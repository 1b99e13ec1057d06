"""Schema-to-schema conversion: dtype casts, custom mappings, bitfield
fan-out and transforms.

Port of examples/layout_conversion.py to pasture_tpu_torch: the
``SchemaConverter`` reproduces ``BufferLayoutConverter`` semantics —
name-matched defaults, zero-filled missing targets, N:1 source fan-out,
and pre-/post-conversion transform functions.  The converted buffer then
goes to the device in its narrow carriers.

Usage: python examples/torch/layout_conversion.py [--device cpu]
"""

import argparse

import numpy as np

from pasture_tpu_torch.buffers.device import PointBatch
from pasture_tpu_torch.buffers.host import HostPointBuffer
from pasture_tpu_torch.layout import attributes as att
from pasture_tpu_torch.layout import dtypes as dt
from pasture_tpu_torch.layout.attributes import PointAttribute
from pasture_tpu_torch.layout.conversion import SchemaConverter
from pasture_tpu_torch.layout.schema import PointSchema


def main(device=None):
    n = 8
    rng = np.random.default_rng(3)

    # -- 1. name-matched conversion with dtype casts (f64 -> f32 positions,
    #       u16 -> u8 intensity with Rust `as` wrapping semantics)
    src = PointSchema.from_attributes([att.POSITION_3D, att.INTENSITY])
    dst = PointSchema.from_attributes([
        att.POSITION_3D.with_dtype(dt.VEC3F32),
        att.INTENSITY.with_dtype(dt.U8),
    ])
    buffer = HostPointBuffer.from_columns(src, {
        att.POSITION_3D.name: rng.uniform(-10, 10, (n, 3)),
        att.INTENSITY.name: rng.integers(0, 65536, n).astype(np.uint16),
    })
    converted = buffer.convert_schema(dst)
    print("positions f64->f32:", converted.get(att.POSITION_3D).dtype)
    print("intensity u16->u8 (wrapping):",
          buffer.get(att.INTENSITY)[:4], "->",
          converted.get(att.INTENSITY)[:4])
    batch = PointBatch.from_host(converted, device=device)
    print("on the device:", {k: v.dtype for k, v in batch.data.items()})

    # -- 2. custom (user-defined) attributes, as in custom_point_type.rs
    heat = PointAttribute("Heat", dt.F32)
    custom = PointSchema.from_attributes([att.POSITION_3D, heat])
    hot = HostPointBuffer.from_columns(custom, {
        att.POSITION_3D.name: rng.uniform(0, 1, (n, 3)),
        heat.name: rng.random(n, dtype=np.float32),
    })
    print("custom schema:", hot.schema)

    # -- 3. fan-out + transform: one packed flags byte -> two unpacked
    #       attributes (the LAS bitfield pattern, raw_readers.rs:61-103)
    flags_attr = PointAttribute("PackedFlags", dt.U8)
    packed = PointSchema.from_attributes([flags_attr])
    unpacked = PointSchema.from_attributes(
        [att.RETURN_NUMBER, att.NUMBER_OF_RETURNS])
    conv = SchemaConverter.for_schemas_with_default(packed, unpacked)
    conv.set_custom_mapping_with_transformation(
        flags_attr, att.RETURN_NUMBER, lambda v: v & 0x07, True)
    conv.set_custom_mapping_with_transformation(
        flags_attr, att.NUMBER_OF_RETURNS, lambda v: (v >> 3) & 0x07, True)
    flags = (rng.integers(1, 4, n)
             | (rng.integers(1, 4, n) << 3)).astype(np.uint8)
    out = conv.convert({flags_attr.name: flags})
    print("packed:", flags[:4])
    print("return numbers:", out[att.RETURN_NUMBER.name][:4])
    print("number of returns:", out[att.NUMBER_OF_RETURNS.name][:4])
    return converted, out


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default=None,
                        help="torch device (default: the GPU)")
    main(parser.parse_args().device)
