"""LAS/LAZ I/O: read, convert schemas, write (the reference's simple_io /
las_io / fast_las_parsing examples rolled into one).

Port of examples/las_io.py to pasture_tpu_torch; the last step reads the
file straight onto the device.

Usage: python examples/torch/las_io.py <input.las|.laz> [output.laz]
       [--device cpu]
"""

import argparse

from pasture_tpu_torch.io import read_all, read_batch, write_all
from pasture_tpu_torch.io.las import LasReader
from pasture_tpu_torch.layout import attributes as att
from pasture_tpu_torch.layout import dtypes as dt
from pasture_tpu_torch.layout.schema import PointSchema


def main(path, out=None, device=None):
    # 1. convenience one-liner
    buffer = read_all(path)
    print(f"{len(buffer)} points, schema: {buffer.schema}")

    # 2. fastest path: exact binary schema, mmap, zero decode
    #    (the reference's fast_las_parsing example)
    with LasReader(path, point_schema_matches_memory_layout=True) as reader:
        raw = reader.read_all()
        print("exact wire schema:", raw.schema)

    # 3. converting read into a custom schema (f32 positions)
    target = PointSchema.from_attributes([
        att.POSITION_3D.with_dtype(dt.VEC3F32), att.INTENSITY])
    with LasReader(path) as reader:
        small = reader.read_all(schema=target)
        print("f32 positions:", small.get(att.POSITION_3D.name)[:3])

    # 4. straight onto the device (exact positions as LAS locals + affine)
    batch = read_batch(path, device=device)
    print(f"on {batch.device}: {int(batch.count)} points")

    if out:
        write_all(buffer, out)   # .laz extension -> native LASzip compress
        print("wrote", out)
    return buffer, batch


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("path")
    parser.add_argument("out", nargs="?", default=None)
    parser.add_argument("--device", default=None,
                        help="torch device (default: the GPU)")
    args = parser.parse_args()
    main(args.path, args.out, args.device)
