"""Basic buffers: schemas, host SoA buffers, device batches.

Port of examples/basic_point_buffers.py to pasture_tpu_torch: define a
schema, build a host buffer from columns, move it to the device, reduce it
there, bring the result back.

Usage: python examples/torch/basic_point_buffers.py [--device cpu]
"""

import argparse

import numpy as np

from pasture_tpu_torch.buffers.device import PointBatch
from pasture_tpu_torch.buffers.host import HostPointBuffer
from pasture_tpu_torch.layout import attributes as att
from pasture_tpu_torch.layout.schema import PointSchema
from pasture_tpu_torch.ops import batch_bounds


def main(device=None):
    schema = PointSchema.from_attributes(
        [att.POSITION_3D, att.INTENSITY, att.CLASSIFICATION])
    print("schema:", schema)
    print("wire record size:", schema.point_size, "bytes")

    rng = np.random.default_rng(0)
    n = 1000
    buffer = HostPointBuffer.from_columns(schema, {
        att.POSITION_3D.name: rng.uniform(-10, 10, (n, 3)),
        att.INTENSITY.name: rng.integers(0, 65536, n).astype(np.uint16),
        att.CLASSIFICATION.name: rng.integers(0, 32, n).astype(np.uint8),
    })
    print("host buffer:", buffer)

    # exact interleaved wire bytes (what a LAS record block looks like)
    wire = buffer.to_interleaved()
    print("wire bytes:", wire.nbytes)

    # to the device, bounds there, back
    batch = PointBatch.from_host(buffer, device=device)
    mn, mx = batch_bounds(batch.data[att.POSITION_3D.name],
                          batch.valid_mask())
    print("device bounds:", mn.cpu().numpy(), mx.cpu().numpy())
    return mn.cpu().numpy(), mx.cpu().numpy()


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default=None,
                        help="torch device (default: the GPU)")
    main(parser.parse_args().device)
