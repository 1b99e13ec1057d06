"""Predicate filtering, host-side and on the device.

Port of examples/simple_filtering.py to pasture_tpu_torch: keep only
points matching a predicate — classification == building — on the host
buffer, then the same as a device compaction (the K5 kernel on the GPU).

Usage: python examples/torch/simple_filtering.py [--device cpu]
"""

import argparse

import numpy as np

from pasture_tpu_torch.buffers.device import PointBatch
from pasture_tpu_torch.buffers.host import HostPointBuffer
from pasture_tpu_torch.layout import attributes as att
from pasture_tpu_torch.layout.schema import PointSchema
from pasture_tpu_torch.ops import filter_batch

BUILDING = 6  # ASPRS classification code


def main(device=None):
    rng = np.random.default_rng(11)
    n = 10_000
    schema = PointSchema.from_attributes(
        [att.POSITION_3D, att.CLASSIFICATION])
    buffer = HostPointBuffer.from_columns(schema, {
        att.POSITION_3D.name: rng.uniform(-100, 100, (n, 3)),
        att.CLASSIFICATION.name: rng.integers(0, 20, n).astype(np.uint8),
    })

    # host: boolean-mask filter (order-preserving, like HashMapBuffer::filter)
    cls = buffer.get(att.CLASSIFICATION)
    buildings = buffer.filter(cls == BUILDING)
    print(f"host filter:   {len(buffer)} -> {len(buildings)} building points")

    # device: stable prefix compaction, the capacity kept
    batch = PointBatch.from_host(buffer, device=device)
    kept = filter_batch(batch,
                        lambda d: d[att.CLASSIFICATION.name] == BUILDING)
    print(f"device filter: count = {int(kept.count)} "
          f"(capacity stays {kept.capacity})")
    out = kept.to_host()
    assert len(out) == len(buildings)
    assert np.array_equal(out.get(att.CLASSIFICATION),
                          buildings.get(att.CLASSIFICATION))
    print("host and device filters agree")
    return len(out)


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default=None,
                        help="torch device (default: the GPU)")
    main(parser.parse_args().device)
