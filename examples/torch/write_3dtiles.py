"""Write a 3D Tiles tileset: split a cloud into spatial tiles, write one
.pnts per tile + a tileset.json (the reference's write_3dtiles example).

Port of examples/write_3dtiles.py to pasture_tpu_torch; the cloud's bounds
are taken on the device.

Usage: python examples/torch/write_3dtiles.py <input.las/.laz> <output_dir>
       [--device cpu]
"""

import argparse
from pathlib import Path

import numpy as np

from pasture_tpu_torch.algorithms import calculate_bounds
from pasture_tpu_torch.buffers.device import PointBatch
from pasture_tpu_torch.io import read_all
from pasture_tpu_torch.io.tiles3d import (
    BoundingVolume,
    PntsWriter,
    Refinement,
    Tile,
    Tileset,
    write_tileset,
)
from pasture_tpu_torch.layout import attributes as att
from pasture_tpu_torch.layout.dtypes import DevicePolicy


def main(path, out_dir, tiles_per_axis=2, device=None):
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    buffer = read_all(path)
    pos = buffer.get_converted(att.POSITION_3D)
    box = calculate_bounds(PointBatch.from_host(
        buffer, policy=DevicePolicy.EXACT, device=device))
    mn, mx = box.min, box.max
    extent = np.maximum(mx - mn, 1e-9)

    cell = np.minimum(((pos - mn) / extent * tiles_per_axis).astype(int),
                      tiles_per_axis - 1)
    tile_id = cell[:, 0] * tiles_per_axis + cell[:, 1]

    children = []
    for t in np.unique(tile_id):
        part = buffer.filter(tile_id == t)
        uri = f"tile_{t}.pnts"
        with PntsWriter(out / uri, part.schema) as w:
            w.write(part)
        p = part.get_converted(att.POSITION_3D)
        center = (p.min(axis=0) + p.max(axis=0)) / 2
        half = (p.max(axis=0) - p.min(axis=0)) / 2 + 1e-6
        children.append(Tile(
            geometric_error=0.0,
            bounding_volume=BoundingVolume.box(
                center, [half[0], 0, 0], [0, half[1], 0], [0, 0, half[2]]),
            content_uri=uri))
        print(f"wrote {uri}: {len(part)} points")

    center = (mn + mx) / 2
    half = extent / 2
    root = Tile(
        geometric_error=float(np.linalg.norm(extent)),
        bounding_volume=BoundingVolume.box(
            center, [half[0], 0, 0], [0, half[1], 0], [0, 0, half[2]]),
        refine=Refinement.ADD,
        children=children)
    write_tileset(Tileset(root=root, geometric_error=root.geometric_error),
                  out / "tileset.json")
    print(f"wrote {out / 'tileset.json'} with {len(children)} tiles")
    return len(children)


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("path")
    parser.add_argument("out_dir", nargs="?", default="tileset_out")
    parser.add_argument("--device", default=None,
                        help="torch device (default: the GPU)")
    args = parser.parse_args()
    main(args.path, args.out_dir, device=args.device)
