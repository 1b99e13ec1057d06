"""``info`` CLI — print layout, metadata and optional per-attribute stats.

Parity with pasture-tools' single binary (reference:
pasture-tools/src/bin/info.rs:29-208): opens any supported file through the
factory, prints the default point schema and metadata; ``--detailed`` scans
the points in 1M-point chunks and prints min/max for every scalar/vector
attribute (the reference's ``minmax_chunk!`` macro over 13 attributes).

Usage: ``python -m pasture_tpu_torch.tools.info <file> [--detailed]``
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np

from ..io import open_reader
from ..math.minmax import infimum, minmax_column, supremum

CHUNK = 1_000_000


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="info", description="Print information about a point cloud file")
    parser.add_argument("file", help="path to a .las/.laz/.pnts file")
    parser.add_argument("--detailed", action="store_true",
                        help="scan all points and print per-attribute min/max")
    args = parser.parse_args(argv)

    t0 = time.perf_counter()
    with open_reader(args.file) as reader:
        schema = reader.get_default_point_schema()
        meta = reader.get_metadata()

        print(f"File:   {args.file}")
        n = meta.number_of_points()
        print(f"Points: {n if n is not None else 'unknown'}")
        bounds = meta.bounds()
        if bounds is not None:
            print(f"Bounds: min={bounds.min.tolist()} "
                  f"max={bounds.max.tolist()}")
        for field in ("version", "point_format", "scale", "offset",
                      "generating_software", "creation_year"):
            value = meta.get_named_field(field)
            if value is not None:
                print(f"{field}: {value}")

        print(f"\nPoint schema ({schema.point_size} bytes/point):")
        for m in schema.members:
            print(f"  {m.name:32s} {str(m.dtype):12s} @ {m.offset}")

        if args.detailed:
            print("\nAttribute statistics:")
            stats = {}
            remaining = n if n is not None else 2 ** 62
            while remaining > 0:
                chunk = reader.read(min(CHUNK, remaining))
                if len(chunk) == 0:
                    break
                remaining -= len(chunk)
                for m in schema.members:
                    if m.dtype.kind in ("bytes", "custom"):
                        continue
                    mm = minmax_column(chunk.get(m.name))
                    if mm is None:
                        continue
                    if m.name in stats:
                        old = stats[m.name]
                        stats[m.name] = (infimum(old[0], mm[0]),
                                         supremum(old[1], mm[1]))
                    else:
                        stats[m.name] = mm
            for name, (mn, mx) in stats.items():
                mn = np.asarray(mn).tolist()
                mx = np.asarray(mx).tolist()
                print(f"  {name:32s} min={mn} max={mx}")

    print(f"\n({time.perf_counter() - t0:.3f}s)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
