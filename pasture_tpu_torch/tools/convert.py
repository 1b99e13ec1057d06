"""``convert`` CLI — convert between any supported point-cloud formats.

Goes beyond the reference's tools (which only ship ``info``): any
registered reader to any registered writer, with optional schema subsetting.

Usage:
  python -m pasture_tpu_torch.tools.convert in.las out.laz
  python -m pasture_tpu_torch.tools.convert in.laz out.pnts --attributes Position3D ColorRGB
  python -m pasture_tpu_torch.tools.convert in.txt out.las --ascii-format xyzi
"""

from __future__ import annotations

import argparse
import sys
import time


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="convert", description="Convert between point cloud formats")
    parser.add_argument("input")
    parser.add_argument("output")
    parser.add_argument("--attributes", nargs="+", default=None,
                        help="keep only these attributes")
    parser.add_argument("--ascii-format", default=None,
                        help="format string when reading/writing ASCII")
    args = parser.parse_args(argv)

    from ..io import open_reader, open_writer
    from ..io.ascii import AsciiReader, AsciiWriter

    t0 = time.perf_counter()
    if args.input.endswith(".txt"):
        if not args.ascii_format:
            parser.error("--ascii-format required for ASCII input")
        reader = AsciiReader(args.input, args.ascii_format)
    else:
        reader = open_reader(args.input)
    with reader:
        buffer = reader.read_all()

    if args.attributes:
        schema = buffer.schema.subset(args.attributes)
        buffer = buffer.convert_schema(schema)

    if args.output.endswith(".txt"):
        writer = AsciiWriter(args.output, buffer.schema,
                             format=args.ascii_format)
    else:
        writer = open_writer(args.output, buffer.schema)
    with writer:
        writer.write(buffer)

    print(f"{len(buffer)} points  {args.input} -> {args.output}  "
          f"({time.perf_counter() - t0:.2f}s)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
