#!/usr/bin/env python3
"""Run one cell of the benchmark of ``pasture_tpu_torch``.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s>
                             --trace <0|1>

from the root of a checkout, on a machine with the cards the cell asks
for.  Prints, as the last line of standard output, one JSON object:
``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's end-to-end
metrics, or with ``--trace 1`` its per-layer metrics), ``device``, with
``--trace 1`` a ``breakdown``, and last ``checks``: each number the check
compared, beside its limit.  The same numbers end standard error.

``--control 1`` puts the plain reference, computed in the precision below
the one the configuration states, in the program's place and runs only the
comparison, which has to come out false; no window is run.

Exits with a code other than 0, printing no result, when there is no CUDA
device (or fewer than the cell asks for), when the program cannot be
imported, or when JAX or the package the program was ported from is
loaded once the window has closed (looked for after the comparison, in a
control run too).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
CHECKOUT = HERE.parent

# every cache of the program and of the libraries it may use lives at a
# fixed path inside the checkout, so only a checkout's first run builds
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TRITON_CACHE_DIR", "triton")):
    os.environ[var] = str(CHECKOUT / ".bench_cache" / sub)
os.environ["USE_FLAX"] = "0"
os.environ["USE_JAX"] = "0"
# one process with few threads: PyTorch's and the BLAS libraries' CPU pools
# keep one thread, so the host work the cells measure (the read-ahead, the
# launches) does not share the machine's cores with idle workers
os.environ["OMP_NUM_THREADS"] = "1"

sys.path.insert(0, str(CHECKOUT))
sys.path.insert(0, str(HERE))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch
    import harness

    with open(CHECKOUT / "BENCHMARK.json") as f:
        bench = json.load(f)
    cells = {c["name"]: c for c in bench["workloads"]}
    cell = cells.get(args.workload)
    if cell is None:
        print(f"no cell named {args.workload!r}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("no CUDA device: the benchmark measures the card",
              file=sys.stderr)
        return 3
    if torch.cuda.device_count() < cell["chips"]:
        print(f"the cell asks for {cell['chips']} cards, "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 3
    try:
        out = harness.run_cell(bench, cell, args.seed, args.seconds,
                               bool(args.trace), "cuda:0",
                               control=bool(args.control))
    except harness.ForbiddenImport as e:
        print(f"forbidden modules loaded: {e.args[0]}", file=sys.stderr)
        return 4
    for name, c in out["checks"].items():
        print(f"check {name} = {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
