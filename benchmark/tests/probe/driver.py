"""Driver of the probe, a cell of the benchmark's tests only (never a cell
of ``BENCHMARK.json``): it drives the rank path of ``world.py``.

Each rank holds ``rows`` int64 values made from the seed and its rank.
One unit is one all-reduce (sum) of those values plus the unit's index,
through the program's collectives (``pasture_tpu_torch.parallel._comm``)
on ``global_mesh()`` of the harness's world.  The check, on every rank
together, holds the sum of each unit's reduced values to the one worked
out in closed form, and the ranks' unit counts to each other.

``traffic["fault"]`` plants one fault on one rank: ``{"rank": r, "where":
"setup" | "unit" | "check", "at": unit index, "kind": k}`` with ``k``
``raise``, ``die`` (the process kills itself), ``skip`` (the unit leaves
out its collective), ``hang`` (sleeps past any limit), ``jax`` (puts a
module named ``jax`` into ``sys.modules``), or ``slow`` (sleeps
``seconds`` after each unit's collective, no ``where``).
"""

from __future__ import annotations

import os
import signal
import sys
import time
import types

import numpy as np
import torch

from reference import compare


def values(seed: int, rank: int, rows: int, device) -> torch.Tensor:
    """A rank's ``rows`` values, each in [0, 1000)."""
    k = torch.arange(rows, dtype=torch.int64, device=device)
    return (k * (rank + 1) + seed % 1000003) % 1000


def expected_sum(seed: int, size: int, rows: int, i: int) -> int:
    """The sum over rows of unit ``i``'s reduced values, in plain numpy."""
    k = np.arange(rows, dtype=np.int64)
    base = sum(int(((k * (r + 1) + seed % 1000003) % 1000).sum())
               for r in range(size))
    return base + size * rows * i


class Driver:
    def __init__(self, config, traffic, seed, device, workdir):
        import torch.distributed as dist
        from pasture_tpu_torch.parallel import _comm, multihost

        self.comm, self.traffic, self.seed = _comm, traffic, seed
        self.rank, self.size = dist.get_rank(), dist.get_world_size()
        self.fault = traffic.get("fault") or {}
        self.rows = config["rows"]
        self.device = torch.device(device)
        self._fault("setup", 0)
        self.mesh = multihost.global_mesh(device=self.device)
        self.base = values(seed, self.rank, self.rows, self.device)
        self.sums = []
        for i in range(traffic["warm_units"]):
            self._reduce(i)

    def _fault(self, where, i):
        f = self.fault
        if f.get("rank") != self.rank or f.get("where") != where \
                or f.get("at", 0) != i:
            return
        kind = f["kind"]
        if kind == "raise":
            raise RuntimeError(f"probe fault: rank {self.rank} raised in "
                               f"its {where}")
        if kind == "die":
            os.kill(os.getpid(), signal.SIGKILL)
        if kind == "hang":
            time.sleep(3600)
        if kind == "jax":
            sys.modules["jax"] = types.ModuleType("jax")

    def _reduce(self, i):
        out = self.comm.all_reduce(self.base + i, "sum", self.mesh)
        return out.sum()

    def unit(self, i):
        self._fault("unit", i)
        f = self.fault
        if f.get("kind") == "skip" and f.get("rank") == self.rank \
                and f.get("at", 0) == i:
            return {"units": 1}
        self.sums.append((i, self._reduce(i)))
        if f.get("kind") == "slow" and f.get("rank") == self.rank:
            time.sleep(f["seconds"])
        return {"units": 1}

    def counters(self):
        return {"all_reduce_calls":
                self.comm.collective_counts()["all_reduce"]["calls"]}

    def info(self):
        return {}

    def release(self):
        self.sums = [(i, int(t)) for i, t in self.sums]

    def check(self, control):
        if control:
            # the reference in bfloat16 in the program's place
            got = []
            for i in range(max(self.traffic["warm_units"], 1)):
                v = sum(values(self.seed, r, self.rows, "cpu") + i
                        for r in range(self.size))
                got.append((i, int(v.to(torch.bfloat16).sum(
                    dtype=torch.bfloat16).item())))
        else:
            got = self.sums
        n = torch.tensor([len(got)], dtype=torch.int64, device=self.device)
        lo = int(self.comm.all_reduce(n, "min", self.mesh))
        hi = int(self.comm.all_reduce(n, "max", self.mesh))
        self._fault("check", 0)
        readings = [{"sum_gap": abs(s - expected_sum(self.seed, self.size,
                                                     self.rows, i)),
                     "unit_count_spread": hi - lo} for i, s in got]
        return compare.worst(readings, self.traffic["limits"])

    def close(self):
        self.base = None
