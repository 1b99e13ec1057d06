"""Launches of the fused ICP kernel K8a (``icp_correspond_accumulate``) in
the trace over the scans registered: 20.0 where every iteration of every
scan's ICP ran on the kernel, 0.0 where the trace holds no launch of it (a
program without K8, or the CPU's plain loop)."""
from _shared import per


def read(run):
    fused = sum(1 for n, _, _ in run.kernels
                if "icp_correspond_accumulate" in n)
    return per(run, float(fused), "scans")
