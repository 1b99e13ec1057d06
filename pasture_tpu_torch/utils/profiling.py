"""Profiling helpers: ``torch.profiler`` traces + roofline accounting.

Port of pasture_tpu/utils/profiling.py.  Usage::

    with trace("/path/to/trace-dir"):
        out = pipeline(batch)
        torch.cuda.synchronize()

    est = roofline_estimate(num_points=4<<20, bytes_per_point=15,
                            flops_per_point=30)
    print(est)

The default peaks are an NVIDIA H100 80GB HBM3's at 700 W (the card the
port is measured on); pass a card's own with ``hbm_bw`` / ``peak_flops``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os

import torch

__all__ = ["trace", "roofline_estimate", "RooflineEstimate",
           "H100_HBM_BW", "H100_F32_FLOPS"]

#: speed-of-light peaks of one NVIDIA H100 80GB HBM3 (SXM, 700 W)
H100_HBM_BW = 3.35e12        # bytes/s
H100_F32_FLOPS = 67e12       # FLOP/s, fp32 without tensor cores


@contextlib.contextmanager
def trace(log_dir: str, create_perfetto_link: bool = False):
    """``torch.profiler`` trace of the block, CPU and (when present) CUDA
    activity, written as a Chrome trace ``trace.json`` under ``log_dir``
    (open it in Perfetto or chrome://tracing).

    ``create_perfetto_link`` is accepted for the reference's callers and
    ignored: the Chrome trace opens in Perfetto as it is, and no link is
    served."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


@dataclasses.dataclass
class RooflineEstimate:
    hbm_bound_s: float
    compute_bound_s: float

    @property
    def speed_of_light_s(self) -> float:
        return max(self.hbm_bound_s, self.compute_bound_s)

    @property
    def bound(self) -> str:
        return ("HBM" if self.hbm_bound_s >= self.compute_bound_s
                else "compute")

    def __repr__(self) -> str:
        return (f"RooflineEstimate({self.bound}-bound, "
                f"SoL={self.speed_of_light_s * 1e3:.3f} ms)")


def roofline_estimate(num_points: int, bytes_per_point: float,
                      flops_per_point: float = 0.0,
                      hbm_bw: float = H100_HBM_BW,
                      peak_flops: float = H100_F32_FLOPS
                      ) -> RooflineEstimate:
    """Speed-of-light estimate for a per-point kernel on one card."""
    return RooflineEstimate(
        hbm_bound_s=num_points * bytes_per_point / hbm_bw,
        compute_bound_s=num_points * flops_per_point / peak_flops)
