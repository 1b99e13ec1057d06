"""The comparisons that decide ``correct``: the program's answers against
the reference's, as numbers each held to a limit.

A map is a dict of equal-length columns: ``centroid`` (m, 3) float64,
``intensity`` and ``classification`` (m,) int64, and, where the answer
has them, ``key`` (m,) int64 ascending and ``counts`` (m,) int64 points a
voxel.  Keyed maps are matched voxel by voxel on ``key``; maps without
keys row by row in their defined order.

Imports nothing of the program.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch

INF = float("inf")


def _gaps(got: Dict, ref: Dict, gi, ri) -> Dict[str, float]:
    """The gaps of the rows ``gi`` of ``got`` against the rows ``ri`` of
    ``ref``, for each column the answer has."""
    if gi.numel() == 0:
        out = {"centroid_gap_m": INF if ref["centroid"].shape[0] else 0.0}
    else:
        c = (got["centroid"][gi] - ref["centroid"][ri]).abs()
        finite = bool(torch.isfinite(got["centroid"][gi]).all())
        out = {"centroid_gap_m": float(c.max()) if finite else INF}
    if "intensity" in got:
        d = (got["intensity"][gi] - ref["intensity"][ri]).abs()
        out["intensity_gap"] = float(d.max()) if gi.numel() else 0.0
    if "classification" in got:
        out["class_mismatch"] = float((got["classification"][gi]
                                       != ref["classification"][ri]).sum())
    return out


def keyed(got: Dict, ref: Dict) -> Dict[str, float]:
    """Voxels in one map and not the other; among the voxels in both,
    point counts that differ, the widest centroid gap (metres, any axis),
    the widest intensity gap and the classifications that differ."""
    gk, rk = got["key"], ref["key"]
    pos = torch.searchsorted(rk, gk).clamp_max(max(rk.numel() - 1, 0))
    hit = rk.numel() > 0
    match = (rk[pos] == gk) if hit else torch.zeros_like(gk, dtype=bool)
    gi = torch.nonzero(match)[:, 0]
    ri = pos[gi]
    out = {"voxels_unmatched": float(gk.numel() + rk.numel()
                                     - 2 * gi.numel())}
    if "counts" in got:
        out["count_mismatch"] = float((got["counts"][gi]
                                       != ref["counts"][ri]).sum())
    out.update(_gaps(got, ref, gi, ri))
    return out


def rows(got: Dict, ref: Dict) -> Dict[str, float]:
    """Row counts that differ, then the gaps of the rows in the same
    place (all of them, when the counts agree)."""
    m = min(got["centroid"].shape[0], ref["centroid"].shape[0])
    idx = torch.arange(m, device=ref["centroid"].device)
    out = {"voxels_unmatched": float(abs(got["centroid"].shape[0]
                                         - ref["centroid"].shape[0]))}
    out.update(_gaps(got, ref, idx, idx))
    return out


def worst(readings: List[Dict[str, float]], limits: Dict[str, float]
          ) -> Tuple[Dict[str, Dict[str, float]], int]:
    """``(checks, failed)``: each limited number at its worst over the
    answers compared, beside its limit, and how many answers broke a
    limit.  A number missing from an answer's reading counts as broken."""
    checks, failed = {}, 0
    for r in readings:
        if any(r.get(k, INF) > v for k, v in limits.items()):
            failed += 1
    for k, v in limits.items():
        vals = [r.get(k, INF) for r in readings] or [INF]
        checks[k] = {"value": max(vals), "limit": v}
    return checks, failed
