"""Exact merging of partial voxelizations (two-stage downsampling).

Chunked and streaming voxel downsampling produce PARTIAL per-voxel
statistics: a voxel whose points are split across two chunks appears once
in each partial result.  Given the merge statistics emitted by
:func:`~pasture_tpu_torch.ops.voxel_downsample` ``with_aux=True`` (cell
keys, per-voxel point counts, winning-mode counts), this module merges
partials so the result equals the one-shot global voxelization (reference
semantics: pasture-algorithms/src/voxel_grid.rs:443-700):

* **mean** — weighted mean of partial means, ``sum(c_i * mean_i) /
  sum(c_i)``, accumulated in f64; integer mean columns merge from the
  carried UNROUNDED partial means (``aux["raw_means"]``);
* **max** — max of partial maxes (exact; the 0-clamp is idempotent);
* **mode** — EXACT when the partials carry full run tables
  (``voxel_downsample(..., mode_runs=True)``): the vote then covers every
  voxel's complete (value, count) histogram, and the merge emits the summed
  histogram so folds stay exact.  Without run tables the merge takes a
  weighted vote over each partial's winner AND runner-up with their true
  in-partial counts; matching values are summed across partials, and the
  largest total wins (ties to the smallest value).  That is exact whenever
  the global mode ranks in the top two of every partial it appears in, and
  can differ only where it ranks third or lower in some partial.

Merged outputs carry the same aux statistics, so merging FOLDS:
``merge(merge(a, b), c) == merge(a, b, c)`` for mean / max (mode keeps the
same envelope) — the shape streaming consumption needs.

The sorts are stable sorts of one composed int64 key where the key fits
(cell key, or cell key and value); the per-voxel reductions are scatters
on segment ids, which are the output rows.  The keys of the merged voxels
and the merged run tables are compacted by ``compact_columns`` (the
compaction kernel on the GPU).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..buffers.device import PointBatch
from .compact import compact_columns
from .convert import wrap_to_logical
from .kernels.tile_sort_kernel import lex_order
from .voxel import (DEFAULT_POLICIES, _INVALID_KEY, _cast_as, mode_top2,
                    row_starts, run_table, spare_slots)

__all__ = ["merge_voxel_batches"]


def _stable_order(cols: List[torch.Tensor]) -> torch.Tensor:
    """Indices of a stable lexicographic sort of u32-valued int64 columns;
    the first two go into one int64 key, ``(c0 - 2**31) * 2**32 + c1``."""
    if len(cols) >= 2:
        cols = [(cols[0] - (1 << 31)) * (1 << 32) + cols[1]] + cols[2:]
    if len(cols) == 1:
        return torch.sort(cols[0], stable=True).indices
    return lex_order(cols, cols[0].shape[0])


def merge_voxel_batches(parts: Sequence[Tuple[PointBatch, Dict]],
                        policies: Optional[Dict[str, str]] = None,
                        exact_mode: Optional[bool] = None,
                        mode_runs_cap: Optional[int] = None
                        ) -> Tuple[PointBatch, Dict]:
    """Merge partial voxelizations into one (see module doc).

    ``parts``: ``(batch, aux)`` pairs as returned by
    :func:`~pasture_tpu_torch.ops.voxel_downsample` ``with_aux=True`` (or
    by a previous merge) against the SAME grid (bounds / leaf / semantics /
    grid_bits), on one device.  ``policies`` must match the ones used to
    produce the partials.  Returns ``(batch, aux)`` of the same form, with
    capacity the sum of the inputs'; output rows are ordered by cell key.
    Voxels are identified by the carried cell keys — nothing is
    re-quantized.

    ``exact_mode``: ``None`` (default) uses the EXACT run-table mode merge
    whenever every partial carries ``aux["mode_runs"]`` and the top-2
    weighted vote otherwise; ``True`` requires run tables (raises if
    absent); ``False`` forces the vote.  ``mode_runs_cap``: capacity of
    the merged run tables (default: the rows of the vote table).  Merged
    tables report their true run count as ``num_runs``; if it exceeds the
    capacity the table was truncated (largest keys dropped), which costs
    only the dropped runs' votes in a later fold: the vote table is padded
    with every carried voxel key at zero weight, so its rows stay aligned
    with the other columns.  Each merged table carries ``input_truncated``,
    a device boolean that is True iff an input table of this merge (or of
    an earlier fold) held more runs than its capacity.

    Example — a voxel split across two chunks merges back to the exact
    global mean (0.2 and 0.4 in the same 1m cell -> 0.3):

    >>> import torch
    >>> from pasture_tpu_torch.buffers.device import PointBatch
    >>> from pasture_tpu_torch.layout import attributes as att
    >>> from pasture_tpu_torch.layout.schema import PointSchema
    >>> from pasture_tpu_torch.ops import merge_voxel_batches
    >>> from pasture_tpu_torch.ops import voxel_downsample
    >>> schema = PointSchema.from_attributes([att.POSITION_3D])
    >>> def chunk(rows):
    ...     b = PointBatch.from_columns(
    ...         schema, {att.POSITION_3D.name: torch.tensor(rows)},
    ...         device="cpu")
    ...     return voxel_downsample(b, 1.0, semantics="floor",
    ...                             bounds=(torch.zeros(3), None),
    ...                             with_aux=True)
    >>> merged, aux = merge_voxel_batches(
    ...     [chunk([[0.2, 0.2, 0.2]]), chunk([[0.4, 0.4, 0.4]])])
    >>> int(merged.count), int(aux["counts"][0])
    (1, 2)
    >>> [round(v, 2) for v in merged.data[att.POSITION_3D.name][0].tolist()]
    [0.3, 0.3, 0.3]
    """
    if not parts:
        raise ValueError("merge_voxel_batches needs at least one partial")
    batch0, aux0 = parts[0]
    nk = len(aux0["keys"])
    names = list(batch0.data)
    for b, a in parts[1:]:
        if list(b.data) != names:
            raise ValueError("partials carry different attribute sets")
        if len(a["keys"]) != nk:
            raise ValueError("partials carry different key widths")

    pol = dict(DEFAULT_POLICIES)
    if policies:
        pol.update(policies)
    ldt = {n: batch0.logical_dtype(n) for n in names}

    def policy_of(name):
        p = pol.get(name)
        if p is None:
            p = "mean" if ldt[name].kind == "f" else "mode"
        return p

    def cat(cols):
        return cols[0] if len(cols) == 1 else torch.cat(cols)

    dev = batch0.device
    keys = [cat([a["keys"][i] for _, a in parts]) for i in range(nk)]
    counts = cat([a["counts"] for _, a in parts]).to(torch.int64)
    data = {n: cat([b.data[n] for b, _ in parts]) for n in names}
    mode_names = [n for n in names if policy_of(n) == "mode"]
    mode_counts = {n: cat([a["mode_counts"][n] for _, a in parts])
                   for n in mode_names}
    have2 = bool(mode_names) and all("mode2_counts" in a for _, a in parts)
    have_runs = bool(mode_names) and all(
        "mode_runs" in a and all(n in a["mode_runs"] for n in mode_names)
        for _, a in parts)
    use_exact = have_runs if exact_mode is None else bool(exact_mode)
    # with no mode column there is nothing to merge exactly
    use_exact = use_exact and bool(mode_names)
    if use_exact and not have_runs:
        raise ValueError(
            "exact_mode=True needs aux['mode_runs'] on every partial for "
            "every mode column (voxel_downsample(..., with_aux=True, "
            "mode_runs=True))")
    raw = {n: cat([a["raw_means"][n] for _, a in parts])
           for n in aux0.get("raw_means", {})}
    cap = keys[0].shape[0]
    valid_in = keys[0] != _INVALID_KEY
    counts = torch.where(valid_in, counts, torch.zeros_like(counts))

    # ---- sort 1: by cell key; a voxel's segment id is its output row -------
    order = _stable_order(list(keys))
    skeys = [k[order] for k in keys]
    scnt = counts[order]
    valid = skeys[0] != _INVALID_KEY
    first = row_starts(skeys) & valid
    seg = torch.cumsum(first.to(torch.int64), 0) - 1
    slot = spare_slots(seg, valid, cap)
    vkeys, num_voxels = compact_columns(skeys, first)

    def seg_reduce(v, fill, how):
        out = torch.full((2 * cap,) + tuple(v.shape[1:]), fill,
                         dtype=v.dtype, device=dev)
        if how == "sum":
            out.index_add_(0, slot, v)
        else:
            idx = slot.reshape((cap,) + (1,) * (v.ndim - 1)).expand_as(v)
            out.scatter_reduce_(0, idx, v, how, include_self=True)
        return out[:cap]

    counts_out = seg_reduce(scnt, 0, "sum")
    reduced: Dict[str, torch.Tensor] = {}
    raw_out: Dict[str, torch.Tensor] = {}
    for n in names:
        p = policy_of(n)
        if p == "mode":
            continue
        c = (raw[n] if n in raw else data[n])[order]
        vm = valid.reshape((cap,) + (1,) * (c.ndim - 1))
        if p == "mean":
            w = scnt.to(torch.float64).reshape(vm.shape)
            sums = seg_reduce(torch.where(vm, c.to(torch.float64) * w, 0.0),
                              0.0, "sum")
            cw = torch.clamp(counts_out, min=1).to(torch.float64)
            mean = sums / cw.reshape((cap,) + (1,) * (c.ndim - 1))
            if n in raw:
                raw_out[n] = mean.to(torch.float32)
            elif data[n].dtype == torch.float32:
                mean = mean.to(torch.float32)
            reduced[n] = _cast_as(mean, ldt[n])
        elif p == "max":
            acc = c.dtype if c.dtype.is_floating_point else torch.float32
            v = torch.where(vm, c.to(acc), float("-inf"))
            m = seg_reduce(v, float("-inf"), "amax")
            reduced[n] = _cast_as(torch.clamp(m, min=0.0), ldt[n])
        else:
            raise ValueError(f"unknown reduction policy {p!r} for {n}")

    # ---- mode: vote over the partial winners, runner-ups or run tables -----
    # the vote keys' distinct valid set is the main key set in every branch
    # (zero-weight vote rows carry the invalid key, or — exact path — every
    # main key rides along at zero weight), so the vote segments ARE the
    # output rows
    mode_stats: Dict[str, Tuple[torch.Tensor, ...]] = {}
    merged_runs: Dict[str, Dict] = {}
    invalid = torch.full((), _INVALID_KEY, dtype=torch.int64, device=dev)
    for n in mode_names:
        col = wrap_to_logical(data[n], np.int32).to(torch.int64)
        mw = torch.where(valid_in, mode_counts[n].to(torch.int64), 0)
        if use_exact:
            rts = [a["mode_runs"][n] for _, a in parts]
            vote_v = cat([t["values"].to(torch.int64) for t in rts]
                         + [torch.zeros_like(col)])
            vote_w = cat([t["counts"].to(torch.int64) for t in rts]
                         + [torch.zeros_like(mw)])
            vote_keys = [cat([t["keys"][i] for t in rts] + [keys[i]])
                         for i in range(nk)]
            trunc = torch.zeros((), dtype=torch.bool, device=dev)
            for t in rts:
                trunc = trunc | (t["num_runs"] > t["values"].shape[0])
                if "input_truncated" in t:
                    trunc = trunc | t["input_truncated"]
        elif have2:
            m2v = cat([a["mode2_values"][n] for _, a in parts])
            m2c = cat([a["mode2_counts"][n] for _, a in parts])
            w2 = torch.where(valid_in, m2c.to(torch.int64), 0)
            vote_v = torch.cat([col, m2v.to(torch.int64)])
            vote_w = torch.cat([mw, w2])
            vote_keys = [torch.where(vote_w > 0, torch.cat([k, k]), invalid)
                         for k in keys]
        else:
            vote_v, vote_w, vote_keys = col, mw, list(keys)
        vorder = _stable_order(vote_keys + [vote_v + (1 << 31)])
        sk = [k[vorder] for k in vote_keys]
        sv, sw = vote_v[vorder], vote_w[vorder]
        key_new = row_starts(sk)
        svalid = sk[0] != _INVALID_KEY
        f2 = key_new & svalid
        runs = (key_new | row_starts([sv])) & svalid
        seg2 = torch.cumsum(f2.to(torch.int64), 0) - 1
        v1, c1, v2, c2, run_tot = mode_top2(sv, runs, sw, seg2, svalid, cap)
        reduced[n] = _cast_as(v1.to(torch.float32), ldt[n])
        mode_stats[n] = (c1, v2, c2)
        if use_exact:
            # the merged histogram (summed counts per (voxel, value)); runs
            # of zero total exist only where the alignment padding met a
            # voxel with no real run of that value — they stay out
            rn = vote_v.shape[0]
            merged_runs[n] = run_table(
                sk, sv, run_tot, runs & (run_tot > 0),
                rn if mode_runs_cap is None else int(mode_runs_cap))
            merged_runs[n]["input_truncated"] = trunc

    live = torch.arange(cap, dtype=torch.int32, device=dev) < num_voxels

    def live_or(c: torch.Tensor, fill) -> torch.Tensor:
        lm = live.reshape((cap,) + (1,) * (c.ndim - 1))
        return torch.where(lm, c, torch.full((), fill, dtype=c.dtype,
                                             device=dev))

    out = {n: live_or(reduced[n], 0) for n in names}
    i32 = torch.int32
    aux = {
        "keys": tuple(live_or(k, _INVALID_KEY) for k in vkeys),
        "counts": live_or(counts_out, 0).to(i32),
        "mode_counts": {n: live_or(st[0], 0).to(i32)
                        for n, st in mode_stats.items()},
        "mode2_values": {n: live_or(st[1], 0).to(i32)
                         for n, st in mode_stats.items()},
        "mode2_counts": {n: live_or(st[2], 0).to(i32)
                         for n, st in mode_stats.items()},
        "raw_means": {n: live_or(m, 0.0) for n, m in raw_out.items()},
    }
    if use_exact:
        aux["mode_runs"] = merged_runs
    return (PointBatch(out, num_voxels, batch0.schema, batch0.meta,
                       batch0.policy), aux)
