"""Voxel-grid downsampling on device.

Re-design of pasture's ``voxelgrid_filter``
(reference: pasture-algorithms/src/voxel_grid.rs:109-165): where the
reference scans markers linearly per point and inserts into a sorted Vec
(O(n·v)), this op quantizes positions to integer cells and regroups with
Morton-key sorts.

Two paths:

* the **generic path** — plain PyTorch: one lexicographic sort by (cell
  key, packed word), segment ids from key changes, and scatter reductions
  (``index_add_``, ``scatter_reduce_``) on those ids.  Segment ids are dense
  and ordered, so a voxel's id IS its output row: the result is compacted
  as it is reduced (the voxels' keys by ``compact_columns``, on the GPU the
  ``blockwise_compact`` kernel).  This path is the package's own oracle.
* the **fast path** — the hand kernels ``tile_sort`` then
  ``fused_sorted_voxel_reduce`` (ops/kernels), which on a CPU tensor run
  their plain versions.  It takes a call whose grid fits one u32 Morton key
  (``grid_bits <= 10``), whose payload fits the packed word, and whose
  positions come in one of the reduce kernel's three forms: the exact-local
  residual word (``precomputed=(keys, resword)`` + ``local_affine=``), the
  quantized residual word (``position_quantization_bits``, with or without
  ``precomputed=(keys, qword)``), or the f32 position column itself (the
  exact-f32 form, with or without ``precomputed=(keys, None)``).

Per-attribute reduction policies reproduce set_all_attributes
(voxel_grid.rs:443-700):

=====================  ==========================================
mean                   Position3D, ColorRGB, Normal, Intensity, NIR
mode (most common)     ReturnNumber, NumberOfReturns, ScannerChannel,
                       ScanDirectionFlag, EdgeOfFlightLine,
                       Classification, ScanAngleRank, ScanAngle,
                       UserData, PointSourceID
max (clamped at 0)     ClassificationFlags, GpsTime
rejected               the five waveform attributes
=====================  ==========================================

Unknown attributes default to mean for floats and mode for integers; ties
in mode go to the smallest value (the reference's HashMap iteration is
nondeterministic there).  Cell-index semantics ``"nearest"`` reproduces the
reference's nearest-marker clamp (voxel_grid.rs:22-51); ``"floor"`` is
standard voxel binning.  Float averages accumulate in f64 and round once
to the column's type — sums of millimetre-quantized f32 coordinates are
then exact, so a mean does not depend on the order of the GPU's atomic adds
and a run is repeatable bit for bit; integer columns are summed exactly and
divided in f32.

``grid_bits`` bounds the cell grid per axis: 10 (1024³ cells) uses a single
u32 Morton sort key; up to 20 uses a dual-u32 key.

The packed word: one u32 rides the sort as an extra minor key.  The FIRST
integer mode column's bits occupy the TOP of the word (its values become
contiguous runs within a voxel — mode needs grouping only) and narrow
integer payload columns fill the remaining low bits in dict order (they
only permute rows within a (voxel, mode) run, which mean and max are
invariant to).  The layout is part of the fast path's contract with the
reduce kernel.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..buffers.device import PointBatch
from ..layout import attributes as att
from ..layout.dtypes import torch_carrier
from ..math.morton import (_expand10_u32, morton_decode_u32,
                           morton_encode_dual32)
from .compact import compact_columns
from .convert import (rust_as_cast_device, u32_bits, u32_carrier,
                      wrap_to_logical)
from .kernels.compact_kernel import blockwise_compact_plain
from .kernels.fused_transform import _f32, _int_cell_base
from .kernels.tile_sort_kernel import (lex_order, supports_tile_sort,
                                       tile_sort)
from .kernels.voxel_reduce_kernel import (MAX_FIELDS,
                                          fused_sorted_voxel_reduce_rows,
                                          segment_mode,
                                          supports_fused_reduce)
from .reductions import batch_bounds

__all__ = ["voxel_indices", "voxel_downsample", "DEFAULT_POLICIES"]

DEFAULT_POLICIES: Dict[str, str] = {
    att.POSITION_3D.name: "mean",
    att.COLOR_RGB.name: "mean",
    att.NORMAL.name: "mean",
    att.INTENSITY.name: "mean",
    att.NIR.name: "mean",
    att.RETURN_NUMBER.name: "mode",
    att.NUMBER_OF_RETURNS.name: "mode",
    att.SCANNER_CHANNEL.name: "mode",
    att.SCAN_DIRECTION_FLAG.name: "mode",
    att.EDGE_OF_FLIGHT_LINE.name: "mode",
    att.CLASSIFICATION.name: "mode",
    att.SCAN_ANGLE_RANK.name: "mode",
    att.SCAN_ANGLE.name: "mode",
    att.USER_DATA.name: "mode",
    att.POINT_SOURCE_ID.name: "mode",
    att.CLASSIFICATION_FLAGS.name: "max",
    att.GPS_TIME.name: "max",
}

_WAVEFORM_NAMES = frozenset({
    att.WAVE_PACKET_DESCRIPTOR_INDEX.name, att.WAVEFORM_DATA_OFFSET.name,
    att.WAVEFORM_PACKET_SIZE.name, att.RETURN_POINT_WAVEFORM_LOCATION.name,
    att.WAVEFORM_PARAMETERS.name,
})

_INVALID_KEY = 0xFFFFFFFF


def _cast_as(x: torch.Tensor, dtype) -> torch.Tensor:
    """Rust ``as``-style cast of a float reduction result back to the
    column's logical dtype (carrier returned): truncate toward zero +
    saturate for ints."""
    return rust_as_cast_device(x, dtype)


def voxel_indices(positions: torch.Tensor, mask: torch.Tensor,
                  leaf_size, bounds_min: torch.Tensor,
                  semantics: str = "nearest",
                  grid_bits: int = 20) -> torch.Tensor:
    """Integer cell indices (N, 3) int32 for each point; invalid rows get
    the maximal index so they sort last."""
    max_cell = (1 << grid_bits) - 1
    dev, dt = positions.device, positions.dtype
    leaf = torch.as_tensor(leaf_size, device=dev).to(dt).expand(3)
    u = (positions - torch.as_tensor(bounds_min, device=dev).to(dt)[None, :]
         ) / leaf[None, :]
    if semantics == "nearest":
        idx = torch.floor(u - 0.5)
    elif semantics == "floor":
        idx = torch.floor(u)
    else:
        raise ValueError(f"unknown voxel semantics {semantics!r}")
    idx = torch.clamp(idx, 0, max_cell).to(torch.int32)
    return torch.where(mask[:, None], idx, torch.full_like(idx, max_cell))


def _keys(cells: torch.Tensor, mask: torch.Tensor, grid_bits: int
          ) -> List[torch.Tensor]:
    """Sort keys (u32 carriers): one Morton key for <=10-bit grids, else
    (hi, lo); invalid rows get the maximal key."""
    invalid = torch.full((), _INVALID_KEY, dtype=torch.int64,
                         device=cells.device)
    if grid_bits <= 10:
        key = (_expand10_u32(cells[:, 0]) | (_expand10_u32(cells[:, 1]) << 1)
               | (_expand10_u32(cells[:, 2]) << 2))
        return [torch.where(mask, key, invalid)]
    hi, lo = morton_encode_dual32(cells[:, 0], cells[:, 1], cells[:, 2])
    return [torch.where(mask, hi, invalid), torch.where(mask, lo, invalid)]


def _flatten_cols(data: Dict[str, torch.Tensor]):
    """Split (N, C) columns into C 1-D operands; remember the layout."""
    ops, layout = [], []
    for name, col in data.items():
        if col.ndim == 1:
            layout.append((name, 1))
            ops.append(col)
        else:
            layout.append((name, col.shape[1]))
            ops.extend(col[:, i] for i in range(col.shape[1]))
    return ops, layout


def _unflatten_cols(ops, layout):
    out, i = {}, 0
    for name, c in layout:
        if c == 1:
            out[name] = ops[i]
            i += 1
        else:
            out[name] = torch.stack(ops[i:i + c], dim=1)
            i += c
    return out


def _width(dtype) -> int:
    return np.dtype(dtype).itemsize * 8


def _is_int(dtype) -> bool:
    return np.dtype(dtype).kind in "iu"


def _bits_of(col: torch.Tensor, width: int) -> torch.Tensor:
    """Low ``width`` bits of an integer column as a u32 carrier."""
    return col.to(torch.int64) & ((1 << width) - 1)


def _unpack_field(word: torch.Tensor, shift: int, width: int, dtype
                  ) -> torch.Tensor:
    """Field of a u32 word in either form -> its value (sign-extended for
    a signed logical dtype).  The mask follows the shift, so the sign bits
    that an arithmetic shift of the bits form brings in are dropped."""
    u = (word >> shift) & ((1 << width) - 1)
    if np.dtype(dtype).kind == "i":
        sb = 1 << (width - 1)
        u = (u ^ sb) - sb
    return u


def _tiled_sort(operands: Sequence[torch.Tensor], num_keys: int,
                sort_tiles: int, use_kernel: bool):
    """Sort each of ``sort_tiles`` contiguous row-tiles independently by the
    first ``num_keys`` operands (u32 carriers, lexicographic); the other
    operands move with their row.  Equals the global sort when tiles are
    spatially disjoint (every voxel then stays within a tile).

    On the GPU, when the tile length is a supported power of two and every
    operand is a u32 word or an f32 column, the sort is the ``tile_sort``
    kernel; otherwise (one tile, unsupported lengths, f64 operands, or
    ``use_kernel`` off) it is ``torch.sort``.  Both agree up to the order
    within equal-key runs, which every reduction downstream is invariant
    to."""
    operands = list(operands)
    cap = operands[0].shape[0]
    tlen = cap // sort_tiles
    if (use_kernel and sort_tiles > 1 and operands[0].is_cuda
            and num_keys <= 2
            and supports_tile_sort(cap, tlen, len(operands))
            and all(o.dtype in (torch.int64, torch.int32, torch.float32)
                    for o in operands)):
        streams = [o.view(torch.int32) if o.dtype == torch.float32
                   else u32_bits(o) for o in operands]
        out = tile_sort(streams, tlen, num_keys=num_keys)
        return tuple(s.view(torch.float32) if o.dtype == torch.float32
                     else u32_carrier(s) for s, o in zip(out, operands))
    order = lex_order([u32_carrier(k) for k in operands[:num_keys]], tlen)
    return tuple(o.index_select(0, order) for o in operands)


def voxel_downsample(batch: PointBatch, leaf_size,
                     bounds: Optional[Tuple[torch.Tensor,
                                            Optional[torch.Tensor]]] = None,
                     policies: Optional[Dict[str, str]] = None,
                     semantics: str = "nearest",
                     position_attribute: str = att.POSITION_3D.name,
                     grid_bits: int = 20,
                     position_quantization_bits: Optional[int] = None,
                     sort_tiles: int = 1,
                     precomputed: Optional[Tuple[torch.Tensor,
                                                 torch.Tensor]] = None,
                     local_affine: Optional[Tuple] = None,
                     with_aux: bool = False,
                     mode_runs: bool = False,
                     *, fused: bool = True) -> PointBatch:
    """Voxel-grid downsample a batch; returns a batch of voxel centroids
    (same schema/capacity, ``count`` = number of occupied voxels, ordered by
    Morton code — the reference orders voxels by (x,y,z) tuple instead).
    Rows past ``count`` are zero.

    ``sort_tiles`` (default 1 = one global sort): split the batch into
    that many contiguous row-tiles and sort each independently.
    Semantics: each tile is voxelized independently and the results
    concatenated (exactly the contract of chunked/streaming voxelization).
    When the tiles are spatially disjoint at voxel granularity — the
    natural shape after Morton partitioning or tiled ingest — this equals
    the global voxelization; overlapping tiles emit one centroid per
    (tile, voxel).  Output voxels are ordered by (tile, Morton) instead of
    global Morton.

    ``position_quantization_bits=q`` (with ``grid_bits <= 10``,
    ``3 * q <= 32``, a float position column under the ``mean`` policy):
    the QUANTIZED path — each point's in-cell residual is kept in q bits
    per axis (window [0, 1) leaves for ``floor``, [0, 1.5) for ``nearest``),
    three of them packed into one u32 sort operand, and the centroid is the
    cell plus the mean residual, within ``1.5 * leaf / 2**q`` of the exact
    mean.  When one of those conditions fails the call silently runs the
    exact path.  ``precomputed=(morton_keys, qword)`` takes keys and
    residual words as given (paired with kernels ``fused_voxel_head``; the
    batch then needs no position column); it requires the quantized path
    and explicit ``bounds``.
    ``precomputed=(morton_keys, None)`` is the EXACT-f32 variant (paired
    with kernels ``fused_decode_transform_key``): keys are taken as given,
    the batch's position column rides the sort as f32 operands, and
    centroids are segmented means.  Requires ``grid_bits <= 10`` and
    explicit ``bounds`` (the keys' grid anchor).

    ``precomputed=(morton_keys, resword)`` WITH ``local_affine=(scale,
    rot, trans, coeffs)`` — ``coeffs`` being the SAME
    kernels.exact_local_base_coeffs tensor the head used — is the
    EXACT-LOCAL variant (paired with kernels
    fused_voxel_head_exact_local): ``resword`` packs each point's i32 LAS
    local coordinate as an exact 10-bit integer residual of a per-cell
    base, and the centroid is the affine image of the EXACT local mean
    (mean commutes with the rigid transform) — no quantization, and
    strictly tighter error than summing f32 world positions.  Requires
    ``grid_bits <= 10``, explicit ``bounds``, scalar ``leaf_size``
    <= kernels.exact_local_max_leaf(scale, semantics); the batch need
    not carry a position column.  The two words may be in carrier (int64)
    or bits (int32) form.

    ``fused`` (keyword only, default on) takes the hand kernels where the
    call is eligible — ``tile_sort`` for a tiled sort on the GPU,
    ``blockwise_compact`` for the generic path's key compaction on the GPU,
    and ``tile_sort`` + ``fused_sorted_voxel_reduce`` for the whole
    exact-local, quantized or exact-f32 path when the key is one u32, every
    other payload is packed in the word, the fused mode column is unsigned
    and the tile fits the kernel (on a CPU batch their plain versions run).
    ``fused=False`` runs the generic path in plain PyTorch all the way: the
    oracle the fast path is held against.

    ``with_aux``: also return the per-voxel merge statistics that make the
    two-stage (chunked / streaming) voxelization EXACTLY equal the one-shot
    global result — the return value becomes ``(batch, aux)`` with ``aux =
    {"keys": (nk,)-tuple of cell-key columns (u32 carriers, int64),
    "counts": i32 points per voxel, "mode_counts": {name: i32 count of the
    winning mode value}, "mode2_values" / "mode2_counts": {name: the
    RUNNER-UP mode value and its count (0, 0 when the voxel holds a single
    distinct value)}, "raw_means": {name: f32 UNROUNDED mean of an integer
    mean column, whose output cast truncates}}``, each aligned with the
    output rows; rows past ``count`` hold the invalid key 0xFFFFFFFF and
    zeros, so concatenated partials feed
    :func:`~pasture_tpu_torch.ops.merge_voxel_batches` without masks.  The
    statistics come from the generic path (the fused reduce emits none).

    ``mode_runs`` (requires ``with_aux``): additionally emit, per mode
    column, the FULL per-(voxel, value) run table —
    ``aux["mode_runs"][name] = {"keys": (nk,)-tuple, "values": i32,
    "counts": i32, "num_runs": 0-d i32}`` (capacity rows, key-ordered,
    compacted by ``compact_columns``, padded with the invalid key / zeros)
    — the voxel's complete value histogram, with which the merge elects
    the global mode exactly.

    Example — four corner points collapse to two 1m voxels, centroids =
    per-voxel means (reference ``voxelgrid_filter``, voxel_grid.rs:109-165):

    >>> import torch
    >>> from pasture_tpu_torch.buffers.device import PointBatch
    >>> from pasture_tpu_torch.layout import attributes as att
    >>> from pasture_tpu_torch.layout.schema import PointSchema
    >>> schema = PointSchema.from_attributes([att.POSITION_3D])
    >>> pos = torch.tensor([[0.2, 0.2, 0.2], [0.4, 0.4, 0.4],
    ...                     [5.1, 5.1, 5.1], [5.3, 5.3, 5.3]])
    >>> batch = PointBatch.from_columns(schema, {att.POSITION_3D.name: pos},
    ...                                 device="cpu")
    >>> out = voxel_downsample(batch, 1.0, semantics="floor",
    ...                        bounds=(torch.zeros(3), None))
    >>> int(out.count)
    2
    >>> [[round(v, 2) for v in row]
    ...  for row in out.data[att.POSITION_3D.name][:2].tolist()]
    [[0.3, 0.3, 0.3], [5.2, 5.2, 5.2]]
    """
    pre = precomputed is not None
    pre_exact = pre and precomputed[1] is None
    exact_local = pre and precomputed[1] is not None \
        and local_affine is not None
    if local_affine is not None and not exact_local:
        raise ValueError("local_affine requires precomputed=(keys, "
                         "resword) from fused_voxel_head_exact_local")
    if pre:
        if grid_bits > 10:
            raise ValueError("precomputed keys require grid_bits <= 10 "
                             "(single-u32 Morton keys)")
        if (not pre_exact and not exact_local
                and position_quantization_bits is None):
            raise ValueError("precomputed (keys, qword) requires the "
                             "quantized path (position_quantization_bits "
                             "set) or local_affine (exact-local path)")
        if bounds is None:
            raise ValueError("precomputed keys require explicit bounds "
                             "(the grid anchor, for centroid "
                             "reconstruction)")
        if pre_exact and position_attribute not in batch.data:
            raise ValueError("precomputed (keys, None) requires the batch "
                             "to carry the position column")
    if position_attribute not in batch.data and not (pre and not pre_exact):
        raise ValueError(
            f"batch has no {position_attribute!r} attribute, required for "
            f"voxel grid construction")
    for name in batch.data:
        if name in _WAVEFORM_NAMES:
            raise ValueError("waveform data currently not supported "
                             "(voxel_grid.rs:452-459 parity)")
    if mode_runs and not with_aux:
        raise ValueError("mode_runs requires with_aux=True (it is a merge "
                         "statistic)")
    if semantics not in ("nearest", "floor"):
        raise ValueError(f"unknown voxel semantics {semantics!r}")

    pol = dict(DEFAULT_POLICIES)
    if policies:
        pol.update(policies)
    ldt = {name: batch.logical_dtype(name) for name in batch.data}

    def policy_of(name):
        p = pol.get(name)
        if p is None:
            p = "mean" if ldt[name].kind == "f" else "mode"
        if p == "mode" and batch.data[name].ndim != 1:
            raise ValueError(f"mode policy needs a scalar column: {name}")
        return p

    dev = batch.device
    pos = batch.data.get(position_attribute)
    pdt = pos.dtype if pos is not None else torch.float32
    mask = batch.valid_mask()
    if bounds is None:
        bmin, _ = batch_bounds(pos, mask)
    else:
        bmin = torch.as_tensor(bounds[0], device=dev)
    cap = batch.capacity
    if sort_tiles < 1 or cap % sort_tiles != 0:
        raise ValueError(f"capacity {cap} not divisible by "
                         f"sort_tiles={sort_tiles}")
    tile_len = cap // sort_tiles
    invalid = torch.full((), _INVALID_KEY, dtype=torch.int64, device=dev)

    qbits = position_quantization_bits
    qwindow = 1.5 if semantics == "nearest" else 1.0
    if pre:
        # the words stay in the form they came in (a head kernel's bits
        # form goes to the sort kernel as it is); the generic path turns
        # them into carriers below
        pkeys, qword = precomputed
        bits = pkeys.dtype == torch.int32
        keys = [torch.where(mask, pkeys,
                            torch.full((), -1, dtype=torch.int32, device=dev)
                            if bits else invalid)]
        quantize_pos = not pre_exact and not exact_local
        if exact_local:
            qbits = 10   # the residual word's layout
        cells = None
    else:
        cells = voxel_indices(pos, mask, leaf_size, bmin, semantics,
                              grid_bits)
        keys = _keys(cells, mask, grid_bits)
        quantize_pos = (
            qbits is not None and grid_bits <= 10 and 3 * qbits <= 32
            and pos.dtype.is_floating_point
            and policy_of(position_attribute) == "mean")
        qword = None
    nk = len(keys)
    if quantize_pos and not pre:
        leaf = torch.as_tensor(leaf_size, device=dev).to(pdt).expand(3)
        u = (pos - bmin.to(pdt)[None, :]) / leaf[None, :]
        # residual window relative to the (clipped) cell: [0, 1) for floor;
        # [0, 1.5) for nearest (the low-edge clamp of voxel_indices puts
        # cell-0 residuals in [0, 0.5))
        r = u - cells.to(pdt)
        qv = torch.clamp(torch.floor(r * ((1 << qbits) / qwindow)), 0,
                         (1 << qbits) - 1).to(torch.int64)
        qword = (qv[:, 0] << (2 * qbits)) | (qv[:, 1] << qbits) | qv[:, 2]
    carry_q = quantize_pos or exact_local

    # ---- the packed word and the loose operands ---------------------------
    mode_names = [n for n in batch.data if policy_of(n) == "mode"]
    fused_mode = next((n for n in mode_names
                       if _is_int(ldt[n]) and _width(ldt[n]) <= 32), None)
    carry_data = {name: col for name, col in batch.data.items()
                  if policy_of(name) != "mode"
                  and not (quantize_pos and name == position_attribute)}
    ops, layout = _flatten_cols(carry_data)
    flat_names = [name for name, c in layout for _ in range(c)]

    mode_bits = 0
    packed_word = None
    if fused_mode is not None:
        mode_bits = _width(ldt[fused_mode])
        packed_word = _bits_of(batch.data[fused_mode], mode_bits) \
            << (32 - mode_bits)
    avail = 32 - mode_bits
    pack_plan = []  # (op index, shift, width, logical dtype)
    loose_idx = []
    for i, op in enumerate(ops):
        dt_ = ldt[flat_names[i]]
        w = _width(dt_)
        if _is_int(dt_) and w <= avail:
            shift = avail - w
            word = _bits_of(op, w) << shift
            packed_word = word if packed_word is None else packed_word | word
            pack_plan.append((i, shift, w, dt_))
            avail -= w
        else:
            loose_idx.append(i)

    # ---- fast path: tile_sort + fused reduce -------------------------------
    scalar_leaf = np.ndim(leaf_size) == 0
    # exact-f32 form: the three f32 position components are the ONLY loose
    # sort operands (a position column beside exact-local words is ignored
    # there as in the generic path, which takes the centroid from the words)
    exact_pos_fused = (
        not carry_q and pos is not None and pdt == torch.float32
        and len(loose_idx) == 3
        and all(flat_names[i] == position_attribute for i in loose_idx)
        and policy_of(position_attribute) == "mean")
    can_fuse = (
        (carry_q and not loose_idx or exact_pos_fused) and nk == 1
        and not with_aux   # the fused reduce emits no merge statistics
        and packed_word is not None and scalar_leaf
        and all(policy_of(flat_names[i]) == "mean"
                and carry_data[flat_names[i]].ndim == 1
                for i, _, _, _ in pack_plan)
        and set(mode_names) <= ({fused_mode} if fused_mode else set())
        and (fused_mode is None or ldt[fused_mode].kind == "u")
        and len(pack_plan) <= MAX_FIELDS
        and supports_fused_reduce(cap, tile_len, len(pack_plan)))
    if can_fuse and fused:
        fields = tuple((shift, w, dt_.kind == "i",
                        int(np.iinfo(dt_).min), int(np.iinfo(dt_).max))
                       for _, shift, w, dt_ in pack_plan)
        operands = (keys[0], packed_word) + (
            tuple(ops[i] for i in loose_idx) if exact_pos_fused
            else (qword,))
        if dev.type == "cuda" and sort_tiles > 1 \
                and supports_tile_sort(cap, tile_len, len(operands)):
            sorted_ops = tile_sort(
                [o.view(torch.int32) if o.dtype == torch.float32
                 else u32_bits(o) for o in operands], tile_len, num_keys=2)
        else:
            sorted_ops = _tiled_sort(operands, 2, sort_tiles, False)
        skey, sword = sorted_ops[:2]
        if exact_pos_fused:
            spos = tuple(s.view(torch.float32) for s in sorted_ops[2:])
            vpos, oword, num_voxels = fused_sorted_voxel_reduce_rows(
                skey, sword, None, _f32(bmin, dev), leaf_size, mode_bits,
                fields, 0, qwindow, tile_len, semantics, spos=spos)
        else:
            vpos, oword, num_voxels = fused_sorted_voxel_reduce_rows(
                skey, sword, sorted_ops[2], _f32(bmin, dev), leaf_size,
                mode_bits, fields, qbits, qwindow, tile_len, semantics,
                local_affine=local_affine)
        reduced_f: Dict[str, torch.Tensor] = {
            position_attribute: vpos.to(pdt)}
        for i, shift, w, dt_ in pack_plan:
            reduced_f[flat_names[i]] = _unpack_field(
                oword, shift, w, dt_).to(torch_carrier(dt_))
        if fused_mode is not None:
            reduced_f[fused_mode] = _unpack_field(
                oword, 32 - mode_bits, mode_bits, ldt[fused_mode]).to(
                torch_carrier(ldt[fused_mode]))
        return PointBatch(reduced_f, num_voxels, batch.schema, batch.meta,
                          batch.policy)

    # ---- generic path: sort, segment ids, scatter reductions ---------------
    if pre:
        keys = [u32_carrier(keys[0])]
    extra_keys = (packed_word,) if packed_word is not None else ()
    loose_ops = tuple(ops[i] for i in loose_idx)
    extra_vals = (u32_carrier(qword),) if carry_q else ()
    sorted_all = _tiled_sort(
        tuple(keys) + extra_keys + loose_ops + extra_vals,
        nk + len(extra_keys), sort_tiles, fused)
    skeys = sorted_all[:nk]
    sword = sorted_all[nk] if packed_word is not None else None
    sqword = sorted_all[-1] if carry_q else None

    sorted_ops: List = [None] * len(ops)
    for j, i in enumerate(loose_idx):
        sorted_ops[i] = sorted_all[nk + len(extra_keys) + j]
    for i, shift, w, dt_ in pack_plan:
        sorted_ops[i] = _unpack_field(sword, shift, w, dt_).to(
            torch_carrier(dt_))
    sorted_cols = _unflatten_cols(sorted_ops, layout)

    # the valid prefix survives tiled sorting: the unsorted batch is
    # prefix-valid, so at most one tile is partially valid and its invalid
    # rows (maximal keys) sort to that tile's end — globally rows [0,count)
    # remain exactly the valid ones
    row = torch.arange(cap, dtype=torch.int32, device=dev)
    valid = row < batch.count
    tile_start = (row % tile_len == 0) if sort_tiles > 1 else None

    def key_changes(ks):
        new = row_starts(ks)
        return new if tile_start is None else new | tile_start

    new_key = key_changes(skeys)
    first = new_key & valid
    # a voxel's segment id is its output row; invalid rows go to spare slots
    seg = torch.cumsum(first.to(torch.int64), 0) - 1
    slot = spare_slots(seg, valid, cap)
    compact = compact_columns if fused else blockwise_compact_plain
    vkeys, num_voxels = compact(list(skeys), first)

    def seg_sum(v, acc):
        out = torch.zeros((2 * cap,) + tuple(v.shape[1:]), dtype=acc,
                          device=dev)
        vm = valid.reshape((cap,) + (1,) * (v.ndim - 1))
        out.index_add_(0, slot, torch.where(vm, v.to(acc),
                                            torch.zeros((), dtype=acc,
                                                        device=dev)))
        return out[:cap]

    npts = seg_sum(torch.ones_like(seg), torch.int64)
    counts = torch.clamp(npts, min=1)
    reduced: Dict[str, torch.Tensor] = {}
    raw_means: Dict[str, torch.Tensor] = {}

    # ---- mean --------------------------------------------------------------
    for n, c in sorted_cols.items():
        if policy_of(n) != "mean":
            continue
        if _is_int(ldt[n]):
            acc = torch.float32
            sums = seg_sum(c, torch.int64).to(acc)   # exact, then rounded
        else:
            acc = torch.float64
            sums = seg_sum(c, acc)
        cnt = counts.to(acc).reshape((cap,) + (1,) * (c.ndim - 1))
        if with_aux and _is_int(ldt[n]):
            # the cast truncates, so merging partials needs the UNROUNDED
            # partial mean
            raw_means[n] = sums / cnt
        reduced[n] = _cast_as(sums / cnt, ldt[n])

    if quantize_pos:
        # centroid = cell (decoded from the voxel's Morton key) + unbiased
        # mean of the centred q-bit residuals
        cnt = counts.to(torch.float32)
        leaf3 = torch.as_tensor(leaf_size, device=dev).to(pdt).expand(3)
        cxyz = morton_decode_u32(vkeys[0])
        comps = []
        for a, sh in enumerate((2 * qbits, qbits, 0)):
            qs = seg_sum((sqword >> sh) & ((1 << qbits) - 1), torch.int64)
            mean_r = (qs.to(torch.float32) / cnt + 0.5) \
                * (qwindow / (1 << qbits))
            ci = cxyz[a]
            comps.append((ci.to(pdt) + mean_r.to(pdt)) * leaf3[a]
                         + bmin[a].to(pdt))
        reduced[position_attribute] = torch.stack(comps, dim=1)
    elif exact_local:
        # centroid = affine image of the EXACT local mean: per-cell base
        # (the SAME integer fixed-point expression the head encoded
        # residuals against) + exact mean of the 10-bit integer residuals,
        # scaled and rotated back to world
        cnt = counts.to(torch.float32)
        la_scale, la_rot, la_trans, la_coeffs = local_affine
        la_scale = _f32(la_scale, dev).reshape(3)
        la_rot = _f32(la_rot, dev).reshape(3, 3)
        la_trans = _f32(la_trans, dev).reshape(3)
        coef = torch.as_tensor(la_coeffs, device=dev).to(torch.int32)
        cxyz = [c.to(torch.int32) for c in morton_decode_u32(vkeys[0])]
        ml = []
        for a, sh in enumerate((20, 10, 0)):
            qsum = seg_sum((sqword >> sh) & 1023, torch.int64)
            base = _int_cell_base(coef, *cxyz, a).to(torch.float32)
            ml.append((base + qsum.to(torch.float32) / cnt) * la_scale[a])
        comps = [la_rot[a, 0] * ml[0] + la_rot[a, 1] * ml[1]
                 + la_rot[a, 2] * ml[2] + la_trans[a] for a in range(3)]
        reduced[position_attribute] = torch.stack(
            [c.to(pdt) for c in comps], dim=1)

    # ---- max: clamped at 0 (centroid_max_pool parity) ----------------------
    for n, c in sorted_cols.items():
        if policy_of(n) != "max":
            continue
        acc = c.dtype if c.dtype.is_floating_point else torch.float32
        v = c.to(acc)
        vm = valid.reshape((cap,) + (1,) * (v.ndim - 1))
        v = torch.where(vm, v, torch.full((), float("-inf"), dtype=acc,
                                          device=dev))
        m = torch.full((2 * cap,) + tuple(v.shape[1:]), float("-inf"),
                       dtype=acc, device=dev)
        index = slot.reshape((cap,) + (1,) * (v.ndim - 1)).expand_as(v)
        m.scatter_reduce_(0, index, v, "amax", include_self=True)
        reduced[n] = _cast_as(torch.clamp(m[:cap], min=0.0), ldt[n])

    # ---- mode: run lengths over (key, value)-sorted values -----------------
    mode_stats: Dict[str, Tuple[torch.Tensor, ...]] = {}
    run_tables: Dict[str, Dict] = {}
    for n in mode_names:
        col = batch.data[n]
        if n == fused_mode:
            # already value-ordered by the packed word of the main sort;
            # sign-extended so "smallest value wins" keeps signed order
            sv = _unpack_field(sword, 32 - mode_bits, mode_bits, ldt[n])
            nk_new, seg_n, sk_n = new_key, seg, skeys
        else:
            # the value as a second sort key: offset so that it is a u32
            val = wrap_to_logical(col, np.int32).to(torch.int64) + (1 << 31)
            s = _tiled_sort(tuple(keys) + (val,), nk + 1, sort_tiles,
                            fused and nk < 2)
            sv = s[nk] - (1 << 31)
            sk_n = s[:nk]
            nk_new = key_changes(sk_n)
            seg_n = torch.cumsum((nk_new & valid).to(torch.int64), 0) - 1
        runs = (nk_new | row_starts([sv])) & valid
        if not with_aux:
            mv = segment_mode(sv, runs, seg_n, valid, cap)
            reduced[n] = _cast_as(mv.to(torch.float32), ldt[n])
            continue
        mv, mc, m2v, m2c, run_len = mode_top2(
            sv, runs, torch.ones_like(sv), seg_n, valid, cap)
        reduced[n] = _cast_as(mv.to(torch.float32), ldt[n])
        mode_stats[n] = (mc, m2v, m2c)
        if mode_runs:
            run_tables[n] = run_table(list(sk_n), sv, run_len, runs, cap,
                                      compact)

    live = row < num_voxels

    def live_or(c: torch.Tensor, fill) -> torch.Tensor:
        lm = live.reshape((cap,) + (1,) * (c.ndim - 1))
        return torch.where(lm, c, torch.full((), fill, dtype=c.dtype,
                                             device=dev))

    out_data = {n: live_or(c, 0) for n, c in reduced.items()}
    out = PointBatch(out_data, num_voxels, batch.schema, batch.meta,
                     batch.policy)
    if not with_aux:
        return out
    i32 = torch.int32
    aux = {
        "keys": tuple(live_or(k, _INVALID_KEY) for k in vkeys),
        "counts": live_or(npts, 0).to(i32),
        "mode_counts": {n: live_or(st[0], 0).to(i32)
                        for n, st in mode_stats.items()},
        "mode2_values": {n: live_or(st[1], 0).to(i32)
                         for n, st in mode_stats.items()},
        "mode2_counts": {n: live_or(st[2], 0).to(i32)
                         for n, st in mode_stats.items()},
        "raw_means": {n: live_or(m, 0.0) for n, m in raw_means.items()},
    }
    if mode_runs:
        aux["mode_runs"] = run_tables
    return out, aux


def row_starts(cols: Sequence[torch.Tensor]) -> torch.Tensor:
    """Row flags: True on row 0 and where any of ``cols`` differs from the
    row above."""
    n = cols[0].shape[0]
    new = torch.ones(n, dtype=torch.bool, device=cols[0].device)
    if n > 1:
        diff = cols[0][1:] != cols[0][:-1]
        for c in cols[1:]:
            diff = diff | (c[1:] != c[:-1])
        new[1:] = diff
    return new


def spare_slots(index: torch.Tensor, keep: torch.Tensor, base: int
                ) -> torch.Tensor:
    """``index`` where ``keep``, else a spare slot of the row's own,
    ``base + row``: a scatter into ``base + len(index)`` slots then never
    makes the left-out rows (a batch's padding, a merge's invalid rows —
    often most of them) contend for one address."""
    rows = torch.arange(index.shape[0], device=index.device)
    return torch.where(keep, index, base + rows)


def mode_top2(values: torch.Tensor, runs: torch.Tensor,
              weights: torch.Tensor, seg: torch.Tensor, valid: torch.Tensor,
              n_out: int):
    """The two best (value, total) runs of each segment of rows sorted by
    (segment, value).  ``runs`` flags the first valid row of every
    (segment, value) run, ``weights`` adds up over the ``valid`` rows of a
    run and ``seg`` is each row's segment id.

    Best means the largest total, ties to the smallest value: a segment
    max, then a second max with each segment's winning run masked out.
    Returns ``(v1, c1, v2, c2, run_total)``: int64 ``(n_out,)`` per segment
    (``v2 = c2 = 0`` where the segment holds one run; all four 0 for an
    id that never occurs) and, per row, its run's total."""
    n = values.shape[0]
    dev = values.device
    run_id = torch.cumsum(runs.to(torch.int64), 0) - 1
    rid = spare_slots(run_id, valid, n)
    tot = torch.zeros(2 * n, dtype=torch.int64, device=dev)
    tot.index_add_(0, rid, torch.where(valid, weights.to(torch.int64),
                                       torch.zeros_like(rid)))
    # each run's segment and value, written from its first row; run ids
    # past the last run keep a spare segment of their own
    at = spare_slots(run_id, runs, n)
    spare = n_out + torch.arange(2 * n, device=dev)
    run_seg = spare.clone().scatter_(0, at, seg.to(torch.int64))
    run_val = torch.zeros(2 * n, dtype=torch.int64, device=dev)
    run_val.scatter_(0, at, values.to(torch.int64))
    run_seg, run_val, run_tot = run_seg[:n], run_val[:n], tot[:n]
    big = torch.iinfo(torch.int64).max

    def best(total):
        """Per segment (largest total, smallest value at it), and each
        run's flag of being that winner; a run with a negative total never
        wins."""
        c = torch.full((n_out + n,), -1, dtype=torch.int64, device=dev)
        c.scatter_reduce_(0, run_seg, total, "amax", include_self=True)
        at_best = (total >= 0) & (total == c[run_seg])
        v = torch.full((n_out + n,), big, dtype=torch.int64, device=dev)
        v.scatter_reduce_(0, spare_slots(run_seg, at_best, n_out), run_val,
                          "amin", include_self=True)
        win = at_best & (run_val == v[run_seg])
        c, v = c[:n_out], v[:n_out]
        has = c >= 0
        return (torch.where(has, v, torch.zeros_like(v)),
                torch.clamp(c, min=0), win)

    v1, c1, win1 = best(run_tot)
    v2, c2, _ = best(torch.where(win1, torch.full_like(run_tot, -1),
                                 run_tot))
    v2 = torch.where(c2 > 0, v2, torch.zeros_like(v2))
    return v1, c1, v2, c2, tot[rid]


def run_table(keys: List[torch.Tensor], values: torch.Tensor,
              totals: torch.Tensor, keep: torch.Tensor, cap: int,
              compact=compact_columns) -> Dict:
    """The run table of the rows ``keep`` flags (one row per (voxel,
    value) run): their keys, values and totals compacted to the front by
    ``compact`` (``compact_columns``: the compaction kernel on the GPU),
    ``cap`` rows (cut or padded), rows past the run count holding the
    invalid key and zeros."""
    nk = len(keys)
    cols, nruns = compact(
        list(keys) + [values.to(torch.int32), totals.to(torch.int32)], keep)
    dev = values.device
    rn = cols[0].shape[0]
    rvalid = torch.arange(rn, dtype=torch.int32, device=dev) < nruns

    def fit(c: torch.Tensor, pad) -> torch.Tensor:
        c = torch.where(rvalid, c, torch.full((), pad, dtype=c.dtype,
                                              device=dev))
        if cap <= rn:
            return c[:cap]
        return torch.cat([c, torch.full((cap - rn,), pad, dtype=c.dtype,
                                        device=dev)])

    return {"keys": tuple(fit(k, _INVALID_KEY) for k in cols[:nk]),
            "values": fit(cols[nk], 0), "counts": fit(cols[nk + 1], 0),
            "num_runs": nruns}
