"""Fused voxel reduction + compaction — the post-sort half of the voxel
pipeline, in the three forms of its position operands.

Input: the tile-sorted operands of ops/voxel.py's fast path — Morton key,
the packed secondary word (mode value in the top bits, narrow mean fields
below), and the positions in one of three forms:

* **exact-local** (``sqword`` + ``local_affine=``): a word of three exact
  10-bit local residuals; centroid = affine image of cell base + exact
  residual mean;
* **quantized** (``sqword`` alone): a word of three ``qbits``-bit in-cell
  residuals; centroid = ``(cell + (mean + 0.5) * qwindow / 2**qbits) * leaf
  + bounds_min``, the cell decoded from the key;
* **exact-f32** (``spos=(px, py, pz)``): three sorted f32 streams; centroid
  = their mean over the voxel, accumulated in f64 and rounded once.

The sort runs per spatial tile, so no voxel spans a tile and every
reduction is tile-local.

Replaces: pasture_tpu/ops/kernels/voxel_reduce_kernel.py
fused_sorted_voxel_reduce (_make_kernel with _seg_totals, _seg_max,
_tiered_ladder, _compact10), all three forms, together with the merge of
per-block outputs that followed it there (ops/compact.py _merge_tiles).
Bound on the H100: bytes — 12 B (20 B for exact-f32) read per row, and
every output row written once: 16 B per voxel and per zeroed row alike.
Design (``csrc/voxel_reduce.cu``): one launch, one pass.  A warp stages a
chunk of whole tiles (512 rows) in shared memory with 16-byte asynchronous
copies and walks it 32 rows a round, a row a lane: ballots of the
run-start flags rank each voxel in its chunk.  A CTA's eight chunks add
their counts, and the CTA's global offset comes from a decoupled look-back
over the CTAs before it (numbered by ticket, status words in a small
zeroed scratch).  The lane holding a run's start walks the run (a handful
of points) and writes the voxel at offset + rank — globally compacted in
(tile, Morton) order with no merge pass.  The last CTA writes the voxel
count, which stays on the device; a second small launch zeroes the rows at
or past it, so the outputs come from ``torch.empty`` and no row is written
twice.

Integer sums are exact (int32 where :func:`narrow_field_sums` proves it,
else int64); a mean is ``float32(sum) / float32(count)``.
That equals the f32 running sum of the reference whenever the latter is
exact (sums below 2**24).  The exact-local and quantized forms therefore
equal their plain versions bit for bit.  The exact-f32 form sums floats:
the kernel's thread adds its run serially, the plain version through
``index_add_``, both in f64, so they agree to the last f32 bit except
where the two f64 sums straddle a rounding boundary.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ...math.morton import morton_decode_u32
from ..convert import u32_bits, u32_carrier
from . import _build
from .fused_transform import _f32, _int_cell_base

__all__ = ["fused_sorted_voxel_reduce", "fused_sorted_voxel_reduce_rows",
           "fused_sorted_voxel_reduce_plain", "supports_fused_reduce",
           "narrow_field_sums", "chunk_count", "LAUNCHES", "MAX_TILE_LEN",
           "MAX_FIELDS", "CHUNK_ROWS"]

#: launches of the kernel by position form (the reduce launch and the
#: zero-tail launch of one call count as one)
LAUNCHES = {"fused_sorted_voxel_reduce": 0,             # exact-local
            "fused_sorted_voxel_reduce_quantized": 0,
            "fused_sorted_voxel_reduce_exact_f32": 0}

_INVALID = 0xFFFFFFFF
# 3 streams x 4096 rows x 4 B = 48 KiB of shared memory; the exact-f32 form
# holds 5 streams = 80 KiB, within the 227 KiB a block can opt in to
MAX_TILE_LEN = 4096
MAX_FIELDS = 4
CHUNK_ROWS = 512     # VR_CHUNK of csrc/voxel_reduce.cu: a warp's whole tiles

# position forms, as csrc/voxel_reduce.cu numbers them
_EXACT_LOCAL, _QUANTIZED, _EXACT_F32 = 0, 1, 2
_FORM_COUNTER = ("fused_sorted_voxel_reduce",
                 "fused_sorted_voxel_reduce_quantized",
                 "fused_sorted_voxel_reduce_exact_f32")


def supports_fused_reduce(n: int, tile_len: int, n_fields: int = 0) -> bool:
    """Static feasibility: whole tiles that fit one block's shared memory."""
    return (n > 0 and 0 < tile_len <= MAX_TILE_LEN and n % tile_len == 0
            and n < (1 << 31) and n_fields <= MAX_FIELDS)


def _check_args(skey, tile_len, fields, qbits, sqword, spos, local_affine
                ) -> int:
    """Validate and return the position form."""
    if (sqword is None) == (spos is None):
        raise ValueError("pass exactly one of sqword / spos")
    if spos is not None and local_affine is not None:
        raise ValueError("local_affine goes with sqword, not with spos")
    if spos is not None and len(spos) != 3:
        raise ValueError("spos must be three streams (px, py, pz)")
    if local_affine is not None and qbits != 10:
        raise ValueError("the exact-local form needs qbits == 10")
    if spos is None and local_affine is None \
            and not (1 <= qbits and 3 * qbits <= 32):
        raise ValueError(f"the quantized form needs 3 * qbits <= 32, got "
                         f"qbits={qbits}")
    if not supports_fused_reduce(skey.shape[0], tile_len, len(fields)):
        raise ValueError(f"unsupported fused reduce: n={skey.shape[0]}, "
                         f"tile_len={tile_len}, fields={len(fields)}")
    if spos is not None:
        return _EXACT_F32
    return _EXACT_LOCAL if local_affine is not None else _QUANTIZED


def chunk_count(tiles: int, tile_len: int) -> int:
    """Chunks of a call: a warp's share of its CTA's rows, the whole tiles
    that fit ``CHUNK_ROWS`` rows (one tile when tiles are longer)."""
    chunk_tiles = max(1, CHUNK_ROWS // tile_len)
    return -(-tiles // chunk_tiles)


def narrow_field_sums(fields: Sequence[Tuple[int, int, bool, int, int]],
                      tile_len: int) -> bool:
    """Whether the kernel may sum every mean field in int32: a run lies in
    one tile, so its sum is below ``2**(width + ceil(log2(tile_len)))`` in
    magnitude, and ``width + ceil(log2(tile_len)) <= 31`` keeps it in
    range; the clip bounds, as the f32 values the kernel compares with,
    must be int32 values too, for the mean's conversion back."""
    grow = (int(tile_len) - 1).bit_length()          # ceil(log2(tile_len))
    return all(int(fw) + grow <= 31
               and -2.0 ** 31 <= float(np.float32(imin))
               and float(np.float32(imax)) < 2.0 ** 31
               for _, fw, _, imin, imax in fields)


def _scale_q(qbits: int, qwindow: float) -> float:
    """Width of one residual step in leaves, rounded to f32 once: a host
    scalar for the kernel and the plain version alike."""
    return float(np.float32(float(qwindow) / float(1 << qbits)))


def _leaf_f32(leaf_size) -> float:
    return float(np.float32(float(leaf_size)))


def _field_mask(width: int) -> int:
    return (1 << width) - 1


def segment_mode(values: torch.Tensor, run_start: torch.Tensor,
                 seg: torch.Tensor, valid: torch.Tensor, n_out: int
                 ) -> torch.Tensor:
    """Run-length mode per segment of value-sorted rows: the value of the
    longest run, ties to the smallest value.  ``run_start`` flags the first
    row of each (segment, value) run, ``seg`` is each row's segment id
    (rows that are not ``valid`` are ignored).  Returns int64 ``(n_out,)``
    (zero where a segment id never occurs)."""
    n = values.shape[0]
    one = valid.to(torch.int64)
    run_id = torch.cumsum(run_start.to(torch.int64), 0) - 1
    run_id = torch.where(valid, run_id, torch.full_like(run_id, n))
    run_len = torch.zeros(n + 1, dtype=torch.int64, device=values.device)
    run_len.index_add_(0, run_id, one)
    row_len = torch.where(valid, run_len[run_id], torch.zeros_like(one))
    dump = torch.where(valid, seg, torch.full_like(seg, n_out))
    best = torch.zeros(n_out + 1, dtype=torch.int64, device=values.device)
    best.scatter_reduce_(0, dump, row_len, "amax", include_self=True)
    is_best = valid & (row_len == best[dump])
    big = torch.iinfo(torch.int64).max
    mode = torch.full((n_out + 1,), big, dtype=torch.int64,
                      device=values.device)
    mode.scatter_reduce_(
        0, torch.where(is_best, dump, torch.full_like(dump, n_out)),
        values.to(torch.int64), "amin", include_self=True)
    mode = mode[:n_out]
    return torch.where(mode == big, torch.zeros_like(mode), mode)


def fused_sorted_voxel_reduce_plain(
        skey, sword, sqword, bounds_min, leaf_size, mode_bits: int,
        fields: Sequence[Tuple[int, int, bool, int, int]], qbits: int,
        qwindow: float, tile_len: int, semantics: str = "floor",
        spos=None, local_affine=None):
    """Plain PyTorch version of :func:`fused_sorted_voxel_reduce_rows`
    (``out_word`` in carrier form)."""
    form = _check_args(skey, tile_len, fields, qbits, sqword, spos,
                       local_affine)
    key = u32_carrier(skey)
    word = u32_carrier(sword)
    dev = key.device
    n = key.shape[0]

    valid = key != _INVALID
    idx = torch.arange(n, device=dev)
    differs = torch.ones(n, dtype=torch.bool, device=dev)
    differs[1:] = key[1:] != key[:-1]
    first = valid & (differs | (idx % tile_len == 0))
    seg = torch.cumsum(first.to(torch.int64), 0) - 1
    num_voxels = first.sum().to(torch.int32)
    dump = torch.where(valid, seg, torch.full_like(seg, n))

    def seg_sum(v):
        out = torch.zeros(n + 1, dtype=torch.int64, device=dev)
        out.index_add_(0, dump, torch.where(valid, v, torch.zeros_like(v)))
        return out[:n]

    cnt = torch.clamp(seg_sum(torch.ones_like(key)), min=1).to(torch.float32)

    out_word = torch.zeros(n, dtype=torch.int64, device=dev)
    if mode_bits:
        mv = word >> (32 - mode_bits)
        mdiff = torch.ones(n, dtype=torch.bool, device=dev)
        mdiff[1:] = mv[1:] != mv[:-1]
        mode = segment_mode(mv, first | (valid & mdiff), seg, valid, n)
        out_word = mode << (32 - mode_bits)
    for fsh, fw, fsigned, imin, imax in fields:
        v = (word >> fsh) & _field_mask(fw)
        if fsigned:
            sb = 1 << (fw - 1)
            v = (v ^ sb) - sb
        t = torch.trunc(seg_sum(v).to(torch.float32) / cnt)
        t = torch.clamp(t, float(imin), float(imax))
        out_word = out_word | ((t.to(torch.int64) & _field_mask(fw)) << fsh)

    if form == _EXACT_F32:
        cnt64 = cnt.to(torch.float64)
        pos = []
        for c in spos:
            acc = torch.zeros(n + 1, dtype=torch.float64, device=dev)
            acc.index_add_(0, dump, torch.where(
                valid, c.to(torch.float64),
                torch.zeros((), dtype=torch.float64, device=dev)))
            pos.append((acc[:n] / cnt64).to(torch.float32))
    else:
        rword = u32_carrier(sqword)
        q = 10 if form == _EXACT_LOCAL else qbits
        qmeans = [seg_sum((rword >> sh) & _field_mask(q)).to(torch.float32)
                  / cnt for sh in (2 * q, q, 0)]
        # key of each voxel: its run's first row, moved to the voxel's slot
        vkey = torch.zeros(n + 1, dtype=torch.int64, device=dev)
        vkey.index_copy_(0, torch.where(first, seg, torch.full_like(seg, n)),
                         key)
        cells = [c.to(torch.int32) for c in morton_decode_u32(vkey[:n])]
        if form == _EXACT_LOCAL:
            scale, rot, trans, coeffs = local_affine
            scale = _f32(scale, dev).reshape(3)
            rot = _f32(rot, dev).reshape(3, 3)
            trans = _f32(trans, dev).reshape(3)
            coef = torch.as_tensor(coeffs, device=dev).to(torch.int32)
            ml = [(_int_cell_base(coef, *cells, a).to(torch.float32)
                   + qmeans[a]) * scale[a] for a in range(3)]
            pos = [rot[a, 0] * ml[0] + rot[a, 1] * ml[1] + rot[a, 2] * ml[2]
                   + trans[a] for a in range(3)]
        else:
            bmin = _f32(bounds_min, dev).reshape(3)
            leaf, scale_q = _leaf_f32(leaf_size), _scale_q(qbits, qwindow)
            pos = [(cells[a].to(torch.float32) + (qmeans[a] + 0.5) * scale_q)
                   * leaf + bmin[a] for a in range(3)]
    live = idx < num_voxels
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    rows = torch.where(live[:, None], torch.stack(pos, dim=1), zero)
    out_word = torch.where(live, out_word, torch.zeros_like(out_word))
    return rows, out_word, num_voxels


def fused_sorted_voxel_reduce_rows(
        skey: torch.Tensor, sword: torch.Tensor, sqword: torch.Tensor,
        bounds_min, leaf_size, mode_bits: int,
        fields: Sequence[Tuple[int, int, bool, int, int]], qbits: int,
        qwindow: float, tile_len: int, semantics: str = "floor",
        spos: Optional[tuple] = None, local_affine: Optional[tuple] = None):
    """All post-sort voxel work of the fast path.  ``skey``, ``sword`` are
    the tile-sorted u32 streams (either form); ``fields`` lists the mean
    fields packed in ``sword`` below the top ``mode_bits`` as ``(shift,
    width, signed, min, max)``.  Positions, one of three forms:

    * ``sqword`` — the QUANTIZED form: a word of three ``qbits``-bit
      residuals of window ``qwindow`` leaves (1.0 floor, 1.5 nearest); the
      centroid is rebuilt from the key's cell, ``bounds_min`` and
      ``leaf_size``;
    * ``sqword`` + ``local_affine=(scale, rot, trans, coeffs)`` — the
      EXACT-LOCAL form, with the SAME ``exact_local_base_coeffs`` tensor
      the head used (``qbits`` must be 10; ``bounds_min``, ``leaf_size``,
      ``qwindow`` are not read);
    * ``spos=(px, py, pz)`` with ``sqword=None`` — the EXACT-f32 form: three
      sorted f32 streams, the centroid their mean (``qbits`` is not read).

    ``semantics`` is accepted for the shape of the function this is ported
    from; the window it implies arrives as ``qwindow``.

    Returns ``(pos, out_word, num_voxels)``: rows ``[0, num_voxels)`` of
    the (N, 3) f32 ``pos`` and of ``out_word`` hold the voxels in (tile,
    Morton) order, globally compacted; rows past ``num_voxels`` are zero.
    ``num_voxels`` is a 0-d int32 tensor on the streams' device (no host
    round trip).  On CUDA tensors the kernel runs and ``out_word`` is in
    bits form (int32); on CPU tensors the plain version returns carrier
    form."""
    if not skey.is_cuda:
        return fused_sorted_voxel_reduce_plain(
            skey, sword, sqword, bounds_min, leaf_size, mode_bits, fields,
            qbits, qwindow, tile_len, semantics, spos, local_affine)
    form = _check_args(skey, tile_len, fields, qbits, sqword, spos,
                       local_affine)
    dev = skey.device
    key = u32_bits(skey).contiguous()
    word = u32_bits(sword).contiguous()
    if form == _EXACT_F32:
        if any(c.dtype != torch.float32 for c in spos):
            raise TypeError("spos streams must be float32")
        rest = [c.contiguous() for c in spos]
    else:
        rest = [u32_bits(sqword).contiguous()]
    n = key.shape[0]
    if any(t.shape != key.shape or t.device != dev for t in [word] + rest):
        raise ValueError("streams must be 1-D, of one length, on one device")
    tiles = n // tile_len
    params = coef = None
    if form == _EXACT_LOCAL:
        scale, rot, trans, coeffs = local_affine
        params = torch.cat([_f32(scale, dev).reshape(3),
                            _f32(rot, dev).reshape(9),
                            _f32(trans, dev).reshape(3)]).contiguous()
        coef = torch.as_tensor(coeffs, device=dev).to(
            torch.int32).contiguous()
        if coef.numel() != 15:
            raise ValueError("coeffs must hold 15 int32 values")
    elif form == _QUANTIZED:
        # leaf and the residual step are host scalars: filled in on the
        # device, no copy from host memory that would wait for the stream
        params = torch.cat([
            _f32(bounds_min, dev).reshape(3),
            torch.full((1,), _leaf_f32(leaf_size), dtype=torch.float32,
                       device=dev),
            torch.full((1,), _scale_q(qbits, qwindow), dtype=torch.float32,
                       device=dev)]).contiguous()
    nf = len(fields)
    f_ints = (ctypes.c_int * (3 * MAX_FIELDS))()
    f_floats = (ctypes.c_float * (2 * MAX_FIELDS))()
    for i, (fsh, fw, fsigned, imin, imax) in enumerate(fields):
        f_ints[3 * i:3 * i + 3] = [int(fsh), int(fw), int(bool(fsigned))]
        f_floats[2 * i:2 * i + 2] = [float(imin), float(imax)]

    def ptr(t):
        return None if t is None else t.data_ptr()

    chunks = chunk_count(tiles, tile_len)
    # the ticket and the CTAs' status words (no more CTAs than chunks): the
    # call's only memset
    status = torch.zeros(chunks + 1, dtype=torch.int64, device=dev)
    num_voxels = torch.empty((), dtype=torch.int32, device=dev)
    pos = torch.empty((n, 3), dtype=torch.float32, device=dev)
    out_word = torch.empty(n, dtype=torch.int32, device=dev)
    lib = _build.library("voxel_reduce")
    with torch.cuda.device(dev):
        # streams 3 to 5: the residual word and two nulls, or px, py, pz
        operands = [ptr(c) for c in rest] + [None] * (3 - len(rest))
        code = lib.voxel_reduce_launch(
            form, int(not narrow_field_sums(fields, tile_len)),
            key.data_ptr(), word.data_ptr(), *operands, tiles, tile_len,
            chunks, status.data_ptr(), num_voxels.data_ptr(), ptr(params),
            ptr(coef), int(qbits) if form == _QUANTIZED else 0,
            int(mode_bits), nf, ctypes.cast(f_ints, ctypes.c_void_p),
            ctypes.cast(f_floats, ctypes.c_void_p), pos.data_ptr(),
            out_word.data_ptr(), _build.stream())
        _build.check(code, "fused_sorted_voxel_reduce")
    LAUNCHES[_FORM_COUNTER[form]] += 1
    return pos, out_word, num_voxels


def fused_sorted_voxel_reduce(
        skey: torch.Tensor, sword: torch.Tensor, sqword: torch.Tensor,
        bounds_min, leaf_size, mode_bits: int,
        fields: Sequence[Tuple[int, int, bool, int, int]], qbits: int,
        qwindow: float, tile_len: int, semantics: str = "floor",
        spos: Optional[tuple] = None, local_affine: Optional[tuple] = None):
    """:func:`fused_sorted_voxel_reduce_rows` with the centroid as three
    streams, the shape of the function it is ported from: returns ``(px,
    py, pz, out_word, num_voxels)``, the three being column views of the
    (N, 3) position tensor."""
    pos, out_word, num_voxels = fused_sorted_voxel_reduce_rows(
        skey, sword, sqword, bounds_min, leaf_size, mode_bits, fields, qbits,
        qwindow, tile_len, semantics, spos, local_affine)
    return pos[:, 0], pos[:, 1], pos[:, 2], out_word, num_voxels
