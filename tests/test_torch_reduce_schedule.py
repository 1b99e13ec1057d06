"""Plain models of the CUDA schedules of K3 (``fused_sorted_voxel_reduce``)
and K5 (``blockwise_compact``), each held bit for bit to the kernel's plain
version on the adversarial inputs of ``chip_smoke``'s sweeps (CPU).

The kernels run only on the card; what these tests hold is the partition
the kernels' exactness rests on: for K3, chunks of whole tiles walked 32
rows a round with a row a lane, ranks from the ballots of the run-start
flags, runs owned by the lane that holds their start and followed across
lanes and rounds to the tile's end, the chunks' offsets from a look-back
(computed serially here), and the 32-/64-bit field-sum choice; for K5,
2048-row blocks ranked by 16-flag groups, look-back offsets, each column
staged in slabs of at most ``SLAB_BYTES`` and written as byte-contiguous
spans, and the zero tail."""

import numpy as np
import pytest
import torch

import chip_smoke
from pasture_tpu_torch.math.morton import morton_decode_u32
from pasture_tpu_torch.ops.convert import u32_carrier
from pasture_tpu_torch.ops.kernels import compact_kernel as ck
from pasture_tpu_torch.ops.kernels import voxel_reduce_kernel as vr
from pasture_tpu_torch.ops.kernels.fused_transform import (
    _int_cell_base, exact_local_base_coeffs)

T = torch.from_numpy
INVALID = 0xFFFFFFFF


# ---- K3 ------------------------------------------------------------------

def _popc(b: int) -> int:
    return bin(b).count("1")


def _k3_voxels(key: np.ndarray, tile_len: int):
    """The kernel's partition of the rows into voxels: ``(rank, first row,
    end row)`` per voxel, from the two walks of each chunk."""
    tiles = key.shape[0] // tile_len
    chunk_tiles = max(1, vr.CHUNK_ROWS // tile_len)
    chunks = vr.chunk_count(tiles, tile_len)
    spans, totals, ballots = [], [], []
    for c in range(chunks):
        row0 = c * chunk_tiles * tile_len
        rows = min(chunk_tiles, tiles - c * chunk_tiles) * tile_len
        k = key[row0:row0 + rows].astype(np.int64)
        r = np.arange(rows)
        prev = np.concatenate([[-1], k[:-1]])
        start = (k != INVALID) & ((r % tile_len == 0) | (k != prev))
        rounds = -(-rows // 32)
        padded = np.zeros(rounds * 32, bool)
        padded[:rows] = start
        bal = [int(sum(1 << lane for lane in np.flatnonzero(g)))
               for g in padded.reshape(rounds, 32)]
        ballots.append((row0, rows, bal))
        totals.append(sum(_popc(b) for b in bal))
    # the look-back's result: each chunk's exclusive prefix, serially
    excl = np.concatenate([[0], np.cumsum(totals)[:-1]]).astype(int)
    for (row0, rows, bal), base in zip(ballots, excl):
        for m, b in enumerate(bal):
            for lane in range(32):
                if not (b >> lane) & 1:
                    continue
                i = 32 * m + lane
                end = i - i % tile_len + tile_len        # the tile's end
                j = i
                while j < end and key[row0 + j] == key[row0 + i]:
                    j += 1                     # into later lanes and rounds
                spans.append((base + _popc(b & ((1 << lane) - 1)),
                              row0 + i, row0 + j))
            base += _popc(b)
    return spans


def _mode(values: np.ndarray) -> int:
    """Run-length mode of a walk: the longest run, ties to the smallest."""
    best_val, best_len, cur_val, cur_len = 0, 0, None, 0
    for v in values.tolist():
        cur_len = cur_len + 1 if v == cur_val else 1
        cur_val = v
        if cur_len > best_len or (cur_len == best_len and v < best_val):
            best_val, best_len = v, cur_len
    return best_val


def _k3_model(key, word, rword, pos, tile_len, mode_bits, fields, form,
              qbits, local_affine, bmin):
    """The kernel's schedule in plain numpy and PyTorch: voxels from
    :func:`_k3_voxels`, field sums in the accumulator
    :func:`narrow_field_sums` picks (int32 sums checked against exact
    ones), the per-voxel f32 arithmetic of ``csrc/voxel_reduce.cu``, rows
    at offset + rank and zeros after the last."""
    n = key.shape[0]
    spans = _k3_voxels(key, tile_len)
    nv = len(spans)
    assert sorted(s[0] for s in spans) == list(range(nv))
    acc = np.int32 if vr.narrow_field_sums(fields, tile_len) else np.int64
    w64 = word.astype(np.int64)
    cnt = np.zeros(nv, np.int64)
    vkey = np.zeros(nv, np.int64)
    fsum = np.zeros((len(fields), nv), np.int64)
    mode = np.zeros(nv, np.int64)
    rsum = np.zeros((3, nv), np.int64)
    psum = np.zeros((nv, 3), np.float64)
    q = 10 if form == "exact_local" else qbits
    for rank, a, b in spans:
        cnt[rank], vkey[rank] = b - a, key[a]
        w = w64[a:b]
        for f, (fsh, fw, signed, _, _) in enumerate(fields):
            v = (w >> fsh) & ((1 << fw) - 1)
            if signed:
                v = (v ^ (1 << (fw - 1))) - (1 << (fw - 1))
            s = np.add.reduce(v.astype(acc), dtype=acc)
            assert int(s) == int(v.sum())       # the accumulator suffices
            fsum[f, rank] = s
        if mode_bits:
            mode[rank] = _mode(w >> (32 - mode_bits))
        r = rword[a:b].astype(np.int64)
        for axis, sh in enumerate((2 * q, q, 0)):
            rsum[axis, rank] = ((r >> sh) & ((1 << q) - 1)).sum()
        for j in range(a, b):                      # serial, as the lane adds
            psum[rank] += pos[j].astype(np.float64)
    cntf = T(cnt).to(torch.float32)
    out_word = T(mode) << (32 - mode_bits) if mode_bits else T(mode) * 0
    for f, (fsh, fw, _, lo, hi) in enumerate(fields):
        t = torch.trunc(T(fsum[f]).to(torch.float32) / cntf)
        t = torch.clamp(t, float(np.float32(lo)), float(np.float32(hi)))
        out_word = out_word | ((t.to(torch.int64) & ((1 << fw) - 1)) << fsh)
    if form == "exact_f32":
        rows = (T(psum) / T(cnt)[:, None].to(torch.float64)).to(torch.float32)
    else:
        means = [T(rsum[a]).to(torch.float32) / cntf for a in range(3)]
        cells = [c.to(torch.int32) for c in morton_decode_u32(T(vkey))]
        if form == "exact_local":
            scale, rot, trans, coef = local_affine
            ml = [(_int_cell_base(coef, *cells, a).to(torch.float32)
                   + means[a]) * scale[a] for a in range(3)]
            rows = torch.stack([rot[a, 0] * ml[0] + rot[a, 1] * ml[1]
                                + rot[a, 2] * ml[2] + trans[a]
                                for a in range(3)], dim=1)
        else:
            leaf = torch.tensor(np.float32(chip_smoke.LEAF))
            step = torch.tensor(np.float32(1.0 / (1 << qbits)))
            rows = torch.stack([(cells[a].to(torch.float32)
                                 + (means[a] + 0.5) * step) * leaf + bmin[a]
                                for a in range(3)], dim=1)
    out_pos = torch.zeros((n, 3), dtype=torch.float32)
    out_pos[:nv] = rows
    full_word = torch.zeros(n, dtype=torch.int64)
    full_word[:nv] = out_word
    return out_pos, full_word, nv


@pytest.mark.parametrize("tile_len", [1, 3, 17, 100, 512, 1000])
@pytest.mark.parametrize("layout", [1, 3, 4])
@pytest.mark.parametrize("form", ["exact_local", "quantized", "exact_f32"])
def test_reduce_schedule_model_equals_plain(tile_len, layout, form):
    """The K3 schedule, modelled, against ``fused_sorted_voxel_reduce_plain``
    on the sweep's adversarial tiles (whole-tile runs, distinct keys,
    invalid tiles, runs on 16- and 32-row boundaries and across them),
    three chunks a call: count and ``out_word`` exact, centroids bit for
    bit (exact-local, quantized) or within atol 1e-5 + rtol 1e-6
    (exact-f32, whose invalid rows are NaN)."""
    mode_bits, fields = chip_smoke.REDUCE_SWEEP_WORDS[layout]
    tiles = 3 * max(1, vr.CHUNK_ROWS // tile_len)
    key, word, rword, pos = chip_smoke.reduce_sweep_streams(tile_len, tiles)
    qbits = 10 if form == "exact_local" else 7
    scale, rot, trans = chip_smoke.affine_on("cpu")
    coef = exact_local_base_coeffs(chip_smoke.SCALE, chip_smoke.ROT,
                                   chip_smoke.TRANS, torch.zeros(3),
                                   chip_smoke.LEAF, "floor")
    local_affine = (scale, rot, trans, coef)
    bmin = torch.tensor([-3.0, 2.0, 1.0])
    kw = {}
    if form == "exact_f32":
        kw["spos"] = tuple(T(np.ascontiguousarray(pos[:, a]))
                           for a in range(3))
        args = (T(key.view(np.int32)), T(word.view(np.int32)), None, bmin,
                chip_smoke.LEAF, mode_bits, fields, 0, 1.0, tile_len)
    else:
        if form == "exact_local":
            kw["local_affine"] = local_affine
        args = (T(key.view(np.int32)), T(word.view(np.int32)),
                T(rword.view(np.int32)), bmin, chip_smoke.LEAF, mode_bits,
                fields, qbits, 1.0, tile_len)
    ppos, pword, pcount = vr.fused_sorted_voxel_reduce_plain(*args, **kw)
    mpos, mword, nv = _k3_model(key, word, rword, pos, tile_len, mode_bits,
                                fields, form, qbits,
                                (scale, rot.to(torch.float32), trans, coef),
                                bmin)
    assert nv == int(pcount) and 0 < nv < key.shape[0]
    assert torch.equal(mword, u32_carrier(pword))
    if form == "exact_f32":
        torch.testing.assert_close(mpos, ppos, rtol=1e-6, atol=1e-5)
    else:
        assert torch.equal(mpos.view(torch.int32), ppos.view(torch.int32))


@pytest.mark.parametrize("fields,tile_len,narrow", [
    ((), 4096, True),
    (((8, 16, False, 0, 65535),), 512, True),        # the main path
    (((8, 16, False, 0, 65535),), 32768, True),      # 16 + 15 = 31
    (((8, 16, False, 0, 65535),), 32769, False),     # 16 + 16 = 32
    (((0, 22, True, -(1 << 21), (1 << 21) - 1),), 512, True),
    (((0, 23, True, -(1 << 22), (1 << 22) - 1),), 512, False),
    (((0, 31, False, 0, (1 << 31) - 1),), 1, False),  # f32(2**31 - 1) = 2**31
    (((0, 31, False, 0, (1 << 30)),), 1, True),
    (((0, 32, False, 0, (1 << 32) - 1),), 1, False),
    (((0, 8, False, 0, 255), (8, 24, True, -5, 5)), 256, False),
])
def test_narrow_field_sums_rule(fields, tile_len, narrow):
    """int32 field sums only where ``width + ceil(log2(tile_len)) <= 31``
    for every field and its clip bounds, as f32, are int32 values."""
    assert vr.narrow_field_sums(fields, tile_len) is narrow


def test_reduce_chunks_hold_whole_tiles():
    assert vr.chunk_count(8192, 512) == 8192
    assert vr.chunk_count(100, 100) == 20          # 5 tiles of 100 a chunk
    assert vr.chunk_count(1024, 1) == 2
    assert vr.chunk_count(7, 4096) == 7
    assert vr.chunk_count(31, 17) == 2             # 30 tiles, then 1


# ---- K5 ------------------------------------------------------------------

def _part_rows(group_bytes: int) -> int:
    """Rows of a block that a launch whose columns' rows have
    ``group_bytes`` bytes together stages at once (``csrc/compact.cu``)."""
    return min(ck.ROWS_PER_BLOCK, ck.LAUNCH_ROW_BYTES // group_bytes)


def _k5_model(cols, keep):
    """The kernel's schedule in numpy, on raw row bytes: per 2048-row block
    the ranks from 16-flag groups and the blocks' offsets by a look-back
    (serially here); the columns in the launches of ``launch_groups``, each
    launch staging every column's rows of a block in parts of
    ``_part_rows`` rows and writing each kept row at offset + rank; the
    rows past the count zero."""
    n = keep.shape[0]
    per = ck.ROWS_PER_BLOCK
    blocks = -(-n // per)
    ranks, totals = [], []
    for b in range(blocks):
        flags = np.zeros(per, bool)
        part = keep[b * per:(b + 1) * per]
        flags[:part.shape[0]] = part
        groups = flags.reshape(per // 16, 16)
        gcount = groups.sum(axis=1)
        gexcl = np.concatenate([[0], np.cumsum(gcount)[:-1]])
        within = np.cumsum(groups, axis=1) - groups
        ranks.append((gexcl[:, None] + within).ravel())
        totals.append(int(gcount.sum()))
    excl = np.concatenate([[0], np.cumsum(totals)[:-1]]).astype(int)
    raws = [np.ascontiguousarray(c).view(np.uint8).reshape(n, -1)
            for c in cols]
    outs = [np.zeros_like(r) for r in raws]
    written = [np.zeros(n, bool) for _ in raws]
    for group in ck.launch_groups([r.shape[1] for r in raws]):
        step = _part_rows(sum(raws[i].shape[1] for i in group))
        for b in range(blocks):
            rows = min(per, n - b * per)
            for r0 in range(0, rows, step):
                r = np.arange(r0, min(rows, r0 + step))
                r = r[keep[b * per + r]]
                o = excl[b] + ranks[b][r]
                for i in group:
                    assert not written[i][o].any()     # each row once
                    written[i][o] = True
                    outs[i][o] = raws[i][b * per + r]
    return [o.view(c.dtype).reshape(c.shape) for o, c in zip(outs, cols)], \
        int(sum(totals))


def _k5_inputs(rng, n, keep):
    cols = []
    for dt, per, off in chip_smoke.COMPACT_SWEEP_COLS:
        npdt = torch.empty((), dtype=dt).numpy().dtype
        flat = rng.integers(0, 256, (n * per + off) * npdt.itemsize,
                            dtype=np.uint8).view(npdt)[off:off + n * per]
        cols.append(flat if per == 1 else flat.reshape(n, per))
    idx = np.arange(n)
    mask = {"all": idx >= 0, "none": idx < 0, "alternate": idx % 2 == 0,
            "10%": rng.random(n) < 0.1, "90%": rng.random(n) < 0.9}[keep]
    return cols, mask


@pytest.mark.parametrize("n", [1, 31, 2047, 2048, 2049, 6000])
@pytest.mark.parametrize("keep", chip_smoke.COMPACT_SWEEP_KEEPS)
def test_compact_schedule_model_equals_plain(rng, n, keep):
    """The K5 schedule, modelled, against ``blockwise_compact_plain`` on
    the sweep's nine columns (rows of 1-17 bytes, some starting at an odd
    element): the count and every byte of every column, tail included."""
    cols, mask = _k5_inputs(rng, n, keep)
    got, count = _k5_model(cols, mask)
    want, wcount = ck.blockwise_compact_plain([T(c) for c in cols], T(mask))
    assert count == int(wcount) == int(mask.sum())
    for g, w in zip(got, want):
        assert g.dtype == w.numpy().dtype and g.shape == tuple(w.shape)
        np.testing.assert_array_equal(g.view(np.uint8),
                                      w.numpy().view(np.uint8))


def test_compact_launch_groups_and_parts(rng):
    """Columns share a launch up to eight at a time and ``LAUNCH_ROW_BYTES``
    bytes of a row; a launch stages a block's rows whole while they fit,
    fewer rows at a time after.  A 4000-byte row: nine rows a part."""
    assert ck.launch_groups([1, 2, 3, 4, 8, 12, 16, 17, 12]) == [
        list(range(8)), [8]]
    big = ck.LAUNCH_ROW_BYTES
    assert ck.launch_groups([12, big - 12, 1]) == [[0, 1], [2]]
    with pytest.raises(ValueError, match="bytes"):
        ck.launch_groups([big + 1])
    assert _part_rows(17) == ck.ROWS_PER_BLOCK
    assert _part_rows(63) == 581                # the sweep's eight columns
    assert _part_rows(4000) == 9 and _part_rows(big) == 1
    n = 3000
    col = rng.integers(0, 256, (n, 4000), dtype=np.uint8)
    mask = rng.random(n) < 0.5
    (got,), count = _k5_model([col], mask)
    (want,), wcount = ck.blockwise_compact_plain([T(col)], T(mask))
    assert count == int(wcount)
    np.testing.assert_array_equal(got, want.numpy())
