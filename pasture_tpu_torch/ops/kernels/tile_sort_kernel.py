"""Tile sort — the sort of the voxel pipeline's hot path.

The headline pipeline sorts 8192 independent 512-row tiles of 3 u32 streams
(Morton key, packed word, residual word) by (key, word); the exact-f32 voxel
path sorts 5 (key, word and the three f32 position streams as their bits).

Replaces: pasture_tpu/ops/kernels/tile_sort_kernel.py tile_sort_pallas
(_make_kernel).  Bound on the H100: bytes at the headline shape — 12 B read
+ 12 B written per row — while the bitonic network costs
log2(L)*(log2(L)+1)/2 compare-exchange substages per row pair (45 for
L = 512).  Design (``csrc/tile_sort.cu``, one kernel family for the whole
contract): the rows live in registers, sixteen consecutive rows a thread
(L rows where L < 16), loaded and stored with 16-byte vector accesses, and
as many tiles a block as give it at least 128 threads.  A substage whose
partner is in the same thread runs on registers (30 of 45 at L = 512); one
in another lane of the warp exchanges rows with ``__shfl_xor_sync`` (15);
only partners 512 rows apart or more (tiles of 1024 rows and up) go
through shared memory.
The key is compared as one UNSIGNED integer, ``key << 32 | word`` for two
key streams (the invalid key 0xFFFFFFFF and a packed word whose top bits
hold the mode value are negative as int32 and must still sort last);
payload words follow their key through selects.  One device-memory read
and one write per stream.

Output equals a stable sort on the same operands up to the order WITHIN
equal-key runs (the sort is unstable; the voxel pipeline's reductions are
invariant to that order).
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

from ..convert import u32_bits, u32_carrier
from . import _build

__all__ = ["tile_sort", "tile_sort_plain", "supports_tile_sort", "LAUNCHES",
           "MAX_TILE_LEN", "MAX_STREAMS"]

#: launches of the kernel (the wrapper adds one where it launches it)
LAUNCHES = {"tile_sort": 0}

# 4096 rows are 256 threads of sixteen rows; their cross-warp exchange takes
# 5 streams x 4096 rows x 4 B = 80 KiB of shared memory (the launch opts in
# to the large dynamic carve-out above 48 KiB)
MAX_TILE_LEN = 4096
MAX_STREAMS = 5   # key, word and the three f32 position streams


def supports_tile_sort(n: int, tile_len: int, n_streams: int) -> bool:
    """Static feasibility of the kernel for ``n`` flat rows in ``tile_len``
    tiles of ``n_streams`` 32-bit streams."""
    if tile_len < 2 or tile_len > MAX_TILE_LEN or tile_len & (tile_len - 1):
        return False
    return n > 0 and n % tile_len == 0 and 1 <= n_streams <= MAX_STREAMS


def lex_order(keys: Sequence[torch.Tensor], tile_len: int) -> torch.Tensor:
    """Flat gather indices that sort every ``tile_len`` tile of the rows by
    the lexicographic key ``keys`` (stable): one stable sort per key, the
    least significant first."""
    n = keys[0].shape[0]
    tiles = n // tile_len
    order = None
    for k in reversed(list(keys)):
        k2 = k.reshape(tiles, tile_len)
        if order is not None:
            k2 = k2.gather(1, order)
        idx = torch.sort(k2, dim=1, stable=True).indices
        order = idx if order is None else order.gather(1, idx)
    start = torch.arange(tiles, device=order.device)[:, None] * tile_len
    return (order + start).reshape(-1)


def tile_sort_plain(streams: Sequence[torch.Tensor], tile_len: int,
                    num_keys: int = 1) -> Tuple[torch.Tensor, ...]:
    """Plain PyTorch version of :func:`tile_sort`: u32 streams in either
    form in, carrier form (int64) out."""
    cols = [u32_carrier(s) for s in streams]
    order = lex_order(cols[:num_keys], tile_len)
    return tuple(c.index_select(0, order) for c in cols)


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous and 16-byte aligned (a copy where a view is not)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def tile_sort(streams: Sequence[torch.Tensor], tile_len: int,
              num_keys: int = 1) -> Tuple[torch.Tensor, ...]:
    """Sort each contiguous ``tile_len``-row tile of the flat u32
    ``streams`` by the first ``num_keys`` streams (lexicographic, unsigned,
    ascending), permuting all streams together.  Unstable: rows with equal
    keys may come out in any order.

    On CUDA tensors the kernel runs and the streams come back in bits form
    (int32); on CPU tensors the plain version returns carrier form."""
    streams = list(streams)
    n = streams[0].shape[0]
    if any(s.ndim != 1 or s.shape[0] != n for s in streams):
        raise ValueError("streams must be 1-D and of one length")
    if num_keys not in (1, 2) or num_keys > len(streams):
        raise ValueError(f"num_keys must be 1 or 2 and at most the number "
                         f"of streams, got {num_keys}")
    if not supports_tile_sort(n, tile_len, len(streams)):
        raise ValueError(f"unsupported tile sort: n={n}, tile_len="
                         f"{tile_len}, streams={len(streams)}")
    if not streams[0].is_cuda:
        return tile_sort_plain(streams, tile_len, num_keys)
    dev = streams[0].device
    # the kernel loads and stores 16-byte vectors
    ins: List[torch.Tensor] = [_aligned(u32_bits(s)) for s in streams]
    if any(s.device != dev for s in ins):
        raise ValueError("streams must share one device")
    outs = [torch.empty_like(s) for s in ins]
    pad = [0] * (MAX_STREAMS - len(ins))
    lib = _build.library("tile_sort")
    with torch.cuda.device(dev):
        code = lib.tile_sort_launch(
            *[s.data_ptr() for s in ins], *pad,
            *[o.data_ptr() for o in outs], *pad,
            len(ins), num_keys, n // tile_len, tile_len, _build.stream())
    _build.check(code, "tile_sort")
    LAUNCHES["tile_sort"] += 1
    return tuple(outs)
