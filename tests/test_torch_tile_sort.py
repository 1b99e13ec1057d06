"""The tile sort of pasture_tpu_torch (plain version, CPU) against the JAX
package's ``tile_sort_pallas`` in interpret mode, on the same numpy
streams.  Both sorts are unstable, so key streams are compared bit for bit
and the rows of each tile as multisets."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pasture_tpu.ops.kernels.tile_sort_kernel import tile_sort_pallas

from pasture_tpu_torch.ops.kernels import tile_sort_kernel as ts

N, TILE = 65536, 512


def _streams(rng, n):
    """Morton-like keys with many repeats, a word with its top bit set on
    half the rows (negative as int32), a payload; some invalid keys."""
    key = rng.integers(0, 200, n).astype(np.uint32) << np.uint32(7)
    key[rng.random(n) < 0.02] = 0xFFFFFFFF
    word = rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)
    word &= np.uint32(0xFF0000FF)          # repeats in the second key too
    payload = rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)
    return [key, word, payload]


def _canonical(streams, tile_len):
    """Rows of every tile in full lexicographic order: equal as arrays iff
    the tiles hold the same multisets of rows."""
    rows = np.stack([np.asarray(s, dtype=np.uint64) for s in streams], axis=1)
    rows = rows.reshape(-1, tile_len, len(streams))
    out = np.empty_like(rows)
    for i, t in enumerate(rows):
        out[i] = t[np.lexsort(t.T[::-1])]
    return out


@pytest.mark.parametrize("num_keys", [1, 2])
@pytest.mark.parametrize("form", ["carrier", "bits"])
def test_tile_sort_plain_matches_pallas_interpret(rng, num_keys, form):
    streams = _streams(rng, N)
    want = tile_sort_pallas([jnp.asarray(s) for s in streams], TILE,
                            num_keys=num_keys, interpret=True)
    want = [np.asarray(w) for w in want]
    if form == "carrier":
        ins = [torch.from_numpy(s.astype(np.int64)) for s in streams]
    else:
        ins = [torch.from_numpy(s.view(np.int32).copy()) for s in streams]
    before = dict(ts.LAUNCHES)
    got = ts.tile_sort(ins, TILE, num_keys=num_keys)
    assert ts.LAUNCHES == before          # CPU tensors launch nothing
    assert all(g.dtype == torch.int64 for g in got)
    got = [g.numpy().astype(np.uint32) for g in got]
    for k in range(num_keys):
        np.testing.assert_array_equal(got[k], want[k])
    np.testing.assert_array_equal(_canonical(got, TILE),
                                  _canonical(want, TILE))
    np.testing.assert_array_equal(_canonical(got, TILE),
                                  _canonical(streams, TILE))
    # unsigned order: invalid keys close every tile that has them
    k2 = got[0].reshape(-1, TILE)
    assert (np.diff(k2.astype(np.int64), axis=1) >= 0).all()


def test_supports_and_argument_checks():
    assert ts.supports_tile_sort(N, TILE, 3)
    assert ts.supports_tile_sort(4096, 2, 1)           # no lane lower limit
    assert not ts.supports_tile_sort(N, 500, 3)        # not a power of two
    assert not ts.supports_tile_sort(N + 1, TILE, 3)   # ragged
    assert not ts.supports_tile_sort(N, 2 * ts.MAX_TILE_LEN, 3)
    assert not ts.supports_tile_sort(N, TILE, ts.MAX_STREAMS + 1)
    s = torch.zeros(1024, dtype=torch.int64)
    with pytest.raises(ValueError, match="num_keys"):
        ts.tile_sort([s, s], 512, num_keys=3)
    with pytest.raises(ValueError, match="unsupported"):
        ts.tile_sort([s], 300)
    with pytest.raises(ValueError, match="one length"):
        ts.tile_sort([s, s[:512]], 512)
    with pytest.raises(TypeError):
        ts.tile_sort([s.to(torch.float32)], 512)
