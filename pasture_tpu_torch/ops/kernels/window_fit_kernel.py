"""Morton-window plane-fit moments — the hot loop of the scalable normals.

For each query row ``i`` of ``sp`` (n, 3) and each shift ``s`` in
``-w..w``, the candidate is row ``i + w + s`` of ``pp`` (n + 2w, 3), ``inf``
where there is none.  Pass 1 keeps the k smallest squared distances in k
sorted registers; the threshold is the k-th times ``1 + 1e-6``.  Pass 2
selects the finite candidates within the threshold and sums, in the
query's own frame, their count, their squared distances, their offsets
(3) and the six second moments (xx, yy, zz, xy, xz, yz).

Replaces: pasture_tpu/ops/kernels/window_fit_kernel.py
window_fit_moments_pallas (``_make_kernel``).  Its (256, 128) lane blocks,
prev/cur/next views, row-rolled bases and ``w <= 64`` limit are TPU
artefacts and are not carried over.

Bound on the H100: instruction issue and its latency. The work the result
needs is, per query, ``(2w + 1) * 10`` operations (d2 once and one compare
in each pass), ``2k * k`` to fill k sorted registers and ~20 per selected
candidate, against 68 bytes moved. Design (``csrc/window_fit.cu``): 128
threads a block, each thread two neighbouring queries that share the three
shared-memory loads of every candidate row; the block's strip in shared
memory as two phases per coordinate (no bank conflicts); pass 1 keeps
exactly k sorted registers (one instance per k) and visits the rows
centre-out, inserting a candidate only where some lane of the warp has it
below its k-th register; pass 2 walks the shifts in the plain version's
ascending order, marks the selected rows in a bit mask and runs the 11
accumulators on those rows only. Both shortcuts are exact — the k smallest
of a multiset do not depend on the order of the visits, and an unselected
candidate's +0.0 term leaves an accumulator that is never -0.0 unchanged —
so the kernel still equals the plain version bit for bit
(``tests/test_torch_window_fit.py`` holds a model of the schedule to that).
``s`` and ``m6`` are written as (n, 3) and (n, 6) directly.
"""

from __future__ import annotations

from typing import Tuple

import torch

from . import _build

__all__ = ["window_fit_moments", "window_fit_moments_plain",
           "supports_window_fit", "LAUNCHES", "MAX_K", "MAX_W"]

#: launches of the kernel: one per call on CUDA tensors
LAUNCHES = {"window_fit_moments": 0}

MAX_K = 32                    # the largest register instance
MAX_W = 1920                  # a block's strip then fits 48 KB
_FIN = 3.0e38                 # finite-candidate guard (inf marks padding)
_MARGIN = 1.0 + 1e-6          # threshold margin of the TPU kernel


def supports_window_fit(n: int, k: int, w: int, dtype) -> bool:
    """What the kernel takes: f32, ``1 <= k <= 32``, ``1 <= w <= 1920`` (a
    block's strip of ``256 + 2w`` rows then fits 48 KB of shared memory),
    at least one query and fewer than 2**31 rows."""
    return (dtype == torch.float32 and 1 <= k <= MAX_K and 1 <= w <= MAX_W
            and 1 <= n and n + 2 * w < 1 << 31)


def _check_args(sp: torch.Tensor, pp: torch.Tensor, w: int) -> int:
    if sp.ndim != 2 or sp.shape[1] != 3:
        raise ValueError(f"sp must be (n, 3), got {tuple(sp.shape)}")
    n = sp.shape[0]
    if tuple(pp.shape) != (n + 2 * w, 3):
        raise ValueError(f"pp must be (n + 2w, 3) = ({n + 2 * w}, 3), got "
                         f"{tuple(pp.shape)}")
    if pp.dtype != sp.dtype or pp.device != sp.device:
        raise ValueError("sp and pp need one dtype and one device")
    return n


def window_fit_moments_plain(sp: torch.Tensor, pp: torch.Tensor, k: int,
                             w: int) -> Tuple[torch.Tensor, torch.Tensor,
                                              torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of :func:`window_fit_moments`: the 2w + 1
    shifts in the kernel's order, every operation rounded as the kernel
    rounds it, so it equals the kernel bit for bit in f32.  Follows the
    inputs' dtype (the CPU tests run it in f64 too)."""
    n = _check_args(sp, pp, w)
    if k < 1:
        raise ValueError(f"k must be >= 1, got {k}")
    qx, qy, qz = sp[:, 0], sp[:, 1], sp[:, 2]
    cand = [pp[:, a] for a in range(3)]

    def d_at(j):
        cx = cand[0][j:j + n]
        dx = cx - qx
        dy = cand[1][j:j + n] - qy
        dz = cand[2][j:j + n] - qz
        return cx, dx, dy, dz, dx * dx + dy * dy + dz * dz

    regs = [torch.full_like(qx, float("inf")) for _ in range(k)]
    for j in range(2 * w + 1):
        v = d_at(j)[4]
        for r in range(k):
            lo = torch.minimum(regs[r], v)
            v = torch.maximum(regs[r], v)
            regs[r] = lo
    thr = regs[k - 1] * torch.tensor(_MARGIN, dtype=sp.dtype,
                                     device=sp.device)
    zero = torch.zeros_like(qx)
    acc = [zero] * 11
    for j in range(2 * w + 1):
        cx, dx, dy, dz, d2 = d_at(j)
        sel = (d2 <= thr) & (cx <= _FIN)
        ex = torch.where(sel, dx, zero)
        ey = torch.where(sel, dy, zero)
        ez = torch.where(sel, dz, zero)
        terms = (sel.to(sp.dtype), torch.where(sel, d2, zero), ex, ey, ez,
                 ex * ex, ey * ey, ez * ez, ex * ey, ex * ez, ey * ez)
        acc = [a + t for a, t in zip(acc, terms)]
    return (acc[0], acc[1], torch.stack(acc[2:5], dim=1),
            torch.stack(acc[5:11], dim=1))


def window_fit_moments(sp: torch.Tensor, pp: torch.Tensor, k: int, w: int
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                  torch.Tensor]:
    """Selected-neighbourhood moments of the ±``w`` Morton window.

    ``sp``: (n, 3) finite query positions; ``pp``: (n + 2w, 3) candidates,
    ``inf`` where invalid, row ``i + w`` aligned with ``sp`` row ``i``.
    Returns ``(cnt (n,), tight_sum (n,), s (n, 3), m6 (n, 6))``: the count
    of selected candidates, the sum of their squared distances, and the
    query-frame first and second moment sums, ``m6`` ordered (xx, yy, zz,
    xy, xz, yz).

    On CUDA tensors the kernel runs (f32 within
    :func:`supports_window_fit`, else ``ValueError``); on CPU tensors the
    plain version."""
    if not sp.is_cuda:
        return window_fit_moments_plain(sp, pp, k, w)
    n = _check_args(sp, pp, w)
    if not supports_window_fit(n, k, w, sp.dtype):
        raise ValueError(f"window_fit_moments takes f32, 1 <= k <= {MAX_K} "
                         f"and 1 <= w <= {MAX_W}; got "
                         f"{sp.dtype}, n={n}, k={k}, w={w}")
    sp = sp.contiguous()
    pp = pp.contiguous()
    dev = sp.device
    cnt = torch.empty(n, dtype=torch.float32, device=dev)
    tight = torch.empty(n, dtype=torch.float32, device=dev)
    s = torch.empty((n, 3), dtype=torch.float32, device=dev)
    m6 = torch.empty((n, 6), dtype=torch.float32, device=dev)
    lib = _build.library("window_fit")
    with torch.cuda.device(dev):
        code = lib.window_fit_launch(sp.data_ptr(), pp.data_ptr(), n, k, w,
                                     cnt.data_ptr(), tight.data_ptr(),
                                     s.data_ptr(), m6.data_ptr(),
                                     _build.stream())
    _build.check(code, "window_fit_moments")
    LAUNCHES["window_fit_moments"] += 1
    return cnt, tight, s, m6
