"""Pipeline head: world bounds and the three voxel heads (exact-local,
quantized, decode + transform + key).

Four hand-written CUDA kernels (``csrc/world_bounds.cu`` and the three of
``csrc/voxel_head.cu``), each beside its plain PyTorch version.  Given a
CUDA tensor a wrapper launches its kernel or raises; given a CPU tensor it
runs the plain version.  The float arithmetic of both forms is the same
sequence of individually rounded f32 operations (the kernels are compiled
with ``-fmad=false``, and ``1/leaf`` and the residual scale are rounded to
f32 once on the host and handed to both), so kernel and plain version agree
bit for bit.

EXACT pipeline head — integer local-coordinate residuals.  The rigid
transform is affine, so the per-voxel centroid commutes with it:
mean(world) = affine(mean(local)).  Each point's i32 LAS local coordinate
is carried as an EXACT 10-bit integer residual relative to a per-cell
deterministic base — three residuals packed into ONE u32 word.  The base is
an INTEGER fixed-point function of the cell,

    base_a = ((M[a,0]*cx + M[a,1]*cy + M[a,2]*cz + C_lo[a]) >> 8)
             + C_hi[a] - 512,

with (M, C_hi, C_lo) computed ONCE (:func:`exact_local_base_coeffs`) and
passed to the head and to the reduce kernel — integer arithmetic is exact
everywhere, so encode and reconstruction can never disagree.  Contract: the
residual window must fit 10 bits, hence
``leaf_size <= exact_local_max_leaf(scale, semantics)``.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import numpy as np
import torch

from ..convert import u32_carrier
from . import _build

__all__ = ["fused_world_bounds", "fused_world_bounds_plain",
           "fused_voxel_head_exact_local",
           "fused_voxel_head_exact_local_plain", "fused_voxel_head",
           "fused_voxel_head_plain", "fused_decode_transform_key",
           "fused_decode_transform_key_plain", "exact_local_max_leaf",
           "exact_local_base_coeffs", "LAUNCHES"]

#: launches of each kernel of this module (a wrapper adds one where it
#: launches its kernel, and nowhere else)
LAUNCHES = {"fused_world_bounds": 0, "fused_voxel_head_exact_local": 0,
            "fused_voxel_head": 0, "fused_decode_transform_key": 0}

_BASE_SHIFT = 8  # fixed-point fractional bits of the base coefficients


def _f32(x, device) -> torch.Tensor:
    return torch.as_tensor(x, device=device).to(torch.float32)


def _check_local(local: torch.Tensor) -> None:
    if local.dtype != torch.int32 or local.ndim != 2 or local.shape[1] != 3:
        raise TypeError(f"local must be an (N, 3) int32 tensor, got "
                        f"{tuple(local.shape)} {local.dtype}")
    if local.shape[0] >= 1 << 31:
        raise ValueError("at most 2**31 - 1 points per call")


def _world(local, scale, rot, trans):
    """Decode + rotate + translate, one individually rounded f32 operation
    after another, in the order both kernels use."""
    wx = local[:, 0].to(torch.float32) * scale[0]
    wy = local[:, 1].to(torch.float32) * scale[1]
    wz = local[:, 2].to(torch.float32) * scale[2]
    return [rot[a, 0] * wx + rot[a, 1] * wy + rot[a, 2] * wz + trans[a]
            for a in range(3)]


# ---- K1: world bounds -----------------------------------------------------
# Replaces: pasture_tpu/ops/kernels/fused_transform.py fused_world_bounds
# (_bounds_kernel).  Bound on the H100: bytes — 12 B read per point, nothing
# written but 24 B; a handful of f32 operations per point.  Design
# (csrc/world_bounds.cu): one launch and no parameter vector — the kernel
# takes the three parameter tensors as pointers.  Each thread reads four
# points as three 16-byte loads, two such groups in flight, and keeps
# minima/maxima in registers; each block reduces them to one (6,) partial,
# and the block that draws the last ticket of a counter folds the
# partials.  World coordinates never reach device memory and no float
# atomics are needed.  The counter and the partials are a workspace kept
# per (device, stream) and zeroed once: the folding block sets the counter
# back to zero, so a call issues no memset, and calls on two streams never
# share a counter.

def _bounds_params(scale, rotation, translation, device
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(scale (3,), rotation (9,) row-major, translation (3,))`` as
    contiguous f32 tensors on ``device``: no copy for tensors that already
    are; host (numpy or CPU) values are copied to the device."""
    out = []
    for x, k, name in ((scale, 3, "scale"), (rotation, 9, "rotation"),
                       (translation, 3, "translation")):
        t = _f32(x, device)
        if t.numel() != k:
            raise ValueError(f"{name} needs {k} values, got shape "
                             f"{tuple(t.shape)}")
        out.append(t.reshape(k).contiguous())
    return out[0], out[1], out[2]


def fused_world_bounds_plain(local, scale, rotation, translation
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of :func:`fused_world_bounds`."""
    s, r, t = _bounds_params(scale, rotation, translation, local.device)
    w = _world(local, s, r.reshape(3, 3), t)
    return (torch.stack([c.min() for c in w]),
            torch.stack([c.max() for c in w]))


#: (device index, stream) -> (workspace: a zeroed ticket and room for the
#: partials, the most blocks a call launches on that device)
_BOUNDS_WORK = {}


def _bounds_workspace(device: torch.device, lib) -> Tuple[torch.Tensor, int]:
    key = (device.index, _build.stream())
    work = _BOUNDS_WORK.get(key)
    if work is None:
        blocks = ctypes.c_int(0)
        _build.check(lib.world_bounds_max_blocks(ctypes.byref(blocks)),
                     "fused_world_bounds")
        work = _BOUNDS_WORK.setdefault(key, (torch.zeros(
            4 + 6 * blocks.value, dtype=torch.float32, device=device),
            blocks.value))
    return work


def fused_world_bounds(local: torch.Tensor, scale, rotation, translation
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(min, max) world AABB of ``rot @ (local * scale) + trans`` over an
    (N, 3) int32 tensor in one pass (no world-position materialisation).
    Any N >= 1.  The parameters may be tensors on the device (no copy, no
    host read) or host values (copied to the device)."""
    _check_local(local)
    if local.shape[0] == 0:
        raise ValueError("fused_world_bounds needs at least one point")
    if not local.is_cuda:
        return fused_world_bounds_plain(local, scale, rotation, translation)
    dev = local.device
    local = local.contiguous()
    s, r, t = _bounds_params(scale, rotation, translation, dev)
    out = torch.empty(6, dtype=torch.float32, device=dev)
    lib = _build.library("world_bounds")
    with torch.cuda.device(dev):
        work, blocks = _bounds_workspace(dev, lib)
        code = lib.world_bounds_launch(
            local.data_ptr(), local.shape[0], s.data_ptr(), r.data_ptr(),
            t.data_ptr(), work.data_ptr(), blocks, out.data_ptr(),
            _build.stream())
    _build.check(code, "fused_world_bounds")
    LAUNCHES["fused_world_bounds"] += 1
    return out[0:3], out[3:6]


# ---- the shared integer cell base -----------------------------------------

def exact_local_max_leaf(scale, semantics: str = "floor") -> float:
    """Largest ``leaf_size`` the exact-local residual path supports
    (10-bit window; 12-unit guard for fixed-point base rounding)."""
    halfwidth_u = 0.75 if semantics == "nearest" else 0.5
    if isinstance(scale, torch.Tensor):
        scale = scale.detach().cpu().numpy()
    smin = float(np.min(np.asarray(scale)))
    return (499.0 / (3.0 ** 0.5 * halfwidth_u)) * smin


def exact_local_base_coeffs(scale, rotation, translation, bounds_min,
                            leaf_size: float, semantics: str = "floor"
                            ) -> torch.Tensor:
    """(15,) int32 fixed-point base coefficients (M row-major, C_hi, C_lo)
    shared by the exact-local head and reduce kernels.  Compute ONCE per
    pipeline and pass the same tensor to both (determinism contract).  The
    result lives on ``bounds_min``'s device.

    Raises ``ValueError`` when ``leaf_size`` exceeds
    :func:`exact_local_max_leaf`: residuals are clipped to [0, 1023] in the
    head, so a too-large leaf would yield wrong centroids with no error.
    (Reading ``scale`` for this check synchronises when it is a CUDA
    tensor; pass a numpy array or a CPU tensor to avoid that.)"""
    mid = 0.75 if semantics == "nearest" else 0.5
    max_leaf = exact_local_max_leaf(scale, semantics)
    if float(leaf_size) > max_leaf:
        raise ValueError(
            f"exact-local residual path: leaf_size {float(leaf_size)} "
            f"exceeds exact_local_max_leaf(scale, {semantics!r}) = "
            f"{max_leaf:.6g}; residuals would overflow the 10-bit "
            f"window and be silently clipped")
    dev = torch.as_tensor(bounds_min).device
    scale = _f32(scale, dev).reshape(3)
    rot_t = _f32(rotation, dev).reshape(3, 3).T
    trans = _f32(translation, dev).reshape(3)
    bmin = _f32(bounds_min, dev).reshape(3)
    # the leaf stays a host scalar, rounded to f32 as the tensor would be:
    # no host-to-device copy (which would wait for the stream)
    leaf = float(np.float32(leaf_size))
    mid_leaf = float(np.float32(mid) * np.float32(leaf_size))
    # l_ref_a(c) = sum_b Rinv[a,b]*((c_b+mid)*leaf + bmin_b - t_b)/scale_a
    # Rinv = rot^T; split into per-cell slope M and constant C = Chi+Clo.
    # Each line is one rounded f32 operation per element, in a fixed order
    # (the three-term sum is written out: no library reduction order).
    m9 = (rot_t * leaf / scale[:, None] * float(1 << _BASE_SHIFT)).reshape(9)
    prod = rot_t * (mid_leaf + bmin - trans)[None, :]
    const = (prod[:, 0] + prod[:, 1] + prod[:, 2]) / scale
    c_hi = torch.floor(const)
    c_lo = torch.round((const - c_hi) * float(1 << _BASE_SHIFT))
    return torch.cat([torch.round(m9).to(torch.int32),
                      c_hi.to(torch.int32), c_lo.to(torch.int32)])


def _int_cell_base(coef: torch.Tensor, cx, cy, cz, axis: int):
    """base_a from int32 cell coords — the identical integer expression in
    the head, the reduce kernel and both plain versions."""
    m = coef[3 * axis:3 * axis + 3]
    acc = m[0] * cx + m[1] * cy + m[2] * cz + coef[12 + axis]
    return (acc >> _BASE_SHIFT) + coef[9 + axis] - 512


# ---- K2: exact-local voxel head -------------------------------------------
# Replaces: pasture_tpu/ops/kernels/fused_transform.py
# fused_voxel_head_exact_local (_make_exact_local_head_kernel).  Bound on
# the H100: bytes — 12 B read + 8 B written per point against ~60 simple
# operations.  Design: one thread per point reading its (x, y, z) row of
# the (N, 3) tensor as it is (no SoA split pass), the 18 f32 parameters and
# 15 i32 coefficients staged once per block in shared memory, outputs
# written as two coalesced 4-byte streams.

def _head_params(scale, rotation, translation, bounds_min, dev):
    """scale(3) rot(9) trans(3) bmin(3) as one f32 tensor."""
    return torch.cat([
        _f32(scale, dev).reshape(3), _f32(rotation, dev).reshape(9),
        _f32(translation, dev).reshape(3), _f32(bounds_min, dev).reshape(3)])


def _inv_leaf(leaf_size: float) -> float:
    """1/leaf in f64, rounded to f32 once: a host scalar that the kernel
    takes as an argument and the plain version multiplies by."""
    return float(np.float32(1.0 / float(leaf_size)))


def _check_semantics(semantics: str) -> None:
    if semantics not in ("floor", "nearest"):
        raise ValueError(f"unknown voxel semantics {semantics!r}")


def _grid_coords(local, scale, rotation, translation, bounds_min,
                 leaf_size: float, semantics: str):
    """What every head starts with: world position ``t``, grid coordinate
    ``u = (t - bmin) * inv_leaf`` and int32 cell per axis (three lists),
    and the 30-bit Morton key (carrier form)."""
    from ...math.morton import _expand10_u32
    p = _head_params(scale, rotation, translation, bounds_min, local.device)
    inv_leaf = _inv_leaf(leaf_size)
    t = _world(local, p[0:3], p[3:12].reshape(3, 3), p[12:15])
    us, cells = [], []
    for a in range(3):
        u = (t[a] - p[15 + a]) * inv_leaf
        us.append(u)
        if semantics == "nearest":
            u = u - 0.5
        cells.append(torch.clamp(torch.floor(u), 0, 1023).to(torch.int32))
    key = (_expand10_u32(cells[0]) | (_expand10_u32(cells[1]) << 1)
           | (_expand10_u32(cells[2]) << 2))
    return t, us, cells, key


def _launch_head(name: str, entry: str, local, scale, rotation, translation,
                 bounds_min, leaf_size: float, *rest) -> None:
    """Launch the head kernel of wrapper ``name``: every C entry point of
    ``csrc/voxel_head.cu`` takes ``(local, n, params, inv_leaf, *rest,
    stream)``."""
    dev = local.device
    params = _head_params(scale, rotation, translation, bounds_min,
                          dev).contiguous()
    lib = _build.library("voxel_head")
    with torch.cuda.device(dev):
        code = getattr(lib, entry)(
            local.data_ptr(), local.shape[0], params.data_ptr(),
            _inv_leaf(leaf_size), *rest, _build.stream())
    _build.check(code, name)
    LAUNCHES[name] += 1


def fused_voxel_head_exact_local_plain(local, scale, rotation, translation,
                                       bounds_min, leaf_size: float, coeffs,
                                       semantics: str = "floor"):
    """Plain PyTorch version of :func:`fused_voxel_head_exact_local`;
    returns the two u32 words in carrier form (int64)."""
    _, _, cells, key = _grid_coords(local, scale, rotation, translation,
                                    bounds_min, leaf_size, semantics)
    coef = torch.as_tensor(coeffs, device=local.device).to(torch.int32)
    r = [torch.clamp(local[:, a] - _int_cell_base(coef, *cells, a), 0, 1023)
         .to(torch.int64) for a in range(3)]
    return key, (r[0] << 20) | (r[1] << 10) | r[2]


def fused_voxel_head_exact_local(local: torch.Tensor, scale, rotation,
                                 translation, bounds_min, leaf_size: float,
                                 coeffs, semantics: str = "floor"):
    """(N,) Morton keys + (N,) packed EXACT 10-bit local residual words
    for the exact voxel pipeline (``voxel_downsample``
    ``precomputed=(keys, resword)`` + ``local_affine=``), one pass over the
    i32 locals.  ``coeffs`` is the shared :func:`exact_local_base_coeffs`
    tensor (pass the SAME tensor to ``voxel_downsample``).  Requires
    ``leaf_size <= exact_local_max_leaf(scale, semantics)``.

    On a CUDA tensor the kernel runs and the two words come back in bits
    form (int32); on a CPU tensor the plain version returns carrier form
    (int64).  Every consumer in this package takes either."""
    _check_local(local)
    _check_semantics(semantics)
    if not local.is_cuda:
        return fused_voxel_head_exact_local_plain(
            local, scale, rotation, translation, bounds_min, leaf_size,
            coeffs, semantics)
    dev = local.device
    local = local.contiguous()
    n = local.shape[0]
    coef = torch.as_tensor(coeffs, device=dev).to(torch.int32).contiguous()
    if coef.numel() != 15:
        raise ValueError("coeffs must hold 15 int32 values")
    key = torch.empty(n, dtype=torch.int32, device=dev)
    rword = torch.empty(n, dtype=torch.int32, device=dev)
    if n:
        _launch_head(
            "fused_voxel_head_exact_local", "voxel_head_exact_local_launch",
            local, scale, rotation, translation, bounds_min, leaf_size,
            coef.data_ptr(), int(semantics == "nearest"), key.data_ptr(),
            rword.data_ptr())
    return key, rword


# ---- K7a: quantized voxel head --------------------------------------------
# Replaces: pasture_tpu/ops/kernels/fused_transform.py fused_voxel_head
# (_make_head_kernel).  Bound on the H100: bytes — 12 B read + 8 B written
# per point.  Design: K2's kernel with another second word — the same
# thread-per-point pass over the (N, 3) tensor, the residual of the grid
# coordinate against the CLIPPED cell scaled by 2^q / window, floored and
# clipped to q bits (a point beyond the grid saturates, it does not wrap).

def _qscale(qbits: int, semantics: str) -> float:
    """2^q / window (1.0 leaves for floor, 1.5 for nearest), rounded to f32
    once: a host scalar for kernel and plain version alike."""
    window = 1.5 if semantics == "nearest" else 1.0
    return float(np.float32(float(1 << qbits) / window))


def _check_qbits(qbits: int) -> None:
    if not (1 <= qbits and 3 * qbits <= 32):
        raise ValueError(f"qbits must satisfy 1 <= qbits and 3 * qbits <= "
                         f"32, got {qbits}")


def fused_voxel_head_plain(local, scale, rotation, translation, bounds_min,
                           leaf_size: float, qbits: int = 10,
                           semantics: str = "floor"):
    """Plain PyTorch version of :func:`fused_voxel_head`; returns the two
    u32 words in carrier form (int64)."""
    _check_qbits(qbits)
    _, us, cells, key = _grid_coords(local, scale, rotation, translation,
                                     bounds_min, leaf_size, semantics)
    qscale = _qscale(qbits, semantics)
    q = [torch.clamp(torch.floor((us[a] - cells[a].to(torch.float32))
                                 * qscale), 0, (1 << qbits) - 1)
         .to(torch.int64) for a in range(3)]
    return key, (q[0] << (2 * qbits)) | (q[1] << qbits) | q[2]


def fused_voxel_head(local: torch.Tensor, scale, rotation, translation,
                     bounds_min, leaf_size: float, qbits: int = 10,
                     semantics: str = "floor"):
    """(N,) Morton keys + (N,) packed ``qbits``-bit residual words for the
    quantized voxel pipeline (``voxel_downsample`` ``precomputed=(keys,
    qword)`` + ``position_quantization_bits=qbits``), one pass over the i32
    locals.  Residual windows match ops/voxel.py: [0, 1) leaves for
    ``floor``, [0, 1.5) for ``nearest`` (low-edge clamp).  Any N.

    On a CUDA tensor the kernel runs and the two words come back in bits
    form (int32); on a CPU tensor the plain version returns carrier form
    (int64)."""
    _check_local(local)
    _check_semantics(semantics)
    _check_qbits(qbits)
    if not local.is_cuda:
        return fused_voxel_head_plain(local, scale, rotation, translation,
                                      bounds_min, leaf_size, qbits, semantics)
    local = local.contiguous()
    n = local.shape[0]
    key = torch.empty(n, dtype=torch.int32, device=local.device)
    qword = torch.empty(n, dtype=torch.int32, device=local.device)
    if n:
        _launch_head(
            "fused_voxel_head", "voxel_head_quantized_launch", local, scale,
            rotation, translation, bounds_min, leaf_size,
            _qscale(qbits, semantics), int(qbits),
            int(semantics == "nearest"), key.data_ptr(), qword.data_ptr())
    return key, qword


# ---- K7b: decode + transform + key ----------------------------------------
# Replaces: pasture_tpu/ops/kernels/fused_transform.py
# fused_decode_transform_key (_kernel).  Bound on the H100: bytes — 12 B
# read + 16 B written per point.  Design: the same pass again, writing the
# world position as one row of an (N, 3) tensor (no three streams and a
# stack afterwards) beside the key; floor semantics only, as there.

def fused_decode_transform_key_plain(local, scale, rotation, translation,
                                     bounds_min, leaf_size: float):
    """Plain PyTorch version of :func:`fused_decode_transform_key`; the key
    in carrier form (int64)."""
    t, _, _, key = _grid_coords(local, scale, rotation, translation,
                                bounds_min, leaf_size, "floor")
    return torch.stack(t, dim=1), key


def fused_decode_transform_key(local: torch.Tensor, scale, rotation,
                               translation, bounds_min, leaf_size: float):
    """(N, 3) i32 local coords -> (world (N, 3) f32, Morton key (N,)) over
    the 1024^3 grid of ``bounds_min`` + ``leaf_size`` (floor semantics) —
    the head of the exact-f32 voxel path (``voxel_downsample``
    ``precomputed=(keys, None)`` on a batch carrying the world column).
    Any N.

    On a CUDA tensor the kernel runs and the key comes back in bits form
    (int32); on a CPU tensor the plain version returns carrier form."""
    _check_local(local)
    if not local.is_cuda:
        return fused_decode_transform_key_plain(
            local, scale, rotation, translation, bounds_min, leaf_size)
    local = local.contiguous()
    n = local.shape[0]
    world = torch.empty((n, 3), dtype=torch.float32, device=local.device)
    key = torch.empty(n, dtype=torch.int32, device=local.device)
    if n:
        _launch_head(
            "fused_decode_transform_key", "decode_transform_key_launch",
            local, scale, rotation, translation, bounds_min, leaf_size,
            world.data_ptr(), key.data_ptr())
    return world, key
