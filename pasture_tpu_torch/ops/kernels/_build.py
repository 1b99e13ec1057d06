"""Builds and loads the package's CUDA kernels.

The sources under ``csrc/`` have a plain C interface (no PyTorch headers,
so ``nvcc`` takes seconds).  At the first CUDA launch each source is
compiled with ``nvcc`` for ``sm_90a`` into ``_build/`` beside this file —
one ``nvcc`` process per source, all started together — and loaded with
``ctypes``.  A library is rebuilt when the content hash of its source (or
of a header beside it) changes.  A failed build raises with ``nvcc``'s
output; nothing falls back.

Every C entry point launches on the stream it is given, does not
synchronise, allocates nothing, and returns ``cudaGetLastError()``;
:func:`check` raises on a non-zero code.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Sequence

__all__ = ["library", "build_all", "check", "stream", "SOURCES", "P", "I", "F",
           "D", "L"]

_HERE = Path(__file__).resolve().parent
CSRC = _HERE / "csrc"
BUILD_DIR = _HERE / "_build"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC")

P = ctypes.c_void_p   # every pointer and the stream
I = ctypes.c_int
F = ctypes.c_float
D = ctypes.c_double
L = ctypes.c_longlong

#: source stem -> {C function: argtypes}
SOURCES: Dict[str, Dict[str, Sequence]] = {
    "world_bounds": {
        # &blocks
        "world_bounds_max_blocks": (ctypes.POINTER(I),),
        # local, n, scale, rot, trans, work, max_blocks, out, stream
        "world_bounds_launch": (P, I, P, P, P, P, I, P, P),
    },
    "voxel_head": {
        # local, n, params, inv_leaf, coeffs, nearest, key, rword, stream
        "voxel_head_exact_local_launch": (P, I, P, F, P, I, P, P, P),
        # local, n, params, inv_leaf, qscale, qbits, nearest, key, qword,
        # stream
        "voxel_head_quantized_launch": (P, I, P, F, F, I, I, P, P, P),
        # local, n, params, inv_leaf, world, key, stream
        "decode_transform_key_launch": (P, I, P, F, P, P, P),
    },
    "tile_sort": {
        # in[5], out[5], n_streams, num_keys, tiles, tile_len, stream
        "tile_sort_launch": (P, P, P, P, P, P, P, P, P, P, I, I, I, I, P),
    },
    "compact": {
        # keep, n, blocks, status, count, ranked, n_cols, src[], dst[],
        # row_bytes[], src_pitch[], dst_pitch[], unit[], stream
        "compact_launch": (P, I, I, P, P, I, I, P, P, P, P, P, P, P),
    },
    "voxel_reduce": {
        # form, wide, key, word, s3, s4, s5 (residual word | px, py, pz),
        # tiles, tile_len, chunks, status, count, params, coeffs, qbits,
        # mode_bits, n_fields, field_ints, field_floats, pos, out_word,
        # stream
        "voxel_reduce_launch": (I, I, P, P, P, P, P, I, I, I, P, P, P, P, I,
                                I, I, P, P, P, P, P),
    },
    "window_fit": {
        # sp, pp, n, k, w, cnt, tight, s, m6, stream
        "window_fit_launch": (P, P, I, I, I, P, P, P, P, P),
    },
    "icp_step": {
        # src, src_valid, n, tgt, tgt_valid, nrm, m, pose, max_d2,
        # point_to_plane, partial, parts, qpw, stream
        "icp_correspond_launch": (P, P, I, P, P, P, I, P, F, I, P, I, I, P),
        # partial, parts, pose, damping, rmse, nin, stream
        "icp_solve_launch": (P, I, P, D, P, P, P),
        # src, src_valid, n, tgt, tgt_valid, nrm, m, pose, max_d2,
        # point_to_plane, damping, partial, parts, qpw, iterations, rmse,
        # nin, stream
        "icp_iterate_launch": (P, P, I, P, P, P, I, P, F, I, D, P, I, I, I,
                               P, P, P),
    },
    "las_decode": {
        # rec, n, record_size, row0, sx, sy, sz, ox, oy, oz, pos_offset,
        # pos_kind, pos, n_fields, f_out[], f_meta[], stream
        "las_decode_launch": (P, L, I, L, D, D, D, D, D, D, I, I, P, I, P, P,
                              P),
    },
}

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def _nvcc() -> str:
    exe = shutil.which("nvcc")
    if exe is None:
        cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
        if cand.exists():
            exe = str(cand)
    if exe is None:
        raise RuntimeError("nvcc not found: the CUDA kernels of "
                           "pasture_tpu_torch are built at first use and "
                           "need the CUDA toolkit")
    return exe


def _digest(stem: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    h.update((CSRC / f"{stem}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    return h.hexdigest()[:16]


def _target(stem: str) -> Path:
    return BUILD_DIR / f"{stem}-{_digest(stem)}.so"


def _start(stem: str, out: Path) -> subprocess.Popen:
    tmp = out.with_suffix(f".{os.getpid()}.so.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{stem}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    proc._tmp, proc._out, proc._cmd = tmp, out, cmd
    return proc


def _finish(proc: subprocess.Popen) -> None:
    output, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}): "
                           f"{' '.join(proc._cmd)}\n{output}")
    os.replace(proc._tmp, proc._out)


def _load(stem: str, path: Path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    for fn, argtypes in SOURCES[stem].items():
        f = getattr(lib, fn)
        f.argtypes = list(argtypes)
        f.restype = ctypes.c_int
    _libs[stem] = lib
    return lib


def build_all() -> None:
    """Build (where stale) and load every kernel library, the compilers
    running side by side."""
    with _lock:
        BUILD_DIR.mkdir(exist_ok=True)
        targets = {s: _target(s) for s in SOURCES if s not in _libs}
        procs = [_start(s, t) for s, t in targets.items() if not t.exists()]
        for p in procs:
            _finish(p)
        for s, t in targets.items():
            _load(s, t)


def library(stem: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<stem>.cu``, built on first use."""
    lib = _libs.get(stem)
    if lib is None:
        build_all()
        lib = _libs[stem]
    return lib


def check(code: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error code."""
    if code != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {code}")


def stream() -> int:
    """The current PyTorch CUDA stream as the integer the C side takes."""
    import torch

    return torch.cuda.current_stream().cuda_stream
