"""Build helper for the native LASzip codec.

Compiles ``src/laszip.cpp`` (one translation unit) with ``g++`` into
``_build/`` beside this module on first use; the shared object is loaded
via ctypes — no pybind11 required.  The library's name carries a content
hash of the source and the flags, so an edited source builds anew.  Each
process compiles to a name of its own and moves the result into place with
``os.replace``, so processes that build at once never see a partial file.
"""

from __future__ import annotations

import hashlib
import os
import subprocess
import threading
from pathlib import Path

_HERE = Path(__file__).resolve().parent
SOURCE = _HERE / "src" / "laszip.cpp"
BUILD_DIR = _HERE / "_build"
GXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-pthread")
_LOCK = threading.Lock()


def laszip_target() -> Path:
    """Path of the shared object for the current source and flags."""
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"_laszip-{h.hexdigest()[:16]}.so"


def ensure_laszip() -> Path:
    """Compile (if not built yet) and return the path of the laszip
    shared object."""
    so = laszip_target()
    with _LOCK:
        if so.exists():
            return so
        BUILD_DIR.mkdir(exist_ok=True)
        tmp = so.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
        cmd = ["g++", *GXX_FLAGS, str(SOURCE), "-o", str(tmp)]
        try:
            subprocess.run(cmd, check=True, capture_output=True, text=True)
        except FileNotFoundError:
            raise RuntimeError("g++ not available; cannot build the native "
                               "laszip codec") from None
        except subprocess.CalledProcessError as e:
            raise RuntimeError(f"laszip build failed:\n{e.stderr}") from None
        os.replace(tmp, so)
        return so
