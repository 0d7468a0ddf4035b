"""Build and bind the host reverse-rANS runtime (port of
imgcomp_cvpr_tpu/coding/native/build.py).

``rans.cpp`` is compiled with ``g++ -O3`` on first use into
``build/native/librans-<hash>.so`` at the repository root (the hash of the
source keys the file, so an edited source is rebuilt) and bound with ctypes.
There is no fallback: when g++ is missing or the build fails, ``load``
raises, and a caller that wants the numpy version asks for it
(``rans.encode_reverse(..., native=False)``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import Optional

_DIR = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(_DIR, 'rans.cpp')
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(_DIR))),
                         'build', 'native')
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def lib_path() -> str:
    with open(SRC, 'rb') as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:12]
    return os.path.join(BUILD_DIR, f'librans-{digest}.so')


def load() -> ctypes.CDLL:
    """The bound library, compiled first if this source has no build yet."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        path = lib_path()
        if not os.path.exists(path):
            os.makedirs(BUILD_DIR, exist_ok=True)
            tmp = f'{path}.{os.getpid()}.tmp'
            try:
                out = subprocess.run(
                    ['g++', '-O3', '-shared', '-fPIC', '-std=c++17', SRC, '-o', tmp],
                    capture_output=True, text=True)
            except OSError as e:
                raise RuntimeError(f'g++ not found: the native rANS runtime cannot '
                                   f'be built ({e})') from e
            if out.returncode != 0:
                raise RuntimeError(f'g++ failed on {SRC}:\n{out.stderr}')
            os.replace(tmp, path)
        lib = ctypes.CDLL(path)
        u32p = ctypes.POINTER(ctypes.c_uint32)
        lib.rans_encode_reverse.argtypes = [
            ctypes.c_int64, ctypes.c_int64, u32p, u32p, ctypes.POINTER(ctypes.c_uint8),
            ctypes.c_uint32, ctypes.POINTER(ctypes.c_uint16), u32p, u32p,
            ctypes.POINTER(ctypes.c_int32)]
        lib.rans_encode_reverse.restype = None
        _lib = lib
        return lib
