"""Hugepage-backed allocation for the pipeline's large matrices.

First-touch page faults can dominate fresh multi-GB allocations (one
fault per 4 KiB page). With transparent hugepages in ``madvise`` mode, an
anonymous mmap + ``madvise(MADV_HUGEPAGE)`` faults in 2 MiB pages
instead, so the pileup/state matrices allocate through here.  Falls back to np.empty
anywhere the dance is unavailable.

A copy of the JAX package's ``phylonium_tpu/utils/bigalloc.py``: the port carries
its own host layer and imports nothing of that package.
"""

from __future__ import annotations

import ctypes
import mmap

import numpy as np

_MADV_HUGEPAGE = 14
_THRESHOLD = 64 << 20  # plain np.empty below this

try:
    _libc = ctypes.CDLL("libc.so.6", use_errno=True)
except OSError:  # pragma: no cover - non-glibc platform
    _libc = None


def empty(shape, dtype=np.uint8) -> np.ndarray:
    """np.empty equivalent; large buffers get MADV_HUGEPAGE."""
    dtype = np.dtype(dtype)
    nbytes = int(np.prod(shape)) * dtype.itemsize
    if _libc is None or nbytes < _THRESHOLD:
        return np.empty(shape, dtype)
    try:
        buf = mmap.mmap(-1, nbytes)
        addr = ctypes.addressof(ctypes.c_char.from_buffer(buf))
        _libc.madvise(
            ctypes.c_void_p(addr), ctypes.c_size_t(nbytes), _MADV_HUGEPAGE
        )
        arr = np.frombuffer(buf, dtype=dtype, count=nbytes // dtype.itemsize)
        return arr.reshape(shape)
    except (OSError, ValueError, BufferError):
        return np.empty(shape, dtype)
