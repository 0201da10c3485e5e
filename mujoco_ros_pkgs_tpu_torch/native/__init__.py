"""The native state codec (statecodec.cpp), built with g++ at first use and
bound over ctypes.

Counterpart of mujoco_ros_pkgs_tpu/native/__init__.py, with its own copy of
the source: the same CRC32-guarded `MTPU` blob, byte for byte. The library
is built into the port's build directory (mujoco_ros_pkgs_tpu_torch/_build/,
beside the CUDA kernels', keyed by a hash of the source and flags), not
next to the source. A codec that fails to build or load raises: nothing
falls back to another format.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import List, Sequence

import numpy as np

SOURCE = Path(__file__).resolve().parent / "statecodec.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-pthread")
MAGIC = b"UPTM"     # kMagic 0x4D545055 ('MTPU') as its little-endian bytes

_lock = threading.Lock()
_lib = None


def library_path() -> Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode() + SOURCE.read_bytes())
    return BUILD_DIR / f"libmrp_statecodec_{h.hexdigest()[:16]}.so"


def _build(out: Path) -> None:
    """g++ into a temporary file beside `out`, renamed into place (two
    processes building at once each rename a whole library)."""
    out.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
    os.close(fd)
    try:
        proc = subprocess.run(["g++", *CXX_FLAGS, str(SOURCE), "-o", tmp],
                              capture_output=True, text=True, timeout=300)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed to build the state codec:\n{proc.stderr}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def statecodec():
    """The codec's ctypes library, built if needed (RuntimeError or OSError
    when it cannot be built or loaded)."""
    global _lib
    with _lock:
        if _lib is None:
            path = library_path()
            if not path.exists():
                _build(path)
            lib = ctypes.CDLL(str(path))
            u64, u32, p = ctypes.c_uint64, ctypes.c_uint32, ctypes.c_void_p
            lib.codec_blob_size.restype = u64
            lib.codec_blob_size.argtypes = [ctypes.POINTER(u64), u32]
            lib.codec_pack.restype = u64
            lib.codec_pack.argtypes = [ctypes.POINTER(p), ctypes.POINTER(u64), u32,
                                       ctypes.c_char_p, u64]
            lib.codec_unpack.restype = u32
            lib.codec_unpack.argtypes = [ctypes.c_char_p, u64, ctypes.POINTER(p),
                                         ctypes.POINTER(u64), u32]
            _lib = lib
        return _lib


def _table(arrays: Sequence[np.ndarray]):
    n = len(arrays)
    sizes = (ctypes.c_uint64 * n)(*[a.nbytes for a in arrays])
    bufs = (ctypes.c_void_p * n)(*[a.ctypes.data for a in arrays])
    return n, sizes, bufs


def pack(arrays: Sequence[np.ndarray]) -> bytes:
    """One MTPU blob of the arrays' bytes (each C-contiguous)."""
    for a in arrays:
        if not a.flags.c_contiguous:
            raise ValueError("the codec packs C-contiguous arrays")
    lib = statecodec()
    n, sizes, bufs = _table(arrays)
    cap = lib.codec_blob_size(sizes, n)
    out = ctypes.create_string_buffer(cap)
    written = lib.codec_pack(bufs, sizes, n, out, cap)
    if written != cap:
        raise RuntimeError("statecodec pack failed")
    return out.raw[:written]


def unpack(blob: bytes, specs: Sequence[dict]) -> List[np.ndarray]:
    """The arrays of a blob, shaped and typed by specs ({dtype, shape} each);
    ValueError for a blob whose magic, count, sizes or CRC32 do not check."""
    arrays = [np.empty(s["shape"], dtype=np.dtype(s["dtype"])) for s in specs]
    lib = statecodec()
    n, sizes, bufs = _table(arrays)
    if lib.codec_unpack(blob, len(blob), bufs, sizes, n) != n:
        raise ValueError("statecodec unpack failed: the blob's magic, array count, "
                         "sizes or CRC32 do not check (a corrupt checkpoint?)")
    return arrays
