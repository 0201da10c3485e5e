"""Build and bind the port's hand-written CUDA kernels.

The sources in csrc/ are compiled at first use with nvcc for sm_90a into a
shared library with a plain C interface, cached under _build/ by a hash of
the sources and flags, and loaded with ctypes. Nothing is built or imported
from CUDA when this module is imported, so the CPU tests can import it.

Each wrapper checks device, dtype, shape and contiguity, allocates its
outputs with torch.empty, launches on the current CUDA stream, raises if the
launch failed, and counts its launches in a plain integer attribute
(`step_fused.launches`).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
_SOURCES = ("step_fused.cu",)

_lock = threading.Lock()
_lib = None
build_log = ""          # nvcc's output of the build this process ran (ptxas -v)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build "
                       "the port's kernels")


def _source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def library_path() -> Path:
    return BUILD_DIR / f"libmrp_kernels_{_source_hash()}.so"


def build() -> Path:
    """Compile csrc/ into the cached shared library unless it exists."""
    global build_log
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *(str(CSRC / s) for s in _SOURCES)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    build_log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{build_log}")
    os.replace(tmp, out)
    return out


def load():
    """The ctypes handle of the kernel library, building it if needed."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            fn = lib.step_fused_launch
            fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int, ctypes.c_void_p]
            fn.restype = ctypes.c_int
            _lib = lib
        return _lib


def _check(name, t, dtype, shape, device):
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a tensor, got {type(t).__name__}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if shape is not None and tuple(t.shape) != shape:
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def step_fused(meta, params, qpos, qvel, ws):
    """Fused whole step (csrc/step_fused.cu) of a (B,) env batch on the card.

    meta: int32 (nmeta,) from ops/step_tpu.kernel_meta; params: float32
    (NP,) from ops/step_tpu._pack_params; qpos (B, 7), qvel (B, 6), ws
    (B, 6) float32. Returns (qpos', qvel', x_solver)."""
    if qpos.device.type != "cuda":
        raise ValueError(f"step_fused: qpos is on {qpos.device}, not a CUDA device")
    dev = qpos.device
    B = qpos.shape[0] if qpos.dim() == 2 else -1
    if B < 1:
        raise ValueError(f"step_fused: qpos shape {tuple(qpos.shape)}, expected (B, 7)")
    _check("qpos", qpos, torch.float32, (B, 7), dev)
    _check("qvel", qvel, torch.float32, (B, 6), dev)
    _check("ws", ws, torch.float32, (B, 6), dev)
    _check("params", params, torch.float32, None, dev)
    _check("meta", meta, torch.int32, None, dev)
    if params.dim() != 1 or meta.dim() != 1:
        raise ValueError("step_fused: params and meta must be 1-D")
    lib = load()
    qpos_out = torch.empty_like(qpos)
    qvel_out = torch.empty_like(qvel)
    x_out = torch.empty_like(qvel)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.step_fused_launch(
            meta.data_ptr(), params.data_ptr(), qpos.data_ptr(), qvel.data_ptr(),
            ws.data_ptr(), qpos_out.data_ptr(), qvel_out.data_ptr(),
            x_out.data_ptr(), B, stream)
    if err != 0:
        raise RuntimeError(f"step_fused: kernel launch failed with CUDA error {err}")
    step_fused.launches += 1
    return qpos_out, qvel_out, x_out


step_fused.launches = 0
