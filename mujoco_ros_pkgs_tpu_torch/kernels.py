"""Build and bind the port's hand-written CUDA kernels.

Each source in csrc/ is compiled at first use with nvcc for sm_90a into a
shared library of its own with a plain C interface, cached under _build/ by
a hash of all the sources and flags, and loaded with ctypes; the nvcc runs
start together. Nothing is built or imported from CUDA when this module is
imported, so the CPU tests can import it.

Each wrapper checks device, dtype, shape and contiguity, allocates its
outputs with torch.empty, launches on the current CUDA stream, raises if the
launch failed, and counts its launches in a plain integer attribute
(`step_fused.launches`, `psd_solve.launches`, `newton_solve.launches`).

K2 and K3 run one Newton body (csrc/solver.cuh) on a group of G lanes per
env; `group_width` picks G from the rows and the batch, and the C entry
points take it. K1 picks its lanes per env from n alone (`psd_width`): a
group of 8 or 16 up to n = 16, a block of `PSD_BLOCK_THREADS` above.
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
# library name -> (source, C entry point, its argument types)
_P, _I = ctypes.c_void_p, ctypes.c_int
_LIBS = {
    "step_fused": ("step_fused.cu", "step_fused_launch", [_P] * 8 + [_I] * 4 + [_P]),
    "linalg": ("linalg.cu", "psd_solve_launch", [_P] * 3 + [_I] * 3 + [_P]),
    "solver": ("solver.cu", "newton_solve_launch", [_P] * 14 + [_I] * 5 + [_P]),
}

GROUP_WIDTHS = (8, 16)         # lanes per env K2 and K3 are built for

_lock = threading.Lock()
_fns: dict = {}
build_log = ""          # nvcc's output of the builds this process ran (ptxas -v)


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


def library_path(name: str) -> Path:
    return BUILD_DIR / f"libmrp_{name}_{_source_hash()}.so"


def build() -> dict:
    """Compile every csrc/ library that is not cached, one nvcc per source,
    all started together. Returns {name: path}."""
    global build_log
    paths = {name: library_path(name) for name in _LIBS}
    todo = [name for name, p in paths.items() if not p.exists()]
    if not todo:
        return paths
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for name in todo:
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, str(CSRC / _LIBS[name][0])]
        procs[name] = (tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                             stderr=subprocess.STDOUT, text=True))
    failed = []
    for name, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        build_log += f"--- {_LIBS[name][0]}\n{out}"
        if proc.returncode != 0:
            os.unlink(tmp)
            failed.append(f"{_LIBS[name][0]} ({proc.returncode})")
        else:
            os.replace(tmp, paths[name])
    if failed:
        raise RuntimeError(f"nvcc failed for {', '.join(failed)}:\n{build_log}")
    return paths


def _fn(name: str):
    """The ctypes entry point of library `name`, building the libraries if
    needed."""
    with _lock:
        if name not in _fns:
            paths = build()
            for lib_name, (_, sym, argtypes) in _LIBS.items():
                fn = getattr(ctypes.CDLL(str(paths[lib_name])), sym)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
                _fns[lib_name] = fn
        return _fns[name]


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


def _sm_count(device) -> int:
    """SMs of a CUDA device (132 on an H100 SXM); for any other device 132,
    since the launch then refuses its tensors anyway."""
    if device.type != "cuda":
        return 132
    return torch.cuda.get_device_properties(device).multi_processor_count


def _launch(name, fn, *args):
    err = fn(*args)
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error {err}")


def group_width(nv: int, nefc: int, ncon: int, nenv: int, sms: int = 132) -> int:
    """Lanes per env (G) of K2 and K3 for nenv envs of nv dofs, nefc rows
    and ncon contacts on a card of `sms` SMs, as measured on the H100
    (PERF.md). A lane owns one dof, so G >= nv. Registers allow 4 blocks of
    128 threads per SM, 32 envs at 16 lanes: while the batch fits that one
    wave, the slowest env's latency sets the time and 16 lanes shorten it.
    Past it, 8 lanes hold twice the envs per SM while an env's slice of
    shared memory is small; beyond three rows a lane, shared memory cuts
    their blocks (at 60 rows to as few envs as 16 lanes hold)."""
    return 16 if nv > 8 or nefc > 3 * 8 or nenv <= 32 * sms else 8


def step_fused(meta, params, qpos, qvel, ws, rows):
    """Fused whole step (csrc/step_fused.cu) of a (B,) env batch on the card.

    meta: int32 (nmeta,) from ops/step_tpu.kernel_meta; params: float32
    (NP,) from ops/step_tpu._pack_params; qpos (B, 7), qvel (B, 6), ws
    (B, 6) float32; rows: the model's (constraint rows, contacts), as the
    solve block of meta says. Returns (qpos', qvel', x_solver)."""
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
    nefc, ncon = rows
    if not 1 <= nefc <= 64 or not 1 <= ncon <= nefc:
        raise ValueError(f"step_fused: {nefc} rows and {ncon} contacts; the kernel "
                         "takes 1..64 rows")
    group = group_width(6, nefc, ncon, B, _sm_count(dev))
    fn = _fn("step_fused")
    qpos_out = torch.empty_like(qpos)
    qvel_out = torch.empty_like(qvel)
    x_out = torch.empty_like(qvel)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        _launch("step_fused", fn, meta.data_ptr(), params.data_ptr(), qpos.data_ptr(),
                qvel.data_ptr(), ws.data_ptr(), qpos_out.data_ptr(),
                qvel_out.data_ptr(), x_out.data_ptr(), B, nefc, ncon, group, stream)
    step_fused.launches += 1
    return qpos_out, qvel_out, x_out


step_fused.launches = 0


# threads per env of K1's block kernel (17 <= n <= 96; csrc/linalg.cuh
# kBlockThreads): 4 warps, faster than 2 at every n and batch swept on the
# H100 (PERF.md)
PSD_BLOCK_THREADS = 128


def psd_width(n: int) -> int:
    """Lanes (threads) per env of K1 for n x n systems, as measured on the
    H100 (PERF.md). Up to n = 16 a lane owns a row in registers, at 8 lanes
    to n = 8 and 16 above: each column step is a shuffle, an rsqrt and a
    multiply-add. Past 16 a block of PSD_BLOCK_THREADS threads takes each
    env: n padded to a multiple of 8, each panel of 8 columns factored in
    registers by the threads that hold its rows, the trailing triangle
    updated by the whole block in 4 x 4 register tiles, so an env's latency
    is two barriers per panel and its multiply-adds are shared by the block
    (csrc/linalg.cu)."""
    return 8 if n <= 8 else 16 if n <= 16 else PSD_BLOCK_THREADS


def psd_solve(H, g):
    """x = H^-1 g (csrc/linalg.cu, K1) for H (B, n, n) SPD (lower triangle
    read) and g (B, n), float32 on the card, n <= 96, on `psd_width(n)`
    lanes or threads per env (kept in `psd_solve.width`): the row kernel at
    8 or 16, the block kernel at PSD_BLOCK_THREADS. Returns x (B, n)."""
    if H.dim() != 3 or H.shape[1] != H.shape[2] or not 1 <= H.shape[1] <= 96 \
            or H.shape[0] < 1:
        raise ValueError(f"psd_solve: H shape {tuple(H.shape)}, expected (B, n, n), "
                         "1 <= n <= 96")
    if H.dtype != torch.float32:
        raise ValueError(f"psd_solve: dtype {H.dtype}, expected torch.float32")
    if H.device.type != "cuda":
        raise ValueError(f"psd_solve: H is on {H.device}, not a CUDA device")
    dev = H.device
    B, n = H.shape[0], H.shape[1]
    _check("H", H, torch.float32, (B, n, n), dev)
    _check("g", g, torch.float32, (B, n), dev)
    width = psd_width(n)
    fn = _fn("linalg")
    x = torch.empty_like(g)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        _launch("psd_solve", fn, H.data_ptr(), g.data_ptr(), x.data_ptr(), B, n, width,
                stream)
    psd_solve.launches += 1
    psd_solve.width = width
    return x


psd_solve.launches = 0
psd_solve.width = None


def newton_solve(meta, tol, J, aref, D, floss, active, mu, M, a_s, ws):
    """The whole Newton solve (csrc/solver.cu, K2) of a (B,) env batch.

    meta: int32 from ops/solver_tpu.kernel_meta for these shapes; tol:
    float32 (1,); J (B, nefc, nv); aref, D, floss (B, nefc) float32; active
    (B, nefc) bool; mu (B, max(ncon, 1), 5); M (B, nv, nv); a_s, ws (B, nv).
    Returns (qacc (B, nv), qfrc (B, nv), f_rows (B, nefc))."""
    if J.device.type != "cuda":
        raise ValueError(f"newton_solve: J is on {J.device}, not a CUDA device")
    dev = J.device
    if J.dim() != 3 or J.shape[0] < 1 or not 1 <= J.shape[1] <= 64 \
            or not 1 <= J.shape[2] <= 16:
        raise ValueError(f"newton_solve: J shape {tuple(J.shape)}; the kernel takes "
                         "(B, nefc, nv) with 1..64 rows and nv <= 16")
    B, nefc, nv = J.shape
    _check("meta", meta, torch.int32, None, dev)
    ncon = (meta.numel() - 6 - nefc) // 2
    if meta.dim() != 1 or ncon < 0 or meta.numel() != 6 + nefc + 2 * ncon:
        raise ValueError(f"newton_solve: meta of {meta.numel()} values does not "
                         f"describe {nefc} rows (ops/solver_tpu.kernel_meta)")
    f32 = torch.float32
    _check("tol", tol, f32, (1,), dev)
    _check("J", J, f32, (B, nefc, nv), dev)
    for name, t in (("aref", aref), ("D", D), ("floss", floss)):
        _check(name, t, f32, (B, nefc), dev)
    _check("active", active, torch.bool, (B, nefc), dev)
    _check("mu", mu, f32, (B, max(ncon, 1), 5), dev)
    _check("M", M, f32, (B, nv, nv), dev)
    _check("a_s", a_s, f32, (B, nv), dev)
    _check("ws", ws, f32, (B, nv), dev)
    group = group_width(nv, nefc, ncon, B, _sm_count(dev))
    fn = _fn("solver")
    x = torch.empty_like(a_s)
    qfrc = torch.empty_like(a_s)
    f = torch.empty_like(aref)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        _launch("newton_solve", fn, meta.data_ptr(), tol.data_ptr(), J.data_ptr(),
                aref.data_ptr(), D.data_ptr(), floss.data_ptr(), active.data_ptr(),
                mu.data_ptr(), M.data_ptr(), a_s.data_ptr(), ws.data_ptr(),
                x.data_ptr(), qfrc.data_ptr(), f.data_ptr(), B, nv, nefc, ncon, group,
                stream)
    newton_solve.launches += 1
    return x, qfrc, f


newton_solve.launches = 0
