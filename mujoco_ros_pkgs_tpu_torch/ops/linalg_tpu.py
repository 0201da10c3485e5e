"""Batched dense SPD solve x = H^-1 g (K1): the mass-matrix solve of the
general step, Euler's implicit-damping solve and the general Newton's
Hessian solve.

Counterpart of mujoco_ros_pkgs_tpu/ops/linalg_tpu.py (`_kernel`,
`_solve_batched`, `psd_solve`, `_xla_solve`). `psd_solve` on a CUDA float32
batch with n <= 96 launches the hand-written kernel csrc/linalg.cu
(kernels.psd_solve); on a CPU tensor it runs `psd_solve_plain`, the same
right-looking Cholesky with the TPU kernel's pivot clamp, in plain torch,
and, as the kernel does above n = 16, one step of iterative refinement
with a float64 residual (past the TPU kernel, whose float32 answers on the
general Newton's ill-conditioned Hessians miss float64 by as much as any
other float32 ordering of its sums: PERF.md, ROADMAP C7).
Any other CUDA input raises. `solve`, which the step calls, picks the
route from n alone: `psd_solve` up to MAX_N, and above it `chol_solve`,
the library Cholesky the JAX package also uses there (`_xla_solve`: no
Pallas kernel solves n > 96).
"""

from __future__ import annotations

import torch

MAX_N = 96
# K1's block kernel (n > 16, kernels.psd_width) ends with one step of
# iterative refinement; its row kernel (n <= 16), whose body K2 and K3
# share, does not
REFINE_ABOVE = 16

def _cholesky(H: torch.Tensor) -> torch.Tensor:
    """The right-looking Cholesky of H's lower triangle: column j gets
    L_jj = d rsqrt(max(d, 1e-30)) with d the updated diagonal, L_ij = A_ij
    rsqrt(...) below it, then one rank-1 update of the trailing submatrix."""
    n = H.shape[-1]
    A = torch.tril(H).clone()
    for j in range(n):
        d = A[:, j, j]
        inv = torch.rsqrt(torch.clamp(d, min=1e-30))
        A[:, j, j] = d * inv
        if j + 1 < n:
            A[:, j + 1:, j] = A[:, j + 1:, j] * inv[:, None]
            col = A[:, j + 1:, j]
            A[:, j + 1:, j + 1:] -= torch.tril(col[:, :, None] * col[:, None, :])
    return A


def _substitute(L: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """(L L^T)^-1 g: forward, then back substitution."""
    n = L.shape[-1]
    y = g.clone()
    for j in range(n):
        y[:, j] = y[:, j] / L[:, j, j]
        if j + 1 < n:
            y[:, j + 1:] -= L[:, j + 1:, j] * y[:, j:j + 1]
    for i in reversed(range(n)):
        y[:, i] = (y[:, i] - (L[:, i + 1:, i] * y[:, i + 1:]).sum(-1)) / L[:, i, i]
    return y


def psd_solve_plain(H: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """(B, n, n) SPD H (lower triangle read), (B, n) g -> (B, n) x.

    K1's arithmetic in plain torch: the right-looking Cholesky (_cholesky),
    forward and back substitution, and for n > REFINE_ABOVE one step of
    iterative refinement, x += (L L^T)^-1 (g - H x) with the residual summed
    in float64 from H's lower triangle."""
    L = _cholesky(H)
    x = _substitute(L, g)
    if H.shape[-1] > REFINE_ABOVE:
        low = torch.tril(H).double()
        Hs = low + torch.tril(low, -1).mT
        r = g.double() - (Hs @ x.double()[..., None])[..., 0]
        x = x + _substitute(L, r.to(g.dtype))
    return x


def psd_solve(H: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """x = H^-1 g for a batch of SPD matrices: (B, n, n), (B, n) -> (B, n).

    CUDA: the K1 kernel for float32 and n <= 96, else ValueError. CPU: the
    plain version."""
    if H.dim() != 3 or g.dim() != 2 or H.shape[0] != g.shape[0] \
            or H.shape[1] != H.shape[2] or g.shape[1] != H.shape[1]:
        raise ValueError(f"psd_solve: shapes {tuple(H.shape)} and {tuple(g.shape)}, "
                         "expected (B, n, n) and (B, n)")
    if H.device.type == "cuda":
        n = H.shape[-1]
        if H.dtype != torch.float32 or g.dtype != torch.float32 or n > MAX_N:
            raise ValueError(f"psd_solve: the CUDA kernel takes float32 with "
                             f"n <= {MAX_N}, got {H.dtype}, n = {n}")
        from mujoco_ros_pkgs_tpu_torch import kernels
        return kernels.psd_solve(H.contiguous(), g.contiguous())
    if H.device.type == "cpu":
        return psd_solve_plain(H, g)
    raise ValueError(f"psd_solve: unsupported device {H.device}")


def chol_solve(H: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """x = H^-1 g by the library Cholesky (torch.linalg.cholesky_ex, lower
    triangle, then torch.cholesky_solve): the route past MAX_N. An env whose
    factorisation fails gets NaN, as jax.scipy's Cholesky gives, without a
    host sync."""
    L, info = torch.linalg.cholesky_ex(H)
    x = torch.cholesky_solve(g[..., None], L)[..., 0]
    return torch.where((info == 0)[:, None], x, torch.nan)


def solve(H: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """x = H^-1 g, the route chosen statically from n: `psd_solve` (K1 on
    CUDA) for n <= MAX_N, `chol_solve` above."""
    return psd_solve(H, g) if H.shape[-1] <= MAX_N else chol_solve(H, g)
