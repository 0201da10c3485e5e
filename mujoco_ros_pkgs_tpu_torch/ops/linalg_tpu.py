"""Batched dense SPD solve x = H^-1 g (K1): the mass-matrix solve of the
general step and Euler's implicit-damping solve.

Counterpart of mujoco_ros_pkgs_tpu/ops/linalg_tpu.py (`_kernel`,
`_solve_batched`, `psd_solve`). On a CUDA float32 batch with n <= 96 it
launches the hand-written kernel csrc/linalg.cu (kernels.psd_solve); on a
CPU tensor it runs `psd_solve_plain`, the same right-looking Cholesky with
the TPU kernel's pivot clamp, in plain torch. Any other CUDA input raises.
"""

from __future__ import annotations

import torch

MAX_N = 96


def psd_solve_plain(H: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """(B, n, n) SPD H (lower triangle read), (B, n) g -> (B, n) x.

    Right-looking Cholesky: column j gets L_jj = d rsqrt(max(d, 1e-30)) with
    d the updated diagonal, L_ij = A_ij rsqrt(...) below it, then one rank-1
    update of the trailing submatrix; forward and back substitution follow."""
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
    y = g.clone()
    for j in range(n):
        y[:, j] = y[:, j] / A[:, j, j]
        if j + 1 < n:
            y[:, j + 1:] -= A[:, j + 1:, j] * y[:, j:j + 1]
    for i in reversed(range(n)):
        y[:, i] = (y[:, i] - (A[:, i + 1:, i] * y[:, i + 1:]).sum(-1)) / A[:, i, i]
    return y


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
