"""The port's batched Cholesky solve (K1's plain version) against the JAX
package's Pallas kernel.

The JAX kernel runs in interpret mode on the CPU (MRP_PALLAS_LINALG=1, as
tests/test_linalg_tpu.py runs it), through `_solve_batched`; the port's
`linalg_tpu.psd_solve` on CPU tensors runs `psd_solve_plain`, the same
right-looking Cholesky with the pivot clamp rsqrt(max(d, 1e-30)). Inputs
are seeded numpy float32 batches handed to both.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mujoco_ros_pkgs_tpu.ops import linalg_tpu as jlinalg_tpu

from mujoco_ros_pkgs_tpu_torch.ops import linalg_tpu


@pytest.fixture(autouse=True)
def _force_kernel(monkeypatch):
    monkeypatch.setenv("MRP_PALLAS_LINALG", "1")


def _spd(rng, B, n, scale=1.0):
    A = rng.normal(size=(B, n, n)).astype(np.float32) * scale
    return A @ np.transpose(A, (0, 2, 1)) + 3 * scale * scale * np.eye(n, dtype=np.float32)


@pytest.mark.parametrize("n", [1, 7, 11, 27, 72, 96])
def test_psd_solve_matches_jax_kernel(n):
    """float32 against the interpret-mode Pallas kernel: atol 2e-5 times
    the solution's scale (the same algorithm; rounding of rsqrt and of the
    sums differs), and both against numpy at the JAX test's tolerance."""
    rng = np.random.default_rng(n)
    B = 6
    H = _spd(rng, B, n)
    g = rng.normal(size=(B, n)).astype(np.float32)
    want = np.asarray(jlinalg_tpu._solve_batched(jnp.asarray(H), jnp.asarray(g), n))
    got = linalg_tpu.psd_solve(torch.from_numpy(H), torch.from_numpy(g))
    assert got.dtype == torch.float32 and got.shape == (B, n)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-5 * scale)
    ref = np.stack([np.linalg.solve(H[i].astype(np.float64), g[i]) for i in range(B)])
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=2e-5 * scale)


def test_psd_solve_reads_the_lower_triangle():
    """Only the lower triangle of H is read, as by the kernel (its upper
    triangle may hold anything)."""
    rng = np.random.default_rng(0)
    H = _spd(rng, 3, 9)
    g = rng.normal(size=(3, 9)).astype(np.float32)
    junk = np.triu(rng.normal(size=(3, 9, 9)).astype(np.float32), 1)
    a = linalg_tpu.psd_solve(torch.from_numpy(H), torch.from_numpy(g))
    b = linalg_tpu.psd_solve(torch.from_numpy(np.tril(H) + junk), torch.from_numpy(g))
    torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_psd_solve_float64_and_shapes():
    """float64 on the CPU solves to float64 accuracy; bad shapes raise."""
    rng = np.random.default_rng(1)
    H = _spd(rng, 2, 13).astype(np.float64)
    g = rng.normal(size=(2, 13))
    x = linalg_tpu.psd_solve(torch.from_numpy(H), torch.from_numpy(g))
    np.testing.assert_allclose(x.numpy(), np.linalg.solve(H, g[..., None])[..., 0],
                               rtol=0, atol=1e-12)
    with pytest.raises(ValueError, match="shapes"):
        linalg_tpu.psd_solve(torch.from_numpy(H), torch.from_numpy(g[:, :5]))


def k1_against_jax(path="chip_smoke_out/k1_c7_envs.npz"):
    """The JAX package's kernel (interpret mode, float32) on the envs
    chip_smoke.py's C7 phase saved (H, g, float64's x, K1's, the plain
    version's), each against float64 in units of 1e-5 + 1e-4 |x64|: the
    worst env of K1, of the plain version and of the JAX kernel per solve
    (ROADMAP C7: only a K1 farther from float64 than the JAX kernel is a
    fault). The saved x64 solves the whole H, whose two triangles differ in
    their last bits; K1 and the plain version read its lower triangle
    only, so the same margins are also given against float64's solve of
    that triangle mirrored."""
    z = np.load(path)
    for key in sorted({k.rsplit("_", 1)[0] for k in z.files}):
        H, g, x64, xk, xp = (z[f"{key}_{s}"] for s in ("H", "g", "x64", "xk", "xp"))
        xj = np.asarray(jlinalg_tpu._solve_batched(jnp.asarray(H), jnp.asarray(g), H.shape[-1]))
        lower = np.tril(H) + np.swapaxes(np.tril(H, -1), -1, -2)
        xl = np.linalg.solve(lower.astype(np.float64), g.astype(np.float64)[..., None])[..., 0]
        worst = [float((np.abs(x.astype(np.float64) - ref) / (1e-5 + 1e-4 * np.abs(ref))).max())
                 for ref in (x64, xl) for x in (xk, xp, xj)]
        asym = float(np.abs(H - np.swapaxes(H, -1, -2)).max() / np.abs(H).max())
        print(f"{key} (n {H.shape[-1]}, {len(H)} envs, triangles apart by {asym:.1e} of "
              f"|H|): worst env against float64, K1 "
              f"{worst[0]:.3f}, plain {worst[1]:.3f}, JAX kernel {worst[2]:.3f}; against "
              f"float64 on the lower triangle, K1 {worst[3]:.3f}, plain {worst[4]:.3f}, "
              f"JAX kernel {worst[5]:.3f}")


if __name__ == "__main__":
    import os
    import sys
    os.environ["MRP_PALLAS_LINALG"] = "1"
    k1_against_jax(*sys.argv[1:])
