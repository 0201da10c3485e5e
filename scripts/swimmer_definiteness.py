"""How often implicitfast's matrix loses definiteness on SWIMMER.

    python scripts/swimmer_definiteness.py [--nenv 4096] [--seeds 0-7]
        [--speeds 1.5,2,3,5] [--gaits]

For each link speed (tests/torch_problems.swimmer_states's `link_speed`,
rad/s) and seed, builds the port's float64 implicitfast matrix
A = M - h qD (ops/forward.py `implicitfast_matrix`) on the CPU and prints the envs
whose smallest eigenvalue is <= 0, the smallest eigenvalue over the batch
relative to the smallest diagonal, and the envs whose float64 step
(psd_solve_plain, K1's arithmetic) is not finite. The JAX package builds
the same matrix and its Cholesky gives NaN in every such env
(tests/test_torch_fluid.py; ROADMAP C14).

`--gaits` also prints, for the states libmujoco's swimmer visits under
tests/torch_problems.SWIMMER_GAITS (every 10th step of 8 s from rest; needs
the `mujoco` package), the links' speeds and the same matrix's smallest
eigenvalue relative to its smallest diagonal.
"""

from __future__ import annotations

import argparse
import os
import sys
import warnings

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from mujoco_ros_pkgs_tpu_torch.core import mjcf  # noqa: E402
from mujoco_ros_pkgs_tpu_torch.ops import forward as fwd  # noqa: E402
from tests.torch_problems import SWIMMER, swimmer_gait_states, swimmer_states  # noqa: E402


def count(m, nenv: int, seed: int, speed: float) -> tuple[int, float, int]:
    """(indefinite envs, min eigenvalue / min diagonal, non-finite steps)."""
    names = ("qpos", "qvel", "ctrl")
    d = fwd.make_data(m, nenv).replace(**{k: torch.from_numpy(v) for k, v in zip(
        names, swimmer_states(m, nenv, seed, link_speed=speed))})
    A = fwd.implicitfast_matrix(m, fwd.forward(m, d))
    ev = torch.linalg.eigvalsh(A).min(-1).values
    rel = float((ev / torch.diagonal(A, 0, 1, 2).min(-1).values).min())
    bad = int((~torch.isfinite(fwd.step(m, d).qvel).all(-1)).sum())
    return int((ev <= 0).sum()), rel, bad


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--nenv", type=int, default=4096)
    ap.add_argument("--seeds", default="0-7", help="first-last")
    ap.add_argument("--speeds", default="1.5,2,3,5")
    ap.add_argument("--gaits", action="store_true")
    a = ap.parse_args()
    lo, hi = map(int, a.seeds.split("-"))
    warnings.filterwarnings("ignore", message=".*truncated to.*")
    torch.set_num_threads(min(4, os.cpu_count() or 1))
    m = mjcf.load_model_from_string(SWIMMER)
    for speed in map(float, a.speeds.split(",")):
        rows = [count(m, a.nenv, seed, speed) for seed in range(lo, hi + 1)]
        print(f"link speed {speed} rad/s, seeds {lo}-{hi} x {a.nenv} envs: indefinite "
              f"{sum(r[0] for r in rows)} (by seed {[r[0] for r in rows]}), smallest "
              f"eigenvalue / smallest diagonal {min(r[1] for r in rows):.6g}, non-finite "
              f"float64 steps {sum(r[2] for r in rows)}", flush=True)
    if a.gaits:
        speeds, (qpos, qvel, ctrl) = swimmer_gait_states()
        d = fwd.make_data(m, len(qpos)).replace(qpos=torch.from_numpy(qpos),
                                                qvel=torch.from_numpy(qvel),
                                                ctrl=torch.from_numpy(ctrl))
        A = fwd.implicitfast_matrix(m, fwd.forward(m, d))
        rel = torch.linalg.eigvalsh(A).min(-1).values / torch.diagonal(A, 0, 1, 2).min(-1).values
        print(f"libmujoco's gaits: link speeds p50 {np.percentile(speeds, 50):.6g}, p99 "
              f"{np.percentile(speeds, 99):.6g}, peak {speeds.max():.6g} rad/s; at "
              f"{len(qpos)} of their states smallest eigenvalue / smallest diagonal "
              f"{float(rel.min()):.6g}, indefinite {int((rel <= 0).sum())}", flush=True)


if __name__ == "__main__":
    main()
