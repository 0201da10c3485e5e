"""Split ROADMAP C8 on the CPU: the port's float64 server against the JAX
server after tests/test_torch_server_services.py's mass edit (the box at
2.0) and test_set_qpos's writes, step by step.

    JAX_PLATFORMS=cpu python scripts/c8_rounding.py

Prints, for each of 3 steps, the Newton trips of every env on both sides
(get_solver_stats' re-solve, before the step) and the largest qpos and qvel
difference per env; then, from the same state, the JAX step run op by op
(jax.vmap, no jit), the same step jitted (as the JAX server runs it) and the
port's server step, pairwise.
"""

import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from mujoco_ros_pkgs_tpu.ops import forward as jfwd  # noqa: E402
from mujoco_ros_pkgs_tpu.server import MujocoServer as JaxServer  # noqa: E402

import tests.test_torch_server_services as T  # noqa: E402
from mujoco_ros_pkgs_tpu_torch.server import MujocoServer  # noqa: E402

Q = np.array([0.0, 0.1, 0.092, 1.0, 0.0, 0.0, 0.0])


def start():
    """Both servers after the mass edit and test_set_qpos's two writes."""
    pair = (JaxServer(T.CLUSTER, nenv=T.NENV, unpause=False),
            MujocoServer(T.CLUSTER, nenv=T.NENV, device="cpu", dtype=torch.float64))
    T.test_set_body_state_in_a_static_frame_and_its_mass(pair)
    T._placed(pair)
    T._both(pair, "set_qpos", Q)
    T._both(pair, "set_qpos", Q + [0.1, 0, 0, 0, 0, 0, 0], env_id=1, zero_qvel=True)
    return pair


def main():
    j, p = pair = start()
    for step in range(3):
        trips = [[s.get_solver_stats(e)["solver_iterations_realized"] for e in range(T.NENV)]
                 for s in pair]
        T._both(pair, "step", 1)
        dq = np.abs(p.d.qpos.numpy() - np.asarray(j.d.qpos)).max(1)
        dv = np.abs(p.d.qvel.numpy() - np.asarray(j.d.qvel)).max(1)
        print(f"step {step + 1}: Newton trips JAX {trips[0]}, port {trips[1]}; max |dqpos| "
              f"per env {dq}; max |dqvel| per env {dv}")
    j, p = pair = start()
    eager = np.asarray(jax.vmap(lambda d: jfwd.step(j.m, d))(j.d).qvel)
    jitted = np.asarray(jax.jit(jax.vmap(lambda d: jfwd.step(j.m, d)))(j.d).qvel)
    T._both(pair, "step", 1)
    served_j, served_p = np.asarray(j.d.qvel), p.d.qvel.numpy()
    for label, a, b in (("JAX jitted - JAX op by op", jitted, eager),
                        ("JAX server - JAX op by op", served_j, eager),
                        ("port server - JAX op by op", served_p, eager),
                        ("port server - JAX server", served_p, served_j)):
        print(f"one step, max |dqvel| per env, {label}: {np.abs(a - b).max(1)}")


if __name__ == "__main__":
    main()
