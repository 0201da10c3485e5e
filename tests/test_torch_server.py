"""The torch port's MujocoServer on the CPU at a small batch.

Step action semantics (rejected while running, chunked), pause, reset,
gravity edits that reach the step with no rebuild, reload with rollback,
body state, the general path (PENDULUM) behind the server,
get_solver_stats of a PILE server with both contact compactions. Plus: the
port and its server import no JAX, and the entry points default to the
card.
"""

import inspect
import subprocess
import sys

import numpy as np
import pytest
import torch

from mujoco_ros_pkgs_tpu_torch.models import worlds
from mujoco_ros_pkgs_tpu_torch.server import MujocoServer
from mujoco_ros_pkgs_tpu_torch.server import launch
from tests.torch_problems import pile_heap

NENV = 4


@pytest.fixture()
def srv():
    return MujocoServer(worlds.BOXES, nenv=NENV, device="cpu", unpause=False)


def test_step_is_rejected_while_running(srv):
    """step is rejected while the physics loop runs unpaused, and for
    nsteps <= 0 (as the JAX server's step)."""
    assert srv.step(3).success
    assert srv.sim_time == pytest.approx(0.006, abs=1e-6)
    srv.set_pause(False)
    srv.start_physics_loop()
    try:
        assert not srv.step(1).success
        srv.set_pause(True)
    finally:
        srv.stop_physics_loop()
    assert srv._physics_thread is None
    assert not srv.step(0).success
    t = srv.sim_time
    assert srv.step(70).success                    # two chunks: 64 + 6
    assert srv.sim_time - t == pytest.approx(0.140, abs=1e-5)   # 70 steps


def test_box_falls_and_reset_restores(srv):
    srv.step(60)
    st = srv.get_body_state("box", env_id=NENV - 1)
    assert st.pose.position[2] < 0.2
    assert st.twist.linear[2] < 0.0
    assert st.mass == pytest.approx(0.5)
    assert srv.reset().success
    st = srv.get_body_state("box", env_id=0)
    np.testing.assert_allclose(st.pose.position, [0.0, 0.0, 0.2], atol=1e-7)
    np.testing.assert_allclose(st.pose.orientation, [1.0, 0, 0, 0], atol=1e-7)
    assert srv.sim_time == 0.0


def test_set_gravity_reaches_the_step(srv):
    assert srv.set_gravity((0.0, 0.0, 0.0)).success
    np.testing.assert_allclose(srv.get_gravity(), [0.0, 0.0, 0.0])
    srv.step(10)
    state = srv.get_batch_state()
    np.testing.assert_allclose(state["qpos"][:, 2], 0.2, atol=1e-7)
    np.testing.assert_allclose(state["qvel"], 0.0, atol=1e-7)
    assert state["time"].shape == (NENV,)


def test_reload_bad_model_keeps_serving(srv):
    srv.step(5)
    res = srv.reload("<mujoco><bad")
    assert not res.success and res.status_message
    assert srv.get_loading_request_state().value == 0
    assert srv.get_body_state("box").pose.position[2] < 0.2
    # a model the port cannot step yet fails cleanly as well (the limit of
    # a ball joint)
    res = srv.reload(worlds.PENDULUM.replace(
        'type="ball" pos="0 0 1"/>', 'type="ball" pos="0 0 1" range="0 1"/>', 1))
    assert not res.success and "not ported" in res.status_message
    assert srv.step(1).success
    # and a good one replaces the old
    assert srv.reload(worlds.BOXES.replace('pos="0 0 0.2"', 'pos="0 0 0.5"')).success
    assert srv.get_body_state("box").pose.position[2] == pytest.approx(0.5)


def test_launch_runs_num_steps(tmp_path, capsys):
    path = tmp_path / "boxes.xml"
    path.write_text(worlds.BOXES)
    assert launch.main(["--modelfile", str(path), "--nenv", "2",
                        "--num-steps", "70", "--device", "cpu"]) == 0
    err = capsys.readouterr().err
    assert "sim_time=0.140s" in err and "steps=70" in err


def test_general_path_behind_the_server():
    """PENDULUM takes the general path; gravity edits reach it; the free
    ball's state reads as on the fused route."""
    srv = MujocoServer(worlds.PENDULUM, nenv=2, device="cpu", unpause=False)
    assert srv.step(3).success
    assert srv.sim_time == pytest.approx(0.003, abs=1e-7)
    ball = srv.get_body_state("ball", env_id=1)
    assert ball.mass == pytest.approx(0.1)
    assert ball.twist.linear[2] < 0.0 and ball.pose.position[2] < 0.06
    assert srv.reset().success and srv.set_gravity((0.0, 0.0, 0.0)).success
    assert srv.step(3).success
    np.testing.assert_allclose(srv.get_batch_state()["qvel"], 0.0, atol=1e-6)


def test_entry_points_default_to_the_card():
    """MujocoServer and the CLI run on the card unless asked for the CPU
    (read from their defaults; nothing is built here)."""
    assert inspect.signature(MujocoServer).parameters["device"].default == "cuda"
    args = launch.build_parser().parse_args(["--modelfile", "w.xml"])
    assert args.device == "cuda"


def test_port_imports_no_jax():
    code = ("import sys; import mujoco_ros_pkgs_tpu_torch, "
            "mujoco_ros_pkgs_tpu_torch.server, mujoco_ros_pkgs_tpu_torch.kernels, "
            "mujoco_ros_pkgs_tpu_torch.core.convert, "
            "mujoco_ros_pkgs_tpu_torch.ops.linalg_tpu, "
            "mujoco_ros_pkgs_tpu_torch.ops.solver, mujoco_ros_pkgs_tpu_torch.ops.efc, "
            "mujoco_ros_pkgs_tpu_torch.ops.narrowphase, "
            "mujoco_ros_pkgs_tpu_torch.ops.broadphase, "
            "mujoco_ros_pkgs_tpu_torch.ops.collision, "
            "mujoco_ros_pkgs_tpu_torch.ops.constraint, "
            "mujoco_ros_pkgs_tpu_torch.server.checkpoint, "
            "mujoco_ros_pkgs_tpu_torch.server.launch, "
            "mujoco_ros_pkgs_tpu_torch.utils.log; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'mujoco_ros_pkgs_tpu')]; "
            "print(bad); sys.exit(1 if bad else 0)")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_get_solver_stats_on_a_cpu_server():
    """get_solver_stats of one env of a PILE server with both compactions:
    the contact counts and forces of that env, a re-solve's Newton trips,
    gradient norm and cost (equal to ops/solver.newton's on the same env),
    and no broadphase overflow; reload keeps the server's capacities."""
    srv = MujocoServer(worlds.PILE, nenv=2, device="cpu", pair_topk=24, con_topk=64)
    qpos, qvel = pile_heap(srv.m, 2, seed=3)
    srv.d = srv.d.replace(qpos=torch.from_numpy(qpos).float(),
                          qvel=torch.from_numpy(qvel).float())
    assert srv.step(2).success
    st = srv.get_solver_stats(1)
    d1 = srv._env_slice(1)
    assert st["ncon_capacity"] == 219 and st["nefc"] == 657
    assert st["ncon_active"] == int((d1.contact.dist < d1.contact.includemargin).sum()) > 0
    assert st["broadphase_overflow"] == 0
    assert st["solver_iterations_limit"] == 12
    assert 1 <= st["solver_iterations_realized"] <= 12
    assert np.isfinite(st["solver_cost"]) and st["solver_grad_norm"] >= 0
    assert st["efc_force_max"] == float(srv.d.efc_force_contact[1].abs().max())
    assert srv.reload().success
    assert (srv.m.pair_topk, srv.m.con_topk) == (24, 64)
    assert srv.d.contact.dyn_pair.shape == (2, 168, 2)
