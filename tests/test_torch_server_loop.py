"""The port server's physics loop, Step action, lock discipline, control
noise, checkpoints and CLI, on the CPU.

Mirrors tests/test_server.py (num_steps termination), tests/test_race_audit.py
(the lock audit and a concurrent-service stress) and tests/test_parallel.py
(checkpoint round trip and mismatch) of the JAX package. The control
noise's rate and scale are held against the JAX server's formula
(mujoco_ros_pkgs_tpu/server/server.py _get_step_fn) computed in numpy; its
draws come from the server's torch.Generator, so their statistics are
checked instead of the JAX package's per-env draws. Every thread is joined
with a timeout and every wait is bounded.
"""

import json
import random
import sys
import threading
import time

import numpy as np
import pytest
import torch

from mujoco_ros_pkgs_tpu_torch.models import worlds
from mujoco_ros_pkgs_tpu_torch.msgs import BodyState, Pose, StepGoal
from mujoco_ros_pkgs_tpu_torch.plugins.base import MujocoPlugin
from mujoco_ros_pkgs_tpu_torch.plugins.mocap import MocapPlugin
from mujoco_ros_pkgs_tpu_torch.plugins.ros_control import RosControlPlugin
from mujoco_ros_pkgs_tpu_torch.server import LockDisciplineError, MujocoServer
from mujoco_ros_pkgs_tpu_torch.server import checkpoint, launch
import mujoco_ros_pkgs_tpu_torch.server as server_pkg
import tests.torch_problems  # noqa: F401  (caps torch's threads)

# one motorised slide joint and a mocap target: no contact, a cheap step
SLIDER = """
<mujoco model="slider">
  <option timestep="0.01"/>
  <worldbody>
    <body name="cart">
      <joint name="s" type="slide" axis="1 0 0"/>
      <geom type="sphere" size="0.1" mass="1" contype="0" conaffinity="0"/>
    </body>
    <body name="target" mocap="true" pos="0 0 1">
      <geom type="sphere" size="0.05" contype="0" conaffinity="0"/>
    </body>
  </worldbody>
  <actuator><motor name="m" joint="s"/></actuator>
</mujoco>
"""


def _wait(cond, timeout=30.0):
    deadline = time.monotonic() + timeout
    while not cond():
        assert time.monotonic() < deadline, "timed out"
        time.sleep(0.01)


class _Counter(MujocoPlugin):
    """Counts its control calls in its batched state; raises at call
    `fail_at` (0: never)."""

    def __init__(self, fail_at=0):
        super().__init__()
        self.fail_at, self.calls = fail_at, 0

    def init_state(self, m, nenv):
        return {"n": torch.zeros(nenv, dtype=m.qpos0.dtype)}

    def control(self, m, d, ps):
        self.calls += 1
        if self.calls == self.fail_at:
            raise RuntimeError("control hook failed")
        return d, {"n": ps["n"] + 1.0}


def test_physics_loop_stops_at_num_steps():
    """The loop runs 70 steps in chunks of 64 and 6, publishes the clock
    after each chunk and stops (tests/test_server.py:59-69)."""
    srv = MujocoServer(SLIDER, nenv=2, device="cpu", unpause=True, num_steps=70)
    ticks = []
    srv.subscribe_clock(ticks.append)
    srv.start_physics_loop()
    _wait(lambda: srv._physics_thread is None)
    srv.stop_physics_loop()
    assert srv.num_steps_until_exit == 0 and srv.physics_error is None
    assert srv.sim_time == pytest.approx(0.70, abs=1e-5)
    assert ticks == pytest.approx([0.64, 0.70], abs=1e-5)


def test_paced_loop_keeps_its_speed_and_resyncs_on_pause():
    """Paced at a quarter of real time the loop's measured slowdown is within
    20% of 0.25; while paused sim time stands still, and after it (and after
    a speed change) the pace is measured from a new baseline."""
    srv = MujocoServer(SLIDER, nenv=2, device="cpu", unpause=True, realtime=0.25)
    srv.start_physics_loop()
    try:
        time.sleep(1.5)
        assert srv.measured_slowdown == pytest.approx(0.25, rel=0.2)
        srv.set_pause(True)
        time.sleep(0.1)
        t = srv.sim_time
        time.sleep(0.5)
        assert srv.sim_time == t
        srv.set_pause(False)
        time.sleep(1.0)
        assert srv.measured_slowdown == pytest.approx(0.25, rel=0.2)
        assert srv.set_speed(0.1).success
        time.sleep(1.5)
        assert srv.measured_slowdown == pytest.approx(0.1, rel=0.2)
    finally:
        srv.stop_physics_loop()
    assert srv._physics_thread is None and srv.physics_error is None


def test_physics_error_stops_the_loop():
    """A step that raises stops the loop and is kept in physics_error; the
    control plane still answers."""
    srv = MujocoServer(SLIDER, nenv=2, device="cpu", unpause=True,
                       plugins=[_Counter(fail_at=5)])
    srv.start_physics_loop()
    _wait(lambda: srv._physics_thread is None)
    assert isinstance(srv.physics_error, RuntimeError)
    assert srv.get_body_state("cart").mass == pytest.approx(1.0)
    assert int(srv.pstates[0]["n"][0]) == 4


def test_step_action_feedback_and_preemption():
    """The Step action reports the steps left after each chunk of 16 and
    succeeds; preempted after its first feedback it fails having run whole
    chunks; it is rejected for no steps and while the loop runs unpaused
    (callbacks.cpp:94-129)."""
    srv = MujocoServer(SLIDER, nenv=2, device="cpu")
    fb, done = [], []
    assert srv.step_action(StepGoal(num_steps=40), feedback_cb=lambda f: fb.append(f.steps_left),
                           done_cb=lambda r: done.append(r.success))
    _wait(lambda: done)
    srv._step_thread.join(timeout=30)
    assert fb == [24, 8, 0] and done == [True]
    assert srv.sim_time == pytest.approx(0.40, abs=1e-5)
    first, done = threading.Event(), []
    assert srv.step_action(StepGoal(num_steps=400), feedback_cb=lambda f: first.set(),
                           done_cb=lambda r: done.append(r.success))
    assert first.wait(timeout=30)
    srv.preempt_step_action(timeout=30)
    assert done == [False] and not srv._step_thread.is_alive()
    steps = round((srv.sim_time - 0.40) / 0.01)
    assert steps % 16 == 0 and 16 <= steps < 400
    assert not srv.step_action(StepGoal(num_steps=0), done_cb=done.append)
    srv.set_pause(False)
    srv.start_physics_loop()
    try:
        assert not srv.step_action(StepGoal(num_steps=5))
    finally:
        srv.stop_physics_loop()


def test_unlocked_write_detected_while_running():
    """While the loop runs, writing d, m or pstates without the lock raises
    LockDisciplineError; under the lock, or with the loop stopped, it is
    allowed (tests/test_race_audit.py:19-31)."""
    srv = MujocoServer(worlds.BOXES, nenv=2, device="cpu", unpause=True)
    srv.start_physics_loop()
    try:
        time.sleep(0.2)
        for name in ("d", "m", "pstates"):
            with pytest.raises(LockDisciplineError):
                setattr(srv, name, getattr(srv, name))
            with srv._lock:
                setattr(srv, name, getattr(srv, name))
    finally:
        srv.stop_physics_loop()
    srv.d = srv.d


def test_concurrent_service_stress():
    """Four threads call reading and mutating services while the loop steps,
    with a short thread switch interval: no lock-discipline error, no
    physics error, a finite batch (tests/test_race_audit.py:34-68)."""
    srv = MujocoServer(worlds.BOXES, nenv=4, device="cpu", unpause=True)
    srv.start_physics_loop()
    errors = []

    def worker(seed):
        rng = random.Random(seed)
        try:
            for _ in range(25):
                op = rng.randrange(6)
                if op == 0:
                    srv.get_body_state("box", env_id=rng.randrange(4))
                elif op == 1:
                    srv.apply_body_wrench("box", force=(0, 0, rng.uniform(-1, 1)))
                elif op == 2:
                    srv.get_solver_stats(rng.randrange(4))
                elif op == 3:
                    srv.set_gravity((0, 0, -9.81 + rng.uniform(-0.1, 0.1)))
                elif op == 4:
                    srv.set_body_state(BodyState(name="box", pose=Pose(
                        np.array([0, 0, 0.3]))), set_twist=False)
                else:
                    srv.get_physics_properties()
        except Exception as exc:   # noqa: BLE001 - collected for the assert
            errors.append(exc)

    threads = [threading.Thread(target=worker, args=(k,)) for k in range(4)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
        srv.stop_physics_loop()
    assert errors == [] and srv.physics_error is None
    assert bool(torch.isfinite(srv.d.qpos).all() and torch.isfinite(srv.d.qvel).all())


def test_control_noise_follows_the_jax_formula():
    """rate = exp(-dt / ctrl_noise_rate) (0 when the rate is 0) and
    scale = std sqrt(1 - rate^2), as the JAX server computes them; one step
    moves ctrl to rate ctrl + scale N(0, 1) with the server generator's
    draws; over 4096 envs the stationary std is within 5% of std."""
    std, tau = 0.3, 0.02
    srv = MujocoServer(SLIDER, nenv=4096, device="cpu", ctrl_noise_std=std,
                       ctrl_noise_rate=tau, seed=11)
    rate = np.exp(-0.01 / tau)
    assert srv.ctrl_noise_coefficients() == pytest.approx(
        (rate, std * np.sqrt(1 - rate ** 2)), rel=1e-15)
    assert MujocoServer(SLIDER, device="cpu", ctrl_noise_std=std).ctrl_noise_coefficients() \
        == (0.0, std)
    assert srv.set_ctrl([0.5]).success
    gen = torch.Generator().manual_seed(11)
    want = rate * 0.5 + std * np.sqrt(1 - rate ** 2) * torch.randn(
        (4096, 1), generator=gen, dtype=torch.float32)
    assert srv.step(1).success
    torch.testing.assert_close(srv.d.ctrl, want, rtol=1e-6, atol=1e-6)
    assert srv.step(30).success
    assert float(srv.d.ctrl.std()) == pytest.approx(std, rel=0.05)
    assert abs(float(srv.d.ctrl.mean())) < 4 * std / np.sqrt(4096)


def test_control_noise_off_and_reset_repeats_the_draws():
    """std 0 leaves ctrl as set; reset re-seeds the generator, so the same
    steps draw the same noise."""
    quiet = MujocoServer(SLIDER, nenv=3, device="cpu", ctrl_noise_rate=0.05)
    assert quiet.set_ctrl([0.7]).success and quiet.step(5).success
    assert quiet.d.ctrl.tolist() == [[pytest.approx(0.7)]] * 3
    srv = MujocoServer(SLIDER, nenv=3, device="cpu", ctrl_noise_std=0.2,
                       ctrl_noise_rate=0.05, seed=4)
    assert srv.step(7).success
    first = srv.d.ctrl.clone()
    assert srv.reset().success and srv.step(7).success
    assert torch.equal(srv.d.ctrl, first) and len(set(first[:, 0].tolist())) == 3


def test_checkpoint_round_trip(tmp_path):
    """Save, step, load: the state, the generator and the plugin state come
    back, and the resumed run repeats the first continuation bit for bit
    (tests/test_parallel.py:78-96), noise included."""
    srv = MujocoServer(SLIDER, nenv=3, device="cpu", ctrl_noise_std=0.2,
                       ctrl_noise_rate=0.05, plugins=[_Counter(), MocapPlugin()])
    assert srv.step(10).success
    assert srv.apply_body_wrench("cart", force=(0.5, 0, 0), env_id=1).success
    q0, t0 = srv.d.qpos.clone(), srv.sim_time
    checkpoint.save(srv, str(tmp_path / "ck"))
    manifest = json.loads((tmp_path / "ck.json").read_text())
    assert manifest["model"] == "slider" and manifest["nenv"] == 3
    assert srv.step(20).success and not torch.equal(srv.d.qpos, q0)
    checkpoint.load(srv, str(tmp_path / "ck"))
    assert torch.equal(srv.d.qpos, q0) and srv.sim_time == t0
    assert srv.pstates[0]["n"].tolist() == [10.0] * 3 and srv._applied
    assert srv.step(5).success
    after = (srv.d.qpos.clone(), srv.d.ctrl.clone())
    checkpoint.load(srv, str(tmp_path / "ck"))
    assert srv.step(5).success
    assert torch.equal(srv.d.qpos, after[0]) and torch.equal(srv.d.ctrl, after[1])


def test_checkpoint_mismatch_and_native_blob(tmp_path):
    """Another model or nenv is refused with ValueError before anything
    changes, and so is a blob of neither the native codec's format nor the
    numpy one's."""
    srv = MujocoServer(SLIDER, nenv=2, device="cpu")
    path = str(tmp_path / "ck")
    checkpoint.save(srv, path)
    for other in (MujocoServer(worlds.BOXES, nenv=2, device="cpu"),
                  MujocoServer(SLIDER, nenv=3, device="cpu")):
        d = other.d
        with pytest.raises(ValueError):
            checkpoint.load(other, path)
        assert other.d is d
    blob = (tmp_path / "ck.bin").read_bytes()
    (tmp_path / "ck.bin").write_bytes(b"MRSC" + blob[4:])
    with pytest.raises(ValueError, match="native"):
        checkpoint.load(srv, path)


def test_cli(tmp_path, monkeypatch, capsys):
    """The launcher loads the plugins of --config, waits for a model file
    that appears (--wait-for-model), exits 2 for a model that does not or
    fails to load, and 1 with FATAL when the physics loop dies."""
    made = []

    class Recorded(MujocoServer):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            made.append(self)
    monkeypatch.setattr(server_pkg, "MujocoServer", Recorded)
    cfg = tmp_path / "plugins.json"
    cfg.write_text(json.dumps({
        "MujocoPlugins": [{"type": "mocap"},
                          {"type": "ros_control", "joints": {"s": {"method": "EFFORT"}}}],
        "initial_joint_positions": {"s": [0.25]}}))
    model = tmp_path / "slider.xml"
    writer = threading.Timer(0.3, model.write_text, args=(SLIDER,))
    writer.start()
    try:
        assert launch.main(["--modelfile", str(model), "--wait-for-model", "20",
                            "--device", "cpu", "--nenv", "2", "--num-steps", "70",
                            "--config", str(cfg), "--ctrl-noise-std", "0.1",
                            "--ctrl-noise-rate", "0.05"]) == 0
    finally:
        writer.join(timeout=10)
    srv = made[-1]
    assert [type(p) for p in srv.registry.cb_ready] == [MocapPlugin, RosControlPlugin]
    assert srv.sim_time == pytest.approx(0.70, abs=1e-5) and srv._init_js == {"s": [0.25]}
    assert "sim_time=0.700s steps=70" in capsys.readouterr().err
    assert launch.main(["--modelfile", str(tmp_path / "none.xml"), "--wait-for-model",
                        "0.2", "--device", "cpu"]) == 2
    assert launch.main(["--modelfile", "<mujoco><bad", "--model-string",
                        "--device", "cpu"]) == 2

    def boom(self):
        raise RuntimeError("step failed")
    monkeypatch.setattr(MujocoServer, "_substep", boom)
    assert launch.main(["--modelfile", str(model), "--device", "cpu",
                        "--num-steps", "10"]) == 1
    assert "FATAL: physics loop died" in capsys.readouterr().err
