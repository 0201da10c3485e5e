"""The torch port's multi-process plane: two processes over torch.distributed
(gloo on the CPU, float64), each a rank of tests/torch_multihost_worker.py,
against the same work in one process and against the JAX package.

- BOXES at 16 envs, 2 x 5 steps through multihost.shardmap_step_fn with its
  consumer, driven by process 0's HostCoordinator commands: both ranks
  observe process 0's sequence and hold one global state, the union of
  their rows equals the single-process port bit for bit and the JAX
  package's jax.vmap(fwd.step) at 1e-12 (the general route: the JAX package
  steps float64 on its general route, its fused kernel being float32), and
  the consumer is the gathered state's mean within 1e-12;
- a distributed server of SENSORS_MOTOR with the sensors plugin and control
  noise at 16 envs through a service sequence that process 0 originates
  and rank 1 replays: the final global state equals a single-process
  server's after the same calls, and so does every normal draw, bit for bit;
- the launcher's --distributed on two processes: both exit 0;
- a rank alone in a group of two fails within the group's timeout.

Workers are subprocesses with a timeout and one torch thread; no process
group is joined inside the pytest process.
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mujoco_ros_pkgs_tpu.ops import forward as jfwd

from mujoco_ros_pkgs_tpu_torch.models import worlds
from mujoco_ros_pkgs_tpu_torch.ops import forward as fwd
from mujoco_ros_pkgs_tpu_torch.parallel import multihost as mh
from mujoco_ros_pkgs_tpu_torch.utils import rng
from tests import torch_multihost_worker as worker
from tests.torch_jax import jax_load

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "torch_multihost_worker.py")
WAIT_S = 120


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"
    return env


def _run_ranks(cmds, timeout=WAIT_S):
    """Start every command at once; (returncode, output) of each, every
    process killed if one outlives the timeout."""
    procs = [subprocess.Popen(c, cwd=REPO, env=_env(), stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for c in cmds]
    try:
        outs = [p.communicate(timeout=timeout)[0] for p in procs]
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        for p in procs:
            p.communicate()
        pytest.fail(f"a rank outlived {timeout} s")
    return [(p.returncode, out) for p, out in zip(procs, outs)]


def _two_ranks(mode, outdir):
    port = _free_port()
    runs = _run_ranks([[sys.executable, WORKER, mode, str(pid), "2", str(port), str(outdir)]
                       for pid in range(2)])
    for pid, (rc, out) in enumerate(runs):
        assert rc == 0, f"rank {pid} exited {rc}:\n{out[-4000:]}"
    return ([dict(np.load(outdir / f"{mode}_{pid}.npz")) for pid in range(2)],
            [json.loads((outdir / f"{mode}_{pid}.json").read_text()) for pid in range(2)])


@pytest.fixture(scope="module")
def boxes_run(tmp_path_factory):
    return _two_ranks("boxes", tmp_path_factory.mktemp("boxes"))


@pytest.fixture(scope="module")
def sensors_run(tmp_path_factory):
    return _two_ranks("sensors", tmp_path_factory.mktemp("sensors"))


@pytest.fixture(scope="module")
def sensors_single():
    """The same service sequence on one process's server, its draws kept."""
    plain = rng.randn
    try:
        draws = worker.recording_draws()
        srv = worker.sensors_server()
        out = worker.sensors_sequence(srv)
    finally:
        rng.randn = plain
    return srv, out, draws


def test_ranks_observe_process0_commands(boxes_run):
    _, meta = boxes_run
    assert meta[0]["observed"] == meta[1]["observed"]
    assert [tuple(c) for c in meta[0]["observed"]] == list(worker.SCRIPT)


def test_boxes_ranks_hold_one_global_state(boxes_run):
    """Both ranks gather the same global batch, whose halves are their rows."""
    arrays, _ = boxes_run
    for f in worker.FIELDS:
        np.testing.assert_array_equal(arrays[0][f], arrays[1][f], err_msg=f)
    np.testing.assert_array_equal(
        arrays[0]["qpos"], np.concatenate([a["local_qpos"] for a in arrays]))
    np.testing.assert_array_equal(arrays[0]["consumed"], arrays[1]["consumed"])


def _single_boxes(nsteps):
    m = worker.boxes_model()
    d = worker.boxes_init(fwd.make_data(m, worker.BOXES_NENV), np.arange(worker.BOXES_NENV))
    qpos0, qvel0 = d.qpos.numpy().copy(), d.qvel.numpy().copy()
    for _ in range(nsteps):
        d = fwd.step(m, d, fwd.GeneralPlan())
    return d, qpos0, qvel0


def test_boxes_union_equals_single_process(boxes_run):
    """The two ranks' rows after 10 steps are the single-process batch's,
    bit for bit."""
    arrays, _ = boxes_run
    d, _, _ = _single_boxes(10)
    for f in worker.FIELDS:
        np.testing.assert_array_equal(arrays[0][f], getattr(d, f).numpy(), err_msg=f)


def test_boxes_union_matches_jax(boxes_run):
    """The union against the JAX package's jax.vmap(fwd.step) of the same
    envs, 10 steps in float64, at 1e-12."""
    arrays, _ = boxes_run
    _, qpos0, qvel0 = _single_boxes(0)
    jm = jax_load(worlds.BOXES, dtype=jnp.float64)
    jd1 = jfwd.make_data(jm, dtype=jnp.float64)
    jd = jax.tree_util.tree_map(
        lambda x: jnp.broadcast_to(x, (worker.BOXES_NENV,) + x.shape), jd1)
    jd = jd.replace(qpos=jnp.asarray(qpos0), qvel=jnp.asarray(qvel0))
    step = jax.jit(jax.vmap(lambda x: jfwd.step(jm, x)))
    for _ in range(10):
        jd = step(jd)
    for f in worker.FIELDS:
        np.testing.assert_allclose(arrays[0][f], np.asarray(getattr(jd, f)),
                                   rtol=0, atol=1e-12, err_msg=f)


def test_consumer_is_gathered_mean(boxes_run):
    arrays, _ = boxes_run
    want = np.concatenate([arrays[0]["qpos"].mean(0), [arrays[0]["time"].mean()]])
    np.testing.assert_allclose(arrays[0]["consumed"], want, rtol=0, atol=1e-12)


def test_sensors_ranks_hold_one_global_state(sensors_run):
    """After the sequence (process 0 originating, rank 1 replaying) both
    ranks gather the same batch, plugin outputs and generator state."""
    arrays, meta = sensors_run
    for f in ("qpos", "qvel", "ctrl", "time", "noisy", "gt", "generator"):
        np.testing.assert_array_equal(arrays[0][f], arrays[1][f], err_msg=f)
    np.testing.assert_array_equal(
        arrays[0]["qpos"], np.concatenate([a["local_qpos"] for a in arrays]))
    assert meta[0]["ndraws"] == meta[1]["ndraws"] > 0
    assert meta[0]["feedback"][-1] == 0


def test_sensors_equals_single_process(sensors_run, sensors_single):
    """The final global state, the plugin's outputs and every read of the
    sequence equal one process's server after the same calls."""
    arrays, meta = sensors_run
    srv, out, _ = sensors_single
    ps = srv.pstates[0]
    want = {f: getattr(srv.d, f).numpy() for f in ("qpos", "qvel", "ctrl", "time")}
    want.update(noisy=ps["noisy"].numpy(), gt=ps["gt"].numpy())
    for f, w in want.items():
        np.testing.assert_array_equal(arrays[0][f], w, err_msg=f)
    for key in ("body_pos", "body_lin", "noisy", "gt", "qpos_after", "feedback"):
        assert meta[0][key] == out[key], key
    np.testing.assert_array_equal(arrays[0]["generator"], srv._generator.get_state().numpy())


def test_noise_equals_single_process_bit_for_bit(sensors_run, sensors_single):
    """Every normal draw (control noise and the plugin's) of the two ranks,
    their rows joined, is the single-process server's draw."""
    arrays, meta = sensors_run
    _, _, draws = sensors_single
    assert meta[0]["ndraws"] == len(draws)
    for k, want in enumerate(draws):
        got = np.concatenate([a[f"draw_{k}"] for a in arrays])
        np.testing.assert_array_equal(got, want.numpy(), err_msg=f"draw {k}")
    assert any(d.shape[1] == 1 for d in draws)     # the motor's control noise


def test_launcher_distributed_two_processes(tmp_path):
    """`launch --distributed` on two processes: process 0 serves and shuts
    the server down, the follower replays and exits 0."""
    model = tmp_path / "boxes.xml"
    model.write_text(worlds.BOXES)
    port = _free_port()
    runs = _run_ranks([[sys.executable, "-m", "mujoco_ros_pkgs_tpu_torch.server.launch",
                        "--modelfile", str(model), "--nenv", "4", "--num-steps", "20",
                        "--device", "cpu", "--distributed", "--coordinator",
                        f"127.0.0.1:{port}", "--num-processes", "2", "--process-id",
                        str(pid)] for pid in range(2)])
    for pid, (rc, out) in enumerate(runs):
        assert rc == 0, f"process {pid} exited {rc}:\n{out[-4000:]}"
        assert "dtype float64 on cpu" in out
    assert "sim_time=0.040s steps=20" in runs[0][1]


def test_lonely_rank_fails_within_timeout(tmp_path):
    """A rank whose peer never comes fails at the group's timeout."""
    (rc, out), = _run_ranks([[sys.executable, WORKER, "lonely", "0", "2",
                              str(_free_port()), str(tmp_path)]], timeout=60)
    assert rc != 0 and worker.JOINED_MARK not in out, out[-2000:]


def test_host_env_mesh_rows_in_one_process():
    """Without a group, the rank's rows are the whole batch and the noise
    generator is a plain one's."""
    assert mh.process_count() == 1 and mh.local_rows(16) == (0, 16)
    gen = mh.env_rng(5, 16)
    plain = torch.Generator()
    plain.manual_seed(5)
    assert torch.equal(rng.randn((16, 3), gen, torch.float64, "cpu"),
                       torch.randn((16, 3), generator=plain, dtype=torch.float64))
