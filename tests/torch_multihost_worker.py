"""One rank of a two-process run of the torch port over torch.distributed
(gloo, CPU, float64), for tests/test_torch_multihost.py (not a test module).

    python tests/torch_multihost_worker.py MODE PID NPROC PORT OUTDIR

Modes:
  boxes    BOXES at BOXES_NENV envs: make_global_batch from global env ids,
           shardmap_step_fn (nsub 5, the general route, with the consumer)
           driven by process 0's commands through HostCoordinator (STEP_N,
           PAUSE, RESUME, STEP_N, SHUTDOWN; the other ranks propose garbage);
           writes the commands observed, the consumer and the gathered state;
  sensors  a distributed MujocoServer of SENSORS_MOTOR with the sensors
           plugin and control noise at SENSORS_NENV envs: process 0 runs
           `sensors_sequence` (a Step action, set_body_state, set_ctrl, step,
           get_body_state, sensor_outputs, reset, step), the others
           serve_follower; writes the gathered state and every normal draw
           (utils/rng.randn) of this rank;
  lonely   joins a group of NPROC that no other process joins: it must fail
           within the group's timeout (5 s) and never print JOINED_MARK.

The single-process references (the same functions without a group) run in
the test's own process. Each rank's torch runs one thread.
"""

import json
import os
import sys
import threading

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from mujoco_ros_pkgs_tpu_torch.core import mjcf  # noqa: E402
from mujoco_ros_pkgs_tpu_torch.models import worlds  # noqa: E402
from mujoco_ros_pkgs_tpu_torch.msgs import BodyState, Pose, StepGoal, Twist  # noqa: E402
from mujoco_ros_pkgs_tpu_torch.ops import forward as fwd  # noqa: E402
from mujoco_ros_pkgs_tpu_torch.parallel import multihost as mh  # noqa: E402
from mujoco_ros_pkgs_tpu_torch.plugins.sensors import SensorsPlugin  # noqa: E402
from mujoco_ros_pkgs_tpu_torch.server import MujocoServer  # noqa: E402
from mujoco_ros_pkgs_tpu_torch.utils import rng  # noqa: E402
from tests.torch_problems import SENSORS_MOTOR, SENSORS_NOISE  # noqa: E402

BOXES_NENV = 16
SENSORS_NENV = 16
TIMEOUT_S = 60.0
# process 0's commands; the others propose (CMD_NOOP, -99), which must lose
SCRIPT = ((mh.CMD_STEP_N, 5.0), (mh.CMD_PAUSE, 0.0), (mh.CMD_RESUME, 0.0),
          (mh.CMD_STEP_N, 5.0), (mh.CMD_SHUTDOWN, 0.0))
FIELDS = ("qpos", "qvel", "qacc", "time")
JOINED_MARK = "lonely rank in its group"


def boxes_model():
    """BOXES in float64 on the CPU."""
    return mjcf.load_model_from_string(worlds.BOXES).to("cpu", torch.float64)


def boxes_init(d, global_idx):
    """The boxes in free flight, set from the global env ids alone: raised
    0.02 m an env (tests/multihost_worker.py's heights), spinning."""
    i = torch.as_tensor(global_idx, dtype=d.qpos.dtype)
    qpos, qvel = d.qpos.clone(), d.qvel.clone()
    qpos[:, 2] += 0.02 * i
    qvel[:, 0] = 0.3 * torch.cos(i)
    qvel[:, 3] = 2.0 * torch.sin(i)
    qvel[:, 4] = 1.5 * torch.cos(3 * i)
    qvel[:, 5] = torch.sin(2 * i)
    return d.replace(qpos=qpos, qvel=qvel)


def sensors_server(**kw):
    """SENSORS_MOTOR at SENSORS_NENV envs, float64 on the CPU, the sensors
    plugin and control noise."""
    return MujocoServer(SENSORS_MOTOR, nenv=SENSORS_NENV, device="cpu", dtype=torch.float64,
                        plugins=[SensorsPlugin({})], ctrl_noise_std=0.2,
                        ctrl_noise_rate=0.05, seed=5, **kw)


def sensors_sequence(srv) -> dict:
    """The service sequence (tests/multihost_server_worker.py's, with
    set_ctrl) on a server of SENSORS_MOTOR: the writes and reads of one env
    ask envs that the last rank holds."""
    n = srv.nenv
    assert srv.register_noise_models(list(SENSORS_NOISE)).success
    done, feedback = threading.Event(), []
    assert srv.step_action(StepGoal(num_steps=24),
                           feedback_cb=lambda f: feedback.append(f.steps_left),
                           done_cb=lambda r: done.set())
    assert done.wait(timeout=TIMEOUT_S)
    assert srv.set_body_state(BodyState(
        name="probe", pose=Pose([0.1, -0.2, 0.3], [1, 0, 0, 0]),
        twist=Twist([0.0, 0.2, 0.0], [0.0, 0.0, 1.0]))).success
    assert srv.set_ctrl([0.4], env_id=n - 4).success
    assert srv.step(8).success
    body = srv.get_body_state("probe", env_id=n - 3)
    noisy, gt = srv.sensor_outputs(env_id=n - 5)
    after = srv.get_batch_state()
    assert srv.reset().success
    assert srv.step(4).success
    return {"feedback": feedback, "body_pos": body.pose.position.tolist(),
            "body_lin": body.twist.linear.tolist(), "noisy": noisy.tolist(),
            "gt": gt.tolist(), "qpos_after": after["qpos"].tolist()}


def recording_draws():
    """Wrap utils/rng.randn so that every draw is kept (in order)."""
    draws, plain = [], rng.randn

    def randn(*a, **kw):
        out = plain(*a, **kw)
        draws.append(out.clone())
        return out
    rng.randn = randn
    return draws


def boxes(pid, nproc, outdir):
    m = boxes_model()
    mesh = mh.make_host_env_mesh(device="cpu")
    assert mesh.devices.shape == (nproc, 1), mesh.devices.shape
    d = mh.make_global_batch(m, BOXES_NENV, mesh, init_fn=boxes_init)
    step = mh.shardmap_step_fn(m, mesh, nsub=5, plan=fwd.GeneralPlan())
    coord = mh.HostCoordinator()
    observed, consumed, i = [], None, 0
    while True:
        cmd, arg = coord.next_command(*(SCRIPT[i] if pid == 0 else (mh.CMD_NOOP, -99.0)))
        observed.append((cmd, arg))
        if cmd == mh.CMD_STEP_N:
            d, consumed = step(d)
        elif cmd == mh.CMD_SHUTDOWN:
            break
        i += 1
    coord.barrier("final")
    assert coord.agree(m.nq)
    gathered = {f: mh.gather_to_host(getattr(d, f)) for f in FIELDS}
    assert torch.equal(mh.scatter_from_host(gathered["qpos"], mesh), d.qpos)
    np.savez(os.path.join(outdir, f"boxes_{pid}.npz"),
             consumed=consumed.numpy(), local_qpos=mh.local_shard_np(d.qpos), **gathered)
    with open(os.path.join(outdir, f"boxes_{pid}.json"), "w") as f:
        json.dump({"observed": observed}, f)


def sensors(pid, nproc, outdir):
    draws = recording_draws()
    srv = sensors_server(distributed=True)
    assert srv._rows == (pid * SENSORS_NENV // nproc, (pid + 1) * SENSORS_NENV // nproc)
    if pid == 0:
        out = sensors_sequence(srv)
        srv.shutdown()
    else:
        srv.serve_follower()
        out = {}
    ps = srv.pstates[0]
    state = {f: srv._np(getattr(srv.d, f)) for f in ("qpos", "qvel", "ctrl", "time")}
    state.update(noisy=srv._np(ps["noisy"]), gt=srv._np(ps["gt"]),
                 local_qpos=mh.local_shard_np(srv.d.qpos))
    np.savez(os.path.join(outdir, f"sensors_{pid}.npz"),
             generator=srv._generator.get_state().numpy(), **state,
             **{f"draw_{k}": t.numpy() for k, t in enumerate(draws)})
    with open(os.path.join(outdir, f"sensors_{pid}.json"), "w") as f:
        json.dump({"ndraws": len(draws), **out}, f)


def main():
    mode, pid, nproc, port, outdir = sys.argv[1], *map(int, sys.argv[2:5]), sys.argv[5]
    torch.set_num_threads(1)
    timeout = 5.0 if mode == "lonely" else TIMEOUT_S
    mh.initialize(f"127.0.0.1:{port}", nproc, pid, timeout_s=timeout)
    assert mh.process_count() == nproc and mh.process_index() == pid
    if mode == "lonely":
        print(JOINED_MARK, flush=True)
        return 0
    {"boxes": boxes, "sensors": sensors}[mode](pid, nproc, outdir)
    mh.shutdown()
    print(f"[rank {pid}] {mode} OK", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
