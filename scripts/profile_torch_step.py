"""Where the torch port's step time goes on the card.

    python scripts/profile_torch_step.py [--world PENDULUM] [--nenv 4096]
        [--steps 32] [--con-topk K] [--pair-topk K] [--ls-iterations N]

BASELINE config 5's PILE: `--world PILE --nenv 512 --con-topk 64
--ls-iterations 8` (and `--pair-topk 24` for its broadphase cell); its
humanoid bench: `--world HUMANOID --nenv 1024 --con-topk 48`.

`--world` names a world of models/worlds.py (BOXES, PENDULUM, PILE,
SENSORS, ARM7), models/humanoid.py (HUMANOID) or tests/torch_problems.py
(PANDA_PICK, TENDON_ACT, MUSCLE_ARM, SWIMMER). SENSORS is served with a
SensorsPlugin and bench_config3's three noise models (bench.py:160-189),
as BASELINE config 3 runs it, MUSCLE_ARM with a SensorsPlugin; ARM7 as BASELINE config 4 runs it
(bench.py:192-206): the weld on, bench_config4's ctrl, with a
MocapPlugin and a RosControlPlugin (POSITION_PID on j4-j6), the target
0.59 m from the end effector, as chip_smoke.py's phase 20 serves it;
PANDA_PICK as chip_smoke.py's phase 30b: each env at its seeded grasp pose
(tests/torch_problems.panda_states, set_qpos), the gripper open through
the warm-up steps and closed on the box for the timed ones.

Steps `MujocoServer(world, nenv, pair_topk=..., con_topk=...)` (on the
card; --ls-iterations replaces the model's line-search iterations) through
WARMUP steps,
times `steps` more without the profiler (wall clock to a synchronize), then
the same number under torch.profiler, and prints:

- wall ms/step, with and without the profiler;
- the device's busy share of the profiled window (union of kernel and copy
  intervals over the window's wall time);
- device time per step by kernel name (top 12), and the port's kernels;
- host time per step of each stage of the general path (smooth position,
  collision, the three sensor stages, the velocity stage's com_vel,
  passive (inside it the fluid forces) and rne, actuation, smooth
  acceleration, efc rows, solve, Euler or implicitfast (inside it the fluid
  forces' d / d qvel),
  inside the position stage the tendons and the transmission,
  inside them the broadphase's top-k (`_topk_pairs`) and the active-contact
  top-k (`_deepest`),
  the sensors plugin's last stage, the mocap and ros_control plugins'
  control hooks; record_function ranges wrapped around the stage functions by this script,
  not by the port);
- CUDA runtime calls per step (kernel launches, copies, synchronizations).

Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import functools
import json
import subprocess
import sys
import time
from pathlib import Path

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile, record_function

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from mujoco_ros_pkgs_tpu_torch.models import humanoid, worlds  # noqa: E402
from mujoco_ros_pkgs_tpu_torch.ops import collision, efc, narrowphase, sensor  # noqa: E402
from mujoco_ros_pkgs_tpu_torch.ops import smooth, solver  # noqa: E402
from mujoco_ros_pkgs_tpu_torch.ops import forward as fwd  # noqa: E402
from mujoco_ros_pkgs_tpu_torch.msgs import MocapState, Pose  # noqa: E402
from mujoco_ros_pkgs_tpu_torch.plugins.mocap import MocapPlugin  # noqa: E402
from mujoco_ros_pkgs_tpu_torch.plugins.ros_control import RosControlPlugin  # noqa: E402
from mujoco_ros_pkgs_tpu_torch.plugins.sensors import SensorsPlugin  # noqa: E402
from mujoco_ros_pkgs_tpu_torch.server import MujocoServer  # noqa: E402
_THREADS = torch.get_num_threads()
import tests.torch_problems as problems  # noqa: E402
from tests.torch_problems import ARM7_CTRL, SENSORS_NOISE  # noqa: E402

torch.set_num_threads(_THREADS)     # tests.torch_problems caps it for the CPU suite

WARMUP = 64
STAGES = ((smooth, "fwd_position_smooth"), (smooth, "tendon"), (smooth, "transmission"),
          (collision, "collide"),
          (narrowphase, "_topk_pairs"), (efc, "_deepest"),
          (sensor, "sensor_pos"), (smooth, "com_vel"), (smooth, "passive"),
          (smooth, "rne"),
          (sensor, "sensor_vel"), (smooth, "actuation"),
          (smooth, "fwd_acceleration_smooth"),
          (efc, "make_efc"), (solver, "solve"), (sensor, "sensor_acc"), (fwd, "euler"),
          (fwd, "implicitfast"), (fwd, "fluid_jacobian"), (smooth, "fluid_qfrc"),
          (SensorsPlugin, "last_stage"), (MocapPlugin, "control"),
          (RosControlPlugin, "control"))


def _label(mod, name):
    """A stage's label: the function's name, a plugin's hook with its class."""
    return f"{mod.__name__}.{name}" if isinstance(mod, type) else name


def _labelled(fn, label):
    @functools.wraps(fn)
    def run(*args, **kwargs):
        with record_function(label):
            return fn(*args, **kwargs)
    return run


def _device_us(evt) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def _on_device(evt) -> bool:
    """A kernel or copy on the card (not a record_function range)."""
    return evt.device_type == DeviceType.CUDA and not evt.is_user_annotation


def _busy_share(events, t0_us, t1_us) -> float:
    spans = sorted((e.time_range.start, e.time_range.end) for e in events
                   if _on_device(e))
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in spans:
        s, e = max(s, t0_us), min(e, t1_us)
        if e <= s:
            continue
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy / max(t1_us - t0_us, 1e-9)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--world", default="PENDULUM",
                    help="a name in models/worlds.py or models/humanoid.py")
    ap.add_argument("--nenv", type=int, default=4096)
    ap.add_argument("--steps", type=int, default=32)
    ap.add_argument("--con-topk", type=int, default=0,
                    help="active-contact compaction capacity (0 = off)")
    ap.add_argument("--pair-topk", type=int, default=0,
                    help="broadphase compaction capacity (0 = off)")
    ap.add_argument("--ls-iterations", type=int, default=0,
                    help="the model's line-search iterations (0 = the model's own)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("profile_torch_step: a CUDA card is required")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True, timeout=60).stdout.strip().splitlines()[0]
    for mod, name in STAGES:
        setattr(mod, name, _labelled(getattr(mod, name), f"stage:{_label(mod, name)}"))

    xml = (getattr(worlds, args.world, None) or getattr(humanoid, args.world, None)
           or getattr(problems, args.world, None))
    if not isinstance(xml, str):
        sys.exit(f"profile_torch_step: no world {args.world!r} in models/worlds.py, "
                 f"models/humanoid.py or tests/torch_problems.py")
    plugins = {"SENSORS": [SensorsPlugin()], "MUSCLE_ARM": [SensorsPlugin()],
               "ARM7": [MocapPlugin(), RosControlPlugin({"joints": {
                   j: {"method": "POSITION_PID", "pid": [20.0, 1.0, 0.5, 5.0],
                       "effort_limit": 20.0} for j in ("j4", "j5", "j6")}})]}
    srv = MujocoServer(xml, nenv=args.nenv, unpause=False,
                       plugins=plugins.get(args.world, ()),
                       pair_topk=args.pair_topk, con_topk=args.con_topk)
    if args.ls_iterations:
        srv.m.opt.ls_iterations = args.ls_iterations
    if args.world == "SENSORS":
        assert srv.register_noise_models(list(SENSORS_NOISE)).success
    if args.world == "ARM7":
        p = srv.get_eq_constraint_parameters("ee_target")
        p.active, p.anchor = True, [0.0, 0.0, 0.1]
        p.relpose = Pose([0.0, 0.0, 0.0], [1.0, 0.0, 0.0, 0.0])
        assert srv.set_eq_constraint_parameters(p).success
        assert srv.set_ctrl(ARM7_CTRL).success
        assert srv.set_mocap_state(MocapState(["mocap_target"],
                                              [Pose([0.35, 0.15, 0.85])])).success
    if args.world == "PANDA_PICK":
        qpos, _, ctrl = problems.panda_states(srv._m64, args.nenv, seed=22)
        qpos[:, 7:9] = 0.04
        for k in range(args.nenv):
            assert srv.set_qpos(qpos[k], env_id=k, zero_qvel=True).success
        assert srv.set_ctrl(ctrl[0]).success
    srv.step(WARMUP)
    if args.world == "PANDA_PICK":
        assert srv.set_ctrl(list(ctrl[0, :7]) + [problems.PANDA_CLOSED]).success
    torch.cuda.synchronize()
    t = time.perf_counter()
    srv.step(args.steps)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t) * 1e3 / args.steps

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function("window"):
            t = time.perf_counter()
            srv.step(args.steps)
            torch.cuda.synchronize()
            wall_prof = (time.perf_counter() - t) * 1e3 / args.steps
    events = prof.events()
    window = [e for e in events if e.name == "window"][0]
    share = _busy_share(events, window.time_range.start, window.time_range.end)
    n = args.steps

    kernels, host, runtime = {}, {}, {}
    for evt in events:
        if evt.name.startswith("stage:") and evt.device_type == DeviceType.CPU:
            host[evt.name[6:]] = host.get(evt.name[6:], 0.0) + (
                evt.time_range.end - evt.time_range.start) / 1e3 / n
    for evt in prof.key_averages():
        dev = _device_us(evt)
        if evt.key.startswith("cuda") and evt.count:
            runtime[evt.key] = evt.count / n
        if dev > 0 and _on_device(evt):
            kernels[evt.key] = (dev / 1e3 / n, evt.count / n)
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])
    dev_total = sum(v[0] for v in kernels.values())

    print(f"[profile] {args.world} nenv={args.nenv} pair_topk={args.pair_topk} "
          f"con_topk={args.con_topk} ls_iterations={srv.m.opt.ls_iterations} ({card}): "
          f"wall {wall:.4f} ms/step "
          f"without the profiler, {wall_prof:.4f} ms/step under it; device busy "
          f"share {share:.4f}; device time {dev_total:.4f} ms/step in "
          f"{sum(v[1] for v in kernels.values()):.1f} kernels and copies per step")
    for name, (ms, cnt) in top[:12]:
        print(f"[profile]   device {ms:.5f} ms/step x{cnt:.1f}  {name[:90]}")
    for name, (ms, cnt) in kernels.items():
        if "mrp::" in name:
            print(f"[profile]   port kernel {name[:60]}: {ms:.5f} ms/step x{cnt:.1f}")
    for mod, name in STAGES:
        if _label(mod, name) in host:
            print(f"[profile]   host stage {_label(mod, name)}: "
                  f"{host[_label(mod, name)]:.4f} ms/step")
    for name, cnt in sorted(runtime.items(), key=lambda kv: -kv[1])[:8]:
        print(f"[profile]   runtime {name}: {cnt:.1f} calls/step")
    print(json.dumps({"world": args.world, "nenv": args.nenv, "card": card,
                      "pair_topk": args.pair_topk, "con_topk": args.con_topk,
                      "ls_iterations": srv.m.opt.ls_iterations,
                      "wall_ms_per_step": wall, "wall_ms_per_step_profiled": wall_prof,
                      "device_busy_share": share, "device_ms_per_step": dev_total,
                      "host_stage_ms_per_step": host}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
