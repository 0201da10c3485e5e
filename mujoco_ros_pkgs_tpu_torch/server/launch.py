"""CLI entry point of the torch port's server (the reference's mujoco_node).

Usage:
    python -m mujoco_ros_pkgs_tpu_torch.server.launch --modelfile world.xml \
        --nenv 4096 --num-steps 1000 [--device cpu] [--config plugins.json] \
        [--realtime 0.5] [--ctrl-noise-std 0.05 --ctrl-noise-rate 0.1] \
        [--eval-mode --admin-hash H] [--pair-topk 24] [--con-topk 64]

Counterpart of mujoco_ros_pkgs_tpu/server/launch.py for what the port
serves: loads the model (waiting for the file with --wait-for-model),
the plugins and initial joint states of a --config file (JSON, or YAML where
pyyaml is installed: `MujocoPlugins`, a list of {type: sensors | mocap |
ros_control, ...} entries, as the reference's rosparam array,
plugin_utils.cpp:41-64; `initial_joint_positions`,
`initial_joint_velocities`), starts the physics-loop thread and prints
`sim_time=` lines to stderr about once a second and at the end. Exits 0
when --num-steps steps are done or on SIGINT, 1 when the physics loop died
(`FATAL: physics loop died`), 2 when the model fails to load.
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import sys
import time


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="mujoco_ros_pkgs_tpu_torch.server",
        description="batched MuJoCo-class simulation server (PyTorch/CUDA)")
    ap.add_argument("--modelfile", required=True,
                    help="MJCF path (or XML with --model-string)")
    ap.add_argument("--model-string", action="store_true",
                    help="treat --modelfile as literal XML")
    ap.add_argument("--wait-for-model", type=float, default=0.0, metavar="S",
                    help="wait up to S seconds for --modelfile to appear (the "
                         "reference's wait_for_xml, main.cpp:103-129); 0 = it must "
                         "exist")
    ap.add_argument("--nenv", type=int, default=1,
                    help="lockstep env instances (batch size)")
    ap.add_argument("--unpause", action="store_true", default=True,
                    help="start running (the default)")
    ap.add_argument("--no-unpause", dest="unpause", action="store_false",
                    help="start paused")
    ap.add_argument("--num-steps", type=int, default=-1,
                    help="terminate after N steps (-1 = run until SIGINT)")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the batch: cuda (the default) or cpu")
    ap.add_argument("--eval-mode", action="store_true",
                    help="every mutating call must give --admin-hash")
    ap.add_argument("--admin-hash", default="")
    ap.add_argument("--realtime", type=float, default=-1.0,
                    help="pace as a fraction of real time (-1 = unbound)")
    ap.add_argument("--ctrl-noise-std", type=float, default=0.0,
                    help="std of the Ornstein-Uhlenbeck noise on ctrl (0 = off)")
    ap.add_argument("--ctrl-noise-rate", type=float, default=0.0,
                    help="time constant of the ctrl noise, seconds")
    ap.add_argument("--config", default="",
                    help="JSON (or YAML) config: MujocoPlugins, "
                         "initial_joint_positions, initial_joint_velocities")
    ap.add_argument("--pair-topk", type=int, default=0,
                    help="broadphase compaction: narrowphase only the K most-"
                         "overlapping pairs of a large pair group (0 = off)")
    ap.add_argument("--con-topk", type=int, default=0,
                    help="active-contact compaction: the solver takes only the "
                         "K deepest contact slots of a cone group (0 = off)")
    ap.add_argument("--verbose", action="store_true", help="log at INFO")
    ap.add_argument("--log-level", default="",
                    help="per-subsystem log levels, e.g. 'server=debug' or a bare "
                         "default level like 'info'")
    return ap


def load_config(path: str) -> dict:
    if not path:
        return {}
    with open(path) as f:
        text = f.read()
    try:
        return json.loads(text)
    except json.JSONDecodeError:
        try:
            import yaml
        except ImportError:
            raise RuntimeError("config is not JSON and pyyaml is not installed")
        return yaml.safe_load(text)


def make_plugins(cfg: dict):
    """The plugins of a config's `MujocoPlugins` list, each built from its
    entry (plugin_utils.cpp:41-64)."""
    from mujoco_ros_pkgs_tpu_torch.plugins.mocap import MocapPlugin
    from mujoco_ros_pkgs_tpu_torch.plugins.ros_control import RosControlPlugin
    from mujoco_ros_pkgs_tpu_torch.plugins.sensors import SensorsPlugin
    types = {"mujoco_ros_sensors/MujocoRosSensorsPlugin": SensorsPlugin,
             "sensors": SensorsPlugin,
             "mujoco_ros_mocap/MocapPlugin": MocapPlugin, "mocap": MocapPlugin,
             "mujoco_ros_control/MujocoRosControlPlugin": RosControlPlugin,
             "ros_control": RosControlPlugin}
    out = []
    for entry in cfg.get("MujocoPlugins", []):
        ptype = entry.get("type", "")
        if ptype not in types:
            raise ValueError(f"unknown plugin type '{ptype}'")
        out.append(types[ptype](entry))
    return out


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    from mujoco_ros_pkgs_tpu_torch.utils import log as log_mod
    if args.log_level:
        if "=" in args.log_level:
            log_mod.configure(log_mod.parse_level_spec(args.log_level))
        else:
            log_mod.configure(default_level=args.log_level)
    else:
        log_mod.configure(default_level="INFO" if args.verbose else "WARNING")
    from mujoco_ros_pkgs_tpu_torch.server import MujocoServer

    cfg = load_config(args.config)
    model = args.modelfile
    if args.wait_for_model > 0 and not args.model_string:
        deadline = time.monotonic() + args.wait_for_model
        while not os.path.exists(model):
            if time.monotonic() >= deadline:
                print(f"model file '{model}' did not appear within "
                      f"{args.wait_for_model:.0f}s", file=sys.stderr)
                return 2
            time.sleep(0.1)
    try:
        srv = MujocoServer(
            model, nenv=args.nenv, device=args.device, eval_mode=args.eval_mode,
            admin_hash=args.admin_hash, unpause=args.unpause, num_steps=args.num_steps,
            realtime=args.realtime,
            initial_joint_states=cfg.get("initial_joint_positions", {}),
            initial_joint_velocities=cfg.get("initial_joint_velocities", {}),
            plugins=make_plugins(cfg), ctrl_noise_std=args.ctrl_noise_std,
            ctrl_noise_rate=args.ctrl_noise_rate,
            pair_topk=args.pair_topk, con_topk=args.con_topk)
    except (ValueError, NotImplementedError, SyntaxError, OSError) as exc:
        print(f"FATAL: model failed to load: {type(exc).__name__}: {exc}", file=sys.stderr)
        return 2
    stop = {"flag": False}

    def sigint(_sig, _frm):   # main.cpp:52-56 sets exit_request
        stop["flag"] = True
    signal.signal(signal.SIGINT, sigint)

    wall0 = time.perf_counter()
    t0 = srv.sim_time
    dt = float(srv.m.opt.timestep)

    def report():
        sim = srv.sim_time      # reads the device: waits for the steps in flight
        print(f"sim_time={sim:.3f}s steps={round((sim - t0) / dt)} "
              f"slowdown={sim / max(time.perf_counter() - wall0, 1e-9):.2f}x "
              f"paused={srv.paused}", file=sys.stderr, flush=True)

    srv.start_physics_loop()
    last = time.perf_counter()
    while (not stop["flag"] and srv.num_steps_until_exit != 0
           and srv.physics_error is None and srv._physics_thread is not None):
        time.sleep(0.05)
        if time.perf_counter() - last >= 1.0:
            last = time.perf_counter()
            report()
    srv.stop_physics_loop()
    report()
    if srv.physics_error is not None:
        print(f"FATAL: physics loop died: {srv.physics_error!r}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
