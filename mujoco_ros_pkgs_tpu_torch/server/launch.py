"""CLI entry point of the torch port's server (the reference's mujoco_node).

Usage:
    python -m mujoco_ros_pkgs_tpu_torch.server.launch --modelfile world.xml \
        --nenv 4096 --num-steps 1000 [--device cpu] [--config plugins.json] \
        [--realtime 0.5] [--ctrl-noise-std 0.05 --ctrl-noise-rate 0.1] \
        [--eval-mode --admin-hash H] [--pair-topk 24] [--con-topk 64] \
        [--png-dir frames/] [--watch-port 8080 [--watch-host 127.0.0.1]] \
        [--f32] [--profile-dir DIR] \
        [--distributed --coordinator 127.0.0.1:PORT --num-processes N --process-id K]

Counterpart of mujoco_ros_pkgs_tpu/server/launch.py for what the port
serves: loads the model (waiting for the file with --wait-for-model),
the plugins and initial joint states of a --config file (JSON, or YAML where
pyyaml is installed: `MujocoPlugins`, a list of {type: sensors | mocap |
ros_control, ...} entries, as the reference's rosparam array,
plugin_utils.cpp:41-64; `initial_joint_positions`,
`initial_joint_velocities`; `cam_config`, the camera streams as
MujocoServer takes them), writes every stream's frames as PNGs with
--png-dir, serves the live view with --watch-port (0: any free port; the
address is printed), starts the physics-loop thread and prints
`sim_time=` lines to stderr about once a second and at the end. Exits 0
when --num-steps steps are done or on SIGINT, 1 when the physics loop died
(`FATAL: physics loop died`), 2 when the model fails to load.

The batch is float64 on the CPU (as the JAX package's server) and float32
on the card, whose kernels take float32 only; --f32 asks for float32 on any
device, and the launcher says which on stderr. --profile-dir writes a
torch.profiler trace of the run (CPU and, on the card, CUDA activity) as
DIR/trace.json, a Chrome trace (chrome://tracing, Perfetto).

--distributed runs one process of a distributed server
(parallel/multihost.py): every process is started with the same arguments
and its own --process-id (or the MRT_COORDINATOR, MRT_NUM_PROCESSES and
MRT_PROCESS_ID variables); the batch of --nenv envs is split by process,
process 0 serves as above and originates every step and service, the
others replay them (`serve_follower`) and exit 0 when process 0 shuts the
server down. --mesh-hosts N splits a single process's batch into N host
rows, each stepped on its own.
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
                         "initial_joint_positions, initial_joint_velocities, "
                         "cam_config/<name>/{stream_type,frequency,width,height,"
                         "use_segid,env_ids,png_dir}")
    ap.add_argument("--png-dir", default="",
                    help="write every camera stream's frames as PNGs here (the "
                         "viewer's screenshot path, viewer.cpp:2231-2245)")
    ap.add_argument("--watch-port", type=int, default=-1,
                    help="serve a live HTTP view of env 0 with the viewer's "
                         "controls on this port (0 = any free port; needs a "
                         "model camera)")
    ap.add_argument("--watch-host", default="127.0.0.1",
                    help="the live view's bind address (loopback by default, as "
                         "the viewer's window is local; 0.0.0.0 exposes it)")
    ap.add_argument("--pair-topk", type=int, default=0,
                    help="broadphase compaction: narrowphase only the K most-"
                         "overlapping pairs of a large pair group (0 = off)")
    ap.add_argument("--con-topk", type=int, default=0,
                    help="active-contact compaction: the solver takes only the "
                         "K deepest contact slots of a cone group (0 = off)")
    ap.add_argument("--f32", action="store_true",
                    help="float32 on any device (default: float64 on the CPU, float32 "
                         "on the card)")
    ap.add_argument("--profile-dir", default="",
                    help="write a torch.profiler trace of the run to DIR/trace.json "
                         "(the reference's profile:=true hook, "
                         "launch_server.launch:93-95)")
    ap.add_argument("--distributed", action="store_true",
                    help="split the batch over the processes of a torch.distributed "
                         "group (parallel/multihost.py); process 0 originates every "
                         "service, the others replay them")
    ap.add_argument("--coordinator", default="",
                    help="the group's rendezvous host:port (also MRT_COORDINATOR)")
    ap.add_argument("--num-processes", type=int, default=0,
                    help="processes in the distributed run (also MRT_NUM_PROCESSES)")
    ap.add_argument("--process-id", type=int, default=-1,
                    help="this process's rank; 0 originates (also MRT_PROCESS_ID)")
    ap.add_argument("--mesh-hosts", type=int, default=0,
                    help="in one process, split the batch into N host rows, each "
                         "stepped on its own (testing without a second process)")
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
    import torch
    from mujoco_ros_pkgs_tpu_torch.parallel import multihost
    from mujoco_ros_pkgs_tpu_torch.server import MujocoServer

    if args.distributed:
        multihost.initialize(coordinator_address=args.coordinator or None,
                             num_processes=args.num_processes or None,
                             process_id=args.process_id if args.process_id >= 0 else None)
    on_card = torch.device(args.device).type == "cuda"
    dtype = torch.float32 if args.f32 or on_card else torch.float64
    print(f"dtype {str(dtype).replace('torch.', '')} on {args.device}"
          + ("" if args.f32 or not on_card else " (the card's kernels take float32 only)"),
          file=sys.stderr, flush=True)
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
    cam_config = dict(cfg.get("cam_config", {}))
    if args.png_dir:    # "*": applied to every camera
        cam_config["*"] = {**cam_config.get("*", {}), "png_dir": args.png_dir}
    try:
        srv = MujocoServer(
            model, nenv=args.nenv, device=args.device, eval_mode=args.eval_mode,
            admin_hash=args.admin_hash, unpause=args.unpause, num_steps=args.num_steps,
            realtime=args.realtime,
            initial_joint_states=cfg.get("initial_joint_positions", {}),
            initial_joint_velocities=cfg.get("initial_joint_velocities", {}),
            plugins=make_plugins(cfg), ctrl_noise_std=args.ctrl_noise_std,
            ctrl_noise_rate=args.ctrl_noise_rate,
            pair_topk=args.pair_topk, con_topk=args.con_topk, cam_config=cam_config,
            dtype=dtype, distributed=args.distributed, mesh_hosts=args.mesh_hosts or None)
    except (ValueError, NotImplementedError, SyntaxError, OSError) as exc:
        print(f"FATAL: model failed to load: {type(exc).__name__}: {exc}", file=sys.stderr)
        return 2
    try:
        if srv._multi and multihost.process_index() != 0:
            srv.serve_follower()      # until process 0 shuts the server down
            return 0
        return _serve(args, srv)
    finally:
        multihost.shutdown()


def _serve(args, srv) -> int:
    """Process 0's (or a single process's) run: the loop until --num-steps
    or SIGINT, the sim_time lines, the profile; a distributed server is shut
    down at the end, which ends the followers' replay."""
    import torch
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

    profiler = None
    if args.profile_dir:
        activities = [torch.profiler.ProfilerActivity.CPU]
        if srv.device.type == "cuda":
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        # the physics loop's thread is the one to see
        profiler = torch.profiler.profile(
            activities=activities,
            experimental_config=torch._C._profiler._ExperimentalConfig(profile_all_threads=True))
        profiler.start()
    if args.watch_port >= 0:
        res = srv.start_watch(port=args.watch_port, host=args.watch_host)
        print("live view: " + (f"http://{args.watch_host}:{res.status_message}/"
                               if res.success else res.status_message),
              file=sys.stderr, flush=True)
    srv.start_physics_loop()
    last = time.perf_counter()
    while (not stop["flag"] and srv.num_steps_until_exit != 0
           and srv.physics_error is None and srv._physics_thread is not None):
        time.sleep(0.05)
        if time.perf_counter() - last >= 1.0:
            last = time.perf_counter()
            report()
    srv.stop_physics_loop()
    if srv._watch is not None:
        srv.stop_watch()
    report()
    if profiler is not None:
        profiler.stop()
        os.makedirs(args.profile_dir, exist_ok=True)
        trace = os.path.join(args.profile_dir, "trace.json")
        profiler.export_chrome_trace(trace)
        print(f"profile: {trace}", file=sys.stderr, flush=True)
    if srv._multi:
        srv.shutdown()      # originated: ends the followers' replay
    if srv.physics_error is not None:
        print(f"FATAL: physics loop died: {srv.physics_error!r}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
