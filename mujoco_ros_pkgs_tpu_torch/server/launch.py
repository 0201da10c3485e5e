"""CLI entry point of the torch port's server.

Usage:
    python -m mujoco_ros_pkgs_tpu_torch.server.launch --modelfile world.xml \
        --nenv 4096 --num-steps 1000 [--device cpu] [--pair-topk 24] [--con-topk 64]

Loads the model, runs the batch unpaused until --num-steps steps are done
(or forever with -1, until SIGINT), and prints `sim_time=` lines to stderr
about once a second and at the end.
"""

from __future__ import annotations

import argparse
import signal
import sys
import time


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="mujoco_ros_pkgs_tpu_torch.server",
        description="batched MuJoCo-class simulation server (PyTorch/CUDA)")
    ap.add_argument("--modelfile", required=True, help="MJCF path")
    ap.add_argument("--nenv", type=int, default=1,
                    help="lockstep env instances (batch size)")
    ap.add_argument("--num-steps", type=int, default=-1,
                    help="terminate after N steps (-1 = run until SIGINT)")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the batch: cuda (the default) or cpu")
    ap.add_argument("--pair-topk", type=int, default=0,
                    help="broadphase compaction: narrowphase only the K most-"
                         "overlapping pairs of a large pair group (0 = off)")
    ap.add_argument("--con-topk", type=int, default=0,
                    help="active-contact compaction: the solver takes only the "
                         "K deepest contact slots of a cone group (0 = off)")
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    from mujoco_ros_pkgs_tpu_torch.server import MujocoServer

    srv = MujocoServer(args.modelfile, nenv=args.nenv, device=args.device,
                       unpause=True, num_steps=args.num_steps,
                       pair_topk=args.pair_topk, con_topk=args.con_topk)
    stop = {"flag": False}

    def sigint(_sig, _frm):
        stop["flag"] = True
    signal.signal(signal.SIGINT, sigint)

    wall0 = last = time.perf_counter()
    steps = 0
    while not stop["flag"] and srv.num_steps_until_exit != 0:
        steps += srv.tick()
        now = time.perf_counter()
        if now - last >= 1.0 or srv.num_steps_until_exit == 0:
            last = now
            sim = srv.sim_time      # reads the device: waits for the steps
            print(f"sim_time={sim:.3f}s steps={steps} "
                  f"slowdown={sim / max(time.perf_counter() - wall0, 1e-9):.2f}x "
                  f"paused={srv.paused}", file=sys.stderr, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
