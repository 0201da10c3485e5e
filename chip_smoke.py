"""Smoke run of the torch port's main paths on one CUDA card.

    python3 chip_smoke.py

Phases (any failure raises; the exit code is then not 0):
  1. card: a CUDA device is required; prints the card's name and power limit
     (nvidia-smi) and turns TF32 off for the plain references' matmuls;
  2. build: compiles every kernel in mujoco_ros_pkgs_tpu_torch/csrc with
     nvcc for sm_90a, one nvcc per source, all started together; prints
     each kernel's registers, stack and spills, one line per instantiation
     (K2 and K3 once per group width G; K1's row kernel once per G and n,
     its block kernel once), and K1's block kernel's shared memory per
     block and envs per SM (the card's occupancy API) at n = 27, 72, 96;
     K1's kernels must use no stack;
  3. fused step (K3) vs plain: BOXES and BOXES with a damped free joint at
     4096 envs from seeded numpy states, 1 step (qpos rtol 1e-5 / atol 1e-6,
     qvel and qacc rtol 1e-4 / atol 1e-4) and 5 steps (qpos atol 1e-4);
  4. BOXES main path: MujocoServer(BOXES, nenv=4096, device="cuda") steps
     1000 times (timed: the server's env-steps/s), the boxes settle on the
     ground (z within 5e-4 of 0.1, speed below 1e-4), set_gravity + reset +
     step keep them floating, a bad reload fails and the server keeps
     answering; the launch counts, zeroed before, must count these steps;
  5. fused step timing: env-steps/s of the kernel and of the plain path at
     4096 and 65536 envs, 200 steps after warm-up, CUDA events; the Newton
     trips of those states (mean, max); K3's device time per call from
     CUDA-graph replay; K3 at every group width on BOXES and on one body
     with 3 and 5 boxes at 4096 and 65536 envs, each held against the plain
     step first, and its solver x against the float64 plain step at a
     bound derived from float64 (held_against_f64); on 3 and 5 boxes the
     envs whose x leaves the float32 budget and the SAVED_TOP envs farthest
     from float64 are saved to chip_smoke_out/k3_x_envs.npz (`python -m
     tests.test_torch_step_fused` runs the JAX package's kernel on them);
  6. Cholesky solve (K1) vs plain: seeded SPD batches (4096, n, n), n in
     {1, 6, 8, 11, 16, 17, 24, 27, 33, 72, 96} at the width
     kernels.psd_width picks (8 or 16 lanes, or the block kernel's
     threads; rtol 1e-4, atol 1e-5), and NaN above the diagonal must leave
     x as it was; K1, the plain version and torch.linalg.cholesky +
     torch.cholesky_solve (the yardstick, never called by the port) timed
     at 4096 envs, n = 11: one call at a time and by CUDA-graph replay (20
     calls a replay, and one); K1 by graph replay at every width that
     takes n (8 and 16 lanes per env, and the block kernel) at n = 6, 8,
     11, 16 and 4096 and 65536 envs, each width held against the plain
     version first, and the block kernel at n = 27, 72, 96;
  7. Newton solve (K2) vs plain: PENDULUM's own rows and those of a
     PENDULUM with two limited hinges (2 'lim' rows ahead of 33 contact
     rows) at 4096 envs from seeded states (qacc, qfrc, row forces at
     rtol/atol 1e-3) and synthetic
     rows of every kind (eq, fri, lim, condim 1/3/4/6) at nv 6, 11, 16 with
     up to 64 rows (rtol/atol 2e-3: both float32, and the solve stops at
     improved_est < tol * scale, where float32 and float64 already differ by
     up to 4e-4); at MuJoCo's default friction (nv 16, 64 rows) the final
     costs on the envs that converged within 32 trips (1e-3 of max(cost,
     1)), and which envs converge within 31 trips for K2, the plain version
     and the plain version in float64 (printed); K2 and the plain version
     timed on PENDULUM's rows (K2 one call at
     a time and by CUDA-graph replay), K2 at every group width;
  8. general path vs plain: 5 steps of PENDULUM at 4096 seeded envs through
     ops/forward.step with the kernels and with their plain versions (qpos
     rtol 1e-5 / atol 1e-6, qvel rtol/atol 1e-4, qacc rtol/atol 1e-3 after
     1 step; qpos atol 1e-4 after 5);
  9. PENDULUM main path: MujocoServer(PENDULUM, nenv=4096) on the default
     device steps 1000 times (timed), everything stays finite, the free ball
     settles on the ground, K1 and K2 each launch once per step; a damped
     PENDULUM steps 10 times (K1 twice per step: the mass matrix and Euler's
     damping solve); the general step's ms/step from CUDA events, with the
     kernels and with their plain versions;
 10. PILE vs plain: 512 seeded drops into the bin settled for 300 steps
     with the kernels (every pair group in contact in some env), then 1 and
     5 steps with the kernels and with their plain versions (phase 8's
     tolerances); K1 at n = 72 on the Hessians of one step's Newton trips,
     against the plain version and against float64;
 11. PILE main path: MujocoServer(PILE, nenv=512) on the default device
     steps PILE_STEPS times from the model's start: K1 launches once per
     step and once per Newton trip of the batch (the general Newton), K2
     and K3 never; everything finite, every body in the bin; env-steps/s,
     the Newton trips per env, host syncs per step; TF32 is off by default;
 12. PILE timing: ms/step at 512 and 4096 envs with the kernels and at 512
     with their plain versions; K1 at n = 72 by graph replay at 512 and 4096
     envs on PILE Hessians with its bound; K1 and
     torch.linalg.cholesky + cholesky_solve at n = 27, 72, 96;
 13. HUMANOID vs plain: 1024 seeded states (hinges past their limits,
     random ctrl) settled HUMANOID_SETTLE steps with the kernels (some
     contacts and some limit rows active), then 1 and 5 steps with the
     kernels and with their plain versions (phase 8's tolerances; qacc
     against the float64 step in units of phase 8's tolerance); K1 at
     n = 27 on every solve of one step (mass matrix, Newton Hessians,
     Euler's damping solve) against plain and against float64;
 14. HUMANOID main path: MujocoServer(HUMANOID, nenv=1024) on the default
     device, set_ctrl, HUMANOID_STEPS steps from the model's start: K1 twice
     per step (mass matrix, damping) and once per Newton trip of the batch,
     K2 and K3 never; finite, the motors' forces the clamped ctrl;
     env-steps/s and Newton trips per env;
 15. HUMANOID timing: fwd.step ms at 1024 and 4096 envs (and at 1024 with
     the plain versions); K1 at n = 27 on HUMANOID Hessians by graph replay
     with its bound, the plain version and cholesky + cholesky_solve;
 16. SENSORS vs plain (BASELINE config 3's scene: nv 7, 3 sites, 11
     sensors, 8 contact slots, 24 rows): 2048 seeded envs (the probe near
     the floor, in contact in most, its rangefinder hitting in some), 1 and
     5 steps with the kernels and with their plain versions: phase 8's
     tolerances for qpos and qvel, the position- and velocity-stage sensors
     at qvel's; qacc and the accelerometer, force and torque at rtol / atol
     1e-3, or, in envs past it, both held against the float64 step
     (held_against_f64); K1 at n = 7 on the mass matrix against plain;
 17. SENSORS main path: MujocoServer(SENSORS, nenv=2048) on the default
     device with a SensorsPlugin and bench_config3's three noise models
     steps SENSORS_STEPS times from the model's start (timed: env-steps/s):
     K1 and K2 once per step, K3 never; every reading finite, range -1 or
     positive, probe_pos the probe's xpos, the acc noise's mean within 4
     sigma / sqrt(N) of 0 and its std within 5% of 0.01 over all envs;
     reset keeps the noise models; an eval-mode plugin withholds the
     ground truth;
 18. SENSORS timing: fwd.step ms at 2048 envs with the kernels and with
     their plain versions; K1 at n = 7 on the mass matrix and K2 on the
     step's rows (held against plain first) by graph replay, one call at a
     time, plain, bound, and for K1 cholesky + cholesky_solve;
 19. ARM7 vs plain (BASELINE config 4's scene: nv 7, a mocap target and
     the `ee_target` weld, 4 position servos, 3 motors, 100 rows): 2048
     seeded envs (tests/torch_problems.arm7_states: the weld on in all but
     one, its target 0.1-0.3 m off, a hinge past a limit in each, every
     fourth env folded onto the floor, random ctrl), 1 and 5 steps with the
     kernels and with their plain versions: phase 8's tolerances for qpos
     and qvel, qacc at rtol / atol 1e-3 or, in envs past it, held against
     the float64 step; K1 launches 2 + the batch's Newton trips a step, K2
     and K3 none; K1 at n = 7 on every solve of one step against plain
     and float64, as phase 13;
 20. ARM7 main path: MujocoServer(ARM7, nenv=2048) on the default device
     with a MocapPlugin and a RosControlPlugin (POSITION_PID on j4-j6,
     commands set), the weld switched on by set_eq_constraint_parameters
     (anchored at the end-effector site), bench_config4's ctrl by set_ctrl,
     set_mocap_state moving the target (all envs, then env 0 apart):
     ARM7_STEPS steps (timed: env-steps/s): K1 2 + the batch's Newton
     trips a step, K2 and K3 never; finite; the site's distance to its
     target below 0.05 m after each move;
 21. ARM7 timing: fwd.step ms at 2048 envs with the kernels and with their
     plain versions; K1 at n = 7 on an ARM7 Newton Hessian by graph replay,
     one call at a time, plain, bound, cholesky + cholesky_solve.
 22. PILE at BASELINE config 5's settings (PILE5: ls_iterations 8) with
     con_topk=64, from phase 10's settled states: 192 solver rows (of 783),
     1 and 5 steps with the kernels against their plain versions (phase 8's
     tolerances), K1 1 + the batch's Newton trips a step, K2 and K3 none,
     one step against the uncompacted step (phase 8's tolerances); K1 on
     the compacted Hessians against plain and float64; the same with
     pair_topk=24 too (345 solver rows of 657);
 23. MujocoServer(PILE5, nenv=512, con_topk=64): COMPACT_STEPS steps from
     the model's start (timed), K1 1 + the batch's Newton trips a step;
 24. the same with pair_topk=24, one step(1) at a time with
     broadphase.candidate_overflow summed over every step (0 asserted);
 25. PILE5 dropped as bench.py's config5_settling (con_topk=64, 512 envs):
     SETTLE_STEPS server steps of the transient, the most active slots of
     any env printed, every body in the bin; one step of the transient
     against the plain versions;
 26. HUMANOID con_topk=48 from phase 13's settled states: 165 solver rows
     (of 408), as phase 22 (qacc held as phase 13's), and its server at
     1024 envs (K1 2 + the batch's trips a step); then 17 of PILE's bodies
     (nv 102) at 256 seeded heaps settled WIDE_SETTLE steps: every solve the
     library Cholesky's, K1 0, one float32 step against float64, psd_solve
     refusing n = 102;
 27. ROADMAP C7 and C7b: K1 against float64 on every solve of one step of
     HUMANOID's (the block kernel), ARM7's, SENSORS's and PENDULUM's (the
     row kernel) seeded states over C7_SEEDS: K1's worst env and its ratio
     to plain's, printed with the largest, which must be within
     WORST_FACTOR; the solves past it, and each world and seed's solve
     that K1 misses most (beyond one unit), saved to
     chip_smoke_out/k1_c7_envs.npz first for the JAX kernel (`python -m
     tests.test_torch_linalg`, on the CPU).
 28. the server's control plane: (a) ARM7 at ARM7_NENV envs from the CLI
     (`python -m mujoco_ros_pkgs_tpu_torch.server.launch`) with a --config
     of phase 20's mocap and ros_control plugins and control noise, for
     CLI_STEPS steps: exit 0, sim_time lines that advance to CLI_STEPS dt;
     (b) phase 20's server on the physics-loop thread, unbound for
     LOOP_SECONDS beside a thread calling set_mocap_state, set_ctrl,
     get_body_state and get_solver_stats (no error, finite, K1 2 + the
     batch's trips a step; env-steps/s), then paced at half its slowdown
     (measured within 10%), then paused and a Step action of 200 steps
     preempted after its first feedback (success False, whole chunks);
     (c) BOXES at 4096 envs on K3: after each model edit (options,
     friction and size, mass) one server step against the edited model's
     plain step at phase 3's tolerances with one more K3 launch, a
     pyramidal cone on the general route, a wrench on the general route
     (delta qvel = F / m dt at phase 8's tolerances) and K3 again once
     cleared; (d) a checkpoint of phase 20's server with control noise:
     the resumed CKPT_STEPS steps against the first, bit for bit or at
     phase 8's qpos tolerance, the largest difference printed.
Prints a JSON line of kernel results (`ms`: one call at a time, CUDA
events over back-to-back calls; `graph_ms`: CUDA-graph replays of 20 calls,
the device time alone; `group`: the width the main path runs; K1's `pile`,
`humanoid`, `sensors` and `arm7` objects and K2's `sensors` object: their
runs on those worlds' main paths; `arm7` also holds phase 28's loop, CLI
and checkpoint figures, with the loop's K1 launches), then the card line, then {"ok": true, "device":
{...}} as the last line. The width
sweeps launch through the kernels' own wrappers with the width rule
(group_width, psd_width) forced.
"""

import contextlib
import ctypes
import dataclasses
import json
import os
import re
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch

from mujoco_ros_pkgs_tpu_torch import kernels
from mujoco_ros_pkgs_tpu_torch.core import mjcf
from mujoco_ros_pkgs_tpu_torch.models import worlds
from mujoco_ros_pkgs_tpu_torch.models.humanoid import HUMANOID
from mujoco_ros_pkgs_tpu_torch.ops import broadphase, collision, efc, narrowphase
from mujoco_ros_pkgs_tpu_torch.ops import forward as fwd
from mujoco_ros_pkgs_tpu_torch.ops import linalg_tpu, smooth, solver, solver_tpu, step_tpu
from mujoco_ros_pkgs_tpu_torch.msgs import MocapState, Pose
from mujoco_ros_pkgs_tpu_torch.plugins.mocap import MocapPlugin
from mujoco_ros_pkgs_tpu_torch.plugins.ros_control import RosControlPlugin
from mujoco_ros_pkgs_tpu_torch.plugins.sensors import SensorsPlugin
from mujoco_ros_pkgs_tpu_torch.server import MujocoServer

_THREADS = torch.get_num_threads()
from tests.torch_problems import (ARM7_CTRL, BOXES_DAMPED, DEFAULT_FRICTION, FULL_BASE,
                                  FULL_KINDS, MIXED_BASE, MIXED_KINDS, PENDULUM_LIMITED,
                                  PILE17, SENSORS_NOISE, SENSORS_POS_VEL, arm7_states,
                                  box_cluster, humanoid_states, pile_heap, random_problem,
                                  sensors_states, solve_cost)

torch.set_num_threads(_THREADS)     # tests.torch_problems caps it for the CPU suite

PENDULUM_DAMPED = (worlds.PENDULUM
                   .replace('type="ball" pos="0 0 1"/>',
                            'type="ball" pos="0 0 1" damping="0.2" stiffness="1.5"/>')
                   .replace('pos="0 0 0.6" axis="0 1 0"/>',
                            'pos="0 0 0.6" axis="0 1 0" damping="0.1" stiffness="2"/>')
                   .replace('<freejoint/>', '<joint type="free" damping="0.01"/>'))
NENV = 4096
# the PILE server's steps (phase 11), about 30 s of the card's time
PILE_STEPS = 300
# HUMANOID's batch (BASELINE's humanoid bench: bench.py NENV // 4), the steps
# that settle its seeded states (the feet reach the floor after some 50) and
# the server's steps (phase 14)
HUMANOID_NENV = 1024
HUMANOID_SETTLE = 80
HUMANOID_STEPS = 150
# SENSORS (BASELINE config 3, which bench.py:160-189 runs at NENV // 2 envs
# with tests/torch_problems.SENSORS_NOISE) and its server's steps (phase 17)
SENSORS_NENV = 2048
SENSORS_STEPS = 300
# ARM7 (BASELINE config 4, which bench.py:192-206 runs at NENV // 2 envs with
# the weld on) and its server's steps (phase 20)
ARM7_NENV = 2048
ARM7_STEPS = 500
# BASELINE config 5 (bench.py:210-237): PILE at 512 envs, Newton iterations
# 12, ls_iterations 8, con_topk 64 (and pair_topk 24 in its broadphase cell);
# the compacted servers' steps (phases 23, 24) and the settling transient's
# (phase 25); HUMANOID's con_topk (bench.py:239-247)
PILE5 = worlds.PILE.replace('iterations="12"', 'iterations="12" ls_iterations="8"')
PILE_NENV = 512
# the nv = 102 world's batch and the steps that settle its heaps (phase 26)
WIDE_NENV = 256
WIDE_SETTLE = 60
COMPACT_STEPS = 150
SETTLE_STEPS = 150
HUMANOID_CON_TOPK = 48
# the seeds of ROADMAP C7's K1 float64 margins (phase 27)
C7_SEEDS = (1, 2, 3, 4, 6)
# the server's control plane (phase 28): the CLI's steps, the physics loop's
# seconds unbound and paced, a checkpoint's continuation
CLI_STEPS = 300
LOOP_SECONDS = 10
CKPT_STEPS = 50
# the card's published peaks (H100 SXM): HBM bytes/s, float32 and float64
# FLOP/s outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
F64_FLOPS = 34e12
KERNELS = (kernels.step_fused, kernels.psd_solve, kernels.newton_solve)
# a float32 result's worst env against float64, as a multiple of the plain
# float32 version's worst (held_against_f64). For K3, from the JAX package's
# kernel on the same states (`python -m tests.test_torch_step_fused`, on the
# CPU): its own worst env reaches 1.53 times the plain float32 step's (5
# boxes, 65536 envs), and on one env the two float32 readings differ by up
# to 2.85 times where both miss float64 by more than a unit; 2 lies between.
WORST_FACTOR = 2.0
# envs saved per shape, for the JAX kernel's reading of the same states
SAVED_TOP = 8


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def build_lines(log):
    """One line per kernel from nvcc's -Xptxas -v output: its name, template
    arguments (K2 and K3: G; K1's row kernel: G and n), registers, stack
    and spill stores."""
    out, name, stack = [], None, ""
    for line in log.splitlines():
        found = re.search(r"Compiling entry function '\w*?\d+([a-z_]+_kernel)"
                          r"(?:ILi(\d+)E(?:Li(\d+)E)?)?", line)
        if found:
            name = found.group(1) + "".join(
                f" {k}={v}" for k, v in zip(("G", "n"), found.group(2, 3)) if v)
        elif "stack frame" in line:
            stack = line.strip()
        elif "registers" in line and name:
            regs = re.search(r"Used (\d+) registers", line).group(1)
            out.append(f"{name}: {regs} registers; {stack}")
            name, stack = None, ""
    return out


def block_occupancy(card):
    """K1's block kernel: shared memory per block (the launch's size) and
    envs per SM by the card's occupancy API, at n = 27, 72, 96."""
    per_sm = ctypes.CDLL(str(kernels.library_path("linalg"))).psd_block_per_sm
    per_sm.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    for n in (27, 72, 96):
        smem = ctypes.c_int(0)
        envs = per_sm(n, ctypes.byref(smem))
        assert envs > 0, f"occupancy query at n={n}: {envs}"
        print(f"[build] psd_block_kernel n={n}: {smem.value} bytes of shared memory per "
              f"block; {envs} envs per SM at {kernels.PSD_BLOCK_THREADS} threads ({card})",
              flush=True)


def zero_counts():
    for k in KERNELS:
        k.launches = 0


@contextlib.contextmanager
def forced_width(group, rule="group_width"):
    """Make the width rule kernels.<rule> (group_width of K2 and K3,
    psd_width of K1) answer `group` (the width sweeps; the port never does
    this)."""
    saved = getattr(kernels, rule)
    setattr(kernels, rule, lambda *args, **kw: group)
    try:
        yield
    finally:
        setattr(kernels, rule, saved)


def states(nenv, seed, device="cuda"):
    """Seeded BOXES states near the ground: heights, tilts and velocities."""
    rng = np.random.default_rng(seed)
    qpos = np.zeros((nenv, 7), np.float32)
    qpos[:, 2] = 0.2 + 0.25 * rng.uniform(size=nenv) - 0.05
    quat = rng.normal(size=(nenv, 4)) * 0.2
    quat[:, 0] += 1.0
    qpos[:, 3:] = quat / np.linalg.norm(quat, axis=1, keepdims=True)
    qvel = (0.6 * rng.normal(size=(nenv, 6))).astype(np.float32)
    ws = (0.5 * rng.normal(size=(nenv, 6))).astype(np.float32)
    return tuple(torch.from_numpy(a).to(device) for a in (qpos, qvel, ws))


def close(name, a, b, rtol, atol):
    """assert_close that also returns the max abs error."""
    torch.testing.assert_close(a, b, rtol=rtol, atol=atol, msg=lambda m: f"{name}: {m}")
    return float((a - b).abs().max())


def kernel_vs_plain(xml, label):
    m = mjcf.load_model_from_string(xml, dtype=torch.float32).to("cuda")
    plan = fwd.make_plan(m)
    qpos, qvel, ws = states(NENV, seed=0)
    kq, kv, kx = qpos, qvel, ws
    pq, pv, px = qpos, qvel, ws
    before = kernels.step_fused.launches
    errs = {}
    for k in range(5):
        kq, kv, kx = step_tpu.step_batched(m, kq, kv, kx, plan)
        pq, pv, px = step_tpu.step_batched_plain(m, pq, pv, px, plan.params, plan.idx)
        torch.cuda.synchronize()
        if k == 0:
            errs["qpos_1"] = close(f"{label} qpos 1 step", kq, pq, 1e-5, 1e-6)
            errs["qvel_1"] = close(f"{label} qvel 1 step", kv, pv, 1e-4, 1e-4)
            errs["qacc_1"] = close(f"{label} qacc 1 step", kx, px, 1e-4, 1e-4)
    errs["qpos_5"] = close(f"{label} qpos 5 steps", kq, pq, 0.0, 1e-4)
    assert kernels.step_fused.launches == before + 5, "kernel launches not counted"
    assert torch.isfinite(kq).all() and torch.isfinite(kv).all()
    print(f"[kernel vs plain] {label} nenv={NENV}: " + " ".join(
        f"{k}={v:.3e}" for k, v in errs.items()), flush=True)
    return max(errs.values())


def main_path():
    zero_counts()
    t0 = time.perf_counter()
    srv = MujocoServer(worlds.BOXES, nenv=NENV, device="cuda", unpause=False)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    assert srv.step(1000).success
    torch.cuda.synchronize()
    t_step = time.perf_counter() - t1
    st = srv.get_batch_state()
    assert st["qpos"].shape == (NENV, 7) and np.isfinite(st["qpos"]).all()
    assert np.isfinite(st["qvel"]).all()
    seen = {}
    for env in (0, NENV - 1):
        b = srv.get_body_state("box", env_id=env)
        z, speed = float(b.pose.position[2]), float(np.linalg.norm(b.twist.linear))
        seen[env] = (z, speed)
        # measured on an H100: z = 0.099892 (soft-contact penetration
        # 1.1e-4) and speed 9.7e-7; bounds keep a 4x and 100x margin
        assert abs(z - 0.1) < 5e-4, f"env {env}: z={z} not settled near 0.1"
        assert speed < 1e-4, f"env {env}: speed {speed} after 1000 steps"
    z_all = st["qpos"][:, 2]
    print(f"[main path] server step(1000) of {NENV} envs: {t_step:.3f}s wall, "
          f"{NENV * 1000 / t_step:.4g} env-steps/s", flush=True)
    print(f"[main path] 1000 steps of {NENV} envs: z env0={seen[0][0]:.6f} "
          f"speed={seen[0][1]:.3e}; z env{NENV - 1}={seen[NENV - 1][0]:.6f} "
          f"speed={seen[NENV - 1][1]:.3e}; z over envs min={z_all.min():.6f} "
          f"max={z_all.max():.6f}; max |qvel|={np.abs(st['qvel']).max():.3e}",
          flush=True)
    assert srv.set_gravity((0.0, 0.0, 0.0)).success
    assert srv.reset().success
    assert srv.step(10).success
    zg = srv.get_batch_state()["qpos"][:, 2]
    assert np.abs(zg - 0.2).max() < 1e-6, f"zero gravity: z moved to {zg.min()}..{zg.max()}"
    bad = srv.reload("<mujoco><bad")
    assert not bad.success
    assert srv.get_body_state("box", env_id=0).pose.position[2] == zg[0]
    launches = kernels.step_fused.launches
    assert launches == 1010, f"main path launched the kernel {launches} times"
    print(f"[main path] zero-gravity z max dev={np.abs(zg - 0.2).max():.3e}; "
          f"bad reload: {bad.status_message[:60]!r}; kernel launches={launches}; "
          f"phase {time.perf_counter() - t0:.1f}s", flush=True)
    return launches


def time_steps(fn, qpos, qvel, ws, nsteps, warmup):
    for _ in range(warmup):
        qpos, qvel, ws = fn(qpos, qvel, ws)
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(nsteps):
        qpos, qvel, ws = fn(qpos, qvel, ws)
    e1.record()
    torch.cuda.synchronize()
    assert torch.isfinite(qpos).all()
    return e0.elapsed_time(e1) / nsteps


def timing(card):
    m = mjcf.load_model_from_string(worlds.BOXES, dtype=torch.float32).to("cuda")
    plan = fwd.make_plan(m)

    def kernel(q, v, w):
        return step_tpu.step_batched(m, q, v, w, plan)

    def plain(q, v, w):
        return step_tpu.step_batched_plain(m, q, v, w, plan.params, plan.idx)

    out = {}
    for nenv in (NENV, 65536):
        for name, fn, warm in (("kernel", kernel, 20), ("plain", plain, 3)):
            ms = time_steps(fn, *states(nenv, seed=1), nsteps=200, warmup=warm)
            out[(name, nenv)] = ms
            print(f"[timing] {name} nenv={nenv}: {ms:.4f} ms/step, "
                  f"{nenv / ms * 1e3:.4g} env-steps/s ({card})", flush=True)
    qpos, qvel, _ = states(NENV, seed=1)
    pr = step_tpu._problem(m, qpos, qvel, plan.params, plan.idx)
    trips = []
    niter, nls = solver_tpu.trip_counts(m)
    solver_tpu.newton_tiles(6, ("con",) * pr.J.shape[-2], pr.con_base, niter, nls,
                            True, plan.params[plan.idx["tol"][0]], pr.J, pr.aref, pr.D,
                            torch.zeros_like(pr.D), pr.act, pr.mu, pr.M, pr.a_s,
                            torch.zeros_like(qvel), trips=trips)
    dims = [dim for _, dim in pr.con_base]
    flops = float(sum(newton_flops(6, pr.J.shape[-2], dims, nls, int(t))
                      for t in trips[0].tolist())) + NENV * 3000.0
    out["bound"] = bound(NENV * 38 * 4, flops)
    out["group"] = kernels.group_width(6, *plan.rows, NENV)
    q, v, w = states(NENV, seed=1)
    out["graph_ms"] = graph_ms(
        lambda: kernels.step_fused(plan.meta, plan.params, q, v, w, plan.rows), 100)
    print(f"[timing] K3 nenv={NENV}: {out['graph_ms']:.4f} ms per call by graph replay "
          f"(the first step of these states) ({card})", flush=True)
    t = trips[0].float()
    print(f"[timing] K3 states nenv={NENV}: Newton trips mean {float(t.mean()):.3f} max "
          f"{int(t.max())} (first step, plain version)", flush=True)

    out["widths"], out["saved"] = {}, {}
    for xml, label in ((worlds.BOXES, "BOXES"), (box_cluster(3), "3 boxes"),
                       (box_cluster(5), "5 boxes")):
        for nenv in (NENV, 65536):
            out["widths"][(label, nenv)] = k3_widths(card, xml, label, nenv, out["saved"])
    return out


def k3_widths(card, xml, label, nenv, saved):
    """K3 at every group width on the timing states of one world (ms/step
    over 200 steps), each width held against the plain step first: qpos and
    qvel at the tolerances of kernel_vs_plain, and the solver's x against
    the float64 plain step by held_against_f64 at every shape, in units of
    1e-4 + 1e-4 |x64|.

    x against the float32 plain step: 1e-4 + 1e-4 |x| on BOXES, where it is
    held; on more rows also plus twice the plain version's float32-vs-
    float64 gap, element by element, held at 4096 envs and printed at
    65536. On 3 and 5 boxes at 65536 envs the plain version in float32
    misses float64 by up to 2.922 and 13.912 times 1e-4 + 1e-4 |x| (an
    H100), and K3 and the JAX package's kernel land as far from it on
    other envs (`python -m tests.test_torch_step_fused`): float32 rounding
    in ill-conditioned solves, whose x reaches 1700. On 3 and 5 boxes the
    envs past that budget and the SAVED_TOP envs farthest from float64 of
    K3 and of the plain step go into `saved` (for
    chip_smoke_out/k3_x_envs.npz)."""
    m = mjcf.load_model_from_string(xml, dtype=torch.float32).to("cuda")
    plan = fwd.make_plan(m)
    rule = kernels.group_width(6, *plan.rows, nenv)
    q, v, w = states(nenv, seed=1)
    want = step_tpu.step_batched_plain(m, q, v, w, plan.params, plan.idx)
    m64 = mjcf.load_model_from_string(xml, dtype=torch.float64).to("cuda")
    plan64 = fwd.make_plan(m64)
    x64 = step_tpu.step_batched_plain(m64, q.double(), v.double(), w.double(),
                                      plan64.params, plan64.idx)[2]
    hold_x = xml == worlds.BOXES or nenv == NENV
    budget = 1e-4 + 1e-4 * want[2].abs()
    if xml != worlds.BOXES:
        gap = (x64 - want[2].double()).abs().float()
        print(f"[timing] K3 {label}: plain float32 vs float64 x, max share of the "
              f"1e-4 + 1e-4 |x| budget {float((gap / budget).max()):.3f}", flush=True)
        budget = budget + 2 * gap
    unit = 1e-4 + 1e-4 * x64.abs()
    out = {}

    def step(q, v, w):
        return kernels.step_fused(plan.meta, plan.params, q, v, w, plan.rows)

    for g in kernels.GROUP_WIDTHS:
        with forced_width(g):
            got = step(q, v, w)
            close(f"K3 {label} G={g} qpos", got[0], want[0], 1e-5, 1e-6)
            close(f"K3 {label} G={g} qvel", got[1], want[1], 1e-4, 1e-4)
            held = held_against_f64(f"K3 {label} G={g} x", got[2], want[2], x64, unit)
            over = ((got[2] - want[2]).abs() / budget).amax(-1)
            assert float(over.max()) <= 1.0 or not hold_x, \
                f"K3 {label} G={g} x: {float(over.max()):.3f} of its budget"
            if xml != worlds.BOXES:
                # the envs past the float32 budget and each float32 x's
                # SAVED_TOP envs farthest from float64
                e_k3, e_p32 = held[4], held[5]
                idx = torch.cat([torch.nonzero(over > 1.0).flatten(),
                                 e_k3.topk(SAVED_TOP).indices, e_p32.topk(SAVED_TOP).indices])
                idx = torch.unique(idx)
                key = f"{label.replace(' ', '')}_n{nenv}_g{g}"
                saved[key + "_idx"] = idx.cpu().numpy()
                # plain float32's worst env, K3's, their 99th percentiles
                saved[key + "_stats"] = np.array(held[:4])
                for name, a in (("q", q), ("v", v), ("w", w), ("k3", got[2]),
                                ("p32", want[2]), ("p64", x64)):
                    saved[f"{key}_{name}"] = a[idx].cpu().numpy()
            out[g] = time_steps(step, q, v, w, nsteps=200, warmup=20)
        print(f"[timing] K3 {label} rows={plan.rows[0]} G={g}{' (rule)' if g == rule else ''} "
              f"nenv={nenv}: {out[g]:.4f} ms/step; x against float64, worst env "
              f"{held[1]:.3f}, 99th percentile {held[3]:.3f} (plain float32: {held[0]:.3f}, "
              f"{held[2]:.3f}); against float32 plain at "
              f"{float(over.max()):.3f} of its budget, {int((over > 1).sum())} envs past it"
              f"{'' if hold_x else ' (printed, not held)'} ({card})", flush=True)
    return out


def held_against_f64(name, got, plain, x64, unit):
    """Hold a float32 result against the float64 one where float32 itself
    cannot do better: each env's error is its largest |x - x64| / unit.
    got passes where its errors are within 1, or follow the plain version's
    in float32 on the same inputs (another order of the same sums): its
    99th-percentile env within twice the plain version's, its worst env
    within WORST_FACTOR times the plain version's worst. Returns (the plain
    version's worst, got's worst, the plain version's 99th percentile,
    got's, got's errors per env, the plain version's)."""
    def errors(x):
        return ((x.double() - x64).abs() / unit).amax(-1).float()
    e_got, e_plain = errors(got), errors(plain)
    q_got, q_plain = (float(torch.quantile(e, 0.99)) for e in (e_got, e_plain))
    worst, worst_plain = float(e_got.max()), float(e_plain.max())
    assert q_got <= max(2 * q_plain, 1.0), \
        f"{name}: 99th percentile {q_got:.3f} against the plain version's {q_plain:.3f}"
    assert worst <= max(WORST_FACTOR * worst_plain, 1.0), \
        f"{name}: worst {worst:.3f} against the plain version's {worst_plain:.3f}"
    return worst_plain, worst, q_plain, q_got, e_got, e_plain


# ---------------------------------------------------------------------------
# bounds: the least time the card could take for the same work
# ---------------------------------------------------------------------------

def bound(nbytes, flops):
    """(bound_ms, bound_by): the larger of bytes over HBM bandwidth and
    float32 operations over the float32 peak."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def newton_flops(nv, nefc, cone_dims, nls, trips):
    """Operations (a multiply-add counts 2) of one env's Newton solve, counted
    from the code of newton_tiles / csrc/solver.cuh for `trips` Newton trips:
    the warmstart's two cost evaluations and the scale, per trip the row
    forces with Hessian blocks, the gradient, W J, H = M + J^T W J, the
    Cholesky solve, J dx and M dx, 7 grid and nls polish evaluations of
    phi', then the final row forces."""
    cones = [d for d in cone_dims if d > 1]
    forces = 12 * nefc + sum(40 for _ in cones)
    forces_w = forces + sum(4 * d * d for d in cones)
    cost = 2 * nv * nv + 2 * nefc * nv + forces
    trip = (2 * nefc * nv + forces_w + 2 * nv * nv + 2 * nefc * nv
            + 2 * nefc * nv + sum(2 * d * d * nv for d in cones)
            + nv * (nv + 1) * nefc + nv ** 3 / 3 + 2 * nv * nv
            + 2 * nefc * nv + 2 * nv * nv + 8 * nv
            + 7 * (4 * nefc + forces)
            + nls * (6 * nefc + forces_w + sum(2 * d * d for d in cones)))
    return 2 * cost + 2 * nv * nv + trips * trip + 2 * nefc * nv + forces


def graph_ms(fn, iters, calls=20):
    """Mean device ms of one fn() call, CUDA events over replays of a CUDA
    graph that holds `calls` calls back to back (after warm-up calls),
    iters calls in all: the kernel's own time. A replay of a graph of one
    call takes no less than the host's interval between two graph
    launches, which is longer than a short kernel and moves with the
    host's load, so K1 at n <= 16 and 4096 envs needs many calls per
    replay."""
    calls = min(calls, iters)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(iters // calls):
        graph.replay()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / (iters // calls * calls)


def time_ms(fn, iters, warmup=3):
    """Mean ms of fn() over iters calls after warmup calls, CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(iters):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / iters


# ---------------------------------------------------------------------------
# K1: the batched Cholesky solve
# ---------------------------------------------------------------------------

def spd_batch(nenv, n, seed):
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(nenv, n, n)).astype(np.float32)
    H = A @ A.transpose(0, 2, 1) / n + np.eye(n, dtype=np.float32)
    g = rng.normal(size=(nenv, n)).astype(np.float32)
    return torch.from_numpy(H).cuda(), torch.from_numpy(g).cuda()


def library_solve(H, g):
    """One PyTorch call chain computing the same function (the yardstick)."""
    return torch.cholesky_solve(g[..., None], torch.linalg.cholesky(H))[..., 0]


def k1_bound(nenv, n):
    """K1's bound: H's lower triangle (all the function reads of H) and g
    read and x written once, n (n + 1) / 2 + 2 n floats per env; n^3 / 3 + 2
    n^2 float32 operations per env (the factorisation's n^3 / 6
    multiply-adds and the substitutions' n^2, a multiply-add counting 2),
    the refinement step's second pair of substitutions (2 n^2 more) and its
    float64 residual (2 n^2 float64 operations, at the card's float64 peak
    outside the tensor cores)."""
    f32, f64 = n ** 3 / 3 + 4 * n * n, 2 * n * n
    return bound(nenv * (n * (n + 1) // 2 + 2 * n) * 4,
                 nenv * (f32 + f64 * F32_FLOPS / F64_FLOPS))


def k1_phase(card):
    """K1 at the rule's width against the plain version at every n the
    port's kernels take a distinct path for, with NaN above the diagonal
    leaving x as it was; timed at n = 11; then every width at n = 6, 8, 11,
    16 (4096 and 65536 envs) and the block kernel at n = 27, 72, 96."""
    err = 0.0
    for n in (1, 6, 8, 11, 16, 17, 24, 27, 33, 72, 96):
        H, g = spd_batch(NENV, n, seed=n)
        x = linalg_tpu.psd_solve(H, g)
        width = kernels.psd_solve.width
        ref = linalg_tpu.psd_solve_plain(H, g)
        torch.cuda.synchronize()
        e = close(f"K1 n={n}", x, ref, 1e-4, 1e-5)
        rel = float(((x - ref).abs() / ref.abs().clamp(min=1e-3)).max())
        lib = close(f"K1 n={n} vs library", x, library_solve(H, g), 1e-3, 1e-4)
        upper = torch.ones(n, n, dtype=torch.bool, device="cuda").triu(1)
        assert torch.equal(linalg_tpu.psd_solve(H.masked_fill(upper, float("nan")), g), x), \
            f"K1 n={n}: the upper triangle changed x"
        print(f"[K1 vs plain] n={n} nenv={NENV} G={width}: max abs {e:.3e}, max rel "
              f"{rel:.3e}; vs cholesky+cholesky_solve max abs {lib:.3e}; NaN above the "
              f"diagonal: x unchanged", flush=True)
        err = max(err, e)
    n = 11
    H, g = spd_batch(NENV, n, seed=0)
    t = {"ms": time_ms(lambda: linalg_tpu.psd_solve(H, g), 200),
         "graph_ms": graph_ms(lambda: linalg_tpu.psd_solve(H, g), 200),
         "graph_one_ms": graph_ms(lambda: linalg_tpu.psd_solve(H, g), 200, calls=1),
         "plain_ms": time_ms(lambda: linalg_tpu.psd_solve_plain(H, g), 20),
         "library_ms": time_ms(lambda: library_solve(H, g), 200),
         "group": kernels.psd_solve.width, "bound": k1_bound(NENV, n)}
    print(f"[K1 timing] nenv={NENV} n={n} G={t['group']}: kernel {t['graph_ms']:.4f} ms by "
          f"graph replay, 20 calls a replay ({t['graph_one_ms']:.4f} ms at one call a "
          f"replay, {t['ms']:.4f} ms one call at a time: the host's launch intervals), "
          f"plain {t['plain_ms']:.4f} ms, cholesky+cholesky_solve "
          f"{t['library_ms']:.4f} ms, bound {t['bound'][0]:.5f} ms ({t['bound'][1]}) "
          f"({card})", flush=True)
    t["widths"] = k1_widths(card)
    return err, t


def k1_widths(card):
    """K1's device time (graph replay) at every width that takes n, each
    held against the plain version first: the row kernel at 8 lanes (n <= 8)
    and 16, the block kernel at the same n, at 4096 and 65536 envs; the
    block kernel alone above n = 16."""
    out = {}
    shapes = [(n, nenv) for n in (6, 8, 11, 16) for nenv in (NENV, 65536)]
    shapes += [(n, NENV) for n in (27, 72, 96)]
    for n, nenv in shapes:
        H, g = spd_batch(nenv, n, seed=100 + n)
        ref = linalg_tpu.psd_solve_plain(H, g)
        rule = kernels.psd_width(n)
        for width in [w for w in (8, 16) if n <= w] + [kernels.PSD_BLOCK_THREADS]:
            with forced_width(width, "psd_width"):
                close(f"K1 n={n} nenv={nenv} G={width}", linalg_tpu.psd_solve(H, g), ref,
                      1e-4, 1e-5)
                out[(n, nenv, width)] = graph_ms(lambda: linalg_tpu.psd_solve(H, g), 200)
        b = k1_bound(nenv, n)
        print(f"[K1 widths] n={n} nenv={nenv}: " + "; ".join(
            f"G={w} {ms:.4f} ms{' (rule)' if w == rule else ''}"
            for (m, e, w), ms in out.items() if (m, e) == (n, nenv))
              + f"; bound {b[0]:.5f} ms ({b[1]}) ({card})", flush=True)
    return out


# ---------------------------------------------------------------------------
# K2: the Newton solve
# ---------------------------------------------------------------------------

def pendulum_states(nenv, seed):
    """Seeded PENDULUM states (qpos 13, qvel 11): a tilted ball joint, bent
    hinges, the free ball around its resting place, some in penetration."""
    rng = np.random.default_rng(seed)
    qpos = np.zeros((nenv, 13))
    q = rng.normal(size=(nenv, 4)) * 0.3
    q[:, 0] += 1.0
    qpos[:, :4] = q / np.linalg.norm(q, axis=1, keepdims=True)
    qpos[:, 4:6] = 0.6 * rng.normal(size=(nenv, 2))
    qpos[:, 6] = 1.0 + 0.05 * rng.normal(size=nenv)
    qpos[:, 7] = 0.05 * rng.normal(size=nenv)
    qpos[:, 8] = 0.01 + 0.06 * rng.uniform(size=nenv)
    q = rng.normal(size=(nenv, 4)) * 0.5
    q[:, 0] += 1.0
    qpos[:, 9:] = q / np.linalg.norm(q, axis=1, keepdims=True)
    qvel = 0.5 * rng.normal(size=(nenv, 11))
    return (torch.from_numpy(qpos.astype(np.float32)).cuda(),
            torch.from_numpy(qvel.astype(np.float32)).cuda())


def pendulum_problem(m, nenv, seed):
    """PENDULUM's constraint problem at seeded states, built by the port's
    general path up to the solve: (static args, tensor args)."""
    qpos, qvel = pendulum_states(nenv, seed)
    return rows_problem(m, fwd.make_data(m, nenv).replace(qpos=qpos, qvel=qvel), seed)


def rows_problem(m, d, seed):
    """The constraint problem of the state d, built by the port's general
    path up to the solve, with a seeded warm start: (static args, tensor
    args)."""
    nenv = d.qpos.shape[0]
    d = smooth.fwd_position_smooth(m, d)
    d = collision.collide(m, d)
    d = smooth.fwd_acceleration_smooth(m, smooth.fwd_velocity_smooth(m, d))
    e = efc.make_efc(m, d)
    niter, nls = solver_tpu.trip_counts(m)
    static = (e.kinds, tuple(zip(e.con_base, e.con_dim)), m.nv, niter, nls,
              m.opt.tolerance, True)
    ws = torch.from_numpy((0.1 * np.random.default_rng(seed).normal(
        size=(nenv, m.nv))).astype(np.float32)).cuda()
    args = dict(J=e.J, aref=e.aref, D=e.D, floss=e.frictionloss, active=e.active,
                mu=e.con_mu, M=d.qM, a_s=d.qacc_smooth, ws=ws)
    return static, args


def k2_compare(label, static, args, tol):
    got = solver_tpu.solve_batched(*static, **args)
    want = solver_tpu.solve_batched_plain(*static, **args)
    torch.cuda.synchronize()
    errs = {name: close(f"K2 {label} {name}", a, b, tol, tol)
            for name, a, b in zip(("qacc", "qfrc", "f_rows"), got, want)}
    assert all(torch.isfinite(t).all() for t in got)
    print(f"[K2 vs plain] {label} nenv={args['J'].shape[0]}: " + " ".join(
        f"{k}={v:.3e}" for k, v in errs.items()), flush=True)
    return max(errs.values())


def k2_default_friction():
    """K2 at MuJoCo's default friction, nv 16, 64 rows. Its stiff cones leave
    flat directions where float32 rounding moves qacc by up to 2e-2, so the
    check is on the objective: on the envs whose plain solve converged
    within 32 trips, the kernel's and the plain version's final costs agree
    to 1e-3 of max(cost, 1) (float32 against float64 solves of such problems
    differ by up to 2e-4 relative)."""
    p = {k: torch.from_numpy(v).cuda() for k, v in random_problem(
        np.random.default_rng(17), NENV, 16, FULL_KINDS, FULL_BASE,
        friction=DEFAULT_FRICTION).items()}
    x, _, _ = solver_tpu.solve_batched(FULL_KINDS, FULL_BASE, 16, 32, 8, 1e-8, True, **p)
    # the kernel reports no trips: an env that converged within 31 trips is
    # frozen, so its x after 31 and after 32 trips are equal bit for bit
    x31, _, _ = solver_tpu.solve_batched(FULL_KINDS, FULL_BASE, 16, 31, 8, 1e-8, True, **p)
    k2_done = (x31 == x).all(-1)
    trips, trips64 = [], []
    solver_tpu.newton_tiles(16, FULL_KINDS, FULL_BASE, 32, 8, True, 1e-8,
                            *(t.double() if t.is_floating_point() else t for t in p.values()),
                            trips=trips64)
    done64 = trips64[0] < 32
    xp, _ = solver_tpu.newton_tiles(16, FULL_KINDS, FULL_BASE, 32, 8, True, 1e-8,
                                    *p.values(), trips=trips)
    torch.cuda.synchronize()
    done = trips[0] < 32
    assert int(done.sum()) >= NENV // 20, f"{int(done.sum())} envs converged"
    got = solve_cost(FULL_KINDS, FULL_BASE, p, x)[done]
    want = solve_cost(FULL_KINDS, FULL_BASE, p, xp)[done]
    rel = float(((got - want).abs() / want.abs().clamp(min=1.0)).max())
    print(f"[K2 vs plain] default friction: converged within 31 trips: K2 "
          f"{int(k2_done.sum())} envs, plain {int(done.sum())}, "
          f"both {int((k2_done & done).sum())}, "
          f"the sets differ in {int((k2_done != done).sum())} of {NENV} (plain trips of "
          f"those envs {trips[0][k2_done != done].tolist()}); the plain solve in float64 "
          f"converges in {int(done64.sum())}, its set differs from the plain float32 one in "
          f"{int((done64 != done).sum())}, from K2's in {int((done64 != k2_done).sum())}",
          flush=True)
    print(f"[K2 vs plain] default friction nv=16 rows={len(FULL_KINDS)} nenv={NENV}: "
          f"{int(done.sum())} envs converged within 32 trips; on those, cost max rel "
          f"err {rel:.3e}, qacc max abs err {float((x - xp).abs()[done].max()):.3e}",
          flush=True)
    assert rel < 1e-3, f"K2 at default friction: cost rel err {rel}"


def k2_phase(card):
    m = mjcf.load_model_from_string(worlds.PENDULUM, dtype=torch.float32).to("cuda")
    static, args = pendulum_problem(m, NENV, seed=0)
    print(f"[K2] PENDULUM: nv={m.nv}, {len(static[0])} rows, cones "
          f"{static[1]}, active contacts per env mean "
          f"{float(args['active'][:, [b for b, _ in static[1]]].float().sum(1).mean()):.3f}",
          flush=True)
    err = k2_compare("PENDULUM rows", static, args, 1e-3)
    ml = mjcf.load_model_from_string(PENDULUM_LIMITED, dtype=torch.float32).to("cuda")
    lstatic, largs = pendulum_problem(ml, NENV, seed=3)
    assert lstatic[0][:2] == ("lim", "lim") and len(lstatic[0]) == 35, lstatic[0][:3]
    lim_active = largs["active"][:, :2].float().sum(1)
    print(f"[K2] limited PENDULUM: {len(lstatic[0])} rows (2 limit rows first), limit rows "
          f"active per env mean {float(lim_active.mean()):.3f}", flush=True)
    assert float(lim_active.sum()) > 0, "no limit row active"
    err = max(err, k2_compare("limited PENDULUM rows", lstatic, largs, 1e-3))
    for nv, kinds, base in ((6, MIXED_KINDS, MIXED_BASE), (11, MIXED_KINDS, MIXED_BASE),
                            (16, MIXED_KINDS, MIXED_BASE), (16, FULL_KINDS, FULL_BASE)):
        p = {k: torch.from_numpy(v).cuda() for k, v in random_problem(
            np.random.default_rng(nv), NENV, nv, kinds, base).items()}
        k2_compare(f"synthetic nv={nv} rows={len(kinds)}",
                   (kinds, base, nv, 32, 8, 1e-8, True), p, 2e-3)
    k2_default_friction()
    prepared = k2_args(static, args)
    t = k2_timing(card, "PENDULUM rows", static, args)
    kinds, con_base, nv = static[:3]
    nefc, ncon = len(kinds), len(con_base)

    # every group width: PENDULUM's rows (each held against the plain
    # version first) and the 64 synthetic rows at nv 16
    want = solver_tpu.solve_batched_plain(*static, **args)
    full = {k: torch.from_numpy(v).cuda() for k, v in random_problem(
        np.random.default_rng(16), NENV, 16, FULL_KINDS, FULL_BASE).items()}
    full_args = k2_args((FULL_KINDS, FULL_BASE, 16, 32, 8, 1e-8, True), full)
    small = {k: torch.from_numpy(v).cuda() for k, v in random_problem(
        np.random.default_rng(6), NENV, 6, MIXED_KINDS, MIXED_BASE).items()}
    small_args = k2_args((MIXED_KINDS, MIXED_BASE, 6, 32, 8, 1e-8, True), small)
    big_static, big = pendulum_problem(m, 65536, seed=2)
    big_args = k2_args(big_static, big)
    cases = (("PENDULUM rows", prepared, t["group"], 100),
             ("nv=16 rows=64", full_args, kernels.group_width(16, 64, len(FULL_BASE), NENV),
              20),
             ("nv=6 rows=20", small_args,
              kernels.group_width(6, len(MIXED_KINDS), len(MIXED_BASE), NENV), 100),
             ("PENDULUM rows nenv=65536", big_args,
              kernels.group_width(nv, nefc, ncon, 65536), 20))
    t["widths"] = {}
    for g in kernels.GROUP_WIDTHS:          # the widths of at least nv lanes
        with forced_width(g):
            if g >= nv:
                got = kernels.newton_solve(*prepared)
                for name, a, b in zip(("qacc", "qfrc", "f_rows"), got, want):
                    close(f"K2 G={g} PENDULUM {name}", a, b, 1e-3, 1e-3)
            t["widths"][g] = {label: graph_ms(lambda a=a: kernels.newton_solve(*a), n)
                              for label, a, _, n in cases if g >= a[2].shape[-1]}
        print(f"[K2 timing] G={g} nenv={NENV}: " + "; ".join(
            f"{label} {t['widths'][g][label]:.4f} ms{' (rule)' if g == rule else ''}"
            for label, _, rule, _ in cases if label in t["widths"][g]) + f" ({card})",
              flush=True)
    return err, t


def k2_timing(card, label, static, args):
    """K2 on one problem: one call at a time (solve_batched), by graph
    replay, the plain version, the bound from the Newton trips each env
    takes, the group width."""
    prepared = k2_args(static, args)
    t = {"ms": time_ms(lambda: solver_tpu.solve_batched(*static, **args), 100),
         "graph_ms": graph_ms(lambda: kernels.newton_solve(*prepared), 100),
         "plain_ms": time_ms(lambda: solver_tpu.solve_batched_plain(*static, **args), 5)}
    trips = []
    kinds, con_base, nv, niter, nls, tol, ws = static
    solver_tpu.newton_tiles(nv, kinds, con_base, niter, nls, ws, tol, args["J"],
                            args["aref"], args["D"], args["floss"], args["active"],
                            args["mu"], args["M"], args["a_s"], args["ws"], trips=trips)
    nefc, ncon, nenv = len(kinds), len(con_base), args["J"].shape[0]
    flops = float(sum(newton_flops(nv, nefc, [d for _, d in con_base], nls, int(k))
                      for k in trips[0].tolist()))
    nbytes = nenv * (4 * (nefc * nv + 3 * nefc + 5 * ncon + nv * nv + 2 * nv) + nefc
                     + 4 * (2 * nv + nefc))
    t["bound"] = bound(nbytes, flops)
    t["trips"] = trips[0].float()
    t["group"] = kernels.group_width(nv, nefc, ncon, nenv)
    print(f"[K2 timing] {label} nenv={nenv}: kernel {t['ms']:.4f} ms (G={t['group']}, "
          f"solve_batched one call at a time; {t['graph_ms']:.4f} ms by graph replay), "
          f"plain {t['plain_ms']:.4f} ms, bound {t['bound'][0]:.5f} ms ({t['bound'][1]}); "
          f"Newton trips mean {float(t['trips'].mean()):.3f} max "
          f"{int(t['trips'].max())} ({card})", flush=True)
    return t


def k2_args(static, args):
    """The K2 wrapper's arguments (kernels.newton_solve) for solve_batched's,
    made once so that a timing holds the launch alone."""
    kinds, con_base, nv, niter, nls, tol, ws = static
    meta = solver_tpu._meta_tensor(tuple(kinds), tuple(con_base), nv, niter, nls,
                                   bool(ws), args["J"].device)
    tol_t = torch.full((1,), tol, dtype=torch.float32, device=args["J"].device)
    return (meta, tol_t) + tuple(args[k].contiguous() for k in (
        "J", "aref", "D", "floss", "active", "mu", "M", "a_s", "ws"))


# ---------------------------------------------------------------------------
# the general path
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def plain_versions():
    """Route the general path's kernel calls to their plain versions (the
    reference and its timing; the port itself never does this)."""
    saved = linalg_tpu.psd_solve, solver_tpu.solve_batched
    linalg_tpu.psd_solve = linalg_tpu.psd_solve_plain
    solver_tpu.solve_batched = solver_tpu.solve_batched_plain
    try:
        yield
    finally:
        linalg_tpu.psd_solve, solver_tpu.solve_batched = saved


def captured_solves(m, d, plan):
    """Every K1 call of one fwd.step of d, in order, as (H, g): the mass
    matrix, the Newton trips' Hessians, Euler's damping solve."""
    seen, saved = [], linalg_tpu.psd_solve
    linalg_tpu.psd_solve = lambda H, g: seen.append((H.clone(), g.clone())) or saved(H, g)
    try:
        fwd.step(m, d, plan)
    finally:
        linalg_tpu.psd_solve = saved
    return seen


def general_vs_plain():
    m = mjcf.load_model_from_string(worlds.PENDULUM, dtype=torch.float32).to("cuda")
    plan = fwd.make_plan(m)
    assert plan == fwd.GeneralPlan()
    qpos, qvel = pendulum_states(NENV, seed=1)
    dk = fwd.make_data(m, NENV).replace(qpos=qpos, qvel=qvel)
    dp = dk
    errs = {}
    for k in range(5):
        dk = fwd.step(m, dk, plan)
        with plain_versions():
            dp = fwd.step(m, dp, plan)
        torch.cuda.synchronize()
        if k == 0:
            errs["qpos_1"] = close("general qpos 1 step", dk.qpos, dp.qpos, 1e-5, 1e-6)
            errs["qvel_1"] = close("general qvel 1 step", dk.qvel, dp.qvel, 1e-4, 1e-4)
            errs["qacc_1"] = close("general qacc 1 step", dk.qacc, dp.qacc, 1e-3, 1e-3)
    errs["qpos_5"] = close("general qpos 5 steps", dk.qpos, dp.qpos, 0.0, 1e-4)
    assert torch.isfinite(dk.qpos).all() and torch.isfinite(dk.qvel).all()
    print(f"[general vs plain] PENDULUM nenv={NENV}: " + " ".join(
        f"{k}={v:.3e}" for k, v in errs.items()), flush=True)
    return m, plan, dk


def general_main_path():
    zero_counts()
    t0 = time.perf_counter()
    srv = MujocoServer(worlds.PENDULUM, nenv=NENV, unpause=False)
    assert srv.device.type == "cuda", f"the server's default device is {srv.device}"
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    assert srv.step(1000).success
    torch.cuda.synchronize()
    t_step = time.perf_counter() - t1
    launches = {"psd_solve": kernels.psd_solve.launches,
                "newton_solve": kernels.newton_solve.launches}
    assert launches == {"psd_solve": 1000, "newton_solve": 1000}, launches
    assert kernels.psd_solve.width == kernels.psd_width(srv.m.nv), kernels.psd_solve.width
    assert kernels.step_fused.launches == 0
    st = srv.get_batch_state()
    assert st["qpos"].shape == (NENV, 13) and np.isfinite(st["qpos"]).all()
    assert np.isfinite(st["qvel"]).all()
    assert all(torch.isfinite(t).all() for t in (srv.d.qacc, srv.d.qfrc_constraint,
                                                 srv.d.efc_force_contact))
    b = srv.get_body_state("ball", env_id=NENV - 1)
    z, speed = float(b.pose.position[2]), float(np.linalg.norm(b.twist.linear))
    zs = st["qpos"][:, 8]
    print(f"[general main path] server step(1000) of PENDULUM x {NENV}: "
          f"{t_step:.3f}s wall, {NENV * 1000 / t_step:.4g} env-steps/s; ball z "
          f"env{NENV - 1}={z:.6f} speed={speed:.3e}, z over envs "
          f"min={zs.min():.6f} max={zs.max():.6f}; max |qvel|="
          f"{np.abs(st['qvel']).max():.3e}; launches {launches}, K1 at "
          f"G={kernels.psd_solve.width}", flush=True)
    # measured on an H100: z = 0.049633 (soft-contact penetration 3.7e-4)
    # and speed 5.4e-7; bounds keep a 4x and 100x margin
    assert abs(z - 0.05) < 1.5e-3, f"ball z={z} not settled near its radius 0.05"
    assert speed < 1e-4, f"ball speed {speed} after 1000 steps"

    zero_counts()
    srv_d = MujocoServer(PENDULUM_DAMPED, nenv=NENV, unpause=False)
    assert srv_d.step(10).success
    torch.cuda.synchronize()
    assert np.isfinite(srv_d.get_batch_state()["qpos"]).all()
    damped = (kernels.psd_solve.launches, kernels.newton_solve.launches)
    assert damped == (20, 10), f"damped PENDULUM launches (K1, K2) = {damped}"
    print(f"[general main path] damped PENDULUM 10 steps: K1 launches {damped[0]}, "
          f"K2 launches {damped[1]}; phase {time.perf_counter() - t0:.1f}s", flush=True)
    return launches, t_step


def general_timing(card, m, plan, d):
    def run(nsteps):
        nonlocal d
        for _ in range(nsteps):
            d = fwd.step(m, d, plan)

    out = {"kernel": time_ms(lambda: run(50), 1, warmup=1) / 50}
    with plain_versions():
        out["plain"] = time_ms(lambda: run(3), 1, warmup=1) / 3
    print(f"[general timing] PENDULUM nenv={NENV}: {out['kernel']:.4f} ms/step with "
          f"the kernels, {out['plain']:.4f} ms/step with their plain versions ({card})",
          flush=True)
    return out


# ---------------------------------------------------------------------------
# PILE: the general Newton, K1 at n = 72
# ---------------------------------------------------------------------------

def pile_states(m, nenv, seed):
    """Seeded drops into PILE's bin: each body at its start height (0.12 +
    0.11 i m, the model's stack), turned at random, over a random place
    within 0.08 m of its env's heap centre (|x|, |y| < 0.42; the walls'
    inner faces stand at 0.53), so that bodies land on each other and some
    heaps against a wall."""
    rng = np.random.default_rng(seed)
    qpos = np.tile(m.qpos0.cpu().numpy().reshape(12, 7), (nenv, 1, 1))
    qpos[..., :2] = (rng.uniform(-0.42, 0.42, (nenv, 1, 2))
                     + rng.uniform(-0.08, 0.08, (nenv, 12, 2)))
    quat = rng.normal(size=(nenv, 12, 4))
    qpos[..., 3:] = quat / np.linalg.norm(quat, axis=-1, keepdims=True)
    return torch.from_numpy(qpos.reshape(nenv, 84).astype(np.float32)).cuda()


@contextlib.contextmanager
def newton_trips():
    """Record (the Newton trips each env took, the trips the batch ran, the
    host syncs) of every general Newton solve inside the block."""
    log, saved = [], solver.newton
    solver.newton = lambda m, d, e: saved(m, d, e, trips=log)
    try:
        yield log
    finally:
        solver.newton = saved


def group_slots(m):
    """(routine name, contact slots) of each pair group."""
    return [(narrowphase._DISPATCH[grp["key"][1:3]].name,
             [int(b) + k for b in grp["bases"] for k in range(grp["cap"])])
            for grp in narrowphase.pair_groups(m)]


def pile_settled(m, plan, nenv, nsteps, seed=3):
    """Seeded drops stepped nsteps times with the kernels; also the number
    of env-steps in which each pair group had an active contact."""
    d = fwd.make_data(m, nenv).replace(qpos=pile_states(m, nenv, seed))
    groups = group_slots(m)
    seen = torch.zeros(len(groups), dtype=torch.int64, device=d.qpos.device)
    for _ in range(nsteps):
        d = fwd.step(m, d, plan)
        active = d.contact.dist < d.contact.includemargin
        seen += torch.stack([active[:, sl].any(1).sum() for _, sl in groups])
    torch.cuda.synchronize()
    assert torch.isfinite(d.qpos).all() and torch.isfinite(d.qvel).all()
    return d, dict(zip((name for name, _ in groups), seen.tolist()))


def pile_vs_plain(card):
    """PILE at 512 envs, settled with the kernels for 300 steps from seeded
    drops (every pair group in contact in some env while settling; the
    count is printed): 1 and 5 steps with
    the kernels against their plain versions, at the tolerances of
    general_vs_plain; then K1 at n = 72 on the Hessians of one PILE step's
    Newton trips: against psd_solve_plain at rtol / atol 1e-2 (x reaches
    1e3 and these Hessians are far worse conditioned than the SPD
    batches), and against the float64 solve by held_against_f64, in units
    of 1e-5 + 1e-4 |x64|."""
    m = mjcf.load_model_from_string(worlds.PILE, dtype=torch.float32).to("cuda")
    plan = fwd.make_plan(m)
    assert plan == fwd.GeneralPlan()
    t0 = time.perf_counter()
    d, seen = pile_settled(m, plan, 512, 300)
    idle = [name for name, n in seen.items() if not n]
    assert not idle, f"PILE pair groups never in contact while settling: {idle}"
    active = d.contact.dist < d.contact.includemargin
    now = {name: int(active[:, sl].any(1).sum()) for name, sl in group_slots(m)}
    print(f"[PILE] 512 envs settled 300 steps in {time.perf_counter() - t0:.1f}s: active "
          f"contacts per env mean {float(active.sum(1).float().mean()):.2f} max "
          f"{int(active.sum(1).max())}; env-steps with a contact, by pair group, while "
          f"settling: {seen}; envs with one now: {now}", flush=True)
    dk = dp = d
    errs = {}
    for k in range(5):
        dk = fwd.step(m, dk, plan)
        with plain_versions():
            dp = fwd.step(m, dp, plan)
        torch.cuda.synchronize()
        if k == 0:
            errs["qpos_1"] = close("PILE qpos 1 step", dk.qpos, dp.qpos, 1e-5, 1e-6)
            errs["qvel_1"] = close("PILE qvel 1 step", dk.qvel, dp.qvel, 1e-4, 1e-4)
            errs["qacc_1"] = close("PILE qacc 1 step", dk.qacc, dp.qacc, 1e-3, 1e-3)
    errs["qpos_5"] = close("PILE qpos 5 steps", dk.qpos, dp.qpos, 0.0, 1e-4)
    print(f"[PILE vs plain] nenv=512: " + " ".join(f"{k}={v:.3e}" for k, v in errs.items()),
          flush=True)

    err = 0.0
    seen = captured_solves(m, d, plan)
    for i, (H, g) in enumerate(seen[1:]):             # seen[0]: the mass matrix
        x = linalg_tpu.psd_solve(H, g)
        ref = linalg_tpu.psd_solve_plain(H, g)
        x64 = torch.linalg.solve(H.double(), g.double()[..., None])[..., 0]
        torch.cuda.synchronize()
        e = close(f"K1 PILE Hessian {i + 1} vs plain", x, ref, 1e-2, 1e-2)
        held = held_against_f64(f"K1 PILE Hessian {i + 1}", x, ref, x64,
                                1e-5 + 1e-4 * x64.abs())
        print(f"[K1 PILE] Hessian of Newton trip {i + 1} (512, 72, 72): vs plain max abs "
              f"{e:.3e} (max |x| {float(ref.abs().max()):.3e}); vs float64 in units of "
              f"1e-5 + 1e-4 |x64|, worst env {held[1]:.3f}, 99th percentile {held[3]:.3f} "
              f"(plain float32: {held[0]:.3f}, {held[2]:.3f})", flush=True)
        err = max(err, e)
    return m, plan, d, max(max(errs.values()), err)


def pile_main_path(tf32_default):
    """MujocoServer(PILE, nenv=512) on the default device steps PILE_STEPS
    times from the model's start (the bodies drop into the bin): K1 once
    per step for the mass matrix and once per Newton trip the batch ran,
    K2 and K3 never; everything finite, every body above z = -0.02 and
    inside the walls (|x|, |y| < 0.6; the walls stand at +-0.55)."""
    assert not tf32_default, "TF32 matmuls are on by default: the Hessian needs full float32"
    zero_counts()
    t0 = time.perf_counter()
    srv = MujocoServer(worlds.PILE, nenv=512, unpause=False)
    assert srv.device.type == "cuda", f"the server's default device is {srv.device}"
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    with newton_trips() as log:
        assert srv.step(PILE_STEPS).success
    torch.cuda.synchronize()
    t_step = time.perf_counter() - t1
    ran = sum(r for _, r, _ in log)
    syncs = sum(s for _, _, s in log)
    launches = {"psd_solve": kernels.psd_solve.launches,
                "newton_solve": kernels.newton_solve.launches,
                "step_fused": kernels.step_fused.launches}
    assert len(log) == PILE_STEPS, f"{len(log)} general Newton solves in {PILE_STEPS} steps"
    assert launches == {"psd_solve": PILE_STEPS + ran, "newton_solve": 0, "step_fused": 0}, \
        f"launches {launches}, {PILE_STEPS} steps + {ran} Newton trips"
    d = srv.d
    assert all(torch.isfinite(t).all() for t in (d.qpos, d.qvel, d.qacc,
                                                 d.efc_force_contact))
    pos = d.qpos.reshape(512, 12, 7)[..., :3]
    assert float(pos[..., 2].min()) > -0.02, f"a body fell through: z {float(pos[..., 2].min())}"
    assert float(pos[..., :2].abs().max()) < 0.6, \
        f"a body left the bin: |x|, |y| up to {float(pos[..., :2].abs().max())}"
    per_env = torch.cat([t for t, _, _ in log])
    hist = torch.bincount(per_env, minlength=srv.m.opt.iterations + 1).tolist()
    batch = torch.bincount(torch.tensor([r for _, r, _ in log]),
                           minlength=srv.m.opt.iterations + 1).tolist()
    print(f"[PILE main path] server step({PILE_STEPS}) of PILE x 512: {t_step:.3f}s wall, "
          f"{512 * PILE_STEPS / t_step:.4g} env-steps/s; launches {launches} (K1 = "
          f"{PILE_STEPS} steps + {ran} Newton trips of the batch); host syncs per step "
          f"{syncs / PILE_STEPS:.3f} (one per {solver.SYNC_EVERY} trips); z min "
          f"{float(pos[..., 2].min()):.4f}, |x|,|y| max {float(pos[..., :2].abs().max()):.4f}; "
          f"phase {time.perf_counter() - t0:.1f}s", flush=True)
    print(f"[PILE main path] Newton trips per env and step, counts for 0..12: {hist}; "
          f"trips the batch ran per step: {batch}", flush=True)
    return launches["psd_solve"], t_step


def pile_timing(card, m, plan, d):
    """ms/step of PILE through fwd.step with the kernels at 512 and 4096
    envs (the settled states, tiled), with the plain versions at 512; K1's
    device time (graph replay) at n = 72 on a captured PILE Hessian batch at
    both sizes (held against the plain version first, at pile_vs_plain's
    tolerance), and one call at a time beside cholesky + cholesky_solve at
    n = 27, 72 and 96 (4096 envs, SPD batches)."""
    out = {}

    def run(dd, nsteps):
        for _ in range(nsteps):
            dd = fwd.step(m, dd, plan)
        return dd
    big = tile_envs(m, d, 8)
    for nenv, dd in ((512, d), (4096, big)):
        run(dd, 2)
        out[("kernel", nenv)] = time_ms(lambda: run(dd, 10), 1, warmup=0) / 10
    with plain_versions():
        out[("plain", 512)] = time_ms(lambda: run(d, 3), 1, warmup=1) / 3
    print(f"[PILE timing] {out[('kernel', 512)]:.4f} ms/step at 512 envs, "
          f"{out[('kernel', 4096)]:.4f} at 4096 with the kernels; "
          f"{out[('plain', 512)]:.4f} at 512 with their plain versions ({card})", flush=True)
    for nenv, dd in ((512, d), (4096, big)):
        H, g = captured_solves(m, dd, plan)[1]
        close(f"K1 PILE Hessian nenv={nenv}", linalg_tpu.psd_solve(H, g),
              linalg_tpu.psd_solve_plain(H, g), 1e-2, 1e-2)
        out[("graph", nenv)] = graph_ms(lambda: linalg_tpu.psd_solve(H, g), 200)
        out[("bound", nenv)] = k1_bound(nenv, 72)
        print(f"[PILE timing] K1 n=72 nenv={nenv} on a PILE Hessian: {out[('graph', nenv)]:.4f} "
              f"ms by graph replay, bound {out[('bound', nenv)][0]:.5f} ms "
              f"({out[('bound', nenv)][1]}) ({card})", flush=True)
    for n in (27, 72, 96):
        H, g = spd_batch(NENV, n, seed=200 + n)
        out[("k1_ms", n)] = time_ms(lambda: linalg_tpu.psd_solve(H, g), 100)
        out[("k1_graph", n)] = graph_ms(lambda: linalg_tpu.psd_solve(H, g), 100)
        out[("library", n)] = time_ms(lambda: library_solve(H, g), 100)
        print(f"[PILE timing] n={n} nenv={NENV}: K1 {out[('k1_graph', n)]:.4f} ms by graph "
              f"replay, {out[('k1_ms', n)]:.4f} one call at a time; cholesky+cholesky_solve "
              f"{out[('library', n)]:.4f} ms one call at a time; bound "
              f"{k1_bound(NENV, n)[0]:.5f} ms ({card})", flush=True)
    return out


def tile_envs(m, d, k):
    """A batch of k copies of d's state (qpos, qvel, warm start, time,
    ctrl)."""
    return fwd.make_data(m, k * d.qpos.shape[0]).replace(**{
        f: getattr(d, f).repeat((k,) + (1,) * (getattr(d, f).dim() - 1))
        for f in ("time", "qpos", "qvel", "qacc_warmstart", "ctrl")})


# ---------------------------------------------------------------------------
# HUMANOID: motors, limit rows, the general Newton, K1 at n = 27
# ---------------------------------------------------------------------------

def humanoid_data(m, nenv, seed):
    """The port's batch of tests/torch_problems.humanoid_states on the card:
    seeded poses 1.3 m up with hinges past their limits, random ctrl."""
    qpos, qvel, ctrl = (torch.from_numpy(a.astype(np.float32)).cuda()
                        for a in humanoid_states(m, nenv, seed))
    return fwd.make_data(m, nenv).replace(qpos=qpos, qvel=qvel, ctrl=ctrl)


def humanoid_rows(m, d):
    """The efc rows the next step of d solves (the stages up to make_efc)."""
    d = collision.collide(m, smooth.fwd_position_smooth(m, d))
    return efc.make_efc(m, smooth.fwd_velocity_smooth(m, d))


def data_as(d, dtype):
    """d with every floating tensor, the contact set's too, cast to dtype."""
    def cast(obj):
        return {f.name: getattr(obj, f.name).to(dtype) for f in dataclasses.fields(obj)
                if torch.is_tensor(getattr(obj, f.name))
                and getattr(obj, f.name).is_floating_point()}
    return d.replace(contact=d.contact.replace(**cast(d.contact)), **cast(d))


def humanoid_qacc(qk, qp, x64, trips_k, trips_p, label="HUMANOID vs plain"):
    """qacc after one HUMANOID step with the kernels (qk) against their
    plain versions (qp) and the plain step in float64 (x64). Phase 8's
    rtol / atol 1e-3 between two float32 solves lies below what float32
    resolves here: the plain float32 step itself misses float64 by up to
    8.8 times that tolerance on HUMANOID's settled states (1024 envs, an
    NVIDIA H100 80GB HBM3), and the few envs where the kernels' qacc and
    the plain one differ by more took the same Newton trips. So qacc is
    held against float64 by held_against_f64 in units of phase 8's
    tolerance, 1e-3 + 1e-3 |x64|; the envs past 1e-3 of plain are printed
    with their trips and their errors against float64. Returns the max abs
    difference to plain."""
    over = ((qk - qp).abs() > 1e-3 + 1e-3 * qp.abs()).any(-1)
    same = trips_k == trips_p
    held = held_against_f64("HUMANOID qacc 1 step", qk, qp, x64, 1e-3 + 1e-3 * x64.abs())
    bad = torch.nonzero(over).flatten().tolist()
    print(f"[{label}] qacc 1 step against float64 in units of 1e-3 + 1e-3 |x64|: "
          f"worst env {held[1]:.3f}, 99th percentile {held[3]:.3f} (plain float32: "
          f"{held[0]:.3f}, {held[2]:.3f}); {len(bad)} envs past rtol / atol 1e-3 of plain, "
          f"{int((over & ~same).sum())} of them with other Newton trips (kernels "
          f"{trips_k[over].tolist()}, plain {trips_p[over].tolist()}), their errors "
          f"against float64 {[round(float(held[4][i]), 3) for i in bad]} (plain "
          f"{[round(float(held[5][i]), 3) for i in bad]}); envs with other trips "
          f"{int((~same).sum())} of {len(same)}", flush=True)
    return float((qk - qp).abs().max())


def humanoid_vs_plain(card):
    """HUMANOID at 1024 envs from seeded states with random ctrl, settled
    with the kernels for HUMANOID_SETTLE steps (the feet on the floor; some
    contacts and some limit rows active, asserted), then 1 and 5 steps with
    the kernels against their plain versions at general_vs_plain's
    tolerances for qpos and qvel, qacc held against the float64 step
    (humanoid_qacc); then K1 at n = 27 on every solve of one step (the mass
    matrix, each Newton trip's Hessian, Euler's damping solve): against
    psd_solve_plain at pile_vs_plain's rtol / atol 1e-2 and against the
    float64 solve by held_against_f64, in units of 1e-5 + 1e-4 |x64|."""
    m = mjcf.load_model_from_string(HUMANOID, dtype=torch.float32).to("cuda")
    plan = fwd.make_plan(m)
    assert plan == fwd.GeneralPlan() and (m.nv, m.nu) == (27, 21)
    t0 = time.perf_counter()
    d = humanoid_data(m, HUMANOID_NENV, seed=5)
    for _ in range(HUMANOID_SETTLE):
        d = fwd.step(m, d, plan)
    torch.cuda.synchronize()
    assert torch.isfinite(d.qpos).all() and torch.isfinite(d.qvel).all()
    e = humanoid_rows(m, d)
    nlim = sum(m.jnt_limited)
    lim = e.active[:, :nlim].sum(1).float()
    con = e.con_active.sum(1).float()
    print(f"[HUMANOID] {HUMANOID_NENV} envs settled {HUMANOID_SETTLE} steps in "
          f"{time.perf_counter() - t0:.1f}s: {len(e.kinds)} rows; active limit rows per env "
          f"mean {float(lim.mean()):.2f} max {int(lim.max())}; active contacts per env mean "
          f"{float(con.mean()):.2f} max {int(con.max())}, envs in contact "
          f"{int((con > 0).sum())}; root z mean {float(d.qpos[:, 2].mean()):.4f}", flush=True)
    assert float(lim.sum()) > 0 and float(con.sum()) > 0, "no limit row or no contact active"
    dk = dp = d
    errs = {}
    for k in range(5):
        with newton_trips() as lk:
            dk = fwd.step(m, dk, plan)
        with plain_versions(), newton_trips() as lp:
            dp = fwd.step(m, dp, plan)
        torch.cuda.synchronize()
        if k == 0:
            errs["qpos_1"] = close("HUMANOID qpos 1 step", dk.qpos, dp.qpos, 1e-5, 1e-6)
            errs["qvel_1"] = close("HUMANOID qvel 1 step", dk.qvel, dp.qvel, 1e-4, 1e-4)
            m64 = mjcf.load_model_from_string(HUMANOID, dtype=torch.float64).to("cuda")
            with plain_versions():
                x64 = fwd.step(m64, data_as(d, torch.float64)).qacc
            errs["qacc_1"] = humanoid_qacc(dk.qacc, dp.qacc, x64, lk[0][0], lp[0][0])
    errs["qpos_5"] = close("HUMANOID qpos 5 steps", dk.qpos, dp.qpos, 0.0, 1e-4)
    assert torch.isfinite(dk.qpos).all() and torch.isfinite(dk.qvel).all()
    print(f"[HUMANOID vs plain] nenv={HUMANOID_NENV}: " + " ".join(
        f"{k}={v:.3e}" for k, v in errs.items()), flush=True)

    err = 0.0
    seen = captured_solves(m, d, plan)
    labels = (["mass matrix"] + [f"Hessian of Newton trip {i}" for i in range(1, len(seen) - 1)]
              + ["Euler's damping solve"])
    for label, (H, g) in zip(labels, seen):
        assert H.shape[-1] == 27
        x = linalg_tpu.psd_solve(H, g)
        ref = linalg_tpu.psd_solve_plain(H, g)
        x64 = torch.linalg.solve(H.double(), g.double()[..., None])[..., 0]
        torch.cuda.synchronize()
        e_abs = close(f"K1 HUMANOID {label} vs plain", x, ref, 1e-2, 1e-2)
        held = held_against_f64(f"K1 HUMANOID {label}", x, ref, x64, 1e-5 + 1e-4 * x64.abs())
        print(f"[K1 HUMANOID] {label} ({HUMANOID_NENV}, 27, 27): vs plain max abs "
              f"{e_abs:.3e} (max |x| {float(ref.abs().max()):.3e}); vs float64 in units of "
              f"1e-5 + 1e-4 |x64|, worst env {held[1]:.3f}, 99th percentile {held[3]:.3f} "
              f"(plain float32: {held[0]:.3f}, {held[2]:.3f})", flush=True)
        err = max(err, e_abs)
    return m, plan, d, max(max(errs.values()), err)


def humanoid_main_path():
    """MujocoServer(HUMANOID, nenv=1024) on the default device: set_ctrl
    writes a seeded ctrl in [-1.2, 1.2] to every env and another to env 0,
    then HUMANOID_STEPS steps from the model's start (it falls onto the
    floor): K1 launches once per step for the mass matrix, once for Euler's
    damping solve and once per Newton trip the batch ran, K2 and K3 never;
    everything finite, the motors' forces the clamped ctrl."""
    zero_counts()
    t0 = time.perf_counter()
    srv = MujocoServer(HUMANOID, nenv=HUMANOID_NENV, unpause=False)
    assert srv.device.type == "cuda", f"the server's default device is {srv.device}"
    rng = np.random.default_rng(9)
    ctrl, ctrl0 = rng.uniform(-1.2, 1.2, 21), rng.uniform(-1.2, 1.2, 21)
    assert srv.set_ctrl(ctrl).success and srv.set_ctrl(ctrl0, env_id=0).success
    assert not srv.set_ctrl(ctrl[:20]).success
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    with newton_trips() as log:
        assert srv.step(HUMANOID_STEPS).success
    torch.cuda.synchronize()
    t_step = time.perf_counter() - t1
    ran = sum(r for _, r, _ in log)
    syncs = sum(s for _, _, s in log)
    launches = {"psd_solve": kernels.psd_solve.launches,
                "newton_solve": kernels.newton_solve.launches,
                "step_fused": kernels.step_fused.launches}
    assert len(log) == HUMANOID_STEPS, f"{len(log)} Newton solves in {HUMANOID_STEPS} steps"
    assert launches == {"psd_solve": 2 * HUMANOID_STEPS + ran, "newton_solve": 0,
                        "step_fused": 0}, \
        f"launches {launches}, {HUMANOID_STEPS} steps x 2 + {ran} Newton trips"
    assert kernels.psd_solve.width == kernels.PSD_BLOCK_THREADS, kernels.psd_solve.width
    d = srv.d
    assert all(torch.isfinite(t).all() for t in (d.qpos, d.qvel, d.qacc, d.qfrc_actuator,
                                                 d.efc_force_contact))
    want = np.tile(np.clip(ctrl, -1, 1), (HUMANOID_NENV, 1))
    want[0] = np.clip(ctrl0, -1, 1)
    np.testing.assert_allclose(d.actuator_force.cpu().numpy(), want, rtol=1e-6)
    z = d.qpos[:, 2]
    per_env = torch.cat([t for t, _, _ in log]).float()
    batch = torch.bincount(torch.tensor([r for _, r, _ in log]),
                           minlength=srv.m.opt.iterations + 1).tolist()
    active = d.contact.dist < d.contact.includemargin
    print(f"[HUMANOID main path] server step({HUMANOID_STEPS}) of HUMANOID x "
          f"{HUMANOID_NENV}: {t_step:.3f}s wall, {HUMANOID_NENV * HUMANOID_STEPS / t_step:.4g} "
          f"env-steps/s; launches {launches} (K1 = 2 x {HUMANOID_STEPS} steps + {ran} Newton "
          f"trips of the batch: {launches['psd_solve'] / HUMANOID_STEPS:.3f} per step); "
          f"Newton trips per env and step mean {float(per_env.mean()):.3f}, the batch's "
          f"{ran / HUMANOID_STEPS:.3f}; host syncs per step {syncs / HUMANOID_STEPS:.3f}; "
          f"root z min {float(z.min()):.4f} max {float(z.max()):.4f}; active contacts per env "
          f"mean {float(active.sum(1).float().mean()):.2f}; phase "
          f"{time.perf_counter() - t0:.1f}s", flush=True)
    print(f"[HUMANOID main path] trips the batch ran per step, counts for 0..20: {batch}",
          flush=True)
    return launches["psd_solve"], t_step, float(per_env.mean()), ran / HUMANOID_STEPS


def humanoid_timing(card, m, plan, d):
    """fwd.step ms of the settled HUMANOID states at 1024 envs and tiled to
    4096, with the kernels (and at 1024 with their plain versions); K1 at n
    = 27 on the first Newton Hessian of a step at both sizes by graph
    replay, held against the plain version first (1e-2), beside its bound,
    the plain version and cholesky + cholesky_solve one call at a time."""
    out = {}

    def run(dd, nsteps):
        for _ in range(nsteps):
            dd = fwd.step(m, dd, plan)
        return dd
    big = tile_envs(m, d, 4)
    for nenv, dd in ((HUMANOID_NENV, d), (4 * HUMANOID_NENV, big)):
        run(dd, 2)
        out[("kernel", nenv)] = time_ms(lambda: run(dd, 10), 1, warmup=0) / 10
    with plain_versions():
        out[("plain", HUMANOID_NENV)] = time_ms(lambda: run(d, 3), 1, warmup=1) / 3
    print(f"[HUMANOID timing] fwd.step {out[('kernel', HUMANOID_NENV)]:.4f} ms at "
          f"{HUMANOID_NENV} envs, {out[('kernel', 4 * HUMANOID_NENV)]:.4f} at "
          f"{4 * HUMANOID_NENV} with the kernels; {out[('plain', HUMANOID_NENV)]:.4f} at "
          f"{HUMANOID_NENV} with their plain versions ({card})", flush=True)
    for nenv, dd in ((HUMANOID_NENV, d), (4 * HUMANOID_NENV, big)):
        H, g = captured_solves(m, dd, plan)[1]
        close(f"K1 HUMANOID Hessian nenv={nenv}", linalg_tpu.psd_solve(H, g),
              linalg_tpu.psd_solve_plain(H, g), 1e-2, 1e-2)
        out[("graph", nenv)] = graph_ms(lambda: linalg_tpu.psd_solve(H, g), 200)
        out[("ms", nenv)] = time_ms(lambda: linalg_tpu.psd_solve(H, g), 100)
        out[("plain_ms", nenv)] = time_ms(lambda: linalg_tpu.psd_solve_plain(H, g), 10)
        out[("library", nenv)] = time_ms(lambda: library_solve(H, g), 100)
        out[("bound", nenv)] = k1_bound(nenv, 27)
        print(f"[HUMANOID timing] K1 n=27 nenv={nenv} on a HUMANOID Hessian: "
              f"{out[('graph', nenv)]:.4f} ms by graph replay, {out[('ms', nenv)]:.4f} one "
              f"call at a time; plain {out[('plain_ms', nenv)]:.4f} ms; cholesky + "
              f"cholesky_solve {out[('library', nenv)]:.4f} ms; bound "
              f"{out[('bound', nenv)][0]:.5f} ms ({out[('bound', nenv)][1]}) ({card})",
              flush=True)
    return out


# ---------------------------------------------------------------------------
# SENSORS: sites, the sensor stages and the sensors plugin, K1 at n = 7 and
# K2 at nv 7 with 24 rows
# ---------------------------------------------------------------------------

def sensors_data(m, nenv, seed):
    """The port's batch of tests/torch_problems.sensors_states on the card:
    the probe near the floor, tilted (its corners in contact in most envs,
    its rangefinder looking up in some), random velocities."""
    qpos, qvel = (torch.from_numpy(a.astype(np.float32)).cuda()
                  for a in sensors_states(nenv, seed))
    return fwd.make_data(m, nenv).replace(qpos=qpos, qvel=qvel)


def sensor_cols(m, names):
    """The sensordata columns of the named sensors."""
    return [m.sensor_adr[i] + k for i in map(m.sensor, names)
            for k in range(m.sensor_dim[i])]


def sensors_vs_plain(card):
    """SENSORS at SENSORS_NENV seeded envs, 1 and 5 steps with the kernels
    and with their plain versions: qpos and qvel at general_vs_plain's
    tolerances after 1 step and qpos after 5, the position- and
    velocity-stage sensors at qvel's after 1 step; the accelerometer, force
    and torque (and qacc), which read qacc, at rtol / atol 1e-3 of plain
    after 1 step, or, in the envs past that, held against the float64 step
    by held_against_f64 in units of 1e-3 + 1e-3 |x64|, as HUMANOID's qacc
    is. Then K1 at n = 7 (the mass-matrix solve) against its plain
    version."""
    m = mjcf.load_model_from_string(worlds.SENSORS, dtype=torch.float32).to("cuda")
    plan = fwd.make_plan(m)
    assert plan == fwd.GeneralPlan() and (m.nv, m.nsensor, m.nsensordata) == (7, 11, 28)
    d = sensors_data(m, SENSORS_NENV, seed=11)
    pos_vel = sensor_cols(m, SENSORS_POS_VEL)
    acc = sensor_cols(m, ("acc", "frc", "trq"))
    dk, dp, errs = d, d, {}
    for k in range(5):
        dk = fwd.step(m, dk, plan)
        with plain_versions():
            dp = fwd.step(m, dp, plan)
        torch.cuda.synchronize()
        if k == 0:
            errs["qpos_1"] = close("SENSORS qpos 1 step", dk.qpos, dp.qpos, 1e-5, 1e-6)
            errs["qvel_1"] = close("SENSORS qvel 1 step", dk.qvel, dp.qvel, 1e-4, 1e-4)
            errs["sensors_pos_vel_1"] = close(
                "SENSORS position and velocity sensors 1 step", dk.sensordata[:, pos_vel],
                dp.sensordata[:, pos_vel], 1e-4, 1e-4)
            m64 = mjcf.load_model_from_string(worlds.SENSORS, dtype=torch.float64).to("cuda")
            with plain_versions():
                d64 = fwd.step(m64, data_as(d, torch.float64))
            for name, got, want, x64 in (
                    ("qacc", dk.qacc, dp.qacc, d64.qacc),
                    ("acc, frc, trq", dk.sensordata[:, acc], dp.sensordata[:, acc],
                     d64.sensordata[:, acc])):
                errs[f"{name}_1"] = held_stage("SENSORS", name, got, want, x64)
            active = dk.contact.dist < dk.contact.includemargin
            rng = dk.sensordata[:, m.sensor_adr[m.sensor("range")]]
            print(f"[SENSORS vs plain] {SENSORS_NENV} envs: active contacts per env mean "
                  f"{float(active.sum(1).float().mean()):.3f}, envs in contact "
                  f"{int(active.any(1).sum())}; rangefinder misses {int((rng == -1).sum())}",
                  flush=True)
            assert bool(active.any()) and bool((rng == -1).any()) and bool((rng > 0).any())
    errs["qpos_5"] = close("SENSORS qpos 5 steps", dk.qpos, dp.qpos, 0.0, 1e-4)
    assert all(torch.isfinite(t).all() for t in (dk.qpos, dk.qvel, dk.sensordata))
    print(f"[SENSORS vs plain] nenv={SENSORS_NENV}: " + " ".join(
        f"{k}={v:.3e}" for k, v in errs.items()), flush=True)
    (H, g), = captured_solves(m, d, plan)
    assert H.shape[-1] == 7
    errs["k1"] = close("K1 SENSORS mass matrix vs plain", linalg_tpu.psd_solve(H, g),
                       linalg_tpu.psd_solve_plain(H, g), 1e-4, 1e-5)
    print(f"[K1 SENSORS] mass matrix ({SENSORS_NENV}, 7, 7) at G={kernels.psd_width(7)}: "
          f"vs plain max abs {errs['k1']:.3e}", flush=True)
    return m, plan, d, max(errs.values())


def held_stage(world, name, got, want, x64):
    """got (kernels) against want (plain versions) at rtol / atol 1e-3; where
    envs are past it, both are held against float64 (x64) instead, by
    held_against_f64 in units of 1e-3 + 1e-3 |x64|. Prints both readings;
    returns the max abs difference to plain."""
    unit = 1e-3 + 1e-3 * x64.abs()
    over = ((got - want).abs() > 1e-3 + 1e-3 * want.abs()).any(-1)
    e_got, e_plain = (((x.double() - x64).abs() / unit).amax(-1) for x in (got, want))
    print(f"[{world} vs plain] {name} 1 step: {int(over.sum())} envs past rtol / atol 1e-3 "
          f"of plain; against float64 in units of 1e-3 + 1e-3 |x64|, worst env "
          f"{float(e_got.max()):.3f}, 99th percentile {float(torch.quantile(e_got, 0.99)):.3f} "
          f"(plain float32: {float(e_plain.max()):.3f}, "
          f"{float(torch.quantile(e_plain, 0.99)):.3f})", flush=True)
    if bool(over.any()):
        print(f"[{world} vs plain] {name}: the envs past it, against float64 "
              f"{[round(float(e_got[i]), 3) for i in torch.nonzero(over).flatten()]} (plain "
              f"{[round(float(e_plain[i]), 3) for i in torch.nonzero(over).flatten()]})",
              flush=True)
        held_against_f64(f"{world} {name} 1 step", got, want, x64, unit)
    else:
        close(f"{world} {name} 1 step", got, want, 1e-3, 1e-3)
    return float((got - want).abs().max())


def sensors_main_path():
    """MujocoServer(SENSORS, nenv=SENSORS_NENV) on the default device with a
    SensorsPlugin and bench_config3's three noise models, SENSORS_STEPS
    steps from the model's start: K1 and K2 once per step each, K3 never;
    every reading finite, the range -1 or positive, probe_pos the probe's
    xpos; over all envs the acc noise's mean within 4 sigma / sqrt(N) of 0
    and its std within 5% of 0.01. Then reset keeps the models, and an
    eval-mode plugin withholds the ground truth."""
    zero_counts()
    t0 = time.perf_counter()
    plugin = SensorsPlugin()
    srv = MujocoServer(worlds.SENSORS, nenv=SENSORS_NENV, plugins=[plugin], seed=5)
    assert srv.device.type == "cuda", f"the server's default device is {srv.device}"
    res = srv.register_noise_models(list(SENSORS_NOISE))
    assert res.success, res.status_message
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    assert srv.step(SENSORS_STEPS).success
    torch.cuda.synchronize()
    t_step = time.perf_counter() - t1
    launches = {"psd_solve": kernels.psd_solve.launches,
                "newton_solve": kernels.newton_solve.launches,
                "step_fused": kernels.step_fused.launches}
    assert launches == {"psd_solve": SENSORS_STEPS, "newton_solve": SENSORS_STEPS,
                        "step_fused": 0}, launches
    assert kernels.psd_solve.width == kernels.psd_width(7), kernels.psd_solve.width
    m, d = srv.m, srv.d
    i, _ = srv._plugin_of(SensorsPlugin)
    ps = srv.pstates[i]
    noisy, gt = ps["noisy"], ps["gt"]
    assert noisy.shape == gt.shape == (SENSORS_NENV, 28)
    assert bool(torch.isfinite(noisy).all()) and bool(torch.isfinite(gt).all())
    rng = gt[:, m.sensor_adr[m.sensor("range")]]
    assert bool(((rng == -1) | (rng > 0)).all()), "a range neither -1 nor positive"
    adr = m.sensor_adr[m.sensor("probe_pos")]
    assert torch.equal(gt[:, adr:adr + 3], d.xpos[:, m.body("probe")]), "probe_pos != xpos"
    delta = (noisy - gt)[:, sensor_cols(m, ("acc",))].double().flatten()
    mean, std, n = float(delta.mean()), float(delta.std()), delta.numel()
    assert abs(mean) < 4 * 0.01 / n ** 0.5, f"acc noise mean {mean} over {n} samples"
    assert abs(std / 0.01 - 1) < 0.05, f"acc noise std {std}"
    single = srv.sensor_outputs(env_id=SENSORS_NENV - 1)
    assert single[0].shape == (28,) and single[1] is not None
    z = d.qpos[:, 2]
    print(f"[SENSORS main path] server step({SENSORS_STEPS}) of SENSORS x {SENSORS_NENV} "
          f"with the sensors plugin and 3 noise models: {t_step:.3f}s wall, "
          f"{SENSORS_NENV * SENSORS_STEPS / t_step:.4g} env-steps/s; launches {launches}; "
          f"acc noise over {n} samples mean {mean:.3e} std {std:.5f}; range misses "
          f"{int((rng == -1).sum())}; probe z min {float(z.min()):.5f} max "
          f"{float(z.max()):.5f}", flush=True)

    kept = [ps[k].clone() for k in ("mean", "std", "enabled")]
    assert srv.reset().success
    ps = srv.pstates[i]
    assert all(torch.equal(a, ps[k]) for a, k in zip(kept, ("mean", "std", "enabled")))
    assert float(ps["noisy"].abs().max()) == 0.0 and srv.step(2).success
    ev = MujocoServer(worlds.SENSORS, nenv=SENSORS_NENV,
                      plugins=[SensorsPlugin({"eval_mode": True})])
    assert ev.step(2).success
    noisy1, gt1 = ev.sensor_outputs(env_id=0)
    assert gt1 is None and np.isfinite(noisy1).all()
    print(f"[SENSORS main path] reset keeps the noise models; eval mode withholds the "
          f"ground truth; phase {time.perf_counter() - t0:.1f}s", flush=True)
    return launches, t_step


def sensors_timing(card, m, plan, d):
    """fwd.step of SENSORS at SENSORS_NENV envs by CUDA events with the
    kernels and with their plain versions; K1 at n = 7 on the mass matrix
    and K2 on the step's rows (nv 7, 24 rows): by graph replay, one call at
    a time, the plain versions, bounds, and for K1 cholesky +
    cholesky_solve."""
    def run(nsteps):
        dd = d
        for _ in range(nsteps):
            dd = fwd.step(m, dd, plan)

    out = {"step_ms": time_ms(lambda: run(50), 1, warmup=1) / 50}
    with plain_versions():
        out["step_plain_ms"] = time_ms(lambda: run(3), 1, warmup=1) / 3
    print(f"[SENSORS timing] fwd.step nenv={SENSORS_NENV}: {out['step_ms']:.4f} ms/step with "
          f"the kernels, {out['step_plain_ms']:.4f} ms/step with their plain versions "
          f"({card})", flush=True)
    (H, g), = captured_solves(m, d, plan)
    k1 = {"graph_ms": graph_ms(lambda: linalg_tpu.psd_solve(H, g), 200),
          "ms": time_ms(lambda: linalg_tpu.psd_solve(H, g), 100),
          "plain_ms": time_ms(lambda: linalg_tpu.psd_solve_plain(H, g), 10),
          "library_ms": time_ms(lambda: library_solve(H, g), 100),
          "bound": k1_bound(SENSORS_NENV, 7), "group": kernels.psd_width(7)}
    print(f"[SENSORS timing] K1 n=7 nenv={SENSORS_NENV} on the mass matrix (G={k1['group']}): "
          f"{k1['graph_ms']:.4f} ms by graph replay, {k1['ms']:.4f} one call at a time; "
          f"plain {k1['plain_ms']:.4f} ms; cholesky + cholesky_solve {k1['library_ms']:.4f} "
          f"ms; bound {k1['bound'][0]:.5f} ms ({k1['bound'][1]}) ({card})", flush=True)
    static, args = rows_problem(m, d, seed=11)
    assert (static[2], len(static[0])) == (7, 24), (static[2], len(static[0]))
    k2_compare("SENSORS rows", static, args, 1e-3)
    k2 = k2_timing(card, "SENSORS rows", static, args)
    return out, k1, k2


# ---------------------------------------------------------------------------
# ARM7: mocap, the weld's rows, servos, the mocap and ros_control plugins, the
# general Newton with K1 at n = 7
# ---------------------------------------------------------------------------

def arm7_data(m, nenv, seed):
    """The port's batch of tests/torch_problems.arm7_states on the card: the
    weld on in every env but the first, its target 0.1-0.3 m off, one
    hinge per env past a limit, random ctrl (some past its range)."""
    m64 = mjcf.load_model_from_string(worlds.ARM7)
    qpos, qvel, ctrl, mpos, mquat, active = arm7_states(m64, nenv, seed)
    f32 = [torch.from_numpy(a.astype(np.float32)).cuda()
           for a in (qpos, qvel, ctrl, mpos, mquat)]
    return fwd.make_data(m, nenv).replace(
        qpos=f32[0], qvel=f32[1], ctrl=f32[2], mocap_pos=f32[3], mocap_quat=f32[4],
        eq_active=torch.from_numpy(active).cuda())


def arm7_vs_plain(card):
    """ARM7 at ARM7_NENV envs from seeded states (arm7_data): 1 and 5 steps
    with the kernels and with their plain versions at general_vs_plain's
    tolerances for qpos and qvel; qacc at rtol / atol 1e-3 of plain, or,
    in envs past it, both held against the float64 step (held_stage); K1
    launches of the kernels' step: the mass matrix, Euler's damping solve
    and one per Newton trip of the batch. Then K1 at n = 7 on every solve
    of one step against plain (1e-2) and against float64 by
    held_against_f64 in units of 1e-5 + 1e-4 |x64|, as HUMANOID's."""
    m = mjcf.load_model_from_string(worlds.ARM7, dtype=torch.float32).to("cuda")
    plan = fwd.make_plan(m)
    assert plan == fwd.GeneralPlan() and (m.nv, m.nmocap, m.neq) == (7, 1, 1)
    d = arm7_data(m, ARM7_NENV, seed=13)
    e = humanoid_rows(m, d)
    assert len(e.kinds) == 100 and e.kinds[:6] == ("eq",) * 6
    weld, lim = e.active[:, :6].all(1), e.active[:, 6:13].sum(1).float()
    con = e.con_active.sum(1).float()
    print(f"[ARM7] {ARM7_NENV} seeded envs: 100 rows; weld on in {int(weld.sum())}, its "
          f"residual {float(e.pos[1:, :3].norm(dim=-1).min()):.3f}-"
          f"{float(e.pos[1:, :3].norm(dim=-1).max()):.3f} m; active limit rows per env mean "
          f"{float(lim.mean()):.2f}; active contacts per env mean {float(con.mean()):.2f}, "
          f"envs in contact {int((con > 0).sum())}", flush=True)
    assert int(weld.sum()) == ARM7_NENV - 1 and float(lim.sum()) > 0
    dk = dp = d
    errs = {}
    for k in range(5):
        zero_counts()
        with newton_trips() as lk:
            dk = fwd.step(m, dk, plan)
        torch.cuda.synchronize()
        launches = (kernels.psd_solve.launches, kernels.newton_solve.launches,
                    kernels.step_fused.launches)
        assert launches == (2 + lk[0][1], 0, 0), f"launches {launches}, trips {lk[0][1]}"
        with plain_versions(), newton_trips() as lp:
            dp = fwd.step(m, dp, plan)
        torch.cuda.synchronize()
        if k == 0:
            errs["qpos_1"] = close("ARM7 qpos 1 step", dk.qpos, dp.qpos, 1e-5, 1e-6)
            errs["qvel_1"] = close("ARM7 qvel 1 step", dk.qvel, dp.qvel, 1e-4, 1e-4)
            m64 = mjcf.load_model_from_string(worlds.ARM7, dtype=torch.float64).to("cuda")
            with plain_versions():
                x64 = fwd.step(m64, data_as(d, torch.float64)).qacc
            errs["qacc_1"] = held_stage("ARM7", "qacc", dk.qacc, dp.qacc, x64)
            print(f"[ARM7 vs plain] step 1: K1 launches {launches[0]} (2 + the batch's "
                  f"{lk[0][1]} Newton trips; plain {lp[0][1]}), K2 {launches[1]}, K3 "
                  f"{launches[2]}", flush=True)
    errs["qpos_5"] = close("ARM7 qpos 5 steps", dk.qpos, dp.qpos, 0.0, 1e-4)
    assert torch.isfinite(dk.qpos).all() and torch.isfinite(dk.qvel).all()
    print(f"[ARM7 vs plain] nenv={ARM7_NENV}: " + " ".join(
        f"{k}={v:.3e}" for k, v in errs.items()), flush=True)

    err = 0.0
    seen = captured_solves(m, d, plan)
    labels = (["mass matrix"] + [f"Hessian of Newton trip {i}" for i in range(1, len(seen) - 1)]
              + ["Euler's damping solve"])
    for label, (H, g) in zip(labels, seen):
        assert H.shape[-1] == 7
        x = linalg_tpu.psd_solve(H, g)
        ref = linalg_tpu.psd_solve_plain(H, g)
        x64 = torch.linalg.solve(H.double(), g.double()[..., None])[..., 0]
        torch.cuda.synchronize()
        e_abs = close(f"K1 ARM7 {label} vs plain", x, ref, 1e-2, 1e-2)
        held = held_against_f64(f"K1 ARM7 {label}", x, ref, x64, 1e-5 + 1e-4 * x64.abs())
        print(f"[K1 ARM7] {label} ({ARM7_NENV}, 7, 7) at G={kernels.psd_width(7)}: vs plain "
              f"max abs {e_abs:.3e} (max |x| {float(ref.abs().max()):.3e}); vs float64 in "
              f"units of 1e-5 + 1e-4 |x64|, worst env {held[1]:.3f}, 99th percentile "
              f"{held[3]:.3f} (plain float32: {held[0]:.3f}, {held[2]:.3f})", flush=True)
        err = max(err, e_abs)
    return m, plan, d, max(max(errs.values()), err)


def arm7_main_path():
    """MujocoServer(ARM7, nenv=ARM7_NENV) on the default device as BASELINE
    config 4 runs it: MocapPlugin and RosControlPlugin (POSITION_PID on
    j4-j6, commands set), the weld switched on through
    set_eq_constraint_parameters (anchored at the end-effector site, no
    relative pose), bench_config4's ctrl, set_mocap_state moving the
    target 0.59 m from the site, ARM7_STEPS // 2 steps, then another move
    (env 0 its own) and ARM7_STEPS // 2 more: K1 twice per step (mass
    matrix, damping) and once per Newton trip of the batch, K2 and K3
    never; finite; the site's distance to its target falls below 0.05 m
    after each move in every env."""
    zero_counts()
    t0 = time.perf_counter()
    rc = RosControlPlugin({"joints": {j: {"method": "POSITION_PID",
                                          "pid": [20.0, 1.0, 0.5, 5.0],
                                          "effort_limit": 20.0}
                                      for j in ("j4", "j5", "j6")}})
    srv = MujocoServer(worlds.ARM7, nenv=ARM7_NENV, plugins=[MocapPlugin(), rc])
    assert srv.device.type == "cuda", f"the server's default device is {srv.device}"
    assert [p.loaded for p in srv.registry.plugins] == [True, True]
    p = srv.get_eq_constraint_parameters("ee_target")
    p.active, p.anchor = True, np.array([0.0, 0.0, 0.1])
    p.relpose = Pose(np.zeros(3), np.array([1.0, 0, 0, 0]))
    assert srv.set_eq_constraint_parameters(p).success
    assert srv.set_ctrl(np.array(ARM7_CTRL)).success
    i, _ = srv._plugin_of(RosControlPlugin)
    srv.pstates = tuple(rc.set_commands(ps, [0.2, -0.3, 0.1]) if k == i else ps
                        for k, ps in enumerate(srv.pstates))
    site = srv.m.site("ee_site")

    def distance(target):
        xpos = smooth.fwd_position_smooth(srv.m, srv.d).site_xpos[:, site]
        return (xpos.double() - target).norm(dim=-1)

    targets = torch.tensor([0.35, 0.15, 0.85], dtype=torch.float64,
                           device="cuda").expand(ARM7_NENV, 3).clone()
    assert srv.set_mocap_state(MocapState(["mocap_target"], [Pose(targets[0].cpu().numpy())]))\
        .success
    moves, t_step, log = [], 0.0, []
    for move in range(2):
        before = distance(targets)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        with newton_trips() as trips:
            assert srv.step(ARM7_STEPS // 2).success
        torch.cuda.synchronize()
        t_step += time.perf_counter() - t1
        log += trips
        after = distance(targets)
        moves.append((float(before.min()), float(before.max()), float(after.max())))
        assert float(after.max()) < 0.05 and bool((after < before).all()), moves[-1]
        if move == 0:
            targets[:] = torch.tensor([0.2, -0.3, 0.7], dtype=torch.float64)
            targets[0] = torch.tensor([-0.3, 0.25, 0.75], dtype=torch.float64)
            assert srv.set_mocap_state(MocapState(
                ["mocap_target"], [Pose(targets[1].cpu().numpy())])).success
            assert srv.set_mocap_state(MocapState(
                ["mocap_target"], [Pose(targets[0].cpu().numpy())], env_id=0)).success
    ran = sum(r for _, r, _ in log)
    syncs = sum(s for _, _, s in log)
    launches = {"psd_solve": kernels.psd_solve.launches,
                "newton_solve": kernels.newton_solve.launches,
                "step_fused": kernels.step_fused.launches}
    assert len(log) == ARM7_STEPS, f"{len(log)} Newton solves in {ARM7_STEPS} steps"
    assert launches == {"psd_solve": 2 * ARM7_STEPS + ran, "newton_solve": 0,
                        "step_fused": 0}, \
        f"launches {launches}, {ARM7_STEPS} steps x 2 + {ran} Newton trips"
    assert kernels.psd_solve.width == kernels.psd_width(7), kernels.psd_solve.width
    d = srv.d
    states = [t for ps in srv.pstates for t in ps.values() if t.is_floating_point()]
    assert all(bool(torch.isfinite(t).all()) for t in (
        d.qpos, d.qvel, d.qacc, d.qfrc_constraint, d.efc_force_contact, d.qfrc_applied,
        *states)), "a non-finite value in the state or the plugins' state"
    per_env = torch.cat([t for t, _, _ in log]).float()
    print(f"[ARM7 main path] server step({ARM7_STEPS}) of ARM7 x {ARM7_NENV} with the mocap "
          f"and ros_control plugins and the weld on: {t_step:.3f}s wall, "
          f"{ARM7_NENV * ARM7_STEPS / t_step:.4g} env-steps/s; launches {launches} a run, per "
          f"step K1 {launches['psd_solve'] / ARM7_STEPS:.3f} (2 + the batch's "
          f"{ran / ARM7_STEPS:.3f} Newton trips), K2 "
          f"{launches['newton_solve'] / ARM7_STEPS:.3f}, K3 "
          f"{launches['step_fused'] / ARM7_STEPS:.3f}; Newton trips per env and step mean "
          f"{float(per_env.mean()):.3f}; host syncs per step {syncs / ARM7_STEPS:.3f}; "
          f"end-effector site to target: {moves[0][0]:.4f}-{moves[0][1]:.4f} m before, "
          f"{moves[0][2]:.5f} m at most after the first move, {moves[1][0]:.4f}-"
          f"{moves[1][1]:.4f} m before and {moves[1][2]:.5f} after the second; phase "
          f"{time.perf_counter() - t0:.1f}s", flush=True)
    return launches["psd_solve"], t_step, float(per_env.mean()), ran / ARM7_STEPS


def arm7_timing(card, m, plan, d):
    """fwd.step of the seeded ARM7 states at ARM7_NENV envs by CUDA events
    with the kernels and with their plain versions; K1 at n = 7 on the first
    Newton Hessian of a step by graph replay, held against the plain
    version first (1e-2), beside its bound, one call at a time, the plain
    version and cholesky + cholesky_solve."""
    def run(nsteps):
        dd = d
        for _ in range(nsteps):
            dd = fwd.step(m, dd, plan)

    out = {"step_ms": time_ms(lambda: run(20), 1, warmup=1) / 20}
    with plain_versions():
        out["step_plain_ms"] = time_ms(lambda: run(3), 1, warmup=1) / 3
    print(f"[ARM7 timing] fwd.step nenv={ARM7_NENV}: {out['step_ms']:.4f} ms/step with the "
          f"kernels, {out['step_plain_ms']:.4f} ms/step with their plain versions ({card})",
          flush=True)
    H, g = captured_solves(m, d, plan)[1]
    close(f"K1 ARM7 Hessian nenv={ARM7_NENV}", linalg_tpu.psd_solve(H, g),
          linalg_tpu.psd_solve_plain(H, g), 1e-2, 1e-2)
    out.update(graph_ms=graph_ms(lambda: linalg_tpu.psd_solve(H, g), 200),
               ms=time_ms(lambda: linalg_tpu.psd_solve(H, g), 100),
               plain_ms=time_ms(lambda: linalg_tpu.psd_solve_plain(H, g), 10),
               library_ms=time_ms(lambda: library_solve(H, g), 100),
               bound=k1_bound(ARM7_NENV, 7), group=kernels.psd_width(7))
    print(f"[ARM7 timing] K1 n=7 nenv={ARM7_NENV} on an ARM7 Newton Hessian "
          f"(G={out['group']}): {out['graph_ms']:.4f} ms by graph replay, {out['ms']:.4f} one "
          f"call at a time; plain {out['plain_ms']:.4f} ms; cholesky + cholesky_solve "
          f"{out['library_ms']:.4f} ms; bound {out['bound'][0]:.5f} ms ({out['bound'][1]}) "
          f"({card})", flush=True)
    return out


# ---------------------------------------------------------------------------
# contact compaction (BASELINE config 5 and its humanoid bench): con_topk,
# pair_topk, the settling transient; the nv > 96 route; C7
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def count_solves():
    """Record the n of every library Cholesky solve (linalg_tpu.chol_solve)
    of the general path inside the block."""
    log, saved = [], linalg_tpu.chol_solve
    linalg_tpu.chol_solve = lambda H, g: log.append(H.shape[-1]) or saved(H, g)
    try:
        yield log
    finally:
        linalg_tpu.chol_solve = saved


def solver_rows(e):
    """The rows the general Newton iterates on: the simple rows and every
    cone group, compacted or not."""
    _, simple, cones = solver._views(e)
    return simple.J.shape[1] + sum(g.J.shape[1] * g.dim for g in cones)


def carried(m, d):
    """d's state (qpos, qvel, warm start, ctrl, time) in a new batch of model
    m (whose contact layout may differ: pair_topk)."""
    return fwd.make_data(m, d.qpos.shape[0]).replace(**{
        f: getattr(d, f).clone() for f in ("time", "qpos", "qvel", "qacc_warmstart", "ctrl")})


def compact_vs_plain(card, label, xml, d, nrows, hold_qacc=None, **topk):
    """The compacted model (xml with topk) from the settled state d: its
    solver rows (nrows, asserted); 1 and 5 steps with the kernels against
    their plain versions at general_vs_plain's tolerances (qacc at rtol /
    atol 1e-3, or held against the float64 step by hold_qacc); K1 launches
    1 or 2 + the batch's Newton trips, K2 and K3 none; one step against
    the uncompacted model's step with the kernels from the same state at
    general_vs_plain's tolerances; then K1 on the compacted Newton
    Hessians of one step against plain (1e-2) and float64
    (held_against_f64, units 1e-5 + 1e-4 |x64|). Returns (m, plan, the
    state, the max abs error, K1's errors)."""
    m = mjcf.load_model_from_string(xml, dtype=torch.float32, **topk).to("cuda")
    m0 = mjcf.load_model_from_string(xml, dtype=torch.float32).to("cuda")
    plan = fwd.make_plan(m)
    assert plan == fwd.GeneralPlan()
    d = carried(m, d)
    e = humanoid_rows(m, d)
    rows = solver_rows(e)
    act = e.con_active.sum(1)
    assert rows == nrows and any(b is not None for b in e.cb), \
        f"{label}: {rows} solver rows, expected {nrows}"
    fixed = 2 if m.has_damping else 1
    dk = dp = d
    errs = {}
    for k in range(5):
        zero_counts()
        with newton_trips() as lk:
            dk = fwd.step(m, dk, plan)
        torch.cuda.synchronize()
        launches = (kernels.psd_solve.launches, kernels.newton_solve.launches,
                    kernels.step_fused.launches)
        assert launches == (fixed + lk[0][1], 0, 0), f"{label} launches {launches}"
        with plain_versions(), newton_trips() as lp:
            dp = fwd.step(m, dp, plan)
        torch.cuda.synchronize()
        if k == 0:
            errs["qpos_1"] = close(f"{label} qpos 1 step", dk.qpos, dp.qpos, 1e-5, 1e-6)
            errs["qvel_1"] = close(f"{label} qvel 1 step", dk.qvel, dp.qvel, 1e-4, 1e-4)
            if hold_qacc is None:
                errs["qacc_1"] = close(f"{label} qacc 1 step", dk.qacc, dp.qacc, 1e-3, 1e-3)
            else:
                m64 = mjcf.load_model_from_string(xml, dtype=torch.float64,
                                                  **topk).to("cuda")
                with plain_versions():
                    x64 = fwd.step(m64, data_as(d, torch.float64)).qacc
                errs["qacc_1"] = hold_qacc(dk.qacc, dp.qacc, x64, lk[0][0], lp[0][0])
            with newton_trips() as l0:
                d0 = fwd.step(m0, carried(m0, d), fwd.make_plan(m0))
            torch.cuda.synchronize()
            unc = {f: close(f"{label} {f} vs uncompacted", getattr(dk, f), getattr(d0, f),
                            rt, at)
                   for f, rt, at in (("qpos", 1e-5, 1e-6), ("qvel", 1e-4, 1e-4))}
            if hold_qacc is None:
                unc["qacc"] = close(f"{label} qacc vs uncompacted", dk.qacc, d0.qacc,
                                    1e-3, 1e-3)
            else:     # the uncompacted step in the plain version's place
                unc["qacc"] = hold_qacc(dk.qacc, d0.qacc, x64, lk[0][0], l0[0][0],
                                        label=f"{label} vs uncompacted")
            trips1 = lk[0][1]
    errs["qpos_5"] = close(f"{label} qpos 5 steps", dk.qpos, dp.qpos, 0.0, 1e-4)
    assert torch.isfinite(dk.qpos).all() and torch.isfinite(dk.qvel).all()
    print(f"[{label} vs plain] {d.qpos.shape[0]} envs, {rows} solver rows of "
          f"{len(e.kinds)}; active contact slots per env mean "
          f"{float(act.float().mean()):.2f} max {int(act.max())}: "
          + " ".join(f"{k}={v:.3e}" for k, v in errs.items())
          + f"; K1 launches a step {fixed} + the batch's {trips1} Newton trips; vs the "
          f"uncompacted step: " + " ".join(f"{k}={v:.3e}" for k, v in unc.items()),
          flush=True)

    k1 = []
    seen = captured_solves(m, d, plan)
    seen = seen[1:len(seen) - (fixed - 1)]           # the Newton trips' Hessians
    for i, (H, g) in enumerate(seen):
        x = linalg_tpu.psd_solve(H, g)
        ref = linalg_tpu.psd_solve_plain(H, g)
        x64 = torch.linalg.solve(H.double(), g.double()[..., None])[..., 0]
        torch.cuda.synchronize()
        e_abs = close(f"K1 {label} Hessian {i + 1} vs plain", x, ref, 1e-2, 1e-2)
        held = held_against_f64(f"K1 {label} Hessian {i + 1}", x, ref, x64,
                                1e-5 + 1e-4 * x64.abs())
        k1.append(e_abs)
        print(f"[K1 {label}] compacted Hessian of Newton trip {i + 1} {tuple(H.shape)}: vs "
              f"plain max abs {e_abs:.3e}; vs float64 in units of 1e-5 + 1e-4 |x64|, "
              f"worst env {held[1]:.3f}, 99th percentile {held[3]:.3f} (plain float32: "
              f"{held[0]:.3f}, {held[2]:.3f}) ({card})", flush=True)
    return m, plan, dk, max(max(errs.values()), max(unc.values())), max(k1)


def compact_server(label, xml, nenv, nsteps, fixed, overflow=False, start=None,
                   in_bin=True, **topk):
    """MujocoServer(xml, nenv, **topk) on the default device, nsteps steps
    (from `start`'s (qpos, qvel) if given, else the model's start), one
    step(1) call at a time when `overflow` (each step's
    broadphase.candidate_overflow summed on the card, asserted 0; the wall
    time then includes it), else one step(nsteps): K1 `fixed` + the batch's
    Newton trips a step, K2 and K3 none; finite; on a pile every body above
    the floor (z > -0.02) and, with in_bin, inside the walls (|x|, |y| <
    0.6). Returns (K1 launches, wall seconds, trips per env and step, the
    batch's trips a step, the most active slots of an env (with `start`),
    the bodies outside the walls)."""
    zero_counts()
    t0 = time.perf_counter()
    srv = MujocoServer(xml, nenv=nenv, unpause=False, **topk)
    assert srv.device.type == "cuda"
    if start is not None:
        srv.d = srv.d.replace(qpos=start[0].clone(), qvel=start[1].clone())
    dropped = torch.zeros((), dtype=torch.int64, device="cuda")
    most = torch.zeros((), dtype=torch.int64, device="cuda")
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    with newton_trips() as log:
        if overflow or start is not None:
            for _ in range(nsteps):
                assert srv.step(1).success
                if overflow:
                    dropped += broadphase.candidate_overflow(srv.m, srv.d).sum()
                else:
                    c = srv.d.contact
                    most = torch.maximum(most, (c.dist < c.includemargin).sum(1).max())
        else:
            assert srv.step(nsteps).success
    torch.cuda.synchronize()
    t_step = time.perf_counter() - t1
    ran = sum(r for _, r, _ in log)
    launches = {"psd_solve": kernels.psd_solve.launches,
                "newton_solve": kernels.newton_solve.launches,
                "step_fused": kernels.step_fused.launches}
    assert len(log) == nsteps
    assert launches == {"psd_solve": fixed * nsteps + ran, "newton_solve": 0,
                        "step_fused": 0}, f"{label} launches {launches}, trips {ran}"
    assert int(dropped) == 0, f"{label}: the broadphase dropped {int(dropped)} overlapping pairs"
    d = srv.d
    assert all(torch.isfinite(t).all() for t in (d.qpos, d.qvel, d.qacc,
                                                 d.efc_force_contact))
    where, outside = "", 0
    if srv.m.nq == 84:
        pos = d.qpos.reshape(nenv, 12, 7)[..., :3]
        outside = int((pos[..., :2].abs() >= 0.6).any(-1).sum())
        assert float(pos[..., 2].min()) > -0.02, f"{label}: a body fell through"
        assert outside == 0 or not in_bin, f"{label}: {outside} bodies left the bin"
        where = (f"z min {float(pos[..., 2].min()):.4f}, |x|,|y| max "
                 f"{float(pos[..., :2].abs().max()):.4f}, bodies outside the walls "
                 f"{outside} of {12 * nenv}; ")
    per_env = torch.cat([t for t, _, _ in log]).float()
    active = d.contact.dist < d.contact.includemargin
    st = srv.get_solver_stats(0)
    print(f"[{label} main path] server step({nsteps}) x {nenv}"
          f"{' one step(1) at a time with candidate_overflow' if overflow else ''}: "
          f"{t_step:.3f}s wall, {nenv * nsteps / t_step:.4g} env-steps/s; launches {launches} "
          f"(K1 = {fixed} x {nsteps} + {ran} Newton trips: {launches['psd_solve'] / nsteps:.3f} "
          f"a step); Newton trips per env and step mean {float(per_env.mean()):.3f}, the "
          f"batch's {ran / nsteps:.3f}; {where}active slots per env now mean "
          f"{float(active.sum(1).float().mean()):.2f} max {int(active.sum(1).max())}"
          f"{', most in any env and step ' + str(int(most)) if start is not None else ''}"
          f"{'; overflow 0 on every step' if overflow else ''}; get_solver_stats(0) "
          f"nefc {st['nefc']}, realized trips {st['solver_iterations_realized']}, overflow "
          f"{st['broadphase_overflow']}; phase {time.perf_counter() - t0:.1f}s", flush=True)
    return (launches["psd_solve"], t_step, float(per_env.mean()), ran / nsteps, int(most),
            outside)


def settling(card):
    """PILE dropped as bench.py's config5_settling drops it (the first body
    0.6-0.8 m up, every dof at 0.5 N(0, 1)), con_topk=64, 512 envs at
    config 5's settings: the server's SETTLE_STEPS steps of the transient
    one at a time (the most active slots of any env and step printed: past
    64 the deepest 64 win), finite, every body above the floor; the drop's
    speeds throw bodies over the 0.3 m walls, so the bodies outside the bin
    are counted, beside the same drop without con_topk; then one step from
    the state after SETTLE_STEPS // 2 steps with the kernels against their
    plain versions at general_vs_plain's tolerances."""
    m = mjcf.load_model_from_string(PILE5, dtype=torch.float32).to("cuda")
    rng = np.random.default_rng(17)
    qpos = m.qpos0.expand(PILE_NENV, -1).clone()
    qpos[:, 2] = torch.from_numpy(0.6 + 0.2 * rng.uniform(size=PILE_NENV)).float().cuda()
    qvel = torch.from_numpy(0.5 * rng.normal(size=(PILE_NENV, m.nv))).float().cuda()
    out = compact_server("PILE settling con_topk=64", PILE5, PILE_NENV, SETTLE_STEPS, 1,
                         start=(qpos, qvel), in_bin=False, con_topk=64)
    unc = compact_server("PILE settling uncompacted", PILE5, PILE_NENV, SETTLE_STEPS, 1,
                         start=(qpos, qvel), in_bin=False)
    mk = mjcf.load_model_from_string(PILE5, dtype=torch.float32, con_topk=64).to("cuda")
    plan = fwd.make_plan(mk)
    d = fwd.make_data(mk, PILE_NENV).replace(qpos=qpos, qvel=qvel)
    for _ in range(SETTLE_STEPS // 2):
        d = fwd.step(mk, d, plan)
    dk = fwd.step(mk, d, plan)
    with plain_versions():
        dp = fwd.step(mk, d, plan)
    torch.cuda.synchronize()
    errs = {f: close(f"PILE settling {f} 1 step", getattr(dk, f), getattr(dp, f), rt, at)
            for f, rt, at in (("qpos", 1e-5, 1e-6), ("qvel", 1e-4, 1e-4),
                              ("qacc", 1e-3, 1e-3))}
    act = (d.contact.dist < d.contact.includemargin).sum(1)
    print(f"[PILE settling vs plain] after {SETTLE_STEPS // 2} steps (active slots per env "
          f"mean {float(act.float().mean()):.2f} max {int(act.max())}): "
          + " ".join(f"{k}={v:.3e}" for k, v in errs.items()) + f" ({card})", flush=True)
    return out + (unc[5],), max(errs.values())


def wide_world(card):
    """17 of PILE's bodies (tests/torch_problems.PILE17, nv 102) with
    con_topk=64 at 256 seeded heaps settled WIDE_SETTLE steps on the card:
    K1 launches 0, every solve the library Cholesky's (mass matrix and each
    Newton trip: n = 102, counted over the settling); one float32 step of
    the settled heaps against the float64 step (qpos rtol / atol 1e-5; qvel
    rtol / atol 1e-3, which holds qacc to 0.5 through h = 0.002; qacc
    printed in units of 1e-3 + 1e-3 |x64|); fwd.step ms; psd_solve still
    refuses n = 102 on the card."""
    m = mjcf.load_model_from_string(PILE17, dtype=torch.float32, con_topk=64).to("cuda")
    m64 = mjcf.load_model_from_string(PILE17, dtype=torch.float64, con_topk=64).to("cuda")
    plan = fwd.make_plan(m)
    assert plan == fwd.GeneralPlan() and m.nv == 102
    qpos, qvel = (torch.from_numpy(a) for a in pile_heap(m64, WIDE_NENV, seed=21))
    d = fwd.make_data(m, WIDE_NENV).replace(qpos=qpos.float().cuda(), qvel=qvel.float().cuda())
    zero_counts()
    with count_solves() as solves, newton_trips() as log:
        for _ in range(WIDE_SETTLE):
            d = fwd.step(m, d, plan)
    torch.cuda.synchronize()
    assert torch.isfinite(d.qpos).all() and torch.isfinite(d.qvel).all()
    ran = sum(r for _, r, _ in log)
    assert kernels.psd_solve.launches == 0 and kernels.newton_solve.launches == 0
    assert solves == [102] * (WIDE_SETTLE + ran), f"{len(solves)} library solves"
    dk = fwd.step(m, d, plan)
    x64 = fwd.step(m64, data_as(d, torch.float64))
    torch.cuda.synchronize()
    errs = {f: close(f"nv 102 {f} vs float64", getattr(dk, f).double(), getattr(x64, f),
                     tol, tol)
            for f, tol in (("qpos", 1e-5), ("qvel", 1e-3))}
    units = ((dk.qacc.double() - x64.qacc).abs() / (1e-3 + 1e-3 * x64.qacc.abs())).amax(-1)
    errs["qacc"] = float((dk.qacc.double() - x64.qacc).abs().max())
    act = (dk.contact.dist < dk.contact.includemargin).sum(1)
    assert int(act.min()) > 0 and float(dk.qfrc_constraint.abs().max()) > 0
    t = time_ms(lambda: fwd.step(m, dk, plan), 5, warmup=1)
    try:
        linalg_tpu.psd_solve(torch.eye(102, device="cuda")[None], torch.zeros(1, 102,
                                                                              device="cuda"))
        raise AssertionError("psd_solve took n = 102 on the card")
    except ValueError:
        pass
    print(f"[nv 102] PILE17 x {WIDE_NENV}, con_topk=64 ({len(humanoid_rows(m, d).kinds)} rows, "
          f"active slots per env mean {float(act.float().mean()):.2f}): {WIDE_SETTLE} steps, "
          f"library solves {len(solves)} ({WIDE_SETTLE} + {ran} Newton trips), K1 launches 0; "
          f"one step vs the float64 step: " + " ".join(f"{k}={v:.3e}" for k, v in errs.items())
          + f", qacc in units of 1e-3 + 1e-3 |x64| worst env {float(units.max()):.3f}, 99th "
          f"percentile {float(units.quantile(0.99)):.3f}; fwd.step {t:.4f} ms; psd_solve refuses "
          f"n = 102 on the card ({card})", flush=True)
    return errs, t


def c7_margins(card):
    """ROADMAP C7 and C7b: K1 against float64 on every solve of one step
    (the mass matrix, the Newton Hessians, Euler's damping solve) of
    HUMANOID's (n = 27, the block kernel), ARM7's (n = 7), SENSORS's (n = 7)
    and PENDULUM's (n = 11, the row kernel) seeded states over C7_SEEDS
    (HUMANOID's root dropped 0.12 m, its feet on the floor), in units of
    1e-5 + 1e-4 |x64|: per solve K1's worst env and its ratio to the plain
    version's (0 where K1 is within one unit), printed, with the largest.
    The solves past WORST_FACTOR, and each world and seed's solve that K1
    misses most (beyond one unit), keep their SAVED_TOP worst envs of K1
    and of plain in chip_smoke_out/k1_c7_envs.npz (`python -m
    tests.test_torch_linalg` runs the JAX package's kernel on them); then
    the largest ratio must be within WORST_FACTOR. Returns it."""
    mh = mjcf.load_model_from_string(HUMANOID, dtype=torch.float32).to("cuda")
    mh64 = mjcf.load_model_from_string(HUMANOID)
    ma = mjcf.load_model_from_string(worlds.ARM7, dtype=torch.float32).to("cuda")
    ms = mjcf.load_model_from_string(worlds.SENSORS, dtype=torch.float32).to("cuda")
    mp = mjcf.load_model_from_string(worlds.PENDULUM, dtype=torch.float32).to("cuda")
    worst, saved = (0.0, ""), {}
    for seed in C7_SEEDS:
        qpos, qvel, ctrl = (torch.from_numpy(a.astype(np.float32)).cuda()
                            for a in humanoid_states(mh64, HUMANOID_NENV, seed, drop=0.12))
        dh = fwd.make_data(mh, HUMANOID_NENV).replace(qpos=qpos, qvel=qvel, ctrl=ctrl)
        qp, vp = pendulum_states(NENV, seed)
        for world, m, d in (("HUMANOID", mh, dh), ("ARM7", ma, arm7_data(ma, ARM7_NENV, seed)),
                            ("SENSORS", ms, sensors_data(ms, SENSORS_NENV, seed)),
                            ("PENDULUM", mp, fwd.make_data(mp, NENV).replace(qpos=qp,
                                                                            qvel=vp))):
            seen = captured_solves(m, d, fwd.make_plan(m))
            ratios, worsts, most = [], [], (1.0, {})
            for k, (H, g) in enumerate(seen):
                x = linalg_tpu.psd_solve(H, g)
                ref = linalg_tpu.psd_solve_plain(H, g)
                x64 = torch.linalg.solve(H.double(), g.double()[..., None])[..., 0]
                unit = 1e-5 + 1e-4 * x64.abs()
                e_k = ((x.double() - x64).abs() / unit).amax(-1)
                e_p = ((ref.double() - x64).abs() / unit).amax(-1)
                r = float(e_k.max()) / max(float(e_p.max()), 1e-30)
                r = r if float(e_k.max()) > 1.0 else 0.0
                ratios.append(r)
                worsts.append(float(e_k.max()))
                if r > WORST_FACTOR or worsts[-1] > most[0]:
                    top = torch.unique(torch.cat([e_k.topk(SAVED_TOP).indices,
                                                  e_p.topk(SAVED_TOP).indices]))
                    envs = {f"{world}_{seed}_{k}_{name}": t[top].cpu().numpy() for name, t in
                            (("H", H), ("g", g), ("x64", x64), ("xk", x), ("xp", ref))}
                    if r > WORST_FACTOR:
                        saved.update(envs)
                    if worsts[-1] > most[0]:
                        most = (worsts[-1], envs)
            saved.update(most[1])
            r = max(ratios)
            if r > worst[0]:
                worst = (r, f"{world} seed {seed}, solve {ratios.index(r)} of {len(seen)}")
            print(f"[C7] {world} seed {seed} (n {seen[0][0].shape[-1]}): per solve, K1's worst "
                  f"env against float64 {[round(x, 3) for x in worsts]}, over plain's "
                  f"(0 within one unit) {[round(x, 3) for x in ratios]}", flush=True)
    if saved:
        os.makedirs("chip_smoke_out", exist_ok=True)
        np.savez("chip_smoke_out/k1_c7_envs.npz", **saved)
    print(f"[C7] largest ratio {worst[0]:.3f} ({worst[1]}); WORST_FACTOR {WORST_FACTOR}; "
          f"{len(saved) // 5} solves (past it, and each world and seed's worst beyond one "
          f"unit) saved to chip_smoke_out/k1_c7_envs.npz ({card})",
          flush=True)
    assert worst[0] <= WORST_FACTOR, \
        f"K1 against float64: {worst[0]:.3f} times plain's worst env ({worst[1]})"
    return worst[0]


# ---------------------------------------------------------------------------
# the server's control plane: the CLI with plugins, the physics loop, the Step
# action, model edits on K3, checkpoints
# ---------------------------------------------------------------------------

ARM7_PID = {j: {"method": "POSITION_PID", "pid": [20.0, 1.0, 0.5, 5.0], "effort_limit": 20.0}
            for j in ("j4", "j5", "j6")}


def arm7_cli(card, tmp):
    """Phase 28a: BASELINE config 4 from the CLI. ARM7's XML and a --config
    JSON with phase 20's mocap and ros_control plugins are written to tmp,
    and `python -m mujoco_ros_pkgs_tpu_torch.server.launch` serves ARM7 at
    ARM7_NENV envs for CLI_STEPS steps with control noise: exit 0, sim_time
    lines that advance, the last at CLI_STEPS * dt."""
    xml, cfg = os.path.join(tmp, "arm7.xml"), os.path.join(tmp, "arm7_plugins.json")
    with open(xml, "w") as f:
        f.write(worlds.ARM7)
    with open(cfg, "w") as f:
        json.dump({"MujocoPlugins": [{"type": "mocap"},
                                     {"type": "ros_control", "joints": ARM7_PID}]}, f)
    cmd = [sys.executable, "-m", "mujoco_ros_pkgs_tpu_torch.server.launch", "--modelfile", xml,
           "--nenv", str(ARM7_NENV), "--config", cfg, "--num-steps", str(CLI_STEPS),
           "--ctrl-noise-std", "0.05", "--ctrl-noise-rate", "0.1", "--verbose"]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    wall = time.perf_counter() - t0
    times = [float(x) for x in re.findall(r"sim_time=([0-9.]+)s", proc.stderr)]
    assert proc.returncode == 0, f"launch exited {proc.returncode}: {proc.stderr[-2000:]}"
    assert "plugins=2" in proc.stderr, proc.stderr[-2000:]
    assert len(times) >= 2 and times == sorted(times) and times[0] < times[-1], times
    assert abs(times[-1] - CLI_STEPS * 0.002) < 1e-3, times[-1]
    print(f"[28a CLI] launch --nenv {ARM7_NENV} --config (mocap, ros_control) --num-steps "
          f"{CLI_STEPS} --ctrl-noise-std 0.05 --ctrl-noise-rate 0.1: exit 0 in {wall:.1f}s "
          f"(process start, build check, compile and steps), {len(times)} sim_time lines "
          f"{times[0]:.3f} .. {times[-1]:.3f} s ({card})", flush=True)
    return wall


def arm7_served(**kw):
    """Phase 20's server: ARM7 at ARM7_NENV envs with the mocap and
    ros_control plugins (POSITION_PID on j4-j6, commands set), the weld on,
    bench_config4's ctrl."""
    rc = RosControlPlugin({"joints": ARM7_PID})
    srv = MujocoServer(worlds.ARM7, nenv=ARM7_NENV, plugins=[MocapPlugin(), rc], **kw)
    p = srv.get_eq_constraint_parameters("ee_target")
    p.active, p.anchor = True, np.array([0.0, 0.0, 0.1])
    p.relpose = Pose(np.zeros(3), np.array([1.0, 0, 0, 0]))
    assert srv.set_eq_constraint_parameters(p).success
    assert srv.set_ctrl(np.array(ARM7_CTRL)).success
    i, _ = srv._plugin_of(RosControlPlugin)
    with srv._lock:
        srv.pstates = tuple(rc.set_commands(ps, [0.2, -0.3, 0.1]) if k == i else ps
                            for k, ps in enumerate(srv.pstates))
    return srv


def arm7_loop(card):
    """Phase 28b: phase 20's server on the physics-loop thread. Unbound, its
    first chunk alone, then for LOOP_SECONDS (and a whole chunk) while a
    second thread calls set_mocap_state, set_ctrl, get_body_state and
    get_solver_stats: no error in either thread, a finite
    batch, K1 2 + the batch's Newton trips a step; then paced at half the
    unbound slowdown for LOOP_SECONDS (measured_slowdown within 10%); then
    paused, a Step action of 200 steps preempted after its first feedback
    (success False, whole chunks of 16 run). Returns the loop's numbers."""
    from mujoco_ros_pkgs_tpu_torch.msgs import StepGoal
    from mujoco_ros_pkgs_tpu_torch.server.server import ACTION_CHUNK, CHUNK
    srv = arm7_served(unpause=True)
    errors, stop = [], [False]

    def services():
        rng = np.random.default_rng(5)
        try:
            while not stop[0]:
                target = Pose(np.array([0.35, 0.15, 0.85]) + 0.05 * rng.normal(size=3))
                assert srv.set_mocap_state(MocapState(["mocap_target"], [target])).success
                assert srv.set_ctrl(np.array(ARM7_CTRL) * rng.uniform(0.5, 1.0)).success
                srv.get_body_state("link6", env_id=int(rng.integers(ARM7_NENV)))
                srv.get_solver_stats(int(rng.integers(ARM7_NENV)))
                time.sleep(0.05)
        except Exception as exc:   # noqa: BLE001 - reported below
            errors.append(exc)

    log, newton = [], solver.newton

    def logged(m, d, e, **kw):     # get_solver_stats' diagnostic solves pass stats
        return newton(m, d, e, **kw) if kw else newton(m, d, e, trips=log)

    zero_counts()
    t_start = srv.sim_time
    worker = threading.Thread(target=services)
    def chunk_after(t, timeout=300):
        """Wait for the end of the first whole chunk after sim time t."""
        deadline = time.monotonic() + timeout
        while srv.sim_time < t + (CHUNK + 0.5) * 0.002:
            assert time.monotonic() < deadline, "the loop finished no chunk"
            time.sleep(0.05)

    solver.newton = logged
    try:
        srv.start_physics_loop()
        chunk_after(t_start)
        alone = srv.measured_slowdown
        worker.start()
        assert srv.set_speed(-1).success        # unbound still: a new baseline
        t_services = srv.sim_time
        time.sleep(LOOP_SECONDS)
        chunk_after(t_services)
        unbound = srv.measured_slowdown
        t_unbound = srv.sim_time
        target = unbound / 2
        assert srv.set_speed(target).success
        time.sleep(LOOP_SECONDS)
        paced = srv.measured_slowdown
        stop[0] = True
        worker.join(timeout=120)
        assert not worker.is_alive(), "the service thread did not stop"
        assert srv.set_pause(True).success
        time.sleep(1.0)
        t_paused = srv.sim_time
        fb, done, first = [], [], threading.Event()
        assert srv.step_action(StepGoal(num_steps=200),
                               feedback_cb=lambda f: (fb.append(f.steps_left), first.set()),
                               done_cb=lambda r: done.append(r.success))
        assert first.wait(timeout=300), "no Step action feedback"
        srv.preempt_step_action(timeout=300)
        srv.stop_physics_loop(timeout=300)
    finally:
        solver.newton = newton
    assert srv._physics_thread is None, "the physics loop did not stop"
    assert errors == [] and srv.physics_error is None, (errors, srv.physics_error)
    ran = round((t_paused - t_start) / 0.002)
    action = round((srv.sim_time - t_paused) / 0.002)
    assert done == [False] and action % ACTION_CHUNK == 0 and 0 < action < 200, (done, action)
    d = srv.d
    assert all(bool(torch.isfinite(t).all()) for t in (d.qpos, d.qvel, d.qacc, d.ctrl))
    trips = sum(r for _, r, _ in log)
    k1 = kernels.psd_solve.launches
    assert len(log) >= ran + action and k1 >= 2 * (ran + action) + trips, (len(log), ran, k1)
    assert (kernels.newton_solve.launches, kernels.step_fused.launches) == (0, 0)
    assert abs(paced / target - 1) < 0.1, f"paced at {paced:.5f} for a target of {target:.5f}"
    out = {"loop_steps": ran, "loop_k1_launches": k1, "loop_newton_solves": len(log),
           "loop_env_steps_per_s": ARM7_NENV * unbound / 0.002,
           "loop_alone_env_steps_per_s": ARM7_NENV * alone / 0.002,
           "loop_unbound_slowdown": unbound, "loop_paced_target": target,
           "loop_paced_slowdown": paced, "action_steps": action}
    print(f"[28b loop] ARM7 x {ARM7_NENV} with both plugins on the physics-loop thread: its "
          f"first chunk alone {out['loop_alone_env_steps_per_s']:.4g} env-steps/s (slowdown "
          f"{alone:.5f}); then {round((t_unbound - t_services) / 0.002)} steps beside a service "
          f"thread (set_mocap_state, set_ctrl, get_body_state, get_solver_stats at 20 Hz): "
          f"slowdown {unbound:.5f}, {out['loop_env_steps_per_s']:.4g} env-steps/s; paced at "
          f"{target:.5f}: "
          f"measured {paced:.5f} ({100 * (paced / target - 1):+.1f}%); Step action of 200 "
          f"preempted after its first feedback: success False, {action} steps (feedback "
          f"{fb}); K1 {k1} launches over {ran + action} steps and {len(log)} Newton solves "
          f"(the paused loop's forward passes included), K2 0, K3 0 ({card})", flush=True)
    return out


def boxes_edits(card):
    """Phase 28c: BOXES at NENV envs on K3. After each edit (physics
    options, friction and size, the body's mass) the plan is rebuilt from
    the edited model, and one server step from seeded states equals
    step_batched_plain of the edited model at phase 3's tolerances, with
    one more K3 launch; a pyramidal cone moves it to the general route;
    apply_body_wrench steps on the general route (no K3 launch) with
    delta qvel = F / m dt at phase 8's tolerances, and after
    clear_body_wrenches K3 launches again."""
    from mujoco_ros_pkgs_tpu_torch.msgs import BodyState, GeomProperties
    srv = MujocoServer(worlds.BOXES, nenv=NENV)
    box = GeomProperties(name="box", friction_slide=0.6, friction_spin=0.01,
                         friction_roll=0.001, size_0=0.12, size_1=0.1, size_2=0.08)
    edits = [("options", "set_physics_properties",
              ({"timestep": 0.001, "tolerance": 1e-6, "impratio": 3.0},), {}),
             ("friction and size", "set_geom_properties", (box,),
              dict(set_friction=True, set_size=True)),
             ("mass", "set_body_state", (BodyState(name="box", mass=1.5),),
              dict(set_pose=False, set_twist=False, set_mass=True))]
    errs = {}
    for k, (label, method, args, kw) in enumerate(edits):
        params = srv._plan.params.clone()
        assert getattr(srv, method)(*args, **kw).success, label
        plan = srv._plan
        assert isinstance(plan, step_tpu.Plan) and not torch.equal(plan.params, params)
        assert torch.equal(plan.params, fwd.make_plan(srv.m).params), label
        qpos, qvel, ws = states(NENV, seed=20 + k)
        srv.d = srv.d.replace(qpos=qpos, qvel=qvel, qacc_warmstart=ws)
        want = step_tpu.step_batched_plain(srv.m, qpos, qvel, ws, plan.params, plan.idx)
        before = kernels.step_fused.launches
        assert srv.step(1).success
        torch.cuda.synchronize()
        assert kernels.step_fused.launches == before + 1, label
        errs[label] = max(close(f"28c {label} qpos", srv.d.qpos, want[0], 1e-5, 1e-6),
                          close(f"28c {label} qvel", srv.d.qvel, want[1], 1e-4, 1e-4),
                          close(f"28c {label} qacc", srv.d.qacc, want[2], 1e-4, 1e-4))
    assert srv.set_physics_properties({"cone": "pyramidal"}).success
    assert srv._plan == fwd.GeneralPlan()
    before = kernels.step_fused.launches
    assert srv.step(1).success and kernels.step_fused.launches == before
    assert srv.set_physics_properties({"cone": "elliptic"}).success
    assert isinstance(srv._plan, step_tpu.Plan)
    assert srv.set_gravity((0.0, 0.0, 0.0)).success
    qpos, qvel, _ = states(NENV, seed=30)
    qpos[:, 2] += 1.0
    srv.d = srv.d.replace(qpos=qpos, qvel=qvel)
    force = torch.tensor([3.0, -2.0, 1.0], device=srv.device)
    assert srv.apply_body_wrench("box", force=tuple(force.tolist())).success
    v0 = srv.d.qvel.clone()
    before = (kernels.step_fused.launches, kernels.psd_solve.launches)
    assert srv.step(1).success
    after = (kernels.step_fused.launches, kernels.psd_solve.launches)
    assert after[0] == before[0] and after[1] > before[1], (before, after)
    dv = srv.d.qvel[:, :3] - v0[:, :3]
    errs["wrench"] = close("28c wrench dv", dv, (force / 1.5 * 0.001).expand_as(dv), 1e-4,
                           1e-4)
    assert srv.clear_body_wrenches().success and srv.step(1).success
    assert kernels.step_fused.launches == before[0] + 1
    print(f"[28c edits] BOXES x {NENV} on K3: after each edit one server step against the "
          f"edited model's plain step: " + " ".join(f"{k} {v:.3e}" for k, v in errs.items())
          + f"; cone pyramidal: general route, no K3 launch; a wrench: general route, dv = "
          f"F / m dt; cleared: K3 again ({card})", flush=True)
    return max(errs.values())


def arm7_checkpoint(card, tmp):
    """Phase 28d: a checkpoint of phase 20's server with control noise
    (ARM7 at ARM7_NENV envs, both plugins): save, CKPT_STEPS steps, load,
    CKPT_STEPS steps again; the two continuations are compared, bit for bit
    where they agree so, and otherwise at phase 8's qpos tolerance (the
    general route's scatter-adds use atomics), the largest difference
    printed."""
    from mujoco_ros_pkgs_tpu_torch.server import checkpoint
    srv = arm7_served(ctrl_noise_std=0.05, ctrl_noise_rate=0.1)
    assert srv.step(20).success
    path = os.path.join(tmp, "arm7_ckpt")
    t0 = time.perf_counter()
    checkpoint.save(srv, path)
    t_save = time.perf_counter() - t0
    assert srv.step(CKPT_STEPS).success
    first = [t.clone() for t in (srv.d.qpos, srv.d.qvel, srv.d.ctrl)]
    t0 = time.perf_counter()
    checkpoint.load(srv, path)
    t_load = time.perf_counter() - t0
    assert srv.step(CKPT_STEPS).success
    again = (srv.d.qpos, srv.d.qvel, srv.d.ctrl)
    diffs = [float((a - b).abs().max()) for a, b in zip(first, again)]
    exact = all(torch.equal(a, b) for a, b in zip(first, again))
    if not exact:
        close("28d qpos of the resumed run", again[0], first[0], 0.0, 1e-4)
    size = os.path.getsize(path + ".bin")
    print(f"[28d checkpoint] ARM7 x {ARM7_NENV} with plugins and control noise: save "
          f"{t_save:.3f}s, load {t_load:.3f}s, {size} bytes; the resumed {CKPT_STEPS} steps "
          f"against the first: max |dqpos| {diffs[0]:.3e}, |dqvel| {diffs[1]:.3e}, |dctrl| "
          f"{diffs[2]:.3e}, {'bit for bit' if exact else 'held at qpos atol 1e-4'} ({card})",
          flush=True)
    return {"max_dqpos": diffs[0], "max_dqvel": diffs[1], "max_dctrl": diffs[2],
            "bit_for_bit": exact}


def entry(name, source, replaces, launches, err, t, group, library_ms=None):
    return {"name": name, "route": "cuda",
            "source": f"mujoco_ros_pkgs_tpu_torch/csrc/{source}",
            "replaces": replaces, "launches": launches, "max_abs_err": err,
            "ms": t["ms"], "graph_ms": t["graph_ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound"][0],
            "bound_by": t["bound"][1], "library_ms": library_ms, "group": group}


def main():
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch.cuda.is_available() is false; a CUDA card is required")
    card = card_line()
    print(f"[card] {card}; torch {torch.__version__} cuda {torch.version.cuda}",
          flush=True)
    tf32_default = (torch.backends.cuda.matmul.allow_tf32
                    or torch.get_float32_matmul_precision() != "highest")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    paths = kernels.build()
    print(f"[build] {', '.join(p.name for p in paths.values())} in "
          f"{time.perf_counter() - t0:.1f}s", flush=True)
    lines = build_lines(kernels.build_log)
    for line in lines:
        print(f"[build] {line}", flush=True)
    k1_lines = [line for line in lines if line.startswith(("psd_rows_kernel",
                                                            "psd_block_kernel"))]
    assert any(line.startswith("psd_block_kernel") for line in k1_lines) or not lines, \
        "no ptxas line for K1's block kernel"
    stack = [line for line in k1_lines if "; 0 bytes stack frame" not in line]
    assert not stack, "K1's kernels use stack: " + "; ".join(stack)
    block_occupancy(card)

    err3 = max(kernel_vs_plain(worlds.BOXES, "boxes"),
               kernel_vs_plain(BOXES_DAMPED, "boxes_damped"))
    launches3 = main_path()
    t3 = timing(card)
    err1, t1 = k1_phase(card)
    err2, t2 = k2_phase(card)
    m, plan, d = general_vs_plain()
    launches12, _ = general_main_path()
    general_timing(card, m, plan, d)
    mp, planp, dp, err_pile = pile_vs_plain(card)
    launches_pile, _ = pile_main_path(tf32_default)
    tp = pile_timing(card, mp, planp, dp)
    t1["pile"] = {"launches": launches_pile, "steps": PILE_STEPS, "max_abs_err": err_pile,
                  "graph_ms_512": tp[("graph", 512)], "graph_ms_4096": tp[("graph", 4096)],
                  "bound_ms_512": tp[("bound", 512)][0],
                  "bound_ms_4096": tp[("bound", 4096)][0],
                  "library_ms": {n: tp[("library", n)] for n in (27, 72, 96)}}
    mh, planh, dh, err_h = humanoid_vs_plain(card)
    launches_h, t_h, trips_env, trips_batch = humanoid_main_path()
    th = humanoid_timing(card, mh, planh, dh)
    n1, n4 = HUMANOID_NENV, 4 * HUMANOID_NENV
    t1["humanoid"] = {
        "launches": launches_h, "steps": HUMANOID_STEPS,
        "launches_per_step": launches_h / HUMANOID_STEPS, "max_abs_err": err_h,
        "env_steps_per_s": HUMANOID_NENV * HUMANOID_STEPS / t_h,
        "newton_trips_per_env": trips_env, "newton_trips_per_batch_step": trips_batch,
        "step_ms": {n1: th[("kernel", n1)], n4: th[("kernel", n4)]},
        "step_plain_ms": {n1: th[("plain", n1)]},
        **{f"{k}_{n}": th[(key, n)] for n in (n1, n4) for k, key in (
            ("graph_ms", "graph"), ("ms", "ms"), ("plain_ms", "plain_ms"),
            ("library_ms", "library"))},
        **{f"bound_ms_{n}": th[("bound", n)][0] for n in (n1, n4)}}
    ms_, plans_, ds_, err_s = sensors_vs_plain(card)
    launches_s, t_s = sensors_main_path()
    ts, ts1, ts2 = sensors_timing(card, ms_, plans_, ds_)
    sensors = {"nenv": SENSORS_NENV, "steps": SENSORS_STEPS,
               "env_steps_per_s": SENSORS_NENV * SENSORS_STEPS / t_s, **ts}
    t1["sensors"] = dict(sensors, launches=launches_s["psd_solve"], max_abs_err=err_s,
                         **{k: ts1[k] for k in ("graph_ms", "ms", "plain_ms", "library_ms",
                                                "group")},
                         bound_ms=ts1["bound"][0], bound_by=ts1["bound"][1])
    t2["sensors"] = dict(sensors, launches=launches_s["newton_solve"],
                         **{k: ts2[k] for k in ("graph_ms", "ms", "plain_ms", "group")},
                         bound_ms=ts2["bound"][0], bound_by=ts2["bound"][1],
                         newton_trips_mean=float(ts2["trips"].mean()))
    ma, plana, da, err_a = arm7_vs_plain(card)
    launches_a, t_a, trips_env_a, trips_batch_a = arm7_main_path()
    ta = arm7_timing(card, ma, plana, da)
    t1["arm7"] = {"nenv": ARM7_NENV, "steps": ARM7_STEPS, "launches": launches_a,
                  "launches_per_step": launches_a / ARM7_STEPS, "max_abs_err": err_a,
                  "env_steps_per_s": ARM7_NENV * ARM7_STEPS / t_a,
                  "newton_trips_per_env": trips_env_a,
                  "newton_trips_per_batch_step": trips_batch_a,
                  **{k: ta[k] for k in ("step_ms", "step_plain_ms", "graph_ms", "ms",
                                        "plain_ms", "library_ms", "group")},
                  "bound_ms": ta["bound"][0], "bound_by": ta["bound"][1]}

    # phases 22-27: contact compaction, the nv > 96 route, C7
    compact = {}
    t0c = time.perf_counter()
    _, _, _, err_c, k1_c = compact_vs_plain(card, "PILE con_topk=64", PILE5, dp, 192,
                                            con_topk=64)
    run = compact_server("PILE con_topk=64", PILE5, PILE_NENV, COMPACT_STEPS, 1, con_topk=64)
    compact["pile_con_topk"] = dict(zip(("launches", "wall_s", "newton_trips_per_env",
                                         "newton_trips_per_batch_step"), run[:4]),
                                    nenv=PILE_NENV, steps=COMPACT_STEPS, solver_rows=192,
                                    env_steps_per_s=PILE_NENV * COMPACT_STEPS / run[1],
                                    max_abs_err=err_c, k1_max_abs_err=k1_c)
    _, _, _, err_b, k1_b = compact_vs_plain(card, "PILE pair_topk=24 con_topk=64", PILE5, dp,
                                            345, pair_topk=24, con_topk=64)
    run = compact_server("PILE pair_topk=24 con_topk=64", PILE5, PILE_NENV, COMPACT_STEPS, 1,
                         overflow=True, pair_topk=24, con_topk=64)
    compact["pile_broadphase"] = dict(zip(("launches", "wall_s", "newton_trips_per_env",
                                           "newton_trips_per_batch_step"), run[:4]),
                                      nenv=PILE_NENV, steps=COMPACT_STEPS, solver_rows=345,
                                      env_steps_per_s=PILE_NENV * COMPACT_STEPS / run[1],
                                      broadphase_overflow=0, max_abs_err=err_b,
                                      k1_max_abs_err=k1_b)
    run, err_st = settling(card)
    compact["pile_settling"] = dict(zip(("launches", "wall_s", "newton_trips_per_env",
                                         "newton_trips_per_batch_step",
                                         "most_active_slots", "bodies_outside",
                                         "bodies_outside_uncompacted"), run),
                                    nenv=PILE_NENV, steps=SETTLE_STEPS, max_abs_err=err_st,
                                    env_steps_per_s=PILE_NENV * SETTLE_STEPS / run[1])
    _, _, _, err_hc, k1_hc = compact_vs_plain(card, f"HUMANOID con_topk={HUMANOID_CON_TOPK}",
                                              HUMANOID, dh, 165, hold_qacc=humanoid_qacc,
                                              con_topk=HUMANOID_CON_TOPK)
    run = compact_server(f"HUMANOID con_topk={HUMANOID_CON_TOPK}", HUMANOID, HUMANOID_NENV,
                         HUMANOID_STEPS, 2, con_topk=HUMANOID_CON_TOPK)
    compact["humanoid_con_topk"] = dict(zip(("launches", "wall_s", "newton_trips_per_env",
                                             "newton_trips_per_batch_step"), run[:4]),
                                        nenv=HUMANOID_NENV, steps=HUMANOID_STEPS,
                                        solver_rows=165, max_abs_err=err_hc,
                                        k1_max_abs_err=k1_hc,
                                        env_steps_per_s=HUMANOID_NENV * HUMANOID_STEPS / run[1])
    errs_w, t_w = wide_world(card)
    compact["nv102"] = {"nenv": 256, "k1_launches": 0, "step_ms": t_w, **errs_w}
    compact["c7_worst_ratio"] = c7_margins(card)
    print(f"[compaction] phases 22-27 in {time.perf_counter() - t0c:.1f}s", flush=True)
    t1.update(compact)

    # phase 28: the server's control plane
    t0s = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        cli_wall = arm7_cli(card, tmp)
        t1["arm7"].update(arm7_loop(card), cli_steps=CLI_STEPS, cli_wall_s=cli_wall)
        err3 = max(err3, boxes_edits(card))
        t1["arm7"]["checkpoint"] = arm7_checkpoint(card, tmp)
    print(f"[server] phase 28 in {time.perf_counter() - t0s:.1f}s", flush=True)

    if t3["saved"]:
        os.makedirs("chip_smoke_out", exist_ok=True)
        np.savez("chip_smoke_out/k3_x_envs.npz", **t3["saved"])
        print(f"[timing] K3 envs past the float32 budget saved to "
              f"chip_smoke_out/k3_x_envs.npz ({len(t3['saved'])} arrays)", flush=True)
    print(json.dumps({"kernels": [
        entry("step_fused", "step_fused.cu", "mujoco_ros_pkgs_tpu/ops/step_tpu.py:510",
              launches3, err3, {"ms": t3[("kernel", NENV)], "graph_ms": t3["graph_ms"],
                                "plain_ms": t3[("plain", NENV)], "bound": t3["bound"]},
              t3["group"]),
        dict(entry("psd_solve", "linalg.cu", "mujoco_ros_pkgs_tpu/ops/linalg_tpu.py:113",
                   launches12["psd_solve"], err1, t1, t1["group"], t1["library_ms"]),
             **{k: t1[k] for k in ("pile", "humanoid", "sensors", "arm7", *compact)}),
        dict(entry("newton_solve", "solver.cu", "mujoco_ros_pkgs_tpu/ops/solver_tpu.py:470",
                   launches12["newton_solve"], err2, t2, t2["group"]),
             sensors=t2["sensors"])]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
