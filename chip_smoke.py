"""Smoke run of the torch port's main path on one CUDA card.

    python3 chip_smoke.py

Phases (any failure raises; the exit code is then not 0):
  1. card: a CUDA device is required; prints the card's name and power limit
     (nvidia-smi) and turns TF32 off for the plain reference's matmuls;
  2. build: compiles the fused step kernel from mujoco_ros_pkgs_tpu_torch/csrc
     with nvcc for sm_90a;
  3. kernel vs plain: BOXES and BOXES with a damped free joint at 4096 envs
     from seeded numpy states, 1 step (qpos rtol 1e-5 / atol 1e-6, qvel and
     qacc rtol 1e-4 / atol 1e-4) and 5 steps (qpos atol 1e-4);
  4. main path: MujocoServer(BOXES, nenv=4096, device="cuda") steps 1000
     times (timed: the server's env-steps/s), the boxes settle on the
     ground (z within 5e-4 of 0.1, speed below 1e-4), set_gravity + reset +
     step keep them floating, a bad reload fails and the server keeps
     answering; the kernel's launch counter, zeroed before, must count
     these steps;
  5. timing: env-steps/s of the kernel and of the plain path at 4096 and
     65536 envs, 200 steps after warm-up, CUDA events.
Prints a JSON line of kernel results, then the card line, then
{"ok": true, "device": {...}} as the last line.
"""

import json
import subprocess
import sys
import time

import numpy as np
import torch

if not torch.cuda.is_available():
    sys.exit("chip_smoke: torch.cuda.is_available() is false; a CUDA card is required")

from mujoco_ros_pkgs_tpu_torch import kernels  # noqa: E402
from mujoco_ros_pkgs_tpu_torch.core import mjcf  # noqa: E402
from mujoco_ros_pkgs_tpu_torch.models import worlds  # noqa: E402
from mujoco_ros_pkgs_tpu_torch.ops import forward as fwd  # noqa: E402
from mujoco_ros_pkgs_tpu_torch.ops import step_tpu  # noqa: E402
from mujoco_ros_pkgs_tpu_torch.server import MujocoServer  # noqa: E402

BOXES_DAMPED = worlds.BOXES.replace(
    "<freejoint/>", '<joint type="free" damping="0.05" armature="0.01"/>')
NENV = 4096


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def states(nenv, seed):
    """Seeded states near the ground: heights, tilts and velocities."""
    rng = np.random.default_rng(seed)
    qpos = np.zeros((nenv, 7), np.float32)
    qpos[:, 2] = 0.2 + 0.25 * rng.uniform(size=nenv) - 0.05
    quat = rng.normal(size=(nenv, 4)) * 0.2
    quat[:, 0] += 1.0
    qpos[:, 3:] = quat / np.linalg.norm(quat, axis=1, keepdims=True)
    qvel = (0.6 * rng.normal(size=(nenv, 6))).astype(np.float32)
    ws = (0.5 * rng.normal(size=(nenv, 6))).astype(np.float32)
    return tuple(torch.from_numpy(a).cuda() for a in (qpos, qvel, ws))


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
    kernels.step_fused.launches = 0
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
    for nenv in (4096, 65536):
        for name, fn, warm in (("kernel", kernel, 20), ("plain", plain, 3)):
            ms = time_steps(fn, *states(nenv, seed=1), nsteps=200, warmup=warm)
            out[(name, nenv)] = ms
            print(f"[timing] {name} nenv={nenv}: {ms:.4f} ms/step, "
                  f"{nenv / ms * 1e3:.4g} env-steps/s ({card})", flush=True)
    return out


def main():
    card = card_line()
    print(f"[card] {card}; torch {torch.__version__} cuda {torch.version.cuda}",
          flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    path = kernels.build()
    print(f"[build] {path.name} in {time.perf_counter() - t0:.1f}s", flush=True)
    for line in kernels.build_log.splitlines():
        if "registers" in line or "spill" in line or "stack frame" in line:
            print("[build] " + line.strip(), flush=True)

    err = max(kernel_vs_plain(worlds.BOXES, "boxes"),
              kernel_vs_plain(BOXES_DAMPED, "boxes_damped"))
    launches = main_path()
    t = timing(card)

    print(json.dumps({"kernels": [{
        "name": "step_fused", "route": "cuda",
        "source": "mujoco_ros_pkgs_tpu_torch/csrc/step_fused.cu",
        "replaces": "mujoco_ros_pkgs_tpu/ops/step_tpu.py:510",
        "launches": launches, "max_abs_err": err,
        "ms": t[("kernel", NENV)], "plain_ms": t[("plain", NENV)]}]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
