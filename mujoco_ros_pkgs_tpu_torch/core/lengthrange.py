"""Automatic actuator lengthrange at load (mj_setLengthRange analogue).

Counterpart of mujoco_ros_pkgs_tpu/core/lengthrange.py. A muscle without a
`lengthrange` gets one at load:

- a joint transmission on a limited hinge or slide: gear0 * jnt_range,
  ordered, with no simulation;
- a tendon transmission: the damped push probe. The probe model keeps the
  joint and tendon limits and the equalities and drops contacts, gravity,
  actuation and passive forces; a force sign * _ACCEL / (moment M^-1
  moment) * moment pushes the transmission while qvel is damped by _DAMP
  each step, for _NSTEP steps, and the extreme actuator length reached is
  the range's end. Every (actuator, direction) is one env of a single
  batch of 2 n envs, stepped together by the port's general route in
  float64 on the CPU (the JAX package runs one loop per actuator and
  direction);
- anything unbounded, or a probe that diverges or finds a degenerate
  range, raises ValueError naming the actuator, as the JAX package does.

The probe prints its seconds to stderr and keeps them in LAST_PROBE_SECONDS.
The probe model also drops the sensors, which feed nothing back into the
motion. core/mjcf_writer.py writes the computed ranges, so a saved model
loads without a probe.
"""

from __future__ import annotations

import dataclasses
import sys
import time

import numpy as np
import torch

from mujoco_ros_pkgs_tpu_torch.core.types import (
    BiasType, DisableBit, GainType, JointType, Model, TrnType,
)

_ACCEL = 20.0
_DAMP = 0.85
_NSTEP = 400
_DIVERGED = 1e6
# the seconds the last probe took (0.0 before any)
LAST_PROBE_SECONDS = 0.0


def needs_auto(m: Model) -> np.ndarray:
    """Bool mask over actuators: a muscle gain or bias with no lengthrange."""
    lr = m.actuator_lengthrange.cpu().numpy()
    muscle = ((np.asarray(m.actuator_gaintype, dtype=np.int64) == int(GainType.MUSCLE))
              | (np.asarray(m.actuator_biastype, dtype=np.int64) == int(BiasType.MUSCLE)))
    return muscle & (lr[:, 0] >= lr[:, 1]) if m.nu else np.zeros(0, dtype=bool)


def _probe_model(m: Model) -> Model:
    """The measuring model: no contacts, gravity, actuation or passive
    forces (the limits and equalities bound the range), and no sensors,
    which feed nothing back."""
    flags = (int(m.opt.disableflags) | DisableBit.CONTACT | DisableBit.GRAVITY
             | DisableBit.ACTUATION | DisableBit.PASSIVE | DisableBit.SENSOR)
    return dataclasses.replace(m, opt=dataclasses.replace(m.opt, disableflags=int(flags)))


def _simulate_ranges(m: Model, acts) -> np.ndarray:
    """(lo, hi) of each actuator in `acts` by the damped push probe, all
    (actuator, direction) pairs as one float64 CPU batch: env 2k pushes
    acts[k] down, env 2k + 1 up."""
    from mujoco_ros_pkgs_tpu_torch.ops import forward

    mp = _probe_model(m.to("cpu", torch.float64))
    n = len(acts)
    idx = torch.tensor(np.repeat(acts, 2), dtype=torch.int64)
    sign = torch.tensor([-1.0, 1.0] * n, dtype=torch.float64)
    rows = torch.arange(2 * n)
    plan = forward.make_plan(mp)
    d = forward.forward(mp, forward.make_data(mp, 2 * n))
    ext = d.actuator_length[rows, idx]
    for _ in range(_NSTEP):
        moment = d.actuator_moment[rows, idx]                              # (2n, nv)
        chol = torch.linalg.cholesky(d.qM)
        minv_moment = torch.cholesky_solve(moment[..., None], chol)[..., 0]
        denom = torch.clamp((moment * minv_moment).sum(-1), min=1e-12)
        d = d.replace(qfrc_applied=(sign * _ACCEL / denom)[:, None] * moment,
                      qvel=d.qvel * _DAMP)
        d = forward.step(mp, d, plan)
        ln = d.actuator_length[rows, idx]
        ext = torch.where(sign > 0, torch.maximum(ext, ln), torch.minimum(ext, ln))
    return ext.view(n, 2).numpy()


def apply_auto_lengthrange(m: Model) -> Model:
    """Fill the missing muscle lengthranges; raise for those that cannot be
    computed."""
    global LAST_PROBE_SECONDS
    need = needs_auto(m)
    if not need.any():
        return m
    lr = m.actuator_lengthrange.cpu().numpy().copy()
    probe = []
    for i in np.nonzero(need)[0]:
        trn = m.actuator_trntype[i]
        name = m.actuator_names[i] if m.actuator_names else str(i)
        if trn == int(TrnType.JOINT):
            j = m.actuator_trnid[i][0]
            if m.jnt_type[j] not in (int(JointType.HINGE), int(JointType.SLIDE)):
                raise ValueError(
                    f"muscle actuator '{name}': automatic lengthrange needs "
                    "a scalar (hinge/slide) joint transmission")
            if not m.jnt_limited[j]:
                raise ValueError(
                    f"muscle actuator '{name}': automatic lengthrange "
                    "computation failed — the transmission joint has no "
                    "range; add limits or an explicit lengthrange")
            g = float(m.actuator_gear[i, 0])
            r = m.jnt_range[j].cpu().numpy().astype(np.float64)
            lr[i] = sorted((g * r[0], g * r[1]))
        elif trn == int(TrnType.TENDON):
            t = m.actuator_trnid[i][0]
            if not (m.tendon_limited[t] or any(m.jnt_limited)):
                raise ValueError(
                    f"muscle actuator '{name}': automatic lengthrange "
                    "computation failed — nothing bounds the tendon; add "
                    "joint/tendon limits or an explicit lengthrange")
            probe.append(int(i))
        else:
            raise ValueError(
                f"muscle actuator '{name}' needs an explicit lengthrange "
                "(automatic computation supports joint/tendon transmission)")
    if probe:
        t0 = time.perf_counter()
        lr[probe] = _simulate_ranges(m, probe)
        LAST_PROBE_SECONDS = time.perf_counter() - t0
        print(f"lengthrange probe: {len(probe)} actuators, {2 * len(probe)} envs x "
              f"{_NSTEP} steps in {LAST_PROBE_SECONDS:.3f} s", file=sys.stderr)
    for i in np.nonzero(need)[0]:
        name = m.actuator_names[i] if m.actuator_names else str(i)
        lo, hi = lr[i]
        if i in probe and (not (np.isfinite(lo) and np.isfinite(hi))
                           or abs(lo) > _DIVERGED or abs(hi) > _DIVERGED):
            raise ValueError(
                f"muscle actuator '{name}': lengthrange probe diverged; "
                "give an explicit lengthrange")
        if hi - lo < 1e-9:
            raise ValueError(
                f"muscle actuator '{name}': computed lengthrange is "
                f"degenerate [{lo}, {hi}]; give an explicit lengthrange")
    return dataclasses.replace(m, actuator_lengthrange=torch.as_tensor(
        lr, dtype=m.actuator_lengthrange.dtype, device=m.actuator_lengthrange.device))
