"""Muscle actuators over a batch: activation dynamics, active gain, passive bias.

Counterpart of mujoco_ros_pkgs_tpu/ops/muscle.py (mju_muscleDynamics,
mju_muscleGain and mju_muscleBias), branchless and elementwise over any
leading shape, so one call takes every actuator of every env.

Parameter vectors (gainprm and biasprm are the same for a muscle):
  prm = (range0, range1, force, scale, lmin, lmax, vmax, fpmax, fvmax)
  dynprm = (tau_act, tau_deact, tausmooth)
A negative force derives the peak force from scale: F0 = scale / acc0, with
acc0 = |M^-1 moment| at qpos0 (core/constants.py).
"""

from __future__ import annotations

import torch

from mujoco_ros_pkgs_tpu_torch.ops.math import MINVAL


def _sigmoid(x):
    """Quintic smoothstep on [0, 1] (mju_sigmoid)."""
    x = torch.clamp(x, 0.0, 1.0)
    return x * x * x * (3.0 * x * (2.0 * x - 5.0) + 10.0)


def _div(a, b):
    return a / torch.clamp(b, min=MINVAL)


def dynamics(ctrl, act, dynprm):
    """Activation rate act_dot(ctrl, act); dynprm (..., >= 3)."""
    tau_act, tau_deact, tausmooth = dynprm[..., 0], dynprm[..., 1], dynprm[..., 2]
    ctrlclamp = torch.clamp(ctrl, 0.0, 1.0)
    actclamp = torch.clamp(act, 0.0, 1.0)
    t_act = tau_act * (0.5 + 1.5 * actclamp)
    t_deact = tau_deact / (0.5 + 1.5 * actclamp)
    dctrl = ctrlclamp - act
    tau_hard = torch.where(dctrl > 0, t_act, t_deact)
    sig = _sigmoid(_div(dctrl, tausmooth) + 0.5)
    tau_smooth = t_deact + sig * (t_act - t_deact)
    return _div(dctrl, torch.where(tausmooth > 0, tau_smooth, tau_hard))


def _norm_length_vel(length, vel, lengthrange, prm):
    r0, r1 = prm[..., 0], prm[..., 1]
    L0 = _div(lengthrange[..., 1] - lengthrange[..., 0], r1 - r0)
    L = r0 + _div(length - lengthrange[..., 0], L0)
    V = _div(vel, L0 * prm[..., 6])
    return L, V


def _peak_force(acc0, prm):
    force, scale = prm[..., 2], prm[..., 3]
    return torch.where(force < 0, _div(scale, acc0), force)


def _bump(L, A, mid, B):
    """Quadratic spline bump: 0 at A and B, 1 at mid (the force-length curve)."""
    left = 0.5 * (A + mid)
    right = 0.5 * (mid + B)
    xl = _div(L - A, left - A)
    xm_l = _div(mid - L, mid - left)
    xm_r = _div(L - mid, right - mid)
    xr = _div(B - L, B - right)
    val = torch.where(L < left, 0.5 * xl * xl,
                      torch.where(L < mid, 1.0 - 0.5 * xm_l * xm_l,
                                  torch.where(L < right, 1.0 - 0.5 * xm_r * xm_r,
                                              0.5 * xr * xr)))
    return torch.where((L <= A) | (L >= B), 0.0, val)


def gain(length, vel, lengthrange, acc0, prm):
    """Active muscle gain (<= 0): -F0 FL(L) FV(V)."""
    L, V = _norm_length_vel(length, vel, lengthrange, prm)
    F0 = _peak_force(acc0, prm)
    fvmax = prm[..., 8]
    FL = _bump(L, prm[..., 4], 1.0, prm[..., 5])
    y = fvmax - 1.0
    FV = torch.where(V <= -1.0, 0.0,
                     torch.where(V <= 0.0, (V + 1.0) * (V + 1.0),
                                 torch.where(V <= y, fvmax - _div((y - V) * (y - V), y),
                                             fvmax)))
    return -F0 * FL * FV


def bias(length, lengthrange, acc0, prm):
    """Passive muscle force (<= 0): -F0 fpmax FP(L)."""
    L, _ = _norm_length_vel(length, torch.zeros_like(length), lengthrange, prm)
    F0 = _peak_force(acc0, prm)
    b = 0.5 * (prm[..., 5] + 1.0)
    x_mid = _div(L - 1.0, b - 1.0)
    x_hi = _div(L - b, b - 1.0)
    FP = torch.where(L <= 1.0, 0.0,
                     torch.where(L <= b, 0.5 * x_mid * x_mid, 0.5 + x_hi))
    return -F0 * prm[..., 7] * FP
