"""Joint-command hardware interface: mujoco_ros_control's DefaultRobotHWSim
as a control hook over the batch.

Counterpart of mujoco_ros_pkgs_tpu/plugins/ros_control.py. Reference
(mujoco_ros_control/src/default_robot_hw_sim.cpp): per-joint control
methods EFFORT / POSITION / POSITION_PID / VELOCITY / VELOCITY_PID with PID
gains from config (:195-214), joint-limit enforcement (:340-446), readSim
(qpos/qvel/qfrc_applied -> joint vectors, :230-246) and writeSim (:248-326):
  EFFORT        -> d->qfrc_applied
  POSITION      -> direct qpos write, zeroing qvel
  POSITION_PID  -> PID on angle error -> clamped effort
  VELOCITY      -> direct qvel write
  VELOCITY_PID  -> PID on velocity error
E-stop freezes position commands and zeroes efforts (:251-260, 272, 307).
The hosting plugin decimates to a control period inside mjcb_control
(mujoco_ros_control_plugin.cpp:153-194) and takes its joints from a URDF
robot_description's transmissions (:198-232); `<safety_controller>` soft
limits follow joint_limits_interface (velocity bounds -k_position (q -
soft_bound), effort bounds -k_velocity (v - vel_bound)).

The POSITION and VELOCITY writes land in the control hook, after the
position stage: as in the JAX package, they shape the rest of this step
(constraint rows, integration) and the next. Commands are set host-side;
the state holds every env's commands, PID integrators and previous errors
(nenv, njoint), e-stop flags and last update times (nenv,). Every joint
group is one batched gather or scatter: no per-joint Python loop runs in
the step.
"""

from __future__ import annotations

import enum
from typing import Any, Dict, Tuple

import numpy as np
import torch

from mujoco_ros_pkgs_tpu_torch.core.types import Data, JointType, Model
from mujoco_ros_pkgs_tpu_torch.ops import math as mmath
from mujoco_ros_pkgs_tpu_torch.plugins import urdf as urdf_mod
from mujoco_ros_pkgs_tpu_torch.plugins.base import MujocoPlugin


class ControlMethod(enum.IntEnum):
    EFFORT = 0
    POSITION = 1
    POSITION_PID = 2
    VELOCITY = 3
    VELOCITY_PID = 4


_EFFORT_CHANNEL = (int(ControlMethod.EFFORT), int(ControlMethod.POSITION_PID),
                   int(ControlMethod.VELOCITY_PID))


class HardwareSim:
    """The RobotHWSim seam (mujoco_ros_control/include/mujoco_ros_control/
    robot_hw_sim.h:62): `RosControlPlugin` hosts the implementation its
    config names (`hardware: {type: "..."}`), by default
    `DefaultRobotHWSim`; custom ones register with `register_hardware_sim`
    (mujoco_ros_control_plugin.cpp:126-147)."""

    def init_sim(self, plugin: "RosControlPlugin", m: Model) -> bool:
        """Bind to the hosting plugin's joint tables; False quarantines."""
        self.plugin = plugin
        return True

    def read_sim(self, m: Model, d: Data) -> Dict[str, Any]:
        """Joint state (nenv, njoint) (readSim, default_robot_hw_sim.cpp:230-246)."""
        p, dev = self.plugin, d.qpos.device
        qadrs = mmath.static_tensor(p.qpos_adr, dev, torch.int64)
        dofs = mmath.static_tensor(p.dof_adr, dev, torch.int64)
        return dict(position=d.qpos[:, qadrs], velocity=d.qvel[:, dofs],
                    effort=d.qfrc_applied[:, dofs])

    def write_sim(self, m: Model, d: Data, ps: Any) -> Tuple[Data, Any]:
        """Apply the commands to the batch (writeSim), inside the step's
        control hook; returns (d, state)."""
        raise NotImplementedError


_HW_REGISTRY: Dict[str, type] = {}


def register_hardware_sim(name: str, cls: type) -> None:
    """Register a custom HardwareSim implementation by type name."""
    if not issubclass(cls, HardwareSim):
        raise TypeError(f"{cls} must subclass HardwareSim")
    _HW_REGISTRY[name] = cls


class RosControlPlugin(MujocoPlugin):
    """config = {
        # EITHER a URDF whose <transmission> elements define the joints
        # (reference: mujoco_ros_control_plugin.cpp:198-232) ...
        "robot_description": "<robot ...>...</robot>" | "/path/robot.urdf",
        "pid_gains": {joint: [p, i, d, i_clamp]},   # upgrades POS/VEL -> *_PID
        # ... OR (additionally: overrides URDF entries) a hand-written table:
        "joints": {name: {"method": "POSITION_PID",
                          "pid": [p, i, d, i_clamp],
                          "effort_limit": float,
                          "position_limits": [lo, hi],
                          "velocity_limit": float,
                          "soft_limits": {"lower": .., "upper": ..,
                                           "k_position": .., "k_velocity": ..}}},
        "control_period": float (default: model timestep),
    }"""

    def load(self, m: Model, d: Data) -> bool:
        self._m = m
        cfg: Dict[str, dict] = {}
        desc = self.config.get("robot_description")
        if desc:
            try:
                cfg.update(urdf_mod.joints_config_from_urdf(
                    urdf_mod.parse_urdf(desc), self.config.get("pid_gains")))
            except ValueError as exc:
                self.load_error = str(exc)
                return False
        cfg.update(self.config.get("joints", {}))
        if not cfg:
            self.load_error = ("no joints configured (neither robot_description "
                               "transmissions nor a 'joints' table)")
            return False
        self.joint_ids, self.dof_adr, self.qpos_adr, self.methods = [], [], [], []
        pid, eff_lim, pos_lim, vel_lim, soft = [], [], [], [], []
        for name, jc in cfg.items():
            if name not in m.jnt_names:
                self.load_error = (f"joint '{name}' (from a URDF transmission or "
                                   f"joints table) does not exist in the MJCF model")
                return False
            j = m.joint(name)
            if m.jnt_type[j] not in (int(JointType.HINGE), int(JointType.SLIDE)):
                self.load_error = f"joint '{name}' is not 1-dof"
                return False
            self.joint_ids.append(j)
            self.dof_adr.append(m.jnt_dofadr[j])
            self.qpos_adr.append(m.jnt_qposadr[j])
            self.methods.append(int(ControlMethod[jc.get("method", "EFFORT")]))
            pid.append(jc.get("pid", [0.0, 0.0, 0.0, 0.0]))
            eff_lim.append(jc.get("effort_limit", np.inf))
            pos_lim.append(jc.get("position_limits", [-np.inf, np.inf]))
            vel_lim.append(jc.get("velocity_limit", np.inf))
            sl = jc.get("soft_limits")
            soft.append([1.0, sl.get("lower", -np.inf), sl.get("upper", np.inf),
                         sl.get("k_position", 0.0), sl.get("k_velocity", 0.0)]
                        if sl else [0.0, -np.inf, np.inf, 0.0, 0.0])
        self.pid = np.array(pid, dtype=np.float64)           # (nj, 4)
        self.eff_lim = np.array(eff_lim, dtype=np.float64)
        self.pos_lim = np.array(pos_lim, dtype=np.float64)   # (nj, 2)
        self.vel_lim = np.array(vel_lim, dtype=np.float64)
        self.soft = np.array(soft, dtype=np.float64)         # (nj, 5)
        self.control_period = float(self.config.get("control_period",
                                                    float(m.opt.timestep)))
        hw_cfg = self.config.get("hardware", {}) or {}
        hw_type = hw_cfg.get("type", "mujoco_ros_control/DefaultRobotHWSim")
        hw_cls = _HW_REGISTRY.get(hw_type)
        if hw_cls is None:
            raise ValueError(f"unknown hardware sim type '{hw_type}' "
                             f"(registered: {sorted(_HW_REGISTRY)})")
        self.hw = hw_cls()
        if hw_cfg.get("control_period") is not None:
            self.control_period = float(hw_cfg["control_period"])
        return bool(self.hw.init_sim(self, m))

    def init_state(self, m: Model, nenv: int) -> Any:
        z = torch.zeros(nenv, len(self.joint_ids), dtype=m.qpos0.dtype, device=m.device)
        return dict(command=z, integral=z.clone(), prev_err=z.clone(),
                    estop=torch.zeros(nenv, dtype=torch.bool, device=m.device),
                    last_update=torch.full((nenv,), -torch.inf, dtype=z.dtype,
                                           device=m.device))

    # -- host-side control plane --
    def set_commands(self, ps: Any, commands) -> Any:
        """New state with the commands (njoint,) of every env or (nenv,
        njoint), in the plugin's joint order."""
        cmd = ps["command"]
        c = torch.as_tensor(np.asarray(commands, dtype=np.float64), dtype=cmd.dtype)
        return dict(ps, command=c.to(cmd.device).expand_as(cmd).clone())

    def set_estop(self, ps: Any, active: bool) -> Any:
        return dict(ps, estop=torch.full_like(ps["estop"], bool(active)))

    def control(self, m: Model, d: Data, ps: Any) -> Tuple[Data, Any]:
        """controlCallback: control-period decimation, then readSim / update
        / writeSim through the hosted HardwareSim
        (mujoco_ros_control_plugin.cpp:153-194)."""
        return self.hw.write_sim(m, d, ps)


class DefaultRobotHWSim(HardwareSim):
    """The reference's DefaultRobotHWSim: EFFORT / POSITION / POSITION_PID /
    VELOCITY / VELOCITY_PID with PID, hard and URDF soft joint limits, e-stop
    (default_robot_hw_sim.cpp:84-446), batched over the envs."""

    def write_sim(self, m: Model, d: Data, ps: Any) -> Tuple[Data, Any]:
        return _default_write_sim(self.plugin, m, d, ps)


register_hardware_sim("mujoco_ros_control/DefaultRobotHWSim", DefaultRobotHWSim)


def _default_write_sim(p: RosControlPlugin, m: Model, d: Data, ps: Any):
    dtype, dev = d.qpos.dtype, d.qpos.device

    def t(a, dt=dtype):
        return mmath.static_tensor(a, dev, dt)
    dofs, qadrs = t(p.dof_adr, torch.int64), t(p.qpos_adr, torch.int64)
    q, v = d.qpos[:, qadrs], d.qvel[:, dofs]
    cmd, estop = ps["command"].to(dtype), ps["estop"][:, None]
    dt = m.opt.timestep.to(dtype)

    # control-period decimation of the PID update
    do_update = (d.time - ps["last_update"]) >= (p.control_period - 1e-12)
    last_update = torch.where(do_update, d.time, ps["last_update"])
    upd = do_update[:, None]

    pid_p, pid_i, pid_d, i_clamp = (t(p.pid[:, k]) for k in range(4))
    eff_lim, vel_lim = t(p.eff_lim), t(p.vel_lim)
    pos_lo, pos_hi = t(p.pos_lim[:, 0]), t(p.pos_lim[:, 1])
    methods = np.array(p.methods)

    # PID, shared by POSITION_PID and VELOCITY_PID
    err_pos = torch.clamp(cmd, pos_lo, pos_hi) - q
    err_vel = torch.clamp(cmd, -vel_lim, vel_lim) - v
    err = torch.where(t(methods == int(ControlMethod.POSITION_PID), torch.bool),
                      err_pos, err_vel)
    integral = torch.where(upd, torch.clamp(ps["integral"] + err * dt, -i_clamp, i_clamp),
                           ps["integral"])
    deriv = torch.where(upd, (err - ps["prev_err"]) / dt, 0.0)
    prev_err = torch.where(upd, err, ps["prev_err"])
    pid_out = torch.clamp(pid_p * err + pid_i * integral + pid_d * deriv, -eff_lim, eff_lim)

    # joint_limits_interface soft-limit bounds (URDF <safety_controller>,
    # default_robot_hw_sim.cpp:340-446): the position error bounds the
    # velocity, the velocity error bounds the effort
    has_soft = t(p.soft[:, 0] > 0.5, torch.bool)
    soft_lo, soft_hi, k_p, k_v = (t(p.soft[:, k]) for k in range(1, 5))
    vel_min = torch.clamp(-k_p * (q - soft_lo), -vel_lim, vel_lim)
    vel_max = torch.clamp(-k_p * (q - soft_hi), -vel_lim, vel_lim)
    eff_min = torch.clamp(-k_v * (v - vel_min), -eff_lim, eff_lim)
    eff_max = torch.clamp(-k_v * (v - vel_max), -eff_lim, eff_lim)

    qfrc, qpos, qvel = d.qfrc_applied, d.qpos, d.qvel
    # effort channel: EFFORT and both PID methods
    eff_g = np.nonzero(np.isin(methods, _EFFORT_CHANNEL))[0]
    if eff_g.size:
        e_all = torch.where(t(methods == int(ControlMethod.EFFORT), torch.bool),
                            torch.clamp(cmd, -eff_lim, eff_lim), pid_out)
        e_all = torch.where(has_soft, torch.clamp(e_all, eff_min, eff_max), e_all)
        e_all = torch.where(estop, 0.0, e_all)
        qfrc = qfrc.clone()
        qfrc[:, dofs[t(eff_g, torch.int64)]] = e_all[:, t(eff_g, torch.int64)]
    # POSITION: direct write, qvel zeroed; e-stop freezes
    pos_g = np.nonzero(methods == int(ControlMethod.POSITION))[0]
    if pos_g.size:
        g = t(pos_g, torch.int64)
        tgt = torch.clamp(cmd, pos_lo, pos_hi)
        dtc = p.control_period
        tgt = torch.where(has_soft, torch.clamp(tgt, q + vel_min * dtc, q + vel_max * dtc),
                          tgt)
        tgt = torch.where(estop, q, tgt)
        qpos, qvel = qpos.clone(), qvel.clone()
        qpos[:, qadrs[g]] = tgt[:, g]
        qvel[:, dofs[g]] = 0.0
    # VELOCITY: direct write; e-stop zeroes
    vel_g = np.nonzero(methods == int(ControlMethod.VELOCITY))[0]
    if vel_g.size:
        g = t(vel_g, torch.int64)
        vt = torch.clamp(cmd, -vel_lim, vel_lim)
        vt = torch.where(has_soft, torch.clamp(vt, vel_min, vel_max), vt)
        vt = torch.where(estop, 0.0, vt)
        qvel = qvel.clone() if qvel is d.qvel else qvel
        qvel[:, dofs[g]] = vt[:, g]

    nps = dict(ps, integral=integral, prev_err=prev_err, last_update=last_update)
    return d.replace(qfrc_applied=qfrc, qpos=qpos, qvel=qvel), nps
