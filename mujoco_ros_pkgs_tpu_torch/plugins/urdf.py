"""Minimal URDF reader for the ros_control bridge.

The reference blocks until `robot_description` appears on the parameter
server, parses it with urdf::Model, and walks `<transmission>` elements to
decide which joints the hardware interface owns and how to drive them
(mujoco_ros_control/src/mujoco_ros_control_plugin.cpp:198-232). Joint limits
come from the same URDF: hard `<limit>` plus `<safety_controller>` soft
limits, enforced through joint_limits_interface saturation / soft-limit
handles (mujoco_ros_control/src/default_robot_hw_sim.cpp:340-446).

This module is the host-side analogue: stdlib ElementTree parsing into plain
dataclasses the RosControlPlugin consumes. No ROS types; the semantic
content (interfaces, limits, soft-limit gains) is identical. It is the
port's own copy of mujoco_ros_pkgs_tpu/plugins/urdf.py, which the port
cannot import (that package imports JAX).
"""

from __future__ import annotations

import math
import xml.etree.ElementTree as ET
from dataclasses import dataclass, field
from typing import Dict, List, Optional


@dataclass
class UrdfJointLimits:
    lower: float = -math.inf
    upper: float = math.inf
    effort: float = math.inf
    velocity: float = math.inf
    # <safety_controller> — present iff has_soft
    has_soft: bool = False
    soft_lower: float = -math.inf
    soft_upper: float = math.inf
    k_position: float = 0.0
    k_velocity: float = 0.0


@dataclass
class UrdfTransmission:
    name: str
    joint: str
    hardware_interface: str      # e.g. "hardware_interface/EffortJointInterface"
    mechanical_reduction: float = 1.0


@dataclass
class UrdfModel:
    name: str = ""
    joint_limits: Dict[str, UrdfJointLimits] = field(default_factory=dict)
    transmissions: List[UrdfTransmission] = field(default_factory=list)
    # joint name -> URDF joint type (revolute/prismatic/continuous/fixed/...)
    joint_types: Dict[str, str] = field(default_factory=dict)


def _strip_ns(tag: str) -> str:
    return tag.rsplit("}", 1)[-1]


def parse_urdf(source: str) -> UrdfModel:
    """Parse a URDF document (XML string, or a path to one).

    Raises ValueError (with the offending element) on malformed input —
    mirroring the reference's hard failure when robot_description is
    unusable (mujoco_ros_control_plugin.cpp:198-226)."""
    text = source
    if "<" not in source:  # path, not document
        with open(source, "r") as f:
            text = f.read()
    try:
        root = ET.fromstring(text)
    except ET.ParseError as exc:
        raise ValueError(f"URDF parse error: {exc}") from exc
    if _strip_ns(root.tag) != "robot":
        raise ValueError(f"URDF root element is <{root.tag}>, expected <robot>")

    model = UrdfModel(name=root.get("name", ""))

    for el in root:
        tag = _strip_ns(el.tag)
        if tag == "joint":
            name = el.get("name")
            if not name:
                raise ValueError("URDF <joint> without a name")
            jtype = el.get("type", "fixed")
            model.joint_types[name] = jtype
            lim = UrdfJointLimits()
            lim_el = el.find("limit")
            if lim_el is not None:
                lim.lower = float(lim_el.get("lower", -math.inf))
                lim.upper = float(lim_el.get("upper", math.inf))
                lim.effort = float(lim_el.get("effort", math.inf))
                lim.velocity = float(lim_el.get("velocity", math.inf))
            if jtype == "continuous":
                lim.lower, lim.upper = -math.inf, math.inf
            safety = el.find("safety_controller")
            if safety is not None:
                lim.has_soft = True
                lim.soft_lower = float(safety.get("soft_lower_limit",
                                                  lim.lower))
                lim.soft_upper = float(safety.get("soft_upper_limit",
                                                  lim.upper))
                lim.k_position = float(safety.get("k_position", 0.0))
                lim.k_velocity = float(safety.get("k_velocity", 0.0))
            model.joint_limits[name] = lim
        elif tag == "transmission":
            tname = el.get("name", "")
            joint_el = el.find("joint")
            if joint_el is None:
                raise ValueError(
                    f"URDF transmission '{tname}' has no <joint>")
            jname = joint_el.get("name")
            hw_el = joint_el.find("hardwareInterface")
            if hw_el is None or not (hw_el.text or "").strip():
                raise ValueError(
                    f"URDF transmission '{tname}' joint '{jname}' has no "
                    f"<hardwareInterface> (the reference refuses such "
                    f"transmissions, default_robot_hw_sim.cpp:96-110)")
            red_el = el.find("actuator/mechanicalReduction")
            reduction = float(red_el.text) if red_el is not None else 1.0
            model.transmissions.append(UrdfTransmission(
                name=tname, joint=jname,
                hardware_interface=(hw_el.text or "").strip(),
                mechanical_reduction=reduction))
    return model


# hardware-interface name -> base control method name (the reference maps
# these in DefaultRobotHWSim::initSim, default_robot_hw_sim.cpp:112-158;
# *_PID is selected when PID gains are configured for the joint)
HW_IFACE_METHOD = {
    "hardware_interface/EffortJointInterface": "EFFORT",
    "hardware_interface/PositionJointInterface": "POSITION",
    "hardware_interface/VelocityJointInterface": "VELOCITY",
    # short forms the reference also accepts
    "EffortJointInterface": "EFFORT",
    "PositionJointInterface": "POSITION",
    "VelocityJointInterface": "VELOCITY",
}


def joints_config_from_urdf(model: UrdfModel,
                            pid_gains: Optional[Dict[str, list]] = None
                            ) -> Dict[str, dict]:
    """Build the RosControlPlugin `joints` table from URDF transmissions.

    Mirrors DefaultRobotHWSim::initSim joint registration: one joint per
    transmission, control method from the hardware interface (upgraded to the
    *_PID variant when `pid_gains[joint]` is provided — the reference reads
    these from rosparam `pid_gains/<joint>`, default_robot_hw_sim.cpp:195-214),
    hard limits from <limit>, soft limits from <safety_controller>."""
    pid_gains = pid_gains or {}
    joints: Dict[str, dict] = {}
    for trn in model.transmissions:
        iface = trn.hardware_interface
        if iface not in HW_IFACE_METHOD:
            raise ValueError(
                f"transmission '{trn.name}': unsupported hardware interface "
                f"'{iface}'")
        method = HW_IFACE_METHOD[iface]
        pid = pid_gains.get(trn.joint)
        if pid is not None and method in ("POSITION", "VELOCITY"):
            method += "_PID"
        lim = model.joint_limits.get(trn.joint, UrdfJointLimits())
        jc = {
            "method": method,
            "effort_limit": lim.effort,
            "position_limits": [lim.lower, lim.upper],
            "velocity_limit": lim.velocity,
        }
        if pid is not None:
            jc["pid"] = list(pid)
        if lim.has_soft:
            jc["soft_limits"] = {
                "lower": lim.soft_lower, "upper": lim.soft_upper,
                "k_position": lim.k_position, "k_velocity": lim.k_velocity,
            }
        joints[trn.joint] = jc
    if not joints:
        raise ValueError("URDF has no transmissions — nothing to control "
                         "(the reference blocks on this, "
                         "mujoco_ros_control_plugin.cpp:228-232)")
    return joints
