"""mujoco_ros_pkgs_tpu_torch — the PyTorch + CUDA port of mujoco_ros_pkgs_tpu.

The JAX package beside it stays the reference. This package imports torch
and numpy only. Today it compiles MJCF models (core/), steps single-free-body
models such as the BOXES world through a hand-written Hopper kernel
(ops/step_tpu.py, csrc/, kernels.py) or its plain-torch twin on the CPU,
steps trees, contact-rich worlds, actuators, sensors, mocap bodies and
equality constraints on the general route (ops/forward.py), and serves them
(server/) with plugins (plugins/: sensors, mocap, ros_control).
"""

__version__ = "0.1.0"

from mujoco_ros_pkgs_tpu_torch.core.types import Data, Model, Option  # noqa: F401
from mujoco_ros_pkgs_tpu_torch.core.mjcf import load_model, load_model_from_string  # noqa: F401
