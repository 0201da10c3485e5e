from mujoco_ros_pkgs_tpu_torch.server.server import (  # noqa: F401
    AdminHashError, LockDisciplineError, MujocoServer,
)
