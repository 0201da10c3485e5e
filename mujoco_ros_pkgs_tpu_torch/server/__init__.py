from mujoco_ros_pkgs_tpu_torch.server.server import MujocoServer  # noqa: F401
