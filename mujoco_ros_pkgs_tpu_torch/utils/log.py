"""Named, per-subsystem loggers: the rosconsole analogue.

Counterpart of mujoco_ros_pkgs_tpu/utils/log.py. The reference configures
per-logger levels through a rosconsole config file
(mujoco_ros/config/rosconsole.config) and logs through named loggers
("mujoco", "sensors", "mujoco_ros_plugin_loader", ...). Here every subsystem
logs through ``get_logger(<subsystem>)``, children of one
``mujoco_ros_pkgs_tpu_torch`` root, and ``configure()`` applies a
{logger: level} map from the CLI (--log-level, --verbose).
"""

from __future__ import annotations

import logging
import sys
from typing import Dict, Optional

ROOT = "mujoco_ros_pkgs_tpu_torch"

_FORMAT = "[%(levelname)s] [%(asctime)s] [%(name)s]: %(message)s"
_configured = False


def get_logger(subsystem: str = "") -> logging.Logger:
    """Logger of a subsystem ('server', 'launch', ...); empty: the package
    root logger."""
    return logging.getLogger(f"{ROOT}.{subsystem}" if subsystem else ROOT)


def configure(levels: Optional[Dict[str, str]] = None,
              default_level: str = "WARNING", stream=None) -> None:
    """Install a stderr handler on the package root and apply per-logger
    levels, e.g. {"server": "DEBUG"}. The handler is added once; the levels
    are applied on every call."""
    global _configured
    root = logging.getLogger(ROOT)
    if not _configured:
        h = logging.StreamHandler(stream or sys.stderr)
        h.setFormatter(logging.Formatter(_FORMAT, datefmt="%H:%M:%S"))
        root.addHandler(h)
        root.propagate = False
        _configured = True
    root.setLevel(getattr(logging, default_level.upper(), logging.WARNING))
    for sub, lvl in (levels or {}).items():
        name = sub if sub.startswith(ROOT) else f"{ROOT}.{sub}"
        logging.getLogger(name).setLevel(getattr(logging, str(lvl).upper(), logging.WARNING))


def parse_level_spec(spec: str) -> Dict[str, str]:
    """Parse 'server=debug,launch=error' (the CLI form of the level map)."""
    levels: Dict[str, str] = {}
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        if "=" not in part:
            raise ValueError(f"bad log level spec '{part}' (want name=level)")
        name, lvl = part.split("=", 1)
        levels[name.strip()] = lvl.strip()
    return levels
