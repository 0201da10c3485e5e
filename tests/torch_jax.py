"""The JAX package's model loader for the port's CPU tests, compiled once.

`jax_load(xml, **kw)` is `mujoco_ros_pkgs_tpu.core.mjcf.load_model_from_string`
with the package's `constants.set_constants` (mj_setConst: the mass matrix's
inverse at qpos0 and what it gives) run under one `jax.jit` instead of op
by op: the same function, traced and compiled once a model structure
instead of dispatched primitive by primitive (a HUMANOID loads in about a
quarter of the time, a PILE in a fifth). It loads with one BLAS thread:
numpy's eigensolver behind the ellipsoid fluid model's 400-point quadrature
runs some 40 times slower with a thread per core on a busy machine. Its
rounding differs from the op-by-op load's at 1e-16 relative, past atol
1e-12 on large fields (PENDULUM's dof_invweight0 of 401), so compile checks
at that tolerance load op by op. Imports JAX; the port's own modules and
chip_smoke.py never import this file.
"""

from unittest import mock

import jax
from threadpoolctl import threadpool_limits

from mujoco_ros_pkgs_tpu.core import constants as jconstants
from mujoco_ros_pkgs_tpu.core import mjcf as jmjcf

_SET_CONSTANTS = jax.jit(jconstants.set_constants)


def jax_load(xml: str, **kw):
    """The JAX package's compile of xml (load_model_from_string's keywords:
    dtype, pair_topk, con_topk, base_dir)."""
    with mock.patch.object(jconstants, "set_constants", _SET_CONSTANTS), \
            threadpool_limits(1):
        return jmjcf.load_model_from_string(xml, **kw)
