"""Constraint solve of the general step (mj_fwdConstraint's solver).

Counterpart of mujoco_ros_pkgs_tpu/ops/solver.py for the route the JAX
package takes on a float32 batch when its fused solver kernel applies
(`solve` -> `_solve_dispatch_tpu`): the whole Newton solve in one call of
ops/solver_tpu.solve_batched (the K2 kernel on CUDA), at most 32 Newton
trips, a 7-point grid line search and max(2, min(ls_iterations, 24) // 3)
polish steps. CG, PGS and systems beyond the kernel (nv > 16 or more than
64 rows; the JAX package's `_solve_jnp` Newton) raise NotImplementedError.
"""

from __future__ import annotations

from mujoco_ros_pkgs_tpu_torch.core.types import Data, DisableBit, Model, SolverType
from mujoco_ros_pkgs_tpu_torch.ops import solver_tpu


def solve(m: Model, d: Data, efc) -> Data:
    """The Newton solve of efc's rows (ops/efc.Efc) from d.qacc_smooth and
    d.qacc_warmstart; sets qacc, qfrc_constraint, efc_force_contact (the
    row forces) and qacc_warmstart (the solution), as _solve_dispatch_tpu
    does."""
    if int(m.opt.solver) != int(SolverType.NEWTON):
        raise NotImplementedError("solver: only the Newton solver is ported to "
                                  "the torch package (CG and PGS are not)")
    if not solver_tpu.supports(efc, m.nv):
        raise NotImplementedError(
            f"solver: nv={m.nv} with {len(efc.kinds)} rows is beyond the fused "
            "Newton kernel (nv <= 16, <= 64 rows); the general Newton solve is "
            "not ported to the torch package")
    niter, nls = solver_tpu.trip_counts(m)
    x, qfrc, frows = solver_tpu.solve_batched(
        efc.kinds, tuple(zip(efc.con_base, efc.con_dim)), m.nv, niter, nls,
        m.opt.tolerance, not m.opt.disableflags & DisableBit.WARMSTART,
        efc.J, efc.aref, efc.D, efc.frictionloss, efc.active, efc.con_mu,
        d.qM, d.qacc_smooth, d.qacc_warmstart)
    return d.replace(qacc=x, qfrc_constraint=qfrc, efc_force_contact=frows,
                     qacc_warmstart=x)
