"""The fused Newton constraint solve (K2) and its plain-torch body.

Counterpart of mujoco_ros_pkgs_tpu/ops/solver_tpu.py: `_row_forces` and
`newton_tiles` written batch-first (the (8, 128) env tiles of the JAX
kernel become the leading env axis, the per-row / per-dof Python lists
stacked tensor axes), `supports` and `solve_batched`. On a CUDA
tensor `solve_batched` launches the hand-written kernel csrc/solver.cu
(kernels.newton_solve, the general path's solver); on a CPU tensor it runs
`newton_tiles`. `newton_tiles` is also the plain version of the device
functions in csrc/newton.cuh that the fused step kernel (ops/step_tpu.py,
csrc/step_fused.cu) runs. The CPU tests hold it against the JAX kernel in
interpret mode. Its Cholesky solve is linalg_tpu.psd_solve_plain, the
right-looking factorisation that csrc/solver.cu runs; the JAX kernel and
csrc/newton.cuh factor left-looking, which differs from it only in the
rounding of an SPD system.

Shapes: J (B, nefc, nv); aref, D, floss, act (B, nefc); mu (B, ncon, 5) in
MuJoCo order [mu_t1, mu_t2, mu_tor, mu_roll1, mu_roll2]; M (B, nv, nv)
symmetric; a_s, ws (B, nv). Row kinds: 'eq', 'fri', 'lim' or 'con';
`con_base` lists (first row, condim) per contact.
"""

from __future__ import annotations

import functools
import warnings
from typing import Dict, Tuple

import torch

from mujoco_ros_pkgs_tpu_torch.ops import linalg_tpu
from mujoco_ros_pkgs_tpu_torch.ops.math import MINVAL

_GRID_ALPHAS = (0.0625, 0.25, 0.5, 1.0, 2.0, 4.0, 16.0)
# tangential sigma per cone component: [mu0, mu0, mu_tor, mu_roll1, mu_roll2]
_SIGMA_COL = (0, 0, 2, 3, 4)
# how a row is solved (row_codes; csrc/solver.cu reads the same codes):
# always on, Huber friction loss, one-sided, part of an elliptic cone
ROW_CODE = {"eq": 0, "fri": 1, "lim": 2, "con": 3}


def row_codes(kinds, con_base) -> list:
    """How each row is solved, as the JAX kernel decides it: a row of a
    contact of condim > 1 is a cone row (3); the row of a condim-1 contact
    is one-sided (2); any other row goes by its kind, 'eq' (0), 'fri' (1),
    and every other kind one-sided (2)."""
    codes = [ROW_CODE[k] if k in ("eq", "fri") else ROW_CODE["lim"] for k in kinds]
    for base, dim in con_base:
        for r in range(base, base + dim):
            codes[r] = ROW_CODE["con"] if dim > 1 else ROW_CODE["lim"]
    return codes


def _cone_groups(con_base) -> Dict[int, Tuple[list, list]]:
    """Contacts grouped by condim > 1: dim -> (contact indices, row bases)."""
    groups: Dict[int, Tuple[list, list]] = {}
    for ci, (base, dim) in enumerate(con_base):
        if dim > 1:
            cis, bases = groups.setdefault(dim, ([], []))
            cis.append(ci)
            bases.append(base)
    return groups


def _row_forces(kinds, con_base, mu, D, floss, act, jar, want_w):
    """Forces for every efc row; leading dims of jar (e.g. (B,) or (B, K))
    broadcast against D/floss/act (B, nefc) and mu (B, ncon, 5) by adding
    singleton axes after the env axis.

    Diagonal rows ('eq'/'fri'/'lim' and condim-1 contacts) get per-row
    weights w; elliptic cones (condim 3/4/6) get a dim x dim Hessian block
    per contact — the model of ops/solver.py in the JAX package.

    Returns (f, w, cost, W) with W = {dim: (row index (n, dim), block
    (..., n, dim, dim))}."""
    extra = jar.dim() - D.dim()

    def lift(t):
        return t.reshape(t.shape[:1] + (1,) * extra + t.shape[1:]) if extra else t

    D, floss, act = lift(D), lift(floss), lift(act)
    dev = jar.device
    codes = row_codes(kinds, con_base)
    is_eq = torch.tensor([c == ROW_CODE["eq"] for c in codes], device=dev)
    is_fri = torch.tensor([c == ROW_CODE["fri"] for c in codes], device=dev)
    is_lim = torch.tensor([c == ROW_CODE["lim"] for c in codes], device=dev)

    # eq: always on; fri: Huber; lim / condim-1 contact: one-sided quadratic
    quad_c = 0.5 * D * jar * jar
    f_unc = -D * jar
    lin = torch.abs(f_unc) > floss
    one_sided = act & (jar < 0)
    f = torch.where(is_eq & act, f_unc,
                    torch.where(is_fri & act, torch.clamp(f_unc, -floss, floss),
                                torch.where(is_lim & one_sided, f_unc, 0.0)))
    w = torch.where((is_eq & act) | (is_fri & act & ~lin) | (is_lim & one_sided),
                    D, 0.0)
    c_fri = torch.where(lin, floss * torch.abs(jar)
                        - 0.5 * floss * floss / torch.clamp(D, min=MINVAL), quad_c)
    cost = torch.where(is_eq & act, quad_c,
                       torch.where(is_fri & act, c_fri,
                                   torch.where(is_lim & one_sided, quad_c, 0.0)))
    cost = cost.sum(-1)

    W = {}
    for dim, (cis, bases) in _cone_groups(con_base).items():
        nt = dim - 1
        idx = torch.tensor([[b + k for k in range(dim)] for b in bases], device=dev)
        u = jar[..., idx]                                   # (..., n, dim)
        Dv = D[..., idx]
        a = act[..., idx[:, 0]]                             # (..., n)
        mu_c = lift(mu[:, cis])                             # (..., n, 5)
        sig = torch.clamp(mu_c[..., list(_SIGMA_COL[:nt])], min=MINVAL)
        Dn = Dv[..., 0]
        P_n = -Dn * u[..., 0]
        P_t = -Dv[..., 1:] * u[..., 1:]
        ph = P_t / sig
        Dh = Dv[..., 1:] / (sig * sig)
        T = torch.sqrt(torch.clamp((ph * ph).sum(-1), min=MINVAL * MINVAL))
        inside = T <= P_n
        Dbar = Dh.sum(-1) / nt
        fn_mid = (P_n / Dn + T / Dbar) / (1.0 / Dn + 1.0 / Dbar)
        polar = fn_mid <= 0.0
        f_n = torch.where(inside, P_n, torch.where(polar, 0.0, fn_mid))
        dirs = ph / T[..., None]
        ft = sig * torch.where(inside[..., None], ph,
                               torch.where(polar[..., None], 0.0,
                                           fn_mid[..., None] * dirs))
        fc = torch.cat([torch.where(a, f_n, 0.0)[..., None],
                        torch.where(a[..., None], ft, 0.0)], -1)
        f = _scatter(f, idx, fc)
        Pfull = torch.cat([P_n[..., None], P_t], -1)
        c = (0.5 * (Dv * u * u).sum(-1)
             - 0.5 * ((Pfull - fc) ** 2 / Dv).sum(-1))
        cost = cost + torch.where(a, c, 0.0).sum(-1)
        if not want_w:
            continue
        A = Dn * Dbar / (Dn + Dbar)
        btt = fn_mid * Dbar / T
        # W_tt = sig sig^T o [btt I + (A - btt) d d^T]; W_t0 = A sig d
        Wt = (sig[..., :, None] * sig[..., None, :]) * (
            (A - btt)[..., None, None] * (dirs[..., :, None] * dirs[..., None, :])
            + btt[..., None, None] * torch.eye(nt, dtype=D.dtype, device=dev))
        Wt0 = A[..., None] * sig * dirs
        Wm = torch.cat([torch.cat([A[..., None, None], Wt0[..., None, :]], -1),
                        torch.cat([Wt0[..., :, None], Wt], -1)], -2)
        Wm = torch.where(inside[..., None, None], torch.diag_embed(Dv), Wm)
        Wm = torch.where((polar | ~a)[..., None, None], 0.0, Wm)
        W[dim] = (idx, Wm)
    return f, w, cost, W


def _scatter(f, idx, vals):
    """f[..., idx] = vals (out of place)."""
    out = f.clone()
    out[..., idx] = vals
    return out


def newton_tiles(nv, kinds, con_base, niter, nls, warmstart, tol, J, aref, D,
                 floss, act, mu, M, a_s, ws, trips=None):
    """The whole Newton constraint solve on a batch. Returns (x (B, nv),
    f (B, nefc)). Up to `niter` Newton steps; an env's x freezes once it
    converges, and the loop stops when every env has. If `trips` is a list,
    the Newton trips each env took ((B,) int64) are appended to it."""
    def Mmul(v):
        return (M @ v[..., None])[..., 0]

    def jar_at(x):
        return (J @ x[..., None])[..., 0] - aref

    def forces(jar, want_w):
        return _row_forces(kinds, con_base, mu, D, floss, act, jar, want_w)

    def cost_at(x):
        dx = x - a_s
        return 0.5 * (Mmul(dx) * dx).sum(-1) + forces(jar_at(x), False)[2]

    x = a_s
    if warmstart:
        better = cost_at(ws) < cost_at(a_s)
        x = torch.where(better[:, None], ws, a_s)
    scale = torch.clamp(torch.abs(Mmul(a_s)).sum(-1), min=MINVAL)
    done = torch.zeros(x.shape[0], dtype=torch.bool, device=x.device)
    taken = torch.zeros(x.shape[0], dtype=torch.int64, device=x.device)
    alphas = torch.tensor(_GRID_ALPHAS, dtype=x.dtype, device=x.device)
    eye = torch.eye(nv, dtype=x.dtype, device=x.device)

    def cone_quad(Wd, vec):
        """sum over contacts of v_c^T W_c v_c, vec (..., nefc)."""
        out = 0.0
        for idx, Wm in Wd.values():
            vc = vec[..., idx]
            out = out + (vc[..., :, None] * Wm * vc[..., None, :]).sum((-1, -2, -3))
        return out

    for _ in range(niter):
        jar = jar_at(x)
        f, w, _, Wc = forces(jar, True)
        xs = x - a_s
        grad = Mmul(xs) - (J * f[..., None]).sum(-2)
        H = M + torch.einsum("bri,br,brj->bij", J, w, J) + 1e-12 * eye
        for idx, Wm in Wc.values():
            Jc = J[:, idx]                                   # (B, n, dim, nv)
            H = H + torch.einsum("bcki,bckl,bclj->bij", Jc, Wm, Jc)
        dx = linalg_tpu.psd_solve_plain(H, -grad)
        v_ls = (J @ dx[..., None])[..., 0]
        Mdx = Mmul(dx)
        gMd = (Mdx * xs).sum(-1)
        dMd = (Mdx * dx).sum(-1)

        # vectorized bracket: phi'(alpha) over the static grid at once
        jj = jar[:, None, :] + alphas[None, :, None] * v_ls[:, None, :]
        fa = forces(jj, False)[0]
        d1g = (gMd[:, None] + alphas[None, :] * dMd[:, None]
               - (fa * v_ls[:, None, :]).sum(-1))
        lo = torch.zeros_like(gMd)
        hi = torch.full_like(gMd, _GRID_ALPHAS[-1])
        found_hi = torch.zeros_like(done)
        for k, a in enumerate(_GRID_ALPHAS):
            neg = d1g[:, k] < 0
            lo = torch.where(neg, a, lo)
            hi = torch.where(~neg & ~found_hi, a, hi)
            found_hi = found_hi | ~neg
        hi = torch.maximum(hi, lo)

        alpha = 0.5 * (lo + hi)
        for _k in range(nls):
            fa, wa, _, Wa = forces(jar + alpha[:, None] * v_ls, True)
            d1 = gMd + alpha * dMd - (fa * v_ls).sum(-1)
            d2 = dMd + (wa * v_ls * v_ls).sum(-1) + cone_quad(Wa, v_ls)
            n1 = d1 < 0
            lo = torch.where(n1, alpha, lo)
            hi = torch.where(~n1, alpha, hi)
            newton = alpha - d1 / torch.clamp(d2, min=MINVAL)
            inb = (newton > lo) & (newton < hi)
            alpha = torch.where(inb, newton, 0.5 * (lo + hi))

        improved_est = -0.5 * alpha * (grad * dx).sum(-1)
        gradsq = (grad * grad).sum(-1)
        new_done = done | (improved_est < tol * scale) | (gradsq < tol * tol)
        x = torch.where(done[:, None], x, x + alpha[:, None] * dx)
        taken = taken + (~done).long()
        done = new_done
        if bool(done.all()):
            break

    if trips is not None:
        trips.append(taken)
    f, _, _, _ = forces(jar_at(x), False)
    return x, f


# ---------------------------------------------------------------------------
# the batched solve (K2)
# ---------------------------------------------------------------------------

MAX_NV = 16              # the largest system csrc/solver.cu takes
MAX_ROWS = 64


def supports(efc, nv: int) -> bool:
    """The JAX package's gate: condim 1/3/4/6 cones, 1..64 rows, nv <= 16,
    the rows counted in the canonical layout (a con_topk compaction changes
    no route)."""
    return supports_rows(efc.kinds, efc.con_dim, nv)


def supports_rows(kinds, con_dim, nv: int) -> bool:
    """`supports` from a row layout's kinds and elliptic condims."""
    return (all(dim in (1, 3, 4, 6) for dim in con_dim)
            and 1 <= len(kinds) <= MAX_ROWS and nv <= MAX_NV)


def trip_counts(m):
    """(Newton trips, line-search polish steps) of the fused solve of model
    `m`; warns when opt.iterations is truncated to 32, as the JAX package
    does."""
    if m.opt.iterations > 32:
        warnings.warn(
            f"solver_tpu: m.opt.iterations={m.opt.iterations} truncated to 32 "
            "in the fused Newton kernel (fixed-trip Newton)", stacklevel=2)
    return (min(int(m.opt.iterations), 32),
            max(2, min(int(m.opt.ls_iterations), 24) // 3))


def kernel_meta(kinds, con_base, nv, niter, nls, warmstart) -> list:
    """The solve's static structure for csrc/solver.cu as int32 values:
    [nv, nefc, ncon, niter, nls, warmstart], one row code per row
    (row_codes), then (first row, condim) per contact."""
    meta = [nv, len(kinds), len(con_base), niter, nls, int(bool(warmstart))]
    meta += row_codes(kinds, con_base)
    for base, dim in con_base:
        meta += [base, dim]
    return meta


@functools.lru_cache(maxsize=64)
def _meta_tensor(kinds, con_base, nv, niter, nls, warmstart, device):
    return torch.tensor(kernel_meta(kinds, con_base, nv, niter, nls, warmstart),
                        dtype=torch.int32, device=device)


def solve_batched(kinds: Tuple[str, ...], con_base: Tuple[Tuple[int, int], ...],
                  nv: int, niter: int, nls: int, tol, warmstart: bool,
                  J, aref, D, floss, active, mu, M, a_s, ws):
    """The whole Newton solve of a (B, ...) batch: J (B, nefc, nv); aref, D,
    floss (B, nefc); active (B, nefc) bool; mu (B, ncon, 5); M (B, nv, nv);
    a_s, ws (B, nv); tol a scalar (a 0-d tensor on the batch's device on
    CUDA). Returns (qacc (B, nv), qfrc = J^T f (B, nv), f_rows (B, nefc)).

    CUDA: the K2 kernel (float32, nv <= 16, nefc <= 64), else ValueError.
    CPU: newton_tiles."""
    if J.device.type == "cuda":
        nefc = len(kinds)
        if nv > MAX_NV or not 1 <= nefc <= MAX_ROWS:
            raise ValueError(f"solve_batched: the CUDA kernel takes nv <= {MAX_NV} "
                             f"and 1..{MAX_ROWS} rows, got nv {nv}, {nefc} rows")
        from mujoco_ros_pkgs_tpu_torch import kernels
        meta = _meta_tensor(tuple(kinds), tuple(tuple(c) for c in con_base), nv,
                            niter, nls, bool(warmstart), J.device)
        tol_t = torch.as_tensor(tol, dtype=torch.float32, device=J.device).reshape(1)
        if mu.shape[1] == 0:
            mu = torch.zeros(J.shape[0], 1, 5, dtype=J.dtype, device=J.device)
        return kernels.newton_solve(
            meta, tol_t, J.contiguous(), aref.contiguous(), D.contiguous(),
            floss.contiguous(), active.to(torch.bool).contiguous(), mu.contiguous(),
            M.contiguous(), a_s.contiguous(), ws.contiguous())
    if J.device.type == "cpu":
        return solve_batched_plain(kinds, con_base, nv, niter, nls, tol, warmstart,
                                   J, aref, D, floss, active, mu, M, a_s, ws)
    raise ValueError(f"solve_batched: unsupported device {J.device}")


def solve_batched_plain(kinds, con_base, nv, niter, nls, tol, warmstart,
                        J, aref, D, floss, active, mu, M, a_s, ws):
    """solve_batched's plain version on any device: newton_tiles, then
    qfrc = J^T f."""
    x, f = newton_tiles(nv, tuple(kinds), tuple(con_base), niter, nls, warmstart,
                        tol, J, aref, D, floss, active, mu, M, a_s, ws)
    return x, (J * f[..., None]).sum(-2), f
