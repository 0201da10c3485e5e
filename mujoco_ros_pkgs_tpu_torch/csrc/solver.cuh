// The Newton constraint solve of one env on a group of G lanes of one warp
// (G = 8 or 16): the one body that K2 (csrc/solver.cu, rows from device
// memory) and K3 (csrc/step_fused.cuh, rows built in the step) both run.
//
// Follows mujoco_ros_pkgs_tpu/ops/solver_tpu.py::newton_tiles and
// `_row_forces` step by step: the warmstart picked by cost, up to niter
// Newton trips with H = M + J^T W J (+1e-12 on the diagonal; W diagonal for
// 'eq' / 'fri' / one-sided rows and a dim x dim block per elliptic cone of
// condim 3/4/6), the 7-point alpha grid that brackets phi', nls Newton or
// bisection polish steps, and the per-env stop once
// improved_est < tol * scale or |grad|^2 < tol^2 (the converging step is
// still applied). Its plain-torch twin is ops/solver_tpu.py of the port.
//
// Layout: each env's arrays live in its own slice of shared memory
// (env_layout), sized from the model's nv, rows and contacts at launch.
// Work is split by ownership, the same in every pass: lane r % G owns
// diagonal row r, lane c % G owns contact c (all rows of its cone), and
// lane i owns dof i (nv <= G: the launches check it). Lane i also holds row
// i of H in registers for the Cholesky solve, whose pivots and columns go
// by shuffles (warp.cuh group_chol_solve_rows). A lane reads back only the
// row values it wrote itself
// (the residual J x - aref and the search direction J dx), so the whole line
// search runs in registers without a barrier: each owner evaluates its rows
// at all 7 grid alphas in one pass and the group reduces the 7 sums in one
// butterfly; each polish step reduces (phi', phi'') in one butterfly. Cone
// Hessian blocks are built in registers (the cone kernels are instantiated
// for condim 3, 4 and 6) and go straight into W J. A Newton trip has four
// barriers: after the row pass, after H = M + J^T W J, after the solve's
// dx and after the x update. Sums run in another order than the plain
// version's, and the two differ by rounding only.
#pragma once

#include <math.h>

#include "warp.cuh"

namespace mrp {

namespace solver {

constexpr float kMinVal = 1e-15f;
constexpr int kMaxNv = 16;
constexpr int kMaxRows = 64;
constexpr int kThreads = 128;   // threads per block of K2 and K3
constexpr int kMinBlocks = 4;   // blocks per SM the launch bounds ask for: at
                                // most 128 registers a thread
// row codes (ops/solver_tpu.py ROW_CODE / row_codes)
enum { kEq = 0, kFri = 1, kLim = 2, kCone = 3 };
// metadata header (ops/solver_tpu.py kernel_meta), then one code per row,
// then (first row, condim) per contact
enum { M_NV, M_NEFC, M_NCON, M_NITER, M_NLS, M_WARMSTART, M_LEN };

// Offsets (in 4-byte words) of one env's arrays in shared memory; the
// launches size their shared memory from `total`.
struct EnvLayout {
  int J, JW, M, H, aref, D, floss, act, jar, f, vls, mu, x, a_s, ws, dx, code, con,
      total;
};

__host__ __device__ inline EnvLayout env_layout(int nv, int nefc, int ncon) {
  const int nc = ncon > 0 ? ncon : 1;
  EnvLayout L;
  int o = 0;
  L.J = o; o += nefc * nv;
  L.JW = o; o += nefc * nv;
  L.M = o; o += nv * nv;
  L.H = o; o += nv * (nv + 1);
  L.aref = o; o += nefc;
  L.D = o; o += nefc;
  L.floss = o; o += nefc;
  L.act = o; o += nefc;
  L.jar = o; o += nefc;
  L.f = o; o += nefc;
  L.vls = o; o += nefc;
  L.mu = o; o += 5 * nc;
  L.x = o; o += nv;
  L.a_s = o; o += nv;
  L.ws = o; o += nv;
  L.dx = o; o += nv;
  L.code = o; o += nefc;
  L.con = o; o += 2 * nc;
  L.total = o;
  return L;
}

// One env's view of its shared-memory block.
struct Env {
  int nv, nefc, ncon;
  float *J, *JW, *M, *H, *aref, *D, *floss, *act, *jar, *f, *vls, *mu, *x, *a_s,
      *ws, *dx;
  int *code, *con;   // row codes; (first row, condim) per contact
};

__device__ inline Env make_env(float* blk, int nv, int nefc, int ncon) {
  const EnvLayout L = env_layout(nv, nefc, ncon);
  Env e;
  e.nv = nv;
  e.nefc = nefc;
  e.ncon = ncon;
  e.J = blk + L.J; e.JW = blk + L.JW; e.M = blk + L.M; e.H = blk + L.H;
  e.aref = blk + L.aref; e.D = blk + L.D; e.floss = blk + L.floss;
  e.act = blk + L.act; e.jar = blk + L.jar; e.f = blk + L.f; e.vls = blk + L.vls;
  e.mu = blk + L.mu; e.x = blk + L.x; e.a_s = blk + L.a_s; e.ws = blk + L.ws;
  e.dx = blk + L.dx;
  e.code = (int*)(blk + L.code);
  e.con = (int*)(blk + L.con);
  return e;
}

// Row codes and contacts from the solve's metadata block into the env.
template <int G>
__device__ inline void load_meta(const Env& e, const Group<G>& g, const int* meta) {
  for (int r = g.lane; r < e.nefc; r += G) e.code[r] = meta[M_LEN + r];
  for (int i = g.lane; i < 2 * e.ncon; i += G) e.con[i] = meta[M_LEN + e.nefc + i];
}

// ---------------------------------------------------------------------------
// row kernels
// ---------------------------------------------------------------------------

struct RowForce {
  float f, w, cost;
};

// Force, diagonal weight and cost of one 'eq', 'fri' or one-sided row at its
// residual u (fl: the row's friction loss, read for 'fri' rows only).
__device__ __forceinline__ RowForce row_force(int code, float D, float fl, bool act,
                                              float u) {
  RowForce o;
  if (code == kEq) {
    o.f = act ? -D * u : 0.0f;
    o.w = act ? D : 0.0f;
    o.cost = act ? 0.5f * D * u * u : 0.0f;
  } else if (code == kFri) {
    const float f_unc = -D * u;
    const bool lin = fabsf(f_unc) > fl;
    o.f = act ? fminf(fmaxf(f_unc, -fl), fl) : 0.0f;
    o.w = (act && !lin) ? D : 0.0f;
    o.cost = act ? (lin ? fl * fabsf(u) - 0.5f * fl * fl / fmaxf(D, kMinVal)
                        : 0.5f * D * u * u)
                 : 0.0f;
  } else {                         // one-sided: limits, condim-1 contacts
    const bool gate = act && (u < 0.0f);
    o.f = gate ? -D * u : 0.0f;
    o.w = gate ? D : 0.0f;
    o.cost = gate ? 0.5f * D * u * u : 0.0f;
  }
  return o;
}

// Forces f of one elliptic cone of condim DIM at u (its rows' residuals),
// with mu its contact's 5 friction values and D its rows' D; if kW, also its
// DIM x DIM Hessian block W. Returns the cone's cost. Every index is static,
// so u, f and W stay in registers.
template <int DIM, bool kW>
__device__ __forceinline__ float cone_forces(const float* mu, const float* D,
                                             const float (&u)[DIM], bool act,
                                             float (&f)[DIM], float (&W)[DIM][DIM]) {
  constexpr int NT = DIM - 1;
  float sig[NT], P_t[NT], ph[NT], dirs[NT];
#pragma unroll
  for (int k = 0; k < NT; ++k) sig[k] = fmaxf(mu[k < 2 ? 0 : k], kMinVal);
  const float Dn = D[0];
  const float P_n = -Dn * u[0];
#pragma unroll
  for (int k = 0; k < NT; ++k) {
    P_t[k] = -D[1 + k] * u[1 + k];
    ph[k] = P_t[k] / sig[k];
  }
  float sumsq = 0.0f, sumDh = 0.0f;
#pragma unroll
  for (int k = 0; k < NT; ++k) sumsq = sumsq + ph[k] * ph[k];
#pragma unroll
  for (int k = 0; k < NT; ++k) sumDh = sumDh + D[1 + k] / (sig[k] * sig[k]);
  const float T = sqrtf(fmaxf(sumsq, kMinVal * kMinVal));
  const bool inside = T <= P_n;
  const float Dbar = sumDh / (float)NT;
  const float fn_mid = (P_n / Dn + T / Dbar) / (1.0f / Dn + 1.0f / Dbar);
  const bool polar = fn_mid <= 0.0f;
  f[0] = act ? (inside ? P_n : (polar ? 0.0f : fn_mid)) : 0.0f;
#pragma unroll
  for (int k = 0; k < NT; ++k) {
    dirs[k] = ph[k] / T;
    const float ft = sig[k] * (inside ? ph[k] : (polar ? 0.0f : fn_mid * dirs[k]));
    f[1 + k] = act ? ft : 0.0f;
  }
  if (kW) {
    const float A = Dn * Dbar / (Dn + Dbar);
    const float btt = fn_mid * Dbar / T;
#pragma unroll
    for (int i = 0; i < DIM; ++i) {
#pragma unroll
      for (int j = 0; j <= i; ++j) {
        float v;
        if (i == 0) {
          v = A;
        } else if (j == 0) {
          v = A * sig[i - 1] * dirs[i - 1];
        } else {
          float wt = (A - btt) * (dirs[i - 1] * dirs[j - 1]);
          if (i == j) wt = wt + btt;
          v = sig[i - 1] * sig[j - 1] * wt;
        }
        if (inside) v = (i == j) ? D[i] : 0.0f;
        if (polar || !act) v = 0.0f;
        W[i][j] = v;
        W[j][i] = v;
      }
    }
  }
  // cost: 0.5 u^T D u - 0.5 (P - f)^T R (P - f), R = 1/D
  float q1 = 0.0f;
#pragma unroll
  for (int k = 0; k < DIM; ++k) q1 = q1 + D[k] * u[k] * u[k];
  const float r0 = P_n - f[0];
  float q2 = r0 * r0 / D[0];
#pragma unroll
  for (int k = 0; k < NT; ++k) {
    const float r = P_t[k] - f[1 + k];
    q2 = q2 + r * r / D[1 + k];
  }
  return act ? (0.5f * q1 - 0.5f * q2) : 0.0f;
}

template <int N>
struct Dim {
  static constexpr int value = N;
};

// Runs row(r, code) for each diagonal row and cone(c, first row, Dim<dim>)
// for each elliptic cone this lane owns. No barrier inside.
template <int G, class RowFn, class ConeFn>
__device__ __forceinline__ void own_rows(const Env& e, const Group<G>& g, RowFn&& row,
                                         ConeFn&& cone) {
  for (int r = g.lane; r < e.nefc; r += G) {
    const int code = e.code[r];
    if (code != kCone) row(r, code);
  }
  for (int c = g.lane; c < e.ncon; c += G) {
    const int b = e.con[2 * c];
    switch (e.con[2 * c + 1]) {
      case 3: cone(c, b, Dim<3>{}); break;
      case 4: cone(c, b, Dim<4>{}); break;
      case 6: cone(c, b, Dim<6>{}); break;
      default: break;              // condim 1: its row is one-sided, above
    }
  }
}

// J[r] . v - aref[r]
__device__ __forceinline__ float resid(const Env& e, int r, const float* v) {
  const float* Jr = e.J + r * e.nv;
  float s = -e.aref[r];
  for (int k = 0; k < e.nv; ++k) s = s + Jr[k] * v[k];
  return s;
}

// J[r] . v
__device__ __forceinline__ float jdot(const Env& e, int r, const float* v) {
  const float* Jr = e.J + r * e.nv;
  float s = Jr[0] * v[0];
  for (int k = 1; k < e.nv; ++k) s = s + Jr[k] * v[k];
  return s;
}

// (M v)_i
__device__ __forceinline__ float mrow(const Env& e, int i, const float* v) {
  const float* Mi = e.M + i * e.nv;
  float s = Mi[0] * v[0];
  for (int j = 1; j < e.nv; ++j) s = s + Mi[j] * v[j];
  return s;
}

// (M (x - a_s))_i
__device__ __forceinline__ float mrow_rel(const Env& e, int i, const float* x) {
  const float* Mi = e.M + i * e.nv;
  float s = Mi[0] * (x[0] - e.a_s[0]);
  for (int j = 1; j < e.nv; ++j) s = s + Mi[j] * (x[j] - e.a_s[j]);
  return s;
}

// Forces of every row at x into e.f (the final pass, and K3's Euler input).
template <int G>
__device__ inline void forces_at(const Env& e, const Group<G>& g, const float* x) {
  own_rows(e, g,
           [&](int r, int code) {
             const float fl = code == kFri ? e.floss[r] : 0.0f;
             e.f[r] = row_force(code, e.D[r], fl, e.act[r] > 0.5f, resid(e, r, x)).f;
           },
           [&](int c, int b, auto dim) {
             constexpr int DIM = decltype(dim)::value;
             float u[DIM], f[DIM], W[DIM][DIM];
#pragma unroll
             for (int k = 0; k < DIM; ++k) u[k] = resid(e, b + k, x);
             cone_forces<DIM, false>(e.mu + 5 * c, e.D + b, u, e.act[b] > 0.5f, f, W);
#pragma unroll
             for (int k = 0; k < DIM; ++k) e.f[b + k] = f[k];
           });
}

// ---------------------------------------------------------------------------
// the solve
// ---------------------------------------------------------------------------

// The whole solve of one env (nv <= G) whose inputs (J, aref, D, floss,
// act, mu, M, a_s, ws, codes, contacts) are loaded into e and visible to the
// group; leaves the solution in e.x and the row forces at it in e.f,
// visible to the group.
template <int G>
__device__ inline void newton_env(const Env& e, const Group<G>& g, int niter, int nls,
                                  bool warmstart, float tol) {
  const float grid[7] = {0.0625f, 0.25f, 0.5f, 1.0f, 2.0f, 4.0f, 16.0f};
  const int nv = e.nv;
  const int i = g.lane;              // the dof this lane owns
  const bool dof = i < nv;

  // warmstart by cost, and the convergence scale sum |M a_s|:
  // s[0] = (ws - a_s)^T M (ws - a_s), s[1] / s[2] = row costs at ws / a_s
  float s[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  if (dof) {
    s[3] = fabsf(mrow(e, i, e.a_s));
    if (warmstart) s[0] = mrow_rel(e, i, e.ws) * (e.ws[i] - e.a_s[i]);
  }
  if (warmstart) {
    own_rows(e, g,
             [&](int r, int code) {
               const float D = e.D[r], fl = code == kFri ? e.floss[r] : 0.0f;
               const bool act = e.act[r] > 0.5f;
               s[1] += row_force(code, D, fl, act, resid(e, r, e.ws)).cost;
               s[2] += row_force(code, D, fl, act, resid(e, r, e.a_s)).cost;
             },
             [&](int c, int b, auto dim) {
               constexpr int DIM = decltype(dim)::value;
               float u[DIM], f[DIM], W[DIM][DIM];
               const bool act = e.act[b] > 0.5f;
#pragma unroll
               for (int k = 0; k < DIM; ++k) u[k] = resid(e, b + k, e.ws);
               s[1] += cone_forces<DIM, false>(e.mu + 5 * c, e.D + b, u, act, f, W);
#pragma unroll
               for (int k = 0; k < DIM; ++k) u[k] = resid(e, b + k, e.a_s);
               s[2] += cone_forces<DIM, false>(e.mu + 5 * c, e.D + b, u, act, f, W);
             });
  }
  g.sum(s);
  const bool use_ws = warmstart && (0.5f * s[0] + s[1] < s[2]);
  const float scale = fmaxf(s[3], kMinVal);
  if (dof) e.x[i] = use_ws ? e.ws[i] : e.a_s[i];
  g.sync();

  for (int it = 0; it < niter; ++it) {
    // rows at x: residual (kept by its owner for the line search), force,
    // and W J row by row (diagonal weight, or the cone's block)
    own_rows(e, g,
             [&](int r, int code) {
               const float u = resid(e, r, e.x);
               const float fl = code == kFri ? e.floss[r] : 0.0f;
               const RowForce rf = row_force(code, e.D[r], fl, e.act[r] > 0.5f, u);
               e.jar[r] = u;
               e.f[r] = rf.f;
               const float* Jr = e.J + r * nv;
               float* JWr = e.JW + r * nv;
               for (int j = 0; j < nv; ++j) JWr[j] = rf.w * Jr[j];
             },
             [&](int c, int b, auto dim) {
               constexpr int DIM = decltype(dim)::value;
               float u[DIM], f[DIM], W[DIM][DIM];
#pragma unroll
               for (int k = 0; k < DIM; ++k) {
                 u[k] = resid(e, b + k, e.x);
                 e.jar[b + k] = u[k];
               }
               cone_forces<DIM, true>(e.mu + 5 * c, e.D + b, u, e.act[b] > 0.5f, f, W);
#pragma unroll
               for (int k = 0; k < DIM; ++k) e.f[b + k] = f[k];
               for (int j = 0; j < nv; ++j) {
                 float Jc[DIM];
#pragma unroll
                 for (int l = 0; l < DIM; ++l) Jc[l] = e.J[(b + l) * nv + j];
#pragma unroll
                 for (int k = 0; k < DIM; ++k) {
                   float w = W[k][0] * Jc[0];
#pragma unroll
                   for (int l = 1; l < DIM; ++l) w = w + W[k][l] * Jc[l];
                   e.JW[(b + k) * nv + j] = w;
                 }
               }
             });
    g.sync();

    // gradient M (x - a_s) - J^T f (kept by the dof's owner), and
    // H = M + J^T W J (+1e-12 on the diagonal), lower triangle, its entries
    // spread over the lanes
    float grad = 0.0f;
    if (dof) {
      grad = mrow_rel(e, i, e.x);
      for (int r = 0; r < e.nefc; ++r) grad = grad - e.J[r * nv + i] * e.f[r];
    }
    const int ntri = nv * (nv + 1) / 2;
    for (int t = g.lane; t < ntri; t += G) {
      int a = (int)((sqrtf(8.0f * (float)t + 1.0f) - 1.0f) * 0.5f);
      while (a * (a + 1) / 2 > t) --a;
      while ((a + 1) * (a + 2) / 2 <= t) ++a;
      const int b = t - a * (a + 1) / 2;
      float h = e.M[a * nv + b];
      for (int r = 0; r < e.nefc; ++r) h = h + e.J[r * nv + a] * e.JW[r * nv + b];
      if (a == b) h = h + 1e-12f;
      e.H[a * (nv + 1) + b] = h;
    }
    g.sync();
    // dx = -H^-1 grad, lane i holding row i of H
    float hrow[kMaxNv];
#pragma unroll
    for (int j = 0; j < kMaxNv; ++j) hrow[j] = (dof && j <= i) ? e.H[i * (nv + 1) + j] : 0.0f;
    const float dxi = group_chol_solve_rows(g, hrow, -grad, nv);
    if (dof) e.dx[i] = dxi;
    g.sync();

    // the search direction on the rows (J dx, kept by the row's owner), and
    // gMd = (M dx) . (x - a_s), dMd = (M dx) . dx, grad . dx, grad . grad
    own_rows(e, g, [&](int r, int) { e.vls[r] = jdot(e, r, e.dx); },
             [&](int, int b, auto dim) {
               constexpr int DIM = decltype(dim)::value;
#pragma unroll
               for (int k = 0; k < DIM; ++k) e.vls[b + k] = jdot(e, b + k, e.dx);
             });
    float p[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    if (dof) {
      const float md = mrow(e, i, e.dx);
      p[0] = md * (e.x[i] - e.a_s[i]);
      p[1] = md * dxi;
      p[2] = grad * dxi;
      p[3] = grad * grad;
    }
    g.sum(p);
    const float gMd = p[0], dMd = p[1], d1_0 = p[2], gradsq = p[3];

    // bracket phi'(alpha) over the static grid: one pass, 7 sums of f . v
    float d1[7] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
    own_rows(e, g,
             [&](int r, int code) {
               const float u0 = e.jar[r], v = e.vls[r], D = e.D[r];
               const float fl = code == kFri ? e.floss[r] : 0.0f;
               const bool act = e.act[r] > 0.5f;
#pragma unroll
               for (int a = 0; a < 7; ++a)
                 d1[a] += row_force(code, D, fl, act, u0 + grid[a] * v).f * v;
             },
             [&](int c, int b, auto dim) {
               constexpr int DIM = decltype(dim)::value;
               float u0[DIM], v[DIM], u[DIM], f[DIM], W[DIM][DIM];
               const bool act = e.act[b] > 0.5f;
#pragma unroll
               for (int k = 0; k < DIM; ++k) {
                 u0[k] = e.jar[b + k];
                 v[k] = e.vls[b + k];
               }
#pragma unroll
               for (int a = 0; a < 7; ++a) {
#pragma unroll
                 for (int k = 0; k < DIM; ++k) u[k] = u0[k] + grid[a] * v[k];
                 cone_forces<DIM, false>(e.mu + 5 * c, e.D + b, u, act, f, W);
#pragma unroll
                 for (int k = 0; k < DIM; ++k) d1[a] += f[k] * v[k];
               }
             });
    g.sum(d1);
    float lo = 0.0f, hi = grid[6];
    bool found_hi = false;
#pragma unroll
    for (int a = 0; a < 7; ++a) {
      const bool neg = gMd + grid[a] * dMd - d1[a] < 0.0f;
      if (neg) lo = grid[a];
      if (!neg && !found_hi) hi = grid[a];
      found_hi = found_hi || !neg;
    }
    hi = fmaxf(hi, lo);

    // polish: phi' and phi'' at alpha in one pass and one butterfly each
    float alpha = 0.5f * (lo + hi);
    for (int k = 0; k < nls; ++k) {
      float q[2] = {0.0f, 0.0f};
      own_rows(e, g,
               [&](int r, int code) {
                 const float v = e.vls[r];
                 const float fl = code == kFri ? e.floss[r] : 0.0f;
                 const RowForce rf = row_force(code, e.D[r], fl, e.act[r] > 0.5f,
                                               e.jar[r] + alpha * v);
                 q[0] += rf.f * v;
                 q[1] += rf.w * v * v;
               },
               [&](int c, int b, auto dim) {
                 constexpr int DIM = decltype(dim)::value;
                 float v[DIM], u[DIM], f[DIM], W[DIM][DIM];
#pragma unroll
                 for (int l = 0; l < DIM; ++l) {
                   v[l] = e.vls[b + l];
                   u[l] = e.jar[b + l] + alpha * v[l];
                 }
                 cone_forces<DIM, true>(e.mu + 5 * c, e.D + b, u, e.act[b] > 0.5f, f, W);
#pragma unroll
                 for (int l = 0; l < DIM; ++l) {
                   float wv = W[l][0] * v[0];
#pragma unroll
                   for (int m = 1; m < DIM; ++m) wv = wv + W[l][m] * v[m];
                   q[0] += f[l] * v[l];
                   q[1] += wv * v[l];
                 }
               });
      g.sum(q);
      const float d1a = gMd + alpha * dMd - q[0];
      const float d2a = dMd + q[1];
      if (d1a < 0.0f) lo = alpha; else hi = alpha;
      const float newton = alpha - d1a / fmaxf(d2a, kMinVal);
      alpha = (newton > lo && newton < hi) ? newton : 0.5f * (lo + hi);
    }

    const float improved_est = -0.5f * alpha * d1_0;
    if (dof) e.x[i] = e.x[i] + alpha * dxi;
    g.sync();
    // the step that converges is still applied; x then stays frozen, so
    // leaving the loop here gives the fixed-trip result of the TPU kernel
    if (improved_est < tol * scale || gradsq < tol * tol) break;
  }
  forces_at(e, g, e.x);
  g.sync();
}

// ---------------------------------------------------------------------------
// K2's body: one thread of a block of kThreads, G lanes per env
// ---------------------------------------------------------------------------

// Inputs as newton_solve_launch (csrc/solver.cu) takes them; smem is the
// block's shared memory, kThreads / G env slices of env_layout.
template <int G>
__device__ inline void solve_env(float* smem, int block, int thread, const int* meta,
                                 const float* tol_p, const float* J, const float* aref,
                                 const float* D, const float* floss,
                                 const unsigned char* act, const float* mu,
                                 const float* M, const float* a_s, const float* ws,
                                 float* x_out, float* qfrc_out, float* f_out, int B,
                                 int nv, int nefc, int ncon) {
  const Group<G> g = Group<G>::of(thread);
  const int slot = thread / G;
  const int env = block * (kThreads / G) + slot;
  if (env >= B) return;            // the whole group leaves together
  const Env e = make_env(smem + slot * env_layout(nv, nefc, ncon).total, nv, nefc, ncon);
  const size_t er = (size_t)env * nefc, ev = (size_t)env * nv;
  const int nmu = 5 * (ncon > 0 ? ncon : 1);
  for (int i = g.lane; i < nefc * nv; i += G) e.J[i] = J[er * nv + i];
  for (int i = g.lane; i < nv * nv; i += G) e.M[i] = M[ev * nv + i];
  for (int r = g.lane; r < nefc; r += G) {
    e.aref[r] = aref[er + r];
    e.D[r] = D[er + r];
    e.floss[r] = floss[er + r];
    e.act[r] = act[er + r] ? 1.0f : 0.0f;
  }
  for (int i = g.lane; i < nmu; i += G) e.mu[i] = mu[(size_t)env * nmu + i];
  for (int i = g.lane; i < nv; i += G) {
    e.a_s[i] = a_s[ev + i];
    e.ws[i] = ws[ev + i];
  }
  load_meta(e, g, meta);
  g.sync();

  newton_env(e, g, meta[M_NITER], meta[M_NLS], meta[M_WARMSTART] != 0, tol_p[0]);

  for (int r = g.lane; r < nefc; r += G) f_out[er + r] = e.f[r];
  for (int i = g.lane; i < nv; i += G) {
    x_out[ev + i] = e.x[i];
    float s = e.J[i] * e.f[0];
    for (int r = 1; r < nefc; ++r) s = s + e.J[r * nv + i] * e.f[r];
    qfrc_out[ev + i] = s;
  }
}

}  // namespace solver
}  // namespace mrp
