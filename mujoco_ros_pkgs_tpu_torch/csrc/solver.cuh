// The Newton constraint solve of one env on one warp (the body of K2,
// csrc/solver.cu), over rows of every kind.
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
// All per-env state lives in shared memory (EnvLayout); lanes share the
// rows (row forces, J x, J dx, the line search's sums), the contacts (one
// lane per cone), the dofs and the entries of H; warp sums combine them.
// Sums therefore run in another order than the plain version's, and the two
// differ by rounding only.
#pragma once

#include <math.h>

#include "warp.cuh"

namespace mrp {

namespace solver {

constexpr float kMinVal = 1e-15f;
constexpr int kMaxNv = 16;
constexpr int kMaxRows = 64;
// row codes (ops/solver_tpu.py ROW_CODE / row_codes)
enum { kEq = 0, kFri = 1, kLim = 2, kCone = 3 };
// metadata header (ops/solver_tpu.py kernel_meta), then one code per row,
// then (first row, condim) per contact
enum { M_NV, M_NEFC, M_NCON, M_NITER, M_NLS, M_WARMSTART, M_LEN };

// Offsets (in 4-byte words) of one env's arrays in shared memory.
struct EnvLayout {
  int J, JW, M, H, Wr, aref, D, floss, act, jar, f, w, vls, jj, mu;
  int x, a_s, ws, xs, grad, dx, tv, code, base, dim, total;
};

__host__ __device__ inline EnvLayout env_layout(int nv, int nefc, int ncon) {
  EnvLayout L;
  int o = 0;
  L.J = o; o += nefc * nv;
  L.JW = o; o += nefc * nv;
  L.M = o; o += nv * nv;
  L.H = o; o += nv * (nv + 1);
  L.Wr = o; o += nefc * 6;
  L.aref = o; o += nefc;
  L.D = o; o += nefc;
  L.floss = o; o += nefc;
  L.act = o; o += nefc;
  L.jar = o; o += nefc;
  L.f = o; o += nefc;
  L.w = o; o += nefc;
  L.vls = o; o += nefc;
  L.jj = o; o += nefc;
  L.mu = o; o += 5 * (ncon > 0 ? ncon : 1);
  L.x = o; o += nv;
  L.a_s = o; o += nv;
  L.ws = o; o += nv;
  L.xs = o; o += nv;
  L.grad = o; o += nv;
  L.dx = o; o += nv;
  L.tv = o; o += nv;
  L.code = o; o += nefc;
  L.base = o; o += nefc;
  L.dim = o; o += nefc;
  L.total = o;
  return L;
}

// One env's view of its shared-memory block and of the model's metadata.
struct Env {
  int nv, nefc, ncon;
  const int* contacts;       // (first row, condim) per contact
  float *J, *JW, *M, *H, *Wr, *aref, *D, *floss, *act, *jar, *f, *w, *vls, *jj,
      *mu, *x, *a_s, *ws, *xs, *grad, *dx, *tv;
  int *code, *base, *dim;
};

__device__ inline Env make_env(float* blk, const int* meta, int nv, int nefc,
                               int ncon) {
  const EnvLayout L = env_layout(nv, nefc, ncon);
  Env e;
  e.nv = nv;
  e.nefc = nefc;
  e.ncon = ncon;
  e.contacts = meta + M_LEN + nefc;
  e.J = blk + L.J; e.JW = blk + L.JW; e.M = blk + L.M; e.H = blk + L.H;
  e.Wr = blk + L.Wr; e.aref = blk + L.aref; e.D = blk + L.D;
  e.floss = blk + L.floss; e.act = blk + L.act; e.jar = blk + L.jar;
  e.f = blk + L.f; e.w = blk + L.w; e.vls = blk + L.vls; e.jj = blk + L.jj;
  e.mu = blk + L.mu; e.x = blk + L.x; e.a_s = blk + L.a_s; e.ws = blk + L.ws;
  e.xs = blk + L.xs; e.grad = blk + L.grad; e.dx = blk + L.dx; e.tv = blk + L.tv;
  e.code = (int*)(blk + L.code);
  e.base = (int*)(blk + L.base);
  e.dim = (int*)(blk + L.dim);
  return e;
}

// Forces of one elliptic cone (condim 3/4/6) at u (its rows), by one lane:
// f[0..dim), and, if W is given, its dim x dim Hessian block as rows of
// stride 6 (W[k * 6 + l]). Returns the cone's cost.
__device__ inline float cone_forces(int dim, const float* mu, const float* D,
                                    const float* u, bool act, float* f, float* W) {
  const int nt = dim - 1;
  float sig[5], P_t[5], ph[5], dirs[5], ft[5];
  for (int k = 0; k < nt; ++k) sig[k] = fmaxf(mu[k < 2 ? 0 : k], kMinVal);
  const float Dn = D[0];
  const float P_n = -Dn * u[0];
  for (int k = 0; k < nt; ++k) {
    P_t[k] = -D[1 + k] * u[1 + k];
    ph[k] = P_t[k] / sig[k];
  }
  float sumsq = 0.0f, sumDh = 0.0f;
  for (int k = 0; k < nt; ++k) sumsq = sumsq + ph[k] * ph[k];
  for (int k = 0; k < nt; ++k) sumDh = sumDh + D[1 + k] / (sig[k] * sig[k]);
  const float T = sqrtf(fmaxf(sumsq, kMinVal * kMinVal));
  const bool inside = T <= P_n;
  const float Dbar = sumDh / (float)nt;
  const float fn_mid = (P_n / Dn + T / Dbar) / (1.0f / Dn + 1.0f / Dbar);
  const bool polar = fn_mid <= 0.0f;
  float f_n = inside ? P_n : (polar ? 0.0f : fn_mid);
  for (int k = 0; k < nt; ++k) {
    dirs[k] = ph[k] / T;
    ft[k] = sig[k] * (inside ? ph[k] : (polar ? 0.0f : fn_mid * dirs[k]));
  }
  if (!act) {
    f_n = 0.0f;
    for (int k = 0; k < nt; ++k) ft[k] = 0.0f;
  }
  f[0] = f_n;
  for (int k = 0; k < nt; ++k) f[1 + k] = ft[k];
  // cost: 0.5 u^T D u - 0.5 (P - f)^T R (P - f), R = 1/D
  float q1 = 0.0f, q2 = 0.0f;
  for (int k = 0; k < dim; ++k) q1 = q1 + D[k] * u[k] * u[k];
  {
    const float r0 = P_n - f_n;
    q2 = q2 + r0 * r0 / D[0];
    for (int k = 0; k < nt; ++k) {
      const float r = P_t[k] - ft[k];
      q2 = q2 + r * r / D[1 + k];
    }
  }
  if (W != nullptr) {
    const float A = Dn * Dbar / (Dn + Dbar);
    const float btt = fn_mid * Dbar / T;
    for (int i = 0; i < dim; ++i) {
      for (int j = 0; j <= i; ++j) {
        float v;
        if (i == 0) {
          v = A;
        } else if (j == 0) {
          v = A * sig[i - 1] * dirs[i - 1];
        } else {
          const int k = i - 1, l = j - 1;
          float wt = (A - btt) * (dirs[k] * dirs[l]);
          if (k == l) wt = wt + btt;
          v = sig[k] * sig[l] * wt;
        }
        if (inside) v = (i == j) ? D[i] : 0.0f;
        if (polar || !act) v = 0.0f;
        W[i * 6 + j] = v;
        W[j * 6 + i] = v;
      }
    }
  }
  return act ? (0.5f * q1 - 0.5f * q2) : 0.0f;
}

// Forces of every row at u (the row residuals J x - aref at some x) into
// e.f; with want_w also the diagonal weights e.w (0 on cone rows) and the
// cone rows' Hessian block rows e.Wr. Returns this lane's share of the cost
// (warp_sum of it is the total).
__device__ inline float row_forces(const Env& e, const float* u, bool want_w,
                                   int lane) {
  float cost = 0.0f;
  for (int r = lane; r < e.nefc; r += kLanes) {
    const int code = e.code[r];
    if (code == kCone) {
      if (want_w) e.w[r] = 0.0f;
      continue;
    }
    const float D = e.D[r], jar = u[r];
    const bool act = e.act[r] > 0.5f;
    float fr, wr, cr;
    if (code == kEq) {
      fr = act ? -D * jar : 0.0f;
      wr = act ? D : 0.0f;
      cr = act ? 0.5f * D * jar * jar : 0.0f;
    } else if (code == kFri) {
      const float fl = e.floss[r];
      const float f_unc = -D * jar;
      const bool lin = fabsf(f_unc) > fl;
      fr = act ? fminf(fmaxf(f_unc, -fl), fl) : 0.0f;
      wr = (act && !lin) ? D : 0.0f;
      cr = act ? (lin ? fl * fabsf(jar) - 0.5f * fl * fl / fmaxf(D, kMinVal)
                      : 0.5f * D * jar * jar)
               : 0.0f;
    } else {                       // one-sided: limits, condim-1 contacts
      const bool gate = act && (jar < 0.0f);
      fr = gate ? -D * jar : 0.0f;
      wr = gate ? D : 0.0f;
      cr = gate ? 0.5f * D * jar * jar : 0.0f;
    }
    e.f[r] = fr;
    if (want_w) e.w[r] = wr;
    cost += cr;
  }
  for (int c = lane; c < e.ncon; c += kLanes) {
    const int b = e.contacts[2 * c], dim = e.contacts[2 * c + 1];
    if (dim == 1) continue;        // solved as a one-sided row above
    cost += cone_forces(dim, e.mu + 5 * c, e.D + b, u + b, e.act[b] > 0.5f,
                        e.f + b, want_w ? e.Wr + 6 * b : nullptr);
  }
  __syncwarp();
  return cost;
}

// out = M v, lanes over dofs.
__device__ inline void mmul(const Env& e, const float* v, float* out, int lane) {
  for (int i = lane; i < e.nv; i += kLanes) {
    float s = e.M[i * e.nv] * v[0];
    for (int j = 1; j < e.nv; ++j) s = s + e.M[i * e.nv + j] * v[j];
    out[i] = s;
  }
  __syncwarp();
}

// out = J v - aref, lanes over rows.
__device__ inline void residual(const Env& e, const float* v, float* out, int lane) {
  for (int r = lane; r < e.nefc; r += kLanes) {
    float s = -e.aref[r];
    for (int k = 0; k < e.nv; ++k) s = s + e.J[r * e.nv + k] * v[k];
    out[r] = s;
  }
  __syncwarp();
}

// The solve's objective at xp: 0.5 (xp - a_s)^T M (xp - a_s) + row costs.
// Uses e.xs, e.tv, e.jj and e.f as scratch.
__device__ inline float cost_at(const Env& e, const float* xp, int lane) {
  for (int v = lane; v < e.nv; v += kLanes) e.xs[v] = xp[v] - e.a_s[v];
  __syncwarp();
  mmul(e, e.xs, e.tv, lane);
  float q = 0.0f;
  for (int v = lane; v < e.nv; v += kLanes) q += e.tv[v] * e.xs[v];
  residual(e, xp, e.jj, lane);
  const float c = row_forces(e, e.jj, false, lane);
  return 0.5f * warp_sum(q) + warp_sum(c);
}

// phi'(alpha) along v_ls from e.jar, and phi''(alpha) into *d2 if given.
// Uses e.jj, e.f, e.w and e.Wr as scratch.
__device__ inline float dphi(const Env& e, float alpha, float gMd, float dMd,
                             float* d2, int lane) {
  for (int r = lane; r < e.nefc; r += kLanes) e.jj[r] = e.jar[r] + alpha * e.vls[r];
  __syncwarp();
  row_forces(e, e.jj, d2 != nullptr, lane);
  float p1 = 0.0f, p2 = 0.0f;
  for (int r = lane; r < e.nefc; r += kLanes) {
    const float vr = e.vls[r];
    p1 += e.f[r] * vr;
    if (d2 != nullptr) {
      float s = e.w[r] * vr;
      if (e.code[r] == kCone) {
        const int b = e.base[r];
        for (int l = 0; l < e.dim[r]; ++l) s += e.Wr[6 * r + l] * e.vls[b + l];
      }
      p2 += s * vr;
    }
  }
  const float d1 = gMd + alpha * dMd - warp_sum(p1);
  if (d2 != nullptr) *d2 = dMd + warp_sum(p2);
  return d1;
}

// The whole solve of one env whose inputs are loaded into e; leaves the
// solution in e.x and the row forces at it in e.f.
__device__ inline void newton_env(const Env& e, int niter, int nls,
                                  bool warmstart, float tol, int lane) {
  const float grid[7] = {0.0625f, 0.25f, 0.5f, 1.0f, 2.0f, 4.0f, 16.0f};
  const int nv = e.nv, nefc = e.nefc;
  bool use_ws = false;
  if (warmstart) use_ws = cost_at(e, e.ws, lane) < cost_at(e, e.a_s, lane);
  for (int v = lane; v < nv; v += kLanes) e.x[v] = use_ws ? e.ws[v] : e.a_s[v];
  __syncwarp();
  mmul(e, e.a_s, e.tv, lane);
  float sc = 0.0f;
  for (int v = lane; v < nv; v += kLanes) sc += fabsf(e.tv[v]);
  const float scale = fmaxf(warp_sum(sc), kMinVal);

  for (int it = 0; it < niter; ++it) {
    residual(e, e.x, e.jar, lane);
    row_forces(e, e.jar, true, lane);
    for (int v = lane; v < nv; v += kLanes) e.xs[v] = e.x[v] - e.a_s[v];
    __syncwarp();
    mmul(e, e.xs, e.tv, lane);
    for (int v = lane; v < nv; v += kLanes) {
      float s = e.tv[v];
      for (int r = 0; r < nefc; ++r) s = s - e.J[r * nv + v] * e.f[r];
      e.grad[v] = s;
      e.dx[v] = -s;
    }
    // JW = W J row by row (diagonal weight, plus the cone block's row)
    for (int idx = lane; idx < nefc * nv; idx += kLanes) {
      const int r = idx / nv, j = idx - r * nv;
      float s = e.w[r] * e.J[idx];
      if (e.code[r] == kCone) {
        const int b = e.base[r];
        for (int l = 0; l < e.dim[r]; ++l) s += e.Wr[6 * r + l] * e.J[(b + l) * nv + j];
      }
      e.JW[idx] = s;
    }
    __syncwarp();
    // H = M + J^T JW (+1e-12 on the diagonal), lower triangle
    for (int idx = lane; idx < nv * nv; idx += kLanes) {
      const int i = idx / nv, j = idx - i * nv;
      if (j > i) continue;
      float s = e.M[idx];
      for (int r = 0; r < nefc; ++r) s = s + e.J[r * nv + i] * e.JW[r * nv + j];
      if (i == j) s = s + 1e-12f;
      e.H[i * (nv + 1) + j] = s;
    }
    __syncwarp();
    warp_chol_solve(e.H, nv + 1, nv, e.dx, lane);

    for (int r = lane; r < nefc; r += kLanes) {
      float s = e.J[r * nv] * e.dx[0];
      for (int v = 1; v < nv; ++v) s = s + e.J[r * nv + v] * e.dx[v];
      e.vls[r] = s;
    }
    __syncwarp();
    mmul(e, e.dx, e.tv, lane);
    float pg = 0.0f, pd = 0.0f, pgd = 0.0f, pgg = 0.0f;
    for (int v = lane; v < nv; v += kLanes) {
      pg += e.tv[v] * e.xs[v];
      pd += e.tv[v] * e.dx[v];
      pgd += e.grad[v] * e.dx[v];
      pgg += e.grad[v] * e.grad[v];
    }
    const float gMd = warp_sum(pg), dMd = warp_sum(pd);
    const float d1_0 = warp_sum(pgd), gradsq = warp_sum(pgg);

    // bracket phi'(alpha) over the static grid
    float lo = 0.0f, hi = grid[6];
    bool found_hi = false;
    for (int g = 0; g < 7; ++g) {
      const bool neg = dphi(e, grid[g], gMd, dMd, nullptr, lane) < 0.0f;
      if (neg) lo = grid[g];
      if (!neg && !found_hi) hi = grid[g];
      found_hi = found_hi || !neg;
    }
    hi = fmaxf(hi, lo);
    float alpha = 0.5f * (lo + hi);
    for (int k = 0; k < nls; ++k) {
      float d2;
      const float d1 = dphi(e, alpha, gMd, dMd, &d2, lane);
      if (d1 < 0.0f) lo = alpha; else hi = alpha;
      const float newton = alpha - d1 / fmaxf(d2, kMinVal);
      alpha = (newton > lo && newton < hi) ? newton : 0.5f * (lo + hi);
    }

    const float improved_est = -0.5f * alpha * d1_0;
    for (int v = lane; v < nv; v += kLanes) e.x[v] = e.x[v] + alpha * e.dx[v];
    __syncwarp();
    // the step that converges is still applied; x then stays frozen, so
    // leaving the loop here gives the fixed-trip result of the TPU kernel
    if (improved_est < tol * scale || gradsq < tol * tol) break;
  }
  residual(e, e.x, e.jar, lane);
  row_forces(e, e.jar, false, lane);
}

}  // namespace solver
}  // namespace mrp
