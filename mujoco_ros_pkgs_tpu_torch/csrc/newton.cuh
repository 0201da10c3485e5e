// Newton constraint solve as per-thread device functions (one env per thread).
//
// Replaces the body of the JAX package's fused Newton kernel,
// mujoco_ros_pkgs_tpu/ops/solver_tpu.py: `_row_forces` (elliptic cones of
// condim 1/3/4/6 and their Hessian blocks), `_chol_solve` (unrolled
// Cholesky) and `newton_tiles` (warmstart by cost, Newton steps with
// H = M + J^T W J, the 7-point alpha grid and Newton/bisection polish,
// convergence masking). The step kernel (step_fused.cu) calls newton_solve.
// Its plain-torch twin is ops/solver_tpu.py of the torch port.
//
// Every row is a contact row: the fused step builds no equality, limit or
// friction-loss rows. Sums run in the order of the JAX kernel, so the two
// differ by rounding only.
#pragma once

#include <math.h>

namespace mrp {

constexpr float MINVAL = 1e-15f;
constexpr int NV = 6;
constexpr int MAX_ROWS = 64;

struct ContactRef {
  int base;          // first efc row
  int dim;           // condim: 1, 3, 4 or 6
  const float* mu;   // friction 5-vector [mu_t1, mu_t2, mu_tor, mu_roll1, mu_roll2]
};

struct EfcRows {
  int nrows;
  int ncon;
  float J[MAX_ROWS][NV];
  float aref[MAX_ROWS];
  float D[MAX_ROWS];
  bool act[MAX_ROWS];
  ContactRef con[MAX_ROWS];
};

// Forces of one contact at jar (its rows). Writes f[0..dim); for dim 1 the
// diagonal weight to *w1; for a cone, if W is given, the dim x dim Hessian
// block (row-major, full). Returns the contact's cost.
__device__ inline float contact_forces(const ContactRef& c, const float* D,
                                       const float* jar, bool act, float* f,
                                       float* w1, float* W) {
  const int dim = c.dim;
  if (dim == 1) {
    const bool gate = act && (jar[0] < 0.0f);
    f[0] = gate ? -D[0] * jar[0] : 0.0f;
    *w1 = gate ? D[0] : 0.0f;
    return gate ? 0.5f * D[0] * jar[0] * jar[0] : 0.0f;
  }
  const int nt = dim - 1;
  float sig[5], P_t[5], ph[5], dirs[5], ft[5];
  for (int k = 0; k < nt; ++k) sig[k] = fmaxf(c.mu[k < 2 ? 0 : k], MINVAL);
  const float Dn = D[0];
  const float P_n = -Dn * jar[0];
  float sumsq = 0.0f, sumDh = 0.0f;
  for (int k = 0; k < nt; ++k) {
    P_t[k] = -D[1 + k] * jar[1 + k];
    ph[k] = P_t[k] / sig[k];
  }
  for (int k = 0; k < nt; ++k) sumsq = sumsq + ph[k] * ph[k];
  for (int k = 0; k < nt; ++k) sumDh = sumDh + D[1 + k] / (sig[k] * sig[k]);
  const float T = sqrtf(fmaxf(sumsq, MINVAL * MINVAL));
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
  for (int k = 0; k < dim; ++k) q1 = q1 + D[k] * jar[k] * jar[k];
  {
    const float r0 = P_n - f_n;
    q2 = q2 + r0 * r0 / D[0];
    for (int k = 0; k < nt; ++k) {
      const float r = P_t[k] - ft[k];
      q2 = q2 + r * r / D[1 + k];
    }
  }
  const float cost = act ? (0.5f * q1 - 0.5f * q2) : 0.0f;
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
          const float dd = dirs[k] * dirs[l];
          float wt = (A - btt) * dd;
          if (k == l) wt = wt + btt;
          v = sig[k] * sig[l] * wt;
        }
        if (inside) v = (i == j) ? D[i] : 0.0f;
        if (polar || !act) v = 0.0f;
        W[i * dim + j] = v;
        W[j * dim + i] = v;
      }
    }
  }
  return cost;
}

// Cholesky solve H x = g reading the lower triangle of H (unrolled, with the
// pivot clamp sqrt(max(s, 1e-30)) of the JAX kernel).
template <int N>
__device__ inline void chol_solve(const float H[N][N], const float* g, float* x) {
  float L[N][N];
  for (int i = 0; i < N; ++i) {
    float s = H[i][i];
    for (int k = 0; k < i; ++k) s = s - L[i][k] * L[i][k];
    const float Lii = sqrtf(fmaxf(s, 1e-30f));
    L[i][i] = Lii;
    const float inv = 1.0f / Lii;
    for (int j = i + 1; j < N; ++j) {
      float t = H[j][i];
      for (int k = 0; k < i; ++k) t = t - L[j][k] * L[i][k];
      L[j][i] = t * inv;
    }
  }
  float y[N];
  for (int i = 0; i < N; ++i) {
    float s = g[i];
    for (int k = 0; k < i; ++k) s = s - L[i][k] * y[k];
    y[i] = s / L[i][i];
  }
  for (int i = N - 1; i >= 0; --i) {
    float s = y[i];
    for (int k = i + 1; k < N; ++k) s = s - L[k][i] * x[k];
    x[i] = s / L[i][i];
  }
}

__device__ inline void mmul(const float M[NV][NV], const float* v, float* out) {
  for (int i = 0; i < NV; ++i) {
    float s = M[i][0] * v[0];
    for (int j = 1; j < NV; ++j) s = s + M[i][j] * v[j];
    out[i] = s;
  }
}

__device__ inline void jar_at(const EfcRows& e, const float* x, float* jar) {
  for (int r = 0; r < e.nrows; ++r) {
    float s = -e.aref[r];
    for (int v = 0; v < NV; ++v) s = s + e.J[r][v] * x[v];
    jar[r] = s;
  }
}

// Forces, diagonal weights and total cost of all rows at jar.
__device__ inline float all_forces(const EfcRows& e, const float* jar, float* f,
                                   float* w) {
  float cost = 0.0f;
  for (int r = 0; r < e.nrows; ++r) w[r] = 0.0f;
  for (int c = 0; c < e.ncon; ++c) {
    const ContactRef& cr = e.con[c];
    cost = cost + contact_forces(cr, &e.D[cr.base], &jar[cr.base],
                                 e.act[cr.base], &f[cr.base], &w[cr.base],
                                 nullptr);
  }
  return cost;
}

__device__ inline float cost_at(const EfcRows& e, const float M[NV][NV],
                                const float* a_s, const float* x) {
  float dx[NV], Mdx[NV], jar[MAX_ROWS], f[MAX_ROWS], w[MAX_ROWS];
  for (int v = 0; v < NV; ++v) dx[v] = x[v] - a_s[v];
  mmul(M, dx, Mdx);
  float quad = 0.0f;
  for (int v = 0; v < NV; ++v) quad = quad + Mdx[v] * dx[v];
  jar_at(e, x, jar);
  return 0.5f * quad + all_forces(e, jar, f, w);
}

// phi'(alpha) and, if d2 is given, phi''(alpha) along the search direction.
__device__ inline float dphi(const EfcRows& e, const float* jar,
                             const float* v_ls, float gMd, float dMd,
                             float alpha, float* d2) {
  float jj[MAX_ROWS], fa[MAX_ROWS], wa[MAX_ROWS];
  for (int r = 0; r < e.nrows; ++r) jj[r] = jar[r] + alpha * v_ls[r];
  all_forces(e, jj, fa, wa);
  float d1 = gMd + alpha * dMd;
  for (int r = 0; r < e.nrows; ++r) d1 = d1 - fa[r] * v_ls[r];
  if (d2 != nullptr) {
    float s = dMd;
    for (int r = 0; r < e.nrows; ++r) s = s + wa[r] * v_ls[r] * v_ls[r];
    float W[36], tmp[6], w1;
    for (int c = 0; c < e.ncon; ++c) {
      const ContactRef& cr = e.con[c];
      if (cr.dim == 1) continue;
      contact_forces(cr, &e.D[cr.base], &jj[cr.base], e.act[cr.base], tmp, &w1, W);
      for (int k = 0; k < cr.dim; ++k)
        for (int l = 0; l < cr.dim; ++l)
          s = s + v_ls[cr.base + k] * W[k * cr.dim + l] * v_ls[cr.base + l];
    }
    *d2 = s;
  }
  return d1;
}

// The whole Newton solve of one env. Returns the solution in x and the row
// forces at it in f.
__device__ inline void newton_solve(const EfcRows& e, const float M[NV][NV],
                                    const float* a_s, const float* ws,
                                    int niter, int nls, bool warmstart,
                                    float tol, float* x, float* f) {
  const float grid[7] = {0.0625f, 0.25f, 0.5f, 1.0f, 2.0f, 4.0f, 16.0f};
  for (int v = 0; v < NV; ++v) x[v] = a_s[v];
  if (warmstart && cost_at(e, M, a_s, ws) < cost_at(e, M, a_s, a_s)) {
    for (int v = 0; v < NV; ++v) x[v] = ws[v];
  }
  float scale;
  {
    float Ma[NV];
    mmul(M, a_s, Ma);
    scale = 0.0f;
    for (int v = 0; v < NV; ++v) scale = scale + fabsf(Ma[v]);
    scale = fmaxf(scale, MINVAL);
  }

  float jar[MAX_ROWS], w[MAX_ROWS], v_ls[MAX_ROWS];
  for (int it = 0; it < niter; ++it) {
    jar_at(e, x, jar);
    all_forces(e, jar, f, w);
    float xs[NV], Mxs[NV], grad[NV];
    for (int v = 0; v < NV; ++v) xs[v] = x[v] - a_s[v];
    mmul(M, xs, Mxs);
    for (int v = 0; v < NV; ++v) {
      float s = Mxs[v];
      for (int r = 0; r < e.nrows; ++r) s = s - e.J[r][v] * f[r];
      grad[v] = s;
    }
    // H = M + J^T diag(w) J (+1e-12 on the diagonal), then the cone blocks
    float H[NV][NV];
    for (int i = 0; i < NV; ++i) {
      for (int j = 0; j <= i; ++j) {
        float s = M[i][j];
        for (int r = 0; r < e.nrows; ++r) s = s + e.J[r][i] * w[r] * e.J[r][j];
        if (i == j) s = s + 1e-12f;
        H[i][j] = s;
      }
    }
    {
      float W[36], tmp[6], w1, JW[6][NV];
      for (int c = 0; c < e.ncon; ++c) {
        const ContactRef& cr = e.con[c];
        if (cr.dim == 1) continue;
        contact_forces(cr, &e.D[cr.base], &jar[cr.base], e.act[cr.base], tmp,
                       &w1, W);
        for (int k = 0; k < cr.dim; ++k) {
          for (int i = 0; i < NV; ++i) {
            float s = W[k * cr.dim] * e.J[cr.base][i];
            for (int l = 1; l < cr.dim; ++l)
              s = s + W[k * cr.dim + l] * e.J[cr.base + l][i];
            JW[k][i] = s;
          }
        }
        for (int i = 0; i < NV; ++i) {
          for (int j = 0; j <= i; ++j) {
            float s = H[i][j];
            for (int k = 0; k < cr.dim; ++k) s = s + e.J[cr.base + k][i] * JW[k][j];
            H[i][j] = s;
          }
        }
      }
    }
    float mg[NV], dx[NV];
    for (int v = 0; v < NV; ++v) mg[v] = -grad[v];
    chol_solve<NV>(H, mg, dx);

    for (int r = 0; r < e.nrows; ++r) {
      float s = e.J[r][0] * dx[0];
      for (int v = 1; v < NV; ++v) s = s + e.J[r][v] * dx[v];
      v_ls[r] = s;
    }
    float Mdx[NV];
    mmul(M, dx, Mdx);
    float gMd = 0.0f, dMd = 0.0f;
    for (int v = 0; v < NV; ++v) gMd = gMd + Mdx[v] * xs[v];
    for (int v = 0; v < NV; ++v) dMd = dMd + Mdx[v] * dx[v];

    // bracket phi'(alpha) over the static grid
    float lo = 0.0f, hi = grid[6];
    bool found_hi = false;
    for (int g = 0; g < 7; ++g) {
      const bool neg = dphi(e, jar, v_ls, gMd, dMd, grid[g], nullptr) < 0.0f;
      if (neg) lo = grid[g];
      if (!neg && !found_hi) hi = grid[g];
      found_hi = found_hi || !neg;
    }
    hi = fmaxf(hi, lo);
    float alpha = 0.5f * (lo + hi);
    for (int k = 0; k < nls; ++k) {
      float d2;
      const float d1 = dphi(e, jar, v_ls, gMd, dMd, alpha, &d2);
      const bool n1 = d1 < 0.0f;
      if (n1) lo = alpha; else hi = alpha;
      const float newton = alpha - d1 / fmaxf(d2, MINVAL);
      alpha = (newton > lo && newton < hi) ? newton : 0.5f * (lo + hi);
    }

    float d1_0 = 0.0f, gradsq = 0.0f;
    for (int v = 0; v < NV; ++v) d1_0 = d1_0 + grad[v] * dx[v];
    for (int v = 0; v < NV; ++v) gradsq = gradsq + grad[v] * grad[v];
    const float improved_est = -0.5f * alpha * d1_0;
    for (int v = 0; v < NV; ++v) x[v] = x[v] + alpha * dx[v];
    // the step that converges is still applied; x then stays frozen, so
    // leaving the loop here gives the JAX kernel's fixed-trip result
    if (improved_est < tol * scale || gradsq < tol * tol) break;
  }
  jar_at(e, x, jar);
  all_forces(e, jar, f, w);
}

}  // namespace mrp
