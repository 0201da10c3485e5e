// Whole mj_step for world + one free body (K3), one group of G lanes per
// env.
//
// Replaces mujoco_ros_pkgs_tpu/ops/step_tpu.py::_make_step_kernel (the JAX
// package's fused Pallas step): quaternion kinematics, single-body CRB and
// RNE, static-vs-body narrowphase by any of the twelve analytic pair
// primitives (narrowphase.cuh), contact efc rows
// with the solref/solimp impedance, the Newton solve and Euler with implicit
// joint damping. Its plain-torch twin is
// ops/step_tpu.py::step_batched_plain of the torch port.
//
// Unlike the TPU kernel, which the JAX package specializes per model at
// trace time, this is one kernel for every supported model: nv = 6 is fixed,
// at most 64 rows, and the model arrives at run time as an int32 metadata
// vector (pairs, trip counts, flags, param offsets, then the solve's block
// of ops/solver_tpu.py::kernel_meta: row codes and (first row, condim) per
// contact; laid out by ops/step_tpu.py::kernel_meta) plus the packed float32
// params vector (ops/step_tpu.py::_pack_params), both in device memory, so
// runtime edits of gravity or geom parameters need no rebuild.
//
// Design: one group of G = 8 or 16 lanes per env (kernels.group_width picks
// it from the rows and the batch), 128 / G envs per block. Every lane computes
// the smooth part (kinematics, com, CRB, RNE and the 6 x 6 solve of the
// unconstrained acceleration, about 3000 operations) in registers, the same
// in each lane, which costs no barrier; lane c of the group then runs the
// narrowphase of contact slot c and writes its rows into the env's slice of
// shared memory, sized from the model's rows at launch. The rows go to the
// Newton body that K2 runs too (solver.cuh), and Euler's implicit-damping
// solve to its group Cholesky. No per-env array lives in local memory.
//
// Cost: it moves 76 B per env per step (qpos, qvel and warmstart in; qpos,
// qvel and qacc out), so its bound is its operations; it is held back by the
// latency of the sequential Newton trips (group barriers, the Cholesky's
// columns) of the slowest env of each warp.
//
// This header holds the per-thread body (step_env); step_fused.cu holds the
// kernel and its launch.
#pragma once

#include <math.h>

#include "narrowphase.cuh"
#include "solver.cuh"

namespace mrp {

constexpr float MINVAL = solver::kMinVal;
constexpr int NV = 6;

// metadata header, then param offsets, then one record per pair, then the
// solve's block (solver.cuh: M_LEN header, row codes, contacts)
enum { H_NPAIRS, H_NROWS, H_NITER, H_NLS, H_WARMSTART, H_REFSAFE, H_DAMPING,
       H_LEN };
enum { P_DT, P_GRAVITY, P_TOL, P_IMPRATIO, P_MASS, P_INERTIA, P_IPOS, P_IQUAT,
       P_INVW0, P_INVW1, P_DAMPING, P_ARMATURE, P_FRIC5, P_SOLREF, P_SOLIMP,
       P_INCM, P_LEN };
enum { R_PRIM, R_PI, R_G1, R_G1BODY, R_G2, R_G2BODY, R_SIGN, R_DIM,
       PAIR_STRIDE };
// primitive ids: the order of ops/narrowphase_soa.py SOA_FNS (PRIM_ID)
enum { PRIM_PLANE_SPHERE, PRIM_PLANE_CAPSULE, PRIM_PLANE_ELLIPSOID, PRIM_PLANE_CYLINDER,
       PRIM_PLANE_BOX, PRIM_SPHERE_SPHERE, PRIM_SPHERE_CAPSULE, PRIM_SPHERE_CYLINDER,
       PRIM_SPHERE_BOX, PRIM_CAPSULE_CAPSULE, PRIM_CAPSULE_BOX, PRIM_BOX_BOX, PRIM_COUNT };
constexpr int PAIR_BASE = H_LEN + P_LEN;
constexpr float MINIMP = 0.0001f, MAXIMP = 0.9999f;
// each primitive's contacts (ops/narrowphase.py _DISPATCH caps), 3 bits per
// id in id order: 1 2 1 4 4 1 1 1 1 1 2 4
constexpr unsigned long long kPrimCaps =
    1ull | 2ull << 3 | 1ull << 6 | 4ull << 9 | 4ull << 12 | 1ull << 15 | 1ull << 18 |
    1ull << 21 | 1ull << 24 | 1ull << 27 | 2ull << 30 | 4ull << 33;

// contacts a pair's primitive writes (its slots); 1 for an unknown id,
// which the dispatch then traps on
__device__ inline int prim_cap(int prim) {
  return (unsigned)prim < PRIM_COUNT ? (int)((kPrimCaps >> (3 * prim)) & 7ull) : 1;
}

// Cholesky solve H x = g reading the lower triangle of H, by one thread
// (unrolled, with the pivot clamp sqrt(max(s, 1e-30)) of the JAX kernel).
template <int N>
__device__ inline void chol_solve(const float H[N][N], const float* g, float* x) {
  float L[N][N];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    float s = H[i][i];
#pragma unroll
    for (int k = 0; k < i; ++k) s = s - L[i][k] * L[i][k];
    const float Lii = sqrtf(fmaxf(s, 1e-30f));
    L[i][i] = Lii;
    const float inv = 1.0f / Lii;
#pragma unroll
    for (int j = i + 1; j < N; ++j) {
      float t = H[j][i];
#pragma unroll
      for (int k = 0; k < i; ++k) t = t - L[j][k] * L[i][k];
      L[j][i] = t * inv;
    }
  }
  float y[N];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    float s = g[i];
#pragma unroll
    for (int k = 0; k < i; ++k) s = s - L[i][k] * y[k];
    y[i] = s / L[i][i];
  }
#pragma unroll
  for (int i = N - 1; i >= 0; --i) {
    float s = y[i];
#pragma unroll
    for (int k = i + 1; k < N; ++k) s = s - L[k][i] * x[k];
    x[i] = s / L[i][i];
  }
}

__device__ inline void quat_to_mat(const float* q, float R[3][3]) {
  const float w = q[0], x = q[1], y = q[2], z = q[3];
  R[0][0] = 1 - 2 * (y * y + z * z);
  R[0][1] = 2 * (x * y - w * z);
  R[0][2] = 2 * (x * z + w * y);
  R[1][0] = 2 * (x * y + w * z);
  R[1][1] = 1 - 2 * (x * x + z * z);
  R[1][2] = 2 * (y * z - w * x);
  R[2][0] = 2 * (x * z - w * y);
  R[2][1] = 2 * (y * z + w * x);
  R[2][2] = 1 - 2 * (x * x + y * y);
}

__device__ inline void mat_mul3(const float A[3][3], const float B[3][3],
                                float C[3][3]) {
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j)
      C[i][j] = A[i][0] * B[0][j] + A[i][1] * B[1][j] + A[i][2] * B[2][j];
}

__device__ inline void mat_vec3(const float A[3][3], const float* v, float* out) {
  for (int i = 0; i < 3; ++i) out[i] = A[i][0] * v[0] + A[i][1] * v[1] + A[i][2] * v[2];
}

// spatial inertia (Ixx Iyy Izz Ixy Ixz Iyz hx hy hz m) x motion (ang, lin)
__device__ inline void inert_vec_mul(const float* cin, const float* v, float* out) {
  const float* w = v;
  const float* l = v + 3;
  const float Iw[3] = {cin[0] * w[0] + cin[3] * w[1] + cin[4] * w[2],
                       cin[3] * w[0] + cin[1] * w[1] + cin[5] * w[2],
                       cin[4] * w[0] + cin[5] * w[1] + cin[2] * w[2]};
  float hl[3], hw[3];
  cross3(cin + 6, l, hl);
  cross3(cin + 6, w, hw);
  for (int k = 0; k < 3; ++k) {
    out[k] = Iw[k] + hl[k];
    out[3 + k] = l[k] * cin[9] - hw[k];
  }
}

// entry (a, b) of the body inertia in the world frame, iR diag(Ib) iR^T
__device__ inline float inertia_w(const float iR[3][3], const float* Ib, int a, int b) {
  float s = 0.0f;
  for (int k = 0; k < 3; ++k) s = s + iR[a][k] * Ib[k] * iR[b][k];
  return s;
}

__device__ inline float sv_dot(const float* a, const float* b) {
  return dot3(a, b) + dot3(a + 3, b + 3);
}

// x**p for x >= 0 as exp(p log x), the formula of the JAX kernel; 0 at 0
__device__ inline float pow_(float x, float p) {
  return x <= 0.0f ? 0.0f : expf(p * logf(fmaxf(x, 1e-30f)));
}

// stiffness k, damping b and impedance imp of one contact (efc._kbi twin)
__device__ inline void kbi(const float* solref, const float* solimp, float pos,
                           float margin, float timestep, bool refsafe,
                           float* k, float* b, float* imp) {
  const float d0 = solimp[0], dmax = solimp[1], width = solimp[2];
  float x = fabsf(pos - margin) / fmaxf(width, MINVAL);
  x = clampf(x, 0.0f, 1.0f);
  const float mid = clampf(solimp[3], MINIMP, MAXIMP);
  const float power = fmaxf(solimp[4], 1.0f);
  const float a = 1.0f / pow_(mid, power - 1.0f);
  const float bb = 1.0f / pow_(1.0f - mid, power - 1.0f);
  const float y = x < mid ? a * pow_(x, power) : 1.0f - bb * pow_(1.0f - x, power);
  *imp = clampf(d0 + y * (dmax - d0), MINIMP, MAXIMP);
  const float dmax_c = clampf(dmax, MINIMP, MAXIMP);
  float timeconst = solref[0];
  const float dampratio = solref[1];
  if (refsafe) timeconst = fmaxf(timeconst, 2.0f * timestep);
  const float k_std = 1.0f / fmaxf(dmax_c * dmax_c * timeconst * timeconst
                                   * dampratio * dampratio, MINVAL);
  const float b_std = 2.0f / fmaxf(dmax_c * timeconst, MINVAL);
  const bool direct = (solref[0] <= 0.0f) || (solref[1] <= 0.0f);
  *k = direct ? -solref[0] / (dmax_c * dmax_c) : k_std;
  *b = direct ? -solref[1] : b_std;
}

__device__ inline void geom_frame(const float* params, int off, bool on_body,
                                  const float* pos, const float R[3][3],
                                  GeomFrame& g) {
  const float* gp = params + off + 3;
  float gR[3][3];
  quat_to_mat(params + off + 6, gR);
  if (!on_body) {
    for (int i = 0; i < 3; ++i) {
      g.p[i] = gp[i];
      for (int j = 0; j < 3; ++j) g.R[i][j] = gR[i][j];
    }
    return;
  }
  float rp[3];
  mat_vec3(R, gp, rp);
  for (int i = 0; i < 3; ++i) g.p[i] = pos[i] + rp[i];
  mat_mul3(R, gR, g.R);
}


// position and normalized orientation of env's qpos
__device__ inline void load_pose(const float* qpos, int env, float* pos, float* quat) {
  for (int k = 0; k < 3; ++k) pos[k] = qpos[env * 7 + k];
  float q[4], ss = 0.0f;
  for (int k = 0; k < 4; ++k) q[k] = qpos[env * 7 + 3 + k];
  for (int k = 0; k < 4; ++k) ss = ss + q[k] * q[k];
  const float nrm = sqrtf(fmaxf(ss, MINVAL * MINVAL));
  for (int k = 0; k < 4; ++k) quat[k] = q[k] / nrm;
}

// One thread's part of the step of env block * (kThreads / G) + thread / G;
// smem is the block's shared memory, kThreads / G env slices of env_layout.
template <int G>
__device__ inline void step_env(float* smem, int block, int thread,
                                const int* __restrict__ meta,
                                const float* __restrict__ params,
                                const float* __restrict__ qpos_in,
                                const float* __restrict__ qvel_in,
                                const float* __restrict__ ws_in,
                                float* __restrict__ qpos_out,
                                float* __restrict__ qvel_out,
                                float* __restrict__ x_out, int B, int nefc, int ncon) {
  using solver::kThreads;
  const Group<G> g = Group<G>::of(thread);
  const int slot = thread / G;
  const int env = block * (kThreads / G) + slot;
  if (env >= B) return;            // the whole group leaves together
  const int npairs = meta[H_NPAIRS];
  const int* op = meta + H_LEN;
  // the solve's block: its header, one code per row, (first row, condim)
  // per contact
  const int* solve_meta = meta + PAIR_BASE + npairs * PAIR_STRIDE;
  const int* cons = solve_meta + solver::M_LEN + nefc;
  const solver::Env e = solver::make_env(
      smem + slot * solver::env_layout(NV, nefc, ncon).total, NV, nefc, ncon);

  float pos[3], quat[4], qvel[NV];
  load_pose(qpos_in, env, pos, quat);
  for (int k = 0; k < NV; ++k) qvel[k] = qvel_in[env * NV + k];
  const float dt = params[op[P_DT]];
  float R[3][3];
  quat_to_mat(quat, R);

  // ---- com quantities (free body: reference point = com = xipos) ----
  float ipos_w[3];
  mat_vec3(R, params + op[P_IPOS], ipos_w);
  float iRl[3][3], iR[3][3];
  quat_to_mat(params + op[P_IQUAT], iRl);
  mat_mul3(R, iRl, iR);
  const float* Ib = params + op[P_INERTIA];
  const float cin[10] = {inertia_w(iR, Ib, 0, 0), inertia_w(iR, Ib, 1, 1),
                         inertia_w(iR, Ib, 2, 2), inertia_w(iR, Ib, 0, 1),
                         inertia_w(iR, Ib, 0, 2), inertia_w(iR, Ib, 1, 2),
                         0.0f, 0.0f, 0.0f, params[op[P_MASS]]};

  // cdof rows (ang, lin): translations e_v, then body-axis rotations
  float cdof[NV][6];
  for (int v = 0; v < 3; ++v)
    for (int k = 0; k < 6; ++k) cdof[v][k] = (k == 3 + v) ? 1.0f : 0.0f;
  for (int k = 0; k < 3; ++k) {
    float* c = cdof[3 + k];
    for (int i = 0; i < 3; ++i) c[i] = R[i][k];
    cross3(c, ipos_w, c + 3);
  }

  // ---- qM (crb on one body), one row of inertia x cdof at a time ----
  float M[NV][NV];
  const float* arma = params + op[P_ARMATURE];
  for (int i = 0; i < NV; ++i) {
    float Fi[6];
    inert_vec_mul(cin, cdof[i], Fi);
    for (int j = 0; j <= i; ++j) {
      float gij = sv_dot(Fi, cdof[j]);
      if (i == j) gij = gij + arma[i];
      M[i][j] = gij;
      M[j][i] = gij;
    }
  }

  // ---- rne bias ----
  const float* grav = params + op[P_GRAVITY];
  float cvel[6] = {0.0f, 0.0f, 0.0f, qvel[0], qvel[1], qvel[2]};
  float vmid[6];
  for (int k = 0; k < 6; ++k) vmid[k] = cvel[k];
  float cacc[6] = {0.0f, 0.0f, 0.0f, -grav[0], -grav[1], -grav[2]};
  for (int k = 0; k < 3; ++k) {
    const float* c = cdof[3 + k];
    float dot[6], t1[3], t2[3];
    cross3(vmid, c, dot);                  // motion cross: ang
    cross3(vmid, c + 3, t1);               // lin = w x l + l_u x w_v
    cross3(vmid + 3, c, t2);
    for (int i = 0; i < 3; ++i) dot[3 + i] = t1[i] + t2[i];
    for (int i = 0; i < 6; ++i) cacc[i] = cacc[i] + dot[i] * qvel[3 + k];
    for (int i = 0; i < 6; ++i) cvel[i] = cvel[i] + c[i] * qvel[3 + k];
  }
  float cfrc_a[6], Icv[6], cfrc[6];
  inert_vec_mul(cin, cacc, cfrc_a);
  inert_vec_mul(cin, cvel, Icv);
  {
    float a1[3], a2[3], l1[3];           // force cross: cvel x_f Icv
    cross3(cvel, Icv, a1);
    cross3(cvel + 3, Icv + 3, a2);
    cross3(cvel, Icv + 3, l1);
    for (int i = 0; i < 3; ++i) {
      cfrc[i] = cfrc_a[i] + (a1[i] + a2[i]);
      cfrc[3 + i] = cfrc_a[3 + i] + l1[i];
    }
  }
  const float* damping = params + op[P_DAMPING];
  float qfrc_smooth[NV], a_s[NV];
  for (int v = 0; v < NV; ++v)
    qfrc_smooth[v] = -damping[v] * qvel[v] - sv_dot(cdof[v], cfrc);
  chol_solve<NV>(M, qfrc_smooth, a_s);

  // the env's M, a_s, warmstart and row codes; lane v keeps dof v's smooth
  // force for Euler
  float my_qfrc = 0.0f;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
#pragma unroll
    for (int j = 0; j < NV; ++j)
      if ((i * NV + j) % G == g.lane) e.M[i * NV + j] = M[i][j];
    if (i == g.lane) {
      e.a_s[i] = a_s[i];
      e.ws[i] = ws_in[env * NV + i];
      my_qfrc = qfrc_smooth[i];
    }
  }
  solver::load_meta(e, g, solve_meta);

  // ---- narrowphase and efc rows: lane c builds contact slot c ----
  const float impratio = params[op[P_IMPRATIO]];
  const float invw = params[op[P_INVW0]] + params[op[P_INVW1]];
  for (int c = g.lane; c < ncon; c += G) {
    // slot c's pair (pairs in slot order, each with prim_cap slots) and
    // c's index k among the pair's contacts
    int p = 0, first = 0;
    for (; p < npairs - 1; ++p) {
      const int cap = prim_cap(meta[PAIR_BASE + p * PAIR_STRIDE + R_PRIM]);
      if (c < first + cap) break;
      first += cap;
    }
    const int* rec = meta + PAIR_BASE + p * PAIR_STRIDE;
    const int k = c - first;
    GeomFrame g1, g2;
    geom_frame(params, rec[R_G1], rec[R_G1BODY] != 0, pos, R, g1);
    geom_frame(params, rec[R_G2], rec[R_G2BODY] != 0, pos, R, g2);
    const float* s1 = params + rec[R_G1];
    const float* s2 = params + rec[R_G2];
    Contact con;
    switch (rec[R_PRIM]) {
      case PRIM_PLANE_SPHERE: plane_sphere(g1, g2, s1, s2, k, con); break;
      case PRIM_PLANE_CAPSULE: plane_capsule(g1, g2, s1, s2, k, con); break;
      case PRIM_PLANE_ELLIPSOID: plane_ellipsoid(g1, g2, s1, s2, k, con); break;
      case PRIM_PLANE_CYLINDER: plane_cylinder(g1, g2, s1, s2, k, con); break;
      case PRIM_PLANE_BOX: plane_box(g1, g2, s1, s2, k, con); break;
      case PRIM_SPHERE_SPHERE: sphere_sphere(g1, g2, s1, s2, k, con); break;
      case PRIM_SPHERE_CAPSULE: sphere_capsule(g1, g2, s1, s2, k, con); break;
      case PRIM_SPHERE_CYLINDER: sphere_cylinder(g1, g2, s1, s2, k, con); break;
      case PRIM_SPHERE_BOX: sphere_box(g1, g2, s1, s2, k, con); break;
      case PRIM_CAPSULE_CAPSULE: capsule_capsule(g1, g2, s1, s2, k, con); break;
      case PRIM_CAPSULE_BOX: capsule_box(g1, g2, s1, s2, k, con); break;
      case PRIM_BOX_BOX: box_box(g1, g2, s1, s2, k, con); break;
      default: __trap();   // an id kernel_meta never writes: stop the launch
    }
    const float dist = con.dist;
    const int pi = rec[R_PI];
    const int base = cons[2 * c], dim = cons[2 * c + 1];
    const float sgn = (float)rec[R_SIGN];
    const float incm = params[op[P_INCM] + pi];
    const float* solref = params + op[P_SOLREF] + 2 * pi;
    const float* solimp = params + op[P_SOLIMP] + 5 * pi;
    const float* fr5 = params + op[P_FRIC5] + 5 * pi;
    const bool a_act = dist < incm;
    float kk, bb, imp;
    kbi(solref, solimp, dist, incm, dt, meta[H_REFSAFE] != 0, &kk, &bb, &imp);
    float off[3];
    for (int i = 0; i < 3; ++i) off[i] = con.pos[i] - (pos[i] + ipos_w[i]);
    const float Rbase = (1.0f - imp) / imp * invw;
    // rows rr < dim (an index fixed by the unrolling, so the frame stays in
    // registers): translations along frame rows 0-2, rotations about 0-2
#pragma unroll
    for (int rr = 0; rr < 6; ++rr) {
      if (rr < dim) {
        const float* axis = con.frame[rr < 3 ? rr : rr - 3];
        float row[NV];
        if (rr < 3) {
          float offxa[3];
          cross3(off, axis, offxa);
          for (int v = 0; v < 3; ++v) row[v] = sgn * axis[v];
          for (int q = 0; q < 3; ++q)
            row[3 + q] = sgn * (dot3(axis, cdof[3 + q] + 3) + dot3(offxa, cdof[3 + q]));
        } else {
          for (int v = 0; v < 3; ++v) row[v] = 0.0f;
          for (int q = 0; q < 3; ++q) row[3 + q] = sgn * dot3(axis, cdof[3 + q]);
        }
        float jv = 0.0f;
        for (int v = 0; v < NV; ++v) jv = jv + row[v] * qvel[v];
        const int r = base + rr;
        for (int v = 0; v < NV; ++v) e.J[r * NV + v] = row[v];
        if (rr == 0) {
          e.aref[r] = -bb * jv - kk * imp * (dist - incm);
          e.D[r] = 1.0f / fmaxf(Rbase, MINVAL);
        } else {
          float scale = impratio;
          if (rr >= 3) scale = scale * fr5[rr - 1] * fr5[rr - 1];
          e.aref[r] = -bb * jv;
          e.D[r] = 1.0f / fmaxf(Rbase / scale, MINVAL);
        }
        e.act[r] = a_act ? 1.0f : 0.0f;
      }
    }
    for (int q = 0; q < 5; ++q) e.mu[5 * c + q] = fr5[q];
  }
  g.sync();

  // ---- Newton solve ----
  solver::newton_env(e, g, meta[H_NITER], meta[H_NLS], meta[H_WARMSTART] != 0,
                     params[op[P_TOL]]);

  // ---- Euler (implicit in joint damping) ----
  const float* qacc = e.x;
  if (meta[H_DAMPING] != 0) {
    // (M + dt diag(damping)) qacc = qfrc_smooth + J^T f, lane i holding
    // row i
    const int i = g.lane;
    float hrow[NV], rhs = 0.0f;
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      hrow[j] = 0.0f;
      if (i < NV && j <= i) hrow[j] = i == j ? e.M[i * NV + j] + dt * damping[i]
                                             : e.M[i * NV + j];
    }
    if (i < NV) {
      float s = e.J[i] * e.f[0];
      for (int r = 1; r < nefc; ++r) s = s + e.J[r * NV + i] * e.f[r];
      rhs = my_qfrc + s;
    }
    const float a = group_chol_solve_rows(g, hrow, rhs, NV);
    if (i < NV) e.dx[i] = a;
    g.sync();
    qacc = e.dx;
  }
  // pose and velocity are read again here: kept through the solve, they
  // would hold registers the Newton body needs
  load_pose(qpos_in, env, pos, quat);
  float qv[NV];
  for (int v = 0; v < NV; ++v) qv[v] = qvel_in[env * NV + v] + dt * qacc[v];
  float wsq = 0.0f;
  for (int k = 0; k < 3; ++k) wsq = wsq + qv[3 + k] * qv[3 + k];
  const float wn = sqrtf(fmaxf(wsq, MINVAL * MINVAL));
  const float half = 0.5f * (wn * dt);
  const float sh = sinf(half), inv = 1.0f / wn;
  const float dq[4] = {cosf(half), qv[3] * inv * sh, qv[4] * inv * sh,
                       qv[5] * inv * sh};
  const float qn[4] = {
      quat[0] * dq[0] - quat[1] * dq[1] - quat[2] * dq[2] - quat[3] * dq[3],
      quat[0] * dq[1] + quat[1] * dq[0] + quat[2] * dq[3] - quat[3] * dq[2],
      quat[0] * dq[2] - quat[1] * dq[3] + quat[2] * dq[0] + quat[3] * dq[1],
      quat[0] * dq[3] + quat[1] * dq[2] - quat[2] * dq[1] + quat[3] * dq[0]};
#pragma unroll
  for (int k = 0; k < 7; ++k) {
    if (k == g.lane) qpos_out[env * 7 + k] = k < 3 ? pos[k] + dt * qv[k] : qn[k - 3];
  }
#pragma unroll
  for (int v = 0; v < NV; ++v) {
    if (v == g.lane) {
      qvel_out[env * NV + v] = qv[v];
      x_out[env * NV + v] = e.x[v];
    }
  }
}

}  // namespace mrp
