// Whole mj_step for world + one free body, one CUDA thread per env.
//
// Replaces mujoco_ros_pkgs_tpu/ops/step_tpu.py::_make_step_kernel (the JAX
// package's fused Pallas step): quaternion kinematics, single-body CRB and
// RNE, static-vs-body plane narrowphase (narrowphase.cuh), contact efc rows
// with the solref/solimp impedance, the Newton solve (newton.cuh) and Euler
// with implicit joint damping. Its plain-torch twin is
// ops/step_tpu.py::step_batched_plain of the torch port.
//
// Unlike the TPU kernel, which the JAX package specializes per model at
// trace time, this is one kernel for every supported model: nv = 6 is fixed,
// rows are bounded by MAX_ROWS, and the model arrives at run time as an int32
// metadata vector (pairs, trip counts, flags, param offsets; laid out by
// ops/step_tpu.py::kernel_meta) plus the packed float32 params vector
// (ops/step_tpu.py::_pack_params), both in device memory, so runtime edits
// of gravity or geom parameters need no rebuild.
//
// Cost: it moves 76 B per env per step (qpos, qvel and warmstart in; qpos,
// qvel and qacc out), so it is bound by per-thread arithmetic and registers,
// not by bytes. Per-env state (the efc rows, up to 64 x 6 Jacobian entries)
// lives in registers and local memory. One thread per env is the first
// design; making it fast is later work.

#include <cuda_runtime.h>
#include <math.h>

#include "narrowphase.cuh"
#include "newton.cuh"

namespace mrp {

// metadata header, then param offsets, then one record per pair
enum { H_NPAIRS, H_NROWS, H_NITER, H_NLS, H_WARMSTART, H_REFSAFE, H_DAMPING,
       H_LEN };
enum { P_DT, P_GRAVITY, P_TOL, P_IMPRATIO, P_MASS, P_INERTIA, P_IPOS, P_IQUAT,
       P_INVW0, P_INVW1, P_DAMPING, P_ARMATURE, P_FRIC5, P_SOLREF, P_SOLIMP,
       P_INCM, P_LEN };
enum { R_PRIM, R_PI, R_G1, R_G1BODY, R_G2, R_G2BODY, R_SIGN, R_DIM,
       PAIR_STRIDE };
enum { PRIM_PLANE_SPHERE, PRIM_PLANE_CAPSULE, PRIM_PLANE_BOX };
constexpr int PAIR_BASE = H_LEN + P_LEN;
constexpr float MINIMP = 0.0001f, MAXIMP = 0.9999f;

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

__device__ inline float sv_dot(const float* a, const float* b) {
  return dot3(a, b) + dot3(a + 3, b + 3);
}

// x**p for x >= 0 as exp(p log x), the formula of the JAX kernel; 0 at 0
__device__ inline float pow_(float x, float p) {
  return x <= 0.0f ? 0.0f : expf(p * logf(fmaxf(x, 1e-30f)));
}

__device__ inline float clampf(float x, float lo, float hi) {
  return fminf(fmaxf(x, lo), hi);
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

__global__ void step_fused_kernel(const int* __restrict__ meta,
                                  const float* __restrict__ params,
                                  const float* __restrict__ qpos_in,
                                  const float* __restrict__ qvel_in,
                                  const float* __restrict__ ws_in,
                                  float* __restrict__ qpos_out,
                                  float* __restrict__ qvel_out,
                                  float* __restrict__ x_out, int B) {
  const int env = blockIdx.x * blockDim.x + threadIdx.x;
  if (env >= B) return;
  const int npairs = meta[H_NPAIRS], nrows = meta[H_NROWS];
  const int niter = meta[H_NITER], nls = meta[H_NLS];
  const bool warmstart = meta[H_WARMSTART] != 0, refsafe = meta[H_REFSAFE] != 0;
  const bool has_damping = meta[H_DAMPING] != 0;
  const int* op = meta + H_LEN;
  if (nrows < 1 || nrows > MAX_ROWS) {   // the wrapper's plan never sends this
    for (int k = 0; k < 7; ++k) qpos_out[env * 7 + k] = NAN;
    for (int k = 0; k < NV; ++k) qvel_out[env * NV + k] = x_out[env * NV + k] = NAN;
    return;
  }

  float pos[3], quat[4], qvel[NV], ws[NV];
  for (int k = 0; k < 3; ++k) pos[k] = qpos_in[env * 7 + k];
  {
    float q[4], ss = 0.0f;
    for (int k = 0; k < 4; ++k) q[k] = qpos_in[env * 7 + 3 + k];
    for (int k = 0; k < 4; ++k) ss = ss + q[k] * q[k];
    const float nrm = sqrtf(fmaxf(ss, MINVAL * MINVAL));
    for (int k = 0; k < 4; ++k) quat[k] = q[k] / nrm;
  }
  for (int k = 0; k < NV; ++k) {
    qvel[k] = qvel_in[env * NV + k];
    ws[k] = ws_in[env * NV + k];
  }
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
  auto Iw = [&](int a, int b) {
    float s = 0.0f;
    for (int k = 0; k < 3; ++k) s = s + iR[a][k] * Ib[k] * iR[b][k];
    return s;
  };
  const float cin[10] = {Iw(0, 0), Iw(1, 1), Iw(2, 2), Iw(0, 1), Iw(0, 2),
                         Iw(1, 2), 0.0f, 0.0f, 0.0f, params[op[P_MASS]]};

  // cdof rows (ang, lin): translations e_v, then body-axis rotations
  float cdof[NV][6];
  for (int v = 0; v < 3; ++v)
    for (int k = 0; k < 6; ++k) cdof[v][k] = (k == 3 + v) ? 1.0f : 0.0f;
  for (int k = 0; k < 3; ++k) {
    float* c = cdof[3 + k];
    for (int i = 0; i < 3; ++i) c[i] = R[i][k];
    cross3(c, ipos_w, c + 3);
  }

  // ---- qM (crb on one body) ----
  float Fi[NV][6], M[NV][NV];
  for (int i = 0; i < NV; ++i) inert_vec_mul(cin, cdof[i], Fi[i]);
  const float* arma = params + op[P_ARMATURE];
  for (int i = 0; i < NV; ++i) {
    for (int j = 0; j <= i; ++j) {
      float g = sv_dot(Fi[i], cdof[j]);
      if (i == j) g = g + arma[i];
      M[i][j] = g;
      M[j][i] = g;
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

  // ---- narrowphase and efc rows, pairs in slot order ----
  EfcRows efc;
  efc.nrows = 0;
  efc.ncon = 0;
  const float impratio = params[op[P_IMPRATIO]];
  const float invw = params[op[P_INVW0]] + params[op[P_INVW1]];
  for (int p = 0; p < npairs; ++p) {
    const int* rec = meta + PAIR_BASE + p * PAIR_STRIDE;
    GeomFrame g1, g2;
    geom_frame(params, rec[R_G1], rec[R_G1BODY] != 0, pos, R, g1);
    geom_frame(params, rec[R_G2], rec[R_G2BODY] != 0, pos, R, g2);
    const float* s2 = params + rec[R_G2];
    Contacts con;
    switch (rec[R_PRIM]) {
      case PRIM_PLANE_SPHERE: plane_sphere(g1, g2, s2, con); break;
      case PRIM_PLANE_CAPSULE: plane_capsule(g1, g2, s2, con); break;
      default: plane_box(g1, g2, s2, con); break;
    }
    const int pi = rec[R_PI], dim = rec[R_DIM];
    const float sgn = (float)rec[R_SIGN];
    const float incm = params[op[P_INCM] + pi];
    const float* solref = params + op[P_SOLREF] + 2 * pi;
    const float* solimp = params + op[P_SOLIMP] + 5 * pi;
    const float* fr5 = params + op[P_FRIC5] + 5 * pi;
    for (int k = 0; k < con.n; ++k) {
      const float dist = con.dist[k];
      const bool a_act = dist < incm;
      float kk, bb, imp;
      kbi(solref, solimp, dist, incm, dt, refsafe, &kk, &bb, &imp);
      float off[3];
      for (int i = 0; i < 3; ++i) off[i] = con.pos[k][i] - (pos[i] + ipos_w[i]);
      const int base = efc.nrows;
      for (int rr = 0; rr < dim; ++rr) {
        float* row = efc.J[base + rr];
        if (rr < 3) {                      // translational row along frame rr
          const float* axis = con.frame[rr];
          float offxa[3];
          cross3(off, axis, offxa);
          for (int v = 0; v < 3; ++v) row[v] = sgn * axis[v];
          for (int q = 0; q < 3; ++q)
            row[3 + q] = sgn * (dot3(axis, cdof[3 + q] + 3) + dot3(offxa, cdof[3 + q]));
        } else {                           // rotational row about frame rr - 3
          const float* axis = con.frame[rr - 3];
          for (int v = 0; v < 3; ++v) row[v] = 0.0f;
          for (int q = 0; q < 3; ++q) row[3 + q] = sgn * dot3(axis, cdof[3 + q]);
        }
        float jv = 0.0f;
        for (int v = 0; v < NV; ++v) jv = jv + row[v] * qvel[v];
        const float Rbase = (1.0f - imp) / imp * invw;
        if (rr == 0) {
          efc.aref[base] = -bb * jv - kk * imp * (dist - incm);
          efc.D[base] = 1.0f / fmaxf(Rbase, MINVAL);
        } else {
          float scale = impratio;
          if (rr >= 3) scale = scale * fr5[rr - 1] * fr5[rr - 1];
          efc.aref[base + rr] = -bb * jv;
          efc.D[base + rr] = 1.0f / fmaxf(Rbase / scale, MINVAL);
        }
        efc.act[base + rr] = a_act;
      }
      efc.con[efc.ncon].base = base;
      efc.con[efc.ncon].dim = dim;
      efc.con[efc.ncon].mu = fr5;
      efc.ncon += 1;
      efc.nrows += dim;
    }
  }

  // ---- Newton solve ----
  float x[NV], f[MAX_ROWS];
  newton_solve(efc, M, a_s, ws, niter, nls, warmstart, params[op[P_TOL]], x, f);

  // ---- Euler (implicit in joint damping) ----
  float qacc[NV];
  for (int v = 0; v < NV; ++v) qacc[v] = x[v];
  if (has_damping) {
    float rhs[NV], MhB[NV][NV];
    for (int v = 0; v < NV; ++v) {
      float s = efc.J[0][v] * f[0];
      for (int r = 1; r < efc.nrows; ++r) s = s + efc.J[r][v] * f[r];
      rhs[v] = qfrc_smooth[v] + s;
    }
    for (int i = 0; i < NV; ++i)
      for (int j = 0; j < NV; ++j) MhB[i][j] = M[i][j];
    for (int v = 0; v < NV; ++v) MhB[v][v] = MhB[v][v] + dt * damping[v];
    chol_solve<NV>(MhB, rhs, qacc);
  }
  float qv[NV];
  for (int v = 0; v < NV; ++v) qv[v] = qvel[v] + dt * qacc[v];
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
  for (int k = 0; k < 3; ++k) qpos_out[env * 7 + k] = pos[k] + dt * qv[k];
  for (int k = 0; k < 4; ++k) qpos_out[env * 7 + 3 + k] = qn[k];
  for (int v = 0; v < NV; ++v) {
    qvel_out[env * NV + v] = qv[v];
    x_out[env * NV + v] = x[v];
  }
}

}  // namespace mrp

// Plain C entry point (bound with ctypes): launches on `stream` and returns
// cudaGetLastError() as an int (0 = launched).
extern "C" int step_fused_launch(const void* meta, const void* params,
                                 const void* qpos, const void* qvel,
                                 const void* ws, void* qpos_out, void* qvel_out,
                                 void* x_out, int B, void* stream) {
  if (B <= 0) return (int)cudaErrorInvalidValue;
  const int threads = 32;
  const int blocks = (B + threads - 1) / threads;
  mrp::step_fused_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const int*)meta, (const float*)params, (const float*)qpos,
      (const float*)qvel, (const float*)ws, (float*)qpos_out,
      (float*)qvel_out, (float*)x_out, B);
  return (int)cudaGetLastError();
}
