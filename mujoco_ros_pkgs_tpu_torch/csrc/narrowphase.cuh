// Plane narrowphase primitives as per-thread device functions.
//
// Replace `_plane_sphere`, `_plane_capsule` and `_plane_box` of the JAX
// package's mujoco_ros_pkgs_tpu/ops/narrowphase_soa.py, which its fused step
// kernel embeds. Same guards, contact order and tie breaking; their
// plain-torch twins are ops/narrowphase_soa.py of the torch port.
#pragma once

#include <math.h>

namespace mrp {

struct GeomFrame {
  float p[3];        // world position
  float R[3][3];     // world orientation, R[i][j] row i column j
};

struct Contacts {
  int n;             // contacts written (the pair's capacity)
  float dist[4];
  float pos[4][3];
  float frame[3][3]; // rows (normal, t1, t2), shared by every contact
};

__device__ inline float dot3(const float* a, const float* b) {
  return a[0] * b[0] + a[1] * b[1] + a[2] * b[2];
}

__device__ inline void cross3(const float* a, const float* b, float* out) {
  out[0] = a[1] * b[2] - a[2] * b[1];
  out[1] = a[2] * b[0] - a[0] * b[2];
  out[2] = a[0] * b[1] - a[1] * b[0];
}

__device__ inline void normalize3(const float* a, float* out) {
  const float inv = 1.0f / sqrtf(fmaxf(dot3(a, a), 1e-15f * 1e-15f));
  out[0] = a[0] * inv;
  out[1] = a[1] * inv;
  out[2] = a[2] * inv;
}

// mju_makeFrame: rows (n, t1, t2); helper axis = the coordinate axis with the
// smallest |n| component, first on ties.
__device__ inline void make_frame(const float* n_in, float F[3][3]) {
  float n[3];
  normalize3(n_in, n);
  const float ax = fabsf(n[0]), ay = fabsf(n[1]), az = fabsf(n[2]);
  const bool is0 = (ax <= ay) && (ax <= az);
  const bool is1 = !is0 && (ay <= az);
  const float a[3] = {is0 ? 1.0f : 0.0f, is1 ? 1.0f : 0.0f,
                      (!is0 && !is1) ? 1.0f : 0.0f};
  float c[3], t1[3], t2[3];
  cross3(n, a, c);
  normalize3(c, t1);
  cross3(n, t1, t2);
  for (int k = 0; k < 3; ++k) {
    F[0][k] = n[k];
    F[1][k] = t1[k];
    F[2][k] = t2[k];
  }
}

// plane normal = column 2 of the plane's frame
__device__ inline void plane_normal(const GeomFrame& g, float* n) {
  n[0] = g.R[0][2];
  n[1] = g.R[1][2];
  n[2] = g.R[2][2];
}

__device__ inline void plane_sphere(const GeomFrame& g1, const GeomFrame& g2,
                                    const float* s2, Contacts& out) {
  float n[3], d[3];
  plane_normal(g1, n);
  for (int k = 0; k < 3; ++k) d[k] = g2.p[k] - g1.p[k];
  const float r = s2[0];
  const float dist = dot3(n, d) - r;
  out.n = 1;
  out.dist[0] = dist;
  for (int k = 0; k < 3; ++k) out.pos[0][k] = g2.p[k] - n[k] * (r + 0.5f * dist);
  make_frame(n, out.frame);
}

__device__ inline void plane_capsule(const GeomFrame& g1, const GeomFrame& g2,
                                     const float* s2, Contacts& out) {
  float n[3];
  plane_normal(g1, n);
  const float axis[3] = {g2.R[0][2], g2.R[1][2], g2.R[2][2]};
  const float r = s2[0], hl = s2[1];
  make_frame(n, out.frame);
  out.n = 2;
  for (int i = 0; i < 2; ++i) {
    const float sgn = i == 0 ? 1.0f : -1.0f;
    float e[3], d[3];
    for (int k = 0; k < 3; ++k) e[k] = g2.p[k] + axis[k] * (sgn * hl);
    for (int k = 0; k < 3; ++k) d[k] = e[k] - g1.p[k];
    const float dist = dot3(n, d) - r;
    out.dist[i] = dist;
    for (int k = 0; k < 3; ++k) out.pos[i][k] = e[k] - n[k] * (r + 0.5f * dist);
  }
}

__device__ inline void plane_box(const GeomFrame& g1, const GeomFrame& g2,
                                 const float* s2, Contacts& out) {
  float n[3];
  plane_normal(g1, n);
  make_frame(n, out.frame);
  const float np0 = dot3(n, g1.p);
  float corner[8][3], cd[8];
  int ci = 0;
  for (int ix = 0; ix < 2; ++ix) {
    for (int iy = 0; iy < 2; ++iy) {
      for (int iz = 0; iz < 2; ++iz, ++ci) {
        const float local[3] = {s2[0] * (ix ? 1.0f : -1.0f),
                                s2[1] * (iy ? 1.0f : -1.0f),
                                s2[2] * (iz ? 1.0f : -1.0f)};
        for (int i = 0; i < 3; ++i) {
          corner[ci][i] = g2.p[i] + (g2.R[i][0] * local[0] + g2.R[i][1] * local[1]
                                     + g2.R[i][2] * local[2]);
        }
        cd[ci] = dot3(corner[ci], n) - np0;
      }
    }
  }
  // the 4 most penetrating corners, lower index first on ties (lax.top_k's
  // order in the JAX package): a strict < scan keeps the first minimum
  bool taken[8] = {false, false, false, false, false, false, false, false};
  out.n = 4;
  for (int s = 0; s < 4; ++s) {
    float bestd = taken[0] ? INFINITY : cd[0];
    int best = 0;
    for (int i = 1; i < 8; ++i) {
      const float di = taken[i] ? INFINITY : cd[i];
      if (di < bestd) {
        bestd = di;
        best = i;
      }
    }
    taken[best] = true;
    out.dist[s] = bestd;
    for (int k = 0; k < 3; ++k) out.pos[s][k] = corner[best][k] - n[k] * (0.5f * bestd);
  }
}

}  // namespace mrp
