// Plane narrowphase primitives as per-thread device functions.
//
// Replace `_plane_sphere`, `_plane_capsule` and `_plane_box` of the JAX
// package's mujoco_ros_pkgs_tpu/ops/narrowphase_soa.py, which its fused step
// kernel embeds. Same guards, contact order and tie breaking; their
// plain-torch twins are ops/narrowphase_soa.py of the torch port. Each
// computes one contact of its pair (the fused step gives each contact slot
// a lane of its own), with static array indices after unrolling, so nothing
// goes to local memory.
#pragma once

#include <math.h>

namespace mrp {

struct GeomFrame {
  float p[3];        // world position
  float R[3][3];     // world orientation, R[i][j] row i column j
};

struct Contact {
  float dist;
  float pos[3];
  float frame[3][3]; // rows (normal, t1, t2), shared by every contact of a pair
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

// Each primitive writes contact k of its pair (k < the pair's capacity: 1
// for a sphere, 2 for a capsule, 4 for a box), in the JAX package's order.

__device__ inline void plane_sphere(const GeomFrame& g1, const GeomFrame& g2,
                                    const float* s2, int k, Contact& out) {
  (void)k;
  float n[3], d[3];
  plane_normal(g1, n);
  for (int i = 0; i < 3; ++i) d[i] = g2.p[i] - g1.p[i];
  const float r = s2[0];
  const float dist = dot3(n, d) - r;
  out.dist = dist;
  for (int i = 0; i < 3; ++i) out.pos[i] = g2.p[i] - n[i] * (r + 0.5f * dist);
  make_frame(n, out.frame);
}

__device__ inline void plane_capsule(const GeomFrame& g1, const GeomFrame& g2,
                                     const float* s2, int k, Contact& out) {
  float n[3];
  plane_normal(g1, n);
  const float axis[3] = {g2.R[0][2], g2.R[1][2], g2.R[2][2]};
  const float r = s2[0], hl = s2[1];
  make_frame(n, out.frame);
  const float sgn = k == 0 ? 1.0f : -1.0f;
  float e[3], d[3];
  for (int i = 0; i < 3; ++i) e[i] = g2.p[i] + axis[i] * (sgn * hl);
  for (int i = 0; i < 3; ++i) d[i] = e[i] - g1.p[i];
  const float dist = dot3(n, d) - r;
  out.dist = dist;
  for (int i = 0; i < 3; ++i) out.pos[i] = e[i] - n[i] * (r + 0.5f * dist);
}

// corner ci of box g2 (half sizes s2), ci = (ix, iy, iz) in bits
__device__ inline void box_corner(const GeomFrame& g2, const float* s2, int ci, float* c) {
  const float local[3] = {s2[0] * ((ci & 4) ? 1.0f : -1.0f),
                          s2[1] * ((ci & 2) ? 1.0f : -1.0f),
                          s2[2] * ((ci & 1) ? 1.0f : -1.0f)};
  for (int i = 0; i < 3; ++i) {
    c[i] = g2.p[i] + (g2.R[i][0] * local[0] + g2.R[i][1] * local[1]
                      + g2.R[i][2] * local[2]);
  }
}

__device__ inline void plane_box(const GeomFrame& g1, const GeomFrame& g2,
                                 const float* s2, int k, Contact& out) {
  float n[3];
  plane_normal(g1, n);
  make_frame(n, out.frame);
  const float np0 = dot3(n, g1.p);
  float cd[8];
#pragma unroll
  for (int ci = 0; ci < 8; ++ci) {
    float c[3];
    box_corner(g2, s2, ci, c);
    cd[ci] = dot3(c, n) - np0;
  }
  // contact k is the k-th most penetrating corner, lower index first on
  // ties (lax.top_k's order in the JAX package): a strict < scan keeps the
  // first minimum. Every array index is static, so cd stays in registers.
  unsigned taken = 0u;
  float dist = 0.0f;
  int pick = 0;
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    float bestd = (taken & 1u) ? INFINITY : cd[0];
    int best = 0;
#pragma unroll
    for (int i = 1; i < 8; ++i) {
      const float di = ((taken >> i) & 1u) ? INFINITY : cd[i];
      if (di < bestd) {
        bestd = di;
        best = i;
      }
    }
    taken |= 1u << best;
    if (s == k) {
      dist = bestd;
      pick = best;
    }
  }
  float c[3];
  box_corner(g2, s2, pick, c);
  out.dist = dist;
  for (int i = 0; i < 3; ++i) out.pos[i] = c[i] - n[i] * (0.5f * dist);
}

}  // namespace mrp
