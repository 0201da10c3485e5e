// The twelve analytic narrowphase primitives as per-thread device functions.
//
// Replace the SoA primitives of the JAX package's
// mujoco_ros_pkgs_tpu/ops/narrowphase_soa.py (SOA_FNS), which its fused step
// kernel embeds: a plane against a sphere, a capsule, an ellipsoid, a
// cylinder and a box; sphere-sphere, sphere-capsule, sphere-cylinder,
// sphere-box; capsule-capsule, capsule-box; box-box. Same guards, contact
// order and tie breaking (first occurrence in every argmin and argmax, a
// strict > or < in every running best); their plain-torch twins are
// ops/narrowphase_soa.py of the torch port. Each computes one contact of its
// pair (the fused step gives each contact slot a lane of its own, so each of
// box-box's four lanes runs the whole separating-axis search), with static
// array indices after unrolling, so nothing goes to local memory. Geom 1 has
// the lower geom type (a plane is always geom 1), and the normal points from
// geom 1 into geom 2.
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

constexpr float kNpMinVal = 1e-15f;     // ops/math.py MINVAL

__device__ inline float dot3(const float* a, const float* b) {
  return a[0] * b[0] + a[1] * b[1] + a[2] * b[2];
}

__device__ inline void cross3(const float* a, const float* b, float* out) {
  out[0] = a[1] * b[2] - a[2] * b[1];
  out[1] = a[2] * b[0] - a[0] * b[2];
  out[2] = a[0] * b[1] - a[1] * b[0];
}

// sqrt(max(a . a, MINVAL^2)), the length every primitive divides by
__device__ inline float norm_safe3(const float* a) {
  return sqrtf(fmaxf(dot3(a, a), kNpMinVal * kNpMinVal));
}

__device__ inline void normalize3(const float* a, float* out) {
  const float inv = 1.0f / norm_safe3(a);
  out[0] = a[0] * inv;
  out[1] = a[1] * inv;
  out[2] = a[2] * inv;
}

__device__ inline float sign_(float x) {
  return x > 0.0f ? 1.0f : (x < 0.0f ? -1.0f : 0.0f);
}

__device__ inline float clampf(float x, float lo, float hi) {
  return fminf(fmaxf(x, lo), hi);
}

// column j of a frame's orientation (its j-th local axis in the world)
__device__ inline void col3(const float R[3][3], int j, float* c) {
  c[0] = R[0][j];
  c[1] = R[1][j];
  c[2] = R[2][j];
}

// world = R @ local, and local = R^T @ world
__device__ inline void rot3(const float R[3][3], const float* v, float* out) {
  for (int i = 0; i < 3; ++i) out[i] = R[i][0] * v[0] + R[i][1] * v[1] + R[i][2] * v[2];
}

__device__ inline void rot3t(const float R[3][3], const float* v, float* out) {
  for (int j = 0; j < 3; ++j) out[j] = R[0][j] * v[0] + R[1][j] * v[1] + R[2][j] * v[2];
}

// first-occurrence argmin / argmax of three values, as the index
__device__ inline int argmin3(float a0, float a1, float a2) {
  if (a0 <= a1 && a0 <= a2) return 0;
  return a1 <= a2 ? 1 : 2;
}

__device__ inline int argmax3(float a0, float a1, float a2) {
  if (a0 >= a1 && a0 >= a2) return 0;
  return a1 >= a2 ? 1 : 2;
}

// v[i] for a runtime i in 0..2, without indexing (keeps v in registers)
__device__ inline float pick3(const float* v, int i) {
  return i == 0 ? v[0] : (i == 1 ? v[1] : v[2]);
}

// mju_makeFrame: rows (n, t1, t2); helper axis = the coordinate axis with the
// smallest |n| component, first on ties.
__device__ inline void make_frame(const float* n_in, float F[3][3]) {
  float n[3];
  normalize3(n_in, n);
  const int h = argmin3(fabsf(n[0]), fabsf(n[1]), fabsf(n[2]));
  const float a[3] = {h == 0 ? 1.0f : 0.0f, h == 1 ? 1.0f : 0.0f, h == 2 ? 1.0f : 0.0f};
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
__device__ inline void plane_normal(const GeomFrame& g, float* n) { col3(g.R, 2, n); }

// Each primitive takes both frames and both sizes (s1 of geom 1, s2 of geom
// 2) and writes contact k of its pair (k < the pair's capacity, prim_cap in
// step_fused.cuh), in the JAX package's order.

__device__ inline void plane_sphere(const GeomFrame& g1, const GeomFrame& g2,
                                    const float* s1, const float* s2, int k,
                                    Contact& out) {
  (void)s1;
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
                                     const float* s1, const float* s2, int k,
                                     Contact& out) {
  (void)s1;
  float n[3], axis[3];
  plane_normal(g1, n);
  col3(g2.R, 2, axis);
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

// the ellipsoid's support point along -n (its deepest point)
__device__ inline void plane_ellipsoid(const GeomFrame& g1, const GeomFrame& g2,
                                       const float* s1, const float* s2, int k,
                                       Contact& out) {
  (void)s1;
  (void)k;
  float n[3], nl[3], sn[3], sup[3], p[3], d[3];
  plane_normal(g1, n);
  rot3t(g2.R, n, nl);
  for (int i = 0; i < 3; ++i) sn[i] = s2[i] * nl[i];
  const float f = -1.0f / norm_safe3(sn);
  for (int i = 0; i < 3; ++i) sup[i] = (s2[i] * sn[i]) * f;
  rot3(g2.R, sup, p);
  for (int i = 0; i < 3; ++i) p[i] = g2.p[i] + p[i];
  for (int i = 0; i < 3; ++i) d[i] = p[i] - g1.p[i];
  const float dist = dot3(n, d);
  out.dist = dist;
  for (int i = 0; i < 3; ++i) out.pos[i] = p[i] - n[i] * (0.5f * dist);
  make_frame(n, out.frame);
}

// 4 contacts: a tilted cylinder's two rim points on each cap, the lower
// cap's first; an upright one (axis within 1e-8 of n) the lower cap's rim
// points at 0, 120 and 240 degrees about its x axis, slot 3 inactive (1e10)
__device__ inline void plane_cylinder(const GeomFrame& g1, const GeomFrame& g2,
                                      const float* s1, const float* s2, int k,
                                      Contact& out) {
  (void)s1;
  float n[3], a[3], perp[3];
  plane_normal(g1, n);
  col3(g2.R, 2, a);
  const float r = s2[0], hl = s2[1];
  const float an = dot3(a, n);
  for (int i = 0; i < 3; ++i) perp[i] = -(n[i] - a[i] * an);
  const float pnorm = norm_safe3(perp);
  const bool degenerate = pnorm < 1e-8f;
  const float lower = an > 0.0f ? -1.0f : 1.0f;
  make_frame(n, out.frame);
  float pt[3];
  if (degenerate) {
    const float cs = lower * hl;
    float center[3];
    for (int i = 0; i < 3; ++i) center[i] = g2.p[i] + a[i] * cs;
    const float h32 = 0.8660254037844386f;
    for (int i = 0; i < 3; ++i) {
      const float t1 = g2.R[i][0], t2 = g2.R[i][1];
      if (k == 0) pt[i] = center[i] + t1 * r;
      else if (k == 1) pt[i] = center[i] + (t1 * (-0.5f * r) + t2 * (h32 * r));
      else if (k == 2) pt[i] = center[i] + (t1 * (-0.5f * r) + t2 * (-h32 * r));
      else pt[i] = center[i];
    }
  } else {
    // slots 0, 1: the lower cap's center +- rim r; 2, 3: the upper cap's
    const float inv = 1.0f / pnorm;
    const float cs = (k < 2 ? lower : -lower) * hl;
    const float rs = (k & 1) ? -1.0f : 1.0f;
    for (int i = 0; i < 3; ++i) {
      const float center = g2.p[i] + a[i] * cs;
      const float rim = perp[i] * inv;
      pt[i] = rs > 0.0f ? center + rim * r : center - rim * r;
    }
  }
  float dist = dot3(pt, n) - dot3(n, g1.p);
  if (k == 3 && degenerate) dist = 1e10f;
  out.dist = dist;
  for (int i = 0; i < 3; ++i) out.pos[i] = pt[i] - n[i] * (0.5f * dist);
}

// corner ci of box g (half sizes s), ci = (ix, iy, iz) in bits
__device__ inline void box_corner(const GeomFrame& g, const float* s, int ci, float* c) {
  const float local[3] = {s[0] * ((ci & 4) ? 1.0f : -1.0f),
                          s[1] * ((ci & 2) ? 1.0f : -1.0f),
                          s[2] * ((ci & 1) ? 1.0f : -1.0f)};
  for (int i = 0; i < 3; ++i) {
    c[i] = g.p[i] + (g.R[i][0] * local[0] + g.R[i][1] * local[1] + g.R[i][2] * local[2]);
  }
}

__device__ inline void plane_box(const GeomFrame& g1, const GeomFrame& g2,
                                 const float* s1, const float* s2, int k,
                                 Contact& out) {
  (void)s1;
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

// the contact of two spheres of radii r1, r2 whose closest centers are q1
// and q2 (the capsules' segment points): normal q1 -> q2
__device__ inline void spheres_contact(const float* q1, const float* q2, float r1,
                                       float r2, Contact& out) {
  float dvec[3], n[3];
  for (int i = 0; i < 3; ++i) dvec[i] = q2[i] - q1[i];
  normalize3(dvec, n);
  const float dist = norm_safe3(dvec) - r1 - r2;
  out.dist = dist;
  for (int i = 0; i < 3; ++i) out.pos[i] = q1[i] + n[i] * (r1 + 0.5f * dist);
  make_frame(n, out.frame);
}

__device__ inline void sphere_sphere(const GeomFrame& g1, const GeomFrame& g2,
                                     const float* s1, const float* s2, int k,
                                     Contact& out) {
  (void)k;
  spheres_contact(g1.p, g2.p, s1[0], s2[0], out);
}

__device__ inline void sphere_capsule(const GeomFrame& g1, const GeomFrame& g2,
                                      const float* s1, const float* s2, int k,
                                      Contact& out) {
  (void)k;
  float axis[3], d[3], p[3];
  col3(g2.R, 2, axis);
  const float hl = s2[1];
  for (int i = 0; i < 3; ++i) d[i] = g1.p[i] - g2.p[i];
  const float t = clampf(dot3(d, axis), -hl, hl);
  for (int i = 0; i < 3; ++i) p[i] = g2.p[i] + axis[i] * t;
  spheres_contact(g1.p, p, s1[0], s2[0], out);
}

// closest points q1, q2 of the segments p1 +- h1 d1 and p2 +- h2 d2
__device__ inline void seg_seg_closest(const float* p1, const float* d1, float h1,
                                       const float* p2, const float* d2, float h2,
                                       float* q1, float* q2) {
  float r[3];
  for (int i = 0; i < 3; ++i) r[i] = p1[i] - p2[i];
  const float a = dot3(d1, d1), e = dot3(d2, d2), b = dot3(d1, d2);
  const float c = dot3(d1, r), f = dot3(d2, r);
  const float denom = a * e - b * b;
  float s = fabsf(denom) > 1e-12f ? (b * f - c * e) / denom : 0.0f;
  s = clampf(s, -h1, h1);
  const float t = clampf((b * s + f) / fmaxf(e, kNpMinVal), -h2, h2);
  const float s2 = clampf((b * t - c) / fmaxf(a, kNpMinVal), -h1, h1);
  for (int i = 0; i < 3; ++i) {
    q1[i] = p1[i] + d1[i] * s2;
    q2[i] = p2[i] + d2[i] * t;
  }
}

__device__ inline void capsule_capsule(const GeomFrame& g1, const GeomFrame& g2,
                                       const float* s1, const float* s2, int k,
                                       Contact& out) {
  (void)k;
  float a1[3], a2[3], q1[3], q2[3];
  col3(g1.R, 2, a1);
  col3(g2.R, 2, a2);
  seg_seg_closest(g1.p, a1, s1[1], g2.p, a2, s2[1], q1, q2);
  spheres_contact(q1, q2, s1[0], s2[0], out);
}

// a sphere (center c, radius r) against box b: the closest point on the
// box, or from inside its nearest face; also the capsule-box probe
__device__ inline void sphere_box_probe(const float* c, float r, const GeomFrame& b,
                                        const float* size, Contact& out) {
  float d[3], local[3], cl[3], closest[3], dvec[3], nn[3];
  for (int i = 0; i < 3; ++i) d[i] = c[i] - b.p[i];
  rot3t(b.R, d, local);
  bool inside = true;
  float depth[3], sl[3];
  for (int i = 0; i < 3; ++i) {
    const float absl = fabsf(local[i]);
    inside = inside && absl < size[i];
    depth[i] = size[i] - absl;
    sl[i] = sign_(local[i]);
  }
  const int face = argmin3(depth[0], depth[1], depth[2]);
  const float sgn = pick3(sl, face);
  for (int i = 0; i < 3; ++i) {
    const float clamped = clampf(local[i], -size[i], size[i]);
    cl[i] = (inside && i == face) ? sgn * size[i] : clamped;
  }
  rot3(b.R, cl, closest);
  for (int i = 0; i < 3; ++i) closest[i] = b.p[i] + closest[i];
  for (int i = 0; i < 3; ++i) dvec[i] = closest[i] - c[i];
  const float nrm = norm_safe3(dvec);
  normalize3(dvec, nn);
  if (inside)
    for (int i = 0; i < 3; ++i) nn[i] = -nn[i];
  const float dist = inside ? -(nrm + r) : nrm - r;
  out.dist = dist;
  for (int i = 0; i < 3; ++i) out.pos[i] = closest[i] - nn[i] * (0.5f * dist);
  make_frame(nn, out.frame);
}

__device__ inline void sphere_box(const GeomFrame& g1, const GeomFrame& g2,
                                  const float* s1, const float* s2, int k,
                                  Contact& out) {
  (void)k;
  sphere_box_probe(g1.p, s1[0], g2, s2, out);
}

__device__ inline void capsule_box(const GeomFrame& g1, const GeomFrame& g2,
                                   const float* s1, const float* s2, int k,
                                   Contact& out) {
  float e[3];
  const float sgn = k == 0 ? 1.0f : -1.0f;
  const float hl = s1[1];
  for (int i = 0; i < 3; ++i) e[i] = g1.p[i] + g1.R[i][2] * (sgn * hl);
  sphere_box_probe(e, s1[0], g2, s2, out);
}

// a sphere against a cylinder: the closest point on its side or a cap, or
// from inside the nearer of the two surfaces
__device__ inline void sphere_cylinder(const GeomFrame& g1, const GeomFrame& g2,
                                       const float* s1, const float* s2, int k,
                                       Contact& out) {
  (void)k;
  float d[3], local[3], cl[3], closest[3], dvec[3], nn[3];
  const float rs = s1[0], r = s2[0], hl = s2[1];
  for (int i = 0; i < 3; ++i) d[i] = g1.p[i] - g2.p[i];
  rot3t(g2.R, d, local);
  const float rad = sqrtf(fmaxf(local[0] * local[0] + local[1] * local[1],
                                kNpMinVal * kNpMinVal));
  const float rx = local[0] / rad, ry = local[1] / rad;
  const float clamped_z = clampf(local[2], -hl, hl);
  const float clamped_r = fminf(rad, r);
  const float absz = fabsf(local[2]);
  const bool inside = rad < r && absz < hl;
  bool side;
  if (inside) side = r - rad < hl - absz;
  else side = (rad > r && absz < hl) || !(absz >= hl);
  if (side) {
    cl[0] = rx * r;
    cl[1] = ry * r;
    cl[2] = clamped_z;
  } else {
    cl[0] = rx * clamped_r;
    cl[1] = ry * clamped_r;
    cl[2] = sign_(local[2]) * hl;
  }
  rot3(g2.R, cl, closest);
  for (int i = 0; i < 3; ++i) closest[i] = g2.p[i] + closest[i];
  for (int i = 0; i < 3; ++i) dvec[i] = closest[i] - g1.p[i];
  const float nrm = norm_safe3(dvec);
  normalize3(dvec, nn);
  if (inside)
    for (int i = 0; i < 3; ++i) nn[i] = -nn[i];
  const float dist = inside ? -(nrm + rs) : nrm - rs;
  out.dist = dist;
  for (int i = 0; i < 3; ++i) out.pos[i] = closest[i] - nn[i] * (0.5f * dist);
  make_frame(nn, out.frame);
}

// Box-box: the separating-axis test over 15 axes (3 face normals of each
// box, then the 9 edge crosses R1 col i x R2 col j), each update a strict >
// in that order; 4 contacts from the reference face (the box whose axis is
// most parallel to the face normal, box 1 on ties) clamped against the
// incident face, or 1 from the closest edges (slots 1-3 inactive, 1e10)
// when an edge axis separates more by 1e-9.

// corner (u, v) of the incident box's face most anti-parallel to nrm,
// clamped into the reference box: its distance along the reference face's
// normal, and its position
__device__ inline void box_face_contact(const GeomFrame& ref, const float* sr,
                                        const GeomFrame& inc, const float* si,
                                        const float* nrm, int k, float* dist_out,
                                        float* pos) {
  float ax[3], dots[3], nl[3];
  for (int j = 0; j < 3; ++j) {
    col3(inc.R, j, ax);
    dots[j] = dot3(nrm, ax);
    col3(ref.R, j, ax);
    nl[j] = dot3(nrm, ax);
  }
  const int iax = argmax3(fabsf(dots[0]), fabsf(dots[1]), fabsf(dots[2]));
  const float isgn = -sign_(pick3(dots, iax));
  const int rax = argmax3(fabsf(nl[0]), fabsf(nl[1]), fabsf(nl[2]));
  const float rsgn = sign_(pick3(nl, rax));
  const float sr_r = pick3(sr, rax);
  const float u = (k & 2) ? 1.0f : -1.0f, v = (k & 1) ? 1.0f : -1.0f;
  float local[3];
  if (iax == 0) {
    local[0] = isgn * si[0];
    local[1] = u * si[1];
    local[2] = v * si[2];
  } else if (iax == 1) {
    local[0] = v * si[0];
    local[1] = isgn * si[1];
    local[2] = u * si[2];
  } else {
    local[0] = u * si[0];
    local[1] = v * si[1];
    local[2] = isgn * si[2];
  }
  float corner[3], d[3], loc[3], pl[3];
  rot3(inc.R, local, corner);
  for (int i = 0; i < 3; ++i) d[i] = (inc.p[i] + corner[i]) - ref.p[i];
  rot3t(ref.R, d, loc);
  const float loc_r = pick3(loc, rax);
  const float dist = rsgn * loc_r - sr_r;
  const float fix = loc_r - 0.5f * dist * rsgn;
  for (int i = 0; i < 3; ++i)
    pl[i] = i == rax ? fix : clampf(loc[i], -sr[i], sr[i]);
  rot3(ref.R, pl, pos);
  for (int i = 0; i < 3; ++i) pos[i] = ref.p[i] + pos[i];
  *dist_out = dist;
}

// the edge of box g most nearly perpendicular to dir through its corner
// farthest along dir: center, direction and half length
__device__ inline void box_support_edge(const GeomFrame& g, const float* s,
                                        const float* dir, float* center, float* edir,
                                        float* half) {
  float ax[3], dk[3], sg[3], local[3], corner[3];
  for (int j = 0; j < 3; ++j) {
    col3(g.R, j, ax);
    dk[j] = dot3(dir, ax);
    const float sj = sign_(dk[j]);
    sg[j] = sj == 0.0f ? 1.0f : sj;
    local[j] = sg[j] * s[j];
  }
  rot3(g.R, local, corner);
  const int e = argmin3(fabsf(dk[0]), fabsf(dk[1]), fabsf(dk[2]));
  col3(g.R, e, edir);
  *half = pick3(s, e);
  const float shift = pick3(sg, e) * *half;
  for (int i = 0; i < 3; ++i) center[i] = (g.p[i] + corner[i]) - edir[i] * shift;
}

__device__ inline void box_box(const GeomFrame& g1, const GeomFrame& g2,
                               const float* s1, const float* s2, int k, Contact& out) {
  float t[3];
  for (int i = 0; i < 3; ++i) t[i] = g2.p[i] - g1.p[i];
  float best_face_sep = -INFINITY, best_edge_sep = -INFINITY;
  float face_axis[3] = {0.0f, 0.0f, 0.0f}, edge_axis[3] = {0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int q = 0; q < 15; ++q) {
    float ax[3];
    if (q < 3) {
      col3(g1.R, q, ax);
    } else if (q < 6) {
      col3(g2.R, q - 3, ax);
    } else {
      float c1[3], c2[3];
      col3(g1.R, (q - 6) / 3, c1);
      col3(g2.R, (q - 6) % 3, c2);
      cross3(c1, c2, ax);
    }
    const float ln = norm_safe3(ax);
    const float inv = 1.0f / fmaxf(ln, kNpMinVal);
    float a[3];
    for (int i = 0; i < 3; ++i) a[i] = ax[i] * inv;
    const float at = dot3(a, t);
    const float sgn = at < 0.0f ? -1.0f : 1.0f;
    for (int i = 0; i < 3; ++i) a[i] = a[i] * sgn;
    float ra = 0.0f, rb = 0.0f, c[3];
    for (int j = 0; j < 3; ++j) {
      col3(g1.R, j, c);
      ra = ra + fabsf(dot3(a, c)) * s1[j];
    }
    for (int j = 0; j < 3; ++j) {
      col3(g2.R, j, c);
      rb = rb + fabsf(dot3(a, c)) * s2[j];
    }
    float sep = fabsf(at) - (ra + rb);
    if (!(ln > 1e-9f)) sep = -INFINITY;
    if (q < 6) {
      if (sep > best_face_sep) {
        best_face_sep = sep;
        for (int i = 0; i < 3; ++i) face_axis[i] = a[i];
      }
    } else if (sep > best_edge_sep) {
      best_edge_sep = sep;
      for (int i = 0; i < 3; ++i) edge_axis[i] = a[i];
    }
  }
  const bool use_edge = best_edge_sep > best_face_sep + 1e-9f;
  if (use_edge) {
    float c1[3], e1[3], c2[3], e2[3], neg[3], q1[3], q2[3], dvec[3], nn[3];
    float h1, h2;
    box_support_edge(g1, s1, edge_axis, c1, e1, &h1);
    for (int i = 0; i < 3; ++i) neg[i] = -edge_axis[i];
    box_support_edge(g2, s2, neg, c2, e2, &h2);
    seg_seg_closest(c1, e1, h1, c2, e2, h2, q1, q2);
    for (int i = 0; i < 3; ++i) dvec[i] = q2[i] - q1[i];
    normalize3(dvec, nn);
    const float flip = dot3(dvec, edge_axis) < 0.0f ? -1.0f : 1.0f;
    const bool apart = norm_safe3(dvec) > 1e-9f;
    for (int i = 0; i < 3; ++i) nn[i] = apart ? nn[i] * flip : edge_axis[i];
    make_frame(nn, out.frame);
    out.dist = k == 0 ? best_edge_sep : 1e10f;
    for (int i = 0; i < 3; ++i) out.pos[i] = k == 0 ? (q1[i] + q2[i]) * 0.5f : 0.0f;
    return;
  }
  float a1 = 0.0f, a2 = 0.0f, c[3];
  for (int j = 0; j < 3; ++j) {
    col3(g1.R, j, c);
    a1 = fmaxf(a1, fabsf(dot3(face_axis, c)));
    col3(g2.R, j, c);
    a2 = fmaxf(a2, fabsf(dot3(face_axis, c)));
  }
  make_frame(face_axis, out.frame);
  if (a1 >= a2) {
    box_face_contact(g1, s1, g2, s2, face_axis, k, &out.dist, out.pos);
  } else {
    float neg[3];
    for (int i = 0; i < 3; ++i) neg[i] = -face_axis[i];
    box_face_contact(g2, s2, g1, s1, neg, k, &out.dist, out.pos);
  }
}

}  // namespace mrp
