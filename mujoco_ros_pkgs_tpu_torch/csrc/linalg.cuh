// K1's per-env body for n <= 16: one group of G lanes per env (G = 8 for
// n <= 8, 16 for n <= 16; kernels.psd_width picks it), lane i holding row i
// of the matrix in registers. csrc/linalg.cu launches it; the host harness
// (tests/csrc_host_harness.cpp) runs it on host threads.
//
// Lane i reads row i of H's lower triangle, H[i][0..i], straight into
// h[0..i] (zeros above the diagonal and in lanes i >= n) and g_i into a
// register; warp.cuh's group_chol_solve_rows does the rest by shuffles,
// with no barrier: the right-looking Cholesky with the pivot clamp
// rsqrt(max(d, 1e-30)), then forward and back substitution. Lane i writes
// x_i, so the group's stores are consecutive.
//
// n is a template parameter (the launch instantiates every n <= G), so the
// solve unrolls to exactly n columns with no run-time bound checks. The
// shuffles name the whole warp (Group::whole_warp): no group leaves early.
// A group past the end of the batch solves a copy of the last env and
// stores nothing.
//
// The loads of a group's lanes are n floats apart, but the env's n^2 floats
// are contiguous and every byte read is used, so each is fetched from device
// memory once; staging the matrix through shared memory first (coalesced
// loads, a barrier, then the row reads) ran slower on the H100.
#pragma once

#include "warp.cuh"

namespace mrp {

constexpr int kRowsThreads = 128;   // threads per block of the row kernel

// One thread's part of the solve of env block * (kRowsThreads / G) +
// thread / G. H (B, n, n), g (B, n), x (B, n), n <= G. Lanes i >= n hold
// zeros and store nothing.
template <int G, int n>
__device__ inline void psd_rows_env(int block, int thread, const float* __restrict__ H,
                                    const float* __restrict__ g, float* __restrict__ x,
                                    int B) {
  static_assert(1 <= n && n <= G, "a lane owns one row");
  const Group<G> grp = Group<G>::whole_warp(thread);
  const int env = block * (kRowsThreads / G) + thread / G;
  const int src = env < B ? env : B - 1;
  const int i = grp.lane;
  const bool row = i < n;
  const float* Hi = H + ((size_t)src * n + i) * n;
  float h[n];
#pragma unroll
  for (int k = 0; k < n; ++k) h[k] = row && k <= i ? Hi[k] : 0.0f;
  const float y = group_chol_solve_rows<G, n>(grp, h, row ? g[(size_t)src * n + i] : 0.0f,
                                              n);
  if (row && env < B) x[(size_t)env * n + i] = y;
}

}  // namespace mrp
