// K1's per-env bodies. csrc/linalg.cu launches them; the host harness
// (tests/csrc_host_harness.cpp) runs them on host threads.
//
// psd_rows_env, n <= 16: one group of G lanes per env (G = 8 for n <= 8,
// 16 for n <= 16; kernels.psd_width picks it), lane i holding row i of the
// matrix in registers. Lane i reads row i of H's lower triangle, H[i][0..i],
// straight into h[0..i] (zeros above the diagonal and in lanes i >= n) and
// g_i into a register; warp.cuh's group_chol_solve_rows does the rest by
// shuffles, with no barrier: the right-looking Cholesky with the pivot clamp
// rsqrt(max(d, 1e-30)), then forward and back substitution. Lane i writes
// x_i, so the group's stores are consecutive. n is a template parameter (the
// launch instantiates every n <= G), so the solve unrolls to exactly n
// columns with no run-time bound checks. The shuffles name the whole warp
// (Group::whole_warp): no group leaves early. A group past the end of the
// batch solves a copy of the last env and stores nothing. The loads of a
// group's lanes are n floats apart, but the env's n^2 floats are contiguous
// and every byte read is used, so each is fetched from device memory once;
// staging the matrix through shared memory first (coalesced loads, a
// barrier, then the row reads) ran slower on the H100.
//
// psd_block_env, 17 <= n <= 96: one block of kBlockWarps = 4 warps per env
// (linalg.cu says why), the same arithmetic in panels of kPanel = 8 columns:
//
// - n is padded to N, a multiple of 8, with an identity extension (1 on the
//   diagonal, 0 elsewhere, g 0), as the TPU kernel pads to a multiple of 8:
//   the padding's pivots are 1 and its L entries 0, so rows and columns < n
//   get the arithmetic of the unpadded solve and x's padding is 0.
// - g rides along as row N of the lower triangle. The Cholesky step that
//   makes column j of L then turns row N's entry j into y_j (divided by
//   L_jj, as the forward substitution does), and the updates subtract
//   y_j L_kj from it column by column: the forward substitution is done by
//   the factorisation.
// - Shared memory holds only what the factorisation reads: the rows of each
//   band of 8 rows (panel row P) up to the end of their diagonal block,
//   8 (P + 1) floats each, 16-byte aligned; then the g block, rows N..N+3
//   of N floats (g, then zeros); then the current panel transposed, 8 rows
//   of N + 4 floats (BlockLayout). Entries above the diagonal inside a
//   diagonal block are stored but never read into an entry on or below it,
//   so whatever they hold (H's upper triangle, NaN) leaves x as it is.
// - Per panel, the threads holding its rows (row c0 + thread; a panel
//   has at most N + 4 <= 100 rows, fewer than the block's 128 threads)
//   each factor the 8 x 8 diagonal block in registers, the same values in
//   every thread, and then their own rows with it, column by column: no
//   shuffle and no barrier inside the panel. They write L back and its
//   transpose beside it. After a block barrier every thread updates the
//   trailing lower triangle (and the g rows) in 4 x 4 register tiles: each
//   entry is loaded once, the panel's 8 columns are subtracted in column
//   order (so each entry sees the sequence of the column-by-column
//   algorithm), and it is stored once: 24 shared-memory instructions of 16
//   bytes per 128 multiply-adds. Tile t of the trailing triangle, row-major,
//   is found from t by one square root, so a warp's threads take
//   neighbouring tiles of one tile row: consecutive 16-byte words, no bank
//   conflict. A second barrier ends the panel.
// - Back substitution, warp 0 alone, by panel from the last, y and x in
//   registers: x_c = (y_c - s_c) / L_cc, each dot product s_c summed by
//   lanes and a butterfly, as the plain version and the previous design
//   sum it (taking its terms from y_c one at a time loses accuracy on the
//   ill-conditioned Hessians of PILE), the diagonal block solved by every
//   lane itself. No barrier.
// - Then one step of iterative refinement on warp 0: the residual
//   g - H x summed in float64 from H's lower triangle in device memory,
//   and the correction solved with the float32 factor by a forward and a
//   back substitution (residual, forward_substitute, back_substitute).
//
// The load reads H's lower triangle row by row, a warp to a row and its
// lanes on consecutive 16-byte words (cp.async 16-byte copies when n % 4 ==
// 0 and H is 16-byte aligned, so every row is; 4-byte copies otherwise),
// with no integer division per element.
#pragma once

#include "warp.cuh"

namespace mrp {

constexpr int kRowsThreads = 128;   // threads per block of the row kernel
constexpr int kPanel = 8;           // columns per panel of the block body
constexpr int kBlockWarps = 4;      // warps per env of the block body
constexpr int kBlockThreads = kBlockWarps * 32;
constexpr unsigned kFullMask = 0xffffffffu;

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

// Shared-memory layout of one env of the block body (offsets in floats).
struct BlockLayout {
  int N;       // n padded to a multiple of kPanel
  int panels;  // N / kPanel
  int g;       // the g block: rows N..N+3, N floats each
  int lt;      // the current panel's transpose: kPanel rows of N + 4 floats
  int total;
};

__host__ __device__ inline BlockLayout block_layout(int n) {
  BlockLayout l;
  l.panels = (n + kPanel - 1) / kPanel;
  l.N = l.panels * kPanel;
  l.g = 32 * l.panels * (l.panels + 1);    // panel row P: 8 rows of 8 (P + 1)
  l.lt = l.g + 4 * l.N;
  l.total = l.lt + kPanel * (l.N + 4);
  return l;
}

// Offset of row i (0 <= i < N + 4) of the lower triangle.
__device__ __forceinline__ int row_offset(const BlockLayout& l, int i) {
  if (i >= l.N) return l.g + (i - l.N) * l.N;
  const int P = i >> 3;
  return 8 * (P + 1) * (4 * P + (i & 7));
}

__device__ __forceinline__ void ld4(const float* p, float* v) {
#ifdef __CUDA_ARCH__
  const float4 q = *reinterpret_cast<const float4*>(p);
  v[0] = q.x;
  v[1] = q.y;
  v[2] = q.z;
  v[3] = q.w;
#else
  for (int k = 0; k < 4; ++k) v[k] = p[k];
#endif
}

__device__ __forceinline__ void st4(float* p, const float* v) {
#ifdef __CUDA_ARCH__
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
#else
  for (int k = 0; k < 4; ++k) p[k] = v[k];
#endif
}

// 1 / sqrt(d) for a normal d (the pivot clamp keeps d >= 1e-30): rsqrtf's
// instruction without its handling of subnormal inputs.
__device__ __forceinline__ float rsqrt_normal(float d) {
#ifdef __CUDA_ARCH__
  float r;
  asm("rsqrt.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(d));
  return r;
#else
  return rsqrtf(d);
#endif
}

// Copies from device to shared memory that run while the thread goes on;
// copy_wait waits for all of the thread's own.
__device__ __forceinline__ void copy16(float* dst, const float* src) {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src)
               : "memory");
#else
  for (int k = 0; k < 4; ++k) dst[k] = src[k];
#endif
}

__device__ __forceinline__ void copy4(float* dst, const float* src) {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src)
               : "memory");
#else
  *dst = *src;
#endif
}

__device__ __forceinline__ void copy_wait() {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.wait_all;\n" ::: "memory");
#endif
}

// Loads the diagonal block of panel c0 (rows and columns c0..c0+7, lower
// part; the entries above its diagonal are left as they come).
__device__ __forceinline__ void load_diagonal(const float* sm, int c0,
                                              float (&d)[kPanel][kPanel]) {
  const int ld = c0 + kPanel;             // the panel row's row length
  const float* blk = sm + ld * (c0 >> 1) + c0;   // row_offset(c0) + c0
#pragma unroll
  for (int i = 0; i < kPanel; ++i) {
    ld4(blk + i * ld, d[i]);
    ld4(blk + i * ld + 4, d[i] + 4);
  }
}

// Every thread of a warp that holds rows of the panel: columns c0..c0+7 of
// rows c0..N+3 (row N: g), the thread's row c0 + thread. Each thread first factors the 8 x 8 diagonal block itself, in registers (the
// same values in every thread), then its own rows with it, column by
// column; it writes L back, and its transpose to lt. Threads 0..7 keep
// their diagonal-block row in diag instead: other threads may still be
// reading the block, so it is stored after the next barrier (store_diag).
__device__ inline void factor_panel(float* sm, const BlockLayout& l, int c0, int thread,
                                    float (&diag)[kPanel]) {
  const int rows = l.N + 4;
  if (c0 + (thread & ~(kLanes - 1)) >= rows) return;   // the warp holds no row
  float d[kPanel][kPanel];
  load_diagonal(sm, c0, d);
  float inv[kPanel];
#pragma unroll
  for (int j = 0; j < kPanel; ++j) {
    inv[j] = rsqrt_normal(fmaxf(d[j][j], 1e-30f));
#pragma unroll
    for (int i = j; i < kPanel; ++i) d[i][j] *= inv[j];
#pragma unroll
    for (int i = j + 1; i < kPanel; ++i) {
#pragma unroll
      for (int k = j + 1; k <= i; ++k) d[i][k] -= d[i][j] * d[k][j];
    }
  }
  float* lt = sm + l.lt;
  const int ldt = l.N + 4;
  const int i = c0 + thread;
  if (i >= rows) return;
  float* row = sm + row_offset(l, i) + c0;
  float h[kPanel];
  ld4(row, h);
  ld4(row + 4, h + 4);
#pragma unroll
  for (int j = 0; j < kPanel; ++j) {
    // y_j = g_j / L_jj on the g row, L_ij = A_ij / sqrt(d_j) on the rest
    h[j] = i == l.N ? div_rn(h[j], d[j][j]) : h[j] * inv[j];
#pragma unroll
    for (int k = j + 1; k < kPanel; ++k) h[k] -= h[j] * d[k][j];
  }
  if (thread < kPanel) {
#pragma unroll
    for (int k = 0; k < kPanel; ++k) diag[k] = h[k];
    return;
  }
  st4(row, h);
  st4(row + 4, h + 4);
#pragma unroll
  for (int k = 0; k < kPanel; ++k) lt[k * ldt + i] = h[k];
}

// Threads 0..7: row c0 + thread of L's diagonal block, from factor_panel.
__device__ __forceinline__ void store_diag(float* sm, const BlockLayout& l, int c0,
                                           int thread, const float (&diag)[kPanel]) {
  if (thread < kPanel) {
    float* row = sm + row_offset(l, c0 + thread) + c0;
    st4(row, diag);
    st4(row + 4, diag + 4);
  }
}

// Every thread: the rows and columns from k0 on (and the g rows) lose the
// panel's 8 columns, in 4 x 4 tiles of the lower triangle.
__device__ inline void update_trailing(float* sm, const BlockLayout& l, int k0,
                                       int thread) {
  const int m = (l.N - k0) >> 2;          // tile rows and columns left
  const int tiles = m * (m + 1) / 2 + m;  // the triangle, then the g rows' m
  const int K0 = k0 >> 2, M = l.N >> 2;
  const float* lt = sm + l.lt;
  const int ldt = l.N + 4;
  for (int t = thread; t < tiles; t += kBlockThreads) {
    const int r = (int)((sqrtf(8.0f * t + 1.0f) - 1.0f) * 0.5f);   // exact: t < 400
    const int I = K0 + r, K = K0 + t - r * (r + 1) / 2;
    int base = l.g, ld = l.N;
    if (I < M) {
      const int P = I >> 1;
      ld = 8 * (P + 1);
      base = ld * (4 * P + 4 * (I & 1));
    }
    float* a = sm + base + 4 * K;
    float acc[4][4];
#pragma unroll
    for (int u = 0; u < 4; ++u) ld4(a + u * ld, acc[u]);
#pragma unroll
    for (int j = 0; j < kPanel; ++j) {
      float li[4], lk[4];
      ld4(lt + j * ldt + 4 * I, li);
      ld4(lt + j * ldt + 4 * K, lk);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
#pragma unroll
        for (int v = 0; v < 4; ++v) acc[u][v] -= li[u] * lk[v];
      }
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) st4(a + u * ld, acc[u]);
  }
}

// y_k of lane k % 32 (slot k / 32 of y), to every lane.
__device__ __forceinline__ float y_entry(const float (&y)[3], int k) {
  const int s = k >> 5;
  return __shfl_sync(kFullMask, s == 0 ? y[0] : s == 1 ? y[1] : y[2], k & (kLanes - 1),
                     kLanes);
}

// Warp 0: z = L^-1 r by panel from the first, lane l holding r_k and then
// z_k for k = l + 32 s in registers (the refinement step's forward
// substitution; the first solve's rides in the factorisation). For each
// column c of the panel, z_c = (r_c - s_c) / L_cc with s_c = sum_{k < c}
// L_ck z_k: each lane sums its columns left of the panel (L_ck from row c
// of L, z_k its own), a butterfly adds the 32 lanes' sums, and each lane
// then adds the terms inside the diagonal block, which it solves itself.
__device__ inline void forward_substitute(const float* sm, const BlockLayout& l, int lane,
                                          float (&r)[3]) {
  for (int p = 0; p < l.panels; ++p) {
    const int c0 = p * kPanel;
    float sum[kPanel] = {};
#pragma unroll
    for (int s = 0; s < 3; ++s) {
      const int k = lane + 32 * s;
      if (k < c0) {
#pragma unroll
        for (int c = 0; c < kPanel; ++c) sum[c] += sm[row_offset(l, c0 + c) + k] * r[s];
      }
    }
#pragma unroll
    for (int off = kLanes / 2; off > 0; off >>= 1) {
#pragma unroll
      for (int c = 0; c < kPanel; ++c) sum[c] += __shfl_xor_sync(kFullMask, sum[c], off);
    }
    float d[kPanel][kPanel], zs[kPanel];
    load_diagonal(sm, c0, d);
#pragma unroll
    for (int c = 0; c < kPanel; ++c) {
#pragma unroll
      for (int k = 0; k < c; ++k) sum[c] += d[c][k] * zs[k];
      zs[c] = div_rn(y_entry(r, c0 + c) - sum[c], d[c][c]);
    }
#pragma unroll
    for (int s = 0; s < 3; ++s) {
#pragma unroll
      for (int c = 0; c < kPanel; ++c) {
        if (lane + 32 * s == c0 + c) r[s] = zs[c];
      }
    }
  }
}

// Warp 0: r = g - H x in float64 from H's lower triangle in device memory
// (H_ij for j <= i, H_ji above), lane l holding x_k and then r_k for
// k = l + 32 s (0 past n), rounded to float32: the residual of one step of
// iterative refinement. Summed in float64, it keeps the digits that the
// float32 solve lost, so the correction solved with the same factor
// leaves x far closer to H^-1 g than any float32 ordering of the sums: on
// the general Newton's ill-conditioned Hessians two float32 orderings
// miss float64 by a factor of up to 5 apart on their worst envs (PERF.md,
// C7), the reference's own kernel as much as any.
__device__ inline void residual(const float* __restrict__ He, const float* __restrict__ ge,
                                int n, int lane, const float (&x)[3], float (&r)[3]) {
  double acc[3];
#pragma unroll
  for (int s = 0; s < 3; ++s) {
    const int i = lane + 32 * s;
    acc[s] = i < n ? (double)ge[i] : 0.0;
  }
  for (int j = 0; j < n; ++j) {
    const double xj = y_entry(x, j);
#pragma unroll
    for (int s = 0; s < 3; ++s) {
      const int i = lane + 32 * s;
      if (i < n) acc[s] -= (double)(j <= i ? He[i * n + j] : He[j * n + i]) * xj;
    }
  }
#pragma unroll
  for (int s = 0; s < 3; ++s) r[s] = (float)acc[s];
}

// Warp 0: x = L^-T y, y in registers, by panel from the last; lane l holds y_k
// and then x_k for k = l + 32 s in registers. For each column c of the
// panel, x_c = (y_c - s_c) / L_cc with s_c = sum_{k > c} L_kc x_k summed
// apart from y_c: each lane sums its rows below the panel (L_kc from row k
// of L, x_k its own), a butterfly adds the 32 lanes' sums, and each lane
// then adds the terms inside the diagonal block, which it solves itself
// (the same values in every lane). No barrier: x never leaves the
// registers.
__device__ inline void back_substitute(const float* sm, const BlockLayout& l, int lane,
                                       float (&y)[3]) {
  for (int p = l.panels - 1; p >= 0; --p) {
    const int c0 = p * kPanel;
    float sum[kPanel] = {};
#pragma unroll
    for (int s = 0; s < 3; ++s) {
      const int k = lane + 32 * s;
      if (k >= c0 + kPanel && k < l.N) {
        float lk[kPanel];
        const float* row = sm + row_offset(l, k) + c0;
        ld4(row, lk);
        ld4(row + 4, lk + 4);
#pragma unroll
        for (int c = 0; c < kPanel; ++c) sum[c] += lk[c] * y[s];
      }
    }
#pragma unroll
    for (int off = kLanes / 2; off > 0; off >>= 1) {
#pragma unroll
      for (int c = 0; c < kPanel; ++c) sum[c] += __shfl_xor_sync(kFullMask, sum[c], off);
    }
    float d[kPanel][kPanel], xs[kPanel];
    load_diagonal(sm, c0, d);
#pragma unroll
    for (int c = kPanel - 1; c >= 0; --c) {
#pragma unroll
      for (int k = c + 1; k < kPanel; ++k) sum[c] += d[k][c] * xs[k];
      xs[c] = div_rn(y_entry(y, c0 + c) - sum[c], d[c][c]);
    }
#pragma unroll
    for (int s = 0; s < 3; ++s) {
#pragma unroll
      for (int c = 0; c < kPanel; ++c) {
        if (lane + 32 * s == c0 + c) y[s] = xs[c];
      }
    }
  }
}

// One thread's part of the solve of env `env` by a block of kBlockThreads
// threads; sm: block_layout(n).total floats of shared memory. vec16:
// n % 4 == 0 and H 16-byte aligned.
__device__ inline void psd_block_env(float* sm, int env, int thread,
                                     const float* __restrict__ H,
                                     const float* __restrict__ g, float* __restrict__ x,
                                     int n, bool vec16) {
  const BlockLayout l = block_layout(n);
  const int N = l.N, warp = thread >> 5, lane = thread & (kLanes - 1);
  const float* He = H + (size_t)env * n * n;
  for (int i = warp; i < n; i += kBlockWarps) {
    float* dst = sm + row_offset(l, i);
    const float* src = He + (size_t)i * n;
    if (vec16) {
      for (int c = lane; c <= i >> 2; c += kLanes) copy16(dst + 4 * c, src + 4 * c);
    } else {
      for (int c = lane; c <= i; c += kLanes) copy4(dst + c, src + c);
    }
  }
  for (int i = n + warp; i < N; i += kBlockWarps) {        // the identity extension
    float* dst = sm + row_offset(l, i);
    for (int c = lane; c < (i & ~7) + 8; c += kLanes) dst[c] = c == i ? 1.0f : 0.0f;
  }
  for (int c = thread; c < 4 * N; c += kBlockThreads)
    sm[l.g + c] = c < n ? g[(size_t)env * n + c] : 0.0f;
  copy_wait();
  __syncthreads();
  float diag[kPanel];
  for (int p = 0; p < l.panels; ++p) {
    factor_panel(sm, l, p * kPanel, thread, diag);
    __syncthreads();
    store_diag(sm, l, p * kPanel, thread, diag);
    if (p + 1 < l.panels) update_trailing(sm, l, (p + 1) * kPanel, thread);
    __syncthreads();
  }
  if (warp != 0) return;
  float y[3], r[3];
#pragma unroll
  for (int s = 0; s < 3; ++s) {
    const int k = lane + 32 * s;
    y[s] = k < N ? sm[l.g + k] : 0.0f;
  }
  back_substitute(sm, l, lane, y);
  // one step of iterative refinement: x += (L L^T)^-1 (g - H x)
  residual(He, g + (size_t)env * n, n, lane, y, r);
  forward_substitute(sm, l, lane, r);
  back_substitute(sm, l, lane, r);
#pragma unroll
  for (int s = 0; s < 3; ++s) {
    const int k = lane + 32 * s;
    if (k < n) x[(size_t)env * n + k] = y[s] + r[s];
  }
}

}  // namespace mrp
