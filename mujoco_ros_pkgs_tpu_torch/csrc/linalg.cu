// Batched dense SPD solve x = H^-1 g (K1): for n <= 16 one group of 8 or 16
// lanes per env with the rows in registers, above that one warp per env
// with the matrix in shared memory.
//
// Replaces mujoco_ros_pkgs_tpu/ops/linalg_tpu.py::_solve_batched (its Pallas
// body `_kernel`): a right-looking Cholesky with the pivot clamp
// rsqrt(max(d, 1e-30)), then forward and back substitution, fused. The port
// calls it through ops/linalg_tpu.psd_solve for the mass-matrix solve of
// every general step (smooth.solve_m) and Euler's implicit-damping solve; its
// plain-torch twin is linalg_tpu.psd_solve_plain.
//
// The TPU kernel puts 128 envs on the lanes and walks the columns with
// masked whole-matrix vector ops. Here:
//
// - n <= 16 (the general path: n = nv = 11 on PENDULUM): psd_rows_kernel<G,
//   n> runs csrc/linalg.cuh's body on a group of G lanes per env, G = 8 for
//   n <= 8 and 16 above (kernels.psd_width), 128 / G envs per block of 128
//   threads, one instantiation per n. Lane i owns row i in registers and
//   the columns go by shuffles named for the whole warp (warp.cuh
//   group_chol_solve_rows): no shared memory and no barrier.
// - 17 <= n <= 96: psd_solve_kernel, one warp per env, four per block: the
//   lower triangle of H in shared memory (n (n + 1) + n floats per env, 36
//   KB at n = 96), the column loop sequential, the 32 lanes sharing the
//   rows of each rank-1 update and of the substitutions (warp.cuh
//   group_chol_solve at G = 32).
//
// Cost: each env reads H's lower triangle and g, n (n + 1) / 2 + n floats,
// writes n, and does about n^3 / 6 + n^2 multiply-adds, so at the sizes of
// the general path the bound is the bytes;
// both kernels are held back by the n sequential column steps (the row
// kernel's: a shuffle and an rsqrt, then a shuffle and a multiply-add per
// row below) and by their issue slots: a group's instruction does one
// row's work per lane.

#include <cuda_runtime.h>

#include "linalg.cuh"
#include "warp.cuh"

namespace mrp {

constexpr int kLinalgWarps = 4;   // envs per block
constexpr int kLinalgMaxN = 96;

__global__ void psd_solve_kernel(const float* __restrict__ H,
                                 const float* __restrict__ g,
                                 float* __restrict__ x, int B, int n) {
  extern __shared__ float smem[];
  const Group<kLanes> grp = Group<kLanes>::of(threadIdx.x);
  const int warp = threadIdx.x / kLanes, lane = grp.lane;
  const int env = blockIdx.x * kLinalgWarps + warp;
  if (env >= B) return;            // the whole warp leaves together
  const int ld = n + 1;            // odd row stride: fewer bank conflicts
  float* A = smem + warp * (n * ld + n);
  float* y = A + n * ld;
  const float* He = H + (size_t)env * n * n;
  for (int idx = lane; idx < n * n; idx += kLanes) {
    const int i = idx / n, j = idx - i * n;
    if (j <= i) A[i * ld + j] = He[idx];
  }
  for (int i = lane; i < n; i += kLanes) y[i] = g[(size_t)env * n + i];
  grp.sync();
  group_chol_solve(grp, A, ld, n, y);
  for (int i = lane; i < n; i += kLanes) x[(size_t)env * n + i] = y[i];
}

template <int G, int n>
__global__ void __launch_bounds__(kRowsThreads) psd_rows_kernel(
    const float* __restrict__ H, const float* __restrict__ g, float* __restrict__ x,
    int B) {
  psd_rows_env<G, n>(blockIdx.x, threadIdx.x, H, g, x, B);
}

// The row kernel at G lanes for the n at hand: tries N, N - 1, ..., 1.
template <int G, int N = G>
int launch_rows(const void* H, const void* g, void* x, int B, int n,
                cudaStream_t stream) {
  if constexpr (N >= 1) {
    if (n != N) return launch_rows<G, N - 1>(H, g, x, B, n, stream);
    constexpr int per_block = kRowsThreads / G;
    psd_rows_kernel<G, N><<<(B + per_block - 1) / per_block, kRowsThreads, 0, stream>>>(
        (const float*)H, (const float*)g, (float*)x, B);
    return (int)cudaGetLastError();
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace mrp

// Plain C entry point (bound with ctypes): H (B, n, n), g (B, n), x (B, n),
// float32, contiguous, on the device. group: lanes per env, 8 or 16 (the row
// kernel, n <= group) or 32 (the shared-memory kernel, n <= 96). Launches on
// `stream` and returns cudaGetLastError() as an int (0 = launched).
extern "C" int psd_solve_launch(const void* H, const void* g, void* x, int B, int n,
                                int group, void* stream) {
  if (B <= 0 || n <= 0 || n > mrp::kLinalgMaxN) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (group) {
    case 8: return mrp::launch_rows<8>(H, g, x, B, n, s);
    case 16: return mrp::launch_rows<16>(H, g, x, B, n, s);
    case 32: break;
    default: return (int)cudaErrorInvalidValue;
  }
  const size_t smem = (size_t)mrp::kLinalgWarps * (n * (n + 1) + n) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        mrp::psd_solve_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int blocks = (B + mrp::kLinalgWarps - 1) / mrp::kLinalgWarps;
  mrp::psd_solve_kernel<<<blocks, mrp::kLinalgWarps * mrp::kLanes, smem, s>>>(
      (const float*)H, (const float*)g, (float*)x, B, n);
  return (int)cudaGetLastError();
}
