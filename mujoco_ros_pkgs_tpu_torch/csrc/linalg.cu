// Batched dense SPD solve x = H^-1 g (K1), one warp per env.
//
// Replaces mujoco_ros_pkgs_tpu/ops/linalg_tpu.py::_solve_batched (its Pallas
// body `_kernel`): a right-looking Cholesky with the pivot clamp
// rsqrt(max(d, 1e-30)), then forward and back substitution, fused. The port
// calls it through ops/linalg_tpu.psd_solve for the mass-matrix solve of
// every general step (smooth.solve_m) and Euler's implicit-damping solve; its
// plain-torch twin is linalg_tpu.psd_solve_plain.
//
// The TPU kernel puts 128 envs on the lanes and walks the columns with
// masked whole-matrix vector ops. Here each env is one warp: the lower
// triangle of H (n x n, n <= 96, any n at run time) goes to shared memory
// (n (n + 1) + n floats per env, 36 KB at n = 96, 0.6 KB at n = 11), the
// column loop is sequential, and the 32 lanes share the rows of each rank-1
// update and of the substitutions (csrc/warp.cuh's group Cholesky at
// G = 32). Four envs per block.
//
// Cost: each env reads n^2 + n floats and writes n, and does about n^3 / 3
// multiply-adds, so at the sizes of the general path (n = 11) the bound is the
// bytes; the kernel is held back by the n sequential column steps (a few
// warp barriers each), which the 4096 warps of a batch hide only in part.

#include <cuda_runtime.h>

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

}  // namespace mrp

// Plain C entry point (bound with ctypes): H (B, n, n), g (B, n), x (B, n),
// float32, contiguous, on the device. Launches on `stream` and returns
// cudaGetLastError() as an int (0 = launched).
extern "C" int psd_solve_launch(const void* H, const void* g, void* x, int B,
                                int n, void* stream) {
  if (B <= 0 || n <= 0 || n > mrp::kLinalgMaxN) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)mrp::kLinalgWarps * (n * (n + 1) + n) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        mrp::psd_solve_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int blocks = (B + mrp::kLinalgWarps - 1) / mrp::kLinalgWarps;
  mrp::psd_solve_kernel<<<blocks, mrp::kLinalgWarps * mrp::kLanes, smem,
                          (cudaStream_t)stream>>>(
      (const float*)H, (const float*)g, (float*)x, B, n);
  return (int)cudaGetLastError();
}
