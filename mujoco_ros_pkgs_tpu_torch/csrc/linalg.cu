// Batched dense SPD solve x = H^-1 g (K1): for n <= 16 one group of 8 or 16
// lanes per env with the rows in registers, above that one block of 4 warps
// per env with the lower triangle in shared memory, factored in panels.
//
// Replaces mujoco_ros_pkgs_tpu/ops/linalg_tpu.py::_solve_batched (its Pallas
// body `_kernel`): a right-looking Cholesky with the pivot clamp
// rsqrt(max(d, 1e-30)), then forward and back substitution, fused; the
// port's kernel then takes one step of iterative refinement with a float64
// residual, which the TPU kernel does not take: float32 alone leaves the
// general Newton's ill-conditioned Hessians as far from float64 as chance
// puts the sums (ROADMAP C7, C7b). The port
// calls it through ops/linalg_tpu.psd_solve for the mass-matrix solve of
// every general step (smooth.solve_m), Euler's implicit-damping solve and
// the general Newton's step (ops/solver.newton, once per trip: PILE at
// n = 72); its plain-torch twin is linalg_tpu.psd_solve_plain.
//
// The TPU kernel puts 128 envs on the lanes and walks the columns with
// masked whole-matrix vector ops. Here (the bodies are csrc/linalg.cuh's):
//
// - n <= 16 (PENDULUM: n = nv = 11): psd_rows_kernel<G, n> runs
//   psd_rows_env on a group of G lanes per env, G = 8 for n <= 8 and 16
//   above (kernels.psd_width), 128 / G envs per block of 128 threads, one
//   instantiation per n. Lane i owns row i in registers and the columns go
//   by shuffles named for the whole warp (warp.cuh group_chol_factor_rows,
//   group_chol_substitute_rows), and the refinement's float64 residual is
//   summed by a reduce-scatter butterfly over the group
//   (linalg.cuh group_residual_rows): no shared memory and no barrier.
// - 17 <= n <= 96 (PILE: n = 72): psd_block_kernel runs psd_block_env on
//   one block of kBlockThreads = 128 threads per env (4 warps;
//   kernels.PSD_BLOCK_THREADS). 4 warps beat 2 at every n and batch swept
//   on the H100 (PERF.md, PR 7), so the width is fixed.
//
// Cost: each env reads H's lower triangle and g, n (n + 1) / 2 + n floats,
// writes n, and does about n^3 / 6 + 2 n^2 multiply-adds (the refinement's
// second substitutions) and n^2 in float64 (its residual), so at the sizes of
// the general path the bound is the bytes (n = 72, 4096 envs: 0.0136 ms;
// the operations 0.0082 ms). What holds the kernels back is latency: n
// dependent column steps per env, and as many envs in flight as hide it.
// The row kernel keeps each step to a shuffle, an rsqrt and a multiply-add
// per row. The block body (linalg.cuh):
//
// - Latency: inside a panel of 8 columns the column steps run in
//   registers, each thread of the panel's rows factoring the 8 x 8
//   diagonal block itself (no shuffle: a chain of rsqrt, multiply and
//   multiply-add per column); only the panel boundaries take block
//   barriers (two each); the trailing updates, nearly all the
//   multiply-adds, are spread over the block's threads in 4 x 4 register
//   tiles, one 16-byte shared-memory access per 5.3 multiply-adds; the
//   forward substitution rides in the factorisation (g as a row) and the
//   back substitution runs by panel on warp 0 with y in registers.
// - Occupancy: shared memory holds the lower triangle by bands of 8 rows
//   and the current panel's transpose, block_layout(n).total floats: 4224
//   bytes at n = 27 (N = 32), 15104 at n = 72, 24704 at n = 96. The
//   registers then set the envs per SM: __launch_bounds__ caps a block of
//   4 warps at 64 registers (8 blocks per SM, no stack), so n = 27, 72 and
//   96 all hold 8 envs per SM by the card's occupancy API (chip_smoke.py
//   prints it). 2 warps per env held 12, 12 and 9 at 79-80 registers and
//   ran slower all the same: an env's latency halves with its threads.
// - Loads: cp.async copies (16 bytes where every row of H is 16-byte
//   aligned) issued by all threads at once, then one barrier. A TMA load or
//   a persistent block that loads the next env while factoring this one was
//   not taken: the other resident blocks of the SM overlap one block's load
//   with their compute, and a triangle is not one TMA box.
// - Only the CUDA cores, in float32: TF32 tensor-core products would break
//   the PSD Hessians of the general Newton (PARITY.md, "TPU matmul
//   precision"; ROADMAP C4).

#include <cuda_runtime.h>

#include <stdint.h>

#include "linalg.cuh"

namespace mrp {

constexpr int kLinalgMaxN = 96;
static_assert(kLinalgMaxN + 4 <= kBlockThreads, "a thread holds at most one panel row");

template <int G, int n>
__global__ void __launch_bounds__(kRowsThreads) psd_rows_kernel(
    const float* __restrict__ H, const float* __restrict__ g, float* __restrict__ x,
    int B) {
  psd_rows_env<G, n>(blockIdx.x, threadIdx.x, H, g, x, B);
}

// 8 blocks per SM cap the registers at 64, which the body fits without
// stack.
__global__ void __launch_bounds__(kBlockThreads, 8) psd_block_kernel(
    const float* __restrict__ H, const float* __restrict__ g, float* __restrict__ x,
    int n, int vec16) {
  extern __shared__ __align__(16) float smem[];
  psd_block_env(smem, blockIdx.x, threadIdx.x, H, g, x, n, vec16 != 0);
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

size_t block_smem(int n) { return (size_t)block_layout(n).total * sizeof(float); }

}  // namespace mrp

// Plain C entry point (bound with ctypes): H (B, n, n), g (B, n), x (B, n),
// float32, contiguous, on the device, 1 <= n <= 96. group: lanes per env, 8
// or 16 (the row kernel, n <= group), or 128 (the block kernel). Launches
// on `stream` and returns cudaGetLastError() as an int (0 = launched).
extern "C" int psd_solve_launch(const void* H, const void* g, void* x, int B, int n,
                                int group, void* stream) {
  if (B <= 0 || n <= 0 || n > mrp::kLinalgMaxN) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (group) {
    case 8: return mrp::launch_rows<8>(H, g, x, B, n, s);
    case 16: return mrp::launch_rows<16>(H, g, x, B, n, s);
    case mrp::kBlockThreads: break;
    default: return (int)cudaErrorInvalidValue;
  }
  const size_t smem = mrp::block_smem(n);
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  const int vec16 = n % 4 == 0 && (uintptr_t)H % 16 == 0;
  mrp::psd_block_kernel<<<B, mrp::kBlockThreads, smem, s>>>(
      (const float*)H, (const float*)g, (float*)x, n, vec16);
  return (int)cudaGetLastError();
}

// Blocks (envs) of the block kernel that one SM holds at n, by the card's
// occupancy rules, with the shared memory a block takes in *smem_bytes
// (chip_smoke.py prints both); a negative CUDA error code if the query
// fails.
extern "C" int psd_block_per_sm(int n, int* smem_bytes) {
  if (n <= 0 || n > mrp::kLinalgMaxN) return -1;
  *smem_bytes = (int)mrp::block_smem(n);
  int blocks = 0;
  const cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, (const void*)mrp::psd_block_kernel, mrp::kBlockThreads, *smem_bytes);
  return e == cudaSuccess ? blocks : -(int)e;
}
