// The fused whole step (K3): the kernel and its launch. The per-env body
// and the design notes are in step_fused.cuh.

#include <cuda_runtime.h>

#include "step_fused.cuh"

namespace mrp {

template <int G>
__global__ void __launch_bounds__(solver::kThreads, solver::kMinBlocks) step_fused_kernel(
    const int* __restrict__ meta, const float* __restrict__ params,
    const float* __restrict__ qpos_in, const float* __restrict__ qvel_in,
    const float* __restrict__ ws_in, float* __restrict__ qpos_out,
    float* __restrict__ qvel_out, float* __restrict__ x_out, int B, int nefc,
    int ncon) {
  extern __shared__ float smem[];
  step_env<G>(smem, blockIdx.x, threadIdx.x, meta, params, qpos_in, qvel_in, ws_in,
              qpos_out, qvel_out, x_out, B, nefc, ncon);
}

template <int G>
int launch_step(const void* meta, const void* params, const void* qpos,
                const void* qvel, const void* ws, void* qpos_out, void* qvel_out,
                void* x_out, int B, int nefc, int ncon, cudaStream_t stream) {
  constexpr int per_block = solver::kThreads / G;
  const size_t smem =
      (size_t)per_block * solver::env_layout(NV, nefc, ncon).total * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        step_fused_kernel<G>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  step_fused_kernel<G><<<(B + per_block - 1) / per_block, solver::kThreads, smem,
                         stream>>>(
      (const int*)meta, (const float*)params, (const float*)qpos, (const float*)qvel,
      (const float*)ws, (float*)qpos_out, (float*)qvel_out, (float*)x_out, B, nefc,
      ncon);
  return (int)cudaGetLastError();
}

}  // namespace mrp

// Plain C entry point (bound with ctypes): meta and params as above, qpos
// (B, 7), qvel and ws (B, 6) in, qpos', qvel' and the solver's x out, all
// float32, contiguous, on the device; nefc and ncon the model's rows and
// contact slots (meta's solve block holds the same); group: lanes per env,
// 8 or 16. Launches on `stream` and returns cudaGetLastError() as an int
// (0 = launched).
extern "C" int step_fused_launch(const void* meta, const void* params,
                                 const void* qpos, const void* qvel,
                                 const void* ws, void* qpos_out, void* qvel_out,
                                 void* x_out, int B, int nefc, int ncon, int group,
                                 void* stream) {
  if (B <= 0 || nefc < 1 || nefc > mrp::solver::kMaxRows || ncon < 1 || ncon > nefc)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (group) {
    case 8: return mrp::launch_step<8>(meta, params, qpos, qvel, ws, qpos_out, qvel_out,
                                       x_out, B, nefc, ncon, s);
    case 16: return mrp::launch_step<16>(meta, params, qpos, qvel, ws, qpos_out,
                                         qvel_out, x_out, B, nefc, ncon, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Blocks of step_fused_kernel<group> one SM holds at nefc rows and ncon
// contacts by the card's occupancy rules, with the shared memory a block
// takes in *smem_bytes (chip_smoke.py prints both); a negative CUDA error
// code if the query fails, -1 for shapes the launch refuses.
extern "C" int step_fused_per_sm(int nefc, int ncon, int group, int* smem_bytes) {
  if (nefc < 1 || nefc > mrp::solver::kMaxRows || ncon < 1 || ncon > nefc) return -1;
  if (group != 8 && group != 16) return -1;
  const int per_block = mrp::solver::kThreads / group;
  const size_t smem = (size_t)per_block *
                      mrp::solver::env_layout(mrp::NV, nefc, ncon).total * sizeof(float);
  *smem_bytes = (int)smem;
  const void* fn = group == 8 ? (const void*)mrp::step_fused_kernel<8>
                              : (const void*)mrp::step_fused_kernel<16>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return -(int)e;
  }
  int blocks = 0;
  const cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, fn, mrp::solver::kThreads, smem);
  return e == cudaSuccess ? blocks : -(int)e;
}
