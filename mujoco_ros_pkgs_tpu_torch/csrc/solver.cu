// The whole Newton constraint solve of a batch (K2), one group of G lanes
// per env.
//
// Replaces mujoco_ros_pkgs_tpu/ops/solver_tpu.py::solve_batched (its Pallas
// body `_make_kernel` over `newton_tiles`): warmstart, Newton trips with the
// Cholesky of H = M + J^T W J, grid line search and polish, per-env stop;
// then qfrc = J^T f and the row forces. The port calls it through
// ops/solver_tpu.solve_batched from ops/solver.solve, once per general step;
// its plain-torch twin is solver_tpu.newton_tiles. The per-env body is
// csrc/solver.cuh's, which the fused step (K3, step_fused.cu) runs too.
//
// Unlike the TPU kernel, which the JAX package traces anew for every row
// layout, this is one kernel for every system with nv <= 16 and at most 64
// rows: the layout (row codes 'eq' / 'fri' / one-sided / cone, the contacts'
// first rows and condims, niter, nls, warmstart) arrives at run time as the
// int32 vector of ops/solver_tpu.py::kernel_meta, in device memory.
//
// Design: the TPU kernel keeps one env per lane of a (8, 128) tile and
// unrolls every dof and row. Here each env is a group of G = 8 or 16 lanes
// of a warp (a template parameter; kernels.group_width picks it from the
// rows and the batch), so a warp holds 32 / G envs and a block of 128
// threads 128 / G. The env's rows, J, W J, M, H and vectors live in
// its slice of shared memory (env_layout: 5.4 KB at the general path's
// nv = 11 and 33 rows, 13.5 KB at the maxima), sized at launch; the lanes
// share rows, cones, dofs and the entries of H, and the line search runs in
// registers (solver.cuh).
//
// Cost: each env reads J, M and its row vectors once (about 2 KB at nv 11,
// 33 rows) and writes 2 nv + nefc floats, and does per Newton trip about
// nefc nv^2 multiply-adds for H plus the line search's 1 + nls passes over
// the rows, so at 4096 envs the bound is the operations of the trips these
// inputs need, far below what the sequential chain of group barriers per
// trip (the Cholesky's columns above all) reaches.

#include <cuda_runtime.h>

#include "solver.cuh"

namespace mrp {
namespace solver {

template <int G>
__global__ void __launch_bounds__(kThreads, kMinBlocks) newton_solve_kernel(
    const int* __restrict__ meta, const float* __restrict__ tol_p,
    const float* __restrict__ J, const float* __restrict__ aref,
    const float* __restrict__ D, const float* __restrict__ floss,
    const unsigned char* __restrict__ act, const float* __restrict__ mu,
    const float* __restrict__ M, const float* __restrict__ a_s,
    const float* __restrict__ ws, float* __restrict__ x_out,
    float* __restrict__ qfrc_out, float* __restrict__ f_out, int B, int nv,
    int nefc, int ncon) {
  extern __shared__ float smem[];
  solve_env<G>(smem, blockIdx.x, threadIdx.x, meta, tol_p, J, aref, D, floss, act, mu,
               M, a_s, ws, x_out, qfrc_out, f_out, B, nv, nefc, ncon);
}

template <int G>
int launch(const void* meta, const void* tol, const void* J, const void* aref,
           const void* D, const void* floss, const void* act, const void* mu,
           const void* M, const void* a_s, const void* ws, void* x_out, void* qfrc_out,
           void* f_out, int B, int nv, int nefc, int ncon, cudaStream_t stream) {
  const size_t smem =
      (size_t)(kThreads / G) * env_layout(nv, nefc, ncon).total * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        newton_solve_kernel<G>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int blocks = (B + kThreads / G - 1) / (kThreads / G);
  newton_solve_kernel<G><<<blocks, kThreads, smem, stream>>>(
      (const int*)meta, (const float*)tol, (const float*)J, (const float*)aref,
      (const float*)D, (const float*)floss, (const unsigned char*)act,
      (const float*)mu, (const float*)M, (const float*)a_s, (const float*)ws,
      (float*)x_out, (float*)qfrc_out, (float*)f_out, B, nv, nefc, ncon);
  return (int)cudaGetLastError();
}

}  // namespace solver
}  // namespace mrp

// Plain C entry point (bound with ctypes). meta: int32 from kernel_meta; tol:
// one float32; J (B, nefc, nv), aref / D / floss (B, nefc) float32, act
// (B, nefc) bool, mu (B, max(ncon, 1), 5), M (B, nv, nv), a_s / ws (B, nv);
// outputs x, qfrc (B, nv) and f (B, nefc). All contiguous, on the device.
// group: lanes per env, 8 or 16, at least nv. Launches on `stream` and returns
// cudaGetLastError() as an int (0 = launched).
extern "C" int newton_solve_launch(const void* meta, const void* tol,
                                   const void* J, const void* aref,
                                   const void* D, const void* floss,
                                   const void* act, const void* mu,
                                   const void* M, const void* a_s,
                                   const void* ws, void* x_out, void* qfrc_out,
                                   void* f_out, int B, int nv, int nefc,
                                   int ncon, int group, void* stream) {
  using namespace mrp::solver;
  if (B <= 0 || nv < 1 || nv > kMaxNv || nv > group || nefc < 1 || nefc > kMaxRows
      || ncon < 0 || ncon > nefc)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (group) {
    case 8: return launch<8>(meta, tol, J, aref, D, floss, act, mu, M, a_s, ws, x_out,
                             qfrc_out, f_out, B, nv, nefc, ncon, s);
    case 16: return launch<16>(meta, tol, J, aref, D, floss, act, mu, M, a_s, ws, x_out,
                               qfrc_out, f_out, B, nv, nefc, ncon, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
