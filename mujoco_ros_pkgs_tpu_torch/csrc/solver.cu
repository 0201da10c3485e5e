// The whole Newton constraint solve of a batch (K2), one warp per env.
//
// Replaces mujoco_ros_pkgs_tpu/ops/solver_tpu.py::solve_batched (its Pallas
// body `_make_kernel` over `newton_tiles`): warmstart, Newton trips with the
// Cholesky of H = M + J^T W J, grid line search and polish, per-env stop;
// then qfrc = J^T f and the row forces. The port calls it through
// ops/solver_tpu.solve_batched from ops/solver.solve, once per general step;
// its plain-torch twin is solver_tpu.newton_tiles. The per-env routine is in
// csrc/solver.cuh.
//
// Unlike the TPU kernel, which the JAX package traces anew for every row
// layout, this is one kernel for every system with nv <= 16 and at most 64
// rows: the layout (row codes 'eq' / 'fri' / one-sided / cone, the contacts'
// first rows and condims, niter, nls, warmstart) arrives at run time as the
// int32 vector of ops/solver_tpu.py::kernel_meta, in device memory.
//
// Design: the TPU kernel keeps one env per lane of a (8, 128) tile and
// unrolls every dof and row. One thread per env, as the fused step kernel
// (step_fused.cu) does at nv = 6, would here hold a 64 x 16 Jacobian (4 KB)
// and the 16 x 16 Hessian per thread in local memory, and a batch of 4096
// envs would fill one warp per SM. So each env is one warp, and its rows,
// J, W J, M, H and vectors live in shared memory (env_layout: 6.4 KB at the
// general path's nv = 11 and 33 rows, 16.6 KB at the maxima); four envs per
// block. The Newton trips stay sequential per env, and the lanes share the
// rows, the cones, the dofs and the entries of H.
//
// Cost: each env reads J, M and its row vectors once (about 2 KB at nv 11,
// 33 rows) and writes 2 nv + nefc floats, and does per Newton trip about
// nefc nv^2 multiply-adds for H plus the line search's 15 passes over the
// rows, so at 4096 envs the bound is the operations of the trips these
// inputs need, far below what a sequential chain of warp barriers per trip
// reaches.

#include <cuda_runtime.h>

#include "solver.cuh"

namespace mrp {
namespace solver {

constexpr int kWarps = 4;   // envs per block

__global__ void newton_solve_kernel(
    const int* __restrict__ meta, const float* __restrict__ tol_p,
    const float* __restrict__ J, const float* __restrict__ aref,
    const float* __restrict__ D, const float* __restrict__ floss,
    const unsigned char* __restrict__ act, const float* __restrict__ mu,
    const float* __restrict__ M, const float* __restrict__ a_s,
    const float* __restrict__ ws, float* __restrict__ x_out,
    float* __restrict__ qfrc_out, float* __restrict__ f_out, int B, int nv,
    int nefc, int ncon) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x / kLanes, lane = threadIdx.x % kLanes;
  const int env = blockIdx.x * kWarps + warp;
  if (env >= B) return;            // the whole warp leaves together
  const EnvLayout L = env_layout(nv, nefc, ncon);
  const Env e = make_env(smem + warp * L.total, meta, nv, nefc, ncon);
  const size_t er = (size_t)env * nefc;
  const int nmu = 5 * (ncon > 0 ? ncon : 1);
  for (int i = lane; i < nefc * nv; i += kLanes) e.J[i] = J[er * nv + i];
  for (int i = lane; i < nv * nv; i += kLanes) e.M[i] = M[(size_t)env * nv * nv + i];
  for (int r = lane; r < nefc; r += kLanes) {
    e.aref[r] = aref[er + r];
    e.D[r] = D[er + r];
    e.floss[r] = floss[er + r];
    e.act[r] = act[er + r] ? 1.0f : 0.0f;
    e.code[r] = meta[M_LEN + r];
    e.base[r] = r;
    e.dim[r] = 1;
  }
  for (int i = lane; i < nmu; i += kLanes) e.mu[i] = mu[(size_t)env * nmu + i];
  for (int v = lane; v < nv; v += kLanes) {
    e.a_s[v] = a_s[(size_t)env * nv + v];
    e.ws[v] = ws[(size_t)env * nv + v];
  }
  __syncwarp();
  // each cone row learns its contact's first row and condim
  for (int c = lane; c < ncon; c += kLanes) {
    const int b = e.contacts[2 * c], dim = e.contacts[2 * c + 1];
    for (int k = 0; k < dim; ++k) {
      e.base[b + k] = b;
      e.dim[b + k] = dim;
    }
  }
  __syncwarp();

  newton_env(e, meta[M_NITER], meta[M_NLS], meta[M_WARMSTART] != 0, tol_p[0], lane);

  for (int r = lane; r < nefc; r += kLanes) f_out[er + r] = e.f[r];
  for (int v = lane; v < nv; v += kLanes) {
    x_out[(size_t)env * nv + v] = e.x[v];
    float s = e.J[v] * e.f[0];
    for (int r = 1; r < nefc; ++r) s = s + e.J[r * nv + v] * e.f[r];
    qfrc_out[(size_t)env * nv + v] = s;
  }
}

}  // namespace solver
}  // namespace mrp

// Plain C entry point (bound with ctypes). meta: int32 from kernel_meta; tol:
// one float32; J (B, nefc, nv), aref / D / floss (B, nefc) float32, act
// (B, nefc) bool, mu (B, max(ncon, 1), 5), M (B, nv, nv), a_s / ws (B, nv);
// outputs x, qfrc (B, nv) and f (B, nefc). All contiguous, on the device.
// Launches on `stream` and returns cudaGetLastError() as an int (0 =
// launched).
extern "C" int newton_solve_launch(const void* meta, const void* tol,
                                   const void* J, const void* aref,
                                   const void* D, const void* floss,
                                   const void* act, const void* mu,
                                   const void* M, const void* a_s,
                                   const void* ws, void* x_out, void* qfrc_out,
                                   void* f_out, int B, int nv, int nefc,
                                   int ncon, void* stream) {
  using namespace mrp::solver;
  if (B <= 0 || nv < 1 || nv > kMaxNv || nefc < 1 || nefc > kMaxRows || ncon < 0
      || ncon > nefc)
    return (int)cudaErrorInvalidValue;
  const size_t smem =
      (size_t)kWarps * env_layout(nv, nefc, ncon).total * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        newton_solve_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int blocks = (B + kWarps - 1) / kWarps;
  newton_solve_kernel<<<blocks, kWarps * mrp::kLanes, smem, (cudaStream_t)stream>>>(
      (const int*)meta, (const float*)tol, (const float*)J, (const float*)aref,
      (const float*)D, (const float*)floss, (const unsigned char*)act,
      (const float*)mu, (const float*)M, (const float*)a_s, (const float*)ws,
      (float*)x_out, (float*)qfrc_out, (float*)f_out, B, nv, nefc, ncon);
  return (int)cudaGetLastError();
}
