// Runs the per-env bodies of K2 (csrc/solver.cuh: solve_env<G>, the group
// Newton body that K2 and K3 share), K3 (csrc/step_fused.cuh: step_env<G>)
// and K1 (csrc/linalg.cuh: the row body psd_rows_env<G, n> for n <= 16, the
// block body psd_block_env above) on the host, for
// tests/test_torch_csrc_host.py.
//
// Each block runs as one std::thread per thread, 32 to a simulated warp.
// __syncwarp(mask) is a barrier of the group of G lanes the mask names, and
// __shfl_xor_sync(mask, ...) goes through memory between two such
// barriers. Every mask is checked against the calling lane's own group: a
// sync or shuffle naming any other lanes (the whole warp, say) aborts, as
// would a group that leaves the Newton loop at another trip than its warp
// neighbours and then waited on them. K1's bodies name the whole warp
// (Group::whole_warp, kFullMask), so in chol mode every mask must be the
// whole warp's and the barrier is the warp's: a lane that left early would
// hang it. __syncthreads() is a barrier of the block's threads. Shared
// memory starts as NaN; cp.async copies are plain copies.
//
//   csrc_host_harness solve IN OUT    problem in IN, (x, qfrc, f) to OUT
//   csrc_host_harness step IN OUT     states in IN, (qpos', qvel', x) to OUT
//   csrc_host_harness chol IN OUT     SPD systems in IN, x to OUT
//   csrc_host_harness layout NV NEFC NCON    prints env_layout(...).total
//
// solve's IN holds int32 B, nv, nefc, ncon, G, nmeta, then meta (int32),
// tol (float32), J, aref, D, floss (float32), act (uint8), mu, M, a_s, ws
// (float32), each C-contiguous in the shapes newton_solve_launch takes.
// step's IN holds int32 B, nefc, ncon, G, nmeta, nparams, then meta (int32),
// params, qpos, qvel, ws (float32), as step_fused_launch takes them.
// chol's IN holds int32 B, n, G, then H (B, n, n) and g (B, n) (float32), as
// psd_solve_launch takes them: G = 8 or 16 lanes per env for the row body,
// 128 threads per env for the block body.

#include <barrier>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <memory>
#include <string>
#include <thread>
#include <vector>

#define __device__
#define __host__
#define __forceinline__ inline

static inline float rsqrtf(float x) { return 1.0f / std::sqrt(x); }
[[noreturn]] static inline void __trap() { std::abort(); }
static inline int min(int a, int b) { return a < b ? a : b; }
static inline int max(int a, int b) { return a > b ? a : b; }

namespace {

struct WarpSim {
  int G = 32;
  bool whole = false;             // masks name the whole warp (chol mode)
  float slot[32] = {};
  double dslot[32] = {};
  std::vector<std::unique_ptr<std::barrier<>>> groups;   // one per group
  std::barrier<> warp{32};
};

thread_local WarpSim* tl_warp = nullptr;
thread_local int tl_lane = 0;
thread_local std::barrier<>* tl_block = nullptr;

std::barrier<>& group_barrier(unsigned mask) {
  const int G = tl_warp->G;
  const int first = tl_lane - tl_lane % G;
  const unsigned own =
      G == 32 || tl_warp->whole ? 0xffffffffu : ((1u << G) - 1u) << first;
  if (mask != own) {
    std::fprintf(stderr, "lane %d (G = %d) synced on mask %08x, expected %08x\n",
                 tl_lane, G, mask, own);
    std::abort();
  }
  return tl_warp->whole ? tl_warp->warp : *tl_warp->groups[tl_lane / G];
}

}  // namespace

void __syncwarp(unsigned mask) { group_barrier(mask).arrive_and_wait(); }

void __syncthreads() { tl_block->arrive_and_wait(); }

float __shfl_xor_sync(unsigned mask, float v, int off) {
  std::barrier<>& b = group_barrier(mask);
  tl_warp->slot[tl_lane] = v;
  b.arrive_and_wait();
  const float r = tl_warp->slot[tl_lane ^ off];
  b.arrive_and_wait();
  return r;
}

double __shfl_xor_sync(unsigned mask, double v, int off) {
  std::barrier<>& b = group_barrier(mask);
  tl_warp->dslot[tl_lane] = v;
  b.arrive_and_wait();
  const double r = tl_warp->dslot[tl_lane ^ off];
  b.arrive_and_wait();
  return r;
}

float __shfl_sync(unsigned mask, float v, int src, int width) {
  std::barrier<>& b = group_barrier(mask);
  tl_warp->slot[tl_lane] = v;
  b.arrive_and_wait();
  const float r = tl_warp->slot[(tl_lane & ~(width - 1)) + src];
  b.arrive_and_wait();
  return r;
}

#include "linalg.cuh"
#include "solver.cuh"
#include "step_fused.cuh"

static_assert(mrp::kRowsThreads == mrp::solver::kThreads, "run_blocks runs kThreads");

namespace {

template <class T>
std::vector<T> take(FILE* f, size_t n) {
  std::vector<T> v(n);
  if (n && std::fread(v.data(), sizeof(T), n, f) != n) {
    std::fprintf(stderr, "short input\n");
    std::exit(2);
  }
  return v;
}

// Runs body(shared, block, thread) for every thread of `blocks` blocks of
// `threads` threads, one block at a time, each with `smem` floats of shared
// memory (NaN at the start); `whole`: the masks name the whole warp.
template <int G, class Body>
void run_blocks(int blocks, size_t smem, Body body, bool whole = false,
                int threads = mrp::solver::kThreads) {
  for (int blk = 0; blk < blocks; ++blk) {
    std::vector<float> shared(smem, NAN);
    std::vector<WarpSim> warps(threads / 32);
    std::barrier<> block(threads);
    for (WarpSim& w : warps) {
      w.G = G;
      w.whole = whole;
      for (int k = 0; k < 32 / G; ++k) w.groups.push_back(std::make_unique<std::barrier<>>(G));
    }
    std::vector<std::thread> pool;
    for (int t = 0; t < threads; ++t) {
      pool.emplace_back([&, t] {
        tl_warp = &warps[t / 32];
        tl_lane = t % 32;
        tl_block = &block;
        body(shared.data(), blk, t);
      });
    }
    for (std::thread& th : pool) th.join();
  }
}

template <int G>
void solve(FILE* in, FILE* out, const std::vector<int>& head) {
  using mrp::solver::env_layout;
  const int B = head[0], nv = head[1], nefc = head[2], ncon = head[3];
  if (nv > G) std::exit(2);        // as newton_solve_launch: nv <= G
  const size_t nc = ncon > 0 ? ncon : 1;
  const std::vector<int> meta = take<int>(in, head[5]);
  const float tol = take<float>(in, 1)[0];
  const std::vector<float> J = take<float>(in, (size_t)B * nefc * nv);
  const std::vector<float> aref = take<float>(in, (size_t)B * nefc);
  const std::vector<float> D = take<float>(in, (size_t)B * nefc);
  const std::vector<float> floss = take<float>(in, (size_t)B * nefc);
  const std::vector<unsigned char> act = take<unsigned char>(in, (size_t)B * nefc);
  const std::vector<float> mu = take<float>(in, (size_t)B * nc * 5);
  const std::vector<float> M = take<float>(in, (size_t)B * nv * nv);
  const std::vector<float> a_s = take<float>(in, (size_t)B * nv);
  const std::vector<float> ws = take<float>(in, (size_t)B * nv);
  std::vector<float> x((size_t)B * nv, NAN), qfrc((size_t)B * nv, NAN),
      f((size_t)B * nefc, NAN);
  const int per_block = mrp::solver::kThreads / G;
  run_blocks<G>((B + per_block - 1) / per_block,
                (size_t)per_block * env_layout(nv, nefc, ncon).total,
                [&](float* smem, int blk, int t) {
                  mrp::solver::solve_env<G>(smem, blk, t, meta.data(), &tol, J.data(),
                                            aref.data(), D.data(), floss.data(),
                                            act.data(), mu.data(), M.data(), a_s.data(),
                                            ws.data(), x.data(), qfrc.data(), f.data(),
                                            B, nv, nefc, ncon);
                });
  for (const std::vector<float>* v : {&x, &qfrc, &f})
    std::fwrite(v->data(), sizeof(float), v->size(), out);
}

template <int G>
void step(FILE* in, FILE* out, const std::vector<int>& head) {
  using mrp::solver::env_layout;
  const int B = head[0], nefc = head[1], ncon = head[2];
  const std::vector<int> meta = take<int>(in, head[4]);
  const std::vector<float> params = take<float>(in, head[5]);
  const std::vector<float> qpos = take<float>(in, (size_t)B * 7);
  const std::vector<float> qvel = take<float>(in, (size_t)B * 6);
  const std::vector<float> ws = take<float>(in, (size_t)B * 6);
  std::vector<float> qpos_out((size_t)B * 7, NAN), qvel_out((size_t)B * 6, NAN),
      x((size_t)B * 6, NAN);
  const int per_block = mrp::solver::kThreads / G;
  run_blocks<G>((B + per_block - 1) / per_block,
                (size_t)per_block * env_layout(6, nefc, ncon).total,
                [&](float* smem, int blk, int t) {
                  mrp::step_env<G>(smem, blk, t, meta.data(), params.data(), qpos.data(),
                                   qvel.data(), ws.data(), qpos_out.data(),
                                   qvel_out.data(), x.data(), B, nefc, ncon);
                });
  for (const std::vector<float>* v : {&qpos_out, &qvel_out, &x})
    std::fwrite(v->data(), sizeof(float), v->size(), out);
}

// K1's row body at G lanes for the n at hand (n <= G), as psd_solve_launch.
template <int G, int N = G>
void chol(FILE* in, FILE* out, const std::vector<int>& head) {
  const int B = head[0], n = head[1];
  if constexpr (N >= 1) {
    if (n != N) return chol<G, N - 1>(in, out, head);
    const std::vector<float> H = take<float>(in, (size_t)B * n * n);
    const std::vector<float> g = take<float>(in, (size_t)B * n);
    std::vector<float> x((size_t)B * n, NAN);
    const int per_block = mrp::kRowsThreads / G;
    run_blocks<G>((B + per_block - 1) / per_block, 0, [&](float*, int blk, int t) {
      mrp::psd_rows_env<G, N>(blk, t, H.data(), g.data(), x.data(), B);
    }, true);
    std::fwrite(x.data(), sizeof(float), x.size(), out);
  } else {
    std::exit(2);
  }
}

// K1's block body, one block per env, as psd_solve_launch (the 16-byte
// copies where n % 4 == 0).
void chol_block(FILE* in, FILE* out, const std::vector<int>& head) {
  const int B = head[0], n = head[1];
  const std::vector<float> H = take<float>(in, (size_t)B * n * n);
  const std::vector<float> g = take<float>(in, (size_t)B * n);
  std::vector<float> x((size_t)B * n, NAN);
  run_blocks<32>(B, mrp::block_layout(n).total, [&](float* smem, int blk, int t) {
    mrp::psd_block_env(smem, blk, t, H.data(), g.data(), x.data(), n, n % 4 == 0);
  }, true, mrp::kBlockThreads);
  std::fwrite(x.data(), sizeof(float), x.size(), out);
}

}  // namespace

int main(int argc, char** argv) {
  using mrp::solver::env_layout;
  const std::string mode = argc > 1 ? argv[1] : "";
  if (argc == 5 && mode == "layout") {
    std::printf("%d\n", env_layout(std::atoi(argv[2]), std::atoi(argv[3]),
                                   std::atoi(argv[4])).total);
    return 0;
  }
  if (argc != 4 || (mode != "solve" && mode != "step" && mode != "chol")) {
    std::fprintf(stderr, "usage: %s solve|step|chol IN OUT | layout NV NEFC NCON\n",
                 argv[0]);
    return 2;
  }
  FILE* in = std::fopen(argv[2], "rb");
  FILE* out = std::fopen(argv[3], "wb");
  if (!in || !out) return 2;
  const std::vector<int> head = take<int>(in, mode == "chol" ? 3 : 6);
  const int G = head[mode == "solve" ? 4 : mode == "step" ? 3 : 2];
  if (mode == "chol" && G == mrp::kBlockThreads) {
    chol_block(in, out, head);
  } else if (G != 8 && G != 16) {
    return 2;                                 // the widths the kernels take
  } else if (mode == "solve") {
    G == 8 ? solve<8>(in, out, head) : solve<16>(in, out, head);
  } else if (mode == "step") {
    G == 8 ? step<8>(in, out, head) : step<16>(in, out, head);
  } else {
    G == 8 ? chol<8>(in, out, head) : chol<16>(in, out, head);
  }
  std::fclose(in);
  std::fclose(out);
  return 0;
}
