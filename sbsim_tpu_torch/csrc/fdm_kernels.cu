// FDM convergence loops for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of sbsim_tpu/physics/fdm_pallas.py with
// two device bodies that share one toolkit (run ownership, staging, the
// swap rounds, the output and the statistics):
//   fdm_cheby_body<E, STAGED> <- K1 (E = 1): _fdm_cheby_kernel_interleaved
//                        (:630) and its one-env form _fdm_cheby_kernel
//                        (:279); K4 (E = 1..4): _fdm_cheby_kernel_block
//                        (:505). Chebyshev semi-iteration of the Jacobi
//                        map, residual sampled every `check_every`
//                        sub-iterations, then J(x), the decision words and
//                        the swap rounds.
//   fdm_jacobi_body<E, STAGED, RULE> <- K2 (E = 1, kSolo): _fdm_kernel
//                        (:207), Jacobi while it < limit and max|dx| >
//                        threshold; K3 (E = 1..4, kBlock): _fdm_kernel_block
//                        (:416), the stack layout with per-env freezing.
//                        Then the same convection epilogue.
//   fdm_cheby_cluster_body, fdm_jacobi_cluster_body<RULE> <- the same
//                        semantics (K1/K4 at E = 1; K2, K3 at E = 1) on a
//                        plan above one block's shared memory: one
//                        thread-block cluster per env, the iterate pair in
//                        global memory (see "Plans above one block's shared
//                        memory" below).
// The decision word of the swap rounds is the mix32 hash of the env's key,
// made in the kernel, or, when the wrapper passes a (B, H, W) word plane
// (the threefry words), read from that plane (_kernel_conv_word, :192).
// Statistics epilogue (replaces _kernel_grid_stats, :137, which the solo
// bodies reach at :273 and :372 and the block bodies through
// _block_write_stats, :404): with a stat layout, the kernel also folds
// the final field while it is still in shared memory -- each zone's
// (hc, wc) window times its mask, then the whole grid -- in the
// halve-with-leftover order of physics/gridstats.py (columns first, then
// rows, odd leftovers added last), and writes (B, Z) zone sums and (B,)
// grid sums, bitwise the fold's.
//
// Bound: a step must read temp, const and denom and write the output, one
// (H, W) float plane each per env (the stencil planes and the two
// convection word planes are shared by the batch and stay in L2): at the
// sb1 shapes 4 x 13,936 B x 2048 envs (12 zones, 34 us at 3.35 TB/s) or
// 4 x 93,744 B x 512 envs (126 rooms, 57 us). The arithmetic of the ~9
// Chebyshev sub-iterations (or ~20-35 Jacobi iterations) an env needs
// there is of the same order at the float32 peak (about 40 us and 70 us),
// so neither bound dominates. That peak (67 TFLOP/s) assumes fused
// multiply-adds; built with -fmad=false and IEEE division (a reciprocal,
// four FFMA and a check per divide) these kernels cannot reach it, and the
// bound is kept as it is so that it stays comparable.
//
// The epilogue adds Z * hc * wc multiplies and about as many adds per env
// (at 12 zones of 14 x 14, 2,352 each against ~3,484 x 12 flops of one
// Jacobi sweep) and writes B * (Z + 1) floats.
//
// Design. Measured on the H100 (PERF.md), what bounds both bodies is
// instruction issue, not bytes: the one-cell-per-thread sweeps of the
// first kernels spent 134-188 SASS instructions per cell update (a runtime
// c / W division, seven read-only-cache loads, edge selects) for ~25 of
// arithmetic, and their swap rounds (two more divisions and two mix32
// hashes per cell and round) took 29-49% of their time. The design takes
// out of the sweep everything that does not change in it:
//  - Each thread owns runs of kRun = 4 vertically consecutive cells; a
//    cursor steps from one owned run to the next by (T / W, T % W) with
//    one carry, so no sweep or swap round divides. The lanes of a warp own
//    neighbouring columns, so every shared-memory access is conflict-free
//    and every global one coalesced (row runs measured 4-way bank
//    conflicts), and a run's cells are each other's vertical neighbours;
//    the run's own values stay in registers for the residual.
//  - The exterior bits are one byte per run; the four stencil
//    coefficients of a cell are one 16-byte read of a packed plane, once
//    per run for all E envs of the block.
//  - const and denom are staged in shared memory (four planes per env:
//    E <= 4 at 52 x 67) by the bulk copy engine (cp.async.bulk, one thread,
//    an mbarrier), as is temp; at 189 x 124 four planes do not fit, so one
//    env per block reads them from global memory. The result leaves by a
//    bulk store; a plane whose start is not 16-byte aligned, or the tail
//    past a multiple of 16 bytes, is copied by the threads.
//  - The swap rounds first write each owned cell's decision bits for up
//    to 8 rounds into a byte plane (one mix32 hash per cell and word plane,
//    or one read of the threefry word), then every round reads bytes.
//  - Instances of both bodies: STAGED E = 1-2 (<= 512 threads, 2 blocks
//    per SM: at 3, E = 1 spilled at 40 registers and ran 12% (Chebyshev)
//    and 8% (Jacobi) slower), E = 3-4 (<= 1024, 1 per SM); one env reading
//    from global memory (<= 1024, 1 per SM; at 52 x 67 the Jacobi body ran
//    35% slower so). The launcher spreads the runs evenly over the fewest
//    passes.
//  - Jacobi samples its stopping rule every iteration (its count and flag
//    are exact per iteration), so every iteration ends in a reduction; it
//    takes one barrier. Each warp writes its per-env maxima into a
//    double-buffered scratch red[it & 1], the block meets once, and every
//    warp then reduces the partials itself (one shuffle max), so every
//    thread holds each env's maximum. That barrier also orders this
//    iteration's writes of the partner plane before the next iteration's
//    reads. A warp can overwrite a parity slot only after every warp has
//    passed the next barrier, and every warp reads the slot before it gets
//    there. (The Chebyshev body samples once per chunk and keeps the
//    two-barrier block_max_envs.)
// Tensor cores do not apply: a cell update is four products and a divide,
// and TF32 or bf16 would break the bitwise equality with the plain
// version.
//
// Numerics: built with -fmad=false and IEEE division, every cell update is
// the plain PyTorch version's sequence of float32 operations
// (physics/fdm_cuda.py: fdm_jacobi_plain / fdm_cheby_plain and their block
// forms), so the kernels equal them bitwise: a_r*x_r + a_l*x_l + a_b*x_b +
// a_t*x_t + const, then / denom; the Chebyshev update
// omega*(jx - x_prev) + x_prev, then the exterior re-pin.
//
// E envs per thread block (K3, K4; K1 and K2 are E = 1). Each env has its
// iterate and its partner plane (and, staged, const and denom) in dynamic
// shared memory for the whole solve, so global memory is read once and
// written once per env. Per run a thread reads the shared stencil once and
// applies it to every active env of the block. The loop runs while
// it < limit and any env of the block is active; an env that has met its
// stopping rule is frozen (skipped, its planes no longer swapped: a
// per-env parity bit says which slot holds its iterate), which equals the
// JAX select. Chebyshev samples the freeze only at the end of a chunk of
// `check_every` sub-iterations, and omega is one schedule for the block
// (all envs start at it = 1). Slots past B are inactive from the start.
// So each env's result equals K1's for that env whatever E, and K3's
// equals K2's unless a residual is NaN. Jacobi has two stopping rules
// (the plain versions are the spec): kSolo (K2) loops while it < limit and
// delta > threshold, so a NaN stops the env at once; kBlock (K3) freezes
// an env once its residual is <= threshold, so a NaN env runs to the
// limit. K3 at E = 1 is therefore not K2. The epilogue runs env by env.

#ifdef FDM_HOST_REHEARSAL
// Host C++ build of the same source (tests/test_torch_kernel_host.py): the
// stub maps the CUDA built-ins onto host threads and the bulk copies onto
// memcpy.
#include "fdm_host_stub.h"
#else
#include <cuda_runtime.h>
#include <stdint.h>

#define FDM_DYNAMIC_SMEM(name) extern __shared__ __align__(16) float name[]
#define FDM_LAUNCH(kernel, grid, threads, smem, stream) \
  kernel<<<grid, threads, smem, stream>>>

namespace {

// Hopper's bulk copy engine (cp.async.bulk) between global and shared
// memory, completing on an mbarrier (loads) or a bulk group (stores).
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_addr(bar)));
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// An asynchronous copy of 4 bytes from global into shared memory
// (cp.async), which holds no register while in flight; wait_async waits for
// all of this thread's.
__device__ __forceinline__ void copy_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void wait_async() {
  asm volatile("cp.async.wait_all;" ::: "memory");
}

// Makes this thread's shared-memory writes visible to the bulk engine.
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// Stores and waits until the engine has read the shared source.
__device__ __forceinline__ void bulk_store(void* dst, const void* src,
                                           uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;" ::"l"(
                   dst),
               "r"(smem_addr(src)), "r"(bytes)
               : "memory");
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
  asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
}

// Thread block clusters: a CTA's rank in its cluster; the cluster barrier,
// whose release/acquire orders every memory access before it (global
// memory included) against every access after it, in all the cluster's
// CTAs; a store into another CTA's shared memory (distributed shared
// memory).
__device__ __forceinline__ unsigned cluster_rank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return r;
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n\t"
      "barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

__device__ __forceinline__ void cluster_store(float* local, unsigned rank, float v) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(remote)
               : "r"(smem_addr(local)), "r"(rank));
  asm volatile("st.shared::cluster.f32 [%0], %1;" ::"r"(remote), "f"(v) : "memory");
}

// Launches `kernel` on `grid` CTAs in clusters of `cluster`; returns a CUDA
// error code.
template <typename... Params, typename... Args>
int launch_cluster(void (*kernel)(Params...), int grid, int cluster, int threads,
                   size_t smem, cudaStream_t stream, Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, args...);
  return err ? (int)err : (int)cudaGetLastError();
}

}  // namespace
#endif

namespace {

constexpr int kMaxRounds = 32;

struct ConvArgs {
  int n_rounds;  // 0: no convection epilogue
  int lane_bits;
  int q;
  int dy[kMaxRounds];
  int dx[kMaxRounds];
};

struct Planes {
  const float* temp;   // (B, H, W)
  const float* cnst;   // (B, H, W)
  const float* denom;  // (B, H, W)
  const float* tinf;   // (B,)
  const float4* coef;  // (H, W) packed (a_r, a_l, a_b, a_t), shared
  const float* ext;    // (H, W) 1.0 at exterior CVs
  const uint32_t* lead;  // (H, W) packed lead masks
  const uint32_t* foll;  // (H, W) packed follower masks
  const int64_t* keys;   // (B, 2) uint32 values
  const uint32_t* words;  // (B, H, W) decision words, or null (mix32 keys)
  float* out;            // (B, H, W)
  int32_t* iters;        // (B,)
  int32_t* converged;    // (B,)
  int H, W;
  int edge_fill;
};

// Zone/grid statistics of the final field; n_zones == 0 disables them.
struct StatArgs {
  const float* masks;    // (Z, hc, wc) 1.0 on the zone's cells in its window
  const int32_t* row0;   // (Z,) window origins
  const int32_t* col0;   // (Z,)
  float* zone_sums;      // (B, Z)
  float* grid_sums;      // (B,)
  int n_zones, hc, wc;
};

// max that propagates NaN, as jnp.max / torch.amax do.
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a > b || a != a) ? a : b;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int off = 16; off > 0; off >>= 1) {
    v = nan_max(v, __shfl_xor_sync(0xffffffffu, v, off));
  }
  return v;
}

__device__ __forceinline__ uint32_t fmix32(uint32_t x) {
  x = (x ^ (x >> 16)) * 0x85EBCA6Bu;
  x = (x ^ (x >> 13)) * 0xC2B2AE35u;
  return x ^ (x >> 16);
}

// In-place halve-with-leftover fold (gridstats._fold_axis) of `rows`
// sequences of length n, block-wide: element e of sequence g lives at
// a[g * gs + e * es]. Each level adds the upper half onto the lower half;
// an odd level first moves its last element into the leftover sum, which
// lives in the slot of the first odd level's last element (no later level
// touches it) and is added to element 0 at the end. Every add pairs the
// same two values as the plain version's, so the sums are bitwise equal.
// The caller synchronises before; the fold synchronises after itself.
__device__ void fold_rows(float* a, int rows, int n, int gs, int es) {
  int acc = -1;
  while (n > 1) {
    if (n & 1) {
      if (acc < 0) {
        acc = n - 1;
      } else {
        for (int g = threadIdx.x; g < rows; g += blockDim.x) {
          a[g * gs + acc * es] += a[g * gs + (n - 1) * es];
        }
      }
      --n;
    }
    const int half = n >> 1;
    for (int t = threadIdx.x; t < rows * half; t += blockDim.x) {
      const int g = t / half, j = t - g * half;
      a[g * gs + j * es] += a[g * gs + (j + half) * es];
    }
    __syncthreads();
    n = half;
  }
  if (acc >= 0) {
    for (int g = threadIdx.x; g < rows; g += blockDim.x) {
      a[g * gs] += a[g * gs + acc * es];
    }
    __syncthreads();
  }
}

// Zone sums from `field` (left intact) with `scratch` as the windows'
// workspace, as many zones at a time as fit in one plane; then the grid sum
// folded in place in `field`.
__device__ void grid_stats(float* field, float* scratch, const Planes& p,
                           const StatArgs& st, int b) {
  const int W = p.W, hw = p.H * p.W;
  const int win = st.hc * st.wc;
  const int group = max(1, min(st.n_zones, hw / win));
  for (int z0 = 0; z0 < st.n_zones; z0 += group) {
    const int g = min(group, st.n_zones - z0);
    for (int t = threadIdx.x; t < g * win; t += blockDim.x) {
      const int zi = t / win, e = t - zi * win;
      const int z = z0 + zi;
      const int r = e / st.wc, c = e - r * st.wc;
      const int cell = (__ldg(st.row0 + z) + r) * W + __ldg(st.col0 + z) + c;
      scratch[t] = field[cell] * __ldg(st.masks + (size_t)z * win + e);
    }
    __syncthreads();
    fold_rows(scratch, g * st.hc, st.wc, st.wc, 1);  // columns
    fold_rows(scratch, g, st.hc, win, st.wc);        // then rows
    for (int zi = threadIdx.x; zi < g; zi += blockDim.x) {
      st.zone_sums[(size_t)b * st.n_zones + z0 + zi] = scratch[zi * win];
    }
    __syncthreads();
  }
  fold_rows(field, p.H, W, W, 1);
  fold_rows(field, 1, p.H, 0, W);
  if (threadIdx.x == 0) st.grid_sums[b] = field[0];
}

constexpr int kSmemPerBlock = 232448;
constexpr int kRun = 4;        // cells a thread owns per run down a column
constexpr int kMaxEnvs = 4;    // envs per block with const/denom staged
// Shared memory the launcher leaves for a body's static scratch (red and
// the mbarrier: at most 1,032 B, the Jacobi body's red[2][4][32]).
constexpr int kStaticSmem = 2048;

// Block-wide max of each active env's m[e] (bit e of `envs`), for all of
// them in one pass: every warp reduces each env in registers, then warp w
// reduces the per-warp maxima of envs w, w + n_warps, ... Two barriers, so
// it also orders the shared-memory writes before it against reads after.
// (The Chebyshev body's reduction, once per chunk.)
template <int E>
__device__ __forceinline__ void block_max_envs(float (&m)[E],
                                               float (*red)[33],
                                               unsigned envs) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = (blockDim.x + 31) >> 5;
#pragma unroll
  for (int e = 0; e < E; ++e) {
    if ((envs >> e) & 1u) {
      const float v = warp_max(m[e]);
      if (lane == 0) red[e][warp] = v;
    }
  }
  __syncthreads();
  for (int e = warp; e < E; e += n_warps) {
    if ((envs >> e) & 1u) {
      float w = lane < n_warps ? red[e][lane] : 0.0f;
      w = warp_max(w);
      if (lane == 0) red[e][32] = w;
    }
  }
  __syncthreads();
#pragma unroll
  for (int e = 0; e < E; ++e) {
    if ((envs >> e) & 1u) m[e] = red[e][32];
  }
}

// Threads per block (at most) and blocks per SM the compiler must allow
// for an instance of either body: E envs with const/denom in shared memory
// (staged), or one env reading them from global memory (a grid too large
// to stage). Two blocks of 512 threads leave 64 registers a thread; for
// the Jacobi body 3 blocks (40 registers) measured 8% slower and reading
// const/denom from global memory where they fit 35% slower (PERF.md).
template <int E, bool STAGED>
struct BodyShape {
  static constexpr int kThreads = STAGED && E <= 2 ? 512 : 1024;
  static constexpr int kMinBlocks = !STAGED ? 1 : E <= 2 ? 2 : 1;
};

// Run ownership: each column is cut into runs of kRun vertically
// consecutive cells (row blocks of kRun rows, the last one shorter when
// kRun does not divide H); runs are numbered row block by row block,
// column by column within one, and thread t owns runs t, t + T, ... (T
// threads). So the lanes of a warp own neighbouring columns: for each of a
// run's cells they read consecutive words of shared memory (no bank
// conflict) and of the shared stencil planes (coalesced), and a run's
// cells are each other's up/down neighbours. Stepping from one owned run
// to the next adds (step_b, step_x) = (T / W, T % W) with one carry, so no
// sweep divides.
struct RunGrid {
  int H, W, hw;
  int plane;  // floats between planes in shared memory (hw rounded to 4)
  int row_blocks, n_runs;
  int step_b, step_x;
  int edge_fill;
};

struct Cursor {
  int r, yb, x;
};

__device__ __forceinline__ Cursor first_run(const RunGrid& g) {
  Cursor q;
  q.r = threadIdx.x;
  q.yb = q.r / g.W;  // outside the cell loop
  q.x = q.r - q.yb * g.W;
  return q;
}

__device__ __forceinline__ void next_run(Cursor& q, const RunGrid& g) {
  q.r += blockDim.x;
  q.yb += g.step_b;
  q.x += g.step_x;
  if (q.x >= g.W) {
    q.x -= g.W;
    ++q.yb;
  }
}

// One run's cells and neighbours: c0 its first (top) cell, n its length,
// iu the cell above it and id the cell below its last cell, dl/dr the
// offsets of a cell's left/right neighbour; with a roll they wrap (reads
// that land only in exterior cells, whose coefficients are folded to
// a = 0, denom = 1, const = t_inf), with edge fill the f* flags say that
// neighbour is t_inf.
struct Run {
  int c0, n, y0, iu, id, dl, dr;
  bool fl, fr, fu, fd;
};

__device__ __forceinline__ Run make_run(const Cursor& q, const RunGrid& g) {
  Run u;
  const bool edge = g.edge_fill != 0;
  u.y0 = q.yb * kRun;
  u.n = min(kRun, g.H - u.y0);
  u.c0 = u.y0 * g.W + q.x;
  const int ye = u.y0 + u.n;
  u.iu = u.y0 > 0 ? u.c0 - g.W : (g.H - 1) * g.W + q.x;
  u.id = ye < g.H ? u.c0 + u.n * g.W : q.x;
  u.dl = q.x > 0 ? -1 : g.W - 1;
  u.dr = q.x + 1 < g.W ? 1 : 1 - g.W;
  u.fl = edge && q.x == 0;
  u.fr = edge && q.x + 1 == g.W;
  u.fu = edge && u.y0 == 0;
  u.fd = edge && ye == g.H;
  return u;
}

// One pass of a body over one run, for every env of `envs`. Chebyshev:
// kFirst writes x1 = J(x0) (slot 1 from slot 0), kCheby writes x_next =
// omega (J(x) - x_prev) + x_prev over x_prev in place (exterior re-pinned),
// kFinal writes J(x_final) into the x_prev slot; bit e of `slots` says
// env e's x_prev is in its slot 1; kFirst and sampling kCheby passes fold
// |J(x) - x| into m. Jacobi: kJacobi writes J(x) from the iterate's slot
// (bit e of `slots`: slot 1) into the other and folds |J(x) - x| into m.
// Each cell update is the plain version's float32 sequence. The stencil
// of a cell is one 16-byte read of the packed (a_r, a_l, a_b, a_t) plane
// through the read-only cache, shared by the block's envs; a full run
// (FULL: kRun cells) needs no guards.
enum Pass { kFirst, kCheby, kFinal, kJacobi };

// One cell's update in pass PASS, shared by the block and the cluster
// bodies: the Jacobi value jx from the cell's neighbours (xr, xl, xb, xt)
// and its stencil k, const cn and denom dn (the tinf pin where `edge` and
// the cell is exterior), then for kCheby the recombination with x_prev
// (xp), pinned likewise. Folds |jx - x| (x the cell's iterate) into m
// where the pass samples. Returns the value the pass writes.
template <int PASS>
__device__ __forceinline__ float cell_update(float4 k, float xr, float xl, float xb, float xt,
                                             float cn, float dn, float tinf, bool pin,
                                             bool edge, float x, float xp, float omega_next,
                                             bool sample, float& m) {
  float num = k.x * xr;
  num = num + k.y * xl;
  num = num + k.z * xb;
  num = num + k.w * xt;
  num = num + cn;
  const float v = num / dn;
  const float jx = edge && pin ? tinf : v;
  if (PASS == kCheby) {
    float nx = omega_next * (jx - xp) + xp;
    if (pin) nx = tinf;
    if (sample) m = nan_max(m, fabsf(jx - x));
    return nx;
  }
  if (PASS == kFirst || PASS == kJacobi) m = nan_max(m, fabsf(jx - x));
  return jx;
}

template <int E, bool STAGED, int PASS, bool FULL>
__device__ __forceinline__ void run_pass(const Run& u, uint32_t ext,
                                         const Planes& p, const RunGrid& g,
                                         float* smem, const float* const* cn_g,
                                         const float* const* dn_g,
                                         const float (&tinf)[E], unsigned envs,
                                         unsigned slots, float omega_next,
                                         bool sample, float (&m)[E]) {
  constexpr int kPlanes = STAGED ? 4 : 2;
  const int n = FULL ? kRun : u.n;
  const int W = g.W;
  const size_t P = g.plane;
  const bool edge = g.edge_fill != 0;
  float4 k[kRun];
#pragma unroll
  for (int i = 0; i < kRun; ++i) {
    k[i] = i < n ? __ldg(p.coef + u.c0 + i * W) : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
#pragma unroll
  for (int e = 0; e < E; ++e) {
    if (!((envs >> e) & 1u)) continue;
    const int s = PASS == kFirst ? 0 : (slots >> e) & 1u;
    float* env = smem + (size_t)e * kPlanes * P;
    const float* x = env + (PASS == kFirst ? 0 : PASS == kJacobi ? s : 1 - s) * P;
    float* dst = env + (PASS == kFirst ? 1 : PASS == kJacobi ? 1 - s : s) * P;
    float xv[kRun];
#pragma unroll
    for (int i = 0; i < kRun; ++i) xv[i] = i < n ? x[u.c0 + i * W] : 0.0f;
    const float top = u.fu ? tinf[e] : x[u.iu];
    const float bottom = u.fd ? tinf[e] : x[u.id];
#pragma unroll
    for (int i = 0; i < kRun; ++i) {
      if (i >= n) continue;
      const int c = u.c0 + i * W;
      const float xl = u.fl ? tinf[e] : x[c + u.dl];
      const float xr = u.fr ? tinf[e] : x[c + u.dr];
      const float xt = i == 0 ? top : xv[i > 0 ? i - 1 : 0];
      const float xb = i + 1 < n ? xv[i + 1 < kRun ? i + 1 : i] : bottom;
      const float cn = STAGED ? env[2 * P + c] : __ldg(cn_g[e] + c);
      const float dn = STAGED ? env[3 * P + c] : __ldg(dn_g[e] + c);
      // kCheby: x_next overwrites x_prev in place; cell c reads only x_prev[c].
      const float xp = PASS == kCheby ? dst[c] : 0.0f;
      dst[c] = cell_update<PASS>(k[i], xr, xl, xb, xt, cn, dn, tinf[e], (ext >> i) & 1u, edge,
                                 xv[i], xp, omega_next, sample, m[e]);
    }
  }
}

// One pass over all of a thread's runs, from its first run q0.
template <int E, bool STAGED, int PASS>
__device__ __forceinline__ void sweep(const Cursor& q0, const Planes& p,
                                      const RunGrid& g, float* smem,
                                      const uint8_t* ext_bits,
                                      const float* const* cn_g,
                                      const float* const* dn_g,
                                      const float (&tinf)[E], unsigned envs,
                                      unsigned slots, float omega_next,
                                      bool sample, float (&m)[E]) {
  for (Cursor q = q0; q.r < g.n_runs; next_run(q, g)) {
    const Run u = make_run(q, g);
    const uint32_t ext = ext_bits[q.r];
    if (u.n == kRun) {
      run_pass<E, STAGED, PASS, true>(u, ext, p, g, smem, cn_g, dn_g, tinf, envs,
                                      slots, omega_next, sample, m);
    } else {
      run_pass<E, STAGED, PASS, false>(u, ext, p, g, smem, cn_g, dn_g, tinf, envs,
                                       slots, omega_next, sample, m);
    }
  }
}

// The leading floats of an n-float global array that the bulk engine
// copies: a multiple of 4 floats from a 16-byte-aligned start, else none
// (the block's threads copy the rest).
__device__ __forceinline__ int bulk_floats(const float* g, int n) {
  return ((uintptr_t)g & 15) == 0 ? (n & ~3) : 0;
}

// Copies n floats from global src to shared dst: thread 0 hands the bulk
// part to the engine (completing on `bar`, whose expected bytes it has
// set), the block's threads copy the rest.
__device__ __forceinline__ void stage_in(float* dst, const float* src, int n,
                                         uint64_t* bar) {
  const int body = bulk_floats(src, n);
  if (body > 0 && threadIdx.x == 0) bulk_load(dst, src, (uint32_t)body * 4u, bar);
  for (int c = body + threadIdx.x; c < n; c += blockDim.x) dst[c] = src[c];
}

// Writes n floats of shared src to global dst the same way; every thread
// has fenced its shared writes and the block has met at a barrier.
__device__ __forceinline__ void stage_out(float* dst, const float* src, int n) {
  const int body = bulk_floats(dst, n);
  if (body > 0 && threadIdx.x == 0) bulk_store(dst, src, (uint32_t)body * 4u);
  for (int c = body + threadIdx.x; c < n; c += blockDim.x) dst[c] = src[c];
}

// Shared memory of a body's block, per env e: its two iterate planes, then
// (STAGED) its const and denom planes; after all envs the run exterior
// bytes, then (not STAGED) the decision byte plane, which with STAGED
// lives in env 0's const plane (free once the solve is done).
//
// The prologue: stages temp (and const, denom) of each env into slot 0
// (and planes 2, 3) while the threads pack their runs' exterior bits;
// returns once the block has met with everything in place.
template <int E, bool STAGED>
__device__ __forceinline__ void stage_envs(const Planes& p, const RunGrid& g,
                                           float* smem, uint8_t* ext_bits,
                                           int b0, int n_env, uint64_t* bar) {
  constexpr int kPlanes = STAGED ? 4 : 2;
  const int hw = g.hw;
  const size_t P = g.plane;
  if (threadIdx.x == 0) {
    mbar_init(bar);
    uint32_t tx = 0;
    for (int e = 0; e < n_env; ++e) {
      const size_t off = (size_t)(b0 + e) * hw;
      tx += 4u * bulk_floats(p.temp + off, hw);
      if (STAGED) {
        tx += 4u * bulk_floats(p.cnst + off, hw);
        tx += 4u * bulk_floats(p.denom + off, hw);
      }
    }
    mbar_expect_tx(bar, tx);
  }
  __syncthreads();
  for (int e = 0; e < n_env; ++e) {
    const size_t off = (size_t)(b0 + e) * hw;
    float* env = smem + (size_t)e * kPlanes * P;
    stage_in(env, p.temp + off, hw, bar);
    if (STAGED) {
      stage_in(env + 2 * P, p.cnst + off, hw, bar);
      stage_in(env + 3 * P, p.denom + off, hw, bar);
    }
  }
  for (Cursor q = first_run(g); q.r < g.n_runs; next_run(q, g)) {
    const Run u = make_run(q, g);
    uint32_t bits = 0;
    for (int i = 0; i < u.n; ++i) {
      if (__ldg(p.ext + u.c0 + i * g.W) > 0.0f) bits |= 1u << i;
    }
    ext_bits[q.r] = (uint8_t)bits;
  }
  mbar_wait(bar, 0);
  __syncthreads();
}

// The R swap rounds (_kernel_apply_swaps) on owned runs. Rounds go in
// groups of up to 8: first each thread writes its cells' decision bits for
// the group's rounds into the byte plane `dec` (one word read, or one
// mix32 hash per cell and plane), then each round reads them, a lead its
// own and a follower its lead's. Partners wrap by a conditional add
// (cv's offsets are normalised to [0, H) x [0, W)). Returns the plane that
// holds the result.
__device__ float* swap_runs(float* src, float* dst, uint8_t* dec,
                            const Planes& p, const ConvArgs& cv,
                            const RunGrid& g, uint32_t k0, uint32_t k1,
                            const uint32_t* wrd) {
  const int H = g.H, W = g.W;
  const int lanes = 32 / cv.lane_bits;
  const uint32_t lane_mask = (1u << cv.lane_bits) - 1u;
  int plane0 = 0, lane0 = 0;  // the (plane, lane) of the group's first round
  for (int g0 = 0; g0 < cv.n_rounds; g0 += 8) {
    const int ng = min(8, cv.n_rounds - g0);
    for (Cursor q = first_run(g); q.r < g.n_runs; next_run(q, g)) {
      const int y0 = q.yb * kRun;
      const int n = min(kRun, H - y0);
      for (int i = 0; i < n; ++i) {
        const uint32_t c = (uint32_t)((y0 + i) * W + q.x);
        uint32_t bits = 0;
        if (wrd != nullptr) {
          bits = (__ldg(wrd + c) >> g0) & 0xffu;
        } else {
          int pl = plane0, ln = lane0;
          uint32_t h = fmix32(fmix32((c + (uint32_t)pl * (uint32_t)g.hw) ^ k0) ^ k1);
          for (int jr = 0; jr < ng; ++jr) {
            if (((h >> (cv.lane_bits * ln)) & lane_mask) < (uint32_t)cv.q) {
              bits |= 1u << jr;
            }
            if (++ln == lanes && jr + 1 < ng) {
              ln = 0;
              ++pl;
              h = fmix32(fmix32((c + (uint32_t)pl * (uint32_t)g.hw) ^ k0) ^ k1);
            }
          }
        }
        dec[c] = (uint8_t)bits;
      }
    }
    __syncthreads();
    for (int jr = 0; jr < ng; ++jr) {
      const int r = g0 + jr;
      const uint32_t bit = 1u << r;
      const int dy = cv.dy[r], dx = cv.dx[r];
      for (Cursor q = first_run(g); q.r < g.n_runs; next_run(q, g)) {
        const int y0 = q.yb * kRun;
        const int n = min(kRun, H - y0);
        int xf = q.x + dx;  // the follower's column of a lead here
        if (xf >= W) xf -= W;
        int xl = q.x - dx;  // the lead's column of a follower here
        if (xl < 0) xl += W;
        int yf = y0 + dy;  // the follower's row of the run's first cell
        if (yf >= H) yf -= H;
        int yl = y0 - dy;  // the lead's row of a follower there
        if (yl < 0) yl += H;
        for (int i = 0; i < n; ++i) {
          const int c = (y0 + i) * W + q.x;
          float v = src[c];
          if ((__ldg(p.lead + c) & bit) && ((dec[c] >> jr) & 1u)) {
            v = src[yf * W + xf];
          }
          if (__ldg(p.foll + c) & bit) {
            const int lead_cell = yl * W + xl;
            if ((dec[lead_cell] >> jr) & 1u) v = src[lead_cell];
          }
          dst[c] = v;
          if (++yf == H) yf = 0;
          if (++yl == H) yl = 0;
        }
      }
      __syncthreads();
      float* t = src;
      src = dst;
      dst = t;
    }
    lane0 += 8;
    while (lane0 >= lanes) {
      lane0 -= lanes;
      ++plane0;
    }
  }
  return src;
}

// The epilogue: writes each env's count and flag, then, env by env, its
// final field (slot (field_slots >> e) & 1; the other slot is scratch)
// through the swap rounds, out by a bulk store, and into the statistics.
// Every thread's writes of the final fields precede a barrier.
template <int E, bool STAGED>
__device__ __forceinline__ void finish_envs(const Planes& p, const ConvArgs& cv,
                                            const StatArgs& st, const RunGrid& g,
                                            float* smem, uint8_t* dec, int b0,
                                            int n_env, unsigned field_slots,
                                            const int (&iters)[E], unsigned conv) {
  constexpr int kPlanes = STAGED ? 4 : 2;
  const int hw = g.hw;
  const size_t P = g.plane;
  if (threadIdx.x == 0) {
#pragma unroll
    for (int e = 0; e < E; ++e) {
      if (e < n_env) {
        p.iters[b0 + e] = iters[e];
        p.converged[b0 + e] = (conv >> e) & 1u;
      }
    }
  }
#pragma unroll 1
  for (int e = 0; e < n_env; ++e) {
    const int b = b0 + e;
    const int s = (field_slots >> e) & 1u;
    float* field = smem + (size_t)(e * kPlanes + s) * P;
    float* spare = smem + (size_t)(e * kPlanes + 1 - s) * P;
    if (cv.n_rounds > 0) {
      uint32_t k0 = 0, k1 = 0;
      const uint32_t* wrd = nullptr;
      if (p.words != nullptr) {
        wrd = p.words + (size_t)b * hw;
      } else {
        k0 = (uint32_t)p.keys[2 * b];
        k1 = (uint32_t)p.keys[2 * b + 1];
      }
      float* result = swap_runs(field, spare, dec, p, cv, g, k0, k1, wrd);
      if (result != field) spare = field;
      field = result;
    }
    fence_async_shared();
    __syncthreads();
    stage_out(p.out + (size_t)b * hw, field, hw);
    __syncthreads();  // the field is read out before the next env or the fold
    if (st.n_zones > 0) grid_stats(field, spare, p, st, b);
  }
}

// ---------------------------------------------------------------------------
// K1 and K4: one Chebyshev body, E envs per block (K1 is E = 1)
// ---------------------------------------------------------------------------

// K1 (E = 1) and K4: _fdm_cheby_kernel_interleaved / _fdm_cheby_kernel and
// _fdm_cheby_kernel_block. x0 = temp; x1 = J(x0); then chunks of
// `check_every` sub-iterations x_next = omega (J(x) - x_prev) + x_prev
// (exterior re-pinned), x_next written over x_prev in place, with one omega
// schedule for the block; an env's freeze state is fixed for a chunk and
// decided by its last sub-iteration's residual max|J(x) - x|. Then J(x_f),
// the swap rounds, the output and the statistics, env by env.
template <int E, bool STAGED>
__global__ void __launch_bounds__(BodyShape<E, STAGED>::kThreads,
                                  BodyShape<E, STAGED>::kMinBlocks)
    fdm_cheby_body(Planes p, ConvArgs cv, StatArgs st, RunGrid g,
                   float threshold, int limit, float rho2, float omega0,
                   int check_every, int B) {
  FDM_DYNAMIC_SMEM(smem);
  __shared__ float red[E][33];
  __shared__ uint64_t bar;  // 8-byte aligned, as mbarrier needs
  constexpr int kPlanes = STAGED ? 4 : 2;
  const int b0 = blockIdx.x * E;
  const int n_env = min(E, B - b0);
  const int hw = g.hw, P = g.plane;
  const unsigned valid = (1u << n_env) - 1u;
  uint8_t* ext_bits = (uint8_t*)(smem + (size_t)E * kPlanes * P);
  uint8_t* dec = STAGED ? (uint8_t*)(smem + 2 * (size_t)P)
                        : ext_bits + ((g.n_runs + 15) & ~15);
  float tinf[E];
#pragma unroll
  for (int e = 0; e < E; ++e) tinf[e] = e < n_env ? p.tinf[b0 + e] : 0.0f;
  stage_envs<E, STAGED>(p, g, smem, ext_bits, b0, n_env, &bar);

  const float* cn_g[E];
  const float* dn_g[E];
#pragma unroll
  for (int e = 0; e < E; ++e) {
    cn_g[e] = p.cnst + (size_t)(b0 + min(e, n_env - 1)) * hw;
    dn_g[e] = p.denom + (size_t)(b0 + min(e, n_env - 1)) * hw;
  }

  // x1 = J(x0) into slot 1, delta0 = max |x1 - x0|.
  float m[E];
#pragma unroll
  for (int e = 0; e < E; ++e) m[e] = 0.0f;
  sweep<E, STAGED, kFirst>(first_run(g), p, g, smem, ext_bits, cn_g, dn_g, tinf,
                           valid, 0, 0.0f, true, m);
  block_max_envs<E>(m, red, valid);
  unsigned done = 0;
#pragma unroll
  for (int e = 0; e < E; ++e) {
    if (((valid >> e) & 1u) && m[e] <= threshold) done |= 1u << e;
  }
  unsigned prev_slots = 0;  // bit e: env e's x_prev is in its slot 1
  int iters[E];
#pragma unroll
  for (int e = 0; e < E; ++e) iters[e] = 1;
  int it = 1;
  float omega = omega0;
  while (it < limit && (valid & ~done)) {
    const unsigned chunk = valid & ~done;
    for (int kk = 0; kk < check_every; ++kk) {
      const float omega_next = 1.0f / (1.0f - rho2 * omega / 4.0f);
      const bool sample = kk == check_every - 1;
#pragma unroll
      for (int e = 0; e < E; ++e) m[e] = 0.0f;
      sweep<E, STAGED, kCheby>(first_run(g), p, g, smem, ext_bits, cn_g, dn_g, tinf,
                               chunk, prev_slots, omega_next, sample, m);
      if (sample) {
        block_max_envs<E>(m, red, chunk);
      } else {
        __syncthreads();
      }
      prev_slots ^= chunk;
      ++it;
      omega = omega_next;
    }
#pragma unroll
    for (int e = 0; e < E; ++e) {
      if ((chunk >> e) & 1u) {
        iters[e] = it;
        if (m[e] <= threshold) done |= 1u << e;
      }
    }
  }
  // Emit J(x_final) into each env's x_prev slot.
  sweep<E, STAGED, kFinal>(first_run(g), p, g, smem, ext_bits, cn_g, dn_g, tinf,
                           valid, prev_slots, 0.0f, false, m);
  __syncthreads();
  finish_envs<E, STAGED>(p, cv, st, g, smem, dec, b0, n_env, prev_slots, iters, done);
}

// ---------------------------------------------------------------------------
// K2 and K3: one Jacobi body, E envs per block (K2 is E = 1, kSolo)
// ---------------------------------------------------------------------------

// The stopping rules of _fdm_kernel (kSolo: loop while it < limit and
// delta > threshold, so a NaN delta stops the env) and _fdm_kernel_block
// (kBlock: an env freezes once its residual is <= threshold, so a NaN env
// runs to the limit; the block loops while any env is active).
enum Rule { kSolo, kBlock };

// K2 (E = 1, kSolo) and K3 (kBlock): x_{it+1} = J(x_it) from the iterate's
// slot into the other, the residual max|x_{it+1} - x_it| of every active
// env reduced after every iteration with one barrier (see the note at the
// top); an env's count is the last iteration in which it stepped. Then the
// swap rounds, the output and the statistics, env by env.
template <int E, bool STAGED, int RULE>
__global__ void __launch_bounds__(BodyShape<E, STAGED>::kThreads,
                                  BodyShape<E, STAGED>::kMinBlocks)
    fdm_jacobi_body(Planes p, ConvArgs cv, StatArgs st, RunGrid g,
                    float threshold, int limit, int B) {
  static_assert(RULE == kBlock || E == 1, "the solo rule runs one env per block");
  FDM_DYNAMIC_SMEM(smem);
  __shared__ float red[2][E][32];  // per-warp maxima, by iteration parity
  __shared__ uint64_t bar;
  constexpr int kPlanes = STAGED ? 4 : 2;
  const int b0 = blockIdx.x * E;
  const int n_env = min(E, B - b0);
  const int hw = g.hw;
  const size_t P = g.plane;
  const unsigned valid = (1u << n_env) - 1u;
  uint8_t* ext_bits = (uint8_t*)(smem + (size_t)E * kPlanes * P);
  uint8_t* dec = STAGED ? (uint8_t*)(smem + 2 * P) : ext_bits + ((g.n_runs + 15) & ~15);
  float tinf[E];
#pragma unroll
  for (int e = 0; e < E; ++e) tinf[e] = e < n_env ? p.tinf[b0 + e] : 0.0f;
  stage_envs<E, STAGED>(p, g, smem, ext_bits, b0, n_env, &bar);

  const float* cn_g[E];
  const float* dn_g[E];
#pragma unroll
  for (int e = 0; e < E; ++e) {
    cn_g[e] = p.cnst + (size_t)(b0 + min(e, n_env - 1)) * hw;
    dn_g[e] = p.denom + (size_t)(b0 + min(e, n_env - 1)) * hw;
  }
  const Cursor q0 = first_run(g);  // the sweeps' start, divided once
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = (blockDim.x + 31) >> 5;

  float delta = threshold + 1.0f;  // kSolo: the last residual max
  unsigned active = RULE == kSolo && !(delta > threshold) ? 0u : valid;
  unsigned slots = 0;  // bit e: env e's iterate is in its slot 1
  unsigned conv = 0;
  int iters[E];
#pragma unroll
  for (int e = 0; e < E; ++e) iters[e] = 0;
  for (int it = 0; it < limit && active; ++it) {
    float m[E];
#pragma unroll
    for (int e = 0; e < E; ++e) m[e] = 0.0f;
    sweep<E, STAGED, kJacobi>(q0, p, g, smem, ext_bits, cn_g, dn_g, tinf, active, slots,
                              0.0f, true, m);
    float(*r)[32] = red[it & 1];
#pragma unroll
    for (int e = 0; e < E; ++e) {
      if ((active >> e) & 1u) {
        const float v = warp_max(m[e]);
        if (lane == 0) r[e][warp] = v;
      }
    }
    __syncthreads();
#pragma unroll
    for (int e = 0; e < E; ++e) {
      if ((active >> e) & 1u) m[e] = warp_max(lane < n_warps ? r[e][lane] : 0.0f);
    }
    slots ^= active;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      if (!((active >> e) & 1u)) continue;
      iters[e] = it + 1;
      if (RULE == kSolo) {
        delta = m[e];
        if (!(delta > threshold)) active = 0;
      } else if (m[e] <= threshold) {
        conv |= 1u << e;
        active &= ~(1u << e);
      }
    }
  }
  if (RULE == kSolo) conv = delta <= threshold ? valid : 0u;
  finish_envs<E, STAGED>(p, cv, st, g, smem, dec, b0, n_env, slots, iters, conv);
}

// ---------------------------------------------------------------------------
// Plans above one block's shared memory: one thread-block cluster per env
// ---------------------------------------------------------------------------
//
// Where not even one env's two planes, exterior bits and decision bytes fit
// one block's shared memory (run_geometry refuses E = 1: near 24,800
// cells), an env is solved by one cluster of up to kClusterMax CTAs, the
// portable cluster size, each owning a band of consecutive row blocks (the
// runs of the bodies above, numbered and stepped the same way within the
// band). The iterate pair lives in global memory: the output plane and a
// scratch plane (with swap rounds a spare plane too: see below); const,
// denom and the shared stencil are read where they lie, and the exterior
// bits of a run from the (H, W) plane. Every pass that reads cells another
// CTA wrote in the pass before it is separated from that pass by one
// cluster barrier: each Jacobi iteration, each Chebyshev sub-iteration,
// the emitted J(x_f), and each group of swap rounds after the first. The
// iterate is read through L2 (ld.global.cg), never from a
// CTA's L1. A sampled residual max is reduced in the block (one barrier),
// then across the cluster through distributed shared memory: warp 0 stores
// the block's max into slot [parity][rank] of every CTA, and after the
// cluster barrier every thread folds the slots, so the cluster barrier
// that orders the sweeps also carries the reduction. A CTA writes a
// parity's slots again only after the next cluster barrier, which every
// CTA passes only once it has read them. The solve's loop stays on the
// device, so a step on this path is captured like the others.
//
// Numerics: each cell update, recombination and swap is the block bodies'
// sequence of float32 operations, and the residual max is order-free, so
// the field, counts and flags equal the plain versions bitwise (both
// stopping rules of the Jacobi body, the Chebyshev chunks, the NaN rule).
// The statistics are left to the caller (the gridstats fold).
//
// Bound: per sweep an env reads its iterate (with its neighbours), const,
// denom and the 16-byte stencil of each cell, and writes the next iterate,
// about 36 B a cell (the Chebyshev recombination 4 more), from L2 where
// the in-flight envs' planes fit and from device memory where they do not;
// at 466 x 721 (335,986 cells) 16 envs are in flight, one cluster of 8 per
// 8 SMs, their planes ~86 MB against the 50 MB L2. Each env also writes
// its barrier count (`barriers`, read as the counter fdm.barriers).
//
// The swap rounds run in groups of consecutive rounds, planned at launch
// from the static offsets and the grid alone (swap_plan). A round is a set
// of disjoint transpositions, each pair a lead and its partner at the
// round's offset (dy, dx) (convection._lead_mask; the follower plane is the
// lead plane rolled by the offset), so after rounds r0..r1 a cell's value
// comes from cells within sum |dy_r| rows and sum |dx_r| columns of it
// (each offset taken as its shortest way round the torus), and from no cell
// further. A group therefore runs in a CTA's shared memory, tile by tile of
// its band: the field over the tile and a halo of that reach is loaded from
// global memory (rows and columns wrapped round the torus, so a region
// larger than the grid holds some cells twice, each of which evolves as the
// torus does), each cell's swap bits are formed once (its lead word AND its
// decisions: the word plane, or the mix32 hash made where the cell is, its
// lanes compared four bytes at a time; a pair whose partner lies outside
// the region is dropped), the group's rounds run in place (the lead of each
// pair swaps both cells; one __syncthreads a round), and the tile's
// interior, which no dropped pair can reach, is written to a plane that
// does not hold the field. No decision plane exists. The tile (th x tw) is
// the one that loads fewest cells within kSwapTileBytes, which leaves the
// rest of the SM's unified memory to the solve as L1; a group is extended
// while its tiles load at most kTileLoad times the band's cells. So the
// epilogue's bound is one read of the field (with its halos: 1.95x at
// floor126, one group of 16 rounds, reach 19 x 14, five tiles of 60 x 145 a
// band) and one write per group, one cluster barrier between groups and
// none inside one. A round whose reach alone admits no such tile (a
// doubling-ladder round on a large room) is a group of its own, run as a
// pass over the band in global memory, its decisions made where they are
// read (a lead's own, a follower's its lead's). With swap rounds the solve
// leaves its field out of the output plane (Chebyshev emits J(x_f) into the
// spare plane; Jacobi alternates between scratch and spare) and the groups
// alternate between scratch and spare, the last writing the output: no copy
// and no barrier after the last group.
//
// Chebyshev's chunks run the same way. Between two sampled sub-iterations no
// decision is taken, so the `check_every` sub-iterations of a chunk after x1 =
// J(x0) run as one chunk pass, tile by tile of the CTA's band: x, x_prev, const
// and denom (copied by cp.async) and each cell's flags (its exterior pin, and
// with edge fill which neighbours are t_inf) are loaded over the tile and a
// halo of `check_every` rows and columns round the torus, sub-iteration s
// updates the region shrunk by s cells in place (x_next over x_prev, one
// __syncthreads a sub-iteration; each cell's update is the streamed sweep's
// float32 sequence on the same inputs, and a halo cell is a real cell of the
// grid computed from its real neighbours), the last one samples the residual
// over the tile's interior alone, and the interior's last iterate and the one
// before it are written out. A neighbour CTA may still be loading its halo from
// the planes a pass reads, so a pass writes two planes it does not read: the
// pairs (spare, output) and (scratch, extra) take turns, the first pass reading
// (scratch, temp). One cluster barrier a chunk, which also carries its residual
// max. The tile (planned at launch by chunk_plan from the grid and
// `check_every` alone) is the one that loads fewest cells within kTileBytes,
// the swap tile's memory, which the solve and the epilogue never use at the
// same time. Without such a tile, or with `check_every` = 1, the chunks stream
// as above.

constexpr int kClusterMax = 8;        // CTAs per env: the portable cluster size
constexpr int kClusterThreads = 1024;  // threads per CTA (at most)
// Floats at the start of a cluster body's shared memory: the block's warp
// maxima and the cluster's reduction slots [2][kClusterMax].
constexpr int kClusterScalars = 32 + 2 * kClusterMax;
// Shared memory a cluster CTA may give a tile of swap rounds or of a chunk
// pass: an SM's 256 KB of unified L1 and shared memory less 96 KB of L1 for
// the solve's streamed sweeps (a 214 KB swap tile, which leaves 28 KB,
// slowed the whole solve by 27-36% on the H100, PERF.md), less the CTA's
// reserved 1 KB and scalars.
constexpr size_t kTileBytes = (256 - 96 - 1) * 1024 - sizeof(float) * kClusterScalars;
// A group's tiles may load at most this many times its band's cells.
constexpr int kTileLoad = 4;
// Cells a thread loads into a chunk tile at a time: the planes' copies
// asynchronous, the exterior's loads all before any flag is stored.
constexpr int kLoadBatch = 4;

// One group of the swap plan: rounds [r0, r1); tw > 0: in shared memory
// over tiles of th x tw cells with a halo of hy rows and hx columns; tw ==
// 0: one round as a pass over the band in global memory.
struct SwapGroup {
  int r0, r1, hy, hx, th, tw;
};

struct SwapPlan {
  int n;  // groups
  SwapGroup g[kMaxRounds];
};

// The tile of Chebyshev's chunk passes: th x tw cells of a CTA's band with
// a halo of `halo` (check_every) rows and columns; tw == 0: the chunks
// stream.
struct ChunkPlan {
  int halo, th, tw;
};

// What a cluster body adds to the planes: the second iterate plane, the
// spare plane of the swap rounds and the chunk passes, the chunk passes'
// extra plane, the per-env barrier and tiled sub-iteration counts, the
// geometry and the plans.
struct ClusterArgs {
  float* scratch;     // (B, H, W)
  float* spare;       // (B, H, W); null without swap rounds or chunk passes
  float* extra;       // (B, H, W); null without chunk passes
  int32_t* barriers;  // (B,)
  int32_t* tiled;     // (B,)
  int cluster;        // CTAs per env
  int band_blocks;    // row blocks a CTA owns (the last may own fewer)
  SwapPlan plan;
  ChunkPlan chunk;
};

// A round's offset d, normalised to [0, n), as its shortest way round a
// torus of n: in (-n/2, n/2].
__host__ __device__ __forceinline__ int torus_offset(int d, int n) {
  return 2 * d > n ? d - n : d;
}

// Shared bytes of a tile region of R x C cells: the field and the swap
// bits per cell, then per row and per column its global offset and the
// rounds whose partner stays in the region.
size_t tile_bytes(int R, int C) {
  return 8 * ((size_t)R * C + R + C);
}

// Shared bytes of a chunk tile region of R x C cells: x, x_prev, const and
// denom per cell, then per row its first cell and per column its x, then
// each cell's flags and each row's and column's edge flags.
constexpr int kChunkCellBytes = 17, kChunkLineBytes = 5;
size_t chunk_bytes(int R, int C) {
  return kChunkCellBytes * (size_t)R * C + kChunkLineBytes * ((size_t)R + C);
}

__device__ __forceinline__ Cursor band_first_run(const RunGrid& g, int rb0) {
  Cursor q = first_run(g);
  q.yb += rb0;
  return q;
}

// One run of a cluster body's pass: as run_pass for one env, with the
// iterate x (and Chebyshev's x_prev, xp) read from global memory through
// L2 and the result written to dst (kCheby: xp and dst are one plane after
// the first sub-iteration; the first reads x_prev from temp). The run's
// results are stored after all its loads: a load the compiler cannot prove
// apart from an earlier store waits for it, which would make every cell an
// L2 round trip of its own.
template <int PASS, bool FULL>
__device__ __forceinline__ void cluster_run(const Run& u, const Planes& p, const RunGrid& g,
                                            const float* x, const float* xp, float* dst,
                                            const float* cn, const float* dn, float tinf,
                                            float omega_next, bool sample, float& m) {
  const int n = FULL ? kRun : u.n;
  const int W = g.W;
  const bool edge = g.edge_fill != 0;
  float xv[kRun];
  uint32_t ext = 0;
#pragma unroll
  for (int i = 0; i < kRun; ++i) {
    xv[i] = i < n ? __ldcg(x + u.c0 + i * W) : 0.0f;
    if (i < n && __ldg(p.ext + u.c0 + i * W) > 0.0f) ext |= 1u << i;
  }
  const float top = u.fu ? tinf : __ldcg(x + u.iu);
  const float bottom = u.fd ? tinf : __ldcg(x + u.id);
  float res[kRun];
#pragma unroll
  for (int i = 0; i < kRun; ++i) {
    res[i] = 0.0f;
    if (i >= n) continue;
    const int c = u.c0 + i * W;
    const float4 k = __ldg(p.coef + c);
    const float xl = u.fl ? tinf : __ldcg(x + c + u.dl);
    const float xr = u.fr ? tinf : __ldcg(x + c + u.dr);
    const float xt = i == 0 ? top : xv[i > 0 ? i - 1 : 0];
    const float xb = i + 1 < n ? xv[i + 1 < kRun ? i + 1 : i] : bottom;
    const float xpv = PASS == kCheby ? __ldcg(xp + c) : 0.0f;
    res[i] = cell_update<PASS>(k, xr, xl, xb, xt, __ldg(cn + c), __ldg(dn + c), tinf,
                               (ext >> i) & 1u, edge, xv[i], xpv, omega_next, sample, m);
  }
#pragma unroll
  for (int i = 0; i < kRun; ++i) {
    if (i < n) dst[u.c0 + i * W] = res[i];
  }
}

// One pass of a cluster body over the CTA's band (runs of it from row
// block rb0).
template <int PASS>
__device__ __forceinline__ void cluster_sweep(const Planes& p, const RunGrid& g, int rb0,
                                              int runs, const float* x, const float* xp,
                                              float* dst, const float* cn, const float* dn,
                                              float tinf, float omega_next, bool sample,
                                              float& m) {
  for (Cursor q = band_first_run(g, rb0); q.r < runs; next_run(q, g)) {
    const Run u = make_run(q, g);
    if (u.n == kRun) {
      cluster_run<PASS, true>(u, p, g, x, xp, dst, cn, dn, tinf, omega_next, sample, m);
    } else {
      cluster_run<PASS, false>(u, p, g, x, xp, dst, cn, dn, tinf, omega_next, sample, m);
    }
  }
}

// The cluster-wide max of every thread's m (see the note above); the
// cluster barrier it takes also orders the sweep before it. `warps` holds
// the block's per-warp maxima, `slots` the cluster's [2][kClusterMax].
__device__ float cluster_max(float m, float* warps, float* slots, int& parity, int rank,
                             int cluster) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = (blockDim.x + 31) >> 5;
  const float v = warp_max(m);
  if (lane == 0) warps[warp] = v;
  __syncthreads();
  float* mine = slots + parity * kClusterMax;
  if (warp == 0) {
    const float w = warp_max(lane < n_warps ? warps[lane] : 0.0f);
    if (lane < cluster) cluster_store(mine + rank, (unsigned)lane, w);
  }
  cluster_sync();
  float r = 0.0f;
  for (int k = 0; k < cluster; ++k) r = nan_max(r, mine[k]);
  parity ^= 1;
  return r;
}

// Bit l set where lane l (lane_bits wide) of the word h is below q: the
// 8- and 4-bit lanes of the decision words by byte compares, others lane
// by lane.
__device__ __forceinline__ uint32_t lanes_below(uint32_t h, const ConvArgs& cv) {
  // Bit k of the result from byte k of m (each 0 or 1): no two products
  // of the multiply meet below bit 28.
  auto gather = [](uint32_t m) { return ((m & 0x01010101u) * 0x01020408u) >> 24; };
  if ((cv.lane_bits == 8 || cv.lane_bits == 4) && cv.q < 256) {
    const uint32_t q = (uint32_t)cv.q * 0x01010101u;
    if (cv.lane_bits == 8) return gather(__vcmpltu4(h, q));
    // Nibbles 0, 2, 4, 6 from the low halves of the bytes, 1, 3, 5, 7 from
    // the high; each 4-bit gather spread to alternate bits.
    auto spread = [](uint32_t x) {
      x = (x | (x << 2)) & 0x33u;
      return (x | (x << 1)) & 0x55u;
    };
    return spread(gather(__vcmpltu4(h & 0x0f0f0f0fu, q))) |
           spread(gather(__vcmpltu4((h >> 4) & 0x0f0f0f0fu, q))) << 1;
  }
  const int lanes = 32 / cv.lane_bits;
  const uint32_t lane_mask = cv.lane_bits == 32 ? ~0u : (1u << cv.lane_bits) - 1u;
  uint32_t out = 0;
  for (int ln = 0; ln < lanes; ++ln) {
    if (((h >> (cv.lane_bits * ln)) & lane_mask) < (uint32_t)cv.q) out |= 1u << ln;
  }
  return out;
}

// The decision bits of cell c for the rounds of `bits` (a subset of the
// rounds of planes pl0..pl1): from the word plane, else the mix32 hash of
// the env's keys, one hash a word plane that holds one of them.
__device__ __forceinline__ uint32_t decisions(uint32_t c, uint32_t bits, const ConvArgs& cv,
                                              const RunGrid& g, int pl0, int pl1, uint32_t k0,
                                              uint32_t k1, const uint32_t* wrd) {
  if (wrd != nullptr) return __ldg(wrd + c) & bits;
  const int lanes = 32 / cv.lane_bits;
  uint32_t out = 0;
  for (int pl = pl0; pl <= pl1; ++pl) {
    const int rb = pl * lanes;  // the plane's first round
    const uint32_t mine = lanes == 32 ? bits : bits & (((1u << lanes) - 1u) << rb);
    if (mine == 0) continue;
    const uint32_t h = fmix32(fmix32((c + (uint32_t)pl * (uint32_t)g.hw) ^ k0) ^ k1);
    out |= lanes_below(h, cv) << rb;
  }
  return out & bits;
}

// A group of swap rounds in shared memory (see the note above), tile by
// tile of the band's rows [y0, y1): from src into dst, both in global
// memory. `tile` is the CTA's shared memory past its scalars.
__device__ void swap_tiles(const float* src, float* dst, float* tile, const Planes& p,
                           const ConvArgs& cv, const RunGrid& g, const SwapGroup& sg, int y0,
                           int y1, uint32_t k0, uint32_t k1, const uint32_t* wrd) {
  const int H = g.H, W = g.W;
  const int T = blockDim.x;
  const int lanes = 32 / cv.lane_bits;
  const int pl0 = sg.r0 / lanes, pl1 = (sg.r1 - 1) / lanes;
  const uint32_t rounds =
      (sg.r1 - sg.r0 == 32 ? ~0u : ((1u << (sg.r1 - sg.r0)) - 1u)) << sg.r0;
  for (int ty = y0; ty < y1; ty += sg.th) {
    const int th = min(sg.th, y1 - ty);
    for (int tx = 0; tx < W; tx += sg.tw) {
      const int tw = min(sg.tw, W - tx);
      const int R = th + 2 * sg.hy, C = tw + 2 * sg.hx, n = R * C;
      float* v = tile;
      uint32_t* sb = reinterpret_cast<uint32_t*>(v + n);
      int* row_cell = reinterpret_cast<int*>(sb + n);  // R: the row's first cell
      uint32_t* row_ok = reinterpret_cast<uint32_t*>(row_cell + R);
      int* col_x = reinterpret_cast<int*>(row_ok + R);  // C: the column
      uint32_t* col_ok = reinterpret_cast<uint32_t*>(col_x + C);
      // Per row and column of the region: where it lies on the torus, and
      // the rounds whose partner row / column lies in the region.
      for (int k = threadIdx.x; k < R + C; k += T) {
        const bool row = k < R;
        const int i = row ? k : k - R;
        const int len = row ? R : C, axis = row ? H : W;
        int at = ((row ? ty - sg.hy : tx - sg.hx) + i) % axis;
        if (at < 0) at += axis;
        uint32_t ok = 0;
        for (int r = sg.r0; r < sg.r1; ++r) {
          const int d = torus_offset(row ? cv.dy[r] : cv.dx[r], axis);
          if (i + d >= 0 && i + d < len) ok |= 1u << r;
        }
        if (row) {
          row_cell[i] = at * W;
          row_ok[i] = ok;
        } else {
          col_x[i] = at;
          col_ok[i] = ok;
        }
      }
      __syncthreads();
      // The field and each cell's swap bits; cell idx at (i, j), stepped by
      // (T / C, T % C) with one carry.
      const int si = T / C, sj = T - si * C;
      int i = threadIdx.x / C, j = threadIdx.x - i * C;
      for (int idx = threadIdx.x; idx < n; idx += T) {
        const int c = row_cell[i] + col_x[j];
        v[idx] = __ldcg(src + c);
        uint32_t bits = __ldg(p.lead + c) & rounds & row_ok[i] & col_ok[j];
        if (bits != 0) bits = decisions((uint32_t)c, bits, cv, g, pl0, pl1, k0, k1, wrd);
        sb[idx] = bits;
        i += si;
        j += sj;
        if (j >= C) {
          j -= C;
          ++i;
        }
      }
      __syncthreads();
      // Round r moves values at most `reach` rows (the rounds from r on),
      // so it runs on the rows within that of the tile; every column.
      int reach = sg.hy;
      for (int r = sg.r0; r < sg.r1; ++r) {
        const uint32_t bit = 1u << r;
        const int dy = torus_offset(cv.dy[r], H);
        const int off = dy * C + torus_offset(cv.dx[r], W);
        const int end = (sg.hy + th + reach) * C;
        for (int idx = (sg.hy - reach) * C + threadIdx.x; idx < end; idx += T) {
          if (sb[idx] & bit) {
            const float a = v[idx];
            v[idx] = v[idx + off];
            v[idx + off] = a;
          }
        }
        reach -= dy < 0 ? -dy : dy;
        __syncthreads();
      }
      // The interior out, row by row of the tile.
      const int ti = T / tw, tj = T - ti * tw;
      int ii = threadIdx.x / tw, jj = threadIdx.x - ii * tw;
      for (int k = threadIdx.x; k < th * tw; k += T) {
        dst[(ty + ii) * W + tx + jj] = v[(sg.hy + ii) * C + sg.hx + jj];
        ii += ti;
        jj += tj;
        if (jj >= tw) {
          jj -= tw;
          ++ii;
        }
      }
      __syncthreads();  // the region is read out before the next tile's
    }
  }
}

// One round too wide for any tile, on the CTA's band: as a round of
// swap_runs, from src into dst in global memory, each decision made where
// it is read (a lead's own, a follower's its lead's). A round reads both
// partners of a run's cells before it stores (see cluster_run).
__device__ void swap_wide(const float* src, float* dst, const Planes& p, const ConvArgs& cv,
                          const RunGrid& g, int rb0, int runs, int r, uint32_t k0, uint32_t k1,
                          const uint32_t* wrd) {
  const int H = g.H, W = g.W;
  const uint32_t bit = 1u << r;
  const int pl = r / (32 / cv.lane_bits);
  const int dy = cv.dy[r], dx = cv.dx[r];
  for (Cursor q = band_first_run(g, rb0); q.r < runs; next_run(q, g)) {
    const int y0 = q.yb * kRun;
    const int n = min(kRun, H - y0);
    int xf = q.x + dx;  // the follower's column of a lead here
    if (xf >= W) xf -= W;
    int xl = q.x - dx;  // the lead's column of a follower here
    if (xl < 0) xl += W;
    int yf = y0 + dy;  // the follower's row of the run's first cell
    if (yf >= H) yf -= H;
    int yl = y0 - dy;  // the lead's row of a follower there
    if (yl < 0) yl += H;
    float v[kRun];
#pragma unroll
    for (int i = 0; i < kRun; ++i) {
      v[i] = 0.0f;
      if (i >= n) continue;
      const int c = (y0 + i) * W + q.x;
      const int lead_cell = yl * W + xl;
      float r_v = __ldcg(src + c);
      if ((__ldg(p.lead + c) & bit) &&
          decisions((uint32_t)c, bit, cv, g, pl, pl, k0, k1, wrd)) {
        r_v = __ldcg(src + yf * W + xf);
      }
      if ((__ldg(p.foll + c) & bit) &&
          decisions((uint32_t)lead_cell, bit, cv, g, pl, pl, k0, k1, wrd)) {
        r_v = __ldcg(src + lead_cell);
      }
      v[i] = r_v;
      if (++yf == H) yf = 0;
      if (++yl == H) yl = 0;
    }
#pragma unroll
    for (int i = 0; i < kRun; ++i) {
      if (i < n) dst[(y0 + i) * W + q.x] = v[i];
    }
  }
}

// A cell's flags in a chunk tile: its exterior pin, and (edge fill) which
// of its neighbours lie off the grid and read t_inf.
enum ChunkFlag : uint8_t { kPin = 1, kUp = 2, kDown = 4, kLeft = 8, kRight = 16 };

// One run of a chunk tile's sub-iteration: the cells of rows i0 .. i0 + n - 1
// of column j of the region (C columns; a the iterate, b x_prev, which
// x_next overwrites in place; x the column's place on the grid), each the
// streamed sweep's update, its stencil read where the cell lies on the
// grid. EDGE: edge fill, whose flags say which neighbours read t_inf
// (without it only the pin is flagged, and the reads wrap).
template <bool FULL, bool EDGE>
__device__ __forceinline__ void tile_run(const float* __restrict__ a, float* __restrict__ b,
                                         const float* __restrict__ cs,
                                         const float* __restrict__ ds,
                                         const uint8_t* __restrict__ fl,
                                         const int* __restrict__ row_cell, int x,
                                         const float4* __restrict__ coef, int C, int i0,
                                         int n_run, int j, float tinf, float omega_next,
                                         bool sample, float& m) {
  const int n = FULL ? kRun : n_run;
  const int top = i0 * C + j;
  // The run's stencil first: a read after a store into the tile waits
  // for it, which would make each cell an L2 round trip of its own.
  float4 k[kRun];
#pragma unroll
  for (int q = 0; q < kRun; ++q) {
    k[q] = q < n ? __ldg(coef + row_cell[i0 + q] + x) : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
  float xv[kRun + 2];  // rows i0 - 1 .. i0 + n
#pragma unroll
  for (int q = 0; q < kRun + 2; ++q) xv[q] = q <= n + 1 ? a[top + (q - 1) * C] : 0.0f;
#pragma unroll
  for (int q = 0; q < kRun; ++q) {
    if (q >= n) continue;
    const int c = top + q * C;
    const uint32_t f = fl[c];
    const float xl = EDGE && (f & kLeft) ? tinf : a[c - 1];
    const float xr = EDGE && (f & kRight) ? tinf : a[c + 1];
    const float xt = EDGE && (f & kUp) ? tinf : xv[q];
    const float xb = EDGE && (f & kDown) ? tinf : xv[q + 2];
    b[c] = cell_update<kCheby>(k[q], xr, xl, xb, xt, cs[c], ds[c], tinf, f & kPin, EDGE,
                               xv[q + 1], b[c], omega_next, sample, m);
  }
}

// The `sweeps` sub-iterations of a chunk tile's region of R x C cells, from
// omega on: sub-iteration s on rows [s, R - s) and columns [s, C - s), in
// runs of kRun down a column as the streamed sweeps own them, x_next over
// x_prev in place; the last samples the residual. On return a holds the
// last iterate and b the one before it.
template <bool EDGE>
__device__ __forceinline__ void tile_sweeps(float*& a, float*& b, const float* cs,
                                            const float* ds, const uint8_t* fl,
                                            const int* row_cell, const int* col_x,
                                            const float4* coef, int R, int C, float tinf,
                                            float rho2, float omega, int sweeps, float& m) {
  const int T = blockDim.x;
  float w = omega;
  for (int s = 1; s <= sweeps; ++s) {
    w = 1.0f / (1.0f - rho2 * w / 4.0f);
    const int nc = C - 2 * s, nb = (R - 2 * s + kRun - 1) / kRun;
    const int sb = T / nc, sx = T - sb * nc;
    int rb = threadIdx.x / nc, jx = threadIdx.x - rb * nc;
    for (int r = threadIdx.x; r < nb * nc; r += T) {
      const int i0 = s + rb * kRun, n_run = min(kRun, R - s - i0);
      const int gx = col_x[s + jx];
      if (n_run == kRun) {
        tile_run<true, EDGE>(a, b, cs, ds, fl, row_cell, gx, coef, C, i0, kRun, s + jx, tinf,
                             w, s == sweeps, m);
      } else {
        tile_run<false, EDGE>(a, b, cs, ds, fl, row_cell, gx, coef, C, i0, n_run, s + jx,
                              tinf, w, s == sweeps, m);
      }
      rb += sb;
      jx += sx;
      if (jx >= nc) {
        jx -= nc;
        ++rb;
      }
    }
    __syncthreads();
    float* t = a;
    a = b;
    b = t;
  }
}

// The chunk passes (see the note above the cluster constants): `sweeps`
// sub-iterations from (x, xp) with omega from `omega` on, tile by tile of
// the band's rows [y0, y1) of the H x W grid (edge: edge fill), the
// interior's x and x_prev written to nx and np. Returns the thread's
// residual max over the interiors of the last sub-iteration. The tile is
// the CTA's shared memory past its scalars.
__device__ float chunk_tiles(const float4* coef, const float* ext, int H, int W, bool edge,
                             ChunkPlan cp, int y0, int y1, const float* x, const float* xp,
                             float* nx, float* np, const float* cn, const float* dn, float tinf,
                             float rho2, float omega, int sweeps) {
  FDM_DYNAMIC_SMEM(smem);
  float* tile = smem + kClusterScalars;
  const int T = blockDim.x, h = cp.halo;
  float m = 0.0f;
  for (int ty = y0; ty < y1; ty += cp.th) {
    const int th = min(cp.th, y1 - ty);
    for (int tx = 0; tx < W; tx += cp.tw) {
      const int tw = min(cp.tw, W - tx);
      const int R = th + 2 * h, C = tw + 2 * h, n = R * C;
      float* a = tile;
      float* b = a + n;
      float* cs = b + n;
      float* ds = cs + n;
      int* row_cell = reinterpret_cast<int*>(ds + n);  // R: the row's first cell
      int* col_x = row_cell + R;                        // C: the column
      uint8_t* fl = reinterpret_cast<uint8_t*>(col_x + C);
      uint8_t* row_f = fl + n;
      uint8_t* col_f = row_f + R;
      for (int k = threadIdx.x; k < R + C; k += T) {
        const bool row = k < R;
        const int i = row ? k : k - R;
        const int axis = row ? H : W;
        int at = ((row ? ty : tx) - h + i) % axis;
        if (at < 0) at += axis;
        uint8_t f = 0;
        if (edge && at == 0) f |= row ? kUp : kLeft;
        if (edge && at == axis - 1) f |= row ? kDown : kRight;
        if (row) {
          row_cell[i] = at * W;
          row_f[i] = f;
        } else {
          col_x[i] = at;
          col_f[i] = f;
        }
      }
      __syncthreads();
      // The region, cell idx at (i, j), stepped by (T / C, T % C) with one
      // carry; kLoadBatch cells a thread at a time.
      const int si = T / C, sj = T - si * C;
      int i = threadIdx.x / C, j = threadIdx.x - i * C;
      for (int idx0 = threadIdx.x; idx0 < n; idx0 += kLoadBatch * T) {
        int c[kLoadBatch];
        uint8_t f[kLoadBatch];
#pragma unroll
        for (int u = 0; u < kLoadBatch; ++u) {
          const bool in = idx0 + u * T < n;
          c[u] = in ? row_cell[i] + col_x[j] : -1;
          f[u] = in ? row_f[i] | col_f[j] : 0;
          i += si;
          j += sj;
          if (j >= C) {
            j -= C;
            ++i;
          }
        }
        float e[kLoadBatch];
#pragma unroll
        for (int u = 0; u < kLoadBatch; ++u) {
          if (c[u] < 0) continue;
          const int idx = idx0 + u * T;
          copy_async4(a + idx, x + c[u]);
          copy_async4(b + idx, xp + c[u]);
          copy_async4(cs + idx, cn + c[u]);
          copy_async4(ds + idx, dn + c[u]);
          e[u] = __ldg(ext + c[u]);
        }
#pragma unroll
        for (int u = 0; u < kLoadBatch; ++u) {
          if (c[u] >= 0) fl[idx0 + u * T] = (e[u] > 0.0f ? kPin : 0) | f[u];
        }
      }
      wait_async();
      __syncthreads();
      if (edge) {
        tile_sweeps<true>(a, b, cs, ds, fl, row_cell, col_x, coef, R, C, tinf, rho2, omega,
                          sweeps, m);
      } else {
        tile_sweeps<false>(a, b, cs, ds, fl, row_cell, col_x, coef, R, C, tinf, rho2, omega,
                           sweeps, m);
      }
      // The interior's x (a) and x_prev (b) out, row by row of the tile.
      const int ti = T / tw, tj = T - ti * tw;
      int ii = threadIdx.x / tw, jj = threadIdx.x - ii * tw;
      for (int k = threadIdx.x; k < th * tw; k += T) {
        const int c = (ty + ii) * W + tx + jj, at = (h + ii) * C + h + jj;
        nx[c] = a[at];
        np[c] = b[at];
        ii += ti;
        jj += tj;
        if (jj >= tw) {
          jj -= tw;
          ++ii;
        }
      }
      __syncthreads();  // the region is read out before the next tile's
    }
  }
  return m;
}

// The epilogue of a cluster body. With swap rounds: the plan's groups from
// the field (never the output plane s0) alternately into s1 and s2, the
// last into s0, a cluster barrier between groups. Without: each thread
// copies its own cells of the field into s0 where it lies elsewhere (it
// wrote those cells itself, so no barrier is needed). Rank 0 writes the
// env's count, flag, barriers and tiled sub-iterations.
__device__ void cluster_finish(const Planes& p, const ConvArgs& cv, const RunGrid& g,
                               const ClusterArgs& ca, float* tile, int rank, int b, int rb0,
                               int runs, const float* field, float* s0, float* s1, float* s2,
                               int iters, bool conv, int n_bar, int tiled) {
  const size_t off = (size_t)b * g.hw;
  if (cv.n_rounds > 0) {
    uint32_t k0 = 0, k1 = 0;
    const uint32_t* wrd = nullptr;
    if (p.words != nullptr) {
      wrd = p.words + off;
    } else {
      k0 = (uint32_t)p.keys[2 * b];
      k1 = (uint32_t)p.keys[2 * b + 1];
    }
    const int y0 = rb0 * kRun, y1 = min(g.H, (rb0 + ca.band_blocks) * kRun);
    const float* src = field;
    for (int k = 0; k < ca.plan.n; ++k) {
      const SwapGroup& sg = ca.plan.g[k];
      float* dst = k + 1 == ca.plan.n ? s0 : src == s1 ? s2 : s1;
      if (k > 0) {
        cluster_sync();
        ++n_bar;
      }
      if (sg.tw > 0) {
        swap_tiles(src, dst, tile, p, cv, g, sg, y0, y1, k0, k1, wrd);
      } else {
        swap_wide(src, dst, p, cv, g, rb0, runs, sg.r0, k0, k1, wrd);
      }
      src = dst;
    }
  } else if (field != s0) {
    for (Cursor q = band_first_run(g, rb0); q.r < runs; next_run(q, g)) {
      const int y0 = q.yb * kRun;
      const int n = min(kRun, g.H - y0);
      float v[kRun];
#pragma unroll
      for (int i = 0; i < kRun; ++i) v[i] = i < n ? __ldcg(field + (y0 + i) * g.W + q.x) : 0.0f;
#pragma unroll
      for (int i = 0; i < kRun; ++i) {
        if (i < n) s0[(y0 + i) * g.W + q.x] = v[i];
      }
    }
  }
  if (rank == 0 && threadIdx.x == 0) {
    p.iters[b] = iters;
    p.converged[b] = conv ? 1 : 0;
    ca.barriers[b] = n_bar;
    ca.tiled[b] = tiled;
  }
}

// The band of a cluster body's CTA: its rank, env, first row block and
// runs; the dynamic shared memory holds warps[32] and slots[2][kClusterMax],
// then a tile of a chunk pass or of the swap rounds.
struct Band {
  int rank, b, rb0, runs;
};

__device__ __forceinline__ Band cluster_band(const RunGrid& g, const ClusterArgs& ca) {
  Band s;
  s.rank = (int)cluster_rank();
  s.b = blockIdx.x / ca.cluster;
  s.rb0 = s.rank * ca.band_blocks;
  s.runs = max(0, min(ca.band_blocks, g.row_blocks - s.rb0)) * g.W;
  return s;
}

// K1's and K4's semantics (one env) on a cluster: x1 = J(x0), then chunks
// of `check_every` sub-iterations, the residual of each chunk's last one
// deciding the stop, then J(x_f), the swap rounds and the output. A chunk
// is one pass in shared memory where the chunk plan has a tile (see the
// note above the cluster constants; `tiled` counts its sub-iterations),
// else it streams: the first sub-iteration reads x_prev from temp and
// writes the output plane, after which x_next overwrites x_prev in place,
// as in the block body, one cluster barrier a sub-iteration. J(x_f) goes
// into a plane that does not hold x, with swap rounds never the output.
__global__ void __launch_bounds__(kClusterThreads, 1)
    fdm_cheby_cluster_body(Planes p, ConvArgs cv, RunGrid g, ClusterArgs ca,
                           float threshold, int limit, float rho2, float omega0,
                           int check_every) {
  FDM_DYNAMIC_SMEM(smem);
  float* warps = smem;
  float* slots = smem + 32;
  const Band s = cluster_band(g, ca);
  const size_t off = (size_t)s.b * g.hw;
  const float* temp = p.temp + off;
  const float* cn = p.cnst + off;
  const float* dn = p.denom + off;
  float* s0 = p.out + off;
  float* s1 = ca.scratch + off;
  float* s2 = ca.spare != nullptr ? ca.spare + off : nullptr;
  float* s3 = ca.extra != nullptr ? ca.extra + off : nullptr;
  float* tile = smem + kClusterScalars;
  const float tinf = p.tinf[s.b];
  int n_bar = 0, parity = 0, tiled = 0;
  float m = 0.0f;
  cluster_sweep<kFirst>(p, g, s.rb0, s.runs, temp, nullptr, s1, cn, dn, tinf, 0.0f, true, m);
  m = cluster_max(m, warps, slots, parity, s.rank, ca.cluster);
  ++n_bar;
  bool done = m <= threshold;
  int it = 1, iters = 1;
  float omega = omega0;
  const float* x = s1;
  const float* xp = temp;
  const int y0 = s.rb0 * kRun, y1 = min(g.H, (s.rb0 + ca.band_blocks) * kRun);
  while (it < limit && !done) {
    if (ca.chunk.tw > 0) {
      // One chunk pass from the pair it reads into the other.
      float* nx = x == s2 ? s1 : s2;
      float* np = x == s2 ? s3 : s0;
      m = chunk_tiles(p.coef, p.ext, g.H, g.W, g.edge_fill != 0, ca.chunk, y0, y1, x, xp, nx,
                      np, cn, dn, tinf, rho2, omega, check_every);
      m = cluster_max(m, warps, slots, parity, s.rank, ca.cluster);
      ++n_bar;
      for (int kk = 0; kk < check_every; ++kk) omega = 1.0f / (1.0f - rho2 * omega / 4.0f);
      x = nx;
      xp = np;
      it += check_every;
      tiled += check_every;
    } else {
      for (int kk = 0; kk < check_every; ++kk) {
        const float omega_next = 1.0f / (1.0f - rho2 * omega / 4.0f);
        const bool sample = kk == check_every - 1;
        float* dst = xp == s1 ? s1 : s0;
        m = 0.0f;
        cluster_sweep<kCheby>(p, g, s.rb0, s.runs, x, xp, dst, cn, dn, tinf, omega_next,
                              sample, m);
        if (sample) {
          m = cluster_max(m, warps, slots, parity, s.rank, ca.cluster);
        } else {
          cluster_sync();
        }
        ++n_bar;
        xp = x;
        x = dst;
        ++it;
        omega = omega_next;
      }
    }
    iters = it;
    if (m <= threshold) done = true;
  }
  // J(x_f) into a plane that does not hold x: with swap rounds never the
  // output (the last group writes it), without them the output.
  float* field = cv.n_rounds > 0 ? (x == s2 ? s1 : s2) : (x == s0 ? s1 : s0);
  cluster_sweep<kFinal>(p, g, s.rb0, s.runs, x, nullptr, field, cn, dn, tinf, 0.0f, false, m);
  cluster_sync();
  ++n_bar;
  cluster_finish(p, cv, g, ca, tile, s.rank, s.b, s.rb0, s.runs, field, s0, s1, s2, iters, done,
                 n_bar, tiled);
}

// K2's (kSolo) and K3's (kBlock) semantics (one env) on a cluster: Jacobi
// from temp, alternating between the output and scratch planes (with swap
// rounds, scratch and spare), one cluster max per iteration; then the swap
// rounds and the output.
template <int RULE>
__global__ void __launch_bounds__(kClusterThreads, 1)
    fdm_jacobi_cluster_body(Planes p, ConvArgs cv, RunGrid g, ClusterArgs ca,
                            float threshold, int limit) {
  FDM_DYNAMIC_SMEM(smem);
  float* warps = smem;
  float* slots = smem + 32;
  const Band s = cluster_band(g, ca);
  const size_t off = (size_t)s.b * g.hw;
  const float* temp = p.temp + off;
  const float* cn = p.cnst + off;
  const float* dn = p.denom + off;
  float* s0 = p.out + off;
  float* s1 = ca.scratch + off;
  float* s2 = cv.n_rounds > 0 ? ca.spare + off : nullptr;
  float* other = s2 != nullptr ? s2 : s0;  // the plane the iterate alternates with s1
  const float tinf = p.tinf[s.b];
  int n_bar = 0, parity = 0;
  float delta = threshold + 1.0f;  // kSolo: the last residual max
  bool active = RULE == kBlock || delta > threshold;
  bool conv = false;
  int iters = 0;
  const float* x = temp;
  for (int it = 0; it < limit && active; ++it) {
    float* dst = x == s1 ? other : s1;
    float m = 0.0f;
    cluster_sweep<kJacobi>(p, g, s.rb0, s.runs, x, nullptr, dst, cn, dn, tinf, 0.0f, true, m);
    m = cluster_max(m, warps, slots, parity, s.rank, ca.cluster);
    ++n_bar;
    x = dst;
    iters = it + 1;
    if (RULE == kSolo) {
      delta = m;
      if (!(delta > threshold)) active = false;
    } else if (m <= threshold) {
      conv = true;
      active = false;
    }
  }
  if (RULE == kSolo) conv = delta <= threshold;
  cluster_finish(p, cv, g, ca, smem + kClusterScalars, s.rank, s.b, s.rb0, s.runs, x, s0, s1,
                 s2, iters, conv, n_bar, 0);
}

// ---------------------------------------------------------------------------
// Launchers
// ---------------------------------------------------------------------------

ConvArgs make_conv_args(const int* offsets, int n_rounds, int lane_bits,
                        int q) {
  ConvArgs cv = {};
  cv.n_rounds = n_rounds;
  cv.lane_bits = lane_bits;
  cv.q = q;
  for (int r = 0; r < n_rounds; ++r) {
    cv.dy[r] = offsets[2 * r];
    cv.dx[r] = offsets[2 * r + 1];
  }
  return cv;
}

StatArgs make_stat_args(const float* masks, const int32_t* row0,
                        const int32_t* col0, float* zone_sums,
                        float* grid_sums, int n_zones, int hc, int wc) {
  StatArgs st;
  st.masks = masks;
  st.row0 = row0;
  st.col0 = col0;
  st.zone_sums = zone_sums;
  st.grid_sums = grid_sums;
  st.n_zones = n_zones;
  st.hc = hc;
  st.wc = wc;
  return st;
}

template <typename Kernel>
int prepare(Kernel kernel, size_t smem) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  return (int)err;
}

Planes make_planes(const float* temp, const float* cnst, const float* denom,
                   const float* tinf, const float* coef, const float* ext,
                   const uint32_t* lead, const uint32_t* foll,
                   const int64_t* keys, const uint32_t* words, float* out,
                   int32_t* iters, int32_t* converged, int H, int W,
                   int edge_fill) {
  Planes p;
  p.temp = temp;
  p.cnst = cnst;
  p.denom = denom;
  p.tinf = tinf;
  p.coef = (const float4*)coef;
  p.ext = ext;
  p.lead = lead;
  p.foll = foll;
  p.keys = keys;
  p.words = words;
  p.out = out;
  p.iters = iters;
  p.converged = converged;
  p.H = H;
  p.W = W;
  p.edge_fill = edge_fill;
  return p;
}

// The arguments every launch checks: rounds, statistics windows, the
// packed stencil's alignment.
int check_args(const Planes& p, int n_rounds, int n_zones, int hc, int wc) {
  if (n_rounds < 0 || n_rounds > kMaxRounds) return (int)cudaErrorInvalidValue;
  if (n_zones < 0 || (n_zones > 0 && (hc < 1 || wc < 1 || hc > p.H || wc > p.W))) {
    return (int)cudaErrorInvalidValue;
  }
  if (p.coef == nullptr || ((uintptr_t)p.coef & 15)) return (int)cudaErrorInvalidValue;
  return 0;
}

// Thread blocks of `kernel` resident per SM at a launch's shape.
template <typename Kernel>
int resident_blocks(Kernel kernel, int threads, size_t smem) {
  int n = 0;
  if (prepare(kernel, smem)) return -1;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, threads, smem)) {
    return -1;
  }
  return n;
}

// Launch geometry of both bodies, E envs per block on an H x W grid
// (mirrored by physics/fdm_cuda.py run_geometry): const/denom staged in
// shared memory when 4 planes per env fit, else (E = 1 only)
// read from global memory; threads spread the runs evenly over as few
// passes (slots) as the instance's thread limit allows.
struct Geometry {
  int staged, threads, slots;
  size_t smem;
  RunGrid grid;
};

int run_geometry(int E, int H, int W, int edge_fill, Geometry* out) {
  if (E < 1 || E > kMaxEnvs || H < 1 || W < 1) {
    return (int)cudaErrorInvalidValue;
  }
  RunGrid g;
  g.H = H;
  g.W = W;
  g.hw = H * W;
  g.plane = (g.hw + 3) & ~3;
  g.row_blocks = (H + kRun - 1) / kRun;
  g.n_runs = g.row_blocks * W;
  g.edge_fill = edge_fill;
  const size_t plane_bytes = 4 * (size_t)g.plane;
  const size_t ext_bytes = ((size_t)g.n_runs + 15) & ~(size_t)15;
  const size_t dec_bytes = ((size_t)g.hw + 15) & ~(size_t)15;
  const size_t budget = kSmemPerBlock - kStaticSmem;
  const size_t staged = E * 4 * plane_bytes + ext_bytes;
  const size_t plain = E * 2 * plane_bytes + ext_bytes + dec_bytes;
  Geometry geo;
  if (staged <= budget) {
    geo.staged = 1;
    geo.smem = staged;
  } else if (E == 1 && plain <= budget) {
    geo.staged = 0;
    geo.smem = plain;
  } else {
    return (int)cudaErrorInvalidValue;
  }
  const int t_max = geo.staged && E <= 2 ? 512 : 1024;  // BodyShape
  geo.slots = (g.n_runs + t_max - 1) / t_max;
  const int per_slot = (g.n_runs + geo.slots - 1) / geo.slots;
  geo.threads = (per_slot + 31) / 32 * 32;
  g.step_b = geo.threads / W;
  g.step_x = geo.threads % W;
  geo.grid = g;
  *out = geo;
  return 0;
}

int max_envs(int H, int W) {
  Geometry geo;
  int e = kMaxEnvs;
  while (e > 1 && run_geometry(e, H, W, 0, &geo)) --e;
  return run_geometry(e, H, W, 0, &geo) ? 0 : e;
}

template <template <int, bool> class Op, typename... Args>
int with_body(int E, int staged, Args... args) {
  if (!staged) return E == 1 ? Op<1, false>::run(args...) : (int)cudaErrorInvalidValue;
  switch (E) {
    case 1: return Op<1, true>::run(args...);
    case 2: return Op<2, true>::run(args...);
    case 3: return Op<3, true>::run(args...);
    case 4: return Op<4, true>::run(args...);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <int E, bool STAGED>
struct ChebyOccupancy {
  static int run(const Geometry& geo) {
    return resident_blocks(fdm_cheby_body<E, STAGED>, geo.threads, geo.smem);
  }
};

template <int E, bool STAGED>
struct ChebyLaunch {
  static int run(const Geometry& geo, Planes p, ConvArgs cv, StatArgs st,
                 float threshold, int limit, float rho2, float omega0,
                 int check_every, int B, cudaStream_t stream) {
    auto kernel = fdm_cheby_body<E, STAGED>;
    int err = prepare(kernel, geo.smem);
    if (err) return err;
    FDM_LAUNCH(kernel, (B + E - 1) / E, geo.threads, geo.smem, stream)(
        p, cv, st, geo.grid, threshold, limit, rho2, omega0, check_every, B);
    return (int)cudaGetLastError();
  }
};

template <int E, bool STAGED>
struct JacobiOccupancy {
  static int run(const Geometry& geo, int rule) {
    if constexpr (E == 1) {
      if (rule == kSolo) {
        return resident_blocks(fdm_jacobi_body<1, STAGED, kSolo>, geo.threads, geo.smem);
      }
    }
    return resident_blocks(fdm_jacobi_body<E, STAGED, kBlock>, geo.threads, geo.smem);
  }
};

template <int E, bool STAGED, int RULE>
int launch_jacobi(const Geometry& geo, Planes p, ConvArgs cv, StatArgs st,
                  float threshold, int limit, int B, cudaStream_t stream) {
  auto kernel = fdm_jacobi_body<E, STAGED, RULE>;
  int err = prepare(kernel, geo.smem);
  if (err) return err;
  FDM_LAUNCH(kernel, (B + E - 1) / E, geo.threads, geo.smem, stream)(
      p, cv, st, geo.grid, threshold, limit, B);
  return (int)cudaGetLastError();
}

template <int E, bool STAGED>
struct JacobiLaunch {
  static int run(const Geometry& geo, int rule, Planes p, ConvArgs cv, StatArgs st,
                 float threshold, int limit, int B, cudaStream_t stream) {
    if constexpr (E == 1) {
      if (rule == kSolo) {
        return launch_jacobi<1, STAGED, kSolo>(geo, p, cv, st, threshold, limit, B, stream);
      }
    }
    return launch_jacobi<E, STAGED, kBlock>(geo, p, cv, st, threshold, limit, B, stream);
  }
};

// The swap offsets normalised to [0, H) x [0, W), so that a partner wraps
// by one conditional add.
void normalise_offsets(ConvArgs& cv, int H, int W) {
  for (int r = 0; r < cv.n_rounds; ++r) {
    cv.dy[r] = ((cv.dy[r] % H) + H) % H;
    cv.dx[r] = ((cv.dx[r] % W) + W) % W;
  }
}

// K1 (E = 1) and K4.
int cheby_launch(Planes p, ConvArgs cv, StatArgs st, int E, float threshold,
                 int limit, float rho2, float omega0, int check_every, int B,
                 cudaStream_t stream) {
  Geometry geo;
  int err = run_geometry(E, p.H, p.W, p.edge_fill, &geo);
  if (err) return err;
  if (check_every < 1) return (int)cudaErrorInvalidValue;
  normalise_offsets(cv, p.H, p.W);
  return with_body<ChebyLaunch>(E, geo.staged, geo, p, cv, st, threshold, limit, rho2,
                                omega0, check_every, B, stream);
}

// K2 (E = 1, kSolo) and K3 (kBlock).
int jacobi_launch(Planes p, ConvArgs cv, StatArgs st, int E, int rule,
                  float threshold, int limit, int B, cudaStream_t stream) {
  Geometry geo;
  int err = run_geometry(E, p.H, p.W, p.edge_fill, &geo);
  if (err) return err;
  normalise_offsets(cv, p.H, p.W);
  return with_body<JacobiLaunch>(E, geo.staged, geo, rule, p, cv, st, threshold, limit,
                                 B, stream);
}

// Launch geometry of the cluster bodies (mirrored by physics/fdm_cuda.py
// cluster_geometry): as many CTAs per env as row blocks, at most
// kClusterMax, each owning an even share of them; the threads spread a
// band's runs evenly over as few passes (slots) as kClusterThreads allow.
// Refuses a grid whose cells overflow a 32-bit index.
struct ClusterGeometry {
  int cluster, band_blocks, threads, slots;
  size_t smem;
  RunGrid grid;
};

int cluster_geometry(int H, int W, int edge_fill, ClusterGeometry* out) {
  if (H < 1 || W < 1 || (long long)H * W > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  RunGrid g;
  g.H = H;
  g.W = W;
  g.hw = H * W;
  g.plane = 0;  // the planes are in global memory
  g.row_blocks = (H + kRun - 1) / kRun;
  g.edge_fill = edge_fill;
  ClusterGeometry geo;
  geo.cluster = min(kClusterMax, g.row_blocks);
  geo.band_blocks = (g.row_blocks + geo.cluster - 1) / geo.cluster;
  geo.cluster = (g.row_blocks + geo.band_blocks - 1) / geo.band_blocks;
  g.n_runs = geo.band_blocks * W;  // a band's most runs
  geo.slots = (g.n_runs + kClusterThreads - 1) / kClusterThreads;
  const int per_slot = (g.n_runs + geo.slots - 1) / geo.slots;
  geo.threads = (per_slot + 31) / 32 * 32;
  g.step_b = geo.threads / W;
  g.step_x = geo.threads % W;
  geo.smem = sizeof(float) * kClusterScalars;
  geo.grid = g;
  *out = geo;
  return 0;
}

// The tile th x tw of a region with a halo of hy rows and hx columns on
// bands of `rows` rows of a W-wide grid, at `cell` bytes a region cell and
// `line` bytes a region row or column: of the tiles whose region fits
// `budget` bytes, with th and tw even shares of the band's rows and of W, the
// one whose regions load the fewest cells, into *th, *tw; returns those
// cells (the band's), 0 where no tile fits.
long long best_tile(int rows, int W, int hy, int hx, int cell, int line, size_t budget, int* th,
                    int* tw) {
  const long long cap = (long long)budget;  // cell * R * C + line * (R + C)
  long long best = 0;
  for (int nr = 1; nr <= min(rows, 256); ++nr) {
    const int h = (rows + nr - 1) / nr;
    if (nr > 1 && h == (rows + nr - 2) / (nr - 1)) continue;  // the same tiles
    const long long R = h + 2LL * hy;
    if (line * R >= cap) continue;
    long long w_max = (cap - line * R) / (cell * R + line) - 2LL * hx;
    if (w_max > W) w_max = W;
    if (w_max < 1) continue;
    const long long nc = (W + w_max - 1) / w_max;
    const long long load = (rows + nr * 2LL * hy) * (W + nc * 2LL * hx);
    if (best == 0 || load < best) {
      best = load;
      *th = h;
      *tw = (int)((W + nc - 1) / nc);
    }
  }
  return best;
}

// The tile of a swap group with reach (hy, hx) (tile_bytes).
long long swap_tile(int rows, int W, int hy, int hx, int* th, int* tw) {
  return best_tile(rows, W, hy, hx, 8, 8, kTileBytes, th, tw);
}

// The chunk plan of a Chebyshev cluster launch (see the note above the
// cluster constants; read by physics/fdm_cuda.py chunk_plan, its mirror,
// through fdm_cluster_chunk_plan): with check_every >= 2, the tile of
// halo check_every (chunk_bytes) on bands of `rows` rows; tw = 0 where
// check_every is 1 or no tile fits. *smem receives its region's bytes (0
// without).
ChunkPlan chunk_plan(int W, int rows, int check_every, size_t* smem) {
  ChunkPlan cp = {check_every, 0, 0};
  *smem = 0;
  if (check_every >= 2 &&
      best_tile(rows, W, check_every, check_every, kChunkCellBytes, kChunkLineBytes,
                kTileBytes, &cp.th, &cp.tw) > 0) {
    *smem = chunk_bytes(cp.th + 2 * check_every, cp.tw + 2 * check_every);
  } else {
    cp.th = cp.tw = 0;
  }
  return cp;
}

// The swap plan of a cluster launch (see the note above the cluster
// bodies; read by physics/fdm_cuda.py swap_plan through
// fdm_cluster_swap_plan): from round 0, each
// group takes consecutive rounds while its summed reach leaves a tile that
// loads at most kTileLoad times the band's cells; a round that admits none
// alone is a group of its own (tw = 0). cv's offsets are normalised; *smem
// receives the largest tile region's bytes (0 without tiles).
void swap_plan(const ConvArgs& cv, int H, int W, int rows, SwapPlan* plan, size_t* smem) {
  plan->n = 0;
  *smem = 0;
  int r = 0;
  while (r < cv.n_rounds) {
    SwapGroup sg = {r, r + 1, 0, 0, 0, 0};
    int hy = 0, hx = 0;
    for (int e = r; e < cv.n_rounds; ++e) {
      const int dy = torus_offset(cv.dy[e], H), dx = torus_offset(cv.dx[e], W);
      const int ny = hy + (dy < 0 ? -dy : dy), nx = hx + (dx < 0 ? -dx : dx);
      int th = 0, tw = 0;
      const long long load = swap_tile(rows, W, ny, nx, &th, &tw);
      if (load == 0 || load > (long long)kTileLoad * rows * W) break;
      hy = ny;
      hx = nx;
      sg = {r, e + 1, hy, hx, th, tw};
    }
    const size_t bytes = sg.tw > 0 ? tile_bytes(sg.th + 2 * sg.hy, sg.tw + 2 * sg.hx) : 0;
    if (bytes > *smem) *smem = bytes;
    plan->g[plan->n++] = sg;
    r = sg.r1;
  }
}

// The cluster bodies' launch: K1/K4 (cheby) or K2/K3 (rule) on a cluster
// per env, with the swap plan of its rounds and (cheby) the chunk plan; the
// spare plane is needed with either plan's tiles, the extra plane with the
// chunk passes'.
int cluster_launch(bool cheby, int rule, Planes p, ConvArgs cv, ClusterArgs ca,
                   float threshold, int limit, float rho2, float omega0, int check_every,
                   int B, cudaStream_t stream) {
  ClusterGeometry geo;
  int err = cluster_geometry(p.H, p.W, p.edge_fill, &geo);
  if (err) return err;
  if (B < 1 || (long long)B * geo.cluster > 0x7fffffffLL || check_every < 1) {
    return (int)cudaErrorInvalidValue;
  }
  normalise_offsets(cv, p.H, p.W);
  ca.cluster = geo.cluster;
  ca.band_blocks = geo.band_blocks;
  const int rows = min(p.H, geo.band_blocks * kRun);
  size_t tile = 0, chunk = 0;
  swap_plan(cv, p.H, p.W, rows, &ca.plan, &tile);
  ca.chunk = cheby ? chunk_plan(p.W, rows, check_every, &chunk) : ChunkPlan{1, 0, 0};
  const bool passes = ca.chunk.tw > 0;
  if (((cv.n_rounds > 0 || passes) && ca.spare == nullptr) || (passes && ca.extra == nullptr) ||
      ca.barriers == nullptr || ca.tiled == nullptr) {
    return (int)cudaErrorInvalidValue;
  }
  const size_t smem = geo.smem + max(tile, chunk);
  const int grid = B * geo.cluster;
  if (cheby) {
    err = prepare(fdm_cheby_cluster_body, smem);
    if (err) return err;
    return launch_cluster(fdm_cheby_cluster_body, grid, geo.cluster, geo.threads, smem,
                          stream, p, cv, geo.grid, ca, threshold, limit, rho2, omega0,
                          check_every);
  }
  if (rule == kSolo) {
    err = prepare(fdm_jacobi_cluster_body<kSolo>, smem);
    if (err) return err;
    return launch_cluster(fdm_jacobi_cluster_body<kSolo>, grid, geo.cluster, geo.threads,
                          smem, stream, p, cv, geo.grid, ca, threshold, limit);
  }
  err = prepare(fdm_jacobi_cluster_body<kBlock>, smem);
  if (err) return err;
  return launch_cluster(fdm_jacobi_cluster_body<kBlock>, grid, geo.cluster, geo.threads, smem,
                        stream, p, cv, geo.grid, ca, threshold, limit);
}

int export_geometry(int E, int H, int W, int* out) {
  Geometry geo;
  int err = run_geometry(E, H, W, 0, &geo);
  if (err) return err;
  const int v[8] = {geo.staged, geo.threads, geo.slots, (int)geo.smem,
                    geo.grid.row_blocks, geo.grid.n_runs, geo.grid.step_b,
                    geo.grid.step_x};
  for (int i = 0; i < 8; ++i) out[i] = v[i];
  return 0;
}

}  // namespace

extern "C" {

// Envs per thread block that the block kernels take on an H x W grid: K4
// (cheby) or K3 (jacobi), one geometry for both; 0 when not even one fits.
int fdm_cheby_max_envs(int H, int W) { return max_envs(H, W); }
int fdm_jacobi_max_envs(int H, int W) { return max_envs(H, W); }

// The launch geometry of the Chebyshev or the Jacobi body for E envs per
// block, into out[8]: staged, threads, slots, shared bytes, row blocks,
// runs, step_b, step_x.
int fdm_cheby_geometry(int E, int H, int W, int* out) {
  return export_geometry(E, H, W, out);
}
int fdm_jacobi_geometry(int E, int H, int W, int* out) {
  return export_geometry(E, H, W, out);
}

// Thread blocks resident per SM on an H x W grid: the Chebyshev (cheby)
// or Jacobi body, K4/K3 with `block_envs` envs per block, or K1/K2 when
// block_envs is 0; -1 on an error.
int fdm_blocks_per_sm(int cheby, int block_envs, int H, int W) {
  const int E = block_envs > 0 ? block_envs : 1;
  Geometry geo;
  if (run_geometry(E, H, W, 0, &geo)) return -1;
  if (cheby) return with_body<ChebyOccupancy>(E, geo.staged, geo);
  return with_body<JacobiOccupancy>(E, geo.staged, geo, block_envs > 0 ? kBlock : kSolo);
}

// Every launch takes the planes: temp, const, denom (B, H, W), tinf (B,),
// coef, the (H, W, 4) float plane of (a_r, a_l, a_b, a_t) per cell,
// 16-byte aligned, ext (H, W), the packed lead/follower masks, the keys or
// the word plane, and the outputs. `offsets` is a host array of
// 2 * n_rounds ints (dy, dx per round). The swap rounds read their
// decision bits from `words` (B, H, W) when it is not null, else make the
// mix32 words from `keys` (lane_bits, q); both may be null when
// n_rounds == 0, and the stat pointers when n_zones == 0 (the window must
// fit the grid: hc <= H, wc <= W). Returns a CUDA error code: the
// geometry's refusal, or cudaGetLastError() after the launch.
#define FDM_PLANE_PARAMS                                                      \
  const float *temp, const float *cnst, const float *denom,                   \
      const float *tinf, const float *coef, const float *ext,                 \
      const uint32_t *lead, const uint32_t *foll, const int64_t *keys,        \
      const uint32_t *words, float *out, int32_t *iters, int32_t *converged,  \
      int B, int H, int W, int edge_fill
#define FDM_TAIL_PARAMS                                                       \
  const int *offsets, int n_rounds, int lane_bits, int q, const float *masks, \
      const int32_t *row0, const int32_t *col0, float *zone_sums,             \
      float *grid_sums, int n_zones, int hc, int wc, void *stream
#define FDM_PREPARE_ARGS                                                      \
  Planes p = make_planes(temp, cnst, denom, tinf, coef, ext, lead, foll,      \
                         keys, words, out, iters, converged, H, W, edge_fill); \
  int err = check_args(p, n_rounds, n_zones, hc, wc);                         \
  if (err) return err;                                                        \
  ConvArgs cv = make_conv_args(offsets, n_rounds, lane_bits, q);              \
  StatArgs st = make_stat_args(masks, row0, col0, zone_sums, grid_sums,       \
                               n_zones, hc, wc)

// K2: the Jacobi body, one env per block, the solo stopping rule.
int fdm_jacobi_launch(FDM_PLANE_PARAMS, float threshold, int limit, FDM_TAIL_PARAMS) {
  FDM_PREPARE_ARGS;
  return jacobi_launch(p, cv, st, 1, kSolo, threshold, limit, B, (cudaStream_t)stream);
}

// K1: the Chebyshev body with one env per block.
int fdm_cheby_launch(FDM_PLANE_PARAMS, float threshold, int limit, float rho2,
                     float omega0, int check_every, FDM_TAIL_PARAMS) {
  FDM_PREPARE_ARGS;
  return cheby_launch(p, cv, st, 1, threshold, limit, rho2, omega0, check_every, B,
                      (cudaStream_t)stream);
}

// K3 and K4: as K2 / K1, with `block_envs` envs per thread block (1 ..
// fdm_jacobi_max_envs(H, W) for K3, 1 .. fdm_cheby_max_envs(H, W) for K4).
int fdm_jacobi_block_launch(FDM_PLANE_PARAMS, int block_envs, float threshold, int limit,
                            FDM_TAIL_PARAMS) {
  FDM_PREPARE_ARGS;
  return jacobi_launch(p, cv, st, block_envs, kBlock, threshold, limit, B,
                       (cudaStream_t)stream);
}

int fdm_cheby_block_launch(FDM_PLANE_PARAMS, int block_envs, float threshold, int limit,
                           float rho2, float omega0, int check_every, FDM_TAIL_PARAMS) {
  FDM_PREPARE_ARGS;
  return cheby_launch(p, cv, st, block_envs, threshold, limit, rho2, omega0, check_every,
                      B, (cudaStream_t)stream);
}

// The cluster launch geometry on an H x W grid into out[8]: cluster,
// band_blocks, threads, slots, shared bytes, row blocks, step_b, step_x.
int fdm_cluster_geometry(int H, int W, int* out) {
  ClusterGeometry geo;
  int err = cluster_geometry(H, W, 0, &geo);
  if (err) return err;
  const int v[8] = {geo.cluster, geo.band_blocks, geo.threads, geo.slots, (int)geo.smem,
                    geo.grid.row_blocks, geo.grid.step_b, geo.grid.step_x};
  for (int i = 0; i < 8; ++i) out[i] = v[i];
  return 0;
}

// The swap plan of the cluster bodies on an H x W grid for n_rounds
// offsets (2 * n_rounds ints, dy and dx per round) into out[2 + 6 *
// n_rounds]: groups, the tile's shared bytes, then r0, r1, hy, hx, th, tw
// per group.
int fdm_cluster_swap_plan(int H, int W, const int* offsets, int n_rounds, int* out) {
  ClusterGeometry geo;
  int err = cluster_geometry(H, W, 0, &geo);
  if (err) return err;
  if (n_rounds < 0 || n_rounds > kMaxRounds) return (int)cudaErrorInvalidValue;
  ConvArgs cv = make_conv_args(offsets, n_rounds, 8, 0);
  normalise_offsets(cv, H, W);
  SwapPlan plan;
  size_t tile = 0;
  swap_plan(cv, H, W, min(H, geo.band_blocks * kRun), &plan, &tile);
  out[0] = plan.n;
  out[1] = (int)tile;
  for (int k = 0; k < plan.n; ++k) {
    const SwapGroup& sg = plan.g[k];
    const int v[6] = {sg.r0, sg.r1, sg.hy, sg.hx, sg.th, sg.tw};
    for (int i = 0; i < 6; ++i) out[2 + 6 * k + i] = v[i];
  }
  return 0;
}

// The chunk plan of the Chebyshev cluster body on an H x W grid for
// `check_every` into out[4]: halo, th, tw (0: the chunks stream) and the
// tile region's shared bytes.
int fdm_cluster_chunk_plan(int H, int W, int check_every, int* out) {
  ClusterGeometry geo;
  int err = cluster_geometry(H, W, 0, &geo);
  if (err) return err;
  if (check_every < 1) return (int)cudaErrorInvalidValue;
  size_t bytes = 0;
  const ChunkPlan cp = chunk_plan(W, min(H, geo.band_blocks * kRun), check_every, &bytes);
  const int v[4] = {cp.halo, cp.th, cp.tw, (int)bytes};
  for (int i = 0; i < 4; ++i) out[i] = v[i];
  return 0;
}

// The cluster bodies, one cluster per env, for a plan above one block's
// shared memory (any plan whose cells a 32-bit index holds): the planes as
// for K1/K2, the solver's arguments, then `scratch` (B, H, W) float,
// `spare` (B, H, W) float (may be null when n_rounds == 0 and the chunks
// stream), `extra` (B, H, W) float (may be null when the chunks stream:
// fdm_cluster_chunk_plan), `barriers` and `tiled` (B,) int32 (each env's
// cluster barriers and the sub-iterations it ran in chunk passes), then
// the convection's arguments. No statistics. `rule` picks the Jacobi
// stopping rule: 0 K2's (solo), 1 K3's (block).
#define FDM_CLUSTER_PARAMS                                                          \
  float *scratch, float *spare, float *extra, int32_t *barriers, int32_t *tiled,    \
      const int *offsets, int n_rounds, int lane_bits, int q, void *stream
#define FDM_CLUSTER_PREPARE                                                      \
  Planes p = make_planes(temp, cnst, denom, tinf, coef, ext, lead, foll, keys,   \
                         words, out, iters, converged, H, W, edge_fill);         \
  int err = check_args(p, n_rounds, 0, 0, 0);                                    \
  if (err) return err;                                                           \
  ConvArgs cv = make_conv_args(offsets, n_rounds, lane_bits, q);                 \
  ClusterArgs ca = {};                                                           \
  ca.scratch = scratch;                                                          \
  ca.spare = spare;                                                              \
  ca.extra = extra;                                                              \
  ca.barriers = barriers;                                                        \
  ca.tiled = tiled

int fdm_cheby_cluster_launch(FDM_PLANE_PARAMS, float threshold, int limit, float rho2,
                             float omega0, int check_every, FDM_CLUSTER_PARAMS) {
  FDM_CLUSTER_PREPARE;
  return cluster_launch(true, kSolo, p, cv, ca, threshold, limit, rho2, omega0, check_every,
                        B, (cudaStream_t)stream);
}

int fdm_jacobi_cluster_launch(FDM_PLANE_PARAMS, int rule, float threshold, int limit,
                              FDM_CLUSTER_PARAMS) {
  FDM_CLUSTER_PREPARE;
  if (rule != kSolo && rule != kBlock) return (int)cudaErrorInvalidValue;
  return cluster_launch(false, rule, p, cv, ca, threshold, limit, 0.0f, 0.0f, 1, B,
                        (cudaStream_t)stream);
}

}  // extern "C"
