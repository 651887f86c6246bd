// FDM convergence loops for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of sbsim_tpu/physics/fdm_pallas.py:
//   fdm_cheby_kernel  (K1) <- _fdm_cheby_kernel_interleaved (:630) and its
//                        E=1 form _fdm_cheby_kernel (:279): Chebyshev
//                        semi-iteration of the Jacobi map, residual sampled
//                        every `check_every` sub-iterations, then J(x), the
//                        decision word and the swap rounds. One env per
//                        thread block.
//   fdm_jacobi_kernel (K2) <- _fdm_kernel (:207): Jacobi while
//                        it < limit and max|dx| > threshold, then the same
//                        convection epilogue. One env per thread block.
//   fdm_jacobi_block_kernel (K3) <- _fdm_kernel_block (:416) and
//   fdm_cheby_block_kernel  (K4) <- _fdm_cheby_kernel_block (:505): the
//                        stack layout, E envs per thread block sharing one
//                        loop (see "Block kernels" below).
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
// (H, W) float plane each per env (the five coefficient planes and the two
// convection word planes are shared by the batch and stay in L2): at the
// sb1 shapes 4 x 13,936 B x 2048 envs (12 zones, 34 us at 3.35 TB/s) or
// 4 x 93,744 B x 512 envs (126 rooms, 57 us). The arithmetic of the ~9
// Chebyshev sub-iterations an env needs there is of the same order at the
// float32 peak (about 40 us and 70 us), so neither bound dominates.
//
// The epilogue adds Z * hc * wc multiplies and about as many adds per env
// (at 12 zones of 14 x 14, 2,352 each against ~3,484 x 12 flops of one
// Jacobi sweep) and writes B * (Z + 1) floats.
//
// Design of K1/K2: the iterate and its partner plane live in dynamic
// shared memory for the whole loop (2 x 13.9 KB, or 2 x 93.7 KB = 187.5 KB
// at 126 rooms, under the 227 KB a block may use), so global memory is read
// once and written once per env; const, denom and the shared planes are
// re-read through the read-only cache. Each block loops on its own env until it
// converges, so batch composition cannot change a result (no padding,
// no freezing masks). The max-reduction runs only where the stopping rule
// samples it (every Jacobi iteration; the last sub-iteration of each
// Chebyshev chunk) and is exact (max does not depend on order).
//
// Numerics: built with -fmad=false and IEEE division, every cell update is
// the plain PyTorch version's sequence of float32 operations
// (physics/fdm_cuda.py: fdm_jacobi_plain / fdm_cheby_plain and their block
// forms), so the kernels equal them bitwise: a_r*x_r + a_l*x_l + a_b*x_b +
// a_t*x_t + const, then / denom; the Chebyshev update
// omega*(jx - x_prev) + x_prev, then the exterior re-pin.
//
// Block kernels (K3, K4). One thread block holds E envs: each env's iterate
// and its partner plane in dynamic shared memory (2 x H x W floats per
// env, so E <= 8 at 52 x 67 and E = 1 at 189 x 124; the wrapper clamps E).
// Each thread owns a fixed set of cells; per cell it reads the shared
// stencil planes once and applies them to every active env of the block.
// Per-env residual maxima stay in registers and are reduced for all E envs
// in one block pass (one pair of barriers per sample, not E). The loop runs
// while it < limit and any env of the block is active; an env whose
// residual met the threshold is frozen (skipped, its planes no longer
// swapped: a per-env parity bit says which slot holds its iterate), which
// equals the JAX select. Chebyshev samples the freeze only at the end of a
// chunk of `check_every` sub-iterations, and omega is one schedule for the
// block (all envs start at it = 1). Slots past B are inactive from the
// start. So each env's result equals K1/K2's for that env, bitwise.
// Bound as above (the same bytes and operations; a word plane adds 4 B per
// cell per env). The trade: at E = 8 one block of 1024 threads takes an
// SM's shared memory, and its 59-64 registers per thread allow one block
// per SM at every E > 2, where K1 runs four blocks of 448 threads per SM
// (fdm_blocks_per_sm reports it). The epilogue runs env by env.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxRounds = 32;
constexpr int kMaxThreads = 1024;

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
  const float* a_r;    // (H, W) shared
  const float* a_l;
  const float* a_b;
  const float* a_t;
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

// Block-wide max; every thread gets the result. Contains two barriers, so
// it also orders the shared-memory writes before it against reads after.
__device__ float block_max(float v, float* red) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = (blockDim.x + 31) >> 5;
  v = warp_max(v);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    float w = lane < n_warps ? red[lane] : 0.0f;
    w = warp_max(w);
    if (lane == 0) red[32] = w;
  }
  __syncthreads();
  return red[32];
}

// The shared stencil coefficients of one cell.
struct Stencil {
  float ar, al, ab, at;
  bool ext;
};

__device__ __forceinline__ Stencil load_stencil(const Planes& p, int c) {
  Stencil k;
  k.ar = __ldg(p.a_r + c);
  k.al = __ldg(p.a_l + c);
  k.ab = __ldg(p.a_b + c);
  k.at = __ldg(p.a_t + c);
  k.ext = __ldg(p.ext + c) > 0.0f;
  return k;
}

// One Jacobi update of cell c from plane x.
__device__ __forceinline__ float jacobi_at(const float* x, int c, int y,
                                           int xc, const Planes& p,
                                           const Stencil& k, float cnst,
                                           float denom, float tinf) {
  const int H = p.H, W = p.W;
  float xr, xl, xb, xt;
  if (p.edge_fill) {
    xr = xc + 1 < W ? x[c + 1] : tinf;
    xl = xc > 0 ? x[c - 1] : tinf;
    xb = y + 1 < H ? x[c + W] : tinf;
    xt = y > 0 ? x[c - W] : tinf;
  } else {
    // Rolls: wraparound reads land only in exterior cells, whose
    // coefficients are folded to (a = 0, denom = 1, const = tinf).
    xr = x[xc + 1 < W ? c + 1 : c + 1 - W];
    xl = x[xc > 0 ? c - 1 : c - 1 + W];
    xb = x[y + 1 < H ? c + W : xc];
    xt = x[y > 0 ? c - W : (H - 1) * W + xc];
  }
  float num = k.ar * xr;
  num = num + k.al * xl;
  num = num + k.ab * xb;
  num = num + k.at * xt;
  num = num + cnst;
  const float v = num / denom;
  if (p.edge_fill && k.ext) return tinf;
  return v;
}

__device__ __forceinline__ float jacobi_cell(const float* x, int c, int y,
                                             int xc, const Planes& p,
                                             const float* cnst,
                                             const float* denom, float tinf) {
  return jacobi_at(x, c, y, xc, p, load_stencil(p, c), __ldg(cnst + c),
                   __ldg(denom + c), tinf);
}

__device__ __forceinline__ uint32_t fmix32(uint32_t x) {
  x = (x ^ (x >> 16)) * 0x85EBCA6Bu;
  x = (x ^ (x >> 13)) * 0xC2B2AE35u;
  return x ^ (x >> 16);
}

// Bit r of the decision word of `cell`: read from the env's word plane
// `wrd` when there is one, else the mix32 word (decision_word_from_key).
__device__ __forceinline__ bool swap_decision(uint32_t cell, int r,
                                              uint32_t k0, uint32_t k1,
                                              int hw, const ConvArgs& cv,
                                              const uint32_t* wrd) {
  if (wrd != nullptr) return (__ldg(wrd + cell) >> r) & 1u;
  const int lanes = 32 / cv.lane_bits;
  const int plane = r / lanes;
  const int lane = r - plane * lanes;
  const uint32_t idx = cell + (uint32_t)plane * (uint32_t)hw;
  const uint32_t bits = fmix32(fmix32(idx ^ k0) ^ k1);
  const uint32_t mask = (1u << cv.lane_bits) - 1u;
  return ((bits >> (cv.lane_bits * lane)) & mask) < (uint32_t)cv.q;
}

// The R swap rounds (_kernel_apply_swaps): each round reads the field as
// it was before the round, so rounds ping-pong between the two planes.
// Returns the plane that holds the result.
__device__ float* apply_swaps(float* src, float* dst, const Planes& p,
                              const ConvArgs& cv, uint32_t k0, uint32_t k1,
                              const uint32_t* wrd) {
  const int H = p.H, W = p.W, hw = H * W;
  for (int r = 0; r < cv.n_rounds; ++r) {
    const uint32_t bit = 1u << r;
    const int dy = cv.dy[r], dx = cv.dx[r];
    for (int c = threadIdx.x; c < hw; c += blockDim.x) {
      const int y = c / W, xc = c - y * W;
      float v = src[c];
      if ((__ldg(p.lead + c) & bit) && swap_decision(c, r, k0, k1, hw, cv, wrd)) {
        // lead: take the follower's value, x[y + dy, x + dx]
        const int yy = (y + dy + H) % H, xx = (xc + dx + W) % W;
        v = src[yy * W + xx];
      }
      if (__ldg(p.foll + c) & bit) {
        // follower of the lead at (y - dy, x - dx): swap if that lead does
        const int yy = (y - dy + H) % H, xx = (xc - dx + W) % W;
        const int lead_cell = yy * W + xx;
        if (swap_decision(lead_cell, r, k0, k1, hw, cv, wrd)) {
          v = src[lead_cell];
        }
      }
      dst[c] = v;
    }
    __syncthreads();
    float* t = src;
    src = dst;
    dst = t;
  }
  return src;
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

// Convection, the output and the statistics of env b's final field; the
// caller writes the iteration count and flag.
__device__ void epilogue(float* field, float* spare, const Planes& p,
                         const ConvArgs& cv, const StatArgs& st, int b) {
  const int hw = p.H * p.W;
  if (cv.n_rounds > 0) {
    uint32_t k0 = 0, k1 = 0;
    const uint32_t* wrd = nullptr;
    if (p.words != nullptr) {
      wrd = p.words + (size_t)b * hw;
    } else {
      k0 = (uint32_t)p.keys[2 * b];
      k1 = (uint32_t)p.keys[2 * b + 1];
    }
    float* result = apply_swaps(field, spare, p, cv, k0, k1, wrd);
    if (result != field) spare = field;
    field = result;
  }
  float* out = p.out + (size_t)b * hw;
  for (int c = threadIdx.x; c < hw; c += blockDim.x) out[c] = field[c];
  if (st.n_zones > 0) {
    __syncthreads();  // the field is written out before the grid fold
    grid_stats(field, spare, p, st, b);
  }
}

__global__ void __launch_bounds__(kMaxThreads)
    fdm_jacobi_kernel(Planes p, ConvArgs cv, StatArgs st, float threshold,
                      int limit) {
  extern __shared__ float smem[];
  __shared__ float red[33];
  const int b = blockIdx.x;
  const int W = p.W, hw = p.H * p.W;
  const float* cnst = p.cnst + (size_t)b * hw;
  const float* denom = p.denom + (size_t)b * hw;
  const float tinf = p.tinf[b];
  float* x = smem;
  float* xn = smem + hw;
  const float* t0 = p.temp + (size_t)b * hw;
  for (int c = threadIdx.x; c < hw; c += blockDim.x) x[c] = t0[c];
  __syncthreads();

  float delta = threshold + 1.0f;
  int it = 0;
  while (it < limit && delta > threshold) {
    float m = 0.0f;
    for (int c = threadIdx.x; c < hw; c += blockDim.x) {
      const int y = c / W;
      const float v = jacobi_cell(x, c, y, c - y * W, p, cnst, denom, tinf);
      xn[c] = v;
      m = nan_max(m, fabsf(v - x[c]));
    }
    delta = block_max(m, red);
    float* t = x;
    x = xn;
    xn = t;
    ++it;
  }
  if (threadIdx.x == 0) {
    p.iters[b] = it;
    p.converged[b] = delta <= threshold ? 1 : 0;
  }
  epilogue(x, xn, p, cv, st, b);
}

__global__ void __launch_bounds__(kMaxThreads)
    fdm_cheby_kernel(Planes p, ConvArgs cv, StatArgs st, float threshold,
                     int limit, float rho2, float omega0, int check_every) {
  extern __shared__ float smem[];
  __shared__ float red[33];
  const int b = blockIdx.x;
  const int W = p.W, hw = p.H * p.W;
  const float* cnst = p.cnst + (size_t)b * hw;
  const float* denom = p.denom + (size_t)b * hw;
  const float tinf = p.tinf[b];
  float* x_prev = smem;
  float* x = smem + hw;
  const float* t0 = p.temp + (size_t)b * hw;
  for (int c = threadIdx.x; c < hw; c += blockDim.x) x_prev[c] = t0[c];
  __syncthreads();

  // x1 = J(x0), delta0 = max |x1 - x0|.
  float m = 0.0f;
  for (int c = threadIdx.x; c < hw; c += blockDim.x) {
    const int y = c / W;
    const float v = jacobi_cell(x_prev, c, y, c - y * W, p, cnst, denom, tinf);
    x[c] = v;
    m = nan_max(m, fabsf(v - x_prev[c]));
  }
  float delta = block_max(m, red);
  bool done = delta <= threshold;
  int it = 1;
  int n_iter = 1;
  float omega = omega0;
  while (it < limit && !done) {
    for (int k = 0; k < check_every; ++k) {
      const float omega_next = 1.0f / (1.0f - rho2 * omega / 4.0f);
      const bool sample = k == check_every - 1;
      m = 0.0f;
      for (int c = threadIdx.x; c < hw; c += blockDim.x) {
        const int y = c / W;
        const float jx = jacobi_cell(x, c, y, c - y * W, p, cnst, denom, tinf);
        const float xp = x_prev[c];
        float v = omega_next * (jx - xp) + xp;
        if (__ldg(p.ext + c) > 0.0f) v = tinf;
        if (sample) m = nan_max(m, fabsf(jx - x[c]));
        // x_next overwrites x_prev in place: cell c reads only x_prev[c].
        x_prev[c] = v;
      }
      if (sample) {
        delta = block_max(m, red);
      } else {
        __syncthreads();
      }
      float* t = x_prev;
      x_prev = x;
      x = t;
      ++it;
      omega = omega_next;
    }
    n_iter = it;
    done = delta <= threshold;
  }
  // Emit J(x_final) into the spare plane.
  for (int c = threadIdx.x; c < hw; c += blockDim.x) {
    const int y = c / W;
    x_prev[c] = jacobi_cell(x, c, y, c - y * W, p, cnst, denom, tinf);
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    p.iters[b] = n_iter;
    p.converged[b] = done ? 1 : 0;
  }
  epilogue(x_prev, x, p, cv, st, b);
}

// ---------------------------------------------------------------------------
// Block kernels: E envs per thread block (the stack layout)
// ---------------------------------------------------------------------------

constexpr int kMaxBlockEnvs = 8;
// Static shared memory the launcher reserves beside the E x 2 planes
// (the red[E][33] scratch, at most 1,056 B).
constexpr int kBlockStaticSmem = 2048;
constexpr int kSmemPerBlock = 232448;

// Block-wide max of each active env's m[e] (bit e of `envs`), for all of
// them in one pass: every warp reduces each env in registers, then warp w
// reduces the per-warp maxima of envs w, w + n_warps, ... Two barriers, so
// it also orders the shared-memory writes before it against reads after.
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

// Slot s (0 or 1) of env e's two planes.
__device__ __forceinline__ float* env_plane(float* smem, int e, int s, int hw) {
  return smem + (size_t)(2 * e + s) * hw;
}

// Writes each valid env's count and flag, then runs the epilogue env by
// env on its final field (slot `(field_slots >> e) & 1`, the other slot is
// its scratch).
template <int E>
__device__ __forceinline__ void block_finish(float* smem, const Planes& p, const ConvArgs& cv,
                             const StatArgs& st, int b0, int n_env,
                             unsigned field_slots, const int (&iters)[E],
                             unsigned conv) {
  const int hw = p.H * p.W;
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
    const int s = (field_slots >> e) & 1u;
    epilogue(env_plane(smem, e, s, hw), env_plane(smem, e, 1 - s, hw), p, cv,
             st, b0 + e);
  }
}

// K3: _fdm_kernel_block. Per env: Jacobi while it < limit and the env has
// not met the threshold; the block loops while any env is active.
template <int E>
__global__ void __launch_bounds__(kMaxThreads)
    fdm_jacobi_block_kernel(Planes p, ConvArgs cv, StatArgs st,
                            float threshold, int limit, int B) {
  extern __shared__ float smem[];
  __shared__ float red[E][33];
  const int b0 = blockIdx.x * E;
  const int n_env = min(E, B - b0);
  const int W = p.W, hw = p.H * p.W;
  float tinf[E];
#pragma unroll
  for (int e = 0; e < E; ++e) tinf[e] = e < n_env ? p.tinf[b0 + e] : 0.0f;
  for (int e = 0; e < n_env; ++e) {
    const float* t0 = p.temp + (size_t)(b0 + e) * hw;
    float* x = env_plane(smem, e, 0, hw);
    for (int c = threadIdx.x; c < hw; c += blockDim.x) x[c] = t0[c];
  }
  __syncthreads();

  unsigned active = (1u << n_env) - 1u;
  unsigned slots = 0;  // bit e: env e's iterate is in its slot 1
  unsigned conv = 0;
  int iters[E];
#pragma unroll
  for (int e = 0; e < E; ++e) iters[e] = 0;
  int it = 0;
  while (it < limit && active) {
    float m[E];
#pragma unroll
    for (int e = 0; e < E; ++e) m[e] = 0.0f;
    for (int c = threadIdx.x; c < hw; c += blockDim.x) {
      const int y = c / W, xc = c - y * W;
      const Stencil k = load_stencil(p, c);
#pragma unroll
      for (int e = 0; e < E; ++e) {
        if (!((active >> e) & 1u)) continue;
        const int s = (slots >> e) & 1u;
        const float* x = env_plane(smem, e, s, hw);
        const size_t g = (size_t)(b0 + e) * hw + c;
        const float v = jacobi_at(x, c, y, xc, p, k, __ldg(p.cnst + g),
                                  __ldg(p.denom + g), tinf[e]);
        env_plane(smem, e, 1 - s, hw)[c] = v;
        m[e] = nan_max(m[e], fabsf(v - x[c]));
      }
    }
    block_max_envs<E>(m, red, active);
    const unsigned stepped = active;
    slots ^= stepped;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      if ((stepped >> e) & 1u) {
        iters[e] = it + 1;
        if (m[e] <= threshold) {
          conv |= 1u << e;
          active &= ~(1u << e);
        }
      }
    }
    ++it;
  }
  block_finish<E>(smem, p, cv, st, b0, n_env, slots, iters, conv);
}

// K4: _fdm_cheby_kernel_block. The freeze state is fixed for each chunk of
// `check_every` sub-iterations and sampled at its last one; omega advances
// once per sub-iteration for the whole block.
template <int E>
__global__ void __launch_bounds__(kMaxThreads)
    fdm_cheby_block_kernel(Planes p, ConvArgs cv, StatArgs st,
                           float threshold, int limit, float rho2,
                           float omega0, int check_every, int B) {
  extern __shared__ float smem[];
  __shared__ float red[E][33];
  const int b0 = blockIdx.x * E;
  const int n_env = min(E, B - b0);
  const int W = p.W, hw = p.H * p.W;
  const unsigned valid = (1u << n_env) - 1u;
  float tinf[E];
#pragma unroll
  for (int e = 0; e < E; ++e) tinf[e] = e < n_env ? p.tinf[b0 + e] : 0.0f;
  for (int e = 0; e < n_env; ++e) {
    const float* t0 = p.temp + (size_t)(b0 + e) * hw;
    float* x0 = env_plane(smem, e, 0, hw);
    for (int c = threadIdx.x; c < hw; c += blockDim.x) x0[c] = t0[c];
  }
  __syncthreads();

  // x1 = J(x0) into slot 1, delta0 = max |x1 - x0|.
  float m[E];
#pragma unroll
  for (int e = 0; e < E; ++e) m[e] = 0.0f;
  for (int c = threadIdx.x; c < hw; c += blockDim.x) {
    const int y = c / W, xc = c - y * W;
    const Stencil k = load_stencil(p, c);
#pragma unroll
    for (int e = 0; e < E; ++e) {
      if (!((valid >> e) & 1u)) continue;
      const float* x0 = env_plane(smem, e, 0, hw);
      const size_t g = (size_t)(b0 + e) * hw + c;
      const float v = jacobi_at(x0, c, y, xc, p, k, __ldg(p.cnst + g),
                                __ldg(p.denom + g), tinf[e]);
      env_plane(smem, e, 1, hw)[c] = v;
      m[e] = nan_max(m[e], fabsf(v - x0[c]));
    }
  }
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
      for (int c = threadIdx.x; c < hw; c += blockDim.x) {
        const int y = c / W, xc = c - y * W;
        const Stencil k = load_stencil(p, c);
#pragma unroll
        for (int e = 0; e < E; ++e) {
          if (!((chunk >> e) & 1u)) continue;
          const int s = (prev_slots >> e) & 1u;
          float* x_prev = env_plane(smem, e, s, hw);
          const float* x = env_plane(smem, e, 1 - s, hw);
          const size_t g = (size_t)(b0 + e) * hw + c;
          const float jx = jacobi_at(x, c, y, xc, p, k, __ldg(p.cnst + g),
                                     __ldg(p.denom + g), tinf[e]);
          const float xp = x_prev[c];
          float v = omega_next * (jx - xp) + xp;
          if (k.ext) v = tinf[e];
          if (sample) m[e] = nan_max(m[e], fabsf(jx - x[c]));
          // x_next overwrites x_prev in place: cell c reads only x_prev[c].
          x_prev[c] = v;
        }
      }
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
  for (int c = threadIdx.x; c < hw; c += blockDim.x) {
    const int y = c / W, xc = c - y * W;
    const Stencil k = load_stencil(p, c);
#pragma unroll
    for (int e = 0; e < E; ++e) {
      if (!((valid >> e) & 1u)) continue;
      const int s = (prev_slots >> e) & 1u;
      const float* x = env_plane(smem, e, 1 - s, hw);
      const size_t g = (size_t)(b0 + e) * hw + c;
      env_plane(smem, e, s, hw)[c] = jacobi_at(
          x, c, y, xc, p, k, __ldg(p.cnst + g), __ldg(p.denom + g), tinf[e]);
    }
  }
  __syncthreads();
  block_finish<E>(smem, p, cv, st, b0, n_env, prev_slots, iters, done);
}

int block_threads(int hw) {
  int t = ((hw / 8 + 31) / 32) * 32;
  if (t < 128) t = 128;
  if (t > kMaxThreads) t = kMaxThreads;
  return t;
}

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
                   const float* tinf, const float* a_r, const float* a_l,
                   const float* a_b, const float* a_t, const float* ext,
                   const uint32_t* lead, const uint32_t* foll,
                   const int64_t* keys, const uint32_t* words, float* out,
                   int32_t* iters, int32_t* converged, int H, int W,
                   int edge_fill) {
  Planes p;
  p.temp = temp;
  p.cnst = cnst;
  p.denom = denom;
  p.tinf = tinf;
  p.a_r = a_r;
  p.a_l = a_l;
  p.a_b = a_b;
  p.a_t = a_t;
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

// Envs per thread block that the block kernels take on an H x W grid.
int block_envs_fit(int H, int W) {
  const long per_env = 2L * H * W * (long)sizeof(float);
  const long fit = (kSmemPerBlock - kBlockStaticSmem) / per_env;
  return (int)(fit < kMaxBlockEnvs ? fit : kMaxBlockEnvs);
}

template <template <int> class Launch, typename... Args>
int launch_block(int E, Args... args) {
  switch (E) {
    case 1: return Launch<1>::run(args...);
    case 2: return Launch<2>::run(args...);
    case 3: return Launch<3>::run(args...);
    case 4: return Launch<4>::run(args...);
    case 5: return Launch<5>::run(args...);
    case 6: return Launch<6>::run(args...);
    case 7: return Launch<7>::run(args...);
    case 8: return Launch<8>::run(args...);
    default: return (int)cudaErrorInvalidValue;
  }
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

template <int E>
struct BlockOccupancy {
  static int run(int cheby, int H, int W) {
    const size_t smem = 2 * (size_t)E * H * W * sizeof(float);
    const int threads = block_threads(E * H * W);
    return cheby ? resident_blocks(fdm_cheby_block_kernel<E>, threads, smem)
                 : resident_blocks(fdm_jacobi_block_kernel<E>, threads, smem);
  }
};

template <int E>
struct JacobiBlock {
  static int run(Planes p, ConvArgs cv, StatArgs st, float threshold,
                 int limit, int B, cudaStream_t stream) {
    const size_t smem = 2 * (size_t)E * p.H * p.W * sizeof(float);
    int err = prepare(fdm_jacobi_block_kernel<E>, smem);
    if (err) return err;
    const int grid = (B + E - 1) / E;
    fdm_jacobi_block_kernel<E>
        <<<grid, block_threads(E * p.H * p.W), smem, stream>>>(
            p, cv, st, threshold, limit, B);
    return (int)cudaGetLastError();
  }
};

template <int E>
struct ChebyBlock {
  static int run(Planes p, ConvArgs cv, StatArgs st, float threshold,
                 int limit, float rho2, float omega0, int check_every, int B,
                 cudaStream_t stream) {
    const size_t smem = 2 * (size_t)E * p.H * p.W * sizeof(float);
    int err = prepare(fdm_cheby_block_kernel<E>, smem);
    if (err) return err;
    const int grid = (B + E - 1) / E;
    fdm_cheby_block_kernel<E>
        <<<grid, block_threads(E * p.H * p.W), smem, stream>>>(
            p, cv, st, threshold, limit, rho2, omega0, check_every, B);
    return (int)cudaGetLastError();
  }
};

}  // namespace

extern "C" {

// Envs per thread block that the block kernels take on an H x W grid.
int fdm_block_max_envs(int H, int W) { return block_envs_fit(H, W); }

// Thread blocks resident per SM on an H x W grid: the Chebyshev (cheby)
// or Jacobi kernel, K4/K3 with `block_envs` envs per block, or K1/K2 when
// block_envs is 0; -1 on an error.
int fdm_blocks_per_sm(int cheby, int block_envs, int H, int W) {
  if (block_envs > 0) {
    if (block_envs > block_envs_fit(H, W)) return -1;
    return launch_block<BlockOccupancy>(block_envs, cheby, H, W);
  }
  const size_t smem = 2 * (size_t)H * W * sizeof(float);
  const int threads = block_threads(H * W);
  return cheby ? resident_blocks(fdm_cheby_kernel, threads, smem)
               : resident_blocks(fdm_jacobi_kernel, threads, smem);
}

// Largest H * W the kernels accept (two planes in shared memory).
int fdm_max_cells() { return (232448 - 1024) / (2 * (int)sizeof(float)); }

// `offsets` is a host array of 2 * n_rounds ints (dy, dx per round). The
// swap rounds read their decision bits from `words` (B, H, W) when it is
// not null, else make the mix32 words from `keys` (lane_bits, q); both may
// be null when n_rounds == 0, and the stat pointers when n_zones == 0 (the
// window must fit the grid: hc <= H, wc <= W). Returns cudaGetLastError().
int fdm_jacobi_launch(const float* temp, const float* cnst, const float* denom,
                      const float* tinf, const float* a_r, const float* a_l,
                      const float* a_b, const float* a_t, const float* ext,
                      const uint32_t* lead, const uint32_t* foll,
                      const int64_t* keys, const uint32_t* words, float* out,
                      int32_t* iters, int32_t* converged, int B, int H, int W,
                      int edge_fill, float threshold, int limit,
                      const int* offsets, int n_rounds, int lane_bits, int q,
                      const float* masks, const int32_t* row0,
                      const int32_t* col0, float* zone_sums, float* grid_sums,
                      int n_zones, int hc, int wc, void* stream) {
  if (n_rounds < 0 || n_rounds > kMaxRounds) return (int)cudaErrorInvalidValue;
  if (n_zones < 0 || (n_zones > 0 && (hc < 1 || wc < 1 || hc > H || wc > W))) {
    return (int)cudaErrorInvalidValue;
  }
  const size_t smem = 2 * (size_t)H * W * sizeof(float);
  int err = prepare(fdm_jacobi_kernel, smem);
  if (err) return err;
  Planes p = make_planes(temp, cnst, denom, tinf, a_r, a_l, a_b, a_t, ext,
                         lead, foll, keys, words, out, iters, converged, H,
                         W, edge_fill);
  ConvArgs cv = make_conv_args(offsets, n_rounds, lane_bits, q);
  StatArgs st = make_stat_args(masks, row0, col0, zone_sums, grid_sums,
                               n_zones, hc, wc);
  fdm_jacobi_kernel<<<B, block_threads(H * W), smem, (cudaStream_t)stream>>>(
      p, cv, st, threshold, limit);
  return (int)cudaGetLastError();
}

int fdm_cheby_launch(const float* temp, const float* cnst, const float* denom,
                     const float* tinf, const float* a_r, const float* a_l,
                     const float* a_b, const float* a_t, const float* ext,
                     const uint32_t* lead, const uint32_t* foll,
                     const int64_t* keys, const uint32_t* words, float* out,
                     int32_t* iters, int32_t* converged, int B, int H, int W,
                     int edge_fill, float threshold, int limit, float rho2,
                     float omega0,
                     int check_every, const int* offsets, int n_rounds,
                     int lane_bits, int q, const float* masks,
                     const int32_t* row0, const int32_t* col0,
                     float* zone_sums, float* grid_sums, int n_zones, int hc,
                     int wc, void* stream) {
  if (n_rounds < 0 || n_rounds > kMaxRounds || check_every < 1) {
    return (int)cudaErrorInvalidValue;
  }
  if (n_zones < 0 || (n_zones > 0 && (hc < 1 || wc < 1 || hc > H || wc > W))) {
    return (int)cudaErrorInvalidValue;
  }
  const size_t smem = 2 * (size_t)H * W * sizeof(float);
  int err = prepare(fdm_cheby_kernel, smem);
  if (err) return err;
  Planes p = make_planes(temp, cnst, denom, tinf, a_r, a_l, a_b, a_t, ext,
                         lead, foll, keys, words, out, iters, converged, H,
                         W, edge_fill);
  ConvArgs cv = make_conv_args(offsets, n_rounds, lane_bits, q);
  StatArgs st = make_stat_args(masks, row0, col0, zone_sums, grid_sums,
                               n_zones, hc, wc);
  fdm_cheby_kernel<<<B, block_threads(H * W), smem, (cudaStream_t)stream>>>(
      p, cv, st, threshold, limit, rho2, omega0, check_every);
  return (int)cudaGetLastError();
}

// As fdm_jacobi_launch / fdm_cheby_launch, with `block_envs` envs per
// thread block (1 .. fdm_block_max_envs(H, W)).
int fdm_jacobi_block_launch(
    const float* temp, const float* cnst, const float* denom,
    const float* tinf, const float* a_r, const float* a_l, const float* a_b,
    const float* a_t, const float* ext, const uint32_t* lead,
    const uint32_t* foll, const int64_t* keys, const uint32_t* words,
    float* out, int32_t* iters, int32_t* converged, int B, int H, int W,
    int edge_fill, int block_envs, float threshold, int limit,
    const int* offsets, int n_rounds, int lane_bits, int q,
    const float* masks, const int32_t* row0, const int32_t* col0,
    float* zone_sums, float* grid_sums, int n_zones, int hc, int wc,
    void* stream) {
  if (n_rounds < 0 || n_rounds > kMaxRounds) return (int)cudaErrorInvalidValue;
  if (n_zones < 0 || (n_zones > 0 && (hc < 1 || wc < 1 || hc > H || wc > W))) {
    return (int)cudaErrorInvalidValue;
  }
  if (block_envs < 1 || block_envs > fdm_block_max_envs(H, W)) {
    return (int)cudaErrorInvalidValue;
  }
  Planes p = make_planes(temp, cnst, denom, tinf, a_r, a_l, a_b, a_t, ext,
                         lead, foll, keys, words, out, iters, converged, H,
                         W, edge_fill);
  ConvArgs cv = make_conv_args(offsets, n_rounds, lane_bits, q);
  StatArgs st = make_stat_args(masks, row0, col0, zone_sums, grid_sums,
                               n_zones, hc, wc);
  return launch_block<JacobiBlock>(block_envs, p, cv, st, threshold, limit, B,
                                   (cudaStream_t)stream);
}

int fdm_cheby_block_launch(
    const float* temp, const float* cnst, const float* denom,
    const float* tinf, const float* a_r, const float* a_l, const float* a_b,
    const float* a_t, const float* ext, const uint32_t* lead,
    const uint32_t* foll, const int64_t* keys, const uint32_t* words,
    float* out, int32_t* iters, int32_t* converged, int B, int H, int W,
    int edge_fill, int block_envs, float threshold, int limit, float rho2,
    float omega0, int check_every, const int* offsets, int n_rounds,
    int lane_bits, int q, const float* masks, const int32_t* row0,
    const int32_t* col0, float* zone_sums, float* grid_sums, int n_zones,
    int hc, int wc, void* stream) {
  if (n_rounds < 0 || n_rounds > kMaxRounds || check_every < 1) {
    return (int)cudaErrorInvalidValue;
  }
  if (n_zones < 0 || (n_zones > 0 && (hc < 1 || wc < 1 || hc > H || wc > W))) {
    return (int)cudaErrorInvalidValue;
  }
  if (block_envs < 1 || block_envs > fdm_block_max_envs(H, W)) {
    return (int)cudaErrorInvalidValue;
  }
  Planes p = make_planes(temp, cnst, denom, tinf, a_r, a_l, a_b, a_t, ext,
                         lead, foll, keys, words, out, iters, converged, H,
                         W, edge_fill);
  ConvArgs cv = make_conv_args(offsets, n_rounds, lane_bits, q);
  StatArgs st = make_stat_args(masks, row0, col0, zone_sums, grid_sums,
                               n_zones, hc, wc);
  return launch_block<ChebyBlock>(block_envs, p, cv, st, threshold, limit,
                                  rho2, omega0, check_every, B,
                                  (cudaStream_t)stream);
}

}  // extern "C"
