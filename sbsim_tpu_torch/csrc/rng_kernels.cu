// Counter-based draws of the port's threefry generator for Hopper (sm_90a).
//
// Replaces no Pallas kernel. XLA compiles each jax.random draw into one
// fusion; the port's plain versions (rng.py, `*_plain`) compute
// threefry2x32 as int64 elementwise ops masked to 32 bits (PyTorch has no
// uint32 shifts on the CPU), some 180-580 launches per draw. Here each draw
// is one launch: one thread per output element, a grid-stride loop where
// the output outgrows kMaxBlocks blocks, the cipher in uint32 registers,
// and the draw's epilogue in the same thread:
//   kPairs    split, fold_in: both words of threefry2x32(key, (0, c0 + i));
//   kBits     bits: x0 ^ x1 of threefry2x32(key, (0, i));
//   kUniform  uniform: a float in [1, 2) from the word's top 23 bits, minus
//             one, then max(lo, f * (hi - lo) + lo) with the multiply-add
//             fused, as XLA compiles jax.random.uniform;
//   kNormal   normal: that uniform on (nextafter(-1, 0), 1), XLA's float32
//             erfinv (Giles' polynomials) and a multiply by sqrt(2);
//   kRandint  randint: jax.random.randint's 64 bits per value, from the
//             two keys of split(key), reduced modulo the span; the bounds
//             are values or device tensors (a captured program cannot
//             read a replay ring's size back to the host).
// Each float operation is the rounded intrinsic of the PyTorch op that the
// plain version runs (__fsub_rn, __fmul_rn, __fadd_rn; __fmaf_rn for the
// fused multiply-add that the plain version emulates in float64). The
// intrinsics alone carry the bitwise result: nvcc never contracts them, so
// the library is built with nvcc's default -fmad, as PyTorch's kernels
// are; log1pf and sqrtf are the CUDA math library's, which torch.log1p
// and torch.sqrt call. Every draw equals its plain version bitwise.
//
// Bound: one threefry2x32 is ~75 integer operations (20 rounds of an add,
// a funnel-shift rotate and an xor, and the key injections), 3.9 per
// output byte of `bits` (8 bytes a word); the H100's integer pipes (64
// operations per SM per clock, ~16.7 T/s at 1.98 GHz) bound a large draw
// at ~0.22 G words per ms, its bytes (3.35 TB/s) at ~0.42 G. At the
// call sites' sizes (8k-64k outputs) a draw is one kernel node's launch.
//
// Keys are int64 tensors of uint32 values, read through the wrapper's
// strides (key b's words at keys[b * key_stride] and one word_stride
// further), so a view such as `sub[:, i]` is read in place.

#ifdef RNG_HOST_REHEARSAL
// Host C++ build of the same source (tests/test_torch_rng_host.py): the
// stub runs a launch's threads one after another.
#include "rng_host_stub.h"
#else
#include <cuda_runtime.h>
#include <stdint.h>

#define RNG_LAUNCH(kernel, grid, threads, stream) kernel<<<grid, threads, 0, stream>>>
#endif

namespace {

constexpr int kThreads = 256;
// 8 blocks of 256 threads fill an SM's 2,048; 8,192 blocks are ~8 waves of
// the H100's 132 SMs, past which each thread loops over further outputs.
constexpr int64_t kMaxBlocks = 8192;

enum Kind { kPairs = 0, kBits = 1, kUniform = 2, kNormal = 3, kRandint = 4 };

// One randint bound: `value` where `ptr` is null, else an int32 or int64
// (`bytes`) device value, the same for every output (`step` 0) or one per
// output (`step` 1); clamped to the int32 range, as the plain version does.
struct Bound {
  const void* ptr;
  int bytes;
  int64_t step;
  int64_t value;
};

struct Draw {
  const int64_t* keys;
  int64_t key_stride, word_stride;
  int64_t n_keys, per_key;  // outputs per key (pairs for kPairs)
  uint32_t counter0;        // kPairs: the first counter
  void* out;
  float lo, hi;             // kUniform, kNormal
  Bound lo_bound, hi_bound;  // kRandint
};

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) {
  return (x << r) | (x >> (32 - r));
}

// The 20-round Threefry-2x32 block cipher (Salmon et al. 2011), as
// jax.random's threefry2x32 primitive and rng.threefry2x32 compute it.
__device__ __forceinline__ void threefry2x32(uint32_t k0, uint32_t k1, uint32_t x0,
                                             uint32_t x1, uint32_t& y0, uint32_t& y1) {
  const uint32_t ks[3] = {k0, k1, k0 ^ k1 ^ 0x1BD11BDAu};
  const int rot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
  uint32_t v0 = x0 + ks[0], v1 = x1 + ks[1];
#pragma unroll
  for (int block = 0; block < 5; ++block) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      v0 += v1;
      v1 = rotl(v1, rot[block & 1][j]) ^ v0;
    }
    v0 += ks[(block + 1) % 3];
    v1 += ks[(block + 2) % 3] + (uint32_t)(block + 1);
  }
  y0 = v0;
  y1 = v1;
}

// rng.uniform_plain on one word: torch.maximum(lo, fma(f, hi - lo, lo)).
__device__ __forceinline__ float uniform_from_word(uint32_t w, float lo, float hi) {
  const float f = __fsub_rn(__uint_as_float((w >> 9) | 0x3F800000u), 1.0f);
  const float r = __fmaf_rn(f, __fsub_rn(hi, lo), lo);
  return (r > lo || r != r) ? r : lo;
}

// rng.erfinv's coefficients, highest order first (w < 5, then w >= 5).
__device__ __forceinline__ float erfinv_coeff(bool small, int i) {
  const float kSmall[9] = {2.81022636e-08f, 3.43273939e-07f, -3.5233877e-06f,
                           -4.39150654e-06f, 0.00021858087f, -0.00125372503f,
                           -0.00417768164f, 0.246640727f, 1.50140941f};
  const float kLarge[9] = {-0.000200214257f, 0.000100950558f, 0.00134934322f,
                           -0.00367342844f, 0.00573950773f, -0.0076224613f,
                           0.00943887047f, 1.00167406f, 2.83297682f};
  return small ? kSmall[i] : kLarge[i];
}

// rng.normal_plain on one word: sqrt(2) * erfinv(u), op for op.
__device__ __forceinline__ float normal_from_word(uint32_t w, float lo, float hi) {
  const float x = uniform_from_word(w, lo, hi);
  float t = -log1pf(__fmul_rn(-x, x));
  const bool small = t < 5.0f;
  t = small ? __fsub_rn(t, 2.5f) : __fsub_rn(sqrtf(t), 3.0f);
  float p = erfinv_coeff(small, 0);
#pragma unroll
  for (int i = 1; i < 9; ++i) p = __fadd_rn(erfinv_coeff(small, i), __fmul_rn(p, t));
  const float e = fabsf(x) == 1.0f ? __fmul_rn(x, __uint_as_float(0x7F800000u))
                                   : __fmul_rn(p, x);
  return __fmul_rn(1.41421354f, e);  // float32(sqrt(2))
}

__device__ __forceinline__ int64_t bound_at(const Bound& b, int64_t idx) {
  int64_t v = b.value;
  if (b.ptr != nullptr) {
    const int64_t j = idx * b.step;
    v = b.bytes == 4 ? (int64_t)static_cast<const int32_t*>(b.ptr)[j]
                     : static_cast<const int64_t*>(b.ptr)[j];
  }
  return v < INT32_MIN ? INT32_MIN : (v > INT32_MAX ? INT32_MAX : v);
}

__device__ __forceinline__ uint32_t bits_at(uint32_t k0, uint32_t k1, uint32_t i) {
  uint32_t y0, y1;
  threefry2x32(k0, k1, 0u, i, y0, y1);
  return y0 ^ y1;
}

// rng.randint_plain on output idx (counter i) of key (k0, k1).
__device__ __forceinline__ int32_t randint_at(const Draw& d, uint32_t k0, uint32_t k1,
                                              uint32_t i, int64_t idx) {
  uint32_t a0, a1, b0, b1;
  threefry2x32(k0, k1, 0u, 0u, a0, a1);
  threefry2x32(k0, k1, 0u, 1u, b0, b1);
  const uint32_t higher = bits_at(a0, a1, i), lower = bits_at(b0, b1, i);
  const int64_t lo = bound_at(d.lo_bound, idx), hi = bound_at(d.hi_bound, idx);
  const uint32_t span = hi <= lo ? 1u : (uint32_t)(hi - lo);
  uint32_t multiplier = 65536u % span;
  multiplier = (multiplier * multiplier) % span;
  const uint32_t offset = ((higher % span) * multiplier + lower % span) % span;
  return (int32_t)((uint32_t)lo + offset);
}

template <int KIND>
__global__ void __launch_bounds__(kThreads) draw_kernel(const Draw d) {
  const int64_t total = d.n_keys * d.per_key;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; idx < total;
       idx += stride) {
    const int64_t b = idx / d.per_key;
    const uint32_t i = (uint32_t)(idx - b * d.per_key);
    const int64_t* key = d.keys + b * d.key_stride;
    const uint32_t k0 = (uint32_t)key[0], k1 = (uint32_t)key[d.word_stride];
    if constexpr (KIND == kRandint) {
      static_cast<int32_t*>(d.out)[idx] = randint_at(d, k0, k1, i, idx);
    } else if constexpr (KIND == kPairs) {
      uint32_t y0, y1;
      threefry2x32(k0, k1, 0u, d.counter0 + i, y0, y1);
      static_cast<int64_t*>(d.out)[2 * idx] = y0;
      static_cast<int64_t*>(d.out)[2 * idx + 1] = y1;
    } else {
      const uint32_t w = bits_at(k0, k1, i);
      if constexpr (KIND == kBits) {
        static_cast<int64_t*>(d.out)[idx] = w;
      } else if constexpr (KIND == kUniform) {
        static_cast<float*>(d.out)[idx] = uniform_from_word(w, d.lo, d.hi);
      } else {
        static_cast<float*>(d.out)[idx] = normal_from_word(w, d.lo, d.hi);
      }
    }
  }
}

template <int KIND>
cudaError_t launch(const Draw& d, cudaStream_t stream) {
  const int64_t total = d.n_keys * d.per_key;
  const int64_t blocks = (total + kThreads - 1) / kThreads;
  const int grid = (int)(blocks < kMaxBlocks ? blocks : kMaxBlocks);
  RNG_LAUNCH(draw_kernel<KIND>, grid, kThreads, stream)(d);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// One draw of kind `kind` (Kind) over n_keys keys, per_key outputs each,
// written to `out` (int64 words, float32 or int32 by kind). Launches on
// `stream` and returns cudaGetLastError() (cudaErrorInvalidValue for a
// kind or size it does not take); launches nothing for an empty draw.
int rng_draw_launch(int kind, const int64_t* keys, int64_t key_stride, int64_t word_stride,
                    int64_t n_keys, int64_t per_key, uint32_t counter0, void* out, float lo,
                    float hi, const void* lo_ptr, int lo_bytes, int64_t lo_step,
                    int64_t lo_value, const void* hi_ptr, int hi_bytes, int64_t hi_step,
                    int64_t hi_value, cudaStream_t stream) {
  if (n_keys < 0 || per_key < 0 || per_key > ((int64_t)1 << 32)) return cudaErrorInvalidValue;
  if (n_keys == 0 || per_key == 0) return cudaSuccess;
  const Draw d{keys, key_stride, word_stride, n_keys, per_key, counter0, out, lo, hi,
               Bound{lo_ptr, lo_bytes, lo_step, lo_value},
               Bound{hi_ptr, hi_bytes, hi_step, hi_value}};
  switch (kind) {
    case kPairs: return (int)launch<kPairs>(d, stream);
    case kBits: return (int)launch<kBits>(d, stream);
    case kUniform: return (int)launch<kUniform>(d, stream);
    case kNormal: return (int)launch<kNormal>(d, stream);
    case kRandint: return (int)launch<kRandint>(d, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // extern "C"
