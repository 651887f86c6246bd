// Host C++ stand-ins for the CUDA built-ins that csrc/rng_kernels.cu uses,
// so that the kernel source compiles with g++ and runs on CPU tensors
// (tests/test_torch_rng_host.py). A launch runs its blocks, and each
// block's threads, one after another: the draw kernel's threads share
// nothing. The rounded intrinsics are the plain float operations, so build
// with -ffp-contract=off -DRNG_HOST_REHEARSAL.
#pragma once

#include <math.h>
#include <stdint.h>

#include <cstring>
#include <type_traits>

#define __global__
#define __device__
#define __forceinline__ inline
#define __launch_bounds__(...)

typedef void* cudaStream_t;
typedef int cudaError_t;
constexpr cudaError_t cudaSuccess = 0;
constexpr cudaError_t cudaErrorInvalidValue = 1;

struct RngHostDim3 {
  unsigned x = 0, y = 0, z = 0;
};
inline RngHostDim3 threadIdx, blockIdx, blockDim, gridDim;

inline float __uint_as_float(uint32_t u) {
  float f;
  std::memcpy(&f, &u, sizeof f);
  return f;
}
inline float __fmaf_rn(float a, float b, float c) { return fmaf(a, b, c); }
inline float __fmul_rn(float a, float b) { return a * b; }
inline float __fadd_rn(float a, float b) { return a + b; }
inline float __fsub_rn(float a, float b) { return a - b; }

inline cudaError_t cudaGetLastError() { return cudaSuccess; }

namespace rng_host {

template <typename Kernel>
struct Launch {
  Kernel kernel;
  int grid, threads;

  template <typename... Args>
  void operator()(const Args&... args) const {
    blockDim.x = threads;
    gridDim.x = grid;
    for (int b = 0; b < grid; ++b) {
      for (int t = 0; t < threads; ++t) {
        blockIdx.x = b;
        threadIdx.x = t;
        kernel(args...);
      }
    }
  }
};

}  // namespace rng_host

#define RNG_LAUNCH(kernel, grid, threads, stream) \
  rng_host::Launch<std::decay_t<decltype(kernel)>>{kernel, grid, threads}
