// Host C++ stand-ins for the CUDA built-ins that csrc/fdm_kernels.cu uses,
// so that the kernel source compiles with g++ and runs on CPU tensors
// (tests/test_torch_kernel_host.py). A launch runs the grid's blocks one
// after another; the threads of a block run as host threads that meet at a
// std::barrier in __syncthreads, and warp shuffles exchange through a
// per-warp pair of slot arrays, one warp barrier per shuffle. A cluster
// launch runs the grid's clusters one after another, the blocks of a
// cluster at once (each with its own dynamic shared memory, barrier and
// warps), and their threads meet at one more std::barrier in cluster_sync;
// distributed shared memory is the other block's buffer. The bulk copies and
// stores are plain memcpy, complete when they return; mbarrier waits and
// proxy fences are no-ops, since a __syncthreads follows each of them.
// A thread's block state is thread_local, set as it starts.
// Build with -std=c++20 -ffp-contract=off -DFDM_HOST_REHEARSAL.
#pragma once

#include <algorithm>
#include <barrier>
#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <memory>
#include <thread>
#include <vector>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __shared__ static
#define __align__(n) alignas(n)

using std::max;
using std::min;

struct float4 {
  float x, y, z, w;
};
inline float4 make_float4(float x, float y, float z, float w) { return {x, y, z, w}; }

typedef void* cudaStream_t;
typedef int cudaError_t;
constexpr cudaError_t cudaSuccess = 0;
constexpr cudaError_t cudaErrorInvalidValue = 1;
constexpr int cudaFuncAttributeMaxDynamicSharedMemorySize = 8;

struct HostDim3 {
  unsigned x = 0, y = 0, z = 0;
};
inline thread_local HostDim3 threadIdx, blockIdx;
inline HostDim3 blockDim, gridDim;

namespace fdm_host {

struct Warp {
  std::unique_ptr<std::barrier<>> bar;
  float vals[2][32];
};

// Which of its warp's slot arrays a thread's next shuffle uses.
inline thread_local unsigned shfl_parity = 0;

inline thread_local float* dyn_smem = nullptr;
inline thread_local std::barrier<>* block_barrier = nullptr;
inline thread_local std::vector<Warp>* warps = nullptr;
// A cluster launch's: the thread's rank in its cluster, the cluster's
// barrier and its blocks' shared memory.
inline thread_local unsigned cluster_rank = 0;
inline thread_local std::barrier<>* cluster_barrier = nullptr;
inline thread_local float* const* cluster_smem = nullptr;

// The threads, barrier and warps of one block.
struct Block {
  std::unique_ptr<std::barrier<>> bar;
  std::vector<Warp> warps;
  explicit Block(int threads)
      : bar(std::make_unique<std::barrier<>>(threads)), warps((threads + 31) / 32) {
    for (size_t w = 0; w < warps.size(); ++w) {
      const int n = std::min(32, threads - 32 * (int)w);
      warps[w].bar = std::make_unique<std::barrier<>>(n);
    }
  }
};

inline float* smem_buffer(size_t smem) {
  const size_t bytes = (smem + 16 + 15) & ~(size_t)15;
  float* buf = static_cast<float*>(std::aligned_alloc(16, bytes));
  std::memset(buf, 0xff, bytes);  // NaN: a read before a write shows
  return buf;
}

template <typename Kernel>
struct Launch {
  Kernel kernel;
  int grid, threads;
  size_t smem;
  Launch(Kernel k, int g, int t, size_t s) : kernel(k), grid(g), threads(t), smem(s) {}

  template <typename... Args>
  void operator()(Args... args) const {
    float* buf = smem_buffer(smem);
    blockDim.x = threads;
    gridDim.x = grid;
    for (int b = 0; b < grid; ++b) {
      Block block(threads);
      std::vector<std::thread> pool;
      pool.reserve(threads);
      for (int t = 0; t < threads; ++t) {
        pool.emplace_back([&, t, b] {
          threadIdx.x = t;
          blockIdx.x = b;
          dyn_smem = buf;
          block_barrier = block.bar.get();
          warps = &block.warps;
          kernel(args...);
        });
      }
      for (auto& th : pool) th.join();
    }
    std::free(buf);
  }
};

// Runs `kernel` on `grid` blocks in clusters of `cluster`, one cluster after
// another.
template <typename... Params, typename... Args>
int launch_cluster(void (*kernel)(Params...), int grid, int cluster, int threads,
                   size_t smem, void*, Args... args) {
  blockDim.x = threads;
  gridDim.x = grid;
  for (int c0 = 0; c0 < grid; c0 += cluster) {
    std::vector<float*> bufs;
    std::vector<std::unique_ptr<Block>> blocks;
    for (int k = 0; k < cluster; ++k) {
      bufs.push_back(smem_buffer(smem));
      blocks.push_back(std::make_unique<Block>(threads));
    }
    std::barrier<> cbar(cluster * threads);
    std::vector<std::thread> pool;
    pool.reserve(cluster * threads);
    for (int k = 0; k < cluster; ++k) {
      for (int t = 0; t < threads; ++t) {
        pool.emplace_back([&, k, t] {
          threadIdx.x = t;
          blockIdx.x = c0 + k;
          dyn_smem = bufs[k];
          block_barrier = blocks[k]->bar.get();
          warps = &blocks[k]->warps;
          cluster_rank = k;
          cluster_barrier = &cbar;
          cluster_smem = bufs.data();
          kernel(args...);
        });
      }
    }
    for (auto& th : pool) th.join();
    for (float* b : bufs) std::free(b);
  }
  return 0;
}

}  // namespace fdm_host

using fdm_host::launch_cluster;

#define FDM_DYNAMIC_SMEM(name) float* name = fdm_host::dyn_smem
#define FDM_LAUNCH(kernel, grid, threads, smem, stream) \
  fdm_host::Launch<std::decay_t<decltype(kernel)>>(kernel, grid, threads, smem)

inline void __syncthreads() { fdm_host::block_barrier->arrive_and_wait(); }

// Shuffles alternate between the two slot arrays: a lane writes an array
// again only two shuffles later, after the barrier of the one between,
// which every lane reaches only once it has read this one.
inline float __shfl_xor_sync(unsigned, float v, int off) {
  fdm_host::Warp& w = (*fdm_host::warps)[threadIdx.x >> 5];
  const unsigned lane = threadIdx.x & 31;
  float* vals = w.vals[fdm_host::shfl_parity];
  fdm_host::shfl_parity ^= 1u;
  vals[lane] = v;
  w.bar->arrive_and_wait();
  return vals[lane ^ (unsigned)off];
}

template <typename T>
inline T __ldg(const T* p) {
  return *p;
}

template <typename T>
inline T __ldcg(const T* p) {
  return *p;
}

// Per byte: 0xff where a's byte is below b's (unsigned), else 0.
inline uint32_t __vcmpltu4(uint32_t a, uint32_t b) {
  uint32_t r = 0;
  for (int k = 0; k < 32; k += 8) {
    if (((a >> k) & 0xffu) < ((b >> k) & 0xffu)) r |= 0xffu << k;
  }
  return r;
}

inline unsigned cluster_rank() { return fdm_host::cluster_rank; }
inline void cluster_sync() { fdm_host::cluster_barrier->arrive_and_wait(); }
inline void cluster_store(float* local, unsigned rank, float v) {
  fdm_host::cluster_smem[rank][local - fdm_host::dyn_smem] = v;
}

inline cudaError_t cudaGetLastError() { return cudaSuccess; }

template <typename Kernel>
inline cudaError_t cudaFuncSetAttribute(Kernel, int, int) {
  return cudaSuccess;
}

template <typename Kernel>
inline cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* n, Kernel, int,
                                                                 size_t) {
  *n = 1;
  return cudaSuccess;
}

inline void mbar_init(uint64_t*) {}
inline void mbar_expect_tx(uint64_t*, uint32_t) {}
inline void mbar_wait(uint64_t*, uint32_t) {}
inline void fence_async_shared() {}

inline void bulk_load(void* dst, const void* src, uint32_t bytes, uint64_t*) {
  std::memcpy(dst, src, bytes);
}

inline void bulk_store(void* dst, const void* src, uint32_t bytes) {
  std::memcpy(dst, src, bytes);
}

inline void copy_async4(void* dst, const void* src) { std::memcpy(dst, src, 4); }
inline void wait_async() {}
