// A stand-in for the CUDA runtime that runs the kernels of
// rscm_tpu_torch/csrc on the host, for tests without a card
// (tests/test_torch_kernel_sources.py): each block's threads are OS threads
// run block after block, __syncthreads is a barrier of the block, and
// __shfl_xor_sync(mask, v, 1) swaps v between the two threads of a pair (the
// only shuffle the kernels use).  The test rewrites each `kernel<T><<<grid,
// threads, ...>>>(args)` launch to `launch_kernel(grid, threads, kernel<T>,
// args)` and the dynamic shared array to g_smem; it compiles with
// -ffp-contract=off so that, as under nvcc -fmad=false, every addition and
// multiplication rounds on its own.
#pragma once
#include <barrier>
#include <cmath>
#include <cstddef>
#include <cstdint>
#include <cstring>
#include <memory>
#include <thread>
#include <vector>

#define __device__
#define __host__
#define __global__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __shared__
#define __align__(x)

struct HostDim3 {
  unsigned x = 0, y = 0, z = 0;
};
inline thread_local HostDim3 threadIdx;
inline HostDim3 blockIdx, blockDim;
alignas(16) inline unsigned char g_smem[1 << 20];  // a block's dynamic shared memory

inline std::barrier<>* g_block_barrier = nullptr;
struct PairSync {
  std::unique_ptr<std::barrier<>> bar;
  alignas(16) unsigned char slot[2][16];
};
inline std::vector<PairSync>* g_pairs = nullptr;

inline void __syncthreads() { g_block_barrier->arrive_and_wait(); }

template <typename T>
T __shfl_xor_sync(unsigned, T v, int) {
  const int t = threadIdx.x;
  PairSync& p = (*g_pairs)[t / 2];
  std::memcpy(p.slot[t & 1], &v, sizeof(T));
  p.bar->arrive_and_wait();
  T r;
  std::memcpy(&r, p.slot[(t & 1) ^ 1], sizeof(T));
  p.bar->arrive_and_wait();
  return r;
}

typedef enum {
  cudaSuccess = 0,
  cudaErrorInvalidValue = 1,
  cudaErrorInvalidConfiguration = 9
} cudaError_t;
typedef void* cudaStream_t;
enum cudaFuncAttribute {
  cudaFuncAttributeMaxDynamicSharedMemorySize,
  cudaFuncAttributePreferredSharedMemoryCarveout
};
enum { cudaSharedmemCarveoutMaxShared = 100 };

inline cudaError_t cudaGetDevice(int* d) {
  *d = 0;
  return cudaSuccess;
}
inline cudaError_t cudaFuncSetAttribute(const void*, cudaFuncAttribute, int) { return cudaSuccess; }
// one resident block of at most two warps: blocks of 32 or 64 threads
inline cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* blocks, const void*,
                                                                 int threads, size_t) {
  *blocks = threads <= 64 ? 1 : 0;
  return cudaSuccess;
}
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
enum cudaDeviceAttr { cudaDevAttrMultiProcessorCount };
inline cudaError_t cudaDeviceGetAttribute(int* value, cudaDeviceAttr, int) {
  *value = 1;  // one SM
  return cudaSuccess;
}

template <typename F, typename... A>
void launch_kernel(unsigned grid, int threads, F f, A... a) {
  blockDim.x = threads;
  for (unsigned b = 0; b < grid; ++b) {
    blockIdx.x = b;
    std::barrier<> block(threads);
    g_block_barrier = &block;
    std::vector<PairSync> pairs(threads / 2);
    for (auto& p : pairs) p.bar = std::make_unique<std::barrier<>>(2);
    g_pairs = &pairs;
    std::vector<std::thread> ts;
    for (int t = 0; t < threads; ++t) ts.emplace_back([=] {
        threadIdx.x = t;
        f(a...);
      });
    for (auto& t : ts) t.join();
  }
}
