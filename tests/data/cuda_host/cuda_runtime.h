// Host stand-in for the CUDA runtime header, for running the kernels of
// implicitglobalgrid_tpu_torch/csrc on the CPU (tests/test_torch_csrc_host.py).
// Device qualifiers compile away and `kernel<<<grid, block, ...>>>(args)` is
// rewritten into `igg_launch([&] { kernel(args); }, grid, block, ...)`, which
// runs the blocks one at a time and the threads of a block concurrently, one
// std::thread each (a pool kept for the process, grown to the largest
// block): `__syncthreads` is a std::barrier of the block, a warp shuffle a
// barrier of the warp after each lane writes its slot, and
// `__shared__` is static storage (one block at a time uses it). A thread
// that returns leaves both barriers. Built with C++20 and -pthread.
#pragma once
#include <algorithm>
#include <atomic>
#include <barrier>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <functional>
#include <memory>
#include <semaphore>
#include <thread>
#include <vector>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __noinline__
#define __launch_bounds__(...)
#define __restrict__
#define __shared__ static
#define __grid_constant__

struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
inline thread_local dim3 blockIdx, threadIdx;
inline dim3 blockDim, gridDim;
typedef struct CUstream_st* cudaStream_t;
enum cudaError_t { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
template <typename T>
inline T __ldg(const T* p) { return *p; }
using std::max;
using std::min;

inline unsigned __float_as_uint(float a) {
  unsigned u;
  std::memcpy(&u, &a, sizeof u);
  return u;
}
inline float __uint_as_float(unsigned u) {
  float a;
  std::memcpy(&a, &u, sizeof a);
  return a;
}
inline long long __double_as_longlong(double a) {
  long long u;
  std::memcpy(&u, &a, sizeof u);
  return u;
}
inline float __fmaf_rn(float a, float b, float c) { return std::fma(a, b, c); }
inline double __fma_rn(double a, double b, double c) { return std::fma(a, b, c); }
inline float __fdiv_rn(float a, float b) { return a / b; }
inline double __ddiv_rn(double a, double b) { return a / b; }
inline unsigned long long atomicAdd(unsigned long long* p, unsigned long long v) {
  return std::atomic_ref<unsigned long long>(*p).fetch_add(v);
}

// The barriers and shuffle slots of the block that runs.
struct igg_host_block {
  std::unique_ptr<std::barrier<>> block;
  std::vector<std::unique_ptr<std::barrier<>>> warps;
  std::vector<unsigned long long> slots;
};
inline igg_host_block igg_block_;

inline unsigned igg_thread_rank() {
  return threadIdx.x + blockDim.x * (threadIdx.y + blockDim.y * threadIdx.z);
}

inline void __syncthreads() { igg_block_.block->arrive_and_wait(); }

// Lane `src(lane)`'s value of v, each lane of the warp taking part. Two
// slots a lane, used in turn: a lane can write its next shuffle's slot only
// after the whole warp has passed this shuffle's barrier, and so its read.
inline thread_local unsigned igg_shuffles_;
template <typename T, typename F>
inline T igg_shuffle(T v, F src) {
  static_assert(sizeof(T) <= sizeof(unsigned long long), "shuffle of a wider type");
  const unsigned t = igg_thread_rank(), w = t / 32, lane = t % 32, turn = igg_shuffles_++ & 1;
  unsigned long long u = 0;
  std::memcpy(&u, &v, sizeof v);
  igg_block_.slots[2 * t + turn] = u;
  igg_block_.warps[w]->arrive_and_wait();
  u = igg_block_.slots[2 * (w * 32 + src(lane)) + turn];
  T r;
  std::memcpy(&r, &u, sizeof r);
  return r;
}
template <typename T>
inline T __shfl_sync(unsigned, T v, int src) {
  return igg_shuffle(v, [&](unsigned) { return (unsigned)src % 32; });
}
template <typename T>
inline T __shfl_down_sync(unsigned, T v, unsigned d) {
  return igg_shuffle(v, [&](unsigned l) { return l + d < 32 ? l + d : l; });
}
template <typename T>
inline T __shfl_up_sync(unsigned, T v, unsigned d) {
  return igg_shuffle(v, [&](unsigned l) { return l >= d ? l - d : l; });
}

// The threads that run a block's threads: worker t waits on its own
// semaphore, runs `job(t)` and posts `done`. Never destroyed (the workers
// outlive every launch); a block has at most 1024 threads.
struct igg_host_pool {
  std::binary_semaphore* go[1024] = {};
  std::counting_semaphore<1024> done{0};
  std::function<void(unsigned)> job;
  unsigned size = 0;

  void run(unsigned count, std::function<void(unsigned)> fn) {
    for (; size < count; ++size) {
      go[size] = new std::binary_semaphore(0);
      std::thread([this, t = size] {
        for (;;) {
          go[t]->acquire();
          job(t);
          done.release();
        }
      }).detach();
    }
    job = std::move(fn);
    for (unsigned t = 0; t < count; ++t) go[t]->release();
    for (unsigned t = 0; t < count; ++t) done.acquire();
  }
};
inline igg_host_pool& igg_pool_ = *new igg_host_pool;

template <typename F>
inline void igg_launch(F&& f, dim3 g, dim3 b, size_t = 0, cudaStream_t = nullptr) {
  gridDim = g;
  blockDim = b;
  const unsigned n = b.x * b.y * b.z, nwarps = (n + 31) / 32;
  for (unsigned z = 0; z < g.z; ++z)
    for (unsigned y = 0; y < g.y; ++y)
      for (unsigned x = 0; x < g.x; ++x) {
        igg_block_.block = std::make_unique<std::barrier<>>(n);
        igg_block_.warps.clear();
        for (unsigned w = 0; w < nwarps; ++w)
          igg_block_.warps.push_back(std::make_unique<std::barrier<>>(std::min(32u, n - 32 * w)));
        igg_block_.slots.assign(64 * nwarps, 0);
        igg_pool_.run(n, [&](unsigned t) {
          blockIdx = dim3(x, y, z);
          igg_shuffles_ = 0;
          threadIdx = dim3(t % b.x, t / b.x % b.y, t / (b.x * b.y));
          f();
          igg_block_.block->arrive_and_drop();
          igg_block_.warps[t / 32]->arrive_and_drop();
        });
      }
}
