// Host stand-in for the CUDA runtime header, for running the kernels of
// implicitglobalgrid_tpu_torch/csrc on the CPU (tests/test_torch_csrc_host.py).
// Device qualifiers compile away, the launch coordinates are globals, and
// IGG_LAUNCH (what the test rewrites `kernel<<<grid, block, ...>>>` into)
// loops over every block and thread in turn, one thread at a time: enough
// for kernels that share no memory and need no barrier.
#pragma once
#include <algorithm>
#include <cstdint>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __noinline__
#define __launch_bounds__(...)
#define __restrict__

struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
inline dim3 blockIdx, threadIdx, blockDim, gridDim;
typedef struct CUstream_st* cudaStream_t;
enum cudaError_t { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
template <typename T>
inline T __ldg(const T* p) { return *p; }
using std::max;
using std::min;

struct igg_host_launch {
  dim3 g, b;
  unsigned long long n = 0, total;
  igg_host_launch(dim3 g_, dim3 b_) : g(g_), b(b_) {
    total = (unsigned long long)g.x * g.y * g.z * b.x * b.y * b.z;
    gridDim = g;
    blockDim = b;
  }
  bool next() {
    if (n >= total) return false;
    unsigned long long q = n++;
    threadIdx.x = q % b.x; q /= b.x;
    threadIdx.y = q % b.y; q /= b.y;
    threadIdx.z = q % b.z; q /= b.z;
    blockIdx.x = q % g.x; q /= g.x;
    blockIdx.y = q % g.y; q /= g.y;
    blockIdx.z = (unsigned)q;
    return true;
  }
};
#define IGG_LAUNCH(G, B, ...) for (igg_host_launch igg_it_((G), (B)); igg_it_.next();)
