// The FMA chain of `calibrate_machine`'s FLOP-rate fit
// (implicitglobalgrid_tpu_torch/telemetry/calibrate.py).
//
// It replaces no TPU kernel and is no port of one: the JAX package times a
// chain of 64 dependent multiply-adds an iteration (its calibrate.py
// `_measure_flops_g`) that XLA fuses into one loop; in eager PyTorch each
// multiply-add would be a pass over memory, and the fit would time the
// memory instead of the float units. Here a thread loads its element once,
// runs iters x 64 dependent multiply-adds in a register and stores it once.
//
// Bound (H100 SXM, 700 W): operations. 2 x 64 x iters FLOPs an element over
// the 67 TFLOP/s float32 peak outside the tensor cores; one load and one
// store an element (8 bytes) are nothing beside them. Design: one element a
// thread in blocks of 256, `fmaf` so the chain stays one fused instruction
// under -fmad=false; one dependent chain a thread keeps one FFMA in flight,
// so the wrapper's caller fills the card (every SM at its thread limit: 16
// warps a scheduler, several times the FFMA latency).

#include <cmath>

#include <cuda_runtime.h>

namespace {

__global__ void __launch_bounds__(256) fma_chain_kernel(float* __restrict__ x, long long n,
                                                        int iters, float a, float b) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float v = x[i];
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int k = 0; k < 64; ++k) v = fmaf(v, a, b);
  }
  x[i] = v;
}

}  // namespace

// x[e] <- iters x 64 times x[e] * a + b (each a single-rounding multiply-add),
// e < n, in place, float32 device memory.
extern "C" int igg_fma_chain(void* x, long long n, int iters, double a, double b,
                             void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n < 0 || iters < 0 || n > (long long)1 << 40) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  const unsigned blocks = (unsigned)((n + 255) / 256);
  fma_chain_kernel<<<blocks, 256, 0, st>>>(static_cast<float*>(x), n, iters, (float)a,
                                           (float)b);
  return (int)cudaGetLastError();
}
