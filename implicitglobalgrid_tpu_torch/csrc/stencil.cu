// K1: one 3-D flux-form diffusion step (+ the self-neighbour halo updates
// folded into the output pass) on every block of a stacked field.
//
// Replaces the TPU kernels `_plane_halo_kernel` (diffusion3d_step_halo_pallas
// / diffusion3d_step_pallas, implicitglobalgrid_tpu/ops/pallas_stencil.py:72)
// and `_mp_kernel` + its x-plane patch (diffusion3d_step_halo_pallas_mp,
// pallas_stencil.py:839-959). Both compute the same function; the multi-plane
// window of the latter is a TPU VMEM tiling choice that has no counterpart
// here.
//
// Function: output cell (i, j, k) of a block of shape (n0, n1, n2) is
//   U(sx(i), sy(j), sz(k)),  U(s, j, k) = interior ? step(T)(s, j, k) : T(s, j, k)
// where sx/sy/sz are the identity unless that dim's halo update is fused, in
// which case the halo index 0 reads n-2 and n-1 reads 1 (`_sigma`,
// pallas_stencil.py:122). Composing the index maps this way reproduces the
// sequential z, x, y exchange, corners included: the TPU kernel applies the
// z edits to the computed plane before it serves as an x or y source
// (pallas_stencil.py:93-95,113-118). The interior mask is taken at the
// SOURCE index (pallas_stencil.py:110-112).
//
// Arithmetic: `_stencil_plane`'s accumulation order (pallas_stencil.py:556),
// with real divisions; built with -fmad=false so that no multiply-add is
// contracted and the result stays at ulp distance from the plain version.
// bfloat16 states are computed in float with float constants.
//
// Bound on an H100 SXM (3.35 TB/s): read T + read Cp + write T, 3 x 4 B per
// cell in float32 -> 201 MB at 256^3, about 60 us a step. The stencil does
// ~30 flops a cell, far below the card's ridge point: it is bound by bytes.
// Design against that bound: threads run along z (contiguous, coalesced),
// a 2-D thread block tiles (y, z), and each thread walks XCHUNK planes along
// x keeping the x-neighbours tm/tc/tp in registers, so T is read about once
// from device memory; the y/z neighbours are re-read by adjacent threads and
// hit in L1/L2. Splitting x into chunks keeps enough threads in flight to
// cover memory latency. Offsets are 64-bit: stacked fields exceed 2^31 cells.
#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int XCHUNK = 16;   // output planes per thread
constexpr int BZ = 32;       // threads along z
constexpr int BY = 8;        // threads along y

__device__ __forceinline__ float to_c(float v) { return v; }
__device__ __forceinline__ double to_c(double v) { return v; }
__device__ __forceinline__ float to_c(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename S, typename C> __device__ __forceinline__ S from_c(C v);
template <> __device__ __forceinline__ float from_c<float, float>(float v) { return v; }
template <> __device__ __forceinline__ double from_c<double, double>(double v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_c<__nv_bfloat16, float>(float v) {
  return __float2bfloat16_rn(v);
}

__device__ __forceinline__ long long src_index(long long i, long long n, int fuse) {
  if (!fuse) return i;
  return i == 0 ? n - 2 : (i == n - 1 ? 1 : i);
}

template <typename S, typename C>
__global__ void __launch_bounds__(BZ * BY)
diffusion3d_step_halo_kernel(const S* __restrict__ T, const S* __restrict__ Cp,
                             S* __restrict__ out,
                             long long S1, long long S2,
                             long long n0, long long n1, long long n2,
                             C lam, C dt, C dx, C dy, C dz,
                             int fuse_x, int fuse_y, int fuse_z, long long nchunk) {
  const long long K = (long long)blockIdx.x * BZ + threadIdx.x;
  const long long J = (long long)blockIdx.y * BY + threadIdx.y;
  if (K >= S2 || J >= S1) return;
  const long long c0 = blockIdx.z / nchunk;
  const long long i_lo = (blockIdx.z % nchunk) * XCHUNK;
  const long long i_hi = min(n0, i_lo + XCHUNK);

  const long long cj = J / n1, j = J - cj * n1;
  const long long ck = K / n2, k = K - ck * n2;
  const long long js = src_index(j, n1, fuse_y);
  const long long ks = src_index(k, n2, fuse_z);
  const bool yz_interior = js > 0 && js < n1 - 1 && ks > 0 && ks < n2 - 1;

  const long long plane = S1 * S2;
  const long long block0 = c0 * n0 * plane;
  const long long col = (cj * n1 + js) * S2 + (ck * n2 + ks);  // source column
  const long long out_col = J * S2 + K;
  const C nlam = -lam;

  long long cached = -2;  // source plane whose x-neighbours sit in tm/tc/tp
  C tm = 0, tc = 0, tp = 0, qxr = 0;
  for (long long i = i_lo; i < i_hi; ++i) {
    const long long s = src_index(i, n0, fuse_x);
    const long long o = block0 + i * plane + out_col;
    const long long p = block0 + s * plane + col;
    if (!(yz_interior && s > 0 && s < n0 - 1)) {
      out[o] = T[p];  // boundary cells keep their input
      continue;
    }
    C qxl;
    if (s == cached + 1) {
      // the left face of this cell is the right face of the last one: the
      // same expression on the same values, so reuse it bit for bit
      tm = tc;
      tc = tp;
      tp = to_c(T[p + plane]);
      qxl = qxr;
    } else if (s == cached) {
      qxl = nlam * (tc - tm) / dx;
    } else {
      tm = to_c(T[p - plane]);
      tc = to_c(T[p]);
      tp = to_c(T[p + plane]);
      qxl = nlam * (tc - tm) / dx;
    }
    cached = s;
    const C ym = to_c(T[p - S2]), yp = to_c(T[p + S2]);
    const C zm = to_c(T[p - 1]), zp = to_c(T[p + 1]);
    const C cp = to_c(Cp[p]);
    qxr = nlam * (tp - tc) / dx;
    C acc = -((qxr - qxl) / dx);
    const C qyr = nlam * (yp - tc) / dy;
    const C qyl = nlam * (tc - ym) / dy;
    acc = acc - (qyr - qyl) / dy;
    const C qzr = nlam * (zp - tc) / dz;
    const C qzl = nlam * (tc - zm) / dz;
    acc = acc - (qzr - qzl) / dz;
    out[o] = from_c<S, C>(tc + dt * (acc / cp));
  }
}

template <typename S, typename C>
void launch(const void* T, const void* Cp, void* out, long long S0, long long S1,
            long long S2, long long n0, long long n1, long long n2, double lam,
            double dt, double dx, double dy, double dz, int fx, int fy, int fz,
            cudaStream_t stream) {
  const long long nchunk = (n0 + XCHUNK - 1) / XCHUNK;
  dim3 block(BZ, BY);
  dim3 grid((unsigned)((S2 + BZ - 1) / BZ), (unsigned)((S1 + BY - 1) / BY),
            (unsigned)((S0 / n0) * nchunk));
  diffusion3d_step_halo_kernel<S, C><<<grid, block, 0, stream>>>(
      static_cast<const S*>(T), static_cast<const S*>(Cp), static_cast<S*>(out),
      S1, S2, n0, n1, n2, (C)lam, (C)dt, (C)dx, (C)dy, (C)dz, fx, fy, fz, nchunk);
}

}  // namespace

// dtype: 0 float32, 1 float64, 2 bfloat16. (S0, S1, S2) is the stacked
// shape, (n0, n1, n2) the block shape; both contiguous row-major.
extern "C" int igg_diffusion3d_step_halo(int dtype, const void* T, const void* Cp,
                                         void* out, long long S0, long long S1,
                                         long long S2, long long n0, long long n1,
                                         long long n2, double lam, double dt,
                                         double dx, double dy, double dz, int fuse_x,
                                         int fuse_y, int fuse_z, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      launch<float, float>(T, Cp, out, S0, S1, S2, n0, n1, n2, lam, dt, dx, dy, dz,
                           fuse_x, fuse_y, fuse_z, st);
      break;
    case 1:
      launch<double, double>(T, Cp, out, S0, S1, S2, n0, n1, n2, lam, dt, dx, dy,
                             dz, fuse_x, fuse_y, fuse_z, st);
      break;
    case 2:
      launch<__nv_bfloat16, float>(T, Cp, out, S0, S1, S2, n0, n1, n2, lam, dt, dx,
                                   dy, dz, fuse_x, fuse_y, fuse_z, st);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
