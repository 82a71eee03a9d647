// K9 `igg_acoustic_step_exchange`: one acoustic leapfrog step of every block
// (the velocity faces from the pressure gradient, the pressure from the
// divergence of the updated faces) with the halo delivery of P, Vx, Vy and Vz,
// in one launch. Replaces `acoustic_step_exchange_pallas`
// (implicitglobalgrid_tpu/ops/pallas_wave.py:386; kernels `_wave_kernel`
// :227, `_wave_mp_kernel` :305, body `_wave_plane_body` :169).
//
// Output cell c of field F is JAX's value for it:
// - the multi-rank route: the received value where c lies in F's halo of an
//   exchanging dim, in the z, x, y write order read as a per-cell rule (a
//   y-halo row takes its received value, else an x-halo plane, else a z-halo
//   lane), else F updated at c (wave.cuh). The pressure of a cell off every
//   halo reads only faces no delivery touches, so computing it from the
//   updated faces is the fused pass's value; a pressure halo cell takes its
//   received value either way.
// - the all-self route (every exchanging dim periodic with one block,
//   `all_self_exchange`): the halos are copies of updated cells of the same
//   block, so c takes F updated at (sx(i), sy(j), sz(k)), where a dim of F's
//   self-exchange maps 0 to n-ol and n-1 to ol-1 (n and ol are F's own), as
//   K1 folds the diffusion halos. No slabs at all.
// The TPU grid has nx programs for Vx's nx+1 planes, so JAX writes Vx planes
// 0 and nx afterwards (`vx_extra_plane_slabs`, `halo_write_inplace`); here a
// thread writes every face of its column itself, with the same final bits.
// `wave_mp_planes`, the VMEM relay and the window handoff are TPU tiling.
//
// Bound on an H100 SXM (3.35 TB/s): read the four fields once and write them
// once, 8 bytes a cell in float32 (1.82 GB and 0.54 ms for 2x2x2 blocks of
// 192^3); ~30 operations a pressure cell is far below the ridge point, so
// bytes bound it. Design: one thread per (block, y, z) column of P's extent,
// threads along z (coalesced), walking XCHUNK planes along x; it computes the
// faces of its cell once and carries P[i] and Vx face i along x in registers
// (about 10 loads a pressure cell, the y and z neighbours through L1), and
// only halo cells go through the generic functions of wave.cuh. 32-bit
// in-block indices, 64-bit offsets.
#include <cuda_runtime.h>
#include <stdint.h>

#include "wave.cuh"

namespace {

constexpr int XCHUNK = 16;
constexpr int BZ = 32;
constexpr int BY = 8;

template <typename T>
struct Outs {
  T *P, *Vx, *Vy, *Vz;
};

// Block extents (m0, m1, m2) of field f.
struct Ext {
  unsigned m0, m1, m2;
};

template <typename T>
__device__ __forceinline__ Ext field_ext(const Wave<T>& w, int f) {
  return Ext{w.nx + (f == 1), w.ny + (f == 2), w.nz + (f == 3)};
}

// The value of output cell (i, j, k) of field f in block (c0, c1, c2), where
// `computed` is f updated at that cell: the received value on a halo cell
// (multi-rank route), the update at the mapped cell (all-self route), else
// `computed`.
template <typename T, bool SELF>
__device__ __forceinline__ T out_value(const Wave<T>& w, const WaveBlock& b, int f,
                                       unsigned c0, unsigned c1, unsigned c2, unsigned i,
                                       unsigned j, unsigned k, T computed, const Recvs<T>& r,
                                       const SelfMap& sm) {
  const Ext e = field_ext(w, f);
  if (SELF) {
    const unsigned si = self_src(i, e.m0, sm.mode[f][0], sm.ol[f][0]);
    const unsigned sj = self_src(j, e.m1, sm.mode[f][1], sm.ol[f][1]);
    const unsigned sk = self_src(k, e.m2, sm.mode[f][2], sm.ol[f][2]);
    if (si == i && sj == j && sk == k) return computed;
    return wave_update(w, b, f, si, sj, sk);
  }
  return received_or(r, f, e.m0, e.m1, e.m2, w.D1, w.D2, c0, c1, c2, i, j, k, computed);
}

// Thread blocks an SM must hold at once, which bounds registers (64 for
// float32, 80 for float64); the halo paths that call the generic functions
// are rare.
template <typename T> constexpr int k9_min_blocks() { return sizeof(T) == 4 ? 4 : 3; }

// One thread: column (j, k) of a block, x planes [i_lo, i_hi). It computes the
// faces of its cell once (wave.cuh's operations, in the same order), carries
// P[i] and Vx face i along x in registers, and writes the cell of each field;
// the thread of the last plane, row or lane also writes the extra face of Vx,
// Vy or Vz.
template <typename T, bool SELF>
__global__ void __launch_bounds__(BZ * BY, k9_min_blocks<T>())
acoustic_step_kernel(Wave<T> w, Outs<T> o, Recvs<T> r, SelfMap sm, unsigned nchunk) {
  const unsigned K = blockIdx.x * blockDim.x + threadIdx.x;
  const unsigned J = blockIdx.y * blockDim.y + threadIdx.y;
  if (K >= w.D2 * w.nz || J >= w.D1 * w.ny) return;
  const unsigned c0 = blockIdx.z / nchunk;
  const unsigned i_lo = (blockIdx.z - c0 * nchunk) * XCHUNK;
  const unsigned i_hi = min(w.nx, i_lo + XCHUNK);
  const unsigned c1 = J / w.ny, j = J - c1 * w.ny;
  const unsigned c2 = K / w.nz, k = K - c2 * w.nz;
  const WaveBlock b = wave_block(w, c0, c1, c2);
  const long long pl = b.sp.plane, row = b.sp.row;
  const long long pc = b.p + j * row + k, xc = b.vx + j * row + k;
  const long long yc = b.vy + j * b.sy.row + k, zc = b.vz + j * b.sz.row + k;
  T p_c = w.P[pc + i_lo * pl];
  T ux_c = w.Vx[xc + i_lo * pl];
  if (i_lo >= 1) {
    const T d = p_c - w.P[pc + (i_lo - 1) * pl];
    ux_c = ux_c + w.cx * d;
  }
  for (unsigned i = i_lo; i < i_hi; ++i) {
    const long long op = pc + i * pl;
    const T p_p = i + 1 < w.nx ? w.P[op + pl] : T(0);
    T ux_p = w.Vx[xc + (i + 1) * pl];
    if (i + 1 <= w.nx - 1) {
      const T d = p_p - p_c;
      ux_p = ux_p + w.cx * d;
    }
    const long long oy = yc + i * b.sy.plane, oz = zc + i * b.sz.plane;
    T uy_c = w.Vy[oy], uy_p = w.Vy[oy + b.sy.row];
    if (j >= 1) {
      const T d = p_c - w.P[op - row];
      uy_c = uy_c + w.cy * d;
    }
    if (j + 1 <= w.ny - 1) {
      const T d = w.P[op + row] - p_c;
      uy_p = uy_p + w.cy * d;
    }
    T uz_c = w.Vz[oz], uz_p = w.Vz[oz + 1];
    if (k >= 1) {
      const T d = p_c - w.P[op - 1];
      uz_c = uz_c + w.cz * d;
    }
    if (k + 1 <= w.nz - 1) {
      const T d = w.P[op + 1] - p_c;
      uz_p = uz_p + w.cz * d;
    }
    const T divx = (ux_p - ux_c) / w.dx;
    const T divy = (uy_p - uy_c) / w.dy;
    const T divz = (uz_p - uz_c) / w.dz;
    const T div = (divx + divy) + divz;
    const T pn = p_c - w.dtK * div;
    o.P[op] = out_value<T, SELF>(w, b, 0, c0, c1, c2, i, j, k, pn, r, sm);
    o.Vx[xc + i * pl] = out_value<T, SELF>(w, b, 1, c0, c1, c2, i, j, k, ux_c, r, sm);
    if (i == w.nx - 1)
      o.Vx[xc + (i + 1) * pl] = out_value<T, SELF>(w, b, 1, c0, c1, c2, i + 1, j, k, ux_p, r, sm);
    o.Vy[oy] = out_value<T, SELF>(w, b, 2, c0, c1, c2, i, j, k, uy_c, r, sm);
    if (j == w.ny - 1)
      o.Vy[oy + b.sy.row] = out_value<T, SELF>(w, b, 2, c0, c1, c2, i, j + 1, k, uy_p, r, sm);
    o.Vz[oz] = out_value<T, SELF>(w, b, 3, c0, c1, c2, i, j, k, uz_c, r, sm);
    if (k == w.nz - 1)
      o.Vz[oz + 1] = out_value<T, SELF>(w, b, 3, c0, c1, c2, i, j, k + 1, uz_p, r, sm);
    p_c = p_p;
    ux_c = ux_p;
  }
}

template <typename T>
int launch(int self_mode, const void* const* ptrs, const long long* g, const double* c,
           cudaStream_t st) {
  const Wave<T> w = make_wave<T>(ptrs[0], ptrs[1], ptrs[2], ptrs[3], g, c);
  const Outs<T> o{static_cast<T*>(const_cast<void*>(ptrs[4])),
                  static_cast<T*>(const_cast<void*>(ptrs[5])),
                  static_cast<T*>(const_cast<void*>(ptrs[6])),
                  static_cast<T*>(const_cast<void*>(ptrs[7]))};
  Recvs<T> r{};
  SelfMap sm{};
  for (int f = 0; f < 4; ++f)
    for (int d = 0; d < 3; ++d) {
      for (int s = 0; s < 2; ++s) r.r[f][d][s] = static_cast<const T*>(ptrs[8 + 6 * f + 2 * d + s]);
      if ((r.r[f][d][0] == nullptr) != (r.r[f][d][1] == nullptr)) return (int)cudaErrorInvalidValue;
      sm.mode[f][d] = (int)g[6 + 3 * f + d];
      sm.ol[f][d] = (unsigned)g[18 + 3 * f + d];
    }
  const unsigned nchunk = (unsigned)((w.nx + XCHUNK - 1) / XCHUNK);
  const dim3 block(BZ, BY);
  const dim3 grid((w.D2 * w.nz + BZ - 1) / BZ, (w.D1 * w.ny + BY - 1) / BY, w.D0 * nchunk);
  if (self_mode)
    acoustic_step_kernel<T, true><<<grid, block, 0, st>>>(w, o, r, sm, nchunk);
  else
    acoustic_step_kernel<T, false><<<grid, block, 0, st>>>(w, o, r, sm, nchunk);
  return (int)cudaGetLastError();
}

}  // namespace

// K9. dtype: 0 float32, 1 float64. ptrs: P, Vx, Vy, Vz (the state), their
// outputs, then 24 received slabs [field P, Vx, Vy, Vz][dim][left, right]
// (null where none; the multi-rank route). g: nx, ny, nz (P's block), D0,
// D1, D2 (blocks), then the self-exchange modes [field][dim] and overlaps
// [field][dim] (the all-self route, self_mode 1). c: cx, cy, cz, dtK, dx, dy,
// dz. Extents must keep every stacked field below 2^31 along each dim and
// every block below 2^31 cells.
extern "C" int igg_acoustic_step_exchange(int dtype, int self_mode, const void* const* ptrs,
                                          const long long* g, const double* c,
                                          void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long lim = 1LL << 31;
  if (g[0] < 3 || g[1] < 1 || g[2] < 1 || g[3] < 1 || g[4] < 1 || g[5] < 1 ||
      g[3] * (g[0] + 1) >= lim || g[4] * (g[1] + 1) >= lim || g[5] * (g[2] + 1) >= lim ||
      (g[0] + 1) * (g[1] + 1) * (g[2] + 1) >= lim ||
      g[3] * ((g[0] + XCHUNK) / XCHUNK) > 65535 || (g[4] * (g[1] + 1) + BY - 1) / BY > 65535)
    return (int)cudaErrorInvalidValue;
  switch (dtype) {
    case 0: return launch<float>(self_mode, ptrs, g, c, st);
    case 1: return launch<double>(self_mode, ptrs, g, c, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
