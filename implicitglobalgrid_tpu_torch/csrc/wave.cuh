// The acoustic leapfrog update of one cell, shared by K9
// (`acoustic_step_exchange`, wave.cu) and the wave modes of K4s (the send
// slabs, stencil.cu): a send slab is, bit for bit, what K9 computes at that
// cell.
//
// The arithmetic is the fused pass's (`_wave_plane_body`,
// implicitglobalgrid_tpu/ops/pallas_wave.py:169): constants rounded once to
// the state dtype (cx = -dt/rho/dx, dtK = dt*K, dx, dy, dz), an interior
// face v + cx*(P[i] - P[i-1]) (a boundary face keeps its value), and
// P - dtK*(((vx[i+1]-vx[i])/dx + (vy[j+1]-vy[j])/dy) + (vz[k+1]-vz[k])/dz)
// from the updated faces. Built with -fmad=false, so each operation rounds
// as the plain PyTorch version's does; the three divisions are by constants
// of the run and go through cdiv.cuh, the IEEE quotient bit for bit.
//
// A bfloat16 state is stored in bfloat16 and computed in float32 with every
// operation's result rounded to bfloat16 (`rs`), and the constants rounded
// to bfloat16: where JAX's Pallas kernel rounds (each operation of
// `_wave_plane_body` on bfloat16 planes with bfloat16 constants), and what
// PyTorch's bfloat16 operations do in the plain versions.
//
// It also holds what the fused staggered steps K9 and K10 (stokes.cu) share:
// the offsets of a block's staggered fields (`staggered_block`) and the halo
// delivery (`Recvs`, `SelfMap`, `self_src`, `received_or`).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "cdiv.cuh"

// The type a stored value is computed in: float for bfloat16, else itself.
template <typename S>
struct ComputeOf {
  using type = S;
};
template <>
struct ComputeOf<__nv_bfloat16> {
  using type = float;
};
template <typename S>
using compute_t = typename ComputeOf<S>::type;

__device__ __forceinline__ float to_c(float v) { return v; }
__device__ __forceinline__ double to_c(double v) { return v; }
__device__ __forceinline__ float to_c(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename S, typename C> __device__ __forceinline__ S from_c(C v);
template <> __device__ __forceinline__ float from_c<float, float>(float v) { return v; }
template <> __device__ __forceinline__ double from_c<double, double>(double v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_c<__nv_bfloat16, float>(float v) {
  return __float2bfloat16_rn(v);
}

// One operation's result rounded to the storage type S (the identity unless
// S is bfloat16).
template <typename S>
__device__ __forceinline__ compute_t<S> rs(compute_t<S> v) {
  return v;
}
template <>
__device__ __forceinline__ float rs<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// A host constant (double) rounded to S, as a value of S's compute type:
// through float for bfloat16, as PyTorch rounds a Python float to it.
template <typename S>
compute_t<S> round_to(double v) {
  return (compute_t<S>)v;
}
template <>
inline float round_to<__nv_bfloat16>(double v) {
  return __bfloat162float(__float2bfloat16_rn((float)v));
}

// The state of every block: P (nx, ny, nz) blocks and the staggered Vx
// (nx+1, ny, nz), Vy (nx, ny+1, nz), Vz (nx, ny, nz+1), D0 x D1 x D2 blocks
// of each, stacked and contiguous.
template <typename S>
struct Wave {
  using C = compute_t<S>;
  const S *P, *Vx, *Vy, *Vz;
  unsigned nx, ny, nz, D0, D1, D2;
  C cx, cy, cz, dtK;
  CDiv<C> dx, dy, dz;
};

// Plane and row strides of a stacked field of blocks (m0, m1, m2).
struct Strides {
  long long plane, row;
};

__device__ __forceinline__ Strides wave_strides(unsigned m1, unsigned m2, unsigned D1,
                                                unsigned D2) {
  const long long row = (long long)D2 * m2;
  return Strides{(long long)D1 * m1 * row, row};
}

// Offsets of local (0, 0, 0) of one block in each field, and their strides.
struct WaveBlock {
  long long p, vx, vy, vz;
  Strides sp, sy, sz;  // P and Vx share sp
};

// Offsets of block (c0, c1, c2) in stacked P (nx, ny, nz) blocks and the
// staggered Vx, Vy, Vz blocks, D1 x D2 blocks across y and z, of a state `w`
// with those extents (a Wave or a Stokes).
template <typename W>
__device__ __forceinline__ WaveBlock staggered_block(const W& w, unsigned c0, unsigned c1,
                                                     unsigned c2) {
  WaveBlock b;
  b.sp = wave_strides(w.ny, w.nz, w.D1, w.D2);
  b.sy = wave_strides(w.ny + 1, w.nz, w.D1, w.D2);
  b.sz = wave_strides(w.ny, w.nz + 1, w.D1, w.D2);
  const long long j0 = (long long)c1 * w.ny, k0 = (long long)c2 * w.nz;
  b.p = (long long)c0 * w.nx * b.sp.plane + j0 * b.sp.row + k0;
  b.vx = (long long)c0 * (w.nx + 1) * b.sp.plane + j0 * b.sp.row + k0;
  b.vy = (long long)c0 * w.nx * b.sy.plane + (long long)c1 * (w.ny + 1) * b.sy.row + k0;
  b.vz = (long long)c0 * w.nx * b.sz.plane + j0 * b.sz.row + (long long)c2 * (w.nz + 1);
  return b;
}

template <typename S>
__device__ __forceinline__ WaveBlock wave_block(const Wave<S>& w, unsigned c0, unsigned c1,
                                                unsigned c2) {
  return staggered_block(w, c0, c1, c2);
}

// An updated face v + c*(hi - lo), each operation rounded to S.
template <typename S>
__device__ __forceinline__ compute_t<S> wave_face(compute_t<S> v, compute_t<S> c,
                                                  compute_t<S> hi, compute_t<S> lo) {
  return rs<S>(v + rs<S>(c * rs<S>(hi - lo)));
}

// The pressure update from the six updated faces around a cell and its
// pressure p; `dv` divides (cdiv.cuh's CDivExact or CDivFast).
template <typename S, typename Div = CDivExact>
__device__ __forceinline__ compute_t<S> wave_pressure(const Wave<S>& w, compute_t<S> p,
                                                      compute_t<S> ux0, compute_t<S> ux1,
                                                      compute_t<S> uy0, compute_t<S> uy1,
                                                      compute_t<S> uz0, compute_t<S> uz1,
                                                      Div&& dv = Div()) {
  const compute_t<S> divx = rs<S>(dv(rs<S>(ux1 - ux0), w.dx));
  const compute_t<S> divy = rs<S>(dv(rs<S>(uy1 - uy0), w.dy));
  const compute_t<S> divz = rs<S>(dv(rs<S>(uz1 - uz0), w.dz));
  const compute_t<S> div = rs<S>(rs<S>(divx + divy) + divz);
  return rs<S>(p - rs<S>(w.dtK * div));
}

template <typename S>
__device__ __forceinline__ compute_t<S> wave_p(const Wave<S>& w, const WaveBlock& b,
                                               unsigned i, unsigned j, unsigned k) {
  return to_c(w.P[b.p + i * b.sp.plane + j * b.sp.row + k]);
}

// Updated Vx face i in [0, nx] (faces 0 and nx keep their values).
template <typename S>
__device__ __forceinline__ compute_t<S> wave_vx(const Wave<S>& w, const WaveBlock& b,
                                                unsigned i, unsigned j, unsigned k) {
  const compute_t<S> v = to_c(w.Vx[b.vx + i * b.sp.plane + j * b.sp.row + k]);
  if (i < 1 || i > w.nx - 1) return v;
  return wave_face<S>(v, w.cx, wave_p(w, b, i, j, k), wave_p(w, b, i - 1, j, k));
}

// Updated Vy face j in [0, ny].
template <typename S>
__device__ __forceinline__ compute_t<S> wave_vy(const Wave<S>& w, const WaveBlock& b,
                                                unsigned i, unsigned j, unsigned k) {
  const compute_t<S> v = to_c(w.Vy[b.vy + i * b.sy.plane + j * b.sy.row + k]);
  if (j < 1 || j > w.ny - 1) return v;
  return wave_face<S>(v, w.cy, wave_p(w, b, i, j, k), wave_p(w, b, i, j - 1, k));
}

// Updated Vz face k in [0, nz].
template <typename S>
__device__ __forceinline__ compute_t<S> wave_vz(const Wave<S>& w, const WaveBlock& b,
                                                unsigned i, unsigned j, unsigned k) {
  const compute_t<S> v = to_c(w.Vz[b.vz + i * b.sz.plane + j * b.sz.row + k]);
  if (k < 1 || k > w.nz - 1) return v;
  return wave_face<S>(v, w.cz, wave_p(w, b, i, j, k), wave_p(w, b, i, j, k - 1));
}

// Updated pressure from the updated faces around the cell.
template <typename S>
__device__ __forceinline__ compute_t<S> wave_pnew(const Wave<S>& w, const WaveBlock& b,
                                                  unsigned i, unsigned j, unsigned k) {
  return wave_pressure(w, wave_p(w, b, i, j, k), wave_vx(w, b, i, j, k),
                       wave_vx(w, b, i + 1, j, k), wave_vy(w, b, i, j, k),
                       wave_vy(w, b, i, j + 1, k), wave_vz(w, b, i, j, k),
                       wave_vz(w, b, i, j, k + 1));
}

// Field f (0 P, 1 Vx, 2 Vy, 3 Vz) updated at local (i, j, k) of its block,
// as a stored value.
template <typename S>
__device__ __forceinline__ S wave_update(const Wave<S>& w, const WaveBlock& b, int f,
                                         unsigned i, unsigned j, unsigned k) {
  using C = compute_t<S>;
  C v;
  switch (f) {
    case 0: v = wave_pnew(w, b, i, j, k); break;
    case 1: v = wave_vx(w, b, i, j, k); break;
    case 2: v = wave_vy(w, b, i, j, k); break;
    default: v = wave_vz(w, b, i, j, k); break;
  }
  return from_c<S, C>(v);
}

// Received slabs of the fused staggered steps (K9, K10; halowidth 1, K2's
// layout: the field's stacked shape with the dim at its block count),
// [field P, Vx, Vy, Vz][dim][side], null where none.
template <typename T>
struct Recvs {
  const T* r[4][3][2];
};

// The self-exchange of each field: mode and overlap per dim.
struct SelfMap {
  int mode[4][3];
  unsigned ol[4][3];
};

__device__ __forceinline__ unsigned self_src(unsigned i, unsigned n, int mode, unsigned ol) {
  if (!mode) return i;
  return i == 0 ? n - ol : (i == n - 1 ? ol - 1 : i);
}

// Output cell (i, j, k) of field f (blocks m0 x m1 x m2, D1 x D2 of them
// across y and z) in block (c0, c1, c2): its received value where it lies in
// an exchanging dim's halo, in the z, x, y write order read as a per-cell
// rule (a y-halo row over an x-halo plane over a z-halo lane), else
// `computed`.
template <typename T>
__device__ __forceinline__ T received_or(const Recvs<T>& r, int f, unsigned m0, unsigned m1,
                                         unsigned m2, unsigned D1, unsigned D2, unsigned c0,
                                         unsigned c1, unsigned c2, unsigned i, unsigned j,
                                         unsigned k, T computed) {
  const long long S1 = (long long)D1 * m1, S2 = (long long)D2 * m2;
  const long long I = (long long)c0 * m0 + i, J = (long long)c1 * m1 + j,
                  K = (long long)c2 * m2 + k;
  if (r.r[f][1][0] != nullptr && (j == 0 || j == m1 - 1))
    return (j == 0 ? r.r[f][1][0] : r.r[f][1][1])[(I * D1 + c1) * S2 + K];
  if (r.r[f][0][0] != nullptr && (i == 0 || i == m0 - 1))
    return (i == 0 ? r.r[f][0][0] : r.r[f][0][1])[((long long)c0 * S1 + J) * S2 + K];
  if (r.r[f][2][0] != nullptr && (k == 0 || k == m2 - 1))
    return (k == 0 ? r.r[f][2][0] : r.r[f][2][1])[(I * S1 + J) * D2 + c2];
  return computed;
}

// The host-side constants (double) rounded once to the state dtype.
template <typename S>
Wave<S> make_wave(const void* P, const void* Vx, const void* Vy, const void* Vz,
                  const long long* g, const double* c) {
  return Wave<S>{static_cast<const S*>(P), static_cast<const S*>(Vx),
                 static_cast<const S*>(Vy), static_cast<const S*>(Vz),
                 (unsigned)g[0], (unsigned)g[1], (unsigned)g[2], (unsigned)g[3],
                 (unsigned)g[4], (unsigned)g[5],
                 round_to<S>(c[0]), round_to<S>(c[1]), round_to<S>(c[2]), round_to<S>(c[3]),
                 make_cdiv(round_to<S>(c[4])), make_cdiv(round_to<S>(c[5])),
                 make_cdiv(round_to<S>(c[6]))};
}
