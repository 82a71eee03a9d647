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
// as the plain PyTorch version's does.
//
// It also holds what the fused staggered steps K9 and K10 (stokes.cu) share:
// the offsets of a block's staggered fields (`staggered_block`) and the halo
// delivery (`Recvs`, `SelfMap`, `self_src`, `received_or`).
#pragma once

#include <cuda_runtime.h>

// The state of every block: P (nx, ny, nz) blocks and the staggered Vx
// (nx+1, ny, nz), Vy (nx, ny+1, nz), Vz (nx, ny, nz+1), D0 x D1 x D2 blocks
// of each, stacked and contiguous.
template <typename T>
struct Wave {
  const T *P, *Vx, *Vy, *Vz;
  unsigned nx, ny, nz, D0, D1, D2;
  T cx, cy, cz, dtK, dx, dy, dz;
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

template <typename T>
__device__ __forceinline__ WaveBlock wave_block(const Wave<T>& w, unsigned c0, unsigned c1,
                                                unsigned c2) {
  return staggered_block(w, c0, c1, c2);
}

template <typename T>
__device__ __forceinline__ T wave_p(const Wave<T>& w, const WaveBlock& b, unsigned i,
                                    unsigned j, unsigned k) {
  return w.P[b.p + i * b.sp.plane + j * b.sp.row + k];
}

// Updated Vx face i in [0, nx] (faces 0 and nx keep their values).
template <typename T>
__device__ __forceinline__ T wave_vx(const Wave<T>& w, const WaveBlock& b, unsigned i,
                                     unsigned j, unsigned k) {
  T v = w.Vx[b.vx + i * b.sp.plane + j * b.sp.row + k];
  if (i >= 1 && i <= w.nx - 1) {
    const T d = wave_p(w, b, i, j, k) - wave_p(w, b, i - 1, j, k);
    v = v + w.cx * d;
  }
  return v;
}

// Updated Vy face j in [0, ny].
template <typename T>
__device__ __forceinline__ T wave_vy(const Wave<T>& w, const WaveBlock& b, unsigned i,
                                     unsigned j, unsigned k) {
  T v = w.Vy[b.vy + i * b.sy.plane + j * b.sy.row + k];
  if (j >= 1 && j <= w.ny - 1) {
    const T d = wave_p(w, b, i, j, k) - wave_p(w, b, i, j - 1, k);
    v = v + w.cy * d;
  }
  return v;
}

// Updated Vz face k in [0, nz].
template <typename T>
__device__ __forceinline__ T wave_vz(const Wave<T>& w, const WaveBlock& b, unsigned i,
                                     unsigned j, unsigned k) {
  T v = w.Vz[b.vz + i * b.sz.plane + j * b.sz.row + k];
  if (k >= 1 && k <= w.nz - 1) {
    const T d = wave_p(w, b, i, j, k) - wave_p(w, b, i, j, k - 1);
    v = v + w.cz * d;
  }
  return v;
}

// Updated pressure from the updated faces around the cell.
template <typename T>
__device__ __forceinline__ T wave_pnew(const Wave<T>& w, const WaveBlock& b, unsigned i,
                                       unsigned j, unsigned k) {
  const T divx = (wave_vx(w, b, i + 1, j, k) - wave_vx(w, b, i, j, k)) / w.dx;
  const T divy = (wave_vy(w, b, i, j + 1, k) - wave_vy(w, b, i, j, k)) / w.dy;
  const T divz = (wave_vz(w, b, i, j, k + 1) - wave_vz(w, b, i, j, k)) / w.dz;
  const T div = (divx + divy) + divz;
  return wave_p(w, b, i, j, k) - w.dtK * div;
}

// Field f (0 P, 1 Vx, 2 Vy, 3 Vz) updated at local (i, j, k) of its block.
template <typename T>
__device__ __forceinline__ T wave_update(const Wave<T>& w, const WaveBlock& b, int f,
                                         unsigned i, unsigned j, unsigned k) {
  switch (f) {
    case 0: return wave_pnew(w, b, i, j, k);
    case 1: return wave_vx(w, b, i, j, k);
    case 2: return wave_vy(w, b, i, j, k);
    default: return wave_vz(w, b, i, j, k);
  }
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
template <typename T>
Wave<T> make_wave(const void* P, const void* Vx, const void* Vy, const void* Vz,
                  const long long* g, const double* c) {
  return Wave<T>{static_cast<const T*>(P), static_cast<const T*>(Vx),
                 static_cast<const T*>(Vy), static_cast<const T*>(Vz),
                 (unsigned)g[0], (unsigned)g[1], (unsigned)g[2], (unsigned)g[3],
                 (unsigned)g[4], (unsigned)g[5],
                 (T)c[0], (T)c[1], (T)c[2], (T)c[3], (T)c[4], (T)c[5], (T)c[6]};
}
