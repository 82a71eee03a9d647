// One pseudo-transient (PT) Stokes iteration at a cell, shared by K10
// (`stokes_step_exchange`, stokes.cu) and the Stokes modes of K4s (the send
// slabs, stencil.cu): a send slab is, bit for bit, what K10 computes at that
// cell in the same form.
//
// The arithmetic is `_stokes_kernel`'s (implicitglobalgrid_tpu/ops/
// pallas_stokes.py:132-254), which has `_stokes_terms`' operation order
// (implicitglobalgrid_tpu/models/stokes.py:151-175) term for term, with the
// constants rounded once to the state dtype:
//   divV = ((Vx[i+1]-Vx[i])/dx + (Vy[j+1]-Vy[j])/dy) + (Vz[k+1]-Vz[k])/dz
//   Pn   = P - dt_p*divV                          (every cell, unmasked)
//   tii  = (2*mu)*((Vi[+1]-Vi)/di - divV/3)       (cells)
//   txy  = mu*((Vx[j]-Vx[j-1])/dy + (Vy[i]-Vy[i-1])/dx)   (x-y edges; xz, yz alike)
//   Rx   = ((A[i]-A[i-1])/dx + (txy[j+1]-txy[j])/dy) + (txz[k+1]-txz[k])/dz,
//          A = txx - Pn (Ry, Rz alike; Rz adds the buoyancy last)
//   dV'  = damp*dV + R,  V' = V + dt_v*dV'        (interior faces only)
// The two sources differ in the buoyancy at z-face k alone: FORM_KERNEL is
// the kernel's 0.5*(rhog[k] + rhog[k-1]), FORM_GETTER `_stokes_terms`'
// 0.5*((rhog[k] - rhog[k-1]) + 2*rhog[k-1]), which JAX's send-slab getters
// (`_v_get_slab`, pallas_stokes.py:102) use. Built with -fmad=false, so each
// operation rounds as the plain PyTorch version's does; every division is by
// a constant of the run (dx, dy, dz, 3) and goes through cdiv.cuh, which
// gives the IEEE quotient bit for bit.
//
// The terms are functions of the values they read (`stokes_cell_of`,
// `stokes_edge`, `stokes_rg_of`), so a kernel that stages its inputs in
// shared memory (K10's tiles) computes exactly what the readers from global
// memory below compute.
#pragma once

#include <cuda_runtime.h>

#include "cdiv.cuh"
#include "wave.cuh"

constexpr int FORM_KERNEL = 0;
constexpr int FORM_GETTER = 1;

// The state of every block: P, rhog (nx, ny, nz) blocks, the staggered Vx
// (nx+1, ny, nz), Vy (nx, ny+1, nz), Vz (nx, ny, nz+1) and dVx, dVy, dVz
// shaped like them, D0 x D1 x D2 blocks of each, stacked and contiguous.
template <typename T>
struct Stokes {
  const T *P, *Vx, *Vy, *Vz, *dVx, *dVy, *dVz, *rhog;
  unsigned nx, ny, nz, D0, D1, D2;
  T mu, dt_v, dt_p, damp;
  CDiv<T> dx, dy, dz, three;
};

template <typename T>
__device__ __forceinline__ WaveBlock stokes_block(const Stokes<T>& s, unsigned c0, unsigned c1,
                                                  unsigned c2) {
  return staggered_block(s, c0, c1, c2);
}

// Offsets of local (i, j, k) in a P-shaped, Vx-, Vy- and Vz-shaped field.
__device__ __forceinline__ long long at_p(const WaveBlock& b, unsigned i, unsigned j,
                                          unsigned k) {
  return b.p + i * b.sp.plane + j * b.sp.row + k;
}
__device__ __forceinline__ long long at_x(const WaveBlock& b, unsigned i, unsigned j,
                                          unsigned k) {
  return b.vx + i * b.sp.plane + j * b.sp.row + k;
}
__device__ __forceinline__ long long at_y(const WaveBlock& b, unsigned i, unsigned j,
                                          unsigned k) {
  return b.vy + i * b.sy.plane + j * b.sy.row + k;
}
__device__ __forceinline__ long long at_z(const WaveBlock& b, unsigned i, unsigned j,
                                          unsigned k) {
  return b.vz + i * b.sz.plane + j * b.sz.row + k;
}

// The cell terms the residuals read: Pn, and txx - Pn, tyy - Pn, tzz - Pn.
template <typename T>
struct StokesCell {
  T pn, a, ty, tz;
};

// The terms of a cell from its faces' velocities (x faces vx0, vx1, y faces
// vy0, vy1, z faces vz0, vz1) and its pressure p. `dv` divides (cdiv.cuh's
// policies; the value-level functions below take one too).
template <typename T, typename Div = CDivExact>
__device__ __forceinline__ StokesCell<T> stokes_cell_of(const Stokes<T>& s, T vx0, T vx1, T vy0,
                                                        T vy1, T vz0, T vz1, T p,
                                                        Div&& dv = Div()) {
  const T gx = dv(vx1 - vx0, s.dx);
  const T gy = dv(vy1 - vy0, s.dy);
  const T gz = dv(vz1 - vz0, s.dz);
  const T div = (gx + gy) + gz;
  const T pn = p - s.dt_p * div;
  const T mu2 = T(2) * s.mu;
  const T d3 = dv(div, s.three);
  return StokesCell<T>{pn, mu2 * (gx - d3) - pn, mu2 * (gy - d3) - pn, mu2 * (gz - d3) - pn};
}

// An edge stress mu*((u1-u0)/du + (w1-w0)/dw): txy = mu*((Vx[j]-Vx[j-1])/dy
// + (Vy[i]-Vy[i-1])/dx), txz and tyz alike.
template <typename T, typename Div = CDivExact>
__device__ __forceinline__ T stokes_edge(const Stokes<T>& s, T u1, T u0, const CDiv<T>& du, T w1,
                                         T w0, const CDiv<T>& dw, Div&& dv = Div()) {
  return s.mu * (dv(u1 - u0, du) + dv(w1 - w0, dw));
}

// The buoyancy at a z-face from rhog of the cells above (hi) and below (lo).
template <typename T, int FORM>
__device__ __forceinline__ T stokes_rg_of(T hi, T lo) {
  if (FORM == FORM_GETTER) return T(0.5) * ((hi - lo) + T(2) * lo);
  return T(0.5) * (hi + lo);
}

// Cell (i, j, k), i < nx, j < ny, k < nz.
template <typename T, typename Div = CDivExact>
__device__ __forceinline__ StokesCell<T> stokes_cell(const Stokes<T>& s, const WaveBlock& b,
                                                     unsigned i, unsigned j, unsigned k,
                                                     Div&& dv = Div()) {
  const long long ox = at_x(b, i, j, k), oy = at_y(b, i, j, k), oz = at_z(b, i, j, k);
  return stokes_cell_of(s, s.Vx[ox], s.Vx[ox + b.sp.plane], s.Vy[oy], s.Vy[oy + b.sy.row],
                        s.Vz[oz], s.Vz[oz + 1], s.P[at_p(b, i, j, k)], dv);
}

// txy at x-face a in [1, nx-1], y-face e in [1, ny-1], lane k < nz.
template <typename T, typename Div = CDivExact>
__device__ __forceinline__ T stokes_txy(const Stokes<T>& s, const WaveBlock& b, unsigned a,
                                        unsigned e, unsigned k, Div&& dv = Div()) {
  const long long ox = at_x(b, a, e, k), oy = at_y(b, a, e, k);
  return stokes_edge(s, s.Vx[ox], s.Vx[ox - b.sp.row], s.dy, s.Vy[oy], s.Vy[oy - b.sy.plane],
                     s.dx, dv);
}

// txz at x-face a in [1, nx-1], row j < ny, z-face f in [1, nz-1].
template <typename T, typename Div = CDivExact>
__device__ __forceinline__ T stokes_txz(const Stokes<T>& s, const WaveBlock& b, unsigned a,
                                        unsigned j, unsigned f, Div&& dv = Div()) {
  const long long ox = at_x(b, a, j, f), oz = at_z(b, a, j, f);
  return stokes_edge(s, s.Vx[ox], s.Vx[ox - 1], s.dz, s.Vz[oz], s.Vz[oz - b.sz.plane], s.dx,
                     dv);
}

// tyz at cell i < nx, y-face e in [1, ny-1], z-face f in [1, nz-1].
template <typename T, typename Div = CDivExact>
__device__ __forceinline__ T stokes_tyz(const Stokes<T>& s, const WaveBlock& b, unsigned i,
                                        unsigned e, unsigned f, Div&& dv = Div()) {
  const long long oy = at_y(b, i, e, f), oz = at_z(b, i, e, f);
  return stokes_edge(s, s.Vy[oy], s.Vy[oy - 1], s.dz, s.Vz[oz], s.Vz[oz - b.sz.row], s.dy,
                     dv);
}

// The buoyancy at z-face f in [1, nz-1] of column (i, j).
template <typename T, int FORM>
__device__ __forceinline__ T stokes_rg(const Stokes<T>& s, const WaveBlock& b, unsigned i,
                                       unsigned j, unsigned f) {
  const long long o = at_p(b, i, j, f);
  return stokes_rg_of<T, FORM>(s.rhog[o], s.rhog[o - 1]);
}

// The residual sums, from their terms.
template <typename T, typename Div = CDivExact>
__device__ __forceinline__ T stokes_rx(const Stokes<T>& s, T a_c, T a_m, T txy_p, T txy_c,
                                       T txz_p, T txz_c, Div&& dv = Div()) {
  return (dv(a_c - a_m, s.dx) + dv(txy_p - txy_c, s.dy)) + dv(txz_p - txz_c, s.dz);
}
template <typename T, typename Div = CDivExact>
__device__ __forceinline__ T stokes_ry(const Stokes<T>& s, T ty_c, T ty_m, T txy_p, T txy_c,
                                       T tyz_p, T tyz_c, Div&& dv = Div()) {
  return (dv(ty_c - ty_m, s.dy) + dv(txy_p - txy_c, s.dx)) + dv(tyz_p - tyz_c, s.dz);
}
template <typename T, typename Div = CDivExact>
__device__ __forceinline__ T stokes_rz(const Stokes<T>& s, T tz_c, T tz_m, T txz_p, T txz_c,
                                       T tyz_p, T tyz_c, T rg, Div&& dv = Div()) {
  return ((dv(tz_c - tz_m, s.dz) + dv(txz_p - txz_c, s.dx)) + dv(tyz_p - tyz_c, s.dy)) + rg;
}

// Interior masks of the face updates (`_stokes_kernel` :238-254).
__device__ __forceinline__ bool vx_interior(unsigned nx, unsigned ny, unsigned nz, unsigned i,
                                            unsigned j, unsigned k) {
  return i >= 1 && i + 1 <= nx && j >= 1 && j + 2 <= ny && k >= 1 && k + 2 <= nz;
}
__device__ __forceinline__ bool vy_interior(unsigned nx, unsigned ny, unsigned nz, unsigned i,
                                            unsigned j, unsigned k) {
  return i >= 1 && i + 2 <= nx && j >= 1 && j + 1 <= ny && k >= 1 && k + 2 <= nz;
}
__device__ __forceinline__ bool vz_interior(unsigned nx, unsigned ny, unsigned nz, unsigned i,
                                            unsigned j, unsigned k) {
  return i >= 1 && i + 2 <= nx && j >= 1 && j + 2 <= ny && k >= 1 && k + 1 <= nz;
}

// The residual at an interior face of Vx (f 1), Vy (2) or Vz (3), every term
// read from the state.
template <typename T, int FORM, typename Div = CDivExact>
__device__ __forceinline__ T stokes_residual(const Stokes<T>& s, const WaveBlock& b, int f,
                                             unsigned i, unsigned j, unsigned k,
                                             Div&& dv = Div()) {
  if (f == 1)
    return stokes_rx(s, stokes_cell(s, b, i, j, k, dv).a, stokes_cell(s, b, i - 1, j, k, dv).a,
                     stokes_txy(s, b, i, j + 1, k, dv), stokes_txy(s, b, i, j, k, dv),
                     stokes_txz(s, b, i, j, k + 1, dv), stokes_txz(s, b, i, j, k, dv), dv);
  if (f == 2)
    return stokes_ry(s, stokes_cell(s, b, i, j, k, dv).ty, stokes_cell(s, b, i, j - 1, k, dv).ty,
                     stokes_txy(s, b, i + 1, j, k, dv), stokes_txy(s, b, i, j, k, dv),
                     stokes_tyz(s, b, i, j, k + 1, dv), stokes_tyz(s, b, i, j, k, dv), dv);
  return stokes_rz(s, stokes_cell(s, b, i, j, k, dv).tz, stokes_cell(s, b, i, j, k - 1, dv).tz,
                   stokes_txz(s, b, i + 1, j, k, dv), stokes_txz(s, b, i, j, k, dv),
                   stokes_tyz(s, b, i, j + 1, k, dv), stokes_tyz(s, b, i, j, k, dv),
                   stokes_rg<T, FORM>(s, b, i, j, k), dv);
}

// Field f (0 P, 1 Vx, 2 Vy, 3 Vz) after the iteration at local (i, j, k) of
// its block; dv_out (f >= 1) receives the damped momentum dV' there. A face
// off the interior keeps its values.
template <typename T, int FORM, typename Div = CDivExact>
__device__ __forceinline__ T stokes_update(const Stokes<T>& s, const WaveBlock& b, int f,
                                           unsigned i, unsigned j, unsigned k,
                                           T* dv_out = nullptr, Div&& dv = Div()) {
  if (f == 0) return stokes_cell(s, b, i, j, k, dv).pn;
  const T* V = f == 1 ? s.Vx : (f == 2 ? s.Vy : s.Vz);
  const T* dV = f == 1 ? s.dVx : (f == 2 ? s.dVy : s.dVz);
  const long long o = f == 1 ? at_x(b, i, j, k) : (f == 2 ? at_y(b, i, j, k) : at_z(b, i, j, k));
  const bool in = f == 1 ? vx_interior(s.nx, s.ny, s.nz, i, j, k)
                         : (f == 2 ? vy_interior(s.nx, s.ny, s.nz, i, j, k)
                                   : vz_interior(s.nx, s.ny, s.nz, i, j, k));
  if (!in) {
    if (dv_out != nullptr) *dv_out = dV[o];
    return V[o];
  }
  const T dn = s.damp * dV[o] + stokes_residual<T, FORM>(s, b, f, i, j, k, dv);
  if (dv_out != nullptr) *dv_out = dn;
  return V[o] + s.dt_v * dn;
}

// The host-side constants (double) rounded once to the state dtype, each
// divisor with its reciprocal (cdiv.cuh). ptrs: the 8 state fields; g: nx,
// ny, nz, D0, D1, D2; c: mu, dt_v, dt_p, damp, dx, dy, dz.
template <typename T>
Stokes<T> make_stokes(const void* const* ptrs, const long long* g, const double* c) {
  return Stokes<T>{static_cast<const T*>(ptrs[0]), static_cast<const T*>(ptrs[1]),
                   static_cast<const T*>(ptrs[2]), static_cast<const T*>(ptrs[3]),
                   static_cast<const T*>(ptrs[4]), static_cast<const T*>(ptrs[5]),
                   static_cast<const T*>(ptrs[6]), static_cast<const T*>(ptrs[7]),
                   (unsigned)g[0], (unsigned)g[1], (unsigned)g[2], (unsigned)g[3],
                   (unsigned)g[4], (unsigned)g[5],
                   (T)c[0], (T)c[1], (T)c[2], (T)c[3],
                   make_cdiv((T)c[4]), make_cdiv((T)c[5]), make_cdiv((T)c[6]), make_cdiv(T(3))};
}
