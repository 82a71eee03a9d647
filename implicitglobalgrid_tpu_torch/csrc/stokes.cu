// K10 `igg_stokes_step_exchange`: one pseudo-transient Stokes iteration of
// all eight fields of every block (the pressure, the damped momenta and the
// velocities, stokes.cuh) with the halo delivery of P, Vx, Vy and Vz, in one
// launch. Replaces `stokes_step_exchange_pallas`
// (implicitglobalgrid_tpu/ops/pallas_stokes.py:286, kernel `_stokes_kernel`
// :132, post-kernel extra planes :423-440).
//
// Output cell c of an exchanged field F (P, Vx, Vy, Vz) is JAX's value for it:
// - the multi-rank route: the received value where c lies in F's halo of an
//   exchanging dim, in the z, x, y write order read as a per-cell rule (a
//   y-halo row takes its received value, else an x-halo plane, else a z-halo
//   lane), else F after the iteration at c. The iteration reads only the
//   input state, so no update sees a delivered value.
// - the all-self route (every exchanging dim periodic with one block,
//   `all_self_exchange`): the halos are copies of updated cells of the same
//   block, so c takes F updated at (sx(i), sy(j), sz(k)), where a dim of F's
//   self-exchange maps 0 to n-ol and n-1 to ol-1 (F's own n and ol). A cell
//   whose x index maps elsewhere reads the getter form: JAX takes its x halo
//   planes from the send-slab getters (`self_recvs_and_ols`); every other
//   cell the kernel form (they differ in Vz's buoyancy alone).
// dVx, dVy, dVz are written, never exchanged. The TPU grid has nx programs
// for Vx's nx+1 planes, so JAX writes Vx and dVx plane nx afterwards
// (`vx_extra_plane_slabs`, `vx_extra_planes_self`, `halo_write_inplace`);
// here the thread of the last plane writes face nx itself (a face the
// iteration never updates: its raw value, or its delivered one), as the last
// row and lane threads write Vy face ny and Vz face nz. The VMEM plane relay
// is TPU tiling.
//
// Bound on an H100 SXM (3.35 TB/s): read the eight fields once and write the
// seven updated ones once, 60 bytes a cell in float32 (1.01 GB and 0.30 ms
// for 2x2x2 blocks of 128^3); ~120 operations a cell (stokes.cuh's terms of
// one cell and its three faces) are below the ridge point, so bytes bound it.
// Design: one thread per (block, y, z) column of P's extent, threads along z
// (coalesced), walking XCHUNK planes along x. It computes the terms of its
// cell and of the two cells below it in y and z, the six edge stresses its
// faces read in its plane and the next, and carries txx - Pn of plane i-1 and
// the x-y and x-z edge stresses of face i along x in registers, so a face
// reads about 40 values (mostly neighbours' through L1) instead of recomputing
// every term from memory. A column on the y = 0 or z = 0 boundary updates no
// face and computes the pressure alone; halo cells go through the generic
// functions of stokes.cuh. 32-bit in-block indices, 64-bit offsets.
#include <cuda_runtime.h>
#include <stdint.h>

#include "stokes.cuh"

namespace {

constexpr int XCHUNK = 16;
constexpr int BZ = 32;
constexpr int BY = 8;

template <typename T>
struct Outs {
  T *P, *Vx, *Vy, *Vz, *dVx, *dVy, *dVz;
};

// Field f after the iteration at a cell another one copies (the all-self
// route's halos), in the getter form where `getter`. Not inlined: one copy
// serves every field and form, and its registers stay off the main path.
template <typename T>
__device__ __noinline__ T halo_update(const Stokes<T>& s, const WaveBlock& b, int f, unsigned i,
                                      unsigned j, unsigned k, bool getter) {
  return getter ? stokes_update<T, FORM_GETTER>(s, b, f, i, j, k)
                : stokes_update<T, FORM_KERNEL>(s, b, f, i, j, k);
}

// The value of output cell (i, j, k) of field f in block (c0, c1, c2), where
// `computed` is f after the iteration at that cell (kernel form): the
// received value on a halo cell (multi-rank route), the update at the mapped
// cell (all-self route), else `computed`.
template <typename T, bool SELF>
__device__ __forceinline__ T out_value(const Stokes<T>& s, const WaveBlock& b, int f,
                                       unsigned c0, unsigned c1, unsigned c2, unsigned i,
                                       unsigned j, unsigned k, T computed, const Recvs<T>& r,
                                       const SelfMap& sm) {
  const unsigned m0 = s.nx + (f == 1), m1 = s.ny + (f == 2), m2 = s.nz + (f == 3);
  if (SELF) {
    const unsigned si = self_src(i, m0, sm.mode[f][0], sm.ol[f][0]);
    const unsigned sj = self_src(j, m1, sm.mode[f][1], sm.ol[f][1]);
    const unsigned sk = self_src(k, m2, sm.mode[f][2], sm.ol[f][2]);
    if (si == i && sj == j && sk == k) return computed;
    return halo_update(s, b, f, si, sj, sk, si != i);
  }
  return received_or(r, f, m0, m1, m2, s.D1, s.D2, c0, c1, c2, i, j, k, computed);
}

// One thread: column (j, k) of a block, x planes [i_lo, i_hi). Carried along
// x: a_m = txx - Pn of cell i-1, and the edge stresses txy and txz of x-face
// i at (y-face j, j+1) and (z-face k, k+1); computed at plane i: the terms of
// cells (i, j, k), (i, j-1, k), (i, j, k-1), txy and txz of x-face i+1 (the
// next plane's carries) and tyz of (j, k), (j+1, k), (j, k+1). Neighbour
// indices past the block's last row or lane are clamped: they feed only
// faces off the interior, whose update is not taken.
//
// Thread blocks an SM must hold at once, which bounds registers (64 for
// float32, 128 for float64). Unbounded, K10 held far more registers and ran
// slower on an H100.
template <typename T> constexpr int k10_min_blocks() { return sizeof(T) == 4 ? 4 : 2; }

template <typename T, bool SELF>
__global__ void __launch_bounds__(BZ * BY, k10_min_blocks<T>())
stokes_step_kernel(Stokes<T> s, Outs<T> o, Recvs<T> r, SelfMap sm, unsigned nchunk) {
  const unsigned K = blockIdx.x * blockDim.x + threadIdx.x;
  const unsigned J = blockIdx.y * blockDim.y + threadIdx.y;
  if (K >= s.D2 * s.nz || J >= s.D1 * s.ny) return;
  const unsigned c0 = blockIdx.z / nchunk;
  const unsigned i_lo = (blockIdx.z - c0 * nchunk) * XCHUNK;
  const unsigned i_hi = min(s.nx, i_lo + XCHUNK);
  const unsigned c1 = J / s.ny, j = J - c1 * s.ny;
  const unsigned c2 = K / s.nz, k = K - c2 * s.nz;
  const WaveBlock b = stokes_block(s, c0, c1, c2);
  const unsigned nx = s.nx, ny = s.ny, nz = s.nz;
  // a face of this column can be interior: j >= 1 and k >= 1 (then ny, nz >= 2)
  const bool faces = j >= 1 && k >= 1;
  const unsigned jp = min(j + 1, ny - 1), kp = min(k + 1, nz - 1);
  T a_m = T(0), txy_c = T(0), txy_cp = T(0), txz_c = T(0), txz_cp = T(0);
  if (faces && i_lo >= 1) {
    a_m = stokes_cell(s, b, i_lo - 1, j, k).a;
    txy_c = stokes_txy(s, b, i_lo, j, k);
    txy_cp = stokes_txy(s, b, i_lo, jp, k);
    txz_c = stokes_txz(s, b, i_lo, j, k);
    txz_cp = stokes_txz(s, b, i_lo, j, kp);
  }
  for (unsigned i = i_lo; i < i_hi; ++i) {
    const StokesCell<T> c = stokes_cell(s, b, i, j, k);
    const long long op = at_p(b, i, j, k), ox = at_x(b, i, j, k), oy = at_y(b, i, j, k),
                    oz = at_z(b, i, j, k);
    T dvx = s.dVx[ox], dvy = s.dVy[oy], dvz = s.dVz[oz];
    T vx = s.Vx[ox], vy = s.Vy[oy], vz = s.Vz[oz];
    if (faces) {
      T txy_n = T(0), txy_np = T(0), txz_n = T(0), txz_np = T(0);
      if (i + 2 <= nx) {
        txy_n = stokes_txy(s, b, i + 1, j, k);
        txy_np = stokes_txy(s, b, i + 1, jp, k);
        txz_n = stokes_txz(s, b, i + 1, j, k);
        txz_np = stokes_txz(s, b, i + 1, j, kp);
      }
      const T tyz_c = stokes_tyz(s, b, i, j, k);
      if (vx_interior(nx, ny, nz, i, j, k)) {
        dvx = s.damp * dvx + stokes_rx(s, c.a, a_m, txy_cp, txy_c, txz_cp, txz_c);
        vx = vx + s.dt_v * dvx;
      }
      if (vy_interior(nx, ny, nz, i, j, k)) {
        const T ty_m = stokes_cell(s, b, i, j - 1, k).ty;
        dvy = s.damp * dvy +
              stokes_ry(s, c.ty, ty_m, txy_n, txy_c, stokes_tyz(s, b, i, j, kp), tyz_c);
        vy = vy + s.dt_v * dvy;
      }
      if (vz_interior(nx, ny, nz, i, j, k)) {
        const T tz_m = stokes_cell(s, b, i, j, k - 1).tz;
        dvz = s.damp * dvz + stokes_rz(s, c.tz, tz_m, txz_n, txz_c, stokes_tyz(s, b, i, jp, k),
                                       tyz_c, stokes_rg<T, FORM_KERNEL>(s, b, i, j, k));
        vz = vz + s.dt_v * dvz;
      }
      a_m = c.a;
      txy_c = txy_n;
      txy_cp = txy_np;
      txz_c = txz_n;
      txz_cp = txz_np;
    }
    o.P[op] = out_value<T, SELF>(s, b, 0, c0, c1, c2, i, j, k, c.pn, r, sm);
    o.Vx[ox] = out_value<T, SELF>(s, b, 1, c0, c1, c2, i, j, k, vx, r, sm);
    o.Vy[oy] = out_value<T, SELF>(s, b, 2, c0, c1, c2, i, j, k, vy, r, sm);
    o.Vz[oz] = out_value<T, SELF>(s, b, 3, c0, c1, c2, i, j, k, vz, r, sm);
    o.dVx[ox] = dvx;
    o.dVy[oy] = dvy;
    o.dVz[oz] = dvz;
    // the extra faces (never updated): their raw or delivered values
    if (i == nx - 1) {
      const long long e = ox + b.sp.plane;
      o.Vx[e] = out_value<T, SELF>(s, b, 1, c0, c1, c2, nx, j, k, s.Vx[e], r, sm);
      o.dVx[e] = s.dVx[e];
    }
    if (j == ny - 1) {
      const long long e = oy + b.sy.row;
      o.Vy[e] = out_value<T, SELF>(s, b, 2, c0, c1, c2, i, ny, k, s.Vy[e], r, sm);
      o.dVy[e] = s.dVy[e];
    }
    if (k == nz - 1) {
      const long long e = oz + 1;
      o.Vz[e] = out_value<T, SELF>(s, b, 3, c0, c1, c2, i, j, nz, s.Vz[e], r, sm);
      o.dVz[e] = s.dVz[e];
    }
  }
}

template <typename T>
int launch(int self_mode, const void* const* ptrs, const long long* g, const double* c,
           cudaStream_t st) {
  const Stokes<T> s = make_stokes<T>(ptrs, g, c);
  Outs<T> o;
  T** op[7] = {&o.P, &o.Vx, &o.Vy, &o.Vz, &o.dVx, &o.dVy, &o.dVz};
  for (int f = 0; f < 7; ++f) *op[f] = static_cast<T*>(const_cast<void*>(ptrs[8 + f]));
  Recvs<T> r{};
  SelfMap sm{};
  for (int f = 0; f < 4; ++f)
    for (int d = 0; d < 3; ++d) {
      for (int q = 0; q < 2; ++q)
        r.r[f][d][q] = static_cast<const T*>(ptrs[15 + 6 * f + 2 * d + q]);
      if ((r.r[f][d][0] == nullptr) != (r.r[f][d][1] == nullptr)) return (int)cudaErrorInvalidValue;
      sm.mode[f][d] = (int)g[6 + 3 * f + d];
      sm.ol[f][d] = (unsigned)g[18 + 3 * f + d];
    }
  const unsigned nchunk = (unsigned)((s.nx + XCHUNK - 1) / XCHUNK);
  const dim3 block(BZ, BY);
  const dim3 grid((s.D2 * s.nz + BZ - 1) / BZ, (s.D1 * s.ny + BY - 1) / BY, s.D0 * nchunk);
  if (self_mode)
    stokes_step_kernel<T, true><<<grid, block, 0, st>>>(s, o, r, sm, nchunk);
  else
    stokes_step_kernel<T, false><<<grid, block, 0, st>>>(s, o, r, sm, nchunk);
  return (int)cudaGetLastError();
}

}  // namespace

// K10. dtype: 0 float32, 1 float64. ptrs: P, Vx, Vy, Vz, dVx, dVy, dVz, rhog
// (the state), the outputs of the first seven, then 24 received slabs [field
// P, Vx, Vy, Vz][dim][left, right] (null where none; the multi-rank route).
// g: nx, ny, nz (P's block), D0, D1, D2 (blocks), then the self-exchange
// modes [field][dim] and overlaps [field][dim] (the all-self route,
// self_mode 1). c: mu, dt_v, dt_p, damp, dx, dy, dz. Extents must keep every
// stacked field below 2^31 along each dim and every block below 2^31 cells.
extern "C" int igg_stokes_step_exchange(int dtype, int self_mode, const void* const* ptrs,
                                        const long long* g, const double* c, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long lim = 1LL << 31;
  if (g[0] < 3 || g[1] < 1 || g[2] < 1 || g[3] < 1 || g[4] < 1 || g[5] < 1 ||
      g[3] * (g[0] + 1) >= lim || g[4] * (g[1] + 1) >= lim || g[5] * (g[2] + 1) >= lim ||
      (g[0] + 1) * (g[1] + 1) * (g[2] + 1) >= lim ||
      g[3] * ((g[0] + XCHUNK - 1) / XCHUNK) > 65535 || (g[4] * g[1] + BY - 1) / BY > 65535)
    return (int)cudaErrorInvalidValue;
  switch (dtype) {
    case 0: return launch<float>(self_mode, ptrs, g, c, st);
    case 1: return launch<double>(self_mode, ptrs, g, c, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
