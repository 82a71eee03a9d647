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
// Every division is by a constant of the run and goes through cdiv.cuh: a
// product and two FMAs instead of the IEEE sequence and its slow path, which
// zeros and subnormals took. A phase of a thread's divisions runs
// branch-free (CDivFast) and is computed again with every fallback
// (CDivExact) only where a numerator left the window (tiny, subnormal,
// huge, inf, NaN).
//
// Design of the tiled kernel (`stokes_step_kernel`, the multi-rank route
// where slabs are received): a thread block is a tile of TZ = 32 lanes
// along z (one warp) by R rows along y of one block (8 in float32, 4 in
// float64), walking a chunk of 16 x planes. The eight inputs of the tile
// and of the one row and lane around it are staged in shared memory with
// cp.async, plane i+2 while plane i is updated. Each term is computed once
// a plane, by the thread of its column: its cell's (Pn, txx - Pn, tyy - Pn,
// tzz - Pn), tyz, and txy and txz of x-face i+1, which it carries to the
// next plane with txx - Pn. A neighbour's term comes from the thread that
// computed it, along z by warp shuffles, along y through shared memory (a
// buffer for each of two planes, so one barrier a plane suffices). Three more warps compute what
// the tile's faces read from outside it: the row below (tyy - Pn), the row
// above (txy, tyz) and the lanes on either side (tzz - Pn; txz, tyz). A
// chunk starts one plane early to compute its carries. Values read past
// the block's last row or lane (clamped) feed only faces off the interior,
// whose update is not taken. What bounds it is not the bytes (PERF.md):
// ~20 corrected divisions a cell and the tile's halo warps leave the SMs
// issue- and latency-bound at 2 blocks (22 warps) an SM.
//
// The per-column kernel (`stokes_step_kernel_column`) keeps one thread per
// (block, y, z) column, reading neighbours' terms through L1. It runs the
// all-self route (not on the Stokes example's path), where it recomputes a
// remapped halo cell through the generic functions of stokes.cuh, and a
// multi-rank launch that receives no slab (one block with no exchange:
// config 5's one-block cell), where it measured faster than the tiles
// (PERF.md). 32-bit in-block indices, 64-bit offsets.
#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "stokes.cuh"

namespace {

template <typename T>
struct Outs {
  T *P, *Vx, *Vy, *Vz, *dVx, *dVy, *dVz;
};

// ---------------------------------------------------------------------------
// The per-column kernel (the all-self route; the multi-rank route with no
// slab).
// ---------------------------------------------------------------------------

constexpr int XCHUNK = 16;
constexpr int BZ = 32;
constexpr int BY = 8;

// Field f after the iteration at a cell another one copies (the all-self
// route's halos), in the getter form where `getter`: with CDivFast, again
// with CDivExact where a numerator left the window. Not inlined: one copy
// serves every field and form, and its registers stay off the main path.
template <typename T>
__device__ __noinline__ T halo_update(const Stokes<T>& s, const WaveBlock& b, int f, unsigned i,
                                      unsigned j, unsigned k, bool getter) {
  const auto update = [&](auto&& dv) {
    return getter ? stokes_update<T, FORM_GETTER>(s, b, f, i, j, k, nullptr, dv)
                  : stokes_update<T, FORM_KERNEL>(s, b, f, i, j, k, nullptr, dv);
  };
  CDivFast fast;
  const T v = update(fast);
  return fast.ok ? v : update(CDivExact());
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
// Launch bounds of 2 blocks an SM (128 registers): with the division helper
// inlined, 4 blocks (64 registers) spilled ~1 KB a thread and ran the
// all-self route 2.4x slower (PERF.md).
template <typename T, bool SELF>
__global__ void __launch_bounds__(BZ * BY, 2)
stokes_step_kernel_column(Stokes<T> s, Outs<T> o, Recvs<T> r, SelfMap sm, unsigned nchunk) {
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
    const long long op = at_p(b, i, j, k), ox = at_x(b, i, j, k), oy = at_y(b, i, j, k),
                    oz = at_z(b, i, j, k);
    const T dvx0 = s.dVx[ox], dvy0 = s.dVy[oy], dvz0 = s.dVz[oz];
    const T vx0 = s.Vx[ox], vy0 = s.Vy[oy], vz0 = s.Vz[oz];
    StokesCell<T> c;
    T dvx, dvy, dvz, vx, vy, vz, txy_n, txy_np, txz_n, txz_np;
    // the plane's terms and updates, with CDivFast, then again with
    // CDivExact where a numerator left the window
    const auto plane = [&](auto&& dv) {
      c = stokes_cell(s, b, i, j, k, dv);
      dvx = dvx0;
      dvy = dvy0;
      dvz = dvz0;
      vx = vx0;
      vy = vy0;
      vz = vz0;
      txy_n = txy_np = txz_n = txz_np = T(0);
      if (!faces) return;
      if (i + 2 <= nx) {
        txy_n = stokes_txy(s, b, i + 1, j, k, dv);
        txy_np = stokes_txy(s, b, i + 1, jp, k, dv);
        txz_n = stokes_txz(s, b, i + 1, j, k, dv);
        txz_np = stokes_txz(s, b, i + 1, j, kp, dv);
      }
      const T tyz_c = stokes_tyz(s, b, i, j, k, dv);
      if (vx_interior(nx, ny, nz, i, j, k)) {
        dvx = s.damp * dvx0 + stokes_rx(s, c.a, a_m, txy_cp, txy_c, txz_cp, txz_c, dv);
        vx = vx0 + s.dt_v * dvx;
      }
      if (vy_interior(nx, ny, nz, i, j, k)) {
        const T ty_m = stokes_cell(s, b, i, j - 1, k, dv).ty;
        dvy = s.damp * dvy0 +
              stokes_ry(s, c.ty, ty_m, txy_n, txy_c, stokes_tyz(s, b, i, j, kp, dv), tyz_c, dv);
        vy = vy0 + s.dt_v * dvy;
      }
      if (vz_interior(nx, ny, nz, i, j, k)) {
        const T tz_m = stokes_cell(s, b, i, j, k - 1, dv).tz;
        dvz = s.damp * dvz0 + stokes_rz(s, c.tz, tz_m, txz_n, txz_c,
                                        stokes_tyz(s, b, i, jp, k, dv), tyz_c,
                                        stokes_rg<T, FORM_KERNEL>(s, b, i, j, k), dv);
        vz = vz0 + s.dt_v * dvz;
      }
    };
    CDivFast fast;
    plane(fast);
    if (!fast.ok) plane(CDivExact());
    if (faces) {
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

template <typename T, bool SELF>
int launch_column(const Stokes<T>& s, const Outs<T>& o, const Recvs<T>& r, const SelfMap& sm,
                  cudaStream_t st) {
  const unsigned nchunk = (s.nx + XCHUNK - 1) / XCHUNK;
  if ((unsigned long long)s.D0 * nchunk > 65535 ||
      ((unsigned long long)s.D1 * s.ny + BY - 1) / BY > 65535)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((s.D2 * s.nz + BZ - 1) / BZ, (s.D1 * s.ny + BY - 1) / BY, s.D0 * nchunk);
  stokes_step_kernel_column<T, SELF><<<grid, dim3(BZ, BY), 0, st>>>(s, o, r, sm, nchunk);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The tiled kernel (the multi-rank route where slabs are received).
// ---------------------------------------------------------------------------

constexpr unsigned TZ = 32;  // lanes of a tile: one warp along z
constexpr unsigned AHEAD = 1;  // planes staged ahead (cp.async groups in flight)
// The staged planes of each input a tile holds: the velocities of planes
// i..i+AHEAD+2 (plane i's update reads planes i and i+1, the next plane's
// terms i+1 and i+2), the other inputs of planes i..i+AHEAD+1.
constexpr unsigned VSLOTS = AHEAD + 3, OSLOTS = AHEAD + 2;

// Rows of a tile: float64 takes 4, so the tile's shared memory stays within
// the 48 KB of a static allocation.
template <typename T>
constexpr int tile_rows() {
  return sizeof(T) == 4 ? 8 : 4;
}

// A tile's shared memory. Staged inputs, at [row + 1][lane + 1] for tile
// row row in [-1, R] and lane in [-1, TZ]: the velocities of plane p in slot
// p % VSLOTS (rows -1..R, lanes -1..TZ), P of plane p in slot p % OSLOTS
// (rows -1..R-1, lanes -1..TZ-1), rhog (rows 0..R-1, lanes -1..TZ-1) and the
// damped momenta (rows 0..R-1 and lanes 0..TZ-1, at [row][lane]). Terms of
// plane p, in buffer p % 2: ty of rows -1..R-1 at [row + 1], the carried txy
// (x-face p) and tyz of rows 0..R at [row], and of the side lanes: lane -1's
// tz and lane TZ's carried txz and tyz, by row.
template <typename T, int R>
struct Tile {
  T vx[VSLOTS][R + 2][TZ + 2], vy[VSLOTS][R + 2][TZ + 2], vz[VSLOTS][R + 2][TZ + 2];
  T p[OSLOTS][R + 1][TZ + 1], rh[OSLOTS][R][TZ + 1];
  T dvx[OSLOTS][R][TZ], dvy[OSLOTS][R][TZ], dvz[OSLOTS][R][TZ];
  T ty[2][R + 1][TZ], txy[2][R + 1][TZ], tyz[2][R + 1][TZ];
  T tz_lo[2][R], txz_hi[2][R], tyz_hi[2][R];
};

// The element of each staged tile a thread copies every plane (at most one:
// R <= 14): element `tid` of the velocity tiles (rows -1..R, lanes -1..TZ)
// and of P's (rows -1..R-1, lanes -1..TZ-1), as offsets within a plane of
// each field, clamped into the block.
struct Staging {
  long long vx, vy, vz;  // velocity tiles
  long long p, dvy, dvz;  // P, rhog and dVx share P's strides
  unsigned erh, edv;      // the element's index in the rhog and damped-momentum tiles
  bool v, o, rh, dv;      // whether the thread copies one of each
};

__device__ __forceinline__ Staging staging(const WaveBlock& b, unsigned tid, unsigned R,
                                           unsigned j0, unsigned k0, unsigned ny, unsigned nz) {
  Staging g;
  const unsigned rv = tid / (TZ + 2), lv = tid - rv * (TZ + 2);
  const int j = (int)(j0 + rv) - 1, k = (int)(k0 + lv) - 1;
  const long long jx = clamp_to(j, ny), kx = clamp_to(k, nz);
  g.v = rv < R + 2;
  g.vx = jx * b.sp.row + kx;
  g.vy = (long long)clamp_to(j, ny + 1) * b.sy.row + kx;
  g.vz = jx * b.sz.row + clamp_to(k, nz + 1);
  const unsigned ro = tid / (TZ + 1), lo = tid - ro * (TZ + 1);
  const long long jo = clamp_to((int)(j0 + ro) - 1, ny), ko = clamp_to((int)(k0 + lo) - 1, nz);
  g.o = ro < R + 1;
  g.rh = g.o && ro >= 1;
  g.dv = g.rh && lo >= 1;
  g.p = jo * b.sp.row + ko;
  g.dvy = jo * b.sy.row + ko;
  g.dvz = jo * b.sz.row + ko;
  g.erh = tid - (TZ + 1);
  g.edv = (ro - 1) * TZ + (lo - 1);
  return g;
}

// Stage the velocities of plane p (Vx has nx+1 planes, Vy and Vz nx).
template <typename T, int R>
__device__ __forceinline__ void stage_v(Tile<T, R>& t, const Stokes<T>& s, const WaveBlock& b,
                                        const Staging& g, unsigned tid, unsigned p) {
  if (!g.v) return;
  const unsigned sl = p % VSLOTS;
  if (p <= s.nx) stage1(&t.vx[sl][0][0] + tid, s.Vx + (b.vx + p * b.sp.plane + g.vx));
  if (p < s.nx) {
    stage1(&t.vy[sl][0][0] + tid, s.Vy + (b.vy + p * b.sy.plane + g.vy));
    stage1(&t.vz[sl][0][0] + tid, s.Vz + (b.vz + p * b.sz.plane + g.vz));
  }
}

// Stage P, rhog and the damped momenta of plane p < nx.
template <typename T, int R>
__device__ __forceinline__ void stage_o(Tile<T, R>& t, const Stokes<T>& s, const WaveBlock& b,
                                        const Staging& g, unsigned tid, unsigned p) {
  if (!g.o) return;
  const unsigned sl = p % OSLOTS;
  const long long o = b.p + p * b.sp.plane + g.p;
  stage1(&t.p[sl][0][0] + tid, s.P + o);
  if (g.rh) stage1(&t.rh[sl][0][0] + g.erh, s.rhog + o);
  if (g.dv) {
    stage1(&t.dvx[sl][0][0] + g.edv, s.dVx + (b.vx + p * b.sp.plane + g.p));
    stage1(&t.dvy[sl][0][0] + g.edv, s.dVy + (b.vy + p * b.sy.plane + g.dvy));
    stage1(&t.dvz[sl][0][0] + g.edv, s.dVz + (b.vz + p * b.sz.plane + g.dvz));
  }
}

// What a thread computes each plane: a tile column's terms and update
// (MAIN), or a term the tile's faces read from outside it.
enum Role { MAIN, ROW_LO, ROW_HI, LANE_LO, LANE_HI, IDLE };

// Thread (lane, w) of a block of (TZ, R + 3): warps 0..R-1 the tile's rows,
// warp R the row below it, warp R+1 the row above, warp R+2 the lanes on
// either side (lanes 0..R-1 lane -1 of rows 0..R-1, lanes R..2R-1 lane TZ).
// Blocks: x walks (block row c1, y tile, block lane c2, z tile), y (block
// plane c0, x chunk); a chunk of XCHUNK planes starts one plane early.
//
// One barrier a plane. Between barrier i and barrier i+1 a thread updates
// plane i from the terms computed before barrier i, then computes plane
// i+1's terms into the other term buffer; barrier i also finds plane i+1
// staged, and after it plane i+AHEAD+2 starts to stage (cp.async, one
// group a plane) into the slots of plane i-1. The terms and the residuals divide
// through retry_passes.
//
// Launch bounds of 2 blocks an SM (22 warps in float32): at 3 it spilled and
// ran one block 34% slower (PERF.md).
template <typename T, int R>
__global__ void __launch_bounds__(TZ * (R + 3), 2)
stokes_step_kernel(Stokes<T> s, Outs<T> o, Recvs<T> rv, unsigned ntz, unsigned nty,
                   unsigned nchunk) {
  static_assert(2 * R <= (int)TZ && R <= 14, "one staged element a field and thread");
  __shared__ Tile<T, R> t;
  const unsigned lane = threadIdx.x, w = threadIdx.y, tid = w * TZ + lane;
  const unsigned zt = blockIdx.x % (s.D2 * ntz), yt = blockIdx.x / (s.D2 * ntz);
  const unsigned c2 = zt / ntz, k0 = (zt - c2 * ntz) * TZ;
  const unsigned c1 = yt / nty, j0 = (yt - c1 * nty) * R;
  const unsigned c0 = blockIdx.y / nchunk, i_lo = (blockIdx.y - c0 * nchunk) * XCHUNK;
  const unsigned nx = s.nx, ny = s.ny, nz = s.nz;
  const unsigned i_hi = min(nx, i_lo + XCHUNK), i_first = i_lo ? i_lo - 1 : 0;
  const WaveBlock b = stokes_block(s, c0, c1, c2);
  const Staging g = staging(b, tid, R, j0, k0, ny, nz);
  Role role = MAIN;
  int row = (int)w, col = (int)lane;
  if (w == R) {
    role = ROW_LO;
    row = -1;
  } else if (w == R + 1) {
    role = ROW_HI;
    row = R;
  } else if (w == R + 2) {
    role = lane < R ? LANE_LO : (lane < 2 * R ? LANE_HI : IDLE);
    row = lane < R ? (int)lane : (int)lane - R;
    col = lane < R ? -1 : (int)TZ;
  }
  const unsigned j = j0 + row, k = k0 + col;  // MAIN only
  const bool own = role == MAIN && j < ny && k < nz;
  const auto VX = [&](unsigned p, int rr, int cc) {
    return t.vx[p % VSLOTS][rr + 1][cc + 1];
  };
  const auto VY = [&](unsigned p, int rr, int cc) {
    return t.vy[p % VSLOTS][rr + 1][cc + 1];
  };
  const auto VZ = [&](unsigned p, int rr, int cc) {
    return t.vz[p % VSLOTS][rr + 1][cc + 1];
  };

  // the terms of plane i (carried: a_m of cell i-1, txy_c and txz_c of
  // x-face i; computed: c, tyz, and txy_n and txz_n of x-face i+1)
  T a_m = T(0), txy_c = T(0), txz_c = T(0), txy_n = T(0), txz_n = T(0), tyz = T(0);
  StokesCell<T> c{};
  // plane p's terms, then into term buffer p % 2 what other threads read
  const auto terms = [&](unsigned p) {
    const unsigned q = p % OSLOTS;
    const auto compute = [&](auto&& dv) {
      if (role == MAIN || role == ROW_LO || role == LANE_LO)
        c = stokes_cell_of(s, VX(p, row, col), VX(p + 1, row, col), VY(p, row, col),
                           VY(p, row + 1, col), VZ(p, row, col), VZ(p, row, col + 1),
                           t.p[q][row + 1][col + 1], dv);
      if (role == MAIN || role == ROW_HI)
        txy_n = stokes_edge(s, VX(p + 1, row, col), VX(p + 1, row - 1, col), s.dy,
                            VY(p + 1, row, col), VY(p, row, col), s.dx, dv);
      if (role == MAIN || role == LANE_HI)
        txz_n = stokes_edge(s, VX(p + 1, row, col), VX(p + 1, row, col - 1), s.dz,
                            VZ(p + 1, row, col), VZ(p, row, col), s.dx, dv);
      if (role == MAIN || role == ROW_HI || role == LANE_HI)
        tyz = stokes_edge(s, VY(p, row, col), VY(p, row, col - 1), s.dz, VZ(p, row, col),
                          VZ(p, row - 1, col), s.dy, dv);
    };
    retry_passes(compute);
    const unsigned u = p & 1;
    if (role == MAIN || role == ROW_LO) t.ty[u][row + 1][col] = c.ty;
    if (role == MAIN || role == ROW_HI) {
      t.txy[u][row][col] = txy_c;
      t.tyz[u][row][col] = tyz;
    }
    if (role == LANE_LO) t.tz_lo[u][row] = c.tz;
    if (role == LANE_HI) {
      t.txz_hi[u][row] = txz_c;
      t.tyz_hi[u][row] = tyz;
    }
  };

  stage_v(t, s, b, g, tid, i_first);
  for (unsigned d = 0; d <= AHEAD; ++d) {
    if (i_first + d < i_hi) {
      stage_v(t, s, b, g, tid, i_first + d + 1);
      stage_o(t, s, b, g, tid, i_first + d);
    }
    __pipeline_commit();
  }
  __pipeline_wait_prior(AHEAD);
  __syncthreads();  // plane i_first staged
  terms(i_first);
  for (unsigned i = i_first; i < i_hi; ++i) {
    __pipeline_wait_prior(AHEAD - 1);
    __syncthreads();  // plane i's terms written; plane i+1 staged; plane i-1 read
    if (i + 1 + AHEAD < i_hi) {
      stage_v(t, s, b, g, tid, i + 2 + AHEAD);
      stage_o(t, s, b, g, tid, i + 1 + AHEAD);
    }
    __pipeline_commit();
    if (role == MAIN) {
      const unsigned q = i % OSLOTS, u = i & 1;
      const T txz_up = __shfl_down_sync(0xffffffffu, txz_c, 1);
      const T tyz_up = __shfl_down_sync(0xffffffffu, tyz, 1);
      const T tz_dn = __shfl_up_sync(0xffffffffu, c.tz, 1);
      if (own && i >= i_lo) {
        const T txz_p = lane == TZ - 1 ? t.txz_hi[u][row] : txz_up;
        const T tyz_p = lane == TZ - 1 ? t.tyz_hi[u][row] : tyz_up;
        const T tz_m = lane == 0 ? t.tz_lo[u][row] : tz_dn;
        const T dvx0 = t.dvx[q][row][col], dvy0 = t.dvy[q][row][col], dvz0 = t.dvz[q][row][col];
        const T vx0 = VX(i, row, col), vy0 = VY(i, row, col), vz0 = VZ(i, row, col);
        T dvx = dvx0, dvy = dvy0, dvz = dvz0, vx = vx0, vy = vy0, vz = vz0;
        const bool in_x = vx_interior(nx, ny, nz, i, j, k);
        const bool in_y = vy_interior(nx, ny, nz, i, j, k);
        const bool in_z = vz_interior(nx, ny, nz, i, j, k);
        const auto update = [&](auto&& dv) {
          if (in_x) {
            dvx = s.damp * dvx0 +
                  stokes_rx(s, c.a, a_m, t.txy[u][row + 1][col], txy_c, txz_p, txz_c, dv);
            vx = vx0 + s.dt_v * dvx;
          }
          if (in_y) {
            dvy = s.damp * dvy0 +
                  stokes_ry(s, c.ty, t.ty[u][row][col], txy_n, txy_c, tyz_p, tyz, dv);
            vy = vy0 + s.dt_v * dvy;
          }
          if (in_z) {
            const T rg = stokes_rg_of<T, FORM_KERNEL>(t.rh[q][row][col + 1], t.rh[q][row][col]);
            dvz = s.damp * dvz0 +
                  stokes_rz(s, c.tz, tz_m, txz_n, txz_c, t.tyz[u][row + 1][col], tyz, rg, dv);
            vz = vz0 + s.dt_v * dvz;
          }
        };
        retry_passes(update);
        const long long op = at_p(b, i, j, k), ox = at_x(b, i, j, k), oy = at_y(b, i, j, k),
                        oz = at_z(b, i, j, k);
        const unsigned D1 = s.D1, D2 = s.D2;
        o.P[op] = received_or(rv, 0, nx, ny, nz, D1, D2, c0, c1, c2, i, j, k, c.pn);
        o.Vx[ox] = received_or(rv, 1, nx + 1, ny, nz, D1, D2, c0, c1, c2, i, j, k, vx);
        o.Vy[oy] = received_or(rv, 2, nx, ny + 1, nz, D1, D2, c0, c1, c2, i, j, k, vy);
        o.Vz[oz] = received_or(rv, 3, nx, ny, nz + 1, D1, D2, c0, c1, c2, i, j, k, vz);
        o.dVx[ox] = dvx;
        o.dVy[oy] = dvy;
        o.dVz[oz] = dvz;
        // the extra faces (never updated): their raw or delivered values
        if (i == nx - 1) {
          const long long e = ox + b.sp.plane;
          o.Vx[e] = received_or(rv, 1, nx + 1, ny, nz, D1, D2, c0, c1, c2, nx, j, k,
                                VX(i + 1, row, col));
          o.dVx[e] = s.dVx[e];
        }
        if (j == ny - 1) {
          const long long e = oy + b.sy.row;
          o.Vy[e] = received_or(rv, 2, nx, ny + 1, nz, D1, D2, c0, c1, c2, i, ny, k,
                                VY(i, row + 1, col));
          o.dVy[e] = s.dVy[e];
        }
        if (k == nz - 1) {
          const long long e = oz + 1;
          o.Vz[e] = received_or(rv, 3, nx, ny, nz + 1, D1, D2, c0, c1, c2, i, j, nz,
                                VZ(i, row, col + 1));
          o.dVz[e] = s.dVz[e];
        }
      }
    }
    a_m = c.a;
    txy_c = txy_n;
    txz_c = txz_n;
    if (i + 1 < i_hi) terms(i + 1);
  }
}

template <typename T>
int launch_tiled(const Stokes<T>& s, const Outs<T>& o, const Recvs<T>& r, cudaStream_t st) {
  constexpr int R = tile_rows<T>();
  const unsigned ntz = (s.nz + TZ - 1) / TZ, nty = (s.ny + R - 1) / R;
  const unsigned nchunk = (s.nx + XCHUNK - 1) / XCHUNK;
  const unsigned long long tiles = (unsigned long long)s.D1 * nty * s.D2 * ntz;
  if (tiles > 0x7fffffffULL || (unsigned long long)s.D0 * nchunk > 65535)
    return (int)cudaErrorInvalidValue;
  stokes_step_kernel<T, R><<<dim3((unsigned)tiles, s.D0 * nchunk), dim3(TZ, R + 3), 0, st>>>(
      s, o, r, ntz, nty, nchunk);
  return (int)cudaGetLastError();
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
  bool received = false;
  for (int f = 0; f < 4; ++f)
    for (int d = 0; d < 3; ++d) {
      for (int q = 0; q < 2; ++q)
        r.r[f][d][q] = static_cast<const T*>(ptrs[15 + 6 * f + 2 * d + q]);
      if ((r.r[f][d][0] == nullptr) != (r.r[f][d][1] == nullptr)) return (int)cudaErrorInvalidValue;
      received |= r.r[f][d][0] != nullptr;
      sm.mode[f][d] = (int)g[6 + 3 * f + d];
      sm.ol[f][d] = (unsigned)g[18 + 3 * f + d];
    }
  if (self_mode) return launch_column<T, true>(s, o, r, sm, st);
  // nothing to deliver (one block, no exchange): the per-column kernel,
  // which measured faster there (PERF.md)
  if (!received) return launch_column<T, false>(s, o, r, sm, st);
  return launch_tiled<T>(s, o, r, st);
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
      (g[0] + 1) * (g[1] + 1) * (g[2] + 1) >= lim)
    return (int)cudaErrorInvalidValue;
  switch (dtype) {
    case 0: return launch<float>(self_mode, ptrs, g, c, st);
    case 1: return launch<double>(self_mode, ptrs, g, c, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// The division helper on its own (cdiv.cuh), for its tests and chip_smoke.py.
// ---------------------------------------------------------------------------

namespace {

template <typename T>
__device__ __forceinline__ T ieee_div(T a, T b);
template <>
__device__ __forceinline__ float ieee_div(float a, float b) {
  return __fdiv_rn(a, b);
}
template <>
__device__ __forceinline__ double ieee_div(double a, double b) {
  return __ddiv_rn(a, b);
}

// mode 0: cdiv; 1: the IEEE quotient; 2: retry_passes, as K10's tiles
// divide (CDivFast, CDivExact where it refuses).
template <typename T>
__global__ void cdiv_kernel(const T* a, T* q, long long n, CDiv<T> d, int mode) {
  for (long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x; e < n;
       e += (long long)gridDim.x * blockDim.x) {
    if (mode == 1) {
      q[e] = ieee_div(a[e], d.b);
    } else if (mode == 2) {
      T v;
      retry_passes([&](auto&& dv) { v = dv(a[e], d); });
      q[e] = v;
    } else {
      q[e] = cdiv(a[e], d);
    }
  }
}

// Every float32 bit pattern as a numerator: counts[0] += the quotients that
// differ from __fdiv_rn's in any bit (two NaNs agree), counts[1] += the
// numerators on the corrected path.
__global__ void cdiv_sweep_kernel(CDiv<float> d, unsigned long long* counts) {
  unsigned long long bad = 0, fast = 0;
  for (unsigned long long u = blockIdx.x * (unsigned long long)blockDim.x + threadIdx.x;
       u < (1ULL << 32); u += (unsigned long long)gridDim.x * blockDim.x) {
    const float a = __uint_as_float((unsigned)u);
    const float q = cdiv(a, d), r = __fdiv_rn(a, d.b);
    bad += __float_as_uint(q) != __float_as_uint(r) && !(q != q && r != r);
    fast += cdiv_in_window(a, d);
  }
  atomicAdd(&counts[0], bad);
  atomicAdd(&counts[1], fast);
}

}  // namespace

// q[e] = a[e] / b, e < n, by cdiv_kernel's mode; b is rounded to the dtype
// (0 float32, 1 float64) first.
extern "C" int igg_cdiv(int dtype, const void* a, void* q, long long n, double b, int mode,
                        void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n < 0) return (int)cudaErrorInvalidValue;
  const unsigned blocks = (unsigned)std::min<long long>((n + 255) / 256 + 1, 2 * 132);
  if (dtype == 0)
    cdiv_kernel<float><<<blocks, 256, 0, st>>>(static_cast<const float*>(a),
                                               static_cast<float*>(q), n, make_cdiv((float)b),
                                               mode);
  else if (dtype == 1)
    cdiv_kernel<double><<<blocks, 256, 0, st>>>(static_cast<const double*>(a),
                                                static_cast<double*>(q), n, make_cdiv(b), mode);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// The float32 sweep of cdiv_sweep_kernel for divisor (float)b, adding into
// counts[0] (mismatches) and counts[1] (corrected path), device memory.
extern "C" int igg_cdiv_sweep(double b, void* counts, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cdiv_sweep_kernel<<<132 * 16, 256, 0, st>>>(make_cdiv((float)b),
                                              static_cast<unsigned long long*>(counts));
  return (int)cudaGetLastError();
}
