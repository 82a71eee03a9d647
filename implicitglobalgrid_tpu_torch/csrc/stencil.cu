// The diffusion kernels: K1 (step + folded self-neighbour halos), K4 (3-D
// step + delivery of received slabs), K5 (2-D step + delivery) and K4s (the
// send slabs of the exchange pipeline). Every cell update rounds as the one
// expression of `step_cell`: a face flux nlam * (b - a) / d, the difference
// of a cell's two faces over d, accumulated x, y, z, then tc + dt * (acc /
// Cp). K1 and K4 divide by the spacings through cdiv.cuh, which is the IEEE
// quotient bit for bit, so a halo value that K4s computes for a neighbour is
// bit for bit the value K1 or K4 computes in place.
//
// K1 replaces `_plane_halo_kernel` (diffusion3d_step_halo_pallas /
// diffusion3d_step_pallas, implicitglobalgrid_tpu/ops/pallas_stencil.py:72)
// and `_mp_kernel` + its x-plane patch (diffusion3d_step_halo_pallas_mp,
// pallas_stencil.py:839-959). Output cell (i, j, k) of a block of shape
// (n0, n1, n2) is U(sx(i), sy(j), sz(k)), U = interior ? step(T) : T, where
// sx/sy/sz are the identity unless that dim's halo update is fused; then index
// 0 reads n-2 and n-1 reads 1 (`_sigma`, pallas_stencil.py:122). Composing the
// index maps reproduces the sequential z, x, y exchange, corners included
// (pallas_stencil.py:93-95,113-118). The interior mask is taken at the SOURCE
// index (pallas_stencil.py:110-112). Here each source cell is computed once
// and written to every output cell that reads it (`mirror_mask`).
//
// K4 replaces `_plane_step_recv_kernel` / `_mp_step_recv_kernel`
// (diffusion3d_step_exchange_pallas, pallas_stencil.py:278,314,366): K1's
// unfused value, overwritten by the received slabs in the reference's z, x, y
// write order read as a per-cell rule (pallas_stencil.py:302-311): a y-halo
// row takes ry, else an x-halo plane takes rx, else a z-halo lane takes rz.
//
// K5 replaces `_strip2d_kernel` (diffusion2d_step_exchange_pallas,
// pallas_stencil.py:999,1104): the 2-D step in `_stencil_row`'s order
// (pallas_stencil.py:593-598), then x rows, then y lanes (:1094-1101). A 2-D
// field (S0, S1) runs as (S0, 1, S1): the y derivative sits in the z slot,
// on the contiguous axis. The R-row strips and H-row tiles of the TPU kernel
// are VMEM tiling and have no counterpart here.
//
// K4s `exchange_slabs` computes, for one exchanging dim, the RECEIVED slabs of
// every block in one launch: the send slab of the neighbour block (an update
// of the state as `_xla_update_slab`, pallas_stencil.py:239, computes it, or a
// plain copy for a standalone exchange), patched with the values that block
// received along earlier dims (the corners, `exchange_recv_slabs_multi`,
// implicitglobalgrid_tpu/ops/halo.py:335-344), moved by the axis permutation,
// and on PROC_NULL edges the block's own patched current halo. The JAX
// package does this with XLA slices, ppermutes and selects; here it is one
// launch per dim, because plain PyTorch would take dozens of launches a step.
// Its wave modes (3 to 6: P, Vx, Vy, Vz) take the send slabs of the fused
// acoustic step: the field updated by the leapfrog on the slab, JAX's getters
// `_make_v_get_slab` / `_make_p_get_slab` (pallas_wave.py:109,127), through
// the per-cell functions of wave.cuh that K9 uses, so a send slab is bit for
// bit what K9 computes at that cell. Its Stokes modes (7 to 10) take the send
// slabs of the fused PT iteration: the field after the iteration, JAX's
// getters `_pn_get_slab` / `_v_get_slab` (pallas_stokes.py:87,102), through
// the per-cell functions of stokes.cuh in their getter form.
//
// Arithmetic: `_stencil_plane` / `_stencil_row` accumulation order; built
// with -fmad=false so that no multiply-add is contracted and every operation
// rounds as the plain version's does. bfloat16 states are computed in float
// with float constants.
//
// Bound on an H100 SXM (3.35 TB/s): K1, K4 and K5 read T and Cp and write
// the new state, 3 x itemsize bytes a cell (1.61 GB and 0.48 ms for a 512^3
// float32 stack); ~30 operations a cell is far below the ridge point, so they
// are bound by bytes.
//
// Design of K1 and K4 (`step_tile`): a thread block is a tile of TZ = 32
// lanes along z (one warp) by R rows along y of one block (8 rows, 4 for
// float64), walking a chunk of TCHUNK = 32 planes along x, one thread a
// column. The tile's T plane with the row and lane around it, and its Cp
// plane, are staged in shared memory by cp.async two planes ahead of the
// plane being updated (a plain copy for bfloat16, whose 2 bytes cp.async
// does not take), so the loads are in flight while earlier planes compute,
// and every T value is read from device memory once. Each face flux is
// computed once a plane by one thread: the x face along the walk, carried
// in a register; the y and z faces beyond a cell by its thread, read by the
// next row and lane through shared memory; the faces that enter the tile
// (below row 0, before lane 0) by rows 0 and 1. So a cell takes six
// quotients by the spacings and the IEEE division by Cp, against nine IEEE
// divisions. The spacings divide through cdiv.cuh's corrected products,
// branch-free, again with every fallback only where a numerator left the
// window (`retry_passes`). One barrier a plane: the faces of plane i+1 are
// computed after plane i's update, into the other of two face buffers. The
// loop is unrolled by the four slots of the staged planes, so every slot is
// a constant. Output cells that take a halo value are not written by the
// main loop: K1 writes each computed source cell also to the fused halo
// cells that read it (out of line where that is another plane or row); K4
// delivers the received values of its column after the walk. 32-bit
// in-block indices, 64-bit offsets. PERF.md has the designs measured on
// the way (per-thread strips in registers, deeper staging, out-of-line
// retries).
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "stokes.cuh"
#include "wave.cuh"

namespace {

constexpr int THREADS = 256;

// -lam, dt and the spacings as cdiv.cuh divisors (`b` is the spacing).
template <typename C> struct Consts {
  C nlam, dt;
  CDiv<C> dx, dy, dz;
};

template <typename C>
Consts<C> make_consts(double lam, double dt, double dx, double dy, double dz) {
  return Consts<C>{-(C)lam, (C)dt, make_cdiv((C)dx), make_cdiv((C)dy), make_cdiv((C)dz)};
}

// The IEEE division by a spacing (K5 and the K4s step modes).
struct IEEEDiv {
  template <typename C>
  __device__ __forceinline__ C operator()(C a, const CDiv<C>& d) const {
    return a / d.b;
  }
};

// Flux through the face between a and its neighbour b beyond it, along the
// dim of spacing d.
template <typename C, typename Div>
__device__ __forceinline__ C face_flux(C a, C b, C nlam, const CDiv<C>& d, Div&& dv) {
  return dv(nlam * (b - a), d);
}

template <typename C>
__device__ __forceinline__ C xflux(C a, C b, const Consts<C>& k) {
  return face_flux(a, b, k.nlam, k.dx, IEEEDiv());
}

// The new value of one interior cell. qxl is the flux through its left x
// face; the right one is returned in qxr (the next cell's left face, so a
// sweep along x can reuse it bit for bit). HAS_Y = false is the 2-D form: no
// y term, and the z slot carries the 2-D y derivative (dz = dy).
template <typename C, bool HAS_Y>
__device__ __forceinline__ C step_cell(C qxl, C tc, C tp, C ym, C yp, C zm, C zp, C cp,
                                       const Consts<C>& k, C& qxr) {
  const IEEEDiv dv;
  qxr = xflux(tc, tp, k);
  C acc = -dv(qxr - qxl, k.dx);
  if (HAS_Y) {
    const C qyr = face_flux(tc, yp, k.nlam, k.dy, dv);
    const C qyl = face_flux(ym, tc, k.nlam, k.dy, dv);
    acc = acc - dv(qyr - qyl, k.dy);
  }
  const C qzr = face_flux(tc, zp, k.nlam, k.dz, dv);
  const C qzl = face_flux(zm, tc, k.nlam, k.dz, dv);
  acc = acc - dv(qzr - qzl, k.dz);
  return tc + k.dt * (acc / cp);
}

// Received slabs of K4/K5 in K2's slab layout: the stacked shape with the
// exchange dim at D*1 (halowidth 1); null where that dim takes none.
template <typename S> struct Recv {
  const S *xl, *xr, *yl, *yr, *zl, *zr;
  unsigned D1, D2;  // blocks along y and z
};

// ---------------------------------------------------------------------------
// K1 and K4: the tiled 3-D step.
// ---------------------------------------------------------------------------

constexpr unsigned TZ = 32;  // lanes of a tile: one warp along z
// Rows of a tile: 8 for 4- and 2-byte states, 4 for float64 (tiles of 8
// rows at 80 registers ran K4 slower, PERF.md).
template <typename S> constexpr unsigned tile_rows = sizeof(S) == 8 ? 4 : 8;
constexpr unsigned TCHUNK = 32;  // x planes a tile walks
constexpr unsigned AHEAD = 2;    // planes staged ahead (cp.async groups in flight)
// Slots of staged planes, a power of two dividing TCHUNK, so that plane i
// of a chunk sits in slot i % SLOTS, a constant of the unrolled loop: T of
// planes i+1..i+AHEAD+2 (the faces of plane i+1 read T[i+1] and T[i+2]; T[i]
// is carried in registers), Cp of planes i..i+AHEAD+1.
constexpr unsigned SLOTS = AHEAD + 2;
static_assert((SLOTS & (SLOTS - 1)) == 0 && TCHUNK % SLOTS == 0, "slots of the unrolled loop");

// A tile's shared memory: T of plane p in slot p % SLOTS at [row + 1][lane
// + 1] (rows -1..R, lanes -1..TZ), Cp of plane p in slot p % SLOTS, and
// plane p's faces in buffer p % 2: the y face below each row, and the z
// face before lane 0 ([row][0]) and beyond each lane ([row][lane + 1]).
template <typename S, typename C, unsigned R>
struct StepTile {
  S t[SLOTS][R + 2][TZ + 2];
  S cp[SLOTS][R][TZ];
  C qy[2][R][TZ];
  C qz[2][R][TZ + 1];
};

// The stacked extents S1, S2, the block (n0, n1, n2), the blocks D1, D2
// along y and z, a block's tiles along y and z and its x chunks.
struct StepGeom {
  unsigned S1, S2, n0, n1, n2, D1, D2, nty, ntz, nchunk;
};

// The output indices along a dim of n that read source index a, as a mask:
// bit 0 a itself, bit 1 index 0 (a = n-2), bit 2 index n-1 (a = 1). Without
// the fused halo update only a itself; with it, the halo indices 0 and n-1
// read n-2 and 1, and nothing reads them.
__device__ __forceinline__ unsigned mirror_mask(unsigned a, unsigned n, bool fused) {
  if (!fused) return 1u;
  return (a != 0 && a != n - 1 ? 1u : 0u) | (a == n - 2 ? 2u : 0u) | (a == 1 ? 4u : 0u);
}

__device__ __forceinline__ unsigned mirror_index(unsigned bit, unsigned a, unsigned n) {
  return bit == 0 ? a : (bit == 1 ? 0u : n - 1);
}

// Value v of source cell (i, j, k) into every output cell of the block at
// Ob that reads it in another plane or row (K1's fused halos; the caller
// writes those in plane i and row j). Out of line: only the cells next to a
// fused halo plane or row call it, and inlined it slowed K1 (PERF.md).
template <typename S>
__device__ __noinline__ void mirror_writes(S* Ob, long long plane, long long S2, unsigned i,
                                           unsigned j, unsigned k, unsigned n0, unsigned n1,
                                           unsigned n2, unsigned mx, unsigned my, unsigned mz,
                                           S v) {
  for (unsigned a = 0; a < 3; ++a) {
    if (!(mx >> a & 1u)) continue;
    const long long ox = (long long)mirror_index(a, i, n0) * plane;
    for (unsigned b = 0; b < 3; ++b) {
      if (!(my >> b & 1u)) continue;
      const long long oy = ox + (long long)mirror_index(b, j, n1) * S2;
      for (unsigned c = 0; c < 3; ++c)
        if ((mz >> c & 1u) && (a | b)) Ob[oy + mirror_index(c, k, n2)] = v;
    }
  }
}

// Thread (lane, row) of a tile: column (j0 + row, k0 + lane) of block (c0,
// c1, c2), x planes [i_lo, i_hi). Blocks: x walks (block row c1, y tile,
// block lane c2, z tile), y (block plane c0, x chunk). hx, hy, hz: the dims
// whose halo cells take another value (K1: the fused dims; K4: the dims that
// receive slabs). Between barrier i and barrier i+1 a thread starts to stage
// plane i+AHEAD+2's T and i+AHEAD+1's Cp into the slots plane i's left,
// updates plane i, then computes plane i+1's faces: the x and y faces beyond
// its cell and the z face beyond it; row 0 also the y face below it, and
// row 1's lanes 0..R-1 the z face before lane 0 of each row. Values read
// past the block's last row or lane (clamped) feed only cells off the
// interior, or outside the block, which are not taken.
template <typename S, typename C, unsigned R, bool RECV>
__device__ __forceinline__ void step_tile(StepTile<S, C, R>& t, const S* __restrict__ T,
                                          const S* __restrict__ Cp, S* __restrict__ out,
                                          const StepGeom& g, const Consts<C>& kc, bool hx,
                                          bool hy, bool hz, const Recv<S>& r) {
  constexpr unsigned TILE = TZ * R, NT = (R + 2) * (TZ + 2);  // NT: T's staged tile
  const unsigned lane = threadIdx.x, row = threadIdx.y, tid = row * TZ + lane;
  const unsigned zt = blockIdx.x % (g.D2 * g.ntz), yt = blockIdx.x / (g.D2 * g.ntz);
  const unsigned c2 = zt / g.ntz, k0 = (zt - c2 * g.ntz) * TZ;
  const unsigned c1 = yt / g.nty, j0 = (yt - c1 * g.nty) * R;
  const unsigned c0 = blockIdx.y / g.nchunk, i_lo = (blockIdx.y - c0 * g.nchunk) * TCHUNK;
  const unsigned n0 = g.n0, n1 = g.n1, n2 = g.n2;
  const unsigned i_hi = min(n0, i_lo + TCHUNK);
  const unsigned j = j0 + row, k = k0 + lane;
  const bool own = j < n1 && k < n2;
  const long long S2 = g.S2, plane = (long long)g.S1 * S2;
  const long long origin = (long long)c0 * n0 * plane + (long long)c1 * n1 * S2 + c2 * n2;
  // what the thread stages (clamped into the block), advanced a plane at a
  // time: T's tile elements tid and e1 (if any) of the next T plane, and its
  // own column's Cp of the next Cp plane
  const auto at = [&](unsigned e) {
    return (long long)clamp_to((int)(j0 + e / (TZ + 2)) - 1, n1) * S2 +
           clamp_to((int)(k0 + e % (TZ + 2)) - 1, n2);
  };
  const unsigned e1 = tid + TILE;
  const long long sc = (long long)clamp_to((int)j, n1) * S2 + clamp_to((int)k, n2);
  const long long first = origin + (long long)i_lo * plane;
  const S* ta = T + first + at(tid);
  const S* tb = T + first + (e1 < NT ? at(e1) : 0);
  const S* cq = Cp + first + sc;
  S* po = out + first + (long long)j * S2 + k;  // the thread's output cell of plane i
  unsigned tp = i_lo;  // the T plane at ta, tb
  const auto stage_t = [&](unsigned slot) {  // the next T plane, clamped into the block
    S* dst = &t.t[slot][0][0];
    stage1(dst + tid, ta);
    if (e1 < NT) stage1(dst + e1, tb);
    if (++tp < n0) {
      ta += plane;
      tb += plane;
    }
  };
  const auto stage_c = [&](unsigned slot) {  // the next Cp plane
    stage1(&t.cp[slot][0][0] + tid, cq);
    cq += plane;
  };

  // T at the cell of plane i and i+1; plane i's faces beyond the cell, and
  // its x face before it (the y and z faces before it are in the buffers)
  const S tm = i_lo > 0 ? T[first - plane + sc] : S();
  stage_t(0);
  for (unsigned d = 0; d <= AHEAD; ++d) {
    if (i_lo + d < i_hi) {
      stage_t(d + 1);
      stage_c(d);
    }
    __pipeline_commit();
  }
  __pipeline_wait_prior(AHEAD);
  __syncthreads();  // plane i_lo's T and Cp, plane i_lo+1's T staged
  S tc = t.t[0][row + 1][lane + 1];
  S tn = t.t[1][row + 1][lane + 1];
  C qxl, qxr, qyr, qzr;
  {
    const C c = to_c(tc), m = i_lo > 0 ? to_c(tm) : c;
    retry_passes([&](auto&& dv) { qxl = face_flux(m, c, kc.nlam, kc.dx, dv); });
  }
  // plane p's faces (T[p] in slot s, its centre tc, and T[p+1]'s tn), into
  // the face buffers of p
  const auto faces = [&](unsigned p, unsigned s) {
    const C c = to_c(tc), n = to_c(tn);
    const C yp = to_c(t.t[s][row + 2][lane + 1]), zp = to_c(t.t[s][row + 1][lane + 2]);
    const bool below = row == 0, before = row == 1 && lane < R;
    const C ym = below ? to_c(t.t[s][0][lane + 1]) : C(0);
    const C z0 = before ? to_c(t.t[s][lane + 1][0]) : C(0);
    const C z1 = before ? to_c(t.t[s][lane + 1][1]) : C(0);
    C qyl = C(0), qz0 = C(0);
    retry_passes([&](auto&& dv) {
      qxr = face_flux(c, n, kc.nlam, kc.dx, dv);
      qyr = face_flux(c, yp, kc.nlam, kc.dy, dv);
      qzr = face_flux(c, zp, kc.nlam, kc.dz, dv);
      if (below) qyl = face_flux(ym, c, kc.nlam, kc.dy, dv);
      if (before) qz0 = face_flux(z0, z1, kc.nlam, kc.dz, dv);
    });
    const unsigned b = p & 1;
    if (below) t.qy[b][0][lane] = qyl;
    if (row + 1 < R) t.qy[b][row + 1][lane] = qyr;
    if (before) t.qz[b][lane][0] = qz0;
    t.qz[b][row][lane + 1] = qzr;
  };
  faces(i_lo, 0);

  const bool in_yz = j > 0 && j + 1 < n1 && k > 0 && k + 1 < n2;
  // K1: the column's output cells along y and z (mirror_mask): in row j
  // (the cell itself, z index 0, z index n2-1), and whether any lies in
  // another row or could in another plane; K4: whether the column takes a
  // received value
  const unsigned my = mirror_mask(j, n1, hy), mz = mirror_mask(k, n2, hz);
  const bool in_row = my & 1u, z_self = in_row && (mz & 1u), z_lo = in_row && (mz & 2u),
             z_hi = in_row && (mz & 4u);
  const bool col_out = my && mz, col_rows = col_out && (my & 6u);
  const bool col_recv = (hy && (j == 0 || j == n1 - 1)) || (hz && (k == 0 || k == n2 - 1));
  // plane i, in slot u = i % SLOTS
  const auto step = [&](unsigned i, unsigned u) {
    __pipeline_wait_prior(AHEAD - 1);
    __syncthreads();  // plane i's faces written; plane i+1's T staged; plane i-1 read
    if (i + AHEAD + 1 < i_hi) {
      stage_t((u + AHEAD + 2) % SLOTS);
      stage_c((u + AHEAD + 1) % SLOTS);
    }
    __pipeline_commit();
    const C qyl = t.qy[i & 1][row][lane], qzl = t.qz[i & 1][row][lane];
    const C cp = to_c(t.cp[u][row][lane]);
    C acc;
    retry_passes([&](auto&& dv) {
      acc = -dv(qxr - qxl, kc.dx);
      acc = acc - dv(qyr - qyl, kc.dy);
      acc = acc - dv(qzr - qzl, kc.dz);
    });
    const bool x_halo = hx && (i == 0 || i == n0 - 1);
    if (own) {
      const bool interior = in_yz && i > 0 && i + 1 < n0;
      const S v = interior ? from_c<S, C>(to_c(tc) + kc.dt * (acc / cp)) : tc;
      if (RECV) {
        if (!(col_recv || x_halo)) *po = v;
      } else if (!x_halo) {
        // in plane i and row j: the cell and its z mirrors
        if (z_self) *po = v;
        if (z_lo) po[-(long long)k] = v;
        if (z_hi) po[n2 - 1 - k] = v;
        if (col_rows || (col_out && hx && (i == 1 || i == n0 - 2)))  // other planes or rows
          mirror_writes(out + origin, plane, S2, i, j, k, n0, n1, n2, mirror_mask(i, n0, hx),
                        my, mz, v);
      }
    }
    po += plane;
    if (i + 1 < i_hi) {
      tc = tn;
      tn = t.t[(u + 2) % SLOTS][row + 1][lane + 1];
      qxl = qxr;
      faces(i + 1, (u + 1) % SLOTS);
    }
  };
  for (unsigned i = i_lo; i < i_hi; i += SLOTS) {
#pragma unroll
    for (unsigned u = 0; u < SLOTS; ++u)
      if (i + u < i_hi) step(i + u, u);
  }
  if (RECV && own) {
    // the received cells of the column, in the 3-D rule: y over x over z
    const bool yc = hy && (j == 0 || j == n1 - 1), zc = hz && (k == 0 || k == n2 - 1);
    const long long J = (long long)c1 * n1 + j, K = (long long)c2 * n2 + k;
    const long long oc = origin + (long long)j * S2 + k;
    const auto deliver = [&](unsigned i) {
      const long long I = (long long)c0 * n0 + i;
      S v;
      if (yc)
        v = (j == 0 ? r.yl : r.yr)[(I * r.D1 + c1) * S2 + K];
      else if (hx && (i == 0 || i == n0 - 1))
        v = (i == 0 ? r.xl : r.xr)[c0 * plane + J * S2 + K];
      else if (zc)
        v = (k == 0 ? r.zl : r.zr)[(I * g.S1 + J) * r.D2 + c2];
      else
        return;
      out[oc + (long long)i * plane] = v;
    };
    if (yc || zc) {
      for (unsigned i = i_lo; i < i_hi; ++i) deliver(i);
    } else if (hx) {
      if (i_lo == 0) deliver(0);
      if (i_hi == n0) deliver(n0 - 1);
    }
  }
}

// Thread blocks an SM must hold at once, which bounds registers to 64: 4
// tiles of 256 threads for 4- and 2-byte states, 8 of 128 for float64.
template <typename S> constexpr int step_min_blocks() { return sizeof(S) == 8 ? 8 : 4; }

template <typename S, typename C>
__global__ void __launch_bounds__(TZ * tile_rows<S>, step_min_blocks<S>())
diffusion3d_step_halo_kernel(const S* __restrict__ T, const S* __restrict__ Cp,
                             S* __restrict__ out, const __grid_constant__ StepGeom g,
                             const __grid_constant__ Consts<C> kc, int fuse_x, int fuse_y,
                             int fuse_z) {
  __shared__ StepTile<S, C, tile_rows<S>> t;
  step_tile<S, C, tile_rows<S>, false>(t, T, Cp, out, g, kc, fuse_x, fuse_y, fuse_z,
                                       Recv<S>{});
}

template <typename S, typename C>
__global__ void __launch_bounds__(TZ * tile_rows<S>, step_min_blocks<S>())
diffusion3d_step_exchange_kernel(const S* __restrict__ T, const S* __restrict__ Cp,
                                 S* __restrict__ out, const __grid_constant__ StepGeom g,
                                 const __grid_constant__ Consts<C> kc,
                                 const __grid_constant__ Recv<S> r) {
  __shared__ StepTile<S, C, tile_rows<S>> t;
  step_tile<S, C, tile_rows<S>, true>(t, T, Cp, out, g, kc, r.xl != nullptr,
                                      r.yl != nullptr, r.zl != nullptr, r);
}

// The geometry of a tiled sweep of a state of S, or false where its
// extents leave 32-bit indices or its grid the launch limits.
template <typename S>
bool step_geom(long long S0, long long S1, long long S2, long long n0, long long n1,
               long long n2, StepGeom& g, dim3& grid) {
  const long long lim = 1LL << 31, rows = tile_rows<S>;
  if (n0 < 1 || n1 < 1 || n2 < 1 || S0 >= lim || S1 >= lim || S2 >= lim) return false;
  const long long nty = (n1 + rows - 1) / rows, ntz = (n2 + TZ - 1) / TZ;
  const long long nchunk = (n0 + TCHUNK - 1) / TCHUNK;
  const long long tiles = (S1 / n1) * nty * (S2 / n2) * ntz;
  if (tiles >= lim || (S0 / n0) * nchunk > 65535) return false;
  g = StepGeom{(unsigned)S1, (unsigned)S2, (unsigned)n0, (unsigned)n1, (unsigned)n2,
               (unsigned)(S1 / n1), (unsigned)(S2 / n2), (unsigned)nty, (unsigned)ntz,
               (unsigned)nchunk};
  grid = dim3((unsigned)tiles, (unsigned)((S0 / n0) * nchunk));
  return true;
}

template <typename S, typename C>
int step_halo(const void* T, const void* Cp, void* out, long long S0, long long S1, long long S2,
              long long n0, long long n1, long long n2, Consts<C> kc, int fx, int fy, int fz,
              cudaStream_t st) {
  StepGeom g;
  dim3 grid;
  if (!step_geom<S>(S0, S1, S2, n0, n1, n2, g, grid)) return (int)cudaErrorInvalidValue;
  diffusion3d_step_halo_kernel<S, C><<<grid, dim3(TZ, tile_rows<S>), 0, st>>>(
      static_cast<const S*>(T), static_cast<const S*>(Cp), static_cast<S*>(out), g, kc, fx,
      fy, fz);
  return (int)cudaGetLastError();
}

template <typename S, typename C>
int step_exchange3d(const void* T, const void* Cp, void* out, long long S0, long long S1,
                    long long S2, long long n0, long long n1, long long n2, Consts<C> kc,
                    Recv<S> r, cudaStream_t st) {
  StepGeom g;
  dim3 grid;
  if (!step_geom<S>(S0, S1, S2, n0, n1, n2, g, grid)) return (int)cudaErrorInvalidValue;
  diffusion3d_step_exchange_kernel<S, C><<<grid, dim3(TZ, tile_rows<S>), 0, st>>>(
      static_cast<const S*>(T), static_cast<const S*>(Cp), static_cast<S*>(out), g, kc, r);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// K5: the 2-D step.
// ---------------------------------------------------------------------------

constexpr int XCHUNK = 16;  // output planes per thread

// One thread: output column K of a 2-D field laid out as (S0, 1, S2), planes
// [i_lo, i_hi) of its block along x, keeping the x-neighbours in registers
// (T is read about once; the z-neighbours are re-read by adjacent threads and
// hit in L1). Per-thread indices are 32-bit (the entry point checks the
// extents) and offsets 64-bit: 64-bit indices cost registers, and so
// occupancy.
template <typename S, typename C>
__device__ __forceinline__ void sweep2d(const S* __restrict__ T, const S* __restrict__ Cp,
                                        S* __restrict__ out, unsigned S2, unsigned n0,
                                        unsigned n2, const Consts<C>& kc, unsigned nchunk,
                                        const Recv<S>& r) {
  const unsigned K = blockIdx.x * blockDim.x + threadIdx.x;
  if (K >= S2) return;
  const unsigned c0 = blockIdx.z / nchunk;
  const unsigned i_lo = (blockIdx.z - c0 * nchunk) * XCHUNK;
  const unsigned i_hi = min(n0, i_lo + XCHUNK);
  const unsigned ck = K / n2, k = K - ck * n2;
  const bool z_interior = k > 0 && k < n2 - 1;
  const long long block0 = (long long)c0 * n0 * S2;
  // this column's received y lane (the z slot), if any, at plane I of the
  // stack: zlane[I * D2]
  const S* zlane = nullptr;
  if (r.zl != nullptr && (k == 0 || k == n2 - 1)) zlane = (k == 0 ? r.zl : r.zr) + ck;

  int cached = -2;  // plane whose x-neighbours sit in tm/tc/tp
  C tm = 0, tc = 0, tp = 0, qxr = 0;
  for (unsigned i = i_lo; i < i_hi; ++i) {
    const long long p = block0 + i * (long long)S2 + K;
    // the last exchanged dim wins: y (z slot) over x
    if (zlane != nullptr) {
      out[p] = zlane[((long long)c0 * n0 + i) * r.D2];
      continue;
    }
    if (r.xl != nullptr && (i == 0 || i == n0 - 1)) {
      out[p] = (i == 0 ? r.xl : r.xr)[(long long)c0 * S2 + K];
      continue;
    }
    if (!(z_interior && i > 0 && i < n0 - 1)) {
      out[p] = T[p];  // boundary cells keep their input
      continue;
    }
    C qxl;
    if ((int)i == cached + 1) {
      tm = tc;
      tc = tp;
      tp = to_c(T[p + S2]);
      qxl = qxr;
    } else {
      tm = to_c(T[p - S2]);
      tc = to_c(T[p]);
      tp = to_c(T[p + S2]);
      qxl = xflux(tm, tc, kc);
    }
    cached = (int)i;
    out[p] = from_c<S, C>(step_cell<C, false>(qxl, tc, tp, C(0), C(0), to_c(T[p - 1]),
                                              to_c(T[p + 1]), to_c(Cp[p]), kc, qxr));
  }
}

// Thread blocks an SM must hold at once, which bounds registers: 8 (32
// registers) for float32 states, 6 (40) for the others.
template <typename S> constexpr int min_blocks() { return sizeof(S) == 4 ? 8 : 6; }

template <typename S, typename C>
__global__ void __launch_bounds__(THREADS, min_blocks<S>())
diffusion2d_step_exchange_kernel(const S* __restrict__ T, const S* __restrict__ Cp,
                                 S* __restrict__ out, unsigned S2, unsigned n0, unsigned n2,
                                 Consts<C> kc, unsigned nchunk, Recv<S> r) {
  sweep2d<S, C>(T, Cp, out, S2, n0, n2, kc, nchunk, r);
}

// Extents of a 2-D sweep fit its 32-bit indices, and its grid the launch
// limits.
bool sweep2d_fits(long long S0, long long S2, long long n0) {
  const long long lim = 1LL << 31;
  const long long nchunk = (n0 + XCHUNK - 1) / XCHUNK;
  return S0 < lim && S2 < lim && (S0 / n0) * nchunk <= 65535;
}

// 256 threads along y, the contiguous axis; one z slice for each (block of
// the stack along x, chunk of XCHUNK planes).
template <typename S, typename C>
void step_exchange2d(const void* T, const void* Cp, void* out, long long S0, long long S2,
                     long long n0, long long n2, Consts<C> kc, Recv<S> r, cudaStream_t st) {
  const unsigned nchunk = (unsigned)((n0 + XCHUNK - 1) / XCHUNK);
  const dim3 grid((unsigned)((S2 + THREADS - 1) / THREADS), 1u,
                  (unsigned)((S0 / n0) * nchunk));
  diffusion2d_step_exchange_kernel<S, C><<<grid, THREADS, 0, st>>>(
      static_cast<const S*>(T), static_cast<const S*>(Cp), static_cast<S*>(out),
      (unsigned)S2, (unsigned)n0, (unsigned)n2, kc, nchunk, r);
}

// ---------------------------------------------------------------------------
// K4s: the received slabs of one exchanging dim.
// ---------------------------------------------------------------------------

// Index arithmetic of K4s is 32-bit (the entry point checks the extents):
// a first version that decomposed 64-bit indices per element, through
// arrays indexed by the dim (a stack frame), took ~20 us a launch for slabs
// of 2x256x256 cells. Offsets into the tensors stay 64-bit.
__device__ __forceinline__ unsigned pick(unsigned a0, unsigned a1, unsigned a2, int d) {
  return d == 0 ? a0 : (d == 1 ? a1 : a2);
}

// Slabs an earlier dim received (K2's layout); l == nullptr: no such dim.
// ext: the slabs' extent along dim (blocks x hw).
template <typename S> struct Earlier {
  const S *l, *r;
  int dim;
  unsigned hw, ext;
};

// One output slab: block t reads block t + shift (mod D when periodic) at
// local start `start`; on a PROC_NULL edge (no such block) its own block at
// local start `own`.
struct Move {
  int start, own, shift;
};

struct Geom {
  unsigned S0, S1, S2, n0, n1, n2;
};

// Value of stacked cell (g0, g1, g2) as the block holds it after the
// earlier dims' halos were written: a received value where the cell lies
// in an earlier dim's halo.
template <typename S>
__device__ __forceinline__ bool from_earlier(const Earlier<S>& e, unsigned g0, unsigned g1,
                                             unsigned g2, const Geom& G, S& v) {
  if (e.l == nullptr) return false;
  const unsigned ne = pick(G.n0, G.n1, G.n2, e.dim);
  const unsigned ge = pick(g0, g1, g2, e.dim);
  const unsigned c = ge / ne, loc = ge - c * ne;
  const S* src;
  unsigned h;
  if (loc < e.hw) {
    src = e.l;
    h = loc;
  } else if (loc >= ne - e.hw) {
    src = e.r;
    h = loc - (ne - e.hw);
  } else {
    return false;
  }
  h += c * e.hw;
  unsigned X1 = G.S1, X2 = G.S2;
  if (e.dim == 0) {
    g0 = h;
  } else if (e.dim == 1) {
    g1 = h;
    X1 = e.ext;
  } else {
    g2 = h;
    X2 = e.ext;
  }
  v = src[((long long)g0 * X1 + g1) * X2 + g2];
  return true;
}

// The stacked source cell of element q of a received slab of dim `dim`
// (width hw) under move m: (g0, g1, g2), in the layout of a field of
// geometry G, blocks D along dim.
__device__ __forceinline__ void slab_source(const Geom& G, unsigned q, int dim, unsigned hw,
                                            int periodic, const Move& m, unsigned P1,
                                            unsigned P2, unsigned nd, int D, unsigned& g0,
                                            unsigned& g1, unsigned& g2) {
  g2 = q % P2;
  const unsigned rest = q / P2;
  g1 = rest % P1;
  g0 = rest / P1;
  const unsigned gd = pick(g0, g1, g2, dim);
  const unsigned t = gd / hw, qq = gd - t * hw;
  int s = (int)t + m.shift;
  bool reached = true;
  if (periodic) {
    s %= D;
    if (s < 0) s += D;
  } else {
    reached = s >= 0 && s < D;
  }
  const unsigned src = reached ? (unsigned)s * nd + m.start + qq : t * nd + m.own + qq;
  if (dim == 0) {
    g0 = src;
  } else if (dim == 1) {
    g1 = src;
  } else {
    g2 = src;
  }
}

// MODE 0: a plain copy (update_halo); 1: the 3-D step; 2: the 2-D step laid
// out as (S0, 1, S1).
template <typename S, typename C, int MODE>
__global__ void __launch_bounds__(THREADS)
exchange_slabs_kernel(const S* __restrict__ T, const S* __restrict__ Cp, S* out0, S* out1,
                      Geom G, int dim, unsigned hw, int periodic, Move m0, Move m1,
                      Earlier<S> e0, Earlier<S> e1, Consts<C> kc) {
  S* out = blockIdx.y ? out1 : out0;
  const Move m = blockIdx.y ? m1 : m0;
  if (out == nullptr) return;
  const unsigned nd = pick(G.n0, G.n1, G.n2, dim);
  const int D = (int)(pick(G.S0, G.S1, G.S2, dim) / nd);
  const unsigned P1 = dim == 1 ? D * hw : G.S1, P2 = dim == 2 ? D * hw : G.S2;
  const unsigned total = (dim == 0 ? D * hw : G.S0) * P1 * P2;
  for (unsigned q = blockIdx.x * blockDim.x + threadIdx.x; q < total;
       q += gridDim.x * blockDim.x) {
    unsigned g0, g1, g2;
    slab_source(G, q, dim, hw, periodic, m, P1, P2, nd, D, g0, g1, g2);
    S v;
    if (!from_earlier(e1, g0, g1, g2, G, v) &&
        !from_earlier(e0, g0, g1, g2, G, v)) {  // the later dim wins
      const long long S1 = G.S1, S2 = G.S2;
      const long long p = ((long long)g0 * S1 + g1) * S2 + g2;
      v = T[p];
      if constexpr (MODE == 1 || MODE == 2) {
        const unsigned i = g0 % G.n0, j = g1 % G.n1, k = g2 % G.n2;
        const bool interior = i > 0 && i < G.n0 - 1 && k > 0 && k < G.n2 - 1 &&
                              (MODE == 2 || (j > 0 && j < G.n1 - 1));
        if (interior) {
          const long long plane = S1 * S2;
          const C tm = to_c(T[p - plane]), tc = to_c(T[p]), tp = to_c(T[p + plane]);
          const C ym = MODE == 1 ? to_c(T[p - S2]) : C(0);
          const C yp = MODE == 1 ? to_c(T[p + S2]) : C(0);
          C qxr;
          v = from_c<S, C>(step_cell<C, MODE == 1>(xflux(tm, tc, kc), tc, tp, ym, yp,
                                                   to_c(T[p - 1]), to_c(T[p + 1]),
                                                   to_c(Cp[p]), kc, qxr));
        }
      }
    }
    out[q] = v;
  }
}

template <typename S, typename C, int MODE>
void exchange_slabs(const void* T, const void* Cp, void* o0, void* o1, const Geom& G, int dim,
                    unsigned hw, int periodic, Move m0, Move m1, Earlier<S> e0,
                    Earlier<S> e1, Consts<C> kc, unsigned total, cudaStream_t st) {
  long long blocks = ((long long)total + THREADS - 1) / THREADS;
  if (blocks > (1LL << 20)) blocks = 1LL << 20;  // grid-stride beyond
  if (blocks < 1) blocks = 1;
  exchange_slabs_kernel<S, C, MODE><<<dim3((unsigned)blocks, 2u), THREADS, 0, st>>>(
      static_cast<const S*>(T), static_cast<const S*>(Cp), static_cast<S*>(o0),
      static_cast<S*>(o1), G, dim, hw, periodic, m0, m1, e0, e1, kc);
}

// The staggered modes of K4s: the received slabs of one dim for each field
// of the fused acoustic step (wave.cuh) or PT iteration (stokes.cuh), one
// launch for all four. A field's slabs (`FieldSlabs`: its geometry, moves,
// earlier dims' slabs and outputs, null outputs where it does not exchange
// along the dim) are read by the blocks of its grid rows.
template <typename S>
struct FieldSlabs {
  Geom G;
  Move m[2];
  Earlier<S> e[2];
  S* out[2];
  unsigned total;
};

template <typename S>
struct SlabBatch {
  FieldSlabs<S> f[4];
};

// Field f of a staggered state updated at stacked cell (g0, g1, g2) of its
// geometry G: the acoustic step's value (a Wave) or the PT iteration's in
// the getter form (a Stokes).
template <typename S>
__device__ __forceinline__ S staggered_update(const Wave<S>& w, int f, const Geom& G,
                                              unsigned g0, unsigned g1, unsigned g2) {
  const unsigned c0 = g0 / G.n0, c1 = g1 / G.n1, c2 = g2 / G.n2;
  return wave_update(w, wave_block(w, c0, c1, c2), f, g0 - c0 * G.n0, g1 - c1 * G.n1,
                     g2 - c2 * G.n2);
}
template <typename S>
__device__ __forceinline__ S staggered_update(const Stokes<S>& s, int f, const Geom& G,
                                              unsigned g0, unsigned g1, unsigned g2) {
  const unsigned c0 = g0 / G.n0, c1 = g1 / G.n1, c2 = g2 / G.n2;
  return stokes_update<S, FORM_GETTER>(s, stokes_block(s, c0, c1, c2), f, g0 - c0 * G.n0,
                                       g1 - c1 * G.n1, g2 - c2 * G.n2);
}

// Grid rows 2f + side: field f's received slab `side`.
template <typename S, typename W>
__global__ void __launch_bounds__(THREADS)
exchange_slabs_staggered_kernel(const __grid_constant__ SlabBatch<S> batch, int dim, unsigned hw,
                                int periodic, W wv) {
  const int f = (int)(blockIdx.y >> 1), side = (int)(blockIdx.y & 1);
  const FieldSlabs<S>& fs = batch.f[f];
  S* out = fs.out[side];
  if (out == nullptr) return;
  const Geom G = fs.G;
  const Move m = fs.m[side];
  const unsigned nd = pick(G.n0, G.n1, G.n2, dim);
  const int D = (int)(pick(G.S0, G.S1, G.S2, dim) / nd);
  const unsigned P1 = dim == 1 ? D * hw : G.S1, P2 = dim == 2 ? D * hw : G.S2;
  for (unsigned q = blockIdx.x * blockDim.x + threadIdx.x; q < fs.total;
       q += gridDim.x * blockDim.x) {
    unsigned g0, g1, g2;
    slab_source(G, q, dim, hw, periodic, m, P1, P2, nd, D, g0, g1, g2);
    S v;
    if (!from_earlier(fs.e[1], g0, g1, g2, G, v) &&
        !from_earlier(fs.e[0], g0, g1, g2, G, v))  // the later dim wins
      v = staggered_update(wv, f, G, g0, g1, g2);
    out[q] = v;
  }
}

// Checks of one K4s call (32-bit extents and slab cells, earlier dims) and
// its geometry; returns the slab's cell count, or -1 for invalid arguments.
long long slabs_geom(long long S0, long long S1, long long S2, long long n0, long long n1,
                     long long n2, int dim, long long hw, int e0d, long long e0h,
                     const void* e0l, int e1d, long long e1h, const void* e1l, Geom& G,
                     unsigned& x0, unsigned& x1) {
  const long long lim = 1LL << 31;
  if (dim < 0 || dim > 2 || hw < 1 || n0 < 1 || n1 < 1 || n2 < 1 || S0 >= lim ||
      S1 >= lim || S2 >= lim)
    return -1;
  if (e0d > 2 || e1d > 2 || (e0d < 0 && e0l) || (e1d < 0 && e1l)) return -1;
  const long long Sv[3] = {S0, S1, S2}, nv[3] = {n0, n1, n2};
  long long P[3] = {S0, S1, S2};
  P[dim] = (Sv[dim] / nv[dim]) * hw;
  if (P[0] * P[1] * P[2] >= lim) return -1;
  G = Geom{(unsigned)S0, (unsigned)S1, (unsigned)S2, (unsigned)n0, (unsigned)n1, (unsigned)n2};
  x0 = e0d >= 0 ? (unsigned)((Sv[e0d] / nv[e0d]) * e0h) : 0u;
  x1 = e1d >= 0 ? (unsigned)((Sv[e1d] / nv[e1d]) * e1h) : 0u;
  return P[0] * P[1] * P[2];
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
      return step_halo<float, float>(T, Cp, out, S0, S1, S2, n0, n1, n2,
                                     make_consts<float>(lam, dt, dx, dy, dz), fuse_x, fuse_y,
                                     fuse_z, st);
    case 1:
      return step_halo<double, double>(T, Cp, out, S0, S1, S2, n0, n1, n2,
                                       make_consts<double>(lam, dt, dx, dy, dz), fuse_x,
                                       fuse_y, fuse_z, st);
    case 2:
      return step_halo<__nv_bfloat16, float>(T, Cp, out, S0, S1, S2, n0, n1, n2,
                                             make_consts<float>(lam, dt, dx, dy, dz), fuse_x,
                                             fuse_y, fuse_z, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// K4. x*, y*, z*: received slabs (halowidth 1) in K2's layout, null for a dim
// that takes none.
extern "C" int igg_diffusion3d_step_exchange(int dtype, const void* T, const void* Cp,
                                             void* out, long long S0, long long S1,
                                             long long S2, long long n0, long long n1,
                                             long long n2, double lam, double dt,
                                             double dx, double dy, double dz,
                                             const void* xl, const void* xr,
                                             const void* yl, const void* yr,
                                             const void* zl, const void* zr,
                                             void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n1 < 1 || n2 < 1) return (int)cudaErrorInvalidValue;
  const unsigned D1 = (unsigned)(S1 / n1), D2 = (unsigned)(S2 / n2);
#define IGG_RECV(S) \
  Recv<S>{static_cast<const S*>(xl), static_cast<const S*>(xr), static_cast<const S*>(yl), \
          static_cast<const S*>(yr), static_cast<const S*>(zl), static_cast<const S*>(zr), D1, D2}
  switch (dtype) {
    case 0:
      return step_exchange3d<float, float>(T, Cp, out, S0, S1, S2, n0, n1, n2,
                                           make_consts<float>(lam, dt, dx, dy, dz),
                                           IGG_RECV(float), st);
    case 1:
      return step_exchange3d<double, double>(T, Cp, out, S0, S1, S2, n0, n1, n2,
                                             make_consts<double>(lam, dt, dx, dy, dz),
                                             IGG_RECV(double), st);
    case 2:
      return step_exchange3d<__nv_bfloat16, float>(T, Cp, out, S0, S1, S2, n0, n1, n2,
                                                   make_consts<float>(lam, dt, dx, dy, dz),
                                                   IGG_RECV(__nv_bfloat16), st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// K5. The 2-D field (S0, S1) with blocks (n0, n1); xl/xr are the received x
// rows, yl/yr the received y lanes (halowidth 1, K2's layout), null where
// that dim takes none.
extern "C" int igg_diffusion2d_step_exchange(int dtype, const void* T, const void* Cp,
                                             void* out, long long S0, long long S1,
                                             long long n0, long long n1, double lam,
                                             double dt, double dx, double dy,
                                             const void* xl, const void* xr,
                                             const void* yl, const void* yr,
                                             void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!sweep2d_fits(S0, S1, n0)) return (int)cudaErrorInvalidValue;
  const void *zl = yl, *zr = yr;  // the 2-D y lanes sit in the z slot
  const unsigned D1 = 1, D2 = (unsigned)(S1 / n1);
  yl = yr = nullptr;
  switch (dtype) {
    case 0:
      step_exchange2d<float, float>(T, Cp, out, S0, S1, n0, n1,
                                    make_consts<float>(lam, dt, dx, dy, dy),
                                    IGG_RECV(float), st);
      break;
    case 1:
      step_exchange2d<double, double>(T, Cp, out, S0, S1, n0, n1,
                                      make_consts<double>(lam, dt, dx, dy, dy),
                                      IGG_RECV(double), st);
      break;
    case 2:
      step_exchange2d<__nv_bfloat16, float>(T, Cp, out, S0, S1, n0, n1,
                                            make_consts<float>(lam, dt, dx, dy, dy),
                                            IGG_RECV(__nv_bfloat16), st);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef IGG_RECV
  return (int)cudaGetLastError();
}

// K4s. mode 0 copies (any element of `itemsize` bytes); modes 1 (3-D step)
// and 2 (2-D step, laid out as (S0, 1, S1)) take `dtype` as above. out0/out1:
// the left/right received slabs of dim `dim` (width hw) in K2's layout; either
// may be null. e0/e1: earlier dims' received slabs (dim -1: none), e1 wins.
// Extents below 2^31 and slabs of fewer than 2^31 cells (32-bit indices).
extern "C" int igg_exchange_slabs(int mode, int dtype, int itemsize, const void* T,
                                  const void* Cp, void* out0, void* out1, long long S0,
                                  long long S1, long long S2, long long n0, long long n1,
                                  long long n2, int dim, long long hw, int periodic,
                                  long long start0, long long own0, long long shift0,
                                  long long start1, long long own1, long long shift1,
                                  int e0d, long long e0h, const void* e0l, const void* e0r,
                                  int e1d, long long e1h, const void* e1l, const void* e1r,
                                  double lam, double dt, double dx, double dy, double dz,
                                  void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  Geom G;
  unsigned x0, x1;
  const long long cells = slabs_geom(S0, S1, S2, n0, n1, n2, dim, hw, e0d, e0h, e0l, e1d,
                                     e1h, e1l, G, x0, x1);
  if (cells < 0) return (int)cudaErrorInvalidValue;
  const unsigned total = (unsigned)cells;
  const Move m0{(int)start0, (int)own0, (int)shift0}, m1{(int)start1, (int)own1, (int)shift1};
#define IGG_SLABS(S, C, MODE, K)                                                          \
  exchange_slabs<S, C, MODE>(                                                             \
      T, Cp, out0, out1, G, dim, (unsigned)hw, periodic, m0, m1,                          \
      Earlier<S>{static_cast<const S*>(e0l), static_cast<const S*>(e0r), e0d,             \
                 (unsigned)e0h, x0},                                                      \
      Earlier<S>{static_cast<const S*>(e1l), static_cast<const S*>(e1r), e1d,             \
                 (unsigned)e1h, x1},                                                      \
      K, total, st)
  if (mode == 0) {
    const Consts<float> k0{};
    switch (itemsize) {
      case 1: IGG_SLABS(uint8_t, float, 0, k0); break;
      case 2: IGG_SLABS(uint16_t, float, 0, k0); break;
      case 4: IGG_SLABS(uint32_t, float, 0, k0); break;
      case 8: IGG_SLABS(unsigned long long, float, 0, k0); break;
      default: return (int)cudaErrorInvalidValue;
    }
    return (int)cudaGetLastError();
  }
  if (mode != 1 && mode != 2) return (int)cudaErrorInvalidValue;
  // the 2-D step's y derivative runs in the z slot with dz = dy
  const double dz_ = mode == 1 ? dz : dy;
  const Consts<float> kf = make_consts<float>(lam, dt, dx, dy, dz_);
  const Consts<double> kd = make_consts<double>(lam, dt, dx, dy, dz_);
  switch (dtype * 2 + (mode - 1)) {
    case 0: IGG_SLABS(float, float, 1, kf); break;
    case 1: IGG_SLABS(float, float, 2, kf); break;
    case 2: IGG_SLABS(double, double, 1, kd); break;
    case 3: IGG_SLABS(double, double, 2, kd); break;
    case 4: IGG_SLABS(__nv_bfloat16, float, 1, kf); break;
    case 5: IGG_SLABS(__nv_bfloat16, float, 2, kf); break;
    default: return (int)cudaErrorInvalidValue;
  }
#undef IGG_SLABS
  return (int)cudaGetLastError();
}

namespace {

// The batch of a staggered K4s launch: ptrs (after the state's `nstate`
// fields) hold per field P, Vx, Vy, Vz: out0, out1, e0l, e0r, e1l, e1r; g:
// nx, ny, nz (P's block), D0, D1, D2 (blocks), dim, hw, periodic, then per
// field: start0, own0, shift0, start1, own1, shift1, e0d, e0h, e1d, e1h. A
// field whose outputs are both null takes no part. Returns the largest
// slab's cell count, or -1 for invalid arguments.
template <typename S>
long long slab_batch(const void* const* ptrs, int nstate, const long long* g,
                     SlabBatch<S>& bt) {
  const long long lim = 1LL << 31;  // every field's stacked extents fit 32 bits
  if (g[0] < 1 || g[1] < 1 || g[2] < 1 || g[3] < 1 || g[4] < 1 || g[5] < 1 ||
      g[3] * (g[0] + 1) >= lim || g[4] * (g[1] + 1) >= lim || g[5] * (g[2] + 1) >= lim)
    return -1;
  const int dim = (int)g[6];
  long long most = 0;
  for (int f = 0; f < 4; ++f) {
    const void* const* p = ptrs + nstate + 6 * f;
    const long long* h = g + 9 + 10 * f;
    FieldSlabs<S>& fs = bt.f[f];
    fs = FieldSlabs<S>{};
    fs.out[0] = static_cast<S*>(const_cast<void*>(p[0]));
    fs.out[1] = static_cast<S*>(const_cast<void*>(p[1]));
    if (fs.out[0] == nullptr && fs.out[1] == nullptr) continue;
    const long long n0 = g[0] + (f == 1), n1 = g[1] + (f == 2), n2 = g[2] + (f == 3);
    unsigned x0, x1;
    const long long cells = slabs_geom(g[3] * n0, g[4] * n1, g[5] * n2, n0, n1, n2, dim, g[7],
                                       (int)h[6], h[7], p[2], (int)h[8], h[9], p[4], fs.G,
                                       x0, x1);
    if (cells < 0) return -1;
    fs.m[0] = Move{(int)h[0], (int)h[1], (int)h[2]};
    fs.m[1] = Move{(int)h[3], (int)h[4], (int)h[5]};
    fs.e[0] = Earlier<S>{static_cast<const S*>(p[2]), static_cast<const S*>(p[3]), (int)h[6],
                         (unsigned)h[7], x0};
    fs.e[1] = Earlier<S>{static_cast<const S*>(p[4]), static_cast<const S*>(p[5]), (int)h[8],
                         (unsigned)h[9], x1};
    fs.total = (unsigned)cells;
    most = cells > most ? cells : most;
  }
  return most;
}

template <typename S, typename W>
int launch_staggered_slabs(const void* const* ptrs, int nstate, const long long* g, W wv,
                           cudaStream_t st) {
  SlabBatch<S> bt;
  const long long most = slab_batch(ptrs, nstate, g, bt);
  if (most < 0) return (int)cudaErrorInvalidValue;
  long long blocks = (most + THREADS - 1) / THREADS;
  if (blocks > (1LL << 20)) blocks = 1LL << 20;  // grid-stride beyond
  if (blocks < 1) blocks = 1;
  exchange_slabs_staggered_kernel<S, W><<<dim3((unsigned)blocks, 8u), THREADS, 0, st>>>(
      bt, (int)g[6], (unsigned)g[7], (int)g[8], wv);
  return (int)cudaGetLastError();
}

}  // namespace

// K4s wave modes: the received slabs of one dim for every field of the
// fused acoustic step that exchanges along it, in one launch. dtype 0
// float32, 1 float64, 2 bfloat16. ptrs: P, Vx, Vy, Vz, then the batch
// (`slab_batch`). c: cx, cy, cz, dtK, dx, dy, dz (wave.cuh).
extern "C" int igg_exchange_slabs_wave(int dtype, const void* const* ptrs, const long long* g,
                                       const double* c, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define IGG_WAVE_SLABS(S) \
  launch_staggered_slabs<S>(ptrs, 4, g, make_wave<S>(ptrs[0], ptrs[1], ptrs[2], ptrs[3], g, c), st)
  switch (dtype) {
    case 0: return IGG_WAVE_SLABS(float);
    case 1: return IGG_WAVE_SLABS(double);
    case 2: return IGG_WAVE_SLABS(__nv_bfloat16);
    default: return (int)cudaErrorInvalidValue;
  }
#undef IGG_WAVE_SLABS
}

// K4s Stokes modes: the received slabs of one dim for every field of the
// fused PT iteration that exchanges along it, in one launch, the send slabs
// in the getter form. dtype 0 float32, 1 float64. ptrs: P, Vx, Vy, Vz, dVx,
// dVy, dVz, rhog, then the batch (`slab_batch`). c: mu, dt_v, dt_p, damp,
// dx, dy, dz (stokes.cuh).
extern "C" int igg_exchange_slabs_stokes(int dtype, const void* const* ptrs,
                                         const long long* g, const double* c, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch_staggered_slabs<float>(ptrs, 8, g, make_stokes<float>(ptrs, g, c), st);
    case 1:
      return launch_staggered_slabs<double>(ptrs, 8, g, make_stokes<double>(ptrs, g, c), st);
    default: return (int)cudaErrorInvalidValue;
  }
}
