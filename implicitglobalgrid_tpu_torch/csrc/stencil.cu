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
//
// A launch computes every received slab of one dim d: for each job (one
// field's slab on one side) and each target block t, the send slab of block
// t + shift at local position start (on a PROC_NULL edge block t's own at
// own), patched with what that block received along earlier dims (the
// corners), and writes it in K2's slab layout. Every cell applies the
// per-cell functions of wave.cuh, stokes.cuh and `step_cell` to its
// operands through a view (`Tile`, `Staged`), so a slab is bitwise what
// K1, K4, K9 or K10 compute at that cell. No cell divides by a runtime
// extent: a tile's blocks, side and origin come from blockIdx once, a
// cell's position from threadIdx and loop counters; the earlier dims'
// corners are two compares on a local index. A job's field is a template
// argument of the code that computes it (a switch once a job), so every
// operand slot is a constant (a runtime index put the operands in local
// memory).
//
// `slab_tile`: a thread block is a tile of 256 cells of one slab position,
// 8 x 32 over the other two dims u and v (u = y, v = z for d = 0; u = x,
// v = z for d = 1; u = x, v = y for d = 2; 1 x 256 where a block is one
// cell wide), inside one block of the stack; a cell reads its operands from
// device memory through L1. Along x and y the lanes run along z, so a
// cell's operands and their neighbours come from consecutive addresses.
// The staggered modes walk every field and side in one tile (the fields'
// reads of one row meet in L1); a single field's two slabs take a grid row
// each.
//
// The wave modes' z slabs (`z_tile`): a z slab is hw cells of each (x, y)
// row, a few cells of one or two 32-byte sectors a row, and a pressure
// cell reads 13 operand cells around it. A thread block takes a group of
// at most 4 jobs (one shift, starts within a cell of each other: the
// fields of one side), 64 rows along y (32 where the block has fewer) and
// a chunk of planes along x, a thread a row and job (each warp one job's).
// It walks x, staging by cp.async (a plain copy for bfloat16) each plane of
// every operand the group reads: for each row of the tile and the one on
// either side, the window of z cells [start-1, start+hw] (the staggered
// field's extra face included), 1 << wl lanes a row, so each sector is
// fetched once a launch. Planes sit in a ring of 8 (4 in float64), staged
// SLOTS-3 planes ahead of the one computed, one barrier a plane; a cell
// reads its x±1 neighbours in the ring, its y±1 in the next rows and its
// z±1 in the window, all in shared memory. Slabs wider than the ring holds
// are split into tiles of slab positions. The other modes' z slabs take
// `slab_tile` (`z_walks`).
//
// Bound: bytes, each operand plane read once and each slab written once
// (`slab_batch_bound` in chip_smoke.py); along z, where a plane is a cell a
// row, the 32-byte sectors those cells span.
//
// Divisions: the step modes divide the IEEE way as `step_cell` does; the
// wave and Stokes modes through cdiv.cuh (`retry_passes`), the IEEE
// quotient bit for bit, so a slab is bitwise the value K9 or K10 computes.

// Slabs an earlier dim received (K2's layout); l == nullptr: no such dim.
template <typename S> struct Earlier {
  const S *l, *r;
  int dim;
  unsigned hw;
};

// One output slab: block t reads block t + shift (mod D when periodic) at
// local start `start`; on a PROC_NULL edge (no such block) its own block at
// local start `own`.
struct Move {
  int start, own, shift;
};

// One received slab of a launch: its output, move and earlier dims' slabs,
// the field's block extents m, and the field (staggered modes).
template <typename S> struct SlabJob {
  S* out;
  Move mv;
  Earlier<S> e[2];
  unsigned m[3];
  int f;
};

constexpr int K4S_JOBS = 8;  // two slabs of each of four fields

// The plan of a wave-mode z launch (see the design above): the groups of
// at most 4 jobs (ng; jobs[g], a mask), the rows along y a tile (ty = 1 <<
// tyl) and its threads (nt: ty for each job of the largest group), the
// window's cells w (in 1 << wl lanes a row when staged), the slab positions
// a tile (qc), the planes along x a chunk (xc), and the tiles a block along
// y (nrt), x (nxc) and the slab positions (nqc).
struct ZPlan {
  unsigned ng, jobs[K4S_JOBS], ty, tyl, nt, w, wl, qc, xc, nrt, nxc, nqc;
};

// The jobs of a launch, the blocks a dim D, the slab width, the x and y
// tiles' extent along v (1 << tv_log lanes; K4S_THREADS >> tv_log along u)
// and tiles a block along u and v (the most any job has), and the z plan.
template <typename S> struct SlabJobs {
  SlabJob<S> j[K4S_JOBS];
  unsigned n, D[3], hw, tv_log, ntu, ntv;
  int periodic;
  ZPlan z;
};

constexpr unsigned K4S_THREADS = 256;  // threads (cells) of an x or y tile

// A cell: its local indices in the source block.
struct Cell {
  int l0, l1, l2;
};

// The cell moved by k along dim a.
__device__ __forceinline__ Cell shifted(const Cell& c, int a, int k) {
  return Cell{c.l0 + (a == 0 ? k : 0), c.l1 + (a == 1 ? k : 0), c.l2 + (a == 2 ? k : 0)};
}

// What a mode's cell reads through a view V (`raw`: operand slot s at the
// cell moved by (d0, d1, d2), as stored), in its compute type C. Slots and
// dims are constants of the code that reads them (a runtime index would put
// the operands in local memory).
template <typename V, typename C> struct Reads {
  __device__ __forceinline__ C at(int s, const Cell& c, int d0 = 0, int d1 = 0,
                                  int d2 = 0) const {
    return to_c(static_cast<const V*>(this)->raw(s, c, d0, d1, d2));
  }
  // slot s at the cell moved by k along dim a
  __device__ __forceinline__ C along(int s, const Cell& c, int a, int k) const {
    return at(s, c, a == 0 ? k : 0, a == 1 ? k : 0, a == 2 ? k : 0);
  }
};

// A field a tile's cells read: the local (0, 0, 0) of the source block in
// it, and its plane and row strides.
template <typename S> struct Operand {
  const S* p;
  long long plane, row;
};

// The x and y tiles' view: each slot's field in device memory, read
// through L1.
template <typename S, typename C, int NIN> struct Tile : Reads<Tile<S, C, NIN>, C> {
  Operand<S> in[NIN];
  __device__ __forceinline__ S raw(int s, const Cell& c, int d0 = 0, int d1 = 0,
                                   int d2 = 0) const {
    const Operand<S>& o = in[s];
    return o.p[(c.l0 + d0) * o.plane + (c.l1 + d1) * o.row + (c.l2 + d2)];
  }
};

// The wave modes' z tiles' view: each slot's staged planes in shared
// memory (see the design above). b[s]: the slot's operand in ring slot 0,
// at staged row 0 and window cell 0; plane x sits in ring slot (x & slm),
// `ring` elements apart; a window cell `rp` elements apart; rows y
// consecutive from local row r0, window cells from local z0.
template <typename S, typename C, int NIN> struct Staged : Reads<Staged<S, C, NIN>, C> {
  const S* b[NIN];
  unsigned ring, slm, rp;
  int r0, z0;
  __device__ __forceinline__ S raw(int s, const Cell& c, int d0 = 0, int d1 = 0,
                                   int d2 = 0) const {
    return b[s][((unsigned)(c.l0 + d0) & slm) * ring + (unsigned)(c.l2 + d2 - z0) * rp +
                (unsigned)(c.l1 + d1 - r0)];
  }
};

// Dim a's unit offset along dim d (1 along a, else 0).
__host__ __device__ __forceinline__ constexpr unsigned unit(int a, int d) {
  return a == d ? 1u : 0u;
}

// The slab modes, each for field F (0 P, 1 Vx, 2 Vy, 3 Vz of the staggered
// modes; 0 the one field of the others): the operands of the state
// (`operand`: one's pointer and block extents), the operand in each of
// field F's NIN slots (`op`), and a cell (`cell`) from a view of the slots,
// which reads only operands in its block, as the per-cell functions do.

// Mode 0: a plain copy (update_halo), of any element of S's size.
template <typename S> struct CopySlab {
  using C = S;
  static constexpr int NIN = 1, NFIELDS = 1;
  const S* A;
  unsigned n0, n1, n2;
  __device__ const S* operand(int, unsigned (&m)[3]) const {
    m[0] = n0, m[1] = n1, m[2] = n2;
    return A;
  }
  template <int F> __device__ static constexpr int op(int) { return 0; }
  template <int F, typename V> __device__ S cell(const V& tm, const Cell& c) const {
    return tm.raw(0, c);
  }
};

// Modes 1 and 2: the diffusion step, 3-D, or 2-D laid out as (S0, 1, S1).
// Operands T and Cp.
template <typename S, typename C_, bool THREE_D> struct StepSlab {
  using C = C_;
  static constexpr int NIN = 2, NFIELDS = 1;
  const S *Tp, *Cp;
  unsigned n0, n1, n2;
  Consts<C> kc;
  __device__ const S* operand(int o, unsigned (&m)[3]) const {
    m[0] = n0, m[1] = n1, m[2] = n2;
    return o == 0 ? Tp : Cp;
  }
  template <int F> __device__ static constexpr int op(int s) { return s; }
  template <int F, typename V> __device__ S cell(const V& tm, const Cell& c) const {
    const bool interior = c.l0 > 0 && (unsigned)c.l0 + 1 < n0 && c.l2 > 0 &&
                          (unsigned)c.l2 + 1 < n2 &&
                          (!THREE_D || (c.l1 > 0 && (unsigned)c.l1 + 1 < n1));
    if (!interior) return tm.raw(0, c);
    const C tc = tm.at(0, c);
    const C ym = THREE_D ? tm.at(0, c, 0, -1) : C(0), yp = THREE_D ? tm.at(0, c, 0, 1) : C(0);
    C qxr;
    return from_c<S, C>(step_cell<C, THREE_D>(xflux(tm.at(0, c, -1), tc, kc), tc,
                                              tm.at(0, c, 1), ym, yp, tm.at(0, c, 0, 0, -1),
                                              tm.at(0, c, 0, 0, 1), tm.at(1, c), kc, qxr));
  }
};

// The wave modes (3 to 6: P, Vx, Vy, Vz): the fields after the acoustic
// step. Operands (and slots) P, Vx, Vy, Vz (NOPS; `op_mask`: those field f
// reads, for the z walk). A face cell is its face updated from the
// pressures on either side; a pressure cell reads the six faces around it,
// updated (`wave.cuh`'s `wave_pnew` on these operands).
template <typename S> struct WaveSlab {
  using C = compute_t<S>;
  static constexpr int NIN = 4, NOPS = 4, NFIELDS = 4;
  Wave<S> w;
  __device__ const S* operand(int o, unsigned (&m)[3]) const {
    const int a = o - 1;  // the staggered dim of operand o
    m[0] = w.nx + unit(a, 0), m[1] = w.ny + unit(a, 1), m[2] = w.nz + unit(a, 2);
    return o == 0 ? w.P : (o == 1 ? w.Vx : (o == 2 ? w.Vy : w.Vz));
  }
  __device__ static unsigned op_mask(int f) { return f == 0 ? 15u : 1u | (1u << f); }
  template <int F> __device__ static constexpr int op(int s) { return s; }
  // The face of dim A at c, updated (faces 0 and n keep their values).
  template <int A, typename V> __device__ C face(const V& tm, const Cell& c) const {
    const C v = tm.at(A + 1, c);
    const unsigned l = (unsigned)(A == 0 ? c.l0 : (A == 1 ? c.l1 : c.l2));
    const unsigned n = A == 0 ? w.nx : (A == 1 ? w.ny : w.nz);
    if (l < 1 || l > n - 1) return v;
    return wave_face<S>(v, A == 0 ? w.cx : (A == 1 ? w.cy : w.cz), tm.at(0, c),
                        tm.along(0, c, A, -1));
  }
  template <int F, typename V> __device__ S cell(const V& tm, const Cell& c) const {
    if constexpr (F > 0) {
      return from_c<S, C>(face<F - 1>(tm, c));
    } else {
      C p;
      retry_passes([&](auto&& dv) {
        p = wave_pressure(w, tm.at(0, c), face<0>(tm, c), face<0>(tm, shifted(c, 0, 1)),
                          face<1>(tm, c), face<1>(tm, shifted(c, 1, 1)), face<2>(tm, c),
                          face<2>(tm, shifted(c, 2, 1)), dv);
      });
      return from_c<S, C>(p);
    }
  }
};

// The Stokes modes (7 to 10: P, Vx, Vy, Vz): the fields after the PT
// iteration in the getter form (`stokes.cuh`'s `stokes_update`, FORM_GETTER,
// on these operands). Operands P, Vx, Vy, Vz, dVx, dVy, dVz, rhog; slots P,
// Vx, Vy, Vz, the field's damped momentum (P for P) and rhog. A pressure
// cell is its cell term; an interior face of dim a reads the cell terms on
// either side of it and the edge stresses of its other dims b1 < b2 on
// either side of it.
template <typename R> struct StokesSlab {
  using C = R;
  static constexpr int NIN = 6, NFIELDS = 4;
  Stokes<R> s;
  // the other dims b1 < b2 of a face of dim a
  __host__ __device__ static constexpr int other(int a, int t) {
    return t == 1 ? (a == 0 ? 1 : 0) : (a == 2 ? 1 : 2);
  }
  __device__ const R* operand(int o, unsigned (&m)[3]) const {
    const int a = o >= 4 ? o - 4 : o - 1;  // the staggered dim of operand o
    const bool cells = o == 0 || o == 7;
    m[0] = s.nx + (cells ? 0 : unit(a, 0)), m[1] = s.ny + (cells ? 0 : unit(a, 1));
    m[2] = s.nz + (cells ? 0 : unit(a, 2));
    switch (o) {
      case 0: return s.P;
      case 1: return s.Vx;
      case 2: return s.Vy;
      case 3: return s.Vz;
      case 4: return s.dVx;
      case 5: return s.dVy;
      case 6: return s.dVz;
      default: return s.rhog;
    }
  }
  template <int F> __device__ static constexpr int op(int k) {
    return k < 4 ? k : (k == 5 ? 7 : (F == 0 ? 0 : 3 + F));
  }
  template <typename V, typename Div>
  __device__ StokesCell<R> cell_terms(const V& tm, const Cell& c, Div&& dv) const {
    return stokes_cell_of(s, tm.at(1, c), tm.at(1, c, 1), tm.at(2, c), tm.at(2, c, 0, 1),
                          tm.at(3, c), tm.at(3, c, 0, 0, 1), tm.at(0, c), dv);
  }
  // the cell term a face of dim A reads: txx - Pn, tyy - Pn or tzz - Pn
  template <int A, typename V, typename Div>
  __device__ R cell_term(const V& tm, const Cell& c, Div&& dv) const {
    const StokesCell<R> sc = cell_terms(tm, c, dv);
    return A == 0 ? sc.a : (A == 1 ? sc.ty : sc.tz);
  }
  // the edge stress of dims P < Q: mu*((V_P - V_P[-Q])/dQ + (V_Q - V_Q[-P])/dP)
  template <int P, int Q, typename V, typename Div>
  __device__ R edge(const V& tm, const Cell& c, Div&& dv) const {
    const CDiv<R>& dp = P == 0 ? s.dx : s.dy;
    const CDiv<R>& dq = Q == 1 ? s.dy : s.dz;
    return stokes_edge(s, tm.at(P + 1, c), tm.along(P + 1, c, Q, -1), dq, tm.at(Q + 1, c),
                       tm.along(Q + 1, c, P, -1), dp, dv);
  }
  template <int A, int B, typename V, typename Div>
  __device__ R edge_of(const V& tm, const Cell& c, Div&& dv) const {
    return edge<(A < B ? A : B), (A < B ? B : A)>(tm, c, dv);
  }
  template <int F, typename V> __device__ R cell(const V& tm, const Cell& c) const {
    R v;
    if constexpr (F == 0) {
      retry_passes([&](auto&& dv) { v = cell_terms(tm, c, dv).pn; });
    } else {
      constexpr int a = F - 1, b1 = other(a, 1), b2 = other(a, 2);
      v = tm.at(F, c);
      const bool in = a == 0   ? vx_interior(s.nx, s.ny, s.nz, c.l0, c.l1, c.l2)
                      : a == 1 ? vy_interior(s.nx, s.ny, s.nz, c.l0, c.l1, c.l2)
                               : vz_interior(s.nx, s.ny, s.nz, c.l0, c.l1, c.l2);
      if (!in) return v;
      const R V0 = v;
      retry_passes([&](auto&& dv) {
        const R tc = cell_term<a>(tm, c, dv), tb = cell_term<a>(tm, shifted(c, a, -1), dv);
        const R e1 = edge_of<a, b1>(tm, c, dv), e1p = edge_of<a, b1>(tm, shifted(c, b1, 1), dv);
        const R e2 = edge_of<a, b2>(tm, c, dv), e2p = edge_of<a, b2>(tm, shifted(c, b2, 1), dv);
        R r;
        if constexpr (a == 0) {
          r = stokes_rx(s, tc, tb, e1p, e1, e2p, e2, dv);
        } else if constexpr (a == 1) {
          r = stokes_ry(s, tc, tb, e1p, e1, e2p, e2, dv);
        } else {
          const R rg = stokes_rg_of<R, FORM_GETTER>(tm.at(5, c), tm.at(5, c, 0, 0, -1));
          r = stokes_rz(s, tc, tb, e1p, e1, e2p, e2, rg, dv);
        }
        v = V0 + s.dt_v * (s.damp * tm.at(4, c) + r);
      });
    }
    return v;
  }
};

// The received value of a cell (local index l, block c, stacked index g,
// field extents m, blocks D) from an earlier dim e (dim DU or DV), if its
// local index along e lies in e's halo.
template <int DU, int DV, typename S>
__device__ __forceinline__ bool from_earlier(const Earlier<S>& e, const unsigned (&l)[3],
                                             const unsigned (&c)[3], const unsigned (&g)[3],
                                             const unsigned (&m)[3], const unsigned (&D)[3],
                                             S& v) {
  if (e.l == nullptr) return false;
  const bool on_u = e.dim == DU;
  const unsigned loc = on_u ? l[DU] : l[DV], me = on_u ? m[DU] : m[DV];
  const S* src;
  unsigned h;
  if (loc < e.hw) {
    src = e.l;
    h = loc;
  } else if (loc >= me - e.hw) {
    src = e.r;
    h = loc - (me - e.hw);
  } else {
    return false;
  }
  h += (on_u ? c[DU] : c[DV]) * e.hw;
  const unsigned ext = (on_u ? D[DU] : D[DV]) * e.hw;
  unsigned g0 = g[0], g1 = g[1], g2 = g[2], X1 = D[1] * m[1], X2 = D[2] * m[2];
  if (e.dim == 0) {
    g0 = h;
  } else if (e.dim == 1) {
    g1 = h;
    X1 = ext;
  } else {
    g2 = h;
    X2 = ext;
  }
  v = src[((long long)g0 * X1 + g1) * X2 + g2];
  return true;
}

// The source block along dim d of target block t for a move of shift
// `shift`: t + shift (mod D when periodic); on a PROC_NULL edge (no such
// block) t itself, and `edge` is set.
__device__ __forceinline__ unsigned source_block(unsigned t, int shift, unsigned D, int periodic,
                                                 bool& edge) {
  int sb = (int)t + shift;
  edge = false;
  if (periodic) {
    sb %= (int)D;
    if (sb < 0) sb += (int)D;
  } else if (sb < 0 || sb >= (int)D) {
    sb = (int)t;
    edge = true;
  }
  return (unsigned)sb;
}

// Value v of the cell at local l of source block cb into job J's slab at
// target block t, slab position q, patched with what that block received
// along earlier dims (the later dim wins).
template <int DIM, typename S>
__device__ __forceinline__ void slab_out(const SlabJobs<S>& jb, const SlabJob<S>& J,
                                         const unsigned (&cb)[3], const unsigned (&l)[3],
                                         unsigned t, unsigned q, S v) {
  constexpr int DU = DIM == 0 ? 1 : 0, DV = DIM == 2 ? 1 : 2;
  unsigned D[3], m[3], g[3];
  for (int d = 0; d < 3; ++d) D[d] = jb.D[d], m[d] = J.m[d], g[d] = cb[d] * m[d] + l[d];
  if (!from_earlier<DU, DV>(J.e[1], l, cb, g, m, D, v))
    from_earlier<DU, DV>(J.e[0], l, cb, g, m, D, v);
  unsigned O[3], X[3];
  for (int d = 0; d < 3; ++d) {
    O[d] = g[d];
    X[d] = D[d] * m[d];
  }
  O[DIM] = t * jb.hw + q;
  X[DIM] = D[DIM] * jb.hw;
  J.out[((long long)O[0] * X[1] + O[1]) * X[2] + O[2]] = v;
}

// The geometry of an x or y tile: the target block t along the exchange
// dim, the slab position q, the blocks cu, cv and tile origins ou, ov along
// u and v, and the thread's cell c in the box.
struct TileAt {
  unsigned t, q, cu, cv, ou, ov, c[3];
};

// Job J of an x or y tile along dim DIM, field F: the thread's cell.
template <int DIM, int F, typename S, typename M>
__device__ __forceinline__ void slab_job(const SlabJobs<S>& jb, const SlabJob<S>& J, const M& md,
                                         const TileAt& ta) {
  constexpr int DU = DIM == 0 ? 1 : 0, DV = DIM == 2 ? 1 : 2;
  bool edge;
  unsigned cb[3], l[3];
  cb[DIM] = source_block(ta.t, J.mv.shift, jb.D[DIM], jb.periodic, edge);
  cb[DU] = ta.cu, cb[DV] = ta.cv;
  l[DIM] = (unsigned)(edge ? J.mv.own : J.mv.start) + ta.q;
  l[DU] = ta.ou + ta.c[DU], l[DV] = ta.ov + ta.c[DV];
  if (l[DU] >= J.m[DU] || l[DV] >= J.m[DV]) return;  // past the block
  Tile<S, typename M::C, M::NIN> tm;
#pragma unroll
  for (int s = 0; s < M::NIN; ++s) {  // each operand's source block
    unsigned mg[3];
    const S* p = md.operand(M::template op<F>(s), mg);
    const long long row = (long long)jb.D[2] * mg[2], plane = (long long)jb.D[1] * mg[1] * row;
    tm.in[s] = Operand<S>{p + cb[0] * mg[0] * plane + cb[1] * mg[1] * row + cb[2] * mg[2],
                          plane, row};
  }
  const S v = md.template cell<F>(tm, Cell{(int)l[0], (int)l[1], (int)l[2]});
  slab_out<DIM>(jb, J, cb, l, ta.t, ta.q, v);
}

// An x or y tile of a K4s launch along dim DIM (see the design above).
template <int DIM, typename S, typename M>
__device__ __forceinline__ void slab_tile(const SlabJobs<S>& jb, const M& md) {
  constexpr int DU = DIM == 0 ? 1 : 0, DV = DIM == 2 ? 1 : 2;
  const unsigned tid = threadIdx.x, tvl = jb.tv_log, TV = 1u << tvl, TU = K4S_THREADS >> tvl;
  // the tile's index, fastest first: slab position, target block along DIM
  // (so the tiles that read the two faces of one block run side by side),
  // tile and block along v, tile and block along u
  TileAt ta;
  unsigned r = blockIdx.x;
  ta.q = r % jb.hw, r /= jb.hw;
  ta.t = r % jb.D[DIM], r /= jb.D[DIM];
  const unsigned tv = r % jb.ntv;
  r /= jb.ntv;
  ta.cv = r % jb.D[DV], r /= jb.D[DV];
  const unsigned tu = r % jb.ntu;
  ta.cu = r / jb.ntu;
  ta.ou = tu * TU, ta.ov = tv * TV;
  ta.c[DIM] = 0, ta.c[DU] = tid >> tvl, ta.c[DV] = tid & (TV - 1);
  // a single field's slabs: a job a thread block (grid row); the staggered
  // modes: every field's and side's in turn
  const unsigned j0 = M::NFIELDS == 1 ? blockIdx.y : 0, j1 = M::NFIELDS == 1 ? j0 + 1 : jb.n;
  for (unsigned jn = j0; jn < j1; ++jn) {
    const SlabJob<S>& J = jb.j[jn];
    switch (J.f) {
      case 0: slab_job<DIM, 0>(jb, J, md, ta); break;
      case 1: if constexpr (M::NFIELDS > 1) slab_job<DIM, 1>(jb, J, md, ta); break;
      case 2: if constexpr (M::NFIELDS > 1) slab_job<DIM, 2>(jb, J, md, ta); break;
      default: if constexpr (M::NFIELDS > 1) slab_job<DIM, 3>(jb, J, md, ta); break;
    }
  }
}

// A z tile's ring: 8 planes where a cell of every operand is at most 16
// bytes together (float32, bfloat16), else 4; and its shared memory, the
// ring of 66 rows (64 and the two around them) of 4 window cells.
template <typename S, typename M> __host__ __device__ constexpr unsigned z_slots() {
  return M::NOPS * sizeof(S) <= 16 ? 8 : 4;
}
template <typename S, typename M> __host__ __device__ constexpr unsigned z_bytes() {
  const unsigned b = z_slots<S, M>() * M::NOPS * (unsigned)sizeof(S) * 4 * 66;
  return b < 45056 ? b : 45056;
}

template <unsigned B> struct alignas(16) ZBuf {
  unsigned char b[B];
};

// A z tile's ring (see `Staged`): the elements of one staged operand (opn)
// and of one ring slot, the slot mask, the row pitch, and the local row and
// z of staged row 0 and window cell 0.
struct ZRing {
  unsigned opn, ring, slm, rp;
  int r0, z0;
};

// Job J of a z tile, field F: row y's slab cells at plane x, positions
// [q0, q1).
template <int F, typename S, typename M>
__device__ __forceinline__ void z_job(const SlabJobs<S>& jb, const SlabJob<S>& J, const M& md,
                                      const S* zs, const ZRing& zr, const unsigned (&cb)[3],
                                      unsigned t, bool edge, unsigned x, unsigned y, unsigned q0,
                                      unsigned q1) {
  if (x >= J.m[0] || y >= J.m[1]) return;
  Staged<S, typename M::C, M::NIN> v;
#pragma unroll
  for (int s = 0; s < M::NIN; ++s) v.b[s] = zs + M::template op<F>(s) * zr.opn;
  v.ring = zr.ring, v.slm = zr.slm, v.rp = zr.rp, v.r0 = zr.r0, v.z0 = zr.z0;
  const unsigned pos = (unsigned)(edge ? J.mv.own : J.mv.start);
  unsigned l[3] = {x, y, 0};
  for (unsigned q = q0; q < q1; ++q) {
    l[2] = pos + q;
    const S val = md.template cell<F>(v, Cell{(int)l[0], (int)l[1], (int)l[2]});
    slab_out<2>(jb, J, cb, l, t, q, val);
  }
}

// A wave-mode z tile (see the design above): rows along y, walking x; a
// thread computes one job's cells of one row.
template <typename S, typename M>
__device__ __forceinline__ void z_tile(const SlabJobs<S>& jb, const M& md) {
  constexpr unsigned SLOTS = z_slots<S, M>(), AHEAD = SLOTS - 3;
  __shared__ ZBuf<z_bytes<S, M>()> zbuf;
  S* const zs = reinterpret_cast<S*>(zbuf.b);
  const ZPlan& z = jb.z;
  const unsigned tid = threadIdx.x, wl = z.wl, nt = z.nt;
  ZRing zr;
  zr.rp = z.ty + 2, zr.slm = SLOTS - 1, zr.opn = z.w * zr.rp, zr.ring = M::NOPS * zr.opn;
  // the tile's index, fastest first: slab positions, target block (so the
  // tiles that read the two faces of one block run side by side), group,
  // row tile, walk chunk, block along the rows, block along the walk
  unsigned r = blockIdx.x;
  const unsigned qi = r % z.nqc;
  r /= z.nqc;
  const unsigned t = r % jb.D[2];
  r /= jb.D[2];
  const unsigned gi = r % z.ng;
  r /= z.ng;
  const unsigned rt = r % z.nrt;
  r /= z.nrt;
  const unsigned xi = r % z.nxc;
  r /= z.nxc;
  unsigned cb[3];
  cb[1] = r % jb.D[1], cb[0] = r / jb.D[1];
  // the group's source block (one shift), window, operands and walk extent;
  // the thread's job: the group's (tid >> tyl)-th, if any
  const unsigned gm = z.jobs[gi];
  bool edge = false;
  int lo = 1 << 30;
  unsigned mask = 0, mw = 0, mine = K4S_JOBS, k = 0;
  for (unsigned jn = 0; jn < jb.n; ++jn) {
    if (!(gm >> jn & 1)) continue;
    if (k++ == tid >> z.tyl) mine = jn;
    const SlabJob<S>& J = jb.j[jn];
    cb[2] = source_block(t, J.mv.shift, jb.D[2], jb.periodic, edge);
    lo = min(lo, edge ? J.mv.own : J.mv.start);
    mask |= M::op_mask(J.f);
    mw = max(mw, J.m[0]);
  }
  const unsigned q0 = qi * z.qc, q1 = min(q0 + z.qc, jb.hw);
  zr.z0 = lo + (int)q0 - 1, zr.r0 = (int)(rt * z.ty) - 1;
  const int xa = (int)(xi * z.xc), xb = min(xa + (int)z.xc, (int)mw);  // planes [xa, xb)
  // plane p of every operand the group reads, rows r0.. and window cells
  // z0.. inside the operand's block, into ring slot p % SLOTS: 1 << wl
  // lanes a row, one a window cell
  auto stage = [&](int p) {
    if (p < xa - 1 || p > xb || p < 0) return;
    S* dp = zs + ((unsigned)p & (SLOTS - 1)) * zr.ring;
#pragma unroll
    for (int o = 0; o < M::NOPS; ++o) {
      if (!(mask >> o & 1)) continue;
      unsigned m[3];
      const S* src = md.operand(o, m);
      if ((unsigned)p >= m[0]) continue;
      const long long row = (long long)jb.D[2] * m[2], plane = (long long)jb.D[1] * m[1] * row;
      src += cb[0] * m[0] * plane + cb[1] * m[1] * row + cb[2] * m[2] + p * plane;
      S* d = dp + o * zr.opn;
      for (unsigned e = tid; e < zr.rp << wl; e += nt) {
        const unsigned w = e & ((1u << wl) - 1), rr = e >> wl;
        const int y = zr.r0 + (int)rr, zz = zr.z0 + (int)w;
        if (w < z.w && y >= 0 && (unsigned)y < m[1] && zz >= 0 && (unsigned)zz < m[2])
          stage1(d + w * zr.rp + rr, src + y * row + zz);
      }
    }
  };
  // planes xa-1 .. xa+AHEAD in flight, a commit group each; plane x+AHEAD+1
  // goes into the slot of plane x-2, which iteration x-1 read last (the
  // barrier of iteration x is after it)
  for (int p = xa - 1; p <= xa + (int)AHEAD; ++p) {
    stage(p);
    __pipeline_commit();
  }
  const unsigned y = rt * z.ty + (tid & (z.ty - 1));
  for (int x = xa; x < xb; ++x) {
    __pipeline_wait_prior(AHEAD - 1);  // plane x+1 landed
    __syncthreads();
    stage(x + (int)AHEAD + 1);
    __pipeline_commit();
    if (mine == K4S_JOBS) continue;
    const SlabJob<S>& J = jb.j[mine];
#define IGG_Z_JOB(F) z_job<F>(jb, J, md, zs, zr, cb, t, edge, (unsigned)x, y, q0, q1)
    switch (J.f) {
      case 0: IGG_Z_JOB(0); break;
      case 1: IGG_Z_JOB(1); break;
      case 2: IGG_Z_JOB(2); break;
      default: IGG_Z_JOB(3); break;
    }
#undef IGG_Z_JOB
  }
}

// Whether mode M's z launch walks x with staged planes (`z_tile`): the
// wave modes. The other modes' z tiles are `slab_tile`'s, which measured
// faster for them on the H100 (PERF.md §6): the step modes in every
// variant, the Stokes modes on the solver's own state (zeros and tiny
// values, where the division's retries run), though not on random ones.
template <typename M> constexpr bool z_walks = false;
template <typename S> constexpr bool z_walks<WaveSlab<S>> = true;

// The copy and diffusion-step modes (CopySlab, StepSlab).
template <int DIM, typename S, typename M>
__global__ void __launch_bounds__(K4S_THREADS)
exchange_slabs_kernel(const __grid_constant__ SlabJobs<S> jb, const __grid_constant__ M md) {
  slab_tile<DIM>(jb, md);
}

// The staggered modes (WaveSlab, StokesSlab): the received slabs of one dim
// for each field of the fused acoustic step (wave.cuh) or PT iteration
// (stokes.cuh), one launch for all four.
template <int DIM, typename S, typename M>
__global__ void __launch_bounds__(K4S_THREADS)
exchange_slabs_staggered_kernel(const __grid_constant__ SlabJobs<S> jb,
                                const __grid_constant__ M md) {
  if constexpr (DIM == 2 && z_walks<M>)
    z_tile(jb, md);
  else
    slab_tile<DIM>(jb, md);
}

// Checks of one K4s field (32-bit extents and slab cells, earlier dims);
// returns false for invalid arguments.
bool slabs_fit(long long S0, long long S1, long long S2, long long n0, long long n1,
               long long n2, int dim, long long hw, int e0d, const void* e0l, int e1d,
               const void* e1l) {
  const long long lim = 1LL << 31;
  if (dim < 0 || dim > 2 || hw < 1 || n0 < 1 || n1 < 1 || n2 < 1 || S0 >= lim ||
      S1 >= lim || S2 >= lim)
    return false;
  if (e0d > 2 || e1d > 2 || (e0d < 0 && e0l) || (e1d < 0 && e1l) || e0d == dim || e1d == dim)
    return false;
  const long long Sv[3] = {S0, S1, S2}, nv[3] = {n0, n1, n2};
  long long P[3] = {S0, S1, S2};
  P[dim] = (Sv[dim] / nv[dim]) * hw;
  return P[0] * P[1] * P[2] < lim;
}

// Add the job of output `out` (null: none) of a field of block extents m
// to the launch.
template <typename S>
void add_job(SlabJobs<S>& jb, S* out, Move mv, Earlier<S> e0, Earlier<S> e1,
             const unsigned (&m)[3], int f, int dim) {
  if (out == nullptr) return;
  const int du = dim == 0 ? 1 : 0, dv = dim == 2 ? 1 : 2;
  const unsigned TV = 1u << jb.tv_log, TU = K4S_THREADS >> jb.tv_log;
  jb.j[jb.n++] = SlabJob<S>{out, mv, {e0, e1}, {m[0], m[1], m[2]}, f};
  jb.ntu = std::max(jb.ntu, (m[du] + TU - 1) / TU);
  jb.ntv = std::max(jb.ntv, (m[dv] + TV - 1) / TV);
}

// An x or y launch's thread blocks: the tiles of the blocks along u and v,
// the slab positions and the target blocks along dim.
template <typename S>
long long tile_grid(const SlabJobs<S>& jb, int dim) {
  const int du = dim == 0 ? 1 : 0, dv = dim == 2 ? 1 : 2;
  return (long long)jb.D[dim] * jb.hw * jb.D[du] * jb.ntu * jb.D[dv] * jb.ntv;
}

// The x and y tiles' extent along v for blocks m: 32 lanes, or the whole
// tile along the one of u and v where the block is one cell wide.
inline unsigned tv_log(const unsigned (&m)[3], int dim) {
  const int du = dim == 0 ? 1 : 0, dv = dim == 2 ? 1 : 2;
  if (m[dv] == 1) return 0;
  if (m[du] == 1) return 8;  // log2 K4S_THREADS
  return 5;
}

// Plan a wave-mode z launch (mode M): group the jobs, pick the tile, and
// return its thread blocks. A group's at most 4 jobs share a shift (so a
// source block) and lie within one cell of each other at their starts and
// at their own starts, so one window of width spread + positions + 2 holds
// the z cells they read. A tile takes 64 rows (32 where the block has no
// more, or where 64 do not fit the ring), as many slab positions as fit,
// and enough chunks of the walk for about 1024 tiles, each at least 8
// planes.
template <typename S, typename M>
long long z_plan(SlabJobs<S>& jb) {
  ZPlan& z = jb.z;
  z = ZPlan{};
  int sh[K4S_JOBS], lo[K4S_JOBS][2], hi[K4S_JOBS][2];
  for (unsigned jn = 0; jn < jb.n; ++jn) {
    const Move& mv = jb.j[jn].mv;
    const int at[2] = {mv.start, mv.own};
    unsigned g = 0;
    for (; g < z.ng; ++g) {
      bool near = sh[g] == mv.shift && __builtin_popcount(z.jobs[g]) < 4;
      for (int k = 0; k < 2; ++k)
        near = near && std::max(hi[g][k], at[k]) - std::min(lo[g][k], at[k]) <= 1;
      if (near) break;
    }
    if (g == z.ng) {
      ++z.ng;
      sh[g] = mv.shift;
      for (int k = 0; k < 2; ++k) lo[g][k] = hi[g][k] = at[k];
    }
    for (int k = 0; k < 2; ++k) {
      lo[g][k] = std::min(lo[g][k], at[k]);
      hi[g][k] = std::max(hi[g][k], at[k]);
    }
    z.jobs[g] |= 1u << jn;
  }
  unsigned spread = 0, mr = 0, mw = 0;
  for (unsigned g = 0; g < z.ng; ++g)
    for (int k = 0; k < 2; ++k) spread = std::max(spread, (unsigned)(hi[g][k] - lo[g][k]));
  for (unsigned jn = 0; jn < jb.n; ++jn) {
    mr = std::max(mr, jb.j[jn].m[1]);
    mw = std::max(mw, jb.j[jn].m[0]);
  }
  auto fits = [&] {
    return z_slots<S, M>() * M::NOPS * z.w * (z.ty + 2) * sizeof(S) <= z_bytes<S, M>();
  };
  for (z.qc = jb.hw;; --z.qc) {  // one position always fits: w <= 4
    z.w = spread + z.qc + 2;
    for (z.ty = mr > 32 ? 64 : 32; z.ty > 32 && !fits(); z.ty /= 2) {
    }
    if (fits() || z.qc == 1) break;
  }
  for (z.wl = 0; (1u << z.wl) < z.w; ++z.wl) {
  }
  for (z.tyl = 0; (1u << z.tyl) < z.ty; ++z.tyl) {
  }
  unsigned most = 0;  // jobs of the largest group
  for (unsigned g = 0; g < z.ng; ++g)
    most = std::max(most, (unsigned)__builtin_popcount(z.jobs[g]));
  z.nt = z.ty * most;
  z.nrt = (mr + z.ty - 1) / z.ty;
  z.nqc = (jb.hw + z.qc - 1) / z.qc;
  const long long tiles = (long long)z.nqc * jb.D[2] * z.ng * z.nrt * jb.D[1] * jb.D[0];
  unsigned nxc = 1;
  while (tiles * nxc < 1024 && mw / (2 * nxc) >= 8) nxc *= 2;
  z.xc = (mw + nxc - 1) / nxc;
  z.nxc = (mw + z.xc - 1) / z.xc;
  return tiles * z.nxc;
}

// Launch a K4s batch of `jb` along dim with mode md; STAG picks the
// staggered kernel.
template <bool STAG, typename S, typename M>
int launch_slabs(SlabJobs<S>& jb, const M& md, int dim, cudaStream_t st) {
  if (jb.n == 0) return (int)cudaSuccess;
  bool walk = false;
  long long blocks;
  if constexpr (z_walks<M>) walk = dim == 2;
  if constexpr (z_walks<M>)
    blocks = walk ? z_plan<S, M>(jb) : tile_grid(jb, dim);
  else
    blocks = tile_grid(jb, dim);
  if (blocks >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)blocks, M::NFIELDS == 1 ? jb.n : 1);
  const unsigned threads = walk ? jb.z.nt : K4S_THREADS;
#define IGG_K4S(D)                                                              \
  if constexpr (STAG)                                                           \
    exchange_slabs_staggered_kernel<D, S, M><<<grid, threads, 0, st>>>(jb, md); \
  else                                                                          \
    exchange_slabs_kernel<D, S, M><<<grid, threads, 0, st>>>(jb, md)
  switch (dim) {
    case 0: IGG_K4S(0); break;
    case 1: IGG_K4S(1); break;
    default: IGG_K4S(2); break;
  }
#undef IGG_K4S
  return (int)cudaGetLastError();
}

// One field's K4s launch (modes 0 to 2).
template <typename S, typename M>
int exchange_slabs(const M& md, void* o0, void* o1, const unsigned (&n)[3], const unsigned (&D)[3],
                   int dim, unsigned hw, int periodic, Move m0, Move m1, Earlier<S> e0,
                   Earlier<S> e1, cudaStream_t st) {
  SlabJobs<S> jb{};
  jb.periodic = periodic;
  jb.hw = hw;
  jb.tv_log = tv_log(n, dim);
  for (int d = 0; d < 3; ++d) jb.D[d] = D[d];
  add_job(jb, static_cast<S*>(o0), m0, e0, e1, n, 0, dim);
  add_job(jb, static_cast<S*>(o1), m1, e0, e1, n, 0, dim);
  return launch_slabs<false>(jb, md, dim, st);
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
  if (!slabs_fit(S0, S1, S2, n0, n1, n2, dim, hw, e0d, e0l, e1d, e1l))
    return (int)cudaErrorInvalidValue;
  const unsigned n[3] = {(unsigned)n0, (unsigned)n1, (unsigned)n2};
  const unsigned D[3] = {(unsigned)(S0 / n0), (unsigned)(S1 / n1), (unsigned)(S2 / n2)};
  const Move m0{(int)start0, (int)own0, (int)shift0}, m1{(int)start1, (int)own1, (int)shift1};
#define IGG_SLABS(S, MD)                                                                   \
  exchange_slabs<S>(MD, out0, out1, n, D, dim, (unsigned)hw, periodic, m0, m1,             \
                    Earlier<S>{static_cast<const S*>(e0l), static_cast<const S*>(e0r), e0d, \
                               (unsigned)e0h},                                             \
                    Earlier<S>{static_cast<const S*>(e1l), static_cast<const S*>(e1r), e1d, \
                               (unsigned)e1h},                                             \
                    st)
#define IGG_COPY(S) IGG_SLABS(S, (CopySlab<S>{static_cast<const S*>(T), n[0], n[1], n[2]}))
  if (mode == 0) {
    switch (itemsize) {
      case 1: return IGG_COPY(uint8_t);
      case 2: return IGG_COPY(uint16_t);
      case 4: return IGG_COPY(uint32_t);
      case 8: return IGG_COPY(unsigned long long);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  if (mode != 1 && mode != 2) return (int)cudaErrorInvalidValue;
  // the 2-D step's y derivative runs in the z slot with dz = dy
  const double dz_ = mode == 1 ? dz : dy;
#define IGG_STEP(S, C, THREE_D)                                                                \
  IGG_SLABS(S, (StepSlab<S, C, THREE_D>{static_cast<const S*>(T), static_cast<const S*>(Cp), \
                                        n[0], n[1], n[2],                                      \
                                        make_consts<C>(lam, dt, dx, dy, dz_)}))
  switch (dtype * 2 + (mode - 1)) {
    case 0: return IGG_STEP(float, float, true);
    case 1: return IGG_STEP(float, float, false);
    case 2: return IGG_STEP(double, double, true);
    case 3: return IGG_STEP(double, double, false);
    case 4: return IGG_STEP(__nv_bfloat16, float, true);
    case 5: return IGG_STEP(__nv_bfloat16, float, false);
    default: return (int)cudaErrorInvalidValue;
  }
#undef IGG_STEP
#undef IGG_COPY
#undef IGG_SLABS
}

namespace {

// The batch of a staggered K4s launch: ptrs (after the state's `nstate`
// fields) hold per field P, Vx, Vy, Vz: out0, out1, e0l, e0r, e1l, e1r; g:
// nx, ny, nz (P's block), D0, D1, D2 (blocks), dim, hw, periodic, then per
// field: start0, own0, shift0, start1, own1, shift1, e0d, e0h, e1d, e1h. A
// field whose outputs are both null takes no part. Returns false for
// invalid arguments.
template <typename S>
bool slab_batch(const void* const* ptrs, int nstate, const long long* g, SlabJobs<S>& jb) {
  const long long lim = 1LL << 31;  // every field's stacked extents fit 32 bits
  if (g[0] < 1 || g[1] < 1 || g[2] < 1 || g[3] < 1 || g[4] < 1 || g[5] < 1 ||
      g[3] * (g[0] + 1) >= lim || g[4] * (g[1] + 1) >= lim || g[5] * (g[2] + 1) >= lim)
    return false;
  const int dim = (int)g[6];
  jb = SlabJobs<S>{};
  jb.periodic = (int)g[8];
  jb.hw = (unsigned)g[7];
  const unsigned D[3] = {(unsigned)g[3], (unsigned)g[4], (unsigned)g[5]};
  const unsigned n[3] = {(unsigned)g[0], (unsigned)g[1], (unsigned)g[2]};
  for (int d = 0; d < 3; ++d) jb.D[d] = D[d];
  jb.tv_log = tv_log(n, dim);
  for (int f = 0; f < 4; ++f) {
    const void* const* p = ptrs + nstate + 6 * f;
    const long long* h = g + 9 + 10 * f;
    S* o0 = static_cast<S*>(const_cast<void*>(p[0]));
    S* o1 = static_cast<S*>(const_cast<void*>(p[1]));
    if (o0 == nullptr && o1 == nullptr) continue;
    const unsigned m[3] = {n[0] + (f == 1), n[1] + (f == 2), n[2] + (f == 3)};
    if (!slabs_fit((long long)D[0] * m[0], (long long)D[1] * m[1], (long long)D[2] * m[2], m[0],
                   m[1], m[2], dim, g[7], (int)h[6], p[2], (int)h[8], p[4]))
      return false;
    const Earlier<S> e0{static_cast<const S*>(p[2]), static_cast<const S*>(p[3]), (int)h[6],
                        (unsigned)h[7]};
    const Earlier<S> e1{static_cast<const S*>(p[4]), static_cast<const S*>(p[5]), (int)h[8],
                        (unsigned)h[9]};
    add_job(jb, o0, Move{(int)h[0], (int)h[1], (int)h[2]}, e0, e1, m, f, dim);
    add_job(jb, o1, Move{(int)h[3], (int)h[4], (int)h[5]}, e0, e1, m, f, dim);
  }
  return true;
}

template <typename S, typename M>
int launch_staggered_slabs(const void* const* ptrs, int nstate, const long long* g, const M& md,
                           cudaStream_t st) {
  SlabJobs<S> jb;
  if (!slab_batch(ptrs, nstate, g, jb)) return (int)cudaErrorInvalidValue;
  return launch_slabs<true>(jb, md, (int)g[6], st);
}

}  // namespace

// K4s wave modes: the received slabs of one dim for every field of the
// fused acoustic step that exchanges along it, in one launch. dtype 0
// float32, 1 float64, 2 bfloat16. ptrs: P, Vx, Vy, Vz, then the batch
// (`slab_batch`). c: cx, cy, cz, dtK, dx, dy, dz (wave.cuh).
extern "C" int igg_exchange_slabs_wave(int dtype, const void* const* ptrs, const long long* g,
                                       const double* c, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define IGG_WAVE_SLABS(S)                                                                  \
  launch_staggered_slabs<S>(                                                               \
      ptrs, 4, g, WaveSlab<S>{make_wave<S>(ptrs[0], ptrs[1], ptrs[2], ptrs[3], g, c)}, st)
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
    case 0:
      return launch_staggered_slabs<float>(ptrs, 8, g,
                                           StokesSlab<float>{make_stokes<float>(ptrs, g, c)}, st);
    case 1:
      return launch_staggered_slabs<double>(
          ptrs, 8, g, StokesSlab<double>{make_stokes<double>(ptrs, g, c)}, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
