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
// 0 and nx afterwards (`vx_extra_plane_slabs`, `halo_write_inplace`); here
// the thread of the last plane, row or lane writes the extra face itself,
// with the same final bits. `wave_mp_planes`, the VMEM relay and the window
// handoff are TPU tiling.
//
// Bound on an H100 SXM (3.35 TB/s): read the four fields once and write them
// once, 8 bytes a cell in float32 (1.82 GB and 0.54 ms for 2x2x2 blocks of
// 192^3); ~20 operations a pressure cell is far below the ridge point, so
// bytes bound it. Design: a thread block is a tile of TZ = 32 lanes along z
// (one warp) by TR = 8 rows along y of one block, walking a chunk of XCHUNK
// planes along x, one thread a column. The tile's P plane with the row and
// lane around it, and its Vx, Vy and Vz faces, are staged in shared memory
// by cp.async one plane ahead (a plain copy for bfloat16, whose 2 bytes
// cp.async does not take), so every input is read from device memory once
// and every neighbour from shared memory; the thread carries Vx face i along
// x in a register. One barrier a plane. The three divisions are cdiv.cuh's
// corrected products, branch-free, again with every fallback only where a
// numerator left the window. The main loop writes every cell's update with
// no delivery test; after a barrier, the tile's threads share out the
// tile's halo cells of the exchanging dims (`deliver_tile`: planes, rows
// and lanes, each cell once) and overwrite them with the received value or
// the self map's, which recomputes the remapped cell through the generic
// functions of wave.cuh. So the halos cost no divergence in the main loop
// and no registers there (a first version that tested every cell against
// the halos diverged and spilled; PERF.md).
// 32-bit in-block and in-plane indices, 64-bit plane offsets.
#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "wave.cuh"

namespace {

constexpr unsigned TZ = 32;      // lanes of a tile: one warp along z
constexpr unsigned TR = 8;       // rows of a tile
constexpr unsigned THREADS = TZ * TR;
constexpr unsigned XCHUNK = 16;  // x planes a tile walks
constexpr unsigned AHEAD = 1;    // planes staged ahead (cp.async groups in flight)
// Slots of staged planes: P of planes i..i+AHEAD+2 (plane i reads P[i] and
// P[i+1]), the faces of planes i..i+AHEAD+1.
constexpr unsigned PSLOTS = AHEAD + 3, VSLOTS = AHEAD + 2;
constexpr unsigned NP = (TR + 2) * (TZ + 2), NY = (TR + 1) * TZ, NZ = TR * (TZ + 1),
                   NX = TR * TZ;
constexpr unsigned NONE = 0xffffffffu;

template <typename T>
struct Outs {
  T *P, *Vx, *Vy, *Vz;
};

// A tile's shared memory: P of plane p in slot p % PSLOTS at [row + 1][lane
// + 1] (rows -1..TR, lanes -1..TZ); the faces plane p's cells read, in slot
// p % VSLOTS: Vx face p+1 (rows 0..TR-1, lanes 0..TZ-1), Vy faces j0..j0+TR
// (rows 0..TR) and Vz faces k0..k0+TZ (lanes 0..TZ).
template <typename S>
struct Tile {
  S p[PSLOTS][TR + 2][TZ + 2];
  S vx[VSLOTS][TR][TZ];
  S vy[VSLOTS][TR + 1][TZ];
  S vz[VSLOTS][TR][TZ + 1];
};

// The in-plane offsets of the elements of each staged tile a thread copies
// every plane (NONE: no element): elements tid and tid + THREADS of P's, Vy's
// and Vz's tiles, element tid of Vx's, clamped into the block.
struct Staging {
  unsigned p[2], y[2], z[2], x;
};

__device__ __forceinline__ Staging staging(unsigned tid, unsigned j0, unsigned k0,
                                           unsigned ny, unsigned nz, unsigned row_p,
                                           unsigned row_z) {
  Staging g;
  for (unsigned q = 0; q < 2; ++q) {
    const unsigned e = tid + q * THREADS;
    g.p[q] = e < NP ? clamp_to((int)(j0 + e / (TZ + 2)) - 1, ny) * row_p +
                          clamp_to((int)(k0 + e % (TZ + 2)) - 1, nz)
                    : NONE;
    g.y[q] = e < NY ? clamp_to((int)(j0 + e / TZ), ny + 1) * row_p +
                          clamp_to((int)(k0 + e % TZ), nz)
                    : NONE;
    g.z[q] = e < NZ ? clamp_to((int)(j0 + e / (TZ + 1)), ny) * row_z +
                          clamp_to((int)(k0 + e % (TZ + 1)), nz + 1)
                    : NONE;
  }
  g.x = clamp_to((int)(j0 + tid / TZ), ny) * row_p + clamp_to((int)(k0 + tid % TZ), nz);
  return g;
}

// Stage P of plane p < nx.
template <typename S>
__device__ __forceinline__ void stage_p(Tile<S>& t, const Wave<S>& w, const WaveBlock& b,
                                        const Staging& g, unsigned tid, unsigned p) {
  const S* src = w.P + (b.p + p * b.sp.plane);
  S* dst = &t.p[p % PSLOTS][0][0];
  for (unsigned q = 0; q < 2; ++q)
    if (g.p[q] != NONE) stage1(dst + tid + q * THREADS, src + g.p[q]);
}

// Stage what plane p < nx adds: P of plane p+1 (if any), Vx face p+1, and
// the Vy and Vz faces of plane p.
template <typename S>
__device__ __forceinline__ void stage_plane(Tile<S>& t, const Wave<S>& w, const WaveBlock& b,
                                            const Staging& g, unsigned tid, unsigned p) {
  if (p + 1 < w.nx) stage_p(t, w, b, g, tid, p + 1);
  const unsigned sl = p % VSLOTS;
  stage1(&t.vx[sl][0][0] + tid, w.Vx + (b.vx + (p + 1) * b.sp.plane + g.x));
  const S* vy = w.Vy + (b.vy + p * b.sy.plane);
  const S* vz = w.Vz + (b.vz + p * b.sz.plane);
  for (unsigned q = 0; q < 2; ++q) {
    if (g.y[q] != NONE) stage1(&t.vy[sl][0][0] + tid + q * THREADS, vy + g.y[q]);
    if (g.z[q] != NONE) stage1(&t.vz[sl][0][0] + tid + q * THREADS, vz + g.z[q]);
  }
}

// Halo cell (i, j, k) of field f in block (c0, c1, c2), on an exchanging
// dim's halo: its received value (multi-rank route; some dim's delivery
// applies), or f updated at the cell the self map gives (all-self route).
// Inlined: as a call, its stack frame slowed the whole kernel (PERF.md).
template <typename S, bool SELF>
__device__ __forceinline__ void halo_cell(const Wave<S>& w, const Outs<S>& o, const Recvs<S>& r,
                                       const SelfMap& sm, const WaveBlock& b, int f,
                                       unsigned c0, unsigned c1, unsigned c2, unsigned i,
                                       unsigned j, unsigned k) {
  const unsigned m0 = w.nx + (f == 1), m1 = w.ny + (f == 2), m2 = w.nz + (f == 3);
  S v;
  if (SELF) {
    v = wave_update(w, b, f, self_src(i, m0, sm.mode[f][0], sm.ol[f][0]),
                    self_src(j, m1, sm.mode[f][1], sm.ol[f][1]),
                    self_src(k, m2, sm.mode[f][2], sm.ol[f][2]));
  } else {
    v = received_or(r, f, m0, m1, m2, w.D1, w.D2, c0, c1, c2, i, j, k, S());
  }
  S* out = f == 0 ? o.P : (f == 1 ? o.Vx : (f == 2 ? o.Vy : o.Vz));
  const Strides st = f == 2 ? b.sy : (f == 3 ? b.sz : b.sp);
  const long long base = f == 0 ? b.p : (f == 1 ? b.vx : (f == 2 ? b.vy : b.vz));
  out[base + i * st.plane + j * st.row + k] = v;
}

// Whether dim d of field f exchanges: it receives slabs (multi-rank route)
// or is self-exchanging (all-self route).
template <typename S, bool SELF>
__device__ __forceinline__ bool exchanges(const Recvs<S>& r, const SelfMap& sm, int f, int d) {
  return SELF ? sm.mode[f][d] != 0 : r.r[f][d][0] != nullptr;
}

// The halo cells of a tile (planes [i_lo, i_hi), rows [j0, j_end), lanes
// [k0, k_end) of P's cells, and the extra face of a staggered field where
// the tile reaches it) on the exchanging dims, each cell once, shared out
// over the tile's threads: the halo planes, then the halo rows off them,
// then the halo lanes off both.
template <typename S, bool SELF>
__device__ __forceinline__ void deliver_tile(const Wave<S>& w, const Outs<S>& o,
                                             const Recvs<S>& r, const SelfMap& sm,
                                             const WaveBlock& b, unsigned c0, unsigned c1,
                                             unsigned c2, unsigned i_lo, unsigned i_hi,
                                             unsigned j0, unsigned j_end, unsigned k0,
                                             unsigned k_end, unsigned tid) {
  for (int f = 0; f < 4; ++f) {
    const unsigned m[3] = {w.nx + (f == 1), w.ny + (f == 2), w.nz + (f == 3)};
    const unsigned lo[3] = {i_lo, j0, k0};
    const unsigned hi[3] = {i_hi + (f == 1 && i_hi == w.nx), j_end + (f == 2 && j_end == w.ny),
                            k_end + (f == 3 && k_end == w.nz)};
    // the halo indices of each dim inside the tile (at most 2)
    unsigned h[3][2], nh[3];
    for (int d = 0; d < 3; ++d) {
      nh[d] = 0;
      if (!exchanges<S, SELF>(r, sm, f, d)) continue;
      if (lo[d] == 0) h[d][nh[d]++] = 0;
      if (m[d] - 1 >= lo[d] && m[d] - 1 < hi[d]) h[d][nh[d]++] = m[d] - 1;
    }
    if (nh[0] + nh[1] + nh[2] == 0) continue;
    const unsigned ni = hi[0] - lo[0], nj = hi[1] - lo[1], nk = hi[2] - lo[2];
    const auto in_halo = [&](int d, unsigned v) {
      return (nh[d] > 0 && h[d][0] == v) || (nh[d] > 1 && h[d][1] == v);
    };
    for (unsigned q = tid; q < nh[0] * nj * nk; q += THREADS) {
      const unsigned a = q / (nj * nk), rest = q - a * nj * nk;
      halo_cell<S, SELF>(w, o, r, sm, b, f, c0, c1, c2, h[0][a], lo[1] + rest / nk,
                         lo[2] + rest % nk);
    }
    for (unsigned q = tid; q < nh[1] * ni * nk; q += THREADS) {
      const unsigned a = q / (ni * nk), rest = q - a * ni * nk, i = lo[0] + rest / nk;
      if (!in_halo(0, i))
        halo_cell<S, SELF>(w, o, r, sm, b, f, c0, c1, c2, i, h[1][a], lo[2] + rest % nk);
    }
    for (unsigned q = tid; q < nh[2] * ni * nj; q += THREADS) {
      const unsigned a = q / (ni * nj), rest = q - a * ni * nj, i = lo[0] + rest / nj,
                     j = lo[1] + rest % nj;
      if (!in_halo(0, i) && !in_halo(1, j))
        halo_cell<S, SELF>(w, o, r, sm, b, f, c0, c1, c2, i, j, h[2][a]);
    }
  }
}

// Thread blocks an SM must hold at once, which bounds registers (64 for a
// 4-byte or 2-byte state, 80 for float64).
template <typename S> constexpr int k9_min_blocks() { return sizeof(S) == 8 ? 3 : 4; }

// Thread (lane, row) of a tile: column (j0 + row, k0 + lane) of block (c0,
// c1, c2), x planes [i_lo, i_hi). Blocks: x walks (block row c1, y tile,
// block lane c2, z tile), y (block plane c0, x chunk). Between barrier i and
// barrier i+1 a thread updates plane i from the staged planes and starts to
// stage plane i+AHEAD+1 into the slots plane i-1 used. The thread of the
// last plane, row or lane also writes the extra face (a boundary face: its
// raw value); the halos are delivered after the chunk.
template <typename S, bool SELF>
__global__ void __launch_bounds__(THREADS, k9_min_blocks<S>())
acoustic_step_kernel(const __grid_constant__ Wave<S> w, const __grid_constant__ Outs<S> o,
                     const __grid_constant__ Recvs<S> r, const __grid_constant__ SelfMap sm,
                     unsigned ntz, unsigned nty, unsigned nchunk) {
  using C = compute_t<S>;
  __shared__ Tile<S> t;
  const unsigned lane = threadIdx.x, row = threadIdx.y, tid = row * TZ + lane;
  const unsigned zt = blockIdx.x % (w.D2 * ntz), yt = blockIdx.x / (w.D2 * ntz);
  const unsigned c2 = zt / ntz, k0 = (zt - c2 * ntz) * TZ;
  const unsigned c1 = yt / nty, j0 = (yt - c1 * nty) * TR;
  const unsigned c0 = blockIdx.y / nchunk, i_lo = (blockIdx.y - c0 * nchunk) * XCHUNK;
  const unsigned nx = w.nx, ny = w.ny, nz = w.nz;
  const unsigned i_hi = min(nx, i_lo + XCHUNK);
  const unsigned j = j0 + row, k = k0 + lane;
  const bool own = j < ny && k < nz;
  const WaveBlock b = wave_block(w, c0, c1, c2);
  const Staging g = staging(tid, j0, k0, ny, nz, (unsigned)b.sp.row, (unsigned)b.sz.row);

  // Vx face i_lo updated, carried along x
  C ux_c = C(0);
  if (own) {
    const long long pc = b.p + i_lo * b.sp.plane + j * b.sp.row + k;
    ux_c = to_c(w.Vx[b.vx + i_lo * b.sp.plane + j * b.sp.row + k]);
    if (i_lo >= 1) ux_c = wave_face<S>(ux_c, w.cx, to_c(w.P[pc]), to_c(w.P[pc - b.sp.plane]));
  }
  stage_p(t, w, b, g, tid, i_lo);
  stage_plane(t, w, b, g, tid, i_lo);
  __pipeline_commit();
  for (unsigned d = 1; d <= AHEAD; ++d) {
    if (i_lo + d < i_hi) stage_plane(t, w, b, g, tid, i_lo + d);
    __pipeline_commit();
  }
  for (unsigned i = i_lo; i < i_hi; ++i) {
    __pipeline_wait_prior(AHEAD);
    __syncthreads();  // plane i staged; plane i-1 read by every thread
    if (i + AHEAD + 1 < i_hi) stage_plane(t, w, b, g, tid, i + AHEAD + 1);
    __pipeline_commit();
    if (!own) continue;
    const unsigned ps = i % PSLOTS, vs = i % VSLOTS;
    const C p_c = to_c(t.p[ps][row + 1][lane + 1]);
    C ux_p = to_c(t.vx[vs][row][lane]);
    if (i + 1 <= nx - 1)
      ux_p = wave_face<S>(ux_p, w.cx, to_c(t.p[(i + 1) % PSLOTS][row + 1][lane + 1]), p_c);
    C uy_c = to_c(t.vy[vs][row][lane]), uy_p = to_c(t.vy[vs][row + 1][lane]);
    if (j >= 1) uy_c = wave_face<S>(uy_c, w.cy, p_c, to_c(t.p[ps][row][lane + 1]));
    if (j + 1 <= ny - 1) uy_p = wave_face<S>(uy_p, w.cy, to_c(t.p[ps][row + 2][lane + 1]), p_c);
    C uz_c = to_c(t.vz[vs][row][lane]), uz_p = to_c(t.vz[vs][row][lane + 1]);
    if (k >= 1) uz_c = wave_face<S>(uz_c, w.cz, p_c, to_c(t.p[ps][row + 1][lane]));
    if (k + 1 <= nz - 1) uz_p = wave_face<S>(uz_p, w.cz, to_c(t.p[ps][row + 1][lane + 2]), p_c);
    C pn;
    retry_passes([&](auto&& dv) {
      pn = wave_pressure(w, p_c, ux_c, ux_p, uy_c, uy_p, uz_c, uz_p, dv);
    });
    const long long ox = b.vx + i * b.sp.plane + j * b.sp.row + k;
    const long long oy = b.vy + i * b.sy.plane + j * b.sy.row + k;
    const long long oz = b.vz + i * b.sz.plane + j * b.sz.row + k;
    o.P[b.p + i * b.sp.plane + j * b.sp.row + k] = from_c<S, C>(pn);
    o.Vx[ox] = from_c<S, C>(ux_c);
    o.Vy[oy] = from_c<S, C>(uy_c);
    o.Vz[oz] = from_c<S, C>(uz_c);
    if (i == nx - 1) o.Vx[ox + b.sp.plane] = from_c<S, C>(ux_p);
    if (j == ny - 1) o.Vy[oy + b.sy.row] = from_c<S, C>(uy_p);
    if (k == nz - 1) o.Vz[oz + 1] = from_c<S, C>(uz_p);
    ux_c = ux_p;
  }
  __syncthreads();  // the tile's updates are written: its halos overwrite them
  deliver_tile<S, SELF>(w, o, r, sm, b, c0, c1, c2, i_lo, i_hi, j0, min(j0 + TR, ny), k0,
                        min(k0 + TZ, nz), tid);
}

template <typename S>
int launch(int self_mode, const void* const* ptrs, const long long* g, const double* c,
           cudaStream_t st) {
  const Wave<S> w = make_wave<S>(ptrs[0], ptrs[1], ptrs[2], ptrs[3], g, c);
  const Outs<S> o{static_cast<S*>(const_cast<void*>(ptrs[4])),
                  static_cast<S*>(const_cast<void*>(ptrs[5])),
                  static_cast<S*>(const_cast<void*>(ptrs[6])),
                  static_cast<S*>(const_cast<void*>(ptrs[7]))};
  Recvs<S> r{};
  SelfMap sm{};
  for (int f = 0; f < 4; ++f)
    for (int d = 0; d < 3; ++d) {
      for (int s = 0; s < 2; ++s) r.r[f][d][s] = static_cast<const S*>(ptrs[8 + 6 * f + 2 * d + s]);
      if ((r.r[f][d][0] == nullptr) != (r.r[f][d][1] == nullptr)) return (int)cudaErrorInvalidValue;
      sm.mode[f][d] = (int)g[6 + 3 * f + d];
      sm.ol[f][d] = (unsigned)g[18 + 3 * f + d];
    }
  const unsigned ntz = (w.nz + TZ - 1) / TZ, nty = (w.ny + TR - 1) / TR;
  const unsigned nchunk = (w.nx + XCHUNK - 1) / XCHUNK;
  const unsigned long long tiles = (unsigned long long)w.D1 * nty * w.D2 * ntz;
  if (tiles > 0x7fffffffULL || (unsigned long long)w.D0 * nchunk > 65535)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)tiles, w.D0 * nchunk), block(TZ, TR);
  if (self_mode)
    acoustic_step_kernel<S, true><<<grid, block, 0, st>>>(w, o, r, sm, ntz, nty, nchunk);
  else
    acoustic_step_kernel<S, false><<<grid, block, 0, st>>>(w, o, r, sm, ntz, nty, nchunk);
  return (int)cudaGetLastError();
}

}  // namespace

// K9. dtype: 0 float32, 1 float64, 2 bfloat16. ptrs: P, Vx, Vy, Vz (the
// state), their outputs, then 24 received slabs [field P, Vx, Vy, Vz][dim]
// [left, right] (null where none; the multi-rank route). g: nx, ny, nz (P's
// block), D0, D1, D2 (blocks), then the self-exchange modes [field][dim] and
// overlaps [field][dim] (the all-self route, self_mode 1). c: cx, cy, cz,
// dtK, dx, dy, dz. Extents must keep every stacked field below 2^31 along
// each dim, every stacked plane and every block below 2^31 cells.
extern "C" int igg_acoustic_step_exchange(int dtype, int self_mode, const void* const* ptrs,
                                          const long long* g, const double* c,
                                          void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long lim = 1LL << 31;
  if (g[0] < 3 || g[1] < 1 || g[2] < 1 || g[3] < 1 || g[4] < 1 || g[5] < 1 ||
      g[3] * (g[0] + 1) >= lim || g[4] * (g[1] + 1) >= lim || g[5] * (g[2] + 1) >= lim ||
      g[4] * (g[1] + 1) * g[5] * (g[2] + 1) >= lim ||
      (g[0] + 1) * (g[1] + 1) * (g[2] + 1) >= lim)
    return (int)cudaErrorInvalidValue;
  switch (dtype) {
    case 0: return launch<float>(self_mode, ptrs, g, c, st);
    case 1: return launch<double>(self_mode, ptrs, g, c, st);
    case 2: return launch<__nv_bfloat16>(self_mode, ptrs, g, c, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
