// K2, K3 and K6: the halo copy kernels of update_halo on the virtual mesh.
//
// All three are pure copies of elements of any dtype (moved as 1, 2, 4 or 8-byte
// words) and match their plain versions bitwise. Fields are stacked: one
// contiguous tensor of shape (S0, S1, S2) holds every virtual rank's block of
// shape (n0, n1, n2), so one launch serves every block.
//
// K2 `igg_halo_write` replaces `halo_write_inplace`
// (implicitglobalgrid_tpu/ops/pallas_halo.py:142, its dim-0 plane copy kernel
// and the dim-1 `_rmw_kernel`): it writes the received slabs of width hw into
// the [0, hw) and [n-hw, n) halos of every block along `dim`, in place,
// touching only the halo. On the TPU the strip read-modify-write of dim 1 and
// the missing dim-2 kernel are (8, 128) tiling artefacts; here one kernel
// covers dims 0, 1 and 2.
// Bound (H100 SXM, 3.35 TB/s): read both slabs once and write them once,
// 2 x 2 x hw x cross-section x itemsize bytes; at 128^3 float32 blocks with
// hw 1 that is ~0.5 MB a dim for a 2x2x2 grid, ~0.2 us, so a launch is
// dominated by its fixed cost (along the last dim each cell sits in its own
// 32-byte sector: ~2.8 us of sectors). Design: tiles, not cells. Seen as
// (outer, L, inner) about `dim`, every halo plane of a block is `inner`
// cells contiguous in the field and in the slab for each outer index. Where
// inner > 1, a thread block is a tile of 8 rows (a warp a row, 16-byte words
// where every span aligns) of one slab plane and side, found from blockIdx
// once: rows of the plane's one run (dim 0) or one row an outer index. Where
// inner == 1 (the last dim), a thread owns a row and writes both halos of
// every block in it. No cell divides by a runtime extent.
//
// K3 `igg_halo_self_exchange` replaces `halo_self_exchange_pallas`
// (pallas_halo.py:384, kernel `_self_exchange_kernel` :558): every
// self-neighbour (periodic, single-rank) halo of hw 1, in one read+write
// pass, out of place. Output cell (i, j, k) of a block reads input cell
// (sx(i), sy(j), sz(k)), where a participating dim maps index 0 to n-ol and
// n-1 to ol-1 and every other index to itself: the composition of the z, x, y
// slab copies of the sequential exchange, corners included
// (pallas_halo.py:406-410,558-575).
// Bound: read + write the whole field, 2 x cells x itemsize: 134 MB and
// ~40 us for a 256^3 float32 block. Design: threads along z (coalesced reads
// and writes except the remapped halo lanes), each thread block on a few
// consecutive rows of one plane, with 32-bit index arithmetic (a first
// version that divided 64-bit indices per element took 230 us at 256^3).
//
// K6 `igg_halo_write_combined` replaces `halo_write_combined_pallas`
// (pallas_halo.py:446, kernel `_combined_write_kernel` :523): it delivers the
// received slabs of every exchanging dim in one launch, in place, in the
// reference's z, x, y write order (a y-halo row takes ry, else an x-halo
// plane takes rx, else a z-halo lane takes rz). The TPU kernel rewrites the
// whole array because its z-edge lanes force array-level traffic there; here
// a lane is a strided access, so K6 touches only halo cells, each once.
// Bound: read the slabs and write the halo cells once, 2 x halo cells x
// itemsize: ~25 MB and ~7.5 us for a 2x2x2 stack of 256^3 float32 blocks,
// against ~320 us for a full pass; the z lanes each sit in their own 32-byte
// sector, which makes ~54 MB and ~16 us. Design: tiles of three parts, each
// found from blockIdx once (prefix sums of the parts' tile counts, planned
// on the host): the z lanes outside the x and y halos (a thread a row,
// threads along y, writing both lanes of every block of the row), the x
// planes (a warp a row along z, 16-byte words where aligned; a row that is a
// y-halo row takes ry, decided once a row) and the y rows outside the x
// halos (skipped by the tiles' bounds). Each halo cell is written once.
//
// K8 `igg_wire_pack` and K7 `igg_halo_write_multi` are the two ends of the
// coalesced multi-field exchange (implicitglobalgrid_tpu/ops/halo.py:555,
// `_exchange_dim_coalesced`). K8 replaces `wire_pack_pallas`
// (pallas_halo.py:72): for every block, it writes that block's send slabs of
// every field of a group into the block's wire buffer, both directions in one
// launch; the buffer is, bit for bit, `WireSchema.pack` of those slabs (slab
// or flat layout: both are a gather by per-slab base offset and strides). K7
// replaces `halo_write_multi_pallas` (pallas_halo.py:269, `_multi_rmw_kernel`
// :347): for every block and every field, it writes the left halo from the
// right-send buffer of block t - disp and the right halo from the left-send
// buffer of block t + disp, unpacked by the same offsets; a PROC_NULL edge
// keeps its halo. The TPU limits (dims 0 and 1, a shared halowidth, 8-row
// strips, a VMEM budget) are tiling and have no counterpart: any dim, any
// per-field halowidth.
// Bound: read and write every slab cell once, 2 x cells x itemsize (~19 MB
// and ~5.7 us a dim for P, Vx, Vy, Vz on a 2x2x2 stack of 192^3 float32
// blocks). A z slab is hw cells of each row, so there the 32-byte sectors
// those cells touch bound it instead: ~24 us for K8 on that stack.
// Design: tiles, not cells. A thread block is a tile of one slab in one
// block of the stack, found from blockIdx once (the slab by a scan of the
// prefix sums of the slabs' tile counts, which `igg_coalesced_plan` fills in
// once a group signature; no grid sized to the largest slab); no cell
// divides by a runtime extent, offsets are 64-bit once a row and 32-bit in
// it. x and y: a tile is 8 rows (a warp each) of one slab position and one
// direction (K8) or side (K7); a row is n2 cells contiguous in the field and
// in the buffer (both layouts), copied in 16-byte words where every span is
// aligned. z: a thread a row, a tile 8 x planes by 32 y rows, threads along
// y so the buffer side stays contiguous; a thread moves both directions of
// its row (K8: the cells at start_r and start_l, read back to back, two
// sectors of one row) or writes both sides (K7: [0, hw) and [n-hw, n)), and
// K7 visits the rows in K8's order. K7 decides the source block, the wrap
// and the PROC_NULL edge once a tile; a tile with no source writes nothing.
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <initializer_list>

namespace {

constexpr int THREADS = 256;
constexpr unsigned MAX_GRID_YZ = 65535;

unsigned clamp_grid(long long n) {
  return (unsigned)(n < 1 ? 1 : (n < MAX_GRID_YZ ? n : MAX_GRID_YZ));
}

__device__ __forceinline__ unsigned remap32(unsigned K, unsigned n, int mode,
                                            unsigned ol) {
  if (!mode) return K;
  const unsigned c = K / n, k = K - c * n;
  return c * n + (k == 0 ? n - ol : (k == n - 1 ? ol - 1 : k));
}

// Threads along z (coalesced); a thread block copies YCHUNK consecutive rows
// of one output plane, so each block reads and writes contiguous memory (a
// version whose threads walked x down a column, one plane apart, ran at a
// third of the copy rate). Indices fit 32 bits (checked by the entry point);
// every offset is computed in 64 bits.
constexpr int YCHUNK = 8;

template <typename E>
__global__ void self_exchange_kernel(const E* __restrict__ a, E* __restrict__ out,
                                     unsigned S0, unsigned S1, unsigned S2, unsigned n0,
                                     unsigned n1, unsigned n2, int m0, int m1, int m2,
                                     unsigned ol0, unsigned ol1, unsigned ol2) {
  const unsigned K = blockIdx.x * blockDim.x + threadIdx.x;
  if (K >= S2) return;
  const unsigned Ks = remap32(K, n2, m2, ol2);
  for (unsigned I = blockIdx.z; I < S0; I += gridDim.z) {
    const long long src_plane = (long long)remap32(I, n0, m0, ol0) * S1;
    const long long dst_plane = (long long)I * S1;
#pragma unroll
    for (int t = 0; t < YCHUNK; ++t) {
      const unsigned J = blockIdx.y * YCHUNK + t;
      if (J >= S1) break;
      out[(dst_plane + J) * S2 + K] =
          a[(src_plane + remap32(J, n1, m1, ol1)) * S2 + Ks];
    }
  }
}

template <typename E>
void self_exchange(const void* a, void* out, long long S0, long long S1, long long S2,
                   long long n0, long long n1, long long n2, int m0, int m1, int m2,
                   long long ol0, long long ol1, long long ol2, cudaStream_t st) {
  dim3 grid((unsigned)((S2 + THREADS - 1) / THREADS),
            (unsigned)((S1 + YCHUNK - 1) / YCHUNK), clamp_grid(S0));
  self_exchange_kernel<E><<<grid, THREADS, 0, st>>>(
      static_cast<const E*>(a), static_cast<E*>(out), (unsigned)S0, (unsigned)S1,
      (unsigned)S2, (unsigned)n0, (unsigned)n1, (unsigned)n2, m0, m1, m2,
      (unsigned)ol0, (unsigned)ol1, (unsigned)ol2);
}

// K7 and K8: the slabs of a coalesced group. Field k is stacked, D0 x D1 x D2
// blocks of (n0, n1, n2), M times (an ensemble's members, mstride elements
// apart); its slab is the block with the exchange dim cut to hw, at local
// start start[0] (K8: the right send slab; K7: the left halo) or start[1]
// (K8: the left send slab; K7: the right halo). Cell x of member m's slab
// sits at base + x . (st0, st1, st2) in row b * M + m of the buffer (b the
// block), a row of payload cells.
constexpr int MAX_SLABS = 16;
constexpr int SLAB_DESC = 16;  // long longs a slab in the host descriptor
constexpr unsigned TILE_WARPS = THREADS / 32;  // rows of an x or y tile, planes of a z tile
constexpr unsigned NO_TILE = 0xffffffffu;

struct Slab {
  void* a;
  long long base, mstride;
  unsigned n0, n1, n2, hw, start[2], st0, st1, st2;
  // tiles of one block: x and y, nt0 along u (the other of x and y) and
  // nt1 = hw slab positions, each direction or side; z, nt0 along x and
  // nt1 along y
  unsigned nt0, nt1;
  int vec;  // x and y: rows copied in 16-byte words
};

struct Slabs {
  Slab s[MAX_SLABS];
  unsigned first[MAX_SLABS];  // each slab's first tile; NO_TILE past the last slab
  unsigned D0, D1, D2, M;     // blocks along each dim; members
  long long payload;          // cells of a member's row
};

struct alignas(16) Word16 {
  unsigned long long lo, hi;
};

// A thread block's tile, from blockIdx once: its slab k, its buffer row
// (block b, coordinates c0, c1, c2; member m) and its index among that
// slab's tiles of the row. A slab's tiles are row-major.
struct TileOf {
  unsigned k, row, b, m, c0, c1, c2, idx;
};

template <int DIM>
__device__ __forceinline__ TileOf tile_of(const Slabs& d) {
  TileOf t;
  t.k = 0;
#pragma unroll
  for (int i = 1; i < MAX_SLABS; ++i) t.k += blockIdx.x >= d.first[i];
  const Slab& s = d.s[t.k];
  const unsigned per = (DIM == 2 ? 1u : 2u) * s.nt0 * s.nt1, local = blockIdx.x - d.first[t.k];
  t.row = local / per;
  t.idx = local - t.row * per;
  t.b = t.row / d.M;
  t.m = t.row - t.b * d.M;
  t.c2 = t.b % d.D2;
  const unsigned r = t.b / d.D2;
  t.c1 = r % d.D1;
  t.c0 = r / d.D1;
  return t;
}

// Offset in the stacked field of the first cell of row (i0, i1) (local) of
// the tile's block.
__device__ __forceinline__ long long row_offset(const Slab& s, const Slabs& d, const TileOf& t,
                                                unsigned i0, unsigned i1) {
  const long long S1 = (long long)d.D1 * s.n1, S2 = (long long)d.D2 * s.n2;
  return ((long long)(t.c0 * s.n0 + i0) * S1 + (t.c1 * s.n1 + i1)) * S2 +
         (long long)t.c2 * s.n2;
}

// K7: the block whose buffer feeds side `side` of the tile's block along
// DIM (disp before it for the left halo, after it for the right; wrapped
// when periodic); false on a PROC_NULL edge.
template <int DIM>
__device__ __forceinline__ bool source_block(const Slabs& d, const TileOf& t, int side,
                                             int periodic, int disp, unsigned& bs) {
  const long long D = DIM == 0 ? d.D0 : (DIM == 1 ? d.D1 : d.D2);
  long long c = (long long)(DIM == 0 ? t.c0 : (DIM == 1 ? t.c1 : t.c2)) + (side ? disp : -disp);
  if (periodic) {
    c %= D;
    if (c < 0) c += D;
  } else if (c < 0 || c >= D) {
    return false;
  }
  const unsigned c0 = DIM == 0 ? (unsigned)c : t.c0, c1 = DIM == 1 ? (unsigned)c : t.c1,
                 c2 = DIM == 2 ? (unsigned)c : t.c2;
  bs = (c0 * d.D1 + c1) * d.D2 + c2;
  return true;
}

// An x or y tile: slab position h along DIM, TILE_WARPS rows along u (a
// warp a row: this thread's u), direction (K8) or side (K7) dir.
struct RowTile {
  unsigned h, u, dir;
};

__device__ __forceinline__ RowTile row_tile(const Slab& s, unsigned idx) {
  RowTile r;
  const unsigned q = idx / s.nt0;
  r.u = (idx - q * s.nt0) * TILE_WARPS + (threadIdx.x >> 5);
  r.dir = q / s.hw;
  r.h = q - r.dir * s.hw;
  return r;
}

// The offset of an x or y tile's row in a block's buffer.
template <int DIM>
__device__ __forceinline__ long long row_buffer(const Slab& s, const RowTile& r) {
  return s.base + (DIM == 0 ? (long long)r.h * s.st0 + (long long)r.u * s.st1
                            : (long long)r.u * s.st0 + (long long)r.h * s.st1);
}

// One warp copies a row of n cells (contiguous on both sides), in 16-byte
// words where `vec`.
template <typename E>
__device__ __forceinline__ void copy_row(E* __restrict__ dst, const E* __restrict__ src,
                                         unsigned n, int vec) {
  const unsigned lane = threadIdx.x & 31;
  if (vec) {
    const unsigned nw = n / (16 / sizeof(E));
    for (unsigned i = lane; i < nw; i += 32)
      reinterpret_cast<Word16*>(dst)[i] = reinterpret_cast<const Word16*>(src)[i];
  } else {
    for (unsigned i = lane; i < n; i += 32) dst[i] = src[i];
  }
}

// A z tile: TILE_WARPS planes along x (a warp each) x 32 rows along y (a
// lane each); this thread's row (x0, x1).
__device__ __forceinline__ void z_row(const Slab& s, unsigned idx, unsigned& x0, unsigned& x1) {
  const unsigned tx = idx / s.nt1;
  x0 = tx * TILE_WARPS + (threadIdx.x >> 5);
  x1 = (idx - tx * s.nt1) * 32 + (threadIdx.x & 31);
}

template <int DIM, typename E>
__global__ void __launch_bounds__(THREADS)
wire_pack_kernel(const __grid_constant__ Slabs d, E* __restrict__ buf_r, E* __restrict__ buf_l) {
  const TileOf t = tile_of<DIM>(d);
  const Slab& s = d.s[t.k];
  const E* __restrict__ a = static_cast<const E*>(s.a) + t.m * s.mstride;
  const long long blk = (long long)t.row * d.payload;
  if constexpr (DIM == 2) {
    unsigned x0, x1;
    z_row(s, t.idx, x0, x1);
    if (x0 >= s.n0 || x1 >= s.n1) return;
    const E* row = a + row_offset(s, d, t, x0, x1);
    const long long o = blk + s.base + (long long)x0 * s.st0 + (long long)x1 * s.st1;
    for (unsigned h = 0; h < s.hw; ++h) {  // both directions of the row
      const E r = row[s.start[0] + h], l = row[s.start[1] + h];
      buf_r[o + h * s.st2] = r;
      buf_l[o + h * s.st2] = l;
    }
  } else {
    const RowTile r = row_tile(s, t.idx);
    if (r.u >= (DIM == 0 ? s.n1 : s.n0)) return;
    const unsigned p = s.start[r.dir] + r.h;
    copy_row((r.dir ? buf_l : buf_r) + blk + row_buffer<DIM>(s, r),
             a + row_offset(s, d, t, DIM == 0 ? p : r.u, DIM == 0 ? r.u : p), s.n2, s.vec);
  }
}

template <int DIM, typename E>
__global__ void __launch_bounds__(THREADS)
halo_write_multi_kernel(const __grid_constant__ Slabs d, const E* __restrict__ buf_r,
                        const E* __restrict__ buf_l, int periodic, int disp) {
  const TileOf t = tile_of<DIM>(d);
  const Slab& s = d.s[t.k];
  E* __restrict__ a = static_cast<E*>(s.a) + t.m * s.mstride;
  if constexpr (DIM == 2) {
    unsigned bl = 0, br = 0;
    const bool left = source_block<DIM>(d, t, 0, periodic, disp, bl),
               right = source_block<DIM>(d, t, 1, periodic, disp, br);
    unsigned x0, x1;
    z_row(s, t.idx, x0, x1);
    if ((!left && !right) || x0 >= s.n0 || x1 >= s.n1) return;
    E* row = a + row_offset(s, d, t, x0, x1);
    const long long o = s.base + (long long)x0 * s.st0 + (long long)x1 * s.st1;
    const E* sl = buf_r + ((long long)bl * d.M + t.m) * d.payload + o;
    const E* sr = buf_l + ((long long)br * d.M + t.m) * d.payload + o;
    for (unsigned h = 0; h < s.hw; ++h) {  // both sides of the row
      if (left) row[s.start[0] + h] = sl[h * s.st2];
      if (right) row[s.start[1] + h] = sr[h * s.st2];
    }
  } else {
    const RowTile r = row_tile(s, t.idx);
    unsigned bs;
    if (!source_block<DIM>(d, t, r.dir, periodic, disp, bs)) return;  // the tile's side
    if (r.u >= (DIM == 0 ? s.n1 : s.n0)) return;
    const unsigned p = s.start[r.dir] + r.h;
    copy_row(a + row_offset(s, d, t, DIM == 0 ? p : r.u, DIM == 0 ? r.u : p),
             (r.dir ? buf_l : buf_r) + ((long long)bs * d.M + t.m) * d.payload +
                 row_buffer<DIM>(s, r),
             s.n2,
             s.vec);
  }
}

// K2. A field is seen as (outer, L, inner) about the dim written (blocks of
// n along L, D = L / n). For every outer index o, halo plane l of the field
// (l = c * n + h or c * n + n - hw + h) and plane s = c * hw + h of its slab
// are `inner` cells, contiguous at (o * L + l) * inner in the field and at
// (o * D * hw + s) * inner in the slab.
struct HaloWrite {
  // rows (inner > 1): row u of slab plane s at s * bs + u * bu in the slab
  // and at l * aL + u * au in the field, R cells (a plane's last to
  // `cells`); lanes (inner == 1): row u of the field at u * au, of the slab
  // at u * bu, `rows` of them
  long long aL, au, bs, bu, cells, rows;
  unsigned R, nt, n, hw, P;  // nt: tiles of a slab plane; P = D * hw slab planes a side
  int vec;                   // rows copied in 16-byte words
};

constexpr long long ROW_BYTES = 1024;  // a warp's row where a plane is one contiguous run

// Rows: a thread block is a tile of TILE_WARPS rows (a warp a row) of one
// slab plane and side, found from blockIdx once. Lanes: a thread a row, both
// halos of every block of the row.
template <bool LANES, typename E>
__global__ void __launch_bounds__(THREADS)
halo_write_kernel(const __grid_constant__ HaloWrite p, E* __restrict__ a,
                  const E* __restrict__ sl, const E* __restrict__ sr) {
  if constexpr (LANES) {
    const long long u = (long long)blockIdx.x * THREADS + threadIdx.x;
    if (u >= p.rows) return;
    E* row = a + u * p.au;
    const E* l = sl + u * p.bu;
    const E* r = sr + u * p.bu;
    for (unsigned k = 0, s = 0; s < p.P; k += p.n, s += p.hw)
      for (unsigned h = 0; h < p.hw; ++h) {
        row[k + h] = l[s + h];
        row[k + p.n - p.hw + h] = r[s + h];
      }
  } else {
    const unsigned q = blockIdx.x / p.nt;  // the tile's side and slab plane
    const unsigned side = q >= p.P, s = q - side * p.P, c = s / p.hw, h = s - c * p.hw;
    const long long u = (long long)(blockIdx.x - q * p.nt) * TILE_WARPS + (threadIdx.x >> 5),
                    first = u * p.R;
    if (first >= p.cells) return;
    const long long l = (long long)c * p.n + (side ? p.n - p.hw : 0) + h,
                    left = p.cells - first;
    copy_row(a + l * p.aL + u * p.au, (side ? sr : sl) + s * p.bs + u * p.bu,
             (unsigned)(left < p.R ? left : p.R), p.vec);
  }
}

// K6's plan: three parts of tiles, in launch order z, x, y.
struct Combined {
  long long S1, S2;
  unsigned n0, n1, n2, D0, D1, D2, hwx;
  unsigned i0, i1, j0, j1;  // local rows outside the x and y halos: [i0, i1) x [j0, j1)
  unsigned first[3];        // the parts' first tiles
  // z: tiles a block along x (TILE_WARPS planes) and y (32 rows); x: row
  // tiles of a block's y extent; y: row tiles of its x extent [i0, i1)
  unsigned zt0, zt1, xt, yt;
  int vec;  // x and y rows copied in 16-byte words
};

// K6: a thread block is a tile of one part in one block of the stack, found
// from blockIdx once. z: TILE_WARPS x planes by 32 y rows outside the x and
// y halos, a thread a row (threads along y) writing its two lanes of every
// block; x: TILE_WARPS rows of one received plane along y in one block, a
// warp a row, which takes ry where it is a y-halo row; y: TILE_WARPS rows of
// one side along x in one block, inside [i0, i1) only.
template <typename E>
__global__ void __launch_bounds__(THREADS)
halo_write_combined_kernel(const __grid_constant__ Combined p, E* __restrict__ a,
                           const E* __restrict__ xl, const E* __restrict__ xr,
                           const E* __restrict__ yl, const E* __restrict__ yr,
                           const E* __restrict__ zl, const E* __restrict__ zr) {
  const unsigned b = blockIdx.x, warp = threadIdx.x >> 5;
  if (b < p.first[1]) {
    const unsigned per = p.zt0 * p.zt1, blk = b / per, t = b - blk * per;
    const unsigned c0 = blk / p.D1, c1 = blk - c0 * p.D1, tx = t / p.zt1, ty = t - tx * p.zt1;
    const unsigned i = p.i0 + tx * TILE_WARPS + warp, j = p.j0 + ty * 32 + (threadIdx.x & 31);
    if (i >= p.i1 || j >= p.j1) return;
    const long long r = (long long)(c0 * p.n0 + i) * p.S1 + (c1 * p.n1 + j);
    E* row = a + r * p.S2;
    const E* l = zl + r * p.D2;
    const E* rr = zr + r * p.D2;
    for (unsigned c2 = 0, k = 0; c2 < p.D2; ++c2, k += p.n2) {
      row[k] = l[c2];
      row[k + p.n2 - 1] = rr[c2];
    }
  } else if (b < p.first[2]) {
    const unsigned per = p.D1 * p.xt, q = (b - p.first[1]) / per, t = b - p.first[1] - q * per;
    const unsigned c1 = t / p.xt, j = (t - c1 * p.xt) * TILE_WARPS + warp;
    if (j >= p.n1) return;
    const unsigned P = p.D0 * p.hwx, side = q >= P, s = q - side * P, c0 = s / p.hwx,
                   h = s - c0 * p.hwx;
    const unsigned I = c0 * p.n0 + (side ? p.n0 - p.hwx : 0) + h, J = c1 * p.n1 + j;
    const E* src = yl != nullptr && (j == 0 || j == p.n1 - 1)
                       ? (j == 0 ? yl : yr) + ((long long)I * p.D1 + c1) * p.S2
                       : (side ? xr : xl) + ((long long)s * p.S1 + J) * p.S2;
    copy_row(a + ((long long)I * p.S1 + J) * p.S2, src, (unsigned)p.S2, p.vec);
  } else {
    const unsigned per = p.D0 * p.yt, q = (b - p.first[2]) / per, t = b - p.first[2] - q * per;
    const unsigned side = q >= p.D1, c1 = q - side * p.D1, c0 = t / p.yt;
    const unsigned i = p.i0 + (t - c0 * p.yt) * TILE_WARPS + warp;
    if (i >= p.i1) return;
    const unsigned I = c0 * p.n0 + i, J = c1 * p.n1 + (side ? p.n1 - 1 : 0);
    copy_row(a + ((long long)I * p.S1 + J) * p.S2,
             (side ? yr : yl) + ((long long)I * p.D1 + c1) * p.S2, (unsigned)p.S2, p.vec);
  }
}

long long cdiv_ll(long long a, long long b) { return (a + b - 1) / b; }

bool item_size(int e) { return e == 1 || e == 2 || e == 4 || e == 8; }

bool aligned16(std::initializer_list<const void*> ps) {
  for (const void* q : ps)
    if (reinterpret_cast<uintptr_t>(q) & 15) return false;
  return true;
}

// K2's plan of one launch (0 tiles where a bound is exceeded).
long long plan_halo_write(int e, const void* a, const void* sl, const void* sr,
                          const long long S[3], int dim, long long n, long long hw,
                          HaloWrite& p) {
  long long outer = 1, inner = 1;
  for (int i = 0; i < dim; ++i) outer *= S[i];
  for (int i = dim + 1; i < 3; ++i) inner *= S[i];
  const long long L = S[dim], P = L / n * hw;
  if (L >= (1LL << 31) || inner >= (1LL << 31)) return 0;
  p = HaloWrite{};
  p.n = (unsigned)n, p.hw = (unsigned)hw, p.P = (unsigned)P;
  if (inner == 1) {
    p.au = L, p.bu = P, p.rows = outer;
    return cdiv_ll(outer, THREADS);
  }
  p.aL = p.bs = inner;
  if (outer == 1) {  // a plane is one run: rows of ROW_BYTES
    p.R = (unsigned)(ROW_BYTES / e), p.au = p.bu = p.R, p.cells = inner;
  } else {  // a row of inner cells an outer index
    p.R = (unsigned)inner, p.au = L * inner, p.bu = P * inner, p.cells = outer * inner;
  }
  const long long nt = cdiv_ll(cdiv_ll(p.cells, p.R), TILE_WARPS);
  p.nt = (unsigned)nt;
  p.vec = (inner * e) % 16 == 0 && aligned16({a, sl, sr});
  return 2 * P * nt;
}

template <typename E>
void halo_write_launch(const HaloWrite& p, long long tiles, void* a, const void* sl,
                       const void* sr, cudaStream_t st) {
  E* d = static_cast<E*>(a);
  const E* l = static_cast<const E*>(sl);
  const E* r = static_cast<const E*>(sr);
  if (p.rows)
    halo_write_kernel<true, E><<<(unsigned)tiles, THREADS, 0, st>>>(p, d, l, r);
  else
    halo_write_kernel<false, E><<<(unsigned)tiles, THREADS, 0, st>>>(p, d, l, r);
}

template <typename E>
void combined_launch(const Combined& p, long long tiles, void* a, const void* xl, const void* xr,
                     const void* yl, const void* yr, const void* zl, const void* zr,
                     cudaStream_t st) {
  halo_write_combined_kernel<E><<<(unsigned)tiles, THREADS, 0, st>>>(
      p, static_cast<E*>(a), static_cast<const E*>(xl), static_cast<const E*>(xr),
      static_cast<const E*>(yl), static_cast<const E*>(yr), static_cast<const E*>(zl),
      static_cast<const E*>(zr));
}

// K6's plan of one launch (its tiles; 0 where there are none).
long long plan_combined(int e, const void* a, const void* xl, const void* yl, const void* zl,
                        const void* xr, const void* yr, long long S0, long long S1,
                        long long S2, long long n0, long long n1, long long n2, long long hwx,
                        Combined& p) {
  const bool x = xl != nullptr, y = yl != nullptr, z = zl != nullptr;
  p = Combined{};
  p.S1 = S1, p.S2 = S2;
  p.n0 = (unsigned)n0, p.n1 = (unsigned)n1, p.n2 = (unsigned)n2, p.hwx = (unsigned)hwx;
  p.D0 = (unsigned)(S0 / n0), p.D1 = (unsigned)(S1 / n1), p.D2 = (unsigned)(S2 / n2);
  p.i0 = x ? p.hwx : 0, p.i1 = x ? p.n0 - p.hwx : p.n0;
  p.j0 = y ? 1 : 0, p.j1 = y ? p.n1 - 1 : p.n1;
  p.zt0 = (unsigned)cdiv_ll(p.i1 - p.i0, TILE_WARPS), p.zt1 = (unsigned)cdiv_ll(p.j1 - p.j0, 32);
  p.xt = (unsigned)cdiv_ll(n1, TILE_WARPS), p.yt = p.zt0;
  const long long D0 = p.D0, D1 = p.D1;
  const long long tz = z ? D0 * D1 * p.zt0 * p.zt1 : 0, tx = x ? 2 * D0 * hwx * D1 * p.xt : 0,
                  ty = y ? 2 * D1 * D0 * p.yt : 0;
  if (tz + tx + ty >= (1LL << 31)) return 0;
  p.first[0] = 0, p.first[1] = (unsigned)tz, p.first[2] = (unsigned)(tz + tx);
  p.vec = (S2 * e) % 16 == 0 && aligned16({a}) && (!x || aligned16({xl, xr})) &&
          (!y || aligned16({yl, yr}));
  return tz + tx + ty;
}

// The kernel slabs of a planned host descriptor, each slab's first tile and
// the tiles of the launch (0 where the descriptor is not one; a slab's
// 16-byte copies off where a pointer is not 16-byte aligned).
unsigned read_plan(const long long* desc, int nslabs, int dim, long long D0, long long D1,
                   long long D2, long long payload, const void* b0, const void* b1, Slabs& d) {
  if (nslabs < 1 || nslabs > MAX_SLABS || dim < 0 || dim > 2 || D0 < 1 || D1 < 1 || D2 < 1 ||
      payload < 1)
    return 0;
  d.D0 = (unsigned)D0, d.D1 = (unsigned)D1, d.D2 = (unsigned)D2;
  d.M = (unsigned)desc[14];
  d.payload = payload;
  long long total = 0;
  for (int k = 0; k < MAX_SLABS; ++k) {
    d.first[k] = k < nslabs ? (unsigned)total : NO_TILE;
    if (k >= nslabs) continue;
    const long long* p = desc + k * SLAB_DESC;
    Slab& s = d.s[k];
    s.a = reinterpret_cast<void*>(p[0]);
    s.n0 = (unsigned)p[1], s.n1 = (unsigned)p[2], s.n2 = (unsigned)p[3], s.hw = (unsigned)p[4];
    s.start[0] = (unsigned)p[5], s.start[1] = (unsigned)p[6];
    s.base = p[7];
    s.st0 = (unsigned)p[8], s.st1 = (unsigned)p[9], s.st2 = (unsigned)p[10];
    s.nt0 = (unsigned)p[11], s.nt1 = (unsigned)p[12];
    s.vec = p[13] && aligned16({b0, b1, s.a});
    s.mstride = p[15];
    if (s.nt0 < 1 || s.nt1 < 1 || p[14] != d.M || d.M < 1) return 0;  // not planned
    total += (dim == 2 ? 1 : 2) * (long long)s.nt0 * s.nt1 * D0 * D1 * D2 * d.M;
    if (total >= (1LL << 31)) return 0;
  }
  return (unsigned)total;
}

template <typename E>
void wire_pack_launch(int dim, const Slabs& d, unsigned tiles, void* buf_r, void* buf_l,
                      cudaStream_t st) {
  E* r = static_cast<E*>(buf_r);
  E* l = static_cast<E*>(buf_l);
  switch (dim) {
    case 0: wire_pack_kernel<0, E><<<tiles, THREADS, 0, st>>>(d, r, l); break;
    case 1: wire_pack_kernel<1, E><<<tiles, THREADS, 0, st>>>(d, r, l); break;
    default: wire_pack_kernel<2, E><<<tiles, THREADS, 0, st>>>(d, r, l); break;
  }
}

template <typename E>
void halo_write_multi_launch(int dim, const Slabs& d, unsigned tiles, const void* buf_r,
                             const void* buf_l, int periodic, int disp, cudaStream_t st) {
  const E* r = static_cast<const E*>(buf_r);
  const E* l = static_cast<const E*>(buf_l);
  switch (dim) {
    case 0: halo_write_multi_kernel<0, E><<<tiles, THREADS, 0, st>>>(d, r, l, periodic, disp); break;
    case 1: halo_write_multi_kernel<1, E><<<tiles, THREADS, 0, st>>>(d, r, l, periodic, disp); break;
    default: halo_write_multi_kernel<2, E><<<tiles, THREADS, 0, st>>>(d, r, l, periodic, disp); break;
  }
}

}  // namespace

// a: stacked (S0, S1, S2), contiguous, block length n along dim; sl/sr:
// contiguous slabs of a's shape with extent (S_dim / n) * hw along dim.
extern "C" int igg_halo_write(int itemsize, void* a, const void* sl, const void* sr,
                              long long S0, long long S1, long long S2, int dim,
                              long long n, long long hw, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dim < 0 || dim > 2 || n < 1 || hw < 1 || !item_size(itemsize))
    return (int)cudaErrorInvalidValue;
  const long long S[3] = {S0, S1, S2};
  HaloWrite p;
  const long long tiles = plan_halo_write(itemsize, a, sl, sr, S, dim, n, hw, p);
  if (tiles < 1 || tiles >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  switch (itemsize) {
    case 1: halo_write_launch<uint8_t>(p, tiles, a, sl, sr, st); break;
    case 2: halo_write_launch<uint16_t>(p, tiles, a, sl, sr, st); break;
    case 4: halo_write_launch<uint32_t>(p, tiles, a, sl, sr, st); break;
    case 8: halo_write_launch<unsigned long long>(p, tiles, a, sl, sr, st); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// a, out: stacked (S0, S1, S2), contiguous, blocks (n0, n1, n2); m*: which
// dims take the self-neighbour exchange, ol*: their overlaps.
extern "C" int igg_halo_self_exchange(int itemsize, const void* a, void* out,
                                      long long S0, long long S1, long long S2,
                                      long long n0, long long n1, long long n2, int m0,
                                      int m1, int m2, long long ol0, long long ol1,
                                      long long ol2, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (S0 >= (1LL << 31) || S2 >= (1LL << 31) || (S1 + YCHUNK - 1) / YCHUNK > 65535)
    return (int)cudaErrorInvalidValue;  // 32-bit indices, grid.y limit
  switch (itemsize) {
    case 1: self_exchange<uint8_t>(a, out, S0, S1, S2, n0, n1, n2, m0, m1, m2, ol0, ol1, ol2, st); break;
    case 2: self_exchange<uint16_t>(a, out, S0, S1, S2, n0, n1, n2, m0, m1, m2, ol0, ol1, ol2, st); break;
    case 4: self_exchange<uint32_t>(a, out, S0, S1, S2, n0, n1, n2, m0, m1, m2, ol0, ol1, ol2, st); break;
    case 8: self_exchange<unsigned long long>(a, out, S0, S1, S2, n0, n1, n2, m0, m1, m2, ol0, ol1, ol2, st); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// K6. a: stacked (S0, S1, S2), contiguous, blocks (n0, n1, n2), in place.
// xl/xr: received x planes (width hwx), yl/yr: y rows, zl/zr: z lanes (width
// 1), each in K2's slab layout; null for a dim that takes none.
extern "C" int igg_halo_write_combined(int itemsize, void* a, const void* xl, const void* xr,
                                       const void* yl, const void* yr, const void* zl,
                                       const void* zr, long long S0, long long S1,
                                       long long S2, long long n0, long long n1,
                                       long long n2, long long hwx, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n0 < 1 || n1 < 1 || n2 < 1 || hwx < 1 || (xl != nullptr && n0 < 2 * hwx) ||
      (yl != nullptr && n1 < 2) || (zl != nullptr && n2 < 2))
    return (int)cudaErrorInvalidValue;  // each dim's halos disjoint
  // 32-bit indices: each part's cell count below 2^31
  const long long most = std::max(std::max((S0 / n0) * 2 * hwx * S1 * S2, S0 * 2 * (S1 / n1) * S2),
                                  S0 * S1 * 2 * (S2 / n2));
  if (most >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  Combined p;
  const long long tiles = plan_combined(itemsize, a, xl, yl, zl, xr, yr, S0, S1, S2, n0, n1, n2,
                                        hwx, p);
  if (tiles < 1) return (int)cudaErrorInvalidValue;
  switch (itemsize) {
    case 1: combined_launch<uint8_t>(p, tiles, a, xl, xr, yl, yr, zl, zr, st); break;
    case 2: combined_launch<uint16_t>(p, tiles, a, xl, xr, yl, yr, zl, zr, st); break;
    case 4: combined_launch<uint32_t>(p, tiles, a, xl, xr, yl, yr, zl, zr, st); break;
    case 8: combined_launch<unsigned long long>(p, tiles, a, xl, xr, yl, yr, zl, zr, st); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// K7 and K8's plan, once a group signature: checks each of the nslabs host
// descriptors (SLAB_DESC long longs a slab: pointer, n0, n1, n2, hw,
// start0, start1, base, st0, st1, st2, the plan nt0, nt1, vec, then the
// member count M, one for every slab, and the member stride) of a group
// along dim (the fields stacked, D0 x D1 x D2 blocks each, M members
// apart; a member's row of the buffer holds payload cells of itemsize
// bytes) and fills in the plan: the slab's tiles a block along its two
// tiled axes (nt0, nt1) and whether its rows copy in 16-byte words (x and
// y: every span a multiple of 16 bytes).
extern "C" int igg_coalesced_plan(int itemsize, int nslabs, long long* desc, long long D0,
                                  long long D1, long long D2, long long payload, int dim) {
  if (nslabs < 1 || nslabs > MAX_SLABS || dim < 0 || dim > 2 || D0 < 1 || D1 < 1 || D2 < 1 ||
      payload < 1 || !item_size(itemsize))
    return (int)cudaErrorInvalidValue;
  const long long D[3] = {D0, D1, D2}, e = itemsize;
  long long total = 0;
  for (int k = 0; k < nslabs; ++k) {
    long long* p = desc + k * SLAB_DESC;
    const long long n[3] = {p[1], p[2], p[3]}, hw = p[4], base = p[7],
                    st[3] = {p[8], p[9], p[10]}, M = p[14], mstride = p[15];
    long long w[3] = {n[0], n[1], n[2]};
    w[dim] = hw;
    // x and y: rows contiguous in the buffer (a 2-D field's rows are a cell)
    bool ok = hw >= 1 && base >= 0 && (dim == 2 || st[2] == 1 || n[2] == 1);
    for (int a = 0; a < 3; ++a)  // 32-bit stacked extents and strides
      ok = ok && n[a] >= 1 && D[a] * n[a] < (1LL << 31) && st[a] >= 0 && st[a] < (1LL << 32);
    for (int j = 5; j < 7; ++j) ok = ok && p[j] >= 0 && p[j] + hw <= n[dim];
    // the slab's last cell lies in the buffer
    ok = ok && base + (w[0] - 1) * st[0] + (w[1] - 1) * st[1] + (w[2] - 1) * st[2] < payload;
    // one member count for the group; members of a field do not overlap
    ok = ok && M >= 1 && M == desc[14] && M < (1LL << 20) &&
         (M == 1 || mstride >= D[0] * n[0] * D[1] * n[1] * D[2] * n[2]);
    if (!ok) return (int)cudaErrorInvalidValue;
    p[11] = dim == 2 ? cdiv_ll(n[0], TILE_WARPS) : cdiv_ll(n[1 - dim], TILE_WARPS);
    p[12] = dim == 2 ? cdiv_ll(n[1], 32) : hw;
    p[13] = dim < 2 && (n[2] * e) % 16 == 0 && (base * e) % 16 == 0 && (st[0] * e) % 16 == 0 &&
            (st[1] * e) % 16 == 0 && (payload * e) % 16 == 0 && (mstride * e) % 16 == 0;
    total += (dim == 2 ? 1 : 2) * p[11] * p[12] * D0 * D1 * D2 * M;
    if (total >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  }
  return 0;
}

// K8. desc: nslabs descriptors planned by igg_coalesced_plan (the pointers
// filled in); buf_r/buf_l: (D0*D1*D2*M, payload) contiguous, the buffers of
// the right and the left send slabs, a row a block and member.
extern "C" int igg_wire_pack(int itemsize, int nslabs, const long long* desc, void* buf_r,
                             void* buf_l, long long D0, long long D1, long long D2,
                             long long payload, int dim, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  Slabs d{};
  const unsigned tiles = read_plan(desc, nslabs, dim, D0, D1, D2, payload, buf_r, buf_l, d);
  if (tiles == 0) return (int)cudaErrorInvalidValue;
  switch (itemsize) {
    case 1: wire_pack_launch<uint8_t>(dim, d, tiles, buf_r, buf_l, st); break;
    case 2: wire_pack_launch<uint16_t>(dim, d, tiles, buf_r, buf_l, st); break;
    case 4: wire_pack_launch<uint32_t>(dim, d, tiles, buf_r, buf_l, st); break;
    case 8: wire_pack_launch<unsigned long long>(dim, d, tiles, buf_r, buf_l, st); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// K7. As K8, with the descriptors' starts the halos' ([0, hw) and [n-hw, n));
// writes the fields' halos in place from the buffers of the neighbour blocks
// along dim (disp apart; periodic wraps, else the edge keeps its halo).
extern "C" int igg_halo_write_multi(int itemsize, int nslabs, const long long* desc,
                                    const void* buf_r, const void* buf_l, long long D0,
                                    long long D1, long long D2, long long payload, int dim,
                                    int periodic, long long disp, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (disp < 0 || disp >= (1LL << 30)) return (int)cudaErrorInvalidValue;
  Slabs d{};
  const unsigned tiles = read_plan(desc, nslabs, dim, D0, D1, D2, payload, buf_r, buf_l, d);
  if (tiles == 0) return (int)cudaErrorInvalidValue;
  const int p = periodic != 0, s = (int)disp;
  switch (itemsize) {
    case 1: halo_write_multi_launch<uint8_t>(dim, d, tiles, buf_r, buf_l, p, s, st); break;
    case 2: halo_write_multi_launch<uint16_t>(dim, d, tiles, buf_r, buf_l, p, s, st); break;
    case 4: halo_write_multi_launch<uint32_t>(dim, d, tiles, buf_r, buf_l, p, s, st); break;
    case 8: halo_write_multi_launch<unsigned long long>(dim, d, tiles, buf_r, buf_l, p, s, st); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
