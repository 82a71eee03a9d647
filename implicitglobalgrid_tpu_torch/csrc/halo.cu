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
// dominated by its fixed cost. Design: one thread per halo element, a 2-D
// launch so that no 64-bit division runs per element (they cost tens of
// instructions each); slab reads are contiguous; halo writes are contiguous
// for dims 0 and 1 and strided for dim 2.
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
// against ~320 us for a full pass.
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
// per-field halowidth. Bound: read and write every slab cell once, 2 x cells
// x itemsize (~9 MB and ~3 us per dim for P, Vx, Vy, Vz on a 2x2x2 stack of
// 192^3 float32 blocks), so a launch is dominated by its fixed cost. Design:
// one thread per slab cell, threads along the slab's contiguous axis (the
// field's z), grid.y = (slab, direction or side); 32-bit index arithmetic,
// 64-bit offsets.
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int THREADS = 256;
constexpr unsigned MAX_GRID_YZ = 65535;

unsigned clamp_grid(long long n) {
  return (unsigned)(n < 1 ? 1 : (n < MAX_GRID_YZ ? n : MAX_GRID_YZ));
}

// One thread per element of a slab plane (p1, p2), flattened in 32 bits;
// grid.y walks the (p0, side) pairs. The slab has shape (P0, P1, P2).
template <typename E>
__global__ void halo_write_kernel(E* __restrict__ a, const E* __restrict__ sl,
                                  const E* __restrict__ sr, long long S1, long long S2,
                                  int dim, long long n, unsigned hw, long long P0,
                                  unsigned P1, unsigned P2) {
  const unsigned q = blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= P1 * P2) return;
  unsigned p1 = q / P2, p2 = q - p1 * P2;
  for (long long z = blockIdx.y; z < 2 * P0; z += gridDim.y) {
    const bool right = z & 1;
    long long p0 = z >> 1;
    const long long src = (p0 * P1 + p1) * (long long)P2 + p2;
    long long d0 = p0, d1 = p1, d2 = p2;
    long long& pd = dim == 0 ? d0 : (dim == 1 ? d1 : d2);
    const long long c = (unsigned)pd / hw, r = pd - c * hw;  // pd < 2^31
    pd = c * n + (right ? n - hw + r : r);
    a[(d0 * S1 + d1) * S2 + d2] = right ? sr[src] : sl[src];
  }
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
void halo_write(void* a, const void* sl, const void* sr, long long S0, long long S1,
                long long S2, int dim, long long n, long long hw, cudaStream_t st) {
  long long P[3] = {S0, S1, S2};
  P[dim] = (P[dim] / n) * hw;
  const long long plane = P[1] * P[2];
  dim3 grid((unsigned)((plane + THREADS - 1) / THREADS), clamp_grid(2 * P[0]));
  halo_write_kernel<E><<<grid, THREADS, 0, st>>>(
      static_cast<E*>(a), static_cast<const E*>(sl), static_cast<const E*>(sr), S1,
      S2, dim, n, (unsigned)hw, P[0], (unsigned)P[1], (unsigned)P[2]);
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

// K6: every halo cell of every block written once, in three parts (grid.y):
// 0 the x-halo planes (a y-halo row in them takes ry, else rx), 1 the y-halo
// rows outside the x halos, 2 the z-halo lanes outside both. That is the
// reference's z, x, y write order read as a per-cell rule. Parts 0 and 1 run
// threads along z (coalesced); part 2 writes one lane cell per thread. Index
// arithmetic is 32-bit (the entry point checks the extents): a first version
// that decomposed 64-bit indices took 100 us at 2x2x2 x 256^3 float32.
template <typename E>
__global__ void __launch_bounds__(THREADS)
halo_write_combined_kernel(E* __restrict__ a, const E* __restrict__ xl,
                           const E* __restrict__ xr, const E* __restrict__ yl,
                           const E* __restrict__ yr, const E* __restrict__ zl,
                           const E* __restrict__ zr, unsigned S0, unsigned S1, unsigned S2,
                           unsigned n0, unsigned n1, unsigned n2, unsigned hwx) {
  const int part = blockIdx.y;
  const unsigned D0 = S0 / n0, D1 = S1 / n1, D2 = S2 / n2;
  unsigned total;
  if (part == 0) {
    if (xl == nullptr) return;
    total = D0 * 2 * hwx * S1 * S2;
  } else if (part == 1) {
    if (yl == nullptr) return;
    total = S0 * 2 * D1 * S2;
  } else {
    if (zl == nullptr) return;
    total = S0 * S1 * 2 * D2;
  }
  for (unsigned q = blockIdx.x * blockDim.x + threadIdx.x; q < total;
       q += gridDim.x * blockDim.x) {
    unsigned I, J, K;
    if (part == 2) {
      const unsigned zc = q % (2 * D2), rest = q / (2 * D2);
      J = rest % S1;
      I = rest / S1;
      const unsigned i = I % n0, j = J % n1;
      if (xl != nullptr && (i < hwx || i >= n0 - hwx)) continue;
      if (yl != nullptr && (j == 0 || j == n1 - 1)) continue;
      const unsigned ck = zc >> 1;
      K = ck * n2 + ((zc & 1) ? n2 - 1 : 0);
      const long long row = (long long)I * S1 + J;
      a[row * S2 + K] = ((zc & 1) ? zr : zl)[row * D2 + ck];
      continue;
    }
    K = q % S2;
    const unsigned rest = q / S2;
    if (part == 1) {
      const unsigned yc = rest % (2 * D1);
      I = rest / (2 * D1);
      const unsigned i = I % n0;
      if (xl != nullptr && (i < hwx || i >= n0 - hwx)) continue;
      const unsigned cj = yc >> 1;
      J = cj * n1 + ((yc & 1) ? n1 - 1 : 0);
      a[((long long)I * S1 + J) * S2 + K] =
          ((yc & 1) ? yr : yl)[((long long)I * D1 + cj) * S2 + K];
      continue;
    }
    J = rest % S1;
    const unsigned pl = rest / S1, c0 = pl / (2 * hwx), h = pl - c0 * 2 * hwx;
    const bool right = h >= hwx;
    const unsigned r = right ? h - hwx : h;
    I = c0 * n0 + (right ? n0 - hwx + r : r);
    const unsigned cj = J / n1, j = J - cj * n1;
    E v;
    if (yl != nullptr && (j == 0 || j == n1 - 1))
      v = (j == 0 ? yl : yr)[((long long)I * D1 + cj) * S2 + K];
    else
      v = (right ? xr : xl)[((long long)(c0 * hwx + r) * S1 + J) * S2 + K];
    a[((long long)I * S1 + J) * S2 + K] = v;
  }
}

template <typename E>
void halo_write_combined(void* a, const void* xl, const void* xr, const void* yl,
                         const void* yr, const void* zl, const void* zr, long long S0,
                         long long S1, long long S2, long long n0, long long n1,
                         long long n2, long long hwx, long long most, cudaStream_t st) {
  long long blocks = (most + THREADS - 1) / THREADS;
  if (blocks > (1LL << 20)) blocks = 1LL << 20;  // grid-stride beyond
  halo_write_combined_kernel<E><<<dim3((unsigned)blocks, 3u), THREADS, 0, st>>>(
      static_cast<E*>(a), static_cast<const E*>(xl), static_cast<const E*>(xr),
      static_cast<const E*>(yl), static_cast<const E*>(yr), static_cast<const E*>(zl),
      static_cast<const E*>(zr), (unsigned)S0, (unsigned)S1, (unsigned)S2, (unsigned)n0,
      (unsigned)n1, (unsigned)n2, (unsigned)hwx);
}

// K7 and K8: one slab of a coalesced group. The field is stacked, D0 x D1 x
// D2 blocks of (n0, n1, n2); the slab is (w0, w1, w2) = the block with the
// exchange dim cut to hw, at local start start[0] (K8: the right send slab;
// K7: the left halo) or start[1] (K8: the left send slab; K7: the right
// halo). Element a of the slab sits at base + a . st in its block's buffer.
constexpr int MAX_SLABS = 16;
constexpr int SLAB_DESC = 11;  // long longs a slab in the host descriptor

struct Slab {
  void* a;
  unsigned n0, n1, n2, w0, w1, w2, cells;
  unsigned start[2];
  unsigned st0, st1, st2;
  long long base;
};

struct Slabs {
  Slab s[MAX_SLABS];
};

// One cell of a slab over all blocks: cell q (32-bit) -> block b, its
// coordinates (c0, c1, c2) and the slab index (x0, x1, x2). Scalars, not
// arrays indexed by dim: such arrays live in a stack frame.
struct Cell {
  unsigned b, c0, c1, c2, x0, x1, x2;
};

__device__ __forceinline__ Cell slab_cell(const Slab& s, unsigned q, unsigned D1,
                                          unsigned D2) {
  Cell e;
  e.b = q / s.cells;
  const unsigned r = q - e.b * s.cells;
  e.x2 = r % s.w2;
  const unsigned t = r / s.w2;
  e.x1 = t % s.w1;
  e.x0 = t / s.w1;
  e.c2 = e.b % D2;
  const unsigned t2 = e.b / D2;
  e.c1 = t2 % D1;
  e.c0 = t2 / D1;
  return e;
}

// Offset of the cell in its block's buffer.
__device__ __forceinline__ long long buffer_offset(const Slab& s, const Cell& e) {
  return s.base + (long long)e.x0 * s.st0 + (long long)e.x1 * s.st1 +
         (long long)e.x2 * s.st2;
}

// Offset in the stacked field of the cell of block (c0, c1, c2) at local
// (i0, i1, i2).
__device__ __forceinline__ long long field_offset(const Slab& s, unsigned c0, unsigned c1,
                                                  unsigned c2, unsigned i0, unsigned i1,
                                                  unsigned i2, unsigned D1, unsigned D2) {
  const long long S1 = (long long)D1 * s.n1, S2 = (long long)D2 * s.n2;
  return ((long long)c0 * s.n0 + i0) * S1 * S2 + ((long long)c1 * s.n1 + i1) * S2 +
         (long long)c2 * s.n2 + i2;
}

// The slab index shifted by `start` along dim, as a field-local index.
__device__ __forceinline__ long long shifted_offset(const Slab& s, const Cell& e, int dim,
                                                    unsigned start, unsigned D1,
                                                    unsigned D2) {
  return field_offset(s, e.c0, e.c1, e.c2, e.x0 + (dim == 0 ? start : 0u),
                      e.x1 + (dim == 1 ? start : 0u), e.x2 + (dim == 2 ? start : 0u), D1,
                      D2);
}

// grid.y = 2 * slab + direction: 0 packs the right send slabs into buf_r, 1
// the left send slabs into buf_l.
template <typename E>
__global__ void __launch_bounds__(THREADS)
wire_pack_kernel(Slabs d, E* __restrict__ buf_r, E* __restrict__ buf_l, unsigned D0,
                 unsigned D1, unsigned D2, long long payload, int dim) {
  const Slab s = d.s[blockIdx.y >> 1];
  const int dir = blockIdx.y & 1;
  E* __restrict__ buf = dir ? buf_l : buf_r;
  const E* __restrict__ a = static_cast<const E*>(s.a);
  const unsigned start = dir ? s.start[1] : s.start[0];
  const unsigned total = D0 * D1 * D2 * s.cells;
  for (unsigned q = blockIdx.x * blockDim.x + threadIdx.x; q < total;
       q += gridDim.x * blockDim.x) {
    const Cell e = slab_cell(s, q, D1, D2);
    buf[e.b * payload + buffer_offset(s, e)] = a[shifted_offset(s, e, dim, start, D1, D2)];
  }
}

// grid.y = 2 * slab + side: 0 writes the left halo from buf_r of block
// t - disp, 1 the right halo from buf_l of block t + disp (along dim).
template <typename E>
__global__ void __launch_bounds__(THREADS)
halo_write_multi_kernel(Slabs d, const E* __restrict__ buf_r, const E* __restrict__ buf_l,
                        unsigned D0, unsigned D1, unsigned D2, long long payload, int dim,
                        int periodic, int disp) {
  const Slab s = d.s[blockIdx.y >> 1];
  const int side = blockIdx.y & 1;
  const E* __restrict__ buf = side ? buf_l : buf_r;
  E* a = static_cast<E*>(s.a);
  const unsigned start = side ? s.start[1] : s.start[0];
  const unsigned total = D0 * D1 * D2 * s.cells;
  const int Dd = (int)(dim == 0 ? D0 : (dim == 1 ? D1 : D2));
  for (unsigned q = blockIdx.x * blockDim.x + threadIdx.x; q < total;
       q += gridDim.x * blockDim.x) {
    const Cell e = slab_cell(s, q, D1, D2);
    const unsigned cd = dim == 0 ? e.c0 : (dim == 1 ? e.c1 : e.c2);
    int sc = (int)cd + (side ? disp : -disp);
    if (periodic) {
      sc %= Dd;
      if (sc < 0) sc += Dd;
    } else if (sc < 0 || sc >= Dd) {
      continue;  // PROC_NULL: the block keeps its halo
    }
    const long long bs = ((long long)(dim == 0 ? (unsigned)sc : e.c0) * D1 +
                          (dim == 1 ? (unsigned)sc : e.c1)) * D2 +
                         (dim == 2 ? (unsigned)sc : e.c2);
    a[shifted_offset(s, e, dim, start, D1, D2)] = buf[bs * payload + buffer_offset(s, e)];
  }
}

// The host descriptor (SLAB_DESC long longs a slab: pointer, n0, n1, n2, hw,
// start0, start1, base, st0, st1, st2) -> kernel slabs; the largest slab's
// cell count over all blocks, or -1 where a count leaves 32 bits.
long long read_slabs(const long long* desc, int nslabs, int dim, long long nblocks,
                     Slabs& d) {
  long long most = 0;
  for (int k = 0; k < nslabs; ++k) {
    const long long* p = desc + k * SLAB_DESC;
    Slab& s = d.s[k];
    s.a = reinterpret_cast<void*>(p[0]);
    s.n0 = (unsigned)p[1];
    s.n1 = (unsigned)p[2];
    s.n2 = (unsigned)p[3];
    long long w[3] = {p[1], p[2], p[3]};
    w[dim] = p[4];
    s.w0 = (unsigned)w[0];
    s.w1 = (unsigned)w[1];
    s.w2 = (unsigned)w[2];
    const long long cells = w[0] * w[1] * w[2];
    s.cells = (unsigned)cells;
    s.start[0] = (unsigned)p[5];
    s.start[1] = (unsigned)p[6];
    s.base = p[7];
    s.st0 = (unsigned)p[8];
    s.st1 = (unsigned)p[9];
    s.st2 = (unsigned)p[10];
    if (cells < 1 || cells * nblocks >= (1LL << 31)) return -1;
    most = std::max(most, cells * nblocks);
  }
  return most;
}

unsigned grid_x(long long most) {
  long long blocks = (most + THREADS - 1) / THREADS;
  if (blocks > (1LL << 20)) blocks = 1LL << 20;  // grid-stride beyond
  return (unsigned)blocks;
}

}  // namespace

// a: stacked (S0, S1, S2), contiguous, block length n along dim; sl/sr:
// contiguous slabs of a's shape with extent (S_dim / n) * hw along dim.
extern "C" int igg_halo_write(int itemsize, void* a, const void* sl, const void* sr,
                              long long S0, long long S1, long long S2, int dim,
                              long long n, long long hw, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dim < 0 || dim > 2 || n < 1 || hw < 1) return (int)cudaErrorInvalidValue;
  long long P[3] = {S0, S1, S2};
  P[dim] = (P[dim] / n) * hw;
  if (P[1] * P[2] >= (1LL << 31)) return (int)cudaErrorInvalidValue;  // 32-bit plane index
  switch (itemsize) {
    case 1: halo_write<uint8_t>(a, sl, sr, S0, S1, S2, dim, n, hw, st); break;
    case 2: halo_write<uint16_t>(a, sl, sr, S0, S1, S2, dim, n, hw, st); break;
    case 4: halo_write<uint32_t>(a, sl, sr, S0, S1, S2, dim, n, hw, st); break;
    case 8: halo_write<unsigned long long>(a, sl, sr, S0, S1, S2, dim, n, hw, st); break;
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
  if (n0 < 1 || n1 < 1 || n2 < 1 || hwx < 1) return (int)cudaErrorInvalidValue;
  // 32-bit indices: each part's cell count below 2^31
  const long long most = std::max(std::max((S0 / n0) * 2 * hwx * S1 * S2, S0 * 2 * (S1 / n1) * S2),
                                  S0 * S1 * 2 * (S2 / n2));
  if (most >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  switch (itemsize) {
    case 1: halo_write_combined<uint8_t>(a, xl, xr, yl, yr, zl, zr, S0, S1, S2, n0, n1, n2, hwx, most, st); break;
    case 2: halo_write_combined<uint16_t>(a, xl, xr, yl, yr, zl, zr, S0, S1, S2, n0, n1, n2, hwx, most, st); break;
    case 4: halo_write_combined<uint32_t>(a, xl, xr, yl, yr, zl, zr, S0, S1, S2, n0, n1, n2, hwx, most, st); break;
    case 8: halo_write_combined<unsigned long long>(a, xl, xr, yl, yr, zl, zr, S0, S1, S2, n0, n1, n2, hwx, most, st); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// K8. desc: nslabs descriptors (see read_slabs); the fields are stacked, D0 x
// D1 x D2 blocks each; buf_r/buf_l: (D0*D1*D2, payload) contiguous, the
// buffers of the right and the left send slabs.
extern "C" int igg_wire_pack(int itemsize, int nslabs, const long long* desc, void* buf_r,
                             void* buf_l, long long D0, long long D1, long long D2,
                             long long payload, int dim, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (nslabs < 1 || nslabs > MAX_SLABS || dim < 0 || dim > 2 || D0 < 1 || D1 < 1 || D2 < 1)
    return (int)cudaErrorInvalidValue;
  Slabs d{};
  const long long most = read_slabs(desc, nslabs, dim, D0 * D1 * D2, d);
  if (most < 0) return (int)cudaErrorInvalidValue;
  const dim3 grid(grid_x(most), 2u * (unsigned)nslabs);
#define IGG_PACK(E)                                                                     \
  wire_pack_kernel<E><<<grid, THREADS, 0, st>>>(d, static_cast<E*>(buf_r),              \
                                                static_cast<E*>(buf_l), (unsigned)D0,   \
                                                (unsigned)D1, (unsigned)D2, payload, dim)
  switch (itemsize) {
    case 1: IGG_PACK(uint8_t); break;
    case 2: IGG_PACK(uint16_t); break;
    case 4: IGG_PACK(uint32_t); break;
    case 8: IGG_PACK(unsigned long long); break;
    default: return (int)cudaErrorInvalidValue;
  }
#undef IGG_PACK
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
  if (nslabs < 1 || nslabs > MAX_SLABS || dim < 0 || dim > 2 || D0 < 1 || D1 < 1 ||
      D2 < 1 || disp < 0 || disp >= (1LL << 30))
    return (int)cudaErrorInvalidValue;
  Slabs d{};
  const long long most = read_slabs(desc, nslabs, dim, D0 * D1 * D2, d);
  if (most < 0) return (int)cudaErrorInvalidValue;
  const dim3 grid(grid_x(most), 2u * (unsigned)nslabs);
#define IGG_UNPACK(E)                                                                    \
  halo_write_multi_kernel<E><<<grid, THREADS, 0, st>>>(                                  \
      d, static_cast<const E*>(buf_r), static_cast<const E*>(buf_l), (unsigned)D0,       \
      (unsigned)D1, (unsigned)D2, payload, dim, periodic, (int)disp)
  switch (itemsize) {
    case 1: IGG_UNPACK(uint8_t); break;
    case 2: IGG_UNPACK(uint16_t); break;
    case 4: IGG_UNPACK(uint32_t); break;
    case 8: IGG_UNPACK(unsigned long long); break;
    default: return (int)cudaErrorInvalidValue;
  }
#undef IGG_UNPACK
  return (int)cudaGetLastError();
}
