// K2 and K3: the halo copy kernels of update_halo on the virtual mesh.
//
// Both are pure copies of elements of any dtype (moved as 1, 2, 4 or 8-byte
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
#include <cuda_runtime.h>
#include <stdint.h>

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
