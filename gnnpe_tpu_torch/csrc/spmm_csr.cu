// CSR neighbour-sum SpMM for Hopper (sm_90a):  nx[v] = sum_{u in N(v)} x[u],
// optionally vde[v] = x[v] + nx[v] in the same pass, for float and double.
//
// Replaces the TPU kernel experiments/pallas_spmm.py:_spmm_kernel (launched
// by spmm_pallas_prepared, :181), which tiled 256 output rows in VMEM and
// fetched every x[src] row with its own DMA.  Here it is the VDE hop of the
// exact online query (gnnpe_tpu_torch/embed/vde.py), run on the data graph
// and on every query graph, and the aggregation="segment" trainer's forward
// and backward.
//
// Bound: bytes.  offsets and neighbors read once, x read once, nx written
// once: 4 * (V + 1 + E) + 2 * V * d * sizeof(T).  At the dblp rung
// (317,080 vertices, 2,099,732 arcs) that is 19.8 MB in f64 at the VDE's
// d = 2 and 334 MB in f32 at d = 128, against 3.35 TB/s.  What the kernel
// gathers is E * d * sizeof(T) bytes (33.6 MB and 1.08 GB); at d = 128 x
// (162 MB) exceeds the 50 MB L2, so the share of re-reads that hit L2
// decides how near the bound it comes.
//
// Design (the device loop is csrc/gather_rows.cuh).  Bit-exactness decides
// the arithmetic: the host reference (ops/spmm.py:neighbor_sum_np) adds
// strictly left to right, in ascending neighbour order, from 0.0, so each
// output element has one accumulator that takes its row's terms in order;
// no tree, no shuffle sum, no atomic, and an add-only loop leaves nothing
// to contract into an FMA.  Around that:
//  * a group of G lanes per row, each lane owning one pack of up to 16
//    bytes of the columns; rows wider than 32 packs loop over column
//    tiles.  The wrapper gives a row at least two lanes where it can: at
//    the VDE's d = 2 two lanes of one double each measured 24 us against
//    31 us for one lane of a double2 (more warps to hide latency with);
//  * the group reads its row's neighbour ids once, coalesced, and hands
//    them round with __shfl_sync; 4 gathered rows are requested before the
//    first is added;
//  * the degree tail.  A power-law graph has rows of hundreds of
//    neighbours beside rows of three, and graphs often come with the
//    heavy rows together (the dblp rung's are its first ids): a block of
//    256 consecutive rows then keeps one SM's load unit busy while the
//    rest of the card has finished.  So a warp takes 32 / G consecutive
//    rows (similar degrees: little divergence), and the wrapper has these
//    units dealt round-robin over the blocks (`deal`) unless a row takes a
//    whole warp, where dealing measured slower.  A warp still runs as long
//    as its longest row, and its lanes' loads are 32 cache lines apiece to
//    the load unit, so rows longer than `long_rows` are left out of the
//    first pass and queued in shared memory; then every warp of the block
//    takes queued rows in turn, a whole warp to a row: its 32 / G lane
//    groups each request one neighbour's row, four rounds deep (128 / G
//    rows in flight, the ids read coalesced), park them in shared memory,
//    and the first group adds them in neighbour order.  The threshold is
//    an argument: the wrapper names it, and a negative value turns the
//    pass off;
//  * a small graph gets one small block: the wrapper sizes the block to
//    the rows, and nothing above costs a graph of 8 vertices anything.
//
// C ABI for ctypes: pointers and the stream are void*; the return value is
// cudaGetLastError() after the launch (0 = launched), or
// cudaErrorInvalidValue for a (vec, lanes) pair that has no kernel.

#include <cuda_runtime.h>

#include "gather_rows.cuh"

namespace {

constexpr int kMaxThreads = 256;
constexpr int kLongRounds = 4;  // rounds of 32 / G rows staged per step

// nx (and vde) of row r from its finished sum.
template <typename T, int VEC>
__device__ __forceinline__ void store_row(const gather_rows::Pack<T, VEC>& acc,
                                          const T* __restrict__ x,
                                          T* __restrict__ nx,
                                          T* __restrict__ vde, long long at) {
  using namespace gather_rows;
  store_pack<T, VEC>(nx + at, acc);
  if (vde != nullptr) {
    Pack<T, VEC> self = load_pack<T, VEC>(x + at);
#pragma unroll
    for (int i = 0; i < VEC; ++i) self.e[i] = self.e[i] + acc.e[i];
    store_pack<T, VEC>(vde + at, self);
  }
}

template <typename T, int VEC, int G>
__global__ void __launch_bounds__(kMaxThreads)
spmm_csr_kernel(const int* __restrict__ offsets,
                const int* __restrict__ neighbors, const T* __restrict__ x,
                T* __restrict__ nx, T* __restrict__ vde, long long n_rows,
                int d, int long_rows, int deal) {
  using namespace gather_rows;
  constexpr int kRowsPerWarp = 32 / G;
  constexpr int kStage = 32 * kLongRounds;  // packs staged per warp
  __shared__ Pack<T, VEC> stage[G < 32 ? kMaxThreads / 32 * kStage : 1];
  __shared__ int queue[G < 32 ? kMaxThreads / G : 1];  // the long rows
  __shared__ int queued;
  if (G < 32) {
    if (threadIdx.x == 0) queued = 0;
    __syncthreads();
  }

  // A warp takes 32 / G consecutive rows (a unit).  Dealt, warp w of
  // block b takes unit w * gridDim.x + b; else the block's warps take
  // consecutive units.
  const int w = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long unit = deal ? (long long)w * gridDim.x + blockIdx.x
                              : (long long)blockIdx.x * (blockDim.x >> 5) + w;
  const long long r = unit * kRowsPerWarp + lane / G;
  const int g = lane % G;
  const bool row_ok = r < n_rows;
  const int lo = row_ok ? __ldg(offsets + r) : 0;
  const int hi = row_ok ? __ldg(offsets + r + 1) : 0;
  const bool is_long = G < 32 && long_rows >= 0 && hi - lo > long_rows;
  const int count = is_long ? 0 : hi - lo;
  const int warp_count = __reduce_max_sync(0xffffffffu, count);
  if (is_long && g == 0) queue[atomicAdd(&queued, 1)] = (int)r;

  for (int c0 = 0; c0 < d; c0 += G * VEC) {  // one turn unless G == 32
    const int c = c0 + g * VEC;
    const bool col_ok = c < d;
    Pack<T, VEC> acc = zero_pack<T, VEC>();
    gather_add<T, VEC, G>(acc, neighbors + lo, count, warp_count, x, d, c,
                          col_ok, g);
    if (row_ok && col_ok && !is_long) {
      store_row<T, VEC>(acc, x, nx, vde, r * d + c);
    }
  }

  if constexpr (G < 32) {
    // The block's long rows, in the order they were queued (which changes
    // no sum), each by a whole warp: lane group `sub` requests the row of
    // neighbour j0 + u * kNb + sub, group 0 adds the staged rows in order.
    __syncthreads();
    constexpr int kNb = 32 / G;  // neighbours requested per round
    const int sub = lane / G;
    const int c = g * VEC;
    const bool col_ok = c < d;
    Pack<T, VEC>* mine = stage + w * kStage;
    for (int q = w; q < queued; q += blockDim.x >> 5) {
      const long long row = queue[q];
      const int llo = __ldg(offsets + row);
      const int lhi = __ldg(offsets + row + 1);
      Pack<T, VEC> acc = zero_pack<T, VEC>();
      for (int j0 = llo; j0 < lhi; j0 += kNb * kLongRounds) {
        Pack<T, VEC> v[kLongRounds];
#pragma unroll
        for (int u = 0; u < kLongRounds; ++u) {
          const int j = j0 + u * kNb + sub;
          if (col_ok && j < lhi) {
            v[u] = load_pack<T, VEC>(
                x + (long long)__ldg(neighbors + j) * d + c);
          }
        }
#pragma unroll
        for (int u = 0; u < kLongRounds; ++u) {
          if (col_ok && j0 + u * kNb + sub < lhi) {
            mine[(u * kNb + sub) * G + g] = v[u];
          }
        }
        __syncwarp();
        if (sub == 0 && col_ok) {
          const int n = min(kNb * kLongRounds, lhi - j0);
          for (int t = 0; t < n; ++t) add_pack(acc, mine[t * G + g]);
        }
        __syncwarp();
      }
      if (sub == 0 && col_ok) store_row<T, VEC>(acc, x, nx, vde, row * d + c);
    }
  }
}

template <typename T, int VEC>
int launch_vec(int lanes, const int* offsets, const int* neighbors,
               const T* x, T* nx, T* vde, long long n_rows, int d,
               int long_rows, int deal, cudaStream_t stream) {
  // One block of just enough warps for a small graph, else full blocks.
  const long long lanes_needed = n_rows * lanes;
  const int threads = lanes_needed >= kMaxThreads
                          ? kMaxThreads
                          : (int)((lanes_needed + 31) / 32 * 32);
  const long long rows_per_block = threads / lanes;
  const unsigned blocks =
      (unsigned)((n_rows + rows_per_block - 1) / rows_per_block);
#define GNNPE_SPMM_CASE(G)                                              \
  case G:                                                               \
    spmm_csr_kernel<T, VEC, G><<<blocks, threads, 0, stream>>>(         \
        offsets, neighbors, x, nx, vde, n_rows, d, long_rows, deal);    \
    break;
  switch (lanes) {
    GNNPE_SPMM_CASE(1)
    GNNPE_SPMM_CASE(2)
    GNNPE_SPMM_CASE(4)
    GNNPE_SPMM_CASE(8)
    GNNPE_SPMM_CASE(16)
    GNNPE_SPMM_CASE(32)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef GNNPE_SPMM_CASE
  return (int)cudaGetLastError();
}

template <typename T>
int launch(int device, const void* offsets, const void* neighbors,
           const void* x, void* nx, void* vde, long long n_rows, int d,
           int vec, int lanes, int long_rows, int deal, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n_rows < 1 || d < 1) return (int)cudaErrorInvalidValue;
  const int* off = (const int*)offsets;
  const int* nbr = (const int*)neighbors;
  cudaStream_t s = (cudaStream_t)stream;
  if (vec * sizeof(T) > 16) return (int)cudaErrorInvalidValue;
  switch (vec) {
    case 4:
      if constexpr (sizeof(T) == 4) {
        return launch_vec<T, 4>(lanes, off, nbr, (const T*)x, (T*)nx,
                                (T*)vde, n_rows, d, long_rows, deal, s);
      }
      return (int)cudaErrorInvalidValue;
    case 2:
      return launch_vec<T, 2>(lanes, off, nbr, (const T*)x, (T*)nx, (T*)vde,
                              n_rows, d, long_rows, deal, s);
    case 1:
      return launch_vec<T, 1>(lanes, off, nbr, (const T*)x, (T*)nx, (T*)vde,
                              n_rows, d, long_rows, deal, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// vec is the columns per lane (vec * sizeof(T) <= 16; d and the byte
// alignment of x, nx and vde must be multiples of it), lanes the lanes per
// row (a power of two up to 32), long_rows the degree above which a row
// goes to the whole warp (negative: never), deal whether rows go
// round-robin over the blocks.
extern "C" int gnnpe_spmm_csr_f64(int device, const void* offsets,
                                  const void* neighbors, const void* x,
                                  void* nx, void* vde, long long n_rows,
                                  int d, int vec, int lanes, int long_rows,
                                  int deal, void* stream) {
  return launch<double>(device, offsets, neighbors, x, nx, vde, n_rows, d,
                        vec, lanes, long_rows, deal, stream);
}

extern "C" int gnnpe_spmm_csr_f32(int device, const void* offsets,
                                  const void* neighbors, const void* x,
                                  void* nx, void* vde, long long n_rows,
                                  int d, int vec, int lanes, int long_rows,
                                  int deal, void* stream) {
  return launch<float>(device, offsets, neighbors, x, nx, vde, n_rows, d,
                       vec, lanes, long_rows, deal, stream);
}
