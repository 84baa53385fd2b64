// ELL gather-sum with the pad correction for Hopper (sm_90a), one launch
// for every table of one dependency level of the degree-binned layout:
//   out[out_row + i, c] = (sum_{k<W} buf[tbl[i, k], c]) - padcnt[i] * buf[0, c]
// for each table (int32 tbl [N, W] whose pad slots point at row 0, an
// optional f32 padcnt [N] = the number of pad slots per row) over one f32
// buf [R, d].
//
// Replaces the TPU kernel experiments/pallas_blocked_spmm.py:kernel
// (launched by blocked_gather_sum, :106), which DMAd every gathered row
// into double-buffered VMEM tiles of 128 table rows.  It is the body of
// gnnpe_tpu/ops/ell.py:BinnedEll._gather_sum, so here it carries every
// table of the layout (gnnpe_tpu_torch/ops/ell.py): the forward of
// fit(aggregation="binned") and, because the adjacency is symmetric, its
// backward too.
//
// Bound: bytes.  Each table and padcnt read once, buf read once, out
// written once: 4 * (slots + padded rows + 2 * V * d) bytes per apply, on
// the dblp rung's layout (3,076,584 slots, 317,080 vertices) about 18.6 MB
// at the trainer's d = 2 and about 338 MB at d = 128, against 3.35 TB/s.
// What the kernel gathers is slots * d * 4 bytes (24.6 MB and 1.58 GB), so
// at d = 128, where buf (162 MB) exceeds the 50 MB L2, the share of
// re-reads that hit L2 decides how near the bound it comes.  At d = 2 each
// of the 3.08 M gathered 8-byte rows is a cache line of its own to the
// load unit, which no byte count sees: see gather_rows.cuh.
//
// Design (the device loop is csrc/gather_rows.cuh):
//  * One launch per dependency level, not per table.  Every width class
//    and the first head level read the same buf, so they share a launch:
//    the level's table descriptors come by value in the kernel's
//    parameters, each with its first work unit, and a warp finds its table
//    by a scan of at most kMaxTables entries.  A unit is one warp's run of
//    consecutive rows of one table; width is fixed per table and a warp
//    never straddles tables, so there is no divergence.  Where a row has
//    fewer than 32 lanes the wrapper has the units dealt round-robin over
//    the blocks (`deal`), so every SM gets the same mix of wide and narrow
//    tables: a block of 256 rows of the width-64 table would otherwise
//    keep its SM's load unit busy 16 times as long as a block of the
//    width-4 table.  With a warp per row the blocks take consecutive
//    units: dealing them measured slower there.
//  * A group of G lanes per table row, each lane owning one pack of up to
//    16 bytes of the row's columns; rows wider than 32 packs loop over
//    column tiles.  The group reads the row's indices once, coalesced, and
//    hands them round with __shfl_sync; a lane with a row to itself (the
//    trainer's d = 2) reads them four at a time as 16-byte loads.
//  * The loads of 4 gathered rows are issued before the first is added
//    (8 and 16 measured no faster, and slower at 128 columns, where their
//    registers cost resident warps).  Hopper's TMA has no row gather, and
//    plain vector loads into registers keep as many bytes in flight per
//    lane as a cp.async ring would without the shared-memory round trip.
//  * The adds run in ascending slot order from 0.0f; the correction is
//    __fmul_rn then __fsub_rn, which nvcc never contracts into an FMA, so
//    the result is bit-equal to ops/ell.py:gather_sum_plain (a multiply,
//    then a subtract).
//
// C ABI for ctypes: pointers and the stream are void*; the level is passed
// by pointer and copied into the kernel's parameters; the return value is
// cudaGetLastError() after the launch (0 = launched), or
// cudaErrorInvalidValue for a (vec, lanes) pair that has no kernel.

#include <cuda_runtime.h>

#include "gather_rows.cuh"

namespace {

constexpr int kMaxTables = 16;
constexpr int kThreads = 256;

struct EllTable {
  const int* tbl;        // [rows, width]
  const float* padcnt;   // [rows] or null
  long long out_row;     // first output row, counted from `out`
  long long rows;
  int width;
  int first_unit;        // the table's first work unit of the launch
};

struct EllLevel {
  int n;
  int units;             // work units of all n tables
  int deal;              // units go round-robin over the blocks
  EllTable t[kMaxTables];
};

template <int VEC, int G>
__global__ void __launch_bounds__(kThreads)
ell_gather_sum_kernel(const EllLevel lv, const float* __restrict__ buf,
                      float* __restrict__ out, int d) {
  using namespace gather_rows;
  // Dealt round-robin, warp w of block b takes unit w * gridDim.x + b;
  // else the block's warps take consecutive units.
  const int w = threadIdx.x >> 5;
  const int unit = lv.deal ? w * (int)gridDim.x + (int)blockIdx.x
                           : (int)blockIdx.x * (kThreads / 32) + w;
  if (unit >= lv.units) return;  // the whole warp
  // The warp's table: the last whose first unit is not after this one.
  // Unrolled with constant subscripts, so the descriptors stay in the
  // parameter bank and no thread copies the array.
  EllTable t = lv.t[0];
#pragma unroll
  for (int i = 1; i < kMaxTables; ++i) {
    if (i < lv.n && unit >= lv.t[i].first_unit) t = lv.t[i];
  }
  constexpr int kRowsPerWarp = 32 / G;
  // A group past the table's last row stays for the shuffles, with no
  // slots to add and nothing to store.
  long long r = (long long)(unit - t.first_unit) * kRowsPerWarp
                + (threadIdx.x & 31) / G;
  const bool row_ok = r < t.rows;
  if (G == 32 && !row_ok) return;  // a whole warp
  if (!row_ok) r = 0;
  const bool idx16 = G == 1 && (t.width & 3) == 0
                     && (reinterpret_cast<unsigned long long>(t.tbl) & 15) == 0;
  const int g = threadIdx.x % G;
  const int* row = t.tbl + r * t.width;
  float* dst = out + (t.out_row + r) * d;
  for (int c0 = 0; c0 < d; c0 += G * VEC) {
    const int c = c0 + g * VEC;
    const bool col_ok = c < d;
    Pack<float, VEC> acc = zero_pack<float, VEC>();
    gather_add<float, VEC, G>(acc, row, row_ok ? t.width : 0, t.width, buf,
                              d, c, col_ok, g, idx16);
    if (row_ok && col_ok) {
      if (t.padcnt != nullptr) {
        const float p = __ldg(t.padcnt + r);
        const Pack<float, VEC> x0 = load_pack<float, VEC>(buf + c);
#pragma unroll
        for (int i = 0; i < VEC; ++i) {
          acc.e[i] = __fsub_rn(acc.e[i], __fmul_rn(p, x0.e[i]));
        }
      }
      store_pack<float, VEC>(dst + c, acc);
    }
  }
}

template <int VEC>
int launch_vec(int lanes, const EllLevel& lv, const float* buf, float* out,
               int d, unsigned blocks, cudaStream_t stream) {
#define GNNPE_ELL_CASE(G)                                                  \
  case G:                                                                  \
    ell_gather_sum_kernel<VEC, G><<<blocks, kThreads, 0, stream>>>(lv, buf, \
                                                                   out, d); \
    break;
  switch (lanes) {
    GNNPE_ELL_CASE(1)
    GNNPE_ELL_CASE(2)
    GNNPE_ELL_CASE(4)
    GNNPE_ELL_CASE(8)
    GNNPE_ELL_CASE(16)
    GNNPE_ELL_CASE(32)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef GNNPE_ELL_CASE
  return (int)cudaGetLastError();
}

}  // namespace

// One launch for the tables of `level` (an EllLevel whose first_unit
// entries were laid out for 32 / lanes rows per unit; `blocks` is its
// units over the kThreads / 32 warps of a block, rounded up).  vec is the
// columns per lane (4, 2 or 1: d and the byte alignment of buf and out
// must be multiples of it), lanes the lanes per table row (a power of two
// up to 32).
extern "C" int gnnpe_ell_gather_sum_level_f32(int device, const void* level,
                                              const void* buf, void* out,
                                              int d, int vec, int lanes,
                                              int blocks, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const EllLevel& lv = *(const EllLevel*)level;
  if (lv.n < 1 || lv.n > kMaxTables || blocks < 1
      || (long long)blocks * (kThreads / 32) < lv.units) {
    return (int)cudaErrorInvalidValue;
  }
  const float* b = (const float*)buf;
  float* o = (float*)out;
  cudaStream_t s = (cudaStream_t)stream;
  switch (vec) {
    case 4: return launch_vec<4>(lanes, lv, b, o, d, (unsigned)blocks, s);
    case 2: return launch_vec<2>(lanes, lv, b, o, d, (unsigned)blocks, s);
    case 1: return launch_vec<1>(lanes, lv, b, o, d, (unsigned)blocks, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" int gnnpe_ell_max_tables() { return kMaxTables; }
extern "C" int gnnpe_ell_threads() { return kThreads; }
