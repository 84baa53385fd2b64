// PE phase 1 for Hopper (sm_90a): every index block's summary tested
// against every query row and the row's signature run, and the surviving
// blocks' ids and gate rows written in block order.
//
// Replaces no TPU kernel.  gnnpe_tpu's phase 1 (gnnpe_tpu/index/
// device_packed.py) is XLA compares with no Pallas kernel.  Done so in
// PyTorch, each chunk of blocks broadcasts three [Q, blocks, W] compares
// (W = L * D), reduces each with .all(-1), and the chunks are joined into
// a dense bool [Q, NB] mask; then come a wait for the phase-1 count, the
// signature runs' compares over [Q, NB], any, nonzero (a second wait) and
// a gather of the survivors' gate rows.  At youtube's 2.29e6 blocks and
// the 96 rows of a 16-query batch that writes and reads several GB.  This
// kernel absorbs the whole chain for the PE table layouts: nothing is
// written but a few bits a block, the survivors' ids and their gate rows.
//
// Bound: bytes.  Each block's summary (f32 ub, llo, lhi [W] and int32
// degrees [L]: 84 B at L = 3, D = 2) is read once from device memory; the
// query rows, read by every thread block, stay in L2; the survivors' ids
// (8 B) and gate rows (Q B) are written once, beside a word of bits a
// block and 32 query rows.  The tests are a few f64 compares a (block,
// row), but a block meets every row until one passes, so at youtube's 96
// rows a batch they weigh as much as the bytes: the summary is widened
// once, and the test that most blocks fail comes first.
//
// Design.
//  * count: one thread an index block, THREADS blocks a tile, a tile a
//    thread block.  A thread reads its block's summary once into registers
//    and widens it to f64 there (HeldSummary: L and D template parameters,
//    1-4 each; the served configurations have L = 3, D = 2); any other
//    shape runs AnySummary, which reads the summary again for each row,
//    from L1 after the first.
//    The query rows (f64 thresholds and label features [W], degrees [L])
//    and each row's signature run [lo, hi) are staged in shared memory,
//    tile_rows rows at a time (a multiple of 32; every row at once at the
//    served shapes).  For each row the thread evaluates the same
//    conjunction as the plain version, in the same f64 arithmetic: label
//    feature inside [(double) llo, (double) lhi] and (double) ub >=
//    threshold at every column, query degree <= block degree at every
//    position, stopping at the first failing column; and lo <= block < hi.
//    A row outside the block's run is not tested once the block has passed
//    the box tests for some row: that row can change neither count nor
//    gate.  Each 32 rows give a word of bits (box tests and run both hold),
//    written to bits[block, word].  A warp's blocks that pass the box
//    tests for any row (phase 1's count) and that survive for any row are
//    counted by two ballots, and the tile's two sums go to its counts.
//  * scan: one thread block scans the tiles' survivor counts into each
//    tile's exclusive offset and sums both counts into counters[0] (phase
//    1) and counters[1] (survived).  The caller reads the two counters,
//    its one wait, and sizes the outputs.
//  * write: the count kernel's tiling again.  A thread finds whether its
//    block survives from its bits, a block scan of the warps' ballots gives
//    its place among the tile's survivors, and it writes the block id at
//    the tile's offset plus that place: ascending, as nonzero gives them.
//    Then the thread block writes the tile's gate rows (bool [n, Q], a row
//    a survivor), neighbouring threads on neighbouring bytes.
//  * Offsets into the summaries, the bits and the outputs are 64-bit.
//
// C ABI for ctypes: pointers and the stream are void*; each entry point
// returns cudaGetLastError() after its launches (0 = launched), or
// cudaErrorInvalidValue for a size it does not take.

#include <cuda_runtime.h>

#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int SCAN_THREADS = 1024;
constexpr unsigned FULL = 0xffffffffu;
// The staged query rows aim for SMEM_BUDGET bytes of shared memory, and
// take up to SMEM_MAX (what a thread block may take without an opt-in)
// where 32 rows need it: summaries of up to 94 columns.
constexpr int SMEM_BUDGET = 32 * 1024;
constexpr int SMEM_MAX = 48 * 1024;

struct Args {
  const float* ub;             // f32 [num_blocks, width * dim]
  const float* llo;            // f32 [num_blocks, width * dim]
  const float* lhi;            // f32 [num_blocks, width * dim]
  const int* deg;              // int32 [num_blocks, width]
  const double* thresh;        // f64 [rows, width * dim]
  const double* label;         // f64 [rows, width * dim]
  const int* q_degrees;        // int32 [rows, width]
  const long long* runs;       // int64 [2, rows]: lo, then hi
  unsigned* bits;              // uint32 [num_blocks, row_words]
  long long* counts;           // int64 [2, tiles]: survivors, box passes
  long long num_blocks;
  int rows, row_words, width, dim, tile_rows;
};

// The query rows of one tile in shared memory.
struct Rows {
  const double* thresh;        // [tile_rows, width * dim]
  const double* label;         // [tile_rows, width * dim]
  const long long* lo;         // [tile_rows]
  const long long* hi;         // [tile_rows]
  const int* deg;              // [tile_rows, width]
};

// Bytes of shared memory one staged query row takes.
int row_bytes(int width, int dim) {
  return 16 * width * dim + 16 + 4 * width;
}

// A block summary read once into registers and widened to f64 there (L
// and D known when compiled): a conversion issues at a quarter of the
// rate of an f64 compare.
template <int L, int D>
struct HeldSummary {
  static constexpr int W = L * D;
  double ub[W], llo[W], lhi[W];
  int deg[L];

  __device__ void load(const Args& a, long long blk) {
#pragma unroll
    for (int w = 0; w < W; ++w) {
      ub[w] = __ldg(a.ub + blk * W + w);
      llo[w] = __ldg(a.llo + blk * W + w);
      lhi[w] = __ldg(a.lhi + blk * W + w);
    }
#pragma unroll
    for (int j = 0; j < L; ++j) deg[j] = __ldg(a.deg + blk * L + j);
  }
  // The box tests against staged row i, in the plain version's f64
  // arithmetic, stopping at the first failing column: the label window
  // first (a block of other labels fails it at once), the upper bound,
  // then the degrees.
  __device__ bool passes(const Args&, const Rows& r, int i) const {
#pragma unroll
    for (int w = 0; w < W; ++w) {
      const double x = r.label[i * W + w];
      if (!(x >= llo[w] && lhi[w] >= x)) return false;
    }
#pragma unroll
    for (int w = 0; w < W; ++w) {
      if (!(ub[w] >= r.thresh[i * W + w])) return false;
    }
#pragma unroll
    for (int j = 0; j < L; ++j) {
      if (!(r.deg[i * L + j] <= deg[j])) return false;
    }
    return true;
  }
};

// A block summary of any width and VDE width (a.width, a.dim): nothing is
// held; each test reads the summary again, from L1 after the first.
struct AnySummary {
  long long blk;

  __device__ void load(const Args&, long long b) { blk = b; }
  __device__ bool passes(const Args& a, const Rows& r, int i) const {
    const int l = a.width, w = a.width * a.dim;
    for (int c = 0; c < w; ++c) {
      const double x = r.label[i * w + c];
      if (!(x >= (double)__ldg(a.llo + blk * w + c) &&
            (double)__ldg(a.lhi + blk * w + c) >= x)) {
        return false;
      }
    }
    for (int c = 0; c < w; ++c) {
      if (!((double)__ldg(a.ub + blk * w + c) >= r.thresh[i * w + c])) {
        return false;
      }
    }
    for (int j = 0; j < l; ++j) {
      if (!(r.deg[i * l + j] <= __ldg(a.deg + blk * l + j))) return false;
    }
    return true;
  }
};

template <class Summary>
__global__ void __launch_bounds__(THREADS) filter_count_kernel(Args a) {
  extern __shared__ double staged[];
  __shared__ int warp_counts[2][WARPS];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int w = a.width * a.dim, tr = a.tile_rows;
  Rows r;
  double* thresh = staged;
  double* label = thresh + (long long)tr * w;
  long long* lo = (long long*)(label + (long long)tr * w);
  long long* hi = lo + tr;
  int* deg = (int*)(hi + tr);
  r.thresh = thresh;
  r.label = label;
  r.lo = lo;
  r.hi = hi;
  r.deg = deg;
  const long long blk = (long long)blockIdx.x * THREADS + threadIdx.x;
  const bool live = blk < a.num_blocks;
  Summary s;
  if (live) s.load(a, blk);
  bool box = false, kept = false;
  for (int q0 = 0; q0 < a.rows; q0 += tr) {
    const int n = min(tr, a.rows - q0);
    __syncthreads();                   // the last tile's rows are read
    for (int i = threadIdx.x; i < n * w; i += THREADS) {
      thresh[i] = a.thresh[(long long)q0 * w + i];
      label[i] = a.label[(long long)q0 * w + i];
    }
    for (int i = threadIdx.x; i < n * a.width; i += THREADS) {
      deg[i] = a.q_degrees[(long long)q0 * a.width + i];
    }
    for (int i = threadIdx.x; i < n; i += THREADS) {
      lo[i] = a.runs[q0 + i];
      hi[i] = a.runs[a.rows + q0 + i];
    }
    __syncthreads();
    if (!live) continue;
    for (int w0 = 0; w0 < n; w0 += 32) {
      unsigned word = 0;
      const int end = min(w0 + 32, n);
      for (int i = w0; i < end; ++i) {
        const bool in_run = lo[i] <= blk && blk < hi[i];
        if (!in_run && box) continue;  // it can change nothing
        if (!s.passes(a, r, i)) continue;
        box = true;
        if (in_run) word |= 1u << (i - w0);
      }
      a.bits[blk * a.row_words + (q0 + w0) / 32] = word;
      kept |= word != 0;
    }
  }
  const unsigned kept_ballot = __ballot_sync(FULL, kept);
  const unsigned box_ballot = __ballot_sync(FULL, box);
  if (lane == 0) {
    warp_counts[0][warp] = __popc(kept_ballot);
    warp_counts[1][warp] = __popc(box_ballot);
  }
  __syncthreads();
  if (threadIdx.x < 2) {
    long long n = 0;
#pragma unroll
    for (int i = 0; i < WARPS; ++i) n += warp_counts[threadIdx.x][i];
    a.counts[(long long)threadIdx.x * gridDim.x + blockIdx.x] = n;
  }
}

// Exclusive prefix of x over the block, in thread order; *total gets the
// block's sum.  Every thread of the block calls it.  scratch: 33 slots.
__device__ long long block_exclusive_scan(long long x, long long* scratch,
                                          long long* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int warps = (blockDim.x + 31) >> 5;
  long long v = x;
  for (int d = 1; d < 32; d <<= 1) {
    const long long y = __shfl_up_sync(FULL, v, d);
    if (lane >= d) v += y;
  }
  if (lane == 31) scratch[warp] = v;
  __syncthreads();
  if (warp == 0) {
    long long t = lane < warps ? scratch[lane] : 0;
    for (int d = 1; d < 32; d <<= 1) {
      const long long y = __shfl_up_sync(FULL, t, d);
      if (lane >= d) t += y;
    }
    scratch[lane] = t;                 // inclusive sums of the warps
  }
  __syncthreads();
  const long long before = (warp ? scratch[warp - 1] : 0) + v - x;
  *total = scratch[warps - 1];
  __syncthreads();                     // scratch is free for the next call
  return before;
}

// One block: offsets[t] = the survivors of the tiles before t; counters
// = (box passes, survivors) summed over the tiles.
__global__ void __launch_bounds__(SCAN_THREADS)
filter_scan_kernel(const long long* __restrict__ counts, long long tiles,
                   long long* __restrict__ offsets,
                   long long* __restrict__ counters) {
  __shared__ long long scratch[33];
  long long carry = 0, box = 0;
  for (long long base = 0; base < tiles; base += SCAN_THREADS) {
    const long long t = base + threadIdx.x;
    long long total;
    const long long at = carry + block_exclusive_scan(
        t < tiles ? counts[t] : 0, scratch, &total);
    if (t < tiles) offsets[t] = at;
    carry += total;
    block_exclusive_scan(t < tiles ? counts[tiles + t] : 0, scratch, &total);
    box += total;
  }
  if (threadIdx.x == 0) {
    counters[0] = box;
    counters[1] = carry;
  }
}

__global__ void __launch_bounds__(THREADS)
filter_write_kernel(const unsigned* __restrict__ bits,
                    const long long* __restrict__ offsets,
                    long long num_blocks, int rows, int row_words,
                    long long* __restrict__ sel,
                    uint8_t* __restrict__ gate) {
  __shared__ int warp_counts[WARPS];
  __shared__ int survivor[THREADS];    // the tile's survivors, in order
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long base = (long long)blockIdx.x * THREADS;
  const long long blk = base + threadIdx.x;
  bool kept = false;
  for (int i = 0; blk < num_blocks && i < row_words; ++i) {
    kept |= bits[blk * row_words + i] != 0u;
  }
  const unsigned ballot = __ballot_sync(FULL, kept);
  if (lane == 0) warp_counts[warp] = __popc(ballot);
  __syncthreads();
  int before = 0, n = 0;
#pragma unroll
  for (int i = 0; i < WARPS; ++i) {
    before += i < warp ? warp_counts[i] : 0;
    n += warp_counts[i];
  }
  const long long off = offsets[blockIdx.x];
  if (kept) {
    const int at = before + __popc(ballot & ((1u << lane) - 1u));
    survivor[at] = threadIdx.x;
    sel[off + at] = blk;
  }
  __syncthreads();
  const long long bytes = (long long)n * rows;
  for (long long i = threadIdx.x; i < bytes; i += THREADS) {
    const int p = (int)(i / rows), q = (int)(i % rows);
    const unsigned word = bits[(base + survivor[p]) * row_words + (q >> 5)];
    gate[off * rows + i] = (uint8_t)((word >> (q & 31)) & 1u);
  }
}

template <class Summary>
int launch_count(const Args& a, long long tiles, int smem, cudaStream_t s) {
  filter_count_kernel<Summary><<<(unsigned)tiles, THREADS, smem, s>>>(a);
  return (int)cudaGetLastError();
}

// Paths of 1-4 vertices with VDEs of 1-4 columns hold their summaries in
// registers; any other shape runs AnySummary.
template <int L>
int launch_dim(const Args& a, long long tiles, int smem, cudaStream_t s) {
  switch (a.dim) {
    case 1: return launch_count<HeldSummary<L, 1>>(a, tiles, smem, s);
    case 2: return launch_count<HeldSummary<L, 2>>(a, tiles, smem, s);
    case 3: return launch_count<HeldSummary<L, 3>>(a, tiles, smem, s);
    case 4: return launch_count<HeldSummary<L, 4>>(a, tiles, smem, s);
    default: return launch_count<AnySummary>(a, tiles, smem, s);
  }
}

}  // namespace

// Index blocks a tile: the counts buffer holds 2 * tiles and the offsets
// buffer tiles, tiles = ceil(num_blocks / this).
extern "C" int gnnpe_block_filter_threads() { return THREADS; }

// count and scan.  ub, llo, lhi: f32 [num_blocks, width * dim]; deg: int32
// [num_blocks, width]; thresh, label: f64 [rows, width * dim]; q_degrees:
// int32 [rows, width]; runs: int64 [2, rows], each row's signature run
// [lo, hi) of block ids; bits: uint32 [num_blocks, ceil(rows / 32)];
// counts: int64 [2 * tiles]; offsets: int64 [tiles]; counters: int64 [2],
// which get (the blocks that pass the box tests for any row, the blocks
// that also lie in that row's run: the survivors).
extern "C" int gnnpe_block_filter_count(
    int device, const void* ub, const void* llo, const void* lhi,
    const void* deg, const void* thresh, const void* label,
    const void* q_degrees, const void* runs, void* bits, void* counts,
    void* offsets, void* counters, long long num_blocks, int rows,
    int width, int dim, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const long long tiles = (num_blocks + THREADS - 1) / THREADS;
  const int per_row = row_bytes(width, dim);
  if (num_blocks < 1 || tiles > 2147483647LL || rows < 1 || width < 1 ||
      dim < 1 || 32 * (long long)per_row > SMEM_MAX) {
    return (int)cudaErrorInvalidValue;
  }
  // As many rows a shared tile as the budget holds, whole words of 32,
  // and no more than the rows.
  int tile_rows = SMEM_BUDGET / per_row / 32 * 32;
  const int all_rows = (rows + 31) / 32 * 32;
  if (tile_rows < 32) tile_rows = 32;
  if (tile_rows > all_rows) tile_rows = all_rows;
  const Args a{(const float*)ub, (const float*)llo, (const float*)lhi,
               (const int*)deg, (const double*)thresh, (const double*)label,
               (const int*)q_degrees, (const long long*)runs,
               (unsigned*)bits, (long long*)counts, num_blocks, rows,
               (rows + 31) / 32, width, dim, tile_rows};
  cudaStream_t s = (cudaStream_t)stream;
  const int smem = tile_rows * per_row;
  switch (width) {
    case 1: err = (cudaError_t)launch_dim<1>(a, tiles, smem, s); break;
    case 2: err = (cudaError_t)launch_dim<2>(a, tiles, smem, s); break;
    case 3: err = (cudaError_t)launch_dim<3>(a, tiles, smem, s); break;
    case 4: err = (cudaError_t)launch_dim<4>(a, tiles, smem, s); break;
    default:
      err = (cudaError_t)launch_count<AnySummary>(a, tiles, smem, s);
  }
  if (err != cudaSuccess) return (int)err;
  filter_scan_kernel<<<1, SCAN_THREADS, 0, s>>>(
      (const long long*)counts, tiles, (long long*)offsets,
      (long long*)counters);
  return (int)cudaGetLastError();
}

// write: sel int64 [survivors], gate bool [survivors, rows], from the bits
// and offsets of gnnpe_block_filter_count on the same blocks and rows.
extern "C" int gnnpe_block_filter_write(int device, const void* bits,
                                        const void* offsets,
                                        long long num_blocks, int rows,
                                        void* sel, void* gate,
                                        void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const long long tiles = (num_blocks + THREADS - 1) / THREADS;
  if (num_blocks < 1 || tiles > 2147483647LL || rows < 1) {
    return (int)cudaErrorInvalidValue;
  }
  filter_write_kernel<<<(unsigned)tiles, THREADS, 0, (cudaStream_t)stream>>>(
      (const unsigned*)bits, (const long long*)offsets, num_blocks, rows,
      (rows + 31) / 32, (long long*)sel, (uint8_t*)gate);
  return (int)cudaGetLastError();
}
