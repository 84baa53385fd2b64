// The index search's candidate union for Hopper (sm_90a): each phase-2
// chunk's gated leaf hits OR-ed into a bit-packed bitmap, one row of
// 32-bit words per query vertex, and the bitmap compacted into each row's
// sorted vertex ids.
//
// Replaces no TPU kernel.  gnnpe_tpu's device union (gnnpe_tpu/index/
// device_packed.py, union="device") scatters True into a bool [nq, V]
// bitmap with XLA and copies the whole bitmap back.  Done so in PyTorch,
// torch.nonzero waits for the device on every chunk, index_put_ writes two
// int64 indices a hit, and the host runs np.nonzero over a bool [nq, V]
// copy.  These kernels keep the union on the card until its answer:
// nothing in the chunk loop waits, and the search ends with one copy of
// the candidates' ids (tens of kB to a few MB) in place of the bitmap (9 MB
// a query at youtube's 1,134,890 vertices) or the hit masks.
//
// Bound: bytes.  The scatter reads its chunk's leaf mask (Q * C bytes, C =
// K * B columns), the block gate (Q * K), the vid rows (4 * C * L') and the
// output ids (4 * Q * L') once, and writes each touched bitmap word; the
// compaction reads the bitmap (4 * nq * W, W = ceil(V / 32)) twice and
// writes each set bit's id once (4 bytes).  Atomics on the bitmap words
// resolve in L2 (the bitmap is 4.5 MB for 32 query vertices at youtube).
//
// Design.
//  * scatter: one thread a column of the chunk, looping over the query
//    rows; neighbouring threads read neighbouring mask bytes of one row
//    (coalesced) and the same gate byte (a column's block is c / B).  A
//    gated-off row is skipped before its mask byte is read, so the
//    repeat_interleave of the gate over [Q, K * B] that the host union
//    needs never exists.  Each hit (row q, column c) sets bit vid & 31 of
//    word vid >> 5 of output row out[q, j] for each of the L' positions j,
//    by atomicOr, which is idempotent: the bitmap is the same whatever the
//    order.  Most hits set a bit that is set already (a candidate lies on
//    many paths), and atomics on one word serialise, so the word is read
//    first (from L2) and the atomic issued only where the bit reads clear:
//    on an NVIDIA H100 that took 3.7x off the scatter's time at the dblp
//    benchmark configuration and 12.7x at youtube's.  Ids outside [0, V)
//    or rows outside [0, nq) are skipped (pad rows carry such ids and
//    never pass the leaf test).  The columns with any hit are counted
//    with one ballot and one atomicAdd a warp: the host union's hit_rows.
//    Offsets into the bitmap are 64-bit (synth100m has 20 M vertices).
//  * compaction: each row is cut into segments of seg_words words (the
//    caller's one constant, passed to both entry points), one block a
//    (segment, row).  count: each block sums its words' popcounts.
//    scan: one block scans the (row, segment) counts in row-major order into
//    exclusive segment offsets, and writes each row's start (offsets,
//    int64[nq + 1]).  write: each block walks its segment in tiles of
//    THREADS words, takes each word's place in the tile by a block scan of
//    the popcounts, and writes its set bits in ascending order.  So a row's
//    ids come out sorted, and the layout is the one the host splits into
//    nq arrays.
//
// C ABI for ctypes: pointers and the stream are void*; each entry point
// returns cudaGetLastError() after its launches (0 = launched), or
// cudaErrorInvalidValue for a size it does not take.

#include <cuda_runtime.h>

#include <stdint.h>

namespace {

constexpr int SCATTER_THREADS = 256;
constexpr int THREADS = 1024;
constexpr unsigned FULL = 0xffffffffu;

__global__ void __launch_bounds__(SCATTER_THREADS)
scatter_kernel(const uint8_t* __restrict__ mask,
               const uint8_t* __restrict__ gate,
               const int* __restrict__ vids,
               const int* __restrict__ out_ids,
               unsigned* __restrict__ words,
               unsigned long long* __restrict__ hit_columns,
               long long cols, int rows, long long block_size, long long k,
               int width, int num_out, int num_vertices, long long row_words) {
  const long long c = blockIdx.x * (long long)SCATTER_THREADS + threadIdx.x;
  bool any = false;
  if (c < cols) {
    const long long blk = c / block_size;
    for (int q = 0; q < rows; ++q) {
      if (!gate[q * k + blk] || !mask[q * cols + c]) continue;
      any = true;
      for (int j = 0; j < width; ++j) {
        const int v = __ldg(vids + c * width + j);
        const int o = __ldg(out_ids + (long long)q * width + j);
        if ((unsigned)v >= (unsigned)num_vertices ||
            (unsigned)o >= (unsigned)num_out) {
          continue;
        }
        unsigned* word = words + o * row_words + (v >> 5);
        const unsigned bit = 1u << (v & 31);
        // Bits are only ever set while the bitmap is written, so a bit
        // read as set is set; a stale read only costs the atomic.
        if (!(__ldcg(word) & bit)) atomicOr(word, bit);
      }
    }
  }
  const unsigned ballot = __ballot_sync(FULL, any);
  if ((threadIdx.x & 31) == 0 && ballot) {
    atomicAdd(hit_columns, (unsigned long long)__popc(ballot));
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
    long long w = lane < warps ? scratch[lane] : 0;
    for (int d = 1; d < 32; d <<= 1) {
      const long long y = __shfl_up_sync(FULL, w, d);
      if (lane >= d) w += y;
    }
    scratch[lane] = w;                 // inclusive sums of the warps
  }
  __syncthreads();
  const long long before = (warp ? scratch[warp - 1] : 0) + v - x;
  *total = scratch[warps - 1];
  __syncthreads();                     // scratch is free for the next call
  return before;
}

// Block b takes segment b % segments of row b / segments: the words
// [lo, hi) of that row.
__device__ void segment_of(long long row_words, long long seg_words,
                           long long segments, long long* row,
                           long long* lo, long long* hi) {
  const long long seg = blockIdx.x % segments;
  *row = blockIdx.x / segments;
  *lo = seg * seg_words;
  *hi = *lo + seg_words < row_words ? *lo + seg_words : row_words;
}

// rows * segments blocks: the popcount of each (row, segment).
__global__ void __launch_bounds__(THREADS)
count_kernel(const unsigned* __restrict__ words, long long row_words,
             long long seg_words, long long segments,
             long long* __restrict__ counts) {
  __shared__ long long scratch[33];
  long long row, lo, hi;
  segment_of(row_words, seg_words, segments, &row, &lo, &hi);
  const unsigned* w = words + row * row_words;
  long long n = 0;
  for (long long i = lo + threadIdx.x; i < hi; i += THREADS) {
    n += __popc(w[i]);
  }
  long long total;
  block_exclusive_scan(n, scratch, &total);
  if (threadIdx.x == 0) counts[blockIdx.x] = total;
}

// One block: seg_offsets[i] = the sum of counts[0, i) over the n = rows *
// segments counts; offsets[r] = seg_offsets[r * segments], offsets[rows] =
// the sum of all.
__global__ void __launch_bounds__(THREADS)
scan_kernel(const long long* __restrict__ counts, long long n,
            long long segments, long long* __restrict__ seg_offsets,
            long long* __restrict__ offsets) {
  __shared__ long long scratch[33];
  long long carry = 0;
  for (long long base = 0; base < n; base += THREADS) {
    const long long i = base + threadIdx.x;
    const long long x = i < n ? counts[i] : 0;
    long long total;
    const long long at = carry + block_exclusive_scan(x, scratch, &total);
    if (i < n) {
      seg_offsets[i] = at;
      if (i % segments == 0) offsets[i / segments] = at;
    }
    carry += total;
  }
  if (threadIdx.x == 0) offsets[n / segments] = carry;
}

// rows * segments blocks: each set bit of the segment's words as its
// vertex id, in ascending order from the segment's offset.
__global__ void __launch_bounds__(THREADS)
write_kernel(const unsigned* __restrict__ words, long long row_words,
             long long seg_words, long long segments,
             const long long* __restrict__ seg_offsets,
             int* __restrict__ ids) {
  __shared__ long long scratch[33];
  long long row, lo, hi;
  segment_of(row_words, seg_words, segments, &row, &lo, &hi);
  const unsigned* w = words + row * row_words;
  long long at = seg_offsets[blockIdx.x];
  for (long long base = lo; base < hi; base += THREADS) {
    const long long i = base + threadIdx.x;
    unsigned word = i < hi ? w[i] : 0u;
    long long total;
    long long pos = at + block_exclusive_scan(__popc(word), scratch, &total);
    while (word) {
      ids[pos++] = (int)(i * 32 + (__ffs(word) - 1));
      word &= word - 1;
    }
    at += total;
  }
}

}  // namespace

// One phase-2 chunk's hits into the bitmap.  mask: bool [rows, cols] (the
// leaf test), gate: bool [rows, k] (the block survival), cols = k *
// block_size; vids: int32 [cols, width]; out_ids: int32 [rows, width];
// words: uint32 [num_out, row_words], row_words = ceil(num_vertices / 32);
// hit_columns: one uint64, to which the columns with any hit are added.
extern "C" int gnnpe_union_scatter(int device, const void* mask,
                                   const void* gate, const void* vids,
                                   const void* out_ids, void* words,
                                   void* hit_columns, long long cols,
                                   int rows, long long block_size,
                                   long long k, int width, int num_out,
                                   int num_vertices, long long row_words,
                                   void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (cols < 0 || rows < 0 || block_size < 1 || k * block_size != cols ||
      width < 1 || num_out < 0 || num_vertices < 0 ||
      row_words != ((long long)num_vertices + 31) / 32) {
    return (int)cudaErrorInvalidValue;
  }
  if (cols == 0 || rows == 0) return (int)cudaGetLastError();
  const long long blocks = (cols + SCATTER_THREADS - 1) / SCATTER_THREADS;
  scatter_kernel<<<(unsigned)blocks, SCATTER_THREADS, 0,
                   (cudaStream_t)stream>>>(
      (const uint8_t*)mask, (const uint8_t*)gate, (const int*)vids,
      (const int*)out_ids, (unsigned*)words,
      (unsigned long long*)hit_columns, cols, rows, block_size, k, width,
      num_out, num_vertices, row_words);
  return (int)cudaGetLastError();
}

namespace {

// A row of row_words words is cut into ceil(row_words / seg_words)
// segments; 0 for a size the launches do not take.
long long segments_of(long long rows, long long row_words,
                      long long seg_words) {
  if (rows < 1 || row_words < 1 || seg_words < 1) return 0;
  const long long segments = (row_words + seg_words - 1) / seg_words;
  return rows * segments > 2147483647LL ? 0 : segments;
}

}  // namespace

// count and scan: counts, seg_offsets int64 [rows * segments], offsets
// int64 [rows + 1], segments = ceil(row_words / seg_words).
extern "C" int gnnpe_union_offsets(int device, const void* words,
                                   long long rows, long long row_words,
                                   long long seg_words, void* counts,
                                   void* seg_offsets, void* offsets,
                                   void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const long long segments = segments_of(rows, row_words, seg_words);
  if (segments == 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  count_kernel<<<(unsigned)(rows * segments), THREADS, 0, s>>>(
      (const unsigned*)words, row_words, seg_words, segments,
      (long long*)counts);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  scan_kernel<<<1, THREADS, 0, s>>>((const long long*)counts,
                                    rows * segments, segments,
                                    (long long*)seg_offsets,
                                    (long long*)offsets);
  return (int)cudaGetLastError();
}

// write: ids int32 [offsets[rows]], from the seg_offsets of
// gnnpe_union_offsets on the same words and seg_words.
extern "C" int gnnpe_union_write(int device, const void* words,
                                 long long rows, long long row_words,
                                 long long seg_words,
                                 const void* seg_offsets, void* ids,
                                 void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const long long segments = segments_of(rows, row_words, seg_words);
  if (segments == 0) return (int)cudaErrorInvalidValue;
  write_kernel<<<(unsigned)(rows * segments), THREADS, 0,
                 (cudaStream_t)stream>>>(
      (const unsigned*)words, row_words, seg_words, segments,
      (const long long*)seg_offsets, (int*)ids);
  return (int)cudaGetLastError();
}
