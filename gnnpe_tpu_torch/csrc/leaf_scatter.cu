// PE phase 2 fused for Hopper (sm_90a): the leaf test of the surviving
// index blocks' vid rows against every gated query row, with each hit
// OR-ed straight into the candidate union's bit-packed bitmap.
//
// Replaces no TPU kernel.  gnnpe_tpu's table-mode leaf test gathers each
// vid's label, degree and VDE through the per-vertex tables and compares
// the whole [Q, K * B, L * D] chunk with XLA.  Done so in PyTorch, each
// chunk writes three gathered tables ([K * B, L] and [K * B, L * D]) and
// three bool compares ([Q, K * B, L] and [Q, K * B, L * D]) to device
// memory, reduces each with .all(-1), and U's scatter (union_bitmap.cu)
// reads the finished [Q, K * B] mask back.  This kernel absorbs that whole
// chain and U's scatter for the PE table layout: nothing but the bitmap's
// words and one hit counter is written.
//
// Bound: bytes.  Each surviving row's L vids are read once from device
// memory (4 * L bytes); the block gate (Q bytes a block), the query rows
// and the per-vertex tables (label, degree, D f64; 27 MB at youtube's
// 1,134,891 vertices) are read through L2, where they stay; each touched
// bitmap word is written.  The compares are a few integer and L * D f64
// compares a (row, gated query row): far below the card's rates.
//
// Design.
//  * One thread block a surviving index block of block_size rows, walked
//    in groups of THREADS rows, a thread a row.  A thread reads its row's
//    L vids once (neighbouring threads, neighbouring rows: coalesced) and
//    gathers each vertex's label, degree and D f64 VDE once into
//    registers (HeldRow: L and D template parameters, 1-4 each; the
//    configurations served have L = 3, D = 2).  Any other L or D runs
//    AnyRow, which holds nothing and reads the vids and the vertex
//    records again for each gated query row, from L1 or L2 after the
//    first: the same tests, slower where many rows are gated on.  Every
//    shape launches this kernel; none falls back.  Ids outside the tables
//    [0, num_vertices] read as the sentinel row num_vertices (label -2,
//    which no query label equals), as pad rows carry.
//  * The block's gate row (gate is [K, Q]: one block's Q bytes lie
//    together) is compacted into a shared list of the gated-on query rows,
//    THREADS at a time, in ascending order, by a ballot a warp.  Every
//    thread then tests its row against each listed query row, in
//    pe_mask_exact's order: labels equal, then query degree <= data
//    degree, then data VDE >= threshold in f64, stopping at the first
//    failure.  The query row's fields are the same address across the
//    warp (a broadcast from L1).
//  * A pass sets vertex vids[j] in output row out_ids[q, j] for each
//    position j, as U's scatter does: the word is read first (from L2)
//    and atomicOr issued only where the bit reads clear; ids outside
//    [0, num_vertices) and output rows outside [0, num_out) are skipped.
//    The bitmap is the same whatever the order.
//  * Rows with any gated hit are counted with one ballot and one
//    atomicAdd a warp: U's hit columns, so hit_rows keeps its meaning.
//  * Offsets into the vid table and the bitmap are 64-bit (youtube's
//    table holds 1.17e9 rows of 3 vids).
//
// C ABI for ctypes: pointers and the stream are void*; the entry point
// returns cudaGetLastError() after its launch (0 = launched), or
// cudaErrorInvalidValue for a size it does not take.

#include <cuda_runtime.h>

#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr unsigned FULL = 0xffffffffu;

struct Args {
  const int* vids;             // int32 [table_blocks * block_size, width]
  const long long* blocks;     // int64 [num_blocks]: blocks of the table
  const uint8_t* gate;         // bool [num_blocks, rows]
  const int* labels;           // int32 [num_vertices + 1]
  const int* degrees;          // int32 [num_vertices + 1]
  const double* vde;           // f64 [num_vertices + 1, dim]
  const int* q_labels;         // int32 [rows, width]
  const int* q_degrees;        // int32 [rows, width]
  const double* q_thresh;      // f64 [rows, width * dim]
  const int* out_ids;          // int32 [rows, width]
  unsigned* words;             // uint32 [num_out, row_words]
  unsigned long long* hit_rows;
  long long num_blocks, table_blocks, row_words;
  int block_size, rows, num_out, num_vertices, width, dim;
};

// The row of the tables that vertex id v reads: ids outside
// [0, num_vertices] read the sentinel row num_vertices.
__device__ __forceinline__ int table_row(const Args& a, int v) {
  return (unsigned)v > (unsigned)a.num_vertices ? a.num_vertices : v;
}

// A vid row whose L vertices' label, degree and D f64 VDE are gathered
// once into registers (L and D known when compiled).
template <int L, int D>
struct HeldRow {
  int vid[L], lab[L], deg[L];
  double e[L][D];

  __device__ void load(const Args& a, long long row, bool live) {
#pragma unroll
    for (int j = 0; j < L; ++j) {
      vid[j] = live ? __ldg(a.vids + row * L + j) : a.num_vertices;
      const int t = table_row(a, vid[j]);
      lab[j] = __ldg(a.labels + t);
      deg[j] = __ldg(a.degrees + t);
#pragma unroll
      for (int d = 0; d < D; ++d) {
        e[j][d] = __ldg(a.vde + (long long)t * D + d);
      }
    }
  }
  __device__ int width(const Args&) const { return L; }
  __device__ int vertex(int j) const { return vid[j]; }
  // pe_mask_exact's test against query row q: labels equal, then query
  // degree <= data degree, then data VDE >= threshold, stopping at the
  // first failure.
  __device__ bool passes(const Args& a, int q) const {
#pragma unroll
    for (int j = 0; j < L; ++j) {
      if (lab[j] != __ldg(a.q_labels + q * L + j)) return false;
    }
#pragma unroll
    for (int j = 0; j < L; ++j) {
      if (!(__ldg(a.q_degrees + q * L + j) <= deg[j])) return false;
    }
#pragma unroll
    for (int j = 0; j < L; ++j) {
#pragma unroll
      for (int d = 0; d < D; ++d) {
        if (!(e[j][d] >= __ldg(a.q_thresh + (q * L + j) * D + d))) {
          return false;
        }
      }
    }
    return true;
  }
};

// A vid row of any width and VDE width (a.width, a.dim): nothing is held;
// each test reads the row's vids and their vertex records again, from L1
// or L2 after the first.
struct AnyRow {
  const int* vids;

  __device__ void load(const Args& a, long long row, bool) {
    vids = a.vids + row * a.width;
  }
  __device__ int width(const Args& a) const { return a.width; }
  __device__ int vertex(int j) const { return __ldg(vids + j); }
  __device__ bool passes(const Args& a, int q) const {
    const int l = a.width, dim = a.dim;
    for (int j = 0; j < l; ++j) {
      if (__ldg(a.labels + table_row(a, vertex(j))) !=
          __ldg(a.q_labels + q * l + j)) {
        return false;
      }
    }
    for (int j = 0; j < l; ++j) {
      if (!(__ldg(a.q_degrees + q * l + j) <=
            __ldg(a.degrees + table_row(a, vertex(j))))) {
        return false;
      }
    }
    for (int j = 0; j < l; ++j) {
      const double* e = a.vde + (long long)table_row(a, vertex(j)) * dim;
      const double* t = a.q_thresh + (long long)(q * l + j) * dim;
      for (int d = 0; d < dim; ++d) {
        if (!(__ldg(e + d) >= __ldg(t + d))) return false;
      }
    }
    return true;
  }
};

template <class Row>
__global__ void __launch_bounds__(THREADS) leaf_scatter_kernel(Args a) {
  __shared__ int list[THREADS];
  __shared__ int warp_counts[WARPS];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long blk = a.blocks[blockIdx.x];
  if (blk < 0 || blk >= a.table_blocks) return;     // the whole block
  const uint8_t* gate = a.gate + (long long)blockIdx.x * a.rows;
  for (int r0 = 0; r0 < a.block_size; r0 += THREADS) {
    const int r = r0 + threadIdx.x;
    const bool live = r < a.block_size;
    Row row;
    row.load(a, blk * a.block_size + r, live);
    bool any = false;
    for (int q0 = 0; q0 < a.rows; q0 += THREADS) {
      const int qq = q0 + threadIdx.x;
      const bool on = qq < a.rows && gate[qq];
      const unsigned ballot = __ballot_sync(FULL, on);
      if (lane == 0) warp_counts[warp] = __popc(ballot);
      __syncthreads();
      int before = 0, n = 0;
#pragma unroll
      for (int w = 0; w < WARPS; ++w) {
        before += w < warp ? warp_counts[w] : 0;
        n += warp_counts[w];
      }
      if (on) list[before + __popc(ballot & ((1u << lane) - 1u))] = qq;
      __syncthreads();
      for (int i = 0; live && i < n; ++i) {
        const int q = list[i];
        if (!row.passes(a, q)) continue;
        any = true;
        const int l = row.width(a);
#pragma unroll
        for (int j = 0; j < l; ++j) {
          const int v = row.vertex(j);
          const int o = __ldg(a.out_ids + q * l + j);
          if ((unsigned)v >= (unsigned)a.num_vertices ||
              (unsigned)o >= (unsigned)a.num_out) {
            continue;
          }
          unsigned* word = a.words + o * a.row_words + (v >> 5);
          const unsigned bit = 1u << (v & 31);
          // Bits are only ever set while the bitmap is written, so a bit
          // read as set is set; a stale read only costs the atomic.
          if (!(__ldcg(word) & bit)) atomicOr(word, bit);
        }
      }
      __syncthreads();                 // the list is free for the next tile
    }
    const unsigned hit = __ballot_sync(FULL, any);
    if (lane == 0 && hit) {
      atomicAdd(a.hit_rows, (unsigned long long)__popc(hit));
    }
  }
}

template <class Row>
int launch(const Args& a, cudaStream_t s) {
  leaf_scatter_kernel<Row><<<(unsigned)a.num_blocks, THREADS, 0, s>>>(a);
  return (int)cudaGetLastError();
}

// Paths of 1-4 vertices with VDEs of 1-4 columns hold their records in
// registers; any other shape runs AnyRow.
template <int L>
int launch_dim(const Args& a, cudaStream_t s) {
  switch (a.dim) {
    case 1: return launch<HeldRow<L, 1>>(a, s);
    case 2: return launch<HeldRow<L, 2>>(a, s);
    case 3: return launch<HeldRow<L, 3>>(a, s);
    case 4: return launch<HeldRow<L, 4>>(a, s);
    default: return launch<AnyRow>(a, s);
  }
}

}  // namespace

// The leaf test of num_blocks index blocks and their hits into the bitmap.
// vids: int32 [table_blocks * block_size, width], whose block blocks[i] is
// tested against the query rows gated on in gate[i] (bool [num_blocks,
// rows]); labels, degrees: int32 [num_vertices + 1], vde: f64
// [num_vertices + 1, dim] (row num_vertices the sentinel); q_labels,
// q_degrees, out_ids: int32 [rows, width]; q_thresh: f64 [rows, width *
// dim]; words: uint32 [num_out, row_words], row_words = ceil(num_vertices
// / 32); hit_rows: one uint64, to which the rows with any gated hit are
// added.  Blocks outside [0, table_blocks) are skipped.
extern "C" int gnnpe_leaf_scatter(
    int device, const void* vids, const void* blocks, const void* gate,
    const void* labels, const void* degrees, const void* vde,
    const void* q_labels, const void* q_degrees, const void* q_thresh,
    const void* out_ids, void* words, void* hit_rows, long long num_blocks,
    long long table_blocks, int block_size, int rows, int width, int dim,
    int num_out, int num_vertices, long long row_words, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (num_blocks < 0 || num_blocks > 2147483647LL || table_blocks < 0 ||
      block_size < 1 || rows < 0 || width < 1 || dim < 1 || num_out < 0 ||
      num_vertices < 0 || row_words != ((long long)num_vertices + 31) / 32) {
    return (int)cudaErrorInvalidValue;
  }
  if (num_blocks == 0 || rows == 0) return (int)cudaGetLastError();
  const Args a{(const int*)vids, (const long long*)blocks,
               (const uint8_t*)gate, (const int*)labels,
               (const int*)degrees, (const double*)vde, (const int*)q_labels,
               (const int*)q_degrees, (const double*)q_thresh,
               (const int*)out_ids, (unsigned*)words,
               (unsigned long long*)hit_rows, num_blocks, table_blocks,
               row_words, block_size, rows, num_out, num_vertices, width,
               dim};
  cudaStream_t s = (cudaStream_t)stream;
  switch (width) {
    case 1: return launch_dim<1>(a, s);
    case 2: return launch_dim<2>(a, s);
    case 3: return launch_dim<3>(a, s);
    case 4: return launch_dim<4>(a, s);
    default: return launch<AnyRow>(a, s);
  }
}
