// Fixed-order segment sum for Hopper (sm_90a): the backward of a fixed
// row gather y = x.index_select(0, idx), one launch a call,
//   out[r, c] = sum_{j = offsets[r]}^{offsets[r+1]-1} g[perm[j], c],
// where perm [N] is the stable argsort of idx and offsets [R+1] the CSR row
// pointer of the transposed index (bincount, then cumsum).  Rows that no
// entry names are 0.0.  g [N, d] and out [R, d] row-major, f32 or f64
// (one entry each, gnnpe_segment_sum_f32 and _f64), any d >= 1.
//
// What it replaces.  In gnnpe_tpu the function is the VJP of jnp.take at
// gnnpe_tpu/models/gnn.py:106,122 and gnnpe_tpu/parallel/dist.py:127-134:
// an XLA scatter-add, not a Pallas kernel.  Its order of adds is
// unspecified, so no bit contract binds this kernel to the host (unlike
// A1's f64 VDE, csrc/spmm_csr.cu): the order may be any, as long as it is
// fixed.  The trainer's label lookup and path readout
// (ops/gather.py:GatherRows) call it once a step each.
//
// Bound: bytes.  Per entry the cotangent row is read once (d * s B for
// elements of s B) and perm once (4 B); per output row one row is written
// (d * s B).  At the trainer's d = 2 the path readout (1,500,000 entries
// into 317,080 rows) must move 20.5 MB, 6.1 us at 3.35 TB/s, and the label
// lookup (317,080 entries into 15 rows) 3.8 MB, 1.1 us.  What the kernel
// adds: a window's run index (4 B per window entries), the row of each run
// it writes (4 B a row), and per tile its incoming row (8 B) and a carry of
// d elements.  What holds it above that bound on an H100 is not the bytes:
// at d = 2 a tile's chain of dependent steps (its entries, the gathers,
// the combine, the flag of the tile before, that tile's carry) takes a few
// microseconds however little it moves, so the path readout is more
// than two waves of such chains (the same readout over its index sorted,
// every gather in order, takes two thirds of its time) and the label
// lookup, under one wave, one chain above a launch; at f64 d = 2 it is
// the blocks resident (registers); at d = 12 the cotangent (8.75 GB at the
// full dblp readout) is read as scattered 48-byte rows from device memory.
// The design keeps the chain short:
//  (1) Row edges come with the data: bit 31 of each entry of perm (free,
//      N < 2^31) marks the last entry of a row, so a slot knows where its
//      runs end from the words it loads anyway, and the row a run writes is
//      run_rows[window_runs[window] + ends before it in the slot] (the
//      non-empty rows in order), loaded beside the gathers: no load waits
//      on another to find where a row ends.
//  (2) A tile combines by fixed trees: each warp runs a Kogge-Stone
//      segmented scan over its slots (shuffles carrying the slots' end
//      flags, log2(32 / lanes) steps), the warps fold their totals in warp
//      order through shared memory (at most 15 adds), and a row's pieces
//      from earlier tiles are summed by a pairwise tree in the block of its
//      last tile: by warp 0 alone, with no block barrier, where they are no
//      more than its slots (the label lookup's ~21 tiles a row, the path
//      readout's one), else by all slots of the block.  No thread adds more
//      than a slot's entries, a tree's levels and the warps' totals one
//      after another.
//  (3) A wide row in one pass: each entry has a group of `lanes` lanes
//      (16 B a lane, gather_rows.cuh's shape: 1 lane at f32 d = 2, 4 at
//      f32 d = 12), so a row's packs are loaded together, and a slot sums
//      window * lanes entries (at most 16), so a tile keeps its entries up
//      to 4 lanes; the row edges, run indices and rows are found once, and
//      rows wider than 32 packs loop over column tiles with no walk
//      repeated.
//  (4) Block t takes tile t: a ticket from a counter would add an atomic
//      to every chain.
//
// The order of the adds (ops/gather.py:segment_sum_plain repeats it bit for
// bit; every sum starts from +0.0, so a sum is never -0.0 and adding a
// +0.0 never changes it).  A tile is S = threads / lanes slots of W =
// min(16, window * lanes) sorted entries; 32 / lanes slots form a warp.
//  (1) A slot sums each of its runs left to right.  A run that ends after
//      the slot's first row end is a whole row, written at once.
//  (2) Each slot's trailing piece (after its last row end; 0.0 if it ends
//      on one) is scanned over the warp's slots: for h = 1, 2, 4, ...,
//      v[i] = v[i-h] + v[i] unless slot i holds a row end (flags OR).
//  (3) The carry into warp w: the warps' totals folded left to right,
//      starting again at a warp that holds a row end.  The carry into a
//      slot: the scan of the slot before it, or the warp's carry + that
//      scan where the slots before it in the warp hold no row end.
//  (4) A slot's first run closes its row: carry into the slot + the run.
//      The first row end of a tile closes the row the tile took in from
//      earlier tiles (if any): that sum is the tile's own piece.
//  (5) A tile whose last row runs on publishes a carry: the scan at its
//      end.  The block of the last tile of such a row waits for the flags
//      of the row's earlier tiles t0 .. t-1, then slot i sums the carries
//      of tiles t0 + i, t0 + i + S, ... left to right, the S slots are
//      summed by a pairwise tree ((s0 + s1) + (s2 + s3)) ..., and the
//      tile's own piece is added last.
// There is no atomic on the output, so the result is bit-identical from
// run to run (index_add_'s is not).  Every output row is written once: an
// empty row by the tile whose share of the empty rows holds it, a row by
// the slot that ends it or, if it crossed tiles, by its last tile's block.
//
// Blocks are dispatched in index order, so the tiles a block waits for
// belong to blocks already running or done (the rule a single-pass scan's
// look-back rests on), and every tile publishes its carry before it waits;
// the wait gives up with a trap after 2^25 polls (seconds) instead of
// hanging.  Each waiting block clears the flags it read, so the flags are
// zero after every launch, and a CUDA graph replays it; a plan's launches
// must stay on one stream, in order.  The carries and own pieces live in
// the plan's global scratch ([2, tiles, d]); a tile's own piece is
// written and read by its own block.
//
// window and threads were chosen with python -m
// gnnpe_tpu_torch.kernels.readout_sweep (ops/gather.py says which run).
//
// Limits.  N < 2^31 and R < 2^31 (perm, offsets and the row ids are
// int32); d >= 1, with no upper bound but memory, and no shared memory
// that grows with it.  Every address that scales with N * d or R * d is
// computed in 64 bits, so N * d and R * d may pass 2^31.  An empty index
// (N = 0) is one tile with no entries, whose share of the empty rows is
// every row, so it is one launch like any other.
//
// C ABI for ctypes: the plan's pointers and sizes come in one struct
// (SegmentPlan below), so a call converts 7 arguments; the return value
// is cudaGetLastError() after the launch (0 = launched), or
// cudaErrorInvalidValue for a shape that has no kernel.

#include <cuda_runtime.h>

#include "gather_rows.cuh"

namespace {

using gather_rows::Pack;
using gather_rows::add_pack;
using gather_rows::load_pack;
using gather_rows::store_pack;
using gather_rows::zero_pack;

constexpr int kMaxThreads = 512;
constexpr int kMaxWarps = kMaxThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr long long kMaxSpins = 1LL << 25;   // polls of 32 ns and more

// Mirrored by ops/gather.py:_SegmentPlan (ctypes).
struct SegmentPlan {
  const int* entries;       // [n] perm, bit 31 set on each row's last entry
  const int* window_runs;   // [ceil(n / window)] run of each window's first
  const int* run_rows;      // [rows] the non-empty rows in order, then the
                            // empty ones
  const int* tile_in;       // [tiles, 2] the row each tile takes in from
                            // earlier tiles (-1: none) and its first tile
  void* scratch;            // [2, tiles, d] of g's type: carries, own pieces
  int* flags;               // [tiles], zero between launches
  long long n;
  int rows;
  int runs;                 // non-empty rows
  int window;               // entries a window_runs entry covers
  int slot_window;          // entries a slot sums: window * lanes, <= 16
  int threads;
  int lanes;                // lanes an entry: a power of two up to 32
  int tiles;
};

template <typename T, int VEC>
__device__ __forceinline__ Pack<T, VEC> load_pack_l2(const T* p) {
  using R = typename gather_rows::Raw<sizeof(T) * VEC>::type;
  Pack<T, VEC> out;
  *reinterpret_cast<R*>(&out) = __ldcg(reinterpret_cast<const R*>(p));
  return out;
}

template <typename T, int VEC>
__device__ __forceinline__ Pack<T, VEC> sum_pack(Pack<T, VEC> a,
                                                 const Pack<T, VEC>& b) {
  add_pack(a, b);
  return a;
}

template <typename T, int VEC>
__device__ __forceinline__ Pack<T, VEC> shfl_up_pack(const Pack<T, VEC>& v,
                                                     int delta) {
  Pack<T, VEC> out;
#pragma unroll
  for (int e = 0; e < VEC; ++e) {
    out.e[e] = __shfl_up_sync(kFull, v.e[e], delta);
  }
  return out;
}

template <typename T, int VEC>
__device__ __forceinline__ Pack<T, VEC> shfl_down_pack(
    const Pack<T, VEC>& v, int delta) {
  Pack<T, VEC> out;
#pragma unroll
  for (int e = 0; e < VEC; ++e) {
    out.e[e] = __shfl_down_sync(kFull, v.e[e], delta);
  }
  return out;
}

// A slot of 4 entries (a plan of window 4 at one lane) keeps at most 64
// registers, two blocks of 512 threads an SM: at f64 d = 2 and 256
// threads that is twice the blocks resident that its 88 registers
// allowed; wider slots need their registers for the gathers in flight,
// and spill when capped.
template <typename T, int VEC, int W>
__global__ void __launch_bounds__(kMaxThreads, W == 4 ? 2 : 1)
segment_sum_kernel(const SegmentPlan p, const T* __restrict__ g,
                   T* __restrict__ out, int d) {
  using P = Pack<T, VEC>;
  __shared__ P s_agg[kMaxWarps][32];   // a warp's total or tree, per lane
  __shared__ int s_wflag[kMaxWarps];   // the warp holds a row end

  const int i = threadIdx.x;
  const int lane = i & 31;
  const int warp = i >> 5;
  const int warps = blockDim.x >> 5;
  const int L = p.lanes;
  const int shift = __ffs(L) - 1;
  const int gl = i & (L - 1);          // lane in the entry's group
  const int slot = i >> shift;         // slot in the tile
  const int pos = lane >> shift;       // slot in the warp
  const int per_warp = 32 >> shift;
  const int slots = blockDim.x >> shift;
  const int wshift = __ffs(p.window) - 1;
  const long long tile = (long long)slots * W;
  const P zero = zero_pack<T, VEC>();

  const int t = blockIdx.x;
  const long long base = t * tile;
  const long long a = base + (long long)slot * W;
  const int cnt = (int)max(0LL, min((long long)W, p.n - a));
  const int2 in = __ldg(reinterpret_cast<const int2*>(p.tile_in) + t);

  // The slot's entries; bit k of `ends` marks a row's last entry.
  int q[W];
  unsigned ends = 0;
  if (cnt == W && W % 4 == 0) {
#pragma unroll
    for (int k = 0; k < W / 4; ++k) {
      const int4 v = __ldg(reinterpret_cast<const int4*>(p.entries + a) + k);
      q[4 * k] = v.x; q[4 * k + 1] = v.y; q[4 * k + 2] = v.z;
      q[4 * k + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int k = 0; k < W; ++k) {
      q[k] = k < cnt ? __ldg(p.entries + a + k) : 0;
    }
  }
#pragma unroll
  for (int k = 0; k < W; ++k) {
    ends |= (unsigned)(q[k] < 0) << k;
    q[k] &= 0x7fffffff;
  }
  // The row of the run that ends at entry k.
  const int run0 = cnt > 0 ? __ldg(p.window_runs + (a >> wshift)) : 0;
  int row_at[W];
#pragma unroll
  for (int k = 0; k < W; ++k) {
    row_at[k] = (ends >> k & 1u)
        ? __ldg(p.run_rows + run0 + __popc(ends & ((1u << k) - 1u))) : 0;
  }

  // This tile's share of the empty rows.
  const long long empties = (long long)p.rows - p.runs;
  if (empties > 0) {
    const long long lo = p.runs + empties * t / p.tiles;
    const long long hi = p.runs + empties * (t + 1) / p.tiles;
    for (long long r = lo + slot; r < hi; r += slots) {
      T* const row = out + (long long)__ldg(p.run_rows + r) * d;
      for (int c = gl * VEC; c < d; c += L * VEC) {
        store_pack<T, VEC>(row + c, zero);
      }
    }
  }

  T* const scratch = static_cast<T*>(p.scratch);
  T* const carry = scratch + (long long)t * d;
  T* const own = scratch + ((long long)p.tiles + t) * d;
  const bool has_end = ends != 0;
  // The tile's last row runs on into the next tile (at N the last entry
  // always ends its row).
  const bool publish = slot == slots - 1 && cnt == W
                       && !(ends >> (W - 1) & 1u);

  for (int c0 = 0; c0 < d; c0 += L * VEC) {
    const int c = c0 + gl * VEC;
    const bool col = c < d;
    P v[W];
#pragma unroll
    for (int k = 0; k < W; ++k) {
      if (k < cnt && col) {
        v[k] = load_pack<T, VEC>(g + (long long)q[k] * d + c);
      }
    }
    // (1) The slot's runs.
    P acc = zero, first = zero;
    int first_row = 0;
    bool seen = false;
#pragma unroll
    for (int k = 0; k < W; ++k) {
      if (k < cnt && col) add_pack(acc, v[k]);
      if (ends >> k & 1u) {
        if (!seen) {
          first = acc;
          first_row = row_at[k];
        } else if (col) {
          store_pack<T, VEC>(out + (long long)row_at[k] * d + c, acc);
        }
        seen = true;
        acc = zero;
      }
    }
    // (2) The scan of the trailing pieces over the warp's slots.
    P sv = acc;
    int sf = has_end;
    for (int h = 1; h < per_warp; h <<= 1) {
      const P ov = shfl_up_pack(sv, h << shift);
      const int of = __shfl_up_sync(kFull, sf, h << shift);
      if (pos >= h) {
        if (!sf) sv = sum_pack(ov, sv);
        sf |= of;
      }
    }
    P xv = shfl_up_pack(sv, L);
    int xf = __shfl_up_sync(kFull, sf, L);
    if (pos == 0) {
      xv = zero;
      xf = 0;
    }
    if (pos == per_warp - 1) s_agg[warp][gl] = sv;
    if (lane == 31) s_wflag[warp] = sf;
    __syncthreads();
    // (3) The carry into this warp, warp by warp.
    P cv = zero;
    int cf = 0;
    for (int w = 0; w < warp; ++w) {
      const P aw = s_agg[w][gl];
      cv = s_wflag[w] ? aw : sum_pack(cv, aw);
      cf |= s_wflag[w];
    }
    // (4) The slot's first run closes its row, or is the tile's own piece
    // of the row it took in.
    if (has_end && col) {
      const P tot = sum_pack(xf ? xv : sum_pack(cv, xv), first);
      const bool is_own = in.x >= 0 && !cf && !xf;
      store_pack<T, VEC>(is_own ? own + c
                                : out + (long long)first_row * d + c, tot);
    }
    // (5) The carry of the row that runs on.
    if (publish && col) {
      store_pack<T, VEC>(carry + c, sf ? sv : sum_pack(cv, sv));
    }
    __syncthreads();  // s_agg is written again for the next columns
  }
  if (warp == warps - 1) {
    if (publish) __threadfence();
    __syncwarp();
    if (publish && lane == 32 - L) atomicExch(p.flags + t, 1);
  }

  // The row taken in from earlier tiles, if this tile ends it: wait for
  // their flags, fold their carries by the tree, add this tile's piece.
  int tile_has_end = 0;
  for (int w = 0; w < warps; ++w) tile_has_end |= s_wflag[w];
  if (in.x < 0 || !tile_has_end) return;
  const int t0 = in.y;
  // Warp 0 requests the first columns' own piece, then waits.
  if (warp > 0 && t - t0 <= per_warp) return;
  const bool adder = warp == 0 && lane < L && gl * VEC < d;
  P own0 = zero;
  if (adder) own0 = load_pack_l2<T, VEC>(own + gl * VEC);
  if (warp == 0) {
    for (int s = t0 + lane; s < t; s += 32) {
      long long spins = 0;
      while (*(volatile int*)(p.flags + s) == 0) {
        if (++spins > kMaxSpins) __trap();
        __nanosleep(32);
      }
    }
    __syncwarp();
    __threadfence();
  }
  if (t - t0 <= per_warp) {
    // The carries fit warp 0's slots, one each: its tree is the block's
    // (the other slots would add only zeros).
    for (int c0 = 0; c0 < d; c0 += L * VEC) {
      const int c = c0 + gl * VEC;
      const bool col = c < d;
      const P own_c = (c0 == 0 || !(lane < L && col))
          ? own0 : load_pack_l2<T, VEC>(own + c);
      P pp = zero;
      if (col && pos < t - t0) {
        add_pack(pp, load_pack_l2<T, VEC>(
            scratch + (long long)(t0 + pos) * d + c));
      }
      for (int h = 1; h < per_warp; h <<= 1) {
        add_pack(pp, shfl_down_pack(pp, h << shift));
      }
      if (lane < L && col) {
        store_pack<T, VEC>(out + (long long)in.x * d + c,
                           sum_pack(pp, own_c));
      }
    }
    for (int s = t0 + lane; s < t; s += 32) p.flags[s] = 0;
    return;
  }
  __syncthreads();
  for (int c0 = 0; c0 < d; c0 += L * VEC) {
    const int c = c0 + gl * VEC;
    const bool col = c < d;
    const P own_c = (c0 == 0 || !(warp == 0 && lane < L && col))
        ? own0 : load_pack_l2<T, VEC>(own + c);
    P pp = zero;
    if (col) {
#pragma unroll 4
      for (int s = t0 + slot; s < t; s += slots) {
        add_pack(pp, load_pack_l2<T, VEC>(scratch + (long long)s * d + c));
      }
    }
    for (int h = 1; h < per_warp; h <<= 1) {
      add_pack(pp, shfl_down_pack(pp, h << shift));
    }
    if (pos == 0) s_agg[warp][gl] = pp;
    __syncthreads();
    if (warp == 0 && lane < L && col) {
      // The warps' trees pairwise, in place: each lane its own columns.
      for (int h = 1; h < warps; h <<= 1) {
        for (int w = 0; w + h < warps; w += 2 * h) {
          s_agg[w][gl] = sum_pack(s_agg[w][gl], s_agg[w + h][gl]);
        }
      }
      store_pack<T, VEC>(out + (long long)in.x * d + c,
                         sum_pack(s_agg[0][gl], own_c));
    }
    __syncthreads();  // s_agg is written again for the next columns
  }
  // Each flag is read by this block alone: clear it for the next launch.
  if (warp == 0) {
    for (int s = t0 + lane; s < t; s += 32) p.flags[s] = 0;
  }
}

template <typename T, int VEC>
int launch_vec(const SegmentPlan& p, const T* g, T* out, int d,
               cudaStream_t stream) {
  const unsigned blocks = (unsigned)p.tiles;
#define GNNPE_SEGMENT_CASE(W)                                              \
  case W:                                                                  \
    segment_sum_kernel<T, VEC, W>                                          \
        <<<blocks, p.threads, 0, stream>>>(p, g, out, d);                  \
    break;
  switch (p.slot_window) {
    GNNPE_SEGMENT_CASE(4)
    GNNPE_SEGMENT_CASE(8)
    GNNPE_SEGMENT_CASE(16)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef GNNPE_SEGMENT_CASE
  return (int)cudaGetLastError();
}

// One launch over plan->tiles blocks of plan->threads threads (a multiple
// of 32 up to 512), each summing threads / lanes slots of window sorted
// entries.  vec is the elements a lane loads (4, 2 or 1 for float, 2 or 1
// for double: 16 bytes at most; d and the alignment of g, out and the
// scratch must be multiples of it); lanes a power of two up to 32.
template <typename T>
int launch(int device, const void* plan, const void* g, void* out, int d,
           int vec, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const SegmentPlan& p = *(const SegmentPlan*)plan;
  if (p.threads < 32 || p.threads > kMaxThreads || p.threads % 32
      || p.lanes < 1 || p.lanes > 32 || (p.lanes & (p.lanes - 1))
      || p.window < 4 || p.window > 16 || (p.window & (p.window - 1))
      || p.slot_window < p.window || p.slot_window % p.window
      || p.tiles < 1 || p.rows < 1 || p.runs < 0 || p.runs > p.rows
      || d < 1 || p.n < 0
      || (long long)p.tiles * (p.threads / p.lanes) * p.slot_window < p.n) {
    return (int)cudaErrorInvalidValue;
  }
  const T* gp = (const T*)g;
  T* op = (T*)out;
  cudaStream_t s = (cudaStream_t)stream;
  switch (vec) {
    case 4:
      if constexpr (sizeof(T) * 4 <= 16) {
        return launch_vec<T, 4>(p, gp, op, d, s);
      }
      return (int)cudaErrorInvalidValue;
    case 2: return launch_vec<T, 2>(p, gp, op, d, s);
    case 1: return launch_vec<T, 1>(p, gp, op, d, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int gnnpe_segment_sum_f32(int device, const void* plan,
                                     const void* g, void* out, int d,
                                     int vec, void* stream) {
  return launch<float>(device, plan, g, out, d, vec, stream);
}

extern "C" int gnnpe_segment_sum_f64(int device, const void* plan,
                                     const void* g, void* out, int d,
                                     int vec, void* stream) {
  return launch<double>(device, plan, g, out, d, vec, stream);
}
