// Fixed-order segment sum for Hopper (sm_90a): the backward of a fixed
// row gather y = x.index_select(0, idx), one launch a call,
//   out[r, c] = sum_{j = offsets[r]}^{offsets[r+1]-1} g[perm[j], c],
// where perm [N] is the stable argsort of idx and offsets [R+1] the CSR row
// pointer of the transposed index (bincount, then cumsum).  Rows that no
// entry names are 0.0.  g [N, d] and out [R, d] row-major, f32 or f64
// (one entry each, gnnpe_segment_sum_f32 and _f64), any d >= 1.
//
// What it replaces.  The trainer's label lookup and path readout
// (ops/gather.py:GatherRows): before, the transposed index walked as a
// rectangular uniform-width ELL, one launch of kernel A2
// (csrc/ell_gather_sum.cu) a level, 4 launches for the path readout and 6
// for the label lookup, every row of the index carried through every
// level, mostly as pads.  In gnnpe_tpu the function is the VJP of
// jnp.take at gnnpe_tpu/models/gnn.py:106,122 and
// gnnpe_tpu/parallel/dist.py:127-134: an XLA scatter-add, not a Pallas
// kernel.  Its order of adds is unspecified, so no bit contract binds this
// kernel to the host (unlike A1's f64 VDE, csrc/spmm_csr.cu): a row may be
// split across blocks, as long as the order is fixed.
//
// Bound: bytes.  Per entry the cotangent row is read once (d * s B for
// elements of s B) and perm once (4 B); per output row one row is written
// (d * s B).  At the
// trainer's d = 2 the path readout (1,500,000 entries into 317,080 rows)
// must move 20.5 MB, 6.1 us at 3.35 TB/s.  What the kernel adds to that:
// the window rows (4 B per W entries), the offsets of the rows it walks
// (4 B a row, mostly from L1) and two pieces of d elements a tile (the
// carry and the incoming row's piece, below).  An 8-byte
// gathered row is a quarter of a 32-byte sector; the path readout's
// cotangent (12 MB) and the label lookup's (2.5 MB) fit in the 50 MB L2,
// so each sector comes from device memory about once however the gathers
// scatter over it, and the kernel makes no attempt to sort its reads by
// sector.
//
// The order of the adds, fixed so that a plain version repeats it
// (ops/gather.py:segment_sum_plain; the two are bit-equal):
//  (1) Tile t is the sorted entries [t * E, (t + 1) * E), E = W * threads;
//      thread i owns the window [t * E + i * W, t * E + (i + 1) * W).
//      Within the window each row's run of entries is summed left to
//      right from 0.0f.
//  (2) Within the tile a row's window pieces are summed left to right:
//      the thread of the first window that holds the row (its "walker")
//      adds the later windows' pieces from shared memory in window order.
//  (3) A row that crosses tiles has its tile pieces summed left to right
//      in tile order by the block of its last tile: each earlier tile
//      publishes its piece (its carry) and raises its flag, and that block
//      waits for the flags, then adds the carries in tile order and its
//      own piece last.  The order is by tile index, never by arrival.
// There is no atomic on the output, so the result is bit-identical from
// run to run (index_add_'s is not).  Every output row is written once: an
// empty row by its owning tile's zero pass (the tile owns the rows whose
// first offset lies in it, the last tile also those at N), a row inside
// one tile by its walker, a crossing row by its last tile's block.
//
// Design.  A thread's W perm entries come as 16-byte loads, then its W
// gathered packs (gather_rows.cuh's Pack: a float2 at d = 2) are all
// requested before the first is added, so W row loads are in flight per
// thread.  The row of the window's first entry comes from the plan
// (window_rows), later rows from the offsets as the window crosses them.
// A row wider than one pack is summed one pack at a time (the column loop
// around the window pass): only d = 2 is on the trainer's path, and the
// other widths keep the same order column by column.  A tile publishes at
// most one carry (the piece of the row that crosses its end), so a carry
// is d elements a tile.  The piece of the row that came in from earlier
// tiles and ends in this one ("own", summed by thread 0, whose window
// starts the tile, and added last by the same thread) is d elements a
// tile too.  The carries live in the plan's global scratch ([2, tiles, d]:
// the carries, then room for the own pieces).  Own lives in shared memory
// beside the window heads while it takes at most kOwnSharedBytes (d <=
// 2,048 floats or 1,024 doubles), and in the scratch's second half beyond
// that, so no width needs more than 16 KB of shared memory: an earlier
// revision kept own in shared memory at every width, which capped d below
// 4,096 under the default 48 KB (raising the block's limit would still cap
// it near 55,000 floats).  The placement is a template argument: on an
// H100 (readout_sweep of the shared-memory-only revision and this one in
// turns, the dblp readout at f32 d = 2, on the card alone), own in global
// memory at every width cost the path readout 4.6 % (0.0263 against
// 0.0252 ms), and a placement chosen at run time, through one generic
// pointer, 3.4 % (and the label lookup 3.2 %); as a template argument the
// two are within 0.3 % and 1.3 % of the earlier revision.  Own is written
// before it is read in every launch, so it needs no clearing.
//
// Blocks take their tiles in launch order from a counter, so the tiles a
// block waits for belong to blocks already running (the single-pass
// scan's rule); the wait gives up with a trap after 2^25 polls (seconds)
// instead of hanging.  The block that takes the last tile puts the
// counter back to 0 and each waiting block clears the flags it read, so
// flags and counter are zero after every launch, and a CUDA graph replays
// it; a plan's launches must stay on one stream, in order.  A first
// design summed every crossing row in the last block to finish (a
// ticket): on an H100 at the dblp shapes it took 0.0106-0.0137 ms
// (labels) and 0.0254-0.0290 ms (paths) on the card against this one's
// 0.0096 and 0.0251 (readout_sweep).
//
// W and threads were chosen with python -m
// gnnpe_tpu_torch.kernels.readout_sweep (ops/gather.py says which run).
//
// Limits.  N < 2^31 and R < 2^31 (perm, offsets and the row ids are
// int32); d >= 1, with no upper bound but memory.  Every address that
// scales with N * d or R * d (the gathers, the three kinds of store, the
// carries and the own pieces) is computed in 64 bits, so N * d and R * d
// may pass 2^31.  An empty index (N = 0) is one tile with no entries, and
// its zero pass writes every row, so it is one launch like any other.
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
constexpr int kUnroll = 8;
constexpr long long kMaxSpins = 1LL << 25;   // polls of 32 ns and more
constexpr long long kOwnSharedBytes = 8192;  // own in shared memory up to

// Mirrored by ops/gather.py:_SegmentPlan (ctypes).
struct SegmentPlan {
  const int* perm;          // [n]
  const int* offsets;       // [rows + 1]
  const int* window_rows;   // [ceil(n / window)]
  const int* tile_rows;     // [tiles + 1]
  void* carry;              // [2, tiles, d] of g's type: carries, own pieces
                            // (those past kOwnSharedBytes)
  int* flags;               // [tiles], zero between launches
  unsigned int* counter;    // [1], zero between launches
  long long n;
  int rows;
  int window;
  int threads;
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
__device__ __forceinline__ Pack<T, VEC> shfl_pack(const Pack<T, VEC>& v,
                                                  int lane) {
  Pack<T, VEC> out;
#pragma unroll
  for (int e = 0; e < VEC; ++e) {
    out.e[e] = __shfl_sync(0xffffffffu, v.e[e], lane);
  }
  return out;
}

// OWN_SHARED: the own piece lives in shared memory after the window heads
// (d * sizeof(T) <= kOwnSharedBytes), else in the scratch's second half;
// a template argument, so that each kernel knows its address space.
template <typename T, int VEC, int W, bool OWN_SHARED>
__global__ void __launch_bounds__(kMaxThreads)
segment_sum_kernel(const SegmentPlan p, const T* __restrict__ g,
                   T* __restrict__ out, int d) {
  extern __shared__ __align__(16) unsigned char smem[];
  Pack<T, VEC>* head = reinterpret_cast<Pack<T, VEC>*>(smem);
  __shared__ int s_tile;

  const int threads = blockDim.x;
  const int i = threadIdx.x;
  if (i == 0) {
    s_tile = (int)atomicAdd(p.counter, 1u);
    if (s_tile == p.tiles - 1) *p.counter = 0u;  // every tile is taken
  }
  __syncthreads();
  const int t = s_tile;
  const long long tile = (long long)threads * W;
  const long long base = t * tile;
  const long long tile_end = min(base + tile, p.n);
  const long long a = base + (long long)i * W;
  const long long b = min(a + W, tile_end);
  const bool has = a < b;
  const int* __restrict__ offsets = p.offsets;

  // The empty rows this tile owns.
  const int own_lo = __ldg(p.tile_rows + t);
  const int own_hi = __ldg(p.tile_rows + t + 1);
  for (int r = own_lo + i; r < own_hi; r += threads) {
    if (__ldg(offsets + r) == __ldg(offsets + r + 1)) {
      for (int c = 0; c < d; c += VEC) {
        store_pack<T, VEC>(out + (long long)r * d + c, zero_pack<T, VEC>());
      }
    }
  }

  int q[W];
  if (has) {
    if (b - a == W && W % 4 == 0) {
#pragma unroll
      for (int k = 0; k < W / 4; ++k) {
        const int4 v = __ldg(reinterpret_cast<const int4*>(p.perm + a) + k);
        q[4 * k] = v.x; q[4 * k + 1] = v.y; q[4 * k + 2] = v.z;
        q[4 * k + 3] = v.w;
      }
    } else {
#pragma unroll
      for (int k = 0; k < W; ++k) q[k] = a + k < b ? __ldg(p.perm + a + k) : 0;
    }
  }
  const int row0 = has ? __ldg(p.window_rows + a / W) : 0;
  T* const scratch = static_cast<T*>(p.carry);
  T* const carry = scratch + (long long)t * d;
  T* const own = OWN_SHARED ? reinterpret_cast<T*>(head + threads)
                            : scratch + ((long long)p.tiles + t) * d;
  bool published = false;

  for (int c0 = 0; c0 < d; c0 += VEC) {
    Pack<T, VEC> v[W];
#pragma unroll
    for (int k = 0; k < W; ++k) {
      if (a + k < b) v[k] = load_pack<T, VEC>(g + (long long)q[k] * d + c0);
    }
    bool pending = false;
    int prow = 0;
    long long pbegin = 0, pend = 0;
    Pack<T, VEC> pacc = zero_pack<T, VEC>();
    if (has) {
      int r = row0;
      long long r_begin = __ldg(offsets + r), r_end = __ldg(offsets + r + 1);
      bool first = true;
      Pack<T, VEC> acc = zero_pack<T, VEC>();
      // A run that ends inside the window: published for its walker, the
      // tile's piece of a row that started in an earlier tile, or a row.
      auto finish = [&]() {
        if (first && i > 0 && r_begin < a) {
          head[i] = acc;
        } else if (first && r_begin < base) {
          store_pack<T, VEC>(own + c0, acc);
        } else {
          store_pack<T, VEC>(out + (long long)r * d + c0, acc);
        }
      };
#pragma unroll
      for (int k = 0; k < W; ++k) {
        if (a + k < b) {
          if (a + k >= r_end) {
            finish();
            do {
              ++r;
              r_begin = r_end;
              r_end = __ldg(offsets + r + 1);
            } while (r_end <= a + k);
            acc = zero_pack<T, VEC>();
            first = false;
          }
          add_pack(acc, v[k]);
        }
      }
      if (r_end <= b) {
        finish();
      } else if (first && i > 0 && r_begin < a) {
        head[i] = acc;          // the whole window, inside an earlier row
      } else {
        pending = true;         // this thread walks the row on
        prow = r;
        pbegin = r_begin;
        pend = r_end;
        pacc = acc;
      }
    }
    __syncthreads();
    if (pending) {
      // The later windows of the tile that hold the row, in order.
      const long long stop = min(pend, tile_end);
      const int windows = (int)((stop - base + W - 1) / W);
      for (int k = i + 1; k < windows; k += kUnroll) {
        Pack<T, VEC> h[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          if (k + u < windows) h[u] = head[k + u];
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          if (k + u < windows) add_pack(pacc, h[u]);
        }
      }
      if (pend > tile_end) {
        store_pack<T, VEC>(carry + c0, pacc);   // for a later tile
        published = true;
      } else if (pbegin < base) {
        store_pack<T, VEC>(own + c0, pacc);
      } else {
        store_pack<T, VEC>(out + (long long)prow * d + c0, pacc);
      }
    }
    __syncthreads();  // head is written again for the next columns
  }
  if (published) {
    __threadfence();
    atomicExch(p.flags + t, 1);
  }

  // The row that came in from earlier tiles and ends here: warp 0 waits
  // for their carries, adds them in tile order and this tile's piece last
  // (thread 0 wrote that piece to own above).
  if (i >= 32 || base >= p.n || base == 0) return;
  const int in_row = __ldg(p.window_rows + base / W);
  const long long in_begin = __ldg(offsets + in_row);
  if (in_begin >= base || __ldg(offsets + in_row + 1) > tile_end) return;
  const int t0 = (int)(in_begin / tile);
  for (int s = t0 + i; s < t; s += 32) {
    long long spins = 0;
    while (*(volatile int*)(p.flags + s) == 0) {
      if (++spins > kMaxSpins) __trap();
      __nanosleep(32);
    }
  }
  __syncwarp();
  __threadfence();
  for (int c0 = 0; c0 < d; c0 += VEC) {
    Pack<T, VEC> acc = zero_pack<T, VEC>();
    for (int s0 = t0; s0 < t; s0 += 32) {
      Pack<T, VEC> mine = zero_pack<T, VEC>();
      if (s0 + i < t) {
        mine = load_pack_l2<T, VEC>(scratch + (long long)(s0 + i) * d + c0);
      }
      const int m = min(32, t - s0);
      for (int u = 0; u < m; ++u) add_pack(acc, shfl_pack<T, VEC>(mine, u));
    }
    if (i == 0) {
      add_pack(acc, *reinterpret_cast<const Pack<T, VEC>*>(own + c0));
      store_pack<T, VEC>(out + (long long)in_row * d + c0, acc);
    }
  }
  // Each flag is read by this warp alone: clear it for the next launch.
  for (int s = t0 + i; s < t; s += 32) p.flags[s] = 0;
}

template <typename T, int VEC, bool OWN_SHARED>
int launch_own(const SegmentPlan& p, const T* g, T* out, int d,
               cudaStream_t stream) {
  const size_t shared = (size_t)p.threads * VEC * sizeof(T)
                        + (OWN_SHARED ? (size_t)d * sizeof(T) : 0);
  const unsigned blocks = (unsigned)p.tiles;
#define GNNPE_SEGMENT_CASE(W)                                              \
  case W:                                                                  \
    segment_sum_kernel<T, VEC, W, OWN_SHARED>                              \
        <<<blocks, p.threads, shared, stream>>>(p, g, out, d);             \
    break;
  switch (p.window) {
    GNNPE_SEGMENT_CASE(4)
    GNNPE_SEGMENT_CASE(8)
    GNNPE_SEGMENT_CASE(16)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef GNNPE_SEGMENT_CASE
  return (int)cudaGetLastError();
}

template <typename T, int VEC>
int launch_vec(const SegmentPlan& p, const T* g, T* out, int d,
               cudaStream_t stream) {
  if ((long long)d * sizeof(T) <= kOwnSharedBytes) {
    return launch_own<T, VEC, true>(p, g, out, d, stream);
  }
  return launch_own<T, VEC, false>(p, g, out, d, stream);
}

// One launch over plan->tiles blocks of plan->threads threads (a multiple
// of 32 up to 512), each summing window * threads sorted entries.  vec is
// the elements per pack (4, 2 or 1 for float, 2 or 1 for double: 16 bytes
// at most; d and the alignment of g, out and the scratch must be multiples
// of it); the shared memory is threads * vec elements (at most 8 KB) and
// own where it fits kOwnSharedBytes.
template <typename T>
int launch(int device, const void* plan, const void* g, void* out, int d,
           int vec, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const SegmentPlan& p = *(const SegmentPlan*)plan;
  if (p.threads < 32 || p.threads > kMaxThreads || p.threads % 32
      || p.tiles < 1 || p.rows < 1 || d < 1 || p.n < 0
      || (long long)p.tiles * p.threads * p.window < p.n) {
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
