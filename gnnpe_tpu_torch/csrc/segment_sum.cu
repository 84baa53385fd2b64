// Fixed-order segment sum for Hopper (sm_90a): the backward of a fixed
// row gather y = x.index_select(0, idx), one launch a call,
//   out[r, c] = sum_{j = offsets[r]}^{offsets[r+1]-1} g[perm[j], c],
// where perm [N] is the stable argsort of idx and offsets [R+1] the CSR row
// pointer of the transposed index (bincount, then cumsum).  Rows that no
// entry names are 0.0.  f32 g [N, d] and out [R, d], row-major.
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
// Bound: bytes.  Per entry the cotangent row is read once (d * 4 B) and
// perm once (4 B); per output row one row is written (d * 4 B).  At the
// trainer's d = 2 the path readout (1,500,000 entries into 317,080 rows)
// must move 20.5 MB, 6.1 us at 3.35 TB/s.  What the kernel adds to that:
// the window rows (4 B per W entries), the offsets of the rows it walks
// (4 B a row, mostly from L1) and one carry of d floats a tile.  An 8-byte
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
// around the window pass): only d = 2 is on the timed path, and the other
// widths keep the same order column by column.  A tile publishes at most
// one carry (the piece of the row that crosses its end), so a carry is d
// floats a tile.  Blocks take their tiles in launch order from a counter,
// so the tiles a block waits for belong to blocks already running (the
// single-pass scan's rule); the wait gives up with a trap after 2^25
// polls (seconds) instead of hanging.  The block that takes the last tile
// puts the counter back to 0 and each waiting block clears the flags it
// read, so the scratch is clean after every launch, in a CUDA graph too; a
// plan's launches must stay on one stream, in order.  A first design
// summed every crossing row in the last block to finish (a ticket): on an
// H100 at the dblp shapes it took 0.0106-0.0137 ms (labels) and
// 0.0254-0.0290 ms (paths) on the card against this one's 0.0096 and
// 0.0251 (readout_sweep).
//
// W and threads were chosen with python -m
// gnnpe_tpu_torch.kernels.readout_sweep (ops/gather.py says which run).
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

// Mirrored by ops/gather.py:_SegmentPlan (ctypes).
struct SegmentPlan {
  const int* perm;          // [n]
  const int* offsets;       // [rows + 1]
  const int* window_rows;   // [ceil(n / window)]
  const int* tile_rows;     // [tiles + 1]
  float* carry;             // [tiles, d]
  int* flags;               // [tiles], zero between launches
  unsigned int* counter;    // [1], zero between launches
  long long n;
  int rows;
  int window;
  int threads;
  int tiles;
};

template <int VEC>
__device__ __forceinline__ Pack<float, VEC> load_pack_l2(const float* p) {
  using R = typename gather_rows::Raw<4 * VEC>::type;
  Pack<float, VEC> out;
  *reinterpret_cast<R*>(&out) = __ldcg(reinterpret_cast<const R*>(p));
  return out;
}

template <int VEC>
__device__ __forceinline__ Pack<float, VEC> shfl_pack(const Pack<float, VEC>& v,
                                                      int lane) {
  Pack<float, VEC> out;
#pragma unroll
  for (int e = 0; e < VEC; ++e) {
    out.e[e] = __shfl_sync(0xffffffffu, v.e[e], lane);
  }
  return out;
}

template <int VEC, int W>
__global__ void __launch_bounds__(kMaxThreads)
segment_sum_kernel(const SegmentPlan p, const float* __restrict__ g,
                   float* __restrict__ out, int d) {
  extern __shared__ __align__(16) unsigned char smem[];
  Pack<float, VEC>* head = reinterpret_cast<Pack<float, VEC>*>(smem);
  float* own = reinterpret_cast<float*>(head + blockDim.x);   // [d]
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
        store_pack<float, VEC>(out + (long long)r * d + c,
                               zero_pack<float, VEC>());
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
  float* const carry = p.carry + (long long)t * d;
  bool published = false;

  for (int c0 = 0; c0 < d; c0 += VEC) {
    Pack<float, VEC> v[W];
#pragma unroll
    for (int k = 0; k < W; ++k) {
      if (a + k < b) v[k] = load_pack<float, VEC>(g + (long long)q[k] * d + c0);
    }
    bool pending = false;
    int prow = 0;
    long long pbegin = 0, pend = 0;
    Pack<float, VEC> pacc = zero_pack<float, VEC>();
    if (has) {
      int r = row0;
      long long r_begin = __ldg(offsets + r), r_end = __ldg(offsets + r + 1);
      bool first = true;
      Pack<float, VEC> acc = zero_pack<float, VEC>();
      // A run that ends inside the window: published for its walker, the
      // tile's piece of a row that started in an earlier tile, or a row.
      auto finish = [&]() {
        if (first && i > 0 && r_begin < a) {
          head[i] = acc;
        } else if (first && r_begin < base) {
          store_pack<float, VEC>(own + c0, acc);
        } else {
          store_pack<float, VEC>(out + (long long)r * d + c0, acc);
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
            acc = zero_pack<float, VEC>();
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
        Pack<float, VEC> h[kUnroll];
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
        store_pack<float, VEC>(carry + c0, pacc);   // for a later tile
        published = true;
      } else if (pbegin < base) {
        store_pack<float, VEC>(own + c0, pacc);
      } else {
        store_pack<float, VEC>(out + (long long)prow * d + c0, pacc);
      }
    }
    __syncthreads();  // head is written again for the next columns
  }
  if (published) {
    __threadfence();
    atomicExch(p.flags + t, 1);
  }

  // The row that came in from earlier tiles and ends here: warp 0 waits
  // for their carries, adds them in tile order and this tile's piece last.
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
    Pack<float, VEC> acc = zero_pack<float, VEC>();
    for (int s0 = t0; s0 < t; s0 += 32) {
      Pack<float, VEC> mine = zero_pack<float, VEC>();
      if (s0 + i < t) {
        mine = load_pack_l2<VEC>(p.carry + (long long)(s0 + i) * d + c0);
      }
      const int m = min(32, t - s0);
      for (int u = 0; u < m; ++u) add_pack(acc, shfl_pack<VEC>(mine, u));
    }
    if (i == 0) {
      add_pack(acc, *reinterpret_cast<const Pack<float, VEC>*>(own + c0));
      store_pack<float, VEC>(out + (long long)in_row * d + c0, acc);
    }
  }
  // Each flag is read by this warp alone: clear it for the next launch.
  for (int s = t0 + i; s < t; s += 32) p.flags[s] = 0;
}

template <int VEC>
int launch_vec(const SegmentPlan& p, const float* g, float* out, int d,
               cudaStream_t stream) {
  const size_t shared = (size_t)p.threads * VEC * sizeof(float)
                        + (size_t)d * sizeof(float);
  const unsigned blocks = (unsigned)p.tiles;
#define GNNPE_SEGMENT_CASE(W)                                              \
  case W:                                                                  \
    segment_sum_kernel<VEC, W><<<blocks, p.threads, shared, stream>>>(     \
        p, g, out, d);                                                     \
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

}  // namespace

// One launch over plan->tiles blocks of plan->threads threads (a multiple
// of 32 up to 512), each summing window * threads sorted entries.  vec is
// the columns per pack (4, 2 or 1: d and the alignment of g, out and the
// carry must be multiples of it); the shared memory is threads * vec + d
// floats, under 48 KB for d < 4,096.
extern "C" int gnnpe_segment_sum_f32(int device, const void* plan,
                                     const void* g, void* out, int d,
                                     int vec, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const SegmentPlan& p = *(const SegmentPlan*)plan;
  if (p.threads < 32 || p.threads > kMaxThreads || p.threads % 32
      || p.tiles < 1 || p.rows < 1 || d < 1 || d >= 4096 || p.n < 0
      || (long long)p.tiles * p.threads * p.window < p.n) {
    return (int)cudaErrorInvalidValue;
  }
  const float* gp = (const float*)g;
  float* op = (float*)out;
  cudaStream_t s = (cudaStream_t)stream;
  switch (vec) {
    case 4: return launch_vec<4>(p, gp, op, d, s);
    case 2: return launch_vec<2>(p, gp, op, d, s);
    case 1: return launch_vec<1>(p, gp, op, d, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
