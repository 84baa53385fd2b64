// Shared device code of the two gather-sum kernels (ell_gather_sum.cu,
// spmm_csr.cu): both compute, for one output row, the sum of gathered
// rows of a row-major matrix x [R, d],
//   acc[c] = x[idx[0], c] + x[idx[1], c] + ... + x[idx[count-1], c],
// in ascending slot order from 0.0 with one accumulator per column and
// add-only arithmetic (nothing to contract into an FMA), so the result is
// bit-equal to the plain PyTorch versions whatever the tiling.
//
// A row belongs to a group of G neighbouring lanes (G a power of two up
// to 32).  Lane g of the group owns the VEC columns [c, c + VEC) with
// c = c0 + g * VEC, one pack of at most 16 bytes (float4, float2, float,
// double2 or double), so a gathered row is read by one vector load per
// lane and the group's loads of one row are contiguous.  The row's
// indices are read once by the group, coalesced (lane g takes slots g,
// g + G, ...), and handed round with __shfl_sync; the next chunk of
// indices is requested before the current chunk's rows are added.  The
// shuffles name the whole warp: every lane of a warp makes the same trips
// (to the longest row of the warp, which it would wait for anyway) and
// only the loads and adds are predicated, because a shuffle whose mask
// differs from group to group splits the warp into groups that then run
// one after another (measured: 2 to 4 times slower).  The loads of U
// gathered rows are issued back to back into registers before the first
// of them is added, so U row loads are in flight per lane; the adds then
// run in slot order.  A lane that has a row to itself (G = 1) needs no
// shuffle and runs its own loop of S rows at a time.
//
// What bounds a narrow row (a lane or two per row) is not bytes but the
// load unit: every gathered row and every index read by a lane is a cache
// line of its own to the SM's L1, which takes about one line a cycle.  So
// with one lane per row the indices come as 16-byte loads (four at a
// time) where the caller vouches for the alignment (idx16), and both
// kernels deal their warps' rows out across the blocks so that no SM is
// left with all the long rows.

#pragma once

#include <cuda_runtime.h>

namespace gather_rows {

// Gathered rows requested before the first is added: per lane of a group
// (U) and per lane that has a row to itself (S).  Measured on an H100 at
// the dblp rung: deeper (8, 16) was no faster at any width and slower at
// 128 columns, where the registers cost resident warps.
constexpr int kRowsInFlight = 4;
constexpr int kSerialUnroll = 4;

template <int BYTES> struct Raw;
template <> struct Raw<4> { using type = unsigned int; };
template <> struct Raw<8> { using type = uint2; };
template <> struct Raw<16> { using type = uint4; };

// VEC consecutive columns of one row, loaded and stored as one word.
template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Pack {
  T e[VEC];
};

template <typename T, int VEC>
__device__ __forceinline__ Pack<T, VEC> load_pack(const T* p) {
  using R = typename Raw<sizeof(T) * VEC>::type;
  Pack<T, VEC> out;
  *reinterpret_cast<R*>(&out) = __ldg(reinterpret_cast<const R*>(p));
  return out;
}

template <typename T, int VEC>
__device__ __forceinline__ void store_pack(T* p, const Pack<T, VEC>& v) {
  using R = typename Raw<sizeof(T) * VEC>::type;
  *reinterpret_cast<R*>(p) = *reinterpret_cast<const R*>(&v);
}

template <typename T, int VEC>
__device__ __forceinline__ Pack<T, VEC> zero_pack() {
  Pack<T, VEC> out;
#pragma unroll
  for (int i = 0; i < VEC; ++i) out.e[i] = T(0);
  return out;
}

template <typename T, int VEC>
__device__ __forceinline__ void add_pack(Pack<T, VEC>& acc,
                                         const Pack<T, VEC>& v) {
#pragma unroll
  for (int i = 0; i < VEC; ++i) acc.e[i] += v.e[i];
}

// The chunk of C indices from slot k0 on, R of them to each lane: lane g
// holds slots k0 + g, k0 + g + G, ...; slots past count read as 0.
template <int G, int R>
__device__ __forceinline__ void load_indices(int (&reg)[R],
                                             const int* __restrict__ idx,
                                             int k0, int count, int g) {
#pragma unroll
  for (int t = 0; t < R; ++t) {
    const int k = k0 + t * G + g;
    reg[t] = k < count ? __ldg(idx + k) : 0;
  }
}

// acc += sum over k < count, in ascending k, of the pack at columns
// [c, c + VEC) of row idx[k] of x.  All 32 lanes of the warp call it
// together; the lanes of a group with the same idx and count (0 for a
// group without a row), and all with the same warp_count >= every
// group's count.  g is the lane's place in the group; col_ok says whether
// the lane's columns exist (c < d).  idx16 (one lane per row only): idx is
// 16-byte aligned and count a multiple of 4, so four indices come as one
// 16-byte load.
template <typename T, int VEC, int G>
__device__ __forceinline__ void gather_add(Pack<T, VEC>& acc,
                                           const int* __restrict__ idx,
                                           int count, int warp_count,
                                           const T* __restrict__ x,
                                           long long d, int c, bool col_ok,
                                           int g, bool idx16 = false) {
  if constexpr (G == 1) {
    // One lane per row: its own loop (no shuffles, so each lane stops at
    // its row's end), S rows at a time, and few registers, so that many
    // warps are resident: this shape lives on latency.
    constexpr int S = kSerialUnroll;
    for (int k = 0; k < count; k += S) {
      int id[S];
      if (S == 4 && idx16) {
        const int4 q = __ldg(reinterpret_cast<const int4*>(idx + k));
        id[0] = q.x; id[1] = q.y; id[2] = q.z; id[3] = q.w;
      } else {
#pragma unroll
        for (int u = 0; u < S; ++u) {
          id[u] = k + u < count ? __ldg(idx + k + u) : 0;
        }
      }
      Pack<T, VEC> v[S];
#pragma unroll
      for (int u = 0; u < S; ++u) {
        if (col_ok && k + u < count) {
          v[u] = load_pack<T, VEC>(x + (long long)id[u] * d + c);
        }
      }
#pragma unroll
      for (int u = 0; u < S; ++u) {
        if (col_ok && k + u < count) add_pack(acc, v[u]);
      }
    }
    return;
  }
  constexpr int U = kRowsInFlight;
  constexpr int C = G > U ? G : U;  // indices per chunk
  constexpr int R = C / G;          // of which each lane holds R

  int cur[R];
  load_indices<G, R>(cur, idx, 0, count, g);
  for (int k0 = 0; k0 < warp_count; k0 += C) {
    int nxt[R];
    load_indices<G, R>(nxt, idx, k0 + C, count, g);
#pragma unroll
    for (int b = 0; b < C / U; ++b) {
      if (k0 + b * U >= warp_count) break;  // the same for the whole warp
      Pack<T, VEC> v[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int j = b * U + u;
        int row = cur[j / G];
        if constexpr (G > 1) row = __shfl_sync(0xffffffffu, row, j % G, G);
        if (col_ok && k0 + j < count) {
          v[u] = load_pack<T, VEC>(x + (long long)row * d + c);
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (col_ok && k0 + b * U + u < count) add_pack(acc, v[u]);
      }
    }
#pragma unroll
    for (int t = 0; t < R; ++t) cur[t] = nxt[t];
  }
}

}  // namespace gather_rows
