// CSR neighbour-sum SpMM for Hopper (sm_90a):  nx[v] = sum_{u in N(v)} x[u],
// optionally vde[v] = x[v] + nx[v] in the same pass.
//
// Replaces the TPU kernel experiments/pallas_spmm.py:_spmm_kernel (launched
// by spmm_pallas_prepared), which tiled 256 output rows in VMEM and fetched
// every x[src] row with its own DMA.  Here it is the VDE hop of the exact
// online query (gnnpe_tpu_torch/embed/vde.py), run on the data graph and on
// every query graph.
//
// Design: bit-exactness decides it.  The host reference
// (gnnpe_tpu/ops/spmm.py:neighbor_sum_np) adds strictly left to right, in
// ascending neighbour order, starting from 0.0.  So each output element
// (v, c) belongs to one thread, which walks row v's CSR slice in order.
// There is no tree reduction, no warp-shuffle sum and no atomic, and an
// add-only loop leaves nothing for the compiler to contract into an FMA.
// The f64 result is therefore bit-equal to the host's, which keeps PDE,
// candidates and answer counts exact on the card.  Consecutive threads take
// consecutive (v, c), so the D columns of one gathered row are read by
// neighbouring threads.
//
// Bound: the random x-row reads, E*D*sizeof(T) bytes.  At the dblp rung in
// f64 with D=2 that is 2.1M arcs * 2 * 8 B, about 34 MB.  Faster forms that
// keep the ascending order (a warp per row, vector loads) are later work.
//
// C ABI for ctypes: pointers and the stream are void*; the return value is
// cudaGetLastError() after the launch (0 = launched).

#include <cuda_runtime.h>

namespace {

template <typename T>
__global__ void spmm_csr_kernel(const int* __restrict__ offsets,
                                const int* __restrict__ neighbors,
                                const T* __restrict__ x,
                                T* __restrict__ nx,
                                T* __restrict__ vde,
                                long long n_rows, int d) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_rows * d) return;
  const long long v = i / d;
  const int c = (int)(i - v * d);
  const int lo = offsets[v];
  const int hi = offsets[v + 1];
  T acc = T(0);
  for (int j = lo; j < hi; ++j) {
    acc += x[(long long)neighbors[j] * d + c];
  }
  nx[i] = acc;
  if (vde != nullptr) vde[i] = x[i] + acc;
}

template <typename T>
int launch(int device, const void* offsets, const void* neighbors,
           const void* x, void* nx, void* vde, long long n_rows, int d,
           void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int threads = 256;
  const long long total = n_rows * d;
  const long long blocks = (total + threads - 1) / threads;
  spmm_csr_kernel<T><<<(unsigned int)blocks, threads, 0,
                       (cudaStream_t)stream>>>(
      (const int*)offsets, (const int*)neighbors, (const T*)x, (T*)nx,
      (T*)vde, n_rows, d);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int gnnpe_spmm_csr_f64(int device, const void* offsets,
                                  const void* neighbors, const void* x,
                                  void* nx, void* vde, long long n_rows,
                                  int d, void* stream) {
  return launch<double>(device, offsets, neighbors, x, nx, vde, n_rows, d,
                        stream);
}

extern "C" int gnnpe_spmm_csr_f32(int device, const void* offsets,
                                  const void* neighbors, const void* x,
                                  void* nx, void* vde, long long n_rows,
                                  int d, void* stream) {
  return launch<float>(device, offsets, neighbors, x, nx, vde, n_rows, d,
                       stream);
}
