// ELL gather-sum with the pad correction for Hopper (sm_90a):
//   out[i, c] = (sum_{k<W} buf[tbl[i, k], c]) - padcnt[i] * buf[0, c]
// over an int32 table tbl [N, W] whose pad slots point at row 0, an
// optional f32 padcnt [N] (the number of pad slots per row) and an f32
// buf [R, D].
//
// Replaces the TPU kernel experiments/pallas_blocked_spmm.py:kernel
// (launched by blocked_gather_sum), which DMAd every gathered row into
// double-buffered VMEM tiles of 128 table rows.  It is the body of
// gnnpe_tpu/ops/ell.py:BinnedEll._gather_sum, so here it carries every
// table of the degree-binned layout (gnnpe_tpu_torch/ops/ell.py): the
// forward of fit(aggregation="binned") and, because the adjacency is
// symmetric, its backward too.
//
// Design: simple and bit-equal to the plain version (ops/ell.py:
// gather_sum_plain).  One thread per output element (i, c) adds its row's
// W slots in ascending k from 0.0f, then subtracts the correction.
// Consecutive threads take consecutive c, so the D columns of one gathered
// row are read by neighbouring threads.  The correction is written with
// __fmul_rn / __fsub_rn: nvcc would otherwise contract acc - p * x0 into
// one FMA, rounding once where the plain version (a multiply, then a
// subtract) rounds twice.  The file is built with the default -fmad=true;
// the two intrinsics are never contracted.
//
// Bound: the random buf-row reads, num_slots * D * 4 bytes per call.  On
// the dblp rung's layout (3,076,584 slots) that is about 24.6 MB at the
// trainer's D = 2 and about 1.58 GB at D = 128.  A warp per row,
// shared-memory staging of the table or TMA are later work.
//
// The caller may pass `out` pointing into a row range of a larger [V, D]
// output, so each width class of the layout writes its rows in place.
//
// C ABI for ctypes: pointers and the stream are void*; the return value is
// cudaGetLastError() after the launch (0 = launched).

#include <cuda_runtime.h>

namespace {

__global__ void ell_gather_sum_kernel(const int* __restrict__ tbl,
                                      const float* __restrict__ padcnt,
                                      const float* __restrict__ buf,
                                      float* __restrict__ out,
                                      long long n_rows, int width, int d) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_rows * d) return;
  const long long r = i / d;
  const int c = (int)(i - r * d);
  const int* row = tbl + r * width;
  float acc = 0.0f;
  for (int k = 0; k < width; ++k) {
    acc += buf[(long long)row[k] * d + c];
  }
  if (padcnt != nullptr) {
    acc = __fsub_rn(acc, __fmul_rn(padcnt[r], buf[c]));
  }
  out[i] = acc;
}

}  // namespace

extern "C" int gnnpe_ell_gather_sum_f32(int device, const void* tbl,
                                        const void* padcnt, const void* buf,
                                        void* out, long long n_rows,
                                        int width, int d, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int threads = 256;
  const long long total = n_rows * d;
  const long long blocks = (total + threads - 1) / threads;
  ell_gather_sum_kernel<<<(unsigned int)blocks, threads, 0,
                          (cudaStream_t)stream>>>(
      (const int*)tbl, (const float*)padcnt, (const float*)buf,
      (float*)out, n_rows, width, d);
  return (int)cudaGetLastError();
}
