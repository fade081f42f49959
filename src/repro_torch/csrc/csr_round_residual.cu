// Fused DHLP-2 superstep for one blocked-CSR width bucket, on Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/segment_reduce/kernel.py::csr_round_residual
// and computes the same function:
//   out[r, s]   = c * base[r, s] + sum_k wgt[r, k] * F[nbr[r, k], s]   (f32 acc)
//   delta[b, s] = max over the rows r of row block b of |out[r, s] - prev[r, s]|
// with nbr (M, D) int32, wgt (M, D) and F (N, S) both f32 or both bf16,
// base/prev/out (M, S) f32 and delta (gridDim.x, S) f32.
//
// Bound on this card: a sparse gather-FMA does 2 operations per nonzero
// and column and has to move at least each F row, each base/prev/out
// element and each nbr/wgt slot once; at the main path's shapes (S = 4396
// label columns) the f32 operation count is the larger term (see PERF.md).
// In practice each F row is re-read from L2 once per slot that names it,
// and that traffic is what limits the kernel.
//
// Design.  The Pallas kernel keeps the whole (N, bs) F panel resident in
// VMEM (16 MB); an SM has 227 KB of shared memory, so this kernel gathers
// F rows from device memory / L2 instead and has no node-count limit.
// Grid = (row blocks, column tiles of 128).  Each of the 128 threads owns
// one column, so every gathered F row is read as one coalesced 512-byte
// (f32) segment per block.  Blocks that run together share a column tile,
// so the F slice they gather stays in L2.  (Four columns per thread with
// 16-byte loads was measured 2.2x slower at the main path's shapes: a
// quarter of the blocks leaves too few warps to hide the gathers' L2
// latency.)  The block stages each row's nbr/wgt slab in shared memory
// (128 slots per pass) and broadcasts it to all threads.  The residual is
// a per-row-block partial written without atomics; the caller reduces it
// over blocks, so results are bit-identical from run to run.  Ragged M
// and S are masked in the kernel; nothing is padded on the host.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kCols = 128;  // columns per block == threads per block
constexpr int kSlab = kCols;  // nbr/wgt slots staged per pass

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__global__ void __launch_bounds__(kCols)
    csr_round_residual_kernel(const int* __restrict__ nbr,
                              const T* __restrict__ wgt,
                              const T* __restrict__ F,
                              const float* __restrict__ base,
                              const float* __restrict__ prev,
                              float* __restrict__ out,
                              float* __restrict__ delta, int M, int D, int S,
                              int rows_per_block, float c) {
  __shared__ int s_nbr[kSlab];
  __shared__ float s_wgt[kSlab];
  const int col = blockIdx.y * kCols + threadIdx.x;
  const bool live = col < S;
  const int r0 = blockIdx.x * rows_per_block;
  const int r1 = min(r0 + rows_per_block, M);
  float dmax = 0.0f;
  for (int r = r0; r < r1; ++r) {
    const int* nrow = nbr + static_cast<size_t>(r) * D;
    const T* wrow = wgt + static_cast<size_t>(r) * D;
    float acc = 0.0f;
    for (int k0 = 0; k0 < D; k0 += kSlab) {
      const int kn = min(kSlab, D - k0);
      __syncthreads();  // every thread is done with the previous slab
      if (threadIdx.x < kn) {
        s_nbr[threadIdx.x] = nrow[k0 + threadIdx.x];
        s_wgt[threadIdx.x] = to_f32(wrow[k0 + threadIdx.x]);
      }
      __syncthreads();
      if (live) {
#pragma unroll 8
        for (int k = 0; k < kn; ++k) {
          const float f = to_f32(F[static_cast<size_t>(s_nbr[k]) * S + col]);
          acc = fmaf(s_wgt[k], f, acc);
        }
      }
    }
    if (live) {
      const size_t o = static_cast<size_t>(r) * S + col;
      const float v = c * base[o] + acc;
      out[o] = v;
      const float d = fabsf(v - prev[o]);
      // a NaN residual must keep its column active, as a max that
      // propagates NaN does in the reference
      dmax = (d > dmax || d != d) ? d : dmax;
    }
  }
  if (live) delta[static_cast<size_t>(blockIdx.x) * S + col] = dmax;
}

}  // namespace

extern "C" int csr_round_residual_launch(const void* nbr, const void* wgt,
                                         const void* F, const void* base,
                                         const void* prev, void* out,
                                         void* delta, int M, int D, int S,
                                         int rows_per_block, float c, int bf16,
                                         int device, void* stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const dim3 grid((M + rows_per_block - 1) / rows_per_block,
                  (S + kCols - 1) / kCols);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16) {
    csr_round_residual_kernel<__nv_bfloat16><<<grid, kCols, 0, st>>>(
        static_cast<const int*>(nbr), static_cast<const __nv_bfloat16*>(wgt),
        static_cast<const __nv_bfloat16*>(F), static_cast<const float*>(base),
        static_cast<const float*>(prev), static_cast<float*>(out),
        static_cast<float*>(delta), M, D, S, rows_per_block, c);
  } else {
    csr_round_residual_kernel<float><<<grid, kCols, 0, st>>>(
        static_cast<const int*>(nbr), static_cast<const float*>(wgt),
        static_cast<const float*>(F), static_cast<const float*>(base),
        static_cast<const float*>(prev), static_cast<float*>(out),
        static_cast<float*>(delta), M, D, S, rows_per_block, c);
  }
  return static_cast<int>(cudaGetLastError());
}
