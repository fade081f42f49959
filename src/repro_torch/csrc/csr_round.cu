// Fused LP round for one blocked-CSR width bucket, on Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/segment_reduce/kernel.py::csr_round
// and computes the same function:
//   out[r, s] = c * base[r, s] + sum_k wgt[r, k] * F[nbr[r, k], s]   (f32 acc)
// with nbr (M, D) int32, wgt (M, D) and F (N, S) both f32 or both bf16,
// base (M, S) f32 and out (M, S) in F's dtype.  It is the round of the
// legacy node-order loops (fused_superstep=False): the residual is taken
// by the caller after the inverse permutation, so there is none here.
//
// Bound on this card: 2 operations per slot and column; each F row, each
// base/out element and each nbr/wgt slot has to move at least once.  At
// the legacy path's shapes (S = 4396 label columns) the f32 operation
// count is the larger term (see PERF.md).  In practice each F row is
// re-read from L2 once per slot that names it, padding slots included,
// and that traffic is what limits the kernel.
//
// Design: the scheme of csr_round_residual.cu without the residual.  The
// Pallas kernel keeps the whole (N, bs) F panel resident in VMEM; an SM
// has 227 KB of shared memory, so this kernel gathers F rows from device
// memory / L2 and has no node-count limit.  Grid = (row blocks, column
// tiles of 128).  Each of the 128 threads owns one column, so every
// gathered F row is one coalesced segment per block.  The block stages
// each row's nbr/wgt slab in shared memory (128 slots per pass) and
// broadcasts it to all threads; rows_per_block comes from the width
// (about 4096 slots per block).  No atomics: every output element is
// written by one thread, so two launches give byte-identical results.
// Ragged M and S are masked in the kernel; nothing is padded on the host.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kCols = 128;  // columns per block == threads per block
constexpr int kSlab = kCols;  // nbr/wgt slots staged per pass

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

template <typename T>
__global__ void __launch_bounds__(kCols)
    csr_round_kernel(const int* __restrict__ nbr, const T* __restrict__ wgt,
                     const T* __restrict__ F, const float* __restrict__ base,
                     T* __restrict__ out, int M, int D, int S,
                     int rows_per_block, float c) {
  __shared__ int s_nbr[kSlab];
  __shared__ float s_wgt[kSlab];
  const int col = blockIdx.y * kCols + threadIdx.x;
  const bool live = col < S;
  const int r0 = blockIdx.x * rows_per_block;
  const int r1 = min(r0 + rows_per_block, M);
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
      store(out + o, c * base[o] + acc);
    }
  }
}

}  // namespace

extern "C" int csr_round_launch(const void* nbr, const void* wgt,
                                const void* F, const void* base, void* out,
                                int M, int D, int S, int rows_per_block,
                                float c, int bf16, int device, void* stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const dim3 grid((M + rows_per_block - 1) / rows_per_block,
                  (S + kCols - 1) / kCols);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16) {
    csr_round_kernel<__nv_bfloat16><<<grid, kCols, 0, st>>>(
        static_cast<const int*>(nbr), static_cast<const __nv_bfloat16*>(wgt),
        static_cast<const __nv_bfloat16*>(F), static_cast<const float*>(base),
        static_cast<__nv_bfloat16*>(out), M, D, S, rows_per_block, c);
  } else {
    csr_round_kernel<float><<<grid, kCols, 0, st>>>(
        static_cast<const int*>(nbr), static_cast<const float*>(wgt),
        static_cast<const float*>(F), static_cast<const float*>(base),
        static_cast<float*>(out), M, D, S, rows_per_block, c);
  }
  return static_cast<int>(cudaGetLastError());
}
