// Padded-CSR neighbour aggregation on Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/segment_reduce/kernel.py::csr_aggregate
// and computes the same function:
//   out[r, s] = sum_k wgt[r, k] * F[nbr[r, k], s]        (f32 accumulation)
// with nbr (M, D) int32, wgt (M, D) and F (N, S) both f32 or both bf16,
// and out (M, S) in F's dtype (one rounding).  It is the aggregate of the
// GCN forward: one launch per layer over the symmetric-normalised padded
// CSR (at ogb_products M = N = 2,449,029, D = 89, S = 100 then 16).
//
// Bound on this card: 2 operations per slot and column against one read
// of F, nbr, wgt and one write of out; at the GCN's widths the bytes are
// the larger term (about 1.1 ms for S = 100 at 3.35 TB/s, see PERF.md).
// In practice every live slot gathers its F row again (F is about 1 GB
// against a 50 MB L2), so the gathers set the time.
//
// Design.  The Pallas kernel keeps an (N, 128) F panel resident in VMEM,
// which caps N at 16,384; here F rows are gathered from device memory /
// L2 and N is unbounded.  Pull model, no atomics: one group of `lanes`
// threads owns one output row and walks its slots in order, so every
// output element is written once and two launches are byte-identical.
// The group loads `lanes` nbr/wgt slots at a time (one coalesced load
// each) and broadcasts them with warp shuffles, so no shared memory and
// no block barrier is needed.  Each lane owns CPL columns spaced `lanes`
// apart; a gathered F row is then one coalesced segment per group.
//
// The thread layout follows S, so narrow widths keep every lane busy
// (csr_round.cu's one-column-per-thread layout would leave 28 of 128
// threads idle at S = 100 and 112 at S = 16):
//   S <= 32:  lanes = next power of two >= S, CPL = 1, 32 / lanes rows per
//             warp.  At S = 16: 2 rows per warp, 16 per 256-thread block,
//             every lane holds a live column (100 %).
//   S  > 32:  lanes = 32 (one row per warp), CPL = 2 up to S = 64, else 4,
//             and grid.y tiles of 32 * CPL columns.  At S = 100: one tile
//             of 128 columns, 100 live (78 % of the lane-columns).
// Padding slots name node 0 with weight 0 and are summed like any other
// slot (0 * F[0]); they are not skipped by testing the weight, so a NaN
// or Inf in F[0] propagates exactly as in the reference's einsum.
// Ragged M, D and S are masked in the kernel; nothing is padded on the
// host.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

template <typename T, int CPL>
__global__ void __launch_bounds__(kThreads)
    csr_aggregate_kernel(const int* __restrict__ nbr,
                         const T* __restrict__ wgt, const T* __restrict__ F,
                         T* __restrict__ out, int M, int D, int S,
                         int lane_shift) {
  const int lanes = 1 << lane_shift;
  const int sub = threadIdx.x & (lanes - 1);  // lane within the row group
  const long long row =
      static_cast<long long>(blockIdx.x) * (kThreads >> lane_shift) +
      (threadIdx.x >> lane_shift);
  const bool live = row < M;
  const size_t slab = static_cast<size_t>(live ? row : 0) * D;
  const int col0 = blockIdx.y * (lanes * CPL) + sub;
  float acc[CPL];
#pragma unroll
  for (int j = 0; j < CPL; ++j) acc[j] = 0.0f;
  // Every lane of the warp runs the same loop trip counts (they depend
  // on D only), so the full-mask shuffles below are always convergent.
  for (int k0 = 0; k0 < D; k0 += lanes) {
    const int kn = min(lanes, D - k0);
    int my_nbr = 0;
    float my_wgt = 0.0f;
    if (live && sub < kn) {
      my_nbr = nbr[slab + k0 + sub];
      my_wgt = to_f32(wgt[slab + k0 + sub]);
    }
#pragma unroll 4
    for (int k = 0; k < kn; ++k) {
      const int v = __shfl_sync(kFull, my_nbr, k, lanes);
      const float w = __shfl_sync(kFull, my_wgt, k, lanes);
      const T* frow = F + static_cast<size_t>(v) * S;
#pragma unroll
      for (int j = 0; j < CPL; ++j) {
        const int col = col0 + j * lanes;
        if (col < S) acc[j] = fmaf(w, to_f32(frow[col]), acc[j]);
      }
    }
  }
  if (live) {
    T* orow = out + static_cast<size_t>(row) * S;
#pragma unroll
    for (int j = 0; j < CPL; ++j) {
      const int col = col0 + j * lanes;
      if (col < S) store(orow + col, acc[j]);
    }
  }
}

template <typename T>
void launch(const void* nbr, const void* wgt, const void* F, void* out,
            int M, int D, int S, cudaStream_t st) {
  int lane_shift = 5;
  int cpl = S <= 64 ? 2 : 4;
  if (S <= 32) {
    lane_shift = 0;
    while ((1 << lane_shift) < S) ++lane_shift;
    cpl = 1;
  }
  const int rows_per_block = kThreads >> lane_shift;
  const int tile = (1 << lane_shift) * cpl;
  const dim3 grid(
      static_cast<unsigned>((M + rows_per_block - 1LL) / rows_per_block),
      static_cast<unsigned>((S + tile - 1LL) / tile));
  const int* n = static_cast<const int*>(nbr);
  const T* w = static_cast<const T*>(wgt);
  const T* f = static_cast<const T*>(F);
  T* o = static_cast<T*>(out);
  if (cpl == 1) {
    csr_aggregate_kernel<T, 1><<<grid, kThreads, 0, st>>>(n, w, f, o, M, D, S,
                                                          lane_shift);
  } else if (cpl == 2) {
    csr_aggregate_kernel<T, 2><<<grid, kThreads, 0, st>>>(n, w, f, o, M, D, S,
                                                          lane_shift);
  } else {
    csr_aggregate_kernel<T, 4><<<grid, kThreads, 0, st>>>(n, w, f, o, M, D, S,
                                                          lane_shift);
  }
}

}  // namespace

extern "C" int csr_aggregate_launch(const void* nbr, const void* wgt,
                                    const void* F, void* out, int M, int D,
                                    int S, int bf16, int device,
                                    void* stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16) {
    launch<__nv_bfloat16>(nbr, wgt, F, out, M, D, S, st);
  } else {
    launch<float>(nbr, wgt, F, out, M, D, S, st);
  }
  return static_cast<int>(cudaGetLastError());
}
