// Fused LP round for one blocked-CSR width bucket, on Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/segment_reduce/kernel.py::csr_round
// and computes the same function:
//   out[r, s] = c * base[r, s] + sum_k wgt[r, k] * F[nbr[r, k], s]   (f32 acc)
// with nbr (M, D) int32, wgt (M, D) and F (N, S) both f32 or both bf16,
// base (M, S) f32 and out (M, S) in F's dtype, rounded once.  It is the
// round of the legacy node-order loops (fused_superstep=False): the
// residual is taken by the caller after the inverse permutation, so there
// is none here.
//
// Bound on this card: 2 operations per nonzero and column; each F row,
// each base/out element and each live nbr/wgt slot has to move at least
// once.  At the legacy path's shapes (S = 4396 label columns) the f32
// operation count is the larger term (see PERF.md).
//
// Design: the inner loop of csr_round_common.cuh (live row lengths, a warp
// per row, lane vectors of columns, warp-shuffle broadcast of nbr/wgt),
// with its compensated row sum: the dhlp-bio step gives B3 rows of 110 k
// (scale_1m) to 2 M (scale_20m) live slots, where a plain running f32 sum
// misses the f32 gate.
// The legacy block-rows layout pads every row of a 64-row block to the
// block's widest row (2.86 slots per nonzero on the LP path); with live
// lengths a row stops after its last nonzero and adds one pad slot.

#include "csr_round_common.cuh"

namespace {

// Blocks of at most 8 warps: at 16 or 32 (a tighter register budget) the
// legacy round ran 14 % and 8 % slower on an H100
// (tools/csr_round_variants.py).
constexpr int kMaxWarps = 8;

template <typename T>
int run(const void* nbr, const void* wgt, const void* live, const void* F,
        const void* base, void* out, int M, int D, int S, int rows_per_block,
        int vec, float c, cudaStream_t st) {
  csr_round::Args<T, T> a{static_cast<const int*>(nbr),
                          static_cast<const T*>(wgt),
                          static_cast<const int*>(live),
                          static_cast<const T*>(F),
                          static_cast<const float*>(base),
                          nullptr,
                          static_cast<T*>(out),
                          nullptr,
                          M, D, S, rows_per_block, c};
  return static_cast<int>(csr_round::launch<T, T, false, kMaxWarps, true>(a, vec, st));
}

}  // namespace

extern "C" int csr_round_launch(const void* nbr, const void* wgt,
                                const void* live, const void* F,
                                const void* base, void* out, int M, int D,
                                int S, int rows_per_block, int vec, float c,
                                int bf16, int device, void* stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bf16 ? run<__nv_bfloat16>(nbr, wgt, live, F, base, out, M, D, S,
                                   rows_per_block, vec, c, st)
              : run<float>(nbr, wgt, live, F, base, out, M, D, S,
                           rows_per_block, vec, c, st);
}
