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
// element and each live nbr/wgt slot once; at the main path's shapes
// (S = 4396 label columns) the f32 operation count is the larger term
// (see PERF.md).  In practice each F row is re-read from L2 once per slot
// that names it, and that traffic is what limits the kernel.
//
// Design: the inner loop of csr_round_common.cuh (live row lengths, a warp
// per row, lane vectors of columns, warp-shuffle broadcast of nbr/wgt).  The
// Pallas kernel keeps the whole (N, bs) F panel resident in VMEM (16 MB);
// an SM has 227 KB of shared memory, so this kernel gathers F rows from
// L2 and has no node-count limit.  The residual is a per-row-block
// partial written without atomics; the caller reduces it over blocks, so
// results are bit-identical from run to run.

#include "csr_round_common.cuh"

namespace {

// Blocks of at most 16 warps: the fused plan's narrow buckets (9 to 15 rows
// a block) then give each warp one row; 8 ran 2.5 % slower, 32 (a 64-
// register budget, which spills) 13 % on an H100
// (tools/csr_round_variants.py).
constexpr int kMaxWarps = 16;

template <typename T>
int run(const void* nbr, const void* wgt, const void* live, const void* F,
        const void* base, const void* prev, void* out, void* delta, int M,
        int D, int S, int rows_per_block, int vec, float c, cudaStream_t st) {
  csr_round::Args<T, float> a{static_cast<const int*>(nbr),
                              static_cast<const T*>(wgt),
                              static_cast<const int*>(live),
                              static_cast<const T*>(F),
                              static_cast<const float*>(base),
                              static_cast<const float*>(prev),
                              static_cast<float*>(out),
                              static_cast<float*>(delta),
                              M, D, S, rows_per_block, c};
  return static_cast<int>(csr_round::launch<T, float, true, kMaxWarps>(a, vec, st));
}

}  // namespace

extern "C" int csr_round_residual_launch(const void* nbr, const void* wgt,
                                         const void* live, const void* F,
                                         const void* base, const void* prev,
                                         void* out, void* delta, int M, int D,
                                         int S, int rows_per_block, int vec,
                                         float c, int bf16, int device,
                                         void* stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bf16 ? run<__nv_bfloat16>(nbr, wgt, live, F, base, prev, out, delta,
                                   M, D, S, rows_per_block, vec, c, st)
              : run<float>(nbr, wgt, live, F, base, prev, out, delta, M, D,
                           S, rows_per_block, vec, c, st);
}
