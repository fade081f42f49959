// Embedding-bag lookup on Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/embedding_bag/kernel.py::embedding_bag
// and computes the same function:
//   out[b, :] = sum_k w[b, k] * table[idx[b, k], :]        (f32 accumulation)
// with table (V, D) and w (B, K) both f32 or both bf16, idx (B, K) int32,
// and out (B, D) in the table's dtype (one rounding).  On the Wide & Deep
// serving path it runs twice per call: the deep lookup (V = 40,000,000,
// D = 32, K = 1, one bag per (example, field)) and the wide lookup
// (D = 1, K = 40, one bag per example).
//
// Bound on this card: bytes.  Each bag reads K ids, K weights and K table
// rows of D values and writes D values; 2 operations per slot and column
// are far below the card's rate.  The table rows are gathered: the deep
// table is 5.12 GB, so nearly every row comes from device memory.
//
// Design.  The Pallas kernel sweeps the vocabulary in VMEM panels and
// masks the ids outside each one, because the table does not fit VMEM;
// that sweep is not carried over: rows are gathered from device memory /
// L2 directly, once per slot.  No atomics: one group of threads owns one
// bag and sums its slots in a fixed order, so two launches are byte-
// identical.  The ids are not range-checked here: the caller checks them
// once on the host (the model's entry point), and an id outside [0, V)
// reads outside the table.  Two layouts, chosen from D:
//   D > 4  ("lanes over D"): a group of lanes = next power of two >= D
//          (at most 32) threads per bag, each lane owning CPL columns
//          spaced `lanes` apart (CPL = 1, 2 or 4 with grid.y column
//          tiles beyond 128).  The group loads `lanes` ids and weights
//          at a time and broadcasts them with warp shuffles.  At D = 32,
//          K = 1: one bag per warp and each table row is one 128-byte
//          coalesced load.
//   D <= 4 ("lanes over K"): a group of lanes = next power of two >=
//          min(K, 32) threads per bag; lane j sums slots j, j + lanes, ...
//          for all D columns, then the group adds its partial sums with a
//          fixed xor-shuffle tree.  At D = 1, K = 40: one bag per warp,
//          40 of the 64 slot positions live; lanes over D would leave 31
//          of 32 lanes idle.

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

__host__ __device__ inline int ceil_log2(int x) {
  int s = 0;
  while ((1 << s) < x) ++s;
  return s;
}

// Lanes over D: one group per bag, CPL columns per lane.
template <typename T, int CPL>
__global__ void __launch_bounds__(kThreads)
    bag_rows_kernel(const T* __restrict__ table, const int* __restrict__ idx,
                    const T* __restrict__ w, T* __restrict__ out, int B,
                    int K, int D, int lane_shift) {
  const int lanes = 1 << lane_shift;
  const int sub = threadIdx.x & (lanes - 1);
  const long long bag =
      static_cast<long long>(blockIdx.x) * (kThreads >> lane_shift) +
      (threadIdx.x >> lane_shift);
  const bool live = bag < B;
  const size_t slab = static_cast<size_t>(live ? bag : 0) * K;
  const int col0 = blockIdx.y * (lanes * CPL) + sub;
  float acc[CPL];
#pragma unroll
  for (int j = 0; j < CPL; ++j) acc[j] = 0.0f;
  // Trip counts depend on K only: the full-mask shuffles stay convergent.
  for (int k0 = 0; k0 < K; k0 += lanes) {
    const int kn = min(lanes, K - k0);
    int my_id = 0;
    float my_w = 0.0f;
    if (live && sub < kn) {
      my_id = idx[slab + k0 + sub];
      my_w = to_f32(w[slab + k0 + sub]);
    }
#pragma unroll 4
    for (int k = 0; k < kn; ++k) {
      const int v = __shfl_sync(kFull, my_id, k, lanes);
      const float wk = __shfl_sync(kFull, my_w, k, lanes);
      const T* row = table + static_cast<size_t>(v) * D;
#pragma unroll
      for (int j = 0; j < CPL; ++j) {
        const int col = col0 + j * lanes;
        if (col < D) acc[j] = fmaf(wk, to_f32(row[col]), acc[j]);
      }
    }
  }
  if (live) {
    T* orow = out + static_cast<size_t>(bag) * D;
#pragma unroll
    for (int j = 0; j < CPL; ++j) {
      const int col = col0 + j * lanes;
      if (col < D) store(orow + col, acc[j]);
    }
  }
}

// Lanes over K: one group per bag, every lane holds all D (<= DC) columns
// of its slots' partial sum; the group reduces with a fixed shuffle tree.
template <typename T, int DC>
__global__ void __launch_bounds__(kThreads)
    bag_slots_kernel(const T* __restrict__ table, const int* __restrict__ idx,
                     const T* __restrict__ w, T* __restrict__ out, int B,
                     int K, int D, int lane_shift) {
  const int lanes = 1 << lane_shift;
  const int sub = threadIdx.x & (lanes - 1);
  const long long bag =
      static_cast<long long>(blockIdx.x) * (kThreads >> lane_shift) +
      (threadIdx.x >> lane_shift);
  const bool live = bag < B;
  float acc[DC];
#pragma unroll
  for (int c = 0; c < DC; ++c) acc[c] = 0.0f;
  if (live) {
    const size_t slab = static_cast<size_t>(bag) * K;
    for (int k = sub; k < K; k += lanes) {
      const float wk = to_f32(w[slab + k]);
      const T* row = table + static_cast<size_t>(idx[slab + k]) * D;
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        if (c < D) acc[c] = fmaf(wk, to_f32(row[c]), acc[c]);
      }
    }
  }
  // All lanes of the warp take part, live or not.
  for (int off = lanes >> 1; off > 0; off >>= 1) {
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[c] += __shfl_xor_sync(kFull, acc[c], off, lanes);
  }
  if (live && sub == 0) {
    T* orow = out + static_cast<size_t>(bag) * D;
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      if (c < D) store(orow + c, acc[c]);
    }
  }
}

template <typename T>
void launch(const void* table, const void* idx, const void* w, void* out,
            int B, int K, int D, cudaStream_t st) {
  const T* t = static_cast<const T*>(table);
  const int* i = static_cast<const int*>(idx);
  const T* wp = static_cast<const T*>(w);
  T* o = static_cast<T*>(out);
  if (D <= 4) {
    const int lane_shift = ceil_log2(K < 32 ? (K > 0 ? K : 1) : 32);
    const int bags_per_block = kThreads >> lane_shift;
    const dim3 grid(
        static_cast<unsigned>((B + bags_per_block - 1LL) / bags_per_block));
    if (D == 1) {
      bag_slots_kernel<T, 1><<<grid, kThreads, 0, st>>>(t, i, wp, o, B, K, D,
                                                        lane_shift);
    } else if (D == 2) {
      bag_slots_kernel<T, 2><<<grid, kThreads, 0, st>>>(t, i, wp, o, B, K, D,
                                                        lane_shift);
    } else {
      bag_slots_kernel<T, 4><<<grid, kThreads, 0, st>>>(t, i, wp, o, B, K, D,
                                                        lane_shift);
    }
    return;
  }
  int lane_shift = 5;
  int cpl = D <= 64 ? 2 : 4;
  if (D <= 32) {
    lane_shift = ceil_log2(D);
    cpl = 1;
  }
  const int bags_per_block = kThreads >> lane_shift;
  const int tile = (1 << lane_shift) * cpl;
  const dim3 grid(
      static_cast<unsigned>((B + bags_per_block - 1LL) / bags_per_block),
      static_cast<unsigned>((D + tile - 1LL) / tile));
  if (cpl == 1) {
    bag_rows_kernel<T, 1><<<grid, kThreads, 0, st>>>(t, i, wp, o, B, K, D,
                                                     lane_shift);
  } else if (cpl == 2) {
    bag_rows_kernel<T, 2><<<grid, kThreads, 0, st>>>(t, i, wp, o, B, K, D,
                                                     lane_shift);
  } else {
    bag_rows_kernel<T, 4><<<grid, kThreads, 0, st>>>(t, i, wp, o, B, K, D,
                                                     lane_shift);
  }
}

}  // namespace

extern "C" int embedding_bag_launch(const void* table, const void* idx,
                                    const void* w, void* out, int B, int K,
                                    int D, int bf16, int device,
                                    void* stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16) {
    launch<__nv_bfloat16>(table, idx, w, out, B, K, D, st);
  } else {
    launch<float>(table, idx, w, out, B, K, D, st);
  }
  return static_cast<int>(cudaGetLastError());
}
