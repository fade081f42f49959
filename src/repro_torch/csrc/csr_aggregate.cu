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
// of F, the live nbr/wgt slots and one write of out; at the GCN's widths
// the bytes are the larger term (about 0.9 ms for S = 100 at 3.35 TB/s,
// see PERF.md).  In practice every live slot gathers its F row again, and
// at S = 100 F (about 1 GB) is far larger than the 50 MB L2, so the
// gathers come from HBM: 126 M live slots x 400 bytes is about 15 ms.
//
// Design.  The Pallas kernel keeps an (N, 128) F panel resident in VMEM,
// which caps N at 16,384; here F rows are gathered from device memory /
// L2 and N is unbounded.  Pull model, no atomics: a group of LANES
// threads owns one output row and walks its slots in order, so every
// output element is written once and two launches are byte-identical.
// - Live row lengths.  With `live`, a row stops after its live[r] slots
//   and, when live[r] < D, adds the slot at index live[r] once with weight
//   0, so a NaN or Inf in the F row the pads name reaches the rows that
//   have pads, as in the reference (which sums every pad).  Without it
//   every row sums its D slots.  The semantics are those of the blocked-
//   CSR rounds (csr_round_common.cuh), whose lane type this file borrows.
// - Lanes.  Each lane holds VEC consecutive columns (16 bytes where S and
//   the operands' alignment allow it), so a gathered F row is one
//   coalesced segment per group.  LANES is the power of two that covers
//   S / VEC, at most 32 (wider rows take grid.y tiles of 32 * VEC
//   columns): at S = 100, 25 lanes of 4 f32 and one row per warp; at
//   S = 16, 4 lanes and 8 rows per warp; at S = 1, 32 rows per warp.
// - Slots.  The group loads its row's nbr/wgt a round at a time (the next
//   round prefetched while this one is summed): one slot per lane, or
//   several per lane in narrow groups, so that a round holds at least
//   kDepth slots.  Slots are broadcast by width-LANES shuffles and each
//   lane issues kDepth gathers before their FMAs.
// - Divergence.  The row groups of one warp differ in length, so every
//   lane loops to the warp's longest row (__reduce_max_sync) and a group
//   masks the slots past its own row: the shuffles stay convergent.
// Ragged M, D and S are masked in the kernel; nothing is padded on the
// host.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

#include "csr_round_common.cuh"

namespace {

using csr_round::kFull;
using csr_round::Lane;
using csr_round::to_f32;

constexpr int kThreads = 256;

template <typename T, int VEC>
__device__ __forceinline__ void store_row(T* p, const float (&acc)[VEC]) {
  if constexpr (std::is_same<T, float>::value && VEC == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(acc[0], acc[1], acc[2], acc[3]);
  } else if constexpr (std::is_same<T, float>::value && VEC == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(acc[0], acc[1]);
  } else {
#pragma unroll
    for (int v = 0; v < VEC; ++v) csr_round::store(p + v, acc[v]);
  }
}

template <typename T, int VEC, int LANES>
__global__ void __launch_bounds__(kThreads)
    csr_aggregate_kernel(const int* __restrict__ nbr, const T* __restrict__ wgt,
                         const int* __restrict__ live, const T* __restrict__ F,
                         T* __restrict__ out, int M, int D, int S) {
  using L = Lane<T, VEC>;
  constexpr int kDepth = L::kDepth;                        // gathers in flight per group
  constexpr int kRound = LANES > kDepth ? LANES : kDepth;  // slots a group loads at a time
  constexpr int kPer = kRound / LANES;                     // of them, per lane
  const int sub = threadIdx.x & (LANES - 1);
  const long long row = static_cast<long long>(blockIdx.x) * (kThreads / LANES) +
                        threadIdx.x / LANES;
  const bool in = row < M;
  const int col = blockIdx.y * (LANES * VEC) + sub * VEC;
  const bool on = in && col < S;  // S % VEC == 0: a lane's columns are all in or all out
  const int n_live = in ? (live ? min(max(live[row], 0), D) : D) : 0;
  const int n_slots = n_live + (in && n_live < D ? 1 : 0);  // + the first pad
  const int k_end = __reduce_max_sync(kFull, n_slots);     // the warp's longest row
  const size_t slab = static_cast<size_t>(in ? row : 0) * D;
  const T* Fcol = F + (on ? col : 0);

  // slot j of a round lies in lane j % LANES, register j / LANES; the pad
  // slot keeps its id and gets weight 0
  int id[kPer], next_id[kPer];
  float w[kPer], next_w[kPer];
  auto load = [&](int k0) {
#pragma unroll
    for (int p = 0; p < kPer; ++p) {
      const int k = k0 + p * LANES + sub;
      next_id[p] = k < n_slots ? nbr[slab + k] : 0;
      next_w[p] = k < n_live ? to_f32(wgt[slab + k]) : 0.0f;
    }
  };
  float acc[VEC];
#pragma unroll
  for (int v = 0; v < VEC; ++v) acc[v] = 0.0f;
  load(0);
  for (int k0 = 0; k0 < k_end; k0 += kRound) {
#pragma unroll
    for (int p = 0; p < kPer; ++p) {
      id[p] = next_id[p];
      w[p] = next_w[p];
    }
    if (k0 + kRound < k_end) load(k0 + kRound);
#pragma unroll
    for (int j0 = 0; j0 < kRound; j0 += kDepth) {
      if (k0 + j0 >= k_end) continue;  // the same for every lane of the warp
      typename L::Raw buf[kDepth];
#pragma unroll
      for (int u = 0; u < kDepth; ++u) {
        const int j = j0 + u;
        const int v = __shfl_sync(kFull, id[j / LANES], j % LANES, LANES);
        if (on && k0 + j < n_slots) buf[u] = L::gather(Fcol + static_cast<size_t>(v) * S);
      }
#pragma unroll
      for (int u = 0; u < kDepth; ++u) {
        const int j = j0 + u;
        const float wv = __shfl_sync(kFull, w[j / LANES], j % LANES, LANES);
        if (on && k0 + j < n_slots) {
#pragma unroll
          for (int v = 0; v < VEC; ++v) acc[v] = fmaf(wv, L::at(buf[u], v), acc[v]);
        }
      }
    }
  }
  if (on) store_row<T, VEC>(out + static_cast<size_t>(row) * S + col, acc);
}

struct Args {
  const void* nbr;
  const void* wgt;
  const int* live;
  const void* F;
  void* out;
  int M, D, S;
};

template <typename T, int VEC, int LANES>
cudaError_t launch_lanes(const Args& a, cudaStream_t st) {
  constexpr int kRows = kThreads / LANES;
  constexpr int kTile = LANES * VEC;
  const dim3 grid(static_cast<unsigned>((a.M + kRows - 1LL) / kRows),
                  static_cast<unsigned>((a.S + kTile - 1LL) / kTile));
  csr_aggregate_kernel<T, VEC, LANES><<<grid, kThreads, 0, st>>>(
      static_cast<const int*>(a.nbr), static_cast<const T*>(a.wgt), a.live,
      static_cast<const T*>(a.F), static_cast<T*>(a.out), a.M, a.D, a.S);
  return cudaGetLastError();
}

template <typename T, int VEC>
cudaError_t launch_vec(const Args& a, int lanes, cudaStream_t st) {
  switch (lanes) {
    case 1: return launch_lanes<T, VEC, 1>(a, st);
    case 2: return launch_lanes<T, VEC, 2>(a, st);
    case 4: return launch_lanes<T, VEC, 4>(a, st);
    case 8: return launch_lanes<T, VEC, 8>(a, st);
    case 16: return launch_lanes<T, VEC, 16>(a, st);
    case 32: return launch_lanes<T, VEC, 32>(a, st);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t launch(const Args& a, int vec, int lanes, cudaStream_t st) {
  switch (vec) {
    case 1: return launch_vec<T, 1>(a, lanes, st);
    case 2: return launch_vec<T, 2>(a, lanes, st);
    case 4: return launch_vec<T, 4>(a, lanes, st);
    case 8:
      if constexpr (sizeof(T) == 2) return launch_vec<T, 8>(a, lanes, st);
      return cudaErrorInvalidValue;
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// live: (M,) int32 live slots per row, or null (every row sums its D
// slots).  vec: columns per lane; lanes: threads per row group (a power of
// two, at most 32); both chosen by the wrapper from S and the alignment.
extern "C" int csr_aggregate_launch(const void* nbr, const void* wgt, const void* live,
                                    const void* F, void* out, int M, int D, int S, int vec,
                                    int lanes, int bf16, int device, void* stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Args a{nbr, wgt, static_cast<const int*>(live), F, out, M, D, S};
  const cudaError_t e =
      bf16 ? launch<__nv_bfloat16>(a, vec, lanes, st) : launch<float>(a, vec, lanes, st);
  return static_cast<int>(e);
}
