// The inner loop shared by the blocked-CSR round kernels on Hopper (sm_90a):
// csr_round.cu (B3) and csr_round_residual.cu (B1).  Both compute, for one
// width bucket,
//   out[r, s] = c * base[r, s] + sum_k wgt[r, k] * F[nbr[r, k], s]   (f32 acc)
// and B1 adds the per-row-block partial of max_r |out[r, s] - prev[r, s]|.
//
// Bound on this card: 2 operations per nonzero and column (the f32 term is
// the larger one at the LP path's S = 4396 label columns), but what limits
// a gather kernel in practice is the traffic of F rows from L2: every slot
// that names a node re-reads that node's F row.
//
// Design.
// - Live row lengths.  Every pad of a blocked-CSR row comes after its last
//   live slot, so live[r] describes the padding exactly.  A row sums its
//   live[r] slots and, when live[r] < D, the slot at index live[r] once
//   with weight 0: the id is read from the slot, so a NaN or Inf in the F
//   row that the pads name reaches exactly the rows the reference (which
//   sums every pad) puts it in.  A null live pointer means every row is D
//   slots long and has no pad.
// - A warp owns a row of output.  Each lane holds VEC consecutive columns
//   (16 bytes where S and F's alignment allow it, down to one element), so
//   a warp reads one contiguous 32*VEC-column segment of each F row it
//   gathers.  The block's warps share that column tile and take the rows of
//   the block's row range in turn.
// - The row's nbr/wgt come in 32 slots at a time, one coalesced load into
//   lane registers (the next 32 prefetched while the current ones are
//   summed), and are broadcast with __shfl_sync: no shared-memory round
//   trip, no block barrier.  A warp issues kDepth gathers before their
//   FMAs.
// - Each output element is summed in slot order by one lane, as the
//   previous kernels and the plain version's per-slot order do; no atomics,
//   so two launches give byte-identical results.
// - kCompensated (B3): each 32-slot chunk is summed into a fresh partial
//   and the partials are added into the row's sum with Kahan compensation.
//   A plain running f32 sum over one row drifts with the row's length: at
//   110,134 slots (dhlp-bio scale_1m, a hub row) it was 2e-4 of the sum
//   off an f64 sum, past the f32 gate; chunked and compensated, the error
//   no longer grows with the row.  Three adds per chunk and lane.
// - No F rows are staged in shared memory.  Copying the fused plan's
//   most-named rows (its permuted ids 0..H-1) into shared memory per block
//   was measured slower at every H tried (H = 128, 256, 384; PERF.md): the
//   L1 cache already serves those rows, and the copy only takes its room.
//
// Grid: x = row blocks of rows_per_block rows, y = column tiles of 32*VEC
// columns; blocks that run together share a column tile, so the F slice
// they gather stays in L2.  Ragged M and S are masked in the kernel.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

namespace csr_round {

constexpr int kWarp = 32;
constexpr unsigned kFull = 0xffffffffu;

// A lane's VEC elements of T, moved as one access of BYTES bytes.
template <int BYTES> struct RawOf;
template <> struct RawOf<2> { using type = unsigned short; };
template <> struct RawOf<4> { using type = unsigned int; };
template <> struct RawOf<8> { using type = uint2; };
template <> struct RawOf<16> { using type = uint4; };

__device__ __forceinline__ unsigned word(unsigned short r, int) { return r; }
__device__ __forceinline__ unsigned word(unsigned r, int) { return r; }
__device__ __forceinline__ unsigned word(const uint2& r, int i) {
  return i == 0 ? r.x : r.y;
}
__device__ __forceinline__ unsigned word(const uint4& r, int i) {
  return i == 0 ? r.x : i == 1 ? r.y : i == 2 ? r.z : r.w;
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

template <typename T, int VEC>
struct Lane {
  static constexpr int kBytes = static_cast<int>(sizeof(T)) * VEC;
  using Raw = typename RawOf<kBytes>::type;
  // gathers a warp issues before their FMAs
  static constexpr int kDepth = 8;

  static __device__ __forceinline__ Raw gather(const T* p) {
    return __ldg(reinterpret_cast<const Raw*>(p));
  }
  // element i of the access, widened to f32 (bf16 is the top half of f32)
  static __device__ __forceinline__ float at(const Raw& r, int i) {
    if constexpr (std::is_same<T, float>::value) {
      return __uint_as_float(word(r, i));
    } else {
      const unsigned w = word(r, i / 2);
      return __uint_as_float((i & 1) ? (w & 0xffff0000u) : (w << 16));
    }
  }
};

template <typename T, typename Out>
struct Args {
  const int* nbr;    // (M, D) int32
  const T* wgt;      // (M, D)
  const int* live;   // (M,) int32 live slots per row, or null (all D)
  const T* F;        // (N, S)
  const float* base; // (M, S)
  const float* prev; // (M, S), B1 only
  Out* out;          // (M, S)
  float* delta;      // (gridDim.x, S), B1 only
  int M, D, S, rows_per_block;
  float c;
};

// kDepth slots j0 .. j0 + kDepth - 1 of the 32 held in (my_id, my_w): all
// gathers are issued before the first FMA.  A partial group (kFullGroup false)
// skips the slots at or past kn.
template <typename T, int VEC, bool kFullGroup>
__device__ __forceinline__ void slot_group(const T* __restrict__ Fcol, int S,
                                           int my_id, float my_w, int j0,
                                           int kn, float (&acc)[VEC]) {
  using L = Lane<T, VEC>;
  constexpr int kDepth = L::kDepth;
  typename L::Raw buf[kDepth];
#pragma unroll
  for (int u = 0; u < kDepth; ++u) {
    const int id = __shfl_sync(kFull, my_id, j0 + u);
    if (kFullGroup || j0 + u < kn) buf[u] = L::gather(Fcol + static_cast<size_t>(id) * S);
  }
#pragma unroll
  for (int u = 0; u < kDepth; ++u) {
    const float w = __shfl_sync(kFull, my_w, j0 + u);
    if (kFullGroup || j0 + u < kn) {
#pragma unroll
      for (int v = 0; v < VEC; ++v) acc[v] = fmaf(w, L::at(buf[u], v), acc[v]);
    }
  }
}

// One row's sum for the lane's VEC columns, in slot order, then the pad.
// Fcol points at the lane's first column (a lane past S reads column 0 and
// its sums are never stored).  kCompensated: 32-slot partials added with
// Kahan compensation (see the header).
template <typename T, int VEC, bool kCompensated>
__device__ __forceinline__ void row_sum(const int* __restrict__ nrow,
                                        const T* __restrict__ wrow, int n_live,
                                        int D, const T* __restrict__ Fcol,
                                        int S, int lane, float (&acc)[VEC]) {
  using L = Lane<T, VEC>;
  constexpr int kDepth = L::kDepth;
  int next_id = 0;
  float next_w = 0.0f;
  float comp[VEC];  // minus what the row's sum has lost so far (Kahan)
#pragma unroll
  for (int v = 0; v < VEC; ++v) comp[v] = 0.0f;
  if (lane < n_live) {
    next_id = nrow[lane];
    next_w = to_f32(wrow[lane]);
  }
  for (int k0 = 0; k0 < n_live; k0 += kWarp) {
    const int kn = min(kWarp, n_live - k0);
    const int my_id = next_id;
    const float my_w = next_w;
    if (k0 + kWarp + lane < n_live) {  // prefetch the next 32 slots
      next_id = nrow[k0 + kWarp + lane];
      next_w = to_f32(wrow[k0 + kWarp + lane]);
    }
    float part[VEC];
#pragma unroll
    for (int v = 0; v < VEC; ++v) part[v] = kCompensated ? 0.0f : acc[v];
    int j = 0;
    for (; j + kDepth <= kn; j += kDepth) slot_group<T, VEC, true>(Fcol, S, my_id, my_w, j, kn, part);
    if (j < kn) slot_group<T, VEC, false>(Fcol, S, my_id, my_w, j, kn, part);
#pragma unroll
    for (int v = 0; v < VEC; ++v) {
      if constexpr (kCompensated) {
        const float y = part[v] - comp[v];
        const float t = acc[v] + y;
        comp[v] = (t - acc[v]) - y;
        acc[v] = t;
      } else {
        acc[v] = part[v];
      }
    }
  }
  if (n_live < D) {
    // the first pad, weight 0: adds nothing but a NaN or Inf of its F row
    const typename L::Raw p = L::gather(Fcol + static_cast<size_t>(nrow[n_live]) * S);
#pragma unroll
    for (int v = 0; v < VEC; ++v) acc[v] = fmaf(0.0f, L::at(p, v), acc[v]);
  }
}

// kMaxWarps: warps per block at most (min(rows_per_block, kMaxWarps) run);
// it also sets the register budget through __launch_bounds__.
template <typename T, typename Out, int VEC, bool kResidual, int kMaxWarps, bool kCompensated>
__global__ void __launch_bounds__(kMaxWarps * kWarp)
    round_kernel(const Args<T, Out> a) {
  constexpr int kTile = kWarp * VEC;  // columns per block
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const int nwarps = blockDim.x / kWarp;
  const int c0 = blockIdx.y * kTile;
  const int col = c0 + lane * VEC;
  const bool on = col < a.S;  // S % VEC == 0: a lane's columns are all in or all out
  const int r0 = blockIdx.x * a.rows_per_block;
  const int r1 = min(r0 + a.rows_per_block, a.M);

  float dmax[VEC];
#pragma unroll
  for (int v = 0; v < VEC; ++v) dmax[v] = 0.0f;
  for (int r = r0 + warp; r < r1; r += nwarps) {
    const int n_live = a.live ? min(max(a.live[r], 0), a.D) : a.D;
    float acc[VEC];
#pragma unroll
    for (int v = 0; v < VEC; ++v) acc[v] = 0.0f;
    row_sum<T, VEC, kCompensated>(a.nbr + static_cast<size_t>(r) * a.D,
                    a.wgt + static_cast<size_t>(r) * a.D, n_live, a.D,
                    a.F + (on ? col : 0), a.S, lane, acc);
    if (on) {
      const size_t o = static_cast<size_t>(r) * a.S + col;
#pragma unroll
      for (int v = 0; v < VEC; ++v) {
        const float val = a.c * a.base[o + v] + acc[v];
        store(a.out + o + v, val);
        if constexpr (kResidual) {
          const float d = fabsf(val - a.prev[o + v]);
          // a NaN residual must keep its column active, as a max that
          // propagates NaN does in the reference
          dmax[v] = (d > dmax[v] || d != d) ? d : dmax[v];
        }
      }
    }
  }

  if constexpr (kResidual) {
    // the block's partial: its warps' maxima merged in warp order
    extern __shared__ float part[];  // (nwarps, kTile)
#pragma unroll
    for (int v = 0; v < VEC; ++v) part[warp * kTile + lane * VEC + v] = dmax[v];
    __syncthreads();
    for (int t = threadIdx.x; t < kTile; t += blockDim.x) {
      if (c0 + t >= a.S) break;
      float m = part[t];
      for (int w = 1; w < nwarps; ++w) {
        const float d = part[w * kTile + t];
        m = (d > m || d != d) ? d : m;
      }
      a.delta[static_cast<size_t>(blockIdx.x) * a.S + c0 + t] = m;
    }
  }
}

template <typename T, typename Out, int VEC, bool kResidual, int kMaxWarps, bool kCompensated>
cudaError_t launch_vec(const Args<T, Out>& a, cudaStream_t st) {
  const int warps = a.rows_per_block < kMaxWarps ? a.rows_per_block : kMaxWarps;
  const int tile = kWarp * VEC;
  // B1: the warps' residual maxima
  const size_t smem = kResidual ? static_cast<size_t>(warps) * tile * sizeof(float) : 0;
  const dim3 grid((a.M + a.rows_per_block - 1) / a.rows_per_block,
                  (a.S + tile - 1) / tile);
  round_kernel<T, Out, VEC, kResidual, kMaxWarps, kCompensated>
      <<<grid, warps * kWarp, smem, st>>>(a);
  return cudaGetLastError();
}

// vec: columns per lane, chosen by the caller from S and F's alignment
template <typename T, typename Out, bool kResidual, int kMaxWarps, bool kCompensated = false>
cudaError_t launch(const Args<T, Out>& a, int vec, cudaStream_t st) {
  if (a.rows_per_block < 1) return cudaErrorInvalidValue;
  switch (vec) {
    case 1: return launch_vec<T, Out, 1, kResidual, kMaxWarps, kCompensated>(a, st);
    case 2: return launch_vec<T, Out, 2, kResidual, kMaxWarps, kCompensated>(a, st);
    case 4: return launch_vec<T, Out, 4, kResidual, kMaxWarps, kCompensated>(a, st);
    case 8:
      if constexpr (sizeof(T) * 8 <= 16)
        return launch_vec<T, Out, 8, kResidual, kMaxWarps, kCompensated>(a, st);
      return cudaErrorInvalidValue;
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace csr_round
