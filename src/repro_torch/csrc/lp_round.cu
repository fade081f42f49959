// Fused dense DHLP-2 round out = c * base + A @ F, on Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/lp_blockspmm/kernel.py::lp_round
// and computes the same function: A (N, N), F (N, S), base (N, S), all f32
// or all bf16; the accumulator starts at c * base and is f32; the output is
// stored in F's type.
//
// Bound on this card: 2 * N * N * S f32 operations against the 67 TFLOP/s
// non-tensor-core f32 peak; at the main path's N = S = 4396 that is about
// 170 GFLOP, far above the bytes term, so the kernel is compute-bound.
//
// Design.  A shared-memory-tiled GEMM with register micro-tiles in full
// f32 FMA: no TF32 and no tensor cores, because TF32 keeps about three
// decimal digits and would miss the f32 tolerance the solver is held to.
// Each 256-thread block computes a 128 x 128 output tile; each thread owns
// an 8 x 8 micro-tile.  Per k-step of 8 the block stages an A tile
// (stored transposed, padded against bank conflicts) and an F tile in
// shared memory; bf16 inputs are widened to f32 as they are staged, and
// the next step's tiles are loaded into registers while this step
// computes.
// Ragged N and S are masked in the kernel (out-of-range elements load as
// zero and are never stored).  The k order is fixed, so results are
// bit-identical from run to run.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBM = 128;  // output rows per block
constexpr int kBN = 128;  // output columns per block
constexpr int kBK = 8;    // depth per shared-memory stage
constexpr int kTM = 8;    // rows per thread
constexpr int kTN = 8;    // columns per thread
constexpr int kThreads = (kBM / kTM) * (kBN / kTN);  // 256
constexpr int kPad = 4;   // keeps rows 16-byte aligned, spreads banks

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    lp_round_kernel(const T* __restrict__ A, const T* __restrict__ F,
                    const T* __restrict__ base, T* __restrict__ out, int N,
                    int S, float c) {
  __shared__ __align__(16) float As[kBK][kBM + kPad];  // A tile, k-major
  __shared__ __align__(16) float Bs[kBK][kBN + kPad];  // F tile
  const int tid = threadIdx.x;
  const int tx = tid % (kBN / kTN);
  const int ty = tid / (kBN / kTN);
  const int row0 = blockIdx.y * kBM;
  const int col0 = blockIdx.x * kBN;

  float acc[kTM][kTN];
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int r = row0 + ty * kTM + i;
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      const int cc = col0 + tx * kTN + j;
      acc[i][j] = (r < N && cc < S)
                      ? c * to_f32(base[static_cast<size_t>(r) * S + cc])
                      : 0.0f;
    }
  }

  // Register prefetch: the next k-step's tiles are loaded from device
  // memory while this step computes from shared memory.
  constexpr int kLoadA = (kBM * kBK) / kThreads;
  constexpr int kLoadB = (kBK * kBN) / kThreads;
  float a_next[kLoadA];
  float b_next[kLoadB];
  auto load_tiles = [&](int k0) {
#pragma unroll
    for (int l = 0; l < kLoadA; ++l) {
      const int idx = tid + l * kThreads;
      const int gr = row0 + idx / kBK;
      const int gk = k0 + idx % kBK;
      a_next[l] = (gr < N && gk < N)
                      ? to_f32(A[static_cast<size_t>(gr) * N + gk])
                      : 0.0f;
    }
#pragma unroll
    for (int l = 0; l < kLoadB; ++l) {
      const int idx = tid + l * kThreads;
      const int gk = k0 + idx / kBN;
      const int gc = col0 + idx % kBN;
      b_next[l] = (gk < N && gc < S)
                      ? to_f32(F[static_cast<size_t>(gk) * S + gc])
                      : 0.0f;
    }
  };

  load_tiles(0);
  for (int k0 = 0; k0 < N; k0 += kBK) {
#pragma unroll
    for (int l = 0; l < kLoadA; ++l) {
      const int idx = tid + l * kThreads;
      As[idx % kBK][idx / kBK] = a_next[l];
    }
#pragma unroll
    for (int l = 0; l < kLoadB; ++l) {
      const int idx = tid + l * kThreads;
      Bs[idx / kBN][idx % kBN] = b_next[l];
    }
    __syncthreads();
    if (k0 + kBK < N) load_tiles(k0 + kBK);
#pragma unroll
    for (int k = 0; k < kBK; ++k) {
      float a[kTM];
      float b[kTN];
      const float4* ap = reinterpret_cast<const float4*>(&As[k][ty * kTM]);
      const float4* bp = reinterpret_cast<const float4*>(&Bs[k][tx * kTN]);
#pragma unroll
      for (int v = 0; v < kTM / 4; ++v) {
        const float4 x = ap[v];
        a[4 * v + 0] = x.x;
        a[4 * v + 1] = x.y;
        a[4 * v + 2] = x.z;
        a[4 * v + 3] = x.w;
      }
#pragma unroll
      for (int v = 0; v < kTN / 4; ++v) {
        const float4 x = bp[v];
        b[4 * v + 0] = x.x;
        b[4 * v + 1] = x.y;
        b[4 * v + 2] = x.z;
        b[4 * v + 3] = x.w;
      }
#pragma unroll
      for (int i = 0; i < kTM; ++i) {
#pragma unroll
        for (int j = 0; j < kTN; ++j) {
          acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
        }
      }
    }
    __syncthreads();  // every thread is done with the tiles before the store
  }

#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int r = row0 + ty * kTM + i;
    if (r >= N) continue;
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      const int cc = col0 + tx * kTN + j;
      if (cc < S) out[static_cast<size_t>(r) * S + cc] = from_f32<T>(acc[i][j]);
    }
  }
}

}  // namespace

extern "C" int lp_round_launch(const void* A, const void* F, const void* base,
                               void* out, int N, int S, float c, int bf16,
                               int device, void* stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const dim3 grid((S + kBN - 1) / kBN, (N + kBM - 1) / kBM);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16) {
    lp_round_kernel<__nv_bfloat16><<<grid, kThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(A),
        static_cast<const __nv_bfloat16*>(F),
        static_cast<const __nv_bfloat16*>(base),
        static_cast<__nv_bfloat16*>(out), N, S, c);
  } else {
    lp_round_kernel<float><<<grid, kThreads, 0, st>>>(
        static_cast<const float*>(A), static_cast<const float*>(F),
        static_cast<const float*>(base), static_cast<float*>(out), N, S, c);
  }
  return static_cast<int>(cudaGetLastError());
}
