// Flash attention forward on Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/flash_attention/kernel.py:85 flash_attention
// (body _flash_kernel) and computes the same function, per query row:
//   out = softmax(q . K^T / sqrt(D) + mask) . V
// with the mask built from absolute positions: key k_pos < Lk, causal
// k_pos <= q_pos, sliding window k_pos > q_pos - window, where q_pos =
// q_offset + the row's index.  Scores, running max, running sum and the
// accumulator are f32; q, k, v are f32 or bf16 (all one type) and out is
// in q's type (one rounding).  Grouped-query attention reads the KV head
// h / group of query head h: the KV heads are never repeated in memory.
// A row with no valid key outputs NaN, as the reference's oracle
// attention_ref and its Pallas kernel do on the CPU (0 / 0).
//
// Bound on this card.  Prefill (a 32,768-token prompt, window 4,096):
// operations, 4 D per live (q, k) pair (30.9 TFLOP over the 24 layers of
// h2o-danube-1.8b, 31 ms at the 989 TFLOP/s bf16 tensor-core peak).
// Decode (one query row per sequence against a 4,096-slot cache): bytes,
// each K/V row read once (1.34 GB per layer at batch 128, 0.40 ms at
// 3.35 TB/s).
//
// Design.  A simple, exact kernel on the CUDA cores (f32 FMA, no tensor
// cores yet; P stays f32 as in the reference).  One block of 256 threads
// owns one (batch, KV head, tile of BQ query rows), where the rows of a
// (batch, KV head) are the (position, group member) pairs in position-
// major order: the `group` query heads of a GQA group share every K/V
// tile a block stages, and a decode step (one position) fills a tile with
// its group's heads instead of wasting a 64-row tile on one row.  The
// block loops over key tiles of 64 (Pallas's sequential key grid axis
// becomes a loop; blocks run in no order), staging each K and V tile in
// shared memory as f32, and keeps the online-softmax state (m, l, acc) in
// registers.  Key tiles wholly outside the causal window are never
// visited: the loop runs from the first key the tile's first row can see
// to the last key its last row can see, which is exact (a fully masked
// tile leaves m, l and acc unchanged in _flash_kernel).  Sixteen threads
// share a row: each scores 4 keys of the tile and owns D / 16 output
// columns; row max and sum travel by warp shuffles.  Two tile shapes:
// BQ = 64 (4 rows a thread) for prefill, BQ = 16 (1 row a thread, warps
// whose rows are all past the end skip the arithmetic) when a (batch, KV
// head) has at most 16 rows, as a decode step has.  Tiles whose rows see
// the most keys launch first.  No atomics: launches are deterministic.
// Strides are arguments: the model's (B, L, H, D) activations and its
// (B, S, H_kv, D) cache slices are read in place.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBK = 64;              // keys per tile
constexpr int kTC = 16;              // threads sharing one query row
constexpr int kCJ = kBK / kTC;       // keys scored per thread per tile
constexpr int kRowGroups = kThreads / kTC;
constexpr int kPS = kBK + 4;         // padded P row (floats)
constexpr unsigned kFull = 0xffffffffu;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* out;
  long long q_sb, q_sl, q_sh;
  long long k_sb, k_sl, k_sh;
  long long v_sb, v_sl, v_sh;
  long long o_sb, o_sl, o_sh;
  int Lq, Lk, group;
  int causal, window, q_offset;
  float scale;
};

__device__ __forceinline__ void load8(const float* p, float (&x)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
  x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&x)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void store8(float* dst, const float (&x)[8]) {
  reinterpret_cast<float4*>(dst)[0] = make_float4(x[0], x[1], x[2], x[3]);
  reinterpret_cast<float4*>(dst)[1] = make_float4(x[4], x[5], x[6], x[7]);
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

template <int BQ>
constexpr size_t smem_floats(int D) {
  return static_cast<size_t>(BQ + 2 * kBK) * (D + 4) +
         static_cast<size_t>(BQ) * kPS;
}

template <typename T, int D, int BQ>
__global__ void __launch_bounds__(kThreads, BQ == 64 ? 2 : 4)
    flash_fwd_kernel(const Params p) {
  constexpr int RI = BQ / kRowGroups;  // rows per thread
  constexpr int DJ = D / kTC;          // output columns per thread
  constexpr int DS = D + 4;            // padded Q/K/V row (floats)
  constexpr int CH = D / 8;            // 8-element chunks per row
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* Ks = Qs + BQ * DS;
  float* Vs = Ks + kBK * DS;
  float* Ps = Vs + kBK * DS;

  const T* __restrict__ q = static_cast<const T*>(p.q);
  const T* __restrict__ k = static_cast<const T*>(p.k);
  const T* __restrict__ v = static_cast<const T*>(p.v);
  T* __restrict__ out = static_cast<T*>(p.out);

  const int tid = threadIdx.x;
  const int tc = tid % kTC;
  const int tr = tid / kTC;
  const int hk = blockIdx.y;
  const long long b = blockIdx.z;
  const int G = p.group;
  const long long R = static_cast<long long>(p.Lq) * G;
  const long long row0 =
      static_cast<long long>(gridDim.x - 1 - blockIdx.x) * BQ;
  const float neg_inf = __int_as_float(0xff800000u);

  // the query tile, as f32
  for (int c = tid; c < BQ * CH; c += kThreads) {
    const int r = c / CH;
    const int d0 = (c % CH) * 8;
    const long long rr = row0 + r;
    float x[8];
    if (rr < R) {
      const long long pos = rr / G;
      const long long h = static_cast<long long>(hk) * G + rr % G;
      load8(q + b * p.q_sb + pos * p.q_sl + h * p.q_sh + d0, x);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) x[e] = 0.0f;
    }
    store8(Qs + r * DS + d0, x);
  }

  // the keys any row of this tile can see
  const long long last = (R < row0 + BQ ? R : row0 + BQ) - 1;
  const int qp_lo = p.q_offset + static_cast<int>(row0 / G);
  const int qp_hi = p.q_offset + static_cast<int>(last / G);
  int k_end = p.Lk;
  if (p.causal) k_end = min(k_end, qp_hi + 1);
  int k_begin = 0;
  if (p.window > 0) k_begin = max(0, qp_lo - p.window + 1);

  int qpos[RI];
  bool live[RI];
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const long long rr = row0 + tr + kRowGroups * i;
    live[i] = rr < R;
    qpos[i] = p.q_offset + static_cast<int>(live[i] ? rr / G : 0);
  }
  // the warp's rows are tr = 2w, 2w + 1 (+ 16 i): warp-uniform skip
  const bool warp_live = row0 + 2 * (tid / 32) < R;

  float m[RI], l[RI], acc[RI][DJ];
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    m[i] = neg_inf;
    l[i] = 0.0f;
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.0f;
  }

  for (int k0 = k_begin; k0 < k_end; k0 += kBK) {
    __syncthreads();  // the previous tile's readers are done
    for (int c = tid; c < kBK * CH; c += kThreads) {
      const int j = c / CH;
      const int d0 = (c % CH) * 8;
      const long long kp = k0 + j;
      float xk[8], xv[8];
      if (kp < k_end) {
        load8(k + b * p.k_sb + kp * p.k_sl + hk * p.k_sh + d0, xk);
        load8(v + b * p.v_sb + kp * p.v_sl + hk * p.v_sh + d0, xv);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          xk[e] = 0.0f;
          xv[e] = 0.0f;
        }
      }
      store8(Ks + j * DS + d0, xk);
      store8(Vs + j * DS + d0, xv);
    }
    __syncthreads();
    if (!warp_live) continue;

    // scores of this thread's RI rows x kCJ keys
    float s[RI][kCJ];
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < kCJ; ++j) s[i][j] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      float4 qv[RI], kv[kCJ];
#pragma unroll
      for (int i = 0; i < RI; ++i)
        qv[i] = *reinterpret_cast<const float4*>(
            Qs + (tr + kRowGroups * i) * DS + d);
#pragma unroll
      for (int j = 0; j < kCJ; ++j)
        kv[j] = *reinterpret_cast<const float4*>(Ks + (tc + kTC * j) * DS + d);
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < kCJ; ++j) {
          float a = s[i][j];
          a = fmaf(qv[i].x, kv[j].x, a);
          a = fmaf(qv[i].y, kv[j].y, a);
          a = fmaf(qv[i].z, kv[j].z, a);
          a = fmaf(qv[i].w, kv[j].w, a);
          s[i][j] = a;
        }
    }

    // mask and online softmax; P to shared memory for the P.V product
#pragma unroll
    for (int i = 0; i < RI; ++i) {
      float mt = neg_inf;
#pragma unroll
      for (int j = 0; j < kCJ; ++j) {
        const int kp = k0 + tc + kTC * j;
        bool ok = live[i] && kp < k_end;
        if (p.causal) ok = ok && kp <= qpos[i];
        if (p.window > 0) ok = ok && kp > qpos[i] - p.window;
        s[i][j] = ok ? s[i][j] * p.scale : neg_inf;
        mt = fmaxf(mt, s[i][j]);
      }
#pragma unroll
      for (int off = kTC / 2; off > 0; off >>= 1)
        mt = fmaxf(mt, __shfl_xor_sync(kFull, mt, off));
      const float m_new = fmaxf(m[i], mt);
      const bool none = m_new == neg_inf;  // no valid key seen yet
      const float alpha = m[i] == neg_inf ? 0.0f : __expf(m[i] - m_new);
      float ls = 0.0f;
      float* prow = Ps + (tr + kRowGroups * i) * kPS;
#pragma unroll
      for (int j = 0; j < kCJ; ++j) {
        const float pj = none ? 0.0f : __expf(s[i][j] - m_new);
        ls += pj;
        prow[tc + kTC * j] = pj;
      }
      l[i] = l[i] * alpha + ls;  // this thread's part; summed at the end
#pragma unroll
      for (int j = 0; j < DJ; ++j) acc[i][j] *= alpha;
      m[i] = m_new;
    }
    __syncwarp();  // a row's P is written and read by one half-warp

#pragma unroll 2
    for (int kk = 0; kk < kBK; kk += 4) {
      float4 pv[RI];
#pragma unroll
      for (int i = 0; i < RI; ++i)
        pv[i] = *reinterpret_cast<const float4*>(
            Ps + (tr + kRowGroups * i) * kPS + kk);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float* vrow = Vs + (kk + u) * DS + tc;
#pragma unroll
        for (int j = 0; j < DJ; ++j) {
          const float vv = vrow[kTC * j];
#pragma unroll
          for (int i = 0; i < RI; ++i) {
            const float pu = u == 0 ? pv[i].x
                             : u == 1 ? pv[i].y
                             : u == 2 ? pv[i].z
                                      : pv[i].w;
            acc[i][j] = fmaf(pu, vv, acc[i][j]);
          }
        }
      }
    }
  }

  // every lane of every warp takes part in the shuffles
#pragma unroll
  for (int i = 0; i < RI; ++i) {
#pragma unroll
    for (int off = kTC / 2; off > 0; off >>= 1)
      l[i] += __shfl_xor_sync(kFull, l[i], off);
    if (!live[i]) continue;
    const long long rr = row0 + tr + kRowGroups * i;
    const long long pos = rr / G;
    const long long h = static_cast<long long>(hk) * G + rr % G;
    T* orow = out + b * p.o_sb + pos * p.o_sl + h * p.o_sh + tc;
#pragma unroll
    for (int j = 0; j < DJ; ++j) store(orow + kTC * j, acc[i][j] / l[i]);
  }
}

template <typename T, int D, int BQ>
cudaError_t launch_tile(const Params& p, int B, int Hkv, cudaStream_t st) {
  const size_t smem = sizeof(float) * smem_floats<BQ>(D);
  auto kern = flash_fwd_kernel<T, D, BQ>;
  const cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  const long long R = static_cast<long long>(p.Lq) * p.group;
  const dim3 grid(static_cast<unsigned>((R + BQ - 1) / BQ),
                  static_cast<unsigned>(Hkv), static_cast<unsigned>(B));
  kern<<<grid, kThreads, smem, st>>>(p);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dim(const Params& p, int B, int Hkv, cudaStream_t st) {
  if (static_cast<long long>(p.Lq) * p.group <= 16)
    return launch_tile<T, D, 16>(p, B, Hkv, st);
  return launch_tile<T, D, 64>(p, B, Hkv, st);
}

template <typename T>
cudaError_t launch(const Params& p, int B, int Hkv, int D, cudaStream_t st) {
  switch (D) {
    case 16: return launch_dim<T, 16>(p, B, Hkv, st);
    case 32: return launch_dim<T, 32>(p, B, Hkv, st);
    case 64: return launch_dim<T, 64>(p, B, Hkv, st);
    case 80: return launch_dim<T, 80>(p, B, Hkv, st);
    case 128: return launch_dim<T, 128>(p, B, Hkv, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q (B, Lq, Hkv * group, D), k and v (B, Lk, Hkv, D), out like q, each
// given by its (batch, sequence, head) strides in elements; the head
// dimension is contiguous.  window <= 0 means no window.
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* out, int B, int Hkv,
    int group, int Lq, int Lk, int D, long long q_sb, long long q_sl,
    long long q_sh, long long k_sb, long long k_sl, long long k_sh,
    long long v_sb, long long v_sl, long long v_sh, long long o_sb,
    long long o_sl, long long o_sh, int causal, int window, int q_offset,
    float scale, int bf16, int device, void* stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.out = out;
  p.q_sb = q_sb; p.q_sl = q_sl; p.q_sh = q_sh;
  p.k_sb = k_sb; p.k_sl = k_sl; p.k_sh = k_sh;
  p.v_sb = v_sb; p.v_sl = v_sl; p.v_sh = v_sh;
  p.o_sb = o_sb; p.o_sl = o_sl; p.o_sh = o_sh;
  p.Lq = Lq;
  p.Lk = Lk;
  p.group = group;
  p.causal = causal;
  p.window = window;
  p.q_offset = q_offset;
  p.scale = scale;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t e = bf16 ? launch<__nv_bfloat16>(p, B, Hkv, D, st)
                             : launch<float>(p, B, Hkv, D, st);
  return static_cast<int>(e);
}
