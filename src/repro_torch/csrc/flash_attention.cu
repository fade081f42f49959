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
// Rows.  A block owns one (batch, KV head) and a tile of its rows, the
// (position, group member) pairs in position-major order: the `group`
// query heads of a GQA group share every K/V tile the block stages, and
// a decode step (one position) fills a tile with its group's heads.
// Key tiles wholly outside the tile's causal window are never visited
// (exact: a fully masked tile leaves m, l and acc unchanged in
// _flash_kernel).  Tiles whose rows see the most keys launch first.  No
// atomics: two launches give the same bytes.  Strides are arguments: the
// model's (B, L, H, D) activations and (B, S, H_kv, D) cache slices are
// read in place.
//
// Three regimes, chosen by the wrapper (kernels/flash_attention/ops.py)
// from the dtype and the rows per (batch, KV head):
//
// * bf16 prefill (more than 16 rows): bound by operations, 4 D per live
//   (q, k) pair (1.30 ms per h2o-danube-1.8b prefill_32k layer at the
//   989 TFLOP/s bf16 tensor-core peak).  wgmma on the tensor cores.  3
//   consumer warpgroups of 64 rows (192 rows a block) share a 4-stage
//   ring of 64-key K/V tiles, which one thread fills with TMA boxes of
//   (8 columns, 64 keys) against an mbarrier per stage; K and V stay bf16.
//   Shared tiles are column-chunk major, which is wgmma's no-swizzle
//   layout for any D that is a multiple of 16 (D = 80 has no swizzle
//   atom): core matrices 128 B apart along the rows and 1 KB along the
//   columns, one descriptor per operand and k-step.  S = Q K^T reads both
//   K-major from shared memory (m64n64k16, D / 16 k-steps, f32); the
//   online softmax runs on S's accumulator registers in f32, masking only
//   tiles that cross the diagonal, the window edge or Lk; P enters
//   P.V from registers as the A operand, against V read MN-major
//   (m64nDk16).  P goes in as two bf16 terms, P_hi = bf16(P) and P_lo =
//   bf16(P - P_hi), each multiplied by the same V tile: the split leaves
//   an error of about 2^-17 of P, where one rounding (2^-9) moves outputs
//   near zero by more than the one-ulp gate the kernel is held to
//   (tests/test_torch_flash_numerics.py shows both).  Cost: 1.5x the MMA
//   work of a single-rounded P.  Per tile t, S of tile t + 1 and P.V of
//   tile t run on the tensor cores while tile t + 1's softmax runs on the
//   CUDA cores; every wgmma wait in the loop is unconditional, or ptxas
//   serializes the wgmmas.
// * bf16 decode (16 rows or fewer, a decode step's group of heads):
//   bound by bytes, each K/V row read once (0.39 ms per decode_32k layer
//   at 3.35 TB/s).  A 64-row wgmma tile would waste 16x the MMA work, so
//   this tile uses mma.sync.m16n8k16 (ldmatrix, the same hi/lo P) on one
//   16-row tile, its 4 warps splitting each 128-key stage of a 3-stage
//   cp.async ring (32 keys each; rows padded to D + 8 elements, free of
//   bank conflicts for ldmatrix), so that ~90 KB of K/V per block are in
//   flight; the warps' partial (m, l, acc) merge in shared memory in a
//   fixed order.
// * f32: an exact kernel on the CUDA cores (f32 FMA: TF32 tensor cores
//   would miss the f32 gate).  256 threads, BQ = 64 rows (BQ = 16 when a
//   (batch, KV head) has at most 16 rows), key tiles of 64 staged in
//   shared memory as f32, the online-softmax state in registers; sixteen
//   threads share a row, each scoring 4 keys of the tile and owning D /
//   16 output columns.
//
// The K/V tensor maps are encoded on every prefill launch with
// cuTensorMapEncodeTiled, looked up through the CUDA runtime so that no
// library links libcuda; a decode launch encodes none.

#include <cuda.h>  // CUtensorMap and its encoder's types only: libcuda is not linked
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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
  float scale_log2;  // scale * log2(e): the bf16 kernels keep scores in log2 units
};

__device__ __forceinline__ void load8(const float* p, float (&x)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
  x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
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

// ------------------------------------------- bf16 on the tensor cores

__device__ __forceinline__ uint32_t smem_addr(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

// 16 bytes global -> shared, asynchronously; zero-filled when !ok
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(ok ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// d += a (16 x 16, row) . b (16 x 8, col), bf16 in, f32 accumulate
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 h) {
  return *reinterpret_cast<const uint32_t*>(&h);
}

// (x, y) as a bf16 pair hi = bf16(x, y) and lo = bf16((x, y) - hi)
__device__ __forceinline__ void split_bf16(float x, float y, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 f = __bfloat1622float2(h);
  hi = bits(h);
  lo = bits(__floats2bfloat162_rn(x - f.x, y - f.y));
}

// 2^x (ex2.approx: __expf is ex2.approx of x log2(e))
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// One key tile's online-softmax step for a thread's rows g and g + 8 (the
// accumulator layout of mma.sync and of wgmma alike), in three parts.
// softmax_scores scales the scores to log2 units (each exponential is
// then one ex2), masks them where the tile crosses an edge (`full`
// false; kp0 is the key of s[0][0]), updates the row max m and this
// thread's part of the row sum l, and leaves P = 2^(S - m) in s and the
// factor alpha that rescales the rows' accumulators.
template <int NT>
__device__ __forceinline__ void softmax_scores(float (&s)[NT][4], float (&m)[2], float (&l)[2],
                                               float (&alpha)[2], const Params& p, bool full,
                                               int kp0, int k_end, const int (&qpos)[2]) {
  const float neg_inf = __int_as_float(0xff800000u);
  float mt[2] = {neg_inf, neg_inf};
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = e >> 1;
      float x = s[j][e] * p.scale_log2;
      if (!full) {
        const int kp = kp0 + j * 8 + (e & 1);
        bool ok = kp < k_end;
        if (p.causal) ok = ok && kp <= qpos[i];
        if (p.window > 0) ok = ok && kp > qpos[i] - p.window;
        x = ok ? x : neg_inf;
      }
      s[j][e] = x;
      mt[i] = fmaxf(mt[i], x);
    }
  bool none[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    mt[i] = fmaxf(mt[i], __shfl_xor_sync(kFull, mt[i], 1));
    mt[i] = fmaxf(mt[i], __shfl_xor_sync(kFull, mt[i], 2));
    const float m_new = fmaxf(m[i], mt[i]);
    none[i] = m_new == neg_inf;  // no valid key seen yet
    alpha[i] = m[i] == neg_inf ? 0.0f : exp2_approx(m[i] - m_new);
    m[i] = m_new;
  }
  float ls[2] = {0.0f, 0.0f};
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = e >> 1;
      s[j][e] = none[i] ? 0.0f : exp2_approx(s[j][e] - m[i]);
      ls[i] += s[j][e];
    }
#pragma unroll
  for (int i = 0; i < 2; ++i) l[i] = l[i] * alpha[i] + ls[i];
}

// P (f32, in s) as bf16 A fragments P_hi + P_lo, one per 16 keys
template <int NT>
__device__ __forceinline__ void split_p(const float (&s)[NT][4], uint32_t (&ph)[NT / 2][4],
                                        uint32_t (&pl)[NT / 2][4]) {
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    split_bf16(s[j][0], s[j][1], ph[j / 2][(j & 1) * 2], pl[j / 2][(j & 1) * 2]);
    split_bf16(s[j][2], s[j][3], ph[j / 2][(j & 1) * 2 + 1], pl[j / 2][(j & 1) * 2 + 1]);
  }
}

template <int DT>
__device__ __forceinline__ void rescale(float (&acc)[DT][4], const float (&alpha)[2]) {
#pragma unroll
  for (int dt = 0; dt < DT; ++dt) {
    acc[dt][0] *= alpha[0];
    acc[dt][1] *= alpha[0];
    acc[dt][2] *= alpha[1];
    acc[dt][3] *= alpha[1];
  }
}

// acc / l of a thread's rows g and g + 8 (rr: their row indices) to out
template <int DT>
__device__ __forceinline__ void store_rows(const float (&acc)[DT][4], const float (&l)[2],
                                           const long long (&rr)[2], const Params& p, int hk,
                                           long long b, int t4) {
  __nv_bfloat16* out = static_cast<__nv_bfloat16*>(p.out);
  const long long R = static_cast<long long>(p.Lq) * p.group;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (rr[i] >= R) continue;
    const long long pos = rr[i] / p.group;
    const long long h = static_cast<long long>(hk) * p.group + rr[i] % p.group;
    __nv_bfloat16* orow = out + b * p.o_sb + pos * p.o_sl + h * p.o_sh + 2 * t4;
#pragma unroll
    for (int dt = 0; dt < DT; ++dt)
      *reinterpret_cast<__nv_bfloat162*>(orow + dt * 8) =
          __floats2bfloat162_rn(acc[dt][2 * i] / l[i], acc[dt][2 * i + 1] / l[i]);
  }
}

// The decode tile: one 16-row tile per block, whose WK warps split every
// BK-key stage of an NS-stage cp.async ring (BKW keys each).
constexpr int kDecWarps = 4;   // WK
constexpr int kDecKeys = 32;   // BKW
constexpr int kDecStages = 3;  // NS

template <int D>
constexpr size_t decode_smem_bytes() {
  const size_t ring = static_cast<size_t>(kDecStages) * 2 * kDecWarps * kDecKeys * (D + 8) *
                      sizeof(__nv_bfloat16);
  const size_t merge = static_cast<size_t>(kDecWarps) * 16 * (D + 2) * sizeof(float);
  return ring > merge ? ring : merge;
}

template <int D>
__global__ void __launch_bounds__(32 * kDecWarps, 2)
    flash_fwd_decode_kernel(const Params p) {
  constexpr int WK = kDecWarps, BKW = kDecKeys, NS = kDecStages;
  constexpr int kThr = 32 * WK;
  constexpr int BQ = 16;        // rows per block
  constexpr int BK = WK * BKW;  // keys per stage
  constexpr int DP = D + 8;     // padded shared row (bf16)
  constexpr int CH = D / 8;     // 16-byte chunks per row
  constexpr int NT = BKW / 8;   // score n-tiles of a warp
  constexpr int DT = D / 8;     // output n-tiles
  constexpr int KS = D / 16;    // k-steps of Q . K^T
  extern __shared__ float4 smem4[];
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(smem4);  // NS x {K, V} x BK x DP

  const __nv_bfloat16* __restrict__ q = static_cast<const __nv_bfloat16*>(p.q);
  const __nv_bfloat16* __restrict__ k = static_cast<const __nv_bfloat16*>(p.k);
  const __nv_bfloat16* __restrict__ v = static_cast<const __nv_bfloat16*>(p.v);
  __nv_bfloat16* __restrict__ out = static_cast<__nv_bfloat16*>(p.out);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int wk = tid >> 5;  // this warp's BKW keys of each stage
  const int g = lane >> 2;  // fragment row (and g + 8)
  const int t4 = lane & 3;  // fragment column pair
  const int hk = blockIdx.y;
  const long long b = blockIdx.z;
  const int G = p.group;
  const long long R = static_cast<long long>(p.Lq) * G;
  const long long row0 = static_cast<long long>(gridDim.x - 1 - blockIdx.x) * BQ;
  const float neg_inf = __int_as_float(0xff800000u);

  // this thread's rows g and g + 8 of the 16, and Q's A fragments
  long long rr[2];
  int qpos[2];
  uint32_t qf[KS][4];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    rr[i] = row0 + g + 8 * i;
    const bool live = rr[i] < R;
    const long long pos = live ? rr[i] / G : 0;
    qpos[i] = p.q_offset + static_cast<int>(pos);
    const long long h = static_cast<long long>(hk) * G + (live ? rr[i] % G : 0);
    const __nv_bfloat16* qrow = q + b * p.q_sb + pos * p.q_sl + h * p.q_sh + 2 * t4;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks)
#pragma unroll
      for (int half = 0; half < 2; ++half)
        qf[ks][i + 2 * half] =
            live ? *reinterpret_cast<const uint32_t*>(qrow + ks * 16 + half * 8) : 0u;
  }

  // the keys any row of this tile can see
  const long long last = (R < row0 + BQ ? R : row0 + BQ) - 1;
  const int qp_lo = p.q_offset + static_cast<int>(row0 / G);
  const int qp_hi = p.q_offset + static_cast<int>(last / G);
  int k_end = p.Lk;
  if (p.causal) k_end = min(k_end, qp_hi + 1);
  int k_begin = 0;
  if (p.window > 0) k_begin = max(0, qp_lo - p.window + 1);
  const int n_tiles = k_end > k_begin ? (k_end - k_begin + BK - 1) / BK : 0;

  const __nv_bfloat16* kb = k + b * p.k_sb + hk * p.k_sh;
  const __nv_bfloat16* vb = v + b * p.v_sb + hk * p.v_sh;
  auto load_tile = [&](int tile) {
    const int k0 = k_begin + tile * BK;
    __nv_bfloat16* Ks = ring + (tile % NS) * 2 * BK * DP;
    __nv_bfloat16* Vs = Ks + BK * DP;
    for (int c = tid; c < BK * CH; c += kThr) {
      const int j = c / CH;
      const int d0 = (c % CH) * 8;
      const bool ok = k0 + j < k_end;
      const long long kp = ok ? k0 + j : 0;
      cp_async16(smem_addr(Ks + j * DP + d0), kb + kp * p.k_sl + d0, ok);
      cp_async16(smem_addr(Vs + j * DP + d0), vb + kp * p.v_sl + d0, ok);
    }
  };

  float m[2] = {neg_inf, neg_inf};
  float l[2] = {0.0f, 0.0f};
  float acc[DT][4];
#pragma unroll
  for (int dt = 0; dt < DT; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[dt][e] = 0.0f;

#pragma unroll
  for (int s = 0; s < NS - 1; ++s) {
    if (s < n_tiles) load_tile(s);
    cp_async_commit();  // one group per tile, empty past the end
  }
  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait<NS - 2>();  // this thread's copies of tile t have landed
    __syncthreads();          // everyone's have; tile t - 1's stage is free
    if (t + NS - 1 < n_tiles) load_tile(t + NS - 1);
    cp_async_commit();

    const __nv_bfloat16* Ks = ring + (t % NS) * 2 * BK * DP + wk * BKW * DP;
    const __nv_bfloat16* Vs = Ks + BK * DP;
    const int k0 = k_begin + t * BK;
    const int kw0 = k0 + wk * BKW;

    // S = Q K^T: ldmatrix gives the B fragments of two n-tiles at once
    float s[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.0f;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks)
#pragma unroll
      for (int j = 0; j < NT; j += 2) {
        uint32_t kb[4];
        const int key = (j + (lane >> 4)) * 8 + (lane & 7);
        const int col = ks * 16 + ((lane >> 3) & 1) * 8;
        ldmatrix_x4(kb, smem_addr(Ks + key * DP + col));
        mma_bf16(s[j], qf[ks], kb[0], kb[1]);
        mma_bf16(s[j + 1], qf[ks], kb[2], kb[3]);
      }

    const bool full = k0 + BK <= k_end && (!p.causal || k0 + BK - 1 <= qp_lo) &&
                      (p.window <= 0 || k0 > qp_hi - p.window);
    float alpha[2];
    softmax_scores(s, m, l, alpha, p, full, kw0 + 2 * t4, k_end, qpos);
    rescale(acc, alpha);
    uint32_t ph[NT / 2][4], pl[NT / 2][4];
    split_p(s, ph, pl);

    // O += P_hi V + P_lo V: ldmatrix.trans gives V's B fragments
#pragma unroll
    for (int tt = 0; tt < NT / 2; ++tt)
#pragma unroll
      for (int dt = 0; dt < DT; dt += 2) {
        uint32_t vb[4];
        const int key = tt * 16 + ((lane >> 3) & 1) * 8 + (lane & 7);
        const int col = (dt + (lane >> 4)) * 8;
        ldmatrix_x4_trans(vb, smem_addr(Vs + key * DP + col));
        mma_bf16(acc[dt], ph[tt], vb[0], vb[1]);
        mma_bf16(acc[dt], pl[tt], vb[0], vb[1]);
        mma_bf16(acc[dt + 1], ph[tt], vb[2], vb[3]);
        mma_bf16(acc[dt + 1], pl[tt], vb[2], vb[3]);
      }
  }
  cp_async_wait<0>();  // only empty groups remain; the ring is quiet

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(kFull, l[i], 1);
    l[i] += __shfl_xor_sync(kFull, l[i], 2);
  }
  // merge the key-split warps' (m, l, acc) in a fixed order
  __syncthreads();  // every warp is done with the ring
  float* part = reinterpret_cast<float*>(smem4);  // WK x 16 x D
  float* pm = part + WK * 16 * D;                 // WK x 16
  float* pls = pm + WK * 16;                      // WK x 16
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = g + 8 * i;
    if (t4 == 0) {
      pm[wk * 16 + row] = m[i];
      pls[wk * 16 + row] = l[i];
    }
#pragma unroll
    for (int dt = 0; dt < DT; ++dt) {
      part[(wk * 16 + row) * D + dt * 8 + 2 * t4] = acc[dt][2 * i];
      part[(wk * 16 + row) * D + dt * 8 + 2 * t4 + 1] = acc[dt][2 * i + 1];
    }
  }
  __syncthreads();
  for (int e = tid; e < 16 * D; e += kThr) {
    const int row = e / D;
    const int d = e % D;
    const long long r = row0 + row;
    if (r >= R) continue;
    float mx = neg_inf;
#pragma unroll
    for (int w = 0; w < WK; ++w) mx = fmaxf(mx, pm[w * 16 + row]);
    float lsum = 0.0f, o = 0.0f;
#pragma unroll
    for (int w = 0; w < WK; ++w) {
      const float mw = pm[w * 16 + row];
      const float c = mw == neg_inf ? 0.0f : exp2_approx(mw - mx);
      lsum += c * pls[w * 16 + row];
      o += c * part[(w * 16 + row) * D + d];
    }
    const long long pos = r / G;
    const long long h = static_cast<long long>(hk) * G + r % G;
    store(out + b * p.o_sb + pos * p.o_sl + h * p.o_sh + d, o / lsum);
  }
}

template <int D>
cudaError_t launch_decode(const Params& p, int B, int Hkv, cudaStream_t st) {
  constexpr size_t smem = decode_smem_bytes<D>();
  auto kern = flash_fwd_decode_kernel<D>;
  const cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  const long long R = static_cast<long long>(p.Lq) * p.group;
  const dim3 grid(static_cast<unsigned>((R + 15) / 16), static_cast<unsigned>(Hkv),
                  static_cast<unsigned>(B));
  kern<<<grid, 32 * kDecWarps, smem, st>>>(p);
  return cudaGetLastError();
}

// ---------------------------------------- bf16 prefill on wgmma

__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keeps the compiler from touching accumulators across an asynchronous wgmma
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(d[i][e])::"memory");
}

// mbarriers and TMA (cp.async.bulk.tensor) for the K/V ring
__device__ __forceinline__ void mbar_init(uint32_t bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred p;\nWAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@p bra DONE;\nbra WAIT;\nDONE:\n}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}
// box (8 columns, 64 rows) of a (D, L, H, B) bf16 tensor map at (c0, c1, c2, c3)
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// Shared tiles of 64 rows x D bf16, column-chunk major: the 8 columns
// c0..c0+7 of all 64 rows are one contiguous 1 KB block (what one TMA box
// of (8, 64) writes), element (r, c) at ((c / 8) * 64 + r) * 8 + c % 8.
// In wgmma's no-swizzle terms its 8 x 8 core matrices are 128 contiguous
// bytes, 128 B apart along the rows and 1 KB apart along the columns, so
// any D that is a multiple of 16 fits (80 too), with no bank conflicts.
__device__ __forceinline__ int tile_index(int r, int c) {
  return ((c >> 3) * 64 + r) * 8 + (c & 7);
}

// a matrix descriptor, no swizzle: lbo = bytes between core matrices
// along K, sbo = along M or N
__device__ __forceinline__ uint64_t wgmma_desc(const void* base, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((smem_addr(base) >> 4) & 0x3FFF) |
         static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16 |
         static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32;
}

// d (64 x 64) += A (64 x 16, shared, K-major) . B (16 x 64, shared, K-major)
// (scale_d 0: d = A . B, its old value ignored)
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[8][4], uint64_t da, uint64_t db,
                                             int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]), "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]), "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]), "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]), "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]), "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]), "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d (64 x 16) += A (64 x 16, registers) . B (16 x 16, shared, MN-major)
__device__ __forceinline__ void wgmma_rs(float (&d)[2][4], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x 32) += A (64 x 16, registers) . B (16 x 32, shared, MN-major)
__device__ __forceinline__ void wgmma_rs(float (&d)[4][4], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]), "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]), "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x 64) += A (64 x 16, registers) . B (16 x 64, shared, MN-major)
__device__ __forceinline__ void wgmma_rs(float (&d)[8][4], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]), "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]), "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]), "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]), "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]), "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]), "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x 80) += A (64 x 16, registers) . B (16 x 80, shared, MN-major)
__device__ __forceinline__ void wgmma_rs(float (&d)[10][4], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %45, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39}, {%40, %41, %42, %43}, %44, p, 1, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]), "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]), "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]), "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]), "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]), "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]), "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]), "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]), "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x 128) += A (64 x 16, registers) . B (16 x 128, shared, MN-major)
__device__ __forceinline__ void wgmma_rs(float (&d)[16][4], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]), "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]), "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]), "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]), "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]), "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]), "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]), "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]), "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]), "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]), "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]), "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]), "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]), "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]), "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}


// The prefill tile: WG warpgroups of 64 rows (192 rows per block) share
// every 64-key stage of an NS-stage TMA ring.
constexpr int kPreGroups = 3;  // WG
constexpr int kPreStages = 4;  // NS

template <int D>
constexpr size_t prefill_smem_bytes() {
  return static_cast<size_t>(64 * kPreGroups + kPreStages * 2 * 64) * D * sizeof(__nv_bfloat16) +
         8 * kPreStages;
}

template <int D>
__global__ void __launch_bounds__(128 * kPreGroups, 1)
    flash_fwd_prefill_kernel(const Params p, const __grid_constant__ CUtensorMap tk,
                             const __grid_constant__ CUtensorMap tv) {
  constexpr int WG = kPreGroups, NS = kPreStages;
  static_assert(NS >= 3, "S of the next tile needs its K while this tile's V is in use");
  constexpr int kThr = 128 * WG;
  constexpr int BQ = 64 * WG;  // rows per block
  constexpr int BK = 64;       // keys per stage
  constexpr int CH = D / 8;    // 8-column chunks
  constexpr int NT = BK / 8;
  constexpr int DT = D / 8;
  constexpr int KS = D / 16;
  constexpr uint32_t kTileBytes = 64 * D * sizeof(__nv_bfloat16);
  // core matrices: 128 B apart along the rows, 1 KB along the columns
  constexpr uint32_t kRowCm = 128, kColCm = 1024;
  extern __shared__ float4 smem4[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem4);  // WG tiles of 64 x D
  __nv_bfloat16* ring = Qs + BQ * D;                              // NS x {K, V} x 64 x D
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + NS * 2 * BK * D);  // NS mbarriers

  const __nv_bfloat16* __restrict__ q = static_cast<const __nv_bfloat16*>(p.q);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;  // rows 16 warp .. 16 warp + 15; warpgroup warp / 4
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int hk = blockIdx.y;
  const int bz = blockIdx.z;
  const long long b = bz;
  const int G = p.group;
  const long long R = static_cast<long long>(p.Lq) * G;
  const long long row0 = static_cast<long long>(gridDim.x - 1 - blockIdx.x) * BQ;
  const float neg_inf = __int_as_float(0xff800000u);

  long long rr[2];
  int qpos[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    rr[i] = row0 + warp * 16 + g + 8 * i;
    qpos[i] = p.q_offset + static_cast<int>(rr[i] < R ? rr[i] / G : 0);
  }
  const long long last = (R < row0 + BQ ? R : row0 + BQ) - 1;
  const int qp_lo = p.q_offset + static_cast<int>(row0 / G);
  const int qp_hi = p.q_offset + static_cast<int>(last / G);
  int k_end = p.Lk;
  if (p.causal) k_end = min(k_end, qp_hi + 1);
  int k_begin = 0;
  if (p.window > 0) k_begin = max(0, qp_lo - p.window + 1);
  const int n_tiles = k_end > k_begin ? (k_end - k_begin + BK - 1) / BK : 0;

  // one thread drives the ring: a stage is K then V, each CH boxes of
  // (8 columns, 64 keys); keys past Lk arrive as zeros
  auto load_tile = [&](int tile) {
    const int st = tile % NS;
    const uint32_t bar = smem_addr(full + st);
    const uint32_t ks = smem_addr(ring + st * 2 * BK * D);
    mbar_expect_tx(bar, 2 * kTileBytes);
    const int k0 = k_begin + tile * BK;
#pragma unroll
    for (int c = 0; c < CH; ++c) {
      tma_load(ks + c * 1024, &tk, bar, c * 8, k0, hk, bz);
      tma_load(ks + kTileBytes + c * 1024, &tv, bar, c * 8, k0, hk, bz);
    }
  };
  if (tid == 0) {
#pragma unroll
    for (int st = 0; st < NS; ++st) mbar_init(smem_addr(full + st));
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
#pragma unroll
    for (int st = 0; st < NS - 1; ++st)
      if (st < n_tiles) load_tile(st);
  }
  // the Q tile, rows zero past the end; 32 lanes fill 512 contiguous bytes
  for (int c = tid; c < BQ * CH; c += kThr) {
    const int r = (c / (64 * CH)) * 64 + c % 64;
    const int d0 = ((c / 64) % CH) * 8;
    const long long rq = row0 + r;
    const bool live = rq < R;
    const long long pos = live ? rq / G : 0;
    const long long h = static_cast<long long>(hk) * G + (live ? rq % G : 0);
    cp_async16(smem_addr(Qs + (r >> 6) * 64 * D + tile_index(r & 63, d0)),
               q + b * p.q_sb + pos * p.q_sl + h * p.q_sh + d0, live);
  }
  cp_async_commit();
  cp_async_wait<0>();
  fence_proxy_async();  // Q's generic-proxy copies are visible to wgmma
  __syncthreads();      // ... and the mbarriers are initialised

  float m[2] = {neg_inf, neg_inf};
  float l[2] = {0.0f, 0.0f};
  float alpha[2];
  float acc[DT][4];
#pragma unroll
  for (int dt = 0; dt < DT; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[dt][e] = 0.0f;

  const __nv_bfloat16* Qw = Qs + (warp >> 2) * 64 * D;  // this warpgroup's 64 rows
  // S = Q K_tile^T, both operands K-major in shared memory (asynchronous)
  float s[NT][4];
  auto issue_s = [&](int tile) {
    const __nv_bfloat16* Ks = ring + (tile % NS) * 2 * BK * D;
    fence_regs(s);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < KS; ++ks)
      wgmma_ss_n64(s, wgmma_desc(Qw + ks * 1024, kColCm, kRowCm),
                   wgmma_desc(Ks + ks * 1024, kColCm, kRowCm), ks > 0);
    wgmma_commit();
  };
  auto scores = [&](int tile) {
    const int k0 = k_begin + tile * BK;
    const bool whole = k0 + BK <= k_end && (!p.causal || k0 + BK - 1 <= qp_lo) &&
                       (p.window <= 0 || k0 > qp_hi - p.window);
    softmax_scores(s, m, l, alpha, p, whole, k0 + 2 * t4, k_end, qpos);
  };
  // O = alpha O + P_hi V + P_lo V: P from registers, V MN-major in shared memory
  uint32_t ph[NT / 2][4], pl[NT / 2][4];  // P of the tile in flight
  auto issue_pv = [&](int tile) {
    rescale(acc, alpha);
    const __nv_bfloat16* Vs = ring + (tile % NS) * 2 * BK * D + BK * D;
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int tt = 0; tt < NT / 2; ++tt) {
      const uint64_t dv = wgmma_desc(Vs + tt * 128, kRowCm, kColCm);
      wgmma_rs(acc, ph[tt], dv);
      wgmma_rs(acc, pl[tt], dv);
    }
    wgmma_commit();
  };

  // Per tile t: S of tile t + 1 and P.V of tile t run on the tensor cores
  // while the softmax of tile t + 1 runs on the CUDA cores.  Every wgmma
  // issue and wait inside the loop is unconditional, so that ptxas can
  // match each wait to its group and keep the wgmmas pipelined.
  if (n_tiles > 0) {
    mbar_wait(smem_addr(full), 0);
    issue_s(0);
    wgmma_wait<0>();
    fence_regs(s);
    scores(0);
    for (int t = 0; t + 1 < n_tiles; ++t) {
      mbar_wait(smem_addr(full + (t + 1) % NS), ((t + 1) / NS) & 1);  // tile t + 1 landed
      __syncthreads();  // every warpgroup is done with tile t - 1's stage
      if (tid == 0 && t + NS - 1 < n_tiles) load_tile(t + NS - 1);
      split_p(s, ph, pl);  // before S of tile t + 1 overwrites s
      issue_s(t + 1);
      issue_pv(t);
      wgmma_wait<1>();  // S of tile t + 1; P.V of tile t may still run
      fence_regs(s);
      scores(t + 1);
      wgmma_wait<0>();
      fence_regs(acc);
    }
    split_p(s, ph, pl);
    issue_pv(n_tiles - 1);
    wgmma_wait<0>();
    fence_regs(acc);
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(kFull, l[i], 1);
    l[i] += __shfl_xor_sync(kFull, l[i], 2);
  }
  store_rows(acc, l, rr, p, hk, b, t4);
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// libcuda's cuTensorMapEncodeTiled, looked up through the CUDA runtime so
// that no kernel library links libcuda
EncodeTiled tensor_map_encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &ptr, 12000,
                                                           cudaEnableDefault, &found);
#else
    const cudaError_t e =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    if (e == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

// (D, L, H, B) bf16 with element strides (1, sl, sh, sb), boxes of (8, 64)
cudaError_t encode_kv_map(CUtensorMap* map, const void* base, int D, int L, int H, int B,
                          long long sl, long long sh, long long sb) {
  const EncodeTiled encode = tensor_map_encoder();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(L),
                              static_cast<cuuint64_t>(H), static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(sl) * 2, static_cast<cuuint64_t>(sh) * 2,
                                 static_cast<cuuint64_t>(sb) * 2};
  const cuuint32_t box[4] = {8, 64, 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base),
                            dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <int D>
cudaError_t launch_prefill(const Params& p, int B, int Hkv, cudaStream_t st) {
  CUtensorMap tk, tv;
  const int L = p.Lk > 0 ? p.Lk : 1;  // no key: the kernel loads no tile
  cudaError_t e = encode_kv_map(&tk, p.k, D, L, Hkv, B, p.k_sl, p.k_sh, p.k_sb);
  if (e != cudaSuccess) return e;
  e = encode_kv_map(&tv, p.v, D, L, Hkv, B, p.v_sl, p.v_sh, p.v_sb);
  if (e != cudaSuccess) return e;
  constexpr size_t smem = prefill_smem_bytes<D>();
  auto kern = flash_fwd_prefill_kernel<D>;
  e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  const long long R = static_cast<long long>(p.Lq) * p.group;
  constexpr int BQ = 64 * kPreGroups;
  const dim3 grid(static_cast<unsigned>((R + BQ - 1) / BQ), static_cast<unsigned>(Hkv),
                  static_cast<unsigned>(B));
  kern<<<grid, 128 * kPreGroups, smem, st>>>(p, tk, tv);
  return cudaGetLastError();
}

// regimes, as the wrapper numbers them
constexpr int kF32 = 0;
constexpr int kPrefill = 1;  // bf16, more than 16 rows per (batch, KV head)
constexpr int kDecode = 2;   // bf16, 16 rows or fewer

template <int D>
cudaError_t launch_dim(const Params& p, int B, int Hkv, int regime, cudaStream_t st) {
  switch (regime) {
    case kF32:
      if (static_cast<long long>(p.Lq) * p.group <= 16)
        return launch_tile<float, D, 16>(p, B, Hkv, st);
      return launch_tile<float, D, 64>(p, B, Hkv, st);
    case kPrefill: return launch_prefill<D>(p, B, Hkv, st);
    case kDecode: return launch_decode<D>(p, B, Hkv, st);
    default: return cudaErrorInvalidValue;
  }
}

cudaError_t launch(const Params& p, int B, int Hkv, int D, int regime, cudaStream_t st) {
  switch (D) {
    case 16: return launch_dim<16>(p, B, Hkv, regime, st);
    case 32: return launch_dim<32>(p, B, Hkv, regime, st);
    case 64: return launch_dim<64>(p, B, Hkv, regime, st);
    case 80: return launch_dim<80>(p, B, Hkv, regime, st);
    case 128: return launch_dim<128>(p, B, Hkv, regime, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q (B, Lq, Hkv * group, D), k and v (B, Lk, Hkv, D), out like q, each
// given by its (batch, sequence, head) strides in elements; the head
// dimension is contiguous.  window <= 0 means no window.  regime: 0 f32
// (CUDA cores), 1 bf16 prefill, 2 bf16 decode (tensor cores).
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* out, int B, int Hkv,
    int group, int Lq, int Lk, int D, long long q_sb, long long q_sl,
    long long q_sh, long long k_sb, long long k_sl, long long k_sh,
    long long v_sb, long long v_sl, long long v_sh, long long o_sb,
    long long o_sl, long long o_sh, int causal, int window, int q_offset,
    float scale, int regime, int device, void* stream) {
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
  p.scale_log2 = scale * 1.4426950408889634f;
  return static_cast<int>(launch(p, B, Hkv, D, regime, static_cast<cudaStream_t>(stream)));
}
