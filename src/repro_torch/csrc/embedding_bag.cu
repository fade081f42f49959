// Embedding-bag lookup on Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/embedding_bag/kernel.py::embedding_bag
// and computes the same function:
//   out[b, :] = sum_k w[b, k] * table[idx[b, k], :]        (f32 accumulation)
// with table (V, D) and w (B, K) both f32 or both bf16, idx (B, K) int32,
// and out in the table's dtype (one rounding).  Bag b's row of out starts
// at element (b / G) * ld + (b % G) * D: G = 1, ld = D is a contiguous
// (B, D) out; the Wide & Deep model passes G = fields and the padded row
// stride of the MLP's input, so that the deep lookup lands in place
// beside the dense features.  On the Wide & Deep serving path it runs
// twice per call: the deep lookup (V = 40,000,000, D = 32, K = 1, one bag
// per (example, field)) and the wide lookup (D = 1, K = 40, one bag per
// example).
//
// Bound on this card: bytes.  Each bag reads K ids, K weights and K table
// rows of D values and writes D values; 2 operations per slot and column
// are far below the card's rate.  The rows are gathered at random: the
// deep table is 5.12 GB, and the Zipf-distributed ids reread a head of
// rows that L2 keeps, so the output stream and the ids set the time.
//
// Design.  The Pallas kernel sweeps the vocabulary in VMEM panels and
// masks the ids outside each one, because the table does not fit VMEM;
// that sweep is not carried over: rows are gathered from device memory /
// L2 directly, once per slot.  A gather is a chain (id, then row, then
// store), so what sets the rate is how many rows are in flight.  No
// atomics: one group of threads owns one bag and sums its slots in
// ascending k with fmaf from 0, so weight 1.0 is an exact gather and two
// launches are byte-identical.  The ids are not range-checked here: the
// caller checks them once on the host (the model's entry point), and an
// id outside [0, V) reads outside the table.  A persistent grid
// (occupancy x SMs blocks) walks the warps' tiles.  Three regimes, chosen
// by the wrapper (kernels/embedding_bag/ops.py::bag_plan) from D, K, the
// dtype and the operands' alignment:
//   vector (D > 4, rows a power of two or a multiple of 32 of 16-byte
//          chunks, 16-byte aligned table, out and row stride): a warp
//          owns a tile of 32 bags; lane i loads bag i's id and weight of
//          slot k with one coalesced load (the next step's are loaded
//          while this step's rows are in flight).  Lanes form groups of
//          D * elem / 16 (8 for f32 at D = 32); each lane takes
//          kRowsInFlight bags from the tile by __shfl_sync, issues one
//          16-byte ld.global.nc per bag before it uses any, and stores
//          16 bytes with st.global.cs, so the 1.3 GB output stream does
//          not evict the reused head rows from L2.
//   scalar (D > 4 otherwise: a table view with a storage offset, D = 36):
//          the same loop with one element a lane and groups of the next
//          power of two >= D lanes (at most 32; wider rows loop over
//          column chunks).
//   slots  (D <= 4, the wide lookup): lanes over K.  A bag has `lanes`
//          threads; lane j sums its id vectors j, j + lanes, ... (4 ids
//          and 4 weights in one 16-byte load where K and the alignment
//          allow it), a batch of them and all their table values in
//          flight, then the group adds its partial sums with a fixed
//          xor-shuffle tree.  At D = 1, K = 40: 4 lanes a bag, 2 or 3
//          id vectors each, 8 bags per warp.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
// vector / scalar regimes: table rows a lane keeps in flight
constexpr int kRowsInFlight = 8;
// vector / scalar regimes: a warp's tile is 32 * kTileIds bags (lane i
// holds the ids of bags i, i + 32, ...)
constexpr int kTileIds = 1;
// Cache policy and grid.  tools/embedding_bag_variants.py builds copies
// with these flipped.  Evict-last row loads made B5 alone 1 % faster but
// the Wide & Deep MLP's matrix products after it 0.1 ms slower (the lines
// it keeps crowd theirs out of L2), so they stay off.
constexpr bool kStreamStores = true;  // st.global.cs for the output
constexpr bool kEvictLast = false;    // an L2::evict_last policy on row loads
constexpr bool kPersistent = true;    // occupancy x SMs blocks walk the tiles

// Raw bytes of one lane's access.
template <int BYTES>
struct Raw;
template <>
struct Raw<16> {
  unsigned w[4];
};
template <>
struct Raw<8> {
  unsigned w[2];
};
template <>
struct Raw<4> {
  unsigned w[1];
};
template <>
struct Raw<2> {
  unsigned short h;
};

template <typename T>
constexpr int kSize = static_cast<int>(sizeof(T));

[[maybe_unused]] __device__ __forceinline__ unsigned long long evict_last_policy() {
  unsigned long long p;
  asm volatile("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;" : "=l"(p));
  return p;
}

// A read-only load (ld.global.nc); with HINT, under the L2 policy `pol`.
template <int BYTES, bool HINT>
__device__ __forceinline__ Raw<BYTES> ld_nc(const void* p, unsigned long long pol) {
  Raw<BYTES> r;
  if constexpr (BYTES == 16) {
    if constexpr (HINT) {
      asm volatile("ld.global.nc.L2::cache_hint.v4.u32 {%0, %1, %2, %3}, [%4], %5;"
                   : "=r"(r.w[0]), "=r"(r.w[1]), "=r"(r.w[2]), "=r"(r.w[3])
                   : "l"(p), "l"(pol));
    } else {
      asm volatile("ld.global.nc.v4.u32 {%0, %1, %2, %3}, [%4];"
                   : "=r"(r.w[0]), "=r"(r.w[1]), "=r"(r.w[2]), "=r"(r.w[3])
                   : "l"(p));
    }
  } else if constexpr (BYTES == 8) {
    if constexpr (HINT) {
      asm volatile("ld.global.nc.L2::cache_hint.v2.u32 {%0, %1}, [%2], %3;"
                   : "=r"(r.w[0]), "=r"(r.w[1])
                   : "l"(p), "l"(pol));
    } else {
      asm volatile("ld.global.nc.v2.u32 {%0, %1}, [%2];"
                   : "=r"(r.w[0]), "=r"(r.w[1])
                   : "l"(p));
    }
  } else if constexpr (BYTES == 4) {
    if constexpr (HINT) {
      asm volatile("ld.global.nc.L2::cache_hint.u32 %0, [%1], %2;"
                   : "=r"(r.w[0])
                   : "l"(p), "l"(pol));
    } else {
      asm volatile("ld.global.nc.u32 %0, [%1];" : "=r"(r.w[0]) : "l"(p));
    }
  } else {
    if constexpr (HINT) {
      asm volatile("ld.global.nc.L2::cache_hint.u16 %0, [%1], %2;"
                   : "=h"(r.h)
                   : "l"(p), "l"(pol));
    } else {
      asm volatile("ld.global.nc.u16 %0, [%1];" : "=h"(r.h) : "l"(p));
    }
  }
  return r;
}

// A table row's lane (the row loads are the ones the L2 policy is for).
template <int BYTES>
__device__ __forceinline__ Raw<BYTES> ld_row(const void* p, unsigned long long pol) {
  return ld_nc<BYTES, kEvictLast>(p, pol);
}

template <int BYTES>
__device__ __forceinline__ void st_out(void* p, const Raw<BYTES>& r) {
  if constexpr (BYTES == 16) {
    if constexpr (kStreamStores) {
      asm volatile("st.global.cs.v4.u32 [%0], {%1, %2, %3, %4};"
                   :: "l"(p), "r"(r.w[0]), "r"(r.w[1]), "r"(r.w[2]), "r"(r.w[3]));
    } else {
      asm volatile("st.global.v4.u32 [%0], {%1, %2, %3, %4};"
                   :: "l"(p), "r"(r.w[0]), "r"(r.w[1]), "r"(r.w[2]), "r"(r.w[3]));
    }
  } else if constexpr (BYTES == 8) {
    if constexpr (kStreamStores) {
      asm volatile("st.global.cs.v2.u32 [%0], {%1, %2};" :: "l"(p), "r"(r.w[0]), "r"(r.w[1]));
    } else {
      asm volatile("st.global.v2.u32 [%0], {%1, %2};" :: "l"(p), "r"(r.w[0]), "r"(r.w[1]));
    }
  } else if constexpr (BYTES == 4) {
    if constexpr (kStreamStores) {
      asm volatile("st.global.cs.u32 [%0], %1;" :: "l"(p), "r"(r.w[0]));
    } else {
      asm volatile("st.global.u32 [%0], %1;" :: "l"(p), "r"(r.w[0]));
    }
  } else {
    if constexpr (kStreamStores) {
      asm volatile("st.global.cs.u16 [%0], %1;" :: "l"(p), "h"(r.h));
    } else {
      asm volatile("st.global.u16 [%0], %1;" :: "l"(p), "h"(r.h));
    }
  }
}

// Element e of VEC values of type T held in raw bytes, as f32 (exact).
template <typename T, int VEC>
__device__ __forceinline__ float value(const Raw<VEC * kSize<T>>& r, int e) {
  if constexpr (kSize<T> == 4) {
    return __uint_as_float(r.w[e]);
  } else if constexpr (VEC == 1) {
    return __uint_as_float(static_cast<unsigned>(r.h) << 16);
  } else {
    const unsigned x = r.w[e >> 1];
    return __uint_as_float((e & 1) ? (x & 0xffff0000u) : (x << 16));
  }
}

__device__ __forceinline__ unsigned bf16_bits(float x) {
  return static_cast<unsigned>(__bfloat16_as_ushort(__float2bfloat16_rn(x)));
}

// VEC f32 sums rounded once to T, as raw bytes.
template <typename T, int VEC>
__device__ __forceinline__ Raw<VEC * kSize<T>> pack(const float (&v)[VEC]) {
  Raw<VEC * kSize<T>> r;
  if constexpr (kSize<T> == 4) {
#pragma unroll
    for (int e = 0; e < VEC; ++e) r.w[e] = __float_as_uint(v[e]);
  } else if constexpr (VEC == 1) {
    r.h = static_cast<unsigned short>(bf16_bits(v[0]));
  } else {
#pragma unroll
    for (int e = 0; e < VEC / 2; ++e) r.w[e] = bf16_bits(v[2 * e]) | (bf16_bits(v[2 * e + 1]) << 16);
  }
  return r;
}

template <typename T, int VEC>
__device__ __forceinline__ Raw<VEC * kSize<T>> zero_raw() {
  Raw<VEC * kSize<T>> r;
  if constexpr (VEC * kSize<T> == 2) {
    r.h = 0;
  } else {
#pragma unroll
    for (int e = 0; e < VEC * kSize<T> / 4; ++e) r.w[e] = 0u;
  }
  return r;
}

template <typename T>
__device__ __forceinline__ float ld_weight(const T* p) {
  return value<T, 1>(ld_nc<kSize<T>, false>(p, 0ull), 0);
}

__device__ __forceinline__ int ld_id(const int* p) {
  return static_cast<int>(ld_nc<4, false>(p, 0ull).w[0]);
}

// Where bag `bag` (< 2^31) starts in out: element (bag / G) * ld + (bag % G) * D.
__device__ __forceinline__ long long out_offset(long long bag, int G, long long ld, int D) {
  const unsigned b = static_cast<unsigned>(bag);
  const unsigned q = b / static_cast<unsigned>(G);
  return static_cast<long long>(q) * ld + static_cast<long long>(b - q * G) * D;
}

// Vector and scalar regimes: lanes over D, a tile of 32 * kTileIds bags
// per warp, kRowsInFlight rows a lane in flight.
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
    bag_rows_kernel(const T* __restrict__ table, const int* __restrict__ idx,
                    const T* __restrict__ w, T* __restrict__ out, int B, int K,
                    int D, int G, long long ld, int lane_shift, int chunks) {
  constexpr int kBytes = VEC * kSize<T>;
  constexpr int kTile = 32 * kTileIds;
  constexpr int U = kRowsInFlight;
  const int lane = threadIdx.x & 31;
  const int lanes = 1 << lane_shift;  // lanes per row group
  const int gpw = 32 >> lane_shift;   // row groups per warp
  const int group = lane >> lane_shift;
  const int sub = lane & (lanes - 1);
  const int per_group = kTileIds * lanes;  // a tile's bags per group
  const long long tiles = (B + kTile - 1LL) / kTile;
  const long long wstride = static_cast<long long>(gridDim.x) * kWarps;
  long long tile = static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  unsigned long long pol = 0ull;
  if constexpr (kEvictLast) pol = evict_last_policy();

  // Slot k's ids and weights of a tile's bags: lane l holds bag l + 32 i.
  int id[kTileIds];
  float wt[kTileIds];
  auto load_step = [&](long long t, int k, int (&ids)[kTileIds], float (&ws)[kTileIds]) {
#pragma unroll
    for (int i = 0; i < kTileIds; ++i) {
      const long long bag = t * kTile + i * 32 + lane;
      ids[i] = 0;
      ws[i] = 0.0f;
      if (bag < B) {
        const long long off = bag * K + k;
        ids[i] = ld_id(idx + off);
        ws[i] = ld_weight(w + off);
      }
    }
  };
  if (K > 0 && tile < tiles) load_step(tile, 0, id, wt);
  // Every loop bound below is the same for the whole warp, so the
  // full-mask shuffles stay convergent.
  for (; tile < tiles; tile += wstride) {
    const long long bag0 = tile * kTile;
    long long at[kTileIds];  // where the bags this lane holds ids of start in out
#pragma unroll
    for (int i = 0; i < kTileIds; ++i) {
      const long long bag = bag0 + i * 32 + lane;
      at[i] = bag < B ? out_offset(bag, G, ld, D) : 0;
    }
    for (int c = 0; c < chunks; ++c) {
      const int col = (c * lanes + sub) * VEC;
      const bool col_ok = col < D;
      const bool last_chunk = c + 1 == chunks;
      for (int j0 = 0; j0 < per_group; j0 += U) {
        const bool last_pass = last_chunk && j0 + U >= per_group;
        bool ok[U];
        int src[U];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          src[u] = (j0 + u) * gpw + group;  // the bag's place in the tile
          ok[u] = col_ok && j0 + u < per_group && bag0 + src[u] < B;
        }
        float acc[U][VEC];
#pragma unroll
        for (int u = 0; u < U; ++u) {
#pragma unroll
          for (int e = 0; e < VEC; ++e) acc[u][e] = 0.0f;
        }
        for (int k = 0; k < K; ++k) {
          float wk[U];
          Raw<kBytes> r[U];
#pragma unroll
          for (int u = 0; u < U; ++u) {
            int v = 0;
            wk[u] = 0.0f;
#pragma unroll
            for (int i = 0; i < kTileIds; ++i) {
              const int vi = __shfl_sync(kFull, id[i], src[u] & 31);
              const float wi = __shfl_sync(kFull, wt[i], src[u] & 31);
              if ((src[u] >> 5) == i) {
                v = vi;
                wk[u] = wi;
              }
            }
            r[u] = ok[u] ? ld_row<kBytes>(table + static_cast<size_t>(v) * D + col, pol)
                         : zero_raw<T, VEC>();
          }
          // The next step's ids, in flight beside this step's rows.
          long long nt = tile;
          int nk = k + 1;
          if (nk == K) {
            nk = 0;
            if (last_pass) nt = tile + wstride;
          }
          if ((nt != tile || nk != k) && nt < tiles) load_step(nt, nk, id, wt);
#pragma unroll
          for (int u = 0; u < U; ++u) {
#pragma unroll
            for (int e = 0; e < VEC; ++e) acc[u][e] = fmaf(wk[u], value<T, VEC>(r[u], e), acc[u][e]);
          }
        }
#pragma unroll
        for (int u = 0; u < U; ++u) {
          long long o = 0;
#pragma unroll
          for (int i = 0; i < kTileIds; ++i) {
            const long long oi = __shfl_sync(kFull, at[i], src[u] & 31);
            if ((src[u] >> 5) == i) o = oi;
          }
          if (ok[u]) st_out<kBytes>(out + o + col, pack<T, VEC>(acc[u]));
        }
      }
    }
  }
}

// Slots regime: lanes over K.  `lanes` threads a bag; lane j sums id
// vectors j, j + lanes, ... of KV slots each, SB vectors in flight, for
// all D (<= DC) columns; the group reduces with a fixed shuffle tree.
template <typename T, int DC, int KV>
__global__ void __launch_bounds__(kThreads)
    bag_slots_kernel(const T* __restrict__ table, const int* __restrict__ idx,
                     const T* __restrict__ w, T* __restrict__ out, int B, int K,
                     int D, int G, long long ld, int lane_shift) {
  constexpr int SB = (32 / (KV * DC)) < 1 ? 1 : ((32 / (KV * DC)) > 8 ? 8 : 32 / (KV * DC));
  const int lane = threadIdx.x & 31;
  const int lanes = 1 << lane_shift;  // lanes per bag
  const int bpw = 32 >> lane_shift;   // bags per warp tile
  const int sub = lane & (lanes - 1);
  const int nvec = K / KV;
  const long long tiles = (B + bpw - 1LL) / bpw;
  const long long wstride = static_cast<long long>(gridDim.x) * kWarps;
  unsigned long long pol = 0ull;
  if constexpr (kEvictLast) pol = evict_last_policy();
  for (long long tile = static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
       tile < tiles; tile += wstride) {
    const long long bag = tile * bpw + (lane >> lane_shift);
    const bool live = bag < B;
    float acc[DC];
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[c] = 0.0f;
    if (live) {
      const int* ib = idx + bag * K;
      const T* wb = w + bag * K;
      for (int v0 = sub; v0 < nvec; v0 += SB * lanes) {
        int ids[SB][KV];
        float ws[SB][KV];
        bool ok[SB];
#pragma unroll
        for (int s = 0; s < SB; ++s) {
          const int vi = v0 + s * lanes;
          ok[s] = vi < nvec;
#pragma unroll
          for (int e = 0; e < KV; ++e) {
            ids[s][e] = 0;
            ws[s][e] = 0.0f;
          }
          if (ok[s]) {
            const Raw<4 * KV> ri = ld_nc<4 * KV, false>(ib + vi * KV, 0ull);
            const Raw<KV * kSize<T>> rw = ld_nc<KV * kSize<T>, false>(wb + vi * KV, 0ull);
#pragma unroll
            for (int e = 0; e < KV; ++e) {
              ids[s][e] = static_cast<int>(ri.w[e]);
              ws[s][e] = value<T, KV>(rw, e);
            }
          }
        }
        float vals[SB][KV][DC];
#pragma unroll
        for (int s = 0; s < SB; ++s) {
#pragma unroll
          for (int e = 0; e < KV; ++e) {
            const T* row = table + static_cast<size_t>(ids[s][e]) * D;
#pragma unroll
            for (int c = 0; c < DC; ++c) {
              vals[s][e][c] = (ok[s] && c < D) ? value<T, 1>(ld_row<kSize<T>>(row + c, pol), 0) : 0.0f;
            }
          }
        }
#pragma unroll
        for (int s = 0; s < SB; ++s) {
          if (ok[s]) {
#pragma unroll
            for (int e = 0; e < KV; ++e) {
#pragma unroll
              for (int c = 0; c < DC; ++c) acc[c] = fmaf(ws[s][e], vals[s][e][c], acc[c]);
            }
          }
        }
      }
    }
    // All lanes of the warp take part, live or not.
    for (int off = lanes >> 1; off > 0; off >>= 1) {
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[c] += __shfl_xor_sync(kFull, acc[c], off, lanes);
    }
    if (live && sub == 0) {
      T* orow = out + out_offset(bag, G, ld, D);
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        if (c < D) {
          const float one[1] = {acc[c]};
          st_out<kSize<T>>(orow + c, pack<T, 1>(one));
        }
      }
    }
  }
}

// Blocks of one kernel that fit an SM at once (its first launch asks).
template <auto Kernel>
int blocks_per_sm() {
  static const int n = [] {
    int v = 0;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&v, Kernel, kThreads, 0);
    return v > 0 ? v : 1;
  }();
  return n;
}

int sm_count(int device) {
  static int counts[64] = {0};
  if (device < 0 || device >= 64) return 132;
  if (counts[device] == 0) {
    int n = 0;
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, device);
    counts[device] = n > 0 ? n : 132;
  }
  return counts[device];
}

template <auto Kernel, typename... Args>
cudaError_t run(long long tiles, int device, cudaStream_t st, Args... args) {
  long long blocks = (tiles + kWarps - 1) / kWarps;
  if constexpr (kPersistent) {
    const long long cap = static_cast<long long>(blocks_per_sm<Kernel>()) * sm_count(device);
    if (blocks > cap) blocks = cap;
  }
  if (blocks < 1) blocks = 1;
  Kernel<<<static_cast<unsigned>(blocks), kThreads, 0, st>>>(args...);
  return cudaSuccess;
}

// regime 0: vector / scalar (lanes over D, `vec` elements a lane: 16 bytes
// or 1); regime 1: slots (lanes over K, `vec` ids a load: 4 or 1).
template <typename T>
cudaError_t launch(const void* table, const void* idx, const void* w, void* out,
                   int B, int K, int D, int G, long long ld, int regime, int vec,
                   int lane_shift, int device, cudaStream_t st) {
  const T* t = static_cast<const T*>(table);
  const int* i = static_cast<const int*>(idx);
  const T* wp = static_cast<const T*>(w);
  T* o = static_cast<T*>(out);
  if (lane_shift < 0 || lane_shift > 5 || G < 1) return cudaErrorInvalidValue;
  const int lanes = 1 << lane_shift;
  if (regime == 0) {
    constexpr int kVec = 16 / kSize<T>;
    if ((vec != 1 && vec != kVec) || D % vec != 0) return cudaErrorInvalidValue;
    const int chunks = (D + lanes * vec - 1) / (lanes * vec);
    const long long tiles = (B + 32LL * kTileIds - 1) / (32LL * kTileIds);
    if (vec == kVec) {
      return run<bag_rows_kernel<T, kVec>>(tiles, device, st, t, i, wp, o, B, K, D, G, ld,
                                           lane_shift, chunks);
    }
    return run<bag_rows_kernel<T, 1>>(tiles, device, st, t, i, wp, o, B, K, D, G, ld,
                                      lane_shift, chunks);
  }
  if (regime != 1 || D > 4 || (vec != 1 && vec != 4) || K % vec != 0) {
    return cudaErrorInvalidValue;
  }
  const long long tiles = (B + (32 >> lane_shift) - 1LL) / (32 >> lane_shift);
  if (vec == 4) {
    if (D == 1) {
      return run<bag_slots_kernel<T, 1, 4>>(tiles, device, st, t, i, wp, o, B, K, D, G, ld,
                                            lane_shift);
    }
    if (D == 2) {
      return run<bag_slots_kernel<T, 2, 4>>(tiles, device, st, t, i, wp, o, B, K, D, G, ld,
                                            lane_shift);
    }
    return run<bag_slots_kernel<T, 4, 4>>(tiles, device, st, t, i, wp, o, B, K, D, G, ld,
                                          lane_shift);
  }
  if (D == 1) {
    return run<bag_slots_kernel<T, 1, 1>>(tiles, device, st, t, i, wp, o, B, K, D, G, ld,
                                          lane_shift);
  }
  if (D == 2) {
    return run<bag_slots_kernel<T, 2, 1>>(tiles, device, st, t, i, wp, o, B, K, D, G, ld,
                                          lane_shift);
  }
  return run<bag_slots_kernel<T, 4, 1>>(tiles, device, st, t, i, wp, o, B, K, D, G, ld,
                                        lane_shift);
}

}  // namespace

extern "C" int embedding_bag_launch(const void* table, const void* idx,
                                    const void* w, void* out, int B, int K,
                                    int D, int G, long long ld, int bf16,
                                    int regime, int vec, int lane_shift,
                                    int device, void* stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t bad =
      bf16 ? launch<__nv_bfloat16>(table, idx, w, out, B, K, D, G, ld, regime, vec,
                                   lane_shift, device, st)
           : launch<float>(table, idx, w, out, B, K, D, G, ld, regime, vec, lane_shift,
                           device, st);
  if (bad != cudaSuccess) return static_cast<int>(bad);
  return static_cast<int>(cudaGetLastError());
}
