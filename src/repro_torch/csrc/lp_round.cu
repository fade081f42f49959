// Fused dense DHLP-2 round out = c * base + A @ F, on Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/lp_blockspmm/kernel.py::lp_round
// and computes the same function: A (N, N), F (N, S), base (N, S), all f32
// or all bf16; the products and their sum are held to f32 accuracy and
// the output is stored in F's type (one rounding).
//
// Bound on this card: 2 N^2 S operations (170 GFLOP at the main path's
// N = S = 4396), far above the bytes term.  Plain f32 runs on the CUDA
// cores at 67 TFLOP/s (2.54 ms); one TF32 tensor-core product keeps only
// 10 mantissa bits of each operand.  This kernel issues three TF32
// products per f32 product on the 495 TFLOP/s tensor cores (1.03 ms).
//
// Design.
// - 3xTF32.  Every operand x is split into two TF32 terms, hi = rna(x)
//   (round to nearest, ties away from zero, to 10 mantissa bits) and
//   lo = rna(x - hi), and A.F is summed as A_hi F_hi + A_hi F_lo +
//   A_lo F_hi: each product is exact in f32, and the lo.lo term lies below
//   f32's last bit.  bf16 storage: bf16 values are exact in TF32, the lo
//   terms are zero, and the kernel issues the hi.hi product alone.
// - Promotion.  The tensor core's f32 accumulation drops bits: summed in
//   its accumulator over all of k, the three products land 17x further
//   from an f64 product than an f32 FMA product does at the main path's
//   shape (tools/lp_round_variants.py).  So the accumulator sums one
//   stage (32 of k) from scale-d 0 and is then added into a separate f32
//   register sum (kPromote), which lands at 0.5x.
// - Layouts.  TF32 wgmma reads its shared-memory operand K-major only, so
//   a pre-pass (split_f_kernel) writes F^T_hi and F^T_lo as (S, N4) f32
//   rows, N4 = N rounded up to 4 so that a row is a multiple of TMA's 16
//   bytes, zero past N.  A (N, N) row-major is already K-major.  It is the
//   register operand: each consumer thread loads its fragment from the
//   block's shared A tile and splits it in registers, so A_lo needs no
//   tile of its own.  A arrives by TMA straight from the caller's tensor
//   when it is f32 with 16-byte rows (N % 4 == 0, as on the main path);
//   otherwise (bf16, or a ragged N) the pre-pass writes an f32 copy
//   (N, N4) padded with zeros.  Non-finite inputs are outside the
//   contract: an Inf in A or F gives NaN through its lo term.
// - Tiles and pipeline.  A block computes a 128 x kBN output tile: two
//   consumer warpgroups of 64 rows, and one producer thread that keeps
//   TMA loads of k-stages in a ring of stages<>() slots (full and empty
//   mbarriers; 3 slots for f32 at kBN = 192).  A stage is 32 columns of k,
//   one 128-byte swizzled row per tile row: the A tile (128 x 32) and the
//   F^T_hi and F^T_lo tiles (kBN x 32).  Per 8-deep k-step a consumer
//   loads and splits its fragment and issues the m64n{kBN}k8 wgmmas of the
//   three products as one group while the previous group runs.  No
//   register is written into the accumulator: each stage starts it by
//   scale-d 0 (register writes between wgmmas would serialize them).
//   c * base is added in the epilogue and the sum rounded once.  Wider
//   tiles move fewer bytes from L2 per product (every variant loaded its
//   tiles at 4.1-4.3 TB/s); 192 is the widest whose accumulator and sum
//   fit the consumers' 232 registers.
// - Order.  Blocks are rastered in groups of kGroupRows row tiles, so the
//   blocks resident together share A row tiles and F^T column tiles in
//   L2.  The k order is fixed, with no split-K and no atomics: two
//   launches give the same bytes.

#include <cuda.h>  // CUtensorMap and its encoder's types only: libcuda is not linked
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 128;  // output rows per block: two consumer warpgroups
constexpr int kBN = 192;  // output columns per block (the wgmma N)
constexpr int kBK = 32;   // k per stage: 32 f32, one 128-byte swizzle row
constexpr int kConsumers = 2;
constexpr int kThreads = 128 * (kConsumers + 1);  // + the producer warpgroup
constexpr int kGroupRows = 8;  // row tiles per raster group
// fold the wgmma accumulator into a separate f32 register sum after every
// stage (scale-d 0 restarts it); false leaves the whole sum to the tensor
// core, which misses the f64 gate (a variant tools/lp_round_variants.py builds)
constexpr bool kPromote = true;
constexpr uint32_t kATile = kBM * kBK * 4;
constexpr uint32_t kFTile = kBN * kBK * 4;
// dynamic shared memory a block may hold, less the alignment slack and barriers
constexpr uint32_t kRingBudget = 232448 - 1024 - 128;

template <bool kThree>
__host__ __device__ constexpr uint32_t stage_bytes() {
  return kATile + (kThree ? 2u : 1u) * kFTile;
}
template <bool kThree>
__host__ __device__ constexpr int stages() {
  return kRingBudget / stage_bytes<kThree>() < 4 ? kRingBudget / stage_bytes<kThree>() : 4;
}
template <bool kThree>
__host__ __device__ constexpr size_t smem_bytes() {
  return 1024 + static_cast<size_t>(stages<kThree>()) * stage_bytes<kThree>() +
         16 * stages<kThree>();
}
static_assert(stages<true>() >= 2, "the ring needs two stages");

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// x rounded to TF32 (10 mantissa bits), ties away from zero, as f32 bits
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

__device__ __forceinline__ uint32_t smem_addr(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

// ---------------------------------------- mbarriers and TMA

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred p;\nWAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@p bra DONE;\nbra WAIT;\nDONE:\n}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}
// box (32 columns, rows) of a 2-D f32 tensor map at (c0, c1), 128-byte swizzled
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// ---------------------------------------- wgmma

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
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// A K-major operand of 128-byte rows, 128-byte swizzled (what TMA's
// SWIZZLE_128B writes into a 1024-byte aligned tile): 8-row groups 1024
// bytes apart; a k-step of 8 f32 starts 32 bytes further along the row.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr) {
  return static_cast<uint64_t>((addr >> 4) & 0x3FFF) | (1ull << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

// d (64 x N) += A (64 x 8, tf32 registers) . B (8 x N, tf32, K-major, shared),
// N = 2 NR; scale_d 0: d = A . B, its old value ignored
template <int NR>
__device__ __forceinline__ void wgmma_tf32(float (&d)[NR], const uint32_t (&a)[4], uint64_t db,
                                           int scale_d) {
  static_assert(NR == 64 || NR == 96 || NR == 128, "N is 128, 192 or 256");
  if constexpr (NR == 64) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
  } else if constexpr (NR == 96) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %101, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n192k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95}, {%96, %97, %98, %99}, %100, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
  } else if constexpr (NR == 128) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, {%128, %129, %130, %131}, %132, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
  }
}

// ---------------------------------------- the pre-pass

// F (N, S) -> F^T_hi and, for kThree, F^T_lo: (S, N4) f32 TF32 terms,
// zero for k in [N, N4); a 32 x 32 tile through shared memory so that
// both the read and the write are coalesced.
template <typename T, bool kThree>
__global__ void __launch_bounds__(256)
    split_f_kernel(const T* __restrict__ F, float* __restrict__ ft_hi,
                   float* __restrict__ ft_lo, int N, int S, int N4) {
  __shared__ float tile[32][33];
  const int k0 = blockIdx.x * 32;
  const int s0 = blockIdx.y * 32;
  for (int i = threadIdx.y; i < 32; i += 8) {
    const int k = k0 + i, s = s0 + threadIdx.x;
    tile[i][threadIdx.x] = (k < N && s < S) ? to_f32(F[static_cast<size_t>(k) * S + s]) : 0.0f;
  }
  __syncthreads();
  for (int i = threadIdx.y; i < 32; i += 8) {
    const int s = s0 + i, k = k0 + threadIdx.x;
    if (s < S && k < N4) {
      const float x = tile[threadIdx.x][i];
      const uint32_t hi = tf32_rna(x);
      const size_t o = static_cast<size_t>(s) * N4 + k;
      ft_hi[o] = __uint_as_float(hi);
      if constexpr (kThree) ft_lo[o] = __uint_as_float(tf32_rna(x - __uint_as_float(hi)));
    }
  }
}

// A (N, N) -> an f32 copy (N, N4), zero for k in [N, N4)
template <typename T>
__global__ void __launch_bounds__(256)
    pad_a_kernel(const T* __restrict__ A, float* __restrict__ a_pad, int N, int N4) {
  const size_t total = static_cast<size_t>(N) * N4;
  for (size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < total;
       i += static_cast<size_t>(gridDim.x) * blockDim.x) {
    const size_t r = i / N4;
    const int k = static_cast<int>(i - r * N4);
    a_pad[i] = k < N ? to_f32(A[r * N + k]) : 0.0f;
  }
}

// ---------------------------------------- the product

// The consumer's A fragment of k-step kk (columns 8 kk .. 8 kk + 7 of the
// stage) from the swizzled A tile: rows ra and ra + 8 (ra % 8 == g),
// columns t and t + 4, split into TF32 terms.  Element (r, k) of the tile
// lies at float r * 32 + 4 ((k / 4) ^ (r % 8)) + k % 4.
template <bool kThree>
__device__ __forceinline__ void load_split(const float* at, int ra, int g, int t, int kk,
                                           uint32_t (&hi)[4], uint32_t (&lo)[4]) {
  const int c0 = (((2 * kk) ^ g) << 2) + t;
  const int c1 = (((2 * kk + 1) ^ g) << 2) + t;
  const float x[4] = {at[ra * 32 + c0], at[(ra + 8) * 32 + c0], at[ra * 32 + c1],
                      at[(ra + 8) * 32 + c1]};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    hi[i] = tf32_rna(x[i]);
    if constexpr (kThree) lo[i] = tf32_rna(x[i] - __uint_as_float(hi[i]));
  }
}

template <typename T, bool kThree>
__global__ void __launch_bounds__(kThreads, 1)
    lp_round_kernel(const __grid_constant__ CUtensorMap ta, const __grid_constant__ CUtensorMap tf_hi,
                    const __grid_constant__ CUtensorMap tf_lo, const T* __restrict__ base,
                    T* __restrict__ out, int N, int S, int n_k, int n_row_tiles,
                    int n_col_tiles, float c) {
  constexpr int NS = stages<kThree>();
  constexpr uint32_t kStage = stage_bytes<kThree>();
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t ring = (raw + 1023u) & ~1023u;  // 128-byte swizzle needs 1024-byte tiles
  const uint8_t* ring_ptr = smem_raw + (ring - raw);
  const uint32_t full0 = ring + NS * kStage;  // NS full mbarriers, then NS empty ones
  const uint32_t empty0 = full0 + 8 * NS;

  // raster: kGroupRows row tiles at a time, column tiles within a group
  const int per_group = kGroupRows * n_col_tiles;
  const int group = blockIdx.x / per_group;
  const int first = group * kGroupRows;
  const int rows_in_group = min(kGroupRows, n_row_tiles - first);
  const int in_group = blockIdx.x - group * per_group;
  const int row0 = (first + in_group % rows_in_group) * kBM;
  const int col0 = (in_group / rows_in_group) * kBN;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  if (tid == 0) {
#pragma unroll
    for (int st = 0; st < NS; ++st) {
      mbar_init(full0 + 8 * st, 1);
      mbar_init(empty0 + 8 * st, 4 * kConsumers);  // lane 0 of every consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= 4 * kConsumers) {
    // the producer warpgroup: one thread keeps the ring full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (tid == 128 * kConsumers) {
      for (int s = 0; s < n_k; ++s) {
        const int st = s % NS;
        if (s >= NS) mbar_wait(empty0 + 8 * st, ((s / NS) - 1) & 1);
        const uint32_t bar = full0 + 8 * st;
        const uint32_t tile = ring + st * kStage;
        mbar_expect_tx(bar, kStage);
        tma_load(tile, &ta, bar, s * kBK, row0);
        tma_load(tile + kATile, &tf_hi, bar, s * kBK, col0);
        if constexpr (kThree) tma_load(tile + kATile + kFTile, &tf_lo, bar, s * kBK, col0);
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int g = lane >> 2;
    const int t = lane & 3;
    const int ra = 16 * warp + g;  // this thread's fragment rows ra, ra + 8 of the tile
    float acc[kBN / 2];
    float sum[kBN / 2];
    if constexpr (kPromote) {
#pragma unroll
      for (int i = 0; i < kBN / 2; ++i) sum[i] = 0.0f;
    }
    for (int s = 0; s < n_k; ++s) {
      const int st = s % NS;
      mbar_wait(full0 + 8 * st, (s / NS) & 1);
      const float* at = reinterpret_cast<const float*>(ring_ptr + st * kStage);
      const uint32_t fh = ring + st * kStage + kATile;
      const uint32_t fl = fh + kFTile;
#pragma unroll
      for (int kk = 0; kk < kBK / 8; ++kk) {
        uint32_t hi[4], lo[4];
        load_split<kThree>(at, ra, g, t, kk, hi, lo);
        wgmma_fence();
        wgmma_tf32(acc, hi, desc_sw128(fh + 32 * kk), kPromote ? kk > 0 : s > 0 || kk > 0);
        if constexpr (kThree) {
          wgmma_tf32(acc, hi, desc_sw128(fl + 32 * kk), 1);
          wgmma_tf32(acc, lo, desc_sw128(fh + 32 * kk), 1);
        }
        wgmma_commit();
        if constexpr (kPromote) {
          if (kk + 1 < kBK / 8) wgmma_wait<1>();
        } else {
          wgmma_wait<1>();  // the previous k-step's group is done
          // that group was the previous stage's last: its slot goes back to the producer
          if (kk == 0 && s > 0 && lane == 0) mbar_arrive(empty0 + 8 * ((s - 1) % NS));
        }
      }
      if constexpr (kPromote) {
        wgmma_wait<0>();
        fence_regs(acc);
        if (lane == 0) mbar_arrive(empty0 + 8 * st);
#pragma unroll
        for (int i = 0; i < kBN / 2; ++i) sum[i] += acc[i];
      }
    }
    if constexpr (!kPromote) {
      wgmma_wait<0>();
      fence_regs(acc);
    }

    // epilogue: c * base + the product, rounded once to T
    const int r_lo = row0 + ra;
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j) {
      const int col = col0 + 8 * j + 2 * t;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = r_lo + (e >= 2 ? 8 : 0);
        const int cc = col + (e & 1);
        if (r < N && cc < S) {
          const size_t o = static_cast<size_t>(r) * S + cc;
          const float v = kPromote ? sum[4 * j + e] : acc[4 * j + e];
          store(out + o, c * to_f32(base[o]) + v);
        }
      }
    }
  }
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

// a row-major (rows, cols) f32 matrix with rows `pitch` floats apart, read
// in boxes of (32 columns, box_rows), 128-byte swizzled; reads past either
// edge fill with zeros
cudaError_t encode_map(CUtensorMap* map, const void* base, int rows, int cols, int pitch,
                       int box_rows) {
  const EncodeTiled encode = tensor_map_encoder();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(pitch) * 4};
  const cuuint32_t box[2] = {kBK, static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t unit[2] = {1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<void*>(base),
                            dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <typename T, bool kThree>
cudaError_t launch(const void* A, const void* F, const void* base, void* out, float* ft_hi,
                   float* ft_lo, float* a_pad, int N, int S, float c, cudaStream_t st) {
  const int N4 = (N + 3) / 4 * 4;
  if (a_pad != nullptr) {
    const long long total = static_cast<long long>(N) * N4;
    const int blocks = static_cast<int>(total / 256 + 1 < 4096 ? total / 256 + 1 : 4096);
    pad_a_kernel<T><<<blocks, 256, 0, st>>>(static_cast<const T*>(A), a_pad, N, N4);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }
  split_f_kernel<T, kThree><<<dim3((N4 + 31) / 32, (S + 31) / 32), dim3(32, 8), 0, st>>>(
      static_cast<const T*>(F), ft_hi, ft_lo, N, S, N4);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;

  CUtensorMap ta, th, tl;
  e = a_pad != nullptr ? encode_map(&ta, a_pad, N, N4, N4, kBM) : encode_map(&ta, A, N, N, N, kBM);
  if (e != cudaSuccess) return e;
  e = encode_map(&th, ft_hi, S, N4, N4, kBN);
  if (e != cudaSuccess) return e;
  e = encode_map(&tl, kThree ? ft_lo : ft_hi, S, N4, N4, kBN);
  if (e != cudaSuccess) return e;

  constexpr size_t smem = smem_bytes<kThree>();
  auto kern = lp_round_kernel<T, kThree>;
  e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  const int n_row_tiles = (N + kBM - 1) / kBM;
  const int n_col_tiles = (S + kBN - 1) / kBN;
  const int n_k = (N4 + kBK - 1) / kBK;
  kern<<<n_row_tiles * n_col_tiles, kThreads, smem, st>>>(
      ta, th, tl, static_cast<const T*>(base), static_cast<T*>(out), N, S, n_k, n_row_tiles,
      n_col_tiles, c);
  return cudaGetLastError();
}

}  // namespace

// out = c * base + A @ F.  ft_hi (and ft_lo for f32) are (S, N4) f32
// scratch, N4 = N rounded up to 4; a_pad is an (N, N4) f32 scratch, or
// null when A is f32 with N % 4 == 0 and 16-byte aligned (TMA reads it in
// place).  bf16 storage takes the one-product regime and no ft_lo.
extern "C" int lp_round_launch(const void* A, const void* F, const void* base, void* out,
                               void* ft_hi, void* ft_lo, void* a_pad, int N, int S, float c,
                               int bf16, int device, void* stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  if (!bf16 && ft_lo == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  if (bf16 && a_pad == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* hi = static_cast<float*>(ft_hi);
  float* lo = static_cast<float*>(ft_lo);
  float* pad = static_cast<float*>(a_pad);
  const cudaError_t e =
      bf16 ? launch<__nv_bfloat16, false>(A, F, base, out, hi, nullptr, pad, N, S, c, st)
           : launch<float, true>(A, F, base, out, hi, lo, pad, N, S, c, st);
  return static_cast<int>(e);
}
