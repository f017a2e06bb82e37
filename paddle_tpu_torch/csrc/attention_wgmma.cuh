// The 16-bit tensor-core tile loop shared by K1 (flash forward,
// flash_attention_fwd.cu) and K5 (paged prefill, paged_attention.cu), and
// the PTX pieces (wgmma, descriptors, cp.async, TileCopy) that the 16-bit
// backward kernels K2/K3 (flash_attention_bwd.cu) build on too.  The
// element type T is a template parameter, __nv_bfloat16 or __half: the
// layouts, tiles and fragments are the same for both (two bytes an
// element), and only the wgmma type suffix (.bf16 / .f16) and the
// conversions differ.  K1-K3 have instances of both; K5 of bf16 only.
//
// Same function as `attend_tile` in attention_common.cuh, which the f32 K5
// keeps (the f32 K1 runs the 3xTF32 loop of attention_tf32.cuh): scale 1/sqrt(D), masked scores -1e30, online softmax
// with an f32 running max, sum and accumulator, the l == 0 guard, and
// lse = m + log(l) from the f32 sum of the unrounded p.  The difference is
// where the products run:
//
//   * One warpgroup (128 threads) owns 64 queries of one head: the M = 64
//     of `wgmma`.  Q is loaded once into shared memory as T.
//   * The keys are walked 64 at a time up to the tile's horizon.  Tiles
//     wholly past it are never visited; only the diagonal and the ragged
//     last tile are masked.
//   * S = Q K^T is `wgmma.mma_async` m64n64k16 (T in, f32 out), D/16
//     steps, both operands K-major in shared memory.
//   * The online softmax runs on the accumulator fragment: a row's 64
//     scores sit in one quad of threads, so its max is two shuffles, and
//     the quad's partial sums are added once at the end.
//   * p is rounded to T in registers and is the register A operand of
//     O += P V (m64nDk16).  V is stored [keys][D], MN-major for B, so the
//     instruction transposes it.  O stays an f32 register accumulator,
//     rescaled by corr each tile.
//   * K/V tiles come through a two-stage ring of `cp.async.cg` 16-byte
//     copies whose rows are addressed by the caller's functor (a strided
//     row, or a row through the block table), so tile n+1 loads while tile
//     n computes.  Rows past the horizon or the table are zero-filled
//     (src-size 0), never left uninitialised: a stray 16-bit NaN pattern
//     survives a zero probability.
//
// Shared memory holds every tile in the layout a `wgmma` descriptor with
// 128-byte swizzle names: 64-column blocks of 64 rows x 128 bytes, the
// 16-byte chunk c of row r stored at chunk c ^ (r % 8).  At D = 128 that is
// Q 16 KB + 2 x (K 16 KB + V 16 KB) = 80 KB, so the launcher opts in past
// 48 KB.
//
// Rounding: p is rounded to T before P V.  The Pallas flash forward
// rounds p to v's dtype there too; the Pallas paged prefill keeps p in f32,
// so K5 departs from it by that one rounding.  Every rounding to f16 is to
// nearest and overflows to inf, as a Pallas astype does.
#pragma once

#include <type_traits>

#include "attention_common.cuh"

namespace pt {
namespace tc {

using bf16 = __nv_bfloat16;
using f16 = __half;

template <typename T>
constexpr bool kIsHalf = std::is_same<T, f16>::value;

constexpr int kTileM = 64;       // queries per block (wgmma M)
constexpr int kTileN = 64;       // keys per step
constexpr int kStages = 2;       // K/V ring depth
constexpr int kRowBytes = 128;   // one swizzle row: 64 16-bit elements
constexpr int kBlockBytes = kTileM * kRowBytes;  // 64 rows of one column block
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

template <int D>
struct Smem {
  static_assert(D % 64 == 0, "head dim in whole 64-column blocks");
  static constexpr int kTile = kTileM * D * 2;     // one Q, K or V tile
  static constexpr int kQ = 0;
  static constexpr int kK = kTile;
  static constexpr int kV = kK + kStages * kTile;
  static constexpr int kBytes = kV + kStages * kTile;
  static constexpr int kAlloc = kBytes + 1024;     // room to align to 1024
};

// -- PTX wrappers ----------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; src_bytes 0 writes zeros and reads nothing.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}

// 4 bytes global -> shared (the .cg form takes 16 only); src_bytes 0 writes
// zeros and reads nothing.
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// shared-memory writes of this thread become visible to wgmma's reads
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Pins accumulator registers in program order around the asynchronous
// wgmma: the compiler may not move their reads or writes across this.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// Shared-memory matrix descriptor, 128-byte swizzle.  K-major operands
// (Q, K): LBO 16 bytes (unused), SBO 1024 bytes between 8-row groups.
// MN-major (V): LBO 8192 bytes between 64-column blocks of D, SBO 1024 bytes
// between groups of 8 keys.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

#define PT_ACC8(i)                                                  \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),       \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// The three products, for T = bf16 or f16 (AB: the PTX type of A and B).
// d[64 x 64] (+)= A[64 x 16] B[64 x 16]^T, A and B K-major in shared memory
#define PT_WGMMA_SS_N64(AB)                                               \
  asm volatile(                                                           \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"                        \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." AB "." AB " "         \
      "{%0, %1, %2, %3, %4, %5, %6, %7, "                                 \
      "%8, %9, %10, %11, %12, %13, %14, %15, "                            \
      "%16, %17, %18, %19, %20, %21, %22, %23, "                          \
      "%24, %25, %26, %27, %28, %29, %30, %31}, "                         \
      "%32, %33, p, 1, 1, 0, 0;\n}\n"                                     \
      : PT_ACC8(0), PT_ACC8(8), PT_ACC8(16), PT_ACC8(24)                  \
      : "l"(a), "l"(b), "r"(scale_d))

// d[64 x 64] += A[64 x 16] (registers) B[16 x 64], B MN-major in shared
#define PT_WGMMA_RS_N64(AB)                                               \
  asm volatile(                                                           \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"                        \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." AB "." AB " "         \
      "{%0, %1, %2, %3, %4, %5, %6, %7, "                                 \
      "%8, %9, %10, %11, %12, %13, %14, %15, "                            \
      "%16, %17, %18, %19, %20, %21, %22, %23, "                          \
      "%24, %25, %26, %27, %28, %29, %30, %31}, "                         \
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"                       \
      : PT_ACC8(0), PT_ACC8(8), PT_ACC8(16), PT_ACC8(24)                  \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1))

// d[64 x 128] += A[64 x 16] (registers) B[16 x 128], B MN-major in shared
#define PT_WGMMA_RS_N128(AB)                                              \
  asm volatile(                                                           \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"                        \
      "wgmma.mma_async.sync.aligned.m64n128k16.f32." AB "." AB " "        \
      "{%0, %1, %2, %3, %4, %5, %6, %7, "                                 \
      "%8, %9, %10, %11, %12, %13, %14, %15, "                            \
      "%16, %17, %18, %19, %20, %21, %22, %23, "                          \
      "%24, %25, %26, %27, %28, %29, %30, %31, "                          \
      "%32, %33, %34, %35, %36, %37, %38, %39, "                          \
      "%40, %41, %42, %43, %44, %45, %46, %47, "                          \
      "%48, %49, %50, %51, %52, %53, %54, %55, "                          \
      "%56, %57, %58, %59, %60, %61, %62, %63}, "                         \
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"                       \
      : PT_ACC8(0), PT_ACC8(8), PT_ACC8(16), PT_ACC8(24), PT_ACC8(32),    \
        PT_ACC8(40), PT_ACC8(48), PT_ACC8(56)                             \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1))

template <typename T>
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t a,
                                             uint64_t b, int scale_d) {
  if constexpr (kIsHalf<T>)
    PT_WGMMA_SS_N64("f16");
  else
    PT_WGMMA_SS_N64("bf16");
}

template <typename T>
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t b) {
  if constexpr (kIsHalf<T>)
    PT_WGMMA_RS_N64("f16");
  else
    PT_WGMMA_RS_N64("bf16");
}

template <typename T>
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t b) {
  if constexpr (kIsHalf<T>)
    PT_WGMMA_RS_N128("f16");
  else
    PT_WGMMA_RS_N128("bf16");
}

#undef PT_WGMMA_SS_N64
#undef PT_WGMMA_RS_N64
#undef PT_WGMMA_RS_N128
#undef PT_ACC8

template <typename T, int D>
__device__ __forceinline__ void wgmma_rs(float (&d)[D / 2],
                                         const uint32_t (&a)[4], uint64_t b) {
  if constexpr (D == 64)
    wgmma_rs_n64<T>(d, a, b);
  else
    wgmma_rs_n128<T>(d, a, b);
}

// Two f32 values rounded to T (to nearest; f16 overflows to inf) and packed
// into one 32-bit register, `lo` in the low half: an A-fragment register,
// or two adjacent output elements.
template <typename T>
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  if constexpr (kIsHalf<T>) {
    const __half2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&v);
  } else {
    const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&v);
  }
}

// -- the tile loop ---------------------------------------------------------

// A thread's 16-byte copies into a [64 rows][D] tile: rows
// first_row + i * kRowStep, one fixed chunk, whose swizzled place differs
// between those rows only by the row's 128 bytes (kRowStep is a multiple
// of 8, so r % 8 is the same for all of them).
template <int D>
struct TileCopy {
  static constexpr int kChunks = D / 8;                 // per row
  static constexpr int kIters = kTileM * kChunks / kThreads;
  static constexpr int kRowStep = kThreads / kChunks;
  static_assert(kRowStep % 8 == 0, "one swizzle phase per thread");
  int first_row, chunk;
  uint32_t offset;  // of (first_row, chunk) in the tile
  __device__ __forceinline__ TileCopy(int tid)
      : first_row(tid / kChunks), chunk(tid % kChunks) {
    offset = (chunk / 8) * kBlockBytes + first_row * kRowBytes +
             (((chunk % 8) ^ (first_row % 8)) << 4);
  }
  __device__ __forceinline__ uint32_t dst(uint32_t tile, int i) const {
    return tile + offset + i * kRowStep * kRowBytes;
  }
};

// One 64-query tile against keys 0..horizon, on tensor cores.  Arguments as
// `attend_tile` (attention_common.cuh), plus `smem`: Smem<D>::kAlloc bytes
// of dynamic shared memory.  `key_at.limit()` is the first position with no
// storage.  With `Dropout`, each thread forms the keep bits
// of its 32 fragment values (one Philox call per 8-column group: rows
// qpos0 + r0 and + 8, which share a counter since qpos0 is a multiple of 64)
// and multiplies p by them before rounding it for P V; l, and so lse, keep
// the undropped p.
template <typename T, int D, typename KeyAt, typename Drop = NoDropout>
__device__ __forceinline__ void attend_tile(
    uint8_t* smem, const T* __restrict__ q_rows, long long q_stride,
    int n_rows, int qpos0, int horizon, bool causal,
    const T* __restrict__ k_base, const T* __restrict__ v_base,
    KeyAt key_at, float scale, T* __restrict__ o_rows, long long o_stride,
    float* __restrict__ lse_rows, const Drop& drop = Drop{}) {
  using L = Smem<D>;
  constexpr int kSteps = D / 16;  // k16 steps of Q K^T
  const int tid = threadIdx.x;
  const uint32_t base = (smem_u32(smem) + 1023) & ~1023u;
  const uint32_t q_sm = base + L::kQ;
  const TileCopy<D> cp(tid);
  const int n_keys = min(horizon + 1, key_at.limit());
  const int n_tiles = (n_keys + kTileN - 1) / kTileN;

  auto load_kv = [&](int t) {
    const int c0 = t * kTileN;
    const uint32_t k_sm = base + L::kK + (t % kStages) * L::kTile;
    const uint32_t v_sm = base + L::kV + (t % kStages) * L::kTile;
#pragma unroll
    for (int i = 0; i < TileCopy<D>::kIters; ++i) {
      const int pos = c0 + cp.first_row + i * TileCopy<D>::kRowStep;
      long long ko = 0, vo = 0;
      // the key's address (a table read for K5) does not wait for n_keys,
      // which K5 forms from a start it reads from memory: the two loads
      // are in flight together
      key_at(pos, ko, vo);
      const bool live = pos < n_keys;
      cp_async16(cp.dst(k_sm, i), k_base + (live ? ko : 0) + cp.chunk * 8,
                 live ? 16 : 0);
      cp_async16(cp.dst(v_sm, i), v_base + (live ? vo : 0) + cp.chunk * 8,
                 live ? 16 : 0);
    }
    cp_async_commit();
  };

#pragma unroll
  for (int i = 0; i < TileCopy<D>::kIters; ++i) {
    const int r = cp.first_row + i * TileCopy<D>::kRowStep;
    const bool live = r < n_rows;
    cp_async16(cp.dst(q_sm, i),
               q_rows + (live ? r * q_stride : 0) + cp.chunk * 8,
               live ? 16 : 0);
  }
  load_kv(0);  // one group with Q

  // fragment coordinates: rows r0 and r0 + 8 of the tile; in each 8-column
  // group j, columns 8j + cq and 8j + cq + 1 (s[4j..4j+1] on row r0,
  // s[4j+2..4j+3] on row r0 + 8)
  const int warp = tid / 32, lane = tid % 32;
  const int r0 = warp * 16 + lane / 4;
  const int cq = (lane % 4) * 2;
  const float scale_log2 = scale * kLog2e;
  float m[2] = {kNegInf, kNegInf};  // running max, log2 units
  float l[2] = {0.f, 0.f};          // this thread's share of the running sum
  float o[D / 2];
  float s[32];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait_all();  // tile t (and, first, Q) has landed
    fence_proxy_async();
    __syncthreads();      // ... for every thread; tile t-1's stage is free
    if (t + 1 < n_tiles) load_kv(t + 1);
    const uint32_t k_sm = base + L::kK + (t % kStages) * L::kTile;
    const uint32_t v_sm = base + L::kV + (t % kStages) * L::kTile;

    // S = Q K^T
    fence_regs(s);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kSteps; ++kk) {
      const uint32_t off = (kk / 4) * kBlockBytes + (kk % 4) * 32;
      wgmma_ss_n64<T>(s, desc_sw128(q_sm + off, 16, 1024),
                   desc_sw128(k_sm + off, 16, 1024), kk > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);

    // online softmax on the fragment
    const int c0 = t * kTileN;
    const bool masked = c0 + kTileN > n_keys ||
                        (causal && c0 + kTileN - 1 > qpos0);
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      const int row = (e / 2) % 2;
      float x = s[e] * scale_log2;
      if (masked) {
        const int kpos = c0 + 8 * (e / 4) + cq + e % 2;
        const bool ok = kpos < n_keys &&
                        (!causal || kpos <= qpos0 + r0 + 8 * row);
        x = ok ? x : kNegInf;
      }
      s[e] = x;
      mx[row] = fmaxf(mx[row], x);
    }
    float corr[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      corr[i] = exp2f(m[i] - mx[i]);
      m[i] = mx[i];
      l[i] *= corr[i];
    }
    uint32_t keep = 0;  // bit e: fragment value e is kept
    if constexpr (Drop::kOn) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
        keep |= drop.keep4(drop.words(qpos0 + r0, c0 + 8 * j + cq)) << (4 * j);
    }
    uint32_t p[4][4];  // A fragments of P, one per 16 keys
#pragma unroll
    for (int e = 0; e < 32; e += 2) {
      const int row = (e / 2) % 2;
      float p0 = exp2f(s[e] - m[row]);
      float p1 = exp2f(s[e + 1] - m[row]);
      l[row] += p0 + p1;
      if constexpr (Drop::kOn) {
        p0 *= drop.factor((keep >> e) & 1u);
        p1 *= drop.factor((keep >> (e + 1)) & 1u);
      }
      p[e / 8][(e % 8) / 2] = pack2<T>(p0, p1);
    }
#pragma unroll
    for (int e = 0; e < D / 2; ++e) o[e] *= corr[(e / 2) % 2];

    // O += P V
    fence_regs(o);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kTileN / 16; ++kk)
      wgmma_rs<T, D>(o, p[kk], desc_sw128(v_sm + kk * 16 * kRowBytes,
                                       kBlockBytes, 1024));
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(o);
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    const int r = r0 + 8 * i;
    const float li = l[i] == 0.f ? 1.f : l[i];
    if (r < n_rows) {
      const float inv = 1.f / li;
      T* out = o_rows + r * o_stride + cq;
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<uint32_t*>(out + 8 * j) = pack2<T>(
            o[4 * j + 2 * i] * inv, o[4 * j + 2 * i + 1] * inv);
      if (lse_rows != nullptr && cq == 0)
        lse_rows[r] = (m[i] + log2f(fmaxf(li, 1e-30f))) * kLn2;
    }
  }
}

// Which loop an instance runs: bf16 and f16 on these 16-bit tensor-core
// loops.  f32: K3 and K5 on their CUDA-core loops (kQueryTile, dynamic_smem
// are K5's), K1 and K2 on the 3xTF32 loops of attention_tf32.cuh, chosen
// in their own launchers.
template <typename T>
constexpr bool kOnTensorCores =
    std::is_same<T, bf16>::value || std::is_same<T, f16>::value;
template <typename T>
constexpr int kQueryTile = kOnTensorCores<T> ? kTileM : kTileQ;

// Dynamic shared memory of a K1/K5 instance, opting the kernel in past
// 48 KB (once per device, through the launcher's `opt_in`) where it needs
// more; returns the bytes or a negative cudaError_t.
template <typename T, int D, typename Kernel>
int dynamic_smem(Kernel kernel, SmemOptIn& opt_in) {
  if constexpr (!kOnTensorCores<T>) {
    return 0;
  } else {
    return opt_in(kernel, Smem<D>::kAlloc);
  }
}

}  // namespace tc
}  // namespace pt
