// The f32 tensor-core pieces of K1 (flash forward, flash_attention_fwd.cu)
// and K2 (dK/dV, flash_attention_bwd.cu): every product on `wgmma` with
// tf32 operands, in the 3xTF32 split that keeps f32 accuracy, and K1's f32
// tile loop.  K3 and K5 keep their f32 CUDA-core loops.
//
// 3xTF32: each f32 operand is split as x = hi + lo, hi = rna_tf32(x) and
// lo = rna_tf32(x - hi), and A B is formed as A_lo B_hi + A_hi B_lo +
// A_hi B_hi in one f32 accumulator, the small terms first (lo lo is
// dropped).  x - hi - lo is ~2^-22 x, so a product is off by a few f32
// ulps times sqrt(K), well inside the f32 instances' 1e-4; there are no
// atomics, and two calls on the same inputs agree bitwise.  The bound is
// three tf32 products at 495 TFLOP/s: an effective 165 TFLOP/s, against 67
// for f32 FMA on the CUDA cores.
//
// What tf32 `wgmma` forces:
//
//   * No transpose.  Only the 16-bit types read an MN-major B; a tf32 B
//     is K-major (the contraction dim contiguous) or nothing.  So an
//     operand contracted over its rows (V in P V; Q and dO in K2's
//     dK += dS^T Q and dV += P^T dO) is written transposed into shared
//     memory, by the threads, as its tile is split: `split_cols`.  K2 needs
//     Q and dO both ways (also contracted over D in S^T = K Q^T and
//     dP^T = V dO^T), each as hi and lo: eight tiles a query tile.
//   * The A fragment is not the accumulator's.  A thread's accumulator
//     holds columns 2t and 2t + 1 of each 8-column group (t = lane % 4); a
//     tf32 A fragment wants columns t and t + 4.  Instead of shuffling, the
//     8 columns of each group are taken in the order 0 2 4 6 1 3 5 7 (the
//     contraction's order does not change the sum's terms): the P (or P^T,
//     dS^T) fragment is the A fragment as it stands, and `split_cols`
//     writes the B tile's columns in that order.
//   * Splitting happens in registers, so nothing goes global -> shared as
//     the kernel reads it: tiles land raw (f32, by cp.async, 16-byte copies
//     where every row is 16-byte aligned, 4-byte ones otherwise), then the
//     threads split them into the tf32 hi/lo tiles.  A block's own rows
//     (K1's Q, K2's K and V) stay raw: `mma_nt` splits their A fragments
//     per k-step, so they cost one f32 copy, not two tf32 ones.
//
// Shared memory is the constraint.  A tf32 tile is held as the 128-byte
// swizzle lays it out (32-column blocks of R rows x 128 bytes, 16-byte
// chunk c of row r at chunk c ^ (r % 8)); a raw tile is rows of D floats
// with the same chunk swizzle, so the fragment reads (8 rows x 4 lanes)
// and the split passes hit 32 banks.  K1 at D 64: raw Q 16 KB, raw K/V of
// the next tile 32 KB, K hi/lo and V^T hi/lo 64 KB: 112 KB (two blocks an
// SM, just); at D 128 224 KB, one block.  The raw stage is the only ring:
// tile t + 1's copies run under tile t's products, but the split pass does
// not overlap the tensor cores.
#pragma once

#include "attention_wgmma.cuh"

namespace pt {
namespace tf32 {

using tc::cp_async16;
using tc::cp_async4;
using tc::cp_async_commit;
using tc::cp_async_wait_all;
using tc::desc_sw128;
using tc::fence_proxy_async;
using tc::fence_regs;
using tc::kLn2;
using tc::kLog2e;
using tc::kRowBytes;  // one swizzle row: 32 tf32 elements
using tc::smem_u32;
using tc::wgmma_commit;
using tc::wgmma_fence;
using tc::wgmma_wait_all;

constexpr int kRows = tc::kTileM;  // a warpgroup's rows (wgmma M)

__device__ __forceinline__ void wgmma_wait_1() {
  asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
}

// -- the split -------------------------------------------------------------

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ void split4(const float (&x)[4], uint32_t (&hi)[4],
                                       uint32_t (&lo)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    hi[i] = to_tf32(x[i]);
    lo[i] = to_tf32(x[i] - __uint_as_float(hi[i]));
  }
}

// -- tf32 wgmma, A from registers ---------------------------------------------

#define PT_TF32_ACC8(i)                                             \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),       \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define PT_TF32_IN "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), \
                   "r"(scale_d)

// d[64 x N] (+)= A[64 x 8] B[N x 8]^T: A four registers a thread (rows
// r0 and r0 + 8, columns t and t + 4), B K-major in shared memory
__device__ __forceinline__ void wgmma_n32(float (&d)[16],
                                          const uint32_t (&a)[4], uint64_t b,
                                          int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : PT_TF32_ACC8(0), PT_TF32_ACC8(8)
      : PT_TF32_IN);
}

__device__ __forceinline__ void wgmma_n64(float (&d)[32],
                                          const uint32_t (&a)[4], uint64_t b,
                                          int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : PT_TF32_ACC8(0), PT_TF32_ACC8(8), PT_TF32_ACC8(16), PT_TF32_ACC8(24)
      : PT_TF32_IN);
}

__device__ __forceinline__ void wgmma_n128(float (&d)[64],
                                           const uint32_t (&a)[4], uint64_t b,
                                           int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : PT_TF32_ACC8(0), PT_TF32_ACC8(8), PT_TF32_ACC8(16), PT_TF32_ACC8(24),
        PT_TF32_ACC8(32), PT_TF32_ACC8(40), PT_TF32_ACC8(48),
        PT_TF32_ACC8(56)
      : PT_TF32_IN);
}

#undef PT_TF32_IN
#undef PT_TF32_ACC8

template <int N>
__device__ __forceinline__ void wgmma(float (&d)[N / 2],
                                      const uint32_t (&a)[4], uint64_t b,
                                      int scale_d) {
  static_assert(N == 32 || N == 64 || N == 128, "wgmma width");
  if constexpr (N == 32)
    wgmma_n32(d, a, b, scale_d);
  else if constexpr (N == 64)
    wgmma_n64(d, a, b, scale_d);
  else
    wgmma_n128(d, a, b, scale_d);
}

// -- shared-memory layouts ----------------------------------------------------

// Byte offset of (row r, column col) in a raw tile of rows of D floats.
template <int D>
__device__ __forceinline__ uint32_t raw_at(int r, int col) {
  static_assert(D % 32 == 0, "whole swizzle periods a row");
  return r * D * 4 + ((((col >> 2) ^ (r & 7))) << 4) + (col & 3) * 4;
}

// Byte offset of 16-byte chunk c (columns 4c..4c+3) of row r in a tf32
// tile of R rows, K-major under the 128-byte swizzle.
template <int R>
__device__ __forceinline__ uint32_t tile_chunk(int r, int c) {
  return (c >> 3) * (R * kRowBytes) + r * kRowBytes +
         (((c & 7) ^ (r & 7)) << 4);
}

// Descriptor of k-step kk (columns 8kk..8kk+7) of a tf32 tile of R rows.
template <int R>
__device__ __forceinline__ uint64_t kstep(uint32_t tile, int kk) {
  return desc_sw128(tile + (kk >> 2) * (R * kRowBytes) + (kk & 3) * 32, 16,
                    1024);
}

// Rows 0..R-1 of a strided f32 slice into a raw tile at `dst`: row(r) is
// the address of row r; rows from n_live on are zero-filled (a stray NaN
// past S would survive a zero probability).  rows16: every row starts
// 16-byte aligned.  Adds the copies to the thread's open cp.async group.
// kT: the block's threads, all of which take part (as in the splits).
template <int R, int D, int kT = kThreads, typename Row>
__device__ __forceinline__ void load_raw(uint32_t dst, Row row, int n_live,
                                         bool rows16) {
  const int tid = threadIdx.x;
  if (rows16) {
    constexpr int kChunks = D / 4;
    static_assert(R * kChunks % kT == 0, "whole copies a thread");
#pragma unroll
    for (int it = 0; it < R * kChunks / kT; ++it) {
      const int i = tid + it * kT, r = i / kChunks, c = i % kChunks;
      const bool live = r < n_live;
      cp_async16(dst + raw_at<D>(r, 4 * c), row(live ? r : 0) + 4 * c,
                 live ? 16 : 0);
    }
  } else {
#pragma unroll 1
    for (int it = 0; it < R * D / kT; ++it) {
      const int i = tid + it * kT, r = i / D, col = i % D;
      const bool live = r < n_live;
      cp_async4(dst + raw_at<D>(r, col), row(live ? r : 0) + col,
                live ? 4 : 0);
    }
  }
}

// A raw [R][D] tile -> tf32 hi and lo tiles [R][D], K-major over D.
template <int R, int D, int kT = kThreads>
__device__ __forceinline__ void split_rows(const uint8_t* raw, uint8_t* hi,
                                           uint8_t* lo) {
  constexpr int kChunks = D / 4;
  static_assert(R * kChunks % kT == 0, "whole chunks a thread");
#pragma unroll
  for (int it = 0; it < R * kChunks / kT; ++it) {
    const int i = threadIdx.x + it * kT;
    const int r = i / kChunks, c = i % kChunks;
    const float4 v = *reinterpret_cast<const float4*>(raw + raw_at<D>(r, 4 * c));
    const float x[4] = {v.x, v.y, v.z, v.w};
    uint32_t h[4], l[4];
    split4(x, h, l);
    const uint32_t off = tile_chunk<R>(r, c);
    *reinterpret_cast<uint4*>(hi + off) = make_uint4(h[0], h[1], h[2], h[3]);
    *reinterpret_cast<uint4*>(lo + off) = make_uint4(l[0], l[1], l[2], l[3]);
  }
}

// A raw [R][D] tile -> tf32 hi and lo tiles of its transpose, [D][R],
// K-major over R, each group of 8 columns in the order 0 2 4 6 1 3 5 7 of
// the raw rows: the B operand of a product whose A is an accumulator
// fragment (see the file's head).  Chunk c of a row holds raw rows
// 8 (c / 2) + c % 2 + {0, 2, 4, 6}.
template <int R, int D, int kT = kThreads>
__device__ __forceinline__ void split_cols(const uint8_t* raw, uint8_t* hi,
                                           uint8_t* lo) {
  constexpr int kChunks = R / 4;  // per row of the transpose
  static_assert(D * kChunks % kT == 0, "whole chunks a thread");
#pragma unroll
  for (int it = 0; it < D * kChunks / kT; ++it) {
    const int i = threadIdx.x + it * kT;
    const int d = i % D, c = i / D;
    const int r = 8 * (c >> 1) + (c & 1);
    float x[4];
#pragma unroll
    for (int m = 0; m < 4; ++m)
      x[m] = *reinterpret_cast<const float*>(raw + raw_at<D>(r + 2 * m, d));
    uint32_t h[4], l[4];
    split4(x, h, l);
    const uint32_t off = tile_chunk<D>(d, c);
    *reinterpret_cast<uint4*>(hi + off) = make_uint4(h[0], h[1], h[2], h[3]);
    *reinterpret_cast<uint4*>(lo + off) = make_uint4(l[0], l[1], l[2], l[3]);
  }
}

// -- the two products ---------------------------------------------------------

// d[64 x N] = A B^T over D: A the raw [64][D] tile `a_raw` (its fragments
// read and split a k-step at a time), B_hi / B_lo tf32 [N][D] tiles.  At
// most two k-steps are in flight, so a k-step's A registers are free
// again two steps on.
template <int N, int D>
__device__ __forceinline__ void mma_nt(float (&d)[N / 2],
                                       const uint8_t* a_raw, uint32_t b_hi,
                                       uint32_t b_lo, int r0, int t) {
  fence_regs(d);
#pragma unroll
  for (int kk = 0; kk < D / 8; ++kk) {
    const int c = 8 * kk + t;
    const float x[4] = {
        *reinterpret_cast<const float*>(a_raw + raw_at<D>(r0, c)),
        *reinterpret_cast<const float*>(a_raw + raw_at<D>(r0 + 8, c)),
        *reinterpret_cast<const float*>(a_raw + raw_at<D>(r0, c + 4)),
        *reinterpret_cast<const float*>(a_raw + raw_at<D>(r0 + 8, c + 4))};
    uint32_t hi[4], lo[4];
    split4(x, hi, lo);
    wgmma_fence();
    wgmma<N>(d, lo, kstep<N>(b_hi, kk), kk > 0);
    wgmma<N>(d, hi, kstep<N>(b_lo, kk), 1);
    wgmma<N>(d, hi, kstep<N>(b_hi, kk), 1);
    wgmma_commit();
    wgmma_wait_1();
  }
  wgmma_wait_all();
  fence_regs(d);
}

// d[64 x N] += P B over K: P a [64 x K] accumulator fragment of this
// warpgroup (p[4j + 2i + c]: row r0 + 8i, column 8j + 2t + c), which is
// the A fragment of columns in the order 0 2 4 6 1 3 5 7 a group; B_hi /
// B_lo tf32 [N][K] tiles in that order (`split_cols`).
template <int N, int K>
__device__ __forceinline__ void mma_frag(float (&d)[N / 2],
                                         const float (&p)[K / 2],
                                         uint32_t b_hi, uint32_t b_lo) {
  fence_regs(d);
#pragma unroll
  for (int kk = 0; kk < K / 8; ++kk) {
    const float x[4] = {p[4 * kk], p[4 * kk + 2], p[4 * kk + 1],
                        p[4 * kk + 3]};
    uint32_t hi[4], lo[4];
    split4(x, hi, lo);
    wgmma_fence();
    wgmma<N>(d, lo, kstep<N>(b_hi, kk), 1);
    wgmma<N>(d, hi, kstep<N>(b_lo, kk), 1);
    wgmma<N>(d, hi, kstep<N>(b_hi, kk), 1);
    wgmma_commit();
    wgmma_wait_1();
  }
  wgmma_wait_all();
  fence_regs(d);
}

// Whether every row of these f32 tensors starts 16-byte aligned: each
// base, and every stride (in elements, or-ed into `strides`), a multiple
// of 4 floats.
template <typename... Ptr>
__device__ __forceinline__ bool aligned16(long long strides,
                                          const Ptr*... ptrs) {
  return (strides & 3) == 0 &&
         ((reinterpret_cast<uintptr_t>(ptrs) | ...) & 15) == 0;
}

// -- K1: the f32 tile loop ----------------------------------------------------

template <int D>
struct FwdSmem {
  static constexpr int kN = tc::kTileN;          // keys a tile
  static constexpr int kRaw = kN * D * 4;        // one raw [64][D] tile
  static constexpr int kQ = 0;                   // raw Q
  static constexpr int kStageK = kRaw;           // raw K and V of a tile
  static constexpr int kStageV = 2 * kRaw;
  static constexpr int kKHi = 3 * kRaw;          // K hi/lo [kN][D]
  static constexpr int kKLo = 4 * kRaw;
  static constexpr int kVHi = 5 * kRaw;          // V^T hi/lo [D][kN]
  static constexpr int kVLo = 6 * kRaw;
  static constexpr int kBytes = 7 * kRaw;
  static constexpr int kAlloc = kBytes + 1024;   // room to align to 1024
};

// One 64-query tile against keys 0..horizon, every product 3xTF32 on
// `wgmma`.  Arguments as tc::attend_tile (attention_wgmma.cuh), f32
// throughout, plus `rows16` (q, k and v rows 16-byte aligned); `smem`:
// FwdSmem<D>::kAlloc bytes.  The softmax and dropout are tc::attend_tile's
// on the same fragment; p is not rounded (the f32 plain version does not
// round it) and P V's A operand is its split.
template <int D, typename KeyAt, typename Drop>
__device__ __forceinline__ void attend_tile(
    uint8_t* smem, const float* __restrict__ q_rows, long long q_stride,
    int n_rows, int qpos0, int horizon, bool causal,
    const float* __restrict__ k_base, const float* __restrict__ v_base,
    KeyAt key_at, float scale, float* __restrict__ o_rows,
    long long o_stride, float* __restrict__ lse_rows, bool rows16,
    const Drop& drop) {
  using L = FwdSmem<D>;
  constexpr int kN = L::kN;
  const int tid = threadIdx.x;
  const uint32_t raw_base = smem_u32(smem);
  const uint32_t base = (raw_base + 1023) & ~1023u;
  uint8_t* sm = smem + (base - raw_base);
  const int n_keys = min(horizon + 1, key_at.limit());
  const int n_tiles = (n_keys + kN - 1) / kN;

  auto load_kv = [&](int t) {
    const int c0 = t * kN;
    auto offsets = [&](int r, long long& ko, long long& vo) {
      ko = vo = 0;
      key_at(c0 + r, ko, vo);
    };
    load_raw<kN, D>(base + L::kStageK, [&](int r) {
      long long ko, vo;
      offsets(r, ko, vo);
      return k_base + ko;
    }, n_keys - c0, rows16);
    load_raw<kN, D>(base + L::kStageV, [&](int r) {
      long long ko, vo;
      offsets(r, ko, vo);
      return v_base + vo;
    }, n_keys - c0, rows16);
    cp_async_commit();
  };

  load_raw<kRows, D>(base + L::kQ, [&](int r) {
    return q_rows + r * q_stride;
  }, n_rows, rows16);
  load_kv(0);  // one group with Q

  const int warp = tid / 32, lane = tid % 32;
  const int r0 = warp * 16 + lane / 4;
  const int t4 = lane % 4, cq = 2 * t4;
  const float scale_log2 = scale * kLog2e;
  float m[2] = {kNegInf, kNegInf};  // running max, log2 units
  float l[2] = {0.f, 0.f};          // this thread's share of the running sum
  float o[D / 2];
  float s[kN / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
#pragma unroll
  for (int i = 0; i < kN / 2; ++i) s[i] = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait_all();  // tile t (and, first, Q) has landed
    __syncthreads();      // ... for every thread; tile t-1's products are done
    split_rows<kN, D>(sm + L::kStageK, sm + L::kKHi, sm + L::kKLo);
    split_cols<kN, D>(sm + L::kStageV, sm + L::kVHi, sm + L::kVLo);
    fence_proxy_async();  // the split tiles are visible to wgmma ...
    __syncthreads();      // ... from every thread; the stage is free
    if (t + 1 < n_tiles) load_kv(t + 1);

    // S = Q K^T
    mma_nt<kN, D>(s, sm + L::kQ, base + L::kKHi, base + L::kKLo, r0, t4);

    // online softmax on the fragment
    const int c0 = t * kN;
    const bool masked = c0 + kN > n_keys || (causal && c0 + kN - 1 > qpos0);
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int e = 0; e < kN / 2; ++e) {
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
      for (int j = 0; j < kN / 8; ++j)
        keep |= drop.keep4(drop.words(qpos0 + r0, c0 + 8 * j + cq)) << (4 * j);
    }
#pragma unroll
    for (int e = 0; e < kN / 2; ++e) {
      const float p = exp2f(s[e] - m[(e / 2) % 2]);
      l[(e / 2) % 2] += p;
      if constexpr (Drop::kOn)
        s[e] = p * drop.factor((keep >> e) & 1u);
      else
        s[e] = p;
    }
#pragma unroll
    for (int e = 0; e < D / 2; ++e) o[e] *= corr[(e / 2) % 2];

    // O += P V
    mma_frag<D, kN>(o, s, base + L::kVHi, base + L::kVLo);
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    const int r = r0 + 8 * i;
    const float li = l[i] == 0.f ? 1.f : l[i];
    if (r < n_rows) {
      const float inv = 1.f / li;
      float* out = o_rows + r * o_stride + cq;
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<float2*>(out + 8 * j) = make_float2(
            o[4 * j + 2 * i] * inv, o[4 * j + 2 * i + 1] * inv);
      if (lse_rows != nullptr && cq == 0)
        lse_rows[r] = (m[i] + log2f(fmaxf(li, 1e-30f))) * kLn2;
    }
  }
}

}  // namespace tf32
}  // namespace pt
