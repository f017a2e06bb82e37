// Flash attention backward for Hopper (sm_90a): kernels K2 (dK, dV) and K3
// (dQ).
//
// Replaces the backward half of paddle_tpu/ops/pallas/flash_attention_kernel.py:
// `_bwd` (:242) with its kernels `_bwd_dkv_kernel` (:170) and
// `_bwd_dq_kernel` (:210) and their shared recompute `_p_ds` (:67).  From
// q/k/v/dO [B, S, H, D] (read through their strides, head dim contiguous),
// K1's compact lse [B*H, S] (row b*H + h) and delta = rowsum(dO * O) in the
// same layout, both kernels recompute
//
//   s  = (q k^T) * scale, masked kpos > qpos (absolute positions) if causal
//   p  = exp(s - lse)                      (0 where masked)
//   ds = p * (dO v^T - delta) * scale
//
// in f32.  K2 accumulates dV += p^T dO and dK += ds^T q; K3 accumulates
// dQ += ds k.  As in the Pallas kernels, p is rounded to dO's dtype before
// the dV product and ds to q's (k's) dtype before the dK (dQ) product; the
// sums stay f32 and the results are rounded once to the input dtype.  In
// f16 a ds (or a result) past 65504 rounds to inf, as a Pallas astype
// does, and is never clamped: under a large loss scale the overflow must
// reach the gradients, where the scaler finds it and skips the step.
//
// Bound by operations: K2 does 8D flops per live (q, k) pair (four
// products), K3 6D (three).  At the GPT-2 345M shape (B 8, S 1024, H 16,
// D 64, causal) that is 34.4 and 25.8 GFLOP against ~50 MB each reads
// once, so the tensor cores are the only way near the bound.  The bf16 and
// f16 instances run every product on `wgmma` (the PTX pieces of
// attention_wgmma.cuh, as K1 does), with the element type T a template
// parameter of one tile loop:
//
//   * One warpgroup (128 threads) owns 64 output rows.  K2: one block per
//     (64-key tile, head, batch) walks the query tiles from its diagonal to
//     S (all of them when full); K3: one block per (64-query tile, head,
//     batch) walks the key tiles up to its causal horizon.  Each block owns
//     its rows, so there are no atomics and no second pass, and the result
//     is deterministic.  The grid is ordered heaviest causal tile first.
//   * K2: S^T = K Q^T and dP^T = V dO^T are m64n64k16 with both tiles
//     K-major; dV += P^T dO and dK += dS^T Q are m64nDk16 with P^T and dS^T
//     from registers (the accumulator fragment of S^T is already the A
//     fragment) and dO, Q read MN-major with the transpose flag.  K3:
//     S = Q K^T and dP = dO V^T as m64n64k16, dQ += dS K with K MN-major.
//     No score tile goes to shared memory.
//   * p and ds are formed on the accumulator fragment; lse is known, so
//     there is no online softmax.  K3's lse and delta belong to the
//     fragment's two rows and sit in registers; K2's belong to its 16 query
//     columns and are staged per query tile in shared memory, in the same
//     cp.async group as the tile's Q and dO.  Only the diagonal and ragged
//     tiles are masked, explicitly: a zero-filled row past S would give
//     p = exp(0 - lse), which is not 0.
//   * The walked pair (Q, dO for K2; K, V for K3) comes through a two-stage
//     ring of cp.async.cg copies zero-filled past S; the block's own pair
//     is loaded once.  Shared memory: 50 KB at D 64, 98 KB at D 128.
//   * K2 holds two D-wide f32 accumulators.  At D 128 it waits for dV's
//     product before it forms dP^T, so the packed P^T is dead by then.
//
// Attention dropout (the `*_dropout_kernel` instances, FlashAttention-2's):
// with Z = M / (1 - p), M the forward's Philox keep bits (`Dropout`,
// attention_common.cuh, at the same global coordinates), K2 forms
// dV += (P o Z)^T dO and dP = (dO V^T) o Z, and both form
// dS = P o (dP - delta) * scale; delta = rowsum(dO o O) still equals
// sum_j P_ij dP_ij.  Each thread forms its fragment's 32 keep bits once a
// tile (K3: one Philox call per 8-key group; K2, whose fragment is the
// transpose, one per key row and query pair) and keeps them in one
// register.  The p == 0 kernels are unchanged.
//
// What this leaves: the products of a warpgroup run one after another (no
// overlap of the exponentials with the next wgmma), K3 recomputes the S and
// dP that K2 formed, and the loads are cp.async rather than TMA.
//
// The f32 instances keep the CUDA-core loop (operands in padded shared
// memory as f32, 256 threads with 4 x 4 register tiles of FMA), which the
// f32 parity checks use.
#include "attention_wgmma.cuh"

namespace pt {

constexpr int kBwdTile = 64;       // query rows / key rows per tile
constexpr int kBwdThreads = 256;   // f32 instances
constexpr int kSide = 16;          // threads per tile edge: tm, tn in 0..15
constexpr int kPer = kBwdTile / kSide;  // rows (and columns) per thread

template <typename T>
constexpr int kBwdBlock = tc::kOnTensorCores<T> ? kThreads : kBwdThreads;

// -- f32: CUDA-core FMA -----------------------------------------------------

template <int D>
struct BwdLayout {
  static constexpr int kLd = D + 1;            // a [tile, D] operand row
  static constexpr int kLdP = kBwdTile + 1;    // a [tile, tile] product row
  static constexpr int kOperand = kBwdTile * kLd;
  static constexpr int kProduct = kBwdTile * kLdP;
  // four operands, `products` [tile, tile] buffers, lse and delta rows
  static constexpr size_t bytes(int products) {
    return (4 * kOperand + products * kProduct + 2 * kBwdTile) *
           sizeof(float);
  }
};

template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_f32(from_f32<T>(x));
}

// Rows 0..n_rows-1 of a strided [rows, D] slice into a padded f32 tile;
// the rows past n_rows are zero.
template <typename T, int D>
__device__ __forceinline__ void load_rows(float* __restrict__ dst,
                                          const T* __restrict__ src,
                                          long long row_stride, int n_rows) {
  for (int e = threadIdx.x; e < kBwdTile * D; e += kBwdThreads) {
    const int r = e / D, d = e % D;
    dst[r * (D + 1) + d] = r < n_rows ? to_f32(src[r * row_stride + d]) : 0.f;
  }
}

// acc[i][j] = sum_{d < K} A[row_i][d] * B[row_j][d], row_i = tm + 16 i,
// row_j = tn + 16 j: a [tile, tile] block of A B^T.
template <int K>
__device__ __forceinline__ void tile_nt(const float* __restrict__ A, int lda,
                                        const float* __restrict__ B, int ldb,
                                        int tm, int tn,
                                        float (&acc)[kPer][kPer]) {
#pragma unroll
  for (int i = 0; i < kPer; ++i)
#pragma unroll
    for (int j = 0; j < kPer; ++j) acc[i][j] = 0.f;
#pragma unroll 8
  for (int d = 0; d < K; ++d) {
    float a[kPer], b[kPer];
#pragma unroll
    for (int i = 0; i < kPer; ++i) a[i] = A[(tm + kSide * i) * lda + d];
#pragma unroll
    for (int j = 0; j < kPer; ++j) b[j] = B[(tn + kSide * j) * ldb + d];
#pragma unroll
    for (int i = 0; i < kPer; ++i)
#pragma unroll
      for (int j = 0; j < kPer; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

// acc[i][j] += sum_{k < tile} A[row_i][k] * B[k][col_j], row_i = tm + 16 i,
// col_j = tn + 16 j: a [tile, N] block of A B.
template <int N>
__device__ __forceinline__ void tile_nn(const float* __restrict__ A, int lda,
                                        const float* __restrict__ B, int ldb,
                                        int tm, int tn,
                                        float (&acc)[kPer][N / kSide]) {
  constexpr int kCols = N / kSide;
#pragma unroll 4
  for (int k = 0; k < kBwdTile; ++k) {
    float a[kPer], b[kCols];
#pragma unroll
    for (int i = 0; i < kPer; ++i) a[i] = A[(tm + kSide * i) * lda + k];
#pragma unroll
    for (int j = 0; j < kCols; ++j) b[j] = B[k * ldb + tn + kSide * j];
#pragma unroll
    for (int i = 0; i < kPer; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

// Rows 0..n_rows-1 of a [tile, D] register accumulator to a strided output.
template <typename T, int D>
__device__ __forceinline__ void store_rows(T* __restrict__ dst,
                                           long long row_stride, int n_rows,
                                           int tm, int tn,
                                           const float (&acc)[kPer][D / kSide]) {
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int r = tm + kSide * i;
    if (r >= n_rows) continue;
#pragma unroll
    for (int j = 0; j < D / kSide; ++j)
      dst[r * row_stride + tn + kSide * j] = from_f32<T>(acc[i][j]);
  }
}

// -- bf16 and f16: tensor cores ----------------------------------------------

namespace tc {

// Shared memory of a 16-bit K2/K3 block: its own pair of [64][D] tiles, a
// two-stage ring of the walked pair, and (K2) each stage's 64 lse and 64
// delta floats.  Every tile starts on a 1024-byte swizzle period.
template <int D>
struct BwdSmem {
  static constexpr int kTile = kTileM * D * 2;
  static constexpr int kOwn0 = 0;                          // K2: K   K3: Q
  static constexpr int kOwn1 = kTile;                      // K2: V   K3: dO
  static constexpr int kRing0 = 2 * kTile;                 // K2: Q   K3: K
  static constexpr int kRing1 = kRing0 + kStages * kTile;  // K2: dO  K3: V
  static constexpr int kRows = kRing1 + kStages * kTile;   // K2: lse, delta
  static constexpr int kRowFloats = 2 * kTileM;            // per stage
  static constexpr int kBytes = kRows + kStages * kRowFloats * 4;
  static constexpr int kAlloc = kBytes + 1024;             // room to align
};

// This block's tile rank, head and batch in a (tiles, H, B) grid, ranked
// so that the blocks launch rank 0 of every (head, batch) first, then
// rank 1, and so on: the caller maps rank 0 to its heaviest causal tile.
__device__ __forceinline__ int tile_rank(int& h, int& b) {
  const int heads = gridDim.y * gridDim.z;
  const int linear =
      blockIdx.x + gridDim.x * (blockIdx.y + gridDim.y * blockIdx.z);
  h = linear % heads % gridDim.y;
  b = linear % heads / gridDim.y;
  return linear / heads;
}

// Rows 0..63 of a strided [rows, D] slice into a swizzled tile; rows from
// n_rows on are zero-filled.
template <typename T, int D>
__device__ __forceinline__ void load_tile(uint32_t tile,
                                          const TileCopy<D>& cp,
                                          const T* __restrict__ rows,
                                          long long stride, int n_rows) {
#pragma unroll
  for (int i = 0; i < TileCopy<D>::kIters; ++i) {
    const int r = cp.first_row + i * TileCopy<D>::kRowStep;
    const bool live = r < n_rows;
    cp_async16(cp.dst(tile, i), rows + (live ? r * stride : 0) + cp.chunk * 8,
               live ? 16 : 0);
  }
}

// d[64 x 64] = A B^T over D: A and B [64][D] tiles, both K-major.
template <typename T, int D>
__device__ __forceinline__ void mma_nt(float (&d)[32], uint32_t a,
                                       uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t off = (kk / 4) * kBlockBytes + (kk % 4) * 32;
    wgmma_ss_n64<T>(d, desc_sw128(a + off, 16, 1024),
                 desc_sw128(b + off, 16, 1024), kk > 0);
  }
}

// d[64 x D] += A B over 64: A as four register fragments of 16 columns,
// B a [64][D] tile read MN-major.
template <typename T, int D>
__device__ __forceinline__ void mma_rs(float (&d)[D / 2],
                                       const uint32_t (&a)[4][4],
                                       uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < kTileN / 16; ++kk)
    wgmma_rs<T, D>(d, a[kk], desc_sw128(b + kk * 16 * kRowBytes,
                                        kBlockBytes, 1024));
}

// Rows 0..n_rows-1 of a [64 x D] accumulator to a strided T output.
template <typename T, int D>
__device__ __forceinline__ void store_acc(const float (&d)[D / 2],
                                          T* __restrict__ rows,
                                          long long stride, int n_rows,
                                          int r0, int cq) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = r0 + 8 * i;
    if (r >= n_rows) continue;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<uint32_t*>(rows + r * stride + 8 * j + cq) =
          pack2<T>(d[4 * j + 2 * i], d[4 * j + 2 * i + 1]);
  }
}

// K2 for one 64-key tile at k0 of one (batch, head): q_bh, do_bh, lse_bh
// and delta_bh start at that head's position 0; k_rows, v_rows, dk_rows and
// dv_rows at key k0.  `smem`: BwdSmem<D>::kAlloc bytes.
//
// Fragment coordinates (a thread's s[4j + 2i + c]): key row r0 + 8i of the
// tile, query column 8j + cq + c.
template <typename T, int D, typename Drop>
__device__ __forceinline__ void dkv_tile(
    uint8_t* smem, const T* __restrict__ q_bh, long long q_ss,
    const T* __restrict__ do_bh, long long do_ss,
    const float* __restrict__ lse_bh, const float* __restrict__ delta_bh,
    const T* __restrict__ k_rows, long long k_ss,
    const T* __restrict__ v_rows, long long v_ss, int S, int k0,
    bool causal, float scale, T* __restrict__ dk_rows, long long dk_ss,
    T* __restrict__ dv_rows, long long dv_ss, const Drop& drop) {
  using L = BwdSmem<D>;
  const int tid = threadIdx.x;
  const uint32_t raw = smem_u32(smem);
  const uint32_t base = (raw + 1023) & ~1023u;
  const float* rows_sm =
      reinterpret_cast<const float*>(smem + (base - raw) + L::kRows);
  const uint32_t k_sm = base + L::kOwn0, v_sm = base + L::kOwn1;
  const TileCopy<D> cp(tid);
  const int n_keys = min(kTileM, S - k0);
  const int first = causal ? k0 : 0;  // query tiles are aligned with keys'
  const int n_tiles = (S - first + kTileM - 1) / kTileM;

  // query tile t: Q, dO, and lse (threads 0..63) / delta (64..127)
  auto load_q = [&](int t) {
    const int c0 = first + t * kTileM;
    const int st = t % kStages;
    load_tile<T, D>(base + L::kRing0 + st * L::kTile, cp, q_bh + c0 * q_ss,
                    q_ss, S - c0);
    load_tile<T, D>(base + L::kRing1 + st * L::kTile, cp, do_bh + c0 * do_ss,
                    do_ss, S - c0);
    const int pos = c0 + tid % kTileM;
    const bool live = pos < S;
    cp_async4(base + L::kRows + (st * L::kRowFloats + tid) * 4,
              (tid < kTileM ? lse_bh : delta_bh) + (live ? pos : 0),
              live ? 4 : 0);
    cp_async_commit();
  };

  load_tile<T, D>(k_sm, cp, k_rows, k_ss, n_keys);
  load_tile<T, D>(v_sm, cp, v_rows, v_ss, n_keys);
  load_q(0);  // one group with K and V

  const int warp = tid / 32, lane = tid % 32;
  const int r0 = warp * 16 + lane / 4;
  const int cq = (lane % 4) * 2;
  const float scale_log2 = scale * kLog2e;
  float dk[D / 2], dv[D / 2], s[32], dp[32];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait_all();  // tile t (and, first, K and V) has landed
    fence_proxy_async();
    __syncthreads();      // ... for every thread; tile t-1's stage is free
    if (t + 1 < n_tiles) load_q(t + 1);
    const int st = t % kStages;
    const uint32_t q_sm = base + L::kRing0 + st * L::kTile;
    const uint32_t do_sm = base + L::kRing1 + st * L::kTile;
    const float* lse_t = rows_sm + st * L::kRowFloats;
    const float* delta_t = lse_t + kTileM;
    const int c0 = first + t * kTileM;

    // S^T = K Q^T
    fence_regs(s);
    wgmma_fence();
    mma_nt<T, D>(s, k_sm, q_sm);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);

    // dropout's keep bits: bit 4j + 2i + c for (key r0 + 8i, query
    // 8j + cq + c); queries q and q + 8 (groups 2jj, 2jj + 1) share a counter
    uint32_t keep = 0;
    if constexpr (Drop::kOn) {
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int key = k0 + r0 + 8 * i;
            const uint4 w = drop.words(c0 + 16 * jj + cq + c, key);
            const int bit = 8 * jj + 2 * i + c;
            keep |= static_cast<uint32_t>(drop.keep(key & 1 ? w.y : w.x))
                    << bit;
            keep |= static_cast<uint32_t>(drop.keep(key & 1 ? w.w : w.z))
                    << (bit + 4);
          }
    }

    // p on the fragment (kept f32 in s for ds) and P^T as T A fragments
    // (times the keep factor under dropout)
    const bool masked = c0 + kTileM > S || (causal && c0 == k0);
    uint32_t pt[4][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 lse2 = *reinterpret_cast<const float2*>(lse_t + 8 * j + cq);
      const float lse_log2[2] = {lse2.x * kLog2e, lse2.y * kLog2e};
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int e = 4 * j + 2 * i;
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          float p = exp2f(s[e + c] * scale_log2 - lse_log2[c]);
          if (masked) {
            const int qpos = c0 + 8 * j + cq + c;
            const bool ok = qpos < S && (!causal || k0 + r0 + 8 * i <= qpos);
            p = ok ? p : 0.f;
          }
          s[e + c] = p;
        }
        if constexpr (Drop::kOn)
          pt[j / 2][(j % 2) * 2 + i] =
              pack2<T>(s[e] * drop.factor((keep >> e) & 1u),
                       s[e + 1] * drop.factor((keep >> (e + 1)) & 1u));
        else
          pt[j / 2][(j % 2) * 2 + i] = pack2<T>(s[e], s[e + 1]);
      }
    }

    // dV += P^T dO, then dP^T = V dO^T
    fence_regs(dv);
    fence_regs(dp);
    wgmma_fence();
    mma_rs<T, D>(dv, pt, do_sm);
    if constexpr (D > 64) {  // P^T's registers are free before dP^T's
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(dv);
      wgmma_fence();
    }
    mma_nt<T, D>(dp, v_sm, do_sm);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(dv);
    fence_regs(dp);

    // dS^T on the fragment (dP^T times the keep factor under dropout),
    // then dK += dS^T Q
    uint32_t dst[4][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 d2 = *reinterpret_cast<const float2*>(delta_t + 8 * j + cq);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int e = 4 * j + 2 * i;
        float dp0 = dp[e], dp1 = dp[e + 1];
        if constexpr (Drop::kOn) {
          dp0 *= drop.factor((keep >> e) & 1u);
          dp1 *= drop.factor((keep >> (e + 1)) & 1u);
        }
        dst[j / 2][(j % 2) * 2 + i] = pack2<T>(s[e] * (dp0 - d2.x) * scale,
                                               s[e + 1] * (dp1 - d2.y) * scale);
      }
    }
    fence_regs(dk);
    wgmma_fence();
    mma_rs<T, D>(dk, dst, q_sm);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(dk);
  }
  store_acc<T, D>(dk, dk_rows, dk_ss, n_keys, r0, cq);
  store_acc<T, D>(dv, dv_rows, dv_ss, n_keys, r0, cq);
}

// K3 for one 64-query tile at q0 (n_rows of it live) of one (batch, head):
// q_rows, do_rows, lse_rows, delta_rows and dq_rows start at query q0;
// k_bh and v_bh at that head's key 0.
//
// Fragment coordinates (a thread's s[4j + 2i + c]): query row r0 + 8i of
// the tile, key column 8j + cq + c.
template <typename T, int D, typename Drop>
__device__ __forceinline__ void dq_tile(
    uint8_t* smem, const T* __restrict__ q_rows, long long q_ss,
    const T* __restrict__ do_rows, long long do_ss,
    const float* __restrict__ lse_rows, const float* __restrict__ delta_rows,
    int n_rows, int q0, const T* __restrict__ k_bh, long long k_ss,
    const T* __restrict__ v_bh, long long v_ss, int S, bool causal,
    float scale, T* __restrict__ dq_rows, long long dq_ss,
    const Drop& drop) {
  using L = BwdSmem<D>;
  const int tid = threadIdx.x;
  const uint32_t base = (smem_u32(smem) + 1023) & ~1023u;
  const uint32_t q_sm = base + L::kOwn0, do_sm = base + L::kOwn1;
  const TileCopy<D> cp(tid);
  const int n_keys = causal ? q0 + n_rows : S;
  const int n_tiles = (n_keys + kTileN - 1) / kTileN;

  auto load_kv = [&](int t) {
    const int c0 = t * kTileN;
    const int st = t % kStages;
    load_tile<T, D>(base + L::kRing0 + st * L::kTile, cp, k_bh + c0 * k_ss,
                    k_ss, n_keys - c0);
    load_tile<T, D>(base + L::kRing1 + st * L::kTile, cp, v_bh + c0 * v_ss,
                    v_ss, n_keys - c0);
    cp_async_commit();
  };

  load_tile<T, D>(q_sm, cp, q_rows, q_ss, n_rows);
  load_tile<T, D>(do_sm, cp, do_rows, do_ss, n_rows);
  load_kv(0);  // one group with Q and dO

  const int warp = tid / 32, lane = tid % 32;
  const int r0 = warp * 16 + lane / 4;
  const int cq = (lane % 4) * 2;
  const float scale_log2 = scale * kLog2e;
  float lse_log2[2], delta[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = r0 + 8 * i;
    lse_log2[i] = r < n_rows ? lse_rows[r] * kLog2e : 0.f;
    delta[i] = r < n_rows ? delta_rows[r] : 0.f;
  }
  float dq[D / 2], s[32], dp[32];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dq[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait_all();  // tile t (and, first, Q and dO) has landed
    fence_proxy_async();
    __syncthreads();      // ... for every thread; tile t-1's stage is free
    if (t + 1 < n_tiles) load_kv(t + 1);
    const int st = t % kStages;
    const uint32_t k_sm = base + L::kRing0 + st * L::kTile;
    const uint32_t v_sm = base + L::kRing1 + st * L::kTile;
    const int c0 = t * kTileN;

    // S = Q K^T and dP = dO V^T
    fence_regs(s);
    fence_regs(dp);
    wgmma_fence();
    mma_nt<T, D>(s, q_sm, k_sm);
    mma_nt<T, D>(dp, do_sm, v_sm);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);
    fence_regs(dp);

    // dropout's keep bits: bit 4j + 2i + c for (query r0 + 8i, key
    // 8j + cq + c), one counter per 8-key group
    uint32_t keep = 0;
    if constexpr (Drop::kOn) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
        keep |= drop.keep4(drop.words(q0 + r0, c0 + 8 * j + cq)) << (4 * j);
    }

    // dS on the fragment as T A fragments (dP times the keep factor
    // under dropout)
    const bool masked = c0 + kTileN > n_keys ||
                        (causal && c0 + kTileN - 1 > q0);
    uint32_t ds[4][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int e = 4 * j + 2 * i;
        float v[2];
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          float p = exp2f(s[e + c] * scale_log2 - lse_log2[i]);
          if (masked) {
            const int kpos = c0 + 8 * j + cq + c;
            const bool ok = kpos < n_keys &&
                            (!causal || kpos <= q0 + r0 + 8 * i);
            p = ok ? p : 0.f;
          }
          float dpc = dp[e + c];
          if constexpr (Drop::kOn) dpc *= drop.factor((keep >> (e + c)) & 1u);
          v[c] = p * (dpc - delta[i]) * scale;
        }
        ds[j / 2][(j % 2) * 2 + i] = pack2<T>(v[0], v[1]);
      }
    }

    // dQ += dS K
    fence_regs(dq);
    wgmma_fence();
    mma_rs<T, D>(dq, ds, k_sm);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(dq);
  }
  store_acc<T, D>(dq, dq_rows, dq_ss, n_rows, r0, cq);
}

}  // namespace tc

// -- kernels ------------------------------------------------------------------

#define PT_DKV_PARAMS                                                       \
  const T *__restrict__ q, const T *__restrict__ k,                         \
      const T *__restrict__ v, const T *__restrict__ dout,                  \
      const float *__restrict__ lse, const float *__restrict__ delta,       \
      T *__restrict__ dk, T *__restrict__ dv, int S, int H, int causal,     \
      long long q_sb, long long q_ss, long long q_sh, long long k_sb,       \
      long long k_ss, long long k_sh, long long v_sb, long long v_ss,       \
      long long v_sh, long long do_sb, long long do_ss, long long do_sh,    \
      long long dk_sb, long long dk_ss, long long dk_sh, long long dv_sb,   \
      long long dv_ss, long long dv_sh, float scale
#define PT_DKV_FORWARD                                                      \
  q, k, v, dout, lse, delta, dk, dv, S, H, causal, q_sb, q_ss, q_sh, k_sb,  \
      k_ss, k_sh, v_sb, v_ss, v_sh, do_sb, do_ss, do_sh, dk_sb, dk_ss,      \
      dk_sh, dv_sb, dv_ss, dv_sh, scale

// K2: one block per (key tile, head, batch) accumulates its dK and dV rows
// over the query tiles that can see them.  `drop`: NoDropout, or Dropout
// (its head row set here): dV takes P times the keep factor, dP^T is
// multiplied by it before dS^T.
template <typename T, int D, typename Drop>
__device__ __forceinline__ void flash_bwd_dkv_block(PT_DKV_PARAMS,
                                                    Drop drop) {
  extern __shared__ float smem[];
  if constexpr (tc::kOnTensorCores<T>) {
    int h, b;
    // rank 0 is key tile 0, which sees every query tile under a causal mask
    const int k0 = tc::tile_rank(h, b) * kBwdTile;
    const long long row0 = ((long long)b * H + h) * S;
    drop.set_head(b, h, H);
    tc::dkv_tile<T, D>(
        reinterpret_cast<uint8_t*>(smem), q + b * q_sb + h * q_sh, q_ss,
        dout + b * do_sb + h * do_sh, do_ss, lse + row0, delta + row0,
        k + b * k_sb + k0 * k_ss + h * k_sh, k_ss,
        v + b * v_sb + k0 * v_ss + h * v_sh, v_ss, S, k0, causal != 0, scale,
        dk + b * dk_sb + k0 * dk_ss + h * dk_sh, dk_ss,
        dv + b * dv_sb + k0 * dv_ss + h * dv_sh, dv_ss, drop);
  } else {
    using L = BwdLayout<D>;
    float* sk = smem;
    float* sv = sk + L::kOperand;
    float* sq = sv + L::kOperand;
    float* sdo = sq + L::kOperand;
    float* sp = sdo + L::kOperand;    // p^T  [key][query]
    float* sds = sp + L::kProduct;    // ds^T [key][query]
    float* slse = sds + L::kProduct;
    float* sdelta = slse + kBwdTile;

    const int k0 = blockIdx.x * kBwdTile, h = blockIdx.y, b = blockIdx.z;
    const int n_keys = min(kBwdTile, S - k0);
    drop.set_head(b, h, H);
    const int tid = threadIdx.x, tm = tid / kSide, tn = tid % kSide;
    const long long row0 = ((long long)b * H + h) * S;  // lse / delta row
    const T* q_bh = q + b * q_sb + h * q_sh;
    const T* do_bh = dout + b * do_sb + h * do_sh;
    load_rows<T, D>(sk, k + b * k_sb + k0 * k_ss + h * k_sh, k_ss, n_keys);
    load_rows<T, D>(sv, v + b * v_sb + k0 * v_ss + h * v_sh, v_ss, n_keys);

    float dk_acc[kPer][D / kSide], dv_acc[kPer][D / kSide];
#pragma unroll
    for (int i = 0; i < kPer; ++i)
#pragma unroll
      for (int j = 0; j < D / kSide; ++j) dk_acc[i][j] = dv_acc[i][j] = 0.f;

    // query tiles are aligned with key tiles: the first that sees key k0 is
    // the one that starts at k0
    for (int c0 = causal ? k0 : 0; c0 < S; c0 += kBwdTile) {
      const int n_q = min(kBwdTile, S - c0);
      __syncthreads();  // the previous tile's products are done with sq/sdo
      load_rows<T, D>(sq, q_bh + c0 * q_ss, q_ss, n_q);
      load_rows<T, D>(sdo, do_bh + c0 * do_ss, do_ss, n_q);
      if (tid < kBwdTile) {
        slse[tid] = tid < n_q ? lse[row0 + c0 + tid] : 0.f;
        sdelta[tid] = tid < n_q ? delta[row0 + c0 + tid] : 0.f;
      }
      __syncthreads();
      float st[kPer][kPer], dpt[kPer][kPer];
      tile_nt<D>(sk, L::kLd, sq, L::kLd, tm, tn, st);    // (q k^T)^T
      tile_nt<D>(sv, L::kLd, sdo, L::kLd, tm, tn, dpt);  // (dO v^T)^T
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        const int kj = tm + kSide * i;
#pragma unroll
        for (int j = 0; j < kPer; ++j) {
          const int qr = tn + kSide * j;
          const bool valid = kj < n_keys && qr < n_q &&
                             (!causal || k0 + kj <= c0 + qr);
          const float p = valid ? expf(st[i][j] * scale - slse[qr]) : 0.f;
          float z = 1.f;
          if constexpr (Drop::kOn) z = drop.at(c0 + qr, k0 + kj);
          const float ds = p * (dpt[i][j] * z - sdelta[qr]) * scale;
          sp[kj * L::kLdP + qr] = round_to<T>(p * z);
          sds[kj * L::kLdP + qr] = round_to<T>(ds);
        }
      }
      __syncthreads();
      tile_nn<D>(sp, L::kLdP, sdo, L::kLd, tm, tn, dv_acc);
      tile_nn<D>(sds, L::kLdP, sq, L::kLd, tm, tn, dk_acc);
    }
    store_rows<T, D>(dk + b * dk_sb + k0 * dk_ss + h * dk_sh, dk_ss, n_keys,
                     tm, tn, dk_acc);
    store_rows<T, D>(dv + b * dv_sb + k0 * dv_ss + h * dv_sh, dv_ss, n_keys,
                     tm, tn, dv_acc);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kBwdBlock<T>) flash_bwd_dkv_kernel(
    PT_DKV_PARAMS) {
  flash_bwd_dkv_block<T, D>(PT_DKV_FORWARD, NoDropout{});
}

// K2 with attention dropout (rng: the draw's [seed, offset] on the device).
template <typename T, int D>
__global__ void __launch_bounds__(kBwdBlock<T>) flash_bwd_dkv_dropout_kernel(
    PT_DKV_PARAMS, const long long* __restrict__ rng, int rng_coords,
    long long threshold, float keep_scale) {
  flash_bwd_dkv_block<T, D>(PT_DKV_FORWARD,
                            Dropout(rng, rng_coords, threshold, keep_scale));
}

#define PT_DQ_PARAMS                                                        \
  const T *__restrict__ q, const T *__restrict__ k,                         \
      const T *__restrict__ v, const T *__restrict__ dout,                  \
      const float *__restrict__ lse, const float *__restrict__ delta,       \
      T *__restrict__ dq, int S, int H, int causal, long long q_sb,         \
      long long q_ss, long long q_sh, long long k_sb, long long k_ss,       \
      long long k_sh, long long v_sb, long long v_ss, long long v_sh,       \
      long long do_sb, long long do_ss, long long do_sh, long long dq_sb,   \
      long long dq_ss, long long dq_sh, float scale
#define PT_DQ_FORWARD                                                       \
  q, k, v, dout, lse, delta, dq, S, H, causal, q_sb, q_ss, q_sh, k_sb,      \
      k_ss, k_sh, v_sb, v_ss, v_sh, do_sb, do_ss, do_sh, dq_sb, dq_ss,      \
      dq_sh, scale

// K3: one block per (query tile, head, batch) accumulates its dQ rows over
// the key tiles up to its causal horizon.  `drop` as K2's: dP is multiplied
// by the keep factor before dS.
template <typename T, int D, typename Drop>
__device__ __forceinline__ void flash_bwd_dq_block(PT_DQ_PARAMS, Drop drop) {
  extern __shared__ float smem[];
  if constexpr (tc::kOnTensorCores<T>) {
    int h, b;
    // rank 0 is the last query tile, which sees every key tile
    const int q0 = (gridDim.x - 1 - tc::tile_rank(h, b)) * kBwdTile;
    const long long row0 = ((long long)b * H + h) * S + q0;
    drop.set_head(b, h, H);
    tc::dq_tile<T, D>(reinterpret_cast<uint8_t*>(smem),
                      q + b * q_sb + q0 * q_ss + h * q_sh, q_ss,
                      dout + b * do_sb + q0 * do_ss + h * do_sh, do_ss,
                      lse + row0, delta + row0, min(kBwdTile, S - q0), q0,
                      k + b * k_sb + h * k_sh, k_ss, v + b * v_sb + h * v_sh,
                      v_ss, S, causal != 0, scale,
                      dq + b * dq_sb + q0 * dq_ss + h * dq_sh, dq_ss, drop);
  } else {
    using L = BwdLayout<D>;
    float* sq = smem;
    float* sdo = sq + L::kOperand;
    float* sk = sdo + L::kOperand;
    float* sv = sk + L::kOperand;
    float* sds = sv + L::kOperand;    // ds [query][key]
    float* slse = sds + L::kProduct;
    float* sdelta = slse + kBwdTile;

    const int q0 = blockIdx.x * kBwdTile, h = blockIdx.y, b = blockIdx.z;
    const int n_rows = min(kBwdTile, S - q0);
    const int tid = threadIdx.x, tm = tid / kSide, tn = tid % kSide;
    const long long row0 = ((long long)b * H + h) * S + q0;
    drop.set_head(b, h, H);
    load_rows<T, D>(sq, q + b * q_sb + q0 * q_ss + h * q_sh, q_ss, n_rows);
    load_rows<T, D>(sdo, dout + b * do_sb + q0 * do_ss + h * do_sh, do_ss,
                    n_rows);
    if (tid < kBwdTile) {
      slse[tid] = tid < n_rows ? lse[row0 + tid] : 0.f;
      sdelta[tid] = tid < n_rows ? delta[row0 + tid] : 0.f;
    }
    const T* k_bh = k + b * k_sb + h * k_sh;
    const T* v_bh = v + b * v_sb + h * v_sh;

    float acc[kPer][D / kSide];
#pragma unroll
    for (int i = 0; i < kPer; ++i)
#pragma unroll
      for (int j = 0; j < D / kSide; ++j) acc[i][j] = 0.f;

    const int horizon = causal ? q0 + n_rows - 1 : S - 1;
    for (int c0 = 0; c0 <= horizon; c0 += kBwdTile) {
      const int n_keys = min(kBwdTile, S - c0);
      __syncthreads();  // the previous tile's dQ product is done with sk/sds
      load_rows<T, D>(sk, k_bh + c0 * k_ss, k_ss, n_keys);
      load_rows<T, D>(sv, v_bh + c0 * v_ss, v_ss, n_keys);
      __syncthreads();
      float s[kPer][kPer], dp[kPer][kPer];
      tile_nt<D>(sq, L::kLd, sk, L::kLd, tm, tn, s);
      tile_nt<D>(sdo, L::kLd, sv, L::kLd, tm, tn, dp);
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        const int r = tm + kSide * i;
#pragma unroll
        for (int j = 0; j < kPer; ++j) {
          const int c = tn + kSide * j;
          const bool valid = r < n_rows && c < n_keys &&
                             (!causal || c0 + c <= q0 + r);
          const float p = valid ? expf(s[i][j] * scale - slse[r]) : 0.f;
          float z = 1.f;
          if constexpr (Drop::kOn) z = drop.at(q0 + r, c0 + c);
          sds[r * L::kLdP + c] =
              round_to<T>(p * (dp[i][j] * z - sdelta[r]) * scale);
        }
      }
      __syncthreads();
      tile_nn<D>(sds, L::kLdP, sk, L::kLd, tm, tn, acc);
    }
    store_rows<T, D>(dq + b * dq_sb + q0 * dq_ss + h * dq_sh, dq_ss, n_rows,
                     tm, tn, acc);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kBwdBlock<T>) flash_bwd_dq_kernel(
    PT_DQ_PARAMS) {
  flash_bwd_dq_block<T, D>(PT_DQ_FORWARD, NoDropout{});
}

// K3 with attention dropout.
template <typename T, int D>
__global__ void __launch_bounds__(kBwdBlock<T>) flash_bwd_dq_dropout_kernel(
    PT_DQ_PARAMS, const long long* __restrict__ rng, int rng_coords,
    long long threshold, float keep_scale) {
  flash_bwd_dq_block<T, D>(PT_DQ_FORWARD,
                           Dropout(rng, rng_coords, threshold, keep_scale));
}

// Dynamic shared memory of a K2/K3 instance (`products` [tile, tile] f32
// buffers for the CUDA-core loop), opting the kernel in past 48 KB once
// per device through the launcher's `opt_in`; returns the bytes or a
// negative cudaError_t.
template <typename T, int D, typename Kernel>
int bwd_smem(Kernel kernel, int products, SmemOptIn& opt_in) {
  int bytes;
  if constexpr (tc::kOnTensorCores<T>)
    bytes = tc::BwdSmem<D>::kAlloc;
  else
    bytes = static_cast<int>(BwdLayout<D>::bytes(products));
  return opt_in(kernel, bytes);
}

template <typename T, int D>
int launch_flash_bwd_dkv(const void* q, const void* k, const void* v,
                         const void* dout, const void* lse, const void* delta,
                         void* dk, void* dv, int B, int S, int H, int causal,
                         long long q_sb, long long q_ss, long long q_sh,
                         long long k_sb, long long k_ss, long long k_sh,
                         long long v_sb, long long v_ss, long long v_sh,
                         long long do_sb, long long do_ss, long long do_sh,
                         long long dk_sb, long long dk_ss, long long dk_sh,
                         long long dv_sb, long long dv_ss, long long dv_sh,
                         float scale, const void* rng, int rng_coords,
                         long long threshold,
                         float keep_scale, cudaStream_t stream) {
  const dim3 grid((S + kBwdTile - 1) / kBwdTile, H, B);
#define PT_DKV_ARGS                                                          \
  static_cast<const T*>(q), static_cast<const T*>(k),                        \
      static_cast<const T*>(v), static_cast<const T*>(dout),                 \
      static_cast<const float*>(lse), static_cast<const float*>(delta),      \
      static_cast<T*>(dk), static_cast<T*>(dv), S, H, causal, q_sb, q_ss,    \
      q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, do_sb, do_ss, do_sh, dk_sb,  \
      dk_ss, dk_sh, dv_sb, dv_ss, dv_sh, scale
  if (rng == nullptr) {
    static SmemOptIn opt_in;
    const int smem = bwd_smem<T, D>(flash_bwd_dkv_kernel<T, D>, 2, opt_in);
    if (smem < 0) return -smem;
    flash_bwd_dkv_kernel<T, D><<<grid, kBwdBlock<T>, smem, stream>>>(
        PT_DKV_ARGS);
  } else {
    static SmemOptIn opt_in;
    const int smem =
        bwd_smem<T, D>(flash_bwd_dkv_dropout_kernel<T, D>, 2, opt_in);
    if (smem < 0) return -smem;
    flash_bwd_dkv_dropout_kernel<T, D><<<grid, kBwdBlock<T>, smem, stream>>>(
        PT_DKV_ARGS, static_cast<const long long*>(rng), rng_coords, threshold,
        keep_scale);
  }
#undef PT_DKV_ARGS
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
int launch_flash_bwd_dq(const void* q, const void* k, const void* v,
                        const void* dout, const void* lse, const void* delta,
                        void* dq, int B, int S, int H, int causal,
                        long long q_sb, long long q_ss, long long q_sh,
                        long long k_sb, long long k_ss, long long k_sh,
                        long long v_sb, long long v_ss, long long v_sh,
                        long long do_sb, long long do_ss, long long do_sh,
                        long long dq_sb, long long dq_ss, long long dq_sh,
                        float scale, const void* rng, int rng_coords,
                        long long threshold,
                        float keep_scale, cudaStream_t stream) {
  const dim3 grid((S + kBwdTile - 1) / kBwdTile, H, B);
#define PT_DQ_ARGS_                                                          \
  static_cast<const T*>(q), static_cast<const T*>(k),                        \
      static_cast<const T*>(v), static_cast<const T*>(dout),                 \
      static_cast<const float*>(lse), static_cast<const float*>(delta),      \
      static_cast<T*>(dq), S, H, causal, q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, \
      v_sb, v_ss, v_sh, do_sb, do_ss, do_sh, dq_sb, dq_ss, dq_sh, scale
  if (rng == nullptr) {
    static SmemOptIn opt_in;
    const int smem = bwd_smem<T, D>(flash_bwd_dq_kernel<T, D>, 1, opt_in);
    if (smem < 0) return -smem;
    flash_bwd_dq_kernel<T, D><<<grid, kBwdBlock<T>, smem, stream>>>(
        PT_DQ_ARGS_);
  } else {
    static SmemOptIn opt_in;
    const int smem =
        bwd_smem<T, D>(flash_bwd_dq_dropout_kernel<T, D>, 1, opt_in);
    if (smem < 0) return -smem;
    flash_bwd_dq_dropout_kernel<T, D><<<grid, kBwdBlock<T>, smem, stream>>>(
        PT_DQ_ARGS_, static_cast<const long long*>(rng), rng_coords, threshold,
        keep_scale);
  }
#undef PT_DQ_ARGS_
  return static_cast<int>(cudaGetLastError());
}

}  // namespace pt

extern "C" {

// dtype: 0 = float32, 1 = bfloat16, 2 = float16.  rng: NULL for no dropout,
// else the draw's int64 [seed, offset] on the device (the forward's;
// followed by [batch_start, head_start, heads_total] when rng_coords is
// nonzero), with the keep threshold round(p * 2^32) and keep_scale
// 1 / (1 - p).  Each returns the cudaError_t of the launch, or -1 for a
// (dtype, head_dim) pair that has no instance.
#define PT_BWD_DISPATCH(fn, ARGS)                                           \
  if (dtype == 0 && head_dim == 64) return pt::fn<float, 64>(ARGS);        \
  if (dtype == 0 && head_dim == 128) return pt::fn<float, 128>(ARGS);      \
  if (dtype == 1 && head_dim == 64) return pt::fn<__nv_bfloat16, 64>(ARGS); \
  if (dtype == 1 && head_dim == 128)                                        \
    return pt::fn<__nv_bfloat16, 128>(ARGS);                                \
  if (dtype == 2 && head_dim == 64) return pt::fn<__half, 64>(ARGS);       \
  if (dtype == 2 && head_dim == 128) return pt::fn<__half, 128>(ARGS);     \
  return -1;

#define PT_DKV_ARGS                                                        \
  q, k, v, dout, lse, delta, dk, dv, B, S, H, causal, q_sb, q_ss, q_sh,    \
      k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, do_sb, do_ss, do_sh, dk_sb,      \
      dk_ss, dk_sh, dv_sb, dv_ss, dv_sh, scale, rng, rng_coords, threshold,  \
      keep_scale, static_cast<cudaStream_t>(stream)

int pt_flash_bwd_dkv(int dtype, int head_dim, const void* q, const void* k,
                     const void* v, const void* dout, const void* lse,
                     const void* delta, void* dk, void* dv, int B, int S,
                     int H, int causal, long long q_sb, long long q_ss,
                     long long q_sh, long long k_sb, long long k_ss,
                     long long k_sh, long long v_sb, long long v_ss,
                     long long v_sh, long long do_sb, long long do_ss,
                     long long do_sh, long long dk_sb, long long dk_ss,
                     long long dk_sh, long long dv_sb, long long dv_ss,
                     long long dv_sh, float scale, const void* rng,
                     int rng_coords, long long threshold,
                     float keep_scale, void* stream) {
  PT_BWD_DISPATCH(launch_flash_bwd_dkv, PT_DKV_ARGS)
}

#define PT_DQ_ARGS                                                         \
  q, k, v, dout, lse, delta, dq, B, S, H, causal, q_sb, q_ss, q_sh, k_sb,  \
      k_ss, k_sh, v_sb, v_ss, v_sh, do_sb, do_ss, do_sh, dq_sb, dq_ss,     \
      dq_sh, scale, rng, rng_coords, threshold, keep_scale,                  \
      static_cast<cudaStream_t>(stream)

int pt_flash_bwd_dq(int dtype, int head_dim, const void* q, const void* k,
                    const void* v, const void* dout, const void* lse,
                    const void* delta, void* dq, int B, int S, int H,
                    int causal, long long q_sb, long long q_ss,
                    long long q_sh, long long k_sb, long long k_ss,
                    long long k_sh, long long v_sb, long long v_ss,
                    long long v_sh, long long do_sb, long long do_ss,
                    long long do_sh, long long dq_sb, long long dq_ss,
                    long long dq_sh, float scale, const void* rng,
                    int rng_coords, long long threshold,
                    float keep_scale, void* stream) {
  PT_BWD_DISPATCH(launch_flash_bwd_dq, PT_DQ_ARGS)
}

const char* pt_flash_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
