// Shared pieces of the hand-written attention kernels for Hopper (sm_90a).
//
// Arithmetic contract (the one the Pallas TPU kernels follow, in
// paddle_tpu/ops/pallas/flash_attention_kernel.py and
// paged_attention_kernel.py): softmax in f32, scale 1/sqrt(D), masked
// scores filled with -1e30, online softmax (running max m, running sum l,
// f32 accumulator), and the l == 0 guard at the end.  Inputs and outputs
// are f32, bf16 or f16.
//
// `attend_tile` is the f32 query-tile loop of the paged prefill kernel
// (K5, paged_attention.cu): one block holds kTileQ queries of one head in
// shared memory as f32 and walks the keys kChunkK at a time up to the
// tile's causal horizon, with both products as scalar FMA on the CUDA
// cores (67 TFLOP/s at most), so it is bound by those operations.  Keys are
// addressed through a functor (the paged kernel reads them through the
// block table).  The bf16 and f16 instances of K5 and K1 run the
// tensor-core loop of attention_wgmma.cuh through the same functors; the
// f32 K1 runs the 3xTF32 tensor-core loop of attention_tf32.cuh.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace pt {

// Opts a kernel instance in to more than 48 KB of dynamic shared memory
// (cudaFuncSetAttribute) once per device, at its first launch there, and
// not at every launch: a launch captured into a CUDA graph then makes no
// runtime call but cudaGetDevice, the launch itself and cudaGetLastError.
// Each launcher keeps one as a function-local static, so every kernel
// instance has its own record.
class SmemOptIn {
 public:
  // Returns `bytes`, or a negative cudaError_t.
  template <typename Kernel>
  int operator()(Kernel kernel, int bytes) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return -static_cast<int>(err);
    const bool kept = dev < kMaxDevices;
    if (kept && done_[dev].load(std::memory_order_acquire) == bytes)
      return bytes;
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return -static_cast<int>(err);
    if (kept) done_[dev].store(bytes, std::memory_order_release);
    return bytes;
  }

 private:
  static constexpr int kMaxDevices = 64;
  std::atomic<int> done_[kMaxDevices] = {};  // bytes opted in; 0: none yet
};

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 128;  // 4 warps per block
constexpr int kWarps = kThreads / 32;
constexpr int kTileQ = 16;     // queries per block (prefill-style kernels)
constexpr int kChunkK = 32;    // keys per step: one key per lane in the softmax

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}
// round to nearest; past f16's range the value becomes inf, never clamped
// (a loss scaler must see the overflow)
template <>
__device__ __forceinline__ __half from_f32<__half>(float x) {
  return __float2half_rn(x);
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// -- attention dropout -------------------------------------------------------
//
// Philox-4x32-10 (Salmon et al., SC'11; the Random123 constants) of a
// 128-bit counter under a 64-bit key: the same function as the plain
// version in paddle_tpu_torch/rng.py.
__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint2 k) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r > 0) {
      k.x += 0x9E3779B9u;
      k.y += 0xBB67AE85u;
    }
    const uint32_t hi0 = __umulhi(0xD2511F53u, c.x), lo0 = 0xD2511F53u * c.x;
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c.z), lo1 = 0xCD9E8D57u * c.z;
    c = make_uint4(hi1 ^ c.y ^ k.x, lo1, hi0 ^ c.w ^ k.y, lo0);
  }
  return c;
}

// No attention dropout: the kernels' p == 0 instances, whose code does not
// change.
struct NoDropout {
  static constexpr bool kOn = false;
  __device__ __forceinline__ void set_head(int, int, int) {}
};

// Attention dropout with rate p.  The bit of probability (row, col) of head
// row bh = b * H + h depends only on those coordinates and the draw, never on
// a kernel's tiles: it is word ((row >> 3) & 1) * 2 + (col & 1) of Philox at
// counter (col >> 1, (row >> 4) * 8 + (row & 7), bh, offset_lo) under key
// (seed_lo, seed_hi ^ offset_hi), so one counter covers rows row and row + 8
// (row % 16 < 8) and columns col and col + 1 (col even): the four values one
// thread of a tensor-core fragment holds.  The probability is kept iff the
// whole 32-bit word is >= threshold = round(p * 2^32) (an 8-bit threshold
// would bias the keep rate) and then multiplied by 1 / (1 - p).  Seed and
// offset are read from device memory (the generator's snapshot), so a
// captured graph draws new masks at every replay.  A rank that holds a slice
// of the whole tensors draws at its place in them: with `coords` the draw is
// int64 [seed, offset, batch_start, head_start, heads_total], and head h of
// local sample b takes the head row (batch_start + b) * heads_total +
// head_start + h of the whole [B, H] (rng.with_coordinates).
class Dropout {
 public:
  static constexpr bool kOn = true;

  // rng: int64 [seed, offset] on the device, followed by [batch_start,
  // head_start, heads_total] when `coords` is nonzero
  __device__ __forceinline__ Dropout(const long long* __restrict__ rng,
                                     int coords, long long threshold,
                                     float scale)
      : threshold_(threshold), scale_(scale) {
    const unsigned long long seed = rng[0], off = rng[1];
    key_ = make_uint2(static_cast<uint32_t>(seed),
                      static_cast<uint32_t>(seed >> 32) ^
                          static_cast<uint32_t>(off >> 32));
    offset_ = static_cast<uint32_t>(off);
    if (coords) {
      batch_start_ = static_cast<uint32_t>(rng[2]);
      head_start_ = static_cast<uint32_t>(rng[3]);
      heads_total_ = static_cast<uint32_t>(rng[4]);
    }
  }

  // Head h of local sample b, of H local heads.
  __device__ __forceinline__ void set_head(int b, int h, int H) {
    const uint32_t total = heads_total_ ? heads_total_ : H;
    bh_ = (batch_start_ + b) * total + head_start_ + h;
  }

  // The words of the counter that covers (row, col).
  __device__ __forceinline__ uint4 words(int row, int col) const {
    return philox4x32_10(
        make_uint4(static_cast<uint32_t>(col) >> 1,
                   (static_cast<uint32_t>(row) >> 4) * 8 + (row & 7), bh_,
                   offset_),
        key_);
  }

  __device__ __forceinline__ bool keep(uint32_t word) const {
    return static_cast<long long>(word) >= threshold_;
  }

  // Bits 0..3: the keep bits of words x, y, z, w.
  __device__ __forceinline__ uint32_t keep4(uint4 w) const {
    return static_cast<uint32_t>(keep(w.x)) |
           static_cast<uint32_t>(keep(w.y)) << 1 |
           static_cast<uint32_t>(keep(w.z)) << 2 |
           static_cast<uint32_t>(keep(w.w)) << 3;
  }

  // 1 / (1 - p) if `bit` is set, else 0.
  __device__ __forceinline__ float factor(uint32_t bit) const {
    return bit ? scale_ : 0.f;
  }

  // The factor of one element (a whole Philox call for it).
  __device__ __forceinline__ float at(int row, int col) const {
    const uint4 w = words(row, col);
    const int i = ((row >> 3) & 1) * 2 + (col & 1);
    const uint32_t x = i == 0 ? w.x : i == 1 ? w.y : i == 2 ? w.z : w.w;
    return keep(x) ? scale_ : 0.f;
  }

 private:
  uint2 key_;
  uint32_t offset_;
  uint32_t bh_ = 0;
  uint32_t batch_start_ = 0, head_start_ = 0, heads_total_ = 0;
  long long threshold_;
  float scale_;
};

// Rows are padded by one float so that a warp reading 32 different rows at
// the same column hits 32 different banks.
template <int D>
struct TileSmem {
  float q[kTileQ][D + 1];
  float k[kChunkK][D + 1];
  float v[kChunkK][D + 1];
  float p[kTileQ][kChunkK + 1];
  float m[kTileQ];
  float l[kTileQ];
  float corr[kTileQ];
  long long key_off[kChunkK];  // -1: the position has no storage
  long long val_off[kChunkK];
};

// One query tile against keys 0..horizon.
//
//   q_rows / o_rows: the tile's first query / output row; rows are
//       `q_stride` / `o_stride` elements apart, the head dim is contiguous.
//   n_rows:  valid rows in the tile (the last tile may be ragged); the
//       other rows compute on zero queries and are never stored.
//   qpos0:   absolute position of the tile's first query.
//   horizon: the last key position any valid row may see.
//   causal:  mask kpos > qpos (absolute positions).
//   key_at(pos, k_off, v_off): sets the element offsets of key row `pos`
//       in k_base and v_base (the kv head already applied); returns false
//       when the position has no storage.
//   lse_rows: where to write m + log(l) per row, or nullptr.
//   drop:    attention dropout (Dropout, its head set) or NoDropout;
//       row and column of a probability are qpos0 + r and the key position.
template <typename T, int D, typename KeyAt, typename Drop = NoDropout>
__device__ __forceinline__ void attend_tile(
    TileSmem<D>& sm, const T* __restrict__ q_rows, long long q_stride,
    int n_rows, int qpos0, int horizon, bool causal,
    const T* __restrict__ k_base, const T* __restrict__ v_base, KeyAt key_at,
    float scale, T* __restrict__ o_rows, long long o_stride,
    float* __restrict__ lse_rows, const Drop& drop = Drop{}) {
  static_assert(kChunkK == 32, "the softmax step maps one key per lane");
  static_assert((kTileQ * D) % kThreads == 0, "accumulator split");
  constexpr int kAcc = kTileQ * D / kThreads;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;

  for (int e = tid; e < kTileQ * D; e += kThreads) {
    const int r = e / D, d = e % D;
    sm.q[r][d] = r < n_rows ? to_f32(q_rows[r * q_stride + d]) : 0.f;
  }
  if (tid < kTileQ) {
    sm.m[tid] = kNegInf;
    sm.l[tid] = 0.f;
  }
  float acc[kAcc];
#pragma unroll
  for (int i = 0; i < kAcc; ++i) acc[i] = 0.f;
  __syncthreads();

  for (int c0 = 0; c0 <= horizon; c0 += kChunkK) {
    if (tid < kChunkK) {
      const int pos = c0 + tid;
      long long ko = -1, vo = -1;
      if (!(pos <= horizon && key_at(pos, ko, vo))) ko = vo = -1;
      sm.key_off[tid] = ko;
      sm.val_off[tid] = vo;
    }
    __syncthreads();
    for (int e = tid; e < kChunkK * D; e += kThreads) {
      const int j = e / D, d = e % D;
      const long long ko = sm.key_off[j];
      sm.k[j][d] = ko >= 0 ? to_f32(k_base[ko + d]) : 0.f;
      sm.v[j][d] = ko >= 0 ? to_f32(v_base[sm.val_off[j] + d]) : 0.f;
    }
    __syncthreads();
    // scores: a warp takes one query row and 32 keys
    for (int e = tid; e < kTileQ * kChunkK; e += kThreads) {
      const int r = e / kChunkK, j = e % kChunkK;
      float s = 0.f;
#pragma unroll 8
      for (int d = 0; d < D; ++d) s = fmaf(sm.q[r][d], sm.k[j][d], s);
      s *= scale;
      const bool valid =
          sm.key_off[j] >= 0 && (!causal || c0 + j <= qpos0 + r);
      sm.p[r][j] = valid ? s : kNegInf;
    }
    __syncthreads();
    // online softmax: a warp per row, a lane per key
    for (int r = warp; r < kTileQ; r += kWarps) {
      const float s = sm.p[r][lane];
      const float m_prev = sm.m[r];
      const float m_new = fmaxf(m_prev, warp_max(s));
      const float p = expf(s - m_new);
      const float psum = warp_sum(p);  // l and lse: the undropped p
      if constexpr (Drop::kOn)
        sm.p[r][lane] = p * drop.at(qpos0 + r, c0 + lane);
      else
        sm.p[r][lane] = p;
      if (lane == 0) {
        const float corr = expf(m_prev - m_new);
        sm.corr[r] = corr;
        sm.m[r] = m_new;
        sm.l[r] = sm.l[r] * corr + psum;
      }
    }
    __syncthreads();
    // acc = acc * corr + p @ v
#pragma unroll
    for (int i = 0; i < kAcc; ++i) {
      const int e = tid + i * kThreads;
      const int r = e / D, d = e % D;
      float a = acc[i] * sm.corr[r];
#pragma unroll 8
      for (int j = 0; j < kChunkK; ++j) a = fmaf(sm.p[r][j], sm.v[j][d], a);
      acc[i] = a;
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < kAcc; ++i) {
    const int e = tid + i * kThreads;
    const int r = e / D, d = e % D;
    if (r < n_rows) {
      const float l = sm.l[r] == 0.f ? 1.f : sm.l[r];
      o_rows[r * o_stride + d] = from_f32<T>(acc[i] / l);
    }
  }
  if (lse_rows != nullptr && tid < n_rows) {
    const float l = sm.l[tid] == 0.f ? 1.f : sm.l[tid];
    lse_rows[tid] = sm.m[tid] + logf(fmaxf(l, 1e-30f));
  }
}

}  // namespace pt
