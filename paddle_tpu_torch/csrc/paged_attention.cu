// Paged attention for Hopper (sm_90a): decode (K4) and fused tail prefill (K5).
//
// Replaces paddle_tpu/ops/pallas/paged_attention_kernel.py:
//   K4 `paged_decode_attention_kernel` (kernel `_decode_kernel`), and
//   K5 `paged_prefill_attention_kernel` (kernel `_prefill_kernel`).
// Both read K/V straight off the block pool through the block table: no
// contiguous copy of a slot's sequence is ever made.
//
// K4 is bound by bytes: each decode step reads every live K/V row of every
// slot once, 2 * (len+1) * Hkv * D * itemsize bytes per slot, against
// 4 * H * D * (len+1) flops.  One block per (slot, kv head) holds that head's
// group of H/Hkv query heads, so a K/V row is read once for the whole group
// (GQA in-kernel), and it loops only over the live keys 0..lengths[b]: the
// TPU grid walks all max_blocks blocks and skips the dead ones.  Four
// threads share a key, so a chunk of 32 keys is in flight at once.  It runs
// on CUDA-core f32 FMA in both dtypes.
//
// K5 is bound by operations at long tails: 4 * H * D * sum_q(keys attended)
// flops.  One block per (query tile, head) walks the key tiles up to the
// tile's causal horizon start + last_row; the Pallas kernel instead holds
// all S queries in VMEM, which S = 4096 would not fit in shared memory.
// bf16 runs on tensor cores through `tc::attend_tile` (attention_wgmma.cuh),
// the loop K1 runs: 64 queries per warpgroup, wgmma for both products, K/V
// rows fetched by cp.async through the block table (a 64-key tile spans
// four 16-row pool blocks).  It rounds p to bf16 before P V, where the
// Pallas kernel keeps p in f32: one bf16 rounding of p apart.  f32 keeps the
// CUDA-core loop `attend_tile` (attention_common.cuh), 16 queries a block.
#include "attention_wgmma.cuh"

namespace pt {

constexpr int kMaxGroup = 8;  // query heads per kv head one decode block holds

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) paged_decode_kernel(
    const T* __restrict__ q, const T* __restrict__ k_pool,
    const T* __restrict__ v_pool, const int* __restrict__ tables,
    const int* __restrict__ lengths, T* __restrict__ out, int H, int Hkv,
    int block_size, int max_blocks, long long q_sb, long long q_sh,
    long long o_sb, long long o_sh, long long t_sb, long long p_sb,
    long long p_st, long long p_sh, float scale) {
  static_assert(kThreads % D == 0, "a thread owns one head-dim column");
  constexpr int kLanesPerKey = kThreads / kChunkK;   // 4
  constexpr int kKeyFrag = D / kLanesPerKey;         // dims per thread
  constexpr int kRowsPerPass = kThreads / D;         // group rows per pass
  constexpr int kAcc = (kMaxGroup + kRowsPerPass - 1) / kRowsPerPass;
  __shared__ float q_s[kMaxGroup][D];
  __shared__ float s_s[kMaxGroup][kChunkK + 1];
  __shared__ float m_s[kMaxGroup];
  __shared__ float l_s[kMaxGroup];
  __shared__ float corr_s[kMaxGroup];
  __shared__ long long off_s[kChunkK];

  const int b = blockIdx.x, hkv = blockIdx.y;
  const int G = H / Hkv;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int* row = tables + b * t_sb;
  // the window is 0..lengths[b] inclusive (the current token was written
  // before the call); a length past the table attends the whole table
  const int n_keys = min(lengths[b] + 1, max_blocks * block_size);
  const long long head_off = (long long)hkv * p_sh;

  for (int e = tid; e < G * D; e += kThreads) {
    const int g = e / D, d = e % D;
    q_s[g][d] = to_f32(q[b * q_sb + (long long)(hkv * G + g) * q_sh + d]);
  }
  if (tid < G) {
    m_s[tid] = kNegInf;
    l_s[tid] = 0.f;
  }
  const int kj = tid / kLanesPerKey, sub = tid % kLanesPerKey;
  const int d = tid % D, g_first = tid / D;
  float acc[kAcc];
#pragma unroll
  for (int i = 0; i < kAcc; ++i) acc[i] = 0.f;
  __syncthreads();

  for (int c0 = 0; c0 < n_keys; c0 += kChunkK) {
    if (tid < kChunkK) {
      const int pos = c0 + tid;
      off_s[tid] = pos < n_keys
                       ? (long long)row[pos / block_size] * p_sb +
                             (long long)(pos % block_size) * p_st + head_off
                       : -1LL;
    }
    __syncthreads();
    {  // scores: four threads per key, each a strided quarter of the head dim
      const long long off = off_s[kj];
      float kf[kKeyFrag];
#pragma unroll
      for (int i = 0; i < kKeyFrag; ++i)
        kf[i] = off >= 0 ? to_f32(k_pool[off + sub + kLanesPerKey * i]) : 0.f;
      for (int g = 0; g < G; ++g) {
        float s = 0.f;
#pragma unroll
        for (int i = 0; i < kKeyFrag; ++i)
          s = fmaf(q_s[g][sub + kLanesPerKey * i], kf[i], s);
        s += __shfl_xor_sync(0xffffffffu, s, 1);
        s += __shfl_xor_sync(0xffffffffu, s, 2);
        if (sub == 0) s_s[g][kj] = off >= 0 ? s * scale : kNegInf;
      }
    }
    __syncthreads();
    for (int g = warp; g < G; g += kWarps) {  // online softmax, a lane per key
      const float s = s_s[g][lane];
      const float m_prev = m_s[g];
      const float m_new = fmaxf(m_prev, warp_max(s));
      const float p = expf(s - m_new);
      const float psum = warp_sum(p);
      s_s[g][lane] = p;
      if (lane == 0) {
        const float corr = expf(m_prev - m_new);
        corr_s[g] = corr;
        m_s[g] = m_new;
        l_s[g] = l_s[g] * corr + psum;
      }
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kAcc; ++i) {
      const int g = g_first + i * kRowsPerPass;
      if (g < G) acc[i] *= corr_s[g];
    }
    for (int j = 0; j < kChunkK; ++j) {
      const long long off = off_s[j];
      if (off < 0) break;  // the live keys are a prefix of the chunk
      const float vv = to_f32(v_pool[off + d]);
#pragma unroll
      for (int i = 0; i < kAcc; ++i) {
        const int g = g_first + i * kRowsPerPass;
        if (g < G) acc[i] = fmaf(s_s[g][j], vv, acc[i]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < kAcc; ++i) {
    const int g = g_first + i * kRowsPerPass;
    if (g < G) {
      const float l = l_s[g] == 0.f ? 1.f : l_s[g];
      out[b * o_sb + (long long)(hkv * G + g) * o_sh + d] =
          from_f32<T>(acc[i] / l);
    }
  }
}

// Key `pos` of one slot's block row, kv head applied.
struct PagedKeyAt {
  const int* row;
  int block_size;
  int max_blocks;
  long long p_sb, p_st, head_off;
  __device__ __forceinline__ int limit() const {
    return max_blocks * block_size;
  }
  __device__ __forceinline__ bool operator()(int pos, long long& k_off,
                                             long long& v_off) const {
    const int j = pos / block_size;
    if (j >= max_blocks) return false;
    k_off = v_off = (long long)row[j] * p_sb +
                    (long long)(pos % block_size) * p_st + head_off;
    return true;
  }
};

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) paged_prefill_kernel(
    const T* __restrict__ q, const T* __restrict__ k_pool,
    const T* __restrict__ v_pool, const int* __restrict__ row, int start,
    T* __restrict__ out, int S, int H, int Hkv, int block_size,
    int max_blocks, long long q_ss, long long q_sh, long long o_ss,
    long long o_sh, long long p_sb, long long p_st, long long p_sh,
    float scale) {
  constexpr int kTile = tc::kQueryTile<T>;
  // last query tile first: it has the most keys
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kTile, h = blockIdx.y;
  const int n_rows = min(kTile, S - q0);
  const int hkv = h / (H / Hkv);
  const PagedKeyAt key_at{row,  block_size, max_blocks,
                          p_sb, p_st,       (long long)hkv * p_sh};
  // query s sits at absolute position start + s and sees keys 0..start+s
  const T* q_rows = q + q0 * q_ss + h * q_sh;
  T* o_rows = out + q0 * o_ss + h * o_sh;
  const int horizon = start + q0 + n_rows - 1;
  if constexpr (tc::kOnTensorCores<T>) {
    extern __shared__ uint8_t dyn_smem[];
    tc::attend_tile<D>(dyn_smem, q_rows, q_ss, n_rows, start + q0, horizon,
                       /*causal=*/true, k_pool, v_pool, key_at, scale,
                       o_rows, o_ss, nullptr);
  } else {
    __shared__ TileSmem<D> sm;
    attend_tile<T, D>(sm, q_rows, q_ss, n_rows, start + q0, horizon,
                      /*causal=*/true, k_pool, v_pool, key_at, scale, o_rows,
                      o_ss, nullptr);
  }
}

template <typename T, int D>
int launch_decode(const void* q, const void* k_pool, const void* v_pool,
                  const void* tables, const void* lengths, void* out, int B,
                  int H, int Hkv, int block_size, int max_blocks,
                  long long q_sb, long long q_sh, long long o_sb,
                  long long o_sh, long long t_sb, long long p_sb,
                  long long p_st, long long p_sh, float scale,
                  cudaStream_t stream) {
  paged_decode_kernel<T, D><<<dim3(B, Hkv), kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pool),
      static_cast<const T*>(v_pool), static_cast<const int*>(tables),
      static_cast<const int*>(lengths), static_cast<T*>(out), H, Hkv,
      block_size, max_blocks, q_sb, q_sh, o_sb, o_sh, t_sb, p_sb, p_st, p_sh,
      scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
int launch_prefill(const void* q, const void* k_pool, const void* v_pool,
                   const void* row, int start, void* out, int S, int H,
                   int Hkv, int block_size, int max_blocks, long long q_ss,
                   long long q_sh, long long o_ss, long long o_sh,
                   long long p_sb, long long p_st, long long p_sh, float scale,
                   cudaStream_t stream) {
  const int smem = tc::dynamic_smem<T, D>(paged_prefill_kernel<T, D>);
  if (smem < 0) return -smem;
  const dim3 grid((S + tc::kQueryTile<T> - 1) / tc::kQueryTile<T>, H);
  paged_prefill_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pool),
      static_cast<const T*>(v_pool), static_cast<const int*>(row), start,
      static_cast<T*>(out), S, H, Hkv, block_size, max_blocks, q_ss, q_sh,
      o_ss, o_sh, p_sb, p_st, p_sh, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace pt

// dtype: 0 = float32, 1 = bfloat16.  Returns the cudaError_t of the launch,
// or -1 for a (dtype, head_dim) pair that has no instance.
#define PT_DISPATCH(FN, ...)                                              \
  if (dtype == 0 && head_dim == 64) return FN<float, 64>(__VA_ARGS__);    \
  if (dtype == 0 && head_dim == 128) return FN<float, 128>(__VA_ARGS__);  \
  if (dtype == 1 && head_dim == 64)                                       \
    return FN<__nv_bfloat16, 64>(__VA_ARGS__);                            \
  if (dtype == 1 && head_dim == 128)                                      \
    return FN<__nv_bfloat16, 128>(__VA_ARGS__);                           \
  return -1;

extern "C" {

int pt_paged_decode(int dtype, int head_dim, const void* q, const void* k_pool,
                    const void* v_pool, const void* tables,
                    const void* lengths, void* out, int B, int H, int Hkv,
                    int block_size, int max_blocks, long long q_sb,
                    long long q_sh, long long o_sb, long long o_sh,
                    long long t_sb, long long p_sb, long long p_st,
                    long long p_sh, float scale, void* stream) {
  if (H % Hkv != 0 || H / Hkv > pt::kMaxGroup) return -1;
  PT_DISPATCH(pt::launch_decode, q, k_pool, v_pool, tables, lengths, out, B,
              H, Hkv, block_size, max_blocks, q_sb, q_sh, o_sb, o_sh, t_sb,
              p_sb, p_st, p_sh, scale, static_cast<cudaStream_t>(stream))
}

int pt_paged_prefill(int dtype, int head_dim, const void* q,
                     const void* k_pool, const void* v_pool, const void* row,
                     int start, void* out, int S, int H, int Hkv,
                     int block_size, int max_blocks, long long q_ss,
                     long long q_sh, long long o_ss, long long o_sh,
                     long long p_sb, long long p_st, long long p_sh,
                     float scale, void* stream) {
  if (H % Hkv != 0) return -1;
  PT_DISPATCH(pt::launch_prefill, q, k_pool, v_pool, row, start, out, S, H,
              Hkv, block_size, max_blocks, q_ss, q_sh, o_ss, o_sh, p_sb, p_st,
              p_sh, scale, static_cast<cudaStream_t>(stream))
}

const char* pt_paged_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
