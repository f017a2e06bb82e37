// Flash attention forward for Hopper (sm_90a): kernel K1.
//
// Replaces the forward half of paddle_tpu/ops/pallas/flash_attention_kernel.py
// (`_fwd`, kernel `_fwd_kernel`, reached through `flash_attention_fused`):
// causal (or full) self-attention over q/k/v [B, S, H, D] with an online
// softmax, emitting O in the input dtype and lse = m + log(l) in f32.  The
// lse is compact [B*H, S] (row b*H + h), which the backward kernels K2/K3
// read; the TPU's [BH, S, 1] buffer was a layout artifact.
//
// Bound by operations at the main paths' shapes: 4 * B * H * D *
// sum_q(keys attended) flops against 4 * B * S * H * D * itemsize bytes
// (at the GPT-2 345M shape the bytes bound is larger only because the
// published bf16 peak is so high; either way the tensor cores are the
// only route to it).  The tensors are read through their strides (GPT's
// fused [B, S, H, 3D] projection, Llama's kv split): no transpose to
// [B*H, S, D].
//
// bf16 and f16 run on tensor cores: one warpgroup per (64-query tile, head,
// batch) runs `tc::attend_tile` (attention_wgmma.cuh) with the element type
// as its template parameter: wgmma for Q K^T and P V, a two-stage cp.async
// ring of swizzled K/V tiles, the softmax on the accumulator fragment.  As
// in the Pallas kernel, p is rounded to the input dtype before P V.  Rows
// must be 16-byte aligned (the wrapper checks).
// The heaviest (last) causal query tiles are scheduled first.
//
// Attention dropout (`flash_fwd_dropout_kernel`, FlashAttention-2's): the
// tile's p is multiplied by M / (1 - p) before P V, M the Philox keep bits
// of `Dropout` (attention_common.cuh) at the probabilities' global
// coordinates; the row sum l, and so lse, stays that of the undropped p, as
// the backward kernels need it.  Seed and offset come from device memory.
// The p == 0 kernel is the same code as before, with no dropout compiled in.
//
// f32 keeps the CUDA-core loop `attend_tile` (attention_common.cuh), 16
// queries per block, which the f32 parity checks use.
#include "attention_wgmma.cuh"

namespace pt {

// Key `pos` of one (batch, head) row of strided [B, S, H, D] k and v.
struct DenseKeyAt {
  long long k_base, k_ss, v_base, v_ss;
  int S;
  __device__ __forceinline__ int limit() const { return S; }
  __device__ __forceinline__ bool operator()(int pos, long long& k_off,
                                             long long& v_off) const {
    if (pos >= S) return false;
    k_off = k_base + (long long)pos * k_ss;
    v_off = v_base + (long long)pos * v_ss;
    return true;
  }
};

// One block: a query tile of one (head, batch).  `drop` is NoDropout, or
// Dropout with its head row set here.
template <typename T, int D, typename Drop>
__device__ __forceinline__ void flash_fwd_block(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    T* __restrict__ o, float* __restrict__ lse, int S, int H, int causal,
    long long q_sb, long long q_ss, long long q_sh, long long k_sb,
    long long k_ss, long long k_sh, long long v_sb, long long v_ss,
    long long v_sh, long long o_sb, long long o_ss, long long o_sh,
    float scale, Drop drop) {
  constexpr int kTile = tc::kQueryTile<T>;
  // last query tile first: under a causal mask it has the most keys
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kTile;
  const int h = blockIdx.y, b = blockIdx.z;
  const int n_rows = min(kTile, S - q0);
  const int horizon = causal ? q0 + n_rows - 1 : S - 1;
  const DenseKeyAt key_at{(long long)b * k_sb + (long long)h * k_sh, k_ss,
                          (long long)b * v_sb + (long long)h * v_sh, v_ss, S};
  const T* q_rows = q + b * q_sb + q0 * q_ss + h * q_sh;
  T* o_rows = o + b * o_sb + q0 * o_ss + h * o_sh;
  float* lse_rows = lse + ((long long)b * H + h) * S + q0;
  drop.set_head(b, h, H);
  if constexpr (tc::kOnTensorCores<T>) {
    extern __shared__ uint8_t dyn_smem[];
    tc::attend_tile<T, D>(dyn_smem, q_rows, q_ss, n_rows, q0, horizon,
                       causal != 0, k, v, key_at, scale, o_rows, o_ss,
                       lse_rows, drop);
  } else {
    __shared__ TileSmem<D> sm;
    attend_tile<T, D>(sm, q_rows, q_ss, n_rows, q0, horizon, causal != 0, k,
                      v, key_at, scale, o_rows, o_ss, lse_rows, drop);
  }
}

#define PT_FWD_PARAMS                                                        \
  const T *__restrict__ q, const T *__restrict__ k,                          \
      const T *__restrict__ v, T *__restrict__ o, float *__restrict__ lse,   \
      int S, int H, int causal, long long q_sb, long long q_ss,              \
      long long q_sh, long long k_sb, long long k_ss, long long k_sh,        \
      long long v_sb, long long v_ss, long long v_sh, long long o_sb,        \
      long long o_ss, long long o_sh, float scale
#define PT_FWD_FORWARD                                                       \
  q, k, v, o, lse, S, H, causal, q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb,   \
      v_ss, v_sh, o_sb, o_ss, o_sh, scale

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(PT_FWD_PARAMS) {
  flash_fwd_block<T, D>(PT_FWD_FORWARD, NoDropout{});
}

// K1 with attention dropout: p times the keep factor before P V (rng: the
// draw's [seed, offset] on the device; keep iff word >= threshold).
template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_fwd_dropout_kernel(
    PT_FWD_PARAMS, const long long* __restrict__ rng, int rng_coords,
    long long threshold, float keep_scale) {
  flash_fwd_block<T, D>(PT_FWD_FORWARD,
                        Dropout(rng, rng_coords, threshold, keep_scale));
}

template <typename T, int D>
int launch_flash_fwd(const void* q, const void* k, const void* v, void* o,
                     void* lse, int B, int S, int H, int causal,
                     long long q_sb, long long q_ss, long long q_sh,
                     long long k_sb, long long k_ss, long long k_sh,
                     long long v_sb, long long v_ss, long long v_sh,
                     long long o_sb, long long o_ss, long long o_sh,
                     float scale, const void* rng, int rng_coords,
                     long long threshold,
                     float keep_scale, cudaStream_t stream) {
  const dim3 grid((S + tc::kQueryTile<T> - 1) / tc::kQueryTile<T>, H, B);
#define PT_FWD_ARGS                                                          \
  static_cast<const T*>(q), static_cast<const T*>(k),                        \
      static_cast<const T*>(v), static_cast<T*>(o), static_cast<float*>(lse), \
      S, H, causal, q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh,     \
      o_sb, o_ss, o_sh, scale
  if (rng == nullptr) {
    static SmemOptIn opt_in;
    const int smem = tc::dynamic_smem<T, D>(flash_fwd_kernel<T, D>, opt_in);
    if (smem < 0) return -smem;
    flash_fwd_kernel<T, D><<<grid, kThreads, smem, stream>>>(PT_FWD_ARGS);
  } else {
    static SmemOptIn opt_in;
    const int smem =
        tc::dynamic_smem<T, D>(flash_fwd_dropout_kernel<T, D>, opt_in);
    if (smem < 0) return -smem;
    flash_fwd_dropout_kernel<T, D><<<grid, kThreads, smem, stream>>>(
        PT_FWD_ARGS, static_cast<const long long*>(rng), rng_coords, threshold,
        keep_scale);
  }
#undef PT_FWD_ARGS
  return static_cast<int>(cudaGetLastError());
}

}  // namespace pt

extern "C" {

// dtype: 0 = float32, 1 = bfloat16, 2 = float16.  rng: NULL for no
// dropout, else the draw's int64 [seed, offset] on the device (followed by
// [batch_start, head_start, heads_total] when rng_coords is nonzero), with
// the keep threshold round(p * 2^32) and keep_scale 1 / (1 - p).  Returns
// the cudaError_t of the launch, or -1 for a (dtype, head_dim) pair that has
// no instance.
#define PT_FLASH_ARGS                                                      \
  q, k, v, o, lse, B, S, H, causal, q_sb, q_ss, q_sh, k_sb, k_ss, k_sh,    \
      v_sb, v_ss, v_sh, o_sb, o_ss, o_sh, scale, rng, rng_coords, threshold, \
      keep_scale, static_cast<cudaStream_t>(stream)

int pt_flash_fwd(int dtype, int head_dim, const void* q, const void* k,
                 const void* v, void* o, void* lse, int B, int S, int H,
                 int causal, long long q_sb, long long q_ss, long long q_sh,
                 long long k_sb, long long k_ss, long long k_sh,
                 long long v_sb, long long v_ss, long long v_sh,
                 long long o_sb, long long o_ss, long long o_sh, float scale,
                 const void* rng, int rng_coords, long long threshold,
                 float keep_scale, void* stream) {
  if (dtype == 0 && head_dim == 64)
    return pt::launch_flash_fwd<float, 64>(PT_FLASH_ARGS);
  if (dtype == 0 && head_dim == 128)
    return pt::launch_flash_fwd<float, 128>(PT_FLASH_ARGS);
  if (dtype == 1 && head_dim == 64)
    return pt::launch_flash_fwd<__nv_bfloat16, 64>(PT_FLASH_ARGS);
  if (dtype == 1 && head_dim == 128)
    return pt::launch_flash_fwd<__nv_bfloat16, 128>(PT_FLASH_ARGS);
  if (dtype == 2 && head_dim == 64)
    return pt::launch_flash_fwd<__half, 64>(PT_FLASH_ARGS);
  if (dtype == 2 && head_dim == 128)
    return pt::launch_flash_fwd<__half, 128>(PT_FLASH_ARGS);
  return -1;
}

const char* pt_flash_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
