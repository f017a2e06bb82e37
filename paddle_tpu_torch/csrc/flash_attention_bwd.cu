// Flash attention backward for Hopper (sm_90a): kernels K2 (dK, dV) and K3
// (dQ).
//
// Replaces the backward half of paddle_tpu/ops/pallas/flash_attention_kernel.py
// (`_bwd`, kernels `_bwd_dkv_kernel` and `_bwd_dq_kernel`, with their shared
// `_p_ds` recompute).  From q/k/v/dO [B, S, H, D] (read through their
// strides, head dim contiguous), K1's compact lse [B*H, S] (row b*H + h) and
// delta = rowsum(dO * O) in the same layout, both kernels recompute
//
//   s  = (q k^T) * scale, masked kpos > qpos (absolute positions) if causal
//   p  = exp(s - lse)                      (0 where masked)
//   ds = p * (dO v^T - delta) * scale
//
// in f32.  K2 accumulates dV += p^T dO and dK += ds^T q; K3 accumulates
// dQ += ds k.  As in the Pallas kernels, p is rounded to dO's dtype before
// the dV product and ds to q's (k's) dtype before the dK (dQ) product; the
// sums stay f32 and the results are rounded once to the input dtype.
//
// Bound by operations at the GPT-2 345M shape (8D flops per live (q, k) pair
// for K2, 6D for K3, against each input read once).  One block per (64-key
// tile, head, batch) for K2 walks only the query tiles that can see its keys
// (from its own diagonal to S when causal); one block per (64-query tile,
// head, batch) for K3 walks the key tiles up to its causal horizon.  Each
// block owns its output rows, so there are no atomics.  Operands sit in
// shared memory as f32 (rows padded by one float against bank conflicts),
// and each of the 256 threads keeps a 4 x 4 (or 4 x D/16) register tile of
// every product, so a shared-memory load feeds four FMAs.  The products run
// on CUDA-core f32 FMA; wgmma with TMA-fed tiles is later work.
#include "attention_common.cuh"

namespace pt {

constexpr int kBwdTile = 64;       // query rows / key rows per tile
constexpr int kBwdThreads = 256;
constexpr int kSide = 16;          // threads per tile edge: tm, tn in 0..15
constexpr int kPer = kBwdTile / kSide;  // rows (and columns) per thread

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

// K2: one block per (key tile, head, batch) accumulates its dK and dV rows
// over the query tiles that can see them.
template <typename T, int D>
__global__ void __launch_bounds__(kBwdThreads) flash_bwd_dkv_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv,
    int S, int H, int causal, long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh, long long v_sb,
    long long v_ss, long long v_sh, long long do_sb, long long do_ss,
    long long do_sh, long long dk_sb, long long dk_ss, long long dk_sh,
    long long dv_sb, long long dv_ss, long long dv_sh, float scale) {
  using L = BwdLayout<D>;
  extern __shared__ float smem[];
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
        const float ds = p * (dpt[i][j] - sdelta[qr]) * scale;
        sp[kj * L::kLdP + qr] = round_to<T>(p);
        sds[kj * L::kLdP + qr] = round_to<T>(ds);
      }
    }
    __syncthreads();
    tile_nn<D>(sp, L::kLdP, sdo, L::kLd, tm, tn, dv_acc);
    tile_nn<D>(sds, L::kLdP, sq, L::kLd, tm, tn, dk_acc);
  }
  store_rows<T, D>(dk + b * dk_sb + k0 * dk_ss + h * dk_sh, dk_ss, n_keys, tm,
                   tn, dk_acc);
  store_rows<T, D>(dv + b * dv_sb + k0 * dv_ss + h * dv_sh, dv_ss, n_keys, tm,
                   tn, dv_acc);
}

// K3: one block per (query tile, head, batch) accumulates its dQ rows over
// the key tiles up to its causal horizon.
template <typename T, int D>
__global__ void __launch_bounds__(kBwdThreads) flash_bwd_dq_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, T* __restrict__ dq, int S, int H,
    int causal, long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh, long long v_sb,
    long long v_ss, long long v_sh, long long do_sb, long long do_ss,
    long long do_sh, long long dq_sb, long long dq_ss, long long dq_sh,
    float scale) {
  using L = BwdLayout<D>;
  extern __shared__ float smem[];
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
        sds[r * L::kLdP + c] = round_to<T>(p * (dp[i][j] - sdelta[r]) * scale);
      }
    }
    __syncthreads();
    tile_nn<D>(sds, L::kLdP, sk, L::kLd, tm, tn, acc);
  }
  store_rows<T, D>(dq + b * dq_sb + q0 * dq_ss + h * dq_sh, dq_ss, n_rows, tm,
                   tn, acc);
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
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
                         float scale, cudaStream_t stream) {
  const size_t bytes = BwdLayout<D>::bytes(2);
  cudaError_t err = allow_smem(flash_bwd_dkv_kernel<T, D>, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((S + kBwdTile - 1) / kBwdTile, H, B);
  flash_bwd_dkv_kernel<T, D><<<grid, kBwdThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dk), static_cast<T*>(dv), S, H, causal, q_sb, q_ss,
      q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, do_sb, do_ss, do_sh, dk_sb,
      dk_ss, dk_sh, dv_sb, dv_ss, dv_sh, scale);
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
                        float scale, cudaStream_t stream) {
  const size_t bytes = BwdLayout<D>::bytes(1);
  cudaError_t err = allow_smem(flash_bwd_dq_kernel<T, D>, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((S + kBwdTile - 1) / kBwdTile, H, B);
  flash_bwd_dq_kernel<T, D><<<grid, kBwdThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dq), S, H, causal, q_sb, q_ss, q_sh, k_sb, k_ss, k_sh,
      v_sb, v_ss, v_sh, do_sb, do_ss, do_sh, dq_sb, dq_ss, dq_sh, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace pt

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  Each returns the cudaError_t of the
// launch, or -1 for a (dtype, head_dim) pair that has no instance.
#define PT_BWD_DISPATCH(fn, ARGS)                                           \
  if (dtype == 0 && head_dim == 64) return pt::fn<float, 64>(ARGS);        \
  if (dtype == 0 && head_dim == 128) return pt::fn<float, 128>(ARGS);      \
  if (dtype == 1 && head_dim == 64) return pt::fn<__nv_bfloat16, 64>(ARGS); \
  if (dtype == 1 && head_dim == 128)                                        \
    return pt::fn<__nv_bfloat16, 128>(ARGS);                                \
  return -1;

#define PT_DKV_ARGS                                                        \
  q, k, v, dout, lse, delta, dk, dv, B, S, H, causal, q_sb, q_ss, q_sh,    \
      k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, do_sb, do_ss, do_sh, dk_sb,      \
      dk_ss, dk_sh, dv_sb, dv_ss, dv_sh, scale,                            \
      static_cast<cudaStream_t>(stream)

int pt_flash_bwd_dkv(int dtype, int head_dim, const void* q, const void* k,
                     const void* v, const void* dout, const void* lse,
                     const void* delta, void* dk, void* dv, int B, int S,
                     int H, int causal, long long q_sb, long long q_ss,
                     long long q_sh, long long k_sb, long long k_ss,
                     long long k_sh, long long v_sb, long long v_ss,
                     long long v_sh, long long do_sb, long long do_ss,
                     long long do_sh, long long dk_sb, long long dk_ss,
                     long long dk_sh, long long dv_sb, long long dv_ss,
                     long long dv_sh, float scale, void* stream) {
  PT_BWD_DISPATCH(launch_flash_bwd_dkv, PT_DKV_ARGS)
}

#define PT_DQ_ARGS                                                         \
  q, k, v, dout, lse, delta, dq, B, S, H, causal, q_sb, q_ss, q_sh, k_sb,  \
      k_ss, k_sh, v_sb, v_ss, v_sh, do_sb, do_ss, do_sh, dq_sb, dq_ss,     \
      dq_sh, scale, static_cast<cudaStream_t>(stream)

int pt_flash_bwd_dq(int dtype, int head_dim, const void* q, const void* k,
                    const void* v, const void* dout, const void* lse,
                    const void* delta, void* dq, int B, int S, int H,
                    int causal, long long q_sb, long long q_ss,
                    long long q_sh, long long k_sb, long long k_ss,
                    long long k_sh, long long v_sb, long long v_ss,
                    long long v_sh, long long do_sb, long long do_ss,
                    long long do_sh, long long dq_sb, long long dq_ss,
                    long long dq_sh, float scale, void* stream) {
  PT_BWD_DISPATCH(launch_flash_bwd_dq, PT_DQ_ARGS)
}

const char* pt_flash_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
