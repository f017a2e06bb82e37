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
// 4 * H * D * (len+1) flops: G = H/Hkv <= 8 flops per byte in bf16, far
// below the ~295 the card needs before its tensor cores are the limit.  So
// the design is about keeping enough bytes in flight (flash-decoding):
//
//   * Split-K.  A split is a fixed run of `split_keys` positions, and the
//     number of splits is ceil(max_blocks * block_size / split_keys): a
//     function of the shapes alone, so the wrapper never reads `lengths` on
//     the host and the launch can be captured in a CUDA graph.  The grid is
//     (grid_splits, kv head, slot), grid_splits <= splits chosen by the
//     wrapper from the shapes (ops/kernels.py `decode_plan`); block x walks
//     splits x, x + grid_splits, ... of its slot's live window and exits at
//     once when x is past it.  So one long slot spreads over grid_splits SMs
//     instead of one block walking it alone, and a short window in a long
//     table leaves few idle blocks.
//   * Bytes in flight inside a block.  A K or V row of one head is
//     D * itemsize bytes; lanes take it in 16-byte pieces, so one warp-wide
//     load covers 32 * 16 / (D * itemsize) keys (two in bf16 at D 128).
//     Each warp walks its own steps of kLoads such loads of K and of V, all
//     issued before any is used, with its own running (m, l, acc) in
//     registers: no __syncthreads per step.  A small group (the main path's
//     MHA) also keeps the next step's loads in flight while it uses this
//     step's.  The split's row offsets (block table lookups) are formed
//     once in shared memory.
//   * GQA in-kernel: the block holds the whole query group (G <= 8 rows, in
//     registers as f32, scaled by 1/sqrt(D) * log2(e) so that the softmax
//     runs on exp2), so each K/V row is read from memory once for the group.
//     The group size is a template bucket (1, 2, 4, 8) so that the
//     registers of a small group are not spent on a large one; a group of 8
//     is split over two warps that walk the same keys (4 rows each), which
//     keeps it at 168 registers instead of 255.
//   * Merge.  The block's warps merge in shared memory once, at the end of
//     the split.  A slot whose window fits in one split writes its output
//     directly.  Otherwise each live split writes its partial (m, l, and the
//     unnormalised acc, f32) to scratch, and the last-arriving block of the
//     (slot, kv head), found through an int32 ticket that it resets to 0,
//     merges the live splits in split order: two calls on the same inputs
//     give bitwise-equal outputs, no float atomics, and no second launch
//     (one device launch per call).
//
// What still limits it: at the main path's shape it reaches ~74 % of the
// bytes bound, the rest being the ramp and tail of a ~57 us launch; a
// group of 4 or 8 rows is bound by each warp's serial step (shuffle
// reductions and exp2 per row), not by bytes: the group's products belong
// on tensor cores.
//
// Arithmetic as the Pallas `_decode_kernel`: f32 scores, masked positions
// never read, online softmax with an f32 max, sum and accumulator, one
// rounding to the input dtype at the end, and the l == 0 guard.  A length
// past the table attends the whole table.
//
// K5 is bound by operations at long tails: 4 * H * D * sum_q(keys attended)
// flops.  One block per (query tile, head) walks the key tiles up to the
// tile's causal horizon start + last_row; the Pallas kernel instead holds
// all S queries in VMEM, which S = 4096 would not fit in shared memory.
// bf16 and f16 run on tensor cores through `tc::attend_tile<T, D>`
// (attention_wgmma.cuh), the loop K1 runs: 64 queries per warpgroup, wgmma
// for both products, K/V rows fetched by cp.async through the block table
// (a 64-key tile spans four 16-row pool blocks).  It rounds p to the input
// dtype before P V, where the Pallas kernel keeps p in f32: one 16-bit
// rounding of p apart (the plain version rounds it too).  f32 keeps the
// CUDA-core loop `attend_tile` (attention_common.cuh), 16 queries a block.
//
// Every dtype rounds its output once, to nearest (`from_f32<T>`); in f16 a
// value past 65504 becomes inf, never clamped.
#include "attention_wgmma.cuh"

namespace pt {

constexpr int kMaxGroup = 8;        // query heads per kv head a block holds
constexpr int kMaxSplitKeys = 512;  // positions one decode block may walk

// 16 bytes of a K/V/q row as f32, widened by the row's element type T
// (never by the element count: bf16 and f16 both take 8 to the 16 bytes):
// 4 floats; 8 bf16, each a 16-bit shift, the low half first; or 8 f16,
// two at a time by __half22float2, the low half first.
template <typename T>
__device__ __forceinline__ void unpack16(const uint4& u,
                                         float (&f)[16 / sizeof(T)]);
template <>
__device__ __forceinline__ void unpack16<float>(const uint4& u,
                                                float (&f)[4]) {
  f[0] = __uint_as_float(u.x);
  f[1] = __uint_as_float(u.y);
  f[2] = __uint_as_float(u.z);
  f[3] = __uint_as_float(u.w);
}
template <>
__device__ __forceinline__ void unpack16<__nv_bfloat16>(const uint4& u,
                                                        float (&f)[8]) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}
template <>
__device__ __forceinline__ void unpack16<__half>(const uint4& u,
                                                 float (&f)[8]) {
  const __half2* h = reinterpret_cast<const __half2*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 x = __half22float2(h[i]);
    f[2 * i] = x.x;
    f[2 * i + 1] = x.y;
  }
}

template <typename T, int D, int kGroup>
struct DecodeShape {
  static constexpr int kVec = 16 / sizeof(T);            // elements per load
  static constexpr int kLanesPerKey = D / kVec;          // lanes of one row
  static constexpr int kKeysPerLoad = 32 / kLanesPerKey;
  // query rows one warp holds (q and acc take kRows * kVec registers
  // each): a group of 8 is split over a team of two warps that walk the
  // same keys, the second one's loads mostly hitting L1 or L2
  static constexpr int kRows = kGroup > 4 ? 4 : kGroup;
  static constexpr int kTeam = kGroup / kRows;
  static constexpr int kTeams = kWarps / kTeam;
  // loads of K (and of V) per lane per step; a small group also has the
  // next step's loads in flight while it uses this step's
  static constexpr int kLoads = 4;
  static constexpr bool kPrefetch = kRows * kVec <= 16;
  static constexpr int kKeysPerStep = kKeysPerLoad * kLoads;
  static_assert(kLanesPerKey <= 32 && 32 % kLanesPerKey == 0, "row split");
};

template <typename T, int D, int kGroup>
__global__ void __launch_bounds__(kThreads) paged_decode_kernel(
    const T* __restrict__ q, const T* __restrict__ k_pool,
    const T* __restrict__ v_pool, const int* __restrict__ tables,
    const int* __restrict__ lengths, T* __restrict__ out,
    float* __restrict__ part_acc, float* __restrict__ part_ml,
    int* __restrict__ tickets, int H, int Hkv, int block_size,
    int max_blocks, int split_keys, int n_splits, long long q_sb,
    long long q_sh, long long o_sb, long long o_sh, long long t_sb,
    long long p_sb, long long p_st, long long p_sh, float scale_log2) {
  using S = DecodeShape<T, D, kGroup>;
  constexpr int kVec = S::kVec, kLanesPerKey = S::kLanesPerKey;
  constexpr int kKeysPerLoad = S::kKeysPerLoad, kLoads = S::kLoads;
  constexpr int kRows = S::kRows, kTeam = S::kTeam;
  constexpr int kStride = S::kTeams * S::kKeysPerStep;  // a block's step
  __shared__ long long off_s[kMaxSplitKeys];
  __shared__ float acc_s[kWarps][kRows][D];
  __shared__ float m_s[kWarps][kRows];
  __shared__ float l_s[kWarps][kRows];
  __shared__ int last_s;

  const int hkv = blockIdx.y, b = blockIdx.z;
  const int G = H / Hkv;
  // the window is 0..lengths[b] inclusive (the current token was written
  // before the call); a length past the table attends the whole table
  const int n_keys = max(0, min(lengths[b] + 1, max_blocks * block_size));
  const int n_live = max(1, (n_keys + split_keys - 1) / split_keys);
  if (blockIdx.x >= n_live) return;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int sub = lane % kLanesPerKey, kslot = lane / kLanesPerKey;
  // warp: rows g0.. of the group, on the steps of its team
  const int g0 = (warp % kTeam) * kRows, team = warp / kTeam;
  const int* row = tables + b * t_sb;
  const long long head_off = (long long)hkv * p_sh;
  const long long bh0 = (long long)b * H + (long long)hkv * G;
  int* ticket = tickets + (long long)b * Hkv + hkv;

  // this lane's kVec dims of the warp's query rows, pre-scaled
  float qf[kRows][kVec];
#pragma unroll
  for (int g = 0; g < kRows; ++g) {
    uint4 u = make_uint4(0, 0, 0, 0);
    if (g0 + g < G)
      u = __ldg(reinterpret_cast<const uint4*>(
          q + b * q_sb + (long long)(hkv * G + g0 + g) * q_sh + sub * kVec));
    unpack16<T>(u, qf[g]);
#pragma unroll
    for (int i = 0; i < kVec; ++i) qf[g][i] *= scale_log2;
  }

  // The block walks splits blockIdx.x, blockIdx.x + gridDim.x, ...: the
  // wrapper caps the grid's x extent from the shapes, so a short window
  // leaves few idle blocks and a long one still spreads over gridDim.x.
  for (int split = blockIdx.x; split < n_live; split += gridDim.x) {
    const int s0 = split * split_keys;
    const int s1 = min(s0 + split_keys, n_keys);
    __syncthreads();  // the last split's readers of off_s and acc_s are done
    for (int i = tid; i < s1 - s0; i += kThreads) {
      const int pos = s0 + i;
      off_s[i] = (long long)row[pos / block_size] * p_sb +
                 (long long)(pos % block_size) * p_st + head_off;
    }
    __syncthreads();

    // team t takes steps t, t + kTeams, ... of kKeysPerStep keys; lane
    // (kslot, sub) holds dims sub * kVec.. of key kslot of each load.
    auto load_step = [&](int t0, uint4(&kr)[kLoads], uint4(&vr)[kLoads]) {
#pragma unroll
      for (int u = 0; u < kLoads; ++u) {
        const int pos = t0 + u * kKeysPerLoad + kslot;
        kr[u] = vr[u] = make_uint4(0, 0, 0, 0);
        if (pos < s1) {  // dead positions are never read
          const long long off = off_s[pos - s0] + sub * kVec;
          kr[u] = __ldg(reinterpret_cast<const uint4*>(k_pool + off));
          vr[u] = __ldg(reinterpret_cast<const uint4*>(v_pool + off));
        }
      }
    };
    float m[kRows], l[kRows], acc[kRows][kVec];
#pragma unroll
    for (int g = 0; g < kRows; ++g) {
      m[g] = kNegInf;
      l[g] = 0.f;
#pragma unroll
      for (int i = 0; i < kVec; ++i) acc[g][i] = 0.f;
    }
    uint4 kr[kLoads], vr[kLoads];
    if constexpr (S::kPrefetch) load_step(s0 + team * S::kKeysPerStep, kr, vr);
    for (int t0 = s0 + team * S::kKeysPerStep; t0 < s1; t0 += kStride) {
      uint4 kn[kLoads], vn[kLoads];
      if constexpr (S::kPrefetch)
        load_step(t0 + kStride, kn, vn);
      else
        load_step(t0, kr, vr);
      float s[kLoads][kRows];  // scores (log2 units), then probabilities
#pragma unroll
      for (int u = 0; u < kLoads; ++u) {
        float kf[kVec];
        unpack16<T>(kr[u], kf);
        const bool live = t0 + u * kKeysPerLoad + kslot < s1;
#pragma unroll
        for (int g = 0; g < kRows; ++g) {
          float d = 0.f;
#pragma unroll
          for (int i = 0; i < kVec; ++i) d = fmaf(qf[g][i], kf[i], d);
#pragma unroll
          for (int o = 1; o < kLanesPerKey; o <<= 1)
            d += __shfl_xor_sync(0xffffffffu, d, o);
          s[u][g] = live ? d : kNegInf;
        }
      }
      // online softmax; the step's first key (u 0, kslot 0) is live, so
      // the new max is finite and masked keys get p = 0
#pragma unroll
      for (int g = 0; g < kRows; ++g) {
        float mt = s[0][g];
#pragma unroll
        for (int u = 1; u < kLoads; ++u) mt = fmaxf(mt, s[u][g]);
#pragma unroll
        for (int o = kLanesPerKey; o < 32; o <<= 1)
          mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, o));
        const float m_new = fmaxf(m[g], mt);
        const float corr = exp2f(m[g] - m_new);
        m[g] = m_new;
        l[g] *= corr;
#pragma unroll
        for (int i = 0; i < kVec; ++i) acc[g][i] *= corr;
#pragma unroll
        for (int u = 0; u < kLoads; ++u) {
          s[u][g] = exp2f(s[u][g] - m_new);
          l[g] += s[u][g];  // this lane's key: summed over kslots below
        }
      }
#pragma unroll
      for (int u = 0; u < kLoads; ++u) {
        float vf[kVec];
        unpack16<T>(vr[u], vf);
#pragma unroll
        for (int g = 0; g < kRows; ++g)
#pragma unroll
          for (int i = 0; i < kVec; ++i)
            acc[g][i] = fmaf(s[u][g], vf[i], acc[g][i]);
        if constexpr (S::kPrefetch) {
          kr[u] = kn[u];
          vr[u] = vn[u];
        }
      }
    }

    // the warp's keys: sum l and acc over the key slots (m is
    // warp-uniform)
#pragma unroll
    for (int g = 0; g < kRows; ++g) {
#pragma unroll
      for (int o = kLanesPerKey; o < 32; o <<= 1) {
        l[g] += __shfl_xor_sync(0xffffffffu, l[g], o);
#pragma unroll
        for (int i = 0; i < kVec; ++i)
          acc[g][i] += __shfl_xor_sync(0xffffffffu, acc[g][i], o);
      }
      if (lane == 0) {
        m_s[warp][g] = m[g];
        l_s[warp][g] = l[g];
      }
      if (kslot == 0) {
#pragma unroll
        for (int i = 0; i < kVec; ++i)
          acc_s[warp][g][sub * kVec + i] = acc[g][i];
      }
    }
    __syncthreads();

    // merge the teams' warps that hold row g (warps g / kRows + kTeam *
    // t); a warp with no keys has m -1e30 and l, acc 0
    for (int e = tid; e < G * D; e += kThreads) {
      const int g = e / D, d = e % D;
      const int w0 = g / kRows, j = g % kRows;
      float mx = m_s[w0][j];
#pragma unroll
      for (int w = w0 + kTeam; w < kWarps; w += kTeam)
        mx = fmaxf(mx, m_s[w][j]);
      float a = 0.f, lt = 0.f;
#pragma unroll
      for (int w = w0; w < kWarps; w += kTeam) {
        const float wt = exp2f(m_s[w][j] - mx);
        a = fmaf(wt, acc_s[w][j][d], a);
        lt = fmaf(wt, l_s[w][j], lt);
      }
      if (n_live == 1) {
        out[b * o_sb + (long long)(hkv * G + g) * o_sh + d] =
            from_f32<T>(a / (lt == 0.f ? 1.f : lt));
      } else {
        const long long r = (bh0 + g) * n_splits + split;
        part_acc[r * D + d] = a;
        if (d == 0) reinterpret_cast<float2*>(part_ml)[r] = make_float2(mx, lt);
      }
    }
    if (n_live == 1) return;

    // the last live split of this (slot, kv head) to arrive merges them
    // all; a block that is last has no split left (its later splits would
    // not have arrived yet)
    __threadfence();
    __syncthreads();
    if (tid == 0) last_s = atomicAdd(ticket, 1) == n_live - 1;
    __syncthreads();
    if (!last_s) continue;
    __threadfence();
    // one pass over the splits in split order, an online softmax merge;
    // each thread's elements are unrolled so that their loads overlap
    constexpr int kElems = (kGroup * D + kThreads - 1) / kThreads;
    const float2* ml = reinterpret_cast<const float2*>(part_ml);
    float mx[kElems], a[kElems], lt[kElems];
#pragma unroll
    for (int i = 0; i < kElems; ++i) {
      mx[i] = kNegInf;
      a[i] = lt[i] = 0.f;
    }
#pragma unroll 2
    for (int sp = 0; sp < n_live; ++sp) {
#pragma unroll
      for (int i = 0; i < kElems; ++i) {
        const int e = tid + i * kThreads;
        if (e < G * D) {
          const long long r = (bh0 + e / D) * n_splits + sp;
          const float2 v = __ldcg(ml + r);
          const float x = __ldcg(part_acc + r * D + e % D);
          const float m_new = fmaxf(mx[i], v.x);
          const float corr = exp2f(mx[i] - m_new), wt = exp2f(v.x - m_new);
          a[i] = fmaf(a[i], corr, wt * x);
          lt[i] = fmaf(lt[i], corr, wt * v.y);
          mx[i] = m_new;
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kElems; ++i) {
      const int e = tid + i * kThreads;
      if (e < G * D)
        out[b * o_sb + (long long)(hkv * G + e / D) * o_sh + e % D] =
            from_f32<T>(a[i] / (lt[i] == 0.f ? 1.f : lt[i]));
    }
    if (tid == 0) *ticket = 0;
    return;
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
    const T* __restrict__ v_pool, const int* __restrict__ row,
    const int* __restrict__ start_at, T* __restrict__ out, int S, int H,
    int Hkv, int block_size, int max_blocks, long long q_ss, long long q_sh,
    long long o_ss, long long o_sh, long long p_sb, long long p_st,
    long long p_sh, float scale) {
  constexpr int kTile = tc::kQueryTile<T>;
  // the cached prefix length lives in device memory, so that one CUDA graph
  // of a bucket's prefill serves every prefix; the grid depends on S alone.
  // A negative start counts as 0, as in the plain block_prefill_attention.
  const int start = max(0, __ldg(start_at));
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
    tc::attend_tile<T, D>(dyn_smem, q_rows, q_ss, n_rows, start + q0,
                          horizon, /*causal=*/true, k_pool, v_pool, key_at,
                          scale, o_rows, o_ss, nullptr);
  } else {
    __shared__ TileSmem<D> sm;
    attend_tile<T, D>(sm, q_rows, q_ss, n_rows, start + q0, horizon,
                      /*causal=*/true, k_pool, v_pool, key_at, scale, o_rows,
                      o_ss, nullptr);
  }
}

// The decode launch's arguments after the dtype and head dim: pointers,
// then sizes, then element strides (see pt_paged_decode).
#define PT_DECODE_PARAMS                                                      \
  const void *q, const void *k_pool, const void *v_pool, const void *tables, \
      const void *lengths, void *out, void *part_acc, void *part_ml,         \
      void *tickets, int B, int H, int Hkv, int block_size, int max_blocks,  \
      int split_keys, int n_splits, int grid_splits, long long q_sb,         \
      long long q_sh, long long o_sb, long long o_sh, long long t_sb,        \
      long long p_sb, long long p_st, long long p_sh, float scale_log2,      \
      cudaStream_t stream
#define PT_DECODE_ARGS                                                        \
  q, k_pool, v_pool, tables, lengths, out, part_acc, part_ml, tickets, B, H, \
      Hkv, block_size, max_blocks, split_keys, n_splits, grid_splits, q_sb,  \
      q_sh, o_sb, o_sh, t_sb, p_sb, p_st, p_sh, scale_log2, stream

template <typename T, int D, int kGroup>
int launch_decode_group(PT_DECODE_PARAMS) {
  paged_decode_kernel<T, D, kGroup>
      <<<dim3(grid_splits, Hkv, B), kThreads, 0, stream>>>(
          static_cast<const T*>(q), static_cast<const T*>(k_pool),
          static_cast<const T*>(v_pool), static_cast<const int*>(tables),
          static_cast<const int*>(lengths), static_cast<T*>(out),
          static_cast<float*>(part_acc), static_cast<float*>(part_ml),
          static_cast<int*>(tickets), H, Hkv, block_size, max_blocks,
          split_keys, n_splits, q_sb, q_sh, o_sb, o_sh, t_sb, p_sb, p_st,
          p_sh, scale_log2);
  return static_cast<int>(cudaGetLastError());
}

// the group size's template bucket: 1, 2, 4 or 8 query rows
template <typename T, int D>
int launch_decode(int group, PT_DECODE_PARAMS) {
  if (group == 1) return launch_decode_group<T, D, 1>(PT_DECODE_ARGS);
  if (group == 2) return launch_decode_group<T, D, 2>(PT_DECODE_ARGS);
  if (group <= 4) return launch_decode_group<T, D, 4>(PT_DECODE_ARGS);
  return launch_decode_group<T, D, 8>(PT_DECODE_ARGS);
}

template <typename T, int D>
int launch_prefill(const void* q, const void* k_pool, const void* v_pool,
                   const void* row, const void* start, void* out, int S,
                   int H, int Hkv, int block_size, int max_blocks,
                   long long q_ss, long long q_sh, long long o_ss,
                   long long o_sh, long long p_sb, long long p_st,
                   long long p_sh, float scale, cudaStream_t stream) {
  static SmemOptIn opt_in;
  const int smem =
      tc::dynamic_smem<T, D>(paged_prefill_kernel<T, D>, opt_in);
  if (smem < 0) return -smem;
  const dim3 grid((S + tc::kQueryTile<T> - 1) / tc::kQueryTile<T>, H);
  paged_prefill_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pool),
      static_cast<const T*>(v_pool), static_cast<const int*>(row),
      static_cast<const int*>(start), static_cast<T*>(out), S, H, Hkv,
      block_size, max_blocks, q_ss, q_sh,
      o_ss, o_sh, p_sb, p_st, p_sh, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace pt

// dtype: 0 = float32, 1 = bfloat16, 2 = float16.  Returns the cudaError_t
// of the launch, or -1 for a (dtype, head_dim) pair that has no instance.
#define PT_DISPATCH(FN, ...)                                              \
  if (dtype == 0 && head_dim == 64) return FN<float, 64>(__VA_ARGS__);    \
  if (dtype == 0 && head_dim == 128) return FN<float, 128>(__VA_ARGS__);  \
  if (dtype == 1 && head_dim == 64)                                       \
    return FN<__nv_bfloat16, 64>(__VA_ARGS__);                            \
  if (dtype == 1 && head_dim == 128)                                      \
    return FN<__nv_bfloat16, 128>(__VA_ARGS__);                           \
  if (dtype == 2 && head_dim == 64) return FN<__half, 64>(__VA_ARGS__);   \
  if (dtype == 2 && head_dim == 128) return FN<__half, 128>(__VA_ARGS__); \
  return -1;

extern "C" {

// part_acc: f32 [B, H, n_splits, D]; part_ml: f32 [B, H, n_splits, 2]
// (m, l); tickets: int32 [B * Hkv], all 0 before the call and after it.
// The three are read only when a window spans more than one split.  The
// grid is (grid_splits, Hkv, B), each block walking splits grid_splits
// apart.
int pt_paged_decode(int dtype, int head_dim, PT_DECODE_PARAMS) {
  if (H % Hkv != 0 || H / Hkv > pt::kMaxGroup) return -1;
  if (split_keys < 1 || split_keys > pt::kMaxSplitKeys ||
      (long long)n_splits * split_keys < (long long)max_blocks * block_size ||
      grid_splits < 1 || grid_splits > n_splits)
    return -1;
  PT_DISPATCH(pt::launch_decode, H / Hkv, PT_DECODE_ARGS)
}

// start: int32 [1] in device memory, the absolute position of the first
// tail query (the cached prefix length); read by the kernel at entry.
int pt_paged_prefill(int dtype, int head_dim, const void* q,
                     const void* k_pool, const void* v_pool, const void* row,
                     const void* start, void* out, int S, int H, int Hkv,
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
