// Flash attention, forward and backward, for Hopper (sm_90a).
//
// Replaces the TPU kernels of horovod_tpu/ops/pallas/flash_attention.py:
//
//   _fa_kernel          (forward, via _fa_forward)   -> fa_fwd_kernel
//   _fa_bwd_dq_kernel   (dQ pass, via _fa_backward)  -> fa_bwd_dq_kernel
//   _fa_bwd_dkv_kernel  (dK/dV pass, via _fa_backward) -> fa_bwd_dkv_kernel
//
// Contract (the Pallas kernels' and the plain versions' in flash_attention.py):
// q (BH, Lq, D); k, v (BHkv, Lk, D); end-aligned causal (query row i sees keys
// <= i + q_offset); keys at or past kv_valid are masked; masked scores are
// -1e30 and p is zeroed where s <= -1e30 / 2, so a fully masked row gives a
// zero output and zero gradients; lse = m + log(max(l, 1e-30)) is fp32; the
// outputs are in the inputs' type. Inputs are read into fp32 and all
// arithmetic (scores, running max and sum, accumulators) is fp32, as in the
// Pallas kernels. The forward reads grouped K/V through the row map
// (b / heads) * kv_heads + (b % heads) / (heads / kv_heads), with no
// broadcast; the backward takes MHA shapes (the wrapper broadcasts K/V).
//
// Design. On the TPU the grid runs in order, and each kernel carries its
// running state (m, l, acc; dq; dk, dv) in VMEM scratch across the innermost
// chunk axis. Hopper's blocks run in any order, so here each block owns one
// output tile and a loop inside the block replaces that axis:
//
//   forward, dQ: a block per (row b, 64-query tile), looping over key tiles;
//   dK/dV:       a block per (row b, 64-key tile), looping over query tiles.
//
// Every output is written by exactly one block, so no atomics are needed.
// Tiles are 64 x 64 in fp32 shared memory (rows padded by one float, which
// keeps the column walks free of bank conflicts); 256 threads as 16 x 16,
// each holding a 4 x 4 block of the score tile and 4 rows x D/16 columns of
// its accumulators in registers; row reductions are shuffles within a
// half-warp. Tiles past the causal diagonal or past kv_valid are skipped (the
// clipped trip counts of the Pallas kernels), and the ragged last tile of any
// length is masked here, so no padded copy is made. Causal forward and dQ
// launch their heaviest query tiles first.
//
// Bound on this card. At the GPT-2-small shapes (BH = 96, L = 1024, D = 64,
// bf16, causal) the three kernels sit near the ~295 flop/byte balance point
// of bf16 tensor cores (989 TFLOP/s) and HBM (3.35 TB/s): the forward does
// 4 * D * L(L+1)/2 * BH = 12.9 GFLOP on 50 MB (13 us of operations, 15 us of
// bytes), dQ 19.3 GFLOP on 64 MB, dK/dV 25.8 GFLOP on 76 MB (operations).
// What bounds these kernels is their own arithmetic: the products run on
// the CUDA cores in fp32 (67 TFLOP/s at most), not on the tensor cores.
// What the simple design leaves for later: mma/wgmma with bf16 operands,
// tiles loaded by TMA or cp.async into a double-buffered ring instead of by
// the threads that compute on them, and a larger register micro-tile (each
// 4 x 4 one reads two shared-memory words per two FMAs).
//
// Plain C interface, loaded with ctypes; each entry point returns
// cudaGetLastError() after its launch (or the error of its setup).

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "cvt.cuh"

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kTile = 64;       // query rows and key rows of a tile
constexpr int kThreads = 256;   // 16 x 16
constexpr int kSS = kTile + 1;  // padded row stride of the score tiles (floats)

__device__ __forceinline__ float max16(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o, 16));
  return x;
}

__device__ __forceinline__ float sum16(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o, 16);
  return x;
}

// Rows [r0, r0 + kTile) of a (n, D) matrix into shared memory as fp32 times
// scale, row stride D + 1; rows at or past n are zero.
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* __restrict__ src, int r0, int n,
                                          float scale) {
  for (int i = threadIdx.x; i < kTile * D; i += kThreads) {
    const int r = i / D, c = i % D;
    dst[r * (D + 1) + c] =
        r0 + r < n ? Cvt<T>::to_f32(src[static_cast<int64_t>(r0 + r) * D + c]) * scale : 0.f;
  }
}

// Elements [r0, r0 + kTile) of a length-n fp32 vector; zero past n.
__device__ __forceinline__ void load_vec(float* dst, const float* __restrict__ src, int r0,
                                         int n) {
  for (int i = threadIdx.x; i < kTile; i += kThreads) dst[i] = r0 + i < n ? src[r0 + i] : 0.f;
}

// acc[i][j] += a[ty + 16 i, :] . b[tx + 16 j, :] over D, both with row stride D + 1.
template <int D>
__device__ __forceinline__ void dot_tile(float (&acc)[4][4], const float* a, const float* b,
                                         int tx, int ty) {
#pragma unroll 8
  for (int d = 0; d < D; ++d) {
    float x[4], y[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) x[i] = a[(ty + 16 * i) * (D + 1) + d];
#pragma unroll
    for (int j = 0; j < 4; ++j) y[j] = b[(tx + 16 * j) * (D + 1) + d];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(x[i], y[j], acc[i][j]);
  }
}

// acc[i][c] += sum_t p(ty + 16 i, t) * m[t, tx + 16 c], where p(r, t) is the
// score tile's entry [r, t], or [t, r] when kTrans; m has row stride D + 1.
template <int D, bool kTrans>
__device__ __forceinline__ void acc_tile(float (&acc)[4][D / 16], const float* p, const float* m,
                                         int tx, int ty) {
#pragma unroll 4
  for (int t = 0; t < kTile; ++t) {
    float x[4], y[D / 16];
#pragma unroll
    for (int i = 0; i < 4; ++i) x[i] = kTrans ? p[t * kSS + ty + 16 * i] : p[(ty + 16 * i) * kSS + t];
#pragma unroll
    for (int c = 0; c < D / 16; ++c) y[c] = m[t * (D + 1) + tx + 16 * c];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < D / 16; ++c) acc[i][c] = fmaf(x[i], y[c], acc[i][c]);
  }
}

// One past the last key a query tile starting at q0 can see.
__device__ __forceinline__ int key_stop(int q0, int lq, int lk, int q_offset, int kv_valid,
                                        int causal) {
  int stop = min(lk, kv_valid);
  if (causal) stop = min(stop, q_offset + min(q0 + kTile, lq));
  return stop;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
fa_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
              T* __restrict__ o, float* __restrict__ lse, int lq, int lk, int q_offset,
              int kv_valid, int causal, float sm_scale, int heads, int kv_heads) {
  constexpr int S = D + 1, C = D / 16;
  extern __shared__ float smem[];
  float* q_s = smem;
  float* k_s = q_s + kTile * S;
  float* v_s = k_s + kTile * S;
  float* p_s = v_s + kTile * S;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kTile;
  const int64_t kvh = static_cast<int64_t>(bh / heads) * kv_heads + (bh % heads) / (heads / kv_heads);
  const T* kb = k + kvh * lk * D;
  const T* vb = v + kvh * lk * D;
  const int kv_end = min(lk, kv_valid);
  const int stop = key_stop(q0, lq, lk, q_offset, kv_valid, causal);
  const int n_kt = stop > 0 ? (stop + kTile - 1) / kTile : 0;

  load_tile<T, D>(q_s, q + static_cast<int64_t>(bh) * lq * D, q0, lq, sm_scale);
  float m[4], l[4], acc[4][C];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < C; ++c) acc[i][c] = 0.f;
  }
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();  // the previous tile's k_s, v_s and p_s are consumed
    load_tile<T, D>(k_s, kb, k0, lk, 1.f);
    load_tile<T, D>(v_s, vb, k0, lk, 1.f);
    __syncthreads();
    float s[4][4] = {};
    dot_tile<D>(s, q_s, k_s, tx, ty);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qk = q0 + ty + 16 * i + q_offset;  // this row's last visible key
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kp = k0 + tx + 16 * j;
        if (kp >= kv_end || (causal && qk < kp)) s[i][j] = kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], max16(mx));
      const float corr = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = s[i][j] > 0.5f * kNegInf ? expf(s[i][j] - m_new) : 0.f;
        p_s[(ty + 16 * i) * kSS + tx + 16 * j] = p;
        rs += p;
      }
      l[i] = l[i] * corr + sum16(rs);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < C; ++c) acc[i][c] *= corr;
    }
    __syncthreads();
    acc_tile<D, false>(acc, p_s, v_s, tx, ty);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty + 16 * i;
    if (r < lq) {
      const float ls = fmaxf(l[i], 1e-30f);
      T* orow = o + (static_cast<int64_t>(bh) * lq + r) * D;
#pragma unroll
      for (int c = 0; c < C; ++c) orow[tx + 16 * c] = Cvt<T>::from_f32(acc[i][c] / ls);
      if (tx == 0) lse[static_cast<int64_t>(bh) * lq + r] = m[i] + logf(ls);
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
fa_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 const T* __restrict__ dout, const float* __restrict__ lse,
                 const float* __restrict__ delta, T* __restrict__ dq, int lq, int lk,
                 int q_offset, int kv_valid, int causal, float sm_scale) {
  constexpr int S = D + 1, C = D / 16;
  extern __shared__ float smem[];
  float* q_s = smem;
  float* do_s = q_s + kTile * S;
  float* k_s = do_s + kTile * S;
  float* v_s = k_s + kTile * S;
  float* ds_s = v_s + kTile * S;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kTile;
  const int64_t qrow = static_cast<int64_t>(bh) * lq;
  const T* kb = k + static_cast<int64_t>(bh) * lk * D;
  const T* vb = v + static_cast<int64_t>(bh) * lk * D;
  const int kv_end = min(lk, kv_valid);
  const int stop = key_stop(q0, lq, lk, q_offset, kv_valid, causal);
  const int n_kt = stop > 0 ? (stop + kTile - 1) / kTile : 0;

  load_tile<T, D>(q_s, q + qrow * D, q0, lq, 1.f);
  load_tile<T, D>(do_s, dout + qrow * D, q0, lq, 1.f);
  float lse_r[4], delta_r[4], acc[4][C];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty + 16 * i;
    lse_r[i] = r < lq ? lse[qrow + r] : 0.f;
    delta_r[i] = r < lq ? delta[qrow + r] : 0.f;
#pragma unroll
    for (int c = 0; c < C; ++c) acc[i][c] = 0.f;
  }
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();
    load_tile<T, D>(k_s, kb, k0, lk, 1.f);
    load_tile<T, D>(v_s, vb, k0, lk, 1.f);
    __syncthreads();
    float s[4][4] = {}, dp[4][4] = {};
    dot_tile<D>(s, q_s, k_s, tx, ty);
    dot_tile<D>(dp, do_s, v_s, tx, ty);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qk = q0 + ty + 16 * i + q_offset;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kp = k0 + tx + 16 * j;
        const bool ok = kp < kv_end && !(causal && qk < kp);
        const float sv = ok ? s[i][j] * sm_scale : kNegInf;
        const float p = sv > 0.5f * kNegInf ? expf(sv - lse_r[i]) : 0.f;
        ds_s[(ty + 16 * i) * kSS + tx + 16 * j] = p * (dp[i][j] - delta_r[i]) * sm_scale;
      }
    }
    __syncthreads();
    acc_tile<D, false>(acc, ds_s, k_s, tx, ty);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty + 16 * i;
    if (r < lq) {
      T* row = dq + (qrow + r) * D;
#pragma unroll
      for (int c = 0; c < C; ++c) row[tx + 16 * c] = Cvt<T>::from_f32(acc[i][c]);
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
fa_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                  const T* __restrict__ dout, const float* __restrict__ lse,
                  const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv,
                  int lq, int lk, int q_offset, int kv_valid, int causal, float sm_scale) {
  constexpr int S = D + 1, C = D / 16;
  extern __shared__ float smem[];
  float* k_s = smem;
  float* v_s = k_s + kTile * S;
  float* q_s = v_s + kTile * S;
  float* do_s = q_s + kTile * S;
  float* p_s = do_s + kTile * S;
  float* ds_s = p_s + kTile * kSS;
  float* lse_s = ds_s + kTile * kSS;
  float* delta_s = lse_s + kTile;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int bh = blockIdx.x;
  const int k0 = blockIdx.y * kTile;  // low key tiles see the most queries: first
  const int64_t qrow = static_cast<int64_t>(bh) * lq;
  const int64_t krow = static_cast<int64_t>(bh) * lk;
  const int kv_end = min(lk, kv_valid);
  float dk_acc[4][C], dv_acc[4][C];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < C; ++c) dk_acc[i][c] = dv_acc[i][c] = 0.f;

  if (k0 < kv_end) {  // a key tile wholly past kv_valid gets zero gradients
    load_tile<T, D>(k_s, k + krow * D, k0, lk, 1.f);
    load_tile<T, D>(v_s, v + krow * D, k0, lk, 1.f);
    int t0 = 0;  // first query tile that sees this key tile
    if (causal && k0 - q_offset > 0) t0 = (k0 - q_offset) / kTile;
    const int n_qt = (lq + kTile - 1) / kTile;
    for (int qt = t0; qt < n_qt; ++qt) {
      const int q0 = qt * kTile;
      __syncthreads();
      load_tile<T, D>(q_s, q + qrow * D, q0, lq, 1.f);
      load_tile<T, D>(do_s, dout + qrow * D, q0, lq, 1.f);
      load_vec(lse_s, lse + qrow, q0, lq);
      load_vec(delta_s, delta + qrow, q0, lq);
      __syncthreads();
      float s[4][4] = {}, dp[4][4] = {};
      dot_tile<D>(s, q_s, k_s, tx, ty);
      dot_tile<D>(dp, do_s, v_s, tx, ty);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = ty + 16 * i;
        const int qp = q0 + r;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int kp = k0 + tx + 16 * j;
          const bool ok = qp < lq && kp < kv_end && !(causal && qp + q_offset < kp);
          const float sv = ok ? s[i][j] * sm_scale : kNegInf;
          const float p = sv > 0.5f * kNegInf ? expf(sv - lse_s[r]) : 0.f;
          p_s[r * kSS + tx + 16 * j] = p;
          ds_s[r * kSS + tx + 16 * j] = p * (dp[i][j] - delta_s[r]) * sm_scale;
        }
      }
      __syncthreads();
      acc_tile<D, true>(dv_acc, p_s, do_s, tx, ty);
      acc_tile<D, true>(dk_acc, ds_s, q_s, tx, ty);
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = k0 + ty + 16 * i;
    if (r < lk) {
      T* krow_k = dk + (krow + r) * D;
      T* krow_v = dv + (krow + r) * D;
#pragma unroll
      for (int c = 0; c < C; ++c) {
        krow_k[tx + 16 * c] = Cvt<T>::from_f32(dk_acc[i][c]);
        krow_v[tx + 16 * c] = Cvt<T>::from_f32(dv_acc[i][c]);
      }
    }
  }
}

template <int D>
constexpr size_t fwd_smem() { return (3 * kTile * (D + 1) + kTile * kSS) * sizeof(float); }
template <int D>
constexpr size_t dq_smem() { return (4 * kTile * (D + 1) + kTile * kSS) * sizeof(float); }
template <int D>
constexpr size_t dkv_smem() {
  return (4 * kTile * (D + 1) + 2 * kTile * kSS + 2 * kTile) * sizeof(float);
}

int tiles(int n) { return (n + kTile - 1) / kTile; }

bool bad_shape(int bh, int lq, int lk) {
  return bh <= 0 || lq <= 0 || lk < 0 || tiles(lq) > 65535 || tiles(lk) > 65535;
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

template <typename T>
struct Type {
  using type = T;
};

// f(Type<T>{}, std::integral_constant<int, D>{}) for the element type code
// (0 = float32, 1 = float16, 2 = bfloat16) and head dim D in {16, 32, 64, 128}.
template <typename T, typename F>
int dispatch_d(int d, F f) {
  switch (d) {
    case 16: return f(Type<T>{}, std::integral_constant<int, 16>{});
    case 32: return f(Type<T>{}, std::integral_constant<int, 32>{});
    case 64: return f(Type<T>{}, std::integral_constant<int, 64>{});
    case 128: return f(Type<T>{}, std::integral_constant<int, 128>{});
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename F>
int dispatch(int dtype, int d, F f) {
  switch (dtype) {
    case 0: return dispatch_d<float>(d, f);
    case 1: return dispatch_d<__half>(d, f);
    case 2: return dispatch_d<__nv_bfloat16>(d, f);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// q (bh, lq, d); k, v (bh / heads * kv_heads, lk, d); o like q; lse (bh, lq) fp32.
int hvd_flash_fwd(const void* q, const void* k, const void* v, void* o, void* lse, int bh,
                  int lq, int lk, int d, int q_offset, int kv_valid, int causal,
                  float sm_scale, int heads, int kv_heads, int dtype, void* stream) {
  if (bad_shape(bh, lq, lk) || heads <= 0 || kv_heads <= 0 || heads % kv_heads ||
      bh % heads) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return dispatch(dtype, d, [&](auto t, auto dd) {
    using T = typename decltype(t)::type;
    constexpr int D = decltype(dd)::value;
    const size_t smem = fwd_smem<D>();
    cudaError_t err = allow_smem(fa_fwd_kernel<T, D>, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    fa_fwd_kernel<T, D><<<dim3(bh, tiles(lq)), kThreads, smem,
                          static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<T*>(o), static_cast<float*>(lse), lq, lk, q_offset, kv_valid, causal,
        sm_scale, heads, kv_heads);
    return static_cast<int>(cudaGetLastError());
  });
}

// q, dout, dq (bh, lq, d); k, v (bh, lk, d); lse, delta (bh, lq) fp32.
int hvd_flash_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                     const void* lse, const void* delta, void* dq, int bh, int lq, int lk,
                     int d, int q_offset, int kv_valid, int causal, float sm_scale, int dtype,
                     void* stream) {
  if (bad_shape(bh, lq, lk)) return static_cast<int>(cudaErrorInvalidValue);
  return dispatch(dtype, d, [&](auto t, auto dd) {
    using T = typename decltype(t)::type;
    constexpr int D = decltype(dd)::value;
    const size_t smem = dq_smem<D>();
    cudaError_t err = allow_smem(fa_bwd_dq_kernel<T, D>, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    fa_bwd_dq_kernel<T, D><<<dim3(bh, tiles(lq)), kThreads, smem,
                             static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<const T*>(dout), static_cast<const float*>(lse),
        static_cast<const float*>(delta), static_cast<T*>(dq), lq, lk, q_offset, kv_valid,
        causal, sm_scale);
    return static_cast<int>(cudaGetLastError());
  });
}

// As hvd_flash_bwd_dq; dk, dv (bh, lk, d). Needs lk >= 1.
int hvd_flash_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                      const void* lse, const void* delta, void* dk, void* dv, int bh, int lq,
                      int lk, int d, int q_offset, int kv_valid, int causal, float sm_scale,
                      int dtype, void* stream) {
  if (bad_shape(bh, lq, lk) || lk == 0) return static_cast<int>(cudaErrorInvalidValue);
  return dispatch(dtype, d, [&](auto t, auto dd) {
    using T = typename decltype(t)::type;
    constexpr int D = decltype(dd)::value;
    const size_t smem = dkv_smem<D>();
    cudaError_t err = allow_smem(fa_bwd_dkv_kernel<T, D>, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    fa_bwd_dkv_kernel<T, D><<<dim3(bh, tiles(lk)), kThreads, smem,
                              static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<const T*>(dout), static_cast<const float*>(lse),
        static_cast<const float*>(delta), static_cast<T*>(dk), static_cast<T*>(dv), lq, lk,
        q_offset, kv_valid, causal, sm_scale);
    return static_cast<int>(cudaGetLastError());
  });
}

}  // extern "C"
