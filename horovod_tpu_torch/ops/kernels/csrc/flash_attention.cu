// Flash attention, forward and backward, for Hopper (sm_90a).
//
// Replaces the TPU kernels of horovod_tpu/ops/pallas/flash_attention.py:
//
//   _fa_kernel          (forward, via _fa_forward)     -> fa_fwd_mma_kernel (bf16, fp16),
//                                                         fa_fwd_kernel (fp32)
//   _fa_bwd_dq_kernel   (dQ pass, via _fa_backward)    -> fa_bwd_dq_mma_kernel (bf16, fp16),
//                                                         fa_bwd_dq_kernel (fp32)
//   _fa_bwd_dkv_kernel  (dK/dV pass, via _fa_backward) -> fa_bwd_dkv_mma_kernel (bf16, fp16),
//                                                         fa_bwd_dkv_kernel (fp32)
//
// Contract (the Pallas kernels' and the plain versions' in flash_attention.py):
// q (BH, Lq, D); k, v (BHkv, Lk, D); end-aligned causal (query row i sees keys
// <= i + q_offset); keys at or past kv_valid are masked; masked scores are
// -1e30 and p is zeroed where s <= -1e30 / 2, so a fully masked row gives a
// zero output and zero gradients; lse = m + log(max(l, 1e-30)) is fp32; the
// outputs are in the inputs' type; head dims 16, 32, 64 and 128. Scores,
// running max and sum and every accumulator are fp32. The forward reads
// grouped K/V through the row map (b / heads) * kv_heads + (b % heads) /
// (heads / kv_heads), with no broadcast; the backward takes MHA shapes (the
// wrapper broadcasts K/V).
//
// Grid. On the TPU the grid runs in order, and each kernel carries its
// running state (m, l, acc; dq; dk, dv) in VMEM scratch across the innermost
// chunk axis. Hopper's blocks run in any order, so here each block owns one
// output tile and a loop inside the block replaces that axis:
//
//   forward, dQ: a block per (row b, 64-query tile), looping over key tiles;
//   dK/dV:       a block per (row b, 64-key tile), looping over query tiles.
//
// Every output is written by exactly one block: no atomics, and reruns are
// bit-identical. Tiles past the causal diagonal or past kv_valid are skipped
// (the clipped trip counts of the Pallas kernels); only the diagonal tiles
// and the ragged ones are masked, and the ragged last tile of any length is
// masked here, so no padded copy is made. The heaviest tiles launch first.
//
// bf16 and fp16: the tensor-core kernels. At GPT-2 small's shape (BH = 96,
// L = 1024, D = 64, causal) the forward does 4 * D * L(L+1)/2 * BH = 12.9
// GFLOP on 50 MB, dQ 19.3 GFLOP on 64 MB and dK/dV 25.8 GFLOP on 76 MB: near
// the ~295 flop/byte balance point of the bf16 tensor cores (989 TFLOP/s)
// and HBM (3.35 TB/s), the forward bound by bytes (15 us against 13 us of
// operations), dQ and dK/dV by operations (20 and 26 us). The SIMT kernels
// they replace ran their products on the CUDA cores in fp32 (67 TFLOP/s at
// most), so what bounded them was their own arithmetic. The design:
//
//   - Products are mma.sync.m16n8k16 with bf16/fp16 operands and fp32
//     accumulators, fed by ldmatrix from shared memory (ldmatrix.trans where
//     an operand is read along its other axis: V in P.V, K in dQ = dS K, Q
//     and dO in dK = dS^T Q and dV = P^T dO). The fp32 accumulator fragment
//     of a score tile is rounded in registers into the A fragment of the
//     next product, so P and dS never go through shared memory. This is
//     where these kernels round P and dS to the input type, as
//     FlashAttention does; the plain versions do so too when asked
//     (round_p).
//   - 4 warps, 16 rows each. Forward: 16 query rows a warp, 64-key tiles;
//     row max and sum are quad shuffles over the accumulator layout;
//     sm_scale * log2(e) is one multiply and the exponent is exp2f. dK/dV:
//     16 key rows a warp; it computes S^T = K Q^T and dP^T = V dO^T, so key
//     rows are the accumulator rows, and reads lse and delta per column
//     from shared memory; 64-query tiles (32 at D = 128, for registers).
//     dQ: the forward's walk, 16 query rows a warp over 64-key tiles (32 at
//     D = 128), S = Q K^T and dP = dO V^T, lse and delta per accumulator
//     row in registers; Q and dO are loaded once and their A fragments kept
//     in registers (read again per tile at D = 128, for registers); K is
//     loaded once per tile and read both ways (ldmatrix for S, .trans for
//     dS K).
//   - K/V tiles (forward, dQ) and Q/dO/lse/delta tiles (dK/dV) go through
//     cp.async into a two-stage ring: tile t + 1 is in flight while tile t
//     computes. Rows past the end are zero-filled (src-size 0). Tiles stay
//     in the input type, rows padded by 16 bytes, so ldmatrix's eight
//     16-byte rows fall in distinct banks at every head dim.
//
// What bounds them next: every warp reads all of a K/V (or Q/dO) tile from
// shared memory per tile, and at D = 64 one exp2 per visible pair on the SFU
// (16 a clock per SM) takes about as long as the tensor-core bound of the
// products. wgmma with TMA loads and warp-specialised ping-pong that hides
// the exp2 behind the other warpgroup's products are what is left.
//
// fp32: the SIMT kernels, unchanged: inputs read into padded fp32 shared
// tiles, 256 threads as 16 x 16, each a 4 x 4 block of the score tile and 4
// rows x D/16 columns of its accumulators, half-warp shuffles for the row
// reductions. TF32 would change the numbers fp32 callers are held to.
//
// Plain C interface, loaded with ctypes; each entry point returns
// cudaGetLastError() after its launch (or the error of its setup).

#include <cuda_runtime.h>
#include <stdint.h>

#include <tuple>
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

// ---------------------------------------------------------------------------
// Tensor-core kernels (bf16, fp16)
// ---------------------------------------------------------------------------

constexpr int kMmaThreads = 128;  // 4 warps of 16 rows
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory, bypassing L1; zero-filled when !ok.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(ok ? 16 : 0));
}

// 4 bytes (an fp32 lse or delta: rows of any length are only 4-byte aligned).
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(ok ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Four 8 x 8 b16 matrices; lane i gives the address of row i % 8 of matrix i / 8.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// c (16 x 8, fp32) += a (16 x 16) * b (16 x 8), in the m16n8k16 fragment layouts:
// lane l holds c rows l / 4 and l / 4 + 8, columns 2 (l % 4) and 2 (l % 4) + 1.
template <typename T>
struct Mma;

template <>
struct Mma<__nv_bfloat16> {
  __device__ static void run(float (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
    asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
        "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
  // Two fp32 values rounded (to nearest) into one register, lo in the low half.
  __device__ static uint32_t pack(float lo, float hi) {
    __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&h);
  }
};

template <>
struct Mma<__half> {
  __device__ static void run(float (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
    asm("mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 {%0, %1, %2, %3}, "
        "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
  __device__ static uint32_t pack(float lo, float hi) {
    __half2 h = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&h);
  }
};

// Shared-memory row stride of a D-wide tile, in elements: 16 bytes of pad.
template <int D>
__host__ __device__ constexpr int row_stride() { return D + 8; }

// Rows [r0, r0 + R) of a (n, D) matrix into a shared tile (row stride D + 8)
// by 16-byte cp.async; rows at or past n are zero-filled. Needs r0 < n.
template <typename T, int R, int D>
__device__ __forceinline__ void load_tile_async(T* dst, const T* __restrict__ src, int r0,
                                                int n) {
  constexpr int kChunks = D * static_cast<int>(sizeof(T)) / 16;  // per row
  static_assert(R * kChunks % kMmaThreads == 0, "tile does not split over the threads");
#pragma unroll
  for (int i = 0; i < R * kChunks / kMmaThreads; ++i) {
    const int idx = threadIdx.x + i * kMmaThreads;
    const int r = idx / kChunks, c = (idx % kChunks) * (16 / static_cast<int>(sizeof(T)));
    const bool ok = r0 + r < n;
    cp_async16(smem_u32(dst + r * row_stride<D>() + c),
               src + static_cast<int64_t>(ok ? r0 + r : r0) * D + c, ok);
  }
}

// The A fragments (16 rows x 16 columns at col0) of a row-major shared tile.
template <int D, typename T>
__device__ __forceinline__ void ldsm_a(uint32_t (&a)[4], const T* tile, int row0, int col0) {
  const int lane = threadIdx.x & 31;
  ldsm_x4(a, smem_u32(tile + (row0 + (lane & 7) + ((lane >> 3) & 1) * 8) * row_stride<D>() +
                      col0 + (lane >> 4) * 8));
}

// B fragments of two n8 tiles (n0 .. n0 + 15) over k0 .. k0 + 15, from a
// shared tile stored n-major (row n holds B[k][n] along k): b[0], b[1] for
// columns n0 .. n0 + 7, b[2], b[3] for n0 + 8 .. n0 + 15.
template <int D, typename T>
__device__ __forceinline__ void ldsm_b(uint32_t (&b)[4], const T* tile, int n0, int k0) {
  const int lane = threadIdx.x & 31;
  ldsm_x4(b, smem_u32(tile + (n0 + (lane & 7) + (lane >> 4) * 8) * row_stride<D>() + k0 +
                      ((lane >> 3) & 1) * 8));
}

// The same fragments from a shared tile stored k-major (row k holds B[k][n]
// along n): ldmatrix.trans.
template <int D, typename T>
__device__ __forceinline__ void ldsm_b_trans(uint32_t (&b)[4], const T* tile, int k0, int n0) {
  const int lane = threadIdx.x & 31;
  ldsm_x4_trans(b, smem_u32(tile + (k0 + (lane & 7) + ((lane >> 3) & 1) * 8) * row_stride<D>() +
                            n0 + (lane >> 4) * 8));
}

// Quad reductions: the four lanes that hold one accumulator row.
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

constexpr int kFwdBq = 64;  // query rows of a forward block (4 warps x 16)
constexpr int kFwdBk = 64;  // keys of a forward tile

template <typename T, int D>
__global__ void __launch_bounds__(kMmaThreads)
fa_fwd_mma_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                  T* __restrict__ o, float* __restrict__ lse, int lq, int lk, int q_offset,
                  int kv_valid, int causal, float sm_scale, int heads, int kv_heads) {
  constexpr int kS = row_stride<D>(), kNT = kFwdBk / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* q_s = reinterpret_cast<T*>(smem_raw);
  T* k_s = q_s + kFwdBq * kS;      // two stages
  T* v_s = k_s + 2 * kFwdBk * kS;  // two stages
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kFwdBq;
  const int64_t kvh = static_cast<int64_t>(bh / heads) * kv_heads + (bh % heads) / (heads / kv_heads);
  const T* kb = k + kvh * lk * D;
  const T* vb = v + kvh * lk * D;
  const int kv_end = min(lk, kv_valid);
  const int stop = key_stop(q0, lq, lk, q_offset, kv_valid, causal);
  const int n_kt = stop > 0 ? (stop + kFwdBk - 1) / kFwdBk : 0;
  const float scale2 = sm_scale * kLog2e;
  const int row_lo = q0 + warp * 16 + (lane >> 2);  // rows row_lo and row_lo + 8

  if (n_kt > 0) {
    load_tile_async<T, kFwdBq, D>(q_s, q + static_cast<int64_t>(bh) * lq * D, q0, lq);
    load_tile_async<T, kFwdBk, D>(k_s, kb, 0, lk);
    load_tile_async<T, kFwdBk, D>(v_s, vb, 0, lk);
  }
  cp_async_commit();

  float acc[D / 8][4], m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < D / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  uint32_t qf[D / 16][4];

  for (int kt = 0; kt < n_kt; ++kt) {
    const int st = kt & 1;
    if (kt + 1 < n_kt) {  // the next tile flies while this one computes
      load_tile_async<T, kFwdBk, D>(k_s + (st ^ 1) * kFwdBk * kS, kb, (kt + 1) * kFwdBk, lk);
      load_tile_async<T, kFwdBk, D>(v_s + (st ^ 1) * kFwdBk * kS, vb, (kt + 1) * kFwdBk, lk);
    }
    cp_async_commit();
    cp_async_wait<1>();  // every group but the newest has landed: this tile
    __syncthreads();
    if (kt == 0) {
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) ldsm_a<D>(qf[kk], q_s, warp * 16, kk * 16);
    }
    const T* ks = k_s + st * kFwdBk * kS;
    const T* vs = v_s + st * kFwdBk * kS;

    float s[kNT][4];
#pragma unroll
    for (int j = 0; j < kNT; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
      for (int nn = 0; nn < kNT / 2; ++nn) {
        uint32_t b[4];
        ldsm_b<D>(b, ks, nn * 16, kk * 16);
        Mma<T>::run(s[2 * nn], qf[kk], b[0], b[1]);
        Mma<T>::run(s[2 * nn + 1], qf[kk], b[2], b[3]);
      }
    }

    const int k0 = kt * kFwdBk;
    const bool masked = k0 + kFwdBk > kv_end || (causal && k0 + kFwdBk - 1 > q0 + q_offset);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int last = row_lo + 8 * h + q_offset;  // this row's last visible key
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float x = s[j][2 * h + e] * scale2;
          if (masked) {
            const int key = k0 + 8 * j + 2 * (lane & 3) + e;
            if (key >= kv_end || (causal && key > last)) x = kNegInf;
          }
          s[j][2 * h + e] = x;
          mx = fmaxf(mx, x);
        }
      }
      const float m_new = fmaxf(m[h], quad_max(mx));
      const float corr = exp2f(m[h] - m_new);
      m[h] = m_new;
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float x = s[j][2 * h + e];
          const float p = !masked || x > 0.5f * kNegInf ? exp2f(x - m_new) : 0.f;
          s[j][2 * h + e] = p;
          rs += p;
        }
      }
      l[h] = l[h] * corr + rs;  // this lane's share; summed over the quad at the end
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        acc[j][2 * h] *= corr;
        acc[j][2 * h + 1] *= corr;
      }
    }

    // O += P V: P's accumulator fragments are the A fragments, rounded to T.
#pragma unroll
    for (int kk = 0; kk < kNT / 2; ++kk) {
      const uint32_t a[4] = {Mma<T>::pack(s[2 * kk][0], s[2 * kk][1]),
                             Mma<T>::pack(s[2 * kk][2], s[2 * kk][3]),
                             Mma<T>::pack(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                             Mma<T>::pack(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int dn = 0; dn < D / 16; ++dn) {
        uint32_t b[4];
        ldsm_b_trans<D>(b, vs, kk * 16, dn * 16);
        Mma<T>::run(acc[2 * dn], a, b[0], b[1]);
        Mma<T>::run(acc[2 * dn + 1], a, b[2], b[3]);
      }
    }
    __syncthreads();  // this stage is free for the load issued next iteration
  }
  cp_async_wait<0>();

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = row_lo + 8 * h;
    const float ls = fmaxf(quad_sum(l[h]), 1e-30f);
    if (r < lq) {
      const float inv = 1.f / ls;
      T* orow = o + (static_cast<int64_t>(bh) * lq + r) * D + 2 * (lane & 3);
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        *reinterpret_cast<uint32_t*>(orow + 8 * j) =
            Mma<T>::pack(acc[j][2 * h] * inv, acc[j][2 * h + 1] * inv);
      }
      if ((lane & 3) == 0) {
        const float mn = m[h] > 0.5f * kNegInf ? m[h] * kLn2 : kNegInf;
        lse[static_cast<int64_t>(bh) * lq + r] = mn + logf(ls);
      }
    }
  }
}

constexpr int kDkvBk = 64;  // key rows of a dK/dV block (4 warps x 16)

// Query rows of a dK/dV tile: 32 at D = 128 keeps the accumulators in registers.
template <int D>
__host__ __device__ constexpr int dkv_bq() { return D <= 64 ? 64 : 32; }

template <typename T, int D>
__global__ void __launch_bounds__(kMmaThreads)
fa_bwd_dkv_mma_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                      const T* __restrict__ dout, const float* __restrict__ lse,
                      const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv,
                      int lq, int lk, int q_offset, int kv_valid, int causal, float sm_scale) {
  constexpr int kS = row_stride<D>(), kBq = dkv_bq<D>(), kNT = kBq / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* k_s = reinterpret_cast<T*>(smem_raw);
  T* v_s = k_s + kDkvBk * kS;
  T* q_s = v_s + kDkvBk * kS;      // two stages
  T* do_s = q_s + 2 * kBq * kS;    // two stages
  float* lse_s = reinterpret_cast<float*>(do_s + 2 * kBq * kS);  // two stages
  float* dl_s = lse_s + 2 * kBq;                                 // two stages
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int bh = blockIdx.x;
  const int k0 = blockIdx.y * kDkvBk;  // low key tiles see the most queries: first
  const int64_t qrow = static_cast<int64_t>(bh) * lq;
  const int64_t krow = static_cast<int64_t>(bh) * lk;
  const int kv_end = min(lk, kv_valid);
  const float scale2 = sm_scale * kLog2e;
  const int key_lo = k0 + warp * 16 + (lane >> 2);  // keys key_lo and key_lo + 8

  float dk_acc[D / 8][4], dv_acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[j][e] = dv_acc[j][e] = 0.f;
  }

  // Q, dO, lse and delta of query tile qt into ring stage st.
  auto load_q_tile = [&](int qt, int st) {
    const int q0 = qt * kBq;
    load_tile_async<T, kBq, D>(q_s + st * kBq * kS, q + qrow * D, q0, lq);
    load_tile_async<T, kBq, D>(do_s + st * kBq * kS, dout + qrow * D, q0, lq);
    for (int i = threadIdx.x; i < 2 * kBq; i += kMmaThreads) {
      const int c = i % kBq;
      const bool ok = q0 + c < lq;
      const float* src = (i < kBq ? lse : delta) + qrow + (ok ? q0 + c : 0);
      cp_async4(smem_u32((i < kBq ? lse_s : dl_s) + st * kBq + c), src, ok);
    }
  };

  if (k0 < kv_end) {  // a key tile wholly past kv_valid gets zero gradients
    int t0 = 0;       // first query tile that sees this key tile
    if (causal && k0 - q_offset > 0) t0 = (k0 - q_offset) / kBq;
    const int n_qt = (lq + kBq - 1) / kBq;
    if (t0 < n_qt) {
      load_tile_async<T, kDkvBk, D>(k_s, k + krow * D, k0, lk);
      load_tile_async<T, kDkvBk, D>(v_s, v + krow * D, k0, lk);
      load_q_tile(t0, 0);
    }
    cp_async_commit();
    for (int qt = t0; qt < n_qt; ++qt) {
      const int st = (qt - t0) & 1;
      if (qt + 1 < n_qt) load_q_tile(qt + 1, st ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
      __syncthreads();
      const T* qs = q_s + st * kBq * kS;
      const T* dos = do_s + st * kBq * kS;
      const float* lse_t = lse_s + st * kBq;
      const float* dl_t = dl_s + st * kBq;
      const int q0 = qt * kBq;

      // S^T = K Q^T and dP^T = V dO^T: rows are this warp's 16 keys.
      float s[kNT][4], dp[kNT][4];
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
      }
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        uint32_t ka[4], va[4];
        ldsm_a<D>(ka, k_s, warp * 16, kk * 16);
        ldsm_a<D>(va, v_s, warp * 16, kk * 16);
#pragma unroll
        for (int nn = 0; nn < kNT / 2; ++nn) {
          uint32_t b[4];
          ldsm_b<D>(b, qs, nn * 16, kk * 16);
          Mma<T>::run(s[2 * nn], ka, b[0], b[1]);
          Mma<T>::run(s[2 * nn + 1], ka, b[2], b[3]);
          ldsm_b<D>(b, dos, nn * 16, kk * 16);
          Mma<T>::run(dp[2 * nn], va, b[0], b[1]);
          Mma<T>::run(dp[2 * nn + 1], va, b[2], b[3]);
        }
      }

      // P^T = exp(S^T scale - lse) and dS^T = P^T (dP^T - delta) scale, per
      // column; s and dp are overwritten with them.
      const bool masked = k0 + kDkvBk > kv_end || q0 + kBq > lq ||
                          (causal && q0 + q_offset < k0 + kDkvBk - 1);
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = 8 * j + 2 * (lane & 3) + (e & 1);  // query column in the tile
          const int key = key_lo + 8 * (e >> 1);
          bool ok = true;
          if (masked) {
            ok = key < kv_end && q0 + c < lq && !(causal && key > q0 + c + q_offset);
          }
          const float p = ok ? exp2f(s[j][e] * scale2 - lse_t[c] * kLog2e) : 0.f;
          s[j][e] = p;
          dp[j][e] = p * (dp[j][e] - dl_t[c]) * sm_scale;
        }
      }

      // dV += P^T dO and dK += dS^T Q: the accumulators, rounded to T, are
      // the A fragments; dO and Q are read along their other axis.
#pragma unroll
      for (int kk = 0; kk < kNT / 2; ++kk) {
        const uint32_t pa[4] = {Mma<T>::pack(s[2 * kk][0], s[2 * kk][1]),
                                Mma<T>::pack(s[2 * kk][2], s[2 * kk][3]),
                                Mma<T>::pack(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                                Mma<T>::pack(s[2 * kk + 1][2], s[2 * kk + 1][3])};
        const uint32_t da[4] = {Mma<T>::pack(dp[2 * kk][0], dp[2 * kk][1]),
                                Mma<T>::pack(dp[2 * kk][2], dp[2 * kk][3]),
                                Mma<T>::pack(dp[2 * kk + 1][0], dp[2 * kk + 1][1]),
                                Mma<T>::pack(dp[2 * kk + 1][2], dp[2 * kk + 1][3])};
#pragma unroll
        for (int dn = 0; dn < D / 16; ++dn) {
          uint32_t b[4];
          ldsm_b_trans<D>(b, dos, kk * 16, dn * 16);
          Mma<T>::run(dv_acc[2 * dn], pa, b[0], b[1]);
          Mma<T>::run(dv_acc[2 * dn + 1], pa, b[2], b[3]);
          ldsm_b_trans<D>(b, qs, kk * 16, dn * 16);
          Mma<T>::run(dk_acc[2 * dn], da, b[0], b[1]);
          Mma<T>::run(dk_acc[2 * dn + 1], da, b[2], b[3]);
        }
      }
      __syncthreads();  // this stage is free for the load issued next iteration
    }
    cp_async_wait<0>();
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = key_lo + 8 * h;
    if (r < lk) {
      const int64_t off = (krow + r) * D + 2 * (lane & 3);
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        *reinterpret_cast<uint32_t*>(dk + off + 8 * j) =
            Mma<T>::pack(dk_acc[j][2 * h], dk_acc[j][2 * h + 1]);
        *reinterpret_cast<uint32_t*>(dv + off + 8 * j) =
            Mma<T>::pack(dv_acc[j][2 * h], dv_acc[j][2 * h + 1]);
      }
    }
  }
}

constexpr int kDqBq = 64;  // query rows of a dQ block (4 warps x 16)

// Keys of a dQ tile, and whether the Q and dO A fragments stay in registers
// across key tiles: at D = 128, dq_acc alone takes 64 registers, so the tile
// is 32 keys and the fragments are read again from shared memory per tile.
template <int D>
__host__ __device__ constexpr int dq_bk() { return D <= 64 ? 64 : 32; }
template <int D>
__host__ __device__ constexpr bool dq_frags_in_regs() { return D <= 64; }

template <typename T, int D>
__global__ void __launch_bounds__(kMmaThreads)
fa_bwd_dq_mma_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     const T* __restrict__ dout, const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dq, int lq, int lk,
                     int q_offset, int kv_valid, int causal, float sm_scale) {
  constexpr int kS = row_stride<D>(), kBk = dq_bk<D>(), kNT = kBk / 8;
  constexpr bool kRegs = dq_frags_in_regs<D>();
  constexpr int kF = kRegs ? D / 16 : 1;  // A fragments kept per operand
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* q_s = reinterpret_cast<T*>(smem_raw);
  T* do_s = q_s + kDqBq * kS;
  T* k_s = do_s + kDqBq * kS;   // two stages
  T* v_s = k_s + 2 * kBk * kS;  // two stages
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kDqBq;
  const int64_t qrow = static_cast<int64_t>(bh) * lq;
  const T* kb = k + static_cast<int64_t>(bh) * lk * D;
  const T* vb = v + static_cast<int64_t>(bh) * lk * D;
  const int kv_end = min(lk, kv_valid);
  const int stop = key_stop(q0, lq, lk, q_offset, kv_valid, causal);
  const int n_kt = stop > 0 ? (stop + kBk - 1) / kBk : 0;
  const float scale2 = sm_scale * kLog2e;
  const int row_lo = q0 + warp * 16 + (lane >> 2);  // rows row_lo and row_lo + 8

  // lse (times log2 e) and delta of this lane's two accumulator rows. Rows
  // past lq read zeros; their dS is zero (dO is zero-filled), and they are
  // never written.
  float lse2[2], dl[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = row_lo + 8 * h;
    lse2[h] = r < lq ? lse[qrow + r] * kLog2e : 0.f;
    dl[h] = r < lq ? delta[qrow + r] : 0.f;
  }

  if (n_kt > 0) {
    load_tile_async<T, kDqBq, D>(q_s, q + qrow * D, q0, lq);
    load_tile_async<T, kDqBq, D>(do_s, dout + qrow * D, q0, lq);
    load_tile_async<T, kBk, D>(k_s, kb, 0, lk);
    load_tile_async<T, kBk, D>(v_s, vb, 0, lk);
  }
  cp_async_commit();

  float dq_acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) dq_acc[j][0] = dq_acc[j][1] = dq_acc[j][2] = dq_acc[j][3] = 0.f;
  uint32_t qf[kF][4], df[kF][4];

  for (int kt = 0; kt < n_kt; ++kt) {
    const int st = kt & 1;
    if (kt + 1 < n_kt) {  // the next tile flies while this one computes
      load_tile_async<T, kBk, D>(k_s + (st ^ 1) * kBk * kS, kb, (kt + 1) * kBk, lk);
      load_tile_async<T, kBk, D>(v_s + (st ^ 1) * kBk * kS, vb, (kt + 1) * kBk, lk);
    }
    cp_async_commit();
    cp_async_wait<1>();  // every group but the newest has landed: this tile
    __syncthreads();
    if (kRegs && kt == 0) {
#pragma unroll
      for (int kk = 0; kk < kF; ++kk) {
        ldsm_a<D>(qf[kk], q_s, warp * 16, kk * 16);
        ldsm_a<D>(df[kk], do_s, warp * 16, kk * 16);
      }
    }
    const T* ks = k_s + st * kBk * kS;
    const T* vs = v_s + st * kBk * kS;

    // S = Q K^T and dP = dO V^T: rows are this warp's 16 queries.
    float s[kNT][4], dp[kNT][4];
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t qa[4], da[4];
      if constexpr (kRegs) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          qa[e] = qf[kk][e];
          da[e] = df[kk][e];
        }
      } else {
        ldsm_a<D>(qa, q_s, warp * 16, kk * 16);
        ldsm_a<D>(da, do_s, warp * 16, kk * 16);
      }
#pragma unroll
      for (int nn = 0; nn < kNT / 2; ++nn) {
        uint32_t b[4];
        ldsm_b<D>(b, ks, nn * 16, kk * 16);
        Mma<T>::run(s[2 * nn], qa, b[0], b[1]);
        Mma<T>::run(s[2 * nn + 1], qa, b[2], b[3]);
        ldsm_b<D>(b, vs, nn * 16, kk * 16);
        Mma<T>::run(dp[2 * nn], da, b[0], b[1]);
        Mma<T>::run(dp[2 * nn + 1], da, b[2], b[3]);
      }
    }

    // P = exp(S scale - lse) and dS = P (dP - delta) scale, into s. Only
    // the diagonal and ragged tiles are masked.
    const int k0 = kt * kBk;
    const bool masked = k0 + kBk > kv_end || (causal && k0 + kBk - 1 > q0 + q_offset);
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1;
        bool ok = true;
        if (masked) {
          const int key = k0 + 8 * j + 2 * (lane & 3) + (e & 1);
          ok = key < kv_end && !(causal && key > row_lo + 8 * h + q_offset);
        }
        const float p = ok ? exp2f(s[j][e] * scale2 - lse2[h]) : 0.f;
        s[j][e] = p * (dp[j][e] - dl[h]) * sm_scale;
      }
    }

    // dQ += dS K: dS's accumulator fragments, rounded to T, are the A
    // fragments; K is read along its other axis from the same tile.
#pragma unroll
    for (int kk = 0; kk < kNT / 2; ++kk) {
      const uint32_t a[4] = {Mma<T>::pack(s[2 * kk][0], s[2 * kk][1]),
                             Mma<T>::pack(s[2 * kk][2], s[2 * kk][3]),
                             Mma<T>::pack(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                             Mma<T>::pack(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int dn = 0; dn < D / 16; ++dn) {
        uint32_t b[4];
        ldsm_b_trans<D>(b, ks, kk * 16, dn * 16);
        Mma<T>::run(dq_acc[2 * dn], a, b[0], b[1]);
        Mma<T>::run(dq_acc[2 * dn + 1], a, b[2], b[3]);
      }
    }
    __syncthreads();  // this stage is free for the load issued next iteration
  }
  cp_async_wait<0>();

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = row_lo + 8 * h;
    if (r < lq) {
      T* row = dq + (qrow + r) * D + 2 * (lane & 3);
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        *reinterpret_cast<uint32_t*>(row + 8 * j) =
            Mma<T>::pack(dq_acc[j][2 * h], dq_acc[j][2 * h + 1]);
      }
    }
  }
}

template <typename T, int D>
constexpr size_t fwd_mma_smem() { return (kFwdBq + 4 * kFwdBk) * row_stride<D>() * sizeof(T); }
template <typename T, int D>
constexpr size_t dq_mma_smem() {
  return (2 * kDqBq + 4 * dq_bk<D>()) * row_stride<D>() * sizeof(T);
}
template <typename T, int D>
constexpr size_t dkv_mma_smem() {
  return (2 * kDkvBk + 4 * dkv_bq<D>()) * row_stride<D>() * sizeof(T) +
         4 * dkv_bq<D>() * sizeof(float);
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

// Raises the kernel's dynamic shared memory limit, launches it on the stream
// with the arguments of the tuple, and returns cudaGetLastError().
template <typename K, typename... A>
int launch(K kernel, dim3 grid, int threads, size_t smem, void* stream,
           const std::tuple<A...>& args) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  std::apply(
      [&](auto... a) {
        kernel<<<grid, threads, smem, static_cast<cudaStream_t>(stream)>>>(a...);
      },
      args);
  return static_cast<int>(cudaGetLastError());
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
    const auto args = std::make_tuple(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<T*>(o), static_cast<float*>(lse), lq, lk, q_offset, kv_valid, causal,
        sm_scale, heads, kv_heads);
    if constexpr (std::is_same<T, float>::value) {
      return launch(fa_fwd_kernel<T, D>, dim3(bh, tiles(lq)), kThreads, fwd_smem<D>(), stream,
                    args);
    } else {
      return launch(fa_fwd_mma_kernel<T, D>, dim3(bh, tiles(lq)), kMmaThreads,
                    fwd_mma_smem<T, D>(), stream, args);
    }
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
    const auto args = std::make_tuple(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<const T*>(dout), static_cast<const float*>(lse),
        static_cast<const float*>(delta), static_cast<T*>(dq), lq, lk, q_offset, kv_valid,
        causal, sm_scale);
    if constexpr (std::is_same<T, float>::value) {
      return launch(fa_bwd_dq_kernel<T, D>, dim3(bh, tiles(lq)), kThreads, dq_smem<D>(),
                    stream, args);
    } else {
      return launch(fa_bwd_dq_mma_kernel<T, D>, dim3(bh, tiles(lq)), kMmaThreads,
                    dq_mma_smem<T, D>(), stream, args);
    }
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
    const auto args = std::make_tuple(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<const T*>(dout), static_cast<const float*>(lse),
        static_cast<const float*>(delta), static_cast<T*>(dk), static_cast<T*>(dv), lq, lk,
        q_offset, kv_valid, causal, sm_scale);
    if constexpr (std::is_same<T, float>::value) {
      return launch(fa_bwd_dkv_kernel<T, D>, dim3(bh, tiles(lk)), kThreads, dkv_smem<D>(),
                    stream, args);
    } else {
      return launch(fa_bwd_dkv_mma_kernel<T, D>, dim3(bh, tiles(lk)), kMmaThreads,
                    dkv_mma_smem<T, D>(), stream, args);
    }
  });
}

// Dynamic shared memory (bytes) of the bf16/fp16 forward (which = 0), dK/dV
// (which = 1) or dQ (which = 2) kernel at head dim d; -1 for another head
// dim or kernel.
int hvd_flash_mma_smem(int which, int d) {
  if ((d != 16 && d != 32 && d != 64 && d != 128) || which < 0 || which > 2) return -1;
  return dispatch_d<__nv_bfloat16>(d, [&](auto t, auto dd) {
    using T = typename decltype(t)::type;
    constexpr int D = decltype(dd)::value;
    const size_t bytes[] = {fwd_mma_smem<T, D>(), dkv_mma_smem<T, D>(), dq_mma_smem<T, D>()};
    return static_cast<int>(bytes[which]);
  });
}

}  // extern "C"
