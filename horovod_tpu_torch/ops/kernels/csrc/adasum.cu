// Adasum combine of two gradient vectors, segment by segment, for Hopper (sm_90a).
//
// Replaces the TPU kernel horovod_tpu/ops/pallas/kernels.py::_adasum_kernel
// (via adasum_combine_pallas), the reference's pairwise combine of
// horovod/common/ops/adasum/adasum.h:103+. For every segment (one tensor of a
// fusion bucket) on its own:
//
//   dot = sum a*b,  na = sum a*a,  nb = sum b*b                      (fp32)
//   ca  = na > eps ? 1 - dot / (2 max(na, eps)) : 1,  cb likewise
//   out = T(ca*a + cb*b)       (two fp32 products, one fp32 add, one rounding)
//
// T is float, __half, __nv_bfloat16 or double; every element is read into
// fp32, as the JAX combine casts to fp32 whatever its input.
//
// A cross-block reduction needs a second pass or atomics; this takes the
// second pass, so the result is deterministic:
//
//   hvd_adasum_partials: each block grid-strides over its share of one
//     segment, reduces its three fp32 sums in the block (warp shuffles, then
//     shared memory, in a fixed order) and writes them to partials[block];
//   hvd_adasum_apply: each block first sums its segment's partials in a fixed
//     order, so every block of a segment derives the same ca and cb, then
//     writes out over the same share.
//
// out may alias a: in the apply pass each element is read and written by one
// thread, and nothing reads a after it. So the Adasum tree runs in place in
// the gathered buffer (row i <- combine(row i, row i + stride)).
//
// Layout: the table has one int64 row (offset, numel, first, nblocks) per
// block, its segment's; the wrapper builds it once per bucket signature and
// keeps it on the card. A segment of n elements gets ceil(n / 4096) blocks,
// at most 1024 (grid-stride beyond), and a zero-length segment none. The
// partials are three fp32 planes of n_blocks each (dot, na, nb).
//
// Bound: bytes. The two passes read a and b twice and write out once, where
// the least the function needs is one read of each and one write (3 N
// itemsize bytes; 92 us for ResNet-50's 25.6M fp32 gradients at 3.35 TB/s);
// a handful of flops per element is far below the card's balance point.
// What the design does about it: coalesced grid-stride access, blocks sized
// to each segment (no idle blocks for small tensors), and partials that are
// a few KB. One fused pass for segments that fit in L2, 16-byte loads and a
// whole tree level per launch are left for later.
//
// Plain C interface, loaded with ctypes; each entry point returns
// cudaGetLastError() after its launch. Nothing is allocated here and nothing
// synchronises.

#include <cuda_runtime.h>
#include <stdint.h>

#include "cvt.cuh"

namespace {

struct Row {
  int64_t offset;   // the segment's first element in a, b and out
  int64_t numel;    // the segment's length
  int64_t first;    // the segment's first block
  int64_t nblocks;  // the segment's number of blocks
};

struct Sums {
  float dot, na, nb;
};

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// The block's sums, in a fixed order, valid in every thread. Called once per
// kernel, so its shared memory needs no second barrier.
__device__ __forceinline__ Sums block_sum(Sums s) {
  __shared__ float warp_part[3][kWarps];
  s.dot = warp_sum(s.dot);
  s.na = warp_sum(s.na);
  s.nb = warp_sum(s.nb);
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) {
    warp_part[0][warp] = s.dot;
    warp_part[1][warp] = s.na;
    warp_part[2][warp] = s.nb;
  }
  __syncthreads();
  Sums r{0.f, 0.f, 0.f};
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    r.dot += warp_part[0][w];
    r.na += warp_part[1][w];
    r.nb += warp_part[2][w];
  }
  return r;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
adasum_partials_kernel(const Row* __restrict__ table, int64_t n_blocks, const T* a, const T* b,
                       float* __restrict__ partials) {
  const Row r = table[blockIdx.x];
  const int64_t stride = r.nblocks * kThreads;
  const T* sa = a + r.offset;
  const T* sb = b + r.offset;
  Sums s{0.f, 0.f, 0.f};
  for (int64_t i = (blockIdx.x - r.first) * kThreads + threadIdx.x; i < r.numel; i += stride) {
    const float x = Cvt<T>::to_f32(sa[i]);
    const float y = Cvt<T>::to_f32(sb[i]);
    s.dot = fmaf(x, y, s.dot);
    s.na = fmaf(x, x, s.na);
    s.nb = fmaf(y, y, s.nb);
  }
  s = block_sum(s);
  if (threadIdx.x == 0) {
    partials[blockIdx.x] = s.dot;
    partials[n_blocks + blockIdx.x] = s.na;
    partials[2 * n_blocks + blockIdx.x] = s.nb;
  }
}

__device__ __forceinline__ float coefficient(float dot, float n, float eps) {
  // 1 - dot / (2 max(n, eps)) where n > eps, else 1; IEEE division.
  return n > eps ? __fsub_rn(1.f, __fdiv_rn(dot, __fmul_rn(2.f, fmaxf(n, eps)))) : 1.f;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
adasum_apply_kernel(const Row* __restrict__ table, int64_t n_blocks, const T* a, const T* b,
                    T* out, const float* __restrict__ partials, float eps) {
  const Row r = table[blockIdx.x];
  Sums s{0.f, 0.f, 0.f};
  for (int64_t k = threadIdx.x; k < r.nblocks; k += kThreads) {
    s.dot += partials[r.first + k];
    s.na += partials[n_blocks + r.first + k];
    s.nb += partials[2 * n_blocks + r.first + k];
  }
  s = block_sum(s);
  const float ca = coefficient(s.dot, s.na, eps);
  const float cb = coefficient(s.dot, s.nb, eps);
  const int64_t stride = r.nblocks * kThreads;
  const T* sa = a + r.offset;
  const T* sb = b + r.offset;
  T* so = out + r.offset;
  for (int64_t i = (blockIdx.x - r.first) * kThreads + threadIdx.x; i < r.numel; i += stride) {
    const float x = Cvt<T>::to_f32(sa[i]);
    const float y = Cvt<T>::to_f32(sb[i]);
    so[i] = Cvt<T>::from_f32(__fadd_rn(__fmul_rn(ca, x), __fmul_rn(cb, y)));
  }
}

bool valid_grid(int64_t n_blocks) { return n_blocks > 0 && n_blocks <= 0x7fffffff; }

template <typename T>
void partials(const void* table, int64_t n_blocks, const void* a, const void* b, void* p,
              cudaStream_t stream) {
  adasum_partials_kernel<T><<<static_cast<unsigned>(n_blocks), kThreads, 0, stream>>>(
      static_cast<const Row*>(table), n_blocks, static_cast<const T*>(a),
      static_cast<const T*>(b), static_cast<float*>(p));
}

template <typename T>
void apply(const void* table, int64_t n_blocks, const void* a, const void* b, void* out,
           const void* p, float eps, cudaStream_t stream) {
  adasum_apply_kernel<T><<<static_cast<unsigned>(n_blocks), kThreads, 0, stream>>>(
      static_cast<const Row*>(table), n_blocks, static_cast<const T*>(a),
      static_cast<const T*>(b), static_cast<T*>(out), static_cast<const float*>(p), eps);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = float16, 2 = bfloat16, 3 = float64. Returns a
// cudaError_t. partials: 3 * n_blocks fp32.
int hvd_adasum_partials(const void* table, int64_t n_blocks, const void* a, const void* b,
                        void* partials_out, int dtype, void* stream) {
  if (!valid_grid(n_blocks)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: partials<float>(table, n_blocks, a, b, partials_out, s); break;
    case 1: partials<__half>(table, n_blocks, a, b, partials_out, s); break;
    case 2: partials<__nv_bfloat16>(table, n_blocks, a, b, partials_out, s); break;
    case 3: partials<double>(table, n_blocks, a, b, partials_out, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

int hvd_adasum_apply(const void* table, int64_t n_blocks, const void* a, const void* b, void* out,
                     const void* partials_in, int dtype, float eps, void* stream) {
  if (!valid_grid(n_blocks)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: apply<float>(table, n_blocks, a, b, out, partials_in, eps, s); break;
    case 1: apply<__half>(table, n_blocks, a, b, out, partials_in, eps, s); break;
    case 2: apply<__nv_bfloat16>(table, n_blocks, a, b, out, partials_in, eps, s); break;
    case 3: apply<double>(table, n_blocks, a, b, out, partials_in, eps, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
