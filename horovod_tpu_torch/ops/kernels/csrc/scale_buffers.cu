// Batched fusion-buffer pack+prescale and unpack+postscale for Hopper (sm_90a).
//
// Replaces the TPU kernel horovod_tpu/ops/pallas/kernels.py::_scale_kernel as
// reached through scale_buffers (one launch scaling a whole list of tensors),
// which stands in for the reference's batched memcpy+scale of
// horovod/common/ops/cuda/cuda_kernels.cu around each fusion bucket.
//
//   pack:   flat[off_i + k] = B(float(B(t_i[k])) * scale)   for every tensor i
//   unpack: t_i[k]          = A(B(float(flat[off_i + k]) * scale))
//
// with A the tensors' type and B the buffer's (fp32, fp16 or bf16 each). When
// they are the same type this is one fp32 multiply (__fmul_rn, never
// contracted) and one rounding back to the type, the TPU kernel's contract.
// The mixed-dtype form scales in the buffer's type: the tensor is rounded to
// B before the multiply and the product rounded to B before it becomes an A,
// the rounding points of the JAX fused program on the quantized wire (A =
// bf16/fp16 into an fp32 work buffer: B(a) is exact) and on the 16-bit cast
// wire (A = fp32 into a bf16/fp16 buffer: cast, then scale in the wire type;
// back: scale in the wire type, then widen). Either way the kernel is
// bit-equal to the plain PyTorch version, which rounds at the same points.
//
// Bound: bytes. Each element is read once and written once and the kernel
// does one multiply per element, far below the card's ~300 flop/byte balance
// point; the least time is 2 * bucket bytes / 3.35 TB/s (61 us for ResNet-50's
// 102 MB of fp32 gradients). What the design does about it: a single launch
// per bucket, one per tensor type in a bucket that mixes them (no per-tensor
// launch overhead, as in the reference), a 2-D grid
// whose y walks the tensor table and whose x is grid-stride over each tensor
// so neighbouring threads touch neighbouring addresses (coalesced), and no
// staging beyond the fusion buffer itself. Vectorised 16-byte access, TMA and
// persistent blocks are left for later.
//
// The table of (pointer, numel, offset) rows, one per tensor, is a kernel
// parameter passed by value (__grid_constant__: read in place from the
// parameter bank, never copied to local memory). A launch takes up to
// kMaxRows rows, 6 KB (past the 4 KB of parameters before CUDA 12.1, which
// allows 32,764 bytes on sm_70 and later); the wrapper splits a longer
// bucket into launches. So the table goes to the card with the launch
// itself: no device allocation, no copy of its own and nothing kept between
// launches, whether or not the tensors' addresses repeat from step to step.
// The kernel allocates nothing and does not synchronise. Plain C interface,
// loaded with ctypes; each entry point returns cudaGetLastError() after its
// launch.

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include "cvt.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxRows = 256;  // more than any bucket of ResNet-50 or GPT-2 small

// The rows as arrays (each read by a block at its own index).
struct Table {
  int64_t ptr[kMaxRows];
  int64_t numel[kMaxRows];
  int64_t offset[kMaxRows];
};

template <typename A, typename B, bool kPack>
__global__ void __launch_bounds__(kThreads)
scale_copy_kernel(const __grid_constant__ Table table, int n_tensors, B* flat, float scale) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int j = blockIdx.y; j < n_tensors; j += gridDim.y) {
    A* tensor = reinterpret_cast<A*>(table.ptr[j]);
    const int64_t numel = table.numel[j];
    B* slot = flat + table.offset[j];
    for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < numel;
         i += stride) {
      if (kPack) {
        const float x = Cvt<B>::to_f32(Cvt<B>::from_f32(Cvt<A>::to_f32(tensor[i])));
        slot[i] = Cvt<B>::from_f32(__fmul_rn(x, scale));
      } else {
        const B y = Cvt<B>::from_f32(__fmul_rn(Cvt<B>::to_f32(slot[i]), scale));
        tensor[i] = Cvt<A>::from_f32(Cvt<B>::to_f32(y));
      }
    }
  }
}

template <typename A, typename B, bool kPack>
void launch_typed(const Table& table, int n, dim3 grid, void* flat, float scale,
                  cudaStream_t stream) {
  scale_copy_kernel<A, B, kPack>
      <<<grid, kThreads, 0, stream>>>(table, n, static_cast<B*>(flat), scale);
}

// The tensors' type A, then the buffer's B: 0 = float32, 1 = float16,
// 2 = bfloat16. Returns false for another code.
template <typename A, bool kPack>
bool launch_buffer(int buffer_dtype, const Table& table, int n, dim3 grid, void* flat,
                   float scale, cudaStream_t stream) {
  switch (buffer_dtype) {
    case 0: launch_typed<A, float, kPack>(table, n, grid, flat, scale, stream); return true;
    case 1: launch_typed<A, __half, kPack>(table, n, grid, flat, scale, stream); return true;
    case 2:
      launch_typed<A, __nv_bfloat16, kPack>(table, n, grid, flat, scale, stream);
      return true;
    default: return false;
  }
}

// rows: n pointers, then n numels, then n offsets (host memory), copied into
// the launch's parameters.
template <bool kPack>
int launch(const void* rows, int64_t n_tensors, int64_t blocks_x, void* flat, int buffer_dtype,
           int tensor_dtype, float scale, cudaStream_t stream) {
  if (n_tensors <= 0 || n_tensors > kMaxRows || blocks_x <= 0 || blocks_x > 0x7fffffff) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t* r = static_cast<const int64_t*>(rows);
  const int n = static_cast<int>(n_tensors);
  Table table;
  memcpy(table.ptr, r, n * sizeof(int64_t));
  memcpy(table.numel, r + n, n * sizeof(int64_t));
  memcpy(table.offset, r + 2 * n, n * sizeof(int64_t));
  const dim3 grid(static_cast<unsigned>(blocks_x), static_cast<unsigned>(n));
  bool ok = false;
  switch (tensor_dtype) {
    case 0:
      ok = launch_buffer<float, kPack>(buffer_dtype, table, n, grid, flat, scale, stream);
      break;
    case 1:
      ok = launch_buffer<__half, kPack>(buffer_dtype, table, n, grid, flat, scale, stream);
      break;
    case 2:
      ok = launch_buffer<__nv_bfloat16, kPack>(buffer_dtype, table, n, grid, flat, scale,
                                               stream);
      break;
    default:
      break;
  }
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// rows: the table as launch takes it, in host memory; n_tensors <=
// kMaxRows. buffer_dtype, tensor_dtype: 0 = float32, 1 = float16,
// 2 = bfloat16 (every tensor of one launch has the same type). Returns a
// cudaError_t.
int hvd_scale_pack(const void* rows, int64_t n_tensors, int64_t blocks_x, void* flat,
                   int buffer_dtype, int tensor_dtype, float scale, void* stream) {
  return launch<true>(rows, n_tensors, blocks_x, flat, buffer_dtype, tensor_dtype, scale,
                      static_cast<cudaStream_t>(stream));
}

int hvd_scale_unpack(const void* rows, int64_t n_tensors, int64_t blocks_x, void* flat,
                     int buffer_dtype, int tensor_dtype, float scale, void* stream) {
  return launch<false>(rows, n_tensors, blocks_x, flat, buffer_dtype, tensor_dtype, scale,
                       static_cast<cudaStream_t>(stream));
}

}  // extern "C"
