// Batched fusion-buffer pack+prescale and unpack+postscale for Hopper (sm_90a).
//
// Replaces the TPU kernel horovod_tpu/ops/pallas/kernels.py::_scale_kernel as
// reached through scale_buffers (one launch scaling a whole list of tensors),
// which stands in for the reference's batched memcpy+scale of
// horovod/common/ops/cuda/cuda_kernels.cu around each fusion bucket.
//
//   pack:   flat[off_i + k] = T(float(t_i[k]) * scale)   for every tensor i
//   unpack: t_i[k]          = T(float(flat[off_i + k]) * scale)
//
// One fp32 multiply (__fmul_rn, never contracted) and one rounding back to T,
// the TPU kernel's contract; so the kernel is bit-equal to the plain PyTorch
// version, which does the same.
//
// Bound: bytes. Each element is read once and written once and the kernel
// does one multiply per element, far below the card's ~300 flop/byte balance
// point; the least time is 2 * bucket bytes / 3.35 TB/s (61 us for ResNet-50's
// 102 MB of fp32 gradients). What the design does about it: a single launch
// per bucket (no per-tensor launch overhead, as in the reference), a 2-D grid
// whose y walks the tensor table and whose x is grid-stride over each tensor
// so neighbouring threads touch neighbouring addresses (coalesced), and no
// staging beyond the fusion buffer itself. Vectorised 16-byte access, TMA and
// persistent blocks are left for later.
//
// The table is a device int64 array of (pointer, numel, offset) rows filled by
// the Python wrapper; the kernel allocates nothing and does not synchronise.
// Plain C interface, loaded with ctypes; each entry point returns
// cudaGetLastError() after its launch.

#include <cuda_runtime.h>
#include <stdint.h>

#include "cvt.cuh"

namespace {

struct Entry {
  int64_t ptr;
  int64_t numel;
  int64_t offset;
};

constexpr int kThreads = 256;
constexpr int64_t kMaxGridY = 65535;

template <typename T, bool kPack>
__global__ void __launch_bounds__(kThreads)
scale_copy_kernel(const Entry* __restrict__ table, int64_t n_tensors, T* flat, float scale) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t j = blockIdx.y; j < n_tensors; j += gridDim.y) {
    const Entry e = table[j];
    T* tensor = reinterpret_cast<T*>(e.ptr);
    T* slot = flat + e.offset;
    for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < e.numel;
         i += stride) {
      if (kPack) {
        slot[i] = Cvt<T>::from_f32(__fmul_rn(Cvt<T>::to_f32(tensor[i]), scale));
      } else {
        tensor[i] = Cvt<T>::from_f32(__fmul_rn(Cvt<T>::to_f32(slot[i]), scale));
      }
    }
  }
}

template <bool kPack>
int launch(const void* table, int64_t n_tensors, int64_t blocks_x, void* flat, int dtype,
           float scale, cudaStream_t stream) {
  if (n_tensors <= 0 || blocks_x <= 0 || blocks_x > 0x7fffffff) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid(static_cast<unsigned>(blocks_x),
                  static_cast<unsigned>(n_tensors < kMaxGridY ? n_tensors : kMaxGridY));
  const Entry* t = static_cast<const Entry*>(table);
  switch (dtype) {
    case 0:
      scale_copy_kernel<float, kPack>
          <<<grid, kThreads, 0, stream>>>(t, n_tensors, static_cast<float*>(flat), scale);
      break;
    case 1:
      scale_copy_kernel<__half, kPack>
          <<<grid, kThreads, 0, stream>>>(t, n_tensors, static_cast<__half*>(flat), scale);
      break;
    case 2:
      scale_copy_kernel<__nv_bfloat16, kPack><<<grid, kThreads, 0, stream>>>(
          t, n_tensors, static_cast<__nv_bfloat16*>(flat), scale);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = float16, 2 = bfloat16. Returns a cudaError_t.
int hvd_scale_pack(const void* table, int64_t n_tensors, int64_t blocks_x, void* flat,
                   int dtype, float scale, void* stream) {
  return launch<true>(table, n_tensors, blocks_x, flat, dtype, scale,
                      static_cast<cudaStream_t>(stream));
}

int hvd_scale_unpack(const void* table, int64_t n_tensors, int64_t blocks_x, void* flat,
                     int dtype, float scale, void* stream) {
  return launch<false>(table, n_tensors, blocks_x, flat, dtype, scale,
                       static_cast<cudaStream_t>(stream));
}

}  // extern "C"
