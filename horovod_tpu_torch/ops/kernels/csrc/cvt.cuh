// Conversions between the port's element types and fp32, shared by the
// kernels in this directory: every kernel reads its inputs into fp32, does its
// arithmetic in fp32 and rounds once (to nearest) on the way out.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>

template <typename T>
struct Cvt;

template <>
struct Cvt<float> {
  __device__ static float to_f32(float x) { return x; }
  __device__ static float from_f32(float x) { return x; }
};

template <>
struct Cvt<__half> {
  __device__ static float to_f32(__half x) { return __half2float(x); }
  __device__ static __half from_f32(float x) { return __float2half_rn(x); }
};

template <>
struct Cvt<__nv_bfloat16> {
  __device__ static float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
  __device__ static __nv_bfloat16 from_f32(float x) { return __float2bfloat16_rn(x); }
};

// float64 is read into fp32 too (the Adasum combine computes in fp32 whatever
// its input, as the JAX package's adasum_combine does); widening back is exact.
template <>
struct Cvt<double> {
  __device__ static float to_f32(double x) { return __double2float_rn(x); }
  __device__ static double from_f32(float x) { return static_cast<double>(x); }
};
