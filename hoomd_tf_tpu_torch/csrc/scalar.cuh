// The scalar type of the port's kernels: every kernel is a template on T,
// float or double, instantiated for both (the state's dtype picks one at
// the launch). The helpers below name the IEEE operation each kernel needs
// once for both types, so that a kernel's arithmetic reads the same in
// float32 and float64 and rounds as its PyTorch plain version does:
//   add_rn/sub_rn/mul_rn/div_rn  __fadd_rn ... (float), __dadd_rn ... (double)
//   rint_, fmin_, fmax_, fabs_   rintf/rint, fminf/fmin, ...
//   pack_type/unpack_type        an int32 type carried in a float lane:
//                                its bits (float), its bits widened (double)
// Vec4<T> is float4's layout for float (16 bytes) and four doubles for
// double (32 bytes, 16-byte aligned: two 128-bit accesses).

#pragma once

#include <cuda_runtime.h>

namespace htf {

template <class T>
struct alignas(16) Vec4 {
  T x, y, z, w;
};

template <class T>
struct Vec3 {
  T x, y, z;
};

template <class T>
__device__ __forceinline__ Vec4<T> vec4(T x, T y, T z, T w) {
  Vec4<T> v;
  v.x = x;
  v.y = y;
  v.z = z;
  v.w = w;
  return v;
}

__device__ __forceinline__ float add_rn(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ double add_rn(double a, double b) {
  return __dadd_rn(a, b);
}
__device__ __forceinline__ float sub_rn(float a, float b) {
  return __fsub_rn(a, b);
}
__device__ __forceinline__ double sub_rn(double a, double b) {
  return __dsub_rn(a, b);
}
__device__ __forceinline__ float mul_rn(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ double mul_rn(double a, double b) {
  return __dmul_rn(a, b);
}
__device__ __forceinline__ float div_rn(float a, float b) {
  return __fdiv_rn(a, b);
}
__device__ __forceinline__ double div_rn(double a, double b) {
  return __ddiv_rn(a, b);
}
__device__ __forceinline__ float rint_(float a) { return rintf(a); }
__device__ __forceinline__ double rint_(double a) { return rint(a); }
__device__ __forceinline__ float fmin_(float a, float b) {
  return fminf(a, b);
}
__device__ __forceinline__ double fmin_(double a, double b) {
  return fmin(a, b);
}
__device__ __forceinline__ float fmax_(float a, float b) {
  return fmaxf(a, b);
}
__device__ __forceinline__ double fmax_(double a, double b) {
  return fmax(a, b);
}
__device__ __forceinline__ float fabs_(float a) { return fabsf(a); }
__device__ __forceinline__ double fabs_(double a) { return fabs(a); }
__device__ __forceinline__ float copysign_(float a, float b) {
  return copysignf(a, b);
}
__device__ __forceinline__ double copysign_(double a, double b) {
  return copysign(a, b);
}

template <class T>
__device__ __forceinline__ T inf_();
template <>
__device__ __forceinline__ float inf_<float>() {
  return __int_as_float(0x7f800000);
}
template <>
__device__ __forceinline__ double inf_<double>() {
  return __longlong_as_double(0x7ff0000000000000LL);
}

template <class T>
__device__ __forceinline__ T pack_type(int t);
template <>
__device__ __forceinline__ float pack_type<float>(int t) {
  return __int_as_float(t);
}
template <>
__device__ __forceinline__ double pack_type<double>(int t) {
  return __longlong_as_double(static_cast<long long>(t));
}
__device__ __forceinline__ int unpack_type(float w) {
  return __float_as_int(w);
}
__device__ __forceinline__ int unpack_type(double w) {
  return static_cast<int>(__double_as_longlong(w));
}

// A kernel's dynamic shared memory, as a T array (one declaration for
// every instantiation).
template <class T>
__device__ __forceinline__ T* dynamic_smem() {
  extern __shared__ __align__(16) unsigned char htf_dynamic_smem[];
  return reinterpret_cast<T*>(htf_dynamic_smem);
}

}  // namespace htf
