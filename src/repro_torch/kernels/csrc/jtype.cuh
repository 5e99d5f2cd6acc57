// The element types J may be held in, shared by K1 and its ring mode
// (plateau.cu), K4 (plateau_pregen.cu) and K3 (field.cu).
//
// J reaches the kernels as the host rounded or wrapped it into its dtype
// (core/engine.py, _host_j): every value is an integer below 2^24 in
// magnitude, so widening it to float32 (K1, K1's ring mode, K4) or to int32
// (K3, which splits it into byte planes) is exact whatever the type.  The
// plateau kernels widen each value as it is loaded and do the same fmas for
// every type; K3 reads each value as an int32 and lets its plane count
// follow the values (a uint8 of 128-255 takes a u8 plane under a zero s8
// plane, as any |J| > 127 does).
//
// Every C entry point takes J's type as a Code; ssa_update._J_TYPES lists
// the torch dtypes in this order.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>
#include <type_traits>

namespace jtype {

enum Code : int { F32 = 0, BF16 = 1, F16 = 2, I8 = 3, U8 = 4, I16 = 5, I32 = 6 };

// A value of J as a float32 (exact: an integer below 2^24).
__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }
__device__ __forceinline__ float to_f32(int8_t x) { return static_cast<float>(x); }
__device__ __forceinline__ float to_f32(uint8_t x) { return static_cast<float>(x); }
__device__ __forceinline__ float to_f32(int16_t x) { return static_cast<float>(x); }
__device__ __forceinline__ float to_f32(int32_t x) { return static_cast<float>(x); }

// A value of J as an int32: the integer types sign- or zero-extended as
// their signedness says, the float types truncated (they hold integers).
template <typename T>
__device__ __forceinline__ int to_int(T x) {
  if constexpr (std::is_integral<T>::value) {
    return static_cast<int>(x);
  } else {
    return __float2int_rz(to_f32(x));
  }
}

// Four neighbouring values of J, one vector load of 4 * sizeof(T) bytes (16
// for the 4-byte types, 8 for the 2-byte ones, 4 for the bytes); p must be
// aligned to that.
template <typename T>
__device__ __forceinline__ void load4(const T* p, T (&v)[4]) {
  static_assert(sizeof(T) == 1 || sizeof(T) == 2 || sizeof(T) == 4, "a J type of 1, 2 or 4 B");
  if constexpr (sizeof(T) == 4) {
    const uint4 w = *reinterpret_cast<const uint4*>(p);
    memcpy(v, &w, sizeof(w));
  } else if constexpr (sizeof(T) == 2) {
    const uint2 w = *reinterpret_cast<const uint2*>(p);
    memcpy(v, &w, sizeof(w));
  } else {
    const uint32_t w = *reinterpret_cast<const uint32_t*>(p);
    memcpy(v, &w, sizeof(w));
  }
}

// The same four values as floats (0 when !ok).  float32 and bfloat16 have
// their own, branch-free forms (a bfloat16 widens by a shift).
template <typename T>
__device__ __forceinline__ void load4(const T* p, bool ok, float (&x)[4]) {
  if (!ok) {
    x[0] = x[1] = x[2] = x[3] = 0.f;
    return;
  }
  T v[4];
  load4(p, v);
#pragma unroll
  for (int i = 0; i < 4; ++i) x[i] = to_f32(v[i]);
}
__device__ __forceinline__ void load4(const float* p, bool ok, float (&x)[4]) {
  const float4 v = ok ? *reinterpret_cast<const float4*>(p) : make_float4(0.f, 0.f, 0.f, 0.f);
  x[0] = v.x; x[1] = v.y; x[2] = v.z; x[3] = v.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, bool ok, float (&x)[4]) {
  const uint2 v = ok ? *reinterpret_cast<const uint2*>(p) : make_uint2(0u, 0u);
  x[0] = __uint_as_float(v.x << 16);
  x[1] = __uint_as_float(v.x & 0xffff0000u);
  x[2] = __uint_as_float(v.y << 16);
  x[3] = __uint_as_float(v.y & 0xffff0000u);
}

// Vector loads of four neighbouring columns need N % 4 == 0 and rows
// aligned to 4 * sizeof(T) bytes.
template <typename T>
inline bool vector_loads(int N, const void* J) {
  return N % 4 == 0 && reinterpret_cast<uintptr_t>(J) % (4 * sizeof(T)) == 0;
}

template <typename T>
struct Tag {
  using type = T;
};

// f(Tag<T>{}) for the type of `code`; `invalid` for a code that is none.
template <typename R, typename F>
inline R dispatch(int code, R invalid, F&& f) {
  switch (code) {
    case F32: return f(Tag<float>{});
    case BF16: return f(Tag<__nv_bfloat16>{});
    case F16: return f(Tag<__half>{});
    case I8: return f(Tag<int8_t>{});
    case U8: return f(Tag<uint8_t>{});
    case I16: return f(Tag<int16_t>{});
    case I32: return f(Tag<int32_t>{});
    default: return invalid;
  }
}

}  // namespace jtype
