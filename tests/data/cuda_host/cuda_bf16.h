// Host stand-in for cuda_bf16.h (see cuda_runtime.h beside it): bfloat16
// round to nearest even through the float's bits.
#pragma once
#include <cstdint>
#include <cstring>

struct __nv_bfloat16 {
  uint16_t x;
};
inline float __bfloat162float(__nv_bfloat16 v) {
  uint32_t u = (uint32_t)v.x << 16;
  float f;
  std::memcpy(&f, &u, 4);
  return f;
}
inline __nv_bfloat16 __float2bfloat16_rn(float f) {
  uint32_t u;
  std::memcpy(&u, &f, 4);
  u += 0x7FFFu + ((u >> 16) & 1u);
  return __nv_bfloat16{(uint16_t)(u >> 16)};
}
