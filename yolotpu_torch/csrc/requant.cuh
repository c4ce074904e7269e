// Requant epilogue shared by the int16-exact kernels (mm_q16.cu,
// conv3x3_q16.cu).
//
// The contract is the one of yolotpu/ops/pallas_q16.py:_requant32
// (round-half-up shift with its magnitude capped at 30, +bias, saturation to
// int16, integer leaky v/10 truncated toward zero), applied to an
// accumulator that holds the exact int16 x int16 sum modulo 2^32.
//
// Signed overflow is undefined behaviour in C++, so every add or shift that
// can wrap runs on uint32_t, where wraparound is defined; only the final
// arithmetic right shift and the clamp run on int32_t.
#pragma once

#include <stdint.h>

namespace yq16 {

__device__ __forceinline__ int16_t requant_q16(uint32_t acc, int32_t bias,
                                               int shift, int leaky) {
    int32_t a;
    if (shift > 0) {
        const int m = shift < 30 ? shift : 30;
        a = (int32_t)(acc + (1u << (m - 1))) >> m;
    } else if (shift < 0) {
        const int m = -shift < 30 ? -shift : 30;
        a = (int32_t)(acc << m);
    } else {
        a = (int32_t)acc;
    }
    int32_t v = (int32_t)((uint32_t)a + (uint32_t)bias);
    v = v < -32768 ? -32768 : (v > 32767 ? 32767 : v);
    if (leaky && v < 0) v = v / 10;  // C++ division truncates toward zero
    return (int16_t)v;
}

}  // namespace yq16
