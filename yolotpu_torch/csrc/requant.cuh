// Requant epilogue shared by every kernel of csrc/ (through igemm_tc.cuh).
//
// The contract is the one of yolotpu/ops/pallas_q16.py:_requant32 and of the
// per-channel epilogues of pallas_matmul.py and pallas_q16.py's w8 kernels
// (round-half-up shift with its magnitude capped at 30, left shift for a
// negative shift, +bias, saturation to the output type, integer leaky v/10
// truncated toward zero), applied to an accumulator that holds the exact
// sum modulo 2^32.
//
// Signed overflow is undefined behaviour in C++, so every add or shift that
// can wrap runs on uint32_t, where wraparound is defined; only the final
// arithmetic right shift and the clamp run on int32_t.
#pragma once

#include <stdint.h>

namespace yq {

template <class T>
struct Range;
template <>
struct Range<int8_t> {
    static constexpr int lo = -128, hi = 127;
};
template <>
struct Range<int16_t> {
    static constexpr int lo = -32768, hi = 32767;
};

template <int LO, int HI>
__device__ __forceinline__ int32_t requant(uint32_t acc, int32_t bias, int shift,
                                           int leaky) {
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
    v = v < LO ? LO : (v > HI ? HI : v);
    if (leaky && v < 0) v = v / 10;  // C++ division truncates toward zero
    return v;
}

__device__ __forceinline__ int16_t requant_q16(uint32_t acc, int32_t bias, int shift,
                                               int leaky) {
    return (int16_t)requant<-32768, 32767>(acc, bias, shift, leaky);
}

}  // namespace yq
