// The A-operand loader of igemm.cuh, for int16 activations.
//
//   ConvLoader<T>  A is the implicit im2col of a SAME 3x3/s1 window over NHWC
//                  activations, K = 9*C taps x channels, tap-major (the HWIO
//                  weight order), with the output pixels visited window-major
//                  for a conv followed by a 2x2/s2 pool (H and W even): row
//                  m = 4*((b*H/2 + ho)*W/2 + wo) + q is pixel (2*ho + q/2,
//                  2*wo + q%2), so rows 4i..4i+3 are the four members of pool
//                  window i; the matrix is never stored, each value is
//                  gathered while the tile loads, with SAME padding read as
//                  zeros (the 3x3 convs without a pool run on igemm_tc.cuh)
//
// Eight consecutive values are one vector load (16 bytes of int16) when the
// row length C is a multiple of 8 and the base pointer is aligned to the
// load; otherwise, as for the C=3 entry layer, each value is loaded on its
// own.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace yq {

// Eight int16 lanes of a 16-byte load, sign-extended to int32.
__device__ __forceinline__ void unpack8(const int4 q, int32_t v[8]) {
    const int32_t w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
        v[2 * j] = (int32_t)(int16_t)(w[j] & 0xFFFF);
        v[2 * j + 1] = w[j] >> 16;
    }
}

template <class T>
struct Vec8;  // the type of one load of eight T
template <>
struct Vec8<int16_t> {
    using type = int4;
};

template <class T>
__device__ __forceinline__ void load8_vec(const T* p, int32_t v[8]) {
    unpack8(__ldg(reinterpret_cast<const typename Vec8<T>::type*>(p)), v);
}

// Host side: whether rows of length n at base x take the vector loads.
template <class T>
inline int vec_ok(const void* x, int n) {
    return (n % 8 == 0 && ((uintptr_t)x % sizeof(typename Vec8<T>::type)) == 0) ? 1 : 0;
}

template <class T>
struct ConvParams {
    const T* x;  // (B, H, W, C) row-major
    int H, W, C;
    int vec;  // vec_ok<T>(x, C)
};

template <class T>
struct ConvLoader {
    using Params = ConvParams<T>;
    const T* img;  // this row's image
    int y, xw, H, W, C, K, vec;
    bool ok;

    __device__ ConvLoader(const Params& p, long long m, long long M)
        : H(p.H), W(p.W), C(p.C), K(9 * p.C), vec(p.vec), ok(m < M) {
        const long long hw = (long long)p.H * p.W;
        const long long mm = m < M ? m : 0;
        const int wo = p.W / 2;
        const long long win = mm >> 2;  // the pool window of row mm
        const int q = (int)(mm & 3);    // its member, 2 * dy + dx
        const long long b = win / (hw / 4);
        const int r = (int)(win - b * (hw / 4));
        const int ho = r / wo;
        y = 2 * ho + (q >> 1);
        xw = 2 * (r - ho * wo) + (q & 1);
        img = p.x + b * hw * p.C;
    }

    __device__ __forceinline__ int32_t at(int k) const {
        const int tap = k / C;
        const int c = k - tap * C;
        const int iy = y + tap / 3 - 1, ix = xw + tap % 3 - 1;
        if (iy < 0 || iy >= H || ix < 0 || ix >= W) return 0;
        return img[((long long)iy * W + ix) * C + c];
    }

    __device__ __forceinline__ void load8(int k0, int32_t v[8]) const {
        if (vec) {
#pragma unroll
            for (int j = 0; j < 8; ++j) v[j] = 0;
            if (!ok || k0 >= K) return;
            // C % 8 == 0: the eight values share one tap, and c is a
            // multiple of 8, so the load is aligned
            const int tap = k0 / C;
            const int c = k0 - tap * C;
            const int iy = y + tap / 3 - 1, ix = xw + tap % 3 - 1;
            if (iy < 0 || iy >= H || ix < 0 || ix >= W) return;
            load8_vec(img + ((long long)iy * W + ix) * C + c, v);
            return;
        }
#pragma unroll
        for (int j = 0; j < 8; ++j) {
            const int k = k0 + j;
            v[j] = (ok && k < K) ? at(k) : 0;
        }
    }
};

}  // namespace yq
