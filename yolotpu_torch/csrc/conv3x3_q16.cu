// conv3x3_q16: exact int16 SAME 3x3/s1 convolution with the fused requant,
// NHWC activations, as an implicit GEMM: M = B*H*W output pixels,
// K = 9*C taps x input channels (tap-major, the HWIO weight order), N output
// channels. The im2col matrix is never stored: each A value is gathered from
// the input while the tile loads, with SAME padding read as zeros.
//
// Replaces yolotpu/ops/pallas_q16.py:conv3x3_q16_flat (kernel bodies
// _convw_kernel / _convw_kernel_pl and _convf_kernel / _convf_kernel_pl) and
// its fallback conv3x3_q16_requant (_conv_kernel), which compute the same
// function. Their hi/lo s8 planes, lane padding, row padding, image groups
// and manual DMA bands were how the TPU's s8 matrix unit was reached; here
// the int16 x int16 products accumulate in uint32 on the CUDA cores (the
// exact sum modulo 2^32), then requant_q16. One kernel also serves the C=3
// entry convolution and the 208x208 / 104x104 layers that the TPU plan left
// to XLA.
//
// What bounds it on an H100: 32-bit integer multiply-adds on the CUDA cores
// (64 per clock per SM), as in mm_q16.cu. The gather costs one division per
// thread per K step when C % 8 == 0 (the 8 values a thread loads share one
// tap and are one 16-byte load); only the C=3 entry layer takes the
// per-element path, and its K of 27 makes that a small share of the network.
// Tensor cores (s8 wgmma with the hi/lo split), TMA and a fused 2x2 pool are
// later work.
#include "igemm_q16.cuh"

namespace yq16 {

struct ConvParams {
    const int16_t* x;  // (B, H, W, C) row-major
    int H, W, C;
    int vec;  // C % 8 == 0 and x 16-byte aligned: 16-byte loads
};

struct ConvLoader {
    using Params = ConvParams;
    const int16_t* img;  // this row's image
    int y, xw, H, W, C, K, vec;
    bool ok;

    __device__ ConvLoader(const Params& p, long long m, long long M)
        : H(p.H), W(p.W), C(p.C), K(9 * p.C), vec(p.vec), ok(m < M) {
        const long long hw = (long long)p.H * p.W;
        const long long mm = m < M ? m : 0;
        const long long b = mm / hw;
        const int r = (int)(mm - b * hw);
        y = r / p.W;
        xw = r - y * p.W;
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
            const int tap = k0 / C;
            const int c = k0 - tap * C;
            const int iy = y + tap / 3 - 1, ix = xw + tap % 3 - 1;
            if (iy < 0 || iy >= H || ix < 0 || ix >= W) return;
            unpack8(__ldg(reinterpret_cast<const int4*>(
                        img + ((long long)iy * W + ix) * C + c)),
                    v);
            return;
        }
#pragma unroll
        for (int j = 0; j < 8; ++j) {
            const int k = k0 + j;
            v[j] = (ok && k < K) ? at(k) : 0;
        }
    }
};

}  // namespace yq16

// x (B, H, W, C) int16, w (3, 3, C, N) int16 (HWIO, read as (9C, N)),
// bias (N,) int32 -> out (B, H, W, N) int16, all contiguous on the current
// device. Returns cudaGetLastError() after the launch.
extern "C" int yq16_conv3x3(const void* x, const void* w, const void* bias, void* out,
                            int B, int H, int W, int C, int N, int shift, int leaky,
                            void* stream) {
    const yq16::ConvParams p{(const int16_t*)x, H, W, C,
                             (C % 8 == 0 && ((uintptr_t)x % 16) == 0) ? 1 : 0};
    const long long M = (long long)B * H * W;
    return (int)yq16::launch_igemm_q16<yq16::ConvLoader>(p, w, bias, out, M, N, 9 * C,
                                                         shift, leaky, stream);
}
