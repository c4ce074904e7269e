// conv_w8a16: int16 activations x int8 weights, a convolution of any k x k
// size, stride and zero padding, with the fused per-channel requant to
// int16, NHWC: the w8a16 tier's general conv (a conv that is not a regular
// 1x1 or 3x3/s1). An implicit GEMM (M = B*Ho*Wo output pixels, K = k*k*C
// taps x input channels, tap-major, the HWIO weight order; N output
// channels) whose A operand is gathered from the input as it is copied to
// shared memory, padding as zeros (convk_tc.cuh: ConvRows), on the W8A16
// scheme and the per-channel epilogue of conv3x3_w8a16.cu.
//
// Replaces no Pallas kernel: the JAX package runs such a conv through XLA,
// the one s8 lax.conv_general_dilated over its batch-stacked high and
// (offset) low activation planes in convops.conv_w8a16
// (yolotpu/ops/convops.py:508), recombined with the cw column constant.
// Here the low byte stays unsigned and no constant is needed (as in
// conv3x3_w8a16.cu): the two s32 partial sums are recombined as (h << 8) + l
// in uint32, the exact sum modulo 2^32.
//
// What bounds it on an H100: bytes. An int16 x int8 product is two 8-bit
// tensor-core products: the five 3x3/s2 convs of yolov2-s2 416 do 1.99 G
// MAC per frame, 0.0322 ms at b=8 on 989.5e12 8-bit MAC/s, against 0.0650
// ms for their bytes at 3.35 TB/s (each of them bytes-bound, the first 5x).
// The first design (the regular convs' body with this loader) took 4.3x
// their bound, for the reasons conv_q16.cu gives; this one shares
// conv_q16's kernel (convk_tc.cuh: a persistent stream-K grid whose ring
// loads across tile boundaries, a 32-wide N tile where N <= 32, B by TMA
// bulk copy; two wgmma per 32 k; K past KMAX cut into segments).
#include "convk_tc.cuh"

// x (B, H, W, C) int16, wp the packed plane of w (k, k, C, N) int8 read as
// (k*k*C, N) (ops/q8.py: pack_w8a16), bias and shift (N,) int32 -> out
// (B, Ho, Wo, N) int16 with Ho = (H + 2 pad - k) / stride + 1 and Wo alike,
// all contiguous on the current device; the bm x bn tile, the grid, the
// share quantum and ws's slots as ops/tc.py's stream_k plans them (convk_tc.cuh: launch_tile).
// Returns cudaGetLastError() after the launch, or cudaErrorInvalidValue for
// a geometry with no output or a tile that is not built.
extern "C" int yq8_conv_w8a16(const void* x, const void* wp, const void* bias,
                              const void* shift, void* out, void* ws, int B, int H, int W,
                              int C, int N, int k, int stride, int pad, int leaky, int bm,
                              int bn, int grid, int quantum, int slots, void* stream) {
    using namespace yq::tc;
    if (k < 1 || stride < 1 || pad < 0 || H + 2 * pad < k || W + 2 * pad < k)
        return (int)cudaErrorInvalidValue;
    const int Ho = (H + 2 * pad - k) / stride + 1, Wo = (W + 2 * pad - k) / stride + 1;
    const yq::convk::Params<int16_t> p{(const int16_t*)x, H, W, C, k, stride, pad,
                                       Ho, Wo, vec16(x, 2LL * C)};
    const W8A16::Epi e{(const int32_t*)bias, (const int32_t*)shift, (int16_t*)out, leaky};
    const long long M = (long long)B * Ho * Wo;
    return (int)yq::convk::launch<W8A16>(bm, bn, p, wp, e, ws, M, N, k * k * C, grid, quantum, slots,
                                         stream);
}

// The W8A16 bm x bn tile as the wrappers must know it (convk_tc.cuh:
// config).
extern "C" int yq8_conv_w8a16_config(int bm, int bn, int what) {
    return yq::convk::config<yq::tc::W8A16>(bm, bn, what);
}
