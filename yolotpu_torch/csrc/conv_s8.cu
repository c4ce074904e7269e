// conv_s8: int8 convolution of any k x k size, stride and zero padding,
// with the fused per-channel requant, NHWC: the int8 (w8a8) tier's general
// conv (a conv that is not a regular 1x1 or 3x3/s1). The output is int8,
// or int16 for the conv that feeds the region head when it is not a 1x1
// (head16: the caller passes the shift minus 8 and the bias shifted left by
// 8, ops/convops.head16). An implicit GEMM (M = B*Ho*Wo output pixels,
// K = k*k*C taps x input channels, tap-major, the HWIO weight order; N
// output channels) whose A operand is gathered from the input as it is
// copied to shared memory, padding as zeros (convk_tc.cuh: ConvRows), on
// the S8 scheme (S8Out16 for the int16 output) and the per-channel
// epilogue of conv3x3_s8.cu.
//
// Replaces no Pallas kernel: the JAX package runs such a conv through XLA,
// the s8 lax.conv_general_dilated with int32 accumulation in
// convops.conv_int8 (yolotpu/ops/convops.py:572), whose head16 epilogue
// serves a head conv of any size.
//
// What bounds it on an H100: bytes. An s8 x s8 product is one 8-bit
// tensor-core product: the five 3x3/s2 convs of yolov2-s2 416 do 1.99 G
// MAC per frame, 0.0161 ms at b=8 on 989.5e12 8-bit MAC/s, against 0.0330
// ms for their int8 bytes at 3.35 TB/s. The first design (the regular
// convs' body with a general loader: one warpgroup loading and multiplying,
// 64 x 64 tiles, split-K) took 5.9x that bound. This one shares conv_q16's
// kernel (convk_tc.cuh): a producer warpgroup gathers A by cp.async (16
// channels of one tap a copy where C % 16 == 0, value by value otherwise)
// and copies B by TMA, consumers take int8 A straight from ldmatrix to four
// wgmma a K step of 128 k; a persistent stream-K grid, a 32-wide N tile
// where N <= 32, more blocks an SM than the int16 schemes (one s32 set);
// one s32 sum, exact for K <= 131072, a segment summing at most 32768
// values of k (K past KMAX adds the segments into a zeroed slot).
#include "convk_tc.cuh"

// x (B, H, W, C) int8, wp the packed plane of w (k, k, C, N) int8 read as
// (k*k*C, N) (ops/q8.py: pack_s8), bias and shift (N,) int32 -> out
// (B, Ho, Wo, N) int8, or int16 when out16 != 0, with
// Ho = (H + 2 pad - k) / stride + 1 and Wo alike, all contiguous on the
// current device; the bm x bn tile, the grid, the share quantum and ws's
// slots as ops/tc.py's stream_k plans them (convk_tc.cuh: launch_tile).
// Returns cudaGetLastError() after the launch, or cudaErrorInvalidValue for
// a geometry with no output or a tile that is not built.
extern "C" int yq8_conv_s8(const void* x, const void* wp, const void* bias, const void* shift,
                           void* out, void* ws, int B, int H, int W, int C, int N, int k,
                           int stride, int pad, int leaky, int out16, int bm, int bn, int grid,
                           int quantum, int slots, void* stream) {
    using namespace yq::tc;
    if (k < 1 || stride < 1 || pad < 0 || H + 2 * pad < k || W + 2 * pad < k)
        return (int)cudaErrorInvalidValue;
    const int Ho = (H + 2 * pad - k) / stride + 1, Wo = (W + 2 * pad - k) / stride + 1;
    const yq::convk::Params<int8_t> p{(const int8_t*)x, H, W, C, k, stride, pad,
                                      Ho, Wo, vec16(x, C)};
    const int32_t *b = (const int32_t*)bias, *s = (const int32_t*)shift;
    const long long M = (long long)B * Ho * Wo;
    if (out16) {
        const S8Out16::Epi e{b, s, (int16_t*)out, leaky};
        return (int)yq::convk::launch<S8Out16>(bm, bn, p, wp, e, ws, M, N, k * k * C, grid,
                                               quantum, slots, stream);
    }
    const S8::Epi e{b, s, (int8_t*)out, leaky};
    return (int)yq::convk::launch<S8>(bm, bn, p, wp, e, ws, M, N, k * k * C, grid, quantum,
                                      slots, stream);
}

// The S8 bm x bn tile as the wrappers must know it (convk_tc.cuh: config);
// what = 5, the blocks per SM the card keeps, of the two outputs' kernels
// the fewer.
extern "C" int yq8_conv_s8_config(int bm, int bn, int what) {
    const int v = yq::convk::config<yq::tc::S8>(bm, bn, what);
    if (what != 5) return v;
    const int v16 = yq::convk::config<yq::tc::S8Out16>(bm, bn, what);
    return v < v16 ? v : v16;
}
