// conv3x3_pool_q16: exact int16 SAME 3x3/s1 convolution with the fused
// requant, followed by a darknet 2x2/s2 maxpool, in one pass: NHWC (B, H, W,
// C) int16 with H and W even -> (B, H/2, W/2, N) int16. The implicit GEMM of
// conv3x3_q16.cu on the 8-bit tensor cores (igemm_tc.cuh, the Q16 scheme:
// s8 high and u8 low bytes, three s32 partial sums recombined in uint32),
// with the output pixels visited window-major (ConvTc<int16_t, true>): rows
// 4i .. 4i+3 of M are the four members of pool window i, a 64-row tile holds
// 16 whole windows, and both exits of the epilogue (the staged tile of an
// unsplit block, the workspace of a split one) pool four rows of sums into
// one output row (EpiPool).
//
// Replaces the fused conv+pool kinds of the TPU engine plan, which differ in
// where the pool's max is taken, one instantiation per order:
//   kPoolAcc   the max of the four int32 accumulators, then the requant:
//              yolotpu/ops/pallas_q16.py:entry_sdmm_forward (:1857, body
//              _mm_kernel_pool4) and the XLA kinds entry_sd, entry_s2d and
//              sd_pool (convops.py:239, :328, :274)
//   kPoolAccH  the max of each horizontal pair on the accumulator, the
//              requant, then the max of the vertical pair: entryf_forward
//              (:1377) and entry8_conv_pool_q16 / entry8_forward (:1204,
//              :1261)
//   kPoolOut   the requant of each member, then the max (conv-then-pool):
//              conv3x3p2_q16_requant (:417) and its flat-band form
//              conv3x3p2f_q16_requant (:1521) under maxpool2x2_p2
// The three agree while acc + 2^(shift-1) does not wrap; every max of sums is
// a signed int32 max of the wrapped values. The TPU kernels' space-to-depth
// patch packing, 8-pixel patch groups, p2 lane packing, balanced hi/lo s8
// planes and manual DMA bands were how they reached the s8 matrix unit with
// lanes full; none of it carries over.
//
// What bounds it on an H100: operations, as in conv3x3_q16.cu (four 8-bit
// products per int16 MAC on the tensor cores), except at C = 3 (the entry
// conv), where one K step holds all 27 taps and the gather of the A tile by
// kernel rows sets the time. What the fusion saves is memory traffic: the
// full-resolution int16 conv output never reaches device memory (416*416*32*2
// B = 11 MB per image at the entry conv), and neither does the separate
// pool's read of it.
#include "igemm_tc.cuh"

template <int ORDER>
static cudaError_t launch(const void* x, const void* wp, const void* bias, void* out, void* ws,
                          int B, int H, int W, int C, int N, int shift, int leaky,
                          int ktiles_per_split, void* stream) {
    using Loader = yq::tc::ConvTc<int16_t, true>;
    const typename Loader::Params p{(const int16_t*)x, H, W, C, yq::tc::vec16(x, 2LL * C)};
    const yq::tc::EpiPool<ORDER> e{(const int32_t*)bias, (int16_t*)out, shift, leaky};
    const long long M = (long long)B * H * W;
    return yq::tc::launch_igemm_tc<yq::tc::Q16Pool<ORDER>, Loader>(
        p, wp, e, ws, M, N, 9 * C, ktiles_per_split, stream);
}

// x (B, H, W, C) int16 with H and W even, wp the packed planes of w (3, 3,
// C, N) read as (9C, N) (ops/q16.py: pack_q16), bias (N,) int32 -> out (B,
// H/2, W/2, N) int16, all contiguous on the current device; ws as
// launch_igemm_tc wants it for M = B*H*W conv rows; order 0, 1, 2 is
// kPoolAcc, kPoolAccH, kPoolOut. Returns cudaGetLastError() after the
// launch, or cudaErrorInvalidValue for an odd H or W or an unknown order.
extern "C" int yq16_conv3x3_pool(const void* x, const void* wp, const void* bias, void* out,
                                 void* ws, int B, int H, int W, int C, int N, int shift,
                                 int leaky, int order, int ktiles_per_split, void* stream) {
    using namespace yq::tc;
    if (H % 2 || W % 2) return (int)cudaErrorInvalidValue;
    switch (order) {
        case kPoolAcc:
            return (int)launch<kPoolAcc>(x, wp, bias, out, ws, B, H, W, C, N, shift, leaky,
                                         ktiles_per_split, stream);
        case kPoolAccH:
            return (int)launch<kPoolAccH>(x, wp, bias, out, ws, B, H, W, C, N, shift, leaky,
                                          ktiles_per_split, stream);
        case kPoolOut:
            return (int)launch<kPoolOut>(x, wp, bias, out, ws, B, H, W, C, N, shift, leaky,
                                         ktiles_per_split, stream);
        default:
            return (int)cudaErrorInvalidValue;
    }
}
