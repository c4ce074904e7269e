// conv3x3_pool_s8: int8 SAME 3x3/s1 convolution with the fused per-channel
// requant to int8, followed by a darknet 2x2/s2 maxpool, in one pass: NHWC
// (B, H, W, C) int8 with H and W even -> (B, H/2, W/2, N) int8. The implicit
// GEMM of conv3x3_s8.cu on the 8-bit tensor cores (igemm_tc.cuh, the S8
// scheme: int8 A against one s8 weight plane, one s32 sum), with the output
// pixels visited window-major (ConvTc<int8_t, true>): rows 4i .. 4i+3 of M
// are the four members of pool window i, a 64-row tile holds 16 whole
// windows, and both exits of the epilogue (the staged tile of an unsplit
// block, the workspace of a split one) pool four rows of sums into one
// output row (EpiChannelPool, the scheme S8Pool).
//
// The pool is taken in darknet's order, as the int8 tier's unfused path
// takes it (conv3x3_s8, then ops/pool.py's maxpool): each member's sum is
// requantized with its column's bias and shift, leaky included, and the
// window's output is the max of the four int8 values. That is the unfused
// path bit for bit whatever the sums, wrapped ones included, so the tier's
// heads and tables stay equal to the JAX package's
// (yolotpu/models/yolov2.py: convops.conv_int8, then pool.maxpool), which
// has no fused int8 kind: the TPU ran these pools as XLA's reduce.
//
// What bounds it on an H100: operations, as in conv3x3_s8.cu (one 8-bit
// product per MAC), except at C = 3 (the entry conv), where one K step holds
// all 27 taps and the gather of the A tile by kernel rows sets the time. What
// the fusion saves is memory traffic and a pass: the full-resolution int8
// conv output never reaches device memory (416*416*32 B = 5.5 MB per image at
// the entry conv), and neither does the separate pool's read of it.
#include "igemm_tc.cuh"

// x (B, H, W, C) int8 with H and W even, wp the packed plane of w (3, 3, C,
// N) int8 read as (9C, N) (ops/q8.py: pack_s8, conv3x3_s8's), bias and shift
// (N,) int32 -> out (B, H/2, W/2, N) int8, all contiguous on the current
// device; ws as launch_igemm_tc wants it for M = B*H*W conv rows. Returns
// cudaGetLastError() after the launch, or cudaErrorInvalidValue for an odd
// H or W.
extern "C" int yq8_conv3x3_pool_s8(const void* x, const void* wp, const void* bias,
                                   const void* shift, void* out, void* ws, int B, int H,
                                   int W, int C, int N, int leaky, int ktiles_per_split,
                                   void* stream) {
    if (H % 2 || W % 2) return (int)cudaErrorInvalidValue;
    using Loader = yq::tc::ConvTc<int8_t, true>;
    const Loader::Params p{(const int8_t*)x, H, W, C, yq::tc::vec16(x, C)};
    const yq::tc::S8Pool::Epi e{(const int32_t*)bias, (const int32_t*)shift, (int8_t*)out,
                                leaky};
    const long long M = (long long)B * H * W;
    return (int)yq::tc::launch_igemm_tc<yq::tc::S8Pool, Loader>(p, wp, e, ws, M, N, 9 * C,
                                                                ktiles_per_split, stream);
}
