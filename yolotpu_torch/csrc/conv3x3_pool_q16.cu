// conv3x3_pool_q16: exact int16 SAME 3x3/s1 convolution with the fused
// requant, followed by a darknet 2x2/s2 maxpool, in one pass: NHWC (B, H, W,
// C) int16 with H and W even -> (B, H/2, W/2, N) int16. The implicit GEMM of
// conv3x3_q16.cu with the output pixels visited window-major
// (loaders.cuh, ConvLoader<int16_t>): a thread's 8 accumulator rows
// are two whole pool windows, so the epilogue pools in registers, with no
// shuffles and no shared memory, and writes only the pooled rows
// (igemm.cuh, EpiPoolQ16).
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
// The three agree while acc + 2^(shift-1) does not wrap. The TPU kernels'
// space-to-depth patch packing, 8-pixel patch groups, p2 lane packing, hi/lo
// s8 planes and manual DMA bands were how they reached the s8 matrix unit
// with lanes full; none of it carries over.
//
// What bounds it on an H100: the 32-bit integer multiply-adds on the CUDA
// cores, as in conv3x3_q16.cu, with the same MACs; at C = 3 (the entry conv)
// the K = 27 taps are gathered one element at a time. What it saves is
// memory traffic: the full-resolution int16 conv output never reaches
// device memory (416*416*32*2 B = 11 MB per image at the entry conv), and
// neither does the separate pool's read of it.
#include "igemm.cuh"
#include "loaders.cuh"

template <int ORDER>
static cudaError_t launch(const void* x, const void* w, const void* bias, void* out, int B,
                          int H, int W, int C, int N, int shift, int leaky, void* stream) {
    const yq::ConvParams<int16_t> p{(const int16_t*)x, H, W, C, yq::vec_ok<int16_t>(x, C)};
    const yq::EpiPoolQ16<ORDER> e{(const int32_t*)bias, (int16_t*)out, shift, leaky};
    const long long M = (long long)B * H * W;
    return yq::launch_igemm<yq::ConvLoader<int16_t>>(p, w, e, M, N, 9 * C, stream);
}

// x (B, H, W, C) int16 with H and W even, w (3, 3, C, N) int16 (HWIO, read
// as (9C, N)), bias (N,) int32 -> out (B, H/2, W/2, N) int16, all contiguous
// on the current device; order 0, 1, 2 is kPoolAcc, kPoolAccH, kPoolOut.
// Returns cudaGetLastError() after the launch, or cudaErrorInvalidValue for
// an odd H or W or an unknown order.
extern "C" int yq16_conv3x3_pool(const void* x, const void* w, const void* bias, void* out,
                                 int B, int H, int W, int C, int N, int shift, int leaky,
                                 int order, void* stream) {
    if (H % 2 || W % 2) return (int)cudaErrorInvalidValue;
    switch (order) {
        case yq::kPoolAcc:
            return (int)launch<yq::kPoolAcc>(x, w, bias, out, B, H, W, C, N, shift, leaky,
                                             stream);
        case yq::kPoolAccH:
            return (int)launch<yq::kPoolAccH>(x, w, bias, out, B, H, W, C, N, shift, leaky,
                                              stream);
        case yq::kPoolOut:
            return (int)launch<yq::kPoolOut>(x, w, bias, out, B, H, W, C, N, shift, leaky,
                                             stream);
        default:
            return (int)cudaErrorInvalidValue;
    }
}
