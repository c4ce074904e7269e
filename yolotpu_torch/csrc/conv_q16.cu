// conv_q16: exact int16 convolution of any k x k size, stride and zero
// padding, with the fused requant, NHWC activations: the int16 tier's
// general conv (a conv that is not a regular 1x1 or 3x3/s1: strided,
// 2x2, 5x5, 7x7, VALID or an explicit padding=). An implicit GEMM:
// M = B*Ho*Wo output pixels, K = k*k*C taps x input channels (tap-major,
// the HWIO weight order), N output channels; the im2col matrix is never
// stored, each A chunk is gathered from the input as it is copied to shared
// memory, padding and windows past the edge as zeros (convk_tc.cuh:
// ConvRows), on the Q16 scheme and the per-layer epilogue (EpiLayer) of
// conv3x3_q16.cu.
//
// Replaces no Pallas kernel: the JAX package runs such a conv through XLA,
// lax.conv_general_dilated with int32 accumulation in convops.conv_int16
// (yolotpu/ops/convops.py:170, the engine kind "xla"), in
// convops.conv_int16_dec8 as two s8 convs (:421, :424, kind "xla8") and in
// convops.conv_int16_nchw (:208, kind "nchw"), all of which compute this
// function: the exact sum modulo 2^32, then the requant chain.
//
// What bounds it on an H100: bytes or operations, by the layer. An int16
// product is four 8-bit tensor-core products. The five 3x3/s2 convs of
// yolov2-s2 416 (yolov2 with each 2x2/s2 maxpool a 3x3/s2 conv of the same
// width) do 1.99 G MAC per frame: 0.0645 ms at b=8 on 989.5e12 8-bit MAC/s,
// against 0.0659 ms for their bytes (int16 in and out, weights once) at
// 3.35 TB/s; the first (416x416x32) is bytes-bound 2.6x, the last
// (26x26x512) operations-bound 3.7x. The first design (the regular convs'
// body with this loader) took 4.1x their bound: half of each 64-wide tile
// empty at N = 32, a block of 4.5 K steps that stops with its ring still
// filling, grids of 0.86 to 1.7 waves and split-K. This design
// (convk_tc.cuh) runs a persistent stream-K grid whose ring loads across
// tile boundaries, a 32-wide N tile where N <= 32, and B by TMA bulk copy;
// K past KMAX (a 7x7 conv over 1024 channels, K = 50,176) cuts a tile's
// segments at KMAX.
#include "convk_tc.cuh"

// x (B, H, W, C) int16, wp the packed planes of w (k, k, C, N) read as
// (k*k*C, N) (ops/q16.py: pack_q16), bias (N,) int32 -> out (B, Ho, Wo, N)
// int16 with Ho = (H + 2 pad - k) / stride + 1 and Wo alike, all contiguous
// on the current device; the bm x bn tile, the grid, the share quantum and
// ws's slots as
// ops/tc.py's stream_k plans them (convk_tc.cuh: launch_tile). Returns
// cudaGetLastError() after the launch, or cudaErrorInvalidValue for a
// geometry with no output or a tile that is not built.
extern "C" int yq16_conv(const void* x, const void* wp, const void* bias, void* out, void* ws,
                         int B, int H, int W, int C, int N, int k, int stride, int pad,
                         int shift, int leaky, int bm, int bn, int grid, int quantum, int slots,
                         void* stream) {
    using namespace yq::tc;
    if (k < 1 || stride < 1 || pad < 0 || H + 2 * pad < k || W + 2 * pad < k)
        return (int)cudaErrorInvalidValue;
    const int Ho = (H + 2 * pad - k) / stride + 1, Wo = (W + 2 * pad - k) / stride + 1;
    const yq::convk::Params<int16_t> p{(const int16_t*)x, H, W, C, k, stride, pad,
                                       Ho, Wo, vec16(x, 2LL * C)};
    const EpiLayer e{(const int32_t*)bias, (int16_t*)out, shift, leaky};
    const long long M = (long long)B * Ho * Wo;
    return (int)yq::convk::launch<Q16>(bm, bn, p, wp, e, ws, M, N, k * k * C, grid, quantum, slots,
                                       stream);
}

// The Q16 bm x bn tile as the wrappers must know it (convk_tc.cuh: config).
extern "C" int yq16_conv_config(int bm, int bn, int what) {
    return yq::convk::config<yq::tc::Q16>(bm, bn, what);
}
