// conv3x3_q16: exact int16 SAME 3x3/s1 convolution with the fused requant,
// NHWC activations, as an implicit GEMM: M = B*H*W output pixels,
// K = 9*C taps x input channels (tap-major, the HWIO weight order), N output
// channels. The im2col matrix is never stored: each A chunk is gathered
// from the input as it is copied to shared memory, SAME padding as zeros
// (igemm_tc.cuh, ConvTc).
//
// Replaces yolotpu/ops/pallas_q16.py:conv3x3_q16_flat (kernel bodies
// _convw_kernel / _convw_kernel_pl and _convf_kernel / _convf_kernel_pl) and
// its fallback conv3x3_q16_requant (_conv_kernel), which compute the same
// function. Their hi/lo s8 planes reached the TPU's s8 matrix unit; the
// same split reaches Hopper's integer wgmma here (s8 high bytes, u8 low
// bytes, three s32 partial sums recombined in uint32, no correction
// constant), while their lane padding, row padding, image groups and manual
// DMA bands do not carry over. One kernel also serves the C=3 entry
// convolution and the 208x208 / 104x104 layers that the TPU plan left to
// XLA.
//
// What bounds it on an H100: operations. An int16 product is four 8-bit
// products, and the 3x3 layers of yolov2 416 do 14.10 G MAC per frame:
// 4*MAC / 989.5e12 8-bit MAC/s is 0.456 ms at b=8, against 0.124 ms for
// their bytes at 3.35 TB/s. The design keeps the tensor cores fed from a
// 4-stage cp.async ring (one 16-byte copy per 8 channels of one tap; with
// C < 8, the entry layer, each kernel row's 3C contiguous values are
// gathered into the same tiles, and any other C that is not a multiple of 8
// is gathered value by value), reads A with ldmatrix and splits its bytes
// in registers for wgmma (m64n64k32, A from registers, B from shared
// memory in planes packed at model build), keeps three 64x64 blocks on each
// SM so that short-K blocks overlap, and splits K where the output tiles
// cannot fill the card (the 13x13 layers at b=1). TMA for B and keeping
// more than one wgmma group in flight are the next steps. The same conv
// fused with a following 2x2/s2 pool is conv3x3_pool_q16.cu, on the same
// body with a window-major loader and the pool in the epilogue.
#include "igemm_tc.cuh"

// x (B, H, W, C) int16, wp the packed planes of w (3, 3, C, N) read as
// (9C, N) (ops/q16.py: pack_q16), bias (N,) int32 -> out (B, H, W, N)
// int16, all contiguous on the current device; ws as launch_igemm_tc wants
// it. Returns cudaGetLastError() after the launch.
extern "C" int yq16_conv3x3(const void* x, const void* wp, const void* bias, void* out,
                            void* ws, int B, int H, int W, int C, int N, int shift, int leaky,
                            int ktiles_per_split, void* stream) {
    using Loader = yq::tc::ConvTc<int16_t>;
    const Loader::Params p{(const int16_t*)x, H, W, C, yq::tc::vec16(x, 2LL * C)};
    const yq::tc::EpiLayer e{(const int32_t*)bias, (int16_t*)out, shift, leaky};
    const long long M = (long long)B * H * W;
    return (int)yq::tc::launch_igemm_tc<yq::tc::Q16, Loader>(p, wp, e, ws, M, N, 9 * C,
                                                             ktiles_per_split, stream);
}
