// conv3x3_q16: exact int16 SAME 3x3/s1 convolution with the fused requant,
// NHWC activations, as an implicit GEMM: M = B*H*W output pixels,
// K = 9*C taps x input channels (tap-major, the HWIO weight order), N output
// channels. The im2col matrix is never stored: each A value is gathered from
// the input while the tile loads, with SAME padding read as zeros
// (loaders.cuh, ConvLoader).
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
// Tensor cores (s8 wgmma with the hi/lo split) and TMA are later work; the
// same conv fused with a following 2x2/s2 pool is conv3x3_pool_q16.cu.
#include "igemm.cuh"
#include "loaders.cuh"

// x (B, H, W, C) int16, w (3, 3, C, N) int16 (HWIO, read as (9C, N)),
// bias (N,) int32 -> out (B, H, W, N) int16, all contiguous on the current
// device. Returns cudaGetLastError() after the launch.
extern "C" int yq16_conv3x3(const void* x, const void* w, const void* bias, void* out,
                            int B, int H, int W, int C, int N, int shift, int leaky,
                            void* stream) {
    const yq::ConvParams<int16_t> p{(const int16_t*)x, H, W, C, yq::vec_ok<int16_t>(x, C)};
    const yq::EpiQ16 e{(const int32_t*)bias, (int16_t*)out, shift, leaky};
    const long long M = (long long)B * H * W;
    return (int)yq::launch_igemm<yq::ConvLoader<int16_t>>(p, w, e, M, N, 9 * C, stream);
}
