// conv3x3_s8: int8 SAME 3x3/s1 convolution with the fused per-channel
// requant to int8, NHWC activations, for the 3x3 convolutions of the int8
// (w8a8) tier. An implicit GEMM (M = B*H*W, K = 9*C, N output channels)
// whose A operand is gathered from the input while the tile loads, with
// SAME padding read as zeros (loaders.cuh, ConvLoader<int8_t>).
//
// Replaces yolotpu/ops/pallas_q16.py:conv3x3_s8_wi (:953, kernel body
// _convw_s8_kernel), the weight-resident s8 conv that the JAX model ran
// only under YOLO2_INT8_CONV3_WI=1, and the XLA s8 convolution it ran
// otherwise, which compute the same function. The TPU kernel's lane-padded
// channels, W2a row padding and VMEM bands do not carry over. One kernel
// serves every 3x3 conv of the tier: the C=3 entry layer (its rows of 3
// bytes are not aligned for vector loads and take the per-element path)
// and the 208x208 / 104x104 layers included.
//
// What bounds it on an H100: 32-bit integer multiply-adds on the CUDA cores
// (64 per clock per SM), through the tiled body of igemm.cuh; with C % 8 ==
// 0 a thread's eight A values are one 8-byte load. |x*w| <= 2^14 and
// K <= 9*1280 keep every sum inside int32. __dp4a (four s8 products per
// instruction) and the s8 wgmma tensor cores are later work.
#include "igemm.cuh"
#include "loaders.cuh"

// x (B, H, W, C) int8, w (3, 3, C, N) int8 (HWIO, read as (9C, N)), bias
// and shift (N,) int32 -> out (B, H, W, N) int8, all contiguous on the
// current device. Returns cudaGetLastError() after the launch.
extern "C" int yq8_conv3x3_s8(const void* x, const void* w, const void* bias,
                              const void* shift, void* out, int B, int H, int W, int C,
                              int N, int leaky, void* stream) {
    const yq::ConvParams<int8_t> p{(const int8_t*)x, H, W, C, yq::vec_ok<int8_t>(x, C)};
    const yq::EpiVec<int8_t> e{(const int32_t*)bias, (const int32_t*)shift, (int8_t*)out,
                               leaky};
    const long long M = (long long)B * H * W;
    return (int)yq::launch_igemm<yq::ConvLoader<int8_t>>(p, w, e, M, N, 9 * C, stream);
}
