// conv3x3_w8a16: int16 activations x int8 weights, SAME 3x3/s1, with the
// fused per-channel requant to int16, NHWC, for the 3x3 convolutions of the
// w8a16 tier. An implicit GEMM (M = B*H*W, K = 9*C, N output channels)
// whose A operand is gathered from the input while the tile loads, with
// SAME padding read as zeros (loaders.cuh, ConvLoader<int16_t>).
//
// Replaces yolotpu/ops/pallas_q16.py:conv3x3_w8a16_wi (:1048, kernel body
// _convw_w8_kernel) and the XLA plane-stacked conv the JAX model fell back
// to (the C=3 entry layer, and where no VMEM band fit). The TPU kernel
// split each activation into s8 planes, xh = x >> 8 and xl = (x & 255) -
// 128, and added nconst = 128 * sum(w) per column; a SAME zero encodes as
// (0, -128), and nconst cancels it. All of that reaches the same sum as
// multiplying int16 by int8 directly, which this kernel does into a uint32
// accumulator. |x*w| <= 2^22, so a sum over K up to 9*1280 can leave int32:
// it wraps as uint32 does, which is the TPU kernel's int32 wraparound.
//
// What bounds it on an H100: 32-bit integer multiply-adds on the CUDA cores
// (64 per clock per SM), as in conv3x3_q16.cu; the int8 weights halve the
// weight bytes and change nothing else. The s8 wgmma tensor cores (two
// activation planes against one weight plane) are later work.
#include "igemm.cuh"
#include "loaders.cuh"

// x (B, H, W, C) int16, w (3, 3, C, N) int8 (HWIO, read as (9C, N)), bias
// and shift (N,) int32 -> out (B, H, W, N) int16, all contiguous on the
// current device. Returns cudaGetLastError() after the launch.
extern "C" int yq8_conv3x3_w8a16(const void* x, const void* w, const void* bias,
                                 const void* shift, void* out, int B, int H, int W, int C,
                                 int N, int leaky, void* stream) {
    const yq::ConvParams<int16_t> p{(const int16_t*)x, H, W, C, yq::vec_ok<int16_t>(x, C)};
    const yq::EpiVec<int16_t> e{(const int32_t*)bias, (const int32_t*)shift,
                                (int16_t*)out, leaky};
    const long long M = (long long)B * H * W;
    return (int)yq::launch_igemm<yq::ConvLoader<int16_t>>(p, w, e, M, N, 9 * C, stream);
}
