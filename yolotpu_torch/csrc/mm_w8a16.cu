// mm_w8a16: int16 (M, K) @ int8 (K, N) with the fused per-channel requant
// to int16, for the 1x1 convolutions of the w8a16 tier.
//
// Replaces yolotpu/ops/pallas_matmul.py:matmul_w8a16_requant (:127, kernel
// body _mm_w8a16_kernel). That kernel split each int16 activation into s8
// planes xh = x >> 8 and xl = (x & 255) - 128, ran two s8 dots against one
// weight tile and added cw = 128 * sum(w): algebraically the same sum,
// sum((256 xh + xl + 128) w) = sum(x w), shaped for the TPU's s8 matrix
// unit. Here the int16 x int8 products go straight into the uint32
// accumulator; cw and the plane split do not exist. |x*w| <= 2^22, so with
// K up to 9*1280 a sum can leave int32: it wraps as uint32 does, which is
// the TPU kernel's int32 wraparound.
//
// What bounds it on an H100: 32-bit integer multiply-adds on the CUDA cores
// (64 per clock per SM), as in mm_q16.cu; the int8 weights halve the weight
// bytes and change nothing else. The s8 wgmma tensor cores (two activation
// planes against one weight plane, half the int16 tier's four) are later
// work.
#include "igemm.cuh"
#include "loaders.cuh"

// x (M, K) int16, w (K, N) int8, bias and shift (N,) int32 -> out (M, N)
// int16, all contiguous on the current device. Returns cudaGetLastError()
// after the launch.
extern "C" int yq8_mm_w8a16(const void* x, const void* w, const void* bias,
                            const void* shift, void* out, int M, int K, int N, int leaky,
                            void* stream) {
    const yq::MmParams<int16_t> p{(const int16_t*)x, K, yq::vec_ok<int16_t>(x, K)};
    const yq::EpiVec<int16_t> e{(const int32_t*)bias, (const int32_t*)shift,
                                (int16_t*)out, leaky};
    return (int)yq::launch_igemm<yq::MmLoader<int16_t>>(p, w, e, M, N, K, stream);
}
