// mm_q16: exact int16 (M, K) @ (K, N) with the fused requant, for the 1x1
// convolutions of the int16 tier.
//
// Replaces yolotpu/ops/pallas_q16.py:matmul_q16_requant (kernel bodies
// _mm_kernel and _mm_kernel_pl). That kernel reached the TPU's s8 matrix
// unit by splitting each int16 operand into hi/lo s8 planes and recombining
// (hh << 16) + ((hl + lh) << 8) + ll + nconst; none of that is part of the
// function. This kernel computes the same sum directly: int16 x int16
// products accumulated in uint32 on the CUDA cores, which is the exact sum
// modulo 2^32, then requant_q16.
//
// What bounds it on an H100: 32-bit integer multiply-adds. The CUDA cores
// retire 64 of them per clock per SM, far below what the tensor cores
// deliver through s8 mma with the hi/lo split. The 128x64 tile with 32
// accumulators per thread keeps shared-memory traffic at 12 words per 32
// multiply-adds, so the multiply-adds and not the loads set the pace; the
// global reads of a 1x1 layer (x once per 64 output columns, w once per 128
// rows) are far below the 3.35 TB/s of device memory. Moving the products
// onto the tensor cores (s8 wgmma with the hi/lo split) is later work.
#include "igemm.cuh"
#include "loaders.cuh"

// x (M, K) int16, w (K, N) int16, bias (N,) int32 -> out (M, N) int16, all
// contiguous on the current device. Returns cudaGetLastError() after the
// launch.
extern "C" int yq16_mm(const void* x, const void* w, const void* bias, void* out,
                       int M, int K, int N, int shift, int leaky, void* stream) {
    const yq::MmParams<int16_t> p{(const int16_t*)x, K, yq::vec_ok<int16_t>(x, K)};
    const yq::EpiQ16 e{(const int32_t*)bias, (int16_t*)out, shift, leaky};
    return (int)yq::launch_igemm<yq::MmLoader<int16_t>>(p, w, e, M, N, K, stream);
}
