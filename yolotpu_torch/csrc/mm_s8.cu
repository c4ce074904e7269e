// mm_s8: int8 (M, K) @ int8 (K, N) with the fused per-channel requant, for
// the 1x1 convolutions of the int8 (w8a8) tier. The output is int8, or int16
// for the conv that feeds the region head (head16: the caller passes the
// shift minus 8 and the bias shifted left by 8).
//
// Replaces yolotpu/ops/pallas_matmul.py:matmul_int8_requant (:186) and
// matmul_int16_out_requant (:199), both through _matmul_requant (:208) and
// the kernel bodies _mm_requant_kernel / _mm_requant_kernel_vshift. Those
// took a scalar or a vector shift; here a per-layer shift arrives broadcast
// to an (N,) vector, so one epilogue serves both. The TPU wrapper padded M
// to its tile and asked K and N to be multiples of 128; this kernel masks
// its ragged edges and takes every shape of the graph, the head's N=425
// included, which the JAX model sent to XLA.
//
// What bounds it on an H100: the same 32-bit integer multiply-adds on the
// CUDA cores as mm_q16.cu (64 per clock per SM), through the same tiled
// body (igemm.cuh). |x*w| <= 2^14 and K <= 9*1280, so no sum can wrap; the
// accumulator is uint32 all the same. The int8 operands halve the global
// reads of the int16 tier and change nothing else. Four products per
// instruction with __dp4a, or the s8 wgmma tensor cores, are later work.
#include "igemm.cuh"
#include "loaders.cuh"

// x (M, K) int8, w (K, N) int8, bias and shift (N,) int32 -> out (M, N)
// int8, or int16 when out16 != 0; all contiguous on the current device.
// Returns cudaGetLastError() after the launch.
extern "C" int yq8_mm_s8(const void* x, const void* w, const void* bias,
                         const void* shift, void* out, int M, int K, int N, int leaky,
                         int out16, void* stream) {
    const yq::MmParams<int8_t> p{(const int8_t*)x, K, yq::vec_ok<int8_t>(x, K)};
    if (out16) {
        const yq::EpiVec<int16_t> e{(const int32_t*)bias, (const int32_t*)shift,
                                    (int16_t*)out, leaky};
        return (int)yq::launch_igemm<yq::MmLoader<int8_t>>(p, w, e, M, N, K, stream);
    }
    const yq::EpiVec<int8_t> e{(const int32_t*)bias, (const int32_t*)shift, (int8_t*)out,
                               leaky};
    return (int)yq::launch_igemm<yq::MmLoader<int8_t>>(p, w, e, M, N, K, stream);
}
