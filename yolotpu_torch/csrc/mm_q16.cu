// mm_q16: exact int16 (M, K) @ (K, N) with the fused requant, for the 1x1
// convolutions of the int16 tier.
//
// Replaces yolotpu/ops/pallas_q16.py:matmul_q16_requant (kernel bodies
// _mm_kernel and _mm_kernel_pl). That kernel reached the TPU's s8 matrix
// unit by splitting each int16 operand into hi/lo s8 planes with a balanced
// or offset weight encoding and an nconst column constant. Here the same
// idea meets Hopper's integer wgmma, which takes u8 and s8 operands in any
// pairing: the low bytes stay unsigned and no constant is needed
// (igemm_tc.cuh). The result is the exact sum modulo 2^32, then
// requant_q16.
//
// What bounds it on an H100: an int16 product is four 8-bit products, so
// the tensor-core bound is 4*MAC / 989.5e12 8-bit MAC/s; for the 1x1
// layers of yolov2 416 that is below the time to move their bytes (each
// int16 input and output once, the weights once: 88.5 MB at b=8, 0.026 ms
// at 3.35 TB/s), so the bytes bound it. The design moves each operand once
// per tile through a cp.async ring, keeps the three s32 partial-sum sets in
// registers, and writes each output once as 16-byte stores; for the 13x13
// layers at b=1, whose few output tiles cannot fill 132 SMs, it splits K.
#include "igemm_tc.cuh"

// x (M, K) int16, wp the packed weight planes (ops/q16.py: pack_q16),
// bias (N,) int32 -> out (M, N) int16, all contiguous on the current
// device; ws as launch_igemm_tc wants it. Returns cudaGetLastError() after
// the launch.
extern "C" int yq16_mm(const void* x, const void* wp, const void* bias, void* out, void* ws,
                       int M, int K, int N, int shift, int leaky, int ktiles_per_split,
                       void* stream) {
    using Loader = yq::tc::MmTc<int16_t>;
    const Loader::Params p{(const int16_t*)x, K, yq::tc::vec16(x, 2LL * K)};
    const yq::tc::EpiLayer e{(const int32_t*)bias, (int16_t*)out, shift, leaky};
    return (int)yq::tc::launch_igemm_tc<yq::tc::Q16, Loader>(p, wp, e, ws, M, N, K,
                                                             ktiles_per_split, stream);
}

// The tile of the tensor-core body's operand scheme `scheme` (0 Q16, 1
// W8A16, 2 S8): see yq::tc::config for `what`.
extern "C" int yq_tc_config(int scheme, int what) { return yq::tc::config(scheme, what); }
