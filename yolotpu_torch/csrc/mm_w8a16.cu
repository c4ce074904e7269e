// mm_w8a16: int16 (M, K) @ int8 (K, N) with the fused per-channel requant
// to int16, for the 1x1 convolutions of the w8a16 tier.
//
// Replaces yolotpu/ops/pallas_matmul.py:matmul_w8a16_requant (:127, kernel
// body _mm_w8a16_kernel). That kernel split each int16 activation into s8
// planes xh = x >> 8 and xl = (x & 255) - 128, ran two s8 dots against one
// weight tile and added cw = 128 * sum(w): algebraically the same sum,
// sum((256 xh + xl + 128) w) = sum(x w), shaped for the TPU's s8 matrix
// unit. Hopper's integer wgmma takes an unsigned operand, so here the low
// byte stays xl = x & 255 (u8), and cw and the -128 offset do not exist:
// sum(x w) = (sum(xh w) << 8) + sum(xl w) modulo 2^32. |x*w| <= 2^22, so
// with K up to 9*1280 a sum can leave int32: it wraps as uint32 does, which
// is the TPU kernel's int32 wraparound.
//
// What bounds it on an H100: bytes. An int16 x int8 product is two 8-bit
// tensor-core products, 0.010 ms for the eight 1x1 layers of yolov2 416 at
// b=8 on 989.5e12 8-bit MAC/s, against 0.026 ms to move their int16 inputs
// and outputs and the int8 weights once at 3.35 TB/s. With K of 128 to 1024
// a block has two to sixteen K steps, and waits for its loads and its
// epilogue. The design (the W8A16 scheme of igemm_tc.cuh on
// MmTc<int16_t>, mm_q16's loader): int16 rows through a 4-stage cp.async
// ring, 64 values of k per K step; ldmatrix and __byte_perm make the s8
// high and u8 low fragments; one s8 weight plane in that fragment order,
// packed at model build (ops/q8.py: pack_w8a16); two s32 accumulator sets
// (exact for K <= 65793; a block sums at most 32768 values of k)
// recombined in uint32; three blocks per SM; split-K for the 13x13 layers
// at b=1; each column's bias and shift read once, 16-byte stores.
#include "igemm_tc.cuh"

// x (M, K) int16, wp the packed plane of w (K, N) int8 (ops/q8.py:
// pack_w8a16), bias and shift (N,) int32 -> out (M, N) int16, all contiguous
// on the current device; ws as launch_igemm_tc wants it. Returns
// cudaGetLastError() after the launch.
extern "C" int yq8_mm_w8a16(const void* x, const void* wp, const void* bias,
                            const void* shift, void* out, void* ws, int M, int K, int N,
                            int leaky, int ktiles_per_split, void* stream) {
    using namespace yq::tc;
    using Loader = MmTc<int16_t>;
    const Loader::Params p{(const int16_t*)x, K, vec16(x, 2LL * K)};
    const W8A16::Epi e{(const int32_t*)bias, (const int32_t*)shift, (int16_t*)out, leaky};
    return (int)launch_igemm_tc<W8A16, Loader>(p, wp, e, ws, M, N, K, ktiles_per_split,
                                               stream);
}
