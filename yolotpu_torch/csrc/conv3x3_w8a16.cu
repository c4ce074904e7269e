// conv3x3_w8a16: int16 activations x int8 weights, SAME 3x3/s1, with the
// fused per-channel requant to int16, NHWC, for the 3x3 convolutions of the
// w8a16 tier. An implicit GEMM (M = B*H*W output pixels, K = 9*C taps x
// input channels, tap-major, the HWIO weight order; N output channels) whose
// A operand is gathered from the input as it is copied to shared memory,
// SAME padding as zeros (igemm_tc.cuh, ConvTc<int16_t>).
//
// Replaces yolotpu/ops/pallas_q16.py:conv3x3_w8a16_wi (:1048, kernel body
// _convw_w8_kernel) and the XLA plane-stacked conv the JAX model fell back
// to (the C=3 entry layer, and where no VMEM band fit). Per tap the TPU
// kernel took two s8 dots, the high and the low activation planes against
// one weight plane, and recombined (acch << 8) + accl + nconst: its low
// plane was xl - 128 and nconst = 128 * sum(w) per column put the offset
// back. Hopper's integer wgmma takes an unsigned low byte, so here the
// planes are xh = x >> 8 (s8) and xl = x & 255 (u8), the two s32 partial
// sums are recombined as (h << 8) + l in uint32 (the sum modulo 2^32, which
// is the TPU kernel's int32 wraparound: |x*w| <= 2^22, so the exact sum can
// leave int32), and no constant is needed; SAME zeros split to zeros.
//
// What bounds it on an H100: operations. An int16 x int8 product is two
// 8-bit tensor-core products, and the 3x3 layers of yolov2 416 do 14.10 G
// MAC per frame: 0.228 ms at b=8 on 989.5e12 8-bit MAC/s, above the time to
// move their bytes at 3.35 TB/s. The design (the W8A16 scheme of
// igemm_tc.cuh) is conv3x3_q16.cu's with one weight plane: the same 4-stage
// cp.async ring of int16 A (one 16-byte copy per 8 channels of one tap; the
// C=3 entry conv gathered by kernel rows; any other C value by value), the
// same ldmatrix and byte split into an s8 high and a u8 low fragment, one s8
// weight plane in the same permuted k order packed at model build (ops/q8.py:
// pack_conv3x3_w8a16), two wgmma (s8 x s8, u8 x s8) per 32 k instead of
// four, two s32 accumulator sets (exact for K <= 65793; a block sums at most
// 32768 values of k), split-K where the output tiles cannot fill the card,
// and the per-channel requant with each column's bias and shift read once.
#include "igemm_tc.cuh"

// x (B, H, W, C) int16, wp the packed plane of w (3, 3, C, N) int8 read as
// (9C, N) (ops/q8.py: pack_conv3x3_w8a16), bias and shift (N,) int32 -> out
// (B, H, W, N) int16, all contiguous on the current device; ws as
// launch_igemm_tc wants it. Returns cudaGetLastError() after the launch.
extern "C" int yq8_conv3x3_w8a16(const void* x, const void* wp, const void* bias,
                                 const void* shift, void* out, void* ws, int B, int H, int W,
                                 int C, int N, int leaky, int ktiles_per_split,
                                 void* stream) {
    using Loader = yq::tc::ConvTc<int16_t>;
    const Loader::Params p{(const int16_t*)x, H, W, C, yq::tc::vec16(x, 2LL * C)};
    const yq::tc::W8A16::Epi e{(const int32_t*)bias, (const int32_t*)shift, (int16_t*)out,
                               leaky};
    const long long M = (long long)B * H * W;
    return (int)yq::tc::launch_igemm_tc<yq::tc::W8A16, Loader>(p, wp, e, ws, M, N, 9 * C,
                                                               ktiles_per_split, stream);
}
