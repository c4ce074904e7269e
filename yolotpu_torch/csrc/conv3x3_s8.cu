// conv3x3_s8: int8 SAME 3x3/s1 convolution with the fused per-channel
// requant to int8, NHWC activations, for the 3x3 convolutions of the int8
// (w8a8) tier, and through ops/q8.py:conv3x3_int8 the scalar-shift int8 conv.
// An implicit GEMM (M = B*H*W output pixels, K = 9*C taps x input channels,
// tap-major, the HWIO weight order; N output channels) whose A operand is
// gathered from the input as it is copied to shared memory, SAME padding as
// zeros (igemm_tc.cuh, ConvTc<int8_t>).
//
// Replaces yolotpu/ops/pallas_q16.py:conv3x3_s8_wi (:953, kernel body
// _convw_s8_kernel), the weight-resident s8 conv that the JAX model ran only
// under YOLO2_INT8_CONV3_WI=1, and the XLA s8 convolution it ran otherwise,
// and yolotpu/ops/pallas_conv.py:conv3x3_int8 / conv3x3_int8_im2col (K13),
// which compute the same function with one shift. The TPU kernels' s8 dot
// per tap into int32 reached the TPU's matrix unit; the same s8 x s8 -> s32
// products reach Hopper's integer wgmma here, while their lane-padded
// channels, W2a row padding and VMEM bands do not carry over. One kernel
// serves every 3x3 conv of the tier, the C=3 entry layer and the
// 208x208 / 104x104 layers included.
//
// What bounds it on an H100: operations. An s8 x s8 product is one 8-bit
// tensor-core product, and the 3x3 layers of yolov2 416 do 14.10 G MAC per
// frame: 0.114 ms at b=8 on 989.5e12 8-bit MAC/s. Their bytes (int8 in and
// out, weights once) take less at 3.35 TB/s, but a 64x64 tile reads its A
// rows and B columns from L2 once per tile, and one 8-bit product per MAC
// leaves the tensor cores a quarter of the int16 tier's work for the same
// bytes. The design (the S8 scheme of igemm_tc.cuh): A stays int8 from
// memory to shared memory, 128 values of k per K step (one 16-byte cp.async
// is 16 channels of one tap where C % 16 == 0, every int8 3x3 conv of yolov2
// but the entry; the C=3 entry conv gathers its 27 bytes by kernel rows; any
// other C byte by byte), ldmatrix gives the wgmma A fragment with no byte
// permute, the weights are one s8 plane in natural k order packed at model
// build (ops/q8.py: pack_conv3x3_s8), one s32 accumulator set (exact for
// K <= 131072; a block still sums at most 32768 values of k), split-K where
// the output tiles cannot fill the card, and the per-channel requant with
// each column's bias and shift read once.
#include "igemm_tc.cuh"

// x (B, H, W, C) int8, wp the packed plane of w (3, 3, C, N) int8 read as
// (9C, N) (ops/q8.py: pack_conv3x3_s8), bias and shift (N,) int32 -> out
// (B, H, W, N) int8, all contiguous on the current device; ws as
// launch_igemm_tc wants it. Returns cudaGetLastError() after the launch.
extern "C" int yq8_conv3x3_s8(const void* x, const void* wp, const void* bias,
                              const void* shift, void* out, void* ws, int B, int H, int W,
                              int C, int N, int leaky, int ktiles_per_split, void* stream) {
    using Loader = yq::tc::ConvTc<int8_t>;
    const Loader::Params p{(const int8_t*)x, H, W, C, yq::tc::vec16(x, C)};
    const yq::tc::S8::Epi e{(const int32_t*)bias, (const int32_t*)shift, (int8_t*)out, leaky};
    const long long M = (long long)B * H * W;
    return (int)yq::tc::launch_igemm_tc<yq::tc::S8, Loader>(p, wp, e, ws, M, N, 9 * C,
                                                            ktiles_per_split, stream);
}
