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
// included, which the JAX model sent to XLA. The TPU kernel's s8 dot into
// int32 reached the TPU's matrix unit; the same products reach Hopper's
// integer wgmma here.
//
// What bounds it on an H100: bytes. An s8 x s8 product is one 8-bit
// tensor-core product, and the eight 1x1 layers of yolov2 416 do 0.63 G MAC
// per frame, 0.005 ms at b=8 on 989.5e12 8-bit MAC/s, while their int8
// inputs and outputs and the weights, each moved once, take 0.013 ms at
// 3.35 TB/s. With K of 128 to 1024 a block has only one to eight K steps, so
// what it waits for is its own loads and its epilogue, not the products.
// The design (the S8 scheme of igemm_tc.cuh, MmTc<int8_t>): the int8 rows go
// to shared memory as they are, 128 values of k per K step, by 16-byte
// cp.async where K % 16 == 0 (every 1x1 conv of yolov2) and byte by byte
// otherwise; ldmatrix gives the wgmma A fragment with no byte permute; the
// weights are one s8 plane in natural k order packed at model build
// (ops/q8.py: pack_s8); one s32 accumulator set (exact for K <= 131072; a
// block still sums at most 32768 values of k); four blocks per SM, so one
// block's loads and stores overlap the others' products; split-K where the
// output tiles cannot fill the card (the 13x13 layers at b=1); each
// column's bias and shift read once, and the outputs leave as 8-byte (int8)
// or 16-byte (int16) stores where N % 8 == 0 (N=425 stores by element).
#include "igemm_tc.cuh"

// x (M, K) int8, wp the packed plane of w (K, N) int8 (ops/q8.py: pack_s8),
// bias and shift (N,) int32 -> out (M, N) int8, or int16 when out16 != 0,
// all contiguous on the current device; ws as launch_igemm_tc wants it.
// Returns cudaGetLastError() after the launch.
extern "C" int yq8_mm_s8(const void* x, const void* wp, const void* bias, const void* shift,
                         void* out, void* ws, int M, int K, int N, int leaky, int out16,
                         int ktiles_per_split, void* stream) {
    using namespace yq::tc;
    using Loader = MmTc<int8_t>;
    const Loader::Params p{(const int8_t*)x, K, vec16(x, K)};
    const int32_t *b = (const int32_t*)bias, *s = (const int32_t*)shift;
    if (out16) {
        const S8Out16::Epi e{b, s, (int16_t*)out, leaky};
        return (int)launch_igemm_tc<S8Out16, Loader>(p, wp, e, ws, M, N, K, ktiles_per_split,
                                                     stream);
    }
    const S8::Epi e{b, s, (int8_t*)out, leaky};
    return (int)launch_igemm_tc<S8, Loader>(p, wp, e, ws, M, N, K, ktiles_per_split, stream);
}
