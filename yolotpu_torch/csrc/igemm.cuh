// Tiled exact integer GEMM on the CUDA cores with a fused requant and 2x2/s2
// maxpool epilogue: the body of conv3x3_pool_q16.cu (the other kernels of
// csrc/ run on the tensor cores, igemm_tc.cuh). Each kernel is an
// instantiation with an A loader (loaders.cuh: the implicit im2col of a SAME
// 3x3 window, gathered while loading, the pixels window-major) and an
// epilogue (where the pool's max is taken):
//
//   acc[m, n] = sum_k A[m, k] * w[k, n]  (mod 2^32)
//   out[i, n] = pool and requant of acc[4i .. 4i+3, n] with bias[n], shift
//
// A block computes a BM x BN output tile and walks K in BK steps. Operands go
// from global memory to registers to shared memory as int32 (two buffers, so
// one __syncthreads per K step); while the block multiplies one K step the
// next one is already in flight to registers. Each thread owns a TM x TN
// micro-tile of uint32 accumulators, so each product is one 32-bit
// multiply-add whose wraparound is defined. Operands of 8 or 16 bits give
// products of at most 2^30 in magnitude, so the int32 product never
// overflows; only the sum wraps, and it wraps in uint32.
//
// The A operand comes from a Loader:
//   Loader(const Params&, long long m, long long M)  set up for output row m
//   void load8(int k0, int32_t v[8]) const           A[m, k0 .. k0+7], 0 past
//                                                    the row's end or M
// The epilogue from an Epi; rows 4i..4i+3 are one 2x2 pool window
// (ConvLoader<T>) and give one output row:
//   W                                       weight element type
//   Col column(int n, int N) const          what column n needs, read once
//   void store4(long long i, const uint32_t a[4], Col) const
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "requant.cuh"

namespace yq {

constexpr int BM = 128, BN = 64, BK = 16, THREADS = 256;
constexpr int TM = 8, TN = 4;  // BM * BN / THREADS = 32 outputs per thread
static_assert(BM * BN == THREADS * TM * TN, "micro-tiles must cover the tile");
static_assert(BM * BK == THREADS * 8, "each thread loads 8 A values per step");
static_assert(BK * BN == THREADS * 4, "each thread loads 4 B values per step");

// One K step of both operands, global memory -> registers: A[row][k0+ak ..
// k0+ak+8) through the loader, w[k0+bk][nb .. nb+4) with zeros past K and N.
template <class Loader, class W>
__device__ __forceinline__ void load_step(const Loader& ld, const W* __restrict__ w,
                                          int k0, int ak, int bk, int nb, int N, int K,
                                          int32_t ra[8], int32_t rb[4]) {
    ld.load8(k0 + ak, ra);
    const int k = k0 + bk;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
        const int n = nb + j;
        rb[j] = (k < K && n < N) ? (int32_t)w[(long long)k * N + n] : 0;
    }
}

template <class Loader, class Epi>
__global__ void __launch_bounds__(THREADS)
igemm_kernel(const typename Loader::Params p,
             const typename Epi::W* __restrict__ w,  // (K, N) row-major
             const Epi e,                            // bias, shift, out (M, N)
             long long M, int N, int K) {
    __shared__ __align__(16) int32_t As[2][BK][BM];
    __shared__ __align__(16) int32_t Bs[2][BK][BN];

    const int tid = threadIdx.x;
    const long long m0 = (long long)blockIdx.x * BM;
    const int n0 = blockIdx.y * BN;

    // load roles: A row ar, k offsets ak..ak+7; B row bk, columns bn..bn+3
    const int ar = tid % BM;
    const int ak = (tid / BM) * 8;
    const int bk = tid / (BN / 4);
    const int bn = (tid % (BN / 4)) * 4;
    const Loader ld(p, m0 + ar, M);
    // compute role: rows tm..tm+TM-1, columns tn..tn+TN-1 of the tile
    const int tm = (tid / (BN / TN)) * TM;
    const int tn = (tid % (BN / TN)) * TN;

    uint32_t acc[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = 0u;

    int32_t ra[8], rb[4];
    const int ktiles = (K + BK - 1) / BK;
    load_step(ld, w, 0, ak, bk, n0 + bn, N, K, ra, rb);

    for (int t = 0; t < ktiles; ++t) {
        // registers -> buffer t&1: its last reads were in step t-2, and every
        // thread has passed step t-1's barrier since
        const int buf = t & 1;
#pragma unroll
        for (int j = 0; j < 8; ++j) As[buf][ak + j][ar] = ra[j];
        *reinterpret_cast<int4*>(&Bs[buf][bk][bn]) = make_int4(rb[0], rb[1], rb[2], rb[3]);
        __syncthreads();
        // the next K step travels to registers while this one multiplies
        if (t + 1 < ktiles) load_step(ld, w, (t + 1) * BK, ak, bk, n0 + bn, N, K, ra, rb);
#pragma unroll
        for (int kk = 0; kk < BK; ++kk) {
            const int4 a0 = *reinterpret_cast<const int4*>(&As[buf][kk][tm]);
            const int4 a1 = *reinterpret_cast<const int4*>(&As[buf][kk][tm + 4]);
            const int4 b0 = *reinterpret_cast<const int4*>(&Bs[buf][kk][tn]);
            const int32_t a[TM] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
            const int32_t b[TN] = {b0.x, b0.y, b0.z, b0.w};
#pragma unroll
            for (int i = 0; i < TM; ++i)
#pragma unroll
                for (int j = 0; j < TN; ++j)
                    // |a*b| <= 2^30: the int32 product cannot overflow
                    acc[i][j] += (uint32_t)(a[i] * b[j]);
        }
    }

    typename Epi::Col col[TN];
#pragma unroll
    for (int j = 0; j < TN; ++j) col[j] = e.column(n0 + tn + j, N);
    // m0 and tm are multiples of 4, so a thread's TM rows are TM/4 whole
    // windows, pooled in registers; M = B*H*W is a multiple of 4, so a
    // window lies wholly inside M or wholly past it
    static_assert(TM % 4 == 0, "a thread's rows must be whole windows");
#pragma unroll
    for (int g = 0; g < TM / 4; ++g) {
        const long long m = m0 + tm + 4 * g;
        if (m >= M) break;
#pragma unroll
        for (int j = 0; j < TN; ++j) {
            const int n = n0 + tn + j;
            const uint32_t a[4] = {acc[4 * g][j], acc[4 * g + 1][j], acc[4 * g + 2][j],
                                   acc[4 * g + 3][j]};
            if (n < N) e.store4((m / 4) * N + n, a, col[j]);
        }
    }
}

template <class Loader, class Epi>
inline cudaError_t launch_igemm(const typename Loader::Params& p, const void* w,
                                const Epi& e, long long M, int N, int K, void* stream) {
    if (M > 0 && N > 0) {
        const dim3 grid((unsigned)((M + BM - 1) / BM), (unsigned)((N + BN - 1) / BN));
        igemm_kernel<Loader, Epi><<<grid, THREADS, 0, (cudaStream_t)stream>>>(
            p, (const typename Epi::W*)w, e, M, N, K);
    }
    return cudaGetLastError();
}

// Where a conv fused with the following 2x2/s2 maxpool takes the pool's
// max, which is a different function once acc + 2^(shift-1) wraps: on the
// four accumulators; on each horizontal pair's accumulators, then on the
// requantized pair maxima; or on the four requantized values.
enum PoolOrder { kPoolAcc = 0, kPoolAccH = 1, kPoolOut = 2 };

// The signed int32 max of two wrapped sums (an unsigned max is wrong as
// soon as a sum wraps negative).
__device__ __forceinline__ uint32_t max_s32(uint32_t a, uint32_t b) {
    return (int32_t)a > (int32_t)b ? a : b;
}

// The int16-exact tier's epilogue with the pool: int16 weights and output,
// one shift for the layer, out (M/4, N), a[q] the sums of window member
// q = 2 * dy + dx. The column carries only its index; bias[n] is read at
// the store.
template <int ORDER>
struct EpiPoolQ16 {
    using W = int16_t;
    struct Col {
        int n;
    };
    const int32_t* bias;  // (N,)
    int16_t* out;         // (M/4, N)
    int shift, leaky;

    __device__ __forceinline__ Col column(int n, int) const { return {n}; }
    __device__ __forceinline__ void store4(long long i, const uint32_t a[4], Col c) const {
        const int32_t b = bias[c.n];
        int16_t v;
        if constexpr (ORDER == kPoolAcc) {
            v = requant_q16(max_s32(max_s32(a[0], a[1]), max_s32(a[2], a[3])), b, shift,
                            leaky);
        } else if constexpr (ORDER == kPoolAccH) {
            const int16_t top = requant_q16(max_s32(a[0], a[1]), b, shift, leaky);
            const int16_t bot = requant_q16(max_s32(a[2], a[3]), b, shift, leaky);
            v = top > bot ? top : bot;
        } else {
            v = requant_q16(a[0], b, shift, leaky);
#pragma unroll
            for (int q = 1; q < 4; ++q) {
                const int16_t r = requant_q16(a[q], b, shift, leaky);
                v = r > v ? r : v;
            }
        }
        out[i] = v;
    }
};

}  // namespace yq
