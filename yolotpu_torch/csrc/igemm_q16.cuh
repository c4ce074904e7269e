// Tiled exact int16 GEMM with the fused requant epilogue: the body shared by
// mm_q16.cu (A is the activation matrix itself) and conv3x3_q16.cu (A is the
// implicit im2col of a SAME 3x3 window, gathered while loading).
//
//   out[m, n] = requant_q16(sum_k A[m, k] * w[k, n]  (mod 2^32), bias[n])
//
// A block computes a BM x BN output tile and walks K in BK steps. Operands go
// from global memory to registers to shared memory as int32 (two buffers, so
// one __syncthreads per K step); while the block multiplies one K step the
// next one is already in flight to registers. Each thread owns a TM x TN
// micro-tile of uint32 accumulators, so each product is one 32-bit
// multiply-add whose wraparound is defined.
//
// The A operand comes from a Loader:
//   Loader(const Params&, long long m, long long M)  set up for output row m
//   void load8(int k0, int32_t v[8]) const           A[m, k0 .. k0+7], 0 past
//                                                    the row's end or M
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "requant.cuh"

namespace yq16 {

constexpr int BM = 128, BN = 64, BK = 16, THREADS = 256;
constexpr int TM = 8, TN = 4;  // BM * BN / THREADS = 32 outputs per thread
static_assert(BM * BN == THREADS * TM * TN, "micro-tiles must cover the tile");
static_assert(BM * BK == THREADS * 8, "each thread loads 8 A values per step");
static_assert(BK * BN == THREADS * 4, "each thread loads 4 B values per step");

// Eight int16 lanes of a 16-byte load, sign-extended to int32.
__device__ __forceinline__ void unpack8(const int4 q, int32_t v[8]) {
    const int32_t w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
        v[2 * j] = (int32_t)(int16_t)(w[j] & 0xFFFF);
        v[2 * j + 1] = w[j] >> 16;
    }
}

// One K step of both operands, global memory -> registers: A[row][k0+ak ..
// k0+ak+8) through the loader, w[k0+bk][nb .. nb+4) with zeros past K and N.
template <class Loader>
__device__ __forceinline__ void load_step(const Loader& ld, const int16_t* __restrict__ w,
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

template <class Loader>
__global__ void __launch_bounds__(THREADS)
igemm_q16_kernel(const typename Loader::Params p,
                 const int16_t* __restrict__ w,     // (K, N) row-major
                 const int32_t* __restrict__ bias,  // (N,)
                 int16_t* __restrict__ out,         // (M, N) row-major
                 long long M, int N, int K, int shift, int leaky) {
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

#pragma unroll
    for (int i = 0; i < TM; ++i) {
        const long long m = m0 + tm + i;
        if (m >= M) break;
#pragma unroll
        for (int j = 0; j < TN; ++j) {
            const int n = n0 + tn + j;
            if (n < N) out[m * N + n] = requant_q16(acc[i][j], bias[n], shift, leaky);
        }
    }
}

template <class Loader>
inline cudaError_t launch_igemm_q16(const typename Loader::Params& p, const void* w,
                                    const void* bias, void* out, long long M, int N,
                                    int K, int shift, int leaky, void* stream) {
    if (M > 0 && N > 0) {
        const dim3 grid((unsigned)((M + BM - 1) / BM), (unsigned)((N + BN - 1) / BN));
        igemm_q16_kernel<Loader><<<grid, THREADS, 0, (cudaStream_t)stream>>>(
            p, (const int16_t*)w, (const int32_t*)bias, (int16_t*)out, M, N, K, shift,
            leaky);
    }
    return cudaGetLastError();
}

}  // namespace yq16
