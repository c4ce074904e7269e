// Exact int16 GEMM on the 8-bit tensor cores, with the fused requant: the
// body of mm_q16.cu and conv3x3_q16.cu.
//
//   out[m, n] = requant_q16(sum_k A[m, k] * w[k, n]  (mod 2^32), bias[n], shift)
//
// The split. The tensor cores multiply 8-bit operands, so each int16 is cut
// into a signed high byte and an unsigned low byte, x = 256*xh + xl with
// xh = x >> 8 in [-128, 127] (s8) and xl = x & 255 in [0, 255] (u8), and w
// alike. Then
//
//   sum x*w = (sum xh*wh << 16) + ((sum xh*wl + sum xl*wh) << 8) + sum xl*wl
//
// as integers, and the integer wgmma takes s8 and u8 operands in any
// pairing, so the four products need no correction constant. The two middle products shift
// alike and share one accumulator: three s32 accumulator sets. Per k,
// |xh*wh| <= 2^14, |xh*wl + xl*wh| <= 65280 and xl*wl <= 65025, so each s32
// partial sum is exact for K <= 32896 without relying on how the tensor
// cores overflow; a block sums at most KMAX = 32768 values of k, and longer
// K is cut into splits (below). The three sums are recombined in uint32_t,
// where the wrap is defined, and SAME padding splits to zeros.
//
// Operands. Activations stay int16 in memory. A block computes a BM x BN
// output tile and walks its K range in BK steps through a STAGES-deep ring
// of shared-memory tiles filled by cp.async (16 bytes per copy; a copy with
// source size 0 writes zeros, for SAME padding and ragged edges). The A
// tile arrives as int16 from a Loader: the activation rows (1x1 convs) or
// the implicit im2col of a SAME 3x3 window; rows or channels that do not
// come in whole 16-byte chunks are gathered by the threads into the same
// tiles. The block is one warpgroup: wgmma (m64n64k32) takes A from
// registers and B from shared memory through a descriptor. ldmatrix (b16)
// brings each warp's 16 rows of A to registers and __byte_perm separates
// the high and low bytes into the two 8-bit A fragments; that puts k values
// 2t, 2t+1, 8+2t, 9+2t (+16) where the fragment expects 4t .. 4t+3 (+16).
// The weights absorb this permutation: they are split into their high (s8)
// and low (u8) planes, permuted, and laid out as the descriptor reads them
// (8x16-byte core matrices, no swizzle) once, at model build (ops/q16.py:
// pack_q16, whose FRAG_K is the permutation), so a B stage is one
// contiguous copy.
//
// Small M. Where the output tiles are too few to fill the card, the grid's
// z dimension cuts K into splits of ktiles_per_split BK steps; each block
// adds its uint32 partial tile into a zeroed workspace with atomicAdd (sums
// mod 2^32 are exact in any order, so the result does not depend on it),
// and the block that finishes a tile last requantizes it. The epilogue of
// an unsplit block stages its tile through shared memory, and every output
// leaves as 16 bytes (eight int16) per thread where N allows.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "requant.cuh"

namespace yq {
namespace tc {

// A block of 4 warps (one warpgroup, 16 rows each) computes a 64 x 64
// tile, and three blocks stay resident on an SM (the registers of 3 x 128
// threads, 3 x 68 KB of shared memory), so where a block has few K steps
// (a large M and a small K, the entry conv) one block's loads and epilogue
// overlap the others' products.
constexpr int BM = 64, BN = 64, BK = 64, STAGES = 4, THREADS = 128, MIN_BLOCKS = 3;
constexpr int A_LD = BK + 8;             // int16 per A row in shared memory:
                                         // 144 bytes, so the 8 rows of an
                                         // ldmatrix hit 8 distinct bank groups
constexpr int A_STAGE = BM * A_LD;       // int16 per A stage
constexpr int B_STAGE = BK * BN * 2;     // bytes per B stage (two planes)
constexpr int B_CHUNKS = B_STAGE / 16 / THREADS;   // 16-byte copies per thread
constexpr int ROW_STEP = THREADS / 8;    // rows between a thread's A chunks
constexpr int C_LD = BN + 8;             // uint32 per staged output row
constexpr int SMEM = STAGES * (A_STAGE * 2 + B_STAGE);
constexpr int KMAX = 32768;              // k per s32 partial sum
constexpr int PLANE = 32 * BN;           // bytes of one plane of a (32 k, BN n) B chunk
static_assert(THREADS == 128 && BM == 64, "one warpgroup, 16 rows per warp");
static_assert(BM * BK / 8 == 4 * THREADS, "each thread copies 4 A chunks per stage");
static_assert(B_CHUNKS * 16 * THREADS == B_STAGE, "threads cover a B stage");
static_assert(BM * C_LD * 4 <= SMEM, "the staged output tile fits the ring");
static_assert(KMAX % BK == 0, "a split's K is whole BK steps");

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
    return (uint32_t)__cvta_generic_to_shared(p);
}

// 16 bytes global -> shared; with full == false the 16 bytes are zeros and
// src is not read.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool full) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
                 "l"(src), "r"(full ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t r[4], const void* p) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(smem_addr(p)));
}

// B operand descriptor of one plane of a (32 k, 64 n) chunk in shared
// memory: 8 groups of 8 n rows, each group two 8x16-byte core matrices (k
// 0-15, then k 16-31); no swizzle. Leading offset (between the two k
// halves) 128 bytes, stride offset (between n groups) 256 bytes.
__device__ __forceinline__ uint64_t b_desc(const void* p) {
    return (uint64_t)((smem_addr(p) & 0x3FFFF) >> 4) | ((uint64_t)(128 >> 4) << 16) |
           ((uint64_t)(256 >> 4) << 32);
}

// d (64 x 64 s32, 32 per thread) += A (64 x 32 8-bit, from registers) x
// B (32 x 64 8-bit, descriptor), on the warpgroup.
#define YQ_WGMMA_8BIT(NAME, AT, BT)                                                        \
    __device__ __forceinline__ void NAME(int32_t d[32], const uint32_t a[4], uint64_t b) { \
        asm volatile(                                                                      \
            "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"                                   \
            "wgmma.mma_async.sync.aligned.m64n64k32.s32." AT "." BT " "                    \
            "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "      \
            "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, "  \
            "%31}, {%32, %33, %34, %35}, %36, p;\n}\n"                                     \
            : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),      \
              "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),    \
              "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]),             \
              "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]),             \
              "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]), "+r"(d[26]),             \
              "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])              \
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));                 \
    }
YQ_WGMMA_8BIT(wgmma_ss, "s8", "s8")
YQ_WGMMA_8BIT(wgmma_su, "s8", "u8")
YQ_WGMMA_8BIT(wgmma_us, "u8", "s8")
YQ_WGMMA_8BIT(wgmma_uu, "u8", "u8")
#undef YQ_WGMMA_8BIT

__device__ __forceinline__ void wgmma_fence() {
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Keeps r live, and its later reads after this point: a register that an
// asynchronous wgmma reads or writes must not be reused or read before the
// wait.
__device__ __forceinline__ void fence_operand(uint32_t& r) {
    asm volatile("" : "+r"(r)::"memory");
}
__device__ __forceinline__ void fence_operand(int32_t& r) {
    asm volatile("" : "+r"(r)::"memory");
}
// Orders this thread's shared-memory writes (cp.async, stores) before the
// async proxy's reads of them (wgmma's B operand).
__device__ __forceinline__ void fence_proxy_async() {
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// The three partial sums of one output, recombined modulo 2^32.
__device__ __forceinline__ uint32_t combine(int32_t hh, int32_t mid, int32_t ll) {
    return ((uint32_t)hh << 16) + ((uint32_t)mid << 8) + (uint32_t)ll;
}

// Eight int16 A values (one 16-byte chunk) as a scalar gather: v[e] is
// value(k + e), or 0 where it lies past K.
template <class F>
__device__ __forceinline__ int4 gather8(int k, int K, F value) {
    int16_t v[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) v[e] = (k + e < K) ? value(k + e) : (int16_t)0;
    int4 q;
    q.x = (int)(uint16_t)v[0] | ((int)v[1] << 16);
    q.y = (int)(uint16_t)v[2] | ((int)v[3] << 16);
    q.z = (int)(uint16_t)v[4] | ((int)v[5] << 16);
    q.w = (int)(uint16_t)v[6] | ((int)v[7] << 16);
    return q;
}

// A loaders. Each thread fills 4 chunks of 8 int16 per stage: rows
// r0 + ROW_STEP j (j < 4) of the tile, columns k0 + 8 c8 .. +7. vec:
// 16-byte copies (the row length is a multiple of 8 and the base 16-byte
// aligned); otherwise each value is loaded on its own (ConvTc gathers a C
// below 8, the entry conv, by kernel rows instead).
struct MmTc {
    struct Params {
        const int16_t* x;  // (M, K) row-major
        int K;
        int vec;
    };
    const int16_t* x;
    int K, vec, r0, c8;
    int m[4];  // each row's m, -1 past M

    __device__ MmTc(const Params& p, long long m0, long long M, int tid)
        : x(p.x), K(p.K), vec(p.vec), r0(tid >> 3), c8(tid & 7) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            const long long mm = m0 + r0 + ROW_STEP * j;
            m[j] = mm < M ? (int)mm : -1;
        }
    }

    __device__ __forceinline__ void load(int16_t* sA, int k0) const {
        const int k = k0 + 8 * c8;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            int16_t* dst = sA + (r0 + ROW_STEP * j) * A_LD + 8 * c8;
            const bool ok = m[j] >= 0 && k < K;
            const int16_t* row = x + (long long)(ok ? m[j] : 0) * K;
            if (vec) {
                cp_async16(dst, ok ? row + k : x, ok);
            } else {
                *reinterpret_cast<int4*>(dst) =
                    ok ? gather8(k, K, [&](int kk) { return row[kk]; }) : make_int4(0, 0, 0, 0);
            }
        }
    }
};

struct ConvTc {
    struct Params {
        const int16_t* x;  // (B, H, W, C) row-major
        int H, W, C;
        int vec;
    };
    const int16_t* x;
    int H, W, C, K, vec, r0, c8;
    int m[4], y[4], xw[4];  // each row's pixel and its (y, x); m = -1 past M

    __device__ ConvTc(const Params& p, long long m0, long long M, int tid)
        : x(p.x), H(p.H), W(p.W), C(p.C), K(9 * p.C), vec(p.vec), r0(tid >> 3), c8(tid & 7) {
        const int hw = p.H * p.W;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            const long long mm = m0 + r0 + ROW_STEP * j;
            m[j] = mm < M ? (int)mm : -1;
            const int r = m[j] >= 0 ? m[j] % hw : 0;
            y[j] = r / p.W;
            xw[j] = r - y[j] * p.W;
        }
    }

    // input value of row j at im2col column k, 0 in the SAME padding
    __device__ __forceinline__ int16_t at(int j, int k) const {
        const int tap = k / C, c = k - tap * C;
        const int dy = tap / 3 - 1, dx = tap % 3 - 1;
        const int iy = y[j] + dy, ix = xw[j] + dx;
        if (iy < 0 || iy >= H || ix < 0 || ix >= W) return 0;
        return x[(long long)(m[j] + dy * W + dx) * C + c];
    }

    __device__ __forceinline__ void load(int16_t* sA, int k0) const {
        const int k = k0 + 8 * c8;
        if (vec) {
            // C % 8 == 0: the chunk's 8 values share one tap
            const int tap = k < K ? k / C : 0;
            const int c = k - tap * C;
            const int dy = tap / 3 - 1, dx = tap % 3 - 1;
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                const int iy = y[j] + dy, ix = xw[j] + dx;
                const bool ok = m[j] >= 0 && k < K && iy >= 0 && iy < H && ix >= 0 && ix < W;
                const int16_t* src = ok ? x + (long long)(m[j] + dy * W + dx) * C + c : x;
                cp_async16(sA + (r0 + ROW_STEP * j) * A_LD + 8 * c8, src, ok);
            }
            return;
        }
        if (C < 8) {
            // K = 9C < BK: one K step. Row j's window is three runs of 3C
            // values, one per kernel row dy (k = 3C dy + C dx + c, the
            // pixels (y+dy-1, x-1 .. x+1) in order), then zeros up to BK.
            // The thread with c8 = dy < 3 writes run dy of its 4 rows, the
            // one with c8 = 3 the zeros; C = 3 (the entry conv) costs 9
            // loads per run, not a division per value.
            if (c8 > 3) return;
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                int16_t* row = sA + (r0 + ROW_STEP * j) * A_LD;
                if (c8 == 3) {
                    int kk = K;
                    for (; kk & 7; ++kk) row[kk] = 0;
                    for (; kk < BK; kk += 8)
                        *reinterpret_cast<int4*>(row + kk) = make_int4(0, 0, 0, 0);
                    continue;
                }
                const int iy = y[j] + c8 - 1;
                const bool row_ok = m[j] >= 0 && iy >= 0 && iy < H;
                for (int dx = 0; dx < 3; ++dx) {
                    const int ix = xw[j] + dx - 1;
                    const bool ok = row_ok && ix >= 0 && ix < W;
                    const int16_t* src = x + (long long)(m[j] + (c8 - 1) * W + dx - 1) * C;
                    int16_t* dst = row + (3 * c8 + dx) * C;
                    for (int c = 0; c < C; ++c) dst[c] = ok ? src[c] : (int16_t)0;
                }
            }
            return;
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            *reinterpret_cast<int4*>(sA + (r0 + ROW_STEP * j) * A_LD + 8 * c8) =
                m[j] >= 0 ? gather8(k, K, [&](int kk) { return at(j, kk); })
                          : make_int4(0, 0, 0, 0);
        }
    }
};

// Requantize the eight sums of out[m, n .. n+7] (columns past N dropped)
// and store them, as one 16-byte store where the row allows.
__device__ __forceinline__ void store8(int16_t* out, const int32_t* __restrict__ bias,
                                       long long m, int n, int N, const uint32_t acc[8],
                                       int shift, int leaky) {
    int16_t v[8];
#pragma unroll
    for (int e = 0; e < 8; ++e)
        v[e] = n + e < N ? requant_q16(acc[e], __ldg(bias + n + e), shift, leaky) : (int16_t)0;
    int16_t* dst = out + m * N + n;
    if ((N & 7) == 0) {
        int4 q;
        q.x = (int)(uint16_t)v[0] | ((int)v[1] << 16);
        q.y = (int)(uint16_t)v[2] | ((int)v[3] << 16);
        q.z = (int)(uint16_t)v[4] | ((int)v[5] << 16);
        q.w = (int)(uint16_t)v[6] | ((int)v[7] << 16);
        *reinterpret_cast<int4*>(dst) = q;
    } else {
#pragma unroll
        for (int e = 0; e < 8; ++e)
            if (n + e < N) dst[e] = v[e];
    }
}

// wp: the packed planes, one 2 * PLANE-byte block (high plane, then low)
// per BN columns and 32 k, indexed (n / BN) * (Kp / 32) + k / 32, with K
// padded to whole BK steps (Kp) and N to whole BN tiles, with zeros.
// ws (used when gridDim.z > 1): M*N uint32 sums, then one counter per
// output tile, all zero at launch.
template <class Loader>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
igemm_tc_kernel(const typename Loader::Params p, const uint8_t* __restrict__ wp,
                const int32_t* __restrict__ bias, int16_t* __restrict__ out,
                uint32_t* __restrict__ ws, long long M, int N, int K, int shift, int leaky,
                int ktiles_per_split) {
    extern __shared__ __align__(128) uint8_t smem[];
    int16_t* sA = reinterpret_cast<int16_t*>(smem);
    uint8_t* sB = smem + STAGES * A_STAGE * 2;

    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const long long m0 = (long long)blockIdx.x * BM;
    const int n0 = blockIdx.y * BN;
    const int ktiles = (K + BK - 1) / BK;
    const int kt0 = blockIdx.z * ktiles_per_split;
    const int nk = min(ktiles, kt0 + ktiles_per_split) - kt0;
    const Loader ld(p, m0, M, tid);
    // this column tile's planes; a stage (BK k) is 2 * BK / 32 planes,
    // contiguous in wp and in shared memory
    const uint8_t* wcol = wp + (long long)blockIdx.y * (ktiles * BK / 32) * 2 * PLANE;

    auto load_stage = [&](int s, int kt) {
        ld.load(sA + s * A_STAGE, kt * BK);
        const uint8_t* src = wcol + (long long)kt * B_STAGE;
#pragma unroll
        for (int j = 0; j < B_CHUNKS; ++j) {
            const int c = tid + j * THREADS;   // 16-byte chunk of the stage
            cp_async16(sB + s * B_STAGE + c * 16, src + c * 16, true);
        }
    };

    // warp w owns output rows 16w .. 16w+15: accumulator 4j + r of a set
    // is row 16w + g + 8 (r >> 1), column 8j + 2t + (r & 1)
    int32_t hh[32], md[32], ll[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) hh[i] = md[i] = ll[i] = 0;

#pragma unroll
    for (int s = 0; s < STAGES - 1; ++s) {
        if (s < nk) load_stage(s, kt0 + s);
        cp_async_commit();
    }

    // ldmatrix x4: lanes 8q .. 8q+7 address matrix q's rows; matrices 0-3
    // are (rows 0-7, k 0-7), (rows 8-15, k 0-7), (rows 0-7, k 8-15),
    // (rows 8-15, k 8-15) of a 16x16 int16 block
    const int lrow = (lane & 7) + ((lane >> 3) & 1) * 8, lcol = (lane >> 4) * 8;

    for (int t = 0; t < nk; ++t) {
        cp_async_wait<STAGES - 2>();
        fence_proxy_async();
        __syncthreads();
        // refill the slot that step t-1 read; every thread is past it, and
        // its wgmma finished before that step ended
        if (t + STAGES - 1 < nk) load_stage((t + STAGES - 1) % STAGES, kt0 + t + STAGES - 1);
        cp_async_commit();

        const int16_t* a = sA + (t % STAGES) * A_STAGE + (16 * warp + lrow) * A_LD + lcol;
        const uint8_t* b = sB + (t % STAGES) * B_STAGE;
        // rows g and g+8, fragment k 4t..4t+3 and 16+4t..16+4t+3, of each
        // 32-k chunk: the high and the low bytes
        uint32_t ah[BK / 32][4], al[BK / 32][4];
#pragma unroll
        for (int kc = 0; kc < BK / 32; ++kc) {
            uint32_t r[4], q[4];
            ldmatrix_x4(r, a + kc * 32);
            ldmatrix_x4(q, a + kc * 32 + 16);
            ah[kc][0] = __byte_perm(r[0], r[2], 0x7531);
            ah[kc][1] = __byte_perm(r[1], r[3], 0x7531);
            ah[kc][2] = __byte_perm(q[0], q[2], 0x7531);
            ah[kc][3] = __byte_perm(q[1], q[3], 0x7531);
            al[kc][0] = __byte_perm(r[0], r[2], 0x6420);
            al[kc][1] = __byte_perm(r[1], r[3], 0x6420);
            al[kc][2] = __byte_perm(q[0], q[2], 0x6420);
            al[kc][3] = __byte_perm(q[1], q[3], 0x6420);
        }
        wgmma_fence();
#pragma unroll
        for (int kc = 0; kc < BK / 32; ++kc) {
            const uint64_t bh = b_desc(b + kc * 2 * PLANE), bl = b_desc(b + kc * 2 * PLANE + PLANE);
            wgmma_ss(hh, ah[kc], bh);
            wgmma_su(md, ah[kc], bl);
            wgmma_us(md, al[kc], bh);
            wgmma_uu(ll, al[kc], bl);
        }
        wgmma_commit();
        wgmma_wait_all();
#pragma unroll
        for (int kc = 0; kc < BK / 32; ++kc)
#pragma unroll
            for (int i = 0; i < 4; ++i) fence_operand(ah[kc][i]), fence_operand(al[kc][i]);
#pragma unroll
        for (int i = 0; i < 32; ++i) fence_operand(hh[i]), fence_operand(md[i]), fence_operand(ll[i]);
    }
    cp_async_wait<0>();
    __syncthreads();

    const int g = lane >> 2, t4 = lane & 3;
    if (gridDim.z == 1) {
        uint32_t* sC = reinterpret_cast<uint32_t*>(smem);
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                const int row = 16 * warp + g + 8 * h, col = 8 * j + 2 * t4, i = 4 * j + 2 * h;
                *reinterpret_cast<uint2*>(sC + row * C_LD + col) =
                    make_uint2(combine(hh[i], md[i], ll[i]),
                               combine(hh[i + 1], md[i + 1], ll[i + 1]));
            }
        __syncthreads();
#pragma unroll
        for (int j = 0; j < BM * BN / 8 / THREADS; ++j) {
            const int i = tid + j * THREADS, r = i / (BN / 8), c = (i % (BN / 8)) * 8;
            const long long m = m0 + r;
            if (m >= M || n0 + c >= N) continue;
            const uint4 lo = *reinterpret_cast<const uint4*>(sC + r * C_LD + c);
            const uint4 hi = *reinterpret_cast<const uint4*>(sC + r * C_LD + c + 4);
            const uint32_t acc[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
            store8(out, bias, m, n0 + c, N, acc, shift, leaky);
        }
        return;
    }

    // split K: add this block's partial tile into the workspace
#pragma unroll
    for (int i = 0; i < 32; ++i) {
        const long long m = m0 + 16 * warp + g + 8 * ((i & 3) >> 1);
        const int n = n0 + 8 * (i >> 2) + 2 * t4 + (i & 1);
        if (m < M && n < N) atomicAdd(ws + m * N + n, combine(hh[i], md[i], ll[i]));
    }
    __threadfence();
    __syncthreads();
    __shared__ int last;
    if (tid == 0) {
        int* count = reinterpret_cast<int*>(ws + M * N) + blockIdx.y * gridDim.x + blockIdx.x;
        last = atomicAdd(count, 1) == (int)gridDim.z - 1;
    }
    __syncthreads();
    if (!last) return;
    __threadfence();
    // the last block of the tile: every split's sums are in the workspace
#pragma unroll
    for (int j = 0; j < BM * BN / 8 / THREADS; ++j) {
        const int i = tid + j * THREADS, r = i / (BN / 8), c = (i % (BN / 8)) * 8;
        const long long m = m0 + r;
        const int n = n0 + c;
        if (m >= M || n >= N) continue;
        uint32_t acc[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[e] = n + e < N ? __ldcg(ws + m * N + n + e) : 0u;
        store8(out, bias, m, n, N, acc, shift, leaky);
    }
}

// Launch on `stream`: one block per BM x BN output tile and split; the
// K steps of a split, ktiles_per_split, come from the wrapper (ops/q16.py:
// tc_split), at most KMAX / BK. With more than one split, ws holds M*N +
// (output tiles) uint32 and is zeroed here first; it may be null
// otherwise. Returns cudaGetLastError() after the launch.
template <class Loader>
inline cudaError_t launch_igemm_tc(const typename Loader::Params& p, const void* wp,
                                   const void* bias, void* out, void* ws, long long M, int N,
                                   int K, int shift, int leaky, int ktiles_per_split,
                                   void* stream) {
    static const cudaError_t attr = cudaFuncSetAttribute(
        igemm_tc_kernel<Loader>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
    if (attr != cudaSuccess) return attr;
    if (M <= 0 || N <= 0) return cudaGetLastError();
    if (ktiles_per_split < 1 || ktiles_per_split > KMAX / BK) return cudaErrorInvalidValue;
    const int ktiles = (K + BK - 1) / BK;
    const int splits = (ktiles + ktiles_per_split - 1) / ktiles_per_split;
    if (splits > 1 && ws == nullptr) return cudaErrorInvalidValue;
    const int ntiles = (N + BN - 1) / BN;
    const dim3 grid((unsigned)((M + BM - 1) / BM), (unsigned)ntiles, (unsigned)splits);
    if (splits > 1) {
        const size_t words = (size_t)M * N + (size_t)grid.x * grid.y;
        const cudaError_t err =
            cudaMemsetAsync(ws, 0, words * sizeof(uint32_t), (cudaStream_t)stream);
        if (err != cudaSuccess) return err;
    }
    igemm_tc_kernel<Loader><<<grid, THREADS, SMEM, (cudaStream_t)stream>>>(
        p, (const uint8_t*)wp, (const int32_t*)bias, (int16_t*)out, (uint32_t*)ws, M, N, K,
        shift, leaky, ktiles_per_split);
    return cudaGetLastError();
}

}  // namespace tc
}  // namespace yq
