// Exact integer GEMM on the 8-bit tensor cores, with the fused requant: the
// body of mm_q16.cu, conv3x3_q16.cu, conv3x3_pool_q16.cu, mm_w8a16.cu,
// conv3x3_w8a16.cu, mm_s8.cu and conv3x3_s8.cu (the general convs,
// conv_q16.cu, conv_w8a16.cu and conv_s8.cu, run on convk_tc.cuh, which
// reuses the pieces below).
//
//   out[m, n] = requant(sum_k A[m, k] * w[k, n]  (mod 2^32), bias[n], shift)
//
// and, for a conv fused with the 2x2/s2 maxpool after it, one output row per
// pool window: out[i, n] = the pool and requant, in one of three orders
// (PoolOrder), of the four sums of rows 4i .. 4i+3.
//
// The tensor cores multiply 8-bit operands into s32. Three operand schemes,
// chosen at compile time, reach them (the structs Q16, W8A16 and S8 below):
//
//   Q16    int16 A x int16 w, the int16 tier. Each int16 is cut into a signed
//          high byte and an unsigned low byte, x = 256*xh + xl with
//          xh = x >> 8 in [-128, 127] (s8) and xl = x & 255 in [0, 255] (u8),
//          and w alike. Then, as integers,
//            sum x*w = (sum xh*wh << 16) + ((sum xh*wl + sum xl*wh) << 8)
//                      + sum xl*wl,
//          and the integer wgmma takes s8 and u8 operands in any pairing, so
//          the four products need no correction constant. The two middle
//          products shift alike and share one accumulator: three s32 sets.
//          Per k, |xh*wh| <= 2^14, |xh*wl + xl*wh| <= 65280 and
//          xl*wl <= 65025: each partial sum is exact for K <= 32896.
//   W8A16  int16 A x int8 w, the w8a16 tier: A split as in Q16, w whole,
//            sum x*w = (sum xh*w << 8) + sum xl*w,
//          two sets; |xh*w| <= 2^14 and |xl*w| <= 32640, exact for
//          K <= 65793. The low byte stays unsigned, so the TPU kernels'
//          -128 offset and their nconst column constant do not carry over.
//   S8     int8 A x int8 w, the int8 tier: one set, |x*w| <= 2^14, exact for
//          K <= 131072.
//
// A block sums at most KMAX = 32768 values of k, so no partial sum relies on
// how the tensor cores overflow, and longer K is cut into splits (below).
// The sets are recombined in uint32_t, where the wrap is defined; SAME
// padding splits to zeros.
//
// Operands. Activations stay int16 or int8 in memory. A block computes a
// BM x BN output tile and walks its K range in K steps of 128 bytes of A per
// row (BK = 64 int16 or 128 int8 values of k) through a STAGES-deep ring of
// shared-memory tiles filled by cp.async (16 bytes per copy; a copy with
// source size 0 writes zeros, for SAME padding and ragged edges). The A tile
// arrives from a Loader: the activation rows (1x1 convs) or the implicit
// im2col of a SAME 3x3 window; rows or channels that do not come in whole
// 16-byte chunks are gathered by the threads into the same tiles. The block
// is one warpgroup: wgmma (m64n64k32) takes A from registers and B from
// shared memory through a descriptor.
// ldmatrix (b16) brings each warp's 16 rows of a 32-k chunk to registers.
// For 8-bit A that is the 8-bit A fragment itself (k 4t .. 4t+3 and
// 16+4t .. 16+4t+3 of rows g and g+8). For int16 A, __byte_perm separates
// the high and low bytes into two fragments, and that puts k values 2t,
// 2t+1, 8+2t, 9+2t (+16) where the fragment expects 4t .. 4t+3 (+16). The
// weights absorb this permutation: they are laid out as the descriptor reads
// them (8x16-byte core matrices, no swizzle), in the permuted order for
// int16 A and in natural order for int8 A, split into their high (s8) and
// low (u8) planes for Q16, once, at model build (ops/tc.py: FRAG_K, the
// permutation, and arrange_planes; ops/q16.py: pack_q16; ops/q8.py:
// pack_w8), so a B stage is one contiguous copy.
//
// Small M. Where the output tiles are too few to fill the card, the grid's
// z dimension cuts K into splits of ktiles_per_split K steps; each block
// adds its uint32 partial tile into a zeroed workspace with atomicAdd (sums
// mod 2^32 are exact in any order, so the result does not depend on it),
// and the block that finishes a tile last requantizes it. The epilogue of
// an unsplit block stages its tile through shared memory, reads each
// column's bias and shift once, and every output leaves as 16 bytes (eight
// int16) or 8 bytes (eight int8) per thread where N allows.
//
// The pool. A conv whose loader visits the output pixels window-major
// (ConvTc<T, true>) has the four members of pool window i in rows 4i .. 4i+3
// of M, so a 64-row tile holds 16 whole windows. Both exits then hand each
// thread one window and 8 columns: it reads the window's four rows of sums
// (from the staged tile, or from the workspace in the last block of a split
// tile), pools and requantizes them in the epilogue's order (EpiPool) and
// writes 16 bytes of the pooled row; the conv's own output never reaches
// device memory.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "requant.cuh"

namespace yq {
namespace tc {

// A block of 4 warps (one warpgroup, 16 rows each) computes a 64 x 64 tile.
constexpr int BM = 64, BN = 64, THREADS = 128;
constexpr int A_ROW = 128;          // bytes of an A row per K step
constexpr int A_LD = A_ROW + 16;    // bytes per A row in shared memory: the 8
                                    // rows of an ldmatrix hit 8 distinct
                                    // 16-byte bank groups
constexpr int A_STAGE = BM * A_LD;  // bytes per A stage
constexpr int ROW_STEP = THREADS / 8;   // rows between a thread's A chunks
constexpr int C_LD = BN + 8;        // uint32 per staged output row
constexpr int PLANE = 32 * BN;      // bytes of one plane of a (32 k, BN n) B chunk
constexpr int KMAX = 32768;         // k per s32 partial sum

// The epilogues: what an output column needs (Col, read once per column),
// and the requant of one sum into the output type.
// One shift for the layer, int16 output: the int16 tier. A column carries
// only its index, and bias[n] is read at the store, which keeps the
// epilogue the compiler makes for this tier as small as it was before the
// other schemes shared the body.
struct EpiLayer {
    using Out = int16_t;
    static constexpr bool POOL = false;
    struct Col {
        int n;
    };
    const int32_t* bias;  // (N,)
    int16_t* out;         // (M, N)
    int shift, leaky;

    __device__ __forceinline__ Col column(int n) const { return {n}; }
    __device__ __forceinline__ Out requant(uint32_t acc, Col c) const {
        return requant_q16(acc, __ldg(bias + c.n), shift, leaky);
    }
};

// One shift per output channel, int8 or int16 output: the 8-bit-weight
// tiers (a per-layer shift arrives broadcast).
template <class Out_>
struct EpiChannel {
    using Out = Out_;
    static constexpr bool POOL = false;
    struct Col {
        int32_t bias;
        int shift;
    };
    const int32_t* bias;   // (N,)
    const int32_t* shift;  // (N,)
    Out* out;              // (M, N)
    int leaky;

    __device__ __forceinline__ Col column(int n) const {
        return {__ldg(bias + n), __ldg(shift + n)};
    }
    __device__ __forceinline__ Out requant(uint32_t acc, Col c) const {
        return (Out)yq::requant<Range<Out>::lo, Range<Out>::hi>(acc, c.bias, c.shift, leaky);
    }
};

// Where a conv fused with the following 2x2/s2 maxpool takes the pool's
// max, which is a different function once acc + 2^(shift-1) wraps: on the
// four sums; on each horizontal pair's sums, then on the requantized pair
// maxima; or on the four requantized values.
enum PoolOrder { kPoolAcc = 0, kPoolAccH = 1, kPoolOut = 2 };

// The signed int32 max of two wrapped sums (an unsigned max is wrong as
// soon as a sum wraps negative).
__device__ __forceinline__ uint32_t max_s32(uint32_t a, uint32_t b) {
    return (int32_t)a > (int32_t)b ? a : b;
}

// EpiLayer with the pool: out is (M / 4, N), one row per pool window, and
// pool() takes the sums a[q] of the window's members q = 2 * dy + dx.
template <int ORDER>
struct EpiPool {
    using Out = int16_t;
    static constexpr bool POOL = true;
    struct Col {
        int n;
    };
    const int32_t* bias;  // (N,)
    int16_t* out;         // (M / 4, N)
    int shift, leaky;

    __device__ __forceinline__ Col column(int n) const { return {n}; }
    __device__ __forceinline__ Out pool(const uint32_t a[4], Col c) const {
        const int32_t b = __ldg(bias + c.n);
        if constexpr (ORDER == kPoolAcc) {
            return requant_q16(max_s32(max_s32(a[0], a[1]), max_s32(a[2], a[3])), b, shift,
                               leaky);
        } else if constexpr (ORDER == kPoolAccH) {
            const int16_t top = requant_q16(max_s32(a[0], a[1]), b, shift, leaky);
            const int16_t bot = requant_q16(max_s32(a[2], a[3]), b, shift, leaky);
            return top > bot ? top : bot;
        } else {
            int16_t v = requant_q16(a[0], b, shift, leaky);
#pragma unroll
            for (int q = 1; q < 4; ++q) {
                const int16_t r = requant_q16(a[q], b, shift, leaky);
                v = r > v ? r : v;
            }
            return v;
        }
    }
};

// The operand schemes. Each fixes the type of A, the weight planes, the s32
// accumulator sets, the epilogue, a STAGES-deep ring and the blocks per SM
// asked of the compiler (MIN_BLOCKS; yq_tc_config reports them, and
// ops/tc.py's Scheme holds what the wrappers need of them). Several blocks stay on an SM (Q16 and
// W8A16: three, by the registers of 3 x 128 threads and 3 x 68 or 52 KB of
// shared memory; S8, whose one accumulator set needs fewer registers: four,
// with a 3-stage ring of 51 KB), so where a block has few K steps (a large
// M and a small K, the entry conv) one block's loads and epilogue overlap
// the others' products. On an H100,
// chip_smoke.py found 64x128 and 128x128 tiles (two or one blocks per SM)
// slower for S8 and W8A16, and so was keeping two wgmma groups in flight
// (PERF.md).
struct Q16 {
    using A = int16_t;
    using Epi = EpiLayer;
    static constexpr int ID = 0, PLANES = 2, SETS = 3, STAGES = 4, MIN_BLOCKS = 3;
};
struct W8A16 {
    using A = int16_t;
    using Epi = EpiChannel<int16_t>;
    static constexpr int ID = 1, PLANES = 1, SETS = 2, STAGES = 4, MIN_BLOCKS = 3;
};
struct S8 {
    using A = int8_t;
    using Epi = EpiChannel<int8_t>;
    static constexpr int ID = 2, PLANES = 1, SETS = 1, STAGES = 3, MIN_BLOCKS = 4;
};
// S8 with an int16 output: the int8 tier's conv that feeds the region head.
struct S8Out16 : S8 {
    using Epi = EpiChannel<int16_t>;
};
// Q16 with the 2x2/s2 pool in the epilogue, one scheme per pool order: the
// int16 tier's conv fused with the pool after it.
template <int ORDER>
struct Q16Pool : Q16 {
    using Epi = EpiPool<ORDER>;
};

template <class S>
struct Tile {
    static constexpr int AP = sizeof(typename S::A);         // A byte planes (fragments)
    static constexpr int BK = A_ROW / AP;                    // k per K step
    static constexpr int KC = BK / 32;                       // 32-k chunks per K step
    static constexpr int B_STAGE = KC * S::PLANES * PLANE;   // bytes per B stage
    static constexpr int B_CHUNKS = B_STAGE / 16 / THREADS;  // 16-byte copies per thread
    static constexpr int SMEM = S::STAGES * (A_STAGE + B_STAGE);
    static_assert(BM * A_ROW / 16 == 4 * THREADS, "each thread copies 4 A chunks per stage");
    static_assert(B_CHUNKS * 16 * THREADS == B_STAGE, "threads cover a B stage");
    static_assert(BM * C_LD * 4 <= SMEM, "the staged output tile fits the ring");
    static_assert(KMAX % BK == 0, "a split's K is whole K steps");
    static_assert(BM / 4 * (BN / 8) == THREADS,
                  "a pooled exit gives each thread one window and 8 columns");
};

// Host side: whether rows of `bytes` bytes at base x take 16-byte copies.
inline int vec16(const void* x, long long bytes) {
    return (bytes % 16 == 0 && (uintptr_t)x % 16 == 0) ? 1 : 0;
}

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

// The sets of one output, recombined modulo 2^32.
template <class S, int N>
__device__ __forceinline__ uint32_t combine(const int32_t (&acc)[S::SETS][N], int i) {
    if constexpr (S::SETS == 3) {   // Q16: hh, mid, ll
        return ((uint32_t)acc[0][i] << 16) + ((uint32_t)acc[1][i] << 8) + (uint32_t)acc[2][i];
    } else if constexpr (S::SETS == 2) {   // W8A16: xh*w, xl*w
        return ((uint32_t)acc[0][i] << 8) + (uint32_t)acc[1][i];
    } else {
        return (uint32_t)acc[0][i];
    }
}

// Sixteen bytes of A values (16 / sizeof(T) of them) as a scalar gather:
// value(k + e), or 0 where k + e lies past K.
template <class T, class F>
__device__ __forceinline__ int4 gather16(int k, int K, F value) {
    using U = std::make_unsigned_t<T>;
    constexpr int BITS = 8 * (int)sizeof(T);
    uint32_t q[4] = {0u, 0u, 0u, 0u};
#pragma unroll
    for (int e = 0; e < 128 / BITS; ++e) {
        const T v = (k + e < K) ? value(k + e) : (T)0;
        q[e * BITS / 32] |= (uint32_t)(U)v << (e * BITS % 32);
    }
    return make_int4((int)q[0], (int)q[1], (int)q[2], (int)q[3]);
}

// A loaders. Each thread fills 4 chunks of 16 bytes per stage: rows
// r0 + ROW_STEP j (j < 4) of the tile, bytes 16 c8 .. 16 c8 + 15 of the row,
// that is k0 + V c8 .. + V - 1 with V = 16 / sizeof(T) values per chunk.
// MmTc<T>: the (M, K) activation rows of a 1x1 conv; ConvTc<T>: the implicit
// im2col of a SAME 3x3 window, row m the output pixel m in (b, y, x) order;
// ConvTc<T, true>: the same with the pixels visited window-major for a conv
// a 2x2/s2 pool follows (H and W even): row m is member q = m & 3 of pool
// window m >> 2, the pixel (2 ho + q / 2, 2 wo + q % 2) of window (b, ho, wo),
// so rows 4i .. 4i+3 are the four members of window i. vec: 16-byte
// copies (the row length in bytes is a multiple of 16 and the base 16-byte
// aligned); otherwise each value is loaded on its own (ConvTc gathers a C
// small enough that one K step holds all of 9C, the entry conv, by kernel
// rows instead).
template <class T_>
struct MmTc {
    using T = T_;
    static constexpr int V = 16 / (int)sizeof(T);  // values per chunk
    struct Params {
        const T* x;  // (M, K) row-major
        int K;
        int vec;
    };
    const T* x;
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

    __device__ __forceinline__ void load(uint8_t* sA, int k0) const {
        const int k = k0 + V * c8;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            T* dst = reinterpret_cast<T*>(sA + (r0 + ROW_STEP * j) * A_LD) + V * c8;
            const bool ok = m[j] >= 0 && k < K;
            const T* row = x + (long long)(ok ? m[j] : 0) * K;
            if (vec) {
                cp_async16(dst, ok ? row + k : x, ok);
            } else {
                *reinterpret_cast<int4*>(dst) =
                    ok ? gather16<T>(k, K, [&](int kk) { return row[kk]; })
                       : make_int4(0, 0, 0, 0);
            }
        }
    }
};

template <class T_, bool WINDOWS = false>
struct ConvTc {
    using T = T_;
    static constexpr int V = 16 / (int)sizeof(T);        // values per chunk
    static constexpr int BK = A_ROW / (int)sizeof(T);    // values per row and K step
    struct Params {
        const T* x;  // (B, H, W, C) row-major
        int H, W, C;
        int vec;
    };
    const T* x;
    int H, W, C, K, vec, r0, c8;
    int m[4], y[4], xw[4];  // each row's pixel (b, y, x) as one index and
                            // its (y, x); m = -1 past M

    __device__ ConvTc(const Params& p, long long m0, long long M, int tid)
        : x(p.x), H(p.H), W(p.W), C(p.C), K(9 * p.C), vec(p.vec), r0(tid >> 3), c8(tid & 7) {
        const int hw = p.H * p.W;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            const long long mm = m0 + r0 + ROW_STEP * j;
            if constexpr (WINDOWS) {
                const int win = mm < M ? (int)(mm >> 2) : 0, q = (int)(mm & 3);
                const int b = win / (hw / 4), r = win - b * (hw / 4);
                const int ho = r / (p.W / 2);
                y[j] = 2 * ho + (q >> 1);
                xw[j] = 2 * (r - ho * (p.W / 2)) + (q & 1);
                m[j] = mm < M ? b * hw + y[j] * p.W + xw[j] : -1;
            } else {
                m[j] = mm < M ? (int)mm : -1;
                const int r = m[j] >= 0 ? m[j] % hw : 0;
                y[j] = r / p.W;
                xw[j] = r - y[j] * p.W;
            }
        }
    }

    // input value of row j at im2col column k, 0 in the SAME padding
    __device__ __forceinline__ T at(int j, int k) const {
        const int tap = k / C, c = k - tap * C;
        const int dy = tap / 3 - 1, dx = tap % 3 - 1;
        const int iy = y[j] + dy, ix = xw[j] + dx;
        if (iy < 0 || iy >= H || ix < 0 || ix >= W) return 0;
        return x[(long long)(m[j] + dy * W + dx) * C + c];
    }

    __device__ __forceinline__ T* row(uint8_t* sA, int j) const {
        return reinterpret_cast<T*>(sA + (r0 + ROW_STEP * j) * A_LD);
    }

    __device__ __forceinline__ void load(uint8_t* sA, int k0) const {
        const int k = k0 + V * c8;
        if (vec) {
            // C % V == 0: the chunk's V values share one tap
            const int tap = k < K ? k / C : 0;
            const int c = k - tap * C;
            const int dy = tap / 3 - 1, dx = tap % 3 - 1;
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                const int iy = y[j] + dy, ix = xw[j] + dx;
                const bool ok = m[j] >= 0 && k < K && iy >= 0 && iy < H && ix >= 0 && ix < W;
                const T* src = ok ? x + (long long)(m[j] + dy * W + dx) * C + c : x;
                cp_async16(row(sA, j) + V * c8, src, ok);
            }
            return;
        }
        if (9 * C <= BK) {
            // one K step holds the whole window (the entry conv). Kernel row
            // dy of a row's window is one run of 3C contiguous input values,
            // the pixels (y+dy-1, x-1 .. x+1): k = 3C dy + r is value r of
            // that run. In each pass over 32 k, thread c8 takes k = 4 c8 ..
            // 4 c8 + 3 of its 4 rows (zeros from K up to BK, with no index
            // work where all four lie past K): the 8 threads of a row read
            // 32 neighbouring values, the 16 loads of a pass are all in
            // flight before its first store, and a row's four values leave
            // as one store.
            struct alignas(4 * sizeof(T)) Quad {
                T v[4];
            };
            const int run = 3 * C;
#pragma unroll 1
            for (int k0 = 4 * c8; k0 < BK; k0 += 32) {
                if (k0 >= K) {
#pragma unroll
                    for (int j = 0; j < 4; ++j) *reinterpret_cast<Quad*>(row(sA, j) + k0) = Quad{};
                    continue;
                }
                int off[4];   // value k's offset from the row's pixel
                int tap[4];   // dy | dx << 2, or -1 past K
#pragma unroll
                for (int i = 0; i < 4; ++i) {
                    const int k = k0 + i;
                    const int dy = (k >= run) + (k >= 2 * run), r = k - dy * run;
                    const int dx = (r >= C) + (r >= 2 * C);
                    off[i] = (dy - 1) * W * C + r - C;
                    tap[i] = k < K ? dy | (dx << 2) : -1;
                }
                Quad q[4];
#pragma unroll
                for (int j = 0; j < 4; ++j) {
                    const T* px = x + (long long)(m[j] >= 0 ? m[j] : 0) * C;
#pragma unroll
                    for (int i = 0; i < 4; ++i) {
                        const int iy = y[j] + (tap[i] & 3) - 1, ix = xw[j] + (tap[i] >> 2) - 1;
                        const bool ok = m[j] >= 0 && tap[i] >= 0 && iy >= 0 && iy < H &&
                                        ix >= 0 && ix < W;
                        q[j].v[i] = ok ? px[off[i]] : (T)0;
                    }
                }
#pragma unroll
                for (int j = 0; j < 4; ++j) *reinterpret_cast<Quad*>(row(sA, j) + k0) = q[j];
            }
            return;
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            *reinterpret_cast<int4*>(row(sA, j) + V * c8) =
                m[j] >= 0 ? gather16<T>(k, K, [&](int kk) { return at(j, kk); })
                          : make_int4(0, 0, 0, 0);
        }
    }
};

// Store v as row[n .. n+7] of an output row of N values (columns past N
// dropped), as one 16-byte (int16) or 8-byte (int8) store where the row
// allows.
template <class Out>
__device__ __forceinline__ void store_values(Out* row, int n, int N, const Out v[8]) {
    using U = std::make_unsigned_t<Out>;
    Out* dst = row + n;
    if ((N & 7) == 0) {
        if constexpr (sizeof(Out) == 2) {
            uint4 q;
            q.x = (uint32_t)(U)v[0] | ((uint32_t)(U)v[1] << 16);
            q.y = (uint32_t)(U)v[2] | ((uint32_t)(U)v[3] << 16);
            q.z = (uint32_t)(U)v[4] | ((uint32_t)(U)v[5] << 16);
            q.w = (uint32_t)(U)v[6] | ((uint32_t)(U)v[7] << 16);
            *reinterpret_cast<uint4*>(dst) = q;
        } else {
            uint2 q;
            q.x = (uint32_t)(U)v[0] | ((uint32_t)(U)v[1] << 8) | ((uint32_t)(U)v[2] << 16) |
                  ((uint32_t)(U)v[3] << 24);
            q.y = (uint32_t)(U)v[4] | ((uint32_t)(U)v[5] << 8) | ((uint32_t)(U)v[6] << 16) |
                  ((uint32_t)(U)v[7] << 24);
            *reinterpret_cast<uint2*>(dst) = q;
        }
    } else {
#pragma unroll
        for (int e = 0; e < 8; ++e)
            if (n + e < N) dst[e] = v[e];
    }
}

// Requantize the eight sums of out[m, n .. n+7] and store them.
template <class Epi>
__device__ __forceinline__ void store8(const Epi& ep, long long m, int n, int N,
                                       const uint32_t acc[8], const typename Epi::Col col[8]) {
    typename Epi::Out v[8];
#pragma unroll
    for (int e = 0; e < 8; ++e)
        v[e] = n + e < N ? ep.requant(acc[e], col[e]) : (typename Epi::Out)0;
    store_values(ep.out + m * N, n, N, v);
}

// The pooled exits (Epi::POOL): pool window m / 4, whose members' sums are
// rows m .. m+3 of M, at columns n .. n+7 -> out[m / 4, n .. n+7]. row(q, s)
// reads the eight sums of row m + q into s. M is a multiple of 4, so a
// window lies wholly inside M or wholly past it.
template <class Epi, class F>
__device__ __forceinline__ void store_window(const Epi& ep, long long m, long long M, int n,
                                             int N, const typename Epi::Col col[8], F row) {
    if (m >= M || n >= N) return;
    uint32_t s[4][8];
#pragma unroll
    for (int q = 0; q < 4; ++q) row(q, s[q]);
    typename Epi::Out v[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
        const uint32_t a[4] = {s[0][e], s[1][e], s[2][e], s[3][e]};
        v[e] = n + e < N ? ep.pool(a, col[e]) : (typename Epi::Out)0;
    }
    store_values(ep.out + (m / 4) * N, n, N, v);
}

// wp: the packed planes, per BN columns and 32 k one block of PLANES planes
// of PLANE bytes, indexed (n / BN) * (Kp / 32) + k / 32, with K padded to
// whole K steps (Kp) and N to whole BN tiles, with zeros.
// ws (used when gridDim.z > 1): M*N uint32 sums, then one counter per
// output tile, all zero at launch. With a pooled epilogue M counts the
// conv's rows (the loader's, window-major) and e.out has M / 4.
template <class S, class Loader>
__global__ void __launch_bounds__(THREADS, S::MIN_BLOCKS)
igemm_tc_kernel(const typename Loader::Params p, const uint8_t* __restrict__ wp,
                const typename S::Epi e, uint32_t* __restrict__ ws, long long M, int N, int K,
                int ktiles_per_split) {
    using T = Tile<S>;
    constexpr int STAGES = S::STAGES, BK = T::BK, KC = T::KC;
    static_assert(std::is_same<typename Loader::T, typename S::A>::value,
                  "the loader gives the scheme's A type");
    extern __shared__ __align__(128) uint8_t smem[];
    uint8_t* sA = smem;
    uint8_t* sB = smem + STAGES * A_STAGE;

    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const long long m0 = (long long)blockIdx.x * BM;
    const int n0 = blockIdx.y * BN;
    const int ktiles = (K + BK - 1) / BK;
    const int kt0 = blockIdx.z * ktiles_per_split;
    const int nk = min(ktiles, kt0 + ktiles_per_split) - kt0;
    const Loader ld(p, m0, M, tid);
    // this column tile's planes; a stage (BK k) is B_STAGE bytes, contiguous
    // in wp and in shared memory
    const uint8_t* wcol = wp + (long long)blockIdx.y * ktiles * T::B_STAGE;

    auto load_stage = [&](int s, int kt) {
        ld.load(sA + s * A_STAGE, kt * BK);
        const uint8_t* src = wcol + (long long)kt * T::B_STAGE;
#pragma unroll
        for (int j = 0; j < T::B_CHUNKS; ++j) {
            const int c = tid + j * THREADS;   // 16-byte chunk of the stage
            cp_async16(sB + s * T::B_STAGE + c * 16, src + c * 16, true);
        }
    };

    // warp w owns output rows 16w .. 16w+15: accumulator 4j + r of a set is
    // row 16w + g + 8 (r >> 1), column 8j + 2t + (r & 1)
    int32_t acc[S::SETS][32];
#pragma unroll
    for (int s = 0; s < S::SETS; ++s)
#pragma unroll
        for (int i = 0; i < 32; ++i) acc[s][i] = 0;

#pragma unroll
    for (int s = 0; s < STAGES - 1; ++s) {
        if (s < nk) load_stage(s, kt0 + s);
        cp_async_commit();
    }

    // ldmatrix x4: lanes 8q .. 8q+7 address matrix q's rows; matrices 0-3
    // are (rows 0-7, bytes 0-15), (rows 8-15, bytes 0-15), (rows 0-7, bytes
    // 16-31), (rows 8-15, bytes 16-31) of a 16-row x 32-byte block
    const int lrow = (lane & 7) + ((lane >> 3) & 1) * 8, lcol = (lane >> 4) * 16;

    for (int t = 0; t < nk; ++t) {
        cp_async_wait<STAGES - 2>();
        fence_proxy_async();
        __syncthreads();
        // refill the slot that step t-1 read; every thread is past it, and
        // its wgmma finished before that step ended
        if (t + STAGES - 1 < nk) load_stage((t + STAGES - 1) % STAGES, kt0 + t + STAGES - 1);
        cp_async_commit();

        const uint8_t* a = sA + (t % STAGES) * A_STAGE + (16 * warp + lrow) * A_LD + lcol;
        const uint8_t* b = sB + (t % STAGES) * T::B_STAGE;
        // the B planes of chunk kc
        auto bplane = [&](int kc, int plane) {
            return b_desc(b + (kc * S::PLANES + plane) * PLANE);
        };
        // rows g and g+8, fragment k 4t..4t+3 and 16+4t..16+4t+3, of each
        // 32-k chunk: for int16 A the high bytes in fa[0] and the low bytes
        // in fa[1]
        uint32_t fa[T::AP][KC][4];
#pragma unroll
        for (int kc = 0; kc < KC; ++kc) {
            if constexpr (T::AP == 2) {
                // a 32-k chunk of int16 is 64 bytes: split its bytes
                uint32_t r[4], q[4];
                ldmatrix_x4(r, a + kc * 64);
                ldmatrix_x4(q, a + kc * 64 + 32);
                fa[0][kc][0] = __byte_perm(r[0], r[2], 0x7531);
                fa[0][kc][1] = __byte_perm(r[1], r[3], 0x7531);
                fa[0][kc][2] = __byte_perm(q[0], q[2], 0x7531);
                fa[0][kc][3] = __byte_perm(q[1], q[3], 0x7531);
                fa[1][kc][0] = __byte_perm(r[0], r[2], 0x6420);
                fa[1][kc][1] = __byte_perm(r[1], r[3], 0x6420);
                fa[1][kc][2] = __byte_perm(q[0], q[2], 0x6420);
                fa[1][kc][3] = __byte_perm(q[1], q[3], 0x6420);
            } else {
                // a 32-k chunk of int8 (32 bytes) is the fragment as it is
                ldmatrix_x4(fa[0][kc], a + kc * 32);
            }
        }
        wgmma_fence();
#pragma unroll
        for (int kc = 0; kc < KC; ++kc) {
            if constexpr (S::SETS == 3) {   // Q16: hh, mid, ll
                const uint64_t bh = bplane(kc, 0), bl = bplane(kc, 1);
                wgmma_ss(acc[0], fa[0][kc], bh);
                wgmma_su(acc[1], fa[0][kc], bl);
                wgmma_us(acc[1], fa[1][kc], bh);
                wgmma_uu(acc[2], fa[1][kc], bl);
            } else if constexpr (S::SETS == 2) {   // W8A16: xh*w, xl*w
                const uint64_t bw = bplane(kc, 0);
                wgmma_ss(acc[0], fa[0][kc], bw);
                wgmma_us(acc[1], fa[1][kc], bw);
            } else {   // S8
                wgmma_ss(acc[0], fa[0][kc], bplane(kc, 0));
            }
        }
        wgmma_commit();
        wgmma_wait_all();
#pragma unroll
        for (int p = 0; p < T::AP; ++p)
#pragma unroll
            for (int kc = 0; kc < KC; ++kc)
#pragma unroll
                for (int i = 0; i < 4; ++i) fence_operand(fa[p][kc][i]);
#pragma unroll
        for (int s = 0; s < S::SETS; ++s)
#pragma unroll
            for (int i = 0; i < 32; ++i) fence_operand(acc[s][i]);
    }
    cp_async_wait<0>();
    __syncthreads();

    // each thread's 8 output columns are the same in every pass below: read
    // their bias and shift once
    const int g = lane >> 2, t4 = lane & 3;
    const int c = (tid % (BN / 8)) * 8;
    typename S::Epi::Col col[8];
#pragma unroll
    for (int j = 0; j < 8; ++j)
        col[j] = n0 + c + j < N ? e.column(n0 + c + j) : typename S::Epi::Col{};
    if (gridDim.z == 1) {
        uint32_t* sC = reinterpret_cast<uint32_t*>(smem);
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                const int row = 16 * warp + g + 8 * h, col = 8 * j + 2 * t4, i = 4 * j + 2 * h;
                *reinterpret_cast<uint2*>(sC + row * C_LD + col) =
                    make_uint2(combine<S>(acc, i), combine<S>(acc, i + 1));
            }
        __syncthreads();
        if constexpr (S::Epi::POOL) {
            // thread tid: window tid / 8 of the tile's 16, columns c .. c+7
            const int r = 4 * (tid / (BN / 8));
            store_window(e, m0 + r, M, n0 + c, N, col, [&](int q, uint32_t s[8]) {
                const uint4 lo = *reinterpret_cast<const uint4*>(sC + (r + q) * C_LD + c);
                const uint4 hi = *reinterpret_cast<const uint4*>(sC + (r + q) * C_LD + c + 4);
                s[0] = lo.x, s[1] = lo.y, s[2] = lo.z, s[3] = lo.w;
                s[4] = hi.x, s[5] = hi.y, s[6] = hi.z, s[7] = hi.w;
            });
        } else {
#pragma unroll
            for (int j = 0; j < BM * BN / 8 / THREADS; ++j) {
                const int r = (tid + j * THREADS) / (BN / 8);
                const long long m = m0 + r;
                if (m >= M || n0 + c >= N) continue;
                const uint4 lo = *reinterpret_cast<const uint4*>(sC + r * C_LD + c);
                const uint4 hi = *reinterpret_cast<const uint4*>(sC + r * C_LD + c + 4);
                const uint32_t sums[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
                store8(e, m, n0 + c, N, sums, col);
            }
        }
        return;
    }

    // split K: add this block's partial tile into the workspace
#pragma unroll
    for (int i = 0; i < 32; ++i) {
        const long long m = m0 + 16 * warp + g + 8 * ((i & 3) >> 1);
        const int n = n0 + 8 * (i >> 2) + 2 * t4 + (i & 1);
        if (m < M && n < N) atomicAdd(ws + m * N + n, combine<S>(acc, i));
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
    if constexpr (S::Epi::POOL) {
        const long long m = m0 + 4 * (tid / (BN / 8));
        const int n = n0 + c;
        store_window(e, m, M, n, N, col, [&](int q, uint32_t s[8]) {
#pragma unroll
            for (int i = 0; i < 8; ++i)
                s[i] = n + i < N ? __ldcg(ws + (m + q) * N + n + i) : 0u;
        });
    } else {
#pragma unroll
        for (int j = 0; j < BM * BN / 8 / THREADS; ++j) {
            const int r = (tid + j * THREADS) / (BN / 8);
            const long long m = m0 + r;
            const int n = n0 + c;
            if (m >= M || n >= N) continue;
            uint32_t sums[8];
#pragma unroll
            for (int i = 0; i < 8; ++i) sums[i] = n + i < N ? __ldcg(ws + m * N + n + i) : 0u;
            store8(e, m, n, N, sums, col);
        }
    }
}

// Launch on `stream`: one block per BM x BN output tile and split; the
// K steps of a split, ktiles_per_split, come from the wrapper (ops/tc.py:
// split), at most KMAX / BK. With more than one split, ws holds M*N +
// (output tiles) uint32 and is zeroed here first; it may be null
// otherwise. Returns cudaGetLastError() after the launch.
template <class S, class Loader>
inline cudaError_t launch_igemm_tc(const typename Loader::Params& p, const void* wp,
                                   const typename S::Epi& e, void* ws, long long M, int N,
                                   int K, int ktiles_per_split, void* stream) {
    using T = Tile<S>;
    static const cudaError_t attr = cudaFuncSetAttribute(
        igemm_tc_kernel<S, Loader>, cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
    if (attr != cudaSuccess) return attr;
    if (M <= 0 || N <= 0) return cudaGetLastError();
    if (ktiles_per_split < 1 || ktiles_per_split > KMAX / T::BK) return cudaErrorInvalidValue;
    const int ktiles = (K + T::BK - 1) / T::BK;
    const int splits = (ktiles + ktiles_per_split - 1) / ktiles_per_split;
    if (splits > 1 && ws == nullptr) return cudaErrorInvalidValue;
    const dim3 grid((unsigned)((M + BM - 1) / BM), (unsigned)((N + BN - 1) / BN),
                    (unsigned)splits);
    if (splits > 1) {
        const size_t words = (size_t)M * N + (size_t)grid.x * grid.y;
        const cudaError_t err =
            cudaMemsetAsync(ws, 0, words * sizeof(uint32_t), (cudaStream_t)stream);
        if (err != cudaSuccess) return err;
    }
    igemm_tc_kernel<S, Loader><<<grid, THREADS, T::SMEM, (cudaStream_t)stream>>>(
        p, (const uint8_t*)wp, e, (uint32_t*)ws, M, N, K, ktiles_per_split);
    return cudaGetLastError();
}

// Scheme s's tile, as the wrappers must know it: what = 0 BM, 1 BN, 2 BK,
// 3 dynamic shared memory bytes per block, 4 blocks per SM asked of the
// compiler, 5 planes, 6 KMAX; -1 for anything else.
template <class S>
inline int config(int what) {
    using T = Tile<S>;
    const int v[] = {BM, BN, T::BK, T::SMEM, S::MIN_BLOCKS, S::PLANES, KMAX};
    return what >= 0 && what < 7 ? v[what] : -1;
}
inline int config(int scheme, int what) {
    return scheme == Q16::ID     ? config<Q16>(what)
           : scheme == W8A16::ID ? config<W8A16>(what)
           : scheme == S8::ID    ? config<S8>(what)
                                 : -1;
}

}  // namespace tc
}  // namespace yq
