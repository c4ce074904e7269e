// The general convs on the 8-bit tensor cores, designed for Hopper: the body
// of conv_q16.cu (scheme Q16, EpiLayer), conv_w8a16.cu (W8A16,
// EpiChannel<int16_t>) and conv_s8.cu (S8, EpiChannel<int8_t>; S8Out16,
// EpiChannel<int16_t>, for the int8 tier's head16 conv).
//
//   out[m, n] = requant(sum_k A[m, k] * w[k, n]  (mod 2^32), bias[n], shift)
//
// with A the implicit im2col of any k x k conv, any stride and zero padding
// (Params and ConvRows below). It reuses igemm_tc.cuh's operand schemes,
// epilogues, combine<S> and its wgmma, ldmatrix and cp.async helpers, whose
// code it does not change. What differs from igemm_tc_kernel, and why
// (PERF.md, section 6):
//
// Warp-specialized blocks. A block is one producer warpgroup and one or two
// consumer warpgroups (64 rows of the output tile each). The producers
// gather each stage's A rows by cp.async and copy its B stage by TMA; both
// complete on the stage's `full` mbarrier. The consumers wait on it, split
// the int16 bytes in registers (int8 A is the fragment as ldmatrix gives
// it) and run the stage's wgmma, then arrive on its `empty` mbarrier, which
// lets the producers refill it; they also run the epilogues. setmaxnreg
// gives the consumers the registers: in the first design (one block per
// tile, each thread loading and multiplying) the loads' address work and
// the wgmma's wait sat in one thread's path, and a K step took about 2,000
// clocks.
//
// A K step is 128 bytes of A a row: 64 k of int16 (two 32-k chunks) or 128
// k of int8 (four), so an S8 conv gathers the same bytes in half the K
// steps of an int16 one, and its B stage is as large as Q16's.
//
// A persistent schedule (ops/tc.py: stream_k). The grid is at most the SMs
// times the blocks that stay on one. The work is every (output tile, K
// step) unit of the conv, tile-major; block b takes an even, contiguous
// share of it, of whole tiles where that costs no more (no sharing at all),
// else of single units (stream-K: no wave is left part-filled), and walks
// across tile boundaries while the ring keeps loading. A block's run of K
// steps within one tile (a segment) also ends at every KMAX / BK steps,
// since an s32 set sums at most KMAX values of k. A tile that one segment
// computes whole is requantized from the accumulators. A shared tile's
// segments leave their uint32 partial tiles in the workspace, each block in
// one of its two regions (its first segment, its last: the only ones of a
// share that can be part of a tile), stored as the threads hold them, and
// add their step counts to the tile's counter; the segment that brings it
// to the tile's K steps adds the other blocks' partials to its own (sums mod
// 2^32, so the order does not matter) and requantizes. The counter of a
// shared tile is the block that owns its first unit (each such block ends
// its share inside that tile, so they are unique and fewer than the grid).
// Past KMAX a tile's segments add into a zeroed slot of the tile's own with
// atomicAdd instead.
//
// An output tile fit to the layer (ops/tc.py: convk_tile): BN = 32 where
// N <= 32 (wgmma m64n32k32: the 416^2 x 32 conv spends no tensor-core work
// and no B bytes on zero columns), else 64; BM = 128 for a large Q16 conv,
// whose two consumers share each B stage, else 64.
//
// B by the Tensor Memory Accelerator: a B stage is contiguous in the packed
// planes (64-wide tiles), or KC x PLANES pieces of 1 KB (32-wide tiles);
// each copy is one cp.async.bulk by lane 0 of a producer warp, the warps
// taking turns by stage. A stays a cp.async gather (the strided im2col is
// one).
//
// What bounds it on an H100: a K step is about 700 clocks for one block
// alone (the consumer's wait, ldmatrix and byte split, and the wgmma's
// latency, about as long as the producers' gather), so two or three blocks
// on an SM keep the int16 schemes' tensor cores a third to a half busy
// (PERF.md); an S8 step, with half Q16's tensor-core work at 64 columns
// and the same gather, takes about as long.
#pragma once

#include "igemm_tc.cuh"

namespace yq {
namespace convk {

using tc::A_LD;
using tc::KMAX;
using tc::PLANE;

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(tc::smem_addr(bar)),
                 "r"(count));
}
// Makes the barriers' initialisation visible to the async proxy (the bulk
// copies that complete on them).
__device__ __forceinline__ void mbar_fence_init() {
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
// This thread's arrival, expecting `bytes` more of transactions this phase.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                     tc::smem_addr(bar)),
                 "r"(bytes)
                 : "memory");
}
// Wait until the barrier's phase of parity `parity` has completed: a probe
// first, then the blocking wait.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.test_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(tc::smem_addr(bar)), "r"(parity)
        : "memory");
    while (!done) {
        asm volatile(
            "{\n.reg .pred p;\n"
            "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
            "selp.u32 %0, 1, 0, p;\n}\n"
            : "=r"(done)
            : "r"(tc::smem_addr(bar)), "r"(parity)
            : "memory");
    }
}
// `bytes` (a multiple of 16, both addresses 16-byte aligned) global ->
// shared by the TMA, completing on `bar`.
__device__ __forceinline__ void bulk_g2s(void* dst, const void* src, uint32_t bytes,
                                         uint64_t* bar) {
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
        "[%3];\n" ::"r"(tc::smem_addr(dst)),
        "l"(src), "r"(bytes), "r"(tc::smem_addr(bar))
        : "memory");
}

// d (64 x 32 s32, 16 per thread) += A (64 x 32 8-bit, registers) x
// B (32 x 32 8-bit, descriptor), on the warpgroup.
#define YQ_WGMMA_N32(NAME, AT, BT)                                                         \
    __device__ __forceinline__ void NAME(int32_t d[16], const uint32_t a[4], uint64_t b) { \
        asm volatile(                                                                      \
            "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"                                   \
            "wgmma.mma_async.sync.aligned.m64n32k32.s32." AT "." BT " "                    \
            "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "     \
            "{%16, %17, %18, %19}, %20, p;\n}\n"                                           \
            : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),      \
              "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),    \
              "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15])                           \
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));                 \
    }
YQ_WGMMA_N32(wgmma32_ss, "s8", "s8")
YQ_WGMMA_N32(wgmma32_su, "s8", "u8")
YQ_WGMMA_N32(wgmma32_us, "u8", "s8")
YQ_WGMMA_N32(wgmma32_uu, "u8", "u8")
#undef YQ_WGMMA_N32

// The wgmma of an n-BN tile, by operand signedness (A, B).
template <int BN>
struct Mma;
template <>
struct Mma<64> {
    static __device__ __forceinline__ void ss(int32_t* d, const uint32_t* a, uint64_t b) {
        tc::wgmma_ss(d, a, b);
    }
    static __device__ __forceinline__ void su(int32_t* d, const uint32_t* a, uint64_t b) {
        tc::wgmma_su(d, a, b);
    }
    static __device__ __forceinline__ void us(int32_t* d, const uint32_t* a, uint64_t b) {
        tc::wgmma_us(d, a, b);
    }
    static __device__ __forceinline__ void uu(int32_t* d, const uint32_t* a, uint64_t b) {
        tc::wgmma_uu(d, a, b);
    }
};
template <>
struct Mma<32> {
    static __device__ __forceinline__ void ss(int32_t* d, const uint32_t* a, uint64_t b) {
        wgmma32_ss(d, a, b);
    }
    static __device__ __forceinline__ void su(int32_t* d, const uint32_t* a, uint64_t b) {
        wgmma32_su(d, a, b);
    }
    static __device__ __forceinline__ void us(int32_t* d, const uint32_t* a, uint64_t b) {
        wgmma32_us(d, a, b);
    }
    static __device__ __forceinline__ void uu(int32_t* d, const uint32_t* a, uint64_t b) {
        wgmma32_uu(d, a, b);
    }
};

// The tile of scheme S (int16 A: Q16 or W8A16; int8 A: S8) with BN output
// columns and NC consumer warpgroups of 64 rows each (BM = 64 NC), and the
// block's one producer warpgroup. The blocks per SM and the registers a
// producer and a consumer thread keep after setmaxnreg fill the SM's 65,536
// registers; the ring's stages fill its shared memory.
template <class S, int BN_, int NC>
struct KTile {
    static constexpr int AB = sizeof(typename S::A);   // bytes of an A value
    static_assert((AB == 2 && S::SETS >= 2) || (AB == 1 && S::SETS == 1),
                  "int16 activations in two or three s32 sets, int8 in one");
    static_assert(BN_ == 32 || BN_ == 64, "a 32- or 64-wide tile");
    static_assert(NC == 1 || NC == 2, "one or two consumer warpgroups");
    static constexpr int BN = BN_, BM = 64 * NC, CONSUMERS = 128 * NC, THREADS = 128 + CONSUMERS;
    static constexpr int BK = tc::A_ROW / AB, KC = BK / 32;   // k per K step, 32-k chunks per step
    static constexpr int KCHUNK = KMAX / BK;           // K steps per s32 partial sum
    static constexpr int NACC = BN / 2;                // s32 per consumer thread and set
    static constexpr int PIECE = 32 * BN;              // bytes of one plane of a (32 k, BN n) chunk
    static constexpr int B_STAGE = KC * S::PLANES * PIECE;
    // bulk copies per B stage: the whole stage where BN = 64, else one per
    // plane of each 32-k chunk (the planes are packed 64 columns wide)
    static constexpr int COPIES = BN == 64 ? 1 : KC * S::PLANES;
    static_assert(COPIES <= 4, "the producer's four warps take one copy each");
    static constexpr int A_STAGE = BM * A_LD;
    // three blocks on an SM where a consumer's accumulators take at most 64
    // registers (S8, W8A16, Q16 at 32 columns), else two, or one of two
    // consumer warpgroups; a ring of 6 stages, or of 4 at three blocks (S8:
    // as many as the SM's 228 KB of shared memory holds, less the 1 KB the
    // card keeps per block and the block's static variable: 4, or 5 at 32
    // columns). Four S8 blocks (64 registers a thread) were slower on an
    // H100. The int16 schemes keep 4: at the depth S8's rule gives them
    // (W8A16 5, or 6 at 32 columns; Q16 at 32 columns 5) yolov2-s2's five
    // strided convs at batch 8 took W8A16 0.2191-0.2211 ms against
    // 0.2170-0.2177 at 4, Q16 0.2516-0.2517 against 0.2527-0.2529, on an
    // H100 80GB at 700 W (PERF.md, Findings).
    static constexpr int MIN_BLOCKS = NC == 2 ? 1 : S::SETS * NACC <= 64 ? 3 : 2;
    static constexpr int STAGES =
        MIN_BLOCKS != 3 ? 6
        : AB == 1 ? (233472 / MIN_BLOCKS - 2048) / (A_STAGE + B_STAGE + 16) : 4;
    static constexpr int SMEM = STAGES * (A_STAGE + B_STAGE) + 2 * STAGES * 8;   // + mbarriers
    static constexpr int PRODUCER_REGS = MIN_BLOCKS == 3 ? 48 : NC == 1 ? 56 : 72;
    static constexpr int CONSUMER_REGS = MIN_BLOCKS == 3 ? 112 : NC == 1 ? 200 : 216;
    // setmaxnreg moves registers within the block's own allocation, the
    // launch bound's registers a thread (a multiple of 8) times its threads
    static_assert(128 * PRODUCER_REGS + CONSUMERS * CONSUMER_REGS <=
                      THREADS * (65536 / (THREADS * MIN_BLOCKS) / 8 * 8),
                  "the warpgroups' registers fit the block's");
    static_assert(STAGES >= 3 && MIN_BLOCKS * (SMEM + 2048) <= 233472,
                  "the ring fits the SM's shared memory");
    static_assert((STAGES * (A_STAGE + B_STAGE)) % 16 == 0, "barriers 8-byte aligned");
};

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(tc::smem_addr(bar))
                 : "memory");
}
// An arrival on `bar` once every cp.async this thread issued so far has
// landed (counted in the barrier's expected arrivals).
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
    asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                     tc::smem_addr(bar))
                 : "memory");
}
template <int R>
__device__ __forceinline__ void setmaxnreg_dec() {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}
template <int R>
__device__ __forceinline__ void setmaxnreg_inc() {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}
// A barrier of the consumer warpgroups alone (named barrier 1).
template <int COUNT>
__device__ __forceinline__ void consumer_sync() {
    asm volatile("bar.sync 1, %0;\n" ::"n"(COUNT) : "memory");
}

// The geometry of a general conv: x (B, H, W, C) row-major, a k x k window
// with stride `stride` and `pad` pixels of zero padding on each side
// (darknet's pad = k / 2, or an explicit padding=), the (B, Ho, Wo) output;
// vec: each 16 bytes of a pixel's channels are one aligned copy (C a
// multiple of 16 / sizeof(T) and x 16-byte aligned).
template <class T>
struct Params {
    const T* x;
    int H, W, C;
    int k, stride, pad;
    int Ho, Wo;
    int vec;
};

// The A operand of a tile's ROWS = 16 R rows: the implicit im2col of the
// conv, row m the output pixel (b, oy, ox) in that order, column
// kk = (dy k + dx) C + c tap-major (the HWIO weight order, so K = k^2 C and
// the weights pack as a (K, N) matrix); row m at column kk reads the input
// pixel (oy s + dy - p, ox s + dx - p), channel c, a zero outside the image
// and past K. Producer thread t copies bytes 16 c8 .. 16 c8 + 15 (V values
// of T) of rows r0 + 16 j (j < R) each K step, with c8 = t % 8 and
// r0 = t / 8. Made for the producer's loop: the geometry is read from the
// kernel's parameters, each row keeps its window's corner and its offset
// into x; with vec the chunk's V values share one tap and make one 16-byte
// copy, and the chunk's (dy, dx, c) advance by one K step without a
// division, otherwise each value is gathered on its own.
template <class T, int R>
struct ConvRows {
    static constexpr int V = 16 / (int)sizeof(T), BK = tc::A_ROW / (int)sizeof(T);
    using P = Params<T>;
    long long base[R];   // row j's pixel under tap (0, 0), times C, into x
    int iy0[R], ix0[R];  // that pixel; iy0 far negative past M
    int k, c, dy, dx;    // this thread's chunk: its first k, and k's (dy, dx, c)

    // rows m0 + r0 + 16 j of M, the chunk at K step kt
    __device__ __forceinline__ void seek(const P& p, long long m0, long long M, int t, int kt) {
        const int howo = p.Ho * p.Wo;
#pragma unroll
        for (int j = 0; j < R; ++j) {
            const long long mm = m0 + (t >> 3) + 16 * j;
            const int m = mm < M ? (int)mm : 0;
            const int b = m / howo, r = m - b * howo;
            const int oy = r / p.Wo, ox = r - oy * p.Wo;
            iy0[j] = mm < M ? oy * p.stride - p.pad : -(1 << 30);
            ix0[j] = ox * p.stride - p.pad;
            base[j] = (((long long)b * p.H + iy0[j]) * p.W + ix0[j]) * p.C;
        }
        k = V * (t & 7) + kt * BK;
        const int tap = k / p.C;
        c = k - tap * p.C;
        dy = tap / p.k;
        dx = tap - dy * p.k;
    }

    // fill the chunk's 16 bytes of the R rows of stage sA for the current K
    // step, arrive on `full` once they land, and move to the next K step
    __device__ __forceinline__ void load(const P& p, uint8_t* sA, int t, uint64_t* full) {
        constexpr int ROW = A_LD / (int)sizeof(T);   // values between rows
        const int K = p.k * p.k * p.C;
        T* dst = reinterpret_cast<T*>(sA + (t >> 3) * A_LD) + V * (t & 7);
        if (p.vec) {
            const int off = (dy * p.W + dx) * p.C + c;
            const T* src[R];
            bool ok[R];
#pragma unroll
            for (int j = 0; j < R; ++j) {
                const int iy = iy0[j] + dy, ix = ix0[j] + dx;
                ok[j] = k < K && (unsigned)iy < (unsigned)p.H && (unsigned)ix < (unsigned)p.W;
                src[j] = ok[j] ? p.x + base[j] + off : p.x;
            }
#pragma unroll
            for (int j = 0; j < R; ++j) tc::cp_async16(dst + 16 * j * ROW, src[j], ok[j]);
            cp_async_arrive(full);
            c += BK;
            while (c >= p.C) {
                c -= p.C;
                if (++dx == p.k) dx = 0, ++dy;
            }
        } else {
            // value by value, a 32-bit word at a time, walking (ty, tx, cc)
            // from k: few registers, which the producer's setmaxnreg keeps
            using U = std::make_unsigned_t<T>;
            constexpr int PER = 4 / (int)sizeof(T);   // values a word
            const int tap = k / p.C, c0 = k - tap * p.C;
            const int ty0 = tap / p.k, tx0 = tap - ty0 * p.k;
#pragma unroll
            for (int j = 0; j < R; ++j) {
                uint32_t* row = reinterpret_cast<uint32_t*>(dst + 16 * j * ROW);
                int cc = c0, tx = tx0, ty = ty0;
#pragma unroll 1
                for (int w = 0; w < 4; ++w) {
                    uint32_t word = 0;
#pragma unroll
                    for (int i = 0; i < PER; ++i) {
                        const int iy = iy0[j] + ty, ix = ix0[j] + tx;
                        if (k + PER * w + i < K && (unsigned)iy < (unsigned)p.H &&
                            (unsigned)ix < (unsigned)p.W)
                            word |= (uint32_t)(U)p.x[base[j] + (ty * p.W + tx) * p.C + cc]
                                    << (8 * (int)sizeof(T) * i);
                        if (++cc == p.C) {
                            cc = 0;
                            if (++tx == p.k) tx = 0, ++ty;
                        }
                    }
                    row[w] = word;
                }
            }
            mbar_arrive(full);
        }
        k += BK;
    }
};

// Requantize the sums of out[m, n] and out[m, n + 1] (columns past N
// dropped) and store them, as one store of both where N is even.
template <class Epi>
__device__ __forceinline__ void store2(const Epi& e, long long m, int n, int N, uint32_t a0,
                                       uint32_t a1, const typename Epi::Col& c0,
                                       const typename Epi::Col& c1) {
    using Out = typename Epi::Out;
    using U = std::make_unsigned_t<Out>;
    // the pair as one unsigned word of twice the output's width
    using Pair = std::conditional_t<sizeof(Out) == 2, uint32_t, uint16_t>;
    Out* dst = e.out + m * N + n;
    const Out v0 = e.requant(a0, c0);
    if (n + 1 < N) {
        const Out v1 = e.requant(a1, c1);
        if ((N & 1) == 0) {
            *reinterpret_cast<Pair*>(dst) = (Pair)((Pair)(U)v0 | ((Pair)(U)v1 << (8 * sizeof(Out))));
            return;
        }
        dst[1] = v1;
    }
    dst[0] = v0;
}

// wp: the packed planes (igemm_tc.cuh's layout: per 64 columns and 32 k one
// block of PLANES planes of PLANE bytes, K padded to whole K steps).
// ws (slots > 0, the counters of shared tiles): as launch_tile lays it out.
// Warpgroup 0 produces: it gathers each stage's A rows by cp.async and one
// of its threads copies the B stage by TMA, both completing on the stage's
// `full` barrier. The consumer warpgroups (rows 64 (wg - 1) ..) wait on it,
// run the stage's wgmma and arrive on its `empty` barrier, which lets the
// producer refill it; they also run the epilogues.
template <class S, int BN, int NC>
__global__ void __launch_bounds__(KTile<S, BN, NC>::THREADS, KTile<S, BN, NC>::MIN_BLOCKS)
convk_tc_kernel(const Params<typename S::A> p, const uint8_t* __restrict__ wp,
                const typename S::Epi e, uint32_t* __restrict__ ws, long long M, int N, int K,
                int quantum, int slots) {
    using T = KTile<S, BN, NC>;
    using Col = typename S::Epi::Col;
    using MMA = Mma<BN>;
    constexpr int STAGES = T::STAGES, BM = T::BM, KC = T::KC, NACC = T::NACC;
    extern __shared__ __align__(128) uint8_t smem[];
    uint8_t* sA = smem;
    uint8_t* sB = smem + STAGES * T::A_STAGE;
    uint64_t* full = reinterpret_cast<uint64_t*>(sB + STAGES * T::B_STAGE);
    uint64_t* empty = full + STAGES;
    __shared__ int last;

    const int tid = threadIdx.x, wg = tid >> 7, wt = tid & 127, lane = tid & 31,
              warp = wt >> 5;
    const int ktiles = (K + T::BK - 1) / T::BK;
    const int ntiles = (N + BN - 1) / BN;
    const long long units = (M + BM - 1) / BM * ntiles * ktiles;
    const long long grid = gridDim.x, quanta = units / quantum;
    const long long u0 = blockIdx.x * quanta / grid * quantum,
                    u1 = (blockIdx.x + 1) * quanta / grid * quantum;
    const int nunits = (int)(u1 - u0);
    const long long t0 = u0 / ktiles;
    const int kt0 = (int)(u0 - t0 * ktiles);

    if (tid == 0) {
#pragma unroll
        for (int s = 0; s < STAGES; ++s) {
            mbar_init(full + s, 128 + T::COPIES);   // the producers' copies, the B bytes
            mbar_init(empty + s, 4 * NC);   // each consumer warp
        }
        mbar_fence_init();
    }
    __syncthreads();

    if (wg == 0) {
        // the producer: stage j % STAGES holds the j-th unit of the share
        setmaxnreg_dec<T::PRODUCER_REGS>();
        constexpr int STEP_BYTES = KC * S::PLANES * PLANE;   // of the planes per K step
        const long long col_bytes = (long long)ktiles * STEP_BYTES;   // per 64 columns
        // the tile as (m-tile, n-tile), and the B stage's source, kept
        // current without a 64-bit division in the loop
        long long mt = t0 / ntiles;
        int nt = (int)(t0 - mt * ntiles), kt = kt0;
        auto b_src = [&]() {
            return wp + (nt * BN / 64) * col_bytes + (long long)kt * STEP_BYTES +
                   (nt * BN % 64) * 32;
        };
        const uint8_t* src = b_src();
        ConvRows<typename S::A, 4 * NC> ld;
        ld.seek(p, mt * BM, M, wt, kt);
        for (int j = 0; j < nunits; ++j) {
            const int slot = j % STAGES;
            if (j >= STAGES) mbar_wait(empty + slot, (j / STAGES - 1) & 1);
            // B first, so that the copy runs while the A rows are gathered:
            // copy q of stage j by lane 0 of warp (j + q) % 4, each with its
            // own arrival and bytes, so the warps take turns
            const int q = (warp - j) & 3;
            if (lane == 0 && q < T::COPIES) {
                constexpr int BYTES = T::B_STAGE / T::COPIES;
                mbar_expect_tx(full + slot, BYTES);
                bulk_g2s(sB + slot * T::B_STAGE + q * BYTES,
                         src + q * (T::COPIES == 1 ? 0 : PLANE), BYTES, full + slot);
            }
            ld.load(p, sA + slot * T::A_STAGE, wt, full + slot);
            src += STEP_BYTES;
            if (++kt == ktiles) {
                kt = 0;
                if (++nt == ntiles) nt = 0, ++mt;
                src = b_src();
                if (j + 1 < nunits) ld.seek(p, mt * BM, M, wt, 0);
            }
        }
        asm volatile("cp.async.wait_all;\n" ::: "memory");
        return;
    }

    // a consumer: warpgroup cw's rows 64 cw .. 64 cw + 63 of each tile
    setmaxnreg_inc<T::CONSUMER_REGS>();
    const int cw = wg - 1, ct = tid - 128;
    // past KMAX each tile sums its segments in a zeroed slot of its own;
    // else a shared tile's segments leave their partials in their blocks'
    // regions (two a block); the counters follow
    const bool chunked = ktiles > T::KCHUNK;
    const long long counters_at = (chunked ? (long long)slots : 2 * grid) * (BM * BN);
    // ldmatrix x4: lanes 8q .. 8q+7 address matrix q's rows (as igemm_tc.cuh)
    const int lrow = (lane & 7) + ((lane >> 3) & 1) * 8, lcol = (lane >> 4) * 16;
    const int g8 = lane >> 2, t4 = lane & 3;
    long long u = u0, tile = t0, mt = t0 / ntiles;
    int nt = (int)(t0 - mt * ntiles), kt = kt0, j = 0;
    int32_t acc[S::SETS][NACC];

    while (u < u1) {
        // this segment: K steps kt .. kend - 1 of `tile`
        const int kend =
            (int)min((long long)min(ktiles, (kt / T::KCHUNK + 1) * T::KCHUNK), kt + (u1 - u));
#pragma unroll
        for (int s = 0; s < S::SETS; ++s)
#pragma unroll
            for (int i = 0; i < NACC; ++i) acc[s][i] = 0;

        for (int step = kt; step < kend; ++step, ++j) {
            const int slot = j % STAGES;
            mbar_wait(full + slot, (j / STAGES) & 1);
            const uint8_t* a =
                sA + slot * T::A_STAGE + (64 * cw + 16 * warp + lrow) * A_LD + lcol;
            const uint8_t* b = sB + slot * T::B_STAGE;
            auto bplane = [&](int kc, int plane) {
                return tc::b_desc(b + (kc * S::PLANES + plane) * T::PIECE);
            };
            // rows g and g+8 of each 32-k chunk: for int16 A the high bytes
            // in fa[0] and the low bytes in fa[1]
            uint32_t fa[T::AB][KC][4];
#pragma unroll
            for (int kc = 0; kc < KC; ++kc) {
                if constexpr (T::AB == 2) {
                    uint32_t r[4], q[4];
                    tc::ldmatrix_x4(r, a + kc * 64);
                    tc::ldmatrix_x4(q, a + kc * 64 + 32);
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
                    tc::ldmatrix_x4(fa[0][kc], a + kc * 32);
                }
            }
            tc::wgmma_fence();
#pragma unroll
            for (int kc = 0; kc < KC; ++kc) {
                if constexpr (S::SETS == 3) {   // Q16: hh, mid, ll
                    const uint64_t bh = bplane(kc, 0), bl = bplane(kc, 1);
                    MMA::ss(acc[0], fa[0][kc], bh);
                    MMA::su(acc[1], fa[0][kc], bl);
                    MMA::us(acc[1], fa[1][kc], bh);
                    MMA::uu(acc[2], fa[1][kc], bl);
                } else if constexpr (S::SETS == 2) {   // W8A16: xh*w, xl*w
                    const uint64_t bw = bplane(kc, 0);
                    MMA::ss(acc[0], fa[0][kc], bw);
                    MMA::us(acc[1], fa[1][kc], bw);
                } else {   // S8
                    MMA::ss(acc[0], fa[0][kc], bplane(kc, 0));
                }
            }
            tc::wgmma_commit();
            tc::wgmma_wait_all();
#pragma unroll
            for (int p2 = 0; p2 < T::AB; ++p2)
#pragma unroll
                for (int kc = 0; kc < KC; ++kc)
#pragma unroll
                    for (int i = 0; i < 4; ++i) tc::fence_operand(fa[p2][kc][i]);
#pragma unroll
            for (int s = 0; s < S::SETS; ++s)
#pragma unroll
                for (int i = 0; i < NACC; ++i) tc::fence_operand(acc[s][i]);
            // this warp is done with the stage
            __syncwarp();
            if (lane == 0) mbar_arrive(empty + slot);
        }

        // the epilogue: accumulator 4j + 2h + c of a set is row
        // 16 warp + g8 + 8h, column 8j + 2 t4 + c of the warpgroup's rows
        const long long m0 = mt * BM;
        const int n0 = nt * BN;
        const int r0 = 64 * cw + 16 * warp + g8;
        uint32_t sum[NACC];
#pragma unroll
        for (int i = 0; i < NACC; ++i) sum[i] = tc::combine<S>(acc, i);
        // a partial tile in the workspace is laid out as the consumer
        // threads hold it: uint4 q of thread ct at word 4 (q CONSUMERS + ct)
        bool store = true;
        if (kt != 0 || kend != ktiles || chunked) {
            // a shared tile: leave this segment's partial where the segment
            // that completes the tile finds it, and count its steps
            const long long first_unit = tile * ktiles;
            const long long slot = chunked ? tile : ((first_unit + 1) * grid - 1) / units;
            if (chunked) {   // K past KMAX: add into the tile's zeroed slot
                uint32_t* part = ws + slot * (BM * BN);
#pragma unroll
                for (int i = 0; i < NACC; ++i)
                    atomicAdd(part + 4 * ((i / 4) * T::CONSUMERS + ct) + i % 4, sum[i]);
            } else {   // the block's own region: 2b for its first segment, 2b + 1 for its last
                uint4* part = reinterpret_cast<uint4*>(
                    ws + (2 * (long long)blockIdx.x + (u == u0 ? 0 : 1)) * (BM * BN));
#pragma unroll
                for (int q = 0; q < NACC / 4; ++q)
                    __stcg(part + q * T::CONSUMERS + ct,
                           make_uint4(sum[4 * q], sum[4 * q + 1], sum[4 * q + 2], sum[4 * q + 3]));
            }
            // the barrier orders every consumer thread's partial before
            // thread 0's fence and count; thread 0's fence after a count
            // that completes the tile orders the others' partials before
            // the barrier and the reads after it
            consumer_sync<T::CONSUMERS>();
            if (ct == 0) {
                __threadfence();
                int* count = reinterpret_cast<int*>(ws + counters_at) + slot;
                last = atomicAdd(count, kend - kt) + (kend - kt) == ktiles;
                if (last) __threadfence();
            }
            consumer_sync<T::CONSUMERS>();
            store = last;
            if (last) {
                // every other segment of the tile has left its partial
                if (chunked) {
                    const uint32_t* part = ws + slot * (BM * BN);
#pragma unroll
                    for (int i = 0; i < NACC; ++i)
                        sum[i] = __ldcg(part + 4 * ((i / 4) * T::CONSUMERS + ct) + i % 4);
                } else {
                    // the tile's blocks b0 .. b1: b0 left its last segment
                    // (its first, where its share starts with the tile), the
                    // others their first
                    const long long b0 = slot, b1 = ((first_unit + ktiles) * grid - 1) / units;
                    for (long long b = b0; b <= b1; ++b) {
                        if (b == blockIdx.x) continue;
                        const bool tail = b == b0 && b0 * units / grid != first_unit;
                        const uint4* part = reinterpret_cast<const uint4*>(
                            ws + (2 * b + (tail ? 1 : 0)) * (BM * BN));
#pragma unroll
                        for (int q = 0; q < NACC / 4; ++q) {
                            const uint4 v = __ldcg(part + q * T::CONSUMERS + ct);
                            sum[4 * q] += v.x, sum[4 * q + 1] += v.y;
                            sum[4 * q + 2] += v.z, sum[4 * q + 3] += v.w;
                        }
                    }
                }
            }
        }
        if (store) {
#pragma unroll
            for (int jj = 0; jj < BN / 8; ++jj) {
                const int n = n0 + 8 * jj + 2 * t4;
                if (n >= N) continue;
                const Col c0 = e.column(n), c1 = n + 1 < N ? e.column(n + 1) : Col{};
#pragma unroll
                for (int h = 0; h < 2; ++h) {
                    const long long m = m0 + r0 + 8 * h;
                    if (m < M)
                        store2(e, m, n, N, sum[4 * jj + 2 * h], sum[4 * jj + 2 * h + 1], c0, c1);
                }
            }
        }
        u += kend - kt;
        kt = kend;
        if (kt == ktiles) {
            kt = 0;
            ++tile;
            if (++nt == ntiles) nt = 0, ++mt;
        }
    }
}

// Launch the BM x BN tile of scheme S on `stream` with `grid` persistent
// blocks (ops/tc.py: stream_k). With slots > 0 (counters of shared tiles)
// ws holds, past KMAX (K > KMAX), slots partial tiles of BM x BN uint32 and
// then the slots counters, all zeroed here first; otherwise 2 * grid
// regions of BM x BN uint32 (not read before they are written) and the
// slots counters, which are zeroed here. With slots == 0 ws may be null.
// Returns cudaGetLastError() after the launch.
template <class S, int BN, int NC>
inline cudaError_t launch_tile(const Params<typename S::A>& p, const void* wp,
                               const typename S::Epi& e, void* ws, long long M, int N, int K,
                               int grid, int quantum, int slots, void* stream) {
    using T = KTile<S, BN, NC>;
    static const cudaError_t attr = cudaFuncSetAttribute(
        convk_tc_kernel<S, BN, NC>, cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
    if (attr != cudaSuccess) return attr;
    if (M <= 0 || N <= 0) return cudaGetLastError();
    if (grid < 1 || quantum < 1 || slots < 0 || (slots > 0 && ws == nullptr))
        return cudaErrorInvalidValue;
    if (slots > 0) {
        const bool chunked = (K + T::BK - 1) / T::BK > T::KCHUNK;
        const size_t tile = (size_t)T::BM * T::BN;
        const size_t skip = chunked ? 0 : 2 * (size_t)grid * tile;
        const size_t words = chunked ? slots * (tile + 1) : (size_t)slots;
        const cudaError_t err = cudaMemsetAsync((uint32_t*)ws + skip, 0,
                                                words * sizeof(uint32_t), (cudaStream_t)stream);
        if (err != cudaSuccess) return err;
    }
    convk_tc_kernel<S, BN, NC><<<grid, T::THREADS, T::SMEM, (cudaStream_t)stream>>>(
        p, (const uint8_t*)wp, e, (uint32_t*)ws, M, N, K, quantum, slots);
    return cudaGetLastError();
}

template <class S>
inline cudaError_t launch(int bm, int bn, const Params<typename S::A>& p,
                          const void* wp, const typename S::Epi& e, void* ws, long long M,
                          int N, int K, int grid, int quantum, int slots, void* stream) {
#define YQ_CONVK_TILE(BM_, BN_)                                                              \
    if (bm == BM_ && bn == BN_)                                                              \
        return launch_tile<S, BN_, BM_ / 64>(p, wp, e, ws, M, N, K, grid, quantum, slots, stream);
    YQ_CONVK_TILE(64, 64)
    YQ_CONVK_TILE(64, 32)
    YQ_CONVK_TILE(128, 64)
    YQ_CONVK_TILE(128, 32)
#undef YQ_CONVK_TILE
    return cudaErrorInvalidValue;
}

// The BM x BN tile of scheme S as the wrappers must know it: what = 0 BM,
// 1 BN, 2 BK, 3 dynamic shared memory bytes per block, 4 blocks per SM
// asked of the compiler, 5 blocks per SM the card keeps (the occupancy
// calculator), 6 ring stages, 7 KMAX; -1 for anything else.
template <class S, int BN, int NC>
inline int tile_config(int what) {
    using T = KTile<S, BN, NC>;
    int resident = -1;
    if (what == 5) {
        if (cudaFuncSetAttribute(convk_tc_kernel<S, BN, NC>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 T::SMEM) != cudaSuccess ||
            cudaOccupancyMaxActiveBlocksPerMultiprocessor(&resident, convk_tc_kernel<S, BN, NC>,
                                                          T::THREADS, T::SMEM) != cudaSuccess)
            return -1;
    }
    const int v[] = {T::BM, T::BN, T::BK, T::SMEM, T::MIN_BLOCKS, resident, T::STAGES, KMAX};
    return what >= 0 && what < 8 ? v[what] : -1;
}

template <class S>
inline int config(int bm, int bn, int what) {
    if (bm == 64 && bn == 64) return tile_config<S, 64, 1>(what);
    if (bm == 64 && bn == 32) return tile_config<S, 32, 1>(what);
    if (bm == 128 && bn == 64) return tile_config<S, 64, 2>(what);
    if (bm == 128 && bn == 32) return tile_config<S, 32, 2>(what);
    return -1;
}

}  // namespace convk
}  // namespace yq
