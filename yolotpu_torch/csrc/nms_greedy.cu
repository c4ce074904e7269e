// nms_greedy: the class-wise greedy NMS of the on-device postprocess.
//
// Replaces the vmapped lax.scan of yolotpu/ops/nms.py:89-98 (one_class,
// whose scan is greedy_nms_mask, :36-57) and the IoU matrix it reads
// (box_iou_matrix, :21-33, called at :87): for
// every frame b and class c of the top-K candidate table,
//
//   out[b, k, c] = cprob[b, k, c]  where box k survives in class c, else 0,
//
// a box surviving when its score is above 0 and no surviving box ranked
// before it overlaps it, iou(box j, box k) > thresh (the orientation of
// sup[:, i] at nms.py:51), the ranks being jnp.argsort(-scores): scores
// descending, equal scores in index order (a stable sort).
//
// Design. The test iou > thresh does not depend on the class, so it runs
// once per frame, as bits: a first pass (nms_table_kernel, one warp per
// box j) builds the frame's K x W table, W = ceil(K / 32), bit l of word w
// of row j set where iou(j, 32w + l) > thresh, each word one __ballot_sync,
// into global memory, where it stays in L2 (rows padded to a multiple of 4
// words: 8 KB at K = 256, 92 KB at K = 845, 128 KB at K = 1024). The walk
// (nms_greedy_kernel) gives a block `warps` classes of one frame and each
// class one warp. The block copies the frame's table and its classes'
// scores into dynamic shared memory with cp.async, every copy in flight at
// once. A warp compacts its class's live boxes (score > 0: __ballot_sync
// and __popc), ranks only them, by counting, and walks them in rank order
// holding a "removed" mask of W <= 32 words, word w in lane w: at each step
// the lane that owns the box's word hands it to all (__shfl_sync), and if
// the box's bit is clear the box is kept and every lane ORs its word of the
// box's row into its mask; the next box and its row are read ahead. The
// walk has no block barrier and takes as many steps as the class has live
// boxes, not K. The block then writes its classes' outputs together.
// Building the table in every block of the walk instead, and the number of
// classes a block, were measured (chip_smoke.py phase 2, PERF.md).
//
// The IoU is box_iou_matrix's float32 arithmetic operation for operation
// (ops/nms.py), each operation rounded on its own (__fmul_rn, __fadd_rn,
// __fsub_rn, __fdiv_rn: nvcc's default -fmad=true would otherwise contract
// a*b + c into one FMA and move the last bit near the threshold), so the
// table is bit for bit the plain version's ious > thresh.
//
// What bounds it on an H100: not bytes (cboxes and cprob read once and
// the output written once: 1.3 MB at yolov2-416, b=8, K=256, C=80, 0.4 us
// at 3.35 TB/s) nor operations (K(K-1)/2 IoU tests a frame and the live
// boxes' rank comparisons, a few million fp32 operations), but latency:
// the two launches, the copies into shared memory, and each class's chain
// of dependent steps, a shared-memory load and a shuffle each (where a
// block per class and frame paid an L2 load and a block barrier for each
// of K steps).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int TABLE_WARPS = 8;   // rows of the table per block of the first pass

// words of a table row in memory: W = ceil(K/32) rounded up to 4, so that
// every row is 16-byte aligned
__host__ __device__ __forceinline__ int row_stride(int K) { return ((K + 31) / 32 + 3) & ~3; }

struct Corners {
    float x0, y0, x1, y1, area;
};

// box_iou_matrix's corners and area of a center-format box
__device__ __forceinline__ Corners corners(float4 b) {
    const float hw = __fmul_rn(b.z, 0.5f), hh = __fmul_rn(b.w, 0.5f);
    return {__fsub_rn(b.x, hw), __fsub_rn(b.y, hh), __fadd_rn(b.x, hw), __fadd_rn(b.y, hh),
            __fmul_rn(b.z, b.w)};
}

// box_iou_matrix(a, b) > thresh, in its order of operations
__device__ __forceinline__ bool overlaps(const Corners& a, const Corners& b, float thresh) {
    const float iw = fmaxf(__fsub_rn(fminf(a.x1, b.x1), fmaxf(a.x0, b.x0)), 0.0f);
    const float ih = fmaxf(__fsub_rn(fminf(a.y1, b.y1), fmaxf(a.y0, b.y0)), 0.0f);
    const float inter = __fmul_rn(iw, ih);
    const float uni = __fsub_rn(__fadd_rn(a.area, b.area), inter);
    return __fdiv_rn(inter, fmaxf(uni, 1e-12f)) > thresh;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
    return (uint32_t)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(dst)), "l"(src));
}

// The first pass: row j of frame b's table, one warp a row; bit l of word w
// set where iou(box j, box 32w + l) > thresh, each word one ballot.
__global__ void nms_table_kernel(const float4* __restrict__ boxes,
                                 uint32_t* __restrict__ table, int K, float thresh) {
    const int W = (K + 31) >> 5, stride = row_stride(K), lane = threadIdx.x & 31;
    const int j = blockIdx.x * TABLE_WARPS + (threadIdx.x >> 5);
    if (j >= K) return;   // the whole warp
    const float4* bx = boxes + (long long)blockIdx.y * K;
    const Corners a = corners(bx[j]);
    uint32_t mine = 0;   // word `lane` of the row
    for (int w = 0; w < W; ++w) {
        const int i = 32 * w + lane;
        const uint32_t word = __ballot_sync(FULL, i < K && overlaps(a, corners(bx[i]), thresh));
        if (lane == w) mine = word;
    }
    if (lane < stride) table[((long long)blockIdx.y * K + j) * stride + lane] = mine;
}

// The walk: a block takes `warps` classes of frame b, a warp one class.
__global__ void nms_greedy_kernel(const float* __restrict__ cprob,
                                  const uint32_t* __restrict__ table, float* __restrict__ out,
                                  int K, int C) {
    extern __shared__ __align__(16) unsigned char smem[];
    const int W = (K + 31) >> 5, stride = row_stride(K), Kp = K | 1;
    const int warps = blockDim.x >> 5, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int b = blockIdx.y, c0 = blockIdx.x * warps, nc = min(warps, C - c0);
    uint32_t* tab = reinterpret_cast<uint32_t*>(smem);   // [K][stride], the frame's table
    float* tile = reinterpret_cast<float*>(tab + K * stride);   // [warps][Kp], scores by box
    float* score = tile + warps * Kp + warp * K;   // [K] per warp: the live boxes' scores
    uint32_t* keptw = reinterpret_cast<uint32_t*>(tile + warps * Kp + warps * K);  // [warps][32]
    uint16_t* index = reinterpret_cast<uint16_t*>(keptw + 32 * warps) + warp * 2 * K;  // [K]
    uint16_t* order = index + K;   // [K] per warp: the live boxes by rank

    // the table and the block's classes' scores, every copy in flight at once
    const uint32_t* src = table + (long long)b * K * stride;
    for (int t = threadIdx.x; t < K * stride / 4; t += blockDim.x)
        cp_async16(tab + 4 * t, src + 4 * t);
    const float* cp = cprob + (long long)b * K * C + c0;
    for (int t = threadIdx.x; t < K * nc; t += blockDim.x) {
        const int k = t / nc, j = t - k * nc;
        cp_async4(tile + j * Kp + k, cp + (long long)k * C + j);
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncthreads();

    if (warp < nc) {
        const float* sc = tile + warp * Kp;
        // the class's live boxes, in index order
        int n = 0;
        for (int k0 = 0; k0 < K; k0 += 32) {
            const int k = k0 + lane;
            const float s = k < K ? sc[k] : 0.0f;
            const uint32_t live = __ballot_sync(FULL, s > 0.0f);
            if (s > 0.0f) {
                const int p = n + __popc(live & ((1u << lane) - 1u));
                score[p] = s;
                index[p] = (uint16_t)k;
            }
            n += __popc(live);
        }
        __syncwarp();
        // their ranks, by counting: scores descending, equal scores in
        // index order (the compacted list is in index order)
        for (int i = lane; i < n; i += 32) {
            const float s = score[i];
            int rank = 0;
#pragma unroll 4
            for (int j = 0; j < n; ++j) {
                const float sj = score[j];
                rank += (sj > s) || (sj == s && j < i);
            }
            order[rank] = index[i];
        }
        __syncwarp();
        // the walk: lane w holds word w of the removed and the kept masks;
        // the next box and its row are read ahead of the step's shuffle
        uint32_t removed = 0, kept = 0;
        int box = n > 0 ? order[0] : 0;
        uint32_t row = n > 0 && lane < W ? tab[box * stride + lane] : 0u;
        for (int r = 0; r < n; ++r) {
            const int next = r + 1 < n ? order[r + 1] : 0;
            const uint32_t next_row = lane < W ? tab[next * stride + lane] : 0u;
            const uint32_t word = __shfl_sync(FULL, removed, box >> 5);
            if (!((word >> (box & 31)) & 1u)) {
                removed |= row;
                if (lane == (box >> 5)) kept |= 1u << (box & 31);
            }
            box = next;
            row = next_row;
        }
        keptw[32 * warp + lane] = kept;
    }
    __syncthreads();
    float* o = out + (long long)b * K * C + c0;
    for (int t = threadIdx.x; t < K * nc; t += blockDim.x) {
        const int k = t / nc, j = t - k * nc;
        const bool keep = (keptw[32 * j + (k >> 5)] >> (k & 31)) & 1u;
        o[(long long)k * C + j] = keep ? tile[j * Kp + k] : 0.0f;
    }
}

}  // namespace

// cprob (B, K, C) f32 and cboxes (B, K, 4) f32 (center format, 16-byte
// aligned) -> out (B, K, C) f32, contiguous on the current device, 1 <= K
// <= 1024; table a scratch of B * K * row_stride(K) uint32, the first
// pass's output; `warps` classes per block of the walk, whose dynamic shared
// memory, 4 K row_stride(K) + warps (4 (K | 1) + 8 K + 128) bytes, must fit
// the card's 227 KB. Returns cudaGetLastError() after the launches.
extern "C" int yq_nms_greedy(const void* cprob, const void* cboxes, void* table, void* out,
                             int B, int K, int C, int warps, float thresh, void* stream) {
    static const cudaError_t attr = cudaFuncSetAttribute(
        nms_greedy_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, 232448);
    if (attr != cudaSuccess) return attr;
    if (B <= 0 || C <= 0) return cudaGetLastError();
    const size_t smem = (size_t)4 * K * row_stride(K) + (size_t)warps * (4 * (K | 1) + 8 * K + 128);
    if (K < 1 || K > 1024 || warps < 1 || warps > 32 || smem > 232448)
        return cudaErrorInvalidValue;
    nms_table_kernel<<<dim3((K + TABLE_WARPS - 1) / TABLE_WARPS, B), 32 * TABLE_WARPS, 0,
                       (cudaStream_t)stream>>>((const float4*)cboxes, (uint32_t*)table, K,
                                               thresh);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    nms_greedy_kernel<<<dim3((C + warps - 1) / warps, B), 32 * warps, smem,
                        (cudaStream_t)stream>>>((const float*)cprob, (const uint32_t*)table,
                                                (float*)out, K, C);
    return cudaGetLastError();
}
