// nms_greedy: the per-class greedy scan of the on-device class-wise NMS.
//
// Replaces the vmapped lax.scan of yolotpu/ops/nms.py:89-98 (one_class,
// whose scan is greedy_nms_mask, :36-57): for every frame b and class c of
// the top-K candidate table,
//
//   out[b, k, c] = cprob[b, k, c]  where box k survives in class c, else 0,
//
// a box surviving when its score is above 0 and no surviving box ranked
// before it overlaps it with ious[b, j, k] > thresh (the orientation of
// sup[:, i] at nms.py:51), the ranks being jnp.argsort(-scores): scores
// descending, equal scores in index order (a stable sort).
//
// Design. One block per (class, frame), one thread per candidate (K <= 1024).
// The block reads its class's K scores into shared memory; each thread
// counts the scores ranked before its own and so places its box in the
// order, with no sort. Then one pass over the ranks: at step i every thread
// t < i that holds a kept box reads ious[order[t], order[i]], the block ORs
// the suppressions (__syncthreads_or, one barrier a step), and thread i
// keeps or drops its box. A thread keeps only its own box's flag, in a
// register, so the pass writes nothing shared. The next step's IoU is
// loaded before this step's barrier.
//
// What bounds it on an H100: not bytes (each input read once and the output
// written once are 3.4 MB at yolov2-416, b=8, K=256, C=80: 1 us at
// 3.35 TB/s) nor operations, but the
// chain of K dependent steps, each an L2 load and a block barrier; the
// B*C blocks of a forward (640 at b=8) run at once on 132 SMs. A later
// design could share one suppression bitmask per box pair across the
// classes (the IoU test does not depend on the class) and walk the chain
// with warp ballots over 32 boxes a step.
#include <cuda_runtime.h>

namespace {

__global__ void nms_greedy_kernel(const float* __restrict__ cprob,
                                  const float* __restrict__ ious,
                                  float* __restrict__ out, int K, int C,
                                  float thresh) {
    extern __shared__ unsigned char smem[];
    float* score = reinterpret_cast<float*>(smem);        // [K], by index
    int* order = reinterpret_cast<int*>(score + K);       // [K], by rank
    const int c = blockIdx.x, b = blockIdx.y, t = threadIdx.x;
    const bool live = t < K;
    const float* cp = cprob + (long long)b * K * C + c;
    if (live) score[t] = cp[(long long)t * C];
    __syncthreads();
    if (live) {
        const float s = score[t];
        int rank = 0;
        for (int j = 0; j < K; ++j) {
            const float sj = score[j];
            rank += (sj > s) || (sj == s && j < t);
        }
        order[rank] = t;
    }
    __syncthreads();
    // thread t now stands for the box of rank t
    const int box = live ? order[t] : 0;
    const float* row = ious + ((long long)b * K + box) * K;
    const bool alive = live && score[box] > 0.0f;
    bool keep = false;
    float next = live ? row[order[0]] : 0.0f;
    for (int i = 0; i < K; ++i) {
        const float iou = next;
        if (live && i + 1 < K) next = row[order[i + 1]];
        const int killed = __syncthreads_or(t < i && keep && iou > thresh);
        if (t == i) keep = alive && !killed;
    }
    if (live) out[((long long)b * K + box) * C + c] = keep ? score[box] : 0.0f;
}

}  // namespace

// cprob (B, K, C) f32, ious (B, K, K) f32 -> out (B, K, C) f32, contiguous
// on the current device, 1 <= K <= 1024. Returns cudaGetLastError() after
// the launch.
extern "C" int yq_nms_greedy(const void* cprob, const void* ious, void* out, int B, int K,
                             int C, float thresh, void* stream) {
    if (B <= 0 || C <= 0) return cudaGetLastError();
    const dim3 grid(C, B);
    const int threads = (K + 31) / 32 * 32;
    const size_t smem = (size_t)K * (sizeof(float) + sizeof(int));
    nms_greedy_kernel<<<grid, threads, smem, (cudaStream_t)stream>>>(
        (const float*)cprob, (const float*)ious, (float*)out, K, C, thresh);
    return cudaGetLastError();
}
