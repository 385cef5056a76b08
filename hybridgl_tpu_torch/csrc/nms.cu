// Greedy box NMS for sm_90a on the CUDA cores, in two kernels.
//
// Replaces hybridgl_tpu/kernels/nms.py:nms (:31), which the reference writes
// as a fixed-shape XLA program (the IoU matrix, then a fori_loop sweep), not
// as a Pallas kernel. Input: boxes [N, 4] f32 XYXY, already sorted by
// descending score, and their validity flags in the same order. Output:
// keep[i] = !suppressed[i] && valid[i] and the kept count, where the sweep
//   for i in 0..N-1: if !suppressed[i]: suppressed |= (iou[i, :] > thr) & (j > i)
// runs over every row, valid or not, exactly as the reference's does.
//
// Exactness. The selections must equal the reference's bit for bit, so each
// IoU rounds as box_iou_matrix (kernels/masks.py) does in PyTorch and in
// jnp, one IEEE f32 operation at a time: area = (x2-x1)*(y2-y1), lt = max,
// rb = min, wh = max(rb-lt, 0), inter = wh0*wh1, union = (area_a + area_b)
// - inter, iou = union > 0 ? inter/union : 0. The _rn intrinsics keep nvcc
// (-fmad=true) from contracting a product and a sum into one FMA; max and
// min propagate NaN as torch.maximum and jnp.maximum do. The threshold
// arrives as f32 and is compared in f32, as a Python float against an f32
// tensor is.
//
// (a) Mask kernel, grid (column block, row block) of 64 x 64 pairs, upper
// triangle only (row block <= column block). A block stages its 64 column
// boxes and their areas in shared memory; each thread owns one row and
// writes one 64-bit word: bit k of mask[i, c] says iou(i, 64c + k) > thr
// and 64c + k > i. Words left of a row's diagonal block are never written
// and never read. N x ceil(N/64) x 8 bytes in all (18.9 MB at N = 12,288,
// where the f32 IoU matrix is 604 MB); ~15 flops an IoU. Bound by bytes.
//
// (b) Sweep kernel, one block of 256 threads; the removed bits (one word a
// column block) live in shared memory. Per 64-row block w, in order: every
// thread resolves the block's own rows from its 64 diagonal words (staged in
// shared memory one step ahead) in registers, 64 dependent bit steps; the
// block writes keep and counts the kept valid rows; then all threads OR the
// kept rows' words right of w into the removed bits (shared atomics),
// coalesced along a row, while 64 of them fetch the next block's diagonal
// words. Two barriers a 64-row block; the rest is latency, N/64 dependent
// steps of one L2 round trip each (the mask was just written and fits in
// L2). Nothing of size N leaves the card: the wrapper reads the 4-byte count.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef unsigned long long u64;

constexpr int kBlock = 64;          // rows (and columns) a word covers
constexpr int kSweepThreads = 256;  // one block

// torch.maximum / torch.minimum / clamp: NaN in either operand gives NaN
__device__ __forceinline__ float max_nan(float a, float b) { return (a != a || a > b) ? a : b; }
__device__ __forceinline__ float min_nan(float a, float b) { return (a != a || a < b) ? a : b; }

__device__ __forceinline__ float box_area(float x1, float y1, float x2, float y2) {
  return __fmul_rn(__fsub_rn(x2, x1), __fsub_rn(y2, y1));
}

__device__ __forceinline__ float box_iou(float ax1, float ay1, float ax2, float ay2, float area_a,
                                         float bx1, float by1, float bx2, float by2, float area_b) {
  const float w = max_nan(__fsub_rn(min_nan(ax2, bx2), max_nan(ax1, bx1)), 0.0f);
  const float h = max_nan(__fsub_rn(min_nan(ay2, by2), max_nan(ay1, by1)), 0.0f);
  const float inter = __fmul_rn(w, h);
  const float uni = __fsub_rn(__fadd_rn(area_a, area_b), inter);
  return uni > 0.0f ? __fdiv_rn(inter, uni) : 0.0f;
}

__global__ void __launch_bounds__(kBlock) nms_mask_kernel(const float* __restrict__ boxes, int N, int W,
                                                          float thr, u64* __restrict__ mask) {
  const int cb = blockIdx.x, rb = blockIdx.y;
  if (cb < rb) return;  // left of the diagonal: never read by the sweep
  __shared__ float cbox[kBlock][4];
  __shared__ float carea[kBlock];
  const int t = threadIdx.x;
  const int j = cb * kBlock + t;
  if (j < N) {
    const float x1 = boxes[4 * j], y1 = boxes[4 * j + 1], x2 = boxes[4 * j + 2], y2 = boxes[4 * j + 3];
    cbox[t][0] = x1;
    cbox[t][1] = y1;
    cbox[t][2] = x2;
    cbox[t][3] = y2;
    carea[t] = box_area(x1, y1, x2, y2);
  }
  __syncthreads();
  const int i = rb * kBlock + t;
  if (i >= N) return;
  const float ax1 = boxes[4 * i], ay1 = boxes[4 * i + 1], ax2 = boxes[4 * i + 2], ay2 = boxes[4 * i + 3];
  const float area_a = box_area(ax1, ay1, ax2, ay2);
  const int cols = min(kBlock, N - cb * kBlock);
  u64 bits = 0;
  for (int k = 0; k < cols; ++k) {
    if (cb * kBlock + k <= i) continue;
    const float iou = box_iou(ax1, ay1, ax2, ay2, area_a, cbox[k][0], cbox[k][1], cbox[k][2], cbox[k][3], carea[k]);
    if (iou > thr) bits |= 1ull << k;
  }
  mask[(size_t)i * W + cb] = bits;
}

__global__ void __launch_bounds__(kSweepThreads) nms_sweep_kernel(const u64* __restrict__ mask,
                                                                  const bool* __restrict__ valid, int N, int W,
                                                                  bool* __restrict__ keep, int* __restrict__ num_kept) {
  extern __shared__ u64 removed[];  // [W]
  __shared__ u64 diag[2][kBlock];   // a block's diagonal words, this one and the next
  __shared__ int kept_rows[kBlock];
  const int t = threadIdx.x;
  for (int k = t; k < W; k += kSweepThreads) removed[k] = 0;
  if (t < kBlock) diag[0][t] = t < N ? mask[(size_t)t * W] : 0;
  __syncthreads();
  int total = 0;
  for (int w = 0; w < W; ++w) {
    const int base = w * kBlock;
    const int rows = min(kBlock, N - base);
    const u64* d = diag[w & 1];
    // the block's own rows, in order (every thread alike; d[r] = 0 past the last row)
    u64 cur = removed[w];
#pragma unroll
    for (int r = 0; r < kBlock; ++r)
      if (!((cur >> r) & 1ull)) cur |= d[r];
    const u64 live = rows == kBlock ? ~0ull : ((1ull << rows) - 1ull);
    const u64 kept = ~cur & live;
    const int nkept = __popcll(kept);
    bool counted = false;
    if (t < rows) {
      const bool k_t = (kept >> t) & 1ull;
      counted = k_t && valid[base + t];
      keep[base + t] = counted;
      if (k_t) kept_rows[__popcll(kept & ((1ull << t) - 1ull))] = t;
    }
    total += __syncthreads_count(counted);
    // the next block's diagonal words, then the kept rows' words right of w
    if (t < kBlock && w + 1 < W) {
      const int row = base + kBlock + t;
      diag[(w + 1) & 1][t] = row < N ? mask[(size_t)row * W + w + 1] : 0;
    }
    const int nk = W - w - 1;
    for (int idx = t; idx < nkept * nk; idx += kSweepThreads) {
      const int k = w + 1 + idx % nk;
      const u64 v = mask[(size_t)(base + kept_rows[idx / nk]) * W + k];
      if (v) atomicOr(&removed[k], v);
    }
    __syncthreads();
  }
  if (t == 0) *num_kept = total;
}

}  // namespace

extern "C" {

// boxes [N, 4] f32 sorted by descending score, valid [N] bool in the same
// order; mask [N, ceil(N/64)] u64 scratch; keep [N] bool; num_kept one int32.
// Returns a cudaError_t code. The wrapper checks 1 <= N <= hgl_nms_max_n().
int hgl_nms(const void* boxes, const void* valid, int N, float thr, void* mask, void* keep, void* num_kept,
            void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int W = (N + kBlock - 1) / kBlock;
  nms_mask_kernel<<<dim3(W, W), kBlock, 0, st>>>(static_cast<const float*>(boxes), N, W, thr,
                                                  static_cast<u64*>(mask));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  nms_sweep_kernel<<<1, kSweepThreads, W * sizeof(u64), st>>>(static_cast<const u64*>(mask),
                                                              static_cast<const bool*>(valid), N, W,
                                                              static_cast<bool*>(keep), static_cast<int*>(num_kept));
  return cudaGetLastError();
}

// the largest N the sweep takes: its removed bits stay within the 48 KB of
// shared memory a block gets without opting in (with the static arrays)
int hgl_nms_max_n() { return 4096 * kBlock; }

}  // extern "C"
