// AMG pass-1 statistics for sm_90a: two entry points.
//
// K5 replaces hybridgl_tpu/kernels/pass1_stats.py:pass1_stats_half (the
// Pallas `_stats_call` with pre_half=True). For every candidate b it completes the
// canonical-frame logits one tile at a time,
//   logit[r, c] = sum_j Wy[r, j] * tmp[b, j, c]      (the row resize)
// and reduces them in place to
//   counts[b, 0] = #(logit > thresh + offset), counts[b, 1] = #(> thresh - offset)
//   row_any[b, r], col_any[b, c] = any(logit > thresh) along each row / column
// over the pixels inside the placement window (y0, x0, dh, dw); the
// [B, C, C] frame never reaches device memory.
//
// K10 replaces hybridgl_tpu/kernels/pass1_stats.py:pass1_stats (the same
// `_stats_call` with pre_half=False): it takes the raw logits low [B, n, n2]
// and runs the column transform tmp = low @ WxT inside the kernel too.
//
// Design, K5. One block of 256 threads per candidate. The block visits only the
// 64x64 output tiles that meet the window (tiles outside it contribute
// nothing, as in the TPU kernel's row-tile skip; here columns are skipped
// too). Each tile is a small GEMM over n in chunks of 32: Wy rows and tmp
// columns go through shared memory, each thread owns a 4x4 patch of f32
// sums. Operands are whatever the caller stored (bf16 under the reference's
// default HYBRIDGL_STATS_BF16 policy), widened to f32; sums and thresholds
// are f32. Row and column flags live in shared memory; counts are reduced
// across the block at the end.
//
// Design, K10. A candidate's whole tmp [n, C] does not fit in shared memory
// (512 KB in bf16 at n = 256, C = 1024), but one 64-column block of it does
// (64 KB in f32). So the grid is (column block, candidate): a block whose
// columns meet the window computes tmp[:, c0:c0+64] = low @ WxT[:, c0:c0+64]
// in 64-row groups (the same tile GEMM, low and WxT streamed in chunks of
// 32 of n2), rounds it to the stats dtype where the reference does, keeps it
// in shared memory, and sweeps the row tiles of the window against it.
// Dead columns and dead rows are both skipped: 2*n*n2*dw + 2*dh*dw*n flops
// per candidate. Blocks of one candidate meet only in the outputs: counts
// are added with integer atomics, and row flags are stored as 1 by any
// block that sees one (the wrapper zeroes the outputs first).
//
// What bounds both: compute on the f32 CUDA cores. K5 has one block per
// candidate (192 blocks at RefCOCO), so some SMs hold two blocks and some
// one; K10 has a block per live column block, which fills the card even at
// a few dozen candidates.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tile_common.cuh"

namespace {

constexpr int TILE = 64;
constexpr int KC = 32;       // n chunk
constexpr int TX = 16, TY = 16;
constexpr int PT = TILE / 16;  // 4 outputs per thread along each axis
constexpr int LDW = KC + 1;
constexpr int LDT = TILE + 1;

__device__ __forceinline__ bool meets(int t0, float lo, float extent) {
  return (float)t0 < lo + extent && (float)(t0 + TILE) > lo;
}

// Thresholds this thread's 4x4 patch of the tile at (r0, c0) inside the
// window: adds to hi/lo and raises the row flags and the column flags
// (cflag indexed from column cbase).
__device__ __forceinline__ void threshold_patch(const float (&acc)[PT][PT], int r0, int c0, int C,
                                                float y0, float x0, float dh, float dw,
                                                float thresh, float offset, int& hi, int& lo,
                                                int* rflag, int* cflag, int cbase) {
#pragma unroll
  for (int i = 0; i < PT; ++i) {
    const int r = r0 + threadIdx.y + TY * i;
    const float rf = (float)r;
    const bool rok = r < C && rf >= y0 && rf < y0 + dh;
#pragma unroll
    for (int j = 0; j < PT; ++j) {
      const int c = c0 + threadIdx.x + TX * j;
      const float cf = (float)c;
      if (!(rok && c < C && cf >= x0 && cf < x0 + dw)) continue;
      const float val = acc[i][j];
      hi += val > thresh + offset;
      lo += val > thresh - offset;
      if (val > thresh) {
        rflag[r] = 1;  // benign race: every writer stores 1
        cflag[c - cbase] = 1;
      }
    }
  }
}

// Block sums of hi and lo, valid in thread 0. Ends with a barrier.
__device__ __forceinline__ void block_sum2(int& hi, int& lo) {
  __shared__ int red[2][TX * TY / 32];
  const int tid = threadIdx.y * TX + threadIdx.x;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    hi += __shfl_xor_sync(0xffffffffu, hi, off);
    lo += __shfl_xor_sync(0xffffffffu, lo, off);
  }
  if ((tid & 31) == 0) {
    red[0][tid >> 5] = hi;
    red[1][tid >> 5] = lo;
  }
  __syncthreads();
  if (tid == 0) {
    hi = lo = 0;
    for (int w = 0; w < TX * TY / 32; ++w) {
      hi += red[0][w];
      lo += red[1][w];
    }
  }
  __syncthreads();
}

template <typename T>
__global__ void __launch_bounds__(TX * TY)
pass1_stats_kernel(const T* __restrict__ tmp, const T* __restrict__ wy, int n, int C,
                   float y0, float x0, float dh, float dw, float thresh, float offset,
                   float* __restrict__ counts, uint8_t* __restrict__ row_any,
                   uint8_t* __restrict__ col_any) {
  extern __shared__ float smem[];
  float* Ws = smem;                                  // [TILE][LDW]
  float* Ts = Ws + TILE * LDW;                       // [KC][LDT]
  int* rflag = reinterpret_cast<int*>(Ts + KC * LDT);  // [C]
  int* cflag = rflag + C;                            // [C]

  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * TX + tx;
  const int b = blockIdx.x;
  const T* tb = tmp + (size_t)b * n * C;

  for (int i = tid; i < C; i += TX * TY) {
    rflag[i] = 0;
    cflag[i] = 0;
  }
  int hi = 0, lo = 0;
  const int ntiles = (C + TILE - 1) / TILE;

  for (int rt = 0; rt < ntiles; ++rt) {
    const int r0 = rt * TILE;
    if (!meets(r0, y0, dh)) continue;
    for (int ct = 0; ct < ntiles; ++ct) {
      const int c0 = ct * TILE;
      if (!meets(c0, x0, dw)) continue;

      float acc[PT][PT];
#pragma unroll
      for (int i = 0; i < PT; ++i)
#pragma unroll
        for (int j = 0; j < PT; ++j) acc[i][j] = 0.f;

      for (int j0 = 0; j0 < n; j0 += KC) {
        __syncthreads();  // previous chunk's Ws/Ts reads are done
        for (int idx = tid; idx < TILE * KC; idx += TX * TY) {
          const int r = idx / KC, jj = idx % KC;
          const int row = r0 + r, col = j0 + jj;
          Ws[r * LDW + jj] = (row < C && col < n) ? to_f32(wy[(size_t)row * n + col]) : 0.f;
        }
        for (int idx = tid; idx < KC * TILE; idx += TX * TY) {
          const int jj = idx / TILE, c = idx % TILE;
          const int j = j0 + jj, col = c0 + c;
          Ts[jj * LDT + c] = (j < n && col < C) ? to_f32(tb[(size_t)j * C + col]) : 0.f;
        }
        __syncthreads();
#pragma unroll 8
        for (int jj = 0; jj < KC; ++jj) {
          float a[PT], bb[PT];
#pragma unroll
          for (int i = 0; i < PT; ++i) a[i] = Ws[(ty + TY * i) * LDW + jj];
#pragma unroll
          for (int j = 0; j < PT; ++j) bb[j] = Ts[jj * LDT + tx + TX * j];
#pragma unroll
          for (int i = 0; i < PT; ++i)
#pragma unroll
            for (int j = 0; j < PT; ++j) acc[i][j] = fmaf(a[i], bb[j], acc[i][j]);
        }
      }
      threshold_patch(acc, r0, c0, C, y0, x0, dh, dw, thresh, offset, hi, lo, rflag, cflag, 0);
    }
  }

  block_sum2(hi, lo);
  if (tid == 0) {
    counts[2 * b] = (float)hi;
    counts[2 * b + 1] = (float)lo;
  }
  for (int i = tid; i < C; i += TX * TY) {
    row_any[(size_t)b * C + i] = rflag[i] ? 1 : 0;
    col_any[(size_t)b * C + i] = cflag[i] ? 1 : 0;
  }
}

// K10. grid (column block, candidate); see the design note at the top.
// Shared memory: As [TILE][LDW], Bs [KC][LDT], Ts [n_pad][TILE] with n_pad =
// n rounded up to KC (rows past n hold exact zeros), rflag [C].
template <typename T>
__global__ void __launch_bounds__(TX * TY)
pass1_stats_full_kernel(const T* __restrict__ low, const T* __restrict__ wxt,
                        const T* __restrict__ wy, int n, int n2, int C, float y0, float x0,
                        float dh, float dw, float thresh, float offset,
                        int* __restrict__ counts, uint8_t* __restrict__ row_any,
                        uint8_t* __restrict__ col_any) {
  const int c0 = blockIdx.x * TILE;
  if (!meets(c0, x0, dw)) return;  // the whole block leaves together
  extern __shared__ float smem[];
  const int n_pad = (n + KC - 1) / KC * KC;
  float* As = smem;                                        // [TILE][LDW]
  float* Bs = As + TILE * LDW;                             // [KC][LDT]
  float* Ts = Bs + KC * LDT;                               // [n_pad][TILE]
  int* rflag = reinterpret_cast<int*>(Ts + (size_t)n_pad * TILE);  // [C]
  __shared__ int cflag[TILE];

  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * TX + tx;
  const int b = blockIdx.y;
  const T* lb = low + (size_t)b * n * n2;
  for (int i = tid; i < C; i += TX * TY) rflag[i] = 0;
  if (tid < TILE) cflag[tid] = 0;

  // 1. Ts = round_to<T>(low[b] @ WxT[:, c0:c0+64]), 64 rows at a time
  for (int g0 = 0; g0 < n_pad; g0 += TILE) {
    float acc[PT][PT];
#pragma unroll
    for (int i = 0; i < PT; ++i)
#pragma unroll
      for (int j = 0; j < PT; ++j) acc[i][j] = 0.f;
    for (int j0 = 0; j0 < n2; j0 += KC) {
      __syncthreads();  // previous chunk's As/Bs reads are done
      for (int idx = tid; idx < TILE * KC; idx += TX * TY) {
        const int r = idx / KC, jj = idx % KC;
        const int row = g0 + r, col = j0 + jj;
        As[r * LDW + jj] = (row < n && col < n2) ? to_f32(lb[(size_t)row * n2 + col]) : 0.f;
      }
      for (int idx = tid; idx < KC * TILE; idx += TX * TY) {
        const int jj = idx / TILE, c = idx % TILE;
        const int j = j0 + jj, col = c0 + c;
        Bs[jj * LDT + c] = (j < n2 && col < C) ? to_f32(wxt[(size_t)j * C + col]) : 0.f;
      }
      __syncthreads();
#pragma unroll 8
      for (int jj = 0; jj < KC; ++jj) {
        float a[PT], bb[PT];
#pragma unroll
        for (int i = 0; i < PT; ++i) a[i] = As[(ty + TY * i) * LDW + jj];
#pragma unroll
        for (int j = 0; j < PT; ++j) bb[j] = Bs[jj * LDT + tx + TX * j];
#pragma unroll
        for (int i = 0; i < PT; ++i)
#pragma unroll
          for (int j = 0; j < PT; ++j) acc[i][j] = fmaf(a[i], bb[j], acc[i][j]);
      }
    }
#pragma unroll
    for (int i = 0; i < PT; ++i) {
      const int r = g0 + ty + TY * i;  // rows past n summed zeros: acc is 0
      if (r < n_pad) {
#pragma unroll
        for (int j = 0; j < PT; ++j) Ts[r * TILE + tx + TX * j] = round_to<T>(acc[i][j]);
      }
    }
  }

  // 2. the window's row tiles: logit = Wy[r0:r0+64] @ Ts. The barriers at
  // the head of each chunk also order the Ts stores above before any read.
  int hi = 0, lo = 0;
  const int ntiles = (C + TILE - 1) / TILE;
  for (int rt = 0; rt < ntiles; ++rt) {
    const int r0 = rt * TILE;
    if (!meets(r0, y0, dh)) continue;
    float acc[PT][PT];
#pragma unroll
    for (int i = 0; i < PT; ++i)
#pragma unroll
      for (int j = 0; j < PT; ++j) acc[i][j] = 0.f;
    for (int j0 = 0; j0 < n_pad; j0 += KC) {
      __syncthreads();
      for (int idx = tid; idx < TILE * KC; idx += TX * TY) {
        const int r = idx / KC, jj = idx % KC;
        const int row = r0 + r, col = j0 + jj;
        As[r * LDW + jj] = (row < C && col < n) ? to_f32(wy[(size_t)row * n + col]) : 0.f;
      }
      __syncthreads();
#pragma unroll 8
      for (int jj = 0; jj < KC; ++jj) {
        float a[PT], bb[PT];
#pragma unroll
        for (int i = 0; i < PT; ++i) a[i] = As[(ty + TY * i) * LDW + jj];
#pragma unroll
        for (int j = 0; j < PT; ++j) bb[j] = Ts[(j0 + jj) * TILE + tx + TX * j];
#pragma unroll
        for (int i = 0; i < PT; ++i)
#pragma unroll
          for (int j = 0; j < PT; ++j) acc[i][j] = fmaf(a[i], bb[j], acc[i][j]);
      }
    }
    threshold_patch(acc, r0, c0, C, y0, x0, dh, dw, thresh, offset, hi, lo, rflag, cflag, c0);
  }

  // 3. this block's share of the outputs
  block_sum2(hi, lo);
  if (tid == 0) {
    atomicAdd(&counts[2 * b], hi);
    atomicAdd(&counts[2 * b + 1], lo);
  }
  for (int i = tid; i < C; i += TX * TY)
    if (rflag[i]) row_any[(size_t)b * C + i] = 1;
  if (tid < TILE && c0 + tid < C && cflag[tid]) col_any[(size_t)b * C + c0 + tid] = 1;
}

template <typename T>
int launch(const void* tmp, const void* wy, int B, int n, int C, float y0, float x0,
           float dh, float dw, float thresh, float offset, float* counts, void* row_any,
           void* col_any, cudaStream_t stream) {
  const size_t bytes = (size_t)(TILE * LDW + KC * LDT) * sizeof(float) + 2 * (size_t)C * sizeof(int);
  auto kern = pass1_stats_kernel<T>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  kern<<<B, dim3(TX, TY), bytes, stream>>>(
      static_cast<const T*>(tmp), static_cast<const T*>(wy), n, C, y0, x0, dh, dw, thresh,
      offset, counts, static_cast<uint8_t*>(row_any), static_cast<uint8_t*>(col_any));
  return (int)cudaGetLastError();
}

template <typename T>
int launch_full(const void* low, const void* wxt, const void* wy, int B, int n, int n2,
                int C, float y0, float x0, float dh, float dw, float thresh, float offset,
                int* counts, void* row_any, void* col_any, cudaStream_t stream) {
  const size_t n_pad = (size_t)(n + KC - 1) / KC * KC;
  const size_t bytes = (TILE * LDW + KC * LDT + n_pad * TILE) * sizeof(float) + (size_t)C * sizeof(int);
  auto kern = pass1_stats_full_kernel<T>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((C + TILE - 1) / TILE, B);
  kern<<<grid, dim3(TX, TY), bytes, stream>>>(
      static_cast<const T*>(low), static_cast<const T*>(wxt), static_cast<const T*>(wy), n, n2,
      C, y0, x0, dh, dw, thresh, offset, counts, static_cast<uint8_t*>(row_any),
      static_cast<uint8_t*>(col_any));
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// tmp [B, n, C] and wy [C, n], both bf16 (is_bf16) or both f32; counts
// [B, 2] f32; row_any, col_any [B, C] bytes (0/1). Returns a cudaError_t code.
int hgl_pass1_stats(const void* tmp, const void* wy, int B, int n, int C, float y0,
                    float x0, float dh, float dw, float thresh, float offset,
                    float* counts, void* row_any, void* col_any, int is_bf16,
                    void* stream) {
  if (B < 1) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch<__nv_bfloat16>(tmp, wy, B, n, C, y0, x0, dh, dw, thresh, offset,
                                         counts, row_any, col_any, st)
                 : launch<float>(tmp, wy, B, n, C, y0, x0, dh, dw, thresh, offset, counts,
                                 row_any, col_any, st);
}

// K10: low [B, n, n2], wxt [n2, C], wy [C, n], all bf16 (is_bf16) or all
// f32; counts [B, 2] int32, row_any and col_any [B, C] bytes, all zeroed by
// the caller. Returns a cudaError_t code.
int hgl_pass1_stats_full(const void* low, const void* wxt, const void* wy, int B, int n,
                         int n2, int C, float y0, float x0, float dh, float dw,
                         float thresh, float offset, int* counts, void* row_any,
                         void* col_any, int is_bf16, void* stream) {
  if (B < 1) return 0;
  if (B > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch_full<__nv_bfloat16>(low, wxt, wy, B, n, n2, C, y0, x0, dh, dw,
                                              thresh, offset, counts, row_any, col_any, st)
                 : launch_full<float>(low, wxt, wy, B, n, n2, C, y0, x0, dh, dw, thresh,
                                      offset, counts, row_any, col_any, st);
}

}  // extern "C"
