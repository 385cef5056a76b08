// AMG pass-1 statistics for sm_90a.
//
// Replaces hybridgl_tpu/kernels/pass1_stats.py:pass1_stats_half (the Pallas
// `_stats_call` with pre_half=True). For every candidate b it completes the
// canonical-frame logits one tile at a time,
//   logit[r, c] = sum_j Wy[r, j] * tmp[b, j, c]      (the row resize)
// and reduces them in place to
//   counts[b, 0] = #(logit > thresh + offset), counts[b, 1] = #(> thresh - offset)
//   row_any[b, r], col_any[b, c] = any(logit > thresh) along each row / column
// over the pixels inside the placement window (y0, x0, dh, dw); the
// [B, C, C] frame never reaches device memory.
//
// Design. One block of 256 threads per candidate. The block visits only the
// 64x64 output tiles that meet the window (tiles outside it contribute
// nothing, as in the TPU kernel's row-tile skip; here columns are skipped
// too). Each tile is a small GEMM over n in chunks of 32: Wy rows and tmp
// columns go through shared memory, each thread owns a 4x4 patch of f32
// sums. Operands are whatever the caller stored (bf16 under the reference's
// default HYBRIDGL_STATS_BF16 policy), widened to f32; sums and thresholds
// are f32. Row and column flags live in shared memory; counts are reduced
// across the block at the end.
//
// What bounds it: compute, 2 * dh * dw * n flops per candidate on the f32
// CUDA cores, with one block per candidate (192 blocks at RefCOCO) leaving
// some SMs with two blocks and some with one.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE = 64;
constexpr int KC = 32;       // n chunk
constexpr int TX = 16, TY = 16;
constexpr int PT = TILE / 16;  // 4 outputs per thread along each axis
constexpr int LDW = KC + 1;
constexpr int LDT = TILE + 1;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

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
  __shared__ int red[2][TX * TY / 32];

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
    if (!((float)r0 < y0 + dh && (float)(r0 + TILE) > y0)) continue;
    for (int ct = 0; ct < ntiles; ++ct) {
      const int c0 = ct * TILE;
      if (!((float)c0 < x0 + dw && (float)(c0 + TILE) > x0)) continue;

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

#pragma unroll
      for (int i = 0; i < PT; ++i) {
        const int r = r0 + ty + TY * i;
        const float rf = (float)r;
        const bool rok = r < C && rf >= y0 && rf < y0 + dh;
#pragma unroll
        for (int j = 0; j < PT; ++j) {
          const int c = c0 + tx + TX * j;
          const float cf = (float)c;
          if (!(rok && c < C && cf >= x0 && cf < x0 + dw)) continue;
          const float val = acc[i][j];
          hi += val > thresh + offset;
          lo += val > thresh - offset;
          if (val > thresh) {
            rflag[r] = 1;  // benign race: every writer stores 1
            cflag[c] = 1;
          }
        }
      }
    }
  }

  // block reduction of the two counts
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
    int h = 0, l = 0;
    for (int w = 0; w < TX * TY / 32; ++w) {
      h += red[0][w];
      l += red[1][w];
    }
    counts[2 * b] = (float)h;
    counts[2 * b + 1] = (float)l;
  }
  for (int i = tid; i < C; i += TX * TY) {
    row_any[(size_t)b * C + i] = rflag[i] ? 1 : 0;
    col_any[(size_t)b * C + i] = cflag[i] ? 1 : 0;
  }
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

}  // extern "C"
