// AMG pass-1 statistics on the tensor cores, for sm_90a (wgmma): the bf16
// kernels of K5 and K10.
//
// Replaces hybridgl_tpu/kernels/pass1_stats.py:pass1_stats_half (the Pallas
// `_stats_call` with pre_half=True) and pass1_stats (the full mode,
// pre_half=False) for bf16 stats, the default dtype policy.
// For every candidate b, inside the placement window (y0, x0, dh, dw),
//   logit[r, c] = sum_j Wy[r, j] * tmp[b, j, c]      (bf16 operands, f32 sums)
//   counts[b, 0] = #(logit > thresh + offset), counts[b, 1] = #(> thresh - offset)
//   row_any[b, r], col_any[b, c] = any(logit > thresh) along each row / column
// and the [B, C, C] frame never reaches device memory. pass1_stats.cu keeps the
// f32 CUDA-core kernel, which serves f32 stats (whose parity bar is exact
// boxes: the tensor cores sum in another order) and the shapes this kernel
// refuses (hgl_pass1_stats_tc_takes).
//
// What bounds it: 2 * B * dh * dw * n operations (30 GFLOP at 192 RefCOCO
// candidates) against B * n * dw * 2 bytes of tmp (63 MB): operations, by a
// factor of 1.6 at the published peaks. In practice the limit is feeding the
// tensor cores: every block pulls the window's Wy rows out of L2 once (245 MB
// at that shape) and loads its strip with nothing to overlap it.
//
// Design. Grid (128-column strip, candidate); a block whose strip misses the
// window leaves at once. The block loads its strip of tmp [n, 128] (64 KB at
// n = 256) into shared memory once, in the no-swizzle core-matrix layout of
// wgmma_common.cuh: tmp is [n, C] with C contiguous, which is the MN-major B
// operand. Two warpgroups then take alternate 64-row tiles of the window: a
// tile of Wy [64, n] (K-major A operand from shared memory, 32 KB,
// double-buffered per warpgroup with cp.async) against the resident strip,
// n / 16 wgmma m64n128k16 steps into a [64, 128] f32 accumulator in registers
// (64 a thread). The thresholds run on the accumulator fragment: three
// compares an element collected into bit masks, the window's rows and columns
// masked with the float comparisons of the plain version, counts by popc.
// A row's flag is an OR over the quad that shares the row (two shuffles) and
// is stored to device memory by one lane; column flags stay a per-thread bit
// mask over all row tiles and are combined across the warp's rows at the end.
// The warpgroups run independently (one named barrier each per tile), so one's
// thresholds run under the other's products. Blocks of one candidate meet
// only in the outputs: counts are added with integer atomics and flags are
// stored as 1 by any block that sees one (the wrapper zeroes the outputs).
// No producer warp and no mbarrier: every thread starts its share of the next
// tile's cp.async and waits for its own.
//
// K10 (the full mode, template FULL) is the same grid and the same sweep; what
// differs is how the strip gets into shared memory. Instead of copying tmp, the
// block computes it from the raw logits:
//   strip[n, 128] = low[b] [n, n2] @ WxT[:, c0 : c0 + 128]   (bf16, f32 sums)
// with the same wgmma m64n128k16. The WxT strip [n2, 128] (MN-major B operand,
// the layout of the tmp strip) and one 64-row tile of low[b] (K-major A
// operand, the layout of a Wy tile) per warpgroup are staged with cp.async in
// the space of the four Wy buffers, which the sweep does not need yet; the
// warpgroups take alternate 64-row tiles of low[b], and a warpgroup fetches
// its next tile under the epilogue of the last. The f32 sums are rounded to
// bf16 once, where the reference rounds tmp (pass1_stats.py:94), and stored
// from the accumulator fragment into the strip's core-matrix layout (a warp
// writes 8 rows x 16 bytes: 128 contiguous bytes, no bank conflict). Then
// fence.proxy.async and a block barrier, and the sweep starts as in K5. The
// transform's accumulator dies before the sweep's is born, so the full mode
// holds no more registers than K5. Shared memory, resident when: the strip
// (256 n bytes) throughout; beside it first the WxT strip (256 n2) and two low
// tiles (2 x 128 n2), then, once every product of the transform is done, the
// four Wy tiles (4 x 128 n): 256 n + 512 max(n, n2) bytes, 192 KB at 256.
// Work at 192 x [256, 256] -> C = 640: 16 GFLOP on top of the sweep's 30, and
// each block pulls low[b] (128 KB) and its WxT strip (64 KB) out of L2: that
// traffic, ~13 bytes a ns an SM, is what the transform phase costs (0.105 of
// 0.26 ms), not the wait for the first product: committing the first fetch in
// four groups along k, with the products following the groups, gave 0.256 ms
// for 0.260 and was not kept.
//
// A variant with one warpgroup a block, Wy in 16 KB chunks of 128 of n (a ring
// of three) and 112 KB a block, so that an SM holds two blocks and strip loads
// hide under the other block's products, was no faster (0.196 against 0.186 ms
// at 192 x [256, 640]): its chunks are fetched too shortly ahead to cover the
// L2 latency. Both are bound by pulling Wy out of L2 once per block; sharing a
// Wy tile between more columns (a 256-column strip, or a cluster with a
// multicast load) is the next step.
//
// Compile-time switches for tools/take_one_out.py (a variant's results are
// wrong by design): HGL_K5_MMA=0 skips the products, HGL_K5_THRESH=0 the
// thresholds, HGL_K5_FETCH=0 fetches only each warpgroup's first Wy tile;
// HGL_K10_TRANSFORM=0 skips the column transform's products (its loads and
// stores stay), HGL_K10_SWEEP=0 leaves after the transform.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "wgmma_common.cuh"

#ifndef HGL_K5_MMA
#define HGL_K5_MMA 1
#endif
#ifndef HGL_K5_THRESH
#define HGL_K5_THRESH 1
#endif
#ifndef HGL_K5_FETCH
#define HGL_K5_FETCH 1
#endif
#ifndef HGL_K10_TRANSFORM
#define HGL_K10_TRANSFORM 1
#endif
#ifndef HGL_K10_SWEEP
#define HGL_K10_SWEEP 1
#endif

namespace {

constexpr int STRIP = 128;  // columns a block keeps resident
constexpr int ROWS = 64;    // rows of a Wy tile (the wgmma M)
constexpr int MAX_N = 256;  // strip + four Wy tiles = 768 n bytes of shared memory
constexpr int THREADS = 256;

// d[64 x 128] (+)= A (shared memory, K-major) * B (shared memory), both by descriptor
template <int TRANS_B>
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t adesc, uint64_t bdesc, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, %67;\n}\n"
      : D8(d, 0), D8(d, 8), D8(d, 16), D8(d, 24), D8(d, 32), D8(d, 40), D8(d, 48), D8(d, 56)
      : "l"(adesc), "l"(bdesc), "r"(accumulate), "n"(TRANS_B));
}

// barrier over the 128 threads of one warpgroup (ids 1 and 2; 0 is __syncthreads)
__device__ __forceinline__ void warpgroup_sync(int wg) {
  if (wg == 0)
    asm volatile("bar.sync 1, 128;\n" ::: "memory");
  else
    asm volatile("bar.sync 2, 128;\n" ::: "memory");
}

__device__ __forceinline__ bool meets(int t0, int width, float lo, float extent) {
  return (float)t0 < lo + extent && (float)(t0 + width) > lo;
}

__device__ __forceinline__ bool inside(int i, int C, float lo, float extent) {
  const float f = (float)i;
  return i < C && f >= lo && f < lo + extent;
}

// One warpgroup's share of a Wy tile [64][n] at shared address dst: rows
// r0 .. r0 + 63 of wy [C, n], rows at or past C zero-filled (no commit). Unit
// u of the tile is row (u / n) * 8 + u % 8, chunk (u % n) / 8, at byte 16 u.
// The full mode's tiles of low[b] [n, n2] take the same form.
__device__ __forceinline__ void fill_wy(uint32_t dst, const __nv_bfloat16* wy, int r0, int n, int C, int t) {
  for (int u = t; u < ROWS * (n / 8); u += 128) {
    const int r = r0 + (u / n) * 8 + (u & 7), c = (u % n) >> 3;
    const bool live = r < C;
    cp_async16(dst + (uint32_t)u * 16, wy + (live ? (size_t)r * n + c * 8 : 0), live ? 16 : 0);
  }
}

// FULL = false: src is tmp [B, n, C] and wxt, n2 are unused. FULL = true: src
// is low [B, n, n2] and wxt [n2, C]; the block computes its strip of tmp.
template <bool FULL>
__global__ void __launch_bounds__(THREADS, 1)
pass1_stats_tc_kernel(const __nv_bfloat16* __restrict__ src, const __nv_bfloat16* __restrict__ wxt,
                      const __nv_bfloat16* __restrict__ wy, int n, int n2, int C, float y0, float x0, float dh,
                      float dw, float thresh, float offset, int* __restrict__ counts, uint8_t* __restrict__ row_any,
                      uint8_t* __restrict__ col_any) {
  const int c0 = blockIdx.x * STRIP;
  if (!meets(c0, STRIP, x0, dw)) return;  // the whole block leaves together
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ int red[2];
  const int strip_bytes = n * STRIP * 2, tile_bytes = ROWS * n * 2;
  const uint32_t strip = smem_u32(smem);

  const int tid = threadIdx.x, wg = tid >> 7, t = tid & 127, warp = t >> 5, lane = tid & 31;
  const int b = blockIdx.y;
  const uint32_t stage = strip + strip_bytes;           // the Wy buffers; first the transform's operands
  const uint32_t wy_buf = stage + wg * 2 * tile_bytes;  // this warpgroup's two buffers
  if (tid == 0) red[0] = red[1] = 0;

  // the window's row tiles are a contiguous range [rt_lo, rt_hi)
  const int ntiles = (C + ROWS - 1) / ROWS;
  int rt_lo = ntiles, rt_hi = 0;
  for (int rt = 0; rt < ntiles; ++rt)
    if (meets(rt * ROWS, ROWS, y0, dh)) {
      rt_lo = min(rt_lo, rt);
      rt_hi = rt + 1;
    }

  int rt = rt_lo + wg;
  if constexpr (!FULL) {
    // the strip: unit u is row (u / 128) * 8 + u % 8 of tmp[b], chunk (u % 128) / 8
    // of the strip's 16; columns at or past C are zero-filled
    const __nv_bfloat16* tb = src + (size_t)b * n * C + c0;
    for (int u = tid; u < n * (STRIP / 8); u += THREADS) {
      const int j = (u / STRIP) * 8 + (u & 7), c = (u % STRIP) >> 3;
      const bool live = c0 + c * 8 < C;
      cp_async16(strip + (uint32_t)u * 16, tb + (live ? (size_t)j * C + c * 8 : 0), live ? 16 : 0);
    }
  } else {
    // the column transform: the WxT strip [n2][128] (as the tmp strip above)
    // at stage, then one tile of low[b] [64][n2] per warpgroup
    const uint32_t wbuf = stage, abuf = stage + n2 * STRIP * 2 + wg * ROWS * n2 * 2;
    const __nv_bfloat16* lb = src + (size_t)b * n * n2;
    for (int u = tid; u < n2 * (STRIP / 8); u += THREADS) {
      const int j = (u / STRIP) * 8 + (u & 7), c = (u % STRIP) >> 3;
      const bool live = c0 + c * 8 < C;
      cp_async16(wbuf + (uint32_t)u * 16, wxt + (live ? (size_t)j * C + c0 + c * 8 : 0), live ? 16 : 0);
    }
    const int nt = (n + ROWS - 1) / ROWS;
    if (wg < nt) fill_wy(abuf, lb, wg * ROWS, n2, n, t);
    cp_async_commit();
    cp_async_wait<0>();
    fence_async_proxy();
    __syncthreads();  // the WxT strip and both warpgroups' first tiles have landed
    const uint64_t wdesc = make_desc(wbuf, STRIP * 16, 128), ldesc = make_desc(abuf, 128, n2 * 16);
    for (int lt = wg; lt < nt; lt += 2) {
      if (lt > wg) {
        cp_async_wait<0>();
        fence_async_proxy();
        warpgroup_sync(wg);  // this tile has landed for every thread of the warpgroup
      }
      float acc[64];
#if HGL_K10_TRANSFORM
      wgmma_fence();
#pragma unroll 4
      for (int kk = 0; kk < n2 / 16; ++kk)
        wgmma_ss_n128<1>(acc, ldesc + (uint64_t)(kk * 256 >> 4), wdesc + (uint64_t)(kk * 2 * STRIP * 16 >> 4), kk > 0);
      wgmma_commit();
      wgmma_wait0();
#else
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[i] = (float)(i + lt) - 40.f;
#endif
      pin(acc);
      warpgroup_sync(wg);  // every warp is past the products that read the tile
      if (lt + 2 < nt) fill_wy(abuf, lb, (lt + 2) * ROWS, n2, n, t);
      cp_async_commit();
      // rows ja and ja + 8 of tmp, rounded to bf16 once; n is a multiple of 16,
      // so a warp's 16 rows are all inside the strip or all past it
      const int ja = lt * ROWS + warp * 16 + (lane >> 2);
      if (lt * ROWS + warp * 16 < n) {
#pragma unroll
        for (int j = 0; j < STRIP / 8; ++j) {
          const uint32_t at = strip + tile_at<STRIP>(ja, j * 8 + (lane & 3) * 2);
          asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(at), "r"(pack_bf16(acc[j * 4], acc[j * 4 + 1])) : "memory");
          // eight rows further is the next group of core matrices
          asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(at + STRIP * 16), "r"(pack_bf16(acc[j * 4 + 2], acc[j * 4 + 3]))
                       : "memory");
        }
      }
    }
    cp_async_wait<0>();
    fence_async_proxy();
    __syncthreads();  // the strip is whole, and nothing reads the staged operands any more
#if !HGL_K10_SWEEP
    return;
#endif
  }
  if (rt < rt_hi) fill_wy(wy_buf, wy, rt * ROWS, n, C, t);
  cp_async_commit();

  // the columns this thread owns in every accumulator: bit j * 2 + e is column
  // c0 + j * 8 + (lane % 4) * 2 + e
  uint32_t colmask = 0;
#pragma unroll
  for (int j = 0; j < STRIP / 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e)
      if (inside(c0 + j * 8 + (lane & 3) * 2 + e, C, x0, dw)) colmask |= 1u << (j * 2 + e);
  const float th_hi = thresh + offset, th_lo = thresh - offset;
  uint32_t cany = 0;
  int hi = 0, lo = 0;

  cp_async_wait<0>();
  fence_async_proxy();
  __syncthreads();  // the strip and both warpgroups' first tiles have landed

  const uint64_t bdesc = make_desc(strip, STRIP * 16, 128);
  for (int it = 0; rt < rt_hi; rt += 2, ++it) {
    if (it > 0) {
      cp_async_wait<0>();
      fence_async_proxy();
      // this tile has landed for every thread of the warpgroup, and every warp
      // is past the products that read the other buffer
      warpgroup_sync(wg);
    }
#if HGL_K5_FETCH
    if (rt + 2 < rt_hi) fill_wy(wy_buf + ((it + 1) & 1) * tile_bytes, wy, (rt + 2) * ROWS, n, C, t);
#endif
    cp_async_commit();

    float acc[64];
#if HGL_K5_MMA
    const uint64_t adesc = make_desc(wy_buf + (it & 1) * tile_bytes, 128, n * 16);
    wgmma_fence();
#pragma unroll 4
    for (int kk = 0; kk < n / 16; ++kk)
      wgmma_ss_n128<1>(acc, adesc + (uint64_t)(kk * 256 >> 4), bdesc + (uint64_t)(kk * 2 * STRIP * 16 >> 4), kk > 0);
    wgmma_commit();
    wgmma_wait0();
#else
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = (float)(i + rt) - 40.f;
#endif
    pin(acc);

#if HGL_K5_THRESH
    // rows ra and ra + 8 of this tile; masks over the thread's 32 columns
    const int ra = rt * ROWS + warp * 16 + (lane >> 2);
    uint32_t ha = 0, la = 0, ta = 0, hb = 0, lb = 0, tb2 = 0;
#pragma unroll
    for (int j = 0; j < STRIP / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float va = acc[j * 4 + e], vb = acc[j * 4 + 2 + e];
        const int bit = j * 2 + e;
        ha |= (uint32_t)(va > th_hi) << bit;
        la |= (uint32_t)(va > th_lo) << bit;
        ta |= (uint32_t)(va > thresh) << bit;
        hb |= (uint32_t)(vb > th_hi) << bit;
        lb |= (uint32_t)(vb > th_lo) << bit;
        tb2 |= (uint32_t)(vb > thresh) << bit;
      }
    // a row outside the window raises no column flag, a column outside it no row flag
    const uint32_t ma = inside(ra, C, y0, dh) ? colmask : 0u, mb = inside(ra + 8, C, y0, dh) ? colmask : 0u;
    hi += __popc(ha & ma) + __popc(hb & mb);
    lo += __popc(la & ma) + __popc(lb & mb);
    ta &= ma;
    tb2 &= mb;
    cany |= ta | tb2;
    uint32_t any_a = ta, any_b = tb2;
    any_a |= __shfl_xor_sync(0xffffffffu, any_a, 1);
    any_a |= __shfl_xor_sync(0xffffffffu, any_a, 2);
    any_b |= __shfl_xor_sync(0xffffffffu, any_b, 1);
    any_b |= __shfl_xor_sync(0xffffffffu, any_b, 2);
    if ((lane & 3) == 0) {  // benign race with the other strips' blocks: every writer stores 1
      if (any_a) row_any[(size_t)b * C + ra] = 1;
      if (any_b) row_any[(size_t)b * C + ra + 8] = 1;
    }
#endif
  }

  // column flags: OR over the warp's eight rows, then lanes 0..3 store their columns
  cany |= __shfl_xor_sync(0xffffffffu, cany, 4);
  cany |= __shfl_xor_sync(0xffffffffu, cany, 8);
  cany |= __shfl_xor_sync(0xffffffffu, cany, 16);
  if (lane < 4) {
#pragma unroll
    for (int j = 0; j < STRIP / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        if (cany >> (j * 2 + e) & 1u) col_any[(size_t)b * C + c0 + j * 8 + lane * 2 + e] = 1;
  }
  // counts: warp sums, then one shared and one device atomic
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    hi += __shfl_xor_sync(0xffffffffu, hi, off);
    lo += __shfl_xor_sync(0xffffffffu, lo, off);
  }
  if (lane == 0) {
    atomicAdd(&red[0], hi);
    atomicAdd(&red[1], lo);
  }
  __syncthreads();
  if (tid == 0) {
    atomicAdd(&counts[2 * b], red[0]);
    atomicAdd(&counts[2 * b + 1], red[1]);
  }
}

}  // namespace

extern "C" {

// 1 where the tensor-core kernel takes this geometry (bf16 operands only): n
// a whole number of wgmma K steps whose strip and Wy tiles fit in shared
// memory, C a whole number of 16-byte chunks.
int hgl_pass1_stats_tc_takes(int n, int C) { return n >= 16 && n % 16 == 0 && n <= MAX_N && C >= 8 && C % 8 == 0; }

// Dynamic shared memory of a block at this n.
int hgl_pass1_stats_tc_smem(int n) { return n * STRIP * 2 + 4 * ROWS * n * 2; }

// The same for the full mode (K10): n2, the contraction of the column
// transform, is held to n's limits, and the staged operands share the Wy
// buffers' space.
int hgl_pass1_stats_full_tc_takes(int n, int n2, int C) {
  return hgl_pass1_stats_tc_takes(n, C) && n2 >= 16 && n2 % 16 == 0 && n2 <= MAX_N;
}
int hgl_pass1_stats_full_tc_smem(int n, int n2) { return n * STRIP * 2 + 4 * ROWS * (n > n2 ? n : n2) * 2; }

// K5 in bf16: tmp [B, n, C] and wy [C, n] bf16; counts [B, 2] int32, row_any
// and col_any [B, C] bytes, all zeroed by the caller. The caller has checked
// hgl_pass1_stats_tc_takes. Returns a cudaError_t code (0 = launched).
int hgl_pass1_stats_tc(const void* tmp, const void* wy, int B, int n, int C, float y0, float x0, float dh, float dw,
                       float thresh, float offset, int* counts, void* row_any, void* col_any, void* stream) {
  if (B < 1) return 0;
  if (B > 65535 || !hgl_pass1_stats_tc_takes(n, C)) return (int)cudaErrorInvalidValue;
  const int bytes = hgl_pass1_stats_tc_smem(n);
  cudaError_t err =
      cudaFuncSetAttribute(pass1_stats_tc_kernel<false>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((C + STRIP - 1) / STRIP, B);
  pass1_stats_tc_kernel<false><<<grid, THREADS, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(tmp), nullptr, static_cast<const __nv_bfloat16*>(wy), n, 0, C, y0, x0, dh, dw,
      thresh, offset, counts, static_cast<uint8_t*>(row_any), static_cast<uint8_t*>(col_any));
  return (int)cudaGetLastError();
}

// K10 in bf16: low [B, n, n2], wxt [n2, C] and wy [C, n] bf16; outputs as
// above, zeroed by the caller, who has checked hgl_pass1_stats_full_tc_takes.
int hgl_pass1_stats_full_tc(const void* low, const void* wxt, const void* wy, int B, int n, int n2, int C, float y0,
                            float x0, float dh, float dw, float thresh, float offset, int* counts, void* row_any,
                            void* col_any, void* stream) {
  if (B < 1) return 0;
  if (B > 65535 || !hgl_pass1_stats_full_tc_takes(n, n2, C)) return (int)cudaErrorInvalidValue;
  const int bytes = hgl_pass1_stats_full_tc_smem(n, n2);
  cudaError_t err =
      cudaFuncSetAttribute(pass1_stats_tc_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((C + STRIP - 1) / STRIP, B);
  pass1_stats_tc_kernel<true><<<grid, THREADS, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(low), static_cast<const __nv_bfloat16*>(wxt),
      static_cast<const __nv_bfloat16*>(wy), n, n2, C, y0, x0, dh, dw, thresh, offset, counts,
      static_cast<uint8_t*>(row_any), static_cast<uint8_t*>(col_any));
  return (int)cudaGetLastError();
}

}  // extern "C"
