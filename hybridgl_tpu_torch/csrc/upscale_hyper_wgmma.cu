// Tensor-core upscale + hypernetwork tail for bf16 operands, for sm_90a (wgmma).
//
// The bf16 path of K4 at SAM's widths (C = 256, c4 = 64, c8 = 32, m = 1 or 3;
// see upscale_hyper.cu for the TPU kernel it replaces, the chain it computes
// and where it rounds, and for the CUDA-core kernel that keeps f32 operands
// and every other width). Per pixel r of a prompt's g x g grid:
//   d  = src[r] @ w1 + b1            [256] -> 4 groups (i, j) of c4 = 64
//   h1 = round(gelu(LN_c4(d)))
//   z  = h1[(i, j)] @ w2 + b2        [64] -> 4 groups (e, f) of c8 = 32
//   h2 = round(gelu(z))
//   mask[m][4h + 2i + e][4w + 2j + f] = h2[(i, j), (e, f)] . hyper[b, m]
//
// What bounds it: 52 GFLOP a launch at B = 64 is 0.05 ms of tensor-core time
// and the bytes (src in, masks out) 0.055 ms; what the kernel actually pays
// for is the GELU, 0.2 G erf evaluations a launch on the CUDA cores (768 per
// pixel), several times either bound.
//
// Design. One persistent block an SM (256 threads, two warpgroups) walks a
// contiguous range of 64-pixel tiles over all prompts. w1 [256][256] (128
// KB) and w2 [64][128] (16 KB) stay in shared memory as the B operands for
// the block's lifetime, read once as bf16; src tiles (32 KB) arrive with
// 16-byte cp.async through a two-stage ring, the next tile in flight under
// this tile's arithmetic. Warpgroup i takes the sub-row i of the first
// deconv and both its j groups, one after the other:
//   * deconv1 for group (i, j): wgmma m64n64k16 over 16 K-steps, src tile
//     (K-major) x w1 columns (MN-major), f32 accumulator [64 px, 64] in
//     registers. A pixel's 64 channels are 16 values in each of a quad's
//     four threads, so the LN over c4 is a sum over registers and two
//     shuffles;
//   * h1 is packed straight into the A fragments of deconv2 (the
//     accumulator's row/column ownership equals the A operand's): wgmma
//     m64n128k16 over 4 K-steps against w2, accumulator [64 px, (e, f, c8)];
//   * the hyper contraction runs on that fragment: a thread holds 8 of a
//     (pixel, e, f)'s 32 channels, the quad finishes the sum;
//   * with both j done a thread owns, for (pixel, i, e), the four mask
//     values (j, f) that are neighbours in the frame: one 16-byte store,
//     eight pixels of a warp making 128 contiguous bytes. Nothing but src,
//     the weights and the masks touches device memory, and no intermediate
//     passes through shared memory.
// A last tile with fewer than 64 pixels (g * g no multiple of 64) is
// zero-filled and its dead pixels are not stored.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "wgmma_common.cuh"

namespace {

constexpr int C = 256, C4 = 64, C8 = 32;
constexpr int N1 = 4 * C4, N2 = 4 * C8;
constexpr int TILE = 64;  // pixels per tile
constexpr int THREADS = 256;
constexpr int W1_BYTES = C * N1 * 2, W2_BYTES = C4 * N2 * 2, SRC_BYTES = TILE * C * 2;
constexpr int SMALL_FLOATS = 3 * C4 + C8;  // b1, ln_s, ln_b, b2
constexpr int SMEM_BYTES = W1_BYTES + W2_BYTES + 2 * SRC_BYTES + SMALL_FLOATS * 4;
constexpr float LN_EPS = 1e-6f;

// Timing switches (tools/take_one_out.py builds with one of them at 0; the
// results are then wrong and only the time is read): the GELU as the
// identity, the products skipped, the mask stores skipped, the src tiles
// fetched for the first tile only.
#ifndef HGL_K4_GELU
#define HGL_K4_GELU 1
#endif
#ifndef HGL_K4_MMA
#define HGL_K4_MMA 1
#endif
#ifndef HGL_K4_STORE
#define HGL_K4_STORE 1
#endif
#ifndef HGL_K4_FETCH
#define HGL_K4_FETCH 1
#endif

__device__ __forceinline__ float gelu(float x) {
#if HGL_K4_GELU
  return 0.5f * x * (1.f + erff(x * 0.70710678118654752f));
#else
  return x;
#endif
}
__device__ __forceinline__ float round_bf16(float x) { return __bfloat162float(__float2bfloat16(x)); }

// v[q] for a lane's position q in its quad, without indexing registers by q
__device__ __forceinline__ float pick(int q, float v0, float v1, float v2, float v3) {
  return q == 0 ? v0 : q == 1 ? v1 : q == 2 ? v2 : v3;
}

template <int M>
__global__ void __launch_bounds__(THREADS, 1)
upscale_hyper_tc_kernel(const __nv_bfloat16* __restrict__ src, const __nv_bfloat16* __restrict__ w1,
                        const float* __restrict__ b1, const float* __restrict__ ln_s,
                        const float* __restrict__ ln_b, const __nv_bfloat16* __restrict__ w2,
                        const float* __restrict__ b2, const __nv_bfloat16* __restrict__ hyper,
                        float* __restrict__ out, int R, int g, int tiles_per_prompt, int total_tiles) {
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t w1s = smem_u32(smem), w2s = w1s + W1_BYTES, ring = w2s + W2_BYTES;
  float* b1s = reinterpret_cast<float*>(smem + W1_BYTES + W2_BYTES + 2 * SRC_BYTES);
  float* lns = b1s + C4;
  float* lnb = lns + C4;
  float* b2s = lnb + C4;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wg = warp >> 2;                        // the first deconv's sub-row i
  const int row0 = (warp & 3) * 16 + (lane >> 2);  // this thread's pixels in the tile: row0, row0 + 8
  const int colq = (lane & 3) * 2;
  const int quad_pos = lane & 3;

  const int per = (total_tiles + gridDim.x - 1) / gridDim.x;
  const int t_begin = blockIdx.x * per, t_end = min(total_tiles, t_begin + per);
  if (t_begin >= t_end) return;

  auto prefetch = [&](int t, int stage) {
    const int b = t / tiles_per_prompt, p0 = (t % tiles_per_prompt) * TILE;
    fill_tile<C>(ring + stage * SRC_BYTES, src + ((size_t)b * R + p0) * C, TILE, min(TILE, R - p0), tid, THREADS);
  };

  fill_tile<N1>(w1s, w1, C, C, tid, THREADS);
  fill_tile<N2>(w2s, w2, C4, C4, tid, THREADS);
  prefetch(t_begin, 0);
  cp_async_commit();
  for (int i = tid; i < C4; i += THREADS) {
    b1s[i] = b1[i];
    lns[i] = ln_s[i];
    lnb[i] = ln_b[i];
  }
  for (int i = tid; i < C8; i += THREADS) b2s[i] = b2[i];

  const int G4 = 4 * g;
  for (int t = t_begin; t < t_end; ++t) {
    const int stage = (t - t_begin) & 1;
    if (HGL_K4_FETCH && t + 1 < t_end) prefetch(t + 1, stage ^ 1);
    cp_async_commit();
    cp_async_wait<1>();  // everything but the tile just asked for has landed
    fence_async_proxy();
    __syncthreads();

    const int b = t / tiles_per_prompt, p0 = (t % tiles_per_prompt) * TILE;
    // this prompt's hyper rows at the channels this thread's accumulator holds
    float hy[M][8];
#pragma unroll
    for (int mm = 0; mm < M; ++mm)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float2 h = unpack_bf16(
            *reinterpret_cast<const uint32_t*>(hyper + ((size_t)b * M + mm) * C8 + q * 8 + colq));
        hy[mm][q * 2] = h.x;
        hy[mm][q * 2 + 1] = h.y;
      }

    const uint64_t adesc = make_desc(ring + stage * SRC_BYTES, 128, C * 16);
    float y[2][2][4][M];  // [j][pixel row0 / row0 + 8][(e, f)][mask]
#pragma unroll
    for (int jj = 0; jj < 2; ++jj) {
      // ---- deconv1 for group (i, j) = (wg, jj): columns (wg * 2 + jj) * 64 ...
      float d1[32];
      const uint64_t w1desc = make_desc(w1s + (wg * 2 + jj) * (C4 / 8) * 128, N1 * 16, 128);
#if HGL_K4_MMA
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < C / 16; ++kk)
        wgmma_ss_n64<1>(d1, adesc + (uint64_t)(kk * 256 >> 4), w1desc + (uint64_t)(kk * 2 * N1 * 16 >> 4), kk > 0);
      wgmma_commit();
      wgmma_wait0();
#else
#pragma unroll
      for (int i = 0; i < 32; ++i) d1[i] = (float)(adesc + w1desc + i);
#endif
      pin(d1);

      // ---- bias, LN over the group's 64 channels, GELU, round: h1 as A fragments
      float s0 = 0.f, s1 = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float ba = b1s[j * 8 + colq], bb = b1s[j * 8 + colq + 1];
        d1[j * 4] += ba;
        d1[j * 4 + 1] += bb;
        d1[j * 4 + 2] += ba;
        d1[j * 4 + 3] += bb;
        s0 += d1[j * 4] + d1[j * 4 + 1];
        s1 += d1[j * 4 + 2] + d1[j * 4 + 3];
      }
      const float mu0 = quad_sum(s0) * (1.f / C4), mu1 = quad_sum(s1) * (1.f / C4);
      float v0 = 0.f, v1 = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        d1[j * 4] -= mu0;
        d1[j * 4 + 1] -= mu0;
        d1[j * 4 + 2] -= mu1;
        d1[j * 4 + 3] -= mu1;
        v0 += d1[j * 4] * d1[j * 4] + d1[j * 4 + 1] * d1[j * 4 + 1];
        v1 += d1[j * 4 + 2] * d1[j * 4 + 2] + d1[j * 4 + 3] * d1[j * 4 + 3];
      }
      const float rstd0 = rsqrtf(quad_sum(v0) * (1.f / C4) + LN_EPS);
      const float rstd1 = rsqrtf(quad_sum(v1) * (1.f / C4) + LN_EPS);
      uint32_t pa[4][4];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = j * 8 + colq;
        const float sa = lns[c], sb = lns[c + 1], oa = lnb[c], ob = lnb[c + 1];
        pa[j >> 1][(j & 1) * 2] = pack_bf16(gelu(d1[j * 4] * rstd0 * sa + oa), gelu(d1[j * 4 + 1] * rstd0 * sb + ob));
        pa[j >> 1][(j & 1) * 2 + 1] =
            pack_bf16(gelu(d1[j * 4 + 2] * rstd1 * sa + oa), gelu(d1[j * 4 + 3] * rstd1 * sb + ob));
      }

      // ---- deconv2: [64 px, 64] x w2 [64, (e, f, c8)]
      float d2[64];
      const uint64_t w2desc = make_desc(w2s, N2 * 16, 128);
#if HGL_K4_MMA
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < C4 / 16; ++kk) wgmma_n128<1>(d2, pa[kk], w2desc + (uint64_t)(kk * 2 * N2 * 16 >> 4), kk > 0);
      wgmma_commit();
      wgmma_wait0();
#else
#pragma unroll
      for (int i = 0; i < 64; ++i) d2[i] = __uint_as_float(pa[i & 3][(i >> 2) & 3]) + (float)(w2desc + i);
#endif
      pin(d2);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) pin(pa[kk]);

      // ---- bias, GELU, round, and the hyper contraction on the fragment
#pragma unroll
      for (int ef = 0; ef < 4; ++ef) {
        float acc0[M], acc1[M];
#pragma unroll
        for (int mm = 0; mm < M; ++mm) acc0[mm] = acc1[mm] = 0.f;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int jn = ef * 4 + q;
          const float ba = b2s[q * 8 + colq], bb = b2s[q * 8 + colq + 1];
          const float h00 = round_bf16(gelu(d2[jn * 4] + ba)), h01 = round_bf16(gelu(d2[jn * 4 + 1] + bb));
          const float h10 = round_bf16(gelu(d2[jn * 4 + 2] + ba)), h11 = round_bf16(gelu(d2[jn * 4 + 3] + bb));
#pragma unroll
          for (int mm = 0; mm < M; ++mm) {
            acc0[mm] = fmaf(h00, hy[mm][q * 2], fmaf(h01, hy[mm][q * 2 + 1], acc0[mm]));
            acc1[mm] = fmaf(h10, hy[mm][q * 2], fmaf(h11, hy[mm][q * 2 + 1], acc1[mm]));
          }
        }
#pragma unroll
        for (int mm = 0; mm < M; ++mm) {
          y[jj][0][ef][mm] = quad_sum(acc0[mm]);
          y[jj][1][ef][mm] = quad_sum(acc1[mm]);
        }
      }
    }

    // ---- stores: lane q of a quad writes pixel row0 + 8 (q / 2), sub-row e = q % 2:
    // the four values (j, f) are columns 4w .. 4w + 3 of frame row 4h + 2i + e
    {
      const int pixel = p0 + row0 + 8 * (quad_pos >> 1);
      if (pixel < R) {
        const int ph = pixel / g, pw = pixel % g;
        float* dst = out + (((size_t)b * M) * G4 + 4 * ph + 2 * wg + (quad_pos & 1)) * G4 + 4 * pw;
#pragma unroll
        for (int mm = 0; mm < M; ++mm) {
          float4 v;
          v.x = pick(quad_pos, y[0][0][0][mm], y[0][0][2][mm], y[0][1][0][mm], y[0][1][2][mm]);
          v.y = pick(quad_pos, y[0][0][1][mm], y[0][0][3][mm], y[0][1][1][mm], y[0][1][3][mm]);
          v.z = pick(quad_pos, y[1][0][0][mm], y[1][0][2][mm], y[1][1][0][mm], y[1][1][2][mm]);
          v.w = pick(quad_pos, y[1][0][1][mm], y[1][0][3][mm], y[1][1][1][mm], y[1][1][3][mm]);
          if (HGL_K4_STORE || v.x == 12345.678f) *reinterpret_cast<float4*>(dst + (size_t)mm * G4 * G4) = v;
        }
      }
    }
    __syncthreads();  // the stage is free for the tile after next
  }
}

template <int M>
int launch(const void* src, const void* w1, const float* b1, const float* ln_s, const float* ln_b, const void* w2,
           const float* b2, const void* hyper, float* out, int B, int R, int g, int blocks, cudaStream_t st) {
  auto kern = upscale_hyper_tc_kernel<M>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  const int tiles_per_prompt = (R + TILE - 1) / TILE, total = B * tiles_per_prompt;
  kern<<<(blocks < total ? blocks : total), THREADS, SMEM_BYTES, st>>>(
      static_cast<const __nv_bfloat16*>(src), static_cast<const __nv_bfloat16*>(w1), b1, ln_s, ln_b,
      static_cast<const __nv_bfloat16*>(w2), b2, static_cast<const __nv_bfloat16*>(hyper), out, R, g,
      tiles_per_prompt, total);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// 1 where the tensor-core kernel takes these widths (bf16 operands only).
int hgl_upscale_hyper_tc_takes(int C_, int c4, int c8, int m, int is_bf16) {
  return is_bf16 && C_ == C && c4 == C4 && c8 == C8 && (m == 1 || m == 3);
}

// Shared memory the tensor-core kernel asks for, in bytes.
int hgl_upscale_hyper_tc_smem() { return SMEM_BYTES; }

// bf16 K4 on the tensor cores: src [B, R, 256], w1 [256, 256], w2 [64, 128],
// hyper [B, m, 32] bf16; b1/ln_s/ln_b [64], b2 [32] f32 -> out [B, m, 4g, 4g]
// f32. ``blocks`` is the number of persistent blocks (one an SM). The caller
// has checked hgl_upscale_hyper_tc_takes. Returns a cudaError_t code.
int hgl_upscale_hyper_tc(const void* src, const void* w1, const float* b1, const float* ln_s, const float* ln_b,
                         const void* w2, const float* b2, const void* hyper, float* out, int B, int R, int g, int m,
                         int blocks, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return m == 3 ? launch<3>(src, w1, b1, ln_s, ln_b, w2, b2, hyper, out, B, R, g, blocks, st)
                : launch<1>(src, w1, b1, ln_s, ln_b, w2, b2, hyper, out, B, R, g, blocks, st);
}

}  // extern "C"
