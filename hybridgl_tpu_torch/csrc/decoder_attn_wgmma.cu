// Tensor-core decoder cross attentions for bf16 operands, for sm_90a (wgmma).
//
// The bf16 path of K3 (PASS), K7 (I2T) and K8 (T2I) at SAM's widths: C = 256,
// 8 heads x tp 8 = GT = GT2 = 64 lanes, S a multiple of 64 (see
// decoder_attn.cu for the TPU kernels they replace, what the modes compute
// and where they round, and for the CUDA-core kernel that keeps f32
// operands and every other shape). Two operand forms:
//   shared    (K3 pass A, K7 at layer 0): qside [1|B, S, 128] is the score
//             side, base [1|B, S, 256] the residual, no pe on the scores;
//   per-prompt (K3 pass B, K7 elsewhere): qside == base == the keys
//             [B, S, 256], scored as round(keys + pe).
//
// What bounds it: 0.5 GB of image stream per pass B at B = 64 (0.085 ms at
// the memory rate) against 43 GFLOP (0.04 ms on the tensor cores); the
// kernel pays for the element-wise work between the products (two softmaxes,
// the LN, the residual and pe adds), which runs on the CUDA cores while the
// tensor cores wait.
//
// Design. One block (256 threads, two warpgroups) per (prompt, row split),
// one block an SM; the splits' partial (m, l, acc) are merged by
// decoder_attn.cu's t2i_combine. The prompt's token-side operands stay in
// shared memory as wgmma operands for the block's lifetime: w [Cq, 64] and
// vo [64, 256] as MN-major B tiles, qw^T [64, 256] as a K-major A tile (the
// wrapper rounds w and qw to bf16 and transposes qw once, not once a block).
// Image rows come in 64-row tiles through a two-stage ring of two tiles each,
// X (base, which is the keys in the per-prompt form) and P (pe), filled with
// 16-byte cp.async one tile ahead; the shared form's 64 x 128 score-side tile
// has a single buffer that is refilled as soon as the scores have read it.
// Per tile:
//   i2t  scores [64 rows, 64 lanes] = A x w, A built in registers from the
//        tile(s) (per-prompt form: round(X + P), so qside + pe never exists
//        in memory). With tp = 8 each n8 block of the accumulator is one
//        head and a row's eight lanes sit in one quad: the grouped softmax
//        is shuffles only. attn, rounded, is packed from the accumulator
//        into the A fragments of attn x vo. Each warpgroup takes one half of
//        the 256 output channels (accumulator [64, 128], 64 registers), adds
//        base from X and const, and the row LN needs the other half's sums:
//        one exchange through shared memory. keys' goes to device memory
//        and, in PASS, back into X in place; kpe = round(keys' + pe)
//        overwrites P in place. So the tiles the t2i half reads are the
//        stage the i2t half was computed from.
//   t2i  flash attention with the roles turned: scores^T [64 lanes, 64 rows]
//        = qw^T (shared memory) x kpe^T (P, K-major), so the column softmax
//        is a row softmax on the fragment with running (m, l) in registers;
//        p^T, rounded, is packed into the A fragments of p^T x keys' (X,
//        MN-major), each warpgroup accumulating its half of the channels
//        (context [64, 128] f32 in 64 registers). Both warpgroups compute
//        the same scores and softmax.
// Three block barriers a tile; no mbarrier, no float atomics: results are
// the same from run to run.
//
// Shared memory: 96 KB operands + 2 x 64 KB stages + off and the LN exchange
// = 230,656 bytes. const and the LN scale and bias are read through L1.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "decoder_attn_params.cuh"
#include "wgmma_common.cuh"

namespace {

constexpr int C = 256, GT = 64, ROWS = 64, THREADS = 256;
constexpr int TILE_BYTES = ROWS * C * 2;  // one 64 x 256 bf16 tile
constexpr int STAGE_BYTES = 2 * TILE_BYTES;
constexpr int OPERAND_BYTES = 3 * TILE_BYTES;  // w (+ the shared form's score tile), vo, qw^T
constexpr int SMEM_BYTES = OPERAND_BYTES + 2 * STAGE_BYTES + GT * 4 + 2 * ROWS * 2 * 4;
constexpr float NEG_BIG = -1e30f;
constexpr float LN_EPS = 1e-5f;

// Timing switches (tools/take_one_out.py builds with one of them at 0; the
// results are then wrong and only the time is read): the four products
// skipped, the keys' stores to device memory skipped, the image tiles fetched
// for the first tile only.
#ifndef HGL_K3_MMA
#define HGL_K3_MMA 1
#endif
#ifndef HGL_K3_STORE
#define HGL_K3_STORE 1
#endif
#ifndef HGL_K3_FETCH
#define HGL_K3_FETCH 1
#endif

// 4-byte (bf16 pair) access to a tile in shared memory
__device__ __forceinline__ uint32_t lds32(const unsigned char* tile, uint32_t off) {
  return *reinterpret_cast<const uint32_t*>(tile + off);
}
__device__ __forceinline__ void sts32(unsigned char* tile, uint32_t off, uint32_t v) {
  *reinterpret_cast<uint32_t*>(tile + off) = v;
}
__device__ __forceinline__ uint32_t add_round(uint32_t a, uint32_t b) {
  const float2 x = unpack_bf16(a), y = unpack_bf16(b);
  return pack_bf16(x.x + y.x, x.y + y.y);
}

template <int MODE, bool SHARED>
__global__ void __launch_bounds__(THREADS, 1) decoder_attn_tc_kernel(DecoderAttnParams p) {
  constexpr int CQ = SHARED ? 128 : 256;
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* const w_tile = smem;                   // [CQ][64]
  unsigned char* const q_tile = smem + CQ * GT * 2;     // shared form: [64][128] score-side rows
  unsigned char* const vo_tile = smem + TILE_BYTES;     // [64][256]
  unsigned char* const qw_tile = smem + 2 * TILE_BYTES; // [64][256] (qw^T)
  unsigned char* const stages = smem + OPERAND_BYTES;
  float* const offs = reinterpret_cast<float*>(smem + OPERAND_BYTES + 2 * STAGE_BYTES);
  float* const red = offs + GT;  // [2 halves][64 rows][sum, sum of squares]

  const int S = p.S;
  const int b = blockIdx.x, split = blockIdx.y, tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31, wg = warp >> 2;
  const int r0 = (warp & 3) * 16 + (lane >> 2), r1 = r0 + 8;  // this thread's accumulator rows
  const int colq = (lane & 3) * 2;
  const int half = wg * (C / 2);  // this warpgroup's output channels

  const __nv_bfloat16* xsrc = static_cast<const __nv_bfloat16*>(MODE == T2I ? p.qside : p.base) +
                              ((MODE == T2I ? p.q_bcast : p.base_bcast) ? 0 : (size_t)b * S * C);
  const __nv_bfloat16* psrc =
      p.pe == nullptr ? nullptr : static_cast<const __nv_bfloat16*>(p.pe) + (p.pe_bcast ? 0 : (size_t)b * S * C);
  const __nv_bfloat16* qsrc = static_cast<const __nv_bfloat16*>(p.qside) + (p.q_bcast ? 0 : (size_t)b * S * CQ);
  __nv_bfloat16* keys_out = static_cast<__nv_bfloat16*>(p.keys_out) + (size_t)b * S * C;
  constexpr bool NEED_P = MODE != I2T || !SHARED;  // pe on the scores or in kpe

  if (MODE != T2I) {
    fill_tile<GT>(smem_u32(w_tile), static_cast<const __nv_bfloat16*>(p.w) + (size_t)b * CQ * GT, CQ, CQ, tid, THREADS);
    fill_tile<C>(smem_u32(vo_tile), static_cast<const __nv_bfloat16*>(p.vo) + (size_t)b * GT * C, GT, GT, tid, THREADS);
    for (int i = tid; i < GT; i += THREADS) offs[i] = p.off[(size_t)b * GT + i];
  }
  if (MODE != I2T)
    fill_tile<C>(smem_u32(qw_tile), static_cast<const __nv_bfloat16*>(p.qw) + (size_t)b * GT * C, GT, GT, tid, THREADS);

  const int ntiles = S / ROWS;
  const int per = (ntiles + p.nsplit - 1) / p.nsplit;
  const int t_begin = split * per, t_end = min(ntiles, t_begin + per);

  auto fetch_stage = [&](int t, int stage) {
    const uint32_t dst = smem_u32(stages + stage * STAGE_BYTES);
    fill_tile<C>(dst, xsrc + (size_t)t * ROWS * C, ROWS, ROWS, tid, THREADS);
    if (NEED_P) fill_tile<C>(dst + TILE_BYTES, psrc + (size_t)t * ROWS * C, ROWS, ROWS, tid, THREADS);
  };
  auto fetch_q = [&](int t) {
    fill_tile<CQ>(smem_u32(q_tile), qsrc + (size_t)t * ROWS * CQ, ROWS, ROWS, tid, THREADS);
  };
  if (t_begin < t_end) {
    fetch_stage(t_begin, 0);
    if (SHARED && MODE != T2I) fetch_q(t_begin);
  }
  cp_async_commit();

  float ctx[64];  // context rows r0, r1 (token lanes) x this warpgroup's 128 channels
#pragma unroll
  for (int i = 0; i < 64; ++i) ctx[i] = 0.f;
  float m0 = NEG_BIG, m1 = NEG_BIG, l0 = 0.f, l1 = 0.f;

  for (int t = t_begin; t < t_end; ++t) {
    const int stage = (t - t_begin) & 1;
    unsigned char* const X = stages + stage * STAGE_BYTES;
    unsigned char* const P = X + TILE_BYTES;
    cp_async_wait<0>();
    fence_async_proxy();
    __syncthreads();  // tile t has landed; every read of the other stage is over
    if (HGL_K3_FETCH && t + 1 < t_end) {
      fetch_stage(t + 1, stage ^ 1);
      cp_async_commit();
    }

    if (MODE != T2I) {
      // ---- scores = A x w, A fragments built from the tiles, 4 K-steps at a time
      float s[32];
      const uint64_t wdesc = make_desc(smem_u32(w_tile), GT * 16, 128);
#pragma unroll
      for (int chunk = 0; chunk < CQ / 64; ++chunk) {
        uint32_t a[4][4];
#pragma unroll
        for (int k4 = 0; k4 < 4; ++k4)
#pragma unroll
          for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int r = 0; r < 2; ++r) {
              const uint32_t at = tile_at<CQ>(r ? r1 : r0, (chunk * 4 + k4) * 16 + h * 8 + colq);
              a[k4][h * 2 + r] = SHARED ? lds32(q_tile, at) : add_round(lds32(X, at), lds32(P, at));
            }
#if HGL_K3_MMA
        wgmma_fence();
#pragma unroll
        for (int k4 = 0; k4 < 4; ++k4)
          wgmma_n64<1>(s, a[k4], wdesc + (uint64_t)((chunk * 4 + k4) * 2 * GT * 16 >> 4), chunk + k4 > 0);
        wgmma_commit();
        wgmma_wait0();
#else
#pragma unroll
        for (int i = 0; i < 32; ++i) s[i] = unpack_bf16(a[i & 3][(i >> 2) & 3]).x + (float)(wdesc & 7);
#endif
        pin(s);
#pragma unroll
        for (int k4 = 0; k4 < 4; ++k4) pin(a[k4]);
      }

      // ---- softmax over each head's 8 lanes (accumulator block j is head j)
      uint32_t pa[4][4];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float oa = offs[j * 8 + colq], ob = offs[j * 8 + colq + 1];
        const float v00 = s[j * 4] + oa, v01 = s[j * 4 + 1] + ob, v10 = s[j * 4 + 2] + oa, v11 = s[j * 4 + 3] + ob;
        const float mx0 = quad_max(fmaxf(v00, v01)), mx1 = quad_max(fmaxf(v10, v11));
        const float e00 = ex2((v00 - mx0) * LOG2E), e01 = ex2((v01 - mx0) * LOG2E);
        const float e10 = ex2((v10 - mx1) * LOG2E), e11 = ex2((v11 - mx1) * LOG2E);
        const float inv0 = 1.f / fmaxf(quad_sum(e00 + e01), 1e-30f), inv1 = 1.f / fmaxf(quad_sum(e10 + e11), 1e-30f);
        pa[j >> 1][(j & 1) * 2] = pack_bf16(e00 * inv0, e01 * inv0);
        pa[j >> 1][(j & 1) * 2 + 1] = pack_bf16(e10 * inv1, e11 * inv1);
      }

      // ---- x = attn x vo (this half's channels) + base + const, and the LN sums
      float x[64];
      const uint64_t vodesc = make_desc(smem_u32(vo_tile) + wg * (C / 16) * 128, C * 16, 128);
#if HGL_K3_MMA
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < GT / 16; ++kk) wgmma_n128<1>(x, pa[kk], vodesc + (uint64_t)(kk * 2 * C * 16 >> 4), kk > 0);
      wgmma_commit();
      wgmma_wait0();
#else
#pragma unroll
      for (int i = 0; i < 64; ++i) x[i] = unpack_bf16(pa[i & 3][(i >> 2) & 3]).x + (float)(vodesc & 7);
#endif
      pin(x);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) pin(pa[kk]);
      float s0 = 0.f, q0 = 0.f, s1 = 0.f, q1 = 0.f;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int c = half + j * 8 + colq;
        const float2 cn = __ldg(reinterpret_cast<const float2*>(p.cnst + c));
        const float2 ba = unpack_bf16(lds32(X, tile_at<C>(r0, c))), bb = unpack_bf16(lds32(X, tile_at<C>(r1, c)));
        x[j * 4] += ba.x + cn.x;
        x[j * 4 + 1] += ba.y + cn.y;
        x[j * 4 + 2] += bb.x + cn.x;
        x[j * 4 + 3] += bb.y + cn.y;
        s0 += x[j * 4] + x[j * 4 + 1];
        q0 += x[j * 4] * x[j * 4] + x[j * 4 + 1] * x[j * 4 + 1];
        s1 += x[j * 4 + 2] + x[j * 4 + 3];
        q1 += x[j * 4 + 2] * x[j * 4 + 2] + x[j * 4 + 3] * x[j * 4 + 3];
      }
      s0 = quad_sum(s0), q0 = quad_sum(q0), s1 = quad_sum(s1), q1 = quad_sum(q1);
      if ((lane & 3) == 0) {
        *reinterpret_cast<float2*>(red + (wg * ROWS + r0) * 2) = make_float2(s0, q0);
        *reinterpret_cast<float2*>(red + (wg * ROWS + r1) * 2) = make_float2(s1, q1);
      }
      __syncthreads();  // the halves' sums are out; every score has read its tiles
      if (HGL_K3_FETCH && SHARED && t + 1 < t_end) {
        fetch_q(t + 1);
        cp_async_commit();
      }
      {
        const float2 o0 = *reinterpret_cast<const float2*>(red + ((wg ^ 1) * ROWS + r0) * 2);
        const float2 o1 = *reinterpret_cast<const float2*>(red + ((wg ^ 1) * ROWS + r1) * 2);
        s0 += o0.x, q0 += o0.y, s1 += o1.x, q1 += o1.y;
      }
      const float mu0 = s0 * (1.f / C), mu1 = s1 * (1.f / C);
      const float rstd0 = rsqrtf(fmaxf(q0 * (1.f / C) - mu0 * mu0, 0.f) + LN_EPS);
      const float rstd1 = rsqrtf(fmaxf(q1 * (1.f / C) - mu1 * mu1, 0.f) + LN_EPS);
      __nv_bfloat16* out0 = keys_out + ((size_t)t * ROWS + r0) * C;
      __nv_bfloat16* out1 = keys_out + ((size_t)t * ROWS + r1) * C;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int c = half + j * 8 + colq;
        const float2 ls = __ldg(reinterpret_cast<const float2*>(p.ln_s + c));
        const float2 lb = __ldg(reinterpret_cast<const float2*>(p.ln_b + c));
        const uint32_t k0 = pack_bf16((x[j * 4] - mu0) * rstd0 * ls.x + lb.x, (x[j * 4 + 1] - mu0) * rstd0 * ls.y + lb.y);
        const uint32_t k1 =
            pack_bf16((x[j * 4 + 2] - mu1) * rstd1 * ls.x + lb.x, (x[j * 4 + 3] - mu1) * rstd1 * ls.y + lb.y);
        if (HGL_K3_STORE || k0 == 0x12345678u) {
          *reinterpret_cast<uint32_t*>(out0 + c) = k0;
          *reinterpret_cast<uint32_t*>(out1 + c) = k1;
        }
        if (MODE == PASS) {  // keys' over base, kpe over pe, in place
          const uint32_t a0 = tile_at<C>(r0, c), a1 = tile_at<C>(r1, c);
          sts32(X, a0, k0);
          sts32(X, a1, k1);
          sts32(P, a0, add_round(k0, lds32(P, a0)));
          sts32(P, a1, add_round(k1, lds32(P, a1)));
        }
      }
    } else {
      // ---- T2I alone: kpe = round(keys + pe) over pe, 16 bytes at a time
      for (int u = tid; u < TILE_BYTES / 16; u += THREADS) {
        const uint4 kv = *reinterpret_cast<const uint4*>(X + u * 16);
        uint4 pv = *reinterpret_cast<const uint4*>(P + u * 16);
        pv.x = add_round(kv.x, pv.x);
        pv.y = add_round(kv.y, pv.y);
        pv.z = add_round(kv.z, pv.z);
        pv.w = add_round(kv.w, pv.w);
        *reinterpret_cast<uint4*>(P + u * 16) = pv;
      }
    }
    if (MODE == I2T) continue;
    fence_async_proxy();
    __syncthreads();  // keys' and kpe are in X and P for the tensor cores

    // ---- scores^T [64 lanes, 64 rows] = qw^T x kpe^T
    float sT[32];
    {
      const uint64_t adesc = make_desc(smem_u32(qw_tile), 128, C * 16);
      const uint64_t bdesc = make_desc(smem_u32(P), 128, C * 16);
#if HGL_K3_MMA
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < C / 16; ++kk)
        wgmma_ss_n64<0>(sT, adesc + (uint64_t)(kk * 256 >> 4), bdesc + (uint64_t)(kk * 256 >> 4), kk > 0);
      wgmma_commit();
      wgmma_wait0();
#else
#pragma unroll
      for (int i = 0; i < 32; ++i) sT[i] = unpack_bf16(lds32(P, 4 * (tid + THREADS * i))).x + (float)((adesc + bdesc) & 7);
#endif
      pin(sT);
    }
    // ---- online softmax along the rows of the tile; p^T rounded into A fragments
    float mx0 = NEG_BIG, mx1 = NEG_BIG;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      mx0 = fmaxf(mx0, fmaxf(sT[j * 4], sT[j * 4 + 1]));
      mx1 = fmaxf(mx1, fmaxf(sT[j * 4 + 2], sT[j * 4 + 3]));
    }
    const float new0 = fmaxf(m0, quad_max(mx0)), new1 = fmaxf(m1, quad_max(mx1));
    const float alpha0 = ex2((m0 - new0) * LOG2E), alpha1 = ex2((m1 - new1) * LOG2E);
    const float c0 = -new0 * LOG2E, c1 = -new1 * LOG2E;
    m0 = new0;
    m1 = new1;
    uint32_t pt[4][4];
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float p00 = ex2(fmaf(sT[j * 4], LOG2E, c0)), p01 = ex2(fmaf(sT[j * 4 + 1], LOG2E, c0));
      const float p10 = ex2(fmaf(sT[j * 4 + 2], LOG2E, c1)), p11 = ex2(fmaf(sT[j * 4 + 3], LOG2E, c1));
      sum0 += p00 + p01;
      sum1 += p10 + p11;
      pt[j >> 1][(j & 1) * 2] = pack_bf16(p00, p01);
      pt[j >> 1][(j & 1) * 2 + 1] = pack_bf16(p10, p11);
    }
    l0 = l0 * alpha0 + sum0;  // this thread's columns; the quad is summed at the end
    l1 = l1 * alpha1 + sum1;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      ctx[j * 4] *= alpha0;
      ctx[j * 4 + 1] *= alpha0;
      ctx[j * 4 + 2] *= alpha1;
      ctx[j * 4 + 3] *= alpha1;
    }
    // ---- ctx += p^T x keys' (this half's channels)
    {
      const uint64_t kdesc = make_desc(smem_u32(X) + wg * (C / 16) * 128, C * 16, 128);
      pin(ctx);
#if HGL_K3_MMA
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < ROWS / 16; ++kk) wgmma_n128<1>(ctx, pt[kk], kdesc + (uint64_t)(kk * 2 * C * 16 >> 4), 1);
      wgmma_commit();
      wgmma_wait0();
#else
#pragma unroll
      for (int i = 0; i < 64; ++i) ctx[i] += unpack_bf16(pt[i & 3][(i >> 2) & 3]).x + (float)(kdesc & 7);
#endif
      pin(ctx);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) pin(pt[kk]);
    }
  }
  cp_async_wait<0>();

  if (MODE == I2T) return;
  l0 = quad_sum(l0);
  l1 = quad_sum(l1);
  const size_t pb = ((size_t)b * p.nsplit + split) * GT;
  if (wg == 0 && (lane & 3) == 0) {
    p.part_m[pb + r0] = m0;
    p.part_m[pb + r1] = m1;
    p.part_l[pb + r0] = l0;
    p.part_l[pb + r1] = l1;
  }
  float* acc0 = p.part_acc + (pb + r0) * C + half + colq;
  float* acc1 = p.part_acc + (pb + r1) * C + half + colq;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    *reinterpret_cast<float2*>(acc0 + j * 8) = make_float2(ctx[j * 4], ctx[j * 4 + 1]);
    *reinterpret_cast<float2*>(acc1 + j * 8) = make_float2(ctx[j * 4 + 2], ctx[j * 4 + 3]);
  }
}

template <int MODE, bool SHARED>
int launch(const DecoderAttnParams& p, cudaStream_t st) {
  auto kern = decoder_attn_tc_kernel<MODE, SHARED>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  kern<<<dim3(p.B, p.nsplit), THREADS, SMEM_BYTES, st>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// 1 where the tensor-core kernel takes this call (bf16 operands only):
// SAM's widths, S a multiple of the 64-row tile, and one of the two operand
// forms (same_base: qside and base are one tensor, scored with pe; else a
// 128-wide score side without pe).
int hgl_decoder_attn_tc_takes(int mode, int S, int Cq, int C_, int heads, int tp, int GT2, int add_pe,
                              int same_base, int is_bf16) {
  if (!is_bf16 || C_ != C || S < ROWS || S % ROWS) return 0;
  if (mode == T2I) return GT2 == GT && Cq == C;
  if (mode != I2T && mode != PASS) return 0;
  if (heads != 8 || tp != 8 || (mode == PASS && GT2 != GT)) return 0;
  return add_pe ? (same_base && Cq == C) : (!same_base && Cq == 128);
}

// Shared memory the tensor-core kernel asks for, in bytes.
int hgl_decoder_attn_tc_smem() { return SMEM_BYTES; }

// The bf16 decoder cross attentions on the tensor cores; the caller has
// checked hgl_decoder_attn_tc_takes and merges the row splits afterwards.
// Returns a cudaError_t code (0 = launched).
int hgl_decoder_attn_tc(int mode, const DecoderAttnParams* p, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (mode == T2I) return launch<T2I, false>(*p, st);
  if (mode == PASS) return p->add_pe ? launch<PASS, false>(*p, st) : launch<PASS, true>(*p, st);
  return p->add_pe ? launch<I2T, false>(*p, st) : launch<I2T, true>(*p, st);
}

}  // extern "C"
