// Tiled online-softmax attention with an additive f32 bias, for sm_90a.
//
// Replaces three Pallas kernels of the JAX package with one design:
//   K1 hybridgl_tpu/kernels/flash_attention.py:flash_windowed_fused (SAM
//      windowed blocks, S = 196, G = 14),
//   K2 hybridgl_tpu/kernels/flash_attention.py:flash_attention_fused (SAM
//      global blocks, S = 4096, G = 64),
//   K6 hybridgl_tpu/kernels/clip_attention.py:clip_attention (CLIP blocks,
//      L = 197, bias on query row 0 only),
//   K9 hybridgl_tpu/kernels/flash_attention.py:flash_attention_rel_pos (the
//      pre-scaled tiled form, scale 1; only the kernel check calls it).
// The TPU kernels fold the SAM bias into an augmented 128-lane contraction;
// that is a layout trick for the MXU. Here the bias is rebuilt from its
// decomposed terms as the key loop runs:
//   REL_POS: bias[q, k] = rel_h[q, k / G] + rel_w[q, k % G]
//   CLS_ROW: bias[0, k] = cls_bias[n, k], other rows unbiased
//
// Design. One block of 256 threads per (batch*head, 64-query tile). The
// block walks 64-key tiles: K (transposed) and V go through shared memory,
// each thread owns a 4x4 patch of the 64x64 score tile and a 4x(HD/16)
// patch of the output (hd = 8: the first 8 threads of a row own one column
// each), softmax statistics and the accumulator stay in f32 registers, and
// the probabilities pass through shared memory to the PV product. Operands are widened to f32 on load; all arithmetic is f32 on the
// CUDA cores (no tensor cores, no TMA).
//
// What bounds it: at the SAM shapes the work is compute (S^2 * HD * 4 flops
// per head) on the f32 CUDA cores, and the inner loops are bound by
// shared-memory loads (two loads per four FMAs). Moving QK^T and PV onto
// wgmma with bf16 operands is the next step for speed.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int BQ = 64;          // query rows per block
constexpr int BK = 64;          // keys per tile
constexpr int TX = 16;          // threads along keys / output columns
constexpr int TY = 16;          // threads along query rows
constexpr int RPT = BQ / TY;    // query rows per thread
constexpr int CPT = BK / TX;    // score columns per thread
constexpr int LDQ = BQ + 1;     // padded strides: transposed stores stay
constexpr int LDK = BK + 1;     // free of bank conflicts
constexpr int LDP = BK + 1;

enum { REL_POS = 0, CLS_ROW = 1 };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

template <int HD, int MODE>
constexpr size_t smem_floats(int G) {
  return (size_t)HD * LDQ + (size_t)HD * LDK + (size_t)BK * HD + (size_t)BQ * LDP +
         (MODE == REL_POS ? (size_t)2 * BQ * G : 0);
}

// q, k, v, out: [BH, S, HD] contiguous. REL_POS: bias_a = rel_h, bias_b =
// rel_w, both [BH, S, G] f32. CLS_ROW: bias_a = cls_bias [BH / H, S] f32 or
// null, bias_b unused.
template <typename T, int HD, int MODE>
__global__ void __launch_bounds__(TX * TY)
attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const float* __restrict__ bias_a,
                 const float* __restrict__ bias_b, T* __restrict__ out, int S,
                 int G, int H, float scale) {
  constexpr int CPO = (HD + TX - 1) / TX;  // output columns per thread
  constexpr bool ALL_COLS = HD % TX == 0;  // else threads past column HD idle in PV
  extern __shared__ float smem[];
  float* Qt = smem;               // [HD][LDQ]  q * scale, transposed
  float* Kt = Qt + HD * LDQ;      // [HD][LDK]  key tile, transposed
  float* Vs = Kt + HD * LDK;      // [BK][HD]   value tile
  float* Ps = Vs + BK * HD;       // [BQ][LDP]  probabilities
  float* Rh = Ps + BQ * LDP;      // REL_POS: [BQ][G] rel_h rows of this tile
  float* Rw = Rh + BQ * G;        //          [BQ][G] rel_w rows

  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * TX + tx;
  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const size_t base = (size_t)bh * S * HD;

  for (int idx = tid; idx < BQ * HD; idx += TX * TY) {
    const int r = idx / HD, d = idx % HD;
    const int row = q0 + r;
    Qt[d * LDQ + r] = row < S ? to_f32(q[base + (size_t)row * HD + d]) * scale : 0.f;
  }
  if (MODE == REL_POS) {
    const size_t rbase = (size_t)bh * S * G;
    for (int idx = tid; idx < BQ * G; idx += TX * TY) {
      const int r = idx / G;
      const int row = q0 + r;
      const size_t off = rbase + (size_t)row * G + (idx % G);
      Rh[idx] = row < S ? bias_a[off] : 0.f;
      Rw[idx] = row < S ? bias_b[off] : 0.f;
    }
  }
  const float* cls_row = nullptr;
  if (MODE == CLS_ROW && bias_a != nullptr && q0 == 0) cls_row = bias_a + (size_t)(bh / H) * S;

  float m[RPT], l[RPT], o[RPT][CPO];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < CPO; ++c) o[i][c] = 0.f;
  }

  for (int k0 = 0; k0 < S; k0 += BK) {
    __syncthreads();  // previous tile's Kt/Vs/Ps reads are done
    for (int idx = tid; idx < BK * HD; idx += TX * TY) {
      const int r = idx / HD, d = idx % HD;
      const int key = k0 + r;
      const size_t off = base + (size_t)key * HD + d;
      const bool ok = key < S;
      Kt[d * LDK + r] = ok ? to_f32(k[off]) : 0.f;
      Vs[r * HD + d] = ok ? to_f32(v[off]) : 0.f;
    }
    __syncthreads();

    float s[RPT][CPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < CPT; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; ++d) {
      float a[RPT], b[CPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) a[i] = Qt[d * LDQ + ty + TY * i];
#pragma unroll
      for (int j = 0; j < CPT; ++j) b[j] = Kt[d * LDK + tx + TX * j];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < CPT; ++j) s[i][j] = fmaf(a[i], b[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int r = ty + TY * i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const int key = k0 + tx + TX * j;
        if (key >= S) {
          s[i][j] = -INFINITY;
        } else if (MODE == REL_POS) {
          s[i][j] += Rh[r * G + key / G] + Rw[r * G + key % G];
        } else if (cls_row != nullptr && r == 0) {
          s[i][j] += cls_row[key];
        }
        mx = fmaxf(mx, s[i][j]);
      }
      // the 16 threads of a row are one half-warp (tx = lane & 15)
#pragma unroll
      for (int off = TX / 2; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = __expf(m[i] - m_new);
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const float p = __expf(s[i][j] - m_new);
        Ps[r * LDP + tx + TX * j] = p;
        psum += p;
      }
#pragma unroll
      for (int off = TX / 2; off > 0; off >>= 1)
        psum += __shfl_xor_sync(0xffffffffu, psum, off);
      l[i] = l[i] * alpha + psum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < CPO; ++c) o[i][c] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float p[RPT], vv[CPO];
#pragma unroll
      for (int i = 0; i < RPT; ++i) p[i] = Ps[(ty + TY * i) * LDP + kk];
#pragma unroll
      for (int c = 0; c < CPO; ++c)
        vv[c] = (ALL_COLS || tx + TX * c < HD) ? Vs[kk * HD + tx + TX * c] : 0.f;
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int c = 0; c < CPO; ++c) o[i][c] = fmaf(p[i], vv[c], o[i][c]);
    }
  }

#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int row = q0 + ty + TY * i;
    if (row >= S) continue;
    const float inv = 1.f / l[i];
#pragma unroll
    for (int c = 0; c < CPO; ++c)
      if (ALL_COLS || tx + TX * c < HD) store(out + base + (size_t)row * HD + tx + TX * c, o[i][c] * inv);
  }
}

template <typename T, int HD, int MODE>
int launch(const void* q, const void* k, const void* v, const float* a,
           const float* b, void* out, int BH, int S, int G, int H, float scale,
           cudaStream_t stream) {
  const size_t bytes = smem_floats<HD, MODE>(G) * sizeof(float);
  auto kern = attention_kernel<T, HD, MODE>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((S + BQ - 1) / BQ, BH);
  dim3 block(TX, TY);
  kern<<<grid, block, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), a, b,
      static_cast<T*>(out), S, G, H, scale);
  return (int)cudaGetLastError();
}

template <typename T, int MODE>
int dispatch_hd(const void* q, const void* k, const void* v, const float* a,
                const float* b, void* out, int BH, int S, int HD, int G, int H,
                float scale, cudaStream_t stream) {
  switch (HD) {
    case 8: return launch<T, 8, MODE>(q, k, v, a, b, out, BH, S, G, H, scale, stream);
    case 16: return launch<T, 16, MODE>(q, k, v, a, b, out, BH, S, G, H, scale, stream);
    case 32: return launch<T, 32, MODE>(q, k, v, a, b, out, BH, S, G, H, scale, stream);
    case 64: return launch<T, 64, MODE>(q, k, v, a, b, out, BH, S, G, H, scale, stream);
    case 80: return launch<T, 80, MODE>(q, k, v, a, b, out, BH, S, G, H, scale, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// attention_wgmma.cu: the tensor-core kernels for bf16 operands
int hgl_rel_pos_tc_takes(int S, int HD, int G);
int hgl_rel_pos_attention_tc(const void* q, const void* k, const void* v, const float* rel_h,
                             const float* rel_w, void* out, int BH, int S, int HD, int G, float scale,
                             void* stream);

// K1, K2 and K9: decomposed rel-pos attention. is_bf16 selects bf16 or f32
// q/k/v/out. bf16 operands go to the tensor-core kernels where those take
// the geometry (hd 64 or 80; G = 64, or S <= 256); f32 operands and every
// other geometry run the CUDA-core kernel above. Returns a cudaError_t code
// (0 = launched).
int hgl_rel_pos_attention(const void* q, const void* k, const void* v,
                          const float* rel_h, const float* rel_w, void* out, int BH,
                          int S, int HD, int G, float scale, int is_bf16,
                          void* stream) {
  if (G < 1 || G > 64) return (int)cudaErrorInvalidValue;
  if (is_bf16 && hgl_rel_pos_tc_takes(S, HD, G))
    return hgl_rel_pos_attention_tc(q, k, v, rel_h, rel_w, out, BH, S, HD, G, scale, stream);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_bf16 ? dispatch_hd<__nv_bfloat16, REL_POS>(q, k, v, rel_h, rel_w, out, BH, S,
                                                       HD, G, 1, scale, st)
                 : dispatch_hd<float, REL_POS>(q, k, v, rel_h, rel_w, out, BH, S, HD, G,
                                               1, scale, st);
}

// K6: attention with a bias on query row 0 only; cls_bias is [BH / H, S]
// f32 or null (no bias).
int hgl_cls_attention(const void* q, const void* k, const void* v,
                      const float* cls_bias, void* out, int BH, int S, int HD, int H,
                      float scale, int is_bf16, void* stream) {
  if (H < 1 || BH % H) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_bf16 ? dispatch_hd<__nv_bfloat16, CLS_ROW>(q, k, v, cls_bias, nullptr, out, BH,
                                                       S, HD, 0, H, scale, st)
                 : dispatch_hd<float, CLS_ROW>(q, k, v, cls_bias, nullptr, out, BH, S, HD,
                                               0, H, scale, st);
}

const char* hgl_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
