// The glue of the CLIP residual block for sm_90a, on the CUDA cores, in bf16 or f32.
//
// Replaces no TPU kernel: in the JAX package XLA fuses the elementwise work
// around the block's matrix products and K6 (clip_attention) by itself. In
// the port each of those PyTorch operations is a kernel of its own inside the
// captured feature and sentence graphs, and LayerNorm alone is about ten f32
// passes. Four kernels take their place (kernels/clip_glue.py wraps them):
//
//   clip_glue_rows       one warp a row of D <= 1024 values, in four modes:
//                        LN        out = LN(x)  (x may be a strided row view)
//                        RESIDUAL  x' = x + (y + b)
//                        RES_LN    x' = x + (y + b), out = LN(x')
//                        INJECT_LN x' = x + 2 (x2 m) on patch rows,
//                                  x + 2 x2 on the CLS row, out = LN(x')
//                        (y the output of a matrix product, b its bias, m
//                        the f32 proposal mask on the patch grid: the G2L
//                        injection of models/clip/fusion.py);
//   clip_glue_qkv_heads  qkv + b of the [T, 3D] in-projection output,
//                        written as q, k, v in K6's [N*H, L, hd] layout;
//   clip_glue_merge      K6's [N*H, L, hd] context back to [N, L, D];
//   clip_glue_bias_gelu  QuickGELU of h + b: t * sigmoid(1.702 t).
//
// Exactness. Every elementwise step rounds to the activation dtype where the
// plain PyTorch sequence (kernels/clip_glue.py, reference_*) rounds, each in
// one IEEE f32 operation first (the _rn intrinsics keep nvcc from contracting
// a product and a sum into an FMA; expf and the division are the accurate
// ones, as in PyTorch's sigmoid): the bias add, residual, injection, head
// split, merge and QuickGELU equal the plain sequence bit for bit. LayerNorm
// keeps its statistics, scale and bias in f32 as the plain version does and
// rounds once; its two sums run in a warp's shuffle order, not in PyTorch's
// reduction order, so an output may lie one rounding step from the plain one.
//
// What bounds them: bytes. None does more than ~10 f32 operations a value
// read, except QuickGELU's exp and division; each reads its inputs once and
// writes its outputs once, neighbouring threads on neighbouring addresses
// (16 bytes a thread; the row kernel 4 values a lane). The row kernel holds a
// whole row in one warp's registers (D / 128 groups of 4 a lane), so the
// two-pass mean and variance cost no second read of memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kWarps = 4;      // rows a block of the row kernel
constexpr int kThreads = 256;  // threads a block of the elementwise kernels
constexpr int kMaxGroups = 8;  // groups of 4 values a lane holds: D <= 32 * 8 * 4

enum { LN = 0, RESIDUAL = 1, RES_LN = 2, INJECT_LN = 3 };

// rounding to the activation dtype, and 4 and 16-byte vectors of it
template <typename T>
__device__ __forceinline__ float rnd(float v);
template <>
__device__ __forceinline__ float rnd<bf16>(float v) { return __bfloat162float(__float2bfloat16_rn(v)); }
template <>
__device__ __forceinline__ float rnd<float>(float v) { return v; }

// two values rounded in one conversion, and widened back
template <typename T>
__device__ __forceinline__ float2 rnd2(float a, float b);
template <>
__device__ __forceinline__ float2 rnd2<bf16>(float a, float b) { return __bfloat1622float2(__floats2bfloat162_rn(a, b)); }
template <>
__device__ __forceinline__ float2 rnd2<float>(float a, float b) { return make_float2(a, b); }

template <typename T>
struct Vec4;  // 4 values
template <>
struct Vec4<bf16> {
  using type = uint2;
  static __device__ __forceinline__ void load(const type& u, float f[4]) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
    const float2 a = __bfloat1622float2(h[0]), b = __bfloat1622float2(h[1]);
    f[0] = a.x; f[1] = a.y; f[2] = b.x; f[3] = b.y;
  }
  static __device__ __forceinline__ type store(const float f[4]) {
    type u;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
    h[0] = __floats2bfloat162_rn(f[0], f[1]);
    h[1] = __floats2bfloat162_rn(f[2], f[3]);
    return u;
  }
};
template <>
struct Vec4<float> {
  using type = float4;
  static __device__ __forceinline__ void load(const type& u, float f[4]) { f[0] = u.x; f[1] = u.y; f[2] = u.z; f[3] = u.w; }
  static __device__ __forceinline__ type store(const float f[4]) { return make_float4(f[0], f[1], f[2], f[3]); }
};

template <typename T>
__host__ __device__ constexpr int per16() { return 16 / (int)sizeof(T); }  // values in 16 bytes

template <typename T>
__device__ __forceinline__ void load16(const uint4& u, float* f) {
  Vec4<T>::load(reinterpret_cast<const typename Vec4<T>::type*>(&u)[0], f);
  if constexpr (per16<T>() == 8) Vec4<T>::load(reinterpret_cast<const typename Vec4<T>::type*>(&u)[1], f + 4);
}

template <typename T>
__device__ __forceinline__ uint4 store16(const float* f) {
  uint4 u;
  reinterpret_cast<typename Vec4<T>::type*>(&u)[0] = Vec4<T>::store(f);
  if constexpr (per16<T>() == 8) reinterpret_cast<typename Vec4<T>::type*>(&u)[1] = Vec4<T>::store(f + 4);
  return u;
}

__device__ __forceinline__ float warp_sum(float s) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  return s;
}

// One warp a row of D = 4 * D4 values; lane l holds the 4-vectors l, l + 32, ...
// x is read at row * x_stride (elements); every other tensor is [rows, D].
template <typename T, int NG, int MODE>
__global__ void __launch_bounds__(kWarps * 32)
clip_glue_rows(const T* __restrict__ x, int x_stride, const T* __restrict__ y, const T* __restrict__ b,
               const float* __restrict__ m, const T* __restrict__ lw, const T* __restrict__ lb, T* __restrict__ x_out,
               T* __restrict__ ln_out, int rows, int D4, int L, float inv_d, float eps) {
  using V = Vec4<T>;
  using VT = typename V::type;
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= rows) return;
  const VT* xr = reinterpret_cast<const VT*>(x + (size_t)row * x_stride);
  const size_t base = (size_t)row * D4;
  float v[NG][4];
  float mv = 0.0f;  // INJECT_LN: the patch row's mask value in the activation dtype; the CLS row has none
  bool cls = false;
  if (MODE == INJECT_LN) {
    const int n = row / L, l = row % L;
    cls = l == 0;
    if (!cls) mv = rnd<T>(m[(size_t)n * (L - 1) + (l - 1)]);
  }
  float sum = 0.0f;
#pragma unroll
  for (int g = 0; g < NG; ++g) {
    const int c = lane + 32 * g;
#pragma unroll
    for (int i = 0; i < 4; ++i) v[g][i] = 0.0f;
    if (c >= D4) continue;
    V::load(xr[c], v[g]);
    if (MODE != LN) {
      float t[4];
      V::load(reinterpret_cast<const VT*>(y)[base + c], t);
      if (MODE == INJECT_LN) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float s = cls ? t[i] : rnd<T>(__fmul_rn(t[i], mv));         // token_mask
          v[g][i] = rnd<T>(__fadd_rn(rnd<T>(__fmul_rn(2.0f, s)), v[g][i]));  // 2.0 * tm + x
        }
      } else {
        float bb[4];
        V::load(reinterpret_cast<const VT*>(b)[c], bb);
#pragma unroll
        for (int i = 0; i < 4; ++i) v[g][i] = rnd<T>(__fadd_rn(v[g][i], rnd<T>(__fadd_rn(t[i], bb[i]))));  // x + (y + b)
      }
      reinterpret_cast<VT*>(x_out)[base + c] = V::store(v[g]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) sum += v[g][i];
  }
  if (MODE == RESIDUAL) return;
  // the plain version's steps: mean, x - mean, mean of its squares, rsqrt(var + eps), scale, shift
  const float mu = warp_sum(sum) * inv_d;
  float sq = 0.0f;
#pragma unroll
  for (int g = 0; g < NG; ++g) {
    if (lane + 32 * g >= D4) continue;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      v[g][i] = __fsub_rn(v[g][i], mu);
      sq += v[g][i] * v[g][i];
    }
  }
  const float rstd = rsqrtf(warp_sum(sq) * inv_d + eps);
#pragma unroll
  for (int g = 0; g < NG; ++g) {
    const int c = lane + 32 * g;
    if (c >= D4) continue;
    float w[4], bi[4];
    V::load(reinterpret_cast<const VT*>(lw)[c], w);
    V::load(reinterpret_cast<const VT*>(lb)[c], bi);
#pragma unroll
    for (int i = 0; i < 4; ++i) v[g][i] = __fadd_rn(__fmul_rn(__fmul_rn(v[g][i], rstd), w[i]), bi[i]);
    reinterpret_cast<VT*>(ln_out)[base + c] = V::store(v[g]);
  }
}

// y [N*L, 3*Dv vectors] + b [3*Dv] -> q, k, v [N*H, L, hdv vectors] (16-byte vectors)
template <typename T>
__global__ void __launch_bounds__(kThreads)
clip_glue_qkv_heads(const uint4* __restrict__ y, const uint4* __restrict__ b, uint4* __restrict__ q,
                    uint4* __restrict__ k, uint4* __restrict__ v, size_t total, int L, int Dv, int H, int hdv) {
  const size_t i = (size_t)blockIdx.x * kThreads + threadIdx.x;
  if (i >= total) return;
  const int D3 = 3 * Dv;
  const size_t t = i / D3;
  const int c = (int)(i - t * D3);
  const int s = c / Dv, cc = c - s * Dv;
  const int h = cc / hdv, j = cc - h * hdv;
  const size_t n = t / L, l = t - n * L;
  float a[8], bb[8];
  load16<T>(y[i], a);
  load16<T>(b[c], bb);
#pragma unroll
  for (int e = 0; e < per16<T>(); ++e) a[e] = __fadd_rn(a[e], bb[e]);
  uint4* dst = s == 0 ? q : (s == 1 ? k : v);
  dst[((n * H + h) * L + l) * hdv + j] = store16<T>(a);
}

// ctx [N*H, L, hdv vectors] -> out [N*L, Dv vectors]: a copy of 16-byte vectors, for either dtype
__global__ void __launch_bounds__(kThreads)
clip_glue_merge(const uint4* __restrict__ ctx, uint4* __restrict__ out, size_t total, int L, int Dv, int H, int hdv) {
  const size_t i = (size_t)blockIdx.x * kThreads + threadIdx.x;
  if (i >= total) return;
  const size_t t = i / Dv;
  const int c = (int)(i - t * Dv);
  const int h = c / hdv, j = c - h * hdv;
  const size_t n = t / L, l = t - n * L;
  out[i] = ctx[((n * H + h) * L + l) * hdv + j];
}

// h [rows, Fv vectors] + b [Fv] -> QuickGELU, each step rounded as PyTorch's ops in this dtype round
template <typename T>
__global__ void __launch_bounds__(kThreads)
clip_glue_bias_gelu(const uint4* __restrict__ h, const uint4* __restrict__ b, uint4* __restrict__ out, size_t total,
                    int Fv) {
  const size_t i = (size_t)blockIdx.x * kThreads + threadIdx.x;
  if (i >= total) return;
  float a[8], bb[8];
  load16<T>(h[i], a);
  load16<T>(b[i % Fv], bb);
#pragma unroll
  for (int e = 0; e < per16<T>(); e += 2) {
    const float2 t = rnd2<T>(__fadd_rn(a[e], bb[e]), __fadd_rn(a[e + 1], bb[e + 1]));  // h + b
    const float2 s = rnd2<T>(__fmul_rn(t.x, 1.702f), __fmul_rn(t.y, 1.702f));           // 1.702 * x
    const float2 g = rnd2<T>(__fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-s.x))),              // sigmoid
                             __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-s.y))));
    a[e] = __fmul_rn(t.x, g.x);                                                          // x * sigmoid
    a[e + 1] = __fmul_rn(t.y, g.y);
  }
  out[i] = store16<T>(a);
}

template <typename T, int MODE>
int launch_rows(int ng, const void* x, int x_stride, const void* y, const void* b, const float* m, const void* lw,
                const void* lb, void* x_out, void* ln_out, int rows, int D4, int L, float inv_d, float eps,
                cudaStream_t st) {
  const dim3 grid((rows + kWarps - 1) / kWarps), block(kWarps * 32);
  const auto* xt = static_cast<const T*>(x);
  const auto* yt = static_cast<const T*>(y);
  const auto* bt = static_cast<const T*>(b);
  const auto* w = static_cast<const T*>(lw);
  const auto* bi = static_cast<const T*>(lb);
  auto* xo = static_cast<T*>(x_out);
  auto* lo = static_cast<T*>(ln_out);
#define HGL_ROWS(NG) clip_glue_rows<T, NG, MODE><<<grid, block, 0, st>>>(xt, x_stride, yt, bt, m, w, bi, xo, lo, rows, D4, L, inv_d, eps)
  // the groups a lane holds, rounded up to an instantiated count: the extra ones are empty
  if (ng <= 1) HGL_ROWS(1);
  else if (ng <= 2) HGL_ROWS(2);
  else if (ng <= 4) HGL_ROWS(4);
  else if (ng <= 6) HGL_ROWS(6);
  else if (ng <= 8) HGL_ROWS(8);
  else return (int)cudaErrorInvalidValue;
#undef HGL_ROWS
  return cudaGetLastError();
}

template <typename T>
int rows_of(int mode, int ng, const void* x, int x_stride, const void* y, const void* b, const float* m,
            const void* lw, const void* lb, void* x_out, void* ln_out, int rows, int D4, int L, float inv_d, float eps,
            cudaStream_t st) {
  switch (mode) {
    case LN: return launch_rows<T, LN>(ng, x, x_stride, y, b, m, lw, lb, x_out, ln_out, rows, D4, L, inv_d, eps, st);
    case RESIDUAL: return launch_rows<T, RESIDUAL>(ng, x, x_stride, y, b, m, lw, lb, x_out, ln_out, rows, D4, L, inv_d, eps, st);
    case RES_LN: return launch_rows<T, RES_LN>(ng, x, x_stride, y, b, m, lw, lb, x_out, ln_out, rows, D4, L, inv_d, eps, st);
    case INJECT_LN: return launch_rows<T, INJECT_LN>(ng, x, x_stride, y, b, m, lw, lb, x_out, ln_out, rows, D4, L, inv_d, eps, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

unsigned blocks_for(size_t total) { return (unsigned)((total + kThreads - 1) / kThreads); }

}  // namespace

extern "C" {

// Every entry point: f32 = 1 for float32 tensors, 0 for bfloat16; pointers
// 16-byte aligned; D a multiple of 8. Returns a cudaError_t code.

// The row kernel (modes above). D up to 1024; x_stride (elements) a multiple
// of 4; y, x_out, ln_out [rows, D]; b, lw, lb [D], all of one dtype; m
// [rows / L, L - 1] f32 (INJECT_LN).
int hgl_clip_rows(int mode, int f32, const void* x, int x_stride, const void* y, const void* b, const float* m,
                  const void* lw, const void* lb, void* x_out, void* ln_out, int rows, int D, int L, float eps,
                  void* stream) {
  if (rows < 1 || D < 8 || D % 8 || D > 32 * kMaxGroups * 4 || x_stride % 4) return (int)cudaErrorInvalidValue;
  if (mode == INJECT_LN && (L < 2 || rows % L)) return (int)cudaErrorInvalidValue;
  const int D4 = D / 4, ng = (D4 + 31) / 32;
  const float inv_d = 1.0f / (float)D;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return f32 ? rows_of<float>(mode, ng, x, x_stride, y, b, m, lw, lb, x_out, ln_out, rows, D4, L, inv_d, eps, st)
             : rows_of<bf16>(mode, ng, x, x_stride, y, b, m, lw, lb, x_out, ln_out, rows, D4, L, inv_d, eps, st);
}

// y [N * L, 3 D], b [3 D] -> q, k, v [N * H, L, D / H]; D / H a multiple of 8.
int hgl_clip_qkv_heads(int f32, const void* y, const void* b, void* q, void* k, void* v, int N, int L, int D, int H,
                       void* stream) {
  if (N < 1 || L < 1 || H < 1 || D % H || (D / H) % 8) return (int)cudaErrorInvalidValue;
  const int per = f32 ? 4 : 8;
  const size_t total = (size_t)N * L * 3 * (D / per);
  const auto* yv = static_cast<const uint4*>(y);
  const auto* bv = static_cast<const uint4*>(b);
  auto *qv = static_cast<uint4*>(q), *kv = static_cast<uint4*>(k), *vv = static_cast<uint4*>(v);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (f32)
    clip_glue_qkv_heads<float><<<blocks_for(total), kThreads, 0, st>>>(yv, bv, qv, kv, vv, total, L, D / per, H, D / H / per);
  else
    clip_glue_qkv_heads<bf16><<<blocks_for(total), kThreads, 0, st>>>(yv, bv, qv, kv, vv, total, L, D / per, H, D / H / per);
  return cudaGetLastError();
}

// ctx [N * H, L, D / H] -> out [N, L, D]; D / H a multiple of 8.
int hgl_clip_merge_heads(int f32, const void* ctx, void* out, int N, int L, int D, int H, void* stream) {
  if (N < 1 || L < 1 || H < 1 || D % H || (D / H) % 8) return (int)cudaErrorInvalidValue;
  const int per = f32 ? 4 : 8;
  const size_t total = (size_t)N * L * (D / per);
  clip_glue_merge<<<blocks_for(total), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(ctx), static_cast<uint4*>(out), total, L, D / per, H, D / H / per);
  return cudaGetLastError();
}

// h [rows, F], b [F] -> QuickGELU(h + b) [rows, F].
int hgl_clip_bias_quick_gelu(int f32, const void* h, const void* b, void* out, int rows, int F, void* stream) {
  if (rows < 1 || F < 8 || F % 8) return (int)cudaErrorInvalidValue;
  const int per = f32 ? 4 : 8;
  const size_t total = (size_t)rows * (F / per);
  const auto* hv = static_cast<const uint4*>(h);
  const auto* bv = static_cast<const uint4*>(b);
  auto* ov = static_cast<uint4*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (f32)
    clip_glue_bias_gelu<float><<<blocks_for(total), kThreads, 0, st>>>(hv, bv, ov, total, F / per);
  else
    clip_glue_bias_gelu<bf16><<<blocks_for(total), kThreads, 0, st>>>(hv, bv, ov, total, F / per);
  return cudaGetLastError();
}

}  // extern "C"
