// The glue of the SAM ViT image encoder's block for sm_90a, on the CUDA cores, in bf16 or f32.
//
// Replaces no TPU kernel: in the JAX package XLA fuses the elementwise work
// around the encoder block's matrix products and K1/K2 by itself. In the port
// each of those PyTorch operations was a kernel of its own inside the
// captured proposal graph (the LayerNorm about eight f32 passes, the window
// pad and permutes, the bias adds, three head copies, the f32 rel-pos
// einsums, exact GELU over the 5,120-wide hidden state, two residuals):
// ~25-30 launches a block. Four kernels take their place
// (kernels/sam_glue.py wraps them):
//
//   sam_glue_rows       one warp a token row of D <= 1280 values, reading the
//                       residual stream x on the [N, H, W, D] token grid:
//                       out = LN(x), or x' = x + (y + b) (y the output of a
//                       matrix product, b its bias, read in the window layout
//                       of the block that made it) and optionally LN(x');
//                       the LayerNorm is written in the window layout of the
//                       block that reads it, pad rows zero (F.pad pads after
//                       the LayerNorm), or on the grid;
//   sam_glue_qkv_rel    y + b of the [B, S, 3D] qkv product as q, k, v in
//                       K1/K2's [B*H, S, hd] layout, and the two f32 rel-pos
//                       terms of the decomposed bias from the rounded q:
//                       rel_h[bh, (i, j), kh] = q . Rh[i, kh],
//                       rel_w[bh, (i, j), kw] = q . Rw[j, kw];
//   sam_glue_merge      K1/K2's [B*H, S, hd] output back to [B, S, D];
//   sam_glue_bias_gelu  exact GELU of h + b: x/2 (1 + erf(x / sqrt 2)).
//
// Exactness. Every elementwise step rounds to the activation dtype where the
// plain PyTorch sequence (kernels/sam_glue.py, reference_*) rounds, each in
// one IEEE f32 operation first (the _rn intrinsics keep nvcc from contracting
// a product and a sum into an FMA; erff is the accurate one PyTorch's GELU
// calls): the bias adds, residuals, window partition and unpartition, head
// split, merge and GELU equal the plain sequence bit for bit. The LayerNorm
// keeps its statistics, scale and bias in f32 as the plain version does and
// rounds once; its sums run in a warp's shuffle order, so an output may lie
// one rounding step from the plain one. The rel-pos dot products run in f32
// FMAs in their own order: f32 rounding apart from the plain einsums.
//
// What bounds them: bytes, except the rel-pos products. Each reads its inputs
// once and writes its outputs once, neighbouring threads on neighbouring
// 16-byte vectors; the row kernel holds a whole row in one warp's registers
// (D / 256 vectors of 8 bf16 a lane), so the two-pass mean and variance cost
// no second read of memory. The rel-pos terms are 2 G^3 hd multiply-adds a
// stream-head in f32 (ViT-H: ~15 GFLOP an image): a block stages one table
// row R[i] ([G, hd]) and the q rows of up to 128 tokens that share it in
// shared memory and computes 4 x 4 output tiles a thread, so each FMA costs
// half a shared-memory read.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kWarps = 4;           // rows a block of the row kernel
constexpr int kThreads = 256;       // threads a block of the elementwise kernels
constexpr int kRelThreads = 128;    // threads a block of the qkv / rel-pos kernel
constexpr int kRelTokens = 128;     // tokens a block of it stages, at most
constexpr int kSmemFloats = 12288;  // 48 KB of staged table and q rows
constexpr int kMaxGrid = 64;        // the grid side of a global block

// rounding to the activation dtype
template <typename T>
__device__ __forceinline__ float rnd(float v);
template <>
__device__ __forceinline__ float rnd<bf16>(float v) { return __bfloat162float(__float2bfloat16_rn(v)); }
template <>
__device__ __forceinline__ float rnd<float>(float v) { return v; }

template <typename T>
__host__ __device__ constexpr int per16() { return 16 / (int)sizeof(T); }  // values in 16 bytes

template <typename T>
__device__ __forceinline__ void load16(const uint4& u, float* f);
template <>
__device__ __forceinline__ void load16<bf16>(const uint4& u, float* f) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t = __bfloat1622float2(h[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}
template <>
__device__ __forceinline__ void load16<float>(const uint4& u, float* f) {
  f[0] = __uint_as_float(u.x); f[1] = __uint_as_float(u.y); f[2] = __uint_as_float(u.z); f[3] = __uint_as_float(u.w);
}

template <typename T>
__device__ __forceinline__ uint4 store16(const float* f);
template <>
__device__ __forceinline__ uint4 store16<bf16>(const float* f) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
  return u;
}
template <>
__device__ __forceinline__ uint4 store16<float>(const float* f) {
  return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]), __float_as_uint(f[2]), __float_as_uint(f[3]));
}

__device__ __forceinline__ float warp_sum(float s) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  return s;
}

// A layout of the token rows: the [N, H, W] grid itself (win 0), or windows of
// win x win over the grid zero-padded to nwh x nww windows (window_partition's
// [N * nwh * nww, win, win] order).
struct Layout {
  int win, nwh, nww;
};

__host__ __device__ __forceinline__ Layout layout_of(int win, int H, int W) {
  return win ? Layout{win, (H + win - 1) / win, (W + win - 1) / win} : Layout{0, 0, 0};
}

__device__ __forceinline__ size_t row_of(const Layout& l, int n, int gh, int gw, int H, int W) {
  if (!l.win) return ((size_t)n * H + gh) * W + gw;
  const int w = l.win;
  return ((((size_t)n * l.nwh + gh / w) * l.nww + gw / w) * w + gh % w) * w + gw % w;
}

__device__ __forceinline__ void position(const Layout& l, int row, int H, int W, int& n, int& gh, int& gw) {
  if (!l.win) {
    gw = row % W;
    gh = (row / W) % H;
    n = row / (W * H);
    return;
  }
  const int w = l.win, per = w * w, win = row / per, in = row - win * per;
  const int wx = win % l.nww, wy = (win / l.nww) % l.nwh;
  n = win / (l.nww * l.nwh);
  gh = wy * w + in / w;
  gw = wx * w + in % w;
}

// One warp a row of the output layout `ol` (Dv 16-byte vectors a row; lane l
// holds the vectors l, l + 32, ...). x, x_out: the [N, H, W, D] grid; y: the
// layout `yl`; b, lw, lb: [D].
template <typename T, int NV, bool HAS_Y, bool HAS_LN>
__global__ void __launch_bounds__(kWarps * 32)
sam_glue_rows(const T* __restrict__ x, const T* __restrict__ y, const T* __restrict__ b, const T* __restrict__ lw,
              const T* __restrict__ lb, T* __restrict__ x_out, T* __restrict__ ln_out, int H, int W, Layout yl,
              Layout ol, int rows, int Dv, float inv_d, float eps) {
  constexpr int P = per16<T>();
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= rows) return;
  int n, gh, gw;
  position(ol, row, H, W, n, gh, gw);
  if (gh >= H || gw >= W) {  // a pad row of the window layout
    uint4* o = reinterpret_cast<uint4*>(ln_out) + (size_t)row * Dv;
    for (int c = lane; c < Dv; c += 32) o[c] = make_uint4(0u, 0u, 0u, 0u);
    return;
  }
  const size_t g = ((size_t)n * H + gh) * W + gw;
  const uint4* xr = reinterpret_cast<const uint4*>(x) + g * Dv;
  const uint4* yr = HAS_Y ? reinterpret_cast<const uint4*>(y) + row_of(yl, n, gh, gw, H, W) * Dv : nullptr;
  float v[NV][P];
  float sum = 0.0f;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int c = lane + 32 * i;
#pragma unroll
    for (int e = 0; e < P; ++e) v[i][e] = 0.0f;
    if (c >= Dv) continue;
    load16<T>(xr[c], v[i]);
    if (HAS_Y) {
      float t[P], bb[P];
      load16<T>(yr[c], t);
      load16<T>(reinterpret_cast<const uint4*>(b)[c], bb);
#pragma unroll
      for (int e = 0; e < P; ++e) v[i][e] = rnd<T>(__fadd_rn(v[i][e], rnd<T>(__fadd_rn(t[e], bb[e]))));  // x + (y + b)
      reinterpret_cast<uint4*>(x_out)[g * Dv + c] = store16<T>(v[i]);
    }
#pragma unroll
    for (int e = 0; e < P; ++e) sum += v[i][e];
  }
  if (!HAS_LN) return;
  // the plain version's steps: mean, x - mean, mean of its squares, rsqrt(var + eps), scale, shift
  const float mu = __fmul_rn(warp_sum(sum), inv_d);
  float sq = 0.0f;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    if (lane + 32 * i >= Dv) continue;
#pragma unroll
    for (int e = 0; e < P; ++e) {
      v[i][e] = __fsub_rn(v[i][e], mu);
      sq = __fadd_rn(sq, __fmul_rn(v[i][e], v[i][e]));
    }
  }
  const float rstd = rsqrtf(__fadd_rn(__fmul_rn(warp_sum(sq), inv_d), eps));
  uint4* lr = reinterpret_cast<uint4*>(ln_out) + (size_t)row * Dv;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int c = lane + 32 * i;
    if (c >= Dv) continue;
    float w[P], bi[P];
    load16<T>(reinterpret_cast<const uint4*>(lw)[c], w);
    load16<T>(reinterpret_cast<const uint4*>(lb)[c], bi);
#pragma unroll
    for (int e = 0; e < P; ++e) v[i][e] = __fadd_rn(__fmul_rn(__fmul_rn(v[i][e], rstd), w[e]), bi[e]);
    lr[c] = store16<T>(v[i]);
  }
}

// y [B, S = G * G, 3D] + b [3D] -> q, k, v [B * H, S, hd] and rel_h, rel_w [B * H, S, G] (f32).
// A block takes one table row R = tab[line] ([G, hd]) and a chunk of nb stream-heads:
// kind 0 the tokens (line, j) of each (rel_h, and it writes their q, k and v),
// kind 1 the tokens (j, line) (rel_w). Blocks: kind-major, then line, then chunk.
template <typename T>
__global__ void __launch_bounds__(kRelThreads)
sam_glue_qkv_rel(const T* __restrict__ y, const T* __restrict__ b, const float* __restrict__ tab_h,
                 const float* __restrict__ tab_w, T* __restrict__ q, T* __restrict__ k, T* __restrict__ v,
                 float* __restrict__ rel_h, float* __restrict__ rel_w, int BH, int H, int G, int D, int hd, int nb,
                 int chunks) {
  constexpr int P = per16<T>();
  extern __shared__ float smem[];
  const int ld = hd + 1;  // odd: the rows of a tile fall in distinct banks
  float* R = smem;        // [G][ld]
  float* Q = smem + G * ld;  // [tokens][ld]
  const int chunk = blockIdx.x % chunks;
  const int line = (blockIdx.x / chunks) % G;
  const int kind = blockIdx.x / (chunks * G);
  const int bh0 = chunk * nb;
  const int tokens = min(nb, BH - bh0) * G;
  const int S = G * G, D3 = 3 * D, hv = hd / P;
  const float* tab = (kind == 0 ? tab_h : tab_w) + (size_t)line * G * hd;
  for (int i = threadIdx.x; i < G * hd; i += kRelThreads) R[(i / hd) * ld + i % hd] = tab[i];
  for (int i = threadIdx.x; i < tokens * hv; i += kRelThreads) {
    const int t = i / hv, c = (i - t * hv) * P;
    const int bh = bh0 + t / G, j = t % G;
    const int s = kind == 0 ? line * G + j : j * G + line;
    const int n = bh / H, col = (bh - n * H) * hd + c;
    const T* yr = y + ((size_t)n * S + s) * D3 + col;
    float a[P], bb[P];
    load16<T>(*reinterpret_cast<const uint4*>(yr), a);
    load16<T>(*reinterpret_cast<const uint4*>(b + col), bb);
#pragma unroll
    for (int e = 0; e < P; ++e) {
      a[e] = rnd<T>(__fadd_rn(a[e], bb[e]));  // q = y + b in the activation dtype
      Q[t * ld + c + e] = a[e];
    }
    if (kind == 0) {
      const size_t o = ((size_t)bh * S + s) * hd + c;
      *reinterpret_cast<uint4*>(q + o) = store16<T>(a);
#pragma unroll
      for (int part = 1; part < 3; ++part) {
        load16<T>(*reinterpret_cast<const uint4*>(yr + part * D), a);
        load16<T>(*reinterpret_cast<const uint4*>(b + part * D + col), bb);
#pragma unroll
        for (int e = 0; e < P; ++e) a[e] = __fadd_rn(a[e], bb[e]);
        *reinterpret_cast<uint4*>((part == 1 ? k : v) + o) = store16<T>(a);
      }
    }
  }
  __syncthreads();
  // 4 x 4 output tiles: tokens tg + TG a, keys kg + KG b (neighbouring lanes, neighbouring keys)
  const int TG = (tokens + 3) / 4, KG = (G + 3) / 4;
  float* rel = kind == 0 ? rel_h : rel_w;
  for (int task = threadIdx.x; task < TG * KG; task += kRelThreads) {
    const int tg = task / KG, kg = task - tg * KG;
    const float* qa[4];
    const float* rb[4];
#pragma unroll
    for (int a = 0; a < 4; ++a) qa[a] = Q + min(tg + TG * a, tokens - 1) * ld;
#pragma unroll
    for (int c = 0; c < 4; ++c) rb[c] = R + min(kg + KG * c, G - 1) * ld;
    float acc[4][4] = {};
    for (int e = 0; e < hd; ++e) {
      float qv[4], rv[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) qv[a] = qa[a][e];
#pragma unroll
      for (int c = 0; c < 4; ++c) rv[c] = rb[c][e];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[a][c] = fmaf(qv[a], rv[c], acc[a][c]);
    }
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int t = tg + TG * a;
      if (t >= tokens) continue;
      const int bh = bh0 + t / G, j = t % G;
      const int s = kind == 0 ? line * G + j : j * G + line;
      float* out = rel + ((size_t)bh * S + s) * G;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int key = kg + KG * c;
        if (key < G) out[key] = acc[a][c];
      }
    }
  }
}

// ctx [B*H, S, hdv vectors] -> out [B*S, Dv vectors]: a copy of 16-byte vectors, for either dtype
__global__ void __launch_bounds__(kThreads)
sam_glue_merge(const uint4* __restrict__ ctx, uint4* __restrict__ out, size_t total, int S, int Dv, int H, int hdv) {
  const size_t i = (size_t)blockIdx.x * kThreads + threadIdx.x;
  if (i >= total) return;
  const size_t t = i / Dv;
  const int c = (int)(i - t * Dv);
  const int h = c / hdv, j = c - h * hdv;
  const size_t n = t / S, s = t - n * S;
  out[i] = ctx[((n * H + h) * S + s) * hdv + j];
}

// h [rows, Fv vectors] + b [Fv] -> exact GELU, rounded where F.gelu on h + b rounds
template <typename T>
__global__ void __launch_bounds__(kThreads)
sam_glue_bias_gelu(const uint4* __restrict__ h, const uint4* __restrict__ b, uint4* __restrict__ out, size_t total,
                   int Fv) {
  constexpr int P = per16<T>();
  constexpr float kAlpha = 0.70710678118654752440f;  // M_SQRT1_2, as PyTorch's GELU kernel takes it
  const size_t i = (size_t)blockIdx.x * kThreads + threadIdx.x;
  if (i >= total) return;
  float a[P], bb[P];
  load16<T>(h[i], a);
  load16<T>(b[i % Fv], bb);
#pragma unroll
  for (int e = 0; e < P; ++e) {
    const float t = rnd<T>(__fadd_rn(a[e], bb[e]));                                  // h + b
    a[e] = __fmul_rn(__fmul_rn(t, 0.5f), __fadd_rn(1.0f, erff(__fmul_rn(t, kAlpha))));  // x * 0.5 * (1 + erf(x a))
  }
  out[i] = store16<T>(a);
}

template <typename T, bool HAS_Y, bool HAS_LN>
int launch_rows(int nv, const void* x, const void* y, const void* b, const void* lw, const void* lb, void* x_out,
                void* ln_out, int H, int W, Layout yl, Layout ol, int rows, int Dv, float inv_d, float eps,
                cudaStream_t st) {
  const dim3 grid((rows + kWarps - 1) / kWarps), block(kWarps * 32);
  const auto* xt = static_cast<const T*>(x);
  const auto* yt = static_cast<const T*>(y);
  const auto* bt = static_cast<const T*>(b);
  const auto* w = static_cast<const T*>(lw);
  const auto* bi = static_cast<const T*>(lb);
  auto* xo = static_cast<T*>(x_out);
  auto* lo = static_cast<T*>(ln_out);
#define HGL_SAM_ROWS(NV) \
  sam_glue_rows<T, NV, HAS_Y, HAS_LN><<<grid, block, 0, st>>>(xt, yt, bt, w, bi, xo, lo, H, W, yl, ol, rows, Dv, \
                                                               inv_d, eps)
  // the vectors a lane holds, rounded up to an instantiated count: the extra ones are empty
  if (nv <= 1) HGL_SAM_ROWS(1);
  else if (nv <= 2) HGL_SAM_ROWS(2);
  else if (nv <= 3) HGL_SAM_ROWS(3);
  else if (nv <= 4) HGL_SAM_ROWS(4);
  else if (nv <= 5) HGL_SAM_ROWS(5);
  else if (nv <= 6) HGL_SAM_ROWS(6);
  else if (nv <= 8) HGL_SAM_ROWS(8);
  else if (nv <= 10) HGL_SAM_ROWS(10);
  else return (int)cudaErrorInvalidValue;
#undef HGL_SAM_ROWS
  return cudaGetLastError();
}

template <typename T>
int rows_of(int nv, const void* x, const void* y, const void* b, const void* lw, const void* lb, void* x_out,
            void* ln_out, int H, int W, Layout yl, Layout ol, int rows, int Dv, float inv_d, float eps,
            cudaStream_t st) {
  if (y && ln_out)
    return launch_rows<T, true, true>(nv, x, y, b, lw, lb, x_out, ln_out, H, W, yl, ol, rows, Dv, inv_d, eps, st);
  if (y) return launch_rows<T, true, false>(nv, x, y, b, lw, lb, x_out, ln_out, H, W, yl, ol, rows, Dv, inv_d, eps, st);
  return launch_rows<T, false, true>(nv, x, y, b, lw, lb, x_out, ln_out, H, W, yl, ol, rows, Dv, inv_d, eps, st);
}

unsigned blocks_for(size_t total) { return (unsigned)((total + kThreads - 1) / kThreads); }

}  // namespace

extern "C" {

// Every entry point: f32 = 1 for float32 tensors, 0 for bfloat16; pointers
// 16-byte aligned; widths a multiple of 8. Returns a cudaError_t code.

// The row kernel. x [N, H, W, D]; D up to 1280. With y (and b): x_out = x + (y + b)
// on the grid, y read in the layout of windows of y_win (0: the grid). With
// ln_out (and lw, lb): its LayerNorm (of x where y is null) written in the
// layout of windows of out_win, pad rows zero (out_win 0: the grid; without
// ln_out, out_win must be 0).
int hgl_sam_rows(int f32, const void* x, const void* y, const void* b, const void* lw, const void* lb, void* x_out,
                 void* ln_out, int N, int H, int W, int D, int y_win, int out_win, float eps, void* stream) {
  const int per = f32 ? 4 : 8;
  if (N < 1 || H < 1 || W < 1 || D < 8 || D % 8 || D > 1280 || y_win < 0 || out_win < 0)
    return (int)cudaErrorInvalidValue;
  if ((!y && !ln_out) || (!ln_out && out_win)) return (int)cudaErrorInvalidValue;
  const Layout yl = layout_of(y_win, H, W), ol = layout_of(out_win, H, W);
  const size_t rows = ol.win ? (size_t)N * ol.nwh * ol.nww * out_win * out_win : (size_t)N * H * W;
  if (rows > (size_t)INT32_MAX / kWarps) return (int)cudaErrorInvalidValue;
  const int Dv = D / per, nv = (Dv + 31) / 32;
  const float inv_d = 1.0f / (float)D;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return f32 ? rows_of<float>(nv, x, y, b, lw, lb, x_out, ln_out, H, W, yl, ol, (int)rows, Dv, inv_d, eps, st)
             : rows_of<bf16>(nv, x, y, b, lw, lb, x_out, ln_out, H, W, yl, ol, (int)rows, Dv, inv_d, eps, st);
}

// y [B, G * G, 3D], b [3D], tab_h / tab_w [G, G, D / H] f32 -> q, k, v [B * H, G * G, D / H],
// rel_h / rel_w [B * H, G * G, G] f32; D / H a multiple of 8, G <= 64, and a
// table row beside a row of tokens in 48 KB: 2 G (D / H + 1) <= 12288 floats.
int hgl_sam_qkv_rel(int f32, const void* y, const void* b, const float* tab_h, const float* tab_w, void* q, void* k,
                    void* v, float* rel_h, float* rel_w, int B, int G, int D, int H, void* stream) {
  if (B < 1 || G < 1 || G > kMaxGrid || H < 1 || D % H || (D / H) % 8) return (int)cudaErrorInvalidValue;
  const int hd = D / H, ld = hd + 1, BH = B * H;
  const int fit = kSmemFloats / ld - G;  // token rows beside the table row
  if (fit < G) return (int)cudaErrorInvalidValue;
  int nb = kRelTokens / G < fit / G ? kRelTokens / G : fit / G;
  nb = nb < 1 ? 1 : (nb > BH ? BH : nb);
  const int chunks = (BH + nb - 1) / nb;
  const size_t smem = (size_t)(G + nb * G) * ld * sizeof(float);
  const dim3 grid(2 * G * chunks);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (f32)
    sam_glue_qkv_rel<float><<<grid, kRelThreads, smem, st>>>(
        static_cast<const float*>(y), static_cast<const float*>(b), tab_h, tab_w, static_cast<float*>(q),
        static_cast<float*>(k), static_cast<float*>(v), rel_h, rel_w, BH, H, G, D, hd, nb, chunks);
  else
    sam_glue_qkv_rel<bf16><<<grid, kRelThreads, smem, st>>>(
        static_cast<const bf16*>(y), static_cast<const bf16*>(b), tab_h, tab_w, static_cast<bf16*>(q),
        static_cast<bf16*>(k), static_cast<bf16*>(v), rel_h, rel_w, BH, H, G, D, hd, nb, chunks);
  return cudaGetLastError();
}

// ctx [B * H, S, D / H] -> out [B, S, D]; D / H a multiple of 8.
int hgl_sam_merge_heads(int f32, const void* ctx, void* out, int B, int S, int D, int H, void* stream) {
  if (B < 1 || S < 1 || H < 1 || D % H || (D / H) % 8) return (int)cudaErrorInvalidValue;
  const int per = f32 ? 4 : 8;
  const size_t total = (size_t)B * S * (D / per);
  sam_glue_merge<<<blocks_for(total), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(ctx), static_cast<uint4*>(out), total, S, D / per, H, D / H / per);
  return cudaGetLastError();
}

// h [rows, F], b [F] -> GELU(h + b) [rows, F].
int hgl_sam_bias_gelu(int f32, const void* h, const void* b, void* out, int rows, int F, void* stream) {
  if (rows < 1 || F < 8 || F % 8) return (int)cudaErrorInvalidValue;
  const int per = f32 ? 4 : 8;
  const size_t total = (size_t)rows * (F / per);
  const auto* hv = static_cast<const uint4*>(h);
  const auto* bv = static_cast<const uint4*>(b);
  auto* ov = static_cast<uint4*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (f32)
    sam_glue_bias_gelu<float><<<blocks_for(total), kThreads, 0, st>>>(hv, bv, ov, total, F / per);
  else
    sam_glue_bias_gelu<bf16><<<blocks_for(total), kThreads, 0, st>>>(hv, bv, ov, total, F / per);
  return cudaGetLastError();
}

}  // extern "C"
