// The SAM decoder's cross attentions over the per-prompt image stream, for sm_90a.
//
// One kernel, three modes, replacing three Pallas kernels of the JAX package:
//   I2T  (K7) hybridgl_tpu/kernels/decoder_attn.py:i2t_ln_update
//        keys'[q] = LN(base[q] + softmax_group(qside[q] . w + off) @ vo + const)
//   T2I  (K8) hybridgl_tpu/kernels/decoder_attn_t2i.py:t2i_ctx
//        ctx = softmax_k((keys + pe) . qw) @ keys, online over the rows k
//   PASS (K3) hybridgl_tpu/kernels/decoder_pass.py:i2t_ln_then_t2i
//        I2T, then the next T2I fed from the keys' tile in shared memory
// Per prompt the image side is S = 4096 rows of C = 256 channels; the token
// side (w [Cq, GT], vo [GT, C], qw [C, GT2], GT = heads * tp = 64) is tiny.
//
// Design. A block of 256 threads owns one prompt b and a contiguous split of
// the rows (grid B x nsplit, about two blocks per SM). It stages that
// prompt's token-side operands once in shared memory, rounded to the stream
// dtype T, then walks 32-row tiles through two device steps:
//   i2t_ln_tile  score-side rows (+ pe) -> scores (+ off) -> grouped softmax
//                over each head's tp lanes -> @ vo + base + const -> row LN;
//   t2i_update   kpe = keys' + pe -> scores -> running (m, l) per column ->
//                acc[GT2, C] = alpha * acc + p^T keys', acc in registers.
// Every product is a shared-memory tile product with 4x4 register tiles and
// f32 sums (block_gemm). T2I and PASS write each split's (m, l, acc); a
// second small kernel merges the splits into ctx. Broadcast operands
// ([1, S, .]) are read through a zero batch stride, never materialised.
//
// Roundings follow the reference kernels: w and qw to T before their
// products, attn to T before @ vo, keys' to T, kpe to T, p to T before
// p^T keys' (l sums the unrounded p). Padding lanes carry off = -1e30, so
// their exp is 0; m starts at -1e30 and l is clamped at 1e-30.
//
// What bounds it: ~34 GFLOP per pass at B = 64 in f32 FMAs on the CUDA
// cores, issued from shared memory (two loads per four FMAs); the image
// stream itself (~0.5 GB per pass) is far from the memory roofline. Moving
// the four tile products onto wgmma is the next step for speed.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "tile_common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int TR = 32;       // image rows per tile
constexpr int MAX_ACC = 4;   // 4x4 context tiles per thread: GT2 * C <= 16384
constexpr float NEG_BIG = -1e30f;
constexpr float LN_EPS = 1e-5f;

enum { I2T = 0, T2I = 1, PASS = 2 };

struct Params {
  const void* qside;  // [1|B, S, Cq] T   (T2I: the keys [B, S, C])
  const void* base;   // [1|B, S, C] T    (I2T/PASS residual base)
  const void* pe;     // [1|B, S, C] T    (or null in I2T without pe)
  const float* w;     // [B, Cq, GT]
  const float* off;   // [B, GT]
  const void* vo;     // [B, GT, C] T
  const float* cnst;  // [C]
  const float* ln_s;  // [C]
  const float* ln_b;  // [C]
  const float* qw;    // [B, C, GT2]
  void* keys_out;     // [B, S, C] T
  float* part_m;      // [B, nsplit, GT2]
  float* part_l;      // [B, nsplit, GT2]
  float* part_acc;    // [B, nsplit, GT2, C]
  int B, S, Cq, C, heads, tp, GT2, nsplit;
  int q_bcast, base_bcast, pe_bcast, add_pe;
};

// Shared memory, in this order: QK [TR][LQ], X [TR][LX], SS [TR][LS] floats;
// off [GT], const/ln_s/ln_b [C], m/l/alpha [GT2] floats; then Ws [Cq][GT],
// Vs [GT][C], QWs [C][GT2] in T. Odd float strides keep column reads of one
// row-tile conflict-free.
struct Layout {
  int LQ, LX, LS, n_float, nW, nV, nQW;
  __host__ __device__ Layout(int mode, int Cq, int C, int GT, int GT2) {
    LQ = (Cq > C ? Cq : C) + 1;
    LX = C + 1;
    LS = (GT > GT2 ? GT : GT2) + 1;
    n_float = TR * (LQ + LX + LS) + GT + 3 * C + 3 * GT2;
    nW = mode != T2I ? Cq * GT : 0;
    nV = mode != T2I ? GT * C : 0;
    nQW = mode != I2T ? C * GT2 : 0;
  }
  __host__ __device__ size_t bytes(size_t tsize) const {
    return sizeof(float) * (size_t)n_float + tsize * (size_t)(nW + nV + nQW);
  }
};

template <typename T, int MODE>
__global__ void __launch_bounds__(THREADS) decoder_attn_kernel(Params p) {
  extern __shared__ float smem[];
  const int C = p.C, Cq = p.Cq, GT = p.heads * p.tp, GT2 = p.GT2, S = p.S;
  const Layout L(MODE, Cq, C, GT, GT2);
  float* QK = smem;
  float* X = QK + TR * L.LQ;
  float* SS = X + TR * L.LX;
  float* offs = SS + TR * L.LS;
  float* cnst = offs + GT;
  float* lns = cnst + C;
  float* lnb = lns + C;
  float* m_run = lnb + C;
  float* l_run = m_run + GT2;
  float* alpha = l_run + GT2;
  T* Ws = reinterpret_cast<T*>(alpha + GT2);
  T* Vs = Ws + L.nW;
  T* QWs = Vs + L.nV;

  const int b = blockIdx.x, split = blockIdx.y, tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const T* qside = static_cast<const T*>(p.qside) + (p.q_bcast ? 0 : (size_t)b * S * Cq);
  const T* base = static_cast<const T*>(p.base) + (p.base_bcast ? 0 : (size_t)b * S * C);
  const T* pe = static_cast<const T*>(p.pe) + (p.pe_bcast ? 0 : (size_t)b * S * C);
  T* keys_out = static_cast<T*>(p.keys_out) + (size_t)b * S * C;

  if (MODE != T2I) {
    const float* wb = p.w + (size_t)b * Cq * GT;
    const T* vob = static_cast<const T*>(p.vo) + (size_t)b * GT * C;
    for (int i = tid; i < Cq * GT; i += THREADS) Ws[i] = from_f32<T>(wb[i]);
    for (int i = tid; i < GT * C; i += THREADS) Vs[i] = vob[i];
    for (int i = tid; i < GT; i += THREADS) offs[i] = p.off[(size_t)b * GT + i];
    for (int i = tid; i < C; i += THREADS) {
      cnst[i] = p.cnst[i];
      lns[i] = p.ln_s[i];
      lnb[i] = p.ln_b[i];
    }
  }
  if (MODE != I2T) {
    const float* qwb = p.qw + (size_t)b * C * GT2;
    for (int i = tid; i < C * GT2; i += THREADS) QWs[i] = from_f32<T>(qwb[i]);
    for (int i = tid; i < GT2; i += THREADS) {
      m_run[i] = NEG_BIG;
      l_run[i] = 0.f;
    }
  }
  float acc[MAX_ACC][4][4];
#pragma unroll
  for (int q = 0; q < MAX_ACC; ++q)
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[q][i][j] = 0.f;

  const int ntiles = (S + TR - 1) / TR;
  const int per = (ntiles + p.nsplit - 1) / p.nsplit;
  const int t_end = min(ntiles, (split + 1) * per);

  for (int tile = split * per; tile < t_end; ++tile) {
    const int r0 = tile * TR, nr = min(TR, S - r0);
    __syncthreads();  // the previous tile's reads are done; staging is visible
    if (MODE != T2I) {
      // ---- i2t_ln_tile: score-side rows, pe added on the fly
      for (int i = tid; i < TR * Cq; i += THREADS) {
        const int r = i / Cq, c = i % Cq;
        float v = 0.f;
        if (r < nr) {
          const size_t row = (size_t)(r0 + r);
          v = to_f32(qside[row * Cq + c]);
          if (p.add_pe) v = round_to<T>(v + to_f32(pe[row * C + c]));
        }
        QK[r * L.LQ + c] = v;
      }
      __syncthreads();
      block_gemm(
          TR, GT, Cq, [&](int m, int k) { return QK[m * L.LQ + k]; },
          [&](int k, int n) { return to_f32(Ws[k * GT + n]); },
          [&](int m, int n, float v) { SS[m * L.LS + n] = v + offs[n]; });
      __syncthreads();
      // softmax over each head's tp lanes, rounded to T
      for (int i = tid; i < TR * p.heads; i += THREADS) {
        float* s = SS + (i / p.heads) * L.LS + (i % p.heads) * p.tp;
        float mx = s[0];
        for (int t = 1; t < p.tp; ++t) mx = fmaxf(mx, s[t]);
        float d = 0.f;
        for (int t = 0; t < p.tp; ++t) {
          s[t] = expf(s[t] - mx);
          d += s[t];
        }
        const float inv = 1.f / fmaxf(d, 1e-30f);
        for (int t = 0; t < p.tp; ++t) s[t] = round_to<T>(s[t] * inv);
      }
      __syncthreads();
      block_gemm(
          TR, C, GT, [&](int m, int k) { return SS[m * L.LS + k]; },
          [&](int k, int n) { return to_f32(Vs[k * C + n]); },
          [&](int m, int n, float v) {
            const float bv = m < nr ? to_f32(base[(size_t)(r0 + m) * C + n]) : 0.f;
            X[m * L.LX + n] = bv + v + cnst[n];
          });
      __syncthreads();
      // row LayerNorm, one warp per row; keys' rounded to T stays in X
      for (int r = warp; r < TR; r += THREADS / 32) {
        float* x = X + r * L.LX;
        float s = 0.f;
        for (int c = lane; c < C; c += 32) s += x[c];
        const float mu = warp_sum(s) / C;
        float v = 0.f;
        for (int c = lane; c < C; c += 32) v += (x[c] - mu) * (x[c] - mu);
        const float rstd = rsqrtf(warp_sum(v) / C + LN_EPS);
        for (int c = lane; c < C; c += 32) {
          const T y = from_f32<T>((x[c] - mu) * rstd * lns[c] + lnb[c]);
          x[c] = to_f32(y);
          if (r < nr) keys_out[(size_t)(r0 + r) * C + c] = y;
        }
      }
    } else {
      for (int i = tid; i < TR * C; i += THREADS) {
        const int r = i / C, c = i % C;
        X[r * L.LX + c] = r < nr ? to_f32(qside[(size_t)(r0 + r) * C + c]) : 0.f;
      }
    }
    if (MODE == I2T) continue;

    // ---- t2i_update: kpe = keys' + pe, column online softmax, p^T keys'
    __syncthreads();
    for (int i = tid; i < TR * C; i += THREADS) {
      const int r = i / C, c = i % C;
      QK[r * L.LQ + c] =
          r < nr ? round_to<T>(X[r * L.LX + c] + to_f32(pe[(size_t)(r0 + r) * C + c])) : 0.f;
    }
    __syncthreads();
    block_gemm(
        TR, GT2, C, [&](int m, int k) { return QK[m * L.LQ + k]; },
        [&](int k, int n) { return to_f32(QWs[k * GT2 + n]); },
        [&](int m, int n, float v) { SS[m * L.LS + n] = v; });
    __syncthreads();
    for (int g = tid; g < GT2; g += THREADS) {
      float tmax = NEG_BIG;
      for (int r = 0; r < nr; ++r) tmax = fmaxf(tmax, SS[r * L.LS + g]);
      const float m_new = fmaxf(m_run[g], tmax);
      float lsum = 0.f;
      for (int r = 0; r < TR; ++r) {
        float pv = 0.f;
        if (r < nr) {
          pv = expf(SS[r * L.LS + g] - m_new);
          lsum += pv;
        }
        SS[r * L.LS + g] = round_to<T>(pv);
      }
      const float a = expf(m_run[g] - m_new);
      l_run[g] = l_run[g] * a + lsum;
      m_run[g] = m_new;
      alpha[g] = a;
    }
    __syncthreads();
    {
      const int MT = GT2 / 4, NT = C / 4;
#pragma unroll
      for (int q = 0; q < MAX_ACC; ++q) {
        const int t = tid + q * THREADS;
        if (t < MT * NT) {
          const int mi = t / NT, ni = t % NT;
          float part[4][4] = {};
          for (int k = 0; k < TR; ++k) {
            float av[4], bv[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) av[i] = SS[k * L.LS + mi + MT * i];
#pragma unroll
            for (int j = 0; j < 4; ++j) bv[j] = X[k * L.LX + ni + NT * j];
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
              for (int j = 0; j < 4; ++j) part[i][j] = fmaf(av[i], bv[j], part[i][j]);
          }
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float a = alpha[mi + MT * i];
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[q][i][j] = acc[q][i][j] * a + part[i][j];
          }
        }
      }
    }
  }

  if (MODE == I2T) return;
  __syncthreads();
  const size_t pb = (size_t)b * p.nsplit + split;
  for (int g = tid; g < GT2; g += THREADS) {
    p.part_m[pb * GT2 + g] = m_run[g];
    p.part_l[pb * GT2 + g] = l_run[g];
  }
  const int MT = GT2 / 4, NT = C / 4;
#pragma unroll
  for (int q = 0; q < MAX_ACC; ++q) {
    const int t = tid + q * THREADS;
    if (t < MT * NT) {
      const int mi = t / NT, ni = t % NT;
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          p.part_acc[(pb * GT2 + mi + MT * i) * C + ni + NT * j] = acc[q][i][j];
    }
  }
}

// ctx[b, g, :] = sum_s e_s acc_s[g, :] / max(sum_s e_s l_s[g], 1e-30),
// e_s = exp(m_s[g] - max_s m_s[g]).
__global__ void t2i_combine(const float* __restrict__ pm, const float* __restrict__ pl,
                            const float* __restrict__ pacc, float* __restrict__ ctx, int nsplit,
                            int GT2, int C) {
  const size_t b = blockIdx.x;
  for (int i = threadIdx.x; i < GT2 * C; i += blockDim.x) {
    const int g = i / C, c = i % C;
    float M = NEG_BIG;
    for (int s = 0; s < nsplit; ++s) M = fmaxf(M, pm[(b * nsplit + s) * GT2 + g]);
    float num = 0.f, den = 0.f;
    for (int s = 0; s < nsplit; ++s) {
      const size_t o = (b * nsplit + s) * GT2 + g;
      const float e = expf(pm[o] - M);
      den += e * pl[o];
      num += e * pacc[o * C + c];
    }
    ctx[(b * GT2 + g) * C + c] = num / fmaxf(den, 1e-30f);
  }
}

template <typename T, int MODE>
int launch(const Params& p, float* ctx, cudaStream_t st) {
  const Layout L(MODE, p.Cq, p.C, p.heads * p.tp, p.GT2);
  const size_t bytes = L.bytes(sizeof(T));
  auto kern = decoder_attn_kernel<T, MODE>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  kern<<<dim3(p.B, p.nsplit), THREADS, bytes, st>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess || MODE == I2T) return (int)err;
  t2i_combine<<<p.B, THREADS, 0, st>>>(p.part_m, p.part_l, p.part_acc, ctx, p.nsplit, p.GT2, p.C);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_mode(int mode, const Params& p, float* ctx, cudaStream_t st) {
  switch (mode) {
    case I2T: return launch<T, I2T>(p, ctx, st);
    case T2I: return launch<T, T2I>(p, ctx, st);
    case PASS: return launch<T, PASS>(p, ctx, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// K3 / K7 / K8 (mode PASS / I2T / T2I). Pointers a mode does not read may be
// null. Returns a cudaError_t code (0 = launched).
int hgl_decoder_attn(int mode, const void* qside, const void* base, const void* pe,
                     const float* w, const float* off, const void* vo, const float* cnst,
                     const float* ln_s, const float* ln_b, const float* qw, void* keys_out,
                     float* part_m, float* part_l, float* part_acc, float* ctx, int B, int S,
                     int Cq, int C, int heads, int tp, int GT2, int nsplit, int q_bcast,
                     int base_bcast, int pe_bcast, int add_pe, int is_bf16, void* stream) {
  const int GT = heads * tp;
  if (B < 1 || S < 1 || nsplit < 1 || tp < 1 || tp > 32 || GT % 4 || C % 4 || GT2 % 4 ||
      GT2 * C > MAX_ACC * THREADS * 16 || (add_pe && Cq != C))
    return (int)cudaErrorInvalidValue;
  Params p{qside, base,   pe,     w,      off,    vo,     cnst,   ln_s,     ln_b,
           qw,    keys_out, part_m, part_l, part_acc, B,  S,      Cq,       C,
           heads, tp,     GT2,    nsplit, q_bcast, base_bcast, pe_bcast, add_pe};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_bf16 ? dispatch_mode<__nv_bfloat16>(mode, p, ctx, st)
                 : dispatch_mode<float>(mode, p, ctx, st);
}

}  // extern "C"
