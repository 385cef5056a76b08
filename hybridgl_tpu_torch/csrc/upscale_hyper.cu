// The SAM mask decoder's upscale + hypernetwork tail, for sm_90a.
//
// Replaces hybridgl_tpu/kernels/upscale_hyper.py:upscale_hyper_blocked (K4)
// and its interleave. Per prompt b and pixel r of the g x g grid:
//   d[(i,j), :]      = src[r] @ w1 + b1                        C -> 4 x c4
//   h1               = round(gelu(LN_c4(d[(i,j), :])))          eps 1e-6
//   z[(i,j),(e,f),:] = h1[(i,j)] @ w2 + b2                     c4 -> 4 x c8
//   h2               = round(gelu(z))
//   mask[m][4h+2i+e][4w+2j+f] = h2[(i,j),(e,f)] . hyper[b, m]
// with operands rounded to the src dtype T, f32 sums, exact erf GELU.
//
// Design. A block of 256 threads owns one prompt and a contiguous split of
// 16-pixel tiles (grid nsplit x B). It stages w1 [C][4 c4] (128 KB in bf16
// at C = 256), w2 [c4][4 c8] and the prompt's hyper rows once in shared
// memory; per tile the src rows go to shared memory, the two deconvs run as
// shared-memory tile products with 4x4 register tiles, the LN is one warp
// per (pixel, i, j) group, and the mask values are written straight into the
// interleaved frame (neighbouring threads write neighbouring columns). The
// TPU kernel's layout devices (group-mean-centred w1, kron-expanded w2 and
// hyper, blocked output) are not needed: LN is computed directly.
//
// What bounds it: ~52 GFLOP per launch at B = 64 (src @ w1 is two thirds),
// f32 FMAs on the CUDA cores fed from shared memory; HBM traffic is src in
// (0.13 GB) and the masks out (0.05 GB). This kernel keeps f32 operands and
// every width the tensor-core kernel does not take; bf16 at SAM's widths
// (C = 256, c4 = 64, c8 = 32, m = 1 or 3) runs upscale_hyper_wgmma.cu.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "tile_common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int TP = 16;  // pixels per tile
constexpr float LN_EPS = 1e-6f;

__device__ __forceinline__ float gelu(float x) { return 0.5f * x * (1.f + erff(x * 0.70710678118654752f)); }

// Shared memory: SZ (src tile [TP][C+1], later z [4 TP][4 c8 + 1]), D
// [TP][4 c4 + 1], b1/ln_s/ln_b [c4], b2 [c8], H [m][c8] floats; then W1
// [C][4 c4] and W2 [c4][4 c8] in T.
struct Layout {
  int LS, LD, LZ, nSZ, n_float;
  __host__ __device__ Layout(int C, int c4, int c8, int m) {
    LS = C + 1;
    LD = 4 * c4 + 1;
    LZ = 4 * c8 + 1;
    nSZ = TP * LS > 4 * TP * LZ ? TP * LS : 4 * TP * LZ;
    n_float = nSZ + TP * LD + 3 * c4 + c8 + m * c8;
  }
  __host__ __device__ size_t bytes(int C, int c4, int c8, size_t tsize) const {
    return sizeof(float) * (size_t)n_float + tsize * (size_t)(C * 4 * c4 + c4 * 4 * c8);
  }
};

template <typename T>
__global__ void __launch_bounds__(THREADS)
upscale_hyper_kernel(const T* __restrict__ src, const float* __restrict__ w1,
                     const float* __restrict__ b1, const float* __restrict__ ln_s,
                     const float* __restrict__ ln_b, const float* __restrict__ w2,
                     const float* __restrict__ b2, const float* __restrict__ hyper,
                     float* __restrict__ out, int R, int g, int C, int c4, int c8, int m) {
  extern __shared__ float smem[];
  const Layout L(C, c4, c8, m);
  float* SZ = smem;
  float* D = SZ + L.nSZ;
  float* b1s = D + TP * L.LD;
  float* lns = b1s + c4;
  float* lnb = lns + c4;
  float* b2s = lnb + c4;
  float* H = b2s + c8;
  T* W1 = reinterpret_cast<T*>(H + m * c8);
  T* W2 = W1 + C * 4 * c4;

  const int b = blockIdx.y, tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int N1 = 4 * c4, N2 = 4 * c8, G4 = 4 * g;
  for (int i = tid; i < C * N1; i += THREADS) W1[i] = from_f32<T>(w1[i]);
  for (int i = tid; i < c4 * N2; i += THREADS) W2[i] = from_f32<T>(w2[i]);
  for (int i = tid; i < c4; i += THREADS) {
    b1s[i] = b1[i];
    lns[i] = ln_s[i];
    lnb[i] = ln_b[i];
  }
  for (int i = tid; i < c8; i += THREADS) b2s[i] = b2[i];
  for (int i = tid; i < m * c8; i += THREADS) H[i] = round_to<T>(hyper[(size_t)b * m * c8 + i]);

  const int ntiles = (R + TP - 1) / TP;
  const int per = (ntiles + gridDim.x - 1) / gridDim.x;
  const int t_end = min(ntiles, (int)(blockIdx.x + 1) * per);
  const T* src_b = src + (size_t)b * R * C;
  float* out_b = out + (size_t)b * m * G4 * G4;

  for (int tile = blockIdx.x * per; tile < t_end; ++tile) {
    const int p0 = tile * TP, np = min(TP, R - p0);
    __syncthreads();  // staging visible; the previous tile's reads are done
    for (int i = tid; i < TP * C; i += THREADS) {
      const int r = i / C, c = i % C;
      SZ[r * L.LS + c] = r < np ? to_f32(src_b[(size_t)(p0 + r) * C + c]) : 0.f;
    }
    __syncthreads();
    block_gemm(
        TP, N1, C, [&](int r, int k) { return SZ[r * L.LS + k]; },
        [&](int k, int n) { return to_f32(W1[k * N1 + n]); },
        [&](int r, int n, float v) { D[r * L.LD + n] = v + b1s[n % c4]; });
    __syncthreads();
    // LN over each (pixel, i, j) group of c4 channels, then GELU, rounded
    for (int grp = warp; grp < TP * 4; grp += THREADS / 32) {
      float* x = D + (grp / 4) * L.LD + (grp % 4) * c4;
      float s = 0.f;
      for (int c = lane; c < c4; c += 32) s += x[c];
      const float mu = warp_sum(s) / c4;
      float v = 0.f;
      for (int c = lane; c < c4; c += 32) v += (x[c] - mu) * (x[c] - mu);
      const float rstd = rsqrtf(warp_sum(v) / c4 + LN_EPS);
      for (int c = lane; c < c4; c += 32) x[c] = round_to<T>(gelu((x[c] - mu) * rstd * lns[c] + lnb[c]));
    }
    __syncthreads();
    // second deconv: rows (pixel, i, j), columns (e, f, c8)
    block_gemm(
        4 * TP, N2, c4, [&](int q, int k) { return D[(q / 4) * L.LD + (q % 4) * c4 + k]; },
        [&](int k, int n) { return to_f32(W2[k * N2 + n]); },
        [&](int q, int n, float v) { SZ[q * L.LZ + n] = round_to<T>(gelu(v + b2s[n % c8])); });
    __syncthreads();
    // hypernetwork contraction into the interleaved frame; the index runs
    // (mask, i, e, pixel, j, f) with f fastest
    for (int idx = tid; idx < m * 4 * TP * 4; idx += THREADS) {
      const int f = idx & 1, j = (idx >> 1) & 1, r = (idx >> 2) % TP;
      const int rest = (idx >> 2) / TP, e = rest & 1, i = (rest >> 1) & 1, mm = rest >> 2;
      if (r >= np) continue;
      const float* z = SZ + (r * 4 + i * 2 + j) * L.LZ + (e * 2 + f) * c8;
      const float* h = H + mm * c8;
      float y = 0.f;
      for (int c = 0; c < c8; ++c) y = fmaf(z[c], h[c], y);
      const int p = p0 + r, ph = p / g, pw = p % g;
      out_b[((size_t)mm * G4 + 4 * ph + 2 * i + e) * G4 + 4 * pw + 2 * j + f] = y;
    }
  }
}

template <typename T>
int launch(const void* src, const float* w1, const float* b1, const float* ln_s,
           const float* ln_b, const float* w2, const float* b2, const float* hyper, float* out,
           int B, int R, int g, int C, int c4, int c8, int m, int nsplit, cudaStream_t st) {
  const Layout L(C, c4, c8, m);
  const size_t bytes = L.bytes(C, c4, c8, sizeof(T));
  auto kern = upscale_hyper_kernel<T>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  kern<<<dim3(nsplit, B), THREADS, bytes, st>>>(static_cast<const T*>(src), w1, b1, ln_s, ln_b,
                                                w2, b2, hyper, out, R, g, C, c4, c8, m);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// upscale_hyper_wgmma.cu
int hgl_upscale_hyper_tc_takes(int C, int c4, int c8, int m, int is_bf16);
int hgl_upscale_hyper_tc(const void* src, const void* w1, const float* b1, const float* ln_s, const float* ln_b,
                         const void* w2, const float* b2, const void* hyper, float* out, int B, int R, int g, int m,
                         int blocks, void* stream);

// K4. src [B, g*g, C] (bf16 or f32), b1/ln_s/ln_b [c4], b2 [c8] f32 -> out
// [B, m, 4g, 4g] f32. With ``tc`` the call goes to the tensor-core kernel
// (the widths hgl_upscale_hyper_tc_takes accepts): w1 [C, 4 c4], w2 [c4, 4
// c8] and hyper [B, m, c8] are then bf16 and nsplit is the number of
// persistent blocks; otherwise they are f32 and nsplit the tile splits per
// prompt of the CUDA-core kernel.
int hgl_upscale_hyper(const void* src, const void* w1, const float* b1, const float* ln_s,
                      const float* ln_b, const void* w2, const float* b2, const void* hyper,
                      float* out, int B, int R, int g, int C, int c4, int c8, int m, int nsplit,
                      int is_bf16, int tc, void* stream) {
  if (B < 1 || g * g != R || nsplit < 1 || C < 1 || c4 < 1 || c8 < 1 || m < 1)
    return (int)cudaErrorInvalidValue;
  if (tc) {
    if (!hgl_upscale_hyper_tc_takes(C, c4, c8, m, is_bf16)) return (int)cudaErrorInvalidValue;
    return hgl_upscale_hyper_tc(src, w1, b1, ln_s, ln_b, w2, b2, hyper, out, B, R, g, m, nsplit, stream);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* w1f = static_cast<const float*>(w1);
  const float* w2f = static_cast<const float*>(w2);
  const float* hf = static_cast<const float*>(hyper);
  return is_bf16 ? launch<__nv_bfloat16>(src, w1f, b1, ln_s, ln_b, w2f, b2, hf, out, B, R, g, C, c4, c8, m,
                                         nsplit, st)
                 : launch<float>(src, w1f, b1, ln_s, ln_b, w2f, b2, hf, out, B, R, g, C, c4, c8, m, nsplit, st);
}

}  // extern "C"
