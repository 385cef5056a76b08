// Device helpers shared by the decoder kernels (decoder_attn.cu, upscale_hyper.cu):
// dtype conversion and rounding, a warp sum, and a shared-memory tile product.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}
// x rounded to T and widened back: where the reference rounds to the stream dtype
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f32(from_f32<T>(x));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// out(m, n, sum_k a(m, k) * b(k, n)) for an M x N product (M, N multiples of
// 4) whose operands the accessors read from shared memory. Each task is a
// 4x4 register tile over rows mi + MT*i and columns ni + NT*j, so
// neighbouring lanes read neighbouring columns of b; f32 sums.
template <typename FA, typename FB, typename FO>
__device__ __forceinline__ void block_gemm(int M, int N, int K, FA a, FB b, FO out) {
  const int MT = M / 4, NT = N / 4;
  for (int t = threadIdx.x; t < MT * NT; t += blockDim.x) {
    const int mi = t / NT, ni = t % NT;
    float acc[4][4] = {};
    for (int k = 0; k < K; ++k) {
      float av[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = a(mi + MT * i, k);
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = b(k, ni + NT * j);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) out(mi + MT * i, ni + NT * j, acc[i][j]);
  }
}

}  // namespace
