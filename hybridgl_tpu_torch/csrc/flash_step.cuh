// The inner step of the tensor-core attention kernels (attention_wgmma.cu's K1, K2, K6 and
// gem_attention.cu's GEM kernel), for sm_90a: a warpgroup owns 64 query rows, holds them as the
// A fragments of Q K^T in registers, and runs Q K^T and P V on wgmma against 64-key tiles in
// shared memory (wgmma_common.cuh's layout); the mbarriers that hand tiles from a producer warp
// to the consumers.

#pragma once

#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "wgmma_common.cuh"

namespace {

// d[64 x 80] (+)= a[64 x 16] (registers) * B (shared memory, by descriptor)
template <int TRANS_B>
__device__ __forceinline__ void wgmma_n80(float (&d)[40], const uint32_t (&a)[4], uint64_t desc, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %45, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39}, "
      "{%40, %41, %42, %43}, %44, p, 1, 1, %46;\n}\n"
      : D8(d, 0), D8(d, 8), D8(d, 16), D8(d, 24), D8(d, 32)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(accumulate), "n"(TRANS_B));
}

template <int HD>
__device__ __forceinline__ void wgmma_pv(float (&o)[HD / 2], const uint32_t (&a)[4], uint64_t desc) {
  if constexpr (HD == 80) {
    wgmma_n80<1>(o, a, desc, 1);
  } else {
    wgmma_n64<1>(o, a, desc, 1);
  }
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\nselp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// This thread's A fragments of 64 query rows: q * scale rounded to bf16.
// row0 / row1 are the two rows it owns (null where the row does not exist).
template <int HD>
__device__ __forceinline__ void load_q_fragments(uint32_t (&qa)[HD / 16][4], const __nv_bfloat16* row0,
                                                 const __nv_bfloat16* row1, int col, float scale) {
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const __nv_bfloat16* row = r ? row1 : row0;
        uint32_t packed = 0;
        if (row != nullptr) {
          const __nv_bfloat162 x = *reinterpret_cast<const __nv_bfloat162*>(row + kk * 16 + h * 8 + col);
          packed = pack_bf16(__bfloat162float(x.x) * scale, __bfloat162float(x.y) * scale);
        }
        qa[kk][h * 2 + r] = packed;
      }
}

// Running softmax state of the two rows a thread owns.
struct RowState {
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
};

// s = Q K^T for one 64-key tile at shared address ktile.
template <int HD>
__device__ __forceinline__ void scores(float (&s)[32], const uint32_t (&qa)[HD / 16][4], uint32_t ktile) {
  const uint64_t kdesc = make_desc(ktile, 128, HD * 16);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) wgmma_n64<0>(s, qa[kk], kdesc + (uint64_t)(kk * 256 >> 4), kk > 0);
  wgmma_commit();
  wgmma_wait0();
  pin(s);
}

// o += P V over the first ksteps 16-key steps of the tile at shared address vtile.
template <int HD>
__device__ __forceinline__ void accumulate_pv(float (&o)[HD / 2], uint32_t (&pa)[4][4], uint32_t vtile, int ksteps) {
  const uint64_t vdesc = make_desc(vtile, HD * 16, 128);
  pin(o);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    if (kk < ksteps) wgmma_pv<HD>(o, pa[kk], vdesc + (uint64_t)(kk * 2 * HD * 16 >> 4));
  wgmma_commit();
  wgmma_wait0();
  pin(o);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) pin(pa[kk]);
}

}  // namespace
