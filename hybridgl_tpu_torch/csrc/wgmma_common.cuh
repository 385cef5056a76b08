// PTX helpers shared by the tensor-core kernels (attention_wgmma.cu,
// decoder_attn_wgmma.cu, upscale_hyper_wgmma.cu), for sm_90a: wgmma with its
// shared-memory descriptors, cp.async, the proxy fence, bf16 packing, and the
// no-swizzle tile layout all three use.
//
// Tile layout. A [rows][W] bf16 tile (W a multiple of 8) is stored as 8-row x
// 16-byte core matrices: element (r, 8-column chunk c) sits at byte
//   (r / 8) * (W * 16) + c * 128 + (r % 8) * 16.
// wgmma reads it through a descriptor whose leading offset is the stride
// between core matrices along the product's K dimension and whose stride
// offset is the stride along M or N:
//   rows are M or N, columns K (K-major):   make_desc(tile, 128, W * 16),
//                                           16 K-columns further = +256 bytes
//   rows are K, columns N (MN-major, the    make_desc(tile, W * 16, 128),
//   transposed form):                       16 K-rows further = +2 * W * 16
// so one set of bytes serves a product that contracts over the columns and
// one that contracts over the rows. The 16-byte units of a tile are
// consecutive in shared memory (unit u = (r / 8) * W + c * 8 + r % 8), so a
// linear fill is conflict-free.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 64-bit wgmma shared-memory descriptor, no swizzle (layout type 0).
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo_bytes, uint32_t sbo_bytes) {
  return (uint64_t)((addr & 0x3FFFFu) >> 4) | ((uint64_t)(lbo_bytes >> 4) << 16) |
         ((uint64_t)(sbo_bytes >> 4) << 32);
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_wait0() { asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory"); }

// keep the compiler from moving uses of async-written or async-read registers
template <int N>
__device__ __forceinline__ void pin(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void pin(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

#define D8(r, b) "+f"(r[b]), "+f"(r[b + 1]), "+f"(r[b + 2]), "+f"(r[b + 3]), "+f"(r[b + 4]), "+f"(r[b + 5]), "+f"(r[b + 6]), "+f"(r[b + 7])

// d[64 x 64] (+)= a[64 x 16] (registers) * B (shared memory, by descriptor)
template <int TRANS_B>
__device__ __forceinline__ void wgmma_n64(float (&d)[32], const uint32_t (&a)[4], uint64_t desc, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : D8(d, 0), D8(d, 8), D8(d, 16), D8(d, 24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(accumulate), "n"(TRANS_B));
}

// d[64 x 64] (+)= A (shared memory, K-major) * B (shared memory), both by descriptor
template <int TRANS_B>
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t adesc, uint64_t bdesc, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, %35;\n}\n"
      : D8(d, 0), D8(d, 8), D8(d, 16), D8(d, 24)
      : "l"(adesc), "l"(bdesc), "r"(accumulate), "n"(TRANS_B));
}

// d[64 x 128] (+)= a[64 x 16] (registers) * B (shared memory, by descriptor)
template <int TRANS_B>
__device__ __forceinline__ void wgmma_n128(float (&d)[64], const uint32_t (&a)[4], uint64_t desc, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
      : D8(d, 0), D8(d, 8), D8(d, 16), D8(d, 24), D8(d, 32), D8(d, 40), D8(d, 48), D8(d, 56)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(accumulate), "n"(TRANS_B));
}

// 16 bytes, src_bytes of them read and the rest zero-filled. Through L1
// (.ca): a warp-wide copy reads 8 rows x 64 bytes, and the other half of each
// 128-byte line is the next copy's; measured 1.4x faster than .cg on the
// rel-pos stream kernel.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(src_bytes) : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// generic-proxy writes (cp.async, st.shared) before async-proxy reads (wgmma)
__device__ __forceinline__ void fence_async_proxy() { asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory"); }

// 2^x on the special-function unit, without exp2f's denormal handling: the
// values are rounded to bf16 next
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 t = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&t);
}
__device__ __forceinline__ float2 unpack_bf16(uint32_t v) {
  return __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&v));
}

// sum / max over the four lanes that share an accumulator row
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

// Byte offset of element (r, c) (c even: a bf16 pair) of a [rows][W] tile.
template <int W>
__device__ __forceinline__ uint32_t tile_at(int r, int c) {
  return (uint32_t)(r >> 3) * (W * 16) + (uint32_t)(c >> 3) * 128 + (uint32_t)(r & 7) * 16 + (uint32_t)(c & 7) * 2;
}

// Fill a [rows][W] tile at shared address dst from contiguous rows of W bf16
// at src, with cp.async by all nthreads threads (no commit). Rows at or past
// valid_rows are zero-filled. Unit u of the tile is row (u / W) * 8 + u % 8,
// chunk (u % W) / 8, and lands at byte 16 u.
template <int W>
__device__ __forceinline__ void fill_tile(uint32_t dst, const __nv_bfloat16* src, int rows, int valid_rows, int tid,
                                          int nthreads) {
  for (int u = tid; u < rows * (W / 8); u += nthreads) {
    const int r = (u / W) * 8 + (u & 7), c = (u % W) >> 3;
    const bool live = r < valid_rows;
    cp_async16(dst + (uint32_t)u * 16, src + (live ? (size_t)r * W + c * 8 : 0), live ? 16 : 0);
  }
}

}  // namespace
