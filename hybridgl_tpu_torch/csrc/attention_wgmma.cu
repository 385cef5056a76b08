// Tensor-core rel-pos attention for bf16 operands, for sm_90a (wgmma).
//
// The bf16 path of K1, K2 and K9 (see attention.cu for the TPU kernels they
// replace and for the f32 CUDA-core kernel that stays for f32 operands, for
// other head dims and for K6):
//
//   out = softmax(scale * q k^T + bias) v
//   bias[q, k] = rel_h[q, k / G] + rel_w[q, k % G]        (f32, added to the
//                                                          f32 accumulator)
//
// Both kernels here share one inner step. A warpgroup owns 64 query rows.
// Q is scaled in f32, rounded once to bf16 and kept in registers as the A
// fragments of Q K^T (wgmma m64n64k16 over hd / 16 steps, f32 accumulator in
// registers). The softmax runs on the accumulator fragment (4 threads share
// a row: two shuffles for the row max, the row sum stays per thread until
// the end). P is rounded to bf16 in registers, which is where the TPU
// kernels round it too, and is the A operand of P V (wgmma m64n{hd}k16, V
// read from shared memory MN-major). Nothing but K and V tiles passes
// through shared memory, and no score reaches device memory.
//
// Shared-memory tile layout (no swizzle; hd = 80 rows are 160 bytes, which
// is no swizzle width): a tile of keys is stored as 8-key x 16-byte core
// matrices, element (key j, 8-column chunk c) at byte
//   (j / 8) * (hd * 16) + c * 128 + (j % 8) * 16.
// Read K-major (Q K^T: the chunk stride is the leading offset, the 8-key
// group stride the stride offset) and MN-major (P V: the two swap), the same
// bytes serve both products, and the 16-byte units of a tile are simply
// consecutive in shared memory, so the fill is conflict-free.
//
// stream kernel (K2, K9: S = 4096, G = 64; bound by operations: 85.9 GFLOP
// per call at ViT-H against 76 MB). One block per (head, 128 query rows):
// two consumer warpgroups of 64 rows and one producer warp. The producer
// fills a ring of four 64-key K/V stages with 16-byte cp.async and hands
// each over through an mbarrier (after a proxy fence, since wgmma reads
// shared memory through the async proxy); consumers release a stage through
// a second mbarrier, so loads overlap the products, and the two warpgroups
// overlap each other's softmax and products (a software pipeline inside the
// warpgroup, Q K^T of the next tile under this tile's softmax, measured no
// faster and was left out). A 64-key tile is exactly one
// grid row: bias = rel_h[q, tile] + rel_w[q, k - k0], so each thread keeps
// the rel_w values of the 2 x 16 accumulator entries it owns in registers
// for the whole loop and adds one rel_h scalar per row per tile. No divide,
// no modulo and no shared-memory traffic for the bias.
//
// resident kernel (K1: S = 196, G = 14, 400 window-heads; bound by bytes: 59
// MB per call at ViT-H). All K and V of one window-head (65 KB with padding)
// sit in shared memory at once. One block of one warpgroup per
// (window-head, query tile); the S rows split evenly into ceil(S / 64)
// tiles (196 -> 4 x 49 rows), so no block is nearly empty. Three blocks
// share an SM and cover each other's load phase; within a block the loads
// are four cp.async groups, one per 64-key tile, consumed as they land. Keys
// past S get a score of -inf and zero V rows. G = 14 aligns with no tile, so
// k / G and k % G come from a table built once per block, and the block's
// rel_h / rel_w rows sit in shared memory. wgmma rather than mma.sync: the
// kernel is memory-bound either way, and wgmma lets it share the stream
// kernel's inner step and shared-memory layout.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BK = 64;       // keys per tile
constexpr int WG_ROWS = 64;  // query rows per warpgroup
constexpr float LOG2E = 1.4426950408889634f;

// ---- PTX helpers -----------------------------------------------------------

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

// 16 bytes, src_bytes of them read and the rest zero-filled. Through L1
// (.ca): a warp-wide copy reads 8 rows x 64 bytes, and the other half of each
// 128-byte line is the next copy's; measured 1.4x faster than .cg on the
// stream kernel.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(src_bytes) : "memory");
}
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src), "r"(src_bytes) : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// generic-proxy writes (cp.async, st.shared) before async-proxy reads (wgmma)
__device__ __forceinline__ void fence_async_proxy() { asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory"); }

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

// 2^x on the special-function unit, without exp2f's denormal handling: the
// probabilities are rounded to bf16 next, and the unit is as busy as the
// tensor cores in this loop
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 t = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&t);
}

// ---- shared pieces -----------------------------------------------------------

// Byte offset of tile-local key j, 16-byte chunk c in the core-matrix layout.
template <int HD>
__device__ __forceinline__ uint32_t tile_offset(int j, int c) {
  return (uint32_t)(j >> 3) * (HD * 16) + (uint32_t)c * 128 + (uint32_t)(j & 7) * 16;
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

// One key tile: s holds q k^T + the column part of the bias (-inf on dead
// keys), add0 / add1 the row part; turns s into bf16 P fragments, updates
// the running max and sum and rescales the output accumulator.
template <int HD>
__device__ __forceinline__ void softmax_tile(float (&s)[32], float add0, float add1, RowState& st,
                                             float (&o)[HD / 2], uint32_t (&pa)[4][4]) {
  float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    mx0 = fmaxf(mx0, fmaxf(s[j * 4], s[j * 4 + 1]));
    mx1 = fmaxf(mx1, fmaxf(s[j * 4 + 2], s[j * 4 + 3]));
  }
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
  const float new0 = fmaxf(st.m0, mx0 + add0), new1 = fmaxf(st.m1, mx1 + add1);
  const float alpha0 = ex2((st.m0 - new0) * LOG2E), alpha1 = ex2((st.m1 - new1) * LOG2E);
  const float c0 = (add0 - new0) * LOG2E, c1 = (add1 - new1) * LOG2E;
  st.m0 = new0;
  st.m1 = new1;
  float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float p00 = ex2(fmaf(s[j * 4], LOG2E, c0)), p01 = ex2(fmaf(s[j * 4 + 1], LOG2E, c0));
    const float p10 = ex2(fmaf(s[j * 4 + 2], LOG2E, c1)), p11 = ex2(fmaf(s[j * 4 + 3], LOG2E, c1));
    sum0 += p00 + p01;
    sum1 += p10 + p11;
    pa[j >> 1][(j & 1) * 2] = pack_bf16(p00, p01);
    pa[j >> 1][(j & 1) * 2 + 1] = pack_bf16(p10, p11);
  }
  st.l0 = st.l0 * alpha0 + sum0;
  st.l1 = st.l1 * alpha1 + sum1;
#pragma unroll
  for (int j = 0; j < HD / 8; ++j) {
    o[j * 4] *= alpha0;
    o[j * 4 + 1] *= alpha0;
    o[j * 4 + 2] *= alpha1;
    o[j * 4 + 3] *= alpha1;
  }
}

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

// out rows = o / l for the two rows a thread owns (null: row not stored).
template <int HD>
__device__ __forceinline__ void store_rows(const float (&o)[HD / 2], RowState st, __nv_bfloat16* row0,
                                           __nv_bfloat16* row1, int col) {
  float l0 = st.l0, l1 = st.l1;
  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float inv0 = 1.f / l0, inv1 = 1.f / l1;
#pragma unroll
  for (int j = 0; j < HD / 8; ++j) {
    if (row0 != nullptr)
      *reinterpret_cast<uint32_t*>(row0 + j * 8 + col) = pack_bf16(o[j * 4] * inv0, o[j * 4 + 1] * inv0);
    if (row1 != nullptr)
      *reinterpret_cast<uint32_t*>(row1 + j * 8 + col) = pack_bf16(o[j * 4 + 2] * inv1, o[j * 4 + 3] * inv1);
  }
}

// ---- stream kernel: S a multiple of 128, G = 64 --------------------------------

constexpr int STAGES = 4;     // K/V ring depth
constexpr int LOAD_LAG = 2;   // tiles in flight before the producer hands one over
constexpr int STREAM_THREADS = 2 * 128 + 32;

template <int HD>
constexpr int stream_smem_bytes() {
  return STAGES * 2 * BK * HD * 2 + 2 * STAGES * 8;
}

template <int HD>
__global__ void __launch_bounds__(STREAM_THREADS, 1)
rel_pos_stream_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                      const __nv_bfloat16* __restrict__ v, const float* __restrict__ rel_h,
                      const float* __restrict__ rel_w, __nv_bfloat16* __restrict__ out, int S, float scale) {
  constexpr int G = 64;
  constexpr int TILE_BYTES = BK * HD * 2;
  constexpr int UNITS = TILE_BYTES / 16;  // 16-byte units of one K or V tile
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t ring = smem_u32(smem);
  const uint32_t full_bar = ring + STAGES * 2 * TILE_BYTES;
  const uint32_t empty_bar = full_bar + STAGES * 8;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * 2 * WG_ROWS;
  const int tiles = S / BK;
  const size_t base = (size_t)bh * S * HD;

  if (threadIdx.x == 0) {
    for (int i = 0; i < STAGES; ++i) {
      mbar_init(full_bar + i * 8, 32);  // every producer lane
      mbar_init(empty_bar + i * 8, 8);  // lane 0 of every consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == 8) {
    // producer: 16-byte unit u of a tile is key (u / HD) * 8 + u % 8, chunk
    // (u % HD) / 8, and lands at byte 16 * u of the stage. A lane owns units
    // lane + 32 i; their offsets inside a tile are the same for every tile
    // and are worked out once, so the loop is one add and two copies a unit
    static_assert(UNITS % 32 == 0, "a tile is a whole number of warp-wide copies");
    int unit_off[UNITS / 32];
#pragma unroll
    for (int i = 0; i < UNITS / 32; ++i) {
      const int u = lane + 32 * i;
      unit_off[i] = ((u / HD) * 8 + (u & 7)) * HD + ((u % HD) >> 3) * 8;
    }
    const __nv_bfloat16* kb = k + base;
    const __nv_bfloat16* vb = v + base;
    for (int t = 0; t < tiles; ++t) {
      const int stage = t % STAGES;
      mbar_wait(empty_bar + stage * 8, ((t / STAGES) & 1) ^ 1);
      const uint32_t kdst = ring + stage * 2 * TILE_BYTES + lane * 16, vdst = kdst + TILE_BYTES;
      const __nv_bfloat16* kt = kb + (size_t)t * BK * HD;
      const __nv_bfloat16* vt = vb + (size_t)t * BK * HD;
#pragma unroll
      for (int i = 0; i < UNITS / 32; ++i) {
        cp_async16(kdst + i * 512, kt + unit_off[i], 16);
        cp_async16(vdst + i * 512, vt + unit_off[i], 16);
      }
      cp_async_commit();
      if (t >= LOAD_LAG) {
        cp_async_wait<LOAD_LAG>();
        fence_async_proxy();
        mbar_arrive(full_bar + ((t - LOAD_LAG) % STAGES) * 8);
      }
    }
    cp_async_wait<0>();
    fence_async_proxy();
    for (int t = (tiles > LOAD_LAG ? tiles - LOAD_LAG : 0); t < tiles; ++t) mbar_arrive(full_bar + (t % STAGES) * 8);
  } else {
    const int wg = warp >> 2, w = warp & 3;
    const int row0 = q0 + wg * WG_ROWS + w * 16 + (lane >> 2), row1 = row0 + 8;
    const int col = (lane & 3) * 2;

    uint32_t qa[HD / 16][4];
    load_q_fragments<HD>(qa, q + base + (size_t)row0 * HD, q + base + (size_t)row1 * HD, col, scale);
    // the rel_w values of the accumulator entries this thread owns
    float rw[32];
    const float* rw0 = rel_w + ((size_t)bh * S + row0) * G + col;
    const float* rw1 = rel_w + ((size_t)bh * S + row1) * G + col;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 a = *reinterpret_cast<const float2*>(rw0 + j * 8);
      const float2 b = *reinterpret_cast<const float2*>(rw1 + j * 8);
      rw[j * 4] = a.x;
      rw[j * 4 + 1] = a.y;
      rw[j * 4 + 2] = b.x;
      rw[j * 4 + 3] = b.y;
    }
    const float* rh0 = rel_h + ((size_t)bh * S + row0) * G;
    const float* rh1 = rel_h + ((size_t)bh * S + row1) * G;

    float o[HD / 2];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;
    RowState st;
    uint32_t pa[4][4];
    float s[32];
    for (int t = 0; t < tiles; ++t) {
      const int stage = t % STAGES;
      const float add0 = rh0[t], add1 = rh1[t];  // the tile is grid row t
      const uint32_t ktile = ring + stage * 2 * TILE_BYTES;
      mbar_wait(full_bar + stage * 8, (t / STAGES) & 1);
      scores<HD>(s, qa, ktile);
#pragma unroll
      for (int i = 0; i < 32; ++i) s[i] += rw[i];
      softmax_tile<HD>(s, add0, add1, st, o, pa);
      accumulate_pv<HD>(o, pa, ktile + TILE_BYTES, 4);
      if (lane == 0) mbar_arrive(empty_bar + stage * 8);
    }
    store_rows<HD>(o, st, out + base + (size_t)row0 * HD, out + base + (size_t)row1 * HD, col);
  }
}

// ---- resident kernel: S <= 256, any G with G * G = S ---------------------------

constexpr int MAX_RESIDENT_S = 256;
constexpr int MAX_KTILES = MAX_RESIDENT_S / BK;  // cp.async groups a block commits, one per key tile
static_assert(MAX_KTILES == 4, "the wait ladder in rel_pos_resident_kernel names four groups");

struct ResidentLayout {
  int sp;        // S rounded up to 16 keys
  int kv_bytes;  // K region then V region; K's last 64-key tile may read into V
  int rows;      // query rows per block
  int qtiles;
  int bytes;
};

inline ResidentLayout resident_layout(int S, int G, int HD) {
  ResidentLayout L;
  L.sp = (S + 15) / 16 * 16;
  const int ktiles = (S + BK - 1) / BK;
  const int kv_rows = 2 * L.sp > ktiles * BK ? 2 * L.sp : ktiles * BK;
  L.kv_bytes = kv_rows * HD * 2;
  L.qtiles = (S + WG_ROWS - 1) / WG_ROWS;
  L.rows = (S + L.qtiles - 1) / L.qtiles;
  L.bytes = L.kv_bytes + 2 * L.rows * G * 4 + MAX_RESIDENT_S * 2;
  return L;
}

template <int HD>
__global__ void __launch_bounds__(128, 3)
rel_pos_resident_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                        const __nv_bfloat16* __restrict__ v, const float* __restrict__ rel_h,
                        const float* __restrict__ rel_w, __nv_bfloat16* __restrict__ out, int S, int G, int sp,
                        int kv_bytes, int rows, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t ks = smem_u32(smem);
  const uint32_t vs = ks + sp * HD * 2;
  float* Rh = reinterpret_cast<float*>(smem + kv_bytes);  // [rows][G]
  float* Rw = Rh + rows * G;                              // [rows][G]
  uint16_t* split = reinterpret_cast<uint16_t*>(Rw + rows * G);  // key -> (k / G) | (k % G) << 8

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * rows;
  const int ktiles = (S + BK - 1) / BK;
  const size_t base = (size_t)bh * S * HD;

  // the block's rel_h / rel_w rows are contiguous in device memory: a
  // linear 4-byte copy (no divide), zero past the last row, in tile 0's group
  {
    const size_t rel_base = ((size_t)bh * S + q0) * G;
    const int live = (min(q0 + rows, S) - q0) * G;
    const uint32_t rh_s = smem_u32(Rh), rw_s = smem_u32(Rw);
    for (int i = tid; i < rows * G; i += 128) {
      const size_t off = rel_base + (i < live ? i : 0);
      cp_async4(rh_s + i * 4, rel_h + off, i < live ? 4 : 0);
      cp_async4(rw_s + i * 4, rel_w + off, i < live ? 4 : 0);
    }
  }
  // K and V: one cp.async group per 64-key tile; keys past S are zero-filled.
  // 16-byte unit u of a tile is key (u / HD) * 8 + u % 8, chunk (u % HD) / 8,
  // and lands at byte 16 * u of the tile; a thread owns units tid + 128 i,
  // whose key and offset inside a tile are worked out once
  constexpr int UNITS = BK * HD / 8;
  static_assert(UNITS % 128 == 0, "a full tile is a whole number of block-wide copies");
  int unit_key[UNITS / 128], unit_off[UNITS / 128];
#pragma unroll
  for (int i = 0; i < UNITS / 128; ++i) {
    const int u = tid + 128 * i;
    unit_key[i] = (u / HD) * 8 + (u & 7);
    unit_off[i] = unit_key[i] * HD + ((u % HD) >> 3) * 8;
  }
  for (int t = 0; t < ktiles; ++t) {
    const int units = min(BK, sp - t * BK) * (HD / 8);
    const uint32_t dst = (uint32_t)t * BK * HD * 2 + tid * 16;
    const size_t tile_base = base + (size_t)t * BK * HD;
#pragma unroll
    for (int i = 0; i < UNITS / 128; ++i)
      if (tid + 128 * i < units) {
        const bool live = t * BK + unit_key[i] < S;
        const size_t off = live ? tile_base + unit_off[i] : base;
        cp_async16(ks + dst + i * 2048, k + off, live ? 16 : 0);
        cp_async16(vs + dst + i * 2048, v + off, live ? 16 : 0);
      }
    cp_async_commit();
  }
  // the wait below counts back from MAX_KTILES groups: commit empty ones for
  // the tiles a short sequence does not have
  for (int t = ktiles; t < MAX_KTILES; ++t) cp_async_commit();
  for (int key = tid; key < MAX_RESIDENT_S; key += 128) split[key] = (uint16_t)((key / G) | ((key % G) << 8));

  const int r0 = warp * 16 + (lane >> 2), r1 = r0 + 8;  // rows inside the tile
  const int col = (lane & 3) * 2;
  const bool live0 = r0 < rows && q0 + r0 < S, live1 = r1 < rows && q0 + r1 < S;
  uint32_t qa[HD / 16][4];
  load_q_fragments<HD>(qa, live0 ? q + base + (size_t)(q0 + r0) * HD : nullptr,
                       live1 ? q + base + (size_t)(q0 + r1) * HD : nullptr, col, scale);
  // dead rows read a live row's bias: their output is never stored
  const int b0 = min(r0, rows - 1) * G, b1 = min(r1, rows - 1) * G;

  float o[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;
  RowState st;
  uint32_t pa[4][4];
  float s[32];
  for (int t = 0; t < ktiles; ++t) {
    // groups 0..t done = at most MAX_KTILES - 1 - t still in flight
    if (t == 0) cp_async_wait<MAX_KTILES - 1>();
    else if (t == 1) cp_async_wait<MAX_KTILES - 2>();
    else if (t == 2) cp_async_wait<MAX_KTILES - 3>();
    else cp_async_wait<0>();
    fence_async_proxy();
    __syncthreads();  // every thread's part of tile t has landed; at t = 0 also the bias rows

    scores<HD>(s, qa, ks + (uint32_t)t * BK * HD * 2);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int key = t * BK + j * 8 + col + e;
        if (key < S) {
          const int hw = split[key];
          s[j * 4 + e] += Rh[b0 + (hw & 0xff)] + Rw[b0 + (hw >> 8)];
          s[j * 4 + 2 + e] += Rh[b1 + (hw & 0xff)] + Rw[b1 + (hw >> 8)];
        } else {
          s[j * 4 + e] = -INFINITY;
          s[j * 4 + 2 + e] = -INFINITY;
        }
      }
    softmax_tile<HD>(s, 0.f, 0.f, st, o, pa);
    accumulate_pv<HD>(o, pa, vs + (uint32_t)t * BK * HD * 2, min(4, (sp - t * BK) / 16));
  }
  store_rows<HD>(o, st, live0 ? out + base + (size_t)(q0 + r0) * HD : nullptr,
                 live1 ? out + base + (size_t)(q0 + r1) * HD : nullptr, col);
}

template <int HD>
int launch_stream(const void* q, const void* k, const void* v, const float* rel_h, const float* rel_w, void* out,
                  int BH, int S, float scale, cudaStream_t stream) {
  auto kern = rel_pos_stream_kernel<HD>;
  constexpr int bytes = stream_smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  kern<<<dim3(S / (2 * WG_ROWS), BH), STREAM_THREADS, bytes, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), rel_h, rel_w, static_cast<__nv_bfloat16*>(out), S, scale);
  return (int)cudaGetLastError();
}

template <int HD>
int launch_resident(const void* q, const void* k, const void* v, const float* rel_h, const float* rel_w, void* out,
                    int BH, int S, int G, float scale, cudaStream_t stream) {
  auto kern = rel_pos_resident_kernel<HD>;
  const ResidentLayout L = resident_layout(S, G, HD);
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, L.bytes);
  if (err != cudaSuccess) return (int)err;
  // three blocks an SM need the largest shared-memory carve-out
  err = cudaFuncSetAttribute(kern, cudaFuncAttributePreferredSharedMemoryCarveout, cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return (int)err;
  kern<<<dim3(L.qtiles, BH), 128, L.bytes, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), rel_h, rel_w, static_cast<__nv_bfloat16*>(out), S, G, L.sp, L.kv_bytes,
      L.rows, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// 1 where the tensor-core kernels take this geometry (bf16 operands only).
int hgl_rel_pos_tc_takes(int S, int HD, int G) {
  if (HD != 64 && HD != 80) return 0;
  if (G * G != S) return 0;
  return G == 64 || S <= MAX_RESIDENT_S;
}

// bf16 rel-pos attention on the tensor cores; the caller has checked
// hgl_rel_pos_tc_takes. Returns a cudaError_t code (0 = launched).
int hgl_rel_pos_attention_tc(const void* q, const void* k, const void* v, const float* rel_h, const float* rel_w,
                             void* out, int BH, int S, int HD, int G, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (G == 64)
    return HD == 80 ? launch_stream<80>(q, k, v, rel_h, rel_w, out, BH, S, scale, st)
                    : launch_stream<64>(q, k, v, rel_h, rel_w, out, BH, S, scale, st);
  return HD == 80 ? launch_resident<80>(q, k, v, rel_h, rel_w, out, BH, S, G, scale, st)
                  : launch_resident<64>(q, k, v, rel_h, rel_w, out, BH, S, G, scale, st);
}

}  // extern "C"
