// Tensor-core attention with an additive f32 bias for bf16 operands, for
// sm_90a (wgmma).
//
// The bf16 path of K1, K2, K9 and K6 (see attention.cu for the TPU kernels
// they replace and for the f32 CUDA-core kernel that stays for f32 operands,
// for other head dims and for longer CLIP sequences):
//
//   out = softmax(scale * q k^T + bias) v
//   REL_POS: bias[q, k] = rel_h[q, k / G] + rel_w[q, k % G]   (f32, added to the
//   CLS_ROW: bias[0, k] = cls_bias[n, k], other rows unbiased  f32 accumulator)
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
//
// resident kernel, CLS_ROW mode (K6, hybridgl_tpu/kernels/clip_attention.py:
// clip_attention: L = 197 tokens, hd = 64, up to 1536 stream-heads; bound by
// bytes: 155 MB per call). The same kernel with the bias tables left out of
// shared memory (53 KB a block instead of 65): 197 rows split into 4 x 50,
// and only the four lanes that own global row 0 (block 0, warp 0) read
// cls_bias[bh / H, key] from device memory and add it to that row's f32
// accumulator entries before the softmax. Masked patches carry
// finfo(float32).min: score + bias stays finite, row 0 always keeps its own
// key (bias 0), so the running max is finite and masked keys get exp = 0
// exactly. A null cls_bias runs the kernel with no bias.
//
// The same kernel past 256 rows (K6 at CLIP ViT-L/14@336: L = 577 tokens, hd
// = 64, up to 2,048 stream-heads; 175 GFLOP against 606 MB a call at bucket
// 64, so the operations and the bytes bound it alike, ~0.18 ms). A head's K
// and V (577 x 64 bf16 each; 160 KB as whole key tiles) still fit one block's
// shared memory, but then only one block fits an SM, and the tensor cores
// wait while a block loads. So one block of four warpgroups takes a whole
// head: it loads K and V once (ten cp.async groups, one a key tile) and walks
// the head's query tiles (577 rows in 10 tiles of 58), each warpgroup every
// fourth one. The first pass consumes the key tiles as they land, a barrier a
// tile, which holds the warpgroups in step; the later passes find K and V
// resident and run without a barrier, so one warpgroup's softmax overlaps the
// others' products. Between the products nothing branches (ptxas serialises
// the wgmma of a path that does): K and V are whole key tiles, zero past S, so
// every P V takes four steps, and each key's bias comes from two rows in
// shared memory (0 or -inf past S for every query row; cls_bias, times 1 on
// global row 0 and 0 elsewhere). The template's KT is the most key tiles a
// block holds (4 or 10); the kernel keeps its name, resident_kernel<HD, MODE,
// KT>.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flash_step.cuh"
#include "wgmma_common.cuh"

namespace {

constexpr int BK = 64;       // keys per tile
constexpr int WG_ROWS = 64;  // query rows per warpgroup

enum { REL_POS = 0, CLS_ROW = 1 };  // bias modes of the resident kernel

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src), "r"(src_bytes) : "memory");
}

// ---- shared pieces -----------------------------------------------------------

// Byte offset of tile-local key j, 16-byte chunk c in the core-matrix layout.
template <int HD>
__device__ __forceinline__ uint32_t tile_offset(int j, int c) {
  return (uint32_t)(j >> 3) * (HD * 16) + (uint32_t)c * 128 + (uint32_t)(j & 7) * 16;
}

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

// ---- resident kernel: REL_POS S <= 256 (any G with G * G = S); CLS_ROW S <= 577 ----

constexpr int MAX_RESIDENT_S = 256;  // one warpgroup a block, at most four key tiles
constexpr int MAX_CLS_S = 577;       // CLS_ROW: CLIP ViT-L/14@336's tokens, four warpgroups, ten key tiles

// the most key tiles (cp.async groups) a block of the kernel for S holds
__host__ __device__ constexpr int key_tiles(int S) {
  return S <= MAX_RESIDENT_S ? MAX_RESIDENT_S / BK : (MAX_CLS_S + BK - 1) / BK;
}
// warpgroups a block: four where K and V fill the SM's shared memory alone
__host__ __device__ constexpr int resident_wgs(int KT) { return KT > MAX_RESIDENT_S / BK ? 4 : 1; }

struct ResidentLayout {
  int sp;        // S rounded up to 16 keys
  int kv_bytes;  // K region then V region; K's last 64-key tile may read into V (walking: whole tiles)
  int rows;      // query rows per warpgroup tile
  int qtiles;    // warpgroup tiles of query rows
  int blocks;    // blocks a head: a tile each with one warpgroup, else one that walks the tiles
  int bytes;
};

// G = 0: no bias tables in shared memory (CLS_ROW). wgs: warpgroups a block.
inline ResidentLayout resident_layout(int S, int G, int HD, int wgs) {
  ResidentLayout L;
  L.sp = (S + 15) / 16 * 16;
  const int ktiles = (S + BK - 1) / BK;
  const int kv_rows = 2 * L.sp > ktiles * BK ? 2 * L.sp : ktiles * BK;
  L.kv_bytes = kv_rows * HD * 2;
  L.qtiles = (S + WG_ROWS - 1) / WG_ROWS;
  L.rows = (S + L.qtiles - 1) / L.qtiles;
  L.blocks = wgs == 1 ? L.qtiles : 1;
  L.bytes = L.kv_bytes + (G > 0 ? 2 * L.rows * G * 4 + MAX_RESIDENT_S * 2 : 0);
  if (wgs > 1) {  // whole key tiles for K and V, then the keys' bias rows (resident_kernel, WALK)
    L.kv_bytes = 2 * ktiles * BK * HD * 2;
    L.bytes = L.kv_bytes + 2 * ktiles * BK * 4;
  }
  return L;
}

// wait until at most n of this thread's cp.async groups are in flight (the
// instruction takes the count as an immediate: a ladder of N + 1 cases)
template <int N>
__device__ __forceinline__ void cp_async_wait_at_most(int n) {
  if constexpr (N == 0) {
    cp_async_wait<0>();
  } else {
    if (n >= N) cp_async_wait<N>();
    else cp_async_wait_at_most<N - 1>(n);
  }
}

// REL_POS: rel_h, rel_w [BH, S, G]. CLS_ROW: rel_h is cls_bias [BH / G, S] or
// null, rel_w unused, and G carries the number of heads H. KT: the most key
// tiles of S (key_tiles), which sets the warpgroups a block (resident_wgs).
template <int HD, int MODE, int KT>
__global__ void __launch_bounds__(128 * resident_wgs(KT), resident_wgs(KT) == 1 ? 3 : 1)
resident_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                const __nv_bfloat16* __restrict__ v, const float* __restrict__ rel_h,
                const float* __restrict__ rel_w, __nv_bfloat16* __restrict__ out, int S, int G, int sp,
                int kv_bytes, int rows, float scale) {
  constexpr int WGS = resident_wgs(KT);
  constexpr int NT = 128 * WGS;  // threads a block
  constexpr bool WALK = WGS > 1;  // the block walks all of a head's query tiles
  static_assert(MODE == CLS_ROW || !WALK, "REL_POS keeps one warpgroup a block (its bias rows are the block's)");
  extern __shared__ __align__(128) unsigned char smem[];
  const int ktiles = (S + BK - 1) / BK;
  const uint32_t ks = smem_u32(smem);
  const uint32_t vs = ks + (WALK ? ktiles * BK : sp) * HD * 2;
  // WALK: after K and V (whole key tiles, zero past S), each key's bias for every row (0, or -inf past S)
  // and for row 0 (cls_bias, 0 past S)
  float* key_bias = reinterpret_cast<float*>(smem + kv_bytes);
  float* cls_row = key_bias + ktiles * BK;
  // REL_POS only (a CLS_ROW block keeps nothing past kv_bytes but, walking, the keys' bias rows)
  float* Rh = reinterpret_cast<float*>(smem + kv_bytes);  // [rows][G]
  float* Rw = Rh + rows * G;                              // [rows][G]
  uint16_t* split = reinterpret_cast<uint16_t*>(Rw + rows * G);  // key -> (k / G) | (k % G) << 8

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * rows;  // REL_POS (one warpgroup a block): the block's first query row
  const size_t base = (size_t)bh * S * HD;

  // the block's rel_h / rel_w rows are contiguous in device memory: a
  // linear 4-byte copy (no divide), zero past the last row, in tile 0's group
  if constexpr (MODE == REL_POS) {
    const size_t rel_base = ((size_t)bh * S + q0) * G;
    const int live = (min(q0 + rows, S) - q0) * G;
    const uint32_t rh_s = smem_u32(Rh), rw_s = smem_u32(Rw);
    for (int i = tid; i < rows * G; i += NT) {
      const size_t off = rel_base + (i < live ? i : 0);
      cp_async4(rh_s + i * 4, rel_h + off, i < live ? 4 : 0);
      cp_async4(rw_s + i * 4, rel_w + off, i < live ? 4 : 0);
    }
  }
  // K and V: one cp.async group per 64-key tile; keys past S are zero-filled.
  // 16-byte unit u of a tile is key (u / HD) * 8 + u % 8, chunk (u % HD) / 8,
  // and lands at byte 16 * u of the tile; a thread owns units tid + NT i,
  // whose key and offset inside a tile are worked out once
  constexpr int UNITS = BK * HD / 8;
  constexpr int PER = (UNITS + NT - 1) / NT;  // units a thread copies of a full tile
  int unit_key[PER], unit_off[PER];
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int u = tid + NT * i;
    unit_key[i] = (u / HD) * 8 + (u & 7);
    unit_off[i] = unit_key[i] * HD + ((u % HD) >> 3) * 8;
  }
  for (int t = 0; t < ktiles; ++t) {
    const int units = WALK ? UNITS : min(BK, sp - t * BK) * (HD / 8);
    const uint32_t dst = (uint32_t)t * BK * HD * 2 + tid * 16;
    const size_t tile_base = base + (size_t)t * BK * HD;
#pragma unroll
    for (int i = 0; i < PER; ++i)
      if (tid + NT * i < units) {
        const bool live = t * BK + unit_key[i] < S;
        const size_t off = live ? tile_base + unit_off[i] : base;
        cp_async16(ks + dst + i * NT * 16, k + off, live ? 16 : 0);
        cp_async16(vs + dst + i * NT * 16, v + off, live ? 16 : 0);
      }
    cp_async_commit();
  }
  // the wait below counts back from KT groups: commit empty ones for the
  // tiles a short sequence does not have
  for (int t = ktiles; t < KT; ++t) cp_async_commit();
  if constexpr (MODE == REL_POS)
    for (int key = tid; key < MAX_RESIDENT_S; key += NT) split[key] = (uint16_t)((key / G) | ((key % G) << 8));
  if constexpr (WALK) {
    const float* cls = rel_h != nullptr ? rel_h + (size_t)(bh / G) * S : nullptr;
    for (int key = tid; key < ktiles * BK; key += NT) {
      key_bias[key] = key < S ? 0.f : -INFINITY;
      cls_row[key] = cls != nullptr && key < S ? cls[key] : 0.f;
    }
  }

  const int r0 = (warp & 3) * 16 + (lane >> 2), r1 = r0 + 8;  // rows inside the warpgroup's tile
  const int col = (lane & 3) * 2;
  // dead rows read a live row's bias: their output is never stored
  const int b0 = min(r0, rows - 1) * G, b1 = min(r1, rows - 1) * G;
  // query tile qt holds rows [qt * rows, (qt + 1) * rows); every warpgroup runs the first pass (a tile
  // past S computes on zeros and stores nothing), the later ones while the tile holds a row
  for (int qt = blockIdx.x * WGS + (warp >> 2), pass = 0; pass == 0 || (WALK && qt * rows < S);
       qt += gridDim.x * WGS, ++pass) {
    const int qb = qt * rows;
    const bool live0 = r0 < rows && qb + r0 < S, live1 = r1 < rows && qb + r1 < S;
    uint32_t qa[HD / 16][4];
    load_q_fragments<HD>(qa, live0 ? q + base + (size_t)(qb + r0) * HD : nullptr,
                         live1 ? q + base + (size_t)(qb + r1) * HD : nullptr, col, scale);
    // CLS_ROW: the bias row of this stream, for the four lanes that own global row 0
    const float* cls = nullptr;
    if constexpr (MODE == CLS_ROW && !WALK)
      if (rel_h != nullptr && qb + r0 == 0) cls = rel_h + (size_t)(bh / G) * S;
    const float w0 = qb + r0 == 0 ? 1.f : 0.f;  // WALK: this lane's row r0 is global row 0

    float o[HD / 2];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;
    RowState st;
    uint32_t pa[4][4];
    float s[32];
    for (int t = 0; t < ktiles; ++t) {
      if (!WALK || pass == 0) {
        cp_async_wait_at_most<KT - 1>(KT - 1 - t);  // groups 0..t done
        fence_async_proxy();
        __syncthreads();  // every thread's part of tile t has landed; at t = 0 also the bias rows
      }

      scores<HD>(s, qa, ks + (uint32_t)t * BK * HD * 2);
      if constexpr (WALK) {  // no branch: the keys' bias rows from shared memory
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int key = t * BK + j * 8 + col + e;
            const float kb = key_bias[key];
            s[j * 4 + e] += fmaf(w0, cls_row[key], kb);
            s[j * 4 + 2 + e] += kb;
          }
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int key = t * BK + j * 8 + col + e;
            if (key < S) {
              if constexpr (MODE == REL_POS) {
                const int hw = split[key];
                s[j * 4 + e] += Rh[b0 + (hw & 0xff)] + Rw[b0 + (hw >> 8)];
                s[j * 4 + 2 + e] += Rh[b1 + (hw & 0xff)] + Rw[b1 + (hw >> 8)];
              } else if (cls != nullptr) {
                s[j * 4 + e] += cls[key];  // row r0 = global row 0 alone
              }
            } else {
              s[j * 4 + e] = -INFINITY;
              s[j * 4 + 2 + e] = -INFINITY;
            }
          }
      }
      softmax_tile<HD>(s, 0.f, 0.f, st, o, pa);
      accumulate_pv<HD>(o, pa, vs + (uint32_t)t * BK * HD * 2, WALK ? 4 : min(4, (sp - t * BK) / 16));
    }
    store_rows<HD>(o, st, live0 ? out + base + (size_t)(qb + r0) * HD : nullptr,
                   live1 ? out + base + (size_t)(qb + r1) * HD : nullptr, col);
  }
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

template <int HD, int MODE, int KT>
int launch_resident(const void* q, const void* k, const void* v, const float* rel_h, const float* rel_w, void* out,
                    int BH, int S, int G, float scale, cudaStream_t stream) {
  auto kern = resident_kernel<HD, MODE, KT>;
  constexpr int WGS = resident_wgs(KT);
  const ResidentLayout L = resident_layout(S, MODE == REL_POS ? G : 0, HD, WGS);
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, L.bytes);
  if (err != cudaSuccess) return (int)err;
  // three blocks an SM (or one block's 148 KB of K and V) need the largest shared-memory carve-out
  err = cudaFuncSetAttribute(kern, cudaFuncAttributePreferredSharedMemoryCarveout, cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return (int)err;
  kern<<<dim3(L.blocks, BH), 128 * WGS, L.bytes, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), rel_h, rel_w, static_cast<__nv_bfloat16*>(out), S, G, L.sp, L.kv_bytes,
      L.rows, scale);
  return (int)cudaGetLastError();
}

template <int KT>
int launch_cls(const void* q, const void* k, const void* v, const float* cls_bias, void* out, int BH, int S, int HD,
               int H, float scale, cudaStream_t st) {
  return HD == 80 ? launch_resident<80, CLS_ROW, KT>(q, k, v, cls_bias, nullptr, out, BH, S, H, scale, st)
                  : launch_resident<64, CLS_ROW, KT>(q, k, v, cls_bias, nullptr, out, BH, S, H, scale, st);
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
  constexpr int KT = key_tiles(MAX_RESIDENT_S);
  return HD == 80 ? launch_resident<80, REL_POS, KT>(q, k, v, rel_h, rel_w, out, BH, S, G, scale, st)
                  : launch_resident<64, REL_POS, KT>(q, k, v, rel_h, rel_w, out, BH, S, G, scale, st);
}

// 1 where the resident kernel takes this CLS-row geometry (bf16 operands only).
int hgl_cls_tc_takes(int S, int HD) { return (HD == 64 || HD == 80) && S >= 1 && S <= MAX_CLS_S; }

// K6 in bf16 on the tensor cores: cls_bias [BH / H, S] f32 or null; the caller
// has checked hgl_cls_tc_takes. Returns a cudaError_t code (0 = launched).
int hgl_cls_attention_tc(const void* q, const void* k, const void* v, const float* cls_bias, void* out, int BH,
                         int S, int HD, int H, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return S <= MAX_RESIDENT_S ? launch_cls<key_tiles(MAX_RESIDENT_S)>(q, k, v, cls_bias, out, BH, S, HD, H, scale, st)
                             : launch_cls<key_tiles(MAX_CLS_S)>(q, k, v, cls_bias, out, BH, S, HD, H, scale, st);
}

}  // extern "C"
