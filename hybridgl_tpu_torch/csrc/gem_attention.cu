// GEM's attention (models/gem/gem.py:gem_image_features), for sm_90a: in every
// block of the tower at GEM's input size the trunk's
//
//   ctx = softmax(scale q k^T) v
//
// and in the last `depth` blocks beside it the qq/kk/vv self-self ensemble
// (Bousselham et al., CVPR 2024)
//
//   ens = mean over t in {q, k, v} of softmax(temp n(t) n(t)^T) v,
//
// n the row-wise L2 normalisation (eps 1e-6). Replaces no TPU kernel: the JAX
// package computes both in plain XLA (hybridgl_tpu/models/gem/gem.py:
// _std_attention, self_self_attention). In the port they were plain PyTorch:
// an [L, L] score tensor in device memory and ~10 passes over it per
// attention, 4 attentions a block at 785 (ViT-B/16) and 1,025 (ViT-L/14@336)
// tokens, the largest item of the feature stage that no kernel of the port
// ran. What bounds this kernel is the tensor cores: 4 L^2 hd operations an
// attention (4.3 GFLOP a head group at 1,025 x 16 x 64) against 4 L hd bytes
// of q, k, v and out, ~500 operations a byte.
//
// Three kernels:
//
// gem_l2norm_rows (CUDA cores): n(q), n(k), n(v) -> [3, NH, L, hd] once a launch,
// in f32 and rounded once to the operand dtype (the plain path rounds the
// squares, their sum and the root to bf16). A row is HD / 8 (bf16) or HD / 4
// (f32) threads of 16 bytes, a power-of-two group of a warp, summed by shuffles.
//
// gem_flash (tensor cores, bf16, hd 64 or 80). One block of three consumer
// warpgroups and one producer warpgroup. A head's keys (785 or 1,025) do not
// fit a block's shared memory as K6's 577 do, so they stream: the producers
// fill a ring of four stages with 16-byte cp.async (keys past L zero-filled;
// the last tile of 1,025 holds one key), and each stage's mbarrier completes as
// their copies land (cp.async.mbarrier.arrive); the consumers release a stage
// through a second one. A stage holds four 64-key tiles. An ensemble block owns
// one (head, query tile): warpgroup t runs stream t against its own normalised
// key tile (slots 0-2) and the shared V tile (slot 3), and the three f32
// outputs o_t / l_t are summed through shared memory and written once. A trunk
// block owns three query tiles of one head, one a warpgroup, against K (slot 0)
// and V (slot 3). Every block thus walks the same ceil(L / 64) key tiles, so
// the blocks of a launch are equal in length and fill the card in whole waves:
// the ensemble blocks are first in the grid and the trunk's follow in the same
// launch. The query tiles split L evenly into a multiple of three tiles of at
// most 64 rows (785: 15 of 53; 1,025: 18 of 57), so a launch of both at N = 1
// is 240 (12 heads) or 384 (16 heads) blocks of equal length on 132 SMs. What
// an H100 measured of this design: a step of a block (a key tile for three
// warpgroups) takes ~1.3 us in the trunk and ~1.9 us in the ensemble, well
// above its tensor (~0.4 us) and ex2 (~0.4 us) work; without the exponentials
// it is no faster, with twice the tiles loaded a stage the trunk is ~55%
// slower, and a deeper hand-over lag, a token passed between the warpgroups
// before Q K^T, .cg copies and a fifth stage were no faster (the consumers hold
// 128 registers at one block an SM, so Q K^T of the next tile under this one's
// softmax spills, and a producer warpgroup handing its registers to the
// consumers by setmaxnreg leaves ptxas's allocation at 128 and was no faster).
// Scaling the raw products by the rows' inverse norms in place of the
// normalised copies (a tile less a stage in the ensemble, 32 multiplies more a
// tile) was slower: 0.115 against ~0.099 ms at [16, 1025, 64]. Each warpgroup's
// step is a chain of dependent work that three warpgroups an SM do not hide.
//
// Inside a warpgroup the inner step is K6's (flash_step.cuh): q (or n(t)) as
// bf16 A fragments in registers, S = Q K^T on wgmma m64n64k16 into f32
// registers, the online softmax in f32 with the scale applied in the exponent
// (the scores are never rounded; the plain path stored them in bf16), P
// rounded to bf16 in registers as the A operand of P V (wgmma m64n{hd}k16, V
// read MN-major from the same tile layout). Keys past L score -inf by a select
// in the last tile alone, under a block-uniform branch, so no lane diverges
// between the products. No score reaches device memory. The outputs are written with
// the heads merged, [N, L, H hd], ready for the out-projection.
//
// gem_flash_cc (CUDA cores; f32 operands, and bf16 at the other head dims):
// the same jobs on attention.cu's tiled design, all arithmetic f32, the
// ensemble's three streams in turn in one block of 256 threads.
//
// A launch runs one of three modes: the trunk alone (the blocks before the
// last `depth`), the trunk and the ensemble's mean (the last `depth`), and an
// update pass (ss_attn_iters > 1: each stream's softmax(temp n n^T) n, the
// normalised stream as V, written apart, head-split, to be normalised again).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flash_step.cuh"
#include "wgmma_common.cuh"

namespace {

using bf16 = __nv_bfloat16;

enum { TRUNK = 0, TRUNK_ENSEMBLE = 1, UPDATE = 2 };  // what a launch computes

constexpr int KEYS = 64;     // keys a tile
constexpr int GROUP = 3;     // consumer warpgroups a block: the ensemble's streams, or the trunk's query tiles
constexpr int SLOTS = 4;     // tiles a stage: n(q), n(k), n(v) key tiles and V (trunk: K in 0, V in 3)
constexpr int STAGES = 4;    // ring depth
constexpr int PRODUCERS = 4 * 32;  // producer threads: one warpgroup (one warp issued the copies ~10% slower)
constexpr int TC_THREADS = GROUP * 128 + PRODUCERS;
constexpr float NORM_EPS = 1e-6f;

struct Args {
  const void* q;    // trunk operands [NH, L, HD]
  const void* k;
  const void* v;
  const void* nrm;  // [3, NH, L, HD]: the ensemble's streams, rows of unit norm
  void* out;        // trunk context [N, L, H * HD]
  void* ens;        // ensemble mean [N, L, H * HD]; UPDATE: the three streams [3, NH, L, HD]
  int NH, L, H;
  int rows;         // query rows a tile
  int qtiles;       // query tiles a head
  int ens_blocks;   // blocks of ensemble work, first in the grid
  float scale;      // trunk
  float temp;       // ensemble
  int mode;
};

// ---- the row normalisation ------------------------------------------------------------

template <typename T>
struct Vec16 {  // 16 bytes of T as f32
  static constexpr int N = 16 / sizeof(T);
};

__device__ __forceinline__ void load16(const float* p, float (&f)[4]) {
  const float4 u = *reinterpret_cast<const float4*>(p);
  f[0] = u.x, f[1] = u.y, f[2] = u.z, f[3] = u.w;
}
__device__ __forceinline__ void load16(const bf16* p, float (&f)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t = unpack_bf16(w[i]);
    f[2 * i] = t.x, f[2 * i + 1] = t.y;
  }
}
__device__ __forceinline__ void store16(float* p, const float (&f)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(f[0], f[1], f[2], f[3]);
}
__device__ __forceinline__ void store16(bf16* p, const float (&f)[8]) {
  *reinterpret_cast<uint4*>(p) =
      make_uint4(pack_bf16(f[0], f[1]), pack_bf16(f[2], f[3]), pack_bf16(f[4], f[5]), pack_bf16(f[6], f[7]));
}

__host__ __device__ constexpr int pow2_at_least(int n) { return n <= 1 ? 1 : 2 * pow2_at_least((n + 1) / 2); }

// out[t][r] = x_t[r] / max(|x_t[r]|, eps) for the rows r of x0, x1, x2 (each [rows, HD])
template <typename T, int HD>
__global__ void __launch_bounds__(256) gem_l2norm_rows(const T* __restrict__ x0, const T* __restrict__ x1,
                                                       const T* __restrict__ x2, T* __restrict__ out, int rows) {
  constexpr int PER = Vec16<T>::N;
  constexpr int UNITS = HD / PER;             // 16-byte units a row
  constexpr int TPR = pow2_at_least(UNITS);   // threads a row: a power-of-two group of a warp
  static_assert(HD % PER == 0 && TPR <= 32, "a row is whole 16-byte units within one warp");
  const size_t gid = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const size_t row = gid / TPR;
  const int u = (int)(gid % TPR);
  const bool live = row < 3 * (size_t)rows && u < UNITS;  // every lane takes part in the shuffles
  float f[PER];
#pragma unroll
  for (int i = 0; i < PER; ++i) f[i] = 0.f;
  if (live) {
    const int t = (int)(row / rows);
    const T* x = t == 0 ? x0 : t == 1 ? x1 : x2;
    load16(x + (row - (size_t)t * rows) * HD + u * PER, f);
  }
  float ss = 0.f;
#pragma unroll
  for (int i = 0; i < PER; ++i) ss = fmaf(f[i], f[i], ss);
#pragma unroll
  for (int off = TPR / 2; off > 0; off >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, off);
  const float norm = fmaxf(sqrtf(ss), NORM_EPS);
  if (live) {
#pragma unroll
    for (int i = 0; i < PER; ++i) f[i] = f[i] / norm;
    store16(out + row * HD + u * PER, f);
  }
}

// ---- the tensor-core kernel -------------------------------------------------------------

template <int HD>
__host__ __device__ constexpr int tile_bytes() {
  return KEYS * HD * 2;
}
// the ring, the two warpgroups' f32 outputs the ensemble sums, the mbarriers
template <int HD>
__host__ __device__ constexpr int tc_smem_bytes() {
  return STAGES * SLOTS * tile_bytes<HD>() + 2 * 128 * (HD / 2) * 4 + 2 * STAGES * 8;
}

// One key tile of a warpgroup: s holds Q K^T (raw); keys at or past `live`
// are dead. c = scale * log2(e): the softmax of scale * s, in f32, with P
// rounded to bf16 as the A fragments of P V.
template <int HD>
__device__ __forceinline__ void softmax_scaled(float (&s)[32], int live, int col, float c, RowState& st,
                                               float (&o)[HD / 2], uint32_t (&pa)[4][4]) {
  if (live < KEYS) {  // the last tile: block-uniform, so no lane diverges
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const bool dead = j * 8 + col + e >= live;
        s[j * 4 + e] = dead ? -INFINITY : s[j * 4 + e];
        s[j * 4 + 2 + e] = dead ? -INFINITY : s[j * 4 + 2 + e];
      }
  }
  float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    mx0 = fmaxf(mx0, fmaxf(s[j * 4], s[j * 4 + 1]));
    mx1 = fmaxf(mx1, fmaxf(s[j * 4 + 2], s[j * 4 + 3]));
  }
  mx0 = quad_max(mx0);
  mx1 = quad_max(mx1);
  // every tile holds a live key, so the new maxima are finite; the first tile's alpha is 2^-inf = 0
  const float new0 = fmaxf(st.m0, mx0), new1 = fmaxf(st.m1, mx1);
  const float alpha0 = ex2((st.m0 - new0) * c), alpha1 = ex2((st.m1 - new1) * c);
  const float b0 = -new0 * c, b1 = -new1 * c;
  st.m0 = new0;
  st.m1 = new1;
  float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float p00 = ex2(fmaf(s[j * 4], c, b0)), p01 = ex2(fmaf(s[j * 4 + 1], c, b0));
    const float p10 = ex2(fmaf(s[j * 4 + 2], c, b1)), p11 = ex2(fmaf(s[j * 4 + 3], c, b1));
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

// two rows of HD values (pairs at j * 8 + col) to bf16 (null: the row is not stored)
template <int HD>
__device__ __forceinline__ void store_pairs(const float (&o)[HD / 2], float inv0, float inv1, bf16* row0, bf16* row1,
                                            int col) {
#pragma unroll
  for (int j = 0; j < HD / 8; ++j) {
    if (row0 != nullptr)
      *reinterpret_cast<uint32_t*>(row0 + j * 8 + col) = pack_bf16(o[j * 4] * inv0, o[j * 4 + 1] * inv0);
    if (row1 != nullptr)
      *reinterpret_cast<uint32_t*>(row1 + j * 8 + col) = pack_bf16(o[j * 4 + 2] * inv1, o[j * 4 + 3] * inv1);
  }
}

constexpr int COMBINE_BAR = 1;  // the named barrier of the ensemble's sum (0 is __syncthreads)

template <int HD>
__global__ void __launch_bounds__(TC_THREADS, 1) gem_flash(const Args a) {
  constexpr int TILE = tile_bytes<HD>();
  constexpr int UNITS = TILE / 16;  // 16-byte units of a tile
  constexpr int PT = PRODUCERS;
  static_assert(UNITS % PT == 0, "a tile is a whole number of the producers' copies");
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t ring = smem_u32(smem);
  float* comb = reinterpret_cast<float*>(smem + STAGES * SLOTS * TILE);  // [2][HD / 2][128]
  const uint32_t full_bar = ring + STAGES * SLOTS * TILE + 2 * 128 * (HD / 2) * 4;
  const uint32_t empty_bar = full_bar + STAGES * 8;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int L = a.L, KT = (L + KEYS - 1) / KEYS;
  const size_t head = (size_t)L * HD, stream = (size_t)a.NH * head;
  const bool ens = (int)blockIdx.x < a.ens_blocks;
  const int job = ens ? blockIdx.x : blockIdx.x - a.ens_blocks;
  const int per_head = ens ? a.qtiles : a.qtiles / GROUP;
  const int bh = job / per_head;
  const int tile0 = ens ? job % per_head : (job % per_head) * GROUP;  // the block's (first) query tile
  const bf16* nrm = ens ? static_cast<const bf16*>(a.nrm) + bh * head : nullptr;
  const bf16* vb = a.mode == UPDATE ? nullptr : static_cast<const bf16*>(a.v) + bh * head;

  if (threadIdx.x == 0) {
    for (int i = 0; i < STAGES; ++i) {
      mbar_init(full_bar + i * 8, PT);          // every producer thread, as its copies land
      mbar_init(empty_bar + i * 8, GROUP * 4);  // lane 0 of every consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= GROUP * 4) {
    // producer: the block's key tiles, slot by slot; 16-byte unit u of a tile is key (u / HD) * 8 + u % 8,
    // chunk (u % HD) / 8, at byte 16 u of its slot (the layout of wgmma_common.cuh)
    const bf16* src[SLOTS] = {nullptr, nullptr, nullptr, nullptr};
    if (ens) {
      for (int t = 0; t < 3; ++t) src[t] = nrm + t * stream;
      src[3] = vb;  // null in UPDATE: each stream is its own V
    } else {
      src[0] = static_cast<const bf16*>(a.k) + bh * head;
      src[3] = vb;
    }
    const int pt = threadIdx.x - GROUP * 128;
    int unit_key[UNITS / PT], unit_off[UNITS / PT];
#pragma unroll
    for (int i = 0; i < UNITS / PT; ++i) {
      const int u = pt + PT * i;
      unit_key[i] = (u / HD) * 8 + (u & 7);
      unit_off[i] = unit_key[i] * HD + ((u % HD) >> 3) * 8;
    }
    for (int t = 0; t < KT; ++t) {
      const int stage = t % STAGES, live = L - t * KEYS;
      mbar_wait(empty_bar + stage * 8, ((t / STAGES) & 1) ^ 1);
#pragma unroll
      for (int sl = 0; sl < SLOTS; ++sl) {
        if (src[sl] == nullptr) continue;
        const uint32_t dst = ring + (stage * SLOTS + sl) * TILE + pt * 16;
        const bf16* tile = src[sl] + (size_t)t * KEYS * HD;
#pragma unroll
        for (int i = 0; i < UNITS / PT; ++i) {
          const bool ok = unit_key[i] < live;
          cp_async16(dst + i * PT * 16, ok ? tile + unit_off[i] : src[sl], ok ? 16 : 0);
        }
      }
      // the stage's full barrier counts this thread's arrival once its copies have landed
      asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(full_bar + stage * 8) : "memory");
    }
    cp_async_wait<0>();  // no thread leaves with its copies in flight
    return;
  }

  const int wg = warp >> 2, tid = threadIdx.x & 127;
  const int r0 = (warp & 3) * 16 + (lane >> 2), r1 = r0 + 8, col = (lane & 3) * 2;
  const int qb = (ens ? tile0 : tile0 + wg) * a.rows;  // the warpgroup's first query row
  const bool live0 = r0 < a.rows && qb + r0 < L, live1 = r1 < a.rows && qb + r1 < L;
  const bf16* qsrc = ens ? nrm + wg * stream : static_cast<const bf16*>(a.q) + bh * head;
  const int kslot = ens ? wg : 0, vslot = ens && a.mode == UPDATE ? wg : 3;
  const float c = (ens ? a.temp : a.scale) * LOG2E;

  uint32_t qa[HD / 16][4];
  load_q_fragments<HD>(qa, live0 ? qsrc + (size_t)(qb + r0) * HD : nullptr,
                       live1 ? qsrc + (size_t)(qb + r1) * HD : nullptr, col, 1.f);
  float o[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;
  RowState st;
  uint32_t pa[4][4];
  float s[32];
  for (int t = 0; t < KT; ++t) {
    const int stage = t % STAGES;
    const uint32_t base = ring + stage * SLOTS * TILE;
    mbar_wait(full_bar + stage * 8, (t / STAGES) & 1);
    fence_async_proxy();  // the producers' copies (generic proxy) before wgmma's reads (async proxy)
    scores<HD>(s, qa, base + kslot * TILE);
    softmax_scaled<HD>(s, L - t * KEYS, col, c, st, o, pa);
    accumulate_pv<HD>(o, pa, base + vslot * TILE, 4);
    if (lane == 0) mbar_arrive(empty_bar + stage * 8);
  }
  const float inv0 = 1.f / quad_sum(st.l0), inv1 = 1.f / quad_sum(st.l1);

  // merged heads: row r of head bh at out + ((bh / H) L + r) D + (bh % H) HD
  const size_t D = (size_t)a.H * HD;
  auto merged = [&](void* p, int row, bool ok) -> bf16* {
    return ok ? static_cast<bf16*>(p) + ((size_t)(bh / a.H) * L + row) * D + (bh % a.H) * HD : nullptr;
  };
  if (!ens) {
    store_pairs<HD>(o, inv0, inv1, merged(a.out, qb + r0, live0), merged(a.out, qb + r1, live1), col);
  } else if (a.mode == UPDATE) {  // head-split, stream by stream
    bf16* y = static_cast<bf16*>(a.ens) + wg * stream + bh * head;
    store_pairs<HD>(o, inv0, inv1, live0 ? y + (size_t)(qb + r0) * HD : nullptr,
                    live1 ? y + (size_t)(qb + r1) * HD : nullptr, col);
  } else {
    // the mean of the three streams' f32 outputs: warpgroups 1 and 2 hand theirs to warpgroup 0
    if (wg > 0) {
#pragma unroll
      for (int i = 0; i < HD / 2; ++i) comb[((wg - 1) * (HD / 2) + i) * 128 + tid] = o[i] * (i & 2 ? inv1 : inv0);
    }
    asm volatile("bar.sync %0, %1;\n" ::"n"(COMBINE_BAR), "n"(GROUP * 128) : "memory");
    if (wg == 0) {
#pragma unroll
      for (int i = 0; i < HD / 2; ++i)
        o[i] = (o[i] * (i & 2 ? inv1 : inv0) + comb[i * 128 + tid] + comb[(HD / 2 + i) * 128 + tid]) / 3.f;
      store_pairs<HD>(o, 1.f, 1.f, merged(a.ens, qb + r0, live0), merged(a.ens, qb + r1, live1), col);
    }
  }
}

// ---- the CUDA-core kernel (attention.cu's tiling) ---------------------------------------

constexpr int BQ = 64;        // query rows a block
constexpr int TX = 16;        // threads along keys / output columns
constexpr int TY = 16;        // threads along query rows
constexpr int RPT = BQ / TY;  // query rows a thread
constexpr int CPT = KEYS / TX;
constexpr int LDQ = BQ + 1;   // padded strides: the transposed stores stay free of bank conflicts
constexpr int LDK = KEYS + 1;
constexpr int LDP = KEYS + 1;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(bf16* p, float x) { *p = __float2bfloat16(x); }

template <int HD>
constexpr size_t cc_smem_floats() {
  return (size_t)HD * LDQ + (size_t)HD * LDK + (size_t)KEYS * HD + (size_t)BQ * LDP;
}

template <typename T, int HD>
__global__ void __launch_bounds__(TX * TY) gem_flash_cc(const Args a) {
  constexpr int CPO = (HD + TX - 1) / TX;  // output columns a thread
  constexpr bool ALL_COLS = HD % TX == 0;
  extern __shared__ float fsmem[];
  float* Qt = fsmem;             // [HD][LDQ]
  float* Kt = Qt + HD * LDQ;     // [HD][LDK]
  float* Vs = Kt + HD * LDK;     // [KEYS][HD]
  float* Ps = Vs + KEYS * HD;    // [BQ][LDP]

  const int tx = threadIdx.x, ty = threadIdx.y, tid = ty * TX + tx;
  const int L = a.L;
  const size_t head = (size_t)L * HD, stream = (size_t)a.NH * head;
  const bool ens = (int)blockIdx.x < a.ens_blocks;
  const int job = ens ? blockIdx.x : blockIdx.x - a.ens_blocks;
  const int bh = job / a.qtiles, q0 = (job % a.qtiles) * BQ;
  const size_t D = (size_t)a.H * HD;
  const T* nrm = ens ? static_cast<const T*>(a.nrm) + bh * head : nullptr;

  float acc[RPT][CPO];
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int c = 0; c < CPO; ++c) acc[i][c] = 0.f;

  const int nstreams = ens ? 3 : 1;
  for (int t = 0; t < nstreams; ++t) {
    const T* q = ens ? nrm + t * stream : static_cast<const T*>(a.q) + bh * head;
    const T* k = ens ? q : static_cast<const T*>(a.k) + bh * head;
    const T* v = ens && a.mode == UPDATE ? q : static_cast<const T*>(a.v) + bh * head;
    const float scale = ens ? a.temp : a.scale;

    __syncthreads();  // the previous stream's reads of Qt are done
    for (int idx = tid; idx < BQ * HD; idx += TX * TY) {
      const int r = idx / HD, d = idx % HD, row = q0 + r;
      Qt[d * LDQ + r] = row < L ? to_f32(q[(size_t)row * HD + d]) : 0.f;
    }
    float m[RPT], l[RPT], o[RPT][CPO];
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      m[i] = -INFINITY;
      l[i] = 0.f;
#pragma unroll
      for (int c = 0; c < CPO; ++c) o[i][c] = 0.f;
    }
    for (int k0 = 0; k0 < L; k0 += KEYS) {
      __syncthreads();
      for (int idx = tid; idx < KEYS * HD; idx += TX * TY) {
        const int r = idx / HD, d = idx % HD, key = k0 + r;
        const bool ok = key < L;
        Kt[d * LDK + r] = ok ? to_f32(k[(size_t)key * HD + d]) : 0.f;
        Vs[r * HD + d] = ok ? to_f32(v[(size_t)key * HD + d]) : 0.f;
      }
      __syncthreads();
      float s[RPT][CPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < CPT; ++j) s[i][j] = 0.f;
#pragma unroll 4
      for (int d = 0; d < HD; ++d) {
        float qa[RPT], kb[CPT];
#pragma unroll
        for (int i = 0; i < RPT; ++i) qa[i] = Qt[d * LDQ + ty + TY * i];
#pragma unroll
        for (int j = 0; j < CPT; ++j) kb[j] = Kt[d * LDK + tx + TX * j];
#pragma unroll
        for (int i = 0; i < RPT; ++i)
#pragma unroll
          for (int j = 0; j < CPT; ++j) s[i][j] = fmaf(qa[i], kb[j], s[i][j]);
      }
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        const int r = ty + TY * i;
        float mx = -INFINITY;
#pragma unroll
        for (int j = 0; j < CPT; ++j) {
          s[i][j] = s[i][j] * scale;
          if (k0 + tx + TX * j >= L) s[i][j] = -INFINITY;
          mx = fmaxf(mx, s[i][j]);
        }
#pragma unroll
        for (int off = TX / 2; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
        const float m_new = fmaxf(m[i], mx);
        const float alpha = expf(m[i] - m_new);
        float psum = 0.f;
#pragma unroll
        for (int j = 0; j < CPT; ++j) {
          const float p = expf(s[i][j] - m_new);
          Ps[r * LDP + tx + TX * j] = p;
          psum += p;
        }
#pragma unroll
        for (int off = TX / 2; off > 0; off >>= 1) psum += __shfl_xor_sync(0xffffffffu, psum, off);
        l[i] = l[i] * alpha + psum;
        m[i] = m_new;
#pragma unroll
        for (int c = 0; c < CPO; ++c) o[i][c] *= alpha;
      }
      __syncthreads();
#pragma unroll 4
      for (int kk = 0; kk < KEYS; ++kk) {
        float p[RPT], vv[CPO];
#pragma unroll
        for (int i = 0; i < RPT; ++i) p[i] = Ps[(ty + TY * i) * LDP + kk];
#pragma unroll
        for (int c = 0; c < CPO; ++c) vv[c] = (ALL_COLS || tx + TX * c < HD) ? Vs[kk * HD + tx + TX * c] : 0.f;
#pragma unroll
        for (int i = 0; i < RPT; ++i)
#pragma unroll
          for (int c = 0; c < CPO; ++c) o[i][c] = fmaf(p[i], vv[c], o[i][c]);
      }
    }
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int row = q0 + ty + TY * i;
      const float inv = 1.f / l[i];
#pragma unroll
      for (int c = 0; c < CPO; ++c) {
        const int col = tx + TX * c;
        if (!(ALL_COLS || col < HD) || row >= L) continue;
        if (!ens) {
          store(static_cast<T*>(a.out) + ((size_t)(bh / a.H) * L + row) * D + (bh % a.H) * HD + col, o[i][c] * inv);
        } else if (a.mode == UPDATE) {
          store(static_cast<T*>(a.ens) + t * stream + bh * head + (size_t)row * HD + col, o[i][c] * inv);
        } else {
          acc[i][c] += o[i][c] * inv;
        }
      }
    }
  }
  if (ens && a.mode != UPDATE) {
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int row = q0 + ty + TY * i;
#pragma unroll
      for (int c = 0; c < CPO; ++c) {
        const int col = tx + TX * c;
        if ((ALL_COLS || col < HD) && row < L)
          store(static_cast<T*>(a.ens) + ((size_t)(bh / a.H) * L + row) * D + (bh % a.H) * HD + col, acc[i][c] / 3.f);
      }
    }
  }
}

// ---- launches --------------------------------------------------------------------------

template <typename K>
cudaError_t set_smem(K kern, size_t bytes) {
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(kern, cudaFuncAttributePreferredSharedMemoryCarveout, cudaSharedmemCarveoutMaxShared);
}

template <int HD>
int launch_tc(Args a, cudaStream_t st) {
  // query tiles: L split evenly into the fewest tiles of at most 64 rows that a trunk block's three take whole
  const int tiles = (a.L + KEYS - 1) / KEYS;
  a.qtiles = (tiles + GROUP - 1) / GROUP * GROUP;
  a.rows = (a.L + a.qtiles - 1) / a.qtiles;
  a.ens_blocks = a.mode == TRUNK ? 0 : a.NH * a.qtiles;
  const int blocks = a.ens_blocks + (a.mode == UPDATE ? 0 : a.NH * a.qtiles / GROUP);
  auto kern = gem_flash<HD>;
  cudaError_t err = set_smem(kern, tc_smem_bytes<HD>());
  if (err != cudaSuccess) return (int)err;
  kern<<<blocks, TC_THREADS, tc_smem_bytes<HD>(), st>>>(a);
  return (int)cudaGetLastError();
}

template <typename T, int HD>
int launch_cc(Args a, cudaStream_t st) {
  a.qtiles = (a.L + BQ - 1) / BQ;
  a.rows = BQ;
  a.ens_blocks = a.mode == TRUNK ? 0 : a.NH * a.qtiles;
  const int blocks = a.ens_blocks + (a.mode == UPDATE ? 0 : a.NH * a.qtiles);
  auto kern = gem_flash_cc<T, HD>;
  const size_t bytes = cc_smem_floats<HD>() * sizeof(float);
  cudaError_t err = set_smem(kern, bytes);
  if (err != cudaSuccess) return (int)err;
  kern<<<blocks, dim3(TX, TY), bytes, st>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_cc_hd(Args a, int HD, cudaStream_t st) {
  switch (HD) {
    case 16: return launch_cc<T, 16>(a, st);
    case 32: return launch_cc<T, 32>(a, st);
    case 64: return launch_cc<T, 64>(a, st);
    case 80: return launch_cc<T, 80>(a, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename T, int HD>
int launch_norm(const void* x0, const void* x1, const void* x2, void* out, int rows, cudaStream_t st) {
  constexpr int tpr = pow2_at_least(HD / Vec16<T>::N);
  const size_t threads = (size_t)3 * rows * tpr;
  gem_l2norm_rows<T, HD><<<(unsigned)((threads + 255) / 256), 256, 0, st>>>(
      static_cast<const T*>(x0), static_cast<const T*>(x1), static_cast<const T*>(x2), static_cast<T*>(out), rows);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_norm_hd(const void* x0, const void* x1, const void* x2, void* out, int rows, int HD, cudaStream_t st) {
  switch (HD) {
    case 16: return launch_norm<T, 16>(x0, x1, x2, out, rows, st);
    case 32: return launch_norm<T, 32>(x0, x1, x2, out, rows, st);
    case 64: return launch_norm<T, 64>(x0, x1, x2, out, rows, st);
    case 80: return launch_norm<T, 80>(x0, x1, x2, out, rows, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// 1 where the tensor-core kernel takes a bf16 call of head dim HD.
int hgl_gem_tc_takes(int HD) { return HD == 64 || HD == 80; }

// q, k, v [NH, L, HD] (the trunk's; TRUNK_ENSEMBLE also V of the ensemble),
// nrm [3, NH, L, HD] (the ensemble's unit-norm streams; null in TRUNK), out
// [N, L, H HD] (the trunk's context; unused in UPDATE), ens [N, L, H HD] (the
// ensemble's mean) or, in UPDATE, [3, NH, L, HD]; all of one dtype (is_bf16),
// contiguous, 16-byte aligned. bf16 at HD 64 / 80 runs the tensor-core
// kernel, the rest the CUDA-core one. scale, temp > 0. Returns a cudaError_t
// code (0 = launched).
int hgl_gem_attention(int is_bf16, const void* q, const void* k, const void* v, const void* nrm, void* out, void* ens,
                      int NH, int L, int HD, int H, float scale, float temp, int mode, void* stream) {
  if (NH < 1 || L < 1 || H < 1 || NH % H || mode < TRUNK || mode > UPDATE) return (int)cudaErrorInvalidValue;
  if (HD != 16 && HD != 32 && HD != 64 && HD != 80) return (int)cudaErrorInvalidValue;
  if (!(scale > 0.f) || (mode != TRUNK && !(temp > 0.f))) return (int)cudaErrorInvalidValue;
  Args a{q, k, v, nrm, out, ens, NH, L, H, 0, 0, 0, scale, temp, mode};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16 && hgl_gem_tc_takes(HD)) return HD == 80 ? launch_tc<80>(a, st) : launch_tc<64>(a, st);
  return is_bf16 ? launch_cc_hd<bf16>(a, HD, st) : launch_cc_hd<float>(a, HD, st);
}

// out [3, rows, HD] = x_t / max(|x_t|, 1e-6) row by row, x0, x1, x2 [rows, HD].
int hgl_gem_l2norm(int is_bf16, const void* x0, const void* x1, const void* x2, void* out, int rows, int HD,
                   void* stream) {
  if (rows < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch_norm_hd<bf16>(x0, x1, x2, out, rows, HD, st)
                 : launch_norm_hd<float>(x0, x1, x2, out, rows, HD, st);
}

}  // extern "C"
