// Arguments of the decoder cross-attention kernels, shared by the CUDA-core
// kernel (decoder_attn.cu) and the tensor-core kernel (decoder_attn_wgmma.cu).

#pragma once

enum DecoderAttnMode { I2T = 0, T2I = 1, PASS = 2 };

struct DecoderAttnParams {
  const void* qside;  // [1|B, S, Cq] T   (T2I: the keys [B, S, C])
  const void* base;   // [1|B, S, C] T    (I2T/PASS residual base)
  const void* pe;     // [1|B, S, C] T    (or null in I2T without pe)
  const void* w;      // [B, Cq, GT]      f32; T on the tensor-core path
  const float* off;   // [B, GT]
  const void* vo;     // [B, GT, C] T
  const float* cnst;  // [C]
  const float* ln_s;  // [C]
  const float* ln_b;  // [C]
  const void* qw;     // [B, C, GT2] f32; transposed, [B, GT2, C] T, on the tensor-core path
  void* keys_out;     // [B, S, C] T
  float* part_m;      // [B, nsplit, GT2]
  float* part_l;      // [B, nsplit, GT2]
  float* part_acc;    // [B, nsplit, GT2, C]
  int B, S, Cq, C, heads, tp, GT2, nsplit;
  int q_bcast, base_bcast, pe_bcast, add_pe;
};
