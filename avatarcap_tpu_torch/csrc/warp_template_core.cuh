// The 20-layer chain of the warp + template query, as device code shared by
// the port's point and ray kernels: K1 (warp_template_query.cu) runs both
// halves per point, K3 (ray_color_query.cu) per ray sample, K4 and K5
// (template_offset_query.cu) one half each.
//
// The TPU kernels share the same body, avatarcap_tpu/ops/pallas_query.py:
// _warp_template_core (:255-296); _offset_kernel (:115-129) and
// _template_kernel (:53-81) are its two halves.
//
// A block owns a tile of kTile = 128 points, 64 per consumer warpgroup. A
// warpgroup keeps its rows' hidden activations in registers for the whole
// chain; only the two kinds of input that the concats need again live in
// shared memory, as bf16 panels of 128 rows (panel_off):
//   - offset_decoder: input x = [bf16 pts (3), pose features (64)] in the
//     x panel's columns [0, 67) with [67, 80) zero; OffsetDecoder (eval BN
//     folded) = 4 x (Linear 256, softplus), skip concat [x, h] (323
//     channels, walked as 80 + 256), 3 x (Linear 256, softplus), Linear 3
//     -> f32 offset in s_off [T][3];
//   - template_mlp: input the PE(10) of the f32 point (pe_coord) in the pe
//     panel's columns [0, 63) with column 63 zero; 4 x (Linear 256, ReLU),
//     res concat [h, pe] (319, walked as 256 + 64), 2 x (Linear 256, ReLU),
//     Linear 256 (no activation) -> feat; geo: Linear 128 + leaky 0.02,
//     Linear 2 -> s_geo [T][2]; color: Linear 256 + ReLU, Linear 128 + ReLU,
//     Linear 3 -> s_clr [T][3], before the sigmoid.
// Rounding points are those of the TPU kernels: every product takes bf16
// operands and accumulates in f32, the f32 bias added after; every
// activation is rounded to bf16 after its nonlinearity; the PE uses the
// accurate sinf/cosf (its arguments reach hundreds of radians at 2^9 x,
// where the fast intrinsics lose accuracy; never build with fast math).
// softplus = logaddexp(x, 0) in f32 from the hardware's ex2 approximation
// and a polynomial (softplus_bf16_grade), within 2^-19 of the accurate
// value before the bf16 rounding.
//
// How a layer runs on an H100 (wgmma, the weight image streamed through a
// ring of shared-memory stages by a producer warpgroup, hidden activations
// in registers): chunk_ring.cuh, which this chain shares with K2.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "chunk_ring.cuh"

namespace {

constexpr int kXCols = 80;                   // x panel: 67 inputs, padded
constexpr int kPeCols = 64;                  // pe panel: 63 encodings, padded
constexpr int kFreqs = 10;

constexpr size_t kXPanelBytes = sizeof(__nv_bfloat16) * kTile * kXCols;
constexpr size_t kPePanelBytes = sizeof(__nv_bfloat16) * kTile * kPeCols;

static_assert(kXPanelBytes % 128 == 0 && kPePanelBytes % 128 == 0,
              "the ring follows the panels, 16-byte aligned");

// The weight image (ops/fused_query.py: weight_image states the same
// numbers; tests/test_torch_fused_query.py holds the two together).
// offset half: layers 0-6 (K 80, 256, 256, 256, 336, 256, 256), then the
// 3 x 256 head, row-major
constexpr int kOffsetChunks = 106;
constexpr int kOffsetHeadElem = kOffsetChunks * kChunkElems256;
constexpr int kOffsetImageElems = kOffsetHeadElem + 3 * 256;
// template half: layers 0-6 (K 64, 256, 256, 256, 320, 256, 256), geo 0
// (O = 128), color 0, color 1 (O = 128), then the 2 x 128 and 3 x 128 heads
constexpr int kTemplateSharedChunks = 104;
constexpr int kTemplateChunks = 152;
constexpr int kTemplateGeoHeadElem =
    (kTemplateSharedChunks + 16) * kChunkElems256 + 32 * kChunkElems128;
constexpr int kTemplateClrHeadElem = kTemplateGeoHeadElem + 2 * 128;
constexpr int kTemplateImageElems = kTemplateClrHeadElem + 3 * 128;
// f32 biases of a half, layer after layer, each padded to 4 floats
constexpr int kOffsetBiasFloats = 7 * 256 + 4;
constexpr int kTemplateBiasFloats = 7 * 256 + 128 + 4 + 256 + 128 + 4;

static_assert(kOffsetImageElems % 8 == 0 && kOffsetBiasFloats % 4 == 0,
              "the template half must start 16-byte aligned in a joint image");

// One half of the image: chunks then heads, and its biases.
struct HalfWeights {
  const __nv_bfloat16* image;
  const float* bias;
};

// Both halves, as a joint image (offset half then template half) holds them.
struct ChainWeights {
  HalfWeights off, tpl;
};

__host__ inline ChainWeights chain_weights(const void* image, const void* bias) {
  const __nv_bfloat16* img = static_cast<const __nv_bfloat16*>(image);
  const float* b = static_cast<const float*>(bias);
  return ChainWeights{{img, b}, {img + kOffsetImageElems, b + kOffsetBiasFloats}};
}

// ---- the producer's stream -----------------------------------------------

__device__ __forceinline__ void produce_offset(Ring& r, const HalfWeights& w) {
  const unsigned char* src = reinterpret_cast<const unsigned char*>(w.image);
  produce_run(r, src, kOffsetChunks, 2 * kChunkElems256);
}

__device__ __forceinline__ void produce_template(Ring& r, const HalfWeights& w) {
  const unsigned char* src = reinterpret_cast<const unsigned char*>(w.image);
  produce_run(r, src, kTemplateSharedChunks, 2 * kChunkElems256);
  produce_run(r, src, 16, 2 * kChunkElems128);   // geo 0
  produce_run(r, src, 16, 2 * kChunkElems256);   // color 0
  produce_run(r, src, 16, 2 * kChunkElems128);   // color 1
}

// ---- the chain -----------------------------------------------------------

// K3's second warpgroup starts this many chunks after the first
// (first_products' skew): it pays off over the 64 samples of a ray tile,
// not over one pass of the chain (K1, K4, K5 start together).
constexpr int kSkewChunks = 13;
static_assert(kSkewChunks + 4 <= kStages, "the lead must leave the ring room to prefetch");

// Zero the x panel's pad columns [67, 80) of this warp's 16 rows.
__device__ __forceinline__ void zero_input_pad(__nv_bfloat16* xs) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const __nv_bfloat16 zero = __float2bfloat16_rn(0.f);
  for (int i = lane; i < 16 * 13; i += 32) {
    const int r = i / 13, c = i - 13 * r;
    xs[panel_off(warp * 16 + r, 67 + c)] = zero;
  }
}

// OffsetDecoder + head on the x panel (rows of warpgroup wm, written, fenced
// and followed by group_sync by the caller) -> s_off [T][3] (f32), its 106
// chunks taken from the ring. Each warp writes its own 16 rows of s_off and
// ends with __syncwarp. Layers 1-6 share one body (a loop that is not
// unrolled: each body is 16-21 wgmma statements of 130 operands).
__device__ __forceinline__ void offset_decoder(const __nv_bfloat16* xs, int wm, Products& p,
                                               const HalfWeights& wt, float* s_off) {
  const float* b = wt.bias;
  uint32_t h[64];
  float acc[128];
  products_from_panel<kXCols / kChunkK>(acc, xs, wm, p, 0);
  products_done(acc);
  epilogue<256, kSoftplus>(acc, h, b);
#pragma unroll 1
  for (int layer = 1; layer < 7; ++layer) {
    // layer 4: skip concat [x (67, padded to 80), h (256)]; the two calls
    // differ in a compile-time flag only (a run-time one costs registers:
    // ptxas then spills)
    if (layer == 4) {
      products_from_panel<kXCols / kChunkK>(acc, xs, wm, p, 0);
      products_from_registers<256, 16>(acc, h, p, 1, wm);
    } else {
      products_from_registers<256, 16, kSkewChunks - kXCols / kChunkK>(acc, h, p, 0, wm);
    }
    products_done(acc);
    epilogue<256, kSoftplus>(acc, h, b + 256 * layer);
  }
  head_layer<16, 3>(h, wt.image + kOffsetHeadElem, b + 1792, s_off);
  __syncwarp();
}

// PE(10) of coordinate c of the f32 point of row r, into the pe panel:
// [x, sin x, cos x, sin 2x, cos 2x, ...] interleaved over x, y, z.
__device__ __forceinline__ void pe_coord(__nv_bfloat16* pe, int r, int c, float x) {
  pe[panel_off(r, c)] = __float2bfloat16_rn(x);
  float scale = 1.f;
#pragma unroll
  for (int k = 0; k < kFreqs; ++k) {
    const float xf = x * scale;
    pe[panel_off(r, 3 + 6 * k + c)] = __float2bfloat16_rn(sinf(xf));
    pe[panel_off(r, 6 + 6 * k + c)] = __float2bfloat16_rn(cosf(xf));
    scale *= 2.f;
  }
}

// Zero the pe panel's pad column 63 of this warp's 16 rows.
__device__ __forceinline__ void zero_pe_pad(__nv_bfloat16* pe) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane < 16) pe[panel_off(warp * 16 + lane, 63)] = __float2bfloat16_rn(0.f);
}

// DoubleTNet on the pe panel (rows of warpgroup wm, written, fenced and
// followed by group_sync by the caller) -> s_geo [T][2] and the color logits
// s_clr [T][3] (f32), its 152 chunks taken from the ring. Each warp writes
// its own 16 rows and ends with __syncwarp. Layers 1-6 of the shared MLP
// share one body, as in offset_decoder.
__device__ __forceinline__ void template_mlp(const __nv_bfloat16* pe, int wm, Products& p,
                                             const HalfWeights& wt, float* s_geo,
                                             float* s_clr) {
  const float* b = wt.bias;
  uint32_t h[64], hs[32];
  float acc[128], acc_s[64];
  products_from_panel<kPeCols / kChunkK>(acc, pe, wm, p, 0);
  products_done(acc);
  epilogue<256, kFloor>(acc, h, b);
#pragma unroll 1
  for (int layer = 1; layer < 7; ++layer) {
    products_from_registers<256, 16, kSkewChunks - kPeCols / kChunkK>(acc, h, p, 0, wm);
    // layer 4: res concat [h (256), pe (63, padded to 64)]
    if (layer == 4) products_from_panel<kPeCols / kChunkK>(acc, pe, wm, p, 1);
    products_done(acc);
    // layers 1-5 ReLU; layer 6 (feat) has no activation
    epilogue<256, kFloor>(acc, h, b + 256 * layer, layer == 6 ? -INFINITY : 0.f);
  }

  // geometry head
  products_from_registers<128, 16>(acc_s, h, p, 0);
  products_done(acc_s);
  epilogue<128, kLeaky>(acc_s, hs, b + 1792);
  head_layer<8, 2>(hs, wt.image + kTemplateGeoHeadElem, b + 1920, s_geo);
  // color head
  products_from_registers<256, 16>(acc, h, p, 0);
  products_done(acc);
  epilogue<256, kFloor>(acc, h, b + 1924);
  products_from_registers<128, 16>(acc_s, h, p, 0);
  products_done(acc_s);
  epilogue<128, kFloor>(acc_s, hs, b + 2180);
  head_layer<8, 3>(hs, wt.image + kTemplateClrHeadElem, b + 2308, s_clr);
  __syncwarp();
}

}  // namespace
