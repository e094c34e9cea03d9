// The 20-layer chain of the warp + template query, as device code shared by
// the port's point and ray kernels: K1 (warp_template_query.cu) runs both
// halves per point, K3 (ray_color_query.cu) per ray sample, K4 and K5
// (template_offset_query.cu) one half each.
//
// The TPU kernels share the same body, avatarcap_tpu/ops/pallas_query.py:
// _warp_template_core (:255-296); _offset_kernel (:115-129) and
// _template_kernel (:53-81) are its two halves.
//
// A block owns a tile of kTile = 128 points and two ping-pong bf16
// activation panels pa, pb [128][kStride] in shared memory:
//   - offset_decoder: input x = [bf16 pts (3), pose features (64)] in
//     pa[:, 0:67] with pa[:, 67:80] zero; the hidden layers use columns
//     [80, 336) of both panels, so x stays in place for the skip concat
//     [x, h] (323 channels, walked as 336 with the 67..79 pad); OffsetDecoder
//     (eval BN folded) = 4 x (Linear 256, softplus), concat, 3 x (Linear 256,
//     softplus), Linear 3 -> f32 offset in s_off [T][3];
//   - template_mlp: input the PE(10) of the f32 point (pe_coord) in
//     pa[:, 256:319] with column 319 zero; the shared MLP uses columns
//     [0, 256), so the PE stays in place for the res concat [h, pe] (319,
//     walked as 320); 4 x (Linear 256, ReLU), concat, 2 x (Linear 256, ReLU),
//     Linear 256 (no activation) -> feat; geo: Linear 128 + leaky 0.02,
//     Linear 2 -> s_geo [T][2]; color: Linear 256 + ReLU, Linear 128 + ReLU,
//     Linear 3 -> s_clr [T][3], before the sigmoid.
// Rounding points are those of the TPU kernels: every product takes bf16
// operands and accumulates in f32, the f32 bias added after; every
// activation is rounded to bf16 after its nonlinearity; softplus =
// logaddexp(x, 0) in f32; the PE uses the accurate sinf/cosf (its arguments
// reach hundreds of radians at 2^9 x, where the fast intrinsics lose
// accuracy; never build with fast math).
//
// Each layer is a [128 x K] x [K x O] product on mma.sync m16n8k16 bf16
// instructions with f32 accumulators: the 8 warps split the O columns, each
// covering all 128 rows, and the epilogue (bias, activation, bf16 rounding)
// runs on the accumulator registers and writes the next panel. The ~2 MB of
// weights do not fit in shared memory (227 KB a block): each warp streams
// its B fragments from the 50 MB L2, one k-step ahead of the products
// (register double buffer). The B-fragment loader maps a zero-padded K
// column to its real weight column or to zero, so the packed (O, I) weights
// are used as they are. The panel row stride of 344 bf16 (172 words) keeps
// the fragment loads and stores free of bank conflicts.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace {

constexpr int kTile = 128;                   // points per block
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kMTiles = kTile / 16;          // m16 row tiles per panel
constexpr int kStride = 344;                 // bf16 per panel row
constexpr int kFreqs = 10;
constexpr int kOffsetLayers = 8;
constexpr int kTemplateLayers = 12;

constexpr size_t kPanelBytes = sizeof(__nv_bfloat16) * kTile * kStride;

static_assert((kStride / 2) % 8 == 4, "panel stride must avoid bank conflicts");

struct OffsetWeights {
  const __nv_bfloat16* w[kOffsetLayers];     // (O, I) row-major
  const float* b[kOffsetLayers];             // (O,)
};

struct TemplateWeights {
  const __nv_bfloat16* w[kTemplateLayers];
  const float* b[kTemplateLayers];
};

// (weight, bias) pointer pairs in the order of ops/fused_query.py's packers.
__host__ inline OffsetWeights offset_weights(const void* const* ptrs) {
  OffsetWeights wt;
  for (int i = 0; i < kOffsetLayers; ++i) {
    wt.w[i] = static_cast<const __nv_bfloat16*>(ptrs[2 * i]);
    wt.b[i] = static_cast<const float*>(ptrs[2 * i + 1]);
  }
  return wt;
}

__host__ inline TemplateWeights template_weights(const void* const* ptrs) {
  TemplateWeights wt;
  for (int i = 0; i < kTemplateLayers; ++i) {
    wt.w[i] = static_cast<const __nv_bfloat16*>(ptrs[2 * i]);
    wt.b[i] = static_cast<const float*>(ptrs[2 * i + 1]);
  }
  return wt;
}

enum Act { kSoftplus = 0, kRelu = 1, kLeaky = 2, kNone = 3 };

template <int ACT>
__device__ __forceinline__ float activate(float x) {
  if constexpr (ACT == kSoftplus) {
    return fmaxf(x, 0.f) + log1pf(expf(-fabsf(x)));  // logaddexp(x, 0)
  } else if constexpr (ACT == kRelu) {
    return fmaxf(x, 0.f);
  } else if constexpr (ACT == kLeaky) {
    return x >= 0.f ? x : 0.02f * x;
  } else {
    return x;
  }
}

// Padded activation column kp -> real weight column, or -1 for a zero pad.
// Columns [0, SEG0) map to themselves, [SEG0, PAD0) are padding, and
// [PAD0, ...) map to SEG0, SEG0 + 1, ... while below KREAL.
template <int KREAL, int SEG0, int PAD0>
__device__ __forceinline__ int weight_col(int kp) {
  if (kp < PAD0) return kp < SEG0 ? kp : -1;
  const int k = kp - PAD0 + SEG0;
  return k < KREAL ? k : -1;
}

// Two consecutive bf16 of weight row n at padded columns kp, kp + 1
// (kp even), packed low-first as the mma B fragment wants them.
template <int KREAL, int SEG0, int PAD0>
__device__ __forceinline__ uint32_t load_b_pair(const __nv_bfloat16* __restrict__ w,
                                                int n, int out_dim, int kp) {
  if (n >= out_dim) return 0u;
  const __nv_bfloat16* row = w + static_cast<size_t>(n) * KREAL;
  if constexpr (KREAL % 2 == 0 && SEG0 == PAD0) {
    if (kp < KREAL) return __ldg(reinterpret_cast<const unsigned int*>(row + kp));
    return 0u;
  } else {
    const int k0 = weight_col<KREAL, SEG0, PAD0>(kp);
    const int k1 = weight_col<KREAL, SEG0, PAD0>(kp + 1);
    const uint32_t lo = k0 >= 0 ? __ldg(reinterpret_cast<const unsigned short*>(row + k0)) : 0u;
    const uint32_t hi = k1 >= 0 ? __ldg(reinterpret_cast<const unsigned short*>(row + k1)) : 0u;
    return lo | (hi << 16);
  }
}

// One hidden layer: out[:, co:co+O] = bf16(act(in[:, ci:ci+KPAD] W^T + b)).
// The 8 warps split the O output columns; each warp covers all 128 rows.
template <int KPAD, int KREAL, int SEG0, int PAD0, int O, int ACT>
__device__ __forceinline__ void dense_layer(const __nv_bfloat16* in, int ci,
                                            __nv_bfloat16* out, int co,
                                            const __nv_bfloat16* __restrict__ w,
                                            const float* __restrict__ bias) {
  constexpr int kNT = O / 8 / kWarps;       // n8 tiles per warp
  constexpr int kKSteps = KPAD / 16;
  static_assert(kNT >= 1 && kNT * 8 * kWarps == O, "O must split over warps");
  static_assert(KPAD % 16 == 0, "K must be padded to 16");
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int n0 = warp * kNT * 8;

  float acc[kMTiles][kNT][4];
#pragma unroll
  for (int m = 0; m < kMTiles; ++m)
#pragma unroll
    for (int n = 0; n < kNT; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[m][n][i] = 0.f;

  uint32_t bcur[kNT][2], bnext[kNT][2];
#pragma unroll
  for (int n = 0; n < kNT; ++n) {
    bcur[n][0] = load_b_pair<KREAL, SEG0, PAD0>(w, n0 + n * 8 + g, O, 2 * t);
    bcur[n][1] = load_b_pair<KREAL, SEG0, PAD0>(w, n0 + n * 8 + g, O, 2 * t + 8);
  }
#pragma unroll 1
  for (int ks = 0; ks < kKSteps; ++ks) {
    if (ks + 1 < kKSteps) {
      const int kb = (ks + 1) * 16 + 2 * t;
#pragma unroll
      for (int n = 0; n < kNT; ++n) {
        bnext[n][0] = load_b_pair<KREAL, SEG0, PAD0>(w, n0 + n * 8 + g, O, kb);
        bnext[n][1] = load_b_pair<KREAL, SEG0, PAD0>(w, n0 + n * 8 + g, O, kb + 8);
      }
    }
#pragma unroll
    for (int m = 0; m < kMTiles; ++m) {
      uint32_t a[4];
      load_a<kStride>(a, in, m * 16 + g, ci + ks * 16 + 2 * t);
#pragma unroll
      for (int n = 0; n < kNT; ++n) mma16816(acc[m][n], a, bcur[n][0], bcur[n][1]);
    }
#pragma unroll
    for (int n = 0; n < kNT; ++n) {
      bcur[n][0] = bnext[n][0];
      bcur[n][1] = bnext[n][1];
    }
  }

#pragma unroll
  for (int n = 0; n < kNT; ++n) {
    const int col = n0 + n * 8 + 2 * t;
    const float b0 = __ldg(bias + col), b1 = __ldg(bias + col + 1);
#pragma unroll
    for (int m = 0; m < kMTiles; ++m) {
      const int row = m * 16 + g;
      const __nv_bfloat162 lo = __floats2bfloat162_rn(
          activate<ACT>(acc[m][n][0] + b0), activate<ACT>(acc[m][n][1] + b1));
      const __nv_bfloat162 hi = __floats2bfloat162_rn(
          activate<ACT>(acc[m][n][2] + b0), activate<ACT>(acc[m][n][3] + b1));
      *reinterpret_cast<__nv_bfloat162*>(out + row * kStride + co + col) = lo;
      *reinterpret_cast<__nv_bfloat162*>(out + (row + 8) * kStride + co + col) = hi;
    }
  }
}

// An output head with O <= 8 columns (f32, no activation): warp w computes
// rows [16 w, 16 w + 16) of one n8 tile and writes dst[row * O + col].
template <int K, int O>
__device__ __forceinline__ void head_layer(const __nv_bfloat16* in, int ci,
                                           const __nv_bfloat16* __restrict__ w,
                                           const float* __restrict__ bias,
                                           float* dst) {
  static_assert(O <= 8 && K % 16 == 0 && kMTiles == kWarps, "head shape");
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
  for (int ks = 0; ks < K / 16; ++ks) {
    const int kb = ks * 16 + 2 * t;
    const uint32_t b0 = load_b_pair<K, K, K>(w, g, O, kb);
    const uint32_t b1 = load_b_pair<K, K, K>(w, g, O, kb + 8);
    uint32_t a[4];
    load_a<kStride>(a, in, warp * 16 + g, ci + ks * 16 + 2 * t);
    mma16816(acc, a, b0, b1);
  }
  const int row = warp * 16 + g;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int col = 2 * t + i;
    if (col < O) {
      const float b = __ldg(bias + col);
      dst[row * O + col] = acc[i] + b;
      dst[(row + 8) * O + col] = acc[2 + i] + b;
    }
  }
}

// Zero the decoder input's pad columns pa[:, 67:80].
__device__ __forceinline__ void zero_input_pad(__nv_bfloat16* pa) {
  const __nv_bfloat16 zero = __float2bfloat16_rn(0.f);
  for (int i = threadIdx.x; i < kTile * 13; i += kThreads) {
    const int r = i / 13, c = i - 13 * r;
    pa[r * kStride + 67 + c] = zero;
  }
}

// OffsetDecoder + head on x = pa[:, 0:80] -> s_off [T][3] (f32). Ends with
// a barrier; pa[:, 0:80] is left as it was.
__device__ __forceinline__ void offset_decoder(__nv_bfloat16* pa, __nv_bfloat16* pb,
                                               const OffsetWeights& wt, float* s_off) {
  dense_layer<80, 67, 67, 80, 256, kSoftplus>(pa, 0, pb, 80, wt.w[0], wt.b[0]);
  __syncthreads();
  dense_layer<256, 256, 256, 256, 256, kSoftplus>(pb, 80, pa, 80, wt.w[1], wt.b[1]);
  __syncthreads();
  dense_layer<256, 256, 256, 256, 256, kSoftplus>(pa, 80, pb, 80, wt.w[2], wt.b[2]);
  __syncthreads();
  dense_layer<256, 256, 256, 256, 256, kSoftplus>(pb, 80, pa, 80, wt.w[3], wt.b[3]);
  __syncthreads();
  // skip concat [x (67), h (256)] = pa[:, 0:336] with the 67..79 pad
  dense_layer<336, 323, 67, 80, 256, kSoftplus>(pa, 0, pb, 80, wt.w[4], wt.b[4]);
  __syncthreads();
  dense_layer<256, 256, 256, 256, 256, kSoftplus>(pb, 80, pa, 80, wt.w[5], wt.b[5]);
  __syncthreads();
  dense_layer<256, 256, 256, 256, 256, kSoftplus>(pa, 80, pb, 80, wt.w[6], wt.b[6]);
  __syncthreads();
  head_layer<256, 3>(pb, 80, wt.w[7], wt.b[7], s_off);
  __syncthreads();
}

// PE(10) of coordinate c of an f32 point, into its panel row (from column
// 256): [x, sin x, cos x, sin 2x, cos 2x, ...] interleaved over x, y, z.
__device__ __forceinline__ void pe_coord(__nv_bfloat16* row, int c, float x) {
  row[c] = __float2bfloat16_rn(x);
  float scale = 1.f;
#pragma unroll
  for (int k = 0; k < kFreqs; ++k) {
    const float xf = x * scale;
    row[3 + 6 * k + c] = __float2bfloat16_rn(sinf(xf));
    row[6 + 6 * k + c] = __float2bfloat16_rn(cosf(xf));
    scale *= 2.f;
  }
}

// Zero the PE's pad column pa[:, 319].
__device__ __forceinline__ void zero_pe_pad(__nv_bfloat16* pa) {
  const __nv_bfloat16 zero = __float2bfloat16_rn(0.f);
  for (int r = threadIdx.x; r < kTile; r += kThreads) pa[r * kStride + 319] = zero;
}

// DoubleTNet on the PE in pa[:, 256:320] -> s_geo [T][2] and the color
// logits s_clr [T][3] (f32). Ends with a barrier.
__device__ __forceinline__ void template_mlp(__nv_bfloat16* pa, __nv_bfloat16* pb,
                                             const TemplateWeights& wt, float* s_geo,
                                             float* s_clr) {
  // shared MLP: hidden panel columns [0, 256); pe at [256, 320)
  dense_layer<64, 63, 63, 64, 256, kRelu>(pa, 256, pb, 0, wt.w[0], wt.b[0]);
  __syncthreads();
  dense_layer<256, 256, 256, 256, 256, kRelu>(pb, 0, pa, 0, wt.w[1], wt.b[1]);
  __syncthreads();
  dense_layer<256, 256, 256, 256, 256, kRelu>(pa, 0, pb, 0, wt.w[2], wt.b[2]);
  __syncthreads();
  dense_layer<256, 256, 256, 256, 256, kRelu>(pb, 0, pa, 0, wt.w[3], wt.b[3]);
  __syncthreads();
  // res concat [h (256), pe (63)] = pa[:, 0:320] with column 319 zero
  dense_layer<320, 319, 319, 320, 256, kRelu>(pa, 0, pb, 0, wt.w[4], wt.b[4]);
  __syncthreads();
  dense_layer<256, 256, 256, 256, 256, kRelu>(pb, 0, pa, 0, wt.w[5], wt.b[5]);
  __syncthreads();
  dense_layer<256, 256, 256, 256, 256, kNone>(pa, 0, pb, 0, wt.w[6], wt.b[6]);
  __syncthreads();                                            // feat in pb

  // geometry head
  dense_layer<256, 256, 256, 256, 128, kLeaky>(pb, 0, pa, 0, wt.w[7], wt.b[7]);
  __syncthreads();
  head_layer<128, 2>(pa, 0, wt.w[8], wt.b[8], s_geo);
  __syncthreads();
  // color head
  dense_layer<256, 256, 256, 256, 256, kRelu>(pb, 0, pa, 0, wt.w[9], wt.b[9]);
  __syncthreads();
  dense_layer<256, 256, 256, 256, 128, kRelu>(pa, 0, pb, 0, wt.w[10], wt.b[10]);
  __syncthreads();
  head_layer<128, 3>(pb, 0, wt.w[11], wt.b[11], s_clr);
  __syncthreads();
}

__device__ __forceinline__ float sigmoidf_accurate(float x) {
  return 1.f / (1.f + expf(-x));
}

}  // namespace
