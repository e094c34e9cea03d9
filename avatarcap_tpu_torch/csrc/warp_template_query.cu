// Fused warp-offset decode + positional encoding + DoubleTNet template
// query, one CUDA kernel for Hopper (sm_90a).
//
// Replaces the Pallas kernel avatarcap_tpu/ops/pallas_query.py:
// warp_template_query_fused (pallas_call at :341; body _full_query_kernel
// :299 -> _warp_template_core :255-296). Per point it computes
//   x   = [bf16(pts) (3), pose_feat (64)]                      67
//   OffsetDecoder (eval BN folded into the packed weights):
//       4 x (Linear 256, softplus), concat [x, h] (323),
//       3 x (Linear 256, softplus), Linear 3 -> offset (f32)
//   wpts = pts + offset (f32); PE(10) of wpts -> 63
//   template: 4 x (Linear 256, ReLU), concat [h, pe] (319),
//       2 x (Linear 256, ReLU), Linear 256 (fc6, no activation) -> feat
//   geo: Linear 128 + leaky 0.02, Linear 2;  color: Linear 256 + ReLU,
//       Linear 128 + ReLU, Linear 3 + sigmoid
//   outputs occ = geo[0], alpha = relu(geo[1]), rgb, offset (all f32).
// Rounding points are those of the TPU kernel: every product takes bf16
// operands and accumulates in f32; every activation is rounded to bf16
// after its nonlinearity; the points are rounded to bf16 only for the
// decoder input; the PE is built from the f32 warped points with the
// accurate sinf/cosf (the arguments reach hundreds of radians at 2^9 x,
// where the fast intrinsics lose accuracy; never build with fast math).
//
// What bounds it on an H100: operations. ~1.97 MFLOP per point against
// ~172 B of input and output per point, ~11,000 FLOP per byte, far above
// the card's ~295 FLOP/B ridge. So the design keeps all work on tensor
// cores and every intermediate on chip:
//   - a block owns a tile of 128 points; its activations live in shared
//     memory as two ping-pong bf16 panels [128][344] (the row stride of
//     172 words keeps the mma fragment loads and stores bank-conflict
//     free) for the whole 20-layer chain, so device memory sees only the
//     points, the pose features and the 8 output floats per point;
//   - each layer is a [128 x K] x [K x O] product on mma.sync
//     m16n8k16 bf16 tensor-core instructions with f32 accumulators; the
//     8 warps split the O columns, the epilogue (bias, activation, bf16
//     rounding) runs on the accumulator registers and writes the next
//     panel directly;
//   - the ~2 MB of weights do not fit in shared memory (227 KB a block):
//     each warp streams its B fragments from the 50 MB L2, which holds
//     all of them, one k-step ahead of the products (register double
//     buffer), so every weight byte is fetched once per 128-point tile;
//   - the two skip-concats (323 and 319 channels) and the 67/63-channel
//     inputs are zero-padded in K inside the kernel: the activation panels
//     keep aligned column blocks, and the B-fragment loader maps a padded
//     column to its real weight column or to zero, so the packed (O, I)
//     weights are used as they are;
//   - the ragged tail is masked in the kernel (rows past N read zeros and
//     are never stored).
// A simple first version: no wgmma, TMA or warp specialisation yet.

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
constexpr int kLayers = 20;
constexpr int kFreqs = 10;

constexpr size_t kPanelBytes = sizeof(__nv_bfloat16) * kTile * kStride;
constexpr size_t kScalarFloats = kTile * (3 + 3 + 2 + 3);
constexpr size_t kSmemBytes = 2 * kPanelBytes + sizeof(float) * kScalarFloats;

static_assert(kSmemBytes <= 232448, "shared memory per block exceeded");
static_assert((kStride / 2) % 8 == 4, "panel stride must avoid bank conflicts");

struct Weights {
  const __nv_bfloat16* w[kLayers];   // (O, I) row-major
  const float* b[kLayers];           // (O,)
};

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

__global__ void __launch_bounds__(kThreads, 1)
warp_template_query_kernel(const float* __restrict__ pts,
                           const __nv_bfloat16* __restrict__ pose_feat, int n,
                           Weights wt, float* __restrict__ occ,
                           float* __restrict__ alpha, float* __restrict__ rgb,
                           float* __restrict__ offset) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* pa = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* pb = pa + kTile * kStride;
  float* s_pts = reinterpret_cast<float*>(pb + kTile * kStride);  // [T][3]
  float* s_off = s_pts + kTile * 3;                                // [T][3]
  float* s_geo = s_off + kTile * 3;                                // [T][2]
  float* s_clr = s_geo + kTile * 2;                                // [T][3]
  const int base = blockIdx.x * kTile;
  const __nv_bfloat16 zero = __float2bfloat16_rn(0.f);

  // decoder input x = [bf16(pts), pose_feat] in pa[:, 0:67], zero to 80
  for (int i = threadIdx.x; i < kTile * 3; i += kThreads) {
    const int r = i / 3, c = i - 3 * r;
    const float v = base + r < n ? pts[static_cast<size_t>(base + r) * 3 + c] : 0.f;
    s_pts[i] = v;
    pa[r * kStride + c] = __float2bfloat16_rn(v);
  }
  for (int i = threadIdx.x; i < kTile * 64; i += kThreads) {
    const int r = i >> 6, c = i & 63;
    pa[r * kStride + 3 + c] =
        base + r < n ? pose_feat[static_cast<size_t>(base + r) * 64 + c] : zero;
  }
  for (int i = threadIdx.x; i < kTile * 13; i += kThreads) {
    const int r = i / 13, c = i - 13 * r;
    pa[r * kStride + 67 + c] = zero;
  }
  __syncthreads();

  // OffsetDecoder: hidden panel columns [80, 336); x stays in pa[:, 0:80]
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

  // warp in f32, PE(10) of the warped points into pa[:, 256:320]
  for (int i = threadIdx.x; i < kTile * 3; i += kThreads) {
    const int r = i / 3, c = i - 3 * r;
    const float wp = s_pts[i] + s_off[i];
    __nv_bfloat16* row = pa + r * kStride + 256;
    row[c] = __float2bfloat16_rn(wp);
    float scale = 1.f;
#pragma unroll
    for (int k = 0; k < kFreqs; ++k) {
      const float xf = wp * scale;
      row[3 + 6 * k + c] = __float2bfloat16_rn(sinf(xf));
      row[6 + 6 * k + c] = __float2bfloat16_rn(cosf(xf));
      scale *= 2.f;
    }
  }
  for (int r = threadIdx.x; r < kTile; r += kThreads) pa[r * kStride + 319] = zero;
  __syncthreads();

  // template shared MLP: hidden panel columns [0, 256); pe at [256, 320)
  dense_layer<64, 63, 63, 64, 256, kRelu>(pa, 256, pb, 0, wt.w[8], wt.b[8]);
  __syncthreads();
  dense_layer<256, 256, 256, 256, 256, kRelu>(pb, 0, pa, 0, wt.w[9], wt.b[9]);
  __syncthreads();
  dense_layer<256, 256, 256, 256, 256, kRelu>(pa, 0, pb, 0, wt.w[10], wt.b[10]);
  __syncthreads();
  dense_layer<256, 256, 256, 256, 256, kRelu>(pb, 0, pa, 0, wt.w[11], wt.b[11]);
  __syncthreads();
  // res concat [h (256), pe (63)] = pa[:, 0:320] with column 319 zero
  dense_layer<320, 319, 319, 320, 256, kRelu>(pa, 0, pb, 0, wt.w[12], wt.b[12]);
  __syncthreads();
  dense_layer<256, 256, 256, 256, 256, kRelu>(pb, 0, pa, 0, wt.w[13], wt.b[13]);
  __syncthreads();
  dense_layer<256, 256, 256, 256, 256, kNone>(pa, 0, pb, 0, wt.w[14], wt.b[14]);
  __syncthreads();                                            // feat in pb

  // geometry head
  dense_layer<256, 256, 256, 256, 128, kLeaky>(pb, 0, pa, 0, wt.w[15], wt.b[15]);
  __syncthreads();
  head_layer<128, 2>(pa, 0, wt.w[16], wt.b[16], s_geo);
  __syncthreads();
  // color head
  dense_layer<256, 256, 256, 256, 256, kRelu>(pb, 0, pa, 0, wt.w[17], wt.b[17]);
  __syncthreads();
  dense_layer<256, 256, 256, 256, 128, kRelu>(pa, 0, pb, 0, wt.w[18], wt.b[18]);
  __syncthreads();
  head_layer<128, 3>(pb, 0, wt.w[19], wt.b[19], s_clr);
  __syncthreads();

  for (int i = threadIdx.x; i < kTile * 3; i += kThreads) {
    const int r = i / 3, c = i - 3 * r;
    if (base + r < n) {
      const size_t o = static_cast<size_t>(base + r) * 3 + c;
      rgb[o] = 1.f / (1.f + expf(-s_clr[i]));
      offset[o] = s_off[i];
    }
  }
  for (int r = threadIdx.x; r < kTile; r += kThreads) {
    if (base + r < n) {
      occ[base + r] = s_geo[2 * r];
      alpha[base + r] = fmaxf(s_geo[2 * r + 1], 0.f);
    }
  }
}

}  // namespace

// C interface (loaded with ctypes). weight_ptrs holds 40 device pointers:
// (weight, bias) for the 8 offset layers then the 12 template layers, in
// the order of ops/fused_query.py's packers. Launches on `stream` and
// returns the cudaError_t of the launch (0 = success).
extern "C" int wtq_launch(const float* pts, const void* pose_feat, int n,
                          const void* const* weight_ptrs, float* occ,
                          float* alpha, float* rgb, float* offset,
                          void* stream) {
  if (n <= 0) return 0;
  Weights wt;
  for (int i = 0; i < kLayers; ++i) {
    wt.w[i] = static_cast<const __nv_bfloat16*>(weight_ptrs[2 * i]);
    wt.b[i] = static_cast<const float*>(weight_ptrs[2 * i + 1]);
  }
  cudaError_t err = cudaFuncSetAttribute(
      warp_template_query_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kSmemBytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (n + kTile - 1) / kTile;
  warp_template_query_kernel<<<blocks, kThreads, kSmemBytes,
                               static_cast<cudaStream_t>(stream)>>>(
      pts, static_cast<const __nv_bfloat16*>(pose_feat), n, wt, occ, alpha,
      rgb, offset);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* wtq_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
