// ReconNet pixel-aligned occupancy decoder, one CUDA kernel for Hopper
// (sm_90a).
//
// Replaces the Pallas kernel avatarcap_tpu/ops/pallas_query.py:
// recon_decode_fused (pallas_call at :239; body _recon_kernel :188-200).
// Per point, with x = bf16 of the 33 input features (32 pixel-aligned
// channels and z, z included):
//   h1 = bf16(leaky(W0 x + b0))              33 -> 512
//   h2 = bf16(leaky(W1 [h1, x] + b1))        545 -> 256
//   h3 = bf16(leaky(W2 [h2, x] + b2))        289 -> 128
//   occ = sigmoid(W3 h3 + b3)                128 -> 1, f32, not rounded
// leaky = LeakyReLU(0.02); W0-W2 are the weight-norm folds
// w = g v / |v| of ops/fused_query.py:pack_recon_weights. Every product
// takes bf16 operands and accumulates in f32; the f32 bias is added after.
//
// What bounds it on an H100: operations. 193,536 MACs (387,072 FLOP) per
// point against 136 B of input and output per point (33 f32 in, 1 f32
// out), ~2,800 FLOP per byte, far above the card's ~295 FLOP/B ridge. So
// the design keeps the products on tensor cores and every intermediate on
// chip:
//   - a block owns a tile of 128 points. Its activations live in shared
//     memory for the whole chain: the input panel X [128][56] (33 columns
//     and a zero pad to 48), H1 [128][520] and H2 [128][264]; H3 reuses
//     H1 once layer 1 has read it. 215,040 B in all, one block per SM.
//     Each row stride is 8 mod 16 bf16, so the fragment loads and the
//     epilogue stores are free of bank conflicts;
//   - the skip concats [h, x] are not copied: a layer's K loop walks two
//     panels in turn (H1 then X, or H2 then X), and the B-fragment loader
//     maps each padded K column to its weight column (or to zero), so the
//     packed (O, I) weights are read as they are. Their rows (33, 545 and
//     289 long) are odd, so weights are read as 16-bit values;
//   - each hidden layer is a [128 x K] x [K x O] product on mma.sync
//     m16n8k16 bf16 instructions with f32 accumulators. The 8 warps split
//     the output columns in chunks of 256 (layer 0 takes two chunks), each
//     warp covers all 128 rows, and the epilogue (bias, leaky, bf16) runs
//     on the accumulators and writes the next panel;
//   - the 387 KB of bf16 weights do not fit next to the panels: each warp
//     streams its B fragments from the 50 MB L2, one k-step ahead of the
//     products (register double buffer);
//   - the 128 -> 1 head would waste an mma tile: each warp computes it for
//     16 points on CUDA cores, 4 products per lane and a shuffle sum, in
//     f32, then the sigmoid;
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
constexpr int kIn = 33;                      // input features
constexpr int kInPad = 48;                   // padded to the mma K of 16
constexpr int kH1 = 512, kH2 = 256, kH3 = 128;
constexpr int kStrideX = 56;                 // bf16 per panel row
constexpr int kStrideH1 = 520;
constexpr int kStrideH2 = 264;

constexpr size_t kSmemBytes =
    sizeof(__nv_bfloat16) * kTile * (kStrideX + kStrideH1 + kStrideH2);

static_assert(kSmemBytes <= 232448, "shared memory per block exceeded");
static_assert((kStrideX / 2) % 8 == 4 && (kStrideH1 / 2) % 8 == 4 &&
                  (kStrideH2 / 2) % 8 == 4,
              "panel strides must avoid bank conflicts");
static_assert(kTile == kWarps * 16, "the head gives each warp 16 rows");
static_assert(kH3 == 32 * 4, "the head gives each lane 4 columns");

struct Weights {
  const __nv_bfloat16* w[4];   // (O, I) row-major
  const float* b[4];           // (O,)
};

// Two consecutive bf16 of weight row n at padded K columns kp, kp + 1 (kp
// even) of the concatenated input [seg0 | seg1], packed low-first as the
// mma B fragment wants them. seg0 spans padded columns [0, K0P), of which
// the first K0R map to weight columns [0, K0R); seg1 spans the padded
// columns after it, of which the first K1R map to [K0R, K0R + K1R). Padded
// columns read zero.
template <int K0P, int K0R, int K1R>
__device__ __forceinline__ uint32_t load_b_pair(const __nv_bfloat16* __restrict__ w,
                                                int n, int kp) {
  const unsigned short* row = reinterpret_cast<const unsigned short*>(
      w + static_cast<size_t>(n) * (K0R + K1R));
  int k0, k1;
  if (kp < K0P) {
    k0 = kp < K0R ? kp : -1;
    k1 = kp + 1 < K0R ? kp + 1 : -1;
  } else {
    const int j = kp - K0P;
    k0 = j < K1R ? K0R + j : -1;
    k1 = j + 1 < K1R ? K0R + j + 1 : -1;
  }
  const uint32_t lo = k0 >= 0 ? __ldg(row + k0) : 0u;
  const uint32_t hi = k1 >= 0 ? __ldg(row + k1) : 0u;
  return lo | (hi << 16);
}

// One hidden layer, output columns [nb, nb + 64 NT):
//   out[:, nb:...] = bf16(leaky(A W^T + b)),  A = [in0[:, :K0P] | in1[:, :K1P]]
// The 8 warps split the columns (NT n8 tiles each); each warp covers all
// 128 rows.
template <int S0, int K0P, int K0R, int S1, int K1P, int K1R, int NT, int SO>
__device__ __forceinline__ void dense_leaky(const __nv_bfloat16* in0,
                                            const __nv_bfloat16* in1,
                                            __nv_bfloat16* out, int nb,
                                            const __nv_bfloat16* __restrict__ w,
                                            const float* __restrict__ bias) {
  constexpr int kKSteps = (K0P + K1P) / 16;
  static_assert(K0P % 16 == 0 && K1P % 16 == 0, "K must be padded to 16");
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int n0 = nb + warp * NT * 8;

  float acc[kMTiles][NT][4];
#pragma unroll
  for (int m = 0; m < kMTiles; ++m)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[m][j][i] = 0.f;

  uint32_t bcur[NT][2], bnext[NT][2];
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    bcur[j][0] = load_b_pair<K0P, K0R, K1R>(w, n0 + j * 8 + g, 2 * t);
    bcur[j][1] = load_b_pair<K0P, K0R, K1R>(w, n0 + j * 8 + g, 2 * t + 8);
  }
#pragma unroll 1
  for (int ks = 0; ks < kKSteps; ++ks) {
    if (ks + 1 < kKSteps) {
      const int kb = (ks + 1) * 16 + 2 * t;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        bnext[j][0] = load_b_pair<K0P, K0R, K1R>(w, n0 + j * 8 + g, kb);
        bnext[j][1] = load_b_pair<K0P, K0R, K1R>(w, n0 + j * 8 + g, kb + 8);
      }
    }
    const bool first = ks * 16 < K0P;
#pragma unroll
    for (int m = 0; m < kMTiles; ++m) {
      uint32_t a[4];
      if (first) {
        load_a<S0>(a, in0, m * 16 + g, ks * 16 + 2 * t);
      } else {
        load_a<S1>(a, in1, m * 16 + g, ks * 16 - K0P + 2 * t);
      }
#pragma unroll
      for (int j = 0; j < NT; ++j) mma16816(acc[m][j], a, bcur[j][0], bcur[j][1]);
    }
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      bcur[j][0] = bnext[j][0];
      bcur[j][1] = bnext[j][1];
    }
  }

#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const int col = n0 + j * 8 + 2 * t;
    const float b0 = __ldg(bias + col), b1 = __ldg(bias + col + 1);
#pragma unroll
    for (int m = 0; m < kMTiles; ++m) {
      const int row = m * 16 + g;
      float v[4] = {acc[m][j][0] + b0, acc[m][j][1] + b1,
                    acc[m][j][2] + b0, acc[m][j][3] + b1};
#pragma unroll
      for (int i = 0; i < 4; ++i) v[i] = v[i] >= 0.f ? v[i] : 0.02f * v[i];
      *reinterpret_cast<__nv_bfloat162*>(out + row * SO + col) =
          __floats2bfloat162_rn(v[0], v[1]);
      *reinterpret_cast<__nv_bfloat162*>(out + (row + 8) * SO + col) =
          __floats2bfloat162_rn(v[2], v[3]);
    }
  }
}

__global__ void __launch_bounds__(kThreads, 1)
recon_decode_kernel(const float* __restrict__ feats, int n, Weights wt,
                    float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* sx = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* sh1 = sx + kTile * kStrideX;
  __nv_bfloat16* sh2 = sh1 + kTile * kStrideH1;
  const int base = blockIdx.x * kTile;

  // x = bf16(feats) in X[:, 0:33], zero to 48; rows past n are zero
  for (int i = threadIdx.x; i < kTile * kInPad; i += kThreads) {
    const int r = i / kInPad, c = i - kInPad * r;
    const float v = (c < kIn && base + r < n)
                        ? feats[static_cast<size_t>(base + r) * kIn + c]
                        : 0.f;
    sx[r * kStrideX + c] = __float2bfloat16_rn(v);
  }
  __syncthreads();

  // layer 0: x -> H1, two chunks of 256 output columns
  dense_leaky<kStrideX, kInPad, kIn, kStrideX, 0, 0, 4, kStrideH1>(
      sx, sx, sh1, 0, wt.w[0], wt.b[0]);
  dense_leaky<kStrideX, kInPad, kIn, kStrideX, 0, 0, 4, kStrideH1>(
      sx, sx, sh1, kH1 / 2, wt.w[0], wt.b[0]);
  __syncthreads();
  // layer 1: [h1 (512), x (33)] -> H2
  dense_leaky<kStrideH1, kH1, kH1, kStrideX, kInPad, kIn, 4, kStrideH2>(
      sh1, sx, sh2, 0, wt.w[1], wt.b[1]);
  __syncthreads();
  // layer 2: [h2 (256), x (33)] -> H3, written over H1
  dense_leaky<kStrideH2, kH2, kH2, kStrideX, kInPad, kIn, 2, kStrideH1>(
      sh2, sx, sh1, 0, wt.w[2], wt.b[2]);
  __syncthreads();

  // head: occ = sigmoid(h3 . w3 + b3); warp w owns rows [16 w, 16 w + 16)
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float w3[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) w3[i] = __bfloat162float(wt.w[3][4 * lane + i]);
  const float b3 = __ldg(wt.b[3]);
  for (int r = warp * 16; r < warp * 16 + 16; ++r) {
    const __nv_bfloat16* h = sh1 + r * kStrideH1 + 4 * lane;
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i) s = fmaf(__bfloat162float(h[i]), w3[i], s);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
    if (lane == 0 && base + r < n) out[base + r] = 1.f / (1.f + expf(-(s + b3)));
  }
}

}  // namespace

// C interface (loaded with ctypes). weight_ptrs holds 8 device pointers,
// (weight, bias) of the 4 layers in the order of
// ops/fused_query.py:pack_recon_weights. Launches on `stream` and returns
// the cudaError_t of the launch (0 = success).
extern "C" int recon_decode_launch(const float* feats, int n,
                                   const void* const* weight_ptrs, float* out,
                                   void* stream) {
  if (n <= 0) return 0;
  Weights wt;
  for (int i = 0; i < 4; ++i) {
    wt.w[i] = static_cast<const __nv_bfloat16*>(weight_ptrs[2 * i]);
    wt.b[i] = static_cast<const float*>(weight_ptrs[2 * i + 1]);
  }
  cudaError_t err = cudaFuncSetAttribute(
      recon_decode_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kSmemBytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (n + kTile - 1) / kTile;
  recon_decode_kernel<<<blocks, kThreads, kSmemBytes,
                        static_cast<cudaStream_t>(stream)>>>(feats, n, wt, out);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* recon_decode_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
