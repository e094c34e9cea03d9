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
// The layer chain is the shared device code of warp_template_core.cuh
// (offset_decoder, pe_coord, template_mlp), which K3-K5 run too.
// A simple first version: no wgmma, TMA or warp specialisation yet.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "warp_template_core.cuh"

namespace {

constexpr size_t kScalarFloats = kTile * (3 + 3 + 2 + 3);
constexpr size_t kSmemBytes = 2 * kPanelBytes + sizeof(float) * kScalarFloats;

static_assert(kSmemBytes <= 232448, "shared memory per block exceeded");

struct Weights {
  OffsetWeights off;
  TemplateWeights tpl;
};

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
  zero_input_pad(pa);
  __syncthreads();

  offset_decoder(pa, pb, wt.off, s_off);

  // warp in f32, PE(10) of the warped points into pa[:, 256:320]
  for (int i = threadIdx.x; i < kTile * 3; i += kThreads) {
    const int r = i / 3, c = i - 3 * r;
    pe_coord(pa + r * kStride + 256, c, s_pts[i] + s_off[i]);
  }
  zero_pe_pad(pa);
  __syncthreads();

  template_mlp(pa, pb, wt.tpl, s_geo, s_clr);

  for (int i = threadIdx.x; i < kTile * 3; i += kThreads) {
    const int r = i / 3, c = i - 3 * r;
    if (base + r < n) {
      const size_t o = static_cast<size_t>(base + r) * 3 + c;
      rgb[o] = sigmoidf_accurate(s_clr[i]);
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
  const Weights wt{offset_weights(weight_ptrs),
                   template_weights(weight_ptrs + 2 * kOffsetLayers)};
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
