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
//   - a block owns a tile of 128 points, 64 per consumer warpgroup; a
//     warpgroup's hidden activations stay in registers for the whole
//     20-layer chain (an accumulator, rounded to bf16, is the next layer's
//     A fragment), so device memory sees only the points, the pose features
//     and the 8 output floats per point, and shared memory only the two
//     small input panels (x, pe) that the concats read again;
//   - each layer is a [64 x K] x [K x O] product per warpgroup on wgmma
//     (m64n256k16 / m64n128k16, bf16 operands, f32 accumulators), A from
//     registers, B from shared memory;
//   - the ~2 MB of weights do not fit in shared memory (227 KB a block): a
//     producer thread streams them, as one host-built image in the order
//     the chain consumes it, through a 16-stage ring in shared memory with
//     the bulk asynchronous copy and mbarriers, so every weight byte
//     crosses L2 -> shared memory once per 128-point tile, as full lines;
//   - the two warpgroups share nothing but that ring, so one's epilogue
//     (bias, activation, bf16 rounding, on registers) runs beside the
//     other's products;
//   - the two skip-concats (323 and 319 channels) and the 67/63-channel
//     inputs are zero-padded in K: the image holds zero weights at the pad
//     columns;
//   - the ragged tail is masked in the kernel (rows past N read zeros and
//     are never stored).
// The layer chain is the shared device code of warp_template_core.cuh
// (offset_decoder, pe_coord, template_mlp; the ring and the products are
// described there), which K3-K5 run too.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "warp_template_core.cuh"

namespace {

constexpr size_t kScalarFloats = kTile * (3 + 3 + 2 + 3);
constexpr size_t kSmemBytes =
    kXPanelBytes + kPePanelBytes + kRingBytes + sizeof(float) * kScalarFloats;

static_assert(kSmemBytes <= 232448, "shared memory per block exceeded");

__global__ void __launch_bounds__(kBlockThreads, 1)
warp_template_query_kernel(const float* __restrict__ pts,
                           const __nv_bfloat16* __restrict__ pose_feat, int n,
                           ChainWeights wt, float* __restrict__ occ,
                           float* __restrict__ alpha, float* __restrict__ rgb,
                           float* __restrict__ offset) {
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* pe = reinterpret_cast<__nv_bfloat16*>(smem + kXPanelBytes);
  unsigned char* ring_mem = smem + kXPanelBytes + kPePanelBytes;
  float* s_pts = reinterpret_cast<float*>(ring_mem + kRingBytes);  // [T][3]
  float* s_off = s_pts + kTile * 3;                                // [T][3]
  float* s_geo = s_off + kTile * 3;                                // [T][2]
  float* s_clr = s_geo + kTile * 2;                                // [T][3]
  const int base = blockIdx.x * kTile;
  const __nv_bfloat16 zero = __float2bfloat16_rn(0.f);

  Ring ring = ring_init(ring_mem, threadIdx.x >= kThreads);
  if (threadIdx.x >= kThreads) {               // the producer warpgroup
    become_producer();
    if (threadIdx.x == kThreads) {
      produce_offset(ring, wt.off);
      produce_template(ring, wt.tpl);
    }
    return;
  }
  become_consumer();
  Products products = first_products(ring, false);
  // each warp builds, and later stores, its own 16 rows of the tile
  const int wm = threadIdx.x >> 7, lane = threadIdx.x & 31;
  const int row0 = (threadIdx.x >> 5) * 16;

  // decoder input x = [bf16(pts), pose_feat] in xs[:, 0:67], zero to 80
  for (int i = lane; i < 16 * 3; i += 32) {
    const int r = row0 + i / 3, c = i % 3;
    const float v = base + r < n ? pts[static_cast<size_t>(base + r) * 3 + c] : 0.f;
    s_pts[r * 3 + c] = v;
    xs[panel_off(r, c)] = __float2bfloat16_rn(v);
  }
  for (int i = lane; i < 16 * 64; i += 32) {
    const int r = row0 + (i >> 6), c = i & 63;
    xs[panel_off(r, 3 + c)] =
        base + r < n ? pose_feat[static_cast<size_t>(base + r) * 64 + c] : zero;
  }
  zero_input_pad(xs);
  fence_panel_writes();
  group_sync(wm);

  offset_decoder(xs, wm, products, wt.off, s_off);

  // warp in f32, PE(10) of the warped points into pe[:, 0:64]
  for (int i = lane; i < 16 * 3; i += 32) {
    const int r = row0 + i / 3, c = i % 3;
    pe_coord(pe, r, c, s_pts[r * 3 + c] + s_off[r * 3 + c]);
  }
  zero_pe_pad(pe);
  fence_panel_writes();
  group_sync(wm);

  template_mlp(pe, wm, products, wt.tpl, s_geo, s_clr);

  for (int i = lane; i < 16 * 3; i += 32) {
    const int r = row0 + i / 3, c = i % 3;
    if (base + r < n) {
      const size_t o = static_cast<size_t>(base + r) * 3 + c;
      rgb[o] = sigmoidf_accurate(s_clr[r * 3 + c]);
      offset[o] = s_off[r * 3 + c];
    }
  }
  if (lane < 16 && base + row0 + lane < n) {
    const int r = row0 + lane;
    occ[base + r] = s_geo[2 * r];
    alpha[base + r] = fmaxf(s_geo[2 * r + 1], 0.f);
  }
}

}  // namespace

// C interface (loaded with ctypes). image and bias are the joint weight
// image of ops/fused_query.py: weight_image (offset half then template
// half; 16-byte aligned). Launches on `stream` and returns the cudaError_t
// of the launch (0 = success).
extern "C" int wtq_launch(const float* pts, const void* pose_feat, int n,
                          const void* image, const void* bias, float* occ,
                          float* alpha, float* rgb, float* offset,
                          void* stream) {
  if (n <= 0) return 0;
  cudaError_t err = cudaFuncSetAttribute(
      warp_template_query_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kSmemBytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (n + kTile - 1) / kTile;
  warp_template_query_kernel<<<blocks, kBlockThreads, kSmemBytes,
                               static_cast<cudaStream_t>(stream)>>>(
      pts, static_cast<const __nv_bfloat16*>(pose_feat), n,
      chain_weights(image, bias), occ, alpha, rgb, offset);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* wtq_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
