// The two halves of K1 as kernels of their own, for Hopper (sm_90a):
//   - template_query (K4) replaces the Pallas kernel
//     avatarcap_tpu/ops/pallas_query.py:template_query_fused (pallas_call at
//     :533; body _template_kernel :53-81): the DoubleTNet on unwarped points,
//     PE(10) of the f32 points -> rgb = sigmoid(color), alpha =
//     relu(geo[1]), occ = geo[0], all f32;
//   - offset_query (K5) replaces :offset_query_fused (pallas_call at :172;
//     body _offset_kernel :115-129): the OffsetDecoder (eval BN folded) and
//     its head on 67 input features [pts (3), pose features (64)], all 67
//     rounded to bf16 before the first product -> offset (N, 3) f32.
//
// What bounds them on an H100: operations (557,184 and 428,288 MACs per
// point against 12 + 20 and 268 + 12 bytes of input and output). Both run
// K1's design and device code (warp_template_core.cuh): a block owns a tile
// of 128 points, 64 per consumer warpgroup, which keeps its hidden
// activations in registers for the whole chain and runs every product on
// wgmma (bf16 operands, f32 accumulators, A from registers, B from shared
// memory); a producer thread streams its half of the host-built weight
// image through a ring in shared memory (bulk asynchronous copies,
// mbarriers); the ragged tail is masked in the kernel.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "warp_template_core.cuh"

namespace {

constexpr size_t kTemplateSmemBytes =
    kPePanelBytes + kRingBytes + sizeof(float) * kTile * (2 + 3);
constexpr size_t kOffsetSmemBytes = kXPanelBytes + kRingBytes + sizeof(float) * kTile * 3;
constexpr int kOffsetIn = 67;

static_assert(kTemplateSmemBytes <= 232448 && kOffsetSmemBytes <= 232448,
              "shared memory per block exceeded");

__global__ void __launch_bounds__(kBlockThreads, 1)
template_query_kernel(const float* __restrict__ pts, int n, HalfWeights wt,
                      float* __restrict__ rgb, float* __restrict__ alpha,
                      float* __restrict__ occ) {
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* pe = reinterpret_cast<__nv_bfloat16*>(smem);
  unsigned char* ring_mem = smem + kPePanelBytes;
  float* s_geo = reinterpret_cast<float*>(ring_mem + kRingBytes);  // [T][2]
  float* s_clr = s_geo + kTile * 2;                                // [T][3]
  const int base = blockIdx.x * kTile;

  Ring ring = ring_init(ring_mem, threadIdx.x >= kThreads);
  if (threadIdx.x >= kThreads) {               // the producer warpgroup
    become_producer();
    if (threadIdx.x == kThreads) produce_template(ring, wt);
    return;
  }
  become_consumer();
  Products products = first_products(ring, false);
  // each warp builds, and later stores, its own 16 rows of the tile
  const int wm = threadIdx.x >> 7, lane = threadIdx.x & 31;
  const int row0 = (threadIdx.x >> 5) * 16;

  // PE(10) of the f32 points into pe[:, 0:64]
  for (int i = lane; i < 16 * 3; i += 32) {
    const int r = row0 + i / 3, c = i % 3;
    const float v = base + r < n ? pts[static_cast<size_t>(base + r) * 3 + c] : 0.f;
    pe_coord(pe, r, c, v);
  }
  zero_pe_pad(pe);
  fence_panel_writes();
  group_sync(wm);

  template_mlp(pe, wm, products, wt, s_geo, s_clr);

  for (int i = lane; i < 16 * 3; i += 32) {
    const int r = row0 + i / 3, c = i % 3;
    if (base + r < n) {
      rgb[static_cast<size_t>(base + r) * 3 + c] = sigmoidf_accurate(s_clr[r * 3 + c]);
    }
  }
  if (lane < 16 && base + row0 + lane < n) {
    const int r = row0 + lane;
    occ[base + r] = s_geo[2 * r];
    alpha[base + r] = fmaxf(s_geo[2 * r + 1], 0.f);
  }
}

__global__ void __launch_bounds__(kBlockThreads, 1)
offset_query_kernel(const float* __restrict__ feats, int n, HalfWeights wt,
                    float* __restrict__ offset) {
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem);
  unsigned char* ring_mem = smem + kXPanelBytes;
  float* s_off = reinterpret_cast<float*>(ring_mem + kRingBytes);  // [T][3]
  const int base = blockIdx.x * kTile;

  Ring ring = ring_init(ring_mem, threadIdx.x >= kThreads);
  if (threadIdx.x >= kThreads) {               // the producer warpgroup
    become_producer();
    if (threadIdx.x == kThreads) produce_offset(ring, wt);
    return;
  }
  become_consumer();
  Products products = first_products(ring, false);
  // each warp builds, and later stores, its own 16 rows of the tile
  const int wm = threadIdx.x >> 7, lane = threadIdx.x & 31;
  const int row0 = (threadIdx.x >> 5) * 16;

  // decoder input x = bf16(feats) in xs[:, 0:67], zero to 80
  for (int i = lane; i < 16 * kOffsetIn; i += 32) {
    const int r = row0 + i / kOffsetIn, c = i % kOffsetIn;
    const float v =
        base + r < n ? feats[static_cast<size_t>(base + r) * kOffsetIn + c] : 0.f;
    xs[panel_off(r, c)] = __float2bfloat16_rn(v);
  }
  zero_input_pad(xs);
  fence_panel_writes();
  group_sync(wm);

  offset_decoder(xs, wm, products, wt, s_off);

  for (int i = lane; i < 16 * 3; i += 32) {
    const int r = row0 + i / 3, c = i % 3;
    if (base + r < n) offset[static_cast<size_t>(base + r) * 3 + c] = s_off[r * 3 + c];
  }
}

}  // namespace

// C interface (loaded with ctypes). Launch on `stream` and return the
// cudaError_t of the launch (0 = success). image and bias are one half of
// the weight image of ops/fused_query.py: weight_image (16-byte aligned).
// K4: pts (N, 3) f32; the template half; rgb (N, 3), alpha (N, 1),
// occ (N, 1) f32.
extern "C" int tq_launch(const float* pts, int n, const void* image,
                         const void* bias, float* rgb, float* alpha, float* occ,
                         void* stream) {
  if (n <= 0) return 0;
  const HalfWeights wt{static_cast<const __nv_bfloat16*>(image),
                       static_cast<const float*>(bias)};
  cudaError_t err = cudaFuncSetAttribute(
      template_query_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kTemplateSmemBytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  template_query_kernel<<<(n + kTile - 1) / kTile, kBlockThreads, kTemplateSmemBytes,
                          static_cast<cudaStream_t>(stream)>>>(pts, n, wt, rgb,
                                                               alpha, occ);
  return static_cast<int>(cudaGetLastError());
}

// K5: feats (N, 67) f32; the offset half; offset (N, 3) f32.
extern "C" int oq_launch(const float* feats, int n, const void* image,
                         const void* bias, float* offset, void* stream) {
  if (n <= 0) return 0;
  const HalfWeights wt{static_cast<const __nv_bfloat16*>(image),
                       static_cast<const float*>(bias)};
  cudaError_t err = cudaFuncSetAttribute(
      offset_query_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kOffsetSmemBytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  offset_query_kernel<<<(n + kTile - 1) / kTile, kBlockThreads, kOffsetSmemBytes,
                        static_cast<cudaStream_t>(stream)>>>(feats, n, wt, offset);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* tq_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

extern "C" const char* oq_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
