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
// of 128 points, keeps its activations in two bf16 panels in shared memory
// for the whole chain, runs every product on mma.sync bf16 tensor cores with
// f32 accumulators and streams the weight fragments from L2; the ragged tail
// is masked in the kernel.
// A simple first version: no wgmma, TMA or warp specialisation yet.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "warp_template_core.cuh"

namespace {

constexpr size_t kSmemBytes = 2 * kPanelBytes + sizeof(float) * kTile * (2 + 3);
constexpr int kOffsetIn = 67;

static_assert(kSmemBytes <= 232448, "shared memory per block exceeded");

__global__ void __launch_bounds__(kThreads, 1)
template_query_kernel(const float* __restrict__ pts, int n, TemplateWeights wt,
                      float* __restrict__ rgb, float* __restrict__ alpha,
                      float* __restrict__ occ) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* pa = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* pb = pa + kTile * kStride;
  float* s_geo = reinterpret_cast<float*>(pb + kTile * kStride);  // [T][2]
  float* s_clr = s_geo + kTile * 2;                                // [T][3]
  const int base = blockIdx.x * kTile;

  // PE(10) of the f32 points into pa[:, 256:320]
  for (int i = threadIdx.x; i < kTile * 3; i += kThreads) {
    const int r = i / 3, c = i - 3 * r;
    const float v = base + r < n ? pts[static_cast<size_t>(base) * 3 + i] : 0.f;
    pe_coord(pa + r * kStride + 256, c, v);
  }
  zero_pe_pad(pa);
  __syncthreads();

  template_mlp(pa, pb, wt, s_geo, s_clr);

  for (int i = threadIdx.x; i < kTile * 3; i += kThreads) {
    if (base + i / 3 < n) {
      rgb[static_cast<size_t>(base) * 3 + i] = sigmoidf_accurate(s_clr[i]);
    }
  }
  for (int r = threadIdx.x; r < kTile; r += kThreads) {
    if (base + r < n) {
      occ[base + r] = s_geo[2 * r];
      alpha[base + r] = fmaxf(s_geo[2 * r + 1], 0.f);
    }
  }
}

__global__ void __launch_bounds__(kThreads, 1)
offset_query_kernel(const float* __restrict__ feats, int n, OffsetWeights wt,
                    float* __restrict__ offset) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* pa = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* pb = pa + kTile * kStride;
  float* s_off = reinterpret_cast<float*>(pb + kTile * kStride);  // [T][3]
  const int base = blockIdx.x * kTile;

  // decoder input x = bf16(feats) in pa[:, 0:67], zero to 80
  for (int i = threadIdx.x; i < kTile * kOffsetIn; i += kThreads) {
    const int r = i / kOffsetIn;
    const float v = base + r < n ? feats[static_cast<size_t>(base) * kOffsetIn + i] : 0.f;
    pa[r * kStride + (i - kOffsetIn * r)] = __float2bfloat16_rn(v);
  }
  zero_input_pad(pa);
  __syncthreads();

  offset_decoder(pa, pb, wt, s_off);

  for (int i = threadIdx.x; i < kTile * 3; i += kThreads) {
    if (base + i / 3 < n) offset[static_cast<size_t>(base) * 3 + i] = s_off[i];
  }
}

}  // namespace

// C interface (loaded with ctypes). Launch on `stream` and return the
// cudaError_t of the launch (0 = success).
// K4: pts (N, 3) f32; weight_ptrs holds the 24 template pointers of
// pack_template_weights; rgb (N, 3), alpha (N, 1), occ (N, 1) f32.
extern "C" int tq_launch(const float* pts, int n, const void* const* weight_ptrs,
                         float* rgb, float* alpha, float* occ, void* stream) {
  if (n <= 0) return 0;
  const TemplateWeights wt = template_weights(weight_ptrs);
  cudaError_t err = cudaFuncSetAttribute(
      template_query_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kSmemBytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  template_query_kernel<<<(n + kTile - 1) / kTile, kThreads, kSmemBytes,
                          static_cast<cudaStream_t>(stream)>>>(pts, n, wt, rgb,
                                                               alpha, occ);
  return static_cast<int>(cudaGetLastError());
}

// K5: feats (N, 67) f32; weight_ptrs holds the 16 offset pointers of
// pack_offset_weights; offset (N, 3) f32.
extern "C" int oq_launch(const float* feats, int n, const void* const* weight_ptrs,
                         float* offset, void* stream) {
  if (n <= 0) return 0;
  const OffsetWeights wt = offset_weights(weight_ptrs);
  cudaError_t err = cudaFuncSetAttribute(
      offset_query_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kSmemBytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  offset_query_kernel<<<(n + kTile - 1) / kTile, kThreads, kSmemBytes,
                        static_cast<cudaStream_t>(stream)>>>(feats, n, wt, offset);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* tq_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

extern "C" const char* oq_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
