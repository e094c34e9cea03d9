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
// out), ~2,800 FLOP per byte of device memory, far above the card's ~295
// FLOP/B ridge. Each 128-point tile also streams all 413,952 B of weights
// from L2 (~120 FLOP per L2 byte, ~5 TB/s at this kernel's rate); one wave
// of 33 tiles takes nearly the time of one of 132, so a tile's own serial
// chain (its input build, products, epilogues and head) sets the time
// more than the shared L2 does. The design is the ring and wgmma chain of
// chunk_ring.cuh (K1's):
//   - 384-thread blocks: two consumer warpgroups of 64 rows each and a
//     producer warpgroup that streams the host-built image
//     (ops/fused_query.py: recon_weight_image; 66 chunks of 16 k) through
//     the ring;
//   - the x panel [128 x 48] (columns 33-47 and rows past n zero) is read
//     by wgmma as A of layer 0 and of the two [h, x] concats' x segments.
//     Each warp builds its 16 rows with all of its loads in flight at once
//     (a load loop that waits for each load took a third of the time);
//     the concats are two K segments whose pad columns are zero weights in
//     the image, so the kernel has no column map;
//   - h1 never leaves registers: layer 0 (O = 512) runs in four column
//     slices of 128 (m64n128k16 over 3 k-steps, 64 accumulators a thread),
//     and each slice, rounded into A fragments, is consumed at once by
//     layer 1's 8 k-steps of that slice (m64n256k16 into layer 1's 128
//     accumulators): ~200 registers at the peak, where a whole 256-column
//     half of h1 beside layer 1's sums would need 256, above the
//     consumers' 240. The image interleaves the chunks to match;
//   - layer 1's x segment and layer 2's read the x panel; h2 and h3 stay
//     in registers as the next layer's A fragments (K1's epilogue);
//   - the 128 -> 1 head runs on mma.sync from h3's fragments, then the
//     accurate sigmoid;
//   - the ragged tail is masked in the kernel (rows past n read zeros and
//     are never stored).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "chunk_ring.cuh"

namespace {

constexpr int kIn = 33;                      // input features
constexpr int kXCols = 48;                   // x panel: 33 inputs, padded
constexpr int kH1 = 512;                     // hidden widths
constexpr int kH2 = 256;
constexpr int kH3 = 128;

constexpr size_t kXPanelBytes = sizeof(__nv_bfloat16) * kTile * kXCols;
constexpr size_t kSmemBytes = kXPanelBytes + kRingBytes + sizeof(float) * kTile;

static_assert(kSmemBytes <= 232448, "shared memory per block exceeded");
static_assert(kXPanelBytes % 128 == 0, "the ring follows the panel, 16-byte aligned");

// The weight image (ops/fused_query.py: recon_weight_image states the same
// numbers; tests/test_torch_recon.py holds the two together): for each of
// layer 0's four slices of 128 output columns its 3 chunks (O = 128), then
// layer 1's 8 chunks of that slice's h1 columns (O = 256); then layer 1's
// x segment (3 chunks), layer 2 (h2 then x: 19 chunks at O = 128), then
// the 1 x 128 head, row-major.
constexpr int kSlices = 4;
constexpr int kSliceCols = kH1 / kSlices;
constexpr int kXChunks = kXCols / kChunkK;
constexpr int kSliceChunks = kSliceCols / kChunkK;
constexpr int kH2Chunks = kH2 / kChunkK;
constexpr int kReconHeadElem =
    kH1 * kXCols + kH2 * (kH1 + kXCols) + kH3 * (kH2 + kXCols);
constexpr int kReconImageElems = kReconHeadElem + kH3;
// f32 biases, layer after layer, each padded to 4 floats
constexpr int kReconBiasFloats = kH1 + kH2 + kH3 + 4;

// the producer's runs (produce_recon) cover the image's chunks exactly
static_assert(kSlices * (kXChunks * kChunkElems128 + kSliceChunks * kChunkElems256) +
                      kXChunks * kChunkElems256 + (kH2Chunks + kXChunks) * kChunkElems128 ==
                  kReconHeadElem,
              "the stream must match the image");
static_assert(kReconImageElems % 8 == 0 && kReconBiasFloats % 4 == 0,
              "image and biases end on 16-byte lines");

__device__ __forceinline__ void produce_recon(Ring& r, const __nv_bfloat16* image) {
  const unsigned char* src = reinterpret_cast<const unsigned char*>(image);
  for (int j = 0; j < kSlices; ++j) {
    produce_run(r, src, kXChunks, 2 * kChunkElems128);
    produce_run(r, src, kSliceChunks, 2 * kChunkElems256);
  }
  produce_run(r, src, kXChunks, 2 * kChunkElems256);
  produce_run(r, src, kH2Chunks + kXChunks, 2 * kChunkElems128);
}

__global__ void __launch_bounds__(kBlockThreads, 1)
recon_decode_kernel(const float* __restrict__ feats, int n,
                    const __nv_bfloat16* __restrict__ image,
                    const float* __restrict__ bias, float* __restrict__ out) {
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem);
  unsigned char* ring_mem = smem + kXPanelBytes;
  float* s_out = reinterpret_cast<float*>(ring_mem + kRingBytes);   // [T]
  const int base = blockIdx.x * kTile;

  Ring ring = ring_init(ring_mem, threadIdx.x >= kThreads);
  if (threadIdx.x >= kThreads) {               // the producer warpgroup
    become_producer();
    if (threadIdx.x == kThreads) produce_recon(ring, image);
    return;
  }
  become_consumer();
  Products products = first_products(ring, false);
  // each warp builds, and later stores, its own 16 rows of the tile
  const int wm = threadIdx.x >> 7, lane = threadIdx.x & 31;
  const int row0 = (threadIdx.x >> 5) * 16;

  // x = bf16(feats) in xs[:, 0:33], zero to 48; rows past n are zero. The
  // warp's 16 rows are 528 consecutive floats: every load is issued before
  // the first store, one round trip to device memory
  constexpr int kLoads = (16 * kIn + 31) / 32;
  const float* src = feats + static_cast<size_t>(base + row0) * kIn;
  const int present = min(16, n - base - row0) * kIn;   // <= 0: no row
  float xv[kLoads];
#pragma unroll
  for (int k = 0; k < kLoads; ++k) {
    const int i = lane + 32 * k;
    xv[k] = i < present ? src[i] : 0.f;
  }
#pragma unroll
  for (int k = 0; k < kLoads; ++k) {
    const int i = lane + 32 * k, r = i / kIn, c = i - kIn * r;
    if (i < 16 * kIn) xs[panel_off(row0 + r, c)] = __float2bfloat16_rn(xv[k]);
  }
  const __nv_bfloat16 zero = __float2bfloat16_rn(0.f);
  for (int i = lane; i < 16 * (kXCols - kIn); i += 32) {
    const int r = i / (kXCols - kIn), c = i - (kXCols - kIn) * r;
    xs[panel_off(row0 + r, kIn + c)] = zero;
  }
  fence_panel_writes();
  group_sync(wm);

  // layers 0 and 1: x -> h1 slice j (registers) -> layer 1's sums over
  // it, j = 0..3; then layer 1's x segment -> h2 (registers)
  float acc[128];
  {
    float acc0[64];
    uint32_t h1[4 * kSliceChunks];
#pragma unroll
    for (int j = 0; j < kSlices; ++j) {
      products_from_panel<kXChunks, kSliceCols>(acc0, xs, wm, products, 0);
      products_done(acc0);
      epilogue<kSliceCols, kLeaky>(acc0, h1, bias + kSliceCols * j);
      products_from_registers<256, kSliceChunks>(acc, h1, products, j > 0);
    }
  }
  products_from_panel<kXChunks>(acc, xs, wm, products, 1);
  products_done(acc);
  uint32_t h[64];
  epilogue<256, kLeaky>(acc, h, bias + kH1);

  // layer 2: [h2 (256), x] -> h3 (registers)
  float acc3[64];
  uint32_t h3[32];
  products_from_registers<128, kH2Chunks>(acc3, h, products, 0);
  products_from_panel<kXChunks, 128>(acc3, xs, wm, products, 1);
  products_done(acc3);
  epilogue<128, kLeaky>(acc3, h3, bias + kH1 + kH2);

  // head: occ = sigmoid(h3 . w3 + b3), f32
  head_layer<kH3 / kChunkK, 1>(h3, image + kReconHeadElem, bias + kH1 + kH2 + kH3, s_out);
  __syncwarp();
  if (lane < 16 && base + row0 + lane < n) {
    out[base + row0 + lane] = sigmoidf_accurate(s_out[row0 + lane]);
  }
}

}  // namespace

// C interface (loaded with ctypes). image and bias are K2's weight image of
// ops/fused_query.py: recon_weight_image (16-byte aligned). Launches on
// `stream` and returns the cudaError_t of the launch (0 = success).
extern "C" int recon_decode_launch(const float* feats, int n, const void* image,
                                   const void* bias, float* out, void* stream) {
  if (n <= 0) return 0;
  cudaError_t err = cudaFuncSetAttribute(
      recon_decode_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kSmemBytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (n + kTile - 1) / kTile;
  recon_decode_kernel<<<blocks, kBlockThreads, kSmemBytes,
                        static_cast<cudaStream_t>(stream)>>>(
      feats, n, static_cast<const __nv_bfloat16*>(image),
      static_cast<const float*>(bias), out);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* recon_decode_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
