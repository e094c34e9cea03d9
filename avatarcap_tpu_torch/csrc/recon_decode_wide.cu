// PIFu's shape network as the ReconNet pixel-aligned occupancy decoder: one
// CUDA kernel for Hopper (sm_90a), K2w. PIFu (Saito et al., ICCV 2019)
// runs scripts/test.sh's --mlp_dim 257 1024 512 256 128 1 with the input
// concatenated again before every layer after the first
// (lib/model/SurfaceClassifier.py). Per point, with x = bf16 of the 257
// inputs (256 pixel-aligned channels xf and z, z included):
//   h1 = bf16(leaky(W0 x + b0))              257 -> 1024
//   h2 = bf16(leaky(W1 [h1, x] + b1))        1281 -> 512
//   h3 = bf16(leaky(W2 [h2, x] + b2))        769 -> 256
//   h4 = bf16(leaky(W3 [h3, x] + b3))        513 -> 128
//   occ = sigmoid(W4 [h4, x] + b4)           385 -> 1, f32, not rounded
// leaky = LeakyReLU(0.01), no weight norm. Every product takes bf16 operands
// and accumulates in f32; z's product (bf16 z times its bf16 weight, exact
// in f32) is added to each sum in the epilogue, then the f32 bias
// (ops/fused_query.py: recon_decode_wide_plain sums the same products in
// another order).
//
// What bounds it on an H100: operations, and the weights' stream. 1,181,953
// MACs (2.36 MFLOP) a point against 1,032 B of input and output a point;
// but every 128-point tile streams the weights from L2 through shared
// memory, 2.88 MB a tile here (K2: 414 KB). The design is the ring and
// wgmma chain of chunk_ring.cuh (K1's and K2's), with K2's plan for layer 0:
//   - 384-thread blocks: two consumer warpgroups of 64 rows each and a
//     producer warpgroup that streams the host-built image
//     (ops/fused_query.py: recon_wide_weight_image; 368 chunks of 16 k,
//     layer 0's read twice: 496 a tile) through a ring of 6 stages of 16 KB:
//     the two panels below leave it 96 KB of the 227 KB. A stage holds two
//     chunks at O = 256 or four at O = 128, and a consumer takes them as
//     one group of products (one wait, commit and release): with a chunk a
//     stage, the ring's per-step cost, not the tensor cores, set the time
//     (8.4 ms for the coarse launch on an H100, 6.1 ms at two O = 128 chunks
//     a stage, 5.7 ms like this);
//   - the xf panel [128 x 256] is read by wgmma as A of layer 0 and of
//     every [h, x] concat's feature segment, and by the head's mma.sync; z
//     sits in f32 in s_z;
//   - layer 1's 512 sums a row do not fit beside h1 (256 accumulators a
//     thread at O = 512, and h1 is 256 more as fragments), so layer 1 runs
//     in two halves of 256 output columns, and each half recomputes h1:
//     layer 0 in eight column slices of 128 (m64n128k16 over 16 k-steps, 64
//     accumulators a thread), each slice, rounded into A fragments, consumed
//     at once by the half's 8 k-steps over it (m64n256k16 into 128
//     accumulators), then the half's feature segment. The recomputation is
//     22% more products than the network's, uncounted by the roofline;
//   - the first half's h2 columns go to a second [128 x 256] panel in
//     shared memory, the second half's stay in registers; layer 2 reads
//     both and the xf panel; h3 and h4 stay in registers as the next
//     layer's A fragments (K1's epilogue);
//   - the 385 -> 1 head runs on mma.sync from h4's fragments and the xf
//     panel, then the accurate sigmoid;
//   - the ragged tail is masked in the kernel (rows past n read zeros and
//     are never stored).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define CHUNK_RING_STAGES 6
#define CHUNK_RING_STAGE_BYTES 16384
#include "chunk_ring.cuh"

namespace {

constexpr int kIn = 257;                     // input features: xf and z
constexpr int kXCols = 256;                  // the xf panel
constexpr int kH1 = 1024;                    // hidden widths
constexpr int kH2 = 512;
constexpr int kH3 = 256;
constexpr int kH4 = 128;

constexpr size_t kPanelBytes = sizeof(__nv_bfloat16) * kTile * kXCols;
constexpr size_t kSmemBytes = 2 * kPanelBytes + sizeof(float) * kTile + kRingBytes;

static_assert(kSmemBytes <= 232448, "shared memory per block exceeded");
static_assert(kPanelBytes % 128 == 0, "the panels and z keep the ring 16-byte aligned");

// The weight image (ops/fused_query.py: recon_wide_weight_image states the
// same numbers; tests/test_torch_pifu.py holds the two together), region by
// region: layer 0 (slice after slice of 128 rows, 16 chunks at O = 128),
// layer 1's h1 columns (half after half of 256 rows, slice after slice of
// 128 columns, 8 chunks at O = 256), layer 1's xf columns (per half, 16
// chunks), layer 2 (h2 columns 256-511, 0-255, xf: 48 chunks at O = 256),
// layer 3 (h3, xf: 32 chunks at O = 128), then the head [h4, xf] (384).
constexpr int kSlices = 8;
constexpr int kSliceCols = kH1 / kSlices;
constexpr int kXSteps = kXCols / kChunkK;
constexpr int kSliceSteps = kSliceCols / kChunkK;
constexpr int kL0Elems = kH1 * kXCols;
constexpr int kL1hElems = kH2 * kH1;
constexpr int kL1xElems = kH2 * kXCols;
constexpr int kL2Elems = kH3 * (kH2 + kXCols);
constexpr int kL3Elems = kH4 * (kH3 + kXCols);
constexpr int kWideHeadElem = kL0Elems + kL1hElems + kL1xElems + kL2Elems + kL3Elems;
constexpr int kWideImageElems = kWideHeadElem + kH4 + kXCols;
// f32 biases, layer after layer, each padded to 4 floats; then each layer's
// weights of z, the same way
constexpr int kWideBiasFloats = kH1 + kH2 + kH3 + kH4 + 4;

static_assert(kWideImageElems % 8 == 0 && kWideBiasFloats % 4 == 0,
              "image and vectors end on 16-byte lines");

// A ring stage (16 KB) holds stage_chunks(O) consecutive chunks of a layer:
// two at O = 256, four at O = 128. A consumer takes a stage's chunks as one
// group of products: one wait, commit and release a stage.
__host__ __device__ constexpr int stage_chunks(int o) { return kStageBytes / (2 * kChunkK * o); }

__device__ __forceinline__ void produce_wide(Ring& r, const __nv_bfloat16* image) {
  const unsigned char* img = reinterpret_cast<const unsigned char*>(image);
  const unsigned char* l1h = img + 2 * kL0Elems;
  const unsigned char* l1x = l1h + 2 * kL1hElems;
  const unsigned char* l2 = l1x + 2 * kL1xElems;
  const unsigned char* l3 = l2 + 2 * kL2Elems;
  for (int hh = 0; hh < 2; ++hh) {
    for (int j = 0; j < kSlices; ++j) {
      const unsigned char* src = img + 2 * kSliceCols * kXCols * j;
      produce_run(r, src, kXSteps / stage_chunks(128), kStageBytes);
      src = l1h + 2 * (kH2 / 2) * kSliceCols * (kSlices * hh + j);
      produce_run(r, src, kSliceSteps / stage_chunks(256), kStageBytes);
    }
    const unsigned char* src = l1x + 2 * (kH2 / 2) * kXCols * hh;
    produce_run(r, src, kXSteps / stage_chunks(256), kStageBytes);
  }
  produce_run(r, l2, 3 * kXSteps / stage_chunks(256), kStageBytes);
  produce_run(r, l3, 2 * kXSteps / stage_chunks(128), kStageBytes);
}

// One k-step of O columns: acc (+)= A B, A from a descriptor or registers.
template <int O>
__device__ __forceinline__ void wgmma_ss(float (&acc)[O / 2], uint64_t desc_a, uint64_t desc_b,
                                         int accumulate) {
  if constexpr (O == 256) {
    wgmma_m64n256k16(acc, desc_a, desc_b, accumulate);
  } else {
    wgmma_m64n128k16(acc, desc_a, desc_b, accumulate);
  }
}

template <int O>
__device__ __forceinline__ void wgmma_rs(float (&acc)[O / 2], const uint32_t* a, uint64_t desc_b,
                                         int accumulate) {
  if constexpr (O == 256) {
    wgmma_m64n256k16_rs(acc, a[0], a[1], a[2], a[3], desc_b, accumulate);
  } else {
    wgmma_m64n128k16_rs(acc, a[0], a[1], a[2], a[3], desc_b, accumulate);
  }
}

// acc (+)= A B over KSTEPS k-steps (whole stages), A the
// warpgroup's 64 rows of a panel from column 0, a stage's chunks at a time
// (chunk_ring.cuh's products_from_panel, grouped).
template <int KSTEPS, int O>
__device__ __forceinline__ void panel_products(float (&acc)[O / 2], const __nv_bfloat16* panel,
                                               int wm, Products& p, int accumulate) {
  constexpr int G = stage_chunks(O);
  constexpr uint64_t kStepA = 2 * kGroupBytes >> 4;       // 16 panel columns
  constexpr uint64_t kStepB = 2 * kChunkK * O >> 4;       // the stage's next chunk
  static_assert(KSTEPS % G == 0, "whole stages");
  const uint64_t desc_a = wgmma_desc(smem_u32(panel + panel_off(wm * kGroupRows, 0)),
                                     kGroupBytes, kCoreBytes);
#pragma unroll
  for (int s = 0; s < KSTEPS / G; ++s) {
    const uint64_t desc_b = next_chunk<O>(p);
#pragma unroll
    for (int g = 0; g < G; ++g) {
      wgmma_ss<O>(acc, desc_a + (G * s + g) * kStepA, desc_b + g * kStepB,
                  s + g > 0 ? 1 : accumulate);
    }
    chunk_issued(p);
  }
}

// The same with A the thread's register fragments h (products_from_registers,
// grouped).
template <int KSTEPS, int O>
__device__ __forceinline__ void register_products(float (&acc)[O / 2],
                                                  const uint32_t (&h)[4 * KSTEPS], Products& p,
                                                  int accumulate) {
  constexpr int G = stage_chunks(O);
  constexpr uint64_t kStepB = 2 * kChunkK * O >> 4;
  static_assert(KSTEPS % G == 0, "whole stages");
#pragma unroll
  for (int s = 0; s < KSTEPS / G; ++s) {
    const uint64_t desc_b = next_chunk<O>(p);
#pragma unroll
    for (int g = 0; g < G; ++g) {
      wgmma_rs<O>(acc, h + 4 * (G * s + g), desc_b + g * kStepB, s + g > 0 ? 1 : accumulate);
    }
    chunk_issued(p);
  }
}

// Accumulator group j (columns [16 j, 16 j + 16)) plus z's product and the
// bias, through leaky 0.01, in the order of epilogue's v[8]. `b` points at
// the layer's biases, its z weights kWideBiasFloats further; the rows' z
// are read from s_z (registers are what the slice loop runs short of).
template <int O>
__device__ __forceinline__ void wide_values(const float (&acc)[O / 2], int j,
                                            const float* __restrict__ b, const float* s_z,
                                            float (&v)[8]) {
  const int t = threadIdx.x & 3;
  const int row = (threadIdx.x >> 5) * 16 + ((threadIdx.x & 31) >> 2);
  const float z_lo = s_z[row], z_hi = s_z[row + 8];
  const float2 b_lo = __ldg(reinterpret_cast<const float2*>(b + 16 * j + 2 * t));
  const float2 b_hi = __ldg(reinterpret_cast<const float2*>(b + 16 * j + 8 + 2 * t));
  const float* wz = b + kWideBiasFloats;
  const float2 w_lo = __ldg(reinterpret_cast<const float2*>(wz + 16 * j + 2 * t));
  const float2 w_hi = __ldg(reinterpret_cast<const float2*>(wz + 16 * j + 8 + 2 * t));
  v[0] = fmaf(z_lo, w_lo.x, acc[8 * j]) + b_lo.x;
  v[1] = fmaf(z_lo, w_lo.y, acc[8 * j + 1]) + b_lo.y;
  v[2] = fmaf(z_hi, w_lo.x, acc[8 * j + 2]) + b_lo.x;
  v[3] = fmaf(z_hi, w_lo.y, acc[8 * j + 3]) + b_lo.y;
  v[4] = fmaf(z_lo, w_hi.x, acc[8 * j + 4]) + b_hi.x;
  v[5] = fmaf(z_lo, w_hi.y, acc[8 * j + 5]) + b_hi.y;
  v[6] = fmaf(z_hi, w_hi.x, acc[8 * j + 6]) + b_hi.x;
  v[7] = fmaf(z_hi, w_hi.y, acc[8 * j + 7]) + b_hi.y;
#pragma unroll
  for (int i = 0; i < 8; ++i) v[i] = v[i] >= 0.f ? v[i] : 0.01f * v[i];
}

__device__ __forceinline__ uint32_t bf16_pair(float a, float b) {
  const __nv_bfloat162 pair = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&pair);
}

// chunk_ring.cuh's epilogue with z's product: h = bf16(leaky(acc + z wz + b))
// as the next layer's A fragments.
template <int O>
__device__ __forceinline__ void wide_epilogue(const float (&acc)[O / 2], uint32_t (&h)[O / 4],
                                              const float* __restrict__ b, const float* s_z) {
#pragma unroll
  for (int j = 0; j < O / 16; ++j) {
    float v[8];
    wide_values<O>(acc, j, b, s_z, v);
#pragma unroll
    for (int i = 0; i < 4; ++i) h[4 * j + i] = bf16_pair(v[2 * i], v[2 * i + 1]);
    asm volatile("" ::: "memory");
  }
}

// The same into a panel: the thread's rows and columns of the 128-row panel.
template <int O>
__device__ __forceinline__ void wide_epilogue_to_panel(const float (&acc)[O / 2],
                                                       __nv_bfloat16* panel,
                                                       const float* __restrict__ b,
                                                       const float* s_z) {
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  const int row = (threadIdx.x >> 5) * 16 + g;
#pragma unroll
  for (int j = 0; j < O / 16; ++j) {
    float v[8];
    wide_values<O>(acc, j, b, s_z, v);
    const int col = 16 * j + 2 * t;
    *reinterpret_cast<uint32_t*>(panel + panel_off(row, col)) = bf16_pair(v[0], v[1]);
    *reinterpret_cast<uint32_t*>(panel + panel_off(row + 8, col)) = bf16_pair(v[2], v[3]);
    *reinterpret_cast<uint32_t*>(panel + panel_off(row, col + 8)) = bf16_pair(v[4], v[5]);
    *reinterpret_cast<uint32_t*>(panel + panel_off(row + 8, col + 8)) = bf16_pair(v[6], v[7]);
  }
}

// Layer 1's sums over the next half of its output columns: h1 recomputed
// slice by slice (layer 0, 16 chunks at O = 128 a slice), each slice
// consumed at once (8 chunks at O = 256), then xf (16 chunks). The slice
// loop is not unrolled (a body of 24 wgmma statements); each pass ends
// with its products retired.
__device__ __forceinline__ void layer1_half(float (&acc)[128], const __nv_bfloat16* xs,
                                            const float* s_z, int wm, Products& p,
                                            const float* __restrict__ bias) {
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0.f;
#pragma unroll 1
  for (int j = 0; j < kSlices; ++j) {
    float acc0[64];
    uint32_t h1[32];
    panel_products<kXSteps, kSliceCols>(acc0, xs, wm, p, 0);
    products_done(acc0);
    wide_epilogue<kSliceCols>(acc0, h1, bias + kSliceCols * j, s_z);
    register_products<kSliceSteps, 256>(acc, h1, p, 1);
    products_done(acc);
  }
  panel_products<kXSteps, 256>(acc, xs, wm, p, 1);
  products_done(acc);
}

// The head: each warp's 16 rows, occ = sigmoid(h4 . w_h + xf . w_x + z w_z
// + b) on mma.sync, h4 from its fragments, xf from the panel, the (1, 384)
// weights [w_h, w_x] straight from L2; stored past nothing beyond n.
__device__ __forceinline__ void wide_head(const uint32_t (&h)[32], const __nv_bfloat16* xs,
                                          const float* s_z, const __nv_bfloat16* __restrict__ w,
                                          const float* __restrict__ b, float* __restrict__ out,
                                          int base, int n) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int row = (threadIdx.x >> 5) * 16 + g;
  const unsigned int* w32 = reinterpret_cast<const unsigned int*>(w);
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int ks = 0; ks < kH4 / kChunkK; ++ks) {
    const uint32_t b0 = g == 0 ? __ldg(w32 + 8 * ks + t) : 0u;
    const uint32_t b1 = g == 0 ? __ldg(w32 + 8 * ks + t + 4) : 0u;
    const uint32_t a[4] = {h[4 * ks], h[4 * ks + 1], h[4 * ks + 2], h[4 * ks + 3]};
    mma16816(acc, a, b0, b1);
  }
#pragma unroll
  for (int ks = 0; ks < kXSteps; ++ks) {
    const int col = 16 * ks + 2 * t;
    const uint32_t b0 = g == 0 ? __ldg(w32 + kH4 / 2 + 8 * ks + t) : 0u;
    const uint32_t b1 = g == 0 ? __ldg(w32 + kH4 / 2 + 8 * ks + t + 4) : 0u;
    const uint32_t a[4] = {*reinterpret_cast<const uint32_t*>(xs + panel_off(row, col)),
                           *reinterpret_cast<const uint32_t*>(xs + panel_off(row + 8, col)),
                           *reinterpret_cast<const uint32_t*>(xs + panel_off(row, col + 8)),
                           *reinterpret_cast<const uint32_t*>(xs + panel_off(row + 8, col + 8))};
    mma16816(acc, a, b0, b1);
  }
  if (t == 0) {
    const float bias = __ldg(b), wz = __ldg(b + kWideBiasFloats);
    if (base + row < n) out[base + row] = sigmoidf_accurate(fmaf(s_z[row], wz, acc[0]) + bias);
    if (base + row + 8 < n) {
      out[base + row + 8] = sigmoidf_accurate(fmaf(s_z[row + 8], wz, acc[2]) + bias);
    }
  }
}

__global__ void __launch_bounds__(kBlockThreads, 1)
recon_decode_wide_kernel(const float* __restrict__ feats, int n,
                         const __nv_bfloat16* __restrict__ image,
                         const float* __restrict__ vecs, float* __restrict__ out) {
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* h2s = xs + kTile * kXCols;
  float* s_z = reinterpret_cast<float*>(h2s + kTile * kXCols);        // [T]
  unsigned char* ring_mem = reinterpret_cast<unsigned char*>(s_z + kTile);
  const int base = blockIdx.x * kTile;

  Ring ring = ring_init(ring_mem, threadIdx.x >= kThreads);
  if (threadIdx.x >= kThreads) {               // the producer warpgroup
    become_producer();
    if (threadIdx.x == kThreads) produce_wide(ring, image);
    return;
  }
  become_consumer();
  Products products = first_products(ring, false);
  // each warp builds its own 16 rows of the tile
  const int wm = threadIdx.x >> 7, lane = threadIdx.x & 31;
  const int row0 = (threadIdx.x >> 5) * 16;

  // xf = bf16(feats[:, 0:256]) in xs, z = bf16(feats[:, 256]) in s_z; rows
  // past n are zero. The warp's 16 rows are 4,112 consecutive floats, read
  // in three rounds of 43 loads a lane, each round's loads all in flight
  constexpr int kWarpFloats = 16 * kIn;
  constexpr int kRound = 43;
  static_assert(3 * 32 * kRound >= kWarpFloats, "three rounds cover the rows");
  const float* src = feats + static_cast<size_t>(base + row0) * kIn;
  const int present = min(16, n - base - row0) * kIn;   // <= 0: no row
#pragma unroll 1
  for (int r0 = 0; r0 < kWarpFloats; r0 += 32 * kRound) {
    float xv[kRound];
#pragma unroll
    for (int k = 0; k < kRound; ++k) {
      const int i = r0 + lane + 32 * k;
      xv[k] = i < present ? src[i] : 0.f;
    }
#pragma unroll
    for (int k = 0; k < kRound; ++k) {
      const int i = r0 + lane + 32 * k, r = i / kIn, c = i - kIn * r;
      if (i < kWarpFloats) {
        const __nv_bfloat16 b = __float2bfloat16_rn(xv[k]);
        if (c < kXCols) {
          xs[panel_off(row0 + r, c)] = b;
        } else {
          s_z[row0 + r] = __bfloat162float(b);
        }
      }
    }
  }
  fence_panel_writes();
  group_sync(wm);
  const float* bias = vecs;
  // layer 1 in two halves of 256 output columns: the first's h2 to the
  // h2s panel, the second's to registers (written only after the second
  // half's sums, so the two never hold registers together)
  {
    float acc[128];
    layer1_half(acc, xs, s_z, wm, products, bias);
    wide_epilogue_to_panel<256>(acc, h2s, bias + kH1, s_z);
    fence_panel_writes();
    group_sync(wm);
  }
  uint32_t h2b[64];
  {
    float acc[128];
    layer1_half(acc, xs, s_z, wm, products, bias);
    wide_epilogue<256>(acc, h2b, bias + kH1 + 256, s_z);
  }

  // layer 2: [h2 (columns 256-511 from registers, 0-255 from h2s), xf] ->
  // h3 (registers)
  uint32_t h3[64];
  {
    float acc[128];
    register_products<16, 256>(acc, h2b, products, 0);
    panel_products<16, 256>(acc, h2s, wm, products, 1);
    panel_products<kXSteps, 256>(acc, xs, wm, products, 1);
    products_done(acc);
    wide_epilogue<256>(acc, h3, bias + kH1 + kH2, s_z);
  }

  // layer 3: [h3, xf] -> h4 (registers)
  uint32_t h4[32];
  {
    float acc[64];
    register_products<16, 128>(acc, h3, products, 0);
    panel_products<kXSteps, 128>(acc, xs, wm, products, 1);
    products_done(acc);
    constexpr int kB3 = kH1 + kH2 + kH3;
    wide_epilogue<128>(acc, h4, bias + kB3, s_z);
  }

  // head: occ = sigmoid([h4, x] . w4 + b4), f32
  constexpr int kB4 = kH1 + kH2 + kH3 + kH4;
  wide_head(h4, xs, s_z, image + kWideHeadElem, bias + kB4, out, base, n);
}

}  // namespace

// C interface (loaded with ctypes). image and vecs are K2w's weight image
// of ops/fused_query.py: recon_wide_weight_image (16-byte aligned); feats
// are (n, 257) f32 rows. Launches on `stream` and returns the cudaError_t
// of the launch (0 = success).
extern "C" int recon_decode_wide_launch(const float* feats, int n, const void* image,
                                        const void* vecs, float* out, void* stream) {
  if (n <= 0) return 0;
  cudaError_t err = cudaFuncSetAttribute(recon_decode_wide_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(kSmemBytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (n + kTile - 1) / kTile;
  recon_decode_wide_kernel<<<blocks, kBlockThreads, kSmemBytes,
                             static_cast<cudaStream_t>(stream)>>>(
      feats, n, static_cast<const __nv_bfloat16*>(image), static_cast<const float*>(vecs), out);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* recon_decode_wide_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
