// The weight ring and the layer steps of the port's wgmma kernels: the
// warp + template chain (warp_template_core.cuh: K1, K3, K4, K5) and the
// ReconNet decoder (recon_decode.cu: K2).
//
// A block owns a tile of kTile = 128 points, 64 per consumer warpgroup. A
// warpgroup keeps its rows' hidden activations in registers; inputs that a
// layer reads again (a concat) live in shared memory as bf16 panels of 128
// rows: unswizzled K-major core matrices of 8 rows x 8 bf16 (128 contiguous
// bytes), element (row, col) at ((col / 8) * 128 + row) * 8 + col % 8
// (panel_off).
//
// How a layer runs on an H100. A wide layer (O = 256 or 128) is a
// [64 x K] x [K x O] product per warpgroup on the warpgroup matrix multiply
// (wgmma m64n256k16 / m64n128k16, f32 accumulators in registers):
//   - A comes from registers wherever it is a hidden activation: a thread's
//     accumulators of columns [16 j, 16 j + 16), after bias, activation and
//     rounding to bf16 pairs, are exactly its A fragment of the next
//     layer's k-step j, so the epilogue writes registers and no hidden
//     activation touches shared memory; nothing but the ring couples the
//     two warpgroups, so one's epilogue can run beside the other's
//     products. Panel inputs are read by wgmma from the panel;
//   - B comes from one image that the host builds once per packed set
//     (ops/fused_query.py: weight_image, recon_weight_image): K zero-padded
//     per layer to the inputs' column blocks, cut into chunks of 16 k (8 KB
//     at O = 256, 4 KB at O = 128) that follow each other in the order the
//     kernel runs them, each chunk in the same core-matrix layout,
//     [k / 8][n][k % 8];
//   - a producer thread (the first of a third warpgroup, warps 8-11, which
//     gives its registers to the consumers: setmaxnreg 24 / 240; a lone
//     ninth warp would cap every thread at 168 registers, a scheduler's
//     file over three warps) streams the chunks through a ring of kStages
//     8 KB stages in shared memory with the 1-D bulk copy
//     (cp.async.bulk ... mbarrier::complete_tx::bytes), one full and one
//     empty mbarrier per stage; the stream ignores layer boundaries, and
//     each weight byte crosses L2 -> shared memory once per tile;
//   - a consumer warpgroup waits for a chunk, issues one wgmma for its 64
//     rows and all O columns, and frees the stage of the chunk before it
//     once that product has retired.
// Output heads (O <= 8) run on mma.sync from the same register fragments,
// their weights, which follow the chunks in the image, straight from L2.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_bf16.cuh"
#include "wgmma_bf16.cuh"

namespace {

constexpr int kTile = 128;                   // points per block
constexpr int kWarps = 8;                    // consumer warps
constexpr int kThreads = kWarps * 32;        // consumer threads
constexpr int kBlockThreads = kThreads + 128; // + the producer warpgroup
constexpr int kGroupRows = 64;               // rows per consumer warpgroup
// between a panel's column groups (8 columns of all rows), and between the
// 8-row groups inside one: the two strides of a wgmma descriptor
constexpr int kGroupBytes = kTile * 16;
constexpr int kCoreBytes = 128;

// Element index of (row, col) in a panel.
__device__ __forceinline__ int panel_off(int row, int col) {
  return ((col >> 3) * kTile + row) * 8 + (col & 7);
}

constexpr int kChunkK = 16;                  // k per chunk
constexpr int kChunkElems256 = 256 * kChunkK;  // bf16 per chunk at O = 256
constexpr int kChunkElems128 = 128 * kChunkK;

// ---- the ring of weight chunks -------------------------------------------

constexpr int kStages = 21;
constexpr int kStageBytes = 2 * kChunkElems256;          // 8 KB
// stages, then kStages full and kStages + 1 empty mbarriers (8 bytes each;
// the last empty barrier is a dummy: see Products), padded to 16 bytes
constexpr size_t kRingBytes = kStages * kStageBytes + (2 * kStages + 2) * 8;

static_assert(kRingBytes % 16 == 0, "what follows the ring stays 16-byte aligned");

// A thread's view of the ring: the shared-space address of stage 0 and its
// position in the stream. Consumers start at parity 0 (they wait for a stage
// to fill), the producer at parity 1 (its first pass finds every stage
// empty).
struct Ring {
  uint32_t stages;   // stage s at stages + s * kStageBytes
  uint32_t stage, parity;
};

// The full and the empty barrier of stage s.
__device__ __forceinline__ uint32_t full_barrier(const Ring& r, uint32_t s) {
  return r.stages + kStages * kStageBytes + 8 * s;
}

__device__ __forceinline__ uint32_t empty_barrier(const Ring& r, uint32_t s) {
  return r.stages + kStages * kStageBytes + 8 * kStages + 8 * s;
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

// Spin until the barrier's phase of the given parity has completed. The loop
// is inside the asm statement, so the compiler sees straight-line code (a
// C++ loop here makes it fence every wgmma of the caller's loop).
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@p bra DONE;\n"
      "bra WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// 1-D bulk copy global -> shared (16-byte aligned source, destination and
// size); its bytes complete on the mbarrier.
__device__ __forceinline__ void bulk_copy_g2s(uint32_t dst, const void* src,
                                              uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void ring_advance(Ring& r) {
  if (++r.stage == kStages) {
    r.stage = 0;
    r.parity ^= 1;
  }
}

// Every thread of the block (kBlockThreads) calls this once, first thing:
// thread 0 initialises the barriers; ends with a barrier of the whole block.
// `mem` is the kRingBytes region (16-byte aligned).
__device__ __forceinline__ Ring ring_init(unsigned char* mem, bool producer) {
  Ring r;
  r.stages = smem_u32(mem);
  r.stage = 0;
  r.parity = producer ? 1u : 0u;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full_barrier(r, s), 1);        // the producer's expect_tx arrival
      mbar_init(empty_barrier(r, s), kWarps);  // one arrival per consumer warp
    }
    mbar_init(empty_barrier(r, kStages), kWarps);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  return r;
}

// The block splits for good right after ring_init: threads past kThreads
// call become_producer (and return when their stream is sent), the others
// become_consumer. The producer warpgroup hands registers to the two
// consumer warpgroups (8 x 240 + 4 x 24 registers a lane fill the SM's file).
__device__ __forceinline__ void become_producer() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
}

__device__ __forceinline__ void become_consumer() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
}

// Barrier of one consumer warpgroup (wm = 0, 1): named barrier 1 + wm. The
// two warpgroups never wait for each other, and the producer runs ahead on
// its own.
__device__ __forceinline__ void group_sync(int wm) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wm) : "memory");
}

// Producer (one thread): `chunks` chunks of `bytes` each from src into the
// ring, in order; advances src.
__device__ __forceinline__ void produce_run(Ring& r, const unsigned char*& src,
                                            int chunks, uint32_t bytes) {
#pragma unroll 1
  for (int c = 0; c < chunks; ++c) {
    mbar_wait(empty_barrier(r, r.stage), r.parity);
    mbar_arrive_expect_tx(full_barrier(r, r.stage), bytes);
    bulk_copy_g2s(r.stages + r.stage * kStageBytes, src, bytes, full_barrier(r, r.stage));
    src += bytes;
    ring_advance(r);
  }
}

// ---- layers ---------------------------------------------------------------

// softplus(x) = logaddexp(x, 0) = max(x, 0) + log(1 + e), e = exp(-|x|), for
// an epilogue whose result is rounded to bf16. One special-function
// instruction and 10 FMA-pipe instructions in place of the accurate expf and
// log1pf: e from ex2.approx.ftz (inline PTX, so no denormal fix-up code
// around it: an e below 2^-126 may as well be 0), and log(1 + e) = e q(e)
// with q the degree-7 minimax polynomial of log(1 + e) / e on [0, 1], so
// small e keeps its relative accuracy and no logarithm is needed. The whole
// stays within 2^-19 relative of the accurate value. That, not the bf16
// half-ulp of 2^-9, is the accuracy that counts: an error of 2^-16 moves
// one activation in ~300 across a bf16 rounding boundary, dozens of times
// more often than the f32 summation order already does, and every such
// flip is a full bf16 ulp downstream (seen on the card as more cells of a
// small frame's iso-surface changing sides).
// Eight values go through it stage by stage: a warp in its epilogue has the
// issue slots of its scheduler nearly to itself (the other warpgroup's warp
// there sits in wgmma), so what hides the ~12-instruction dependent chain
// is independent chains side by side, not other warps.
__device__ __forceinline__ void softplus_bf16_grade(float (&v)[8]) {
  constexpr float kQ[8] = {0.9999998211860657f,  -0.49997830390930176f,
                           0.33282285928726196f, -0.2453630566596985f,
                           0.1786196231842041f,  -0.10939399152994156f,
                           0.04533516615629196f, -0.00889513734728098f};
  float e[8], q[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(e[i]) : "f"(-fabsf(v[i]) * 1.4426950408889634f));
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) q[i] = fmaf(kQ[7], e[i], kQ[6]);
#pragma unroll
  for (int k = 5; k >= 0; --k) {
#pragma unroll
    for (int i = 0; i < 8; ++i) q[i] = fmaf(q[i], e[i], kQ[k]);
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) v[i] = fmaf(e[i], q[i], fmaxf(v[i], 0.f));
}

// kFloor is max(x, floor) with a run-time floor: 0 for ReLU, -inf for none.
enum Act { kSoftplus = 0, kFloor = 1, kLeaky = 2 };

template <int ACT>
__device__ __forceinline__ void activate(float (&v)[8], float floor) {
  if constexpr (ACT == kSoftplus) {
    softplus_bf16_grade(v);
  } else if constexpr (ACT == kFloor) {
#pragma unroll
    for (int i = 0; i < 8; ++i) v[i] = fmaxf(v[i], floor);
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i) v[i] = v[i] >= 0.f ? v[i] : 0.02f * v[i];
  }
}

// Keep the compiler from reading or moving accumulator registers across
// the asynchronous products' group waits.
template <int N>
__device__ __forceinline__ void fence_registers(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Generic-proxy writes to a panel (an input build) must be fenced before
// the barrier after which wgmma reads them.
__device__ __forceinline__ void fence_panel_writes() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// A consumer thread's place in the stream of products: the ring, and the
// stage of the step before (to free once that product has retired; before
// the kernel's first step it names the dummy barrier past the last stage).
struct Products {
  Ring ring;
  uint32_t prev_stage;
  uint32_t skew_pending;   // 1 from a skewed start until skew_signal
};

// The two consumer warpgroups would otherwise do the same thing at the same
// time: both in their products (sharing the tensor cores), then both in
// their epilogues (tensor cores idle). So a kernel may ask that, once per
// block, the second starts some chunks after the first: it waits in
// first_products until the first has issued that many products
// (skew_signal), and from then on one's epilogue, input build or fold runs
// beside the other's products. The lead cannot grow or shrink by itself
// (both take every chunk of the one ring), and it must stay below kStages,
// or the first would wait for a stage that only the second can free. The
// delay is paid once per block.
__device__ __forceinline__ Products first_products(const Ring& ring, bool skew) {
  if (skew && threadIdx.x >= 128) asm volatile("bar.sync 3, 256;\n" ::: "memory");
  return Products{ring, static_cast<uint32_t>(kStages), skew ? 1u : 0u};
}

// By every thread of both warpgroups; the first one's arrive, once.
__device__ __forceinline__ void skew_signal(Products& p, int wm) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.u32 p, %0, 0;\n"
      "@p bar.arrive 3, 256;\n"
      "}\n" ::"r"(wm == 0 ? p.skew_pending : 0u)
      : "memory");
  p.skew_pending = 0;
}

// One arrival per warp on the empty barrier of the step before's stage
// (lane 0, predicated inside the asm statement: no branch for the compiler
// to see).
__device__ __forceinline__ void release_previous(const Products& p) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.eq.u32 p, %1, 0;\n"
      "@p mbarrier.arrive.shared::cta.b64 _, [%0];\n"
      "}\n" ::"r"(empty_barrier(p.ring, p.prev_stage)),
      "r"(threadIdx.x & 31)
      : "memory");
}

// Before a k-step's wgmma: wait for the ring's next chunk; its descriptor
// as B (O rows x 16 columns, [k / 8][n][k % 8]).
template <int O>
__device__ __forceinline__ uint64_t next_chunk(const Products& p) {
  mbar_wait(full_barrier(p.ring, p.ring.stage), p.ring.parity);
  wgmma_fence();
  return wgmma_desc(p.ring.stages + p.ring.stage * kStageBytes, O * 16, kCoreBytes);
}

// After it: at most this product stays in flight; the chunk of the step
// before (the last one of the layer before, for a layer's first step) is
// free.
__device__ __forceinline__ void chunk_issued(Products& p) {
  wgmma_commit();
  wgmma_wait<1>();
  release_previous(p);
  p.prev_stage = p.ring.stage;
  ring_advance(p.ring);
}

// acc (+)= A B over KSTEPS k-steps, A the thread's register fragments
// h[4 ks ..], B the ring's next chunks. acc holds O / 2 accumulators a
// thread: rows 16 warp4 + g, + 8 of the warpgroup's 64 and columns
// 8 n + 2 t, + 1 in acc[4 n + {0, 1}], {2, 3}. accumulate = 0 starts a layer.
// SIGNAL_AFTER > 0: skew_signal once that many steps are issued.
template <int O, int KSTEPS, int SIGNAL_AFTER = 0>
__device__ __forceinline__ void products_from_registers(float (&acc)[O / 2],
                                                        const uint32_t (&h)[4 * KSTEPS],
                                                        Products& p, int accumulate,
                                                        int wm = 0) {
#pragma unroll
  for (int ks = 0; ks < KSTEPS; ++ks) {
    if (SIGNAL_AFTER > 0 && ks == SIGNAL_AFTER) skew_signal(p, wm);
    const uint64_t desc_b = next_chunk<O>(p);
    if constexpr (O == 256) {
      wgmma_m64n256k16_rs(acc, h[4 * ks], h[4 * ks + 1], h[4 * ks + 2], h[4 * ks + 3],
                          desc_b, ks > 0 ? 1 : accumulate);
    } else {
      wgmma_m64n128k16_rs(acc, h[4 * ks], h[4 * ks + 1], h[4 * ks + 2], h[4 * ks + 3],
                          desc_b, ks > 0 ? 1 : accumulate);
    }
    chunk_issued(p);
  }
}

// The same with A read by wgmma from the warpgroup's 64 rows of a panel,
// from column 0.
template <int KSTEPS, int O = 256>
__device__ __forceinline__ void products_from_panel(float (&acc)[O / 2],
                                                    const __nv_bfloat16* panel, int wm,
                                                    Products& p, int accumulate) {
  const uint64_t desc_a = wgmma_desc(smem_u32(panel + panel_off(wm * kGroupRows, 0)),
                                     kGroupBytes, kCoreBytes);
#pragma unroll
  for (int ks = 0; ks < KSTEPS; ++ks) {
    const uint64_t desc_b = next_chunk<O>(p);
    const uint64_t desc_a_ks = desc_a + static_cast<uint64_t>(ks * (2 * kGroupBytes >> 4));
    if constexpr (O == 256) {
      wgmma_m64n256k16(acc, desc_a_ks, desc_b, ks > 0 ? 1 : accumulate);
    } else {
      wgmma_m64n128k16(acc, desc_a_ks, desc_b, ks > 0 ? 1 : accumulate);
    }
    chunk_issued(p);
  }
}

// After a layer's last step: all products retired, acc readable. (The last
// chunk's stage is freed by the next layer's first step.)
template <int N>
__device__ __forceinline__ void products_done(float (&acc)[N]) {
  wgmma_wait<0>();
  fence_registers(acc);
}

// The epilogue of a wide layer into registers: h = bf16(act(acc + b)) as the
// next layer's A fragments (h[4 j ..] for its k-step j: columns
// [16 j, 16 j + 16) of this layer's output), eight values at a time.
template <int O, int ACT>
__device__ __forceinline__ void epilogue(const float (&acc)[O / 2], uint32_t (&h)[O / 4],
                                         const float* __restrict__ bias, float floor = 0.f) {
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int j = 0; j < O / 16; ++j) {
    // columns 16 j + 2 t, + 1 (rows g, g + 8) and the same + 8
    const float2 b_lo = __ldg(reinterpret_cast<const float2*>(bias + 16 * j + 2 * t));
    const float2 b_hi = __ldg(reinterpret_cast<const float2*>(bias + 16 * j + 8 + 2 * t));
    float v[8] = {acc[8 * j] + b_lo.x,     acc[8 * j + 1] + b_lo.y,
                  acc[8 * j + 2] + b_lo.x, acc[8 * j + 3] + b_lo.y,
                  acc[8 * j + 4] + b_hi.x, acc[8 * j + 5] + b_hi.y,
                  acc[8 * j + 6] + b_hi.x, acc[8 * j + 7] + b_hi.y};
    activate<ACT>(v, floor);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const __nv_bfloat162 pair = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
      h[4 * j + i] = *reinterpret_cast<const uint32_t*>(&pair);
    }
    // keep the bias loads of later groups from piling up in registers
    asm volatile("" ::: "memory");
  }
}

// An output head with O <= 8 columns (f32, no activation) on mma.sync: each
// warp computes its 16 rows from the register fragments h of K = 16 KSTEPS
// columns and writes dst[row * O + col] (rows of the tile). Its (O, K)
// row-major weights come straight from L2.
template <int KSTEPS, int O>
__device__ __forceinline__ void head_layer(const uint32_t (&h)[4 * KSTEPS],
                                           const __nv_bfloat16* __restrict__ w,
                                           const float* __restrict__ bias, float* dst) {
  static_assert(O <= 8, "head shape");
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const unsigned int* row_w =
      reinterpret_cast<const unsigned int*>(w + (g < O ? g : 0) * (16 * KSTEPS));
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int ks = 0; ks < KSTEPS; ++ks) {
    const uint32_t b0 = g < O ? __ldg(row_w + ks * 8 + t) : 0u;
    const uint32_t b1 = g < O ? __ldg(row_w + ks * 8 + t + 4) : 0u;
    const uint32_t a[4] = {h[4 * ks], h[4 * ks + 1], h[4 * ks + 2], h[4 * ks + 3]};
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

__device__ __forceinline__ float sigmoidf_accurate(float x) {
  return 1.f / (1.f + expf(-x));
}

}  // namespace
