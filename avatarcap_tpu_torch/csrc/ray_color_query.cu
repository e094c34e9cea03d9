// Per-ray NeRF color integral (sample generation, pose-feature lerp, warp +
// template query, near-body and bounds masks, alpha compositing), one CUDA
// kernel for Hopper (sm_90a).
//
// Replaces the Pallas kernel avatarcap_tpu/ops/pallas_query.py:
// ray_color_query_fused (pallas_call at :496; body _ray_color_kernel
// :362-440). For each ray (origin ro, direction rd, pose features pf0, pf1
// at its two ends, A anchor distances danch) and each sample s < S:
//   z   = near + gap s,  gap = (far - near) / (S - 1)
//   w   = s / (S - 1);   pf = bf16(f32(pf0) (1 - w) + f32(pf1) w)
//   pts = ro + rd z (f32)
//   geo, rgb, offset = the warp + template chain of K1 on (pts, pf)
//   pos = s (A - 1) / (S - 1); seg = min(floor(pos), A - 2); f = pos - seg
//   d   = (1 - f) danch[seg] + f danch[seg + 1]      (anchored distance)
//   sigma = relu(geo[1]) if d < threshold and bmin < pts + offset < bmax
//           (strictly, on all three axes), else 0
//   alpha = 1 - exp(-sigma gap)
//   acc  += (alpha T) rgb;  T *= 1 - alpha + 1e-10   (T starts at 1)
// and writes acc (R, 3). The scalar constants (near, gap, (A - 1) / (S - 1),
// threshold) arrive as the f32 values the TPU kernel's weak-typed scalars
// take; every scalar step above is one correctly rounded f32 operation
// (__fmul_rn and friends, so nvcc cannot contract them into FMAs), with the
// accurate expf.
//
// What bounds it on an H100: operations. Each sample costs K1's ~1.97 MFLOP
// while a ray reads 6 f32 + 128 bf16 + A f32 and writes 3 f32 for all its S
// samples. So the design is K1's, with the sample loop inside the block:
//   - a block owns 128 rays for all S samples, 16 per consumer warp; its
//     per-ray state (origin, direction, anchor distances, transmittance T
//     and the color sum) stays in shared memory beside K1's two input
//     panels, and each step rebuilds the decoder input panel from it: the
//     sample points in f32 and the lerped pose features (pf0 and pf1 are
//     read from device memory, through L1/L2, at each step: 32 KB a step
//     against the ~2 MB of weights every step streams);
//   - the 20-layer chain is warp_template_core.cuh's (wgmma, hidden
//     activations in registers): the producer thread walks the weight image
//     once per sample, S times in all, through the ring in shared memory,
//     and runs ahead of the consumers across the sample boundary (the next
//     sample's first chunks land while this one is folded);
//   - the fold into T and the color sum runs one thread per ray (16 lanes
//     of the warp that owns it), in the sample order of the TPU kernel's
//     loop (no cumprod); a warp builds, queries and folds only its own rays,
//     so the two warpgroups never wait for each other, and the second one
//     starts 13 chunks after the first (first_products' skew), which puts
//     one's input build, epilogues and fold beside the other's products for
//     all S samples;
//   - ragged tail rays read zeros and are never stored.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "warp_template_core.cuh"

namespace {

constexpr int kMaxAnchors = 16;
// per ray: pts, offset (3 + 3), geo (2), color logits (3), ro, rd (3 + 3),
// T (1), color sum (3), anchor distances (A of the launch, <= kMaxAnchors)
constexpr size_t kRayFloats = 3 + 3 + 2 + 3 + 3 + 3 + 1 + 3;

constexpr size_t smem_bytes(int n_anchors) {
  return kXPanelBytes + kPePanelBytes + kRingBytes +
         sizeof(float) * kTile * (kRayFloats + n_anchors);
}

static_assert(smem_bytes(kMaxAnchors) <= 232448, "shared memory per block exceeded");

struct RayConsts {
  int n_rays, n_samples, n_anchors;
  float near;         // f32(near)
  float gap;          // f32((far - near) / (S - 1))
  float samples_m1;   // f32(S - 1)
  float anchor_step;  // f32((A - 1) / (S - 1))
  float anchors_m2;   // f32(A - 2)
  float threshold;    // f32 near-body distance
};

__global__ void __launch_bounds__(kBlockThreads, 1)
ray_color_query_kernel(const float* __restrict__ ro, const float* __restrict__ rd,
                       const __nv_bfloat16* __restrict__ pf0,
                       const __nv_bfloat16* __restrict__ pf1,
                       const float* __restrict__ danch,
                       const float* __restrict__ bounds, RayConsts k,
                       ChainWeights wt, float* __restrict__ out) {
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* pe = reinterpret_cast<__nv_bfloat16*>(smem + kXPanelBytes);
  unsigned char* ring_mem = smem + kXPanelBytes + kPePanelBytes;
  float* s_pts = reinterpret_cast<float*>(ring_mem + kRingBytes);  // [T][3]
  float* s_off = s_pts + kTile * 3;                                // [T][3]
  float* s_geo = s_off + kTile * 3;                                // [T][2]
  float* s_clr = s_geo + kTile * 2;                                // [T][3]
  float* s_ro = s_clr + kTile * 3;                                 // [T][3]
  float* s_rd = s_ro + kTile * 3;                                  // [T][3]
  float* s_trans = s_rd + kTile * 3;                               // [T]
  float* s_acc = s_trans + kTile;                                  // [T][3]
  float* s_anch = s_acc + kTile * 3;                               // [T][A]
  const int base = blockIdx.x * kTile;
  const int n = k.n_rays, A = k.n_anchors;

  Ring ring = ring_init(ring_mem, threadIdx.x >= kThreads);
  if (threadIdx.x >= kThreads) {               // the producer warpgroup
    become_producer();
    if (threadIdx.x == kThreads) {
#pragma unroll 1
      for (int s = 0; s < k.n_samples; ++s) {
        produce_offset(ring, wt.off);
        produce_template(ring, wt.tpl);
      }
    }
    return;
  }
  become_consumer();
  Products products = first_products(ring, true);
  // each warp loads, builds, folds and stores its own 16 rays of the tile
  const int wm = threadIdx.x >> 7, lane = threadIdx.x & 31;
  const int row0 = (threadIdx.x >> 5) * 16;

  for (int i = lane; i < 16 * 3; i += 32) {
    const int r = row0 + i / 3, j = r * 3 + i % 3;
    const size_t g = static_cast<size_t>(base) * 3 + j;
    s_ro[j] = base + r < n ? ro[g] : 0.f;
    s_rd[j] = base + r < n ? rd[g] : 0.f;
    s_acc[j] = 0.f;
  }
  for (int i = lane; i < 16 * A; i += 32) {
    const int r = row0 + i / A, j = row0 * A + i;
    s_anch[j] = base + r < n ? danch[static_cast<size_t>(base) * A + j] : 0.f;
  }
  if (lane < 16) s_trans[row0 + lane] = 1.f;
  __syncwarp();

#pragma unroll 1
  for (int s = 0; s < k.n_samples; ++s) {
    const float sf = static_cast<float>(s);
    const float z = __fadd_rn(k.near, __fmul_rn(k.gap, sf));
    const float w1 = __fdiv_rn(sf, k.samples_m1);
    const float w0 = __fsub_rn(1.f, w1);

    // decoder input x = [bf16(pts), bf16(lerped pf)] in xs[:, 0:67]
    for (int i = lane; i < 16 * 3; i += 32) {
      const int r = row0 + i / 3, c = i % 3;
      const float v = __fadd_rn(s_ro[r * 3 + c], __fmul_rn(s_rd[r * 3 + c], z));
      s_pts[r * 3 + c] = v;
      xs[panel_off(r, c)] = __float2bfloat16_rn(v);
    }
    for (int i = lane; i < 16 * 32; i += 32) {
      const int r = row0 + (i >> 5), c = 2 * (i & 31);
      float2 a = make_float2(0.f, 0.f), b = make_float2(0.f, 0.f);
      if (base + r < n) {
        const size_t g = static_cast<size_t>(base + r) * 64 + c;
        a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(pf0 + g));
        b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(pf1 + g));
      }
      xs[panel_off(r, 3 + c)] =
          __float2bfloat16_rn(__fadd_rn(__fmul_rn(a.x, w0), __fmul_rn(b.x, w1)));
      xs[panel_off(r, 4 + c)] =
          __float2bfloat16_rn(__fadd_rn(__fmul_rn(a.y, w0), __fmul_rn(b.y, w1)));
    }
    zero_input_pad(xs);
    fence_panel_writes();
    group_sync(wm);

    offset_decoder(xs, wm, products, wt.off, s_off);

    // warp in f32, PE(10) of the warped points into pe[:, 0:64]
    for (int i = lane; i < 16 * 3; i += 32) {
      const int r = row0 + i / 3, c = i % 3;
      pe_coord(pe, r, c, __fadd_rn(s_pts[r * 3 + c], s_off[r * 3 + c]));
    }
    zero_pe_pad(pe);
    fence_panel_writes();
    group_sync(wm);

    template_mlp(pe, wm, products, wt.tpl, s_geo, s_clr);

    // fold the sample into the ray's transmittance and color sum
    if (lane < 16) {
      const int r = row0 + lane;
      const float pos = __fmul_rn(sf, k.anchor_step);
      const float seg = fminf(floorf(pos), k.anchors_m2);
      const float f = __fsub_rn(pos, seg);
      const int a0 = static_cast<int>(seg);
      const float d = __fadd_rn(__fmul_rn(__fsub_rn(1.f, f), s_anch[r * A + a0]),
                                __fmul_rn(f, s_anch[r * A + a0 + 1]));
      bool inside = d < k.threshold;
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const float wp = __fadd_rn(s_pts[3 * r + c], s_off[3 * r + c]);
        inside = inside && wp > __ldg(bounds + c) && wp < __ldg(bounds + 3 + c);
      }
      const float sigma = inside ? fmaxf(s_geo[2 * r + 1], 0.f) : 0.f;
      const float alpha = __fsub_rn(1.f, expf(-__fmul_rn(sigma, k.gap)));
      const float trans = s_trans[r];
      const float wgt = __fmul_rn(alpha, trans);
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        s_acc[3 * r + c] = __fadd_rn(s_acc[3 * r + c],
                                     __fmul_rn(wgt, sigmoidf_accurate(s_clr[3 * r + c])));
      }
      s_trans[r] = __fmul_rn(trans, __fadd_rn(__fsub_rn(1.f, alpha), 1e-10f));
    }
    __syncwarp();
  }

  for (int i = lane; i < 16 * 3; i += 32) {
    const int r = row0 + i / 3, j = r * 3 + i % 3;
    if (base + r < n) out[static_cast<size_t>(base) * 3 + j] = s_acc[j];
  }
}

}  // namespace

// C interface (loaded with ctypes). ro, rd (R, 3) f32; pf0, pf1 (R, 64)
// bf16; danch (R, A) f32; bounds (2, 3) f32 (min, max); out (R, 3) f32, all
// contiguous on the device. near, gap, anchor_step and threshold are the f32
// constants of the header; image and bias are K1's joint weight image.
// Launches on `stream` and returns the cudaError_t of the launch (0 =
// success; cudaErrorInvalidValue for S < 2 or A outside [2, 16]).
extern "C" int rcq_launch(const float* ro, const float* rd, const void* pf0,
                          const void* pf1, const float* danch,
                          const float* bounds, int n_rays, int n_samples,
                          int n_anchors, float near, float gap,
                          float anchor_step, float threshold,
                          const void* image, const void* bias, float* out,
                          void* stream) {
  if (n_rays <= 0) return 0;
  if (n_samples < 2 || n_anchors < 2 || n_anchors > kMaxAnchors) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const RayConsts k{n_rays, n_samples, n_anchors, near, gap,
                    static_cast<float>(n_samples - 1), anchor_step,
                    static_cast<float>(n_anchors - 2), threshold};
  cudaError_t err = cudaFuncSetAttribute(
      ray_color_query_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem_bytes(kMaxAnchors)));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (n_rays + kTile - 1) / kTile;
  ray_color_query_kernel<<<blocks, kBlockThreads, smem_bytes(n_anchors),
                           static_cast<cudaStream_t>(stream)>>>(
      ro, rd, static_cast<const __nv_bfloat16*>(pf0),
      static_cast<const __nv_bfloat16*>(pf1), danch, bounds, k,
      chain_weights(image, bias), out);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* rcq_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
