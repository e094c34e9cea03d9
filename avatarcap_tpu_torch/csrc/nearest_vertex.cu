// The nearest database point of each query, for Hopper (sm_90a): k = 1 of
// ops/knn.knn on float32 CUDA tensors (ops/knn.py: nearest_vertex).
//
// It replaces no Pallas kernel: the JAX package's knn
// (avatarcap_tpu/ops/knn.py) is a chunked product, |q|^2 - 2 q.v + |v|^2
// over a (chunk, M) tile and an argmin, left to XLA. Its plain port did the
// same on the card: a K = 3 GEMM wrote a float32 (chunk, M) tile, three
// elementwise passes rewrote it and a reduction read it again, ~1.8 GB of
// device memory a 65,536-row chunk against the 6,842-vertex toy body. The
// textured frame's anchor distances (2,621,440 queries, 17.9 G pairs) took
// ~255 ms that way on an H100.
//
// What bounds it on an H100: float32 instruction issue. A pair costs six
// instructions at the least (the product's multiply and two fused
// multiply-adds, the -2 g + |q|^2, the + |v|^2 and a minimum) and reads
// nothing from device memory; 132 SMs x 4 schedulers issue ~3.3e13 lane
// instructions a second at the boost clock, ~3.2 ms for the frame's pairs.
// The design keeps every operand on chip:
//   - the database is staged in dynamic shared memory as one float4 a
//     point, (x, y, z, |v|^2), the wrapper having computed |v|^2 as the
//     plain path does; the body (6,842 points, 107 KB) is one stage, and two
//     blocks fit an SM; a larger database streams through in stages of
//     kStageVertices;
//   - a block serves kBlockQueries queries; each lane holds
//     kQueriesPerLane of them, with |q|^2 (again the plain path's, from the
//     wrapper) and a running (min, index) each, in registers; every warp
//     holds the same queries and scans its own eighth of each stage, so a
//     small launch (a train step's 65,536 queries) still fills the card;
//   - a point is one broadcast 16-byte shared load that serves all of a
//     lane's queries: no bank conflicts, no global traffic in the loop;
//   - the scan takes the minimum of kGroup points at a time and keeps the
//     group's first index with it (a compare and two selects a group, not
//     a point); once the scan is done, the index is the first point of its
//     group whose distance, computed again, equals the minimum;
//   - at the end the warps' (min, index) pairs meet in shared memory and
//     the lowest distance wins, the lowest index among equal ones.
// Rounding repeats the plain path's, so the outputs are its bits:
// g = q.v in the K = 3 GEMM's order (one product, then fused
// multiply-adds in k order), t = fma(-2, g, |q|^2) = fl(|q|^2 - 2 g) (2 g
// is exact), d = t + |v|^2, each rounded by itself (the *_rn intrinsics: no
// contraction); the scan keeps the first index of a minimum (torch.min's
// choice on ties); the minimum is clamped at 0. Inputs are finite, and
// |v|^2 is never -0, so d is never -0 and a minimum's bits are its value's.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBlockThreads = 256;
constexpr int kWarps = kBlockThreads / 32;
constexpr int kQueriesPerLane = 8;
constexpr int kBlockQueries = 32 * kQueriesPerLane;
// points whose minimum the scan takes before it compares with the running one
constexpr int kGroup = 4;
// 112 KB of float4s: two blocks an SM (of its 228 KB) with the body whole
constexpr int kStageVertices = 7168;
// the warps' (min, index) pairs, in the stage's memory after the last stage
constexpr int kCombineBytes = kWarps * kBlockQueries * 8;

__device__ __forceinline__ float distance(float x, float y, float z, float qq, float4 v) {
  const float g = __fmaf_rn(z, v.z, __fmaf_rn(y, v.y, __fmul_rn(x, v.x)));
  return __fadd_rn(__fmaf_rn(-2.f, g, qq), v.w);
}

__global__ void __launch_bounds__(kBlockThreads, 2)
    nearest_vertex_kernel(const float* __restrict__ queries, const float* __restrict__ qsq,
                          long long n, const float4* __restrict__ db, int m,
                          float* __restrict__ d2, long long* __restrict__ idx) {
  extern __shared__ float4 stage[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long row0 = static_cast<long long>(blockIdx.x) * kBlockQueries;

  float qx[kQueriesPerLane], qy[kQueriesPerLane], qz[kQueriesPerLane];
  float qq[kQueriesPerLane], best[kQueriesPerLane];
  int at[kQueriesPerLane];
#pragma unroll
  for (int i = 0; i < kQueriesPerLane; ++i) {
    const long long r = row0 + lane + 32 * i;
    const bool in = r < n;                // rows past n are never stored
    qx[i] = in ? queries[3 * r] : 0.f;
    qy[i] = in ? queries[3 * r + 1] : 0.f;
    qz[i] = in ? queries[3 * r + 2] : 0.f;
    qq[i] = in ? qsq[r] : 0.f;
    best[i] = INFINITY;
    at[i] = 0;
  }

  for (int base = 0; base < m; base += kStageVertices) {
    const int count = min(kStageVertices, m - base);
    __syncthreads();                      // the previous stage is read
    for (int t = threadIdx.x; t < count; t += kBlockThreads) stage[t] = db[base + t];
    __syncthreads();
    // this warp's points of the stage: [lo, hi), whole groups up to ``full``
    const int per = (count + kWarps - 1) / kWarps;
    const int lo = min(count, warp * per);
    const int hi = min(count, lo + per);
    const int full = lo + (hi - lo) / kGroup * kGroup;
#pragma unroll 2
    for (int j = lo; j < full; j += kGroup) {
      float4 v[kGroup];
#pragma unroll
      for (int s = 0; s < kGroup; ++s) v[s] = stage[j + s];
#pragma unroll
      for (int i = 0; i < kQueriesPerLane; ++i) {
        float low = distance(qx[i], qy[i], qz[i], qq[i], v[0]);
#pragma unroll
        for (int s = 1; s < kGroup; ++s)
          low = fminf(low, distance(qx[i], qy[i], qz[i], qq[i], v[s]));
        if (low < best[i]) {
          best[i] = low;
          at[i] = base + j;               // the group's first point
        }
      }
    }
    for (int j = full; j < hi; ++j) {
      const float4 v = stage[j];
#pragma unroll
      for (int i = 0; i < kQueriesPerLane; ++i) {
        const float d = distance(qx[i], qy[i], qz[i], qq[i], v);
        if (d < best[i]) {
          best[i] = d;
          at[i] = base + j;
        }
      }
    }
  }
  // the first point of the winning group at the minimum: the same
  // arithmetic on the same operands gives the same bits
#pragma unroll
  for (int i = 0; i < kQueriesPerLane; ++i) {
    const int k = at[i];
    for (int s = 0; s < kGroup && k + s < m; ++s) {
      if (distance(qx[i], qy[i], qz[i], qq[i], db[k + s]) == best[i]) {
        at[i] = k + s;
        break;
      }
    }
  }

  __syncthreads();                        // the last stage is read
  float* part_d = reinterpret_cast<float*>(stage);
  int* part_i = reinterpret_cast<int*>(part_d + kWarps * kBlockQueries);
#pragma unroll
  for (int i = 0; i < kQueriesPerLane; ++i) {
    part_d[warp * kBlockQueries + lane + 32 * i] = best[i];
    part_i[warp * kBlockQueries + lane + 32 * i] = at[i];
  }
  __syncthreads();
  for (int q = threadIdx.x; q < kBlockQueries; q += kBlockThreads) {
    const long long r = row0 + q;
    if (r < n) {
      float b = part_d[q];
      int k = part_i[q];
      for (int w = 1; w < kWarps; ++w) {
        const float d = part_d[w * kBlockQueries + q];
        const int j = part_i[w * kBlockQueries + q];
        if (d < b || (d == b && j < k)) {
          b = d;
          k = j;
        }
      }
      d2[r] = b < 0.f ? 0.f : b;
      idx[r] = k;
    }
  }
}

}  // namespace

// queries (n, 3) and qsq (n,) float32; db (m, 4) float32 rows (x, y, z,
// |v|^2), 16-byte aligned; d2 (n,) float32 and idx (n,) int64 out. Launches
// on ``stream``; n = 0 launches nothing.
extern "C" int nearest_vertex_launch(const float* queries, const float* qsq, long long n,
                                     const void* db, int m, float* d2, long long* idx,
                                     void* stream) {
  if (n <= 0) return 0;
  const long long blocks = (n + kBlockQueries - 1) / kBlockQueries;
  if (m <= 0 || blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const int staged = m < kStageVertices ? m : kStageVertices;
  const size_t stage_bytes = sizeof(float4) * static_cast<size_t>(staged);
  const size_t smem = stage_bytes > kCombineBytes ? stage_bytes : kCombineBytes;
  cudaError_t err = cudaFuncSetAttribute(
      nearest_vertex_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  nearest_vertex_kernel<<<static_cast<unsigned>(blocks), kBlockThreads, smem,
                          static_cast<cudaStream_t>(stream)>>>(
      queries, qsq, n, static_cast<const float4*>(db), m, d2, idx);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* nearest_vertex_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
