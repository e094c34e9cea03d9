// bf16 tensor-core helpers shared by the port's kernels: mma.sync m16n8k16
// with f32 accumulators (the output heads), and the shared-space address of
// a shared-memory object.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

// d += a b for one m16n8k16 tile: a row-major, b column-major, d f32.
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The address of a shared-memory object in the shared state space.
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
