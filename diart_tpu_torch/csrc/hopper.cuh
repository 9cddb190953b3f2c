// Hopper building blocks shared by the port's tensor-core kernels: shared
// addresses, `cp.async` copies, and the `wgmma` shared-memory descriptor and
// fences. Every tile that a descriptor names lies in the 128-byte-swizzled
// layout: rows of 128 bytes, the 16-byte chunk c of row r stored at chunk
// c ^ (r % 8), tiles starting on a 1024-byte boundary.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace hopper {

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// byte offset of 16-byte chunk `chunk` of row `row` in a 128-byte-swizzled tile
__device__ __forceinline__ unsigned swizzle128(int row, int chunk) {
  return row * 128 + ((chunk ^ (row & 7)) << 4);
}

// 16 bytes global -> shared; `bytes` = 0 fills the destination with zeros
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes = 16) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(bytes));
}
// N (4, 8 or 16) bytes global -> shared, both N-byte aligned; `bytes` = 0
// fills the destination with zeros
template <int N>
__device__ __forceinline__ void cp_async_ca(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(smem_u32(dst)), "l"(src),
               "n"(N), "r"(bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// shared-memory matrix descriptor, 128-byte swizzle. K-major operand: rows
// are M or N, `sbo` the stride of 8-row groups (1024), `lbo` unused. MN-major
// operand: rows are k, `sbo` the stride of 8-k-row groups (1024), `lbo` the
// stride of 64-element (16-bit) panels along M or N.
__device__ __forceinline__ uint64_t wgmma_desc(unsigned addr, unsigned lbo_bytes,
                                               unsigned sbo_bytes) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo_bytes >> 4) << 16) |
         ((uint64_t)(sbo_bytes >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// generic-proxy writes to shared memory become visible to the tensor cores
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

}  // namespace hopper
