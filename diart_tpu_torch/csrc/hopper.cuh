// Hopper building blocks shared by the port's kernels: shared addresses,
// `cp.async` copies, the `wgmma` shared-memory descriptor and fences,
// `mbarrier`s, thread block clusters (a cluster barrier, stores into a peer
// block's shared memory), and the tensor-map encoder of the TMA. A tile that a
// descriptor names lies in a swizzled layout: rows of 128 bytes (or of 64
// or 32), the 16-byte chunk c of row r stored at chunk c ^ (r % 8) (its
// 64- and 32-byte forms), tiles starting on a 1024-byte boundary.

#pragma once

#include <cuda.h>
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

// shared-memory matrix descriptor, `swizzle` (128, 64 or 32) bytes a row.
// K-major operand: rows are M or N, `sbo` the stride of 8-row groups (8 x
// the row), `lbo` unused. MN-major operand (128-byte swizzle): rows are k,
// `sbo` the stride of 8-k-row groups (1024), `lbo` the stride of
// 64-element (16-bit) panels along M or N.
__device__ __forceinline__ uint64_t wgmma_desc(unsigned addr, unsigned lbo_bytes,
                                               unsigned sbo_bytes, unsigned swizzle = 128) {
  const uint64_t layout = swizzle == 128 ? 1 : swizzle == 64 ? 2 : 3;
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo_bytes >> 4) << 16) |
         ((uint64_t)(sbo_bytes >> 4) << 32) | (layout << 62);
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

__device__ __forceinline__ void mbar_init(unsigned bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count));
}
__device__ __forceinline__ void mbar_expect_tx(unsigned bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(unsigned bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
// A wait that outlasts 2^34 cycles (seconds) is a fault of the pipeline,
// not a slow load: trap, so that the launch fails instead of hanging.
__device__ __forceinline__ void mbar_wait(unsigned bar, unsigned parity) {
  const long long t0 = clock64();
  for (;;) {
    unsigned done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (clock64() - t0 > (1ll << 34)) __trap();
  }
}

// Thread block clusters: a barrier of every thread of the cluster, the
// shared::cluster address of `addr` (a shared::cta address) in block `rank`,
// and 16 bytes stored into another block's shared memory that count on its
// mbarrier `bar` (complete_tx), so a waiter on that mbarrier sees them.
__device__ __forceinline__ void cluster_barrier() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n"
               "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}
__device__ __forceinline__ unsigned map_rank(unsigned addr, unsigned rank) {
  unsigned out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(out) : "r"(addr), "r"(rank));
  return out;
}
__device__ __forceinline__ void st_async16(unsigned addr, const float4& v, unsigned bar) {
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.b32 [%0], {%1, %2, %3, %4}, [%5];\n"
               ::"r"(addr), "r"(__float_as_uint(v.x)), "r"(__float_as_uint(v.y)), "r"(__float_as_uint(v.z)),
               "r"(__float_as_uint(v.w)), "r"(bar)
               : "memory");
}

// cuTensorMapEncodeTiled, looked up through the runtime's entry-point query
// (no -lcuda)
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult status;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &status);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &status);
#endif
    if (status == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

}  // namespace hopper
