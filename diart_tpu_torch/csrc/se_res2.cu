// Fused ECAPA SE-Res2Block, for Hopper.
//
// Replaces the TPU kernel `_res2_kernel` of diart_tpu/ops/pallas_res2.py
// (reached through `_run_kernel` / `fused_se_res2_block`), and, in stage
// mode, its diagnostics `_staged_kernel` (scripts/res2_stage_debug.py)
// and the `run_variant` kernels (scripts/res2_fix_experiments.py). Same
// function, in the activation dtype dt (f32 or bf16) with f32 sums:
//
//   z1  = dt(a1 * relu(x @ w1 + b1) + c1)                 1x1 TDNN
//   g_i = chunk i of z1 (64 channels); y_0 = g_0
//   y_i = dt(ag_i * relu(conv_d(dt(g_i + y_{i-1})) + bg_i) + cg_i)   i = 1..7
//         (3-tap dilated 64x64 convolution, reflect-padded in time)
//   z2  = dt(a2 * relu(cat(y_0..y_7) @ w2 + b2) + c2)     1x1 TDNN
//   gate = sigmoid(relu(mean_t(z2) @ ws1 + bs1) @ ws2 + bs2)   (f32)
//   out = dt(x + dt(z2 * dt(gate)))
//
// with the rounding points of `se_res2_block_reference` (the bf16 products
// are exact in f32, so only the order of the f32 sums differs from it).
//
// What bounds it on the H100: at the ECAPA trunk (B=64, T=501, C=512) one
// block is 39 GFLOP (two 512x512 products of 16.8 GFLOP each and the
// 5.5 GFLOP cascade) against ~66 MB of bf16 input and output: bound by
// operations. A whole (501, 512) activation does not fit in one SM's shared
// memory, so the block runs as five launches on the caller's stream, all
// hand-written; the intermediates make one round trip through memory
// (mostly L2):
//
// (a) z1 = TDNN(x). bf16: `tdnn_wgmma`, a 128 x 128 output tile per block,
//     two warpgroups of 64 frames each, on the tensor cores with `wgmma`
//     m64n128k16: X and W arrive through a 3-stage `cp.async` ring of
//     64-deep k slices, written in the 128-byte-swizzled layout the
//     instruction reads (W as it lies in memory, channels contiguous), so
//     the copies of the next slices are in flight while the products of
//     this one run; the bias/ReLU/affine epilogue in registers, rounded to
//     bf16 on store. Two blocks fit a multiprocessor and cover each other's
//     prologue and epilogue. f32: `tdnn_wgmma_tf32`, the same 128 x 128
//     tiles on the TF32 tensor cores at f32 accuracy (3xTF32: each operand
//     split into hi = rna_tf32(v) and lo = rna_tf32(v - hi), each k8 step
//     accumulating lo.hi + hi.lo + hi.hi, `wgmma` m64n128k8 .tf32; hi.hi
//     and the small terms in two accumulators, since the tensor cores'
//     f32 accumulation truncates, added to nearest at the end). A
//     `wgmma` takes a .tf32 operand from shared memory only K-major, so W
//     comes prepared by the wrapper as W^T (channels x k) already split;
//     X, the A operand, is read from the ring into registers a k8 step at a
//     time and split there, so its lo half never takes shared memory or
//     bandwidth. Slices are 32 deep (128 bytes of f32); the A fragments of
//     two slices live in registers at once, because a `wgmma` reads its A
//     registers while it runs. `tdnn_fma` (64 x 64 FMA tiles) takes the
//     widths that route does not (K or N not a multiple of 8).
// (b) the 7 dependent group convolutions, split in time over
//     (stream, tile) blocks so the whole card works at any batch size.
//     y_7 at frame t needs z1 over t +- 7 pad, so a tile recomputes a halo
//     of (7 - i) pad frames a side of y_i, clipped at the true ends of the
//     sequence, where the reflection (t<0 -> -t, t>=T -> 2(T-1)-t) turns
//     inward; a tile edge never reflects. Each block keeps its window of
//     the group input dt(g_i + y_{i-1}) in shared memory and overwrites it
//     in place with the next group's input between two barriers; y_i's tile
//     rows go to a second buffer (the concat), so no block reads what a
//     neighbour has overwritten.
//     bf16: `res2_cascade_mma` -- the input is rounded to bf16 anyway, so
//     it sits in shared memory as bf16 and each group is a (rows x 192) @
//     (192 x 64) product on the tensor cores: `ldmatrix` takes one row
//     address per lane, so the tap shift and the reflection are index
//     arithmetic on that address and need no halo copy or im2col. The next
//     group's z1 chunk and weights arrive by `cp.async` under the products.
//     f32: `res2_cascade_tf32`, the same windows with 3xTF32 `mma.sync`
//     m16n8k8 .tf32: the window sits in shared memory as f32 rows with
//     their 16-byte chunks XOR-swizzled by the row (`ldmatrix` moves the
//     32-bit values as pairs of 16-bit ones and reads 8 rows without a bank
//     conflict), each group's taps as W^T hi and lo (prepared split by the
//     wrapper, rows = output channels, swizzled alike), and each A fragment
//     split into hi and lo in registers. The window and both halves of the
//     taps fill shared memory, so the next group's z1 chunk is read from
//     memory in the epilogue. `res2_cascade_fma` (FMAs, 4 channels x up to
//     16 frames a thread) takes the windows whose shared memory the tensor
//     route exceeds (more than 3 taps at long windows).
// (c) z2 = TDNN(concat), the GEMM of (a), which also writes each
//     (stream, row tile, channel) partial time sum of the rounded z2 in
//     f32, in a fixed order.
//
// The f32 bound on this card: 3 x 39 GFLOP of TF32 at 495 TFLOP/s, 0.24 ms,
// against 0.58 ms for the same work as f32 FMAs (67 TFLOP/s).
// (d) `se_gate`: one block per stream sums the partials in a fixed order
//     (the time mean) and runs the 512->128->512 gate MLP in f32;
//     `se_residual` applies the gate and the residual in place over z2,
//     16 bytes a thread.
//
// Stage mode (`se_res2_staged_launch`) stops after (a) (stage 0: z1) or
// after group k of (b) with the later groups zeroed (stage k:
// cat(g0, y1..yk, 0...)), the semantics of `staged` / `reference_stage`.
// No atomics anywhere: results are deterministic, and do not depend on the
// time tile (each output row sums in the same order wherever it falls).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>

#include "hopper.cuh"

namespace {

using hopper::cp_async16;
using hopper::cp_async_commit;
using hopper::cp_async_wait;
using hopper::fence_async_shared;
using hopper::smem_u32;
using hopper::swizzle128;
using hopper::tf32_split;
using hopper::wgmma_commit;
using hopper::wgmma_desc;
using hopper::wgmma_fence;
using hopper::wgmma_m64n128k8_tf32;
using hopper::wgmma_wait;

typedef __nv_bfloat16 bf16;

constexpr int WIDTH = 64;            // res2 group width the cascade takes
constexpr int MAX_TIME = 512;        // frames: 16 warps x 2 x 16-row tiles of the cascade
constexpr size_t kMaxSmem = 232448;  // 227 KB, the per-block opt-in limit

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float v) { return __float2bfloat16(v); }
// v rounded to T and back
template <typename T> __device__ __forceinline__ float round_to(float v) {
  return to_f(from_f<T>(v));
}

// a * relu(acc + b) + c, each operation rounded in f32 (no contraction)
__device__ __forceinline__ float tdnn_epilogue(float acc, float b, float a, float c) {
  const float y = fmaxf(__fadd_rn(acc, b), 0.0f);
  return __fadd_rn(__fmul_rn(y, a), c);
}

__device__ __forceinline__ void ldmatrix_x4(unsigned addr, unsigned (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(unsigned addr, unsigned (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d (16 x 8, f32) += a (16 x 8) @ b (8 x 8), TF32
__device__ __forceinline__ void mma_tf32(float (&d)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(bf16* p, bf16 a, bf16 b) {
  __nv_bfloat162 pair;
  pair.x = a;
  pair.y = b;
  *reinterpret_cast<__nv_bfloat162*>(p) = pair;
}

// --------------------------------------------------------------------- //
// (a)/(c) 1x1 TDNN: Y = dt(a * relu(X @ W + b) + c), X (B, T, K), W (K, N),
// v (3, N) = [b; a; c]. part (B, row tiles, N) gets the column sums of the
// rounded Y over each row tile's valid frames (when not null).

constexpr int FT = 64;    // f32 GEMM tile: frames and channels
constexpr int FNT = 256;  // its threads

__global__ void __launch_bounds__(FNT) tdnn_fma(const float* __restrict__ x,
                                                const float* __restrict__ w,
                                                const float* __restrict__ v, float* __restrict__ y,
                                                float* __restrict__ part, int time, int kdim,
                                                int ndim) {
  constexpr int KC = 32;
  __shared__ float xs[FT][KC + 1];
  __shared__ __align__(16) float ws[KC][FT];
  __shared__ float red[FT / 4][FT];

  const int n0 = blockIdx.x * FT, t0 = blockIdx.y * FT, b = blockIdx.z;
  const int tid = threadIdx.x;
  const int tx = tid % (FT / 4);  // channels tx*4 .. +3
  const int ty = tid / (FT / 4);  // frames ty*4 .. +3
  const float* xb = x + (size_t)b * time * kdim;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[i][q] = 0.0f;

  for (int k0 = 0; k0 < kdim; k0 += KC) {
#pragma unroll
    for (int r = 0; r < FT * KC / FNT; ++r) {
      const int e = tid + r * FNT;
      const int t = e / KC, k = e % KC;
      const bool ok = (t0 + t < time) && (k0 + k < kdim);
      xs[t][k] = ok ? xb[(size_t)(t0 + t) * kdim + k0 + k] : 0.0f;
    }
#pragma unroll
    for (int r = 0; r < KC * FT / FNT; ++r) {
      const int e = tid + r * FNT;
      const int k = e / FT, c = e % FT;
      const bool ok = (k0 + k < kdim) && (n0 + c < ndim);
      ws[k][c] = ok ? w[(size_t)(k0 + k) * ndim + n0 + c] : 0.0f;
    }
    __syncthreads();
#pragma unroll 8
    for (int k = 0; k < KC; ++k) {
      const float4 wv = *reinterpret_cast<const float4*>(&ws[k][tx * 4]);
      const float wq[4] = {wv.x, wv.y, wv.z, wv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float xv = xs[ty * 4 + i][k];
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[i][q] = fmaf(xv, wq[q], acc[i][q]);
      }
    }
    __syncthreads();
  }

  float colsum[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int n = n0 + tx * 4 + q;
    if (n >= ndim) continue;
    const float bq = v[n], aq = v[ndim + n], cq = v[2 * ndim + n];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int t = t0 + ty * 4 + i;
      if (t >= time) continue;
      const float out = tdnn_epilogue(acc[i][q], bq, aq, cq);
      y[((size_t)b * time + t) * ndim + n] = out;
      colsum[q] += out;
    }
  }
  if (part == nullptr) return;
#pragma unroll
  for (int q = 0; q < 4; ++q) red[ty][tx * 4 + q] = colsum[q];
  __syncthreads();
  if (tid < FT && n0 + tid < ndim) {
    float sum = 0.0f;
    for (int g = 0; g < FT / 4; ++g) sum += red[g][tid];
    part[((size_t)b * gridDim.y + blockIdx.y) * ndim + n0 + tid] = sum;
  }
}

// bf16 on the tensor cores with `wgmma`; K % 64 == 0, N % 8 == 0. A block of
// two warpgroups computes a 128 x 128 tile: warpgroup g the 64 frames g*64..,
// each k slice of 64 as four m64n128k16 products whose A (frames x k, k
// contiguous) and B (k x channels, channels contiguous, as W lies in memory)
// both come from shared memory in the 128-byte-swizzled layout.
constexpr int WBM = 128, WBN = 128, WBK = 64;
constexpr int WST = 3;     // cp.async ring depth
constexpr int WNT = 256;   // threads: 2 warpgroups
constexpr int W_A_BYTES = WBM * WBK * 2;  // 16 KB: 128 rows of 128 bytes
constexpr int W_B_BYTES = WBK * WBN * 2;  // 16 KB: 2 panels of 64 k rows of 128 bytes
constexpr size_t kWgmmaSmem = 1024 + (size_t)WST * (W_A_BYTES + W_B_BYTES) + sizeof(float) * 8 * WBN;

// d (64 x 128, f32) += A (64 x 16, k-major) @ B (16 x 128, n-major)
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[16][4], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]), "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]), "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]), "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]), "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]), "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]), "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]), "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]), "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]), "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]), "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]), "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]), "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]), "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]), "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3])
      : "l"(da), "l"(db));
}

// The epilogue of a 128 x 128 tile held as two warpgroups' m64n128
// accumulators: acc[j][0..1] -> frame r0, [2..3] -> r0 + 8; columns n0 + 8 j
// + 2 tig + {0, 1}. Y = dt(a * relu(acc + b) + c); part (when not null) gets
// the column sums of the rounded Y over the tile's valid frames: the 8 row
// groups of a warp by shuffles, then the 8 warps, in a fixed order.
template <typename T>
__device__ __forceinline__ void tdnn_tile_epilogue(const float (&acc)[16][4],
                                                   const float* __restrict__ v, T* __restrict__ y,
                                                   float* __restrict__ part, float* red, int time,
                                                   int ndim, int n0, int t0, int b) {
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tig = lane & 3;
  const int r0 = t0 + warp * 16 + g;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int n = n0 + j * 8 + tig * 2;
    float colsum[2] = {0.0f, 0.0f};
    if (n < ndim) {  // ndim % 8 == 0: both columns in or both out
      const float b0 = v[n], b1 = v[n + 1];
      const float a0 = v[ndim + n], a1 = v[ndim + n + 1];
      const float c0 = v[2 * ndim + n], c1 = v[2 * ndim + n + 1];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int t = r0 + h * 8;
        if (t >= time) continue;
        const T o0 = from_f<T>(tdnn_epilogue(acc[j][2 * h], b0, a0, c0));
        const T o1 = from_f<T>(tdnn_epilogue(acc[j][2 * h + 1], b1, a1, c1));
        store2(&y[((size_t)b * time + t) * ndim + n], o0, o1);
        colsum[0] += to_f(o0);
        colsum[1] += to_f(o1);
      }
    }
    if (part == nullptr) continue;
    // sum the 8 row groups of a warp (lane bits 2..4); the 8 warps meet below
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      float s = colsum[p];
      s += __shfl_xor_sync(0xffffffffu, s, 4);
      s += __shfl_xor_sync(0xffffffffu, s, 8);
      s += __shfl_xor_sync(0xffffffffu, s, 16);
      if (g == 0) red[warp * WBN + j * 8 + tig * 2 + p] = s;
    }
  }
  if (part == nullptr) return;
  __syncthreads();
  if (tid < WBN && n0 + tid < ndim) {
    float sum = 0.0f;
#pragma unroll
    for (int q = 0; q < 8; ++q) sum += red[q * WBN + tid];
    part[((size_t)b * gridDim.y + blockIdx.y) * ndim + n0 + tid] = sum;
  }
}

__global__ void __launch_bounds__(WNT, 2) tdnn_wgmma(const bf16* __restrict__ x,
                                                     const bf16* __restrict__ w,
                                                     const float* __restrict__ v,
                                                     bf16* __restrict__ y, float* __restrict__ part,
                                                     int time, int kdim, int ndim) {
  extern __shared__ unsigned char smem_raw[];
  // the swizzle repeats every 1024 bytes: tiles start on that boundary
  const unsigned base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  unsigned char* tiles = smem_raw + (base - smem_u32(smem_raw));
  float* red = reinterpret_cast<float*>(tiles + WST * (W_A_BYTES + W_B_BYTES));  // [8][WBN]

  const int n0 = blockIdx.x * WBN, t0 = blockIdx.y * WBM, b = blockIdx.z;
  const int tid = threadIdx.x;
  const int wgrp = tid >> 7;
  const bf16* xb = x + (size_t)b * time * kdim;

  auto load = [&](int stage, int kb) {
    const int k0 = kb * WBK;
    unsigned char* xd = tiles + stage * (W_A_BYTES + W_B_BYTES);
    unsigned char* wd = xd + W_A_BYTES;
#pragma unroll
    for (int r = 0; r < WBM * 8 / WNT; ++r) {  // X: 128 rows x 8 chunks of 16 bytes
      const int e = tid + r * WNT;
      const int row = e >> 3, c = e & 7;
      const bool ok = t0 + row < time;
      cp_async16(xd + row * 128 + ((c ^ (row & 7)) << 4),
                 xb + (size_t)(ok ? t0 + row : 0) * kdim + k0 + c * 8, ok ? 16 : 0);
    }
#pragma unroll
    for (int r = 0; r < WBK * 16 / WNT; ++r) {  // W: 64 k rows x 16 chunks, two 64-wide panels
      const int e = tid + r * WNT;
      const int k = e >> 4, cn = e & 15;
      const bool ok = n0 + cn * 8 < ndim;
      cp_async16(wd + (cn >> 3) * (W_B_BYTES / 2) + k * 128 + (((cn & 7) ^ (k & 7)) << 4),
                 w + (size_t)(k0 + k) * ndim + (ok ? n0 + cn * 8 : 0), ok ? 16 : 0);
    }
  };

  float acc[16][4];
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[j][i] = 0.0f;

  const int nk = kdim / WBK;
#pragma unroll
  for (int s = 0; s < WST - 1; ++s) {
    if (s < nk) load(s, s);
    cp_async_commit();
  }
  for (int kb = 0; kb < nk; ++kb) {
    cp_async_wait<WST - 2>();  // slice kb has landed
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");  // slice kb - 1 is consumed
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // ... for the tensor cores
    __syncthreads();  // ... for every thread
    const unsigned xa = base + (kb % WST) * (W_A_BYTES + W_B_BYTES) + wgrp * 64 * 128;
    const unsigned wa = base + (kb % WST) * (W_A_BYTES + W_B_BYTES) + W_A_BYTES;
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int ks = 0; ks < WBK / 16; ++ks)
      wgmma_m64n128k16(acc, wgmma_desc(xa + ks * 32, 16, 1024),
                       wgmma_desc(wa + ks * 16 * 128, W_B_BYTES / 2, 1024));
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    // the copies of a later slice start under the products, into the stage
    // that slice kb - 1 left
    if (kb + WST - 1 < nk) load((kb + WST - 1) % WST, kb + WST - 1);
    cp_async_commit();
  }
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");

  tdnn_tile_epilogue<bf16>(acc, v, y, part, red, time, ndim, n0, t0, b);
}

// f32 on the TF32 tensor cores (3xTF32); K % 8 == 0, N % 8 == 0. The tiles
// of `tdnn_wgmma`; A, the X tile, from registers, B = W^T hi and lo (N x K,
// k contiguous: `wt` holds hi, then lo) from shared memory, K-major. Slices
// are copied TST - 2 ahead, so a stage is rewritten only after both
// warpgroups' products of the slice before the last are done.
constexpr int TBK = 32;                // k slice: 32 f32 = 128 bytes a row
constexpr int TST = 4;                 // cp.async ring depth
constexpr int T_X_BYTES = WBM * 128;   // 16 KB: 128 frames
constexpr int T_W_BYTES = WBN * 128;   // 16 KB: 128 channels of W^T hi (or lo)
constexpr int T_STAGE = T_X_BYTES + 2 * T_W_BYTES;
constexpr size_t kTf32Smem = 1024 + (size_t)TST * T_STAGE + sizeof(float) * 8 * WBN;

__global__ void __launch_bounds__(WNT, 1) tdnn_wgmma_tf32(const float* __restrict__ x,
                                                          const float* __restrict__ wt,
                                                          const float* __restrict__ v,
                                                          float* __restrict__ y,
                                                          float* __restrict__ part, int time,
                                                          int kdim, int ndim) {
  extern __shared__ unsigned char smem_raw[];
  const unsigned base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  unsigned char* tiles = smem_raw + (base - smem_u32(smem_raw));
  float* red = reinterpret_cast<float*>(tiles + TST * T_STAGE);  // [8][WBN]

  const int n0 = blockIdx.x * WBN, t0 = blockIdx.y * WBM, b = blockIdx.z;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tig = lane & 3;
  const float* xb = x + (size_t)b * time * kdim;
  const float* wlo = wt + (size_t)ndim * kdim;

  auto load = [&](int kb) {  // slice kb into stage kb % TST: X, W^T hi, W^T lo
    const int k0 = kb * TBK;
    unsigned char* xd = tiles + (kb % TST) * T_STAGE;
#pragma unroll
    for (int r = 0; r < WBM * 8 / WNT; ++r) {  // 128 rows x 8 chunks of 16 bytes each
      const int e = tid + r * WNT;
      const int row = e >> 3, c = e & 7;
      const bool kin = k0 + c * 4 < kdim;
      const bool xok = kin && t0 + row < time, wok = kin && n0 + row < ndim;
      const size_t xat = xok ? (size_t)(t0 + row) * kdim + k0 + c * 4 : 0;
      const size_t wat = wok ? (size_t)(n0 + row) * kdim + k0 + c * 4 : 0;
      cp_async16(xd + swizzle128(row, c), xb + xat, xok ? 16 : 0);
      cp_async16(xd + T_X_BYTES + swizzle128(row, c), wt + wat, wok ? 16 : 0);
      cp_async16(xd + T_X_BYTES + T_W_BYTES + swizzle128(row, c), wlo + wat, wok ? 16 : 0);
    }
  };
  // this thread's A rows: warp * 16 + g and + 8 (row % 8 == g: the swizzle),
  // columns 8 ks + tig (+ 4): 16-byte chunk 2 ks (+ 1), 4-byte word tig
  auto frags = [&](int kb, unsigned (&ah)[TBK / 8][4], unsigned (&al)[TBK / 8][4]) {
    const float* xs = reinterpret_cast<const float*>(tiles + (kb % TST) * T_STAGE) + (warp * 16 + g) * 32;
#pragma unroll
    for (int ks = 0; ks < TBK / 8; ++ks)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        tf32_split(xs[(i & 1) * 8 * 32 + (((2 * ks + (i >> 1)) ^ g) << 2) + tig], ah[ks][i], al[ks][i]);
  };

  // hi . hi sums in acc, the small terms in lo_acc (the tensor cores' f32
  // accumulation truncates: a sum 2^11 smaller loses 2^11 less), added
  // once, to nearest, before the epilogue
  float acc[16][4], lo_acc[16][4];
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[j][i] = lo_acc[j][i] = 0.0f;

  const int nk = (kdim + TBK - 1) / TBK;
#pragma unroll
  for (int s = 0; s < TST - 2; ++s) {
    if (s < nk) load(s);
    cp_async_commit();
  }
  auto slice = [&](int kb, unsigned (&ah)[TBK / 8][4], unsigned (&al)[TBK / 8][4]) {
    cp_async_wait<TST - 3>();  // slice kb has landed (this thread's copies)
    fence_async_shared();      // ... for the tensor cores
    __syncthreads();           // ... every thread's; both warpgroups are done with slice kb - 2
    if (kb + TST - 2 < nk) load(kb + TST - 2);  // into slice kb - 2's stage
    cp_async_commit();
    frags(kb, ah, al);  // the last products to read these registers, slice kb - 2's, are done
    const unsigned wh = base + (kb % TST) * T_STAGE + T_X_BYTES, wl = wh + T_W_BYTES;
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < TBK / 8; ++ks) {  // lo . hi + hi . lo, and hi . hi
      wgmma_m64n128k8_tf32(lo_acc, al[ks], wgmma_desc(wh + ks * 32, 16, 1024));
      wgmma_m64n128k8_tf32(lo_acc, ah[ks], wgmma_desc(wl + ks * 32, 16, 1024));
      wgmma_m64n128k8_tf32(acc, ah[ks], wgmma_desc(wh + ks * 32, 16, 1024));
    }
    wgmma_commit();
    wgmma_wait<1>();  // slice kb - 1 is done; slice kb runs on
  };
  // two register sets of A fragments, taken in turns
  unsigned ah0[TBK / 8][4], al0[TBK / 8][4], ah1[TBK / 8][4], al1[TBK / 8][4];
  for (int kb = 0; kb < nk; kb += 2) {
    slice(kb, ah0, al0);
    if (kb + 1 < nk) slice(kb + 1, ah1, al1);
  }
  wgmma_wait<0>();
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[j][i] = __fadd_rn(acc[j][i], lo_acc[j][i]);
  tdnn_tile_epilogue<float>(acc, v, y, part, red, time, ndim, n0, t0, b);
}

// --------------------------------------------------------------------- //
// (b) the group cascade over one time tile: z1 (B, T, C) -> cat (B, T, C) =
// cat(g0, y1..y_run, [zeros]) on frames [t0, t1) of stream blockIdx.y.
// wg (G, taps, 64, 64) in dt, vg (G, 3, 64) = [b; a; c] f32. The block's
// window is [wlo, whi) = [t0 - run pad, t1 + run pad) clipped to [0, T);
// group i is computed on [lo, hi) = [t0 - (run - i) pad, t1 + (run - i) pad)
// clipped, and its input's rows lo - pad .. hi + pad, reflected at 0 and T,
// all lie inside the rows group i - 1 was computed on.

__device__ __forceinline__ int reflect_row(int t, int time) {
  t = t < 0 ? -t : t;
  return t >= time ? 2 * (time - 1) - t : t;
}

struct Window {
  int t0, t1, wlo, whi, pad;
};

__device__ __forceinline__ Window tile_window(int tile, int time, int taps, int dilation, int run) {
  Window w;
  w.pad = (taps - 1) * dilation / 2;
  w.t0 = blockIdx.x * tile;
  w.t1 = min(time, w.t0 + tile);
  w.wlo = max(0, w.t0 - run * w.pad);
  w.whi = min(time, w.t1 + run * w.pad);
  return w;
}

// chunk 0 passes through; stage mode zeroes the chunks after run_groups
template <typename T>
__device__ __forceinline__ void pass_and_zero(const T* zb, T* cb, const Window& w, int chans,
                                              int run_groups, int zero_rest) {
  constexpr int V = 16 / sizeof(T);  // elements per 16 bytes
  const int rows = w.t1 - w.t0;
  for (int e = threadIdx.x; e < rows * (WIDTH / V); e += blockDim.x) {
    const size_t at = (size_t)(w.t0 + e / (WIDTH / V)) * chans + (e % (WIDTH / V)) * V;
    *reinterpret_cast<uint4*>(cb + at) = *reinterpret_cast<const uint4*>(zb + at);
  }
  if (!zero_rest) return;
  const int c_from = (run_groups + 1) * WIDTH;
  const int span = (chans - c_from) / V;
  for (int e = threadIdx.x; e < rows * span; e += blockDim.x) {
    const size_t at = (size_t)(w.t0 + e / span) * chans + c_from + (e % span) * V;
    *reinterpret_cast<uint4*>(cb + at) = make_uint4(0, 0, 0, 0);
  }
}

constexpr int LDB = WIDTH + 8;  // bf16 row stride (elements): conflict-free ldmatrix

// NW warps: NW / 2 along frames x 2 along channels; a warp owns up to four
// 16-row tiles (interleaved over the frame warps) of 32 channels, so a block
// covers windows of up to 32 NW rows.
template <int NW>
__global__ void __launch_bounds__(NW * 32, NW == 8 ? 2 : 1)
    res2_cascade_mma(const bf16* __restrict__ z1, bf16* __restrict__ cat,
                     const bf16* __restrict__ wg, const float* __restrict__ vg, int time,
                     int chans, int taps, int dilation, int run_groups, int zero_rest, int tile,
                     int rows_cap) {
  constexpr int WM = NW / 2;
  constexpr int NT = NW * 32;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* inp = reinterpret_cast<bf16*>(smem_raw);  // [rows_cap][LDB] group input, in place
  bf16* gst = inp + (size_t)rows_cap * LDB;       // [rows_cap][LDB] next z1 chunk
  bf16* wsm = gst + (size_t)rows_cap * LDB;       // [taps * 64][LDB] this group's taps

  const Window w = tile_window(tile, time, taps, dilation, run_groups);
  const int wrows = w.whi - w.wlo;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 1, wn = warp & 1;
  const int g = lane >> 2, tig = lane & 3;
  const int mat = lane >> 3, mrow = lane & 7;
  const bf16* zb = z1 + (size_t)blockIdx.y * time * chans;
  bf16* cb = cat + (size_t)blockIdx.y * time * chans;

  auto load_chunk = [&](bf16* dst, int gi) {  // chunk gi of z1 over the window
    for (int e = tid; e < wrows * (WIDTH / 8); e += NT) {
      const int r = e >> 3, c = (e & 7) * 8;
      cp_async16(dst + r * LDB + c, zb + (size_t)(w.wlo + r) * chans + gi * WIDTH + c);
    }
  };
  auto load_taps = [&](int gi) {  // the taps of group gi (1-based)
    const bf16* src = wg + (size_t)(gi - 1) * taps * WIDTH * WIDTH;
    for (int e = tid; e < taps * WIDTH * (WIDTH / 8); e += NT) {
      const int r = e >> 3, c = (e & 7) * 8;
      cp_async16(wsm + r * LDB + c, src + r * WIDTH + c);
    }
  };

  load_taps(1);
  load_chunk(inp, 1);
  if (run_groups >= 2) load_chunk(gst, 2);
  cp_async_commit();
  pass_and_zero<bf16>(zb, cb, w, chans, run_groups, zero_rest);
  cp_async_wait<0>();
  __syncthreads();

  for (int gi = 1; gi <= run_groups; ++gi) {
    if (gi > 1 && gi < run_groups) load_chunk(gst, gi + 1);  // under the products
    cp_async_commit();
    const int lo = max(0, w.t0 - (run_groups - gi) * w.pad);
    const int hi = min(time, w.t1 + (run_groups - gi) * w.pad);
    const int nmt = (hi - lo + 15) >> 4;

    float acc[4][4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[j][nt][i] = 0.0f;

    for (int tap = 0; tap < taps; ++tap) {
      const int shift = tap * dilation - w.pad;
      // this lane's ldmatrix row of each tile: shifted, reflected at the
      // sequence's ends; rows past hi are computed and dropped
      unsigned arow[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int t = lo + (wm + WM * j) * 16 + (mat & 1) * 8 + mrow;
        const int src = min(max(reflect_row(t + shift, time), w.wlo), w.whi - 1);
        arow[j] = smem_u32(inp + (src - w.wlo) * LDB + (mat >> 1) * 8);
      }
      const bf16* wt = wsm + tap * WIDTH * LDB;
#pragma unroll
      for (int kk = 0; kk < WIDTH; kk += 16) {
        unsigned bfr[2][4];
#pragma unroll
        for (int np = 0; np < 2; ++np)
          ldmatrix_x4_trans(
              smem_u32(wt + (kk + (mat & 1) * 8 + mrow) * LDB + wn * 32 + np * 16 + (mat >> 1) * 8),
              bfr[np]);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (wm + WM * j >= nmt) continue;  // the same for the whole warp
          unsigned a[4];
          ldmatrix_x4(arow[j] + kk * 2, a);
#pragma unroll
          for (int np = 0; np < 2; ++np) {
            mma_bf16(acc[j][np * 2], a, bfr[np][0], bfr[np][1]);
            mma_bf16(acc[j][np * 2 + 1], a, bfr[np][2], bfr[np][3]);
          }
        }
      }
    }
    cp_async_wait<0>();  // the next chunk has landed
    __syncthreads();     // every read of inp and wsm is done
    if (gi < run_groups) load_taps(gi + 1);  // under the epilogue
    cp_async_commit();

    // y_i = dt(epilogue); its tile rows go out, and dt(g_{i+1} + y_i)
    // replaces the group input in place
    const float* vgi = vg + (size_t)(gi - 1) * 3 * WIDTH;
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int n = wn * 32 + nt * 8 + tig * 2;
      const float b0 = vgi[n], b1 = vgi[n + 1];
      const float a0 = vgi[WIDTH + n], a1 = vgi[WIDTH + n + 1];
      const float c0 = vgi[2 * WIDTH + n], c1 = vgi[2 * WIDTH + n + 1];
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int t = lo + (wm + WM * j) * 16 + g + h * 8;
          if (t >= hi) continue;
          __nv_bfloat162 yv;
          yv.x = __float2bfloat16(tdnn_epilogue(acc[j][nt][2 * h], b0, a0, c0));
          yv.y = __float2bfloat16(tdnn_epilogue(acc[j][nt][2 * h + 1], b1, a1, c1));
          if (t >= w.t0 && t < w.t1)
            *reinterpret_cast<__nv_bfloat162*>(cb + (size_t)t * chans + gi * WIDTH + n) = yv;
          if (gi < run_groups) {
            const int at = (t - w.wlo) * LDB + n;
            const __nv_bfloat162 gv = *reinterpret_cast<const __nv_bfloat162*>(gst + at);
            __nv_bfloat162 next;
            next.x = __float2bfloat16(__bfloat162float(gv.x) + __bfloat162float(yv.x));
            next.y = __float2bfloat16(__bfloat162float(gv.y) + __bfloat162float(yv.y));
            *reinterpret_cast<__nv_bfloat162*>(inp + at) = next;
          }
        }
    }
    cp_async_wait<0>();  // the next taps have landed
    __syncthreads();     // the next group's input is complete, gst is free
  }
}

constexpr int CNT = 512;        // threads of the f32 cascade: 16 (x 4 channels) x 32 frames
constexpr int LDI = WIDTH + 1;  // its input row stride (floats)

__global__ void __launch_bounds__(CNT) res2_cascade_fma(
    const float* __restrict__ z1, float* __restrict__ cat, const float* __restrict__ wg,
    const float* __restrict__ vg, int time, int chans, int taps, int dilation, int run_groups,
    int zero_rest, int tile, int rows_cap) {
  extern __shared__ __align__(16) float smem[];
  float* inp = smem;                                 // [rows_cap][LDI] group input, in place
  float* wsm = smem + (rows_cap * LDI + 3) / 4 * 4;  // [taps * 64][64], 16-byte aligned

  const Window w = tile_window(tile, time, taps, dilation, run_groups);
  const int wrows = w.whi - w.wlo;
  const int tid = threadIdx.x;
  const int tx = tid % 16;  // channels tx*4 .. +3
  const int ty = tid / 16;  // frames lo + ty + 32 m
  const float* zb = z1 + (size_t)blockIdx.y * time * chans;
  float* cb = cat + (size_t)blockIdx.y * time * chans;

  for (int e = tid; e < wrows * WIDTH; e += CNT) {
    const int r = e / WIDTH, c = e % WIDTH;
    inp[r * LDI + c] = zb[(size_t)(w.wlo + r) * chans + WIDTH + c];
  }
  pass_and_zero<float>(zb, cb, w, chans, run_groups, zero_rest);

  for (int gi = 1; gi <= run_groups; ++gi) {
    const float* wgi = wg + (size_t)(gi - 1) * taps * WIDTH * WIDTH;
    for (int e = tid; e < taps * WIDTH * WIDTH; e += CNT) wsm[e] = wgi[e];
    __syncthreads();  // the group input and the taps are staged

    const int lo = max(0, w.t0 - (run_groups - gi) * w.pad);
    const int hi = min(time, w.t1 + (run_groups - gi) * w.pad);
    const int mcount = (hi - lo + 31) >> 5;  // frames a thread owns (<= 16)
    float acc[16][4];
#pragma unroll
    for (int m = 0; m < 16; ++m)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[m][q] = 0.0f;
    for (int tap = 0; tap < taps; ++tap) {
      const int shift = tap * dilation - w.pad;
      int off[16];
#pragma unroll
      for (int m = 0; m < 16; ++m) {  // rows past hi are computed and dropped
        const int src = reflect_row(lo + ty + 32 * m + shift, time);
        off[m] = (min(max(src, w.wlo), w.whi - 1) - w.wlo) * LDI;
      }
      const float* wj = wsm + tap * WIDTH * WIDTH + tx * 4;
#pragma unroll 4
      for (int k = 0; k < WIDTH; ++k) {
        const float4 wv = *reinterpret_cast<const float4*>(wj + k * WIDTH);
#pragma unroll
        for (int m = 0; m < 16; ++m) {
          if (m >= mcount) continue;  // the same for the whole block
          const float iv = inp[off[m] + k];
          acc[m][0] = fmaf(iv, wv.x, acc[m][0]);
          acc[m][1] = fmaf(iv, wv.y, acc[m][1]);
          acc[m][2] = fmaf(iv, wv.z, acc[m][2]);
          acc[m][3] = fmaf(iv, wv.w, acc[m][3]);
        }
      }
    }
    __syncthreads();  // every read of inp and wsm is done

    float bq[4], aq[4], cq[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      bq[q] = vg[((gi - 1) * 3 + 0) * WIDTH + tx * 4 + q];
      aq[q] = vg[((gi - 1) * 3 + 1) * WIDTH + tx * 4 + q];
      cq[q] = vg[((gi - 1) * 3 + 2) * WIDTH + tx * 4 + q];
    }
#pragma unroll
    for (int m = 0; m < 16; ++m) {
      const int t = lo + ty + 32 * m;
      if (m >= mcount || t >= hi) continue;
      float4 yv;
      yv.x = tdnn_epilogue(acc[m][0], bq[0], aq[0], cq[0]);
      yv.y = tdnn_epilogue(acc[m][1], bq[1], aq[1], cq[1]);
      yv.z = tdnn_epilogue(acc[m][2], bq[2], aq[2], cq[2]);
      yv.w = tdnn_epilogue(acc[m][3], bq[3], aq[3], cq[3]);
      const size_t at = (size_t)t * chans + gi * WIDTH + tx * 4;
      if (t >= w.t0 && t < w.t1) *reinterpret_cast<float4*>(cb + at) = yv;
      if (gi < run_groups) {  // g_{i+1} + y_i replaces the group input in place
        const float4 gv = *reinterpret_cast<const float4*>(zb + at + WIDTH);
        float* dst = inp + (t - w.wlo) * LDI + tx * 4;
        dst[0] = __fadd_rn(gv.x, yv.x);
        dst[1] = __fadd_rn(gv.y, yv.y);
        dst[2] = __fadd_rn(gv.z, yv.z);
        dst[3] = __fadd_rn(gv.w, yv.w);
      }
    }
  }
}

// f32 on the TF32 tensor cores (3xTF32). 8 warps: 4 along frames x 2 along
// channels; a warp owns up to JT 16-row tiles (interleaved over the frame
// warps) of 32 channels, so a block covers windows of up to 64 JT rows.
// wgs (G, 2, taps, 64, 64): each group's taps as W^T (output channel, k),
// hi then lo. Shared memory from a 1024-byte boundary: the window's group
// input [rows_cap][64] f32, then the group's taps, hi then lo; every row is
// 256 bytes with 16-byte chunk c stored at c ^ (row % 8), so an `ldmatrix`
// address is the row's address XOR'ed with the k step's chunk bits.
constexpr int CT_NT = 256;  // threads of the tf32 cascade

__host__ __device__ constexpr size_t cascade_tf32_smem(int rows_cap, int taps) {
  return 1024 + (size_t)rows_cap * 256 + (size_t)2 * taps * WIDTH * WIDTH * sizeof(float);
}

template <int JT>
__global__ void __launch_bounds__(CT_NT, 1)
    res2_cascade_tf32(const float* __restrict__ z1, float* __restrict__ cat,
                      const float* __restrict__ wgs, const float* __restrict__ vg, int time,
                      int chans, int taps, int dilation, int run_groups, int zero_rest, int tile,
                      int rows_cap) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const unsigned raw = smem_u32(smem_raw);
  const unsigned base = (raw + 1023u) & ~1023u;
  unsigned char* inp = smem_raw + (base - raw);  // [rows_cap][256 B] group input, in place
  const int tap_bytes = taps * WIDTH * WIDTH * (int)sizeof(float);  // one group's taps, hi or lo
  const unsigned whi = base + rows_cap * 256;

  const Window w = tile_window(tile, time, taps, dilation, run_groups);
  const int wrows = w.whi - w.wlo;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 1, wn = warp & 1;
  const int g = lane >> 2, tig = lane & 3;
  const int mat = lane >> 3, mrow = lane & 7;
  const float* zb = z1 + (size_t)blockIdx.y * time * chans;
  float* cb = cat + (size_t)blockIdx.y * time * chans;

  auto load_chunk = [&](int gi) {  // chunk gi of z1 over the window
    for (int e = tid; e < wrows * 16; e += CT_NT) {
      const int r = e >> 4, c = e & 15;
      cp_async16(inp + r * 256 + ((c ^ (r & 7)) << 4),
                 zb + (size_t)(w.wlo + r) * chans + gi * WIDTH + c * 4);
    }
  };
  auto load_taps = [&](int gi) {  // the taps of group gi (1-based), hi and lo: 2 taps x 64 rows
    const float* src = wgs + (size_t)(gi - 1) * 2 * taps * WIDTH * WIDTH;
    unsigned char* dst = inp + rows_cap * 256;
    for (int e = tid; e < 2 * taps * WIDTH * 16; e += CT_NT) {
      const int r = e >> 4, c = e & 15;
      cp_async16(dst + r * 256 + ((c ^ (r & 7)) << 4), src + r * WIDTH + c * 4);
    }
  };

  load_taps(1);
  load_chunk(1);
  cp_async_commit();
  pass_and_zero<float>(zb, cb, w, chans, run_groups, zero_rest);
  cp_async_wait<0>();
  __syncthreads();

  for (int gi = 1; gi <= run_groups; ++gi) {
    const int lo = max(0, w.t0 - (run_groups - gi) * w.pad);
    const int hi = min(time, w.t1 + (run_groups - gi) * w.pad);
    const int nmt = (hi - lo + 15) >> 4;

    float acc[JT][4][4];
#pragma unroll
    for (int j = 0; j < JT; ++j)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[j][nt][i] = 0.0f;

    for (int tap = 0; tap < taps; ++tap) {
      const int shift = tap * dilation - w.pad;
      // this lane's ldmatrix row of each A tile (rows (mat & 1) * 8 + mrow,
      // k chunk mat >> 1 of the step): shifted, reflected at the sequence's
      // ends; rows past hi are computed and dropped
      unsigned arow[JT];
#pragma unroll
      for (int j = 0; j < JT; ++j) {
        const int t = lo + (wm + 4 * j) * 16 + (mat & 1) * 8 + mrow;
        const int r = min(max(reflect_row(t + shift, time), w.wlo), w.whi - 1) - w.wlo;
        arow[j] = base + r * 256 + (((mat >> 1) ^ (r & 7)) << 4);
      }
      // ... and of the B tiles: output channels wn * 32 + 16 np + (mat >> 1) * 8
      // + mrow, k chunk mat & 1 of the step
      unsigned brow[2];
#pragma unroll
      for (int np = 0; np < 2; ++np)
        brow[np] = whi + tap * WIDTH * 256 + (wn * 32 + np * 16 + (mat >> 1) * 8 + mrow) * 256 +
                   (((mat & 1) ^ mrow) << 4);
#pragma unroll 2
      for (int kk = 0; kk < WIDTH / 8; ++kk) {
        // b[np]: {b0, b1} of channel tile 2 np, then of 2 np + 1
        unsigned bh[2][4], bl[2][4];
#pragma unroll
        for (int np = 0; np < 2; ++np) {
          ldmatrix_x4(brow[np] ^ (kk << 5), bh[np]);
          ldmatrix_x4((brow[np] + tap_bytes) ^ (kk << 5), bl[np]);
        }
#pragma unroll
        for (int j = 0; j < JT; ++j) {
          if (wm + 4 * j >= nmt) continue;  // the same for the whole warp
          unsigned a[4], ah[4], al[4];
          ldmatrix_x4(arow[j] ^ (kk << 5), a);
#pragma unroll
          for (int i = 0; i < 4; ++i) tf32_split(__uint_as_float(a[i]), ah[i], al[i]);
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) {  // the small terms first, then hi . hi
            const int np = nt >> 1, q = (nt & 1) * 2;
            mma_tf32(acc[j][nt], al, bh[np][q], bh[np][q + 1]);
            mma_tf32(acc[j][nt], ah, bl[np][q], bl[np][q + 1]);
            mma_tf32(acc[j][nt], ah, bh[np][q], bh[np][q + 1]);
          }
        }
      }
    }
    __syncthreads();  // every read of inp and of the taps is done
    if (gi < run_groups) load_taps(gi + 1);  // under the epilogue
    cp_async_commit();

    // y_i; its tile rows go out, and g_{i+1} + y_i (g_{i+1} read from z1)
    // replaces the group input in place
    const float* vgi = vg + (size_t)(gi - 1) * 3 * WIDTH;
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int n = wn * 32 + nt * 8 + tig * 2;
      const float b0 = vgi[n], b1 = vgi[n + 1];
      const float a0 = vgi[WIDTH + n], a1 = vgi[WIDTH + n + 1];
      const float c0 = vgi[2 * WIDTH + n], c1 = vgi[2 * WIDTH + n + 1];
#pragma unroll
      for (int j = 0; j < JT; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int t = lo + (wm + 4 * j) * 16 + g + h * 8;
          if (t >= hi) continue;
          const float y0 = tdnn_epilogue(acc[j][nt][2 * h], b0, a0, c0);
          const float y1 = tdnn_epilogue(acc[j][nt][2 * h + 1], b1, a1, c1);
          const size_t at = (size_t)t * chans + gi * WIDTH + n;
          if (t >= w.t0 && t < w.t1) store2(cb + at, y0, y1);
          if (gi < run_groups) {
            const float2 gv = *reinterpret_cast<const float2*>(zb + at + WIDTH);
            const int r = t - w.wlo;
            store2(reinterpret_cast<float*>(inp + r * 256 + (((n >> 2) ^ (r & 7)) << 4)) + (n & 3),
                   __fadd_rn(gv.x, y0), __fadd_rn(gv.y, y1));
          }
        }
    }
    cp_async_wait<0>();  // the next taps have landed
    __syncthreads();     // the next group's input is complete
  }
}

// --------------------------------------------------------------------- //
// (d) SE gate from the partial time sums, one block per stream, then the
// gate and residual elementwise.

// sum_k a[k] * w[k * stride] over [k0, k1) as four interleaved chains (many
// loads in flight), added in a fixed order
__device__ __forceinline__ float dot_strided(const float* a, const float* __restrict__ w,
                                             int stride, int k0, int k1) {
  float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  int k = k0;
#pragma unroll 4
  for (; k + 3 < k1; k += 4)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[i] = fmaf(a[k + i], w[(size_t)(k + i) * stride], acc[i]);
  for (; k < k1; ++k) acc[0] = fmaf(a[k], w[(size_t)k * stride], acc[0]);
  return (acc[0] + acc[1]) + (acc[2] + acc[3]);
}

constexpr int GATE_NT = 512;  // threads of se_gate
constexpr int GATE_KP = 4;    // at most this many k ranges per hidden unit

__global__ void __launch_bounds__(GATE_NT) se_gate(const float* __restrict__ part, int ntiles,
                                                   int time, const float* __restrict__ ws1,
                                                   const float* __restrict__ bs1,
                                                   const float* __restrict__ ws2,
                                                   const float* __restrict__ bs2,
                                                   float* __restrict__ gate, int chans,
                                                   int hidden) {
  extern __shared__ float sm[];
  float* s = sm;                  // [chans] the time mean
  float* h = sm + chans;          // [hidden]
  float* hp = sm + chans + hidden;  // [GATE_KP][hidden] partial sums over k ranges
  const int b = blockIdx.x;
  for (int c = threadIdx.x; c < chans; c += blockDim.x) {
    float sum = 0.0f;
    for (int i = 0; i < ntiles; ++i) sum += part[((size_t)b * ntiles + i) * chans + c];
    s[c] = sum / (float)time;
  }
  __syncthreads();
  const int kparts = min(GATE_KP, max(1, (int)blockDim.x / hidden));
  const int kchunk = (chans + kparts - 1) / kparts;
  for (int e = threadIdx.x; e < hidden * kparts; e += blockDim.x) {
    const int j = e % hidden, q = e / hidden;
    hp[q * hidden + j] = dot_strided(s, ws1 + j, hidden, q * kchunk, min(chans, (q + 1) * kchunk));
  }
  __syncthreads();
  for (int j = threadIdx.x; j < hidden; j += blockDim.x) {
    float acc = 0.0f;
    for (int q = 0; q < kparts; ++q) acc += hp[q * hidden + j];
    h[j] = fmaxf(acc + bs1[j], 0.0f);
  }
  __syncthreads();
  for (int c = threadIdx.x; c < chans; c += blockDim.x) {
    const float acc = dot_strided(h, ws2 + c, chans, 0, hidden);
    gate[(size_t)b * chans + c] = 1.0f / (1.0f + expf(-(acc + bs2[c])));
  }
}

// z (B, T, C) holds z2 on entry and dt(x + dt(z2 * dt(gate))) on exit;
// 16 bytes of x and z a thread (C is a multiple of 64).
template <typename T>
__global__ void se_residual(const T* __restrict__ x, T* __restrict__ z,
                            const float* __restrict__ gate, size_t vectors, int time, int chans) {
  constexpr int V = 16 / sizeof(T);
  const size_t per_stream = (size_t)time * chans;
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < vectors;
       i += (size_t)gridDim.x * blockDim.x) {
    const size_t at = i * V;
    const float* gt = gate + (at / per_stream) * chans + at % chans;
    const uint4 xv = *reinterpret_cast<const uint4*>(x + at);
    uint4 zv = *reinterpret_cast<const uint4*>(z + at);
    const T* xe = reinterpret_cast<const T*>(&xv);
    T* ze = reinterpret_cast<T*>(&zv);
#pragma unroll
    for (int q = 0; q < V; ++q) {
      const float scaled = round_to<T>(__fmul_rn(to_f(ze[q]), round_to<T>(gt[q])));
      ze[q] = from_f<T>(__fadd_rn(to_f(xe[q]), scaled));
    }
    *reinterpret_cast<uint4*>(z + at) = zv;
  }
}

// --------------------------------------------------------------------- //
template <typename K, typename... A>
int launch_with_smem(K kernel, dim3 grid, int threads, size_t smem, cudaStream_t st, A... args) {
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, threads, smem, st>>>(args...);
  return (int)cudaGetLastError();
}

// The f32 routes, chosen by width (the wrapper's `launch_plan` states the
// same rules): the TDNNs take the TF32 tensor cores where K and N are
// multiples of 8, the cascade where its window and taps fit shared memory;
// any other width takes the FMA kernels. `tensor` = false takes the FMA
// kernels at every width (the C interface always passes true; the FMA
// route is kept reachable for comparisons). bf16 always takes its tensor
// cores.
bool tf32_tdnn(int kdim, int ndim) { return kdim % 8 == 0 && ndim % 8 == 0; }
bool tf32_cascade(int rows_cap, int taps) { return cascade_tf32_smem(rows_cap, taps) <= kMaxSmem; }

// row tiles of the TDNN for T frames: the rows of `part`
template <typename T>
int tdnn_tile(bool tensor, int kdim, int ndim) {
  return sizeof(T) == 2 || (tensor && tf32_tdnn(kdim, ndim)) ? WBM : FT;
}

// wt: f32 only, W^T (N, K) split, hi then lo (the tensor-core route's B)
template <typename T>
int launch_tdnn(const T* x, const T* w, const float* wt, const float* v, T* y, float* part,
                int batch, int time, int kdim, int ndim, bool tensor, cudaStream_t st) {
  const dim3 grid((ndim + WBN - 1) / WBN, (time + WBM - 1) / WBM, batch);
  if constexpr (sizeof(T) == 2) {
    return launch_with_smem(tdnn_wgmma, grid, WNT, kWgmmaSmem, st, x, w, v, y, part, time, kdim,
                            ndim);
  } else {
    if (tensor && tf32_tdnn(kdim, ndim))
      return launch_with_smem(tdnn_wgmma_tf32, grid, WNT, kTf32Smem, st, x, wt, v, y, part, time,
                              kdim, ndim);
    const dim3 fgrid((ndim + FT - 1) / FT, (time + FT - 1) / FT, batch);
    tdnn_fma<<<fgrid, FNT, 0, st>>>(x, w, v, y, part, time, kdim, ndim);
  }
  return (int)cudaGetLastError();
}

// `tile`: frames of one time tile (the wrapper's plan); any value >= 1 gives
// the same result. wgs: f32 only, the taps split (the tensor-core route's).
template <typename T>
int launch_cascade(const T* z1, T* cat, const T* wg, const float* wgs, const float* vg, int batch,
                   int time, int chans, int groups, int taps, int dilation, int run_groups,
                   int zero_rest, int tile, bool tensor, cudaStream_t st) {
  tile = std::min(std::max(tile, 1), time);
  const int pad = (taps - 1) * dilation / 2;
  const int rows_cap = (int)std::min((long long)time, (long long)tile + 2LL * run_groups * pad);
  const dim3 grid((time + tile - 1) / tile, batch);
  if constexpr (sizeof(T) == 2) {
    const size_t smem = sizeof(bf16) * LDB * (2 * (size_t)rows_cap + (size_t)taps * WIDTH);
    if (rows_cap <= 256)
      return launch_with_smem(res2_cascade_mma<8>, grid, 256, smem, st, z1, cat, wg, vg, time, chans,
                              taps, dilation, run_groups, zero_rest, tile, rows_cap);
    return launch_with_smem(res2_cascade_mma<16>, grid, 512, smem, st, z1, cat, wg, vg, time, chans,
                            taps, dilation, run_groups, zero_rest, tile, rows_cap);
  } else {
    if (tensor && tf32_cascade(rows_cap, taps)) {
      const size_t smem = cascade_tf32_smem(rows_cap, taps);
      if (rows_cap <= 256)
        return launch_with_smem(res2_cascade_tf32<4>, grid, CT_NT, smem, st, z1, cat, wgs, vg, time,
                                chans, taps, dilation, run_groups, zero_rest, tile, rows_cap);
      return launch_with_smem(res2_cascade_tf32<8>, grid, CT_NT, smem, st, z1, cat, wgs, vg, time,
                              chans, taps, dilation, run_groups, zero_rest, tile, rows_cap);
    }
    const size_t smem =
        sizeof(float) * (((size_t)rows_cap * LDI + 3) / 4 * 4 + (size_t)taps * WIDTH * WIDTH);
    return launch_with_smem(res2_cascade_fma, grid, CNT, smem, st, z1, cat, wg, vg, time, chans,
                            taps, dilation, run_groups, zero_rest, tile, rows_cap);
  }
}

int check_shapes(int batch, int time, int chans, int groups, int taps, int dilation, int tile) {
  const long long pad = (long long)(taps - 1) * dilation / 2;
  if (batch < 1 || batch > 65535 || time < 2 || time > MAX_TIME || dilation < 1 || pad >= time ||
      groups < 1 || chans != (groups + 1) * WIDTH || taps < 1 || taps % 2 == 0 || tile < 1)
    return (int)cudaErrorInvalidValue;
  return 0;
}

// The block's operands as the kernels read them (see se_res2_block_launch).
struct Operands {
  const void *w1, *wg, *w2;
  const float *v1, *vg, *v2, *ws1, *bs1, *ws2, *bs2, *w1s, *wgs, *w2s;
};

template <typename T>
int block_t(const void* x, void* out, void* cat, float* part, float* gate, const Operands& k,
            int batch, int time, int chans, int groups, int taps, int hidden, int dilation,
            int tile, bool tensor, cudaStream_t st) {
  const T* xt = static_cast<const T*>(x);
  T* ot = static_cast<T*>(out);  // z1, then z2, then the block's output
  T* ct = static_cast<T*>(cat);
  int err = launch_tdnn<T>(xt, static_cast<const T*>(k.w1), k.w1s, k.v1, ot, nullptr, batch, time,
                           chans, chans, tensor, st);
  if (err) return err;
  err = launch_cascade<T>(ot, ct, static_cast<const T*>(k.wg), k.wgs, k.vg, batch, time, chans,
                          groups, taps, dilation, groups, 0, tile, tensor, st);
  if (err) return err;
  err = launch_tdnn<T>(ct, static_cast<const T*>(k.w2), k.w2s, k.v2, ot, part, batch, time, chans,
                       chans, tensor, st);
  if (err) return err;
  const int rows = tdnn_tile<T>(tensor, chans, chans);
  se_gate<<<batch, GATE_NT, sizeof(float) * (chans + (1 + GATE_KP) * hidden), st>>>(
      part, (time + rows - 1) / rows, time, k.ws1, k.bs1, k.ws2, k.bs2, gate, chans, hidden);
  err = (int)cudaGetLastError();
  if (err) return err;
  const size_t vectors = (size_t)batch * time * chans * sizeof(T) / 16;
  const int blocks = (int)std::min((vectors + 255) / 256, (size_t)1 << 20);
  se_residual<T><<<blocks, 256, 0, st>>>(xt, ot, gate, vectors, time, chans);
  return (int)cudaGetLastError();
}

// the block on the routes `tensor` gives (see tf32_tdnn)
int block(const void* x, void* out, void* cat, float* part, float* gate, const Operands& k,
          int batch, int time, int chans, int groups, int taps, int hidden, int dilation, int tile,
          int dtype, bool tensor, cudaStream_t st) {
  int err = check_shapes(batch, time, chans, groups, taps, dilation, tile);
  if (err || hidden < 1) return err ? err : (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return block_t<float>(x, out, cat, part, gate, k, batch, time, chans, groups, taps, hidden,
                          dilation, tile, tensor, st);
  if (dtype == 1)
    return block_t<bf16>(x, out, cat, part, gate, k, batch, time, chans, groups, taps, hidden,
                         dilation, tile, tensor, st);
  return (int)cudaErrorInvalidValue;
}

template <typename T>
int staged_t(const void* x, void* out, void* z1, const Operands& k, int batch, int time, int chans,
             int groups, int taps, int dilation, int stage, int tile, cudaStream_t st) {
  T* first = static_cast<T*>(stage == 0 ? out : z1);
  int err = launch_tdnn<T>(static_cast<const T*>(x), static_cast<const T*>(k.w1), k.w1s, k.v1,
                           first, nullptr, batch, time, chans, chans, true, st);
  if (err || stage == 0) return err;
  return launch_cascade<T>(first, static_cast<T*>(out), static_cast<const T*>(k.wg), k.wgs, k.vg,
                           batch, time, chans, groups, taps, dilation, stage, 1, tile, true, st);
}

}  // namespace

// One SE-Res2Block. dtype of x, out, cat, w1, wg, w2: 0 = float32,
// 1 = bfloat16. Shapes: x/out/cat (B, T, C) with C = (G + 1) * 64, 16-byte
// aligned; cat is scratch (the concat), and out holds z1 and z2 on the way;
// part (B, ceil(T/64), C) f32 and gate (B, C) f32 scratch; w1/w2 (C, C);
// v1/v2 (3, C) = [b; a; c] f32; wg (G, taps, 64, 64); vg (G, 3, 64) f32;
// ws1 (C, H), bs1 (H), ws2 (H, C), bs2 (C) f32; f32 only (else unread):
// w1s/w2s (2, C, C), w1^T / w2^T split into TF32 hi and lo, and wgs (G, 2,
// taps, 64, 64), each group's taps transposed (output, input) and split.
// All contiguous. tile: frames per time tile of the cascade. Returns the
// first failing launch's cudaError_t, else 0.
extern "C" int se_res2_block_launch(const void* x, void* out, void* cat, void* part, void* gate,
                                    const void* w1, const void* v1, const void* wg,
                                    const void* vg, const void* w2, const void* v2,
                                    const void* ws1, const void* bs1, const void* ws2,
                                    const void* bs2, const void* w1s, const void* wgs,
                                    const void* w2s, int batch, int time, int chans, int groups,
                                    int taps, int hidden, int dilation, int tile, int dtype,
                                    void* stream) {
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  const Operands k{w1, wg, w2, f(v1), f(vg), f(v2), f(ws1), f(bs1), f(ws2), f(bs2), f(w1s), f(wgs), f(w2s)};
  return block(x, out, cat, static_cast<float*>(part), static_cast<float*>(gate), k, batch, time,
               chans, groups, taps, hidden, dilation, tile, dtype, true,
               static_cast<cudaStream_t>(stream));
}

// Stage mode: out (B, T, C) gets z1 (stage 0) or cat(g0, y1..y_stage,
// zeros) (1 <= stage <= G); z1 (B, T, C) is scratch for stage >= 1.
// Other arguments as above.
extern "C" int se_res2_staged_launch(const void* x, void* out, void* z1, const void* w1,
                                     const void* v1, const void* wg, const void* vg,
                                     const void* w1s, const void* wgs, int batch, int time,
                                     int chans, int groups, int taps, int dilation, int stage,
                                     int tile, int dtype, void* stream) {
  int err = check_shapes(batch, time, chans, groups, taps, dilation, tile);
  if (err || stage < 0 || stage > groups) return err ? err : (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  const Operands k{w1, wg, nullptr, f(v1), f(vg), nullptr, nullptr, nullptr, nullptr, nullptr, f(w1s), f(wgs), nullptr};
  if (dtype == 0)
    return staged_t<float>(x, out, z1, k, batch, time, chans, groups, taps, dilation, stage, tile, st);
  if (dtype == 1)
    return staged_t<bf16>(x, out, z1, k, batch, time, chans, groups, taps, dilation, stage, tile, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* se_res2_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
