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
// operations (0.04 ms at the bf16 tensor-core rate), and far from it.
// A whole (501, 512) activation does not fit in one SM's shared memory,
// so the block runs as five launches on the caller's stream, all
// hand-written; the intermediates make one round trip through memory
// (mostly L2):
//
// (a) `tdnn_mma` (bf16) / `tdnn_fma` (f32): z1 as a tiled GEMM, one block
//     (8 warps) per (stream, 64 frames, 64 channels), the bf16 product on
//     the tensor cores with `mma.sync` m16n8k16 (as linear_stats.cu), the
//     bias/ReLU/affine epilogue in registers, rounded to dt on store.
// (b) `res2_cascade`: one block per stream runs the 7 dependent group
//     convolutions. A whole (T, 64) group sits in shared memory as f32,
//     so the reflect padding is index arithmetic (t<0 -> -t,
//     t>=T -> 2(T-1)-t) and needs no halo; each thread owns 4 channels of
//     16 frames per pass and sums the 3 x 64 taps with FMAs. The y_i are
//     written in place over z1's chunks, which turns z1 into the concat.
// (c) the GEMM of (a) on the concat, which also writes each
//     (stream, 64-frame tile, channel) partial time sum of z2 in f32, in
//     a fixed order.
// (d) `se_gate`: one block per stream sums the partials in a fixed
//     order (the time mean) and runs the 512->128->512 gate MLP in f32;
//     `se_residual` applies the gate and the residual elementwise.
//
// Stage mode (`se_res2_staged_launch`) stops after (a) (stage 0: z1) or
// after group k of (b) with the later groups zeroed (stage k:
// cat(g0, y1..yk, 0...)), the semantics of `staged` / `reference_stage`.
// No atomics anywhere: results are deterministic. `wgmma`/TMA and a
// single fused pass with halo recompute are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int TILE = 64;   // GEMM tile: frames and channels
constexpr int NT = 256;    // threads of the GEMM and cascade kernels
constexpr int WIDTH = 64;  // res2 group width the cascade takes
constexpr int LDI = WIDTH + 1;   // cascade input row stride (floats)
constexpr int MAX_TIME = 512;    // cascade: 2 passes x 16 rows x 16 row groups

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

// --------------------------------------------------------------------- //
// (a)/(c) 1x1 TDNN: Y = dt(a * relu(X @ W + b) + c), X (B, T, K), W (K, N),
// v (3, N) = [b; a; c]. part (B, ceil(T/64), N) gets the column sums of
// the rounded Y over each tile's valid frames (when not null).

template <typename T>
__global__ void __launch_bounds__(NT) tdnn_fma(const T* __restrict__ x, const T* __restrict__ w,
                                               const float* __restrict__ v, T* __restrict__ y,
                                               float* __restrict__ part, int time, int kdim,
                                               int ndim) {
  constexpr int KC = 32;
  __shared__ float xs[TILE][KC + 1];
  __shared__ __align__(16) float ws[KC][TILE];
  __shared__ float red[TILE / 4][TILE];

  const int n0 = blockIdx.x * TILE, t0 = blockIdx.y * TILE, b = blockIdx.z;
  const int tid = threadIdx.x;
  const int tx = tid % (TILE / 4);  // channels tx*4 .. +3
  const int ty = tid / (TILE / 4);  // frames ty*4 .. +3
  const T* xb = x + (size_t)b * time * kdim;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[i][q] = 0.0f;

  for (int k0 = 0; k0 < kdim; k0 += KC) {
#pragma unroll
    for (int r = 0; r < TILE * KC / NT; ++r) {
      const int e = tid + r * NT;
      const int t = e / KC, k = e % KC;
      const bool ok = (t0 + t < time) && (k0 + k < kdim);
      xs[t][k] = ok ? to_f(xb[(size_t)(t0 + t) * kdim + k0 + k]) : 0.0f;
    }
#pragma unroll
    for (int r = 0; r < KC * TILE / NT; ++r) {
      const int e = tid + r * NT;
      const int k = e / TILE, c = e % TILE;
      const bool ok = (k0 + k < kdim) && (n0 + c < ndim);
      ws[k][c] = ok ? to_f(w[(size_t)(k0 + k) * ndim + n0 + c]) : 0.0f;
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
      const T out = from_f<T>(tdnn_epilogue(acc[i][q], bq, aq, cq));
      y[((size_t)b * time + t) * ndim + n] = out;
      colsum[q] += to_f(out);
    }
  }
  if (part == nullptr) return;
#pragma unroll
  for (int q = 0; q < 4; ++q) red[ty][tx * 4 + q] = colsum[q];
  __syncthreads();
  if (tid < TILE && n0 + tid < ndim) {
    float sum = 0.0f;
    for (int g = 0; g < TILE / 4; ++g) sum += red[g][tid];
    part[((size_t)b * gridDim.y + blockIdx.y) * ndim + n0 + tid] = sum;
  }
}

constexpr int MK = 64;        // K chunk of the mma GEMM
constexpr int MPAD = MK + 8;  // smem row stride (elements): conflict-free ldmatrix

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
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

// bf16, K % 8 == 0, N % 8 == 0. Warp (wm, wn) owns frames wm*16..+15 and
// channels wn*32..+31 of the tile.
__global__ void __launch_bounds__(NT) tdnn_mma(const bf16* __restrict__ x,
                                               const bf16* __restrict__ w,
                                               const float* __restrict__ v, bf16* __restrict__ y,
                                               float* __restrict__ part, int time, int kdim,
                                               int ndim) {
  __shared__ __align__(16) bf16 xs[TILE][MPAD];  // [frame][k]
  __shared__ __align__(16) bf16 ws[MK][MPAD];    // [k][channel]
  __shared__ float red[4][TILE];

  const int n0 = blockIdx.x * TILE, t0 = blockIdx.y * TILE, b = blockIdx.z;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int wm = warp & 3, wn = warp >> 2;
  const int g = lane >> 2, tig = lane & 3;
  const bf16* xb = x + (size_t)b * time * kdim;
  const uint4 zero = make_uint4(0, 0, 0, 0);

  float acc[4][4];
#pragma unroll
  for (int nt = 0; nt < 4; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[nt][i] = 0.0f;

  for (int k0 = 0; k0 < kdim; k0 += MK) {
#pragma unroll
    for (int r = 0; r < TILE * MK / 8 / NT; ++r) {
      const int e = tid + r * NT;
      const int t = e / (MK / 8), k = (e % (MK / 8)) * 8;
      const bool ok = (t0 + t < time) && (k0 + k < kdim);
      *reinterpret_cast<uint4*>(&xs[t][k]) =
          ok ? *reinterpret_cast<const uint4*>(xb + (size_t)(t0 + t) * kdim + k0 + k) : zero;
    }
#pragma unroll
    for (int r = 0; r < MK * TILE / 8 / NT; ++r) {
      const int e = tid + r * NT;
      const int k = e / (TILE / 8), c = (e % (TILE / 8)) * 8;
      const bool ok = (k0 + k < kdim) && (n0 + c < ndim);
      *reinterpret_cast<uint4*>(&ws[k][c]) =
          ok ? *reinterpret_cast<const uint4*>(w + (size_t)(k0 + k) * ndim + n0 + c) : zero;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < MK; kk += 16) {
      unsigned a[4];
      const int mat = lane >> 3, row = lane & 7;
      ldmatrix_x4(smem_u32(&xs[wm * 16 + (mat & 1) * 8 + row][kk + (mat >> 1) * 8]), a);
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        unsigned bf[4];
        ldmatrix_x4_trans(
            smem_u32(&ws[kk + (mat & 1) * 8 + row][wn * 32 + np * 16 + (mat >> 1) * 8]), bf);
        mma_bf16(acc[np * 2], a, bf[0], bf[1]);
        mma_bf16(acc[np * 2 + 1], a, bf[2], bf[3]);
      }
    }
    __syncthreads();
  }

  // epilogue: acc[nt][0..1] -> frame r0, acc[nt][2..3] -> frame r0 + 8;
  // columns n0 + wn*32 + nt*8 + tig*2 + {0, 1}
  const int r0 = t0 + wm * 16 + g;
  float colsum[4][2];
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
    const int n = n0 + wn * 32 + nt * 8 + tig * 2;
    colsum[nt][0] = colsum[nt][1] = 0.0f;
    if (n >= ndim) continue;  // ndim % 8 == 0: both columns in or both out
    const float b0 = v[n], b1 = v[n + 1];
    const float a0 = v[ndim + n], a1 = v[ndim + n + 1];
    const float c0 = v[2 * ndim + n], c1 = v[2 * ndim + n + 1];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int t = r0 + h * 8;
      if (t >= time) continue;
      const bf16 o0 = __float2bfloat16(tdnn_epilogue(acc[nt][2 * h], b0, a0, c0));
      const bf16 o1 = __float2bfloat16(tdnn_epilogue(acc[nt][2 * h + 1], b1, a1, c1));
      __nv_bfloat162 pair;
      pair.x = o0;
      pair.y = o1;
      *reinterpret_cast<__nv_bfloat162*>(&y[((size_t)b * time + t) * ndim + n]) = pair;
      colsum[nt][0] += __bfloat162float(o0);
      colsum[nt][1] += __bfloat162float(o1);
    }
  }
  if (part == nullptr) return;
  // sum the 8 row groups of a warp (lane bits 2..4), then the 4 frame warps
#pragma unroll
  for (int nt = 0; nt < 4; ++nt)
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      float s = colsum[nt][p];
      s += __shfl_xor_sync(0xffffffffu, s, 4);
      s += __shfl_xor_sync(0xffffffffu, s, 8);
      s += __shfl_xor_sync(0xffffffffu, s, 16);
      if (g == 0) red[wm][wn * 32 + nt * 8 + tig * 2 + p] = s;
    }
  __syncthreads();
  if (tid < TILE && n0 + tid < ndim) {
    const float sum = ((red[0][tid] + red[1][tid]) + red[2][tid]) + red[3][tid];
    part[((size_t)b * gridDim.y + blockIdx.y) * ndim + n0 + tid] = sum;
  }
}

// --------------------------------------------------------------------- //
// (b) the group cascade, in place: cat (B, T, C) holds z1 on entry and
// cat(g0, y1..y_run, [zeros]) on exit. wg (G, taps, 64, 64) in dt,
// vg (G, 3, 64) = [b; a; c] f32. One block per stream.

template <typename T>
__global__ void __launch_bounds__(NT) res2_cascade(T* __restrict__ cat, const T* __restrict__ wg,
                                                   const float* __restrict__ vg, int time,
                                                   int chans, int groups, int taps, int dilation,
                                                   int run_groups, int zero_rest) {
  extern __shared__ __align__(16) float smem[];
  float* inp = smem;                                // [time][LDI]
  float* wsm = smem + (time * LDI + 3) / 4 * 4;     // [taps * 64][64], 16-byte aligned

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int tx = tid % 16;  // channels tx*4 .. +3
  const int ty = tid / 16;  // frames ty + 16 m
  const int pad = (taps - 1) * dilation / 2;
  T* cb = cat + (size_t)b * time * chans;

  for (int gi = 0; gi < run_groups; ++gi) {
    const int col_in = (gi + 1) * WIDTH;  // z1 chunk gi+1; y goes there too
    for (int e = tid; e < time * WIDTH; e += NT) {
      const int t = e / WIDTH, w = e % WIDTH;
      float val = to_f(cb[(size_t)t * chans + col_in + w]);
      if (gi > 0) val = round_to<T>(val + to_f(cb[(size_t)t * chans + col_in - WIDTH + w]));
      inp[t * LDI + w] = val;
    }
    const T* wgi = wg + (size_t)gi * taps * WIDTH * WIDTH;
    for (int e = tid; e < taps * WIDTH * WIDTH; e += NT) wsm[e] = to_f(wgi[e]);
    __syncthreads();

    float bq[4], aq[4], cq[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      bq[q] = vg[(gi * 3 + 0) * WIDTH + tx * 4 + q];
      aq[q] = vg[(gi * 3 + 1) * WIDTH + tx * 4 + q];
      cq[q] = vg[(gi * 3 + 2) * WIDTH + tx * 4 + q];
    }
    for (int half = 0; half < 2; ++half) {
      const int base = half * 256 + ty;
      if (base >= time) break;
      float acc[16][4];
#pragma unroll
      for (int m = 0; m < 16; ++m)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[m][q] = 0.0f;
      for (int j = 0; j < taps; ++j) {
        const int shift = j * dilation - pad;
        int off[16];
#pragma unroll
        for (int m = 0; m < 16; ++m) {
          int src = base + 16 * m + shift;
          src = src < 0 ? -src : src;
          src = src >= time ? 2 * (time - 1) - src : src;
          src = min(max(src, 0), time - 1);  // frames >= time are not stored
          off[m] = src * LDI;
        }
        const float* wj = wsm + j * WIDTH * WIDTH + tx * 4;
#pragma unroll 4
        for (int w = 0; w < WIDTH; ++w) {
          const float4 wv = *reinterpret_cast<const float4*>(wj + w * WIDTH);
#pragma unroll
          for (int m = 0; m < 16; ++m) {
            const float iv = inp[off[m] + w];
            acc[m][0] = fmaf(iv, wv.x, acc[m][0]);
            acc[m][1] = fmaf(iv, wv.y, acc[m][1]);
            acc[m][2] = fmaf(iv, wv.z, acc[m][2]);
            acc[m][3] = fmaf(iv, wv.w, acc[m][3]);
          }
        }
      }
#pragma unroll
      for (int m = 0; m < 16; ++m) {
        const int t = base + 16 * m;
        if (t >= time) continue;
        T* dst = cb + (size_t)t * chans + col_in + tx * 4;
#pragma unroll
        for (int q = 0; q < 4; ++q) dst[q] = from_f<T>(tdnn_epilogue(acc[m][q], bq[q], aq[q], cq[q]));
      }
    }
    __syncthreads();  // inp/wsm are restaged; this group's y is visible to the next
  }
  if (zero_rest) {
    const int c_from = (run_groups + 1) * WIDTH;
    const int span = chans - c_from;
    for (int e = tid; e < time * span; e += NT) {
      const int t = e / span, c = e % span;
      cb[(size_t)t * chans + c_from + c] = from_f<T>(0.0f);
    }
  }
}

size_t cascade_smem(int time, int taps) {
  const size_t inp = (size_t)time * LDI;
  const size_t inp_aligned = (inp + 3) / 4 * 4;
  return sizeof(float) * (inp_aligned + (size_t)taps * WIDTH * WIDTH);
}

// --------------------------------------------------------------------- //
// (d) SE gate from the partial time sums, one block per stream, then the
// gate and residual elementwise.

__global__ void __launch_bounds__(NT) se_gate(const float* __restrict__ part, int ntiles,
                                              int time, const float* __restrict__ ws1,
                                              const float* __restrict__ bs1,
                                              const float* __restrict__ ws2,
                                              const float* __restrict__ bs2,
                                              float* __restrict__ gate, int chans, int hidden) {
  extern __shared__ float sm[];
  float* s = sm;            // [chans]
  float* h = sm + chans;    // [hidden]
  const int b = blockIdx.x;
  for (int c = threadIdx.x; c < chans; c += blockDim.x) {
    float sum = 0.0f;
    for (int i = 0; i < ntiles; ++i) sum += part[((size_t)b * ntiles + i) * chans + c];
    s[c] = sum / (float)time;
  }
  __syncthreads();
  for (int j = threadIdx.x; j < hidden; j += blockDim.x) {
    float acc = 0.0f;
    for (int c = 0; c < chans; ++c) acc = fmaf(s[c], ws1[(size_t)c * hidden + j], acc);
    h[j] = fmaxf(acc + bs1[j], 0.0f);
  }
  __syncthreads();
  for (int c = threadIdx.x; c < chans; c += blockDim.x) {
    float acc = 0.0f;
    for (int j = 0; j < hidden; ++j) acc = fmaf(h[j], ws2[(size_t)j * chans + c], acc);
    gate[(size_t)b * chans + c] = 1.0f / (1.0f + expf(-(acc + bs2[c])));
  }
}

template <typename T>
__global__ void se_residual(const T* __restrict__ x, const T* __restrict__ z2,
                            const float* __restrict__ gate, T* __restrict__ out, size_t total,
                            int time, int chans) {
  const size_t per_stream = (size_t)time * chans;
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < total;
       i += (size_t)gridDim.x * blockDim.x) {
    const int c = (int)(i % chans);
    const size_t b = i / per_stream;
    const float gt = round_to<T>(gate[b * chans + c]);
    const float scaled = round_to<T>(to_f(z2[i]) * gt);
    out[i] = from_f<T>(to_f(x[i]) + scaled);
  }
}

// --------------------------------------------------------------------- //
template <typename T>
int launch_tdnn(const T* x, const T* w, const float* v, T* y, float* part, int batch, int time,
                int kdim, int ndim, cudaStream_t st) {
  const dim3 grid((ndim + TILE - 1) / TILE, (time + TILE - 1) / TILE, batch);
  if constexpr (sizeof(T) == 2) {
    if (kdim % 8 == 0 && ndim % 8 == 0) {
      tdnn_mma<<<grid, NT, 0, st>>>(x, w, v, y, part, time, kdim, ndim);
      return (int)cudaGetLastError();
    }
  }
  tdnn_fma<T><<<grid, NT, 0, st>>>(x, w, v, y, part, time, kdim, ndim);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_cascade(T* cat, const T* wg, const float* vg, int batch, int time, int chans,
                   int groups, int taps, int dilation, int run_groups, int zero_rest,
                   cudaStream_t st) {
  const size_t smem = cascade_smem(time, taps);
  cudaError_t err = cudaFuncSetAttribute(res2_cascade<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  res2_cascade<T><<<batch, NT, smem, st>>>(cat, wg, vg, time, chans, groups, taps, dilation,
                                          run_groups, zero_rest);
  return (int)cudaGetLastError();
}

int check_shapes(int batch, int time, int chans, int groups, int taps, int dilation) {
  const int pad = (taps - 1) * dilation / 2;
  if (batch < 1 || batch > 65535 || time < 2 || time > MAX_TIME || pad >= time ||
      chans != (groups + 1) * WIDTH || taps < 1 || taps % 2 == 0 ||
      cascade_smem(time, taps) > 227 * 1024)
    return (int)cudaErrorInvalidValue;
  return 0;
}

template <typename T>
int block_t(const void* x, void* out, void* cat, void* z2, float* part, float* gate,
            const void* w1, const float* v1, const void* wg, const float* vg, const void* w2,
            const float* v2, const float* ws1, const float* bs1, const float* ws2,
            const float* bs2, int batch, int time, int chans, int groups, int taps, int hidden,
            int dilation, cudaStream_t st) {
  const T* xt = static_cast<const T*>(x);
  T* ct = static_cast<T*>(cat);
  T* zt = static_cast<T*>(z2);
  int err = launch_tdnn<T>(xt, static_cast<const T*>(w1), v1, ct, nullptr, batch, time, chans,
                           chans, st);
  if (err) return err;
  err = launch_cascade<T>(ct, static_cast<const T*>(wg), vg, batch, time, chans, groups, taps,
                          dilation, groups, 0, st);
  if (err) return err;
  err = launch_tdnn<T>(ct, static_cast<const T*>(w2), v2, zt, part, batch, time, chans, chans,
                       st);
  if (err) return err;
  const int ntiles = (time + TILE - 1) / TILE;
  se_gate<<<batch, NT, sizeof(float) * (chans + hidden), st>>>(part, ntiles, time, ws1, bs1, ws2,
                                                              bs2, gate, chans, hidden);
  err = (int)cudaGetLastError();
  if (err) return err;
  const size_t total = (size_t)batch * time * chans;
  const int blocks = (int)((total + NT * 4 - 1) / (NT * 4));
  se_residual<T><<<blocks, NT, 0, st>>>(xt, zt, gate, static_cast<T*>(out), total, time, chans);
  return (int)cudaGetLastError();
}

}  // namespace

// One SE-Res2Block. dtype of x, out, cat, z2, w1, wg, w2: 0 = float32,
// 1 = bfloat16. Shapes: x/out/cat/z2 (B, T, C) with C = (G + 1) * 64;
// part (B, ceil(T/64), C) f32 and gate (B, C) f32 scratch; w1/w2 (C, C);
// v1/v2 (3, C) = [b; a; c] f32; wg (G, taps, 64, 64); vg (G, 3, 64) f32;
// ws1 (C, H), bs1 (H), ws2 (H, C), bs2 (C) f32. All contiguous. Returns
// the first failing launch's cudaError_t, else 0.
extern "C" int se_res2_block_launch(const void* x, void* out, void* cat, void* z2, void* part,
                                    void* gate, const void* w1, const void* v1, const void* wg,
                                    const void* vg, const void* w2, const void* v2,
                                    const void* ws1, const void* bs1, const void* ws2,
                                    const void* bs2, int batch, int time, int chans, int groups,
                                    int taps, int hidden, int dilation, int dtype, void* stream) {
  int err = check_shapes(batch, time, chans, groups, taps, dilation);
  if (err || hidden < 1) return err ? err : (int)cudaErrorInvalidValue;
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  float* pt = static_cast<float*>(part);
  float* gt = static_cast<float*>(gate);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return block_t<float>(x, out, cat, z2, pt, gt, w1, f(v1), wg, f(vg), w2, f(v2), f(ws1),
                          f(bs1), f(ws2), f(bs2), batch, time, chans, groups, taps, hidden,
                          dilation, st);
  if (dtype == 1)
    return block_t<bf16>(x, out, cat, z2, pt, gt, w1, f(v1), wg, f(vg), w2, f(v2), f(ws1),
                         f(bs1), f(ws2), f(bs2), batch, time, chans, groups, taps, hidden,
                         dilation, st);
  return (int)cudaErrorInvalidValue;
}

// Stage mode: out (B, T, C) gets z1 (stage 0) or cat(g0, y1..y_stage,
// zeros) (1 <= stage <= G). Arguments as above.
extern "C" int se_res2_staged_launch(const void* x, void* out, const void* w1, const void* v1,
                                     const void* wg, const void* vg, int batch, int time,
                                     int chans, int groups, int taps, int dilation, int stage,
                                     int dtype, void* stream) {
  int err = check_shapes(batch, time, chans, groups, taps, dilation);
  if (err || stage < 0 || stage > groups) return err ? err : (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  if (dtype == 0) {
    float* o = static_cast<float*>(out);
    err = launch_tdnn<float>(static_cast<const float*>(x), static_cast<const float*>(w1), f(v1),
                             o, nullptr, batch, time, chans, chans, st);
    if (err || stage == 0) return err;
    return launch_cascade<float>(o, static_cast<const float*>(wg), f(vg), batch, time, chans,
                                 groups, taps, dilation, stage, 1, st);
  }
  if (dtype == 1) {
    bf16* o = static_cast<bf16*>(out);
    err = launch_tdnn<bf16>(static_cast<const bf16*>(x), static_cast<const bf16*>(w1), f(v1), o,
                            nullptr, batch, time, chans, chans, st);
    if (err || stage == 0) return err;
    return launch_cascade<bf16>(o, static_cast<const bf16*>(wg), f(vg), batch, time, chans,
                                groups, taps, dilation, stage, 1, st);
  }
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* se_res2_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
