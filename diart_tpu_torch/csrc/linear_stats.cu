// Fused final-TDNN projection + weighted statistics, for Hopper.
//
// Replaces the TPU kernel `_stats_kernel` of diart_tpu/ops/pallas_stats.py
// (reached through `_run_kernel` / `fused_linear_stats`). Same function:
//
//   Z = a * leaky(X @ W + b) + c          (B, T, C), never written to memory
//   s1[b, s, :] = sum_t wt[b, s, t] * Z[b, t, :]
//   s2[b, s, :] = sum_t wt[b, s, t] * Z[b, t, :]^2
//
// X (B, T, Cin) is f32 or bf16 and W (Cin, C) has X's dtype (the wrapper
// casts it, as the TPU wrapper does); every product accumulates in f32.
//
// What bounds it on the H100: at the x-vector head (B=64, T=279, Cin=512,
// C=1500, S=4) the X @ W product is 27.4 GFLOP against ~25 MB of inputs
// and outputs, so the function is bound by operations, not bytes. Leaving
// Z out of memory saves the 107 MB (f32) that the unfused version writes
// and reads back twice.
//
// Two kernels, chosen by the wrapper from X's dtype and shape:
//
// * `linear_stats_mma` (bf16 X with Cin % 8 == 0 — the main path): the
//   X @ W tile runs on the tensor cores with `mma.sync` m16n8k16 (bf16 in,
//   f32 accumulate; bf16 products are exact in f32). One block (8 warps)
//   per (stream, tile of 64 channels); the block walks T in tiles of 64
//   frames and Cin in chunks of 64, staged through shared memory with
//   16-byte loads (W's rows are padded by the wrapper to a multiple of 8
//   channels so every load is aligned) and read into fragments with
//   `ldmatrix` (`.trans` for W, which is stored k-major). Each warp owns a
//   16-frame x 32-channel piece of the tile; its epilogue applies bias,
//   leaky ReLU and the folded batch norm in registers and accumulates the
//   S speakers' s1/s2 for its 8 columns.
// * `linear_stats_fma` (f32 X, or any Cin): the same tiling with plain
//   f32 FMAs — 256 threads each own 4 frames x 4 channels of the tile.
//
// In both, the (T, C) projection lives only in registers, and the partial
// sums of a channel are combined at the end in a fixed order (a warp
// butterfly, then shared memory): no atomics, so results are
// deterministic. Padded frames (t >= T) get weight 0 and padded channels
// are not written. `wgmma` and TMA are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int CT = 64;   // channels per block
constexpr int TT = 64;   // frames per tile
constexpr int KC = 32;   // Cin chunk staged per pass
constexpr int NT = 256;  // threads
constexpr int GROUPS = TT / 4;  // frame groups (threads per channel group)

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T, int S>
__global__ void __launch_bounds__(NT) linear_stats_fma(
    const T* __restrict__ x, const T* __restrict__ w, const float* __restrict__ bias,
    const float* __restrict__ scale, const float* __restrict__ shift,
    const float* __restrict__ wt, float* __restrict__ s1, float* __restrict__ s2, int time,
    int cin, int channels, int ldw, float slope) {
  __shared__ float xs[TT][KC + 1];
  __shared__ __align__(16) float ws[KC][CT];
  __shared__ float wts[S][TT];
  __shared__ float red[GROUPS][CT];

  const int b = blockIdx.y;
  const int c0 = blockIdx.x * CT;
  const int tid = threadIdx.x;
  const int tx = tid % (CT / 4);  // channel group: channels tx*4 .. tx*4+3
  const int ty = tid / (CT / 4);  // frame group: frames ty*4 .. ty*4+3

  float bq[4], aq[4], cq[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int c = c0 + tx * 4 + q;
    const bool ok = c < channels;
    bq[q] = ok ? bias[c] : 0.0f;
    aq[q] = ok ? scale[c] : 0.0f;
    cq[q] = ok ? shift[c] : 0.0f;
  }
  float p1[S][4], p2[S][4];
#pragma unroll
  for (int s = 0; s < S; ++s)
#pragma unroll
    for (int q = 0; q < 4; ++q) p1[s][q] = p2[s][q] = 0.0f;

  const T* xb = x + (size_t)b * time * cin;
  const float* wtb = wt + (size_t)b * S * time;

  for (int t0 = 0; t0 < time; t0 += TT) {
    for (int e = tid; e < S * TT; e += NT) {
      const int s = e / TT, t = e % TT;
      wts[s][t] = (t0 + t < time) ? wtb[(size_t)s * time + t0 + t] : 0.0f;
    }
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][q] = 0.0f;

    for (int k0 = 0; k0 < cin; k0 += KC) {
#pragma unroll
      for (int r = 0; r < TT * KC / NT; ++r) {
        const int e = tid + r * NT;
        const int t = e / KC, k = e % KC;
        const bool ok = (t0 + t < time) && (k0 + k < cin);
        xs[t][k] = ok ? to_f(xb[(size_t)(t0 + t) * cin + k0 + k]) : 0.0f;
      }
#pragma unroll
      for (int r = 0; r < KC * CT / NT; ++r) {
        const int e = tid + r * NT;
        const int k = e / CT, c = e % CT;
        const bool ok = (k0 + k < cin) && (c0 + c < channels);
        ws[k][c] = ok ? to_f(w[(size_t)(k0 + k) * ldw + c0 + c]) : 0.0f;
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

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int t = ty * 4 + i;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        float y = acc[i][q] + bq[q];
        y = y >= 0.0f ? y : slope * y;
        const float z = y * aq[q] + cq[q];
        const float zz = z * z;
#pragma unroll
        for (int s = 0; s < S; ++s) {
          const float wv = wts[s][t];
          p1[s][q] = fmaf(wv, z, p1[s][q]);
          p2[s][q] = fmaf(wv, zz, p2[s][q]);
        }
      }
    }
    __syncthreads();  // wts is rewritten by the next tile
  }

  // Sum the GROUPS frame groups of each channel in a fixed order.
#pragma unroll
  for (int m = 0; m < 2 * S; ++m) {
    const int s = m >> 1;
#pragma unroll
    for (int q = 0; q < 4; ++q) red[ty][tx * 4 + q] = (m & 1) ? p2[s][q] : p1[s][q];
    __syncthreads();
    if (tid < CT && c0 + tid < channels) {
      float sum = 0.0f;
      for (int g = 0; g < GROUPS; ++g) sum += red[g][tid];
      float* dst = (m & 1) ? s2 : s1;
      dst[((size_t)b * S + s) * channels + c0 + tid] = sum;
    }
    __syncthreads();
  }
}

// --------------------------------------------------------------------- //
// Tensor-core kernel (bf16)

constexpr int MK = 64;       // Cin chunk of the mma kernel
constexpr int MPAD = MK + 8;  // smem row stride (elements): 144 bytes, conflict-free ldmatrix

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

// x: (B, T, Cin) bf16, Cin % 8 == 0; w: (Cin, ldw) bf16, ldw % 8 == 0, zero beyond C.
template <int S>
__global__ void __launch_bounds__(NT) linear_stats_mma(
    const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w,
    const float* __restrict__ bias, const float* __restrict__ scale,
    const float* __restrict__ shift, const float* __restrict__ wt, float* __restrict__ s1,
    float* __restrict__ s2, int time, int cin, int channels, int ldw, float slope) {
  __shared__ __align__(16) __nv_bfloat16 xs[TT][MPAD];  // [frame][k]
  __shared__ __align__(16) __nv_bfloat16 ws[MK][MPAD];  // [k][channel]
  __shared__ float wts[S][TT];
  __shared__ float red[4][CT];

  const int b = blockIdx.y;
  const int c0 = blockIdx.x * CT;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int wm = warp & 3;   // frames wm*16 .. +15 of the tile
  const int wn = warp >> 2;  // channels wn*32 .. +31 of the tile
  const int g = lane >> 2, tig = lane & 3;

  // this thread's 8 output columns: wn*32 + nt*8 + tig*2 + {0, 1}
  float bq[8], aq[8], cq[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int c = c0 + wn * 32 + (i >> 1) * 8 + tig * 2 + (i & 1);
    const bool ok = c < channels;
    bq[i] = ok ? bias[c] : 0.0f;
    aq[i] = ok ? scale[c] : 0.0f;
    cq[i] = ok ? shift[c] : 0.0f;
  }
  float p1[S][8], p2[S][8];
#pragma unroll
  for (int s = 0; s < S; ++s)
#pragma unroll
    for (int i = 0; i < 8; ++i) p1[s][i] = p2[s][i] = 0.0f;

  const __nv_bfloat16* xb = x + (size_t)b * time * cin;
  const float* wtb = wt + (size_t)b * S * time;
  const uint4 zero = make_uint4(0, 0, 0, 0);

  for (int t0 = 0; t0 < time; t0 += TT) {
    for (int e = tid; e < S * TT; e += NT) {
      const int s = e / TT, t = e % TT;
      wts[s][t] = (t0 + t < time) ? wtb[(size_t)s * time + t0 + t] : 0.0f;
    }
    float acc[4][4];
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[nt][i] = 0.0f;

    for (int k0 = 0; k0 < cin; k0 += MK) {
      // stage 64 frames x 64 k of X and 64 k x 64 channels of W, 16 bytes a load
#pragma unroll
      for (int r = 0; r < TT * MK / 8 / NT; ++r) {
        const int e = tid + r * NT;
        const int t = e / (MK / 8), k = (e % (MK / 8)) * 8;
        const bool ok = (t0 + t < time) && (k0 + k < cin);
        *reinterpret_cast<uint4*>(&xs[t][k]) =
            ok ? *reinterpret_cast<const uint4*>(xb + (size_t)(t0 + t) * cin + k0 + k) : zero;
      }
#pragma unroll
      for (int r = 0; r < MK * CT / 8 / NT; ++r) {
        const int e = tid + r * NT;
        const int k = e / (CT / 8), c = (e % (CT / 8)) * 8;
        const bool ok = (k0 + k < cin) && (c0 + c < ldw);
        *reinterpret_cast<uint4*>(&ws[k][c]) =
            ok ? *reinterpret_cast<const uint4*>(w + (size_t)(k0 + k) * ldw + c0 + c) : zero;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < MK; kk += 16) {
        unsigned a[4];
        const int mat = lane >> 3, row = lane & 7;
        ldmatrix_x4(smem_u32(&xs[wm * 16 + (mat & 1) * 8 + row][kk + (mat >> 1) * 8]), a);
#pragma unroll
        for (int np = 0; np < 2; ++np) {  // two n8 tiles per ldmatrix
          unsigned bf[4];
          ldmatrix_x4_trans(
              smem_u32(&ws[kk + (mat & 1) * 8 + row][wn * 32 + np * 16 + (mat >> 1) * 8]), bf);
          mma_bf16(acc[np * 2], a, bf[0], bf[1]);
          mma_bf16(acc[np * 2 + 1], a, bf[2], bf[3]);
        }
      }
      __syncthreads();
    }

    // epilogue: rows wm*16 + g (acc[.][0..1]) and wm*16 + g + 8 (acc[.][2..3])
    const int r0 = wm * 16 + g, r1 = r0 + 8;
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int col = nt * 2 + (i & 1);
        float y = acc[nt][i] + bq[col];
        y = y >= 0.0f ? y : slope * y;
        const float z = y * aq[col] + cq[col];
        const float zz = z * z;
        const int r = i < 2 ? r0 : r1;
#pragma unroll
        for (int s = 0; s < S; ++s) {
          const float wv = wts[s][r];
          p1[s][col] = fmaf(wv, z, p1[s][col]);
          p2[s][col] = fmaf(wv, zz, p2[s][col]);
        }
      }
    }
    __syncthreads();  // wts is rewritten by the next tile
  }

  // sum over the 8 row groups of a warp (butterfly over lane bits 2..4),
  // then over the 4 frame warps through shared memory, in a fixed order
#pragma unroll
  for (int m = 0; m < 2 * S; ++m) {
    const int s = m >> 1;
#pragma unroll
    for (int col = 0; col < 8; ++col) {
      float v = (m & 1) ? p2[s][col] : p1[s][col];
      v += __shfl_xor_sync(0xffffffffu, v, 4);
      v += __shfl_xor_sync(0xffffffffu, v, 8);
      v += __shfl_xor_sync(0xffffffffu, v, 16);
      if (g == 0) red[wm][wn * 32 + (col >> 1) * 8 + tig * 2 + (col & 1)] = v;
    }
    __syncthreads();
    if (tid < CT && c0 + tid < channels) {
      const float sum = ((red[0][tid] + red[1][tid]) + red[2][tid]) + red[3][tid];
      float* dst = (m & 1) ? s2 : s1;
      dst[((size_t)b * S + s) * channels + c0 + tid] = sum;
    }
    __syncthreads();
  }
}

// --------------------------------------------------------------------- //
template <typename T, int S>
int launch_s(const void* x, const void* w, const float* bias, const float* scale,
             const float* shift, const float* wt, float* s1, float* s2, int batch, int time,
             int cin, int channels, int ldw, float slope, cudaStream_t stream) {
  const dim3 grid((channels + CT - 1) / CT, batch);
  if constexpr (sizeof(T) == 2) {
    if (cin % 8 == 0 && ldw % 8 == 0) {
      linear_stats_mma<S><<<grid, NT, 0, stream>>>(
          static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w), bias,
          scale, shift, wt, s1, s2, time, cin, channels, ldw, slope);
      return (int)cudaGetLastError();
    }
  }
  linear_stats_fma<T, S><<<grid, NT, 0, stream>>>(static_cast<const T*>(x),
                                                  static_cast<const T*>(w), bias, scale, shift,
                                                  wt, s1, s2, time, cin, channels, ldw, slope);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* x, const void* w, const float* bias, const float* scale,
           const float* shift, const float* wt, float* s1, float* s2, int batch, int time,
           int cin, int channels, int ldw, int speakers, float slope, cudaStream_t stream) {
#define DIART_STATS_CASE(S_)                                                                 \
  case S_:                                                                                  \
    return launch_s<T, S_>(x, w, bias, scale, shift, wt, s1, s2, batch, time, cin, channels, \
                           ldw, slope, stream);
  switch (speakers) {
    DIART_STATS_CASE(1)
    DIART_STATS_CASE(2)
    DIART_STATS_CASE(3)
    DIART_STATS_CASE(4)
    DIART_STATS_CASE(5)
    DIART_STATS_CASE(6)
    DIART_STATS_CASE(7)
    DIART_STATS_CASE(8)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef DIART_STATS_CASE
}

}  // namespace

// dtype of x and w: 0 = float32, 1 = bfloat16. w: (Cin, ldw) row-major with
// ldw >= C. bias/scale/shift: (C,) f32; wt: (B, S, T) f32; s1, s2: (B, S, C)
// f32. Returns the launch's cudaError_t.
extern "C" int linear_stats_launch(const void* x, const void* w, const void* bias,
                                   const void* scale, const void* shift, const void* wt,
                                   void* s1, void* s2, int batch, int time, int cin,
                                   int channels, int ldw, int speakers, int dtype, float slope,
                                   void* stream) {
  if (batch < 1 || time < 1 || cin < 1 || channels < 1 || ldw < channels || batch > 65535)
    return (int)cudaErrorInvalidValue;
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* o1 = static_cast<float*>(s1);
  float* o2 = static_cast<float*>(s2);
  if (dtype == 0)
    return launch<float>(x, w, f(bias), f(scale), f(shift), f(wt), o1, o2, batch, time, cin,
                         channels, ldw, speakers, slope, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, w, f(bias), f(scale), f(shift), f(wt), o1, o2, batch, time,
                                 cin, channels, ldw, speakers, slope, s);
  return (int)cudaErrorInvalidValue;
}

// 1 when a call with this dtype and Cin runs on the tensor cores.
extern "C" int linear_stats_uses_mma(int cin, int dtype) { return dtype == 1 && cin % 8 == 0; }

extern "C" const char* linear_stats_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
