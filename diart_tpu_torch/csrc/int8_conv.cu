// Dynamic int8 convolution (per-sample activation scales, per-output-channel
// weight scales, s8 x s8 -> s32 on the tensor cores), for Hopper.
//
// Replaces the XLA integer convolution of diart_tpu/ops/quant.py
// (`_int8_conv_forward`: `lax.conv_general_dilated` on int8 operands with
// `preferred_element_type=int32`), which is not a Pallas kernel. Same
// function, in the same f32 arithmetic:
//
//   s_x[b]   = max(max |x[b]|, 1e-12) / 127           quantize_rows
//   q_x      = clip(rint(x / s_x[b]), -127, 127)      (rint: half to even,
//                                                      as jnp.round)
//   acc      = conv(q_x, q_w)                          int32, exact
//   y        = out_dtype(float(acc) * (s_x[b] * s_w[c]))   then + bias in
//                                                      out_dtype
//
// The weights' q_w and s_w are made once per model by the wrapper (plain
// PyTorch) and held, as XLA folds them at trace time. Every multiply, divide
// and add of the epilogue and the quantizer is an `_rn` intrinsic, so the
// compiler contracts none of them into an FMA: the bits are the plain
// version's. The build has no --use_fast_math.
//
// What bounds it on the H100: at the quantizable sites of the five embedding
// families at B = 64 the products are 2-56 GOP and the activations 10-330 MB
// (f32 or bf16 in, int8 staging, the output), so most sites sit near the
// ridge: 1,979 TOP/s of dense int8 against 3.35 TB/s is ~590 operations a
// byte. The 3x3 ResNet convolutions and TitaNet's 1024-wide pointwise ones
// are bound by operations, the x-vector's TDNN 0 and the ECAPA stem by bytes.
//
// What this design does about it (simple first; `wgmma`, TMA and a
// persistent tile loop are later work):
//
// * The quantizer, two passes over the input: `absmax_rows` (8192 elements
//   a block, a sample's blocks merged with atomicMax on the float bits: max
//   is exact in any order) and `quantize_rows` (one block a 64 x 32 tile of
//   (positions, channels), written channels-last (B, S, C) through shared
//   memory, the input read along whichever of its axes is contiguous: the
//   models hand channels-first or channels-last views). The int8 copy is a
//   quarter of the f32 activation. (A first version ran one block a sample:
//   64 blocks for 132 multiprocessors, 93 of ResNet34's 123 ms a step.)
// * `int8_conv_mma`: implicit GEMM, M = output channels, N = output
//   positions (b, o1, o2), K = (k1, k2, c_in) zero-padded to 32. A block
//   computes a 64 x 64 tile with four warps of 32 x 32, each
//   `mma.sync.m16n8k32` s8 with s32 accumulators in registers. K arrives in
//   64-deep slices; the next slice's global loads are in flight (registers)
//   while the current one is multiplied from shared memory (rows padded to
//   80 bytes: the fragment loads are free of bank conflicts). Channels-last
//   q_x makes a 16-byte piece of K one contiguous load whenever c_in % 16 ==
//   0; other widths (TDNN 0's 60 and 24 channels) gather bytes. Padding
//   (ResNet's 1), stride (2) and dilation (the TDNNs' 2 and 3) are index
//   arithmetic in that gather: no padded or unfolded copy of the input is
//   written. The dequantize epilogue and the bias are fused; the output is
//   written channels-first (B, C_out, O1, O2), the models' layout. An int32
//   output (`out_dtype` 2) skips the epilogue and writes the sums, which
//   the checks hold bitwise against the plain version's.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int QT = 256;      // quantize threads
constexpr int QCHUNK = 8192;  // elements of a sample a max block reads
constexpr int TS = 64;       // quantize tile: positions
constexpr int TC = 32;       // quantize tile: channels
constexpr int BM = 64;       // conv tile: output channels
constexpr int BN = 64;       // conv tile: positions
constexpr int BK = 64;       // conv tile: reduction slice (two k32 steps)
constexpr int LDS = BK + 16;  // shared row stride in bytes
constexpr int CT = 128;      // conv threads

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

__device__ __forceinline__ float block_max(float v, float* red) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < (int)(blockDim.x >> 5) ? red[lane] : 0.0f;
    for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
    if (lane == 0) red[0] = v;
  }
  __syncthreads();
  return red[0];
}

// Pass 1: |x|'s largest value of each sample, as the bits of a
// non-negative float (their unsigned order is the floats' order), merged
// over the blocks of a sample with atomicMax. x element (b, c, s) at
// b * sb + c * sc + s * ss; a sample whose C * S elements are one dense
// block (channels-first or channels-last) is read flat.
template <typename T>
__global__ void __launch_bounds__(QT) absmax_rows(const T* __restrict__ x, unsigned* __restrict__ amax,
                                                  int C, int S, long long sb, long long sc,
                                                  long long ss) {
  __shared__ float red[QT / 32];
  const int b = blockIdx.y;
  const T* xb = x + (long long)b * sb;
  const int n = C * S;
  const int start = blockIdx.x * QCHUNK, stop = min(start + QCHUNK, n);
  const bool flat = (sc == S && ss == 1) || (sc == 1 && ss == C);
  float m = 0.0f;
  for (int e = start + threadIdx.x; e < stop; e += QT) {
    long long at = e;
    if (!flat) {
      const int c = e / S, s = e - (e / S) * S;
      at = c * sc + s * ss;
    }
    m = fmaxf(m, fabsf(to_f(xb[at])));
  }
  m = block_max(m, red);
  if (threadIdx.x == 0) atomicMax(amax + b, __float_as_uint(m));
}

// Pass 2: one block a (TS positions x TC channels) tile of one sample:
// round and clip to int8 with the sample's scale, written channels-last
// (B, S, C) through shared memory; the input is read along whichever of its
// axes is contiguous. The first tile's block writes the scale.
template <typename T>
__global__ void __launch_bounds__(QT) quantize_rows(const T* __restrict__ x,
                                                    const unsigned* __restrict__ amax,
                                                    int8_t* __restrict__ q, float* __restrict__ scale,
                                                    int C, int S, long long sb, long long sc,
                                                    long long ss) {
  __shared__ int8_t tile[TS][TC + 4];
  const int b = blockIdx.z, s0 = blockIdx.x * TS, c0 = blockIdx.y * TC;
  const T* xb = x + (long long)b * sb;
  const float sx = __fdiv_rn(fmaxf(__uint_as_float(amax[b]), 1e-12f), 127.0f);
  if (blockIdx.x == 0 && blockIdx.y == 0 && threadIdx.x == 0) scale[b] = sx;
  const bool s_fast = ss == 1;
  for (int e = threadIdx.x; e < TS * TC; e += QT) {
    int cc, tt;
    if (s_fast) { tt = e % TS; cc = e / TS; } else { cc = e % TC; tt = e / TC; }
    const int c = c0 + cc, s = s0 + tt;
    int8_t v = 0;
    if (c < C && s < S) {
      float r = rintf(__fdiv_rn(to_f(xb[c * sc + s * ss]), sx));
      v = (int8_t)fminf(fmaxf(r, -127.0f), 127.0f);
    }
    tile[tt][cc] = v;
  }
  __syncthreads();
  int8_t* qb = q + (long long)b * C * S;
  for (int e = threadIdx.x; e < TS * TC; e += QT) {
    const int cc = e % TC, tt = e / TC;
    const int c = c0 + cc, s = s0 + tt;
    if (c < C && s < S) qb[(long long)s * C + c] = tile[tt][cc];
  }
}

struct Geom {
  int B, C, S1, S2;        // input (channels-last int8)
  int M, O1, O2, O, N;     // output channels, output positions
  int K1, K2, K, Kpad;     // window, reduction depth (unpadded, padded)
  int s1, s2, p1, p2, d1, d2;
  bool vec;                // C % 16 == 0: a 16-byte piece of K is contiguous
};

// 16 bytes of the implicit-GEMM B operand: position n, reduction k..k+15
__device__ __forceinline__ int4 load_b_piece(const int8_t* __restrict__ qx, const Geom& g, int n,
                                             int k) {
  int4 z = make_int4(0, 0, 0, 0);
  if (n >= g.N || k >= g.K) return z;
  const int b = n / g.O;
  const int o = n - b * g.O;
  const int o1 = o / g.O2, o2 = o - (o / g.O2) * g.O2;
  const int base1 = o1 * g.s1 - g.p1, base2 = o2 * g.s2 - g.p2;
  if (g.vec) {
    const int tap = k / g.C, ci = k - tap * g.C;
    const int k1 = tap / g.K2, k2 = tap - k1 * g.K2;
    const int i1 = base1 + k1 * g.d1, i2 = base2 + k2 * g.d2;
    if (i1 < 0 || i1 >= g.S1 || i2 < 0 || i2 >= g.S2) return z;
    return *reinterpret_cast<const int4*>(qx + (((long long)b * g.S1 + i1) * g.S2 + i2) * g.C + ci);
  }
  union {
    int4 v;
    int8_t c[16];
  } u;
  u.v = z;
#pragma unroll 1
  for (int j = 0; j < 16; ++j) {
    const int kk = k + j;
    if (kk >= g.K) break;
    const int tap = kk / g.C, ci = kk - tap * g.C;
    const int k1 = tap / g.K2, k2 = tap - k1 * g.K2;
    const int i1 = base1 + k1 * g.d1, i2 = base2 + k2 * g.d2;
    if (i1 >= 0 && i1 < g.S1 && i2 >= 0 && i2 < g.S2)
      u.c[j] = qx[(((long long)b * g.S1 + i1) * g.S2 + i2) * g.C + ci];
  }
  return u.v;
}

__device__ __forceinline__ void mma_s8(int (&d)[4], const int (&a)[4], const int (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, "
      "{%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// the epilogue, in JAX's order: y = float(acc) * (s_x[b] * s_w[c]) rounded to
// the output dtype, then + bias in that dtype; int32 output: the raw sums
__device__ __forceinline__ void store_out(float* out, long long i, int acc, float sx, float sw,
                                          const float* bias, int co) {
  const float y = __fmul_rn(__int2float_rn(acc), __fmul_rn(sx, sw));
  out[i] = bias ? __fadd_rn(y, bias[co]) : y;
}
__device__ __forceinline__ void store_out(__nv_bfloat16* out, long long i, int acc, float sx,
                                          float sw, const float* bias, int co) {
  __nv_bfloat16 v = __float2bfloat16_rn(__fmul_rn(__int2float_rn(acc), __fmul_rn(sx, sw)));
  if (bias)
    v = __float2bfloat16_rn(
        __fadd_rn(__bfloat162float(v), __bfloat162float(__float2bfloat16_rn(bias[co]))));
  out[i] = v;
}
__device__ __forceinline__ void store_out(int* out, long long i, int acc, float, float,
                                          const float*, int) {
  out[i] = acc;
}

// qx (B, S1, S2, C) int8; qw (M, Kpad) int8, K ordered (k1, k2, c_in);
// out (B, M, O1, O2) in OutT.
template <typename OutT>
__global__ void __launch_bounds__(CT) int8_conv_mma(const int8_t* __restrict__ qx,
                                                    const int8_t* __restrict__ qw,
                                                    const float* __restrict__ sx,
                                                    const float* __restrict__ sw,
                                                    const float* __restrict__ bias,
                                                    OutT* __restrict__ out, Geom g) {
  __shared__ __align__(16) int8_t As[BM * LDS];
  __shared__ __align__(16) int8_t Bs[BN * LDS];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tq = lane & 3;
  const int wm = warp >> 1, wn = warp & 1;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;

  int acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0;

  // each thread moves two 16-byte pieces of A and two of B a slice:
  // piece p = tid + 128 * i is row p / 4, bytes 16 * (p % 4)
  int4 ra[2], rb[2];
  auto load = [&](int k0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int p = tid + CT * i, r = p >> 2, kq = (p & 3) * 16;
      const int m = m0 + r, k = k0 + kq;
      ra[i] = (m < g.M && k < g.Kpad)
                  ? __ldg(reinterpret_cast<const int4*>(qw + (long long)m * g.Kpad + k))
                  : make_int4(0, 0, 0, 0);
      rb[i] = load_b_piece(qx, g, n0 + r, k);
    }
  };
  auto store = [&]() {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int p = tid + CT * i, r = p >> 2, kq = (p & 3) * 16;
      *reinterpret_cast<int4*>(As + r * LDS + kq) = ra[i];
      *reinterpret_cast<int4*>(Bs + r * LDS + kq) = rb[i];
    }
  };

  load(0);
  for (int k0 = 0; k0 < g.Kpad; k0 += BK) {
    store();
    __syncthreads();
    if (k0 + BK < g.Kpad) load(k0 + BK);  // in flight during the products below
#pragma unroll
    for (int kk = 0; kk < BK; kk += 32) {
      int a[2][4], b[4][2];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const int row = wm * 32 + mi * 16 + gid;
        a[mi][0] = *reinterpret_cast<const int*>(As + row * LDS + kk + 4 * tq);
        a[mi][1] = *reinterpret_cast<const int*>(As + (row + 8) * LDS + kk + 4 * tq);
        a[mi][2] = *reinterpret_cast<const int*>(As + row * LDS + kk + 16 + 4 * tq);
        a[mi][3] = *reinterpret_cast<const int*>(As + (row + 8) * LDS + kk + 16 + 4 * tq);
      }
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int col = wn * 32 + ni * 8 + gid;
        b[ni][0] = *reinterpret_cast<const int*>(Bs + col * LDS + kk + 4 * tq);
        b[ni][1] = *reinterpret_cast<const int*>(Bs + col * LDS + kk + 16 + 4 * tq);
      }
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) mma_s8(acc[mi][ni], a[mi], b[ni]);
    }
    __syncthreads();
  }

  // accumulator r of a fragment: row gid + 8 * (r / 2), column 2 * tq + r % 2
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int co = m0 + wm * 32 + mi * 16 + gid + 8 * (r >> 1);
        const int n = n0 + wn * 32 + ni * 8 + 2 * tq + (r & 1);
        if (co >= g.M || n >= g.N) continue;
        const int b = n / g.O, o = n - b * g.O;
        store_out(out, ((long long)b * g.M + co) * g.O + o, acc[mi][ni][r], sx[b], sw[co], bias, co);
      }
}

}  // namespace

extern "C" int int8_conv_quantize(const void* x, int dtype, int batch, int channels, int spatial,
                                  long long sb, long long sc, long long ss, void* amax, void* q,
                                  void* scale, void* stream) {
  if (batch < 1 || channels < 1 || spatial < 1 || batch > 65535 ||
      (long long)channels * spatial > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  unsigned* am = static_cast<unsigned*>(amax);
  int8_t* qo = static_cast<int8_t*>(q);
  float* so = static_cast<float*>(scale);
  const int n = channels * spatial;
  dim3 grid_max((n + QCHUNK - 1) / QCHUNK, batch);
  dim3 grid_q((spatial + TS - 1) / TS, (channels + TC - 1) / TC, batch);
  cudaError_t err = cudaMemsetAsync(am, 0, sizeof(unsigned) * batch, s);
  if (err != cudaSuccess) return (int)err;
  if (dtype == 0) {
    const float* xf = static_cast<const float*>(x);
    absmax_rows<float><<<grid_max, QT, 0, s>>>(xf, am, channels, spatial, sb, sc, ss);
    quantize_rows<float><<<grid_q, QT, 0, s>>>(xf, am, qo, so, channels, spatial, sb, sc, ss);
  } else if (dtype == 1) {
    const __nv_bfloat16* xh = static_cast<const __nv_bfloat16*>(x);
    absmax_rows<__nv_bfloat16><<<grid_max, QT, 0, s>>>(xh, am, channels, spatial, sb, sc, ss);
    quantize_rows<__nv_bfloat16><<<grid_q, QT, 0, s>>>(xh, am, qo, so, channels, spatial, sb, sc, ss);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" int int8_conv_launch(const void* qx, const void* qw, const void* sx, const void* sw,
                                const void* bias, void* out, int out_dtype, int batch,
                                int channels, int s1_len, int s2_len, int out_channels, int o1_len,
                                int o2_len, int k1, int k2, int stride1, int stride2, int pad1,
                                int pad2, int dil1, int dil2, int kpad, void* stream) {
  Geom g;
  g.B = batch;
  g.C = channels;
  g.S1 = s1_len;
  g.S2 = s2_len;
  g.M = out_channels;
  g.O1 = o1_len;
  g.O2 = o2_len;
  g.O = o1_len * o2_len;
  g.K1 = k1;
  g.K2 = k2;
  g.K = k1 * k2 * channels;
  g.Kpad = kpad;
  g.s1 = stride1;
  g.s2 = stride2;
  g.p1 = pad1;
  g.p2 = pad2;
  g.d1 = dil1;
  g.d2 = dil2;
  g.vec = channels % 16 == 0;
  const long long n = (long long)batch * g.O;
  if (batch < 1 || channels < 1 || out_channels < 1 || g.O < 1 || kpad < g.K || kpad % 32 ||
      n > 0x7fffffffLL || (n + BN - 1) / BN > 0x7fffffffLL || (out_channels + BM - 1) / BM > 65535)
    return (int)cudaErrorInvalidValue;
  g.N = (int)n;
  dim3 grid((unsigned)((n + BN - 1) / BN), (unsigned)((out_channels + BM - 1) / BM));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int8_t* x8 = static_cast<const int8_t*>(qx);
  const int8_t* w8 = static_cast<const int8_t*>(qw);
  const float* fx = static_cast<const float*>(sx);
  const float* fw = static_cast<const float*>(sw);
  const float* fb = static_cast<const float*>(bias);
  if (out_dtype == 0)
    int8_conv_mma<float><<<grid, CT, 0, s>>>(x8, w8, fx, fw, fb, static_cast<float*>(out), g);
  else if (out_dtype == 1)
    int8_conv_mma<__nv_bfloat16><<<grid, CT, 0, s>>>(x8, w8, fx, fw, fb,
                                                     static_cast<__nv_bfloat16*>(out), g);
  else if (out_dtype == 2)  // the int32 sums themselves (checks)
    int8_conv_mma<int><<<grid, CT, 0, s>>>(x8, w8, fx, fw, fb, static_cast<int*>(out), g);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

extern "C" const char* int8_conv_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
