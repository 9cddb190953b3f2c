// Bidirectional LSTM sweep over a pre-projected gate stream, for Hopper.
//
// Replaces the TPU kernels `_lstm_kernel` / `_lstm_block_kernel` of
// diart_tpu/ops/pallas_lstm.py (reached through `_pallas_sweep` and
// `_pallas_sweep_blocked`, i.e. `lstm_sweep_tm`). Same function:
//
//   proj (T, 2, B, 4H) -> out (T, 2, B, H), both directions in natural time
//   order; direction 1 walks t = T-1 .. 0 by indexing (no flipped copies).
//   gates = proj[t] + h_{t-1} @ w_hh^T   (gate order i, f, g, o)
//   c = sig(f) * c + sig(i) * tanh(g);  h = sig(o) * tanh(c)
//
// h and c are f32; h is rounded to the stream dtype before it multiplies
// w_hh (as the TPU kernel casts h to w_hh's dtype), and the output is
// written in the stream dtype.
//
// What bounds it on the H100: not bytes or FLOPs. At T=293, B=64, H=128 a
// layer moves ~48 MB (bf16) and does ~4.9 GFLOP -- ~15 us at the card's
// peaks -- but the recurrence is T dependent steps. The kernel is
// latency-bound: its time is T x (the time of one step inside one block),
// so the design shortens the step. ONE persistent launch per layer runs the
// whole time loop; one block (split route: one cluster) per (direction,
// batch tile).
//
// Three routes, chosen by the stream dtype and H in one rule (`route_of`,
// mirrored by the wrapper's `_route`; `lstm_sweep_plan` reports them):
//
// * Tensor-core route (bf16 stream, H = 128 or 64):
//   gates^T (4H x 8) = w_hh (4H x H) @ h^T (H x 8) as `mma.sync` m16n8k16
//   tiles. Warp w owns hidden units 8w..8w+7: its two m16 tiles hold rows
//   (i, f) and (g, o) of those units, so the accumulator layout hands ONE
//   thread all four gates of one unit for its two batch columns. w_hh is
//   packed by the wrapper in fragment order and loaded ONCE into registers
//   (H/2 registers a thread) for the whole sweep: no weight traffic per
//   step, no partial sums in shared memory. A step is: ldmatrix of h (bf16,
//   shared memory), H/16 mma per tile in two interleaved chains, the cell
//   update in registers (c never leaves them), h rounded to bf16 into the
//   other half of a double-buffered (8 x H) tile and to `out`, ONE barrier.
//   The gate stream arrives through a 4-stage `cp.async` ring (16 B per
//   thread per step), three steps ahead, issued under the products.
//   A block holds 4 batch rows while 2 * ceil(B / 4) blocks fit one wave of
//   the card, else 8: with 8 every lane updates two cells, and the gate
//   math of the 16 warps, not the products, is what a step waits for; with
//   4 the two lanes of each quad that would idle take one cell each by a
//   shuffle. The gate math uses ex2.approx / rcp.approx (see
//   `fast_sigmoid`): with 4 warps on each scheduler, expf, tanhf and the
//   IEEE division made a sweep a quarter longer. What a step still waits for:
//   the tensor pipe takes the 64 mma of a scheduler's 4 warps one after
//   another, and every warp re-reads the whole h tile.
// * Split route (f32 stream, H = 128 or 64): true f32 has no tensor-core
//   form, and a direction's f32 w_hh (256 KB at H = 128) does not fit one
//   block's 227 KB of shared memory, but it is exactly one SM's register
//   file. A block owns 64 hidden units and holds all four gate rows of each
//   over every k in registers for the whole sweep: 256 x H f32 values over
//   4H threads, 64 registers a thread. At H = 128 a direction takes a
//   CLUSTER OF 2 blocks (units 0..63 and 64..127); at H = 64 one block of
//   256 threads. Thread (unit j, part p) of a unit's H / 16 parts (8
//   threads of one warp at H = 128, 4 at H = 64) holds the four gate rows
//   of j over k = 8p..8p+7 of each half of the k range, the block's own
//   half (the h it computes itself) first. A step: one FMA chain a gate and
//   batch row over the own half (its h from this block's shared memory,
//   whole after the last barrier), then, once the peer's h has arrived,
//   on over the other half; the parts' sums added as a balanced tree in
//   part order by warp shuffles that also spread the results (each thread
//   ends with one or a few (row, gate) sums, so the gate activations run
//   side by side); the four activations of a cell gathered by shuffles,
//   the cell update in registers (c never leaves them); 4 units' new h
//   gathered into one 16-byte store into the block's h tile, into `out`,
//   and, with `st.async`, into the peer's tile, where the bytes complete a
//   phase of its mbarrier (one a step parity; h double-buffered by the
//   step's parity). ONE block barrier a step and no cluster barrier: the
//   exchange's latency hides under the own half's FMAs. h sits in shared
//   memory in an order where the parts of a warp read consecutive 16-byte
//   words (no bank conflict; the units of a warp read the same words, a
//   broadcast). The gate stream is loaded straight into registers two steps
//   ahead, one value a held sum. Precise expf / tanhf and IEEE division.
//   The batch tile BT in {1, 2, 4} is the smallest whose 2 x ceil(B / BT) x
//   cluster blocks fit one wave of the card (BT = 2 at B = 64, H = 128: 128
//   blocks); beyond that BT = 4 and more waves. Measured (chip_smoke.py
//   phase 2, scripts/lstm_sweep_step_probe.py; H100 80GB HBM3, 700 W): 0.33
//   ms at (293, 64, 128) against the FMA route's 1.34; a step ~1,430 cycles,
//   of which the products and the wait for the peer's h ~490, and the
//   serial tail (the tree, the precise activations, the cell update and
//   tanh c, the stores) the rest: what a step still waits for.
// * FMA route (every other H <= 256, either dtype): KS groups of H threads
//   split the k range, leave partial sums in shared memory and sum them in a
//   fixed order after a barrier; w_hh packed as (2, H_k, H_j, 4 gates) sits
//   in shared memory where it fits (bf16 up to H = 160, f32 up to 112) and
//   is read through L2 beyond; the batch tile BT in {1, 2, 4, 8} fills one
//   wave of SMs; precise expf/tanhf.
// All three are deterministic (fixed sum orders, no atomics).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cooperative_groups.h>

#include "hopper.cuh"

#include <initializer_list>
#include <type_traits>

namespace {

constexpr size_t kMaxSmem = 232448;  // 227 KB, the per-block opt-in limit

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

__device__ __forceinline__ void load_w4(const float* p, float (&w)[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  w[0] = v.x; w[1] = v.y; w[2] = v.z; w[3] = v.w;
}
__device__ __forceinline__ void load_w4(const __nv_bfloat16* p, float (&w)[4]) {
  const uint2 v = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.y));
  w[0] = a.x; w[1] = a.y; w[2] = b.x; w[3] = b.y;
}

// BT consecutive floats from shared memory (16-byte aligned when BT >= 4)
template <int BT>
__device__ __forceinline__ void load_h(const float* p, float (&h)[BT]) {
  if constexpr (BT == 1) {
    h[0] = p[0];
  } else if constexpr (BT == 2) {
    const float2 v = *reinterpret_cast<const float2*>(p);
    h[0] = v.x; h[1] = v.y;
  } else {
#pragma unroll
    for (int i = 0; i < BT; i += 4) {
      const float4 v = *reinterpret_cast<const float4*>(p + i);
      h[i] = v.x; h[i + 1] = v.y; h[i + 2] = v.z; h[i + 3] = v.w;
    }
  }
}

__device__ __forceinline__ float sigmoid(float x) { return 1.0f / (1.0f + expf(-x)); }

// proj: (T, 2, B, 4H); wp: (2, H, H, 4) packed [d][k][j][gate]; out: (T, 2, B, H).
// blockDim.x = KS * hp, hp = H rounded up to a warp.
template <typename T, bool W_SMEM, int BT, int KS>
__global__ void __launch_bounds__(512) lstm_sweep_kernel(
    const T* __restrict__ proj, const T* __restrict__ wp, T* __restrict__ out,
    int time, int batch, int hidden) {
  constexpr int RB = (BT + KS - 1) / KS;  // batch rows each thread updates
  extern __shared__ __align__(16) unsigned char smem[];
  const int hp = blockDim.x / KS;
  float* h_s = reinterpret_cast<float*>(smem);  // [hp][BT]
  float* red = h_s + hp * BT;                   // [KS][4][BT][hp]
  const int d = blockIdx.y;
  const int b0 = blockIdx.x * BT;
  const int q = threadIdx.x / hp;
  const int j = threadIdx.x % hp;
  const bool active = j < hidden;
  const int kc = (hidden + KS - 1) / KS;
  const int k0 = q * kc;
  const int k1 = min(hidden, k0 + kc);

  const T* w = wp + (size_t)d * hidden * hidden * 4;
  if constexpr (W_SMEM) {
    T* w_s = reinterpret_cast<T*>(red + KS * 4 * BT * hp);
    using Quad = typename std::conditional<sizeof(T) == 4, float4, uint2>::type;
    const Quad* src = reinterpret_cast<const Quad*>(w);
    Quad* dst = reinterpret_cast<Quad*>(w_s);
    for (int i = threadIdx.x; i < hidden * hidden; i += blockDim.x) dst[i] = src[i];
    w = w_s;
  }
  for (int i = threadIdx.x; i < hp * BT; i += blockDim.x) h_s[i] = 0.0f;
  __syncthreads();

  const size_t slab = (size_t)batch * 4 * hidden;  // elements per (t, d)
  auto load_x = [&](int t, float (&dst)[4][RB]) {
    const int tt = d == 0 ? t : time - 1 - t;
    const T* base = proj + ((size_t)tt * 2 + d) * slab;
#pragma unroll
    for (int r = 0; r < RB; ++r) {
      const int b = q + r * KS;
      const bool ok = active && b < BT && (b0 + b) < batch;
#pragma unroll
      for (int g = 0; g < 4; ++g)
        dst[g][r] = ok ? to_f(base[(size_t)(b0 + b) * 4 * hidden + g * hidden + j]) : 0.0f;
    }
  };

  float c[RB];
#pragma unroll
  for (int r = 0; r < RB; ++r) c[r] = 0.0f;
  float xn[4][RB];
  load_x(0, xn);

  for (int t = 0; t < time; ++t) {
    float xc[4][RB];
#pragma unroll
    for (int g = 0; g < 4; ++g)
#pragma unroll
      for (int r = 0; r < RB; ++r) xc[g][r] = xn[g][r];
    if (t + 1 < time) load_x(t + 1, xn);

    // phase 1: partial gate sums over this group's k range
    if (active) {
      float acc[4][BT];
#pragma unroll
      for (int g = 0; g < 4; ++g)
#pragma unroll
        for (int b = 0; b < BT; ++b) acc[g][b] = 0.0f;
      const T* wj = w + (size_t)j * 4;
#pragma unroll 4
      for (int k = k0; k < k1; ++k) {
        float hv[BT];
        load_h<BT>(h_s + k * BT, hv);
        float wk[4];
        load_w4(wj + (size_t)k * hidden * 4, wk);
#pragma unroll
        for (int g = 0; g < 4; ++g)
#pragma unroll
          for (int b = 0; b < BT; ++b) acc[g][b] = fmaf(wk[g], hv[b], acc[g][b]);
      }
#pragma unroll
      for (int g = 0; g < 4; ++g)
#pragma unroll
        for (int b = 0; b < BT; ++b) red[((q * 4 + g) * BT + b) * hp + j] = acc[g][b];
    }
    __syncthreads();

    // phase 2: gates, cell and hidden state of unit j for rows q, q+KS, ...
    const int tt = d == 0 ? t : time - 1 - t;
    T* orow = out + (((size_t)tt * 2 + d) * batch) * hidden;
#pragma unroll
    for (int r = 0; r < RB; ++r) {
      const int b = q + r * KS;
      if (active && b < BT) {
        float gs[4];
#pragma unroll
        for (int g = 0; g < 4; ++g) {
          float sum = 0.0f;
#pragma unroll
          for (int qq = 0; qq < KS; ++qq) sum += red[((qq * 4 + g) * BT + b) * hp + j];
          gs[g] = xc[g][r] + sum;
        }
        c[r] = sigmoid(gs[1]) * c[r] + sigmoid(gs[0]) * tanhf(gs[2]);
        const T hq = from_f<T>(sigmoid(gs[3]) * tanhf(c[r]));
        h_s[j * BT + b] = to_f(hq);
        if (b0 + b < batch) orow[(size_t)(b0 + b) * hidden + j] = hq;
      }
    }
    __syncthreads();
  }
}

// --------------------------------------------------------------------- //
// Tensor-core route.

constexpr int MMA_N = 8;       // the n of m16n8k16: the h tile's rows
constexpr int MMA_STAGES = 4;  // gate-stream ring

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldmatrix_x4(unsigned addr, unsigned (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint4& a, unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a.x), "r"(a.y), "r"(a.z), "r"(a.w), "r"(b0), "r"(b1));
}

// 16 bytes global -> shared; `bytes` = 0 fills the destination with zeros
__device__ __forceinline__ void cp_async16(unsigned dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// row strides (elements) of the h tile and of a gate-stream row
__host__ __device__ constexpr int mma_h_stride(int kt) { return (kt + 1) / 2 * 32 + 8; }
__host__ __device__ constexpr int mma_x_stride(int kt) { return kt * 64 + 8; }
__host__ __device__ constexpr size_t mma_smem(int kt, int bt) {
  return sizeof(__nv_bfloat16) *
         (2 * MMA_N * mma_h_stride(kt) + MMA_STAGES * bt * mma_x_stride(kt));
}

// Gate math of the tensor-core route: ex2.approx and rcp.approx in place of
// expf, tanhf and the IEEE division. Their absolute error in [0, 1] and
// [-1, 1] is below 1e-6, the size of the f32 sums' own reordering noise,
// and far below the bf16 rounding of h. Measured on an H100 against the same
// kernel with the precise functions: the same error against the plain
// version, and a fifth less time a sweep.
__device__ __forceinline__ float fast_sigmoid(float x) {
  return __fdividef(1.0f, 1.0f + __expf(-x));
}
__device__ __forceinline__ float fast_tanh(float x) {
  return 1.0f - __fdividef(2.0f, 1.0f + __expf(2.0f * x));
}

// H = 16 KT, blockDim.x = 4H (H/8 warps). proj (T, 2, B, 4H) bf16; wp: w_hh
// in fragment order, one uint4 per [d][warp][tile][k tile][lane] (the
// wrapper's pack); out (T, 2, B, H) bf16. BT = 8 batch rows a block: lane
// (gid, tig) updates unit 8 warp + gid for rows 2 tig and 2 tig + 1, as the
// accumulators fall. BT = 4: rows 4..7 of the n = 8 tile stay empty, and the
// two lanes that would idle take over each second row by one shuffle per
// gate, so every lane updates one cell.
template <int KT, int BT>
__global__ void __launch_bounds__(KT * 64, 1) lstm_sweep_mma(
    const __nv_bfloat16* __restrict__ proj, const uint4* __restrict__ wp,
    __nv_bfloat16* __restrict__ out, int time, int batch) {
  static_assert(BT == 4 || BT == 8, "4 or 8 batch rows a block");
  constexpr int ST = MMA_STAGES;
  static_assert(ST % 2 == 0, "a trip of ST steps must leave the h buffers where they were");
  constexpr int H = KT * 16;
  constexpr int NT = KT * 64;
  constexpr int HS = mma_h_stride(KT);
  constexpr int XS = mma_x_stride(KT);
  constexpr int CHUNKS = H / 2;  // 16-byte chunks of one gate-stream row
  constexpr int CELLS = BT / 4;  // cells a lane updates
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* h_s = reinterpret_cast<__nv_bfloat16*>(smem);  // [2][8][HS]
  __nv_bfloat16* x_s = h_s + 2 * MMA_N * HS;                    // [ST][BT][XS]

  const int d = blockIdx.y;
  const int b0 = blockIdx.x * BT;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int unit = warp * 8 + gid;  // the hidden unit this thread updates
  // ... for batch rows b0 + col (+ 1 when BT = 8)
  const int col = BT == 8 ? tig * 2 : (tig & 1) * 2 + (tig >> 1);

  // w_hh: this thread's A fragments, for the whole sweep
  uint4 wa[2][KT];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int kt = 0; kt < KT; ++kt)
      wa[mt][kt] = wp[((((size_t)d * (H / 8) + warp) * 2 + mt) * KT + kt) * 32 + lane];

  for (int i = tid; i < 2 * MMA_N * HS; i += NT) h_s[i] = __float2bfloat16(0.0f);

  // Direction 1 walks time backwards: step 0 is frame T - 1, and every
  // pointer moves by a signed stride per step.
  const size_t slab = (size_t)batch * 4 * H;  // gate-stream elements per (t, d)
  const size_t first = d == 0 ? 0 : (size_t)(time - 1);
  const ptrdiff_t x_step = d == 0 ? (ptrdiff_t)(2 * slab) : -(ptrdiff_t)(2 * slab);
  const ptrdiff_t o_step = x_step / 4;  // out has H per row where proj has 4H

  // the gate-stream ring: thread -> one 16-byte chunk of one of the BT rows
  // (BT = 4: the first half of the threads)
  const int xr = tid / CHUNKS, xc = tid % CHUNKS;
  const bool x_mine = xr < BT;
  const int x_bytes = b0 + xr < batch ? 16 : 0;  // a row past the batch: zeros
  const __nv_bfloat16* x_src =
      proj + (first * 2 + d) * slab + (size_t)(x_bytes ? b0 + xr : 0) * 4 * H + xc * 8;
  const unsigned x_dst = smem_u32(x_s + xr * XS + xc * 8);
  auto issue = [&](int stage, bool in_time) {
    if (x_mine && in_time) {
      cp_async16(x_dst + stage * BT * XS * 2, x_src, x_bytes);
      x_src += x_step;
    }
    cp_async_commit();
  };
#pragma unroll
  for (int t = 0; t < ST - 1; ++t) issue(t, t < time);
  cp_async_wait<ST - 2>();
  __syncthreads();

  // ldmatrix row address of this lane: batch row lane % 8, k offset 8 (lane / 8)
  const unsigned h_addr = smem_u32(h_s + (lane & 7) * HS + (lane >> 3) * 8);
  __nv_bfloat16* orow = out + ((first * 2 + d) * batch + b0 + col) * H + unit;
  const bool row_ok[2] = {b0 + col < batch, b0 + col + 1 < batch};
  float c[CELLS];
#pragma unroll
  for (int j = 0; j < CELLS; ++j) c[j] = 0.0f;

  // ST steps per trip, so the ring stage and the h buffer are constants
  for (int t0 = 0; t0 < time; t0 += ST) {
#pragma unroll
    for (int u = 0; u < ST; ++u) {
      if (t0 + u >= time) break;
      const int cur = u & 1;
      // this step's gate-stream values: [gate][cell]
      const __nv_bfloat16* xs = x_s + (u * BT + col) * XS + unit;
      float x[4][CELLS];
#pragma unroll
      for (int g = 0; g < 4; ++g)
#pragma unroll
        for (int j = 0; j < CELLS; ++j) x[g][j] = __bfloat162float(xs[j * XS + g * H]);
      // h^T as B fragments: one ldmatrix.x4 per pair of k tiles
      unsigned hb[(KT + 1) / 2][4];
#pragma unroll
      for (int kp = 0; kp < (KT + 1) / 2; ++kp)
        ldmatrix_x4(h_addr + (cur * MMA_N * HS + kp * 32) * 2, hb[kp]);
      // two interleaved chains per tile (even and odd k tiles), summed at the end
      float acc[2][2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int ch = 0; ch < 2; ++ch)
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[mt][ch][i] = 0.0f;
#pragma unroll
      for (int kt = 0; kt < KT; ++kt)
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
          mma_bf16(acc[mt][kt & 1], wa[mt][kt], hb[kt >> 1][(kt & 1) * 2],
                   hb[kt >> 1][(kt & 1) * 2 + 1]);
      issue((u + ST - 1) % ST, t0 + u + ST - 1 < time);  // under the products

      // accumulator rows gid / gid + 8 of tile 0 are gates i / f, of tile 1
      // g / o; its columns are batch rows 2 tig, 2 tig + 1: s[gate][column]
      float s[4][2];
#pragma unroll
      for (int g = 0; g < 4; ++g)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          s[g][j] = acc[g >> 1][0][(g & 1) * 2 + j] + acc[g >> 1][1][(g & 1) * 2 + j];
      if constexpr (BT == 4) {  // lanes tig 2, 3 take column 1 of lanes tig 0, 1
#pragma unroll
        for (int g = 0; g < 4; ++g) {
          const float other = __shfl_xor_sync(0xffffffffu, s[g][1], 2);
          s[g][0] = (tig & 2) ? other : s[g][0];
        }
      }
      __nv_bfloat16* hn = h_s + ((cur ^ 1) * MMA_N + col) * HS + unit;
#pragma unroll
      for (int j = 0; j < CELLS; ++j) {
        const float gi = x[0][j] + s[0][j], gf = x[1][j] + s[1][j];
        const float gg = x[2][j] + s[2][j], go = x[3][j] + s[3][j];
        c[j] = fast_sigmoid(gf) * c[j] + fast_sigmoid(gi) * fast_tanh(gg);
        const __nv_bfloat16 hq = __float2bfloat16_rn(fast_sigmoid(go) * fast_tanh(c[j]));
        hn[j * HS] = hq;
        if (row_ok[j]) orow[j * H] = hq;
      }
      orow += o_step;
      cp_async_wait<ST - 2>();
      __syncthreads();
    }
  }
}

template <int KT, int BT>
int launch_mma(const void* proj, const void* wp, void* out, int time, int batch,
               cudaStream_t stream) {
  const dim3 grid((batch + BT - 1) / BT, 2);
  lstm_sweep_mma<KT, BT><<<grid, KT * 64, mma_smem(KT, BT), stream>>>(
      static_cast<const __nv_bfloat16*>(proj), static_cast<const uint4*>(wp),
      static_cast<__nv_bfloat16*>(out), time, batch);
  return (int)cudaGetLastError();
}

template <int BT>
int launch_mma_kt(int kt, const void* proj, const void* wp, void* out, int time, int batch,
                  cudaStream_t s) {
  switch (kt) {
    case 4: return launch_mma<4, BT>(proj, wp, out, time, batch, s);
    case 8: return launch_mma<8, BT>(proj, wp, out, time, batch, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// 4 batch rows a block while that fits one wave of the card, else 8
int mma_rows(int batch, int num_sms) { return 2 * ((batch + 3) / 4) <= num_sms ? 4 : 8; }

// The route of a sweep (the wrapper's `_route` states the same rule): H =
// 128 (the published segmentation model) or 64 (the half-width
// `lstm_hidden` its entry point also takes) run the tensor-core route in
// bf16 (1) and the split route in f32 (2); every other size the FMA route (0)
int route_of(int hidden, int dtype) {
  if (hidden != 128 && hidden != 64) return 0;
  return dtype == 1 ? 1 : 2;
}

// --------------------------------------------------------------------- //
// Split route.

namespace cg = cooperative_groups;

constexpr int kUnits = 64;  // hidden units a block holds (all four gate rows of each)

template <int H>
struct Split {
  static constexpr int kCluster = H / kUnits;       // blocks a direction: 2 at H = 128, 1 at H = 64
  static constexpr int kParts = H / 16;             // threads that share a unit's sum: 8 / 4
  static constexpr int kThreads = kUnits * kParts;  // 512 / 256
  static constexpr int kWarpUnits = 32 / kParts;    // units a warp: 4 / 8
};

__host__ __device__ constexpr int log2i(int n) { return n <= 1 ? 0 : 1 + log2i(n / 2); }

// One half of a step's product: v[4 b + g] += w[g][8 SLOT + e] h[b][k_e] for
// e = 0..7 in order, one FMA chain a (row, gate). `hh` points at this
// thread's first 16-byte word of the half in the h tile: word q of part p
// lies at (q NP + p) 4 within the half.
template <int H, int BT, int SLOT>
__device__ __forceinline__ void split_half(const float (&w)[4][16], const float* hh, float (&v)[4 * BT]) {
  constexpr int NP = Split<H>::kParts;
#pragma unroll
  for (int q = 0; q < 2; ++q)
#pragma unroll
    for (int b = 0; b < BT; ++b) {
      const float4 h4 = *reinterpret_cast<const float4*>(hh + b * H + q * NP * 4);
      const float hv[4] = {h4.x, h4.y, h4.z, h4.w};
#pragma unroll
      for (int e = 0; e < 4; ++e)
#pragma unroll
        for (int g = 0; g < 4; ++g) v[4 * b + g] = fmaf(w[g][8 * SLOT + 4 * q + e], hv[e], v[4 * b + g]);
    }
}

// proj (T, 2, B, 4H) f32; wp (2, CL, 16, 4H, 4) f32, `pack_w_hh`'s "split"
// layout: float4 r of thread tid of block `rank` of direction d holds
// w_hh[d][g H + j][hf H/2 + 8 p + 4 (r % 2) + c], c = 0..3, for r = 4 g + 2
// slot + r % 2 and hf = slot ^ rank (slot 0: the block's own half), where
// tid = 32 warp + NP u + p and j = 64 rank + warp (32 / NP) + u; out (T, 2,
// B, H) f32. Grid (CL x ceil(B / BT), 2), clusters of CL blocks along x.
template <int H, int BT>
__global__ void __launch_bounds__(Split<H>::kThreads, 1) lstm_sweep_split(
    const float* __restrict__ proj, const float4* __restrict__ wp, float* __restrict__ out, int time,
    int batch) {
  using S = Split<H>;
  constexpr int CL = S::kCluster, NP = S::kParts, NT = S::kThreads, HALF = H / 2;
  constexpr int NV = 4 * BT;                  // sums a thread carries, [row][gate]
  constexpr int LP = log2i(NP), LV = log2i(NV);
  constexpr int LH = LP < LV ? LP : LV;       // levels of the tree that halve the sums a thread holds
  constexpr int R = NV >> LH;                 // sums a thread holds after the tree
  constexpr unsigned ALL = 0xffffffffu;
  __shared__ __align__(16) float h_s[2][BT][H];  // h by its step's parity, k in the parts' order
  __shared__ __align__(8) unsigned long long mbar[2];  // the peer's h of a step, by its parity

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int u = lane / NP, p = lane % NP;
  int rank = 0;
  if constexpr (CL > 1) rank = (int)cg::this_cluster().block_rank();
  const int d = blockIdx.y, b0 = (blockIdx.x / CL) * BT;
  const int j = rank * kUnits + warp * S::kWarpUnits + u;  // this thread's unit

  float w[4][16];  // [gate][8 slot + e], for the whole sweep
  {
    const float4* src = wp + (size_t)(d * CL + rank) * 16 * NT + tid;
#pragma unroll
    for (int r = 0; r < 16; ++r) {
      const float4 v = __ldg(src + (size_t)r * NT);
      w[r / 4][(r % 4) * 4] = v.x;
      w[r / 4][(r % 4) * 4 + 1] = v.y;
      w[r / 4][(r % 4) * 4 + 2] = v.z;
      w[r / 4][(r % 4) * 4 + 3] = v.w;
    }
  }
  for (int i = tid; i < 2 * BT * H; i += NT) (&h_s[0][0][0])[i] = 0.0f;  // h_{-1} = 0
  unsigned peer_h = 0, peer_bar = 0;
  if constexpr (CL > 1) {
    if (tid == 0) {
      hopper::mbar_init(hopper::smem_u32(&mbar[0]), 1);
      hopper::mbar_init(hopper::smem_u32(&mbar[1]), 1);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    // both blocks run, their h tiles zeroed and mbarriers set: the peer's
    // shared memory may be written from here on
    hopper::cluster_barrier();
    peer_h = hopper::map_rank(hopper::smem_u32(&h_s[0][0][0]), rank ^ 1);
    peer_bar = hopper::map_rank(hopper::smem_u32(&mbar[0]), rank ^ 1);
  } else {
    __syncthreads();
  }

  // After the tree this thread holds the sums base .. base + R - 1 of
  // [row][gate]: the halving levels l pick the upper half where bit l of p
  // is set. It updates the cell (row, j) with the lanes that share its row.
  int base = 0;
#pragma unroll
  for (int l = 0; l < LH; ++l) base += ((p >> l) & 1) * (NV >> (l + 1));
  const int row = base / 4;
  int src[4];  // the lane that holds gate g of (row, j) after the tree
#pragma unroll
  for (int g = 0; g < 4; ++g) {
    int q = p;
#pragma unroll
    for (int l = 0; l < LH; ++l) q = (q & ~(1 << l)) | ((((4 * row + g) >> (LV - 1 - l)) & 1) << l);
    src[g] = u * NP + q;
  }
  // one writer a row and 4 units: units j0 .. j0 + 3 are one 16-byte word of the h tile
  const bool writer = (u % 4) == 0 && (base % 4) == 0 && (p >> LH) == 0;
  const int j0 = j - u % 4, k0 = j0 % HALF;
  const int hpos = (j0 / HALF) * HALF + (((k0 % 8) / 4) * NP + k0 / 8) * 4;
  const int pack = (u - u % 4) * NP + p;  // the lane of unit j0 with this thread's row

  // the gate stream of the held sums, loaded two steps ahead
  const size_t slab = (size_t)batch * 4 * H;  // elements per (time, direction)
  int xoff[R];
  bool xok[R];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int b = (base + i) / 4, g = (base + i) % 4;
    xok[i] = b0 + b < batch;
    xoff[i] = (b0 + b) * 4 * H + g * H + j;
  }
  auto load_x = [&](int t, float (&x)[R]) {  // t < time
    const float* src_t = proj + ((size_t)(d == 0 ? t : time - 1 - t) * 2 + d) * slab;
#pragma unroll
    for (int i = 0; i < R; ++i) x[i] = xok[i] ? __ldg(src_t + xoff[i]) : 0.0f;
  };
  float x0[R], x1[R] = {};
  load_x(0, x0);
  if (time > 1) load_x(1, x1);
  float c = 0.0f;

  for (int t = 0; t < time; ++t) {
    float xc[R];
#pragma unroll
    for (int i = 0; i < R; ++i) { xc[i] = x0[i]; x0[i] = x1[i]; }
    if (t + 2 < time) load_x(t + 2, x1);
    // the peer's h_t, sent unless this is the last step
    if (CL > 1 && tid == 0 && t + 1 < time)
      hopper::mbar_expect_tx(hopper::smem_u32(&mbar[t & 1]), 4 * kUnits * BT);

    const float* hb = &h_s[(t + 1) & 1][0][0];  // h_{t-1}
    float v[NV];
#pragma unroll
    for (int i = 0; i < NV; ++i) v[i] = 0.0f;
    split_half<H, BT, 0>(w, hb + rank * HALF + 4 * p, v);
    if (CL > 1 && t > 0) hopper::mbar_wait(hopper::smem_u32(&mbar[(t - 1) & 1]), ((t - 1) >> 1) & 1);
    split_half<H, BT, 1>(w, hb + (rank ^ 1) * HALF + 4 * p, v);

    // the parts' sums as a balanced tree in part order (level l adds lanes
    // p and p ^ 2^l), halving what a thread holds while there is more than one
#pragma unroll
    for (int l = 0; l < LP; ++l) {
      if (l < LH) {
        const int n = NV >> (l + 1);
        const bool up = (p >> l) & 1;
#pragma unroll
        for (int i = 0; i < NV / 2; ++i) {  // a constant trip count: v stays in registers
          if (i < n) {
            const float send = up ? v[i] : v[n + i];
            const float keep = up ? v[n + i] : v[i];
            v[i] = keep + __shfl_xor_sync(ALL, send, 1 << l);
          }
        }
      } else {
        v[0] += __shfl_xor_sync(ALL, v[0], 1 << l);
      }
    }
    float a[R];
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const float pre = xc[i] + v[i];
      a[i] = (base + i) % 4 == 2 ? tanhf(pre) : sigmoid(pre);
    }
    float act[4];
#pragma unroll
    for (int g = 0; g < 4; ++g) act[g] = R == 4 ? a[g % R] : __shfl_sync(ALL, a[g % R], src[g]);
    c = act[1] * c + act[0] * act[2];
    const float hv = act[3] * tanhf(c);

    float4 h4;
    h4.x = __shfl_sync(ALL, hv, pack);
    h4.y = __shfl_sync(ALL, hv, pack + NP);
    h4.z = __shfl_sync(ALL, hv, pack + 2 * NP);
    h4.w = __shfl_sync(ALL, hv, pack + 3 * NP);
    if (writer) {
      const int buf = t & 1, at = (buf * BT + row) * H + hpos;
      *reinterpret_cast<float4*>(&h_s[0][0][0] + at) = h4;
      if constexpr (CL > 1)
        if (t + 1 < time) hopper::st_async16(peer_h + 4u * at, h4, peer_bar + 8u * buf);
      if (b0 + row < batch) {
        const int tt = d == 0 ? t : time - 1 - t;
        *reinterpret_cast<float4*>(out + (((size_t)tt * 2 + d) * batch + b0 + row) * H + j0) = h4;
      }
    }
    __syncthreads();  // this block's h_t is whole
  }
  // every st.async into this block was waited for; no block leaves before its peer is done
  if constexpr (CL > 1) hopper::cluster_barrier();
}

// the split route's batch tile: the smallest of 1, 2, 4 whose 2 x ceil(B /
// BT) x cluster blocks fit one wave of the card, else 4 (more waves)
int split_bt(int batch, int hidden, int num_sms) {
  for (int bt : {1, 2}) {
    if (2 * ((batch + bt - 1) / bt) * (hidden / kUnits) <= num_sms) return bt;
  }
  return 4;
}

template <int H, int BT>
cudaLaunchConfig_t split_config(int batch, cudaStream_t stream, cudaLaunchAttribute* attr) {
  constexpr int CL = Split<H>::kCluster;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(CL * ((batch + BT - 1) / BT), 2, 1);
  cfg.blockDim = dim3(Split<H>::kThreads, 1, 1);
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CL;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

template <int H, int BT>
int launch_split_kernel(const void* proj, const void* wp, void* out, int time, int batch, cudaStream_t s) {
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = split_config<H, BT>(batch, s, attr);
  const cudaError_t err = cudaLaunchKernelEx(&cfg, lstm_sweep_split<H, BT>, static_cast<const float*>(proj),
                                             static_cast<const float4*>(wp), static_cast<float*>(out), time, batch);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <int H>
int launch_split_h(int bt, const void* proj, const void* wp, void* out, int time, int batch, cudaStream_t s) {
  switch (bt) {
    case 1: return launch_split_kernel<H, 1>(proj, wp, out, time, batch, s);
    case 2: return launch_split_kernel<H, 2>(proj, wp, out, time, batch, s);
    default: return launch_split_kernel<H, 4>(proj, wp, out, time, batch, s);
  }
}

int launch_split(const void* proj, const void* wp, void* out, int time, int batch, int hidden, int num_sms,
                 cudaStream_t s) {
  const int bt = split_bt(batch, hidden, num_sms);
  if (hidden == 128) return launch_split_h<128>(bt, proj, wp, out, time, batch, s);
  return launch_split_h<64>(bt, proj, wp, out, time, batch, s);
}

template <int BT>
int max_clusters(int batch, int* clusters) {
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = split_config<128, BT>(batch, nullptr, attr);
  return (int)cudaOccupancyMaxActiveClusters(clusters, lstm_sweep_split<128, BT>, &cfg);
}

// --------------------------------------------------------------------- //
// The FMA route's launch plan.

struct Plan {
  int bt, ks, hp;
  bool w_smem;
  size_t smem;
};

Plan plan(int batch, int hidden, size_t elt, int num_sms) {
  Plan p;
  p.hp = (hidden + 31) / 32 * 32;
  p.ks = p.hp <= 128 ? 4 : 2;
  const size_t w_bytes = (size_t)hidden * hidden * 4 * elt;
  auto smem_for = [&](int bt, bool w_smem) {
    return (size_t)p.hp * bt * 4 + (size_t)p.ks * 4 * bt * p.hp * 4 + (w_smem ? w_bytes : 0);
  };
  p.w_smem = smem_for(1, true) <= kMaxSmem;
  if (p.w_smem) {
    p.bt = 8;
    for (int bt : {1, 2, 4, 8}) {
      if (2 * ((batch + bt - 1) / bt) <= num_sms) {
        p.bt = bt;
        break;
      }
    }
    while (p.bt > 1 && smem_for(p.bt, true) > kMaxSmem) p.bt /= 2;
  } else {
    p.bt = 4;
  }
  p.smem = smem_for(p.bt, p.w_smem);
  return p;
}

template <typename T, bool W, int BT>
int launch_bt(const Plan& p, const void* proj, const void* wp, void* out, int time, int batch,
              int hidden, cudaStream_t stream) {
  auto kern = p.ks == 4 ? lstm_sweep_kernel<T, W, BT, 4> : lstm_sweep_kernel<T, W, BT, 2>;
  if (p.smem > 48 * 1024) {
    cudaError_t err =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)p.smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((batch + BT - 1) / BT, 2);
  kern<<<grid, p.ks * p.hp, p.smem, stream>>>(static_cast<const T*>(proj),
                                             static_cast<const T*>(wp), static_cast<T*>(out),
                                             time, batch, hidden);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_w(const Plan& p, const void* proj, const void* wp, void* out, int time, int batch,
             int hidden, cudaStream_t s) {
  switch (p.bt) {
    case 1: return launch_bt<T, true, 1>(p, proj, wp, out, time, batch, hidden, s);
    case 2: return launch_bt<T, true, 2>(p, proj, wp, out, time, batch, hidden, s);
    case 4: return launch_bt<T, true, 4>(p, proj, wp, out, time, batch, hidden, s);
    default: return launch_bt<T, true, 8>(p, proj, wp, out, time, batch, hidden, s);
  }
}

template <typename T>
int launch(const void* proj, const void* wp, void* out, int time, int batch, int hidden,
           int num_sms, cudaStream_t stream) {
  const Plan p = plan(batch, hidden, sizeof(T), num_sms);
  if (p.w_smem) return launch_w<T>(p, proj, wp, out, time, batch, hidden, stream);
  return launch_bt<T, false, 4>(p, proj, wp, out, time, batch, hidden, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; route: 0 = FMA (wp as [d][k][j][gate]),
// 1 = tensor cores (wp in fragment order), 2 = split (wp in its thread
// order) -- it must be the route `lstm_sweep_plan` gives for this size;
// num_sms: the card's SM count (sizes the batch tile). Returns the
// cudaError_t of the launch.
extern "C" int lstm_sweep_launch(const void* proj, const void* wp, void* out, int time, int batch,
                                 int hidden, int dtype, int route, int num_sms, void* stream) {
  if (time < 1 || batch < 1 || hidden < 1 || hidden > 256 || num_sms < 1 ||
      (dtype != 0 && dtype != 1) || route != route_of(hidden, dtype))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (route == 1) {
    if (mma_rows(batch, num_sms) == 4)
      return launch_mma_kt<4>(hidden / 16, proj, wp, out, time, batch, s);
    return launch_mma_kt<8>(hidden / 16, proj, wp, out, time, batch, s);
  }
  if (route == 2) return launch_split(proj, wp, out, time, batch, hidden, num_sms, s);
  if (dtype == 0) return launch<float>(proj, wp, out, time, batch, hidden, num_sms, s);
  return launch<__nv_bfloat16>(proj, wp, out, time, batch, hidden, num_sms, s);
}

// The launch plan for a sweep of this size, for reports: fields[0..7] =
// the route (0 FMA, 1 tensor cores, 2 split), batch rows per block, k groups
// (FMA route; 0 otherwise), where w_hh lives during the sweep (2 =
// registers, 1 = shared memory, 0 = global memory through L2), blocks a
// cluster, blocks, threads a block, and the threads that add to one unit's
// sum (the split route's parts; the FMA route's k groups; 1 on the
// tensor-core route, whose sums stay in one thread's accumulators).
extern "C" void lstm_sweep_plan(int batch, int hidden, int dtype, int num_sms, int* fields) {
  const int route = route_of(hidden, dtype);
  if (route == 1) {
    const int bt = mma_rows(batch, num_sms);
    const int f[8] = {1, bt, 0, 2, 1, 2 * ((batch + bt - 1) / bt), 4 * hidden, 1};
    for (int i = 0; i < 8; ++i) fields[i] = f[i];
    return;
  }
  if (route == 2) {
    const int bt = split_bt(batch, hidden, num_sms), cl = hidden / kUnits;
    const int f[8] = {2, bt, 0, 2, cl, 2 * cl * ((batch + bt - 1) / bt), 4 * hidden, hidden / 16};
    for (int i = 0; i < 8; ++i) fields[i] = f[i];
    return;
  }
  const Plan p = plan(batch, hidden, dtype == 0 ? 4 : 2, num_sms);
  const int f[8] = {0, p.bt, p.ks, p.w_smem ? 1 : 0, 1, 2 * ((batch + p.bt - 1) / p.bt), p.ks * p.hp, p.ks};
  for (int i = 0; i < 8; ++i) fields[i] = f[i];
}

// How many clusters of the split route at H = 128 the card holds at once
// (cudaOccupancyMaxActiveClusters), for reports. Returns the cudaError_t.
extern "C" int lstm_sweep_max_clusters(int batch, int num_sms, int* clusters) {
  switch (split_bt(batch, 128, num_sms)) {
    case 1: return max_clusters<1>(batch, clusters);
    case 2: return max_clusters<2>(batch, clusters);
    default: return max_clusters<4>(batch, clusters);
  }
}

extern "C" const char* lstm_sweep_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
