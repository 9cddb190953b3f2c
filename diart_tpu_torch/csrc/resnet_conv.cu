// WeSpeaker ResNet34's trunk convolutions for Hopper, each in one launch
// that writes its output once: normalized, added, rectified and
// channels-last.
//
//   out[b, t, f, c] = relu?( bf16( bf16( bf16( bf16(sum_{i, j, k}
//                       x[b, t s + i - p, f s + j - p, k] w[c, k, i, j])
//                       * a[c]) + b[c]) + res[b, t, f, c]) )
//
// a 2-D convolution of bf16 activations laid out (B, T, F, C) (time, mel,
// channels: the JAX package's layout) with f32 sums, then the folded batch
// norm (a, b) = InferenceBatchNorm.folded() rounded to bf16, optionally
// the residual (read from the same (B, T', F', C_out) layout) and
// optionally ReLU, each step rounded to bf16 once, in the order PyTorch's
// separate ops round (and the JAX package states it, `x * a.astype(x.dtype)
// + b.astype(x.dtype)`): in `mul.rn.bf16x2` and `add.rn.bf16x2` (`epilogue2`
// says why those are the plain version's bits), none contracted into an FMA
// (no --use_fast_math). So the kernel and the plain version differ only in
// the order of the sum.
//
// It replaces no TPU kernel: the JAX package leaves the trunk to XLA
// (`conv_general_dilated` plus the norm, ReLU and the add in
// diart_tpu/models/resnet.py), which fuses them over channels-last
// activations. On the card it replaces cuDNN's bf16 convolution and the
// glue around each of the trunk's 36 convolutions: the NCHW <-> NHWC
// transposes cuDNN makes around every call, the norm's scale and shift
// as two passes, ReLU and the residual add; at B = 256 that glue was 58 of
// the trunk's 76 ms.
//
// What bounds it on the H100 (portbench/work/resnet34.py, each
// convolution's input read, output and weights written or read once, and
// its products at 989 TFLOP/s; B = 256, 5 s windows): stages 1 and 2 are
// bound by bytes (stage 1's 32-channel maps are 653 MB, a 3x3 convolution
// 0.39 ms by bytes against 0.19 ms by products; stage 2's 0.195 ms against
// 0.190), stages 3 and 4 by products (0.19 ms a 3x3 convolution against
// 0.10 and 0.05 ms of bytes); the stem by its output (0.20 ms); 8.01 ms in
// all, plus ~1.3 ms of residual reads. (The stride-2 1x1 downsamples read a
// quarter of their input, so they run under that count's bound.)
//
// What this design does about it:
//
// * Implicit GEMM on `wgmma.mma_async` m64nNk16 bf16 -> f32, fed by TMA,
//   one persistent block an SM: a producer warpgroup (one lane issues the
//   loads; `setmaxnreg` gives its registers to the others) and two
//   consumer warpgroups. M = output positions in boxes of 64 (box1 time
//   rows x box2 mel columns of one sample; a tile's boxes stacked along
//   time), so the sums of a position are one channel vector of the
//   channels-last output; N = output channels (16, 32, 64, 128 or 256 a
//   tile: the whole width up to 256); K = one window tap x a slice of bk
//   (16, 32 or 64) input channels. The weights are laid out (C_out, taps x
//   C_pad), C_pad = C_in rounded up to 16 and zero-filled; the tensor maps'
//   out-of-bounds zeros give the padding (and the channels past C_in): no
//   unfolded or padded copy is written. Operands are K-major rows of 2 bk
//   bytes, swizzled by their row.
// * Three routes (`ops/resnet_conv.py` conv_plan). `resnet_conv_taps` (the
//   stride-2 3x3 and 1x1 convolutions): each tap's activation box read by
//   TMA at the convolution's stride (the tensor map's element strides), a
//   ring of stages of boxes and weights, both warpgroups on one tile. Read
//   that way a 3x3 convolution at stride 1 moves nine times its input from
//   L2 into shared memory, which bound the first design (2.4 ms a stage-1
//   convolution at B = 256 on an H100 SXM); so the 3x3 windows at stride 1
//   read each tile's input once a K slice as a halo (the tile's rows and
//   columns and one more on each side, one TMA box) and take each tap's A
//   operand out of it with `ldmatrix` at the tap's offset (`wgmma` with A
//   in registers): `resnet_conv_halo` with the weights in a ring of
//   stages (stages 3 and 4), `resnet_conv_pingpong` where one K slice
//   holds C_in and N <= 64 (stages 1 and 2) with all nine taps' weights
//   kept in shared memory and the two warpgroups taking turns over tiles,
//   so that one's epilogue runs under the other's products.
// * The epilogue was most of a tile's time (the card idles under it with
//   one block an SM): the sums are rounded to bf16 pairs and transposed in
//   each quad, so that the residual, the norm and the output move as
//   16-byte pieces, a warp's store 8 rows x 64 contiguous bytes; the
//   residual is loaded when the tile starts, under its products, where the
//   registers allow.
// * `resnet_stem`: the 3x3 stem from one input channel (K = 9, too thin
//   for the tensor cores) on the CUDA cores: a thread computes 8 output
//   channels of 4 neighbouring positions from the bf16-rounded f32
//   features (the cast the plain version makes), in f32 fused
//   multiply-adds (each product of two bf16 values is exact in f32), the
//   same epilogue, and 16-byte stores; it is bound by its 653 MB output.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int CONSUMER_WARPS = 8;                        // two warpgroups
constexpr int CONV_THREADS = 32 * CONSUMER_WARPS + 128;  // + the producer warpgroup
// registers a thread after `setmaxnreg`: the producer warpgroup gives its
// share to the consumers (the register file's 64 K: 128 x 40 + 256 x 232)
constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;
constexpr int ROWS = 64;                                // output positions a warpgroup
constexpr int MAX_STAGES = 8;
constexpr int RING_BYTES = 200 * 1024;  // the ring's shared memory budget (halo buffers included)
constexpr int HALO_BUFFERS = 2;         // the halo route's input buffers
constexpr int STEM_THREADS = 256;
constexpr int STEM_TAPS = 9;
constexpr int STEM_RUN = 4;  // neighbouring positions a stem thread computes at a time

__device__ __forceinline__ void tma_2d(unsigned dst, const CUtensorMap* map, int c0, int c1,
                                       unsigned bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}
__device__ __forceinline__ void tma_4d(unsigned dst, const CUtensorMap* map, int c0, int c1, int c2,
                                       int c3, unsigned bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(bar)
      : "memory");
}

// (generated: one wrapper a tile width N, accumulators d[N / 8][4])
// d (64 x 16, f32) (+)= A (64 x 16, bf16, K-major) . B (16 x 16, bf16, K-major)^T
__device__ __forceinline__ void wgmma_bf16(float (&d)[2][4], uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3])
      : "l"(da), "l"(db), "r"(accumulate));
}
// d (64 x 32, f32) (+)= A (64 x 16, bf16, K-major) . B (32 x 16, bf16, K-major)^T
__device__ __forceinline__ void wgmma_bf16(float (&d)[4][4], uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]), "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]), "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3])
      : "l"(da), "l"(db), "r"(accumulate));
}
// d (64 x 64, f32) (+)= A (64 x 16, bf16, K-major) . B (64 x 16, bf16, K-major)^T
__device__ __forceinline__ void wgmma_bf16(float (&d)[8][4], uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]), "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]), "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]), "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]), "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]), "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]), "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "l"(da), "l"(db), "r"(accumulate));
}
// d (64 x 128, f32) (+)= A (64 x 16, bf16, K-major) . B (128 x 16, bf16, K-major)^T
__device__ __forceinline__ void wgmma_bf16(float (&d)[16][4], uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]), "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]), "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]), "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]), "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]), "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]), "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]), "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]), "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]), "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]), "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]), "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]), "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]), "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]), "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3])
      : "l"(da), "l"(db), "r"(accumulate));
}
// d (64 x 256, f32) (+)= A (64 x 16, bf16, K-major) . B (256 x 16, bf16, K-major)^T
__device__ __forceinline__ void wgmma_bf16(float (&d)[32][4], uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, %128, %129, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]), "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]), "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]), "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]), "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]), "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]), "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]), "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]), "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]), "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]), "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]), "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]), "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]), "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]), "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3]), "+f"(d[16][0]), "+f"(d[16][1]), "+f"(d[16][2]), "+f"(d[16][3]), "+f"(d[17][0]), "+f"(d[17][1]), "+f"(d[17][2]), "+f"(d[17][3]), "+f"(d[18][0]), "+f"(d[18][1]), "+f"(d[18][2]), "+f"(d[18][3]), "+f"(d[19][0]), "+f"(d[19][1]), "+f"(d[19][2]), "+f"(d[19][3]), "+f"(d[20][0]), "+f"(d[20][1]), "+f"(d[20][2]), "+f"(d[20][3]), "+f"(d[21][0]), "+f"(d[21][1]), "+f"(d[21][2]), "+f"(d[21][3]), "+f"(d[22][0]), "+f"(d[22][1]), "+f"(d[22][2]), "+f"(d[22][3]), "+f"(d[23][0]), "+f"(d[23][1]), "+f"(d[23][2]), "+f"(d[23][3]), "+f"(d[24][0]), "+f"(d[24][1]), "+f"(d[24][2]), "+f"(d[24][3]), "+f"(d[25][0]), "+f"(d[25][1]), "+f"(d[25][2]), "+f"(d[25][3]), "+f"(d[26][0]), "+f"(d[26][1]), "+f"(d[26][2]), "+f"(d[26][3]), "+f"(d[27][0]), "+f"(d[27][1]), "+f"(d[27][2]), "+f"(d[27][3]), "+f"(d[28][0]), "+f"(d[28][1]), "+f"(d[28][2]), "+f"(d[28][3]), "+f"(d[29][0]), "+f"(d[29][1]), "+f"(d[29][2]), "+f"(d[29][3]), "+f"(d[30][0]), "+f"(d[30][1]), "+f"(d[30][2]), "+f"(d[30][3]), "+f"(d[31][0]), "+f"(d[31][1]), "+f"(d[31][2]), "+f"(d[31][3])
      : "l"(da), "l"(db), "r"(accumulate));
}

// (generated: the same with A from registers, a wgmma A fragment)
// d (64 x 16, f32) (+)= A (64 x 16, bf16, registers) . B (16 x 16, bf16, K-major)^T
__device__ __forceinline__ void wgmma_bf16_rs(float (&d)[2][4], const unsigned (&a)[4], uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}
// d (64 x 32, f32) (+)= A (64 x 16, bf16, registers) . B (32 x 16, bf16, K-major)^T
__device__ __forceinline__ void wgmma_bf16_rs(float (&d)[4][4], const unsigned (&a)[4], uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, {%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]), "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]), "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}
// d (64 x 64, f32) (+)= A (64 x 16, bf16, registers) . B (64 x 16, bf16, K-major)^T
__device__ __forceinline__ void wgmma_bf16_rs(float (&d)[8][4], const unsigned (&a)[4], uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]), "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]), "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]), "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]), "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]), "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]), "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}
// d (64 x 128, f32) (+)= A (64 x 16, bf16, registers) . B (128 x 16, bf16, K-major)^T
__device__ __forceinline__ void wgmma_bf16_rs(float (&d)[16][4], const unsigned (&a)[4], uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]), "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]), "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]), "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]), "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]), "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]), "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]), "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]), "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]), "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]), "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]), "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]), "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]), "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]), "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}
// d (64 x 256, f32) (+)= A (64 x 16, bf16, registers) . B (256 x 16, bf16, K-major)^T
__device__ __forceinline__ void wgmma_bf16_rs(float (&d)[32][4], const unsigned (&a)[4], uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, {%128, %129, %130, %131}, %132, p, 1, 1, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]), "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]), "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]), "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]), "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]), "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]), "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]), "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]), "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]), "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]), "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]), "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]), "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]), "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]), "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3]), "+f"(d[16][0]), "+f"(d[16][1]), "+f"(d[16][2]), "+f"(d[16][3]), "+f"(d[17][0]), "+f"(d[17][1]), "+f"(d[17][2]), "+f"(d[17][3]), "+f"(d[18][0]), "+f"(d[18][1]), "+f"(d[18][2]), "+f"(d[18][3]), "+f"(d[19][0]), "+f"(d[19][1]), "+f"(d[19][2]), "+f"(d[19][3]), "+f"(d[20][0]), "+f"(d[20][1]), "+f"(d[20][2]), "+f"(d[20][3]), "+f"(d[21][0]), "+f"(d[21][1]), "+f"(d[21][2]), "+f"(d[21][3]), "+f"(d[22][0]), "+f"(d[22][1]), "+f"(d[22][2]), "+f"(d[22][3]), "+f"(d[23][0]), "+f"(d[23][1]), "+f"(d[23][2]), "+f"(d[23][3]), "+f"(d[24][0]), "+f"(d[24][1]), "+f"(d[24][2]), "+f"(d[24][3]), "+f"(d[25][0]), "+f"(d[25][1]), "+f"(d[25][2]), "+f"(d[25][3]), "+f"(d[26][0]), "+f"(d[26][1]), "+f"(d[26][2]), "+f"(d[26][3]), "+f"(d[27][0]), "+f"(d[27][1]), "+f"(d[27][2]), "+f"(d[27][3]), "+f"(d[28][0]), "+f"(d[28][1]), "+f"(d[28][2]), "+f"(d[28][3]), "+f"(d[29][0]), "+f"(d[29][1]), "+f"(d[29][2]), "+f"(d[29][3]), "+f"(d[30][0]), "+f"(d[30][1]), "+f"(d[30][2]), "+f"(d[30][3]), "+f"(d[31][0]), "+f"(d[31][1]), "+f"(d[31][2]), "+f"(d[31][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

// 16 bytes of each of eight rows a matrix, four matrices: a wgmma A
// fragment (rows g / g + 8, k 2 tig / 2 tig + 8 of a 16 x 16 tile) from the
// rows whose addresses lanes 0-15 (k 0-7) and 16-31 (k 8-15) give
__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], unsigned addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

// the stem's input as the plain version casts it: f32 rounded to bf16
__device__ __forceinline__ float round_bf16(float v) { return __bfloat162float(__float2bfloat16_rn(v)); }
__device__ __forceinline__ float round_bf16(__nv_bfloat16 v) { return __bfloat162float(v); }

// the launch's geometry and tiling (see resnet_conv_launch)
struct Plan {
  int M, O1, O2;               // output channels, output positions
  int cpad, bk, slices;        // padded input channels, K slice, slices a tap
  int k2, taps;                // window columns, window taps
  int s1, s2, p1, p2;          // stride, padding
  int box1, box2;              // a 64-position box: box1 rows x box2 columns
  int rows;                    // output rows a tile (its boxes stacked along O1)
  int nt, pt1, pt2, tiles;     // tiles along channels, O1, O2; all tiles
  int stages;                  // ring depth
  int has_res, relu;
};

// the epilogue of two neighbouring channels of one position, in the plain
// version's order: the sum rounded to bf16 (by the caller), times a, plus
// b, plus the residual, then ReLU, in bf16x2 arithmetic, each step rounded
// once to bf16. PyTorch's bf16 ops compute each step in f32 and round that
// to bf16: the product of two bf16 values is exact in f32, and the f32 sum
// of two bf16 values rounds to bf16 as their exact sum does (it is exact
// unless their exponents lie more than 16 apart, and then the smaller lies
// below half a bf16 step of the larger), so `mul.rn.bf16x2` and
// `add.rn.bf16x2` give the plain version's bits. The `.rn` keeps the two
// apart: without it the compiler may contract the product and the sum after
// it into one fused multiply-add, which rounds once where the plain version
// rounds twice (with `__hmul2` and `__hadd2` 8-28% of a layer's outputs came
// out a bf16 step off the plain version's on an H100).
__device__ __forceinline__ __nv_bfloat162 mul_rn(__nv_bfloat162 a, __nv_bfloat162 b) {
  unsigned d;
  asm("mul.rn.bf16x2 %0, %1, %2;\n" : "=r"(d) : "r"(*reinterpret_cast<unsigned*>(&a)), "r"(*reinterpret_cast<unsigned*>(&b)));
  return *reinterpret_cast<__nv_bfloat162*>(&d);
}
__device__ __forceinline__ __nv_bfloat162 add_rn(__nv_bfloat162 a, __nv_bfloat162 b) {
  unsigned d;
  asm("add.rn.bf16x2 %0, %1, %2;\n" : "=r"(d) : "r"(*reinterpret_cast<unsigned*>(&a)), "r"(*reinterpret_cast<unsigned*>(&b)));
  return *reinterpret_cast<__nv_bfloat162*>(&d);
}
__device__ __forceinline__ __nv_bfloat162 epilogue2(__nv_bfloat162 c, __nv_bfloat162 a, __nv_bfloat162 b,
                                                   bool has_res, __nv_bfloat162 r, bool relu) {
  __nv_bfloat162 y = add_rn(mul_rn(c, a), b);
  if (has_res) y = add_rn(y, r);
  if (relu) y = __hmax2(y, __float2bfloat162_rn(0.0f));
  return y;
}

union Pieces {  // 8 bf16 channels, 4 pairs: one 16-byte load or store
  uint4 v;
  unsigned w[4];
};

__device__ __forceinline__ unsigned bits(__nv_bfloat162 v) { return *reinterpret_cast<unsigned*>(&v); }
__device__ __forceinline__ __nv_bfloat162 pair(unsigned u) { return *reinterpret_cast<__nv_bfloat162*>(&u); }

// A quad's 4 x 4 transpose: lane tig's v[k] goes to lane k's v[tig]
__device__ __forceinline__ void quad_transpose(unsigned (&v)[4], int tig) {
  const bool top = tig < 2, even = (tig & 1) == 0;
  unsigned s0 = top ? v[2] : v[0], s1 = top ? v[3] : v[1];
  unsigned r0 = __shfl_xor_sync(0xffffffffu, s0, 2), r1 = __shfl_xor_sync(0xffffffffu, s1, 2);
  if (top) {
    v[2] = r0;
    v[3] = r1;
  } else {
    v[0] = r0;
    v[1] = r1;
  }
  s0 = even ? v[1] : v[0];
  s1 = even ? v[3] : v[2];
  r0 = __shfl_xor_sync(0xffffffffu, s0, 1);
  r1 = __shfl_xor_sync(0xffffffffu, s1, 1);
  if (even) {
    v[1] = r0;
    v[3] = r1;
  } else {
    v[0] = r0;
    v[2] = r1;
  }
}

// Where a warp's rows of one 64-position box (first output row q1_0) lie
// in the channels-last output and the residual: lane g's rows g and g + 8
// of the warp's 16, at `at` (their channel n0; row 0 where the row lies
// past the map, `ok` false)
struct BoxRows {
  long long at[2];
  bool ok[2];
};

__device__ __forceinline__ BoxRows box_rows(int q1_0, int o2, int b, int n0, int wq, int lane, const Plan& p) {
  BoxRows r;
  const int g = lane >> 2;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int m = wq * 16 + g + 8 * h;
    const int q1 = q1_0 + m / p.box2, q2 = o2 + m % p.box2;
    r.ok[h] = q1 < p.O1 && q2 < p.O2;
    r.at[h] = (r.ok[h] ? (((long long)b * p.O1 + q1) * p.O2 + q2) * p.M : 0) + n0;
  }
  return r;
}

// A box's residual as the epilogue reads it (N a multiple of 32): lane tig
// holds the 8 channels of group 4 jg + tig of each of its two rows, loaded
// when the tile starts, so that the loads land under the tile's products,
// where the registers allow (a quarter of the sums' again: N MS <= 128),
// else just before the epilogue
template <int N, int MS>
constexpr bool EARLY_RESIDUAL = N * MS <= 128;

template <int N>
struct Residual {
  Pieces r[(N % 32 == 0 ? N / 32 : 1)][2];
};

template <int N>
__device__ __forceinline__ void fetch_residual(Residual<N>& rv, const BoxRows& rows, int n0, int lane, const Plan& p,
                                               const __nv_bfloat16* __restrict__ res) {
  if constexpr (N % 32 == 0) {
    const int tig = lane & 3, jn = (p.M - n0) / 8;
#pragma unroll
    for (int jg = 0; jg < N / 32; ++jg)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int j = 4 * jg + tig;
        rv.r[jg][h].v = make_uint4(0, 0, 0, 0);
        if (p.has_res && rows.ok[h] && j < jn)
          rv.r[jg][h].v = *reinterpret_cast<const uint4*>(res + rows.at[h] + 8 * j);
      }
  }
}

// A warp's share of a tile's epilogue: the accumulators of one 64-position
// box. Accumulator (j, i): box position (warp % 4) * 16 + g + 8 (i / 2),
// channel n0 + 8 j + 2 tig + i % 2. The sums are rounded to bf16 pairs, and
// a quad transposes each four channel groups' pairs, so that lane tig holds
// the 8 channels of group 4 jg + tig of its row: the residual (fetched when
// the tile started), the norm's scale and shift and the output move as
// 16-byte pieces (a warp's store: 8 rows x 64 contiguous bytes), with no
// branch but the pieces' predicates. A tile of 16 channels moves its pairs
// as they are and reads its residual here.
template <int N>
__device__ __forceinline__ void store_box(const float (&acc)[N / 8][4], const BoxRows& rows, const Residual<N>& rv,
                                          int n0, int lane, const Plan& p, const __nv_bfloat16* __restrict__ scale,
                                          const __nv_bfloat16* __restrict__ shift,
                                          const __nv_bfloat16* __restrict__ res, __nv_bfloat16* __restrict__ out) {
  constexpr int J = N / 8;
  const int tig = lane & 3;
  const int jn = (p.M - n0) / 8;  // the tile's channel groups within C_out
  if constexpr (J % 4 == 0) {
#pragma unroll
    for (int jg = 0; jg < J / 4; ++jg) {
      if (4 * jg >= jn) break;  // uniform
      const int j = 4 * jg + tig;
      const bool cj = j < jn;
      Pieces a, sh;
      a.v = sh.v = make_uint4(0, 0, 0, 0);
      if (cj) {
        a.v = *reinterpret_cast<const uint4*>(scale + n0 + 8 * j);
        sh.v = *reinterpret_cast<const uint4*>(shift + n0 + 8 * j);
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        unsigned v[4];
#pragma unroll
        for (int k = 0; k < 4; ++k)
          v[k] = bits(__floats2bfloat162_rn(acc[4 * jg + k][2 * h], acc[4 * jg + k][2 * h + 1]));
        quad_transpose(v, tig);
        Pieces y;
#pragma unroll
        for (int k = 0; k < 4; ++k)
          y.w[k] = bits(epilogue2(pair(v[k]), pair(a.w[k]), pair(sh.w[k]), p.has_res, pair(rv.r[jg][h].w[k]),
                                  p.relu));
        if (rows.ok[h] && cj) *reinterpret_cast<uint4*>(out + rows.at[h] + 8 * j) = y.v;
      }
    }
  } else {
#pragma unroll
    for (int j = 0; j < J; ++j) {
      if (j >= jn) break;  // uniform
      const int co = 8 * j + 2 * tig;
      const __nv_bfloat162 av = *reinterpret_cast<const __nv_bfloat162*>(scale + n0 + co);
      const __nv_bfloat162 bv = *reinterpret_cast<const __nv_bfloat162*>(shift + n0 + co);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        __nv_bfloat162 r = __float2bfloat162_rn(0.0f);
        if (p.has_res && rows.ok[h]) r = *reinterpret_cast<const __nv_bfloat162*>(res + rows.at[h] + co);
        const __nv_bfloat162 y =
            epilogue2(__floats2bfloat162_rn(acc[j][2 * h], acc[j][2 * h + 1]), av, bv, p.has_res, r, p.relu);
        if (rows.ok[h]) *reinterpret_cast<__nv_bfloat162*>(out + rows.at[h] + co) = y;
      }
    }
  }
}

// tile t's (channel offset, first output row, first output column, sample):
// the channel tile fastest, then columns, rows, samples
__device__ __forceinline__ void tile_of(int t, const Plan& p, int N, int& n0, int& o1, int& o2, int& b) {
  n0 = (t % p.nt) * N;
  t /= p.nt;
  o2 = (t % p.pt2) * p.box2;
  t /= p.pt2;
  o1 = (t % p.pt1) * p.rows;
  b = t / p.pt1;
}

// The taps route (any window and stride): x through `xmap`, (B, S1, S2,
// C_in) bf16, boxes (bk, box2, box1, 1) with element strides (1, s2, s1,
// 1), one a warpgroup and a K step; w through `wmap`, (C_out, taps x
// C_pad) bf16, boxes (bk, N). scale, shift (C_out,) bf16; res and out
// (B, O1, O2, C_out) bf16.
template <int N>
__global__ void __launch_bounds__(CONV_THREADS, 1)
    resnet_conv_taps(const __grid_constant__ CUtensorMap wmap, const __grid_constant__ CUtensorMap xmap,
                     const __nv_bfloat16* __restrict__ scale, const __nv_bfloat16* __restrict__ shift,
                     const __nv_bfloat16* __restrict__ res, __nv_bfloat16* __restrict__ out, const Plan p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const unsigned raw = smem_u32(smem_raw);
  const unsigned base = (raw + 1023u) & ~1023u;  // the swizzle repeats every 1024 bytes
  const unsigned row = 2 * p.bk;                 // bytes of a K row
  const unsigned a_bytes = ROWS * row;           // a warpgroup's positions (a multiple of 1024)
  const unsigned b_bytes = (N * row + 1023u) & ~1023u;
  const unsigned stage_bytes = 2 * a_bytes + b_bytes;
  const unsigned full = base + p.stages * stage_bytes, empty = full + 8 * p.stages;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  if (tid == 0) {
    for (int i = 0; i < p.stages; ++i) {
      mbar_init(full + 8 * i, 1);
      mbar_init(empty + 8 * i, CONSUMER_WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int nk = p.taps * p.slices;
  int n0, o1, o2, b;

  if (warp >= CONSUMER_WARPS) {  // the producer warpgroup: one lane issues
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if (warp == CONSUMER_WARPS && lane == 0) {
      const unsigned tx = 2 * a_bytes + N * row;
      int stage = 0;
      unsigned phase = 0;
      for (int t = blockIdx.x; t < p.tiles; t += gridDim.x) {
        tile_of(t, p, N, n0, o1, o2, b);
        for (int kk = 0; kk < nk; ++kk) {
          const int tap = kk / p.slices, c0 = (kk - tap * p.slices) * p.bk;
          const int i1 = tap / p.k2, i2 = tap - i1 * p.k2;
          mbar_wait(empty + 8 * stage, phase ^ 1);
          mbar_expect_tx(full + 8 * stage, tx);
          const unsigned dst = base + stage * stage_bytes;
#pragma unroll
          for (int w = 0; w < 2; ++w)
            tma_4d(dst + w * a_bytes, &xmap, c0, o2 * p.s2 - p.p2 + i2,
                   (o1 + w * p.box1) * p.s1 - p.p1 + i1, b, full + 8 * stage);
          tma_2d(dst + 2 * a_bytes, &wmap, tap * p.cpad + c0, n0, full + 8 * stage);
          if (++stage == p.stages) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
  // the consumers: warpgroup wg computes the 64 positions of its box
  // against the tile's N channels
  const int wg = warp >> 2;
  const int nks = p.bk / 16;  // k16 products a slice
  float acc[N / 8][4];
  int stage = 0, last = 0;
  unsigned phase = 0;
  for (int t = blockIdx.x; t < p.tiles; t += gridDim.x) {
    tile_of(t, p, N, n0, o1, o2, b);
    const BoxRows rows = box_rows(o1 + wg * p.box1, o2, b, n0, warp & 3, lane, p);
    Residual<N> rv;
    if (EARLY_RESIDUAL<N, 1>) fetch_residual<N>(rv, rows, n0, lane, p, res);
    for (int kk = 0; kk < nk; ++kk) {
      mbar_wait(full + 8 * stage, phase);
      const unsigned a = base + stage * stage_bytes + wg * a_bytes;
      const unsigned bt = base + stage * stage_bytes + 2 * a_bytes;
      wgmma_fence();
      // unrolled, so that the accumulators stay in the same registers from
      // one product to the next (a uniform branch skips past the slice)
#pragma unroll
      for (int ks = 0; ks < 4; ++ks)
        if (ks < nks)  // K-major tiles of `row`-byte rows, swizzled by their row
          wgmma_bf16(acc, wgmma_desc(a + 32 * ks, 16, 8 * row, row), wgmma_desc(bt + 32 * ks, 16, 8 * row, row),
                     kk > 0 || ks > 0);
      wgmma_commit();
      wgmma_wait<1>();  // the previous slice's products are done: its stage is free
      if (kk > 0 && lane == 0) mbar_arrive(empty + 8 * last);
      last = stage;
      if (++stage == p.stages) {
        stage = 0;
        phase ^= 1;
      }
    }
    wgmma_wait<0>();
    if (lane == 0) mbar_arrive(empty + 8 * last);
    if (!EARLY_RESIDUAL<N, 1>) fetch_residual<N>(rv, rows, n0, lane, p, res);
    store_box<N>(acc, rows, rv, n0, lane, p, scale, shift, res, out);
  }
}

// The halo route (3x3, stride 1, padding 1): a block's output rows (its 2
// MS boxes stacked along O1) read their input once a K slice, as one TMA
// box of (rows + 2) x (box2 + 2) positions x bk channels through `hmap`
// (the padding as its out-of-bounds zeros), and each of the nine taps
// reads its A fragments out of that halo with `ldmatrix` at the tap's
// offset (wgmma takes A from registers); the weights come a tap and a
// slice at a time through `wmap` into a ring of stages, as in the taps
// route. Warpgroup wg owns boxes wg MS .. wg MS + MS - 1.
template <int N, int MS>
__global__ void __launch_bounds__(CONV_THREADS, 1)
    resnet_conv_halo(const __grid_constant__ CUtensorMap wmap, const __grid_constant__ CUtensorMap hmap,
                     const __nv_bfloat16* __restrict__ scale, const __nv_bfloat16* __restrict__ shift,
                     const __nv_bfloat16* __restrict__ res, __nv_bfloat16* __restrict__ out, const Plan p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const unsigned raw = smem_u32(smem_raw);
  const unsigned base = (raw + 1023u) & ~1023u;
  const unsigned row = 2 * p.bk;
  const int hw = p.box2 + 2;  // the halo's width
  const unsigned halo_tx = (unsigned)(p.rows + 2) * hw * row;
  const unsigned halo_bytes = (halo_tx + 1023u) & ~1023u;
  const unsigned b_bytes = (N * row + 1023u) & ~1023u;
  const unsigned ring = base + HALO_BUFFERS * halo_bytes;
  const unsigned hfull = ring + p.stages * b_bytes, hempty = hfull + 8 * HALO_BUFFERS;
  const unsigned bfull = hempty + 8 * HALO_BUFFERS, bempty = bfull + 8 * p.stages;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  if (tid == 0) {
    for (int i = 0; i < HALO_BUFFERS; ++i) {
      mbar_init(hfull + 8 * i, 1);
      mbar_init(hempty + 8 * i, CONSUMER_WARPS);
    }
    for (int i = 0; i < p.stages; ++i) {
      mbar_init(bfull + 8 * i, 1);
      mbar_init(bempty + 8 * i, CONSUMER_WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  int n0, o1, o2, b;

  if (warp >= CONSUMER_WARPS) {  // the producer warpgroup: one lane issues
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if (warp == CONSUMER_WARPS && lane == 0) {
      int hs = 0, stage = 0;
      unsigned hphase = 0, phase = 0;
      for (int t = blockIdx.x; t < p.tiles; t += gridDim.x) {
        tile_of(t, p, N, n0, o1, o2, b);
        for (int s = 0; s < p.slices; ++s) {
          mbar_wait(hempty + 8 * hs, hphase ^ 1);
          mbar_expect_tx(hfull + 8 * hs, halo_tx);
          tma_4d(base + hs * halo_bytes, &hmap, s * p.bk, o2 - 1, o1 - 1, b, hfull + 8 * hs);
          if (++hs == HALO_BUFFERS) {
            hs = 0;
            hphase ^= 1;
          }
          for (int tap = 0; tap < 9; ++tap) {
            mbar_wait(bempty + 8 * stage, phase ^ 1);
            mbar_expect_tx(bfull + 8 * stage, N * row);
            tma_2d(ring + stage * b_bytes, &wmap, tap * p.cpad + s * p.bk, n0, bfull + 8 * stage);
            if (++stage == p.stages) {
              stage = 0;
              phase ^= 1;
            }
          }
        }
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
  const int wg = warp >> 2, wq = warp & 3;
  const int nks = p.bk / 16;
  // this lane's ldmatrix row (box position 16 wq + lane % 16) in the halo
  // at tap (0, 0), for each of the warpgroup's boxes; lanes 16-31 read the
  // upper 8 channels of each k16 step
  const int m = wq * 16 + (lane & 15), mr = m / p.box2, mc = m - mr * p.box2;
  int h0[MS];
#pragma unroll
  for (int ms = 0; ms < MS; ++ms) h0[ms] = ((wg * MS + ms) * p.box1 + mr) * hw + mc;
  const unsigned swz = row / 16 - 1;  // the 16-byte chunks a row: the swizzle's mask
  float acc[MS][N / 8][4];
  unsigned a[2][MS][4];
  int hs = 0, stage = 0, last = -1;
  unsigned hphase = 0, phase = 0;
  for (int t = blockIdx.x; t < p.tiles; t += gridDim.x) {
    tile_of(t, p, N, n0, o1, o2, b);
    BoxRows rows[MS];
    Residual<N> rv[MS];
#pragma unroll
    for (int ms = 0; ms < MS; ++ms) {
      rows[ms] = box_rows(o1 + (wg * MS + ms) * p.box1, o2, b, n0, wq, lane, p);
      if (EARLY_RESIDUAL<N, MS>) fetch_residual<N>(rv[ms], rows[ms], n0, lane, p, res);
    }
    bool first = true;
    for (int s = 0; s < p.slices; ++s) {
      mbar_wait(hfull + 8 * hs, hphase);
      const unsigned halo = base + hs * halo_bytes;
      for (int tap = 0; tap < 9; ++tap) {
        const int shift_h = (tap / 3) * hw + tap % 3;
        mbar_wait(bfull + 8 * stage, phase);
        const unsigned bt = ring + stage * b_bytes;
#pragma unroll
        for (int ks = 0; ks < 4; ++ks) {
          if (ks >= nks) continue;  // uniform
          const unsigned q = 2 * ks + (lane >> 4);
#pragma unroll
          for (int ms = 0; ms < MS; ++ms) {
            const unsigned h = h0[ms] + shift_h;
            // a row's 16-byte chunk c lies at c ^ (the swizzle's row bits)
            ldmatrix_x4(a[ks & 1][ms], halo + h * row + ((q ^ ((h * row >> 7) & swz)) << 4));
          }
          wgmma_fence();
#pragma unroll
          for (int ms = 0; ms < MS; ++ms)
            wgmma_bf16_rs(acc[ms], a[ks & 1][ms], wgmma_desc(bt + 32 * ks, 16, 8 * row, row), !first);
          wgmma_commit();
          first = false;
          // the A registers of the step before are free once its products
          // are done; one step a tap (16-channel slices) rewrites the same
          // buffer at the next tap, so it waits for all
          if (nks == 1)
            wgmma_wait<0>();
          else
            wgmma_wait<1>();
          if (ks == 0 && last >= 0) {  // the previous tap's products are done: its stage is free
            if (lane == 0) mbar_arrive(bempty + 8 * last);
            last = -1;
          }
        }
        last = stage;
        if (++stage == p.stages) {
          stage = 0;
          phase ^= 1;
        }
      }
      // every ldmatrix of this slice's halo has returned: the buffer is free
      if (lane == 0) mbar_arrive(hempty + 8 * hs);
      if (++hs == HALO_BUFFERS) {
        hs = 0;
        hphase ^= 1;
      }
    }
    wgmma_wait<0>();
    if (last >= 0) {
      if (lane == 0) mbar_arrive(bempty + 8 * last);
      last = -1;
    }
#pragma unroll
    for (int ms = 0; ms < MS; ++ms) {
      if (!EARLY_RESIDUAL<N, MS>) fetch_residual<N>(rv[ms], rows[ms], n0, lane, p, res);
      store_box<N>(acc[ms], rows[ms], rv[ms], n0, lane, p, scale, shift, res, out);
    }
  }
}

// The ping-pong route (a 3x3 window at stride 1, one K slice: C_in <= 64,
// and up to 64 output channels): the weights of all nine taps stay in
// shared memory for the whole launch, and the two warpgroups take turns
// over the block's tiles (a tile: MS boxes stacked along O1), each with two
// to four halo buffers of its own, so that one's epilogue runs while the
// other's products do. A warpgroup's halo is its tile's rows and columns and one
// more on each side, read as one TMA box through `hmap`; each tap's A
// fragments are read out of it with `ldmatrix` as in the halo route.
template <int N, int MS>
__global__ void __launch_bounds__(CONV_THREADS, 1)
    resnet_conv_pingpong(const __grid_constant__ CUtensorMap wmap, const __grid_constant__ CUtensorMap hmap,
                         const __nv_bfloat16* __restrict__ scale, const __nv_bfloat16* __restrict__ shift,
                         const __nv_bfloat16* __restrict__ res, __nv_bfloat16* __restrict__ out, const Plan p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const unsigned raw = smem_u32(smem_raw);
  const unsigned base = (raw + 1023u) & ~1023u;
  const unsigned row = 2 * p.bk;
  const int hw = p.box2 + 2;
  const unsigned halo_tx = (unsigned)(p.rows + 2) * hw * row;
  const unsigned halo_bytes = (halo_tx + 1023u) & ~1023u;
  const unsigned b_bytes = (N * row + 1023u) & ~1023u;
  const int slots = p.stages;                 // halo buffers a warpgroup
  const unsigned halos = base + 9 * b_bytes;  // [warpgroup][slot]
  const unsigned wfull = halos + 2 * slots * halo_bytes, hfull = wfull + 8, hempty = hfull + 8 * 2 * slots;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  if (tid == 0) {
    mbar_init(wfull, 1);
    for (int i = 0; i < 2 * slots; ++i) {
      mbar_init(hfull + 8 * i, 1);
      mbar_init(hempty + 8 * i, 4);  // a warpgroup's warps
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  int n0, o1, o2, b;

  if (warp >= CONSUMER_WARPS) {  // the producer warpgroup: one lane issues
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if (warp == CONSUMER_WARPS && lane == 0) {
      mbar_expect_tx(wfull, 9 * N * row);
      for (int tap = 0; tap < 9; ++tap) tma_2d(base + tap * b_bytes, &wmap, tap * p.cpad, 0, wfull);
      // the block's k-th tile goes to warpgroup k % 2, its (k / 2)-th, in
      // its slot (k / 2) % slots, for the (k / 2 / slots)-th time
      for (int k = 0, t = blockIdx.x; t < p.tiles; ++k, t += gridDim.x) {
        tile_of(t, p, N, n0, o1, o2, b);
        const int w = k & 1, j = k >> 1, use = j / slots, slot = w * slots + (j - use * slots);
        mbar_wait(hempty + 8 * slot, (use & 1) ^ 1);
        mbar_expect_tx(hfull + 8 * slot, halo_tx);
        tma_4d(halos + slot * halo_bytes, &hmap, 0, o2 - 1, o1 - 1, b, hfull + 8 * slot);
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
  const int wg = warp >> 2, wq = warp & 3;
  const int nks = p.bk / 16;
  const int m = wq * 16 + (lane & 15), mr = m / p.box2, mc = m - mr * p.box2;
  int h0[MS];
#pragma unroll
  for (int ms = 0; ms < MS; ++ms) h0[ms] = (ms * p.box1 + mr) * hw + mc;
  const unsigned swz = row / 16 - 1;
  float acc[MS][N / 8][4];
  unsigned a[2][MS][4];
  mbar_wait(wfull, 0);
  for (int j = 0, t = blockIdx.x + wg * gridDim.x; t < p.tiles; ++j, t += 2 * gridDim.x) {
    tile_of(t, p, N, n0, o1, o2, b);
    BoxRows rows[MS];
    Residual<N> rv[MS];
#pragma unroll
    for (int ms = 0; ms < MS; ++ms) {
      rows[ms] = box_rows(o1 + ms * p.box1, o2, b, n0, wq, lane, p);
      if (EARLY_RESIDUAL<N, MS>) fetch_residual<N>(rv[ms], rows[ms], n0, lane, p, res);
    }
    const int use = j / slots, slot = wg * slots + (j - use * slots);
    mbar_wait(hfull + 8 * slot, use & 1);
    const unsigned halo = halos + slot * halo_bytes;
    for (int tap = 0; tap < 9; ++tap) {
      const int shift_h = (tap / 3) * hw + tap % 3;
      const unsigned bt = base + tap * b_bytes;
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        if (ks >= nks) continue;  // uniform
        const unsigned q = 2 * ks + (lane >> 4);
#pragma unroll
        for (int ms = 0; ms < MS; ++ms) {
          const unsigned h = h0[ms] + shift_h;
          ldmatrix_x4(a[ks & 1][ms], halo + h * row + ((q ^ ((h * row >> 7) & swz)) << 4));
        }
        wgmma_fence();
#pragma unroll
        for (int ms = 0; ms < MS; ++ms)
          wgmma_bf16_rs(acc[ms], a[ks & 1][ms], wgmma_desc(bt + 32 * ks, 16, 8 * row, row), tap > 0 || ks > 0);
        wgmma_commit();
        if (nks == 1)
          wgmma_wait<0>();
        else
          wgmma_wait<1>();
      }
    }
    // every ldmatrix of this tile's halo has returned: the slot is free
    if (lane == 0) mbar_arrive(hempty + 8 * slot);
    wgmma_wait<0>();
#pragma unroll
    for (int ms = 0; ms < MS; ++ms) {
      if (!EARLY_RESIDUAL<N, MS>) fetch_residual<N>(rv[ms], rows[ms], n0, lane, p, res);
      store_box<N>(acc[ms], rows[ms], rv[ms], n0, lane, p, scale, shift, res, out);
    }
  }
}

// The stem: x (B, S1, S2) f32 or bf16 (one input channel), a 3x3 window,
// padding 1, stride 1; w (C_out, 9) f32 holding bf16 values; out (B, S1,
// S2, C_out) bf16. A thread computes 8 channels of a run of STEM_RUN
// neighbouring positions of one row at a time (their 3 x (STEM_RUN + 2)
// inputs read once), always the same 8 channels (the grid's threads are a
// multiple of C_out / 8), so that their 72 weights and their norm stay in
// registers over its walk; the epilogue runs on bf16 pairs (`epilogue2`).
template <typename T>
__global__ void __launch_bounds__(STEM_THREADS)
    resnet_stem(const T* __restrict__ x, const float* __restrict__ w, const __nv_bfloat16* __restrict__ scale,
                const __nv_bfloat16* __restrict__ shift, __nv_bfloat16* __restrict__ out, int runs, int S1, int S2,
                int M, int relu) {
  const int groups = M / 8, runs2 = (S2 + STEM_RUN - 1) / STEM_RUN;
  const int tid = blockIdx.x * blockDim.x + threadIdx.x, stride = gridDim.x * blockDim.x;
  const int cg = tid % groups;
  float wr[8][STEM_TAPS];
  __nv_bfloat162 ar[4], br[4];
#pragma unroll
  for (int c = 0; c < 8; ++c)
#pragma unroll
    for (int k = 0; k < STEM_TAPS; ++k) wr[c][k] = w[(cg * 8 + c) * STEM_TAPS + k];
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    ar[c] = *reinterpret_cast<const __nv_bfloat162*>(scale + cg * 8 + 2 * c);
    br[c] = *reinterpret_cast<const __nv_bfloat162*>(shift + cg * 8 + 2 * c);
  }
  for (int run = tid / groups; run < runs; run += stride / groups) {
    const int r2 = run % runs2, bq1 = run / runs2, q1 = bq1 % S1, q2 = r2 * STEM_RUN;
    const T* xb = x + (long long)(bq1 - q1) * S2;  // the sample's plane
    float v[3][STEM_RUN + 2];
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int j = 0; j < STEM_RUN + 2; ++j) {
        const int t = q1 + i - 1, f = q2 + j - 1;
        v[i][j] = t >= 0 && t < S1 && f >= 0 && f < S2 ? round_bf16(xb[(long long)t * S2 + f]) : 0.0f;
      }
#pragma unroll
    for (int e = 0; e < STEM_RUN; ++e) {
      if (q2 + e >= S2) break;
      float acc[8];
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        acc[c] = 0.0f;
#pragma unroll
        for (int i = 0; i < 3; ++i)
#pragma unroll
          for (int j = 0; j < 3; ++j) acc[c] = __fmaf_rn(v[i][e + j], wr[c][3 * i + j], acc[c]);  // exact products
      }
      Pieces y;
#pragma unroll
      for (int c = 0; c < 4; ++c)
        y.w[c] = bits(epilogue2(__floats2bfloat162_rn(acc[2 * c], acc[2 * c + 1]), ar[c], br[c], false,
                                __float2bfloat162_rn(0.0f), relu));
      *reinterpret_cast<uint4*>(out + ((long long)bq1 * S2 + q2 + e) * M + cg * 8) = y.v;
    }
  }
}

CUtensorMapSwizzle swizzle_of(int row_bytes) {
  return row_bytes == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
         : row_bytes == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                           : CU_TENSOR_MAP_SWIZZLE_32B;
}

template <auto Kernel>
int launch(const CUtensorMap& wmap, const CUtensorMap& xmap, const __nv_bfloat16* scale, const __nv_bfloat16* shift,
           const __nv_bfloat16* res, __nv_bfloat16* out, const Plan& p, int grid, size_t smem, cudaStream_t s) {
  static bool ready = false;  // the attribute is the kernel's, set once
  if (!ready) {
    const cudaError_t err = cudaFuncSetAttribute(Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, 227 * 1024);
    if (err != cudaSuccess) return (int)err;
    ready = true;
  }
  Kernel<<<grid, CONV_THREADS, smem, s>>>(wmap, xmap, scale, shift, res, out, p);
  return (int)cudaGetLastError();
}

// the route's kernel (0 taps, 1 halo, 2 ping-pong): the halo routes with
// four boxes a warpgroup up to 32 channels a tile, two up to 128, one at 256
// (the accumulators' registers); the ping-pong route up to 64
template <int N>
int launch_route(int route, int ms, const CUtensorMap& wmap, const CUtensorMap& xmap,
                 const __nv_bfloat16* scale, const __nv_bfloat16* shift, const __nv_bfloat16* res, __nv_bfloat16* out, const Plan& p, int grid,
                 size_t smem, cudaStream_t s) {
  constexpr int MS = N <= 32 ? 4 : N <= 128 ? 2 : 1;
  if (route == 0) return launch<resnet_conv_taps<N>>(wmap, xmap, scale, shift, res, out, p, grid, smem, s);
  if (ms != MS) return (int)cudaErrorInvalidValue;
  if (route == 1) return launch<resnet_conv_halo<N, MS>>(wmap, xmap, scale, shift, res, out, p, grid, smem, s);
  if constexpr (N <= 64)
    return launch<resnet_conv_pingpong<N, MS>>(wmap, xmap, scale, shift, res, out, p, grid, smem, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// x (B, S1, S2, C_in) bf16 channels-last, C_in a multiple of 8, 16-byte
// aligned; w (C_out, k1 x k2 x c_pad) bf16, taps in (k1, k2) order, each
// tap's channels zero from C_in to c_pad (a multiple of 16 and of bk);
// scale, shift (C_out,) bf16, 16-byte aligned; res (B, O1, O2, C_out)
// bf16 or null; out (B, O1, O2, C_out) bf16, C_out a multiple of 8. The
// tiling (`ops/resnet_conv.py` conv_plan): tile_n (16, 32, 64, 128 or 256)
// channels a tile; box1 x box2 = 64 positions a box; route 0 (taps): one
// box a warpgroup, box1 * stride1 <= 256, box2 * stride2 <= 256; route 1
// (halo) and 2 (ping-pong), a 3x3 window at stride 1 and padding 1 only:
// ms boxes a warpgroup (4 up to 32 channels a tile, 2 up to 128, 1 at 256),
// the halo's sides at most 256; the ping-pong route takes one K slice
// (c_pad == bk) and tile_n <= 64 >= C_out. bk (16, 32 or 64) the K slice.
// sms: the persistent grid's size.
extern "C" int resnet_conv_launch(const void* x, const void* w, const void* scale, const void* shift,
                                  const void* res, void* out, int batch, int c_in, int s1_len, int s2_len,
                                  int out_channels, int o1_len, int o2_len, int k1, int k2, int stride1,
                                  int stride2, int pad1, int pad2, int c_pad, int tile_n, int box1, int box2,
                                  int bk, int route, int ms, int relu, int sms, void* stream) {
  if (batch < 1 || c_in < 8 || c_in % 8 || c_pad < c_in || c_pad % 16 || (bk != 16 && bk != 32 && bk != 64) ||
      c_pad % bk || out_channels < 8 || out_channels % 8 || o1_len < 1 || o2_len < 1 || k1 < 1 || k2 < 1 ||
      (tile_n != 16 && tile_n != 32 && tile_n != 64 && tile_n != 128 && tile_n != 256) || box1 < 1 ||
      box2 < 1 || box1 * box2 != ROWS || stride1 < 1 || stride2 < 1 || stride1 > 8 || stride2 > 8 || sms < 1 ||
      route < 0 || route > 2 || reinterpret_cast<uintptr_t>(x) % 16 || reinterpret_cast<uintptr_t>(w) % 16 ||
      reinterpret_cast<uintptr_t>(out) % 16 || reinterpret_cast<uintptr_t>(res) % 16)
    return (int)cudaErrorInvalidValue;
  const bool halo = route > 0;
  const int rows = (route == 2 ? 1 : 2) * ms * box1;  // output rows a tile
  if (halo ? (k1 != 3 || k2 != 3 || stride1 != 1 || stride2 != 1 || pad1 != 1 || pad2 != 1 ||
              ms != (tile_n <= 32 ? 4 : tile_n <= 128 ? 2 : 1) || rows + 2 > 256 || box2 + 2 > 256)
           : (ms != 1 || box1 * stride1 > 256 || box2 * stride2 > 256))
    return (int)cudaErrorInvalidValue;
  if (route == 2 && (c_pad != bk || tile_n > 64 || out_channels > tile_n)) return (int)cudaErrorInvalidValue;
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  Plan p;
  p.M = out_channels;
  p.O1 = o1_len;
  p.O2 = o2_len;
  p.cpad = c_pad;
  p.bk = bk;
  p.slices = c_pad / bk;
  p.k2 = k2;
  p.taps = k1 * k2;
  p.s1 = stride1;
  p.s2 = stride2;
  p.p1 = pad1;
  p.p2 = pad2;
  p.box1 = box1;
  p.box2 = box2;
  p.rows = rows;
  p.nt = (out_channels + tile_n - 1) / tile_n;
  p.pt1 = (o1_len + p.rows - 1) / p.rows;
  p.pt2 = (o2_len + box2 - 1) / box2;
  const long long tiles = (long long)p.nt * p.pt1 * p.pt2 * batch;
  if (tiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  p.tiles = (int)tiles;
  p.has_res = res != nullptr;
  p.relu = relu != 0;
  const unsigned row = 2 * bk;
  const unsigned b_bytes = (tile_n * row + 1023u) & ~1023u;
  // taps: stages of both warpgroups' boxes and the weights; halo: two halo
  // buffers, then stages of weights; ping-pong: the nine taps' weights, then
  // two to four halo buffers a warpgroup
  const unsigned halo_bytes = halo ? (((unsigned)(rows + 2) * (box2 + 2) * row + 1023u) & ~1023u) : 0;
  size_t smem;
  if (route == 2) {  // p.stages: halo buffers a warpgroup, as many as fit up to 4
    const long long room = (long long)RING_BYTES - 9LL * b_bytes;
    p.stages = room / (2LL * halo_bytes) < 4 ? (int)(room / (2LL * halo_bytes)) : 4;
    if (room < 0 || p.stages < 2) return (int)cudaErrorInvalidValue;
    smem = 1024 + 9 * (size_t)b_bytes + 2 * (size_t)p.stages * halo_bytes + 8 + 16 * 4;
  } else {
    const unsigned stage_bytes = halo ? b_bytes : 2 * ROWS * row + b_bytes;
    const long long room = (long long)RING_BYTES - (long long)HALO_BUFFERS * halo_bytes;
    p.stages = room / stage_bytes < MAX_STAGES ? (int)(room / stage_bytes) : MAX_STAGES;
    if (room < 0 || p.stages < 2) return (int)cudaErrorInvalidValue;
    smem = 1024 + (size_t)HALO_BUFFERS * halo_bytes + (size_t)p.stages * stage_bytes + 16 * (HALO_BUFFERS + p.stages);
  }

  CUtensorMap wmap, xmap;
  const int ktot = p.taps * c_pad;
  const cuuint64_t wdims[2] = {(cuuint64_t)ktot, (cuuint64_t)out_channels};
  const cuuint64_t wstrides[1] = {(cuuint64_t)ktot * 2};
  const cuuint32_t wbox[2] = {(cuuint32_t)bk, (cuuint32_t)tile_n};
  const cuuint32_t ones[4] = {1, 1, 1, 1};
  CUresult r = encode(&wmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(w), wdims, wstrides, wbox,
                      ones, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle_of(row), CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) return (int)cudaErrorInvalidValue;
  const cuuint64_t xdims[4] = {(cuuint64_t)c_in, (cuuint64_t)s2_len, (cuuint64_t)s1_len, (cuuint64_t)batch};
  const cuuint64_t xstrides[3] = {(cuuint64_t)c_in * 2, (cuuint64_t)s2_len * c_in * 2,
                                  (cuuint64_t)s1_len * s2_len * c_in * 2};
  // taps: a box traverses box * stride elements of an axis and loads every
  // stride-th, box elements; halo: the block's rows and columns and one
  // more on each side
  const cuuint32_t xbox[4] = {(cuuint32_t)bk, (cuuint32_t)(halo ? box2 + 2 : box2 * stride2),
                              (cuuint32_t)(halo ? rows + 2 : box1 * stride1), 1};
  const cuuint32_t xstep[4] = {1, (cuuint32_t)(halo ? 1 : stride2), (cuuint32_t)(halo ? 1 : stride1), 1};
  r = encode(&xmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(x), xdims, xstrides, xbox, xstep,
             CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle_of(row), CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) return (int)cudaErrorInvalidValue;

  const int grid = p.tiles < sms ? p.tiles : sms;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const __nv_bfloat16* fa = static_cast<const __nv_bfloat16*>(scale);
  const __nv_bfloat16* fb = static_cast<const __nv_bfloat16*>(shift);
  const __nv_bfloat16* rp = static_cast<const __nv_bfloat16*>(res);
  __nv_bfloat16* op = static_cast<__nv_bfloat16*>(out);
  switch (tile_n) {
    case 16: return launch_route<16>(route, ms, wmap, xmap, fa, fb, rp, op, p, grid, smem, s);
    case 32: return launch_route<32>(route, ms, wmap, xmap, fa, fb, rp, op, p, grid, smem, s);
    case 64: return launch_route<64>(route, ms, wmap, xmap, fa, fb, rp, op, p, grid, smem, s);
    case 128: return launch_route<128>(route, ms, wmap, xmap, fa, fb, rp, op, p, grid, smem, s);
    default: return launch_route<256>(route, ms, wmap, xmap, fa, fb, rp, op, p, grid, smem, s);
  }
}

// x (B, S1, S2) f32 (x_dtype 0) or bf16 (1), contiguous; w (C_out, 9) f32
// holding bf16 values; scale, shift (C_out,) bf16; out (B, S1, S2, C_out)
// bf16, C_out a multiple of 8, 16-byte aligned. sms: the grid's size is a
// few blocks an SM.
extern "C" int resnet_stem_launch(const void* x, int x_dtype, const void* w, const void* scale,
                                  const void* shift, void* out, int batch, int s1_len, int s2_len,
                                  int out_channels, int relu, int sms, void* stream) {
  if (batch < 1 || s1_len < 1 || s2_len < 1 || out_channels < 8 || out_channels % 8 ||
      out_channels > 8 * STEM_THREADS || (x_dtype != 0 && x_dtype != 1) || sms < 1 ||
      reinterpret_cast<uintptr_t>(out) % 16 || (long long)batch * s1_len * s2_len > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const int runs = batch * s1_len * ((s2_len + STEM_RUN - 1) / STEM_RUN), groups = out_channels / 8;
  const int threads = STEM_THREADS / groups * groups;  // a multiple of the channel groups
  const long long need = ((long long)runs * groups + threads - 1) / threads;
  const int blocks = (int)(need < 4LL * sms ? need : 4LL * sms);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* fw = static_cast<const float*>(w);
  const __nv_bfloat16* fa = static_cast<const __nv_bfloat16*>(scale);
  const __nv_bfloat16* fb = static_cast<const __nv_bfloat16*>(shift);
  __nv_bfloat16* op = static_cast<__nv_bfloat16*>(out);
  if (x_dtype == 0)
    resnet_stem<float><<<blocks, threads, 0, s>>>(static_cast<const float*>(x), fw, fa, fb, op, runs, s1_len, s2_len,
                                                   out_channels, relu);
  else
    resnet_stem<__nv_bfloat16><<<blocks, threads, 0, s>>>(static_cast<const __nv_bfloat16*>(x), fw, fa, fb, op, runs,
                                                          s1_len, s2_len, out_channels, relu);
  return (int)cudaGetLastError();
}

extern "C" const char* resnet_conv_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
