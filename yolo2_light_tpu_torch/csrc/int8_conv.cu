// INT8 implicit-GEMM convolution on the tensor cores, with the reference's
// input quantize and either of its int8 epilogues fused.
//
// Replaces the Pallas kernels yolo2_light_tpu/ops/pallas_int8.py
// conv3x3_int8_fused (v1) and conv3x3_int8_tiled (v2), and extends them to
// every int8-eligible conv of a darknet net (any size, stride and pad whose
// tiles fit in shared memory: sizes 1 to 5 at strides 1 and 2). The function:
//
//   xq  = clamp(trunc(x * input_mult), +-127)      (f32 and bf16 input forms)
//   acc = sum_{ky,kx,c} xq[b, oy*s-pad+ky, ox*s-pad+kx, c] * w[m, ky, kx, c]
//         (int8 x int8, int32 accumulation, zero padding of xq)
//   "cpu" epilogue (the Pallas kernels' function):
//   q   = clamp(trunc_div(acc, 2^shift), +-32767)
//   y   = q * alpha + bias[m]                           (two roundings)
//   y   = y > 0 ? y : y / 10                            (leaky, IEEE division)
//   "gpu" epilogue (the reference's cuDNN INT8x4 flavor, -int8_policy gpu):
//   y   = float(acc) * inv + bias[m]                    (two roundings)
//   y   = y > 0 ? y : 0.1f * y                          (leaky)
//   store: f32; bf16 (round to nearest even); or int8 at out_mult,
//   clamp(trunc(y * out_mult), +-127) (the int8 residual trunk's quantize)
//   "old" epilogue (the reference's legacy all-int8 chain, -int8_policy
//   cpu_old; alpha is the layer's output_multipler, bias its biases_quant):
//   q   = clamp(trunc_div(acc, 2^shift), +-32767)
//   q   = trunc(trunc(q * alpha) + bias[m])            (each step rounded)
//   q   = q > 0 ? q : trunc(q / 10)                     (leaky)
//   store: f32 q / 16, int8 clamp(q, +-127), or both in one pass (the f32
//   one to out, the int8 one to out2): the consumer picks
//
// Layouts: x NHWC (float32 or bfloat16 for the float-input forms, int8 for
// the int8-input form that the Pallas signatures and the int8 chain use),
// w [M][ks][ks][C] int8, out NHWC in the store's type.
//
// What bounds it on an H100: at yolov3-416's shapes (b=1) the least time is
// the bytes (the f32 input read once, the weights, the f32 output written
// once: 0.5-10 us a conv at 3.35 TB/s); the int8 tensor cores need a tenth
// of that. Measured, a block takes 8-25 us from start to end, in one or two
// waves: its prologue, its first slab's copies, ldmatrix traffic (12 KB of
// shared memory a K step for 64x64 outputs) and its epilogue, not the bytes
// or the MMAs. So what counts is how many blocks share an SM (the planner
// maximises it) and that the grid covers the card. What the design does:
//
// * Output tiles of 64 pixels x 64 channels, eight warps of 32x16, each
//   K step one mma.sync m16n8k32 s8 per m16n8 tile, fragments by ldmatrix
//   (int8_mma.cuh). A 1x1/s1/p0 conv tiles the pixels flat (a plain GEMM);
//   every other conv takes an 8x8 spatial tile (4x8 where two blocks of 8x8
//   would not share an SM, as at the f32 entry's 3x3/s2 convs; their other
//   32 rows of MMAs run on zeros) whose input halo is staged once per slab
//   and read by every tap: each input element is loaded and quantized once
//   per block, not once per tap.
// * K runs in slabs of 32 channels. The weights and the halo of a slab
//   arrive by cp.async 16-byte copies (the int8 halo and the weights take
//   4-byte copies where C % 16 != 0) into a ring of 2-4 stages (the planner
//   picks the depth that lets the most blocks share an SM), up to three
//   slabs ahead; the first slabs' weight copies start before the halo table
//   is built. Out-of-image taps and ragged pixels, channels and filters are
//   zero-filled by src-size 0. Int8 rows are padded to an odd number of
//   16-byte units, so ldmatrix is free of bank conflicts. One __syncthreads
//   per slab.
// * The f32-input form stages the halo as f32 in its ring. After the
//   current slab's MMAs each thread quantizes, with quantize_pack4, the
//   16-byte chunks of the next slab that its own copies brought in (so no
//   barrier stands between the copy and the quantize) into a double buffer
//   of int8 rows: the input quantize costs no launch and no trip through
//   device memory, and the f32 loads stay as deep in flight as the weights.
//   The bf16 form does the same with 8-byte chunks of four bf16 channels,
//   upcast exactly before the quantize (the JAX package multiplies a bf16
//   map by a float32 multiplier in float32).
// * Where tiles alone give fewer than 132 blocks, the host planner
//   (ops/int8_conv.plan_launch) splits the slabs across a thread-block
//   cluster of 2-8 blocks; each block stages its int32 partial tile in shared
//   memory, and every block sums its share of the tile's rows over the
//   cluster through distributed shared memory and runs the epilogue on them.
// * The epilogue reads the int32 tile from shared memory, 16 threads per
//   pixel row (each thread's bias loaded at the start), and stores four
//   channels at once along M: 16 bytes of f32, 8 of bf16 or 4 of int8.
// * __launch_bounds__(256, 3) holds every form to 80 registers, so three
//   blocks share an SM where shared memory allows (the f32 form needed 122).
//
// Traps handled here: the epilogue and the quantize (int8_epilogue.cuh) use
// __fmul_rn/__fadd_rn/__fdiv_rn so nvcc cannot contract q*alpha+bias into an
// FMA; int32 sums are exact in any order, so the cluster split is bit-exact;
// C % 4 == 0 (4 channels per copy or per quantized word), which the Python
// wrapper checks; the launch allocates nothing and the entry point returns
// cudaGetLastError() so a refused launch is reported.
//
// The kernel's body and launcher are int8_conv.cuh's. This file builds the
// leaky and linear forms; csrc/int8_conv_mish.cu builds the mish form
// (yolov4's activation), a kernel of its own name, from the same body.

#include "int8_conv.cuh"

namespace {

template <int kIn>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
int8_conv_kernel(const ConvArgs a) {
  conv_block<kIn, kActFlag>(a);
}

const Kernel kKernels[3] = {int8_conv_kernel<kInI8>, int8_conv_kernel<kInF32>,
                            int8_conv_kernel<kInBf16>};

}  // namespace

// Launches one convolution on `stream` of CUDA device `device`. Pointers are
// device pointers to contiguous tensors: x [B,H,W,C] (x_form 0: int8, 4-byte
// aligned; 1: float32, 16-byte aligned; 2: bfloat16, 8-byte aligned),
// w [M,ks,ks,C] int8 (4-byte aligned), bias [M] f32, out [B,OH,OW,M] (store
// 0: float32, 16-byte aligned; 1: bfloat16, 8-byte aligned; 2: int8 at
// out_mult, 4-byte aligned; 3, "old" only: float32 to out, 16-byte aligned,
// and int8 to out2 [B,OH,OW,M], 4-byte aligned). semantics 0 runs the "cpu"
// requant epilogue with alpha and shift, 1 the "gpu" one with alpha = inv,
// 2 the "old" one with alpha = output_multipler and bias = biases_quant,
// which stores q / 16 as float32 and clamp(q, +-127) as int8 (stores 0, 2
// and 3; out_mult is not read). act: 0 linear, 1 leaky (the entry of
// csrc/int8_conv_mish.cu takes 2, mish). Requires C % 4 == 0 and B*H*W,
// B*OH*OW < 2^31. The launch plan comes from
// ops/int8_conv.plan_launch: tile_h x tile_w output tiles (0 x 0: flat
// 64-pixel tiles, for 1x1/s1/p0 only), `split` blocks per cluster (1-8, at
// most the number of 32-channel slabs), `stages` ring stages (2-4).
// Returns the cudaError_t of the launch (0 on success); cudaErrorInvalidValue
// for a plan whose tiles do not fit.
extern "C" int int8_conv_nhwc(const void* x, int x_form, float input_mult,
                              const void* w, const void* bias, void* out,
                              void* out2, int B, int H, int W, int C, int M,
                              int OH, int OW, int ks, int stride, int pad,
                              float alpha, int shift, int act,
                              int semantics, int store, float out_mult,
                              int tile_h, int tile_w, int split, int stages,
                              int device, void* stream) {
  return launch_conv<kActFlag>(kKernels, x, x_form, input_mult, w, bias, out,
                               out2, B, H, W, C, M, OH, OW, ks, stride, pad,
                               alpha, shift, act, semantics, store, out_mult,
                               tile_h, tile_w, split, stages, device, stream);
}
