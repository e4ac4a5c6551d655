// K1's mish form: the int8 implicit-GEMM convolution of csrc/int8_conv.cu
// (its design is set out there; body and launcher in int8_conv.cuh) with
// mish as its epilogue's activation, for yolov4's CSPDarknet53 convs:
//
//   y = "cpu" or "gpu" epilogue, linear (int8_epilogue.cuh)
//   y = y * tanhf(log1pf(expf(y)))      (float32, before the store)
//
// which is PyTorch's F.mish of the linear epilogue's output, computed with
// the same CUDA math functions (built without fast-math: expf, log1pf and
// tanhf are the library's accurate versions), so the kernel is bit-identical
// to its plain twin (ops/int8_conv.conv2d_int8_f32_plain with activation
// "mish"). Without it, every mish conv would store its linear output and a
// second pass would read and rewrite the map: 44.4 M float32 elements an
// image at yolov4-416, at least 355 MB of traffic.
//
// Only the float32-input form is built, storing float32 under the "cpu" or
// "gpu" epilogue: the form the network's int8 path runs. Its kernel is named
// int8_conv_mish_kernel, so the device trace tells it from the leaky and
// linear forms (int8_conv_kernel).

#include "int8_conv.cuh"

namespace {

template <int kIn>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
int8_conv_mish_kernel(const ConvArgs a) {
  conv_block<kIn, kActMish>(a);
}

const Kernel kKernels[3] = {nullptr, int8_conv_mish_kernel<kInF32>, nullptr};

}  // namespace

// int8_conv_nhwc (csrc/int8_conv.cu) with act 2 (mish), x_form 1 (float32)
// and store 0 (float32) under semantics 0 or 1; anything else returns
// cudaErrorInvalidValue.
extern "C" int int8_conv_mish_nhwc(const void* x, int x_form,
                                   float input_mult, const void* w,
                                   const void* bias, void* out, void* out2,
                                   int B, int H, int W, int C, int M, int OH,
                                   int OW, int ks, int stride, int pad,
                                   float alpha, int shift, int act,
                                   int semantics, int store, float out_mult,
                                   int tile_h, int tile_w, int split,
                                   int stages, int device, void* stream) {
  return launch_conv<kActMish>(kKernels, x, x_form, input_mult, w, bias, out,
                               out2, B, H, W, C, M, OH, OW, ks, stride, pad,
                               alpha, shift, act, semantics, store, out_mult,
                               tile_h, tile_w, split, stages, device, stream);
}
