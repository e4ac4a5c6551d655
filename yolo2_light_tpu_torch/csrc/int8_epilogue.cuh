// The int8 quantize and the three epilogues shared by the hand kernels:
// the reference's int8-"cpu" requant (forward_convolutional_layer_q,
// src/yolov2_forward_network_quantized.c:527-631), its cuDNN INT8x4
// "gpu" flavor (forward_convolutional_layer_gpu_cudnn_quantized,
// src/yolov2_forward_network_gpu.cu:143-315) and its legacy all-int8
// "old" chain (forward_convolutional_layer_q_old,
// src/yolov2_forward_network_quantized.c:636-801).
//
// Every float step is an explicitly rounded intrinsic, so nvcc cannot contract
// q*alpha+bias into an FMA: one rounding instead of two moves y by up to
// 1 ULP, and that can flip the next layer's quantization bin.

#pragma once

#include <cstdint>
#include <cuda_bf16.h>

// clamp(trunc(x * m), +-127): the C float->int cast truncates toward zero.
__device__ __forceinline__ int quantize_i8(float x, float m) {
  const float t = truncf(__fmul_rn(x, m));
  return static_cast<int>(fminf(fmaxf(t, -127.0f), 127.0f));
}

// Four channels quantized and packed into one 32-bit word, channel 0 in the
// low byte (the memory order of an int8 NHWC row read as int32).
__device__ __forceinline__ int32_t quantize_pack4(float4 v, float m) {
  const uint32_t b0 = quantize_i8(v.x, m) & 0xff;
  const uint32_t b1 = quantize_i8(v.y, m) & 0xff;
  const uint32_t b2 = quantize_i8(v.z, m) & 0xff;
  const uint32_t b3 = quantize_i8(v.w, m) & 0xff;
  return static_cast<int32_t>(b0 | b1 << 8 | b2 << 16 | b3 << 24);
}

// Four bf16 channels (8 bytes, channel 0 in the low half of .x) upcast to
// float exactly (a bf16 is the high half of the float's bits).
__device__ __forceinline__ float4 bf16x4_to_float4(uint2 v) {
  return make_float4(__uint_as_float(v.x << 16),
                     __uint_as_float(v.x & 0xffff0000u),
                     __uint_as_float(v.y << 16),
                     __uint_as_float(v.y & 0xffff0000u));
}

// A float rounded to the nearest even bf16, as its 16 bits.
__device__ __forceinline__ uint32_t bf16_bits(float y) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(y));
}

// "cpu": q = clamp(trunc_div(acc, 2^shift), +-32767); y = q * alpha + bias
// with two roundings; leaky is y > 0 ? y : y / 10 (IEEE division).
__device__ __forceinline__ float requant_epilogue(int acc, int shift,
                                                  float alpha, float bias,
                                                  bool leaky) {
  // C integer division truncates toward zero: add (2^shift - 1) to negatives
  // before the arithmetic shift.
  int q = (acc + ((acc >> 31) & ((1 << shift) - 1))) >> shift;
  q = min(max(q, -32767), 32767);
  float y = __fadd_rn(__fmul_rn(static_cast<float>(q), alpha), bias);
  if (leaky && !(y > 0.0f)) y = __fdiv_rn(y, 10.0f);
  return y;
}

// "gpu": y = float(acc) * inv + bias with two roundings, inv =
// 1 / (input_mult * weights_mult); no requant; leaky is y > 0 ? y : 0.1f * y.
__device__ __forceinline__ float gpu_epilogue(int acc, float inv, float bias,
                                              bool leaky) {
  float y = __fadd_rn(__fmul_rn(__int2float_rn(acc), inv), bias);
  if (leaky && !(y > 0.0f)) y = __fmul_rn(0.1f, y);
  return y;
}

// "old": q = clamp(trunc_div(acc, 2^shift), +-32767); q = trunc(q * mult)
// (mult: the layer's output_multipler); q = trunc(q + bias) (bias: its
// biases_quant); leaky is q > 0 ? q : trunc(q / 10) (IEEE division). Each
// step rounds on its own; the result is an integer held in a float, which
// the store writes as q / 16 (float) and/or clamp(q, +-127) (int8).
__device__ __forceinline__ float old_epilogue(int acc, int shift, float mult,
                                              float bias, bool leaky) {
  int q = (acc + ((acc >> 31) & ((1 << shift) - 1))) >> shift;
  q = min(max(q, -32767), 32767);
  float y = truncf(__fmul_rn(__int2float_rn(q), mult));
  y = truncf(__fadd_rn(y, bias));
  if (leaky && !(y > 0.0f)) y = truncf(__fdiv_rn(y, 10.0f));
  return y;
}

// mish: y * tanh(softplus(y)) as PyTorch's CUDA F.mish computes it,
// y * tanhf(log1pf(expf(y))), with the same math functions (no fast-math)
// and the product rounded once. AlexeyAB/darknet's softplus threshold of 20
// changes no float32 result (ops/int8_conv.mish_plain says why).
__device__ __forceinline__ float mish(float y) {
  return __fmul_rn(y, tanhf(log1pf(expf(y))));
}
