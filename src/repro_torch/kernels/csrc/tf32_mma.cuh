// The 3xTF32 operand split, shared by the tensor-core kernels that keep
// f32 accuracy on tf32 products (bus_attention.cu with mma.sync,
// flash_attention_tf32.cu with wgmma).
//
// A product in 3xTF32 is hi*lo + lo*hi + hi*hi into one f32 accumulator:
// hi = tf32(x) (cvt.rna: the mantissa rounded to 10 bits, ties away from
// zero), lo = x - hi as it is, which the tensor core reads as tf32 by
// dropping its low 13 bits. It keeps f32 accuracy where one tf32 product
// (hi*hi alone) is ~1e-3 off. On sm_90 cvt.rna is emulated (about 4
// integer instructions), so a split costs 5: a kernel splits each operand
// once.
//
// Included by .cu files only; kernels/_build.py hashes every header a
// source includes with quotes, so an edit here rebuilds its users.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace tf32x3 {

__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// x = hi + lo: hi = tf32(x), and lo = x - hi as it is, which the tensor
// core reads as tf32 by dropping its low 13 bits (rounding lo as well
// would cost three more instructions and changes nothing the checks can
// see). An exact operand (from bf16 or fp16) has lo = 0.
template <bool kExact>
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  if (kExact) {
    hi = __float_as_uint(x);
    lo = 0u;
  } else {
    hi = tf32(x);
    lo = __float_as_uint(x - __uint_as_float(hi));
  }
}

}  // namespace tf32x3
