// Shared helpers for the port's kernels: reading the repository's
// quantized weight format.
//
// A quantized weight W[K, N] is stored row-major as
//   int8:  q[K][N] bytes;
//   int4:  q[K/2][N] bytes, split-half packed: byte (r, n) holds element
//          (r, n) in its low nibble and element (r + K/2, n) in its high
//          nibble, each sign-extended with ((b & 0xF) ^ 8) - 8;
// with bf16 scales s[K/gs][N], one per (K-group, column).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace ktt {

__device__ __forceinline__ int nib_lo(uint32_t b) { return (int)((b & 0xFu) ^ 8u) - 8; }
__device__ __forceinline__ int nib_hi(uint32_t b) { return (int)(((b >> 4) & 0xFu) ^ 8u) - 8; }

// The 4 integer weights W[k][n .. n+3] (n a multiple of 4, N % 4 == 0).
__device__ __forceinline__ void load_w4cols(const int8_t* __restrict__ q, int bits,
                                            int K, int N, int k, int n, int out[4]) {
  if (bits == 8) {
    const uint32_t v = *reinterpret_cast<const uint32_t*>(q + (size_t)k * N + n);
#pragma unroll
    for (int i = 0; i < 4; ++i) out[i] = (int)(int8_t)((v >> (8 * i)) & 0xFFu);
  } else {
    const int half = K >> 1;
    const bool hi = k >= half;
    const uint32_t v = *reinterpret_cast<const uint32_t*>(
        q + (size_t)(hi ? k - half : k) * N + n);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const uint32_t b = (v >> (8 * i)) & 0xFFu;
      out[i] = hi ? nib_hi(b) : nib_lo(b);
    }
  }
}

// Scales s[g][n .. n+3] as floats.
__device__ __forceinline__ void load_s4cols(const __nv_bfloat16* __restrict__ s, int N,
                                            int g, int n, float out[4]) {
  const __nv_bfloat16* p = s + (size_t)g * N + n;
#pragma unroll
  for (int i = 0; i < 4; ++i) out[i] = __bfloat162float(p[i]);
}

// Dequantized weight as the reference rounds it: f32 product, then bf16.
__device__ __forceinline__ float deq_bf16(int q, float scale) {
  return __bfloat162float(__float2bfloat16((float)q * scale));
}

}  // namespace ktt
