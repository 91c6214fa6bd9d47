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

// Two weights of one column as a bf16 pair, dequantized as deq_bf16 does:
// from a word of 4 packed bytes b0..b3 in which (b_p, b_p+2) are one
// column's k pair (ldmatrix.trans of packed rows; p = 0 or 1), the low (h
// = 0) or high (h = 1) nibbles for int4, else the bytes. The values become
// exact bf16 integers — int4: the nibble ^ 8 in the low bits of bf16 128,
// minus 136; int8: the byte's low 7 bits in the low bits of bf16 128, minus
// 128, or 256 where its sign bit is set (bf16 256 is 128's bits with that
// bit) — and one bf16 multiply by the scale pair rounds the exact product
// once: bf16(f32(q) * scale).
template <bool IS4>
__device__ __forceinline__ uint32_t deq_pair(uint32_t w, int p, int h, __nv_bfloat162 scale) {
  __nv_bfloat162 v;
  if (IS4) {
    const uint32_t m = ((w >> (8 * p + 4 * h)) & 0x000F000Fu) ^ 0x43084308u;
    v = __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&m), __float2bfloat162_rn(136.f));
  } else {
    const uint32_t b = w >> (8 * p);
    const uint32_t m = (b & 0x007F007Fu) | 0x43004300u;
    const uint32_t base = (b & 0x00800080u) | 0x43004300u;
    v = __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&m),
                *reinterpret_cast<const __nv_bfloat162*>(&base));
  }
  v = __hmul2(v, scale);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The MLP activation on f32 gate g and up u: SwiGLU g·σ(g)·u, or with
// gpt_oss the clamped GPT-OSS form g = min(g, lim), u = clamp(u, -lim,
// lim), g·σ(1.702 g)·(u + 1). σ is 1 / (1 + e^-x) in full-precision expf,
// which gives PyTorch's sigmoid bit for bit.
__device__ __forceinline__ float mlp_act(float g, float u, float lim, bool gpt_oss) {
  if (gpt_oss) {
    g = fminf(g, lim);
    u = fminf(fmaxf(u, -lim), lim);
    return g * (1.f / (1.f + expf(-(1.702f * g)))) * (u + 1.f);
  }
  return g * (1.f / (1.f + expf(-g))) * u;
}

}  // namespace ktt
