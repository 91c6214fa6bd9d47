// K5 — the bf16-activation decode MoE (w13_bf16_kernel, w2_bf16_kernel),
// in two launches:
//   stage 1: a[p, :] = bf16(act(h))  with h = x[t] · dequant(W13[e]) in f32
//   stage 2: o[p, :] = wt[p] * (a[p] · dequant(W2[e]))
// for every pick p = (token t = p / k, expert e = idx[p]); the wrapper sums
// the k picks of a token in pick order and casts to bf16.
// Replaces: krasis_tpu/ops/moe_pallas.py moe_gathered_pallas (_kernel with
// _unpack_scale). Numerics as there: each weight is dequantized in f32 and
// rounded to bf16; x is bf16; h accumulates in f32 and the activation
// (SwiGLU, or GPT-OSS's clamped form when asked: ktt::mlp_act) runs on the
// f32 h; a is rounded to bf16 before the w2 product; the f32 output is
// scaled by the routing weight and the wrapper sums the picks in f32 in
// pick order.
//
// What bounds it on the H100: bytes. Each pick reads its expert's packed
// int4 w13 and w2 once (4.46 MB per pick at V2-Lite widths) at 2
// operations per weight element. Design: a CTA owns one pick and 128 output
// columns (each lane 4 adjacent columns, so a warp reads 128 contiguous
// bytes of a weight row); its 8 warps take the rows in turn, and the warps'
// partials meet in shared memory in a fixed order, so results repeat from
// run to run. Stage 1 pairs each gate column with its up column inside the
// CTA (lanes 0-15 gate, 16-31 up) so the activation needs no second pass.
// (K3, the int8-activation form, has its own kernels: csrc/moe_w4a8.cu.)
// (K6, the one gathered product with bf16 rows, runs on K1's core: csrc/qmm.cu.)
#include "int4.cuh"

namespace {

constexpr int WARPS = 8;

// acc[i] += Σ_k x[k] * bf16(W[k][n+i] * s[k/gs][n+i]) over the rows
// k = warp, warp + WARPS, ...
__device__ __forceinline__ void bf16_dots(const __nv_bfloat16* __restrict__ x,
                                          const int8_t* __restrict__ q,
                                          const __nv_bfloat16* __restrict__ s, int bits,
                                          int K, int N, int gs, int n, int warp,
                                          float acc[4]) {
#pragma unroll 8
  for (int k = warp; k < K; k += WARPS) {
    int qv[4];
    float sv[4];
    ktt::load_w4cols(q, bits, K, N, k, n, qv);
    ktt::load_s4cols(s, N, k / gs, n, sv);
    const float xv = __bfloat162float(x[k]);
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[i] = fmaf(xv, ktt::deq_bf16(qv[i], sv[i]), acc[i]);
  }
}

__global__ void __launch_bounds__(WARPS * 32)
w13_bf16_kernel(const __nv_bfloat16* __restrict__ x, const int* __restrict__ idx,
                const int8_t* __restrict__ q13, const __nv_bfloat16* __restrict__ s13,
                __nv_bfloat16* __restrict__ a_out, int k, int H, int I, int bits, int gs,
                long q_estride, long s_estride, float limit, int gpt_oss) {
  const int p = blockIdx.x;
  const int t = p / k;
  const int e = idx[p];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n0 = blockIdx.y * 64;
  const int n = lane < 16 ? n0 + lane * 4 : I + n0 + (lane - 16) * 4;
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  bf16_dots(x + (long)t * H, q13 + e * q_estride, s13 + e * s_estride, bits, H, 2 * I,
            gs, n, warp, acc);

  __shared__ float red[WARPS][128];
#pragma unroll
  for (int i = 0; i < 4; ++i) red[warp][lane * 4 + i] = acc[i];
  __syncthreads();
  if (threadIdx.x < 64) {
    const int c = threadIdx.x;
    float g = 0.f, u = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      g += red[w][c];
      u += red[w][64 + c];
    }
    a_out[(long)p * I + n0 + c] = __float2bfloat16(ktt::mlp_act(g, u, limit, gpt_oss != 0));
  }
}

__global__ void __launch_bounds__(WARPS * 32)
w2_bf16_kernel(const __nv_bfloat16* __restrict__ a_in, const int* __restrict__ idx,
               const float* __restrict__ wt, const int8_t* __restrict__ q2,
               const __nv_bfloat16* __restrict__ s2, float* __restrict__ o_out, int H,
               int I, int bits, int gs, long q_estride, long s_estride) {
  const int p = blockIdx.x;
  const int e = idx[p];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n = blockIdx.y * 128 + lane * 4;
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  bf16_dots(a_in + (long)p * I, q2 + e * q_estride, s2 + e * s_estride, bits, I, H, gs,
            n, warp, acc);

  __shared__ float red[WARPS][128];
#pragma unroll
  for (int i = 0; i < 4; ++i) red[warp][lane * 4 + i] = acc[i];
  __syncthreads();
  if (threadIdx.x < 128) {
    const int c = threadIdx.x;
    float o = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) o += red[w][c];
    o_out[(long)p * H + blockIdx.y * 128 + c] = o * wt[p];
  }
}

}  // namespace

extern "C" int moe_w13_bf16_launch(const void* x, const void* idx, const void* q13,
                                   const void* s13, void* a_out, int P, int k, int H,
                                   int I, int bits, int gs, long q_estride,
                                   long s_estride, float limit, int gpt_oss, void* stream) {
  dim3 grid(P, I / 64);
  w13_bf16_kernel<<<grid, WARPS * 32, 0, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)x, (const int*)idx, (const int8_t*)q13,
      (const __nv_bfloat16*)s13, (__nv_bfloat16*)a_out, k, H, I, bits, gs, q_estride,
      s_estride, limit, gpt_oss);
  return (int)cudaGetLastError();
}

extern "C" int moe_w2_bf16_launch(const void* a, const void* idx, const void* wt,
                                  const void* q2, const void* s2, void* o_out, int P,
                                  int H, int I, int bits, int gs, long q_estride,
                                  long s_estride, void* stream) {
  dim3 grid(P, H / 128);
  w2_bf16_kernel<<<grid, WARPS * 32, 0, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)a, (const int*)idx, (const float*)wt, (const int8_t*)q2,
      (const __nv_bfloat16*)s2, (float*)o_out, H, I, bits, gs, q_estride, s_estride);
  return (int)cudaGetLastError();
}
