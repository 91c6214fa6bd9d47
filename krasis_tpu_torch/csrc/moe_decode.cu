// K3 — W4A8 gathered expert MLP for decode, in two launches:
//   stage 1: a[p, :] = swiglu(h)   with h = xq[t] · W13[e] by int8 group dots
//   stage 2: o[p, :] = wt[p] * (requant(a[p]) · W2[e])
// for every pick p = (token t = p / k, expert e = idx[p]); the wrapper sums
// the k picks of a token in pick order and casts to bf16.
//
// Replaces: krasis_tpu/ops/moe_pallas.py moe_gathered_w4a8_pallas
// (_kernel_w4a8 with _grouped_dot_i8, _unpack_int8 and quantize_activations).
// Numerics as there: activations are int8 per row and K-group with scale
// max|x|/127 clamped at 1e-8, rounded half to even and clipped to ±127;
// each int8 x int8 group dot is summed in int32, then acc += d * sx * sw in
// f32; SwiGLU runs on the f32 h with no bf16 rounding; the hidden is
// requantized from the f32 activations in stage 2.
//
// What bounds it on the H100: bytes. Each pick reads its expert's packed
// int4 w13 and w2 once (4.46 MB per pick at V2-Lite widths) for ~1 int8
// operation per weight element. Design: a CTA owns one pick and 128 output
// columns (each lane 4 adjacent columns, so a warp reads 128 contiguous
// bytes of a weight row); its 8 warps take the K-groups in turn, keep the
// group dot in int32 registers, scale it into an f32 partial, and the warps'
// partials meet in shared memory in a fixed order, so results repeat from
// run to run. Stage 1 pairs each gate column with its up column inside the
// CTA (lanes 0-15 gate, 16-31 up) so SwiGLU needs no second pass.
#include "int4.cuh"

namespace {

constexpr int WARPS = 8;

// acc[i] += Σ_groups (Σ_{k in g} xq[k] w[k][n+i]) * sx[g] * sw[g][n+i]
// over the groups g = warp, warp + WARPS, ...
__device__ __forceinline__ void group_dots(const int8_t* __restrict__ xq,
                                           const float* __restrict__ sx,
                                           const int8_t* __restrict__ q,
                                           const __nv_bfloat16* __restrict__ s, int bits,
                                           int K, int N, int gs, int n, int warp,
                                           float acc[4]) {
  const int ng = K / gs;
  for (int g = warp; g < ng; g += WARPS) {
    int d[4] = {0, 0, 0, 0};
#pragma unroll 16
    for (int k = g * gs; k < (g + 1) * gs; ++k) {
      int w[4];
      ktt::load_w4cols(q, bits, K, N, k, n, w);
      const int xv = xq[k];
#pragma unroll
      for (int i = 0; i < 4; ++i) d[i] += xv * w[i];
    }
    float sw[4];
    ktt::load_s4cols(s, N, g, n, sw);
    const float sxg = sx[g];
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[i] += (float)d[i] * sxg * sw[i];
  }
}

__global__ void __launch_bounds__(WARPS * 32)
w13_kernel(const int8_t* __restrict__ xq, const float* __restrict__ sx,
           const int* __restrict__ idx, const int8_t* __restrict__ q13,
           const __nv_bfloat16* __restrict__ s13, float* __restrict__ a_out, int k,
           int H, int I, int bits, int gs, long q_estride, long s_estride) {
  const int p = blockIdx.x;
  const int t = p / k;
  const int e = idx[p];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n0 = blockIdx.y * 64;
  const int n = lane < 16 ? n0 + lane * 4 : I + n0 + (lane - 16) * 4;
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  group_dots(xq + (long)t * H, sx + (long)t * (H / gs), q13 + e * q_estride,
             s13 + e * s_estride, bits, H, 2 * I, gs, n, warp, acc);

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
    a_out[(long)p * I + n0 + c] = g * (1.f / (1.f + expf(-g))) * u;
  }
}

__global__ void __launch_bounds__(WARPS * 32)
w2_kernel(const float* __restrict__ a_in, const int* __restrict__ idx,
          const float* __restrict__ wt, const int8_t* __restrict__ q2,
          const __nv_bfloat16* __restrict__ s2, float* __restrict__ o_out, int H, int I,
          int bits, int gs, long q_estride, long s_estride) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int ng = I / gs;
  float* sa = (float*)smem_raw;                 // [ng]
  int8_t* aq = (int8_t*)(smem_raw + ng * 4);    // [I]
  const int p = blockIdx.x;
  const int e = idx[p];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const float* a = a_in + (long)p * I;

  // per-group scale of the f32 hidden, then its int8 values
  for (int g = warp; g < ng; g += WARPS) {
    float mx = 0.f;
    for (int j = lane; j < gs; j += 32) mx = fmaxf(mx, fabsf(a[g * gs + j]));
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    const float sc = fmaxf(mx / 127.f, 1e-8f);
    if (lane == 0) sa[g] = sc;
    for (int j = lane; j < gs; j += 32) {
      const float v = rintf(a[g * gs + j] / sc);
      aq[g * gs + j] = (int8_t)fminf(fmaxf(v, -127.f), 127.f);
    }
  }
  __syncthreads();

  const int n = blockIdx.y * 128 + lane * 4;
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  group_dots(aq, sa, q2 + e * q_estride, s2 + e * s_estride, bits, I, H, gs, n, warp, acc);

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

extern "C" int moe_w13_launch(const void* xq, const void* sx, const void* idx,
                              const void* q13, const void* s13, void* a_out, int P, int k,
                              int H, int I, int bits, int gs, long q_estride,
                              long s_estride, void* stream) {
  dim3 grid(P, I / 64);
  w13_kernel<<<grid, WARPS * 32, 0, (cudaStream_t)stream>>>(
      (const int8_t*)xq, (const float*)sx, (const int*)idx, (const int8_t*)q13,
      (const __nv_bfloat16*)s13, (float*)a_out, k, H, I, bits, gs, q_estride, s_estride);
  return (int)cudaGetLastError();
}

extern "C" int moe_w2_launch(const void* a, const void* idx, const void* wt,
                             const void* q2, const void* s2, void* o_out, int P, int H,
                             int I, int bits, int gs, long q_estride, long s_estride,
                             void* stream) {
  dim3 grid(P, H / 128);
  const size_t bytes = (size_t)(I / gs) * 4 + I;
  w2_kernel<<<grid, WARPS * 32, bytes, (cudaStream_t)stream>>>(
      (const float*)a, (const int*)idx, (const float*)wt, (const int8_t*)q2,
      (const __nv_bfloat16*)s2, (float*)o_out, H, I, bits, gs, q_estride, s_estride);
  return (int)cudaGetLastError();
}
