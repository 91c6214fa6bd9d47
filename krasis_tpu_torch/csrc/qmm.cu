// K1 — dequant-fused quantized matmul for few rows:
//   part[split, T, N] = x[T, K] (bf16) @ dequant(W)[K-range of split, N]
// with W int4 (split-half packed [K/2, N]) or int8 ([K, N]) and bf16 group
// scales [K/gs, N]. The wrapper sums the split partials.
//
// K1s, the stacked entry, is the same kernel over one layer of a
// [L, K(/2), N] stack: it is handed the base pointers of the q and scales
// stacks, their layer strides and the layer index, and offsets inside the
// kernel, so a layer is read in place and no per-layer copy exists.
//
// Replaces: krasis_tpu/ops/qmm_pallas.py qmm_pallas (_kernel_int4 and
// _kernel_int8) and qmm_stacked_pallas (_kernel_int4_st, _kernel_int8_st).
// Numerics as there: each weight is dequantized in f32,
// rounded to bf16, and multiplied by the bf16 activation with f32
// accumulation.
//
// What bounds it on the H100: bytes. At T = 1 (the lm_head [2048, 102400]
// int8 and the decode dense MLP) the kernel does 2 operations per weight
// byte, far below the ~295 operations per byte where the tensor cores
// would bind; the time is the packed weight bytes over 3.35 TB/s.
// Design: a block owns 128 output columns (each lane 4 adjacent columns,
// so a warp reads one 128-byte row segment, coalesced) and its 8 warps
// stride over the K rows; partial sums meet in shared memory. Weights are
// read exactly once; activations are warp-broadcast loads that stay in
// L1. Narrow outputs (N / 128 blocks well below the 132 SMs) split K over
// grid.z so that enough SMs pull bytes at once.
#include "int4.cuh"

namespace {

constexpr int WARPS = 8;
constexpr int COLS = 128;  // output columns per block (32 lanes x 4)
constexpr int TT = 8;      // rows of x per block

__global__ void __launch_bounds__(WARPS * 32)
qmm_kernel(const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ q,
           const __nv_bfloat16* __restrict__ s, float* __restrict__ part,
           int T, int K, int N, int bits, int gs, int k_per_split,
           long q_lstride, long s_lstride, int layer) {
  q += layer * q_lstride;
  s += layer * s_lstride;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n0 = blockIdx.x * COLS;
  const int n = n0 + lane * 4;
  const int t0 = blockIdx.y * TT;
  const int tc = min(TT, T - t0);
  const int split = blockIdx.z;
  const int kbeg = split * k_per_split;
  const int kend = min(K, kbeg + k_per_split);

  float acc[TT][4];
#pragma unroll
  for (int t = 0; t < TT; ++t)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[t][i] = 0.f;

  if (n < N) {
#pragma unroll 8
    for (int k = kbeg + warp; k < kend; k += WARPS) {
      int qv[4];
      float sv[4], w[4];
      ktt::load_w4cols(q, bits, K, N, k, n, qv);
      ktt::load_s4cols(s, N, k / gs, n, sv);
#pragma unroll
      for (int i = 0; i < 4; ++i) w[i] = ktt::deq_bf16(qv[i], sv[i]);
#pragma unroll
      for (int t = 0; t < TT; ++t) {
        if (t < tc) {
          const float xv = __bfloat162float(x[(size_t)(t0 + t) * K + k]);
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[t][i] = fmaf(xv, w[i], acc[t][i]);
        }
      }
    }
  }

  __shared__ float red[WARPS][TT][COLS];
#pragma unroll
  for (int t = 0; t < TT; ++t)
#pragma unroll
    for (int i = 0; i < 4; ++i) red[warp][t][lane * 4 + i] = acc[t][i];
  __syncthreads();
  for (int o = threadIdx.x; o < TT * COLS; o += WARPS * 32) {
    const int t = o / COLS, c = o % COLS;
    if (t < tc && n0 + c < N) {
      float sum = 0.f;
#pragma unroll
      for (int w = 0; w < WARPS; ++w) sum += red[w][t][c];
      part[((size_t)split * T + t0 + t) * N + n0 + c] = sum;
    }
  }
}

}  // namespace

// q and s are the bases of [L, K(/2), N] and [L, K/gs, N] stacks with the
// given element strides between layers; `layer` picks the one to read. A
// single [K, N] weight is the stack of one layer.
extern "C" int qmm_stacked_launch(const void* x, const void* q, const void* s, void* part,
                                  int T, int K, int N, int bits, int gs, int ksplit,
                                  long q_lstride, long s_lstride, int layer,
                                  void* stream) {
  const int k_per_split = (K + ksplit - 1) / ksplit;
  dim3 grid((N + COLS - 1) / COLS, (T + TT - 1) / TT, ksplit);
  qmm_kernel<<<grid, WARPS * 32, 0, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)x, (const int8_t*)q, (const __nv_bfloat16*)s,
      (float*)part, T, K, N, bits, gs, k_per_split, q_lstride, s_lstride, layer);
  return (int)cudaGetLastError();
}
