// K4 — grouped expert GEMM over expert-sorted row tiles, with two epilogues:
//   swiglu: out[r, :I] (bf16) = swiglu(bf16(x[src(r)] @ dequant(W13[e])))
//   f32:    out[r, :N] (f32)  = x[r] @ dequant(W2[e])
// where tile t = rows [t*TM, (t+1)*TM) all belong to expert e = tile_e[t],
// src(r) = row_src[r] gathers the token row (-1: a padding row, read as 0),
// and tiles with tile_valid[t] == 0 are skipped.
//
// Replaces: krasis_tpu/ops/gmm_pallas.py gmm13_fused (SwiGLU epilogue) and
// gmm2_fused (f32 epilogue). Numerics as there: each expert weight is
// dequantized in f32 and rounded to bf16, the products accumulate in f32,
// and the w13 result is rounded to bf16 before SwiGLU in f32.
//
// What bounds it on the H100: operations. At T = 2048 and 6 picks a
// V2-Lite w13 layer is ~1.4e11 flops over ~190 MB of packed experts, far
// above the ~295 flops per byte where the tensor cores bind. Design: a CTA
// owns a 64-row tile of one expert and 128 output columns and walks K in
// steps of 32; each step gathers the tile's token rows straight from x (no
// sorted copy of x is materialised) and dequantizes the expert's 32x128
// weight block into shared memory, then the 8 warps run 16x16x16 bf16
// tensor core tiles (WMMA) into f32 accumulators held in registers. For
// w13 the CTA's columns are 64 gate columns and their 64 up columns, so the
// SwiGLU epilogue is local and the f32 h never reaches device memory.
// wgmma, TMA and a pipelined weight stream are later work.
#include <mma.h>

#include "int4.cuh"

namespace {

using namespace nvcuda;

constexpr int TM = 64;
constexpr int BN = 128;
constexpr int BK = 32;
constexpr int THREADS = 256;
constexpr int LDA = BK + 8;
constexpr int LDB = BN + 8;

__global__ void __launch_bounds__(THREADS)
gmm_kernel(const __nv_bfloat16* __restrict__ x, const int* __restrict__ row_src,
           const int8_t* __restrict__ q, const __nv_bfloat16* __restrict__ s,
           const int* __restrict__ tile_e, const int* __restrict__ tile_valid,
           void* __restrict__ out, int K, int N, int bits, int gs, long q_estride,
           long s_estride, int swiglu) {
  const int tile = blockIdx.x;
  if (!tile_valid[tile]) return;
  const int e = tile_e[tile];
  const int tid = threadIdx.x, warp = tid >> 5;
  const int I = N / 2;
  const int n0 = swiglu ? blockIdx.y * (BN / 2) : blockIdx.y * BN;
  const int8_t* qe = q + e * q_estride;
  const __nv_bfloat16* se = s + e * s_estride;

  __shared__ __align__(128) unsigned char smem[(TM * LDA + BK * LDB) * 2 + TM * BN * 4];
  __nv_bfloat16* As = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Bs = As + TM * LDA;
  float* Cs = reinterpret_cast<float*>(Bs + BK * LDB);

  // A rows this thread loads: one 16-byte chunk of one row per K step
  const int ar = tid / 4, ac = (tid % 4) * 8;
  const int grow = tile * TM + ar;
  const int src = row_src ? row_src[grow] : grow;

  const int wr = (warp / 4) * 32, wc = (warp % 4) * 32;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  for (int k0 = 0; k0 < K; k0 += BK) {
    uint4 av = make_uint4(0, 0, 0, 0);
    if (src >= 0) av = *reinterpret_cast<const uint4*>(x + (long)src * K + k0 + ac);
    *reinterpret_cast<uint4*>(As + ar * LDA + ac) = av;
#pragma unroll
    for (int it = 0; it < (BK * BN / 4) / THREADS; ++it) {
      const int i = tid + it * THREADS;
      const int kr = i / (BN / 4), lc = (i % (BN / 4)) * 4;
      const int gc = swiglu ? (lc < BN / 2 ? n0 + lc : I + n0 + lc - BN / 2) : n0 + lc;
      int w[4];
      float sc[4];
      ktt::load_w4cols(qe, bits, K, N, k0 + kr, gc, w);
      ktt::load_s4cols(se, N, (k0 + kr) / gs, gc, sc);
#pragma unroll
      for (int c = 0; c < 4; ++c)
        Bs[kr * LDB + lc + c] = __float2bfloat16((float)w[c] * sc[c]);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> fb[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(fa[i], As + (wr + 16 * i) * LDA + kk, LDA);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(fb[j], Bs + kk * LDB + wc + 16 * j, LDB);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(Cs + (wr + 16 * i) * BN + wc + 16 * j, acc[i][j], BN,
                              wmma::mem_row_major);
  __syncthreads();

  const long row0 = (long)tile * TM;
  if (swiglu) {
    __nv_bfloat16* o = (__nv_bfloat16*)out;
    for (int i = tid; i < TM * (BN / 2); i += THREADS) {
      const int r = i / (BN / 2), c = i % (BN / 2);
      const float g = __bfloat162float(__float2bfloat16(Cs[r * BN + c]));
      const float u = __bfloat162float(__float2bfloat16(Cs[r * BN + BN / 2 + c]));
      o[(row0 + r) * I + n0 + c] = __float2bfloat16(g * (1.f / (1.f + expf(-g))) * u);
    }
  } else {
    float* o = (float*)out;
    for (int i = tid; i < TM * BN; i += THREADS) {
      const int r = i / BN, c = i % BN;
      o[(row0 + r) * N + n0 + c] = Cs[i];
    }
  }
}

}  // namespace

extern "C" int gmm_launch(const void* x, const void* row_src, const void* q,
                          const void* s, const void* tile_e, const void* tile_valid,
                          void* out, int n_tiles, int K, int N, int bits, int gs,
                          long q_estride, long s_estride, int swiglu, void* stream) {
  dim3 grid(n_tiles, swiglu ? (N / 2) / (BN / 2) : N / BN);
  gmm_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)x, (const int*)row_src, (const int8_t*)q,
      (const __nv_bfloat16*)s, (const int*)tile_e, (const int*)tile_valid, out, K, N,
      bits, gs, q_estride, s_estride, swiglu);
  return (int)cudaGetLastError();
}
