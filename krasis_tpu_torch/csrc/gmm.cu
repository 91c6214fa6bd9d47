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
//
// K7 — the two-stage grouped GEMM (krasis_tpu/ops/gmm_pallas.py gmm, which
// moe_prefill_pallas runs twice with SwiGLU between when one expert's block
// is too large for its fused kernels) is this kernel's f32 epilogue at both
// call shapes: w13 with gathered token rows to f32 [Mp, 2I], and w2. The
// accumulators are the fused epilogue's, so rounding the f32 h to bf16 and
// applying SwiGLU outside gives the fused result bit for bit.
//
// K7a — gmm_a8_kernel, the same tiles with int8 rows (gmm_pallas.py gmm_a8,
// _gmm_kernel_a8): out[r, :] = Σ_g (xq[r, g] · W[e, g]) * sx[r, g] * sw[g, :],
// the weights unpacked to int8 with no scale, one exact int32 dot per
// K-group, folded into the f32 sum at each group boundary, groups in order
// (d * sx first, then * sw, then the add, each rounded, as the reference
// writes it). Bound by bytes at int8's tensor-core peak; this first version
// does not use the tensor cores: each thread keeps an 8 x 4 block of int32
// dots with dp4a, reading the rows' 4-byte k-quads from shared memory by
// broadcast and the weights repacked k-major, 4 k values of a column in one
// word. A padding row (row_src < 0) reads as zeros and gives zeros.
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

constexpr int A8_BK = 32;           // k rows per step; the group size is a multiple

__global__ void __launch_bounds__(THREADS)
gmm_a8_kernel(const int8_t* __restrict__ xq, const float* __restrict__ sx,
              const int* __restrict__ row_src, const int8_t* __restrict__ q,
              const __nv_bfloat16* __restrict__ s, const int* __restrict__ tile_e,
              const int* __restrict__ tile_valid, float* __restrict__ out, int K, int N,
              int bits, int gs, long q_estride, long s_estride) {
  const int tile = blockIdx.x;
  if (!tile_valid[tile]) return;
  const int e = tile_e[tile];
  const int tid = threadIdx.x;
  const int ty = tid >> 5, tx = tid & 31;       // 8 rows x 4 columns per thread
  const int n0 = blockIdx.y * BN;
  const int8_t* qe = q + e * q_estride;
  const __nv_bfloat16* se = s + e * s_estride;
  const int G = K / gs;

  __shared__ __align__(16) uint32_t As[TM][A8_BK / 4 + 1];   // [row][k-quad]
  __shared__ __align__(16) uint32_t Bp[A8_BK / 4][BN];        // [k-quad][column]
  __shared__ int srcs[TM];
  if (tid < TM) {
    const int grow = tile * TM + tid;
    srcs[tid] = row_src ? row_src[grow] : grow;
  }
  __syncthreads();

  // loads of this thread: one 8-byte piece of one A row, and the 4 x 4 block
  // of weights (4 k rows, 4 columns) that it repacks into 4 k-major words
  const int ar = tid >> 2, ac = (tid & 3) * 8;
  const int asrc = srcs[ar];
  const int bq = tid >> 5, bc = (tid & 31) * 4;

  int d[8][4];
  float acc[8][4];
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      d[r][c] = 0;
      acc[r][c] = 0.f;
    }

  for (int k0 = 0; k0 < K; k0 += A8_BK) {
    uint2 av = make_uint2(0u, 0u);
    if (asrc >= 0) av = *reinterpret_cast<const uint2*>(xq + (long)asrc * K + k0 + ac);
    As[ar][ac / 4] = av.x;
    As[ar][ac / 4 + 1] = av.y;
    uint32_t packed[4] = {0u, 0u, 0u, 0u};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      int w[4];
      ktt::load_w4cols(qe, bits, K, N, k0 + bq * 4 + i, n0 + bc, w);
#pragma unroll
      for (int c = 0; c < 4; ++c) packed[c] |= ((uint32_t)w[c] & 0xFFu) << (8 * i);
    }
    *reinterpret_cast<uint4*>(&Bp[bq][bc]) =
        make_uint4(packed[0], packed[1], packed[2], packed[3]);
    __syncthreads();
#pragma unroll
    for (int kq = 0; kq < A8_BK / 4; ++kq) {
      const uint4 b = *reinterpret_cast<const uint4*>(&Bp[kq][tx * 4]);
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const int a = (int)As[ty * 8 + r][kq];
        d[r][0] = __dp4a(a, (int)b.x, d[r][0]);
        d[r][1] = __dp4a(a, (int)b.y, d[r][1]);
        d[r][2] = __dp4a(a, (int)b.z, d[r][2]);
        d[r][3] = __dp4a(a, (int)b.w, d[r][3]);
      }
    }
    __syncthreads();
    if ((k0 + A8_BK) % gs == 0) {
      const int g = k0 / gs;
      float sw[4];
      ktt::load_s4cols(se, N, g, n0 + tx * 4, sw);
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const int src = srcs[ty * 8 + r];
        const float sxr = src >= 0 ? sx[(long)src * G + g] : 0.f;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          acc[r][c] = __fadd_rn(acc[r][c],
                                __fmul_rn(__fmul_rn((float)d[r][c], sxr), sw[c]));
          d[r][c] = 0;
        }
      }
    }
  }

  const long row0 = (long)tile * TM + ty * 8;
#pragma unroll
  for (int r = 0; r < 8; ++r)
    *reinterpret_cast<float4*>(out + (row0 + r) * N + n0 + tx * 4) =
        make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
}

}  // namespace

extern "C" int gmm_a8_launch(const void* xq, const void* sx, const void* row_src,
                             const void* q, const void* s, const void* tile_e,
                             const void* tile_valid, void* out, int n_tiles, int K, int N,
                             int bits, int gs, long q_estride, long s_estride,
                             void* stream) {
  dim3 grid(n_tiles, N / BN);
  gmm_a8_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const int8_t*)xq, (const float*)sx, (const int*)row_src, (const int8_t*)q,
      (const __nv_bfloat16*)s, (const int*)tile_e, (const int*)tile_valid, (float*)out, K,
      N, bits, gs, q_estride, s_estride);
  return (int)cudaGetLastError();
}

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
