// K2 — causal online-softmax attention over a bf16 KV cache, one kernel for
// prefill, chunked prefill and decode.
//
// Replaces: krasis_tpu/ops/flash_attention.py flash_attention (_kernel) and
// decode_attention (_decode_kernel). Decode is the same function: the Sq*G
// query rows of one kv head are stacked as rows (row r is query s = r / G,
// head hkv*G + r % G) and query s sits at position q_off + s, where decode
// passes q_off = kv_len - Sq.
//
// Numerics of the reference kernels: bf16 q and k; scores in f32 from the
// bf16 dot, scaled after the dot; masked scores set to NEG_INF = -1e30 with
// the fully-masked-row guards (m_safe, alpha); p summed in f32 and rounded
// to bf16 before the PV product; the final divide guards l == 0. V is the
// first Dv lanes of the K row (MLA's [ckv; kpe] cache, v_from_k).
//
// What bounds it on the H100: for MLA prefill, operations (Sq*G rows share
// every K row, ~900 flops per cache byte); for decode, bytes (each cache
// row is read once for all G heads). Design: a CTA owns BQ = 32 stacked
// query rows of one (batch, kv head) and walks BK = 64-row kv blocks only
// up to its tile's causal and kv_len frontier. The MLA widths (D = 640,
// Dv = 512) put the f32 output tile at 64 KB, beyond registers, so Q, the
// K block, the scores, p and the output accumulator all live in shared
// memory and the eight warps run the two products as 16x16x16 bf16 tensor
// core tiles (WMMA, f32 accumulation). Decode of one sequence runs on one
// CTA and is latency-bound; split-KV is later work.
#include <mma.h>

#include "int4.cuh"

namespace {

using namespace nvcuda;

constexpr int BQ = 32;
constexpr int BK = 64;
constexpr int THREADS = 256;
constexpr float NEG_INF = -1e30f;
// Shared-memory row pitches padded off multiples of 128 bytes, so the 16
// rows of a tensor-core tile fall on different banks.
constexpr int LDS = BK + 4;   // scores, f32
constexpr int LDP = BK + 8;   // p, bf16

struct Smem {
  __nv_bfloat16* q;  // [BQ][D + 8]
  __nv_bfloat16* k;  // [BK][D + 8]
  float* s;          // [BQ][LDS]
  __nv_bfloat16* p;  // [BQ][LDP]
  float* o;          // [BQ][Dv + 4]
  float* m;          // [BQ]
  float* l;          // [BQ]
  int* pos;          // [BQ] absolute position of each row, -1 = no row
};

__host__ __device__ inline size_t smem_bytes(int D, int Dv) {
  return (size_t)BQ * (D + 8) * 2 + (size_t)BK * (D + 8) * 2 + BQ * LDS * 4 +
         BQ * LDP * 2 + (size_t)BQ * (Dv + 4) * 4 + BQ * 4 * 3;
}

__global__ void __launch_bounds__(THREADS)
attention_kernel(const __nv_bfloat16* __restrict__ q, long qsb, long qss, long qsh,
                 const __nv_bfloat16* __restrict__ kv, long ksb, long ksh, long kss,
                 __nv_bfloat16* __restrict__ out, const int* __restrict__ q_off,
                 const int* __restrict__ kv_len, float scale, int Sq, int Hq, int Hkv,
                 int S, int D, int Dv) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  Smem sm;
  unsigned char* ptr = smem_raw;
  const int LDQ = D + 8, LDO = Dv + 4;
  sm.q = (__nv_bfloat16*)ptr; ptr += (size_t)BQ * LDQ * 2;
  sm.k = (__nv_bfloat16*)ptr; ptr += (size_t)BK * LDQ * 2;
  sm.s = (float*)ptr;         ptr += BQ * LDS * 4;
  sm.p = (__nv_bfloat16*)ptr; ptr += BQ * LDP * 2;
  sm.o = (float*)ptr;         ptr += (size_t)BQ * LDO * 4;
  sm.m = (float*)ptr;         ptr += BQ * 4;
  sm.l = (float*)ptr;         ptr += BQ * 4;
  sm.pos = (int*)ptr;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int b = blockIdx.z;
  const int hk = blockIdx.y;
  const int G = Hq / Hkv;
  const int R = Sq * G;
  const int r0 = blockIdx.x * BQ;
  const int qo = q_off[b];
  const int kl = kv_len[b];
  const int D8 = D / 8;

  // Q tile: stacked rows (s, g) → head hk*G + g; rows past R are zero.
  for (int i = tid; i < BQ * D8; i += THREADS) {
    const int r = i / D8, c = (i % D8) * 8;
    const int gr = r0 + r;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (gr < R) {
      const int s = gr / G, h = hk * G + gr % G;
      v = *reinterpret_cast<const uint4*>(q + b * qsb + s * qss + h * qsh + c);
    }
    *reinterpret_cast<uint4*>(sm.q + r * LDQ + c) = v;
  }
  for (int i = tid; i < BQ * LDO; i += THREADS) sm.o[i] = 0.f;
  if (tid < BQ) {
    const int gr = r0 + tid;
    sm.pos[tid] = gr < R ? qo + gr / G : -1;
    sm.m[tid] = NEG_INF;
    sm.l[tid] = 0.f;
  }
  const int last = min(r0 + BQ, R) - 1;
  const int kv_end = min(kl, qo + last / G + 1);
  const int nblk = kv_end > 0 ? (kv_end + BK - 1) / BK : 0;
  __syncthreads();

  const __nv_bfloat16* kbase = kv + b * ksb + hk * ksh;
  for (int j = 0; j < nblk; ++j) {
    const int kb = j * BK;
    for (int i = tid; i < BK * D8; i += THREADS) {
      const int r = i / D8, c = (i % D8) * 8;
      uint4 v = make_uint4(0, 0, 0, 0);
      if (kb + r < kv_end && kb + r < S)
        v = *reinterpret_cast<const uint4*>(kbase + (long)(kb + r) * kss + c);
      *reinterpret_cast<uint4*>(sm.k + r * LDQ + c) = v;
    }
    __syncthreads();

    // scores: 2 x 4 tiles of 16x16, one per warp
    {
      const int rt = warp / (BK / 16), ct = warp % (BK / 16);
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.f);
      for (int k0 = 0; k0 < D; k0 += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> fb;
        wmma::load_matrix_sync(fa, sm.q + rt * 16 * LDQ + k0, LDQ);
        wmma::load_matrix_sync(fb, sm.k + ct * 16 * LDQ + k0, LDQ);
        wmma::mma_sync(acc, fa, fb, acc);
      }
      wmma::store_matrix_sync(sm.s + rt * 16 * LDS + ct * 16, acc, LDS, wmma::mem_row_major);
    }
    __syncthreads();

    // online softmax: 8 threads per row, 8 columns each
    {
      const int row = tid >> 3, part = tid & 7;
      const int rp = sm.pos[row];
      float v[8];
      float mx = NEG_INF;
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const int col = part * 8 + c, kp = kb + col;
        const bool ok = rp >= 0 && kp <= rp && kp < kl;
        v[c] = ok ? sm.s[row * LDS + col] * scale : NEG_INF;
        mx = fmaxf(mx, v[c]);
      }
#pragma unroll
      for (int o = 4; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_prev = sm.m[row];
      const float m_new = fmaxf(m_prev, mx);
      const float m_safe = m_new <= NEG_INF / 2 ? 0.f : m_new;
      float psum = 0.f;
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const int col = part * 8 + c, kp = kb + col;
        const bool ok = rp >= 0 && kp <= rp && kp < kl;
        const float pv = ok ? expf(v[c] - m_safe) : 0.f;
        psum += pv;
        sm.p[row * LDP + col] = __float2bfloat16(pv);
      }
#pragma unroll
      for (int o = 4; o > 0; o >>= 1) psum += __shfl_xor_sync(0xffffffffu, psum, o);
      const float alpha = m_prev <= NEG_INF / 2 ? 0.f : expf(m_prev - m_safe);
      const float l_prev = sm.l[row];
      __syncwarp();
      if (part == 0) {
        sm.l[row] = l_prev * alpha + psum;
        sm.m[row] = m_new;
      }
      for (int c = part; c < Dv; c += 8) sm.o[row * LDO + c] *= alpha;
    }
    __syncthreads();

    // O += P V with V = the first Dv lanes of the K block
    {
      const int ctn = Dv / 16;
      for (int t = warp; t < (BQ / 16) * ctn; t += THREADS / 32) {
        const int rt = t / ctn, ct = t % ctn;
        wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
        float* optr = sm.o + rt * 16 * LDO + ct * 16;
        wmma::load_matrix_sync(acc, optr, LDO, wmma::mem_row_major);
#pragma unroll
        for (int kk = 0; kk < BK; kk += 16) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa;
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> fb;
          wmma::load_matrix_sync(fa, sm.p + rt * 16 * LDP + kk, LDP);
          wmma::load_matrix_sync(fb, sm.k + kk * LDQ + ct * 16, LDQ);
          wmma::mma_sync(acc, fa, fb, acc);
        }
        wmma::store_matrix_sync(optr, acc, LDO, wmma::mem_row_major);
      }
    }
    __syncthreads();
  }

  // out[b, s, h, :] = O / l  (l == 0: fully masked row → 0)
  for (int i = tid; i < BQ * Dv; i += THREADS) {
    const int r = i / Dv, c = i % Dv;
    const int gr = r0 + r;
    if (gr < R) {
      const int s = gr / G, h = hk * G + gr % G;
      const float l = sm.l[r];
      const float den = l == 0.f ? 1.f : l;
      out[(((long)b * Sq + s) * Hq + h) * Dv + c] = __float2bfloat16(sm.o[r * LDO + c] / den);
    }
  }
}

}  // namespace

extern "C" int attention_launch(const void* q, long qsb, long qss, long qsh,
                                const void* kv, long ksb, long ksh, long kss, void* out,
                                const void* q_off, const void* kv_len, float scale,
                                int B, int Sq, int Hq, int Hkv, int S, int D, int Dv,
                                void* stream) {
  const size_t bytes = smem_bytes(D, Dv);
  cudaError_t err = cudaFuncSetAttribute(
      attention_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const int R = Sq * (Hq / Hkv);
  dim3 grid((R + BQ - 1) / BQ, Hkv, B);
  attention_kernel<<<grid, THREADS, bytes, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)q, qsb, qss, qsh, (const __nv_bfloat16*)kv, ksb, ksh, kss,
      (__nv_bfloat16*)out, (const int*)q_off, (const int*)kv_len, scale, Sq, Hq, Hkv, S,
      D, Dv);
  return (int)cudaGetLastError();
}
