// K4 — grouped expert GEMM over expert-sorted row tiles, with two epilogues:
//   swiglu: out[r, :I] (bf16) = swiglu(bf16(x[src(r)] @ dequant(W13[e])))
//   f32:    out[r, :N] (f32)  = x[src(r)] @ dequant(W[e])
// where tile t = rows [t*TM, (t+1)*TM) all belong to expert e = tile_e[t],
// src(r) = row_src[r] gathers the token row (-1: a padding row, read as 0;
// no row_src: the rows are x's own), and tiles with tile_valid[t] == 0 are
// skipped. TM is the plan's tile height, 64 or 128.
//
// Replaces: krasis_tpu/ops/gmm_pallas.py gmm13_fused (SwiGLU epilogue) and
// gmm2_fused (f32 epilogue). Numerics as there: each expert weight is
// dequantized as bf16(f32(q) * scale), the products accumulate in f32, and
// the w13 result is rounded to bf16 before SwiGLU in f32 (or the GPT-OSS
// form: g = min(g, lim), u = clamp(u, -lim, lim), g·σ(1.702 g)·(u + 1)).
//
// What bounds it on the H100: operations at V2-Lite's shapes (~1.4e11
// flops over ~190 MB of packed experts at T = 2048), bytes where experts
// get few rows (the hybrid: 513 experts, ~40 rows each). Design:
//  * a CTA owns a TM-row tile of one expert and 128 output columns (for
//    w13: 64 gate columns and their 64 up columns, so SwiGLU is local and
//    the f32 h never reaches device memory); 8 warps as 2 x 4, each
//    TM/2 rows x 32 columns of f32 accumulators in registers;
//  * the weights stream through a 4- or 6-stage cp.async ring in steps of
//    32 packed rows with their scale rows; the loads of the next 3 or 5
//    steps are in flight while step j computes. For int4 a step uses both nibbles of each byte,
//    K rows r0.. (low) and K/2 + r0.. (high), with the matching two column
//    ranges of x and both scale rows, so every packed byte is fetched once;
//  * token rows are gathered through row_src by cp.async, 16 bytes a
//    thread, zero-filled for padding rows;
//  * dequantization happens in registers (Marlin's layout): ldmatrix.trans
//    of the packed bytes gives each thread, per 16-byte column block, the
//    k pairs (2t, 2t+1) and (2t+8, 2t+9) of columns 2g and 2g+1, which are
//    the B fragments of mma.sync m16n8k16 for two n8 tiles (the even and
//    the odd columns). Two values at a time become exact bf16 integers
//    (int4: the nibble in the low bits of bf16 128, minus 136; int8: the
//    byte in the low bits of f32 2^23, minus the bias, packed), and one
//    bf16 multiply by the scale rounds the exact product once: bf16(float(q)
//    * scale), as the reference. No bf16 weight tile goes through shared
//    memory;
//  * both epilogues read the same accumulators, so K7 + SwiGLU + K7 equals
//    K4 bit for bit.
//
// K7 — the two-stage grouped GEMM (krasis_tpu/ops/gmm_pallas.py gmm, which
// moe_prefill_pallas runs twice with SwiGLU between when one expert's block
// is too large for its fused kernels) is this kernel's f32 epilogue at both
// call shapes: w13 with gathered token rows to f32 [Mp, 2I], and w2.
//
// K7a — gmm_a8_kernel, the same tiles (TM = 64) with int8 rows
// (gmm_pallas.py gmm_a8, _gmm_kernel_a8): out[r, :] = Σ_g (xq[r, g] · W[e, g])
// * sx[r, g] * sw[g, :], the weights unpacked to int8 with no scale, one exact
// int32 dot per K-group, folded into the f32 sum at each group boundary,
// groups in order (d * sx first, then * sw, then the add, each rounded, as
// the reference writes it). Bound by bytes at int8's tensor-core peak; this
// version does not use the tensor cores: each thread keeps an 8 x 4 block of
// int32 dots with dp4a, reading the rows' 4-byte k-quads from shared memory
// by broadcast and the weights repacked k-major, 4 k values of a column in
// one word. A padding row (row_src < 0) reads as zeros and gives zeros.
#include "int4.cuh"
#include "mma.cuh"

namespace {

constexpr int TM = 64;       // K7a's tile rows
constexpr int BN = 128;
constexpr int THREADS = 256;

// gmm_kernel's ring: PK packed weight rows a step; 6 stages for 64-row
// tiles (bytes-bound: few rows an expert), 4 for 128-row ones (two CTAs of
// either fit an SM).
constexpr int PK = 32;
__host__ __device__ constexpr int stages(int tm) { return tm == 64 ? 6 : 4; }
constexpr int LDA = 72;      // bf16 pitch of an A row: 64 k values + 8
constexpr int LDB = 144;     // byte pitch of a packed weight row: 128 + 16

__host__ __device__ constexpr int stage_bytes(int tm) {
  return tm * LDA * 2 + PK * LDB + 2 * BN * 2;
}

// An exact f32 of a small integer: the bits of 2^23 + u, minus the bias.
__device__ __forceinline__ float magic(uint32_t bits, float bias) {
  return __uint_as_float(bits) - bias;
}

template <int TMR>
__global__ void __launch_bounds__(THREADS)
gmm_kernel(const __nv_bfloat16* __restrict__ x, const int* __restrict__ row_src,
           const int8_t* __restrict__ q, const __nv_bfloat16* __restrict__ s,
           const int* __restrict__ tile_e, const int* __restrict__ tile_valid,
           void* __restrict__ out, int K, int N, int bits, int gs, long q_estride,
           long s_estride, int swiglu, float limit, int gpt_oss) {
  constexpr int MI = TMR / 32;  // m16 tiles of a warp
  constexpr int NST = stages(TMR);
  const int tile = blockIdx.x;
  if (!tile_valid[tile]) return;
  extern __shared__ __align__(128) unsigned char smem[];
  const int e = tile_e[tile];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 2, wn = warp & 3;
  const int g = lane >> 2, t = lane & 3;
  const int I = N / 2;
  const bool is4 = bits == 4;
  const int rows = is4 ? K / 2 : K;  // packed weight rows
  const int khalf = K / 2;
  const int steps = rows / PK;
  // the CTA's 128 columns: swiglu, 64 gate (n0h..) then their 64 up columns
  const int n0 = swiglu ? blockIdx.y * (BN / 2) : blockIdx.y * BN;
  const int8_t* qe = q + e * q_estride;
  const __nv_bfloat16* se = s + e * s_estride;

  // A loads of this thread: CPR 16-byte chunks per row, fixed rows
  const int CPR = is4 ? 8 : 4;
  constexpr int MAXIT = TMR * 8 / THREADS;
  const __nv_bfloat16* arow[MAXIT];
  int a_r[MAXIT];
  const int a_c = tid % CPR;
#pragma unroll
  for (int it = 0; it < MAXIT; ++it) {
    const int r = (tid + it * THREADS) / CPR;
    a_r[it] = r;
    arow[it] = nullptr;
    if (r < TMR) {
      const int grow = tile * TMR + r;
      const int src = row_src ? row_src[grow] : grow;
      if (src >= 0) arow[it] = x + (long)src * K;
    }
  }
  const int a_kofs = is4 ? (a_c < 4 ? a_c * 8 : khalf + (a_c - 4) * 8) : a_c * 8;
  // B / scale loads: packed row tid / 8, 16-column chunk tid % 8
  const int b_r = tid >> 3, b_c = tid & 7;
  auto gcol = [&](int sc) { return swiglu ? (sc < 64 ? n0 + sc : I + n0 + sc - 64) : n0 + sc; };
  const int b_gc = gcol(b_c * 16);

  auto load_stage = [&](int j, int st) {
    unsigned char* base = smem + st * stage_bytes(TMR);
    __nv_bfloat16* sa = reinterpret_cast<__nv_bfloat16*>(base);
    int8_t* sb = reinterpret_cast<int8_t*>(base + TMR * LDA * 2);
    __nv_bfloat16* ss = reinterpret_cast<__nv_bfloat16*>(base + TMR * LDA * 2 + PK * LDB);
    const int p0 = j * PK;
#pragma unroll
    for (int it = 0; it < MAXIT; ++it) {
      if (a_r[it] < TMR) {
        const __nv_bfloat16* src = arow[it] ? arow[it] + p0 + a_kofs : x;
        ktt::cp_async16(sa + a_r[it] * LDA + a_c * 8, src, arow[it] != nullptr);
      }
    }
    ktt::cp_async16(sb + b_r * LDB + b_c * 16, qe + (long)(p0 + b_r) * N + b_gc, true);
    if (tid < 32) {  // scale rows: the low half's group, then the high half's
      const int h = tid >> 4, c8 = (tid & 15) * 8;
      const int grp = (h == 0 ? p0 : khalf + p0) / gs;
      const bool ok = h == 0 || is4;
      ktt::cp_async16(ss + h * BN + c8, se + (long)grp * N + gcol(c8), ok);
    }
  };

  // smem columns of this warp's two 16-column blocks
  const int cb_col[2] = {swiglu ? wn * 16 : wn * 32, swiglu ? 64 + wn * 16 : wn * 32 + 16};
  const int ld_col = (lane >> 4) ? cb_col[1] : cb_col[0];

  float acc[MI][4][4];
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int n = 0; n < 4; ++n) acc[i][n][0] = acc[i][n][1] = acc[i][n][2] = acc[i][n][3] = 0.f;

#pragma unroll
  for (int st = 0; st < NST - 1; ++st) {
    if (st < steps) load_stage(st, st);
    ktt::cp_commit();
  }
  for (int j = 0; j < steps; ++j) {
    ktt::cp_wait<NST - 2>();
    __syncthreads();
    if (j + NST - 1 < steps) load_stage(j + NST - 1, (j + NST - 1) % NST);
    ktt::cp_commit();
    const unsigned char* base = smem + (j % NST) * stage_bytes(TMR);
    const __nv_bfloat16* sa = reinterpret_cast<const __nv_bfloat16*>(base);
    const int8_t* sb = reinterpret_cast<const int8_t*>(base + TMR * LDA * 2);
    const __nv_bfloat16* ss =
        reinterpret_cast<const __nv_bfloat16*>(base + TMR * LDA * 2 + PK * LDB);
    // scales of this thread's 4 columns (block cb, parity p), both halves,
    // each as a bf16 pair for the two k rows of a fragment register
    __nv_bfloat162 sc[2][4];
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int n = 0; n < 4; ++n)
        sc[h][n] = __bfloat162bfloat162(ss[h * BN + cb_col[n >> 1] + 2 * g + (n & 1)]);
#pragma unroll
    for (int kk = 0; kk < PK; kk += 16) {
      uint32_t wr[4];
      ktt::ldsm_x4_t(wr, sb + (kk + (lane & 7) + ((lane >> 3) & 1) * 8) * LDB + ld_col);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (h == 1 && !is4) break;
        // B fragments of the 4 n8 tiles (cb, parity) for this half: the
        // bytes (p, p + 2) of a register are one column's k pair
        uint32_t bf[4][2];
#pragma unroll
        for (int n = 0; n < 4; ++n) {
#pragma unroll
          for (int q2 = 0; q2 < 2; ++q2) {
            const uint32_t w = wr[(n >> 1) * 2 + q2];
            const int p = n & 1;
            __nv_bfloat162 v;
            if (is4) {
              // (nibble ^ 8) in the low bits of bf16 128: 128 + u, minus 136
              const uint32_t m = ((w >> (8 * p + 4 * h)) & 0x000F000Fu) ^ 0x43084308u;
              v = __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&m),
                          __float2bfloat162_rn(136.f));
            } else {
              const uint32_t u = w ^ 0x80808080u;
              v = __floats2bfloat162_rn(
                  magic(__byte_perm(u, 0x4B000000u, 0x7440 | p), 8388736.f),
                  magic(__byte_perm(u, 0x4B000000u, 0x7440 | (p + 2)), 8388736.f));
            }
            // exact integers times bf16 scales, rounded once: bf16(f32(q) * s)
            v = __hmul2(v, sc[h][n]);
            bf[n][q2] = *reinterpret_cast<uint32_t*>(&v);
          }
        }
        const int acol = h * 32 + kk;
#pragma unroll
        for (int i = 0; i < MI; ++i) {
          uint32_t af[4];
          ktt::ldsm_x4(af, sa + (wm * (TMR / 2) + i * 16 + (lane & 15)) * LDA + acol +
                               (lane >> 4) * 8);
#pragma unroll
          for (int n = 0; n < 4; ++n) ktt::mma_bf16(acc[i][n], af, bf[n][0], bf[n][1]);
        }
      }
    }
  }
  ktt::cp_wait<0>();

  // Thread (g, t) holds, per m16 tile and row (g, g+8), the columns
  // cb_col[cb] + 4t .. +3 of each block: (even, odd) tiles' c0, c1 are the
  // columns +0, +2 and +1, +3.
  const long row0 = (long)tile * TMR + wm * (TMR / 2);
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long r = row0 + i * 16 + g + 8 * h;
      float v[2][4];
#pragma unroll
      for (int cb = 0; cb < 2; ++cb) {
        v[cb][0] = acc[i][2 * cb][2 * h];
        v[cb][1] = acc[i][2 * cb + 1][2 * h];
        v[cb][2] = acc[i][2 * cb][2 * h + 1];
        v[cb][3] = acc[i][2 * cb + 1][2 * h + 1];
      }
      if (swiglu) {
        uint32_t packed[2];
#pragma unroll
        for (int c = 0; c < 4; c += 2) {
          float a2[2];
#pragma unroll
          for (int k = 0; k < 2; ++k) {
            a2[k] = ktt::mlp_act(__bfloat162float(__float2bfloat16(v[0][c + k])),
                                 __bfloat162float(__float2bfloat16(v[1][c + k])), limit,
                                 gpt_oss != 0);
          }
          packed[c / 2] = ktt::pack_bf16(a2[0], a2[1]);
        }
        __nv_bfloat16* o = (__nv_bfloat16*)out;
        *reinterpret_cast<uint2*>(o + r * I + n0 + wn * 16 + 4 * t) =
            make_uint2(packed[0], packed[1]);
      } else {
        float* o = (float*)out;
#pragma unroll
        for (int cb = 0; cb < 2; ++cb)
          *reinterpret_cast<float4*>(o + r * N + n0 + cb_col[cb] + 4 * t) =
              make_float4(v[cb][0], v[cb][1], v[cb][2], v[cb][3]);
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

template <int TMR>
int gmm_launch_tm(const void* x, const void* row_src, const void* q, const void* s,
                  const void* tile_e, const void* tile_valid, void* out, int n_tiles, int K,
                  int N, int bits, int gs, long q_estride, long s_estride, int swiglu,
                  float limit, int gpt_oss, cudaStream_t stream) {
  const int bytes = stages(TMR) * stage_bytes(TMR);
  cudaError_t err = cudaFuncSetAttribute(gmm_kernel<TMR>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(n_tiles, swiglu ? (N / 2) / (BN / 2) : N / BN);
  gmm_kernel<TMR><<<grid, THREADS, bytes, stream>>>(
      (const __nv_bfloat16*)x, (const int*)row_src, (const int8_t*)q,
      (const __nv_bfloat16*)s, (const int*)tile_e, (const int*)tile_valid, out, K, N, bits,
      gs, q_estride, s_estride, swiglu, limit, gpt_oss);
  return (int)cudaGetLastError();
}

extern "C" int gmm_launch(const void* x, const void* row_src, const void* q, const void* s,
                          const void* tile_e, const void* tile_valid, void* out, int n_tiles,
                          int tm, int K, int N, int bits, int gs, long q_estride,
                          long s_estride, int swiglu, float limit, int gpt_oss,
                          void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (tm == 64)
    return gmm_launch_tm<64>(x, row_src, q, s, tile_e, tile_valid, out, n_tiles, K, N, bits,
                             gs, q_estride, s_estride, swiglu, limit, gpt_oss, st);
  if (tm == 128)
    return gmm_launch_tm<128>(x, row_src, q, s, tile_e, tile_valid, out, n_tiles, K, N, bits,
                              gs, q_estride, s_estride, swiglu, limit, gpt_oss, st);
  return (int)cudaErrorInvalidValue;
}
