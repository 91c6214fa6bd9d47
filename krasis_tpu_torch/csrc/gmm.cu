// K4 — grouped expert GEMM over expert-sorted row tiles, with two epilogues:
//   swiglu: out[r, :I] (bf16) = swiglu(bf16(x[src(r)] @ dequant(W13[e])))
//   f32:    out[r, :N] (f32)  = x[src(r)] @ dequant(W[e])
// where tile t = rows [t*TM, (t+1)*TM) all belong to expert e = tile_e[t],
// src(r) = row_src[r] gathers the token row (-1: a padding row, read as 0;
// no row_src: the rows are x's own), and tiles with tile_valid[t] == 0 are
// skipped. N is a whole number of CTAs for swiglu; for f32 a multiple of 64
// whose last CTA may be partial (the TAIL instances, GPT-OSS's w2 of 2880
// columns). TM is the plan's tile height: 64 or 128 on the main path (the
// port's choose_tm), 256 or 512 where moe_prefill(tile_rows=...) asks. The
// summation order over K does not depend on TM: every output element is
// the same sequence of mma.sync products at any height, so the four
// heights give the same rows bit for bit.
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
//    TM/2 rows x 32 columns of f32 accumulators in registers. At 512 rows a
//    CTA owns 64 columns as 4 x 2 warps, so a warp still holds 128 rows x
//    32 columns (128 accumulator registers a thread);
//  * the weights stream through a cp.async ring (6 stages at 64 rows, 4 at
//    128 and 256, 3 at 512) in steps of 32 packed rows with their scale
//    rows; the loads of the next steps are in flight while step j
//    computes. For int4 a step uses both nibbles of each byte, K rows r0..
//    (low) and K/2 + r0.. (high), with the matching two column ranges of x
//    and both scale rows, so every packed byte is fetched once. Groups of
//    16 rows (FULL16) stage a scale row for each 16-row half of a step;
//  * token rows are gathered through row_src by cp.async, 16 bytes a
//    thread, zero-filled for padding rows (256 and 512 rows: the tile's
//    source rows sit in shared memory, not in registers);
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
// The probe forms (enum Mode below; krasis_tpu_torch/probes) are
// compile-time variants of this kernel that split one step into terms
// (benchmarks/probe_gmm_terms.py gmm_mode: copy, nounpack, unpackonly;
// its full term is K7 itself) or unpack by shifts
// (benchmarks/probe_unpack_variants.py gmm_v2).
//
// K7 — the two-stage grouped GEMM (krasis_tpu/ops/gmm_pallas.py gmm, which
// moe_prefill_pallas runs twice with SwiGLU between when one expert's block
// is too large for its fused kernels) is this kernel's f32 epilogue at both
// call shapes: w13 with gathered token rows to f32 [Mp, 2I], and w2. The
// same two launches carry the reference's plain ragged form
// (krasis_tpu/ops/moe.py moe_forward_ragged: biased experts, GPT-OSS's
// prefill), the biases added between them in PyTorch. Its widths need not be
// whole CTAs: the f32 epilogue takes N % 64 == 0 (GPT-OSS's w2 is 2880 = 22.5
// CTAs of 128 columns) through the TAIL instances, whose last column CTA reads
// no weight or scale byte and writes no output at a column >= N.
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

// What one launch of gmm_kernel computes. FULL is K4 / K7; FULL16 is the
// same for scale groups that are not a multiple of a step's 32 rows (a
// multiple of 16: each 16-row half of a step has a scale row of its own).
// The others are the probe forms of krasis_tpu_torch/probes (f32 epilogue):
// each streams the same bytes through the same ring and does only its named
// part of the step.
//   COPY:       out[r, n] = x[src(r), n mod tn]           (the ring alone)
//   NOUNPACK:   out = x @ S, S[k, n] = s[k / gs, n]       (the ring and the product)
//   UNPACKONLY: out[r, n] = dequant(W[e])[r, n], r < TM   (the ring and the dequantization)
//   V2:         K7's function, each nibble sign-extended by two shifts and
//               converted, then the bf16 scale product
// COPY and UNPACKONLY fold the inputs of the work they skip into a
// checksum that reaches `sink` only when a caller passes one, so the
// compiler keeps the loads and the dequantization.
enum Mode { FULL = 0, COPY = 1, NOUNPACK = 2, UNPACKONLY = 3, V2 = 4, FULL16 = 5 };

// gmm_kernel's ring: PK packed weight rows a step; 6 stages for 64-row
// tiles (bytes-bound: few rows an expert), 4 for 128- and 256-row ones, 3
// for 512 (227 KB: one CTA of 256 or 512 rows an SM).
constexpr int PK = 32;
// A CTA's columns: 128 as 2 x 4 warps up to 256 rows (a warp TM/2 rows x 32
// columns); 64 as 4 x 2 warps at 512 rows, so that a warp still holds 128
// rows x 32 columns of f32 accumulators (128 registers a thread). With TAIL
// the last CTA may own fewer live columns (N % 64 == 0, so at up to 256 rows
// 64 of its 128): its loads past N are zero-filled and its warps whose 32
// columns lie past N compute zeros and store nothing.
__host__ __device__ constexpr int cta_cols(int tm) { return tm == 512 ? 64 : 128; }
__host__ __device__ constexpr int stages(int tm) { return tm == 64 ? 6 : tm == 512 ? 3 : 4; }
constexpr int LDA = 72;      // bf16 pitch of an A row: 64 k values + 8
// byte pitch of a packed weight row: the CTA's columns + 16
__host__ __device__ constexpr int ldb(int tm) { return cta_cols(tm) + 16; }

// scale rows a stage: the low and the high half's, per 16 rows with FULL16
__host__ __device__ constexpr int scale_rows(int mode) { return mode == FULL16 ? 4 : 2; }
__host__ __device__ constexpr int stage_bytes(int tm, int mode) {
  return tm * LDA * 2 + PK * ldb(tm) + scale_rows(mode) * cta_cols(tm) * 2;
}
// the ring, and for 256- and 512-row tiles the tile's source rows after it
// (FULL16 at 512 rows: 227 KB exactly)
__host__ __device__ constexpr int smem_bytes(int tm, int mode) {
  return stages(tm) * stage_bytes(tm, mode) + (tm >= 256 ? tm * 4 : 0);
}

// An exact f32 of a small integer: the bits of 2^23 + u, minus the bias.
__device__ __forceinline__ float magic(uint32_t bits, float bias) {
  return __uint_as_float(bits) - bias;
}

template <int TMR, int MODE, bool TAIL = false>
__global__ void __launch_bounds__(THREADS)
gmm_kernel(const __nv_bfloat16* __restrict__ x, const int* __restrict__ row_src,
           const int8_t* __restrict__ q, const __nv_bfloat16* __restrict__ s,
           const int* __restrict__ tile_e, const int* __restrict__ tile_valid,
           void* __restrict__ out, int K, int N, int bits, int gs, long q_estride,
           long s_estride, int swiglu, float limit, int gpt_oss, int tn,
           unsigned* __restrict__ sink) {
  constexpr int BNC = cta_cols(TMR);
  constexpr int WN = BNC / 32;      // warps along the columns
  constexpr int WM = 8 / WN;        // and along the rows
  constexpr int MI = TMR / WM / 16;  // m16 tiles of a warp
  constexpr int NST = stages(TMR);
  constexpr int LDB = ldb(TMR);
  constexpr int SB = stage_bytes(TMR, MODE);
  constexpr bool G16 = MODE == FULL16;
  constexpr bool BIG = TMR >= 256;   // source rows from shared memory, not registers
  const int tile = blockIdx.x;
  if (!tile_valid[tile]) return;
  extern __shared__ __align__(128) unsigned char smem[];
  const int e = tile_e[tile];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> (WN == 4 ? 2 : 1), wn = warp & (WN - 1);
  const int g = lane >> 2, t = lane & 3;
  const int I = N / 2;
  const bool is4 = bits == 4;
  const int rows = is4 ? K / 2 : K;  // packed weight rows
  const int khalf = K / 2;
  const int steps = rows / PK;
  // the CTA's columns: swiglu, BNC/2 gate (n0..) then their BNC/2 up columns
  const int n0 = swiglu ? blockIdx.y * (BNC / 2) : blockIdx.y * BNC;
  const int8_t* qe = q + e * q_estride;
  const __nv_bfloat16* se = s + e * s_estride;

  // A loads of this thread: CPR 16-byte chunks per row, fixed rows
  const int CPR = is4 ? 8 : 4;
  constexpr int MAXIT = TMR * 8 / THREADS;
  const __nv_bfloat16* arow[BIG ? 1 : MAXIT];
  int a_r[BIG ? 1 : MAXIT];
  const int a_c = tid % CPR;
  int* srow = reinterpret_cast<int*>(smem + NST * SB);
  if constexpr (BIG) {
    for (int r = tid; r < TMR; r += THREADS) {
      const int grow = tile * TMR + r;
      srow[r] = row_src ? row_src[grow] : grow;
    }
    __syncthreads();
  } else {
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
  }
  const int a_kofs = is4 ? (a_c < 4 ? a_c * 8 : khalf + (a_c - 4) * 8) : a_c * 8;
  // B / scale loads: packed row tid / (BNC/16), 16-column chunk tid % (BNC/16)
  constexpr int BCH = BNC / 16;
  const int b_r = tid >> (BCH == 8 ? 3 : 2), b_c = tid & (BCH - 1);
  auto gcol = [&](int sc) {
    return swiglu ? (sc < BNC / 2 ? n0 + sc : I + n0 + sc - BNC / 2) : n0 + sc;
  };
  const int b_gc = gcol(b_c * 16);
  // TAIL (f32 epilogue): a column at or past N is not read
  auto live = [&](int col) { return !TAIL || col < N; };

  auto load_stage = [&](int j, int st) {
    unsigned char* base = smem + st * SB;
    __nv_bfloat16* sa = reinterpret_cast<__nv_bfloat16*>(base);
    int8_t* sb = reinterpret_cast<int8_t*>(base + TMR * LDA * 2);
    __nv_bfloat16* ss = reinterpret_cast<__nv_bfloat16*>(base + TMR * LDA * 2 + PK * LDB);
    const int p0 = j * PK;
    if constexpr (BIG) {
#pragma unroll
      for (int it = 0; it < MAXIT; ++it) {
        const int r = (tid + it * THREADS) / CPR;
        if (r < TMR) {
          const int src = srow[r];
          const __nv_bfloat16* p = src >= 0 ? x + (long)src * K + p0 + a_kofs : x;
          ktt::cp_async16(sa + r * LDA + a_c * 8, p, src >= 0);
        }
      }
    } else {
#pragma unroll
      for (int it = 0; it < MAXIT; ++it) {
        if (a_r[it] < TMR) {
          const __nv_bfloat16* src = arow[it] ? arow[it] + p0 + a_kofs : x;
          ktt::cp_async16(sa + a_r[it] * LDA + a_c * 8, src, arow[it] != nullptr);
        }
      }
    }
    if constexpr (TAIL) {
      const bool b_live = live(b_gc);
      if (PK * BCH == THREADS || tid < PK * BCH)
        ktt::cp_async16(sb + b_r * LDB + b_c * 16,
                        b_live ? qe + (long)(p0 + b_r) * N + b_gc : qe, b_live);
    } else if constexpr (PK * BCH == THREADS)
      ktt::cp_async16(sb + b_r * LDB + b_c * 16, qe + (long)(p0 + b_r) * N + b_gc, true);
    else if (tid < PK * BCH)
      ktt::cp_async16(sb + b_r * LDB + b_c * 16, qe + (long)(p0 + b_r) * N + b_gc, true);
    if constexpr (G16) {  // scale rows (16-row half, half of K): row 2 * sub + h
      if (tid < 4 * (BNC / 8)) {
        const int r4 = tid >> (BNC == 128 ? 4 : 3), c8 = (tid & (BNC / 8 - 1)) * 8;
        const int h = r4 & 1;
        const int grp = ((h == 0 ? p0 : khalf + p0) + 16 * (r4 >> 1)) / gs;
        if constexpr (TAIL) {
          const bool ok = (h == 0 || is4) && live(n0 + c8);
          ktt::cp_async16(ss + r4 * BNC + c8, ok ? se + (long)grp * N + gcol(c8) : se, ok);
        } else {
          ktt::cp_async16(ss + r4 * BNC + c8, se + (long)grp * N + gcol(c8), h == 0 || is4);
        }
      }
    } else if (tid < 2 * (BNC / 8)) {  // scale rows: the low half's group, then the high half's
      const int h = tid >> (BNC == 128 ? 4 : 3), c8 = (tid & (BNC / 8 - 1)) * 8;
      const int grp = (h == 0 ? p0 : khalf + p0) / gs;
      if constexpr (TAIL) {
        const bool ok = (h == 0 || is4) && live(n0 + c8);
        ktt::cp_async16(ss + h * BNC + c8, ok ? se + (long)grp * N + gcol(c8) : se, ok);
      } else {
        const bool ok = h == 0 || is4;
        ktt::cp_async16(ss + h * BNC + c8, se + (long)grp * N + gcol(c8), ok);
      }
    }
  };

  // smem columns of this warp's two 16-column blocks
  const int cb_col[2] = {swiglu ? wn * 16 : wn * 32,
                         swiglu ? BNC / 2 + wn * 16 : wn * 32 + 16};
  const int ld_col = (lane >> 4) ? cb_col[1] : cb_col[0];

  float acc[MI][4][4];
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int n = 0; n < 4; ++n) acc[i][n][0] = acc[i][n][1] = acc[i][n][2] = acc[i][n][3] = 0.f;
  unsigned chk = 0;  // COPY, UNPACKONLY: the folded inputs of the skipped work

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
    const unsigned char* base = smem + (j % NST) * SB;
    const __nv_bfloat16* sa = reinterpret_cast<const __nv_bfloat16*>(base);
    const int8_t* sb = reinterpret_cast<const int8_t*>(base + TMR * LDA * 2);
    const __nv_bfloat16* ss =
        reinterpret_cast<const __nv_bfloat16*>(base + TMR * LDA * 2 + PK * LDB);
    if constexpr (MODE == COPY) {
      chk ^= reinterpret_cast<const unsigned*>(base)[tid * 4] ^
             *reinterpret_cast<const unsigned*>(sb + (b_r % PK) * LDB + b_c * 16);
      continue;
    }
    // scales of this thread's 4 columns (block cb, parity p), both halves,
    // each as a bf16 pair for the two k rows of a fragment register: those
    // of the step's rows r0 (FULL16: of its 16 rows from r0)
    __nv_bfloat162 sc[2][4];
    auto load_scales = [&](int r0) {
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int n = 0; n < 4; ++n)
          sc[h][n] =
              __bfloat162bfloat162(ss[(r0 + h) * BNC + cb_col[n >> 1] + 2 * g + (n & 1)]);
    };
    if constexpr (!G16) load_scales(0);
#pragma unroll
    for (int kk = 0; kk < PK; kk += 16) {
      if constexpr (G16) load_scales(kk / 8);
      uint32_t wr[4];
      if constexpr (MODE != NOUNPACK)
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
            if constexpr (MODE == NOUNPACK) {
              // the scale itself: S[k, n] = s[k / gs, n]
              bf[n][q2] = *reinterpret_cast<const uint32_t*>(&sc[h][n]);
            } else {
              const uint32_t w = wr[(n >> 1) * 2 + q2];
              const int p = n & 1;
              __nv_bfloat162 v;
              if constexpr (MODE == V2) {
                // sign-extended by two shifts, converted, exact
                int lo, hi;
                if (is4) {
                  lo = (int)(w << (28 - 8 * p - 4 * h)) >> 28;
                  hi = (int)(w << (12 - 8 * p - 4 * h)) >> 28;
                } else {
                  lo = (int)(w << (24 - 8 * p)) >> 24;
                  hi = (int)(w << (8 - 8 * p)) >> 24;
                }
                v = __floats2bfloat162_rn((float)lo, (float)hi);
              } else if (is4) {
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
        }
        if constexpr (MODE == UNPACKONLY) {
          // the dequantized rows k < TM of the tile's expert, written by the
          // first row of warps (the others hold the same values)
          const int kb = (h == 0 ? j * PK : khalf + j * PK) + kk;
#pragma unroll
          for (int n = 0; n < 4; ++n)
#pragma unroll
            for (int q2 = 0; q2 < 2; ++q2) chk ^= bf[n][q2];
          if (wm == 0 && kb < TMR) {
            float* o = (float*)out;
#pragma unroll
            for (int n = 0; n < 4; ++n)
#pragma unroll
              for (int q2 = 0; q2 < 2; ++q2) {
                const long r = (long)tile * TMR + kb + 2 * t + 8 * q2;
                const int col = n0 + cb_col[n >> 1] + 2 * g + (n & 1);
                const float2 f = __bfloat1622float2(
                    *reinterpret_cast<const __nv_bfloat162*>(&bf[n][q2]));
                o[r * N + col] = f.x;
                o[(r + 1) * N + col] = f.y;
              }
          }
          continue;
        }
        const int acol = h * 32 + kk;
#pragma unroll
        for (int i = 0; i < MI; ++i) {
          uint32_t af[4];
          ktt::ldsm_x4(af, sa + (wm * (TMR / WM) + i * 16 + (lane & 15)) * LDA + acol +
                               (lane >> 4) * 8);
#pragma unroll
          for (int n = 0; n < 4; ++n) ktt::mma_bf16(acc[i][n], af, bf[n][0], bf[n][1]);
        }
      }
    }
  }
  ktt::cp_wait<0>();

  if constexpr (MODE == COPY || MODE == UNPACKONLY) {
    if constexpr (MODE == COPY) {
      float* o = (float*)out;
      for (int idx = tid; idx < TMR * BNC; idx += THREADS) {
        const long r = (long)tile * TMR + idx / BNC;
        const int col = n0 + idx % BNC;
        const int src = row_src ? row_src[r] : (int)r;
        o[r * N + col] = src >= 0 ? __bfloat162float(x[(long)src * K + col % tn]) : 0.f;
      }
    }
    if (sink != nullptr) atomicXor(sink, chk);
    return;
  }

  // Thread (g, t) holds, per m16 tile and row (g, g+8), the columns
  // cb_col[cb] + 4t .. +3 of each block: (even, odd) tiles' c0, c1 are the
  // columns +0, +2 and +1, +3.
  const long row0 = (long)tile * TMR + wm * (TMR / WM);
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
        for (int cb = 0; cb < 2; ++cb) {
          if constexpr (TAIL)
            if (!live(n0 + cb_col[cb])) continue;
          *reinterpret_cast<float4*>(o + r * N + n0 + cb_col[cb] + 4 * t) =
              make_float4(v[cb][0], v[cb][1], v[cb][2], v[cb][3]);
        }
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

template <int TMR, int MODE, bool TAIL = false>
int gmm_launch_tm(const void* x, const void* row_src, const void* q, const void* s,
                  const void* tile_e, const void* tile_valid, void* out, int n_tiles, int K,
                  int N, int bits, int gs, long q_estride, long s_estride, int swiglu,
                  float limit, int gpt_oss, int tn, unsigned* sink, cudaStream_t stream) {
  constexpr int bytes = smem_bytes(TMR, MODE);
  constexpr int cols = cta_cols(TMR);
  cudaError_t err = cudaFuncSetAttribute(gmm_kernel<TMR, MODE, TAIL>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  // TAIL: a last, partial column CTA
  dim3 grid(n_tiles, swiglu ? (N / 2) / (cols / 2) : (N + cols - 1) / cols);
  gmm_kernel<TMR, MODE, TAIL><<<grid, THREADS, bytes, stream>>>(
      (const __nv_bfloat16*)x, (const int*)row_src, (const int8_t*)q,
      (const __nv_bfloat16*)s, (const int*)tile_e, (const int*)tile_valid, out, K, N, bits,
      gs, q_estride, s_estride, swiglu, limit, gpt_oss, tn, sink);
  return (int)cudaGetLastError();
}

// K4 / K7 at tile heights of 64, 128, 256 or 512 rows; groups a multiple
// of 32 rows (FULL) or of 16 (FULL16). The SwiGLU epilogue takes whole CTAs
// only; the f32 epilogue takes N % 64 == 0, through the TAIL instances where
// N is not a whole number of CTAs (at 512 rows a CTA is 64 columns, so
// always whole).
extern "C" int gmm_launch(const void* x, const void* row_src, const void* q, const void* s,
                          const void* tile_e, const void* tile_valid, void* out, int n_tiles,
                          int tm, int K, int N, int bits, int gs, long q_estride,
                          long s_estride, int swiglu, float limit, int gpt_oss,
                          void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (gs % 16 || K % gs || N % 64) return (int)cudaErrorInvalidValue;
  const int cols = cta_cols(tm);
  if (swiglu && (N / 2) % (cols / 2)) return (int)cudaErrorInvalidValue;
  const bool tail = !swiglu && N % cols != 0;
#define GMM_TM(T, M, TL)                                                                    \
  if (tm == T && (M == FULL16) == (gs % 32 != 0))                                           \
    return gmm_launch_tm<T, M, TL>(x, row_src, q, s, tile_e, tile_valid, out, n_tiles, K, N, \
                                   bits, gs, q_estride, s_estride, swiglu, limit, gpt_oss, 0, \
                                   nullptr, st);
  if (tail) {
    GMM_TM(64, FULL, true)
    GMM_TM(128, FULL, true)
    GMM_TM(256, FULL, true)
    GMM_TM(64, FULL16, true)
    GMM_TM(128, FULL16, true)
    GMM_TM(256, FULL16, true)
    return (int)cudaErrorInvalidValue;
  }
  GMM_TM(64, FULL, false)
  GMM_TM(128, FULL, false)
  GMM_TM(256, FULL, false)
  GMM_TM(512, FULL, false)
  GMM_TM(64, FULL16, false)
  GMM_TM(128, FULL16, false)
  GMM_TM(256, FULL16, false)
  GMM_TM(512, FULL16, false)
#undef GMM_TM
  return (int)cudaErrorInvalidValue;
}

// The probe forms (Mode), f32 out over tile-aligned rows or rows gathered
// through row_src: COPY, NOUNPACK and UNPACKONLY at 128 rows, V2 at 128, 256
// and 512. The FULL term is K7 itself (gmm_launch).
extern "C" int gmm_probe_launch(const void* x, const void* row_src, const void* q, const void* s,
                                const void* tile_e, const void* tile_valid, void* out,
                                int n_tiles, int tm, int K, int N, int bits, int gs,
                                long q_estride, long s_estride, int mode, int tn, void* sink,
                                void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  unsigned* sk = (unsigned*)sink;
  if (gs % 32) return (int)cudaErrorInvalidValue;
#define GMM_PROBE(T, M)                                                                     \
  if (tm == T && mode == M)                                                                 \
    return gmm_launch_tm<T, M>(x, row_src, q, s, tile_e, tile_valid, out, n_tiles, K, N, bits, \
                               gs, q_estride, s_estride, 0, 0.f, 0, tn, sk, st);
  GMM_PROBE(128, COPY)
  GMM_PROBE(128, NOUNPACK)
  GMM_PROBE(128, UNPACKONLY)
  GMM_PROBE(128, V2)
  GMM_PROBE(256, V2)
  GMM_PROBE(512, V2)
#undef GMM_PROBE
  return (int)cudaErrorInvalidValue;
}
