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
// K7a — gmm_a8_kernel<TMR, IS4, G16>, the same tiles with int8 rows
// (gmm_pallas.py gmm_a8, _gmm_kernel_a8): out[r, :] = Σ_g (xq[r, g] · W[e, g])
// * sx[r, g] * sw[g, :], the weights unpacked to int8 with no scale, one
// exact int32 dot per K-group, folded into the f32 sum when the group is
// done (d * sx first, then * sw, then the add, each rounded, as the
// reference writes it). Tiles of 64 rows (2 x 4 warps over 128 columns) or
// 128 rows (4 x 2 warps over 64 columns): a warp always owns 32 rows x 32
// columns, so the int32 sets and the f32 sums fit its registers. Groups of
// a multiple of 32 rows run mma.sync m16n8k32 .s8.s8.s32; groups of 16
// (G16: a multiple of 16, not of 32) m16n8k16, so no product spans two
// groups. N % 64 == 0: a last 128-column CTA may have 64 live columns (its
// loads past N are zero-filled, its warps past N store nothing).
// Bound by operations at int8's tensor-core peak at the main path's row
// counts, by bytes where experts get few rows. Design:
//  * gmm_kernel's cp.async ring of 32 packed rows a step (6 stages at 64
//    rows, 4 at 128), with the tile's int8 rows (gathered through row_src,
//    zero-filled for padding rows) and, for a step that ends a group, the
//    rows' f32 and the weights' bf16 scales of that group staged beside
//    them; groups are tracked by their end rows, with no division;
//  * a group's fold converts its dots to f32 exactly on the full-rate
//    pipes (|d| < 2^22 up to 256 rows a group; I2F beyond);
//  * A fragments (the rows) by ldmatrix; B fragments (the weights) by four
//    32-bit loads of 4 columns of 4 k rows and a 4 x 4 byte transpose
//    (__byte_perm), which makes k-major words: column c of n8 tile c is
//    4g + c of the warp's 32, so a thread's C values are 8 adjacent
//    columns. The staged rows are 16-byte-chunk swizzled so these loads
//    hit 32 distinct banks;
//  * int4: each packed byte is read from device memory once and gives both
//    nibbles, each moved to its byte's high nibble (16 q, exact in int8):
//    the dots are 16x and shifted back exactly before the fold. The low
//    nibbles (K rows r) and the high ones (K/2 + r) lie in two groups, so
//    two int32 sets run side by side; where K/2 is not a whole number of
//    groups, the group that holds row K/2 is cut in two and a third set
//    sums both its parts before its one fold, after the last step. So for
//    int4 the groups are folded as they finish, low and high interleaved
//    and that cut group last, not in index order: the f32 sums may differ
//    from gmm_a8_plain's in the last bits. For int8 stacks the order is
//    the plain version's and the result equal bit for bit;
//  * a padding row (row_src < 0) reads zeros and scales 0 and gives zeros.
#include "int4.cuh"
#include "mma.cuh"
#include "int4.cuh"
#include "mma.cuh"

namespace {

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

// --- K7a ---------------------------------------------------------------
__host__ __device__ constexpr int a8_cols(int tm) { return tm == 128 ? 64 : 128; }
__host__ __device__ constexpr int a8_stages(int tm) { return tm == 128 ? 4 : 6; }
// byte pitches of a staged row of x (its 32 or 64 bytes a step, + 16) and
// of weights (the CTA's columns + 16)
__host__ __device__ constexpr int a8_lda(bool is4) { return is4 ? 80 : 48; }
__host__ __device__ constexpr int a8_ldb(int tm) { return a8_cols(tm) + 16; }
// scale slots of a step: one per half (int4: two) and 16-row sub-step (G16)
__host__ __device__ constexpr int a8_slots(bool is4, bool g16) {
  return (is4 ? 2 : 1) * (g16 ? 2 : 1);
}
__host__ __device__ constexpr int a8_stage_bytes(int tm, bool is4, bool g16) {
  return tm * a8_lda(is4) + PK * a8_ldb(tm) + tm * a8_slots(is4, g16) * 4 +
         a8_slots(is4, g16) * a8_cols(tm) * 2;
}
__host__ __device__ constexpr int a8_smem(int tm, bool is4, bool g16) {
  return a8_stages(tm) * a8_stage_bytes(tm, is4, g16) + tm * 4;
}
// the swizzled 16-byte chunk of weight row r: chunks move by two for rows
// 8-15 of each 16, so the four k-quads a B load reads lie in four bank groups
__device__ __forceinline__ int a8_chunk(int r, int c) { return c ^ (((r >> 3) & 1) << 1); }

__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool pred) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(ktt::smem_u32(dst)),
               "l"(src), "r"(pred ? 4 : 0));
}

// f32(d) for |d| < 2^22, exactly, on the full-rate pipes: d added to the
// bits of 1.5 * 2^23, whose unit in the last place is 1, then 1.5 * 2^23
// taken away
__device__ __forceinline__ float small_int_to_float(int d) {
  return __fsub_rn(__int_as_float(0x4B400000 + d), 12582912.f);
}

// a[i] for a small array indexed at run time, by selects (no local memory)
template <typename T, int S>
__device__ __forceinline__ T pick(const T (&a)[S], int i) {
  T v = a[0];
#pragma unroll
  for (int k = 1; k < S; ++k)
    if (i == k) v = a[k];
  return v;
}

// o[c] = byte c of w[0..3]: a 4 x 4 byte transpose
__device__ __forceinline__ void transpose4(const uint32_t w[4], uint32_t o[4]) {
  const uint32_t a = __byte_perm(w[0], w[1], 0x5140), b = __byte_perm(w[0], w[1], 0x7362);
  const uint32_t c = __byte_perm(w[2], w[3], 0x5140), d = __byte_perm(w[2], w[3], 0x7362);
  o[0] = __byte_perm(a, c, 0x5410);
  o[1] = __byte_perm(a, c, 0x7632);
  o[2] = __byte_perm(b, d, 0x5410);
  o[3] = __byte_perm(b, d, 0x7632);
}

__device__ __forceinline__ void mma_s8_k32(int c[4], const uint32_t a[4], uint32_t b0,
                                           uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ void mma_s8_k16(int c[4], uint32_t a0, uint32_t a1, uint32_t b0) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, "
      "{%4,%5}, {%6}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a0), "r"(a1), "r"(b0));
}

template <int TMR, bool IS4, bool G16>
__global__ void __launch_bounds__(THREADS)
gmm_a8_kernel(const int8_t* __restrict__ xq, const float* __restrict__ sx,
              const int* __restrict__ row_src, const int8_t* __restrict__ q,
              const __nv_bfloat16* __restrict__ s, const int* __restrict__ tile_e,
              const int* __restrict__ tile_valid, float* __restrict__ out, int K, int N,
              int gs, long q_estride, long s_estride) {
  constexpr int BNC = a8_cols(TMR);
  constexpr int WN = BNC / 32, WM = 8 / WN;  // warps along the columns and the rows
  static_assert(WM * 32 == TMR, "a warp owns 32 rows");
  constexpr int NST = a8_stages(TMR), LDA = a8_lda(IS4), LDB = a8_ldb(TMR);
  constexpr int HALVES = IS4 ? 2 : 1;
  constexpr int SUBS = G16 ? 2 : 1;
  constexpr int SLOTS = HALVES * SUBS;
  constexpr int SB = a8_stage_bytes(TMR, IS4, G16);
  constexpr int SETS = IS4 ? 3 : 1;  // int32 sets: low half, high half, the cut group
  const int tile = blockIdx.x;
  if (!tile_valid[tile]) return;
  extern __shared__ __align__(128) unsigned char smem[];
  const int e = tile_e[tile];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp / WN, wn = warp % WN;
  const int g = lane >> 2, t = lane & 3;
  const int rows = IS4 ? K / 2 : K;  // packed weight rows
  const int khalf = K / 2;
  const int steps = rows / PK;
  const int G = K / gs;
  // int4: the group cut by row K/2, or -1
  const int gcut = IS4 && khalf % gs ? khalf / gs : -1;
  const int n0 = blockIdx.y * BNC;
  const int8_t* qe = q + e * q_estride;
  const __nv_bfloat16* se = s + e * s_estride;
  int* srow = reinterpret_cast<int*>(smem + NST * SB);
  for (int r = tid; r < TMR; r += THREADS) {
    const int grow = tile * TMR + r;
    srow[r] = row_src ? row_src[grow] : grow;
  }
  __syncthreads();

  // Groups are tracked without division, by the next group end (a K row)
  // and the current group of each half: for the loader, which stages a
  // slot's scales only where its chunk ends a group (and the low half's
  // last chunk, which ends the cut group), and for the products, which
  // fold there. The loader runs step by step in order, NST - 1 ahead.
  const int CH = G16 ? 16 : 32;  // K rows of a product chunk
  const int hi_grp = khalf / gs;
  int lend[2] = {gs, (hi_grp + 1) * gs}, lgrp[2] = {0, hi_grp};
  auto load_stage = [&](int j, int st) {
    unsigned char* base = smem + st * SB;
    int8_t* sa = reinterpret_cast<int8_t*>(base);
    int8_t* sb = reinterpret_cast<int8_t*>(base + TMR * LDA);
    float* sxs = reinterpret_cast<float*>(base + TMR * LDA + PK * LDB);
    __nv_bfloat16* sws = reinterpret_cast<__nv_bfloat16*>(base + TMR * LDA + PK * LDB +
                                                          TMR * SLOTS * 4);
    const int p0 = j * PK;
    // the rows: per half 32 bytes, two 16-byte chunks
    for (int c = tid; c < TMR * HALVES * 2; c += THREADS) {
      const int r = c / (HALVES * 2), h = (c >> 1) % HALVES, off = (c & 1) * 16;
      const int src = srow[r];
      ktt::cp_async16(sa + r * LDA + h * 32 + off,
                      src >= 0 ? xq + (long)src * K + (h ? khalf : 0) + p0 + off : xq, src >= 0);
    }
    // the weights: PK packed rows of the CTA's columns, chunks swizzled
    for (int c = tid; c < PK * (BNC / 16); c += THREADS) {
      const int r = c / (BNC / 16), ch = c % (BNC / 16);
      const bool ok = n0 + ch * 16 < N;
      ktt::cp_async16(sb + r * LDB + a8_chunk(r, ch) * 16,
                      ok ? qe + (long)(p0 + r) * N + n0 + ch * 16 : qe, ok);
    }
    // the group of each slot whose chunk ends one, and the slots' group scales
    int grp[SLOTS];
    bool ends[SLOTS];
#pragma unroll
    for (int sl = 0; sl < SLOTS; ++sl) {
      const int h = sl / SUBS;
      const int kend = (h ? khalf : 0) + p0 + 16 * (sl % SUBS) + CH;
      grp[sl] = lgrp[h];
      ends[sl] = kend == lend[h] || (IS4 && h == 0 && kend == khalf);
      if (kend == lend[h]) {
        lend[h] += gs;
        ++lgrp[h];
      }
    }
    for (int c = tid; c < TMR * SLOTS; c += THREADS) {
      const int r = c / SLOTS, sl = c % SLOTS;
      const int src = srow[r];
      if (pick(ends, sl))
        cp_async4(sxs + r * SLOTS + sl, src >= 0 ? sx + (long)src * G + pick(grp, sl) : sx,
                  src >= 0);
    }
    for (int c = tid; c < SLOTS * (BNC / 8); c += THREADS) {
      const int sl = c / (BNC / 8), c8 = (c % (BNC / 8)) * 8;
      const bool ok = n0 + c8 < N;
      if (pick(ends, sl))
        ktt::cp_async16(sws + sl * BNC + c8, ok ? se + (long)pick(grp, sl) * N + n0 + c8 : se, ok);
    }
  };

  float acc[2][4][4];      // [m16 tile][n8 tile][C fragment]
  int d[SETS][2][4][4];    // the int32 group dots of each set
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        acc[i][n][v] = 0.f;
#pragma unroll
        for (int st = 0; st < SETS; ++st) d[st][i][n][v] = 0;
      }

  // |a group's dot| < 2^22 up to 256 rows (int8: 256 * 127 * 128 < 2^22)
  const bool small = gs <= 256;
  // acc += (f32(dots) * sx[row, slot]) * sw[slot, col], the dots zeroed.
  // C fragment (g, t) of m16 tile i, n8 tile n: rows 32 wm + 16 i + g (+ 8),
  // columns 32 wn + 8 t + n and + 4
  auto fold_as = [&](auto to_float, int (&dd)[2][4][4], const float* sxs,
                     const __nv_bfloat16* sws, int sl) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = wm * 32 + i * 16 + g;
      const float s0 = sxs[r * SLOTS + sl], s1 = sxs[(r + 8) * SLOTS + sl];
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        const int col = wn * 32 + 8 * t + n;
        const float w0 = __bfloat162float(sws[sl * BNC + col]);
        const float w1 = __bfloat162float(sws[sl * BNC + col + 4]);
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          const float dv = to_float(IS4 ? dd[i][n][v] >> 4 : dd[i][n][v]);
          acc[i][n][v] = __fadd_rn(acc[i][n][v],
                                   __fmul_rn(__fmul_rn(dv, v < 2 ? s0 : s1), v & 1 ? w1 : w0));
          dd[i][n][v] = 0;
        }
      }
    }
  };
  auto fold = [&](int (&dd)[2][4][4], const float* sxs, const __nv_bfloat16* sws, int sl) {
    if (small)
      fold_as([](int v) { return small_int_to_float(v); }, dd, sxs, sws, sl);
    else
      fold_as([](int v) { return (float)v; }, dd, sxs, sws, sl);
  };

#pragma unroll 1
  for (int st = 0; st < NST - 1; ++st) {
    if (st < steps) load_stage(st, st);
    ktt::cp_commit();
  }
  // the products' group tracking, as the loader's
  int gend[2] = {gs, (hi_grp + 1) * gs};
  const int cut_lo = gcut * gs, cut_hi = (gcut + 1) * gs;  // the cut group's rows
  for (int j = 0; j < steps; ++j) {
    ktt::cp_wait<NST - 2>();
    __syncthreads();
    if (j + NST - 1 < steps) load_stage(j + NST - 1, (j + NST - 1) % NST);
    ktt::cp_commit();
    const unsigned char* base = smem + (j % NST) * SB;
    const int8_t* sa = reinterpret_cast<const int8_t*>(base);
    const int8_t* sb = reinterpret_cast<const int8_t*>(base + TMR * LDA);
    const float* sxs = reinterpret_cast<const float*>(base + TMR * LDA + PK * LDB);
    const __nv_bfloat16* sws = reinterpret_cast<const __nv_bfloat16*>(
        base + TMR * LDA + PK * LDB + TMR * SLOTS * 4);
    const int p0 = j * PK;
    // B: k-major words of the warp's columns 4g + c, k rows 16 blk + 4t ..
    uint32_t bq[2][4];
#pragma unroll
    for (int blk = 0; blk < 2; ++blk) {
      uint32_t w[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = blk * 16 + 4 * t + i;
        const int byte = wn * 32 + 4 * g;
        w[i] = *reinterpret_cast<const uint32_t*>(sb + r * LDB + a8_chunk(r, byte >> 4) * 16 +
                                                  (byte & 15));
      }
      transpose4(w, bq[blk]);
    }
#pragma unroll
    for (int h = 0; h < HALVES; ++h) {
      uint32_t b[2][4];
#pragma unroll
      for (int blk = 0; blk < 2; ++blk)
#pragma unroll
        for (int c = 0; c < 4; ++c)
          b[blk][c] = IS4 ? (h == 0 ? (bq[blk][c] << 4) & 0xF0F0F0F0u : bq[blk][c] & 0xF0F0F0F0u)
                          : bq[blk][c];
      uint32_t af[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        ktt::ldsm_x4(af[i], sa + (wm * 32 + i * 16 + (lane & 15)) * LDA + h * 32 + (lane >> 4) * 16);
#pragma unroll
      for (int sub = 0; sub < SUBS; ++sub) {
        const int k0 = (h ? khalf : 0) + p0 + 16 * sub;  // the chunk's first K row
        const bool cut = IS4 && gcut >= 0 && (h ? k0 < cut_hi : k0 >= cut_lo);
        auto product = [&](int (&dd)[2][4][4]) {
#pragma unroll
          for (int i = 0; i < 2; ++i)
#pragma unroll
            for (int c = 0; c < 4; ++c) {
              if constexpr (G16)
                mma_s8_k16(dd[i][c], af[i][2 * sub], af[i][2 * sub + 1], b[sub][c]);
              else
                mma_s8_k32(dd[i][c], af[i], b[0][c], b[1][c]);
            }
        };
        if (cut)
          product(d[SETS - 1]);
        else
          product(d[h]);
        if (k0 + CH == gend[h]) {
          if (!cut) fold(d[h], sxs, sws, h * SUBS + sub);
          gend[h] += gs;
        }
      }
    }
    // the cut group: its high part came first, its low part ends the loop
    if (IS4 && gcut >= 0 && j == steps - 1) fold(d[SETS - 1], sxs, sws, SUBS - 1);
  }
  ktt::cp_wait<0>();

  if (n0 + wn * 32 >= N) return;  // a warp of the last CTA past N
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const long r = (long)tile * TMR + wm * 32 + i * 16 + g + 8 * hh;
      float* o = out + r * N + n0 + wn * 32 + 8 * t;
      *reinterpret_cast<float4*>(o) =
          make_float4(acc[i][0][2 * hh], acc[i][1][2 * hh], acc[i][2][2 * hh], acc[i][3][2 * hh]);
      *reinterpret_cast<float4*>(o + 4) = make_float4(acc[i][0][2 * hh + 1], acc[i][1][2 * hh + 1],
                                                      acc[i][2][2 * hh + 1], acc[i][3][2 * hh + 1]);
    }
}

template <int TMR, bool IS4, bool G16>
int gmm_a8_launch_tm(const void* xq, const void* sx, const void* row_src, const void* q,
                     const void* s, const void* tile_e, const void* tile_valid, void* out,
                     int n_tiles, int K, int N, int gs, long q_estride, long s_estride,
                     cudaStream_t stream) {
  constexpr int bytes = a8_smem(TMR, IS4, G16);
  const cudaError_t err = cudaFuncSetAttribute(gmm_a8_kernel<TMR, IS4, G16>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(n_tiles, (N + a8_cols(TMR) - 1) / a8_cols(TMR));
  gmm_a8_kernel<TMR, IS4, G16><<<grid, THREADS, bytes, stream>>>(
      (const int8_t*)xq, (const float*)sx, (const int*)row_src, (const int8_t*)q,
      (const __nv_bfloat16*)s, (const int*)tile_e, (const int*)tile_valid, (float*)out, K, N, gs,
      q_estride, s_estride);
  return (int)cudaGetLastError();
}

}  // namespace

// K7a at tile heights of 64 or 128 rows: groups a multiple of 16 rows (of
// 32: m16n8k32; else m16n8k16), K a whole number of groups, a multiple of
// 32 packed rows, N % 64 == 0 (a last CTA of 64 live columns at 64 rows).
extern "C" int gmm_a8_launch(const void* xq, const void* sx, const void* row_src,
                             const void* q, const void* s, const void* tile_e,
                             const void* tile_valid, void* out, int n_tiles, int tm, int K,
                             int N, int bits, int gs, long q_estride, long s_estride,
                             void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int rows = bits == 4 ? K / 2 : K;
  if ((bits != 4 && bits != 8) || gs % 16 || K % gs || rows % PK || N % 64)
    return (int)cudaErrorInvalidValue;
#define GMM_A8(T, B4, G)                                                                      \
  if (tm == T && (bits == 4) == B4 && (gs % 32 != 0) == G)                                    \
    return gmm_a8_launch_tm<T, B4, G>(xq, sx, row_src, q, s, tile_e, tile_valid, out, n_tiles, \
                                      K, N, gs, q_estride, s_estride, st);
  GMM_A8(64, true, false)
  GMM_A8(64, true, true)
  GMM_A8(64, false, false)
  GMM_A8(64, false, true)
  GMM_A8(128, true, false)
  GMM_A8(128, true, true)
  GMM_A8(128, false, false)
  GMM_A8(128, false, true)
#undef GMM_A8
  return (int)cudaErrorInvalidValue;
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
