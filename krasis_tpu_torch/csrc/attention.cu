// K2 — causal online-softmax attention over a bf16 or fp8 (e4m3) KV cache:
// prefill, chunked prefill and decode, with an optional sliding window and
// per-head attention sinks.
//
// Replaces: krasis_tpu/ops/flash_attention.py flash_attention (_kernel) and
// decode_attention (_decode_kernel). The Sq*G query rows of one kv head are
// stacked as rows (row r is query s = r / G, head hkv*G + r % G) and query
// s sits at position q_off + s; decode passes q_off = kv_len - Sq.
//
// Numerics of the reference kernels: bf16 q and k; scores in f32 from the
// bf16 dot over the first DQK lanes (the lane pad beyond is zero), scaled
// after the dot; masked scores set to NEG_INF = -1e30 with the fully-masked
// row guards (m_safe, alpha); p summed in f32 and rounded to bf16 before the
// PV product; the final divide guards l == 0. With a window W > 0 a query at
// position p sees only keys kp > p - W. With sinks [Hq] (f32) the row sum
// takes exp(sink - m) once, at the end, for the row's head; the sink adds
// no value. V is either the first DV
// lanes of the K row (no V pointer: MLA's [ckv; kpe] cache, the reference's
// v_from_k) or a tensor of its own with its own strides (GQA's separate K
// and V buffers).
//
// What bounds it on the H100: prefill, operations (Sq*G rows share every K
// row); decode, bytes (each cache row is read once for all G heads). A
// window bounds both by the W keys a row sees: blocks wholly before a row
// tile's window are never loaded, splits wholly before it load nothing.
//
// fp8 cache (the reference's in-kernel upcast): K and V rows arrive as e4m3
// bytes through their own cp.async ring, and each block is widened to bf16 in
// one shared-memory pass before the products. Every e4m3 value is exact in
// bf16, and the products then run on the same bf16 tile as for a bf16 cache,
// so K2 over an fp8 cache equals K2 over that cache cast to bf16, bit for bit.
//
// Design (FA2 shape on mma.sync m16n8k16, nothing large in shared memory):
// a CTA of WM x SPLIT warps owns BM = 16*WM stacked query rows of one
// (batch, kv head). Warp (wm, wn) owns rows 16*wm.. and, of each BK-row kv
// block, the S columns wn*BK/SPLIT.. and the output columns wn*DVW..: S, O,
// the row max m and the row sum l live in registers. K and V blocks arrive
// through an NST-stage cp.async ring, so the next blocks load while this
// one computes; Q stays in shared memory (its 576 MLA lanes would need 144
// registers a thread). With SPLIT = 1 (GQA, DV ≤ 256) p goes to bf16 in
// registers and is PV's A operand directly. MLA's DV = 512 makes a 16 x
// 512 f32 O 256 registers a thread, over the limit, so SPLIT = 2 warps
// share 16 rows: each computes half the block's scores, they exchange row
// maxima, and each writes its half of P to shared memory once per block
// and reads the whole P as A for its half of DV. Masks are evaluated only
// on blocks that cross the diagonal, kv_len, or the split's end. Heaviest
// row tiles launch first.
//
// Two launch forms (ops/flash_attention.py chooses from shapes):
//  * one launch (chunk == 0): a CTA walks every kv block up to its tile's
//    causal and kv_len frontier (from its tile's window start) and writes
//    bf16 O / l, the sink joining l before the divide;
//  * split-KV (chunk > 0, Sq*G ≤ 64: decode and verify steps): CTA (split,
//    kv head, batch) walks rows [split*chunk, (split+1)*chunk) only and
//    writes an f32 partial O with its m and l to a workspace (a split past
//    kv_len or wholly before the window writes m = NEG_INF, l = 0 and reads
//    nothing); combine_kernel then merges the splits, m* = max m_i,
//    l = Σ e^(m_i - m*) l_i + e^(sink - m*), O = Σ e^(m_i - m*) O_i / l,
//    and rounds to bf16 once: the sink joins once, in the combine, never
//    inside a split. Decode thus runs on ~2 CTAs per SM instead of one CTA
//    per kv head.
#include <cuda_fp8.h>

#include <type_traits>

#include "mma.cuh"

namespace {

constexpr float NEG_INF = -1e30f;

struct Args {
  const __nv_bfloat16* q;
  long qsb, qss, qsh;
  const void* kv;          // bf16, or e4m3 bytes for an fp8 cache
  long ksb, ksh, kss;
  const void* v;           // nullptr: V is the first DV lanes of K
  long vsb, vsh, vss;
  __nv_bfloat16* out;
  const int* q_off;
  const int* kv_len;
  const float* sinks;      // [Hq] f32, or nullptr
  float scale;
  int Sq, Hq, Hkv, D, VW, DQK, DV;
  int window;              // 0: full causal
  int chunk, n_split;      // chunk == 0: one launch
  float* opart;        // [B, Hkv, n_split, R, DV]
  float* mpart;        // [B, Hkv, n_split, R]
  float* lpart;
};

__host__ __device__ constexpr int round16(int x) { return (x + 15) / 16 * 16; }

// Lanes of a staged K row: the score lanes, and V's when V lives in K.
__host__ __device__ inline int k_lanes(int DQK, int DVP, bool vink) {
  return round16(DQK > (vink ? DVP : 0) ? DQK : DVP);
}

// Bytes of one raw e4m3 block: K rows of KL lanes, then V rows of DVP.
__host__ __device__ inline int raw_stage_bytes(int BK, int KL, int DVP, bool vink) {
  return BK * KL + (vink ? 0 : BK * DVP);
}

// Shared memory: Q, the bf16 ring (one bf16 stage for an fp8 cache, which
// widens into it), P, the row-max exchange, and the raw e4m3 ring.
__host__ __device__ inline size_t smem_for(int WM, int SPLIT, int BK, int NST, int DVW,
                                           int DQK, bool vink, bool f8) {
  const int BM = WM * 16, DVP = DVW * SPLIT;
  const int KL = k_lanes(DQK, DVP, vink);
  const size_t stage = (size_t)BK * (KL + 8) + (vink ? 0 : (size_t)BK * (DVP + 8));
  return ((size_t)BM * (DQK + 8) + (f8 ? 1 : NST) * stage + (size_t)BM * (BK + 8)) * 2 +
         (size_t)SPLIT * BM * 4 + (f8 ? (size_t)NST * raw_stage_bytes(BK, KL, DVP, vink) : 0);
}

// Two e4m3 values (the low byte first) → two bf16, exact.
__device__ __forceinline__ uint32_t f8x2_to_bf16x2(uint32_t two) {
  const __half2_raw h = __nv_cvt_fp8x2_to_halfraw2((__nv_fp8x2_storage_t)two, __NV_E4M3);
  const float2 f = __half22float2(__half2(h));
  return ktt::pack_bf16(f.x, f.y);
}

// 16 e4m3 bytes → 16 bf16 (32 bytes); both addresses 16-byte aligned.
__device__ __forceinline__ void widen16(__nv_bfloat16* dst, const uint8_t* src) {
  const uint4 raw = *reinterpret_cast<const uint4*>(src);
  const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
  uint32_t o[8];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    o[2 * i] = f8x2_to_bf16x2(w[i] & 0xFFFFu);
    o[2 * i + 1] = f8x2_to_bf16x2(w[i] >> 16);
  }
  uint4* d = reinterpret_cast<uint4*>(dst);
  d[0] = make_uint4(o[0], o[1], o[2], o[3]);
  d[1] = make_uint4(o[4], o[5], o[6], o[7]);
}

template <int WM, int SPLIT, int BK, int NST, int DVW, bool F8>
__global__ void __launch_bounds__(WM * SPLIT * 32, 1) attention_kernel(const Args a) {
  using KT = std::conditional_t<F8, uint8_t, __nv_bfloat16>;  // a cache element
  constexpr int THREADS = WM * SPLIT * 32;
  constexpr int BM = WM * 16;
  constexpr int BKW = BK / SPLIT;  // score columns of a warp
  constexpr int NTS = BKW / 8;     // their n8 tiles
  constexpr int NTO = DVW / 8;     // n8 tiles of a warp's output columns
  constexpr int DVP = DVW * SPLIT;
  constexpr int LDP = BK + 8;
  static_assert(BKW % 8 == 0 && BK % 16 == 0 && NTO % 2 == 0, "tile shape");
  static_assert(SPLIT > 1 || NTS % 2 == 0, "register P needs whole k16 chunks");

  extern __shared__ __align__(128) unsigned char smem_raw[];
  const bool vink = a.v == nullptr;
  const int G = a.Hq / a.Hkv, R = a.Sq * G;
  const int b = blockIdx.z, hk = blockIdx.y;
  const bool split = a.chunk > 0;
  const int r0 = split ? 0 : (gridDim.x - 1 - blockIdx.x) * BM;
  const int qo = a.q_off[b], kl = a.kv_len[b];
  const int last = min(r0 + BM, R) - 1;
  const int pmin = qo + r0 / G, pmax = qo + last / G;
  const int kv_end = max(0, min(kl, pmax + 1));
  // keys before the window of the tile's first query are seen by no row
  const int win_lo = a.window > 0 ? max(0, pmin - a.window + 1) : 0;
  int k_lo = win_lo, k_hi = kv_end;
  if (split) {
    k_lo = max(win_lo, (int)blockIdx.x * a.chunk);
    k_hi = min(kv_end, (int)blockIdx.x * a.chunk + a.chunk);
  }
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t ws = ((size_t)(b * a.Hkv + hk) * a.n_split + blockIdx.x) * R;
  if (split && k_lo >= k_hi) {
    for (int r = tid; r < R; r += THREADS) {
      a.mpart[ws + r] = NEG_INF;
      a.lpart[ws + r] = 0.f;
    }
    return;
  }

  const int KL = k_lanes(a.DQK, DVP, vink);
  const int LDQ = a.DQK + 8, LDK = KL + 8, LDV = DVP + 8;
  const int stage = BK * LDK + (vink ? 0 : BK * LDV);
  const int raw_stage = raw_stage_bytes(BK, KL, DVP, vink);
  __nv_bfloat16* sq = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sring = sq + BM * LDQ;                  // F8: the one widened stage
  __nv_bfloat16* sp = sring + (F8 ? 1 : NST) * stage;
  float* red = reinterpret_cast<float*>(sp + BM * LDP);  // [SPLIT][BM]
  uint8_t* sraw = reinterpret_cast<uint8_t*>(red + SPLIT * BM);  // F8: [NST] raw stages

  // Q tile: stacked rows (s, g) → head hk*G + g; rows past R are zero
  {
    const int DQ8 = a.DQK / 8;
    for (int i = tid; i < BM * DQ8; i += THREADS) {
      const int r = i / DQ8, c = (i % DQ8) * 8, gr = r0 + r;
      const bool ok = gr < R;
      const __nv_bfloat16* src = a.q;
      if (ok) src = a.q + b * a.qsb + (gr / G) * a.qss + (hk * G + gr % G) * a.qsh + c;
      ktt::cp_async16(sq + r * LDQ + c, src, ok);
    }
  }
  const KT* kbase = static_cast<const KT*>(a.kv) + b * a.ksb + hk * a.ksh;
  const KT* vbase = vink ? nullptr : static_cast<const KT*>(a.v) + b * a.vsb + hk * a.vsh;
  // one kv block into a ring stage (F8: the raw ring, KL and DVP bytes a
  // row); rows past the walk's end and lanes past the buffers' width are
  // zero, so masked p = 0 never meets garbage
  constexpr int EL = 16 / sizeof(KT);  // elements of one 16-byte copy
  auto load_block = [&](int j, int st) {
    const int kb = k_lo + j * BK;
    KT* sk;
    int ldk, ldv;
    if constexpr (F8) {
      sk = sraw + st * raw_stage;
      ldk = KL, ldv = DVP;
    } else {
      sk = sring + st * stage;
      ldk = LDK, ldv = LDV;
    }
    const int KC = KL / EL;
    for (int i = tid; i < BK * KC; i += THREADS) {
      const int r = i / KC, c = (i % KC) * EL;
      const bool ok = kb + r < k_hi && c < a.D;
      ktt::cp_async16(sk + r * ldk + c, ok ? kbase + (long)(kb + r) * a.kss + c : a.kv, ok);
    }
    if (!vink) {
      KT* sv = sk + BK * ldk;
      constexpr int VC = DVP / EL;
      for (int i = tid; i < BK * VC; i += THREADS) {
        const int r = i / VC, c = (i % VC) * EL;
        const bool ok = kb + r < k_hi && c < a.VW;
        ktt::cp_async16(sv + r * ldv + c, ok ? vbase + (long)(kb + r) * a.vss + c : a.v, ok);
      }
    }
  };
  // F8: raw stage st widened into the bf16 stage
  auto widen_block = [&](int st) {
    const uint8_t* rk = sraw + st * raw_stage;
    const int K16 = KL / 16;
    for (int i = tid; i < BK * K16; i += THREADS) {
      const int r = i / K16, c = (i % K16) * 16;
      widen16(sring + r * LDK + c, rk + r * KL + c);
    }
    if (!vink) {
      constexpr int V16 = DVP / 16;
      for (int i = tid; i < BK * V16; i += THREADS) {
        const int r = i / V16, c = (i % V16) * 16;
        widen16(sring + BK * LDK + r * LDV + c, rk + BK * KL + r * DVP + c);
      }
    }
  };

  const int nblk = k_hi > k_lo ? (k_hi - k_lo + BK - 1) / BK : 0;
  const int wm = warp / SPLIT, wn = warp % SPLIT;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = wm * 16 + g;  // this thread's rows: row0, row0 + 8
  const int pos[2] = {r0 + row0 < R ? qo + (r0 + row0) / G : -1,
                      r0 + row0 + 8 < R ? qo + (r0 + row0 + 8) / G : -1};
  const bool pad_rows = r0 + BM > R;

  float o[NTO][4];
#pragma unroll
  for (int n = 0; n < NTO; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m_run[2] = {NEG_INF, NEG_INF}, l_run[2] = {0.f, 0.f};

#pragma unroll
  for (int st = 0; st < NST - 1; ++st) {
    if (st < nblk) load_block(st, st);
    ktt::cp_commit();
  }
  for (int j = 0; j < nblk; ++j) {
    ktt::cp_wait<NST - 2>();
    __syncthreads();
    if (j + NST - 1 < nblk) load_block(j + NST - 1, (j + NST - 1) % NST);
    ktt::cp_commit();
    if constexpr (F8) {
      widen_block(j % NST);
      __syncthreads();
    }
    const __nv_bfloat16* sk = sring + (F8 ? 0 : (j % NST) * stage);
    const __nv_bfloat16* sv = vink ? sk : sk + BK * LDK;
    const int ldv = vink ? LDK : LDV;
    const int kb = k_lo + j * BK;

    // S = Q K^T over this warp's BKW columns
    float s[NTS][4];
#pragma unroll
    for (int n = 0; n < NTS; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
    const __nv_bfloat16* qrow = sq + (wm * 16 + (lane & 15)) * LDQ + (lane >> 4) * 8;
#pragma unroll 4
    for (int k0 = 0; k0 < a.DQK; k0 += 16) {
      uint32_t af[4];
      ktt::ldsm_x4(af, qrow + k0);
      if constexpr (NTS == 1) {
        uint32_t b0, b1;
        ktt::ldsm_x2(b0, b1, sk + (wn * BKW + (lane & 7)) * LDK + k0 + ((lane >> 3) & 1) * 8);
        ktt::mma_bf16(s[0], af, b0, b1);
      } else {
#pragma unroll
        for (int n = 0; n < NTS; n += 2) {
          uint32_t bb[4];
          ktt::ldsm_x4(bb, sk + (wn * BKW + n * 8 + (lane & 7) + ((lane >> 4) << 3)) * LDK +
                               k0 + ((lane >> 3) & 1) * 8);
          ktt::mma_bf16(s[n], af, bb[0], bb[1]);
          ktt::mma_bf16(s[n + 1], af, bb[2], bb[3]);
        }
      }
    }

    // scale, mask (only blocks that cross a frontier), row max
    const bool need_mask = pad_rows || kb + BK > pmin + 1 || kb + BK > kl || kb + BK > k_hi ||
                           (a.window > 0 && kb <= pmax - a.window);
    float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int n = 0; n < NTS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float v = s[n][e] * a.scale;
        if (need_mask) {
          const int kp = kb + wn * BKW + n * 8 + 2 * t + (e & 1);
          if (!(kp <= pos[e >> 1] && kp < kl && kp < k_hi &&
                (a.window <= 0 || kp > pos[e >> 1] - a.window)))
            v = NEG_INF;
        }
        s[n][e] = v;
        mx[e >> 1] = fmaxf(mx[e >> 1], v);
      }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
    }
    if constexpr (SPLIT > 1) {
      if (t == 0) {
        red[wn * BM + row0] = mx[0];
        red[wn * BM + row0 + 8] = mx[1];
      }
      ktt::named_barrier(1 + wm, SPLIT * 32);
#pragma unroll
      for (int w = 0; w < SPLIT; ++w) {
        mx[0] = fmaxf(mx[0], red[w * BM + row0]);
        mx[1] = fmaxf(mx[1], red[w * BM + row0 + 8]);
      }
    }
    float m_safe[2], alpha[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float m_new = fmaxf(m_run[h], mx[h]);
      m_safe[h] = m_new <= NEG_INF / 2 ? 0.f : m_new;
      alpha[h] = m_run[h] <= NEG_INF / 2 ? 0.f : __expf(m_run[h] - m_safe[h]);
      m_run[h] = m_new;
      l_run[h] *= alpha[h];
    }
#pragma unroll
    for (int n = 0; n < NTS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = s[n][e] <= NEG_INF / 2 ? 0.f : __expf(s[n][e] - m_safe[e >> 1]);
        l_run[e >> 1] += p;
        s[n][e] = p;
      }
#pragma unroll
    for (int n = 0; n < NTO; ++n) {
      o[n][0] *= alpha[0];
      o[n][1] *= alpha[0];
      o[n][2] *= alpha[1];
      o[n][3] *= alpha[1];
    }

    // O += P V over this warp's DVW columns. SPLIT == 1: P from the score
    // registers; else each warp's part of P through shared memory.
    __nv_bfloat16* pw = sp + wm * 16 * LDP;
    if constexpr (SPLIT > 1) {
#pragma unroll
      for (int n = 0; n < NTS; ++n) {
        const int c = wn * BKW + n * 8 + 2 * t;
        *reinterpret_cast<uint32_t*>(pw + g * LDP + c) = ktt::pack_bf16(s[n][0], s[n][1]);
        *reinterpret_cast<uint32_t*>(pw + (g + 8) * LDP + c) = ktt::pack_bf16(s[n][2], s[n][3]);
      }
      ktt::named_barrier(1 + wm, SPLIT * 32);
    }
    const __nv_bfloat16* vrow =
        sv + ((lane & 7) + ((lane >> 3) & 1) * 8) * ldv + wn * DVW + (lane >> 4) * 8;
#pragma unroll
    for (int kc = 0; kc < BK / 16; ++kc) {
      uint32_t af[4];
      if constexpr (SPLIT == 1) {
        af[0] = ktt::pack_bf16(s[2 * kc][0], s[2 * kc][1]);
        af[1] = ktt::pack_bf16(s[2 * kc][2], s[2 * kc][3]);
        af[2] = ktt::pack_bf16(s[2 * kc + 1][0], s[2 * kc + 1][1]);
        af[3] = ktt::pack_bf16(s[2 * kc + 1][2], s[2 * kc + 1][3]);
      } else {
        ktt::ldsm_x4(af, pw + (lane & 15) * LDP + kc * 16 + (lane >> 4) * 8);
      }
#pragma unroll
      for (int n = 0; n < NTO; n += 2) {
        uint32_t bb[4];
        ktt::ldsm_x4_t(bb, vrow + kc * 16 * ldv + n * 8);
        ktt::mma_bf16(o[n], af, bb[0], bb[1]);
        ktt::mma_bf16(o[n + 1], af, bb[2], bb[3]);
      }
    }
  }
  ktt::cp_wait<0>();

  // row sums: over the quad, then over the SPLIT warps of the rows
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l_run[h] += __shfl_xor_sync(0xffffffffu, l_run[h], 1);
    l_run[h] += __shfl_xor_sync(0xffffffffu, l_run[h], 2);
  }
  if constexpr (SPLIT > 1) {
    __syncthreads();
    if (t == 0) {
      red[wn * BM + row0] = l_run[0];
      red[wn * BM + row0 + 8] = l_run[1];
    }
    __syncthreads();
    l_run[0] = l_run[1] = 0.f;
#pragma unroll
    for (int w = 0; w < SPLIT; ++w) {
      l_run[0] += red[w * BM + row0];
      l_run[1] += red[w * BM + row0 + 8];
    }
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int gr = r0 + row0 + 8 * h;
    if (gr >= R) continue;
    if (!split) {
      if (a.sinks != nullptr)  // the head's sink joins the row sum once
        l_run[h] += expf(a.sinks[hk * G + gr % G] - (m_run[h] <= NEG_INF / 2 ? 0.f : m_run[h]));
      // out[b, s, h, :] = O / l  (l == 0: a row that sees no key → 0)
      const float den = l_run[h] == 0.f ? 1.f : l_run[h];
      __nv_bfloat16* op =
          a.out + (((long)b * a.Sq + gr / G) * a.Hq + hk * G + gr % G) * a.DV;
#pragma unroll
      for (int n = 0; n < NTO; ++n) {
        const int c = wn * DVW + n * 8 + 2 * t;
        if (c < a.DV)
          *reinterpret_cast<uint32_t*>(op + c) =
              ktt::pack_bf16(o[n][2 * h] / den, o[n][2 * h + 1] / den);
      }
    } else {
      float* op = a.opart + (ws + gr) * a.DV;
#pragma unroll
      for (int n = 0; n < NTO; ++n) {
        const int c = wn * DVW + n * 8 + 2 * t;
        if (c < a.DV)
          *reinterpret_cast<float2*>(op + c) = make_float2(o[n][2 * h], o[n][2 * h + 1]);
      }
      if (wn == 0 && t == 0) {
        a.mpart[ws + gr] = m_run[h];
        a.lpart[ws + gr] = l_run[h];
      }
    }
  }
}

constexpr int COMBINE_THREADS = 128;

// One CTA per (stacked row, 128 output columns, batch x kv head).
__global__ void __launch_bounds__(COMBINE_THREADS)
combine_kernel(const float* __restrict__ opart, const float* __restrict__ mpart,
               const float* __restrict__ lpart, const float* __restrict__ sinks,
               __nv_bfloat16* __restrict__ out, int Sq, int Hq, int Hkv, int n_split, int DV) {
  extern __shared__ float wgt[];  // [n_split]
  __shared__ float red[COMBINE_THREADS / 32];
  const int G = Hq / Hkv, R = Sq * G;
  const int r = blockIdx.x, b = blockIdx.z / Hkv, hk = blockIdx.z % Hkv;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t base = (size_t)(b * Hkv + hk) * n_split;

  float mx = NEG_INF;
  for (int i = tid; i < n_split; i += COMBINE_THREADS) mx = fmaxf(mx, mpart[(base + i) * R + r]);
  for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
  if (lane == 0) red[warp] = mx;
  __syncthreads();
  mx = red[0];
  for (int w = 1; w < COMBINE_THREADS / 32; ++w) mx = fmaxf(mx, red[w]);
  __syncthreads();
  float l = 0.f;
  for (int i = tid; i < n_split; i += COMBINE_THREADS) {
    const float mi = mpart[(base + i) * R + r];
    const float w = mi <= NEG_INF / 2 ? 0.f : expf(mi - mx);
    wgt[i] = w;
    l += w * lpart[(base + i) * R + r];
  }
  for (int o = 16; o > 0; o >>= 1) l += __shfl_xor_sync(0xffffffffu, l, o);
  if (lane == 0) red[warp] = l;
  __syncthreads();
  l = 0.f;
  for (int w = 0; w < COMBINE_THREADS / 32; ++w) l += red[w];
  if (sinks != nullptr) l += expf(sinks[hk * G + r % G] - (mx <= NEG_INF / 2 ? 0.f : mx));

  const int c = blockIdx.y * COMBINE_THREADS + tid;
  if (c >= DV) return;
  // the loads are predicated, not branched over, so eight are in flight
  float acc = 0.f;
  const float* op = opart + (base * R + r) * DV + c;
#pragma unroll 8
  for (int i = 0; i < n_split; ++i) {
    const float w = wgt[i];
    const float v = w != 0.f ? __ldg(op + (size_t)i * R * DV) : 0.f;
    acc += w * v;
  }
  const int s = r / G, h = hk * G + r % G;
  out[(((long)b * Sq + s) * Hq + h) * DV + c] = __float2bfloat16(l == 0.f ? 0.f : acc / l);
}

template <int WM, int SPLIT, int BK, int NST, int DVW, bool F8>
int launch(const Args& a, int B, cudaStream_t stream) {
  const size_t bytes = smem_for(WM, SPLIT, BK, NST, DVW, a.DQK, a.v == nullptr, F8);
  auto kern = attention_kernel<WM, SPLIT, BK, NST, DVW, F8>;
  static size_t allowed = 0;  // the dynamic shared memory this instance may use
  if (bytes > allowed) {
    cudaError_t err =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return (int)err;
    allowed = bytes;
  }
  const int R = a.Sq * (a.Hq / a.Hkv);
  const int nx = a.chunk > 0 ? a.n_split : (R + WM * 16 - 1) / (WM * 16);
  kern<<<dim3(nx, a.Hkv, B), WM * SPLIT * 32, bytes, stream>>>(a);
  return (int)cudaGetLastError();
}

int pow2_at_least(int x, int lo) {
  int p = lo;
  while (p < x) p *= 2;
  return p;
}

// The launch shape for R stacked rows, DV output lanes and `ctas` one-launch
// CTAs of 128 rows (kv heads x batch x row tiles):
//   R ≤ 16 (decode):           1 x 8 warps, 64-row blocks, 2 stages, DVW = DV / 8;
//   DV ≤ 256, ≥ 132 CTAs:      8 x 1 warps, 32-row blocks, 3 stages, DVW = DV;
//   DV ≤ 256, fewer (chunks):  4 x 1 warps, the same, 64-row tiles for twice the CTAs;
//   else (MLA):                4 x 2 warps, 32-row blocks, 3 stages, DVW = DV / 2.
// DVW is a power of two ≥ 16 (the extra columns are computed from zero or
// finite lanes and not stored).
struct Shape {
  int WM, SPLIT, BK, NST, DVW;
};

constexpr int SMS = 132;

Shape shape_for(int R, int DV, long ctas128) {
  if (R <= 16) return {1, 8, 64, 2, pow2_at_least((DV + 7) / 8, 16)};
  if (DV <= 256) return {ctas128 >= SMS ? 8 : 4, 1, 32, 3, pow2_at_least(DV, 16)};
  return {4, 2, 32, 3, pow2_at_least((DV + 1) / 2, 16)};
}

template <int WM, bool F8>
int launch_split1(const Args& a, int B, int DVW, cudaStream_t st) {
  switch (DVW) {
    case 16: return launch<WM, 1, 32, 3, 16, F8>(a, B, st);
    case 32: return launch<WM, 1, 32, 3, 32, F8>(a, B, st);
    case 64: return launch<WM, 1, 32, 3, 64, F8>(a, B, st);
    case 128: return launch<WM, 1, 32, 3, 128, F8>(a, B, st);
    case 256: return launch<WM, 1, 32, 3, 256, F8>(a, B, st);
  }
  return (int)cudaErrorInvalidValue;
}

template <bool F8>
int launch_shape(const Args& a, int B, const Shape& s, cudaStream_t st) {
  if (s.WM == 1) {
    switch (s.DVW) {
      case 16: return launch<1, 8, 64, 2, 16, F8>(a, B, st);
      case 32: return launch<1, 8, 64, 2, 32, F8>(a, B, st);
      case 64: return launch<1, 8, 64, 2, 64, F8>(a, B, st);
    }
  } else if (s.SPLIT == 1) {
    return s.WM == 8 ? launch_split1<8, F8>(a, B, s.DVW, st)
                     : launch_split1<4, F8>(a, B, s.DVW, st);
  } else if (s.DVW == 256) {
    return launch<4, 2, 32, 3, 256, F8>(a, B, st);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" long attention_smem_bytes(int R, int DQK, int DV, int vink, int f8) {
  long most = 0;
  const long ctas_cases[2] = {1, SMS};  // either one-launch shape for DV ≤ 256
  for (long ctas : ctas_cases) {
    const Shape s = shape_for(R, DV, ctas);
    const long b = (long)smem_for(s.WM, s.SPLIT, s.BK, s.NST, s.DVW, DQK, vink != 0, f8 != 0);
    most = b > most ? b : most;
  }
  return most;
}

// chunk == 0: one launch. chunk > 0: the split launch, then the combine;
// `ws` holds the partial O [B, Hkv, n_split, R, DV] and then m and l
// [B, Hkv, n_split, R], f32. f8: the cache (kv, and v when given) holds
// e4m3 bytes; strides count elements either way. sinks: [Hq] f32 or null.
extern "C" int attention_launch(const void* q, long qsb, long qss, long qsh, const void* kv,
                                long ksb, long ksh, long kss, const void* v, long vsb,
                                long vsh, long vss, void* out, const void* q_off,
                                const void* kv_len, const void* sinks, float scale, int B,
                                int Sq, int Hq, int Hkv, int D, int VW, int DQK, int DV,
                                int window, int f8, int chunk, int n_split, void* ws,
                                void* stream) {
  const int R = Sq * (Hq / Hkv);
  if (chunk > 0 && R > 64) return (int)cudaErrorInvalidValue;
  const size_t parts = (size_t)B * Hkv * n_split * R;
  float* opart = (float*)ws;
  float* mpart = chunk > 0 ? opart + parts * DV : nullptr;
  float* lpart = chunk > 0 ? mpart + parts : nullptr;
  Args a{(const __nv_bfloat16*)q, qsb, qss, qsh, kv, ksb, ksh, kss, v, vsb, vsh, vss,
         (__nv_bfloat16*)out, (const int*)q_off, (const int*)kv_len, (const float*)sinks,
         scale, Sq, Hq, Hkv, D, VW, DQK, DV, window, chunk, n_split, opart, mpart, lpart};
  cudaStream_t st = (cudaStream_t)stream;
  const Shape s = shape_for(R, DV, (long)B * Hkv * ((R + 127) / 128));
  const int err = f8 ? launch_shape<true>(a, B, s, st) : launch_shape<false>(a, B, s, st);
  if (err != 0 || chunk == 0) return err;
  dim3 grid(R, (DV + COMBINE_THREADS - 1) / COMBINE_THREADS, B * Hkv);
  combine_kernel<<<grid, COMBINE_THREADS, n_split * sizeof(float), st>>>(
      opart, mpart, lpart, (const float*)sinks, (__nv_bfloat16*)out, Sq, Hq, Hkv, n_split,
      DV);
  return (int)cudaGetLastError();
}
