// Host-RAM MoE expert engine: routed top-k expert forward over quantized
// weights resident in host memory (the port's copy of
// krasis_tpu/native/hostmoe.cpp, with a thread count of its own).
//
// The offload tier (krasis_tpu_torch/offload.py) keeps a model's routed
// experts in host RAM when they do not fit the card: attention, norms,
// routing, the shared expert and the head run on the GPU, and each MoE
// layer's routed picks are computed here, against the same packed
// INT4/INT8 + bf16-scale format the device kernels use
// (krasis_tpu_torch/quant.py): one weight format, no repacking. The math
// layout is [K, N] with N contiguous: inner loops broadcast x[k] and FMA
// across 64-column stripes (AVX-512 / AVX2 intrinsics, portable scalar
// fallback); activations stay f32.
//
// Layout contract (see quant.py):
//   INT4: q int8 [K/2, N] — byte (r, n) holds element (r, n) in the low
//         nibble and (r + K/2, n) in the high nibble, two's complement
//         decode (v ^ 8) - 8;
//   INT8: q int8 [K, N];
//   scales bf16 [K/gs, N]; dequant w[k,n] = q * scale[k/gs, n].
//
// Threads: krasish_create takes the OpenMP team size of every parallel
// region (0 = omp_get_max_threads()), so a process that also runs other
// OpenMP pools (PyTorch's, parallel test workers) can keep this one small.
//
// C ABI only (ctypes-loaded from native/__init__.py).

#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

#ifdef _OPENMP
#include <omp.h>
#endif

// SIMD tiers are compiled with per-function target attributes and picked
// at runtime by cpuid, independent of the -march the TU was built with:
// AVX-512, AVX2+FMA and a portable scalar fallback. KRASISH_FORCE_TIER=avx512|avx2|scalar
// (read at krasish_create) pins a tier for testing.
#if defined(__x86_64__) || defined(__i386__)
#include <immintrin.h>
#define KRASISH_X86 1
#endif

namespace {

enum Tier { TIER_SCALAR = 0, TIER_AVX2 = 1, TIER_AVX512 = 2 };

static Tier detect_tier() {
    const char* f = std::getenv("KRASISH_FORCE_TIER");
#ifdef KRASISH_X86
    __builtin_cpu_init();
    const bool has512 =
        __builtin_cpu_supports("avx512f") && __builtin_cpu_supports("avx512bw");
    const bool has2 =
        __builtin_cpu_supports("avx2") && __builtin_cpu_supports("fma");
    if (f) {
        if (!std::strcmp(f, "avx512") && has512) return TIER_AVX512;
        if (!std::strcmp(f, "avx2") && has2) return TIER_AVX2;
        return TIER_SCALAR;
    }
    if (has512) return TIER_AVX512;
    if (has2) return TIER_AVX2;
#else
    (void)f;
#endif
    return TIER_SCALAR;
}

static inline float bf16_to_f32(uint16_t b) {
    uint32_t u = static_cast<uint32_t>(b) << 16;
    float f;
    std::memcpy(&f, &u, 4);
    return f;
}

struct LayerWeights {
    const int8_t* w13_q = nullptr;    // [E, H(/2), 2I]
    const uint16_t* w13_s = nullptr;  // [E, H/gs13, 2I] bf16
    const int8_t* w2_q = nullptr;     // [E, I(/2), H]
    const uint16_t* w2_s = nullptr;   // [E, I/gs2, H] bf16
    const float* w13_bias = nullptr;  // [E, 2I] or null
    const float* w2_bias = nullptr;   // [E, H] or null
};

struct HostMoE {
    int64_t n_layers, E, H, I;  // I = expert intermediate (2I columns in w13)
    int bits;
    int gs13, gs2;
    int gpt_oss;
    float swiglu_limit;
    Tier tier;
    int nthreads;               // OpenMP team size of every parallel region
    std::vector<LayerWeights> layers;
};

#ifdef KRASISH_X86
#define KRASISH_T512 __attribute__((target("avx512f,avx512bw")))
#define KRASISH_T256 __attribute__((target("avx2,fma")))

// 64-column stripe of the INT4 matvec: y[n0:n0+64] += dequant matvec.
// One pass over the byte rows; each 64-byte row feeds the lo (element r)
// and hi (element r + K/2) accumulators. Scale groups run along the
// UNPACKED k (group of element k is k/gs), so the hi half's group
// boundaries are offset by K/2 % gs relative to the byte rows; rows are
// processed in segments on which both halves' group indices are
// constant (e.g. V2-Lite w2: K=1408, K/2=704 is NOT a gs multiple).
KRASISH_T512
static void qmatvec4_stripe(const float* x, const int8_t* q,
                            const uint16_t* s, int64_t K, int64_t N,
                            int gs, int64_t n0, float* y) {
    const int64_t half = K / 2;
    const __m512i m4 = _mm512_set1_epi8(0xF);
    const __m512i m8 = _mm512_set1_epi8(8);

    __m512 acc[4];  // y accumulators: 4 x 16 lanes for [n0, n0+64)
    for (int v = 0; v < 4; ++v) acc[v] = _mm512_loadu_ps(y + n0 + 16 * v);

    int64_t r0 = 0;
    while (r0 < half) {
        const int64_t lo_end = (r0 / gs + 1) * gs;
        const int64_t hi_end = ((r0 + half) / gs + 1) * gs - half;
        int64_t r1 = lo_end < hi_end ? lo_end : hi_end;
        if (r1 > half) r1 = half;
        __m512 tlo[4], thi[4];
        for (int v = 0; v < 4; ++v) {
            tlo[v] = _mm512_setzero_ps();
            thi[v] = _mm512_setzero_ps();
        }
        for (int64_t r = r0; r < r1; ++r) {
            const __m512i b =
                _mm512_loadu_si512((const void*)(q + r * N + n0));
            // lo nibble -> signed int8: (v & 15 ^ 8) - 8
            const __m512i lo =
                _mm512_sub_epi8(_mm512_xor_si512(_mm512_and_si512(b, m4), m8), m8);
            // hi nibble: logical shift per 16-bit lane then mask
            const __m512i hs =
                _mm512_and_si512(_mm512_srli_epi16(b, 4), m4);
            const __m512i hi = _mm512_sub_epi8(_mm512_xor_si512(hs, m8), m8);
            const __m512 xl = _mm512_set1_ps(x[r]);
            const __m512 xh = _mm512_set1_ps(x[r + half]);
            for (int v = 0; v < 4; ++v) {
                const __m128i lo8 = _mm512_extracti32x4_epi32(lo, v);
                const __m128i hi8 = _mm512_extracti32x4_epi32(hi, v);
                const __m512 lof =
                    _mm512_cvtepi32_ps(_mm512_cvtepi8_epi32(lo8));
                const __m512 hif =
                    _mm512_cvtepi32_ps(_mm512_cvtepi8_epi32(hi8));
                tlo[v] = _mm512_fmadd_ps(xl, lof, tlo[v]);
                thi[v] = _mm512_fmadd_ps(xh, hif, thi[v]);
            }
        }
        const uint16_t* slo = s + (r0 / gs) * N + n0;
        const uint16_t* shi = s + ((r0 + half) / gs) * N + n0;
        for (int v = 0; v < 4; ++v) {
            // bf16 -> f32: zero-extend to 32 bits, shift left 16
            const __m512i sl = _mm512_slli_epi32(
                _mm512_cvtepu16_epi32(_mm256_loadu_si256(
                    (const __m256i*)(slo + 16 * v))), 16);
            const __m512i sh = _mm512_slli_epi32(
                _mm512_cvtepu16_epi32(_mm256_loadu_si256(
                    (const __m256i*)(shi + 16 * v))), 16);
            acc[v] = _mm512_fmadd_ps(tlo[v], _mm512_castsi512_ps(sl), acc[v]);
            acc[v] = _mm512_fmadd_ps(thi[v], _mm512_castsi512_ps(sh), acc[v]);
        }
        r0 = r1;
    }
    for (int v = 0; v < 4; ++v) _mm512_storeu_ps(y + n0 + 16 * v, acc[v]);
}

// 64-column stripe of the INT8 matvec.
KRASISH_T512
static void qmatvec8_stripe(const float* x, const int8_t* q,
                            const uint16_t* s, int64_t K, int64_t N,
                            int gs, int64_t n0, float* y) {
    __m512 acc[4];
    for (int v = 0; v < 4; ++v) acc[v] = _mm512_loadu_ps(y + n0 + 16 * v);
    const int64_t n_groups = K / gs;
    for (int64_t g = 0; g < n_groups; ++g) {
        __m512 t[4];
        for (int v = 0; v < 4; ++v) t[v] = _mm512_setzero_ps();
        const int64_t r0 = g * gs, r1 = r0 + gs;
        for (int64_t r = r0; r < r1; ++r) {
            const __m512i b =
                _mm512_loadu_si512((const void*)(q + r * N + n0));
            const __m512 xr = _mm512_set1_ps(x[r]);
            for (int v = 0; v < 4; ++v) {
                const __m128i b8 = _mm512_extracti32x4_epi32(b, v);
                const __m512 bf =
                    _mm512_cvtepi32_ps(_mm512_cvtepi8_epi32(b8));
                t[v] = _mm512_fmadd_ps(xr, bf, t[v]);
            }
        }
        const uint16_t* sg = s + g * N + n0;
        for (int v = 0; v < 4; ++v) {
            const __m512i sv = _mm512_slli_epi32(
                _mm512_cvtepu16_epi32(_mm256_loadu_si256(
                    (const __m256i*)(sg + 16 * v))), 16);
            acc[v] = _mm512_fmadd_ps(t[v], _mm512_castsi512_ps(sv), acc[v]);
        }
    }
    for (int v = 0; v < 4; ++v) _mm512_storeu_ps(y + n0 + 16 * v, acc[v]);
}

// ---- AVX2+FMA tier (32-column stripes; the reference's baseline ISA,
// reference src/kernel/avx2.rs:1066-1206) -------------------------------

// 8 signed bytes (low half of `b16`) -> 8 f32 lanes.
KRASISH_T256
static inline __m256 cvt8i8_ps(__m128i b16, int hi8) {
    const __m128i b8 = hi8 ? _mm_srli_si128(b16, 8) : b16;
    return _mm256_cvtepi32_ps(_mm256_cvtepi8_epi32(b8));
}

// 8 bf16 scales -> 8 f32 lanes.
KRASISH_T256
static inline __m256 bf16x8_ps(const uint16_t* p) {
    const __m128i h = _mm_loadu_si128((const __m128i*)p);
    return _mm256_castsi256_ps(
        _mm256_slli_epi32(_mm256_cvtepu16_epi32(h), 16));
}

// 32-column stripe of the INT4 matvec (same group-segment walk as the
// AVX-512 version; see that function's comment for why).
KRASISH_T256
static void qmatvec4_stripe_avx2(const float* x, const int8_t* q,
                                 const uint16_t* s, int64_t K, int64_t N,
                                 int gs, int64_t n0, float* y) {
    const int64_t half = K / 2;
    const __m256i m4 = _mm256_set1_epi8(0xF);
    const __m256i m8 = _mm256_set1_epi8(8);

    __m256 acc[4];
    for (int v = 0; v < 4; ++v) acc[v] = _mm256_loadu_ps(y + n0 + 8 * v);

    int64_t r0 = 0;
    while (r0 < half) {
        const int64_t lo_end = (r0 / gs + 1) * gs;
        const int64_t hi_end = ((r0 + half) / gs + 1) * gs - half;
        int64_t r1 = lo_end < hi_end ? lo_end : hi_end;
        if (r1 > half) r1 = half;
        __m256 tlo[4], thi[4];
        for (int v = 0; v < 4; ++v) {
            tlo[v] = _mm256_setzero_ps();
            thi[v] = _mm256_setzero_ps();
        }
        for (int64_t r = r0; r < r1; ++r) {
            const __m256i b =
                _mm256_loadu_si256((const __m256i*)(q + r * N + n0));
            const __m256i lo = _mm256_sub_epi8(
                _mm256_xor_si256(_mm256_and_si256(b, m4), m8), m8);
            const __m256i hs =
                _mm256_and_si256(_mm256_srli_epi16(b, 4), m4);
            const __m256i hi = _mm256_sub_epi8(_mm256_xor_si256(hs, m8), m8);
            const __m256 xl = _mm256_set1_ps(x[r]);
            const __m256 xh = _mm256_set1_ps(x[r + half]);
            const __m128i lo_l = _mm256_castsi256_si128(lo);
            const __m128i lo_h = _mm256_extracti128_si256(lo, 1);
            const __m128i hi_l = _mm256_castsi256_si128(hi);
            const __m128i hi_h = _mm256_extracti128_si256(hi, 1);
            tlo[0] = _mm256_fmadd_ps(xl, cvt8i8_ps(lo_l, 0), tlo[0]);
            tlo[1] = _mm256_fmadd_ps(xl, cvt8i8_ps(lo_l, 1), tlo[1]);
            tlo[2] = _mm256_fmadd_ps(xl, cvt8i8_ps(lo_h, 0), tlo[2]);
            tlo[3] = _mm256_fmadd_ps(xl, cvt8i8_ps(lo_h, 1), tlo[3]);
            thi[0] = _mm256_fmadd_ps(xh, cvt8i8_ps(hi_l, 0), thi[0]);
            thi[1] = _mm256_fmadd_ps(xh, cvt8i8_ps(hi_l, 1), thi[1]);
            thi[2] = _mm256_fmadd_ps(xh, cvt8i8_ps(hi_h, 0), thi[2]);
            thi[3] = _mm256_fmadd_ps(xh, cvt8i8_ps(hi_h, 1), thi[3]);
        }
        const uint16_t* slo = s + (r0 / gs) * N + n0;
        const uint16_t* shi = s + ((r0 + half) / gs) * N + n0;
        for (int v = 0; v < 4; ++v) {
            acc[v] = _mm256_fmadd_ps(tlo[v], bf16x8_ps(slo + 8 * v), acc[v]);
            acc[v] = _mm256_fmadd_ps(thi[v], bf16x8_ps(shi + 8 * v), acc[v]);
        }
        r0 = r1;
    }
    for (int v = 0; v < 4; ++v) _mm256_storeu_ps(y + n0 + 8 * v, acc[v]);
}

// 32-column stripe of the INT8 matvec.
KRASISH_T256
static void qmatvec8_stripe_avx2(const float* x, const int8_t* q,
                                 const uint16_t* s, int64_t K, int64_t N,
                                 int gs, int64_t n0, float* y) {
    __m256 acc[4];
    for (int v = 0; v < 4; ++v) acc[v] = _mm256_loadu_ps(y + n0 + 8 * v);
    const int64_t n_groups = K / gs;
    for (int64_t g = 0; g < n_groups; ++g) {
        __m256 t[4];
        for (int v = 0; v < 4; ++v) t[v] = _mm256_setzero_ps();
        const int64_t r0 = g * gs, r1 = r0 + gs;
        for (int64_t r = r0; r < r1; ++r) {
            const __m256i b =
                _mm256_loadu_si256((const __m256i*)(q + r * N + n0));
            const __m256 xr = _mm256_set1_ps(x[r]);
            const __m128i bl = _mm256_castsi256_si128(b);
            const __m128i bh = _mm256_extracti128_si256(b, 1);
            t[0] = _mm256_fmadd_ps(xr, cvt8i8_ps(bl, 0), t[0]);
            t[1] = _mm256_fmadd_ps(xr, cvt8i8_ps(bl, 1), t[1]);
            t[2] = _mm256_fmadd_ps(xr, cvt8i8_ps(bh, 0), t[2]);
            t[3] = _mm256_fmadd_ps(xr, cvt8i8_ps(bh, 1), t[3]);
        }
        const uint16_t* sg = s + g * N + n0;
        for (int v = 0; v < 4; ++v)
            acc[v] = _mm256_fmadd_ps(t[v], bf16x8_ps(sg + 8 * v), acc[v]);
    }
    for (int v = 0; v < 4; ++v) _mm256_storeu_ps(y + n0 + 8 * v, acc[v]);
}

#endif  // KRASISH_X86

// Portable stripe fallbacks (width 64 unless clipped by N).
static void qmatvec4_stripe_ref(const float* x, const int8_t* q,
                                const uint16_t* s, int64_t K, int64_t N,
                                int gs, int64_t n0, int64_t nw, float* y) {
    const int64_t half = K / 2;
    float tlo[64], thi[64];
    int64_t r0 = 0;
    while (r0 < half) {
        const int64_t lo_end = (r0 / gs + 1) * gs;
        const int64_t hi_end = ((r0 + half) / gs + 1) * gs - half;
        int64_t r1 = lo_end < hi_end ? lo_end : hi_end;
        if (r1 > half) r1 = half;
        std::memset(tlo, 0, sizeof(float) * nw);
        std::memset(thi, 0, sizeof(float) * nw);
        for (int64_t r = r0; r < r1; ++r) {
            const float xl = x[r], xh = x[r + half];
            const int8_t* row = q + r * N + n0;
            for (int64_t n = 0; n < nw; ++n) {
                const uint8_t b = (uint8_t)row[n];
                tlo[n] += xl * (float)((int)((b & 0xF) ^ 8) - 8);
                thi[n] += xh * (float)((int)((b >> 4) ^ 8) - 8);
            }
        }
        const uint16_t* slo = s + (r0 / gs) * N + n0;
        const uint16_t* shi = s + ((r0 + half) / gs) * N + n0;
        for (int64_t n = 0; n < nw; ++n) {
            y[n0 + n] +=
                tlo[n] * bf16_to_f32(slo[n]) + thi[n] * bf16_to_f32(shi[n]);
        }
        r0 = r1;
    }
}

static void qmatvec8_stripe_ref(const float* x, const int8_t* q,
                                const uint16_t* s, int64_t K, int64_t N,
                                int gs, int64_t n0, int64_t nw, float* y) {
    float t[64];
    const int64_t n_groups = K / gs;
    for (int64_t g = 0; g < n_groups; ++g) {
        std::memset(t, 0, sizeof(float) * nw);
        const int64_t r0 = g * gs, r1 = r0 + gs;
        for (int64_t r = r0; r < r1; ++r) {
            const float xr = x[r];
            const int8_t* row = q + r * N + n0;
            for (int64_t n = 0; n < nw; ++n) t[n] += xr * (float)row[n];
        }
        const uint16_t* sg = s + g * N + n0;
        for (int64_t n = 0; n < nw; ++n)
            y[n0 + n] += t[n] * bf16_to_f32(sg[n]);
    }
}

// y[N] (f32, caller-zeroed) += dequant(W)[K, N] matvec with x[K], over
// columns [c0, c1). `tier` picks the SIMD implementation (runtime cpuid
// dispatch; all tiers bit-agree with the scalar reference).
static void qmatvec_range(const float* x, const int8_t* q, const uint16_t* s,
                          int64_t K, int64_t N, int bits, int gs, int64_t c0,
                          int64_t c1, float* y, Tier tier) {
    int64_t n0 = c0;
#ifdef KRASISH_X86
    if (tier == TIER_AVX512) {
        for (; n0 + 64 <= c1; n0 += 64) {
            if (bits == 4)
                qmatvec4_stripe(x, q, s, K, N, gs, n0, y);
            else
                qmatvec8_stripe(x, q, s, K, N, gs, n0, y);
        }
    } else if (tier == TIER_AVX2) {
        for (; n0 + 32 <= c1; n0 += 32) {
            if (bits == 4)
                qmatvec4_stripe_avx2(x, q, s, K, N, gs, n0, y);
            else
                qmatvec8_stripe_avx2(x, q, s, K, N, gs, n0, y);
        }
    }
#else
    (void)tier;
#endif
    for (; n0 < c1; n0 += 64) {
        const int64_t nw = (c1 - n0) < 64 ? (c1 - n0) : 64;
        if (bits == 4)
            qmatvec4_stripe_ref(x, q, s, K, N, gs, n0, nw, y);
        else
            qmatvec8_stripe_ref(x, q, s, K, N, gs, n0, nw, y);
    }
}

static inline float sigmoidf(float v) { return 1.0f / (1.0f + std::exp(-v)); }

struct PickCtx {
    const HostMoE* h;
    const LayerWeights* lw;
    const float* x;
    const int32_t* topk;
    const float* topw;
    int64_t k;
};

// Compute one pick's weighted expert output into po[H] (zeroed here).
// Column range splits allow intra-pick parallelism; this variant does the
// whole pick single-threaded (used when there are enough picks).
static bool pick_forward(const PickCtx& c, int64_t p, float* hbuf,
                         float* abuf, float* po) {
    const HostMoE* h = c.h;
    const int64_t H = h->H, I = h->I;
    const int64_t t = p / c.k;
    const int32_t e = c.topk[p];
    const float w = c.topw[p];
    std::memset(po, 0, H * sizeof(float));
    if (e < 0 || w == 0.0f) return true;
    if (e >= h->E) return false;
    const int64_t w13_rows = (h->bits == 4) ? H / 2 : H;
    const int64_t w2_rows = (h->bits == 4) ? I / 2 : I;
    const int64_t w13_esz = w13_rows * 2 * I;
    const int64_t w13_ssz = (H / h->gs13) * 2 * I;
    const int64_t w2_esz = w2_rows * H;
    const int64_t w2_ssz = (I / h->gs2) * H;
    const float* xt = c.x + t * H;
    std::memset(hbuf, 0, 2 * I * sizeof(float));
    qmatvec_range(xt, c.lw->w13_q + e * w13_esz, c.lw->w13_s + e * w13_ssz, H,
                  2 * I, h->bits, h->gs13, 0, 2 * I, hbuf, h->tier);
    if (c.lw->w13_bias) {
        const float* b = c.lw->w13_bias + e * 2 * I;
        for (int64_t i = 0; i < 2 * I; ++i) hbuf[i] += b[i];
    }
    if (h->gpt_oss) {
        const float lim = h->swiglu_limit;
        for (int64_t i = 0; i < I; ++i) {
            float g = hbuf[i], u = hbuf[I + i];
            if (lim > 0.0f) {
                g = g < lim ? g : lim;
                u = u < -lim ? -lim : (u > lim ? lim : u);
            }
            abuf[i] = g * sigmoidf(1.702f * g) * (u + 1.0f);
        }
    } else {
        for (int64_t i = 0; i < I; ++i) {
            const float g = hbuf[i];
            abuf[i] = g * sigmoidf(g) * hbuf[I + i];
        }
    }
    qmatvec_range(abuf, c.lw->w2_q + e * w2_esz, c.lw->w2_s + e * w2_ssz, I, H,
                  h->bits, h->gs2, 0, H, po, h->tier);
    if (c.lw->w2_bias) {
        const float* b = c.lw->w2_bias + e * H;
        for (int64_t n = 0; n < H; ++n) po[n] += b[n];
    }
    for (int64_t n = 0; n < H; ++n) po[n] *= w;
    return true;
}

}  // namespace

extern "C" {

void* krasish_create(int64_t n_layers, int64_t E, int64_t H, int64_t I,
                     int bits, int gs13, int gs2, int gpt_oss,
                     float swiglu_limit, int nthreads) {
    if (n_layers <= 0 || E <= 0 || H <= 0 || I <= 0) return nullptr;
    if (bits != 4 && bits != 8) return nullptr;
    if (H % gs13 || I % gs2) return nullptr;
    if (bits == 4 && (H % 2 || I % 2)) return nullptr;
    HostMoE* h = new HostMoE();
    h->n_layers = n_layers;
    h->E = E;
    h->H = H;
    h->I = I;
    h->bits = bits;
    h->gs13 = gs13;
    h->gs2 = gs2;
    h->gpt_oss = gpt_oss;
    h->swiglu_limit = swiglu_limit;
    h->tier = detect_tier();
#ifdef _OPENMP
    h->nthreads = nthreads > 0 ? nthreads : omp_get_max_threads();
#else
    h->nthreads = 1;
#endif
    h->layers.resize(n_layers);
    return h;
}

// Active SIMD tier: 0 = scalar, 1 = AVX2+FMA, 2 = AVX-512.
int krasish_tier(void* hp) {
    HostMoE* h = static_cast<HostMoE*>(hp);
    return h ? static_cast<int>(h->tier) : -1;
}

int krasish_set_layer(void* hp, int64_t layer, const void* w13_q,
                      const void* w13_s, const void* w2_q, const void* w2_s,
                      const float* w13_bias, const float* w2_bias) {
    HostMoE* h = static_cast<HostMoE*>(hp);
    if (!h || layer < 0 || layer >= h->n_layers) return 1;
    LayerWeights& lw = h->layers[layer];
    lw.w13_q = static_cast<const int8_t*>(w13_q);
    lw.w13_s = static_cast<const uint16_t*>(w13_s);
    lw.w2_q = static_cast<const int8_t*>(w2_q);
    lw.w2_s = static_cast<const uint16_t*>(w2_s);
    lw.w13_bias = w13_bias;
    lw.w2_bias = w2_bias;
    return 0;
}

// x [T, H] f32, topk [T, k] int32 (global expert ids; id < 0 = skip),
// topw [T, k] f32, out [T, H] f32 (overwritten).
int krasish_forward(void* hp, int64_t layer, int64_t T, int64_t k,
                    const float* x, const int32_t* topk, const float* topw,
                    float* out) {
    HostMoE* h = static_cast<HostMoE*>(hp);
    if (!h || layer < 0 || layer >= h->n_layers) return 1;
    const LayerWeights& lw = h->layers[layer];
    if (!lw.w13_q || !lw.w2_q) return 2;

    const int64_t H = h->H, I = h->I;
    const int64_t P = T * k;
    PickCtx ctx{h, &lw, x, topk, topw, k};

    const int nthreads = h->nthreads;

    // Per-pick outputs, reduced per token afterwards (no atomics).
    std::vector<float> pick_out(P * H);
    std::atomic<int> bad{0};

    if (P >= 2 * nthreads) {
        // Enough picks: parallelize across picks, one thread per pick.
#pragma omp parallel num_threads(nthreads)
        {
            std::vector<float> hbuf(2 * I), abuf(I);
#pragma omp for schedule(dynamic, 1)
            for (int64_t p = 0; p < P; ++p) {
                if (!pick_forward(ctx, p, hbuf.data(), abuf.data(),
                                  pick_out.data() + p * H))
                    bad.store(3);
            }
#pragma omp for schedule(static)
            for (int64_t t = 0; t < T; ++t) {
                float* o = out + t * H;
                std::memset(o, 0, H * sizeof(float));
                for (int64_t j = 0; j < k; ++j) {
                    const float* po = pick_out.data() + (t * k + j) * H;
                    for (int64_t n = 0; n < H; ++n) o[n] += po[n];
                }
            }
        }
        return bad.load();
    }

    // Few picks (decode T=1): parallelize columns inside each pick.
    const int64_t w13_rows = (h->bits == 4) ? H / 2 : H;
    const int64_t w2_rows = (h->bits == 4) ? I / 2 : I;
    const int64_t w13_esz = w13_rows * 2 * I;
    const int64_t w13_ssz = (H / h->gs13) * 2 * I;
    const int64_t w2_esz = w2_rows * H;
    const int64_t w2_ssz = (I / h->gs2) * H;
    std::vector<float> hbuf(2 * I), abuf(I);
    for (int64_t t = 0; t < T; ++t) std::memset(out + t * H, 0, H * 4);

    for (int64_t p = 0; p < P; ++p) {
        const int64_t t = p / k;
        const int32_t e = ctx.topk[p];
        const float w = ctx.topw[p];
        if (e < 0 || w == 0.0f) continue;
        if (e >= h->E) return 3;
        const float* xt = x + t * H;
        float* po = pick_out.data() + p * H;
        std::memset(hbuf.data(), 0, 2 * I * sizeof(float));
        std::memset(po, 0, H * sizeof(float));
        const int8_t* q13 = lw.w13_q + e * w13_esz;
        const uint16_t* s13 = lw.w13_s + e * w13_ssz;
        const int8_t* q2 = lw.w2_q + e * w2_esz;
        const uint16_t* s2 = lw.w2_s + e * w2_ssz;
#pragma omp parallel num_threads(nthreads)
        {
#ifdef _OPENMP
            const int tid = omp_get_thread_num();
            const int nt = omp_get_num_threads();
#else
            const int tid = 0, nt = 1;
#endif
            // 64-aligned column split of w13
            const int64_t N1 = 2 * I;
            const int64_t stripes1 = (N1 + 63) / 64;
            const int64_t c0 = (stripes1 * tid / nt) * 64;
            const int64_t c1 = (stripes1 * (tid + 1) / nt) * 64;
            qmatvec_range(xt, q13, s13, H, N1, h->bits, h->gs13, c0,
                          c1 < N1 ? c1 : N1, hbuf.data(), h->tier);
#pragma omp barrier
#pragma omp single
            {
                if (lw.w13_bias) {
                    const float* b = lw.w13_bias + e * 2 * I;
                    for (int64_t i = 0; i < 2 * I; ++i) hbuf[i] += b[i];
                }
                if (h->gpt_oss) {
                    const float lim = h->swiglu_limit;
                    for (int64_t i = 0; i < I; ++i) {
                        float g = hbuf[i], u = hbuf[I + i];
                        if (lim > 0.0f) {
                            g = g < lim ? g : lim;
                            u = u < -lim ? -lim : (u > lim ? lim : u);
                        }
                        abuf[i] = g * sigmoidf(1.702f * g) * (u + 1.0f);
                    }
                } else {
                    for (int64_t i = 0; i < I; ++i) {
                        const float g = hbuf[i];
                        abuf[i] = g * sigmoidf(g) * hbuf[I + i];
                    }
                }
            }
            const int64_t stripes2 = (H + 63) / 64;
            const int64_t d0 = (stripes2 * tid / nt) * 64;
            const int64_t d1 = (stripes2 * (tid + 1) / nt) * 64;
            qmatvec_range(abuf.data(), q2, s2, I, H, h->bits, h->gs2, d0,
                          d1 < H ? d1 : H, po, h->tier);
        }
        if (lw.w2_bias) {
            const float* b = lw.w2_bias + e * H;
            for (int64_t n = 0; n < H; ++n) po[n] += b[n];
        }
        float* o = out + t * H;
        for (int64_t n = 0; n < H; ++n) o[n] += w * po[n];
    }
    return 0;
}

void krasish_destroy(void* hp) { delete static_cast<HostMoE*>(hp); }

int krasish_threads(void* hp) {
    HostMoE* h = static_cast<HostMoE*>(hp);
    return h ? h->nthreads : -1;
}

}  // extern "C"
