// K3 — W4A8 gathered expert MLP for decode, in exactly two launches:
//   stage 1: a[p, :] = act(h),  h = xq[t] · W13[e]  by int8 group dots,
//            x quantized inside the kernel;
//   stage 2: out[t, :] = bf16(Σ_j wt[p_j] · (requant(a[p_j]) · W2[e_j])),
//            the k picks p_j = t·k + j of token t summed in pick order;
// for every pick p = (token t = p / k, expert e = idx[p]).
//
// Replaces: krasis_tpu/ops/moe_pallas.py:391 moe_gathered_w4a8_pallas
// (_kernel_w4a8 with _grouped_dot_i8, _unpack_int8 and quantize_activations).
// Numerics as there: activations are int8 per row and K-group with scale
// max|x|/127 clamped at 1e-8 (IEEE division), rounded half to even and
// clipped to ±127; each int8 x int8 group dot is exact in int32, and the
// f32 sum takes acc = acc + (d * sx) * sw over the groups g = 0, 1, ... in
// order; the activation (SwiGLU, or GPT-OSS's clamped form: ktt::mlp_act)
// runs on the f32 h; the hidden is requantized from f32 at w2's group size;
// the picks' f32 outputs times their routing weights are summed in pick
// order and rounded to bf16 once. Every sum has a fixed order and no float
// is added atomically, so a call gives the same bits on every run.
//
// What bounds it on the H100: bytes. Each pick reads its expert's packed
// w13 and w2 once (4.46 MB with scales per pick at V2-Lite widths) for 2 int8
// operations per weight element. What the design does about it:
//  1. CTAs: a CTA streams `cols` weight columns (stage 1: cols/2 gate and
//     cols/2 up columns) over a contiguous range of 32-row units; the units
//     of one column tile (stage 1: one pick's packed rows; stage 2: a
//     token's k picks times their packed rows, pick-major) split over the
//     ks ranks of a thread-block cluster (ks = 1, 2, 4 or 8). The plan
//     (ops/moe_cuda.py plan_w4a8) picks cols and ks for 2.5 CTAs an SM
//     where it can: at T = 1, 352 and 512 CTAs on V2-Lite and on the
//     hybrid. Stage 2 is held to 51 registers so its 512 CTAs fit at once.
//  2. Copies: the weight units stream through a ring of 16-byte cp.async
//     copies (6 stages of 4 KB in stage 1, 4 in stage 2: one copy a thread
//     a stage). The activation rows and the scale rows a rank reduces go
//     first, in their own copy group, so quantizing waits for them and not
//     for the weights behind them. Stage 2 is a programmatic dependent
//     launch: it may start (zero, gather its experts and scales) once every
//     stage-1 CTA has streamed its units, and waits for stage 1 to finish
//     (griddepcontrol.wait) before it copies the hidden.
//  3. Each packed int4 byte is read once: a 32-row unit gives the element
//     rows r and r + K/2 of the same bytes (low and high nibbles), with the
//     int8 activations of both rows in shared memory.
//  4. Products on mma.sync m16n8k32 s8 with the weights as A: ldmatrix.trans
//     of 32 packed rows x 16 columns gives each lane byte pairs of two
//     columns; two prmt make the four 4-row words of columns 2g and 2g + 1,
//     and one and (high nibble) or a shift and an and (low nibble) turn
//     them into 16 x the signed int4 values (a nibble in a byte's high half
//     is 16 x its value as an int8), so the int32 sum is 16·d and a shift
//     by 4 gives d exactly. The activations sit in shared memory permuted
//     to the same k order, one 32-bit load for each B register. int8
//     weights go to the mma as they lie.
//  5. No launches around the kernels: stage 1 quantizes the token's bf16
//     row itself, stage 2 requantizes the f32 hidden, does the
//     routing-weighted pick sum and stores bf16 [T, H]; the wrapper
//     allocates and launches, nothing else.
// Split groups: the unit ranges of two ranks may cut a group (V2-Lite's w2
// has K/2 = 704 = 5.5 groups of 128, so its group 5 lies in the low nibbles
// of packed rows 640-703 and the high nibbles of rows 0-63). Every unit's
// int32 dot of each (pick, group, column) is added, as an integer atomic
// (red.shared::cluster: any order gives the same sum), into the shared
// memory of the rank that reduces that column, and each quantized group's
// scale is stored into every rank. After the cluster barrier each rank
// holds whole int32 group dots of its columns and every scale, and only
// then takes the f32 sums in group and pick order.
// Groups of 16 rows (G16: a group size that is a multiple of 16 and not of
// 32): each 16-row half of a unit lies in one group, and the unit's dot is
// taken as two, one for each half (the other half's activations zero in
// the mma), each added to its own group.
//
// K6a — the same core for the two-stage expert class, the experts too
// large for the reference's fused kernel (ops/expert_class.py).
// Replaces: krasis_tpu/ops/moe_pallas.py:605 gathered_qmm_a8_pallas
// (_gq_kernel_a8), in the two forms its callers take:
//  * the chain moe_gathered_tiled(activation="int8") (moe_pallas.py:619),
//    two calls of it with quantization and SwiGLU between: the two kernels
//    above under names of their own (gq_a8_stage1_kernel,
//    gq_a8_stage2_kernel), which also take pick_valid. The reference rounds
//    at the same points as its fused kernel: int32 group dots, the f32 sum
//    over the groups in order, the activation on the f32 h, the hidden
//    requantized from f32, the picks weighted in f32 and summed.
//  * the one product gathered_qmm_a8(xq, sx, W, e, valid) → f32 [P, N]:
//    stage 1 in a product form (gq_a8_product_kernel): the int8 rows and
//    their scales staged as given, COLS output columns a CTA, no
//    activation, the f32 sums stored.
// A pick whose valid flag is 0 copies no weight or scale byte in either
// stage and adds nothing to its token's sum; the product form writes its
// row as zeros. That is the reference's result: its h and o are 0 there.
#include <stdint.h>

#include "int4.cuh"
#include "mma.cuh"

// build.py compiles this file in parts, in parallel (-DKRASIS_PART=0, 1),
// and links them into one library; a part holds the blocks under
// IN_PART(its number). Compiled whole, the file holds every block.
#ifdef KRASIS_PART
#define IN_PART(n) (KRASIS_PART == (n))
#else
#define IN_PART(n) 1
#endif

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int UNIT = 32;  // packed rows of a unit: one ldmatrix.x4.trans
constexpr int STAGES1 = 6;
constexpr int STAGES2 = 4;
constexpr int MAX_SMEM = 227 * 1024;

struct Args {
  const __nv_bfloat16* x;  // [T, H], rows x_stride apart
  long x_stride;
  const int* idx;          // [T * k]
  const float* wt;         // [T * k]
  const int8_t* q13;       // [E, H(/2), 2I]
  const __nv_bfloat16* s13;
  long q13_es, s13_es;
  const int8_t* q2;        // [E, I(/2), H]
  const __nv_bfloat16* s2;
  long q2_es, s2_es;
  float* a;                // [T * k, I] f32: stage 1 → stage 2
  __nv_bfloat16* out;      // [T, H]
  int T, k, H, I, gs13, gs2;
  float limit;
  int gpt_oss;
  const int* valid;        // [T * k] or null (K6a): 0 skips the pick
};

// The product form: out[p, :] = Σ_g (xq[p, g] · W[e[p], g]) * sx[p, g] * sw[g, :].
struct Prod {
  const int8_t* xq;        // [P, K] int8 rows
  const float* sx;         // [P, K / gs] their scales
  const int* idx;          // [P]
  const int* valid;        // [P] or null
  const int8_t* q;         // [E, K(/2), N]
  const __nv_bfloat16* s;  // [E, K / gs, N]
  long q_es, s_es;
  float* out;              // [P, N] f32
  int K, N, gs;
};

__host__ __device__ constexpr int al16(int n) { return (n + 15) & ~15; }

// The picks a rank's units can reach: ranks hold at most ceil(U / ks)
// units of nb per pick.
__host__ __device__ inline int rank_picks(int U, int ks, int nb, int kk) {
  const int n = ((U + ks - 1) / ks + nb - 1) / nb + 1;
  return n < kk ? n : kk;
}

// Shared memory of a CTA whose units reach np of the cluster's kk picks:
// the ring (reused after the main loop for the f32 sums), the int32 dots
// of its cr columns [kk][G][cr], the activation scales [kk][G], the weight
// scales of its columns [kk][G][cr], the permuted int8 activations
// [np][K], the activation rows as they lie (act_bytes), the flags of the
// groups its units reach [kk][G] and the picks' experts [kk].
struct Layout {
  int dpart, scl, sws, xperm, act, flags, eidx, total;
};
__host__ __device__ inline Layout layout(int stages, int cols, int kk, int G, int K, int cr,
                                         int np, int act_bytes) {
  Layout L{};
  const int ring = stages * (128 / cols) * UNIT * (cols + 16);
  const int post = kk * cr * 4;
  int off = al16(ring > post ? ring : post);
  L.dpart = off;
  off += al16(kk * G * cr * 4);
  L.scl = off;
  off += al16(kk * G * 4);
  L.sws = off;
  off += al16(kk * G * cr * 2);
  L.xperm = off;
  off += al16(np * K);
  L.act = off;
  off += al16(act_bytes);
  L.flags = off;
  off += al16(kk * G);
  L.eidx = off;
  off += al16(kk * 4);
  L.total = off;
  return L;
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(ktt::smem_u32(dst)), "l"(src));
}

// The shared::cluster address of `p` in the shared memory of cluster rank `rank`.
__device__ __forceinline__ uint32_t rank_addr(const void* p, int rank) {
  uint32_t a;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(a)
               : "r"(ktt::smem_u32(p)), "r"(rank));
  return a;
}

__device__ __forceinline__ void red_add_cluster(uint32_t addr, int v) {
  asm volatile("red.relaxed.cluster.shared::cluster.add.s32 [%0], %1;\n" ::"r"(addr), "r"(v)
               : "memory");
}

__device__ __forceinline__ void st_cluster(uint32_t addr, float v) {
  asm volatile("st.shared::cluster.f32 [%0], %1;\n" ::"r"(addr), "f"(v) : "memory");
}

// The cluster barrier in two halves, so the wait can come later than the arrival.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// c += a · b: s8 A 16x32 (row), s8 B 32x8 (col), s32 C 16x8.
__device__ __forceinline__ void mma_s8(int c[4], const uint32_t a[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Where element row w of a 32-row block sits in the permuted activations:
// position κ = 16h + 4t + i holds row 16h + {2t, 2t + 1, 2t + 8, 2t + 9}[i],
// the rows lane t's A words hold (see the main loop).
__device__ __forceinline__ int perm32(int w) {
  const int h = w >> 4, v = w & 15;
  const int t = (v & 7) >> 1, i = (v & 1) + ((v >> 3) << 1);
  return 16 * h + 4 * t + i;
}

// What the two stages share, from the copies to the products: a rank's
// units [u0, u1) (unit u: pick j = u / nb, packed rows 32 (u % nb) ...),
// the int8 activations of each pick j a K-row of xperm (row j - j0, j0 =
// u0 / nb), and the int32 dots
// dpart[j][g][CR] of the CR columns the rank reduces, which every rank of
// the cluster adds into. With SKIP, a pick j whose expert eidx[j] is -1
// copies nothing and adds nothing. G16: groups of a multiple of 16 rows
// that is not one of 32, so a unit's two 16-row halves are dotted apart.
template <int BITS, int COLS, int STAGES, bool SKIP = false, bool G16 = false>
struct Rank {
  static constexpr int PITCH = COLS + 16;  // bytes of a staged row: ldmatrix without conflicts
  static constexpr int CB = COLS / 16;     // 16-column blocks: the copies of a row
  static constexpr int UPS = 128 / COLS;   // units a stage: 256 copies of 16 bytes
  static constexpr int STAGE = UPS * UNIT * PITCH;

  unsigned char* ring;
  int* dpart;
  float* scl;
  int8_t* xperm;
  unsigned char* flags;
  int u0, u1, nb, K, gs, G, half, ks, CR, j0;
  const int* eidx = nullptr;

  __device__ __forceinline__ bool live(int j) const {
    if constexpr (SKIP) return eidx[j] >= 0;
    return true;
  }

  // Issue the copies of step s: units u0 + s·UPS + (0 .. UPS-1).
  template <typename Src>
  __device__ __forceinline__ void load(int s, Src src) const {
    const int tid = threadIdx.x;
    const int us = tid / (UNIT * CB), row = (tid / CB) % UNIT, ch = tid % CB;
    const int u = u0 + s * UPS + us;
    // SKIP first: K3's instances (SKIP false) then compute no u / nb
    // here, which keeps their code the same as without the test
    if (u < u1 && (!SKIP || live(u / nb)))
      ktt::cp_async16(ring + (s % STAGES) * STAGE + (us * UNIT + row) * PITCH + 16 * ch,
                      src(u / nb, (u % nb) * UNIT + row, 16 * ch), true);
  }

  template <typename Src>
  __device__ __forceinline__ void prologue(Src src) const {
    const int steps = (u1 - u0 + UPS - 1) / UPS;
#pragma unroll
    for (int s = 0; s < STAGES - 1; ++s) {
      if (s < steps) load(s, src);
      ktt::cp_commit();
    }
  }

  // Flag the groups of every pick that the rank's units reach (low and,
  // for int4, high nibbles).
  __device__ __forceinline__ void mark() const {
    for (int u = u0 + (int)threadIdx.x; u < u1; u += THREADS) {
      const int j = u / nb, r = (u % nb) * UNIT;
      if constexpr (SKIP)
        if (!live(j)) continue;
      flags[j * G + r / gs] = 1;
      if (G16) flags[j * G + (r + 16) / gs] = 1;
      if (BITS == 4) flags[j * G + (half + r) / gs] = 1;
      if (BITS == 4 && G16) flags[j * G + (half + r + 16) / gs] = 1;
    }
  }

  // Quantize the flagged groups from the staged rows, a warp a group:
  // scale max|v|/127 clamped at 1e-8, values rint(v / scale) clipped to
  // ±127, stored permuted; each
  // scale goes to every rank of the cluster (the ranks that reduce need all
  // of them; two ranks that share a group store the same value).
  template <typename Act>
  __device__ __forceinline__ void quantize(int kk, Act act) const {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    for (int q = warp; q < kk * G; q += WARPS) {
      if (!flags[q]) continue;
      const int j = q / G, e0 = (q % G) * gs;
      float v[8];  // the group's first 256 values, held
      float mx = 0.f;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const bool in = G16 ? 32 * i + lane < gs : 32 * i < gs;
        v[i] = in ? act(j, e0 + 32 * i + lane) : 0.f;
        mx = fmaxf(mx, fabsf(v[i]));
      }
      for (int i = 256 + lane; i < gs; i += 32) mx = fmaxf(mx, fabsf(act(j, e0 + i)));
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float sc = fmaxf(mx / 127.f, 1e-8f);
      if (lane < ks) st_cluster(rank_addr(scl + q, lane), sc);
      auto put = [&](int e, float x) {
        xperm[(j - j0) * K + (e & ~31) + perm32(e & 31)] =
            (int8_t)fminf(fmaxf(rintf(x / sc), -127.f), 127.f);
      };
#pragma unroll
      for (int i = 0; i < 8; ++i)
        if (G16 ? 32 * i + lane < gs : 32 * i < gs) put(e0 + 32 * i + lane, v[i]);
      for (int i = 256 + lane; i < gs; i += 32) put(e0 + i, act(j, e0 + i));
    }
  }

  // The ring: per step one unit a warp (warp / CB) and 16 columns (warp %
  // CB). Each unit's int32 dots are added into dpart of the rank that
  // reduces their column: `dst` gives a column's (rank, index in dpart).
  template <typename Src, typename Dst>
  __device__ __forceinline__ void run(Src src, Dst dst) const {
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int g = lane >> 2, t = lane & 3;
    const int wus = warp / CB, cb = warp % CB;
    const int steps = (u1 - u0 + UPS - 1) / UPS;
    // lane (g, t) adds: t = 0, 1 the low rows' dot of column 2g + t; t = 2,
    // 3 the high rows' (int4)
    const int2 to = dst(16 * cb + 2 * g + (t & 1));
    const uint32_t out = rank_addr(dpart + to.y, to.x);
    for (int s = 0; s < steps; ++s) {
      ktt::cp_wait<STAGES - 2>();
      __syncthreads();
      if (s + STAGES - 1 < steps) load(s + STAGES - 1, src);
      ktt::cp_commit();
      const int u = u0 + s * UPS + wus;
      if (u >= u1 || (SKIP && !live(u / nb))) continue;
      const int j = u / nb, r = (u % nb) * UNIT;
      uint32_t v[4];
      ktt::ldsm_x4_t(v, ring + (s % STAGES) * STAGE + (wus * UNIT + lane) * PITCH + 16 * cb);
      // v[m] = bytes (row 8m + 2t, col 2g), (8m + 2t, 2g + 1), (8m + 2t + 1, 2g),
      // (8m + 2t + 1, 2g + 1): A words of columns 2g (rows) and 2g + 1
      uint32_t w[4];
      w[0] = __byte_perm(v[0], v[1], 0x6420);
      w[1] = __byte_perm(v[0], v[1], 0x7531);
      w[2] = __byte_perm(v[2], v[3], 0x6420);
      w[3] = __byte_perm(v[2], v[3], 0x7531);
      const int8_t* xr = xperm + (j - j0) * K + r + 4 * t;
      const uint32_t b0 = *reinterpret_cast<const uint32_t*>(xr);
      const uint32_t b1 = *reinterpret_cast<const uint32_t*>(xr + 16);
      int c[4] = {0, 0, 0, 0};
      if constexpr (G16) {
        // the unit's rows r .. r + 15 (b0: positions 0-15) and r + 16 ..
        // (b1), a dot each; int4: of both nibbles' rows
        int c1[4] = {0, 0, 0, 0};
        if constexpr (BITS == 8) {
          mma_s8(c, w, b0, 0u);
          mma_s8(c1, w, 0u, b1);
          if (t < 2) {
            red_add_cluster(out + 4 * (j * G + r / gs) * CR, t ? c[2] : c[0]);
            red_add_cluster(out + 4 * (j * G + (r + 16) / gs) * CR, t ? c1[2] : c1[0]);
          }
        } else {
          uint32_t lo[4], hi[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            lo[i] = (w[i] << 4) & 0xF0F0F0F0u;
            hi[i] = w[i] & 0xF0F0F0F0u;
          }
          const uint32_t h0 = *reinterpret_cast<const uint32_t*>(xr + half);
          const uint32_t h1 = *reinterpret_cast<const uint32_t*>(xr + half + 16);
          int ch[4] = {0, 0, 0, 0}, ch1[4] = {0, 0, 0, 0};
          mma_s8(c, lo, b0, 0u);
          mma_s8(c1, lo, 0u, b1);
          mma_s8(ch, hi, h0, 0u);
          mma_s8(ch1, hi, 0u, h1);
          const int d0 = t == 0 ? c[0] : t == 1 ? c[2] : t == 2 ? ch[0] : ch[2];
          const int d1 = t == 0 ? c1[0] : t == 1 ? c1[2] : t == 2 ? ch1[0] : ch1[2];
          const int rb = (t < 2 ? 0 : half) + r;
          red_add_cluster(out + 4 * (j * G + rb / gs) * CR, d0 >> 4);
          red_add_cluster(out + 4 * (j * G + (rb + 16) / gs) * CR, d1 >> 4);
        }
      } else if constexpr (BITS == 8) {
        mma_s8(c, w, b0, b1);
        if (t < 2) red_add_cluster(out + 4 * (j * G + r / gs) * CR, t ? c[2] : c[0]);
      } else {
        uint32_t lo[4], hi[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          lo[i] = (w[i] << 4) & 0xF0F0F0F0u;  // 16 x the low nibble, signed
          hi[i] = w[i] & 0xF0F0F0F0u;         // 16 x the high nibble
        }
        int ch[4] = {0, 0, 0, 0};
        mma_s8(c, lo, b0, b1);
        mma_s8(ch, hi, *reinterpret_cast<const uint32_t*>(xr + half),
               *reinterpret_cast<const uint32_t*>(xr + half + 16));
        const int d = t == 0 ? c[0] : t == 1 ? c[2] : t == 2 ? ch[0] : ch[2];
        red_add_cluster(out + 4 * (j * G + ((t < 2 ? 0 : half) + r) / gs) * CR, d >> 4);
      }
    }
    ktt::cp_wait<0>();
  }
};

// Both kernels: zero the rank's dpart and arrive at the cluster barrier;
// copy the activation rows the rank needs and the scales of its columns
// (one copy group, ahead of the weights, so the rows do not queue behind
// them), then the first weight stages; wait (every rank's dpart is zero and
// its shared memory live) before the first store into another rank; then
// quantize, stream, and meet at the barrier again, after which each rank's
// dpart holds whole int32 group dots of its columns and no rank touches
// another's shared memory. VALID (K6a): a skipped pick's stage-1 cluster
// returns at once (its ranks share the pick), and stage 2 leaves the pick out.
template <int BITS, int COLS, bool VALID, bool G16>
__device__ __forceinline__ void stage1_body(const Args& A) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int NA = COLS / 2;  // a columns of a tile: NA gate + NA up weight columns
  const int ks = gridDim.z, z = blockIdx.z;
  const int p = blockIdx.y, tok = p / A.k;
  if constexpr (VALID)
    if (A.valid != nullptr && A.valid[p] == 0) return;
  const int n0 = blockIdx.x * NA;
  const int H = A.H, I = A.I, N = 2 * I, gs = A.gs13, G = H / gs;
  const int nb = (BITS == 4 ? H / 2 : H) / UNIT;
  const int cra = NA / ks;  // a columns this rank reduces: its dpart holds gate, then up
  const Layout L = layout(STAGES1, COLS, 1, G, H, COLS / ks, 1, 2 * H);
  Rank<BITS, COLS, STAGES1, false, G16> R{
      smem, (int*)(smem + L.dpart), (float*)(smem + L.scl), (int8_t*)(smem + L.xperm),
      smem + L.flags, (int)((long)nb * z / ks), (int)((long)nb * (z + 1) / ks), nb, H, gs, G,
      BITS == 4 ? H / 2 : 0, ks, 2 * cra, 0};
  const int e = A.idx[p];
  const int8_t* q = A.q13 + e * A.q13_es;
  const __nv_bfloat16* s = A.s13 + e * A.s13_es;
  auto src = [&](int, int row, int lc) {
    return q + (long)row * N + (lc < NA ? n0 + lc : I + n0 + lc - NA);
  };

  for (int i = threadIdx.x; i < G * 2 * cra; i += THREADS) R.dpart[i] = 0;
  for (int i = threadIdx.x; i < G; i += THREADS) R.flags[i] = 0;
  cluster_arrive();
  // the token's row (bf16 pairs), the scales of the rank's columns [g][gate, up][cra]
  __nv_bfloat16* xs = (__nv_bfloat16*)(smem + L.act);
  const __nv_bfloat16* xrow = A.x + tok * A.x_stride;
  for (int i = 2 * threadIdx.x; i < H; i += 2 * THREADS) cp_async4(xs + i, xrow + i);
  __nv_bfloat16* sws = (__nv_bfloat16*)(smem + L.sws);
  for (int i = threadIdx.x; i < G * cra; i += THREADS) {
    const int g = i / cra, h = (i % cra) / (cra / 2), c = 2 * (i % (cra / 2));
    cp_async4(sws + (g * 2 + h) * cra + c, s + (long)g * N + (h ? I : 0) + n0 + z * cra + c);
  }
  ktt::cp_commit();
  R.prologue(src);
  __syncthreads();
  R.mark();
  ktt::cp_wait<STAGES1 - 1>();
  __syncthreads();
  cluster_wait();
  R.quantize(1, [&](int, int i) { return __bfloat162float(xs[i]); });
  R.run(src, [&](int lc) {  // gate column lc < NA, up column lc - NA
    const int ac = lc < NA ? lc : lc - NA;
    return make_int2(ac / cra, (lc < NA ? 0 : cra) + ac % cra);
  });
  // the dependent launch (stage 2) may start
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  __syncthreads();
  cluster_arrive();
  cluster_wait();
  // h of the gate and up columns, groups in order
  float* hbuf = (float*)smem;
  for (int i = threadIdx.x; i < 2 * cra; i += THREADS) {
    const int h = i / cra, c = i % cra;
    float acc = 0.f;
    for (int g = 0; g < G; ++g)
      acc = __fadd_rn(acc, __fmul_rn(__fmul_rn((float)R.dpart[g * 2 * cra + i], R.scl[g]),
                                     __bfloat162float(sws[(g * 2 + h) * cra + c])));
    hbuf[i] = acc;
  }
  __syncthreads();
  for (int c = threadIdx.x; c < cra; c += THREADS)
    A.a[(long)p * I + n0 + z * cra + c] =
        ktt::mlp_act(hbuf[c], hbuf[cra + c], A.limit, A.gpt_oss != 0);
}

template <int BITS, int COLS, bool VALID, bool G16>
__device__ __forceinline__ void stage2_body(const Args& A) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int ks = gridDim.z, z = blockIdx.z;
  const int tok = blockIdx.y, k = A.k;
  const int n0 = blockIdx.x * COLS;
  const int H = A.H, I = A.I, gs = A.gs2, G = I / gs;
  const int nb = (BITS == 4 ? I / 2 : I) / UNIT, U = k * nb;
  const int cr = COLS / ks;  // output columns this rank reduces
  const int np = rank_picks(U, ks, nb, k);
  const Layout L = layout(STAGES2, COLS, k, G, I, cr, np, np * I * 4);
  const int u0 = (int)((long)U * z / ks), u1 = (int)((long)U * (z + 1) / ks);
  int* eidx = (int*)(smem + L.eidx);  // the picks' experts; -1: skipped (VALID)
  Rank<BITS, COLS, STAGES2, VALID, G16> R{smem, (int*)(smem + L.dpart), (float*)(smem + L.scl),
                                     (int8_t*)(smem + L.xperm), smem + L.flags, u0, u1,
                                     nb, I, gs, G, BITS == 4 ? I / 2 : 0, ks, cr, u0 / nb,
                                     eidx};
  auto src = [&](int j, int row, int lc) {
    return A.q2 + eidx[j] * A.q2_es + (long)row * H + n0 + lc;
  };

  // everything before the grid dependency wait reads only what was
  // written before stage 1
  for (int i = threadIdx.x; i < k * G * cr; i += THREADS) R.dpart[i] = 0;
  for (int i = threadIdx.x; i < k * G; i += THREADS) R.flags[i] = 0;
  for (int j = threadIdx.x; j < k; j += THREADS)
    eidx[j] = VALID && A.valid != nullptr && A.valid[tok * k + j] == 0 ? -1 : A.idx[tok * k + j];
  cluster_arrive();
  __syncthreads();
  __nv_bfloat16* sws = (__nv_bfloat16*)(smem + L.sws);  // [j][g][cr]
  for (int i = threadIdx.x; i < k * G * (cr / 2); i += THREADS) {
    const int jg = i / (cr / 2), c = 2 * (i % (cr / 2));
    if (R.live(jg / G))
      cp_async4(sws + jg * cr + c,
                A.s2 + eidx[jg / G] * A.s2_es + (long)(jg % G) * H + n0 + z * cr + c);
  }
  asm volatile("griddepcontrol.wait;\n" ::: "memory");  // stage 1's a is complete
  // the f32 hidden rows of the rank's picks R.j0 .. R.j0 + np - 1
  float* as = (float*)(smem + L.act);
  const float* arow = A.a + ((long)tok * k + R.j0) * I;
  const int n4 = (min(np, k - R.j0) * I) / 4;
  for (int i = threadIdx.x; i < n4; i += THREADS) ktt::cp_async16(as + 4 * i, arow + 4 * i, true);
  ktt::cp_commit();
  R.prologue(src);
  R.mark();
  ktt::cp_wait<STAGES2 - 1>();
  __syncthreads();
  cluster_wait();
  R.quantize(k, [&](int j, int i) { return as[(j - R.j0) * I + i]; });
  R.run(src, [&](int c) { return make_int2(c / cr, c % cr); });
  __syncthreads();
  cluster_arrive();
  cluster_wait();
  // each pick's output, groups in order; then the picks in order
  float* obuf = (float*)smem;  // [j][cr]
  for (int i = threadIdx.x; i < k * cr; i += THREADS) {
    const int j = i / cr, c = i % cr;
    if (!R.live(j)) continue;
    float o = 0.f;
    for (int g = 0; g < G; ++g)
      o = __fadd_rn(o, __fmul_rn(__fmul_rn((float)R.dpart[(j * G + g) * cr + c],
                                           R.scl[j * G + g]),
                                 __bfloat162float(sws[(j * G + g) * cr + c])));
    obuf[i] = o;
  }
  __syncthreads();
  for (int c = threadIdx.x; c < cr; c += THREADS) {
    float v = 0.f;
    for (int j = 0; j < k; ++j)
      if (R.live(j)) v = __fadd_rn(v, __fmul_rn(obuf[j * cr + c], A.wt[tok * k + j]));
    A.out[(long)tok * H + n0 + z * cr + c] = __float2bfloat16(v);
  }
}

// K3's kernels and K6a's, under their own names for the profiler; G16 for
// groups of a multiple of 16 rows that is not one of 32.
template <int BITS, int COLS, bool G16>
__global__ void __launch_bounds__(THREADS) w4a8_stage1_kernel(Args A) {
  stage1_body<BITS, COLS, false, G16>(A);
}
template <int BITS, int COLS, bool G16>
__global__ void __launch_bounds__(THREADS, 5) w4a8_stage2_kernel(Args A) {
  stage2_body<BITS, COLS, false, G16>(A);
}
template <int BITS, int COLS, bool G16>
__global__ void __launch_bounds__(THREADS) gq_a8_stage1_kernel(Args A) {
  stage1_body<BITS, COLS, true, G16>(A);
}
template <int BITS, int COLS, bool G16>
__global__ void __launch_bounds__(THREADS, 5) gq_a8_stage2_kernel(Args A) {
  stage2_body<BITS, COLS, true, G16>(A);
}

// K6a's product form, stage 1's copies and products on rows given as int8:
// a CTA per (COLS output columns, pick, rank). The rank stages the pick's
// row and every group's scale itself (no quantization, so nothing goes to
// the other ranks but the int32 dots), and stores the f32 sums of its
// columns. The shared memory is stage 1's layout with H = K.
template <int BITS, int COLS>
__global__ void __launch_bounds__(THREADS) gq_a8_product_kernel(Prod A) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int ks = gridDim.z, z = blockIdx.z, p = blockIdx.y;
  const int n0 = blockIdx.x * COLS;
  const int K = A.K, N = A.N, gs = A.gs, G = K / gs;
  const int cr = COLS / ks;  // output columns this rank reduces
  float* o = A.out + (long)p * N + n0 + z * cr;
  if (A.valid != nullptr && A.valid[p] == 0) {
    for (int c = threadIdx.x; c < cr; c += THREADS) o[c] = 0.f;
    return;
  }
  const int nb = (BITS == 4 ? K / 2 : K) / UNIT;
  const Layout L = layout(STAGES1, COLS, 1, G, K, cr, 1, 2 * K);
  Rank<BITS, COLS, STAGES1> R{smem, (int*)(smem + L.dpart), (float*)(smem + L.scl),
                              (int8_t*)(smem + L.xperm), smem + L.flags,
                              (int)((long)nb * z / ks), (int)((long)nb * (z + 1) / ks),
                              nb, K, gs, G, BITS == 4 ? K / 2 : 0, ks, cr, 0};
  const int e = A.idx[p];
  const int8_t* q = A.q + e * A.q_es;
  const __nv_bfloat16* s = A.s + e * A.s_es;
  auto src = [&](int, int row, int lc) { return q + (long)row * N + n0 + lc; };

  for (int i = threadIdx.x; i < G * cr; i += THREADS) R.dpart[i] = 0;
  cluster_arrive();
  // the pick's int8 row, its scales, the weight scales of the rank's columns [g][cr]
  int8_t* xs = (int8_t*)(smem + L.act);
  const int8_t* xrow = A.xq + (long)p * K;
  for (int i = 4 * threadIdx.x; i < K; i += 4 * THREADS) cp_async4(xs + i, xrow + i);
  for (int g = threadIdx.x; g < G; g += THREADS) cp_async4(R.scl + g, A.sx + (long)p * G + g);
  __nv_bfloat16* sws = (__nv_bfloat16*)(smem + L.sws);
  for (int i = threadIdx.x; i < G * (cr / 2); i += THREADS) {
    const int g = i / (cr / 2), c = 2 * (i % (cr / 2));
    cp_async4(sws + g * cr + c, s + (long)g * N + n0 + z * cr + c);
  }
  ktt::cp_commit();
  R.prologue(src);
  ktt::cp_wait<STAGES1 - 1>();
  __syncthreads();
  for (int i = threadIdx.x; i < K; i += THREADS) R.xperm[(i & ~31) + perm32(i & 31)] = xs[i];
  __syncthreads();
  cluster_wait();
  R.run(src, [&](int c) { return make_int2(c / cr, c % cr); });
  __syncthreads();
  cluster_arrive();
  cluster_wait();
  for (int c = threadIdx.x; c < cr; c += THREADS) {
    float acc = 0.f;
    for (int g = 0; g < G; ++g)
      acc = __fadd_rn(acc, __fmul_rn(__fmul_rn((float)R.dpart[g * cr + c], R.scl[g]),
                                     __bfloat162float(sws[g * cr + c])));
    o[c] = acc;
  }
}

// `configured`: the kernel's own flag, set once it may take MAX_SMEM.
// `dependent`: the launch may begin while the previous kernel on the stream
// runs (it waits for it with griddepcontrol.wait before reading its output).
template <typename P>
int launch(void (*kern)(P), bool& configured, const P& A, dim3 grid, int ks, int smem,
           bool dependent, cudaStream_t stream) {
  if (smem > MAX_SMEM) return (int)cudaErrorInvalidValue;
  if (!configured) {
    const cudaError_t e =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_SMEM);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[2];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = ks;
  attr[1].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[1].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = dependent ? 2 : 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kern, A);
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}

// Shared memory of a CTA of stage 1 or 2 (the layouts the kernels take;
// the product form takes stage 1's with H = K).
int smem_bytes(int stage, int bits, int cols, int ks, int k, int H, int I, int gs) {
  if (stage == 1) return layout(STAGES1, cols, 1, H / gs, H, cols / ks, 1, 2 * H).total;
  const int nb = (bits == 4 ? I / 2 : I) / UNIT, np = rank_picks(k * nb, ks, nb, k);
  return layout(STAGES2, cols, k, I / gs, I, cols / ks, np, np * I * 4).total;
}

template <int BITS, int COLS, bool K6A, bool G16>
int stage1(const Args& A, int ks, cudaStream_t st) {
  const int smem = smem_bytes(1, BITS, COLS, ks, A.k, A.H, A.I, A.gs13);
  static bool configured = false;
  return launch(K6A ? gq_a8_stage1_kernel<BITS, COLS, G16> : w4a8_stage1_kernel<BITS, COLS, G16>,
                configured, A, dim3(A.I / (COLS / 2), A.T * A.k, ks), ks, smem, false, st);
}

template <int BITS, int COLS, bool K6A, bool G16>
int stage2(const Args& A, int ks, cudaStream_t st) {
  const int smem = smem_bytes(2, BITS, COLS, ks, A.k, A.H, A.I, A.gs2);
  static bool configured = false;
  return launch(K6A ? gq_a8_stage2_kernel<BITS, COLS, G16> : w4a8_stage2_kernel<BITS, COLS, G16>,
                configured, A, dim3(A.H / COLS, A.T, ks), ks, smem, true, st);
}

template <int BITS, int COLS>
int product(const Prod& A, int P, int ks, cudaStream_t st) {
  const int smem = smem_bytes(1, BITS, COLS, ks, 1, A.K, 0, A.gs);
  static bool configured = false;
  return launch(gq_a8_product_kernel<BITS, COLS>, configured, A, dim3(A.N / COLS, P, ks), ks,
                smem, false, st);
}

// The instance of each launcher for `cols` (32, 64 or 128 columns a CTA).
template <int BITS, bool K6A, bool G16>
int stage1_cols(const Args& A, int cols, int ks, cudaStream_t st) {
  return cols == 128 ? stage1<BITS, 128, K6A, G16>(A, ks, st)
         : cols == 64 ? stage1<BITS, 64, K6A, G16>(A, ks, st)
                      : stage1<BITS, 32, K6A, G16>(A, ks, st);
}

template <int BITS, bool K6A, bool G16>
int stage2_cols(const Args& A, int cols, int ks, cudaStream_t st) {
  return cols == 128 ? stage2<BITS, 128, K6A, G16>(A, ks, st)
         : cols == 64 ? stage2<BITS, 64, K6A, G16>(A, ks, st)
                      : stage2<BITS, 32, K6A, G16>(A, ks, st);
}

// ... and for the stage's bits and group size
template <bool K6A>
int stage1_any(const Args& A, int bits, int cols, int ks, cudaStream_t st) {
  const bool g16 = A.gs13 % UNIT != 0;
  return bits == 4 ? (g16 ? stage1_cols<4, K6A, true> : stage1_cols<4, K6A, false>)(A, cols, ks, st)
                   : (g16 ? stage1_cols<8, K6A, true> : stage1_cols<8, K6A, false>)(A, cols, ks, st);
}

template <bool K6A>
int stage2_any(const Args& A, int bits, int cols, int ks, cudaStream_t st) {
  const bool g16 = A.gs2 % UNIT != 0;
  return bits == 4 ? (g16 ? stage2_cols<4, K6A, true> : stage2_cols<4, K6A, false>)(A, cols, ks, st)
                   : (g16 ? stage2_cols<8, K6A, true> : stage2_cols<8, K6A, false>)(A, cols, ks, st);
}

template <int BITS>
int product_cols(const Prod& A, int P, int cols, int ks, cudaStream_t st) {
  return cols == 128 ? product<BITS, 128>(A, P, ks, st)
         : cols == 64 ? product<BITS, 64>(A, P, ks, st)
                      : product<BITS, 32>(A, P, ks, st);
}

bool valid_split(int cols, int ks, int units) {
  return (cols == 32 || cols == 64 || cols == 128) && (ks == 1 || ks == 2 || ks == 4 || ks == 8) &&
         ks <= units;
}

// The two launches of K3 (K6A false) or of K6a's chain.
template <bool K6A>
int two_stages(const void* x, long x_stride, const void* idx, const void* wt, const void* q13,
               const void* s13, long q13_es, long s13_es, const void* q2, const void* s2,
               long q2_es, long s2_es, void* a, void* out, int T, int k, int H, int I,
               int bits13, int bits2, int gs13, int gs2, int cols1, int ks1, int cols2, int ks2,
               float limit, int gpt_oss, const void* valid, void* stream) {
  if (T < 1 || k < 1 || (bits13 != 4 && bits13 != 8) || (bits2 != 4 && bits2 != 8) ||
      gs13 % 16 || gs2 % 16 || H % gs13 || I % gs2 || H % 64 || I % 64 ||
      I % (cols1 / 2) || H % cols2 || T > 65535 || T * k > 65535)
    return (int)cudaErrorInvalidValue;
  const int nb13 = (bits13 == 4 ? H / 2 : H) / UNIT, nb2 = (bits2 == 4 ? I / 2 : I) / UNIT;
  if (!valid_split(cols1, ks1, nb13) || !valid_split(cols2, ks2, k * nb2) ||
      cols1 / 2 / ks1 < 2)
    return (int)cudaErrorInvalidValue;
  Args A{(const __nv_bfloat16*)x, x_stride, (const int*)idx, (const float*)wt,
         (const int8_t*)q13, (const __nv_bfloat16*)s13, q13_es, s13_es,
         (const int8_t*)q2, (const __nv_bfloat16*)s2, q2_es, s2_es,
         (float*)a, (__nv_bfloat16*)out, T, k, H, I, gs13, gs2, limit, gpt_oss,
         (const int*)valid};
  cudaStream_t st = (cudaStream_t)stream;
  const int err = stage1_any<K6A>(A, bits13, cols1, ks1, st);
  if (err) return err;
  return stage2_any<K6A>(A, bits2, cols2, ks2, st);
}

}  // namespace

#if IN_PART(0)
// K3: out[T, H] (bf16) from x[T, H] (bf16, rows x_stride elements apart),
// the picks idx / wt [T * k] (int32 / f32) and the expert stacks q13
// [E, H(/2), 2I], s13 [E, H/gs13, 2I], q2 [E, I(/2), H], s2 [E, I/gs2, H]
// (experts q*_es / s*_es elements apart), through the f32 scratch a
// [T * k, I]. The plan (ops/moe_cuda.py plan_w4a8) gives each stage's
// columns a CTA (32, 64 or 128) and cluster size. Two launches on `stream`;
// returns the first cudaError_t.
extern "C" int moe_w4a8_launch(const void* x, long x_stride, const void* idx, const void* wt,
                               const void* q13, const void* s13, long q13_es, long s13_es,
                               const void* q2, const void* s2, long q2_es, long s2_es, void* a,
                               void* out, int T, int k, int H, int I, int bits13, int bits2,
                               int gs13, int gs2, int cols1, int ks1, int cols2, int ks2,
                               float limit, int gpt_oss, void* stream) {
  return two_stages<false>(x, x_stride, idx, wt, q13, s13, q13_es, s13_es, q2, s2, q2_es, s2_es,
                           a, out, T, k, H, I, bits13, bits2, gs13, gs2, cols1, ks1, cols2, ks2,
                           limit, gpt_oss, nullptr, stream);
}

// The shared memory a CTA of `stage` (1 or 2) takes under a plan: what the
// plan (ops/moe_cuda.py plan_w4a8) must fit in 227 KB.
extern "C" int moe_w4a8_smem(int stage, int bits, int cols, int ks, int k, int H, int I, int gs) {
  return smem_bytes(stage, bits, cols, ks, k, H, I, gs);
}
#endif

#if IN_PART(1)
// K6a's chain, moe_gathered_tiled(activation="int8"): K3's call with the
// pick flags valid [T * k] (int32, or null for every pick).
extern "C" int gq_a8_launch(const void* x, long x_stride, const void* idx, const void* wt,
                            const void* q13, const void* s13, long q13_es, long s13_es,
                            const void* q2, const void* s2, long q2_es, long s2_es, void* a,
                            void* out, int T, int k, int H, int I, int bits13, int bits2,
                            int gs13, int gs2, int cols1, int ks1, int cols2, int ks2,
                            float limit, int gpt_oss, const void* valid, void* stream) {
  return two_stages<true>(x, x_stride, idx, wt, q13, s13, q13_es, s13_es, q2, s2, q2_es, s2_es,
                          a, out, T, k, H, I, bits13, bits2, gs13, gs2, cols1, ks1, cols2, ks2,
                          limit, gpt_oss, valid, stream);
}

// K6a's product form: out[P, N] (f32) from the int8 rows xq [P, K] (4-byte
// aligned), their scales sx [P, K/gs] (f32), the experts idx [P], the flags
// valid [P] (or null) and the stack q [E, K(/2), N], s [E, K/gs, N]. The
// plan (ops/moe_cuda.py plan_gq_a8) gives the columns a CTA and the cluster
// size. One launch on `stream`; returns its cudaError_t.
extern "C" int gq_a8_product_launch(const void* xq, const void* sx, const void* idx,
                                    const void* valid, const void* q, const void* s, long q_es,
                                    long s_es, void* out, int P, int K, int N, int bits, int gs,
                                    int cols, int ks, void* stream) {
  const int packed = bits == 4 ? K / 2 : K;
  if (P < 1 || P > 65535 || (bits != 4 && bits != 8) || gs % UNIT || K % gs || packed % UNIT ||
      N % cols || !valid_split(cols, ks, packed / UNIT) || cols / ks < 2)
    return (int)cudaErrorInvalidValue;
  Prod A{(const int8_t*)xq, (const float*)sx, (const int*)idx, (const int*)valid,
         (const int8_t*)q, (const __nv_bfloat16*)s, q_es, s_es, (float*)out, K, N, gs};
  cudaStream_t st = (cudaStream_t)stream;
  return bits == 4 ? product_cols<4>(A, P, cols, ks, st) : product_cols<8>(A, P, cols, ks, st);
}
#endif
