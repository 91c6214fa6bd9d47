// K1 — dequant-fused quantized matmul for few rows:
//   out[T, N] = x[T, K] (bf16) @ dequant(W)[K, N], one rounding to out's type,
// with W int4 (split-half packed [K/2, N]) or int8 ([K, N]) and bf16 group
// scales [K/gs, N], T <= 16.
//
// K1s, the stacked entry, is the same kernel over one layer of a
// [L, K(/2), N] stack: it is handed the base pointers of the q and scales
// stacks, their layer strides and the layer index, and offsets inside the
// kernel, so a layer is read in place and no per-layer copy exists. A
// single [K, N] weight is the stack of one layer.
//
// Replaces: krasis_tpu/ops/qmm_pallas.py qmm_pallas (_kernel_int4 and
// _kernel_int8) and qmm_stacked_pallas (_kernel_int4_st, _kernel_int8_st).
// Numerics as there: each weight is dequantized as bf16(f32(q) * scale),
// multiplied by the bf16 activation with f32 accumulation, and the sum is
// rounded once to the output type.
//
// What bounds it on the H100: bytes. At T <= 16 the kernel does at most 32
// operations per weight byte (int8), far below the ~295 per byte where the
// tensor cores would bind, so the time is the packed weight bytes over
// 3.35 TB/s, and the design is about keeping HBM busy with few
// instructions per byte:
//  * a CTA owns 128 output columns (4 warps x 32) and one of ks contiguous
//    ranges of packed rows, split on group boundaries; the ks CTAs of a
//    column tile form one thread-block cluster (ks = 1, 2, 4 or 8);
//  * packed weight rows stream through a 4-stage cp.async ring, 16 bytes
//    a thread (4-byte copies where N is not a multiple of 16 or the layer
//    base is not 16-byte aligned), 64 or 128 rows a stage with the
//    matching x columns (bf16, T rows, zero past T) and scale rows, so 3
//    stages are in flight while one is used and no load waits in the
//    product loop;
//  * the product runs on mma.sync m16n8k16 with the weights as A: the
//    output columns are the 16 rows of A, x's rows the 8 (T <= 8) or 16
//    columns of B. ldmatrix.trans of the packed bytes gives each thread
//    the k pairs (2t, 2t+1) and (2t+8, 2t+9) of columns 2g and 2g+1, which
//    are A fragments once two values become exact bf16 integers and one
//    bf16 multiply by the scale rounds the product (ktt::deq_pair). That
//    is ~2 instructions per int8 value and no FMA per row of x; a warp
//    takes two 16-column blocks, so x's fragments and the scale checks of
//    a k step serve 16 bytes a thread;
//  * int4: each packed byte gives rows r and r + K/2 (low and high
//    nibble), with x's columns r and r + K/2 and each row's own group
//    scale, so every packed byte is read once;
//  * each stage carries the scale rows of the groups its rows reach (a
//    group of 128 rows rides with two 64-row stages); each thread keeps
//    its columns' scales of the current group in registers and reads the
//    stage's copy only when a row crosses a group boundary;
//  * split K meets on the chip: each CTA of a cluster leaves its [T, 128]
//    f32 partial in shared memory, and each CTA sums a slice of the
//    columns over the cluster's ranks in rank order through distributed
//    shared memory and writes out[T, N] in the output type. The sum's order
//    is fixed, so the result is the same bits from run to run, and a call
//    is one launch.
#include <cooperative_groups.h>
#include <stdint.h>

#include "int4.cuh"
#include "mma.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;
constexpr int CB = 2;              // 16-column blocks of a warp
constexpr int WCOLS = 16 * CB;     // output columns of a warp
constexpr int NC = WARPS * WCOLS;  // output columns of a CTA: 128
constexpr int STAGES = 4;
constexpr int LDB = NC + 16;  // byte pitch of a staged weight row (ldmatrix without conflicts)
constexpr int XPAD = 8;       // bf16 pad of a staged x row
constexpr int MAX_SMEM = 227 * 1024;

// Group rows of scales a stage may touch per half: its pk rows span at
// most (pk + gs - 1) / gs + 1 groups.
__host__ __device__ constexpr int scale_rows(int pk, int gs) { return (pk + gs - 1) / gs + 1; }

// A stage: pk packed weight rows (LDB bytes each), then x (each half's TT
// rows of pk bf16 columns, padded), then the scale rows (each half's
// scale_rows x 128 bf16).
__host__ __device__ constexpr int stage_bytes(int pk, int tt, int halves, int gs) {
  return pk * LDB + halves * tt * (pk + XPAD) * 2 + halves * scale_rows(pk, gs) * NC * 2;
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool pred) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(ktt::smem_u32(dst)),
               "l"(src), "r"(pred ? 4 : 0));
}

template <typename OT>
__device__ __forceinline__ void store2(OT* o, float a, float b);
template <>
__device__ __forceinline__ void store2<float>(float* o, float a, float b) {
  *reinterpret_cast<float2*>(o) = make_float2(a, b);
}
template <>
__device__ __forceinline__ void store2<__nv_bfloat16>(__nv_bfloat16* o, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(o) = __floats2bfloat162_rn(a, b);
}
__device__ __forceinline__ void store1(float* o, float a) { *o = a; }
__device__ __forceinline__ void store1(__nv_bfloat16* o, float a) { *o = __float2bfloat16(a); }

// TT: T rounded up to 1, 2, 4, 8 or 16. Packed rows [r0, r1) of split z
// are units [z * units / ks, (z + 1) * units / ks) of `unit` rows each.
template <int TT, int BITS, typename OT>
__global__ void __launch_bounds__(THREADS)
qmm_kernel(const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ q,
           const __nv_bfloat16* __restrict__ s, OT* __restrict__ out, int T, int K, int N,
           int gs, int unit, int ks, int pk, long q_lstride, long s_lstride, int layer,
           int x_vec) {
  constexpr bool IS4 = BITS == 4;
  constexpr int HALVES = IS4 ? 2 : 1;
  constexpr int NT = TT > 8 ? 2 : 1;  // n8 tiles of x rows
  extern __shared__ __align__(128) unsigned char smem[];
  q += layer * q_lstride;
  s += layer * s_lstride;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int n0 = blockIdx.x * NC;
  const int rows = IS4 ? K / 2 : K;  // packed rows
  const int khalf = K / 2;
  const int units = rows / unit;
  const int z = blockIdx.z;
  const int r0 = (int)((long)units * z / ks) * unit;
  const int r1 = (int)((long)units * (z + 1) / ks) * unit;
  const int steps = (r1 - r0 + pk - 1) / pk;
  const int sbytes = stage_bytes(pk, TT, HALVES, gs);
  const int xp = pk + XPAD;
  const int sg = scale_rows(pk, gs);
  const int xbytes = HALVES * TT * xp * 2;
  const bool w16 = (N % 16 == 0) && ((reinterpret_cast<uintptr_t>(q) & 15) == 0);
  const bool s16 = (N % 8 == 0) && ((reinterpret_cast<uintptr_t>(s) & 15) == 0);
  // the first group of a stage's rows, per half
  auto group0 = [&](int h, int p0) { return min((h ? khalf : 0) + p0, K - 1) / gs; };

  auto load_stage = [&](int j, int st) {
    unsigned char* base = smem + st * sbytes;
    const int p0 = r0 + j * pk;
    if (w16) {
      for (int c = tid; c < pk * (NC / 16); c += THREADS) {
        const int r = c / (NC / 16), cc = (c % (NC / 16)) * 16;
        const bool ok = p0 + r < r1 && n0 + cc < N;
        ktt::cp_async16(base + r * LDB + cc, ok ? q + (long)(p0 + r) * N + n0 + cc : q, ok);
      }
    } else {  // the tail form: 4 columns a copy
      for (int c = tid; c < pk * (NC / 4); c += THREADS) {
        const int r = c / (NC / 4), cc = (c % (NC / 4)) * 4;
        const bool ok = p0 + r < r1 && n0 + cc < N;
        cp_async4(base + r * LDB + cc, ok ? q + (long)(p0 + r) * N + n0 + cc : q, ok);
      }
    }
    // x: for each half, TT rows of the stage's pk columns; zero past T
    // and past r1
    __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(base + pk * LDB);
    if (x_vec) {
      const int per_row = pk / 8;
      for (int c = tid; c < HALVES * TT * per_row; c += THREADS) {
        const int hr = c / per_row, k8 = (c % per_row) * 8;
        const int h = hr / TT, row = hr % TT;
        const bool ok = row < T && p0 + k8 < r1;
        const __nv_bfloat16* src = x + (long)row * K + (h ? khalf : 0) + p0 + k8;
        ktt::cp_async16(xs + hr * xp + k8, ok ? src : x, ok);
      }
    } else {  // x not 16-byte aligned: element by element
      for (int c = tid; c < HALVES * TT * pk; c += THREADS) {
        const int hr = c / pk, k = c % pk;
        const int h = hr / TT, row = hr % TT;
        const bool ok = row < T && p0 + k < r1;
        xs[hr * xp + k] = ok ? x[(long)row * K + (h ? khalf : 0) + p0 + k] : __float2bfloat16(0.f);
      }
    }
    // scales: each half's group rows from the stage's first row on, 128
    // columns (16-byte copies, or 4-byte ones in the tail form)
    __nv_bfloat16* ss = reinterpret_cast<__nv_bfloat16*>(base + pk * LDB + xbytes);
    const int per = s16 ? NC / 8 : NC / 2;
    for (int c = tid; c < HALVES * sg * per; c += THREADS) {
      const int hg = c / per, h = hg / sg, grp = group0(h, p0) + hg % sg;
      const int cc = (c % per) * (s16 ? 8 : 2);
      const bool ok = grp < K / gs && n0 + cc < N;
      const __nv_bfloat16* src = ok ? s + (long)grp * N + n0 + cc : s;
      if (s16)
        ktt::cp_async16(ss + hg * NC + cc, src, ok);
      else
        cp_async4(ss + hg * NC + cc, src, ok);
    }
  };

  // this thread's columns: 2g and 2g+1 of each of the warp's two 16-column
  // blocks; their scales for the current group of each half and k-row set
  // (2t.. or 2t+8..), as pairs (even, odd column)
  const int wcol = warp * WCOLS;
  __nv_bfloat162 sc_e[HALVES][2][CB], sc_o[HALVES][2][CB];
  int bound[HALVES][2];
#pragma unroll
  for (int h = 0; h < HALVES; ++h)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      bound[h][i] = -1;
#pragma unroll
      for (int cb = 0; cb < CB; ++cb) sc_e[h][i][cb] = sc_o[h][i][cb] = __float2bfloat162_rn(0.f);
    }
  // k: a row of W in the stage at `ss` whose first row is p0
  auto scales_at = [&](int h, int i, int k, const __nv_bfloat16* ss, int p0) {
    if (k >= bound[h][i]) {
      const int grp = min(k, K - 1) / gs;
      bound[h][i] = (grp + 1) * gs;
      const __nv_bfloat16* row = ss + (h * sg + grp - group0(h, p0)) * NC + wcol + 2 * g;
#pragma unroll
      for (int cb = 0; cb < CB; ++cb) {
        const __nv_bfloat162 p = *reinterpret_cast<const __nv_bfloat162*>(row + 16 * cb);
        sc_e[h][i][cb] = __low2bfloat162(p);
        sc_o[h][i][cb] = __high2bfloat162(p);
      }
    }
  };

  float acc[CB][NT][4];
#pragma unroll
  for (int cb = 0; cb < CB; ++cb)
#pragma unroll
    for (int n = 0; n < NT; ++n) acc[cb][n][0] = acc[cb][n][1] = acc[cb][n][2] = acc[cb][n][3] = 0.f;

#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < steps) load_stage(st, st);
    ktt::cp_commit();
  }
  for (int j = 0; j < steps; ++j) {
    ktt::cp_wait<STAGES - 2>();
    __syncthreads();
    if (j + STAGES - 1 < steps) load_stage(j + STAGES - 1, (j + STAGES - 1) % STAGES);
    ktt::cp_commit();
    const unsigned char* base = smem + (j % STAGES) * sbytes;
    const __nv_bfloat16* xs = reinterpret_cast<const __nv_bfloat16*>(base + pk * LDB);
    const __nv_bfloat16* ss = reinterpret_cast<const __nv_bfloat16*>(base + pk * LDB + xbytes);
    const int p0 = r0 + j * pk;
    for (int u = 0; u < pk; u += 32) {
      // per column block: k rows u + 0-7, 8-15, 16-23, 24-31
      uint32_t wr[CB][4];
#pragma unroll
      for (int cb = 0; cb < CB; ++cb)
        ktt::ldsm_x4_t(wr[cb], base + (u + lane) * LDB + wcol + 16 * cb);
#pragma unroll
      for (int s2 = 0; s2 < 2; ++s2) {
        const int kk = u + 16 * s2;
#pragma unroll
        for (int h = 0; h < HALVES; ++h) {
          const int k = (h ? khalf : 0) + p0 + kk + 2 * t;
          scales_at(h, 0, k, ss, p0);
          scales_at(h, 1, k + 8, ss, p0);
          uint32_t b[NT][2];
#pragma unroll
          for (int n = 0; n < NT; ++n) {
            const int row = 8 * n + g;
            b[n][0] = b[n][1] = 0u;
            if (row < TT) {
              const __nv_bfloat16* xr = xs + (h * TT + row) * xp + kk + 2 * t;
              b[n][0] = *reinterpret_cast<const uint32_t*>(xr);
              b[n][1] = *reinterpret_cast<const uint32_t*>(xr + 8);
            }
          }
#pragma unroll
          for (int cb = 0; cb < CB; ++cb) {
            uint32_t a[4];
            a[0] = ktt::deq_pair<IS4>(wr[cb][2 * s2], 0, h, sc_e[h][0][cb]);
            a[1] = ktt::deq_pair<IS4>(wr[cb][2 * s2], 1, h, sc_o[h][0][cb]);
            a[2] = ktt::deq_pair<IS4>(wr[cb][2 * s2 + 1], 0, h, sc_e[h][1][cb]);
            a[3] = ktt::deq_pair<IS4>(wr[cb][2 * s2 + 1], 1, h, sc_o[h][1][cb]);
#pragma unroll
            for (int n = 0; n < NT; ++n) ktt::mma_bf16(acc[cb][n], a, b[n][0], b[n][1]);
          }
        }
      }
    }
  }
  ktt::cp_wait<0>();

  // Thread (g, t) holds, per column block cb and n8 tile n, rows
  // 8n + 2t + {0, 1} of columns wcol + 16 cb + 2g (c0, c1) and the next (c2, c3).
  if (ks == 1) {
#pragma unroll
    for (int cb = 0; cb < CB; ++cb) {
      const int col = n0 + wcol + 16 * cb + 2 * g;
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          const int row = 8 * n + 2 * t + rr;
          if (row < T && col < N)
            store2(out + (long)row * N + col, acc[cb][n][rr], acc[cb][n][2 + rr]);
        }
    }
    return;
  }
  __syncthreads();  // every warp is done with the ring: it becomes the partial
  float* red = reinterpret_cast<float*>(smem);  // [TT][NC]
#pragma unroll
  for (int cb = 0; cb < CB; ++cb)
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const int row = 8 * n + 2 * t + rr;
        if (row < TT) {
          float* r = red + row * NC + wcol + 16 * cb + 2 * g;
          r[0] = acc[cb][n][rr];
          r[1] = acc[cb][n][2 + rr];
        }
      }
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  const int rank = (int)cluster.block_rank();
  const int cw = NC / ks;  // this CTA sums columns [rank * cw, (rank + 1) * cw)
  for (int e = tid; e < T * cw; e += THREADS) {
    const int row = e / cw, c = rank * cw + e % cw;
    float part[8];  // every rank's value in flight at once, summed in rank order
#pragma unroll
    for (int r = 0; r < 8; ++r)
      part[r] = r < ks ? cluster.map_shared_rank(red, r)[row * NC + c] : 0.f;
    float v = 0.f;
#pragma unroll
    for (int r = 0; r < 8; ++r)
      if (r < ks) v += part[r];
    if (n0 + c < N) store1(out + (long)row * N + n0 + c, v);
  }
  cluster.sync();  // no CTA leaves while another reads its partial
}

template <int TT, int BITS, typename OT>
int launch(const void* x, const void* q, const void* s, void* out, int T, int K, int N, int gs,
           int unit, int ks, int pk, long q_lstride, long s_lstride, int layer, int x_vec,
           cudaStream_t stream) {
  auto kern = qmm_kernel<TT, BITS, OT>;
  constexpr int HALVES = BITS == 4 ? 2 : 1;
  static bool configured = false;  // the largest ring a block may take
  if (!configured) {
    const cudaError_t e =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_SMEM);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  int smem = STAGES * stage_bytes(pk, TT, HALVES, gs);
  if (smem > MAX_SMEM) return (int)cudaErrorInvalidValue;
  if (smem < TT * NC * 4) smem = TT * NC * 4;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((N + NC - 1) / NC, 1, ks);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = ks;
  cfg.attrs = attr;
  cfg.numAttrs = ks > 1 ? 1 : 0;
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, kern, (const __nv_bfloat16*)x, (const int8_t*)q, (const __nv_bfloat16*)s, (OT*)out,
      T, K, N, gs, unit, ks, pk, q_lstride, s_lstride, layer, x_vec);
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}

template <int TT>
int launch_tt(int bits, int out_f32, const void* x, const void* q, const void* s, void* out,
              int T, int K, int N, int gs, int unit, int ks, int pk, long ql, long sl,
              int layer, int x_vec, cudaStream_t st) {
  if (bits == 4)
    return out_f32 ? launch<TT, 4, float>(x, q, s, out, T, K, N, gs, unit, ks, pk, ql, sl, layer,
                                          x_vec, st)
                   : launch<TT, 4, __nv_bfloat16>(x, q, s, out, T, K, N, gs, unit, ks, pk, ql,
                                                  sl, layer, x_vec, st);
  return out_f32 ? launch<TT, 8, float>(x, q, s, out, T, K, N, gs, unit, ks, pk, ql, sl, layer,
                                        x_vec, st)
                 : launch<TT, 8, __nv_bfloat16>(x, q, s, out, T, K, N, gs, unit, ks, pk, ql, sl,
                                                layer, x_vec, st);
}

}  // namespace

// out[T, N] (bf16, or f32 with out_f32) = x[T, K] @ dequant(layer `layer`
// of the [L, K(/2), N] q and [L, K/gs, N] scales stacks, whose layers lie
// q_lstride and s_lstride elements apart). The plan (ops/qmm_cuda.py plan)
// gives the split unit, the cluster size ks <= 8 and the stage depth pk
// (64 or 128 packed rows). One launch; returns the cudaError_t.
extern "C" int qmm_launch(const void* x, const void* q, const void* s, void* out, int T, int K,
                          int N, int bits, int gs, int unit, int ks, int pk, long q_lstride,
                          long s_lstride, int layer, int out_f32, int x_vec, void* stream) {
  if (T < 1 || T > 16 || (bits != 4 && bits != 8) || ks < 1 || ks > 8 || pk % 32 || pk > 128)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (T == 1)
    return launch_tt<1>(bits, out_f32, x, q, s, out, T, K, N, gs, unit, ks, pk, q_lstride,
                        s_lstride, layer, x_vec, st);
  if (T <= 2)
    return launch_tt<2>(bits, out_f32, x, q, s, out, T, K, N, gs, unit, ks, pk, q_lstride,
                        s_lstride, layer, x_vec, st);
  if (T <= 4)
    return launch_tt<4>(bits, out_f32, x, q, s, out, T, K, N, gs, unit, ks, pk, q_lstride,
                        s_lstride, layer, x_vec, st);
  if (T <= 8)
    return launch_tt<8>(bits, out_f32, x, q, s, out, T, K, N, gs, unit, ks, pk, q_lstride,
                        s_lstride, layer, x_vec, st);
  return launch_tt<16>(bits, out_f32, x, q, s, out, T, K, N, gs, unit, ks, pk, q_lstride,
                       s_lstride, layer, x_vec, st);
}
