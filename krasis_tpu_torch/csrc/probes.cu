// Probe kernels: the H100 counterparts of the TPU probes in
// benchmarks/probe_int4_mxu.py. They run on no serving path; each answers
// one question about this card, and every sum in them is of small
// integers, so each equals its plain version (ops/probes_cuda.py) exactly.
//
// P4 — colsum_kernel<RAW> (stream_once, pallas_call at :114): the column
//   sums of the packed w13 and w2 bytes of the k picked experts, as signed
//   bytes, into f32 [H]: out[c] = Σ_p Σ_r q13[e_p, r, c] + q2[e_p, r, c]
//   (c < H; w13's columns past H are summed as well and reach `spill` only
//   when a caller passes one, so every byte is loaded). The gathered decode
//   pattern's bandwidth floor: bound by bytes (k x 4.33 MB at V2-Lite's
//   expert shapes). Design: each warp reads 512 contiguous bytes of a row,
//   16 a thread (uint4, no L1 allocation), 8 rows in flight per warp; the 8
//   warps of a CTA walk 64 rows at a time over 128 rows of one pick and one
//   512-column group, reduce their int32 sums through shared memory, and
//   add one float per column with atomicAdd: every partial and every total
//   is an integer below 2^24, so f32 adds are exact in any order.
// P8 — colsum_kernel<MASKXOR | SHIFT> (unpack_once, pallas_call at :223):
//   one expert's packed w13 [K/2, N] unpacked to int8 [K, N] — each nibble
//   sign-extended by ((b & 0xF) ^ 8) - 8 or by two shifts — and column-summed
//   into f32 [N]. Same streaming design, 64 rows a CTA.
// P5 / P6 — int4_dot_kernel (try_int4_pallas :152, try_int4_pallas_cast
//   :171): int8 x [M ≤ 16, K] · int4 w [K, N] → int32, w in the quantizer's
//   split-half layout q [K/2, N] (low nibble row r, high nibble row r + K/2).
//   S4 (P5) feeds the packed nibbles to mma.sync m16n8k64 .s4.s4 as they
//   lie: a B register is the 4 bytes q[j..j+3, n] (8 nibbles, k = j.. and
//   K/2 + j..), and x is packed in registers in the same split-half order,
//   so the product pairs the same k on both sides; valid only for x in
//   [-8, 7] (the wrapper checks). S8 (P6) unpacks the nibbles to s8 in
//   registers and runs mma.sync m16n8k32 .s8.s8. One warp per 8 columns.
// P7 — int4_view_kernel (try_bitcast, pallas_call at :192): the shape of a
//   byte block [R, N] seen as int4 [2R, N]: each thread reads one element
//   through that view and the largest row and column read (+1) are the
//   shape, int32 [2].
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int WARP_COLS = 512;      // 32 lanes x 16 bytes
constexpr int BATCH = 8;            // rows a warp has in flight

enum ColsumMode { RAW = 0, MASKXOR = 1, SHIFT = 2 };

struct Seg {        // a [rows, N] byte matrix of each pick: q + e * estride
  const int8_t* q;
  long estride;
  int rows, N;
  int n_keep;       // columns below n_keep add into out, the others into spill
  int rows_per_cta;
};

__device__ __forceinline__ uint4 load_stream(const void* p) {
  uint4 v;
  asm volatile("ld.global.nc.L1::no_allocate.v4.u32 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "l"(p));
  return v;
}

template <int MODE>
__device__ __forceinline__ void add_word(uint32_t w, int* acc) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if constexpr (MODE == RAW) {
      acc[i] += (int)(int8_t)(w >> (8 * i));
    } else if constexpr (MODE == MASKXOR) {
      const int b = (int)((w >> (8 * i)) & 0xFFu);
      acc[i] += (((b & 0xF) ^ 8) - 8) + ((((b >> 4) & 0xF) ^ 8) - 8);
    } else {
      acc[i] += ((int)(w << (28 - 8 * i)) >> 28) + ((int)(w << (24 - 8 * i)) >> 28);
    }
  }
}

// blockIdx.x walks segment a's (row block, column group) pairs, then b's;
// blockIdx.y is the pick.
template <int MODE>
__global__ void __launch_bounds__(THREADS)
colsum_kernel(Seg a, Seg b, int blocks_a, const int* __restrict__ eids,
              float* __restrict__ out, float* __restrict__ spill) {
  int bx = blockIdx.x;
  const bool first = bx < blocks_a;
  const Seg sg = first ? a : b;
  if (!first) bx -= blocks_a;
  const int ncg = (sg.N + WARP_COLS - 1) / WARP_COLS;
  const int cg = bx % ncg, rb = bx / ncg;
  const int8_t* base = sg.q + (eids ? (long)eids[blockIdx.y] * sg.estride : 0L);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int c0 = cg * WARP_COLS + lane * 16;   // this thread's 16 columns
  const int r0 = rb * sg.rows_per_cta;
  const int r1 = min(r0 + sg.rows_per_cta, sg.rows);
  int acc[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) acc[i] = 0;
  if (c0 < sg.N) {
    for (int rr = r0; rr < r1; rr += WARPS * BATCH) {
      uint4 v[BATCH];
#pragma unroll
      for (int i = 0; i < BATCH; ++i) {
        const int r = rr + warp + i * WARPS;
        v[i] = r < r1 ? load_stream(base + (long)r * sg.N + c0) : make_uint4(0u, 0u, 0u, 0u);
      }
#pragma unroll
      for (int i = 0; i < BATCH; ++i) {   // a zero byte adds 0 in every mode
        add_word<MODE>(v[i].x, acc);
        add_word<MODE>(v[i].y, acc + 4);
        add_word<MODE>(v[i].z, acc + 8);
        add_word<MODE>(v[i].w, acc + 12);
      }
    }
  }
  // column lane * 16 + i of the group sits at red[w][i * 32 + lane]
  __shared__ int red[WARPS][WARP_COLS];
#pragma unroll
  for (int i = 0; i < 16; ++i) red[warp][i * 32 + lane] = acc[i];
  __syncthreads();
  for (int c = threadIdx.x; c < WARP_COLS; c += THREADS) {
    const int col = cg * WARP_COLS + c;
    if (col >= sg.N) continue;
    int sum = 0;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) sum += red[w][(c % 16) * 32 + c / 16];
    if (col < sg.n_keep) atomicAdd(out + col, (float)sum);
    else if (spill != nullptr) atomicAdd(spill + col, (float)sum);
  }
}

int blocks_of(const Seg& s) {
  return ((s.rows + s.rows_per_cta - 1) / s.rows_per_cta) * ((s.N + WARP_COLS - 1) / WARP_COLS);
}

// 4 bytes q[r..r+3, n] of one column, byte i from row r + i.
__device__ __forceinline__ uint32_t column_word(const uint8_t* q, int N, int r, int n) {
  return (uint32_t)q[(long)r * N + n] | ((uint32_t)q[(long)(r + 1) * N + n] << 8) |
         ((uint32_t)q[(long)(r + 2) * N + n] << 16) | ((uint32_t)q[(long)(r + 3) * N + n] << 24);
}

__device__ __forceinline__ uint32_t x_word(const int8_t* x, int M, int K, int row, int k) {
  return row < M ? *reinterpret_cast<const uint32_t*>(x + (long)row * K + k) : 0u;
}

// Four s8 values from the low (h = 0) or high (h = 1) nibbles of 4 bytes.
__device__ __forceinline__ uint32_t nibbles_s8(uint32_t w, int h) {
  const uint32_t n = ((w >> (4 * h)) & 0x0F0F0F0Fu) ^ 0x08080808u;
  return __vsub4(n, 0x08080808u);
}

template <bool S4>
__global__ void __launch_bounds__(THREADS)
int4_dot_kernel(const int8_t* __restrict__ x, const uint8_t* __restrict__ q,
                int* __restrict__ out, int M, int K, int N) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int n0 = (blockIdx.x * WARPS + warp) * 8;
  if (n0 >= N) return;
  const int n = n0 + g;
  const int half = K / 2;
  int c[4] = {0, 0, 0, 0};
  if constexpr (S4) {
    // 32 packed rows (64 k values) a step: element 2i of a register is the
    // low nibble (k = j + i), element 2i + 1 the high one (k = K/2 + j + i)
    for (int j0 = 0; j0 < half; j0 += 32) {
      uint32_t a[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int row = g + 8 * (r & 1);
        const int k = j0 + 16 * (r >> 1) + 4 * t;
        const uint32_t lo = x_word(x, M, K, row, k), hi = x_word(x, M, K, row, half + k);
        a[r] = (lo & 0x0F0F0F0Fu) | ((hi & 0x0F0F0F0Fu) << 4);
      }
      const uint32_t b0 = column_word(q, N, j0 + 4 * t, n);
      const uint32_t b1 = column_word(q, N, j0 + 16 + 4 * t, n);
      asm volatile(
          "mma.sync.aligned.m16n8k64.row.col.s32.s4.s4.s32 {%0,%1,%2,%3}, "
          "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
          : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
          : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
    }
  } else {
    // 32 k values a step, all in one half of the packed rows
    for (int k0 = 0; k0 < K; k0 += 32) {
      const int h = k0 >= half;
      const int j0 = k0 - h * half;
      uint32_t a[4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
        a[r] = x_word(x, M, K, g + 8 * (r & 1), k0 + 16 * (r >> 1) + 4 * t);
      const uint32_t b0 = nibbles_s8(column_word(q, N, j0 + 4 * t, n), h);
      const uint32_t b1 = nibbles_s8(column_word(q, N, j0 + 16 + 4 * t, n), h);
      asm volatile(
          "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, "
          "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
          : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
          : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
    }
  }
  // c0, c1 = rows g, columns n0 + 2t, +1; c2, c3 = row g + 8
  if (g < M) {
    out[(long)g * N + n0 + 2 * t] = c[0];
    out[(long)g * N + n0 + 2 * t + 1] = c[1];
  }
  if (g + 8 < M) {
    out[(long)(g + 8) * N + n0 + 2 * t] = c[2];
    out[(long)(g + 8) * N + n0 + 2 * t + 1] = c[3];
  }
}

__global__ void __launch_bounds__(THREADS)
int4_view_kernel(const uint8_t* __restrict__ q, int R, int N, int lo, int* __restrict__ out) {
  const long i = (long)blockIdx.x * THREADS + threadIdx.x;  // element of the view [2R, N]
  int rows = 0, cols = 0;
  if (i < 2L * R * N) {
    const int r = (int)(i / N), c = (int)(i % N);
    const uint32_t b = q[(long)(r % R) * N + c];
    const int v = r < R ? (int)((b & 0xFu) ^ 8u) - 8 : (int)(((b >> 4) & 0xFu) ^ 8u) - 8;
    if (v >= lo) {   // lo = -8: every int4 value
      rows = r + 1;
      cols = c + 1;
    }
  }
  rows = __reduce_max_sync(0xffffffffu, rows);
  cols = __reduce_max_sync(0xffffffffu, cols);
  if ((threadIdx.x & 31) == 0) {
    atomicMax(out, rows);
    atomicMax(out + 1, cols);
  }
}

}  // namespace

// P4: q13 [E, rows13, N13] and q2 [E, rows2, N2] bytes, eids [k] int32;
// out f32 [n_keep], zeroed by the caller; spill f32 [N13] or null.
extern "C" int stream_launch(const void* q13, const void* q2, const void* eids, int k,
                             int rows13, int n13, int rows2, int n2, long e13, long e2,
                             int n_keep, void* out, void* spill, void* stream) {
  const Seg a{(const int8_t*)q13, e13, rows13, n13, n_keep, 128};
  const Seg b{(const int8_t*)q2, e2, rows2, n2, n_keep, 128};
  const int ba = blocks_of(a);
  dim3 grid(ba + blocks_of(b), k);
  colsum_kernel<RAW><<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      a, b, ba, (const int*)eids, (float*)out, (float*)spill);
  return (int)cudaGetLastError();
}

// P8: q [rows, N] bytes of one expert; mode 1 = mask-xor, 2 = shifts; out
// f32 [N], zeroed by the caller.
extern "C" int unpack_launch(const void* q, int rows, int n, int mode, void* out,
                             void* stream) {
  const Seg a{(const int8_t*)q, 0, rows, n, n, 64};
  const int ba = blocks_of(a);
  dim3 grid(ba, 1);
  cudaStream_t st = (cudaStream_t)stream;
  if (mode == MASKXOR)
    colsum_kernel<MASKXOR><<<grid, THREADS, 0, st>>>(a, a, ba, nullptr, (float*)out, nullptr);
  else if (mode == SHIFT)
    colsum_kernel<SHIFT><<<grid, THREADS, 0, st>>>(a, a, ba, nullptr, (float*)out, nullptr);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// P5 (native = 1) / P6 (native = 0): x int8 [M, K], q [K/2, N] packed
// int4 → out int32 [M, N]; M ≤ 16, K a multiple of 64, N of 8.
extern "C" int int4_dot_launch(const void* x, const void* q, void* out, int M, int K, int N,
                               int native, void* stream) {
  dim3 grid((N / 8 + WARPS - 1) / WARPS);
  cudaStream_t st = (cudaStream_t)stream;
  if (native)
    int4_dot_kernel<true><<<grid, THREADS, 0, st>>>((const int8_t*)x, (const uint8_t*)q,
                                                     (int*)out, M, K, N);
  else
    int4_dot_kernel<false><<<grid, THREADS, 0, st>>>((const int8_t*)x, (const uint8_t*)q,
                                                      (int*)out, M, K, N);
  return (int)cudaGetLastError();
}

// P7: q [R, N] bytes → out int32 [2] = the int4 view's shape; out zeroed
// by the caller.
extern "C" int int4_view_launch(const void* q, int R, int N, int lo, void* out, void* stream) {
  const long n = 2L * R * N;
  dim3 grid((unsigned)((n + THREADS - 1) / THREADS));
  int4_view_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>((const uint8_t*)q, R, N, lo,
                                                                (int*)out);
  return (int)cudaGetLastError();
}
