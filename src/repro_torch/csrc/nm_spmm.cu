// N:M balanced-sparsity SpMM for Hopper (sm_90a), on the tensor cores.
//
// Replaces src/repro/kernels/nm_spmm.py:_nm_spmm_kernel. For X (t, d_in) and
// the condensed planes V (R, d_out) float32, O (R, d_out) int8 of an N:M
// weight (R = d_in * N / M; row r belongs to window r / N) it writes
//     Y[t, j] = sum_r V[r, j] * X[t, M * (r / N) + O[r, j]]
// with offsets outside [0, M) adding nothing, as the TPU kernel's masked
// one-hot products give it.
//
// Bound: operations. The TPU runs the product on its matrix unit as M masked
// dense matmuls. The card's matrix unit is the tensor cores, and this kernel
// runs the same dense-expanded product there: 2 * t * d_in * d_out operations
// (183.6 GFLOP at the main path's 4096 x 2048 x 10944 2:4 layer), on the
// FP64 tensor cores (67 TFLOP/s dense), against the condensed
// 2 * t * R * d_out that the CUDA cores would need at 67 TFLOP/s fp32 (a
// CUDA-core loop gathers one X value from shared memory for every FMA,
// which caps it at a quarter of that rate).
//   * A block owns a tile of BT = 128 tokens x BD = 128 output columns and
//     walks the reduction in K-chunks of whole windows, wc = max(1, 32 / M)
//     windows, kc = wc * M input columns, padded with zeros to kcp, a
//     multiple of the MMA depth 8 (kernels/nm_spmm.py k_chunk).
//   * Each chunk's dense X tile Xs[token][k] and its condensed V and O rows
//     are copied into shared memory by cp.async (16 bytes a copy where the
//     rows allow it, zeros past t, d_in, kc and d_out), two stages deep. A
//     chunk's rows are expanded into a dense weight tile Ws[k][column], also
//     two deep: one thread a (window, column) zeroes the window's M rows
//     and adds its N values at rows M * window + offset, in row order, so
//     rows of one window that share an offset add; offsets out of range add
//     nothing. Chunk c is multiplied while chunk c + 1 is expanded and chunk
//     c + 2's copies fly, two barriers a chunk. Each V and O value is read
//     once per output tile, and no FMA gathers.
//   * Eight warps, 2 x 4, each own 64 tokens x 32 columns: 4 x 4 tiles of
//     mma.sync.aligned.m16n8k8 .f64 a k-step, one block an SM (the 64
//     double sums take 128 registers a thread).
//   * Float32 fidelity on the FP64 tensor cores: each fp32 operand widens
//     to double exactly, a product of two is exact in double, and the sums
//     run in double, so the only rounding a result takes is its final one
//     to fp32. Split TF32 (three TF32 products of the operands' halves)
//     was tried first and did not hold fp32 fidelity: the TF32 tensor
//     cores truncate each k-step's sum, and at 4:8 on normal operands its
//     error reached 4.14x the plain fp32 twin's (PERF.md). Integer-valued
//     operands give the fp32 product bit for bit.
//   * Strides of 4 (Xs) and 8 (Ws) floats past the tile widths put the 32
//     lanes of each fragment load on 32 banks; fragments are widened to
//     double in registers, so shared memory holds fp32.
// The ragged edges of t, d_out and the last chunk are masked here (zeros
// staged, stores skipped), so the caller pads nothing.
// Two entries: nm_spmm_f32 (X, V and Y float32, the design above) and
// nm_spmm_bf16 (X, V and Y bfloat16) on the bf16 tensor cores, with float32
// sums, the reference's accumulator: mma.sync m16n8k16 .bf16 .f32, the same
// tiles, warps and pipeline. The FP64 design cannot serve bf16 well: its
// dense-expanded operations alone need 2.74 ms at fc_in (183.6 GFLOP at
// 67 TFLOP/s), about what the plain twin takes for the whole bf16 product
// (PERF.md). For bf16:
//   * Xs[token][k], the V rows and WsT[column][k] (the weight tile
//     transposed, so a B fragment's two k values are one 32-bit word) hold
//     bf16, staged by cp.async 16 bytes (8 values) a copy where the rows
//     allow it, by plain loads where they do not; kcp rounds up to a
//     multiple of 16, the MMA depth, the extra columns zero.
//   * Strides of kcp + 8 values put the 32 lanes of each fragment load on
//     32 banks at kcp = 32.
//   * Values of a window that share an offset add in WsT, each partial
//     sum rounded to bf16; core/nm.py's offsets in a window are distinct
//     (a partial permutation), so each of its values enters the product
//     exactly. (Summing a window in float32 registers and storing its M
//     values as one word was tried, and ran slower at fc_in.)
//   * Each result is its float32 sum rounded once to bf16 (nearest even);
//     integer-valued operands with sums below 256 give it bit for bit.
// Built with -DNM_SPMM_ONE_TF32 (kernels/_build.py VARIANTS,
// "nm_spmm_one_tf32") each tile takes one TF32 product (m16n8k8 .tf32, fp32
// sums) in place of the FP64 one: a probe, timed beside the kernel, of what
// the float32 fidelity costs. It rounds every operand to TF32 (about three
// decimal digits), so no wrapper launches it.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;          // 8 warps
constexpr int BT = 128;               // tokens a block
constexpr int BD = 128;               // output columns a block
constexpr int WT = 64;                // tokens a warp
constexpr int WD = 32;                // columns a warp
constexpr int MT = WT / 16;           // m16 tiles a warp
constexpr int NT = WD / 8;            // n8 tiles a warp
constexpr int WS = BD + 8;            // row stride of Ws, floats

// d += a (16 x 8, row) * b (8 x 8, col). Both shapes lay their fragments
// out alike: a[0..3] at (g, q), (g + 8, q), (g, q + 4), (g + 8, q + 4),
// b[0..1] at (q, g), (q + 4, g), d[0..3] at (g, 2q), (g, 2q + 1),
// (g + 8, 2q), (g + 8, 2q + 1), for g = lane / 4 and q = lane % 4.
#ifdef NM_SPMM_ONE_TF32
using F32Acc = float;                 // sums
using Op = uint32_t;                  // a TF32 operand

__device__ __forceinline__ Op widen(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ void mma(float (&d)[4], const Op (&a)[4],
                                    const Op (&b)[2]) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}
#else
using F32Acc = double;
using Op = double;

__device__ __forceinline__ Op widen(float x) { return (double)x; }

__device__ __forceinline__ void mma(double (&d)[4], const Op (&a)[4],
                                    const Op (&b)[2]) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
      : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(b[0]), "d"(b[1]));
}
#endif
// One block an SM holds the double sums in registers; the probe's fp32
// sums leave room for two.
constexpr int MIN_BLOCKS = sizeof(F32Acc) == 8 ? 1 : 2;

using bf16 = __nv_bfloat16;

// d += a (16 x 16, row) * b (16 x 8, col) on the bf16 tensor cores, float32
// sums. Each register holds two bf16 values adjacent in k, the lower k in
// the lower half: a[0..3] at (g, 2q), (g + 8, 2q), (g, 2q + 8),
// (g + 8, 2q + 8), b[0..1] at (2q, g), (2q + 8, g); d as for m16n8k8.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Two bf16 values at p (4-byte aligned) as one register.
__device__ __forceinline__ uint32_t pair(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// A sum rounded once to the output type.
__device__ __forceinline__ void store(float* p, double v) { *p = (float)v; }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(bf16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int bytes) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(bytes)
               : "memory");
}

// 16 bytes to shared memory, the first `bytes` of them from src, the rest 0.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ int clamp_bytes(int64_t left, int most) {
  return left <= 0 ? 0 : (left >= most ? most : (int)left);
}

template <typename In>
struct Operands {
  const In* x;
  const In* val;
  const int8_t* off;
  int64_t t, d_in, d_out;
  int n, m, wc, kcp;
  bool xvec, vvec, ovec;    // 16-byte copies: aligned rows and chunks
};

// Shared memory, every size a multiple of 16 bytes: two stages of Xs
// [BT][kcp + 4] floats; two of the chunk's V rows [wc * n][BD] floats and
// O rows [wc * n][BD] bytes; two Ws [kcp][WS] floats.
struct Smem {
  float* base;
  int x_len, v_len, vo_len, w_len;   // floats of an Xs, V, V + O, a Ws
  __device__ Smem(void* p, int kcp, int rows)
      : base(static_cast<float*>(p)),
        x_len(BT * (kcp + 4)),
        v_len(rows * BD),
        vo_len(rows * BD + rows * BD / 4),
        w_len(kcp * WS) {}
  __device__ float* xs(int s) const { return base + s * x_len; }
  __device__ float* vr(int s) const { return base + 2 * x_len + s * vo_len; }
  __device__ int8_t* orow(int s) const {
    return reinterpret_cast<int8_t*>(vr(s) + v_len);
  }
  __device__ float* ws(int s) const {
    return base + 2 * x_len + 2 * vo_len + s * w_len;
  }
  static size_t bytes(int kcp, int rows) {
    return 2 * ((size_t)BT * (kcp + 4) * 4 + (size_t)rows * BD * 5 +
                (size_t)kcp * WS * 4);
  }
};

// The bf16 entry's shared memory, every size a multiple of 16 bytes: two
// stages of Xs [BT][kcp + 8]; two of the chunk's V rows [wc * n][BD] and O
// rows [wc * n][BD] bytes; two WsT [BD][kcp + 8] (the weight tile
// transposed).
struct SmemB {
  char* base;
  int x_bytes, v_bytes, vo_bytes, w_bytes;
  __device__ SmemB(void* p, int kcp, int rows)
      : base(static_cast<char*>(p)),
        x_bytes(BT * (kcp + 8) * 2),
        v_bytes(rows * BD * 2),
        vo_bytes(rows * BD * 3),
        w_bytes(BD * (kcp + 8) * 2) {}
  __device__ bf16* xs(int s) const {
    return reinterpret_cast<bf16*>(base + s * x_bytes);
  }
  __device__ bf16* vr(int s) const {
    return reinterpret_cast<bf16*>(base + 2 * x_bytes + s * vo_bytes);
  }
  __device__ int8_t* orow(int s) const {
    return reinterpret_cast<int8_t*>(base + 2 * x_bytes + s * vo_bytes +
                                     v_bytes);
  }
  __device__ bf16* ws(int s) const {
    return reinterpret_cast<bf16*>(base + 2 * x_bytes + 2 * vo_bytes +
                                   s * w_bytes);
  }
  static size_t bytes(int kcp, int rows) {
    return 2 * ((size_t)BT * (kcp + 8) * 2 + (size_t)rows * BD * 3 +
                (size_t)BD * (kcp + 8) * 2);
  }
};

// What differs between the entries: the sums, the shared memory, the
// blocks an SM.
template <typename In>
struct Path;
template <>
struct Path<float> {
  using Acc = F32Acc;
  using Tiles = Smem;
  static constexpr int kMinBlocks = MIN_BLOCKS;
};
template <>
struct Path<bf16> {
  using Acc = float;
  using Tiles = SmemB;
  static constexpr int kMinBlocks = 2;   // 64 float sums a thread
};

// The windows of chunk ch: nw of them from window w0.
template <typename In>
__device__ __forceinline__ int chunk_windows(const Operands<In>& a, int64_t ch,
                                             int64_t& w0) {
  const int64_t windows = a.d_in / a.m;
  w0 = ch * a.wc;
  return (int)(windows - w0 < a.wc ? windows - w0 : a.wc);
}

// Start the copies of chunk ch's X tile into Xs stage s.
__device__ __forceinline__ void stage_x(const Operands<float>& a, const Smem& sm,
                                        int s, int64_t ch, int64_t t0) {
  int64_t w0;
  const int kc = chunk_windows(a, ch, w0) * a.m;
  const int64_t c0 = w0 * a.m;
  const int xs_stride = a.kcp + 4;
  float* xd = sm.xs(s);
  if (a.xvec) {
    const int groups = a.kcp / 4;
    for (int i = threadIdx.x; i < BT * groups; i += THREADS) {
      const int tt = i / groups;
      const int c = (i - tt * groups) * 4;
      const int64_t tok = t0 + tt;
      const int bytes = tok < a.t ? 4 * clamp_bytes(kc - c, 4) : 0;
      cp_async16(xd + tt * xs_stride + c,
                 bytes ? a.x + tok * a.d_in + c0 + c : a.x, bytes);
    }
  } else {
    for (int i = threadIdx.x; i < BT * a.kcp; i += THREADS) {
      const int tt = i / a.kcp;
      const int c = i - tt * a.kcp;
      const int64_t tok = t0 + tt;
      const int bytes = tok < a.t && c < kc ? 4 : 0;
      cp_async4(xd + tt * xs_stride + c,
                bytes ? a.x + tok * a.d_in + c0 + c : a.x, bytes);
    }
  }
}

template <typename In>
__device__ __forceinline__ void stage_o(const Operands<In>& a, int8_t* od,
                                        int rows, int64_t r0, int64_t j0);

// Start the copies of chunk ch's V and O rows into stage s.
__device__ __forceinline__ void stage_vo(const Operands<float>& a, const Smem& sm,
                                         int s, int64_t ch, int64_t j0) {
  int64_t w0;
  const int rows = chunk_windows(a, ch, w0) * a.n;
  const int64_t r0 = w0 * a.n;
  float* vd = sm.vr(s);
  if (a.vvec) {
    for (int i = threadIdx.x; i < rows * (BD / 4); i += THREADS) {
      const int rr = i / (BD / 4);
      const int jj = (i - rr * (BD / 4)) * 4;
      const int bytes = 4 * clamp_bytes(a.d_out - (j0 + jj), 4);
      cp_async16(vd + rr * BD + jj,
                 bytes ? a.val + (r0 + rr) * a.d_out + j0 + jj : a.val,
                 bytes);
    }
  } else {
    for (int i = threadIdx.x; i < rows * BD; i += THREADS) {
      const int rr = i / BD;
      const int jj = i - rr * BD;
      const int bytes = j0 + jj < a.d_out ? 4 : 0;
      cp_async4(vd + rr * BD + jj,
                bytes ? a.val + (r0 + rr) * a.d_out + j0 + jj : a.val, bytes);
    }
  }
  stage_o(a, sm.orow(s), rows, r0, j0);
}

// Start the copies of a chunk's O rows (rows of them from row r0) into od;
// rows that are not 16-byte aligned are stored directly.
template <typename In>
__device__ __forceinline__ void stage_o(const Operands<In>& a, int8_t* od,
                                        int rows, int64_t r0, int64_t j0) {
  if (a.ovec) {
    for (int i = threadIdx.x; i < rows * (BD / 16); i += THREADS) {
      const int rr = i / (BD / 16);
      const int jj = (i - rr * (BD / 16)) * 16;
      const int bytes = clamp_bytes(a.d_out - (j0 + jj), 16);
      cp_async16(od + rr * BD + jj,
                 bytes ? a.off + (r0 + rr) * a.d_out + j0 + jj : a.off,
                 bytes);
    }
  } else {
    for (int i = threadIdx.x; i < rows * BD; i += THREADS) {
      const int rr = i / BD;
      const int jj = i - rr * BD;
      od[rr * BD + jj] =
          j0 + jj < a.d_out ? a.off[(r0 + rr) * a.d_out + j0 + jj] : 0;
    }
  }
}

__device__ __forceinline__ void commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Expand chunk ch's condensed rows (V/O stage s) into Ws s: one thread a
// (window, column) zeroes the window's M rows of the column and adds its N
// values at their offsets, in row order; rows past the chunk's windows are
// zeroed. Columns past d_out hold V = 0 and add nothing.
__device__ __forceinline__ void expand_chunk(const Operands<float>& a,
                                             const Smem& sm, int s,
                                             int64_t ch) {
  int64_t w0;
  const int nw = chunk_windows(a, ch, w0);
  const float* vs = sm.vr(s);
  const int8_t* os = sm.orow(s);
  float* ws = sm.ws(s);
  for (int i = threadIdx.x; i < nw * BD; i += THREADS) {
    const int wl = i / BD;
    const int jj = i - wl * BD;
    float* col = ws + wl * a.m * WS + jj;
    for (int r = 0; r < a.m; ++r) col[r * WS] = 0.0f;
    for (int p = 0; p < a.n; ++p) {
      const int e = (wl * a.n + p) * BD + jj;
      const int o = os[e];
      if ((unsigned)o < (unsigned)a.m) col[o * WS] += vs[e];
    }
  }
  const int used = nw * a.m;
  for (int i = threadIdx.x; i < (a.kcp - used) * BD; i += THREADS)
    ws[(used + i / BD) * WS + i % BD] = 0.0f;
}

// Multiply chunk s: Xs s times Ws s into the warp's sums.
__device__ __forceinline__ void multiply_chunk(F32Acc (&acc)[MT][NT][4],
                                               const Operands<float>& a,
                                               const Smem& sm, int s, int wm,
                                               int wn, int g, int q) {
  const int xs_stride = a.kcp + 4;
  const float* xs = sm.xs(s);
  const float* ws = sm.ws(s);
  for (int k0 = 0; k0 < a.kcp; k0 += 8) {
    Op b[NT][2];
#pragma unroll
    for (int jn = 0; jn < NT; ++jn) {
      const float* wp = ws + (k0 + q) * WS + wn + jn * 8 + g;
      b[jn][0] = widen(wp[0]);
      b[jn][1] = widen(wp[4 * WS]);
    }
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      const float* xp = xs + (wm + i * 16 + g) * xs_stride + k0 + q;
      const Op av[4] = {widen(xp[0]), widen(xp[8 * xs_stride]),
                        widen(xp[4]), widen(xp[8 * xs_stride + 4])};
#pragma unroll
      for (int jn = 0; jn < NT; ++jn) mma(acc[i][jn], av, b[jn]);
    }
  }
}

// The bf16 entry's stages: the same chunks, tiles of bf16 values.
__device__ __forceinline__ void stage_x(const Operands<bf16>& a,
                                        const SmemB& sm, int s, int64_t ch,
                                        int64_t t0) {
  int64_t w0;
  const int kc = chunk_windows(a, ch, w0) * a.m;
  const int64_t c0 = w0 * a.m;
  const int stride = a.kcp + 8;
  bf16* xd = sm.xs(s);
  if (a.xvec) {
    const int groups = a.kcp / 8;
    for (int i = threadIdx.x; i < BT * groups; i += THREADS) {
      const int tt = i / groups;
      const int c = (i - tt * groups) * 8;
      const int64_t tok = t0 + tt;
      const int bytes = tok < a.t ? 2 * clamp_bytes(kc - c, 8) : 0;
      cp_async16(xd + tt * stride + c,
                 bytes ? a.x + tok * a.d_in + c0 + c : a.x, bytes);
    }
  } else {
    for (int i = threadIdx.x; i < BT * a.kcp; i += THREADS) {
      const int tt = i / a.kcp;
      const int c = i - tt * a.kcp;
      const int64_t tok = t0 + tt;
      xd[tt * stride + c] = tok < a.t && c < kc ? a.x[tok * a.d_in + c0 + c]
                                                : __float2bfloat16(0.0f);
    }
  }
}

__device__ __forceinline__ void stage_vo(const Operands<bf16>& a,
                                         const SmemB& sm, int s, int64_t ch,
                                         int64_t j0) {
  int64_t w0;
  const int rows = chunk_windows(a, ch, w0) * a.n;
  const int64_t r0 = w0 * a.n;
  bf16* vd = sm.vr(s);
  if (a.vvec) {
    for (int i = threadIdx.x; i < rows * (BD / 8); i += THREADS) {
      const int rr = i / (BD / 8);
      const int jj = (i - rr * (BD / 8)) * 8;
      const int bytes = 2 * clamp_bytes(a.d_out - (j0 + jj), 8);
      cp_async16(vd + rr * BD + jj,
                 bytes ? a.val + (r0 + rr) * a.d_out + j0 + jj : a.val,
                 bytes);
    }
  } else {
    for (int i = threadIdx.x; i < rows * BD; i += THREADS) {
      const int rr = i / BD;
      const int jj = i - rr * BD;
      vd[rr * BD + jj] = j0 + jj < a.d_out
                             ? a.val[(r0 + rr) * a.d_out + j0 + jj]
                             : __float2bfloat16(0.0f);
    }
  }
  stage_o(a, sm.orow(s), rows, r0, j0);
}

// Expand chunk ch into WsT s, a column's k values contiguous: as the float
// entry, each sum of values that share an offset rounded to bf16.
__device__ __forceinline__ void expand_chunk(const Operands<bf16>& a,
                                             const SmemB& sm, int s,
                                             int64_t ch) {
  int64_t w0;
  const int nw = chunk_windows(a, ch, w0);
  const int stride = a.kcp + 8;
  const bf16* vs = sm.vr(s);
  const int8_t* os = sm.orow(s);
  bf16* ws = sm.ws(s);
  for (int i = threadIdx.x; i < nw * BD; i += THREADS) {
    const int wl = i / BD;
    const int jj = i - wl * BD;
    bf16* col = ws + jj * stride + wl * a.m;
    for (int r = 0; r < a.m; ++r) col[r] = __float2bfloat16(0.0f);
    for (int p = 0; p < a.n; ++p) {
      const int e = (wl * a.n + p) * BD + jj;
      const int o = os[e];
      if ((unsigned)o < (unsigned)a.m)
        col[o] = __float2bfloat16_rn(__bfloat162float(col[o]) +
                                     __bfloat162float(vs[e]));
    }
  }
  const int used = nw * a.m;
  const int pad = a.kcp - used;
  for (int i = threadIdx.x; i < pad * BD; i += THREADS)
    ws[(i / pad) * stride + used + i % pad] = __float2bfloat16(0.0f);
}

__device__ __forceinline__ void multiply_chunk(float (&acc)[MT][NT][4],
                                               const Operands<bf16>& a,
                                               const SmemB& sm, int s, int wm,
                                               int wn, int g, int q) {
  const int stride = a.kcp + 8;
  const bf16* xs = sm.xs(s);
  const bf16* ws = sm.ws(s);
  for (int k0 = 0; k0 < a.kcp; k0 += 16) {
    uint32_t b[NT][2];
#pragma unroll
    for (int jn = 0; jn < NT; ++jn) {
      const bf16* wp = ws + (wn + jn * 8 + g) * stride + k0 + 2 * q;
      b[jn][0] = pair(wp);
      b[jn][1] = pair(wp + 8);
    }
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      const bf16* xp = xs + (wm + i * 16 + g) * stride + k0 + 2 * q;
      const uint32_t av[4] = {pair(xp), pair(xp + 8 * stride), pair(xp + 8),
                              pair(xp + 8 * stride + 8)};
#pragma unroll
      for (int jn = 0; jn < NT; ++jn) mma_bf16(acc[i][jn], av, b[jn]);
    }
  }
}

template <typename In>
__global__ void __launch_bounds__(THREADS, Path<In>::kMinBlocks)
nm_spmm_kernel(Operands<In> a, In* __restrict__ y) {
  extern __shared__ float4 smem4[];
  const typename Path<In>::Tiles sm(smem4, a.kcp, a.wc * a.n);
  const int64_t t0 = (int64_t)blockIdx.x * BT;
  const int64_t j0 = (int64_t)blockIdx.y * BD;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;                // the fragment's groupID
  const int q = lane & 3;                 // its thread in group
  const int wm = (warp >> 2) * WT;        // the warp's first token
  const int wn = (warp & 3) * WD;         // its first column
  const int64_t chunks = (a.d_in / a.m + a.wc - 1) / a.wc;

  typename Path<In>::Acc acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int jn = 0; jn < NT; ++jn)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][jn][e] = 0;

  // Chunk ch is multiplied while chunk ch + 1 is expanded beside it and
  // chunk ch + 2's copies fly: its V/O rows from the start of the
  // iteration, its X tile from the end (each into the stage its chunk - 2
  // freed). Copy groups in order: X0 + VO0, VO1, X1, then VO(ch+2) and
  // X(ch+2) each iteration; a wait for all but the newest leaves X(ch+1) and
  // VO(ch+2) in place for the next iteration.
  if (chunks > 0) {
    stage_x(a, sm, 0, 0, t0);
    stage_vo(a, sm, 0, 0, j0);
  }
  commit();
  if (chunks > 1) stage_vo(a, sm, 1, 1, j0);
  commit();
  if (chunks > 1) stage_x(a, sm, 1, 1, t0);
  commit();
  asm volatile("cp.async.wait_group 2;\n" ::: "memory");
  __syncthreads();
  if (chunks > 0) expand_chunk(a, sm, 0, 0);
  for (int64_t ch = 0; ch < chunks; ++ch) {
    const int s = (int)(ch & 1);
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    __syncthreads();
    if (ch + 2 < chunks) stage_vo(a, sm, s, ch + 2, j0);
    commit();
    if (ch + 1 < chunks) expand_chunk(a, sm, s ^ 1, ch + 1);
    multiply_chunk(acc, a, sm, s, wm, wn, g, q);
    __syncthreads();
    if (ch + 2 < chunks) stage_x(a, sm, s, ch + 2, t0);
    commit();
  }

#pragma unroll
  for (int i = 0; i < MT; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int64_t tok = t0 + wm + i * 16 + g + 8 * h;
      if (tok >= a.t) continue;
#pragma unroll
      for (int jn = 0; jn < NT; ++jn) {
        const int64_t col = j0 + wn + jn * 8 + 2 * q;
        In* yr = y + tok * a.d_out;
        if (col < a.d_out) store(yr + col, acc[i][jn][2 * h]);
        if (col + 1 < a.d_out) store(yr + col + 1, acc[i][jn][2 * h + 1]);
      }
    }
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// kcp is the float32 entry's chunk width; the bf16 entry rounds it up to
// its MMA depth, 16. A copy moves 16 bytes: 4 float32 or 8 bf16 values.
template <typename In>
int run(const void* x, const void* val, const void* off, void* y, long long t,
        long long d_in, long long d_out, int n, int m, int wc, int kcp,
        void* stream) {
  if (n < 1 || m < 1 || wc < 1 || kcp % 8 || kcp < wc * m ||
      kcp - wc * m >= 8)
    return (int)cudaErrorInvalidValue;
  constexpr int per = 16 / (int)sizeof(In);
  if (sizeof(In) == 2) kcp = (kcp + 15) / 16 * 16;
  if (t > 0 && d_out > 0) {
    const size_t smem = Path<In>::Tiles::bytes(kcp, wc * n);
    cudaError_t err = cudaFuncSetAttribute(
        nm_spmm_kernel<In>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
    const Operands<In> a{(const In*)x, (const In*)val, (const int8_t*)off,
                         t, d_in, d_out, n, m, wc, kcp,
                         d_in % per == 0 && (wc * m) % per == 0 &&
                             aligned16(x),
                         d_out % per == 0 && aligned16(val),
                         d_out % 16 == 0 && aligned16(off)};
    const dim3 grid((unsigned)((t + BT - 1) / BT),
                    (unsigned)((d_out + BD - 1) / BD));
    nm_spmm_kernel<In><<<grid, THREADS, smem, (cudaStream_t)stream>>>(
        a, (In*)y);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// wc windows a K-chunk, kcp its columns padded to a multiple of 8
// (kernels/nm_spmm.py k_chunk). A chunk that does not fit one block's
// shared memory (M near a hundred) is refused by cudaFuncSetAttribute, and
// its error returned.
extern "C" int nm_spmm_f32(const void* x, const void* val, const void* off,
                           void* y, long long t, long long d_in,
                           long long d_out, int n, int m, int wc, int kcp,
                           void* stream) {
  return run<float>(x, val, off, y, t, d_in, d_out, n, m, wc, kcp, stream);
}

// X, V and Y bfloat16: float32 sums, each rounded once to bfloat16.
extern "C" int nm_spmm_bf16(const void* x, const void* val, const void* off,
                            void* y, long long t, long long d_in,
                            long long d_out, int n, int m, int wc, int kcp,
                            void* stream) {
  return run<bf16>(x, val, off, y, t, d_in, d_out, n, m, wc, kcp, stream);
}

extern "C" const char* nm_spmm_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
