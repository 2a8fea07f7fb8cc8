// N:M balanced-sparsity SpMM for Hopper (sm_90a).
//
// Replaces src/repro/kernels/nm_spmm.py:_nm_spmm_kernel. For X (t, d_in) and
// the condensed planes V (R, d_out) float32, O (R, d_out) int8 of an N:M
// weight (R = d_in * N / M; row r belongs to window r / N) it writes
//     Y[t, j] = sum_r V[r, j] * X[t, M * (r / N) + O[r, j]]
// with offsets outside [0, M) adding nothing, as the TPU kernel's masked
// one-hot products give it.
//
// Bound: operations, 2 * t * R * d_out fp32 (at the main path's 4096 x 2048
// x 10944 2:4 layer, 91.8 GFLOP against 0.25 GB of operands). The TPU runs M
// masked dense matmuls (M times the work) because its matrix unit cannot
// gather; this kernel takes nmSPARSE's conflict-free form instead and does
// only the condensed products, with fp32 FMA on the CUDA cores:
//   * a block owns a tile of BT = 128 tokens x BD = 128 output columns and
//     walks the windows in chunks of WC = max(1, 64 / M) windows;
//   * per chunk it stages the chunk's X columns transposed, Xs[c][token]
//     (read coalesced along c, row stride BT + 4 against bank conflicts on
//     the transposed stores), and the chunk's V and O rows in shared memory;
//   * a thread holds TT = 16 tokens x TJ = 4 adjacent columns in registers.
//     For each condensed row it reads its 4 values (one 16-byte load) and 4
//     offsets (one 4-byte load), then each column's 16 tokens as four 16-byte
//     loads of Xs[M * window + offset][...]. All 32 lanes of a warp read the
//     same window, so their addresses fall on at most M distinct rows of Xs
//     and the loads are broadcasts: the balance of the N:M pattern is what
//     keeps them free of bank conflicts.
// The ragged edges of t, d_out and the last chunk are masked here (zeros
// staged, stores skipped), so the caller pads nothing. No TF32 or wgmma: a
// later PR may move the inner product onto the tensor cores.
// Built with -DNM_SPMM_BROADCAST (kernels/_build.py VARIANTS,
// "nm_spmm_broadcast") every lane reads its window's first column instead:
// a probe, timed beside the kernel, of what the loop costs with no gather.
// Its result is wrong and no wrapper launches it.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;          // 8 warps
constexpr int BT = 128;               // tokens a block
constexpr int BD = 128;               // output columns a block
constexpr int TT = BT / (THREADS / 32);   // 16 tokens a thread (a warp's)
constexpr int TJ = BD / 32;           // 4 adjacent columns a thread
constexpr int XS = BT + 4;            // row stride of Xs, floats
constexpr int X_COLS = 64;            // dense X columns staged a chunk

__global__ void __launch_bounds__(THREADS)
nm_spmm_kernel(const float* __restrict__ x, const float* __restrict__ val,
               const int8_t* __restrict__ off, float* __restrict__ y,
               int64_t t, int64_t d_in, int64_t d_out, int n, int m,
               int wc) {
  extern __shared__ float4 smem4[];
  float* xs = reinterpret_cast<float*>(smem4);           // [wc*m][XS]
  float* vs = xs + (int64_t)wc * m * XS;                  // [wc*n][BD]
  int8_t* os = reinterpret_cast<int8_t*>(vs + wc * n * BD);  // [wc*n][BD]

  const int64_t t0 = (int64_t)blockIdx.x * BT;
  const int64_t j0 = (int64_t)blockIdx.y * BD;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int jl = lane * TJ;
  const int64_t windows = d_in / m;

  float acc[TT][TJ];
#pragma unroll
  for (int i = 0; i < TT; ++i)
#pragma unroll
    for (int q = 0; q < TJ; ++q) acc[i][q] = 0.0f;

  for (int64_t w0 = 0; w0 < windows; w0 += wc) {
    const int nw = (int)(windows - w0 < wc ? windows - w0 : wc);
    const int xc = nw * m;
    const int rc = nw * n;
    const int64_t c0 = w0 * m;
    for (int i = threadIdx.x; i < xc * BT; i += THREADS) {
      const int c = i % xc;
      const int tt = i / xc;
      const int64_t tok = t0 + tt;
      xs[c * XS + tt] = tok < t ? x[tok * d_in + c0 + c] : 0.0f;
    }
    const int64_t r0 = w0 * n;
    for (int i = threadIdx.x; i < rc * BD; i += THREADS) {
      const int jj = i % BD;
      const int rr = i / BD;
      const int64_t col = j0 + jj;
      const bool ok = col < d_out;
      const int64_t g = (r0 + rr) * d_out + col;
      vs[rr * BD + jj] = ok ? val[g] : 0.0f;
      os[rr * BD + jj] = ok ? off[g] : (int8_t)0;
    }
    __syncthreads();

    for (int wl = 0; wl < nw; ++wl) {
      for (int q = 0; q < n; ++q) {
        const int rr = wl * n + q;
        const float4 v4 = *reinterpret_cast<const float4*>(&vs[rr * BD + jl]);
        const char4 o4 = *reinterpret_cast<const char4*>(&os[rr * BD + jl]);
        const float vv[TJ] = {v4.x, v4.y, v4.z, v4.w};
        const int oo[TJ] = {o4.x, o4.y, o4.z, o4.w};
#pragma unroll
        for (int jq = 0; jq < TJ; ++jq) {
          const bool ok = (unsigned)oo[jq] < (unsigned)m;
          const float v = ok ? vv[jq] : 0.0f;
#ifdef NM_SPMM_BROADCAST
          const int c = wl * m;   // probe variant: no gather, wrong result
#else
          const int c = wl * m + (ok ? oo[jq] : 0);
#endif
          const float4* xr =
              reinterpret_cast<const float4*>(&xs[c * XS + warp * TT]);
#pragma unroll
          for (int u = 0; u < TT / 4; ++u) {
            const float4 xv = xr[u];
            acc[4 * u + 0][jq] = fmaf(xv.x, v, acc[4 * u + 0][jq]);
            acc[4 * u + 1][jq] = fmaf(xv.y, v, acc[4 * u + 1][jq]);
            acc[4 * u + 2][jq] = fmaf(xv.z, v, acc[4 * u + 2][jq]);
            acc[4 * u + 3][jq] = fmaf(xv.w, v, acc[4 * u + 3][jq]);
          }
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TT; ++i) {
    const int64_t tok = t0 + warp * TT + i;
    if (tok < t) {
#pragma unroll
      for (int q = 0; q < TJ; ++q) {
        const int64_t col = j0 + jl + q;
        if (col < d_out) y[tok * d_out + col] = acc[i][q];
      }
    }
  }
}

int chunk_windows(int m) { return m < X_COLS ? X_COLS / m : 1; }

size_t smem_bytes(int n, int m) {
  const int wc = chunk_windows(m);
  return (size_t)wc * m * XS * 4 + (size_t)wc * n * BD * 5;
}

}  // namespace

// A window whose chunk does not fit one block's shared memory (M in the
// hundreds) is refused by cudaFuncSetAttribute, and its error returned.
extern "C" int nm_spmm_f32(const void* x, const void* val, const void* off,
                           void* y, long long t, long long d_in,
                           long long d_out, int n, int m, void* stream) {
  if (t > 0 && d_out > 0) {
    const size_t smem = smem_bytes(n, m);
    cudaError_t err = cudaFuncSetAttribute(
        nm_spmm_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((unsigned)((t + BT - 1) / BT),
                    (unsigned)((d_out + BD - 1) / BD));
    nm_spmm_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
        (const float*)x, (const float*)val, (const int8_t*)off, (float*)y, t,
        d_in, d_out, n, m, chunk_windows(m));
  }
  return (int)cudaGetLastError();
}

extern "C" const char* nm_spmm_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
