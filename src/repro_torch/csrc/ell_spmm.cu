// ELLPACK-rows x dense SpMM for Hopper (sm_90a).
//
// Replaces src/repro/kernels/ell_spmm.py:_ell_spmm_kernel. For A in
// row-wise ELLPACK, val (k, n) float32 and idx (k, n) int32, and X (n, d)
// float32 it writes
//     C[r, :] = sum over (s, c) with idx[s, c] == r of val[s, c] * X[c, :]
// into C (n_rows, d); lanes with idx -1 (or any idx outside [0, n_rows)) add
// nothing.
//
// Bound: bytes, k*n*8 of planes + n_used*d*4 of X read, where n_used counts
// the columns with a valid slot (no other row of X is needed, and the kernel
// reads no other), + n_rows*d*4 of C written; 2*d operations a valid lane. The TPU forms a one-hot (128 x 128) tile a
// slab and lets the matrix unit do the scatter, because it has no scatter
// unit; Hopper has atomics in L2, which is the mapping the TPU kernel's own
// docstring names. This kernel scatters with them:
//   * the C entry zeroes C on the stream, then one warp takes one column c
//     of A (eight a block);
//   * the warp reads its k (val, idx) slots once and skips a column with no
//     valid slot without touching X (MoE's combine has many empty capacity
//     slots);
//   * it reads X[c, :] once, 16 bytes a lane (a float4) where d and the
//     pointers allow it, and adds val[s, c] * X[c, :] into row idx[s, c] with
//     one 16-byte vector atomicAdd a lane (sm_90 has float4 atomics in global
//     memory), else one float atomicAdd an element.
// Built with atomics, not a deterministic CSR transpose: a transpose needs a
// sort or a histogram-and-scan of the idx plane before the product (two more
// passes), while the main path's dispatch writes each output row from one
// slot (no order to decide) and its combine sums at most top_k rows a token.
// Float sums therefore land in an order that may change from run to run;
// integer-valued operands (|partial sums| < 2^24) give the same bits in any
// order. A deterministic variant is a later PR's choice.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 8;              // columns of A a block, one a warp

template <bool VEC>
__global__ void __launch_bounds__(WARPS * 32)
ell_spmm_kernel(const float* __restrict__ val, const int32_t* __restrict__ idx,
                const float* __restrict__ x, float* __restrict__ out,
                int64_t k, int64_t n, int64_t d, int64_t n_rows) {
  const int64_t c = (int64_t)blockIdx.x * WARPS + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (c >= n) return;
  bool any = false;
  for (int64_t s = 0; s < k; ++s) {
    const int32_t r = idx[s * n + c];
    any |= (r >= 0 && r < n_rows);
  }
  if (!any) return;
  const float* xr = x + c * d;
  if (VEC) {
    for (int64_t e = 4 * lane; e < d; e += 128) {
      const float4 xv = *reinterpret_cast<const float4*>(xr + e);
      for (int64_t s = 0; s < k; ++s) {
        const int32_t r = idx[s * n + c];
        if (r < 0 || r >= n_rows) continue;
        const float v = val[s * n + c];
        atomicAdd(reinterpret_cast<float4*>(out + (int64_t)r * d + e),
                  make_float4(v * xv.x, v * xv.y, v * xv.z, v * xv.w));
      }
    }
  } else {
    for (int64_t e = lane; e < d; e += 32) {
      const float xv = xr[e];
      for (int64_t s = 0; s < k; ++s) {
        const int32_t r = idx[s * n + c];
        if (r < 0 || r >= n_rows) continue;
        atomicAdd(out + (int64_t)r * d + e, val[s * n + c] * xv);
      }
    }
  }
}

// The float4 path needs whole 16-byte rows of X and C.
bool vectorized(const void* x, const void* out, long long d) {
  return d % 4 == 0 && (uintptr_t)x % 16 == 0 && (uintptr_t)out % 16 == 0;
}

}  // namespace

extern "C" int ell_spmm_f32(const void* val, const void* idx, const void* x,
                            void* out, long long k, long long n, long long d,
                            long long n_rows, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (n_rows > 0 && d > 0) {
    cudaError_t err =
        cudaMemsetAsync(out, 0, (size_t)n_rows * d * sizeof(float), st);
    if (err != cudaSuccess) return (int)err;
  }
  if (n > 0 && k > 0 && d > 0 && n_rows > 0) {
    const unsigned blocks = (unsigned)((n + WARPS - 1) / WARPS);
    if (vectorized(x, out, d))
      ell_spmm_kernel<true><<<blocks, WARPS * 32, 0, st>>>(
          (const float*)val, (const int32_t*)idx, (const float*)x,
          (float*)out, k, n, d, n_rows);
    else
      ell_spmm_kernel<false><<<blocks, WARPS * 32, 0, st>>>(
          (const float*)val, (const int32_t*)idx, (const float*)x,
          (float*)out, k, n, d, n_rows);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* ell_spmm_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
