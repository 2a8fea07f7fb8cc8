// ELLPACK-rows x dense SpMM for Hopper (sm_90a), K9.
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
// reads no other), + n_rows*d*4 of C written; 2*d operations a valid lane.
// The TPU forms a one-hot (128 x 128) tile a slab and lets the matrix unit do
// the scatter, because it has no scatter unit. A scatter with atomics needs
// C zeroed first (at MoE dispatch a memset of 252 MB, as much as the whole
// bound) and sums each row in whatever order its atomics land. This kernel
// turns the scatter into a gather by transposing the index plane first
// (CSR transpose), so each row of C is written once, from registers, with
// its terms in a fixed order:
//   1. transpose (csrc/ell_transpose.cuh): a stable sort of the k*n lane
//      ids (l = s*n + c, s-major) by their row, lanes outside [0, n_rows)
//      last, by the LSD radix sort of csrc/radix_sort.cuh over the digits
//      n_rows needs (two 8-bit digits at the MoE shapes' 30,720 and 4,096
//      rows), then one grid of row bounds: rowptr[r] = the first sorted
//      lane of row >= r.
//   2. gather: one warp a row of C reads its sources in lane order, X's rows
//      with 16-byte loads where d and the pointers allow, and sums in
//      registers; a row with no source writes zeros.
// No memset of C and no atomics on it (the transpose's only atomics are the
// radix sort's shared-memory integer counts, whose totals do not depend on
// their order). Each term is one rounded product added by one
// rounded add (__fmul_rn, __fadd_rn: no contraction into an FMA), in lane
// order from 0, which is the order in which the plain twin's index_add_
// sums on the CPU: the same bits there whatever the operands; on the card
// the twin's atomics sum in another order, so float results agree within
// float32 summation order and two calls give the same bits.
#include "ell_transpose.cuh"

namespace {

constexpr int WARPS = 8;              // rows of C a gather block, one a warp
constexpr int UNROLL = 4;             // 16-byte loads in flight a lane

__device__ __forceinline__ float4 fma_rn(float v, float4 x, float4 acc) {
  return make_float4(__fadd_rn(acc.x, __fmul_rn(v, x.x)),
                     __fadd_rn(acc.y, __fmul_rn(v, x.y)),
                     __fadd_rn(acc.z, __fmul_rn(v, x.z)),
                     __fadd_rn(acc.w, __fmul_rn(v, x.w)));
}

// One warp a row of C: its sources (lane ids, in lane order) are
// lane_ids[rowptr[r] .. rowptr[r + 1]).
template <bool VEC>
__global__ void __launch_bounds__(WARPS * 32)
gather_kernel(const float* __restrict__ val,
              const int32_t* __restrict__ lane_ids,
              const int32_t* __restrict__ rowptr,
              const float* __restrict__ x, float* __restrict__ out,
              int64_t n, int64_t d, int64_t n_rows) {
  const int64_t r = (int64_t)blockIdx.x * WARPS + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (r >= n_rows) return;
  const int s0 = rowptr[r];
  const int s1 = rowptr[r + 1];
  float* o = out + r * d;
  if (VEC) {
    for (int64_t e0 = 4 * lane; e0 < d; e0 += 128 * UNROLL) {
      float4 acc[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u)
        acc[u] = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int s = s0; s < s1; ++s) {
        const int32_t l = lane_ids[s];
        const float v = val[l];
        const float* xr = x + (l % n) * d;
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
          const int64_t e = e0 + 128 * u;
          if (e < d)
            acc[u] = fma_rn(v, __ldg(reinterpret_cast<const float4*>(xr + e)),
                            acc[u]);
        }
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int64_t e = e0 + 128 * u;
        if (e < d) *reinterpret_cast<float4*>(o + e) = acc[u];
      }
    }
  } else {
    for (int64_t e = lane; e < d; e += 32) {
      float acc = 0.0f;
      for (int s = s0; s < s1; ++s) {
        const int32_t l = lane_ids[s];
        acc = __fadd_rn(acc, __fmul_rn(val[l], __ldg(x + (l % n) * d + e)));
      }
      o[e] = acc;
    }
  }
}

// The float4 path needs whole 16-byte rows of X and C.
bool vectorized(const void* x, const void* out, long long d) {
  return d % 4 == 0 && (uintptr_t)x % 16 == 0 && (uintptr_t)out % 16 == 0;
}

}  // namespace

// C (n_rows, d) = A (val, idx: (k, n)) @ X (n, d). `scratch` holds
// scratch_len int32s, at least the transpose's ellt::scratch_ints(k*n,
// n_rows) (kernels/ell_spmm.py sizes it). *grids receives the grids
// launched.
extern "C" int ell_spmm_f32(const void* val, const void* idx, const void* x,
                            void* out, void* scratch, long long scratch_len,
                            long long k, long long n, long long d,
                            long long n_rows, int* grids, void* stream) {
  *grids = 0;
  const int64_t lanes = k * n;
  if (k < 0 || n < 0 || d < 0 || n_rows < 0 || lanes >= (1LL << 31) ||
      scratch_len < ellt::scratch_ints(lanes, n_rows))
    return (int)cudaErrorInvalidValue;
  if (d == 0 || n_rows == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  const int32_t* ids;
  int32_t* rowptr;
  int err = ellt::transpose((const int32_t*)idx, lanes, n_rows,
                            (int32_t*)scratch, &ids, &rowptr, grids, st);
  if (err) return err;
  const unsigned blocks = (unsigned)((n_rows + WARPS - 1) / WARPS);
  if (vectorized(x, out, d))
    gather_kernel<true><<<blocks, WARPS * 32, 0, st>>>(
        (const float*)val, ids, rowptr, (const float*)x, (float*)out, n, d,
        n_rows);
  else
    gather_kernel<false><<<blocks, WARPS * 32, 0, st>>>(
        (const float*)val, ids, rowptr, (const float*)x, (float*)out, n, d,
        n_rows);
  ++*grids;
  return (int)cudaGetLastError();
}

extern "C" const char* ell_spmm_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
