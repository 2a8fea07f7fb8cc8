// ELLPACK-rows x dense SpMM for Hopper (sm_90a), K9.
//
// Replaces src/repro/kernels/ell_spmm.py:_ell_spmm_kernel. For A in
// row-wise ELLPACK, val (k, n) and idx (k, n) int32, and X (n, d) it writes
//     C[r, :] = sum over (s, c) with idx[s, c] == r of val[s, c] * X[c, :]
// into C (n_rows, d); lanes with idx -1 (or any idx outside [0, n_rows)) add
// nothing. Two entries: ell_spmm_f32 (val, X and C float32) and
// ell_spmm_bf16 (val, X and C bfloat16), which sums each row in float32
// registers and rounds it to bfloat16 once, to nearest even, as the
// reference's Pallas body accumulates in float32 and stores in x.dtype.
//
// Bound: bytes, k*n*(4 + the value's bytes) of planes + n_used*d*w of X
// read, where n_used counts the columns with a valid slot (no other row of X
// is needed, and the kernel reads no other) and w is the value's bytes, +
// n_rows*d*w of C written; 2*d operations a valid lane.
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
//      with 16-byte loads where d and the pointers allow (4 float32 or 8
//      bfloat16 values a load), and sums in float32 registers; a row with no
//      source writes zeros.
// No memset of C and no atomics on it (the transpose's only atomics are the
// radix sort's shared-memory integer counts, whose totals do not depend on
// their order). Each term is one rounded product added by one
// rounded add (__fmul_rn, __fadd_rn: no contraction into an FMA), in lane
// order from 0, which is the order in which the plain twin's index_add_
// sums on the CPU: the same bits there whatever the operands; on the card
// the twin's atomics sum in another order, so float results agree within
// float32 summation order and two calls give the same bits. In bfloat16 the
// twin sums in float32 too and rounds once, so the two differ by at most
// that order's error and one bfloat16 rounding; a row of one term (MoE
// dispatch: value 1) is the same bits.
#include <cuda_bf16.h>

#include "ell_transpose.cuh"

namespace {

constexpr int WARPS = 8;              // rows of C a gather block, one a warp
constexpr int UNROLL = 4;             // 16-byte loads in flight a lane

// A value type: how it widens to float and narrows back (to nearest
// even), and how a 16-byte load of PER values unpacks and packs.
template <typename T>
struct Elem;

template <>
struct Elem<float> {
  static constexpr int PER = 4;
  __device__ static float widen(float v) { return v; }
  __device__ static float narrow(float v) { return v; }
  __device__ static void unpack(const uint4& raw, float* f) {
    const float* p = reinterpret_cast<const float*>(&raw);
#pragma unroll
    for (int j = 0; j < PER; ++j) f[j] = p[j];
  }
  __device__ static uint4 pack(const float* f) {
    return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                      __float_as_uint(f[2]), __float_as_uint(f[3]));
  }
};

template <>
struct Elem<__nv_bfloat16> {
  static constexpr int PER = 8;
  __device__ static float widen(__nv_bfloat16 v) {
    return __bfloat162float(v);
  }
  __device__ static __nv_bfloat16 narrow(float v) {
    return __float2bfloat16_rn(v);
  }
  __device__ static void unpack(const uint4& raw, float* f) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int j = 0; j < PER / 2; ++j) {
      const float2 p = __bfloat1622float2(h[j]);
      f[2 * j] = p.x;
      f[2 * j + 1] = p.y;
    }
  }
  __device__ static uint4 pack(const float* f) {
    uint4 raw;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
    for (int j = 0; j < PER / 2; ++j)
      h[j] = __floats2bfloat162_rn(f[2 * j], f[2 * j + 1]);
    return raw;
  }
};

// One warp a row of C: its sources (lane ids, in lane order) are
// lane_ids[rowptr[r] .. rowptr[r + 1]). Sums are float32 whatever T (a
// product of two bfloat16 values is exact in float32), narrowed once at
// the store. VEC: 16-byte loads and stores of PER values a lane.
template <typename T, bool VEC>
__global__ void __launch_bounds__(WARPS * 32)
gather_kernel(const T* __restrict__ val, const int32_t* __restrict__ lane_ids,
              const int32_t* __restrict__ rowptr, const T* __restrict__ x,
              T* __restrict__ out, int64_t n, int64_t d, int64_t n_rows) {
  using E = Elem<T>;
  constexpr int PER = E::PER;
  const int64_t r = (int64_t)blockIdx.x * WARPS + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (r >= n_rows) return;
  const int s0 = rowptr[r];
  const int s1 = rowptr[r + 1];
  T* o = out + r * d;
  if (VEC) {
    for (int64_t e0 = PER * lane; e0 < d; e0 += 32 * PER * UNROLL) {
      float acc[UNROLL][PER];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u)
#pragma unroll
        for (int j = 0; j < PER; ++j) acc[u][j] = 0.0f;
      for (int s = s0; s < s1; ++s) {
        const int32_t l = lane_ids[s];
        const float v = E::widen(val[l]);
        const T* xr = x + (l % n) * d;
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
          const int64_t e = e0 + 32 * PER * u;
          if (e < d) {
            float f[PER];
            E::unpack(__ldg(reinterpret_cast<const uint4*>(xr + e)), f);
#pragma unroll
            for (int j = 0; j < PER; ++j)
              acc[u][j] = __fadd_rn(acc[u][j], __fmul_rn(v, f[j]));
          }
        }
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int64_t e = e0 + 32 * PER * u;
        if (e < d) *reinterpret_cast<uint4*>(o + e) = E::pack(acc[u]);
      }
    }
  } else {
    for (int64_t e = lane; e < d; e += 32) {
      float acc = 0.0f;
      for (int s = s0; s < s1; ++s) {
        const int32_t l = lane_ids[s];
        acc = __fadd_rn(acc, __fmul_rn(E::widen(val[l]),
                                       E::widen(x[(l % n) * d + e])));
      }
      o[e] = E::narrow(acc);
    }
  }
}

// The 16-byte path needs whole 16-byte rows of X and C: `per` values a load.
bool vectorized(const void* x, const void* out, long long d, int per) {
  return d % per == 0 && (uintptr_t)x % 16 == 0 && (uintptr_t)out % 16 == 0;
}

// C (n_rows, d) = A (val, idx: (k, n)) @ X (n, d), values of type T: the
// transpose, then the gather. `scratch` holds scratch_len int32s, at least
// the transpose's ellt::scratch_ints(k*n, n_rows) (kernels/ell_spmm.py
// sizes it). *grids receives the grids launched.
template <typename T>
int spmm(const void* val, const void* idx, const void* x, void* out,
         void* scratch, long long scratch_len, long long k, long long n,
         long long d, long long n_rows, int* grids, void* stream) {
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
  const T* v = (const T*)val;
  const T* xx = (const T*)x;
  T* o = (T*)out;
  if (vectorized(x, out, d, Elem<T>::PER))
    gather_kernel<T, true><<<blocks, WARPS * 32, 0, st>>>(v, ids, rowptr, xx,
                                                          o, n, d, n_rows);
  else
    gather_kernel<T, false><<<blocks, WARPS * 32, 0, st>>>(v, ids, rowptr,
                                                           xx, o, n, d,
                                                           n_rows);
  ++*grids;
  return (int)cudaGetLastError();
}

}  // namespace

// val, X and C float32.
extern "C" int ell_spmm_f32(const void* val, const void* idx, const void* x,
                            void* out, void* scratch, long long scratch_len,
                            long long k, long long n, long long d,
                            long long n_rows, int* grids, void* stream) {
  return spmm<float>(val, idx, x, out, scratch, scratch_len, k, n, d, n_rows,
                     grids, stream);
}

// val, X and C bfloat16, each row summed in float32.
extern "C" int ell_spmm_bf16(const void* val, const void* idx, const void* x,
                             void* out, void* scratch, long long scratch_len,
                             long long k, long long n, long long d,
                             long long n_rows, int* grids, void* stream) {
  return spmm<__nv_bfloat16>(val, idx, x, out, scratch, scratch_len, k, n, d,
                             n_rows, grids, stream);
}

extern "C" const char* ell_spmm_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
