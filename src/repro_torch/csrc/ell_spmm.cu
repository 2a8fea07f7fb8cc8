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
//   1. transpose: a stable sort of the k*n lane ids (l = s*n + c, s-major)
//      by their row, lanes outside [0, n_rows) last. It is the LSD radix
//      sort of csrc/radix_sort.cuh over a lane source, EllLanes, that forms
//      each lane's key (its row) and value (its lane id, carried as the
//      32-bit word the sort moves) from the idx plane. Only the digits that
//      n_rows needs are sorted: two 8-bit digits below 65,536 rows (the MoE
//      shapes' 30,720 and 4,096). Above one 4,096-lane tile each digit is
//      the library's count, scan and scatter grids (the first digit's count
//      and scatter over EllLanes); up to one tile, one block sorts it in
//      shared memory.
//   2. row bounds: rowptr[r] = the first sorted lane of row >= r, written
//      once for every r by the sorted lane where the rows step past it.
//   3. gather: one warp a row of C reads its sources in lane order, X's rows
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
#include "radix_sort.cuh"

namespace {

using radix::ITEMS;
using radix::PAD;
using radix::THREADS;
using radix::TILE;
using radix::WARP_KEYS;

constexpr int WARPS = 8;              // rows of C a gather block, one a warp
constexpr int UNROLL = 4;             // 16-byte loads in flight a lane

// Lane l < lanes of the idx plane: key idx[l] where it is a row of C, else
// PAD; value the lane id's bits. Past `lanes` every lane is PAD.
struct EllLanes {
  const int32_t* idx;
  int64_t lanes;
  int64_t n_rows;

  __device__ __forceinline__ int32_t key(int64_t l) const {
    if (l >= lanes) return PAD;
    const int32_t r = __ldg(idx + l);
    return r >= 0 && r < n_rows ? r : PAD;
  }

  __device__ __forceinline__ void run(int64_t l, int32_t (&k)[16]) const {
#pragma unroll
    for (int q = 0; q < 16; ++q) k[q] = key(l + q);
  }

  __device__ __forceinline__ void begin(int64_t) {}

  // Thread (warp w, lane x) forms tile lanes w * WARP_KEYS + i * 32 + x.
  __device__ __forceinline__ void tile(int64_t at, int64_t, int32_t*, float*,
                                       int32_t (&k)[ITEMS],
                                       float (&v)[ITEMS]) const {
    const int64_t w =
        at + (threadIdx.x >> 5) * WARP_KEYS + (threadIdx.x & 31);
#pragma unroll
    for (int i = 0; i < ITEMS; ++i) lane(w + i * 32, k[i], v[i]);
  }

  __device__ __forceinline__ void lane(int64_t l, int32_t& k,
                                       float& v) const {
    k = key(l);
    v = __int_as_float((int32_t)l);
  }
};

__global__ void __launch_bounds__(THREADS)
ell_upsweep_kernel(EllLanes src, int32_t* __restrict__ counts, int64_t row,
                   int bpr, int tpb) {
  radix::upsweep(src, counts, row, bpr, tpb, 0);
}

__global__ void __launch_bounds__(THREADS)
ell_downsweep_kernel(EllLanes src, int32_t* __restrict__ kout,
                     float* __restrict__ vout,
                     const int32_t* __restrict__ offs, int64_t row, int bpr,
                     int tpb) {
  radix::downsweep<true>(src, kout, vout, offs, row, bpr, tpb, 0);
}

// Lanes of at most one tile, sorted by `passes` digits in one block.
__global__ void __launch_bounds__(THREADS)
ell_rows_kernel(EllLanes src, int32_t* __restrict__ kout,
                float* __restrict__ vout, int64_t lanes, int passes) {
  radix::rows_sort<true, false>(src, kout, vout, lanes, 0, passes);
}

// rowptr[r] for r in [0, n_rows]: the first of the `sorted` keys that is
// at least r (PAD counts as n_rows). Thread i writes the rows between the
// key before it and its own, so each entry is written once.
__global__ void row_bounds_kernel(const int32_t* __restrict__ sorted,
                                  int64_t lanes, int64_t n_rows,
                                  int32_t* __restrict__ rowptr) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i > lanes) return;
  const int64_t cur = i < lanes && sorted[i] < n_rows ? sorted[i] : n_rows;
  const int64_t prev = i == 0 ? -1 : (sorted[i - 1] < n_rows ? sorted[i - 1]
                                                             : n_rows);
  for (int64_t r = prev + 1; r <= cur; ++r) rowptr[r] = (int32_t)i;
}

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

// 8-bit digits that order the rows 0 .. n_rows - 1 before PAD.
int digits(long long n_rows) {
  int p = 1;
  while (p < radix::PASSES && n_rows >= (1LL << (radix::BITS * p))) ++p;
  return p;
}

}  // namespace

// C (n_rows, d) = A (val, idx: (k, n)) @ X (n, d). `scratch` holds
// scratch_len int32s, at least 4 * sorted + (sorted / TILE + 1) * 256 +
// n_rows + 1 (kernels/ell_spmm.py sizes it), sorted = k*n rounded up to a
// tile above one tile, else k*n. *grids receives the grids launched.
extern "C" int ell_spmm_f32(const void* val, const void* idx, const void* x,
                            void* out, void* scratch, long long scratch_len,
                            long long k, long long n, long long d,
                            long long n_rows, int* grids, void* stream) {
  *grids = 0;
  const int64_t lanes = k * n;
  const int64_t sorted =
      lanes <= TILE ? lanes : (lanes + TILE - 1) / TILE * TILE;
  if (k < 0 || n < 0 || d < 0 || n_rows < 0 || lanes >= (1LL << 31) ||
      scratch_len <
          4 * sorted + (sorted / TILE + 1) * radix::BINS + n_rows + 1)
    return (int)cudaErrorInvalidValue;
  if (d == 0 || n_rows == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  int32_t* k0 = (int32_t*)scratch;
  int32_t* v0 = k0 + sorted;
  int32_t* k1 = v0 + sorted;
  int32_t* v1 = k1 + sorted;
  int32_t* counts = v1 + sorted;
  const int passes = digits(n_rows);
  const EllLanes src{(const int32_t*)idx, lanes, n_rows};
  int err = 0;
  const int32_t* keys = k0;
  const int32_t* ids = v0;
  if (lanes > 0 && lanes <= TILE) {
    constexpr int smem = radix::rows_smem<true>();
    err = (int)cudaFuncSetAttribute(
        ell_rows_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err) return err;
    ell_rows_kernel<<<1, THREADS, smem, st>>>(src, k0, (float*)v0, lanes,
                                              passes);
    ++*grids;
    if ((err = (int)cudaGetLastError())) return err;
  } else if (lanes > TILE) {
    // one row of `sorted` lanes, cut as kernels/radix_sort.py span_geometry
    const int64_t tiles = sorted / TILE;
    const int tpb = (int)((tiles + 511) / 512);
    const int bpr = (int)((tiles + tpb - 1) / tpb);
    int32_t* kb[2] = {k0, k1};
    int32_t* vb[2] = {v0, v1};
    for (int p = 0; p < passes && !err; ++p) {
      const int shift = radix::BITS * p;
      int32_t* kd = kb[p & 1];
      float* vd = (float*)vb[p & 1];
      const int32_t* ks = kb[(p + 1) & 1];
      const float* vs = (const float*)vb[(p + 1) & 1];
      if (p == 0) {
        ell_upsweep_kernel<<<(unsigned)bpr, THREADS, 0, st>>>(
            src, counts, sorted, bpr, tpb);
        err = (int)cudaGetLastError();
      } else {
        err = radix::upsweep_launch(ks, counts, sorted, sorted, bpr, tpb,
                                    shift, st);
      }
      ++*grids;
      if (!err) {
        err = radix::scan_launch(counts, 1, bpr, st);
        ++*grids;
      }
      if (!err) {
        if (p == 0) {
          ell_downsweep_kernel<<<(unsigned)bpr, THREADS, 0, st>>>(
              src, kd, vd, counts, sorted, bpr, tpb);
          err = (int)cudaGetLastError();
        } else {
          err = radix::downsweep_launch(ks, vs, kd, vd, counts, sorted,
                                        sorted, bpr, tpb, shift, st);
        }
        ++*grids;
      }
    }
    if (err) return err;
    keys = kb[(passes - 1) & 1];
    ids = vb[(passes - 1) & 1];
  }
  int32_t* rowptr = counts + (sorted / TILE + 1) * radix::BINS;
  row_bounds_kernel<<<(unsigned)((sorted + 1 + 255) / 256), 256, 0, st>>>(
      keys, sorted, n_rows, rowptr);
  ++*grids;
  if ((err = (int)cudaGetLastError())) return err;
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
