// CSR transpose of a row-wise ELLPACK index plane for Hopper (sm_90a): the
// lane ids l = s*n + c of a (k, n) plane, sorted stably by their row idx[l],
// lanes whose row lies outside [0, n_rows) last, and rowptr[r], the first
// sorted lane of row >= r, for r in [0, n_rows]. K9 (csrc/ell_spmm.cu)
// gathers each row of C from it; K3's grouped alignment
// (csrc/insitu_search.cu) walks the (s, c) groups of each row of C with it.
//
// The sort is the LSD radix sort of csrc/radix_sort.cuh over a lane source,
// EllLanes, that forms each lane's key (its row) and value (its lane id,
// carried as the 32-bit word the sort moves) from the idx plane. Only the
// digits that n_rows needs are sorted: two 8-bit digits below 65,536 rows.
// Above one 4,096-lane tile each digit is the library's count, scan and
// scatter grids (the first digit's count and scatter over EllLanes); up to
// one tile, one block sorts it in shared memory. The row bounds take one
// more grid, a binary search a row. Stable: lanes of one row keep their
// lane order, and the lanes outside [0, n_rows) follow the last row in lane
// order, the padding of the sorted buffers (lane ids >= lanes) after them.
#pragma once

#include "radix_sort.cuh"

namespace {
namespace ellt {

using radix::ITEMS;
using radix::PAD;
using radix::THREADS;
using radix::TILE;
using radix::WARP_KEYS;

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
upsweep_kernel(EllLanes src, int32_t* __restrict__ counts, int64_t row,
               int bpr, int tpb) {
  radix::upsweep(src, counts, row, bpr, tpb, 0);
}

__global__ void __launch_bounds__(THREADS)
downsweep_kernel(EllLanes src, int32_t* __restrict__ kout,
                 float* __restrict__ vout, const int32_t* __restrict__ offs,
                 int64_t row, int bpr, int tpb) {
  radix::downsweep<true>(src, kout, vout, offs, row, bpr, tpb, 0);
}

// Lanes of at most one tile, sorted by `passes` digits in one block.
__global__ void __launch_bounds__(THREADS)
rows_kernel(EllLanes src, int32_t* __restrict__ kout,
            float* __restrict__ vout, int64_t lanes, int passes) {
  radix::rows_sort<true, false>(src, kout, vout, lanes, 0, passes);
}

// rowptr[r] for r in [0, n_rows]: the first of the `sorted` keys that is
// at least r (PAD is above every row), one thread a row, each a binary
// search, so no thread walks a long run of rows without lanes.
__global__ void row_bounds_kernel(const int32_t* __restrict__ sorted,
                                  int64_t lanes, int64_t n_rows,
                                  int32_t* __restrict__ rowptr) {
  const int64_t r = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (r > n_rows) return;
  int64_t lo = 0;
  int64_t hi = lanes;
  while (lo < hi) {
    const int64_t mid = (lo + hi) >> 1;
    if (sorted[mid] < r)
      lo = mid + 1;
    else
      hi = mid;
  }
  rowptr[r] = (int32_t)lo;
}

// 8-bit digits that order the rows 0 .. n_rows - 1 before PAD.
inline int digits(long long n_rows) {
  int p = 1;
  while (p < radix::PASSES && n_rows >= (1LL << (radix::BITS * p))) ++p;
  return p;
}

// Lanes of the sorted buffers: `lanes` up to one tile, else a multiple of it.
inline int64_t sorted_lanes(int64_t lanes) {
  return lanes <= TILE ? lanes : (lanes + TILE - 1) / TILE * TILE;
}

// int32 scratch of one transpose: two key and two lane-id buffers, the radix
// counts and the row bounds (kernels/ell_spmm.py scratch_ints).
inline int64_t scratch_ints(int64_t lanes, int64_t n_rows) {
  const int64_t s = sorted_lanes(lanes);
  return 4 * s + (s / TILE + 1) * radix::BINS + n_rows + 1;
}

// Transpose the (lanes,) idx plane into `scratch` (scratch_ints of it):
// *ids receives the sorted lane ids, *rowptr the n_rows + 1 row bounds;
// *grids counts the grids launched. lanes < 2^31.
inline int transpose(const int32_t* idx, int64_t lanes, int64_t n_rows,
                     int32_t* scratch, const int32_t** ids, int32_t** rowptr,
                     int* grids, cudaStream_t st) {
  const int64_t sorted = sorted_lanes(lanes);
  int32_t* k0 = scratch;
  int32_t* v0 = k0 + sorted;
  int32_t* k1 = v0 + sorted;
  int32_t* v1 = k1 + sorted;
  int32_t* counts = v1 + sorted;
  const int passes = digits(n_rows);
  const EllLanes src{idx, lanes, n_rows};
  int err = 0;
  const int32_t* keys = k0;
  *ids = v0;
  if (lanes > 0 && lanes <= TILE) {
    constexpr int smem = radix::rows_smem<true>();
    err = (int)cudaFuncSetAttribute(
        rows_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err) return err;
    rows_kernel<<<1, THREADS, smem, st>>>(src, k0, (float*)v0, lanes,
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
        upsweep_kernel<<<(unsigned)bpr, THREADS, 0, st>>>(src, counts, sorted,
                                                          bpr, tpb);
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
          downsweep_kernel<<<(unsigned)bpr, THREADS, 0, st>>>(
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
    *ids = vb[(passes - 1) & 1];
  }
  *rowptr = counts + (sorted / TILE + 1) * radix::BINS;
  row_bounds_kernel<<<(unsigned)((n_rows + 1 + 255) / 256), 256, 0, st>>>(
      keys, sorted, n_rows, *rowptr);
  ++*grids;
  return (int)cudaGetLastError();
}

}  // namespace ellt
}  // namespace
