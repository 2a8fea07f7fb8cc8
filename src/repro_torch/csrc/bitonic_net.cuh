// The bitonic (key, value) network of K6's merge-tree level
// (csrc/bitonic_merge.cu merge_runs_f32): the shared-memory tile network,
// the one-stride global passes, the flip stage of a merge, and the row-local
// run-tail totals, which are also the last grid of the radix row sort (K5)
// and of K8's step (seg_totals_f32). Everything here has internal linkage.
//
// Design: the classic bitonic merge network (stage k, stride j). Every
// stride below one shared-memory tile (4,096 pairs = 32 KB) runs inside one
// tile pass, so a tile is read and written once per merge level instead of
// once per stride; each stride at or above the tile is one coalesced global
// pass. Blocks never exchange data, so no pass carries state across blocks.
// A pair's direction comes from the lane's position WITHIN ITS ROW (bit k of
// lane & (row-1)): taken from the global lane, every odd row would sort
// descending once k reaches the row length. A pair swaps only when strictly
// out of order. The totals are not a difference of global prefix sums (that
// loses float precision): each tail lane walks back over its own run, which
// never crosses a row. Every lane belongs to exactly one run, so the walks
// together read each lane once.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int32_t KEY_INVALID = 2147483647;
constexpr int TILE = 4096;        // (key, value) pairs per shared tile: 32 KB
constexpr int TILE_THREADS = 1024;
constexpr int THREADS = 256;

__device__ __forceinline__ void cmp_swap(int32_t* k, float* v, int64_t i,
                                         int64_t l, bool asc) {
  const int32_t a = k[i];
  const int32_t b = k[l];
  if (asc ? (a > b) : (a < b)) {
    const float va = v[i];
    k[i] = b;
    k[l] = a;
    v[i] = v[l];
    v[l] = va;
  }
}

// One compare-exchange stride over the shared tile at merge level k; `base`
// is the tile's first global lane, `row` the (power-of-two) row length.
__device__ __forceinline__ void tile_stride(int32_t* k, float* v, int64_t base,
                                            int64_t row, int half, int j,
                                            int64_t kk) {
  for (int p = threadIdx.x; p < half; p += blockDim.x) {
    const int i = ((p & ~(j - 1)) << 1) | (p & (j - 1));
    cmp_swap(k, v, i, i + j, (((base + i) & (row - 1)) & kk) == 0);
  }
  __syncthreads();
}

// The network over one shared tile of t lanes (t a power of two), the tile
// already loaded and synchronised:
//   flip_run > 0  : merge rows of 2*flip_run <= t: the flip stage, then the
//                   ascending strides flip_run/2 .. 1.
//   otherwise     : finish stage k_merge > t: strides t/2 .. 1.
__device__ __forceinline__ void tile_network(int32_t* sk, float* sv, int t,
                                             int64_t base, int64_t row,
                                             int64_t k_merge, int flip_run) {
  const int half = t >> 1;
  if (flip_run > 0) {
    for (int p = threadIdx.x; p < half; p += blockDim.x) {
      const int r = p / flip_run;
      const int q = p - r * flip_run;
      const int lo = 2 * r * flip_run + q;
      cmp_swap(sk, sv, lo, lo + 2 * (flip_run - q) - 1, true);
    }
    __syncthreads();
    for (int j = flip_run >> 1; j > 0; j >>= 1)
      tile_stride(sk, sv, base, row, half, j, row);
  } else {
    for (int j = half; j > 0; j >>= 1)
      tile_stride(sk, sv, base, row, half, j, k_merge);
  }
}

// One shared-memory pass over a tile of t lanes (t | n): load, network,
// store. kin/vin may alias kout/vout: a block reads its whole tile before
// writing.
__global__ void tile_kernel(const int32_t* kin, const float* vin,
                            int32_t* kout, float* vout, int t, int64_t row,
                            int64_t k_merge, int flip_run) {
  extern __shared__ int32_t smem[];
  int32_t* sk = smem;
  float* sv = reinterpret_cast<float*>(smem + t);
  const int64_t base = (int64_t)blockIdx.x * t;
  for (int x = threadIdx.x; x < t; x += blockDim.x) {
    sk[x] = kin[base + x];
    sv[x] = vin[base + x];
  }
  __syncthreads();
  tile_network(sk, sv, t, base, row, k_merge, flip_run);
  for (int x = threadIdx.x; x < t; x += blockDim.x) {
    kout[base + x] = sk[x];
    vout[base + x] = sv[x];
  }
}

// One stride j >= TILE of stage kk over device memory, in place.
__global__ void stride_kernel(int32_t* __restrict__ key,
                              float* __restrict__ val, int64_t half_n,
                              int64_t j, int64_t kk, int64_t row) {
  const int64_t p = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= half_n) return;
  const int64_t i = ((p & ~(j - 1)) << 1) | (p & (j - 1));
  cmp_swap(key, val, i, i + j, ((i & (row - 1)) & kk) == 0);
}

// The flip stage of a merge of rows 2*run > TILE: lane q of each row against
// lane 2*run-1-q, ascending. Reads kin/vin, writes kout/vout (may alias:
// every pair is read and written by one thread).
__global__ void flip_kernel(const int32_t* kin, const float* vin,
                            int32_t* kout, float* vout, int64_t half_n,
                            int64_t run) {
  const int64_t p = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= half_n) return;
  const int64_t r = p / run;
  const int64_t q = p - r * run;
  const int64_t lo = 2 * r * run + q;
  const int64_t hi = lo + 2 * (run - q) - 1;
  const int32_t a = kin[lo];
  const int32_t b = kin[hi];
  const float va = vin[lo];
  const float vb = vin[hi];
  const bool swap = a > b;
  kout[lo] = swap ? b : a;
  kout[hi] = swap ? a : b;
  vout[lo] = swap ? vb : va;
  vout[hi] = swap ? va : vb;
}

__global__ void seg_total_kernel(const int32_t* __restrict__ key,
                                 const float* __restrict__ val,
                                 float* __restrict__ tot, int64_t n,
                                 int64_t row) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int32_t k = key[i];
  const bool row_end = ((i + 1) & (row - 1)) == 0;
  if (k == KEY_INVALID || (!row_end && key[i + 1] == k)) {
    tot[i] = 0.0f;
    return;
  }
  const int64_t start = i & ~(row - 1);
  float s = val[i];
  for (int64_t m = i - 1; m >= start && key[m] == k; --m) s += val[m];
  tot[i] = s;
}

unsigned blocks(int64_t work, int threads) {
  return (unsigned)((work + threads - 1) / threads);
}

// Threads of a tile pass over t lanes: one per compare-exchange, at most
// TILE_THREADS.
int tile_threads(int t) {
  return t >= 2 * TILE_THREADS ? TILE_THREADS : (t >= 2 ? t / 2 : 1);
}

// Launch the tile pass; returns the launch's error code.
int tile_pass(const int32_t* kin, const float* vin, int32_t* kout,
              float* vout, int64_t n, int t, int64_t row, int64_t k_merge,
              int flip_run, cudaStream_t st) {
  tile_kernel<<<(unsigned)(n / t), tile_threads(t), t * 8, st>>>(
      kin, vin, kout, vout, t, row, k_merge, flip_run);
  return (int)cudaGetLastError();
}

int totals(const int32_t* key, const float* val, float* tot, int64_t n,
           int64_t row, cudaStream_t st) {
  seg_total_kernel<<<blocks(n, THREADS), THREADS, 0, st>>>(key, val, tot, n,
                                                          row);
  return (int)cudaGetLastError();
}

}  // namespace
