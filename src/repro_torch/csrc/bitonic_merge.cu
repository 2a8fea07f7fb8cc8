// The bitonic (key, value) network of the 'tiled', 'bucket' and 'hash'
// accumulators for Hopper (sm_90a): the row sort, one merge-tree level, and
// the row-local run-tail totals both end with.
//
// 1. sort_tiles replaces src/repro/kernels/bitonic_merge.py:_make_sort_kernel:
//    every power-of-two row of (int32 key, float32 value) pairs sorted
//    ascending, then the run-tail totals. Rows are 4,096 lanes for 'tiled',
//    2^21-2^22 lanes for 'bucket' and 'hash'.
// 2. merge_runs replaces src/repro/kernels/bitonic_merge.py:_make_merge_kernel:
//    adjacent ascending runs of length `run` merged into ascending rows of
//    2*run (one bitonic merge network, no full re-sort), then the totals.
// 3. seg_total, the last grid of both: on every row, the last lane of each
//    run of equal keys gets the run's value total and every other lane 0;
//    the last lane of a row is a tail even when the next row starts with the
//    same key, and KEY_INVALID lanes get 0.
//
// Bound: bytes. Each pass reads and writes 8 bytes a lane; the network is
// n*log2(row)*(log2(row)+1)/4 compare-exchanges for a sort and
// n*log2(2*run)/2 for a merge, far below the card's integer rate.
// Design: the classic bitonic network (stage k, stride j). Every stride below
// one shared-memory tile (4,096 pairs = 32 KB) runs inside one tile pass, so
// a tile is read and written once per merge level instead of once per stride;
// each stride at or above the tile is one coalesced global pass. Blocks never
// exchange data, so no pass carries state across blocks. A pair's direction
// comes from the lane's position WITHIN ITS ROW (bit k of lane & (row-1)):
// taken from the global lane, every odd row would sort descending once k
// reaches the row length. A pair swaps only when strictly out of order, so
// ascending ties keep the lower lane first. A merge skips the copy the TPU
// kernel makes of "ascending ++ flipped": its first stage compares lane i with
// lane 2*run-1-i of each row, which leaves two bitonic halves, and the rest is
// the ordinary ascending half-cleaner cascade. The totals are not a
// difference of global prefix sums (that loses float precision): each tail
// lane walks back over its own run, which never crosses a row. Every lane
// belongs to exactly one run, so the walks together read each lane once.
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

// One shared-memory pass over a tile of t lanes (t a power of two, t | n).
//   flip_run > 0  : merge rows of 2*flip_run <= t: the flip stage, then the
//                   ascending strides flip_run/2 .. 1.
//   k_merge == 0  : sort every row, stages k = 2 .. min(t, row).
//   otherwise     : finish stage k_merge > t: strides t/2 .. 1.
// kin/vin may alias kout/vout: a block reads its whole tile before writing.
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
  } else if (k_merge == 0) {
    const int64_t top = row < t ? row : t;
    for (int64_t kk = 2; kk <= top; kk <<= 1)
      for (int j = (int)(kk >> 1); j > 0; j >>= 1)
        tile_stride(sk, sv, base, row, half, j, kk);
  } else {
    for (int j = half; j > 0; j >>= 1)
      tile_stride(sk, sv, base, row, half, j, k_merge);
  }
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

// Launch the tile pass; returns the launch's error code.
int tile_pass(const int32_t* kin, const float* vin, int32_t* kout,
              float* vout, int64_t n, int t, int64_t row, int64_t k_merge,
              int flip_run, cudaStream_t st) {
  const int threads = t >= 2 * TILE_THREADS ? TILE_THREADS
                                            : (t >= 2 ? t / 2 : 1);
  tile_kernel<<<(unsigned)(n / t), threads, t * 8, st>>>(
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

// Sort every row of `row` lanes of (kin, vin) into (kout, vsorted), then the
// run-tail totals into tot. n and row are powers of two, row | n. *grids
// receives the number of grids launched.
extern "C" int sort_tiles_f32(const void* kin, const void* vin, void* kout,
                              void* vsorted, void* tot, long long n,
                              long long row, int* grids, void* stream) {
  *grids = 0;
  if (n <= 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  int32_t* k = (int32_t*)kout;
  float* v = (float*)vsorted;
  const int t = (int)(n < TILE ? n : TILE);
  int err = tile_pass((const int32_t*)kin, (const float*)vin, k, v, n, t, row,
                      0, 0, st);
  ++*grids;
  for (int64_t kk = 2 * (int64_t)t; kk <= row && !err; kk <<= 1) {
    for (int64_t j = kk >> 1; j >= t && !err; j >>= 1) {
      stride_kernel<<<blocks(n / 2, THREADS), THREADS, 0, st>>>(k, v, n / 2,
                                                               j, kk, row);
      err = (int)cudaGetLastError();
      ++*grids;
    }
    if (!err) {
      err = tile_pass(k, v, k, v, n, t, row, kk, 0, st);
      ++*grids;
    }
  }
  if (!err) {
    err = totals(k, v, (float*)tot, n, row, st);
    ++*grids;
  }
  return err;
}

// Merge adjacent ascending runs of `run` lanes of (kin, vin) into ascending
// rows of 2*run in (kout, vsorted), then the run-tail totals into tot.
extern "C" int merge_runs_f32(const void* kin, const void* vin, void* kout,
                              void* vsorted, void* tot, long long n,
                              long long run, int* grids, void* stream) {
  *grids = 0;
  if (n <= 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  int32_t* k = (int32_t*)kout;
  float* v = (float*)vsorted;
  const int64_t row = 2 * (int64_t)run;
  const int t = (int)(n < TILE ? n : TILE);
  int err;
  if (row <= t) {
    err = tile_pass((const int32_t*)kin, (const float*)vin, k, v, n, t, row, 0,
                    (int)run, st);
    ++*grids;
  } else {
    flip_kernel<<<blocks(n / 2, THREADS), THREADS, 0, st>>>(
        (const int32_t*)kin, (const float*)vin, k, v, n / 2, run);
    err = (int)cudaGetLastError();
    ++*grids;
    for (int64_t j = run >> 1; j >= t && !err; j >>= 1) {
      stride_kernel<<<blocks(n / 2, THREADS), THREADS, 0, st>>>(k, v, n / 2,
                                                               j, row, row);
      err = (int)cudaGetLastError();
      ++*grids;
    }
    if (!err) {
      err = tile_pass(k, v, k, v, n, t, row, row, 0, st);
      ++*grids;
    }
  }
  if (!err) {
    err = totals(k, v, (float*)tot, n, row, st);
    ++*grids;
  }
  return err;
}

extern "C" const char* bitonic_merge_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
