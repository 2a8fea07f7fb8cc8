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
// Design: the network of csrc/bitonic_net.cuh. A merge skips the copy the
// TPU kernel makes of "ascending ++ flipped": its first stage compares lane i
// with lane 2*run-1-i of each row, which leaves two bitonic halves, and the
// rest is the ordinary ascending half-cleaner cascade.
#include "bitonic_net.cuh"

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
  if (!err) err = sort_above_tile(k, v, (float*)tot, n, t, row, grids, st);
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
