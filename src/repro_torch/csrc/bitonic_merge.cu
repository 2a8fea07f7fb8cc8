// The (key, value) row sort, merge-tree level and run-tail totals of the
// 'tiled', 'bucket' and 'hash' accumulators for Hopper (sm_90a).
//
// 1. The row sort (K5) replaces src/repro/kernels/bitonic_merge.py:
//    _make_sort_kernel: every power-of-two row of (int32 key, float32 value)
//    pairs sorted ascending, ties in lane order, then the run-tail totals.
//    Rows are 4,096 lanes for 'tiled', 2^21-2^22 lanes for 'bucket' and
//    'hash'. Bound: bytes, 16 a lane (the pair read and written, the total
//    written, the value re-read). The TPU's bitonic network made one pass
//    over device memory for every stride at or above a shared tile: 66
//    passes at a 2^22 row. Design: the LSD radix sort of csrc/radix_sort.cu
//    (its own library) with the value carried beside its key, its
//    histograms and offset scans per (row, digit) so each row sorts on its
//    own: rows above one 4,096-lane tile take three grids a digit, four
//    digits; rows of at most one tile are sorted in shared memory, one block
//    a tile of whole rows (radix_rows). This file holds its last grid,
//    seg_totals_f32.
// 2. merge_runs (K6) replaces src/repro/kernels/bitonic_merge.py:
//    _make_merge_kernel: adjacent ascending runs of length `run` merged into
//    ascending rows of 2*run (one bitonic merge network, no full re-sort),
//    then the totals. Bound: bytes; the network is n*log2(2*run)/2
//    compare-exchanges, far below the card's integer rate. Design: the
//    network of csrc/bitonic_net.cuh. It skips the copy the TPU kernel makes
//    of "ascending ++ flipped": its first stage compares lane i with lane
//    2*run-1-i of each row, which leaves two bitonic halves, and the rest is
//    the ordinary ascending half-cleaner cascade.
// 3. seg_total, the last grid of both and of K8's step
//    (csrc/fused_sccp_stream.cu): on every row, the last lane of each
//    run of equal keys gets the run's value total and every other lane 0;
//    the last lane of a row is a tail even when the next row starts with the
//    same key, and KEY_INVALID lanes get 0.
#include "bitonic_net.cuh"

// The run-tail totals of rows of `row` sorted lanes, the last grid of the
// radix row sort (K5) and of K8's step.
extern "C" int seg_totals_f32(const void* key, const void* val, void* tot,
                              long long n, long long row, void* stream) {
  if (n <= 0) return 0;
  return totals((const int32_t*)key, (const float*)val, (float*)tot, n, row,
                (cudaStream_t)stream);
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
