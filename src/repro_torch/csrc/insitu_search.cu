// The 'search' accumulation's kernels for Hopper (sm_90a): the emission sort,
// the alignment search and the literal bit-serial minima scan.
//
// 1. emit sort (csrc/radix_sort.cu: radix_rows, or radix_upsweep +
//    radix_scan + radix_downsweep four times) replaces
//    src/repro/kernels/insitu_search.py:
//    _make_emit_sort_kernel and _make_emit_merge_kernel: an ascending
//    key-only sort of a power-of-two packed int32 key stream.
//    Bound: bytes (each key read and written once at the least). The TPU's
//    bitonic network, carried over as it was, made one pass over device
//    memory for every stride at or above a shared tile: 136 of 153 grids at
//    2^28 keys. Design: the LSD radix sort of csrc/radix_sort.cuh, four
//    8-bit digits, three grids a digit (reduce-then-scan: count, scan,
//    stable scatter through a shared-memory staging tile), so about 12
//    transfers of the stream whatever its length; a stream of at most one
//    4,096-key tile is sorted in shared memory by one block. The caller
//    orders the passes between its output and one scratch stream so the
//    fourth lands in the output; the input is never written.
// 2. align replaces src/repro/kernels/insitu_search.py:_make_align_kernel
//    (a 512 x 512 broadcast compare per block, O(S*u) work):
//    slot = #{uk < pk}, hit = pk in uk, for every product key.
//    Bound: bytes (product keys in, 4 a key; slot and hit out, 5 a key; each
//    unique key read once). Two entries compute it:
//    a. align_keys, flat: one thread per product key runs a lower-bound
//       binary search over all of uk. On a product stream the keys of one
//       row of C are spread over every slab, and uk is larger than L2, so
//       each slab's searches sweep uk from device memory again: 72 sweeps
//       of 346 MB at bcsstk32. It stays the kernel of one streaming step
//       (one slab, under one group a row of C, so nothing is shared).
//    b. align_product_keys, grouped by row of C: the keys come in SCCP's
//       (k_a, n, k_b) lane order, and the k_b lanes of group g = s*n + c
//       all lie in row group_row[g] = A.idx[s, c] of C. Three steps:
//         - the (s, c) groups sorted stably by row (the CSR transpose of
//           csrc/ell_transpose.cuh), rowptr[r] the first group of row r;
//         - the row bounds of uk, bnd[r] = #{uk < r*n_cols} for
//           r in [0, n_rows], so row r's keys are uk[bnd[r], bnd[r+1]);
//         - one block a row of C reads that segment once into shared
//           memory, as a bitmap of its columns with popcount prefixes, so a
//           lane of the row finds its rank in two shared loads (rows of
//           more than 131,072 columns, or with equal keys: a binary search
//           of the segment in place), then walks the lanes of the row's
//           groups: each segment of uk is read once a call. A row's blocks
//           follow its own lane count: its first block takes its first
//           ROW_LANES lanes, and the lanes past them are cut, in row order,
//           into runs of ROW_LANES, one block each, which read the row's
//           segment again; a row of few lanes costs one block, a heavy row
//           as many as its lanes need.
//       Correctness does not rest on the grouping: a lane whose key is not
//       in its block's row (a dead lane packed as 0 or KEY_INVALID, a wrong
//       group_row), every lane of a group outside [0, n_rows), and the lanes
//       past groups*k_b (the power-of-two padding of a packed stream) search
//       their own key's segment of uk in device memory: [0, bnd[0]) for a
//       negative key, [bnd[n_rows], u) for one at or past n_rows*n_cols.
//       uk is ascending, so the segment's lower bound plus its start is the
//       flat kernel's slot, and its hit the flat kernel's hit. Dead lanes
//       repeat one key, so a thread reuses its last such answer, and every
//       thread keeps BATCH lanes' loads in flight.
//       The groups of a row lie all over the stream, so a block reads their
//       keys and writes their slots and hits 288 and 72 bytes at a time at
//       scattered places, where the flat kernel streams; whether that is
//       what keeps it above the byte bound is not measured (PERF.md §7).
// 3. minima replaces src/repro/kernels/insitu_search.py:_minima_kernel: the
//    paper's Alg. 1, a 31-step scan from bit 30 down to bit 0 that keeps the
//    active rows whose bit is 0 whenever any active row has a 0 there; its
//    survivors are the active rows (v != KEY_INVALID) holding min(v).
//    Bound: bytes (each key read once, each mask byte written once); the old
//    form (one block walking the keys and the mask in device memory once or
//    twice a bit) was 160x the min-and-compare it replaces at 2^20 keys.
//    Design: a block holds MIN_CHUNK = 1,024 threads x 16 keys in registers,
//    read once; lanes past n read as KEY_INVALID. Each thread folds its keys
//    to their least (Alg. 1's survivor value over them), each warp reduces
//    its 32 lanes' values to theirs, and the warps' values meet in shared
//    memory behind one barrier, where every warp reduces them the same way.
//    Alg. 1's survivors over a union of parts are the rows equal to the
//    least of the parts' survivor values, which is min(v), so the split is
//    exact. Up to MIN_CHUNK keys that is one grid; above it, grid 1 writes
//    each block's value to scratch and grid 2 folds those values in every
//    block and writes the mask: the keys read twice, no block waiting on
//    another.
//    A warp's reduction is one __reduce_min_sync, the reference's
//    minima_mask_xla contract (the same rows for values >= 0). The literal
//    form, Alg. 1 over the 32 lanes with one __ballot_sync a bit ("does any
//    active word line hold a 0 here", the sense amplifier), stopping once
//    one lane is left, was built first: at the faithful cut's emission it
//    took about 4.7x the reduction's time on an H100, above 0.15 ms
//    (PERF.md's K4 row), so the reduction is kept.
//    minima_chunk and minima_part_ints tell the wrapper a block's keys and
//    the scratch a mask call needs, so the sizes live here alone.
//    minima_emit is the faithful emission, iterated Alg. 1 (Fig. 11), in
//    one launch of one block for streams of at most MIN_CHUNK keys: the keys
//    stay in registers (the caller's are never written), each warp keeps
//    its least active key in a shared array double-buffered by emission,
//    and an emission is: every warp reduces the warps' values to the
//    block's minimum m (no barrier before it is used), one thread writes it
//    (and the count of its rows), only the warps that held m invalidate
//    those lanes and reduce again, and one __syncthreads ends it. The loop
//    stops at the first m == KEY_INVALID and fills the remaining slots.
//    Of an emission's chain, the rescan (one warp) and the decision with
//    the barrier take about equal parts (tools/k4_emit_probe.py; PERF.md).
#include "ell_transpose.cuh"

namespace {

constexpr int32_t KEY_INVALID = 2147483647;
constexpr int ALIGN_THREADS = 256;
constexpr int BITMAP_WORDS = 4096;   // bitmap and prefix words (32 KB)
constexpr int64_t BITMAP_COLS = 32 * BITMAP_WORDS;
constexpr int LOOSE_BLOCKS = 1056;   // 8 blocks a Hopper SM
constexpr int BATCH = 4;             // lanes a thread loads before it uses
constexpr int32_t ROW_LANES = 65536; // lanes a row block takes at most

__global__ void align_keys_kernel(const int32_t* __restrict__ pk,
                                  const int32_t* __restrict__ uk,
                                  int32_t* __restrict__ slot,
                                  uint8_t* __restrict__ hit, int64_t n,
                                  int64_t u) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int32_t x = pk[i];
  int64_t lo = 0;
  int64_t hi = u;
  while (lo < hi) {
    const int64_t mid = (lo + hi) >> 1;
    if (__ldg(uk + mid) < x)
      lo = mid + 1;
    else
      hi = mid;
  }
  slot[i] = (int32_t)lo;
  hit[i] = (lo < u) && (__ldg(uk + lo) == x);
}

// The first of base[0, len) not below x (len when none is).
__device__ __forceinline__ int32_t lower_bound(const int32_t* base,
                                               int32_t len, int32_t x) {
  int32_t lo = 0;
  int32_t hi = len;
  while (lo < hi) {
    const int32_t mid = (lo + hi) >> 1;
    if (base[mid] < x)
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo;
}

// Row bounds of uk: bnd[r] = #{uk < r * n_cols}, r in [0, n_rows].
__global__ void key_bounds_kernel(const int32_t* __restrict__ uk,
                                  int32_t* __restrict__ bnd, int64_t u,
                                  int64_t n_rows, int64_t n_cols) {
  const int64_t r = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (r > n_rows) return;
  bnd[r] = lower_bound(uk, (int32_t)u, (int32_t)(r * n_cols));
}

// The segment of uk that holds every key of x's row: [lo, lo + len).
__device__ __forceinline__ void key_segment(int32_t x,
                                            const int32_t* __restrict__ bnd,
                                            int64_t u, int64_t n_rows,
                                            int64_t n_cols, int32_t& lo,
                                            int32_t& len) {
  int32_t hi;
  if (x < 0) {
    lo = 0;
    hi = bnd[0];
  } else if (x >= n_rows * n_cols) {
    lo = bnd[n_rows];
    hi = (int32_t)u;
  } else {
    const int32_t r = x / (int32_t)n_cols;
    lo = bnd[r];
    hi = bnd[r + 1];
  }
  len = hi - lo;
}

// A lane's key searched in its own key's segment of uk in device memory.
// Dead lanes repeat one key (KEY_INVALID, or 0 on the warm path), so each
// thread keeps the last such answer and reuses it for an equal key.
struct LooseSearch {
  const int32_t* uk;
  const int32_t* bnd;
  int64_t u, n_rows, n_cols;
  int32_t last_x = 0, last_slot = -1;
  bool last_hit = false;

  __device__ __forceinline__ void find(int32_t x, int32_t& slot,
                                       bool& hit) {
    if (last_slot < 0 || x != last_x) {
      int32_t lo, len;
      key_segment(x, bnd, u, n_rows, n_cols, lo, len);
      const int32_t p = lower_bound(uk + lo, len, x);
      last_x = x;
      last_slot = lo + p;
      last_hit = p < len && __ldg(uk + lo + p) == x;
    }
    slot = last_slot;
    hit = last_hit;
  }
};

// Lanes [j_lo, j_hi) of row r's groups (groups ids[rowptr[r]] ..
// ids[rowptr[r + 1] - 1], k_b lanes each, in lane order within each), aligned
// by the whole block. The row's segment of uk, keys r*n_cols + c for columns
// c < n_cols, is read once:
//  - as a bitmap of its columns with each word's exclusive popcount prefix
//    (n_cols <= BITMAP_COLS, uk strictly ascending there; two equal keys
//    would share a bit, so they send the row to the search): a key in the row
//    finds its slot as lo + prefix[c / 32] + the set bits below c in its
//    word, and its hit as bit c, two shared loads and no search;
//  - else (wider rows, or equal keys in the segment) searched in place: a
//    lower-bound binary search of uk[lo, lo + len).
// Any other lane searches its own key's segment in device memory.
__device__ void align_row_run(const int32_t* __restrict__ pk,
                              const int32_t* __restrict__ uk,
                              const int32_t* __restrict__ ids,
                              const int32_t* __restrict__ bnd,
                              int32_t* __restrict__ slot,
                              uint8_t* __restrict__ hit, int64_t u,
                              int64_t n_rows, int64_t n_cols, int32_t k_b,
                              int32_t r, int32_t g0, int32_t j_lo,
                              int32_t j_hi, int32_t* tile, int* wt) {
  __syncthreads();  // the block's previous run has left the tile
  const int32_t lo = bnd[r];
  const int32_t len = bnd[r + 1] - lo;
  const int32_t key_lo = (int32_t)(r * n_cols);
  const int32_t words = (int32_t)((n_cols + 31) / 32);
  uint32_t* bits = reinterpret_cast<uint32_t*>(tile);
  int32_t* prefix = tile + words;
  bool bitmap = n_cols <= BITMAP_COLS;
  if (bitmap) {
    for (int32_t w = threadIdx.x; w < words; w += ALIGN_THREADS) bits[w] = 0;
    __syncthreads();
    int equal = 0;
    for (int32_t i = threadIdx.x; i < len; i += ALIGN_THREADS) {
      const int32_t x = __ldg(uk + lo + i);
      const int32_t c = x - key_lo;     // in [0, n_cols) where uk ascends
      if (c >= 0 && c < n_cols && (i == 0 || __ldg(uk + lo + i - 1) < x))
        atomicOr(bits + (c >> 5), 1u << (c & 31));
      else
        equal = 1;
    }
    bitmap = !__syncthreads_or(equal);
    if (bitmap) {
      // exclusive prefix of the words' popcounts, a run of words a thread
      const int32_t per = (words + ALIGN_THREADS - 1) / ALIGN_THREADS;
      const int32_t w0 = threadIdx.x * per;
      int total = 0;
      for (int32_t k = 0; k < per && w0 + k < words; ++k)
        total += __popc(bits[w0 + k]);
      int run = radix::block_exclusive(total, wt);
      for (int32_t k = 0; k < per && w0 + k < words; ++k) {
        prefix[w0 + k] = run;
        run += __popc(bits[w0 + k]);
      }
      __syncthreads();
    }
  }
  LooseSearch other{uk, bnd, u, n_rows, n_cols};
  // BATCH lanes a thread at a time, their loads issued before any is used
  for (int64_t j0 = j_lo + threadIdx.x; j0 < j_hi;
       j0 += BATCH * ALIGN_THREADS) {
    int64_t lane[BATCH];
    int32_t x[BATCH];
#pragma unroll
    for (int q = 0; q < BATCH; ++q) {
      const int64_t j = j0 + q * ALIGN_THREADS;
      lane[q] = -1;
      if (j < j_hi) {
        const int32_t gi = (int32_t)j / k_b;
        lane[q] = (int64_t)ids[g0 + gi] * k_b + ((int32_t)j - gi * k_b);
      }
    }
#pragma unroll
    for (int q = 0; q < BATCH; ++q)
      if (lane[q] >= 0) x[q] = pk[lane[q]];
#pragma unroll
    for (int q = 0; q < BATCH; ++q) {
      if (lane[q] < 0) continue;
      int32_t sl;
      bool h;
      if (x[q] < key_lo || (int64_t)x[q] >= key_lo + n_cols) {
        other.find(x[q], sl, h);
      } else if (bitmap) {
        const int32_t c = x[q] - key_lo;
        const uint32_t w = bits[c >> 5];
        sl = lo + prefix[c >> 5] + __popc(w & ((1u << (c & 31)) - 1));
        h = (w >> (c & 31)) & 1;
      } else {
        const int32_t p = lower_bound(uk + lo, len, x[q]);
        sl = lo + p;
        h = p < len && __ldg(uk + lo + p) == x[q];
      }
      slot[lane[q]] = sl;
      hit[lane[q]] = h;
    }
  }
}

// The row of C whose groups hold sorted group position g < rowptr[n_rows]:
// the last r with rowptr[r] <= g (a row with groups).
__device__ __forceinline__ int32_t row_of(const int32_t* __restrict__ rowptr,
                                          int64_t n_rows, int32_t g) {
  int64_t lo = 0;
  int64_t hi = n_rows;
  while (lo < hi) {
    const int64_t mid = (lo + hi) >> 1;
    if (rowptr[mid + 1] <= g)
      lo = mid + 1;
    else
      hi = mid;
  }
  return (int32_t)lo;
}

// Blocks r < n_rows: row r's lanes [0, ROW_LANES). Block n_rows + e: the
// lanes at or past ROW_LANES of each row that meet [e, e + 1) * ROW_LANES of
// the rows' lanes in sorted order. A row that lies wholly inside that range
// has at most ROW_LANES lanes, so only the rows at its two ends can have
// such lanes: each block takes at most ROW_LANES lanes, and a row's blocks
// follow its lane count. Six blocks an SM (32.8 KB of shared memory each)
// need at most 40 registers a thread.
__global__ void __launch_bounds__(ALIGN_THREADS, 6)
align_rows_kernel(const int32_t* __restrict__ pk,
                  const int32_t* __restrict__ uk,
                  const int32_t* __restrict__ ids,
                  const int32_t* __restrict__ rowptr,
                  const int32_t* __restrict__ bnd,
                  int32_t* __restrict__ slot, uint8_t* __restrict__ hit,
                  int64_t u, int64_t n_rows, int64_t n_cols, int32_t k_b) {
  __shared__ int32_t tile[2 * BITMAP_WORDS];
  __shared__ int wt[ALIGN_THREADS / 32];
  const int64_t b = blockIdx.x;
  const bool first = b < n_rows;  // a row's first ROW_LANES lanes
  int64_t p0 = 0;
  int64_t p1 = 0;
  int32_t r0 = (int32_t)b;
  int32_t r1 = r0;
  if (!first) {
    const int64_t end = (int64_t)rowptr[n_rows] * k_b;
    p0 = (b - n_rows) * ROW_LANES;
    if (p0 >= end) return;
    p1 = min(p0 + ROW_LANES, end);
    r0 = row_of(rowptr, n_rows, (int32_t)(p0 / k_b));
    r1 = row_of(rowptr, n_rows, (int32_t)((p1 - 1) / k_b));
  }
  for (int32_t r = r0;; r = r1) {
    const int32_t g0 = rowptr[r];
    const int32_t lanes = (rowptr[r + 1] - g0) * k_b;
    int32_t j_lo = 0;
    int32_t j_hi = min(lanes, ROW_LANES);
    if (!first) {
      const int64_t base = (int64_t)g0 * k_b;
      j_lo = (int32_t)max(p0 - base, (int64_t)ROW_LANES);
      j_hi = (int32_t)min(p1 - base, (int64_t)lanes);
    }
    if (j_lo < j_hi)  // the same for the whole block
      align_row_run(pk, uk, ids, bnd, slot, hit, u, n_rows, n_cols, k_b, r,
                    g0, j_lo, j_hi, tile, wt);
    if (r == r1) break;
  }
}

// The lanes no row block owns: those of the groups outside [0, n_rows)
// (sorted positions rowptr[n_rows] .. groups - 1), then the lanes past
// groups * k_b; a grid-stride loop, the first count read on the device.
// n < 2^31, so a lane and its division are 32-bit.
__global__ void __launch_bounds__(ALIGN_THREADS)
align_loose_kernel(const int32_t* __restrict__ pk,
                   const int32_t* __restrict__ uk,
                   const int32_t* __restrict__ ids,
                   const int32_t* __restrict__ rowptr,
                   const int32_t* __restrict__ bnd,
                   int32_t* __restrict__ slot, uint8_t* __restrict__ hit,
                   int32_t n, int64_t u, int32_t groups, int64_t n_rows,
                   int64_t n_cols, int32_t k_b) {
  const int32_t first = rowptr[n_rows];
  const int32_t dead = (groups - first) * k_b;
  const int32_t loose = dead + (n - groups * k_b);
  const int64_t stride = (int64_t)gridDim.x * ALIGN_THREADS;
  LooseSearch other{uk, bnd, u, n_rows, n_cols};
  for (int64_t j0 = (int64_t)blockIdx.x * ALIGN_THREADS + threadIdx.x;
       j0 < loose; j0 += BATCH * stride) {
    int32_t lane[BATCH];
    int32_t x[BATCH];
#pragma unroll
    for (int q = 0; q < BATCH; ++q) {
      const int64_t j = j0 + q * stride;
      lane[q] = -1;
      if (j < dead) {
        const int32_t gi = (int32_t)j / k_b;
        lane[q] = ids[first + gi] * k_b + ((int32_t)j - gi * k_b);
      } else if (j < loose) {
        lane[q] = groups * k_b + (int32_t)(j - dead);
      }
    }
#pragma unroll
    for (int q = 0; q < BATCH; ++q)
      if (lane[q] >= 0) x[q] = pk[lane[q]];
#pragma unroll
    for (int q = 0; q < BATCH; ++q) {
      if (lane[q] < 0) continue;
      int32_t sl;
      bool h;
      other.find(x[q], sl, h);
      slot[lane[q]] = sl;
      hit[lane[q]] = h;
    }
  }
}

constexpr int MIN_THREADS = 1024;
constexpr int MIN_KEYS = 16;                          // a thread's keys
constexpr int64_t MIN_CHUNK = (int64_t)MIN_THREADS * MIN_KEYS;
constexpr int MIN_PARTS = 1024;                       // grid 1's blocks
constexpr unsigned FULL = 0xffffffffu;

// The survivors' value of Alg. 1 over the 32 lanes of a warp, each offering
// one value (KEY_INVALID: no active row), in every lane; KEY_INVALID when no
// lane is active. For values >= 0, as Alg. 1 scans bits 30..0, that is
// their least: one __reduce_min_sync.
__device__ __forceinline__ int32_t warp_minima(int32_t x) {
  return __reduce_min_sync(FULL, x);
}

// The block's survivor value over each thread's x: each warp's value to
// shared memory, one barrier, then every warp reduces the warps' values.
// Called once a kernel (wv is not reused).
__device__ __forceinline__ int32_t block_minima(int32_t x, int32_t* wv) {
  const int32_t w = warp_minima(x);
  if ((threadIdx.x & 31) == 0) wv[threadIdx.x >> 5] = w;
  __syncthreads();
  const int lane = threadIdx.x & 31;
  return warp_minima(lane < (int)(blockDim.x >> 5) ? wv[lane] : KEY_INVALID);
}

// A thread's MIN_KEYS keys of the chunk at base: lanes base + j*blockDim.x
// + threadIdx.x (each load coalesced across the warp), KEY_INVALID past n.
__device__ __forceinline__ void load_keys(const int32_t* __restrict__ v,
                                          int64_t n, int64_t base,
                                          int32_t (&k)[MIN_KEYS]) {
#pragma unroll
  for (int j = 0; j < MIN_KEYS; ++j) {
    const int64_t i = base + (int64_t)j * blockDim.x + threadIdx.x;
    k[j] = i < n ? __ldg(v + i) : KEY_INVALID;
  }
}

// The least of a thread's keys, folded as a tree (4 dependent steps).
__device__ __forceinline__ int32_t fold_keys(const int32_t (&k)[MIN_KEYS]) {
  int32_t t[MIN_KEYS / 2];
#pragma unroll
  for (int j = 0; j < MIN_KEYS / 2; ++j) t[j] = min(k[2 * j], k[2 * j + 1]);
#pragma unroll
  for (int w = MIN_KEYS / 4; w >= 1; w /= 2)
#pragma unroll
    for (int j = 0; j < w; ++j) t[j] = min(t[2 * j], t[2 * j + 1]);
  return t[0];
}

// The chunk's mask lanes: an active row holding the minimum m.
__device__ __forceinline__ void store_mask(uint8_t* __restrict__ mask,
                                           int64_t n, int64_t base,
                                           const int32_t (&k)[MIN_KEYS],
                                           int32_t m) {
#pragma unroll
  for (int j = 0; j < MIN_KEYS; ++j) {
    const int64_t i = base + (int64_t)j * blockDim.x + threadIdx.x;
    if (i < n) mask[i] = k[j] == m && m != KEY_INVALID;
  }
}

// n <= MIN_CHUNK: one block, the keys read once, the mask written once.
__global__ void __launch_bounds__(MIN_THREADS)
minima_mask_kernel(const int32_t* __restrict__ v, uint8_t* __restrict__ mask,
                   int64_t n) {
  __shared__ int32_t wv[32];
  int32_t k[MIN_KEYS];
  load_keys(v, n, 0, k);
  const int32_t m = block_minima(fold_keys(k), wv);
  store_mask(mask, n, 0, k, m);
}

// n > MIN_CHUNK, grid 1: block b folds chunks b, b + gridDim.x, ... and
// writes their survivors' value to part[b].
__global__ void __launch_bounds__(MIN_THREADS)
minima_part_kernel(const int32_t* __restrict__ v, int32_t* __restrict__ part,
                   int64_t n) {
  __shared__ int32_t wv[32];
  int32_t lo = KEY_INVALID;
  for (int64_t base = blockIdx.x * MIN_CHUNK; base < n;
       base += (int64_t)gridDim.x * MIN_CHUNK) {
    int32_t k[MIN_KEYS];
    load_keys(v, n, base, k);
    lo = min(lo, fold_keys(k));
  }
  const int32_t m = block_minima(lo, wv);
  if (threadIdx.x == 0) part[blockIdx.x] = m;
}

// Grid 2: every block folds the gridDim.x parts to min(v), then writes the
// mask lanes of the same chunks.
__global__ void __launch_bounds__(MIN_THREADS)
minima_apply_kernel(const int32_t* __restrict__ v,
                    const int32_t* __restrict__ part,
                    uint8_t* __restrict__ mask, int64_t n) {
  __shared__ int32_t wv[32];
  int32_t lo = KEY_INVALID;
  for (int i = threadIdx.x; i < (int)gridDim.x; i += blockDim.x)
    lo = min(lo, part[i]);
  const int32_t m = block_minima(lo, wv);
  for (int64_t base = blockIdx.x * MIN_CHUNK; base < n;
       base += (int64_t)gridDim.x * MIN_CHUNK) {
    int32_t k[MIN_KEYS];
    load_keys(v, n, base, k);
    store_mask(mask, n, base, k, m);
  }
}

// The faithful emission of n <= MIN_CHUNK keys: vals[e] the e-th least
// distinct active key (KEY_INVALID past the last), counts[e] (when given)
// its rows (0 past the last), *nnz the keys emitted plus 1 if an active row
// is left after out_cap emissions.
__global__ void __launch_bounds__(MIN_THREADS)
minima_emit_kernel(const int32_t* __restrict__ key, int64_t n,
                   int32_t* __restrict__ vals, int32_t* __restrict__ counts,
                   int32_t* __restrict__ nnz, int64_t out_cap) {
  __shared__ int32_t wv[2][32];  // each warp's least active key, by parity
  __shared__ int32_t cnt[2];     // rows of the emission's key, by parity
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  int32_t k[MIN_KEYS];
  load_keys(key, n, 0, k);
  int32_t w = warp_minima(fold_keys(k));
  if (lane == 0) wv[0][warp] = w;
  if (threadIdx.x < 2) cnt[threadIdx.x] = 0;
  __syncthreads();
  int64_t e = 0;
  for (; e < out_cap; ++e) {
    const int p = (int)(e & 1);
    // the block's Alg. 1 decision, the same in every warp
    const int32_t m = warp_minima(lane < warps ? wv[p][lane] : KEY_INVALID);
    if (m == KEY_INVALID) break;
    if (threadIdx.x == 0) {
      vals[e] = m;
      if (counts && e > 0) {  // the last emission's adds ended at its barrier
        counts[e - 1] = cnt[p ^ 1];
        cnt[p ^ 1] = 0;
      }
    }
    if (w == m) {  // this warp held m: consume its rows, reduce again
      int c = 0;
#pragma unroll
      for (int j = 0; j < MIN_KEYS; ++j) {
        c += k[j] == m;
        k[j] = k[j] == m ? KEY_INVALID : k[j];
      }
      if (counts) {
        c = __reduce_add_sync(FULL, c);
        if (lane == 0) atomicAdd(&cnt[p], c);
      }
      w = warp_minima(fold_keys(k));
    }
    if (lane == 0) wv[p ^ 1][warp] = w;
    __syncthreads();
  }
  // e is the same in every thread: the emissions made
  const int32_t left =
      warp_minima(lane < warps ? wv[e & 1][lane] : KEY_INVALID);
  if (threadIdx.x == 0) {
    if (counts && e > 0) counts[e - 1] = cnt[(e - 1) & 1];
    *nnz = (int32_t)e + (left != KEY_INVALID);
  }
  for (int64_t s = e + threadIdx.x; s < out_cap; s += blockDim.x) {
    vals[s] = KEY_INVALID;
    if (counts) counts[s] = 0;
  }
}

// Threads of a block that holds n <= MIN_CHUNK keys: whole warps, enough
// for MIN_KEYS keys each.
int chunk_threads(int64_t n) {
  const int64_t t = (n + MIN_KEYS - 1) / MIN_KEYS;
  return (int)(t <= 32 ? 32 : (t + 31) / 32 * 32);
}

}  // namespace

extern "C" int align_keys(const void* pk, const void* uk, void* slot,
                          void* hit, long long n, long long u, void* stream) {
  if (n > 0) {
    const int threads = 256;
    align_keys_kernel<<<(unsigned)((n + threads - 1) / threads), threads, 0,
                        (cudaStream_t)stream>>>(
        (const int32_t*)pk, (const int32_t*)uk, (int32_t*)slot,
        (uint8_t*)hit, n, u);
  }
  return (int)cudaGetLastError();
}

// The flat entry's answer, grouped by row of C: pk (n,) in SCCP lane order
// (group g's k_b keys at g*k_b), group_row (groups,) each group's row of C,
// uk (u,) ascending. `scratch` holds scratch_len int32s, at least the
// transpose's ellt::scratch_ints(groups, n_rows) then n_rows + 1 row bounds
// (kernels/insitu_search.py sizes it). *grids receives the grids launched.
extern "C" int align_product_keys(const void* pk, const void* uk,
                                  const void* group_row, void* slot,
                                  void* hit, void* scratch,
                                  long long scratch_len, long long n,
                                  long long u, long long groups,
                                  long long k_b, long long n_rows,
                                  long long n_cols, int* grids,
                                  void* stream) {
  *grids = 0;
  if (n < 0 || u < 0 || groups < 0 || k_b < 0 || n_rows < 0 || n_cols < 0 ||
      n >= (1LL << 31) || u >= (1LL << 31) || groups * k_b > n ||
      n_rows * n_cols >= KEY_INVALID ||
      n_rows + (n + ROW_LANES - 1) / ROW_LANES >= (1LL << 31) ||
      scratch_len < ellt::scratch_ints(groups, n_rows) + n_rows + 1)
    return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  if (k_b == 0) groups = 0;
  cudaStream_t st = (cudaStream_t)stream;
  const int32_t* ids;
  int32_t* rowptr;
  int err = ellt::transpose((const int32_t*)group_row, groups, n_rows,
                            (int32_t*)scratch, &ids, &rowptr, grids, st);
  if (err) return err;
  int32_t* bnd = (int32_t*)scratch + ellt::scratch_ints(groups, n_rows);
  key_bounds_kernel<<<(unsigned)((n_rows + 1 + 255) / 256), 256, 0, st>>>(
      (const int32_t*)uk, bnd, u, n_rows, n_cols);
  ++*grids;
  if ((err = (int)cudaGetLastError())) return err;
  if (n_rows > 0) {
    // a block for each row's first ROW_LANES lanes, and one for each
    // ROW_LANES of all the rows' lanes, for the lanes past them
    const int64_t blocks =
        n_rows + (groups * k_b + ROW_LANES - 1) / ROW_LANES;
    align_rows_kernel<<<(unsigned)blocks, ALIGN_THREADS, 0, st>>>(
        (const int32_t*)pk, (const int32_t*)uk, ids, rowptr, bnd,
        (int32_t*)slot, (uint8_t*)hit, u, n_rows, n_cols, (int32_t)k_b);
    ++*grids;
    if ((err = (int)cudaGetLastError())) return err;
  }
  const int64_t blocks = (n + ALIGN_THREADS - 1) / ALIGN_THREADS;
  align_loose_kernel<<<(unsigned)(blocks < LOOSE_BLOCKS ? blocks
                                                        : LOOSE_BLOCKS),
                       ALIGN_THREADS, 0, st>>>(
      (const int32_t*)pk, (const int32_t*)uk, ids, rowptr, bnd,
      (int32_t*)slot, (uint8_t*)hit, (int32_t)n, u, (int32_t)groups, n_rows,
      n_cols, (int32_t)(k_b > 0 ? k_b : 1));
  ++*grids;
  return (int)cudaGetLastError();
}

// Keys one block of the minima kernels holds: minima_emit takes at most
// this many, and minima_mask launches one grid up to it.
extern "C" int minima_chunk() { return (int)MIN_CHUNK; }

// int32 scratch of a minima_mask call on n keys: one survivor value for
// each block of grid 1, none while one block holds the keys.
extern "C" int minima_part_ints(long long n) {
  if (n <= MIN_CHUNK) return 0;
  const int64_t chunks = (n + MIN_CHUNK - 1) / MIN_CHUNK;
  return (int)(chunks < MIN_PARTS ? chunks : MIN_PARTS);
}

// Mask of the active rows of v (n,) holding min(v): one grid for n <=
// MIN_CHUNK, else two over `part` (minima_part_ints(n) int32s); none for
// n = 0. *grids receives the grids launched.
extern "C" int minima_mask(const void* v, void* mask, void* part,
                           long long part_len, long long n, int* grids,
                           void* stream) {
  *grids = 0;
  const int parts = minima_part_ints(n);
  if (n < 0 || n >= (1LL << 31) || part_len < parts)
    return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  if (n <= MIN_CHUNK) {
    minima_mask_kernel<<<1, chunk_threads(n), 0, st>>>(
        (const int32_t*)v, (uint8_t*)mask, n);
    ++*grids;
    return (int)cudaGetLastError();
  }
  minima_part_kernel<<<(unsigned)parts, MIN_THREADS, 0, st>>>(
      (const int32_t*)v, (int32_t*)part, n);
  ++*grids;
  int err = (int)cudaGetLastError();
  if (err) return err;
  minima_apply_kernel<<<(unsigned)parts, MIN_THREADS, 0, st>>>(
      (const int32_t*)v, (const int32_t*)part, (uint8_t*)mask, n);
  ++*grids;
  return (int)cudaGetLastError();
}

// The faithful emission of key (n,), n <= MIN_CHUNK, in one launch: vals
// (out_cap,), counts (out_cap,) or null, nnz one int32.
extern "C" int minima_emit(const void* key, long long n, void* vals,
                           void* counts, void* nnz, long long out_cap,
                           void* stream) {
  if (n < 0 || n > MIN_CHUNK || out_cap < 0)
    return (int)cudaErrorInvalidValue;
  minima_emit_kernel<<<1, chunk_threads(n), 0, (cudaStream_t)stream>>>(
      (const int32_t*)key, n, (int32_t*)vals, (int32_t*)counts,
      (int32_t*)nnz, out_cap);
  return (int)cudaGetLastError();
}

extern "C" const char* insitu_search_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
