// Stable binning of the 'bucket' accumulator for Hopper (sm_90a).
//
// Replaces src/repro/kernels/radix_bucket.py:_make_rank_kernel, the rank of
// each lane within its bucket,
//     rank[i] = #{j <= i : bid[j] == bid[i]} - 1,
// and -1 where bid[i] < 0 (a dead lane) or bid[i] >= n_buckets (an id no
// bucket owns, as the TPU kernel's one-hot columns give it), together with
// the placement around it in _bucket_merge_jit: every valid product of a
// packed-key stream goes to slot bid * bucket_cap + rank of an
// (n_buckets * bucket_cap,) layout when rank < bucket_cap, every empty slot
// holds KEY_INVALID / 0, and the products past a full bucket are counted.
// Two entries share the device code: bin_ranks (ids in, ranks out, the TPU
// kernel's function) and bin_stream (keys and values in, the layout and the
// drop count out, the 'bucket' path's binning).
//
// Bound: bytes. bin_ranks reads an id and writes a rank, 8 bytes a lane;
// bin_stream reads a key and a value, 8 bytes a lane, and writes a key and a
// value, 8 bytes a slot. The work is a few integer operations a lane. The
// TPU kernel carries an (n_buckets,) counter through a sequential scan over
// chunks; Hopper's blocks run in no order, so the carry becomes three grids
// over tiles of TILE = 4,096 lanes, reduce-then-scan, with no block waiting
// on another:
//   1. count: one block a tile. Warp w owns the tile's lanes w*512 ..
//      w*512+511, 16 a thread, and walks them in lane order. A lane's bucket
//      comes from its id, or from its key in registers (key / keys_per_bucket
//      by a wide multiply and a shift, clamped to the last bucket;
//      KEY_INVALID is dead;
//      a key below 0, which no bucket owns, goes to a lost column that
//      counts as dropped). Peers of one bucket in the 32 lanes come from a
//      reduction and two votes where the warp's live lanes share a bucket
//      (the common case: neighbouring products share an output row, with
//      dead lanes among them), else from __match_any_sync; the lowest peer
//      adds their number to the warp's counter in shared memory, and each
//      lane's rank in its warp is that counter before the add plus its
//      lower peers. The tile's count of each bucket goes to a
//      (n_buckets + 1) x n_tiles matrix.
//   2. scan: one block a column turns its tile counts into exclusive
//      offsets and writes the column's total.
//   3. rank (bin_ranks) or place (bin_stream): the count grid's walk again,
//      then a lane's rank is its tile's offset + the lanes of its bucket in
//      earlier warps of the tile + its rank in its warp. bin_ranks writes it;
//      bin_stream writes an in-capacity lane's key and value straight to its
//      slot, and dead, lost and dropped lanes write nothing. The same grid's
//      last blocks fill only each bucket's empty tail [min(total, cap), cap)
//      with KEY_INVALID / 0, and its first fill block sums
//      dropped = sum_b max(0, total_b - cap) + lost, with no atomics.
// Every rank is the stable one: the place grid writes the stream's lanes of
// a bucket in lane order, so the row sort that follows (K5) sums each run's
// values in the order the plain twin gives them. Lanes are indexed in 64
// bits; counts and ranks are int32, so a stream holds fewer than 2^31 lanes
// (the wrappers check).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;            // 8
constexpr int ITEMS = 16;                      // lanes a thread a tile
constexpr int WARP_LANES = 32 * ITEMS;         // 512
constexpr int TILE = THREADS * ITEMS;          // 4,096
constexpr int MAX_BUCKETS = 256;
constexpr int MAX_COLS = MAX_BUCKETS + 1;      // + bin_stream's lost column
constexpr int SCAN_THREADS = 1024;
constexpr int SCAN_ITEMS = 4;
constexpr int FILL = 16384;                    // layout slots a fill block
constexpr int32_t KEY_INVALID = 2147483647;
constexpr unsigned FULL = 0xffffffffu;

// Lane l's 4 bytes through the read-only path where l < n, else `dead`.
// Volatile, so each thread's loads of a tile are all issued before the walk
// uses the first: the compiler otherwise sinks each load into the step of
// the walk that uses it, one load's latency a step.
__device__ __forceinline__ int32_t load_lane(const int32_t* p, int64_t l,
                                             int64_t n, int32_t dead) {
  int32_t v = dead;
  asm volatile(
      "{\n\t.reg .pred p;\n\tsetp.lt.s64 p, %1, %2;\n\t"
      "@p ld.global.nc.b32 %0, [%3];\n\t}"
      : "+r"(v)
      : "l"(l), "l"(n), "l"(p + l));
  return v;
}

// bin_ranks' lanes: an id is its bucket, -1 outside [0, nb).
struct IdLanes {
  static constexpr int32_t kDead = -1;       // a lane past the stream's end
  const int32_t* in;
  int nb;
  __device__ __forceinline__ int bucket(int32_t b) const {
    return b >= 0 && b < nb ? b : -1;
  }
};

// bin_stream's lanes: a packed key's bucket is key / keys_per_bucket,
// clamped to nb - 1 (the slack rows of a ceil split). For keys below 2^31
// and a divisor d < 2^31, floor(key / d) = (magic * key) >> shift exactly,
// with shift = 31 + ceil(log2 d) and magic = 2^shift / d + 1 < 2^32
// (Granlund and Montgomery): one wide multiply and a shift, no branch.
// KEY_INVALID is dead (-1); a key below 0 goes to the lost column nb.
struct KeyLanes {
  static constexpr int32_t kDead = KEY_INVALID;
  const int32_t* in;
  int nb;
  unsigned magic;
  int shift;
  __device__ __forceinline__ int bucket(int32_t k) const {
    const unsigned q = (unsigned)(((unsigned long long)magic * (unsigned)k)
                                  >> shift);
    const int b = q < (unsigned)nb ? (int)q : nb - 1;
    return k == KEY_INVALID ? -1 : k < 0 ? nb : b;
  }
};

// The walk of one tile from lane `first`: each thread's 16 lanes (x, dead
// past the stream's end) and, for each, its bucket and its rank within the
// warp packed as (bucket << 16) | rank, or -1 for a dead lane (br); the
// warp's count of each column is left in wc[warp * cols + column], which
// must hold zeros. Where the warp's live lanes of an item share one bucket
// (the common case: neighbouring products share an output row, dead lanes
// among them) one reduction and two votes find them; else
// __match_any_sync groups the lanes by bucket.
template <class Src>
__device__ __forceinline__ void walk_tile(const Src& src, int64_t first,
                                          int64_t n, int cols, int* wc,
                                          int32_t (&x)[ITEMS],
                                          int (&br)[ITEMS]) {
  const int lane = threadIdx.x & 31;
  const int64_t at = first + (threadIdx.x >> 5) * WARP_LANES + lane;
#pragma unroll
  for (int i = 0; i < ITEMS; ++i)
    x[i] = load_lane(src.in, at + i * 32, n, Src::kDead);
  int* mine = wc + (threadIdx.x >> 5) * cols;
  const unsigned lower = (1u << lane) - 1;
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    const int b = src.bucket(x[i]);
    const int top = __reduce_max_sync(FULL, b);
    const unsigned peers = __all_sync(FULL, b < 0 || b == top)
                               ? __ballot_sync(FULL, b >= 0)
                               : __match_any_sync(FULL, b);
    const int below = __popc(peers & lower);
    const int before = b >= 0 ? mine[b] : 0;
    __syncwarp();
    if (b >= 0 && below == 0) mine[b] = before + __popc(peers);
    __syncwarp();
    br[i] = b < 0 ? -1 : (b << 16) | (before + below);
  }
}

__device__ __forceinline__ void zero(int* wc, int cols) {
  for (int i = threadIdx.x; i < WARPS * cols; i += THREADS) wc[i] = 0;
  __syncthreads();
}

template <class Src>
__global__ void __launch_bounds__(THREADS)
bin_count_kernel(Src src, int64_t n, int cols, int64_t n_tiles,
                 int32_t* __restrict__ counts) {
  __shared__ int wc[WARPS * MAX_COLS];
  zero(wc, cols);
  int32_t x[ITEMS];
  int br[ITEMS];
  walk_tile(src, (int64_t)blockIdx.x * TILE, n, cols, wc, x, br);
  __syncthreads();
  for (int c = threadIdx.x; c < cols; c += THREADS) {
    int sum = 0;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) sum += wc[w * cols + c];
    counts[(int64_t)c * n_tiles + blockIdx.x] = sum;
  }
}

// One block a column: exclusive offsets over the tiles, in place, in strips
// of SCAN_THREADS * SCAN_ITEMS counts; the column's total to totals[c].
__global__ void __launch_bounds__(SCAN_THREADS)
bin_scan_kernel(int32_t* __restrict__ counts, int64_t n_tiles,
                int32_t* __restrict__ totals) {
  __shared__ int warp_sum[SCAN_THREADS / 32];
  int32_t* col = counts + (int64_t)blockIdx.x * n_tiles;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int carry = 0;
  for (int64_t strip = 0; strip < n_tiles;
       strip += SCAN_THREADS * SCAN_ITEMS) {
    const int64_t at = strip + (int64_t)threadIdx.x * SCAN_ITEMS;
    int v[SCAN_ITEMS];
    int sum = 0;
#pragma unroll
    for (int q = 0; q < SCAN_ITEMS; ++q) {
      v[q] = at + q < n_tiles ? col[at + q] : 0;
      sum += v[q];
    }
    int inc = sum;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int t = __shfl_up_sync(FULL, inc, off);
      if (lane >= off) inc += t;
    }
    if (lane == 31) warp_sum[warp] = inc;
    __syncthreads();
    if (warp == 0) {
      int w = warp_sum[lane];
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int t = __shfl_up_sync(FULL, w, off);
        if (lane >= off) w += t;
      }
      warp_sum[lane] = w;
    }
    __syncthreads();
    int run = carry + (warp ? warp_sum[warp - 1] : 0) + inc - sum;
#pragma unroll
    for (int q = 0; q < SCAN_ITEMS; ++q)
      if (at + q < n_tiles) {
        col[at + q] = run;
        run += v[q];
      }
    carry += warp_sum[SCAN_THREADS / 32 - 1];
    __syncthreads();
  }
  if (threadIdx.x == 0) totals[blockIdx.x] = carry;
}

// The walk of tile blockIdx.x, then wc[warp * cols + column] turned into
// the tile's offset of the column plus its lanes in earlier warps. The
// tile's offsets are loaded before the walk, so their latency hides behind
// it.
template <class Src>
__device__ __forceinline__ void rank_tile(const Src& src, int64_t n, int cols,
                                          int64_t n_tiles,
                                          const int32_t* __restrict__ offs,
                                          int* wc, int32_t (&x)[ITEMS],
                                          int (&br)[ITEMS]) {
  static_assert(MAX_COLS <= 2 * THREADS, "two columns a thread");
  int off[2];
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const int c = threadIdx.x + k * THREADS;
    off[k] = c < cols ? offs[(int64_t)c * n_tiles + blockIdx.x] : 0;
  }
  zero(wc, cols);
  walk_tile(src, (int64_t)blockIdx.x * TILE, n, cols, wc, x, br);
  __syncthreads();
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const int c = threadIdx.x + k * THREADS;
    if (c >= cols) break;
    int run = off[k];
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const int t = wc[w * cols + c];
      wc[w * cols + c] = run;
      run += t;
    }
  }
  __syncthreads();
}

__global__ void __launch_bounds__(THREADS)
bin_rank_kernel(IdLanes src, int64_t n, int cols, int64_t n_tiles,
                const int32_t* __restrict__ offs, int32_t* __restrict__ rank) {
  __shared__ int wc[WARPS * MAX_COLS];
  int32_t x[ITEMS];
  int br[ITEMS];
  rank_tile(src, n, cols, n_tiles, offs, wc, x, br);
  const int* mine = wc + (threadIdx.x >> 5) * cols;
  const int64_t at = (int64_t)blockIdx.x * TILE +
                     (threadIdx.x >> 5) * WARP_LANES + (threadIdx.x & 31);
#pragma unroll
  for (int i = 0; i < ITEMS; ++i)
    if (at + i * 32 < n)
      rank[at + i * 32] =
          br[i] < 0 ? -1 : mine[br[i] >> 16] + (br[i] & 0xffff);
}

// Blocks [0, n_tiles) place a tile's lanes; the rest fill the empty tails,
// FILL slots of the layout a block, and the first of them counts the drops.
__global__ void __launch_bounds__(THREADS)
bin_place_kernel(KeyLanes src, const float* __restrict__ val, int64_t n,
                 int64_t n_tiles, const int32_t* __restrict__ offs,
                 const int32_t* __restrict__ totals, int lg_cap,
                 int32_t* __restrict__ key_out, float* __restrict__ val_out,
                 int32_t* __restrict__ dropped) {
  __shared__ int wc[WARPS * MAX_COLS];
  const int nb = src.nb;
  const int cols = nb + 1;
  const int64_t cap = (int64_t)1 << lg_cap;
  if (blockIdx.x >= n_tiles) {
    int* lim = wc;                                     // min(total_b, cap)
    for (int c = threadIdx.x; c < nb; c += THREADS)
      lim[c] = totals[c] < cap ? totals[c] : (int)cap;
    const int64_t fb = blockIdx.x - n_tiles;
    if (fb == 0 && threadIdx.x < 32) {
      long long d = 0;
      for (int c = threadIdx.x; c < cols; c += 32) {
        const int64_t t = totals[c];
        d += c < nb ? (t > cap ? t - cap : 0) : t;
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        d += __shfl_down_sync(FULL, d, off);
      if (threadIdx.x == 0) *dropped = (int32_t)d;
    }
    __syncthreads();
    const int64_t lo = fb * FILL;
    const int64_t end = (int64_t)nb << lg_cap;
    const int64_t hi = lo + FILL < end ? lo + FILL : end;
    // placed slots are a prefix of each bucket: a block inside one bucket
    // whose last slot is placed has nothing to fill
    if ((lo >> lg_cap) == ((hi - 1) >> lg_cap) &&
        ((hi - 1) & (cap - 1)) < lim[lo >> lg_cap])
      return;
    for (int64_t s = lo + threadIdx.x; s < hi; s += THREADS)
      if ((s & (cap - 1)) >= lim[s >> lg_cap]) {
        key_out[s] = KEY_INVALID;
        val_out[s] = 0.0f;
      }
    return;
  }
  const int64_t at = (int64_t)blockIdx.x * TILE +
                     (threadIdx.x >> 5) * WARP_LANES + (threadIdx.x & 31);
  int32_t v[ITEMS];                                    // the values' bits
#pragma unroll
  for (int i = 0; i < ITEMS; ++i)
    v[i] = load_lane(reinterpret_cast<const int32_t*>(val), at + i * 32, n,
                     0);
  int32_t x[ITEMS];
  int br[ITEMS];
  rank_tile(src, n, cols, n_tiles, offs, wc, x, br);
  const int* mine = wc + (threadIdx.x >> 5) * cols;
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    const int b = br[i] >> 16;
    if (br[i] < 0 || b == nb) continue;                // dead or lost
    const int64_t rank = mine[b] + (br[i] & 0xffff);
    if (rank >= cap) continue;                         // dropped
    const int64_t slot = ((int64_t)b << lg_cap) + rank;
    key_out[slot] = x[i];
    val_out[slot] = __int_as_float(v[i]);
  }
}

// The count and scan grids over `src`'s n lanes, then `last(n_tiles,
// offsets, totals)`, which launches the third; *grids counts the grids.
// scratch holds (nb + 1) * (n_tiles + 1) int32, one tile at least.
template <class Src, class Last>
int three_grids(const Src& src, int64_t n, void* scratch, int* grids,
                cudaStream_t st, Last last) {
  const int cols = src.nb + 1;
  const int64_t n_tiles = n > 0 ? (n + TILE - 1) / TILE : 1;
  int32_t* counts = (int32_t*)scratch;
  int32_t* totals = counts + cols * n_tiles;
  bin_count_kernel<<<(unsigned)n_tiles, THREADS, 0, st>>>(src, n, cols,
                                                          n_tiles, counts);
  int err = (int)cudaGetLastError();
  ++*grids;
  if (err) return err;
  bin_scan_kernel<<<cols, SCAN_THREADS, 0, st>>>(counts, n_tiles, totals);
  err = (int)cudaGetLastError();
  ++*grids;
  if (err) return err;
  err = last(n_tiles, counts, totals);
  ++*grids;
  return err;
}

}  // namespace

// rank (n,) int32 from bid (n,) int32; scratch holds
// (n_buckets + 1) * (ceil(n / 4096) + 1) int32 (at least one tile).
// *grids receives the grids launched.
extern "C" int bin_ranks(const void* bid, void* rank, void* scratch,
                         long long n, int n_buckets, int* grids,
                         void* stream) {
  *grids = 0;
  if (n < 0 || n > INT32_MAX || n_buckets < 1 || n_buckets > MAX_BUCKETS)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const IdLanes src{(const int32_t*)bid, n_buckets};
  return three_grids(src, n, scratch, grids, st,
                     [&](int64_t n_tiles, const int32_t* offs,
                         const int32_t*) {
    bin_rank_kernel<<<(unsigned)n_tiles, THREADS, 0, st>>>(
        src, n, n_buckets + 1, n_tiles, offs, (int32_t*)rank);
    return (int)cudaGetLastError();
  });
}

// The (n_buckets << lg_cap,) layout binned_key / binned_val and the int32
// drop count from key (n,) int32 and val (n,) float32, buckets of
// keys_per_bucket keys; scratch as bin_ranks'. *grids receives the grids
// launched.
extern "C" int bin_stream(const void* key, const void* val, void* binned_key,
                          void* binned_val, void* dropped, void* scratch,
                          long long n, int n_buckets, int lg_cap,
                          long long keys_per_bucket, int* grids,
                          void* stream) {
  *grids = 0;
  if (n < 0 || n > INT32_MAX || n_buckets < 1 || n_buckets > MAX_BUCKETS ||
      lg_cap < 0 || lg_cap > 40 || keys_per_bucket < 1 ||
      keys_per_bucket > INT32_MAX)
    return (int)cudaErrorInvalidValue;
  const int64_t n_fill = (((int64_t)n_buckets << lg_cap) + FILL - 1) / FILL;
  if (n / TILE + 1 + n_fill > INT32_MAX) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  int lg = 0;                                  // ceil(log2 keys_per_bucket)
  while ((1LL << lg) < keys_per_bucket) ++lg;
  const KeyLanes src{(const int32_t*)key, n_buckets,
                     (unsigned)((1ULL << (31 + lg)) / keys_per_bucket + 1),
                     31 + lg};
  return three_grids(src, n, scratch, grids, st,
                     [&](int64_t n_tiles, const int32_t* offs,
                         const int32_t* totals) {
    bin_place_kernel<<<(unsigned)(n_tiles + n_fill), THREADS, 0, st>>>(
        src, (const float*)val, n, n_tiles, offs, totals, lg_cap,
        (int32_t*)binned_key, (float*)binned_val, (int32_t*)dropped);
    return (int)cudaGetLastError();
  });
}

extern "C" const char* radix_bucket_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
