// The merge-tree level (K6), the stream's merge-and-compact step, and the
// run-tail totals of the 'tiled', 'bucket', 'hash' and 'stream' accumulators
// for Hopper (sm_90a). The file keeps the reference module's name; nothing in
// it is a bitonic network any more.
//
// 1. merge_runs_f32 (K6) replaces src/repro/kernels/bitonic_merge.py:
//    _make_merge_kernel: adjacent ascending, coalesced runs of `run` lanes
//    (int32 key, float32 value) merged into ascending rows of 2*run with the
//    run-tail totals: the last lane of each group of equal keys carries the
//    group's total, every other lane 0, KEY_INVALID lanes 0, and a row's last
//    lane is a tail even when the next row starts with the same key. Bound:
//    bytes, 16 a lane (the pair read once, the key and the total written
//    once). The TPU merged with a bitonic network, log2(2*run) compare-
//    exchange stages; on Hopper each stage at or above a shared tile was one
//    pass over device memory (18 grids a level at 2^28 lanes). Design: a
//    merge path (co-rank) merge, which moves every lane once.
//      * Rows of at most one window (WINDOW = 4,096 lanes, run 1 to 2,048):
//        one grid, a block a window of whole rows staged in shared memory;
//        each thread finds the co-rank of its 16 output lanes within its row
//        by binary search and merges them sequentially.
//      * Longer rows: two grids. The partition grid finds, for every window
//        of 4,096 output lanes of a row, the co-rank of its first lane (i
//        lanes from the row's first run, diag - i from its second) by binary
//        search in device memory. The merge grid stages each window's two
//        spans, with one lane of halo on each side, in shared memory by
//        coalesced loads (four in flight a thread), merges as above into
//        registers, and writes each (key, total) once, coalesced, through
//        the spans' own shared memory (XOR-swizzled against bank
//        conflicts): 33 KB a block, six blocks an SM.
//    Equal keys take the first run's lanes first, as the stable plain twin.
//    The totals are fused into the merge: the inputs are coalesced (a key's
//    lanes in one run carry 0 but on the run's last lane of that key), so a
//    group's total is a_tail + b_tail, and the lane that ends the group knows
//    both from the merge position: a lane of the first run ends its group
//    when the next lane of its run and the second run's next lane differ
//    from it; a lane of the second run ends its group when its run's next
//    lane differs, and then adds the first run's lane just before the merge
//    position where its key is the same. The halo makes those neighbours
//    visible across a window's edge. Float addition of two terms is
//    commutative and adding exact zeros changes nothing, so the totals equal
//    the plain twin's log-step scan bit for bit; no separate totals grid
//    reads the merged stream again.
// 2. merge_compact_f32, the streaming engine's step (kernels/bitonic_merge.py
//    merge_compact_pair): two ascending, duplicate-free lists of L lanes
//    (the running buffer and the compacted tile), with their valid-lane
//    counts as device scalars, merged and compacted at once into `cap` lanes:
//    every key of the union once, ascending, carrying a_tot + b_tot, then
//    KEY_INVALID/0; count = min(uniques, cap) and dropped = max(uniques -
//    cap, 0) as device scalars. It replaces the reference step's
//    merge_coalesce_pair + _coalesce_compact (src/repro/core/streaming.py),
//    which merge 2L lanes and then compact them with a cumsum, a searchsorted
//    and two gathers. Bound: bytes, 8 a valid input lane read and 8 an
//    output lane written. Four grids, none of which waits for the host: the
//    partition grid (co-ranks of the windows of the valid merged lanes only,
//    na + nb, read on the device), a count grid (each window merged on its
//    keys, its uniques counted: the lanes that end a group), one block that
//    scans the windows' counts into output offsets and writes count and
//    dropped, and a write grid that merges each window again with its
//    values, packs its uniques through shared memory and writes them at
//    their offset (nothing at or past cap), then fills [count, cap) with
//    KEY_INVALID/0. Windows past the valid lanes cost nothing: the count and
//    write grids walk the live windows in a grid-stride loop sized to the
//    card, and the KEY_INVALID tails of both lists are never read.
// 3. seg_totals_f32: the run-tail totals of sorted rows, the last grid of the
//    radix row sort (K5, csrc/radix_sort.cu) and of K8's step
//    (csrc/fused_sccp_stream.cu). Each tail lane walks back over its own
//    run, which never crosses a row; every lane belongs to one run, so the
//    walks read each lane once.
//
// Lane offsets are 64-bit: the stream's lists reach 2^27 lanes a list, 2^28
// merged, 2 GiB of pairs.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int32_t KEY_INVALID = 2147483647;
constexpr int THREADS = 256;                   // a merge block
constexpr int WARPS = THREADS / 32;
constexpr int ITEMS = 16;                      // merged lanes a thread
constexpr int WINDOW = THREADS * ITEMS;        // 4,096 merged lanes a block
constexpr int HALO = 4;                        // a lane each side of each span
constexpr int SKEWED = WINDOW + WINDOW / 32;   // the staging tile, skewed
constexpr int SCAN_THREADS = 1024;
constexpr int LOADS = 4;                       // loads in flight a thread

// The staging tile's index of merged lane x (merge_rows_kernel): one word of
// skew every 32 lanes, so a thread's 16 consecutive lanes and a warp's
// coalesced reads both fall in distinct banks.
__device__ __forceinline__ int skew(int x) { return x + (x >> 5); }

// The same for a tile of exactly WINDOW lanes, in place: lane x of each
// group of 32 moves within its group by an XOR with the group's index, a
// permutation of [0, WINDOW) that spreads both access patterns over the 32
// banks.
__device__ __forceinline__ int swz(int x) { return x ^ ((x >> 5) & 31); }

// Dynamic shared memory of a merge block: the two staged spans with their
// halo (keys, values); merge_rows_kernel adds a staging tile of the merged
// lanes, the window kernels hold their merged lanes in registers and reuse
// the spans' memory, so six blocks fit an SM.
constexpr int WINDOW_SMEM = 2 * (WINDOW + HALO) * 4;
constexpr int MERGE_SMEM = WINDOW_SMEM + 2 * SKEWED * 4;

// The number of lanes of A among the first d lanes of the stable merge of A
// (la lanes) and B (lb lanes), A first on equal keys. I: int in shared
// memory, int64_t over a list in device memory.
template <class I>
__device__ __forceinline__ I co_rank(const int32_t* a, I la, const int32_t* b,
                                     I lb, I d) {
  I lo = d > lb ? d - lb : 0;
  I hi = d < la ? d : la;
  while (lo < hi) {
    const I mid = (lo + hi) >> 1;
    if (a[mid] <= b[d - mid - 1])
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo;
}

// One window's staged spans: A's lanes [a0, a0 + la) at ak (ak[-1] and
// ak[la] hold A's lanes a0 - 1 and a0 + la where they lie in A), B's alike.
// a_prev: A has a lane before the window; a_rest, b_rest: lanes from the
// window's first lane of A (of B) to the end of that list.
struct Spans {
  const int32_t* ak;
  const float* av;
  const int32_t* bk;
  const float* bv;
  int la, lb;
  bool a_prev;
  int64_t a_rest, b_rest;
};

// The next merged lane from A's lane i or B's lane j (window-local; both
// advance): its key k, tail when it ends its key's group and the key is not
// KEY_INVALID, and v the group's a_tail + b_tail on the tail, 0 elsewhere.
// kVals: the values are staged (else every total is 0).
template <bool kVals>
__device__ __forceinline__ void merge_step(const Spans& s, int& i, int& j,
                                           int32_t& k, float& v, bool& tail) {
  v = 0.0f;
  if (j >= s.lb || (i < s.la && s.ak[i] <= s.bk[j])) {
    k = s.ak[i];
    // the last lane of its key in A, and B (from its merge position on)
    // holds no lane of that key
    tail = k != KEY_INVALID && (i + 1 >= s.a_rest || s.ak[i + 1] != k) &&
           !(j < s.b_rest && s.bk[j] == k);
    if (kVals && tail) v = s.av[i] + 0.0f;
    ++i;
  } else {
    k = s.bk[j];
    tail = k != KEY_INVALID && (j + 1 >= s.b_rest || s.bk[j + 1] != k);
    if (kVals && tail) {
      // A's lanes of this key, if any, end just before the merge position
      const bool in_a = (i > 0 || s.a_prev) && s.ak[i - 1] == k;
      v = (s.bv[j] + (in_a ? s.av[i - 1] : 0.0f)) + 0.0f;
    }
    ++j;
  }
}

// Merge the window's lanes [d, d + cnt): emit(q, key, total, tail) for each.
template <bool kVals, class Emit>
__device__ __forceinline__ void merge_lanes(const Spans& s, int d, int cnt,
                                            Emit&& emit) {
  int i = co_rank(s.ak, s.la, s.bk, s.lb, d);
  int j = d - i;
  for (int q = 0; q < cnt; ++q) {
    int32_t k;
    float v;
    bool tail;
    merge_step<kVals>(s, i, j, k, v, tail);
    emit(q, k, v, tail);
  }
}

// Merge the window's lanes [d, d + cnt), cnt <= ITEMS, into registers:
// keys k, totals v, and bit q of the result set where lane d + q is a tail.
template <bool kVals>
__device__ __forceinline__ unsigned merge_items(const Spans& s, int d,
                                                int cnt,
                                                int32_t (&k)[ITEMS],
                                                float (&v)[ITEMS]) {
  int i = co_rank(s.ak, s.la, s.bk, s.lb, d);
  int j = d - i;
  unsigned tails = 0;
#pragma unroll
  for (int q = 0; q < ITEMS; ++q) {
    if (q < cnt) {
      bool tail;
      merge_step<kVals>(s, i, j, k[q], v[q], tail);
      tails |= (unsigned)tail << q;
    }
  }
  return tails;
}

// Stage A's lanes [a0 - 1, a1] and B's [b0 - 1, b1], those inside their
// lists of la and lb lanes, at sk (sv), A first; returns the window's spans.
template <bool kVals>
__device__ __forceinline__ Spans stage(const int32_t* ka, const float* va,
                                       int64_t la, int64_t a0, int64_t a1,
                                       const int32_t* kb, const float* vb,
                                       int64_t lb, int64_t b0, int64_t b1,
                                       int32_t* sk, float* sv) {
  const int na = (int)(a1 - a0) + 2;
  const int nb = (int)(b1 - b0) + 2;
  // LOADS lanes a thread in flight: all loads first, then the stores
  for (int x0 = threadIdx.x; x0 < na + nb; x0 += LOADS * THREADS) {
    int32_t kr[LOADS];
    float vr[LOADS];
    bool ok[LOADS];
#pragma unroll
    for (int u = 0; u < LOADS; ++u) {
      const int x = x0 + u * THREADS;
      const bool in_a = x < na;
      const int64_t g = in_a ? a0 - 1 + x : b0 - 1 + (x - na);
      ok[u] = x < na + nb && g >= 0 && g < (in_a ? la : lb);
      if (ok[u]) {
        kr[u] = in_a ? ka[g] : kb[g];
        if (kVals) vr[u] = in_a ? va[g] : vb[g];
      }
    }
#pragma unroll
    for (int u = 0; u < LOADS; ++u) {
      if (ok[u]) {
        sk[x0 + u * THREADS] = kr[u];
        if (kVals) sv[x0 + u * THREADS] = vr[u];
      }
    }
  }
  return Spans{sk + 1,         kVals ? sv + 1 : nullptr,
               sk + na + 1,    kVals ? sv + na + 1 : nullptr,
               na - 2,         nb - 2,
               a0 > 0,         la - a0,
               lb - b0};
}

// Exclusive prefix sum of one int a thread over the block (THREADS
// threads); *total receives the sum. `wt` is WARPS ints of shared scratch.
// Synchronises the block.
__device__ __forceinline__ int block_exclusive(int x, int* wt, int* total) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int inc = x;
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, inc, o);
    if (lane >= o) inc += y;
  }
  if (lane == 31) wt[warp] = inc;
  __syncthreads();
  int before = 0, all = 0;
  for (int w = 0; w < WARPS; ++w) {
    before += w < warp ? wt[w] : 0;
    all += wt[w];
  }
  __syncthreads();
  *total = all;
  return before + inc - x;
}

// ---------------------------------------------------------------------------
// K6: one merge-tree level
// ---------------------------------------------------------------------------

// Rows of `row` = 2 * run <= WINDOW lanes: a block merges a window of whole
// rows (the last window may be partial) in shared memory.
__global__ void __launch_bounds__(THREADS)
merge_rows_kernel(const int32_t* __restrict__ kin,
                  const float* __restrict__ vin, int32_t* __restrict__ kout,
                  float* __restrict__ tot, int64_t n, int run) {
  extern __shared__ int4 smem4[];
  int32_t* sk = reinterpret_cast<int32_t*>(smem4);
  float* sv = reinterpret_cast<float*>(sk + WINDOW + HALO);
  int32_t* ok = reinterpret_cast<int32_t*>(sv + WINDOW + HALO);
  float* ov = reinterpret_cast<float*>(ok + SKEWED);
  const int64_t base = (int64_t)blockIdx.x * WINDOW;
  const int m = n - base < WINDOW ? (int)(n - base) : WINDOW;
  for (int x = threadIdx.x; x < m; x += THREADS) {
    sk[x] = kin[base + x];
    sv[x] = vin[base + x];
  }
  __syncthreads();
  const int row = 2 * run;
  const int first = threadIdx.x * ITEMS;
  const int end = first + ITEMS < m ? first + ITEMS : m;
  for (int o = first; o < end;) {
    const int r0 = o & ~(row - 1);
    const int cnt = (r0 + row < end ? r0 + row : end) - o;
    const Spans s{sk + r0, sv + r0, sk + r0 + run, sv + r0 + run,
                  run,     run,     false,         run,
                  run};
    merge_lanes<true>(s, o - r0, cnt, [&](int q, int32_t k, float v, bool) {
      ok[skew(o + q)] = k;
      ov[skew(o + q)] = v;
    });
    o += cnt;
  }
  __syncthreads();
  for (int x = threadIdx.x; x < m; x += THREADS) {
    kout[base + x] = ok[skew(x)];
    tot[base + x] = ov[skew(x)];
  }
}

// Rows longer than a window: part[r * (wpr + 1) + w] receives the co-rank
// of window w's first lane in row r (w == wpr: the row's end, run).
__global__ void merge_partition_kernel(const int32_t* __restrict__ key,
                                       int64_t run, int64_t wpr,
                                       int64_t entries,
                                       int64_t* __restrict__ part) {
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= entries) return;
  const int64_t r = t / (wpr + 1);
  const int64_t w = t - r * (wpr + 1);
  const int32_t* a = key + r * 2 * run;
  part[t] = co_rank(a, run, a + run, run, w * WINDOW);
}

// One block a window of WINDOW output lanes of a row longer than a window.
__global__ void __launch_bounds__(THREADS)
merge_window_kernel(const int32_t* __restrict__ kin,
                    const float* __restrict__ vin,
                    int32_t* __restrict__ kout, float* __restrict__ tot,
                    int64_t run, int64_t wpr,
                    const int64_t* __restrict__ part) {
  extern __shared__ int4 smem4[];
  int32_t* sk = reinterpret_cast<int32_t*>(smem4);
  float* sv = reinterpret_cast<float*>(sk + WINDOW + HALO);
  const int64_t r = blockIdx.x / wpr;
  const int64_t w = blockIdx.x - r * wpr;
  const int64_t a0 = part[r * (wpr + 1) + w];
  const int64_t a1 = part[r * (wpr + 1) + w + 1];
  const int64_t b0 = w * WINDOW - a0;
  const int64_t b1 = (w + 1) * WINDOW - a1;
  const int64_t at = r * 2 * run;
  const Spans s = stage<true>(kin + at, vin + at, run, a0, a1,
                              kin + at + run, vin + at + run, run, b0, b1,
                              sk, sv);
  __syncthreads();
  const int first = threadIdx.x * ITEMS;
  int32_t k[ITEMS];
  float v[ITEMS];
  merge_items<true>(s, first, ITEMS, k, v);
  __syncthreads();                     // the spans are read: reuse them
#pragma unroll
  for (int q = 0; q < ITEMS; ++q) {
    sk[swz(first + q)] = k[q];
    sv[swz(first + q)] = v[q];
  }
  __syncthreads();
  const int64_t out = at + w * WINDOW;
  for (int x = threadIdx.x; x < WINDOW; x += THREADS) {
    kout[out + x] = sk[swz(x)];
    tot[out + x] = sv[swz(x)];
  }
}

// ---------------------------------------------------------------------------
// The stream's step: merge two duplicate-free lists and compact
// ---------------------------------------------------------------------------

// The two lists and their valid-lane counts (device scalars, clamped to the
// lists' lengths).
struct Pair {
  const int32_t* ka;
  const float* va;
  const int32_t* kb;
  const float* vb;
  const int32_t* na;
  const int32_t* nb;
  int64_t len_a, len_b;

  __device__ __forceinline__ int64_t valid_a() const {
    const int64_t x = *na;
    return x < 0 ? 0 : (x > len_a ? len_a : x);
  }
  __device__ __forceinline__ int64_t valid_b() const {
    const int64_t x = *nb;
    return x < 0 ? 0 : (x > len_b ? len_b : x);
  }
};

__device__ __forceinline__ int64_t windows(int64_t lanes) {
  return (lanes + WINDOW - 1) / WINDOW;
}

// part[w] = the co-rank of window w's first lane over the valid lanes
// (w == their windows: the end, valid_a).
__global__ void compact_partition_kernel(Pair p, int64_t* __restrict__ part) {
  const int64_t w = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t la = p.valid_a();
  const int64_t lb = p.valid_b();
  const int64_t live = la + lb;
  if (w > windows(live)) return;
  const int64_t d = w * WINDOW < live ? w * WINDOW : live;
  part[w] = co_rank(p.ka, la, p.kb, lb, d);
}

// The window w's first and last merged lane and its spans' bounds.
struct Window {
  int64_t d0, d1, a0, a1, b0, b1;
};

__device__ __forceinline__ Window window(const int64_t* part, int64_t w,
                                         int64_t live) {
  Window x;
  x.d0 = w * WINDOW;
  x.d1 = x.d0 + WINDOW < live ? x.d0 + WINDOW : live;
  x.a0 = part[w];
  x.a1 = part[w + 1];
  x.b0 = x.d0 - x.a0;
  x.b1 = x.d1 - x.a1;
  return x;
}

// The uniques of every live window, merged on keys alone, into wcount[w].
__global__ void __launch_bounds__(THREADS)
compact_count_kernel(Pair p, const int64_t* __restrict__ part,
                     int64_t* __restrict__ wcount) {
  __shared__ int32_t sk[WINDOW + HALO];
  __shared__ int wt[WARPS];
  const int64_t la = p.valid_a();
  const int64_t lb = p.valid_b();
  const int64_t live = la + lb;
  for (int64_t w = blockIdx.x; w < windows(live); w += gridDim.x) {
    const Window x = window(part, w, live);
    __syncthreads();                  // the last window's spans are done
    const Spans s = stage<false>(p.ka, nullptr, la, x.a0, x.a1, p.kb,
                                 nullptr, lb, x.b0, x.b1, sk, nullptr);
    __syncthreads();
    const int first = threadIdx.x * ITEMS;
    const int span = (int)(x.d1 - x.d0);
    int32_t k[ITEMS];
    float v[ITEMS];
    const int mine =
        first < span
            ? __popc(merge_items<false>(
                  s, first, span - first < ITEMS ? span - first : ITEMS, k, v))
            : 0;
    int total;
    block_exclusive(mine, wt, &total);
    if (threadIdx.x == 0) wcount[w] = total;
  }
}

// One block: wcount (the live windows') into exclusive offsets woff, the
// uniques' total into *total, count = min(total, cap), dropped = the rest.
__global__ void __launch_bounds__(SCAN_THREADS)
compact_scan_kernel(Pair p, const int64_t* __restrict__ wcount,
                    int64_t* __restrict__ woff, int64_t* __restrict__ total,
                    int32_t* __restrict__ count, int32_t* __restrict__ dropped,
                    int64_t cap) {
  __shared__ long long wt[SCAN_THREADS / 32];
  const int64_t nw = windows(p.valid_a() + p.valid_b());
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  long long carry = 0;
  for (int64_t at = 0; at < nw; at += SCAN_THREADS) {
    const int64_t w = at + threadIdx.x;
    const long long x = w < nw ? wcount[w] : 0;
    long long inc = x;
    for (int o = 1; o < 32; o <<= 1) {
      const long long y = __shfl_up_sync(0xffffffffu, inc, o);
      if (lane >= o) inc += y;
    }
    if (lane == 31) wt[warp] = inc;
    __syncthreads();
    long long before = 0, all = 0;
    for (int v = 0; v < SCAN_THREADS / 32; ++v) {
      before += v < warp ? wt[v] : 0;
      all += wt[v];
    }
    if (w < nw) woff[w] = carry + before + inc - x;
    carry += all;
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    *total = carry;
    *count = (int32_t)(carry < cap ? carry : cap);
    *dropped = (int32_t)(carry > cap ? carry - cap : 0);
  }
}

// Every live window merged with its values; its uniques packed through
// shared memory and written at woff[w] on (none at or past cap); then the
// lanes [min(total, cap), cap) become KEY_INVALID/0.
__global__ void __launch_bounds__(THREADS)
compact_write_kernel(Pair p, const int64_t* __restrict__ part,
                     const int64_t* __restrict__ woff,
                     const int64_t* __restrict__ total,
                     int32_t* __restrict__ kout, float* __restrict__ vout,
                     int64_t cap) {
  extern __shared__ int4 smem4[];
  __shared__ int wt[WARPS];
  int32_t* sk = reinterpret_cast<int32_t*>(smem4);
  float* sv = reinterpret_cast<float*>(sk + WINDOW + HALO);
  const int64_t la = p.valid_a();
  const int64_t lb = p.valid_b();
  const int64_t live = la + lb;
  for (int64_t w = blockIdx.x; w < windows(live); w += gridDim.x) {
    const Window x = window(part, w, live);
    const int64_t off = woff[w];
    if (off >= cap) continue;          // every unique here is dropped
    __syncthreads();
    const Spans s = stage<true>(p.ka, p.va, la, x.a0, x.a1, p.kb, p.vb, lb,
                                x.b0, x.b1, sk, sv);
    __syncthreads();
    const int first = threadIdx.x * ITEMS;
    const int span = (int)(x.d1 - x.d0);
    const int cnt = first < span ? (span - first < ITEMS ? span - first
                                                         : ITEMS)
                                 : 0;
    int32_t k[ITEMS];
    float v[ITEMS];
    const unsigned tails = merge_items<true>(s, first, cnt, k, v);
    int uniques;
    int at = block_exclusive(__popc(tails), wt, &uniques);  // spans read
#pragma unroll
    for (int q = 0; q < ITEMS; ++q) {
      if ((tails >> q) & 1u) {
        sk[swz(at)] = k[q];
        sv[swz(at)] = v[q];
        ++at;
      }
    }
    __syncthreads();
    for (int y = threadIdx.x; y < uniques && off + y < cap; y += THREADS) {
      kout[off + y] = sk[swz(y)];
      vout[off + y] = sv[swz(y)];
    }
  }
  const int64_t t = *total;
  for (int64_t y = (t < cap ? t : cap) + (int64_t)blockIdx.x * THREADS +
                   threadIdx.x;
       y < cap; y += (int64_t)gridDim.x * THREADS) {
    kout[y] = KEY_INVALID;
    vout[y] = 0.0f;
  }
}

// ---------------------------------------------------------------------------
// The run-tail totals of sorted rows (K5's and K8's last grid)
// ---------------------------------------------------------------------------

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

// Blocks of `kernel` the card holds at once (every SM full), at least 1.
int resident_blocks(const void* kernel, int smem) {
  int dev = 0, sms = 0, per_sm = 0;
  if (cudaGetDevice(&dev) || cudaDeviceGetAttribute(
          &sms, cudaDevAttrMultiProcessorCount, dev) ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS,
                                                    smem))
    return 1;
  return sms * per_sm > 0 ? sms * per_sm : 1;
}

int set_smem(const void* kernel, int bytes) {
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

}  // namespace

// The run-tail totals of rows of `row` sorted lanes, the last grid of the
// radix row sort (K5) and of K8's step.
extern "C" int seg_totals_f32(const void* key, const void* val, void* tot,
                              long long n, long long row, void* stream) {
  if (n <= 0) return 0;
  seg_total_kernel<<<blocks(n, THREADS), THREADS, 0, (cudaStream_t)stream>>>(
      (const int32_t*)key, (const float*)val, (float*)tot, n, row);
  return (int)cudaGetLastError();
}

// Merge adjacent ascending, coalesced runs of `run` lanes of (kin, vin) into
// ascending rows of 2*run in kout with their run-tail totals in tot. Rows
// above a window need `part`, n / (2 * run) * (2 * run / WINDOW + 1) of
// its `part_len` int64s (kernels/bitonic_merge.py sizes it). *grids
// receives the grids launched.
extern "C" int merge_runs_f32(const void* kin, const void* vin, void* kout,
                              void* tot, void* part, long long part_len,
                              long long n, long long run, int* grids,
                              void* stream) {
  *grids = 0;
  const long long row = 2 * run;
  if (run < 1 || (row & (row - 1)) || n % row ||
      (row > WINDOW && part_len < n / row * (row / WINDOW + 1)))
    return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  if (row <= WINDOW) {
    int err = set_smem((const void*)merge_rows_kernel, MERGE_SMEM);
    if (err) return err;
    merge_rows_kernel<<<blocks(n, WINDOW), THREADS, MERGE_SMEM, st>>>(
        (const int32_t*)kin, (const float*)vin, (int32_t*)kout, (float*)tot,
        n, (int)run);
    ++*grids;
    return (int)cudaGetLastError();
  }
  const int64_t wpr = row / WINDOW;
  const int64_t entries = n / row * (wpr + 1);
  merge_partition_kernel<<<blocks(entries, THREADS), THREADS, 0, st>>>(
      (const int32_t*)kin, run, wpr, entries, (int64_t*)part);
  ++*grids;
  int err = (int)cudaGetLastError();
  if (err) return err;
  err = set_smem((const void*)merge_window_kernel, WINDOW_SMEM);
  if (err) return err;
  merge_window_kernel<<<(unsigned)(n / WINDOW), THREADS, WINDOW_SMEM, st>>>(
      (const int32_t*)kin, (const float*)vin, (int32_t*)kout, (float*)tot,
      run, wpr, (const int64_t*)part);
  ++*grids;
  return (int)cudaGetLastError();
}

// Merge the ascending, duplicate-free lists (ka, va) and (kb, vb) of len_a
// and len_b lanes, whose first *na (*nb) lanes are valid and the rest
// KEY_INVALID, into cap lanes of kout/vout: every key of the union once,
// ascending, with its total, then KEY_INVALID/0; *count and *dropped as the
// uniques kept and lost. `scratch` holds scratch_len int64s, at least
// 3 * (windows + 1) + 1, windows = ceil((len_a + len_b) / WINDOW)
// (kernels/bitonic_merge.py sizes it). *grids receives the grids launched
// (4).
extern "C" int merge_compact_f32(const void* ka, const void* va,
                                 const void* kb, const void* vb,
                                 const void* na, const void* nb,
                                 long long len_a, long long len_b,
                                 void* kout, void* vout, long long cap,
                                 void* count, void* dropped, void* scratch,
                                 long long scratch_len, int* grids,
                                 void* stream) {
  *grids = 0;
  const int64_t mw = (len_a + len_b + WINDOW - 1) / WINDOW;
  if (len_a < 0 || len_b < 0 || cap < 0 || scratch_len < 3 * (mw + 1) + 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const Pair p{(const int32_t*)ka, (const float*)va, (const int32_t*)kb,
               (const float*)vb, (const int32_t*)na, (const int32_t*)nb,
               len_a, len_b};
  int64_t* part = (int64_t*)scratch;
  int64_t* wcount = part + mw + 1;
  int64_t* woff = wcount + mw + 1;
  int64_t* total = woff + mw + 1;
  compact_partition_kernel<<<blocks(mw + 1, THREADS), THREADS, 0, st>>>(p,
                                                                        part);
  ++*grids;
  int err = (int)cudaGetLastError();
  if (err) return err;
  static const int count_blocks =
      resident_blocks((const void*)compact_count_kernel, 0);
  const int64_t cb = mw < count_blocks ? (mw > 0 ? mw : 1) : count_blocks;
  compact_count_kernel<<<(unsigned)cb, THREADS, 0, st>>>(p, part, wcount);
  ++*grids;
  if ((err = (int)cudaGetLastError())) return err;
  compact_scan_kernel<<<1, SCAN_THREADS, 0, st>>>(
      p, wcount, woff, total, (int32_t*)count, (int32_t*)dropped, cap);
  ++*grids;
  if ((err = (int)cudaGetLastError())) return err;
  if ((err = set_smem((const void*)compact_write_kernel, WINDOW_SMEM)))
    return err;
  static const int write_blocks =
      resident_blocks((const void*)compact_write_kernel, WINDOW_SMEM);
  const int64_t want = mw > blocks(cap, THREADS) ? mw : blocks(cap, THREADS);
  const int64_t wb =
      want < write_blocks ? (want > 0 ? want : 1) : write_blocks;
  compact_write_kernel<<<(unsigned)wb, THREADS, WINDOW_SMEM, st>>>(
      p, part, woff, total, (int32_t*)kout, (float*)vout, cap);
  ++*grids;
  return (int)cudaGetLastError();
}

extern "C" const char* bitonic_merge_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
