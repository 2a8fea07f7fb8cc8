// LSD radix sort of int32 keys, alone or carrying float32 values, for Hopper
// (sm_90a): the design of K2 (kernels/insitu_search.py emit_sort_keys, keys
// only, one row the whole stream), of K5's rows (kernels/bitonic_merge.py
// sort_tiles, (key, value) pairs, every power-of-two row sorted on its own)
// and of K8's step (kernels/fused_sccp_stream.py fused_slab_sort, one row of
// the products it forms). csrc/radix_sort.cu builds it into one library
// whose four entries the three wrappers call through kernels/radix_sort.py;
// K8's library (csrc/fused_sccp_stream.cu) adds the first digit's count and
// scatter and the one-grid sort over its own lane source.
//
// Bound: bytes. A sort must read each key (and value) once and write it once;
// the bitonic networks these replace made one pass over device memory for
// each stride at or above a shared tile, log2(n)^2/2 passes in all. An LSD
// radix sort makes a fixed PASSES = 4 passes of 8-bit digits whatever n is.
// Keys are ordered as signed int32: each digit is taken from the key with
// bit 31 flipped, so the buffers keep the keys as they are.
//
// Rows of more than one tile (row > TILE, a multiple of it) take three grids
// a digit, reduce-then-scan, so no block waits on another and every position
// is fixed by the data alone:
//   1. upsweep: blocks_per_row blocks a row, each owning tiles_per_block
//      consecutive tiles, count the digit over their lanes into per-warp
//      shared histograms, each thread 16 consecutive keys at a time with one
//      shared atomic per run of one digit (the high digits of a packed
//      stream come in long runs), then store the block's 256 counts.
//   2. scan: one block a row turns the row's counts into exclusive offsets
//      in bin-major order: all the row's lanes of a lower digit, then those
//      of the same digit in earlier blocks. The scan restarts at every row.
//   3. downsweep: the same blocks walk their tiles in order. A tile of 4,096
//      lanes is loaded 16 bytes a thread into shared memory and ranked
//      stably by the digit: warp w holds lanes w*512 .. w*512+511; a lane's
//      peers of one digit come from eight ballots (one a digit bit), and
//      the lowest of them adds their number to the warp's counter and hands
//      the old count on by a shuffle (the warp ranking of Onesweep); a
//      per-bin scan over the 8 warps orders the warps. The tile is staged
//      in shared memory in digit order and written bin by bin, so each
//      bin's stores are one contiguous run at the block's running offset
//      for that bin.
// Passes alternate between two buffers, and the caller orders them so the
// fourth lands in its output. A row's last block may own fewer tiles than
// the others, so a row need only be a multiple of TILE (K8 sorts its real
// lanes rounded up to a tile, not to a power of two).
//
// The grids read their lanes through a lane source: MemLanes reads a key
// (and value) stream from device memory, as K2 and K5 sort it; K8
// (csrc/fused_sccp_stream.cu) passes its own, which forms each lane from
// the slab operands, to the first digit's count and scatter and to the
// one-grid sort, so its unsorted products never reach device memory. A
// source gives run(l, k), the 16 keys from lane l on (the count's unit);
// begin(first) and tile(at, next, sk, sv, k, v), the scatter's tiles in
// warp order; lane(l, k, v), one lane (below the stream's end) of the
// one-grid sort.
//
// Rows of at most one tile take one grid: one block a tile of TILE lanes,
// which holds TILE / row whole rows, sorts it in shared memory with the same
// ranking, ping-ponging two shared buffers. The four key digits sort the
// tile as a whole; where it holds several rows, one or two more passes on
// the tile-local row index (lane / row, the most significant digit) then
// bring every row back to its own lanes, each sorted, ties in lane order.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {
namespace radix {

constexpr int BITS = 8;
constexpr int BINS = 1 << BITS;                // 256
constexpr int PASSES = 32 / BITS;              // 4
constexpr int THREADS = 256;                   // == BINS: thread b owns bin b
constexpr int WARPS = THREADS / 32;            // 8
constexpr int ITEMS = 16;                      // keys a thread a tile
constexpr int WARP_KEYS = 32 * ITEMS;          // 512
constexpr int TILE = THREADS * ITEMS;          // 4,096 lanes a tile
constexpr int SCAN_THREADS = 1024;
constexpr int32_t PAD = 2147483647;            // sorts last

static_assert(BINS == THREADS, "one thread a bin");

__device__ __forceinline__ unsigned digit(int32_t k, int shift) {
  return (((uint32_t)k ^ 0x80000000u) >> shift) & (BINS - 1);
}

// A tile of TILE 4-byte lanes in flight through registers: fetch() starts
// the loads (16 bytes a thread where the source allows it, else coalesced
// 4-byte loads), put() stores them to shared memory in tile order, so a
// block can fetch its next tile while it ranks the current one.
struct TileRegs {
  int32_t x[ITEMS];
  __device__ __forceinline__ void fetch(const void* src, bool vec) {
    if (vec) {
      const int4* s = reinterpret_cast<const int4*>(src);
#pragma unroll
      for (int q = 0; q < ITEMS / 4; ++q) {
        const int4 v = __ldg(s + q * THREADS + threadIdx.x);
        x[4 * q] = v.x;
        x[4 * q + 1] = v.y;
        x[4 * q + 2] = v.z;
        x[4 * q + 3] = v.w;
      }
    } else {
      const int32_t* s = reinterpret_cast<const int32_t*>(src);
#pragma unroll
      for (int i = 0; i < ITEMS; ++i)
        x[i] = __ldg(s + i * THREADS + threadIdx.x);
    }
  }
  __device__ __forceinline__ void put(void* dst, bool vec) const {
    if (vec) {
      int4* d = reinterpret_cast<int4*>(dst);
#pragma unroll
      for (int q = 0; q < ITEMS / 4; ++q)
        d[q * THREADS + threadIdx.x] =
            make_int4(x[4 * q], x[4 * q + 1], x[4 * q + 2], x[4 * q + 3]);
    } else {
      int32_t* d = reinterpret_cast<int32_t*>(dst);
#pragma unroll
      for (int i = 0; i < ITEMS; ++i) d[i * THREADS + threadIdx.x] = x[i];
    }
  }
};

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// Lanes read from a key stream kin, and a value stream vin beside it where
// kVals, through the read-only path (no grid writes its input).
template <bool kVals>
struct MemLanes {
  const int32_t* kin;
  const float* vin;
  TileRegs nk, nv;
  bool kvec, vvec;

  __device__ MemLanes(const int32_t* k, const float* v)
      : kin(k), vin(v), kvec(false), vvec(false) {}

  __device__ __forceinline__ void run(int64_t l, int32_t (&k)[16]) const {
    const int32_t* src = kin + l;
    if (aligned16(src)) {
      const int4* s4 = reinterpret_cast<const int4*>(src);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int4 v = __ldg(s4 + q);
        k[4 * q] = v.x;
        k[4 * q + 1] = v.y;
        k[4 * q + 2] = v.z;
        k[4 * q + 3] = v.w;
      }
    } else {
#pragma unroll
      for (int q = 0; q < 16; ++q) k[q] = __ldg(src + q);
    }
  }

  // Start the loads of the tile at lane `first` (every later tile of the
  // block lies a multiple of TILE on, so it shares the alignment).
  __device__ __forceinline__ void begin(int64_t first) {
    kvec = aligned16(kin + first);
    vvec = kVals && aligned16(vin + first);
    nk.fetch(kin + first, kvec);
    if (kVals) nv.fetch(vin + first, vvec);
  }

  // The tile whose loads are in flight, through shared memory into warp
  // order; the loads of the tile at `next` (-1: none) fly meanwhile.
  __device__ __forceinline__ void tile(int64_t, int64_t next, int32_t* sk,
                                       float* sv, int32_t (&k)[ITEMS],
                                       float (&v)[ITEMS]) {
    nk.put(sk, kvec);
    if (kVals) nv.put(sv, vvec);
    __syncthreads();
    if (next >= 0) {
      nk.fetch(kin + next, kvec);
      if (kVals) nv.fetch(vin + next, vvec);
    }
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
#pragma unroll
    for (int i = 0; i < ITEMS; ++i) {
      const int x = warp * WARP_KEYS + i * 32 + lane;
      k[i] = sk[x];
      if (kVals) v[i] = sv[x];
    }
  }

  // Lane l, inside the stream.
  __device__ __forceinline__ void lane(int64_t l, int32_t& k,
                                       float& v) const {
    k = __ldg(kin + l);
    if (kVals) v = __ldg(vin + l);
  }
};

// The lanes block j of a row owns: tpb tiles, or the row's rest.
__device__ __forceinline__ int64_t block_lanes(int64_t row, int j, int tpb) {
  const int64_t span = (int64_t)tpb * TILE;
  const int64_t rest = row - (int64_t)j * span;
  return rest < span ? rest : span;
}

// Exclusive prefix sum of one int a thread over the block; `wt` is WARPS ints
// of shared scratch. Synchronises the block.
__device__ __forceinline__ int block_exclusive(int x, int* wt) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int inc = x;
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, inc, o);
    if (lane >= o) inc += y;
  }
  if (lane == 31) wt[warp] = inc;
  __syncthreads();
  int before = 0;
  for (int w = 0; w < warp; ++w) before += wt[w];
  __syncthreads();
  return before + inc - x;
}

// The lanes of the warp whose digit equals this lane's: one ballot a bit.
__device__ __forceinline__ unsigned warp_peers(unsigned d) {
  unsigned peers = 0xffffffffu;
#pragma unroll
  for (int bit = 0; bit < BITS; ++bit) {
    const unsigned set = (d >> bit) & 1u;
    const unsigned bal = __ballot_sync(0xffffffffu, set);
    peers &= set ? bal : ~bal;
  }
  return peers;
}

// Rank one tile stably by its digits. Thread (warp w, lane l) holds the
// digit d[i] of tile lane w * WARP_KEYS + i * 32 + l. On return pos[i] is
// that lane's position in the tile sorted stably by digit; thread b has written
// start[b] (the bin's first position) and count[b] (its size). `wh` is
// WARPS * BINS ints of shared scratch, `wt` WARPS ints. The caller
// synchronises the block between two calls.
__device__ __forceinline__ void rank_tile(const unsigned (&d)[ITEMS],
                                          int (&pos)[ITEMS], int* wh,
                                          int* start, int* count, int* wt) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int x = threadIdx.x; x < WARPS * BINS; x += THREADS) wh[x] = 0;
  __syncthreads();
  // within the warp: the lowest lane of each digit adds the digit's lanes to
  // the warp's counter and hands the old count to the others (items in
  // order, so lane order within an item and item order agree with the tile)
  int* h = wh + warp * BINS;
  const unsigned lower = (1u << lane) - 1;
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    const unsigned peers = warp_peers(d[i]);
    const int below = __popc(peers & lower);
    int base = 0;
    if (below == 0) base = atomicAdd(&h[d[i]], __popc(peers));
    pos[i] = __shfl_sync(0xffffffffu, base, __ffs(peers) - 1) + below;
  }
  __syncthreads();
  // thread b: bin b's offset within each warp, its count, its start
  const int b = threadIdx.x;
  int s = 0;
  for (int w = 0; w < WARPS; ++w) {
    const int c = wh[w * BINS + b];
    wh[w * BINS + b] = s;
    s += c;
  }
  const int first = block_exclusive(s, wt);
  start[b] = first;
  count[b] = s;
  __syncthreads();
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) pos[i] += start[d[i]] + h[d[i]];
}

// Count N consecutive keys into the warp's histogram `h`, one shared atomic
// for each run of one digit.
template <int N>
__device__ __forceinline__ void count_keys(int* h, const int32_t (&k)[N],
                                           int shift) {
  unsigned prev = digit(k[0], shift);
  int run = 1;
#pragma unroll
  for (int i = 1; i < N; ++i) {
    const unsigned d = digit(k[i], shift);
    if (d == prev) {
      ++run;
    } else {
      atomicAdd(&h[prev], run);
      prev = d;
      run = 1;
    }
  }
  atomicAdd(&h[prev], run);
}

// One digit's count over each block's lanes (grid: rows * bpr blocks; block
// r * bpr + j owns tiles j * tpb .. of row r). Each thread counts 16
// consecutive keys at a time and adds each run of one digit once, so the
// runs of equal high digits in a packed stream cost one shared atomic a run.
template <class Src>
__device__ __forceinline__ void upsweep(const Src& src,
                                        int32_t* __restrict__ counts,
                                        int64_t row, int bpr, int tpb,
                                        int shift) {
  constexpr int RUN = 16;
  __shared__ int wh[WARPS * BINS];
  for (int x = threadIdx.x; x < WARPS * BINS; x += THREADS) wh[x] = 0;
  __syncthreads();
  const int64_t r = blockIdx.x / bpr;
  const int j = blockIdx.x - (int)(r * bpr);
  const int64_t lanes = block_lanes(row, j, tpb);
  const int64_t first = r * row + (int64_t)j * tpb * TILE;
  int* h = wh + (threadIdx.x >> 5) * BINS;
  int32_t k[RUN];
  for (int64_t x = (int64_t)threadIdx.x * RUN; x < lanes; x += THREADS * RUN) {
    src.run(first + x, k);
    count_keys(h, k, shift);
  }
  __syncthreads();
  const int b = threadIdx.x;
  int s = 0;
  for (int w = 0; w < WARPS; ++w) s += wh[w * BINS + b];
  counts[(int64_t)blockIdx.x * BINS + b] = s;
}

__global__ void __launch_bounds__(THREADS)
upsweep_kernel(const int32_t* __restrict__ kin, int32_t* __restrict__ counts,
               int64_t row, int bpr, int tpb, int shift) {
  upsweep(MemLanes<false>(kin, nullptr), counts, row, bpr, tpb, shift);
}

// Counts are stored block-major, counts[(r * bpr + j) * BINS + bin], so the
// upsweep writes and the downsweep reads each block's 256 counts in one
// coalesced run. One block a row turns them in place into exclusive offsets
// in bin-major order: the row's lanes of every lower digit, then those of
// the same digit in earlier blocks. PARTS threads a bin each scan a quarter
// of the row's blocks.
__global__ void __launch_bounds__(SCAN_THREADS)
scan_kernel(int32_t* __restrict__ counts, int bpr) {
  constexpr int PARTS = SCAN_THREADS / BINS;
  __shared__ int part[PARTS][BINS];
  __shared__ int total[BINS];
  __shared__ int incl[BINS];
  int32_t* c = counts + (int64_t)blockIdx.x * bpr * BINS;
  const int b = threadIdx.x % BINS;
  const int p = threadIdx.x / BINS;
  const int per = (bpr + PARTS - 1) / PARTS;
  const int j0 = p * per < bpr ? p * per : bpr;
  const int j1 = j0 + per < bpr ? j0 + per : bpr;
  int s = 0;
#pragma unroll 8
  for (int jj = j0; jj < j1; ++jj) s += c[(int64_t)jj * BINS + b];
  part[p][b] = s;
  __syncthreads();
  if (p == 0) {
    int acc = 0;
    for (int q = 0; q < PARTS; ++q) {
      const int t = part[q][b];
      part[q][b] = acc;
      acc += t;
    }
    total[b] = acc;
    incl[b] = acc;
  }
  __syncthreads();
  for (int off = 1; off < BINS; off <<= 1) {
    const int add = p == 0 && b >= off ? incl[b - off] : 0;
    __syncthreads();
    if (p == 0) incl[b] += add;
    __syncthreads();
  }
  int run = incl[b] - total[b] + part[p][b];
#pragma unroll 8
  for (int jj = j0; jj < j1; ++jj) {
    const int t = c[(int64_t)jj * BINS + b];
    c[(int64_t)jj * BINS + b] = run;
    run += t;
  }
}

// One digit's stable scatter (grid: rows * bpr blocks, as the upsweep).
// `offs` holds the scanned counts. kVals: values travel with their keys.
template <bool kVals, class Src>
__device__ __forceinline__ void downsweep(Src src, int32_t* __restrict__ kout,
                                          float* __restrict__ vout,
                                          const int32_t* __restrict__ offs,
                                          int64_t row, int bpr, int tpb,
                                          int shift) {
  __shared__ __align__(16) int32_t sk[TILE];
  __shared__ __align__(16) float sv[kVals ? TILE : 4];
  __shared__ int wh[WARPS * BINS];
  __shared__ int start[BINS];
  __shared__ int count[BINS];
  __shared__ int wt[WARPS];
  __shared__ long long run[BINS];
  const int b = threadIdx.x;
  const int64_t r = blockIdx.x / bpr;
  const int j = blockIdx.x - (int)(r * bpr);
  run[b] = r * row + offs[(int64_t)blockIdx.x * BINS + b];
  const int64_t first = r * row + (int64_t)j * tpb * TILE;
  const int tiles = (int)(block_lanes(row, j, tpb) / TILE);
  int32_t k[ITEMS];
  float v[ITEMS];
  unsigned d[ITEMS];
  int pos[ITEMS];
  src.begin(first);
  for (int t = 0; t < tiles; ++t) {
    const int64_t at = first + (int64_t)t * TILE;
    src.tile(at, t + 1 < tiles ? at + TILE : -1, sk, sv, k, v);
#pragma unroll
    for (int i = 0; i < ITEMS; ++i) d[i] = digit(k[i], shift);
    rank_tile(d, pos, wh, start, count, wt);
#pragma unroll
    for (int i = 0; i < ITEMS; ++i) {
      sk[pos[i]] = k[i];
      if (kVals) sv[pos[i]] = v[i];
    }
    __syncthreads();
    for (int x = threadIdx.x; x < TILE; x += THREADS) {
      const int32_t key = sk[x];
      const unsigned dd = digit(key, shift);
      const int64_t g = run[dd] + (x - start[dd]);
      kout[g] = key;
      if (kVals) vout[g] = sv[x];
    }
    __syncthreads();
    run[b] += count[b];
  }
}

template <bool kVals>
__global__ void __launch_bounds__(THREADS)
downsweep_kernel(const int32_t* __restrict__ kin, const float* __restrict__ vin,
                 int32_t* __restrict__ kout, float* __restrict__ vout,
                 const int32_t* __restrict__ offs, int64_t row, int bpr,
                 int tpb, int shift) {
  downsweep<kVals>(MemLanes<kVals>(kin, vin), kout, vout, offs, row, bpr,
                   tpb, shift);
}

// Every row of `row` <= TILE lanes sorted in shared memory (grid: one block
// a tile of TILE lanes, the last one partial). `passes` digit passes: the
// four key digits, then the tile-local row index in 8-bit digits above
// log_row (kernels/radix_sort.py tile_passes). Lanes past the stream's end
// are padded with PAD: in a stream of one row they sort after every real
// key, a real INT32_MAX included (the sort is stable); otherwise they lie in
// rows of their own after the real ones. Each lane carries its 16-bit tile
// index through the passes, which gives its row, and a value comes from the
// tile's unsorted copy by that index at the end. kTotals (K8's one-grid
// step; the stream is then one row of at most one tile): vout receives each
// run's value total on its last lane, 0 elsewhere and on PAD lanes, summed
// from the tail back as seg_total_kernel (csrc/bitonic_merge.cu) sums it.
// Dynamic shared memory: rows_smem<kVals>() bytes.
template <bool kVals, bool kTotals, class Src>
__device__ __forceinline__ void rows_sort(const Src& src,
                                          int32_t* __restrict__ kout,
                                          float* __restrict__ vout, int64_t n,
                                          int log_row, int passes) {
  extern __shared__ int4 smem4[];
  int32_t* ka = reinterpret_cast<int32_t*>(smem4);
  int32_t* kb = ka + TILE;
  float* vt = reinterpret_cast<float*>(kb + TILE);
  uint16_t* ia = reinterpret_cast<uint16_t*>(vt + (kVals ? TILE : 0));
  uint16_t* ib = ia + TILE;
  int* wh = reinterpret_cast<int*>(ib + TILE);
  int* start = wh + WARPS * BINS;
  int* count = start + BINS;
  int* wt = count + BINS;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t base = (int64_t)blockIdx.x * TILE;
  const int m = n - base < TILE ? (int)(n - base) : TILE;
  const bool carry = kVals || passes > PASSES;   // the tile index is needed
  for (int x = threadIdx.x; x < TILE; x += THREADS) {
    int32_t key = PAD;
    float val = 0.0f;
    if (x < m) src.lane(base + x, key, val);
    ka[x] = key;
    ia[x] = (uint16_t)x;
    if (kVals) vt[x] = val;
  }
  __syncthreads();
  int32_t k[ITEMS];
  unsigned id[ITEMS];
  unsigned d[ITEMS];
  int pos[ITEMS];
  for (int p = 0; p < passes; ++p) {
    const int32_t* ks = p & 1 ? kb : ka;
    int32_t* kd = p & 1 ? ka : kb;
    const uint16_t* is = p & 1 ? ib : ia;
    uint16_t* idst = p & 1 ? ia : ib;
#pragma unroll
    for (int i = 0; i < ITEMS; ++i) {
      const int x = warp * WARP_KEYS + i * 32 + lane;
      k[i] = ks[x];
      id[i] = carry ? is[x] : 0u;
      d[i] = p < PASSES
                 ? digit(k[i], p * BITS)
                 : (id[i] >> (log_row + (p - PASSES) * BITS)) & (BINS - 1);
    }
    rank_tile(d, pos, wh, start, count, wt);
#pragma unroll
    for (int i = 0; i < ITEMS; ++i) {
      kd[pos[i]] = k[i];
      if (carry) idst[pos[i]] = (uint16_t)id[i];
    }
    __syncthreads();
  }
  const int32_t* kf = passes & 1 ? kb : ka;
  const uint16_t* idf = passes & 1 ? ib : ia;
  for (int x = threadIdx.x; x < m; x += THREADS) {
    const int32_t key = kf[x];
    kout[base + x] = key;
    if (kTotals) {
      float s = 0.0f;
      if (key != PAD && (x + 1 == m || kf[x + 1] != key)) {
        s = vt[idf[x]];
        for (int y = x - 1; y >= 0 && kf[y] == key; --y) s += vt[idf[y]];
      }
      vout[base + x] = s;
    } else if (kVals) {
      vout[base + x] = vt[idf[x]];
    }
  }
}

template <bool kVals>
__global__ void __launch_bounds__(THREADS)
rows_kernel(const int32_t* __restrict__ kin, const float* __restrict__ vin,
            int32_t* __restrict__ kout, float* __restrict__ vout, int64_t n,
            int log_row, int passes) {
  rows_sort<kVals, false>(MemLanes<kVals>(kin, vin), kout, vout, n,
                          log_row, passes);
}

template <bool kVals>
constexpr int rows_smem() {
  return 2 * TILE * 4 + (kVals ? TILE * 4 : 0) + 2 * TILE * 2 +
         (WARPS * BINS + 2 * BINS + WARPS) * 4;
}

template <bool kVals>
int rows_launch_t(const int32_t* kin, const float* vin, int32_t* kout,
                  float* vout, int64_t n, int log_row, int passes,
                  cudaStream_t st) {
  int err = (int)cudaFuncSetAttribute(
      rows_kernel<kVals>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      rows_smem<kVals>());
  if (err) return err;
  rows_kernel<kVals><<<(unsigned)((n + TILE - 1) / TILE), THREADS,
                       rows_smem<kVals>(), st>>>(kin, vin, kout, vout, n,
                                                 log_row, passes);
  return (int)cudaGetLastError();
}

// The passes sort every row on its own: the four key digits alone where a
// tile holds one row (or one padded row, n == row), else enough 8-bit digits
// for the TILE / row row indices of a tile, at most two.
bool tile_passes_ok(int64_t n, int64_t row, int passes) {
  if (passes == PASSES) return n == row || row == TILE;
  return passes > PASSES && passes <= PASSES + 2 &&
         TILE / row <= (int64_t)1 << (BITS * (passes - PASSES));
}

// Every power-of-two row of `row` <= TILE lanes (row | n) in one grid of
// `passes` digit passes; vin == nullptr: keys alone.
int rows_launch(const int32_t* kin, const float* vin, int32_t* kout,
                float* vout, int64_t n, int64_t row, int passes,
                cudaStream_t st) {
  if (row < 1 || row > TILE || (row & (row - 1)) || n % row ||
      !tile_passes_ok(n, row, passes))
    return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  const int log_row = __builtin_ctzll((unsigned long long)row);
  return vin ? rows_launch_t<true>(kin, vin, kout, vout, n, log_row, passes,
                                   st)
             : rows_launch_t<false>(kin, nullptr, kout, nullptr, n, log_row,
                                    passes, st);
}

// A segmented pass covers n lanes exactly: rows of `row` lanes (a multiple
// of TILE), each cut into bpr blocks of tpb tiles, the last one owning the
// rest of the row, and the digit at a multiple of BITS.
bool geometry_ok(int64_t n, int64_t row, int bpr, int tpb, int shift) {
  const int64_t span = (int64_t)tpb * TILE;
  return row > 0 && row % TILE == 0 && n % row == 0 && bpr > 0 && tpb > 0 &&
         (int64_t)bpr * span >= row && (int64_t)(bpr - 1) * span < row &&
         shift >= 0 && shift < 32 && shift % BITS == 0;
}

int upsweep_launch(const int32_t* kin, int32_t* counts, int64_t n,
                   int64_t row, int bpr, int tpb, int shift, cudaStream_t st) {
  if (!geometry_ok(n, row, bpr, tpb, shift)) return (int)cudaErrorInvalidValue;
  upsweep_kernel<<<(unsigned)(n / row * bpr), THREADS, 0, st>>>(
      kin, counts, row, bpr, tpb, shift);
  return (int)cudaGetLastError();
}

int scan_launch(int32_t* counts, int64_t rows, int bpr, cudaStream_t st) {
  if (rows < 1 || bpr < 1) return (int)cudaErrorInvalidValue;
  scan_kernel<<<(unsigned)rows, SCAN_THREADS, 0, st>>>(counts, bpr);
  return (int)cudaGetLastError();
}

// vin == nullptr: keys alone.
int downsweep_launch(const int32_t* kin, const float* vin, int32_t* kout,
                     float* vout, const int32_t* offs, int64_t n, int64_t row,
                     int bpr, int tpb, int shift, cudaStream_t st) {
  if (!geometry_ok(n, row, bpr, tpb, shift)) return (int)cudaErrorInvalidValue;
  const unsigned grid = (unsigned)(n / row * bpr);
  if (vin)
    downsweep_kernel<true><<<grid, THREADS, 0, st>>>(kin, vin, kout, vout,
                                                     offs, row, bpr, tpb,
                                                     shift);
  else
    downsweep_kernel<false><<<grid, THREADS, 0, st>>>(kin, nullptr, kout,
                                                      nullptr, offs, row, bpr,
                                                      tpb, shift);
  return (int)cudaGetLastError();
}

}  // namespace radix
}  // namespace
