// Stable binning ranks of the 'bucket' accumulator for Hopper (sm_90a).
//
// Replaces src/repro/kernels/radix_bucket.py:_make_rank_kernel:
//     rank[i] = #{j <= i : bid[j] == bid[i]} - 1,
// and -1 where bid[i] < 0 (a dead lane) or bid[i] >= n_buckets (an id no
// bucket owns, as the TPU kernel's one-hot columns give it).
//
// Bound: bytes, 8 a lane (the id read, the rank written); the work is a few
// integer operations a lane. The TPU kernel carries an (n_buckets,) counter
// through a sequential scan over 1,024-lane chunks; Hopper's blocks run in
// no order, so the carry becomes three grids over the same chunks:
//   1. bin_hist: one block a chunk counts its ids in shared memory. A warp's
//      lanes with one id are found with __match_any_sync and add their count
//      once, so a chunk of one id (the common case: neighbouring products
//      share an output row) costs 32 shared atomics, not 1,024.
//   2. bin_scan: one block a bucket turns that bucket's per-chunk counts
//      into exclusive prefix sums over the chunks, in place.
//   3. bin_rank: one block a chunk, one thread a lane. The rank is the
//      chunk's offset for the id + the lanes with that id in earlier warps of
//      the chunk (a per-bucket scan over the 32 warps' counts in shared
//      memory) + the lower lanes of the warp with that id (the popcount of
//      the __match_any_sync mask below the lane).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int CHUNK = 1024;          // lanes per block, one a thread
constexpr int WARPS = CHUNK / 32;
constexpr int MAX_BUCKETS = 256;     // shared counters: 32 warps x 256 x 4 B

__device__ __forceinline__ int load_id(const int32_t* bid, int64_t i,
                                       int64_t n, int nb) {
  const int b = i < n ? bid[i] : -1;
  return (b >= 0 && b < nb) ? b : -1;
}

__global__ void bin_hist_kernel(const int32_t* __restrict__ bid,
                                int32_t* __restrict__ counts, int64_t n,
                                int nb, int64_t n_chunks) {
  __shared__ int hist[MAX_BUCKETS];
  for (int b = threadIdx.x; b < nb; b += blockDim.x) hist[b] = 0;
  __syncthreads();
  const int b = load_id(bid, (int64_t)blockIdx.x * CHUNK + threadIdx.x, n, nb);
  const unsigned peers = __match_any_sync(0xffffffffu, b);
  const int lane = threadIdx.x & 31;
  if (b >= 0 && (peers & ((1u << lane) - 1)) == 0)
    atomicAdd(&hist[b], __popc(peers));
  __syncthreads();
  for (int c = threadIdx.x; c < nb; c += blockDim.x)
    counts[c * n_chunks + blockIdx.x] = hist[c];
}

__global__ void bin_scan_kernel(int32_t* __restrict__ counts,
                                int64_t n_chunks) {
  __shared__ int part[CHUNK];
  int32_t* c = counts + (int64_t)blockIdx.x * n_chunks;
  const int64_t seg = (n_chunks + blockDim.x - 1) / blockDim.x;
  const int64_t lo = threadIdx.x * seg;
  const int64_t hi = lo + seg < n_chunks ? lo + seg : n_chunks;
  int sum = 0;
  for (int64_t x = lo; x < hi; ++x) sum += c[x];
  part[threadIdx.x] = sum;
  __syncthreads();
  for (int off = 1; off < blockDim.x; off <<= 1) {
    const int add = threadIdx.x >= off ? part[threadIdx.x - off] : 0;
    __syncthreads();
    part[threadIdx.x] += add;
    __syncthreads();
  }
  int run = part[threadIdx.x] - sum;
  for (int64_t x = lo; x < hi; ++x) {
    const int t = c[x];
    c[x] = run;
    run += t;
  }
}

__global__ void bin_rank_kernel(const int32_t* __restrict__ bid,
                                const int32_t* __restrict__ offs,
                                int32_t* __restrict__ rank, int64_t n, int nb,
                                int64_t n_chunks) {
  __shared__ int wc[WARPS * MAX_BUCKETS];
  for (int x = threadIdx.x; x < WARPS * nb; x += blockDim.x) wc[x] = 0;
  __syncthreads();
  const int64_t i = (int64_t)blockIdx.x * CHUNK + threadIdx.x;
  const int b = load_id(bid, i, n, nb);
  const unsigned peers = __match_any_sync(0xffffffffu, b);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int below = __popc(peers & ((1u << lane) - 1));
  if (b >= 0 && below == 0) wc[warp * nb + b] = __popc(peers);
  __syncthreads();
  for (int c = threadIdx.x; c < nb; c += blockDim.x) {
    int run = 0;
    for (int w = 0; w < WARPS; ++w) {
      const int t = wc[w * nb + c];
      wc[w * nb + c] = run;
      run += t;
    }
  }
  __syncthreads();
  if (i < n)
    rank[i] = b < 0 ? -1
                    : offs[b * n_chunks + blockIdx.x] + wc[warp * nb + b] +
                          below;
}

}  // namespace

// rank (n,) int32 from bid (n,) int32; counts is scratch of
// n_buckets * ceil(n / 1024) int32. *grids receives the grids launched.
extern "C" int bin_ranks(const void* bid, void* rank, void* counts,
                         long long n, int n_buckets, int* grids,
                         void* stream) {
  *grids = 0;
  if (n <= 0) return 0;
  if (n_buckets < 1 || n_buckets > MAX_BUCKETS) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int64_t n_chunks = (n + CHUNK - 1) / CHUNK;
  bin_hist_kernel<<<(unsigned)n_chunks, CHUNK, 0, st>>>(
      (const int32_t*)bid, (int32_t*)counts, n, n_buckets, n_chunks);
  int err = (int)cudaGetLastError();
  ++*grids;
  if (err) return err;
  bin_scan_kernel<<<n_buckets, CHUNK, 0, st>>>((int32_t*)counts, n_chunks);
  err = (int)cudaGetLastError();
  ++*grids;
  if (err) return err;
  bin_rank_kernel<<<(unsigned)n_chunks, CHUNK, 0, st>>>(
      (const int32_t*)bid, (const int32_t*)counts, (int32_t*)rank, n,
      n_buckets, n_chunks);
  ++*grids;
  return (int)cudaGetLastError();
}

extern "C" const char* radix_bucket_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
