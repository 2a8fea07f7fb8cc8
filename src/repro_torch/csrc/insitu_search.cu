// The 'search' accumulation's kernels for Hopper (sm_90a): the emission sort,
// the alignment search and the literal bit-serial minima scan.
//
// 1. emit sort (emit_tile + emit_merge_global) replaces
//    src/repro/kernels/insitu_search.py:_make_emit_sort_kernel and
//    _make_emit_merge_kernel: an ascending key-only bitonic sort of a
//    power-of-two packed int32 key stream.
//    Bound: bytes (each key read and written once at the least). Design: the
//    classic bitonic network, k = 2, 4, ..., n blocks and strides j = k/2 ..
//    1, ascending where (i & k) == 0. Every stride below one shared-memory
//    tile (4096 keys = 16 KB) runs inside emit_tile, so a tile is read and
//    written once per merge level instead of once per stride; each stride
//    at or above the tile is one coalesced compare-exchange pass over device
//    memory (emit_merge_global). Blocks never exchange data, so no pass
//    carries state across blocks.
// 2. align replaces src/repro/kernels/insitu_search.py:_make_align_kernel
//    (a 512 x 512 broadcast compare per block, O(S*u) work). Here one thread
//    per product key runs a lower-bound binary search over the sorted unique
//    keys: slot = #{uk < pk}, hit = pk in uk, O(S log u) work.
//    Bound: bytes (product keys in, slot and hit out). The top levels of the
//    search tree stay in L2; only the last few levels touch device memory.
// 3. minima replaces src/repro/kernels/insitu_search.py:_minima_kernel: the
//    paper's Alg. 1, a 31-step scan from bit 30 down to bit 0 that keeps the
//    active rows whose bit is 0 whenever any active row has a 0 there.
//    Bound: operations on a short vector; it is kept bit-serial on purpose.
//    Design: one block walks the vector once per bit and ends the bit with
//    __syncthreads_or, the block-wide "does any row hold a 0" of the paper's
//    sense amplifiers.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int32_t KEY_INVALID = 2147483647;

// One compare-exchange stride over a shared-memory tile; `base` is the
// tile's first global lane, which fixes each pair's direction.
__device__ __forceinline__ void tile_stride(int32_t* s, int64_t base, int half,
                                            int j, int64_t k) {
  for (int p = threadIdx.x; p < half; p += blockDim.x) {
    const int i = ((p & ~(j - 1)) << 1) | (p & (j - 1));
    const int l = i + j;
    const bool asc = ((base + i) & k) == 0;
    const int32_t a = s[i];
    const int32_t b = s[l];
    if ((a > b) == asc) {
      s[i] = b;
      s[l] = a;
    }
  }
  __syncthreads();
}

// k_merge == 0: sort every tile (all blocks k <= tile).
// k_merge > tile: finish merge level k_merge (strides tile/2 .. 1).
// `in` may equal `out`: each block reads its tile fully before it writes.
__global__ void emit_tile_kernel(const int32_t* in, int32_t* out, int tile,
                                 int64_t k_merge) {
  extern __shared__ int32_t s[];
  const int64_t base = (int64_t)blockIdx.x * tile;
  for (int t = threadIdx.x; t < tile; t += blockDim.x) s[t] = in[base + t];
  __syncthreads();
  const int half = tile >> 1;
  if (k_merge == 0) {
    for (int64_t k = 2; k <= tile; k <<= 1)
      for (int j = (int)(k >> 1); j > 0; j >>= 1) tile_stride(s, base, half, j, k);
  } else {
    for (int j = half; j > 0; j >>= 1) tile_stride(s, base, half, j, k_merge);
  }
  for (int t = threadIdx.x; t < tile; t += blockDim.x) out[base + t] = s[t];
}

__global__ void emit_merge_global_kernel(int32_t* __restrict__ key,
                                         int64_t half_n, int64_t j,
                                         int64_t k) {
  const int64_t p = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= half_n) return;
  const int64_t i = ((p & ~(j - 1)) << 1) | (p & (j - 1));
  const int64_t l = i + j;
  const bool asc = (i & k) == 0;
  const int32_t a = key[i];
  const int32_t b = key[l];
  if ((a > b) == asc) {
    key[i] = b;
    key[l] = a;
  }
}

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

__global__ void minima_mask_kernel(const int32_t* __restrict__ v,
                                   uint8_t* __restrict__ mask, int64_t n) {
  for (int64_t i = threadIdx.x; i < n; i += blockDim.x)
    mask[i] = v[i] != KEY_INVALID;
  for (int bit = 30; bit >= 0; --bit) {
    int zero = 0;
    for (int64_t i = threadIdx.x; i < n; i += blockDim.x)
      if (mask[i] && ((v[i] >> bit) & 1) == 0) zero = 1;
    // Alg. 1 line 8: keep the '0' rows iff some active row holds a '0'.
    if (__syncthreads_or(zero)) {
      for (int64_t i = threadIdx.x; i < n; i += blockDim.x)
        if (mask[i] && ((v[i] >> bit) & 1)) mask[i] = 0;
    }
  }
}

}  // namespace

extern "C" int emit_tile(const void* in, void* out, long long n, int tile,
                         long long k_merge, void* stream) {
  if (n > 0) {
    const int threads = tile >= 2048 ? 1024 : (tile >= 2 ? tile / 2 : 1);
    emit_tile_kernel<<<(unsigned)(n / tile), threads, tile * sizeof(int32_t),
                       (cudaStream_t)stream>>>((const int32_t*)in,
                                               (int32_t*)out, tile, k_merge);
  }
  return (int)cudaGetLastError();
}

extern "C" int emit_merge_global(void* key, long long n, long long j,
                                 long long k, void* stream) {
  const int64_t half_n = n / 2;
  if (half_n > 0) {
    const int threads = 256;
    emit_merge_global_kernel<<<(unsigned)((half_n + threads - 1) / threads),
                               threads, 0, (cudaStream_t)stream>>>(
        (int32_t*)key, half_n, j, k);
  }
  return (int)cudaGetLastError();
}

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

extern "C" int minima_mask(const void* v, void* mask, long long n,
                           void* stream) {
  minima_mask_kernel<<<1, 1024, 0, (cudaStream_t)stream>>>(
      (const int32_t*)v, (uint8_t*)mask, n);
  return (int)cudaGetLastError();
}

extern "C" const char* insitu_search_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
