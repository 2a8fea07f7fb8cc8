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
