// K8, the streaming engine's step for Hopper (sm_90a): a fused SCCP multiply
// and stable (key, value) LSD radix sort; the run-tail totals follow.
//
// Replaces src/repro/kernels/fused_sccp_stream.py:_make_fused_kernel (called
// by fused_slab_sort_pallas). A block of `group` A slabs a (group, n) times
// all B slabs b (n, k_b) gives the products a_val[g,c]*b_val[c,t] packed to
// int32 keys a_idx[g,c]*n_cols + b_idx[c,t], in the (group, n, k_b) lane
// order of the reference (at group 1 its _pack_tile, above it the lanes its
// streaming._sort_tile sorts). A lane where either index is -1 becomes
// KEY_INVALID with value 0, and so does every pad lane up to pot, the next
// power of two of group*n*k_b. The pot lanes come out sorted ascending as one
// row, ties in lane order, each run of equal keys with its value total on its
// last lane and 0 on the others.
//
// Bound: bytes. The function reads the operands once (8 B an A slot, 8 B a B
// slot) and writes 8 B a lane of pot. On the TPU the whole tile sits in VMEM;
// on Hopper bcsstk32's tile is 2^22 pairs, 32 MB, far over the 227 KB of
// shared memory, so the sort is the LSD radix sort of csrc/radix_sort.cuh,
// four 8-bit digits, and this file gives it a lane source, SlabLanes, that
// forms each lane's key and value from the operands where the sort would
// read a stream:
//   * above one tile, the first digit's count and scatter (the two grids
//     here) form the lanes, so the unsorted products never reach device
//     memory; digits 1-3 are the radix library's own grids
//     (csrc/radix_sort.cu) and the totals bitonic_merge.cu's seg_totals_f32,
//     13 grids a step. Only the real lanes, rounded up to a tile, are
//     sorted: the pad lanes above them are KEY_INVALID, the largest key, so
//     the first count grid writes them straight to the tail of the keys.
//   * a step of at most one 4,096-lane tile is one grid: it forms the tile
//     in shared memory, sorts it and writes the keys and the totals.
// The totals walk each run back from its tail over the stably sorted values,
// the order seg_total_kernel sums in.
#include "radix_sort.cuh"

namespace {

using radix::ITEMS;
using radix::PAD;
using radix::THREADS;
using radix::WARP_KEYS;

// The lanes of one streaming step: lane l = (g * n + c) * k_b + t holds the
// product of A slot (g, c) and B slot (c, t). lanes (< 2^31) counts them;
// past it every lane is PAD with value 0.
struct SlabLanes {
  const float* a_val;
  const int32_t* a_idx;
  const float* b_val;
  const int32_t* b_idx;
  uint32_t lanes, n, k_b, slab;   // slab = n * k_b
  int64_t n_cols;

  __device__ __forceinline__ bool locate(int64_t l, uint32_t& a,
                                         uint32_t& r) const {
    if (l >= lanes) return false;
    const uint32_t u = (uint32_t)l;
    const uint32_t g = u / slab;
    r = u - g * slab;
    a = g * n + r / k_b;
    return true;
  }

  __device__ __forceinline__ int32_t key(int64_t l) const {
    uint32_t a, r;
    if (!locate(l, a, r)) return PAD;
    const int32_t ai = a_idx[a];
    const int32_t bi = b_idx[r];
    return ai >= 0 && bi >= 0 ? (int32_t)((int64_t)ai * n_cols + bi) : PAD;
  }

  __device__ __forceinline__ void lane(int64_t l, int32_t& k,
                                       float& v) const {
    uint32_t a, r;
    k = PAD;
    v = 0.0f;
    if (!locate(l, a, r)) return;
    const int32_t ai = a_idx[a];
    const int32_t bi = b_idx[r];
    if (ai >= 0 && bi >= 0) {
      k = (int32_t)((int64_t)ai * n_cols + bi);
      v = a_val[a] * b_val[r];
    }
  }

  __device__ __forceinline__ void run(int64_t l, int32_t (&k)[16]) const {
#pragma unroll
    for (int q = 0; q < 16; ++q) k[q] = key(l + q);
  }

  __device__ __forceinline__ void begin(int64_t) {}

  // Thread (warp w, lane x) forms tile lanes w * WARP_KEYS + i * 32 + x:
  // a warp reads 32 consecutive B slots an item.
  __device__ __forceinline__ void tile(int64_t at, int64_t, int32_t*, float*,
                                       int32_t (&k)[ITEMS],
                                       float (&v)[ITEMS]) const {
    const int64_t w =
        at + (threadIdx.x >> 5) * WARP_KEYS + (threadIdx.x & 31);
#pragma unroll
    for (int i = 0; i < ITEMS; ++i) lane(w + i * 32, k[i], v[i]);
  }
};

// The first digit's count over the formed lanes; the grid also writes PAD
// to the `tail` keys that follow the sorted lanes.
__global__ void __launch_bounds__(THREADS)
slab_upsweep_kernel(SlabLanes src, int32_t* __restrict__ counts, int64_t row,
                    int bpr, int tpb, int shift, int32_t* __restrict__ ktail,
                    int64_t tail) {
  radix::upsweep(src, counts, row, bpr, tpb, shift);
  for (int64_t x = (int64_t)blockIdx.x * THREADS + threadIdx.x; x < tail;
       x += (int64_t)gridDim.x * THREADS)
    ktail[x] = PAD;
}

// The first digit's stable scatter of the formed lanes, values beside.
__global__ void __launch_bounds__(THREADS)
slab_downsweep_kernel(SlabLanes src, int32_t* __restrict__ kout,
                      float* __restrict__ vout,
                      const int32_t* __restrict__ offs, int64_t row, int bpr,
                      int tpb, int shift) {
  radix::downsweep<true>(src, kout, vout, offs, row, bpr, tpb, shift);
}

// A step of pot <= TILE lanes: formed, sorted and totalled in one block.
__global__ void __launch_bounds__(THREADS)
slab_rows_kernel(SlabLanes src, int32_t* __restrict__ kout,
                 float* __restrict__ tot, int64_t pot) {
  radix::rows_sort<true, true>(src, kout, tot, pot, 0, radix::PASSES);
}

SlabLanes slab_lanes(const void* a_val, const void* a_idx, const void* b_val,
                     const void* b_idx, long long group, long long n,
                     long long k_b, long long n_cols) {
  // an empty slab forms no lane; its divisors stay nonzero all the same
  return SlabLanes{(const float*)a_val,
                   (const int32_t*)a_idx,
                   (const float*)b_val,
                   (const int32_t*)b_idx,
                   (uint32_t)(group * n * k_b),
                   (uint32_t)n,
                   (uint32_t)(k_b > 0 ? k_b : 1),
                   (uint32_t)(n * k_b > 0 ? n * k_b : 1),
                   (int64_t)n_cols};
}

// The formed lanes must be countable in 32 bits, as the radix sort's
// offsets are.
bool slab_ok(long long group, long long n, long long k_b) {
  return group >= 0 && n >= 0 && k_b >= 0 && group * n * k_b < (1LL << 31);
}

}  // namespace

// a_val/a_idx (group, n), b_val/b_idx (n, k_b), all contiguous. The step of
// pot <= 4,096 lanes (pot a power of two >= group*n*k_b): the sorted keys
// to kout and the run-tail totals to tot, pot lanes each, in one grid.
extern "C" int fused_slab_rows(const void* a_val, const void* a_idx,
                               const void* b_val, const void* b_idx,
                               void* kout, void* tot, long long group,
                               long long n, long long k_b, long long n_cols,
                               long long pot, void* stream) {
  if (!slab_ok(group, n, k_b) || pot < group * n * k_b || pot > radix::TILE ||
      pot < 1)
    return (int)cudaErrorInvalidValue;
  constexpr int smem = radix::rows_smem<true>();
  int err = (int)cudaFuncSetAttribute(
      slab_rows_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err) return err;
  slab_rows_kernel<<<1, THREADS, smem, (cudaStream_t)stream>>>(
      slab_lanes(a_val, a_idx, b_val, b_idx, group, n, k_b, n_cols),
      (int32_t*)kout, (float*)tot, pot);
  return (int)cudaGetLastError();
}

// The first digit's count of a step above one tile: the row is the formed
// lanes rounded up to a tile (kernels/radix_sort.py span_geometry), and
// the `tail` keys at ktail, which follow them up to pot, become PAD.
extern "C" int fused_slab_upsweep(const void* a_val, const void* a_idx,
                                  const void* b_val, const void* b_idx,
                                  long long group, long long n, long long k_b,
                                  long long n_cols, void* counts,
                                  long long row, int bpr, int tpb, int shift,
                                  void* ktail, long long tail, void* stream) {
  if (!slab_ok(group, n, k_b) || row < group * n * k_b || tail < 0 ||
      !radix::geometry_ok(row, row, bpr, tpb, shift))
    return (int)cudaErrorInvalidValue;
  slab_upsweep_kernel<<<(unsigned)bpr, THREADS, 0, (cudaStream_t)stream>>>(
      slab_lanes(a_val, a_idx, b_val, b_idx, group, n, k_b, n_cols),
      (int32_t*)counts, row, bpr, tpb, shift, (int32_t*)ktail, tail);
  return (int)cudaGetLastError();
}

// The first digit's scatter of the same lanes into (kout, vout), by the
// scanned counts.
extern "C" int fused_slab_downsweep(const void* a_val, const void* a_idx,
                                    const void* b_val, const void* b_idx,
                                    long long group, long long n,
                                    long long k_b, long long n_cols,
                                    void* kout, void* vout, const void* offs,
                                    long long row, int bpr, int tpb,
                                    int shift, void* stream) {
  if (!slab_ok(group, n, k_b) || row < group * n * k_b ||
      !radix::geometry_ok(row, row, bpr, tpb, shift))
    return (int)cudaErrorInvalidValue;
  slab_downsweep_kernel<<<(unsigned)bpr, THREADS, 0, (cudaStream_t)stream>>>(
      slab_lanes(a_val, a_idx, b_val, b_idx, group, n, k_b, n_cols),
      (int32_t*)kout, (float*)vout, (const int32_t*)offs, row, bpr, tpb,
      shift);
  return (int)cudaGetLastError();
}

extern "C" const char* fused_sccp_stream_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
