// K8, the streaming engine's step for Hopper (sm_90a): a fused SCCP multiply
// and (key, value) bitonic sort with run-tail totals.
//
// Replaces src/repro/kernels/fused_sccp_stream.py:_make_fused_kernel (called
// by fused_slab_sort_pallas). A block of `group` A slabs a (group, n) times
// all B slabs b (n, k_b) gives the products a_val[g,c]*b_val[c,t] packed to
// int32 keys a_idx[g,c]*n_cols + b_idx[c,t], in the (group, n, k_b) lane
// order of the reference (at group 1 its _pack_tile, above it the lanes its
// streaming._sort_tile sorts). A lane where either index is -1 becomes
// KEY_INVALID with value 0, and so does every pad lane up to pot, the next
// power of two of group*n*k_b. The pot lanes come out sorted ascending as one
// row, each run of equal keys with its value total on its last lane and 0 on
// the others.
//
// Bound: bytes. The function reads the operands once (8 B an A slot, 8 B a B
// slot) and writes 8 B a lane of pot; its compare-exchanges,
// pot*log2(pot)*(log2(pot)+1)/4, stay far below the card's integer rate.
// Design: on the TPU the whole tile sits in VMEM; on Hopper bcsstk32's tile
// is 2^22 pairs, 32 MB, far over the 227 KB of shared memory. So the first
// grid forms each 4,096-pair shared tile's products in place from the
// operands, packs them and runs every stage below the tile in shared memory:
// unsorted products never reach device memory. The stages above the tile are
// the global strides and tile passes of K5 (csrc/bitonic_net.cuh), and the
// totals its segmented-total grid. A tile of at most 4,096 lanes is one
// residency, as on the TPU.
#include "bitonic_net.cuh"

namespace {

// The first grid: tile blockIdx.x of the packed, padded stream, formed in
// shared memory and sorted through every stage below the tile.
__global__ void fused_tile_kernel(const float* __restrict__ a_val,
                                  const int32_t* __restrict__ a_idx,
                                  const float* __restrict__ b_val,
                                  const int32_t* __restrict__ b_idx,
                                  int32_t* kout, float* vout, int64_t lanes,
                                  int64_t n, int64_t k_b, int64_t n_cols,
                                  int t, int64_t row) {
  extern __shared__ int32_t smem[];
  int32_t* sk = smem;
  float* sv = reinterpret_cast<float*>(smem + t);
  const int64_t base = (int64_t)blockIdx.x * t;
  const int64_t slab = n * k_b;
  for (int x = threadIdx.x; x < t; x += blockDim.x) {
    const int64_t l = base + x;
    int32_t key = KEY_INVALID;
    float val = 0.0f;
    if (l < lanes) {
      const int64_t g = l / slab;
      const int64_t r = l - g * slab;
      const int64_t c = r / k_b;
      const int64_t a = g * n + c;
      const int32_t ai = a_idx[a];
      const int32_t bi = b_idx[r];
      if (ai >= 0 && bi >= 0) {
        key = (int32_t)((int64_t)ai * n_cols + bi);
        val = a_val[a] * b_val[r];
      }
    }
    sk[x] = key;
    sv[x] = val;
  }
  __syncthreads();
  tile_network(sk, sv, t, base, row, 0, 0);
  for (int x = threadIdx.x; x < t; x += blockDim.x) {
    kout[base + x] = sk[x];
    vout[base + x] = sv[x];
  }
}

}  // namespace

// a_val/a_idx (group, n), b_val/b_idx (n, k_b), all contiguous; kout, vsorted
// and tot hold pot lanes (pot a power of two >= group*n*k_b). The sorted keys
// go to kout, the values sorted with them to vsorted (scratch), the run-tail
// totals to tot. *grids receives the number of grids launched.
extern "C" int fused_slab_sort_f32(const void* a_val, const void* a_idx,
                                   const void* b_val, const void* b_idx,
                                   void* kout, void* vsorted, void* tot,
                                   long long group, long long n, long long k_b,
                                   long long n_cols, long long pot, int* grids,
                                   void* stream) {
  *grids = 0;
  if (pot <= 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  int32_t* k = (int32_t*)kout;
  float* v = (float*)vsorted;
  const int t = (int)(pot < TILE ? pot : TILE);
  fused_tile_kernel<<<(unsigned)(pot / t), tile_threads(t), t * 8, st>>>(
      (const float*)a_val, (const int32_t*)a_idx, (const float*)b_val,
      (const int32_t*)b_idx, k, v, group * n * k_b, n, k_b, n_cols, t, pot);
  int err = (int)cudaGetLastError();
  ++*grids;
  if (!err) err = sort_above_tile(k, v, (float*)tot, pot, t, pot, grids, st);
  return err;
}

extern "C" const char* fused_sccp_stream_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
