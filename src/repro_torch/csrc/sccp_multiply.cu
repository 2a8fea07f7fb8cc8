// SCCP slab-pair structured multiply for Hopper (sm_90a).
//
// Replaces src/repro/kernels/sccp_multiply.py:_sccp_kernel. For A in
// row-wise ELLPACK (k_a, n) and B in column-wise ELLPACK (n, k_b) it writes
// the three (k_a, n, k_b) planes
//     val[s, c, t] = a_val[s, c] * b_val[c, t]
//     row[s, c, t] = a_idx[s, c]
//     col[s, c, t] = b_idx[c, t]
// with val = 0 and row = col = -1 on every lane where either index is -1.
//
// Bound: bytes. The kernel reads 2*(k_a*n + n*k_b)*4 bytes and writes
// 3*k_a*n*k_b*4 bytes; it does one multiply per lane. Design: one thread per
// (c, t) lane of B's (n, k_b) plane, which is also the flat offset of that
// lane inside every s-slice of the output, so each thread reads its B lane
// once and then walks s. For a fixed s, neighbouring threads store to
// neighbouring addresses (fully coalesced stores, the dominant traffic), and
// the A element a[s, c] is shared by the k_b neighbouring threads of one c
// (one broadcast load). The stores are streaming (__stcs): the planes are
// written once and read by the next stage long after they have left L2.
// The ragged edge of n is masked here, so the caller pads nothing.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void sccp_multiply_kernel(const float* __restrict__ a_val,
                                     const int32_t* __restrict__ a_idx,
                                     const float* __restrict__ b_val,
                                     const int32_t* __restrict__ b_idx,
                                     float* __restrict__ val,
                                     int32_t* __restrict__ row,
                                     int32_t* __restrict__ col,
                                     int64_t k_a, int64_t n, int64_t k_b) {
  const int64_t plane = n * k_b;
  const int64_t ct = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (ct >= plane) return;
  const int64_t c = ct / k_b;
  const float bv = b_val[ct];
  const int32_t bi = b_idx[ct];
  for (int64_t s = 0; s < k_a; ++s) {
    const float av = a_val[s * n + c];
    const int32_t ai = a_idx[s * n + c];
    const bool ok = (ai >= 0) && (bi >= 0);
    const int64_t o = s * plane + ct;
    __stcs(val + o, ok ? av * bv : 0.0f);
    __stcs(row + o, ok ? ai : -1);
    __stcs(col + o, ok ? bi : -1);
  }
}

}  // namespace

extern "C" int sccp_multiply_f32(const void* a_val, const void* a_idx,
                                 const void* b_val, const void* b_idx,
                                 void* val, void* row, void* col,
                                 long long k_a, long long n, long long k_b,
                                 void* stream) {
  const int64_t plane = (int64_t)n * k_b;
  if (plane > 0 && k_a > 0) {
    const int threads = 256;
    const int64_t blocks = (plane + threads - 1) / threads;
    sccp_multiply_kernel<<<(unsigned)blocks, threads, 0,
                           (cudaStream_t)stream>>>(
        (const float*)a_val, (const int32_t*)a_idx, (const float*)b_val,
        (const int32_t*)b_idx, (float*)val, (int32_t*)row, (int32_t*)col,
        k_a, n, k_b);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* sccp_multiply_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
