// The LSD radix sort's grids (csrc/radix_sort.cuh) as one library with a
// plain C interface: K2's emission sort (keys alone, vin == nullptr), K5's
// row sort ((key, value) pairs) and K8's digits 1-3 launch these four
// entries, each one grid, through kernels/radix_sort.py, which orders them
// and the buffers. Each entry returns cudaGetLastError() after its launch, or
// cudaErrorInvalidValue for a geometry the grid does not cover.
#include "radix_sort.cuh"

extern "C" int radix_rows(const void* kin, const void* vin, void* kout,
                          void* vout, long long n, long long row, int passes,
                          void* stream) {
  return radix::rows_launch((const int32_t*)kin, (const float*)vin,
                            (int32_t*)kout, (float*)vout, n, row, passes,
                            (cudaStream_t)stream);
}

extern "C" int radix_upsweep(const void* kin, void* counts, long long n,
                             long long row, int bpr, int tpb, int shift,
                             void* stream) {
  return radix::upsweep_launch((const int32_t*)kin, (int32_t*)counts, n, row,
                               bpr, tpb, shift, (cudaStream_t)stream);
}

extern "C" int radix_scan(void* counts, long long rows, int bpr,
                          void* stream) {
  return radix::scan_launch((int32_t*)counts, rows, bpr,
                            (cudaStream_t)stream);
}

extern "C" int radix_downsweep(const void* kin, const void* vin, void* kout,
                               void* vout, const void* offs, long long n,
                               long long row, int bpr, int tpb, int shift,
                               void* stream) {
  return radix::downsweep_launch((const int32_t*)kin, (const float*)vin,
                                 (int32_t*)kout, (float*)vout,
                                 (const int32_t*)offs, n, row, bpr, tpb,
                                 shift, (cudaStream_t)stream);
}

extern "C" const char* radix_sort_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
