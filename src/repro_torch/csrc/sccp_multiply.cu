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
// 3*k_a*n*k_b*4 bytes; it does one multiply per lane. Design: a thread owns
// a quad of four consecutive lanes ct = 4q .. 4q+3 of B's (n, k_b) plane,
// which are also the flat offsets of those lanes inside every s-slice of the
// output. It reads the quad once, 16 bytes of b_val and 16 of b_idx, and
// finds each lane's column c with one division, then walks s: a[s, c] is
// one broadcast load shared by the quad's lanes of one c, and the quad's
// val, row and col go out as three 16-byte stores wherever the output
// offset s*n*k_b + 4q is a multiple of 4 (always when n*k_b is), lane by
// lane elsewhere and in B's last, partial quad; all as streaming stores
// (__stcs: the planes are written once and read by the next stage long
// after they have left L2).
// Index arithmetic is 32-bit
// where the planes hold fewer than 2^31 lanes. The grid is sized to the
// card (8 blocks an SM) and walks the quads in a grid-stride loop, so a
// one-slab call (k_a = 1, the streaming step) gives each thread a few quads
// instead of launching a block per 256 lanes that each do one lane and
// exit. The ragged edge of n is masked here, so the caller pads nothing.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int BLOCKS_PER_SM = 8;

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

template <typename I>
__global__ void __launch_bounds__(THREADS)
sccp_multiply_kernel(const float* __restrict__ a_val,
                     const int32_t* __restrict__ a_idx,
                     const float* __restrict__ b_val,
                     const int32_t* __restrict__ b_idx,
                     float* __restrict__ val, int32_t* __restrict__ row,
                     int32_t* __restrict__ col, I k_a, I n, I k_b,
                     bool vec) {
  const I plane = n * k_b;
  const I quads = (plane + 3) / 4;
  for (I q = (I)blockIdx.x * THREADS + threadIdx.x; q < quads;
       q += (I)gridDim.x * THREADS) {
    const I ct = 4 * q;
    const int m = plane - ct < 4 ? (int)(plane - ct) : 4;
    float bv[4] = {0.f, 0.f, 0.f, 0.f};
    int32_t bi[4] = {-1, -1, -1, -1};
    if (vec && m == 4) {
      const float4 v = __ldg(reinterpret_cast<const float4*>(b_val + ct));
      const int4 i = __ldg(reinterpret_cast<const int4*>(b_idx + ct));
      bv[0] = v.x, bv[1] = v.y, bv[2] = v.z, bv[3] = v.w;
      bi[0] = i.x, bi[1] = i.y, bi[2] = i.z, bi[3] = i.w;
    } else {
#pragma unroll
      for (int l = 0; l < 4; ++l)
        if (l < m) {
          bv[l] = __ldg(b_val + ct + l);
          bi[l] = __ldg(b_idx + ct + l);
        }
    }
    // each lane's column of A: one division, then a step at each wrap of t
    I c[4];
    {
      I cc = ct / k_b;
      I t = ct - cc * k_b;
#pragma unroll
      for (int l = 0; l < 4; ++l) {
        c[l] = cc;
        if (++t == k_b) {
          t = 0;
          ++cc;
        }
      }
    }
    for (I s = 0; s < k_a; ++s) {
      float v[4];
      int32_t r[4], co[4];
      float av = 0.f;
      int32_t ai = -1;
#pragma unroll
      for (int l = 0; l < 4; ++l) {
        if (l < m && (l == 0 || c[l] != c[l - 1])) {
          av = __ldg(a_val + s * n + c[l]);
          ai = __ldg(a_idx + s * n + c[l]);
        }
        const bool ok = ai >= 0 && bi[l] >= 0;
        v[l] = ok ? av * bv[l] : 0.0f;
        r[l] = ok ? ai : -1;
        co[l] = ok ? bi[l] : -1;
      }
      const I o = s * plane + ct;
      if (vec && m == 4 && (o & 3) == 0) {
        __stcs(reinterpret_cast<float4*>(val + o),
               make_float4(v[0], v[1], v[2], v[3]));
        __stcs(reinterpret_cast<int4*>(row + o),
               make_int4(r[0], r[1], r[2], r[3]));
        __stcs(reinterpret_cast<int4*>(col + o),
               make_int4(co[0], co[1], co[2], co[3]));
      } else {
#pragma unroll
        for (int l = 0; l < 4; ++l)
          if (l < m) {
            __stcs(val + o + l, v[l]);
            __stcs(row + o + l, r[l]);
            __stcs(col + o + l, co[l]);
          }
      }
    }
  }
}

int sms() {
  static int count = 0;
  if (count == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount,
                               dev) != cudaSuccess)
      count = 132;
  }
  return count;
}

}  // namespace

extern "C" int sccp_multiply_f32(const void* a_val, const void* a_idx,
                                 const void* b_val, const void* b_idx,
                                 void* val, void* row, void* col,
                                 long long k_a, long long n, long long k_b,
                                 void* stream) {
  if (k_a < 0 || n < 0 || k_b < 0) return (int)cudaErrorInvalidValue;
  const int64_t plane = (int64_t)n * k_b;
  if (plane == 0 || k_a == 0) return (int)cudaGetLastError();
  const int64_t quads = (plane + 3) / 4;
  const int64_t want = (quads + THREADS - 1) / THREADS;
  const int64_t cap = (int64_t)sms() * BLOCKS_PER_SM;
  const unsigned blocks = (unsigned)(want < cap ? want : cap);
  const bool vec = aligned16(b_val) && aligned16(b_idx) && aligned16(val) &&
                   aligned16(row) && aligned16(col);
  cudaStream_t st = (cudaStream_t)stream;
  if (k_a * plane < (1LL << 31) - 4)
    sccp_multiply_kernel<int32_t><<<blocks, THREADS, 0, st>>>(
        (const float*)a_val, (const int32_t*)a_idx, (const float*)b_val,
        (const int32_t*)b_idx, (float*)val, (int32_t*)row, (int32_t*)col,
        (int32_t)k_a, (int32_t)n, (int32_t)k_b, vec);
  else
    sccp_multiply_kernel<int64_t><<<blocks, THREADS, 0, st>>>(
        (const float*)a_val, (const int32_t*)a_idx, (const float*)b_val,
        (const int32_t*)b_idx, (float*)val, (int32_t*)row, (int32_t*)col,
        k_a, n, k_b, vec);
  return (int)cudaGetLastError();
}

extern "C" const char* sccp_multiply_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
