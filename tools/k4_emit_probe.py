"""Split K4's faithful emission (``minima_emit`` in
``src/repro_torch/csrc/insitu_search.cu``) into its serial parts on the card.

An emission of the one-launch kernel is one chain: every warp reads the
warps' values from shared memory and reduces them (the decision), the warp
that held the minimum consumes its rows and reduces its keys again (the
rescan), writes its new value to shared memory, and the block meets at one
barrier. Each part here runs alone in a loop inside one block, on the same
16 keys a thread, timed by the SM's cycle counter (``clock64``) and the
global nanosecond timer, at 32, 512 and 1,024 threads:

* ``emission_store``: the whole loop, as the kernel runs it (counts off):
  one thread stores each key to device memory before the barrier;
* ``emission``: the same with the key stored to shared memory instead;
* ``decision_barrier``: the loop without the rescan (the warp that held
  the minimum offers the minimum plus one);
* ``rescan``: the rescan alone, in one warp as in an emission, each
  round's minimum the next round's key to consume, no shared memory and no
  barrier;
* ``barrier``: a shared load, a shared store and the barrier, no reduction;
* ``redux``: one ``__reduce_min_sync`` a round, chained.

Beside them the emission entry itself, through ``faithful_emit``, on 8,192
distinct keys at caps 256 and 512 (CUDA events; the slope is its time an
emission), and ``torch.unique(key, sorted=True)`` on the same keys, the two
timed in turns.

Run from the repository root on a machine with a CUDA card and ``nvcc``:

    python3 tools/k4_emit_probe.py

Prints the card's name and power limit, then one JSON object a reading.
"""
from __future__ import annotations

import ctypes
import json
import statistics
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

SOURCE = r"""
#include <cstdint>
#include <cuda_runtime.h>

namespace {
constexpr int32_t KI = 2147483647;
constexpr unsigned FULL = 0xffffffffu;
constexpr int KEYS = 16;

__device__ __forceinline__ unsigned long long now_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__device__ __forceinline__ int32_t fold(const int32_t (&k)[KEYS]) {
  int32_t t[KEYS / 2];
#pragma unroll
  for (int j = 0; j < KEYS / 2; ++j) t[j] = min(k[2 * j], k[2 * j + 1]);
#pragma unroll
  for (int w = KEYS / 4; w >= 1; w /= 2)
#pragma unroll
    for (int j = 0; j < w; ++j) t[j] = min(t[2 * j], t[2 * j + 1]);
  return t[0];
}

// MODE 0 emission, 1 decision_barrier, 2 rescan, 3 barrier, 4 redux,
// 5 emission_store
template <int MODE>
__global__ void part_kernel(const int32_t* __restrict__ key, int iters,
                            long long* __restrict__ out,
                            int32_t* __restrict__ sink,
                            int32_t* __restrict__ vals) {
  __shared__ int32_t sv[512];
  __shared__ int32_t wv[2][32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  int32_t k[KEYS];
#pragma unroll
  for (int j = 0; j < KEYS; ++j) k[j] = key[j * blockDim.x + threadIdx.x];
  int32_t w = __reduce_min_sync(FULL, fold(k));
  if (lane == 0) wv[0][warp] = w;
  __syncthreads();
  int32_t acc = 0;
  const long long c0 = clock64();
  const unsigned long long t0 = now_ns();
  for (int e = 0; e < iters; ++e) {
    const int p = e & 1;
    if (MODE == 2 || MODE == 4) {
      if (MODE == 2 && warp == 0) {
#pragma unroll
        for (int j = 0; j < KEYS; ++j) k[j] = k[j] == w ? KI : k[j];
        w = __reduce_min_sync(FULL, fold(k));
      } else if (MODE == 4) {
        w = __reduce_min_sync(FULL, w ^ lane);
      }
      acc += w;
      continue;
    }
    int32_t m;
    if (MODE == 3)
      m = wv[p][lane < warps ? lane : 0];
    else
      m = __reduce_min_sync(FULL, lane < warps ? wv[p][lane] : KI);
    acc += m;
    if (threadIdx.x == 0) {
      if (MODE == 5) vals[e] = m;
      else sv[e & 511] = m;
    }
    if ((MODE == 0 || MODE == 5) && w == m) {
#pragma unroll
      for (int j = 0; j < KEYS; ++j) k[j] = k[j] == m ? KI : k[j];
      w = __reduce_min_sync(FULL, fold(k));
    }
    if ((MODE == 1 && w == m) || MODE == 3) w = m + 1;
    if (lane == 0) wv[p ^ 1][warp] = w;
    __syncthreads();
  }
  const unsigned long long t1 = now_ns();
  const long long c1 = clock64();
  if (threadIdx.x == 0) {
    out[0] = c1 - c0;
    out[1] = (long long)(t1 - t0);
  }
  sink[threadIdx.x] = acc + w + sv[threadIdx.x & 511];
}
}  // namespace

extern "C" int run_part(int mode, const void* key, int threads, int iters,
                        void* out, void* sink, void* vals, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int32_t* k = (const int32_t*)key;
  long long* o = (long long*)out;
  int32_t* s = (int32_t*)sink;
  int32_t* v = (int32_t*)vals;
  switch (mode) {
    case 0: part_kernel<0><<<1, threads, 0, st>>>(k, iters, o, s, v); break;
    case 1: part_kernel<1><<<1, threads, 0, st>>>(k, iters, o, s, v); break;
    case 2: part_kernel<2><<<1, threads, 0, st>>>(k, iters, o, s, v); break;
    case 3: part_kernel<3><<<1, threads, 0, st>>>(k, iters, o, s, v); break;
    case 4: part_kernel<4><<<1, threads, 0, st>>>(k, iters, o, s, v); break;
    case 5: part_kernel<5><<<1, threads, 0, st>>>(k, iters, o, s, v); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
"""

MODES = ("emission", "decision_barrier", "rescan", "barrier", "redux",
         "emission_store")
ITERS = 400          # the faithful cut emits 400 keys


def build(tmp: Path) -> ctypes.CDLL:
    from repro_torch.kernels import _build
    src, lib = tmp / "k4_emit_probe.cu", tmp / "k4_emit_probe.so"
    src.write_text(SOURCE)
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib),
                    str(src)], check=True, capture_output=True, text=True)
    cdll = ctypes.CDLL(str(lib))
    cdll.run_part.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
                              ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                              ctypes.c_void_p, ctypes.c_void_p]
    cdll.run_part.restype = ctypes.c_int
    return cdll


def events_ms(fn, reps: int) -> float:
    import torch
    fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("k4_emit_probe: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import insitu_search as isr
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip().splitlines()[0])
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream
    with tempfile.TemporaryDirectory() as tmp:
        cdll = build(Path(tmp))
        for threads in (32, 512, 1024):
            n = 16 * threads
            key = torch.randperm(1 << 24, generator=g, device=dev)[:n] \
                .to(torch.int32)
            out = torch.zeros(2, dtype=torch.int64, device=dev)
            sink = torch.empty(threads, dtype=torch.int32, device=dev)
            vals = torch.empty(ITERS, dtype=torch.int32, device=dev)
            for mode, name in enumerate(MODES):
                cyc, ns = [], []
                for _ in range(7):
                    err = cdll.run_part(mode, key.data_ptr(), threads, ITERS,
                                        out.data_ptr(), sink.data_ptr(),
                                        vals.data_ptr(), stream)
                    if err:
                        raise RuntimeError(f"run_part {name}: error {err}")
                    c, t = out.tolist()
                    cyc.append(c / ITERS)
                    ns.append(t / ITERS)
                print(json.dumps(dict(part=name, threads=threads, keys=n,
                                      rounds=ITERS,
                                      cycles_a_round=statistics.median(cyc),
                                      ns_a_round=statistics.median(ns))),
                      flush=True)
    key = torch.randperm(1 << 24, generator=g, device=dev)[:8192] \
        .to(torch.int32)
    for turn in range(3):
        t = {cap: events_ms(lambda: isr.faithful_emit(key, cap, counts=False),
                            50) for cap in (256, 512)}
        lib = events_ms(lambda: torch.unique(key, sorted=True), 50)
        print(json.dumps(dict(part="entry", turn=turn, keys=8192,
                              ms_cap256=t[256], ms_cap512=t[512],
                              ns_an_emission=(t[512] - t[256]) * 1e6 / 256,
                              unique_ms=lib)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
