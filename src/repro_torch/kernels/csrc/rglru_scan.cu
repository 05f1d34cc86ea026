// RG-LRU linear-recurrence scan for Hopper (sm_90a), bound through a plain C entry.
//
// Replaces the Pallas TPU kernel repro/kernels/rglru_scan.py (_rglru_kernel,
// launched by rglru_scan_fwd).  Same contract:
//   h_t = a_t * h_{t-1} + b_t over a, b [B,T,W] fp32 from h0 [B,W] fp32,
//   h [B,T,W] fp32.
//
// The TPU kernel cuts time into tiles of tb steps, runs a log-depth
// associative scan inside each [tb, wb] tile, folds the carry in with
// h_loc + cumprod(a) * h_in, and carries h between sequential grid steps in
// VMEM, padding time with a = 1, b = 0 to whole tiles.  Here one thread owns
// one (b, w) lane and walks T in order, one fma per step: no padding (a width
// tail is a bounds check), and a warp's 32 lanes are 32 consecutive w, so
// every load and store is one coalesced 128-byte line.
//
// What bounds it on an H100: 2 FLOP per element against 12 bytes (read a and
// b, write h), so memory.  At the serving shape (B 4, T 4096, W 4096) that is
// 805 MB, 0.24 ms at 3.35 TB/s.  The loads of a_t and b_t do not depend on h,
// so the time loop is unrolled by UNROLL steps with every load issued before
// the fmas: 2 * UNROLL loads in flight per thread.  That is the only source of
// memory parallelism, since there are only B * W lanes (16 384 at the serving
// shape, about one 128-thread block per SM).  A chunked form (a local scan per
// time chunk, then a carry pass) would add lanes; it is later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;
constexpr int UNROLL = 16;

__global__ void __launch_bounds__(THREADS)
rglru_scan_kernel(const float* __restrict__ a, const float* __restrict__ b,
                  const float* __restrict__ h0, float* __restrict__ h, int T, int W) {
  const int w = blockIdx.x * THREADS + threadIdx.x;
  if (w >= W) return;
  const int64_t lane = (int64_t)blockIdx.y * T * W + w;
  const float* ap = a + lane;
  const float* bp = b + lane;
  float* hp = h + lane;
  float carry = h0[(int64_t)blockIdx.y * W + w];
  int t = 0;
  for (; t + UNROLL <= T; t += UNROLL) {
    float av[UNROLL], bv[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int64_t off = (int64_t)(t + u) * W;
      av[u] = __ldcs(ap + off);  // read once: evict-first
      bv[u] = __ldcs(bp + off);
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      carry = fmaf(av[u], carry, bv[u]);
      __stcs(hp + (int64_t)(t + u) * W, carry);
    }
  }
  for (; t < T; ++t) {
    const int64_t off = (int64_t)t * W;
    carry = fmaf(__ldcs(ap + off), carry, __ldcs(bp + off));
    __stcs(hp + off, carry);
  }
}

}  // namespace

// Returns the cudaError_t of the launch (0 on success).  The caller has
// checked shapes, fp32, contiguity and that every pointer lives on the
// current device.
extern "C" int rglru_scan_fwd(const float* a, const float* b, const float* h0, float* h,
                              int B, int T, int W, void* stream) {
  cudaGetLastError();  // report this launch's error, not an earlier one's
  dim3 grid((W + THREADS - 1) / THREADS, B);
  rglru_scan_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      a, b, h0, h, T, W);
  return (int)cudaGetLastError();
}
