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
//
// The backward, rglru_scan_bwd_kernel, replaces the cotangent of the
// reference's custom_vjp (repro/kernels/ops.py, _rg_bwd: the vjp of the
// lax.scan oracle).  Given g = dL/dh [B,T,W] fp32 and the forward's h, with
// h_{-1} = h0, it is the same recurrence run backwards in time:
//   dh_t = g_t + a_{t+1} dh_{t+1}  (dh_{T-1} = g_{T-1}),
//   da_t = dh_t h_{t-1},  db_t = dh_t,  dh0 = a_0 dh_0.
// The thread carries c = a_{t+1} dh_{t+1} (0 above the last step), so each
// step reads g_t, a_t and h_{t-1} of its own index, and dh0 is the carry left
// after t = 0.  b is never read.  One thread per (b, w) lane walks t from T-1
// down to 0; no atomics, so a run repeats bit for bit.
//
// What bounds it: 20 bytes per element (read g, a, h; write da, db) against
// 3 FLOP (an add, two multiplies), so memory: at recurrentgemma-9b's training shape (B 1, T 4096,
// W 4096) 335.5 MB, 0.1002 ms at 3.35 TB/s.  The loads do not depend on the
// carry, so they are issued BWD_UNROLL steps ahead, 3 * BWD_UNROLL per
// thread.  B 1 gives only 4096 lanes, so blocks are one warp (128 blocks on
// 132 SMs at W 4096, where 128-thread blocks would fill 32) and the unroll is
// twice the forward's, to keep more bytes in flight per lane.

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

constexpr int BWD_THREADS = 32;
constexpr int BWD_UNROLL = 32;

__global__ void __launch_bounds__(BWD_THREADS)
rglru_scan_bwd_kernel(const float* __restrict__ a, const float* __restrict__ h,
                      const float* __restrict__ h0, const float* __restrict__ g,
                      float* __restrict__ da, float* __restrict__ db,
                      float* __restrict__ dh0, int T, int W) {
  const int w = blockIdx.x * BWD_THREADS + threadIdx.x;
  if (w >= W) return;
  const int64_t lane = (int64_t)blockIdx.y * T * W + w;
  const float* ap = a + lane;
  const float* hp = h + lane;
  const float* gp = g + lane;
  float* dap = da + lane;
  float* dbp = db + lane;
  const float* h0p = h0 + (int64_t)blockIdx.y * W + w;
  float carry = 0.f;  // a_{t+1} dh_{t+1}
  int t = T - 1;
  for (; t + 1 >= BWD_UNROLL; t -= BWD_UNROLL) {  // steps t, t-1, ..., t-BWD_UNROLL+1
    float av[BWD_UNROLL], gv[BWD_UNROLL], hv[BWD_UNROLL];
#pragma unroll
    for (int u = 0; u < BWD_UNROLL; ++u) {
      const int s = t - u;
      const int64_t off = (int64_t)s * W;
      av[u] = __ldcs(ap + off);  // read once: evict-first
      gv[u] = __ldcs(gp + off);
      hv[u] = __ldcs(s > 0 ? hp + off - W : h0p);  // h_{s-1}; h0 at s = 0
    }
#pragma unroll
    for (int u = 0; u < BWD_UNROLL; ++u) {
      const int64_t off = (int64_t)(t - u) * W;
      const float dh = gv[u] + carry;
      __stcs(dbp + off, dh);
      __stcs(dap + off, dh * hv[u]);
      carry = av[u] * dh;
    }
  }
  for (; t >= 0; --t) {
    const int64_t off = (int64_t)t * W;
    const float dh = __ldcs(gp + off) + carry;
    __stcs(dbp + off, dh);
    __stcs(dap + off, dh * __ldcs(t > 0 ? hp + off - W : h0p));
    carry = __ldcs(ap + off) * dh;
  }
  dh0[(int64_t)blockIdx.y * W + w] = carry;  // a_0 dh_0; 0 when T = 0
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

// The backward: da, db [B,T,W] and dh0 [B,W] from a, the forward's h, h0 and
// g = dL/dh.  Returns the cudaError_t of the launch (0 on success), under the
// same contract as rglru_scan_fwd.
extern "C" int rglru_scan_bwd(const float* a, const float* h, const float* h0, const float* g,
                              float* da, float* db, float* dh0, int B, int T, int W,
                              void* stream) {
  cudaGetLastError();
  dim3 grid((W + BWD_THREADS - 1) / BWD_THREADS, B);
  rglru_scan_bwd_kernel<<<grid, BWD_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      a, h, h0, g, da, db, dh0, T, W);
  return (int)cudaGetLastError();
}
