// RG-LRU linear-recurrence scan for Hopper (sm_90a), forward and backward,
// bound through plain C entries (rglru_scan_fwd, rglru_scan_bwd).
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
// one (b, w) lane and walks T in order, one fma per step (carry =
// fmaf(a_t, carry, b_t)): no padding, no carry pass, and a warp's lanes are
// consecutive w, so every row it reads or writes is one coalesced line.
//
// The backward replaces the cotangent of the reference's custom_vjp
// (repro/kernels/ops.py, _rg_bwd: the vjp of the lax.scan oracle).  Given
// g = dL/dh [B,T,W] fp32 and the forward's h, with h_{-1} = h0, it is the
// same recurrence run backwards in time:
//   dh_t = g_t + a_{t+1} dh_{t+1}  (dh_{T-1} = g_{T-1}),
//   da_t = dh_t h_{t-1},  db_t = dh_t,  dh0 = a_0 dh_0.
// The thread carries c = a_{t+1} dh_{t+1} (0 above the last step): each step
// is dh = g_t + c; db_t = dh; da_t = dh h_{t-1}; c = a_t dh, walking t from
// T-1 down to 0, and dh0 is the carry left after t = 0.  b is never read.
// Each product and sum is rounded on its own (__fmul_rn, __fadd_rn: the
// compiler may not fuse c = a dh into the next step's add), as the plain
// version rounds them, so both variants give the same bits.  No atomics, so
// a run repeats bit for bit.
//
// What bounds both on an H100: memory.  The forward moves 12 bytes per
// element (read a and b, write h) for 2 FLOP, the backward 20 (read g, a, h;
// write da, db) for 3.  At recurrentgemma-9b's training shape (B 1, T 4096,
// W 4096) that is 201 MB and 336 MB, 0.0601 and 0.1002 ms at 3.35 TB/s; at
// its prefill shape (B 4) four times that.  The loads do not depend on the
// carry, so the whole problem is keeping enough bytes in flight: 3.35 TB/s
// times a loaded DRAM latency near 0.7 us is 2-3 MB across the card, and B 1
// gives only 4096 lanes to carry them.
//
// Two variants of each direction, chosen by the caller
// (kernels/rglru_scan.py::variant, the one place that states the rule):
//  * rglru_scan_tma / rglru_scan_bwd_tma ("tma"), for every shape the TMA
//    can address: W a multiple of 4 (rows of 16-byte multiples) and 16-byte
//    aligned inputs.  One block owns a column of LANES = 32 lanes of one
//    batch row and walks the whole of T.  Warp 1's lane 0 is the producer:
//    it keeps a ring of stages of ROWS = 64 time steps in shared memory in
//    flight, one 3-D TMA box (LANES, ROWS, 1) per input over the tensor
//    [B, T, W], each stage completed on a "full" mbarrier by its byte
//    count.  Warp 0 consumes: each lane copies its column of a stage into
//    registers (a conflict-free 128-byte row per step), hands the stage back
//    on an "empty" mbarrier, and only then runs the stage's steps.  The ring
//    never drains while a column has steps left, so the bytes in flight are
//    set by the ring and not by the lanes.  Its depth is fixed:
//    FWD_STAGES = 3 stages of 16 KB (a, b) and BWD_STAGES = 2 of 24 KB (g,
//    a, h), 48 KB a block either way, so up to four blocks share an SM's
//    228 KB at B 4 (512 blocks on 132 SMs), and at B 1 (128 blocks) an SM
//    holds one.  The carry never leaves a register, so the bytes stay at
//    the bound.  The TMA zero-fills rows past T (the consumer stops at T)
//    and columns past W (those lanes store nothing).  The backward loads
//    its stages last-first: stage k holds rows r0 = T - (k+1) ROWS ..
//    r0 + ROWS - 1 of g and a, and h through a box that starts one row
//    earlier (h_{t-1}); rows before 0 read as zero, and t = 0 takes h0.
//    Outputs go straight from registers with __stcs, one 128-byte line per
//    warp and step.
//    Alternatives tried on an H100 and dropped (PERF.md has the readings):
//    32-step stages with 64 KB rings (slower at B 1 and B 4), 96 KB rings
//    (slower at B 1), a 256-byte L2 promotion (about 4 % slower at B 4) and
//    16-lane columns (more blocks: about 10 % slower at B 1 / W 4096, mixed
//    at W 2048).  Staging each stage's outputs in shared memory for TMA
//    stores: of two probes, one read it faster at B 1 and B 4, the other
//    read the forward slower at B 1, so no clear gain; it costs a second
//    ring, proxy fences and a store-side rule (a store's box may not start
//    at a negative row, which the backward's last-first stages would need),
//    so outputs stay in registers.
//  * rglru_scan_kernel / rglru_scan_bwd_kernel ("lane"), for the rest (W %
//    4 != 0, or an input off 16-byte alignment): one thread per lane with
//    loads issued UNROLL (BWD_UNROLL) steps ahead into registers, the only
//    place they keep bytes in flight (about 0.5 MB at B 1).  The same
//    arithmetic in the same order and roundings: the forward's h equals the
//    tma variant's bit for bit, and so do the backward's outputs.

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// ------------------------------------------------------------ lane variant --
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
      const float dh = __fadd_rn(gv[u], carry);
      __stcs(dbp + off, dh);
      __stcs(dap + off, __fmul_rn(dh, hv[u]));
      carry = __fmul_rn(av[u], dh);
    }
  }
  for (; t >= 0; --t) {
    const int64_t off = (int64_t)t * W;
    const float dh = __fadd_rn(__ldcs(gp + off), carry);
    __stcs(dbp + off, dh);
    __stcs(dap + off, __fmul_rn(dh, __ldcs(t > 0 ? hp + off - W : h0p)));
    carry = __fmul_rn(__ldcs(ap + off), dh);
  }
  dh0[(int64_t)blockIdx.y * W + w] = carry;  // a_0 dh_0; 0 when T = 0
}

// ------------------------------------------------------------- tma variant --
constexpr int LANES = 32;         // lanes a block owns: one 128-byte row per input and step
constexpr int ROWS = 64;          // time steps per stage (kernels/rglru_scan.py::ROWS)
constexpr int FWD_STAGES = 3;     // the forward's ring: 3 x 16 KB
constexpr int BWD_STAGES = 2;     // the backward's ring: 2 x 24 KB
constexpr int TMA_THREADS = 64;   // warp 0 consumes, warp 1's lane 0 loads
constexpr uint32_t BOX = ROWS * LANES * 4;  // bytes of one input's box

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// Wait until the phase of the given parity has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// Box (c0 .. c0+LANES-1, c1 .. c1+ROWS-1, c2) of a rank-3 map (W, T, B)
// into shared memory, completing on bar.  Coordinates outside the tensor,
// also negative ones, read as zero.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// Shared memory of a block: STAGES stages of NIN boxes of [ROWS][LANES]
// floats, then a full and an empty mbarrier per stage.
template <int NIN, int STAGES>
constexpr size_t ring_smem() { return (size_t)STAGES * (NIN * BOX + 16); }

// A block's mbarriers: the producer's one arrival (with the stage's byte
// count) completes a full barrier, the consumer's lane 0 an empty one.
template <int STAGES>
__device__ __forceinline__ void init_ring(uint32_t full, uint32_t empty) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
}

// The producer: stage k of n into slot k % STAGES once the consumer has
// handed back that slot's previous use, rows from row0(k) (and the last
// input's box from row0(k) + shift), each box of one input map.
template <int NIN, int STAGES, typename Row>
__device__ __forceinline__ void produce(const CUtensorMap* const (&maps)[NIN], uint32_t ring,
                                        uint32_t full, uint32_t empty, int n, int col, int bat,
                                        int shift, Row row0) {
  for (int k = 0, s = 0, use = 0; k < n; ++k) {
    if (use > 0) mbar_wait(empty + 8 * s, (use - 1) & 1);
    mbar_expect_tx(full + 8 * s, NIN * BOX);
    const uint32_t dst = ring + s * NIN * BOX;
    const int r = row0(k);
#pragma unroll
    for (int i = 0; i < NIN; ++i)
      tma_load(dst + i * BOX, maps[i], full + 8 * s, col, i == NIN - 1 ? r + shift : r, bat);
    if (++s == STAGES) s = 0, ++use;
  }
}

__global__ void __launch_bounds__(TMA_THREADS)
rglru_scan_tma(const __grid_constant__ CUtensorMap ta, const __grid_constant__ CUtensorMap tb,
               const float* __restrict__ h0, float* __restrict__ h, int T, int W) {
  constexpr int STAGES = FWD_STAGES, STAGE = 2 * BOX / 4;  // floats of a stage
  extern __shared__ __align__(128) unsigned char smem[];
  const float* ring = reinterpret_cast<const float*>(smem);
  const uint32_t full = smem_u32(ring + (size_t)STAGES * STAGE), empty = full + 8 * STAGES;
  const int col = blockIdx.x * LANES, bat = blockIdx.y, n = (T + ROWS - 1) / ROWS;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  init_ring<STAGES>(full, empty);

  if (warp == 1) {
    if (lane == 0) {
      const CUtensorMap* const maps[2] = {&ta, &tb};
      produce<2, STAGES>(maps, smem_u32(smem), full, empty, n, col, bat, 0,
                 [](int k) { return k * ROWS; });
    }
    return;
  }

  const int w = col + lane;
  const bool live = w < W;
  float carry = live ? h0[(int64_t)bat * W + w] : 0.f;
  float* hp = h + (int64_t)bat * T * W + w;
  for (int k = 0, s = 0, use = 0; k < n; ++k) {
    mbar_wait(full + 8 * s, use & 1);
    const float* as = ring + (size_t)s * STAGE + lane;
    const float* bs = as + BOX / 4;
    const int rows = T - k * ROWS;
    if (rows >= ROWS) {
      float av[ROWS], bv[ROWS];
#pragma unroll
      for (int u = 0; u < ROWS; ++u) {
        av[u] = as[u * LANES];
        bv[u] = bs[u * LANES];
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + 8 * s);
#pragma unroll
      for (int u = 0; u < ROWS; ++u) {
        carry = fmaf(av[u], carry, bv[u]);
        if (live) __stcs(hp, carry);
        hp += W;
      }
    } else {  // the last stage: rows past T are the TMA's zero fill
      for (int u = 0; u < rows; ++u) {
        carry = fmaf(as[u * LANES], carry, bs[u * LANES]);
        if (live) __stcs(hp, carry);
        hp += W;
      }
    }
    if (++s == STAGES) s = 0, ++use;
  }
}

__global__ void __launch_bounds__(TMA_THREADS)
rglru_scan_bwd_tma(const __grid_constant__ CUtensorMap tg, const __grid_constant__ CUtensorMap ta,
                   const __grid_constant__ CUtensorMap th, const float* __restrict__ h0,
                   float* __restrict__ da, float* __restrict__ db, float* __restrict__ dh0,
                   int T, int W) {
  constexpr int STAGES = BWD_STAGES, STAGE = 3 * BOX / 4;
  extern __shared__ __align__(128) unsigned char smem[];
  const float* ring = reinterpret_cast<const float*>(smem);
  const uint32_t full = smem_u32(ring + (size_t)STAGES * STAGE), empty = full + 8 * STAGES;
  const int col = blockIdx.x * LANES, bat = blockIdx.y, n = (T + ROWS - 1) / ROWS;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  init_ring<STAGES>(full, empty);

  if (warp == 1) {
    if (lane == 0) {  // g and a from row r0, h from r0 - 1 (h_{t-1})
      const CUtensorMap* const maps[3] = {&tg, &ta, &th};
      produce<3, STAGES>(maps, smem_u32(smem), full, empty, n, col, bat, -1,
                 [T](int k) { return T - (k + 1) * ROWS; });
    }
    return;
  }

  const int w = col + lane;
  const bool live = w < W;
  const float hfirst = live ? h0[(int64_t)bat * W + w] : 0.f;  // h_{-1}
  const int64_t base = (int64_t)bat * T * W + w;
  float carry = 0.f;  // a_{t+1} dh_{t+1}
  for (int k = 0, s = 0, use = 0; k < n; ++k) {
    mbar_wait(full + 8 * s, use & 1);
    const float* gs = ring + (size_t)s * STAGE + lane;
    const float* as = gs + BOX / 4;
    const float* hs = as + BOX / 4;
    const int r0 = T - (k + 1) * ROWS;
    float* dap = da + base + (int64_t)(r0 + ROWS - 1) * W;  // step r0 + ROWS - 1 first
    float* dbp = db + base + (int64_t)(r0 + ROWS - 1) * W;
    if (r0 > 0) {  // every step has its h_{t-1} in the stage
      float gv[ROWS], av[ROWS], hv[ROWS];
#pragma unroll
      for (int u = 0; u < ROWS; ++u) {
        gv[u] = gs[u * LANES];
        av[u] = as[u * LANES];
        hv[u] = hs[u * LANES];
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + 8 * s);
#pragma unroll
      for (int u = ROWS - 1; u >= 0; --u) {
        const float dh = __fadd_rn(gv[u], carry);
        if (live) {
          __stcs(dbp, dh);
          __stcs(dap, __fmul_rn(dh, hv[u]));
        }
        carry = __fmul_rn(av[u], dh);
        dap -= W;
        dbp -= W;
      }
    } else {  // the last stage: rows before 0 are the TMA's zero fill, t = 0 takes h0
      for (int u = ROWS - 1; u >= -r0; --u) {
        const float dh = __fadd_rn(gs[u * LANES], carry);
        if (live) {
          __stcs(dbp, dh);
          __stcs(dap, __fmul_rn(dh, r0 + u > 0 ? hs[u * LANES] : hfirst));
        }
        carry = __fmul_rn(as[u * LANES], dh);
        dap -= W;
        dbp -= W;
      }
    }
    if (++s == STAGES) s = 0, ++use;
  }
  if (live) dh0[(int64_t)bat * W + w] = carry;  // a_0 dh_0
}

// cuTensorMapEncodeTiled lives in libcuda, not in the CUDA runtime.  It is
// fetched through the runtime's entry-point query, so the library links
// against nothing beyond the runtime that nvcc links anyway (no -lcuda).
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &ptr, 12000,
                                                       cudaEnableDefault, &found);
#else
    cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess) fn = (EncodeTiledFn)ptr;
  }
  return fn;
}

// Rank-3 map of a contiguous fp32 [B, T, W] tensor, innermost first (W, T,
// B); box (LANES, ROWS, 1), no swizzle, reads outside the tensor
// zero-filled, L2 promotion to 128 bytes (a block's row; 256 measured
// slower at B 4).  Returns 0 or the CUresult of the encoding.
int make_map(CUtensorMap* map, const float* ptr, int B, int T, int W) {
  EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return (int)CUDA_ERROR_NOT_FOUND;
  const cuuint64_t dims[3] = {(cuuint64_t)W, (cuuint64_t)T, (cuuint64_t)B};
  const cuuint64_t strides[2] = {(cuuint64_t)W * 4, (cuuint64_t)T * W * 4};
  const cuuint32_t box[3] = {(cuuint32_t)LANES, (cuuint32_t)ROWS, 1};
  const cuuint32_t elem_strides[3] = {1, 1, 1};
  return (int)encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<float*>(ptr), dims,
                     strides, box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
                     CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                     CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

// Whether the tma variant takes these inputs (kernels/rglru_scan.py::variant
// states the same rule).
bool tma_takes(const float* const* xs, int nx, int T, int W) {
  uintptr_t addr = 0;
  for (int i = 0; i < nx; ++i) addr |= (uintptr_t)xs[i];
  return addr % 16 == 0 && W % 4 == 0 && T <= INT32_MAX - 2 * ROWS &&
         (uint64_t)T * (uint64_t)W * 4 < (1ull << 40);
}

// One map per input, then the launch: a block per column of LANES lanes and
// batch row, with a ring of STAGES stages.
template <int NIN, int STAGES, typename Kernel, typename... Args>
int launch_tma(Kernel kernel, const float* const (&xs)[NIN], int B, int T, int W,
               cudaStream_t stream, Args... args) {
  CUtensorMap maps[NIN];
  for (int i = 0; i < NIN; ++i) {
    const int r = make_map(&maps[i], xs[i], B, T, W);
    if (r != 0) return -r;
  }
  constexpr size_t smem = ring_smem<NIN, STAGES>();
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((W + LANES - 1) / LANES, B);
  if constexpr (NIN == 2)
    kernel<<<grid, TMA_THREADS, smem, stream>>>(maps[0], maps[1], args..., T, W);
  else
    kernel<<<grid, TMA_THREADS, smem, stream>>>(maps[0], maps[1], maps[2], args..., T, W);
  return (int)cudaGetLastError();
}

}  // namespace

// variant: 0 = lane, 1 = tma, as kernels/rglru_scan.py::variant chose it.
// A tma request that breaks the rule (W % 4, a or b off 16-byte alignment,
// T or T W past the tensor map's limits) is refused
// (cudaErrorInvalidValue), never sent to the other variant.
// Returns the cudaError_t of the launch (0 on success), or minus the
// CUresult of a tensor map that could not be encoded.  The caller has
// checked shapes, fp32, contiguity and that every pointer lives on the
// current device.
extern "C" int rglru_scan_fwd(const float* a, const float* b, const float* h0, float* h,
                              int B, int T, int W, int variant, void* stream) {
  cudaGetLastError();  // report this launch's error, not an earlier one's
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (variant == 1) {
    const float* const xs[2] = {a, b};
    if (!tma_takes(xs, 2, T, W)) return (int)cudaErrorInvalidValue;
    return launch_tma<2, FWD_STAGES>(rglru_scan_tma, xs, B, T, W, st, h0, h);
  }
  if (variant != 0) return (int)cudaErrorInvalidValue;
  dim3 grid((W + THREADS - 1) / THREADS, B);
  rglru_scan_kernel<<<grid, THREADS, 0, st>>>(a, b, h0, h, T, W);
  return (int)cudaGetLastError();
}

// The backward: da, db [B,T,W] and dh0 [B,W] from a, the forward's h, h0 and
// g = dL/dh.  variant and the return value as for rglru_scan_fwd;
// the tma rule holds for a, h and g.
extern "C" int rglru_scan_bwd(const float* a, const float* h, const float* h0, const float* g,
                              float* da, float* db, float* dh0, int B, int T, int W,
                              int variant, void* stream) {
  cudaGetLastError();
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (variant == 1) {
    const float* const xs[3] = {g, a, h};
    if (!tma_takes(xs, 3, T, W)) return (int)cudaErrorInvalidValue;
    return launch_tma<3, BWD_STAGES>(rglru_scan_bwd_tma, xs, B, T, W, st, h0, da, db, dh0);
  }
  if (variant != 0) return (int)cudaErrorInvalidValue;
  dim3 grid((W + BWD_THREADS - 1) / BWD_THREADS, B);
  rglru_scan_bwd_kernel<<<grid, BWD_THREADS, 0, st>>>(a, h, h0, g, da, db, dh0, T, W);
  return (int)cudaGetLastError();
}
