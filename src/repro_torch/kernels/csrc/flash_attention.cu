// Flash attention for Hopper (sm_90a), forward and backward, bound through
// plain C entries (flash_attention_fwd, flash_attention_bwd).
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attention.py
// (_flash_kernel, launched by flash_attention_fwd).  Same contract:
//   q [B,Tq,H,dk], k [B,Tk,K,dk], v [B,Tk,K,dv] -> o [B,Tq,H,dv] in v's dtype,
//   query head h reads KV head h / (H/K) (repeated KV is never materialised),
//   masks: causal k <= q, window k > q - window, tail padding on both axes,
//   fp32 running max / sum / accumulator, o = acc / max(l, 1e-30).
//
// The TPU kernel walks KV blocks on a sequential grid axis and carries
// (m, l, acc) in VMEM scratch between grid steps.  Blocks on a GPU run in no
// order, so here the KV walk is a loop inside the block: one block owns a
// tile of query rows of one (b, h) and keeps (m, l, acc) on chip for the
// whole walk.  KV tiles wholly above the causal diagonal or wholly below the
// window are never visited, and masked scores are -inf with an explicit
// guard, so a fully masked tile neither costs work nor adds the exp(0) terms
// the TPU kernel later cancels.
//
// Two variants, chosen by the caller (kernels/flash_attention.py::variant):
//  * flash_fwd_wgmma<DK, DV>: bf16 with dk, dv multiples of 8 up to 256
//    and 16-byte aligned pointers, every serving shape.  DK covers dk (q and
//    k), DV covers dv (v and o), as kernels/flash_attention.py::widths
//    names them: (64, 64), (128, 128) and (256, 256), the smallest that
//    covers max(dk, dv), and (192, 128) for 128 < dk <= 192 with dv <= 128
//    (MLA's 192 / 128).  BK keys per KV tile (128 at (64, 64) and
//    (128, 128), 64 at (256, 256), where O's accumulator takes 128
//    registers a thread, and at (192, 128), see WgmmaTile), NS
//    shared-memory stages (4, 3, 2, and 4 at (192, 128)), for 148624,
//    230512, 197712 and 214160 B of dynamic shared memory
//    (WgmmaTile::SMEM).  At (192, 128) Q and K span three swizzle atoms and
//    V two, O is m64n128 (64 registers, half of (256, 256)'s), and four
//    stages of K (24 KB) and V (16 KB) lie beside Q (48 KB); its walk is
//    head-major (see flash_fwd_wgmma).  One
//    persistent block per SM walks work tiles of 128 query rows of one
//    (b, h), heaviest causal tiles first, with three warpgroups:
//      - a producer (warps 8-11, 24 registers after setmaxnreg), one thread
//        of which issues TMA loads: Q once per work tile, K and V tiles into
//        a ring of NS stages, each completed on its own mbarrier;
//      - two consumers (warps 0-7, 240 registers), 64 query rows each, that
//        run S = Q K^T on wgmma (A = Q, B = K, both K-major in shared memory),
//        the online softmax on the S accumulator in registers, and
//        O += P V on wgmma with P from registers (the S accumulator repacked
//        to bf16 A fragments) and V from shared memory (MN-major, transposed
//        by the descriptor).  K and V of a stage are released separately on
//        "empty" mbarriers, Q once a work tile's last S is done.
//    Each consumer issues S of tile i together with P V of tile i - 1 and
//    runs the softmax of tile i while that P V is still on the tensor cores;
//    the two consumers take turns to issue (named barriers), so that one's
//    softmax overlaps the other's products.
//    Every operand tile lies in shared memory as DK/64 (q, k) or DV/64 (v)
//    boxes of [rows][64] bf16 under the 128-byte swizzle, one swizzle atom
//    column each, as the TMA writes them (box (64, 1, rows, 1) of a rank-4
//    map (d, heads, T, B)).  The TMA zero-fills rows past T and columns past
//    dk or dv, so tail padding and head dims below DK or DV cost no code
//    (but the products still run DK and DV wide).
//  * flash_fwd_simt<T>: fp32 (exact fp32 arithmetic, as the reference), and
//    any bf16 shape the TMA cannot take (a head dim that is no multiple of
//    8, or a misaligned pointer).  CUDA-core dot products, 32x32 tiles,
//    8 threads per query row.
//
// The forward's lse.  With a non-null Params::lse, both variants write each
// row's log-sum-exp, fp32 [B, H, Tq], in natural-log units of the scaled
// scores over the keys the mask leaves: lse = log sum_k exp(scale q.k).  The
// wgmma variant keeps its running max m in scaled base-2 units (S scale log2e)
// and writes (m + log2 l) ln 2; the simt variant, m + ln l.  A row with no
// unmasked key keeps m = -inf and gets lse = -inf (the backward then gives it
// P = 0).  Serving passes null and writes nothing.
//
// The backward (second half of this file, with its own headers): the
// flash-backward equations from the saved output and lse, on the tensor
// cores for every bf16 shape the forward's wgmma rule takes, and
// flash_bwd_simt<T> for fp32 and every other shape, as
// kernels/flash_attention.py::variant chooses, at the widths ::widths
// names.  At (64, 64) and (128, 128), flash_bwd_wgmma<D> is warp-specialised
// like the forward: a TMA loader, a dQ writer that adds finished dQ tiles
// into fp32 sums by TMA reductions, and two consumer warpgroups of 64 keys
// each that meet only through mbarriers, the dQ of each query tile computed
// by one of them in turn.  Past them two kernels split the work with no
// atomics, flash_bwd_wgmma_dkdv<DK, DV> (dK and dV, the GQA group split
// across blocks) and flash_bwd_wgmma_dq<DK, DV> (dQ, S and dP recomputed):
// at (256, 256) 64 keys or queries a block with the head dim split across
// the two consumers; at (192, 128), MLA's widths, 128 a block, each
// consumer holding whole rows of 64 keys or queries (dK 96 and dV 64
// registers, or dQ 96).  The reference has no backward kernel: its
// custom_vjp (repro/kernels/ops.py) takes the vjp of its quadratic oracle,
// which this computes up to rounding.
//
// What bounds it on an H100: at both serving shapes attention does several
// hundred FLOP per byte of q/k/v/o (llama3.2-1b, d 64: 34.4 GFLOP against
// 84 MB; recurrentgemma-9b, d 256, window 2048: 412 GFLOP against 285 MB),
// above the card's ~295 FLOP/byte ridge, so the tensor cores bound it.  The
// wgmma variant keeps them fed: loads are asynchronous and run ahead of the
// math by up to NS tiles and across work tiles, the softmax overlaps the
// products, and no thread spends registers or instructions on address
// arithmetic for the copies.  At d 64 the softmax's exponentials (one
// MUFU.EX2 per score) take as long as the products; at d 256 the products
// dominate.  Later work: one block for all q heads of an MQA KV head, and
// three consumer warpgroups at d 64.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* lse;  // [B, H, Tq] or null: each row's log-sum-exp (see the header)
  int B, Tq, Tk, H, K, dk, dv;
  int causal, window;
  float scale;
};

__device__ __forceinline__ bool masked(const Params& p, int qpos, int kpos) {
  return kpos >= p.Tk || (p.causal && kpos > qpos) ||
         (p.window > 0 && kpos <= qpos - p.window);
}

// KV tiles [lo, hi) that hold at least one unmasked key for a query tile
// starting at q0.  The loosest causal bound is the tile's last row, the
// loosest window bound its first row.  In the wgmma variant the producer and
// both consumers call it with the same arguments: the barrier phases of
// every stage follow from this range, so they must agree on it.
__device__ __forceinline__ void kv_tiles(const Params& p, int q0, int bq, int bk,
                                         int& lo, int& hi) {
  int k_end = p.Tk;
  if (p.causal) k_end = min(k_end, min(q0 + bq, p.Tq));
  int k_begin = p.window > 0 ? max(0, q0 - p.window + 1) : 0;
  lo = k_begin / bk;
  hi = (k_end + bk - 1) / bk;
}

// ----------------------------------------------------------- SIMT variant --
constexpr int S_BQ = 32, S_BK = 32, S_THREADS = 256;  // 8 threads per row

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store_f(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

size_t simt_smem_bytes(int dk, int dv) {
  return sizeof(float) * ((size_t)(S_BQ + S_BK) * (dk + 1) + (size_t)S_BK * dv +
                          (size_t)S_BQ * (S_BK + 1) + (size_t)S_BQ * dv);
}

template <typename T>
__global__ void __launch_bounds__(S_THREADS) flash_fwd_simt(Params p) {
  extern __shared__ float smem[];
  const int dk = p.dk, dv = p.dv, ldk = dk + 1;  // +1: conflict-free row reads
  float* Qs = smem;                      // [S_BQ][ldk]
  float* Ks = Qs + S_BQ * ldk;           // [S_BK][ldk]
  float* Vs = Ks + S_BK * ldk;           // [S_BK][dv]
  float* Ps = Vs + S_BK * dv;            // [S_BQ][S_BK + 1]
  float* Acc = Ps + S_BQ * (S_BK + 1);   // [S_BQ][dv]

  const int q0 = (gridDim.y - 1 - blockIdx.y) * S_BQ;  // heaviest causal tiles first
  const int b = blockIdx.x / p.H, h = blockIdx.x % p.H;
  const int kh = h / (p.H / p.K);
  const int tid = threadIdx.x, row = tid >> 3, lane8 = tid & 7;
  const T* q = static_cast<const T*>(p.q);
  const T* k = static_cast<const T*>(p.k);
  const T* v = static_cast<const T*>(p.v);
  T* o = static_cast<T*>(p.o);

  for (int i = tid; i < S_BQ * dk; i += S_THREADS) {
    const int r = i / dk, c = i % dk, t = q0 + r;
    Qs[r * ldk + c] = t < p.Tq ? to_f(q[((int64_t)(b * p.Tq + t) * p.H + h) * dk + c]) : 0.f;
  }
  for (int i = tid; i < S_BQ * dv; i += S_THREADS) Acc[i] = 0.f;

  const int qpos = q0 + row;
  float m = -INFINITY, l = 0.f;
  int kt_lo, kt_hi;
  kv_tiles(p, q0, S_BQ, S_BK, kt_lo, kt_hi);
  for (int kt = kt_lo; kt < kt_hi; ++kt) {
    const int k0 = kt * S_BK;
    __syncthreads();  // the previous tile's readers are done
    for (int i = tid; i < S_BK * dk; i += S_THREADS) {
      const int r = i / dk, c = i % dk, t = k0 + r;
      Ks[r * ldk + c] = t < p.Tk ? to_f(k[((int64_t)(b * p.Tk + t) * p.K + kh) * dk + c]) : 0.f;
    }
    for (int i = tid; i < S_BK * dv; i += S_THREADS) {
      const int r = i / dv, c = i % dv, t = k0 + r;
      Vs[i] = t < p.Tk ? to_f(v[((int64_t)(b * p.Tk + t) * p.K + kh) * dv + c]) : 0.f;
    }
    __syncthreads();

    float s[S_BK / 8];
    float mx = -INFINITY;
#pragma unroll
    for (int jj = 0; jj < S_BK / 8; ++jj) {
      const int j = lane8 + jj * 8;
      float acc = 0.f;
      for (int c = 0; c < dk; ++c) acc = fmaf(Qs[row * ldk + c], Ks[j * ldk + c], acc);
      acc *= p.scale;
      if (masked(p, qpos, k0 + j)) acc = -INFINITY;
      s[jj] = acc;
      mx = fmaxf(mx, acc);
    }
#pragma unroll
    for (int off = 1; off < 8; off <<= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    const float m_new = fmaxf(m, mx);
    const bool none = m_new == -INFINITY;  // no valid key for this row yet
    const float corr = none ? 1.f : expf(m - m_new);
    float sum = 0.f;
#pragma unroll
    for (int jj = 0; jj < S_BK / 8; ++jj) {
      const float pj = none ? 0.f : expf(s[jj] - m_new);
      Ps[row * (S_BK + 1) + lane8 + jj * 8] = pj;
      sum += pj;
    }
#pragma unroll
    for (int off = 1; off < 8; off <<= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
    l = l * corr + sum;
    m = m_new;
    __syncwarp();  // a row's 8 threads share one warp: make its P visible
    for (int c = lane8; c < dv; c += 8) {
      float a = Acc[row * dv + c] * corr;
      for (int j = 0; j < S_BK; ++j) a = fmaf(Ps[row * (S_BK + 1) + j], Vs[j * dv + c], a);
      Acc[row * dv + c] = a;
    }
  }
  if (qpos < p.Tq) {
    if (p.lse != nullptr && lane8 == 0)
      p.lse[((int64_t)b * p.H + h) * p.Tq + qpos] = m == -INFINITY ? -INFINITY : m + logf(l);
    const float denom = fmaxf(l, 1e-30f);
    for (int c = lane8; c < dv; c += 8)
      store_f(o + ((int64_t)(b * p.Tq + qpos) * p.H + h) * dv + c, Acc[row * dv + c] / denom);
  }
}

// ---------------------------------------------------------- wgmma variant --
constexpr int W_BQ = 128;                 // query rows per block: 2 consumer warpgroups
constexpr int W_THREADS = 384;            // + 1 producer warpgroup
constexpr int W_ATOM = 64;                // bf16 columns of one 128-byte swizzle atom
constexpr int W_PRODUCER_REGS = 24, W_CONSUMER_REGS = 240;

// Widths DK (q and k) and DV (v and o) of an instantiation: (64, 64),
// (128, 128), (192, 128) or (256, 256).  BK keys per KV tile, NS
// shared-memory stages.  The O accumulator takes DV / 2 registers a thread
// and the S accumulator BK / 2: BK is 64 at (256, 256), where O takes 128.
// At (192, 128) BK is 64 too, in four stages.  128 keys a tile fit its
// registers and ran faster at MLA's shapes (PERF.md, PR 34), but the online
// softmax then rounds otherwise than the (256, 256) kernel MLA ran before,
// and that new bf16 rounding alone moved chip_smoke.py's phase 9(b) check
// of two ranks against one over its limit; at 64 keys the forward gives the
// (256, 256) kernel's bits (its zero-filled columns add exact zeros).
template <int DK, int DV>
struct WgmmaTile {
  static constexpr int BK = DV == 256 || DK != DV ? 64 : 128;  // the S accumulator: BK / 2 registers
  static constexpr int NS = DK == 64 || DK != DV ? 4 : DK == 128 ? 3 : 2;
  static constexpr int K_ATOMS = DK / W_ATOM, V_ATOMS = DV / W_ATOM;
  static constexpr uint32_t Q_BOX = W_BQ * 128;        // bytes of one [128][64] atom column
  static constexpr uint32_t KV_BOX = BK * 128;         // bytes of one [BK][64] atom column
  static constexpr uint32_t Q_BYTES = K_ATOMS * Q_BOX;
  static constexpr uint32_t K_BYTES = K_ATOMS * KV_BOX;  // one K stage
  static constexpr uint32_t V_BYTES = V_ATOMS * KV_BOX;  // one V stage
  // Q, then NS K stages, NS V stages, then the mbarriers (Q full and empty,
  // then for each stage: K full, V full, K empty, V empty); 1024 bytes of
  // slack to align the base to the swizzle period.
  static constexpr size_t SMEM =
      1024 + Q_BYTES + NS * ((size_t)K_BYTES + V_BYTES) + 8 * (2 + 4 * NS);
  static_assert(SMEM <= 232448, "over the 227 KB a block may use");
};

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

// One box of a rank-4 tensor map into shared memory, completing on bar.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// Shared-memory matrix descriptor, 128-byte swizzle.  Offsets in bytes:
// K-major operands (Q, K) step 1024 bytes between 8-row groups (sbo) and
// ignore lbo; the MN-major V steps sbo between 8-key groups and lbo between
// 64-column atoms.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Wait until at most N committed groups are still running.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keep the compiler from moving reads of an accumulator across the wait.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Lower column in the low half, as the A fragments expect.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// D[64 x N] (+)= A[64 x 16] B[16 x N] with fp32 accumulators; the
// accumulator fragment of thread (warp w, lane 4 g + t) holds, for each
// 8-column chunk j, rows 16 w + g (d[4j], d[4j+1]) and 16 w + g + 8 (d[4j+2],
// d[4j+3]) at columns 8 j + 2 t and 8 j + 2 t + 1.  acc = 0 overwrites D.
// wgmma_ss: A and B K-major in shared memory.  wgmma_rs: A from registers
// (the mma.sync m16n8k16 A fragment), B MN-major in shared memory.
#define F4(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define F16(i) F4(i), F4(i + 4), F4(i + 8), F4(i + 12)
#define F32(i) F16(i), F16(i + 16)
#define F64(i) F32(i), F32(i + 32)
#define F128(i) F64(i), F64(i + 64)

template <int N>
__device__ void wgmma_ss(float (&d)[N / 2], uint64_t da, uint64_t db, int acc);
template <int N>
__device__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t db, int acc);

template <>
__device__ __forceinline__ void wgmma_ss<64>(float (&d)[32], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : F32(0)
      : "l"(da), "l"(db), "r"(acc));
}

template <>
__device__ __forceinline__ void wgmma_ss<128>(float (&d)[64], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : F64(0)
      : "l"(da), "l"(db), "r"(acc));
}

template <>
__device__ __forceinline__ void wgmma_rs<64>(float (&d)[32], const uint32_t (&a)[4], uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : F32(0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
}

template <>
__device__ __forceinline__ void wgmma_rs<128>(float (&d)[64], const uint32_t (&a)[4], uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : F64(0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
}

template <>
__device__ __forceinline__ void wgmma_rs<192>(float (&d)[96], const uint32_t (&a)[4], uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %101, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71,"
      "%72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87,"
      "%88, %89, %90, %91, %92, %93, %94, %95"
      "}, {%96, %97, %98, %99}, %100, p, 1, 1, 1;\n}\n"
      : F64(0), F32(64)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
}

template <>
__device__ __forceinline__ void wgmma_rs<256>(float (&d)[128], const uint32_t (&a)[4], uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71,"
      "%72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87,"
      "%88, %89, %90, %91, %92, %93, %94, %95,"
      "%96, %97, %98, %99, %100, %101, %102, %103,"
      "%104, %105, %106, %107, %108, %109, %110, %111,"
      "%112, %113, %114, %115, %116, %117, %118, %119,"
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : F128(0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
}

// D[64 x 64] (+)= A B with A from registers and B K-major in shared memory.
__device__ __forceinline__ void wgmma_rs_kb64(float (&d)[32], const uint32_t (&a)[4], uint64_t db,
                                              int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : F32(0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
}

// D[64 x N] (+)= A B with A and B both MN-major in shared memory: each read
// through the descriptor's transpose, as V is in the forward's P V.
template <int N>
__device__ void wgmma_tt(float (&d)[N / 2], uint64_t da, uint64_t db, int acc);

template <>
__device__ __forceinline__ void wgmma_tt<64>(float (&d)[32], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 1, 1;\n}\n"
      : F32(0)
      : "l"(da), "l"(db), "r"(acc));
}

template <>
__device__ __forceinline__ void wgmma_ss<32>(float (&d)[16], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : F16(0)
      : "l"(da), "l"(db), "r"(acc));
}

// D[64 x 128] (+)= A B with A K-major and B MN-major, both in shared memory
// (B read through the descriptor's transpose).
__device__ __forceinline__ void wgmma_st128(float (&d)[64], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 1;\n}\n"
      : F64(0)
      : "l"(da), "l"(db), "r"(acc));
}

#undef F4
#undef F16
#undef F32
#undef F64
#undef F128

// Online softmax on one S tile in registers (base 2): scale, mask where the
// tile crosses an edge, update the running max m and this thread's partial
// sums l, leave P = 2^(S sl2 - m) in s and each row's rescale factor for O
// in corr.  Element e of chunk j is row qpos0 + 8 (e >> 1), key
// k0 + 8 j + 2 t + (e & 1).  Everything here is branch-free per element: the
// mask is two compares against per-row bounds, and only on edge tiles.  A
// row with no valid key yet keeps m = -inf and P = 0 (it subtracts 0, not
// -inf), so a windowed row gives no NaN.
template <int BK>
__device__ __forceinline__ void softmax_tile(float (&s)[BK / 2], float (&m)[2], float (&l)[2],
                                             float (&corr)[2], const Params& p, bool edge,
                                             int qpos0, int k0, int t, float sl2) {
  if (edge) {
    int lo[2], hi[2];  // row r's valid keys: lo[r] < key < hi[r]
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int q = qpos0 + 8 * r;
      hi[r] = p.causal ? min(p.Tk, q + 1) : p.Tk;
      lo[r] = p.window > 0 ? q - p.window : -1;
    }
    const int key0 = k0 + 2 * t;
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = key0 + 8 * j + (e & 1), r = e >> 1;
        s[4 * j + e] = key > lo[r] && key < hi[r] ? s[4 * j + e] : -INFINITY;
      }
    }
  }
  float mx[2][2] = {{-INFINITY, -INFINITY}, {-INFINITY, -INFINITY}};  // two chains per row
#pragma unroll
  for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) mx[e >> 1][j & 1] = fmaxf(mx[e >> 1][j & 1], s[4 * j + e]);
  }
  float base[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float x = fmaxf(mx[r][0], mx[r][1]);
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
    const float mn = fmaxf(m[r], x * sl2);
    base[r] = mn == -INFINITY ? 0.f : mn;
    corr[r] = ex2(m[r] - base[r]);  // 0 while m is -inf: O and l are still 0 then
    m[r] = mn;
  }
  float sum[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
#pragma unroll
  for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = e >> 1;
      const float pe = ex2(fmaf(s[4 * j + e], sl2, -base[r]));
      s[4 * j + e] = pe;
      sum[r][j & 1] += pe;
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) l[r] = l[r] * corr[r] + (sum[r][0] + sum[r][1]);
}

// The accumulator fragment of keys [16 kc, 16 kc + 16) is the A fragment of
// the kc-th k16 step of PV, in bf16 (v's dtype).
template <int BK>
__device__ __forceinline__ void pack_p(const float (&s)[BK / 2], uint32_t (&pf)[BK / 16][4]) {
#pragma unroll
  for (int kc = 0; kc < BK / 16; ++kc) {
    pf[kc][0] = pack_bf16(s[8 * kc + 0], s[8 * kc + 1]);
    pf[kc][1] = pack_bf16(s[8 * kc + 2], s[8 * kc + 3]);
    pf[kc][2] = pack_bf16(s[8 * kc + 4], s[8 * kc + 5]);
    pf[kc][3] = pack_bf16(s[8 * kc + 6], s[8 * kc + 7]);
  }
}

template <int DK, int DV>
__global__ void __launch_bounds__(W_THREADS, 1)
    flash_fwd_wgmma(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv, Params p) {
  using Tile = WgmmaTile<DK, DV>;
  constexpr int BK = Tile::BK, NS = Tile::NS, K_ATOMS = Tile::K_ATOMS, V_ATOMS = Tile::V_ATOMS;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t sQ = (smem_u32(smem_raw) + 1023) & ~1023u;  // swizzle period
  const uint32_t sK = sQ + Tile::Q_BYTES;
  const uint32_t sV = sK + NS * Tile::K_BYTES;
  // mbarriers, 8 bytes each: Q full, Q empty, then K full, V full, K empty,
  // V empty for each stage.
  const uint32_t q_full = sV + NS * Tile::V_BYTES, q_empty = q_full + 8;
  const uint32_t k_full = q_empty + 8, v_full = k_full + 8 * NS;
  const uint32_t k_empty = v_full + 8 * NS, v_empty = k_empty + 8 * NS;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  // The block is persistent: it takes work tiles (128 query rows of one
  // (b, h)) w = blockIdx.x, blockIdx.x + gridDim.x, ..., heaviest causal
  // tiles first, so that one tile's last products and epilogue overlap the
  // loads of the next.  KV tiles are numbered across work tiles: the j-th
  // goes through stage j % NS in round j / NS.
  const int BH = p.B * p.H, nq = (p.Tq + W_BQ - 1) / W_BQ, nwork = BH * nq;
  // At (192, 128) the walk is head-major instead (heaviest tiles of each
  // head first): MLA gives every query head its own K and V (2.6 MB at T
  // 4096), and tile-major order would keep 132 heads in flight, more than
  // the 50 MB L2 holds, so every work tile would read its K and V from HBM.
  // Its n-th round of work tiles, [n G, n G + G) for a grid of G, goes to
  // the blocks rotated by n, so that each block meets every query tile of a
  // head in turn and none runs ahead of the others onto later heads.
  auto work = [&](int n) {
    if constexpr (DK != DV)
      return n * (int)gridDim.x + ((int)blockIdx.x + n) % (int)gridDim.x;
    else
      return (int)blockIdx.x + n * (int)gridDim.x;
  };
  auto decode = [&](int w, int& b, int& h, int& q0, int& lo, int& hi) {
    if constexpr (DK != DV) {
      q0 = (nq - 1 - w % nq) * W_BQ;
      b = w / nq / p.H;
      h = w / nq % p.H;
    } else {
      q0 = (nq - 1 - w / BH) * W_BQ;
      b = (w % BH) / p.H;
      h = w % p.H;
    }
    kv_tiles(p, q0, W_BQ, BK, lo, hi);
  };

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    mbar_init(q_empty, 8);  // lane 0 of each consumer warp
    for (int s = 0; s < NS; ++s) {
      mbar_init(k_full + 8 * s, 1);
      mbar_init(v_full + 8 * s, 1);
      mbar_init(k_empty + 8 * s, 8);
      mbar_init(v_empty + 8 * s, 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= 8) {
    // ------------------------------------------------------- producer --
    // Q of work tile n once the consumers are done with tile n - 1's; KV
    // tile j once they have released tile j - NS from its stage, K and V
    // separately, since K is done with a whole P V product before V.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(W_PRODUCER_REGS));
    if (threadIdx.x == 256) {
      int j = 0;
      for (int n = 0, w = work(0); w < nwork; w = work(++n)) {
        int b, h, q0, lo, hi;
        decode(w, b, h, q0, lo, hi);
        const int kh = h / (p.H / p.K);
        if (n > 0) mbar_wait(q_empty, (n - 1) & 1);
        mbar_expect_tx(q_full, Tile::Q_BYTES);
#pragma unroll
        for (int a = 0; a < K_ATOMS; ++a)
          tma_load(sQ + a * Tile::Q_BOX, &tq, q_full, a * W_ATOM, h, q0, b);
        for (int kt = lo; kt < hi; ++kt, ++j) {
          const int s = j % NS;
          const uint32_t parity = ((j / NS) - 1) & 1;
          if (j >= NS) mbar_wait(k_empty + 8 * s, parity);
          mbar_expect_tx(k_full + 8 * s, Tile::K_BYTES);
#pragma unroll
          for (int a = 0; a < K_ATOMS; ++a)
            tma_load(sK + s * Tile::K_BYTES + a * Tile::KV_BOX, &tk, k_full + 8 * s, a * W_ATOM,
                     kh, kt * BK, b);
          if (j >= NS) mbar_wait(v_empty + 8 * s, parity);
          mbar_expect_tx(v_full + 8 * s, Tile::V_BYTES);
#pragma unroll
          for (int a = 0; a < V_ATOMS; ++a)
            tma_load(sV + s * Tile::V_BYTES + a * Tile::KV_BOX, &tv, v_full + 8 * s, a * W_ATOM,
                     kh, kt * BK, b);
        }
      }
    }
  } else {
    // ------------------------------------------------------- consumers --
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(W_CONSUMER_REGS));
    const int wg = warp >> 2, t = lane & 3;
    const int row = wg * 64 + (warp & 3) * 16 + (lane >> 2);  // this thread's rows: row, row + 8
    const float sl2 = p.scale * 1.4426950408889634f;         // softmax in base 2
    const uint32_t q_wg = sQ + wg * 64 * 128;

    auto wait_full = [&](uint32_t full, int j) { mbar_wait(full + 8 * (j % NS), (j / NS) & 1); };
    auto release = [&](uint32_t empty, int j) {
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + 8 * (j % NS));
    };
    // S = Q K_j^T, issued and committed, not waited for.
    auto issue_s = [&](float (&sc)[BK / 2], int j) {
      const uint32_t k_st = sK + (j % NS) * Tile::K_BYTES;
#pragma unroll
      for (int kk = 0; kk < DK / 16; ++kk) {
        const uint32_t off = (kk & 3) * 32;  // k16 step inside a 128-byte atom row
        wgmma_ss<BK>(sc, desc_sw128(q_wg + (kk >> 2) * Tile::Q_BOX + off, 16, 1024),
                     desc_sw128(k_st + (kk >> 2) * Tile::KV_BOX + off, 16, 1024), kk > 0);
      }
      wgmma_commit();
    };
    // O += P V_j, issued and committed, not waited for.
    auto issue_pv = [&](float (&o)[DV / 2], const uint32_t (&pf)[BK / 16][4], int j) {
      const uint32_t v_st = sV + (j % NS) * Tile::V_BYTES;
#pragma unroll
      for (int kc = 0; kc < BK / 16; ++kc)
        wgmma_rs<DV>(o, pf[kc], desc_sw128(v_st + kc * 16 * 128, Tile::KV_BOX, 1024), 1);
      wgmma_commit();
    };

    // Ping-pong between the two consumer warpgroups: each issues its
    // products only in its turn (named barrier 1 + wg) and then hands the
    // turn to the other, so that one's softmax runs while the other's
    // products hold the tensor cores.  Both take the same number of turns
    // (every tile of the block's range, also one wholly masked for its own
    // rows), as the barriers need.  Warpgroup 0 has the first turn.
    auto turn_wait = [&]() { asm volatile("bar.sync %0, 256;\n" ::"r"(1 + wg) : "memory"); };
    auto turn_pass = [&]() { asm volatile("bar.arrive %0, 256;\n" ::"r"(2 - wg) : "memory"); };
    if (wg == 1) turn_pass();

    int j0 = 0;  // KV tiles of earlier work tiles
    for (int n = 0, w = work(0); w < nwork; w = work(++n)) {
      int b, h, q0, lo, hi;
      decode(w, b, h, q0, lo, hi);
      const int row0 = q0 + wg * 64, qpos0 = q0 + row;
      // Warpgroup-uniform: does KV tile kt cross the causal diagonal, the
      // window's edge or the end of the keys, for some row of these 64?
      auto edge = [&](int kt) {
        const int k0 = kt * BK;
        return k0 + BK > p.Tk || (p.causal && k0 + BK - 1 > row0) ||
               (p.window > 0 && k0 <= row0 + 63 - p.window);
      };

      float o[DV / 2];
#pragma unroll
      for (int i = 0; i < DV / 2; ++i) o[i] = 0.f;
      float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};  // l: this thread's partial sums

      // KV tiles [lo, hi) are pipelined: the softmax of tile kt runs while
      // the tensor cores compute P V of tile kt - 1.
      mbar_wait(q_full, n & 1);
      if (lo < hi) {
        float sc[BK / 2], corr[2];
        uint32_t pf[BK / 16][4];
        int j = j0;
        wait_full(k_full, j);
        turn_wait();
        wgmma_fence();
        issue_s(sc, j);
        turn_pass();
        wgmma_wait<0>();
        fence_regs(sc);
        release(k_empty, j);
        softmax_tile<BK>(sc, m, l, corr, p, edge(lo), qpos0, lo * BK, t, sl2);
        pack_p<BK>(sc, pf);  // O is still zero: nothing to rescale
        for (int kt = lo + 1; kt < hi; ++kt) {
          j = j0 + kt - lo;
          wait_full(k_full, j);
          wait_full(v_full, j - 1);
          turn_wait();
          wgmma_fence();
          issue_s(sc, j);
          issue_pv(o, pf, j - 1);
          turn_pass();
          wgmma_wait<1>();  // S of tile kt is done, P V of tile kt - 1 may still run
          fence_regs(sc);
          release(k_empty, j);
          softmax_tile<BK>(sc, m, l, corr, p, edge(kt), qpos0, kt * BK, t, sl2);
          wgmma_wait<0>();
          fence_regs(o);
          release(v_empty, j - 1);
#pragma unroll
          for (int c = 0; c < DV / 8; ++c) {
            o[4 * c + 0] *= corr[0];
            o[4 * c + 1] *= corr[0];
            o[4 * c + 2] *= corr[1];
            o[4 * c + 3] *= corr[1];
          }
          pack_p<BK>(sc, pf);
        }
        release(q_empty, 0);  // every S of this work tile is done: Q may be reloaded
        wait_full(v_full, j);
        turn_wait();
        wgmma_fence();
        issue_pv(o, pf, j);
        turn_pass();
        wgmma_wait<0>();
        fence_regs(o);
        release(v_empty, j);
      } else {
        release(q_empty, 0);
      }
      j0 += hi - lo;

      __nv_bfloat16* out = static_cast<__nv_bfloat16*>(p.o);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
        const float inv = 1.f / fmaxf(l[r], 1e-30f);
        const int qpos = qpos0 + 8 * r;
        if (qpos < p.Tq && p.lse != nullptr && t == 0)  // m is in scaled log2 units
          p.lse[((int64_t)b * p.H + h) * p.Tq + qpos] =
              m[r] == -INFINITY ? -INFINITY : (m[r] + log2f(l[r])) * 0.6931471805599453f;
        if (qpos < p.Tq) {
          __nv_bfloat16* orow = out + ((int64_t)(b * p.Tq + qpos) * p.H + h) * p.dv;
#pragma unroll
          for (int c = 0; c < DV / 8; ++c) {
            const int col = 8 * c + 2 * t;
            if (col < p.dv)  // dv is even: col + 1 < dv too
              *reinterpret_cast<__nv_bfloat162*>(orow + col) =
                  __floats2bfloat162_rn(o[4 * c + 2 * r] * inv, o[4 * c + 2 * r + 1] * inv);
          }
        }
      }
    }
    if (wg == 0) turn_wait();  // the last turn warpgroup 1 handed over
  }
}

// ================================================================ backward --
// The flash-backward equations, from the forward's output O and per-row
// log-sum-exp: D = rowsum(dO * O), P = exp(scale S - lse), dV = P^T dO,
// dP = dO V^T, dS = P (dP - D), dQ = scale dS K, dK = scale dS^T Q.  dK and dV
// of a KV head sum over its GQA group in fp32 and are cast once.
struct BwdParams {
  Params p;          // q, k, v, o (the forward's output), lse (read), shapes, masks
  const void* dout;  // [B, Tq, H, dv], contiguous
  void* dq;          // [B, Tq, H, dk]
  void* dk;          // [B, Tk, K, dk]
  void* dv;          // [B, Tk, K, dv]
  float* dq_acc;     // [B, H, t_pad, dk] fp32 zeros: the wgmma variant's dq sums
  float* lse2;       // [B, H, t_pad]: lse in base 2 (+inf for a row with no key)
  float* dsum;       // [B, H, t_pad]: D
  int t_pad;         // Tq rounded up to the wgmma variant's 64-row query tile
  float* part;       // past width 128: fp32 dK then dV of each head group, [groups, B, Tk, K, d]
  int groups;        // past width 128: blocks that share one (key tile, KV head), a divisor of H/K
};

// Query tiles [lo, hi) that see at least one key of the KV tile at k0: the
// forward's kv_tiles read the other way.  Causal: queries from k0 on; window:
// queries up to the tile's last key + window - 1.
__device__ __forceinline__ void q_tiles(const Params& p, int k0, int bk, int bq, int& lo,
                                        int& hi) {
  int q_end = p.Tq;
  if (p.window > 0) q_end = min(q_end, min(k0 + bk, p.Tk) - 1 + p.window);
  lo = (p.causal ? k0 : 0) / bq;
  hi = max(lo, (q_end + bq - 1) / bq);
}

// Row pass: 8 threads per (b, h, query row) of the padded range, in the
// order of the outputs ((b H + h) t_pad + t), with 16-byte loads of o and
// dout where dv and the pointers allow.  Rows past Tq get D = 0 and
// lse2 = +inf, so that they contribute P = 0.
template <typename T>
__global__ void __launch_bounds__(256) flash_bwd_rows(BwdParams bp) {
  constexpr int VEC = 16 / sizeof(T);
  const Params& p = bp.p;
  const int64_t idx = (int64_t)blockIdx.x * 32 + (threadIdx.x >> 3);
  const int lane8 = threadIdx.x & 7;
  if (idx >= (int64_t)p.B * p.H * bp.t_pad) return;  // whole groups of 8 leave together
  const int t = (int)(idx % bp.t_pad), h = (int)(idx / bp.t_pad % p.H), b = (int)(idx / bp.t_pad / p.H);
  float d = 0.f, l2 = INFINITY;
  if (t < p.Tq) {
    const int64_t base = ((int64_t)(b * p.Tq + t) * p.H + h) * p.dv;
    const T* o = static_cast<const T*>(p.o) + base;
    const T* g = static_cast<const T*>(bp.dout) + base;
    if (p.dv % VEC == 0 && ((uintptr_t)p.o | (uintptr_t)bp.dout) % 16 == 0) {
      for (int c = lane8 * VEC; c < p.dv; c += 8 * VEC) {
        const uint4 ov = *reinterpret_cast<const uint4*>(o + c);
        const uint4 gv = *reinterpret_cast<const uint4*>(g + c);
        const T* oe = reinterpret_cast<const T*>(&ov);
        const T* ge = reinterpret_cast<const T*>(&gv);
#pragma unroll
        for (int e = 0; e < VEC; ++e) d = fmaf(to_f(oe[e]), to_f(ge[e]), d);
      }
    } else {
      for (int c = lane8; c < p.dv; c += 8) d = fmaf(to_f(o[c]), to_f(g[c]), d);
    }
#pragma unroll
    for (int off = 4; off > 0; off >>= 1)  // the row's 8 lanes only: rows of a warp may differ in t
      d += __shfl_xor_sync(0xffu << (threadIdx.x & 24), d, off);
    const float lse = p.lse[((int64_t)b * p.H + h) * p.Tq + t];
    l2 = lse == -INFINITY ? INFINITY : lse * 1.4426950408889634f;
  }
  if (lane8 == 0) {
    bp.dsum[idx] = d;
    bp.lse2[idx] = l2;
  }
}

// ------------------------------------------------ SIMT backward (exact fp32) --
// Two passes, no atomics, so a run repeats bit for bit: flash_bwd_simt_dkdv
// (one block per (b, KV head, 32 keys), walking every query head of the
// group and every query tile the mask lets see the keys, dK and dV summed in
// shared memory) and flash_bwd_simt_dq (one block per (b, h, 32 queries),
// walking the forward's KV tiles).  8 threads per row, as the forward.
constexpr int SB = 32;

size_t simt_bwd_smem(int dk, int dv) {
  return sizeof(float) * (2 * (size_t)SB * (dk + 1) + 2 * (size_t)SB * (dv + 1) +
                          (size_t)SB * (dk + dv) + 2 * (size_t)SB * (SB + 1) + 2 * SB);
}

// Rows [r0, r0 + SB) of a [B, T, heads, d] tensor into a [SB][d + 1] fp32 tile,
// zero past T.
template <typename T>
__device__ __forceinline__ void load_rows(float* dst, const void* src, int b, int T_, int heads,
                                          int head, int d, int r0) {
  const T* x = static_cast<const T*>(src);
  for (int i = threadIdx.x; i < SB * d; i += S_THREADS) {
    const int r = i / d, c = i % d, t = r0 + r;
    dst[r * (d + 1) + c] = t < T_ ? to_f(x[((int64_t)(b * T_ + t) * heads + head) * d + c]) : 0.f;
  }
}

template <typename T>
__global__ void __launch_bounds__(S_THREADS) flash_bwd_simt_dkdv(BwdParams bp) {
  const Params& p = bp.p;
  extern __shared__ float smem[];
  const int dk = p.dk, dv = p.dv, lk = dk + 1, lv = dv + 1, lp = SB + 1;
  float* Ks = smem;               // [SB][lk]
  float* Vs = Ks + SB * lk;       // [SB][lv]
  float* Qs = Vs + SB * lv;       // [SB][lk]
  float* Gs = Qs + SB * lk;       // dO, [SB][lv]
  float* dKa = Gs + SB * lv;      // [SB][dk]
  float* dVa = dKa + SB * dk;     // [SB][dv]
  float* Ps = dVa + SB * dv;      // P^T, [SB keys][lp]
  float* dSs = Ps + SB * lp;      // dS^T, [SB keys][lp]
  float* Ls = dSs + SB * lp;      // [SB]
  float* Ds = Ls + SB;            // [SB]

  const int k0 = blockIdx.y * SB;  // causal: the first key tiles see the most queries
  const int b = blockIdx.x / p.K, kh = blockIdx.x % p.K, G = p.H / p.K;
  const int tid = threadIdx.x, row = tid >> 3, lane8 = tid & 7, key = k0 + row;
  const float sl2 = p.scale * 1.4426950408889634f;
  load_rows<T>(Ks, p.k, b, p.Tk, p.K, kh, dk, k0);
  load_rows<T>(Vs, p.v, b, p.Tk, p.K, kh, dv, k0);
  for (int i = tid; i < SB * dk; i += S_THREADS) dKa[i] = 0.f;
  for (int i = tid; i < SB * dv; i += S_THREADS) dVa[i] = 0.f;
  int lo, hi;
  q_tiles(p, k0, SB, SB, lo, hi);
  for (int h = kh * G; h < (kh + 1) * G; ++h) {
    const int64_t rows = (int64_t)(b * p.H + h) * bp.t_pad;
    for (int qt = lo; qt < hi; ++qt) {
      const int m0 = qt * SB;
      __syncthreads();  // the previous tile's readers are done
      load_rows<T>(Qs, p.q, b, p.Tq, p.H, h, dk, m0);
      load_rows<T>(Gs, bp.dout, b, p.Tq, p.H, h, dv, m0);
      if (tid < SB) {
        Ls[tid] = bp.lse2[rows + m0 + tid];
        Ds[tid] = bp.dsum[rows + m0 + tid];
      }
      __syncthreads();
#pragma unroll
      for (int jj = 0; jj < SB / 8; ++jj) {
        const int j = lane8 + jj * 8;
        float s = 0.f, dp = 0.f;
        for (int c = 0; c < dk; ++c) s = fmaf(Ks[row * lk + c], Qs[j * lk + c], s);
        for (int c = 0; c < dv; ++c) dp = fmaf(Vs[row * lv + c], Gs[j * lv + c], dp);
        const float pj = masked(p, m0 + j, key) ? 0.f : exp2f(fmaf(s, sl2, -Ls[j]));
        Ps[row * lp + j] = pj;
        dSs[row * lp + j] = pj * (dp - Ds[j]);
      }
      __syncwarp();  // a row's 8 threads share one warp
      for (int c = lane8; c < dv; c += 8) {
        float a = dVa[row * dv + c];
        for (int j = 0; j < SB; ++j) a = fmaf(Ps[row * lp + j], Gs[j * lv + c], a);
        dVa[row * dv + c] = a;
      }
      for (int c = lane8; c < dk; c += 8) {
        float a = dKa[row * dk + c];
        for (int j = 0; j < SB; ++j) a = fmaf(dSs[row * lp + j], Qs[j * lk + c], a);
        dKa[row * dk + c] = a;
      }
    }
  }
  if (key < p.Tk) {
    const int64_t base = (int64_t)(b * p.Tk + key) * p.K + kh;
    for (int c = lane8; c < dk; c += 8)
      store_f(static_cast<T*>(bp.dk) + base * dk + c, p.scale * dKa[row * dk + c]);
    for (int c = lane8; c < dv; c += 8)
      store_f(static_cast<T*>(bp.dv) + base * dv + c, dVa[row * dv + c]);
  }
}

template <typename T>
__global__ void __launch_bounds__(S_THREADS) flash_bwd_simt_dq(BwdParams bp) {
  const Params& p = bp.p;
  extern __shared__ float smem[];
  const int dk = p.dk, dv = p.dv, lk = dk + 1, lv = dv + 1, lp = SB + 1;
  float* Qs = smem;               // [SB][lk]
  float* Gs = Qs + SB * lk;       // dO, [SB][lv]
  float* Ks = Gs + SB * lv;       // [SB][lk]
  float* Vs = Ks + SB * lk;       // [SB][lv]
  float* dQa = Vs + SB * lv;      // [SB][dk]
  float* dSs = dQa + SB * dk;     // [SB queries][lp]

  const int m0 = (gridDim.y - 1 - blockIdx.y) * SB;  // heaviest causal tiles first
  const int b = blockIdx.x / p.H, h = blockIdx.x % p.H, kh = h / (p.H / p.K);
  const int tid = threadIdx.x, row = tid >> 3, lane8 = tid & 7, qpos = m0 + row;
  const float sl2 = p.scale * 1.4426950408889634f;
  load_rows<T>(Qs, p.q, b, p.Tq, p.H, h, dk, m0);
  load_rows<T>(Gs, bp.dout, b, p.Tq, p.H, h, dv, m0);
  for (int i = tid; i < SB * dk; i += S_THREADS) dQa[i] = 0.f;
  const int64_t rows = (int64_t)(b * p.H + h) * bp.t_pad + qpos;
  const float l2 = bp.lse2[rows], d = bp.dsum[rows];
  int lo, hi;
  kv_tiles(p, m0, SB, SB, lo, hi);
  for (int kt = lo; kt < hi; ++kt) {
    const int k0 = kt * SB;
    __syncthreads();
    load_rows<T>(Ks, p.k, b, p.Tk, p.K, kh, dk, k0);
    load_rows<T>(Vs, p.v, b, p.Tk, p.K, kh, dv, k0);
    __syncthreads();
#pragma unroll
    for (int jj = 0; jj < SB / 8; ++jj) {
      const int j = lane8 + jj * 8;
      float s = 0.f, dp = 0.f;
      for (int c = 0; c < dk; ++c) s = fmaf(Qs[row * lk + c], Ks[j * lk + c], s);
      for (int c = 0; c < dv; ++c) dp = fmaf(Gs[row * lv + c], Vs[j * lv + c], dp);
      const float pj = masked(p, qpos, k0 + j) ? 0.f : exp2f(fmaf(s, sl2, -l2));
      dSs[row * lp + j] = pj * (dp - d);
    }
    __syncwarp();
    for (int c = lane8; c < dk; c += 8) {
      float a = dQa[row * dk + c];
      for (int j = 0; j < SB; ++j) a = fmaf(dSs[row * lp + j], Ks[j * lk + c], a);
      dQa[row * dk + c] = a;
    }
  }
  if (qpos < p.Tq) {
    T* out = static_cast<T*>(bp.dq) + ((int64_t)(b * p.Tq + qpos) * p.H + h) * dk;
    for (int c = lane8; c < dk; c += 8) store_f(out + c, p.scale * dQa[row * dk + c]);
  }
}

// --------------------------------------------------------- wgmma backward --
// flash_bwd_wgmma<D>, D 64 or 128 (dk, dv <= D; past 128, see the split
// kernels below).  One block per (b, KV head,
// BN = 128 keys), heaviest key tiles first.  The block walks steps i: every
// query head of the GQA group and every 64-row query tile the mask lets see
// its keys (q_tiles).  Roles (384 threads):
//   - the loader (thread 256) issues TMA loads: K and V once, then per step
//     Q, dO, lse2 and D into a ring of NS = 2 stages;
//   - the dQ writer (thread 288) adds each finished 64 x 64 fp32 dQ tile into
//     dq_acc ([B, H, t_pad, dk]) by TMA tensor reductions
//     (cp.reduce.async.bulk.tensor .add), which are atomic in L2;
//   - two consumer warpgroups (warps 0-7, 240 registers) own 64 keys each
//     and keep their dK and dV accumulators in registers for the whole walk.
//     Per step a consumer computes S^T = K Q^T and dP^T = V dO^T (K and V
//     held in registers as A fragments at D 64, read from shared memory at
//     D 128), P^T = 2^(S^T sl2 - lse2) and dS^T = P^T (dP^T - D) in
//     registers (masks in one warpgroup-uniform branch, on edge tiles only),
//     writes dS^T in bf16 to its half of dS^T buffer i % 3 (128-byte swizzle,
//     by hand), and issues dV += P^T dO and dK += dS^T Q (A from registers).
//     dQ needs both halves of dS^T, so each step's dQ has one owner, consumer
//     i % 2, which computes it one step late (during step i + 1, when the
//     other half is written already): dS K over all 128 keys (both operands
//     MN-major), 64 columns per tile, stored in the TMA's 128-byte swizzle
//     (every bank once per warp) and handed to the writer.
// Barriers, all mbarriers: full/empty per stage (loader and consumers),
// full/empty per dS^T buffer (both consumers and the step's dQ owner), and
// full/empty per dQ tile (owner and writer).  The consumers meet nowhere
// else: with dQ owned in turns they overlap each other's products and
// elementwise passes without named barriers (turns between them, as the
// forward takes them, made this kernel slower on the card).
// Shared memory: K and V, two stages of Q and dO (8 KB each at D 64, 16 KB
// at D 128) with lse2 and D, three 16 KB dS^T buffers, and two dQ tiles of
// 16 KB per consumer at D 64 (one at D 128, which sends two per step): 183448
// B at D 64, 216184 B at D 128 (SMEM).  The order in which a query tile's
// reductions arrive can change from run to run; a last pass
// (flash_bwd_dq_cast) scales dq and casts it to bf16.
// What bounds it: five products per unmasked (query, key) pair against the
// forward's two; at llama3.2-1b's training shape (T 4096, H 32, K 8, d 64,
// causal) 171.8 GFLOP against 84.4 MB of inputs and outputs, so the tensor
// cores (0.174 ms on an H100).  The products are small (64 x 64 x 64 at d
// 64), and each score costs an ex2 and two bf16 conversions on the
// quarter-rate pipe between a consumer's products, so the kernel reaches a
// little under half of that bound.
template <int D>
struct BwdTile {
  static constexpr int BM = 64;   // query rows per step
  static constexpr int BN = 128;  // keys per block, 64 per consumer warpgroup
  static constexpr int NS = 2;     // stages of (Q, dO, lse2, D)
  static constexpr int NDS = 3;    // dS^T buffers: step i's in buffer i % NDS
  static constexpr int ATOMS = D / W_ATOM;
  static constexpr int CHUNKS = D / 64;            // 64-column dQ tiles per step
  static constexpr int DQ_BUFS = D == 64 ? 2 : 1;  // dQ tiles per consumer
  static constexpr bool KV_REGS = D == 64;         // K and V as A fragments in registers
  static constexpr uint32_t KV_BOX = BN * 128;     // one [BN][64] atom column
  static constexpr uint32_t Q_BOX = BM * 128;      // one [BM][64] atom column
  static constexpr uint32_t KV_BYTES = ATOMS * KV_BOX;
  static constexpr uint32_t Q_BYTES = ATOMS * Q_BOX;
  static constexpr uint32_t ROW_BYTES = BM * 4;  // lse2 or D of one step
  // A stage: Q, dO, then lse2 and D padded to the swizzle period.
  static constexpr uint32_t STAGE = 2 * Q_BYTES + 1024;
  static constexpr uint32_t DS_BYTES = BN * BM * 2;  // dS^T in bf16, [BN keys][BM queries]
  static constexpr uint32_t DQ_BOX = BM * 128;       // [BM][32] fp32: one swizzled box
  static constexpr uint32_t DQ_TILE = 2 * DQ_BOX;    // 64 x 64 fp32
  // K, V, NS stages, NDS dS^T buffers, the dQ tiles (consumer 0's, then
  // 1's), then the mbarriers (K and V full; full and empty of each stage, of
  // each dS^T buffer and of each dQ tile); 1024 bytes of slack for the
  // alignment.
  static constexpr size_t SMEM = 1024 + 2 * (size_t)KV_BYTES + NS * (size_t)STAGE +
                                 NDS * (size_t)DS_BYTES + 2 * DQ_BUFS * (size_t)DQ_TILE +
                                 8 * (1 + 2 * NS + 2 * NDS + 4 * DQ_BUFS);
  static_assert(SMEM <= 232448, "over the 227 KB a block may use");
};

// One contiguous run of global memory into shared memory, completing on bar
// (16-byte aligned, a multiple of 16 bytes).
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(bar)
      : "memory");
}

// Add one box of shared memory into a rank-2 fp32 tensor map at (c0, c1).
__device__ __forceinline__ void tma_reduce_add(const CUtensorMap* map, uint32_t src, int c0,
                                               int c1) {
  asm volatile(
      "cp.reduce.async.bulk.tensor.2d.global.shared::cta.add.bulk_group [%0, {%2, %3}], [%1];\n"
      ::"l"(reinterpret_cast<uint64_t>(map)), "r"(src), "r"(c0), "r"(c1)
      : "memory");
}

template <int D>
__global__ void __launch_bounds__(W_THREADS, 1)
    flash_bwd_wgmma(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
                    const __grid_constant__ CUtensorMap tdq, BwdParams bp) {
  using Tile = BwdTile<D>;
  constexpr int BM = Tile::BM, BN = Tile::BN, NS = Tile::NS, ATOMS = Tile::ATOMS;
  constexpr int CHUNKS = Tile::CHUNKS, DQ_BUFS = Tile::DQ_BUFS, NDS = Tile::NDS;
  const Params& p = bp.p;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t sK = smem_u32(sm);
  const uint32_t sV = sK + Tile::KV_BYTES;
  const uint32_t sStage = sV + Tile::KV_BYTES;
  const uint32_t sDS = sStage + NS * Tile::STAGE;  // buffer i % NDS holds step i's dS^T
  const uint32_t sDQ = sDS + NDS * Tile::DS_BYTES;  // tile (wg, n): sDQ + (wg DQ_BUFS + n) DQ_TILE
  const uint32_t kv_full = sDQ + 2 * DQ_BUFS * Tile::DQ_TILE;
  const uint32_t full = kv_full + 8, empty = full + 8 * NS;
  const uint32_t ds_full = empty + 8 * NS, ds_empty = ds_full + 8 * NDS;
  const uint32_t dq_full = ds_empty + 8 * NDS, dq_empty = dq_full + 8 * 2 * DQ_BUFS;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  const int BK_ = p.B * p.K, kt = blockIdx.x / BK_;  // the first key tiles are the heaviest
  const int b = (blockIdx.x % BK_) / p.K, kh = blockIdx.x % p.K, G = p.H / p.K;
  const int k0 = kt * BN;
  int lo, hi;
  q_tiles(p, k0, BN, BM, lo, hi);
  const int nq = hi - lo, steps = G * nq;  // step i: head kh G + i / nq, query tile lo + i % nq

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < NS; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 8);  // lane 0 of each consumer warp
    }
    for (int n = 0; n < NDS; ++n) {
      mbar_init(ds_full + 8 * n, 256);  // every consumer thread
      mbar_init(ds_empty + 8 * n, 4);   // lane 0 of each warp of the step's dQ consumer
    }
    for (int n = 0; n < 2 * DQ_BUFS; ++n) {
      mbar_init(dq_full + 8 * n, 128);  // every thread of the tile's consumer
      mbar_init(dq_empty + 8 * n, 1);   // the writer
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= 8) {
    // ------------------------------------------------ loader and writer --
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(W_PRODUCER_REGS));
    if (threadIdx.x == 256) {
      mbar_expect_tx(kv_full, 2 * Tile::KV_BYTES);
#pragma unroll
      for (int a = 0; a < ATOMS; ++a) {
        tma_load(sK + a * Tile::KV_BOX, &tk, kv_full, a * W_ATOM, kh, k0, b);
        tma_load(sV + a * Tile::KV_BOX, &tv, kv_full, a * W_ATOM, kh, k0, b);
      }
      for (int i = 0; i < steps; ++i) {
        const int s = i % NS, h = kh * G + i / nq, m0 = (lo + i % nq) * BM;
        if (i >= NS) mbar_wait(empty + 8 * s, ((i / NS) - 1) & 1);
        const uint32_t st = sStage + s * Tile::STAGE, bar = full + 8 * s;
        mbar_expect_tx(bar, 2 * Tile::Q_BYTES + 2 * Tile::ROW_BYTES);
#pragma unroll
        for (int a = 0; a < ATOMS; ++a) {
          tma_load(st + a * Tile::Q_BOX, &tq, bar, a * W_ATOM, h, m0, b);
          tma_load(st + Tile::Q_BYTES + a * Tile::Q_BOX, &tdo, bar, a * W_ATOM, h, m0, b);
        }
        const int64_t rows = (int64_t)(b * p.H + h) * bp.t_pad + m0;
        const uint32_t rs = st + 2 * Tile::Q_BYTES;
        bulk_load(rs, bp.lse2 + rows, Tile::ROW_BYTES, bar);
        bulk_load(rs + Tile::ROW_BYTES, bp.dsum + rows, Tile::ROW_BYTES, bar);
      }
    } else if (threadIdx.x == 288) {
      // The dQ writer: step i's dQ tiles come from consumer i % 2, its
      // ((i / 2) CHUNKS + c)-th, in its tile ((i / 2) CHUNKS + c) % DQ_BUFS.
      for (int i = 0; i < steps; ++i) {
        const int wg = i & 1;
        const int row = (b * p.H + kh * G + i / nq) * bp.t_pad + (lo + i % nq) * BM;
#pragma unroll
        for (int c = 0; c < CHUNKS; ++c) {
          const int u = (i >> 1) * CHUNKS + c, tile = wg * DQ_BUFS + u % DQ_BUFS;
          mbar_wait(dq_full + 8 * tile, (u / DQ_BUFS) & 1);
#pragma unroll
          for (int x = 0; x < 2; ++x)
            if (64 * c + 32 * x < p.dk)
              tma_reduce_add(&tdq, sDQ + tile * Tile::DQ_TILE + x * Tile::DQ_BOX, 64 * c + 32 * x,
                             row);
          asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
          asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
          mbar_arrive(dq_empty + 8 * tile);
        }
      }
      // The last reductions have landed before the block ends.
      asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
    }
  } else {
    // ------------------------------------------------------- consumers --
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(W_CONSUMER_REGS));
    const int wg = warp >> 2, t = lane & 3, g = lane >> 2;
    const int lrow = wg * 64 + (warp & 3) * 16 + g;  // this thread's keys: lrow, lrow + 8
    const int kw0 = k0 + wg * 64, key0 = k0 + lrow;
    const float sl2 = p.scale * 1.4426950408889634f;
    const uint32_t k_wg = sK + wg * 64 * 128, v_wg = sV + wg * 64 * 128;

    float dv_acc[D / 2], dk_acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dv_acc[i] = dk_acc[i] = 0.f;
    mbar_wait(kv_full, 0);

    // At D 64, K and V of this warpgroup's keys as A fragments (pack_p's
    // layout: k16 step kk holds key rows lrow, lrow + 8 and columns
    // 16 kk + 2 t (+1, +8, +9)), read once through the TMA's swizzle.
    constexpr int KF = Tile::KV_REGS ? D / 16 : 1;
    uint32_t kf[KF][4], vf[KF][4];
    if constexpr (Tile::KV_REGS) {
#pragma unroll
      for (int kk = 0; kk < KF; ++kk) {
#pragma unroll
        for (int f = 0; f < 4; ++f) {
          const int r = lrow + 8 * (f & 1), c = 16 * kk + 2 * t + 8 * (f >> 1);
          const int off = r * 128 + (((c >> 3) ^ (r & 7)) << 4) + (c & 7) * 2;
          kf[kk][f] = *reinterpret_cast<const uint32_t*>(sm + off);
          vf[kk][f] = *reinterpret_cast<const uint32_t*>(sm + (sV - sK) + off);
        }
      }
    }

    auto stage = [&](int i) { return sStage + (i % NS) * Tile::STAGE; };
    auto arrive_warp = [&](uint32_t bar) {  // one arrival per warp, after all its lanes
      __syncwarp();
      if (lane == 0) mbar_arrive(bar);
    };
    // S^T = K Q^T and dP^T = V dO^T of step i (B K-major), issued and committed.
    auto issue_sdp = [&](float (&sc)[32], float (&dp)[32], int i) {
      const uint32_t q_st = stage(i), do_st = q_st + Tile::Q_BYTES;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t off = (kk >> 2) * Tile::KV_BOX + (kk & 3) * 32;
        const uint32_t qoff = (kk >> 2) * Tile::Q_BOX + (kk & 3) * 32;
        if constexpr (Tile::KV_REGS)
          wgmma_rs_kb64(sc, kf[kk], desc_sw128(q_st + qoff, 16, 1024), kk > 0);
        else
          wgmma_ss<64>(sc, desc_sw128(k_wg + off, 16, 1024), desc_sw128(q_st + qoff, 16, 1024),
                       kk > 0);
      }
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t off = (kk >> 2) * Tile::KV_BOX + (kk & 3) * 32;
        const uint32_t qoff = (kk >> 2) * Tile::Q_BOX + (kk & 3) * 32;
        if constexpr (Tile::KV_REGS)
          wgmma_rs_kb64(dp, vf[kk], desc_sw128(do_st + qoff, 16, 1024), kk > 0);
        else
          wgmma_ss<64>(dp, desc_sw128(v_wg + off, 16, 1024), desc_sw128(do_st + qoff, 16, 1024),
                       kk > 0);
      }
      wgmma_commit();
    };
    // dV += P^T dO and dK += dS^T Q (A from registers), issued and committed.
    auto issue_dkdv = [&](const uint32_t (&pf)[4][4], const uint32_t (&dsf)[4][4], int i) {
      const uint32_t q_st = stage(i), do_st = q_st + Tile::Q_BYTES;
      wgmma_fence();
#pragma unroll
      for (int kc = 0; kc < BM / 16; ++kc)
        wgmma_rs<D>(dv_acc, pf[kc], desc_sw128(do_st + kc * 16 * 128, Tile::Q_BOX, 1024), 1);
#pragma unroll
      for (int kc = 0; kc < BM / 16; ++kc)
        wgmma_rs<D>(dk_acc, dsf[kc], desc_sw128(q_st + kc * 16 * 128, Tile::Q_BOX, 1024), 1);
      wgmma_commit();
    };
    // dQ[:, c:c + 64] = dS K[:, c:c + 64] of step i over all 128 keys (both
    // operands MN-major), issued and committed.
    auto issue_dq = [&](float (&dq)[32], int i, int c) {
      const uint32_t ds_i = sDS + (i % NDS) * Tile::DS_BYTES;
      wgmma_fence();
#pragma unroll
      for (int kc = 0; kc < BN / 16; ++kc)
        wgmma_tt<64>(dq, desc_sw128(ds_i + kc * 16 * 128, Tile::DS_BYTES, 1024),
                     desc_sw128(sK + (c / 64) * Tile::KV_BOX + kc * 16 * 128, Tile::KV_BOX, 1024),
                     kc > 0);
      wgmma_commit();
    };
    // dQ tile u of this consumer, [64 rows][32] fp32 boxes under the 128-byte
    // swizzle (16-byte unit (col / 4) ^ (row % 8) of the row's 128 bytes, so
    // that a warp's stores hit every bank once), then handed to the writer.
    auto store_dq = [&](const float (&dq)[32], int u) {
      const int tile = wg * DQ_BUFS + u % DQ_BUFS;
      if (u >= DQ_BUFS) mbar_wait(dq_empty + 8 * tile, ((u / DQ_BUFS) - 1) & 1);
      unsigned char* dst = sm + (sDQ - sK) + tile * Tile::DQ_TILE;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = (warp & 3) * 16 + g + 8 * r;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int col = (8 * j + 2 * t) & 31;
          *reinterpret_cast<float2*>(dst + (j >> 2) * Tile::DQ_BOX + row * 128 +
                                     (((col >> 2) ^ (row & 7)) << 4) + (col & 3) * 4) =
              make_float2(dq[4 * j + 2 * r], dq[4 * j + 2 * r + 1]);
        }
      }
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      mbar_arrive(dq_full + 8 * tile);
    };

    // dQ of step i from its owner, consumer i % 2, one step late so that the
    // other consumer's half of dS^T is there already: over both halves, 64
    // columns at a time; then the dS^T buffer goes back to both consumers.
    auto dq_step = [&](int i) {
      float dq[32];
      mbar_wait(ds_full + 8 * (i % NDS), (i / NDS) & 1);
      // The running dV and dK products are done before dq's accumulators
      // are allocated: nothing new lives in registers while a product still
      // reads its A fragments from them.
      wgmma_wait<0>();
#pragma unroll
      for (int c = 0; c < CHUNKS; ++c) {
        issue_dq(dq, i, 64 * c);
        wgmma_wait<0>();
        fence_regs(dq);
        store_dq(dq, (i >> 1) * CHUNKS + c);
      }
      arrive_warp(ds_empty + 8 * (i % NDS));
    };

    for (int i = 0; i < steps; ++i) {
      const int m0 = (lo + i % nq) * BM;
      const float* lse2 = reinterpret_cast<const float*>(sm + (stage(i) - sK) + 2 * Tile::Q_BYTES);
      const float* dsum = lse2 + BM;
      float sc[32], dp[32];
      mbar_wait(full + 8 * (i % NS), (i / NS) & 1);
      issue_sdp(sc, dp, i);
      wgmma_wait<0>();
      fence_regs(sc);
      fence_regs(dp);

      // P^T: element e of chunk j is key key0 + 8 (e >> 1), query
      // m0 + 8 j + 2 t + (e & 1).
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float2 l2 = *reinterpret_cast<const float2*>(lse2 + 8 * j + 2 * t);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          sc[4 * j + e] = ex2(fmaf(sc[4 * j + e], sl2, -((e & 1) ? l2.y : l2.x)));
      }
      // Does this 64 x 64 tile cross the diagonal, the window's edge or the
      // end of the keys?  Warpgroup-uniform, so the mask costs one branch
      // and, on edge tiles only, two compares per element: key row r sees
      // the queries [qlo[r], qhi[r]).
      if (kw0 + 64 > p.Tk || (p.causal && kw0 + 63 > m0) ||
          (p.window > 0 && kw0 <= m0 + 63 - p.window)) {
        int qlo[2], qhi[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int key = key0 + 8 * r;
          qlo[r] = p.causal ? key : INT_MIN;
          qhi[r] = key >= p.Tk ? INT_MIN : p.window > 0 ? key + p.window : INT_MAX;
        }
#pragma unroll
        for (int j = 0; j < 8; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int q = m0 + 8 * j + 2 * t + (e & 1), r = e >> 1;
            sc[4 * j + e] = q >= qlo[r] && q < qhi[r] ? sc[4 * j + e] : 0.f;
          }
        }
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float2 dd = *reinterpret_cast<const float2*>(dsum + 8 * j + 2 * t);
#pragma unroll
        for (int e = 0; e < 4; ++e)  // dS^T
          dp[4 * j + e] = sc[4 * j + e] * (dp[4 * j + e] - ((e & 1) ? dd.y : dd.x));
      }
      uint32_t pf[4][4], dsf[4][4];
      pack_p<64>(sc, pf);
      pack_p<64>(dp, dsf);

      // dS^T to buffer i % NDS once step i - NDS's dQ has read it: key row
      // r, query column c at byte r 128 + ((c / 8) ^ (r % 8)) 16 + (c % 8) 2,
      // the 128-byte swizzle.
      if (i >= NDS) mbar_wait(ds_empty + 8 * (i % NDS), ((i / NDS) - 1) & 1);
      unsigned char* ds = sm + (sDS - sK) + (i % NDS) * Tile::DS_BYTES;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int kr = lrow + 8 * r;
          *reinterpret_cast<uint32_t*>(ds + kr * 128 + ((j ^ (kr & 7)) << 4) + 4 * t) =
              dsf[j >> 1][(j & 1) * 2 + r];
        }
      }
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      mbar_arrive(ds_full + 8 * (i % NDS));

      // dV and dK of step i; then dQ of step i - 1 if this consumer owns it.
      issue_dkdv(pf, dsf, i);
      if (i > 0 && ((i - 1) & 1) == wg) dq_step(i - 1);
      wgmma_wait<0>();
      fence_regs(dv_acc);
      fence_regs(dk_acc);
      arrive_warp(empty + 8 * (i % NS));  // step i's stage goes back to the loader
    }
    if (steps > 0 && ((steps - 1) & 1) == wg) dq_step(steps - 1);

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int key = key0 + 8 * r;
      if (key < p.Tk) {
        const int64_t base = (int64_t)(b * p.Tk + key) * p.K + kh;
        __nv_bfloat16* dkr = static_cast<__nv_bfloat16*>(bp.dk) + base * p.dk;
        __nv_bfloat16* dvr = static_cast<__nv_bfloat16*>(bp.dv) + base * p.dv;
#pragma unroll
        for (int c = 0; c < D / 8; ++c) {
          const int col = 8 * c + 2 * t;
          if (col < p.dk)
            *reinterpret_cast<__nv_bfloat162*>(dkr + col) = __floats2bfloat162_rn(
                p.scale * dk_acc[4 * c + 2 * r], p.scale * dk_acc[4 * c + 2 * r + 1]);
          if (col < p.dv)
            *reinterpret_cast<__nv_bfloat162*>(dvr + col) =
                __floats2bfloat162_rn(dv_acc[4 * c + 2 * r], dv_acc[4 * c + 2 * r + 1]);
        }
      }
    }
  }
}

// dq [B, Tq, H, dk] = scale dq_acc [B, H, t_pad, dk] in bf16, 8 columns per
// thread (dk is a multiple of 8 on the wgmma variant): two 16-byte loads,
// one 16-byte store.
__global__ void __launch_bounds__(256) flash_bwd_dq_cast(BwdParams bp, int64_t n8) {
  const Params& p = bp.p;
  for (int64_t i = blockIdx.x * 256 + threadIdx.x; i < n8; i += (int64_t)gridDim.x * 256) {
    const int64_t row = i * 8 / p.dk;  // (b Tq + t) H + h
    const int col = (int)(i * 8 - row * p.dk);
    const int h = (int)(row % p.H), t = (int)(row / p.H % p.Tq), b = (int)(row / p.H / p.Tq);
    const float4* src = reinterpret_cast<const float4*>(
        bp.dq_acc + ((int64_t)(b * p.H + h) * bp.t_pad + t) * p.dk + col);
    const float4 x = src[0], y = src[1];
    uint4 out;
    out.x = pack_bf16(p.scale * x.x, p.scale * x.y);
    out.y = pack_bf16(p.scale * x.z, p.scale * x.w);
    out.z = pack_bf16(p.scale * y.x, p.scale * y.y);
    out.w = pack_bf16(p.scale * y.z, p.scale * y.w);
    reinterpret_cast<uint4*>(bp.dq)[i] = out;
  }
}

// ----------------------------------- wgmma backward at (DK, DV) = (256, 256) --
// flash_bwd_wgmma_dkdv<256, 256> and flash_bwd_wgmma_dq<256, 256> (128 <
// max(dk, dv) <= 256 outside MLA's widths; their bodies dkdv_halves and
// dq_halves), two kernels with no atomics, so that a run repeats bit for
// bit.  The layout of flash_bwd_wgmma<64/128> does not stretch to D 256: dK
// and dV of 64 keys in one warpgroup would be 256 registers a thread, and
// K, V and two stages of Q and dO at 128 keys would be 320 KB.
//   - flash_bwd_wgmma_dkdv: one block per (64-key tile, head group, b, KV
//     head), heaviest key tiles first.  The GQA group of H/K query heads is
//     split into `groups` blocks (the wrapper chooses the count from the SM
//     count, so that a B 1 MQA grid fills the card), each walking its heads
//     and the query tiles q_tiles gives.  K and V (32 KB each) load once; Q,
//     dO (32 KB each), lse2 and D stream through two stages.  The two
//     consumer warpgroups split the head dim: each keeps dK and dV of all 64
//     keys for its 128 columns (64 + 64 registers), computes S^T = K Q^T and
//     dP^T = V dO^T for its 32 of the step's 64 queries (16 + 16 registers),
//     P^T and dS^T from them, and writes its half of both to shared memory in
//     bf16 (128-byte swizzle, by hand).  Both then read all of P^T and dS^T
//     as the shared-memory A operand of dV += P^T dO and dK += dS^T Q, B the
//     consumer's columns of dO and Q read through the transpose.  Two named
//     barriers a step guard the one P^T / dS^T buffer: before the writes
//     (both consumers' products of the step before are done) and after them.
//     Each block writes its fp32 dK (unscaled) and dV to its head group's
//     slice of `part`.
//   - flash_bwd_wgmma_dq: one block per (b, h, 64 query rows), heaviest
//     causal tiles first.  Q and dO load once; K and V stream through two
//     stages over the forward's kv_tiles.  The same split: each consumer
//     computes S = Q K^T and dP = dO V^T for its 32 of the step's 64 keys,
//     dS in bf16 to shared memory, then dQ += dS K for its 128 columns.
//     dQ is scaled and cast once at the end, written straight to dq.
//   - flash_bwd_dkdv_sum sums the groups' partials in a fixed order, scales
//     dK and casts both to bf16.
// Roles as flash_bwd_wgmma's: one TMA loader thread (thread 256) and two
// consumer warpgroups (240 registers each) that meet the loader on mbarriers
// (K and V, or Q and dO, full; full and empty per stage).
// Shared memory: K, V, two stages of (Q, dO, lse2, D), P^T and dS^T (8 KB
// each): 216104 B for dkdv; Q, dO, two stages of (K, V), dS: 205864 B for dq
// (Bwd256Tile).
// What bounds it: recomputing S and dP in the dq kernel makes seven products
// per unmasked pair instead of five.  At recurrentgemma-9b's training shape
// (T 4096, H 16, K 1, d 256, causal, window 2048) that is 361 GFLOP against
// 0.14 GB of inputs and outputs, so the tensor cores (0.365 ms at 989
// TFLOP/s; 0.261 ms for five products).  A step moves a 64 KB tile pair from L2 for 3-4 small
// products (N 32 and 128), so L2 and shared-memory bandwidth come close.
template <int D>
struct Bwd256Tile {
  static constexpr int BT = 64;  // rows of every tile: keys or queries
  static constexpr int NS = 2;   // stages
  static constexpr int ATOMS = D / W_ATOM;
  static constexpr int HALF = D / 2;                 // head-dim columns per consumer
  static constexpr uint32_t BOX = BT * 128;          // one [64][64] bf16 atom column
  static constexpr uint32_t TILE = ATOMS * BOX;      // one 64-row operand tile
  static constexpr uint32_t ROW_BYTES = BT * 4;      // lse2 or D of one query tile
  static constexpr uint32_t DKDV_STAGE = 2 * TILE + 1024;  // Q, dO, lse2 and D
  static constexpr uint32_t DQ_STAGE = 2 * TILE;           // K, V
  static constexpr uint32_t SCORE = BT * BT * 2;     // [64][64] bf16: P^T, dS^T or dS
  static constexpr size_t DKDV_SMEM =
      1024 + 2 * (size_t)TILE + NS * (size_t)DKDV_STAGE + 2 * SCORE + 8 * (1 + 2 * NS);
  static constexpr size_t DQ_SMEM =
      1024 + 2 * (size_t)TILE + NS * (size_t)DQ_STAGE + SCORE + 8 * (1 + 2 * NS);
  static_assert(DKDV_SMEM <= 232448 && DQ_SMEM <= 232448, "over the 227 KB a block may use");
};

// Both consumer warpgroups (256 threads) at named barrier id.
__device__ __forceinline__ void consumers_sync(int id) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(id) : "memory");
}

// This consumer's half of a [64 rows][64 columns] bf16 score tile from its
// m64n32 accumulator (columns 32 wg + ...), under the 128-byte swizzle: row
// r, column c at byte r 128 + ((c / 8) ^ (r % 8)) 16 + (c % 8) 2, so that a
// warp's stores hit every bank once.
__device__ __forceinline__ void store_half(unsigned char* dst, const float (&x)[16], int lrow,
                                           int wg, int t) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = lrow + 8 * r;
      *reinterpret_cast<uint32_t*>(dst + row * 128 + (((4 * wg + j) ^ (row & 7)) << 4) + 4 * t) =
          pack_bf16(x[4 * j + 2 * r], x[4 * j + 2 * r + 1]);
    }
  }
}

// The body of flash_bwd_wgmma_dkdv<256, 256>.
template <int D>
__device__ __forceinline__ void dkdv_halves(const CUtensorMap& tq, const CUtensorMap& tk,
                                            const CUtensorMap& tv, const CUtensorMap& tdo,
                                            const BwdParams& bp) {
  using Tile = Bwd256Tile<D>;
  constexpr int NS = Tile::NS, ATOMS = Tile::ATOMS, HALF = Tile::HALF;
  const Params& p = bp.p;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t sK = smem_u32(sm), sV = sK + Tile::TILE;
  const uint32_t sStage = sV + Tile::TILE;  // stage s: Q, dO, then lse2 and D
  const uint32_t sP = sStage + NS * Tile::DKDV_STAGE, sDS = sP + Tile::SCORE;
  const uint32_t kv_full = sDS + Tile::SCORE, full = kv_full + 8, empty = full + 8 * NS;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  const int G = p.H / p.K, GH = G / bp.groups;  // heads per block
  const int per_tile = p.B * p.K * bp.groups, r0 = blockIdx.x % per_tile;
  const int kt = blockIdx.x / per_tile;  // the first key tiles are the heaviest
  const int grp = r0 / (p.B * p.K), b = r0 / p.K % p.B, kh = r0 % p.K;
  const int k0 = kt * 64, h0 = kh * G + grp * GH;
  int lo, hi;
  q_tiles(p, k0, 64, 64, lo, hi);
  const int nq = hi - lo, steps = GH * nq;  // step i: head h0 + i / nq, query tile lo + i % nq

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < NS; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 8);  // lane 0 of each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= 8) {
    // ----------------------------------------------------------- loader --
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(W_PRODUCER_REGS));
    if (threadIdx.x == 256) {
      mbar_expect_tx(kv_full, 2 * Tile::TILE);
#pragma unroll
      for (int a = 0; a < ATOMS; ++a) {
        tma_load(sK + a * Tile::BOX, &tk, kv_full, a * W_ATOM, kh, k0, b);
        tma_load(sV + a * Tile::BOX, &tv, kv_full, a * W_ATOM, kh, k0, b);
      }
      for (int i = 0; i < steps; ++i) {
        const int s = i % NS, h = h0 + i / nq, m0 = (lo + i % nq) * 64;
        if (i >= NS) mbar_wait(empty + 8 * s, ((i / NS) - 1) & 1);
        const uint32_t st = sStage + s * Tile::DKDV_STAGE, bar = full + 8 * s;
        mbar_expect_tx(bar, 2 * Tile::TILE + 2 * Tile::ROW_BYTES);
#pragma unroll
        for (int a = 0; a < ATOMS; ++a) {
          tma_load(st + a * Tile::BOX, &tq, bar, a * W_ATOM, h, m0, b);
          tma_load(st + Tile::TILE + a * Tile::BOX, &tdo, bar, a * W_ATOM, h, m0, b);
        }
        const int64_t rows = (int64_t)(b * p.H + h) * bp.t_pad + m0;
        bulk_load(st + 2 * Tile::TILE, bp.lse2 + rows, Tile::ROW_BYTES, bar);
        bulk_load(st + 2 * Tile::TILE + Tile::ROW_BYTES, bp.dsum + rows, Tile::ROW_BYTES, bar);
      }
    }
  } else {
    // -------------------------------------------------------- consumers --
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(W_CONSUMER_REGS));
    const int wg = warp >> 2, t = lane & 3, g = lane >> 2;
    const int lrow = (warp & 3) * 16 + g;  // this thread's keys: k0 + lrow, + 8
    const float sl2 = p.scale * 1.4426950408889634f;
    const uint32_t qrows = wg * 32 * 128;  // this consumer's 32 rows of a Q or dO tile
    const uint32_t cols = wg * 2 * Tile::BOX;  // its 128 columns of a Q or dO tile

    float dv_acc[HALF / 2], dk_acc[HALF / 2];
#pragma unroll
    for (int i = 0; i < HALF / 2; ++i) dv_acc[i] = dk_acc[i] = 0.f;
    mbar_wait(kv_full, 0);

    for (int i = 0; i < steps; ++i) {
      const int s = i % NS, mq0 = (lo + i % nq) * 64 + wg * 32;  // this consumer's queries
      const uint32_t q_st = sStage + s * Tile::DKDV_STAGE, do_st = q_st + Tile::TILE;
      const float* lse2 =
          reinterpret_cast<const float*>(sm + (q_st - sK) + 2 * Tile::TILE) + wg * 32;
      const float* dsum = lse2 + 64;
      float sc[16], dp[16];
      mbar_wait(full + 8 * s, (i / NS) & 1);
      // S^T = K Q^T and dP^T = V dO^T for this consumer's 32 queries; this
      // also waits for the step before's dV and dK.
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t off = (kk >> 2) * Tile::BOX + (kk & 3) * 32;
        wgmma_ss<32>(sc, desc_sw128(sK + off, 16, 1024), desc_sw128(q_st + off + qrows, 16, 1024),
                     kk > 0);
      }
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t off = (kk >> 2) * Tile::BOX + (kk & 3) * 32;
        wgmma_ss<32>(dp, desc_sw128(sV + off, 16, 1024),
                     desc_sw128(do_st + off + qrows, 16, 1024), kk > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sc);
      fence_regs(dp);
      if (i > 0) {  // the step before's stage is read no more
        __syncwarp();
        if (lane == 0) mbar_arrive(empty + 8 * ((i - 1) % NS));
      }

      // P^T: element e of chunk j is key k0 + lrow + 8 (e >> 1), query
      // mq0 + 8 j + 2 t + (e & 1).  Masks as in flash_bwd_wgmma, on edge
      // tiles only (warpgroup-uniform): key row r sees queries [qlo, qhi).
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float2 l2 = *reinterpret_cast<const float2*>(lse2 + 8 * j + 2 * t);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          sc[4 * j + e] = ex2(fmaf(sc[4 * j + e], sl2, -((e & 1) ? l2.y : l2.x)));
      }
      if (k0 + 64 > p.Tk || (p.causal && k0 + 63 > mq0) ||
          (p.window > 0 && k0 <= mq0 + 31 - p.window)) {
        int qlo[2], qhi[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int key = k0 + lrow + 8 * r;
          qlo[r] = p.causal ? key : INT_MIN;
          qhi[r] = key >= p.Tk ? INT_MIN : p.window > 0 ? key + p.window : INT_MAX;
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int q = mq0 + 8 * j + 2 * t + (e & 1), r = e >> 1;
            sc[4 * j + e] = q >= qlo[r] && q < qhi[r] ? sc[4 * j + e] : 0.f;
          }
        }
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float2 dd = *reinterpret_cast<const float2*>(dsum + 8 * j + 2 * t);
#pragma unroll
        for (int e = 0; e < 4; ++e)  // dS^T
          dp[4 * j + e] = sc[4 * j + e] * (dp[4 * j + e] - ((e & 1) ? dd.y : dd.x));
      }

      consumers_sync(1);  // both consumers' dV and dK of the step before are done
      store_half(sm + (sP - sK), sc, lrow, wg, t);
      store_half(sm + (sDS - sK), dp, lrow, wg, t);
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      consumers_sync(2);  // both halves are written

      // dV += P^T dO and dK += dS^T Q over the step's 64 queries, this
      // consumer's 128 columns; issued and committed, waited for next step.
      wgmma_fence();
#pragma unroll
      for (int kc = 0; kc < 4; ++kc)
        wgmma_st128(dv_acc, desc_sw128(sP + kc * 32, 16, 1024),
                    desc_sw128(do_st + cols + kc * 16 * 128, Tile::BOX, 1024), 1);
#pragma unroll
      for (int kc = 0; kc < 4; ++kc)
        wgmma_st128(dk_acc, desc_sw128(sDS + kc * 32, 16, 1024),
                    desc_sw128(q_st + cols + kc * 16 * 128, Tile::BOX, 1024), 1);
      wgmma_commit();
    }
    wgmma_wait<0>();
    fence_regs(dv_acc);
    fence_regs(dk_acc);

    // This head group's fp32 partials: dK unscaled, columns 128 wg + 8 c + 2 t.
    const int64_t n_k = (int64_t)p.B * p.Tk * p.K;
    float* dk_part = bp.part + grp * n_k * p.dk;
    float* dv_part = bp.part + bp.groups * n_k * p.dk + grp * n_k * p.dv;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int key = k0 + lrow + 8 * r;
      if (key < p.Tk) {
        const int64_t base = (int64_t)(b * p.Tk + key) * p.K + kh;
#pragma unroll
        for (int c = 0; c < HALF / 8; ++c) {
          const int col = wg * HALF + 8 * c + 2 * t;
          if (col < p.dk)
            *reinterpret_cast<float2*>(dk_part + base * p.dk + col) =
                make_float2(dk_acc[4 * c + 2 * r], dk_acc[4 * c + 2 * r + 1]);
          if (col < p.dv)
            *reinterpret_cast<float2*>(dv_part + base * p.dv + col) =
                make_float2(dv_acc[4 * c + 2 * r], dv_acc[4 * c + 2 * r + 1]);
        }
      }
    }
  }
}

// The body of flash_bwd_wgmma_dq<256, 256>.
template <int D>
__device__ __forceinline__ void dq_halves(const CUtensorMap& tq, const CUtensorMap& tk,
                                          const CUtensorMap& tv, const CUtensorMap& tdo,
                                          const BwdParams& bp) {
  using Tile = Bwd256Tile<D>;
  constexpr int NS = Tile::NS, ATOMS = Tile::ATOMS, HALF = Tile::HALF;
  const Params& p = bp.p;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t sQ = smem_u32(sm), sDO = sQ + Tile::TILE;
  const uint32_t sStage = sDO + Tile::TILE;  // stage s: K, then V
  const uint32_t sDS = sStage + NS * Tile::DQ_STAGE;
  const uint32_t q_full = sDS + Tile::SCORE, full = q_full + 8, empty = full + 8 * NS;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  const int BH = p.B * p.H, nqt = bp.t_pad / 64;
  const int m0 = (nqt - 1 - blockIdx.x / BH) * 64;  // heaviest causal tiles first
  const int b = (blockIdx.x % BH) / p.H, h = blockIdx.x % p.H, kh = h / (p.H / p.K);
  int lo, hi;
  kv_tiles(p, m0, 64, 64, lo, hi);
  const int steps = hi - lo;  // step j: key tile lo + j

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < NS; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 8);  // lane 0 of each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= 8) {
    // ----------------------------------------------------------- loader --
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(W_PRODUCER_REGS));
    if (threadIdx.x == 256) {
      mbar_expect_tx(q_full, 2 * Tile::TILE);
#pragma unroll
      for (int a = 0; a < ATOMS; ++a) {
        tma_load(sQ + a * Tile::BOX, &tq, q_full, a * W_ATOM, h, m0, b);
        tma_load(sDO + a * Tile::BOX, &tdo, q_full, a * W_ATOM, h, m0, b);
      }
      for (int j = 0; j < steps; ++j) {
        const int s = j % NS, n0 = (lo + j) * 64;
        if (j >= NS) mbar_wait(empty + 8 * s, ((j / NS) - 1) & 1);
        const uint32_t st = sStage + s * Tile::DQ_STAGE, bar = full + 8 * s;
        mbar_expect_tx(bar, 2 * Tile::TILE);
#pragma unroll
        for (int a = 0; a < ATOMS; ++a) {
          tma_load(st + a * Tile::BOX, &tk, bar, a * W_ATOM, kh, n0, b);
          tma_load(st + Tile::TILE + a * Tile::BOX, &tv, bar, a * W_ATOM, kh, n0, b);
        }
      }
    }
  } else {
    // -------------------------------------------------------- consumers --
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(W_CONSUMER_REGS));
    const int wg = warp >> 2, t = lane & 3, g = lane >> 2;
    const int lrow = (warp & 3) * 16 + g;  // this thread's queries: m0 + lrow, + 8
    const float sl2 = p.scale * 1.4426950408889634f;
    const uint32_t krows = wg * 32 * 128;      // this consumer's 32 keys of a K or V tile
    const uint32_t cols = wg * 2 * Tile::BOX;  // its 128 columns of a K tile
    float l2[2], dd[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int64_t row = (int64_t)(b * p.H + h) * bp.t_pad + m0 + lrow + 8 * r;
      l2[r] = bp.lse2[row];
      dd[r] = bp.dsum[row];
    }

    float dq_acc[HALF / 2];
#pragma unroll
    for (int i = 0; i < HALF / 2; ++i) dq_acc[i] = 0.f;
    mbar_wait(q_full, 0);

    for (int j = 0; j < steps; ++j) {
      const int s = j % NS, kc0 = (lo + j) * 64 + wg * 32;  // this consumer's keys
      const uint32_t k_st = sStage + s * Tile::DQ_STAGE, v_st = k_st + Tile::TILE;
      float sc[16], dp[16];
      mbar_wait(full + 8 * s, (j / NS) & 1);
      // S = Q K^T and dP = dO V^T for this consumer's 32 keys; this also
      // waits for the step before's dQ.
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t off = (kk >> 2) * Tile::BOX + (kk & 3) * 32;
        wgmma_ss<32>(sc, desc_sw128(sQ + off, 16, 1024), desc_sw128(k_st + off + krows, 16, 1024),
                     kk > 0);
      }
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t off = (kk >> 2) * Tile::BOX + (kk & 3) * 32;
        wgmma_ss<32>(dp, desc_sw128(sDO + off, 16, 1024),
                     desc_sw128(v_st + off + krows, 16, 1024), kk > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sc);
      fence_regs(dp);
      if (j > 0) {  // the step before's stage is read no more
        __syncwarp();
        if (lane == 0) mbar_arrive(empty + 8 * ((j - 1) % NS));
      }

      // P: element e of chunk c is query m0 + lrow + 8 (e >> 1), key
      // kc0 + 8 c + 2 t + (e & 1).  Masks as in the forward's softmax_tile,
      // on edge tiles only: row r sees keys lo < key < hi.
#pragma unroll
      for (int c = 0; c < 4; ++c) {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          sc[4 * c + e] = ex2(fmaf(sc[4 * c + e], sl2, -l2[e >> 1]));
      }
      if (kc0 + 32 > p.Tk || (p.causal && kc0 + 31 > m0) ||
          (p.window > 0 && kc0 <= m0 + 63 - p.window)) {
        int klo[2], khi[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int q = m0 + lrow + 8 * r;
          khi[r] = p.causal ? min(p.Tk, q + 1) : p.Tk;
          klo[r] = p.window > 0 ? q - p.window : -1;
        }
#pragma unroll
        for (int c = 0; c < 4; ++c) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int key = kc0 + 8 * c + 2 * t + (e & 1), r = e >> 1;
            sc[4 * c + e] = key > klo[r] && key < khi[r] ? sc[4 * c + e] : 0.f;
          }
        }
      }
#pragma unroll
      for (int i = 0; i < 16; ++i) dp[i] = sc[i] * (dp[i] - dd[(i >> 1) & 1]);  // dS

      consumers_sync(1);  // both consumers' dQ of the step before is done
      store_half(sm + (sDS - sQ), dp, lrow, wg, t);
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      consumers_sync(2);  // both halves are written

      // dQ += dS K over the step's 64 keys, this consumer's 128 columns.
      wgmma_fence();
#pragma unroll
      for (int kc = 0; kc < 4; ++kc)
        wgmma_st128(dq_acc, desc_sw128(sDS + kc * 32, 16, 1024),
                    desc_sw128(k_st + cols + kc * 16 * 128, Tile::BOX, 1024), 1);
      wgmma_commit();
    }
    wgmma_wait<0>();
    fence_regs(dq_acc);

    __nv_bfloat16* out = static_cast<__nv_bfloat16*>(bp.dq);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int q = m0 + lrow + 8 * r;
      if (q < p.Tq) {
        __nv_bfloat16* row = out + ((int64_t)(b * p.Tq + q) * p.H + h) * p.dk;
#pragma unroll
        for (int c = 0; c < HALF / 8; ++c) {
          const int col = wg * HALF + 8 * c + 2 * t;
          if (col < p.dk)
            *reinterpret_cast<__nv_bfloat162*>(row + col) = __floats2bfloat162_rn(
                p.scale * dq_acc[4 * c + 2 * r], p.scale * dq_acc[4 * c + 2 * r + 1]);
        }
      }
    }
  }
}

// ------------------------------------- wgmma backward at (DK, DV) = (192, 128) --
// flash_bwd_wgmma_dkdv<192, 128> and flash_bwd_wgmma_dq<192, 128>: MLA's
// widths (128 < dk <= 192, dv <= 128; kernels/flash_attention.py::widths).
// The split and its guarantees are those of the (256, 256) kernels (no
// atomics, the head groups' partials summed in a fixed order, a run repeats
// bit for bit), but not their layout: at these widths a consumer warpgroup
// holds whole rows of its accumulators, so no product is split across the
// two consumers and they never wait for each other.
//   - dkdv: one block per (128-key tile, head group, b, KV head), heaviest
//     key tiles first; each consumer owns 64 keys and keeps dK (DK / 2 = 96
//     registers) and dV (DV / 2 = 64) of them for the whole walk.  A step
//     of 64 queries runs in two halves of 32: S^T = K Q^T (m64n32, depth DK)
//     and dP^T = V dO^T (m64n32, depth DV) with both operands in shared
//     memory, P^T and dS^T in registers, then dV += P^T dO (m64n128) and
//     dK += dS^T Q (m64n192) over the half's 32 queries with P^T and dS^T as
//     register A fragments.  Whole steps (64 registers of scores beside the
//     160) left ptxas too few of the 240 a consumer has: it spilled and
//     serialized every wgmma; halves keep the scores to 32.  K (48 KB)
//     and V (32 KB) load once; Q (24 KB), dO (16 KB), lse2 and D stream
//     through three stages: 208952 B.  With one head group the block writes
//     dk and dv in bf16 itself and no sum pass runs.
//   - dq: one block per (b, h, 128 query rows), heaviest causal tiles
//     first, in the forward's layout: each consumer owns 64 rows and keeps
//     dQ (96 registers); per step of 64 keys S = Q K^T and dP = dO V^T
//     (m64n64) from shared memory, dS in registers, dQ += dS K (m64n192, dS
//     as the A fragments).  Q (48 KB) and dO (32 KB) load once; K (24 KB)
//     and V (16 KB) stream through three stages: 205880 B.  128 rows a
//     block, not 64: every K and V tile brought from L2 serves twice the
//     rows.
// Either kernel skips the products of a step whose tile is wholly masked for
// the consumer's 64 keys or rows (the causal diagonal, a window's far edge,
// rows past Tq), and still releases its stage.
// What bounds it: seven products per unmasked pair, 4 DK + 3 DV = 1152
// multiply-adds against 1792 zero-filled to (256, 256); at deepseek-v2's
// training microbatch (B 2, T 4096, 128 heads, causal) 4.95 TFLOP, 5.004 ms
// on an H100's tensor cores.  S^T and dP^T (N 32) and S and dP (N 64) read
// both operands from shared memory, which comes close to its bandwidth; the
// other products read B only.
template <int DK, int DV>
struct BwdWholeTile {
  static constexpr int BN = 128;  // dkdv: keys per block, 64 per consumer
  static constexpr int BM = 64;   // dkdv: queries per step
  static constexpr int BQ = 128;  // dq: query rows per block, 64 per consumer
  static constexpr int BKS = 64;  // dq: keys per step
  static constexpr int NS = 3;    // stages of either kernel
  static constexpr int K_ATOMS = DK / W_ATOM, V_ATOMS = DV / W_ATOM;
  static constexpr uint32_t WIDE_BOX = 128 * 128;  // one [128][64] bf16 atom column
  static constexpr uint32_t STEP_BOX = 64 * 128;   // one [64][64] bf16 atom column
  static constexpr uint32_t ROW_BYTES = BM * 4;    // lse2 or D of one dkdv step
  // dkdv: K and V of the block's keys, then NS stages of Q, dO, and lse2
  // and D padded to the swizzle period.
  static constexpr uint32_t KEY_K = K_ATOMS * WIDE_BOX, KEY_V = V_ATOMS * WIDE_BOX;
  static constexpr uint32_t STEP_Q = K_ATOMS * STEP_BOX, STEP_DO = V_ATOMS * STEP_BOX;
  static constexpr uint32_t DKDV_STAGE = STEP_Q + STEP_DO + 1024;
  static constexpr size_t DKDV_SMEM =
      1024 + KEY_K + KEY_V + NS * (size_t)DKDV_STAGE + 8 * (1 + 2 * NS);
  // dq: Q and dO of the block's rows, then NS stages of K and V.
  static constexpr uint32_t ROWS_Q = K_ATOMS * WIDE_BOX, ROWS_DO = V_ATOMS * WIDE_BOX;
  static constexpr uint32_t STEP_K = K_ATOMS * STEP_BOX, STEP_V = V_ATOMS * STEP_BOX;
  static constexpr uint32_t DQ_STAGE = STEP_K + STEP_V;
  static constexpr size_t DQ_SMEM =
      1024 + ROWS_Q + ROWS_DO + NS * (size_t)DQ_STAGE + 8 * (1 + 2 * NS);
  static_assert(DKDV_SMEM <= 232448 && DQ_SMEM <= 232448, "over the 227 KB a block may use");
  static_assert(DK % W_ATOM == 0 && DV % W_ATOM == 0 && DK <= 192 && DV <= 128,
                "whole rows of dK and dV fit a consumer's registers up to (192, 128)");
};

// The body of flash_bwd_wgmma_dkdv<DK, DV> for DK != DV.
template <int DK, int DV>
__device__ __forceinline__ void dkdv_whole(const CUtensorMap& tq, const CUtensorMap& tk,
                                           const CUtensorMap& tv, const CUtensorMap& tdo,
                                           const BwdParams& bp) {
  using Tile = BwdWholeTile<DK, DV>;
  constexpr int NS = Tile::NS, BM = Tile::BM, K_ATOMS = Tile::K_ATOMS, V_ATOMS = Tile::V_ATOMS;
  const Params& p = bp.p;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t sK = smem_u32(sm), sV = sK + Tile::KEY_K;
  const uint32_t sStage = sV + Tile::KEY_V;  // stage s: Q, dO, then lse2 and D
  const uint32_t kv_full = sStage + NS * Tile::DKDV_STAGE, full = kv_full + 8,
                 empty = full + 8 * NS;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  // Head-major: the blocks in flight share a few (b, KV head, group)s, whose
  // Q and dO stay in L2 (with MLA's own K and V per head, tile-major order
  // would stream a different head's Q and dO from HBM into every block).
  const int G = p.H / p.K, GH = G / bp.groups;  // heads per block
  const int n_kt = (p.Tk + Tile::BN - 1) / Tile::BN, r0 = blockIdx.x / n_kt;
  const int kt = blockIdx.x % n_kt;  // each head's first key tiles are its heaviest
  const int grp = r0 / (p.B * p.K), b = r0 / p.K % p.B, kh = r0 % p.K;
  const int k0 = kt * Tile::BN, h0 = kh * G + grp * GH;
  int lo, hi;
  q_tiles(p, k0, Tile::BN, BM, lo, hi);
  const int nq = hi - lo, steps = GH * nq;  // step i: head h0 + i / nq, query tile lo + i % nq

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < NS; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 8);  // lane 0 of each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= 8) {
    // ----------------------------------------------------------- loader --
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(W_PRODUCER_REGS));
    if (threadIdx.x == 256) {
      mbar_expect_tx(kv_full, Tile::KEY_K + Tile::KEY_V);
#pragma unroll
      for (int a = 0; a < K_ATOMS; ++a)
        tma_load(sK + a * Tile::WIDE_BOX, &tk, kv_full, a * W_ATOM, kh, k0, b);
#pragma unroll
      for (int a = 0; a < V_ATOMS; ++a)
        tma_load(sV + a * Tile::WIDE_BOX, &tv, kv_full, a * W_ATOM, kh, k0, b);
      for (int i = 0; i < steps; ++i) {
        const int s = i % NS, h = h0 + i / nq, m0 = (lo + i % nq) * BM;
        if (i >= NS) mbar_wait(empty + 8 * s, ((i / NS) - 1) & 1);
        const uint32_t st = sStage + s * Tile::DKDV_STAGE, bar = full + 8 * s;
        mbar_expect_tx(bar, Tile::STEP_Q + Tile::STEP_DO + 2 * Tile::ROW_BYTES);
#pragma unroll
        for (int a = 0; a < K_ATOMS; ++a)
          tma_load(st + a * Tile::STEP_BOX, &tq, bar, a * W_ATOM, h, m0, b);
#pragma unroll
        for (int a = 0; a < V_ATOMS; ++a)
          tma_load(st + Tile::STEP_Q + a * Tile::STEP_BOX, &tdo, bar, a * W_ATOM, h, m0, b);
        const int64_t rows = (int64_t)(b * p.H + h) * bp.t_pad + m0;
        const uint32_t rs = st + Tile::STEP_Q + Tile::STEP_DO;
        bulk_load(rs, bp.lse2 + rows, Tile::ROW_BYTES, bar);
        bulk_load(rs + Tile::ROW_BYTES, bp.dsum + rows, Tile::ROW_BYTES, bar);
      }
    }
  } else {
    // -------------------------------------------------------- consumers --
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(W_CONSUMER_REGS));
    const int wg = warp >> 2, t = lane & 3, g = lane >> 2;
    const int lrow = wg * 64 + (warp & 3) * 16 + g;  // this thread's keys: k0 + lrow, + 8
    const int kw0 = k0 + wg * 64, key0 = k0 + lrow;
    const float sl2 = p.scale * 1.4426950408889634f;
    const uint32_t k_wg = sK + wg * 64 * 128, v_wg = sV + wg * 64 * 128;

    float dv_acc[DV / 2], dk_acc[DK / 2];
#pragma unroll
    for (int i = 0; i < DV / 2; ++i) dv_acc[i] = 0.f;
#pragma unroll
    for (int i = 0; i < DK / 2; ++i) dk_acc[i] = 0.f;
    mbar_wait(kv_full, 0);

    for (int i = 0; i < steps; ++i) {
      const int s = i % NS, m0 = (lo + i % nq) * BM;
      const uint32_t q_st = sStage + s * Tile::DKDV_STAGE, do_st = q_st + Tile::STEP_Q;
      mbar_wait(full + 8 * s, (i / NS) & 1);
      // Every query of the step before every key of this consumer (causal),
      // past every key's window, or no key left: nothing to add.
      const bool dead = kw0 >= p.Tk || (p.causal && m0 + 63 < kw0) ||
                        (p.window > 0 && m0 >= kw0 + 63 + p.window);
      if (!dead) {
        const float* lse2 =
            reinterpret_cast<const float*>(sm + (q_st - sK) + Tile::STEP_Q + Tile::STEP_DO);
        const float* dsum = lse2 + BM;
        // The step in two halves of 32 queries: S^T = K Q^T and dP^T = V dO^T
        // (m64n32, both operands K-major), P^T and dS^T in registers, then
        // dV += P^T dO and dK += dS^T Q over the half's two k16 steps (P^T
        // and dS^T as A fragments, B MN-major through the transpose), done
        // before the next half: the scores never take more than 32 registers
        // beside the 160 of dK and dV, and the other consumer's products
        // fill the tensor cores meanwhile.  Not unrolled: the second half's
        // addresses would take registers during the first.
#pragma unroll 1
        for (int half = 0; half < 2; ++half) {
          const uint32_t rows = half * 32 * 128;  // the half's 32 rows of a Q or dO tile
          float sc[16], dp[16];
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < DK / 16; ++kk)
            wgmma_ss<32>(sc,
                         desc_sw128(k_wg + (kk >> 2) * Tile::WIDE_BOX + (kk & 3) * 32, 16, 1024),
                         desc_sw128(q_st + rows + (kk >> 2) * Tile::STEP_BOX + (kk & 3) * 32, 16,
                                    1024),
                         kk > 0);
#pragma unroll
          for (int kk = 0; kk < DV / 16; ++kk)
            wgmma_ss<32>(dp,
                         desc_sw128(v_wg + (kk >> 2) * Tile::WIDE_BOX + (kk & 3) * 32, 16, 1024),
                         desc_sw128(do_st + rows + (kk >> 2) * Tile::STEP_BOX + (kk & 3) * 32, 16,
                                    1024),
                         kk > 0);
          wgmma_commit();
          wgmma_wait<0>();
          fence_regs(sc);
          fence_regs(dp);

          // P^T: element e of chunk j is key key0 + 8 (e >> 1), query
          // mq + 8 j + 2 t + (e & 1).  Masks as in flash_bwd_wgmma, on edge
          // halves only (warpgroup-uniform): key row r sees queries
          // [qlo, qhi).
          const int mq = m0 + 32 * half;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const float2 l2 = *reinterpret_cast<const float2*>(lse2 + 32 * half + 8 * j + 2 * t);
#pragma unroll
            for (int e = 0; e < 4; ++e)
              sc[4 * j + e] = ex2(fmaf(sc[4 * j + e], sl2, -((e & 1) ? l2.y : l2.x)));
          }
          if (kw0 + 64 > p.Tk || (p.causal && kw0 + 63 > mq) ||
              (p.window > 0 && kw0 <= mq + 31 - p.window)) {
            int qlo[2], qhi[2];
#pragma unroll
            for (int r = 0; r < 2; ++r) {
              const int key = key0 + 8 * r;
              qlo[r] = p.causal ? key : INT_MIN;
              qhi[r] = key >= p.Tk ? INT_MIN : p.window > 0 ? key + p.window : INT_MAX;
            }
#pragma unroll
            for (int j = 0; j < 4; ++j) {
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                const int q = mq + 8 * j + 2 * t + (e & 1), r = e >> 1;
                sc[4 * j + e] = q >= qlo[r] && q < qhi[r] ? sc[4 * j + e] : 0.f;
              }
            }
          }
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const float2 dd = *reinterpret_cast<const float2*>(dsum + 32 * half + 8 * j + 2 * t);
#pragma unroll
            for (int e = 0; e < 4; ++e)  // dS^T
              dp[4 * j + e] = sc[4 * j + e] * (dp[4 * j + e] - ((e & 1) ? dd.y : dd.x));
          }
          uint32_t pf[2][4], dsf[2][4];
#pragma unroll
          for (int kc = 0; kc < 2; ++kc) {
#pragma unroll
            for (int f = 0; f < 4; ++f) {
              pf[kc][f] = pack_bf16(sc[8 * kc + 2 * f], sc[8 * kc + 2 * f + 1]);
              dsf[kc][f] = pack_bf16(dp[8 * kc + 2 * f], dp[8 * kc + 2 * f + 1]);
            }
          }
          wgmma_fence();
#pragma unroll
          for (int kc = 0; kc < 2; ++kc)
            wgmma_rs<DV>(dv_acc, pf[kc],
                         desc_sw128(do_st + rows + kc * 16 * 128, Tile::STEP_BOX, 1024), 1);
#pragma unroll
          for (int kc = 0; kc < 2; ++kc)
            wgmma_rs<DK>(dk_acc, dsf[kc],
                         desc_sw128(q_st + rows + kc * 16 * 128, Tile::STEP_BOX, 1024), 1);
          wgmma_commit();
          wgmma_wait<0>();
          fence_regs(dv_acc);
          fence_regs(dk_acc);
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + 8 * s);
    }

    // One head group: dk (scaled) and dv in bf16; more: this group's fp32
    // partials (dK unscaled), summed by flash_bwd_dkdv_sum.
    const int64_t n_k = (int64_t)p.B * p.Tk * p.K;
    float* dk_part = bp.part + grp * n_k * p.dk;
    float* dv_part = bp.part + bp.groups * n_k * p.dk + grp * n_k * p.dv;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int key = key0 + 8 * r;
      if (key < p.Tk) {
        const int64_t base = (int64_t)(b * p.Tk + key) * p.K + kh;
#pragma unroll
        for (int c = 0; c < DK / 8; ++c) {
          const int col = 8 * c + 2 * t;
          if (col >= p.dk) continue;
          const float x = dk_acc[4 * c + 2 * r], y = dk_acc[4 * c + 2 * r + 1];
          if (bp.groups == 1)
            *reinterpret_cast<__nv_bfloat162*>(static_cast<__nv_bfloat16*>(bp.dk) + base * p.dk +
                                               col) = __floats2bfloat162_rn(p.scale * x, p.scale * y);
          else
            *reinterpret_cast<float2*>(dk_part + base * p.dk + col) = make_float2(x, y);
        }
#pragma unroll
        for (int c = 0; c < DV / 8; ++c) {
          const int col = 8 * c + 2 * t;
          if (col >= p.dv) continue;
          const float x = dv_acc[4 * c + 2 * r], y = dv_acc[4 * c + 2 * r + 1];
          if (bp.groups == 1)
            *reinterpret_cast<__nv_bfloat162*>(static_cast<__nv_bfloat16*>(bp.dv) + base * p.dv +
                                               col) = __floats2bfloat162_rn(x, y);
          else
            *reinterpret_cast<float2*>(dv_part + base * p.dv + col) = make_float2(x, y);
        }
      }
    }
  }
}

// The body of flash_bwd_wgmma_dq<DK, DV> for DK != DV.
template <int DK, int DV>
__device__ __forceinline__ void dq_whole(const CUtensorMap& tq, const CUtensorMap& tk,
                                         const CUtensorMap& tv, const CUtensorMap& tdo,
                                         const BwdParams& bp) {
  using Tile = BwdWholeTile<DK, DV>;
  constexpr int NS = Tile::NS, BQ = Tile::BQ, BKS = Tile::BKS;
  constexpr int K_ATOMS = Tile::K_ATOMS, V_ATOMS = Tile::V_ATOMS;
  const Params& p = bp.p;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t sQ = smem_u32(sm), sDO = sQ + Tile::ROWS_Q;
  const uint32_t sStage = sDO + Tile::ROWS_DO;  // stage s: K, then V
  const uint32_t q_full = sStage + NS * Tile::DQ_STAGE, full = q_full + 8, empty = full + 8 * NS;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  // Head-major, each head's heaviest causal tiles first: the blocks in flight
  // share a few heads, whose K and V stay in L2.
  const int nqt = (p.Tq + BQ - 1) / BQ, bh = blockIdx.x / nqt;
  const int m0 = (nqt - 1 - blockIdx.x % nqt) * BQ;
  const int b = bh / p.H, h = bh % p.H, kh = h / (p.H / p.K);
  int lo, hi;
  kv_tiles(p, m0, BQ, BKS, lo, hi);
  const int steps = hi - lo;  // step j: key tile lo + j

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < NS; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 8);  // lane 0 of each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= 8) {
    // ----------------------------------------------------------- loader --
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(W_PRODUCER_REGS));
    if (threadIdx.x == 256) {
      mbar_expect_tx(q_full, Tile::ROWS_Q + Tile::ROWS_DO);
#pragma unroll
      for (int a = 0; a < K_ATOMS; ++a)
        tma_load(sQ + a * Tile::WIDE_BOX, &tq, q_full, a * W_ATOM, h, m0, b);
#pragma unroll
      for (int a = 0; a < V_ATOMS; ++a)
        tma_load(sDO + a * Tile::WIDE_BOX, &tdo, q_full, a * W_ATOM, h, m0, b);
      for (int j = 0; j < steps; ++j) {
        const int s = j % NS, n0 = (lo + j) * BKS;
        if (j >= NS) mbar_wait(empty + 8 * s, ((j / NS) - 1) & 1);
        const uint32_t st = sStage + s * Tile::DQ_STAGE, bar = full + 8 * s;
        mbar_expect_tx(bar, Tile::DQ_STAGE);
#pragma unroll
        for (int a = 0; a < K_ATOMS; ++a)
          tma_load(st + a * Tile::STEP_BOX, &tk, bar, a * W_ATOM, kh, n0, b);
#pragma unroll
        for (int a = 0; a < V_ATOMS; ++a)
          tma_load(st + Tile::STEP_K + a * Tile::STEP_BOX, &tv, bar, a * W_ATOM, kh, n0, b);
      }
    }
  } else {
    // -------------------------------------------------------- consumers --
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(W_CONSUMER_REGS));
    const int wg = warp >> 2, t = lane & 3, g = lane >> 2;
    const int row0 = m0 + wg * 64, qpos0 = row0 + (warp & 3) * 16 + g;  // rows qpos0, + 8
    const float sl2 = p.scale * 1.4426950408889634f;
    const uint32_t q_wg = sQ + wg * 64 * 128, do_wg = sDO + wg * 64 * 128;
    // Rows past t_pad (in the second half of the last block) get P = 0, as
    // the row pass gives rows past Tq.
    float l2[2], dd[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int q = qpos0 + 8 * r;
      const int64_t row = (int64_t)(b * p.H + h) * bp.t_pad + q;
      l2[r] = q < bp.t_pad ? bp.lse2[row] : INFINITY;
      dd[r] = q < bp.t_pad ? bp.dsum[row] : 0.f;
    }

    float dq_acc[DK / 2];
#pragma unroll
    for (int i = 0; i < DK / 2; ++i) dq_acc[i] = 0.f;
    mbar_wait(q_full, 0);

    for (int j = 0; j < steps; ++j) {
      const int s = j % NS, n0 = (lo + j) * BKS;
      const uint32_t k_st = sStage + s * Tile::DQ_STAGE, v_st = k_st + Tile::STEP_K;
      mbar_wait(full + 8 * s, (j / NS) & 1);
      // No row of this consumer left, every key after every row (causal), or
      // every key before every row's window: nothing to add.
      const bool dead = row0 >= p.Tq || (p.causal && n0 > row0 + 63) ||
                        (p.window > 0 && n0 + 63 <= row0 - p.window);
      if (!dead) {
        float sc[32], dp[32];
        // S = Q K^T and dP = dO V^T, both operands K-major.
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < DK / 16; ++kk)
          wgmma_ss<64>(sc, desc_sw128(q_wg + (kk >> 2) * Tile::WIDE_BOX + (kk & 3) * 32, 16, 1024),
                       desc_sw128(k_st + (kk >> 2) * Tile::STEP_BOX + (kk & 3) * 32, 16, 1024),
                       kk > 0);
#pragma unroll
        for (int kk = 0; kk < DV / 16; ++kk)
          wgmma_ss<64>(dp, desc_sw128(do_wg + (kk >> 2) * Tile::WIDE_BOX + (kk & 3) * 32, 16, 1024),
                       desc_sw128(v_st + (kk >> 2) * Tile::STEP_BOX + (kk & 3) * 32, 16, 1024),
                       kk > 0);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(sc);
        fence_regs(dp);

        // P: element e of chunk c is query qpos0 + 8 (e >> 1), key
        // n0 + 8 c + 2 t + (e & 1).  Masks as in the forward's softmax_tile,
        // on edge tiles only: row r sees keys klo < key < khi.
#pragma unroll
        for (int c = 0; c < 8; ++c) {
#pragma unroll
          for (int e = 0; e < 4; ++e) sc[4 * c + e] = ex2(fmaf(sc[4 * c + e], sl2, -l2[e >> 1]));
        }
        if (n0 + 64 > p.Tk || (p.causal && n0 + 63 > row0) ||
            (p.window > 0 && n0 <= row0 + 63 - p.window)) {
          int klo[2], khi[2];
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int q = qpos0 + 8 * r;
            khi[r] = p.causal ? min(p.Tk, q + 1) : p.Tk;
            klo[r] = p.window > 0 ? q - p.window : -1;
          }
#pragma unroll
          for (int c = 0; c < 8; ++c) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int key = n0 + 8 * c + 2 * t + (e & 1), r = e >> 1;
              sc[4 * c + e] = key > klo[r] && key < khi[r] ? sc[4 * c + e] : 0.f;
            }
          }
        }
#pragma unroll
        for (int i = 0; i < 32; ++i) dp[i] = sc[i] * (dp[i] - dd[(i >> 1) & 1]);  // dS
        uint32_t dsf[4][4];
        pack_p<64>(dp, dsf);

        // dQ += dS K (B MN-major, read through the transpose), done before
        // the stage goes back to the loader.
        wgmma_fence();
#pragma unroll
        for (int kc = 0; kc < 4; ++kc)
          wgmma_rs<DK>(dq_acc, dsf[kc], desc_sw128(k_st + kc * 16 * 128, Tile::STEP_BOX, 1024), 1);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(dq_acc);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + 8 * s);
    }

    __nv_bfloat16* out = static_cast<__nv_bfloat16*>(bp.dq);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int q = qpos0 + 8 * r;
      if (q < p.Tq) {
        __nv_bfloat16* row = out + ((int64_t)(b * p.Tq + q) * p.H + h) * p.dk;
#pragma unroll
        for (int c = 0; c < DK / 8; ++c) {
          const int col = 8 * c + 2 * t;
          if (col < p.dk)
            *reinterpret_cast<__nv_bfloat162*>(row + col) = __floats2bfloat162_rn(
                p.scale * dq_acc[4 * c + 2 * r], p.scale * dq_acc[4 * c + 2 * r + 1]);
        }
      }
    }
  }
}

// The backward past head dim 128 in two kernels, on the head-dim halves at
// (256, 256) and on whole rows at (192, 128).
template <int DK, int DV>
__global__ void __launch_bounds__(W_THREADS, 1)
    flash_bwd_wgmma_dkdv(const __grid_constant__ CUtensorMap tq,
                         const __grid_constant__ CUtensorMap tk,
                         const __grid_constant__ CUtensorMap tv,
                         const __grid_constant__ CUtensorMap tdo, BwdParams bp) {
  if constexpr (DK == DV)
    dkdv_halves<DK>(tq, tk, tv, tdo, bp);
  else
    dkdv_whole<DK, DV>(tq, tk, tv, tdo, bp);
}

template <int DK, int DV>
__global__ void __launch_bounds__(W_THREADS, 1)
    flash_bwd_wgmma_dq(const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv,
                       const __grid_constant__ CUtensorMap tdo, BwdParams bp) {
  if constexpr (DK == DV)
    dq_halves<DK>(tq, tk, tv, tdo, bp);
  else
    dq_whole<DK, DV>(tq, tk, tv, tdo, bp);
}

// dk = scale sum_g dK part g, dv = sum_g dV part g, in bf16, group by group
// in order; 8 columns per thread (dk and dv are multiples of 8 here).
__global__ void __launch_bounds__(256) flash_bwd_dkdv_sum(BwdParams bp, int64_t nk8,
                                                          int64_t nv8) {
  const float* dk_part = bp.part;
  const float* dv_part = bp.part + bp.groups * nk8 * 8;
  for (int64_t i = blockIdx.x * 256 + threadIdx.x; i < nk8 + nv8; i += (int64_t)gridDim.x * 256) {
    const bool is_k = i < nk8;
    const int64_t j = is_k ? i : i - nk8, n8 = is_k ? nk8 : nv8;
    const float4* src = reinterpret_cast<const float4*>((is_k ? dk_part : dv_part) + j * 8);
    float4 x = src[0], y = src[1];
    for (int grp = 1; grp < bp.groups; ++grp) {
      const float4 a = src[grp * n8 * 2], c = src[grp * n8 * 2 + 1];
      x.x += a.x; x.y += a.y; x.z += a.z; x.w += a.w;
      y.x += c.x; y.y += c.y; y.z += c.z; y.w += c.w;
    }
    const float s = is_k ? bp.p.scale : 1.f;
    uint4 out;
    out.x = pack_bf16(s * x.x, s * x.y);
    out.y = pack_bf16(s * x.z, s * x.w);
    out.z = pack_bf16(s * y.x, s * y.y);
    out.w = pack_bf16(s * y.z, s * y.w);
    reinterpret_cast<uint4*>(is_k ? bp.dk : bp.dv)[j] = out;
  }
}

// cuTensorMapEncodeTiled lives in libcuda, not in the CUDA runtime.  It is
// fetched through the runtime's entry-point query, so the library links
// against nothing beyond the runtime that nvcc links anyway (no -lcuda, no
// stub library path).
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

// Rank-4 map of a contiguous bf16 [B, T, heads, d] tensor, innermost first
// (d, heads, T, B); box (64, 1, rows, 1) under the 128-byte swizzle.  Reads
// past T or d are zero-filled.  Returns 0 or the CUresult of the encoding.
int make_map(CUtensorMap* map, const void* ptr, int B, int T, int heads, int d, int rows) {
  EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return (int)CUDA_ERROR_NOT_FOUND;
  const cuuint64_t dims[4] = {(cuuint64_t)d, (cuuint64_t)heads, (cuuint64_t)T, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)d * 2, (cuuint64_t)heads * d * 2,
                                 (cuuint64_t)T * heads * d * 2};
  const cuuint32_t box[4] = {(cuuint32_t)W_ATOM, 1, (cuuint32_t)rows, 1};
  const cuuint32_t elem_strides[4] = {1, 1, 1, 1};
  return (int)encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
                     strides, box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
                     CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                     CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

// Returns a cudaError_t (0 on success), or minus the CUresult of a tensor
// map that could not be encoded.
template <int DK, int DV>
int launch_wgmma(const Params& p, cudaStream_t stream) {
  using Tile = WgmmaTile<DK, DV>;
  CUtensorMap tq, tk, tv;
  int r = make_map(&tq, p.q, p.B, p.Tq, p.H, p.dk, W_BQ);
  if (r == 0) r = make_map(&tk, p.k, p.B, p.Tk, p.K, p.dk, Tile::BK);
  if (r == 0) r = make_map(&tv, p.v, p.B, p.Tk, p.K, p.dv, Tile::BK);
  if (r != 0) return -r;
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_wgmma<DK, DV>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)Tile::SMEM);
  if (err != cudaSuccess) return (int)err;
  // One persistent block per SM (its shared memory allows no second one).
  int device, sms;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess)
    return (int)err;
  const int nwork = p.B * p.H * ((p.Tq + W_BQ - 1) / W_BQ);
  flash_fwd_wgmma<DK, DV><<<nwork < sms ? nwork : sms, W_THREADS, Tile::SMEM, stream>>>(
      tq, tk, tv, p);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_simt(const Params& p, cudaStream_t stream) {
  const size_t smem = simt_smem_bytes(p.dk, p.dv);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_simt<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  dim3 grid(p.B * p.H, (p.Tq + S_BQ - 1) / S_BQ);
  flash_fwd_simt<T><<<grid, S_THREADS, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

// Rank-2 map of the fp32 dq_acc, [rows][dk] innermost first; box (32, 64)
// (128 bytes by 64 rows) under the 128-byte swizzle, for the backward's dQ
// reductions.  Returns as make_map.
int make_dq_map(CUtensorMap* map, float* ptr, int64_t rows, int dk) {
  EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return (int)CUDA_ERROR_NOT_FOUND;
  const cuuint64_t dims[2] = {(cuuint64_t)dk, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)dk * 4};
  const cuuint32_t box[2] = {32, 64};
  const cuuint32_t elem_strides[2] = {1, 1};
  return (int)encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, ptr, dims, strides, box,
                     elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                     CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

template <int D>
int launch_bwd_wgmma(const BwdParams& bp, cudaStream_t stream) {
  using Tile = BwdTile<D>;
  const Params& p = bp.p;
  CUtensorMap tq, tk, tv, tdo, tdq;
  int r = make_map(&tq, p.q, p.B, p.Tq, p.H, p.dk, Tile::BM);
  if (r == 0) r = make_map(&tdo, bp.dout, p.B, p.Tq, p.H, p.dv, Tile::BM);
  if (r == 0) r = make_map(&tk, p.k, p.B, p.Tk, p.K, p.dk, Tile::BN);
  if (r == 0) r = make_map(&tv, p.v, p.B, p.Tk, p.K, p.dv, Tile::BN);
  if (r == 0) r = make_dq_map(&tdq, bp.dq_acc, (int64_t)p.B * p.H * bp.t_pad, p.dk);
  if (r != 0) return -r;
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_wgmma<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)Tile::SMEM);
  if (err != cudaSuccess) return (int)err;
  const int blocks = p.B * p.K * ((p.Tk + Tile::BN - 1) / Tile::BN);
  flash_bwd_wgmma<D><<<blocks, W_THREADS, Tile::SMEM, stream>>>(tq, tk, tv, tdo, tdq, bp);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const int64_t n8 = (int64_t)p.B * p.Tq * p.H * p.dk / 8;
  const int64_t grid = (n8 + 255) / 256;
  flash_bwd_dq_cast<<<(int)(grid < 4096 ? grid : 4096), 256, 0, stream>>>(bp, n8);
  return (int)cudaGetLastError();
}

// flash_bwd_dkdv_sum over the head groups' partials in bp.part.
int launch_dkdv_sum(const BwdParams& bp, cudaStream_t stream) {
  const Params& p = bp.p;
  const int64_t rows = (int64_t)p.B * p.Tk * p.K, nk8 = rows * p.dk / 8, nv8 = rows * p.dv / 8;
  const int64_t grid = (nk8 + nv8 + 255) / 256;
  flash_bwd_dkdv_sum<<<(int)(grid < 4096 ? grid : 4096), 256, 0, stream>>>(bp, nk8, nv8);
  return (int)cudaGetLastError();
}

template <int D>
int launch_bwd_wgmma_split(const BwdParams& bp, cudaStream_t stream) {
  using Tile = Bwd256Tile<D>;
  const Params& p = bp.p;
  CUtensorMap tq, tk, tv, tdo;
  int r = make_map(&tq, p.q, p.B, p.Tq, p.H, p.dk, Tile::BT);
  if (r == 0) r = make_map(&tdo, bp.dout, p.B, p.Tq, p.H, p.dv, Tile::BT);
  if (r == 0) r = make_map(&tk, p.k, p.B, p.Tk, p.K, p.dk, Tile::BT);
  if (r == 0) r = make_map(&tv, p.v, p.B, p.Tk, p.K, p.dv, Tile::BT);
  if (r != 0) return -r;
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_wgmma_dkdv<D, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)Tile::DKDV_SMEM);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(flash_bwd_wgmma_dq<D, D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)Tile::DQ_SMEM);
  if (err != cudaSuccess) return (int)err;
  const int kv_blocks = p.B * p.K * bp.groups * ((p.Tk + Tile::BT - 1) / Tile::BT);
  flash_bwd_wgmma_dkdv<D, D><<<kv_blocks, W_THREADS, Tile::DKDV_SMEM, stream>>>(tq, tk, tv, tdo,
                                                                                bp);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const int q_blocks = p.B * p.H * (bp.t_pad / Tile::BT);
  flash_bwd_wgmma_dq<D, D><<<q_blocks, W_THREADS, Tile::DQ_SMEM, stream>>>(tq, tk, tv, tdo, bp);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  return launch_dkdv_sum(bp, stream);
}

// flash_bwd_wgmma_dkdv / _dq at (192, 128), then the sum of the head groups'
// partials where there is more than one group.
template <int DK, int DV>
int launch_bwd_wgmma_whole(const BwdParams& bp, cudaStream_t stream) {
  using Tile = BwdWholeTile<DK, DV>;
  const Params& p = bp.p;
  CUtensorMap tq_step, tdo_step, tk_key, tv_key, tq_rows, tdo_rows, tk_step, tv_step;
  int r = make_map(&tq_step, p.q, p.B, p.Tq, p.H, p.dk, Tile::BM);
  if (r == 0) r = make_map(&tdo_step, bp.dout, p.B, p.Tq, p.H, p.dv, Tile::BM);
  if (r == 0) r = make_map(&tk_key, p.k, p.B, p.Tk, p.K, p.dk, Tile::BN);
  if (r == 0) r = make_map(&tv_key, p.v, p.B, p.Tk, p.K, p.dv, Tile::BN);
  if (r == 0) r = make_map(&tq_rows, p.q, p.B, p.Tq, p.H, p.dk, Tile::BQ);
  if (r == 0) r = make_map(&tdo_rows, bp.dout, p.B, p.Tq, p.H, p.dv, Tile::BQ);
  if (r == 0) r = make_map(&tk_step, p.k, p.B, p.Tk, p.K, p.dk, Tile::BKS);
  if (r == 0) r = make_map(&tv_step, p.v, p.B, p.Tk, p.K, p.dv, Tile::BKS);
  if (r != 0) return -r;
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_wgmma_dkdv<DK, DV>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)Tile::DKDV_SMEM);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(flash_bwd_wgmma_dq<DK, DV>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)Tile::DQ_SMEM);
  if (err != cudaSuccess) return (int)err;
  const int kv_blocks = p.B * p.K * bp.groups * ((p.Tk + Tile::BN - 1) / Tile::BN);
  flash_bwd_wgmma_dkdv<DK, DV><<<kv_blocks, W_THREADS, Tile::DKDV_SMEM, stream>>>(
      tq_step, tk_key, tv_key, tdo_step, bp);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const int q_blocks = p.B * p.H * ((p.Tq + Tile::BQ - 1) / Tile::BQ);
  flash_bwd_wgmma_dq<DK, DV><<<q_blocks, W_THREADS, Tile::DQ_SMEM, stream>>>(
      tq_rows, tk_step, tv_step, tdo_rows, bp);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  return bp.groups > 1 ? launch_dkdv_sum(bp, stream) : 0;
}

template <typename T>
int launch_bwd_simt(const BwdParams& bp, cudaStream_t stream) {
  const Params& p = bp.p;
  const size_t smem = simt_bwd_smem(p.dk, p.dv);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_bwd_simt_dkdv<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(flash_bwd_simt_dq<T>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  flash_bwd_simt_dkdv<T><<<dim3(p.B * p.K, (p.Tk + SB - 1) / SB), S_THREADS, smem, stream>>>(bp);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  flash_bwd_simt_dq<T><<<dim3(p.B * p.H, (p.Tq + SB - 1) / SB), S_THREADS, smem, stream>>>(bp);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_bwd_rows(const BwdParams& bp, cudaStream_t stream) {
  const int64_t rows = (int64_t)bp.p.B * bp.p.H * bp.t_pad;
  flash_bwd_rows<T><<<(int)((rows + 31) / 32), 256, 0, stream>>>(bp);
  return (int)cudaGetLastError();
}

// The wgmma instantiations, (DK, DV): kernels/flash_attention.py::widths
// names the one a shape runs.
bool known_widths(int wdk, int wdv) {
  return (wdk == wdv && (wdk == 64 || wdk == 128 || wdk == 256)) || (wdk == 192 && wdv == 128);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  variant: 0 = simt, 1 = wgmma, as
// kernels/flash_attention.py::variant chose it, and for wgmma the widths
// (wdk, wdv) of the instantiation, as kernels/flash_attention.py::widths
// chose them; those functions state which requests the wgmma variant takes.
// A wgmma request that breaks its rule, or names widths that do not cover dk
// and dv, is refused here (cudaErrorInvalidValue), never sent to another
// variant or instantiation.  lse is null, or fp32 [B, H, Tq] for each row's
// log-sum-exp (see the header).  Returns the cudaError_t of the launch (0 on
// success), or minus the CUresult of a tensor map that could not be encoded.
// The caller has checked shapes, H % K == 0, dk, dv <= 256, contiguity and
// that q, k, v, o live on the current device.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                   float* lse, int dtype, int variant, int wdk, int wdv, int B,
                                   int Tq, int Tk, int H, int K, int dk, int dv, int causal,
                                   int window, float scale, void* stream) {
  Params p{q, k, v, o, lse, B, Tq, Tk, H, K, dk, dv, causal, window, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaGetLastError();  // report this launch's error, not an earlier one's
  if (variant == 1) {
    const uintptr_t addr = (uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)o;
    if (dtype != 1 || dk % 8 || dv % 8 || addr % 16 || !known_widths(wdk, wdv) || dk > wdk ||
        dv > wdv)
      return (int)cudaErrorInvalidValue;
    if (wdk == 64) return launch_wgmma<64, 64>(p, s);
    if (wdk == 128) return launch_wgmma<128, 128>(p, s);
    if (wdk == 192) return launch_wgmma<192, 128>(p, s);
    return launch_wgmma<256, 256>(p, s);
  }
  if (dtype == 1) return launch_simt<__nv_bfloat16>(p, s);
  return launch_simt<float>(p, s);
}

// The backward: (dq, dk, dv) from q, k, v, the forward's output o and lse
// (flash_attention_fwd with a non-null lse) and the output's cotangent dout.
// dtype, variant and the widths as for the forward; variant 1 (wgmma) needs
// bf16, dk and dv multiples of 8 up to 256, 16-byte aligned q, k, v, dout,
// and widths that cover dk and dv; it is refused otherwise
// (cudaErrorInvalidValue).  lse2 and dsum are fp32 [B, H, t_pad] scratch,
// t_pad = Tq rounded up to 64.  scratch is fp32, for variant 1 only: zeros
// [B, H, t_pad, dk] (dq's sums) at widths up to 128; past them, room for the
// head groups' dK and dV, [groups, B, Tk, K, dk] then [groups, B, Tk, K,
// dv], groups a divisor of H/K (null at (192, 128) with one group, whose
// kernel writes dk and dv itself).  Returns as the forward does.
extern "C" int flash_attention_bwd(const void* q, const void* k, const void* v, const void* o,
                                   const float* lse, const void* dout, void* dq, void* dk,
                                   void* dv, float* scratch, float* lse2, float* dsum, int dtype,
                                   int variant, int wdk, int wdv, int B, int Tq, int Tk, int H,
                                   int K, int dk_, int dv_, int causal, int window, int groups,
                                   float scale, void* stream) {
  Params p{q, k, v, const_cast<void*>(o), const_cast<float*>(lse), B, Tq, Tk, H, K, dk_, dv_,
           causal, window, scale};
  const bool fused = wdk <= 128;  // flash_bwd_wgmma<64/128>; past it, flash_bwd_wgmma_dkdv / _dq
  const bool parts = !fused && (wdk == wdv || groups > 1);  // the head groups' fp32 partials
  BwdParams bp{p, dout, dq, dk, dv, fused ? scratch : nullptr, lse2, dsum, (Tq + 63) / 64 * 64,
               fused ? nullptr : scratch, groups};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaGetLastError();  // report this call's error, not an earlier one's
  if (variant == 1) {
    const uintptr_t addr = (uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)dout;
    if (dtype != 1 || dk_ % 8 || dv_ % 8 || addr % 16 || !known_widths(wdk, wdv) || dk_ > wdk ||
        dv_ > wdv || ((fused || parts) && scratch == nullptr) ||
        (!fused && (groups < 1 || (H / K) % groups)))
      return (int)cudaErrorInvalidValue;
    int err = launch_bwd_rows<__nv_bfloat16>(bp, s);
    if (err) return err;
    if (wdk == 64) return launch_bwd_wgmma<64>(bp, s);
    if (wdk == 128) return launch_bwd_wgmma<128>(bp, s);
    if (wdk == 192) return launch_bwd_wgmma_whole<192, 128>(bp, s);
    return launch_bwd_wgmma_split<256>(bp, s);
  }
  if (dtype == 1) {
    int err = launch_bwd_rows<__nv_bfloat16>(bp, s);
    return err ? err : launch_bwd_simt<__nv_bfloat16>(bp, s);
  }
  int err = launch_bwd_rows<float>(bp, s);
  return err ? err : launch_bwd_simt<float>(bp, s);
}
