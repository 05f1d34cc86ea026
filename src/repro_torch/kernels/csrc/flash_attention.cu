// Flash-attention forward for Hopper (sm_90a), bound through a plain C entry.
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
//  * flash_fwd_wgmma<D>: bf16 with dk, dv multiples of 8 up to 256
//    and 16-byte aligned pointers, every serving shape.  D is the smallest of
//    64 / 128 / 256 that covers max(dk, dv); BK keys per KV tile (128 at
//    D 64 and 128, 64 at D 256), NS shared-memory stages (4, 3, 2), for
//    148624, 230512 and 197712 B of dynamic shared memory (WgmmaTile::SMEM).  One
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
//    Every operand tile lies in shared memory as D/64 boxes of [rows][64]
//    bf16 under the 128-byte swizzle, one swizzle atom column each, as the
//    TMA writes them (box (64, 1, rows, 1) of a rank-4 map (d, heads, T, B)).
//    The TMA zero-fills rows past T and columns past dk or dv, so tail
//    padding and head dims below D cost no code.
//  * flash_fwd_simt<T>: fp32 (exact fp32 arithmetic, as the reference), and
//    any bf16 shape the TMA cannot take (a head dim that is no multiple of
//    8, or a misaligned pointer).  CUDA-core dot products, 32x32 tiles,
//    8 threads per query row.
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
#include <math.h>
#include <stdint.h>

namespace {

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
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

// Head dim D (64, 128 or 256): BK keys per KV tile, NS shared-memory stages.
template <int D>
struct WgmmaTile {
  static constexpr int BK = D == 256 ? 64 : 128;  // the S accumulator: BK / 2 registers
  static constexpr int NS = D == 64 ? 4 : D == 128 ? 3 : 2;
  static constexpr int ATOMS = D / W_ATOM;
  static constexpr uint32_t Q_BOX = W_BQ * 128;        // bytes of one [128][64] atom column
  static constexpr uint32_t KV_BOX = BK * 128;         // bytes of one [BK][64] atom column
  static constexpr uint32_t Q_BYTES = ATOMS * Q_BOX;
  static constexpr uint32_t KV_BYTES = ATOMS * KV_BOX;  // one K or one V stage
  // Q, then NS K stages, NS V stages, then the mbarriers (Q full and empty,
  // then for each stage: K full, V full, K empty, V empty); 1024 bytes of
  // slack to align the base to the swizzle period.
  static constexpr size_t SMEM = 1024 + Q_BYTES + 2 * NS * (size_t)KV_BYTES + 8 * (2 + 4 * NS);
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

template <int D>
__global__ void __launch_bounds__(W_THREADS, 1)
    flash_fwd_wgmma(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv, Params p) {
  using Tile = WgmmaTile<D>;
  constexpr int BK = Tile::BK, NS = Tile::NS, ATOMS = Tile::ATOMS;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t sQ = (smem_u32(smem_raw) + 1023) & ~1023u;  // swizzle period
  const uint32_t sK = sQ + Tile::Q_BYTES;
  const uint32_t sV = sK + NS * Tile::KV_BYTES;
  // mbarriers, 8 bytes each: Q full, Q empty, then K full, V full, K empty,
  // V empty for each stage.
  const uint32_t q_full = sV + NS * Tile::KV_BYTES, q_empty = q_full + 8;
  const uint32_t k_full = q_empty + 8, v_full = k_full + 8 * NS;
  const uint32_t k_empty = v_full + 8 * NS, v_empty = k_empty + 8 * NS;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  // The block is persistent: it takes work tiles (128 query rows of one
  // (b, h)) w = blockIdx.x, blockIdx.x + gridDim.x, ..., heaviest causal
  // tiles first, so that one tile's last products and epilogue overlap the
  // loads of the next.  KV tiles are numbered across work tiles: the j-th
  // goes through stage j % NS in round j / NS.
  const int BH = p.B * p.H, nq = (p.Tq + W_BQ - 1) / W_BQ, nwork = BH * nq;
  auto decode = [&](int w, int& b, int& h, int& q0, int& lo, int& hi) {
    q0 = (nq - 1 - w / BH) * W_BQ;
    b = (w % BH) / p.H;
    h = w % p.H;
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
      for (int w = blockIdx.x, n = 0; w < nwork; w += gridDim.x, ++n) {
        int b, h, q0, lo, hi;
        decode(w, b, h, q0, lo, hi);
        const int kh = h / (p.H / p.K);
        if (n > 0) mbar_wait(q_empty, (n - 1) & 1);
        mbar_expect_tx(q_full, Tile::Q_BYTES);
#pragma unroll
        for (int a = 0; a < ATOMS; ++a)
          tma_load(sQ + a * Tile::Q_BOX, &tq, q_full, a * W_ATOM, h, q0, b);
        for (int kt = lo; kt < hi; ++kt, ++j) {
          const int s = j % NS;
          const uint32_t parity = ((j / NS) - 1) & 1;
          if (j >= NS) mbar_wait(k_empty + 8 * s, parity);
          mbar_expect_tx(k_full + 8 * s, Tile::KV_BYTES);
#pragma unroll
          for (int a = 0; a < ATOMS; ++a)
            tma_load(sK + s * Tile::KV_BYTES + a * Tile::KV_BOX, &tk, k_full + 8 * s, a * W_ATOM,
                     kh, kt * BK, b);
          if (j >= NS) mbar_wait(v_empty + 8 * s, parity);
          mbar_expect_tx(v_full + 8 * s, Tile::KV_BYTES);
#pragma unroll
          for (int a = 0; a < ATOMS; ++a)
            tma_load(sV + s * Tile::KV_BYTES + a * Tile::KV_BOX, &tv, v_full + 8 * s, a * W_ATOM,
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
      const uint32_t k_st = sK + (j % NS) * Tile::KV_BYTES;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t off = (kk & 3) * 32;  // k16 step inside a 128-byte atom row
        wgmma_ss<BK>(sc, desc_sw128(q_wg + (kk >> 2) * Tile::Q_BOX + off, 16, 1024),
                     desc_sw128(k_st + (kk >> 2) * Tile::KV_BOX + off, 16, 1024), kk > 0);
      }
      wgmma_commit();
    };
    // O += P V_j, issued and committed, not waited for.
    auto issue_pv = [&](float (&o)[D / 2], const uint32_t (&pf)[BK / 16][4], int j) {
      const uint32_t v_st = sV + (j % NS) * Tile::KV_BYTES;
#pragma unroll
      for (int kc = 0; kc < BK / 16; ++kc)
        wgmma_rs<D>(o, pf[kc], desc_sw128(v_st + kc * 16 * 128, Tile::KV_BOX, 1024), 1);
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
    for (int w = blockIdx.x, n = 0; w < nwork; w += gridDim.x, ++n) {
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

      float o[D / 2];
#pragma unroll
      for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
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
          for (int c = 0; c < D / 8; ++c) {
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
        if (qpos < p.Tq) {
          __nv_bfloat16* orow = out + ((int64_t)(b * p.Tq + qpos) * p.H + h) * p.dv;
#pragma unroll
          for (int c = 0; c < D / 8; ++c) {
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
template <int D>
int launch_wgmma(const Params& p, cudaStream_t stream) {
  using Tile = WgmmaTile<D>;
  CUtensorMap tq, tk, tv;
  int r = make_map(&tq, p.q, p.B, p.Tq, p.H, p.dk, W_BQ);
  if (r == 0) r = make_map(&tk, p.k, p.B, p.Tk, p.K, p.dk, Tile::BK);
  if (r == 0) r = make_map(&tv, p.v, p.B, p.Tk, p.K, p.dv, Tile::BK);
  if (r != 0) return -r;
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_wgmma<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)Tile::SMEM);
  if (err != cudaSuccess) return (int)err;
  // One persistent block per SM (its shared memory allows no second one).
  int device, sms;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess)
    return (int)err;
  const int nwork = p.B * p.H * ((p.Tq + W_BQ - 1) / W_BQ);
  flash_fwd_wgmma<D><<<nwork < sms ? nwork : sms, W_THREADS, Tile::SMEM, stream>>>(
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

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  variant: 0 = simt, 1 = wgmma, as
// kernels/flash_attention.py::variant chose it; that function states which
// requests the wgmma variant takes.  A wgmma request that breaks its rule is
// refused here (cudaErrorInvalidValue), never sent to another variant.
// Returns the cudaError_t of the launch (0 on success), or minus the
// CUresult of a tensor map that could not be encoded.  The caller has
// checked shapes, H % K == 0, dk, dv <= 256, contiguity and that q, k, v, o
// live on the current device.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                   int dtype, int variant, int B, int Tq, int Tk, int H,
                                   int K, int dk, int dv, int causal, int window, float scale,
                                   void* stream) {
  Params p{q, k, v, o, B, Tq, Tk, H, K, dk, dv, causal, window, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaGetLastError();  // report this launch's error, not an earlier one's
  if (variant == 1) {
    const uintptr_t addr = (uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)o;
    const int d = dk > dv ? dk : dv;
    if (dtype != 1 || dk % 8 || dv % 8 || addr % 16 || d > 256) return (int)cudaErrorInvalidValue;
    if (d <= 64) return launch_wgmma<64>(p, s);
    if (d <= 128) return launch_wgmma<128>(p, s);
    return launch_wgmma<256>(p, s);
  }
  if (dtype == 1) return launch_simt<__nv_bfloat16>(p, s);
  return launch_simt<float>(p, s);
}
