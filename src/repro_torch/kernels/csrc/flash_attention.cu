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
// tile of query rows of one (b, h), stages each KV tile in shared memory and
// keeps (m, l, acc) on chip for the whole walk.  KV tiles wholly above the
// causal diagonal or wholly below the window are never visited, and masked
// scores are -inf with an explicit guard, so a fully masked tile neither
// costs work nor adds the exp(0) terms the TPU kernel later cancels.
//
// Two variants behind one entry:
//  * flash_fwd_mma<D>: bf16 with dk, dv <= 128, the serving path.  Four
//    warps, 64 query rows per block (16 per warp), 64-key tiles; QK^T and PV
//    on the tensor cores with mma.sync m16n8k16 (bf16 in, fp32 out); P stays
//    in registers between the two products (the S accumulator fragment is
//    the A fragment of PV).  dk and dv are zero-padded to D in shared memory.
//  * flash_fwd_simt<T>: fp32 (exact fp32 arithmetic, as the reference), and
//    bf16 with a head dim above 128.  CUDA-core dot products, 32x32 tiles,
//    8 threads per query row.
//
// What bounds it on an H100: at the serving shape (B 8, T 1024, H 32, K 8,
// d 64, causal) the work is 34.4 GFLOP against 84 MB of q/k/v/o, about 400
// FLOP per byte, so the tensor cores bound it (35 us at 989 TFLOP/s) and not
// memory (25 us at 3.35 TB/s).  This first version issues mma.sync from
// synchronously staged tiles; wgmma, TMA and warp specialisation, which the
// full tensor-core rate needs, are later work.  Shared memory is small
// (27 KB at D 64) so several blocks share an SM and hide each other's loads.

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
// loosest window bound its first row.
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

// ------------------------------------------------------- tensor-core variant --
constexpr int M_BQ = 64, M_BK = 64, M_THREADS = 128;  // 4 warps x 16 query rows

template <int D>
constexpr size_t mma_smem_bytes() { return 3 * (size_t)64 * (D + 8) * sizeof(uint16_t); }

__device__ __forceinline__ void mma_16816(float (&d)[4], const uint32_t (&a)[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t ld32(const uint16_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack16(uint16_t lo, uint16_t hi) {
  return (uint32_t)lo | ((uint32_t)hi << 16);
}

// Lower column in the low half, as the mma fragments expect.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Stage rows [0, 64) of a [*, w] bf16 tile into dst[64][D + 8]; rows at or
// past nvalid and columns at or past w are written as zeros.
template <int D>
__device__ __forceinline__ void stage_tile(uint16_t* dst, const uint16_t* src,
                                           int64_t row_stride, int nvalid, int w,
                                           bool vec) {
  constexpr int LD = D + 8, CH = D / 8;
  for (int i = threadIdx.x; i < 64 * CH; i += M_THREADS) {
    const int r = i / CH, c = (i % CH) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r < nvalid && c < w) {
      const uint16_t* s = src + r * row_stride + c;
      if (vec && c + 8 <= w) {
        val = *reinterpret_cast<const uint4*>(s);
      } else {
        uint16_t e[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) e[j] = c + j < w ? s[j] : 0;
        val = make_uint4(pack16(e[0], e[1]), pack16(e[2], e[3]),
                         pack16(e[4], e[5]), pack16(e[6], e[7]));
      }
    }
    *reinterpret_cast<uint4*>(dst + r * LD + c) = val;
  }
}

template <int D>
__global__ void __launch_bounds__(M_THREADS) flash_fwd_mma(Params p, int vec) {
  constexpr int LD = D + 8;  // padded rows: fragment reads hit 32 distinct banks
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint16_t* Qs = reinterpret_cast<uint16_t*>(smem_raw);  // [64][LD]
  uint16_t* Ks = Qs + 64 * LD;                            // [64][LD]
  uint16_t* Vs = Ks + 64 * LD;                            // [64][LD]

  const int q0 = (gridDim.y - 1 - blockIdx.y) * M_BQ;    // heaviest causal tiles first
  const int b = blockIdx.x / p.H, h = blockIdx.x % p.H;
  const int kh = h / (p.H / p.K);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;  // mma fragment row group / column pair
  const uint16_t* q = static_cast<const uint16_t*>(p.q);
  const uint16_t* k = static_cast<const uint16_t*>(p.k);
  const uint16_t* v = static_cast<const uint16_t*>(p.v);
  __nv_bfloat16* o = static_cast<__nv_bfloat16*>(p.o);

  stage_tile<D>(Qs, q + ((int64_t)(b * p.Tq + q0) * p.H + h) * p.dk,
                (int64_t)p.H * p.dk, p.Tq - q0, p.dk, vec);
  __syncthreads();

  const int r0 = warp * 16 + g;  // this thread's rows: r0 and r0 + 8
  uint32_t qf[D / 16][4];
#pragma unroll
  for (int kc = 0; kc < D / 16; ++kc) {
    qf[kc][0] = ld32(Qs + r0 * LD + kc * 16 + t * 2);
    qf[kc][1] = ld32(Qs + (r0 + 8) * LD + kc * 16 + t * 2);
    qf[kc][2] = ld32(Qs + r0 * LD + kc * 16 + 8 + t * 2);
    qf[kc][3] = ld32(Qs + (r0 + 8) * LD + kc * 16 + 8 + t * 2);
  }

  float acc[D / 8][4];
#pragma unroll
  for (int dn = 0; dn < D / 8; ++dn) acc[dn][0] = acc[dn][1] = acc[dn][2] = acc[dn][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};  // l: this thread's partial sums
  const int qpos[2] = {q0 + r0, q0 + r0 + 8};

  int kt_lo, kt_hi;
  kv_tiles(p, q0, M_BQ, M_BK, kt_lo, kt_hi);
  for (int kt = kt_lo; kt < kt_hi; ++kt) {
    const int k0 = kt * M_BK;
    __syncthreads();  // the previous tile's readers are done
    const int64_t kv_row = (int64_t)(b * p.Tk + k0) * p.K + kh;
    stage_tile<D>(Ks, k + kv_row * p.dk, (int64_t)p.K * p.dk, p.Tk - k0, p.dk, vec);
    stage_tile<D>(Vs, v + kv_row * p.dv, (int64_t)p.K * p.dv, p.Tk - k0, p.dv, vec);
    __syncthreads();

    // S = Q K^T: 8 fragments of 16 rows x 8 keys.
    float s[M_BK / 8][4];
#pragma unroll
    for (int j = 0; j < M_BK / 8; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
      const uint16_t* krow = Ks + (j * 8 + g) * LD + t * 2;
#pragma unroll
      for (int kc = 0; kc < D / 16; ++kc)
        mma_16816(s[j], qf[kc], ld32(krow + kc * 16), ld32(krow + kc * 16 + 8));
    }

    // Scale, mask, and the online-softmax update; element e of a fragment is
    // row r0 + 8 * (e >> 1), key k0 + j * 8 + t * 2 + (e & 1).
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < M_BK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        float x = s[j][e] * p.scale;
        if (masked(p, qpos[r], k0 + j * 8 + t * 2 + (e & 1))) x = -INFINITY;
        s[j][e] = x;
        mx[r] = fmaxf(mx[r], x);
      }
    }
    float corr[2], m_new[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      m_new[r] = fmaxf(m[r], mx[r]);
      corr[r] = m_new[r] == -INFINITY ? 1.f : __expf(m[r] - m_new[r]);
      l[r] *= corr[r];
      m[r] = m_new[r];
    }
#pragma unroll
    for (int j = 0; j < M_BK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const float pe = m_new[r] == -INFINITY ? 0.f : __expf(s[j][e] - m_new[r]);
        s[j][e] = pe;
        l[r] += pe;
      }
    }
#pragma unroll
    for (int dn = 0; dn < D / 8; ++dn) {
      acc[dn][0] *= corr[0];
      acc[dn][1] *= corr[0];
      acc[dn][2] *= corr[1];
      acc[dn][3] *= corr[1];
    }

    // O += P V: P's accumulator fragments are PV's A fragments (in bf16,
    // as the reference casts p to v's dtype); V's B fragment pairs two keys.
#pragma unroll
    for (int kc = 0; kc < M_BK / 16; ++kc) {
      const uint32_t a[4] = {pack_bf16(s[2 * kc][0], s[2 * kc][1]),
                             pack_bf16(s[2 * kc][2], s[2 * kc][3]),
                             pack_bf16(s[2 * kc + 1][0], s[2 * kc + 1][1]),
                             pack_bf16(s[2 * kc + 1][2], s[2 * kc + 1][3])};
      const uint16_t* vrow = Vs + (kc * 16 + t * 2) * LD + g;
#pragma unroll
      for (int dn = 0; dn < D / 8; ++dn) {
        const uint16_t* vp = vrow + dn * 8;
        mma_16816(acc[dn], a, pack16(vp[0], vp[LD]), pack16(vp[8 * LD], vp[9 * LD]));
      }
    }
  }

  float denom[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    denom[r] = fmaxf(l[r], 1e-30f);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (qpos[r] >= p.Tq) continue;
    __nv_bfloat16* orow = o + ((int64_t)(b * p.Tq + qpos[r]) * p.H + h) * p.dv;
#pragma unroll
    for (int dn = 0; dn < D / 8; ++dn) {
      const int c = dn * 8 + t * 2;
      if (c < p.dv) orow[c] = __float2bfloat16_rn(acc[dn][2 * r] / denom[r]);
      if (c + 1 < p.dv) orow[c + 1] = __float2bfloat16_rn(acc[dn][2 * r + 1] / denom[r]);
    }
  }
}

template <int D>
cudaError_t launch_mma(const Params& p, cudaStream_t stream) {
  constexpr size_t smem = mma_smem_bytes<D>();
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_mma<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const uintptr_t addr = (uintptr_t)p.q | (uintptr_t)p.k | (uintptr_t)p.v;
  const int vec = (addr % 16 == 0) && p.dk % 8 == 0 && p.dv % 8 == 0;
  dim3 grid(p.B * p.H, (p.Tq + M_BQ - 1) / M_BQ);
  flash_fwd_mma<D><<<grid, M_THREADS, smem, stream>>>(p, vec);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_simt(const Params& p, cudaStream_t stream) {
  const size_t smem = simt_smem_bytes(p.dk, p.dv);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_simt<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  dim3 grid(p.B * p.H, (p.Tq + S_BQ - 1) / S_BQ);
  flash_fwd_simt<T><<<grid, S_THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Returns the cudaError_t of the launch
// (0 on success).  The caller has checked shapes, H % K == 0, dk, dv <= 256,
// contiguity and that q, k, v, o live on the current device.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                   int dtype, int B, int Tq, int Tk, int H, int K,
                                   int dk, int dv, int causal, int window, float scale,
                                   void* stream) {
  Params p{q, k, v, o, B, Tq, Tk, H, K, dk, dv, causal, window, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaGetLastError();  // report this launch's error, not an earlier one's
  if (dtype == 1) {
    const int d = dk > dv ? dk : dv;
    if (d <= 64) return (int)launch_mma<64>(p, s);
    if (d <= 128) return (int)launch_mma<128>(p, s);
    return (int)launch_simt<__nv_bfloat16>(p, s);
  }
  return (int)launch_simt<float>(p, s);
}
