// Mamba-2 SSD chunk scan forward (state-space duality) for Hopper (sm_90a).
//
// Replaces the TPU kernel `ssd_scan` (`_ssd_kernel`, line 26; the pallas_call
// wrapper, line 67) in src/repro/kernels/ssd_scan/kernel.py.  For each
// (batch b, head h) the sequence is cut into NC chunks of Q = min(chunk, S)
// positions with a float32 (P, N) state h carried from chunk to chunk,
// starting at zero.  Per chunk, with cum = cumsum(dt * A) over the chunk:
//   L[i,j] = exp(cum_i - cum_j) for i >= j, else 0
//   y      = (C B^T o L o dt_j) x + (C o e^cum) h_in^T
//   h_out  = e^{cum_last} h_in + x^T (B o e^{cum_last - cum} dt)
// Every product, sum and exponential is float32 whatever the input dtype
// (x, B, C are float32 or bfloat16; dt and A float32), and y is rounded once
// to x's dtype, as the TPU kernel does with preferred_element_type=f32.
// Unlike the TPU kernel, a ragged S (S % Q != 0) is masked here: positions
// past S load as zeros with dt = 0, so they neither decay nor inject, which is
// exactly what padding with dt = 0 gives (models/mamba2.py's ssd_chunked).
// It returns no final state and has no backward, like the TPU kernel.
//
// Bound: operations.  At mamba2-780m's shape (B=4, S=2048, H=48, P=64,
// N=128, Q=256) with causal skipping, M x, (C o e^cum) h^T and
// x^T (B o decay) take Q(Q+1) P + 4 Q N P = 1.26e7 FLOPs a chunk, 1.94e10
// for the call, all with a float32 operand: 0.289 ms at the CUDA cores'
// float32 peak (67 TFLOP/s), against ~0.1 GB of bf16 inputs and output
// (0.03 ms at 3.35 TB/s).  C B^T depends only on the group (one for the
// 780m); for bf16 inputs it is exact on the bf16 tensor cores (bf16 products
// are exact in float32, and they accumulate in float32).  float32 on the
// tensor cores would round to TF32 and miss the 2e-4 limit, so float32
// inputs keep C B^T on the CUDA cores, and every other product stays there.
//
// Design: the chunk-parallel split of the Mamba-2 authors' own
// implementation, three kernels on the caller's stream, with two float32
// scratches the wrapper allocates:
//   (a) chunk_state, grid (chunk, head, batch): the chunk's cumsum, written
//       to a scratch (B, H, NC, Q), and its own state
//       x^T (B o e^{cum_last - cum} dt), P x N, written to a scratch
//       (B, H, NC, P, N): ~50 MB at the 780m shape, most of which L2 keeps
//       between the kernels.
//   (b) state_passing, grid (P*N / 256, head, batch): over the chunks in
//       order, h_in(0) = 0 and h_in(c+1) = e^{cum_last(c)} h_in(c) + h_c,
//       overwriting each chunk's own state with its input state.
//   (c) chunk_scan, grid (chunk, head, batch): y of one chunk, 64 output
//       rows at a time: (C_i o e^cum) h_in^T, then for each 64-row tile
//       j <= i (tiles above the diagonal are skipped: L is zero there) the
//       64 x 64 tile C_i B_j^T, scaled by L and dt into shared memory, and
//       its product with x_j, with 4 x CP register tiles a thread (16-byte
//       shared loads of 4 consecutive columns).  For bf16 inputs C_i and
//       B_j stay bf16 in shared memory, arriving by cp.async while the tile
//       before them computes (x_j likewise, through registers, for both
//       dtypes), and C_i B_j^T runs on the tensor cores (mma.sync
//       m16n8k16, float32 accumulate, ldmatrix fragments from padded rows);
//       the block takes ~105 KB of shared memory, so two fit on an SM.  For
//       float32 inputs C and B are staged n-major in float32 and C_i B_j^T
//       runs on the CUDA cores.
// Each output's arithmetic is that of a sequential walk over the chunks:
// the same two-level cumsum, products and state recurrence, spread over
// B x H x NC blocks (1,536 at the 780m shape).  What still bounds it: the
// float32 products run from shared memory, each tile step behind a
// __syncthreads, well below the CUDA cores' float32 peak.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kT = 64;          // positions in a tile
constexpr int kThreads = 256;   // 16 x 16 threads, 8 warps
constexpr int kMaxChunk = 256;  // one thread per chunk position in the scan
constexpr int kTS = kT + 4;     // row stride of an n-major (transposed) tile
constexpr unsigned kFull = 0xffffffffu;

struct Dims {
  int S, H, P, N, chunk, NC;
  int vec;   // B and C rows take 16-byte vector copies
  int xvec;  // and x rows
  int64_t b_sb, b_ss, b_sh;  // element strides of B over (batch, seq, head)
  int64_t c_sb, c_ss, c_sh;  // and of C; the state dim is contiguous
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// Rows [q0, q0 + kT) of the chunk of a (.., N) operand into dst[n][q]
// (n-major, row stride kTS) as float32: zero past the chunk's qlen rows and
// for n >= N, for n < NP (N rounded up to 8).  The 32 lanes of a warp take
// 8 n x 4 q, so the transposed stores hit 32 distinct banks.
template <typename T>
__device__ __forceinline__ void load_nmajor(float* dst, const T* src,
                                            int64_t base, int64_t ss, int q0,
                                            int qlen, int N, int NP) {
  const int nb = NP >> 3;
  for (int idx = threadIdx.x; idx < kT * NP; idx += kThreads) {
    const int lane = idx & 31, grp = idx >> 5;
    const int n = (grp % nb) * 8 + (lane & 7);
    const int q = (grp / nb) * 4 + (lane >> 3);
    const int qq = q0 + q;
    float v = 0.f;
    if (qq < qlen && n < N) v = to_f32(src[base + qq * ss + n]);
    dst[n * kTS + q] = v;
  }
}

// Rows [q0, q0 + kT) of the chunk of a (.., W) operand for a row-major
// float32 tile dst[q][c] (row stride WT + 4), zero past qlen rows and for
// columns >= W.  With `vec` (W a multiple of 8, every row 16-byte aligned)
// fetch() puts the thread's 16-byte vectors in flight into registers, so
// they load while the previous tile computes, and commit() stores them;
// otherwise commit() loads element by element.  Each row is scaled by
// scale[q0 + q] when scale is given.
template <typename T, int WT>
struct RowTile {
  static constexpr int kE = 16 / sizeof(T);  // elements in a vector
  static constexpr int kVecs = kT * WT / kE / kThreads;
  uint4 r[kVecs];
  int q0;

  __device__ __forceinline__ void fetch(const T* src, int64_t base,
                                        int64_t ss, int q0_, int qlen, int W,
                                        bool vec) {
    q0 = q0_;
    if (!vec) return;
#pragma unroll
    for (int k = 0; k < kVecs; ++k) {
      const int idx = threadIdx.x + k * kThreads;
      const int q = idx / (WT / kE), c = (idx % (WT / kE)) * kE;
      r[k] = q0 + q < qlen && c < W
                 ? *reinterpret_cast<const uint4*>(src + base +
                                                   (q0 + q) * ss + c)
                 : make_uint4(0u, 0u, 0u, 0u);
    }
  }

  __device__ __forceinline__ void commit(float* dst, const T* src,
                                         int64_t base, int64_t ss, int qlen,
                                         int W, bool vec,
                                         const float* scale) const {
    if (vec) {
#pragma unroll
      for (int k = 0; k < kVecs; ++k) {
        const int idx = threadIdx.x + k * kThreads;
        const int q = idx / (WT / kE), c = (idx % (WT / kE)) * kE;
        const float sc = scale != nullptr ? scale[q0 + q] : 1.f;
        const T* e = reinterpret_cast<const T*>(&r[k]);
        float* row = dst + q * (WT + 4) + c;
#pragma unroll
        for (int j = 0; j < kE; j += 4)
          *reinterpret_cast<float4*>(row + j) = make_float4(
              to_f32(e[j]) * sc, to_f32(e[j + 1]) * sc,
              to_f32(e[j + 2]) * sc, to_f32(e[j + 3]) * sc);
      }
      return;
    }
    for (int idx = threadIdx.x; idx < kT * WT; idx += kThreads) {
      const int q = idx / WT, c = idx % WT;
      float v = 0.f;
      if (q0 + q < qlen && c < W) {
        v = to_f32(src[base + (q0 + q) * ss + c]);
        if (scale != nullptr) v *= scale[q0 + q];
      }
      dst[q * (WT + 4) + c] = v;
    }
  }
};

// A thread's C columns of a row-major float32 tile row, with t its 16-way
// index: four at a time (t * 4 + 64 g + j) when C >= 4, else two (t * 2 + j),
// so each pair of quarter-warps reads a contiguous run of 16-byte vectors.
template <int C>
__device__ __forceinline__ int col_of(int k, int t) {
  return C >= 4 ? (k >> 2) * 64 + t * 4 + (k & 3) : t * 2 + k;
}

template <int C>
__device__ __forceinline__ void load_cols(float (&v)[C], const float* row,
                                          int t) {
  if constexpr (C >= 4) {
#pragma unroll
    for (int g = 0; g < C / 4; ++g) {
      const float4 f = *reinterpret_cast<const float4*>(row + g * 64 + t * 4);
      v[4 * g] = f.x;
      v[4 * g + 1] = f.y;
      v[4 * g + 2] = f.z;
      v[4 * g + 3] = f.w;
    }
  } else {
    const float2 f = *reinterpret_cast<const float2*>(row + t * 2);
    v[0] = f.x;
    v[1] = f.y;
  }
}

// ---- bf16 tiles for the tensor cores

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(a), "l"(src), "r"(valid ? 16 : 0) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Rows [q0, q0 + kT) of the chunk of a bf16 (.., N) operand into dst[q][n]
// (row-major, row stride NT + 8 elements: ldmatrix rows on distinct banks),
// zero past qlen rows and for n >= N.  With `vec` (N a multiple of 8 and
// every row 16-byte aligned) by cp.async, to be waited on; else by plain
// loads.
template <int NT>
__device__ __forceinline__ void load_bf16_tile(__nv_bfloat16* dst,
                                               const __nv_bfloat16* src,
                                               int64_t base, int64_t ss,
                                               int q0, int qlen, int N,
                                               bool vec) {
  constexpr int kRow = NT + 8;
  if (vec) {
    for (int idx = threadIdx.x; idx < kT * (NT / 8); idx += kThreads) {
      const int q = idx / (NT / 8), n = (idx % (NT / 8)) * 8;
      const bool ok = q0 + q < qlen && n < N;
      cp_async16(dst + q * kRow + n, ok ? src + base + (q0 + q) * ss + n : src,
                 ok);
    }
  } else {
    for (int idx = threadIdx.x; idx < kT * NT; idx += kThreads) {
      const int q = idx / NT, n = idx % NT;
      dst[q * kRow + n] = q0 + q < qlen && n < N
                              ? src[base + (q0 + q) * ss + n]
                              : __float2bfloat16(0.f);
    }
  }
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four 8x8 b16 matrices from shared memory; lanes 8i..8i+7 give the row
// addresses of matrix i.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a) : "memory");
}

// ---------------------------------------------------------------- (a)

template <int PT, int NT>
constexpr size_t state_smem_bytes() {
  return sizeof(float) *
         (2 * kMaxChunk + 32 + kT * (NT + 4) + kT * (PT + 4));
}

// PT, NT: P and N rounded up to the tile widths the thread layout covers.
template <typename T, int PT, int NT>
__global__ void __launch_bounds__(kThreads, 2)
chunk_state(const T* __restrict__ x, const float* __restrict__ dt,
            const float* __restrict__ A, const T* __restrict__ Bm,
            float* __restrict__ cum, float* __restrict__ states,
            const Dims d) {
  constexpr int CP = PT / 16;  // state rows (p) a thread owns
  constexpr int CN = NT / 16;  // state columns (n) a thread owns
  constexpr int XS = PT + 4;
  extern __shared__ float4 smem4[];
  float* s_cum = reinterpret_cast<float*>(smem4);  // [kMaxChunk] cumsum
  float* s_dec = s_cum + kMaxChunk;                 // e^{last - cum} dt
  float* s_warp = s_dec + kMaxChunk;                // scan: warp totals
  float* buf_b = s_warp + 32;                       // B o dec, row-major
  float* buf_x = buf_b + kT * (NT + 4);             // x row-major

  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int lane = tid & 31, warp = tid >> 5;
  const int cs = c * d.chunk, qlen = min(d.chunk, d.S - cs);
  const float a = A[h];
  const int64_t xs = static_cast<int64_t>(d.H) * d.P;  // x: per position
  const int64_t x_c = (static_cast<int64_t>(b) * d.S + cs) * xs + h * d.P;
  const int64_t b_c = b * d.b_sb + h * d.b_sh + cs * d.b_ss;
  const int64_t bh = static_cast<int64_t>(b) * d.H + h;

  // ---- cum = inclusive cumsum of dt * A over the chunk (constant past qlen)
  float dtv = 0.f, v = 0.f;
  if (tid < qlen) {
    dtv = dt[(static_cast<int64_t>(b) * d.S + cs + tid) * d.H + h];
    v = dtv * a;
  }
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float u = __shfl_up_sync(kFull, v, off);
    if (lane >= off) v += u;
  }
  if (lane == 31) s_warp[warp] = v;
  __syncthreads();
  float pre = 0.f;
  for (int w = 0; w < warp; ++w) pre += s_warp[w];
  v += pre;
  s_cum[tid] = v;
  if (tid < d.chunk) cum[(bh * d.NC + c) * d.chunk + tid] = v;
  __syncthreads();
  const float last = s_cum[qlen - 1];
  s_dec[tid] = expf(last - v) * dtv;
  __syncthreads();

  // ---- the chunk's own state: sum_q x[q]^T (B[q] e^{last - cum_q} dt_q)
  float hs[CP][CN];
#pragma unroll
  for (int k = 0; k < CP; ++k)
#pragma unroll
    for (int cc = 0; cc < CN; ++cc) hs[k][cc] = 0.f;
  RowTile<T, NT> nb;  // the next tile of B and of x, in flight
  RowTile<T, PT> nx;
  nb.fetch(Bm, b_c, d.b_ss, 0, qlen, d.N, d.vec);
  nx.fetch(x, x_c, xs, 0, qlen, d.P, d.xvec);
  for (int j0 = 0; j0 < qlen; j0 += kT) {
    nb.commit(buf_b, Bm, b_c, d.b_ss, qlen, d.N, d.vec, s_dec);
    nx.commit(buf_x, x, x_c, xs, qlen, d.P, d.xvec, nullptr);
    __syncthreads();
    if (j0 + kT < qlen) {
      nb.fetch(Bm, b_c, d.b_ss, j0 + kT, qlen, d.N, d.vec);
      nx.fetch(x, x_c, xs, j0 + kT, qlen, d.P, d.xvec);
    }
#pragma unroll 2
    for (int q = 0; q < kT; ++q) {
      float xv[CP], bv[CN];
      load_cols<CP>(xv, buf_x + q * XS, ty);
      load_cols<CN>(bv, buf_b + q * (NT + 4), tx);
#pragma unroll
      for (int k = 0; k < CP; ++k)
#pragma unroll
        for (int cc = 0; cc < CN; ++cc) hs[k][cc] = fmaf(xv[k], bv[cc], hs[k][cc]);
    }
    __syncthreads();
  }
  float* out = states + (bh * d.NC + c) * d.P * d.N;
#pragma unroll
  for (int k = 0; k < CP; ++k) {
    const int p = col_of<CP>(k, ty);
    if (p >= d.P) continue;
#pragma unroll
    for (int cc = 0; cc < CN; ++cc) {
      const int n = col_of<CN>(cc, tx);
      if (n < d.N) out[p * d.N + n] = hs[k][cc];
    }
  }
}

// ---------------------------------------------------------------- (b)

// Each thread carries one (p, n) element of one (b, h) state across the
// chunks, replacing each chunk's own state by the state entering it.
__global__ void __launch_bounds__(kThreads)
state_passing(const float* __restrict__ cum, float* __restrict__ states,
              const Dims d) {
  const int pn = d.P * d.N;
  const int e = blockIdx.x * kThreads + threadIdx.x;
  if (e >= pn) return;
  const int64_t bh = static_cast<int64_t>(blockIdx.z) * d.H + blockIdx.y;
  float* st = states + bh * d.NC * pn + e;
  const float* cm = cum + bh * d.NC * d.chunk;
  // eight chunks' loads at a time, so their latencies overlap
  float h = 0.f;
  for (int c0 = 0; c0 < d.NC; c0 += 8) {
    float own[8], el[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int c = c0 + k;
      if (c < d.NC) {
        own[k] = st[static_cast<int64_t>(c) * pn];
        const int qlen = min(d.chunk, d.S - c * d.chunk);
        el[k] = expf(cm[static_cast<int64_t>(c) * d.chunk + qlen - 1]);
      }
    }
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int c = c0 + k;
      if (c < d.NC) {
        st[static_cast<int64_t>(c) * pn] = h;
        h = el[k] * h + own[k];
      }
    }
  }
}

// ---------------------------------------------------------------- (c)

template <typename T, int PT, int NT>
struct ScanSmem {
  static constexpr bool kBf16 = sizeof(T) == 2;
  // C_i and B_j: bf16 row-major (row NT + 8) or float32 n-major (row kTS)
  static constexpr size_t kOperand =
      kBf16 ? sizeof(__nv_bfloat16) * kT * (NT + 8) : sizeof(float) * NT * kTS;
  static constexpr size_t kBytes =
      sizeof(float) * (3 * kMaxChunk + NT * (PT + 4) + kT * (PT + 4) +
                       kT * kTS) + 2 * kOperand;
};

template <typename T, int PT, int NT, int MIN_BLOCKS>
__global__ void __launch_bounds__(kThreads, MIN_BLOCKS)
chunk_scan(const T* __restrict__ x, const float* __restrict__ dt,
           const T* __restrict__ Bm, const T* __restrict__ Cm,
           const float* __restrict__ cum, const float* __restrict__ states,
           T* __restrict__ y, const Dims d) {
  using Smem = ScanSmem<T, PT, NT>;
  constexpr bool kBf16 = Smem::kBf16;
  constexpr int CP = PT / 16;  // output columns (p) a thread owns
  constexpr int XS = PT + 4;   // row stride of x (row-major) and of h^T
  constexpr int kRowB = NT + 8;  // bf16 operand row
  extern __shared__ float4 smem4[];
  float* s_cum = reinterpret_cast<float*>(smem4);  // [kMaxChunk] cumsum
  float* s_dt = s_cum + kMaxChunk;                  // dt, 0 past the chunk
  float* s_ecum = s_dt + kMaxChunk;                 // e^cum
  float* buf_h = s_ecum + kMaxChunk;                // h_in^T: [n][p]
  float* buf_x = buf_h + NT * XS;                   // x row-major
  float* buf_m = buf_x + kT * XS;                   // M^T: [j][i]
  unsigned char* ops = reinterpret_cast<unsigned char*>(buf_m + kT * kTS);
  // C_i and B_j in the layout of the dtype's C B^T path
  float* buf_c = reinterpret_cast<float*>(ops);
  float* buf_b = reinterpret_cast<float*>(ops + Smem::kOperand);
  __nv_bfloat16* sC = reinterpret_cast<__nv_bfloat16*>(ops);
  __nv_bfloat16* sB = reinterpret_cast<__nv_bfloat16*>(ops + Smem::kOperand);

  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int lane = tid & 31, warp = tid >> 5;
  const int NP = (d.N + 7) & ~7;
  const int cs = c * d.chunk, qlen = min(d.chunk, d.S - cs);
  const int64_t xs = static_cast<int64_t>(d.H) * d.P;  // x, y: per position
  const int64_t x_c = (static_cast<int64_t>(b) * d.S + cs) * xs + h * d.P;
  const int64_t b_c = b * d.b_sb + h * d.b_sh + cs * d.b_ss;
  const int64_t c_c = b * d.c_sb + h * d.c_sh + cs * d.c_ss;
  const int64_t bh = static_cast<int64_t>(b) * d.H + h;

  if (tid < kMaxChunk) {
    const float v = tid < d.chunk ? cum[(bh * d.NC + c) * d.chunk + tid] : 0.f;
    s_cum[tid] = v;
    s_dt[tid] = tid < qlen
        ? dt[(static_cast<int64_t>(b) * d.S + cs + tid) * d.H + h] : 0.f;
    s_ecum[tid] = expf(v);
  }
  // the state entering the chunk, transposed (zero for the first chunk)
  const float* hin = states + (bh * d.NC + c) * d.P * d.N;
  for (int idx = tid; idx < NT * PT; idx += kThreads) {
    const int n = idx % NT, p = idx / NT;
    buf_h[n * XS + p] = c > 0 && n < d.N && p < d.P ? hin[p * d.N + n] : 0.f;
  }

  // Every tile is in flight before it is needed: x by registers, and for
  // bf16 C_i and B_j by cp.async, each issued once the tile it replaces is
  // consumed.
  RowTile<T, PT> nx;
  nx.fetch(x, x_c, xs, 0, qlen, d.P, d.xvec);
  if constexpr (kBf16) {
    load_bf16_tile<NT>(sC, Cm, c_c, d.c_ss, 0, qlen, d.N, d.vec);
    load_bf16_tile<NT>(sB, Bm, b_c, d.b_ss, 0, qlen, d.N, d.vec);
    cp_async_commit();
  }
  for (int i0 = 0; i0 < qlen; i0 += kT) {
    if constexpr (kBf16) {
      cp_async_wait_all();
    } else {
      load_nmajor(buf_c, Cm, c_c, d.c_ss, i0, qlen, d.N, NP);
    }
    __syncthreads();
    // inter-chunk: e^{cum_i} sum_n C[i][n] h[p][n]
    float acc[4][CP];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int k = 0; k < CP; ++k) acc[r][k] = 0.f;
    if (c > 0) {
      if constexpr (kBf16) {
        for (int n0 = 0; n0 < NT; n0 += 4) {
          float cr[4][4];
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const uint2 u = *reinterpret_cast<const uint2*>(
                sC + (ty * 4 + r) * kRowB + n0);
            const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&u);
#pragma unroll
            for (int nn = 0; nn < 4; ++nn) cr[r][nn] = __bfloat162float(e[nn]);
          }
#pragma unroll
          for (int nn = 0; nn < 4; ++nn) {
            float hv[CP];
            load_cols<CP>(hv, buf_h + (n0 + nn) * XS, tx);
#pragma unroll
            for (int k = 0; k < CP; ++k)
#pragma unroll
              for (int r = 0; r < 4; ++r)
                acc[r][k] = fmaf(cr[r][nn], hv[k], acc[r][k]);
          }
        }
      } else {
#pragma unroll 4
        for (int n = 0; n < NP; ++n) {
          const float4 c4 =
              *reinterpret_cast<const float4*>(buf_c + n * kTS + ty * 4);
          const float cr[4] = {c4.x, c4.y, c4.z, c4.w};
          float hv[CP];
          load_cols<CP>(hv, buf_h + n * XS, tx);
#pragma unroll
          for (int k = 0; k < CP; ++k)
#pragma unroll
            for (int r = 0; r < 4; ++r) acc[r][k] = fmaf(cr[r], hv[k], acc[r][k]);
        }
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float e = s_ecum[i0 + ty * 4 + r];
#pragma unroll
        for (int k = 0; k < CP; ++k) acc[r][k] *= e;
      }
    }

    // intra-chunk: sum_{j <= i} (C B^T o L o dt)[i][j] x[j][p]
    for (int j0 = 0; j0 <= i0; j0 += kT) {
      nx.commit(buf_x, x, x_c, xs, qlen, d.P, d.xvec, nullptr);
      if constexpr (kBf16) {
        cp_async_wait_all();  // B_j
      } else {
        load_nmajor(buf_b, Bm, b_c, d.b_ss, j0, qlen, d.N, NP);
      }
      __syncthreads();
      if constexpr (kBf16) {
        // C_i B_j^T on the tensor cores: warp w takes rows 16 (w % 4) and
        // keys 32 (w / 4) of the 64 x 64 tile
        const int wr = 16 * (warp & 3), jc = 32 * (warp >> 2);
        const int grp = lane >> 2, tig = lane & 3;
        float cb[4][4];
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
          cb[nt][0] = cb[nt][1] = cb[nt][2] = cb[nt][3] = 0.f;
#pragma unroll
        for (int kk = 0; kk < NT / 16; ++kk) {
          uint32_t fa[4];
          ldmatrix_x4(fa, sC + (wr + (lane & 15)) * kRowB + kk * 16 +
                              (lane >> 4) * 8);
#pragma unroll
          for (int np = 0; np < 2; ++np) {
            uint32_t fb[4];  // b0, b1 of key tiles 2np and 2np + 1
            ldmatrix_x4(fb, sB + (jc + np * 16 + (lane >> 4) * 8 +
                                  (lane & 7)) * kRowB +
                                kk * 16 + ((lane >> 3) & 1) * 8);
            mma_bf16(cb[2 * np], fa, fb[0], fb[1]);
            mma_bf16(cb[2 * np + 1], fa, fb[2], fb[3]);
          }
        }
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int il = wr + grp + 8 * (e >> 1);
            const int jl = jc + nt * 8 + tig * 2 + (e & 1);
            const int i = i0 + il, j = j0 + jl;
            buf_m[jl * kTS + il] =
                i >= j ? cb[nt][e] * expf(s_cum[i] - s_cum[j]) * s_dt[j]
                       : 0.f;
          }
      } else {
        float s[4][4];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int cc = 0; cc < 4; ++cc) s[r][cc] = 0.f;
#pragma unroll 4
        for (int n = 0; n < NP; ++n) {
          const float4 c4 =
              *reinterpret_cast<const float4*>(buf_c + n * kTS + ty * 4);
          const float4 b4 =
              *reinterpret_cast<const float4*>(buf_b + n * kTS + tx * 4);
          const float cr[4] = {c4.x, c4.y, c4.z, c4.w};
          const float bc[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int cc = 0; cc < 4; ++cc)
              s[r][cc] = fmaf(cr[r], bc[cc], s[r][cc]);
        }
#pragma unroll
        for (int cc = 0; cc < 4; ++cc) {
          const int j = j0 + tx * 4 + cc;
          const float cj = s_cum[j], dj = s_dt[j];
          float m[4];
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const int i = i0 + ty * 4 + r;
            m[r] = i >= j ? s[r][cc] * expf(s_cum[i] - cj) * dj : 0.f;
          }
          *reinterpret_cast<float4*>(buf_m + (tx * 4 + cc) * kTS + ty * 4) =
              make_float4(m[0], m[1], m[2], m[3]);
        }
      }
      __syncthreads();
      // the next tiles stream in while M x_j runs (C_i and B_j are
      // consumed): x and B of tile j + 1, or x, C and B of the next row
      // tile's first step
      const bool more_j = j0 + kT <= i0;
      const bool more_i = !more_j && i0 + kT < qlen;
      if (more_j || more_i)
        nx.fetch(x, x_c, xs, more_j ? j0 + kT : 0, qlen, d.P, d.xvec);
      if constexpr (kBf16) {
        if (more_i)
          load_bf16_tile<NT>(sC, Cm, c_c, d.c_ss, i0 + kT, qlen, d.N, d.vec);
        if (more_j || more_i) {
          load_bf16_tile<NT>(sB, Bm, b_c, d.b_ss, more_j ? j0 + kT : 0, qlen,
                             d.N, d.vec);
          cp_async_commit();
        }
      }
#pragma unroll 4
      for (int jj = 0; jj < kT; ++jj) {
        const float4 m4 =
            *reinterpret_cast<const float4*>(buf_m + jj * kTS + ty * 4);
        const float mr[4] = {m4.x, m4.y, m4.z, m4.w};
        float xv[CP];
        load_cols<CP>(xv, buf_x + jj * XS, tx);
#pragma unroll
        for (int k = 0; k < CP; ++k)
#pragma unroll
          for (int r = 0; r < 4; ++r) acc[r][k] = fmaf(mr[r], xv[k], acc[r][k]);
      }
      __syncthreads();
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = i0 + ty * 4 + r;
      if (i >= qlen) continue;
      T* row = y + x_c + static_cast<int64_t>(i) * xs;
#pragma unroll
      for (int k = 0; k < CP; ++k) {
        const int p = col_of<CP>(k, tx);
        if (p < d.P) store(row + p, acc[r][k]);
      }
    }
  }
}

template <typename T, int PT, int NT>
cudaError_t launch(const void* x, const float* dt, const float* A,
                   const void* Bm, const void* Cm, void* y, float* cum,
                   float* states, int B, const Dims& d, cudaStream_t stream) {
  const T* xt = static_cast<const T*>(x);
  const T* bt = static_cast<const T*>(Bm);
  const T* ct = static_cast<const T*>(Cm);
  const dim3 grid(d.NC, d.H, B);

  constexpr size_t state_smem = state_smem_bytes<PT, NT>();
  cudaError_t err = cudaFuncSetAttribute(
      chunk_state<T, PT, NT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(state_smem));
  if (err != cudaSuccess) return err;
  chunk_state<T, PT, NT><<<grid, kThreads, state_smem, stream>>>(
      xt, dt, A, bt, cum, states, d);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const dim3 pass_grid((d.P * d.N + kThreads - 1) / kThreads, d.H, B);
  state_passing<<<pass_grid, kThreads, 0, stream>>>(cum, states, d);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  // two blocks an SM where the bf16 block's ~105 KB allow it
  constexpr int kMin = sizeof(T) == 2 && PT <= 64 ? 2 : 1;
  constexpr size_t scan_smem = ScanSmem<T, PT, NT>::kBytes;
  err = cudaFuncSetAttribute(chunk_scan<T, PT, NT, kMin>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(scan_smem));
  if (err != cudaSuccess) return err;
  chunk_scan<T, PT, NT, kMin><<<grid, kThreads, scan_smem, stream>>>(
      xt, dt, bt, ct, cum, states, static_cast<T*>(y), d);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_typed(const void* x, const float* dt, const float* A,
                         const void* Bm, const void* Cm, void* y, float* cum,
                         float* states, int B, const Dims& d,
                         cudaStream_t st) {
  const bool wide_n = d.N > 32;
  if (d.P <= 32)
    return wide_n
        ? launch<T, 32, 128>(x, dt, A, Bm, Cm, y, cum, states, B, d, st)
        : launch<T, 32, 32>(x, dt, A, Bm, Cm, y, cum, states, B, d, st);
  if (d.P <= 64)
    return wide_n
        ? launch<T, 64, 128>(x, dt, A, Bm, Cm, y, cum, states, B, d, st)
        : launch<T, 64, 32>(x, dt, A, Bm, Cm, y, cum, states, B, d, st);
  return wide_n
      ? launch<T, 128, 128>(x, dt, A, Bm, Cm, y, cum, states, B, d, st)
      : launch<T, 128, 32>(x, dt, A, Bm, Cm, y, cum, states, B, d, st);
}

}  // namespace

// x: (B, S, H, P) contiguous; dt: (B, S, H) float32 contiguous; A: (H,)
// float32; Bm, Cm: (B, S, H, N) with the element strides given for the
// first three dims (a head stride of 0 reads one group's B or C for every
// head) and the last dim contiguous; y: x's shape, contiguous.  x, Bm, Cm and
// y are bfloat16 (`is_bf16`) or float32.  cum: float32 scratch of
// B * H * NC * Q elements and states: float32 scratch of B * H * NC * P * N,
// where Q = min(chunk, S) and NC = ceil(S / Q).  P <= 128, N <= 128,
// 1 <= chunk <= 256.  Launches three kernels on `stream` and does not
// synchronise.  Returns the CUDA error code of selecting the device or of
// a launch, or cudaErrorInvalidValue for a size it does not take (0 on
// success).
extern "C" int ssd_scan_fwd(const void* x, const void* dt, const void* A,
                            const void* Bm, const void* Cm, void* y,
                            void* cum, void* states, int is_bf16, int B,
                            int S, int H, int P, int N, int chunk,
                            int64_t b_sb, int64_t b_ss, int64_t b_sh,
                            int64_t c_sb, int64_t c_ss, int64_t c_sh,
                            int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B <= 0 || S <= 0 || H <= 0) return 0;
  if (P <= 0 || P > 128 || N <= 0 || N > 128 || chunk <= 0 ||
      chunk > kMaxChunk || B > 65535 || H > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const int q = chunk < S ? chunk : S;
  const int nc = (S + q - 1) / q;
  // 16-byte vectors of B and C rows (cp.async on the bf16 path): N a
  // multiple of 8, every stride a multiple of 8 elements and both bases
  // 16-byte aligned; of x rows: P a multiple of 8 and the base aligned
  const bool vec =
      N % 8 == 0 && b_sb % 8 == 0 && b_ss % 8 == 0 && b_sh % 8 == 0 &&
      c_sb % 8 == 0 && c_ss % 8 == 0 && c_sh % 8 == 0 &&
      reinterpret_cast<uintptr_t>(Bm) % 16 == 0 &&
      reinterpret_cast<uintptr_t>(Cm) % 16 == 0;
  const bool xvec = P % 8 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const Dims d{S, H, P, N, q, nc, vec ? 1 : 0, xvec ? 1 : 0, b_sb, b_ss,
               b_sh, c_sb, c_ss, c_sh};
  const float* dtf = static_cast<const float*>(dt);
  const float* Af = static_cast<const float*>(A);
  float* cumf = static_cast<float*>(cum);
  float* stf = static_cast<float*>(states);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    err = launch_typed<__nv_bfloat16>(x, dtf, Af, Bm, Cm, y, cumf, stf, B, d,
                                      st);
  else
    err = launch_typed<float>(x, dtf, Af, Bm, Cm, y, cumf, stf, B, d, st);
  return static_cast<int>(err);
}
