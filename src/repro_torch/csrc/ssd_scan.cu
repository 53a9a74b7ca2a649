// Mamba-2 SSD chunk scan forward (state-space duality) for Hopper (sm_90a).
//
// Replaces the TPU kernel `ssd_scan` (`_ssd_kernel`, line 26; the pallas_call
// wrapper, line 67) in src/repro/kernels/ssd_scan/kernel.py.  For each
// (batch b, head h) it walks the sequence in chunks of Q = min(chunk, S)
// positions with a float32 (P, N) state h carried from chunk to chunk,
// starting at zero.  Per chunk, with cum = cumsum(dt * A) over the chunk:
//   L[i,j] = exp(cum_i - cum_j) for i >= j, else 0
//   y      = (C B^T o L o dt_j) x + (C o e^cum) h^T
//   h     <- e^{cum_last} h + x^T (B o e^{cum_last - cum} dt)
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
// 780m: 2.7e8 FLOPs; one per head would be 1.3e10); for bf16 inputs it is
// exact on the bf16 tensor cores.  float32 on the tensor cores would round
// to TF32 and miss the 2e-4 limit, so this kernel runs every product on the
// CUDA cores, C B^T once per head.
//
// Design (a), fused: one block of 256 threads per (b, h), looping over the
// chunks in order with the state in shared memory (N x P float32, transposed
// so each thread reads it with stride-1 loads).  On the TPU the chunk axis
// is a sequential grid dimension with the state in VMEM scratch; here blocks
// run in no order, so a block takes the whole sequence of one (b, h) and no
// state ever leaves the SM.  A 256-row chunk of x, B and C in float32 would
// not fit in shared memory beside the Q x Q decay tile, so a chunk is
// streamed in 64-row tiles: for each 64-row tile i of outputs the block
// forms (C_i o e^cum) h^T, then for each tile j <= i (tiles above the
// diagonal are skipped: L is zero there) the 64 x 64 tile of C_i B_j^T with
// 4 x 4 register tiles per thread (float4 shared loads of C and B stored
// n-major), scales it by L and dt into shared memory, and adds its product
// with x_j.  A second pass over the chunk's tiles forms x^T (B o decay) into
// registers and updates h.  This design keeps every intermediate on chip and
// reads each input about (Q/64 + 1)/2 + 1 times from L2; its parallelism is
// B x H blocks (192 at the 780m shape, on 132 SMs) with one block per SM.
// The split form (chunk-parallel intra-chunk work, then a short sequential
// pass over chunk states) would give 8x the blocks at the cost of writing
// the per-chunk states; that, cp.async double-buffering and tensor-core
// bf16 products are later work.
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
  int S, H, P, N, chunk;
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

// Shared floats of the region that holds C n-major in the output pass and
// B (scaled by the decay) row-major in the state pass.
template <int NT>
__host__ __device__ constexpr int buf_c_floats() {
  return NT * kTS > kT * (NT + 4) ? NT * kTS : kT * (NT + 4);
}

template <int PT, int NT>
constexpr size_t smem_bytes() {
  return sizeof(float) *
         (4 * kMaxChunk + 32 + buf_c_floats<NT>() + NT * kTS +
          kT * (PT + 4) + kT * kTS + NT * (PT + 4));
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

// Rows [q0, q0 + kT) of the chunk of a (.., W) operand into dst[q][c]
// (row-major, row stride WT + 4) as float32 for c < WT, zero past qlen rows
// and for c >= W; each row scaled by scale[q0 + q] when scale is given.
template <typename T, int WT>
__device__ __forceinline__ void load_rowmajor(float* dst, const T* src,
                                              int64_t base, int64_t ss,
                                              int q0, int qlen, int W,
                                              const float* scale) {
  for (int idx = threadIdx.x; idx < kT * WT; idx += kThreads) {
    const int q = idx / WT, c = idx % WT;
    const int qq = q0 + q;
    float v = 0.f;
    if (qq < qlen && c < W) {
      v = to_f32(src[base + qq * ss + c]);
      if (scale != nullptr) v *= scale[qq];
    }
    dst[q * (WT + 4) + c] = v;
  }
}

// PT, NT: P and N rounded up to the tile widths the thread layout covers.
template <typename T, int PT, int NT>
__global__ void __launch_bounds__(kThreads)
ssd_fwd(const T* __restrict__ x, const float* __restrict__ dt,
        const float* __restrict__ A, const T* __restrict__ Bm,
        const T* __restrict__ Cm, T* __restrict__ y, const Dims d) {
  constexpr int CP = PT / 16;  // output columns (p) a thread owns
  constexpr int CN = NT / 16;  // state columns (n) a thread owns
  constexpr int XS = PT + 4;   // row stride of x (row-major) and of h^T
  extern __shared__ float4 smem4[];
  float* s_cum = reinterpret_cast<float*>(smem4);  // [kMaxChunk] cumsum
  float* s_dt = s_cum + kMaxChunk;                  // dt, 0 past the chunk
  float* s_ecum = s_dt + kMaxChunk;                 // e^cum
  float* s_dec = s_ecum + kMaxChunk;                // e^{last - cum} dt
  float* s_warp = s_dec + kMaxChunk;                // scan: warp totals
  float* buf_c = s_warp + 32;                       // C n-major | B o dec
  float* buf_b = buf_c + buf_c_floats<NT>();        // B n-major
  float* buf_x = buf_b + NT * kTS;                  // x row-major
  float* buf_m = buf_x + kT * XS;                   // M^T: [j][i]
  float* buf_h = buf_m + kT * kTS;                  // h^T: [n][p]

  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int lane = tid & 31, warp = tid >> 5;
  const int NP = (d.N + 7) & ~7;
  const float a = A[h];
  const int64_t xs = static_cast<int64_t>(d.H) * d.P;  // x, y: per position
  const int64_t x_bh = (static_cast<int64_t>(b) * d.S * d.H + h) * d.P;
  const int64_t dt_bh = static_cast<int64_t>(b) * d.S * d.H + h;
  const int64_t b_bh = b * d.b_sb + h * d.b_sh;
  const int64_t c_bh = b * d.c_sb + h * d.c_sh;

  for (int i = tid; i < NT * XS; i += kThreads) buf_h[i] = 0.f;

  for (int cs = 0; cs < d.S; cs += d.chunk) {
    const int qlen = min(d.chunk, d.S - cs);
    // ---- cum = inclusive cumsum of dt * A over the chunk (0 past qlen)
    float dtv = 0.f, v = 0.f;
    if (tid < qlen) {
      dtv = dt[dt_bh + static_cast<int64_t>(cs + tid) * d.H];
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
    s_dt[tid] = dtv;
    __syncthreads();
    const float last = s_cum[qlen - 1];
    s_ecum[tid] = expf(v);
    s_dec[tid] = expf(last - v) * dtv;
    __syncthreads();

    // ---- outputs, 64 rows at a time
    for (int i0 = 0; i0 < qlen; i0 += kT) {
      load_nmajor(buf_c, Cm, c_bh + cs * d.c_ss, d.c_ss, i0, qlen, d.N, NP);
      __syncthreads();
      // inter-chunk: e^{cum_i} sum_n C[i][n] h[p][n]
      float acc[4][CP];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int k = 0; k < CP; ++k) acc[r][k] = 0.f;
#pragma unroll 4
      for (int n = 0; n < NP; ++n) {
        const float4 c4 =
            *reinterpret_cast<const float4*>(buf_c + n * kTS + ty * 4);
        const float cr[4] = {c4.x, c4.y, c4.z, c4.w};
#pragma unroll
        for (int k = 0; k < CP; ++k) {
          const float hv = buf_h[n * XS + tx + 16 * k];
#pragma unroll
          for (int r = 0; r < 4; ++r) acc[r][k] = fmaf(cr[r], hv, acc[r][k]);
        }
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float e = s_ecum[i0 + ty * 4 + r];
#pragma unroll
        for (int k = 0; k < CP; ++k) acc[r][k] *= e;
      }

      // intra-chunk: sum_{j <= i} (C B^T o L o dt)[i][j] x[j][p]
      for (int j0 = 0; j0 <= i0; j0 += kT) {
        load_nmajor(buf_b, Bm, b_bh + cs * d.b_ss, d.b_ss, j0, qlen, d.N, NP);
        load_rowmajor<T, PT>(buf_x, x, x_bh + cs * xs, xs, j0, qlen, d.P,
                             nullptr);
        __syncthreads();
        float s[4][4];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) s[r][c] = 0.f;
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
            for (int c = 0; c < 4; ++c) s[r][c] = fmaf(cr[r], bc[c], s[r][c]);
        }
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int j = j0 + tx * 4 + c;
          const float cj = s_cum[j], dj = s_dt[j];
          float m[4];
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const int i = i0 + ty * 4 + r;
            m[r] = i >= j ? s[r][c] * expf(s_cum[i] - cj) * dj : 0.f;
          }
          *reinterpret_cast<float4*>(buf_m + (tx * 4 + c) * kTS + ty * 4) =
              make_float4(m[0], m[1], m[2], m[3]);
        }
        __syncthreads();
#pragma unroll 4
        for (int jj = 0; jj < kT; ++jj) {
          const float4 m4 =
              *reinterpret_cast<const float4*>(buf_m + jj * kTS + ty * 4);
          const float mr[4] = {m4.x, m4.y, m4.z, m4.w};
#pragma unroll
          for (int k = 0; k < CP; ++k) {
            const float xv = buf_x[jj * XS + tx + 16 * k];
#pragma unroll
            for (int r = 0; r < 4; ++r) acc[r][k] = fmaf(mr[r], xv, acc[r][k]);
          }
        }
        __syncthreads();
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = i0 + ty * 4 + r;
        if (i >= qlen) continue;
        T* row = y + x_bh + (cs + i) * xs;
#pragma unroll
        for (int k = 0; k < CP; ++k) {
          const int p = tx + 16 * k;
          if (p < d.P) store(row + p, acc[r][k]);
        }
      }
    }

    // ---- state: h <- e^{last} h + sum_q x[q]^T (B[q] e^{last - cum_q} dt_q)
    float hs[CP][CN];
#pragma unroll
    for (int k = 0; k < CP; ++k)
#pragma unroll
      for (int c = 0; c < CN; ++c) hs[k][c] = 0.f;
    for (int j0 = 0; j0 < qlen; j0 += kT) {
      load_rowmajor<T, NT>(buf_c, Bm, b_bh + cs * d.b_ss, d.b_ss, j0, qlen,
                           d.N, s_dec);
      load_rowmajor<T, PT>(buf_x, x, x_bh + cs * xs, xs, j0, qlen, d.P,
                           nullptr);
      __syncthreads();
#pragma unroll 2
      for (int q = 0; q < kT; ++q) {
        float xv[CP], bv[CN];
#pragma unroll
        for (int k = 0; k < CP; ++k) xv[k] = buf_x[q * XS + ty + 16 * k];
#pragma unroll
        for (int c = 0; c < CN; ++c) bv[c] = buf_c[q * (NT + 4) + tx + 16 * c];
#pragma unroll
        for (int k = 0; k < CP; ++k)
#pragma unroll
          for (int c = 0; c < CN; ++c) hs[k][c] = fmaf(xv[k], bv[c], hs[k][c]);
      }
      __syncthreads();
    }
    const float el = expf(last);
#pragma unroll
    for (int k = 0; k < CP; ++k)
#pragma unroll
      for (int c = 0; c < CN; ++c) {
        float* hp = buf_h + (tx + 16 * c) * XS + ty + 16 * k;
        *hp = el * *hp + hs[k][c];
      }
    __syncthreads();
  }
}

template <typename T, int PT, int NT>
cudaError_t launch(const void* x, const float* dt, const float* A,
                   const void* Bm, const void* Cm, void* y, int B,
                   const Dims& d, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<PT, NT>();
  const cudaError_t err = cudaFuncSetAttribute(
      ssd_fwd<T, PT, NT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(d.H, B);
  ssd_fwd<T, PT, NT><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), dt, A, static_cast<const T*>(Bm),
      static_cast<const T*>(Cm), static_cast<T*>(y), d);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_typed(const void* x, const float* dt, const float* A,
                         const void* Bm, const void* Cm, void* y, int B,
                         const Dims& d, cudaStream_t st) {
  const bool wide_n = d.N > 32;
  if (d.P <= 32)
    return wide_n ? launch<T, 32, 128>(x, dt, A, Bm, Cm, y, B, d, st)
                  : launch<T, 32, 32>(x, dt, A, Bm, Cm, y, B, d, st);
  if (d.P <= 64)
    return wide_n ? launch<T, 64, 128>(x, dt, A, Bm, Cm, y, B, d, st)
                  : launch<T, 64, 32>(x, dt, A, Bm, Cm, y, B, d, st);
  return wide_n ? launch<T, 128, 128>(x, dt, A, Bm, Cm, y, B, d, st)
                : launch<T, 128, 32>(x, dt, A, Bm, Cm, y, B, d, st);
}

}  // namespace

// x: (B, S, H, P) contiguous; dt: (B, S, H) float32 contiguous; A: (H,)
// float32; Bm, Cm: (B, S, H, N) with the element strides given for the
// first three dims (a head stride of 0 reads one group's B or C for every
// head) and the last dim contiguous; y: x's shape, contiguous.  x, Bm, Cm and
// y are bfloat16 (`is_bf16`) or float32.  P <= 128, N <= 128,
// 1 <= chunk <= 256.  Launches on `stream` and does not synchronise.
// Returns the CUDA error code of selecting the device or of the launch, or
// cudaErrorInvalidValue for a size it does not take (0 on success).
extern "C" int ssd_scan_fwd(const void* x, const void* dt, const void* A,
                            const void* Bm, const void* Cm, void* y,
                            int is_bf16, int B, int S, int H, int P, int N,
                            int chunk, int64_t b_sb, int64_t b_ss,
                            int64_t b_sh, int64_t c_sb, int64_t c_ss,
                            int64_t c_sh, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B <= 0 || S <= 0 || H <= 0) return 0;
  if (P <= 0 || P > 128 || N <= 0 || N > 128 || chunk <= 0 ||
      chunk > kMaxChunk || B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const Dims d{S, H, P, N, chunk, b_sb, b_ss, b_sh, c_sb, c_ss, c_sh};
  const float* dtf = static_cast<const float*>(dt);
  const float* Af = static_cast<const float*>(A);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    err = launch_typed<__nv_bfloat16>(x, dtf, Af, Bm, Cm, y, B, d, st);
  else
    err = launch_typed<float>(x, dtf, Af, Bm, Cm, y, B, d, st);
  return static_cast<int>(err);
}
