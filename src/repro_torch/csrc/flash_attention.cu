// Flash attention forward (causal or full, grouped-query) for Hopper (sm_90a).
//
// Replaces the TPU kernel `flash_attention_fwd` (`_flash_kernel`) in
// src/repro/kernels/flash_attention/kernel.py.  q is (B, Sq, G, R, hd), k and
// v are (B, Sk, G, hd), all contiguous; the output has q's shape and dtype.
// Like the TPU kernel it scales q in its own dtype, keeps the online-softmax
// state (m, l, acc) in float32, masks with -1e30 (query position i sees keys
// 0..i when causal, with no offset between Sq and Sk), rounds p to the input
// dtype before the P.V product, skips key tiles above the diagonal, and
// divides by max(l, 1e-30) at the end.  Unlike it, ragged Sq and Sk are
// masked here instead of asserted, so every prompt length runs.
//
// Bound: operations.  Causal attention at qwen2-0.5b's prefill shape
// (B=4, S=2048, 14 heads in 2 groups, hd=64) is about 3.0e10 FLOPs against
// 34 MB of q, k, v and output, far above the card's 295 FLOP/byte ridge in
// bf16.
//
// Design: one block of 4 warps per (b, g, 64 flattened q*R rows).  As on the
// TPU, the R query heads of a group are flattened into rows, so every key and
// value tile is staged in shared memory once and serves all R heads.  Each
// warp owns 16 rows.
//   * bf16: both products run on the tensor cores with
//     mma.sync.m16n8k16 (bf16 in, float32 accumulate).  The scaled q tile is
//     held in registers as A fragments; the score accumulator's layout is the
//     A-fragment layout of the P.V product, so p never leaves registers.
//     Key/value tiles of 64 rows arrive by cp.async into two stages, the next
//     loading while this one computes; fragments come from padded
//     (conflict-free) rows by ldmatrix (.trans for v).  m and l live in
//     registers, reduced across the 4 threads of a quad with shuffles; the
//     softmax runs in base 2.  Only tiles that cross the diagonal or the end
//     of the keys are masked.  The output goes out through shared memory in
//     16-byte rows.
//   * float32: the tensor cores would round to TF32, so the products run on
//     the CUDA cores: lane j scores key j of a 32-key tile against the warp's
//     16 rows (q and k from padded shared memory, conflict-free), then each
//     lane accumulates its hd/32 output columns from p staged in shared
//     memory.
// wgmma, TMA and warp specialisation are later work.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kRows = 64;  // flattened q*R rows per block
constexpr int kWarps = 4;  // 16 rows per warp
constexpr int kThreads = kWarps * 32;
constexpr unsigned kFull = 0xffffffffu;

struct Dims {
  int B, Sq, Sk, G, R, causal;
  float scale;
};

// Offsets of a flattened q row and of a key row, in elements.
__device__ __forceinline__ int64_t q_offset(const Dims& d, int b, int g,
                                            int64_t row, int hd) {
  const int64_t qpos = row / d.R, r = row % d.R;
  return ((static_cast<int64_t>(b) * d.Sq + qpos) * d.G + g) * d.R * hd +
         r * hd;
}

__device__ __forceinline__ int64_t k_offset(const Dims& d, int b, int g,
                                            int64_t kpos, int hd) {
  return ((static_cast<int64_t>(b) * d.Sk + kpos) * d.G + g) * hd;
}

// The number of key positions the block's rows can see: all of Sk, or up
// to the last row's query position when causal (tiles past it are skipped).
__device__ __forceinline__ int kv_extent(const Dims& d, int64_t row0,
                                         int64_t n_rows) {
  int64_t last = row0 + kRows;
  if (last > n_rows) last = n_rows;
  int64_t end = d.Sk;
  if (d.causal && (last - 1) / d.R + 1 < end) end = (last - 1) / d.R + 1;
  return static_cast<int>(end);
}

__device__ __forceinline__ bool visible(const Dims& d, int kpos, int qpos) {
  return kpos < d.Sk && (!d.causal || kpos <= qpos);
}

// ---------------------------------------------------------------- bf16

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four 8x8 b16 matrices from shared memory; lanes 8i..8i+7 give the row
// addresses of matrix i.  With .trans each matrix arrives transposed.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a) : "memory");
}

// 16 bytes global -> shared without passing through registers; zeros
// when !valid (the source is then not read).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(a), "l"(src), "r"(valid ? 16 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// Two values as one 32-bit register, the first in the low half.
__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

constexpr int kKeysBf16 = 64;  // keys per tile

// Shared memory of the bf16 kernel: the q tile, then two stages of k and v.
template <int HD>
constexpr size_t bf16_smem_bytes() {
  return sizeof(__nv_bfloat16) * (HD + 8) * (kRows + 4 * kKeysBf16);
}

template <int HD>
__global__ void __launch_bounds__(kThreads)
flash_fwd_bf16(const __nv_bfloat16* __restrict__ q,
               const __nv_bfloat16* __restrict__ k,
               const __nv_bfloat16* __restrict__ v,
               __nv_bfloat16* __restrict__ o, Dims d) {
  constexpr int kKeys = kKeysBf16;
  constexpr int kStride = HD + 8;     // padded row: conflict-free ldmatrix
  constexpr int kTile = kKeys * kStride;
  constexpr int kVecPerRow = HD / 8;  // 16-byte vectors per row
  constexpr float kLog2e = 1.4426950408889634f;
  extern __shared__ __align__(16) unsigned char smem_bf16[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem_bf16);
  __nv_bfloat16* sK = sQ + kRows * kStride;  // stages 0, 1
  __nv_bfloat16* sV = sK + 2 * kTile;        // stages 0, 1

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int grp = lane >> 2, tig = lane & 3;
  const int g = blockIdx.y, b = blockIdx.z;
  const int64_t n_rows = static_cast<int64_t>(d.Sq) * d.R;
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * kRows;
  const int wr = warp * 16;
  const int kv_end = kv_extent(d, row0, n_rows);

  auto load_tile = [&](int k0, int stage) {
    for (int i = tid; i < kKeys * kVecPerRow; i += kThreads) {
      const int kr = i / kVecPerRow, c = (i % kVecPerRow) * 8;
      const bool ok = k0 + kr < d.Sk;
      const int64_t off = ok ? k_offset(d, b, g, k0 + kr, HD) + c : 0;
      cp_async16(sK + stage * kTile + kr * kStride + c, k + off, ok);
      cp_async16(sV + stage * kTile + kr * kStride + c, v + off, ok);
    }
    cp_async_commit();
  };
  load_tile(0, 0);  // in flight while q is staged

  // q tile, scaled in bf16 as the TPU kernel does
  for (int i = tid; i < kRows * kVecPerRow; i += kThreads) {
    const int rr = i / kVecPerRow, c = (i % kVecPerRow) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + rr < n_rows)
      val = *reinterpret_cast<const uint4*>(
          q + q_offset(d, b, g, row0 + rr, HD) + c);
    __nv_bfloat16* e = reinterpret_cast<__nv_bfloat16*>(&val);
#pragma unroll
    for (int j = 0; j < 8; ++j)
      e[j] = __float2bfloat16(__bfloat162float(e[j]) * d.scale);
    *reinterpret_cast<uint4*>(sQ + rr * kStride + c) = val;
  }
  __syncthreads();
  uint32_t qa[HD / 16][4];
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk)
    ldmatrix_x4(qa[kk], sQ + (wr + (lane & 15)) * kStride + kk * 16 +
                            (lane >> 4) * 8);

  // this thread's two rows: wr + grp and wr + grp + 8
  int qpos[2];
#pragma unroll
  for (int h = 0; h < 2; ++h)
    qpos[h] = static_cast<int>((row0 + wr + grp + 8 * h) / d.R);
  const int q_first = static_cast<int>(row0 / d.R);  // the block's first

  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};  // partial sums over this thread's columns
  float acc[HD / 8][4];
#pragma unroll
  for (int dt = 0; dt < HD / 8; ++dt)
    acc[dt][0] = acc[dt][1] = acc[dt][2] = acc[dt][3] = 0.f;

  for (int k0 = 0, stage = 0; k0 < kv_end; k0 += kKeys, stage ^= 1) {
    if (k0 + kKeys < kv_end) {  // the next tile loads during this one
      load_tile(k0 + kKeys, stage ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const __nv_bfloat16* tK = sK + stage * kTile;
    const __nv_bfloat16* tV = sV + stage * kTile;

    // s = (q * scale) k^T: 16 rows x 64 keys per warp, 8 n-tiles of 8 keys
    float s[kKeys / 8][4];
#pragma unroll
    for (int nt = 0; nt < kKeys / 8; ++nt)
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
#pragma unroll
      for (int np = 0; np < kKeys / 16; ++np) {
        uint32_t kb[4];  // b0, b1 of n-tiles 2np and 2np + 1
        ldmatrix_x4(kb, tK + (np * 16 + (lane >> 4) * 8 + (lane & 7)) *
                                 kStride +
                            kk * 16 + ((lane >> 3) & 1) * 8);
        mma_bf16(s[2 * np], qa[kk], kb[0], kb[1]);
        mma_bf16(s[2 * np + 1], qa[kk], kb[2], kb[3]);
      }
    }

    // mask where a key can be invisible (a ragged end, or the diagonal),
    // then the online softmax of rows h = 0, 1 in base 2
    if (k0 + kKeys > d.Sk || (d.causal && k0 + kKeys - 1 > q_first)) {
#pragma unroll
      for (int nt = 0; nt < kKeys / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (!visible(d, k0 + nt * 8 + tig * 2 + (e & 1), qpos[e >> 1]))
            s[nt][e] = kNegInf;
    }
    float corr[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float mx = kNegInf;
#pragma unroll
      for (int nt = 0; nt < kKeys / 8; ++nt)
        mx = fmaxf(mx, fmaxf(s[nt][2 * h], s[nt][2 * h + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 2));
      const float m_new = fmaxf(m[h], mx);
      corr[h] = exp2f((m[h] - m_new) * kLog2e);
      m[h] = m_new;
      const float mb = m_new * kLog2e;
      float sum = 0.f;
#pragma unroll
      for (int nt = 0; nt < kKeys / 8; ++nt)
#pragma unroll
        for (int e = 2 * h; e < 2 * h + 2; ++e) {
          s[nt][e] = exp2f(fmaf(s[nt][e], kLog2e, -mb));
          sum += s[nt][e];
        }
      l[h] = l[h] * corr[h] + sum;
    }
#pragma unroll
    for (int dt = 0; dt < HD / 8; ++dt) {
      acc[dt][0] *= corr[0];
      acc[dt][1] *= corr[0];
      acc[dt][2] *= corr[1];
      acc[dt][3] *= corr[1];
    }

    // acc += bf16(p) v: two score n-tiles form one A fragment of 16 keys;
    // v's B fragments come transposed by ldmatrix
#pragma unroll
    for (int kk = 0; kk < kKeys / 16; ++kk) {
      const uint32_t pa[4] = {pack(s[2 * kk][0], s[2 * kk][1]),
                              pack(s[2 * kk][2], s[2 * kk][3]),
                              pack(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int dp = 0; dp < HD / 16; ++dp) {
        uint32_t vb[4];  // b0, b1 of d-tiles 2dp and 2dp + 1
        ldmatrix_x4_trans(vb, tV + (kk * 16 + ((lane >> 3) & 1) * 8 +
                                    (lane & 7)) * kStride +
                                  dp * 16 + (lane >> 4) * 8);
        mma_bf16(acc[2 * dp], pa, vb[0], vb[1]);
        mma_bf16(acc[2 * dp + 1], pa, vb[2], vb[3]);
      }
    }
    __syncthreads();  // this stage is consumed before it is loaded again
  }

  // normalize into the warp's rows of the q buffer, then store 16-byte
  // vectors of whole rows
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float lt = l[h];
    lt += __shfl_xor_sync(kFull, lt, 1);
    lt += __shfl_xor_sync(kFull, lt, 2);
    lt = fmaxf(lt, 1e-30f);
    __nv_bfloat16* dst = sQ + (wr + grp + 8 * h) * kStride + tig * 2;
#pragma unroll
    for (int dt = 0; dt < HD / 8; ++dt)
      *reinterpret_cast<uint32_t*>(dst + dt * 8) =
          pack(acc[dt][2 * h] / lt, acc[dt][2 * h + 1] / lt);
  }
  __syncwarp();
  for (int i = lane; i < 16 * kVecPerRow; i += 32) {
    const int rr = wr + i / kVecPerRow, c = (i % kVecPerRow) * 8;
    if (row0 + rr < n_rows)
      *reinterpret_cast<uint4*>(o + q_offset(d, b, g, row0 + rr, HD) + c) =
          *reinterpret_cast<const uint4*>(sQ + rr * kStride + c);
  }
}

// ---------------------------------------------------------------- float32

constexpr int kKeysF32 = 32;

template <int HD>
constexpr size_t f32_smem_bytes() {
  return sizeof(float) * (kRows * (HD + 1) + kKeysF32 * (HD + 1) +
                          kKeysF32 * HD + kRows * kKeysF32);
}

template <int HD>
__global__ void __launch_bounds__(kThreads)
flash_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, float* __restrict__ o, Dims d) {
  constexpr int kQs = HD + 1;  // padded: lanes on different rows, other banks
  constexpr int kCols = HD / 32;
  extern __shared__ float smem_f32[];
  float* sQ = smem_f32;                    // kRows x kQs, scaled q
  float* sK = sQ + kRows * kQs;        // kKeysF32 x kQs
  float* sV = sK + kKeysF32 * kQs;     // kKeysF32 x HD
  float* sP = sV + kKeysF32 * HD;      // kRows x kKeysF32, p of each warp

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = blockIdx.y, b = blockIdx.z;
  const int64_t n_rows = static_cast<int64_t>(d.Sq) * d.R;
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * kRows;
  const int wr = warp * 16;

  for (int i = tid; i < kRows * HD; i += kThreads) {
    const int rr = i / HD, c = i % HD;
    sQ[rr * kQs + c] = row0 + rr < n_rows
        ? q[q_offset(d, b, g, row0 + rr, HD) + c] * d.scale : 0.f;
  }

  int qpos[16];
  float m[16], l[16], acc[16][kCols];
#pragma unroll
  for (int r = 0; r < 16; ++r) {
    qpos[r] = static_cast<int>((row0 + wr + r) / d.R);
    m[r] = kNegInf;
    l[r] = 0.f;  // partial sum over the keys this lane scores
#pragma unroll
    for (int j = 0; j < kCols; ++j) acc[r][j] = 0.f;
  }

  const int kv_end = kv_extent(d, row0, n_rows);
  for (int k0 = 0; k0 < kv_end; k0 += kKeysF32) {
    __syncthreads();  // q is staged; the previous tile and p are consumed
    for (int i = tid; i < kKeysF32 * HD; i += kThreads) {
      const int kr = i / HD, c = i % HD;
      float kv = 0.f, vv = 0.f;
      if (k0 + kr < d.Sk) {
        const int64_t off = k_offset(d, b, g, k0 + kr, HD) + c;
        kv = k[off];
        vv = v[off];
      }
      sK[kr * kQs + c] = kv;
      sV[kr * HD + c] = vv;
    }
    __syncthreads();

    float s[16];
#pragma unroll
    for (int r = 0; r < 16; ++r) s[r] = 0.f;
    for (int c = 0; c < HD; ++c) {
      const float kc = sK[lane * kQs + c];
#pragma unroll
      for (int r = 0; r < 16; ++r) s[r] = fmaf(sQ[(wr + r) * kQs + c], kc, s[r]);
    }

    const int kpos = k0 + lane;
#pragma unroll
    for (int r = 0; r < 16; ++r) {
      if (!visible(d, kpos, qpos[r])) s[r] = kNegInf;
      float mx = s[r];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, off));
      const float m_new = fmaxf(m[r], mx);
      const float corr = expf(m[r] - m_new);
      m[r] = m_new;
      const float p = expf(s[r] - m_new);
      l[r] = l[r] * corr + p;
      sP[(wr + r) * kKeysF32 + lane] = p;
#pragma unroll
      for (int j = 0; j < kCols; ++j) acc[r][j] *= corr;
    }
    __syncwarp();

    for (int j = 0; j < kKeysF32; ++j) {
      float vv[kCols];
#pragma unroll
      for (int c = 0; c < kCols; ++c) vv[c] = sV[j * HD + lane + 32 * c];
#pragma unroll
      for (int r = 0; r < 16; ++r) {
        const float p = sP[(wr + r) * kKeysF32 + j];
#pragma unroll
        for (int c = 0; c < kCols; ++c) acc[r][c] = fmaf(p, vv[c], acc[r][c]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 16; ++r) {
    float lt = l[r];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      lt += __shfl_xor_sync(kFull, lt, off);
    lt = fmaxf(lt, 1e-30f);
    const int64_t row = row0 + wr + r;
    if (row >= n_rows) continue;
    float* dst = o + q_offset(d, b, g, row, HD) + lane;
#pragma unroll
    for (int c = 0; c < kCols; ++c) dst[32 * c] = acc[r][c] / lt;
  }
}

template <int HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   bool bf16, const Dims& d, dim3 grid, cudaStream_t stream) {
  if (bf16) {
    constexpr size_t smem = bf16_smem_bytes<HD>();
    const cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_bf16<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    flash_fwd_bf16<HD><<<grid, kThreads, smem, stream>>>(
        static_cast<const __nv_bfloat16*>(q),
        static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v),
        static_cast<__nv_bfloat16*>(o), d);
  } else {
    constexpr size_t smem = f32_smem_bytes<HD>();
    const cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_f32<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    flash_fwd_f32<HD><<<grid, kThreads, smem, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(o), d);
  }
  return cudaGetLastError();
}

}  // namespace

// q: (B, Sq, G, R, hd); k, v: (B, Sk, G, hd); o: q's shape.  All contiguous,
// 16-byte aligned, on `device`, bf16 (`is_bf16`) or float32; hd is 32, 64 or
// 128.  Launches on `stream` and does not synchronise.  Returns the CUDA
// error code of selecting the device, of the launch, or
// cudaErrorInvalidValue for a shape it does not take (0 on success).
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* o, int is_bf16, int B,
                                   int Sq, int Sk, int G, int R, int hd,
                                   int causal, float scale, int device,
                                   void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B <= 0 || Sq <= 0 || G <= 0 || R <= 0) return 0;
  if (Sk <= 0 || B > 65535 || G > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const Dims d{B, Sq, Sk, G, R, causal ? 1 : 0, scale};
  const int64_t blocks = (static_cast<int64_t>(Sq) * R + kRows - 1) / kRows;
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(blocks), G, B);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 32: err = launch<32>(q, k, v, o, is_bf16 != 0, d, grid, st); break;
    case 64: err = launch<64>(q, k, v, o, is_bf16 != 0, d, grid, st); break;
    case 128: err = launch<128>(q, k, v, o, is_bf16 != 0, d, grid, st); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
