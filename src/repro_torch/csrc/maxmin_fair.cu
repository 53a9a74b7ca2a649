// Masked row-min over a flow x link incidence, for Hopper (sm_90a).
//
// Replaces the TPU kernel `masked_min_rows` (`_minrows_kernel`) in
// src/repro/kernels/maxmin_fair/kernel.py: for every flow row of an int8
// (F, L) incidence, the minimum of a float32 (L,) per-link fair share over
// the links the flow crosses (adj > 0), and 3.4e38 for a row with no link.
// It is the inner step of progressive-filling max-min fairness (`waterfill`).
//
// Bound: memory.  The incidence is F*L bytes and is read once per call; the
// share vector (4*L bytes) stays in cache.  At Frontera's fabric (8,008
// flows x 18,200 links, 146 MB) that is about 44 us at 3.35 TB/s.
//
// Design: the TPU kernel walks (bf, bl) tiles in order and carries a running
// min across link blocks in VMEM.  Here each warp owns one row, so nothing
// carries between blocks: the warp streams the row with 16-byte loads
// (cache-streaming, the row is not reused within a call), skips a 16-byte
// chunk that is all zero (a flow crosses a handful of links), reads the share
// of a crossed link through the read-only path, and ends with a warp-shuffle
// min.  Rows need not be 16-byte aligned (L is any width): a scalar head runs
// up to the first 16-byte boundary of the row and a scalar tail after the
// last whole chunk, so ragged F and L need no padding.  A min does no
// arithmetic, so the result equals the plain version exactly.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr float kInf = 3.4e38f;
constexpr int kWarpsPerBlock = 8;

__device__ __forceinline__ float take(int8_t a, const float* __restrict__ vals,
                                      int64_t j, float m) {
  if (a > 0) {
    const float v = __ldg(vals + j);
    m = v < m ? v : m;
  }
  return m;
}

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
minrows_kernel(const int8_t* __restrict__ adj, const float* __restrict__ vals,
               float* __restrict__ out, int64_t F, int64_t L) {
  const int lane = threadIdx.x & 31;
  const int64_t row =
      static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= F) return;  // whole warp leaves together: one row per warp
  const int8_t* r = adj + row * L;
  float m = kInf;

  // head: bytes before the row's first 16-byte boundary (at most 15)
  int64_t head = (16 - static_cast<int64_t>(
                           reinterpret_cast<uintptr_t>(r) & 15)) & 15;
  if (head > L) head = L;
  if (lane < head) m = take(r[lane], vals, lane, m);

  // body: whole 16-byte chunks
  const int64_t nvec = (L - head) >> 4;
  const int4* body = reinterpret_cast<const int4*>(r + head);
  for (int64_t i = lane; i < nvec; i += 32) {
    const int4 w = __ldcs(body + i);
    if ((w.x | w.y | w.z | w.w) == 0) continue;
    const int64_t j0 = head + (i << 4);
    const uint32_t words[4] = {static_cast<uint32_t>(w.x),
                               static_cast<uint32_t>(w.y),
                               static_cast<uint32_t>(w.z),
                               static_cast<uint32_t>(w.w)};
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      if (words[q] == 0) continue;
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int8_t a = static_cast<int8_t>((words[q] >> (8 * b)) & 0xffu);
        m = take(a, vals, j0 + 4 * q + b, m);
      }
    }
  }

  // tail: the bytes after the last whole chunk (at most 15)
  for (int64_t j = head + (nvec << 4) + lane; j < L; j += 32)
    m = take(r[j], vals, j, m);

#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float o = __shfl_xor_sync(0xffffffffu, m, off);
    m = o < m ? o : m;
  }
  if (lane == 0) out[row] = m;
}

}  // namespace

// adj: (F, L) int8 row-major; vals: (L,) float32; out: (F,) float32, all on
// `device`.  Launches on `stream` and does not synchronise.  Returns the
// CUDA error code of selecting the device or of the launch (0 on success).
extern "C" int masked_min_rows_f32(const void* adj, const void* vals,
                                   void* out, int64_t F, int64_t L,
                                   int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (F <= 0) return 0;
  const int64_t blocks = (F + kWarpsPerBlock - 1) / kWarpsPerBlock;
  minrows_kernel<<<static_cast<unsigned int>(blocks), kWarpsPerBlock * 32, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(adj), static_cast<const float*>(vals),
      static_cast<float*>(out), F, L);
  return static_cast<int>(cudaGetLastError());
}
