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
// bf16, so the bf16 tensor cores' rate (989 TFLOP/s) bounds it, and only
// wgmma reaches that rate.
//
// As on the TPU, the R query heads of a group are flattened into rows, so
// every key and value tile is staged in shared memory once and serves all R
// heads of its group.
//   * bf16: one block per (b, g, 192 flattened q*R rows; 128 at hd = 80
//     and hd = 128): three consumer warpgroups of 64 rows (two at hd = 80
//     and 128, whose accumulators need the registers: with three, a thread
//     has 160, and hd = 96's 48 accumulators, 64 scores and 32 words of p
//     spill there and ptxas serialises the wgmma (C7512), which ran slower
//     than two) and one producer warpgroup, which gives its registers to
//     the consumers (setmaxnreg).  A tile is stored as column blocks of 64
//     columns with the 128-byte swizzle (hd 64, 128), or of 32 columns with
//     the 64-byte swizzle (hd 32, and hd 80, whose rows do not split into
//     64-column blocks).  hd = 80 runs padded to 96 columns in shared
//     memory, three 32-column blocks, the layout hd = 32 has: the tensor
//     maps keep the real inner dim of 80 (a 160-byte row stride), so TMA's
//     zero fill writes columns 80-95 of K and V, the q load writes zeros
//     there, Q K^T sums the zeros in (20% more MMA work than exact hd 80),
//     P V runs at n = 96 and the store drops columns 80-95.  The real hd
//     sets the strides, the q offsets and the scale (the wrapper's
//     1/sqrt(hd)); the padded width sets only the shared-memory layout and
//     the products.  The producer's first lane streams K and V tiles of
//     128 keys with TMA (cp.async.bulk.tensor over a 4-D map (hd, G, Sk,
//     B), box (column block, 1, 128, 1); hd = 80 and hd = 128 take three
//     and two boxes a tile) into a ring of as many stages as fit in shared
//     memory (6 at hd = 64, 4 at hd = 80, 3 at hd = 128).  Each stage has a
//     full barrier for K, one for V, and an empty barrier that each
//     consumer warp arrives on when it is done with the stage.  TMA's zero
//     fill covers keys past Sk; the score mask still applies.  The tensor
//     maps are encoded on the host each call by cuTensorMapEncodeTiled,
//     reached through the runtime's cudaGetDriverEntryPoint(ByVersion), so
//     nothing links -lcuda, and are passed as __grid_constant__
//     parameters.  q is read once per block: with R = 7 its flattened rows
//     do not form one TMA box, so each consumer warpgroup loads its 64 rows
//     with 16-byte loads, scales them in bf16 and stores them in the same
//     swizzled layout.
//     S = Q K^T is wgmma.m64n128k16 with both operands in shared memory
//     (K-major descriptors); the online softmax runs in registers on the
//     accumulator layout, in base 2 (ex2.approx); p is rounded to bf16 in
//     registers and is the register A operand of O += P V
//     (wgmma.m64n<padded hd>k16), whose B operand is the V tile through an
//     MN-major descriptor.  Tile t's Q K^T is issued with tile t-1's P V
//     behind it, so t's softmax overlaps that P V, and the warpgroups take
//     turns at issuing (named barriers), so one's softmax overlaps another's
//     products.  The wait loops and the elected arrivals stay inside asm, so
//     the compiler sees no divergent branch near a wgmma (it would serialise
//     them).  Only tiles that cross the diagonal or Sk are masked.  Row
//     blocks run heaviest first (the causal row-block index is reversed).
//     The output goes out through shared memory in 16-byte rows.
//   * float32: the tensor cores would round to TF32, so the products run on
//     the CUDA cores in blocks of 4 warps and 64 rows: lane j scores key j
//     of a 32-key tile against the warp's 16 rows (q and k from padded
//     shared memory, conflict-free), then each lane accumulates its
//     ceil(hd/32) output columns from p staged in shared memory (at hd = 80
//     the third, columns 64-79, only on lanes 0-15).
#include <cstdint>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kRows = 64;  // flattened q*R rows per float32 block
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

// The number of key positions rows [row0, row0 + rows) can see: all of Sk,
// or up to the last row's query position when causal (tiles past it are
// skipped).  0 when no row is below n_rows.
__device__ __forceinline__ int kv_extent(const Dims& d, int64_t row0,
                                         int rows, int64_t n_rows) {
  int64_t last = row0 + rows;
  if (last > n_rows) last = n_rows;
  if (last <= row0) return 0;
  int64_t end = d.Sk;
  if (d.causal && (last - 1) / d.R + 1 < end) end = (last - 1) / d.R + 1;
  return static_cast<int>(end);
}

__device__ __forceinline__ bool visible(const Dims& d, int kpos, int qpos) {
  return kpos < d.Sk && (!d.causal || kpos <= qpos);
}

// ---------------------------------------------------------------- bf16

constexpr int kWgRows = 64;                 // rows of a consumer warpgroup
constexpr int kKeys = 128;                  // keys per K/V tile
constexpr int kProducerRegs = 24;           // a producer thread after setmaxnreg

// Shared memory of the bf16 kernel: q (each consumer warpgroup's 64 rows),
// the K and V stages, then the barriers.  A tile of rows x hd is stored
// padded to kPad columns, as kPad / kCols column blocks of rows x kCols,
// each row kRowBytes long and swizzled over kRowBytes (the TMA map's and
// the wgmma descriptors').
template <int HD>
struct Bf16Tile {
  // consumer warpgroups of 64 rows: three at hd <= 64 (each K/V tile then
  // serves 192 rows), two at hd = 80 and 128, whose accumulators need more
  // registers than three leave (at hd 80 three spill); one producer
  // warpgroup after them
  static constexpr int kConsumers = HD <= 64 ? 3 : 2;
  static constexpr int kBlockRows = kWgRows * kConsumers;
  static constexpr int kProducerWarp = kConsumers * 4;
  static constexpr int kThreads = (kConsumers + 1) * 128;
  // registers a consumer thread takes after setmaxnreg: what the producer
  // warpgroup gives up (kConsumers x 128 x regs + 128 x 24 <= 65,536)
  static constexpr int kConsumerRegs = kConsumers == 3 ? 160 : 240;
  // 64-column blocks (128-byte swizzle) where hd splits into them, else
  // 32-column blocks (64-byte swizzle); kPad is hd rounded up to a block
  static constexpr int kCols = HD % 64 == 0 ? 64 : 32;
  static constexpr int kPad = (HD + kCols - 1) / kCols * kCols;
  static constexpr int kRowBytes = kCols * 2;
  static constexpr int kWgQBytes = kWgRows * kPad * 2;
  static constexpr int kTileBytes = kKeys * kPad * 2;
  // as many K/V stages as fit beside q in 227 KB, up to 8: 6 at hd 64, 4 at
  // hd 80, 3 at hd 128, so the loads run well ahead of the consumers
  static constexpr int kFit =
      (232448 - 1024 - kConsumers * kWgQBytes - 256) / (2 * kTileBytes);
  static constexpr int kStages = kFit < 8 ? kFit : 8;
  static constexpr int kColBlockBytes = kKeys * kRowBytes;  // of a K/V tile
  static constexpr uint64_t kLayout = kRowBytes == 128 ? 1 : 2;  // B128/B64
  static constexpr size_t kSmem = 1024 + kConsumers * kWgQBytes +
                                  2 * kStages * kTileBytes + 3 * kStages * 8;
};

// The byte offset `off` within a 1024-byte-aligned tile as the 128-byte
// (ROW = 128) or 64-byte (ROW = 64) swizzle places it: the 16-byte chunk
// index XORed with the row bits above the span.
template <int ROW>
__device__ __forceinline__ uint32_t swizzle(uint32_t off) {
  return off ^ (((off >> 7) & (ROW / 16 - 1)) << 4);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// wgmma shared-memory matrix descriptor: start address, leading and stride
// byte offsets (16-byte units), swizzle layout.
__device__ __forceinline__ uint64_t gmma_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo, uint64_t layout) {
  return static_cast<uint64_t>((addr >> 4) & 0x3FFF) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (layout << 62);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(bar), "r"(count) : "memory");
}

// Waits for the phase of parity `parity` of barrier `bar` to complete.  The
// polling loop stays inside one asm block, so the compiler sees no divergent
// branch around the wgmma instructions that follow (which would make it
// serialise them).
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n"
      "}\n"
      :: "r"(bar), "r"(parity) : "memory");
}

// Arrives on `bar` from the threads where `pred` holds (predicated inside
// the asm: no divergent branch).
__device__ __forceinline__ void mbar_arrive_if(uint32_t bar, bool pred) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %1, 0;\n"
      "@p mbarrier.arrive.shared::cta.b64 _, [%0];\n"
      "}\n"
      :: "r"(bar), "r"(static_cast<int>(pred)) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

// One box of a 4-D tensor map into shared memory, completing on `bar`.
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0),
         "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// Keeps the compiler from moving reads or writes of accumulator registers
// across the asynchronous wgmma that owns them.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}

__device__ __forceinline__ void named_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(threads) : "memory");
}

// D (64 x 128, float32) += A (64 x 16) B^T (16 x 128), both bf16 in shared
// memory, K-major; D is zeroed first unless scale_d.
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t a,
                                           uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(scale_d)
      : "memory");
}

// D (64 x 32, float32) += A (64 x 16, bf16 in registers) B (16 x 32, bf16
// in shared memory, MN-major).
__device__ __forceinline__ void wgmma_rs_n32(float (&d)[16],
                                           const uint32_t (&a)[4],
                                           uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1)
      : "memory");
}

// D (64 x 64, float32) += A (64 x 16, bf16 in registers) B (16 x 64, bf16
// in shared memory, MN-major).
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                           const uint32_t (&a)[4],
                                           uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1)
      : "memory");
}

// D (64 x 128, float32) += A (64 x 16, bf16 in registers) B (16 x 128, bf16
// in shared memory, MN-major).
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                           const uint32_t (&a)[4],
                                           uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1)
      : "memory");
}


// D (64 x 96, float32) += A (64 x 16, bf16 in registers) B (16 x 96, bf16
// in shared memory, MN-major).
__device__ __forceinline__ void wgmma_rs_n96(float (&d)[48],
                                           const uint32_t (&a)[4],
                                           uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47"
      "}, {%48, %49, %50, %51}, %52, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1)
      : "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t (&a)[4], uint64_t b);
template <>
__device__ __forceinline__ void wgmma_rs<32>(float (&d)[16],
                                             const uint32_t (&a)[4],
                                             uint64_t b) {
  wgmma_rs_n32(d, a, b);
}
template <>
__device__ __forceinline__ void wgmma_rs<64>(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t b) {
  wgmma_rs_n64(d, a, b);
}
template <>
__device__ __forceinline__ void wgmma_rs<96>(float (&d)[48],
                                             const uint32_t (&a)[4],
                                             uint64_t b) {
  wgmma_rs_n96(d, a, b);
}
template <>
__device__ __forceinline__ void wgmma_rs<128>(float (&d)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t b) {
  wgmma_rs_n128(d, a, b);
}

// 2^x by the special-function unit (one MUFU.EX2; relative error ~2^-22,
// far below the bf16 rounding of p that follows).
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Two values as one 32-bit register, the first in the low half.
__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

template <int HD>
__global__ void __launch_bounds__(Bf16Tile<HD>::kThreads, 1)
flash_fwd_bf16(const __grid_constant__ CUtensorMap k_map,
               const __grid_constant__ CUtensorMap v_map,
               const __nv_bfloat16* __restrict__ q,
               __nv_bfloat16* __restrict__ o, Dims d, int row_blocks) {
  using T = Bf16Tile<HD>;
  constexpr int kConsumers = T::kConsumers, kBlockRows = T::kBlockRows;
  constexpr int kCols = T::kCols, kRowBytes = T::kRowBytes;
  constexpr int kStages = T::kStages, kPad = T::kPad;
  constexpr int kVecPerRow = HD / 8;     // 16-byte vectors of a real row
  constexpr int kPadVecs = kPad / 8;     // and of a padded row
  constexpr int kNT = kKeys / 8;         // score n-tiles of 8 keys
  extern __shared__ unsigned char smem_raw[];
  // 1024-byte alignment, which the swizzle patterns assume
  unsigned char* base = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  unsigned char* sQ = base;                               // q, per warpgroup
  unsigned char* sK = sQ + kConsumers * T::kWgQBytes;     // kStages tiles
  unsigned char* sV = sK + kStages * T::kTileBytes;       // kStages tiles
  const uint32_t bars = smem_addr(sV + kStages * T::kTileBytes);
  auto full_k = [&](int s) { return bars + 8 * s; };
  auto full_v = [&](int s) { return bars + 8 * (kStages + s); };
  auto empty = [&](int s) { return bars + 8 * (2 * kStages + s); };

  // the warp index through a shuffle, so the compiler knows it is uniform
  // across the warp (and the warpgroup branches below are not divergent)
  const int tid = threadIdx.x, lane = tid & 31;
  const int warp = __shfl_sync(kFull, tid >> 5, 0);
  // heaviest causal row blocks first: the row-block index runs backwards,
  // slowest of the three
  const int gb = static_cast<int>(blockIdx.x % (d.G * d.B));
  const int rb = row_blocks - 1 - static_cast<int>(blockIdx.x / (d.G * d.B));
  const int g = gb % d.G, b = gb / d.G;
  const int64_t n_rows = static_cast<int64_t>(d.Sq) * d.R;
  const int64_t row0 = static_cast<int64_t>(rb) * kBlockRows;
  const int n_tiles = (kv_extent(d, row0, kBlockRows, n_rows) + kKeys - 1) / kKeys;

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full_k(s), 1);
      mbar_init(full_v(s), 1);
      mbar_init(empty(s), kConsumers * 4);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= T::kProducerWarp) {
    // ---- producer warpgroup: gives up registers; lane 0 of its first warp
    // keeps the ring of K/V stages filled
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(kProducerRegs));
    if (warp == T::kProducerWarp && lane == 0) {
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % kStages;
        mbar_wait(empty(s), ((t / kStages) & 1) ^ 1);
        const uint32_t k_dst = smem_addr(sK + s * T::kTileBytes);
        const uint32_t v_dst = smem_addr(sV + s * T::kTileBytes);
        mbar_expect_tx(full_k(s), T::kTileBytes);
#pragma unroll
        for (int c = 0; c < kPad / kCols; ++c)
          tma_load_4d(k_dst + c * T::kColBlockBytes, &k_map, full_k(s),
                      c * kCols, g, t * kKeys, b);
        mbar_expect_tx(full_v(s), T::kTileBytes);
#pragma unroll
        for (int c = 0; c < kPad / kCols; ++c)
          tma_load_4d(v_dst + c * T::kColBlockBytes, &v_map, full_v(s),
                      c * kCols, g, t * kKeys, b);
      }
    }
    return;
  }

  // ---- consumers: warpgroup wg owns rows [wrow0, wrow0 + 64)
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(T::kConsumerRegs));
  const int wg = warp >> 2, wt = tid & 127, w = warp & 3;
  const int grp = lane >> 2, tig = lane & 3;
  const int64_t wrow0 = row0 + wg * kWgRows;
  unsigned char* sQw = sQ + wg * T::kWgQBytes;

  // q rows, scaled in bf16 as the TPU kernel does, into the swizzled layout
  for (int i = wt; i < kWgRows * kPadVecs; i += 128) {
    const int rr = i / kPadVecs, c = (i % kPadVecs) * 8;
    // rows past the end, and the padding columns hd..kPad, read row 0 and
    // are zeroed: a select, not a branch
    const bool ok = wrow0 + rr < n_rows && c < HD;
    uint4 val = *reinterpret_cast<const uint4*>(
        q + (ok ? q_offset(d, b, g, wrow0 + rr, HD) + c : 0));
    __nv_bfloat16* e = reinterpret_cast<__nv_bfloat16*>(&val);
#pragma unroll
    for (int j = 0; j < 8; ++j)
      e[j] = __float2bfloat16(ok ? __bfloat162float(e[j]) * d.scale : 0.f);
    *reinterpret_cast<uint4*>(
        sQw + (c / kCols) * (kWgRows * kRowBytes) +
        swizzle<kRowBytes>(rr * kRowBytes + (c % kCols) * 2)) = val;
  }
  // generic-proxy stores, read next by wgmma through the async proxy
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  named_barrier(1 + wg, 128);

  // this thread's two rows: 16 w + grp and 16 w + grp + 8 of the warpgroup
  int qpos[2];
#pragma unroll
  for (int h = 0; h < 2; ++h)
    qpos[h] = static_cast<int>((wrow0 + 16 * w + grp + 8 * h) / d.R);
  const int q_first = static_cast<int>(wrow0 / d.R);  // the warpgroup's first

  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};  // partial sums over this thread's columns
  float acc[kPad / 2];
#pragma unroll
  for (int i = 0; i < kPad / 2; ++i) acc[i] = 0.f;
  float s[kKeys / 2];
  uint32_t pa[kKeys / 16][4];  // bf16(p) of the previous tile, A fragments
  const uint32_t q_addr = smem_addr(sQw);

  // s = (q * scale) k^T of tile t: 64 rows x 128 keys, issued, not waited
  auto issue_qk = [&](int t) {
    const uint32_t k_addr = smem_addr(sK + (t % kStages) * T::kTileBytes);
#pragma unroll
    for (int kk = 0; kk < kPad / 16; ++kk) {
      const uint32_t sub = kk / (kCols / 16), off = (kk % (kCols / 16)) * 32;
      wgmma_ss_n128(
          s,
          gmma_desc(q_addr + sub * (kWgRows * kRowBytes) + off, 16,
                    8 * kRowBytes, T::kLayout),
          gmma_desc(k_addr + sub * T::kColBlockBytes + off, 16,
                    8 * kRowBytes, T::kLayout),
          kk > 0);
    }
    wgmma_commit();
  };
  // acc += bf16(p) v of tile t: v is the MN-major B operand, 16 key rows a
  // step; issued, not waited
  auto issue_pv = [&](int t) {
    const uint32_t v_addr = smem_addr(sV + (t % kStages) * T::kTileBytes);
#pragma unroll
    for (int kk = 0; kk < kKeys / 16; ++kk)
      wgmma_rs<kPad>(acc, pa[kk],
                   gmma_desc(v_addr + kk * 16 * kRowBytes, T::kColBlockBytes,
                             8 * kRowBytes, T::kLayout));
    wgmma_commit();
  };
  // mask where a key of tile t can be invisible (a ragged end, or the
  // diagonal), then the online softmax of rows h = 0, 1 in base 2: s becomes
  // p, m and l move on, and corr is the factor acc must be scaled by
  auto softmax = [&](int t, float (&corr)[2]) {
    const int k0 = t * kKeys;
    if (k0 + kKeys > d.Sk || (d.causal && k0 + kKeys - 1 > q_first)) {
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (!visible(d, k0 + nt * 8 + tig * 2 + (e & 1), qpos[e >> 1]))
            s[nt * 4 + e] = kNegInf;
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float mx = kNegInf;
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt)
        mx = fmaxf(mx, fmaxf(s[nt * 4 + 2 * h], s[nt * 4 + 2 * h + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 2));
      const float m_new = fmaxf(m[h], mx);
      corr[h] = fast_exp2((m[h] - m_new) * kLog2e);
      m[h] = m_new;
      const float mb = m_new * kLog2e;
      float sum = 0.f;
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
        for (int e = 2 * h; e < 2 * h + 2; ++e) {
          s[nt * 4 + e] = fast_exp2(fmaf(s[nt * 4 + e], kLog2e, -mb));
          sum += s[nt * 4 + e];
        }
      l[h] = l[h] * corr[h] + sum;
    }
  };
  // p rounded to bf16: two score n-tiles form one A fragment of 16 keys
  auto pack_p = [&]() {
#pragma unroll
    for (int kk = 0; kk < kKeys / 16; ++kk) {
      pa[kk][0] = pack(s[8 * kk + 0], s[8 * kk + 1]);
      pa[kk][1] = pack(s[8 * kk + 2], s[8 * kk + 3]);
      pa[kk][2] = pack(s[8 * kk + 4], s[8 * kk + 5]);
      pa[kk][3] = pack(s[8 * kk + 6], s[8 * kk + 7]);
    }
  };
  auto phase = [](int t) { return static_cast<uint32_t>((t / kStages) & 1); };

  // The consumer warpgroups take turns at the tensor cores, in a ring
  // (named barriers 4, 5, 6): one issues its products while the others run
  // their softmax.  Warpgroup 0 goes first; the last one skips its last
  // hand-over, which nobody waits for.  Every warpgroup runs all n_tiles
  // tiles of the block (a tile past its own rows' keys is masked whole),
  // so the turns match.
  auto turn_begin = [&]() { named_barrier(4 + wg, 256); };
  auto turn_end = [&](bool last) {
    if (!(wg == kConsumers - 1 && last))
      asm volatile("bar.arrive %0, 256;\n"
                   :: "r"(4 + (wg + 1) % kConsumers) : "memory");
  };
  if (wg == 0) asm volatile("bar.arrive 4, 256;\n" ::: "memory");

  // Tile t's q k^T runs on the tensor cores while tile t - 1's p v is
  // issued behind it; tile t's softmax then overlaps that p v.
  float corr[2];
  mbar_wait(full_k(0), phase(0));
  turn_begin();
  fence_regs(s);
  wgmma_fence();
  issue_qk(0);
  turn_end(n_tiles == 1);
  wgmma_wait<0>();
  fence_regs(s);
  softmax(0, corr);
  pack_p();
  for (int t = 1; t < n_tiles; ++t) {
    mbar_wait(full_k(t % kStages), phase(t));
    turn_begin();
    fence_regs(s);
    fence_regs(acc);
    wgmma_fence();
    issue_qk(t);
    mbar_wait(full_v((t - 1) % kStages), phase(t - 1));
    issue_pv(t - 1);
    fence_regs(acc);
    turn_end(t == n_tiles - 1);
    wgmma_wait<1>();  // q k^T of tile t is done; p v of t - 1 runs on
    fence_regs(s);
    softmax(t, corr);
    wgmma_wait<0>();
    fence_regs(acc);
    mbar_arrive_if(empty((t - 1) % kStages), lane == 0);
#pragma unroll
    for (int dt = 0; dt < kPad / 8; ++dt) {
      acc[dt * 4 + 0] *= corr[0];
      acc[dt * 4 + 1] *= corr[0];
      acc[dt * 4 + 2] *= corr[1];
      acc[dt * 4 + 3] *= corr[1];
    }
    pack_p();
  }
  mbar_wait(full_v((n_tiles - 1) % kStages), phase(n_tiles - 1));
  fence_regs(acc);
  wgmma_fence();
  issue_pv(n_tiles - 1);
  fence_regs(acc);
  wgmma_wait<0>();
  fence_regs(acc);
  mbar_arrive_if(empty((n_tiles - 1) % kStages), lane == 0);

  // normalize into the warpgroup's q rows (swizzled, padding columns
  // included), then store 16-byte vectors of the real columns of each row
  named_barrier(1 + wg, 128);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float lt = l[h];
    lt += __shfl_xor_sync(kFull, lt, 1);
    lt += __shfl_xor_sync(kFull, lt, 2);
    lt = fmaxf(lt, 1e-30f);
    const int rr = 16 * w + grp + 8 * h;
#pragma unroll
    for (int dt = 0; dt < kPad / 8; ++dt) {
      const int c = dt * 8 + tig * 2;
      *reinterpret_cast<uint32_t*>(
          sQw + (c / kCols) * (kWgRows * kRowBytes) +
          swizzle<kRowBytes>(rr * kRowBytes + (c % kCols) * 2)) =
          pack(acc[dt * 4 + 2 * h] / lt, acc[dt * 4 + 2 * h + 1] / lt);
    }
  }
  named_barrier(1 + wg, 128);
  for (int i = wt; i < kWgRows * kVecPerRow; i += 128) {
    const int rr = i / kVecPerRow, c = (i % kVecPerRow) * 8;
    if (wrow0 + rr < n_rows)
      *reinterpret_cast<uint4*>(o + q_offset(d, b, g, wrow0 + rr, HD) + c) =
          *reinterpret_cast<const uint4*>(
              sQw + (c / kCols) * (kWgRows * kRowBytes) +
              swizzle<kRowBytes>(rr * kRowBytes + (c % kCols) * 2));
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
  // output columns lane, lane + 32, ... of each row: ceil(hd / 32) of them,
  // the last one only on lanes below hd % 32 where 32 does not divide hd
  constexpr int kCols = (HD + 31) / 32;
  extern __shared__ float smem_f32[];
  float* sQ = smem_f32;                    // kRows x kQs, scaled q
  float* sK = sQ + kRows * kQs;        // kKeysF32 x kQs
  float* sV = sK + kKeysF32 * kQs;     // kKeysF32 x HD
  float* sP = sV + kKeysF32 * HD;      // kRows x kKeysF32, p of each warp

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  auto has_col = [&](int c) { return HD % 32 == 0 || lane + 32 * c < HD; };
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

  const int kv_end = kv_extent(d, row0, kRows, n_rows);
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
      for (int c = 0; c < kCols; ++c)
        vv[c] = has_col(c) ? sV[j * HD + lane + 32 * c] : 0.f;
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
    for (int c = 0; c < kCols; ++c)
      if (has_col(c)) dst[32 * c] = acc[r][c] / lt;
  }
}

// cuTensorMapEncodeTiled from the driver, through the runtime (no -lcuda).
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

cudaError_t encoder(EncodeTiled* fn) {
  static EncodeTiled cached = nullptr;
  if (cached == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess) return err;
    if (found != cudaDriverEntryPointSuccess || p == nullptr)
      return cudaErrorSymbolNotFound;
    cached = reinterpret_cast<EncodeTiled>(p);
  }
  *fn = cached;
  return cudaSuccess;
}

// The 4-D map (hd, G, Sk, B) over a contiguous (B, Sk, G, hd) bf16 tensor,
// with a box of (one column block, 1, kKeys, 1) swizzled as the kernel reads
// it.  The inner dim is the real hd: at hd 80 the third box of a tile
// reaches past it, and TMA fills columns 80-95 with zeros.
template <int HD>
cudaError_t kv_map(CUtensorMap* map, const void* ptr, const Dims& d) {
  EncodeTiled encode;
  const cudaError_t err = encoder(&encode);
  if (err != cudaSuccess) return err;
  using T = Bf16Tile<HD>;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(HD),
                              static_cast<cuuint64_t>(d.G),
                              static_cast<cuuint64_t>(d.Sk),
                              static_cast<cuuint64_t>(d.B)};
  const cuuint64_t strides[3] = {
      static_cast<cuuint64_t>(HD) * 2,
      static_cast<cuuint64_t>(d.G) * HD * 2,
      static_cast<cuuint64_t>(d.Sk) * d.G * HD * 2};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(T::kCols), 1,
                             static_cast<cuuint32_t>(kKeys), 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
      strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
      T::kRowBytes == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                          : CU_TENSOR_MAP_SWIZZLE_64B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <int HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   bool bf16, const Dims& d, cudaStream_t stream) {
  const int64_t n_rows = static_cast<int64_t>(d.Sq) * d.R;
  if (bf16) {
    using T = Bf16Tile<HD>;
    const int64_t row_blocks = (n_rows + T::kBlockRows - 1) / T::kBlockRows;
    const int64_t blocks = row_blocks * d.G * d.B;
    if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
    CUtensorMap k_map, v_map;
    cudaError_t err = kv_map<HD>(&k_map, k, d);
    if (err != cudaSuccess) return err;
    err = kv_map<HD>(&v_map, v, d);
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(flash_fwd_bf16<HD>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(T::kSmem));
    if (err != cudaSuccess) return err;
    flash_fwd_bf16<HD><<<static_cast<unsigned>(blocks), T::kThreads,
                         T::kSmem, stream>>>(
        k_map, v_map, static_cast<const __nv_bfloat16*>(q),
        static_cast<__nv_bfloat16*>(o), d, static_cast<int>(row_blocks));
  } else {
    const int64_t blocks = (n_rows + kRows - 1) / kRows;
    if (blocks > 0x7fffffff || d.G > 65535 || d.B > 65535)
      return cudaErrorInvalidValue;
    constexpr size_t smem = f32_smem_bytes<HD>();
    const cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_f32<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    flash_fwd_f32<HD><<<dim3(static_cast<unsigned>(blocks), d.G, d.B),
                        kThreads, smem, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(o), d);
  }
  return cudaGetLastError();
}

}  // namespace

// q: (B, Sq, G, R, hd); k, v: (B, Sk, G, hd); o: q's shape.  All contiguous,
// 16-byte aligned, on `device`, bf16 (`is_bf16`) or float32; hd is 32, 64,
// 80 or 128.  Launches on `stream` and does not synchronise.  Returns the CUDA
// error code of selecting the device, of encoding the bf16 path's tensor
// maps, of the launch, or cudaErrorInvalidValue for a shape it does not take
// (0 on success).
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* o, int is_bf16, int B,
                                   int Sq, int Sk, int G, int R, int hd,
                                   int causal, float scale, int device,
                                   void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B <= 0 || Sq <= 0 || G <= 0 || R <= 0) return 0;
  if (Sk <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const Dims d{B, Sq, Sk, G, R, causal ? 1 : 0, scale};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 32: err = launch<32>(q, k, v, o, is_bf16 != 0, d, st); break;
    case 64: err = launch<64>(q, k, v, o, is_bf16 != 0, d, st); break;
    case 80: err = launch<80>(q, k, v, o, is_bf16 != 0, d, st); break;
    case 128: err = launch<128>(q, k, v, o, is_bf16 != 0, d, st); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
