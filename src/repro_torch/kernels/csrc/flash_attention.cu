// Causal / sliding-window GQA attention with an online softmax, for sm_90a.
//
// Replaces the Pallas TPU kernel `flash_attention`
// (src/repro/kernels/flash_attention.py:69, body `_flash_body` :35).  Same
// function: q (B, S, H, hd), k and v (B, S, KV, hd) with H % KV == 0, query
// head h reading KV head h / (H / KV); scores q.k / sqrt(hd) in fp32; a
// masked score is the finite -1e30 (causal: kpos <= qpos; with a window w
// also kpos > qpos - w; and kpos < S for the ragged last tile); an online
// softmax with fp32 running max, sum and accumulator; out = acc / max(l,
// 1e-30) in q's dtype.  Any S >= 1, causal or not; hd 32, 64, 96, 128 or 256;
// bf16, fp16, fp32.
//
// What bounds it: the multiply-adds.  A (b, h) pair needs 4 hd FLOPs per
// unmasked (query, key) pair (q.k and p.v) but reads q, k, v and writes o
// only once, so at the serving shapes (S in the thousands) the work is
// compute-bound on the tensor cores: at qwen3-1.7b's prefill (B 8, S 2048,
// H 16, KV 8, hd 128, bf16) 1.375e11 FLOP over 989 TFLOP/s (dense
// bf16/fp16 on an H100 SXM) = 0.139 ms, against 0.060 ms for its bytes at
// 3.35 TB/s.
//
// What the design does about it (bf16 / fp16):
//  * Both products on wgmma, fp32 accumulate.  S = Q K^T is m64n128k16
//    with A = the Q tile and B = the K tile, both read from shared memory
//    through descriptors (K stored [key][hd] is K-major for B).  O += P V
//    takes A = P from registers: the fp32 S accumulator of a 64 x 128 tile,
//    rounded in place to bf16/fp16 pairs, is wgmma's register-A layout (as
//    the TPU kernel's p @ v rounds on the MXU), so scores never leave
//    registers; B = the V tile [key][hd], MN-major, through the
//    descriptor's transpose bit.
//  * k/v reach shared memory by TMA (cp.async.bulk.tensor) into a ring of
//    STAGES = 2 stages, each completed on mbarriers (k and v apart, so QK^T
//    starts before v lands) and handed back on an "empty" mbarrier.  One
//    producer warp (one thread issues) keeps the next tile's loads in
//    flight while two consumer warpgroups of 64 query rows each compute.
//    Tensor maps are encoded on the host each call over the (B, S, heads,
//    hd) layout and its strides; TMA fills rows past S (and head-dim
//    columns past hd) with zeros.
//  * One layout everywhere: a TMA box is 64 head-dim columns (128 bytes) by
//    the tile's rows, with the 128-byte swizzle, and the wgmma descriptors
//    name the same layout (swizzle mode 1, 8-row groups 1024 bytes apart,
//    a k16 step 32 bytes along a K-major row or 16 rows down an MN-major
//    one, V's 64-column boxes one tile apart).  hd 128 is two boxes; hd 96
//    two with the last 32 columns zero-filled, hd 32 one with 32 (the
//    products see hd 128 and 64: a quarter and a half of their work is on
//    zeros; qwen3's hd 128 has none).
//  * The mask runs only where a tile needs it: the causal diagonal, the
//    window's lower edge and the ragged last tile (judged per warpgroup's
//    64 rows, as two key bounds a row); interior tiles only scale.  Tiles
//    masked for the whole query tile are never loaded, so the work is
//    S (S + 1) / 2 pairs a head, not S^2.  Tiles run in ascending key
//    order: a row whose first visited tile is fully masked (a window
//    smaller than the tile) accumulates p = 1 on the finite -1e30, which
//    the first unmasked tile wipes with corr = exp(-1e30 - m) = 0, exactly
//    as on the TPU.
//  * A persistent grid, one block an SM: a block walks (b, h, query tile)
//    items, a long causal band paired with a short one (`unit_item`), with
//    two Q buffers, so that an item's Q and first k/v tiles load while the
//    one before it finishes, and its output leaves by TMA store (which
//    drops rows past S and columns past hd) from the warpgroup's own rows
//    of the Q buffer while the next item computes.
//  * Tiles: 128 query rows and 128 keys, 288 threads (warpgroups 0-1
//    compute, warp 8 loads); shared memory (two Q buffers + 2 stages of K
//    and V) 192 KB at hd 96/128 and 96 KB at hd 32/64, one block an SM.
//    ptxas, bf16 hd 128 (-Xptxas -v, `_build/flash_attention.log`): "Used
//    168 registers, used 16 barriers"; "0 bytes stack frame, 0 bytes spill
//    stores, 0 bytes spill loads".  168 is ptxas's ceiling at 288 threads
//    as at 384, and setmaxnreg did not raise it for the consumers' code, so
//    the design keeps a consumer within 168: one S tile, P and O (64 + 32
//    + 64 registers) and no second S tile in flight.
//  * hd 256 (recurrentgemma): O alone is 128 registers a consumer thread,
//    so that kernel (`flash_tc256_kernel`, below) has no producer warp:
//    256 threads under a ceiling of 255 registers, 64-key tiles, thread 0
//    issuing the loads, one Q buffer; 192 KB of shared memory.
//  * fp32: CUDA cores only (never TF32), so that it holds 2e-5 against the
//    plain version.  One block of 8 warps per (b, h, 32-query tile); warp w
//    owns rows w, w + 8, w + 16, w + 24, lane j owns key j of a 32-key tile,
//    and the running max, sum and output stay in registers; the public
//    layout is read in place through its strides, rows past S loaded as
//    zeros and masked.

#include <cuda.h>   // CUtensorMap and its enums; the encoder is reached through the runtime
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

// 2^x on the special-function unit, denormal results flushed to zero.
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

struct Shape {
  int B, S, H, KV, causal, window;       // window <= 0: none
  int64_t qs_b, qs_s, qs_h;              // q and o strides, in elements
  int64_t ks_b, ks_s, ks_h;              // k and v strides
};

// The k/v tile range a query tile [q_lo, q_hi] touches: [*lo, *hi].
__device__ __forceinline__ void tile_range(const Shape& sh, int q_lo, int q_hi, int bk,
                                           int* lo, int* hi) {
  *hi = (sh.causal ? q_hi : sh.S - 1) / bk;
  *lo = sh.window > 0 ? max(0, q_lo - sh.window + 1) / bk : 0;
}

__device__ __forceinline__ bool unmasked(const Shape& sh, int qpos, int kpos) {
  return kpos < sh.S && (!sh.causal || kpos <= qpos) &&
         (sh.window <= 0 || kpos > qpos - sh.window);
}

// ------------------------------------------------------------ fp16 / bf16
constexpr int BQ = 128;          // query rows a block: two consumer warpgroups of 64
constexpr int BK = 128;          // keys a k/v tile
constexpr int BOX = 64;          // head-dim columns a TMA box: one 128-byte swizzled row
constexpr int ROW = 128;         // bytes of a box row in shared memory
constexpr int STAGES = 2;        // k/v ring
constexpr int CONSUMERS = 256;   // warpgroups 0 and 1 compute
constexpr int THREADS = CONSUMERS + 32;   // warp 8 loads

template <int HD> struct Geo {
  static constexpr int NB = (HD + BOX - 1) / BOX;   // boxes a row
  static constexpr int HDP = NB * BOX;              // head dim the products see
  static constexpr int QB = BQ * ROW;               // bytes of one box of the Q tile
  static constexpr int KB = BK * ROW;               // ... of a K or V tile
  static constexpr int Q_OFF = 0;                   // Q[buffer][box], two buffers
  static constexpr int K_OFF = 2 * NB * QB;         // K[stage][box]
  static constexpr int V_OFF = K_OFF + STAGES * NB * KB;
  static constexpr int BAR_OFF = V_OFF + STAGES * NB * KB;
  static constexpr int SMEM = BAR_OFF + 8 * (4 + 3 * STAGES) + 1024;   // + alignment slack
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
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
  asm volatile("{\n.reg .b64 st;\nmbarrier.arrive.shared::cta.b64 st, [%0];\n}\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

__device__ __forceinline__ uint64_t global_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// Wait for the phase of `parity` to complete.  A barrier still open after
// 2^22 polls and 4 s (a producer and its consumers disagreeing on the tile
// count) traps, which fails the launch instead of hanging the card.  Polls
// are made only while the kernel runs, so a context preempted or stopped
// in a debugger does not trap, however long it waits; a correct wait lasts a
// tile's work, microseconds.  A trap is a sticky error: it poisons the
// caller's CUDA context, and the process cannot go on using the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  const uint64_t t0 = global_ns();
  for (uint32_t polls = 1; !mbar_try_wait(bar, parity); ++polls)
    if (polls >= (1u << 22) && global_ns() - t0 > 4000000000ull) __trap();
}

// TMA: one box at coordinates (column, head, row, batch) into shared memory,
// completing `bar`'s transaction count.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void tma_store(const CUtensorMap* map, uint32_t src, int c0, int c1,
                                          int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%2, %3, %4, %5}], [%1];\n" ::
          "l"(reinterpret_cast<uint64_t>(map)), "r"(src), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// A wgmma operand descriptor for the 128-byte swizzle (layout type 1): start
// address, leading byte offset `lbo` (the distance between 64-column boxes
// of an MN-major operand; unused K-major) and 1024 bytes between 8-row groups.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16 |
         static_cast<uint64_t>(1024 >> 4) << 32 | 1ull << 62;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <typename T> struct Wgmma;

template <> struct Wgmma<__nv_bfloat16> {
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
  // d (64 x 128) = a . b (+ d if scale_d): a 64 x 16 and b 16 x 128 in shared memory, K-major.
  static __device__ __forceinline__ void ss128(float (&d)[64], uint64_t a, uint64_t b,
                                               int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "%64, %65, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(a), "l"(b), "r"(scale_d));
  }
  // d (64 x 64) = a . b (+ d if scale_d): a 64 x 16 and b 16 x 64 in shared memory, K-major.
  static __device__ __forceinline__ void ss64(float (&d)[32], uint64_t a, uint64_t b,
                                              int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "%32, %33, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(a), "l"(b), "r"(scale_d));
  }
  // d (64 x N) += a . b: a 64 x 16 in registers, b 16 x N in shared memory, MN-major.
  static __device__ __forceinline__ void rs(float (&d)[32], const uint32_t (&a)[4], uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
  static __device__ __forceinline__ void rs(float (&d)[64], const uint32_t (&a)[4], uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

template <> struct Wgmma<__half> {
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    __half2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
  static __device__ __forceinline__ void ss128(float (&d)[64], uint64_t a, uint64_t b,
                                               int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.f16.f16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "%64, %65, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(a), "l"(b), "r"(scale_d));
  }
  // d (64 x 64) = a . b (+ d if scale_d): a 64 x 16 and b 16 x 64 in shared memory, K-major.
  static __device__ __forceinline__ void ss64(float (&d)[32], uint64_t a, uint64_t b,
                                              int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.f16.f16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "%32, %33, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(a), "l"(b), "r"(scale_d));
  }
  static __device__ __forceinline__ void rs(float (&d)[32], const uint32_t (&a)[4], uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.f16.f16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
  static __device__ __forceinline__ void rs(float (&d)[64], const uint32_t (&a)[4], uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.f16.f16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keep the compiler from moving reads or writes of wgmma's registers across
// its issue and wait.
template <int N>
__device__ __forceinline__ void reg_fence(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int N>
__device__ __forceinline__ void reg_fence(uint32_t (&a)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int x = 0; x < 4; ++x) asm volatile("" : "+r"(a[i][x])::"memory");
}

// A consumer thread's accumulators: element 4 j + 2 r + e is row r (of its
// two rows, g and g + 8 of its warp's 16) and column 8 j + 2 tq + e, where
// lane = 4 g + tq; S is 64 x BK a warpgroup, O 64 x HDP.

// S = Q K^T of the tile in stage s for warpgroup cw: hd / 16 k-steps, 32
// bytes apart along a box row; issued and committed, not waited.
template <typename T, int HD>
__device__ __forceinline__ void issue_s(float (&sc)[BK / 2], uint32_t q_s, uint32_t k_s, int cw,
                                        int s) {
  using G = Geo<HD>;
  reg_fence(sc);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < G::HDP / 16; ++kk) {
    const uint32_t off = (kk % 4) * 32;
    const uint64_t da = sw128_desc(q_s + (kk / 4) * G::QB + cw * 64 * ROW + off, 16);
    const uint64_t db = sw128_desc(k_s + (s * G::NB + kk / 4) * G::KB + off, 16);
    Wgmma<T>::ss128(sc, da, db, kk > 0);
  }
  wgmma_commit();
}

// O += P V of the tile in stage s: BK / 16 k-steps, 16 rows (2048 bytes)
// apart; V's boxes one tile (KB bytes) apart along N.  Not waited.
template <typename T, int HD>
__device__ __forceinline__ void issue_pv(float (&o)[Geo<HD>::HDP / 2], uint32_t (&p)[BK / 16][4],
                                         uint32_t v_s, int s) {
  using G = Geo<HD>;
  reg_fence(o);
  reg_fence(p);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk)
    Wgmma<T>::rs(o, p[kk], sw128_desc(v_s + s * G::NB * G::KB + kk * 16 * ROW, G::KB));
  wgmma_commit();
}

// Scale the scores of the tile at key k0 (NS / 2 of a row's 2 NS keys a
// thread: BK keys, or W_BK at hd 256) into the log2 domain, masking only
// a tile that reaches past the causal diagonal of a row in [row_lo,
// row_hi], below its window, or past S; update the running max m and sum l
// of the thread's rows qpos[0..1] (the four lanes of a quad hold a row's
// scores between them); turn the scores into p; return each row's
// correction of the accumulator in corr.
template <int NS>
__device__ __forceinline__ void online_softmax(float (&sc)[NS], const Shape& sh, int k0,
                                               int row_lo, int row_hi, const int (&qpos)[2],
                                               int tq, float scale_log2, float (&m)[2],
                                               float (&l)[2], float (&corr)[2]) {
  constexpr int BKT = 2 * NS;
  const bool edge = (sh.causal && k0 + BKT - 1 > row_lo) || k0 + BKT > sh.S ||
                    (sh.window > 0 && k0 <= row_hi - sh.window);
  if (edge) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      // row r sees keys [lo, hi]
      const int hi = (sh.causal ? min(qpos[r], sh.S - 1) : sh.S - 1) - k0 - 2 * tq;
      const int lo = (sh.window > 0 ? qpos[r] - sh.window + 1 : 0) - k0 - 2 * tq;
#pragma unroll
      for (int j = 0; j < BKT / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& x = sc[4 * j + 2 * r + e];
          x = 8 * j + e >= lo && 8 * j + e <= hi ? x * scale_log2 : kNegInf;
        }
    }
  } else {
#pragma unroll
    for (int i = 0; i < BKT / 2; ++i) sc[i] *= scale_log2;
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float mx = kNegInf;
#pragma unroll
    for (int j = 0; j < BKT / 8; ++j) mx = fmaxf(mx, fmaxf(sc[4 * j + 2 * r], sc[4 * j + 2 * r + 1]));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m[r], mx);
    corr[r] = ex2(m[r] - m_new);
    m[r] = m_new;
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < BKT / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float& x = sc[4 * j + 2 * r + e];
        x = ex2(x - m_new);
        sum += x;
      }
    l[r] = l[r] * corr[r] + sum;        // this lane's share; summed over the quad at the end
  }
}

// P in wgmma's register-A layout: keys [16 kk, 16 kk + 16) are score
// columns 2 kk and 2 kk + 1 of 8.
template <typename T, int NS>
__device__ __forceinline__ void pack_p(const float (&sc)[NS], uint32_t (&p)[NS / 8][4]) {
#pragma unroll
  for (int kk = 0; kk < NS / 8; ++kk)
#pragma unroll
    for (int x = 0; x < 4; ++x) p[kk][x] = Wgmma<T>::pack(sc[8 * kk + 2 * x], sc[8 * kk + 2 * x + 1]);
}

template <int N>
__device__ __forceinline__ void rescale(float (&o)[N], const float (&corr)[2]) {
#pragma unroll
  for (int i = 0; i < N; ++i) o[i] *= corr[(i / 2) % 2];
}

// The work of one launch: every (b, h, query tile).  A unit pairs query
// tile j with tile n_qt - 1 - j of one (b, h) (the middle tile of an odd
// n_qt alone), so that under the causal mask every unit holds n_qt + 1 k/v
// tiles; block c of the persistent grid runs units c, c + G, c + 2G, ...,
// the longer tile of a unit first.  The pairing alone covers every query
// tile exactly once, causal or not: unit j < ceil(n_qt / 2) runs tile
// n_qt - 1 - j, the upper half down to the middle, and tile j, the lower
// half, unless j is that middle tile; the mask only sets each tile's k/v
// range (`tile_range`: without it, every key tile up to S).  Units run
// (b, h) by (b, h), so the blocks in flight at a time read the k/v of a few
// heads, which stay in L2.
struct Item {
  int qt, h, b, t_lo, t_hi;
};

template <int BKT = BK>
__device__ __forceinline__ bool unit_item(const Shape& sh, int u, int second, Item* it) {
  const int n_qt = (sh.S + BQ - 1) / BQ, n_pairs = (n_qt + 1) / 2;
  const int j = u % n_pairs, bh = u / n_pairs;
  if (second && j == n_qt - 1 - j) return false;
  it->qt = second ? j : n_qt - 1 - j;
  it->h = bh % sh.H;
  it->b = bh / sh.H;
  const int q0 = it->qt * BQ;
  tile_range(sh, q0, min(q0 + BQ, sh.S) - 1, BKT, &it->t_lo, &it->t_hi);
  return true;
}

__host__ __device__ __forceinline__ int num_units(int B, int S, int H) {
  return B * H * (((S + BQ - 1) / BQ + 1) / 2);
}

template <typename T, int HD>
__global__ void __launch_bounds__(THREADS, 1)
flash_tc_kernel(const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,
                const __grid_constant__ CUtensorMap vmap, const __grid_constant__ CUtensorMap omap,
                Shape sh, float scale_log2) {
  using G = Geo<HD>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;   // the swizzle's 1024-byte atoms
  const uint32_t q_s = base + G::Q_OFF, k_s = base + G::K_OFF, v_s = base + G::V_OFF;
  // Barriers: q_full[2], q_empty[2] (the two Q buffers), then k_full,
  // v_full and empty of each k/v stage.
  const uint32_t bars = base + G::BAR_OFF;
  const auto q_full = [&](int qb) { return bars + 8 * qb; };
  const auto q_empty = [&](int qb) { return bars + 8 * (2 + qb); };
  const auto k_full = [&](int s) { return bars + 8 * (4 + s); };
  const auto v_full = [&](int s) { return bars + 8 * (4 + STAGES + s); };
  const auto empty = [&](int s) { return bars + 8 * (4 + 2 * STAGES + s); };
  const int units = num_units(sh.B, sh.S, sh.H);

  if (threadIdx.x == 0) {
    for (int qb = 0; qb < 2; ++qb) {
      mbar_init(q_full(qb), 1);
      mbar_init(q_empty(qb), 2);                    // one thread of each consumer warpgroup
    }
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(k_full(s), 1);
      mbar_init(v_full(s), 1);
      mbar_init(empty(s), CONSUMERS);               // every consumer thread hands a stage back
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // The role, read as a warp-uniform value: warpgroups 0 and 1 compute,
  // warp 8 loads.
  if (__shfl_sync(0xffffffffu, threadIdx.x / 128, 0) == CONSUMERS / 128) {
    // ------------------------------------------------------------ producer
    // Item n's Q goes to buffer n % 2 once item n - 2's output has left it;
    // k/v tile number `it` (counted over the items) to stage it % STAGES.
    if (threadIdx.x == CONSUMERS) {
      int n = 0, it = 0;
      for (int u = blockIdx.x; u < units; u += gridDim.x)
        for (int second = 0; second < 2; ++second) {
          Item item;
          if (!unit_item(sh, u, second, &item)) continue;
          const int qb = n % 2, kvh = item.h / (sh.H / sh.KV);
          if (n >= 2) mbar_wait(q_empty(qb), (n / 2 - 1) & 1);
          mbar_expect_tx(q_full(qb), G::NB * G::QB);
#pragma unroll
          for (int c = 0; c < G::NB; ++c)
            tma_load(q_s + (qb * G::NB + c) * G::QB, &qmap, q_full(qb), c * BOX, item.h,
                     item.qt * BQ, item.b);
          for (int t = item.t_lo; t <= item.t_hi; ++t, ++it) {
            const int s = it % STAGES;
            if (it >= STAGES) mbar_wait(empty(s), (it / STAGES - 1) & 1);
            mbar_expect_tx(k_full(s), G::NB * G::KB);
#pragma unroll
            for (int c = 0; c < G::NB; ++c)
              tma_load(k_s + (s * G::NB + c) * G::KB, &kmap, k_full(s), c * BOX, kvh, t * BK,
                       item.b);
            mbar_expect_tx(v_full(s), G::NB * G::KB);
#pragma unroll
            for (int c = 0; c < G::NB; ++c)
              tma_load(v_s + (s * G::NB + c) * G::KB, &vmap, v_full(s), c * BOX, kvh, t * BK,
                       item.b);
          }
          ++n;
        }
    }
  } else {
    // ----------------------------------------------------------- consumers
    const int cw = threadIdx.x / 128;               // rows [64 cw, 64 cw + 64) of a tile
    const int warp = threadIdx.x / 32 % 4, lane = threadIdx.x % 32, g = lane / 4, tq = lane % 4;
    constexpr int NO = G::HDP / 2;
    float o[NO], sc[BK / 2];
    uint32_t p[BK / 16][4];
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) sc[i] = 0.f;
    int n = 0, it = 0;
    for (int u = blockIdx.x; u < units; u += gridDim.x)
      for (int second = 0; second < 2; ++second) {
        Item item;
        if (!unit_item(sh, u, second, &item)) continue;
        const int qb = n % 2;
        const uint32_t qbuf = q_s + qb * G::NB * G::QB;
        const int row_lo = item.qt * BQ + 64 * cw, row_hi = min(row_lo + 63, sh.S - 1);
        const int qpos[2] = {row_lo + 16 * warp + g, row_lo + 16 * warp + g + 8};
        float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f}, corr[2];
#pragma unroll
        for (int i = 0; i < NO; ++i) o[i] = 0.f;

        mbar_wait(q_full(qb), (n / 2) & 1);
        for (int t = item.t_lo; t <= item.t_hi; ++t, ++it) {
          const int s = it % STAGES;
          const uint32_t phase = (it / STAGES) & 1;
          mbar_wait(k_full(s), phase);
          issue_s<T, HD>(sc, qbuf, k_s, cw, s);
          wgmma_wait_all();
          reg_fence(sc);
          online_softmax(sc, sh, t * BK, row_lo, row_hi, qpos, tq, scale_log2, m, l, corr);
          rescale(o, corr);
          pack_p<T>(sc, p);
          mbar_wait(v_full(s), phase);
          issue_pv<T, HD>(o, p, v_s, s);
          wgmma_wait_all();
          reg_fence(o);
          mbar_arrive(empty(s));
        }

        // Epilogue: normalise, stage the rows in this warpgroup's own 64
        // rows of the Q buffer (their last read is done) in the TMA box's
        // swizzled layout, store them by TMA, and hand the buffer back once
        // the store has read it.
        float inv[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          float lsum = l[r];
          lsum += __shfl_xor_sync(0xffffffffu, lsum, 1);
          lsum += __shfl_xor_sync(0xffffffffu, lsum, 2);
          inv[r] = 1.f / fmaxf(lsum, 1e-30f);
        }
#pragma unroll
        for (int c = 0; c < NO / 4; ++c)
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int row = 64 * cw + 16 * warp + g + 8 * r;
            const uint32_t dst =
                qbuf + (c / 8) * G::QB + row * ROW + (((c % 8) ^ (row % 8)) << 4) + 4 * tq;
            asm volatile("st.shared.u32 [%0], %1;\n" ::"r"(dst),
                         "r"(Wgmma<T>::pack(o[4 * c + 2 * r] * inv[r], o[4 * c + 2 * r + 1] * inv[r]))
                         : "memory");
          }
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        asm volatile("bar.sync %0, 128;\n" ::"r"(1 + cw) : "memory");
        if (threadIdx.x % 128 == 0) {
          if (row_lo < sh.S) {
#pragma unroll
            for (int bx = 0; bx < G::NB; ++bx)
              tma_store(&omap, qbuf + bx * G::QB + cw * 64 * ROW, bx * BOX, item.h, row_lo, item.b);
            asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
            asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
          }
          mbar_arrive(q_empty(qb));
        }
        ++n;
      }
    if (threadIdx.x % 128 == 0) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
  }
}

// ------------------------------------------------------------ hd 256, fp16 / bf16
// recurrentgemma's local attention (hd 256, MQA).  At hd 128's tiling a
// consumer would hold O (64 x 256 fp32: 128 registers), an S tile of 64 x
// 128 (64) and P (32), far over the 168 registers ptxas keeps at 288
// threads, and two Q buffers with two stages of 128-key K and V would take
// 384 KB of shared memory.  So this kernel keeps the two consumer
// warpgroups and drops the producer warp: 256 threads, a ceiling of 255
// registers (O 128, S 32, P 16), 64-key tiles, and thread 0 issues the TMA
// loads between its own tiles.  The two warpgroups walk the k/v tiles in
// step, a __syncthreads ending each tile, so that the stage a tile freed is
// the one the next tile's prefetch fills: tile t + 1 is in flight while
// tile t computes.  One Q buffer (64 KB) and two stages of 32 + 32 KB: 192
// KB of shared memory.  The item walk, the mask, the online softmax and the
// epilogue are hd 128's.  O's 256 columns are two m64n128k16 products a
// k-step, over V's boxes 0-1 and 2-3.
constexpr int W_BK = 64;         // keys a k/v tile at hd 256
constexpr int W_THREADS = 256;   // warpgroups 0 and 1 compute; thread 0 also loads

struct Geo256 {
  static constexpr int NB = 4;                      // boxes a row
  static constexpr int QB = BQ * ROW;               // bytes of one box of the Q tile
  static constexpr int KB = W_BK * ROW;             // ... of a K or V tile
  static constexpr int Q_OFF = 0;                   // Q[box], one buffer
  static constexpr int K_OFF = NB * QB;             // K[stage][box]
  static constexpr int V_OFF = K_OFF + STAGES * NB * KB;
  static constexpr int BAR_OFF = V_OFF + STAGES * NB * KB;
  static constexpr int SMEM = BAR_OFF + 8 * (1 + 2 * STAGES) + 1024;   // + alignment slack
};

template <typename T>
__global__ void __launch_bounds__(W_THREADS, 1)
flash_tc256_kernel(const __grid_constant__ CUtensorMap qmap,
                   const __grid_constant__ CUtensorMap kmap,
                   const __grid_constant__ CUtensorMap vmap,
                   const __grid_constant__ CUtensorMap omap, Shape sh, float scale_log2) {
  using G = Geo256;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;   // the swizzle's 1024-byte atoms
  const uint32_t q_s = base + G::Q_OFF, k_s = base + G::K_OFF, v_s = base + G::V_OFF;
  // Barriers: q_full, then k_full and v_full of each stage.
  const uint32_t bars = base + G::BAR_OFF, q_full = bars;
  const auto k_full = [&](int s) { return bars + 8 * (1 + s); };
  const auto v_full = [&](int s) { return bars + 8 * (1 + STAGES + s); };
  const int units = num_units(sh.B, sh.S, sh.H);
  const bool loader = threadIdx.x == 0;

  if (loader) {
    mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(k_full(s), 1);
      mbar_init(v_full(s), 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // k/v tile t of KV head kvh, batch b, into stage s.
  const auto load_kv = [&](int t, int s, int kvh, int b) {
    mbar_expect_tx(k_full(s), G::NB * G::KB);
#pragma unroll
    for (int c = 0; c < G::NB; ++c)
      tma_load(k_s + (s * G::NB + c) * G::KB, &kmap, k_full(s), c * BOX, kvh, t * W_BK, b);
    mbar_expect_tx(v_full(s), G::NB * G::KB);
#pragma unroll
    for (int c = 0; c < G::NB; ++c)
      tma_load(v_s + (s * G::NB + c) * G::KB, &vmap, v_full(s), c * BOX, kvh, t * W_BK, b);
  };

  const int cw = threadIdx.x / 128;               // rows [64 cw, 64 cw + 64) of a tile
  const int warp = threadIdx.x / 32 % 4, lane = threadIdx.x % 32, g = lane / 4, tq = lane % 4;
  float o[2][64], sc[W_BK / 2];
  uint32_t p[W_BK / 16][4];
#pragma unroll
  for (int i = 0; i < W_BK / 2; ++i) sc[i] = 0.f;
  int n = 0, it = 0;
  for (int u = blockIdx.x; u < units; u += gridDim.x)
    for (int second = 0; second < 2; ++second) {
      Item item;
      if (!unit_item<W_BK>(sh, u, second, &item)) continue;
      const int kvh = item.h / (sh.H / sh.KV);
      // Every thread is done with the stages, and the last item's output
      // store has read the Q buffer (its thread waited for that first).
      __syncthreads();
      if (loader) {
        mbar_expect_tx(q_full, G::NB * G::QB);
#pragma unroll
        for (int c = 0; c < G::NB; ++c)
          tma_load(q_s + c * G::QB, &qmap, q_full, c * BOX, item.h, item.qt * BQ, item.b);
        load_kv(item.t_lo, it % STAGES, kvh, item.b);
      }
      const int row_lo = item.qt * BQ + 64 * cw, row_hi = min(row_lo + 63, sh.S - 1);
      const int qpos[2] = {row_lo + 16 * warp + g, row_lo + 16 * warp + g + 8};
      float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f}, corr[2];
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int i = 0; i < 64; ++i) o[h][i] = 0.f;

      mbar_wait(q_full, n & 1);
      for (int t = item.t_lo; t <= item.t_hi; ++t, ++it) {
        const int s = it % STAGES;
        const uint32_t phase = (it / STAGES) & 1;
        // Tile t + 1 goes to the other stage, which tile t - 1 freed.
        if (loader && t < item.t_hi) load_kv(t + 1, (it + 1) % STAGES, kvh, item.b);
        mbar_wait(k_full(s), phase);
        // S = Q K^T: 16 k-steps, 32 bytes apart along a box row.
        reg_fence(sc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < G::NB * 4; ++kk) {
          const uint32_t off = (kk % 4) * 32;
          const uint64_t da = sw128_desc(q_s + (kk / 4) * G::QB + cw * 64 * ROW + off, 16);
          const uint64_t db = sw128_desc(k_s + (s * G::NB + kk / 4) * G::KB + off, 16);
          Wgmma<T>::ss64(sc, da, db, kk > 0);
        }
        wgmma_commit();
        wgmma_wait_all();
        reg_fence(sc);
        online_softmax(sc, sh, t * W_BK, row_lo, row_hi, qpos, tq, scale_log2, m, l, corr);
        rescale(o[0], corr);
        rescale(o[1], corr);
        pack_p<T>(sc, p);
        mbar_wait(v_full(s), phase);
        // O += P V: 4 k-steps of 16 rows, each over V's boxes 0-1 and 2-3.
        reg_fence(o[0]);
        reg_fence(o[1]);
        reg_fence(p);
        wgmma_fence();
        const uint32_t vt = v_s + s * G::NB * G::KB;
#pragma unroll
        for (int kk = 0; kk < W_BK / 16; ++kk) {
          Wgmma<T>::rs(o[0], p[kk], sw128_desc(vt + kk * 16 * ROW, G::KB));
          Wgmma<T>::rs(o[1], p[kk], sw128_desc(vt + 2 * G::KB + kk * 16 * ROW, G::KB));
        }
        wgmma_commit();
        wgmma_wait_all();
        reg_fence(o[0]);
        reg_fence(o[1]);
        __syncthreads();          // stage s is free for tile t + 2
      }

      // Epilogue, as hd 128's: normalise, stage the rows in this
      // warpgroup's 64 rows of the Q buffer, store them by TMA.
      float inv[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float lsum = l[r];
        lsum += __shfl_xor_sync(0xffffffffu, lsum, 1);
        lsum += __shfl_xor_sync(0xffffffffu, lsum, 2);
        inv[r] = 1.f / fmaxf(lsum, 1e-30f);
      }
#pragma unroll
      for (int c = 0; c < 32; ++c)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int row = 64 * cw + 16 * warp + g + 8 * r;
          const uint32_t dst =
              q_s + (c / 8) * G::QB + row * ROW + (((c % 8) ^ (row % 8)) << 4) + 4 * tq;
          const int e = 4 * (c % 16) + 2 * r;
          asm volatile("st.shared.u32 [%0], %1;\n" ::"r"(dst),
                       "r"(Wgmma<T>::pack(o[c / 16][e] * inv[r], o[c / 16][e + 1] * inv[r]))
                       : "memory");
        }
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      asm volatile("bar.sync %0, 128;\n" ::"r"(1 + cw) : "memory");
      if (threadIdx.x % 128 == 0 && row_lo < sh.S) {
#pragma unroll
        for (int bx = 0; bx < G::NB; ++bx)
          tma_store(&omap, q_s + bx * G::QB + cw * 64 * ROW, bx * BOX, item.h, row_lo, item.b);
        asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
        asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
      }
      ++n;
    }
  if (threadIdx.x % 128 == 0) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// ------------------------------------------------------------------------ fp32
constexpr int F_BQ = 32;         // query rows a block (4 a warp)
constexpr int F_BK = 32;         // keys a tile (one a lane)
constexpr int F_THREADS = 256;
constexpr int F_ROWS = F_BQ / (F_THREADS / 32);

// Stage rows [row0, row0 + F_BK) of one fp32 head (row stride `ld` floats in
// shared memory), 16 bytes a thread, zeros past S.
template <int HD>
__device__ __forceinline__ void stage_f32(float* dst, int ld, const float* src,
                                          int64_t s_stride, int row0, int rows, int S) {
  constexpr int PER_ROW = HD / 4;
  for (int i = threadIdx.x; i < rows * PER_ROW; i += blockDim.x) {
    const int r = i / PER_ROW, c = (i % PER_ROW) * 4;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < S)
      val = __ldg(reinterpret_cast<const float4*>(src + (int64_t)(row0 + r) * s_stride + c));
    dst[r * ld + c] = val.x;
    dst[r * ld + c + 1] = val.y;
    dst[r * ld + c + 2] = val.z;
    dst[r * ld + c + 3] = val.w;
  }
}

template <int HD>
__global__ void __launch_bounds__(F_THREADS)
flash_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o, Shape sh, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* q_s = reinterpret_cast<float*>(smem_raw);          // [F_BQ][HD]
  float* k_s = q_s + F_BQ * HD;                              // [F_BK][HD + 1]
  float* v_s = k_s + F_BK * (HD + 1);                        // [F_BK][HD]

  const int n_qt = (sh.S + F_BQ - 1) / F_BQ;
  const int qt = n_qt - 1 - blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (sh.H / sh.KV);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int q0 = qt * F_BQ;
  constexpr int CPL = HD / 32;          // output columns a lane: lane + 32 c

  const float* qb = q + b * sh.qs_b + h * sh.qs_h;
  const float* kb = k + b * sh.ks_b + kvh * sh.ks_h;
  const float* vb = v + b * sh.ks_b + kvh * sh.ks_h;
  stage_f32<HD>(q_s, HD, qb, sh.qs_s, q0, F_BQ, sh.S);

  float m[F_ROWS], l[F_ROWS], acc[F_ROWS][CPL];
#pragma unroll
  for (int i = 0; i < F_ROWS; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < CPL; ++c) acc[i][c] = 0.f;
  }

  int t_lo, t_hi;
  tile_range(sh, q0, min(q0 + F_BQ, sh.S) - 1, F_BK, &t_lo, &t_hi);
  for (int t = t_lo; t <= t_hi; ++t) {
    const int k0 = t * F_BK;
    __syncthreads();
    stage_f32<HD>(k_s, HD + 1, kb, sh.ks_s, k0, F_BK, sh.S);
    stage_f32<HD>(v_s, HD, vb, sh.ks_s, k0, F_BK, sh.S);
    __syncthreads();

    const int kpos = k0 + lane;
    float s[F_ROWS];
#pragma unroll
    for (int i = 0; i < F_ROWS; ++i) s[i] = 0.f;
    for (int c = 0; c < HD; ++c) {
      const float kc = k_s[lane * (HD + 1) + c];
#pragma unroll
      for (int i = 0; i < F_ROWS; ++i) s[i] = fmaf(q_s[(warp + 8 * i) * HD + c], kc, s[i]);
    }
#pragma unroll
    for (int i = 0; i < F_ROWS; ++i) {
      const int qpos = q0 + warp + 8 * i;
      float x = unmasked(sh, qpos, kpos) ? s[i] * scale : kNegInf;
      float mx = x;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float corr = expf(m[i] - m_new);
      const float p = expf(x - m_new);
      float sum = p;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = l[i] * corr + sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < CPL; ++c) acc[i][c] *= corr;
      for (int j = 0; j < F_BK; ++j) {
        const float pj = __shfl_sync(0xffffffffu, p, j);
#pragma unroll
        for (int c = 0; c < CPL; ++c) acc[i][c] = fmaf(pj, v_s[j * HD + lane + 32 * c], acc[i][c]);
      }
    }
  }

  float* ob = o + b * sh.qs_b + h * sh.qs_h;
#pragma unroll
  for (int i = 0; i < F_ROWS; ++i) {
    const int qpos = q0 + warp + 8 * i;
    if (qpos < sh.S) {
      const float inv = 1.f / fmaxf(l[i], 1e-30f);
#pragma unroll
      for (int c = 0; c < CPL; ++c) ob[(int64_t)qpos * sh.qs_s + lane + 32 * c] = acc[i][c] * inv;
    }
  }
}

// -------------------------------------------------------------------- launchers
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled (libcuda), looked up through the CUDA runtime's
// entry-point query so that the library needs no -lcuda; null if missing.
EncodeTiled encoder() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &found);
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// A tensor map over one (B, S, heads, hd) tensor of 16-bit elements (strides
// in elements), boxes of BOX columns by `rows` rows of one head, 128-byte
// swizzle, zeros outside the tensor.
bool tensor_map(CUtensorMap* map, EncodeTiled enc, CUtensorMapDataType dt, const void* ptr,
                int B, int S, int heads, int hd, int64_t s_b, int64_t s_s, int64_t s_h,
                int rows) {
  const cuuint64_t dims[4] = {(cuuint64_t)hd, (cuuint64_t)heads, (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)s_h * 2, (cuuint64_t)s_s * 2, (cuuint64_t)s_b * 2};
  const cuuint32_t box[4] = {BOX, 1, (cuuint32_t)rows, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return enc(map, dt, 4, const_cast<void*>(ptr), dims, strides, box, unit,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename T, int HD>
cudaError_t launch_tc(const void* q, const void* k, const void* v, void* o, const Shape& sh,
                      cudaStream_t stream) {
  const EncodeTiled enc = encoder();
  if (enc == nullptr) return cudaErrorNotSupported;
  const CUtensorMapDataType dt = std::is_same<T, __half>::value ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                                                                : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  CUtensorMap qm, km, vm, om;
  if (!tensor_map(&qm, enc, dt, q, sh.B, sh.S, sh.H, HD, sh.qs_b, sh.qs_s, sh.qs_h, BQ) ||
      !tensor_map(&km, enc, dt, k, sh.B, sh.S, sh.KV, HD, sh.ks_b, sh.ks_s, sh.ks_h, BK) ||
      !tensor_map(&vm, enc, dt, v, sh.B, sh.S, sh.KV, HD, sh.ks_b, sh.ks_s, sh.ks_h, BK) ||
      !tensor_map(&om, enc, dt, o, sh.B, sh.S, sh.H, HD, sh.qs_b, sh.qs_s, sh.qs_h, BQ / 2))
    return cudaErrorInvalidValue;
  const int smem = Geo<HD>::SMEM;
  cudaError_t err = cudaFuncSetAttribute(flash_tc_kernel<T, HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  int device, sms;
  if ((err = cudaGetDevice(&device)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess)
    return err;
  const int grid = min(sms, num_units(sh.B, sh.S, sh.H));   // persistent: one block an SM
  const float scale_log2 = kLog2e / sqrtf((float)HD);
  flash_tc_kernel<T, HD><<<grid, THREADS, smem, stream>>>(qm, km, vm, om, sh, scale_log2);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_tc256(const void* q, const void* k, const void* v, void* o, const Shape& sh,
                         cudaStream_t stream) {
  constexpr int HD = 256;
  const EncodeTiled enc = encoder();
  if (enc == nullptr) return cudaErrorNotSupported;
  const CUtensorMapDataType dt = std::is_same<T, __half>::value ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                                                                : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  CUtensorMap qm, km, vm, om;
  if (!tensor_map(&qm, enc, dt, q, sh.B, sh.S, sh.H, HD, sh.qs_b, sh.qs_s, sh.qs_h, BQ) ||
      !tensor_map(&km, enc, dt, k, sh.B, sh.S, sh.KV, HD, sh.ks_b, sh.ks_s, sh.ks_h, W_BK) ||
      !tensor_map(&vm, enc, dt, v, sh.B, sh.S, sh.KV, HD, sh.ks_b, sh.ks_s, sh.ks_h, W_BK) ||
      !tensor_map(&om, enc, dt, o, sh.B, sh.S, sh.H, HD, sh.qs_b, sh.qs_s, sh.qs_h, BQ / 2))
    return cudaErrorInvalidValue;
  const int smem = Geo256::SMEM;
  cudaError_t err = cudaFuncSetAttribute(flash_tc256_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  int device, sms;
  if ((err = cudaGetDevice(&device)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess)
    return err;
  const int grid = min(sms, num_units(sh.B, sh.S, sh.H));   // persistent: one block an SM
  const float scale_log2 = kLog2e / sqrtf((float)HD);
  flash_tc256_kernel<T><<<grid, W_THREADS, smem, stream>>>(qm, km, vm, om, sh, scale_log2);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* o, const Shape& sh,
                       cudaStream_t stream) {
  const size_t smem = sizeof(float) * ((size_t)F_BQ * HD + (size_t)F_BK * (HD + 1) +
                                       (size_t)F_BK * HD);
  cudaError_t err = cudaFuncSetAttribute(flash_f32_kernel<HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((sh.S + F_BQ - 1) / F_BQ, sh.H, sh.B);
  flash_f32_kernel<HD><<<grid, F_THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), sh, 1.f / sqrtf((float)HD));
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch_hd(int dtype, const void* q, const void* k, const void* v, void* o,
                      const Shape& sh, cudaStream_t stream) {
  switch (dtype) {
    case 0: return launch_f32<HD>(q, k, v, o, sh, stream);
    case 1:
      if constexpr (HD == 256) return launch_tc256<__nv_bfloat16>(q, k, v, o, sh, stream);
      else return launch_tc<__nv_bfloat16, HD>(q, k, v, o, sh, stream);
    case 2:
      if constexpr (HD == 256) return launch_tc256<__half>(q, k, v, o, sh, stream);
      else return launch_tc<__half, HD>(q, k, v, o, sh, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 float32, 1 bfloat16, 2 float16.  window <= 0: no window.  Strides
// are in elements; v has k's strides and o has q's.  Returns the launch's
// cudaError_t (0 on success).
extern "C" int fa_flash_attention(int dtype, int B, int S, int H, int KV, int hd, int causal,
                                  int window, const void* q, const void* k, const void* v,
                                  void* o, int64_t qs_b, int64_t qs_s, int64_t qs_h,
                                  int64_t ks_b, int64_t ks_s, int64_t ks_h, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || KV <= 0 || H % KV != 0) return (int)cudaErrorInvalidValue;
  const Shape sh{B, S, H, KV, causal, window, qs_b, qs_s, qs_h, ks_b, ks_s, ks_h};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 32: return (int)launch_hd<32>(dtype, q, k, v, o, sh, st);
    case 64: return (int)launch_hd<64>(dtype, q, k, v, o, sh, st);
    case 96: return (int)launch_hd<96>(dtype, q, k, v, o, sh, st);
    case 128: return (int)launch_hd<128>(dtype, q, k, v, o, sh, st);
    case 256: return (int)launch_hd<256>(dtype, q, k, v, o, sh, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
