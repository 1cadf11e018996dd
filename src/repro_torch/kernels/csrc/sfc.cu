// Hand-written Hopper (sm_90a) kernels for the SFC element ops of the forest
// pipeline.  New -> Adapt -> Partition: encode (morton key), decode, parent
// (+ local index) and children.  Balance -> Ghost -> validate: the fused face
// sweep, the routing eval, and the inside-root test; over a coarse mesh, the
// tree transform of every face crossing.  The element queries of paper
// Section 4: the owner rank of a key against the partition markers (Ghost's
// owner lookup), the successor (Algorithm 4.10) and the single-face neighbor
// (Algorithm 4.6).  One thread per element (per element and child for
// `children`), templated on the dimension D and the element class EC:
// simplices on the tetrahedral Morton curve (kSimplex), or quads and
// hexahedra on the plain Morton curve (kHex), whose bodies read no type
// column and write it as 0.  Each entry point takes the class and launches
// its body; `eval_route` and `owner_rank` have one body for both and run on
// a persistent grid, eval_route over the (face, element) pairs of all its
// face planes (d + 1 a simplex, 2d a hex).
//
// Each kernel computes what the JAX package's Pallas kernel of the same name
// computes (src/repro/kernels/sfc.py), bit for bit, but none carries over the
// TPU's block structure:
//   * The packed (cube-id, type) transition tables — at most 48 bytes each —
//     are generated from repro_torch/core/tables.py into sfc_tables.h as
//     __constant__ arrays, copied into shared memory at block start, and
//     indexed directly.  (The TPU kernels turn every lookup into a 48-way
//     masked sum, `_lut`, because the TPU has no per-lane gather; a direct
//     __constant__ read would serialise a warp over its distinct addresses.)
//     Table indices are masked to the 64-byte shared copy, so an element of
//     an out-of-range type reads a wrong entry, never out of bounds.
//   * The simplex bodies of morton_key and decode walk m levels a lookup
//     instead (m = 5 at d = 2, 3 at d = 3): build.py composes m-level tables
//     from the one-level ones (4 and 6 KB, in __constant__ memory), and each
//     resident block of a persistent grid copies its table into shared
//     memory once, through the table's global address.
//   * The face-neighbor table (16 bits an entry) is copied to shared memory
//     the same way.  The root simplex's Proposition-23 constants (its axis
//     permutation, and the type sets outside each boundary) are generated
//     as compile-time constants and bit masks over the types, so the
//     inside-root test reads no table at all.
//   * Keys are one 64-bit integer per element; the (hi, lo) uint32 word
//     straddling of the TPU kernels disappears.
//   * The level loops are unrolled at compile time (MAXLEVEL is a constant).
//   * The hex key is the bit interleave of the anchor, which the TPU kernels
//     build one level at a time (_hex_encode_expr); here each coordinate's
//     low L bits are spread apart by a fixed chain of shifts and masks, and
//     decode gathers them back the same way.  The hex face-neighbor table
//     (2d entries of 16 bits) is generated and staged like the simplex one.
//
// Bound: the bytes each kernel must move at one H100 SXM's 3.35 TB/s
// device memory, counting each input byte read once and each output byte
// written once.  Simplex bodies, per element, d = 3 / d = 2:
//   morton_key  anchor + type in, key out        24 / 20 B
//   decode      key + level in, anchor + type out 28 / 24 B
//   parent      anchor + level + type in,
//               anchor + level + type + index out 44 / 36 B
//   children    anchor + level + type in,
//               2^d x (anchor + level + type) out 180 / 80 B
//   face_sweep  anchor + level + type in, (d+1) x (neighbor anchor + type
//               + dual int32, inside 1 B, key 8 B) out      136 / 91 B
//   eval_route  (d+1) x (tree int32 + key int64) + level in,
//               (d+1) x (end key int64 + first + last int32) out
//                                              116 / 88 B (+ 12 B a marker)
//   inside_root anchor + level + type in, 1 B out          21 / 17 B
//   tree_transform connection + anchor + level + type + dual in,
//               anchor + type + dual + tree out  52 / 44 B (+ 4W B a connection)
//   owner_rank  tree + key in, rank out           16 B (+ 12 B a marker)
//   successor   anchor + level + type in, anchor + type out  36 / 28 B
//   face_neighbor anchor + level + type + face in,
//               anchor + type + dual out          44 / 36 B
// Hex bodies read no type column; those that write one write zeros, which
// count.  Per element, d = 3 / d = 2:
//   morton_key  anchor in, key out                20 / 16 B
//   decode      key + level in, anchor + type out 28 / 24 B
//   parent      anchor + level in,
//               anchor + level + type + index out 40 / 32 B
//   children    anchor + level in,
//               2^d x (anchor + level + type) out 176 / 76 B
//   face_sweep  anchor + level in, 2d x (neighbor anchor + type + dual
//               int32, inside 1 B, key 8 B) out  190 / 112 B
//   eval_route  as above over 2d planes          172 / 116 B (+ 12 B a marker)
//   inside_root anchor + level in, 1 B out        17 / 13 B
//   tree_transform connection + anchor + level + dual in,
//               anchor + type + dual + tree out  48 / 40 B (+ 4W B a connection)
//   successor   anchor + level in, anchor + type out  32 / 24 B
//   face_neighbor anchor + level + face in,
//               anchor + type + dual out          40 / 32 B
// These integer table walks and bit shuffles do no floating-point work, and
// no published integer peak fits them, so the bound has no operations term.
// What the design does about it: encode and decode keep the whole level
// chain in registers and read the tables from shared memory, so the only
// memory traffic is the element itself (and a 4-6 KB table a resident
// block); walking m levels a lookup, a simplex issues about a fifth of the
// instructions of a walk one level at a time, which alone took longer than
// the bytes at d = 2 (30 levels); parent and children are single
// passes whose stores are contiguous across the threads of a warp.  The
// face sweep reads each element once and writes every face's outputs
// face-major ((nf, n) planes), so each store is contiguous across a warp;
// eval_route and owner_rank stage a table of up to 16384 partition markers
// (every marker up to P = 16384, every s-th past it) into shared memory
// once per resident block of a persistent grid and find a query's owner in
// O(log P) dependent steps, the last log2 s of them in one window of
// markers in global memory (`owner_count`); tree_transform reads its
// connection rows through the read-only cache; successor finds a simplex's carry level from the
// trailing bits its coordinates share and reads one entry of each packed
// table (the walks remain for elements outside the root), and
// face_neighbor is one table lookup.
//
// Every entry point launches on the caller's stream, does not synchronise,
// allocates nothing, and returns cudaGetLastError() after the launch.

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cuda_runtime.h>

#include "sfc_tables.h"

namespace {

constexpr int kThreads = 256;
constexpr int kTab = 64;  // shared copy of a packed table; index mask kTab - 1
constexpr int kNei = 32;  // shared copy of a face-neighbor table; mask kNei - 1
constexpr int kOwnerThreads = 1024;   // owner_rank and eval_route: a block of the persistent grid,
constexpr int kTableHeight = 14;      // with a table of up to 2^14 splitters (192 KB)
constexpr int kSimplex = 0, kHex = 1;  // element classes, as core/types.py tags them

template <int D> struct Dim;
template <> struct Dim<2> {
  static constexpr int L = SFC_MAXLEVEL_2;
  static constexpr int NT = 2;
  static constexpr int PI = SFC_ROOT_PERM_2_0, PJ = SFC_ROOT_PERM_2_1;
  static constexpr unsigned OUT_KJ = SFC_ROOT_OUT_KJ_2;  // triangles have no ik/diag cases
};
template <> struct Dim<3> {
  static constexpr int L = SFC_MAXLEVEL_3;
  static constexpr int NT = 6;
  static constexpr int PI = SFC_ROOT_PERM_3_0, PJ = SFC_ROOT_PERM_3_1, PK = SFC_ROOT_PERM_3_2;
  static constexpr unsigned OUT_IK = SFC_ROOT_OUT_IK_3, OUT_KJ = SFC_ROOT_OUT_KJ_3,
                            OUT_DIAG = SFC_ROOT_OUT_DIAG_3;
};

// enc[b * 2^D + cid] = local index | parent type << 3   (Table 6 + Fig. 8)
// dec[b * 2^D + iloc] = cube id | child type << 3         (Tables 7 + 8)
enum Table { kEnc, kDec };
template <int D, Table T> __device__ __forceinline__ unsigned char table_entry(int i);
template <> __device__ __forceinline__ unsigned char table_entry<2, kEnc>(int i) { return sfc_enc_2[i]; }
template <> __device__ __forceinline__ unsigned char table_entry<3, kEnc>(int i) { return sfc_enc_3[i]; }
template <> __device__ __forceinline__ unsigned char table_entry<2, kDec>(int i) { return sfc_dec_2[i]; }
template <> __device__ __forceinline__ unsigned char table_entry<3, kDec>(int i) { return sfc_dec_3[i]; }

// Copies a packed table into shared memory, zero-padded to kTab entries.
// Every thread of the block must reach this (it ends in __syncthreads).
template <int D, Table T>
__device__ __forceinline__ void load_table(unsigned char* dst) {
  constexpr int n = Dim<D>::NT * (1 << D);
  for (int i = threadIdx.x; i < kTab; i += blockDim.x) dst[i] = i < n ? table_entry<D, T>(i) : 0;
  __syncthreads();
}

// The packed face-neighbor table of class EC, entry i: the simplex table
// (entry b * (D+1) + f) or the hex one (entry f).
template <int D, int EC>
__device__ __forceinline__ unsigned short neighbor_entry(int i) {
  if constexpr (EC == kHex) {
    if constexpr (D == 2) return sfc_hex_nei_2[i];
    else return sfc_hex_nei_3[i];
  } else {
    if constexpr (D == 2) return sfc_nei_2[i];
    else return sfc_nei_3[i];
  }
}

// Copies the packed face-neighbor table of class EC into shared memory,
// zero-padded to kNei entries.  Every thread of the block must reach this.
template <int D, int EC>
__device__ __forceinline__ void load_neighbor_table(unsigned short* dst) {
  constexpr int n = EC == kHex ? 2 * D : Dim<D>::NT * (D + 1);
  for (int i = threadIdx.x; i < kNei; i += blockDim.x) dst[i] = i < n ? neighbor_entry<D, EC>(i) : 0;
  __syncthreads();
}

// The level-padded key of anchor c and type b (_encode_expr, sfc.py:100):
// fine -> coarse over the levels, each digit the local index of the
// (cube-id, type) pair, the type walking up through the parent-type table.
// The level plays no role: below an element's level its anchor bits are
// zero, cube-id 0 keeps the type and contributes digit 0.  Only the low L
// bits of each coordinate are read, so an anchor outside the root cube
// (a neighbor across the root boundary) still gives a defined key.
template <int D>
__device__ __forceinline__ int64_t encode_key(const int (&c)[D], int b, const unsigned char* enc) {
  constexpr int L = Dim<D>::L, NC = 1 << D;
  uint64_t k64 = 0;
#pragma unroll
  for (int lv = L; lv >= 1; --lv) {
    int cid = 0;
#pragma unroll
    for (int k = 0; k < D; ++k) cid |= ((c[k] >> (L - lv)) & 1) << k;
    const int p = enc[(b * NC + cid) & (kTab - 1)];
    k64 |= static_cast<uint64_t>(p & 7) << (D * (L - lv));
    b = p >> 3;
  }
  return static_cast<int64_t>(k64);
}

// The low L bits of x spread D apart: bit j goes to bit D*j.
template <int D>
__device__ __forceinline__ uint64_t spread_bits(uint32_t x) {
  uint64_t v = x & ((1u << Dim<D>::L) - 1);
  if constexpr (D == 3) {  // 21 bits -> 63
    v = (v | (v << 32)) & 0x001F00000000FFFFull;
    v = (v | (v << 16)) & 0x001F0000FF0000FFull;
    v = (v | (v << 8)) & 0x100F00F00F00F00Full;
    v = (v | (v << 4)) & 0x10C30C30C30C30C3ull;
    v = (v | (v << 2)) & 0x1249249249249249ull;
  } else {  // 30 bits -> 60
    v = (v | (v << 16)) & 0x0000FFFF0000FFFFull;
    v = (v | (v << 8)) & 0x00FF00FF00FF00FFull;
    v = (v | (v << 4)) & 0x0F0F0F0F0F0F0F0Full;
    v = (v | (v << 2)) & 0x3333333333333333ull;
    v = (v | (v << 1)) & 0x5555555555555555ull;
  }
  return v;
}

// The inverse of spread_bits: bits D*j of v gathered to bit j.
template <int D>
__device__ __forceinline__ int gather_bits(uint64_t v) {
  if constexpr (D == 3) {
    v &= 0x1249249249249249ull;
    v = (v | (v >> 2)) & 0x10C30C30C30C30C3ull;
    v = (v | (v >> 4)) & 0x100F00F00F00F00Full;
    v = (v | (v >> 8)) & 0x001F0000FF0000FFull;
    v = (v | (v >> 16)) & 0x001F00000000FFFFull;
    v = (v | (v >> 32)) & 0x00000000001FFFFFull;
  } else {
    v &= 0x5555555555555555ull;
    v = (v | (v >> 1)) & 0x3333333333333333ull;
    v = (v | (v >> 2)) & 0x0F0F0F0F0F0F0F0Full;
    v = (v | (v >> 4)) & 0x00FF00FF00FF00FFull;
    v = (v | (v >> 8)) & 0x0000FFFF0000FFFFull;
    v = (v | (v >> 16)) & 0x00000000FFFFFFFFull;
  }
  return static_cast<int>(v);
}

// The hex key (_hex_encode_expr, sfc.py:174): the plain Morton interleave of
// the anchor's low L bits, axis k at bit k of each D-bit digit.  An anchor
// outside the root cube gives the key of its low bits, as there.
template <int D>
__device__ __forceinline__ int64_t hex_key(const int (&c)[D]) {
  uint64_t k64 = 0;
#pragma unroll
  for (int k = 0; k < D; ++k) k64 |= spread_bits<D>(static_cast<uint32_t>(c[k])) << k;
  return static_cast<int64_t>(k64);
}

// The key of an element of class EC (the type is not read for a hex).
template <int D, int EC>
__device__ __forceinline__ int64_t element_key(const int (&c)[D], int b, const unsigned char* enc) {
  if constexpr (EC == kHex) return hex_key<D>(c);
  else return encode_key<D>(c, b, enc);
}

// Proposition 23 against the root simplex (type 0, level 0), as
// _inside_expr (sfc.py:139) computes it: the element is the root itself, or
// it lies deeper and its permuted anchor satisfies the root's inequalities,
// with the boundary cases settled by the outside-type masks.
template <int D>
__device__ __forceinline__ bool inside_root_of(const int (&c)[D], int lvl, int b) {
  using T = Dim<D>;
  constexpr int ht = 1 << T::L;
  const unsigned bit = 1u << (b & 7);
  bool at_root = lvl == 0 && b == 0;
#pragma unroll
  for (int k = 0; k < D; ++k) at_root = at_root && c[k] == 0;
  const int ai = c[T::PI], aj = c[T::PJ];
  bool inside;
  if constexpr (D == 2) {
    inside = aj >= 0 && ai < ht && aj <= ai && (aj != ai || !(T::OUT_KJ & bit));
  } else {
    const int ak = c[T::PK];
    inside = aj >= 0 && ai < ht && ak <= ai && aj <= ak;
    const bool eq_ik = ak == ai, eq_kj = aj == ak;
    const bool ok = eq_ik && eq_kj ? !(T::OUT_DIAG & bit)
                    : eq_ik        ? !(T::OUT_IK & bit)
                    : eq_kj        ? !(T::OUT_KJ & bit)
                                   : true;
    inside = inside && ok;
  }
  return at_root || (lvl > 0 && inside);
}

// Box containment in the root cube (_hex_inside_expr, sfc.py:210): every
// coordinate in [0, 2^L - h].  The upper bound is shifted by h, so the
// compare never forms anchor + h, which overflows int32 at level 0.
template <int D>
__device__ __forceinline__ bool inside_root_cube(const int (&c)[D], int lvl) {
  constexpr int L = Dim<D>::L;
  const int lim = (1 << L) - (1 << ((L - lvl) & 31));
  bool inside = lvl >= 0;
#pragma unroll
  for (int k = 0; k < D; ++k) inside = inside && c[k] >= 0 && c[k] <= lim;
  return inside;
}

template <int D, int EC>
__device__ __forceinline__ bool element_inside(const int (&c)[D], int lvl, int b) {
  if constexpr (EC == kHex) return inside_root_cube<D>(c, lvl);
  else return inside_root_of<D>(c, lvl, b);
}

// Algorithm 4.8 coarse -> fine (_decode_body, sfc.py:238): the anchor xyz
// and, returned, the type of the level-`lvl` element with level-padded key
// k64.  Digits finer than the level are masked to 0 and the type chain is
// frozen there, as in the TPU kernel, so keys with garbage below the level
// decode to the same element.  A hex de-interleaves the masked key: its
// digit is the cube id, and its type is 0.
template <int D, int EC>
__device__ __forceinline__ int decode_walk(uint64_t k64, int lvl, const unsigned char* dec,
                                           int (&xyz)[D]) {
  constexpr int L = Dim<D>::L, NC = 1 << D;
  if constexpr (EC == kHex) {
    const int sb = min(max(D * (L - lvl), 0), 63);
    const uint64_t k = k64 & ~((uint64_t{1} << sb) - 1);
#pragma unroll
    for (int a = 0; a < D; ++a) xyz[a] = gather_bits<D>(k >> a);
    return 0;
  } else {
    int b = 0;
#pragma unroll
    for (int k = 0; k < D; ++k) xyz[k] = 0;
#pragma unroll
    for (int lv = 1; lv <= L; ++lv) {
      const bool active = lv <= lvl;
      const int digit = static_cast<int>((k64 >> (D * (L - lv))) & (NC - 1));
      const int p = dec[(b * NC + (active ? digit : 0)) & (kTab - 1)];
      const int cid = p & 7;
      if (active) b = p >> 3;
#pragma unroll
      for (int k = 0; k < D; ++k) xyz[k] |= ((cid >> k) & 1) << (L - lv);
    }
    return b;
  }
}

// The simplex key and decode walks of morton_key and decode, m levels a
// table lookup (m = Walk<D>::M, generated by build.py: 5 at d = 2, 3 at
// d = 3, so L / m = 6 and 7 lookups): the m-level tables (`walk_tables`,
// 16 bits an entry, 4 / 6 KB) compose m steps of the one-level tables, so
// a lookup replaces m dependent table reads and m levels of bit
// extraction.  The type selects a block of 2^(D m) entries:
//   * encode, fine -> coarse: the chunk is the anchor's bits of m levels,
//     axis-major (bits s .. s + m - 1 of coordinate k at bit m k), so the
//     anchor needs no interleave; an entry holds the m local indices as key
//     digits and the type at the chunk's coarse end;
//   * decode, coarse -> fine: the chunk is m digits of the key; an entry
//     holds the m cube ids axis-major, which go straight into the anchor's
//     coordinates, and the type at the chunk's fine end.
template <int D>
struct Walk {
  static constexpr int M = D == 2 ? SFC_WALK_M_2 : SFC_WALK_M_3;
  static constexpr int STEPS = Dim<D>::L / M;
  static constexpr int CHUNK = 1 << (D * M);        // entries a type
  static constexpr int ENTRIES = Dim<D>::NT * CHUNK;
  static constexpr unsigned BITS = (1u << M) - 1;    // one axis's bits of a chunk
  static constexpr unsigned DIGITS = CHUNK - 1;      // the key digits of a chunk
  static_assert(STEPS * M == Dim<D>::L, "the walk must cover every level");
  static_assert(ENTRIES * sizeof(unsigned short) % 16 == 0, "staged as 16-byte vectors");
};

// The global copy of the m-level table that morton_key (kEnc) or decode
// (kDec) stages; the launcher asks the runtime for its address.
template <int D, Table T>
const void* walk_symbol() {
  if constexpr (T == kEnc) return D == 2 ? static_cast<const void*>(sfc_walk_enc_2)
                                         : static_cast<const void*>(sfc_walk_enc_3);
  else return D == 2 ? static_cast<const void*>(sfc_walk_dec_2)
                     : static_cast<const void*>(sfc_walk_dec_3);
}

constexpr int kWalkThreads = 512;   // a block of the walks' persistent grid,
constexpr int kWalkBlocks = 4;      // and the blocks an SM holds (registers fit by launch bounds)

// Copies an m-level table from global memory into shared memory as 16-byte
// vectors; every thread of the block must reach this (it ends in
// __syncthreads).
template <int D>
__device__ __forceinline__ void stage_walk_table(unsigned short* dst,
                                                 const unsigned short* __restrict__ src) {
  constexpr int vecs = Walk<D>::ENTRIES * sizeof(unsigned short) / 16;
  for (int i = threadIdx.x; i < vecs; i += blockDim.x)
    reinterpret_cast<uint4*>(dst)[i] = __ldg(reinterpret_cast<const uint4*>(src) + i);
  __syncthreads();
}

// The key encode_key computes, m levels a lookup.  Only the low L bits of
// each coordinate are read (bits s .. s + m - 1 for s < L).  A type out of
// range is clamped to the last type: a wrong key, never a read out of the
// table.
template <int D>
__device__ __forceinline__ int64_t walk_key(const int (&c)[D], int b, const unsigned short* tab) {
  using W = Walk<D>;
  unsigned t = min(static_cast<unsigned>(b), static_cast<unsigned>(Dim<D>::NT - 1));
  uint64_t k64 = 0;
#pragma unroll
  for (int j = 0; j < W::STEPS; ++j) {
    const int s = W::M * j;
    unsigned q = 0;
#pragma unroll
    for (int k = 0; k < D; ++k) q |= ((static_cast<unsigned>(c[k]) >> s) & W::BITS) << (W::M * k);
    const unsigned e = tab[t * W::CHUNK + q];
    k64 |= static_cast<uint64_t>(e & W::DIGITS) << (D * s);
    t = e >> (D * W::M);
  }
  return static_cast<int64_t>(k64);
}

// The element decode_walk computes for a simplex, m levels a lookup: the
// digits finer than the level are zeroed once (the shift clamped to [0, 63]
// as for a hex), and every level is walked with no level test.  That is the
// TPU kernel's frozen-type rule, because child 0 of every type b is cube 0
// of type b (build.py checks this): a zero digit contributes cube id 0 and
// keeps the type.  Key bits at and above D*L are not read.
template <int D>
__device__ __forceinline__ int walk_decode(uint64_t k64, int lvl, const unsigned short* tab,
                                           int (&xyz)[D]) {
  using W = Walk<D>;
  constexpr int L = Dim<D>::L;
  const int sb = min(max(D * (L - lvl), 0), 63);
  const uint64_t k = k64 & ~((uint64_t{1} << sb) - 1);
  unsigned t = 0, x[D];
#pragma unroll
  for (int a = 0; a < D; ++a) x[a] = 0;
#pragma unroll
  for (int j = W::STEPS - 1; j >= 0; --j) {
    const int s = W::M * j;
    const unsigned e = tab[t * W::CHUNK + (static_cast<unsigned>(k >> (D * s)) & W::DIGITS)];
#pragma unroll
    for (int a = 0; a < D; ++a) x[a] |= ((e >> (W::M * a)) & W::BITS) << s;
    t = e >> (D * W::M);
  }
#pragma unroll
  for (int a = 0; a < D; ++a) xyz[a] = static_cast<int>(x[a]);
  return static_cast<int>(t);
}

// Replaces morton_key_kernel's simplex body (src/repro/kernels/sfc.py:557,
// body _encode_body :224 / _encode_expr :100).  A persistent grid: each
// resident block stages the m-level table once and then walks the elements
// a grid stride apart, one a thread, so that every load and store is
// contiguous across a warp.
template <int D>
__global__ void __launch_bounds__(kWalkThreads, kWalkBlocks)
simplex_key_kernel(const int32_t* __restrict__ anchor, const int32_t* __restrict__ stype,
                   const unsigned short* __restrict__ table, int64_t* __restrict__ key,
                   int64_t n) {
  __shared__ __align__(16) unsigned short tab[Walk<D>::ENTRIES];
  stage_walk_table<D>(tab, table);
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x; i < n;
       i += stride) {
    int c[D];
#pragma unroll
    for (int k = 0; k < D; ++k) c[k] = anchor[i * D + k];
    key[i] = walk_key<D>(c, stype[i], tab);
  }
}

// Replaces morton_key_kernel's hex branch (src/repro/kernels/sfc.py:557,
// body _encode_body :232 / _hex_encode_expr :174): one element a thread.
template <int D>
__global__ void __launch_bounds__(kThreads)
hex_key_kernel(const int32_t* __restrict__ anchor, int64_t* __restrict__ key, int64_t n) {
  const int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
  if (i >= n) return;
  int c[D];
#pragma unroll
  for (int k = 0; k < D; ++k) c[k] = anchor[i * D + k];
  key[i] = hex_key<D>(c);
}

// Replaces decode_kernel's simplex body (src/repro/kernels/sfc.py:573,
// body _decode_body :238): Algorithm 4.8 on the persistent grid of
// simplex_key_kernel.
template <int D>
__global__ void __launch_bounds__(kWalkThreads, kWalkBlocks)
simplex_decode_kernel(const int64_t* __restrict__ key, const int32_t* __restrict__ level,
                      const unsigned short* __restrict__ table, int32_t* __restrict__ anchor,
                      int32_t* __restrict__ stype, int64_t n) {
  __shared__ __align__(16) unsigned short tab[Walk<D>::ENTRIES];
  stage_walk_table<D>(tab, table);
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x; i < n;
       i += stride) {
    int xyz[D];
    stype[i] = walk_decode<D>(static_cast<uint64_t>(key[i]), level[i], tab, xyz);
#pragma unroll
    for (int a = 0; a < D; ++a) anchor[i * D + a] = xyz[a];
  }
}

// Replaces decode_kernel's hex branch (src/repro/kernels/sfc.py:573, body
// _decode_body :264): the masked key de-interleaved, one element a thread.
template <int D>
__global__ void __launch_bounds__(kThreads)
hex_decode_kernel(const int64_t* __restrict__ key, const int32_t* __restrict__ level,
                  int32_t* __restrict__ anchor, int32_t* __restrict__ stype, int64_t n) {
  const int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
  if (i >= n) return;
  int xyz[D];
  decode_walk<D, kHex>(static_cast<uint64_t>(key[i]), level[i], nullptr, xyz);
#pragma unroll
  for (int k = 0; k < D; ++k) anchor[i * D + k] = xyz[k];
  stype[i] = 0;
}

// Replaces parent_kernel (src/repro/kernels/sfc.py:627, body _parent_body
// :398, hex branch :421): Algorithm 4.3 fused with the Table-6 local index; one cube-id feeds
// both lookups through the enc table.  For a hex the cube id is the local
// index and the parent's type is 0.  Level-0 input is in the domain (the
// family scan runs on every element): h = 2^L there, the cube-id of an
// in-root anchor is 0, and the result is the element itself at level -1 —
// exactly what the TPU kernel returns.
template <int D, int EC>
__global__ void __launch_bounds__(kThreads)
parent_kernel(const int32_t* __restrict__ anchor, const int32_t* __restrict__ level,
              const int32_t* __restrict__ stype, int32_t* __restrict__ p_anchor,
              int32_t* __restrict__ p_level, int32_t* __restrict__ p_stype,
              int32_t* __restrict__ iloc, int64_t n) {
  constexpr int L = Dim<D>::L, NC = 1 << D;
  __shared__ unsigned char enc[kTab];
  if constexpr (EC == kSimplex) load_table<D, kEnc>(enc);
  const int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
  if (i >= n) return;
  const int lvl = level[i];
  const int h = 1 << (L - lvl);
  int cid = 0;
#pragma unroll
  for (int k = 0; k < D; ++k) {
    const int c = anchor[i * D + k];
    cid |= ((c & h) != 0) << k;
    p_anchor[i * D + k] = c & ~h;
  }
  p_level[i] = lvl - 1;
  if constexpr (EC == kHex) {
    p_stype[i] = 0;
    iloc[i] = cid;
  } else {
    const int p = enc[(stype[i] * NC + cid) & (kTab - 1)];
    p_stype[i] = p >> 3;
    iloc[i] = p & 7;
  }
}

// Replaces children_kernel (src/repro/kernels/sfc.py:644, body
// _children_body :430, hex branch :450): Algorithm 4.5, all 2^D children in TM order (Morton
// order for a hex, whose j-th child's cube id is j), one thread per
// (element, child); output rows are (n, 2^D[, D]) row-major, so consecutive
// threads store consecutive addresses.  At level L the child offset h/2 is
// 0 (the TPU kernel's h2 == 0), which is reproduced, not guarded: Adapt
// never refines there, but the kernel takes every level.
template <int D, int EC>
__global__ void __launch_bounds__(kThreads)
children_kernel(const int32_t* __restrict__ anchor, const int32_t* __restrict__ level,
                const int32_t* __restrict__ stype, int32_t* __restrict__ c_anchor,
                int32_t* __restrict__ c_level, int32_t* __restrict__ c_stype, int64_t n) {
  constexpr int L = Dim<D>::L, NC = 1 << D;
  __shared__ unsigned char dec[kTab];
  if constexpr (EC == kSimplex) load_table<D, kDec>(dec);
  const int64_t t = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
  if (t >= n * NC) return;
  const int64_t e = t >> D;
  const int j = static_cast<int>(t & (NC - 1));
  const int lvl = level[e];
  const int h2 = (1 << (L - lvl)) >> 1;
  const int p = EC == kHex ? j : dec[(stype[e] * NC + j) & (kTab - 1)];
  const int cid = p & 7;
#pragma unroll
  for (int k = 0; k < D; ++k) c_anchor[t * D + k] = anchor[e * D + k] + h2 * ((cid >> k) & 1);
  c_level[t] = lvl + 1;
  c_stype[t] = p >> 3;
}

// One face of Algorithm 4.6 (_neighbor_expr, sfc.py:124; hex
// _hex_neighbor_expr :195): the same-level neighbor across face f of the
// element with anchor c, cube side h = 2^(L - level) and type b, from the
// packed neighbor table of class EC (entry b * (D+1) + f, or f for a hex,
// whose entries carry type 0 and dual face f ^ 1): its anchor nc, type nb
// and dual face.  A face or type out of range reads a wrong entry of the
// 32-entry shared copy, never out of bounds.
template <int D, int EC>
__device__ __forceinline__ void neighbor_across(const int (&c)[D], int h, int b, int f,
                                                const unsigned short* nei, int (&nc)[D],
                                                int& nb, int& dual) {
  const int p = nei[(EC == kHex ? f : b * (D + 1) + f) & (kNei - 1)];
#pragma unroll
  for (int k = 0; k < D; ++k) nc[k] = c[k] + (((p >> (6 + 2 * k)) & 3) - 1) * h;
  nb = p & 7;
  dual = (p >> 3) & 7;
}

// Replaces face_sweep_kernel (src/repro/kernels/sfc.py:604, body
// _face_sweep_body :300, hex branch :319, with _neighbor_expr, _inside_expr :139 and
// _encode_expr :100; hex _hex_neighbor_expr :195, _hex_inside_expr :210 and
// _hex_encode_expr :174): for all NF faces of each element (D+1 a simplex,
// 2D a hex), the same-level neighbor (Algorithm 4.6: anchor, type, dual
// face), whether it lies inside the root, and its level-padded key.  The
// element is read once; face f's outputs go to plane f of the face-major
// (NF, n) outputs, so every store is contiguous across a warp.  Nothing is
// masked: a neighbor outside the root gets its key and inside = 0 all the
// same.
template <int D, int EC>
__global__ void __launch_bounds__(kThreads)
face_sweep_kernel(const int32_t* __restrict__ anchor, const int32_t* __restrict__ level,
                  const int32_t* __restrict__ stype, int32_t* __restrict__ nb_anchor,
                  int32_t* __restrict__ nb_stype, int32_t* __restrict__ dual,
                  uint8_t* __restrict__ inside, int64_t* __restrict__ key, int64_t n) {
  constexpr int L = Dim<D>::L, NF = EC == kHex ? 2 * D : D + 1;
  __shared__ unsigned char enc[kTab];
  __shared__ unsigned short nei[kNei];
  if constexpr (EC == kSimplex) load_table<D, kEnc>(enc);
  load_neighbor_table<D, EC>(nei);
  const int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
  if (i >= n) return;
  int c[D];
#pragma unroll
  for (int k = 0; k < D; ++k) c[k] = anchor[i * D + k];
  const int lvl = level[i];
  const int b = EC == kHex ? 0 : stype[i];
  const int h = 1 << (L - lvl);
#pragma unroll
  for (int f = 0; f < NF; ++f) {
    int nc[D], nb, du;
    neighbor_across<D, EC>(c, h, b, f, nei, nc, nb, du);
    const int64_t o = f * n + i;
#pragma unroll
    for (int k = 0; k < D; ++k) nb_anchor[o * D + k] = nc[k];
    nb_stype[o] = nb;
    dual[o] = du;
    inside[o] = element_inside<D, EC>(nc, lvl, nb) ? 1 : 0;
    key[o] = element_key<D, EC>(nc, nb, enc);
  }
}

// Replaces face_neighbor_kernel (src/repro/kernels/sfc.py:588, body
// _neighbor_body :279, hex branch :289, with _neighbor_expr :124 or _hex_neighbor_expr :195):
// Algorithm 4.6 across one face per element, face[i] of element i, by the
// per-face step the face sweep runs, so the two cannot drift.
template <int D, int EC>
__global__ void __launch_bounds__(kThreads)
face_neighbor_kernel(const int32_t* __restrict__ anchor, const int32_t* __restrict__ level,
                     const int32_t* __restrict__ stype, const int32_t* __restrict__ face,
                     int32_t* __restrict__ nb_anchor, int32_t* __restrict__ nb_stype,
                     int32_t* __restrict__ dual, int64_t n) {
  constexpr int L = Dim<D>::L;
  __shared__ unsigned short nei[kNei];
  load_neighbor_table<D, EC>(nei);
  const int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
  if (i >= n) return;
  int c[D];
#pragma unroll
  for (int k = 0; k < D; ++k) c[k] = anchor[i * D + k];
  int nc[D], nb, du;
  neighbor_across<D, EC>(c, 1 << (L - level[i]), EC == kHex ? 0 : stype[i], face[i], nei, nc,
                         nb, du);
#pragma unroll
  for (int k = 0; k < D; ++k) nb_anchor[i * D + k] = nc[k];
  nb_stype[i] = nb;
  dual[i] = du;
}
// The owner count of _owner_count_expr (sfc.py:504), which the TPU's
// owner_rank and eval_route kernels share and so do these: the owner rank of
// a lex (tree, key) is the number of the P lex-sorted partition markers
// lex-<= it, less one, clamped to 0 (keys before the first marker go to rank
// 0; an empty rank repeats the next rank's marker and owns nothing; with no
// markers every key goes to rank 0).  One search for every P, in
// O(log P) dependent steps a query:
//   * Each block of a persistent grid copies a table of splitters into
//     shared memory once: every s-th marker, s the least power of two that
//     leaves m = ceil(P / s) <= 2^kTableHeight splitters, so every marker
//     up to P = 16384.
//   * Splitter 0 sits in slot 0; splitters 1..m-1 form a complete binary
//     search tree of height H = ceil(log2 m) in Eytzinger order (node e's
//     children are 2e and 2e + 1; slots past the splitters hold a lex
//     +infinity).  A query compares with slot 0, which every lane reads at
//     once, then takes exactly H steps e = 2e + (node e lex-<= query) from
//     e = 1, with no bounds test and the same in every lane; e - 2^H counts
//     the tree's splitters lex-<= it.  The first levels are a few
//     contiguous slots that the lanes of a warp read together.
//   * Then at most log2 s steps over the window of s markers in global
//     memory that the last such splitter opens, through the read-only cache.
//   * A slot is held as (hi, lo): hi = tree << 32 | the high word of
//     key ^ 2^63, lo its low word, so that the signed order of hi and then
//     the unsigned order of lo is the lex order of (tree, key); a step reads
//     hi, and lo only where the two hi are equal.
//   * A thread takes a few adjacent queries at a time, loaded and stored as
//     vectors (where the caller's pointers are aligned for them), and
//     carries them through each step together, so that their loads
//     overlap.
struct OwnerTable {
  int m;                // splitters
  int height;           // of the search tree of splitters 1..m-1
  int s_log2;           // a splitter every 2^s_log2 markers
  const int32_t* mt;    // the P markers, global
  const int64_t* mk;
  int p;
};

extern __shared__ int64_t owner_smem[];   // 2^height hi words, then 2^height lo words

__device__ __forceinline__ int64_t lex_hi(int t, int64_t k) {
  const uint64_t u = static_cast<uint64_t>(k) ^ 0x8000000000000000ull;
  return static_cast<int64_t>((static_cast<uint64_t>(static_cast<int64_t>(t)) << 32) | (u >> 32));
}

__device__ __forceinline__ uint32_t lex_lo(int64_t k) {
  return static_cast<uint32_t>(static_cast<uint64_t>(k));
}

__device__ __forceinline__ bool marker_le(int tm, int64_t km, int t, int64_t k) {
  return tm < t || (tm == t && km <= k);
}

// Slot e of the table lex-<= the query (qh, ql).
__device__ __forceinline__ bool slot_le(const uint32_t* lo, int e, int64_t qh, uint32_t ql) {
  const int64_t h = owner_smem[e];
  bool le = h < qh;
  if (h == qh) le = lo[e] <= ql;
  return le;
}

// Copies the splitter table into dynamic shared memory; every thread of the
// block must reach this (it ends in __syncthreads).
__device__ __forceinline__ OwnerTable stage_table(const int32_t* __restrict__ mt,
                                                  const int64_t* __restrict__ mk, int p,
                                                  int s_log2) {
  const int m = p > 0 ? static_cast<int>(((static_cast<int64_t>(p) - 1) >> s_log2) + 1) : 0;
  const int height = m > 1 ? 32 - __clz(m - 1) : 0;
  const int slots = 1 << height;
  uint32_t* lo = reinterpret_cast<uint32_t*>(owner_smem + slots);
  // splitter j (a marker read in order, so a warp's reads are contiguous
  // where s = 1) goes to slot 0, or for j >= 1 to the node whose in-order
  // position is j - 1; the slots of j >= m hold +infinity
#pragma unroll 4
  for (int j = threadIdx.x; j < slots; j += blockDim.x) {
    int e = 0;
    if (j > 0) {
      const int tz = __ffs(j) - 1;
      e = (1 << (height - 1 - tz)) | (j >> (tz + 1));
    }
    int64_t h = 0x7FFFFFFFFFFFFFFFll;
    uint32_t l = 0xFFFFFFFFu;
    if (j < m) {
      const int64_t g = static_cast<int64_t>(j) << s_log2;
      const int64_t k = __ldg(mk + g);
      h = lex_hi(__ldg(mt + g), k);
      l = lex_lo(k);
    }
    owner_smem[e] = h;
    lo[e] = l;
  }
  __syncthreads();
  return {m, height, s_log2, mt, mk, p};
}

// The number of markers lex-<= (t[u], k[u]) for each of U queries.
template <int U>
__device__ __forceinline__ void owner_counts(const OwnerTable& tb, const int (&t)[U],
                                             const int64_t (&k)[U], int (&count)[U]) {
  const uint32_t* lo = reinterpret_cast<const uint32_t*>(owner_smem + (1 << tb.height));
  int64_t qh[U];
  uint32_t ql[U];
  int e[U];
  bool past0[U];  // lex-<= splitter 0
#pragma unroll
  for (int u = 0; u < U; ++u) {
    qh[u] = lex_hi(t[u], k[u]);
    ql[u] = lex_lo(k[u]);
    past0[u] = slot_le(lo, 0, qh[u], ql[u]);
    e[u] = 1;
  }
  auto descend = [&]() {
#pragma unroll
    for (int u = 0; u < U; ++u) e[u] = 2 * e[u] + slot_le(lo, e[u], qh[u], ql[u]);
  };
  int level = tb.height;
  for (; level >= 2; level -= 2) {
    descend();
    descend();
  }
  if (level) descend();
  int64_t g[U], end[U];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    // the splitters lex-<= the query (the +infinity slots only if it is
    // +infinity itself), and the window after the last of them
    const int c = past0[u] ? 1 + min(e[u] - (1 << tb.height), tb.m - 1) : 0;
    g[u] = c > 0 ? static_cast<int64_t>(c - 1) << tb.s_log2 : -1;
    end[u] = min(g[u] + (int64_t{1} << tb.s_log2), static_cast<int64_t>(tb.p));
  }
  for (int64_t step = (int64_t{1} << tb.s_log2) >> 1; step > 0; step >>= 1) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int64_t i = g[u] + step;
      if (g[u] >= 0 && i < end[u] && marker_le(__ldg(tb.mt + i), __ldg(tb.mk + i), t[u], k[u]))
        g[u] = i;
    }
  }
#pragma unroll
  for (int u = 0; u < U; ++u) count[u] = static_cast<int>(g[u] + 1);
}

__device__ __forceinline__ int rank_of(int count) { return max(count - 1, 0); }

// Whether p may be read or written as a vector of `bytes` (a caller may pass
// a view with an offset; then the kernel reads and writes one value at a time).
__device__ __forceinline__ bool aligned(const void* p, unsigned bytes) {
  return (reinterpret_cast<uintptr_t>(p) & (bytes - 1)) == 0;
}

// Replaces owner_rank_kernel (src/repro/kernels/sfc.py:696, body
// _owner_rank_body :491 with _owner_count_expr :504): one (tree, key) a
// query, four adjacent queries a thread at a time over a persistent grid.
// The TPU kernel pads the markers to a power of two with sentinels and
// unrolls a compare-and-count over all of them at compile time; here P is
// a launch argument and the search above takes O(log P) steps.
__global__ void __launch_bounds__(kOwnerThreads, 1)
owner_rank_kernel(const int32_t* __restrict__ tree, const int64_t* __restrict__ key,
                  const int32_t* __restrict__ marker_tree,
                  const int64_t* __restrict__ marker_key, int num_markers, int s_log2,
                  int32_t* __restrict__ rank, int64_t n) {
  constexpr int U = 4;
  const OwnerTable tb = stage_table(marker_tree, marker_key, num_markers, s_log2);
  const int64_t stride = U * static_cast<int64_t>(gridDim.x) * blockDim.x;
  const bool vec = aligned(tree, 16) && aligned(key, 16) && aligned(rank, 16);
  for (int64_t i = U * (blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x); i < n;
       i += stride) {
    int t[U], c[U];
    int64_t k[U];
    const bool whole = vec && i + U <= n;
    if (whole) {
      const int4 tv = *reinterpret_cast<const int4*>(tree + i);
      const longlong2 k01 = *reinterpret_cast<const longlong2*>(key + i);
      const longlong2 k23 = *reinterpret_cast<const longlong2*>(key + i + 2);
      t[0] = tv.x, t[1] = tv.y, t[2] = tv.z, t[3] = tv.w;
      k[0] = k01.x, k[1] = k01.y, k[2] = k23.x, k[3] = k23.y;
    } else {
#pragma unroll
      for (int u = 0; u < U; ++u) {
        t[u] = i + u < n ? tree[i + u] : 0;
        k[u] = i + u < n ? key[i + u] : 0;
      }
    }
    owner_counts<U>(tb, t, k, c);
    if (whole) {
      *reinterpret_cast<int4*>(rank + i) =
          make_int4(rank_of(c[0]), rank_of(c[1]), rank_of(c[2]), rank_of(c[3]));
    } else {
#pragma unroll
      for (int u = 0; u < U; ++u)
        if (i + u < n) rank[i + u] = rank_of(c[u]);
    }
  }
}

// Replaces eval_route_kernel (src/repro/kernels/sfc.py:715, body
// _eval_route_body :516 with _owner_count_expr :504): for each (face,
// element) pair of a face-major (nf, n) sweep, the end key of the
// neighbor's interval, key | (2^(D(L - lvl)) - 1) (keys are span aligned),
// and the first and last owner rank of the interval, those of (tree, key)
// and (tree, end key).  The persistent grid walks the nf * n pairs as one
// index space, face-major as the outputs are (d + 1 planes a simplex, 2d a
// hex: the TPU kernel reads nf off its tile), two adjacent pairs a thread
// at a time, carrying the element index (the pair index mod n) along
// without a division.  The end key is >= the key, so its owner count is the
// first one unless marker `first count` is lex-<= it, which one compare
// decides; only then does it search.  The span exponent is clamped to
// [0, 63], so the mask never shifts by 64: at d = 3, level 0 it is
// 2^63 - 1.
template <int D>
__device__ __forceinline__ int64_t interval_end(int64_t k, int lvl) {
  constexpr int L = Dim<D>::L;
  const int sb = min(max(D * (L - lvl), 0), 63);
  return k | static_cast<int64_t>(0x7FFFFFFFFFFFFFFFull >> (63 - sb));
}

template <int D>
__global__ void __launch_bounds__(kOwnerThreads, 1)
eval_route_kernel(const int32_t* __restrict__ tgt, const int64_t* __restrict__ key,
                  const int32_t* __restrict__ level, const int32_t* __restrict__ marker_tree,
                  const int64_t* __restrict__ marker_key, int num_markers, int s_log2,
                  int64_t* __restrict__ kend, int32_t* __restrict__ first,
                  int32_t* __restrict__ last, int64_t n, int nf) {
  constexpr int U = 2;
  const OwnerTable tb = stage_table(marker_tree, marker_key, num_markers, s_log2);
  const int64_t total = n * nf, stride = U * static_cast<int64_t>(gridDim.x) * blockDim.x;
  const int64_t step = stride % n;   // how far the element index moves a stride
  const bool vec = aligned(tgt, 8) && aligned(key, 16) && aligned(kend, 16) &&
                   aligned(first, 8) && aligned(last, 8);
  int64_t o = U * (blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x), i = o % n;
  for (; o < total; o += stride) {
    int t[U], c1[U], c2[U];
    int64_t k[U], ke[U];
    const bool whole = vec && o + U <= total;
    if (whole) {
      const int2 tv = *reinterpret_cast<const int2*>(tgt + o);
      const longlong2 kv = *reinterpret_cast<const longlong2*>(key + o);
      t[0] = tv.x, t[1] = tv.y, k[0] = kv.x, k[1] = kv.y;
    } else {
#pragma unroll
      for (int u = 0; u < U; ++u) {
        t[u] = o + u < total ? tgt[o + u] : 0;
        k[u] = o + u < total ? key[o + u] : 0;
      }
    }
    ke[0] = interval_end<D>(k[0], level[i]);
    ke[1] = interval_end<D>(k[1], o + 1 < total ? level[i + 1 == n ? 0 : i + 1] : 0);
    i += step;
    if (i >= n) i -= n;
    owner_counts<U>(tb, t, k, c1);
    bool far = false;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      c2[u] = c1[u];
      far |= c1[u] < tb.p && marker_le(__ldg(tb.mt + c1[u]), __ldg(tb.mk + c1[u]), t[u], ke[u]);
    }
    if (far) owner_counts<U>(tb, t, ke, c2);
    if (whole) {
      *reinterpret_cast<longlong2*>(kend + o) = make_longlong2(ke[0], ke[1]);
      *reinterpret_cast<int2*>(first + o) = make_int2(rank_of(c1[0]), rank_of(c1[1]));
      *reinterpret_cast<int2*>(last + o) = make_int2(rank_of(c2[0]), rank_of(c2[1]));
    } else {
#pragma unroll
      for (int u = 0; u < U; ++u)
        if (o + u < total) {
          kend[o + u] = ke[u];
          first[o + u] = rank_of(c1[u]);
          last[o + u] = rank_of(c2[u]);
        }
    }
  }
}

// The successor of a simplex inside the root simplex, at a level in 1..L,
// in constant time: its anchor c (no bits finer than the level) and type b
// become the next element's.  Digit i of the key (the local index at level
// i) is 2^D - 1 exactly where the cube id at level i is 2^D - 1, every
// coordinate's bit L - i set, and there the parent type is the child's
// (the tables give parent_type[2^D - 1, b] = b).  So the run of trailing
// levels whose bits all coordinates share, the trailing ones of their AND,
// is the run of digits the +1 carries through, and the type at the carry
// level i = lvl - run is still b.  One enc entry at (b, cube id) gives the
// parent type p and the local index l < 2^D - 1; one dec entry at (p, l + 1)
// gives the new cube id and type at level i; below it the digits become 0,
// child 0, whose cube id is 0 and whose type is its parent's.  A run over
// every level is the level's last element, whose successor is element 0.
// Returns the new type and updates c.
template <int D>
__device__ __forceinline__ int successor_in_root(int (&c)[D], int lvl, int b,
                                                 const unsigned char* enc,
                                                 const unsigned char* dec) {
  constexpr int L = Dim<D>::L, NC = 1 << D;
  unsigned shared_bits = ~0u;
#pragma unroll
  for (int k = 0; k < D; ++k) shared_bits &= static_cast<unsigned>(c[k]);
  // Inside the root every coordinate lies below 2^L, so the shifted AND lies
  // below 2^lvl, its complement has bit lvl set, and run <= lvl.
  const int run = __ffs(static_cast<int>(~(shared_bits >> (L - lvl)))) - 1;
  if (run == lvl) {
#pragma unroll
    for (int k = 0; k < D; ++k) c[k] = 0;
    return 0;
  }
  const int s = L - lvl + run;               // the carry level's bit, L - i
  int cid = 0;
#pragma unroll
  for (int k = 0; k < D; ++k) cid |= ((c[k] >> s) & 1) << k;
  const int up = enc[(b * NC + cid) & (kTab - 1)];                     // l | p << 3
  const int next = dec[((up >> 3) * NC + (up & 7) + 1) & (kTab - 1)];  // cid' | b' << 3
  const unsigned coarser = ~((2u << s) - 1);  // the bits of levels above i
#pragma unroll
  for (int k = 0; k < D; ++k)
    c[k] = static_cast<int>((static_cast<unsigned>(c[k]) & coarser) |
                            (static_cast<unsigned>((next >> k) & 1) << s));
  return next >> 3;
}

// Replaces successor_kernel (src/repro/kernels/sfc.py:739, body
// _successor_body :339, hex branches from :346): Algorithm 4.10 at the
// element's own level, wrapping within the level (the last element's
// successor is element 0).
//
// A simplex first drops the anchor bits finer than its level, as the JAX
// package's `SimplexOps.successor` does (it shifts them out of the key);
// the TPU kernel's encode walk reads them instead, so on such anchors it
// gives another element (ROADMAP, faults of the reference).  Inside the
// root simplex, at a level in 1..L and a type below d!, `successor_in_root`
// reads one enc and one dec entry and walks no levels.  At level 0 every
// element's successor is the root, anchor 0 and type 0, the walk's answer
// too, given here without the walk, which one lane would make its whole
// warp run.  Any other element (outside the root, where the decode from the
// root type does not retrace its type chain; a level or type out of range)
// takes the walk: the level-padded key plus 2^(D(L - lvl)), the span of one
// element of the level, in uint64 and masked to the D*L key bits, then the
// decode at the same level.  The TPU kernel carries +1 through the level's
// digits; the sum carries the same way, and the carry out of the top digit
// is masked off, so the last element of a level wraps to element 0 and a
// level-0 element maps to the root, as there.  At d = 3 a level-0 span is
// 2^63, which the uint64 sum holds and an int64 would not.  A hex always
// takes the walk over its interleaved key, which keeps bits finer than the
// level below the span: the sum never carries out of them and the decode
// masks them off.
template <int D, int EC>
__global__ void __launch_bounds__(kThreads)
successor_kernel(const int32_t* __restrict__ anchor, const int32_t* __restrict__ level,
                 const int32_t* __restrict__ stype, int32_t* __restrict__ o_anchor,
                 int32_t* __restrict__ o_stype, int64_t n) {
  constexpr int L = Dim<D>::L;
  constexpr uint64_t kKeyBits = (uint64_t{1} << (D * L)) - 1;
  __shared__ unsigned char enc[kTab];
  __shared__ unsigned char dec[kTab];
  if constexpr (EC == kSimplex) {
    load_table<D, kEnc>(enc);
    load_table<D, kDec>(dec);
  }
  const int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
  if (i >= n) return;
  int c[D];
#pragma unroll
  for (int k = 0; k < D; ++k) c[k] = anchor[i * D + k];
  const int lvl = level[i];
  int b = EC == kHex ? 0 : stype[i];
  if constexpr (EC == kSimplex) {
    const int fine = (1 << (L - min(max(lvl, 0), L))) - 1;
#pragma unroll
    for (int k = 0; k < D; ++k) c[k] &= ~fine;
    const bool root = lvl == 0;
    if (root || (lvl >= 1 && lvl <= L && b >= 0 && b < Dim<D>::NT &&
                 inside_root_of<D>(c, lvl, b))) {
      if (root) {
#pragma unroll
        for (int k = 0; k < D; ++k) c[k] = 0;
        b = 0;
      } else {
        b = successor_in_root<D>(c, lvl, b, enc, dec);
      }
#pragma unroll
      for (int k = 0; k < D; ++k) o_anchor[i * D + k] = c[k];
      o_stype[i] = b;
      return;
    }
  }
  const uint64_t span = uint64_t{1} << min(max(D * (L - lvl), 0), 63);
  const int64_t key = element_key<D, EC>(c, b, enc);
  const uint64_t next = (static_cast<uint64_t>(key) + span) & kKeyBits;
  int xyz[D];
  b = decode_walk<D, EC>(next, lvl, dec, xyz);
#pragma unroll
  for (int k = 0; k < D; ++k) o_anchor[i * D + k] = xyz[k];
  o_stype[i] = b;
}

// Replaces inside_root_kernel (src/repro/kernels/sfc.py:662, body
// _inside_body :536, hex branch :545): the Proposition-23 test against the root simplex,
// one element a thread, with the level-0 rule of sfc.py:171 (a level-0
// element is inside only if it is the root); for a hex, box containment in
// the root cube.
template <int D, int EC>
__global__ void __launch_bounds__(kThreads)
inside_root_kernel(const int32_t* __restrict__ anchor, const int32_t* __restrict__ level,
                   const int32_t* __restrict__ stype, uint8_t* __restrict__ inside, int64_t n) {
  const int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
  if (i >= n) return;
  int c[D];
#pragma unroll
  for (int k = 0; k < D; ++k) c[k] = anchor[i * D + k];
  inside[i] = element_inside<D, EC>(c, level[i], EC == kHex ? 0 : stype[i]) ? 1 : 0;
}

// Replaces tree_transform_kernel (src/repro/kernels/sfc.py:678, body
// _tree_transform_body :464): the coarse-mesh gluing map, one element a
// thread, each across its own connection.  Per element: anchor'[k] =
// anchor[ax_k] + c[k] on a + row, c[k] - anchor[ax_k] - h on a reflected
// row (h = 2^(L - level)), type' = typemap[type], dual' = facemap[type][dual]
// and the neighbor tree.  A hex keeps type 0 and reads its 2D-entry face map
// from the row's first face-map slots (pack_connection).  The TPU kernel
// bakes one connection's M, c and typemap into each compiled program and
// looks the type up by a masked sum (_lut); one launch over every crossing
// of a many-tree mesh needs the connection as data instead, so each thread
// reads its row (packed by repro_torch/core/cmesh.py:pack_connection,
// W = 2D + D! + D!(D+1) + 1 int32) from the table in global memory through
// the read-only cache: the number of connections is unbounded, so the table
// does not go to shared memory.  The arithmetic is done in uint32 and cast
// back, which is the int32 ring arithmetic of the reference without signed
// overflow: at d = 2 periodic translations reach 2^31.  Connection, type and
// dual indices are clamped to their tables (the dual to the class's faces),
// so a malformed input reads a wrong row or entry, never out of bounds.
template <int D, int EC>
__global__ void __launch_bounds__(kThreads)
tree_transform_kernel(const int32_t* __restrict__ conn, const int32_t* __restrict__ anchor,
                      const int32_t* __restrict__ level, const int32_t* __restrict__ stype,
                      const int32_t* __restrict__ dual, const int32_t* __restrict__ table,
                      int num_conn, int32_t* __restrict__ o_anchor,
                      int32_t* __restrict__ o_stype, int32_t* __restrict__ o_dual,
                      int32_t* __restrict__ o_tree, int64_t n) {
  constexpr int L = Dim<D>::L, NT = Dim<D>::NT, NF = EC == kHex ? 2 * D : D + 1;
  constexpr int W = 2 * D + NT + NT * (D + 1) + 1;
  const int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
  if (i >= n) return;
  const int64_t row = static_cast<int64_t>(min(max(conn[i], 0), num_conn - 1)) * W;
  const int32_t* __restrict__ r = table + row;
  int a[D];
#pragma unroll
  for (int k = 0; k < D; ++k) a[k] = anchor[i * D + k];
  const uint32_t h = 1u << ((L - level[i]) & 31);
#pragma unroll
  for (int k = 0; k < D; ++k) {
    const int code = __ldg(r + k);
    const int ax = code & 3;
    uint32_t src = static_cast<uint32_t>(a[0]);
#pragma unroll
    for (int j = 1; j < D; ++j) src = ax == j ? static_cast<uint32_t>(a[j]) : src;
    const uint32_t c = static_cast<uint32_t>(__ldg(r + D + k));
    const uint32_t v = (code & 4) ? c - src - h : src + c;
    o_anchor[i * D + k] = static_cast<int32_t>(v);
  }
  const int f = min(max(dual[i], 0), NF - 1);
  if constexpr (EC == kHex) {
    o_stype[i] = 0;
    o_dual[i] = __ldg(r + 2 * D + NT + f);
  } else {
    const int b = min(max(stype[i], 0), NT - 1);
    o_stype[i] = __ldg(r + 2 * D + b);
    o_dual[i] = __ldg(r + 2 * D + NT + b * NF + f);
  }
  o_tree[i] = __ldg(r + W - 1);
}

inline unsigned blocks_for(int64_t work) {
  return static_cast<unsigned>((work + kThreads - 1) / kThreads);
}

// The launch of owner_rank or eval_route against P markers over `work`
// queries: the splitter stride exponent (the least that leaves at most
// 2^kTableHeight splitters), the splitter table's shared memory, and the
// persistent grid, as many blocks as the card holds at once with that
// table, and no more than the work needs.  What the runtime is asked for
// this is asked once a device and kernel and kept: the opt-in to the
// largest table (past 48 KB a kernel must ask), the SM count, and the
// blocks an SM holds at each table height; so a launch on a small input
// makes one runtime call (the current device) before the kernel's.
// Returns cudaSuccess or the first error.
struct OwnerLaunch {
  int s_log2 = 0;
  size_t smem = 0;
  unsigned grid = 0;
};

enum OwnerKernel { kOwnerRank, kEvalRoute2, kEvalRoute3, kOwnerKernels };
constexpr int kMaxDevices = 64;
constexpr int kOwnerMaxSmem = (1 << kTableHeight) * (sizeof(int64_t) + sizeof(uint32_t));

struct OwnerShape {                               // zero until asked
  std::atomic<int> sms;                           // set after the opt-in
  std::atomic<int> per_sm[kTableHeight + 1];      // blocks an SM holds, by table height
};
OwnerShape owner_shapes[kOwnerKernels][kMaxDevices];

template <typename Kernel>
cudaError_t owner_launch(Kernel* kernel, OwnerKernel which, int p, int64_t work,
                         OwnerLaunch* out) {
  int m = p;
  while (m > (1 << kTableHeight)) {
    ++out->s_log2;
    m = static_cast<int>(((static_cast<int64_t>(p) - 1) >> out->s_log2) + 1);
  }
  int height = 0;
  while ((1 << height) < m) ++height;   // 2^height - 1 >= m - 1 tree nodes
  out->smem = (size_t{1} << height) * (sizeof(int64_t) + sizeof(uint32_t));
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  OwnerShape& shape = owner_shapes[which][dev];
  int sms = shape.sms.load(std::memory_order_acquire);
  if (sms == 0) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kOwnerMaxSmem);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return e;
    shape.sms.store(sms, std::memory_order_release);
  }
  int per_sm = shape.per_sm[height].load(std::memory_order_relaxed);
  if (per_sm == 0) {
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kOwnerThreads, out->smem);
    if (e != cudaSuccess) return e;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    shape.per_sm[height].store(per_sm, std::memory_order_relaxed);
  }
  const int64_t need = (work + kOwnerThreads - 1) / kOwnerThreads;
  out->grid = static_cast<unsigned>(std::min<int64_t>(need, static_cast<int64_t>(per_sm) * sms));
  return cudaSuccess;
}

// The persistent grid of a simplex key or decode walk over n elements:
// kWalkBlocks blocks an SM (their launch bounds make them fit), and no more
// than the work needs; and the global address of the m-level table the
// blocks stage.  What the runtime is asked for this is asked once a device
// and table and kept (the table's address, the SM count), so a launch makes
// one runtime call (the current device) before the kernel's.  Returns
// cudaSuccess or the first error.
struct WalkLaunch {
  unsigned grid = 0;
  const unsigned short* table = nullptr;
};

enum WalkKernel { kWalkKey2, kWalkKey3, kWalkDecode2, kWalkDecode3, kWalkKernels };

struct WalkShape {                                // zero until asked
  std::atomic<const unsigned short*> table;
  std::atomic<unsigned> resident;                 // blocks the card holds; set last
};
WalkShape walk_shapes[kWalkKernels][kMaxDevices];

cudaError_t walk_launch(WalkKernel which, const void* symbol, int64_t n, WalkLaunch* out) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  WalkShape& shape = walk_shapes[which][dev];
  unsigned resident = shape.resident.load(std::memory_order_acquire);
  if (resident == 0) {
    void* table = nullptr;
    int sms = 0;
    e = cudaGetSymbolAddress(&table, symbol);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return e;
    if (reinterpret_cast<uintptr_t>(table) & 15) return cudaErrorMisalignedAddress;
    shape.table.store(static_cast<const unsigned short*>(table), std::memory_order_relaxed);
    resident = static_cast<unsigned>(kWalkBlocks * sms);
    shape.resident.store(resident, std::memory_order_release);
  }
  out->grid = static_cast<unsigned>(std::min<int64_t>((n + kWalkThreads - 1) / kWalkThreads,
                                                      resident));
  out->table = shape.table.load(std::memory_order_relaxed);
  return cudaSuccess;
}

// Calls Launch<d, eclass>::run(args...) for the four instantiated pairs and
// returns the launcher's error or, after the launch, cudaGetLastError(); an
// unknown pair launches nothing and returns cudaErrorInvalidValue.
template <template <int, int> class Launch, typename... Args>
int launch_for(int d, int eclass, Args... args) {
  cudaError_t e;
  if (d == 2 && eclass == kSimplex) e = Launch<2, kSimplex>::run(args...);
  else if (d == 3 && eclass == kSimplex) e = Launch<3, kSimplex>::run(args...);
  else if (d == 2 && eclass == kHex) e = Launch<2, kHex>::run(args...);
  else if (d == 3 && eclass == kHex) e = Launch<3, kHex>::run(args...);
  else return cudaErrorInvalidValue;
  return e != cudaSuccess ? e : cudaGetLastError();
}

// One launcher per kernel with a body per class, for `launch_for`; each
// returns an error it met before the launch, else cudaSuccess.
template <int D, int EC> struct MortonKey {
  static cudaError_t run(cudaStream_t s, const int32_t* a, const int32_t* b, int64_t* k,
                         int64_t n) {
    if constexpr (EC == kHex) {
      hex_key_kernel<D><<<blocks_for(n), kThreads, 0, s>>>(a, k, n);
    } else {
      WalkLaunch g;
      const cudaError_t e =
          walk_launch(D == 2 ? kWalkKey2 : kWalkKey3, walk_symbol<D, kEnc>(), n, &g);
      if (e != cudaSuccess) return e;
      simplex_key_kernel<D><<<g.grid, kWalkThreads, 0, s>>>(a, b, g.table, k, n);
    }
    return cudaSuccess;
  }
};
template <int D, int EC> struct Decode {
  static cudaError_t run(cudaStream_t s, const int64_t* k, const int32_t* l, int32_t* a,
                         int32_t* b, int64_t n) {
    if constexpr (EC == kHex) {
      hex_decode_kernel<D><<<blocks_for(n), kThreads, 0, s>>>(k, l, a, b, n);
    } else {
      WalkLaunch g;
      const cudaError_t e =
          walk_launch(D == 2 ? kWalkDecode2 : kWalkDecode3, walk_symbol<D, kDec>(), n, &g);
      if (e != cudaSuccess) return e;
      simplex_decode_kernel<D><<<g.grid, kWalkThreads, 0, s>>>(k, l, g.table, a, b, n);
    }
    return cudaSuccess;
  }
};
template <int D, int EC> struct Parent {
  static cudaError_t run(cudaStream_t s, const int32_t* a, const int32_t* l, const int32_t* b,
                         int32_t* pa, int32_t* pl, int32_t* pb, int32_t* pi, int64_t n) {
    parent_kernel<D, EC><<<blocks_for(n), kThreads, 0, s>>>(a, l, b, pa, pl, pb, pi, n);
    return cudaSuccess;
  }
};
template <int D, int EC> struct Children {
  static cudaError_t run(cudaStream_t s, const int32_t* a, const int32_t* l, const int32_t* b,
                         int32_t* ca, int32_t* cl, int32_t* cb, int64_t n) {
    children_kernel<D, EC><<<blocks_for(n << D), kThreads, 0, s>>>(a, l, b, ca, cl, cb, n);
    return cudaSuccess;
  }
};
template <int D, int EC> struct FaceSweep {
  static cudaError_t run(cudaStream_t s, const int32_t* a, const int32_t* l, const int32_t* b,
                         int32_t* na, int32_t* nb, int32_t* du, uint8_t* in, int64_t* k,
                         int64_t n) {
    face_sweep_kernel<D, EC><<<blocks_for(n), kThreads, 0, s>>>(a, l, b, na, nb, du, in, k, n);
    return cudaSuccess;
  }
};
template <int D, int EC> struct Successor {
  static cudaError_t run(cudaStream_t s, const int32_t* a, const int32_t* l, const int32_t* b,
                         int32_t* oa, int32_t* ob, int64_t n) {
    successor_kernel<D, EC><<<blocks_for(n), kThreads, 0, s>>>(a, l, b, oa, ob, n);
    return cudaSuccess;
  }
};
template <int D, int EC> struct FaceNeighbor {
  static cudaError_t run(cudaStream_t s, const int32_t* a, const int32_t* l, const int32_t* b,
                         const int32_t* f, int32_t* na, int32_t* nb, int32_t* du, int64_t n) {
    face_neighbor_kernel<D, EC><<<blocks_for(n), kThreads, 0, s>>>(a, l, b, f, na, nb, du, n);
    return cudaSuccess;
  }
};
template <int D, int EC> struct InsideRoot {
  static cudaError_t run(cudaStream_t s, const int32_t* a, const int32_t* l, const int32_t* b,
                         uint8_t* in, int64_t n) {
    inside_root_kernel<D, EC><<<blocks_for(n), kThreads, 0, s>>>(a, l, b, in, n);
    return cudaSuccess;
  }
};
template <int D, int EC> struct TreeTransform {
  static cudaError_t run(cudaStream_t s, const int32_t* cn, const int32_t* a, const int32_t* l,
                         const int32_t* b, const int32_t* du, const int32_t* tb, int num_conn,
                         int32_t* oa, int32_t* ob, int32_t* od, int32_t* ot, int64_t n) {
    tree_transform_kernel<D, EC><<<blocks_for(n), kThreads, 0, s>>>(cn, a, l, b, du, tb,
                                                                     num_conn, oa, ob, od, ot, n);
    return cudaSuccess;
  }
};

}  // namespace

extern "C" {

int sfc_morton_key(int d, int eclass, const void* anchor, const void* stype, void* key,
                   int64_t n, void* stream) {
  if (n <= 0) return cudaSuccess;
  auto s = static_cast<cudaStream_t>(stream);
  auto a = static_cast<const int32_t*>(anchor);
  auto b = static_cast<const int32_t*>(stype);
  auto k = static_cast<int64_t*>(key);
  return launch_for<MortonKey>(d, eclass, s, a, b, k, n);
}

int sfc_decode(int d, int eclass, const void* key, const void* level, void* anchor,
               void* stype, int64_t n, void* stream) {
  if (n <= 0) return cudaSuccess;
  auto s = static_cast<cudaStream_t>(stream);
  auto k = static_cast<const int64_t*>(key);
  auto l = static_cast<const int32_t*>(level);
  auto a = static_cast<int32_t*>(anchor);
  auto b = static_cast<int32_t*>(stype);
  return launch_for<Decode>(d, eclass, s, k, l, a, b, n);
}

int sfc_parent(int d, int eclass, const void* anchor, const void* level, const void* stype,
               void* p_anchor, void* p_level, void* p_stype, void* iloc, int64_t n,
               void* stream) {
  if (n <= 0) return cudaSuccess;
  auto s = static_cast<cudaStream_t>(stream);
  auto a = static_cast<const int32_t*>(anchor);
  auto l = static_cast<const int32_t*>(level);
  auto b = static_cast<const int32_t*>(stype);
  auto pa = static_cast<int32_t*>(p_anchor);
  auto pl = static_cast<int32_t*>(p_level);
  auto pb = static_cast<int32_t*>(p_stype);
  auto pi = static_cast<int32_t*>(iloc);
  return launch_for<Parent>(d, eclass, s, a, l, b, pa, pl, pb, pi, n);
}

int sfc_children(int d, int eclass, const void* anchor, const void* level, const void* stype,
                 void* c_anchor, void* c_level, void* c_stype, int64_t n, void* stream) {
  if (n <= 0) return cudaSuccess;
  auto s = static_cast<cudaStream_t>(stream);
  auto a = static_cast<const int32_t*>(anchor);
  auto l = static_cast<const int32_t*>(level);
  auto b = static_cast<const int32_t*>(stype);
  auto ca = static_cast<int32_t*>(c_anchor);
  auto cl = static_cast<int32_t*>(c_level);
  auto cb = static_cast<int32_t*>(c_stype);
  return launch_for<Children>(d, eclass, s, a, l, b, ca, cl, cb, n);
}

int sfc_face_sweep(int d, int eclass, const void* anchor, const void* level, const void* stype,
                   void* nb_anchor, void* nb_stype, void* dual, void* inside, void* key,
                   int64_t n, void* stream) {
  if (n <= 0) return cudaSuccess;
  auto s = static_cast<cudaStream_t>(stream);
  auto a = static_cast<const int32_t*>(anchor);
  auto l = static_cast<const int32_t*>(level);
  auto b = static_cast<const int32_t*>(stype);
  auto na = static_cast<int32_t*>(nb_anchor);
  auto nb = static_cast<int32_t*>(nb_stype);
  auto du = static_cast<int32_t*>(dual);
  auto in = static_cast<uint8_t*>(inside);
  auto k = static_cast<int64_t*>(key);
  return launch_for<FaceSweep>(d, eclass, s, a, l, b, na, nb, du, in, k, n);
}

int sfc_eval_route(int d, int nf, const void* tgt, const void* key, const void* level,
                   const void* marker_tree, const void* marker_key, int num_markers,
                   void* kend, void* first, void* last, int64_t n, void* stream) {
  if (n <= 0) return cudaSuccess;
  if (num_markers < 0 || (d != 2 && d != 3) || (nf != d + 1 && nf != 2 * d))
    return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  auto t = static_cast<const int32_t*>(tgt);
  auto k = static_cast<const int64_t*>(key);
  auto l = static_cast<const int32_t*>(level);
  auto mt = static_cast<const int32_t*>(marker_tree);
  auto mk = static_cast<const int64_t*>(marker_key);
  auto ke = static_cast<int64_t*>(kend);
  auto f = static_cast<int32_t*>(first);
  auto la = static_cast<int32_t*>(last);
  auto kernel = d == 2 ? eval_route_kernel<2> : eval_route_kernel<3>;
  OwnerLaunch g;
  const cudaError_t e =
      owner_launch(kernel, d == 2 ? kEvalRoute2 : kEvalRoute3, num_markers, n * nf, &g);
  if (e != cudaSuccess) return e;
  kernel<<<g.grid, kOwnerThreads, g.smem, s>>>(t, k, l, mt, mk, num_markers, g.s_log2, ke, f, la,
                                                n, nf);
  return cudaGetLastError();
}

int sfc_owner_rank(const void* tree, const void* key, const void* marker_tree,
                   const void* marker_key, int num_markers, void* rank, int64_t n,
                   void* stream) {
  if (n <= 0) return cudaSuccess;
  if (num_markers < 0) return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  auto t = static_cast<const int32_t*>(tree);
  auto k = static_cast<const int64_t*>(key);
  auto mt = static_cast<const int32_t*>(marker_tree);
  auto mk = static_cast<const int64_t*>(marker_key);
  auto r = static_cast<int32_t*>(rank);
  OwnerLaunch g;
  const cudaError_t e = owner_launch(owner_rank_kernel, kOwnerRank, num_markers, n, &g);
  if (e != cudaSuccess) return e;
  owner_rank_kernel<<<g.grid, kOwnerThreads, g.smem, s>>>(t, k, mt, mk, num_markers, g.s_log2,
                                                          r, n);
  return cudaGetLastError();
}

int sfc_successor(int d, int eclass, const void* anchor, const void* level, const void* stype,
                  void* o_anchor, void* o_stype, int64_t n, void* stream) {
  if (n <= 0) return cudaSuccess;
  auto s = static_cast<cudaStream_t>(stream);
  auto a = static_cast<const int32_t*>(anchor);
  auto l = static_cast<const int32_t*>(level);
  auto b = static_cast<const int32_t*>(stype);
  auto oa = static_cast<int32_t*>(o_anchor);
  auto ob = static_cast<int32_t*>(o_stype);
  return launch_for<Successor>(d, eclass, s, a, l, b, oa, ob, n);
}

int sfc_face_neighbor(int d, int eclass, const void* anchor, const void* level,
                      const void* stype, const void* face, void* nb_anchor, void* nb_stype,
                      void* dual, int64_t n, void* stream) {
  if (n <= 0) return cudaSuccess;
  auto s = static_cast<cudaStream_t>(stream);
  auto a = static_cast<const int32_t*>(anchor);
  auto l = static_cast<const int32_t*>(level);
  auto b = static_cast<const int32_t*>(stype);
  auto f = static_cast<const int32_t*>(face);
  auto na = static_cast<int32_t*>(nb_anchor);
  auto nb = static_cast<int32_t*>(nb_stype);
  auto du = static_cast<int32_t*>(dual);
  return launch_for<FaceNeighbor>(d, eclass, s, a, l, b, f, na, nb, du, n);
}

int sfc_inside_root(int d, int eclass, const void* anchor, const void* level, const void* stype,
                    void* inside, int64_t n, void* stream) {
  if (n <= 0) return cudaSuccess;
  auto s = static_cast<cudaStream_t>(stream);
  auto a = static_cast<const int32_t*>(anchor);
  auto l = static_cast<const int32_t*>(level);
  auto b = static_cast<const int32_t*>(stype);
  auto in = static_cast<uint8_t*>(inside);
  return launch_for<InsideRoot>(d, eclass, s, a, l, b, in, n);
}

int sfc_tree_transform(int d, int eclass, const void* conn, const void* anchor,
                       const void* level, const void* stype, const void* dual,
                       const void* table, int num_conn, void* o_anchor, void* o_stype,
                       void* o_dual, void* o_tree, int64_t n, void* stream) {
  if (n <= 0) return cudaSuccess;
  if (num_conn < 1) return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  auto cn = static_cast<const int32_t*>(conn);
  auto a = static_cast<const int32_t*>(anchor);
  auto l = static_cast<const int32_t*>(level);
  auto b = static_cast<const int32_t*>(stype);
  auto du = static_cast<const int32_t*>(dual);
  auto tb = static_cast<const int32_t*>(table);
  auto oa = static_cast<int32_t*>(o_anchor);
  auto ob = static_cast<int32_t*>(o_stype);
  auto od = static_cast<int32_t*>(o_dual);
  auto ot = static_cast<int32_t*>(o_tree);
  return launch_for<TreeTransform>(d, eclass, s, cn, a, l, b, du, tb, num_conn, oa, ob, od, ot,
                                   n);
}

}  // extern "C"
