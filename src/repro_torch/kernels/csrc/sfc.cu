// Hand-written Hopper (sm_90a) kernels for the simplex SFC element ops of
// the forest pipeline.  New -> Adapt -> Partition: encode (morton key),
// decode, parent (+ local index) and children.  Balance -> Ghost -> validate:
// the fused face sweep, the routing eval, and the inside-root test.  One
// thread per element (per element and child for `children`, per element and
// face for `eval_route`), templated on the dimension D.
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
//   * The face-neighbor table (16 bits an entry) is copied to shared memory
//     the same way.  The root simplex's Proposition-23 constants (its axis
//     permutation, and the type sets outside each boundary) are generated
//     as compile-time constants and bit masks over the types, so the
//     inside-root test reads no table at all.
//   * Keys are one 64-bit integer per element; the (hi, lo) uint32 word
//     straddling of the TPU kernels disappears.
//   * The level loops are unrolled at compile time (MAXLEVEL is a constant).
//
// Bound: the bytes each kernel must move at one H100 SXM's 3.35 TB/s
// device memory, counting each input byte read once and each output byte
// written once.  Per element, d = 3 / d = 2:
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
// These integer table walks do no floating-point work, and no published
// integer peak fits them, so the bound has no operations term.
// What the design does about it: encode and decode keep the whole level
// chain in registers and read the tables from shared memory, so the only
// memory traffic is the element itself; parent and children are single
// passes whose stores are contiguous across the threads of a warp.  The
// face sweep reads each element once and writes every face's outputs
// face-major ((d+1, n) planes), so each store is contiguous across a warp;
// eval_route reads the P partition markers into shared memory once per
// block and scans them from there.
//
// Every entry point launches on the caller's stream, does not synchronise,
// allocates nothing, and returns cudaGetLastError() after the launch.

#include <cstdint>
#include <cuda_runtime.h>

#include "sfc_tables.h"

namespace {

constexpr int kThreads = 256;
constexpr int kTab = 64;  // shared copy of a packed table; index mask kTab - 1
constexpr int kNei = 32;  // shared copy of the face-neighbor table; mask kNei - 1
constexpr int kMaxMarkers = 4096;  // eval_route's markers in shared memory: 48 KB

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

// Copies the packed face-neighbor table into shared memory, zero-padded to
// kNei entries.  Every thread of the block must reach this.
template <int D>
__device__ __forceinline__ void load_neighbor_table(unsigned short* dst) {
  constexpr int n = Dim<D>::NT * (D + 1);
  for (int i = threadIdx.x; i < kNei; i += blockDim.x) {
    if constexpr (D == 2) dst[i] = i < n ? sfc_nei_2[i] : 0;
    else dst[i] = i < n ? sfc_nei_3[i] : 0;
  }
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

// Replaces morton_key_kernel (src/repro/kernels/sfc.py:557, body
// _encode_body :224 / _encode_expr :100).
template <int D>
__global__ void __launch_bounds__(kThreads)
morton_key_kernel(const int32_t* __restrict__ anchor, const int32_t* __restrict__ stype,
                  int64_t* __restrict__ key, int64_t n) {
  __shared__ unsigned char enc[kTab];
  load_table<D, kEnc>(enc);
  const int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
  if (i >= n) return;
  int c[D];
#pragma unroll
  for (int k = 0; k < D; ++k) c[k] = anchor[i * D + k];
  key[i] = encode_key<D>(c, stype[i], enc);
}

// Replaces decode_kernel (src/repro/kernels/sfc.py:573, body _decode_body
// :238): Algorithm 4.8 coarse -> fine.  Digits finer than the element's
// level are masked to 0 and the type chain is frozen there, as in the TPU
// kernel, so keys with garbage below the level decode to the same element.
template <int D>
__global__ void __launch_bounds__(kThreads)
decode_kernel(const int64_t* __restrict__ key, const int32_t* __restrict__ level,
              int32_t* __restrict__ anchor, int32_t* __restrict__ stype, int64_t n) {
  constexpr int L = Dim<D>::L, NC = 1 << D;
  __shared__ unsigned char dec[kTab];
  load_table<D, kDec>(dec);
  const int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
  if (i >= n) return;
  const uint64_t k64 = static_cast<uint64_t>(key[i]);
  const int lvl = level[i];
  int b = 0;
  int xyz[D];
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
#pragma unroll
  for (int k = 0; k < D; ++k) anchor[i * D + k] = xyz[k];
  stype[i] = b;
}

// Replaces parent_kernel (src/repro/kernels/sfc.py:627, body _parent_body
// :398): Algorithm 4.3 fused with the Table-6 local index; one cube-id feeds
// both lookups through the enc table.  Level-0 input is in the domain (the
// family scan runs on every element): h = 2^L there, the cube-id of an
// in-root anchor is 0, and the result is the element itself at level -1 —
// exactly what the TPU kernel returns.
template <int D>
__global__ void __launch_bounds__(kThreads)
parent_kernel(const int32_t* __restrict__ anchor, const int32_t* __restrict__ level,
              const int32_t* __restrict__ stype, int32_t* __restrict__ p_anchor,
              int32_t* __restrict__ p_level, int32_t* __restrict__ p_stype,
              int32_t* __restrict__ iloc, int64_t n) {
  constexpr int L = Dim<D>::L, NC = 1 << D;
  __shared__ unsigned char enc[kTab];
  load_table<D, kEnc>(enc);
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
  const int p = enc[(stype[i] * NC + cid) & (kTab - 1)];
  p_level[i] = lvl - 1;
  p_stype[i] = p >> 3;
  iloc[i] = p & 7;
}

// Replaces children_kernel (src/repro/kernels/sfc.py:644, body
// _children_body :430): Algorithm 4.5, all 2^D children in TM order, one
// thread per (element, child); output rows are (n, 2^D[, D]) row-major, so
// consecutive threads store consecutive addresses.  At level L the child
// offset h/2 is 0 (the TPU kernel's h2 == 0), which is reproduced, not
// guarded: Adapt never refines there, but the kernel takes every level.
template <int D>
__global__ void __launch_bounds__(kThreads)
children_kernel(const int32_t* __restrict__ anchor, const int32_t* __restrict__ level,
                const int32_t* __restrict__ stype, int32_t* __restrict__ c_anchor,
                int32_t* __restrict__ c_level, int32_t* __restrict__ c_stype, int64_t n) {
  constexpr int L = Dim<D>::L, NC = 1 << D;
  __shared__ unsigned char dec[kTab];
  load_table<D, kDec>(dec);
  const int64_t t = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
  if (t >= n * NC) return;
  const int64_t e = t >> D;
  const int j = static_cast<int>(t & (NC - 1));
  const int lvl = level[e];
  const int h2 = (1 << (L - lvl)) >> 1;
  const int p = dec[(stype[e] * NC + j) & (kTab - 1)];
  const int cid = p & 7;
#pragma unroll
  for (int k = 0; k < D; ++k) c_anchor[t * D + k] = anchor[e * D + k] + h2 * ((cid >> k) & 1);
  c_level[t] = lvl + 1;
  c_stype[t] = p >> 3;
}

// Replaces face_sweep_kernel (src/repro/kernels/sfc.py:604, body
// _face_sweep_body :300 with _neighbor_expr, _inside_expr :139 and
// _encode_expr :100): for all D+1 faces of each element, the same-level
// neighbor (Algorithm 4.6: anchor, type, dual face), whether it lies inside
// the root simplex, and its level-padded key.  The element is read once;
// face f's outputs go to plane f of the face-major (D+1, n) outputs, so
// every store is contiguous across a warp.  Nothing is masked: a neighbor
// outside the root gets its key and inside = 0 all the same.
template <int D>
__global__ void __launch_bounds__(kThreads)
face_sweep_kernel(const int32_t* __restrict__ anchor, const int32_t* __restrict__ level,
                  const int32_t* __restrict__ stype, int32_t* __restrict__ nb_anchor,
                  int32_t* __restrict__ nb_stype, int32_t* __restrict__ dual,
                  uint8_t* __restrict__ inside, int64_t* __restrict__ key, int64_t n) {
  constexpr int L = Dim<D>::L, NF = D + 1;
  __shared__ unsigned char enc[kTab];
  __shared__ unsigned short nei[kNei];
  load_table<D, kEnc>(enc);
  load_neighbor_table<D>(nei);
  const int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
  if (i >= n) return;
  int c[D];
#pragma unroll
  for (int k = 0; k < D; ++k) c[k] = anchor[i * D + k];
  const int lvl = level[i];
  const int b = stype[i];
  const int h = 1 << (L - lvl);
#pragma unroll
  for (int f = 0; f < NF; ++f) {
    const int p = nei[(b * NF + f) & (kNei - 1)];
    int nc[D];
#pragma unroll
    for (int k = 0; k < D; ++k) nc[k] = c[k] + (((p >> (6 + 2 * k)) & 3) - 1) * h;
    const int nb = p & 7;
    const int64_t o = f * n + i;
#pragma unroll
    for (int k = 0; k < D; ++k) nb_anchor[o * D + k] = nc[k];
    nb_stype[o] = nb;
    dual[o] = (p >> 3) & 7;
    inside[o] = inside_root_of<D>(nc, lvl, nb) ? 1 : 0;
    key[o] = encode_key<D>(nc, nb, enc);
  }
}

// Replaces eval_route_kernel (src/repro/kernels/sfc.py:715, body
// _eval_route_body :516 with _owner_count_expr :504): for each (face,
// element) pair of a face-major (nf, n) sweep, the end key of the
// neighbor's interval, key | (2^(D(L - lvl)) - 1) (keys are span aligned),
// and the first and last owner rank of the interval: the number of the P
// partition markers lex-<= (tree, key) resp. (tree, end key), less one,
// clamped to 0.  Grid: x over elements, y over faces.  The markers are
// copied into shared memory once per block and scanned there (a binary
// search pays only for large P).  The span exponent is clamped to [0, 63],
// so the mask never shifts by 64: at d = 3, level 0 it is 2^63 - 1.
template <int D>
__global__ void __launch_bounds__(kThreads)
eval_route_kernel(const int32_t* __restrict__ tgt, const int64_t* __restrict__ key,
                  const int32_t* __restrict__ level, const int32_t* __restrict__ marker_tree,
                  const int64_t* __restrict__ marker_key, int num_markers,
                  int64_t* __restrict__ kend, int32_t* __restrict__ first,
                  int32_t* __restrict__ last, int64_t n) {
  constexpr int L = Dim<D>::L;
  extern __shared__ int64_t route_smem[];
  int64_t* mk = route_smem;
  int32_t* mt = reinterpret_cast<int32_t*>(route_smem + num_markers);
  for (int m = threadIdx.x; m < num_markers; m += blockDim.x) {
    mk[m] = marker_key[m];
    mt[m] = marker_tree[m];
  }
  __syncthreads();
  const int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
  if (i >= n) return;
  const int64_t o = blockIdx.y * n + i;
  const int t = tgt[o];
  const int64_t k = key[o];
  const int sb = min(max(D * (L - level[i]), 0), 63);
  const int64_t ke = k | static_cast<int64_t>(0x7FFFFFFFFFFFFFFFull >> (63 - sb));
  int c0 = 0, c1 = 0;
  for (int m = 0; m < num_markers; ++m) {
    const int tm = mt[m];
    const int64_t km = mk[m];
    c0 += tm < t || (tm == t && km <= k);
    c1 += tm < t || (tm == t && km <= ke);
  }
  kend[o] = ke;
  first[o] = max(c0 - 1, 0);
  last[o] = max(c1 - 1, 0);
}

// Replaces inside_root_kernel (src/repro/kernels/sfc.py:662, body
// _inside_body :536): the Proposition-23 test against the root simplex,
// one element a thread, with the level-0 rule of sfc.py:171 (a level-0
// element is inside only if it is the root).
template <int D>
__global__ void __launch_bounds__(kThreads)
inside_root_kernel(const int32_t* __restrict__ anchor, const int32_t* __restrict__ level,
                   const int32_t* __restrict__ stype, uint8_t* __restrict__ inside, int64_t n) {
  const int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
  if (i >= n) return;
  int c[D];
#pragma unroll
  for (int k = 0; k < D; ++k) c[k] = anchor[i * D + k];
  inside[i] = inside_root_of<D>(c, level[i], stype[i]) ? 1 : 0;
}

inline unsigned blocks_for(int64_t work) {
  return static_cast<unsigned>((work + kThreads - 1) / kThreads);
}

}  // namespace

extern "C" {

int sfc_morton_key(int d, const void* anchor, const void* stype, void* key, int64_t n,
                   void* stream) {
  if (n <= 0) return cudaSuccess;
  auto s = static_cast<cudaStream_t>(stream);
  auto a = static_cast<const int32_t*>(anchor);
  auto b = static_cast<const int32_t*>(stype);
  auto k = static_cast<int64_t*>(key);
  if (d == 2) morton_key_kernel<2><<<blocks_for(n), kThreads, 0, s>>>(a, b, k, n);
  else if (d == 3) morton_key_kernel<3><<<blocks_for(n), kThreads, 0, s>>>(a, b, k, n);
  else return cudaErrorInvalidValue;
  return cudaGetLastError();
}

int sfc_decode(int d, const void* key, const void* level, void* anchor, void* stype,
               int64_t n, void* stream) {
  if (n <= 0) return cudaSuccess;
  auto s = static_cast<cudaStream_t>(stream);
  auto k = static_cast<const int64_t*>(key);
  auto l = static_cast<const int32_t*>(level);
  auto a = static_cast<int32_t*>(anchor);
  auto b = static_cast<int32_t*>(stype);
  if (d == 2) decode_kernel<2><<<blocks_for(n), kThreads, 0, s>>>(k, l, a, b, n);
  else if (d == 3) decode_kernel<3><<<blocks_for(n), kThreads, 0, s>>>(k, l, a, b, n);
  else return cudaErrorInvalidValue;
  return cudaGetLastError();
}

int sfc_parent(int d, const void* anchor, const void* level, const void* stype,
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
  if (d == 2) parent_kernel<2><<<blocks_for(n), kThreads, 0, s>>>(a, l, b, pa, pl, pb, pi, n);
  else if (d == 3) parent_kernel<3><<<blocks_for(n), kThreads, 0, s>>>(a, l, b, pa, pl, pb, pi, n);
  else return cudaErrorInvalidValue;
  return cudaGetLastError();
}

int sfc_children(int d, const void* anchor, const void* level, const void* stype,
                 void* c_anchor, void* c_level, void* c_stype, int64_t n, void* stream) {
  if (n <= 0) return cudaSuccess;
  auto s = static_cast<cudaStream_t>(stream);
  auto a = static_cast<const int32_t*>(anchor);
  auto l = static_cast<const int32_t*>(level);
  auto b = static_cast<const int32_t*>(stype);
  auto ca = static_cast<int32_t*>(c_anchor);
  auto cl = static_cast<int32_t*>(c_level);
  auto cb = static_cast<int32_t*>(c_stype);
  if (d == 2) children_kernel<2><<<blocks_for(n << 2), kThreads, 0, s>>>(a, l, b, ca, cl, cb, n);
  else if (d == 3) children_kernel<3><<<blocks_for(n << 3), kThreads, 0, s>>>(a, l, b, ca, cl, cb, n);
  else return cudaErrorInvalidValue;
  return cudaGetLastError();
}

int sfc_face_sweep(int d, const void* anchor, const void* level, const void* stype,
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
  if (d == 2) face_sweep_kernel<2><<<blocks_for(n), kThreads, 0, s>>>(a, l, b, na, nb, du, in, k, n);
  else if (d == 3) face_sweep_kernel<3><<<blocks_for(n), kThreads, 0, s>>>(a, l, b, na, nb, du, in, k, n);
  else return cudaErrorInvalidValue;
  return cudaGetLastError();
}

int sfc_eval_route(int d, const void* tgt, const void* key, const void* level,
                   const void* marker_tree, const void* marker_key, int num_markers,
                   void* kend, void* first, void* last, int64_t n, void* stream) {
  if (n <= 0) return cudaSuccess;
  if (num_markers < 1 || num_markers > kMaxMarkers) return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  auto t = static_cast<const int32_t*>(tgt);
  auto k = static_cast<const int64_t*>(key);
  auto l = static_cast<const int32_t*>(level);
  auto mt = static_cast<const int32_t*>(marker_tree);
  auto mk = static_cast<const int64_t*>(marker_key);
  auto ke = static_cast<int64_t*>(kend);
  auto f = static_cast<int32_t*>(first);
  auto la = static_cast<int32_t*>(last);
  const size_t shmem = static_cast<size_t>(num_markers) * (sizeof(int64_t) + sizeof(int32_t));
  const dim3 grid(blocks_for(n), d + 1);
  if (d == 2) eval_route_kernel<2><<<grid, kThreads, shmem, s>>>(t, k, l, mt, mk, num_markers, ke, f, la, n);
  else if (d == 3) eval_route_kernel<3><<<grid, kThreads, shmem, s>>>(t, k, l, mt, mk, num_markers, ke, f, la, n);
  else return cudaErrorInvalidValue;
  return cudaGetLastError();
}

int sfc_inside_root(int d, const void* anchor, const void* level, const void* stype,
                    void* inside, int64_t n, void* stream) {
  if (n <= 0) return cudaSuccess;
  auto s = static_cast<cudaStream_t>(stream);
  auto a = static_cast<const int32_t*>(anchor);
  auto l = static_cast<const int32_t*>(level);
  auto b = static_cast<const int32_t*>(stype);
  auto in = static_cast<uint8_t*>(inside);
  if (d == 2) inside_root_kernel<2><<<blocks_for(n), kThreads, 0, s>>>(a, l, b, in, n);
  else if (d == 3) inside_root_kernel<3><<<blocks_for(n), kThreads, 0, s>>>(a, l, b, in, n);
  else return cudaErrorInvalidValue;
  return cudaGetLastError();
}

}  // extern "C"
