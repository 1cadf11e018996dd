// Hand-written Hopper (sm_90a) kernels for the four simplex SFC element ops
// on the New -> Adapt -> Partition path: encode (morton key), decode, parent
// (+ local index) and children.  One thread per element (per element and
// child for `children`), templated on the dimension D.
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
// These integer table walks do no floating-point work, and no published
// integer peak fits them, so the bound has no operations term.
// What the design does about it: encode and decode keep the whole level
// chain in registers and read the tables from shared memory, so the only
// memory traffic is the element itself; parent and children are single
// passes whose stores are contiguous across the threads of a warp.
//
// Every entry point launches on the caller's stream, does not synchronise,
// allocates nothing, and returns cudaGetLastError() after the launch.

#include <cstdint>
#include <cuda_runtime.h>

#include "sfc_tables.h"

namespace {

constexpr int kThreads = 256;
constexpr int kTab = 64;  // shared copy of a packed table; index mask kTab - 1

template <int D> struct Dim;
template <> struct Dim<2> {
  static constexpr int L = SFC_MAXLEVEL_2;
  static constexpr int NT = 2;
};
template <> struct Dim<3> {
  static constexpr int L = SFC_MAXLEVEL_3;
  static constexpr int NT = 6;
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

// Replaces morton_key_kernel (src/repro/kernels/sfc.py:557, body
// _encode_body :224 / _encode_expr :100): fine -> coarse over the levels,
// each digit the local index of the (cube-id, type) pair, the type walking
// up through the parent-type table.  The level plays no role: below an
// element's level its anchor bits are zero, cube-id 0 keeps the type and
// contributes digit 0.
template <int D>
__global__ void __launch_bounds__(kThreads)
morton_key_kernel(const int32_t* __restrict__ anchor, const int32_t* __restrict__ stype,
                  int64_t* __restrict__ key, int64_t n) {
  constexpr int L = Dim<D>::L, NC = 1 << D;
  __shared__ unsigned char enc[kTab];
  load_table<D, kEnc>(enc);
  const int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
  if (i >= n) return;
  int c[D];
#pragma unroll
  for (int k = 0; k < D; ++k) c[k] = anchor[i * D + k];
  int b = stype[i];
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
  key[i] = static_cast<int64_t>(k64);
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

}  // extern "C"
