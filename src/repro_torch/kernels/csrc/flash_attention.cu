// Causal / sliding-window GQA attention with an online softmax, for sm_90a.
//
// Replaces the Pallas TPU kernel `flash_attention`
// (src/repro/kernels/flash_attention.py:69, body `_flash_body` :35).  Same
// function: q (B, S, H, hd), k and v (B, S, KV, hd) with H % KV == 0, query
// head h reading KV head h / (H / KV); scores q.k / sqrt(hd) in fp32; a
// masked score is the finite -1e30 (causal: kpos <= qpos; with a window w
// also kpos > qpos - w; and kpos < S for the ragged last tile); an online
// softmax with fp32 running max, sum and accumulator; out = acc / max(l,
// 1e-30) in q's dtype.  Any S >= 1; hd 32, 64, 96 or 128.
//
// What bounds it: the multiply-adds.  A (b, h) pair needs 4 hd FLOPs per
// unmasked (query, key) pair (q.k and p.v) but reads q, k, v and writes o
// only once, so at the serving shapes (S in the thousands) the work is
// compute-bound on the tensor cores: 989 TFLOP/s dense bf16/fp16 on an H100
// SXM against 3.35 TB/s of device memory.
//
// What the design does about it (a simple first kernel; wgmma, TMA and warp
// specialisation are for a later redesign):
//  * bf16 / fp16: one block of 4 warps per (b, h, 64-query tile); each warp
//    owns 16 query rows.  Q's fragments stay in registers for the whole
//    loop; k/v tiles of 64 keys are staged in shared memory and both
//    products run on the tensor cores through mma.sync m16n8k16
//    with fp32 accumulation.  The score accumulators are reused in place as
//    the A operand of p.v (rounded to bf16/fp16 there, as the TPU kernel's
//    p @ v rounds on the MXU), so scores never leave registers.
//  * fp32: CUDA cores only (never TF32), so that it holds 2e-5 against the
//    plain version.  One block of 8 warps per (b, h, 32-query tile); warp w
//    owns rows w, w + 8, w + 16, w + 24, lane j owns key j of a 32-key tile,
//    and the running max, sum and output stay in registers.
//  * Both loop only over the k/v tiles that the causal (and window) band of
//    their query tile touches: masked tiles are never loaded, so the work is
//    S (S + 1) / 2 pairs a head, not S^2.  A row whose first visited tile is
//    fully masked (a window smaller than the tile) accumulates p = 1 on the
//    finite -1e30, which the first unmasked tile wipes with
//    corr = exp(-1e30 - m) = 0, exactly as on the TPU.
//  * The public layout (B, S, H, hd) is read in place through its strides,
//    16 bytes a thread; rows past S are loaded as zeros and masked.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

// ------------------------------------------------------------------ fp16 / bf16
constexpr int TC_BQ = 64;        // query rows a block (16 a warp)
constexpr int TC_BK = 64;        // keys a tile
constexpr int TC_THREADS = 128;
constexpr int TC_PAD = 8;        // 16 B of padding a shared row: conflict-free fragments

template <typename T> struct Tc;
template <> struct Tc<__nv_bfloat16> {
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
  static __device__ __forceinline__ void mma(float* d, const uint32_t* a, uint32_t b0,
                                             uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
};
template <> struct Tc<__half> {
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    __half2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
  static __device__ __forceinline__ void mma(float* d, const uint32_t* a, uint32_t b0,
                                             uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
};

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

// Stage rows [row0, row0 + rows) of one head into shared memory (row stride
// HD + TC_PAD), 16 bytes a thread, zeros past S.
template <typename T, int HD>
__device__ __forceinline__ void stage(T* dst, const T* src, int64_t s_stride, int row0,
                                      int rows, int S) {
  constexpr int PER_ROW = HD / 8;
  for (int i = threadIdx.x; i < rows * PER_ROW; i += blockDim.x) {
    const int r = i / PER_ROW, c = (i % PER_ROW) * 8;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (row0 + r < S)
      val = __ldg(reinterpret_cast<const uint4*>(src + (int64_t)(row0 + r) * s_stride + c));
    *reinterpret_cast<uint4*>(dst + r * (HD + TC_PAD) + c) = val;
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(TC_THREADS)
flash_tc_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                T* __restrict__ o, Shape sh, float scale_log2) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* q_s = reinterpret_cast<T*>(smem_raw);                 // [TC_BQ][HD + PAD]
  T* k_s = q_s + TC_BQ * (HD + TC_PAD);                    // [TC_BK][HD + PAD]
  T* v_s = k_s + TC_BK * (HD + TC_PAD);                    // [TC_BK][HD + PAD]

  const int n_qt = (sh.S + TC_BQ - 1) / TC_BQ;
  const int qt = n_qt - 1 - blockIdx.x;                    // longest bands first
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (sh.H / sh.KV);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, tg = lane % 4;
  const int q0 = qt * TC_BQ;

  const T* qb = q + b * sh.qs_b + h * sh.qs_h;
  const T* kb = k + b * sh.ks_b + kvh * sh.ks_h;
  const T* vb = v + b * sh.ks_b + kvh * sh.ks_h;

  stage<T, HD>(q_s, qb, sh.qs_s, q0, TC_BQ, sh.S);
  __syncthreads();

  // Q's A fragments for this warp's 16 rows, all hd chunks.
  constexpr int KC = HD / 16;
  uint32_t qf[KC][4];
  {
    const int r = warp * 16 + g;
#pragma unroll
    for (int kc = 0; kc < KC; ++kc) {
      const int c = kc * 16 + tg * 2;
      qf[kc][0] = *reinterpret_cast<const uint32_t*>(q_s + r * (HD + TC_PAD) + c);
      qf[kc][1] = *reinterpret_cast<const uint32_t*>(q_s + (r + 8) * (HD + TC_PAD) + c);
      qf[kc][2] = *reinterpret_cast<const uint32_t*>(q_s + r * (HD + TC_PAD) + c + 8);
      qf[kc][3] = *reinterpret_cast<const uint32_t*>(q_s + (r + 8) * (HD + TC_PAD) + c + 8);
    }
  }

  constexpr int NT = TC_BK / 8;         // score n-tiles of 8 keys
  constexpr int OT = HD / 8;            // output n-tiles of 8 columns
  float oacc[OT][4];
#pragma unroll
  for (int n = 0; n < OT; ++n) oacc[n][0] = oacc[n][1] = oacc[n][2] = oacc[n][3] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  const int qpos[2] = {q0 + warp * 16 + g, q0 + warp * 16 + g + 8};

  int t_lo, t_hi;
  tile_range(sh, q0, min(q0 + TC_BQ, sh.S) - 1, TC_BK, &t_lo, &t_hi);
  for (int t = t_lo; t <= t_hi; ++t) {
    const int k0 = t * TC_BK;
    __syncthreads();                    // the previous tile's reads are done
    stage<T, HD>(k_s, kb, sh.ks_s, k0, TC_BK, sh.S);
    stage<T, HD>(v_s, vb, sh.ks_s, k0, TC_BK, sh.S);
    __syncthreads();

    float s[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
      const T* krow = k_s + (j * 8 + g) * (HD + TC_PAD) + tg * 2;
#pragma unroll
      for (int kc = 0; kc < KC; ++kc) {
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(krow + kc * 16);
        const uint32_t b1 = *reinterpret_cast<const uint32_t*>(krow + kc * 16 + 8);
        Tc<T>::mma(s[j], qf[kc], b0, b1);
      }
    }

    // Scale into the log2 domain, mask, and update the running max and sum
    // of rows g (r = 0) and g + 8 (r = 1); the four lanes of a quad hold a
    // row's 64 scores between them.
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int kpos = k0 + j * 8 + tg * 2 + e;
          float& x = s[j][2 * r + e];
          x = unmasked(sh, qpos[r], kpos) ? x * scale_log2 : kNegInf;
          mx = fmaxf(mx, x);
        }
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[r], mx);
      const float corr = exp2f(m[r] - m_new);
      m[r] = m_new;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& x = s[j][2 * r + e];
          x = exp2f(x - m_new);
          sum += x;
        }
      }
      l[r] = l[r] * corr + sum;         // this lane's share; summed over the quad at the end
#pragma unroll
      for (int n = 0; n < OT; ++n) {
        oacc[n][2 * r] *= corr;
        oacc[n][2 * r + 1] *= corr;
      }
    }

    // o += p . v: score tiles 2kk and 2kk + 1 are the A fragment of keys
    // [16 kk, 16 kk + 16); v's B fragment pairs two keys of one column,
    // read as 16-bit halves (conflict-free with the padded row stride).
    const uint16_t* v16 = reinterpret_cast<const uint16_t*>(v_s);
#pragma unroll
    for (int kk = 0; kk < TC_BK / 16; ++kk) {
      uint32_t pa[4];
      pa[0] = Tc<T>::pack(s[2 * kk][0], s[2 * kk][1]);
      pa[1] = Tc<T>::pack(s[2 * kk][2], s[2 * kk][3]);
      pa[2] = Tc<T>::pack(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pa[3] = Tc<T>::pack(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int n = 0; n < OT; ++n) {
        const uint16_t* vcol = v16 + (kk * 16 + tg * 2) * (HD + TC_PAD) + n * 8 + g;
        const uint32_t b0 = vcol[0] | ((uint32_t)vcol[HD + TC_PAD] << 16);
        const uint32_t b1 = vcol[8 * (HD + TC_PAD)] | ((uint32_t)vcol[9 * (HD + TC_PAD)] << 16);
        Tc<T>::mma(oacc[n], pa, b0, b1);
      }
    }
  }

  T* ob = o + b * sh.qs_b + h * sh.qs_h;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float lsum = l[r];
    lsum += __shfl_xor_sync(0xffffffffu, lsum, 1);
    lsum += __shfl_xor_sync(0xffffffffu, lsum, 2);
    const float inv = 1.f / fmaxf(lsum, 1e-30f);
    if (qpos[r] < sh.S) {
      T* orow = ob + (int64_t)qpos[r] * sh.qs_s + tg * 2;
#pragma unroll
      for (int n = 0; n < OT; ++n)
        *reinterpret_cast<uint32_t*>(orow + n * 8) =
            Tc<T>::pack(oacc[n][2 * r] * inv, oacc[n][2 * r + 1] * inv);
    }
  }
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
template <typename T, int HD>
cudaError_t launch_tc(const void* q, const void* k, const void* v, void* o, const Shape& sh,
                      cudaStream_t stream) {
  const size_t smem = sizeof(T) * (size_t)(TC_BQ + 2 * TC_BK) * (HD + TC_PAD);
  cudaError_t err = cudaFuncSetAttribute(flash_tc_kernel<T, HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((sh.S + TC_BQ - 1) / TC_BQ, sh.H, sh.B);
  const float scale_log2 = kLog2e / sqrtf((float)HD);
  flash_tc_kernel<T, HD><<<grid, TC_THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), sh, scale_log2);
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
    case 1: return launch_tc<__nv_bfloat16, HD>(q, k, v, o, sh, stream);
    case 2: return launch_tc<__half, HD>(q, k, v, o, sh, stream);
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
    default: return (int)cudaErrorInvalidValue;
  }
}
