// Flash-attention forward for Hopper (sm_90a): causal and/or sliding-window
// GQA attention with an fp32 online softmax, fp32 or bf16 inputs.
//
//   persia_flash_attention_fwd:
//     q (B, Hq, Sq, Dh), k and v (B, Hkv, Sk, Dh); query head h reads kv
//     head h / (Hq / Hkv);
//     s = (q . k) * scale + bias, bias = 0 where attended, -1e30 where masked
//     (masked: causal and qpos < kpos, or window > 0 and qpos - kpos >=
//     window, with qpos = query row + q_offset);
//     o = softmax(s) v in q's dtype, lse = m + log(max(l, 1e-30)) in fp32
//     (B, Hq, Sq).
//
// It replaces the Pallas TPU kernel
//   src/repro/kernels/flash_attention.py  flash_attention_fwd (_kernel)
// and is held against its plain torch version in ../ref.py
// (flash_attention_fwd_ref, the arithmetic of models/layers.py::_attn_naive)
// within a tolerance: the exponentials and the sums run in another order.
//
// Design. The TPU kernel carries its accumulator in VMEM across a
// sequential kv grid axis and needs Sq and Sk to be multiples of its
// blocks. Here each CTA owns one (batch, query head, 64-query tile) and
// loops over 64-key tiles itself: the query tile stays in shared memory,
// each key tile's K and V are staged in shared memory (as fp32; bf16 inputs
// are widened on the load), and the running max m, sum l and the output
// accumulator stay in registers. 256 threads as 16 x 16: thread (ty, tx)
// owns query rows ty + 16 i (i < 4), score columns tx + 16 j (j < 4) and
// output columns tx + 16 c (c < Dh / 16), so a row's 16 threads are one
// half-warp and its max and sum are shuffle reductions. The scores of a
// tile go through shared memory (P) for the P.V product. Ragged edges are
// masked, not padded: query rows past Sq are computed on zeros and never
// stored, keys past Sk are absent (score -inf, weight 0), unlike masked
// keys (-1e30), which keep the reference's semantics for a row with no
// attended key (a uniform average). Key tiles wholly above the causal
// diagonal or wholly outside the window for every row of the CTA are
// skipped, unless some row of the tile attends no key at all (possible only
// with a window and Sq + q_offset > Sk), which must then see every key.
// CTAs are issued last query tile first, so the longest causal rows start
// early. expf and logf, not the fast intrinsics; a true division at the end.
//
// Bound: operations. 4 * B * Hq * Dh * (attended pairs) fp32 operations
// against 67 TFLOP/s; the bytes (q, k, v read once, o written once) are a
// few percent of that at prefill length. No tensor core applies to fp32
// with TF32 off; this kernel is a simple, correct SIMT kernel (no TMA, no
// wgmma, no pipelining), written to be right first.
//
// Shared memory: (64 + 2 * 64) * (Dh + 4) + 64 * 68 floats, 118,784 bytes
// at Dh = 128, so the kernel opts in to dynamic shared memory above 48 KB.
//
// C interface (bound with ctypes): launches on `stream`, does not
// synchronise, allocates nothing, and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;          // query rows per CTA
constexpr int BK = 64;          // keys per tile
constexpr int NT = 256;         // threads per CTA, 16 x 16
constexpr int LDP = BK + 4;     // row stride of the P tile
constexpr float kMasked = -1e30f;

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&raw.x);
  const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&raw.y);
  const float2 a = __bfloat1622float2(lo), b = __bfloat1622float2(hi);
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// rows [r0, r0 + 64) of a (n_rows, Dh) matrix into a (64, ld) fp32 tile;
// rows past n_rows read as zero.
template <typename T>
__device__ __forceinline__ void load_tile(float* dst, int ld, const T* src,
                                          int r0, int n_rows, int Dh) {
  const int n4 = Dh / 4;
  for (int i = threadIdx.x; i < 64 * n4; i += NT) {
    const int r = i / n4, c = (i - r * n4) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + r < n_rows) x = load4(src + (long long)(r0 + r) * Dh + c);
    *reinterpret_cast<float4*>(dst + r * ld + c) = x;
  }
}

__device__ __forceinline__ float half_warp_max(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}
__device__ __forceinline__ float half_warp_sum(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// DMAX: the largest Dh this instantiation takes (64 or 128).
template <typename T, int DMAX>
__global__ void __launch_bounds__(NT)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, int Hq, int Hkv, int Sq, int Sk,
                 int Dh, float scale, int causal, int window, int q_offset) {
  constexpr int NC = DMAX / 16;   // output columns per thread
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int ld = Dh + 4;
  float* sQ = smem;
  float* sK = sQ + BQ * ld;
  float* sV = sK + BK * ld;
  float* sP = sV + BK * ld;

  const int qt = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int q0 = qt * BQ;
  const long long q_base = ((long long)b * Hq + h) * Sq;
  const T* qb = q + q_base * Dh;
  const T* kb = k + ((long long)b * Hkv + hk) * Sk * Dh;
  const T* vb = v + ((long long)b * Hkv + hk) * Sk * Dh;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;

  // the key tiles this query tile needs
  const long long qlo = (long long)q0 + q_offset;
  const long long qhi = (long long)min(q0 + BQ, Sq) - 1 + q_offset;
  const int nk = (Sk + BK - 1) / BK;
  int kt_begin = 0, kt_end = nk;
  const bool row_without_keys =
      window > 0 && qhi >= (long long)Sk + window - 1;
  if (!row_without_keys) {
    if (causal) kt_end = (int)min((long long)nk, qhi / BK + 1);
    if (window > 0) {
      const long long first_key = qlo - window + 1;
      if (first_key > 0) kt_begin = (int)min((long long)nk, first_key / BK);
    }
  }

  load_tile(sQ, ld, qb, q0, Sq, Dh);

  float m[4], l[4], acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kMasked;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
  }

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();              // the last tile's K, V and P are read
    load_tile(sK, ld, kb, k0, Sk, Dh);
    load_tile(sV, ld, vb, k0, Sk, Dh);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    for (int d = 0; d < Dh; d += 4) {
      float4 qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = load4(sQ + (ty + 16 * i) * ld + d);
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = load4(sK + (tx + 16 * j) * ld + d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qv[i].x, kv[j].x, s[i][j]);
          s[i][j] = fmaf(qv[i].y, kv[j].y, s[i][j]);
          s[i][j] = fmaf(qv[i].z, kv[j].z, s[i][j]);
          s[i][j] = fmaf(qv[i].w, kv[j].w, s[i][j]);
        }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const long long qpos = qlo + ty + 16 * i;
      float mt = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx + 16 * j;
        float x = -INFINITY;      // past the keys: absent
        if (kpos < Sk) {
          bool attended = true;
          if (causal) attended = attended && qpos >= kpos;
          if (window > 0) attended = attended && qpos - kpos < window;
          x = s[i][j] * scale + (attended ? 0.f : kMasked);
        }
        s[i][j] = x;
        mt = fmaxf(mt, x);
      }
      const float m_new = fmaxf(m[i], half_warp_max(mt));
      const float corr = expf(m[i] - m_new);
      float ps = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        ps += p;
        sP[(ty + 16 * i) * LDP + tx + 16 * j] = p;
      }
      l[i] = l[i] * corr + half_warp_sum(ps);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[i][c] *= corr;
    }
    __syncthreads();

    for (int kk = 0; kk < BK; kk += 4) {
      float4 p4[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p4[i] = load4(sP + (ty + 16 * i) * LDP + kk);
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int col = tx + 16 * c;
        if (col < Dh) {
          const float v0 = sV[(kk + 0) * ld + col];
          const float v1 = sV[(kk + 1) * ld + col];
          const float v2 = sV[(kk + 2) * ld + col];
          const float v3 = sV[(kk + 3) * ld + col];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            acc[i][c] = fmaf(p4[i].x, v0, acc[i][c]);
            acc[i][c] = fmaf(p4[i].y, v1, acc[i][c]);
            acc[i][c] = fmaf(p4[i].z, v2, acc[i][c]);
            acc[i][c] = fmaf(p4[i].w, v3, acc[i][c]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= Sq) continue;
    const float lc = fmaxf(l[i], 1e-30f);
    T* orow = o + (q_base + row) * Dh;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int col = tx + 16 * c;
      if (col < Dh) store(orow + col, acc[i][c] / lc);
    }
    if (tx == 0) lse[q_base + row] = m[i] + logf(lc);
  }
}

size_t smem_bytes(int Dh) {
  return sizeof(float) * ((size_t)(BQ + 2 * BK) * (Dh + 4) + (size_t)BQ * LDP);
}

template <typename T, int DMAX>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           int B, int Hq, int Hkv, int Sq, int Sk, int Dh, float scale,
           int causal, int window, int q_offset, cudaStream_t stream) {
  auto kernel = flash_fwd_kernel<T, DMAX>;
  // opt in once per instantiation, for its largest Dh, so that no launch
  // (nor one captured into a CUDA graph) makes the call
  static bool opted_in = false;
  if (!opted_in) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem_bytes(DMAX));
    if (err != cudaSuccess) return static_cast<int>(err);
    opted_in = true;
  }
  const size_t smem = smem_bytes(Dh);
  const dim3 grid((Sq + BQ - 1) / BQ, Hq, B);
  kernel<<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, Hq, Hkv, Sq, Sk, Dh,
      scale, causal, window, q_offset);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q (B, Hq, Sq, Dh), k and v (B, Hkv, Sk, Dh), o (B, Hq, Sq, Dh): fp32
// (bf16 == 0) or bf16 (bf16 == 1), contiguous, 16-byte (fp32) or 8-byte
// (bf16) aligned; lse (B, Hq, Sq) fp32. Dh a multiple of 4 in [4, 128],
// Hq a multiple of Hkv, Sk >= 1, window >= 0, q_offset >= 0.
extern "C" int persia_flash_attention_fwd(const void* q, const void* k,
                                          const void* v, void* o, float* lse,
                                          int B, int Hq, int Hkv, int Sq,
                                          int Sk, int Dh, float scale,
                                          int causal, int window,
                                          int q_offset, int bf16,
                                          void* stream) {
  if (B <= 0 || Hq <= 0 || Hkv <= 0 || Hq % Hkv != 0 || Sq <= 0 || Sk <= 0 ||
      Dh < 4 || Dh > 128 || Dh % 4 != 0 || window < 0 || q_offset < 0 ||
      Hq > 65535 || B > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) {
    return Dh <= 64 ? launch<__nv_bfloat16, 64>(q, k, v, o, lse, B, Hq, Hkv,
                                                Sq, Sk, Dh, scale, causal,
                                                window, q_offset, s)
                    : launch<__nv_bfloat16, 128>(q, k, v, o, lse, B, Hq, Hkv,
                                                 Sq, Sk, Dh, scale, causal,
                                                 window, q_offset, s);
  }
  return Dh <= 64 ? launch<float, 64>(q, k, v, o, lse, B, Hq, Hkv, Sq, Sk, Dh,
                                      scale, causal, window, q_offset, s)
                  : launch<float, 128>(q, k, v, o, lse, B, Hq, Hkv, Sq, Sk,
                                       Dh, scale, causal, window, q_offset, s);
}
