// Fused embedding backward for Hopper (sm_90a), fp32: the PS-side put of
// Persia's Alg. 1 in one call.
//
//   g_push[j] = sum_{k in [offsets[j], offsets[j+1])} grads[order[k]]
//   for each live j (0 <= apply_idx[j] < R), g = apply_self ? g_push[j]
//                                                           : apply_g[j]:
//     acc[row]   += mean(g^2)                    (adagrad; skipped for sgd)
//     table[row] += -lr * (g / sqrt(acc[row] + eps))   (sgd: -lr * g)
//
// It replaces the Pallas TPU kernel
//   src/repro/kernels/fused_backward.py  fused_backward (_kernel)
// and agrees bit for bit with its plain torch version in ../ref.py
// (fused_backward_ref).
//
// Design. The TPU kernel walks n_occ + cap grid steps in order, carrying
// the unique-width sums in VMEM from phase A into phase B. Blocks on the
// GPU run in no order, so the two phases are two grid passes on the
// stream (and a memset), launched by one call:
//
// * Phase A (segment_sum_kernel): one warp per unique position j < U and
//   group of 32 columns, a lane per column. The dedup plan's occurrence
//   CSR (order, offsets) tells the warp which occurrence rows to add; it
//   adds them in occurrence order from 0.0. The adds of one segment are a
//   serial chain, and a Zipf-hot id owns a segment of hundreds of rows
//   (~350 of ~2,300 at the training shape), so the chain's memory latency
//   is the kernel's critical path: the warp loads a window of 32 rows
//   (scalar, one register per row per lane) before adding them, and the
//   next window's indices are in flight meanwhile. No atomics: their
//   order changes from run to run, and the queue payload is bit-exact.
//   Payload rows past the plan (j >= U) are zeroed by a memset.
// * Phase B (apply_kernel): one warp per apply position j, its lanes
//   striding over D (float4 where D % 4 == 0 and the rows are 16-byte
//   aligned, scalar otherwise). Several positions can name one physical
//   row: the uniform-shuffle placement is not a bijection once
//   id * 1,000,003 wraps 2^32 (at 62,500 rows a quarter of the rows are
//   shared by two ids), so two unique ids of one batch may collide. The
//   JAX reference then adds both increments to acc before either step
//   reads it, and adds the row updates in position order. Here the first
//   position of a row (found by a warp-wide ballot scan of apply_idx)
//   leads: it adds every member's increment, then applies every member's
//   update, in position order; the other members return. No two warps
//   write one row, so no atomics here either. mean(g^2) adds the squares
//   in column order (each lane loads a slice of the row, the warp walks
//   it in order by shuffle).
//
// Every float operation is a correctly rounded intrinsic (__fadd_rn,
// __fmul_rn, __fdiv_rn, __fsqrt_rn), so nvcc cannot contract a product
// and a sum into an FMA (the reference rounds the -lr * step product
// before the row add) and the plain version can repeat each operation.
//
// Bound: memory. Each valid occurrence gradient row read once, each payload
// row written once, each applied gradient row read once and each live
// table row (and its acc) read and written once: at most 8 MB at the
// training shape (n_occ 4096, cap 4096, D 128), about 2.5 us at 3.35 TB/s
// (chip_smoke.py counts each call's bytes from its inputs). The kernel is
// written to be right first; the serial add chain of a hot id's segment
// and the O(cap) ballot scan per apply position are its known costs.
//
// C interface (bound with ctypes): launches on `stream`, does not
// synchronise, allocates nothing, returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;   // warps (positions) per block
constexpr int kScan = 8;    // ballots per round of the apply-position scan
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ void vzero(float& a) { a = 0.0f; }
__device__ __forceinline__ void vzero(float4& a) {
  a = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
}

// s + the squares of v's elements, in element order.
__device__ __forceinline__ float add_sq(float s, float v) {
  return __fadd_rn(s, __fmul_rn(v, v));
}
__device__ __forceinline__ float add_sq(float s, float4 v) {
  s = add_sq(s, v.x);
  s = add_sq(s, v.y);
  s = add_sq(s, v.z);
  return add_sq(s, v.w);
}

__device__ __forceinline__ float shfl(float v, int src) {
  return __shfl_sync(kFull, v, src);
}
__device__ __forceinline__ float4 shfl(float4 v, int src) {
  return make_float4(shfl(v.x, src), shfl(v.y, src), shfl(v.z, src),
                     shfl(v.w, src));
}

// The sum of the squares of row g's elements, in element order, on every
// lane: each lane loads one element (vector) of 32, then all lanes walk the
// 32 in order by shuffle. Every lane of the warp must call it.
template <typename T>
__device__ __forceinline__ float sum_sq(const T* __restrict__ g, int n_vec,
                                        int lane) {
  float s = 0.0f;
  for (int c0 = 0; c0 < n_vec; c0 += 32) {
    T mine;
    vzero(mine);
    if (c0 + lane < n_vec) mine = __ldg(g + c0 + lane);
    const int n = min(32, n_vec - c0);
    for (int u = 0; u < n; ++u) s = add_sq(s, shfl(mine, u));
  }
  return s;
}

// t + (-lr) * (g * r) element-wise; sgd (r unused) is t + (-lr) * g.
__device__ __forceinline__ float step(float t, float g, float nlr, float r,
                                      bool adagrad) {
  const float s = adagrad ? __fmul_rn(g, r) : g;
  return __fadd_rn(t, __fmul_rn(nlr, s));
}
__device__ __forceinline__ float4 step(float4 t, float4 g, float nlr, float r,
                                       bool adagrad) {
  return make_float4(step(t.x, g.x, nlr, r, adagrad),
                     step(t.y, g.y, nlr, r, adagrad),
                     step(t.z, g.z, nlr, r, adagrad),
                     step(t.w, g.w, nlr, r, adagrad));
}

// Phase A. One warp per (position j < U, group of 32 columns); lane =
// column. Scalar loads keep one register per row, so a warp holds a window
// of 32 occurrence rows in flight before adding them, and the next
// window's indices load meanwhile.
__global__ void segment_sum_kernel(const float* __restrict__ grads,
                                   const int* __restrict__ order,
                                   const int* __restrict__ offsets,
                                   float* __restrict__ push, int n_occ,
                                   int n_order, int n_seg, int D) {
  const int lane = threadIdx.x;
  const int n_grp = (D + 31) / 32;
  const long long w = (long long)blockIdx.x * blockDim.y + threadIdx.y;
  if (w >= (long long)n_seg * n_grp) return;
  const int j = static_cast<int>(w / n_grp);
  const int c = static_cast<int>(w % n_grp) * 32 + lane;
  const bool has = c < D;
  const int lo = min(max(__ldg(offsets + j), 0), n_order);
  const int hi = min(max(__ldg(offsets + j + 1), 0), n_order);
  auto index_at = [&](int k) { return k < hi ? __ldg(order + k) : -1; };
  float acc = 0.0f;
  int nxt = index_at(lo + lane);
  for (int base = lo; base < hi; base += 32) {
    const int cur = nxt;
    nxt = index_at(base + 32 + lane);
    float r[32];
    unsigned ok = 0;
#pragma unroll
    for (int u = 0; u < 32; ++u) {
      const int src = __shfl_sync(kFull, cur, u);
      const bool v = has && src >= 0 && src < n_occ;
      r[u] = v ? __ldg(grads + (long long)src * D + c) : 0.0f;
      ok |= static_cast<unsigned>(v) << u;
    }
    // the adds in occurrence order; entries that are not rows add nothing
#pragma unroll
    for (int u = 0; u < 32; ++u) {
      if ((ok >> u) & 1u) acc = __fadd_rn(acc, r[u]);
    }
  }
  if (has) push[(long long)j * D + c] = acc;
}

// The first position i >= from with idx[i] == row, or cap: a warp-wide
// scan, 32 positions per ballot, with 8 ballots' loads in flight at once.
// Every lane of the warp must call it with the same arguments.
__device__ __forceinline__ int next_member(const int* __restrict__ idx,
                                           int from, int cap, int row,
                                           int lane) {
  for (int base = from & ~31; base < cap; base += 32 * kScan) {
    unsigned m[kScan];
#pragma unroll
    for (int q = 0; q < kScan; ++q) {
      const int i = base + 32 * q + lane;
      m[q] = __ballot_sync(kFull,
                           i >= from && i < cap && __ldg(idx + i) == row);
    }
#pragma unroll
    for (int q = 0; q < kScan; ++q) {
      if (m[q]) return base + 32 * q + __ffs(m[q]) - 1;
    }
  }
  return cap;
}

template <typename T>
__global__ void apply_kernel(T* __restrict__ table, float* __restrict__ acc,
                             const int* __restrict__ apply_idx,
                             const T* __restrict__ g_src, long long R,
                             int cap, int D, int n_vec, float lr, float eps) {
  const int lane = threadIdx.x;
  const int j = blockIdx.x * blockDim.y + threadIdx.y;
  if (j >= cap) return;
  const int row = __ldg(apply_idx + j);
  if (row < 0 || row >= R) return;
  // only the first position of a row goes on; it applies all of them
  if (next_member(apply_idx, 0, cap, row, lane) != j) return;
  const int after = next_member(apply_idx, j + 1, cap, row, lane);
  const bool adagrad = acc != nullptr;
  float r = 1.0f;
  if (adagrad) {
    // every lane computes the same sums (the squares reach all lanes by
    // shuffle); lane 0 stores
    float a = acc[row];
    for (int i = j; i < cap;
         i = i == j ? after : next_member(apply_idx, i + 1, cap, row, lane)) {
      const float s = sum_sq(g_src + (long long)i * n_vec, n_vec, lane);
      a = __fadd_rn(a, __fdiv_rn(s, static_cast<float>(D)));
    }
    if (lane == 0) acc[row] = a;
    r = __fdiv_rn(1.0f, __fsqrt_rn(__fadd_rn(a, eps)));
  }
  const float nlr = -lr;
  T* t_row = table + (long long)row * n_vec;
  for (int i = j; i < cap;
       i = i == j ? after : next_member(apply_idx, i + 1, cap, row, lane)) {
    const T* g = g_src + (long long)i * n_vec;
    for (int c = lane; c < n_vec; c += 32) {
      t_row[c] = step(t_row[c], __ldg(g + c), nlr, r, adagrad);
    }
  }
}

bool aligned16(const void* p) {
  return p == nullptr || reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

template <typename T>
int launch(float* table, float* acc, const int* order, const int* offsets,
           const float* grads, const int* apply_idx, const float* apply_g,
           float* push, long long R, int n_occ, int n_order, int n_seg,
           int cap, int D, int n_vec, float lr, float eps, int apply_self,
           cudaStream_t stream) {
  const dim3 block(32, kWarps);
  // payload rows past the plan are zero
  if (n_seg < cap) {
    const cudaError_t err = cudaMemsetAsync(
        push + (long long)n_seg * D, 0,
        sizeof(float) * static_cast<size_t>(cap - n_seg) * D, stream);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (n_seg > 0) {
    const long long warps_a = (long long)n_seg * ((D + 31) / 32);
    segment_sum_kernel<<<static_cast<unsigned>((warps_a + kWarps - 1) /
                                               kWarps),
                         block, 0, stream>>>(grads, order, offsets, push,
                                             n_occ, n_order, n_seg, D);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid_b((cap + kWarps - 1) / kWarps);
  const float* g_src = apply_self ? push : apply_g;
  apply_kernel<T><<<grid_b, block, 0, stream>>>(
      reinterpret_cast<T*>(table), acc, apply_idx,
      reinterpret_cast<const T*>(g_src), R, cap, D, n_vec, lr, eps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// table (R, D) fp32, updated in place; acc (R,) fp32 in place, or null for
// sgd; order (n_order,) int32 occurrence rows of grads; offsets (n_seg + 1,)
// int32; grads (n_occ, D) fp32; apply_idx (cap,) int32, < 0 or >= R = no-op;
// apply_g (cap, D) fp32, or null with apply_self; push (cap, D) fp32 out.
extern "C" int persia_fused_backward_f32(
    float* table, float* acc, const int* order, const int* offsets,
    const float* grads, const int* apply_idx, const float* apply_g,
    float* push, long long R, int n_occ, int n_order, int n_seg, int cap,
    int D, float lr, float eps, int apply_self, void* stream) {
  if (cap <= 0 || D <= 0 || R < 0 || n_occ < 0 || n_order < 0 ||
      (!apply_self && apply_g == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  n_seg = max(min(n_seg, cap), 0);
  const bool vec = D % 4 == 0 && aligned16(table) &&
                   aligned16(push) && (apply_self || aligned16(apply_g));
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec) {
    return launch<float4>(table, acc, order, offsets, grads, apply_idx,
                          apply_g, push, R, n_occ, n_order, n_seg, cap, D,
                          D / 4, lr, eps, apply_self, s);
  }
  return launch<float>(table, acc, order, offsets, grads, apply_idx, apply_g,
                       push, R, n_occ, n_order, n_seg, cap, D, D, lr, eps,
                       apply_self, s);
}
