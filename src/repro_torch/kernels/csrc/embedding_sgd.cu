// Row-wise SGD scatter-apply for Hopper (sm_90a), fp32, in place.
//
//   persia_embedding_sgd_f32: table[ids[t]] = table[ids[t]] + (-lr * grads[t])
//
// It replaces the Pallas TPU kernel
//   src/repro/kernels/embedding_sgd.py  embedding_sgd (_sgd_kernel)
// and agrees bit for bit with its plain torch version in ../ref.py
// (embedding_sgd_ref), which follows the JAX oracle ref.embedding_sgd_ref:
// an id is applied when 0 <= id < V; -1 and ids >= V change nothing (the
// oracle's scatter drops them; the Pallas kernel would rewrite row 0 for a
// -1 as row0 - lr * 0 * g, and this kernel never touches it).
//
// Design. The TPU kernel walks the T puts as a sequential grid, one row DMA
// in and out per step through an aliased block. Here the puts are
// independent, and the work of each is a short chain of dependent loads
// (id, then table row, then the store), so the kernel is shaped to keep
// that chain short and many chains in flight:
//
// * One warp per put row, `rows` rows per warp. Lanes 0..rows-1 load the
//   warp's ids, one each, and __shfl_sync hands every lane all of them:
//   one load per id, not one per lane. Each lane owns one float4 of a row
//   per 32-float4 chunk (one float on the scalar path, taken when D % 4 !=
//   0 or the table or grads is not 16-byte aligned); a row wider than a
//   chunk loops over chunks.
// * Every row's gradient loads are issued before the id test, since they do
//   not depend on it (a no-op row's gradient is read and dropped), then
//   every live row's table load before the first add and store: a warp has
//   all its rows' loads in flight at once, and the chain is two round trips
//   (ids with gradients, then table rows).
// * `rows` is chosen per launch: one while the grid does not fill a wave of
//   kWaveCtas CTAs of kWarps warps, then up to kMaxRows, so a small put
//   (the entry point's 694 rows: 174 CTAs) still spreads over all 132 SMs.
// * A programmatic dependent launch (PDL, cudaLaunchKernelEx with
//   programmatic stream serialization): the kernel lets its successor
//   launch at once (griddepcontrol.launch_dependents) and waits for its
//   predecessor (griddepcontrol.wait) before its first read of ids, grads
//   or table, which a preceding kernel may write (a segment sum writes the
//   gradients). In a chain of puts, a launch's setup overlaps the one
//   before it.
//
// The product and the sum are one correctly rounded operation each
// (__fmul_rn, __fadd_rn: no FMA contraction), so the result equals the
// plain version's row + (-lr * g). Ids must be unique among the valid
// entries (ops.embedding_sgd checks them on the host unless the caller
// vouches): two warps writing one row would race, as two grid steps of the
// TPU kernel last-write-win. Row offsets are int64, since V * D can pass
// 2^31.
//
// Bound: memory. Each valid put reads its gradient row and its table row and
// writes the table row back; each id is read once:
//   (T * 4 + n_valid * D * 4 * 3) / 3.35 TB/s.
// At one kwai-dlrm put (about 700 unique rows of 128) that is about 0.3 us,
// under the fixed cost of a launch. No wgmma, TMA or shared-memory staging:
// the rows are scattered and each element is used once, so there is
// nothing to stage or reuse; what is left is the launch and two dependent
// round trips to memory.
//
// persia_launch_floor launches an empty one-thread kernel, plainly or as a
// programmatic dependent: the fixed cost any launch pays, timed beside the
// kernels.
//
// C interface (bound with ctypes): launches on `stream`, does not
// synchronise, allocates nothing, and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarps = 4;                  // warps per CTA
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxRows = 4;                // put rows per warp, at most
constexpr int kWaveCtas = 132 * 16;        // H100: 132 SMs x 16 CTAs of 128

__device__ __forceinline__ void sgd(float& r, float g, float neg_lr) {
  r = __fadd_rn(r, __fmul_rn(neg_lr, g));
}
__device__ __forceinline__ void sgd(float4& r, float4 g, float neg_lr) {
  sgd(r.x, g.x, neg_lr);
  sgd(r.y, g.y, neg_lr);
  sgd(r.z, g.z, neg_lr);
  sgd(r.w, g.w, neg_lr);
}

// T is float or float4; n_vec elements of T per row; each warp applies the
// `rows` consecutive puts from its first, t0.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    sgd_kernel(T* __restrict__ table, const int* __restrict__ ids,
               const T* __restrict__ grads, long long V, int n_puts,
               int n_vec, int rows, float neg_lr) {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  const int lane = threadIdx.x & 31;
  const long long t0 =
      ((long long)blockIdx.x * kWarps + (threadIdx.x >> 5)) * rows;
  // the warp's rows that exist (warp-uniform; <= 0 past the last put)
  const long long left = (long long)n_puts - t0;
  const int n_rows = left < rows ? (int)left : rows;
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  if (n_rows <= 0) return;
  const int my_id = lane < n_rows ? __ldg(ids + t0 + lane) : -1;
  int id[kMaxRows];
  for (int c0 = 0; c0 < n_vec; c0 += 32) {
    const int c = c0 + lane;
    const bool in = c < n_vec;
    T g[kMaxRows];
#pragma unroll
    for (int k = 0; k < kMaxRows; ++k) {
      if (k < n_rows && in) g[k] = __ldg(grads + (t0 + k) * n_vec + c);
    }
    if (c0 == 0) {
#pragma unroll
      for (int k = 0; k < kMaxRows; ++k) id[k] = __shfl_sync(kFull, my_id, k);
    }
    T r[kMaxRows];
#pragma unroll
    for (int k = 0; k < kMaxRows; ++k) {
      if (k < n_rows && in && id[k] >= 0 && id[k] < V)
        r[k] = table[(long long)id[k] * n_vec + c];
    }
#pragma unroll
    for (int k = 0; k < kMaxRows; ++k) {
      if (k < n_rows && in && id[k] >= 0 && id[k] < V) {
        sgd(r[k], g[k], neg_lr);
        table[(long long)id[k] * n_vec + c] = r[k];
      }
    }
  }
}

__global__ void noop_kernel() {}

cudaLaunchConfig_t config(dim3 grid, dim3 block, cudaStream_t stream,
                          cudaLaunchAttribute* attr, bool pdl) {
  attr->id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr->val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = block;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = pdl ? 1 : 0;
  return cfg;
}

// The launch's error if it was refused, else cudaGetLastError(); either way
// the error is cleared, so a later launch does not report it.
int launched(cudaError_t err) {
  const cudaError_t last = cudaGetLastError();
  return static_cast<int>(err != cudaSuccess ? err : last);
}

}  // namespace

// Put rows per warp for a put of T rows: one until the grid fills a wave of
// kWaveCtas CTAs, then up to kMaxRows.
extern "C" int persia_embedding_sgd_rows_per_warp(long long T) {
  const long long wave = (long long)kWaveCtas * kWarps;
  return static_cast<int>(std::min<long long>(
      std::max<long long>((T + wave - 1) / wave, 1), kMaxRows));
}

// table (V, D) fp32, updated in place; ids (T,) int32, applied where
// 0 <= id < V; grads (T, D) fp32.
extern "C" int persia_embedding_sgd_f32(float* table, const int* ids,
                                        const float* grads, long long V, int T,
                                        int D, float lr, void* stream) {
  if (T < 0 || D <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (T == 0) return static_cast<int>(cudaGetLastError());
  const bool vec = (D % 4 == 0) &&
                   (reinterpret_cast<uintptr_t>(table) % 16 == 0) &&
                   (reinterpret_cast<uintptr_t>(grads) % 16 == 0);
  const int n_vec = vec ? D / 4 : D;
  const int rows = persia_embedding_sgd_rows_per_warp(T);
  const long long warps = ((long long)T + rows - 1) / rows;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      config(dim3((unsigned)((warps + kWarps - 1) / kWarps)), dim3(kThreads),
             static_cast<cudaStream_t>(stream), &attr, true);
  if (vec) {
    return launched(cudaLaunchKernelEx(
        &cfg, sgd_kernel<float4>, reinterpret_cast<float4*>(table), ids,
        reinterpret_cast<const float4*>(grads), V, T, n_vec, rows, -lr));
  }
  return launched(cudaLaunchKernelEx(&cfg, sgd_kernel<float>, table, ids,
                                     grads, V, T, n_vec, rows, -lr));
}

// One empty one-thread kernel, as a programmatic dependent when `pdl`.
extern "C" int persia_launch_floor(int pdl, void* stream) {
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = config(
      dim3(1), dim3(1), static_cast<cudaStream_t>(stream), &attr, pdl != 0);
  return launched(cudaLaunchKernelEx(&cfg, noop_kernel));
}
