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
// in and out per step through an aliased block. Here every (put, column)
// pair is independent: a flat grid of threads, one float4 (or one float on
// the scalar path, when D % 4 != 0 or a pointer is not 16-byte aligned)
// each; a thread loads its put's id, reads the table element, and writes it
// back. The product and the sum are one correctly rounded operation each
// (__fmul_rn, __fadd_rn: no FMA contraction), so the result equals the
// plain version's row + (-lr * g). Ids must be unique among the valid
// entries (ops.embedding_sgd checks them on the host unless the caller
// vouches): two threads writing one row would race, as two grid steps of
// the TPU kernel last-write-win. Row offsets are int64, since V * D can pass
// 2^31.
//
// Bound: memory. Each valid put reads its gradient row and its table row and
// writes the table row back; each id is read once:
//   (T * 4 + n_valid * D * 4 * 3) / 3.35 TB/s.
// At one kwai-dlrm put (about 700 unique rows of 128) that is about 0.3 us,
// so the launch dominates. The kernel is written to be right first.
//
// C interface (bound with ctypes): launches on `stream`, does not
// synchronise, allocates nothing, and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ void sgd(float& r, float g, float neg_lr) {
  r = __fadd_rn(r, __fmul_rn(neg_lr, g));
}
__device__ __forceinline__ void sgd(float4& r, float4 g, float neg_lr) {
  sgd(r.x, g.x, neg_lr);
  sgd(r.y, g.y, neg_lr);
  sgd(r.z, g.z, neg_lr);
  sgd(r.w, g.w, neg_lr);
}

// T is float or float4; n_vec elements of T per row.
template <typename T>
__global__ void sgd_kernel(T* __restrict__ table, const int* __restrict__ ids,
                           const T* __restrict__ grads, long long V,
                           long long n, int n_vec, float neg_lr) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const long long t = i / n_vec;
  const int c = (int)(i - t * n_vec);
  const int id = __ldg(ids + t);
  if (id < 0 || id >= V) return;
  T* row = table + (long long)id * n_vec + c;
  T r = *row;
  sgd(r, __ldg(grads + t * n_vec + c), neg_lr);
  *row = r;
}

constexpr int kThreads = 256;

}  // namespace

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
  const long long n = (long long)T * n_vec;
  const unsigned blocks = (unsigned)((n + kThreads - 1) / kThreads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec) {
    sgd_kernel<float4><<<blocks, kThreads, 0, s>>>(
        reinterpret_cast<float4*>(table), ids,
        reinterpret_cast<const float4*>(grads), V, n, n_vec, -lr);
  } else {
    sgd_kernel<float><<<blocks, kThreads, 0, s>>>(table, ids, grads, V, n,
                                                  n_vec, -lr);
  }
  return static_cast<int>(cudaGetLastError());
}
