// Sum-pooled embedding bags for Hopper (sm_90a), fp32.
//
//   persia_embedding_bag_f32: out[b] = sum_l table[ids[b, l]]
//   persia_unique_bag_f32:    out[b] = sum_l table[dev[inv[b, l]]]
//
// They replace the Pallas TPU kernels
//   src/repro/kernels/embedding_bag.py  embedding_bag (_bag_kernel)
//   src/repro/kernels/unique_bag.py     unique_bag (_unique_bag_kernel)
// and agree bit for bit with their plain torch versions in ../ref.py.
//
// Design. The TPU kernels walk the B*L occurrences as a sequential grid, one
// row DMA per step, revisiting the bag's output row in VMEM. Here the bags
// run in parallel: a row of threads owns one bag (blockDim.y bags per
// block), strides over D with float4 loads when D % 4 == 0 and the table
// and output are 16-byte aligned (a scalar path otherwise), loads its own
// indices, and adds the L rows in registers in l order. Padding (an index
// < 0) skips the row: a select, not a multiply by zero, so a padded slot
// never turns a non-finite row into NaN. An index past the end of the array
// it indexes reads the array's last entry, as the JAX package's gathers
// clamp. Each bag's output row is stored once. Row offsets are int64, since
// V * D can pass 2^31.
//
// Bound: memory. The least traffic is each distinct row read once, each
// output row written once and each index read once:
//   (distinct_rows * D * 4 + B * D * 4 + index_bytes) / 3.35 TB/s.
// At the serving shape (B=64, L=8, D=128) that is well under a microsecond,
// so the fixed cost of a launch dominates. The kernel is written to be
// right first; it is not tuned.
//
// C interface (bound with ctypes): every function launches on `stream`,
// does not synchronise, allocates nothing, and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ void vzero(float& a) { a = 0.0f; }
__device__ __forceinline__ void vzero(float4& a) {
  a = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
}
__device__ __forceinline__ void vadd(float& a, float b) { a = __fadd_rn(a, b); }
__device__ __forceinline__ void vadd(float4& a, float4 b) {
  a.x = __fadd_rn(a.x, b.x);
  a.y = __fadd_rn(a.y, b.y);
  a.z = __fadd_rn(a.z, b.z);
  a.w = __fadd_rn(a.w, b.w);
}

// An index into an array of n entries: < 0 is padding (-1), past the end
// reads the last entry.
__device__ __forceinline__ long long clamp_index(long long i, long long n) {
  return (i < 0 || n <= 0) ? -1LL : (i < n ? i : n - 1);
}

// Table row of occurrence (b, l), or -1 for padding.
struct BagRows {
  const int* ids;
  long long V;
  int L;
  __device__ __forceinline__ long long operator()(int b, int l) const {
    return clamp_index(__ldg(ids + (long long)b * L + l), V);
  }
};

struct UniqueRows {
  const int* dev;
  const int* inv;
  long long V;
  int U;
  int L;
  __device__ __forceinline__ long long operator()(int b, int l) const {
    const long long u = clamp_index(__ldg(inv + (long long)b * L + l), U);
    return u < 0 ? -1LL : clamp_index(__ldg(dev + u), V);
  }
};

// T is float or float4; n_vec = D / (sizeof(T) / 4) elements of T per row.
template <typename T, typename Rows>
__global__ void bag_kernel(const T* __restrict__ table, T* __restrict__ out,
                           Rows rows, int B, int L, int n_vec) {
  const int b = blockIdx.x * blockDim.y + threadIdx.y;
  if (b >= B) return;
  for (int c = threadIdx.x; c < n_vec; c += blockDim.x) {
    T acc;
    vzero(acc);
    for (int l = 0; l < L; ++l) {
      const long long r = rows(b, l);
      if (r >= 0) vadd(acc, __ldg(table + r * n_vec + c));
    }
    out[(long long)b * n_vec + c] = acc;
  }
}

constexpr int kThreads = 128;

template <typename Rows>
int launch(const float* table, float* out, Rows rows, int B, int L, int D,
           cudaStream_t stream) {
  if (B <= 0 || L < 0 || D <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool vec = (D % 4 == 0) &&
                   (reinterpret_cast<uintptr_t>(table) % 16 == 0) &&
                   (reinterpret_cast<uintptr_t>(out) % 16 == 0);
  const int n_vec = vec ? D / 4 : D;
  int tx = ((n_vec + 31) / 32) * 32;
  if (tx > kThreads) tx = kThreads;
  const int ty = kThreads / tx;
  const dim3 block(tx, ty);
  const dim3 grid((B + ty - 1) / ty);
  if (vec) {
    bag_kernel<float4, Rows><<<grid, block, 0, stream>>>(
        reinterpret_cast<const float4*>(table), reinterpret_cast<float4*>(out),
        rows, B, L, n_vec);
  } else {
    bag_kernel<float, Rows><<<grid, block, 0, stream>>>(table, out, rows, B,
                                                        L, n_vec);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// table (V, D) fp32; ids (B, L) int32, < 0 = padding, >= V reads row V-1;
// out (B, D).
extern "C" int persia_embedding_bag_f32(const float* table, const int* ids,
                                        float* out, long long V, int B, int L,
                                        int D, void* stream) {
  BagRows rows{ids, V, L};
  return launch(table, out, rows, B, L, D,
                static_cast<cudaStream_t>(stream));
}

// table (V, D) fp32; dev (U,) int32 table rows, < 0 = padding, >= V reads
// row V-1; inv (B, L) int32 positions in dev, < 0 = padding, >= U reads
// dev[U-1]; out (B, D).
extern "C" int persia_unique_bag_f32(const float* table, const int* dev,
                                     const int* inv, float* out, long long V,
                                     int U, int B, int L, int D,
                                     void* stream) {
  UniqueRows rows{dev, inv, V, U, L};
  return launch(table, out, rows, B, L, D,
                static_cast<cudaStream_t>(stream));
}
