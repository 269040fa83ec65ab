// Sum-pooled embedding bags for Hopper (sm_90a), fp32: one kernel serves
// both TPU bag kernels.
//
//   persia_unique_bag_grouped_f32: for every table t of a group, in one
//                                  launch: out_t[b] = sum_l
//                                  table_t[dev_t[inv_t[b, l]]]
//   persia_unique_bag_f32:         its one-table case
//
// With the identity for dev (U = -1, no dev array) a table's pool is
//   out[b] = sum_l table[ids[b, l]],
// the occurrence-width bag. So the one kernel replaces both Pallas TPU
// kernels
//   src/repro/kernels/embedding_bag.py  embedding_bag (_bag_kernel)
//   src/repro/kernels/unique_bag.py     unique_bag (_unique_bag_kernel)
// and agrees bit for bit with both plain torch versions in ../ref.py
// (embedding_bag_ref, unique_bag_ref). One launch may mix tables of the
// two kinds: every bag read of a stage, plan tables and occurrence-width
// tables alike, is one launch.
//
// The TPU kernels walk the B*L occurrences as a sequential grid, one row
// DMA per step, revisiting the bag's output row in VMEM. Here the bags run
// in parallel and each adds its L rows in registers in l order, from zero,
// with __fadd_rn: the fixed sum order is what keeps the result bit-exact.
// Padding (an index < 0) skips the row: a select, not a multiply by zero,
// so a padded slot never turns a non-finite row into NaN. An index past
// the end of the array it indexes reads the array's last entry, as the JAX
// package's gathers clamp. float4 loads when D % 4 == 0 and the table and
// output are 16-byte aligned, a scalar path otherwise. Row offsets are
// int64, since V * D can pass 2^31.
//
// At the main path's shapes a table's call moves well under 1 MB, so its
// time is the launch plus the chain of dependent loads inv -> dev -> row,
// not the bytes; one launch per table made a 32-table stage 32 launches in
// a row. So one launch serves every table of a stage:
// * Each table has a descriptor {table, dev, inv, out, V, U, B, L, D, vec},
//   passed by value in a __grid_constant__ kernel parameter (no pointer
//   table to copy to the device, no synchronisation), with the first CTA
//   of each table beside them. The parameter stays under the 4 KB classic
//   limit, so a launch takes up to kMaxTables tables and the host launches
//   once per chunk of that many.
// * One flat grid covers every table's bags, kBagWarps bags per CTA; a CTA
//   finds its table by a binary search of the first-CTA prefix, a read that
//   is uniform across the CTA (a broadcast from parameter space).
// * One warp per bag: lanes < L load the bag's inv entries together, then
//   their dev entries, and __shfl_sync spreads the rows across the warp,
//   so the chain is three round trips per bag (two for the identity), not
//   per occurrence. The L row loads are issued eight at a time, unrolled,
//   all in flight before the adds, which then run in l order. At D = 128
//   the 32 lanes' float4 loads cover a 512-byte row in one coalesced
//   access.
//
// Bound: memory. The least traffic is each distinct row read once, each
// output row written once and each index read once:
//   (distinct_rows * D * 4 + B * D * 4 + index_bytes) / 3.35 TB/s.
// At the serving shape (B=64, L=8, D=128) that is 0.05 us a table, so even
// a 32-table launch (512 CTAs, one wave on 132 SMs) is dominated by the
// launch and the dependent-load chain.
//
// C interface (bound with ctypes): every function launches on `stream`,
// does not synchronise, allocates nothing, and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;

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

bool aligned(const void* p, uintptr_t to) {
  return reinterpret_cast<uintptr_t>(p) % to == 0;
}

// ---------------------------------------------------------------------------
// the grouped bag kernel: one launch per chunk of tables
// ---------------------------------------------------------------------------

constexpr int kBagWarps = 4;       // bags (warps) per CTA
constexpr int kRowsInFlight = 8;   // row loads issued before their adds
constexpr int kMaxTables = 56;     // tables per launch (parameter < 4 KB)

struct UniqueBagTable {
  const float* table;   // (V, D)
  const int* dev;       // (U,); not read for the identity
  const int* inv;       // (B, L)
  float* out;           // (B, D)
  long long V;
  int U, B, L, D;       // U = -1: the identity (inv holds table rows)
  int vec;              // float4 path
};

struct UniqueBagGroup {
  int n;                          // tables in this launch, each B, D > 0
  int first[kMaxTables + 1];      // first CTA of each table; first[n] = grid
  UniqueBagTable t[kMaxTables];
};
static_assert(sizeof(UniqueBagGroup) <= 4000,
              "the grouped unique_bag parameter must stay under 4 KB");

// The index of the table whose CTAs hold `cta`: the last t with
// first[t] <= cta (every table has at least one CTA).
__device__ __forceinline__ int table_of(const int* first, int n, int cta) {
  int lo = 0, hi = n - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (first[mid] <= cta) {
      lo = mid;
    } else {
      hi = mid - 1;
    }
  }
  return lo;
}

// Bag b of table t, one warp; T is float4 (vec) or float.
template <typename T>
__device__ __forceinline__ void unique_bag_warp(const UniqueBagTable& t,
                                                int b, int lane) {
  const T* __restrict__ table = reinterpret_cast<const T*>(t.table);
  T* __restrict__ out = reinterpret_cast<T*>(t.out);
  const int n_vec = t.D / static_cast<int>(sizeof(T) / 4);
  const int* __restrict__ inv = t.inv + static_cast<long long>(b) * t.L;
  for (int c0 = 0; c0 < n_vec; c0 += 32) {
    const int c = c0 + lane;
    const bool live = c < n_vec;
    T acc;
    vzero(acc);
    for (int l0 = 0; l0 < t.L; l0 += 32) {
      // lanes < m fetch the chain of occurrences l0 .. l0 + m: inv, dev
      const int m = min(32, t.L - l0);
      long long r = -1;
      if (lane < m) {
        const long long i = __ldg(inv + l0 + lane);
        if (t.U < 0) {
          r = clamp_index(i, t.V);   // the identity: the index is the row
        } else {
          const long long u = clamp_index(i, t.U);
          if (u >= 0) r = clamp_index(__ldg(t.dev + u), t.V);
        }
      }
      for (int j0 = 0; j0 < m; j0 += kRowsInFlight) {
        T v[kRowsInFlight];
        long long rj[kRowsInFlight];
#pragma unroll
        for (int j = 0; j < kRowsInFlight; ++j) {
          rj[j] = __shfl_sync(kFull, r, (j0 + j) & 31);
          if (j0 + j >= m) rj[j] = -1;
          if (live && rj[j] >= 0) v[j] = __ldg(table + rj[j] * n_vec + c);
        }
#pragma unroll
        for (int j = 0; j < kRowsInFlight; ++j) {
          if (live && rj[j] >= 0) vadd(acc, v[j]);
        }
      }
    }
    if (live) out[static_cast<long long>(b) * n_vec + c] = acc;
  }
}

__global__ void __launch_bounds__(kBagWarps * 32)
    unique_bag_grouped_kernel(const __grid_constant__ UniqueBagGroup g) {
  const int cta = static_cast<int>(blockIdx.x);
  const int k = table_of(g.first, g.n, cta);
  const UniqueBagTable& t = g.t[k];
  const int b = (cta - g.first[k]) * kBagWarps + (threadIdx.x >> 5);
  if (b >= t.B) return;
  if (t.vec) {
    unique_bag_warp<float4>(t, b, threadIdx.x & 31);
  } else {
    unique_bag_warp<float>(t, b, threadIdx.x & 31);
  }
}

// One row of the host descriptor array (int64 each):
//   table, dev, inv, out, V, U (-1: the identity), B, L, D
constexpr int kBagDescWords = 9;

int launch_group(UniqueBagGroup& g, int& ctas, int* launches,
                 cudaStream_t stream) {
  g.first[g.n] = ctas;
  unique_bag_grouped_kernel<<<ctas, kBagWarps * 32, 0, stream>>>(g);
  const int err = static_cast<int>(cudaGetLastError());
  if (err == 0 && launches != nullptr) ++*launches;
  g.n = 0;
  ctas = 0;
  return err;
}

int unique_bag_grouped(const long long* desc, int n, int* launches,
                       cudaStream_t stream) {
  if (launches != nullptr) *launches = 0;
  if (n < 0 || (n > 0 && desc == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  UniqueBagGroup g;
  g.n = 0;
  int ctas = 0;
  for (int i = 0; i < n; ++i) {
    const long long* d = desc + static_cast<long long>(i) * kBagDescWords;
    const long long V = d[4], U = d[5], B = d[6], L = d[7], D = d[8];
    if (V < 0 || U < -1 || B < 0 || L < 0 || D < 0 || U > INT_MAX ||
        B > INT_MAX || L > INT_MAX || D > INT_MAX) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    if (B == 0 || D == 0) continue;    // nothing to write
    UniqueBagTable t;
    t.table = reinterpret_cast<const float*>(d[0]);
    t.dev = reinterpret_cast<const int*>(d[1]);
    t.inv = reinterpret_cast<const int*>(d[2]);
    t.out = reinterpret_cast<float*>(d[3]);
    t.V = V;
    t.U = static_cast<int>(U);
    t.B = static_cast<int>(B);
    t.L = static_cast<int>(L);
    t.D = static_cast<int>(D);
    t.vec = D % 4 == 0 && aligned(t.table, 16) && aligned(t.out, 16);
    const long long need = (B + kBagWarps - 1) / kBagWarps;
    if (g.n > 0 && ctas + need > INT_MAX) {
      const int err = launch_group(g, ctas, launches, stream);
      if (err != 0) return err;
    }
    g.first[g.n] = ctas;
    g.t[g.n++] = t;
    ctas += static_cast<int>(need);
    if (g.n == kMaxTables) {
      const int err = launch_group(g, ctas, launches, stream);
      if (err != 0) return err;
    }
  }
  return g.n > 0 ? launch_group(g, ctas, launches, stream)
                 : static_cast<int>(cudaSuccess);
}

}  // namespace

// desc: n rows of 9 int64 {table, dev, inv, out, V, U, B, L, D}, in host
// memory, one per table: table (V, D) fp32; dev (U,) int32 table rows (< 0
// = padding, >= V reads row V-1); inv (B, L) int32 positions in dev (< 0 =
// padding, >= U reads dev[U-1]); out (B, D). U = -1 is the identity: dev
// is not read and inv holds table rows (the occurrence-width bag). Tables
// with B = 0 or D = 0 are skipped. Launches once per kMaxTables non-empty
// tables and stores the number of launches in *launches.
extern "C" int persia_unique_bag_grouped_f32(const long long* desc, int n,
                                             int* launches, void* stream) {
  return unique_bag_grouped(desc, n, launches,
                            static_cast<cudaStream_t>(stream));
}

// The one-table case: table (V, D) fp32; dev (U,) int32 (U = -1: the
// identity, dev not read); inv (B, L) int32; out (B, D).
extern "C" int persia_unique_bag_f32(const float* table, const int* dev,
                                     const int* inv, float* out, long long V,
                                     int U, int B, int L, int D,
                                     void* stream) {
  if (B <= 0 || L < 0 || D <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long desc[kBagDescWords] = {
      static_cast<long long>(reinterpret_cast<uintptr_t>(table)),
      static_cast<long long>(reinterpret_cast<uintptr_t>(dev)),
      static_cast<long long>(reinterpret_cast<uintptr_t>(inv)),
      static_cast<long long>(reinterpret_cast<uintptr_t>(out)),
      V, U, B, L, D};
  return unique_bag_grouped(desc, 1, nullptr,
                            static_cast<cudaStream_t>(stream));
}
