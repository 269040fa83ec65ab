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
// GPU run in no order, so one call is two launches on the stream:
//
// * Launch 1 (segment_kernel): W = max(n_seg, cap / 8) blocks of 1 + 8
//   warps. Block w sums segment w < n_seg: the dedup plan's occurrence CSR
//   (order, offsets) names its occurrence rows, added in occurrence order
//   from 0.0; entries that are not rows of grads add nothing. The adds of
//   one segment are a serial chain per column, and a Zipf-hot id owns a
//   segment of hundreds of rows (~350 of ~2,300 at the training shape):
//   that segment is launch 1's critical path. Its rows stream through a
//   ring of 128 rows (8 groups of 16) in shared memory: 8 producer warps
//   each keep one group's cp.asyncs in flight, completing on the group's
//   mbarrier, and the consumer warp adds the groups in order and frees
//   each slot on a second mbarrier (one warp that both copied and added,
//   by cp.async or by TMA bulk copies of a row each, was held back by its
//   own issue and waits, whatever the ring's depth). A lane
//   owns 4 columns of a 128-column block: a float4 where D % 4 == 0 and
//   the rows are 16-byte aligned, scalars at stride 32 otherwise; wider
//   rows loop over column blocks. Rows that are not rows of grads, or past
//   the segment, land as zeros and add +0.0, which is the same as skipping
//   them (a sum that starts at +0.0 is never -0.0). No atomics on floats:
//   their order changes from run to run, and the payload is bit-exact.
//   Before its adds the consumer writes its share of the zero payload rows
//   j >= n_seg (no memset) and elects leaders: every live apply position j
//   records itself with atomicMin(first[row], j) and atomicMax(last[row],
//   j), int32 scratch indexed by physical row; min and max do not depend
//   on the order of the atomics, so the election is deterministic.
// * Launch 2 (apply_kernel): one warp per apply position j; it goes on
//   only if first[row] == j. Several positions can name one physical row:
//   the uniform-shuffle placement is not a bijection once id * 1,000,003
//   wraps 2^32 (at 62,500 rows a quarter of the rows are shared by two
//   ids), so two unique ids of one batch may collide. The JAX reference
//   then adds both increments to acc before either step reads it, and adds
//   the row updates in position order. The leader does the same: alone
//   when first == last (the common case), else it walks the members in
//   [first, last] in position order (a ballot scan bounded by that range,
//   not by cap), adds every member's increment, then applies every
//   member's update. No two warps write one row, so no atomics here
//   either. The leader restores first[row] and last[row] to their
//   sentinels (INT_MAX, -1), so the next call finds clean scratch. mean(g^2)
//   adds the squares in column order (each lane loads a slice of the row,
//   the warp walks it in order by shuffle). With apply_self (sync), g is
//   the payload launch 1 wrote. Launch 2 is launch 1's programmatic
//   dependent (PDL): its blocks start while launch 1's last blocks run,
//   load their position's table row, acc and (unless apply_self) gradient,
//   and only then wait for launch 1 (griddepcontrol.wait).
//
// Every float operation is a correctly rounded intrinsic (__fadd_rn,
// __fmul_rn, __fdiv_rn, __fsqrt_rn), so nvcc cannot contract a product
// and a sum into an FMA (the reference rounds the -lr * step product
// before the row add) and the plain version can repeat each operation.
//
// Bound: memory. Each valid occurrence gradient row and its index read
// once, each payload row written once, each applied gradient row read
// once, and each live table row (and its acc) read and written once:
// about 4.4 MB at the training shape (2,311 valid occurrences, 694 live
// positions, cap 4,096, D 128), 1.3 us at 3.35 TB/s (chip_smoke.py counts
// each call's bytes from its inputs; the election scratch, 8 bytes per
// live row, is this design's own traffic and not counted). The call takes
// several times that: the hot segment's serial adds, a launch's cost
// twice, and launch 2's dependent loads (PERF.md).
//
// Shared memory: launch 1 holds the ring, 128 x 128 floats and 16
// mbarriers (65,664 bytes) per block, opted in once per instantiation
// (three blocks per SM); launch 2 none.
//
// C interface (bound with ctypes): launches on `stream`, does not
// synchronise, allocates nothing (the caller owns the scratch, filled with
// its sentinels once), returns cudaGetLastError().

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kRing = 128;      // rows in flight per segment block
constexpr int kGroup = 16;      // rows per group
constexpr int kGroups = kRing / kGroup;    // and producer warps
constexpr int kCols = 128;      // columns per block of a row
constexpr int kWarps = 4;       // warps (positions) per apply block
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

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar)) : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(smem_addr(bar)), "r"(parity) : "memory");
  }
}
// cp.async of `bytes` (16, or 0: the 16 bytes at dst become zeros) and of
// 4 bytes (or 0)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)), "l"(src), "r"(bytes) : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)), "l"(src), "r"(bytes) : "memory");
}
// `bar` receives one arrival once this thread's cp.asyncs have landed
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::
                   "r"(smem_addr(bar)) : "memory");
}

// A block's ring: kGroups groups of kGroup rows of kCols floats; `full`
// completes when a group's copies landed (32 producer lanes), `empty` when
// the consumer has read it (32 consumer lanes).
struct Ring {
  float rows[kRing][kCols];
  uint64_t full[kGroups];
  uint64_t empty[kGroups];
};

// A producer warp p: the rows of segment [lo, hi) of grads, columns [cb,
// cb + 128) of each, into the ring in occurrence order. Group i of a column
// block is rows [16 i, 16 i + 16); the block's groups follow those of the
// blocks before it in one sequence, and group g takes slot g % kGroups,
// which producer warp g % kGroups fills once the consumer has released the
// slot's previous group, so kGroups warps keep copies in flight at once.
// A row that is not a row of grads, a row past the segment and columns
// past D land as zeros: the sum, which starts at +0.0 and so is never
// -0.0, adds +0.0 for them, which changes nothing. VEC: lane copies
// columns cb + 4 lane .. + 3 (16 bytes); else cb + lane + 32 i (4 bytes
// each).
template <bool VEC>
__device__ __forceinline__ void produce(const float* __restrict__ grads,
                                        const int* __restrict__ order,
                                        Ring& ring, int lo, int hi, int n_occ,
                                        int D, int p, int lane) {
  const int n = hi - lo, ng = (n + kGroup - 1) / kGroup;
  // lane u < 16 holds the index of row 16 i + u of its group
  auto index_at = [&](int i) {
    const int r = kGroup * i + (lane & (kGroup - 1));
    return r < n ? __ldg(order + lo + r) : -1;
  };
  int gbase = 0;
  for (int cb = 0; cb < D; cb += kCols, gbase += ng) {
    int i = (p - gbase % kGroups + kGroups) % kGroups;
    int nxt = i < ng ? index_at(i) : -1;
    for (; i < ng; i += kGroups) {
      const int g = gbase + i;
      const int src_mine = nxt;
      if (i + kGroups < ng) nxt = index_at(i + kGroups);
      if (g >= kGroups) mbar_wait(&ring.empty[p], (g / kGroups - 1) & 1);
      float* slots = ring.rows[p * kGroup];
#pragma unroll
      for (int u = 0; u < kGroup; ++u) {
        const int src = __shfl_sync(kFull, src_mine, u);
        const bool ok = kGroup * i + u < n && src >= 0 && src < n_occ;
        const float* row = grads + (ok ? (long long)src * D : 0);
        if (VEC) {
          const int c = cb + 4 * lane;
          cp_async16(slots + u * kCols + 4 * lane,
                     ok && c < D ? row + c : grads, ok && c < D ? 16 : 0);
        } else {
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const int c = cb + lane + 32 * k;
            cp_async4(slots + u * kCols + lane + 32 * k,
                      ok && c < D ? row + c : grads, ok && c < D ? 4 : 0);
          }
        }
      }
      cp_async_arrive(&ring.full[p]);
    }
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// The consumer warp: segment j's sums, column block after column block,
// adding the ring's rows in order (lane owns 4 columns: VEC cb + 4 lane +
// i, else cb + lane + 32 i), one group per wait.
template <bool VEC>
__device__ __forceinline__ void consume(float* __restrict__ push, Ring& ring,
                                        int j, int n, int D, int lane) {
  int g = 0;
  for (int cb = 0; cb < D; cb += kCols) {
    float a[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    for (int g0 = 0; g0 < n; g0 += kGroup, ++g) {
      const int s = g % kGroups;
      mbar_wait(&ring.full[s], (g / kGroups) & 1);
      const float* slots = ring.rows[s * kGroup];
#pragma unroll
      for (int u = 0; u < kGroup; ++u) {
        const float* row = slots + u * kCols;
        if (VEC) {
          const float4 x = *reinterpret_cast<const float4*>(row + 4 * lane);
          a[0] = __fadd_rn(a[0], x.x);
          a[1] = __fadd_rn(a[1], x.y);
          a[2] = __fadd_rn(a[2], x.z);
          a[3] = __fadd_rn(a[3], x.w);
        } else {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            a[i] = __fadd_rn(a[i], row[lane + 32 * i]);
          }
        }
      }
      mbar_arrive(&ring.empty[s]);
    }
    float* out = push + (long long)j * D;
    if (VEC) {
      const int c = cb + 4 * lane;
      if (c < D) {
        *reinterpret_cast<float4*>(out + c) = make_float4(a[0], a[1], a[2],
                                                          a[3]);
      }
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int c = cb + lane + 32 * i;
        if (c < D) out[c] = a[i];
      }
    }
  }
}

// Launch 1: W blocks of 1 + kGroups warps. Block w: the consumer warp sums
// segment w (if w < n_seg) from the ring its producer warps fill; before it
// writes zero payload rows n_seg + w + k W and elects leaders for
// positions [w P, (w + 1) P), P = ceil(cap / W) <= 8.
template <bool VEC>
__global__ void __launch_bounds__(32 * (1 + kGroups))
segment_kernel(const float* __restrict__ grads, const int* __restrict__ order,
               const int* __restrict__ offsets,
               const int* __restrict__ apply_idx, float* __restrict__ push,
               int* __restrict__ first, int* __restrict__ last, long long R,
               int n_occ, int n_order, int n_seg, int cap, int D) {
  // launch 2 may begin once every block of this grid has started
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  extern __shared__ float4 smem4[];
  Ring& ring = *reinterpret_cast<Ring*>(smem4);
  const int lane = threadIdx.x & 31, w = blockIdx.x, W = gridDim.x;
  const bool producer = threadIdx.x >= 32;
  if (w < n_seg && threadIdx.x == 0) {
    for (int g = 0; g < kGroups; ++g) {
      mbar_init(&ring.full[g], 32);
      mbar_init(&ring.empty[g], 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  int lo = 0, hi = 0;
  if (w < n_seg) {
    lo = min(max(__ldg(offsets + w), 0), n_order);
    hi = max(min(max(__ldg(offsets + w + 1), 0), n_order), lo);
  }
  if (producer) {
    produce<VEC>(grads, order, ring, lo, hi, n_occ, D, threadIdx.x / 32 - 1,
                 lane);
    return;
  }

  const int P = (cap + W - 1) / W;
  const int jp = w * P + lane;
  if (lane < P && jp < cap) {
    const int row = __ldg(apply_idx + jp);
    if (row >= 0 && row < R) {
      atomicMin(first + row, jp);
      atomicMax(last + row, jp);
    }
  }
  for (int j = n_seg + w; j < cap; j += W) {
    float* out = push + (long long)j * D;
    if (VEC) {
      for (int c = lane; c < D / 4; c += 32) {
        reinterpret_cast<float4*>(out)[c] = make_float4(0.f, 0.f, 0.f, 0.f);
      }
    } else {
      for (int c = lane; c < D; c += 32) out[c] = 0.0f;
    }
  }
  if (w < n_seg) consume<VEC>(push, ring, w, hi - lo, D, lane);
}

// The first position i in [from, end) with idx[i] == row, or end: a
// warp-wide ballot scan. Every lane of the warp must call it with the same
// arguments.
__device__ __forceinline__ int next_member(const int* __restrict__ idx,
                                           int from, int end, int row,
                                           int lane) {
  for (int base = from; base < end; base += 32) {
    const int i = base + lane;
    const unsigned m = __ballot_sync(kFull, i < end && __ldg(idx + i) == row);
    if (m) return base + __ffs(m) - 1;
  }
  return end;
}

template <typename T>
__global__ void apply_kernel(T* __restrict__ table, float* __restrict__ acc,
                             const int* __restrict__ apply_idx,
                             const T* __restrict__ g_src,
                             int* __restrict__ first, int* __restrict__ last,
                             long long R, int cap, int D, int n_vec,
                             float lr, float eps, int apply_self) {
  const int lane = threadIdx.x;
  const int j = blockIdx.x * blockDim.y + threadIdx.y;
  if (j >= cap) return;
  // launched as launch 1's programmatic dependent: until the wait below,
  // read only what was written before launch 1 began
  const int row = __ldg(apply_idx + j);
  if (row < 0 || row >= R) return;
  const bool adagrad = acc != nullptr;
  const float nlr = -lr;
  T* t_row = table + (long long)row * n_vec;
  // this position's gradient, its row and acc, loaded while launch 1 runs
  // (discarded unless this position leads); apply_self's gradient is
  // launch 1's payload
  T g_mine, t_mine;
  vzero(g_mine);
  vzero(t_mine);
  const T* g_j = g_src + (long long)j * n_vec;
  if (lane < n_vec) {
    if (!apply_self) g_mine = __ldg(g_j + lane);
    t_mine = t_row[lane];
  }
  const float a_row = adagrad ? acc[row] : 0.0f;
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  if (apply_self && lane < n_vec) g_mine = __ldg(g_j + lane);
  // only the first position of a row goes on; it applies all of them
  if (first[row] != j) return;
  const int end = last[row] + 1;
  __syncwarp();
  if (lane == 0) {
    first[row] = INT_MAX;
    last[row] = -1;
  }
  if (end == j + 1 && n_vec <= 32) {
    // a row of its own (the common case), one element (vector) per lane
    float r = 1.0f;
    if (adagrad) {
      float s = 0.0f;
      if (n_vec == 32) {          // D 128 on the vector path: unrolled
#pragma unroll
        for (int u = 0; u < 32; ++u) s = add_sq(s, shfl(g_mine, u));
      } else {
        for (int u = 0; u < n_vec; ++u) s = add_sq(s, shfl(g_mine, u));
      }
      const float a = __fadd_rn(a_row, __fdiv_rn(s, static_cast<float>(D)));
      if (lane == 0) acc[row] = a;
      r = __fdiv_rn(1.0f, __fsqrt_rn(__fadd_rn(a, eps)));
    }
    if (lane < n_vec) t_row[lane] = step(t_mine, g_mine, nlr, r, adagrad);
    return;
  }
  float r = 1.0f;
  if (adagrad) {
    // every lane computes the same sums (the squares reach all lanes by
    // shuffle); lane 0 stores
    float a = a_row;
    for (int i = j; i < end; i = next_member(apply_idx, i + 1, end, row,
                                             lane)) {
      const float s = sum_sq(g_src + (long long)i * n_vec, n_vec, lane);
      a = __fadd_rn(a, __fdiv_rn(s, static_cast<float>(D)));
    }
    if (lane == 0) acc[row] = a;
    r = __fdiv_rn(1.0f, __fsqrt_rn(__fadd_rn(a, eps)));
  }
  for (int i = j; i < end; i = next_member(apply_idx, i + 1, end, row,
                                           lane)) {
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
           float* push, int* first, int* last, long long R, int n_occ,
           int n_order, int n_seg, int cap, int D, float lr, float eps,
           int apply_self, cudaStream_t stream) {
  constexpr bool kVec = sizeof(T) == sizeof(float4);
  // opt in to the ring's shared memory once per instantiation, outside any
  // graph capture
  static bool opted_in = false;
  if (!opted_in) {
    const cudaError_t err = cudaFuncSetAttribute(
        segment_kernel<kVec>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(sizeof(Ring)));
    if (err != cudaSuccess) return static_cast<int>(err);
    opted_in = true;
  }
  const int W = max(n_seg, (cap + 7) / 8);
  segment_kernel<kVec><<<W, 32 * (1 + kGroups), sizeof(Ring),
                         stream>>>(
      grads, order, offsets, apply_idx, push, first, last, R, n_occ, n_order,
      n_seg, cap, D);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  // launch 2 may start while launch 1 still runs (programmatic dependent
  // launch): its blocks load what they can, then wait for launch 1
  const float* g_src = apply_self ? push : apply_g;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((cap + kWarps - 1) / kWarps);
  cfg.blockDim = dim3(32, kWarps);
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err2 = cudaLaunchKernelEx(
      &cfg, apply_kernel<T>, reinterpret_cast<T*>(table), acc, apply_idx,
      reinterpret_cast<const T*>(g_src), first, last, R, cap, D,
      kVec ? D / 4 : D, lr, eps, apply_self);
  if (err2 != cudaSuccess) return static_cast<int>(err2);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// table (R, D) fp32, updated in place; acc (R,) fp32 in place, or null for
// sgd; order (n_order,) int32 occurrence rows of grads; offsets (n_seg + 1,)
// int32; grads (n_occ, D) fp32; apply_idx (cap,) int32, < 0 or >= R = no-op;
// apply_g (cap, D) fp32, or null with apply_self; push (cap, D) fp32 out;
// first and last (R,) int32 scratch holding INT_MAX and -1 on entry, and
// again on return.
extern "C" int persia_fused_backward_f32(
    float* table, float* acc, const int* order, const int* offsets,
    const float* grads, const int* apply_idx, const float* apply_g,
    float* push, int* first, int* last, long long R, int n_occ, int n_order,
    int n_seg, int cap, int D, float lr, float eps, int apply_self,
    void* stream) {
  if (cap <= 0 || D <= 0 || R < 0 || n_occ < 0 || n_order < 0 ||
      (!apply_self && apply_g == nullptr) ||
      (R > 0 && (first == nullptr || last == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  n_seg = max(min(n_seg, cap), 0);
  const bool vec = D % 4 == 0 && aligned16(table) && aligned16(grads) &&
                   aligned16(push) && (apply_self || aligned16(apply_g));
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec) {
    return launch<float4>(table, acc, order, offsets, grads, apply_idx,
                          apply_g, push, first, last, R, n_occ, n_order,
                          n_seg, cap, D, lr, eps, apply_self, s);
  }
  return launch<float>(table, acc, order, offsets, grads, apply_idx, apply_g,
                       push, first, last, R, n_occ, n_order, n_seg, cap, D,
                       lr, eps, apply_self, s);
}
