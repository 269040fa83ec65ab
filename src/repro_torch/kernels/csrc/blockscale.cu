// Blockscale fp16 wire codec for Hopper (sm_90a): Persia's §4.2.3 lossy
// value compression of the get and put payloads.
//
//   persia_blockscale_compress_grouped_f32: for every table of a group, in
//   one launch: the flat fp32 input v (n elements) cut into blocks of
//   `block` (the last block reads zeros past n); per block k
//     scale[k] = 32768 / max(max|v_k|, 1e-30)     (NaN if v_k holds a NaN)
//     comp[k * block + i] = fp16_rn(v[k * block + i] * scale[k])
//   persia_blockscale_compress_f32: its one-table case
//   persia_blockscale_decompress_grouped_f32: for every table of a group,
//   in one launch,
//     out[i] = float(comp[i]) / scale[i / block]   for i < n
//   persia_blockscale_decompress_f32: its one-table case
//
// They replace the Pallas TPU kernels
//   src/repro/kernels/blockscale.py  compress (_compress_kernel)
//   src/repro/kernels/blockscale.py  decompress (_decompress_kernel)
// and agree bit for bit with their plain torch versions in ../ref.py
// (blockscale_compress_ref, blockscale_decompress_ref).
//
// Design. The TPU kernels stage (256, 128) tiles through VMEM: one block is
// one vreg row and its max a lane reduction, so the Pallas wrapper pads the
// input to 256 blocks of 128. Here `block` and n are run-time values and
// nothing is padded in memory. A wire get or put crosses every table of a
// stage at once (32 for kwai-dlrm), and one table's call moves well under
// 1 MB, so a launch per table costs its fixed launch time 32 times in a
// row. So both kernels are grouped: one launch serves every table of a
// stage.
//
// * Each table has a descriptor, passed by value in a __grid_constant__
//   kernel parameter (no pointer table to copy to the device, no
//   synchronisation), with the first CTA of each table beside them. At 40
//   bytes a table the parameter stays under the 4 KB classic limit with
//   kMaxCodecTables tables; the host launches once per chunk of that many.
// * One flat grid covers every table; a CTA finds its table by a binary
//   search of the first-CTA prefix, a read that is uniform across the CTA
//   (a broadcast from parameter space).
// * The work per thread is chosen per launch from the launch's total work:
//   one unit while the launch does not fill a wave of kWaveCtas CTAs (one
//   table alone still spreads over the SMs), up to four for a whole stage,
//   so that several wide loads are in flight per thread.
// * The scalar path (block or n not a multiple of 4, or a misaligned
//   pointer) is chosen per table.
//
// * Compress: one warp per 128-value block (the wire's block), up to
//   kCompressBlocks consecutive blocks per warp. Each lane loads a float4
//   (a float on the scalar path) of every one of its warp's blocks before
//   any reduction, then takes each block's max|v| by a __shfl_xor_sync
//   butterfly of fmaxf, exact in any order since a max is never rounded,
//   and stores the block from the registers that loaded it. fmaxf drops NaN
//   where torch's amax keeps it, so a NaN is tracked apart and makes the
//   scale NaN. A block longer than one load per lane (block > 128 on the
//   float4 path, > 32 on the scalar path) is read twice, the second time
//   from L1.
// * Decompress: each thread loads its groups of four halves (uint2) and
//   their scales before it divides and stores them as float4; each
//   table's output goes straight into the caller's buffer.
// * Every float operation is one correctly rounded intrinsic: the scale by
//   __fdiv_rn, the product by __fmul_rn, the fp16 cast by __float2half_rn
//   (round to nearest even, fp16 subnormals kept), and the decompression by
//   __fdiv_rn, a true division and never a multiply by 1/s. Built without
//   fast-math or flush-to-zero, fp32 subnormals are kept too (XLA on the
//   CPU flushes them; the plain version, like this kernel, does not).
//   Grouping changes no bit: each block's max and each element's product
//   are what the one-table launch computes.
//
// Bound: memory. Compress reads 4 bytes and writes 2 per element plus 4 per
// block; decompress the reverse. At the training shape (one table's
// unique rows, 1,024 to 4,096 rows of 128) that is 0.8 to 3.2 MB, under a
// microsecond at 3.35 TB/s; the 32 tables of a stage (about 25 MB) bound
// either kernel at about 7.6 us, where it is bandwidth-bound: hence the
// wide loads and several of them in flight per thread.
//
// C interface (bound with ctypes): every function launches on `stream`,
// does not synchronise, allocates nothing, and returns cudaGetLastError().

#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;   // threads per thread block (both kernels)
constexpr int kWarps = kThreads / 32;
constexpr float kKappa = 32768.0f;
constexpr int kWaveCtas = 132 * 8;   // H100: 132 SMs x 8 CTAs of 256
constexpr int kMaxCodecTables = 80;  // tables per launch (parameter < 4 KB)

bool aligned(const void* p, uintptr_t to) {
  return reinterpret_cast<uintptr_t>(p) % to == 0;
}

// The index of the table whose CTAs hold `cta`: the last t with
// first[t] <= cta (every table of a group has at least one CTA).
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

// Units of work per thread for a launch of `work` units, `per_cta` units
// per CTA at one unit per thread: one until the launch fills a wave of
// kWaveCtas CTAs, then up to `most`.
int per_thread(long long work, long long per_cta, int most) {
  const long long wave = per_cta * kWaveCtas;
  return static_cast<int>(std::min<long long>(
      std::max<long long>((work + wave - 1) / wave, 1), most));
}

// ---------------------------------------------------------------------------
// compress: one launch per chunk of tables
// ---------------------------------------------------------------------------

constexpr int kCompressBlocks = 4;   // codec blocks per warp, at most

struct CompressTable {
  const float* v;          // (n,)
  unsigned short* comp;    // (ceil(n / block) * block,) fp16 bits
  float* scale;            // (ceil(n / block),)
  long long n;
  int block;
  int vec;                 // float4 path
};

struct CompressGroup {
  int n;
  int blocks;                       // codec blocks per warp, 1..4
  int first[kMaxCodecTables + 1];   // first CTA of each table; [n] = grid
  CompressTable t[kMaxCodecTables];
};
static_assert(sizeof(CompressGroup) <= 4000,
              "the grouped compress parameter must stay under 4 KB");

// W consecutive elements of v from e (zeros past n). With W == 4 the
// caller guarantees e % 4 == 0, n % 4 == 0 and a 16-byte aligned v.
template <int W>
__device__ __forceinline__ void load(const float* __restrict__ v,
                                     long long e, long long n, float* x) {
  if constexpr (W == 4) {
    if (e < n) {
      const float4 t = __ldg(reinterpret_cast<const float4*>(v + e));
      x[0] = t.x;
      x[1] = t.y;
      x[2] = t.z;
      x[3] = t.w;
    } else {
      x[0] = x[1] = x[2] = x[3] = 0.0f;
    }
  } else {
    x[0] = e < n ? __ldg(v + e) : 0.0f;
  }
}

__device__ __forceinline__ unsigned short to_half(float x, float s) {
  return __half_as_ushort(__float2half_rn(__fmul_rn(x, s)));
}

// fp16(x * s) of W elements stored from e (comp 8-byte aligned when W == 4).
template <int W>
__device__ __forceinline__ void store(unsigned short* __restrict__ comp,
                                      long long e, const float* x, float s) {
  if constexpr (W == 4) {
    uint2 p;
    p.x = static_cast<unsigned>(to_half(x[0], s)) |
          (static_cast<unsigned>(to_half(x[1], s)) << 16);
    p.y = static_cast<unsigned>(to_half(x[2], s)) |
          (static_cast<unsigned>(to_half(x[3], s)) << 16);
    *reinterpret_cast<uint2*>(comp + e) = p;
  } else {
    comp[e] = to_half(x[0], s);
  }
}

// Folds W values into a lane's running max|v| and NaN flag.
template <int W>
__device__ __forceinline__ void fold(const float* x, float& m, bool& nan) {
#pragma unroll
  for (int j = 0; j < W; ++j) {
    m = fmaxf(m, fabsf(x[j]));
    nan |= isnan(x[j]);
  }
}

// The block's scale from every lane's max|v| and NaN flag (warp-wide).
__device__ __forceinline__ float block_scale(float m, bool nan) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(kFull, m, o));
  nan = __any_sync(kFull, nan);
  return nan ? __int_as_float(0x7fffffff)
             : __fdiv_rn(kKappa, fmaxf(m, 1e-30f));
}

// Blocks k0 .. k0 + count - 1 of table t (count >= 1, all < n_blocks),
// one warp; a lane loads W values at once (4: a float4, 1: a float).
template <int W>
__device__ __forceinline__ void compress_warp(const CompressTable& t,
                                              long long k0, int count,
                                              int lane) {
  const int block = t.block;
  const int i0 = lane * W;
  if (block <= 32 * W) {
    // one load per lane covers a block: every block's loads in flight
    // before the first reduction, and the stores from the same registers
    float x[kCompressBlocks][W];
#pragma unroll
    for (int j = 0; j < kCompressBlocks; ++j) {
      if (j < count && i0 < block) {
        load<W>(t.v, (k0 + j) * block + i0, t.n, x[j]);
      } else {
#pragma unroll
        for (int i = 0; i < W; ++i) x[j][i] = 0.0f;
      }
    }
#pragma unroll
    for (int j = 0; j < kCompressBlocks; ++j) {
      if (j >= count) break;   // uniform across the warp
      float m = 0.0f;
      bool nan = false;
      fold<W>(x[j], m, nan);
      const float s = block_scale(m, nan);
      if (lane == 0) t.scale[k0 + j] = s;
      if (i0 < block) store<W>(t.comp, (k0 + j) * block + i0, x[j], s);
    }
    return;
  }
  for (int j = 0; j < count; ++j) {
    const long long base = (k0 + j) * block;
    float x[W];
    float m = 0.0f;
    bool nan = false;
    for (int i = i0; i < block; i += 32 * W) {
      load<W>(t.v, base + i, t.n, x);
      fold<W>(x, m, nan);
    }
    const float s = block_scale(m, nan);
    if (lane == 0) t.scale[k0 + j] = s;
    for (int i = i0; i < block; i += 32 * W) {
      load<W>(t.v, base + i, t.n, x);
      store<W>(t.comp, base + i, x, s);
    }
  }
}

__global__ void __launch_bounds__(kThreads)
    compress_grouped_kernel(const __grid_constant__ CompressGroup g) {
  const int cta = static_cast<int>(blockIdx.x);
  const int k = table_of(g.first, g.n, cta);
  const CompressTable& t = g.t[k];
  const long long n_blocks = (t.n + t.block - 1) / t.block;
  const long long k0 =
      (static_cast<long long>(cta - g.first[k]) * kWarps + (threadIdx.x >> 5))
      * g.blocks;
  if (k0 >= n_blocks) return;   // a whole warp leaves together
  const int count = n_blocks - k0 < g.blocks
                        ? static_cast<int>(n_blocks - k0) : g.blocks;
  if (t.vec) {
    compress_warp<4>(t, k0, count, threadIdx.x & 31);
  } else {
    compress_warp<1>(t, k0, count, threadIdx.x & 31);
  }
}

// One row of the host descriptor array (int64 each): v, comp, scale, n,
// block
constexpr int kCompDescWords = 5;

// Lays out the group's grid (blocks per warp, first CTAs), launches it and
// empties the group.
int launch_compress(CompressGroup& g, int* launches, cudaStream_t stream) {
  long long work = 0;   // codec blocks
  for (int i = 0; i < g.n; ++i) {
    work += (g.t[i].n + g.t[i].block - 1) / g.t[i].block;
  }
  g.blocks = per_thread(work, kWarps, kCompressBlocks);
  const long long span = static_cast<long long>(kWarps) * g.blocks;
  long long ctas = 0;
  for (int i = 0; i < g.n; ++i) {
    g.first[i] = static_cast<int>(ctas);
    ctas += ((g.t[i].n + g.t[i].block - 1) / g.t[i].block + span - 1) / span;
    if (ctas > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  }
  g.first[g.n] = static_cast<int>(ctas);
  compress_grouped_kernel<<<static_cast<unsigned>(ctas), kThreads, 0,
                            stream>>>(g);
  const int err = static_cast<int>(cudaGetLastError());
  if (err == 0 && launches != nullptr) ++*launches;
  g.n = 0;
  return err;
}

int compress_grouped(const long long* desc, int n, int* launches,
                     cudaStream_t stream) {
  if (launches != nullptr) *launches = 0;
  if (n < 0 || (n > 0 && desc == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  CompressGroup g;
  g.n = 0;
  for (int i = 0; i < n; ++i) {
    const long long* d = desc + static_cast<long long>(i) * kCompDescWords;
    const long long len = d[3], block = d[4];
    if (len < 0 || block <= 0 || block > INT_MAX) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    if (len == 0) continue;
    CompressTable t;
    t.v = reinterpret_cast<const float*>(d[0]);
    t.comp = reinterpret_cast<unsigned short*>(d[1]);
    t.scale = reinterpret_cast<float*>(d[2]);
    t.n = len;
    t.block = static_cast<int>(block);
    t.vec = block % 4 == 0 && len % 4 == 0 && aligned(t.v, 16) &&
            aligned(t.comp, 8);
    g.t[g.n++] = t;
    if (g.n == kMaxCodecTables) {
      const int err = launch_compress(g, launches, stream);
      if (err != 0) return err;
    }
  }
  return g.n > 0 ? launch_compress(g, launches, stream)
                 : static_cast<int>(cudaSuccess);
}

// ---------------------------------------------------------------------------
// decompress: one launch per chunk of tables
// ---------------------------------------------------------------------------

// A CTA covers `groups` 4-element groups per thread of one table.
constexpr int kDecGroups = 4;

struct DecompressTable {
  const unsigned short* comp;   // (>= n,) fp16 bits
  const float* scale;           // (ceil(n / block),)
  float* out;                   // (n,)
  long long n;
  int block;
  int vec;
};

struct DecompressGroup {
  int n;
  int groups;                       // 4-element groups per thread, 1..4
  int first[kMaxCodecTables + 1];   // first CTA of each table; [n] = grid
  DecompressTable t[kMaxCodecTables];
};
static_assert(sizeof(DecompressGroup) <= 4000,
              "the grouped decompress parameter must stay under 4 KB");

__device__ __forceinline__ float unscale(unsigned short c, float s) {
  return __fdiv_rn(__half2float(__ushort_as_half(c)), s);
}

__global__ void __launch_bounds__(kThreads)
    decompress_grouped_kernel(const __grid_constant__ DecompressGroup g) {
  const int cta = static_cast<int>(blockIdx.x);
  const int k = table_of(g.first, g.n, cta);
  const DecompressTable& t = g.t[k];
  const long long base =
      static_cast<long long>(cta - g.first[k]) * kThreads * 4 * g.groups;
  if (t.vec) {
    // block % 4 == 0: the four elements of a group share one scale
    uint2 p[kDecGroups];
    float s[kDecGroups];
#pragma unroll
    for (int j = 0; j < kDecGroups; ++j) {
      const long long e = base + (j * kThreads + threadIdx.x) * 4LL;
      if (j < g.groups && e < t.n) {
        p[j] = __ldg(reinterpret_cast<const uint2*>(t.comp + e));
        s[j] = __ldg(t.scale + e / t.block);
      }
    }
#pragma unroll
    for (int j = 0; j < kDecGroups; ++j) {
      const long long e = base + (j * kThreads + threadIdx.x) * 4LL;
      if (j < g.groups && e < t.n) {
        float4 o;
        o.x = unscale(p[j].x & 0xffffu, s[j]);
        o.y = unscale(p[j].x >> 16, s[j]);
        o.z = unscale(p[j].y & 0xffffu, s[j]);
        o.w = unscale(p[j].y >> 16, s[j]);
        *reinterpret_cast<float4*>(t.out + e) = o;
      }
    }
  } else {
    for (int j = 0; j < g.groups * 4; ++j) {
      const long long e = base + j * kThreads + threadIdx.x;
      if (e < t.n) {
        t.out[e] = unscale(__ldg(t.comp + e), __ldg(t.scale + e / t.block));
      }
    }
  }
}

// One row of the host descriptor array (int64 each): comp, scale, out, n,
// block
constexpr int kDecDescWords = 5;

// Lays out the group's grid (groups per thread, first CTAs), launches it
// and empties the group.
int launch_decompress(DecompressGroup& g, int* launches,
                      cudaStream_t stream) {
  long long work = 0;   // 4-element groups
  for (int i = 0; i < g.n; ++i) work += (g.t[i].n + 3) / 4;
  g.groups = per_thread(work, kThreads, kDecGroups);
  const long long span = static_cast<long long>(kThreads) * 4 * g.groups;
  long long ctas = 0;
  for (int i = 0; i < g.n; ++i) {
    g.first[i] = static_cast<int>(ctas);
    ctas += (g.t[i].n + span - 1) / span;
    if (ctas > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  }
  g.first[g.n] = static_cast<int>(ctas);
  decompress_grouped_kernel<<<static_cast<unsigned>(ctas), kThreads, 0,
                              stream>>>(g);
  const int err = static_cast<int>(cudaGetLastError());
  if (err == 0 && launches != nullptr) ++*launches;
  g.n = 0;
  return err;
}

}  // namespace

// desc: n rows of 5 int64 {v, comp, scale, n, block}, in host memory, one
// per table: v (n,) fp32; comp (ceil(n / block) * block,) fp16, written;
// scale (ceil(n / block),) fp32, written. Tables with n = 0 are skipped.
// Launches once per kMaxCodecTables non-empty tables and stores the number
// of launches in *launches.
extern "C" int persia_blockscale_compress_grouped_f32(const long long* desc,
                                                      int n, int* launches,
                                                      void* stream) {
  return compress_grouped(desc, n, launches,
                          static_cast<cudaStream_t>(stream));
}

// The one-table case: v (n,) fp32; comp (ceil(n / block) * block,) fp16
// out; scale (ceil(n / block),) fp32 out.
extern "C" int persia_blockscale_compress_f32(const float* v, long long n,
                                              int block, void* comp,
                                              float* scale, void* stream) {
  if (n < 0 || block <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const long long desc[kCompDescWords] = {
      static_cast<long long>(reinterpret_cast<uintptr_t>(v)),
      static_cast<long long>(reinterpret_cast<uintptr_t>(comp)),
      static_cast<long long>(reinterpret_cast<uintptr_t>(scale)), n, block};
  return compress_grouped(desc, 1, nullptr,
                          static_cast<cudaStream_t>(stream));
}

// desc: n rows of 5 int64 {comp, scale, out, n, block}, in host memory,
// one per table: comp (>= n,) fp16; scale (ceil(n / block),) fp32; out
// (n,) fp32, written. Tables with n = 0 are skipped. Launches once per
// kMaxCodecTables non-empty tables and stores the number of launches in
// *launches.
extern "C" int persia_blockscale_decompress_grouped_f32(const long long* desc,
                                                        int n, int* launches,
                                                        void* stream) {
  if (launches != nullptr) *launches = 0;
  if (n < 0 || (n > 0 && desc == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  DecompressGroup g;
  g.n = 0;
  for (int i = 0; i < n; ++i) {
    const long long* d = desc + static_cast<long long>(i) * kDecDescWords;
    const long long len = d[3], block = d[4];
    if (len < 0 || block <= 0 || block > INT_MAX) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    if (len == 0) continue;
    DecompressTable t;
    t.comp = reinterpret_cast<const unsigned short*>(d[0]);
    t.scale = reinterpret_cast<const float*>(d[1]);
    t.out = reinterpret_cast<float*>(d[2]);
    t.n = len;
    t.block = static_cast<int>(block);
    t.vec = block % 4 == 0 && len % 4 == 0 && aligned(t.comp, 8) &&
            aligned(t.out, 16);
    g.t[g.n++] = t;
    if (g.n == kMaxCodecTables) {
      const int err = launch_decompress(g, launches, s);
      if (err != 0) return err;
    }
  }
  return g.n > 0 ? launch_decompress(g, launches, s)
                 : static_cast<int>(cudaSuccess);
}

// The one-table case: comp (>= n,) fp16; scale (ceil(n / block),) fp32;
// out (n,) fp32 out.
extern "C" int persia_blockscale_decompress_f32(const void* comp,
                                                const float* scale,
                                                long long n, int block,
                                                float* out, void* stream) {
  if (n < 0 || block <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const long long desc[kDecDescWords] = {
      static_cast<long long>(reinterpret_cast<uintptr_t>(comp)),
      static_cast<long long>(reinterpret_cast<uintptr_t>(scale)),
      static_cast<long long>(reinterpret_cast<uintptr_t>(out)), n, block};
  return persia_blockscale_decompress_grouped_f32(desc, 1, nullptr, stream);
}
