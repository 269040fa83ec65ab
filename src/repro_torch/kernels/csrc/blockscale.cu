// Blockscale fp16 wire codec for Hopper (sm_90a): Persia's §4.2.3 lossy
// value compression of the get and put payloads.
//
//   persia_blockscale_compress_f32: the flat fp32 input v (n elements) cut
//   into blocks of `block` (the last block reads zeros past n); per block k
//     scale[k] = 32768 / max(max|v_k|, 1e-30)     (NaN if v_k holds a NaN)
//     comp[k * block + i] = fp16_rn(v[k * block + i] * scale[k])
//   persia_blockscale_decompress_f32:
//     out[i] = float(comp[i]) / scale[i / block]   for i < n
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
// nothing is padded in memory:
//
// * Compress: one warp per block. Each lane loads a float4 (or a float on
//   the scalar path) and strides over the block; the block's max|v| is a
//   __shfl_xor_sync butterfly of fmaxf, exact in any order since a max is
//   never rounded. fmaxf drops NaN where torch's amax keeps it, so a NaN is
//   tracked apart and makes the scale NaN. A lane keeps the values of the
//   first pass in registers when the block fits in one load per lane
//   (block 128 on the float4 path, the wire's block); otherwise the second
//   pass reads the block again, from L1.
// * Decompress: a thread per float4 (or float) of the output.
// * Every float operation is one correctly rounded intrinsic: the scale by
//   __fdiv_rn, the product by __fmul_rn, the fp16 cast by __float2half_rn
//   (round to nearest even, fp16 subnormals kept), and the decompression by
//   __fdiv_rn, a true division and never a multiply by 1/s. Built without
//   fast-math or flush-to-zero, fp32 subnormals are kept too (XLA on the
//   CPU flushes them; the plain version, like this kernel, does not).
//
// Bound: memory. Compress reads 4 bytes and writes 2 per element plus 4 per
// block; decompress the reverse. At the training shape (one table's
// unique rows, 1,024 to 4,096 rows of 128) that is 0.8 to 3.2 MB, under a
// microsecond at 3.35 TB/s, so the fixed cost of a launch dominates. The
// kernels are written to be right first; they are not tuned.
//
// C interface (bound with ctypes): every function launches on `stream`,
// does not synchronise, allocates nothing, and returns cudaGetLastError().

#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarps = 8;       // codec blocks (warps) per thread block
constexpr int kThreads = 256;   // decompress threads per thread block
constexpr float kKappa = 32768.0f;

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

template <int W>
__global__ void compress_kernel(const float* __restrict__ v, long long n,
                                int block, long long n_blocks,
                                unsigned short* __restrict__ comp,
                                float* __restrict__ scale) {
  const int lane = threadIdx.x;
  const long long k = static_cast<long long>(blockIdx.x) * blockDim.y +
                      threadIdx.y;
  if (k >= n_blocks) return;
  const long long base = k * block;
  // one load per lane covers the block: keep it for the second pass
  const bool held = block <= 32 * W;
  float x[W];
  float m = 0.0f;
  bool nan = false;
  for (int i = lane * W; i < block; i += 32 * W) {
    load<W>(v, base + i, n, x);
#pragma unroll
    for (int j = 0; j < W; ++j) {
      m = fmaxf(m, fabsf(x[j]));
      nan |= isnan(x[j]);
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(kFull, m, o));
  nan = __any_sync(kFull, nan);
  const float s = nan ? __int_as_float(0x7fffffff)
                      : __fdiv_rn(kKappa, fmaxf(m, 1e-30f));
  if (lane == 0) scale[k] = s;
  if (held) {
    if (lane * W < block) store<W>(comp, base + lane * W, x, s);
    return;
  }
  for (int i = lane * W; i < block; i += 32 * W) {
    load<W>(v, base + i, n, x);
    store<W>(comp, base + i, x, s);
  }
}

template <int W>
__global__ void decompress_kernel(const unsigned short* __restrict__ comp,
                                  const float* __restrict__ scale,
                                  long long n, int block,
                                  float* __restrict__ out) {
  const long long e =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) * W;
  if (e >= n) return;
  // with W == 4, block % 4 == 0: the four elements share one block
  const float s = __ldg(scale + e / block);
  if constexpr (W == 4) {
    const uint2 p = __ldg(reinterpret_cast<const uint2*>(comp + e));
    float4 o;
    o.x = __fdiv_rn(__half2float(__ushort_as_half(p.x & 0xffffu)), s);
    o.y = __fdiv_rn(__half2float(__ushort_as_half(p.x >> 16)), s);
    o.z = __fdiv_rn(__half2float(__ushort_as_half(p.y & 0xffffu)), s);
    o.w = __fdiv_rn(__half2float(__ushort_as_half(p.y >> 16)), s);
    *reinterpret_cast<float4*>(out + e) = o;
  } else {
    out[e] = __fdiv_rn(__half2float(__ushort_as_half(comp[e])), s);
  }
}

bool aligned(const void* p, uintptr_t to) {
  return reinterpret_cast<uintptr_t>(p) % to == 0;
}

}  // namespace

// v (n,) fp32; comp (ceil(n / block) * block,) fp16 out; scale
// (ceil(n / block),) fp32 out.
extern "C" int persia_blockscale_compress_f32(const float* v, long long n,
                                              int block, void* comp,
                                              float* scale, void* stream) {
  if (n < 0 || block <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return static_cast<int>(cudaSuccess);
  const long long n_blocks = (n + block - 1) / block;
  const dim3 threads(32, kWarps);
  const dim3 grid(static_cast<unsigned>((n_blocks + kWarps - 1) / kWarps));
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  unsigned short* c = static_cast<unsigned short*>(comp);
  if (block % 4 == 0 && n % 4 == 0 && aligned(v, 16) && aligned(comp, 8)) {
    compress_kernel<4><<<grid, threads, 0, s>>>(v, n, block, n_blocks, c,
                                                scale);
  } else {
    compress_kernel<1><<<grid, threads, 0, s>>>(v, n, block, n_blocks, c,
                                                scale);
  }
  return static_cast<int>(cudaGetLastError());
}

// comp (>= n,) fp16; scale (ceil(n / block),) fp32; out (n,) fp32 out.
extern "C" int persia_blockscale_decompress_f32(const void* comp,
                                                const float* scale,
                                                long long n, int block,
                                                float* out, void* stream) {
  if (n < 0 || block <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return static_cast<int>(cudaSuccess);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned short* c = static_cast<const unsigned short*>(comp);
  if (block % 4 == 0 && n % 4 == 0 && aligned(comp, 8) && aligned(out, 16)) {
    const long long n_thr = n / 4;
    decompress_kernel<4><<<static_cast<unsigned>((n_thr + kThreads - 1) /
                                                 kThreads),
                           kThreads, 0, s>>>(c, scale, n, block, out);
  } else {
    decompress_kernel<1><<<static_cast<unsigned>((n + kThreads - 1) /
                                                 kThreads),
                           kThreads, 0, s>>>(c, scale, n, block, out);
  }
  return static_cast<int>(cudaGetLastError());
}
