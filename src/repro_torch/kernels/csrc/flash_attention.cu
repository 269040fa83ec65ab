// Flash-attention forward for Hopper (sm_90a): causal and/or sliding-window
// GQA attention with an fp32 online softmax, fp32 or bf16 inputs, both
// products on the tensor cores (wgmma).
//
//   persia_flash_attention_fwd:
//     q (B, Hq, Sq, Dh), k (B, Hkv, Sk, Dh), v (B, Hkv, Sk, Dv); query head
//     h reads kv head h / (Hq / Hkv); the value head Dv <= Dh may be
//     narrower than the query/key head (MLA: Dh 192 = 128 + 64 rope, Dv
//     128);
//     s = (q . k) * scale + bias, bias = 0 where attended, -1e30 where masked
//     (masked: causal and qpos < kpos, or window > 0 and qpos - kpos >=
//     window, with qpos = query row + q_offset);
//     o = softmax(s) v (B, Hq, Sq, Dv) in q's dtype, lse = m + log(max(l,
//     1e-30)) in fp32 (B, Hq, Sq).
//
// It replaces the Pallas TPU kernel
//   src/repro/kernels/flash_attention.py  flash_attention_fwd (_kernel)
// and is held against its plain torch version in ../ref.py
// (flash_attention_fwd_ref, the arithmetic of models/layers.py::_attn_naive)
// within a tolerance: o within 2e-5 in fp32 and 4e-2 with bf16 inputs, lse
// within 1e-4. The exponentials and sums run in another order.
//
// Design. Each CTA owns one (batch, query head, tile of 64 * NWG query
// rows) and loops over key tiles of BK keys. Warp specialised:
//
// * One producer warp fills a ring of kStages = 2 raw K/V stages in shared
//   memory. A key tile of one head is one contiguous run of bytes in
//   (B, Hkv, Sk, Dh), so the producer takes it with TMA's bulk copy
//   (cp.async.bulk, completion on an mbarrier, no tensor map); the rows
//   past Sk are not copied. Where TMA's 16-byte rule fails (bf16 with
//   Dh % 8 != 0, or k / v not 16-byte aligned) the warp's 32 lanes load
//   the tile with 8-byte cp.async instead and arrive on the same mbarrier
//   (cp.async.mbarrier.arrive.noinc).
// * NWG consumer warpgroups own 64 query rows each. When a stage lands
//   they restage it into the wgmma operand layout (K-major, no swizzle:
//   8-row x 16-byte core matrices; V transposed to (d, key), since tf32
//   wgmma has no transpose), writing keys past Sk as zeros, so no garbage
//   or NaN enters a product, and free the stage. Dh is padded with zeros
//   to DP (32, 64, 128 or 192) in shared memory, Dv to DV (DP, or 128
//   where DP is 192): the query/key width is the depth of Q K^T, the value
//   width the N of P V, and each operand follows its own.
// * fp32 inputs: 3xTF32. Each operand x is split once into big =
//   tf32(x) and small = tf32(x - big) (cvt.rna.tf32.f32): Q once per CTA,
//   K and V when their tile is restaged, P in registers. Each product is
//   three wgmma .tf32 passes, small.big, big.small, then big.big, with fp32
//   accumulators in registers: the dropped small.small term is ~2^-22 of
//   the product, fp32-grade, where single-pass TF32 (~2^-11) would miss
//   the 2e-5 check. bf16 inputs: one wgmma .bf16 pass per product, P
//   rounded to bf16, on the same skeleton (its own instantiation).
// * S = Q K^T lands in registers (m64nBK); the online softmax (m and l per
//   row, expf / logf, a true division at the end) runs on the accumulator
//   fragment, a row's four threads reducing by shuffle; P feeds the P V
//   wgmma from registers. Each tile's P V is summed afresh on the tensor
//   cores and added to the running output with a rounded fma (o = o corr +
//   P V): accumulating a whole row's tiles on the tensor cores lost low
//   bits (max |do| 5.9e-6 at granite's prefill shape, 2.7e-6 this way).
//   tf32's A fragment holds keys (c, c + 4) where the accumulator holds
//   (2c, 2c + 1), so V's tile is stored with each 8-key step permuted to
//   match (key 2i at slot i, key 2i + 1 at 4 + i).
// * Ragged edges: query rows past Sq are computed on zeros and never
//   stored; keys past Sk are absent (score -inf, weight 0), unlike masked
//   keys (-1e30), which keep the reference's semantics for a row with no
//   attended key (a uniform average). Key tiles wholly above the causal
//   diagonal or wholly outside the window for every row of the CTA are
//   skipped, unless some row of the CTA attends no key at all (possible
//   only with a window and Sq + q_offset > Sk), which must then see every
//   key. CTAs are issued last query tile first, so the longest causal rows
//   start early.
//
// Bound: operations. 2 * B * Hq * (Dh + Dv) * (attended pairs)
// fp32-equivalent operations; at fp32 accuracy the card does three TF32
// passes of them at 495 TFLOP/s (3 x 68.8 GFLOP: 417 us at granite's
// prefill shape, 3 x 85.9 GFLOP: 521 us at DeepSeek-V2-Lite's MLA prefill,
// B 4, S 2,048, 16 heads of 192 / 128; one fp32 pass outside the tensor
// cores, 67 TFLOP/s, would take 1,026 and 1,283 us), bf16 one pass at 989
// TFLOP/s (70 and 87 us). The bytes (q, k, v read once, o
// written once) are a few percent of that at prefill length. The
// restaging of every K/V tile and the softmax run between the products,
// not beside them: the kernel is far from that bound (PERF.md).
//
// Shared memory, bytes, fp32 / bf16 inputs (DP, DV: Dh, Dv padded; NWG
// consumer warpgroups; BK keys a tile; raw K/V stages in the ring):
//   DP, DV, NWG, BK, stages  raw K/V stage    Q ops            K ops, V ops
//   32, 32, 2, 64, 2         16,384 / 8,192   32,768 / 8,192   16,384 / 4,096
//   64, 64, 2, 64, 2         32,768 / 16,384  65,536 / 16,384  32,768 / 8,192
//   128, 128, 1, 32, 2       32,768 / 16,384  65,536 / 16,384  32,768 / 8,192
//   192, 128, 1, 32, 1 / 2   40,960 / 20,480  98,304 / 24,576  49,152, 32,768
//                                                              / 12,288, 8,192
// (the fp32 operand buffers hold big and small; K ops and V ops are each
// that size in the first three rows), so at most 196,640 bytes with the
// mbarriers where DP <= 128, and 221,200 at (192, 128) in fp32: there two
// raw stages (262,144 in all) or the old 2 x 81,920 ring would pass the
// 232,448 bytes a block may opt in to, so the fp32 ring keeps ONE raw
// stage. The stage is freed as soon as it is restaged into the operand
// layout, so the producer still loads tile i + 1 while the consumers
// multiply tile i. One CTA per SM, opted in to dynamic shared memory
// above 48 KB once per instantiation.
//
// C interface (bound with ctypes): launches on `stream`, does not
// synchronise, allocates nothing, and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr float kMasked = -1e30f;

// DP: the query/key head padded; DV: the value head padded (DP where
// DP <= 128)
template <typename T, int DP, int DV>
struct Cfg {
  static constexpr bool kF32 = std::is_same<T, float>::value;
  static constexpr int BK = DP >= 128 ? 32 : 64;     // keys per tile
  static constexpr int NWG = DP >= 128 ? 1 : 2;      // consumer warpgroups
  // raw K/V stages in the ring (one for fp32 at DP 192: see the table)
  static constexpr int kStages = DP > 128 && kF32 ? 1 : 2;
  static constexpr int BQ = 64 * NWG;                // query rows per CTA
  static constexpr int NC = NWG * 128;               // consumer threads
  static constexpr int NT = NC + 32;                 // + the producer warp
  static constexpr int CH = 16 / sizeof(T);          // elements per 16 B
  static constexpr int NSPLIT = kF32 ? 2 : 1;        // big (and small)
  static constexpr int kRaw = BK * (DP + DV) * sizeof(T);      // one stage
  static constexpr int kQ = 64 * DP * sizeof(T);               // one half
  static constexpr int kK = BK * DP * sizeof(T);
  static constexpr int kV = DV * BK * sizeof(T);
  static constexpr int kSmem = kStages * kRaw + NSPLIT * (NWG * kQ + kK + kV)
                               + 2 * kStages * 8;
  static_assert(kSmem <= 232448, "over the shared memory a block may use");
};

// ---------------------------------------------------------------------------
// PTX
// ---------------------------------------------------------------------------

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
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_addr(bar)), "r"(bytes) : "memory");
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
// TMA bulk copy of `bytes` (a multiple of 16, both ends 16-byte aligned),
// completing on `bar`'s transaction count
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)), "l"(src),
      "r"(bytes), "r"(smem_addr(bar)) : "memory");
}
__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(
                   smem_addr(dst)), "l"(src) : "memory");
}
// `bar` receives one arrival once this thread's cp.asyncs have landed
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::
                   "r"(smem_addr(bar)) : "memory");
}
// generic-proxy writes to shared memory, visible to wgmma (async proxy)
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// the consumer warpgroups' own barrier (the producer warp is not in it)
template <int N>
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// keeps the compiler from moving a register's uses across an async wgmma
template <typename R, int N>
__device__ __forceinline__ void fence_regs(R (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    if constexpr (std::is_same<R, float>::value) {
      asm volatile("" : "+f"(r[i])::"memory");
    } else {
      asm volatile("" : "+r"(r[i])::"memory");
    }
  }
}

// A wgmma shared-memory descriptor: K-major, no swizzle; core matrices of
// 8 rows x 16 bytes, 128 bytes apart along M/N (SBO), `lbo` bytes apart
// along K (LBO).
__device__ __forceinline__ uint64_t desc(const void* p, uint32_t lbo) {
  return static_cast<uint64_t>((smem_addr(p) & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(128 >> 4) << 32);
}

// wgmma m64nNk8 (tf32) and m64nNk16 (bf16), fp32 accumulators, A from
// shared memory (ss) or registers (rs), B from shared memory, both K-major.
__device__ __forceinline__ void wgmma_ss_tf32_n32(
    float (&d)[16], uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15"
      "}, %16, %17, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "l"(a), "l"(b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_ss_tf32_n64(
    float (&d)[32], uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs_tf32_n32(
    float (&d)[16], const uint32_t (&a)[4], uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
        "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs_tf32_n64(
    float (&d)[32], const uint32_t (&a)[4], uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
        "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs_tf32_n128(
    float (&d)[64], const uint32_t (&a)[4], uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
        "r"(scale_d));
}

__device__ __forceinline__ void wgmma_ss_bf16_n32(
    float (&d)[16], uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "l"(a), "l"(b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_ss_bf16_n64(
    float (&d)[32], uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs_bf16_n32(
    float (&d)[16], const uint32_t (&a)[4], uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
        "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs_bf16_n64(
    float (&d)[32], const uint32_t (&a)[4], uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
        "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs_bf16_n128(
    float (&d)[64], const uint32_t (&a)[4], uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
        "r"(scale_d));
}

template <typename T, int N>
__device__ __forceinline__ void mma_ss(float (&d)[N / 2], uint64_t a,
                                       uint64_t b, int scale_d) {
  if constexpr (std::is_same<T, float>::value) {
    if constexpr (N == 32) wgmma_ss_tf32_n32(d, a, b, scale_d);
    else wgmma_ss_tf32_n64(d, a, b, scale_d);
  } else {
    if constexpr (N == 32) wgmma_ss_bf16_n32(d, a, b, scale_d);
    else wgmma_ss_bf16_n64(d, a, b, scale_d);
  }
}
template <typename T, int N>
__device__ __forceinline__ void mma_rs(float (&d)[N / 2],
                                       const uint32_t (&a)[4], uint64_t b,
                                       int scale_d) {
  if constexpr (std::is_same<T, float>::value) {
    if constexpr (N == 32) wgmma_rs_tf32_n32(d, a, b, scale_d);
    else if constexpr (N == 64) wgmma_rs_tf32_n64(d, a, b, scale_d);
    else wgmma_rs_tf32_n128(d, a, b, scale_d);
  } else {
    if constexpr (N == 32) wgmma_rs_bf16_n32(d, a, b, scale_d);
    else if constexpr (N == 64) wgmma_rs_bf16_n64(d, a, b, scale_d);
    else wgmma_rs_bf16_n128(d, a, b, scale_d);
  }
}

// ---------------------------------------------------------------------------
// operand staging
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}
// x = big + small + O(2^-22 x), both halves TF32
__device__ __forceinline__ void split(float x, float& big, float& small) {
  big = __uint_as_float(tf32(x));
  small = __uint_as_float(tf32(x - big));
}
__device__ __forceinline__ void split4(float4 x, float4& b, float4& s) {
  split(x.x, b.x, s.x);
  split(x.y, b.y, s.y);
  split(x.z, b.z, s.z);
  split(x.w, b.w, s.w);
}
__device__ __forceinline__ float comp(float4 v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// Rows [0, ROWS) of a row-major (rows, Dh) matrix at `src` (shared or
// global memory; rows >= n_valid read as zero) into the K-major operand
// layout [DP / CH][ROWS][CH]: fp32 split into big and small, bf16 copied.
// Thread `tid` of `nt`; consecutive threads take consecutive rows, each on
// the next 16-byte column chunk, so neither side's banks collide (where
// Dh * 4 is a multiple of 128 bytes).
template <typename T, int ROWS>
__device__ __forceinline__ void stage_rows(T* big, T* small, const T* src,
                                           int n_valid, int Dh, int tid,
                                           int nt) {
  if constexpr (std::is_same<T, float>::value) {
    const int nc = Dh / 4;
    for (int idx = tid; idx < ROWS * nc; idx += nt) {
      const int r = idx % ROWS, ch = (idx / ROWS + r) % nc;
      float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
      if (r < n_valid) {
        x = *reinterpret_cast<const float4*>(src + (long long)r * Dh + 4 * ch);
      }
      float4 b, s;
      split4(x, b, s);
      *reinterpret_cast<float4*>(big + (ch * ROWS + r) * 4) = b;
      *reinterpret_cast<float4*>(small + (ch * ROWS + r) * 4) = s;
    }
  } else {
    // 4 bf16 (8 bytes) a unit: half of a 16-byte chunk
    const int nu = Dh / 4;
    for (int idx = tid; idx < ROWS * nu; idx += nt) {
      const int r = idx % ROWS, u = (idx / ROWS + r) % nu;
      uint2 x = make_uint2(0u, 0u);
      if (r < n_valid) {
        x = *reinterpret_cast<const uint2*>(src + (long long)r * Dh + 4 * u);
      }
      *reinterpret_cast<uint2*>(big + ((u >> 1) * ROWS + r) * 8 +
                                (u & 1) * 4) = x;
    }
  }
}

// The V tile (BK keys x Dv, row-major, keys >= n_valid zero) into the
// K-major B operand of P V: [BK / CH][DV][CH], keys along the 16 bytes. For
// tf32 the keys of each 8-key step are permuted as P's A fragment holds
// them: chunk 2s + p holds keys 8s + p + 2i, i < 4.
template <typename T, int DV, int BK>
__device__ __forceinline__ void stage_v(T* big, T* small, const T* src,
                                        int n_valid, int Dv, int tid,
                                        int nt) {
  const int ndq = Dv / 4;
  if constexpr (std::is_same<T, float>::value) {
    for (int idx = tid; idx < (BK / 4) * ndq; idx += nt) {
      const int dq = idx % ndq, kc = idx / ndq;
      const int key0 = 8 * (kc >> 1) + (kc & 1);
      float4 v[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int key = key0 + 2 * i;
        v[i] = key < n_valid
                   ? *reinterpret_cast<const float4*>(src + key * Dv + 4 * dq)
                   : make_float4(0.f, 0.f, 0.f, 0.f);
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        float4 b, s;
        split4(make_float4(comp(v[0], r), comp(v[1], r), comp(v[2], r),
                           comp(v[3], r)), b, s);
        const int o = (kc * DV + 4 * dq + r) * 4;
        *reinterpret_cast<float4*>(big + o) = b;
        *reinterpret_cast<float4*>(small + o) = s;
      }
    }
  } else {
    for (int idx = tid; idx < (BK / 8) * ndq; idx += nt) {
      const int dq = idx % ndq, kc = idx / ndq;
      uint2 v[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int key = 8 * kc + i;
        v[i] = key < n_valid
                   ? *reinterpret_cast<const uint2*>(src + key * Dv + 4 * dq)
                   : make_uint2(0u, 0u);
      }
      // row d takes the d-th bf16 of each key: low / high halves of .x, .y
      uint4* out = reinterpret_cast<uint4*>(big + (kc * DV + 4 * dq) * 8);
      out[0] = make_uint4(__byte_perm(v[0].x, v[1].x, 0x5410),
                          __byte_perm(v[2].x, v[3].x, 0x5410),
                          __byte_perm(v[4].x, v[5].x, 0x5410),
                          __byte_perm(v[6].x, v[7].x, 0x5410));
      out[1] = make_uint4(__byte_perm(v[0].x, v[1].x, 0x7632),
                          __byte_perm(v[2].x, v[3].x, 0x7632),
                          __byte_perm(v[4].x, v[5].x, 0x7632),
                          __byte_perm(v[6].x, v[7].x, 0x7632));
      out[2] = make_uint4(__byte_perm(v[0].y, v[1].y, 0x5410),
                          __byte_perm(v[2].y, v[3].y, 0x5410),
                          __byte_perm(v[4].y, v[5].y, 0x5410),
                          __byte_perm(v[6].y, v[7].y, 0x5410));
      out[3] = make_uint4(__byte_perm(v[0].y, v[1].y, 0x7632),
                          __byte_perm(v[2].y, v[3].y, 0x7632),
                          __byte_perm(v[4].y, v[5].y, 0x7632),
                          __byte_perm(v[6].y, v[7].y, 0x7632));
    }
  }
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// ---------------------------------------------------------------------------
// the kernel
// ---------------------------------------------------------------------------

template <typename T, int DP, int DV>
__global__ void __launch_bounds__(Cfg<T, DP, DV>::NT, 1)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, int Hq, int Hkv, int Sq, int Sk,
                 int Dh, int Dv, float scale, int causal, int window,
                 int q_offset, int bulk) {
  using C = Cfg<T, DP, DV>;
  constexpr int BK = C::BK, CH = C::CH, kStages = C::kStages;
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* raw = smem;
  T* q_ops = reinterpret_cast<T*>(smem + kStages * C::kRaw);
  T* k_ops = q_ops + C::NSPLIT * C::NWG * 64 * DP;
  T* v_ops = k_ops + C::NSPLIT * BK * DP;
  uint64_t* full = reinterpret_cast<uint64_t*>(v_ops + C::NSPLIT * DV * BK);
  uint64_t* empty = full + kStages;

  const int qt = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int q0 = qt * C::BQ;
  const long long q_base = ((long long)b * Hq + h) * Sq;
  const T* kb = k + ((long long)b * Hkv + hk) * Sk * Dh;
  const T* vb = v + ((long long)b * Hkv + hk) * Sk * Dv;

  // the key tiles this query tile needs
  const long long qlo = (long long)q0 + q_offset;
  const long long qhi = (long long)min(q0 + C::BQ, Sq) - 1 + q_offset;
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

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], bulk ? 1 : 32);
      mbar_init(&empty[s], C::NC);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= C::NC) {
    // ---- producer warp: K/V tiles into the raw ring ----
    const int lane = threadIdx.x & 31;
    for (int it = 0; kt_begin + it < kt_end; ++it) {
      const int s = it % kStages;
      if (it >= kStages) mbar_wait(&empty[s], (it / kStages - 1) & 1);
      const int k0 = (kt_begin + it) * BK;
      const int rows = min(BK, Sk - k0);
      T* dk = reinterpret_cast<T*>(raw + s * C::kRaw);
      T* dv = dk + BK * DP;
      const T* sk = kb + (long long)k0 * Dh;
      const T* sv = vb + (long long)k0 * Dv;
      const uint32_t kbytes = rows * Dh * sizeof(T);
      const uint32_t vbytes = rows * Dv * sizeof(T);
      if (bulk) {
        if (lane == 0) {
          mbar_arrive_expect_tx(&full[s], kbytes + vbytes);
          bulk_load(dk, sk, kbytes, &full[s]);
          bulk_load(dv, sv, vbytes, &full[s]);
        }
      } else {
        constexpr int E8 = 8 / sizeof(T);     // elements per 8 bytes
        for (uint32_t i = lane; i < kbytes / 8; i += 32) {
          cp_async8(dk + i * E8, sk + i * E8);
        }
        for (uint32_t i = lane; i < vbytes / 8; i += 32) {
          cp_async8(dv + i * E8, sv + i * E8);
        }
        cp_async_arrive(&full[s]);
      }
    }
    if (!bulk) asm volatile("cp.async.wait_all;\n" ::: "memory");
    return;
  }

  // ---- consumer warpgroups ----
  const int wg = threadIdx.x / 128, t = threadIdx.x % 128;
  const int lane = t & 31, g = 16 * (t >> 5) + (lane >> 2), c = lane & 3;
  T* qb_ops = q_ops + wg * C::NSPLIT * 64 * DP;   // this warpgroup's Q
  T* qs_ops = qb_ops + 64 * DP;                   // its small half (fp32)
  T* ks_ops = k_ops + BK * DP;
  T* vs_ops = v_ops + DV * BK;

  // the padding (Dh..DP of Q and K, Dv..DV of V) of every operand stays
  // zero
  for (int i = threadIdx.x; i * 16 < C::NSPLIT * (C::NWG * C::kQ + C::kK +
                                                  C::kV);
       i += C::NC) {
    reinterpret_cast<uint4*>(q_ops)[i] = make_uint4(0u, 0u, 0u, 0u);
  }
  consumer_sync<C::NC>();
  const int row0 = q0 + 64 * wg;
  stage_rows<T, 64>(qb_ops, qs_ops, q + (q_base + row0) * Dh, Sq - row0, Dh,
                    t, 128);

  // acc: the running output; ot: one tile's P V, summed afresh on the
  // tensor cores and added to acc with a rounded fma (the tensor cores'
  // accumulation over a whole row's tiles would lose low bits)
  float acc[DV / 2], ot[DV / 2];
#pragma unroll
  for (int i = 0; i < DV / 2; ++i) acc[i] = ot[i] = 0.f;
  float m[2] = {kMasked, kMasked}, l[2] = {0.f, 0.f};
  const long long qpos0 = (long long)row0 + g + q_offset;

  for (int it = 0; kt_begin + it < kt_end; ++it) {
    const int s = it % kStages;
    const int k0 = (kt_begin + it) * BK;
    const int n_valid = min(BK, Sk - k0);
    mbar_wait(&full[s], (it / kStages) & 1);
    const T* rk = reinterpret_cast<const T*>(raw + s * C::kRaw);
    stage_rows<T, BK>(k_ops, ks_ops, rk, n_valid, Dh, threadIdx.x, C::NC);
    stage_v<T, DV, BK>(v_ops, vs_ops, rk + BK * DP, n_valid, Dv,
                       threadIdx.x, C::NC);
    mbar_arrive(&empty[s]);
    fence_async_smem();
    consumer_sync<C::NC>();

    // S = Q K^T (64 x BK per warpgroup)
    float sc[BK / 2];
    wgmma_fence();
    if constexpr (C::kF32) {
#pragma unroll
      for (int pass = 0; pass < 3; ++pass) {
        const T* qa = pass == 0 ? qs_ops : qb_ops;
        const T* kbm = pass == 1 ? ks_ops : k_ops;
#pragma unroll
        for (int ks = 0; ks < DP / 8; ++ks) {
          mma_ss<T, BK>(sc, desc(qa + ks * 2 * 64 * CH, 64 * 16),
                        desc(kbm + ks * 2 * BK * CH, BK * 16),
                        pass > 0 || ks > 0);
        }
      }
    } else {
#pragma unroll
      for (int ks = 0; ks < DP / 16; ++ks) {
        mma_ss<T, BK>(sc, desc(qb_ops + ks * 2 * 64 * CH, 64 * 16),
                      desc(k_ops + ks * 2 * BK * CH, BK * 16), ks > 0);
      }
    }
    wgmma_commit();
    wgmma_wait();
    fence_regs(sc);

    // online softmax on the fragment: sc[i] is row g + 8 * ((i >> 1) & 1),
    // key k0 + 8 * (i >> 2) + 2c + (i & 1)
    float mt[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) {
      const int hr = (i >> 1) & 1;
      const long long qpos = qpos0 + 8 * hr;
      const int kpos = k0 + 8 * (i >> 2) + 2 * c + (i & 1);
      float x = -INFINITY;        // past the keys: absent
      if (kpos < Sk) {
        bool attended = true;
        if (causal) attended = attended && qpos >= kpos;
        if (window > 0) attended = attended && qpos - kpos < window;
        x = sc[i] * scale + (attended ? 0.f : kMasked);
      }
      sc[i] = x;
      mt[hr] = fmaxf(mt[hr], x);
    }
    float corr[2], m_new[2], ps[2] = {0.f, 0.f};
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      mt[hr] = fmaxf(mt[hr], __shfl_xor_sync(0xffffffffu, mt[hr], 1));
      mt[hr] = fmaxf(mt[hr], __shfl_xor_sync(0xffffffffu, mt[hr], 2));
      m_new[hr] = fmaxf(m[hr], mt[hr]);
      corr[hr] = expf(m[hr] - m_new[hr]);
    }
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) {
      const int hr = (i >> 1) & 1;
      sc[i] = expf(sc[i] - m_new[hr]);
      ps[hr] += sc[i];
    }
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      ps[hr] += __shfl_xor_sync(0xffffffffu, ps[hr], 1);
      ps[hr] += __shfl_xor_sync(0xffffffffu, ps[hr], 2);
      l[hr] = l[hr] * corr[hr] + ps[hr];
      m[hr] = m_new[hr];
    }

    // O = O corr + P V
    if constexpr (C::kF32) {
      // A fragment of step j: (g, key 2c), (g + 8, 2c), (g, 2c + 1),
      // (g + 8, 2c + 1) of keys 8j..8j + 7
      uint32_t pb[BK / 8][4], pl[BK / 8][4];
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float p = sc[4 * j + ((r & 1) << 1) + (r >> 1)];
          pb[j][r] = tf32(p);
          pl[j][r] = tf32(p - __uint_as_float(pb[j][r]));
        }
      }
      wgmma_fence();
#pragma unroll
      for (int pass = 0; pass < 3; ++pass) {
        const T* vm = pass == 1 ? vs_ops : v_ops;
#pragma unroll
        for (int j = 0; j < BK / 8; ++j) {
          mma_rs<T, DV>(ot, pass == 0 ? pl[j] : pb[j],
                        desc(vm + j * 2 * DV * CH, DV * 16),
                        pass > 0 || j > 0);
        }
      }
      wgmma_commit();
      wgmma_wait();
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
        fence_regs(pb[j]);
        fence_regs(pl[j]);
      }
    } else {
      uint32_t pa[BK / 16][4];
#pragma unroll
      for (int j = 0; j < BK / 16; ++j) {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          pa[j][r] = pack_bf16(sc[8 * j + 2 * r], sc[8 * j + 2 * r + 1]);
        }
      }
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < BK / 16; ++j) {
        mma_rs<T, DV>(ot, pa[j], desc(v_ops + j * 2 * DV * CH, DV * 16),
                      j > 0);
      }
      wgmma_commit();
      wgmma_wait();
#pragma unroll
      for (int j = 0; j < BK / 16; ++j) fence_regs(pa[j]);
    }
    fence_regs(ot);
#pragma unroll
    for (int i = 0; i < DV / 2; ++i) {
      acc[i] = fmaf(acc[i], corr[(i >> 1) & 1], ot[i]);
    }
    consumer_sync<C::NC>();       // the operand tiles are free again
  }

#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int row = row0 + g + 8 * hr;
    if (row >= Sq) continue;
    const float lc = fmaxf(l[hr], 1e-30f);
    T* orow = o + (q_base + row) * Dv;
#pragma unroll
    for (int j = 0; j < DV / 8; ++j) {
      const int col = 8 * j + 2 * c;
      if (col < Dv) {
        store2(orow + col, acc[4 * j + 2 * hr] / lc,
               acc[4 * j + 2 * hr + 1] / lc);
      }
    }
    if (c == 0) lse[q_base + row] = m[hr] + logf(lc);
  }
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

template <typename T, int DP, int DV>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           int B, int Hq, int Hkv, int Sq, int Sk, int Dh, int Dv,
           float scale, int causal, int window, int q_offset,
           cudaStream_t stream) {
  using C = Cfg<T, DP, DV>;
  auto kernel = flash_fwd_kernel<T, DP, DV>;
  // opt in once per instantiation, so that no launch (nor one captured
  // into a CUDA graph) makes the call
  static bool opted_in = false;
  if (!opted_in) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    opted_in = true;
  }
  // TMA's bulk copy wants 16-byte rows and 16-byte aligned sources
  const int bulk = (Dh * sizeof(T)) % 16 == 0 &&
                   (Dv * sizeof(T)) % 16 == 0 && aligned16(k) &&
                   aligned16(v);
  const dim3 grid((Sq + C::BQ - 1) / C::BQ, Hq, B);
  kernel<<<grid, C::NT, C::kSmem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, Hq, Hkv, Sq, Sk, Dh,
      Dv, scale, causal, window, q_offset, bulk);
  return static_cast<int>(cudaGetLastError());
}

// Dh <= 128 pads the value head with the query/key head (DV = DP, Dv <=
// Dh); a query/key head over 128 takes MLA's instantiation, DP 192 with a
// value head of up to 128
template <typename T>
int launch_dh(const void* q, const void* k, const void* v, void* o,
              float* lse, int B, int Hq, int Hkv, int Sq, int Sk, int Dh,
              int Dv, float scale, int causal, int window, int q_offset,
              cudaStream_t s) {
  if (Dh <= 32) {
    return launch<T, 32, 32>(q, k, v, o, lse, B, Hq, Hkv, Sq, Sk, Dh, Dv,
                             scale, causal, window, q_offset, s);
  }
  if (Dh <= 64) {
    return launch<T, 64, 64>(q, k, v, o, lse, B, Hq, Hkv, Sq, Sk, Dh, Dv,
                             scale, causal, window, q_offset, s);
  }
  if (Dh <= 128) {
    return launch<T, 128, 128>(q, k, v, o, lse, B, Hq, Hkv, Sq, Sk, Dh, Dv,
                               scale, causal, window, q_offset, s);
  }
  return launch<T, 192, 128>(q, k, v, o, lse, B, Hq, Hkv, Sq, Sk, Dh, Dv,
                             scale, causal, window, q_offset, s);
}

}  // namespace

// q (B, Hq, Sq, Dh), k (B, Hkv, Sk, Dh), v (B, Hkv, Sk, Dv), o (B, Hq, Sq,
// Dv): fp32 (bf16 == 0) or bf16 (bf16 == 1), contiguous, 16-byte (fp32) or
// 8-byte (bf16) aligned; lse (B, Hq, Sq) fp32. Dh a multiple of 4 in [4,
// 192], Dv a multiple of 4 in [4, min(Dh, 128)], Hq a multiple of Hkv, Sk
// >= 1, window >= 0, q_offset >= 0.
extern "C" int persia_flash_attention_fwd(const void* q, const void* k,
                                          const void* v, void* o, float* lse,
                                          int B, int Hq, int Hkv, int Sq,
                                          int Sk, int Dh, int Dv, float scale,
                                          int causal, int window,
                                          int q_offset, int bf16,
                                          void* stream) {
  if (B <= 0 || Hq <= 0 || Hkv <= 0 || Hq % Hkv != 0 || Sq <= 0 || Sk <= 0 ||
      Dh < 4 || Dh > 192 || Dh % 4 != 0 || Dv < 4 || Dv > Dh || Dv > 128 ||
      Dv % 4 != 0 || window < 0 || q_offset < 0 || Hq > 65535 ||
      B > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) {
    return launch_dh<__nv_bfloat16>(q, k, v, o, lse, B, Hq, Hkv, Sq, Sk, Dh,
                                    Dv, scale, causal, window, q_offset, s);
  }
  return launch_dh<float>(q, k, v, o, lse, B, Hq, Hkv, Sq, Sk, Dh, Dv, scale,
                          causal, window, q_offset, s);
}
