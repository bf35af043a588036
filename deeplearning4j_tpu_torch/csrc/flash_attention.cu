// Flash attention forward for Hopper (sm_90a): blockwise online-softmax
// attention with an optional additive logits bias and causal masking,
//     out[b, h, i, :] = sum_j softmax_j(scale * q[b, h, i] . k[b, h, j] + bias) v[b, h, j]
// without ever writing the [T, T] score matrix to device memory, and
// optionally the log-sum-exp of each row for the backward.
//
// Replaces: deeplearning4j_tpu/ops/pallas_attention.py::_fa_kernel (launched
// by _fa_forward, entry flash_attention), which runs on the float32 upcast
// of its inputs. Same function, not a block-by-block copy: the TPU kernel
// runs a (B*H, T/bq, T/bk) grid whose innermost k axis is sequential, and
// keeps the running max, denominator and accumulator in VMEM scratch that
// persists across it. Here one thread block owns one 64-row q tile of one
// (batch, head) and walks the k tiles in a loop, so the state stays in
// registers and nothing carries between blocks.
//
// Two kernels, chosen by the wrapper (ops/attention.py) by dtype and shape,
// each with its own launch count; neither falls back to the other.
//
// 1. flash_bf16_kernel, the path's: bf16 q, k, v as they lie.
//    Bound: at the encoder's [B*H, T, D] = [384, 128, 64] it must move
//    q, k, v and out once, 25,165,824 B, 7.51 us at 3.35 TB/s, against
//    4*B*H*T*T*D = 1.61 GFLOP, 1.63 us at 989 TFLOP/s in bf16: bytes bound
//    it. So the design reads every input once in bf16, where it lies, and
//    writes bf16 once: no float32 casts and no head copies around it.
//    - Loads: thread 0 issues TMA loads (cp.async.bulk.tensor, 4-D tensor
//      maps over the [B, H, T, D] view with its own strides, e.g. the
//      [B, T, H, D] projection buffers in which the heads are a view) of
//      the block's 64-row q tiles and of 64-key k and v tiles into a ring of 2
//      stages; an mbarrier per stage reports the bytes' arrival. Boxes are
//      64 x 64 (head size x rows) with the 128-byte swizzle that the wgmma
//      descriptors name; a head size above 64 takes two boxes, one below
//      64 and rows past T arrive zero-filled.
//    - S = Q K^T: wgmma m64n64k16, both operands K-major from shared
//      memory, float32 accumulation. The scale multiplies the float32
//      scores (the JAX kernel scales q before the product: about an f32
//      ulp apart). Then the bias (read in float32 through four strides),
//      the causal mask, and -inf for keys >= T (the zero fill gives 0).
//    - The online softmax runs on the accumulator fragments in registers:
//      a thread holds 2 rows x 16 columns, so a row's max and sum are two
//      shuffles within a quad. _fa_kernel's guards are kept term for term.
//    - O += P V: P from registers as the A operand (the f32 accumulator
//      layout of S, converted pairwise, is the A fragment of the next
//      product), V MN-major from shared memory (transpose bit). P is split
//      into bf16 hi and lo parts, two wgmma each: V is exact in bf16, so O
//      keeps float32 accuracy and the kernel computes what the float32
//      upcast computes. The extra product stays under the bytes bound (3.3
//      us of bf16 tensor time for both against 7.5 us of bytes at the
//      path's shape), but not under this kernel's time: a build without it
//      ran faster, and wrong in the ninth bit.
//    - out = acc / max(l, 1e-30), as acc times the reciprocal (within a
//      float32 ulp of the quotient; 64 IEEE divisions a thread made the
//      epilogue as long as the products), rounded once to bf16 (what
//      .to(bfloat16) of the float32 result gives), written through the
//      output's strides (the wrapper's [B, T, H, D] buffer, so the head
//      merge is a view);
//      lse = safe + log(max(l, 1e-30)) in float32 [B*H, T];
//      out_f32 (optional, null when unused): the same quotient before the
//      bf16 rounding, float32 [B*H, T, D] contiguous. Autograd's forward
//      asks for it, so the backward takes D = sum(dO * O) from the float32
//      O as the JAX package's does (its residual is the float32 output of
//      the upcast); serving passes null and writes no extra byte.
//    Work split: at D <= 64 a block (one warpgroup, 128 threads) takes
//    two 64-row q tiles of one (batch, head) and walks the k tiles once
//    for both: each k/v tile is loaded once and serves both q tiles in
//    turn. At the path's shape that is 384 blocks of about 50 KB of shared
//    memory, three on an SM (registers capped at 168 a thread), so the
//    whole grid runs in one wave. With one q tile a block, 768 blocks ran
//    in two waves, and a timeline of each block (%globaltimer stamps)
//    showed the first wave waiting on its loads together and the second
//    starting only when the first ended. Above D = 64 the accumulators are
//    twice as large and a block takes one q tile. k tiles above a q
//    tile's diagonal are skipped when causal. A persistent grid (the next
//    item's loads overlapping the current one's work) measured no faster.
//    exp(x - safe) is 2^(x log2 e - safe log2 e): one FFMA and one
//    ex2.approx (relative error about 2^-22, far below the bf16 rounding
//    that follows); a build with the accurate expf ran slower. Masking
//    walks only the tiles that hold keys past T or, when causal, above the
//    diagonal.
//
// 2. flash_fwd_kernel, float32 (the parity path, and every input that the
//    bf16 kernel does not take, cast by the wrapper: float32 is DL4J's
//    default dtype): split float32 on the TF32 tensor cores (3xTF32),
//    redesigned from a plain-FFMA kernel.
//    Bound: on FFMA the work is 4*B*H*T*T*D operations at 67 TFLOP/s
//    (24.0 us at [384, 128, 64], 96.2 us at [96, 512, 64]); the old kernel
//    reached 28% and 33% of that and lost to SDPA. Only the tensor cores
//    beat it, and TF32 keeps 11 of float32's 24 bits. So each float32
//    operand x is split into hi = tf32(x) and lo = tf32(x - hi) (rounded
//    as cvt.rna rounds, to nearest, ties away, by an integer add and mask;
//    lo taken from the rounded hi, so hi + lo is x to 2^-22 of |x|), and
//    each product is three TF32 products:
//        S = Ql Kh^T + Qh Kl^T + Qh Kh^T,   O += Pl Vh + Ph Vl + Ph Vh,
//    small terms first, float32 accumulators. The dropped lo*lo term is
//    below 2^-22 of each product: float32's order, far inside the 2e-5 the
//    gates hold it to. Restated bound: three TF32 products of 4*B*H*T*T*D
//    at 495 TFLOP/s (9.8 us at the encoder's shape, 39.0 us at T = 512),
//    or q, k, v and out once over 3.35 TB/s (15.0 us / 15.0 us), whichever
//    is larger: bytes at T = 128, the tensor cores at T = 512.
//    - One warpgroup (128 threads) owns one 64-row q tile of one (batch,
//      head) and walks the 64-key tiles. All threads load each tile with
//      16-byte cp.async (rows past T and head-size elements past D arrive
//      zero-filled) into 128-byte-swizzled [64 rows][32 floats] chunks:
//      the row of 32 floats is the swizzle row, so D = 64 takes two
//      chunks and D = 128 four.
//    - The warps split the tiles in shared memory. q is multiplied by the
//      scale before its split (the JAX kernel scales q before the
//      product). Q and K stay where they landed as hi, their lo beside
//      them: both are K-major for S = Q K^T as they lie (head size
//      contiguous), which is all a TF32 wgmma takes from shared memory
//      (there is no transpose bit for 32-bit types).
//    - V is not: for P V the reduction runs over keys and V lies [keys,
//      D]. The warps transpose it while they split it, into [D rows][64
//      keys] hi and lo tiles (lane = key, so each scalar store of a warp
//      hits 32 banks).
//    - P never leaves registers. The S accumulator of a thread holds keys
//      2t and 2t + 1 of each 8-key step (t = lane % 4); the TF32 A fragment
//      wants keys t and t + 4. Rather than shuffle, the transposed V tile
//      is written with its keys permuted to match (key 2t at k-position t,
//      2t + 1 at t + 4), so P's fragments are its accumulator registers as
//      they are, split into hi and lo in place.
//    - The online softmax runs on the accumulator fragments with the bf16
//      kernel's code (_fa_kernel's guards term for term; exp as ex2.approx
//      of a fused multiply-add, about 2^-22 relative; out as o times the
//      reciprocal of max(l, 1e-30), within a float32 ulp of the quotient).
//    - Loads overlap the products: the next tile's V lands in a raw
//      buffer of its own as soon as this tile's V is split, its K where
//      its hi part will be as soon as S has read this tile's K.
//    - Shared memory at D <= 64: Q, K and V^T hi and lo and the raw V
//      tile, 113 KB: two blocks fill an SM's 228 KB (the carveout is set
//      to all shared memory), 264 q tiles at once (768 at both timed
//      shapes: three waves). At D <= 32 73 KB (three blocks); at D <= 128
//      225 KB (one).
//    Measured (chip_smoke.py and profile_port.py --flash --levers, NVIDIA
//    H100 80GB HBM3, 700 W; PERF.md has the numbers): faster than SDPA in
//    float32 at both timed shapes. The splits are a block's largest phase,
//    about a third of its cycles, ahead of the softmax with P's split and
//    of each product; waiting for loads takes a quarter at T = 128 and
//    little at T = 512 (the measurement build DL4J_FLASH_PHASES counts each
//    phase's cycles). Tried and kept out: cvt.rna.tf32.f32 for the
//    rounding (the measurement build DL4J_FLASH_CVT_RNA=1: bitwise the
//    same, 13-19% slower).
//    The FFMA design (4 x 4 register micro-tiles on 256 threads, tiles
//    transposed into shared memory by scalar stores, P through shared
//    memory, accurate expf and division) measured 0.0860 ms at [384, 128,
//    64] and 0.2924 ms at [96, 512, 64] (PERF.md, NVIDIA H100 80GB HBM3,
//    700 W), 1.16x and 1.34x SDPA's time.
//
// Numerics follow _fa_kernel: q is multiplied by the scale before the
// product; the bias is added, then causal positions qpos < kpos become -inf
// and k tiles entirely above the diagonal are skipped; safe = m if finite
// else 0, p = 0 where s is not finite, alpha = 0 where the old max is not
// finite; the output is acc / max(l, 1e-30), so a row that is -inf
// everywhere gives 0, not NaN. Both kernels take exp as ex2.approx and the
// quotient as a product with the reciprocal; the plain version
// (ops/attention.py, flash_attention_reference) sums in another order, so
// they agree within a tolerance, not bitwise.
//
// The bias is read through element strides of a [B, H, T, T] view (zero
// strides for broadcast dimensions), so a padding mask is never expanded in
// device memory.
//
// The wrapper (ops/attention.py, flash_attention_cuda) allocates out, checks
// shapes, dtypes, contiguity and alignment, launches on PyTorch's current
// stream, and raises when the launch function returns a nonzero cudaError_t.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>

#ifndef DL4J_FLASH_CVT_RNA
#define DL4J_FLASH_CVT_RNA 0
#endif

namespace {

constexpr int kTile = 64;           // q rows and keys per tile, both kernels
constexpr int kMaxD = 128;

struct Bias {
  const float* ptr;                 // null: no bias
  long long sb, sh, sq, sk;         // element strides of the [B, H, T, T] view
  int H;
};

// --- shared by both kernels: wgmma, the score tile's softmax ----------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// wgmma shared-memory descriptor of a 128-byte-swizzled operand: start
// address, leading and stride byte offsets (16-byte units), layout 1 = 128B.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  uint64_t d = 0;
  d |= static_cast<uint64_t>((addr & 0x3FFFF) >> 4);
  d |= static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16;
  d |= static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32;
  d |= static_cast<uint64_t>(1) << 62;
  return d;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keep the compiler from moving reads or writes of the accumulators across
// the asynchronous wgmma (CUTLASS's warpgroup_fence_operand).
__device__ __forceinline__ void fence_regs(float (&r)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

__device__ __forceinline__ void fence_regs(uint32_t (&r)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

#define DL4J_ACC32(d)                                                                          \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),         \
      "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), \
      "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),           \
      "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),           \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])

#define DL4J_D32                                                                            \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, " \
  "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"

constexpr float kLog2e = 1.4426950408889634f;

// 2^x by the special-function unit (relative error about 2^-22; -inf
// gives 0)
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// The online softmax of one 64 x 64 score tile in the f32 accumulator
// layout of wgmma (s[4c + e] is row e < 2 ? r0 : r1, key k0 + 8c + cp +
// (e & 1); a row's other columns lie in the three other lanes of the
// quad), turned into p in place: the bias is added, keys past T and, when
// causal, above the diagonal become -inf (only the tiles that hold such
// keys are walked for it), then _fa_kernel's guards term for term; m and l
// of the thread's two rows are updated and alpha, the factor the caller
// rescales its accumulator by, is returned. exp(x - safe) is 2^(x log2 e -
// safe log2 e), one FFMA and one ex2.approx.
template <bool CAUSAL, bool HAS_BIAS>
__device__ __forceinline__ void softmax_tile(float (&s)[32], float (&m)[2], float (&l)[2],
                                             float (&alpha)[2], int q0, int k0, int r0,
                                             int r1, int cp, const float* bias_bh,
                                             const Bias& bias, int T) {
  if (HAS_BIAS) {
#pragma unroll
    for (int c = 0; c < 8; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = e < 2 ? r0 : r1;
        const int key = k0 + 8 * c + cp + (e & 1);
        if (row < T && key < T) s[4 * c + e] += bias_bh[row * bias.sq + key * bias.sk];
      }
  }
  if (k0 + kTile > T || (CAUSAL && k0 + kTile - 1 > q0)) {
#pragma unroll
    for (int c = 0; c < 8; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = e < 2 ? r0 : r1;
        const int key = k0 + 8 * c + cp + (e & 1);
        if (key >= T || (CAUSAL && row < key)) s[4 * c + e] = -INFINITY;
      }
  }
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int i = 0; i < 32; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
  float rs[2] = {0.f, 0.f}, neg_safe_l2[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float m_new = fmaxf(m[i], quad_max(mx[i]));
    const float safe = isfinite(m_new) ? m_new : 0.f;
    neg_safe_l2[i] = -safe * kLog2e;
    alpha[i] = isfinite(m[i]) ? exp2_approx(fmaf(m[i], kLog2e, neg_safe_l2[i])) : 0.f;
    m[i] = m_new;
  }
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const float x = s[i];
    const float p = isfinite(x) ? exp2_approx(fmaf(x, kLog2e, neg_safe_l2[(i >> 1) & 1])) : 0.f;
    s[i] = p;
    rs[(i >> 1) & 1] += p;
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) l[i] = l[i] * alpha[i] + quad_sum(rs[i]);
}

namespace bf16 {

constexpr int kRows = 64;                  // q rows per block (one warpgroup)
constexpr int kKeys = kTile;               // keys per k tile
constexpr int kChunk = 64;                 // head-size elements per 128-byte row
constexpr int kStages = 2;                 // k/v tiles in flight
constexpr int kThreads = 128;              // one warpgroup
constexpr int kTileBytes = kRows * kChunk * 2;   // one [64, 64] bf16 tile: 8 KB

// Where t, h and b sit among the TMA coordinates 1..3 of one tensor map
// (coordinate 0 is the head dimension): the launcher orders the three
// outer dimensions by stride.
struct Coords {
  int t, h, b;
};

struct Maps {
  Coords q, k, v;
};

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// One [64 rows, 64 elements] box of a 4-D tensor map into shared memory,
// 128-byte swizzled; rows and elements past the tensor's end arrive as 0.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// Box of head-size chunk c at row t0 of (b, h) in a map whose outer
// coordinates are ordered as co says.
__device__ __forceinline__ void tma_tile(uint32_t dst, const CUtensorMap* map, Coords co,
                                         uint32_t bar, int c, int t0, int h, int b) {
  auto at = [&](int i) { return co.t == i ? t0 : co.h == i ? h : b; };
  tma_load(dst, map, bar, c * kChunk, at(1), at(2), at(3));
}

// d[64 x 64] (+)= A[64 x 16] B[16 x 64], both from shared memory, both
// K-major (the reduced dimension contiguous). scale_d 0 overwrites d.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da, uint64_t db,
                                         int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " DL4J_D32
      ", %32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : DL4J_ACC32(d)
      : "l"(da), "l"(db), "r"(scale_d));
}

// d[64 x 64] += A[64 x 16] B[16 x 64], A from registers (the m64k16 A
// fragment), B from shared memory MN-major (N contiguous: transpose bit).
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " DL4J_D32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : DL4J_ACC32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// Descriptors. A [64 rows, 64 elements] 128-byte-swizzled tile: row r at
// byte 128 r, 8-row groups 1024 bytes apart. K-major step kk (16 elements
// of the reduced dimension) starts 32 kk bytes into the rows; an MN-major
// step kk (16 rows of V) starts 2048 kk bytes into the tile.
__device__ __forceinline__ uint64_t desc_kmajor(uint32_t tile, int kk) {
  return smem_desc(tile + 32 * kk, 16, 1024);
}

__device__ __forceinline__ uint64_t desc_mnmajor(uint32_t tile, int kk) {
  return smem_desc(tile + 2048 * kk, kTileBytes, 1024);
}

// p (the f32 accumulator layout of the 64 x 64 score tile) as the A
// fragments of the four k16 steps of P.V, split into bf16 hi + lo parts:
// the accumulator pair (4c, 4c+1) holds row r, columns 8c + 2(lane % 4)
// + {0, 1}, and (4c+2, 4c+3) row r + 8; the A fragment of step kk wants
// rows r / r + 8 at columns 16kk + 2(lane % 4) + {0, 1} and + 8: the
// accumulator of chunks 2kk and 2kk + 1, pairwise.
__device__ __forceinline__ void split_p(const float (&p)[32], uint32_t (&hi)[4][4],
                                        uint32_t (&lo)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float a = p[8 * kk + 2 * j], b = p[8 * kk + 2 * j + 1];
      const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);   // .x (low half) = a
      const float2 hf = __bfloat1622float2(h);
      const __nv_bfloat162 r = __floats2bfloat162_rn(a - hf.x, b - hf.y);
      hi[kk][j] = *reinterpret_cast<const uint32_t*>(&h);
      lo[kk][j] = *reinterpret_cast<const uint32_t*>(&r);
    }
  }
}

struct Out {
  __nv_bfloat16* ptr;
  long long sb, sh, st;             // element strides of the [B, H, T, D] output view
  float* lse;                       // null, or [B*H, T]
  float* f32;                       // null, or the unrounded output, [B*H, T, D]
};

size_t smem_bytes(int nc, int qt) {
  return 1024 + static_cast<size_t>(nc) * kTileBytes * (qt + 2 * kStages) + 8 * (qt + kStages);
}

// One q tile against one k/v tile: S = Q K^T (wgmma from shared memory),
// scale, bias and masks, the online softmax update of (m, l, o), and
// O += P_hi V + P_lo V (P from registers). The caller has waited for the
// tiles and frees the stage afterwards.
template <int NC, bool CAUSAL, bool HAS_BIAS>
__device__ __forceinline__ void attend_tile(float (&o)[NC][32], float (&m)[2], float (&l)[2],
                                            uint32_t q_tile, uint32_t k_tile, uint32_t v_tile,
                                            int q0, int k0, int r0, int r1, int cp,
                                            const float* bias_bh, const Bias& bias, int T,
                                            float scale) {
  // S = Q K^T over the NC head-size chunks, 4 k16 steps each
  float s[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = 0.f;
  wgmma_fence();
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_ss(s, desc_kmajor(q_tile + c * kTileBytes, kk),
               desc_kmajor(k_tile + c * kTileBytes, kk), (c | kk) != 0);
  wgmma_commit();
  wgmma_wait_all();
  fence_regs(s);

  // scale (the JAX kernel scales q before the product: about an f32 ulp
  // apart), then the bias, the masks and the online softmax
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] *= scale;
  float alpha[2];
  softmax_tile<CAUSAL, HAS_BIAS>(s, m, l, alpha, q0, k0, r0, r1, cp, bias_bh, bias, T);
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) o[c][i] *= alpha[(i >> 1) & 1];

  // O += P_hi V + P_lo V: V is exact in bf16, so O keeps float32 accuracy
  uint32_t phi[4][4], plo[4][4];
  split_p(s, phi, plo);
#pragma unroll
  for (int c = 0; c < NC; ++c) fence_regs(o[c]);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const uint64_t dv = desc_mnmajor(v_tile + c * kTileBytes, kk);
      wgmma_rs(o[c], phi[kk], dv);
      wgmma_rs(o[c], plo[kk], dv);
    }
  }
  wgmma_commit();
  wgmma_wait_all();
#pragma unroll
  for (int c = 0; c < NC; ++c) fence_regs(o[c]);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    fence_regs(phi[kk]);
    fence_regs(plo[kk]);
  }
}

// o / max(l, 1e-30) of one q tile (as o times the reciprocal, within a
// float32 ulp), rounded once to bf16 and written through the output's
// strides; the log-sum-exp per row; the unrounded quotient too when the
// caller gave a float32 output.
template <int NC>
__device__ __forceinline__ void store_tile(const float (&o)[NC][32], const float (&m)[2],
                                           const float (&l)[2], const Out& out, long long bh,
                                           int b, int h, int row0, int cp, bool lse_lane, int T,
                                           int D) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + 8 * i;
    if (row >= T) continue;
    const float den = fmaxf(l[i], 1e-30f);
    const float inv = 1.f / den;
    __nv_bfloat16* orow = out.ptr + b * out.sb + h * out.sh + row * out.st;
    float* frow = out.f32 != nullptr ? out.f32 + (bh * T + row) * D : nullptr;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const int col = c * kChunk + 8 * n + cp;
        if (col < D) {
          const float2 v = make_float2(o[c][4 * n + 2 * i] * inv, o[c][4 * n + 2 * i + 1] * inv);
          *reinterpret_cast<__nv_bfloat162*>(orow + col) = __floats2bfloat162_rn(v.x, v.y);
          if (frow != nullptr) *reinterpret_cast<float2*>(frow + col) = v;
        }
      }
    }
    if (out.lse != nullptr && lse_lane)
      out.lse[bh * T + row] = (isfinite(m[i]) ? m[i] : 0.f) + logf(den);
  }
}

// QT q tiles of one (batch, head) per block, one warpgroup: each k/v tile
// is loaded once and serves them all. QT = 2 at D <= 64 (three blocks on
// an SM, registers capped at 168 a thread: 396 at once for the path's
// 384), QT = 1 above (its accumulators are twice as large). The loads are
// issued in the order the work uses them (q tile 0, k/v tile 0, the other
// q tiles, then the other k/v tiles), each q tile with its own barrier, so
// the first product starts before the block's last bytes arrive.
template <int NC, int QT, bool CAUSAL, bool HAS_BIAS>
__global__ void __launch_bounds__(kThreads, QT == 2 ? 3 : 1)
    flash_bf16_kernel(const __grid_constant__ CUtensorMap tq,
                      const __grid_constant__ CUtensorMap tk,
                      const __grid_constant__ CUtensorMap tv, Maps maps, Bias bias, Out out,
                      int H, int T, int D, float scale) {
  extern __shared__ uint8_t smem_raw[];
  // tiles 1024-byte aligned (the 128-byte swizzle repeats every 8 rows)
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t sq = base;                                  // [QT][NC][64][64]
  const uint32_t sk = sq + QT * NC * kTileBytes;             // [kStages][NC][64][64]
  const uint32_t sv = sk + kStages * NC * kTileBytes;        // [kStages][NC][64][64]
  const uint32_t qbars = sv + kStages * NC * kTileBytes;     // one per q tile
  const uint32_t kvbars = qbars + 8 * QT;                    // one per k/v stage

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int n_q = (T + kRows - 1) / kRows;
  const int n_g = (n_q + QT - 1) / QT;                       // q tile groups per (b, h)
  const long long bh = blockIdx.x / n_g;
  const int qt0 = (blockIdx.x % n_g) * QT;
  const int n_valid = min(QT, n_q - qt0);
  const int b = static_cast<int>(bh / H), h = static_cast<int>(bh % H);

  const int n_kv = (T + kKeys - 1) / kKeys;
  // k tiles of q tile t: causal ones stop at its diagonal
  auto tiles_of = [&](int t) { return CAUSAL ? min(n_kv, qt0 + t + 1) : n_kv; };
  const int n_k = tiles_of(n_valid - 1);

  if (tid == 0) {
    for (int t = 0; t < QT; ++t) mbar_init(qbars + 8 * t, 1);
    for (int s = 0; s < kStages; ++s) mbar_init(kvbars + 8 * s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  auto load_q = [&](int t) {
    const uint32_t bar = qbars + 8 * t;
    mbar_expect_tx(bar, NC * kTileBytes);
#pragma unroll
    for (int c = 0; c < NC; ++c)
      tma_tile(sq + (t * NC + c) * kTileBytes, &tq, maps.q, bar, c, (qt0 + t) * kRows, h, b);
  };
  auto load_kv = [&](int stage, int tile) {
    const uint32_t bar = kvbars + 8 * stage;
    mbar_expect_tx(bar, 2 * NC * kTileBytes);
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      tma_tile(sk + (stage * NC + c) * kTileBytes, &tk, maps.k, bar, c, tile * kKeys, h, b);
      tma_tile(sv + (stage * NC + c) * kTileBytes, &tv, maps.v, bar, c, tile * kKeys, h, b);
    }
  };

  if (tid == 0) {
    load_q(0);
    load_kv(0, 0);
    for (int t = 1; t < n_valid; ++t) load_q(t);
    for (int s = 1; s < kStages && s < n_k; ++s) load_kv(s, s);
  }

  const float* bias_bh = nullptr;
  if (HAS_BIAS) bias_bh = bias.ptr + b * bias.sb + h * bias.sh;

  // this thread's rows of a 64-row tile, and its column pair in each
  // 8-column chunk of an accumulator
  const int r_off = 16 * warp + lane / 4;
  const int cp = 2 * (lane % 4);

  float m[QT][2], l[QT][2];
  float o[QT][NC][32];
#pragma unroll
  for (int t = 0; t < QT; ++t) {
    m[t][0] = m[t][1] = -INFINITY;
    l[t][0] = l[t][1] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int i = 0; i < 32; ++i) o[t][c][i] = 0.f;
  }

  for (int j = 0; j < n_k; ++j) {
    const int stage = j % kStages;
    mbar_wait(kvbars + 8 * stage, (j / kStages) & 1);
#pragma unroll
    for (int t = 0; t < QT; ++t) {
      // a q tile past T, or (causal) one whose diagonal lies before this k tile
      if (t >= n_valid || j >= tiles_of(t)) continue;
      if (j == 0) mbar_wait(qbars + 8 * t, 0);
      const int q0 = (qt0 + t) * kRows;
      attend_tile<NC, CAUSAL, HAS_BIAS>(o[t], m[t], l[t], sq + t * NC * kTileBytes,
                                        sk + stage * NC * kTileBytes,
                                        sv + stage * NC * kTileBytes, q0, j * kKeys,
                                        q0 + r_off, q0 + r_off + 8, cp, bias_bh, bias, T,
                                        scale);
    }
    __syncthreads();                   // every warp is done with this stage
    if (tid == 0 && j + kStages < n_k) load_kv(stage, j + kStages);
  }
#pragma unroll
  for (int t = 0; t < QT; ++t)
    if (t < n_valid)
      store_tile<NC>(o[t], m[t], l[t], out, bh, b, h, (qt0 + t) * kRows + r_off, cp,
                     lane % 4 == 0, T, D);
}

// One tile: S = Q K^T (SS wgmma) and O = (P_hi + P_lo) V with P = S (RS
// wgmma), both written as float32 [64, 64]. Checks the accumulator-to-A
// register identity that the attention kernel builds on.
__global__ void __launch_bounds__(kThreads)
    layout_check_kernel(const __grid_constant__ CUtensorMap tq,
                        const __grid_constant__ CUtensorMap tk,
                        const __grid_constant__ CUtensorMap tv, Maps maps, float* s_out,
                        float* o_out) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t sq = base, sk = sq + kTileBytes, sv = sk + kTileBytes;
  const uint32_t bar = sv + kTileBytes;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  if (tid == 0) {
    mbar_init(bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(bar, 3 * kTileBytes);
    tma_tile(sq, &tq, maps.q, bar, 0, 0, 0, 0);
    tma_tile(sk, &tk, maps.k, bar, 0, 0, 0, 0);
    tma_tile(sv, &tv, maps.v, bar, 0, 0, 0, 0);
  }
  mbar_wait(bar, 0);
  float s[32], o[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = o[i] = 0.f;
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma_ss(s, desc_kmajor(sq, kk), desc_kmajor(sk, kk), kk != 0);
  wgmma_commit();
  wgmma_wait_all();
  fence_regs(s);
  uint32_t phi[4][4], plo[4][4];
  split_p(s, phi, plo);
  fence_regs(o);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    wgmma_rs(o, phi[kk], desc_mnmajor(sv, kk));
    wgmma_rs(o, plo[kk], desc_mnmajor(sv, kk));
  }
  wgmma_commit();
  wgmma_wait_all();
  fence_regs(o);
  const int r0 = 16 * warp + lane / 4, cp = 2 * (lane % 4);
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int idx = (r0 + 8 * (e >> 1)) * 64 + 8 * n + cp + (e & 1);
      s_out[idx] = s[4 * n + e];
      o_out[idx] = o[4 * n + e];
    }
}

// --- host side ---------------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled lives in libcuda.so.1, not in the CUDA runtime:
// it is looked up there with dlopen/dlsym (the runtime has loaded the
// library already), so the build needs no -lcuda.
EncodeTiled encode_fn() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_NOLOAD);
    if (lib == nullptr) lib = dlopen("libcuda.so.1", RTLD_NOW);
    if (lib != nullptr) fn = reinterpret_cast<EncodeTiled>(dlsym(lib, "cuTensorMapEncodeTiled"));
  }
  return fn;
}

constexpr int kEncodeError = 10000;       // returned as kEncodeError + CUresult

// The map of one bf16 [B, H, T, D] view with element strides st[0..2] (b,
// h, t; the head dimension is contiguous): dimension 0 is the head size,
// boxes of 64 x 64 (head size x rows), 128-byte swizzle; dimensions 1..3
// are t, h and b ordered by stride (a size-1 dimension goes last).
int encode(CUtensorMap* map, Coords* co, const void* ptr, const long long* sizes,
           const long long* strides, int D) {
  EncodeTiled fn = encode_fn();
  if (fn == nullptr) return kEncodeError + CUDA_ERROR_NOT_FOUND;
  // candidates: 0 = b, 1 = h, 2 = t
  long long span = 0;
  for (int i = 0; i < 3; ++i) span = std::max(span, sizes[i] * strides[i]);
  long long key[3];
  for (int i = 0; i < 3; ++i) key[i] = sizes[i] == 1 ? span + i : strides[i];
  int order[3] = {2, 1, 0};
  for (int i = 0; i < 3; ++i)
    for (int j = i + 1; j < 3; ++j)
      if (key[order[j]] < key[order[i]]) {
        const int x = order[i];
        order[i] = order[j];
        order[j] = x;
      }
  cuuint64_t dims[4] = {static_cast<cuuint64_t>(D), 0, 0, 0};
  cuuint64_t gstride[3];
  cuuint32_t box[4] = {static_cast<cuuint32_t>(kChunk), 1, 1, 1};
  const cuuint32_t estride[4] = {1, 1, 1, 1};
  for (int p = 0; p < 3; ++p) {
    const int which = order[p];
    dims[p + 1] = static_cast<cuuint64_t>(sizes[which]);
    // a size-1 dimension's stride is never stepped: any multiple of 16 does
    const long long st = sizes[which] == 1 ? ((span * 2 + 15) / 16) * 16 : strides[which] * 2;
    gstride[p] = static_cast<cuuint64_t>(st);
    if (which == 2) box[p + 1] = kRows;
    if (which == 0) co->b = p + 1;
    if (which == 1) co->h = p + 1;
    if (which == 2) co->t = p + 1;
  }
  const CUresult r =
      fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, gstride, box,
         estride, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
         CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kEncodeError + static_cast<int>(r);
}

template <int NC, int QT, bool CAUSAL, bool HAS_BIAS>
int launch(const CUtensorMap& tq, const CUtensorMap& tk, const CUtensorMap& tv, Maps maps,
           Bias bias, Out out, long long BH, int H, int T, int D, float scale,
           cudaStream_t stream) {
  auto kernel = flash_bf16_kernel<NC, QT, CAUSAL, HAS_BIAS>;
  const size_t bytes = smem_bytes(NC, QT);
  if (bytes > 48 * 1024) {
    // above 48 KB only after the opt-in, which holds per device
    cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (e != cudaSuccess) return (int)e;
  }
  const int n_q = (T + kRows - 1) / kRows;
  const long long blocks = BH * ((n_q + QT - 1) / QT);
  kernel<<<(unsigned)blocks, kThreads, bytes, stream>>>(tq, tk, tv, maps, bias, out, H, T, D,
                                                         scale);
  return (int)cudaGetLastError();
}

template <bool CAUSAL, bool HAS_BIAS>
int dispatch_nc(const CUtensorMap& tq, const CUtensorMap& tk, const CUtensorMap& tv,
                Maps maps, Bias bias, Out out, long long BH, int H, int T, int D, float scale,
                cudaStream_t stream) {
  if (D <= kChunk)
    return launch<1, 2, CAUSAL, HAS_BIAS>(tq, tk, tv, maps, bias, out, BH, H, T, D, scale,
                                          stream);
  return launch<2, 1, CAUSAL, HAS_BIAS>(tq, tk, tv, maps, bias, out, BH, H, T, D, scale,
                                        stream);
}

}  // namespace bf16

// ---------------------------------------------------------------------------
// The float32 route: 3xTF32 on wgmma, cp.async loads (see the note at the
// top of the file).
// ---------------------------------------------------------------------------

namespace f32 {

constexpr int kThreads = 128;              // one warpgroup, one 64-row q tile
constexpr int kChunkBytes = kTile * 128;   // [64 rows][32 floats]: 8 KB

// Byte offset of float e (0..31) of row ``row`` in a [rows][32 floats]
// chunk with the 128-byte swizzle that the wgmma descriptors name: the
// 16-byte unit e / 4 of each row XORed with row % 8.
__device__ __forceinline__ uint32_t swz(int row, int e) {
  return row * 128 + ((((e >> 2) ^ row) & 7) << 4) + (e & 3) * 4;
}

// x rounded to TF32 as cvt.rna.tf32.f32 rounds it (to nearest, ties away
// from zero; the 13 low bits cleared), as a float: half the kept last place
// added to the sign-magnitude bits, the rest cleared. Bitwise the same as
// cvt.rna on the card, which issues on the slower conversion pipe (the
// measurement build DL4J_FLASH_CVT_RNA=1 takes cvt.rna).
__device__ __forceinline__ float tf32(float x) {
#if DL4J_FLASH_CVT_RNA
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return __uint_as_float(r);
#else
  return __uint_as_float((__float_as_uint(x) + 0x1000u) & 0xffffe000u);
#endif
}

#ifdef DL4J_FLASH_PHASES
// Measurement build only (profile_port.py --flash --levers): thread 0 of
// each block adds up the clock64 cycles of the k-tile loop's phases (the
// loads' wait and the barrier; the splits; S; the softmax and P's split;
// O) and stores them in phases[block * 5 + 0..4].
__device__ long long* g_phases = nullptr;

__device__ __forceinline__ long long clock_now() {
  long long t;
  asm volatile("mov.u64 %0, %%clock64;" : "=l"(t)::"memory");
  return t;
}
#define DL4J_PHASE_START() \
  long long phase_t0 = clock_now(), phase_sum[5] = {0, 0, 0, 0, 0}
#define DL4J_PHASE(i)                    \
  do {                                   \
    const long long t = clock_now();     \
    phase_sum[i] += t - phase_t0;        \
    phase_t0 = t;                        \
  } while (0)
#define DL4J_PHASE_STORE()                                                          \
  do {                                                                              \
    if (g_phases != nullptr && threadIdx.x == 0)                                    \
      for (int i = 0; i < 5; ++i) g_phases[blockIdx.x * 5LL + i] = phase_sum[i];   \
  } while (0)
#else
#define DL4J_PHASE_START() ((void)0)
#define DL4J_PHASE(i) ((void)0)
#define DL4J_PHASE_STORE() ((void)0)
#endif

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// wgmma's reads of shared memory (the async proxy) see the threads' stores
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// d[64 x 64] (+)= A[64 x 8] B[8 x 64] in TF32, both from shared memory,
// K-major (the only layout a 32-bit wgmma operand takes). scale_d 0
// overwrites d.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da, uint64_t db,
                                         int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 " DL4J_D32
      ", %32, %33, p, 1, 1;\n"
      "}\n"
      : DL4J_ACC32(d)
      : "l"(da), "l"(db), "r"(scale_d));
}

// d[64 x 64] += A[64 x 8] B[8 x 64] in TF32, A from registers (the m64k8
// fragment: a0 row r, k t; a1 row r + 8, k t; a2 row r, k t + 4; a3 row
// r + 8, k t + 4), B K-major from shared memory.
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 " DL4J_D32
      ", {%32, %33, %34, %35}, %36, p, 1, 1;\n"
      "}\n"
      : DL4J_ACC32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// K-major step kk (8 floats of the reduced dimension) of a chunk: 32 kk
// bytes into its rows, 8-row groups 1024 bytes apart
__device__ __forceinline__ uint64_t desc(uint32_t chunk, int kk) {
  return smem_desc(chunk + 32 * kk, 16, 1024);
}

// A [64, D] tile of rows row0.. of a [T, D] float32 matrix into NC chunks
// at dst, 16 bytes a cp.async, consecutive threads on consecutive bytes;
// rows past T and elements past D arrive as 0. The caller commits and
// waits.
template <int NC>
__device__ __forceinline__ void load_tile(uint32_t dst, const float* src, int row0, int T,
                                          int D) {
  constexpr int kGroups = NC * 8;          // 16-byte groups of a row
#pragma unroll
  for (int i = 0; i < 4 * NC; ++i) {
    const int idx = i * kThreads + threadIdx.x;
    const int row = idx / kGroups, g = idx % kGroups;
    const bool ok = row0 + row < T && 4 * g < D;
    const float* p = ok ? src + static_cast<long long>(row0 + row) * D + 4 * g : src;
    cp_async16(dst + (g / 8) * kChunkBytes + swz(row, 4 * (g % 8)), p, ok ? 16 : 0);
  }
}

// This thread's share of a tile in the splits: row (q row or key) ``row``
// and the 16-byte groups g0, g0 + 2, ... (lane = row: the 8 lanes of a
// 16-byte access hit 8 different units, and the transposed scalar stores of
// V 32 different banks).
//
// The split of a Q or K tile in place: x * mul as hi where it landed, its
// lo at the same offset of ``lo``.
template <int NC>
__device__ __forceinline__ void split_rows(uint8_t* hi, uint8_t* lo, int row, int g0,
                                           float mul) {
#pragma unroll
  for (int i = 0; i < 4 * NC; ++i) {
    const int g = g0 + 2 * i;
    const uint32_t off = (g / 8) * kChunkBytes + swz(row, 4 * (g % 8));
    const float4 x = *reinterpret_cast<const float4*>(hi + off);
    const float4 xs = make_float4(x.x * mul, x.y * mul, x.z * mul, x.w * mul);
    const float4 h = make_float4(tf32(xs.x), tf32(xs.y), tf32(xs.z), tf32(xs.w));
    *reinterpret_cast<float4*>(hi + off) = h;
    *reinterpret_cast<float4*>(lo + off) = make_float4(
        tf32(xs.x - h.x), tf32(xs.y - h.y), tf32(xs.z - h.z), tf32(xs.w - h.w));
  }
}

// k-position of key o (0..31) of a 32-key chunk in the transposed V tile:
// step o / 8, and in it 2t -> t, 2t + 1 -> t + 4, so that the P fragment
// of step kk is the S accumulator's registers 4kk, 4kk + 2, 4kk + 1, 4kk +
// 3 as they are (a thread holds keys 2t and 2t + 1 of each 8-key step)
__device__ __forceinline__ int v_pos(int o) {
  return (o & ~7) + ((o & 7) >> 1) + 4 * (o & 1);
}

// Byte offset of (head-size element d, key) in the transposed V tile: NO
// column blocks of 64 d rows, each two 32-key chunks.
__device__ __forceinline__ uint32_t vt_off(int d, int key) {
  return ((d >> 6) * 2 + (key >> 5)) * kChunkBytes + swz(d & 63, v_pos(key & 31));
}

// The split of a V tile that landed as rows in ``raw`` into its
// transposed hi (``vt_hi``) and lo (``vt_lo``) tiles.
template <int NC>
__device__ __forceinline__ void split_v(const uint8_t* raw, uint8_t* vt_hi, uint8_t* vt_lo,
                                        int key, int g0) {
#pragma unroll
  for (int i = 0; i < 4 * NC; ++i) {
    const int g = g0 + 2 * i;
    const float4 x = *reinterpret_cast<const float4*>(
        raw + (g / 8) * kChunkBytes + swz(key, 4 * (g % 8)));
    const float xs[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float h = tf32(xs[e]);
      const uint32_t off = vt_off(4 * g + e, key);
      *reinterpret_cast<float*>(vt_hi + off) = h;
      *reinterpret_cast<float*>(vt_lo + off) = tf32(xs[e] - h);
    }
  }
}

// hi and lo parts of x as TF32 bit patterns
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  const float h = tf32(x);
  hi = __float_as_uint(h);
  lo = __float_as_uint(tf32(x - h));
}

// Q, K hi and lo, V^T hi and lo, and the raw V tile in flight: at D <= 64
// 1024 + 14 x 8 KB = 113 KB, two blocks on an SM's 228 KB with their 1 KB
// each
size_t smem_bytes(int nc) {
  const int no = nc == 4 ? 2 : 1;
  return 1024 + static_cast<size_t>(kChunkBytes) * (5 * nc + 4 * no);
}

// One 64-row q tile of one (batch, head) per block; NC 32-float chunks of
// the head size (1, 2 or 4), NO 64-column blocks of the output.
template <int NC, bool CAUSAL, bool HAS_BIAS>
__global__ void __launch_bounds__(kThreads, NC == 4 ? 1 : 2)
    flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, Bias bias, float* __restrict__ out,
                     float* __restrict__ lse, int T, int D, float scale) {
  constexpr int NO = NC == 4 ? 2 : 1;
  extern __shared__ uint8_t smem_raw[];
  // chunks 1024-byte aligned (the 128-byte swizzle repeats every 8 rows)
  uint8_t* sm = smem_raw + ((1024u - (smem_addr(smem_raw) & 1023u)) & 1023u);
  const uint32_t base = smem_addr(sm);
  constexpr uint32_t oQh = 0, oQl = NC * kChunkBytes;
  constexpr uint32_t oKh = 2 * NC * kChunkBytes, oKl = 3 * NC * kChunkBytes;
  constexpr uint32_t oVh = 4 * NC * kChunkBytes, oVl = oVh + 2 * NO * kChunkBytes;
  constexpr uint32_t oVr = oVl + 2 * NO * kChunkBytes;      // the raw V tile

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int n_q = (T + kTile - 1) / kTile;
  const long long bh = blockIdx.x / n_q;
  const int q0 = static_cast<int>(blockIdx.x % n_q) * kTile;
  const long long off = bh * T * D;
  const float* bias_bh = nullptr;
  if (HAS_BIAS) bias_bh = bias.ptr + (bh / bias.H) * bias.sb + (bh % bias.H) * bias.sh;

  const int n_kv = (T + kTile - 1) / kTile;
  const int n_k = CAUSAL ? min(n_kv, q0 / kTile + 1) : n_kv;   // skip tiles above the diagonal

  // the splits' share (split_rows), and this thread's rows of a 64-row
  // accumulator and its column pair in each 8-column chunk
  const int srow = 32 * (warp & 1) + lane, sg0 = warp >> 1;
  const int r0 = q0 + 16 * warp + lane / 4, r1 = r0 + 8;
  const int cp = 2 * (lane % 4);

  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float o[NO][32];
#pragma unroll
  for (int c = 0; c < NO; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) o[c][i] = 0.f;

  // K lands where its hi part will be, V in a buffer of its own; the next
  // tile's V is loaded while this one's products run, its K once S is done
  DL4J_PHASE_START();
  load_tile<NC>(base + oQh, q + off, q0, T, D);
  load_tile<NC>(base + oKh, k + off, 0, T, D);
  load_tile<NC>(base + oVr, v + off, 0, T, D);
  cp_async_commit();
  for (int j = 0; j < n_k; ++j) {
    const int k0 = j * kTile;
    const bool more = j + 1 < n_k;
    cp_async_wait_all();
    __syncthreads();                       // tile j has landed; tile j - 1 is done
    DL4J_PHASE(0);
    if (j == 0) split_rows<NC>(sm + oQh, sm + oQl, srow, sg0, scale);
    split_rows<NC>(sm + oKh, sm + oKl, srow, sg0, 1.f);
    split_v<NC>(sm + oVr, sm + oVh, sm + oVl, srow, sg0);
    fence_proxy_async();
    __syncthreads();
    if (more) {
      load_tile<NC>(base + oVr, v + off, k0 + kTile, T, D);
      cp_async_commit();
    }
    DL4J_PHASE(1);

    // S = Ql Kh^T + Qh Kl^T + Qh Kh^T over NC chunks of 4 k8 steps
    float s[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint32_t qc = base + c * kChunkBytes, kc = qc + oKh;
        wgmma_ss(s, desc(qc + oQl, kk), desc(kc, kk), (c | kk) != 0);
        wgmma_ss(s, desc(qc + oQh, kk), desc(kc + NC * kChunkBytes, kk), 1);
      }
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint32_t qc = base + c * kChunkBytes;
        wgmma_ss(s, desc(qc + oQh, kk), desc(qc + oKh, kk), 1);
      }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);
    __syncthreads();                       // every warp's S has read K
    if (more) {
      load_tile<NC>(base + oKh, k + off, k0 + kTile, T, D);
      cp_async_commit();
    }
    DL4J_PHASE(2);

    float alpha[2];
    softmax_tile<CAUSAL, HAS_BIAS>(s, m, l, alpha, q0, k0, r0, r1, cp, bias_bh, bias, T);
#pragma unroll
    for (int c = 0; c < NO; ++c)
#pragma unroll
      for (int i = 0; i < 32; ++i) o[c][i] *= alpha[(i >> 1) & 1];

    // O += Pl Vh + Ph Vl + Ph Vh: P's fragments are its accumulator
    // registers (see v_pos), split in place
    uint32_t ph[8][4], pl[8][4];
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      split(s[4 * kk], ph[kk][0], pl[kk][0]);
      split(s[4 * kk + 2], ph[kk][1], pl[kk][1]);
      split(s[4 * kk + 1], ph[kk][2], pl[kk][2]);
      split(s[4 * kk + 3], ph[kk][3], pl[kk][3]);
    }
#pragma unroll
    for (int c = 0; c < NO; ++c) fence_regs(o[c]);
    DL4J_PHASE(3);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 8; ++kk)
#pragma unroll
      for (int c = 0; c < NO; ++c) {
        const uint32_t vc = base + (c * 2 + kk / 4) * kChunkBytes;
        wgmma_rs(o[c], pl[kk], desc(vc + oVh, kk % 4));
        wgmma_rs(o[c], ph[kk], desc(vc + oVl, kk % 4));
      }
#pragma unroll
    for (int kk = 0; kk < 8; ++kk)
#pragma unroll
      for (int c = 0; c < NO; ++c) {
        const uint32_t vc = base + (c * 2 + kk / 4) * kChunkBytes;
        wgmma_rs(o[c], ph[kk], desc(vc + oVh, kk % 4));
      }
    wgmma_commit();
    wgmma_wait_all();
#pragma unroll
    for (int c = 0; c < NO; ++c) fence_regs(o[c]);
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      fence_regs(ph[kk]);
      fence_regs(pl[kk]);
    }
    DL4J_PHASE(4);
  }
  DL4J_PHASE_STORE();

  // out = o / max(l, 1e-30) (as o times the reciprocal), float32 [B*H, T, D]
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = i == 0 ? r0 : r1;
    if (row >= T) continue;
    const float den = fmaxf(l[i], 1e-30f);
    const float inv = 1.f / den;
    float* orow = out + off + static_cast<long long>(row) * D;
#pragma unroll
    for (int c = 0; c < NO; ++c)
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const int col = 64 * c + 8 * n + cp;
        if (col < D)
          *reinterpret_cast<float2*>(orow + col) =
              make_float2(o[c][4 * n + 2 * i] * inv, o[c][4 * n + 2 * i + 1] * inv);
      }
    if (lse != nullptr && lane % 4 == 0)
      lse[bh * T + row] = (isfinite(m[i]) ? m[i] : 0.f) + logf(den);
  }
}

template <int NC, bool CAUSAL, bool HAS_BIAS>
int launch(const float* q, const float* k, const float* v, Bias bias, float* out, float* lse,
           long long BH, int T, int D, float scale, cudaStream_t stream) {
  auto kernel = flash_fwd_kernel<NC, CAUSAL, HAS_BIAS>;
  const size_t bytes = smem_bytes(NC);
  // above 48 KB only after the opt-in, which holds per device
  cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  // all of the SM's 228 KB to shared memory: two blocks need every byte
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout, 100);
  if (e != cudaSuccess) return (int)e;
  const long long blocks = BH * ((T + kTile - 1) / kTile);
  kernel<<<(unsigned)blocks, kThreads, bytes, stream>>>(q, k, v, bias, out, lse, T, D, scale);
  return (int)cudaGetLastError();
}

template <bool CAUSAL, bool HAS_BIAS>
int dispatch_nc(const float* q, const float* k, const float* v, Bias bias, float* out,
                float* lse, long long BH, int T, int D, float scale, cudaStream_t stream) {
  if (D <= 32) return launch<1, CAUSAL, HAS_BIAS>(q, k, v, bias, out, lse, BH, T, D, scale, stream);
  if (D <= 64) return launch<2, CAUSAL, HAS_BIAS>(q, k, v, bias, out, lse, BH, T, D, scale, stream);
  return launch<4, CAUSAL, HAS_BIAS>(q, k, v, bias, out, lse, BH, T, D, scale, stream);
}

}  // namespace f32


}  // namespace

extern "C" {

// q, k, v, out: [BH, T, D] float32, contiguous, 16-byte aligned; D a
// multiple of 4 in [4, 128]. bias: null, or float32 read at
// b*sb + h*sh + i*sq + j*sk for bh = b*H + h (element strides of a
// [BH/H, H, T, T] view). lse: null, or float32 [BH, T] that receives
// safe + log(max(l, 1e-30)) per row. Returns the launch's cudaError_t.
int dl4j_flash_attention_fwd(const void* q, const void* k, const void* v, const void* bias,
                             long long sb, long long sh, long long sq, long long sk, int H,
                             void* out, void* lse, int BH, int T, int D, float scale,
                             int causal, void* stream) {
  if (BH <= 0 || T <= 0) return 0;
  if (D < 4 || D > kMaxD || D % 4 != 0 || H <= 0 || BH % H != 0 ||
      static_cast<long long>(BH) * ((T + kTile - 1) / kTile) >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* qp = static_cast<const float*>(q);
  const float* kp = static_cast<const float*>(k);
  const float* vp = static_cast<const float*>(v);
  float* op = static_cast<float*>(out);
  float* lp = static_cast<float*>(lse);
  Bias b{static_cast<const float*>(bias), sb, sh, sq, sk, H};
  if (b.ptr) {
    if (causal) return f32::dispatch_nc<true, true>(qp, kp, vp, b, op, lp, BH, T, D, scale, st);
    return f32::dispatch_nc<false, true>(qp, kp, vp, b, op, lp, BH, T, D, scale, st);
  }
  if (causal) return f32::dispatch_nc<true, false>(qp, kp, vp, b, op, lp, BH, T, D, scale, st);
  return f32::dispatch_nc<false, false>(qp, kp, vp, b, op, lp, BH, T, D, scale, st);
}

// q, k, v: bf16 [B, H, T, D] views, each with its own element strides
// (b, h, t; the head dimension contiguous), 16-byte aligned, strides of
// dimensions longer than 1 positive multiples of 8; D a multiple of 8 in
// [8, 128]. geom: B, H, T, D, then the strides of q, k, v and out (3
// each). out: bf16, written through its strides. bias: null, or float32
// read at b*sb + h*sh + i*sq + j*sk. lse: null, or float32 [B*H, T].
// out_f32: null, or float32 [B*H, T, D] contiguous, 8-byte aligned, that
// receives the output before its rounding to bf16.
// Returns the launch's cudaError_t, or 10000 + the CUresult of a tensor
// map that could not be encoded.
int dl4j_flash_attention_bf16_fwd(const void* q, const void* k, const void* v,
                                  const long long* geom, const void* bias, long long sb,
                                  long long sh, long long sq, long long sk, void* out,
                                  void* lse, void* out_f32, float scale, int causal,
                                  void* stream) {
  const long long B = geom[0], H = geom[1], T = geom[2], D = geom[3];
  if (B <= 0 || H <= 0 || T <= 0) return 0;
  if (D < 8 || D > kMaxD || D % 8 != 0 || T >= (1LL << 31) ||
      B * H * ((T + bf16::kRows - 1) / bf16::kRows) >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  const long long sizes[3] = {B, H, T};
  CUtensorMap tq, tk, tv;
  bf16::Maps maps;
  int err = bf16::encode(&tq, &maps.q, q, sizes, geom + 4, (int)D);
  if (err == 0) err = bf16::encode(&tk, &maps.k, k, sizes, geom + 7, (int)D);
  if (err == 0) err = bf16::encode(&tv, &maps.v, v, sizes, geom + 10, (int)D);
  if (err != 0) return err;
  bf16::Out o{static_cast<__nv_bfloat16*>(out), geom[13], geom[14], geom[15],
              static_cast<float*>(lse), static_cast<float*>(out_f32)};
  Bias b{static_cast<const float*>(bias), sb, sh, sq, sk, (int)H};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long BH = B * H;
  const int t = (int)T, d = (int)D, h = (int)H;
  if (b.ptr) {
    if (causal) return bf16::dispatch_nc<true, true>(tq, tk, tv, maps, b, o, BH, h, t, d, scale, st);
    return bf16::dispatch_nc<false, true>(tq, tk, tv, maps, b, o, BH, h, t, d, scale, st);
  }
  if (causal) return bf16::dispatch_nc<true, false>(tq, tk, tv, maps, b, o, BH, h, t, d, scale, st);
  return bf16::dispatch_nc<false, false>(tq, tk, tv, maps, b, o, BH, h, t, d, scale, st);
}

// One tile of the bf16 kernel's two products: q, k, v bf16 [64, 64]
// contiguous and 16-byte aligned; s_out = q k^T and o_out = (p_hi + p_lo) v
// with p = s_out, both float32 [64, 64].
int dl4j_flash_bf16_layout_check(const void* q, const void* k, const void* v, void* s_out,
                                 void* o_out, void* stream) {
  const long long sizes[3] = {1, 1, 64};
  const long long strides[3] = {64 * 64, 64 * 64, 64};
  CUtensorMap tq, tk, tv;
  bf16::Maps maps;
  int err = bf16::encode(&tq, &maps.q, q, sizes, strides, 64);
  if (err == 0) err = bf16::encode(&tk, &maps.k, k, sizes, strides, 64);
  if (err == 0) err = bf16::encode(&tv, &maps.v, v, sizes, strides, 64);
  if (err != 0) return err;
  const size_t bytes = 1024 + 3 * bf16::kTileBytes + 64;
  bf16::layout_check_kernel<<<1, bf16::kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(
      tq, tk, tv, maps, static_cast<float*>(s_out), static_cast<float*>(o_out));
  return (int)cudaGetLastError();
}

#ifdef DL4J_FLASH_PHASES
// phases: [blocks * 5] 64-bit words on the card, or null to stop
int dl4j_flash_phases(void* phases) {
  return (int)cudaMemcpyToSymbol(f32::g_phases, &phases, sizeof(phases));
}
#endif

const char* dl4j_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
