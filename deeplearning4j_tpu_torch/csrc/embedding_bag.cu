// Embedding bag for Hopper (sm_90a): the masked sum or mean of the W table
// rows that each bag gathers,
//     out[b, :] = (sum_w table[idx[b, w], :] * mask[b, w]) [/ counts[b]]
//
// Replaces: deeplearning4j_tpu/ops/embeddings.py::_bag_kernel (launched by
// _bag_pallas, entry embedding_bag). Same function, not a block-by-block
// copy: the TPU kernel runs a sequential (B, W) grid whose index map DMAs one
// row per step into VMEM and carries the sum in the revisited output block.
// Here one warp owns one bag and keeps the sum in registers, so nothing
// carries between blocks and the [B, W, D] gather never reaches device
// memory.
//
// Bound: memory. Per gathered element one multiply and one add, against 4
// bytes read; the least traffic is the indices, the mask, the counts, the
// output and each distinct row once. Rows that recur (a zipf corpus repeats
// its head words thousands of times per round) come from L2 or L1, but a
// lookup whose SM's L1 does not hold its row moves it from L2: at the CBOW
// path's shape up to 32.8 MB against the 7.5 MB the bound counts. A warp
// timeline (profile_port.py --bag --timeline) shows the warps waiting on
// those rows and, before them, on their indices.
//
// - Indices off the chain. Lane w loads idx[b, w] and mask[b, w] in one
//   coalesced load (chunks of 32 when W > 32); the warp then
//   broadcasts them with __shfl_sync, and every lane issues its row loads
//   for K = 4 indices back to back before it sums them, in W order, from
//   registers: no index load waits between two row loads.
// - Occupancy over rows in flight. K rows of float4 take 4K registers a
//   lane; more rows per warp meant fewer warps per SM and more waves, and
//   measured slower. K = 4 in 32 registers keeps 64 warps on each SM: the
//   CBOW path's 8192 bags, one per warp, run in a single wave.
// - Default caching. Reading the rows under an L2 evict_last policy
//   (createpolicy + ld.global.nc.L2::cache_hint) and the indices, the mask,
//   the counts and the output as streaming data (ld/st .cs) made the kernel
//   alone 10% faster from a cold L2, but the CBOW block's device time rose
//   by 0.11 ms: the pinned table and the evicted output slowed the round's
//   other kernels (index_add_ on that table, the ops that read the output),
//   while the kernel itself ran no faster inside the round. So the rows are
//   read through the read-only path under the evict_normal policy, and
//   everything else is cached as usual.
// - Lanes: lane l covers row elements [4l, 4l+4) with 16-byte loads when
//   D % 4 == 0 and the table and output are 16-byte aligned (then every row
//   is), element l otherwise, striding by 32 vectors for wide rows.
//
// Measurement builds (profile_port.py --bag --levers, --word2vec
// --bag-build) override the design's choices with -D: DL4J_BAG_ROWS (rows
// in flight), DL4J_BAG_VEC (floats per lane load on the vector route, 4 or
// 2), DL4J_BAG_L2_KEEP_BYTES (the largest table whose rows are read under
// evict_last; 0: none), DL4J_BAG_STREAM (1: indices, mask, counts and
// output streamed, .cs), DL4J_BAG_TIMELINE (a warp timeline, below).
//
// Numerics: each term is __fadd_rn(acc, __fmul_rn(row, mask)), in W order
// from acc = 0, then __fdiv_rn(acc, count) for the mean: the same roundings,
// in the same order, as the plain version (ops/embeddings.py,
// embedding_bag_reference), so the two agree bit for bit. The intrinsics stop
// nvcc from contracting the multiply-add into an FMA. Masked terms are
// computed as well (row * 0), as the plain version does.
//
// The bf16 route (dl4j_embedding_bag_bf16), in its own design: a bf16
// table, mask and counts, bf16 output, as the Pallas kernel runs in the
// table's dtype. Each product and each sum is rounded to bf16 (round to
// nearest even) before the next step, and so is the quotient, as PyTorch's
// bf16 operations in the plain version round them: the product of two bf16
// values and a float sum or quotient of bf16 values, rounded once more to
// bf16, are the correctly rounded bf16 results (the float result never
// lands on a bf16 tie that the exact one is not on), so kernel and plain
// version agree bit for bit.
// - Bound: the bytes, half the float route's (1.17 us at the CBOW path's
//   [8192, 10] x [10000, 100]); a launch's fixed cost of about 3.7 us sits
//   inside every timed launch. Built on the float route's loop it took
//   0.0140 ms against the float route's 0.0112 at the same shape: a term
//   was multiply, round, add, round in float registers, six instructions
//   an element where the float route spends two, and at D = 100 the
//   200-byte rows (8-byte aligned) take 25 lanes of 8-byte loads, as many
//   loads as the float route's 16-byte ones, four rows in flight a warp.
// - Arithmetic: the values stay packed, two a 32-bit word, from the load
//   to the store; a term is mul.rn.bf16x2 then add.rn.bf16x2 (the
//   correctly rounded product and sum), one instruction for every two
//   elements and steps; the mask travels as its bf16 in both halves. Only
//   the mean's quotient unpacks (float division, rounded to bf16).
//   Measurement builds: DL4J_BAG_PAIRS=0 runs every shape on the float
//   route's loops, DL4J_BAG_PAIR_WORDS sets the registers of rows in flight
//   in the paired layout (44: 11 rows of D = 100).
// - Layout (W <= 16 and at most 32 row vectors: the CBOW path, PV-DM's W =
//   11): two bags a warp, 16 lanes each (embedding_bag_pairs_kernel). A
//   lane covers vectors l and l + 16 of its row, the warp's two index
//   chunks arrive in one coalesced load of 2W indices, and each half keeps
//   all of a W <= 11 chunk's rows in flight (44 registers of rows) before
//   its first sum, where the float route's loop kept 4. Two bags a warp
//   halve the warps, so the CBOW path's 8192 bags still run in one wave at
//   that register count. Wider rows and W > 16 keep the float route's
//   loops (kPasses, kChunks), on the packed arithmetic.
// - Rows are read as 16-byte vectors of 8 bf16 values when D % 8 == 0 and
//   the table and output are 16-byte aligned, else 8-byte vectors of 4 (D %
//   4 == 0: the CBOW path's D = 100), 4-byte pairs or single values.
// Measured (profile_port.py --bag, NVIDIA H100 80GB HBM3, 700 W; cold L2,
// then warm): at [8192, 10] x [10000, 100] 0.0097 / 0.0089 ms against the
// float route's loop on bf16 values' 0.0141 / 0.0133 and the float32
// route's 0.0111 / 0.0101 on the same values; the bag's time in a
// bf16-table CBOW block of 64 rounds 0.325 ms against 0.610. Measurement
// builds, each slower (profile_port.py --bag --levers): DL4J_BAG_PAIRS=0,
// one bag a warp on the float route's loop with the packed arithmetic
// (0.0104 / 0.0098: the arithmetic is most of the gain);
// DL4J_BAG_PAIR_WORDS=24, 6 rows in flight (0.0103 / 0.0096); 64, 16 rows
// (0.0121 / 0.0109: fewer warps resident). The chosen build's timeline
// (--timeline) shows a bag's rows arriving 2.3 us after its indices at the
// median, against 3.8 us on the float32 route.
//
// Indices are clamped to [0, V-1] and row offsets are 64-bit.
//
// The wrapper (ops/embeddings.py, embedding_bag_cuda) allocates out, checks
// shapes, dtypes and contiguity, launches on PyTorch's current stream, and
// raises when the launch function returns a nonzero cudaError_t.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

#ifndef DL4J_BAG_ROWS
#define DL4J_BAG_ROWS 4
#endif
#ifndef DL4J_BAG_VEC
#define DL4J_BAG_VEC 4
#endif
#ifndef DL4J_BAG_L2_KEEP_BYTES
#define DL4J_BAG_L2_KEEP_BYTES 0
#endif
#ifndef DL4J_BAG_STREAM
#define DL4J_BAG_STREAM 0
#endif
#ifndef DL4J_BAG_PAIRS
#define DL4J_BAG_PAIRS 1
#endif
#ifndef DL4J_BAG_PAIR_WORDS
#define DL4J_BAG_PAIR_WORDS 44
#endif

constexpr int kWarp = 32;
constexpr int kThreads = 256;
constexpr int kBagsPerBlock = kThreads / kWarp;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kRows = DL4J_BAG_ROWS;  // row loads in flight per lane
constexpr int kVec = DL4J_BAG_VEC;    // floats per lane load, vector route
constexpr long long kKeepBytes = DL4J_BAG_L2_KEEP_BYTES;
constexpr bool kPairs = DL4J_BAG_PAIRS != 0;  // the bf16 route's two bags a warp
constexpr int kPairWords = DL4J_BAG_PAIR_WORDS;  // its registers for rows in flight
static_assert(kVec == 4 || kVec == 2, "vector route: float4 or float2");
static_assert(kRows >= 1, "rows in flight");

__device__ __forceinline__ uint64_t l2_policy(bool keep) {
  uint64_t p;
  if (keep)
    asm("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;" : "=l"(p));
  else
    asm("createpolicy.fractional.L2::evict_normal.b64 %0, 1.0;" : "=l"(p));
  return p;
}

// one row vector of VEC floats through the read-only path, with the L2
// policy ``pol``
template <int VEC>
__device__ __forceinline__ void load_row(const float* p, uint64_t pol,
                                         float (&t)[VEC]) {
  if constexpr (VEC == 4) {
    asm("ld.global.nc.L2::cache_hint.v4.f32 {%0, %1, %2, %3}, [%4], %5;"
        : "=f"(t[0]), "=f"(t[1]), "=f"(t[2]), "=f"(t[3])
        : "l"(p), "l"(pol));
  } else if constexpr (VEC == 2) {
    asm("ld.global.nc.L2::cache_hint.v2.f32 {%0, %1}, [%2], %3;"
        : "=f"(t[0]), "=f"(t[1])
        : "l"(p), "l"(pol));
  } else {
    asm("ld.global.nc.L2::cache_hint.f32 %0, [%1], %2;"
        : "=f"(t[0])
        : "l"(p), "l"(pol));
  }
}

// one row vector of VEC bf16 values (their bits, uint16_t) through the
// read-only path, kept packed: two values a 32-bit word, the lower address
// in the low half
template <int VEC>
__device__ __forceinline__ void load_row(const uint16_t* p, uint64_t pol,
                                         uint32_t (&t)[(VEC + 1) / 2]) {
  if constexpr (VEC == 8) {
    asm("ld.global.nc.L2::cache_hint.v4.u32 {%0, %1, %2, %3}, [%4], %5;"
        : "=r"(t[0]), "=r"(t[1]), "=r"(t[2]), "=r"(t[3])
        : "l"(p), "l"(pol));
  } else if constexpr (VEC == 4) {
    asm("ld.global.nc.L2::cache_hint.v2.u32 {%0, %1}, [%2], %3;"
        : "=r"(t[0]), "=r"(t[1])
        : "l"(p), "l"(pol));
  } else if constexpr (VEC == 2) {
    asm("ld.global.nc.L2::cache_hint.u32 %0, [%1], %2;"
        : "=r"(t[0])
        : "l"(p), "l"(pol));
  } else {
    unsigned short h;
    asm("ld.global.nc.L2::cache_hint.u16 %0, [%1], %2;"
        : "=h"(h)
        : "l"(p), "l"(pol));
    t[0] = h;
  }
}

// a bf16 value (its bits) as a float: exact
__device__ __forceinline__ float bf16_bits_to_float(uint32_t bits16) {
  return __uint_as_float(bits16 << 16);
}

// x rounded to the nearest bf16 value (ties to even), as a float
__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// data read or written once: streaming (.cs) when DL4J_BAG_STREAM is 1
template <typename T>
__device__ __forceinline__ T ld_once(const T* p) {
  return DL4J_BAG_STREAM ? __ldcs(p) : *p;
}
template <typename T>
__device__ __forceinline__ void st_once(T* p, T v) {
  if constexpr (DL4J_BAG_STREAM)
    __stcs(p, v);
  else
    *p = v;
}

template <int VEC>
__device__ __forceinline__ void store_out(float* p, const float (&a)[VEC]) {
  if constexpr (VEC == 4) {
    st_once(reinterpret_cast<float4*>(p),
            make_float4(a[0], a[1], a[2], a[3]));
  } else if constexpr (VEC == 2) {
    st_once(reinterpret_cast<float2*>(p), make_float2(a[0], a[1]));
  } else {
    st_once(p, a[0]);
  }
}

// two bf16-valued floats packed into a word, the first in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  return (__float_as_uint(lo) >> 16) | (__float_as_uint(hi) & 0xffff0000u);
}

// VEC bf16 values, packed two a word as they were loaded, stored
template <int VEC>
__device__ __forceinline__ void store_out(uint16_t* p, const uint32_t (&a)[(VEC + 1) / 2]) {
  if constexpr (VEC == 8) {
    st_once(reinterpret_cast<uint4*>(p), make_uint4(a[0], a[1], a[2], a[3]));
  } else if constexpr (VEC == 4) {
    st_once(reinterpret_cast<uint2*>(p), make_uint2(a[0], a[1]));
  } else if constexpr (VEC == 2) {
    st_once(reinterpret_cast<unsigned int*>(p), a[0]);
  } else {
    st_once(reinterpret_cast<unsigned short*>(p), (unsigned short)(a[0] & 0xffffu));
  }
}

// The arithmetic of each route on one lane's vector of VEC elements: the
// registers a row vector takes (Word x kWords), the accumulator (Acc x
// kAcc), a mask value as the sum takes it (Mask), one term of the sum and
// the quotient. The float route rounds each step to float; the bf16 route
// keeps its values packed, two a word, and rounds each step to bf16 by the
// bf16x2 instructions (see Numerics above).
template <typename T, int VEC>
struct Lane;

template <int VEC>
struct Lane<float, VEC> {
  using Word = float;
  using Acc = float;
  using Mask = float;
  static constexpr int kWords = VEC;
  static constexpr int kAcc = VEC;
  static __device__ __forceinline__ Mask mask(float m) { return m; }
  static __device__ __forceinline__ void add(float (&acc)[VEC], const float (&t)[VEC],
                                             float m) {
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[e] = __fadd_rn(acc[e], __fmul_rn(t[e], m));
  }
  static __device__ __forceinline__ void div(float (&acc)[VEC], float c) {
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[e] = __fdiv_rn(acc[e], c);
  }
};

// a * b and a + b on two bf16 values a word, each rounded to bf16 (round to
// nearest even): the correctly rounded results, which the float product
// (exact) and the float sum of bf16 values rounded once more to bf16 equal
__device__ __forceinline__ uint32_t mul_bf16x2(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("mul.rn.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}
__device__ __forceinline__ uint32_t add_bf16x2(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("add.rn.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

// the bf16 value of a word's low or high half, as a float: exact
__device__ __forceinline__ float lo_half(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float hi_half(uint32_t w) {
  return __uint_as_float(w & 0xffff0000u);
}

template <int VEC>
struct Lane<uint16_t, VEC> {
  using Word = uint32_t;
  using Acc = uint32_t;
  using Mask = uint32_t;           // the mask's bf16 in both halves
  static constexpr int kWords = (VEC + 1) / 2;
  static constexpr int kAcc = kWords;
  static __device__ __forceinline__ Mask mask(uint16_t m) {
    return static_cast<uint32_t>(m) | (static_cast<uint32_t>(m) << 16);
  }
  // (with VEC = 1 the high halves hold 0 and stay 0)
  static __device__ __forceinline__ void add(uint32_t (&acc)[kWords],
                                             const uint32_t (&t)[kWords], uint32_t m) {
#pragma unroll
    for (int w = 0; w < kWords; ++w) acc[w] = add_bf16x2(acc[w], mul_bf16x2(t[w], m));
  }
  static __device__ __forceinline__ void div(uint32_t (&acc)[kWords], float c) {
#pragma unroll
    for (int w = 0; w < kWords; ++w)
      acc[w] = pack_bf16(round_bf16(__fdiv_rn(lo_half(acc[w]), c)),
                         round_bf16(__fdiv_rn(hi_half(acc[w]), c)));
  }
};

// a count value as a float: float as it is, bf16 (its bits) exactly
__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(uint16_t v) {
  return bf16_bits_to_float(v);
}

// lane ``lane``'s entry of the index chunk starting at w0: the clamped row
// (fits an int: V - 1 is taken only when idx >= V, so V - 1 < 2^31) and the
// mask value as the route's sum takes it; 0 and 0 past W
template <typename T, int VEC>
__device__ __forceinline__ void load_chunk(const int* bidx, const T* bmask,
                                           int w0, int W, int lane,
                                           long long V, int& r,
                                           typename Lane<T, VEC>::Mask& m) {
  r = 0;
  m = 0;
  if (w0 + lane < W) {
    const int i = ld_once(bidx + w0 + lane);
    r = i < 0 ? 0 : ((long long)i >= V ? (int)(V - 1) : i);
    m = Lane<T, VEC>::mask(ld_once(bmask + w0 + lane));
  }
}

#ifdef DL4J_BAG_TIMELINE
// Measurement build only (profile_port.py --bag --timeline): lane 0 of each
// warp stores %globaltimer at the warp's start, once its first index chunk
// has arrived, once its rows have arrived and been summed, and after its
// store, with its SM, into stamps[bag * 5 + 0..4]. DL4J_STAMP_AFTER reads
// the timer once ``var`` has arrived and ties ``var`` to the reading, so
// what uses ``var`` (the row loads, the store) comes after it; DL4J_STAMP
// is ordered against memory accesses.
__device__ unsigned long long* g_stamps = nullptr;

__device__ __forceinline__ unsigned long long now_after(int& v) {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t), "+r"(v));
  return t;
}
__device__ __forceinline__ unsigned long long now_after(uint32_t& v) {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t), "+r"(v));
  return t;
}
__device__ __forceinline__ unsigned long long now_after(float& v) {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t), "+f"(v));
  return t;
}
__device__ __forceinline__ unsigned long long now() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t) : : "memory");
  return t;
}
__device__ __forceinline__ void put_stamp(long long bag, bool lead, int k,
                                          unsigned long long t) {
  if (lead && g_stamps) g_stamps[bag * 5 + k] = t;
}
__device__ __forceinline__ void put_sm(long long bag, bool lead) {
  if (lead && g_stamps) {
    unsigned sm;
    asm volatile("mov.u32 %0, %%smid;" : "=r"(sm));
    g_stamps[bag * 5 + 4] = sm;
  }
}
#define DL4J_STAMP(k) put_stamp(bag, lead, k, now())
#define DL4J_STAMP_AFTER(k, var) put_stamp(bag, lead, k, now_after(var))
#define DL4J_STAMP_SM() put_sm(bag, lead)
#else
#define DL4J_STAMP(k) ((void)0)
#define DL4J_STAMP_AFTER(k, var) ((void)0)
#define DL4J_STAMP_SM() ((void)0)
#endif

// The bag's rows in chunks of kRows: kRows row loads in flight, then the
// sums in W order. Lane j of the warp holds index j of the chunk (row r,
// mask m); n of them are live. A source lane past 31 wraps (shuffle
// semantics) and its value goes unused.
template <typename T, int VEC>
__device__ __forceinline__ void sum_rows(
    const T* col, int D, uint64_t pol, bool live, int r,
    typename Lane<T, VEC>::Mask m, int n,
    typename Lane<T, VEC>::Acc (&acc)[Lane<T, VEC>::kAcc]) {
  using L = Lane<T, VEC>;
  for (int k0 = 0; k0 < n; k0 += kRows) {
    typename L::Word t[kRows][L::kWords] = {};
#pragma unroll
    for (int k = 0; k < kRows; ++k) {
      const int rk = __shfl_sync(kFull, r, k0 + k);
      if (live && k0 + k < n)
        load_row<VEC>(col + (long long)rk * D, pol, t[k]);
    }
#pragma unroll
    for (int k = 0; k < kRows; ++k) {
      const typename L::Mask mk = __shfl_sync(kFull, m, k0 + k);
      if (k0 + k < n) L::add(acc, t[k], mk);
    }
  }
}

// How a bag's work is looped, by W and the vectors per row (D / VEC):
// kOne, W <= 32 and at most 32 vectors (one index chunk, one pass of the
// warp: the CBOW path); kPasses, W <= 32 and wider rows (the chunk is
// loaded once, then one pass per 32 vectors); kChunks, W > 32 (each pass
// loads its chunks of 32 indices).
enum Mode { kOne, kPasses, kChunks };

// Registers bound the rows in flight: kRows rows of VEC floats take
// kRows * VEC registers a lane. The blocks per SM asked of the compiler keep
// the most warps resident without spills: at 4 rows of float4 the one-pass
// kernel fits 32 registers a thread, 64 warps on each SM, so the CBOW path's
// 8192 bags run in one wave. Measurement builds with more rows ask for
// proportionally fewer blocks. The bf16 route counts its packed row words
// and its packed accumulators.
template <typename T, int VEC>
constexpr int min_blocks(Mode mode) {
  const int base = mode == kOne ? 8 : mode == kPasses ? 6 : 4;
  const int words = sizeof(T) == 4 ? kRows * VEC
                                   : (kRows + 1) * ((VEC + 1) / 2);
  const int regs = words < 16 ? 16 : words;
  return base * 16 / regs < 1 ? 1 : base * 16 / regs;
}

// T: float (the float32 route) or uint16_t (the bits of bf16 values, the
// bf16 route) for the table, the mask, the counts and the output
template <typename T, int VEC, bool MEAN, Mode MODE>
__global__ void __launch_bounds__(kThreads, min_blocks<T, VEC>(MODE))
    embedding_bag_kernel(const T* __restrict__ table,
                         const int* __restrict__ idx,
                         const T* __restrict__ mask,
                         const T* __restrict__ counts,
                         T* __restrict__ out, long long B, int W, int D,
                         long long V, bool keep) {
  using L = Lane<T, VEC>;
  const long long bag =
      (long long)blockIdx.x * kBagsPerBlock + threadIdx.x / kWarp;
  if (bag >= B) return;  // the whole warp: shuffles below see all 32 lanes
  const int lane = threadIdx.x % kWarp;
  const bool lead = lane == 0;
  DL4J_STAMP(0);
  const uint64_t pol = l2_policy(keep);
  const int* bidx = idx + bag * W;
  const T* bmask = mask + bag * W;
  const float count = MEAN ? to_float(ld_once(counts + bag)) : 1.f;
  int r = 0;
  typename L::Mask m = 0;
  if constexpr (MODE != kChunks) {
    load_chunk<T, VEC>(bidx, bmask, 0, W, lane, V, r, m);
    DL4J_STAMP_AFTER(1, r);
  }
  const int nvec = D / VEC;
  // every lane runs every pass (the shuffles need the whole warp); lanes
  // past the row's end load and store nothing
  for (int v = lane; v - lane < nvec; v += kWarp) {
    const bool live = v < nvec;
    const T* col = table + (long long)v * VEC;
    typename L::Acc acc[L::kAcc];
#pragma unroll
    for (int e = 0; e < L::kAcc; ++e) acc[e] = 0;
    if constexpr (MODE == kChunks) {
      for (int w0 = 0; w0 < W; w0 += kWarp) {
        load_chunk<T, VEC>(bidx, bmask, w0, W, lane, V, r, m);
        sum_rows<T, VEC>(col, D, pol, live, r, m, min(kWarp, W - w0),
                         acc);
      }
    } else {
      sum_rows<T, VEC>(col, D, pol, live, r, m, W, acc);
    }
    DL4J_STAMP_AFTER(2, acc[0]);
    if (live) {
      if (MEAN) L::div(acc, count);
      store_out<VEC>(out + bag * D + (long long)v * VEC, acc);
    }
    if constexpr (MODE == kOne) break;
  }
  DL4J_STAMP(3);
  DL4J_STAMP_SM();
}

// The bf16 route's own layout, for W <= 16 and rows of at most 32 vectors
// (the CBOW path's [8192, 10] x D = 100, PV-DM's W = 11): two bags a warp,
// a half-warp of 16 lanes each. Lane l of a half covers vectors l and
// l + 16 of the row (U of them; at D = 100, 25 vectors of 8 bytes), so a
// warp loads its two bags' index chunks at once (2W consecutive indices)
// and keeps kPairRows rows of each in flight before its first sum, where
// one bag a warp kept 4 (the float route's count). The sums run in W order
// on the packed words, as above.
template <int VEC, int U>
__host__ __device__ constexpr int pair_rows() {
  const int per_row = U * ((VEC + 1) / 2);          // registers a row takes
  const int rows = kPairWords / per_row;
  return rows > 16 ? 16 : rows;
}

template <int VEC, int U>
__host__ __device__ constexpr int pair_min_blocks() {
  // the rows, the accumulators, the indices and addresses: about 16 more
  const int regs = (pair_rows<VEC, U>() + 1) * U * ((VEC + 1) / 2) + 16;
  const int blocks = 65536 / (kThreads * regs);
  return blocks < 1 ? 1 : blocks;
}

template <int VEC, int U, bool MEAN>
__global__ void __launch_bounds__(kThreads, pair_min_blocks<VEC, U>())
    embedding_bag_pairs_kernel(const uint16_t* __restrict__ table,
                               const int* __restrict__ idx,
                               const uint16_t* __restrict__ mask,
                               const uint16_t* __restrict__ counts,
                               uint16_t* __restrict__ out, long long B,
                               int W, int D, long long V, bool keep) {
  using L = Lane<uint16_t, VEC>;
  constexpr int K = pair_rows<VEC, U>();
  const int lane = threadIdx.x % kWarp, hl = lane % 16;
  const long long bag0 = ((long long)blockIdx.x * kBagsPerBlock + threadIdx.x / kWarp) * 2;
  if (bag0 >= B) return;  // the whole warp
  const long long bag = bag0 + lane / 16;
  const bool live_bag = bag < B;
  const bool lead = hl == 0 && live_bag;
  DL4J_STAMP(0);
  const uint64_t pol = l2_policy(keep);
  const float count = MEAN && live_bag ? to_float(ld_once(counts + bag)) : 1.f;
  int r = 0;
  typename L::Mask m = 0;
  if (live_bag) load_chunk<uint16_t, VEC>(idx + bag * W, mask + bag * W, 0, W, hl, V, r, m);
  DL4J_STAMP_AFTER(1, r);
  const int nvec = D / VEC;
  bool live[U];
#pragma unroll
  for (int u = 0; u < U; ++u) live[u] = live_bag && hl + 16 * u < nvec;
  uint32_t acc[U][L::kWords];
#pragma unroll
  for (int u = 0; u < U; ++u)
#pragma unroll
    for (int w = 0; w < L::kWords; ++w) acc[u][w] = 0;
  for (int k0 = 0; k0 < W; k0 += K) {
    uint32_t t[K][U][L::kWords] = {};
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int rk = __shfl_sync(kFull, r, k0 + k, 16);
#pragma unroll
      for (int u = 0; u < U; ++u)
        if (live[u] && k0 + k < W)
          load_row<VEC>(table + (long long)rk * D + (long long)(hl + 16 * u) * VEC, pol,
                        t[k][u]);
    }
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const uint32_t mk = __shfl_sync(kFull, m, k0 + k, 16);
      if (k0 + k < W) {
#pragma unroll
        for (int u = 0; u < U; ++u) L::add(acc[u], t[k][u], mk);
      }
    }
  }
  DL4J_STAMP_AFTER(2, acc[0][0]);
#pragma unroll
  for (int u = 0; u < U; ++u)
    if (live[u]) {
      if (MEAN) L::div(acc[u], count);
      store_out<VEC>(out + bag * D + (long long)(hl + 16 * u) * VEC, acc[u]);
    }
  DL4J_STAMP(3);
  DL4J_STAMP_SM();
}

template <typename T, int VEC, Mode MODE>
void launch(const T* table, const int* idx, const T* mask, const T* counts,
            T* out, long long B, int W, int D, long long V, bool mean,
            bool keep, cudaStream_t stream) {
  const unsigned blocks = (unsigned)((B + kBagsPerBlock - 1) / kBagsPerBlock);
  if (mean)
    embedding_bag_kernel<T, VEC, true, MODE>
        <<<blocks, kThreads, 0, stream>>>(table, idx, mask, counts, out, B,
                                          W, D, V, keep);
  else
    embedding_bag_kernel<T, VEC, false, MODE>
        <<<blocks, kThreads, 0, stream>>>(table, idx, mask, counts, out, B,
                                          W, D, V, keep);
}

template <typename T, int VEC>
void launch_mode(const T* table, const int* idx, const T* mask,
                 const T* counts, T* out, long long B, int W, int D,
                 long long V, bool mean, bool keep, cudaStream_t stream) {
  if (W > kWarp)
    launch<T, VEC, kChunks>(table, idx, mask, counts, out, B, W, D, V, mean,
                            keep, stream);
  else if (D / VEC > kWarp)
    launch<T, VEC, kPasses>(table, idx, mask, counts, out, B, W, D, V, mean,
                            keep, stream);
  else
    launch<T, VEC, kOne>(table, idx, mask, counts, out, B, W, D, V, mean,
                         keep, stream);
}

template <int VEC, int U>
void launch_pairs(const uint16_t* table, const int* idx, const uint16_t* mask,
                  const uint16_t* counts, uint16_t* out, long long B, int W, int D,
                  long long V, bool mean, bool keep, cudaStream_t stream) {
  const unsigned blocks = (unsigned)((B + 2 * kBagsPerBlock - 1) / (2 * kBagsPerBlock));
  if (mean)
    embedding_bag_pairs_kernel<VEC, U, true>
        <<<blocks, kThreads, 0, stream>>>(table, idx, mask, counts, out, B, W, D, V, keep);
  else
    embedding_bag_pairs_kernel<VEC, U, false>
        <<<blocks, kThreads, 0, stream>>>(table, idx, mask, counts, out, B, W, D, V, keep);
}

// The bf16 route at one vector width: the paired layout where it fits (W
// <= 16, at most 32 vectors a row), else the float route's loops.
template <int VEC>
void launch_bf16(const uint16_t* table, const int* idx, const uint16_t* mask,
                 const uint16_t* counts, uint16_t* out, long long B, int W, int D,
                 long long V, bool mean, bool keep, cudaStream_t stream) {
  const int nvec = D / VEC;
  if (kPairs && W <= 16 && nvec <= 16)
    launch_pairs<VEC, 1>(table, idx, mask, counts, out, B, W, D, V, mean, keep, stream);
  else if (kPairs && W <= 16 && nvec <= 32)
    launch_pairs<VEC, 2>(table, idx, mask, counts, out, B, W, D, V, mean, keep, stream);
  else
    launch_mode<uint16_t, VEC>(table, idx, mask, counts, out, B, W, D, V, mean, keep, stream);
}

}  // namespace

extern "C" {

// table [V, D] float32, idx [B, W] int32, mask [B, W] float32, counts [B]
// float32 (read only when mean), out [B, D] float32; all contiguous. The
// vector route when D is a multiple of the lane's vector and table and out
// are aligned to it, else the scalar one. Returns the launch's cudaError_t.
int dl4j_embedding_bag(const void* table, const void* idx, const void* mask,
                       const void* counts, void* out, long long B, int W,
                       int D, long long V, int mean, void* stream) {
  if (B <= 0 || D <= 0) return 0;
  if (V <= 0 || W < 0 || B > (long long)0x7FFFFFFF * kBagsPerBlock)
    return (int)cudaErrorInvalidValue;
  const uintptr_t align = (uintptr_t)table | (uintptr_t)out;
  const bool keep = V * (long long)D * 4 <= kKeepBytes;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* t = static_cast<const float*>(table);
  const int* i = static_cast<const int*>(idx);
  const float* m = static_cast<const float*>(mask);
  const float* c = static_cast<const float*>(counts);
  float* o = static_cast<float*>(out);
  if (D % kVec == 0 && align % (4 * kVec) == 0)
    launch_mode<float, kVec>(t, i, m, c, o, B, W, D, V, mean != 0, keep, st);
  else
    launch_mode<float, 1>(t, i, m, c, o, B, W, D, V, mean != 0, keep, st);
  return (int)cudaGetLastError();
}

// The bf16 route: table [V, D], mask [B, W], counts [B] (read only when
// mean) and out [B, D] bf16, idx [B, W] int32; all contiguous. Rows in
// 16-byte vectors of 8 values when D % 8 == 0 and table and out are 16-byte
// aligned, else the widest of 8, 4 or 2 bytes that D and the alignment
// allow. Returns the launch's cudaError_t.
int dl4j_embedding_bag_bf16(const void* table, const void* idx,
                            const void* mask, const void* counts, void* out,
                            long long B, int W, int D, long long V, int mean,
                            void* stream) {
  if (B <= 0 || D <= 0) return 0;
  if (V <= 0 || W < 0 || B > (long long)0x7FFFFFFF * kBagsPerBlock)
    return (int)cudaErrorInvalidValue;
  const uintptr_t align = (uintptr_t)table | (uintptr_t)out;
  const bool keep = V * (long long)D * 2 <= kKeepBytes;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint16_t* t = static_cast<const uint16_t*>(table);
  const int* i = static_cast<const int*>(idx);
  const uint16_t* m = static_cast<const uint16_t*>(mask);
  const uint16_t* c = static_cast<const uint16_t*>(counts);
  uint16_t* o = static_cast<uint16_t*>(out);
  const bool md = mean != 0;
  if (D % 8 == 0 && align % 16 == 0)
    launch_bf16<8>(t, i, m, c, o, B, W, D, V, md, keep, st);
  else if (D % 4 == 0 && align % 8 == 0)
    launch_bf16<4>(t, i, m, c, o, B, W, D, V, md, keep, st);
  else if (D % 2 == 0 && align % 4 == 0)
    launch_bf16<2>(t, i, m, c, o, B, W, D, V, md, keep, st);
  else
    launch_bf16<1>(t, i, m, c, o, B, W, D, V, md, keep, st);
  return (int)cudaGetLastError();
}

#ifdef DL4J_BAG_TIMELINE
// stamps: [B * 5] 64-bit words on the card, or null to stop stamping
int dl4j_embedding_bag_stamps(void* stamps) {
  return (int)cudaMemcpyToSymbol(g_stamps, &stamps, sizeof(stamps));
}
#endif

const char* dl4j_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
