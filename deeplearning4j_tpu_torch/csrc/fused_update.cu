// Fused weight update over one flat float32 bucket, for Hopper (sm_90a):
// one SGD, Nesterovs, Adam or AdamW step for every element, in place.
//
// Replaces: deeplearning4j_tpu/ops/pallas_update.py::_kernel (:143, launched
// by _launch_kernel, entry fused_apply). Same function, not a block-by-block
// copy: the TPU kernel pads the bucket to 256x128 tiles and reads its
// hyperparameters from a (1,128) float32 row, both TPU shapes. Here the
// hyperparameters travel by value in a small struct, and a grid-stride loop
// covers a bucket of any length.
//
// Bound: memory bandwidth, about 2-3 flops per byte. Nesterovs with bf16
// state moves 20 B/elem (read p 4, g 4, v 2, bits 4; write p 4, v 2); Adam
// 24 B/elem with bf16 state, 28 with float32 state. The design touches each
// byte once: a thread covers 4 elements with 16-byte loads of p, g and bits,
// 16-byte loads of float32 moments or 8-byte loads of bf16 moments, and
// writes p and the moments back in place.
//
// Layout of the work: `head` leading elements (until p is 16-byte aligned)
// and the ragged tail are done one at a time; the body in 4-element
// vectors, grid-stride. When the pointers do not share p's alignment (a
// view into a buffer at an odd offset), the wrapper launches the scalar
// variant instead (vec == 0).
//
// The member-batched route (dl4j_fused_update_members): a fleet of M
// same-architecture members keeps each bucket as one contiguous [M, n]
// tensor, and one launch updates every row: the grid's y dimension is the
// member, each row reads its own learning rate from a float32 [M] (the
// sweep's) and an int32 [M] live mask, and a block whose member is masked
// returns at once. This is what jax.vmap makes of the TPU kernel under the
// fleet (parallel/fleet.py, ops/pallas_update.py:191 under vmap). Bound: the
// same bytes per element as the single bucket, times M live rows.
//
// In place: p and the moment buffers are read and written at the same
// index by the same thread; the wrapper (ops/update.py) passes views of the
// persistent buckets, so the graph's parameters change with them.
//
// Stochastic rounding (bf16 moments): one uint32 of random bits per
// element, drawn outside the kernel and passed as int32 patterns; the low
// halfword rounds the first moment, the high halfword the second. x's
// float32 pattern plus the 16 bits, truncated to its top half, rounds up
// with probability (dropped bits) / 2^16. +-inf pass through; NaN becomes
// 0x7FC0 with its sign (the JAX package's cast).
//
// Numerics: every operation is written with a round-to-nearest intrinsic
// (__fmul_rn, __fadd_rn, __fsub_rn, __fdiv_rn, __fsqrt_rn), in the order of
// ops/update.py::_update_math, so nvcc cannot contract a multiply-add into
// an FMA and the result is meant to be bitwise equal to the plain version
// on the card. The accepted bound for parameters and float32 moments is the
// JAX package's contract between its modes, 2 float32 ulp. bf16 moments are
// held bitwise: stochastic rounding picks between two neighbours 1 bf16 ulp
// apart, so a 1-ulp bound would not show a misread halfword.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

enum Kind { kSgd = 0, kNesterovs = 1, kAdam = 2, kAdamW = 3 };

// kind-specific meaning, as ops/update.py::_scalars orders them:
//   sgd:       lr
//   nesterovs: lr, mu, 1+mu
//   adam(w):   lr, b1, b2, eps, bc1, bc2, 1-b1, 1-b2 [, weight decay]
struct Scalars {
  float v[9];
};

__device__ __forceinline__ float bf16_up(uint16_t h) {
  return __uint_as_float(static_cast<uint32_t>(h) << 16);
}

__device__ __forceinline__ uint16_t sr_bf16(float x, uint32_t r) {
  const uint32_t u = __float_as_uint(x);
  if ((u & 0x7F800000u) == 0x7F800000u) {
    if (u & 0x007FFFFFu) return static_cast<uint16_t>(((u >> 16) & 0x8000u) | 0x7FC0u);
    return static_cast<uint16_t>(u >> 16);
  }
  // finite: u + 0xFFFF cannot overflow 32 bits
  return static_cast<uint16_t>((u + (r & 0xFFFFu)) >> 16);
}

template <typename S>
struct State;

template <>
struct State<float> {
  static __device__ __forceinline__ float load(const float* s, long long i) {
    return s[i];
  }
  static __device__ __forceinline__ void store(float* s, long long i, float v,
                                               uint32_t) {
    s[i] = v;
  }
  static __device__ __forceinline__ void load4(const float* s, long long i,
                                               float out[4]) {
    const float4 q = *reinterpret_cast<const float4*>(s + i);
    out[0] = q.x; out[1] = q.y; out[2] = q.z; out[3] = q.w;
  }
  static __device__ __forceinline__ void store4(float* s, long long i,
                                                const float in[4],
                                                const uint32_t*) {
    *reinterpret_cast<float4*>(s + i) = make_float4(in[0], in[1], in[2], in[3]);
  }
};

template <>
struct State<uint16_t> {   // bf16 patterns, stored with stochastic rounding
  static __device__ __forceinline__ float load(const uint16_t* s, long long i) {
    return bf16_up(s[i]);
  }
  static __device__ __forceinline__ void store(uint16_t* s, long long i,
                                               float v, uint32_t r) {
    s[i] = sr_bf16(v, r);
  }
  static __device__ __forceinline__ void load4(const uint16_t* s, long long i,
                                               float out[4]) {
    const uint2 q = *reinterpret_cast<const uint2*>(s + i);
    out[0] = __uint_as_float(q.x << 16);
    out[1] = __uint_as_float(q.x & 0xFFFF0000u);
    out[2] = __uint_as_float(q.y << 16);
    out[3] = __uint_as_float(q.y & 0xFFFF0000u);
  }
  static __device__ __forceinline__ void store4(uint16_t* s, long long i,
                                                const float in[4],
                                                const uint32_t* r) {
    uint2 q;
    q.x = static_cast<uint32_t>(sr_bf16(in[0], r[0])) |
          (static_cast<uint32_t>(sr_bf16(in[1], r[1])) << 16);
    q.y = static_cast<uint32_t>(sr_bf16(in[2], r[2])) |
          (static_cast<uint32_t>(sr_bf16(in[3], r[3])) << 16);
    *reinterpret_cast<uint2*>(s + i) = q;
  }
};

// The update of one element: p, m (first slot), v (second slot) in and out.
template <int KIND>
__device__ __forceinline__ void update(const Scalars& sc, float& p, float g,
                                       float& s0, float& s1) {
  if constexpr (KIND == kSgd) {
    p = __fsub_rn(p, __fmul_rn(sc.v[0], g));
  } else if constexpr (KIND == kNesterovs) {
    const float lr = sc.v[0], mu = sc.v[1], opmu = sc.v[2];
    const float v = s0;
    const float v_new = __fsub_rn(__fmul_rn(mu, v), __fmul_rn(lr, g));
    p = __fadd_rn(p, __fadd_rn(__fmul_rn(-mu, v), __fmul_rn(opmu, v_new)));
    s0 = v_new;
  } else {
    const float lr = sc.v[0], b1 = sc.v[1], b2 = sc.v[2], eps = sc.v[3];
    const float bc1 = sc.v[4], bc2 = sc.v[5], omb1 = sc.v[6], omb2 = sc.v[7];
    const float m_new = __fadd_rn(__fmul_rn(b1, s0), __fmul_rn(omb1, g));
    const float v_new =
        __fadd_rn(__fmul_rn(b2, s1), __fmul_rn(omb2, __fmul_rn(g, g)));
    const float denom = __fadd_rn(__fsqrt_rn(__fdiv_rn(v_new, bc2)), eps);
    float step;
    if constexpr (KIND == kAdamW) {
      step = __fmul_rn(lr, __fadd_rn(__fdiv_rn(__fdiv_rn(m_new, bc1), denom),
                                     __fmul_rn(sc.v[8], p)));
    } else {
      step = __fdiv_rn(__fmul_rn(lr, __fdiv_rn(m_new, bc1)), denom);
    }
    p = __fsub_rn(p, step);
    s0 = m_new;
    s1 = v_new;
  }
}

template <int KIND>
struct NSlots {
  static constexpr int n = KIND == kSgd ? 0 : (KIND == kNesterovs ? 1 : 2);
};

template <int KIND, typename S>
__device__ __forceinline__ void one(const Scalars& sc, float* __restrict__ p,
                                    const float* __restrict__ g,
                                    S* __restrict__ s0, S* __restrict__ s1,
                                    const uint32_t* __restrict__ bits,
                                    long long i) {
  constexpr int NS = NSlots<KIND>::n;
  float pv = p[i];
  float a = 0.f, b = 0.f;
  if constexpr (NS >= 1) a = State<S>::load(s0, i);
  if constexpr (NS >= 2) b = State<S>::load(s1, i);
  update<KIND>(sc, pv, g[i], a, b);
  p[i] = pv;
  const uint32_t r = bits != nullptr ? bits[i] : 0u;
  if constexpr (NS >= 1) State<S>::store(s0, i, a, r);
  if constexpr (NS >= 2) State<S>::store(s1, i, b, r >> 16);
}

// The whole bucket [0, n) of one update, grid-stride from thread `tid` with
// `stride` threads: the body both kernels run.
template <int KIND, typename S, bool VEC>
__device__ __forceinline__ void bucket(const Scalars& sc, float* __restrict__ p,
                                       const float* __restrict__ g,
                                       S* __restrict__ s0, S* __restrict__ s1,
                                       const uint32_t* __restrict__ bits,
                                       long long n, long long head,
                                       long long tid, long long stride) {
  constexpr int NS = NSlots<KIND>::n;
  if constexpr (!VEC) {
    for (long long i = tid; i < n; i += stride)
      one<KIND, S>(sc, p, g, s0, s1, bits, i);
  } else {
    if (tid < head) one<KIND, S>(sc, p, g, s0, s1, bits, tid);
    const long long nvec = (n - head) / 4;
    for (long long v = tid; v < nvec; v += stride) {
      const long long i = head + v * 4;
      const float4 pq = *reinterpret_cast<const float4*>(p + i);
      const float4 gq = *reinterpret_cast<const float4*>(g + i);
      float pe[4] = {pq.x, pq.y, pq.z, pq.w};
      const float ge[4] = {gq.x, gq.y, gq.z, gq.w};
      float a[4] = {0.f, 0.f, 0.f, 0.f}, b[4] = {0.f, 0.f, 0.f, 0.f};
      if constexpr (NS >= 1) State<S>::load4(s0, i, a);
      if constexpr (NS >= 2) State<S>::load4(s1, i, b);
#pragma unroll
      for (int k = 0; k < 4; ++k) update<KIND>(sc, pe[k], ge[k], a[k], b[k]);
      *reinterpret_cast<float4*>(p + i) = make_float4(pe[0], pe[1], pe[2], pe[3]);
      if constexpr (NS >= 1) {
        uint32_t lo[4] = {0u, 0u, 0u, 0u}, hi[4] = {0u, 0u, 0u, 0u};
        if (bits != nullptr) {
          const uint4 bq = *reinterpret_cast<const uint4*>(bits + i);
          lo[0] = bq.x; lo[1] = bq.y; lo[2] = bq.z; lo[3] = bq.w;
#pragma unroll
          for (int k = 0; k < 4; ++k) hi[k] = lo[k] >> 16;
        }
        State<S>::store4(s0, i, a, lo);
        if constexpr (NS >= 2) State<S>::store4(s1, i, b, hi);
      }
    }
    for (long long i = head + nvec * 4 + tid; i < n; i += stride)
      one<KIND, S>(sc, p, g, s0, s1, bits, i);
  }
}

template <int KIND, typename S, bool VEC>
__global__ void fused_update_kernel(Scalars sc, float* __restrict__ p,
                                    const float* __restrict__ g,
                                    S* __restrict__ s0, S* __restrict__ s1,
                                    const uint32_t* __restrict__ bits,
                                    long long n, long long head) {
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long stride = (long long)gridDim.x * blockDim.x;
  bucket<KIND, S, VEC>(sc, p, g, s0, s1, bits, n, head, tid, stride);
}

// The member-batched route: row m = blockIdx.y of a contiguous [M, n]
// bucket (every buffer's rows `row` elements apart), the row's own learning
// rate lr[m] when `lr` is given, and nothing at all for a row whose
// live[m] is 0: its parameters and moments keep their bits and its random
// bits are not read. The element math is the single bucket's, so each row
// is bitwise the solo kernel's update of that row with its scalars.
template <int KIND, typename S, bool VEC>
__global__ void fused_update_members_kernel(
    Scalars sc, float* __restrict__ p, const float* __restrict__ g,
    S* __restrict__ s0, S* __restrict__ s1, const uint32_t* __restrict__ bits,
    long long n, long long row, long long head, const float* __restrict__ lr,
    const int* __restrict__ live) {
  constexpr int NS = NSlots<KIND>::n;
  const long long m = blockIdx.y;
  if (live != nullptr && live[m] == 0) return;
  if (lr != nullptr) sc.v[0] = lr[m];
  const long long off = m * row;
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long stride = (long long)gridDim.x * blockDim.x;
  bucket<KIND, S, VEC>(sc, p + off, g + off, NS >= 1 ? s0 + off : s0,
                       NS >= 2 ? s1 + off : s1,
                       bits != nullptr ? bits + off : bits, n, head, tid,
                       stride);
}

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 132LL * 16;

// members == 0: the single bucket (fused_update_kernel); members >= 1: the
// member-batched kernel over `members` rows.
struct Rows {
  int members;
  long long row;
  const float* lr;
  const int* live;
};

template <int KIND, typename S>
void launch(const Scalars& sc, void* p, const void* g, void* s0, void* s1,
            const void* bits, long long n, long long head, int vec,
            const Rows& rows, cudaStream_t stream) {
  const long long work = vec ? (n - head) / 4 : n;
  long long blocks = (work + kThreads - 1) / kThreads;
  if (blocks < 1) blocks = 1;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  float* pp = static_cast<float*>(p);
  const float* gp = static_cast<const float*>(g);
  S* a = static_cast<S*>(s0);
  S* b = static_cast<S*>(s1);
  const uint32_t* r = static_cast<const uint32_t*>(bits);
  if (rows.members > 0) {
    const dim3 grid((unsigned)blocks, (unsigned)rows.members);
    if (vec)
      fused_update_members_kernel<KIND, S, true><<<grid, kThreads, 0, stream>>>(
          sc, pp, gp, a, b, r, n, rows.row, head, rows.lr, rows.live);
    else
      fused_update_members_kernel<KIND, S, false><<<grid, kThreads, 0, stream>>>(
          sc, pp, gp, a, b, r, n, rows.row, 0, rows.lr, rows.live);
  } else if (vec) {
    fused_update_kernel<KIND, S, true><<<(unsigned)blocks, kThreads, 0, stream>>>(
        sc, pp, gp, a, b, r, n, head);
  } else {
    fused_update_kernel<KIND, S, false><<<(unsigned)blocks, kThreads, 0, stream>>>(
        sc, pp, gp, a, b, r, n, 0);
  }
}

template <int KIND>
int dispatch_state(int bf16_state, const Scalars& sc, void* p, const void* g,
                   void* s0, void* s1, const void* bits, long long n,
                   long long head, int vec, const Rows& rows,
                   cudaStream_t stream) {
  if (bf16_state) {
    if (bits == nullptr) return (int)cudaErrorInvalidValue;
    launch<KIND, uint16_t>(sc, p, g, s0, s1, bits, n, head, vec, rows, stream);
  } else {
    launch<KIND, float>(sc, p, g, s0, s1, nullptr, n, head, vec, rows, stream);
  }
  return 0;
}

int dispatch_kind(int kind, int bf16_state, const Scalars& sc, void* p,
                  const void* g, void* s0, void* s1, const void* bits,
                  long long n, long long head, int vec, const Rows& rows,
                  cudaStream_t st) {
  switch (kind) {
    case kSgd:
      launch<kSgd, float>(sc, p, g, nullptr, nullptr, nullptr, n, head, vec,
                          rows, st);
      return 0;
    case kNesterovs:
      return dispatch_state<kNesterovs>(bf16_state, sc, p, g, s0, s1, bits, n,
                                        head, vec, rows, st);
    case kAdam:
      return dispatch_state<kAdam>(bf16_state, sc, p, g, s0, s1, bits, n,
                                   head, vec, rows, st);
    case kAdamW:
      return dispatch_state<kAdamW>(bf16_state, sc, p, g, s0, s1, bits, n,
                                    head, vec, rows, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// kind: 0 sgd, 1 nesterovs, 2 adam, 3 adamw. p, g: float32 [n]; s0, s1:
// the moments ([n], float32, or bf16 when bf16_state; NULL where the kind
// has fewer); bits: int32 [n] (uint32 patterns), needed with bf16_state.
// head/vec: see the header. a0..a8: the kind's float32 hyperparameters.
// Returns the launch's cudaError_t.
int dl4j_fused_update(int kind, void* p, const void* g, void* s0, void* s1,
                      const void* bits, long long n, int bf16_state,
                      int head, int vec, float a0, float a1, float a2,
                      float a3, float a4, float a5, float a6, float a7,
                      float a8, void* stream) {
  if (n <= 0) return 0;
  if (head < 0 || head > n || (vec && head > 3)) return (int)cudaErrorInvalidValue;
  const Scalars sc = {{a0, a1, a2, a3, a4, a5, a6, a7, a8}};
  const Rows single = {0, 0, nullptr, nullptr};
  const int bad = dispatch_kind(kind, bf16_state, sc, p, g, s0, s1, bits, n,
                                head, vec, single,
                                static_cast<cudaStream_t>(stream));
  if (bad) return bad;
  return (int)cudaGetLastError();
}

// The member-batched route: `members` rows of n elements, row m at element
// offset m * row of every buffer (p, g, s0, s1, bits), one launch. lr:
// float32 [members], each row's learning rate (NULL: a0 for every row);
// live: int32 [members], 0 leaves the row untouched (NULL: every row). head
// and vec as for dl4j_fused_update, the same for every row: the caller
// passes vec = 1 only when every row start keeps the alignment.
int dl4j_fused_update_members(int kind, void* p, const void* g, void* s0,
                              void* s1, const void* bits, long long n,
                              long long row, int members, const void* lr,
                              const void* live, int bf16_state, int head,
                              int vec, float a0, float a1, float a2, float a3,
                              float a4, float a5, float a6, float a7,
                              float a8, void* stream) {
  if (n <= 0 || members <= 0) return 0;
  if (members > 65535 || row < n) return (int)cudaErrorInvalidValue;
  if (head < 0 || head > n || (vec && head > 3)) return (int)cudaErrorInvalidValue;
  const Scalars sc = {{a0, a1, a2, a3, a4, a5, a6, a7, a8}};
  const Rows rows = {members, row, static_cast<const float*>(lr),
                     static_cast<const int*>(live)};
  const int bad = dispatch_kind(kind, bf16_state, sc, p, g, s0, s1, bits, n,
                                head, vec, rows,
                                static_cast<cudaStream_t>(stream));
  if (bad) return bad;
  return (int)cudaGetLastError();
}

const char* dl4j_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
