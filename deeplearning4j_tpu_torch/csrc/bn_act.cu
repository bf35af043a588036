// Fused inference BatchNorm epilogue for Hopper (sm_90a):
//     out = act(x * scale[c] + shift[c] [+ residual]),  act = relu | identity
//
// Replaces: deeplearning4j_tpu/ops/pallas_epilogue.py::_kernel (launched by
// _launch, entry bn_act). Same function, not a block-by-block copy: the TPU
// kernel streams a channels-last [rows, C] view in 256x128 tiles because of
// the TPU's 128-lane tiling, so the JAX package transposes NCHW around it.
// Here the kernel reads contiguous NCHW (or [N, C]) as it lies, so there is
// no transpose and no C % 128 gate.
//
// Bound: memory bandwidth. Per element it does one FMA, at most one add and
// one max, against 2 or 3 tensors x N*C*H*W x element size of traffic (x,
// the residual when present, out); at 3.35 TB/s that is the whole cost. At
// the small shapes of a forward (7x7, 5x5 planes, under 2 MB a launch) the
// cost is the launch and one trip to memory, so the design also keeps the
// per-launch work small.
//
// Design: one flat pass. x, the residual and out are flat arrays of
// N*C*H*W elements ([N, C] is H*W = 1), cut into 16-byte vectors (8 bf16 or
// 4 float32), neighbouring threads on neighbouring vectors. Only the three
// base pointers need 16-byte alignment (the wrapper checks them; otherwise
// it takes the scalar route, vectors of one element). The numel % VEC
// elements at the end are done one at a time by block 0. A thread issues
// the loads of its `per_thread` (1-4) vectors, x and the residual, before its
// first FMA, then computes, then stores. The wrapper sizes the grid: one
// pass of ceil(vectors / (256 * per_thread)) blocks, per_thread halved
// until the grid covers the SMs; past 64 blocks an SM the grid strides.
// __launch_bounds__(256, 4) keeps registers at 64 or fewer (none spilled),
// so at least 4 blocks are resident on an SM. On an H100 one pass took
// 2-4% less than a grid of 4 blocks an SM that strides at the large
// shapes, and matches copy_ on the same bytes (PERF.md, section 6).
//
// The port's first design gave each (n, c) plane a row of at least one
// warp and did the misaligned head and tail of every plane one element at
// a time; a plane of 49 bf16 (98 B) or 196 (392 B) is misaligned whenever
// its byte length is not a multiple of 16. Every 7x7 and 14x14 launch of
// ResNet-50 (29 of 53) ran mostly idle warps and scalar loads: [32,512,7,7]
// took 0.0102 ms against a bound of 0.00096, a forward's 53 launches 1.0081
// ms against 0.5100 (PERF.md, section 6). Most of what remains at the small
// shapes is the launch itself: timed the same way, an empty launch takes
// about 0.0048 ms and this kernel at one vector 0.0055 (PERF.md).
//
// Channels: for a vector's first element e, (plane, r) = divmod(e, HW) and
// c = plane mod C, once per vector; then the channel steps with the
// elements. Where HW >= VEC a vector spans at most two channels: both
// channels' scale and shift are read and each element picks one by
// comparing k with HW - r. Where HW < VEC (HW = 1 for [N, C]) each element
// steps r and c and reads its own. Index routes, chosen by the wrapper from
// numel: below 2^31 elements, 32-bit indices and a multiply-high divmod
// with magic numbers computed on the host (n / d = umulhi(2n, mul) >> shr
// for n < 2^31; ops/epilogue.py:divmod_magic); from 2^31 on, 64-bit indices
// and the hardware's division (off the main path).
//
// scale and shift (float32, at most 2 x 2048 values on the main paths) are
// read through the read-only path (__ldg): the L1 holds them, and a warp's
// 32 vectors touch a few neighbouring channels, so these are broadcasts.
//
// Cache policy: x and the residual are dead after this kernel; out is read
// next by the following convolution. DL4J_BN_STREAM=1 (the default) loads
// x and the residual evict-first (__ldcs), 0 through the read-only path
// (__ldg); out is stored with the default policy either way. In the served
// ResNet-50 forward (batch 32, bf16, on an H100) the forward's kernels took
// 0.01-0.04 ms less device time with evict-first loads in three calls
// (3.29-3.30 ms against 3.30-3.35), about what this kernel's 53 launches
// saved; timed alone from a cold L2 the two are equal (profile_port.py
// --bn; PERF.md).
//
// Numerics: x and residual are upcast to float32; y = fmaf(x, scale, shift),
// plus the residual, then the activation; the result is rounded once, on
// the store: the same expression as the first design's, so the output is
// bitwise the same. scale and shift stay float32 (the JAX package's bf16
// path rounds them to bf16 first; see ops/epilogue.py for the bound).
//
// The wrapper (ops/epilogue.py) allocates out, checks shapes, dtypes,
// contiguity and 16-byte alignment, plans the launch (route, vector width,
// per_thread, blocks, magic numbers), launches on PyTorch's current stream,
// and raises when the launch function returns a nonzero cudaError_t.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#ifndef DL4J_BN_STREAM
#define DL4J_BN_STREAM 1
#endif

namespace {

constexpr int kThreads = 256;
constexpr int kMaxPerThread = 4;
constexpr int kMinBlocksPerSm = 4;

template <typename T>
struct VecWidth;
template <>
struct VecWidth<float> { static constexpr int kN = 4; };
template <>
struct VecWidth<__nv_bfloat16> { static constexpr int kN = 8; };

// what one thread loads and stores at once: 16 bytes, or one element on
// the scalar route
template <typename T, int VEC>
struct Pack { using type = uint4; };
template <typename T>
struct Pack<T, 1> { using type = T; };

template <typename P>
__device__ __forceinline__ P load_dead(const P* p) {
#if DL4J_BN_STREAM
  return __ldcs(p);
#else
  return __ldg(p);
#endif
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// relu keeps NaN (as torch.relu and jnp.maximum(y, 0) do); fmaxf would not
template <bool RELU>
__device__ __forceinline__ float activate(float y) {
  return (RELU && y < 0.f) ? 0.f : y;
}

template <typename T, bool RELU, bool RES>
__device__ __forceinline__ T epilogue(T xe, T re, float s, float b) {
  float y = fmaf(to_f32(xe), s, b);
  if (RES) y += to_f32(re);
  return from_f32<T>(activate<RELU>(y));
}

struct Params {
  const void* x;
  const float* scale;
  const float* shift;
  const void* res;
  void* out;
  long long total;        // elements
  long long hw;           // H*W (1 for [N, C])
  long long C;
  int per_thread;         // vectors a thread loads before computing, 1-4
  uint32_t hw_mul, hw_shr, c_mul, c_shr;   // the 32-bit route's divmods
};

// (plane, r) = divmod(e, hw); c = plane mod C
__device__ __forceinline__ void channel_of(uint32_t e, const Params& p,
                                           uint32_t& r, uint32_t& c) {
  const uint32_t hw = (uint32_t)p.hw, C = (uint32_t)p.C;
  const uint32_t plane = __umulhi(e << 1, p.hw_mul) >> p.hw_shr;
  r = e - plane * hw;
  const uint32_t q = __umulhi(plane << 1, p.c_mul) >> p.c_shr;
  c = plane - q * C;
}

__device__ __forceinline__ void channel_of(uint64_t e, const Params& p,
                                           uint64_t& r, uint64_t& c) {
  const uint64_t plane = e / (uint64_t)p.hw;
  r = e - plane * (uint64_t)p.hw;
  c = plane % (uint64_t)p.C;
}

// one vector of VEC elements starting at element e (VEC-aligned)
template <typename T, typename I, int VEC, bool SPAN2, bool RELU, bool RES>
__device__ __forceinline__ typename Pack<T, VEC>::type vector_epilogue(
    const typename Pack<T, VEC>::type& xv,
    const typename Pack<T, VEC>::type& rv, I e, const Params& p) {
  using P = typename Pack<T, VEC>::type;
  const T* xe = reinterpret_cast<const T*>(&xv);
  const T* re = reinterpret_cast<const T*>(&rv);
  P ov;
  T* oe = reinterpret_cast<T*>(&ov);
  I r, c;
  channel_of(e, p, r, c);
  if constexpr (SPAN2) {
    // hw >= VEC: channel c for the first hw - r elements, then c + 1
    const float s0 = __ldg(p.scale + c), b0 = __ldg(p.shift + c);
    float s1 = s0, b1 = b0;
    const I split = (I)p.hw - r;
    if (VEC > 1 && split < (I)VEC) {
      const I c1 = (c + 1 == (I)p.C) ? 0 : c + 1;
      s1 = __ldg(p.scale + c1);
      b1 = __ldg(p.shift + c1);
    }
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      const bool first = (I)k < split;
      oe[k] = epilogue<T, RELU, RES>(xe[k], RES ? re[k] : xe[k],
                                     first ? s0 : s1, first ? b0 : b1);
    }
  } else {
    // hw < VEC: the channel may change at every element
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      oe[k] = epilogue<T, RELU, RES>(xe[k], RES ? re[k] : xe[k],
                                     __ldg(p.scale + c), __ldg(p.shift + c));
      if (++r == (I)p.hw) {
        r = 0;
        c = (c + 1 == (I)p.C) ? 0 : c + 1;
      }
    }
  }
  return ov;
}

template <typename T, typename I, int VEC, bool SPAN2, bool RELU, bool RES>
__global__ void __launch_bounds__(kThreads, kMinBlocksPerSm)
    bn_act_kernel(const Params p) {
  using P = typename Pack<T, VEC>::type;
  const P* __restrict__ x = static_cast<const P*>(p.x);
  const P* __restrict__ res = static_cast<const P*>(p.res);
  P* __restrict__ out = static_cast<P*>(p.out);
  const I nvec = (I)(p.total / VEC);
  const I chunk = (I)kThreads * (I)p.per_thread;
  const I step = chunk * (I)gridDim.x;
  for (I v0 = (I)blockIdx.x * chunk + threadIdx.x; v0 < nvec; v0 += step) {
    P xv[kMaxPerThread], rv[kMaxPerThread];
#pragma unroll
    for (int u = 0; u < kMaxPerThread; ++u) {
      const I v = v0 + (I)(u * kThreads);
      if (u < p.per_thread && v < nvec) {
        xv[u] = load_dead(x + v);
        if (RES) rv[u] = load_dead(res + v);
      }
    }
#pragma unroll
    for (int u = 0; u < kMaxPerThread; ++u) {
      const I v = v0 + (I)(u * kThreads);
      if (u < p.per_thread && v < nvec)
        out[v] = vector_epilogue<T, I, VEC, SPAN2, RELU, RES>(
            xv[u], RES ? rv[u] : xv[u], v * (I)VEC, p);
    }
  }
  if (VEC > 1 && blockIdx.x == 0) {
    // the ragged end: numel % VEC elements, one a thread
    const I e = nvec * (I)VEC + threadIdx.x;
    if (e < (I)p.total) {
      const T* xs = static_cast<const T*>(p.x);
      const T* rs = static_cast<const T*>(p.res);
      I r, c;
      channel_of(e, p, r, c);
      static_cast<T*>(p.out)[e] = epilogue<T, RELU, RES>(
          xs[e], RES ? rs[e] : xs[e], __ldg(p.scale + c), __ldg(p.shift + c));
    }
  }
}

template <typename T, typename I, int VEC, bool SPAN2>
void launch_act(const Params& p, int relu, int blocks, cudaStream_t st) {
  const bool r = p.res != nullptr;
  if (relu) {
    if (r) bn_act_kernel<T, I, VEC, SPAN2, true, true><<<blocks, kThreads, 0, st>>>(p);
    else bn_act_kernel<T, I, VEC, SPAN2, true, false><<<blocks, kThreads, 0, st>>>(p);
  } else {
    if (r) bn_act_kernel<T, I, VEC, SPAN2, false, true><<<blocks, kThreads, 0, st>>>(p);
    else bn_act_kernel<T, I, VEC, SPAN2, false, false><<<blocks, kThreads, 0, st>>>(p);
  }
}

template <typename T, typename I>
void launch_vec(const Params& p, int vec, int relu, int blocks,
                cudaStream_t st) {
  constexpr int V = VecWidth<T>::kN;
  if (!vec) launch_act<T, I, 1, true>(p, relu, blocks, st);
  else if (p.hw >= V) launch_act<T, I, V, true>(p, relu, blocks, st);
  else launch_act<T, I, V, false>(p, relu, blocks, st);
}

template <typename T>
void launch_route(const Params& p, int wide, int vec, int relu, int blocks,
                  cudaStream_t st) {
  if (wide) launch_vec<T, uint64_t>(p, vec, relu, blocks, st);
  else launch_vec<T, uint32_t>(p, vec, relu, blocks, st);
}

}  // namespace

extern "C" {

// x, res (may be NULL) and out: contiguous, `total` elements, `hw` = H*W
// (1 for [N, C]) elements a plane, C channels; scale, shift: C float32.
// dtype: 0 float32, 1 bfloat16. vec: 1 when every base pointer is 16-byte
// aligned. wide: 1 for the 64-bit index route (required from 2^31
// elements on). per_thread (1-4) and blocks: the grid the wrapper planned;
// hw_mul, hw_shr, c_mul, c_shr: the 32-bit route's divmods by hw and C.
// Returns the launch's cudaError_t.
int dl4j_bn_act(const void* x, const void* scale, const void* shift,
                const void* res, void* out, long long total, long long hw,
                long long C, int dtype, int relu, int vec, int wide,
                int per_thread, int blocks, unsigned hw_mul, unsigned hw_shr,
                unsigned c_mul, unsigned c_shr, void* stream) {
  if (total <= 0) return 0;
  if (hw <= 0 || C <= 0 || blocks <= 0 || per_thread < 1 ||
      per_thread > kMaxPerThread || (!wide && total >= (1LL << 31)))
    return (int)cudaErrorInvalidValue;
  Params p{x, static_cast<const float*>(scale),
           static_cast<const float*>(shift), res, out, total, hw, C,
           per_thread, hw_mul, hw_shr, c_mul, c_shr};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    launch_route<float>(p, wide, vec, relu, blocks, st);
  } else if (dtype == 1) {
    launch_route<__nv_bfloat16>(p, wide, vec, relu, blocks, st);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

const char* dl4j_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
