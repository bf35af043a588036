// Fused inference BatchNorm epilogue for Hopper (sm_90a):
//     out = act(x * scale[c] + shift[c] [+ residual]),  act = relu | identity
//
// Replaces: deeplearning4j_tpu/ops/pallas_epilogue.py::_kernel (launched by
// _launch, entry bn_act). Same function, not a block-by-block copy: the TPU
// kernel streams a channels-last [rows, C] view in 256x128 tiles because of
// the TPU's 128-lane tiling, so the JAX package transposes NCHW around it.
// Here the kernel reads contiguous NCHW directly, so there is no transpose
// and no C % 128 gate.
//
// Bound: memory bandwidth. Per element it does one FMA, at most one add and
// one max, against 2 or 3 tensors x N*C*H*W x element size of traffic (x,
// residual when present, out); at 3.35 TB/s that is the whole cost. The
// design therefore touches each byte once: one read of x, one read of the
// residual, one write of out, with 16-byte loads and stores per thread
// wherever alignment allows; scale and shift (float32, C values each) are
// read once per (n, c) plane.
//
// Layout of the work:
//   4-D NCHW: a block is blockDim.y planes x blockDim.x threads. Each row
//   of threads walks one (n, c) plane, loads that channel's scale and shift
//   once, and covers the plane's 16-byte-aligned body with vector loads;
//   the few elements before the first aligned address and after the last
//   whole vector (a plane of H*W elements need not start on a 16-byte
//   boundary) are done one at a time by the row of gridDim.y index 0.
//   2-D [N, C]: a grid-stride loop over flat vectors; channel = i % C.
//
// Numerics: x and residual are upcast to float32; y = fmaf(x, scale, shift),
// plus the residual, then the activation; the result is rounded once, on
// the store. scale and shift stay float32 (the JAX package's bf16 path
// rounds them to bf16 first; see ops/epilogue.py for the bound).
//
// The wrapper (ops/epilogue.py) allocates out, checks shapes, dtypes,
// contiguity and 16-byte alignment, launches on PyTorch's current stream,
// and raises when the launch function returns a nonzero cudaError_t.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <typename T>
struct VecWidth;
template <>
struct VecWidth<float> { static constexpr int kN = 4; };
template <>
struct VecWidth<__nv_bfloat16> { static constexpr int kN = 8; };

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
__device__ __forceinline__ void one(const T* __restrict__ x,
                                    const T* __restrict__ res,
                                    T* __restrict__ out, long long i, float s,
                                    float b) {
  float y = fmaf(to_f32(x[i]), s, b);
  if (RES) y += to_f32(res[i]);
  out[i] = from_f32<T>(activate<RELU>(y));
}

// VEC elements starting at element i, which is 16-byte aligned; one
// channel for all of them
template <typename T, int VEC, bool RELU, bool RES>
__device__ __forceinline__ void vec_same_channel(const T* __restrict__ x,
                                                 const T* __restrict__ res,
                                                 T* __restrict__ out,
                                                 long long i, float s,
                                                 float b) {
  if constexpr (VEC == 1) {
    one<T, RELU, RES>(x, res, out, i, s, b);
  } else {
    static_assert(VEC * sizeof(T) == 16, "16-byte vectors");
    uint4 xv = *reinterpret_cast<const uint4*>(x + i);
    uint4 rv = make_uint4(0, 0, 0, 0);
    if (RES) rv = *reinterpret_cast<const uint4*>(res + i);
    const T* xe = reinterpret_cast<const T*>(&xv);
    const T* re = reinterpret_cast<const T*>(&rv);
    uint4 ov;
    T* oe = reinterpret_cast<T*>(&ov);
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      float y = fmaf(to_f32(xe[k]), s, b);
      if (RES) y += to_f32(re[k]);
      oe[k] = from_f32<T>(activate<RELU>(y));
    }
    *reinterpret_cast<uint4*>(out + i) = ov;
  }
}

template <typename T, int VEC, bool RELU, bool RES>
__global__ void bn_act_nchw_kernel(const T* __restrict__ x,
                                   const float* __restrict__ scale,
                                   const float* __restrict__ shift,
                                   const T* __restrict__ res,
                                   T* __restrict__ out, long long planes,
                                   long long hw, int C) {
  const long long plane =
      (long long)blockIdx.x * blockDim.y + threadIdx.y;
  if (plane >= planes) return;
  const int c = (int)(plane % C);
  const float s = scale[c];
  const float b = shift[c];
  const long long base = plane * hw;
  long long head = 0;
  if (VEC > 1) {
    // the base pointers are 16-byte aligned (checked by the wrapper), so
    // the plane's misalignment follows from its element offset alone
    const long long mis = (base * (long long)sizeof(T)) & 15;
    head = mis ? (16 - mis) / (long long)sizeof(T) : 0;
    if (head > hw) head = hw;
  }
  const long long nvec = (hw - head) / VEC;
  const long long stride = (long long)gridDim.y * blockDim.x;
  for (long long v = (long long)blockIdx.y * blockDim.x + threadIdx.x;
       v < nvec; v += stride) {
    vec_same_channel<T, VEC, RELU, RES>(x, res, out, base + head + v * VEC,
                                        s, b);
  }
  if (VEC > 1 && blockIdx.y == 0) {
    for (long long i = threadIdx.x; i < head; i += blockDim.x)
      one<T, RELU, RES>(x, res, out, base + i, s, b);
    for (long long i = head + nvec * VEC + threadIdx.x; i < hw;
         i += blockDim.x)
      one<T, RELU, RES>(x, res, out, base + i, s, b);
  }
}

template <typename T, int VEC, bool RELU, bool RES>
__global__ void bn_act_rows_kernel(const T* __restrict__ x,
                                   const float* __restrict__ scale,
                                   const float* __restrict__ shift,
                                   const T* __restrict__ res,
                                   T* __restrict__ out, long long total,
                                   int C) {
  const long long nvec = total / VEC;
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long v = tid; v < nvec; v += stride) {
    const long long i = v * VEC;
    if constexpr (VEC == 1) {
      const int c = (int)(i % C);
      one<T, RELU, RES>(x, res, out, i, scale[c], shift[c]);
    } else {
      uint4 xv = *reinterpret_cast<const uint4*>(x + i);
      uint4 rv = make_uint4(0, 0, 0, 0);
      if (RES) rv = *reinterpret_cast<const uint4*>(res + i);
      const T* xe = reinterpret_cast<const T*>(&xv);
      const T* re = reinterpret_cast<const T*>(&rv);
      uint4 ov;
      T* oe = reinterpret_cast<T*>(&ov);
      int c = (int)(i % C);
#pragma unroll
      for (int k = 0; k < VEC; ++k) {
        float y = fmaf(to_f32(xe[k]), scale[c], shift[c]);
        if (RES) y += to_f32(re[k]);
        oe[k] = from_f32<T>(activate<RELU>(y));
        c = (c + 1 == C) ? 0 : c + 1;
      }
      *reinterpret_cast<uint4*>(out + i) = ov;
    }
  }
  for (long long i = nvec * VEC + tid; i < total; i += stride) {
    const int c = (int)(i % C);
    one<T, RELU, RES>(x, res, out, i, scale[c], shift[c]);
  }
}

constexpr int kThreads = 256;

template <typename T, int VEC, bool RELU, bool RES>
void launch_nchw(const void* x, const float* scale, const float* shift,
                 const void* res, void* out, long long planes, long long hw,
                 int C, cudaStream_t stream) {
  const long long per_plane = (hw + VEC - 1) / VEC;
  int tx = (int)(((per_plane + 31) / 32) * 32);
  if (tx > kThreads) tx = kThreads;
  if (tx < 32) tx = 32;
  const int ty = kThreads / tx;
  long long gx = (planes + ty - 1) / ty;
  long long gy = (per_plane + tx - 1) / tx;
  if (gy > 65535) gy = 65535;
  if (gy < 1) gy = 1;
  dim3 grid((unsigned)gx, (unsigned)gy, 1);
  dim3 block(tx, ty, 1);
  bn_act_nchw_kernel<T, VEC, RELU, RES><<<grid, block, 0, stream>>>(
      static_cast<const T*>(x), scale, shift, static_cast<const T*>(res),
      static_cast<T*>(out), planes, hw, C);
}

template <typename T, int VEC, bool RELU, bool RES>
void launch_rows(const void* x, const float* scale, const float* shift,
                 const void* res, void* out, long long total, int C,
                 cudaStream_t stream) {
  long long blocks = (total / VEC + kThreads - 1) / kThreads;
  if (blocks < 1) blocks = 1;
  if (blocks > 132 * 32) blocks = 132 * 32;
  bn_act_rows_kernel<T, VEC, RELU, RES><<<(unsigned)blocks, kThreads, 0,
                                           stream>>>(
      static_cast<const T*>(x), scale, shift, static_cast<const T*>(res),
      static_cast<T*>(out), total, C);
}

template <typename T, bool RELU, bool RES>
void dispatch_vec(int rows, int vec, const void* x, const float* scale,
                  const float* shift, const void* res, void* out, long long a,
                  long long hw, int C, cudaStream_t stream) {
  constexpr int V = VecWidth<T>::kN;
  if (rows) {
    if (vec) launch_rows<T, V, RELU, RES>(x, scale, shift, res, out, a, C, stream);
    else launch_rows<T, 1, RELU, RES>(x, scale, shift, res, out, a, C, stream);
  } else {
    if (vec) launch_nchw<T, V, RELU, RES>(x, scale, shift, res, out, a, hw, C, stream);
    else launch_nchw<T, 1, RELU, RES>(x, scale, shift, res, out, a, hw, C, stream);
  }
}

template <typename T>
void dispatch(int rows, int relu, int vec, const void* x, const float* scale,
              const float* shift, const void* res, void* out, long long a,
              long long hw, int C, cudaStream_t stream) {
  if (relu) {
    if (res) dispatch_vec<T, true, true>(rows, vec, x, scale, shift, res, out, a, hw, C, stream);
    else dispatch_vec<T, true, false>(rows, vec, x, scale, shift, res, out, a, hw, C, stream);
  } else {
    if (res) dispatch_vec<T, false, true>(rows, vec, x, scale, shift, res, out, a, hw, C, stream);
    else dispatch_vec<T, false, false>(rows, vec, x, scale, shift, res, out, a, hw, C, stream);
  }
}

}  // namespace

extern "C" {

// rows == 0: x is NCHW with `a` = N*C planes of `hw` = H*W elements.
// rows == 1: x is [N, C] with `a` = N*C elements (hw unused).
// dtype: 0 float32, 1 bfloat16. res may be NULL. vec: 1 when every base
// pointer is 16-byte aligned. Returns the launch's cudaError_t.
int dl4j_bn_act(const void* x, const void* scale, const void* shift,
                const void* res, void* out, long long a, long long hw, int C,
                int rows, int dtype, int relu, int vec, void* stream) {
  if (a <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* s = static_cast<const float*>(scale);
  const float* b = static_cast<const float*>(shift);
  if (dtype == 0) {
    dispatch<float>(rows, relu, vec, x, s, b, res, out, a, hw, C, st);
  } else if (dtype == 1) {
    dispatch<__nv_bfloat16>(rows, relu, vec, x, s, b, res, out, a, hw, C, st);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

const char* dl4j_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
