// Flash attention forward for Hopper (sm_90a): blockwise online-softmax
// attention in float32, with an optional additive logits bias and causal
// masking,
//     out[bh, i, :] = sum_j softmax_j(scale * q[bh, i] . k[bh, j] + bias) v[bh, j]
// without ever writing the [T, T] score matrix to device memory.
//
// Replaces: deeplearning4j_tpu/ops/pallas_attention.py::_fa_kernel (launched
// by _fa_forward, entry flash_attention). Same function, not a block-by-block
// copy: the TPU kernel runs a (B*H, T/bq, T/bk) grid whose innermost k axis
// is sequential, and keeps the running max, denominator and accumulator in
// VMEM scratch that persists across it. Here one thread block owns one
// 64-row q tile of one (batch, head) and walks the k tiles in a loop, so the
// state stays in registers and nothing carries between blocks.
//
// Bound: at T = 128, D = 64 (BERT-base's path) the work is 4*T*T*D float32
// operations per (batch, head) against 4*T*D*4 bytes moved, about 32
// operations per byte: above the float32 ridge (67 TFLOP/s / 3.35 TB/s = 20),
// so the FFMA rate bounds it. This first design uses plain FFMA (no tensor
// cores, no TMA): its speed is the register micro-tile below.
//
// Layout of the work: 256 threads as a 16 x 16 grid (ty = tid / 16, tx = tid
// % 16). For the scores, thread (ty, tx) owns q rows 4ty..4ty+3 and k columns
// 4tx..4tx+3 of the 64 x 64 tile: per d one 16-byte shared load of q (from
// the transposed Qt) and one of k (from the transposed Kt) feed 16 FMAs. A
// row's 64 scores live in the 16 threads of one half-warp, so the row max
// and row sum are 4 shuffles. p goes to shared memory (transposed, Pt), and
// for p.v thread (ty, tx) owns rows 4ty..4ty+3 and d columns 4tx + 64u
// (u < NU = D/64 rounded up): per k one 16-byte load of p and one of v per u
// feed 16 FMAs each. Each tile is loaded with 16-byte coalesced reads; rows
// past T load as zeros and their scores are -inf (the tail tile is masked).
//
// Numerics follow _fa_kernel: q is multiplied by the scale before the
// product; the bias is added, then causal positions qpos < kpos become -inf
// and k tiles entirely above the diagonal are skipped; safe = m if finite
// else 0, p = 0 where s is not finite, alpha = 0 where the old max is not
// finite; the output is acc / max(l, 1e-30), so a row that is -inf
// everywhere gives 0, not NaN. expf and the division are the accurate ones
// (no fast math); the plain version (ops/attention.py,
// flash_attention_reference) sums in another order, so the two agree within
// a tolerance, not bitwise.
//
// The bias is read through element strides of a [B, H, T, T] view (zero
// strides for broadcast dimensions), so a padding mask is never expanded in
// device memory.
//
// The wrapper (ops/attention.py, flash_attention_cuda) allocates out, checks
// shapes, dtypes, contiguity and alignment, launches on PyTorch's current
// stream, and raises when the launch function returns a nonzero cudaError_t.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;           // q rows and k rows per tile
constexpr int kThreads = 256;       // 16 x 16
constexpr int kLd = kTile + 4;      // row length of Qt, Kt, Pt (16-byte rows)
constexpr int kMaxD = 128;

struct Bias {
  const float* ptr;                 // null: no bias
  long long sb, sh, sq, sk;         // element strides of the [B, H, T, T] view
  int H;
};

__device__ __forceinline__ float half_warp_max(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float half_warp_sum(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// A [kTile, D] tile of rows row0.. of a [T, D] matrix into shared memory,
// transposed (dst[d * kLd + row]) and multiplied by mul; rows past T are 0.
__device__ __forceinline__ void load_transposed(float* dst, const float* src, int row0,
                                                int T, int D, float mul) {
  const int n4 = D / 4;
  for (int i = threadIdx.x; i < kTile * n4; i += kThreads) {
    const int row = i / n4, c = (i % n4) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + row < T)
      x = *reinterpret_cast<const float4*>(src + (long long)(row0 + row) * D + c);
    dst[(c + 0) * kLd + row] = x.x * mul;
    dst[(c + 1) * kLd + row] = x.y * mul;
    dst[(c + 2) * kLd + row] = x.z * mul;
    dst[(c + 3) * kLd + row] = x.w * mul;
  }
}

// The same tile as it lies (dst[row * D + d]); rows past T are 0.
__device__ __forceinline__ void load_rows(float* dst, const float* src, int row0, int T,
                                          int D) {
  const int n4 = D / 4;
  for (int i = threadIdx.x; i < kTile * n4; i += kThreads) {
    const int row = i / n4, c = (i % n4) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + row < T)
      x = *reinterpret_cast<const float4*>(src + (long long)(row0 + row) * D + c);
    *reinterpret_cast<float4*>(dst + row * D + c) = x;
  }
}

template <int NU, bool CAUSAL, bool HAS_BIAS>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, Bias bias, float* __restrict__ out, int T,
                     int D, float scale) {
  extern __shared__ __align__(16) float smem[];
  float* Qt = smem;                 // [D][kLd]     q * scale, transposed
  float* Kt = Qt + D * kLd;         // [D][kLd]     k tile, transposed
  float* Vs = Kt + D * kLd;         // [kTile][D]   v tile
  float* Pt = Vs + kTile * D;       // [kTile][kLd] p, transposed (k-major)

  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const long long bh = blockIdx.x;
  const int q0 = blockIdx.y * kTile;
  const long long base = bh * T * D;
  const float* qb = q + base;
  const float* kb = k + base;
  const float* vb = v + base;
  const float* bias_bh = nullptr;
  if (HAS_BIAS) bias_bh = bias.ptr + (bh / bias.H) * bias.sb + (bh % bias.H) * bias.sh;

  load_transposed(Qt, qb, q0, T, D, scale);

  float m[4], l[4], acc[4][4 * NU];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < 4 * NU; ++c) acc[i][c] = 0.f;
  }

  int n_k = (T + kTile - 1) / kTile;
  if (CAUSAL) n_k = min(n_k, (q0 + kTile - 1) / kTile + 1);   // skip tiles above the diagonal
  for (int kt = 0; kt < n_k; ++kt) {
    const int k0 = kt * kTile;
    load_transposed(Kt, kb, k0, T, D, 1.f);
    load_rows(Vs, vb, k0, T, D);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      const float4 a = *reinterpret_cast<const float4*>(Qt + d * kLd + 4 * ty);
      const float4 b = *reinterpret_cast<const float4*>(Kt + d * kLd + 4 * tx);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(av[i], bv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = q0 + 4 * ty + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kj = k0 + 4 * tx + j;
        if (kj >= T) {
          s[i][j] = -INFINITY;
        } else {
          if (HAS_BIAS && qi < T) s[i][j] += bias_bh[qi * bias.sq + kj * bias.sk];
          if (CAUSAL && qi < kj) s[i][j] = -INFINITY;
        }
      }
      float mb = s[i][0];
#pragma unroll
      for (int j = 1; j < 4; ++j) mb = fmaxf(mb, s[i][j]);
      const float m_new = fmaxf(m[i], half_warp_max(mb));
      const float safe = isfinite(m_new) ? m_new : 0.f;
      const float alpha = isfinite(m[i]) ? expf(m[i] - safe) : 0.f;
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = isfinite(s[i][j]) ? expf(s[i][j] - safe) : 0.f;
        rs += s[i][j];
      }
      l[i] = l[i] * alpha + half_warp_sum(rs);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < 4 * NU; ++c) acc[i][c] *= alpha;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float4*>(Pt + (4 * tx + j) * kLd + 4 * ty) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < kTile; ++kk) {
      const float4 p4 = *reinterpret_cast<const float4*>(Pt + kk * kLd + 4 * ty);
      const float pv[4] = {p4.x, p4.y, p4.z, p4.w};
#pragma unroll
      for (int u = 0; u < NU; ++u) {
        const int dc = 4 * tx + 64 * u;
        if (dc < D) {
          const float4 w = *reinterpret_cast<const float4*>(Vs + kk * D + dc);
          const float wv[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int c = 0; c < 4; ++c)
              acc[i][4 * u + c] = fmaf(pv[i], wv[c], acc[i][4 * u + c]);
        }
      }
    }
    __syncthreads();    // Kt, Vs and Pt are overwritten by the next tile
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + 4 * ty + i;
    if (qi >= T) continue;
    const float den = fmaxf(l[i], 1e-30f);
    float* orow = out + base + (long long)qi * D;
#pragma unroll
    for (int u = 0; u < NU; ++u) {
      const int dc = 4 * tx + 64 * u;
      if (dc < D)
        *reinterpret_cast<float4*>(orow + dc) =
            make_float4(acc[i][4 * u] / den, acc[i][4 * u + 1] / den,
                        acc[i][4 * u + 2] / den, acc[i][4 * u + 3] / den);
    }
  }
}

size_t smem_bytes(int D) { return sizeof(float) * (2 * D * kLd + kTile * D + kTile * kLd); }

template <int NU, bool CAUSAL, bool HAS_BIAS>
int launch(const float* q, const float* k, const float* v, Bias bias, float* out, int BH,
           int T, int D, float scale, cudaStream_t stream) {
  auto kernel = flash_fwd_kernel<NU, CAUSAL, HAS_BIAS>;
  const size_t bytes = smem_bytes(D);
  if (bytes > 48 * 1024) {
    // above 48 KB only after the opt-in, which holds per device
    cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((unsigned)BH, (unsigned)((T + kTile - 1) / kTile));
  kernel<<<grid, kThreads, bytes, stream>>>(q, k, v, bias, out, T, D, scale);
  return (int)cudaGetLastError();
}

template <bool CAUSAL, bool HAS_BIAS>
int dispatch_nu(const float* q, const float* k, const float* v, Bias bias, float* out,
                int BH, int T, int D, float scale, cudaStream_t stream) {
  if (D <= 64) return launch<1, CAUSAL, HAS_BIAS>(q, k, v, bias, out, BH, T, D, scale, stream);
  return launch<2, CAUSAL, HAS_BIAS>(q, k, v, bias, out, BH, T, D, scale, stream);
}

}  // namespace

extern "C" {

// q, k, v, out: [BH, T, D] float32, contiguous, 16-byte aligned; D a
// multiple of 4 in [4, 128]. bias: null, or float32 read at
// b*sb + h*sh + i*sq + j*sk for bh = b*H + h (element strides of a
// [BH/H, H, T, T] view). Returns the launch's cudaError_t.
int dl4j_flash_attention_fwd(const void* q, const void* k, const void* v, const void* bias,
                             long long sb, long long sh, long long sq, long long sk, int H,
                             void* out, int BH, int T, int D, float scale, int causal,
                             void* stream) {
  if (BH <= 0 || T <= 0) return 0;
  if (D < 4 || D > kMaxD || D % 4 != 0 || H <= 0 || BH % H != 0 ||
      (T + kTile - 1) / kTile > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* qp = static_cast<const float*>(q);
  const float* kp = static_cast<const float*>(k);
  const float* vp = static_cast<const float*>(v);
  float* op = static_cast<float*>(out);
  Bias b{static_cast<const float*>(bias), sb, sh, sq, sk, H};
  if (b.ptr) {
    if (causal) return dispatch_nu<true, true>(qp, kp, vp, b, op, BH, T, D, scale, st);
    return dispatch_nu<false, true>(qp, kp, vp, b, op, BH, T, D, scale, st);
  }
  if (causal) return dispatch_nu<true, false>(qp, kp, vp, b, op, BH, T, D, scale, st);
  return dispatch_nu<false, false>(qp, kp, vp, b, op, BH, T, D, scale, st);
}

const char* dl4j_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
