// Embedding bag for Hopper (sm_90a): the masked sum or mean of the W table
// rows that each bag gathers,
//     out[b, :] = (sum_w table[idx[b, w], :] * mask[b, w]) [/ counts[b]]
//
// Replaces: deeplearning4j_tpu/ops/embeddings.py::_bag_kernel (launched by
// _bag_pallas, entry embedding_bag). Same function, not a block-by-block
// copy: the TPU kernel runs a sequential (B, W) grid whose index map DMAs one
// row per step into VMEM and carries the sum in the revisited output block.
// Here one warp owns one bag and keeps the sum in registers; the W rows are
// visited by a loop inside the warp, so nothing carries between blocks and
// the [B, W, D] gather never reaches device memory.
//
// Bound: memory. Per gathered element one multiply and one add, against 4
// bytes read; the least traffic is the indices, the mask, the counts, the
// output and each distinct row once. Rows that recur (a zipf corpus repeats
// its head words thousands of times per round) are served from L2.
//
// Layout of the work: a block of 256 threads is 8 warps, one bag each.
// Lane l covers row elements [4l, 4l+4) with 16-byte loads when D % 4 == 0
// and the table and output are 16-byte aligned (then every row is), and
// element l otherwise, striding by 32 vectors (or elements) for wide rows.
// All lanes read the bag's W indices and mask values at the same address
// (one broadcast transaction each).
//
// Numerics: each term is __fadd_rn(acc, __fmul_rn(row, mask)), in W order
// from acc = 0, then __fdiv_rn(acc, count) for the mean: the same roundings,
// in the same order, as the plain version (ops/embeddings.py,
// embedding_bag_reference), so the two agree bit for bit. The intrinsics stop
// nvcc from contracting the multiply-add into an FMA. Masked terms are
// computed as well (row * 0), as the plain version does.
//
// Indices are clamped to [0, V-1] and row offsets are 64-bit.
//
// The wrapper (ops/embeddings.py, embedding_bag_cuda) allocates out, checks
// shapes, dtypes, contiguity and alignment, launches on PyTorch's current
// stream, and raises when the launch function returns a nonzero cudaError_t.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr int kThreads = 256;
constexpr int kBagsPerBlock = kThreads / kWarp;

__device__ __forceinline__ long long clamp_row(int i, long long V) {
  long long r = i;
  return r < 0 ? 0 : (r >= V ? V - 1 : r);
}

template <int VEC, bool MEAN>
__global__ void __launch_bounds__(kThreads)
    embedding_bag_kernel(const float* __restrict__ table,
                         const int* __restrict__ idx,
                         const float* __restrict__ mask,
                         const float* __restrict__ counts,
                         float* __restrict__ out, long long B, int W, int D,
                         long long V) {
  const long long bag =
      (long long)blockIdx.x * kBagsPerBlock + threadIdx.x / kWarp;
  if (bag >= B) return;
  const int lane = threadIdx.x % kWarp;
  const int* bidx = idx + bag * W;
  const float* bmask = mask + bag * W;
  float* orow = out + bag * D;
  const int nvec = D / VEC;
  for (int v = lane; v < nvec; v += kWarp) {
    float acc[VEC];
#pragma unroll
    for (int k = 0; k < VEC; ++k) acc[k] = 0.f;
#pragma unroll 4
    for (int w = 0; w < W; ++w) {
      const float m = bmask[w];
      const float* row = table + clamp_row(bidx[w], V) * D + (long long)v * VEC;
      float t[VEC];
      if constexpr (VEC == 4) {
        const float4 q = *reinterpret_cast<const float4*>(row);
        t[0] = q.x;
        t[1] = q.y;
        t[2] = q.z;
        t[3] = q.w;
      } else {
        t[0] = row[0];
      }
#pragma unroll
      for (int k = 0; k < VEC; ++k) acc[k] = __fadd_rn(acc[k], __fmul_rn(t[k], m));
    }
    if (MEAN) {
      const float c = counts[bag];
#pragma unroll
      for (int k = 0; k < VEC; ++k) acc[k] = __fdiv_rn(acc[k], c);
    }
    if constexpr (VEC == 4) {
      *reinterpret_cast<float4*>(orow + (long long)v * VEC) =
          make_float4(acc[0], acc[1], acc[2], acc[3]);
    } else {
      orow[v] = acc[0];
    }
  }
}

template <int VEC, bool MEAN>
void launch(const float* table, const int* idx, const float* mask,
            const float* counts, float* out, long long B, int W, int D,
            long long V, cudaStream_t stream) {
  const long long blocks = (B + kBagsPerBlock - 1) / kBagsPerBlock;
  embedding_bag_kernel<VEC, MEAN><<<(unsigned)blocks, kThreads, 0, stream>>>(
      table, idx, mask, counts, out, B, W, D, V);
}

}  // namespace

extern "C" {

// table [V, D] float32, idx [B, W] int32, mask [B, W] float32, counts [B]
// float32 (read only when mean), out [B, D] float32; all contiguous. vec: 1
// when D % 4 == 0 and table and out are 16-byte aligned. Returns the launch's
// cudaError_t.
int dl4j_embedding_bag(const void* table, const void* idx, const void* mask,
                       const void* counts, void* out, long long B, int W,
                       int D, long long V, int mean, int vec, void* stream) {
  if (B <= 0 || D <= 0) return 0;
  if (V <= 0 || W < 0 || B > (long long)0x7FFFFFFF * kBagsPerBlock)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* t = static_cast<const float*>(table);
  const int* i = static_cast<const int*>(idx);
  const float* m = static_cast<const float*>(mask);
  const float* c = static_cast<const float*>(counts);
  float* o = static_cast<float*>(out);
  if (vec) {
    if (mean) launch<4, true>(t, i, m, c, o, B, W, D, V, st);
    else launch<4, false>(t, i, m, c, o, B, W, D, V, st);
  } else {
    if (mean) launch<1, true>(t, i, m, c, o, B, W, D, V, st);
    else launch<1, false>(t, i, m, c, o, B, W, D, V, st);
  }
  return (int)cudaGetLastError();
}

const char* dl4j_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
