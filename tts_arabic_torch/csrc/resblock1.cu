// HiFi-GAN ResBlock1 for Hopper (sm_90a): three passes of
//   h += conv2(leaky(conv1_d(leaky(h) * mask) + b1) * mask) + b2
// on x [B, T, C] (f32 or bf16), f32 accumulation, SAME zero padding at the
// sequence edges (the mask zeroes every conv input outside [0, T)).
//
// Replaces tts_arabic_tpu/ops/hifigan_pallas.py::resblock_pallas (wide, C >=
// 64) and ::resblock_pallas_packed (narrow, C <= 32). It computes what
// `_resblock_kernel` computes; the TPU's lane packing is not carried over.
//
// Design (a simple kernel that is right; mma.sync / wgmma / TMA come later):
// - one block per (time tile, batch row), 256 threads; thread (co, ty) owns
//   output channel co and every ny-th chunk of ROWS consecutive time rows,
//   so weight reads [k, C_in, C_out] are coalesced over co and each weight
//   value feeds ROWS FMAs from registers;
// - the haloed input tile is staged once in shared memory (as f32, whatever
//   the storage type); activations are read as float4 broadcasts (every
//   thread of a warp reads the same row), so shared memory has no bank
//   conflicts;
// - conv outputs are rounded to the storage type after the bias add, and
//   the residual sum likewise, as the Pallas kernel rounds its matmul
//   outputs to x.dtype.
//
// What bounds it: the convs are 12*k*C^2 FLOPs per time row, all on the
// f32 CUDA cores (67 TFLOP/s peak, 989 for bf16 on the tensor cores), with
// ~1.5 shared-memory loads per 4 FMAs; the ideal byte traffic (x in, y out)
// is far smaller, so it is bound by operations. The halo recompute adds
// (tile + 2*halo)/tile work.
//
// Shared memory decides the variants. A whole fused ResBlock at k=11 needs a
// halo of 60 rows per side and a residual buffer beside two conv buffers:
// three [tile + 120, C] f32 buffers, over 227 KB at C=256 for any tile
// worth having. So:
// - wide (C >= 64): one pass per launch (halo <= 30 rows), two buffers,
//   three launches per ResBlock, the residual read from global memory.
//   C=256, tile 32, k=11: (98 + 48) rows * 1 KB = 146 KB.
// - narrow (C <= 32, and C=64 for the checks): all three passes fused in
//   one launch, three buffers. C=32, tile 128, k=11: 3 * 264 rows * 128 B
//   = 101 KB; C=64, tile 64: 3 * 200 * 256 B = 154 KB.
// Weights (up to 11*256*256 per conv) stay in global memory and L2.
//
// C interface for ctypes: pointers and the stream as void*, the return
// value is cudaGetLastError() after the launch (0 = success).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 16;          // time rows per thread per chunk
constexpr float kSlope = 0.1f;     // LRELU_SLOPE
constexpr int kMaxSmem = 232448;   // 227 KB, the most a block may use

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(
    float v) {
  return __float2bfloat16(v);
}

// v rounded to the storage type T, kept as f32
template <typename T> __device__ __forceinline__ float rnd(float v) {
  return to_f(from_f<T>(v));
}

template <typename T> __device__ __forceinline__ float leaky(float v) {
  return rnd<T>(v > 0.f ? v : v * kSlope);
}

__host__ __device__ __forceinline__ int round_up(int n, int m) {
  return (n + m - 1) / m * m;
}

// acc[r] += sum_j sum_ci src[(r + j*step) * C + ci] * w[(j*C + ci)*C + co]
// for kRows consecutive output rows; src points at the row that output row
// 0 reads through tap 0. The order of the sum is fixed (taps, then input
// channels), so a row's value does not depend on its tile.
template <typename T>
__device__ __forceinline__ void conv_rows(float (&acc)[kRows],
                                          const float* src,
                                          const T* __restrict__ w, int C,
                                          int k, int step, int co) {
  for (int j = 0; j < k; ++j) {
    const float* s = src + j * step * C;
    const T* wj = w + (size_t)j * C * C + co;
    for (int ci = 0; ci < C; ci += 4) {
      const float w0 = to_f(wj[(size_t)(ci + 0) * C]);
      const float w1 = to_f(wj[(size_t)(ci + 1) * C]);
      const float w2 = to_f(wj[(size_t)(ci + 2) * C]);
      const float w3 = to_f(wj[(size_t)(ci + 3) * C]);
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float4 a = *reinterpret_cast<const float4*>(s + r * C + ci);
        float v = acc[r];
        v = fmaf(a.x, w0, v);
        v = fmaf(a.y, w1, v);
        v = fmaf(a.z, w2, v);
        v = fmaf(a.w, w3, v);
        acc[r] = v;
      }
    }
  }
}

// conv1 over `n_rows` rows (a multiple of kRows) into dst:
//   dst[i] = mask(t0 + i) * leaky(rnd(b1 + conv1_d(src)[i]))
// src row i + j*d is tap j of output row i.
template <typename T>
__device__ void conv1_stage(float* dst, const float* src, const T* w,
                            const float* b, int C, int k, int d, int n_rows,
                            int t0, int T_len) {
  const int co = threadIdx.x % C, ty = threadIdx.x / C;
  const int ny = blockDim.x / C;
  const float bias = b[co];
  for (int i0 = ty * kRows; i0 < n_rows; i0 += ny * kRows) {
    float acc[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) acc[r] = 0.f;
    conv_rows<T>(acc, src + (size_t)i0 * C, w, C, k, d, co);
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int t = t0 + i0 + r;
      const bool in = t >= 0 && t < T_len;
      dst[(size_t)(i0 + r) * C + co] = in ? leaky<T>(rnd<T>(acc[r] + bias))
                                          : 0.f;
    }
  }
}

// One pass per launch (wide variant): y = x + conv2(leaky(conv1_d(leaky(x)
// * mask) + b1) * mask) + b2 for the output rows [t0, t0 + tile).
template <typename T>
__global__ void __launch_bounds__(kThreads)
resblock1_pass_kernel(const T* __restrict__ x, T* __restrict__ y,
                      const T* __restrict__ w1, const float* __restrict__ b1,
                      const T* __restrict__ w2, const float* __restrict__ b2,
                      int T_len, int C, int k, int d, int tile) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int r = (k - 1) / 2;
  const int h1 = r * d, h2 = r;
  const int nz = round_up(tile + 2 * h2, kRows);
  const int na = nz + 2 * h1;
  float* A = smem;                      // [na, C]: leaky(x) * mask
  float* Z = smem + (size_t)na * C;     // [nz, C]: conv1 output
  const int t0 = blockIdx.x * tile;
  const size_t base = (size_t)blockIdx.y * T_len * C;
  const T* xb = x + base;
  T* yb = y + base;

  const int a0 = t0 - h2 - h1;          // time of A row 0
  for (int idx = threadIdx.x; idx < na * C; idx += blockDim.x) {
    const int t = a0 + idx / C;
    A[idx] = (t >= 0 && t < T_len)
                 ? leaky<T>(to_f(xb[(size_t)t * C + idx % C])) : 0.f;
  }
  __syncthreads();
  conv1_stage<T>(Z, A, w1, b1, C, k, d, nz, t0 - h2, T_len);
  __syncthreads();

  const int co = threadIdx.x % C, ty = threadIdx.x / C;
  const int ny = blockDim.x / C;
  const float bias = b2[co];
  for (int i0 = ty * kRows; i0 < tile; i0 += ny * kRows) {
    float acc[kRows];
#pragma unroll
    for (int q = 0; q < kRows; ++q) acc[q] = 0.f;
    conv_rows<T>(acc, Z + (size_t)i0 * C, w2, C, k, 1, co);
#pragma unroll
    for (int q = 0; q < kRows; ++q) {
      const int t = t0 + i0 + q;
      if (t < T_len) {
        const size_t o = (size_t)t * C + co;
        yb[o] = from_f<T>(to_f(xb[o]) + rnd<T>(acc[q] + bias));
      }
    }
  }
}

struct Dilations {
  int n;
  int d[4];
};

// The whole ResBlock in one launch (narrow variant). Buffers are indexed by
// window row w, time t = t0 - H + w, H the summed halo of all passes; each
// pass shrinks the valid margin e by r*(d + 1). Rows computed past a valid
// range (chunk rounding) read stale but finite values and only feed rows
// that are discarded, as in the Pallas kernel's overlap-discard.
template <typename T>
__global__ void __launch_bounds__(kThreads)
resblock1_fused_kernel(const T* __restrict__ x, T* __restrict__ y,
                       const T* __restrict__ w1,
                       const float* __restrict__ b1,
                       const T* __restrict__ w2,
                       const float* __restrict__ b2, int T_len, int C, int k,
                       Dilations dil, int tile) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int r = (k - 1) / 2;
  int H = 0;
  for (int p = 0; p < dil.n; ++p) H += r * (dil.d[p] + 1);
  const int nw = tile + 2 * H;
  const int nb = nw + kRows;            // slack for rounded chunks
  float* Hb = smem;                     // residual stream h
  float* A = Hb + (size_t)nb * C;       // leaky(h) * mask
  float* Z = A + (size_t)nb * C;        // conv1 output
  const int t0 = blockIdx.x * tile;
  const int w0 = t0 - H;                // time of window row 0
  const size_t base = (size_t)blockIdx.y * T_len * C;
  const T* xb = x + base;
  T* yb = y + base;

  for (int idx = threadIdx.x; idx < nb * C; idx += blockDim.x) {
    const int w = idx / C, t = w0 + w;
    Hb[idx] = (w < nw && t >= 0 && t < T_len)
                  ? to_f(xb[(size_t)t * C + idx % C]) : 0.f;
    Z[idx] = 0.f;
  }
  const int co = threadIdx.x % C, ty = threadIdx.x / C;
  const int ny = blockDim.x / C;
  int e = H;                            // valid margin of Hb on each side
  for (int p = 0; p < dil.n; ++p) {
    const int d = dil.d[p];
    const int e_out = e - r * (d + 1);
    __syncthreads();
    for (int idx = threadIdx.x; idx < nb * C; idx += blockDim.x) {
      const int w = idx / C, t = w0 + w;
      A[idx] = (w < nw && t >= 0 && t < T_len) ? leaky<T>(Hb[idx]) : 0.f;
    }
    __syncthreads();
    // conv1 rows [lo_z, lo_z + nz): row w reads A[w + (j - r)*d]
    const int lo_z = H - e_out - r;
    const int nz = round_up(tile + 2 * (e_out + r), kRows);
    conv1_stage<T>(Z + (size_t)lo_z * C, A + (size_t)(lo_z - r * d) * C,
                   w1 + (size_t)p * k * C * C, b1 + p * C, C, k, d, nz,
                   w0 + lo_z, T_len);
    __syncthreads();
    // conv2 + residual on rows [lo_h, lo_h + nh): row w reads Z[w + j - r]
    const int lo_h = H - e_out;
    const int nh = round_up(tile + 2 * e_out, kRows);
    const T* w2p = w2 + (size_t)p * k * C * C;
    const float bias = b2[p * C + co];
    for (int i0 = ty * kRows; i0 < nh; i0 += ny * kRows) {
      float acc[kRows];
#pragma unroll
      for (int q = 0; q < kRows; ++q) acc[q] = 0.f;
      conv_rows<T>(acc, Z + (size_t)(lo_h + i0 - r) * C, w2p, C, k, 1, co);
#pragma unroll
      for (int q = 0; q < kRows; ++q) {
        float* h = Hb + (size_t)(lo_h + i0 + q) * C + co;
        *h = rnd<T>(*h + rnd<T>(acc[q] + bias));
      }
    }
    e = e_out;
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < tile * C; idx += blockDim.x) {
    const int t = t0 + idx / C;
    if (t < T_len) yb[(size_t)t * C + idx % C] = from_f<T>(Hb[H * C + idx]);
  }
}

bool shape_ok(int C, int k, int tile) {
  return C >= 4 && C % 4 == 0 && kThreads % C == 0 && k >= 1 && k % 2 == 1 &&
         tile > 0 && tile % kRows == 0;
}

template <typename T>
int launch_pass(const void* x, void* y, const void* w1, const void* b1,
                const void* w2, const void* b2, int B, int T_len, int C,
                int k, int d, int tile, cudaStream_t stream) {
  const int r = (k - 1) / 2;
  const int nz = round_up(tile + 2 * r, kRows);
  const size_t smem = (size_t)(nz + nz + 2 * r * d) * C * sizeof(float);
  if (!shape_ok(C, k, tile) || d < 1 || smem > kMaxSmem)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      resblock1_pass_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((T_len + tile - 1) / tile, B);
  resblock1_pass_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(y),
      static_cast<const T*>(w1), static_cast<const float*>(b1),
      static_cast<const T*>(w2), static_cast<const float*>(b2), T_len, C, k,
      d, tile);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_fused(const void* x, void* y, const void* w1, const void* b1,
                 const void* w2, const void* b2, int B, int T_len, int C,
                 int k, Dilations dil, int tile, cudaStream_t stream) {
  const int r = (k - 1) / 2;
  int H = 0;
  for (int p = 0; p < dil.n; ++p) {
    if (dil.d[p] < 1) return (int)cudaErrorInvalidValue;
    H += r * (dil.d[p] + 1);
  }
  const size_t smem = (size_t)3 * (tile + 2 * H + kRows) * C * sizeof(float);
  if (!shape_ok(C, k, tile) || dil.n < 1 || dil.n > 4 || smem > kMaxSmem)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      resblock1_fused_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((T_len + tile - 1) / tile, B);
  resblock1_fused_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(y),
      static_cast<const T*>(w1), static_cast<const float*>(b1),
      static_cast<const T*>(w2), static_cast<const float*>(b2), T_len, C, k,
      dil, tile);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. Weights [k, C_in, C_out] in x's dtype,
// biases [C] f32, for this pass only.
int resblock1_pass(const void* x, void* y, const void* w1, const void* b1,
                   const void* w2, const void* b2, int B, int T_len, int C,
                   int k, int d, int tile, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_pass<float>(x, y, w1, b1, w2, b2, B, T_len, C, k, d, tile,
                              s);
  if (dtype == 1)
    return launch_pass<__nv_bfloat16>(x, y, w1, b1, w2, b2, B, T_len, C, k,
                                      d, tile, s);
  return (int)cudaErrorInvalidValue;
}

// Weights [n_d, k, C_in, C_out] in x's dtype, biases [n_d, C] f32; n_d <= 3
// dilations d0..d2 (the unused ones ignored).
int resblock1_fused(const void* x, void* y, const void* w1, const void* b1,
                    const void* w2, const void* b2, int B, int T_len, int C,
                    int k, int n_d, int d0, int d1, int d2, int tile,
                    int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_d < 1 || n_d > 3) return (int)cudaErrorInvalidValue;
  Dilations dil{n_d, {d0, d1, d2, 0}};
  if (dtype == 0)
    return launch_fused<float>(x, y, w1, b1, w2, b2, B, T_len, C, k, dil,
                               tile, s);
  if (dtype == 1)
    return launch_fused<__nv_bfloat16>(x, y, w1, b1, w2, b2, B, T_len, C, k,
                                       dil, tile, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
