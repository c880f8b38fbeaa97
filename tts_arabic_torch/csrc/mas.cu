// Monotonic alignment search (MAS) for Hopper (sm_90a): width-1 Viterbi over
// a log-attention map, one batch row per warp.
//
// Replaces tts_arabic_tpu/ops/mas_pallas.py::mas_pallas (`_opt_kernel`). It
// computes what tts_arabic_tpu/align/mas.py::mas computes (the function the
// JAX train step runs): -inf outside each row's text length,
//   row_t[j] = attn_t[j] + max(row_{t-1}[j], row_{t-1}[j-1]),
// then a backtrack from (out_len-1, in_len-1) that moves diagonally when
// row_{t-1}[j-1] >= row_{t-1}[j]. Same f32 add/max in the same order, and
// exact comparisons, so the one-hot output equals the plain version
// (tts_arabic_torch/align/mas.py) bit for bit. Build without fast-math: it
// would break the -inf arithmetic.
//
// Design (simple and right first):
// - one warp (one block of 32 threads) per batch row; the T_mel loop runs in
//   the warp, as the TPU grid's sequential loop did;
// - lane l owns the K contiguous text columns [l*K, l*K + K), K = T_txt/32
//   rounded up to a power of two (1..32), so one row holds up to 1024
//   columns: the kernel refuses T_txt > 1024 (kMaxTxt);
// - forward: each step needs row_{t-1}[l*K - 1] from the lane on the left,
//   one __shfl_up_sync; the rest is in registers. The backtrack decision of
//   every cell is kept as one direction bit, row_{t-1}[j-1] >= row_{t-1}[j]
//   (exactly the comparison the backtrack makes), K bits per lane packed in
//   one uint32 word, so the f32 table is never stored. The bits
//   [B, T_mel, 32] words go to a global scratch tensor the wrapper allocates:
//   the 30000-frame bucket's bits (3.8 MB a row) do not fit in shared memory;
// - log_attn rows reach shared memory in chunks of R rows by cp.async, the
//   next chunk in flight while the warp works through the current one (the
//   loads do not depend on the chain); each lane's columns sit at a padded
//   stride of K+1 words, so the per-step reads have no bank conflicts;
// - backtrack: the bit rows are staged in shared memory a chunk at a time by
//   the whole warp, and lane 0 walks t = out_len-1 .. 1, writing the one-hot
//   rows into the output the wrapper has zeroed; rows >= out_len stay zero.
//
// What bounds it on the card: the bytes are small (log_attn read once where
// it is valid, sum_b out_len*in_len*4, and the [B, T_mel, T_txt] f32 output
// written once: about 21 MB, 6.3 us at 3.35 TB/s, at [10, 1024, 256]), and
// the operations are three per cell. The real floor is latency: the
// out_len-long dependent chain of the forward pass (a shuffle, a max and an
// add per step) and the serial backtrack (a shared-memory read per step),
// with only B warps on 132 SMs. The design keeps the chain in registers and
// takes the loads off it; it does not try to fill the card.
//
// C interface for ctypes: pointers and the stream as void*, the return
// value is cudaGetLastError() after the launch (0 = success).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kLanes = 32;
constexpr int kMaxTxt = kLanes * 32;  // 32 lanes x 32 direction bits

// rows of log_attn per cp.async chunk: one buffer is about 17-20 KB
__host__ __device__ constexpr int chunk_rows(int K) {
  return K >= 32 ? 4 : K >= 16 ? 8 : K >= 8 ? 16 : 32;
}

__device__ __forceinline__ void cp_async4(float* smem, const float* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_prev() {  // all but the newest
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

template <int K>
__global__ void __launch_bounds__(kLanes)
    mas_kernel(const float* __restrict__ attn, const int* __restrict__ in_lens,
               const int* __restrict__ out_lens, float* __restrict__ out,
               uint32_t* __restrict__ bits, int T_mel, int T_txt) {
  constexpr int R = chunk_rows(K);
  constexpr int W = K + 1;              // padded stride of a lane's columns
  constexpr int kRow = kLanes * W;      // floats per staged row
  __shared__ float buf[2][R * kRow];

  const int b = blockIdx.x;
  const int lane = threadIdx.x;
  const int in_len = in_lens[b];
  const int out_len = min(out_lens[b], T_mel);
  if (in_len < 1 || in_len > T_txt || out_len < 1) return;  // all-zero row

  const float* a = attn + (size_t)b * T_mel * T_txt;
  float* o = out + (size_t)b * T_mel * T_txt;
  uint32_t* bt = bits + (size_t)b * T_mel * kLanes;
  const float kNeg = -INFINITY;

  // async copy of rows [t0, t0 + R) ∩ [0, out_len), columns < in_len
  auto stage = [&](int t0, float* dst) {
    const int nr = min(R, out_len - t0);
    for (int r = 0; r < nr; ++r)
      for (int j = lane; j < in_len; j += kLanes)
        cp_async4(dst + r * kRow + (j / K) * W + (j % K),
                  a + (size_t)(t0 + r) * T_txt + j);
    cp_async_commit();
  };

  // ---- forward pass ---------------------------------------------------------
  float prev[K];
  stage(0, buf[0]);
  for (int t0 = 0, c = 0; t0 < out_len; t0 += R, c ^= 1) {
    if (t0 + R < out_len)
      stage(t0 + R, buf[c ^ 1]);
    else
      cp_async_commit();  // empty group: wait_group 1 then covers chunk t0
    cp_async_wait_prev();
    __syncwarp();
    const int nr = min(R, out_len - t0);
    for (int r = 0; r < nr; ++r) {
      const float* row = buf[c] + r * kRow + lane * W;
      if (t0 + r == 0) {
#pragma unroll
        for (int k = 0; k < K; ++k)
          prev[k] = (lane == 0 && k == 0) ? row[0] : kNeg;
        continue;
      }
      float left = __shfl_up_sync(kFull, prev[K - 1], 1);
      if (lane == 0) left = kNeg;
      uint32_t word = 0;
#pragma unroll
      for (int k = K - 1; k >= 0; --k) {  // descending: prev[k-1] still old
        const float stay = prev[k];
        const float diag = k == 0 ? left : prev[k - 1];
        const float v = lane * K + k < in_len ? row[k] : kNeg;
        word |= static_cast<uint32_t>(diag >= stay) << k;
        prev[k] = v + fmaxf(stay, diag);
      }
      bt[(size_t)(t0 + r) * kLanes + lane] = word;
    }
    __syncwarp();  // the next stage() overwrites this buffer
  }

  // ---- backtrack ------------------------------------------------------------
  // the direction bits of up to RB rows at a time, in the (free) buffer
  constexpr int RB = 2 * R * kRow / kLanes;
  uint32_t* sb = reinterpret_cast<uint32_t*>(&buf[0][0]);
  int j = in_len - 1;
  for (int hi = out_len - 1; hi >= 1; hi -= RB) {
    const int lo = max(1, hi - RB + 1);
    const int n = (hi - lo + 1) * kLanes;
    __syncwarp();
    for (int idx = lane; idx < n; idx += kLanes)
      sb[idx] = bt[(size_t)lo * kLanes + idx];
    __syncwarp();
    if (lane == 0) {
      for (int t = hi; t >= lo; --t) {
        o[(size_t)t * T_txt + j] = 1.f;
        if (j > 0 && ((sb[(t - lo) * kLanes + j / K] >> (j % K)) & 1u)) --j;
      }
    }
    j = __shfl_sync(kFull, j, 0);
  }
  if (lane == 0) o[j] = 1.f;  // row 0
}

template <int K>
int launch(const void* attn, const void* in_lens, const void* out_lens,
           void* out, void* bits, int B, int T_mel, int T_txt,
           cudaStream_t s) {
  mas_kernel<K><<<B, kLanes, 0, s>>>(
      static_cast<const float*>(attn), static_cast<const int*>(in_lens),
      static_cast<const int*>(out_lens), static_cast<float*>(out),
      static_cast<uint32_t*>(bits), T_mel, T_txt);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// log_attn [B, T_mel, T_txt] f32, in/out lens [B] int32, out [B, T_mel,
// T_txt] f32 zeroed by the caller, bits scratch [B, T_mel, 32] uint32.
// T_txt <= 1024.
int mas_forward(const void* attn, const void* in_lens, const void* out_lens,
                void* out, void* bits, int B, int T_mel, int T_txt,
                void* stream) {
  if (B < 1 || T_mel < 1 || T_txt < 1 || T_txt > kMaxTxt)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int k = (T_txt + kLanes - 1) / kLanes;
  if (k <= 1) return launch<1>(attn, in_lens, out_lens, out, bits, B, T_mel, T_txt, s);
  if (k <= 2) return launch<2>(attn, in_lens, out_lens, out, bits, B, T_mel, T_txt, s);
  if (k <= 4) return launch<4>(attn, in_lens, out_lens, out, bits, B, T_mel, T_txt, s);
  if (k <= 8) return launch<8>(attn, in_lens, out_lens, out, bits, B, T_mel, T_txt, s);
  if (k <= 16) return launch<16>(attn, in_lens, out_lens, out, bits, B, T_mel, T_txt, s);
  return launch<32>(attn, in_lens, out_lens, out, bits, B, T_mel, T_txt, s);
}

}  // extern "C"
