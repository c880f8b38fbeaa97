// Monotonic alignment search (MAS) for Hopper (sm_90a): width-1 Viterbi over
// a log-attention map, one block per batch row, the rows streamed into a
// shared-memory ring by a producer warp while consumer warps run the DP.
//
// Replaces tts_arabic_tpu/ops/mas_pallas.py:85 mas_pallas (`_opt_kernel`,
// :37). It computes what tts_arabic_tpu/align/mas.py::mas computes (the
// function the JAX train step runs): -inf outside each row's text length,
//   row_t[j] = attn_t[j] + max(row_{t-1}[j], row_{t-1}[j-1]),
// then a backtrack from (out_len-1, in_len-1) that moves diagonally when
// row_{t-1}[j-1] >= row_{t-1}[j]. Same f32 adds and maxes in the same order
// (max.NaN, as torch.maximum), exact comparisons, so the one-hot output
// equals the plain version (tts_arabic_torch/align/mas.py) bit for bit.
// Build without fast-math: it would break the -inf arithmetic. Columns at
// or past in_len are not masked: no value left of them depends on them, and
// the backtrack never reads their bits.
//
// What bounds it. Bytes: the valid log_attn region read once and the
// [B, T_mel, T_txt] f32 output written once (chip_smoke.py's mas_bound_ms;
// about 14 us over the training run's seven calls at 3.35 TB/s). That bound
// is out of reach: the DP is a chain of out_len dependent steps, and the
// backtrack a chain of out_len dependent bit reads. The chain, reckoned
// (not a bound): per frame a shuffle, a select, a max and an add, about 35
// cycles, and the walk's subtract, shift, and and subtract, about 20; at
// 1024 frames and 1.98 GHz some 30 us a call. At the training width (T_txt
// 144, K = 5 columns a lane) a step is 46 SASS instructions in one warp (K
// ring loads, shuffles, selects, compares, ballots, maxes and adds, one
// bit store, the loop), issued in order: on an H100 it takes about 165
// cycles a frame and the backtrack about 27 (PERF.md).
//
// Design, against what held the first kernel (one lone warp per row) back:
// - warp 0 is a producer: one lane streams rows [0, out_len) into a ring
//   of S stages of R rows (R up to 32, S 4-8, about 128 KB), one mbarrier
//   per stage for "full" and one for "empty". A stage is one TMA bulk copy
//   (cp.async.bulk ... mbarrier::complete_tx): the rows stay T_txt floats
//   apart, as in global memory, and the copy spans from the 16-byte
//   boundary at or before the stage's first float to the one at or after
//   its last, so a row that starts off a boundary (odd T_txt, an offset
//   view) needs no other path. The consumers' instruction streams hold no
//   global load; the ring runs up to S*R rows ahead of the chain. (A copy
//   per row cost the producer about 250 cycles a row, more than a step.)
// - warps 1..nw are consumers: warp w owns columns [w*32K, (w+1)*32K), and
//   within them lane l owns columns l, l+32, ..., so a staged row is read
//   with no bank conflict. One __shfl_sync per column (from lane l-1, lane
//   0 from lane 31's previous column) gives row_{t-1}[j-1]; a warp's first
//   column gets it from the warp on its left through shared memory, with
//   one named barrier (bar.sync 1) a step when nw > 1;
// - exact K: K = ceil(T_txt / (32 nw)) with nw = ceil(T_txt / 1024), and
//   the kernel is instantiated for every K in 1..32 (no power-of-two
//   rounding: 5 columns a lane at T_txt 144, not 8);
// - a step: row 0 and the edge exchange stay out of the single-warp loop
//   (the exchange is its own instantiation); each frame issues its K ring
//   loads and its K shuffles together, so their latencies overlap, and the
//   rest is register arithmetic;
// - direction bits: one __ballot_sync per column slot packs the 32 bits of
//   32 adjacent columns into one word, which lane k keeps for slot k, so a
//   frame is one store by lanes 0..K-1 of ceil(T_txt/32) words (20 B at
//   T_txt 144). They stay in shared memory when T_mel rows of them fit
//   beside the ring, else they spill to a global scratch the wrapper
//   allocates (mas_scratch_words says which);
// - backtrack: warp 1 walks frames out_len-1 .. 1, every lane the same
//   path; for 32 frames at a time it first cuts from the bit words one
//   32-bit window a frame, the columns [j-31, j] around the current column
//   j (it falls by at most one a frame), so a frame's walk is a shift, an
//   and and two subtracts. Lane r keeps frame hi-r's column, and the 32
//   ones of a walk go out as one store instruction after it;
// - the output is written once, by the kernel: warps nw+1 and nw+2 clear
//   the row's whole [T_mel, T_txt] span in 16-byte stores while the DP
//   runs, and the backtrack's 1s follow a block barrier. The wrapper
//   allocates the output with torch.empty. A row with in_len outside
//   [1, T_txt] or out_len < 1 is all zero.
// T_txt up to kMaxTxt = 12288 (12 consumer warps; four ring stages of one
// 49 KB row then fill 197 KB of the 227 KB a block may use).
//
// C interface for ctypes: pointers and the stream as void*, the return
// value is cudaGetLastError() after the launch (0 = success).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kLanes = 32;
constexpr int kMaxK = 32;                         // columns a lane
constexpr int kColsPerWarp = kLanes * kMaxK;      // 1024
constexpr int kMaxTxt = 12288;
constexpr int kMaxWarps = kMaxTxt / kColsPerWarp;  // consumer warps
constexpr int kWriters = 2;                       // warps clearing the output
constexpr int kMaxThreads = kLanes * (1 + kMaxWarps + kWriters);
constexpr int kHeadBytes = 256;   // mbarriers (128 B), edge exchange (96 B)
constexpr size_t kSmemMax = 232448;               // 227 KB a block on sm_90
constexpr int kWalk = 32;         // backtrack frames per batch of bit loads

struct Plan {
  int nw, K, words, SP, R, S, threads;
  size_t smem;
  bool spill;
};

int clampi(int v, int lo, int hi) { return v < lo ? lo : v > hi ? hi : v; }

// nw consumer warps of K columns a lane; R rows a stage, staged as they lie
// in global memory (T_txt floats apart), SP floats a stage: the rows' span
// from the 16-byte boundary before it, and room for the last row's reads
// past T_txt; S stages; the bits in shared memory unless they do not fit.
bool make_plan(int T_mel, int T_txt, Plan* p) {
  if (T_mel < 1 || T_txt < 1 || T_txt > kMaxTxt) return false;
  p->nw = (T_txt + kColsPerWarp - 1) / kColsPerWarp;
  p->K = (T_txt + kLanes * p->nw - 1) / (kLanes * p->nw);
  p->words = p->nw * p->K;
  p->R = clampi(32768 / (4 * T_txt), 1, 32);
  p->SP = (p->R * T_txt + 6 + p->words * kLanes - T_txt + 3) & ~3;
  const int stage = 4 * p->SP;
  p->S = clampi(131072 / stage, 4, 8);
  const size_t ring = (size_t)p->S * stage;
  const size_t bits = (size_t)T_mel * p->words * 4;
  p->spill = kHeadBytes + ring + bits > kSmemMax;
  p->smem = kHeadBytes + ring + (p->spill ? 0 : bits);
  p->threads = kLanes * (1 + p->nw + kWriters);
  return p->smem <= kSmemMax;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count));
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_u32(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  } while (!done);
}
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}
__device__ __forceinline__ void consumers_sync(int threads) {
  asm volatile("bar.sync 1, %0;\n" ::"r"(threads) : "memory");
}
__device__ __forceinline__ float max_nan(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;\n" : "=f"(r) : "f"(a), "f"(b));
  return r;
}
__device__ __forceinline__ int misalign(const float* p) {  // floats past 16 B
  return static_cast<int>((reinterpret_cast<uintptr_t>(p) >> 2) & 3);
}

// zeros o[0, n), threads tid, tid + nthreads, ...: 16-byte stores between
// 4-byte ends
__device__ void clear(float* o, size_t n, int tid, int nthreads) {
  size_t head = (4 - misalign(o)) & 3;
  if (head > n) head = n;
  for (size_t i = tid; i < head; i += nthreads) o[i] = 0.f;
  const size_t nvec = (n - head) / 4;
  float4* v = reinterpret_cast<float4*>(o + head);
  const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
  for (size_t i = tid; i < nvec; i += nthreads) v[i] = z;
  for (size_t i = head + 4 * nvec + tid; i < n; i += nthreads) o[i] = 0.f;
}

// warp 0, lane 0: rows [0, out_len) into the ring, a stage of R rows by
// one bulk copy of their whole span, from the 16-byte boundary at or
// before its start to the one at or after its end
__device__ void produce(const float* a, float* ring, uint64_t* full,
                        uint64_t* empty, int out_len, int T_txt, int SP,
                        int R, int S) {
  int s = 0;
  uint32_t phase = 0;
  for (int t0 = 0, i = 0; t0 < out_len; t0 += R, ++i) {
    if (i >= S) mbar_wait(&empty[s], phase ^ 1);
    const float* src = a + (size_t)t0 * T_txt;
    const int m = misalign(src);
    const uint32_t bytes = (4 * (min(R, out_len - t0) * T_txt + m) + 15) & ~15;
    mbar_arrive_expect_tx(&full[s], bytes);
    bulk_copy(ring + (size_t)s * SP, src - m, bytes, &full[s]);
    if (++s == S) {
      s = 0;
      phase ^= 1;
    }
  }
}

// consumer warp w: the DP over its columns, the direction bits of each
// frame t >= 1 into bits[t * words + w * K + k] (frame 0's are zero).
// kSpill: bits is global memory, else shared; kMulti: nw > 1 warps pass
// their edge columns. Each pair is its own instantiation, so that every
// access has its own space (a generic store, which might alias the ring,
// holds back the ring's loads behind it) and the single-warp step has no
// branch.
template <int K, bool kSpill, bool kMulti>
__device__ void forward(const float* ring, uint32_t* bits, float* edge,
                        uint64_t* full, uint64_t* empty, int out_len,
                        int T_txt, int words, int nw, int w, int lane, int m0,
                        int SP, int R, int S) {
  const float kNeg = -INFINITY;
  const int col0 = w * K * kLanes + lane;  // slot k holds column col0 + 32k
  const int src = (lane + kLanes - 1) % kLanes;
  const bool store = lane < K;             // lane k stores slot k's word
  uint32_t* bp = bits + w * K + lane;  // frame 0's word: no move, zero
  if (store) *bp = 0u;
  bp += words;
  // this warp's last column of frame t to the warp on its right
  auto pass_edge = [&](int t, const float* prev) {
    if (lane == kLanes - 1) edge[(t & 1) * kMaxWarps + w] = prev[K - 1];
    consumers_sync(nw * kLanes);
  };
  float prev[K];
  mbar_wait(&full[0], 0);
#pragma unroll
  for (int k = 0; k < K; ++k)
    prev[k] = col0 + k * kLanes == 0 ? ring[m0 + col0 + k * kLanes] : kNeg;
  if constexpr (kMulti) pass_edge(0, prev);
  int s = 0, r0 = 1, t = 1;
  uint32_t phase = 0;
  for (int base = 0;;) {  // stage s holds frames [base, base + R)
    const int nr = min(R, out_len - base);
    // the stage starts (m0 + base * T_txt) mod 4 floats past its boundary
    const int m = (m0 + (base & 3) * (T_txt & 3)) & 3;
    const float* row = ring + (size_t)s * SP + m + r0 * T_txt + col0;
    for (int r = r0; r < nr; ++r, ++t, row += T_txt, bp += words) {
      // the row's loads and the K shuffles go out together; their
      // latencies overlap, and the rest of the step is register arithmetic
      float cur[K], sh[K];  // sh: row t-1 at column - 1, from lane l - 1
#pragma unroll
      for (int k = 0; k < K; ++k) cur[k] = row[k * kLanes];
#pragma unroll
      for (int k = 0; k < K; ++k) sh[k] = __shfl_sync(kFull, prev[k], src);
      float left = kNeg;  // column w*32K - 1
      if constexpr (kMulti)
        if (lane == 0 && w > 0) left = edge[((t - 1) & 1) * kMaxWarps + w - 1];
      uint32_t mine = 0;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const float stay = prev[k];
        const float diag = lane > 0 ? sh[k] : k > 0 ? sh[k - 1] : left;
        const uint32_t word = __ballot_sync(kFull, diag >= stay);
        mine = lane == k ? word : mine;
        prev[k] = cur[k] + max_nan(stay, diag);
      }
      if (store) *bp = mine;
      if constexpr (kMulti) pass_edge(t, prev);
    }
    base += R;
    if (base >= out_len) break;
    __syncwarp();  // the stage's loads are done: free it, take the next
    if (lane == 0) mbar_arrive(&empty[s]);
    if (++s == S) {
      s = 0;
      phase ^= 1;
    }
    mbar_wait(&full[s], phase);
    r0 = 0;
  }
}

// one warp: the path from (out_len-1, in_len-1), its 1s into o. Every
// lane walks the same path (the bit loads are broadcasts); lane r keeps the
// column of frame hi - r of each 32-frame walk, so the walk's 32 ones go
// out as one store instruction after it. kSpill as for forward.
template <bool kSpill>
__device__ void backtrack(const uint32_t* bits, float* o, int words,
                          int T_txt, int in_len, int out_len, int lane) {
  int j = in_len - 1;
  for (int hi = out_len - 1; hi >= 1; hi -= kWalk) {
    // the next kWalk frames read columns [j - kWalk + 1, j] (the column
    // falls by at most one a frame): one 32-bit window a frame, cut from
    // the two words around it before the walk, with no branch; column 0
    // and frames before frame 1 never move
    const int lo = max(j - kWalk + 1, 0);
    const int wb = lo >> 5;
    const bool two = wb + 1 < words;
    const uint32_t keep = lo == 0 ? ~1u : ~0u;
    uint32_t win[kWalk];
#pragma unroll
    for (int r = 0; r < kWalk; ++r) {  // frames before 1 read frame 0's zeros
      const uint32_t* bw = bits + (size_t)max(hi - r, 0) * words + wb;
      const uint32_t w0 = bw[0], w1 = bw[two ? 1 : 0];
      win[r] = __funnelshift_r(w0, two ? w1 : 0u, lo & 31) & keep;
    }
    int mine = 0;
#pragma unroll
    for (int r = 0; r < kWalk; ++r) {
      mine = lane == r ? j : mine;
      j -= (win[r] >> (j - lo)) & 1;
    }
    if (hi - lane >= 1) o[(size_t)(hi - lane) * T_txt + mine] = 1.f;
  }
  if (lane == 0) o[j] = 1.f;  // frame 0
}

template <int K>
__global__ void __launch_bounds__(kMaxThreads)
    mas_kernel(const float* __restrict__ attn, const int* __restrict__ in_lens,
               const int* __restrict__ out_lens, float* __restrict__ out,
               uint32_t* __restrict__ bits_global, int T_mel, int T_txt,
               int nw, int SP, int R, int S) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int b = blockIdx.x;
  const int warp = threadIdx.x / kLanes, lane = threadIdx.x % kLanes;
  const int in_len = in_lens[b];
  const int out_len = min(out_lens[b], T_mel);
  const size_t span = (size_t)T_mel * T_txt;
  float* o = out + b * span;
  if (in_len < 1 || in_len > T_txt || out_len < 1) {  // an all-zero row
    clear(o, span, threadIdx.x, blockDim.x);
    return;
  }
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + 8;
  float* edge = reinterpret_cast<float*>(smem + 128);  // [2][kMaxWarps]
  float* ring = reinterpret_cast<float*>(smem + kHeadBytes);
  const int words = nw * K;
  uint32_t* gbits = bits_global;  // the row's scratch, where bits spill
  if (gbits) gbits += (size_t)b * T_mel * words;
  uint32_t* sbits = reinterpret_cast<uint32_t*>(ring + (size_t)S * SP);
  const float* a = attn + b * span;
  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 1);  // the producer's expect_tx
      mbar_init(&empty[s], nw);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // ---- forward pass
  if (warp == 0) {
    if (lane == 0) produce(a, ring, full, empty, out_len, T_txt, SP, R, S);
  } else if (warp <= nw) {
    const int m0 = misalign(a);
    if constexpr (K > kMaxK / 2) {  // only these K have nw > 1
      if (nw > 1) {
        if (bits_global)
          forward<K, true, true>(ring, gbits, edge, full, empty, out_len,
                                 T_txt, words, nw, warp - 1, lane, m0, SP, R,
                                 S);
        else
          forward<K, false, true>(ring, sbits, edge, full, empty, out_len,
                                  T_txt, words, nw, warp - 1, lane, m0, SP, R,
                                  S);
      }
    }
    if (nw == 1) {
      if (bits_global)
        forward<K, true, false>(ring, gbits, edge, full, empty, out_len,
                                T_txt, words, nw, 0, lane, m0, SP, R, S);
      else
        forward<K, false, false>(ring, sbits, edge, full, empty, out_len,
                                 T_txt, words, nw, 0, lane, m0, SP, R, S);
    }
    // ---- forward done
  } else {
    clear(o, span, threadIdx.x - (1 + nw) * kLanes, kWriters * kLanes);
    // ---- output cleared
  }
  __syncthreads();  // the bits and the cleared output, to the backtrack
  // ---- backtrack
  if (warp == 1) {
    if (bits_global)
      backtrack<true>(gbits, o, words, T_txt, in_len, out_len, lane);
    else
      backtrack<false>(sbits, o, words, T_txt, in_len, out_len, lane);
  }
  // ---- end
}

template <int K>
int launch(const Plan& p, const void* attn, const void* in_lens,
           const void* out_lens, void* out, void* bits, int B, int T_mel,
           int T_txt, cudaStream_t s) {
  if (p.smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        mas_kernel<K>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(p.smem));
    if (e != cudaSuccess) return (int)e;
  }
  mas_kernel<K><<<B, p.threads, p.smem, s>>>(
      static_cast<const float*>(attn), static_cast<const int*>(in_lens),
      static_cast<const int*>(out_lens), static_cast<float*>(out),
      static_cast<uint32_t*>(bits), T_mel, T_txt, p.nw, p.SP, p.R, p.S);
  return (int)cudaGetLastError();
}

template <int K>
int dispatch(const Plan& p, const void* attn, const void* in_lens,
             const void* out_lens, void* out, void* bits, int B, int T_mel,
             int T_txt, cudaStream_t s) {
  if constexpr (K > kMaxK) {
    return (int)cudaErrorInvalidValue;
  } else {
    if (p.K == K)
      return launch<K>(p, attn, in_lens, out_lens, out, bits, B, T_mel, T_txt,
                       s);
    return dispatch<K + 1>(p, attn, in_lens, out_lens, out, bits, B, T_mel,
                           T_txt, s);
  }
}

}  // namespace

extern "C" {

// uint32 words of global scratch a batch row needs for its direction bits:
// 0 when they fit in shared memory, -1 for a shape no kernel takes
int mas_scratch_words(int T_mel, int T_txt) {
  Plan p;
  if (!make_plan(T_mel, T_txt, &p)) return -1;
  return p.spill ? T_mel * p.words : 0;
}

// log_attn [B, T_mel, T_txt] f32, in/out lens [B] int32, out [B, T_mel,
// T_txt] f32 (written whole by the kernel), bits [B, mas_scratch_words]
// uint32 scratch, or null where that is 0. T_txt <= 12288.
int mas_forward(const void* attn, const void* in_lens, const void* out_lens,
                void* out, void* bits, int B, int T_mel, int T_txt,
                void* stream) {
  Plan p;
  if (B < 1 || !make_plan(T_mel, T_txt, &p) || (p.spill && bits == nullptr))
    return (int)cudaErrorInvalidValue;
  return dispatch<1>(p, attn, in_lens, out_lens, out, p.spill ? bits : nullptr,
                     B, T_mel, T_txt, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
