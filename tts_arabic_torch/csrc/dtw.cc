// Dynamic time warping on the host, for `tts_arabic_torch.eval.dtw`.
//
// The accumulated-cost recurrence of the reference's DTW
// (`utils/oversmoothing.py:109-200`) over time-major float32 sequences
// A [Ta, M] and B [Tb, M]:
//
//   D[0][0] = 0, D[i][0] = D[0][j] = +inf,
//   D[i][j] = cost(A[i-1], B[j-1]) + min(D[i-1][j], D[i][j-1], D[i-1][j-1])
//
// the first of (up, left, diagonal) winning a tie, the cost the L2 distance
// (metric 0) or 1 - cosine similarity (metric 1), and with window >= 0 only
// the cells |i - j| <= window of a Sakoe-Chiba band computed. Each cell
// keeps its move as an int8 backpointer (0 up, 1 left, 2 diagonal, -1 never
// reached); the path is walked back from (Ta-1, Tb-1), and a cell never
// reached ends the walk and drops its own pair, as the reference's loop
// does. Two rows of D live at a time.
//
// Host C++ with a plain C interface, built at first use by
// `tts_arabic_torch/ops/build.py::host_library` (the host compiler, no CUDA)
// and called through ctypes. Sums run in float32 in index order, so the
// results match a float32 evaluation of the same formulas.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <vector>

namespace {

constexpr float kUnreached = 1e30f;

float l2_distance(const float* a, const float* b, int m) {
  float sum = 0.0f;
  for (int k = 0; k < m; ++k) {
    const float d = a[k] - b[k];
    sum += d * d;
  }
  return std::sqrt(sum);
}

float cosine_distance(const float* a, const float* b, int m) {
  float dot = 0.0f, aa = 0.0f, bb = 0.0f;
  for (int k = 0; k < m; ++k) {
    dot += a[k] * b[k];
    aa += a[k] * a[k];
    bb += b[k] * b[k];
  }
  return 1.0f - dot / (std::sqrt(aa) * std::sqrt(bb) + 1e-12f);
}

}  // namespace

extern "C" {

// Returns 0 on success, 1 on an empty or malformed input. `path` holds
// room for (Ta + Tb) pairs of int32 (i, j); `*path_len` receives the number
// written, in increasing time order.
int tts_dtw_path(const float* A, const float* B, int Ta, int Tb, int M,
                 int metric, int window, float* total_cost, int32_t* path,
                 int32_t* path_len) {
  if (Ta <= 0 || Tb <= 0 || M <= 0 || (metric != 0 && metric != 1)) {
    return 1;
  }
  const auto distance = metric == 0 ? l2_distance : cosine_distance;
  std::vector<float> above(Tb + 1, kUnreached), row(Tb + 1, kUnreached);
  std::vector<int8_t> moves(static_cast<size_t>(Ta) * Tb, -1);
  above[0] = 0.0f;

  for (int i = 1; i <= Ta; ++i) {
    const int lo = window >= 0 ? std::max(1, i - window) : 1;
    const int hi = window >= 0 ? std::min(Tb, i + window) : Tb;
    std::fill(row.begin(), row.end(), kUnreached);
    const float* a = A + static_cast<size_t>(i - 1) * M;
    int8_t* move_row = moves.data() + static_cast<size_t>(i - 1) * Tb;
    for (int j = lo; j <= hi; ++j) {
      float best = above[j];
      int8_t move = 0;
      if (row[j - 1] < best) {
        best = row[j - 1];
        move = 1;
      }
      if (above[j - 1] < best) {
        best = above[j - 1];
        move = 2;
      }
      row[j] = distance(a, B + static_cast<size_t>(j - 1) * M, M) + best;
      move_row[j - 1] = move;
    }
    above.swap(row);
  }
  *total_cost = above[Tb];

  // walk back, then reverse into `path`
  std::vector<int32_t> walk;
  walk.reserve(2 * static_cast<size_t>(Ta + Tb));
  int i = Ta - 1, j = Tb - 1;
  while (i >= 0 && j >= 0) {
    const int8_t move = moves[static_cast<size_t>(i) * Tb + j];
    if (move < 0) break;  // never reached: this pair is not on the path
    walk.push_back(i);
    walk.push_back(j);
    if (move != 1) --i;
    if (move != 0) --j;
  }
  const int n = static_cast<int>(walk.size() / 2);
  for (int k = 0; k < n; ++k) {
    path[2 * k] = walk[2 * (n - 1 - k)];
    path[2 * k + 1] = walk[2 * (n - 1 - k) + 1];
  }
  *path_len = n;
  return 0;
}

}  // extern "C"
