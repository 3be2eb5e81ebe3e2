// The port's copy of native/rapt.cc, the host tracker of
// speechsplit_tpu/ops/pitch_native.py; built with g++ by
// speechsplit_tpu_torch/ops/pitch_native.py. Only this header differs.
//
// Host-side RAPT-style pitch tracker (NCCF + Viterbi), C++.
//
// The reference delegates F0 extraction to the C RAPT implementation in
// SPTK via pysptk (make_spect_f0.py:64). This is a from-scratch C++
// tracker implementing the same algorithmic core — normalized
// cross-correlation candidates refined by parabolic interpolation and
// decoded with a voiced/unvoiced Viterbi — and deliberately mirrors the
// math of the batched on-device tracker (speechsplit_tpu/ops/pitch.py)
// so the two paths cross-validate. Used by host data workers that
// preprocess without a TPU attached.
//
// Build: g++ -O3 -march=native -shared -fPIC rapt.cc -o librapt.so
// ABI: plain C, numpy-friendly (see rapt_track below).

#include <cmath>
#include <cstring>
#include <vector>
#include <algorithm>
#include <limits>

namespace {

struct Params {
  int window = 120;          // correlation window, 7.5 ms @ 16 kHz
  int num_cands = 12;        // voiced candidates per frame
  float cand_thresh = 0.3f;  // min NCCF for a usable candidate
  float lag_weight = 0.3f;   // prefer shorter lags
  float freq_weight = 0.25f; // octave-jump transition penalty
  float voice_bias = 0.0f;   // bias toward voiced decisions
  float trans_cost = 0.3f;   // voiced<->unvoiced switch cost
};

constexpr float kUnvoiced = -1e10f;
constexpr float kBarred = 1e6f;

}  // namespace

extern "C" {

// x:        [n] float32 waveform (any scale; NCCF is normalized)
// n_frames: number of output frames (caller: n / hop + 1)
// lo, hi:   F0 search range in Hz
// out:      [n_frames] natural-log F0, unvoiced = -1e10
// Returns 0 on success.
int rapt_track(const float* x, long n, int fs, int hop,
               float lo, float hi, float* out, long n_frames) {
  Params p;
  const int kmin = std::max(2, (int)(fs / hi));
  const int kmax = (int)(fs / lo);
  const int n_lags = kmax - kmin + 1;
  const int W = p.window;
  const int K = p.num_cands;
  const long T = n_frames;

  // zero-padded copy so every frame's correlation span is in bounds
  const long span = (T - 1) * (long)hop + W + kmax + 1;
  std::vector<float> s(span, 0.0f);
  std::memcpy(s.data(), x, std::min(n, span) * sizeof(float));

  // prefix sums of s and s^2 for O(1) window means/energies
  std::vector<double> e(span + 1, 0.0), ps(span + 1, 0.0);
  for (long i = 0; i < span; ++i) {
    e[i + 1] = e[i] + (double)s[i] * s[i];
    ps[i + 1] = ps[i] + (double)s[i];
  }

  // per-frame candidates (mean-subtracted NCCF, matching ops/pitch.py:
  // immune to DC/rumble so unfiltered input is acceptable)
  std::vector<float> cand_lag(T * K), cand_score(T * K);
  std::vector<float> nccf(n_lags);
  for (long m = 0; m < T; ++m) {
    const long st = m * hop;
    const double s0 = ps[st + W] - ps[st];
    const double e0 = std::max(e[st + W] - e[st] - s0 * s0 / W, 0.0);
    for (int k = kmin; k <= kmax; ++k) {
      double num = 0.0;
      const float* a = s.data() + st;
      const float* b = s.data() + st + k;
      for (int i = 0; i < W; ++i) num += (double)a[i] * b[i];
      const double sk = ps[st + k + W] - ps[st + k];
      const double ek =
          std::max(e[st + k + W] - e[st + k] - sk * sk / W, 0.0);
      num -= s0 * sk / W;
      nccf[k - kmin] = (float)(num / std::sqrt(e0 * ek + 1e-12));
    }
    // local maxima, kept as a top-K selection
    struct Peak { float score; int pos; };
    std::vector<Peak> peaks;
    for (int i = 0; i < n_lags; ++i) {
      const float left = (i > 0) ? nccf[i - 1] : -2.0f;
      const float right = (i + 1 < n_lags) ? nccf[i + 1] : -2.0f;
      if (nccf[i] >= left && nccf[i] > right)
        peaks.push_back({nccf[i], i});
    }
    std::partial_sort(
        peaks.begin(), peaks.begin() + std::min<size_t>(K, peaks.size()),
        peaks.end(),
        [](const Peak& a, const Peak& b) { return a.score > b.score; });
    for (int c = 0; c < K; ++c) {
      if (c < (int)peaks.size()) {
        const int pos = peaks[c].pos;
        // parabolic lag refinement
        float delta = 0.0f;
        if (pos > 0 && pos + 1 < n_lags) {
          const float ym = nccf[pos - 1], y0 = nccf[pos],
                      yp = nccf[pos + 1];
          const float denom = ym - 2.0f * y0 + yp;
          if (std::fabs(denom) > 1e-9f)
            delta = std::clamp(0.5f * (ym - yp) / denom, -0.5f, 0.5f);
        }
        cand_lag[m * K + c] = (float)(pos + kmin) + delta;
        cand_score[m * K + c] = peaks[c].score;
      } else {
        cand_lag[m * K + c] = (float)kmin;
        cand_score[m * K + c] = -2.0f;
      }
    }
  }

  // Viterbi over K voiced states + 1 unvoiced state
  const int S = K + 1;
  std::vector<float> cost(T * S), prev_cost(S), cur_cost(S);
  std::vector<int> back(T * S);
  std::vector<float> loglag(T * K);
  auto local_v = [&](long m, int c) {
    const float sc = cand_score[m * K + c];
    if (sc <= p.cand_thresh) return kBarred;
    const float lag_term =
        1.0f - p.lag_weight * cand_lag[m * K + c] / (float)kmax;
    return 1.0f - sc * lag_term;
  };
  auto local_u = [&](long m) {
    float best = 0.0f;
    for (int c = 0; c < K; ++c)
      best = std::max(best, cand_score[m * K + c]);
    return p.voice_bias + best;
  };
  for (long m = 0; m < T; ++m)
    for (int c = 0; c < K; ++c)
      loglag[m * K + c] = std::log(std::max(cand_lag[m * K + c], 1.0f));

  for (int c = 0; c < K; ++c) prev_cost[c] = local_v(0, c);
  prev_cost[K] = local_u(0);

  for (long m = 1; m < T; ++m) {
    float best_prev_v = std::numeric_limits<float>::max();
    int arg_prev_v = 0;
    for (int c = 0; c < K; ++c)
      if (prev_cost[c] < best_prev_v) { best_prev_v = prev_cost[c]; arg_prev_v = c; }

    for (int c = 0; c < K; ++c) {
      // best voiced predecessor with octave penalty
      float best = std::numeric_limits<float>::max();
      int arg = 0;
      for (int cp = 0; cp < K; ++cp) {
        const float t = prev_cost[cp] +
            p.freq_weight *
                std::fabs(loglag[m * K + c] - loglag[(m - 1) * K + cp]);
        if (t < best) { best = t; arg = cp; }
      }
      const float from_u = prev_cost[K] + p.trans_cost;
      if (best <= from_u) {
        cur_cost[c] = local_v(m, c) + best;
        back[m * S + c] = arg;
      } else {
        cur_cost[c] = local_v(m, c) + from_u;
        back[m * S + c] = K;
      }
    }
    const float to_u_from_v = best_prev_v + p.trans_cost;
    if (to_u_from_v <= prev_cost[K]) {
      cur_cost[K] = local_u(m) + to_u_from_v;
      back[m * S + K] = arg_prev_v;
    } else {
      cur_cost[K] = local_u(m) + prev_cost[K];
      back[m * S + K] = K;
    }
    std::copy(cur_cost.begin(), cur_cost.end(), prev_cost.begin());
  }

  // backtrace
  int state = 0;
  float best_final = prev_cost[0];
  for (int sidx = 1; sidx < S; ++sidx)
    if (prev_cost[sidx] < best_final) { best_final = prev_cost[sidx]; state = sidx; }

  std::vector<int> states(T);
  for (long m = T - 1; m >= 0; --m) {
    states[m] = state;
    if (m > 0) state = back[m * S + state];
  }

  const long valid_frames =
      std::min(T, (n + (long)hop - 1) / hop + 1);
  for (long m = 0; m < T; ++m) {
    const int st = states[m];
    const bool in_signal = m * (long)hop < n;
    if (st < K && cand_score[m * K + st] > p.cand_thresh && in_signal) {
      const float f0 = (float)fs / std::max(cand_lag[m * K + st], 1.0f);
      out[m] = std::log(f0);
    } else {
      out[m] = kUnvoiced;
    }
  }
  (void)valid_frames;
  return 0;
}

}  // extern "C"
