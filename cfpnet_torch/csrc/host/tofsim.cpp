// Host kernel of the ToF zone-histogram simulation (a copy of the JAX
// package's native/tofsim.cpp, built and bound by cfpnet_torch/data/native.py).
//
// The reference's data-loader hot loop (per-zone torch.histc + np.split
// cluster search, reference src/utils/dataloader.py:106-118) needs 12
// worker processes to keep 4 GPUs fed. This single-pass C++ kernel computes
// zone histograms, noise-floor subtraction, strongest-contiguous-cluster
// selection (first-max ties) and moment fitting for all zones of a frame in
// one call; exposed to Python via ctypes (cfpnet_torch/data/native.py) with
// a vectorized-numpy twin (cfpnet_torch/data/tof_sim.py) that agrees with it
// to float rounding.
//
// Built at first use: g++ -O3 -march=native -shared -fPIC.

#include <cstdint>
#include <cstring>
#include <vector>

extern "C" {

// depth:    [H, W] float32 metric depth
// fh_out:   [zn*zn, 2] float32 (mu, sigma)
// mask_out: [zn*zn] uint8 (zone has signal)
// Returns 0 on success.
int tof_get_hist(const float* depth, int H, int W,
                 int sy, int sx, int zn, int ph, int pw,
                 float max_distance, float bin_width, float noise_floor,
                 float* fh_out, uint8_t* mask_out) {
  const int bins = static_cast<int>(max_distance / bin_width);
  if (bins <= 0 || zn <= 0) return 1;
  std::vector<float> hist(bins);

  for (int zi = 0; zi < zn; ++zi) {
    for (int zj = 0; zj < zn; ++zj) {
      const int z = zi * zn + zj;
      std::memset(hist.data(), 0, bins * sizeof(float));
      const int y0 = sy + zi * ph, x0 = sx + zj * pw;
      // histogram (torch.histc semantics: [0, max] kept, v==max -> last bin)
      for (int y = y0; y < y0 + ph; ++y) {
        if (y < 0 || y >= H) continue;
        const float* row = depth + static_cast<int64_t>(y) * W;
        for (int x = x0; x < x0 + pw; ++x) {
          if (x < 0 || x >= W) continue;
          const float v = row[x];
          if (v < 0.f || v > max_distance) continue;
          int b = static_cast<int>(v / bin_width);
          if (b >= bins) b = bins - 1;
          hist[b] += 1.f;
        }
      }
      // zero bin 0; subtract noise floor; clip at 0
      hist[0] = 0.f;
      for (int b = 0; b < bins; ++b) {
        hist[b] = hist[b] > noise_floor ? hist[b] - noise_floor : 0.f;
      }
      // strongest contiguous non-zero cluster (first max wins)
      float best_sum = -1.f;
      int best_lo = -1, best_hi = -1;
      int lo = -1;
      float run_sum = 0.f;
      for (int b = 0; b <= bins; ++b) {
        const bool nz = (b < bins) && hist[b] > 0.f;
        if (nz) {
          if (lo < 0) { lo = b; run_sum = 0.f; }
          run_sum += hist[b];
        } else if (lo >= 0) {
          if (run_sum > best_sum) { best_sum = run_sum; best_lo = lo; best_hi = b; }
          lo = -1;
        }
      }
      double n = 0.0, m1 = 0.0;
      if (best_lo >= 0) {
        for (int b = 0; b < best_lo; ++b) hist[b] = 0.f;
        for (int b = best_hi; b < bins; ++b) hist[b] = 0.f;
        for (int b = best_lo; b < best_hi; ++b) {
          const double c = (b + 0.5) * bin_width;
          n += hist[b];
          m1 += c * hist[b];
        }
      }
      const double mu = m1 / (n + 1e-9);
      double m2 = 0.0;
      if (best_lo >= 0) {
        for (int b = best_lo; b < best_hi; ++b) {
          const double c = (b + 0.5) * bin_width;
          m2 += hist[b] * (c - mu) * (c - mu);
        }
      }
      const double sigma = __builtin_sqrt(m2 / (n + 1e-9)) + 1e-9;
      fh_out[2 * z] = static_cast<float>(mu);
      fh_out[2 * z + 1] = static_cast<float>(sigma);
      mask_out[z] = n > 0.0 ? 1 : 0;
    }
  }
  return 0;
}

// Batched uniform point sampling: mu±3sigma linspace per valid zone.
// fh: [Z,2], mask: [Z], out: [Z, nsamples]
void tof_sample_uniform(const float* fh, const uint8_t* mask, int Z,
                        int nsamples, float* out) {
  for (int z = 0; z < Z; ++z) {
    float* row = out + static_cast<int64_t>(z) * nsamples;
    if (!mask[z]) {
      std::memset(row, 0, nsamples * sizeof(float));
      continue;
    }
    const float mu = fh[2 * z], sg = fh[2 * z + 1];
    const float start = mu - 3.f * sg, end = mu + 3.f * sg;
    for (int i = 0; i < nsamples; ++i) {
      const float t = nsamples > 1 ? static_cast<float>(i) / (nsamples - 1) : 0.f;
      row[i] = start * (1.f - t) + end * t;
    }
  }
}

}  // extern "C"
