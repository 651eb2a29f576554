// Host-side superpixel segmentation: SLIC + Felzenszwalb-Huttenlocher.
//
// The port's copy of the JAX package's native/superpixels.cc, the same code:
// the replacement for the reference's third-party CPU segmenters
// (scikit-image `slic` / `felzenszwalb` and the fast-slic import,
// reference code/data/superpixels.py:5-20). Exposed via ctypes
// (videowalk_tpu_torch/data/superpixels.py); the SLIC kernel on the card
// (videowalk_tpu_torch/ops/slic.py) is the training fast path, this C++
// path serves `--sp-backend host` and the FH method (sequential
// union-find).
//
// Build (videowalk_tpu_torch/native/__init__.py, at first use):
//   g++ -O3 -shared -fPIC -std=c++17 superpixels.cc -o _build/lib...so

#include <cmath>
#include <cstdint>
#include <cstring>
#include <algorithm>
#include <vector>
#include <numeric>

extern "C" {

// ---------------------------------------------------------------- SLIC
//
// Center-centric SLIC (Achanta et al. 2012), matching skimage semantics:
// grid-initialized centers, distance d^2 = dLAB^2 + (dxy * compactness/S)^2,
// 2S search window, `n_iter` iterations, optional connectivity enforcement
// (small disconnected components merged into an adjacent segment).
void slic_segment(const float* lab,  // H*W*3 CIELAB
                  int H, int W, int K, float compactness, int n_iter,
                  int enforce_connectivity, int32_t* labels_out) {
  const int N = H * W;
  const float S = std::sqrt((float)N / K);
  const float ratio2 = (compactness / S) * (compactness / S);

  // grid init (same layout as the device implementation)
  int gh = (int)(std::sqrt((float)K * H / W) + 0.5f);
  if (gh < 1) gh = 1;
  int gw = (K + gh - 1) / gh;
  std::vector<float> cy(K), cx(K), cl(K), ca(K), cb(K);
  for (int k = 0; k < K; ++k) {
    int gy = (k / gw) % gh, gx = k % gw;
    cy[k] = (gy + 0.5f) * H / gh;
    cx[k] = (gx + 0.5f) * W / gw;
    int py = std::min(H - 1, (int)cy[k]), px = std::min(W - 1, (int)cx[k]);
    const float* p = lab + (py * W + px) * 3;
    cl[k] = p[0]; ca[k] = p[1]; cb[k] = p[2];
  }

  std::vector<float> dist(N);
  std::vector<int32_t> label(N, 0);

  for (int it = 0; it < n_iter; ++it) {
    std::fill(dist.begin(), dist.end(), 1e30f);
    for (int k = 0; k < K; ++k) {
      int y0 = std::max(0, (int)(cy[k] - 2 * S)),
          y1 = std::min(H, (int)(cy[k] + 2 * S) + 1);
      int x0 = std::max(0, (int)(cx[k] - 2 * S)),
          x1 = std::min(W, (int)(cx[k] + 2 * S) + 1);
      for (int y = y0; y < y1; ++y) {
        const float dy = y - cy[k];
        for (int x = x0; x < x1; ++x) {
          const int i = y * W + x;
          const float* p = lab + i * 3;
          const float dl = p[0] - cl[k], da = p[1] - ca[k], db = p[2] - cb[k];
          const float dx = x - cx[k];
          const float d = dl * dl + da * da + db * db
                        + (dy * dy + dx * dx) * ratio2;
          if (d < dist[i]) { dist[i] = d; label[i] = k; }
        }
      }
    }
    // update centers
    std::vector<double> sy(K, 0), sx(K, 0), sl(K, 0), sa(K, 0), sb(K, 0);
    std::vector<int> cnt(K, 0);
    for (int y = 0; y < H; ++y)
      for (int x = 0; x < W; ++x) {
        const int i = y * W + x;
        const int k = label[i];
        const float* p = lab + i * 3;
        sy[k] += y; sx[k] += x; sl[k] += p[0]; sa[k] += p[1]; sb[k] += p[2];
        cnt[k]++;
      }
    for (int k = 0; k < K; ++k)
      if (cnt[k] > 0) {
        cy[k] = sy[k] / cnt[k]; cx[k] = sx[k] / cnt[k];
        cl[k] = sl[k] / cnt[k]; ca[k] = sa[k] / cnt[k]; cb[k] = sb[k] / cnt[k];
      }
  }

  if (enforce_connectivity) {
    // Relabel: BFS connected components; merge components smaller than
    // min_size = S*S/4 into the previously-visited adjacent segment
    // (skimage-style post-pass).
    const int min_size = std::max(1, (int)(S * S / 4));
    std::vector<int32_t> out(N, -1);
    std::vector<int> stack;
    int adjacent = 0;
    const int dy4[4] = {-1, 1, 0, 0}, dx4[4] = {0, 0, -1, 1};
    for (int i = 0; i < N; ++i) {
      if (out[i] >= 0) continue;
      const int k = label[i];
      stack.clear();
      stack.push_back(i);
      out[i] = k;
      size_t head = 0;
      std::vector<int> comp{i};
      while (head < stack.size()) {
        const int c = stack[head++];
        const int y = c / W, x = c % W;
        for (int d = 0; d < 4; ++d) {
          const int ny = y + dy4[d], nx = x + dx4[d];
          if (ny < 0 || ny >= H || nx < 0 || nx >= W) continue;
          const int n = ny * W + nx;
          if (out[n] < 0 && label[n] == k) {
            out[n] = k;
            stack.push_back(n);
            comp.push_back(n);
          } else if (out[n] >= 0 && label[n] != k) {
            adjacent = out[n];
          }
        }
      }
      if ((int)comp.size() < min_size) {
        for (int c : comp) out[c] = adjacent;
      }
    }
    std::memcpy(labels_out, out.data(), N * sizeof(int32_t));
  } else {
    std::memcpy(labels_out, label.data(), N * sizeof(int32_t));
  }
}

// ------------------------------------------------- Felzenszwalb-Huttenlocher
//
// Graph-based segmentation (Felzenszwalb & Huttenlocher 2004) with
// euclidean color edge weights on the 8-connected grid (skimage semantics;
// reference uses scale=600, sigma=0.5, min_size=400 at
// code/data/superpixels.py:18-20). Input should be pre-smoothed (the Python
// wrapper applies the gaussian).

struct DSU {
  std::vector<int> parent, rank_, size;
  explicit DSU(int n) : parent(n), rank_(n, 0), size(n, 1) {
    std::iota(parent.begin(), parent.end(), 0);
  }
  int find(int a) {
    while (parent[a] != a) { parent[a] = parent[parent[a]]; a = parent[a]; }
    return a;
  }
  int join(int a, int b) {
    a = find(a); b = find(b);
    if (a == b) return a;
    if (rank_[a] < rank_[b]) std::swap(a, b);
    parent[b] = a;
    size[a] += size[b];
    if (rank_[a] == rank_[b]) rank_[a]++;
    return a;
  }
};

void felzenszwalb_segment(const float* img,  // H*W*3, pre-smoothed
                          int H, int W, float scale, int min_size,
                          int32_t* labels_out) {
  const int N = H * W;
  struct Edge { float w; int a, b; };
  std::vector<Edge> edges;
  edges.reserve(N * 4);
  auto color_dist = [&](int a, int b) {
    const float* pa = img + a * 3;
    const float* pb = img + b * 3;
    const float d0 = pa[0] - pb[0], d1 = pa[1] - pb[1], d2 = pa[2] - pb[2];
    return std::sqrt(d0 * d0 + d1 * d1 + d2 * d2);
  };
  for (int y = 0; y < H; ++y)
    for (int x = 0; x < W; ++x) {
      const int i = y * W + x;
      if (x + 1 < W) edges.push_back({color_dist(i, i + 1), i, i + 1});
      if (y + 1 < H) edges.push_back({color_dist(i, i + W), i, i + W});
      if (x + 1 < W && y + 1 < H)
        edges.push_back({color_dist(i, i + W + 1), i, i + W + 1});
      if (x > 0 && y + 1 < H)
        edges.push_back({color_dist(i, i + W - 1), i, i + W - 1});
    }
  std::sort(edges.begin(), edges.end(),
            [](const Edge& a, const Edge& b) { return a.w < b.w; });

  DSU dsu(N);
  std::vector<float> threshold(N, scale);  // tau(C) = scale / |C|, |C|=1
  for (const Edge& e : edges) {
    const int a = dsu.find(e.a), b = dsu.find(e.b);
    if (a == b) continue;
    if (e.w <= threshold[a] && e.w <= threshold[b]) {
      const int r = dsu.join(a, b);
      threshold[r] = e.w + scale / dsu.size[r];
    }
  }
  // merge small components
  for (const Edge& e : edges) {
    const int a = dsu.find(e.a), b = dsu.find(e.b);
    if (a != b && (dsu.size[a] < min_size || dsu.size[b] < min_size))
      dsu.join(a, b);
  }
  // dense relabel
  std::vector<int32_t> remap(N, -1);
  int next = 0;
  for (int i = 0; i < N; ++i) {
    const int r = dsu.find(i);
    if (remap[r] < 0) remap[r] = next++;
    labels_out[i] = remap[r];
  }
}

}  // extern "C"
