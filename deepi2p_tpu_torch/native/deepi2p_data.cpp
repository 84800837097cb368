// Native data-pipeline core for DeepI2P-TPU.
//
// The reference implements its hot loops natively: the CUDA index_max /
// ball_query extensions (models/index_max_ext/, models/ball_query_ext/) and
// the Ceres frustum solver (evaluation/frustum_reg/).  On TPU those live in
// XLA; what remains hot on the HOST is the data pipeline — farthest point
// sampling (an O(kN) numpy loop in the reference, data/kitti_helper.py:
// 224-243), voxel-grid downsampling (Open3D there), and the per-sample
// random resampling.  This library provides multithreaded C implementations
// exposed through a plain C ABI for ctypes.
//
// Build: make -C native   (produces libdeepi2p_data.so)

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <functional>
#include <random>
#include <thread>
#include <unordered_map>
#include <vector>

namespace {

inline float sq(float v) { return v * v; }

void parallel_for(int64_t n, int n_threads,
                  const std::function<void(int64_t, int64_t)>& fn) {
  if (n_threads <= 1 || n < 4096) {
    fn(0, n);
    return;
  }
  std::vector<std::thread> threads;
  int64_t chunk = (n + n_threads - 1) / n_threads;
  for (int t = 0; t < n_threads; ++t) {
    int64_t lo = t * chunk;
    int64_t hi = std::min(n, lo + chunk);
    if (lo >= hi) break;
    threads.emplace_back(fn, lo, hi);
  }
  for (auto& th : threads) th.join();
}

}  // namespace

extern "C" {

// Farthest point sampling over pts (n x 3, row-major).  Writes k selected
// indices to out_idx.  seed selects the random first point.
void fps(const float* pts, int64_t n, int64_t k, uint64_t seed,
         int n_threads, int64_t* out_idx) {
  std::mt19937_64 rng(seed);
  std::vector<float> dist(n);
  int64_t cur = static_cast<int64_t>(rng() % static_cast<uint64_t>(n));
  out_idx[0] = cur;
  const float* p0 = pts + cur * 3;
  for (int64_t i = 0; i < n; ++i) {
    const float* p = pts + i * 3;
    dist[i] = sq(p[0] - p0[0]) + sq(p[1] - p0[1]) + sq(p[2] - p0[2]);
  }
  for (int64_t j = 1; j < k; ++j) {
    // argmax of dist (threaded partial maxima)
    std::vector<std::pair<float, int64_t>> partial(
        std::max(1, n_threads), {-1.0f, 0});
    if (n_threads <= 1 || n < 4096) {
      float best = -1.0f;
      int64_t bi = 0;
      for (int64_t i = 0; i < n; ++i)
        if (dist[i] > best) { best = dist[i]; bi = i; }
      partial[0] = {best, bi};
    } else {
      std::vector<std::thread> threads;
      int64_t chunk = (n + n_threads - 1) / n_threads;
      for (int t = 0; t < n_threads; ++t) {
        int64_t lo = t * chunk, hi = std::min(n, lo + chunk);
        if (lo >= hi) break;
        threads.emplace_back([&, t, lo, hi]() {
          float best = -1.0f;
          int64_t bi = lo;
          for (int64_t i = lo; i < hi; ++i)
            if (dist[i] > best) { best = dist[i]; bi = i; }
          partial[t] = {best, bi};
        });
      }
      for (auto& th : threads) th.join();
    }
    float best = -1.0f;
    int64_t bi = 0;
    for (auto& pr : partial)
      if (pr.first > best) { best = pr.first; bi = pr.second; }
    out_idx[j] = bi;
    const float* pj = pts + bi * 3;
    parallel_for(n, n_threads, [&](int64_t lo, int64_t hi) {
      for (int64_t i = lo; i < hi; ++i) {
        float d = sq(pts[i * 3] - pj[0]) + sq(pts[i * 3 + 1] - pj[1]) +
                  sq(pts[i * 3 + 2] - pj[2]);
        if (d < dist[i]) dist[i] = d;
      }
    });
  }
}

// Voxel-grid average downsampling.  pts (n x 3), extras (n x e) averaged
// alongside.  Writes up to n output rows; returns the number written.
int64_t voxel_downsample(const float* pts, const float* extras, int64_t n,
                         int64_t e, float voxel, float* out_pts,
                         float* out_extras) {
  float minv[3] = {INFINITY, INFINITY, INFINITY};
  for (int64_t i = 0; i < n; ++i)
    for (int d = 0; d < 3; ++d)
      minv[d] = std::min(minv[d], pts[i * 3 + d]);

  struct Acc {
    double p[3] = {0, 0, 0};
    std::vector<double> ex;
    int64_t count = 0;
  };
  std::unordered_map<uint64_t, Acc> cells;
  cells.reserve(static_cast<size_t>(n / 4));
  for (int64_t i = 0; i < n; ++i) {
    uint64_t kx = static_cast<uint64_t>(
        std::floor((pts[i * 3 + 0] - minv[0]) / voxel));
    uint64_t ky = static_cast<uint64_t>(
        std::floor((pts[i * 3 + 1] - minv[1]) / voxel));
    uint64_t kz = static_cast<uint64_t>(
        std::floor((pts[i * 3 + 2] - minv[2]) / voxel));
    uint64_t key = (kx * 73856093ull) ^ (ky * 19349663ull) ^
                   (kz * 83492791ull) ^ (kx << 40) ^ (ky << 20) ^ kz;
    Acc& a = cells[key];
    if (a.ex.empty() && e > 0) a.ex.assign(static_cast<size_t>(e), 0.0);
    for (int d = 0; d < 3; ++d) a.p[d] += pts[i * 3 + d];
    for (int64_t d = 0; d < e; ++d) a.ex[static_cast<size_t>(d)] += extras[i * e + d];
    a.count++;
  }
  int64_t out = 0;
  for (auto& kv : cells) {
    const Acc& a = kv.second;
    for (int d = 0; d < 3; ++d)
      out_pts[out * 3 + d] = static_cast<float>(a.p[d] / a.count);
    for (int64_t d = 0; d < e; ++d)
      out_extras[out * e + d] =
          static_cast<float>(a.ex[static_cast<size_t>(d)] / a.count);
    out++;
  }
  return out;
}

// Brute-force k-nearest-neighbour indices: for each of nq query points the
// k nearest of nd database points (both row-major x3).  Threaded over
// queries.  Used for host-side surface-normal estimation in offline prep.
void knn(const float* query, int64_t nq, const float* database, int64_t nd,
         int64_t k, int n_threads, int64_t* out_idx) {
  parallel_for(nq, n_threads, [&](int64_t lo, int64_t hi) {
    std::vector<std::pair<float, int64_t>> heap;
    for (int64_t q = lo; q < hi; ++q) {
      const float* pq = query + q * 3;
      heap.clear();
      heap.reserve(static_cast<size_t>(k) + 1);
      for (int64_t i = 0; i < nd; ++i) {
        const float* p = database + i * 3;
        float d = sq(p[0] - pq[0]) + sq(p[1] - pq[1]) + sq(p[2] - pq[2]);
        if (heap.size() < static_cast<size_t>(k)) {
          heap.emplace_back(d, i);
          std::push_heap(heap.begin(), heap.end());
        } else if (d < heap.front().first) {
          std::pop_heap(heap.begin(), heap.end());
          heap.back() = {d, i};
          std::push_heap(heap.begin(), heap.end());
        }
      }
      std::sort_heap(heap.begin(), heap.end());
      for (int64_t j = 0; j < k; ++j)
        out_idx[q * k + j] = heap[static_cast<size_t>(j)].second;
    }
  });
}

}  // extern "C"
