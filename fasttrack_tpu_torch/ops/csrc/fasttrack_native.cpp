// Native host kernels of fasttrack_tpu_torch: the port's own copy of the
// JAX package's native/fasttrack_native.cpp, with the same functions and
// the same arithmetic, so that the host sides of both packages agree bit
// for bit.
//
// These are the CPU sides of the per-stage offload toggles (the reference's
// CPU fallbacks selected by KernelController) plus host-side algorithms the
// reference also keeps on CPU:
//  - hamming_matrix_u8: packed-descriptor popcount matcher
//    (ORBmatcher::DescriptorDistance, ORBmatcher.cc:2256)
//  - fast_score_f32: FAST-9 segment-test corner score (ORBextractor CPU path)
//  - distribute_octree: quadtree keypoint balancing
//    (ORBextractor::DistributeOctTree, ORBextractor.cc:1112)
//
// Built by fasttrack_tpu_torch/native.py with g++ at first use into
// fasttrack_tpu_torch/_build/ and loaded with ctypes.

#include <cstdint>
#include <cstring>
#include <algorithm>
#include <deque>
#include <vector>

extern "C" {

// ---------------------------------------------------------------- hamming
void hamming_matrix_u8(const uint8_t* a, int n, const uint8_t* b, int m,
                       int32_t* out) {
  for (int i = 0; i < n; ++i) {
    const uint64_t* pa = reinterpret_cast<const uint64_t*>(a + i * 32);
    for (int j = 0; j < m; ++j) {
      const uint64_t* pb = reinterpret_cast<const uint64_t*>(b + j * 32);
      int32_t d = 0;
      for (int k = 0; k < 4; ++k) d += __builtin_popcountll(pa[k] ^ pb[k]);
      out[i * m + j] = d;
    }
  }
}

// ------------------------------------------------------------- FAST score
static const int kCircleDx[16] = {3, 3, 2, 1, 0, -1, -2, -3,
                                  -3, -3, -2, -1, 0, 1, 2, 3};
static const int kCircleDy[16] = {0, 1, 2, 3, 3, 3, 2, 1,
                                  0, -1, -2, -3, -3, -3, -2, -1};

// score = max over 16 arc starts of min over 9 consecutive circle diffs
// (bright and dark cases); <=0 for non-corners. Matches ops/fast.py.
void fast_score_f32(const float* img, int h, int w, float* score) {
  std::memset(score, 0, sizeof(float) * h * w);
  for (int y = 3; y < h - 3; ++y) {
    for (int x = 3; x < w - 3; ++x) {
      const float c = img[y * w + x];
      float d[16];
      for (int k = 0; k < 16; ++k)
        d[k] = img[(y + kCircleDy[k]) * w + (x + kCircleDx[k])] - c;
      float best_bright = -1e30f, best_dark = -1e30f;
      for (int s = 0; s < 16; ++s) {
        float mn_b = 1e30f, mn_d = 1e30f;
        for (int k = 0; k < 9; ++k) {
          const float v = d[(s + k) & 15];
          mn_b = std::min(mn_b, v);
          mn_d = std::min(mn_d, -v);
        }
        best_bright = std::max(best_bright, mn_b);
        best_dark = std::max(best_dark, mn_d);
      }
      score[y * w + x] = std::max(best_bright, best_dark);
    }
  }
}

// --------------------------------------------------------------- octree
namespace {
struct Node {
  int min_x, max_x, min_y, max_y;
  std::vector<int> idx;
  bool no_more = false;
};
}  // namespace

// Quadtree distribution over [min_x,max_x)x[min_y,max_y): split the node
// with the most points until >= n_target nodes (or none divisible), then
// keep the best-scored keypoint of each node.
int distribute_octree(const float* x, const float* y, const float* score,
                      int n, int min_x, int max_x, int min_y, int max_y,
                      int n_target, int* out_idx) {
  if (n <= 0 || n_target <= 0) return 0;
  std::deque<Node> nodes;
  Node root;
  root.min_x = min_x; root.max_x = max_x;
  root.min_y = min_y; root.max_y = max_y;
  root.idx.reserve(n);
  for (int i = 0; i < n; ++i) root.idx.push_back(i);
  root.no_more = (n == 1);
  nodes.push_back(std::move(root));

  bool finished = false;
  while (!finished) {
    // pick the expandable node with the most points
    int best = -1;
    size_t best_count = 1;
    for (size_t i = 0; i < nodes.size(); ++i) {
      if (!nodes[i].no_more && nodes[i].idx.size() > best_count) {
        best_count = nodes[i].idx.size();
        best = static_cast<int>(i);
      }
    }
    if (best < 0 || static_cast<int>(nodes.size()) >= n_target) break;

    Node parent = std::move(nodes[best]);
    nodes.erase(nodes.begin() + best);
    const int cx = (parent.min_x + parent.max_x) / 2;
    const int cy = (parent.min_y + parent.max_y) / 2;
    Node child[4];
    child[0] = {parent.min_x, cx, parent.min_y, cy, {}, false};
    child[1] = {cx, parent.max_x, parent.min_y, cy, {}, false};
    child[2] = {parent.min_x, cx, cy, parent.max_y, {}, false};
    child[3] = {cx, parent.max_x, cy, parent.max_y, {}, false};
    for (int i : parent.idx) {
      const int q = (x[i] >= cx ? 1 : 0) + (y[i] >= cy ? 2 : 0);
      child[q].idx.push_back(i);
    }
    for (auto& c : child) {
      if (c.idx.empty()) continue;
      c.no_more = (c.idx.size() == 1) ||
                  (c.max_x - c.min_x <= 1 && c.max_y - c.min_y <= 1);
      nodes.push_back(std::move(c));
    }
    if (nodes.empty()) finished = true;
  }

  int count = 0;
  for (auto& nd : nodes) {
    if (nd.idx.empty() || count >= n_target) continue;
    int best_i = nd.idx[0];
    for (int i : nd.idx)
      if (score[i] > score[best_i]) best_i = i;
    out_idx[count++] = best_i;
  }
  return count;
}

}  // extern "C"
