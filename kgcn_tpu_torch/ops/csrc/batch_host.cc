// Host batch packer of the streaming Batcher (kgcn_tpu_torch/data/batcher.py),
// plain C++, no CUDA: the host C++ compiler builds it into its own library
// (ops/_build.py), which the Batcher loads on any machine.  The port's copy
// of kgcn_tpu/native/batcher.cpp (pack_edges, gather_pad_features).
//
// One call packs a whole batch's COO edge lists into the padded [C, E]
// layout of GraphBatch, and one more gathers and pads its node features:
// the per-graph Python and NumPy work of batch_graphs, which the host does
// once per training step on a path whose steps wait on the host.  The
// edges are packed per channel, in parallel over the channels.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

extern "C" {

// Pack per-graph COO edges into the padded [C, E] batch layout.
//   rows/cols/vals: the dataset's edges, all (graph, channel) blocks
//     concatenated; block (g, c) of the batch starts at block_off[g*C + c]
//     and holds block_len[g*C + c] edges (the caller gathers both per batch);
//   senders/receivers int32 [C * edge_budget], weights float [C * edge_budget],
//   n_edge int32 [C]: written here, padding slots 0.
// Graph g's node indices are offset by g * max_nodes; receiver = row,
// sender = col (A·X).  Returns 0, -1 if a channel exceeds edge_budget, -2 if
// a node index lies outside [0, max_nodes) (it would bleed into the next
// graph's block).
int kgcn_pack_edges(const int32_t* rows, const int32_t* cols, const float* vals,
                    const int64_t* block_off, const int64_t* block_len,
                    int64_t n_graph, int64_t n_channel, int64_t max_nodes,
                    int64_t edge_budget, int32_t* senders, int32_t* receivers,
                    float* weights, int32_t* n_edge) {
  std::vector<int> rc(n_channel, 0);
  auto pack_channel = [&](int64_t c) {
    int32_t* s = senders + c * edge_budget;
    int32_t* r = receivers + c * edge_budget;
    float* w = weights + c * edge_budget;
    std::memset(s, 0, sizeof(int32_t) * edge_budget);
    std::memset(r, 0, sizeof(int32_t) * edge_budget);
    std::memset(w, 0, sizeof(float) * edge_budget);
    int64_t off = 0;
    for (int64_t g = 0; g < n_graph; ++g) {
      const int64_t b = g * n_channel + c;
      const int64_t len = block_len[b];
      if (off + len > edge_budget) {
        rc[c] = -1;
        return;
      }
      const int32_t* br = rows + block_off[b];
      const int32_t* bc = cols + block_off[b];
      const float* bv = vals + block_off[b];
      const int32_t base = static_cast<int32_t>(g * max_nodes);
      for (int64_t e = 0; e < len; ++e) {
        if (br[e] < 0 || br[e] >= max_nodes || bc[e] < 0 || bc[e] >= max_nodes) {
          rc[c] = -2;
          return;
        }
        r[off + e] = br[e] + base;
        s[off + e] = bc[e] + base;
        w[off + e] = bv[e];
      }
      off += len;
    }
    n_edge[c] = static_cast<int32_t>(off);
  };

  if (n_channel > 1) {
    std::vector<std::thread> threads;
    threads.reserve(n_channel);
    for (int64_t c = 0; c < n_channel; ++c) threads.emplace_back(pack_channel, c);
    for (auto& t : threads) t.join();
  } else if (n_channel == 1) {
    pack_channel(0);
  }
  for (int64_t c = 0; c < n_channel; ++c)
    if (rc[c] != 0) return rc[c];
  return 0;
}

// Gather and pad node features: out[i] = features[idx[i]] for i < n_pick,
// out[n_pick .. batch_graphs - 1] = 0.
//   features float [total_graphs, rows, feat]; idx int64 [n_pick];
//   out float [batch_graphs, rows, feat].
void kgcn_gather_pad_features(const float* features, const int64_t* idx,
                              int64_t n_pick, int64_t batch_graphs, int64_t rows,
                              int64_t feat, float* out) {
  const int64_t stride = rows * feat;
  std::memset(out, 0, sizeof(float) * batch_graphs * stride);
  if (n_pick <= 0) return;
  const unsigned n_threads = std::min<unsigned>(std::thread::hardware_concurrency(),
                                                static_cast<unsigned>(n_pick));
  auto worker = [&](int64_t begin, int64_t end) {
    for (int64_t i = begin; i < end; ++i)
      std::memcpy(out + i * stride, features + idx[i] * stride, sizeof(float) * stride);
  };
  if (n_threads <= 1 || n_pick < 64) {
    worker(0, n_pick);
    return;
  }
  std::vector<std::thread> threads;
  const int64_t chunk = (n_pick + n_threads - 1) / n_threads;
  for (unsigned t = 0; t < n_threads; ++t) {
    const int64_t b = t * chunk;
    const int64_t e = std::min<int64_t>(b + chunk, n_pick);
    if (b >= e) break;
    threads.emplace_back(worker, b, e);
  }
  for (auto& t : threads) t.join();
}

}  // extern "C"
