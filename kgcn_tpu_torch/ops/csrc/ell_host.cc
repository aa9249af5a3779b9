// Host code of the ELL backends (kgcn_tpu_torch/data/batcher.py), plain C++,
// no CUDA: the host C++ compiler builds it into its own library
// (ops/_build.py), which the Batcher loads on any machine.
//
// kgcn_ell_pack lays one batch's ELL pack (GraphBatch.ell_pack) from the
// per-graph arrays that Batcher._prepare_ell builds once per dataset: the
// senders [C, B*N, K] offset to the batch's node numbering (padding slots
// stay at node 0), the weights' bits [C, B*N, K], then the transpose that
// the GPU's dx kernel walks (ops/ell.ell_transpose for the batch: offsets
// [C, B*N + 1] into the slot list, and each channel's real slots v*K + k
// grouped by sender).  A sender's slots all lie in its own graph, so each
// channel's list is its graphs' lists in batch order, each offset by its
// graph's first slot.  One call instead of some twenty NumPy operations on
// small arrays, each of which costs the host a few microseconds: the host
// assembles a batch per training step, on a path whose steps wait on the
// host.
#include <cstring>

extern "C" {

// idx/w: [G_ds, C, N, K] per-graph senders (int32) and weights (float32);
// t_slots [G_ds, C, N*K] each graph's real slots grouped by sender (the
// first t_count of each row), t_end [G_ds, C, N] each sender's list end
// counted from its graph's list start, t_count [G_ds, C]; graphs [G] the
// batch's dataset indices, B >= G the batch size (graphs G .. B - 1 are
// padding: no slot).  pack: 2*C*B*N*K + C*(B*N + 1) + (sum of the batch's
// t_count) int32.  Returns the slots written.
long long kgcn_ell_pack(const int* idx, const float* w, const int* t_slots,
                        const int* t_end, const int* t_count, const long long* graphs,
                        int G, int B, int C, int N, int K, int* pack) {
  const long long V = (long long)B * N, n = (long long)C * V * K, NK = (long long)N * K;
  int* senders = pack;
  float* weights = reinterpret_cast<float*>(pack + n);
  int* offsets = pack + 2 * n;
  int* slots = offsets + C * (V + 1);
  long long pos = 0;
  for (int c = 0; c < C; ++c) {
    int* off = offsets + c * (V + 1);
    off[0] = (int)pos;
    for (int b = 0; b < B; ++b) {
      const long long row0 = (long long)b * N;
      int* si = senders + (c * V + row0) * K;
      float* wi = weights + (c * V + row0) * K;
      if (b >= G) {  // a padding graph: no edge, no slot
        std::memset(si, 0, sizeof(int) * NK);
        std::memset(wi, 0, sizeof(float) * NK);
        for (int u = 0; u < N; ++u) off[row0 + u + 1] = (int)pos;
        continue;
      }
      const long long gc = graphs[b] * C + c;
      const int* gi = idx + gc * NK;
      const float* gw = w + gc * NK;
      for (long long j = 0; j < NK; ++j) {
        si[j] = gi[j] + (gw[j] != 0.f ? (int)row0 : 0);  // padding stays at node 0
        wi[j] = gw[j];
      }
      const int* end = t_end + gc * N;
      for (int u = 0; u < N; ++u) off[row0 + u + 1] = (int)(pos + end[u]);
      const int* ts = t_slots + gc * NK;
      const int cnt = t_count[gc];
      const int first = (int)(row0 * K);
      for (int j = 0; j < cnt; ++j) slots[pos + j] = ts[j] + first;
      pos += cnt;
    }
  }
  return pos;
}

}  // extern "C"
