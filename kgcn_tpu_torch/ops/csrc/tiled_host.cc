// Host code of the tiled sparse backend (kgcn_tpu_torch/ops/tiled_spmm.py),
// plain C++, no CUDA: the host C++ compiler builds it into its own library
// (ops/_build.py), which the wrappers load on any machine.
//
// kgcn_tiled_arrays packs one direction of a TiledCOO (build_tiled): the
// kept edges grouped by (receiver tile, sender tile) pair in input order,
// chunk after chunk, every receiver tile owning at least one chunk, padded
// to a chunk budget -- the arrays kgcn_tpu's NumPy _build_arrays and
// _pad_chunks make, which the tests hold equal, in one pass.
//
// kgcn_tiled_plan builds the SpMM kernel's plan (TiledPlan) of a structure
// when it moves to the card, so the tests on a CPU hold the very plan the
// kernel walks to the plain SpMM and to the JAX package.  One pass over the
// slots: a counting sort of the real slots by receiver row (stable: a row
// keeps slot order), then the cuts, the split rows with their partials and
// the empty rows, in O(slots + receivers).
#include <algorithm>
#include <cstring>
#include <vector>

namespace kgcn_tiled_plan_detail {

// the plan of the last kgcn_tiled_plan call on this thread, laid out as
// TiledPlan.buf, until kgcn_tiled_plan_take copies it out
inline thread_local std::vector<int> plan_buf;

// the arrays of the last kgcn_tiled_arrays call on this thread: slot_src,
// s_loc, r_loc (chunks x chunk each), chunk_rt, chunk_st (chunks each) and
// edge_slot (num_edges), until kgcn_tiled_arrays_take copies them out
inline thread_local std::vector<int> arrays_buf;
inline thread_local long long arrays_slots = 0, arrays_chunks = 0, arrays_edges = 0;

inline long long pad4(long long v) { return (v + 3) / 4 * 4; }

}  // namespace kgcn_tiled_plan_detail

extern "C" {

// One direction of a TiledCOO from its n kept edges (senders s, receivers
// r, original edge ids eid, in input order): n_st = max(ceil(num_senders /
// ts), 1) sender tiles, n_rt likewise; pair key (r / tr) n_st + s / ts; the
// pairs present, and (rt, 0) for each receiver tile without an edge, in key
// order; a pair holds max(ceil(count / chunk), 1) chunks, its edges in
// input order from its first slot; padding slots carry slot_src num_edges
// and s_loc = r_loc = 0.  With budget >= 0 the chunk list is padded to
// budget chunks that repeat the last chunk's (rt, st).  with_edge_slot: also
// each original edge's flat slot (dropped edges: the slot count).  Returns
// the chunk count; -(chunks needed) when the budget is short of it; 0 when
// an edge lies outside the tiles.
long long kgcn_tiled_arrays(const long long* s, const long long* r, const int* eid,
                            long long n, int num_senders, int num_receivers,
                            int num_edges, int ts, int tr, int chunk, long long budget,
                            int with_edge_slot) {
  const long long n_st = std::max(((long long)num_senders + ts - 1) / ts, 1LL);
  const long long n_rt = std::max(((long long)num_receivers + tr - 1) / tr, 1LL);
  std::vector<long long> key(n);
  for (long long i = 0; i < n; ++i) {
    if (s[i] < 0 || s[i] >= (long long)n_st * ts || r[i] < 0 || r[i] >= (long long)n_rt * tr)
      return 0;
    key[i] = r[i] / tr * n_st + s[i] / ts;
  }
  // the pairs present, and a filler pair (rt, 0) for each empty receiver tile
  std::vector<long long> pairs(key);
  std::sort(pairs.begin(), pairs.end());
  pairs.erase(std::unique(pairs.begin(), pairs.end()), pairs.end());
  std::vector<char> has_rt(n_rt, 0);
  for (long long k : pairs) has_rt[k / n_st] = 1;
  for (long long rt = 0; rt < n_rt; ++rt)
    if (!has_rt[rt]) pairs.push_back(rt * n_st);
  std::sort(pairs.begin(), pairs.end());
  const long long n_pairs = (long long)pairs.size();
  std::vector<long long> pair_of(n), count(n_pairs, 0);
  for (long long i = 0; i < n; ++i) {
    pair_of[i] = std::lower_bound(pairs.begin(), pairs.end(), key[i]) - pairs.begin();
    ++count[pair_of[i]];
  }
  std::vector<long long> base(n_pairs + 1, 0);  // first chunk of each pair
  for (long long p = 0; p < n_pairs; ++p)
    base[p + 1] = base[p] + std::max((count[p] + chunk - 1) / chunk, 1LL);
  const long long n_chunks = base[n_pairs];
  if (budget >= 0 && n_chunks > budget) return -n_chunks;
  const long long total = budget >= 0 ? budget : n_chunks;
  const long long slots = total * chunk;

  using namespace kgcn_tiled_plan_detail;
  arrays_slots = slots;
  arrays_chunks = total;
  arrays_edges = with_edge_slot ? num_edges : 0;
  arrays_buf.assign(3 * slots + 2 * total + arrays_edges, 0);
  int* slot_src = arrays_buf.data();
  int* s_loc = slot_src + slots;
  int* r_loc = s_loc + slots;
  int* chunk_rt = r_loc + slots;
  int* chunk_st = chunk_rt + total;
  int* edge_slot = chunk_st + total;
  std::fill(slot_src, slot_src + slots, num_edges);
  for (long long p = 0; p < n_pairs; ++p)
    for (long long c = base[p]; c < base[p + 1]; ++c) {
      chunk_rt[c] = (int)(pairs[p] / n_st);
      chunk_st[c] = (int)(pairs[p] % n_st);
    }
  for (long long c = n_chunks; c < total; ++c) {  // budget fillers
    chunk_rt[c] = chunk_rt[n_chunks - 1];
    chunk_st[c] = chunk_st[n_chunks - 1];
  }
  std::fill(edge_slot, edge_slot + arrays_edges, (int)slots);
  std::vector<long long> rank(n_pairs, 0);
  for (long long i = 0; i < n; ++i) {
    const long long p = pair_of[i];
    const long long slot = base[p] * chunk + rank[p]++;
    slot_src[slot] = eid[i];
    s_loc[slot] = (int)(s[i] % ts);
    r_loc[slot] = (int)(r[i] % tr);
    if (with_edge_slot) edge_slot[eid[i]] = (int)slot;
  }
  return total;
}

// Copies the arrays of the last kgcn_tiled_arrays call on this thread:
// slots [3][chunks * chunk] (slot_src, s_loc, r_loc), chunks [2][chunks]
// (chunk_rt, chunk_st), and edge_slot [num_edges] when it was asked for.
void kgcn_tiled_arrays_take(int* slots, int* chunks, int* edge_slot) {
  using namespace kgcn_tiled_plan_detail;
  const int* b = arrays_buf.data();
  std::memcpy(slots, b, 3 * arrays_slots * sizeof(int));
  std::memcpy(chunks, b + 3 * arrays_slots, 2 * arrays_chunks * sizeof(int));
  if (edge_slot)
    std::memcpy(edge_slot, b + 3 * arrays_slots + 2 * arrays_chunks, arrays_edges * sizeof(int));
}

// Builds one direction's TiledPlan from the structure's host arrays
// (slot_src, s_loc, r_loc [n_chunks * chunk], chunk_rt, chunk_st
// [n_chunks]): pieces of about `piece` real slots, piece =
// min(512, 32 max(1, ceil(n_real / (32 target_pieces)))); below `small`
// real slots a piece per row, a row longer than `piece` cut at the
// multiples of `piece` in it; beyond, a cut at each multiple of `piece`,
// moved back to its row's start unless the row is longer than `piece` or
// starts more than max(8, piece / 4) back.  Fills counts (piece, n_real,
// n_pieces, n_split, n_empty, n_parts) and offsets (of entries, starts,
// pieces, splits, empty_rows and arrivals, in ints, each a multiple of 4)
// and returns the plan's size in ints, for kgcn_tiled_plan_take; -1 where
// a real slot's receiver lies outside [0, num_receivers).
long long kgcn_tiled_plan(const int* slot_src, const int* s_loc, const int* r_loc,
                          const int* chunk_rt, const int* chunk_st, int n_chunks,
                          int chunk, int ts, int tr, int num_receivers, int num_edges,
                          int target_pieces, int small, int pieces_per_block,
                          long long* counts, long long* offsets) {
  std::vector<long long> row_start(num_receivers + 1, 0);
  for (long long c = 0; c < n_chunks; ++c) {
    const long long base = (long long)chunk_rt[c] * tr, i0 = c * chunk;
    for (long long i = i0; i < i0 + chunk; ++i) {
      if (slot_src[i] < 0 || slot_src[i] >= num_edges) continue;  // padding
      const long long row = base + r_loc[i];
      if (row < 0 || row >= num_receivers) return -1;
      ++row_start[row + 1];
    }
  }
  for (int r = 0; r < num_receivers; ++r) row_start[r + 1] += row_start[r];
  const long long n = row_start[num_receivers];
  const long long per = 32LL * target_pieces;
  const long long P = std::min(512LL, 32 * std::max(1LL, (n + per - 1) / per));
  const long long window = std::max(8LL, P / 4);

  // the real slots by receiver row, stable in slot order
  std::vector<int> idx(n), rows(n), send(n);
  std::vector<long long> fill(row_start.begin(), row_start.end() - 1);
  for (long long c = 0; c < n_chunks; ++c) {
    const long long base = (long long)chunk_rt[c] * tr, i0 = c * chunk;
    const int sbase = chunk_st[c] * ts;
    for (long long i = i0; i < i0 + chunk; ++i) {
      if (slot_src[i] < 0 || slot_src[i] >= num_edges) continue;
      const long long row = base + r_loc[i];
      const long long at = fill[row]++;
      idx[at] = slot_src[i];
      rows[at] = (int)row;
      send[at] = sbase + s_loc[i];
    }
  }

  std::vector<long long> starts;
  if (n < small) {
    for (int r = 0; r < num_receivers; ++r) {
      const long long s0 = row_start[r], s1 = row_start[r + 1];
      if (s1 == s0) continue;
      starts.push_back(s0);
      if (s1 - s0 > P)
        for (long long t = (s0 / P + 1) * P; t < s1; t += P) starts.push_back(t);
    }
  } else {
    starts.push_back(0);
    for (long long t = P; t < n; t += P) {
      const int r = rows[t];
      const long long s0 = row_start[r];
      const bool inside = row_start[r + 1] - s0 > P || t - s0 > window;
      starts.push_back(inside ? t : s0);
    }
  }
  const long long n_pieces = (long long)starts.size();

  // a row is split where a piece ends in it and the next starts in it; its
  // partials are numbered in (piece, first row / last row) order
  std::vector<int> pieces(4 * n_pieces, -1);
  std::vector<int> splits;  // row, first partial, partials, blocks
  long long n_parts = 0, first_piece = 0;
  for (long long p = 0; p < n_pieces; ++p) {
    const long long e0 = starts[p], e1 = p + 1 < n_pieces ? starts[p + 1] : n;
    const int first = rows[e0], last = rows[e1 - 1];
    const bool next_in_last = e1 < n && rows[e1] == last;
    const bool first_split = (e0 > 0 && rows[e0 - 1] == first) || (next_in_last && first == last);
    const bool last_split = last != first && next_in_last;
    for (int which = 0; which < 2; ++which) {
      if (!(which ? last_split : first_split)) continue;
      const int row = which ? last : first;
      const long long k = (long long)splits.size() / 4 - 1;
      if (k < 0 || splits[4 * k] != row) {  // a new split row
        splits.insert(splits.end(), {row, (int)n_parts, 0, 0});
        first_piece = p;
      }
      const long long kk = (long long)splits.size() / 4 - 1;
      splits[4 * kk + 2] += 1;
      splits[4 * kk + 3] = (int)(p / pieces_per_block - first_piece / pieces_per_block + 1);
      pieces[4 * p + 2 * which] = (int)kk;
      pieces[4 * p + 2 * which + 1] = (int)n_parts++;
    }
  }
  const long long n_split = (long long)splits.size() / 4;
  std::vector<int> empty;
  empty.reserve(num_receivers - n_pieces > 0 ? num_receivers - n_pieces : 0);
  for (int r = 0; r < num_receivers; ++r)
    if (row_start[r + 1] == row_start[r]) empty.push_back(r);

  const long long sizes[6] = {3 * n, n_pieces + 1, 4 * n_pieces, 4 * n_split,
                              (long long)empty.size(), n_split};
  long long total = 0;
  for (int a = 0; a < 6; ++a) {
    offsets[a] = total;
    total += kgcn_tiled_plan_detail::pad4(sizes[a]);
  }
  kgcn_tiled_plan_detail::plan_buf.assign(total, 0);  // arrivals and padding 0
  int* buf = kgcn_tiled_plan_detail::plan_buf.data();
  std::memcpy(buf, idx.data(), n * sizeof(int));
  std::memcpy(buf + n, rows.data(), n * sizeof(int));
  std::memcpy(buf + 2 * n, send.data(), n * sizeof(int));
  for (long long p = 0; p < n_pieces; ++p) buf[offsets[1] + p] = (int)starts[p];
  buf[offsets[1] + n_pieces] = (int)n;
  std::memcpy(buf + offsets[2], pieces.data(), pieces.size() * sizeof(int));
  std::memcpy(buf + offsets[3], splits.data(), splits.size() * sizeof(int));
  std::memcpy(buf + offsets[4], empty.data(), empty.size() * sizeof(int));
  const long long c[6] = {P, n, n_pieces, n_split, (long long)empty.size(), n_parts};
  for (int a = 0; a < 6; ++a) counts[a] = c[a];
  return total;
}

// Copies the plan that the last kgcn_tiled_plan call on this thread built
// into out (its returned size in ints).
void kgcn_tiled_plan_take(int* out) {
  std::memcpy(out, kgcn_tiled_plan_detail::plan_buf.data(), kgcn_tiled_plan_detail::plan_buf.size() * sizeof(int));
}

}  // extern "C"
