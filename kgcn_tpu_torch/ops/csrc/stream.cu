// Streaming scatter SpMM of the stream backend for Hopper (sm_90a), on the
// StreamCOO edge structure of kgcn_tpu_torch/ops/stream_spmm.py.
//
//   scatter: out[r, :] = sum over the real slots with receiver r of
//            cdt(w) * cdt(x[sender, :]), w the slot's weight (w_slots[slot])
//            or its one-hot entry (oh[slot, r_loc[slot]], bf16)
//   dw:      dw[slot] = <cdt(dy[r_slot, :]), cdt(x[slot_sender[slot], :])>
//
// Replace the Pallas TPU kernels `_scatter_kernel`, `_scatter_kernel_mat` and
// `_dw_kernel` (kgcn_tpu/ops/stream_spmm.py:335, :374 and :448).  The TPU
// kernels scatter through one-hot matmuls over receiver windows because
// Mosaic cannot scatter rows, and take the gathered rows g = x[slot_sender]
// from an XLA gather; here the gather is fused and rows are addressed
// directly.  The one-hot kernel relies on the one-hots' contract (at most
// one non-zero per row, at r_loc: _materialize_oh) and reads that one bf16
// entry per slot, not the tr_w-wide row.
//
// Payload: with bf16 the gathered row and the weight are rounded to bf16,
// their product is exact in f32 and the sum runs in f32 -- the TPU kernels'
// roundings (their one-hot holds bf16(w), their gather bf16(x)).  f32 rounds
// nothing.  The one-hot route is bf16 (the one-hots are bf16).  dw rounds dy
// and x alike.
//
// What bounds them: an edge gathers one F-wide f32 row of x (4F bytes, from
// L2 once x has been read: the KG's 40 960 x 128 f32 rows are 21 MB of the
// 50 MB L2) for 2F FLOP, and the output is written once, so the scatter is
// bound by bytes and by the latency of dependent gathers.  dw is bound the
// same way: per edge one gathered row of x and the receiver's row of dy
// (both 4F bytes) for 2F FLOP, and 4 bytes out; x and dy must each be read
// once, so the least time is their bytes at the HBM rate.
//
// scatter: the host plan (StreamPlan) lists the real slots in slot order --
//   which is receiver order -- as (slot, row, sender), cut into pieces of
//   `piece` slots (32-512, so that a structure has some 2 000 pieces).  A
//   warp walks one piece: every slot's metadata is read once (a lane per
//   slot, the next 32 prefetched), a lane holds 4 of a 128-column group
//   (one 16-byte load or store when F % 4 == 0), 16 gathered rows are in
//   flight, and the running row is summed in registers.  A row that lies in
//   this piece alone is written straight to out when the receiver changes.
//   A hub row's slots thus spread over many warps and SMs: the piece's first
//   and last rows, where other pieces share them, go to partial rows, and
//   the plan names these split rows with their partials (consecutive, in
//   piece order).  Each block of 8 pieces, after its partials, bumps a
//   counter per split row it wrote to; the block that completes a row sums
//   its partials -- one warp in order where there are at most 64 (the
//   warps take such rows in turn), else its 8 warps each a consecutive
//   eighth in order, then the eight in order -- writes the row and resets
//   the counter.  So the order of every sum is fixed by the plan: two
//   launches give the same bits, with no atomics on values.  Rows without a
//   real slot (the plan's empty_rows) are written as zeros by all warps in
//   turn; every row of out is written once, and padding slots and budget
//   fillers are never visited.
// dw: walks the same plan's real entries alone, in slot order, cut into
//   spans: the scatter's pieces, or where a structure has fewer pieces
//   than the grid has resident warps and F > 64, spans of down to 8
//   entries (the host's choice, _dw_span), so that a small structure still
//   fills the card.  A warp walks a span, the next 32 entries' (slot, row,
//   sender) prefetched a lane each, so each slot's receiver row comes with
//   it and no padding slot is read.  A lane holds 4 columns of a pass: 4
//   consecutive ones, one 16-byte load, where F % 4 == 0 and x and dy are
//   16-byte aligned, else 4 strided by the group's width; the lanes split
//   into groups of LPR = 4-32 lanes sized to F (columns past 4 * LPR in
//   passes, so F 133 takes 2).  A group takes LPR consecutive entries of
//   each 32 and keeps up to DW_BATCH of them in flight: their x rows, and
//   dy only where the receiver changes (a streaming load, so that x keeps
//   the L2).  The entries are in receiver order, so a run of one row loads
//   dy once (where F takes all 32 lanes in one pass, as F 128 does, a warp
//   is one group and holds dy across its whole span; a hub row spanning
//   spans is loaded once a span).  DW_BATCH 8 fits a thread in 128
//   registers, so two blocks an SM are resident (the strided layout, ~145
//   registers uncapped, is held to 128).  Each lane sums its columns' products in
//   order from 0, then a fixed butterfly over the group's lanes (strides
//   LPR/2 ... 1) finishes every entry's dot, transposed so that a level's
//   shuffle moves half the values it holds (at LPR 32, 9 shuffles for 8
//   dots, not 40).  No atomics: two launches give the same bits.  An
//   entry's lane writes its dot and the warp writes zeros into the padding
//   slots between it and the entry before (the first span from slot 0);
//   the padding after the last entry (a macro budget's fillers: most of a
//   small channel's slots) is cut evenly over all warps.  So every slot of
//   out is written once in the one launch.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int WARPS = 8;          // pieces per block (stream_spmm.PIECES_PER_BLOCK)
constexpr int THREADS = WARPS * 32;
constexpr int GROUP = 128;        // columns a warp sums at a time: 4 per lane
constexpr int BATCH = 16;         // gathered x rows a warp keeps in flight
constexpr int SPLIT_WARP = 64;    // split rows of at most this many partials: one warp
constexpr int ZERO_ROWS = 64;     // empty rows per warp, sizing the grid
constexpr int DW_WARPS = 8;       // dw blocks: 8 warps, a piece each
constexpr int DW_BATCH = 8;       // entries a dw lane group keeps in flight
constexpr int DW_VEC = 4;         // columns a dw lane holds in a pass
constexpr unsigned FULL = 0xffffffffu;

enum Weight { W_F32 = 0, W_BF16 = 1, W_ONEHOT = 2 };

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// A lane's 4 columns of the 128-column group at c0 of one F-wide row: with
// VEC 4 consecutive columns (one 16-byte access; F % 4 == 0), else columns
// lane + 32 i.  Columns >= F read as 0 and are not written.  L2: read
// through L2 only (__ldcg), for rows other blocks wrote in this launch;
// else through the read-only path (__ldg).
template <bool L2, class T>
__device__ __forceinline__ T ld(const T* p) {
  return L2 ? __ldcg(p) : __ldg(p);
}

template <bool VEC, bool L2 = false>
__device__ __forceinline__ void load4(const float* row, int c0, int F, int lane,
                                      float (&v)[4]) {
  if (VEC) {
    const int c = c0 + 4 * lane;
    float4 t = make_float4(0.f, 0.f, 0.f, 0.f);
    if (c < F) t = ld<L2>(reinterpret_cast<const float4*>(row + c));
    v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int c = c0 + lane + 32 * i;
      v[i] = c < F ? ld<L2>(row + c) : 0.f;
    }
  }
}

template <bool VEC>
__device__ __forceinline__ void store4(float* row, int c0, int F, int lane,
                                       const float (&v)[4]) {
  if (VEC) {
    const int c = c0 + 4 * lane;
    if (c < F) *reinterpret_cast<float4*>(row + c) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int c = c0 + lane + 32 * i;
      if (c < F) row[c] = v[i];
    }
  }
}

// the column of the group that a lane's i-th value belongs to
template <bool VEC>
__device__ __forceinline__ int col4(int lane, int i) {
  return VEC ? 4 * lane + i : lane + 32 * i;
}

// sum = partials [lo, hi) of a lane's columns, added in order from 0 (read
// through L2: other blocks wrote them in this launch)
template <bool VEC>
__device__ __forceinline__ void sum_partials(const float* part, int lo, int hi, int c0,
                                             int F, int lane, float (&sum)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) sum[i] = 0.f;
  for (int q0 = lo; q0 < hi; q0 += BATCH) {
    float v[BATCH][4];
#pragma unroll
    for (int u = 0; u < BATCH; ++u) {
      if (q0 + u < hi) load4<VEC, true>(part + (size_t)(q0 + u) * F, c0, F, lane, v[u]);
    }
#pragma unroll
    for (int u = 0; u < BATCH; ++u) {
      if (q0 + u < hi) {
#pragma unroll
        for (int i = 0; i < 4; ++i) sum[i] += v[u][i];
      }
    }
  }
}

struct Slot {
  int row, send;
  float w;  // rounded as the payload asks
};

template <int WK>
__device__ __forceinline__ Slot slot_meta(const int* __restrict__ ent, int n_real,
                                          int e, int e_end, const void* __restrict__ w,
                                          int tr_w) {
  Slot m{-1, 0, 0.f};
  if (e < e_end) {
    const int slot = __ldg(ent + e);
    m.row = __ldg(ent + n_real + e);
    m.send = __ldg(ent + 2 * n_real + e);
    if (WK == W_ONEHOT) {
      const __nv_bfloat16* oh = static_cast<const __nv_bfloat16*>(w);
      m.w = __bfloat162float(oh[(size_t)slot * tr_w + m.row % tr_w]);
    } else {
      const float v = __ldg(static_cast<const float*>(w) + slot);
      m.w = WK == W_BF16 ? round_bf16(v) : v;
    }
  }
  return m;
}

template <int WK, bool VEC>
__global__ void __launch_bounds__(THREADS)
stream_scatter_kernel(const int* __restrict__ ent, const int4* __restrict__ pieces,
                      const int4* __restrict__ splits,
                      const int* __restrict__ empty_rows, int* __restrict__ arrivals,
                      const void* __restrict__ w, const float* __restrict__ x,
                      float* __restrict__ out, float* __restrict__ part, int n_real,
                      int n_pieces, int n_empty, int piece, int tr_w, int F) {
  __shared__ float red[WARPS][GROUP];  // the warps' sums of a split row
  __shared__ int done[2 * WARPS];      // split rows this block completes
  __shared__ int n_done;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int p = blockIdx.x * WARPS + warp;

  if (p < n_pieces) {
    // (split row, partial) of the piece's first and of its last row
    const int4 info = pieces[p];
    const int e0 = p * piece;
    const int e1 = min(e0 + piece, n_real);
    for (int c0 = 0; c0 < F; c0 += GROUP) {
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
      int cur = -1;        // the row being summed
      bool first = true;   // cur is the piece's first row
      Slot nxt = slot_meta<WK>(ent, n_real, e0 + lane, e1, w, tr_w);
      for (int b = e0; b < e1; b += 32) {
        const Slot me = nxt;
        nxt = slot_meta<WK>(ent, n_real, b + 32 + lane, e1, w, tr_w);
        const int n = min(32, e1 - b);
        for (int j0 = 0; j0 < n; j0 += BATCH) {
          float xv[BATCH][4];
          int rw[BATCH];
          float wv[BATCH];
#pragma unroll
          for (int u = 0; u < BATCH; ++u) {
            const int j = j0 + u;  // the same in every lane
            const int s = __shfl_sync(FULL, me.send, j & 31);
            rw[u] = __shfl_sync(FULL, me.row, j & 31);
            wv[u] = __shfl_sync(FULL, me.w, j & 31);
            if (j < n) {
              load4<VEC>(x + (size_t)s * F, c0, F, lane, xv[u]);
            } else {
              rw[u] = -1;
            }
          }
#pragma unroll
          for (int u = 0; u < BATCH; ++u) {
            if (rw[u] < 0) break;
            if (rw[u] != cur) {
              if (cur >= 0) {
                // a finished row other than the last: the first one goes
                // where the plan says, the others are whole
                const int c = first ? info.y : -1;
                store4<VEC>(c >= 0 ? part + (size_t)c * F : out + (size_t)cur * F,
                            c0, F, lane, acc);
                first = false;
              }
              cur = rw[u];
#pragma unroll
              for (int i = 0; i < 4; ++i) acc[i] = 0.f;
            }
            if (WK == W_ONEHOT && wv[u] == 0.f) continue;  // as oh^T g: non-zeros only
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const float xi = WK == W_F32 ? xv[u][i] : round_bf16(xv[u][i]);
              acc[i] += __fmul_rn(wv[u], xi);
            }
          }
        }
      }
      // the last row (which may be the first)
      const int c = first ? info.y : info.w;
      store4<VEC>(c >= 0 ? part + (size_t)c * F : out + (size_t)cur * F, c0, F, lane,
                  acc);
    }
  }

  // rows without a real slot: zeros, by every warp of the grid in turn
  const int nw = gridDim.x * WARPS;
  for (int i = blockIdx.x * WARPS + warp; i < n_empty; i += nw) {
    float* o = out + (size_t)__ldg(empty_rows + i) * F;
    const float z[4] = {0.f, 0.f, 0.f, 0.f};
    for (int c0 = 0; c0 < F; c0 += GROUP) store4<VEC>(o, c0, F, lane, z);
  }

  // this block's partials are written: count it in for each split row it
  // wrote to, once, and note the rows it is the last to reach
  __threadfence();
  __syncthreads();
  if (warp == 0) {
    int k = -1;
    if (lane < 2 * WARPS) {
      const int q = blockIdx.x * WARPS + lane / 2;
      if (q < n_pieces) k = (lane & 1) ? pieces[q].z : pieces[q].x;
    }
    bool seen = false;  // an earlier lane holds the same row
#pragma unroll
    for (int j = 0; j < 2 * WARPS; ++j) {
      const int kj = __shfl_sync(FULL, k, j);
      seen |= j < lane && kj == k;
    }
    bool last = false;
    if (k >= 0 && !seen) {
      last = atomicAdd(arrivals + k, 1) == splits[k].w - 1;
      if (last) {
        arrivals[k] = 0;  // every block has arrived: ready for the next launch
        __threadfence();
      }
    }
    const unsigned mask = __ballot_sync(FULL, last);
    if (last) done[__popc(mask & ((1u << lane) - 1))] = k;
    if (lane == 0) n_done = __popc(mask);
  }
  __syncthreads();

  // sum each completed split row's partials in a fixed order: a row of at
  // most SPLIT_WARP partials by one warp, in piece order, the warps taking
  // such rows in turn; a longer one by all 8 warps, each a consecutive
  // eighth in order, then the eight in order
  for (int t = warp; t < n_done; t += WARPS) {
    const int4 sp = splits[done[t]];  // row, first partial, partials, blocks
    if (sp.z > SPLIT_WARP) continue;
    for (int c0 = 0; c0 < F; c0 += GROUP) {
      float sum[4];
      sum_partials<VEC>(part, sp.y, sp.y + sp.z, c0, F, lane, sum);
      store4<VEC>(out + (size_t)sp.x * F, c0, F, lane, sum);
    }
  }
  for (int t = 0; t < n_done; ++t) {
    const int4 sp = splits[done[t]];
    if (sp.z <= SPLIT_WARP) continue;
    const int per = (sp.z + WARPS - 1) / WARPS;
    const int lo = sp.y + min(warp * per, sp.z);
    const int hi = sp.y + min((warp + 1) * per, sp.z);
    for (int c0 = 0; c0 < F; c0 += GROUP) {
      float sum[4];
      sum_partials<VEC>(part, lo, hi, c0, F, lane, sum);
#pragma unroll
      for (int i = 0; i < 4; ++i) red[warp][col4<VEC>(lane, i)] = sum[i];
      __syncthreads();
      if (warp == 0) {
        float tot[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          tot[i] = red[0][col4<VEC>(lane, i)];
          for (int k = 1; k < WARPS; ++k) tot[i] += red[k][col4<VEC>(lane, i)];
        }
        store4<VEC>(out + (size_t)sp.x * F, c0, F, lane, tot);
      }
      __syncthreads();
    }
  }
}

struct Entry {
  int slot, row, send;
};

__device__ __forceinline__ Entry dw_entry(const int* __restrict__ ent, int n_real, int e,
                                          int e_end) {
  Entry m{-1, -1, 0};
  if (e < e_end) {
    m.slot = __ldg(ent + e);
    m.row = __ldg(ent + n_real + e);
    m.send = __ldg(ent + 2 * (size_t)n_real + e);
  }
  return m;
}

// the column of a row that lane l of a group of LPR holds as its i-th of
// DW_VEC in the pass at c0: consecutive ones (CONTIG), else strided by LPR
template <int LPR, bool CONTIG>
__device__ __forceinline__ int dw_col(int c0, int l, int i) {
  return CONTIG ? c0 + l * DW_VEC + i : c0 + l + LPR * i;
}

// A lane's DW_VEC columns of an F-wide row in the pass at c0, one 16-byte
// load where they are consecutive (F % 4 == 0), else one load each; columns
// >= F and entries that are not live read 0.  CS: a streaming (evict-first)
// load, for dy, whose rows a span reads once a run, so that the L2 keeps
// the x rows that every edge of a sender gathers again.
template <int LPR, bool CONTIG, bool CS = false>
__device__ __forceinline__ void ld_cols(const float* row, int c0, int l, int F, bool live,
                                        float (&v)[DW_VEC]) {
  if (CONTIG) {
    const int c = dw_col<LPR, CONTIG>(c0, l, 0);
    float4 t = make_float4(0.f, 0.f, 0.f, 0.f);
    const float4* q = reinterpret_cast<const float4*>(row + c);
    if (live && c < F) t = CS ? __ldcs(q) : __ldg(q);
    v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
  } else {
#pragma unroll
    for (int i = 0; i < DW_VEC; ++i) {
      const int c = dw_col<LPR, CONTIG>(c0, l, i);
      v[i] = live && c < F ? (CS ? __ldcs(row + c) : __ldg(row + c)) : 0.f;
    }
  }
}

// Each of LPR lanes holds N partial sums (N <= LPR, powers of 2); the group's
// butterfly at strides LPR/2 ... 1 adds them across lanes.  While a lane
// holds more than one value a level is transposed: the lane keeps half its
// values (the upper half where its stride bit is set) and adds the partner's
// copy of them, sending the other half.  After it v[0] holds the whole sum of
// value (lane % LPR) >> log2(LPR / N), in the lanes sharing those bits.
template <int N, int LPR>
__device__ __forceinline__ void reduce_lanes(float (&v)[N], int lane) {
#pragma unroll
  for (int o = LPR / 2; o > 0; o >>= 1) {
    const int half = N * o / LPR;  // values kept at this level; 0: a plain add
    if (half > 0) {
      const bool up = lane & o;
#pragma unroll
      for (int k = 0; k < N / 2; ++k) {
        if (k < half) {
          const float send = up ? v[k] : v[k + half];
          v[k] = (up ? v[k + half] : v[k]) + __shfl_xor_sync(FULL, send, o);
        }
      }
    } else {
      v[0] += __shfl_xor_sync(FULL, v[0], o);
    }
  }
}

// zeros into each lane's padding slots [lo, hi), the warp writing one lane's
// range after another
__device__ __forceinline__ void zero_gaps(float* __restrict__ out, int lo, int hi, int lane) {
  unsigned todo = __ballot_sync(FULL, hi > lo);
  while (todo) {
    const int j = __ffs(todo) - 1;
    todo &= todo - 1;
    const int a = __shfl_sync(FULL, lo, j), b = __shfl_sync(FULL, hi, j);
    for (int s = a + lane; s < b; s += 32) out[s] = 0.f;
  }
}

template <bool BF16, int LPR, bool CONTIG>
__global__ void __launch_bounds__(DW_WARPS * 32, 2)  // <= 128 registers: two blocks an SM
stream_dw_kernel(const int* __restrict__ ent, const float* __restrict__ x,
                 const float* __restrict__ dy, float* __restrict__ out, int n_real,
                 int n_spans, int span, long long slots, int F) {
  constexpr int VEC = DW_VEC;
  constexpr int SUB = LPR < DW_BATCH ? LPR : DW_BATCH;  // a group's entries in flight
  constexpr int SHIFT = LPR / SUB == 1 ? 0 : LPR / SUB == 2 ? 1 : LPR / SUB == 4 ? 2 : 3;
  const int lane = threadIdx.x % 32;
  const int grp = lane / LPR, l = lane % LPR;
  const int p = blockIdx.x * DW_WARPS + threadIdx.x / 32;
  const int e0 = p * span, e1 = p < n_spans ? min(e0 + span, n_real) : e0;
  // a warp that is one group in one pass keeps dy from entry to entry
  const bool carry = LPR == 32 && F <= 32 * VEC;
  int held = -1;  // the row whose dy the lane holds in hd
  float hd[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) hd[i] = 0.f;
  int before = e0 > 0 && e0 < e1 ? __ldg(ent + e0 - 1) : -1;  // the slot before the batch
  Entry nxt = dw_entry(ent, n_real, e0 + lane, e1);
  for (int b = e0; b < e1; b += 32) {
    const Entry me = nxt;
    nxt = dw_entry(ent, n_real, b + 32 + lane, e1);
    const int n = min(32, e1 - b);
    const int prev = __shfl_up_sync(FULL, me.slot, 1);
    const int lo = (lane == 0 ? before : prev) + 1;
    before = __shfl_sync(FULL, me.slot, n - 1);
    zero_gaps(out, lo, lane < n ? me.slot : lo, lane);

#pragma unroll
    for (int h = 0; h < LPR; h += SUB) {
      if (h >= n) break;  // every group's entries from h on lie past the span
      int rw[SUB], sd[SUB];
      float acc[SUB];
#pragma unroll
      for (int u = 0; u < SUB; ++u) {
        const int j = grp * LPR + h + u;  // the group's u-th entry of this sub-batch
        rw[u] = __shfl_sync(FULL, me.row, j);
        sd[u] = __shfl_sync(FULL, me.send, j);
        acc[u] = 0.f;
      }
      for (int c0 = 0; c0 < F; c0 += LPR * VEC) {
        float xv[SUB][VEC], dv[SUB][VEC];
        bool fresh[SUB];
        // every load first: the x rows, and dy where the receiver changes
#pragma unroll
        for (int u = 0; u < SUB; ++u) {
          const bool live = grp * LPR + h + u < n;
          fresh[u] = u == 0 ? !(carry && rw[0] == held) : rw[u] != rw[u - 1];
          ld_cols<LPR, CONTIG>(x + (size_t)sd[u] * F, c0, l, F, live, xv[u]);
          if (fresh[u])
            ld_cols<LPR, CONTIG, true>(dy + (size_t)rw[u] * F, c0, l, F, live, dv[u]);
        }
#pragma unroll
        for (int u = 0; u < SUB; ++u) {  // dy rounded once a run
#pragma unroll
          for (int i = 0; i < VEC; ++i) {
            dv[u][i] = !fresh[u] ? (u == 0 ? hd[i] : dv[u - 1][i])
                       : BF16 ? round_bf16(dv[u][i]) : dv[u][i];
          }
        }
#pragma unroll
        for (int u = 0; u < SUB; ++u) {
#pragma unroll
          for (int i = 0; i < VEC; ++i) {
            acc[u] += __fmul_rn(BF16 ? round_bf16(xv[u][i]) : xv[u][i], dv[u][i]);
          }
        }
        if (carry) {
          held = rw[SUB - 1];
#pragma unroll
          for (int i = 0; i < VEC; ++i) hd[i] = dv[SUB - 1][i];
        }
      }
      reduce_lanes<SUB, LPR>(acc, lane);
      const int j = grp * LPR + h + (l >> SHIFT);  // the entry whose dot this lane holds
      const int slot = __shfl_sync(FULL, me.slot, j);
      if ((l & ((1 << SHIFT) - 1)) == 0 && j < n) __stcs(out + slot, acc[0]);
    }
  }
  // the padding after the last real slot (a macro budget's fillers may be
  // most of the slots), cut evenly over every warp of the grid
  const long long lo = n_real > 0 ? (long long)__ldg(ent + n_real - 1) + 1 : 0;
  const long long nw = (long long)gridDim.x * DW_WARPS;
  const long long per = ((slots - lo + nw - 1) / nw + 31) / 32 * 32;
  const long long end = min(lo + (p + 1) * per, slots);
  for (long long s = lo + p * per + lane; s < end; s += 32) out[s] = 0.f;
}

template <int WK, bool VEC>
cudaError_t launch_scatter(const int* ent, const int* pieces, const int* splits,
                           const int* empty_rows, int* arrivals, const void* w,
                           const float* x, float* out, float* part, int n_real,
                           int n_pieces, int n_empty, int piece, int tr_w, int F,
                           cudaStream_t stream) {
  const int blocks = std::max({(n_pieces + WARPS - 1) / WARPS,
                               (n_empty + WARPS * ZERO_ROWS - 1) / (WARPS * ZERO_ROWS), 1});
  stream_scatter_kernel<WK, VEC><<<blocks, THREADS, 0, stream>>>(
      ent, reinterpret_cast<const int4*>(pieces), reinterpret_cast<const int4*>(splits),
      empty_rows, arrivals, w, x, out, part, n_real, n_pieces, n_empty, piece, tr_w, F);
  return cudaGetLastError();
}

template <int WK>
cudaError_t launch_scatter_vec(const int* ent, const int* pieces, const int* splits,
                               const int* empty_rows, int* arrivals, const void* w,
                               const float* x, float* out, float* part, int n_real,
                               int n_pieces, int n_empty, int piece, int tr_w, int F,
                               cudaStream_t stream) {
  // 16-byte rows when F % 4 == 0 and the rows start 16-byte aligned
  const bool vec = F % 4 == 0 &&
                   ((uintptr_t)x | (uintptr_t)out | (uintptr_t)part) % 16 == 0;
  return vec ? launch_scatter<WK, true>(ent, pieces, splits, empty_rows, arrivals, w, x,
                                        out, part, n_real, n_pieces, n_empty, piece,
                                        tr_w, F, stream)
             : launch_scatter<WK, false>(ent, pieces, splits, empty_rows, arrivals, w, x,
                                         out, part, n_real, n_pieces, n_empty, piece,
                                         tr_w, F, stream);
}

template <bool BF16, bool CONTIG>
cudaError_t launch_dw(const int* ent, const float* x, const float* dy, float* out,
                      int n_real, int n_spans, int span, long long slots, int F,
                      cudaStream_t stream) {
  const int lanes = (F + DW_VEC - 1) / DW_VEC;
  const int lpr = lanes <= 4 ? 4 : lanes <= 8 ? 8 : lanes <= 16 ? 16 : 32;
  const int blocks = std::max((n_spans + DW_WARPS - 1) / DW_WARPS, 1);
  switch (lpr) {
#define KGCN_DW(L)                                                           \
  case L:                                                                    \
    stream_dw_kernel<BF16, L, CONTIG><<<blocks, DW_WARPS * 32, 0, stream>>>( \
        ent, x, dy, out, n_real, n_spans, span, slots, F);                   \
    break;
    KGCN_DW(4) KGCN_DW(8) KGCN_DW(16) KGCN_DW(32)
#undef KGCN_DW
  }
  return cudaGetLastError();
}

template <bool BF16>
cudaError_t launch_dw_vec(const int* ent, const float* x, const float* dy, float* out,
                          int n_real, int n_spans, int span, long long slots, int F,
                          cudaStream_t stream) {
  // 16-byte rows when F % 4 == 0 and x and dy start 16-byte aligned; else
  // 4 columns a lane strided by the group's width, as the scatter's scalar
  // path
  if (F % 4 == 0 && ((uintptr_t)x | (uintptr_t)dy) % 16 == 0)
    return launch_dw<BF16, true>(ent, x, dy, out, n_real, n_spans, span, slots, F, stream);
  return launch_dw<BF16, false>(ent, x, dy, out, n_real, n_spans, span, slots, F, stream);
}

}  // namespace

extern "C" {

// out [num_receivers, F] = the structure's sparse matrix times x
// [num_senders, F], over the StreamPlan's arrays (entries [3, n_real],
// pieces [n_pieces, 4], splits [n_split, 4], empty_rows [n_empty], arrivals
// [n_split], zero between launches).  weights: 0 = w_slots [slots] f32, 1 =
// the same with the bf16 payload, 2 = one-hots oh [slots, tr_w] bf16.  part:
// scratch of the plan's n_parts rows of F.  Launches on `stream` (a
// cudaStream_t); returns the cudaError_t of the launch (0 on success).
// Does not synchronise and allocates nothing.
int kgcn_stream_scatter(const int* entries, const int* pieces, const int* splits,
                        const int* empty_rows, int* arrivals, const void* w,
                        const float* x, float* out, float* part, int n_real,
                        int n_pieces, int n_empty, int piece, int tr_w, int F,
                        int weights, void* stream) {
  if (piece <= 0 || tr_w <= 0 || F <= 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (weights) {
    case W_F32:
      return (int)launch_scatter_vec<W_F32>(entries, pieces, splits, empty_rows, arrivals,
                                            w, x, out, part, n_real, n_pieces, n_empty,
                                            piece, tr_w, F, s);
    case W_BF16:
      return (int)launch_scatter_vec<W_BF16>(entries, pieces, splits, empty_rows,
                                             arrivals, w, x, out, part, n_real, n_pieces,
                                             n_empty, piece, tr_w, F, s);
    case W_ONEHOT:
      return (int)launch_scatter_vec<W_ONEHOT>(entries, pieces, splits, empty_rows,
                                               arrivals, w, x, out, part, n_real,
                                               n_pieces, n_empty, piece, tr_w, F, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// out [slots]: per slot <dy[receiver], x[sender]>, 0 in padding slots, over
// the StreamPlan's entries [3, n_real] (slot, receiver row, sender) cut
// into n_spans spans of `span` entries, a warp each; x [num_senders, F],
// dy [num_receivers, F]; bf16: round both operands to bf16.  Writes every
// slot of out once.  Same conventions as kgcn_stream_scatter.
int kgcn_stream_dw(const int* entries, const float* x, const float* dy, float* out,
                   int n_real, int n_spans, int span, long long slots, int F, int bf16,
                   void* stream) {
  if (span <= 0 || F < 0 || n_real < 0 || slots < n_real ||
      (long long)n_spans * span < n_real)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  return bf16 ? (int)launch_dw_vec<true>(entries, x, dy, out, n_real, n_spans, span, slots,
                                         F, s)
              : (int)launch_dw_vec<false>(entries, x, dy, out, n_real, n_spans, span,
                                          slots, F, s);
}

const char* kgcn_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
