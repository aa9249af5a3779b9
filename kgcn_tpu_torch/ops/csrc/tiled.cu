// Tiled sparse x dense product (SpMM) and its sampled dense-dense gradient
// (SDDMM) for Hopper (sm_90a), on the TiledCOO edge structure of
// kgcn_tpu_torch/ops/tiled_spmm.py.
//
//   spmm:  out[r, :] = sum over slots of edge e with receiver r of
//          w[e] * x[s_e, :]          x [num_senders, F] -> out [num_receivers, F]
//   sddmm: dw[slot] = <g[r_slot, :], x[s_slot, :]>    -> [n_chunks, chunk]
//
// Replaces the Pallas TPU kernels `_spmm_kernel` and `_sddmm_kernel`
// (kgcn_tpu/ops/tiled_spmm.py:320 and :353).  The TPU kernels gather and
// scatter through one-hot matmuls on the MXU because Mosaic cannot gather
// rows; here rows are gathered directly.
//
// Payload (bf16 = 1, the default of the port's configs): x and w are
// rounded to bf16, their product is exact in f32, the message is rounded to
// bf16 and summed in f32 -- the TPU kernel's roundings.  The SDDMM rounds
// both operands to bf16 and sums the (exact) products in f32.  bf16 = 0 is
// plain f32 (products not fused into FMAs, as in the plain version).
//
// What bounds it: an edge costs 2F FLOP against ~4F bytes of gathered x
// row (f32 in memory), so the work is memory- and latency-bound; at the
// training path's shapes (1504 nodes, ~750 edges, F <= 81) one call is a
// few microseconds of launch and load latency, at 10^6 edges and F 128 the
// gathers of 0.5 GB of rows (from L2 for the most part).
//
// SpMM: work follows the real slots.  The host plan (TiledPlan, built when
//   a structure moves to the card) lists a direction's real slots in
//   receiver order, stable in slot order, as (edge id, receiver row,
//   sender); the edge id indexes the weights, which arrive with each launch
//   (GAT's attention changes every step).  The entries are cut into pieces
//   at row starts: below 16 384 entries a piece per row (a molecule batch's
//   ~250 pieces: short chains of loads on many warps), a row of more than
//   `piece` entries (32-512, so that a structure has some 2 000 pieces) cut
//   at the multiples of `piece` in it; beyond, a cut at each multiple of
//   `piece`, moved back to its row's start unless that lies more than a
//   quarter piece back.  A warp walks one piece: every entry's metadata and
//   weight are read once (a lane per entry, the next 32 prefetched), a lane
//   holds 4 of a 128-column group (one 16-byte load or store when
//   F % 4 == 0), 16 gathered rows are in flight, and the running row is
//   summed in registers from 0 in entry order, so each row keeps the plain
//   version's order of sums.  A row that lies in this piece alone is written
//   straight to out when the receiver changes.  The piece's first and last
//   rows, where other pieces share them (a hub's), go to partial rows, and
//   the plan names these split rows with their partials (consecutive, in
//   piece order).  Each block of 8 pieces, after its partials, bumps a
//   counter per split row it wrote to; the block that completes a row sums
//   its partials -- one warp in order where there are at most 64 (the warps
//   take such rows in turn), else its 8 warps each a consecutive eighth in
//   order, then the eight in order -- writes the row and resets the
//   counter.  So the order of every sum is fixed by the plan: two launches
//   give the same bits, with no atomics on values.  Rows without a real
//   slot (the plan's empty_rows) are written as zeros, spread evenly over
//   the grid's warps; every row of out is written once, and padding slots,
//   budget fillers and edge-free tiles are never visited.
// SDDMM: one warp per slot (grid-stride), lanes over F, a shuffle reduction.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>


namespace {

constexpr int WARPS = 8;          // pieces per block (tiled_spmm.PIECES_PER_BLOCK)
constexpr int THREADS = WARPS * 32;
constexpr int GROUP = 128;        // columns a warp sums at a time: 4 per lane
constexpr int BATCH = 16;         // gathered x rows a warp keeps in flight
constexpr int SPLIT_WARP = 64;    // split rows of at most this many partials: one warp
constexpr int ZERO_ROWS = 16;     // empty rows per warp, sizing the grid
constexpr int SMS = 132;          // H100 SXM
constexpr int SDDMM_WARPS = 8;    // SDDMM blocks: 8 warps, one slot each
constexpr unsigned FULL = 0xffffffffu;

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
  float w;  // rounded to bf16 with the bf16 payload
};

template <bool BF16>
__device__ __forceinline__ Slot slot_meta(const int* __restrict__ ent, int n_real,
                                          int e, int e_end, const float* __restrict__ w) {
  Slot m{-1, 0, 0.f};
  if (e < e_end) {
    const int edge = __ldg(ent + e);
    m.row = __ldg(ent + n_real + e);
    m.send = __ldg(ent + 2 * n_real + e);
    const float v = __ldg(w + edge);
    m.w = BF16 ? round_bf16(v) : v;
  }
  return m;
}

template <bool BF16, bool VEC>
__global__ void __launch_bounds__(THREADS)
tiled_spmm_kernel(const int* __restrict__ ent, const int* __restrict__ starts,
                  const int4* __restrict__ pieces, const int4* __restrict__ splits,
                  const int* __restrict__ empty_rows, int* __restrict__ arrivals,
                  const float* __restrict__ w, const float* __restrict__ x,
                  float* __restrict__ out, float* __restrict__ part, int n_real,
                  int n_pieces, int n_split, int n_empty, int F) {
  __shared__ float red[WARPS][GROUP];  // the warps' sums of a split row
  __shared__ int done[2 * WARPS];      // split rows this block completes
  __shared__ int n_done;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int p = blockIdx.x * WARPS + warp;

  bool wrote_part = false;  // this warp wrote a partial row
  if (p < n_pieces) {
    // (split row, partial) of the piece's first and of its last row
    const int4 info = pieces[p];
    wrote_part = info.y >= 0 || info.w >= 0;
    const int e0 = __ldg(starts + p);
    const int e1 = __ldg(starts + p + 1);
    for (int c0 = 0; c0 < F; c0 += GROUP) {
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
      int cur = -1;        // the row being summed
      bool first = true;   // cur is the piece's first row
      Slot nxt = slot_meta<BF16>(ent, n_real, e0 + lane, e1, w);
      for (int b = e0; b < e1; b += 32) {
        const Slot me = nxt;
        nxt = slot_meta<BF16>(ent, n_real, b + 32 + lane, e1, w);
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
            if (j < n) {
              load4<VEC>(x + (size_t)s * F, c0, F, lane, xv[u]);
            } else {
              rw[u] = -1;
            }
          }
          // the weights after the gathers are under way: their loads overlap
#pragma unroll
          for (int u = 0; u < BATCH; ++u) wv[u] = __shfl_sync(FULL, me.w, (j0 + u) & 31);
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
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              if (!VEC && c0 + 32 * i >= F) break;  // past F in every lane
              const float xi = BF16 ? round_bf16(xv[u][i]) : xv[u][i];
              const float msg = __fmul_rn(wv[u], xi);
              acc[i] += BF16 ? round_bf16(msg) : msg;
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

  // rows without a real slot: zeros; every warp of the grid takes `per` of
  // the list at a time, one id a lane (not a chain of dependent loads)
  const int nw = gridDim.x * WARPS;
  const int per = min(32, (n_empty + nw - 1) / nw);
  const float z[4] = {0.f, 0.f, 0.f, 0.f};
  for (long long i0 = (long long)p * per; i0 < n_empty; i0 += (long long)nw * per) {
    const int n = (int)min((long long)per, n_empty - i0);
    const int mine = lane < n ? __ldg(empty_rows + i0 + lane) : 0;
    for (int j = 0; j < n; ++j) {
      float* o = out + (size_t)__shfl_sync(FULL, mine, j) * F;
      for (int c0 = 0; c0 < F; c0 += GROUP) store4<VEC>(o, c0, F, lane, z);
    }
  }

  if (n_split == 0) return;  // no row is cut: no partial to sum

  // this block's partials are written: the warps that wrote one make them
  // visible, then the block counts itself in for each split row it wrote
  // to, once, and notes the rows it is the last to reach
  if (wrote_part) __threadfence();
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

template <bool BF16, bool VEC>
cudaError_t launch_spmm(const int* ent, const int* starts, const int* pieces,
                        const int* splits, const int* empty_rows, int* arrivals,
                        const float* w, const float* x, float* out, float* part,
                        int n_real, int n_pieces, int n_split, int n_empty, int F,
                        cudaStream_t stream) {
  const int blocks = std::max({(n_pieces + WARPS - 1) / WARPS,
                               (n_empty + WARPS * ZERO_ROWS - 1) / (WARPS * ZERO_ROWS), 1});
  tiled_spmm_kernel<BF16, VEC><<<blocks, THREADS, 0, stream>>>(
      ent, starts, reinterpret_cast<const int4*>(pieces),
      reinterpret_cast<const int4*>(splits), empty_rows, arrivals, w, x, out, part, n_real,
      n_pieces, n_split, n_empty, F);
  return cudaGetLastError();
}

template <bool BF16>
cudaError_t launch_spmm_vec(const int* ent, const int* starts, const int* pieces,
                            const int* splits, const int* empty_rows, int* arrivals,
                            const float* w, const float* x, float* out, float* part,
                            int n_real, int n_pieces, int n_split, int n_empty, int F,
                            cudaStream_t stream) {
  // 16-byte rows when F % 4 == 0 and the rows start 16-byte aligned
  const bool vec = F % 4 == 0 &&
                   ((uintptr_t)x | (uintptr_t)out | (uintptr_t)part) % 16 == 0;
  return vec ? launch_spmm<BF16, true>(ent, starts, pieces, splits, empty_rows, arrivals,
                                       w, x, out, part, n_real, n_pieces, n_split,
                                       n_empty, F, stream)
             : launch_spmm<BF16, false>(ent, starts, pieces, splits, empty_rows, arrivals,
                                        w, x, out, part, n_real, n_pieces, n_split,
                                        n_empty, F, stream);
}

__global__ void __launch_bounds__(SDDMM_WARPS * 32)
tiled_sddmm_kernel(const int* __restrict__ s_loc, const int* __restrict__ r_loc,
                   const int* __restrict__ slot_src,
                   const int* __restrict__ chunk_rt,
                   const int* __restrict__ chunk_st,
                   const float* __restrict__ x, const float* __restrict__ g,
                   float* __restrict__ out, long long total, int chunk, int ts,
                   int tr, int num_edges, int F, int bf16) {
  const int lane = threadIdx.x % 32;
  const long long nwarps = (long long)gridDim.x * SDDMM_WARPS;
  for (long long slot = (long long)blockIdx.x * SDDMM_WARPS + threadIdx.x / 32;
       slot < total; slot += nwarps) {
    const int src = slot_src[slot];
    if (src < 0 || src >= num_edges) {  // padding slot
      if (lane == 0) out[slot] = 0.f;
      continue;
    }
    const long long c = slot / chunk;
    const float* xs = x + (size_t)(chunk_st[c] * ts + s_loc[slot]) * F;
    const float* gr = g + (size_t)(chunk_rt[c] * tr + r_loc[slot]) * F;
    float sum = 0.f;
    for (int k = lane; k < F; k += 32) {
      float a = xs[k], b = gr[k];
      if (bf16) { a = round_bf16(a); b = round_bf16(b); }
      sum += __fmul_rn(a, b);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
    if (lane == 0) out[slot] = sum;
  }
}

}  // namespace

extern "C" {

// out [num_receivers, F] = the structure's sparse matrix (weights w[E]) times
// x [num_senders, F], over the TiledPlan's arrays (entries [3, n_real]:
// edge id, receiver row, sender; starts [n_pieces + 1]; pieces [n_pieces,
// 4], splits [n_split, 4], empty_rows [n_empty], arrivals [n_split], zero
// between launches).  part: scratch of the plan's n_parts rows of F.
// Launches on `stream` (a cudaStream_t); returns the cudaError_t of the
// launch (0 on success).  Does not synchronise and allocates nothing.
int kgcn_tiled_spmm(const int* entries, const int* starts, const int* pieces,
                    const int* splits, const int* empty_rows, int* arrivals,
                    const float* weights, const float* x, float* out, float* part,
                    int n_real, int n_pieces, int n_split, int n_empty, int F, int bf16,
                    void* stream) {
  if (F <= 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  return bf16 ? (int)launch_spmm_vec<true>(entries, starts, pieces, splits, empty_rows,
                                           arrivals, weights, x, out, part, n_real,
                                           n_pieces, n_split, n_empty, F, s)
              : (int)launch_spmm_vec<false>(entries, starts, pieces, splits, empty_rows,
                                            arrivals, weights, x, out, part, n_real,
                                            n_pieces, n_split, n_empty, F, s);
}

// out [n_chunks, chunk]: per slot <g[receiver], x[sender]> (0 in padding
// slots), x [num_senders, F], g [num_receivers, F].  Same conventions.
int kgcn_tiled_sddmm(const int* s_loc, const int* r_loc, const int* slot_src,
                     const int* chunk_rt, const int* chunk_st, const float* x,
                     const float* g, float* out, int n_chunks, int chunk,
                     int ts, int tr, int num_edges, int F, int bf16,
                     void* stream) {
  const long long total = (long long)n_chunks * chunk;
  long long blocks = (total + SDDMM_WARPS - 1) / SDDMM_WARPS;
  if (blocks > SMS * 16) blocks = SMS * 16;  // grid-stride past 16 blocks/SM
  tiled_sddmm_kernel<<<(unsigned)blocks, SDDMM_WARPS * 32, 0, (cudaStream_t)stream>>>(
      s_loc, r_loc, slot_src, chunk_rt, chunk_st, x, g, out, total, chunk, ts,
      tr, num_edges, F, bf16);
  return (int)cudaGetLastError();
}

const char* kgcn_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
