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
// bound by bytes and by the latency of dependent gathers.
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
// dw: one warp per slot (grid-stride), lanes over F, a shuffle reduction.
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
constexpr int SMS = 132;          // H100 SXM
constexpr int DW_WARPS = 8;       // dw blocks: 8 warps, one slot each
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

__global__ void __launch_bounds__(DW_WARPS * 32)
stream_dw_kernel(const int* __restrict__ slot_sender,
                 const int* __restrict__ r_loc, const int* __restrict__ sub_wid,
                 const int* __restrict__ macro_rb, const float* __restrict__ x,
                 const float* __restrict__ dy, float* __restrict__ out,
                 long long slots, int chunk, int mc, int wb, int tr_w,
                 int num_senders, int num_receivers, int F, int bf16) {
  const int lane = threadIdx.x % 32;
  const long long nwarps = (long long)gridDim.x * DW_WARPS;
  for (long long slot = (long long)blockIdx.x * DW_WARPS + threadIdx.x / 32;
       slot < slots; slot += nwarps) {
    const int s = slot_sender[slot];
    const long long sub = slot / chunk;
    const long long r =
        ((long long)macro_rb[sub / mc] * wb + sub_wid[sub]) * tr_w + r_loc[slot];
    if (s < 0 || s >= num_senders || r < 0 || r >= num_receivers) {  // padding
      if (lane == 0) out[slot] = 0.f;
      continue;
    }
    const float* xs = x + (size_t)s * F;
    const float* dr = dy + (size_t)r * F;
    float sum = 0.f;
    for (int k = lane; k < F; k += 32) {
      float a = xs[k], b = dr[k];
      if (bf16) { a = round_bf16(a); b = round_bf16(b); }
      sum += __fmul_rn(a, b);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(FULL, sum, o);
    if (lane == 0) out[slot] = sum;
  }
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

// out [slots]: per slot <dy[receiver], x[sender]> (0 in padding slots),
// x [num_senders, F], dy [num_receivers, F].  Same conventions.
int kgcn_stream_dw(const int* slot_sender, const int* r_loc,
                   const int* sub_wid, const int* macro_rb, const float* x,
                   const float* dy, float* out, long long slots, int chunk,
                   int mc, int wb, int tr_w, int num_senders,
                   int num_receivers, int F, int bf16, void* stream) {
  long long blocks = (slots + DW_WARPS - 1) / DW_WARPS;
  if (blocks > SMS * 16) blocks = SMS * 16;  // grid-stride past 16 blocks/SM
  stream_dw_kernel<<<(unsigned)blocks, DW_WARPS * 32, 0, (cudaStream_t)stream>>>(
      slot_sender, r_loc, sub_wid, macro_rb, x, dy, out, slots, chunk, mc, wb,
      tr_w, num_senders, num_receivers, F, bf16);
  return (int)cudaGetLastError();
}

const char* kgcn_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
