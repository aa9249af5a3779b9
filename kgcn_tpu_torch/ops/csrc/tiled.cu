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
// rows; here rows are gathered directly, and only the input contract of the
// structure is kept: slots sorted by (receiver tile, sender tile), s_loc /
// r_loc local to the chunk's tiles, slot_src the edge id (num_edges marks a
// padding slot), chunk_rt non-decreasing, and within a receiver tile the
// chunks without edges after those with edges (as build_tiled and its
// chunk budget lay them out).
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
// few microseconds of load latency.  The design is simple and exact:
//
// SpMM: one block of 16 warps per (receiver tile rt, slice of at most 256 of
//   its rows, 32-column slice).  The block alone owns its rows of `out` for
//   its columns, so it needs no atomics and the summation order is fixed
//   (slot order); its accumulator (rows x 32 f32, at most 32 KB) always fits
//   in shared memory.  The host picks the row slice: 256 rows (or the tile),
//   halved down to 32 while the grid has fewer blocks than the card has SMs,
//   so a batch of one or two tiles still spreads over the card.  The tile's
//   chunks are contiguous (chunk_rt is non-decreasing), and those that hold
//   no edge -- the one chunk of an edge-free tile, the budget fillers -- come
//   after those that do; a chunk holds an edge iff its first slot does.  One
//   parallel scan of chunk_rt and the chunk heads finds the tile's first
//   chunk and its chunks that hold edges, whose slots form one contiguous
//   range.  Every block of the tile walks that range, 512 slots at a time
//   staged in shared memory (sender row, receiver row in the slice, weight;
//   padding slots and other slices' rows marked), and warp w finds the slots
//   whose row is = w mod 16 with __ballot_sync, 32 slots at a time, keeps 4
//   x-row loads in flight, and adds the messages in slot order (lane =
//   column) to its rows of the accumulator.  No block touches another's
//   rows, so receiver tiles without edges and budget fillers need no care.
// SDDMM: one warp per slot (grid-stride), lanes over F, a shuffle reduction.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 512;
constexpr int WARPS = THREADS / 32;
constexpr int TF = 32;          // output columns per block: one per lane
constexpr int PIECE = THREADS;  // slots staged per step, one per thread
constexpr int BATCH = 4;        // x-row loads a warp keeps in flight
constexpr int MAX_ROWS = 256;   // receiver rows per block
constexpr int MIN_ROWS = 32;
constexpr int SMS = 132;        // H100 SXM
constexpr int SDDMM_WARPS = 8;  // SDDMM blocks: 8 warps, one slot each
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__global__ void __launch_bounds__(THREADS)
tiled_spmm_kernel(const int* __restrict__ s_loc, const int* __restrict__ r_loc,
                  const int* __restrict__ slot_src,
                  const int* __restrict__ chunk_rt,
                  const int* __restrict__ chunk_st,
                  const float* __restrict__ weights,
                  const float* __restrict__ x, float* __restrict__ out,
                  int n_chunks, int chunk, int ts, int tr, int slice_rows,
                  int num_receivers, int num_edges, int F, int bf16) {
  __shared__ int st_send[PIECE];  // sender row, -1 = not this block's
  __shared__ int st_row[PIECE];   // receiver row in the slice
  __shared__ float st_w[PIECE];
  __shared__ float acc[MAX_ROWS * TF];

  const int slices = (tr + slice_rows - 1) / slice_rows;
  const int rt = blockIdx.x / slices;
  const int row0 = (blockIdx.x % slices) * slice_rows;  // first row in the tile
  const int rows = min(min(slice_rows, tr - row0), num_receivers - rt * tr - row0);
  if (rows <= 0) return;  // a slice past the last receiver
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int f = blockIdx.y * TF + lane;
  const bool col_ok = f < F;

  // Thread (warp, lane) owns rows = warp (mod WARPS) of column f: it alone
  // zeroes, accumulates and writes them, so no barrier guards them.
  for (int r = warp; r < rows; r += WARPS) acc[r * TF + lane] = 0.f;

  // the tile's first chunk (chunks of earlier tiles) and its chunks that
  // hold edges; stop at the first stripe that reaches a later tile
  int lo = 0, used = 0;
  for (int base = 0; base < n_chunks; base += THREADS) {
    const int c = base + tid;
    const int crt = c < n_chunks ? chunk_rt[c] : 0x7fffffff;
    const bool head = crt == rt && slot_src[(size_t)c * chunk] < num_edges;
    lo += __syncthreads_count(crt < rt);
    used += __syncthreads_count(head);
    if (__syncthreads_or(crt > rt)) break;
  }

  const long long s_end = (long long)(lo + used) * chunk;
  for (long long p0 = (long long)lo * chunk; p0 < s_end; p0 += PIECE) {
    __syncthreads();  // every warp is done with the previous piece
    const long long i = p0 + tid;
    int send = -1, row = 0;
    float wv = 0.f;
    if (i < s_end) {
      const int src = slot_src[i];
      const int rl = r_loc[i] - row0;
      if (src >= 0 && src < num_edges && rl >= 0 && rl < rows) {
        send = chunk_st[i / chunk] * ts + s_loc[i];
        row = rl;
        wv = weights[src];
      }
    }
    st_send[tid] = send;
    st_row[tid] = row;
    st_w[tid] = wv;
    __syncthreads();
    const int n = (int)min((long long)PIECE, s_end - p0);
    for (int k = 0; k < n; k += 32) {
      const int j = k + lane;
      const bool mine = j < n && st_send[j] >= 0 && (st_row[j] % WARPS) == warp;
      unsigned mask = __ballot_sync(FULL, mine);  // this warp's slots, in order
      while (mask) {
        int js[BATCH];
        float xv[BATCH];
#pragma unroll
        for (int u = 0; u < BATCH; ++u) {
          js[u] = mask ? k + __ffs(mask) - 1 : -1;
          mask &= mask - 1;
        }
#pragma unroll
        for (int u = 0; u < BATCH; ++u) {
          xv[u] = (js[u] >= 0 && col_ok) ? x[(size_t)st_send[js[u]] * F + f] : 0.f;
        }
#pragma unroll
        for (int u = 0; u < BATCH; ++u) {
          if (js[u] < 0 || !col_ok) continue;
          const float w = st_w[js[u]];
          float m;
          if (bf16) {
            m = round_bf16(__fmul_rn(round_bf16(w), round_bf16(xv[u])));
          } else {
            m = __fmul_rn(w, xv[u]);
          }
          acc[st_row[js[u]] * TF + lane] += m;
        }
      }
    }
  }
  if (col_ok) {
    float* o = out + (size_t)(rt * tr + row0) * F + f;
    for (int r = warp; r < rows; r += WARPS) o[(size_t)r * F] = acc[r * TF + lane];
  }
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
// x [num_senders, F].  Launches on `stream` (a cudaStream_t); returns the
// cudaError_t of the launch (0 on success).  Does not synchronise and
// allocates nothing.
int kgcn_tiled_spmm(const int* s_loc, const int* r_loc, const int* slot_src,
                    const int* chunk_rt, const int* chunk_st,
                    const float* weights, const float* x, float* out,
                    int n_chunks, int chunk, int ts, int tr, int n_rt,
                    int num_receivers, int num_edges, int F, int bf16,
                    void* stream) {
  const int cols = (F + TF - 1) / TF;
  int rows = tr < MAX_ROWS ? tr : MAX_ROWS;
  while (rows >= 2 * MIN_ROWS && (long long)n_rt * ((tr + rows - 1) / rows) * cols < SMS) {
    rows /= 2;
  }
  dim3 grid(n_rt * ((tr + rows - 1) / rows), cols);
  tiled_spmm_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      s_loc, r_loc, slot_src, chunk_rt, chunk_st, weights, x, out, n_chunks,
      chunk, ts, tr, rows, num_receivers, num_edges, F, bf16);
  return (int)cudaGetLastError();
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
