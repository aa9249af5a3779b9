// Streaming scatter SpMM of the stream backend for Hopper (sm_90a), on the
// StreamCOO edge structure of kgcn_tpu_torch/ops/stream_spmm.py.
//
//   scatter:     out[r, :] = sum over slots with receiver r of
//                cdt(w[slot]) * cdt(x[slot_sender[slot], :])
//   scatter_mat: out[window rows, :] = sum over the window's slots of
//                oh[slot, :]^T * bf16(x[slot_sender[slot], :])
//   dw:          dw[slot] = <cdt(dy[r_slot, :]), cdt(x[slot_sender[slot], :])>
//
// Replace the Pallas TPU kernels `_scatter_kernel`, `_scatter_kernel_mat` and
// `_dw_kernel` (kgcn_tpu/ops/stream_spmm.py:335, :374 and :448).  The TPU
// kernels scatter through one-hot matmuls because Mosaic cannot scatter rows,
// and take the gathered rows g = x[slot_sender] from an XLA gather; here the
// gather is fused (x is read at slot_sender; the sentinel num_senders is the
// zero row) and rows are addressed directly.  What is kept is the structure's
// contract: slots sorted by receiver, cut into tr_w-row receiver windows whose
// sub-chunks of `chunk` slots are consecutive; win_subs[w] = (first
// sub-chunk, sub-chunk count) of window w; r_loc the receiver row within the
// window; padding slots carry sender num_senders and weight 0 (all-zero
// one-hot rows).
//
// Payload (bf16 = 1, the default): the gathered row and the weight are
// rounded to bf16, their product is exact in f32 and the sum runs in f32 --
// the TPU kernels' roundings (their one-hot holds bf16(w), their gather
// bf16(x); products summed in f32).  bf16 = 0 rounds nothing.  scatter_mat
// is bf16 only (the one-hots are bf16).  dw rounds dy and x alike.
//
// What bounds them: an edge moves one F-wide f32 row (4F bytes, from L2
// when x fits there) for 2F FLOP, so the work is memory- and latency-bound.
// The design is simple, deterministic and has no atomics:
//
// scatter / scatter_mat: one block of 8 warps per (receiver window, 32-column
//   slice).  The block alone owns the window's rows for its columns, so the
//   sum over slots runs in slot order in one thread per output element (lane
//   = column, warp w owns rows = w mod 8), accumulating in shared memory, and
//   every window -- edge-free ones included -- is written once.  Macro
//   zeroing, block padding and budget fillers need no counterpart: only the
//   window's own sub-chunks are walked.  scatter stages 256 slots at a time
//   (sender, row, weight), and each warp finds its slots with __ballot_sync,
//   32 at a time, keeping up to 16 x-row loads in flight (a hub row's slots
//   all fall to one warp).  scatter_mat stages 128 one-hot rows at a time in
//   shared memory (row stride tr_w + 2, so the 32 lanes scanning 32 rows hit
//   32 banks); for 32 slots at a time each lane makes the bitmask of the
//   warp's rows where its slot's one-hot is non-zero, a ballot finds the
//   slots with any, and the warp adds each marked entry times the slot's
//   gathered row -- every non-zero entry, one per slot for build_stream's
//   one-hots.
// dw: one warp per slot (grid-stride), lanes over F, a shuffle reduction.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int TF = 32;          // output columns per block: one per lane
constexpr int PIECE = THREADS;  // scatter: slots staged per step
constexpr int MAT_PIECE = 128;  // scatter_mat: one-hot rows staged per step
constexpr int OH_PAD = 2;       // scatter_mat: bf16 pad per staged row
constexpr int BATCH = 16;       // x-row loads a warp keeps in flight
constexpr int MAX_TR_W = 256;   // window rows (the accumulator is tr_w x 32)
constexpr int SMS = 132;        // H100 SXM
constexpr int DW_WARPS = 8;     // dw blocks: 8 warps, one slot each
constexpr int STATIC_SMEM_LIMIT = 48 * 1024;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__global__ void __launch_bounds__(THREADS)
stream_scatter_kernel(const int* __restrict__ slot_sender,
                      const int* __restrict__ r_loc,
                      const int* __restrict__ win_subs,
                      const float* __restrict__ w_slots,
                      const float* __restrict__ x, float* __restrict__ out,
                      int chunk, int tr_w, int num_senders, int num_receivers,
                      int F, int bf16) {
  extern __shared__ float acc[];  // tr_w x TF
  __shared__ int st_send[PIECE];  // sender row, -1 = padding
  __shared__ int st_row[PIECE];   // receiver row in the window
  __shared__ float st_w[PIECE];

  const int win = blockIdx.x;
  const int row0 = win * tr_w;
  const int rows = min(tr_w, num_receivers - row0);
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int f = blockIdx.y * TF + lane;
  const bool col_ok = f < F;

  // Thread (warp, lane) owns rows = warp (mod WARPS) of column f: it alone
  // zeroes, accumulates and writes them, so no barrier guards them.
  for (int r = warp; r < rows; r += WARPS) acc[r * TF + lane] = 0.f;

  const long long s0 = (long long)win_subs[2 * win] * chunk;
  const long long s_end = s0 + (long long)win_subs[2 * win + 1] * chunk;
  for (long long p0 = s0; p0 < s_end; p0 += PIECE) {
    __syncthreads();  // every warp is done with the previous piece
    const long long i = p0 + tid;
    int send = -1, row = 0;
    float wv = 0.f;
    if (i < s_end) {
      const int s = slot_sender[i];
      const int rl = r_loc[i];
      if (s >= 0 && s < num_senders && rl >= 0 && rl < rows) {
        send = s;
        row = rl;
        wv = w_slots[i];
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
          if (js[u] < 0) continue;
          const float w = st_w[js[u]];
          const float m = bf16 ? __fmul_rn(round_bf16(w), round_bf16(xv[u]))
                               : __fmul_rn(w, xv[u]);
          acc[st_row[js[u]] * TF + lane] += m;
        }
      }
    }
  }
  if (col_ok) {
    float* o = out + (size_t)row0 * F + f;
    for (int r = warp; r < rows; r += WARPS) o[(size_t)r * F] = acc[r * TF + lane];
  }
}

__global__ void __launch_bounds__(THREADS)
stream_scatter_mat_kernel(const int* __restrict__ slot_sender,
                          const int* __restrict__ win_subs,
                          const __nv_bfloat16* __restrict__ oh,
                          const float* __restrict__ x, float* __restrict__ out,
                          int chunk, int tr_w, int num_senders,
                          int num_receivers, int F) {
  extern __shared__ float smem[];
  float* acc = smem;  // tr_w x TF
  // MAT_PIECE rows of tr_w one-hot entries, row stride tr_w + OH_PAD
  __nv_bfloat16* oh_s = reinterpret_cast<__nv_bfloat16*>(smem + tr_w * TF);
  __shared__ int st_send[MAT_PIECE];  // sender row, -1 = padding
  const int stride = tr_w + OH_PAD;

  const int win = blockIdx.x;
  const int row0 = win * tr_w;
  const int rows = min(tr_w, num_receivers - row0);
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int f = blockIdx.y * TF + lane;
  const bool col_ok = f < F;

  for (int r = warp; r < rows; r += WARPS) acc[r * TF + lane] = 0.f;

  const long long s0 = (long long)win_subs[2 * win] * chunk;
  const long long s_end = s0 + (long long)win_subs[2 * win + 1] * chunk;
  for (long long p0 = s0; p0 < s_end; p0 += MAT_PIECE) {
    __syncthreads();
    const int n = (int)min((long long)MAT_PIECE, s_end - p0);
    // the piece's one-hot rows are contiguous: copy them as 32-bit words
    // (tr_w is a multiple of 8, so every row starts 16-byte aligned)
    const unsigned* src = reinterpret_cast<const unsigned*>(oh + p0 * tr_w);
    unsigned* dst = reinterpret_cast<unsigned*>(oh_s);
    const int row_words = tr_w / 2;
    const int words = n * row_words;
    for (int k = tid; k < words; k += THREADS) {
      dst[(k / row_words) * (stride / 2) + k % row_words] = src[k];
    }
    if (tid < n) {
      const int s = slot_sender[p0 + tid];
      st_send[tid] = (s >= 0 && s < num_senders) ? s : -1;
    }
    __syncthreads();
    for (int k = 0; k < n; k += 32) {
      // bit q: this warp's row warp + q * WARPS of slot k + lane is non-zero
      unsigned bits = 0;
      if (k + lane < n) {
        const __nv_bfloat16* row = oh_s + (k + lane) * stride;
        for (int q = 0, r = warp; r < rows; ++q, r += WARPS) {
          if (__bfloat162float(row[r]) != 0.f) bits |= 1u << q;
        }
      }
      unsigned mask = __ballot_sync(FULL, bits != 0);  // in slot order
      while (mask) {
        int js[BATCH];
        unsigned rbits[BATCH];
        float xv[BATCH];
#pragma unroll
        for (int u = 0; u < BATCH; ++u) {
          js[u] = mask ? __ffs(mask) - 1 : -1;
          mask &= mask - 1;
        }
#pragma unroll
        for (int u = 0; u < BATCH; ++u) {
          rbits[u] = __shfl_sync(FULL, bits, js[u] >= 0 ? js[u] : 0);
          const int s = js[u] >= 0 ? st_send[k + js[u]] : -1;
          xv[u] = (s >= 0 && col_ok) ? round_bf16(x[(size_t)s * F + f]) : 0.f;
        }
#pragma unroll
        for (int u = 0; u < BATCH; ++u) {
          if (js[u] < 0) continue;
          const __nv_bfloat16* row = oh_s + (k + js[u]) * stride;
          for (unsigned b = rbits[u]; b; b &= b - 1) {
            const int r = warp + (__ffs(b) - 1) * WARPS;
            acc[r * TF + lane] += __fmul_rn(__bfloat162float(row[r]), xv[u]);
          }
        }
      }
    }
  }
  if (col_ok) {
    float* o = out + (size_t)row0 * F + f;
    for (int r = warp; r < rows; r += WARPS) o[(size_t)r * F] = acc[r * TF + lane];
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

int check_window(int tr_w) {
  return (tr_w <= 0 || tr_w > MAX_TR_W || tr_w % 8) ? (int)cudaErrorInvalidValue : 0;
}

}  // namespace

extern "C" {

// out [num_receivers, F] = the structure's sparse matrix (weights w_slots,
// slot order) times x [num_senders, F].  n_windows = ceil(num_receivers /
// tr_w) rows of win_subs.  Launches on `stream` (a cudaStream_t); returns the
// cudaError_t of the launch (0 on success).  Does not synchronise and
// allocates nothing.
int kgcn_stream_scatter(const int* slot_sender, const int* r_loc,
                        const int* win_subs, const float* w_slots,
                        const float* x, float* out, int n_windows, int chunk,
                        int tr_w, int num_senders, int num_receivers, int F,
                        int bf16, void* stream) {
  if (int e = check_window(tr_w)) return e;
  dim3 grid(n_windows, (F + TF - 1) / TF);
  const size_t smem = (size_t)tr_w * TF * sizeof(float);
  stream_scatter_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      slot_sender, r_loc, win_subs, w_slots, x, out, chunk, tr_w, num_senders,
      num_receivers, F, bf16);
  return (int)cudaGetLastError();
}

// out [num_receivers, F] = per receiver window, oh[window slots]^T times
// bf16(x[slot_sender]); oh [slots, tr_w] bfloat16.  Same conventions.
int kgcn_stream_scatter_mat(const int* slot_sender, const int* win_subs,
                            const void* oh, const float* x, float* out,
                            int n_windows, int chunk, int tr_w,
                            int num_senders, int num_receivers, int F,
                            void* stream) {
  if (int e = check_window(tr_w)) return e;
  dim3 grid(n_windows, (F + TF - 1) / TF);
  const size_t smem = (size_t)tr_w * TF * sizeof(float) +
                      (size_t)MAT_PIECE * (tr_w + OH_PAD) * sizeof(__nv_bfloat16);
  if (smem + MAT_PIECE * sizeof(int) > STATIC_SMEM_LIMIT) {
    const cudaError_t e = cudaFuncSetAttribute(
        stream_scatter_mat_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  stream_scatter_mat_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      slot_sender, win_subs, static_cast<const __nv_bfloat16*>(oh), x, out,
      chunk, tr_w, num_senders, num_receivers, F);
  return (int)cudaGetLastError();
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
