// Fused multi-channel dense graph convolution for Hopper (sm_90a), float32.
//
//   out[b] = sum_c A[c, b] @ (X[b] @ W[c] + bias[c])
//   adj [C, B, N, N], x [B, N, Fin], w [C, Fin, Fout], bias [C, Fout]
//   -> out [B, N, Fout], all row-major and contiguous.
//
// Replaces the Pallas TPU kernel `_gconv_kernel`
// (kgcn_tpu/ops/pallas_gconv.py:33, launched by `_gconv_call`).  Like it, the
// channel loop runs inside the block and the per-channel product X W_c stays
// on chip (shared memory here, VMEM there); it never goes to device memory.
//
// What bounds it: at the serving path's shape (C=1, B=32, N=47, Fin 81->50,
// Fout=50) one call moves ~1.1 MB and does ~19 MFLOP, i.e. ~0.3 us of HBM
// traffic at 3.35 TB/s and ~0.3 us of FP32 work at 67 TFLOP/s.  Both are far
// below the ~few-us cost of a launch, so the kernel is launch-bound.  The
// design therefore does the whole layer in ONE launch (no intermediate
// tensor, no second kernel for the bias or the channel sum) and keeps the
// block simple: plain FP32 FMAs, no tensor cores, no TMA.
//
// Design:
//   * one block of 8 warps per (Fout tile of TF = 32 columns, row tile of
//     TN = 32 rows, graph b): 128 blocks at the path shape;
//   * for each channel c the block builds HW_c = X_b W_c[:, tile] + bias_c
//     for ALL N rows in shared memory, Fin in chunks of KC = 32: each chunk
//     of X_b and W_c is staged with coalesced loads, then every thread adds
//     the chunk's products for one column and 8 rows (one W read from shared
//     memory feeds 8 independent FMAs; the X reads are one address per warp);
//   * the row tile A_c[b, rows, :] is staged beside it; after a barrier each
//     thread accumulates 4 rows of one output column in registers over the
//     N-term contraction, then the next channel;
//   * the tile is written once.  Ragged N, Fin and Fout edges are masked
//     here, so unlike the TPU wrapper nothing is padded to 128 lanes.
//   Shared memory: (N*TF + TN*N + N*KC + KC*TF) floats, 100 KB at N = 256,
//   so the launch raises cudaFuncAttributeMaxDynamicSharedMemorySize above
//   the 48 KB default.
#include <cuda_runtime.h>

namespace {

constexpr int TN = 32;                          // output rows per block
constexpr int TF = 32;                          // output columns per block
constexpr int KC = 32;                          // Fin chunk staged per step
constexpr int THREADS = 256;
constexpr int ROW_GROUPS = THREADS / TF;        // 8: one warp per row group
constexpr int ACC_ROWS = TN / ROW_GROUPS;       // 4 output rows a thread
constexpr int HW_ROWS = 8;                      // HW rows a thread per pass

__global__ void __launch_bounds__(THREADS)
gconv_f32_kernel(const float* __restrict__ adj, const float* __restrict__ x,
                 const float* __restrict__ w, const float* __restrict__ bias,
                 float* __restrict__ out, int C, int B, int N, int Fin,
                 int Fout) {
  extern __shared__ float smem[];
  float* hw = smem;                // [N][TF]: X_b W_c + bias_c, this tile
  float* a_tile = hw + N * TF;     // [TN][N]: A_c[b, r0:r0+TN, :]
  float* xs = a_tile + TN * N;     // [N][KC]: X_b[:, k0:k0+KC]
  float* ws = xs + N * KC;         // [KC][TF]: W_c[k0:k0+KC, tile]

  const int f0 = blockIdx.x * TF;
  const int r0 = blockIdx.y * TN;
  const int g = blockIdx.z;
  const int tid = threadIdx.x;
  const int col = tid % TF;
  const int rgrp = tid / TF;
  const float* xg = x + (size_t)g * N * Fin;

  float acc[ACC_ROWS];
#pragma unroll
  for (int j = 0; j < ACC_ROWS; ++j) acc[j] = 0.f;

  for (int c = 0; c < C; ++c) {
    const float* wc = w + (size_t)c * Fin * Fout;
    // Thread (rgrp, col) owns HW rows rgrp, rgrp + 8, ... of its column in
    // every pass below, so it alone writes them: no barrier between passes.
    const float bc = (f0 + col < Fout) ? bias[(size_t)c * Fout + f0 + col] : 0.f;
    for (int n = rgrp; n < N; n += ROW_GROUPS) hw[n * TF + col] = bc;

    const float* ag = adj + ((size_t)c * B + g) * N * N;
    for (int i = tid; i < TN * N; i += THREADS) {
      const int r = i / N;
      const int m = i % N;
      a_tile[i] = (r0 + r < N) ? ag[(size_t)(r0 + r) * N + m] : 0.f;
    }

    for (int k0 = 0; k0 < Fin; k0 += KC) {
      __syncthreads();  // the previous chunk's readers are done with xs, ws
      for (int i = tid; i < N * KC; i += THREADS) {
        const int n = i / KC;
        const int k = k0 + i % KC;
        xs[i] = (k < Fin) ? xg[(size_t)n * Fin + k] : 0.f;
      }
      for (int i = tid; i < KC * TF; i += THREADS) {
        const int k = k0 + i / TF;
        const int f = f0 + i % TF;
        ws[i] = (k < Fin && f < Fout) ? wc[(size_t)k * Fout + f] : 0.f;
      }
      __syncthreads();
      for (int n0 = rgrp; n0 < N; n0 += ROW_GROUPS * HW_ROWS) {
        int xo[HW_ROWS];  // rows past N read row N-1 and are not stored
        float h[HW_ROWS];
#pragma unroll
        for (int j = 0; j < HW_ROWS; ++j) {
          xo[j] = min(n0 + j * ROW_GROUPS, N - 1) * KC;
          h[j] = 0.f;
        }
#pragma unroll 8
        for (int k = 0; k < KC; ++k) {
          const float wv = ws[k * TF + col];
#pragma unroll
          for (int j = 0; j < HW_ROWS; ++j) h[j] = fmaf(xs[xo[j] + k], wv, h[j]);
        }
#pragma unroll
        for (int j = 0; j < HW_ROWS; ++j) {
          const int n = n0 + j * ROW_GROUPS;
          if (n < N) hw[n * TF + col] += h[j];
        }
      }
    }
    __syncthreads();  // HW_c and the adjacency tile are complete

    // acc[j] += sum_m A[r0 + rgrp + 8j, m] * HW[m, col].  Within a warp the
    // A read is one address (broadcast) and the HW read 32 distinct banks.
    for (int m = 0; m < N; ++m) {
      const float hv = hw[m * TF + col];
#pragma unroll
      for (int j = 0; j < ACC_ROWS; ++j)
        acc[j] = fmaf(a_tile[(rgrp + j * ROW_GROUPS) * N + m], hv, acc[j]);
    }
    __syncthreads();  // the next channel overwrites hw and a_tile
  }

  const int f = f0 + col;
  if (f >= Fout) return;
#pragma unroll
  for (int j = 0; j < ACC_ROWS; ++j) {
    const int r = r0 + rgrp + j * ROW_GROUPS;
    if (r < N) out[((size_t)g * N + r) * Fout + f] = acc[j];
  }
}

int configured_smem = 48 * 1024;  // the default every kernel may use

}  // namespace

extern "C" {

// Dynamic shared memory the kernel needs for N nodes, in bytes.
long long kgcn_gconv_f32_smem_bytes(int N) {
  return (long long)(N * TF + TN * N + N * KC + KC * TF) * (long long)sizeof(float);
}

// Launches on `stream` (a cudaStream_t) and returns the cudaError_t of the
// launch: 0 on success.  Does not synchronise and allocates nothing.
int kgcn_gconv_f32(const float* adj, const float* x, const float* w,
                   const float* bias, float* out, int C, int B, int N,
                   int Fin, int Fout, void* stream) {
  const int smem = (int)kgcn_gconv_f32_smem_bytes(N);
  if (smem > configured_smem) {
    cudaError_t e = cudaFuncSetAttribute(
        gconv_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    configured_smem = smem;
  }
  dim3 grid((Fout + TF - 1) / TF, (N + TN - 1) / TN, B);
  gconv_f32_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      adj, x, w, bias, out, C, B, N, Fin, Fout);
  return (int)cudaGetLastError();
}

const char* kgcn_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
