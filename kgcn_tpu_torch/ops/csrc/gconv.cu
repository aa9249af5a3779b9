// Fused multi-channel dense graph convolution for Hopper (sm_90a), float32
// (kgcn_gconv_f32) and bf16 (kgcn_gconv_bf16).
//
//   out[b] = sum_c A[c, b] @ (X[b] @ W[c] + bias[c])
//   adj [C, B, N, N], x [B, N, Fin], w [C, Fin, Fout], bias [C, Fout]
//   -> out [B, N, Fout], all row-major and contiguous, all of one type.
//
// Replaces the Pallas TPU kernel `_gconv_kernel`
// (kgcn_tpu/ops/pallas_gconv.py:33, launched by `_gconv_call`), which keeps
// one graph's X W_c in VMEM while it aggregates.
//
// ---- float32 (kgcn_gconv_f32) ----
//
// Arithmetic: plain FP32 FMAs, no tensor cores and no TF32.  The JAX
// reference runs its einsums at `highest` precision, and the port's parity
// tolerances (1e-4 on the card, 1e-5 on the CPU) assume full f32 products.
//
// What bounds it: FLOP.  At the reaction-scale batch (C 3, B 128, N 203,
// Fin 81, Fout 128) one call does 5.7 GFLOP (1.6 projection, 4.1
// aggregation) against ~0.17 GB of traffic: 0.085 ms at 67 TFLOP/s FP32
// against 0.05 ms at 3.35 TB/s.  At the serving path's shapes (C 1, B 32,
// N 47) it is a few microseconds of launch and load latency.
//
// Two designs, chosen by shape in kgcn_gconv_f32:
//
// Small graphs (N <= 64, and X_b, W_c's column tile, A_c,b and HW_c of one
// graph within 48 KB of shared memory; the serving and training path's
// molecules, N 47): ONE launch, a block of 16 warps per (graph, 32 output
// columns), 4 rows a thread.  It stages X_b once and, per channel, W_c's columns and A_c,b,
// computes HW_c = X_b W_c + b_c for all N rows into shared memory, then
// adds A_c,b HW_c to its accumulators; the channel loop runs inside the
// block, as in the TPU kernel.  Each lane owns one column, each warp rows
// warp, warp + 16, ...: shared reads are a broadcast (X, A) and 32 distinct
// banks (W, HW), and 16-byte reads along the contraction feed 4 FMAs of up
// to 4 rows.  At these shapes a call is a few microseconds of load latency
// and of short instruction streams on a few warps per SM, so one launch,
// every operand staged in one round of loads, and 16 warps a block to
// split the work beat two launches.  Blocks walk (graph, column tile) in a
// grid-stride loop, so no number of graphs is refused.
//
// Larger graphs: two launches of one batched GEMM kernel.
//   1. projection: HW[c] = X W_c + bias_c for every graph at once, X read
//      as one [B*N, Fin] matrix, written to a scratch [C, B, N, Fout] that
//      the wrapper allocates.  X W_c is computed once per (graph, channel,
//      column), never again per row tile;
//   2. aggregation: out[b] = sum_c A[c, b] HW[c, b], a contraction over the
//      C*N terms of (channel, node), channels in order.
// The GEMM streams its contraction through shared memory in chunks of BK
// terms, double-buffered (the next chunk is loaded into registers while
// the current one is multiplied), so shared memory is fixed (17 KB) and
// no size of N or B is refused.  Each thread holds a TM x TN register tile
// of outputs (4x4 or 8x8, each as 4-wide runs read with 16-byte shared
// loads).  Ragged M, N and K edges are masked: nothing is padded in memory.
// Its launch shape is chosen per GEMM by size: 128x128 tiles with 8x8 per
// thread where that gives at least one tile per SM (the reaction-scale
// batch: 609 projection and 256 aggregation tiles), else 32x64 tiles with
// 4x4 per thread and a deeper chunk (BK 16), which spread a mid-sized
// problem (N 600 and 1024 in chip_smoke.py: 128-256 blocks) over the SMs.
// On the H100, 64x64 tiles were slower at N 1024 (half the SMs busy), and
// 128x128 tiles with BK 16 (spills) or above 128 registers (one block an
// SM) slower at reaction scale.  Where the small tiles still number fewer
// than four blocks an SM, their (channel, term) steps are cut into 2-8
// runs (split_count), each run summed by its own block into a partial
// output in the scratch, and a third launch adds the runs in order.
//
// Every output is a sum in one fixed order (one FMA per term; with runs,
// the runs' sums added in run order), so two launches give the same bits.
// Every kernel walks its blocks in a grid-stride loop, so B is not bounded
// by a grid dimension.  chip_smoke.py phase 3 runs every launch shape.
//
// ---- bf16 (kgcn_gconv_bf16): tensor cores ----
//
// What `_gconv_kernel` computes on bf16 refs (pallas_gconv.py:33-53): X W_c
// summed in f32 and b_c added in f32, that projection P kept to f32
// precision, A_c P summed in f32 over the channels in order, the output
// rounded to bf16 once.  Both products run on the tensor cores: mma.sync
// m16n8k16 bf16 with f32 accumulators, operands read from shared memory by
// ldmatrix, tiles staged by cp.async along each contraction.  The f32
// kernels above share none of this code.
//
// X W_c is exact per product (bf16 x bf16 fits f32).  The aggregation
// multiplies bf16 A by the f32 P: each value p is split into three bf16
// terms, hi = bf16(p), lo = bf16(p - hi), lo2 = bf16(p - hi - lo), which
// hold p exactly, and A P is summed as A hi + A lo + A lo2 into the same f32
// accumulators.  With two terms 2^-16 of p per term is lost, which puts
// outputs that cancel (|A P| far below sum |A| |P|) outside one bf16
// rounding of the f64 sum (tests/test_torch_precision.py shows it at the
// serving shape); with three the sums are as good as f32 ones.
//
// Graphs of up to 256 nodes (runtime/backend.DENSE_MAX_NODES: every graph
// the dense backend takes): ONE launch of gconv_tc_fused.  A block of 16
// warps owns a tile of 64 output columns of G graphs (G graphs of N rounded
// up to 16 rows, at most 256 rows; G > 1 only where the graphs outnumber
// two blocks an SM even so, e.g. 70 000 graphs of 8 nodes) and runs the
// channels inside, as the TPU kernel does:
//   1. P = X W_c[:, tile] + b_c for all its rows, X's rows and W_c's tile
//      streamed through shared memory in stages of 32-96 terms; P is split
//      into its three terms once, into three bf16 planes in shared memory
//      (108 KB at 256 rows: 6 bytes a value where an f32 takes 4), and never
//      goes to device memory;
//   2. acc += A_c P, A_c's rows streamed in stages of 32-64 terms, each
//      graph's rows against its own rows of the planes; a warp's 24
//      products of a 16-term step are ordered so that 8 accumulators lie
//      between two that depend on each other.
// Three stages are in flight (cp.async groups).  Warps split the rows 4
// ways (m16 tiles w, w + 4, ...) and the columns 4 ways (16 each): 32 f32
// accumulators a thread, and as many for P.  Rows whose length is not a
// multiple of 8 terms (N, Fin or Fout 203, 81, 47, 50, ...) are not 16-byte
// aligned: the aligned 16-byte pieces that cover such a row are copied and
// the row is shifted into place in shared memory (REALIGN); each operand's
// way is a template parameter, so the kernel has 8 instances.  The
// tensors must start on 16-byte boundaries (the wrapper copies a view that
// does not).  Shared memory is at most 227 KB: one block an SM; blocks walk
// (graph group, column tile) in a grid-stride loop, so no B is refused.
//
// Larger graphs: two launches of gconv_tc_gemm, 128 x 64 tiles of 8 warps:
// the projection X W_c + b_c for every graph at once into an f32 scratch
// [C, B, N, Fout] that the wrapper allocates (the bytes of a hi + lo pair a
// value), then the aggregation over it, each scratch value split into its
// three terms as its mma fragment is built.  Where the aggregation's blocks
// are few, its (channel, term) steps are cut into runs, each summed into a
// partial output in the scratch, and a third launch (sum_splits) adds them
// in run order.  No N and no B is refused.
//
// What bounds it: bytes at the reaction-scale batch (0.0127 ms of bf16
// traffic against 0.0058 ms of its FLOP at 989 TFLOP/s), but the kernel
// issues the aggregation's products three times on mma.sync, which reaches
// about half of the tensor cores' rate, and copies each graph's A and X
// once for every 64 output columns: at N 256 it is bound by the tensor
// cores and the copies.
//
// Every output is a sum in one fixed order (the mma k-steps in order, the
// three terms in order within a step, channels in order, runs in run
// order); nothing is added atomically, so two launches give the same bits.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>

namespace {

// an operand element, widened to f32 (read-only path)
__device__ __forceinline__ float ld(const float* p) { return __ldg(p); }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) {
  return __bfloat162float(
      __ushort_as_bfloat16(__ldg(reinterpret_cast<const unsigned short*>(p))));
}
// an output element, rounded once to its type
__device__ __forceinline__ void st(float* p, float v) { *p = v; }
__device__ __forceinline__ void st(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

constexpr int SMS = 132;                  // H100 SXM
constexpr long long MAX_GRID = 1 << 20;   // blocks a launch asks for at most

// One batched GEMM: for z < batch,
//   out_z[m, n] = sum_{c < nsum} sum_{k < K} A_zc[m, k] B_zc[k, n] (+ bias_z[n])
// with A_zc = a + z a_z + c a_c (row-major, leading dimension lda) and
// B_zc = b + z b_z + c b_c (row-major, ldb); out_z = out + z out_z (ldo).
// A is read as TA, B and the bias as TB, and out written as TO; the sums
// are f32.
template <typename TA, typename TB, typename TO>
struct Gemm {
  const TA* a;
  const TB* b;
  const TB* bias;  // nullptr: none
  TO* out;
  long long a_z, a_c, b_z, b_c, out_z, bias_z, batch, M;
  int N, K, nsum, lda, ldb, ldo;
};

// SPLIT: the (channel, term) steps are cut into `splits` runs, each summed
// by its own block into part[split] (laid out as out, with ldo = N and
// out_z = M N), and sum_splits adds the runs in order.  Off, part and
// splits are unused and the kernel keeps the registers of one run.
template <typename TA, typename TB, typename TO, int BM, int BN, int BK, int TM, int TN,
          bool SPLIT>
__global__ void __launch_bounds__((BM / TM) * (BN / TN), 2)  // <= 128 registers
gemm_kernel(const Gemm<TA, TB, TO> g, float* __restrict__ part, int splits_) {
  constexpr int THREADS = (BM / TM) * (BN / TN);
  constexpr int TX = BN / TN;                 // threads along a row of the tile
  constexpr int GM = TM / 4, GN = TN / 4;     // 4-wide runs per thread
  constexpr int A_LOADS = BM * BK / THREADS;  // chunk elements a thread stages
  constexpr int B_LOADS = BK * BN / THREADS;
  constexpr int AP = BM + 4;  // padded rows: the transposed stores spread over banks
  static_assert(A_LOADS * THREADS == BM * BK && B_LOADS * THREADS == BK * BN, "");
  __shared__ __align__(16) float as[2][BK][AP];  // A chunk, transposed: [k][m]
  __shared__ __align__(16) float bs[2][BK][BN];  // B chunk: [k][n]

  const int tid = threadIdx.x;
  const int tx = tid % TX, ty = tid / TX;
  const int tiles_n = (g.N + BN - 1) / BN;
  const long long tiles = (g.M + BM - 1) / BM * tiles_n;
  const int k_tiles = (g.K + BK - 1) / BK;
  const int all_steps = g.nsum * k_tiles;

  const int splits = SPLIT ? splits_ : 1;
  for (long long blk = blockIdx.x; blk < g.batch * tiles * splits; blk += gridDim.x) {
    const int split = SPLIT ? (int)(blk % splits) : 0;
    const long long zt = SPLIT ? blk / splits : blk;
    const long long z = zt / tiles;
    const long long t = zt % tiles;
    // this block's run of (channel, term) steps
    const int first = SPLIT ? (int)((long long)all_steps * split / splits) : 0;
    const int steps =
        SPLIT ? (int)((long long)all_steps * (split + 1) / splits) - first : all_steps;
    const long long m0 = t / tiles_n * BM;
    const int n0 = (int)(t % tiles_n) * BN;
    float acc[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
    float ra[A_LOADS], rb[B_LOADS];

    // chunk `step` = (channel c, terms k0..k0+BK) into registers, 0 outside
    auto fetch = [&](int step) {
      const int c = step / k_tiles;
      const int k0 = (step - c * k_tiles) * BK;
      const TA* a = g.a + z * g.a_z + c * g.a_c;
      const TB* b = g.b + z * g.b_z + c * g.b_c;
#pragma unroll
      for (int j = 0; j < A_LOADS; ++j) {
        const int i = tid + j * THREADS;
        const long long m = m0 + i / BK;
        const int k = k0 + i % BK;
        ra[j] = (m < g.M && k < g.K) ? ld(a + m * g.lda + k) : 0.f;
      }
#pragma unroll
      for (int j = 0; j < B_LOADS; ++j) {
        const int i = tid + j * THREADS;
        const int k = k0 + i / BN, n = n0 + i % BN;
        rb[j] = (k < g.K && n < g.N) ? ld(b + (size_t)k * g.ldb + n) : 0.f;
      }
    };
    auto stash = [&](int buf) {
#pragma unroll
      for (int j = 0; j < A_LOADS; ++j) {
        const int i = tid + j * THREADS;
        as[buf][i % BK][i / BK] = ra[j];
      }
#pragma unroll
      for (int j = 0; j < B_LOADS; ++j) {
        const int i = tid + j * THREADS;
        bs[buf][i / BN][i % BN] = rb[j];
      }
    };

    if (steps > 0) {
      fetch(first);
      stash(0);
    }
    __syncthreads();
    for (int s = 0; s < steps; ++s) {
      const int buf = s & 1;
      if (s + 1 < steps) fetch(first + s + 1);  // in flight while this chunk is used
#pragma unroll
      for (int k = 0; k < BK; ++k) {
        float av[TM], bv[TN];
#pragma unroll
        for (int gi = 0; gi < GM; ++gi) {
          const float4 v =
              *reinterpret_cast<const float4*>(&as[buf][k][gi * (BM / GM) + ty * 4]);
          av[4 * gi] = v.x; av[4 * gi + 1] = v.y; av[4 * gi + 2] = v.z; av[4 * gi + 3] = v.w;
        }
#pragma unroll
        for (int gj = 0; gj < GN; ++gj) {
          const float4 v =
              *reinterpret_cast<const float4*>(&bs[buf][k][gj * (BN / GN) + tx * 4]);
          bv[4 * gj] = v.x; bv[4 * gj + 1] = v.y; bv[4 * gj + 2] = v.z; bv[4 * gj + 3] = v.w;
        }
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
      // the other buffer was last read in step s - 1, before its barrier
      if (s + 1 < steps) stash(buf ^ 1);
      __syncthreads();
    }

    // one run: the output (+ bias), rounded to TO; runs: f32 partials
    const TB* bias = splits == 1 && g.bias ? g.bias + z * g.bias_z : nullptr;
    TO* o = g.out + z * g.out_z;
    float* po = splits == 1 ? nullptr : part + ((long long)split * g.batch + z) * g.M * g.N;
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const long long m = m0 + (i / 4) * (BM / GM) + ty * 4 + i % 4;
      if (m >= g.M) continue;
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int n = n0 + (j / 4) * (BN / GN) + tx * 4 + j % 4;
        if (n >= g.N) continue;
        if (splits == 1)
          st(o + m * g.ldo + n, bias ? acc[i][j] + ld(bias + n) : acc[i][j]);
        else
          po[m * g.ldo + n] = acc[i][j];
      }
    }
  }
}

constexpr int SG_TF = 32;                 // output columns per block: one a lane
constexpr int SG_ROWS = 4;                // rows a thread holds, at most
constexpr int SG_MAX_N = 64;              // rows a block holds (16 warps)
constexpr int SG_SMEM = 48 * 1024;        // shared memory a launch may ask without opting in

__host__ __device__ inline int round4(int v) { return (v + 3) / 4 * 4; }

// floats of shared memory the small-graph kernel needs: X_b [N][XS],
// W_c's tile [XS][32], A_c,b [N][AS] and HW_c [AS][32], rows padded to 4
inline long long small_graph_floats(int N, int Fin) {
  const long long XS = round4(Fin), AS = round4(N);
  return N * XS + XS * SG_TF + N * AS + AS * SG_TF;
}

constexpr int SG_WARPS = SG_MAX_N / SG_ROWS;  // one a row group

template <typename T>
__global__ void __launch_bounds__(SG_WARPS * 32)
small_graph_kernel(const T* __restrict__ adj, const T* __restrict__ x,
                   const T* __restrict__ w, const T* __restrict__ bias,
                   T* __restrict__ out, int C, int B, int N, int Fin, int Fout) {
  extern __shared__ float4 smem4[];
  const int XS = round4(Fin), AS = round4(N);
  float* xs = reinterpret_cast<float*>(smem4);  // [N][XS]: X_b, zero past Fin
  float* ws = xs + N * XS;                       // [XS][32]: W_c[:, tile], zero past Fin
  float* as = ws + XS * SG_TF;                   // [N][AS]: A_c,b, zero past N
  float* hs = as + N * AS;                       // [AS][32]: HW_c, zero past N
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int tiles = (Fout + SG_TF - 1) / SG_TF;

  for (long long blk = blockIdx.x; blk < (long long)B * tiles; blk += gridDim.x) {
    const long long b = blk / tiles;
    const int f = (int)(blk % tiles) * SG_TF + lane;  // this lane's column
    float acc[SG_ROWS];
#pragma unroll
    for (int i = 0; i < SG_ROWS; ++i) acc[i] = 0.f;
    __syncthreads();  // the previous graph's readers are done
    // rows by warp, columns by lane: coalesced, no index division
    const T* xb = x + b * N * Fin;
    for (int r = warp; r < N; r += SG_WARPS)
      for (int k = lane; k < XS; k += 32) xs[r * XS + k] = k < Fin ? ld(xb + r * Fin + k) : 0.f;
    for (int r = N + warp; r < AS; r += SG_WARPS) hs[r * SG_TF + lane] = 0.f;

    for (int c = 0; c < C; ++c) {
      const T* wc = w + (size_t)c * Fin * Fout;
      const T* ac = adj + ((size_t)c * B + b) * N * N;
      for (int k = warp; k < XS; k += SG_WARPS)
        ws[k * SG_TF + lane] = (k < Fin && f < Fout) ? ld(wc + (size_t)k * Fout + f) : 0.f;
      for (int r = warp; r < N; r += SG_WARPS)
        for (int m = lane; m < AS; m += 32) as[r * AS + m] = m < N ? ld(ac + r * N + m) : 0.f;
      const float bc = f < Fout ? ld(bias + (size_t)c * Fout + f) : 0.f;
      __syncthreads();

      // HW_c rows warp + SG_WARPS i of this column: X_b W_c, then + b_c
      float h[SG_ROWS];
#pragma unroll
      for (int i = 0; i < SG_ROWS; ++i) h[i] = 0.f;
      for (int k = 0; k < XS; k += 4) {
        float wv[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) wv[u] = ws[(k + u) * SG_TF + lane];
#pragma unroll
        for (int i = 0; i < SG_ROWS; ++i) {
          const int r = warp + i * SG_WARPS;  // the same in the whole warp
          if (r < N) {
            const float4 v = *reinterpret_cast<const float4*>(xs + r * XS + k);
            h[i] = fmaf(v.x, wv[0], h[i]);
            h[i] = fmaf(v.y, wv[1], h[i]);
            h[i] = fmaf(v.z, wv[2], h[i]);
            h[i] = fmaf(v.w, wv[3], h[i]);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < SG_ROWS; ++i) {
        const int r = warp + i * SG_WARPS;
        if (r < N) hs[r * SG_TF + lane] = h[i] + bc;
      }
      __syncthreads();

      // acc += A_c,b HW_c, the N terms in order
      for (int m = 0; m < AS; m += 4) {
        float hv[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) hv[u] = hs[(m + u) * SG_TF + lane];
#pragma unroll
        for (int i = 0; i < SG_ROWS; ++i) {
          const int r = warp + i * SG_WARPS;
          if (r < N) {
            const float4 v = *reinterpret_cast<const float4*>(as + r * AS + m);
            acc[i] = fmaf(v.x, hv[0], acc[i]);
            acc[i] = fmaf(v.y, hv[1], acc[i]);
            acc[i] = fmaf(v.z, hv[2], acc[i]);
            acc[i] = fmaf(v.w, hv[3], acc[i]);
          }
        }
      }
      __syncthreads();  // the next channel overwrites ws, as and hs
    }
    if (f < Fout) {
#pragma unroll
      for (int i = 0; i < SG_ROWS; ++i) {
        const int r = warp + i * SG_WARPS;
        if (r < N) st(out + (b * N + r) * Fout + f, acc[i]);
      }
    }
  }
}

// out = the runs of part added in split order (+ bias), element by element,
// rounded to TO: total = batch * M * N outputs, out_z = M * N
template <typename TB, typename TO>
__global__ void __launch_bounds__(256)
sum_splits(const float* __restrict__ part, const TB* __restrict__ bias,
           TO* __restrict__ out, long long total, long long out_z, long long bias_z,
           int N, int splits) {
  for (long long i = blockIdx.x * 256LL + threadIdx.x; i < total;
       i += (long long)gridDim.x * 256) {
    float v = __ldg(part + i);
    for (int sp = 1; sp < splits; ++sp) v += __ldg(part + sp * total + i);
    if (bias) v += ld(bias + i / out_z * bias_z + i % N);
    st(out + i, v);
  }
}

// launched: incremented once for each kernel launched
template <int BM, int BN, int BK, int TM, int TN, bool SPLIT, typename TA, typename TB,
          typename TO>
cudaError_t launch(const Gemm<TA, TB, TO>& g, float* part, int splits, cudaStream_t stream,
                   int* launched) {
  const long long blocks =
      g.batch * ((g.M + BM - 1) / BM) * ((g.N + BN - 1) / BN) * splits;
  if (blocks == 0) return cudaSuccess;
  const unsigned grid = (unsigned)(blocks < MAX_GRID ? blocks : MAX_GRID);
  gemm_kernel<TA, TB, TO, BM, BN, BK, TM, TN, SPLIT><<<grid, (BM / TM) * (BN / TN), 0, stream>>>(
      g, part, splits);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  ++*launched;
  if (splits == 1) return e;
  const long long total = g.batch * g.M * g.N;
  const long long sum_blocks = (total + 255) / 256;
  sum_splits<TB, TO><<<(unsigned)(sum_blocks < MAX_GRID ? sum_blocks : MAX_GRID), 256, 0,
                        stream>>>(
      part, g.bias, g.out, total, g.M * g.N, g.bias_z, g.N, splits);
  e = cudaGetLastError();
  if (e == cudaSuccess) ++*launched;
  return e;
}

template <typename G>
bool large_tiles(const G& g) {
  return g.batch * ((g.M + 127) / 128) * ((g.N + 127) / 128) >= SMS;
}

// Runs the small tiles' steps are cut into: doubled, up to 8, while the
// blocks number fewer than four an SM and each run keeps 8 steps or more.
// A mid-sized GEMM (N 600 and 1024 in chip_smoke.py: 128-152 blocks of 4
// warps, 38-128 steps of 16 terms) is otherwise a chain of dependent loads
// on a few warps an SM.
template <typename G>
int split_count(const G& g) {
  if (large_tiles(g)) return 1;
  const long long blocks = g.batch * ((g.M + 31) / 32) * ((g.N + 63) / 64);
  const int steps = g.nsum * ((g.K + 15) / 16);
  int splits = 1;
  while (splits < 8 && blocks * splits < 4 * SMS && steps / (2 * splits) >= 8) splits *= 2;
  return splits;
}

// the launch shape by size: large tiles once they fill every SM, else small
// ones, their steps cut into runs where the blocks are few (split_count);
// part: room for the runs' partial outputs
template <typename TA, typename TB, typename TO>
cudaError_t run(const Gemm<TA, TB, TO>& g, float* part, cudaStream_t stream, int* launched) {
  return large_tiles(g)
             ? launch<128, 128, 8, 8, 8, false>(g, nullptr, 1, stream, launched)
             : launch<32, 64, 16, 4, 4, true>(g, part, split_count(g), stream, launched);
}

bool small_graph(int N, int Fin) {
  return N <= SG_MAX_N && small_graph_floats(N, Fin) * (long long)sizeof(float) <= SG_SMEM;
}

// The projection HW[c] = X W_c + bias_c, X read as one [B*N, Fin] matrix,
// written in f32.
template <typename T>
Gemm<T, T, float> projection(const T* x, const T* w, const T* bias, float* hw, int C, int B,
                             int N, int Fin, int Fout) {
  Gemm<T, T, float> g{};
  g.a = x;
  g.b = w;
  g.bias = bias;
  g.out = hw;
  g.b_z = (long long)Fin * Fout;
  g.out_z = (long long)B * N * Fout;
  g.bias_z = Fout;
  g.batch = C;
  g.M = (long long)B * N;
  g.N = Fout;
  g.K = Fin;
  g.nsum = 1;
  g.lda = Fin;
  g.ldb = Fout;
  g.ldo = Fout;
  return g;
}

// The aggregation out[b] = sum_c A[c, b] HW[c, b] over the C*N terms, HW
// read in f32.
template <typename T>
Gemm<T, float, T> aggregation(const T* adj, const float* hw, T* out, int C, int B, int N,
                              int Fout) {
  Gemm<T, float, T> g{};
  g.a = adj;
  g.b = hw;
  g.out = out;
  g.a_z = (long long)N * N;
  g.a_c = (long long)B * N * N;
  g.b_z = (long long)N * Fout;
  g.b_c = (long long)B * N * Fout;
  g.out_z = (long long)N * Fout;
  g.batch = B;
  g.M = N;
  g.N = Fout;
  g.K = N;
  g.nsum = C;
  g.lda = N;
  g.ldb = Fout;
  g.ldo = Fout;
  return g;
}

// floats of the split runs' partial outputs of one GEMM (0: not split)
template <typename G>
long long part_floats(const G& g) {
  const int splits = split_count(g);
  return splits == 1 ? 0 : splits * g.batch * g.M * g.N;
}

// out [B, N, Fout] = sum_c adj[c, b] (x[b] w[c] + bias[c]) in T, as the C
// entries below say.
template <typename T>
int gconv(const T* adj, const T* x, const T* w, const T* bias, float* scratch, T* out,
          int C, int B, int N, int Fin, int Fout, void* stream, int* launched) {
  *launched = 0;
  if (C <= 0 || B <= 0 || N <= 0 || Fin < 0 || Fout <= 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  if (small_graph(N, Fin)) {
    const size_t small_bytes = small_graph_floats(N, Fin) * sizeof(float);
    const long long blocks = (long long)B * ((Fout + SG_TF - 1) / SG_TF);
    const unsigned grid = (unsigned)(blocks < MAX_GRID ? blocks : MAX_GRID);
    small_graph_kernel<T><<<grid, SG_WARPS * 32, small_bytes, s>>>(adj, x, w, bias, out, C, B,
                                                                   N, Fin, Fout);
    const cudaError_t e = cudaGetLastError();
    if (e == cudaSuccess) *launched = 1;
    return (int)e;
  }
  float* hw = scratch;                                  // [C, B, N, Fout]
  float* part = scratch + (long long)C * B * N * Fout;  // the split runs
  cudaError_t e = run(projection<T>(x, w, bias, hw, C, B, N, Fin, Fout), part, s, launched);
  if (e != cudaSuccess) return (int)e;
  return (int)run(aggregation<T>(adj, hw, out, C, B, N, Fout), part, s, launched);
}

// ---------------------------------------------------------------------------
// bf16 on the tensor cores (the header's second part)

namespace tc {

using bf16 = __nv_bfloat16;
constexpr int MAX_ROWS = 256;  // rows a fused block holds (DENSE_MAX_NODES)

// gconv_tc_fused
constexpr int FT = 512;       // its threads: 16 warps, 4 along the rows x 4 along the columns
constexpr int TF = 64;        // output columns a block holds, 16 a warp
constexpr int FWS = TF + 8;   // row stride of its bf16 W stage and of P's planes: 144 B,
                              // so the 8 rows an ldmatrix reads lie on distinct banks
                              // (any stride of an odd number of 16-byte pieces does)
constexpr int DEPTH = 3;      // stages in flight
constexpr int SMEM_BUDGET = 232448;  // bytes of shared memory a block may take
// a thread's share of a stage, at most: pieces of 8 terms of X, W and A
// (cols / 8 a row, + 1 where realigned), and realigned groups of 8 terms
constexpr int QX = 3, QW = 2, QA = 4, GX = 2, GW = 2, GA = 4;

// gconv_tc_gemm
constexpr int THREADS = 256;  // its threads: 8 warps, 4 along the rows x 2 along the columns
constexpr int KC = 32;        // contraction terms a stage holds
constexpr int KS = KC + 8;    // row stride of a bf16 [rows][KC] stage
constexpr int TN = 64;        // output columns a block holds
constexpr int WS = TN + 8;    // row stride of the bf16 [KC][TN] stage
constexpr int PS = TN + 4;    // row stride of the f32 [KC][TN] stage
constexpr int GM = 128;       // rows a block holds

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes into shared memory, of which the first `bytes` come from src and
// the rest are zero
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
// wait until at most `pending` of this thread's newest groups are in flight
template <int pending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(pending) : "memory");
}

__device__ __forceinline__ void zero16(void* dst) {
  *reinterpret_cast<uint4*>(dst) = make_uint4(0, 0, 0, 0);
}

// four 8x8 b16 matrices; lane i gives the address of row i % 8 of matrix i / 8
__device__ __forceinline__ void ldsm4(unsigned (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm4_t(unsigned (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// d += a b: a 16x16 row-major bf16 fragment, b 16x8 (two registers), d f32
__device__ __forceinline__ void mma(float (&d)[4], const unsigned (&a)[4], unsigned b0,
                                    unsigned b1) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ unsigned bits(__nv_bfloat162 v) {
  return *reinterpret_cast<unsigned*>(&v);
}

// (x0, x1) as three bf16 pairs hi + lo + lo2 that hold them exactly
__device__ __forceinline__ void split3(unsigned (&t)[3], float x0, float x1) {
  const __nv_bfloat162 hi = __floats2bfloat162_rn(x0, x1);
  const float r0 = x0 - __low2float(hi), r1 = x1 - __high2float(hi);
  const __nv_bfloat162 lo = __floats2bfloat162_rn(r0, r1);
  const __nv_bfloat162 lo2 =
      __floats2bfloat162_rn(r0 - __low2float(lo), r1 - __high2float(lo));
  t[0] = bits(hi);
  t[1] = bits(lo);
  t[2] = bits(lo2);
}

// The B fragments of one n8 tile at one k16 step of f32 values p[k][n]
// (gconv_tc_gemm's f32 stage, row stride PS; p points at row k0, column n0
// of the tile), each term of the three: b[term][0] rows 2t, 2t + 1,
// b[term][1] rows 2t + 8, 2t + 9, column g.
__device__ __forceinline__ void split_frag(unsigned (&b)[3][2], const float* p, int lane) {
  const float* q = p + (2 * (lane & 3)) * PS + (lane >> 2);
  unsigned t0[3], t1[3];
  split3(t0, q[0], q[PS]);
  split3(t1, q[8 * PS], q[9 * PS]);
#pragma unroll
  for (int e = 0; e < 3; ++e) {
    b[e][0] = t0[e];
    b[e][1] = t1[e];
  }
}

// acc += a (hi + lo + lo2), the terms in order
__device__ __forceinline__ void mma3(float (&d)[4], const unsigned (&a)[4],
                                     const unsigned (&b)[3][2]) {
#pragma unroll
  for (int e = 0; e < 3; ++e) mma(d, a, b[e][0], b[e][1]);
}

// Fills a bf16 stage dst[r][k] (row stride ld), r < rows, k < 8 * groups.
// at(r, k, n) gives the source of elements (r, k .. k + 7) and sets n, how
// many of them are real (the rest, and all 8 where n <= 0, are zero).
// `aligned`: every such source is 16-byte aligned, and cp.async copies it;
// else the real elements are read one by one.
template <typename At>
__device__ __forceinline__ void stage(bf16* dst, int ld, int rows, int groups, bool aligned,
                                      At at) {
  for (int i = threadIdx.x; i < rows * groups; i += THREADS) {
    const int r = i / groups, k = (i - r * groups) * 8;
    int n;
    const bf16* src = at(r, k, n);
    bf16* d = dst + r * ld + k;
    if (n <= 0) {
      zero16(d);
    } else if (aligned) {
      cp_async16(d, src, 2 * (n < 8 ? n : 8));
    } else {
      const unsigned short* s = reinterpret_cast<const unsigned short*>(src);
      unsigned e[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) e[j] = j < n ? __ldg(s + j) : 0u;
      *reinterpret_cast<uint4*>(d) = make_uint4(e[0] | e[1] << 16, e[2] | e[3] << 16,
                                                e[4] | e[5] << 16, e[6] | e[7] << 16);
    }
  }
}

// How a tile of bf16 rows reaches shared memory.  Row r of a tile holds
// the tensor's elements from base + at(r) + col0, cols of them (zero past
// the row's `len` real terms, and everywhere where at(r) < 0).  The tensor
// starts on a 16-byte boundary (kgcn_gconv_bf16 refuses one that does not;
// the wrapper copies such a view).
enum Mode {
  ALIGNED = 0,  // every row piece 16-byte aligned: cp.async of the row's pieces
  REALIGN = 1   // rows not: cp.async of the aligned 16-byte pieces that cover the
                // row (cols / 8 + 1 of them), then the row shifted into place in
                // shared memory (realign_read, realign_write)
};

// ceil(65536 / per_row): (i * inv16) >> 16 is i / per_row for the lists of a
// block (fewer than 4096 items, per_row below 21)
__host__ __device__ inline int inv16(int per_row) { return (65535 + per_row) / per_row; }

// The copies of one stage of a tile into dst (row stride ld): rows x pieces
// of 8 terms, Q pieces a thread at most; nothing at or past `end` is read.
template <int MODE, int Q, typename At>
__device__ __forceinline__ void tile_issue(const bf16* base, const bf16* end, bf16* dst,
                                           int ld, int rows, int cols, int col0, int len,
                                           At at) {
  const int per_row = cols / 8 + (MODE == REALIGN), inv = inv16(per_row);
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    const int i = threadIdx.x + q * FT;
    if (i >= rows * per_row) break;
    const int r = (i * inv) >> 16, j = i - r * per_row;
    const int o = at(r);
    bf16* d = dst + r * ld + 8 * j;
    if (MODE == REALIGN) {
      const bf16* first = base + o + col0;  // the row's term col0
      const bf16* p =
          reinterpret_cast<const bf16*>(reinterpret_cast<size_t>(first) & ~(size_t)15) + 8 * j;
      const long long rest = end - p;
      const int bytes =
          o < 0 || p >= base + o + min(len, col0 + cols) ? 0 : rest >= 8 ? 16 : 2 * (int)rest;
      cp_async16(d, bytes ? p : base, bytes);
    } else {
      const int k = col0 + 8 * j;
      const int n = o < 0 ? 0 : max(0, min(8, len - k));
      cp_async16(d, n ? base + o + k : base, 2 * n);
    }
  }
}

// A REALIGN tile's rows shifted into place, read: v[q] holds the 8 terms of
// the thread's q-th group (row r, terms 8j .. 8j + 7), zero past the real
// ones; realign_write stores them once every thread has read.
template <int Q, typename At>
__device__ __forceinline__ void realign_read(uint4 (&v)[Q], const bf16* base, const bf16* src,
                                             int ld, int rows, int cols, int col0, int len,
                                             At at) {
  const int per_row = cols / 8, inv = inv16(per_row);
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    v[q] = make_uint4(0, 0, 0, 0);
    const int i = threadIdx.x + q * FT;
    if (i >= rows * per_row) break;
    const int r = (i * inv) >> 16, j = i - r * per_row;
    const int o = at(r), left = len - (col0 + 8 * j);
    if (o < 0 || left <= 0) continue;
    // where term 8j of the row landed: past its first piece's start
    const int s = (int)((reinterpret_cast<size_t>(base + o + col0) >> 1) & 7) + 8 * j;
    const unsigned* w = reinterpret_cast<const unsigned*>(src + r * ld) + (s >> 1);
    unsigned e[5], u[4];
#pragma unroll
    for (int m = 0; m < 5; ++m) e[m] = w[m];
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      u[m] = (s & 1) ? __funnelshift_r(e[m], e[m + 1], 16) : e[m];
      if (2 * m + 1 >= left) u[m] &= 2 * m < left ? 0xffffu : 0u;
    }
    v[q] = make_uint4(u[0], u[1], u[2], u[3]);
  }
}

template <int Q>
__device__ __forceinline__ void realign_write(const uint4 (&v)[Q], bf16* dst, int ld, int rows,
                                              int cols) {
  const int per_row = cols / 8, inv = inv16(per_row);
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    const int i = threadIdx.x + q * FT;
    if (i >= rows * per_row) break;
    const int r = (i * inv) >> 16, j = i - r * per_row;
    *reinterpret_cast<uint4*>(dst + r * ld + 8 * j) = v[q];
  }
}

// Runs `steps` stages of a contraction in D slots, D - 1 stages loading
// while one is multiplied: issue(s, slot) starts stage s's copies,
// realign(s, slot) (where REALIGNS) shifts its REALIGN rows into place,
// compute(s, slot) uses it.  Ends with the block synchronised, every stage
// read.
template <int D, bool REALIGNS, typename Issue, typename Realign, typename Compute>
__device__ __forceinline__ void pipeline(int steps, Issue issue, Realign realign,
                                         Compute compute) {
#pragma unroll
  for (int s = 0; s < D - 1; ++s) {
    if (s < steps) issue(s, s);
    cp_async_commit();
  }
  for (int s = 0; s < steps; ++s) {
    cp_async_wait<D - 2>();
    __syncthreads();  // stage s is in; every reader of stage s - 1 is done
    if (REALIGNS) {
      realign(s, s % D);
      __syncthreads();
    }
    if (s + D - 1 < steps) issue(s + D - 1, (s + D - 1) % D);
    cp_async_commit();
    compute(s, s % D);
  }
  __syncthreads();
}

struct Fused {
  const bf16 *adj, *x, *w, *bias;
  bf16* out;
  int C, B, N, Fin, Fout;
  int NP;          // a graph's rows in the block: N rounded up to 16
  int G;           // graphs a block holds (G * NP <= MAX_ROWS)
  int KP, KA;      // terms a projection, an aggregation stage holds (multiples of 32)
  int xm, wm, am;  // how X, W and A reach shared memory (Mode)
};

// bytes of one stage slot of gconv_tc_fused for `rows` rows: a projection
// stage (X [rows][kp + 8], W [kp][FWS]) or an aggregation stage
// (A [rows][ka + 8])
__host__ __device__ inline int fused_slot(int rows, int kp, int ka) {
  const int proj = rows * (kp + 8) + kp * FWS, agg = rows * (ka + 8);
  return 2 * (proj > agg ? proj : agg);
}

// its shared memory: the held rows' node indices [rows], P's three bf16
// planes [3][rows][FWS], then DEPTH slots
__host__ __device__ inline int fused_smem(int rows, int kp, int ka) {
  return rows * 4 + 3 * rows * FWS * 2 + DEPTH * fused_slot(rows, kp, ka);
}

// XM, WM, AM: how X, W and A reach shared memory (Mode).  (__grid_constant__:
// the lambdas below refer to f, and a reference to a plain kernel parameter
// would keep a copy of it in local memory.)
template <int XM, int WM, int AM>
__global__ void __launch_bounds__(FT, 1) gconv_tc_fused(const __grid_constant__ Fused f) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int RT = f.G * f.NP;  // rows held
  const int XS = f.KP + 8, AS = f.KA + 8;  // row strides of the X and A stages
  const int slot = fused_slot(RT, f.KP, f.KA);
  int* node = reinterpret_cast<int*>(smem);  // held row R: (b - b0) N + n, or -1
  bf16* planes = reinterpret_cast<bf16*>(smem + RT * 4);  // P = hi + lo + lo2, [3][RT][FWS]
  unsigned char* slots = smem + RT * 4 + 3 * RT * FWS * 2;
  auto xs = [&](int buf) { return reinterpret_cast<bf16*>(slots + buf * slot); };
  auto ws = [&](int buf) { return xs(buf) + RT * XS; };
  const bf16* x_end = f.x + (long long)f.B * f.N * f.Fin;  // nothing past these is read
  const bf16* w_end = f.w + (long long)f.C * f.Fin * f.Fout;
  const bf16* a_end = f.adj + (long long)f.C * f.B * f.N * f.N;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = warp >> 2, wn = warp & 3;  // rows: m16 tiles wm + 4 i; columns 16 wn ..
  const int g = lane >> 2, t = lane & 3;
  const int lrow = lane & 15, lcol = (lane >> 4) * 8;  // this lane's ldmatrix address
  const int tiles = (f.Fout + TF - 1) / TF;
  const long long blocks = ((long long)f.B + f.G - 1) / f.G * tiles;
  const int psteps = (f.Fin + f.KP - 1) / f.KP, asteps = (f.N + f.KA - 1) / f.KA;
  const int mts = RT / 16;  // m16 tiles held

  for (long long blk = blockIdx.x; blk < blocks; blk += gridDim.x) {
    const long long b0 = blk / tiles * f.G;
    const int n0 = (int)(blk % tiles) * TF;
    __syncthreads();  // the last block's readers of `node` are done
    for (int R = threadIdx.x; R < RT; R += FT) {
      const int gi = R / f.NP, rr = R - gi * f.NP;
      node[R] = rr < f.N && b0 + gi < f.B ? gi * f.N + rr : -1;
    }
    __syncthreads();
    float acc[4][2][4];  // m16 tiles wm + 4 i, n8 tiles 2 wn + j
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

    for (int c = 0; c < f.C; ++c) {
      // 1. P = X W_c[:, tile] + b_c for every row held
      const bf16* xb0 = f.x + b0 * f.N * f.Fin;  // the block's first graph
      const bf16* wc = f.w + (long long)c * f.Fin * f.Fout + n0;  // W_c's column tile
      float bv[2][2];  // b_c at this thread's columns, read ahead of its use
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int n = n0 + wn * 16 + 8 * j + 2 * t + h;
          bv[j][h] = n < f.Fout ? ld(f.bias + (size_t)c * f.Fout + n) : 0.f;
        }
      float pacc[4][2][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) pacc[i][j][e] = 0.f;
      auto xrow = [&](int r) { return node[r] < 0 ? -1 : node[r] * f.Fin; };
      auto wrow = [&](int k0) {
        return [&f, k0](int r) { return k0 + r < f.Fin ? r * f.Fout : -1; };
      };
      auto pissue = [&](int s, int buf) {
        const int k0 = s * f.KP;
        tile_issue<XM, QX>(xb0, x_end, xs(buf), XS, RT, f.KP, k0, f.Fin, xrow);
        tile_issue<WM, QW>(wc + (long long)k0 * f.Fout, w_end, ws(buf), FWS, f.KP, TF, 0,
                           f.Fout - n0, wrow(k0));
      };
      auto prealign = [&](int s, int buf) {
        const int k0 = s * f.KP;
        uint4 vx[GX], vw[GW];
        if (XM == REALIGN) realign_read(vx, xb0, xs(buf), XS, RT, f.KP, k0, f.Fin, xrow);
        if (WM == REALIGN)
          realign_read(vw, wc + (long long)k0 * f.Fout, ws(buf), FWS, f.KP, TF, 0,
                       f.Fout - n0, wrow(k0));
        __syncthreads();
        if (XM == REALIGN) realign_write(vx, xs(buf), XS, RT, f.KP);
        if (WM == REALIGN) realign_write(vw, ws(buf), FWS, f.KP, TF);
      };
      auto pcompute = [&](int s, int buf) {
        const bf16* xb = xs(buf);
        const bf16* wb = ws(buf);
        const int kend = min(f.KP, f.Fin - s * f.KP);  // real terms of this stage
        for (int kk = 0; kk < kend; kk += 16) {
          unsigned bw[4];  // n8 tiles 2 wn, 2 wn + 1
          ldsm4_t(bw, wb + (kk + lrow) * FWS + wn * 16 + lcol);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            if (wm + 4 * i >= mts) break;
            unsigned a[4];
            ldsm4(a, xb + ((wm + 4 * i) * 16 + lrow) * XS + kk + lcol);
            mma(pacc[i][0], a, bw[0], bw[1]);
            mma(pacc[i][1], a, bw[2], bw[3]);
          }
        }
      };
      pipeline<DEPTH, XM == REALIGN || WM == REALIGN>(psteps, pissue, prealign, pcompute);
      // + b_c (rows of no graph 0), split into P's planes: hi, lo, lo2
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int mt = wm + 4 * i;
        if (mt >= mts) break;
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int cl = wn * 16 + 8 * j + 2 * t;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int R = mt * 16 + g + 8 * h;
            const bool real = node[R] >= 0;
            unsigned v[3];
            split3(v, real ? pacc[i][j][2 * h] + bv[j][0] : 0.f,
                   real ? pacc[i][j][2 * h + 1] + bv[j][1] : 0.f);
#pragma unroll
            for (int e = 0; e < 3; ++e)
              *reinterpret_cast<unsigned*>(planes + (e * RT + R) * FWS + cl) = v[e];
          }
        }
      }
      // 2. acc += A_c P, each graph's rows against its own rows of P (the
      // aggregation's first barrier orders the planes' stores before their
      // reads)
      const bf16* ac = f.adj + ((long long)c * f.B + b0) * f.N * f.N;  // A_c of the block
      auto arow = [&](int r) { return node[r] < 0 ? -1 : node[r] * f.N; };
      auto aissue = [&](int s, int buf) {
        tile_issue<AM, QA>(ac, a_end, xs(buf), AS, RT, f.KA, s * f.KA, f.N, arow);
      };
      auto arealign = [&](int s, int buf) {
        uint4 v[GA];
        realign_read(v, ac, xs(buf), AS, RT, f.KA, s * f.KA, f.N, arow);
        __syncthreads();
        realign_write(v, xs(buf), AS, RT, f.KA);
      };
      auto acompute = [&](int s, int buf) {
        const bf16* ab = xs(buf);
        const int kend = min(f.KA, f.N - s * f.KA);  // real terms of this stage
        for (int kk = 0; kk < kend; kk += 16) {
          const int k = s * f.KA + kk;
          unsigned a[4][4];
#pragma unroll
          for (int i = 0; i < 4; ++i)
            if (wm + 4 * i < mts) ldsm4(a[i], ab + ((wm + 4 * i) * 16 + lrow) * AS + kk + lcol);
          unsigned bp[3][4];  // per plane: n8 tiles 2 wn, 2 wn + 1
          if (f.G == 1) {
            // one graph: its P rows k .. k + 15 for every m16 tile, and the
            // 24 products in an order that keeps 8 accumulators apart
#pragma unroll
            for (int e = 0; e < 3; ++e)
              ldsm4_t(bp[e], planes + (e * RT + k + lrow) * FWS + wn * 16 + lcol);
#pragma unroll
            for (int e = 0; e < 3; ++e)
#pragma unroll
              for (int i = 0; i < 4; ++i) {
                if (wm + 4 * i >= mts) break;
#pragma unroll
                for (int j = 0; j < 2; ++j) mma(acc[i][j], a[i], bp[e][2 * j], bp[e][2 * j + 1]);
              }
          } else {
            // an m16 tile holds rows of one graph (NP is a multiple of 16)
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const int mt = wm + 4 * i;
              if (mt >= mts) break;
              const int pr = mt * 16 / f.NP * f.NP + k;  // its graph's P row k
#pragma unroll
              for (int e = 0; e < 3; ++e)
                ldsm4_t(bp[e], planes + (e * RT + pr + lrow) * FWS + wn * 16 + lcol);
#pragma unroll
              for (int e = 0; e < 3; ++e)
#pragma unroll
                for (int j = 0; j < 2; ++j) mma(acc[i][j], a[i], bp[e][2 * j], bp[e][2 * j + 1]);
            }
          }
        }
      };
      pipeline<DEPTH, AM == REALIGN>(asteps, aissue, arealign, acompute);
    }

    // the output, rounded to bf16 once
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int mt = wm + 4 * i;
      if (mt >= mts) break;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int nd = node[mt * 16 + g + 8 * h];
        if (nd < 0) continue;
        bf16* o = f.out + (b0 * f.N + nd) * f.Fout;
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int n = n0 + wn * 16 + 8 * j + 2 * t;
          const float v0 = acc[i][j][2 * h], v1 = acc[i][j][2 * h + 1];
          if (f.Fout % 2 == 0 && n < f.Fout) {
            *reinterpret_cast<__nv_bfloat162*>(o + n) = __floats2bfloat162_rn(v0, v1);
          } else {
            if (n < f.Fout) st(o + n, v0);
            if (n + 1 < f.Fout) st(o + n + 1, v1);
          }
        }
      }
    }
  }
}

// One batched GEMM on the tensor cores, for graphs above MAX_ROWS nodes:
// for z < batch, out_z = sum_{c < nsum} A_zc B_zc over K terms, with A_zc =
// a + z a_z + c a_c (bf16, row-major, lda) and B_zc = b + z b_z + c b_c
// (row-major, ldb), out_z = out + z out_z (ldo).
//   projection (AGG false): B bf16, out f32 = A B + bias_z;
//   aggregation (AGG true): B f32 (the projection), split into three bf16
//   terms as it is read; out bf16, or with `splits` runs f32 partials
//   part[split][z] ([M][N]) that sum_splits adds.
struct Gemm16 {
  const bf16* a;
  const void* b;
  const bf16* bias;
  void* out;
  long long a_z, a_c, b_z, b_c, out_z, bias_z, batch, M;
  int N, K, nsum, lda, ldb, ldo;
  bool a_al, b_al;  // 16-byte aligned rows: staged by cp.async
};

template <bool AGG>
__global__ void __launch_bounds__(THREADS, 2)
gconv_tc_gemm(const Gemm16 g, float* __restrict__ part, int splits) {
  constexpr int BF = AGG ? KC * PS * 4 : KC * WS * 2;  // bytes of a B stage
  __shared__ __align__(16) bf16 as[2][GM * KS];
  __shared__ __align__(16) unsigned char bs[2][BF];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = warp >> 1, wn = warp & 1;
  const int gr = lane >> 2, t = lane & 3;
  const int lrow = lane & 15, lcol = (lane >> 4) * 8;
  const int tiles_n = (g.N + TN - 1) / TN;
  const long long tiles = (g.M + GM - 1) / GM * tiles_n;
  const int k_steps = (g.K + KC - 1) / KC, all_steps = g.nsum * k_steps;

  for (long long blk = blockIdx.x; blk < g.batch * tiles * splits; blk += gridDim.x) {
    const int split = (int)(blk % splits);
    const long long zt = blk / splits, z = zt / tiles, tt = zt % tiles;
    const int first = (int)((long long)all_steps * split / splits);
    const int steps = (int)((long long)all_steps * (split + 1) / splits) - first;
    const long long m0 = tt / tiles_n * GM;
    const int n0 = (int)(tt % tiles_n) * TN;
    float acc[2][4][4];  // m16 tiles 2 wm + i, n8 tiles 4 wn + j
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

    auto load = [&](int s, int buf) {
      const int step = first + s, c = step / k_steps, k0 = (step - c * k_steps) * KC;
      const bf16* a = g.a + z * g.a_z + c * g.a_c;
      stage(as[buf], KS, GM, KC / 8, g.a_al, [&](int r, int k, int& n) {
        const long long m = m0 + r;
        n = m < g.M ? g.K - (k0 + k) : 0;
        return a + m * g.lda + k0 + k;
      });
      if constexpr (AGG) {  // f32 rows of TN, 4 values a 16-byte piece
        const float* b = static_cast<const float*>(g.b) + z * g.b_z + c * g.b_c;
        float* d = reinterpret_cast<float*>(bs[buf]);
        for (int i = threadIdx.x; i < KC * (TN / 4); i += THREADS) {
          const int r = i / (TN / 4), k = (i % (TN / 4)) * 4;
          const int n = k0 + r < g.K ? g.N - (n0 + k) : 0;
          const float* src = b + (size_t)(k0 + r) * g.ldb + n0 + k;
          float* dst = d + r * PS + k;
          if (n <= 0) {
            *reinterpret_cast<float4*>(dst) = make_float4(0.f, 0.f, 0.f, 0.f);
          } else if (g.b_al) {
            cp_async16(dst, src, 4 * (n < 4 ? n : 4));
          } else {
#pragma unroll
            for (int j = 0; j < 4; ++j) dst[j] = j < n ? __ldg(src + j) : 0.f;
          }
        }
      } else {
        const bf16* b = static_cast<const bf16*>(g.b) + z * g.b_z + c * g.b_c;
        stage(reinterpret_cast<bf16*>(bs[buf]), WS, KC, TN / 8, g.b_al,
              [&](int r, int k, int& n) {
                n = k0 + r < g.K ? g.N - (n0 + k) : 0;
                return b + (size_t)(k0 + r) * g.ldb + n0 + k;
              });
      }
    };
    auto compute = [&](int s, int buf) {
      const int step = first + s, k0 = (step % k_steps) * KC;
#pragma unroll
      for (int kk = 0; kk < KC; kk += 16) {
        if (k0 + kk >= g.K) break;  // zero terms
        unsigned a[2][4];
#pragma unroll
        for (int i = 0; i < 2; ++i)
          ldsm4(a[i], as[buf] + ((2 * wm + i) * 16 + lrow) * KS + kk + lcol);
        if constexpr (AGG) {
          const float* pk = reinterpret_cast<const float*>(bs[buf]) + kk * PS + wn * 32;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            unsigned b[3][2];
            split_frag(b, pk + 8 * j, lane);
#pragma unroll
            for (int i = 0; i < 2; ++i) mma3(acc[i][j], a[i], b);
          }
        } else {
          const bf16* wb = reinterpret_cast<const bf16*>(bs[buf]);
          unsigned bw[2][4];
          ldsm4_t(bw[0], wb + (kk + lrow) * WS + wn * 32 + lcol);
          ldsm4_t(bw[1], wb + (kk + lrow) * WS + wn * 32 + 16 + lcol);
#pragma unroll
          for (int i = 0; i < 2; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j)
              mma(acc[i][j], a[i], bw[j >> 1][(j & 1) * 2], bw[j >> 1][(j & 1) * 2 + 1]);
        }
      }
    };
    pipeline<2, false>(steps, load, [](int, int) {}, compute);

#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const long long m = m0 + (2 * wm + i) * 16 + gr + 8 * h;
        if (m >= g.M) continue;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int n = n0 + wn * 32 + 8 * j + 2 * t;
          float v[2] = {acc[i][j][2 * h], acc[i][j][2 * h + 1]};
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            if (n + e >= g.N) continue;
            if constexpr (!AGG) {
              const float bv = ld(g.bias + z * g.bias_z + n + e);
              static_cast<float*>(g.out)[z * g.out_z + m * g.ldo + n + e] = v[e] + bv;
            } else if (splits == 1) {
              st(static_cast<bf16*>(g.out) + z * g.out_z + m * g.ldo + n + e, v[e]);
            } else {
              part[((long long)split * g.batch + z) * g.M * g.N + m * g.N + n + e] = v[e];
            }
          }
        }
      }
    }
  }
}

// 16-byte aligned rows of bf16 (ld elements apart, from p, at offsets that
// are multiples of `step`)
inline bool rows16(const void* p, long long ld, long long step = 0) {
  return reinterpret_cast<size_t>(p) % 16 == 0 && ld % 8 == 0 && step % 8 == 0;
}

// graphs a fused block holds: one, unless even so the blocks would
// outnumber two an SM, and then as many as keep two an SM busy (at most
// MAX_ROWS rows)
int fused_graphs(int B, int NP, int Fout) {
  const long long tiles = (Fout + TF - 1) / TF;
  const long long gs = (long long)B * tiles / (2 * SMS);
  return (int)std::max(1LL, std::min<long long>(gs, MAX_ROWS / NP));
}

// how rows `ld` elements apart from p reach shared memory (Mode), or -1
// where p is not 16-byte aligned (the wrapper passes aligned tensors)
int load_mode(const void* p, long long ld) {
  if (reinterpret_cast<size_t>(p) % 16 != 0) return -1;
  return ld % 8 == 0 ? ALIGNED : REALIGN;
}

// The stages' terms: as many as the graph has, up to what the shared
// memory and a thread's share of a stage (QX ... GA) allow.
void fused_terms(Fused& f) {
  const int RT = f.G * f.NP;
  auto pieces = [](int rows, int cols, int mode) { return rows * (cols / 8 + (mode == REALIGN)); };
  auto ok = [&](int kp, int ka) {
    return fused_smem(RT, kp, ka) <= SMEM_BUDGET && pieces(RT, kp, f.xm) <= QX * FT &&
           pieces(kp, TF, f.wm) <= QW * FT && pieces(RT, ka, f.am) <= QA * FT &&
           (f.xm != REALIGN || RT * kp / 8 <= GX * FT) &&
           (f.wm != REALIGN || kp * TF / 8 <= GW * FT) &&
           (f.am != REALIGN || RT * ka / 8 <= GA * FT);
  };
  int ka = std::max(32, (f.N + 31) / 32 * 32), kp = std::max(32, (f.Fin + 31) / 32 * 32);
  while (ka > 32 && !ok(32, ka)) ka -= 32;
  while (kp > 32 && !ok(kp, ka)) kp -= 32;
  f.KA = ka;
  f.KP = kp;
}

// Runs the aggregation's steps are cut into: doubled, up to 8, while the
// blocks number fewer than two an SM and each run keeps 4 steps or more.
int agg_splits(const Gemm16& g) {
  const long long blocks = g.batch * ((g.M + GM - 1) / GM) * ((g.N + TN - 1) / TN);
  const int steps = g.nsum * ((g.K + KC - 1) / KC);
  int splits = 1;
  while (splits < 8 && blocks * splits < 2 * SMS && steps / (2 * splits) >= 4) splits *= 2;
  return splits;
}

template <bool AGG>
cudaError_t launch_gemm(const Gemm16& g, float* part, int splits, cudaStream_t s,
                        int* launched) {
  const long long blocks =
      g.batch * ((g.M + GM - 1) / GM) * ((g.N + TN - 1) / TN) * splits;
  if (blocks == 0) return cudaSuccess;
  gconv_tc_gemm<AGG><<<(unsigned)std::min(blocks, MAX_GRID), THREADS, 0, s>>>(g, part,
                                                                             splits);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  ++*launched;
  if (splits == 1) return e;
  const long long total = g.batch * g.M * g.N;
  sum_splits<bf16, bf16><<<(unsigned)std::min((total + 255) / 256, MAX_GRID), 256, 0, s>>>(
      part, nullptr, static_cast<bf16*>(g.out), total, g.M * g.N, 0, g.N, splits);
  e = cudaGetLastError();
  if (e == cudaSuccess) ++*launched;
  return e;
}

// The projection X W_c + b_c of every graph into hw [C, B, N, Fout] (f32).
Gemm16 projection16(const bf16* x, const bf16* w, const bf16* bias, float* hw, int C, int B,
                    int N, int Fin, int Fout) {
  Gemm16 g{};
  g.a = x;
  g.b = w;
  g.bias = bias;
  g.out = hw;
  g.b_z = (long long)Fin * Fout;
  g.out_z = (long long)B * N * Fout;
  g.bias_z = Fout;
  g.batch = C;
  g.M = (long long)B * N;
  g.N = Fout;
  g.K = Fin;
  g.nsum = 1;
  g.lda = Fin;
  g.ldb = Fout;
  g.ldo = Fout;
  g.a_al = rows16(x, Fin);
  g.b_al = rows16(w, Fout, g.b_z);
  return g;
}

// The aggregation out[b] = sum_c A[c, b] HW[c, b] over the C*N terms.
Gemm16 aggregation16(const bf16* adj, const float* hw, bf16* out, int C, int B, int N,
                     int Fout) {
  Gemm16 g{};
  g.a = adj;
  g.b = hw;
  g.out = out;
  g.a_z = (long long)N * N;
  g.a_c = (long long)B * N * N;
  g.b_z = (long long)N * Fout;
  g.b_c = (long long)B * N * Fout;
  g.out_z = (long long)N * Fout;
  g.batch = B;
  g.M = N;
  g.N = Fout;
  g.K = N;
  g.nsum = C;
  g.lda = N;
  g.ldb = Fout;
  g.ldo = Fout;
  g.a_al = rows16(adj, N, g.a_z);
  g.b_al = reinterpret_cast<size_t>(hw) % 16 == 0 && Fout % 4 == 0;  // f32 rows
  return g;
}

// floats of scratch: the projection, then the aggregation's split runs
long long scratch_floats(int C, int B, int N, int Fout) {
  if (N <= MAX_ROWS) return 0;
  const long long hw = (long long)C * B * N * Fout;
  const Gemm16 g = aggregation16(nullptr, nullptr, nullptr, C, B, N, Fout);
  const int splits = agg_splits(g);
  return hw + (splits == 1 ? 0 : splits * g.batch * g.M * g.N);
}

template <int XM, int WM, int AM>
cudaError_t allow_smem() {
  return cudaFuncSetAttribute(gconv_tc_fused<XM, WM, AM>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BUDGET);
}

// gconv_tc_fused takes more shared memory than 48 KB: allowed for all 8
// instances at a device's first call (an eager call: the runners warm up
// before they capture)
cudaError_t allow_fused_smem() {
  static bool allowed[64] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess || (dev < 64 && allowed[dev])) return e;
  const cudaError_t es[] = {
      allow_smem<ALIGNED, ALIGNED, ALIGNED>(), allow_smem<ALIGNED, ALIGNED, REALIGN>(),
      allow_smem<ALIGNED, REALIGN, ALIGNED>(), allow_smem<ALIGNED, REALIGN, REALIGN>(),
      allow_smem<REALIGN, ALIGNED, ALIGNED>(), allow_smem<REALIGN, ALIGNED, REALIGN>(),
      allow_smem<REALIGN, REALIGN, ALIGNED>(), allow_smem<REALIGN, REALIGN, REALIGN>()};
  for (const cudaError_t x : es)
    if (x != cudaSuccess) return x;
  if (dev < 64) allowed[dev] = true;
  return cudaSuccess;
}

template <int XM, int WM, int AM>
cudaError_t launch_fused(const Fused& f, cudaStream_t s) {
  const long long blocks = ((long long)f.B + f.G - 1) / f.G * ((f.Fout + TF - 1) / TF);
  gconv_tc_fused<XM, WM, AM><<<(unsigned)std::min(blocks, MAX_GRID), FT,
                               fused_smem(f.G * f.NP, f.KP, f.KA), s>>>(f);
  return cudaGetLastError();
}

// One launch of gconv_tc_fused in the instance of f's modes
cudaError_t launch_fused(const Fused& f, cudaStream_t s) {
  const cudaError_t e = allow_fused_smem();
  if (e != cudaSuccess) return e;
  switch (f.xm * 4 + f.wm * 2 + f.am) {
    case 0: return launch_fused<ALIGNED, ALIGNED, ALIGNED>(f, s);
    case 1: return launch_fused<ALIGNED, ALIGNED, REALIGN>(f, s);
    case 2: return launch_fused<ALIGNED, REALIGN, ALIGNED>(f, s);
    case 3: return launch_fused<ALIGNED, REALIGN, REALIGN>(f, s);
    case 4: return launch_fused<REALIGN, ALIGNED, ALIGNED>(f, s);
    case 5: return launch_fused<REALIGN, ALIGNED, REALIGN>(f, s);
    case 6: return launch_fused<REALIGN, REALIGN, ALIGNED>(f, s);
    default: return launch_fused<REALIGN, REALIGN, REALIGN>(f, s);
  }
}

int gconv_bf16(const bf16* adj, const bf16* x, const bf16* w, const bf16* bias,
               float* scratch, bf16* out, int C, int B, int N, int Fin, int Fout,
               void* stream, int* launched) {
  *launched = 0;
  if (C <= 0 || B <= 0 || N <= 0 || Fin < 0 || Fout <= 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  if (N <= MAX_ROWS) {
    const int xm = load_mode(x, Fin), wm = load_mode(w, Fout), am = load_mode(adj, N);
    if (xm < 0 || wm < 0 || am < 0) return (int)cudaErrorMisalignedAddress;
    Fused f{adj, x, w, bias, out, C, B, N, Fin, Fout};
    f.NP = (N + 15) / 16 * 16;
    f.G = fused_graphs(B, f.NP, Fout);
    f.xm = xm;
    f.wm = wm;
    f.am = am;
    fused_terms(f);
    const cudaError_t e = launch_fused(f, s);
    if (e == cudaSuccess) *launched = 1;
    return (int)e;
  }
  float* hw = scratch;                                  // [C, B, N, Fout]
  float* part = scratch + (long long)C * B * N * Fout;  // the split runs
  cudaError_t e = launch_gemm<false>(projection16(x, w, bias, hw, C, B, N, Fin, Fout),
                                     nullptr, 1, s, launched);
  if (e != cudaSuccess) return (int)e;
  const Gemm16 agg = aggregation16(adj, hw, out, C, B, N, Fout);
  return (int)launch_gemm<true>(agg, part, agg_splits(agg), s, launched);
}

}  // namespace tc


}  // namespace

extern "C" {

// Floats of scratch kgcn_gconv_f32 needs for these sizes: 0 for the
// small-graph design; else C*B*N*Fout for the projection, then room for the
// partial outputs of whichever GEMM has its steps cut into runs.
long long kgcn_gconv_f32_scratch_floats(int C, int B, int N, int Fin, int Fout) {
  if (small_graph(N, Fin)) return 0;
  const long long parts = std::max(
      part_floats(projection<float>(nullptr, nullptr, nullptr, nullptr, C, B, N, Fin, Fout)),
      part_floats(aggregation<float>(nullptr, nullptr, nullptr, C, B, N, Fout)));
  return (long long)C * B * N * Fout + parts;
}

// out [B, N, Fout] = sum_c adj[c, b] (x[b] w[c] + bias[c]); scratch holds
// kgcn_gconv_f32_scratch_floats floats.  Launches on `stream` (a
// cudaStream_t) and sets *launched to the number of kernels it launched (1
// to 3); returns the cudaError_t of the first launch that fails, else 0.
// Does not synchronise and allocates nothing.
int kgcn_gconv_f32(const float* adj, const float* x, const float* w,
                   const float* bias, float* scratch, float* out, int C, int B, int N,
                   int Fin, int Fout, void* stream, int* launched) {
  return gconv<float>(adj, x, w, bias, scratch, out, C, B, N, Fin, Fout, stream, launched);
}

// Floats of scratch kgcn_gconv_bf16 needs for these sizes: 0 for graphs
// of up to 256 nodes (one fused launch); else C*B*N*Fout for the f32
// projection (the bytes of its hi + lo bf16 pairs), then room for the
// aggregation's split runs.
long long kgcn_gconv_bf16_scratch_floats(int C, int B, int N, int Fin, int Fout) {
  (void)Fin;
  return tc::scratch_floats(C, B, N, Fout);
}

// The same on bf16 operands and a bf16 output, on the tensor cores: f32
// sums, one rounding at the output; scratch holds
// kgcn_gconv_bf16_scratch_floats floats.  For graphs of up to 256 nodes
// adj, x and w must start on 16-byte boundaries (else
// cudaErrorMisalignedAddress); sets *launched to 1 for those, else 2 to 3.
int kgcn_gconv_bf16(const void* adj, const void* x, const void* w, const void* bias,
                    float* scratch, void* out, int C, int B, int N, int Fin, int Fout,
                    void* stream, int* launched) {
  using T = __nv_bfloat16;
  return tc::gconv_bf16(static_cast<const T*>(adj), static_cast<const T*>(x),
                        static_cast<const T*>(w), static_cast<const T*>(bias), scratch,
                        static_cast<T*>(out), C, B, N, Fin, Fout, stream, launched);
}

const char* kgcn_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
