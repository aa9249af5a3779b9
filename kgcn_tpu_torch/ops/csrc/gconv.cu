// Fused multi-channel dense graph convolution for Hopper (sm_90a), float32
// (kgcn_gconv_f32) and bf16 (kgcn_gconv_bf16).
//
//   out[b] = sum_c A[c, b] @ (X[b] @ W[c] + bias[c])
//   adj [C, B, N, N], x [B, N, Fin], w [C, Fin, Fout], bias [C, Fout]
//   -> out [B, N, Fout], all row-major and contiguous, all of one type.
//
// bf16: what `_gconv_kernel` computes on bf16 refs (pallas_gconv.py:33-53).
// Every operand is read as bf16 and widened to f32 in registers (or in
// shared memory, which stays f32); X W_c is summed in f32 and b_c added in
// f32, and that projection is kept in f32 (the scratch of the two-launch
// design is f32, sized as for float32); A_c HW_c is summed in f32 over the
// channels in order; the output is rounded to bf16 once.  The launch
// shapes, the order of sums and the split runs are the float32 ones, so two
// launches give the same bits.  The arithmetic is FP32 FMAs: bf16 halves
// the operand bytes, and no tensor core is used yet.
//
// Replaces the Pallas TPU kernel `_gconv_kernel`
// (kgcn_tpu/ops/pallas_gconv.py:33, launched by `_gconv_call`), which keeps
// one graph's X W_c in VMEM while it aggregates.
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

}  // namespace

extern "C" {

// Floats of scratch kgcn_gconv_f32 and kgcn_gconv_bf16 need for these
// sizes: 0 for the small-graph design; else C*B*N*Fout for the projection,
// then room for the partial outputs of whichever GEMM has its steps cut
// into runs.
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

// The same on bf16 operands and a bf16 output (the scratch is f32, of
// kgcn_gconv_f32_scratch_floats floats): f32 sums, one rounding at the
// output.
int kgcn_gconv_bf16(const void* adj, const void* x, const void* w, const void* bias,
                    float* scratch, void* out, int C, int B, int N, int Fin, int Fout,
                    void* stream, int* launched) {
  using T = __nv_bfloat16;
  return gconv<T>(static_cast<const T*>(adj), static_cast<const T*>(x),
                  static_cast<const T*>(w), static_cast<const T*>(bias), scratch,
                  static_cast<T*>(out), C, B, N, Fin, Fout, stream, launched);
}

const char* kgcn_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
