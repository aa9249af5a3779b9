// Fused Adam / AdamW update for Hopper (sm_90a): every leaf of a model's
// parameters, its gradient and its two moments updated in place in ONE
// launch (multi-tensor).
//
//   mu <- (1-b1)*g + b1*mu
//   nu <- ((1-b2)*g)*g + b2*nu
//   u  <- (mu * (1/c1)) / (sqrt(nu * (1/c2)) + eps)
//   u  <- u + weight_decay*p                        (AdamW's decoupled decay)
//   p  <- p + (-lr)*u
//
// c1 = 1 - b1^t and c2 = 1 - b2^t (the bias corrections) and, under a
// schedule, -lr are read from the optimizer's row on the device (the
// runner's table row of the step), so the launch is the same at every
// step and can be captured into a CUDA graph.
//
// Replaces no TPU kernel: kgcn_tpu leaves the optimizer to XLA, which fuses
// optax's update into a few loops.  In the port the same update was about
// 17 PyTorch kernels a leaf (runtime/optim.py: scale_by_adam, then the
// learning rate, the add into the parameters and the copies of the new
// moments into the runner's buffers): 35 passes over float32 per parameter
// where the update needs 7.
//
// What bounds it: bytes.  A parameter reads p, g, mu and nu and writes p,
// mu and nu, 28 bytes, for ~12 FLOP, far below the card's ridge.  So the
// design only moves each of those bytes once, with 16-byte loads and stores
// where a leaf's four pointers are 16-byte aligned (PyTorch's allocations
// are) and a scalar tail where its size is not a multiple of 4 (20 014 and
// 2 200 are not), each block taking CHUNK elements of one leaf at a time in
// a grid-stride loop over every leaf's chunks, the grid filling the SMs.
//
// Same bits as the generic update: every step is its own rounding
// (__fmul_rn, __fadd_rn, __fdiv_rn, __fsqrt_rn), in the generic update's
// order, so nvcc's default --fmad=true cannot contract (1-b1)*g + b1*mu
// into an FMA; the reciprocals 1/c are correctly rounded, as PyTorch's
// reciprocal is; the scalars arrive rounded to float32 as PyTorch rounds a
// Python number against a float32 tensor.
//
// Layout: a device table of int64, built once for a set of buffers whose
// addresses do not move (the runner's parameters and moments):
//   leaf i: [4i] p, [4i+1] mu, [4i+2] nu (pointers), [4i+3] its element count
//   then [4L + i], i = 0..L: the leaf's first chunk (a prefix sum of
//   ceil(n / CHUNK)), the last entry the number of chunks.
// The gradients, which a captured step allocates anew, come as kernel
// parameters (at most MAX_LEAVES pointers).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int CHUNK = 2048;                  // elements of a leaf a block takes at a time
constexpr int PER = CHUNK / 4 / THREADS;     // float4s a thread takes in a chunk
constexpr int MAX_LEAVES = 256;              // gradients passed by value: 2 KiB
static_assert(CHUNK % (4 * THREADS) == 0, "a chunk is whole float4s of every thread");

struct Grads {
  const float* g[MAX_LEAVES];
};

// float32, as the eager update rounds its Python numbers
struct Scalars {
  float b1, one_minus_b1, b2, one_minus_b2, eps, weight_decay, neg_lr;
  int decay;   // 1: add weight_decay * p (AdamW)
  int lr_col;  // >= 0: -lr is row[lr_col] (a schedule), else neg_lr
};

__device__ __forceinline__ float step(float p, float g, float& m, float& v,
                                      const Scalars& s, float rc1, float rc2,
                                      float neg_lr) {
  m = __fadd_rn(__fmul_rn(s.one_minus_b1, g), __fmul_rn(s.b1, m));
  v = __fadd_rn(__fmul_rn(__fmul_rn(s.one_minus_b2, g), g), __fmul_rn(s.b2, v));
  float u = __fdiv_rn(__fmul_rn(m, rc1), __fadd_rn(__fsqrt_rn(__fmul_rn(v, rc2)), s.eps));
  if (s.decay) u = __fadd_rn(u, __fmul_rn(s.weight_decay, p));
  return __fadd_rn(p, __fmul_rn(neg_lr, u));
}

__device__ __forceinline__ void step4(float4& p, const float4& g, float4& m, float4& v,
                                      const Scalars& s, float rc1, float rc2,
                                      float neg_lr) {
  p.x = step(p.x, g.x, m.x, v.x, s, rc1, rc2, neg_lr);
  p.y = step(p.y, g.y, m.y, v.y, s, rc1, rc2, neg_lr);
  p.z = step(p.z, g.z, m.z, v.z, s, rc1, rc2, neg_lr);
  p.w = step(p.w, g.w, m.w, v.w, s, rc1, rc2, neg_lr);
}

template <typename T>
__device__ __forceinline__ T* ptr(long long bits) {
  return reinterpret_cast<T*>(static_cast<uintptr_t>(bits));
}

__global__ void __launch_bounds__(THREADS)
    adam_kernel(const long long* __restrict__ table, int leaves, int chunks,
                const __grid_constant__ Grads grads, const Scalars s,
                const float* __restrict__ row) {
  const float rc1 = __fdiv_rn(1.0f, row[0]);
  const float rc2 = __fdiv_rn(1.0f, row[1]);
  const float neg_lr = s.lr_col >= 0 ? row[s.lr_col] : s.neg_lr;
  const long long* first = table + 4LL * leaves;
  for (int c = blockIdx.x; c < chunks; c += gridDim.x) {
    int lo = 0, hi = leaves - 1;  // the leaf: the last whose first chunk is <= c
    while (lo < hi) {
      const int mid = (lo + hi + 1) >> 1;
      if (__ldg(first + mid) <= c) lo = mid; else hi = mid - 1;
    }
    const long long* e = table + 4LL * lo;
    float* p = ptr<float>(__ldg(e));
    float* mu = ptr<float>(__ldg(e + 1));
    float* nu = ptr<float>(__ldg(e + 2));
    const long long n = __ldg(e + 3);
    const float* g = grads.g[lo];
    const long long start = (long long)(c - __ldg(first + lo)) * CHUNK;
    const long long end = min(start + (long long)CHUNK, n);
    long long done = start;
    const uintptr_t bits = reinterpret_cast<uintptr_t>(p) | reinterpret_cast<uintptr_t>(g)
                           | reinterpret_cast<uintptr_t>(mu) | reinterpret_cast<uintptr_t>(nu);
    if ((bits & 15) == 0) {
      const long long vend = start + ((end - start) & ~3LL);
      float4 P[PER], G[PER], M[PER], V[PER];
#pragma unroll
      for (int r = 0; r < PER; ++r) {
        const long long j = start + 4LL * (threadIdx.x + r * THREADS);
        if (j < vend) {
          P[r] = *reinterpret_cast<const float4*>(p + j);
          G[r] = *reinterpret_cast<const float4*>(g + j);
          M[r] = *reinterpret_cast<const float4*>(mu + j);
          V[r] = *reinterpret_cast<const float4*>(nu + j);
        }
      }
#pragma unroll
      for (int r = 0; r < PER; ++r) {
        const long long j = start + 4LL * (threadIdx.x + r * THREADS);
        if (j < vend) {
          step4(P[r], G[r], M[r], V[r], s, rc1, rc2, neg_lr);
          *reinterpret_cast<float4*>(p + j) = P[r];
          *reinterpret_cast<float4*>(mu + j) = M[r];
          *reinterpret_cast<float4*>(nu + j) = V[r];
        }
      }
      done = vend;
    }
    for (long long j = done + threadIdx.x; j < end; j += THREADS) {
      float m = mu[j], v = nu[j];
      p[j] = step(p[j], g[j], m, v, s, rc1, rc2, neg_lr);
      mu[j] = m;
      nu[j] = v;
    }
  }
}

// blocks the card keeps resident at once, by device (asked once, at a
// device's first launch: that is an eager step, never inside a capture)
int grid_cap(int device) {
  static int cap[64] = {0};
  if (device < 0 || device >= 64) return 132;
  if (cap[device] == 0) {
    int sms = 0, per_sm = 0;
    if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) != cudaSuccess
        || cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, adam_kernel, THREADS, 0)
               != cudaSuccess
        || sms <= 0 || per_sm <= 0) {
      cudaGetLastError();  // clear it: the launch below reports its own
      return 132;
    }
    cap[device] = sms * per_sm;
  }
  return cap[device];
}

}  // namespace

extern "C" {

// One launch of the fused update over `leaves` leaves: `table` as above
// (device, int64), `grads` a host array of the leaves' gradient pointers in
// table order, `chunks` the table's chunk count for `chunk` elements a chunk
// (must be CHUNK: the caller's layout and the kernel's agree), `row` the
// device row whose [0] and [1] are c1 and c2 (and [lr_col] is -lr when
// lr_col >= 0).  Every tensor float32, contiguous, on the current device.
// Launches on `stream` (a cudaStream_t) and returns the cudaError_t of the
// launch (0 on success).  Does not synchronise and allocates nothing.
int kgcn_adam(const void* table, const void* const* grads, int leaves, int chunks,
              int chunk, const void* row, float b1, float one_minus_b1, float b2,
              float one_minus_b2, float eps, float weight_decay, int decay, float neg_lr,
              int lr_col, void* stream) {
  if (leaves <= 0 || chunks <= 0) return 0;
  if (leaves > MAX_LEAVES || chunk != CHUNK) return (int)cudaErrorInvalidValue;
  Grads gs{};
  for (int i = 0; i < leaves; ++i) gs.g[i] = static_cast<const float*>(grads[i]);
  const Scalars s{b1, one_minus_b1, b2, one_minus_b2, eps, weight_decay, neg_lr,
                  decay, lr_col};
  int device = 0;
  cudaGetDevice(&device);
  const int grid = chunks < grid_cap(device) ? chunks : grid_cap(device);
  adam_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const long long*>(table), leaves, chunks, gs, s,
      static_cast<const float*>(row));
  return (int)cudaGetLastError();
}

const char* kgcn_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
