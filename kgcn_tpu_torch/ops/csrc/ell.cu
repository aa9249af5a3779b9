// ELL gather SpMM for Hopper (sm_90a), on padded per-row neighbour lists.
//
//   out[v, :] = sum_{k = 0}^{K-1} w[v, k] * x[idx[v, k], :]
//   idx [V, K] int32, w [V, K] float32, x [N, F] float32 or bf16
//   -> out [V, F] in x's dtype; every array row-major and contiguous.
//
// Replaces the Pallas TPU kernel `_ell_kernel`
// (kgcn_tpu/ops/pallas_spmm.py:30, launched by `spmm_ell_pallas`).  The TPU
// kernel keeps ALL of x in VMEM and gathers rows of it there, because Mosaic
// cannot gather rows from HBM; that caps x at the VMEM budget and needs a
// compile probe.  Here every row of x is read from device memory (or L2,
// where x fits its 50 MB), so the kernel takes every size.  What is kept is
// the arithmetic: the weight stays f32, x is widened to f32, the sum runs
// in f32 in slot order k = 0 .. K-1, and the row is written once in x's
// dtype.
//
// What bounds it: a slot moves one F-wide row of x (4F bytes in f32) for 2F
// FLOP, so the work is memory- and latency-bound.  The least it must move is
// each input once and the output once (V*K*8 + 2*V*F*4 bytes); a gather
// reads x once per slot instead, from L2 where rows repeat, so several times
// the bound is the expectation.  The design is simple and deterministic:
//
//   * LPR lanes own one output row (32 when a row needs more than 16
//     VEC-wide lanes, else 4, 8 or 16, so a warp covers 32 / LPR rows and
//     few lanes idle on a 3-wide row); each lane owns VEC consecutive columns per
//     pass (float4, float2 or one float; bf16x2 or one bf16), so a row's
//     lanes read x[idx[v, k], :] with coalesced, vectorised loads;
//   * the row's lanes load LPR of its (idx, w) slots at a time, one each,
//     and hand them round with __shfl_sync; for 4 slots at a time they issue
//     the 4 row loads before adding any, then add them in slot order;
//   * padding slots (weight 0, index 0) are skipped: they would add 0 * x[0],
//     which changes nothing for finite x (a NaN or inf in row 0 would not
//     spread through them, where the plain version's einsum spreads it);
//   * no atomics and no reduction across threads: each output element is
//     one lane's sum, written once.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int UNROLL = 4;  // row loads in flight per lane, in slot order
constexpr unsigned FULL = 0xffffffffu;

template <int VEC>
__device__ __forceinline__ void load_row(const float* __restrict__ p, float* v) {
  if constexpr (VEC == 4) {
    const float4 t = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
  } else if constexpr (VEC == 2) {
    const float2 t = __ldg(reinterpret_cast<const float2*>(p));
    v[0] = t.x; v[1] = t.y;
  } else {
    v[0] = __ldg(p);
  }
}

template <int VEC>
__device__ __forceinline__ void load_row(const __nv_bfloat16* __restrict__ p,
                                         float* v) {
  if constexpr (VEC == 2) {
    const float2 t = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
    v[0] = t.x; v[1] = t.y;
  } else {
    v[0] = __bfloat162float(p[0]);
  }
}

template <int VEC>
__device__ __forceinline__ void store_row(float* p, const float* v) {
  if constexpr (VEC == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else if constexpr (VEC == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  } else {
    p[0] = v[0];
  }
}

template <int VEC>
__device__ __forceinline__ void store_row(__nv_bfloat16* p, const float* v) {
  if constexpr (VEC == 2) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v[0], v[1]);
  } else {
    p[0] = __float2bfloat16_rn(v[0]);
  }
}

template <typename T, int LPR, int VEC>
__global__ void __launch_bounds__(THREADS)
ell_spmm_kernel(const int* __restrict__ idx, const float* __restrict__ w,
                const T* __restrict__ x, T* __restrict__ out, int V, int K,
                int F) {
  constexpr int RPW = 32 / LPR;  // output rows a warp
  const int lane = threadIdx.x & 31;
  const int l = lane % LPR;      // lane within the row
  const long long warp = (long long)blockIdx.x * WARPS + (threadIdx.x >> 5);
  const long long v = warp * RPW + lane / LPR;
  const bool row_ok = v < V;
  const long long slot0 = v * K;
  // every lane runs the same trip counts (the shuffles need the whole warp)
  const int passes = (F + LPR * VEC - 1) / (LPR * VEC);
  for (int p = 0; p < passes; ++p) {
    const int f0 = (p * LPR + l) * VEC;
    const bool col_ok = row_ok && f0 < F;
    float acc[VEC];
#pragma unroll
    for (int i = 0; i < VEC; ++i) acc[i] = 0.f;
    for (int k0 = 0; k0 < K; k0 += LPR) {
      int my_s = 0;
      float my_w = 0.f;  // slots past K read as padding
      if (row_ok && k0 + l < K) {
        my_s = __ldg(idx + slot0 + k0 + l);
        my_w = __ldg(w + slot0 + k0 + l);
      }
      const int kn = min(LPR, K - k0);
      for (int j0 = 0; j0 < kn; j0 += UNROLL) {
        float rows[UNROLL][VEC];
        float ws[UNROLL];
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
          // j0 + u < LPR: kn <= LPR and LPR is a multiple of UNROLL
          const int s = __shfl_sync(FULL, my_s, j0 + u, LPR);
          ws[u] = __shfl_sync(FULL, my_w, j0 + u, LPR);
          if (col_ok && ws[u] != 0.f) {
            load_row<VEC>(x + (long long)s * F + f0, rows[u]);
          } else {
#pragma unroll
            for (int i = 0; i < VEC; ++i) rows[u][i] = 0.f;
          }
        }
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
          if (ws[u] != 0.f) {
#pragma unroll
            for (int i = 0; i < VEC; ++i) acc[i] = fmaf(ws[u], rows[u][i], acc[i]);
          }
        }
      }
    }
    if (col_ok) store_row<VEC>(out + v * F + f0, acc);
  }
}

template <typename T, int LPR, int VEC>
cudaError_t launch(const int* idx, const float* w, const T* x, T* out, int V,
                   int K, int F, cudaStream_t stream) {
  constexpr int RPW = 32 / LPR;
  const long long warps = ((long long)V + RPW - 1) / RPW;
  const long long blocks = (warps + WARPS - 1) / WARPS;  // V < 2^31: fits
  ell_spmm_kernel<T, LPR, VEC><<<(unsigned)blocks, THREADS, 0, stream>>>(
      idx, w, x, out, V, K, F);
  return cudaGetLastError();
}

// The narrowest row group whose VEC-wide lanes cover F in one pass (at
// least 4 lanes, so UNROLL divides it), else the whole warp.
template <typename T, int VEC>
cudaError_t dispatch_lpr(const int* idx, const float* w, const T* x, T* out,
                         int V, int K, int F, cudaStream_t stream) {
  const int lanes = (F + VEC - 1) / VEC;
  if (lanes <= 4) return launch<T, 4, VEC>(idx, w, x, out, V, K, F, stream);
  if (lanes <= 8) return launch<T, 8, VEC>(idx, w, x, out, V, K, F, stream);
  if (lanes <= 16) return launch<T, 16, VEC>(idx, w, x, out, V, K, F, stream);
  return launch<T, 32, VEC>(idx, w, x, out, V, K, F, stream);
}

}  // namespace

extern "C" {

// out [V, F] = the ELL product of idx/w [V, K] and x [N, F], float32.
// Every idx entry must lie in [0, N).  Launches on `stream` (a
// cudaStream_t); returns the cudaError_t of the launch (0 on success).  Does
// not synchronise and allocates nothing.  The pointers must be 16-byte
// aligned (PyTorch's allocations are).
int kgcn_ell_spmm_f32(const void* idx, const void* w, const void* x, void* out,
                      int V, int K, int F, void* stream) {
  if (V <= 0 || F <= 0) return 0;
  if (K <= 0) return (int)cudaErrorInvalidValue;
  auto i = static_cast<const int*>(idx);
  auto ww = static_cast<const float*>(w);
  auto xx = static_cast<const float*>(x);
  auto o = static_cast<float*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  if (F % 4 == 0) return (int)dispatch_lpr<float, 4>(i, ww, xx, o, V, K, F, s);
  if (F % 2 == 0) return (int)dispatch_lpr<float, 2>(i, ww, xx, o, V, K, F, s);
  return (int)dispatch_lpr<float, 1>(i, ww, xx, o, V, K, F, s);
}

// The same with x and out in bf16 (the sum still runs in f32).
int kgcn_ell_spmm_bf16(const void* idx, const void* w, const void* x, void* out,
                       int V, int K, int F, void* stream) {
  if (V <= 0 || F <= 0) return 0;
  if (K <= 0) return (int)cudaErrorInvalidValue;
  auto i = static_cast<const int*>(idx);
  auto ww = static_cast<const float*>(w);
  auto xx = static_cast<const __nv_bfloat16*>(x);
  auto o = static_cast<__nv_bfloat16*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  if (F % 2 == 0) return (int)dispatch_lpr<__nv_bfloat16, 2>(i, ww, xx, o, V, K, F, s);
  return (int)dispatch_lpr<__nv_bfloat16, 1>(i, ww, xx, o, V, K, F, s);
}

const char* kgcn_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
