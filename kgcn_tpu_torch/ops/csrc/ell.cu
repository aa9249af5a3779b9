// ELL product for Hopper (sm_90a): the forward gather, fused over the
// channels, and its transpose (dx) over sender-grouped slot lists.
//
//   forward: out[v, :] = sum_c sum_k w[c, v, k] * x_c[idx[c, v, k], :]
//            idx [C, V, K] int32, w [C, V, K] float32, x_c the channel's
//            [N, F] slice of x [C, N, F], or x [N, F] shared by every
//            channel -> out [V, F] in x's dtype
//   dx:      dx_c[u, :] = sum_{j in T_c(u)} w[c, s_j] * g[s_j / K, :]
//            T_c(u) = [off[c, u], off[c, u + 1]): the flat forward slots
//            s = v*K + k of channel c whose sender idx[c, v, k] is u,
//            in increasing (v, k) order; g [V, F] the cotangent of out
//            -> dx [N, F] = sum_c dx_c (shared x) or [C, N, F]
//   Every array row-major and contiguous.
//
// Replaces the Pallas TPU kernel `_ell_kernel` (kgcn_tpu/ops/pallas_spmm.py:30,
// launched by `spmm_ell_pallas`) and, on the card, the segment sum of its
// custom VJP (`_spmm_ell_ad_bwd`, pallas_spmm.py:120-129).  The TPU kernel
// keeps ALL of x in VMEM and gathers rows there, because Mosaic cannot
// gather rows from HBM; that caps x at the VMEM budget.  Here every row is
// read from device memory or L2, so the kernel takes every size.  Kept from
// the TPU kernel: the weight stays f32, x is widened to f32, a channel's
// sum runs in f32 in slot order k = 0 .. K-1, and the row is written once
// in x's dtype.
//
// What bounds it: a slot moves one F-wide row (4F bytes in f32) for 2F
// FLOP, so the work is memory- and latency-bound.  The least it must move
// is each input once and the output once; a gather reads a row once per
// slot instead, from L2 where rows repeat.  At the training path's shape (a
// batch of 25 ring graphs: V 150, K 5) a call is the ~1.5 us launch floor,
// so what the design saves there is launches:
//
//   * one forward launch for all C channels: a channel's sum is kept in its
//     own f32 accumulator, and the channels are added into the row in
//     channel order, so the result has the bits of the per-channel products
//     summed as o_0 + o_1 + ... in f32 (the earlier one launch per channel);
//   * dx as one launch with no atomics: the slot lists grouped by sender are
//     built on the host with the batch (ops/ell.ell_transpose), or on the
//     card by a stable sort for the COO entry, so each dx row is one lane
//     group's sum in the order of the reference's segment sum (and of the
//     CPU's index_add_); the products and sums are rounded separately, as
//     index_add_ rounds them, and the channels' dx are added in channel
//     order.  Two launches give the same bits.
//
// At scale (V 10^5, K 10, F 128: x is 51 MB in f32, just over the 50 MB L2)
// the slot indices, weights and the output stream past the caches
// (evict-first loads and stores), so that the gathered rows keep L2; each
// lane keeps up to 8 gathered rows in flight.  TMA has no row gather on
// Hopper, so the design works through L2 and loads in flight.  An L2
// evict-last policy on the gathered rows (createpolicy, ld.global.L2::
// cache_hint) was measured on the H100 and made both kernels slower at
// this scale (x does not fit L2 whole, so its lines evict each other), so
// the rows take the plain read-only path.
//
// Layout: LPR lanes own one output row (32 when a row needs more than 16
// VEC-wide lanes, else 4, 8 or 16, so that few lanes idle on a narrow row);
// each lane owns VEC consecutive columns per pass (float4, float2 or one
// float; bf16x2 or one bf16), so a row's lanes gather a source row with
// coalesced, vectorised loads.  The row's lanes load STEP of its slots'
// (index, weight) at a time, a few each, and hand them round with
// __shfl_sync.  Padding slots (weight 0) are skipped: they would add
// 0 * x[0], which changes nothing for finite x.  No reduction crosses lanes,
// and each output element is written once.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
// gathered rows in flight per lane, in slot order: 8 in the forward, 4 in
// dx, whose rows (senders) have uneven lengths that the warp walks to the
// longest
constexpr int UNROLL_FWD = 8, UNROLL_DX = 4;
constexpr unsigned FULL = 0xffffffffu;

// VEC columns of a gathered row, through the read-only path (rows repeat
// across slots, so they stay cacheable, unlike the streamed slot data).
template <int VEC>
__device__ __forceinline__ void load_row(const float* p, float* v) {
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
__device__ __forceinline__ void load_row(const __nv_bfloat16* p, float* v) {
  if constexpr (VEC == 2) {
    const float2 t = __bfloat1622float2(__ldg(reinterpret_cast<const __nv_bfloat162*>(p)));
    v[0] = t.x; v[1] = t.y;
  } else {
    v[0] = __bfloat162float(__ldg(p));
  }
}

// the row's VEC columns, written once, streaming (evict-first)
template <int VEC>
__device__ __forceinline__ void store_row(float* p, const float* v) {
  if constexpr (VEC == 4) {
    __stcs(reinterpret_cast<float4*>(p), make_float4(v[0], v[1], v[2], v[3]));
  } else if constexpr (VEC == 2) {
    __stcs(reinterpret_cast<float2*>(p), make_float2(v[0], v[1]));
  } else {
    __stcs(p, v[0]);
  }
}

template <int VEC>
__device__ __forceinline__ void store_row(__nv_bfloat16* p, const float* v) {
  if constexpr (VEC == 2) {
    const unsigned int lo = __bfloat16_as_ushort(__float2bfloat16_rn(v[0]));
    const unsigned int hi = __bfloat16_as_ushort(__float2bfloat16_rn(v[1]));
    __stcs(reinterpret_cast<unsigned int*>(p), lo | (hi << 16));
  } else {
    __stcs(reinterpret_cast<unsigned short*>(p),
           __bfloat16_as_ushort(__float2bfloat16_rn(v[0])));
  }
}

// DX = false, the forward: `ids` is idx [C, V, K]; row v of channel c has
// the K slots c*V*K + v*K + k, each gathering src_c[idx] with weight w.
// DX = true: `ids` is the slot list and `off` its offsets [C, rows + 1];
// row u of channel c has the entries [off[c, u], off[c, u + 1]), each a
// flat forward slot s gathering src_c[s / K] with weight w[c, s].
// Block row blockIdx.y sums the channels [y*csum, (y+1)*csum) in channel
// order into out + y*out_cstride.  ONE: csum is 1, known to the compiler
// (a loop over a run-time count of one channel made the one-channel
// forward measurably slower at the path's shape).
template <typename T, int LPR, int VEC, bool DX, bool ONE>
__global__ void __launch_bounds__(THREADS)
ell_kernel(const int* __restrict__ ids, const int* __restrict__ off,
           const float* __restrict__ w, const T* __restrict__ src,
           T* __restrict__ out, int rows, int K, int F, int csum,
           long long src_cstride, long long out_cstride, long long vk) {
  constexpr int UNROLL = DX ? UNROLL_DX : UNROLL_FWD;
  constexpr int RPW = 32 / LPR;                       // output rows a warp
  constexpr int SPL = LPR >= UNROLL ? 1 : UNROLL / LPR;  // slots a lane loads a step
  constexpr int STEP = LPR * SPL;                     // a multiple of UNROLL
  const int lane = threadIdx.x & 31;
  const int l = lane % LPR;  // lane within the row
  const long long warp = (long long)blockIdx.x * WARPS + (threadIdx.x >> 5);
  const long long v = warp * RPW + lane / LPR;
  const bool row_ok = v < rows;
  out += blockIdx.y * out_cstride;
  // every lane runs the same trip counts (the shuffles need the whole warp)
  const int passes = (F + LPR * VEC - 1) / (LPR * VEC);
  for (int p = 0; p < passes; ++p) {
    const int f0 = (p * LPR + l) * VEC;
    const bool col_ok = row_ok && f0 < F;
    float tot[VEC];
    for (int ci = 0; ci < (ONE ? 1 : csum); ++ci) {
      const int c = blockIdx.y * csum + ci;
      long long lo = 0;  // the row's first slot (forward) or entry (dx)
      int deg = 0;
      if (DX) {
        if (row_ok) {
          const int* o = off + (long long)c * (rows + 1) + v;
          lo = __ldcs(o);
          deg = __ldcs(o + 1) - (int)lo;
        }
      } else if (row_ok) {
        lo = c * vk + v * K;
        deg = K;
      }
      const int steps = DX ? __reduce_max_sync(FULL, deg) : K;  // warp-uniform
      const T* xs = src + c * src_cstride;
      const float* wc = w + c * vk;
      float acc[VEC];
#pragma unroll
      for (int i = 0; i < VEC; ++i) acc[i] = 0.f;
      for (int k0 = 0; k0 < steps; k0 += STEP) {
        int my_s[SPL];
        float my_w[SPL];  // slots past the row's end read as padding
#pragma unroll
        for (int q = 0; q < SPL; ++q) {
          const int j = k0 + q * LPR + l;
          my_s[q] = 0;
          my_w[q] = 0.f;
          if (j < deg) {
            const int s = __ldcs(ids + lo + j);
            if (DX) {
              my_w[q] = __ldcs(wc + s);
              my_s[q] = s / K;
            } else {
              my_w[q] = __ldcs(w + lo + j);
              my_s[q] = s;
            }
          }
        }
        // not unrolled: one batch of code whatever STEP (a kernel of a few
        // microseconds pays for every instruction it fetches); with SPL > 1
        // STEP == UNROLL, so j0 is 0 and my_s's index a constant
#pragma unroll 1
        for (int j0 = 0; j0 < STEP && k0 + j0 < steps; j0 += UNROLL) {  // warp-uniform
          {
            float rowv[UNROLL][VEC];
            float ws[UNROLL];
#pragma unroll
            for (int u = 0; u < UNROLL; ++u) {
              const int j = j0 + u;
              const int q = SPL == 1 ? 0 : j / LPR;
              const int s = __shfl_sync(FULL, my_s[q], j % LPR, LPR);
              ws[u] = __shfl_sync(FULL, my_w[q], j % LPR, LPR);
              if (col_ok && ws[u] != 0.f) {
                load_row<VEC>(xs + (long long)s * F + f0, rowv[u]);
              } else {
#pragma unroll
                for (int i = 0; i < VEC; ++i) rowv[u][i] = 0.f;
              }
            }
#pragma unroll
            for (int u = 0; u < UNROLL; ++u) {
              if (ws[u] != 0.f) {
#pragma unroll
                for (int i = 0; i < VEC; ++i) {
                  // dx: product and sum rounded apart (index_add_'s order)
                  acc[i] = DX ? __fadd_rn(acc[i], __fmul_rn(ws[u], rowv[u][i]))
                              : fmaf(ws[u], rowv[u][i], acc[i]);
                }
              }
            }
          }
        }
      }
#pragma unroll
      for (int i = 0; i < VEC; ++i) tot[i] = ci == 0 ? acc[i] : __fadd_rn(tot[i], acc[i]);
    }
    if (col_ok) store_row<VEC>(out + v * F + f0, tot);
  }
}

template <typename T, int LPR, int VEC, bool DX>
cudaError_t launch(const int* ids, const int* off, const float* w, const T* src, T* out,
                   int rows, int K, int F, int csum, int groups, long long src_cstride,
                   long long out_cstride, long long vk, cudaStream_t stream) {
  constexpr int RPW = 32 / LPR;
  const long long warps = ((long long)rows + RPW - 1) / RPW;
  const long long blocks = (warps + WARPS - 1) / WARPS;  // rows < 2^31: fits
  const dim3 grid((unsigned)blocks, (unsigned)groups);
  if (csum == 1)
    ell_kernel<T, LPR, VEC, DX, true><<<grid, THREADS, 0, stream>>>(
        ids, off, w, src, out, rows, K, F, csum, src_cstride, out_cstride, vk);
  else
    ell_kernel<T, LPR, VEC, DX, false><<<grid, THREADS, 0, stream>>>(
        ids, off, w, src, out, rows, K, F, csum, src_cstride, out_cstride, vk);
  return cudaGetLastError();
}

// The narrowest row group whose VEC-wide lanes cover F in one pass (at
// least 4 lanes), else the whole warp.
template <typename T, int VEC, bool DX>
cudaError_t dispatch_lpr(const int* ids, const int* off, const float* w, const T* src,
                         T* out, int rows, int K, int F, int csum, int groups,
                         long long src_cstride, long long out_cstride, long long vk,
                         cudaStream_t s) {
  const int lanes = (F + VEC - 1) / VEC;
  if (lanes <= 4)
    return launch<T, 4, VEC, DX>(ids, off, w, src, out, rows, K, F, csum, groups,
                                 src_cstride, out_cstride, vk, s);
  if (lanes <= 8)
    return launch<T, 8, VEC, DX>(ids, off, w, src, out, rows, K, F, csum, groups,
                                 src_cstride, out_cstride, vk, s);
  if (lanes <= 16)
    return launch<T, 16, VEC, DX>(ids, off, w, src, out, rows, K, F, csum, groups,
                                  src_cstride, out_cstride, vk, s);
  return launch<T, 32, VEC, DX>(ids, off, w, src, out, rows, K, F, csum, groups,
                                src_cstride, out_cstride, vk, s);
}

template <bool DX>
cudaError_t dispatch(const void* ids, const void* off, const void* w, const void* src,
                     void* out, int rows, int K, int F, int csum, int groups,
                     long long src_cstride, long long out_cstride, long long vk,
                     int bf16, void* stream) {
  auto i = static_cast<const int*>(ids);
  auto o = static_cast<const int*>(off);
  auto ww = static_cast<const float*>(w);
  auto s = static_cast<cudaStream_t>(stream);
  if (bf16) {
    auto x = static_cast<const __nv_bfloat16*>(src);
    auto y = static_cast<__nv_bfloat16*>(out);
    if (F % 2 == 0)
      return dispatch_lpr<__nv_bfloat16, 2, DX>(i, o, ww, x, y, rows, K, F, csum, groups,
                                                src_cstride, out_cstride, vk, s);
    return dispatch_lpr<__nv_bfloat16, 1, DX>(i, o, ww, x, y, rows, K, F, csum, groups,
                                              src_cstride, out_cstride, vk, s);
  }
  auto x = static_cast<const float*>(src);
  auto y = static_cast<float*>(out);
  if (F % 4 == 0)
    return dispatch_lpr<float, 4, DX>(i, o, ww, x, y, rows, K, F, csum, groups,
                                      src_cstride, out_cstride, vk, s);
  if (F % 2 == 0)
    return dispatch_lpr<float, 2, DX>(i, o, ww, x, y, rows, K, F, csum, groups,
                                      src_cstride, out_cstride, vk, s);
  return dispatch_lpr<float, 1, DX>(i, o, ww, x, y, rows, K, F, csum, groups, src_cstride,
                                    out_cstride, vk, s);
}

}  // namespace

extern "C" {

// out [V, F] = sum over the C channels of the ELL products of idx/w
// [C, V, K] and x: [C, N, F] (shared = 0) or [N, F] (shared = 1), float32
// (bf16 = 0) or bf16 (bf16 = 1; out in the same dtype, sums in f32).  Every
// idx entry must lie in [0, N).  Launches on `stream` (a cudaStream_t) and
// returns the cudaError_t of the launch (0 on success).  Does not
// synchronise and allocates nothing.  The pointers must be 16-byte aligned
// (PyTorch's allocations are).
int kgcn_ell_spmm(const void* idx, const void* w, const void* x, void* out, int C, int V,
                  int K, int N, int F, int shared, int bf16, void* stream) {
  if (V <= 0 || F <= 0) return 0;
  if (K <= 0 || C <= 0) return (int)cudaErrorInvalidValue;
  return (int)dispatch<false>(idx, nullptr, w, x, out, V, K, F, C, 1,
                              shared ? 0 : (long long)N * F, 0, (long long)V * K, bf16,
                              stream);
}

// The transpose: dx from g [V, F] (x's dtype) over the slot lists grouped by
// sender, `slots` (flat forward slot ids v*K + k of real slots) with
// `offsets` [C, N + 1] (absolute positions in `slots`), and the forward's
// w [C, V, K].  shared = 1: dx [N, F], the channels' dx added in channel
// order; shared = 0: dx [C, N, F].  Same conventions as kgcn_ell_spmm.
int kgcn_ell_dx(const void* slots, const void* offsets, const void* w, const void* g,
                void* dx, int C, int V, int K, int N, int F, int shared, int bf16,
                void* stream) {
  if (N <= 0 || F <= 0) return 0;
  if (K <= 0 || C <= 0) return (int)cudaErrorInvalidValue;
  return (int)dispatch<true>(slots, offsets, w, g, dx, N, K, F, shared ? C : 1,
                             shared ? 1 : C, 0, shared ? 0 : (long long)N * F,
                             (long long)V * K, bf16, stream);
}

const char* kgcn_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
