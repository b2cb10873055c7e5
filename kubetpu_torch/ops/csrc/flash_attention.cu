// Flash attention for Hopper (sm_90a): forward, dQ and dK/dV kernels, with a
// plain C interface for ctypes.
//
// Replaces the TPU kernels of kubetpu/ops/flash_attention.py:
//   flash_fwd_wgmma_kernel, flash_fwd_kernel
//                        <- _flash_kernel          (pallas_call in _flash_forward)
//   flash_bwd_dq_wgmma_kernel, flash_bwd_dq_kernel
//                        <- _flash_bwd_dq_kernel   (pallas_call in _flash_backward)
//   flash_bwd_dkv_wgmma_kernel, flash_bwd_dkv_kernel
//                        <- _flash_bwd_dkv_kernel  (pallas_call in _flash_backward)
// and computes the same functions. q, k, v, out, dO, dq, dk and dv are
// (B, S, H, D) in one dtype (f32, f16 or bf16; K/V already expanded to H
// heads); lse and delta = rowsum(dO * O) are (B*H, S) f32. Key k is visible
// to row r iff k < S and, when causal, k <= r and (window == 0 or
// r - k < window). The forward masks scores to -1e30, keeps the online max /
// normalizer / accumulator and writes out = acc / l and lse = m + log(l).
// The backward recomputes P = exp(min(s * scale - lse, 0)) on visible keys
// (the clamp bounds ring attention's invisible steps),
// dS = P * (dO V^T - delta), dQ = dS K * scale, dK = dS^T Q * scale and
// dV = P^T dO. Outputs are stored in the input dtype.
//
// What bounds it on an H100: operations. At B=4, S=2048, H=16, D=128 causal
// the forward does 2 products over the causal half (~69 GFLOP, ~0.07 ms at
// the 989 TFLOP/s bf16 tensor-core rate) against ~134 MB of q/k/v/o
// (~0.04 ms at 3.35 TB/s); dQ recomputes 3 products and dK/dV 4. Only the
// tensor cores (wgmma) come near that rate; f32 CUDA-core math tops out
// below 67 TFLOP/s.
//
// Common to every kernel. The Pallas grids walked key blocks (forward, dQ)
// or query blocks (dK/dV) as a sequential axis; GPU blocks share no state,
// so each CUDA block owns one (batch*head, row tile) and loops over the
// tiles its rows can see: causal tiles up to the diagonal, from the first
// tile inside the band when windowed, every tile when non-causal. The
// backward keeps the JAX package's two kernels — dQ per query tile, dK/dV
// per key tile — so no atomics are needed and the gradients are
// deterministic. The ragged last tile is masked (rows past S load zeros and
// are not stored; keys past S are invisible).
//
// Two routes, chosen by the wrapper (flash_attention.py::_route) and passed
// in as `route`; a route that cannot take a call refuses it:
//
// wgmma (all three kernels; f16 and bf16 at D = 64 or 128). Products run on
// the tensor cores as wgmma.mma_async m64nNk16 with 16-bit operands and f32
// sums (hopper.cuh), as the TPU's default one-pass bf16 dot does: P (and dS
// in dK/dV) are rounded to the input dtype before their second product, dQ
// carries dS as two 16-bit terms; the softmax, lse, clamp, masks and delta
// stay f32. Tiles arrive by cp.async in
// 128-byte-swizzled 16-byte chunks (zero-filled past S), two stages deep,
// so the next tile loads while this one is used. A block is two
// warpgroups, each owning 64 rows of the block's tile. The forward
// (128 query rows, 64-key tiles): S = Q K^T as an SS wgmma, the online
// softmax in base 2 on the accumulator fragment (scale * log2 e applied to
// the f32 scores, never folded into 16-bit Q), P packed into the A-operand
// registers of O += P V (RS wgmma, V read MN-major); row reductions are two
// lane shuffles. dQ has the forward's shape (128 query rows, Q and dO
// loaded once, 64-key K/V tiles): S = Q K^T and dP = dO V^T (SS, one commit
// group), dS = P (dP - delta) packed in place as two 16-bit terms (hi, and
// the rest: the ring's clamped P makes |dS| large), dQ += dS K (RS, K
// MN-major).
// dK/dV (128 keys, 64-row query tiles) computes the
// transposed products, M = keys: S^T = K Q^T, dP^T = V dO^T (SS), and
// dV += P^T dO, dK += dS^T Q (RS, dO and Q read MN-major), so P^T and dS^T
// never pass through shared memory; lse and delta of the query tile are
// staged beside it. Only tiles that cross the diagonal, the band's edge or
// S are masked; a warpgroup skips tiles none of its rows or keys see;
// causal forward and dQ blocks launch longest first.
//
// SIMT (f32 — TF32 stays off for parity — and the head dims 16 and 256).
// Tiles are staged in shared memory as f32 (rows padded to D + 1
// floats, so the 16 lanes of a half-warp that read 16 different rows hit 16
// banks); 256 threads form a 16 x 16 grid, each thread owning a
// (TILE/16) x (TILE/16) patch of the score tile and (TILE/16) x ceil(D/16)
// accumulators in registers. The forward scales q before the product. All
// math is f32 on CUDA cores.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "hopper.cuh"

namespace {

constexpr float NEG_INF = -1e30f;   // the Pallas kernels' mask value
constexpr int NT = 256;             // threads per block: a 16 x 16 grid
constexpr int MAX_D = 256;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__half x) { return __half2float(x); }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __half from_f<__half>(float x) {
  return __float2half_rn(x);
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(
    float x) {
  return __float2bfloat16_rn(x);
}

// Reductions over the 16 lanes of a half-warp: the 16 threads that share
// one row of the score tile (tid = ty * 16 + tx).
__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ bool visible(int r, int c, int S, int causal,
                                        int window) {
  if (c >= S) return false;
  if (!causal) return true;
  return c <= r && (window <= 0 || r - c < window);
}

// Stage rows [r0, r0 + n) of one head of a (B, S, H, D) tensor into shared
// memory as f32 rows of stride ld, times mul; rows past S load zeros.
template <typename T>
__device__ __forceinline__ void stage(float* dst, int ld, const T* src,
                                      size_t row_stride, int r0, int n, int S,
                                      int D, float mul) {
  for (int e = threadIdx.x; e < n * D; e += NT) {
    const int r = e / D, d = e - r * D;
    dst[r * ld + d] =
        r0 + r < S ? to_f(src[static_cast<size_t>(r0 + r) * row_stride + d]) * mul
                   : 0.f;
  }
}

// [first tile start, end) of the keys that rows [q0, q0 + BQ) can see.
__device__ __forceinline__ void key_range(int q0, int BQ, int BK, int S,
                                          int causal, int window, int* lo,
                                          int* hi) {
  int first = 0;
  if (causal && window > 0) first = max(0, q0 - (window - 1));
  *lo = (first / BK) * BK;
  *hi = causal ? min(S, q0 + BQ) : S;
}

// ---------------------------------------------------------------- forward

template <typename T, int DPT, int TILE>
__global__ void __launch_bounds__(NT) flash_fwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    T* __restrict__ out, float* __restrict__ lse, int S, int H, int D,
    int causal, int window, float scale) {
  constexpr int BQ = TILE, BK = TILE, TR = TILE / 16, TC = TILE / 16;
  extern __shared__ float smem[];
  const int DP = D + 1, PP = BK + 1;
  float* q_s = smem;                 // BQ x DP, pre-scaled
  float* k_s = q_s + BQ * DP;        // BK x DP
  float* v_s = k_s + BK * DP;        // BK x D
  float* p_s = v_s + BK * D;         // BQ x PP

  const int bh = blockIdx.y, b = bh / H, h = bh - b * H;
  const int q0 = blockIdx.x * BQ;
  const size_t rs = static_cast<size_t>(H) * D;
  const size_t base = (static_cast<size_t>(b) * S * H + h) * D;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;

  stage(q_s, DP, q + base, rs, q0, BQ, S, D, scale);

  float m[TR], l[TR], acc[TR][DPT];
#pragma unroll
  for (int i = 0; i < TR; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DPT; ++j) acc[i][j] = 0.f;
  }

  int k_lo, k_hi;
  key_range(q0, BQ, BK, S, causal, window, &k_lo, &k_hi);
  for (int k0 = k_lo; k0 < k_hi; k0 += BK) {
    __syncthreads();                 // the last tile's readers are done
    stage(k_s, DP, k + base, rs, k0, BK, S, D, 1.f);
    stage(v_s, D, v + base, rs, k0, BK, S, D, 1.f);
    __syncthreads();

    float s[TR][TC];
#pragma unroll
    for (int i = 0; i < TR; ++i)
#pragma unroll
      for (int j = 0; j < TC; ++j) s[i][j] = 0.f;
    for (int d = 0; d < D; ++d) {
      float a[TR], c[TC];
#pragma unroll
      for (int i = 0; i < TR; ++i) a[i] = q_s[(ty + 16 * i) * DP + d];
#pragma unroll
      for (int j = 0; j < TC; ++j) c[j] = k_s[(tx + 16 * j) * DP + d];
#pragma unroll
      for (int i = 0; i < TR; ++i)
#pragma unroll
        for (int j = 0; j < TC; ++j) s[i][j] = fmaf(a[i], c[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < TR; ++i) {
      const int r = q0 + ty + 16 * i;
      bool vis[TC];
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < TC; ++j) {
        vis[j] = visible(r, k0 + tx + 16 * j, S, causal, window);
        if (!vis[j]) s[i][j] = NEG_INF;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max(mx));
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < TC; ++j) {
        const float p = vis[j] ? expf(s[i][j] - m_new) : 0.f;
        sum += p;
        p_s[(ty + 16 * i) * PP + tx + 16 * j] = p;
      }
      const float corr = expf(m[i] - m_new);
      l[i] = l[i] * corr + row_sum(sum);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < DPT; ++j) acc[i][j] *= corr;
    }
    __syncthreads();

    const int nk = min(BK, S - k0);
    for (int kk = 0; kk < nk; ++kk) {
      float vv[DPT];
#pragma unroll
      for (int j = 0; j < DPT; ++j) {
        const int d = tx + 16 * j;
        vv[j] = d < D ? v_s[kk * D + d] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < TR; ++i) {
        const float p = p_s[(ty + 16 * i) * PP + kk];
#pragma unroll
        for (int j = 0; j < DPT; ++j) acc[i][j] = fmaf(p, vv[j], acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < TR; ++i) {
    const int r = q0 + ty + 16 * i;
    if (r >= S) continue;
    T* orow = out + base + static_cast<size_t>(r) * rs;
#pragma unroll
    for (int j = 0; j < DPT; ++j) {
      const int d = tx + 16 * j;
      if (d < D) orow[d] = from_f<T>(acc[i][j] / l[i]);
    }
    if (tx == 0) lse[static_cast<size_t>(bh) * S + r] = m[i] + logf(l[i]);
  }
}

// --------------------------------------------------------------------- dQ

template <typename T, int DPT, int TILE>
__global__ void __launch_bounds__(NT) flash_bwd_dq_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, T* __restrict__ dq, int S, int H, int D,
    int causal, int window, float scale) {
  constexpr int BQ = TILE, BK = TILE, TR = TILE / 16, TC = TILE / 16;
  extern __shared__ float smem[];
  const int DP = D + 1, PP = BK + 1;
  float* q_s = smem;                 // BQ x DP
  float* do_s = q_s + BQ * DP;       // BQ x DP
  float* k_s = do_s + BQ * DP;       // BK x DP
  float* v_s = k_s + BK * DP;        // BK x DP
  float* ds_s = v_s + BK * DP;       // BQ x PP

  const int bh = blockIdx.y, b = bh / H, h = bh - b * H;
  const int q0 = blockIdx.x * BQ;
  const size_t rs = static_cast<size_t>(H) * D;
  const size_t base = (static_cast<size_t>(b) * S * H + h) * D;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;

  stage(q_s, DP, q + base, rs, q0, BQ, S, D, 1.f);
  stage(do_s, DP, dout + base, rs, q0, BQ, S, D, 1.f);
  float lse_r[TR], dl_r[TR], acc[TR][DPT];
#pragma unroll
  for (int i = 0; i < TR; ++i) {
    const int r = q0 + ty + 16 * i;
    lse_r[i] = r < S ? lse[static_cast<size_t>(bh) * S + r] : 0.f;
    dl_r[i] = r < S ? delta[static_cast<size_t>(bh) * S + r] : 0.f;
#pragma unroll
    for (int j = 0; j < DPT; ++j) acc[i][j] = 0.f;
  }

  int k_lo, k_hi;
  key_range(q0, BQ, BK, S, causal, window, &k_lo, &k_hi);
  for (int k0 = k_lo; k0 < k_hi; k0 += BK) {
    __syncthreads();
    stage(k_s, DP, k + base, rs, k0, BK, S, D, 1.f);
    stage(v_s, DP, v + base, rs, k0, BK, S, D, 1.f);
    __syncthreads();

    float s[TR][TC], dp[TR][TC];
#pragma unroll
    for (int i = 0; i < TR; ++i)
#pragma unroll
      for (int j = 0; j < TC; ++j) s[i][j] = dp[i][j] = 0.f;
    for (int d = 0; d < D; ++d) {
      float a[TR], g[TR], kc[TC], vc[TC];
#pragma unroll
      for (int i = 0; i < TR; ++i) {
        a[i] = q_s[(ty + 16 * i) * DP + d];
        g[i] = do_s[(ty + 16 * i) * DP + d];
      }
#pragma unroll
      for (int j = 0; j < TC; ++j) {
        kc[j] = k_s[(tx + 16 * j) * DP + d];
        vc[j] = v_s[(tx + 16 * j) * DP + d];
      }
#pragma unroll
      for (int i = 0; i < TR; ++i)
#pragma unroll
        for (int j = 0; j < TC; ++j) {
          s[i][j] = fmaf(a[i], kc[j], s[i][j]);
          dp[i][j] = fmaf(g[i], vc[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < TR; ++i) {
      const int r = q0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < TC; ++j) {
        const int c = tx + 16 * j;
        const float p = visible(r, k0 + c, S, causal, window)
                            ? expf(fminf(s[i][j] * scale - lse_r[i], 0.f))
                            : 0.f;
        ds_s[(ty + 16 * i) * PP + c] = p * (dp[i][j] - dl_r[i]);
      }
    }
    __syncthreads();

    const int nk = min(BK, S - k0);
    for (int kk = 0; kk < nk; ++kk) {
      float kr[DPT];
#pragma unroll
      for (int j = 0; j < DPT; ++j) {
        const int d = tx + 16 * j;
        kr[j] = d < D ? k_s[kk * DP + d] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < TR; ++i) {
        const float w = ds_s[(ty + 16 * i) * PP + kk];
#pragma unroll
        for (int j = 0; j < DPT; ++j) acc[i][j] = fmaf(w, kr[j], acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < TR; ++i) {
    const int r = q0 + ty + 16 * i;
    if (r >= S) continue;
    T* row = dq + base + static_cast<size_t>(r) * rs;
#pragma unroll
    for (int j = 0; j < DPT; ++j) {
      const int d = tx + 16 * j;
      if (d < D) row[d] = from_f<T>(acc[i][j] * scale);
    }
  }
}

// ------------------------------------------------------------------ dK/dV

template <typename T, int DPT, int TILE>
__global__ void __launch_bounds__(NT) flash_bwd_dkv_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv,
    int S, int H, int D, int causal, int window, float scale) {
  constexpr int BQ = TILE, BK = TILE, TR = TILE / 16, TC = TILE / 16;
  constexpr int TK = TILE / 16;      // key rows per thread in dK / dV
  extern __shared__ float smem[];
  const int DP = D + 1, PP = BK + 1;
  float* k_s = smem;                 // BK x DP
  float* v_s = k_s + BK * DP;        // BK x DP
  float* q_s = v_s + BK * DP;        // BQ x DP
  float* do_s = q_s + BQ * DP;       // BQ x DP
  float* t_s = do_s + BQ * DP;       // BQ x PP: P, then dS
  float* lse_s = t_s + BQ * PP;      // BQ
  float* dl_s = lse_s + BQ;          // BQ

  const int bh = blockIdx.y, b = bh / H, h = bh - b * H;
  const int k0 = blockIdx.x * BK;
  const size_t rs = static_cast<size_t>(H) * D;
  const size_t base = (static_cast<size_t>(b) * S * H + h) * D;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;

  stage(k_s, DP, k + base, rs, k0, BK, S, D, 1.f);
  stage(v_s, DP, v + base, rs, k0, BK, S, D, 1.f);
  float dk_r[TK][DPT], dv_r[TK][DPT];
#pragma unroll
  for (int i = 0; i < TK; ++i)
#pragma unroll
    for (int j = 0; j < DPT; ++j) dk_r[i][j] = dv_r[i][j] = 0.f;

  // query rows that can see keys [k0, k0 + BK): from the diagonal when
  // causal, to the last row inside the band when windowed
  const int lo = causal ? k0 : 0;
  const int hi = causal && window > 0 ? min(S, k0 + BK - 1 + window) : S;
  for (int q0 = (lo / BQ) * BQ; q0 < hi; q0 += BQ) {
    __syncthreads();
    stage(q_s, DP, q + base, rs, q0, BQ, S, D, 1.f);
    stage(do_s, DP, dout + base, rs, q0, BQ, S, D, 1.f);
    for (int r = threadIdx.x; r < BQ; r += NT) {
      const bool in = q0 + r < S;
      lse_s[r] = in ? lse[static_cast<size_t>(bh) * S + q0 + r] : 0.f;
      dl_s[r] = in ? delta[static_cast<size_t>(bh) * S + q0 + r] : 0.f;
    }
    __syncthreads();

    float s[TR][TC], dp[TR][TC];
#pragma unroll
    for (int i = 0; i < TR; ++i)
#pragma unroll
      for (int j = 0; j < TC; ++j) s[i][j] = dp[i][j] = 0.f;
    for (int d = 0; d < D; ++d) {
      float a[TR], g[TR], kc[TC], vc[TC];
#pragma unroll
      for (int i = 0; i < TR; ++i) {
        a[i] = q_s[(ty + 16 * i) * DP + d];
        g[i] = do_s[(ty + 16 * i) * DP + d];
      }
#pragma unroll
      for (int j = 0; j < TC; ++j) {
        kc[j] = k_s[(tx + 16 * j) * DP + d];
        vc[j] = v_s[(tx + 16 * j) * DP + d];
      }
#pragma unroll
      for (int i = 0; i < TR; ++i)
#pragma unroll
        for (int j = 0; j < TC; ++j) {
          s[i][j] = fmaf(a[i], kc[j], s[i][j]);
          dp[i][j] = fmaf(g[i], vc[j], dp[i][j]);
        }
    }
    // P into t_s for dV; dS kept in registers until dV has read P
#pragma unroll
    for (int i = 0; i < TR; ++i) {
      const int rl = ty + 16 * i, r = q0 + rl;
#pragma unroll
      for (int j = 0; j < TC; ++j) {
        const int c = tx + 16 * j;
        const float p = visible(r, k0 + c, S, causal, window)
                            ? expf(fminf(s[i][j] * scale - lse_s[rl], 0.f))
                            : 0.f;
        t_s[rl * PP + c] = p;
        dp[i][j] = p * (dp[i][j] - dl_s[rl]);
      }
    }
    __syncthreads();

    const int nq = min(BQ, S - q0);
    for (int r = 0; r < nq; ++r) {      // dV += P^T dO
      float g[DPT];
#pragma unroll
      for (int j = 0; j < DPT; ++j) {
        const int d = tx + 16 * j;
        g[j] = d < D ? do_s[r * DP + d] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < TK; ++i) {
        const float p = t_s[r * PP + ty + 16 * i];
#pragma unroll
        for (int j = 0; j < DPT; ++j) dv_r[i][j] = fmaf(p, g[j], dv_r[i][j]);
      }
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < TR; ++i)
#pragma unroll
      for (int j = 0; j < TC; ++j)
        t_s[(ty + 16 * i) * PP + tx + 16 * j] = dp[i][j];
    __syncthreads();
    for (int r = 0; r < nq; ++r) {      // dK += dS^T Q
      float a[DPT];
#pragma unroll
      for (int j = 0; j < DPT; ++j) {
        const int d = tx + 16 * j;
        a[j] = d < D ? q_s[r * DP + d] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < TK; ++i) {
        const float w = t_s[r * PP + ty + 16 * i];
#pragma unroll
        for (int j = 0; j < DPT; ++j) dk_r[i][j] = fmaf(w, a[j], dk_r[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < TK; ++i) {
    const int c = k0 + ty + 16 * i;
    if (c >= S) continue;
    T* krow = dk + base + static_cast<size_t>(c) * rs;
    T* vrow = dv + base + static_cast<size_t>(c) * rs;
#pragma unroll
    for (int j = 0; j < DPT; ++j) {
      const int d = tx + 16 * j;
      if (d < D) {
        krow[d] = from_f<T>(dk_r[i][j] * scale);
        vrow[d] = from_f<T>(dv_r[i][j]);
      }
    }
  }
}

// ------------------------------------------- forward on the tensor cores

constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;
constexpr int WG_NT = 256;          // two consumer warpgroups a block

enum Kind { FWD = 0, DQ = 1, DKV = 2 };

// Tile sizes and shared memory of the wgmma instances: the forward holds a
// 128-row query tile and two stages of 64-row K and V tiles; dQ holds the
// 128-row Q and dO tiles and two stages of 64-row K and V tiles; dK/dV
// holds a 128-row K and V tile and two stages of 64-row Q and dO tiles with
// their lse and delta rows. 1024 bytes of slack align the swizzled boxes.
constexpr int FWD_BQ = 128, FWD_BK = 64, DKV_BK = 128, DKV_BQ = 64;

constexpr size_t wgmma_smem_bytes(Kind kind, int D) {
  return kind == FWD  ? (size_t)(FWD_BQ + 4 * FWD_BK) * D * 2 + 1024
         : kind == DQ ? (size_t)(2 * FWD_BQ + 4 * FWD_BK) * D * 2 + 1024
                      : (size_t)(2 * DKV_BK + 4 * DKV_BQ) * D * 2 +
                            4 * DKV_BQ * sizeof(float) + 1024;
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

template <typename T>
__device__ __forceinline__ void store2(T* dst, float lo, float hi) {
  *reinterpret_cast<uint32_t*>(dst) =
      hopper::pack2<std::is_same<T, __nv_bfloat16>::value>(lo, hi);
}

// One block per (batch*head, 128 query rows); warpgroup wg owns rows
// [q0 + 64 wg, q0 + 64 wg + 64). Per 64-key tile: S = Q K^T (SS wgmma, Q and
// K K-major), the online softmax on the accumulator fragment in base 2
// (scale * log2 e folded into the scores, never into bf16 Q), P packed to
// 16 bits in registers, O += P V (RS wgmma, V MN-major). The next K/V tile
// is in flight (cp.async) while this one is used.
template <typename T, int D>
__global__ void __launch_bounds__(WG_NT, 1) flash_fwd_wgmma_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    T* __restrict__ out, float* __restrict__ lse, int S, int H, int causal,
    int window, float scale) {
  constexpr bool BF16 = std::is_same<T, __nv_bfloat16>::value;
  constexpr int BQ = FWD_BQ, BK = FWD_BK, ND = D / 2;
  constexpr uint32_t Q_BYTES = BQ * D * 2, KV_BYTES = BK * D * 2;
  extern __shared__ uint8_t fwd_smem[];
  const uint32_t q_s = (hopper::smem_u32(fwd_smem) + 1023u) & ~1023u;
  const uint32_t k_s = q_s + Q_BYTES;            // two stages
  const uint32_t v_s = k_s + 2 * KV_BYTES;       // two stages

  const int bh = blockIdx.x, b = bh / H, h = bh - b * H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;   // longest tiles first
  const size_t rs = static_cast<size_t>(H) * D;
  const size_t base = (static_cast<size_t>(b) * S * H + h) * D;
  const int wg = threadIdx.x / 128, warp = (threadIdx.x / 32) % 4;
  const int lane = threadIdx.x % 32;
  const int r_lo = q0 + 64 * wg;                  // the warpgroup's rows
  const int row0 = r_lo + 16 * warp + lane / 4;   // this thread's: +0, +8
  const int col0 = 2 * (lane % 4);

  int k_lo, k_hi;
  key_range(q0, BQ, BK, S, causal, window, &k_lo, &k_hi);
  const int n_kt = (k_hi - k_lo + BK - 1) / BK;

  hopper::load_tile<BQ, D, WG_NT>(q_s, q + base, rs, q0, S);
  hopper::load_tile<BK, D, WG_NT>(k_s, k + base, rs, k_lo, S);
  hopper::load_tile<BK, D, WG_NT>(v_s, v + base, rs, k_lo, S);
  hopper::cp_async_commit();

  float o[ND];
#pragma unroll
  for (int i = 0; i < ND; ++i) o[i] = 0.f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  const float sl2 = scale * LOG2E;
  const bool live = r_lo < S;

  for (int it = 0; it < n_kt; ++it) {
    const int st = it & 1;
    if (it + 1 < n_kt) {
      const int kn = k_lo + (it + 1) * BK;
      hopper::load_tile<BK, D, WG_NT>(k_s + (st ^ 1) * KV_BYTES, k + base, rs,
                                      kn, S);
      hopper::load_tile<BK, D, WG_NT>(v_s + (st ^ 1) * KV_BYTES, v + base, rs,
                                      kn, S);
    }
    hopper::cp_async_commit();
    hopper::cp_async_wait<1>();          // this tile's group has landed
    hopper::fence_proxy_async();
    __syncthreads();

    const int k0 = k_lo + it * BK;
    // nothing of this tile is visible to the warpgroup's rows
    const bool skip = !live || (causal && k0 > r_lo + 63) ||
                      (causal && window > 0 && k0 + BK - 1 <= r_lo - window);
    if (!skip) {
      const uint32_t ks = k_s + st * KV_BYTES, vs = v_s + st * KV_BYTES;
      float s[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) s[i] = 0.f;
      hopper::fence_regs(s);
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t col = (kk >> 2), sub = (kk & 3) * 32;
        hopper::wgmma_ss_n64<BF16>(
            s, hopper::make_desc(q_s + col * BQ * 128 + wg * 8192 + sub, 16, 1024),
            hopper::make_desc(ks + col * BK * 128 + sub, 16, 1024), kk > 0);
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(s);

      // only tiles across the diagonal, the band's edge or S are masked
      const bool masked = k0 + BK > S || (causal && k0 + BK - 1 > r_lo) ||
                          (causal && window > 0 && k0 <= r_lo + 63 - window);
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        float x = s[i] * sl2;
        if (masked && !visible(row0 + 8 * ((i >> 1) & 1),
                               k0 + 8 * (i >> 2) + col0 + (i & 1), S, causal,
                               window))
          x = NEG_INF;
        s[i] = x;
        mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], x);
      }
      float corr[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = quad_max(mx[r]);
        corr[r] = exp2f(m[r] - mx[r]);
        m[r] = mx[r];
        l[r] *= corr[r];
      }
      uint32_t pa[16];
#pragma unroll
      for (int i = 0; i < 32; i += 2) {
        const int r = (i >> 1) & 1;
        const float p0 = s[i] == NEG_INF ? 0.f : exp2f(s[i] - m[r]);
        const float p1 = s[i + 1] == NEG_INF ? 0.f : exp2f(s[i + 1] - m[r]);
        l[r] += p0 + p1;
        pa[i >> 1] = hopper::pack2<BF16>(p0, p1);
      }
#pragma unroll
      for (int i = 0; i < ND; ++i) o[i] *= corr[(i >> 1) & 1];

      hopper::fence_regs(o);
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        const uint32_t a[4] = {pa[4 * kk], pa[4 * kk + 1], pa[4 * kk + 2],
                               pa[4 * kk + 3]};
        const uint64_t db = hopper::make_desc(vs + kk * 2048, BK * 128, 1024);
        if constexpr (D == 128) hopper::wgmma_rs_n128<BF16>(o, a, db);
        else hopper::wgmma_rs_n64<BF16>(o, a, db);
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(o);
    }
    __syncthreads();                     // the stage is free to refill
  }

  if (!live) return;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float lr = quad_sum(l[r]);
    const int row = row0 + 8 * r;
    if (row >= S) continue;
    const float inv = 1.f / lr;
    T* orow = out + base + static_cast<size_t>(row) * rs + col0;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      store2(orow + 8 * j, o[4 * j + 2 * r] * inv, o[4 * j + 2 * r + 1] * inv);
    if (col0 == 0)
      lse[static_cast<size_t>(bh) * S + row] = m[r] * LN2 + logf(lr);
  }
}

// -------------------------------------------------- dQ on the tensor cores

// One block per (batch*head, 128 query rows), longest causal tiles first;
// warpgroup wg owns rows [q0 + 64 wg, q0 + 64 wg + 64), their dQ
// accumulator (64 x D f32) and their lse and delta in registers. Q and dO
// are loaded once; per 64-key tile, with M = queries: S = Q K^T and
// dP = dO V^T (SS, all four K-major, one commit group),
// P = exp2(min(S scale log2 e - lse log2 e, 0)), dS = P (dP - delta) packed
// to 16 bits in place as the A operand of dQ += dS K (RS, K MN-major), in
// two terms (dS rounded, and the rest rounded). The next K/V tile is in
// flight (cp.async) while this one is used. No atomics.
template <typename T, int D>
__global__ void __launch_bounds__(WG_NT, 1) flash_bwd_dq_wgmma_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, T* __restrict__ dq, int S, int H,
    int causal, int window, float scale) {
  constexpr bool BF16 = std::is_same<T, __nv_bfloat16>::value;
  constexpr int BQ = FWD_BQ, BK = FWD_BK, ND = D / 2;
  constexpr uint32_t Q_BYTES = BQ * D * 2, KV_BYTES = BK * D * 2;
  extern __shared__ uint8_t dq_smem[];
  const uint32_t q_s = (hopper::smem_u32(dq_smem) + 1023u) & ~1023u;
  const uint32_t do_s = q_s + Q_BYTES;
  const uint32_t k_s = do_s + Q_BYTES;           // two stages
  const uint32_t v_s = k_s + 2 * KV_BYTES;       // two stages

  const int bh = blockIdx.x, b = bh / H, h = bh - b * H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;   // longest tiles first
  const size_t rs = static_cast<size_t>(H) * D;
  const size_t base = (static_cast<size_t>(b) * S * H + h) * D;
  const int wg = threadIdx.x / 128, warp = (threadIdx.x / 32) % 4;
  const int lane = threadIdx.x % 32;
  const int r_lo = q0 + 64 * wg;                  // the warpgroup's rows
  const int row0 = r_lo + 16 * warp + lane / 4;   // this thread's: +0, +8
  const int col0 = 2 * (lane % 4);

  int k_lo, k_hi;
  key_range(q0, BQ, BK, S, causal, window, &k_lo, &k_hi);
  const int n_kt = (k_hi - k_lo + BK - 1) / BK;

  hopper::load_tile<BQ, D, WG_NT>(q_s, q + base, rs, q0, S);
  hopper::load_tile<BQ, D, WG_NT>(do_s, dout + base, rs, q0, S);
  hopper::load_tile<BK, D, WG_NT>(k_s, k + base, rs, k_lo, S);
  hopper::load_tile<BK, D, WG_NT>(v_s, v + base, rs, k_lo, S);
  hopper::cp_async_commit();

  // lse (base 2) and delta of the thread's two rows; rows past S see zeros
  float lse2[2], dl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    lse2[r] = row < S ? lse[static_cast<size_t>(bh) * S + row] * LOG2E : 0.f;
    dl[r] = row < S ? delta[static_cast<size_t>(bh) * S + row] : 0.f;
  }
  float acc[ND];
#pragma unroll
  for (int i = 0; i < ND; ++i) acc[i] = 0.f;
  const float sl2 = scale * LOG2E;
  const bool live = r_lo < S;

  for (int it = 0; it < n_kt; ++it) {
    const int st = it & 1;
    if (it + 1 < n_kt) {
      const int kn = k_lo + (it + 1) * BK;
      hopper::load_tile<BK, D, WG_NT>(k_s + (st ^ 1) * KV_BYTES, k + base, rs,
                                      kn, S);
      hopper::load_tile<BK, D, WG_NT>(v_s + (st ^ 1) * KV_BYTES, v + base, rs,
                                      kn, S);
    }
    hopper::cp_async_commit();
    hopper::cp_async_wait<1>();          // this tile's group has landed
    hopper::fence_proxy_async();
    __syncthreads();

    const int k0 = k_lo + it * BK;
    const bool skip = !live || (causal && k0 > r_lo + 63) ||
                      (causal && window > 0 && k0 + BK - 1 <= r_lo - window);
    if (!skip) {
      const uint32_t ks = k_s + st * KV_BYTES, vs = v_s + st * KV_BYTES;
      float s[32], dp[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;
      hopper::fence_regs(s);
      hopper::fence_regs(dp);
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t col = (kk >> 2), sub = (kk & 3) * 32;
        hopper::wgmma_ss_n64<BF16>(
            s, hopper::make_desc(q_s + col * BQ * 128 + wg * 8192 + sub, 16, 1024),
            hopper::make_desc(ks + col * BK * 128 + sub, 16, 1024), kk > 0);
      }
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t col = (kk >> 2), sub = (kk & 3) * 32;
        hopper::wgmma_ss_n64<BF16>(
            dp, hopper::make_desc(do_s + col * BQ * 128 + wg * 8192 + sub, 16, 1024),
            hopper::make_desc(vs + col * BK * 128 + sub, 16, 1024), kk > 0);
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(s);
      hopper::fence_regs(dp);

      // only tiles across the diagonal, the band's edge or S are masked
      const bool masked = k0 + BK > S || (causal && k0 + BK - 1 > r_lo) ||
                          (causal && window > 0 && k0 <= r_lo + 63 - window);
      // dS as two 16-bit terms, hi = dS rounded and lo = dS - hi rounded:
      // |dS| reaches tens where a ring step's global lse clamps P at 1,
      // and one rounding of dS alone then moves dQ by more than a few
      // roundings of its own
      uint32_t da[16], da_lo[16];
#pragma unroll
      for (int i = 0; i < 32; i += 2) {
        const int r = (i >> 1) & 1;
        float d[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float p = exp2f(fminf(s[i + e] * sl2 - lse2[r], 0.f));
          if (masked && !visible(row0 + 8 * r, k0 + 8 * (i >> 2) + col0 + e,
                                 S, causal, window))
            p = 0.f;
          d[e] = p * (dp[i + e] - dl[r]);
        }
        da[i >> 1] = hopper::pack2<BF16>(d[0], d[1]);
        const float2 h = hopper::unpack2<BF16>(da[i >> 1]);
        da_lo[i >> 1] = hopper::pack2<BF16>(d[0] - h.x, d[1] - h.y);
      }

      hopper::fence_regs(acc);
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 2 * BK / 16; ++kk) {
        const uint32_t* x = kk < BK / 16 ? da : da_lo;
        const int j = kk % (BK / 16);
        const uint32_t a[4] = {x[4 * j], x[4 * j + 1], x[4 * j + 2],
                               x[4 * j + 3]};
        const uint64_t db = hopper::make_desc(ks + j * 2048, BK * 128, 1024);
        if constexpr (D == 128) hopper::wgmma_rs_n128<BF16>(acc, a, db);
        else hopper::wgmma_rs_n64<BF16>(acc, a, db);
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(acc);
    }
    __syncthreads();                     // the stage is free to refill
  }

  if (!live) return;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= S) continue;
    T* drow = dq + base + static_cast<size_t>(row) * rs + col0;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      store2(drow + 8 * j, acc[4 * j + 2 * r] * scale,
             acc[4 * j + 2 * r + 1] * scale);
  }
}

// ----------------------------------------------- dK/dV on the tensor cores

// One block per (batch*head, 128 keys); warpgroup wg owns keys
// [k0 + 64 wg, k0 + 64 wg + 64) and their dK, dV accumulators (64 x D f32
// each) in registers. Per 64-row query tile, with M = keys throughout:
// S^T = K Q^T (SS), P^T = exp(min(S^T scale - lse, 0)), dV += P^T dO (RS,
// dO MN-major) while dP^T = V dO^T (SS) runs, dS^T = P^T (dP^T - delta),
// dK += dS^T Q (RS, Q MN-major). P^T and dS^T are already the A-operand
// fragments; nothing is transposed through shared memory. No atomics.
template <typename T, int D>
__global__ void __launch_bounds__(WG_NT, 1) flash_bwd_dkv_wgmma_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv,
    int S, int H, int causal, int window, float scale) {
  constexpr bool BF16 = std::is_same<T, __nv_bfloat16>::value;
  constexpr int BK = DKV_BK, BQ = DKV_BQ, ND = D / 2;
  constexpr uint32_t KV_BYTES = BK * D * 2, Q_BYTES = BQ * D * 2;
  extern __shared__ uint8_t dkv_smem[];
  const uint32_t k_s = (hopper::smem_u32(dkv_smem) + 1023u) & ~1023u;
  const uint32_t v_s = k_s + KV_BYTES;
  const uint32_t q_s = v_s + KV_BYTES;           // two stages
  const uint32_t do_s = q_s + 2 * Q_BYTES;       // two stages
  const uint32_t row_s = do_s + 2 * Q_BYTES;     // lse[2][BQ], delta[2][BQ]
  const float* lse_sh = reinterpret_cast<const float*>(
      dkv_smem + (row_s - hopper::smem_u32(dkv_smem)));

  const int bh = blockIdx.x, b = bh / H, h = bh - b * H;
  const int k0 = blockIdx.y * BK;                 // low keys see most rows
  const size_t rs = static_cast<size_t>(H) * D;
  const size_t base = (static_cast<size_t>(b) * S * H + h) * D;
  const float* lse_bh = lse + static_cast<size_t>(bh) * S;
  const float* delta_bh = delta + static_cast<size_t>(bh) * S;
  const int wg = threadIdx.x / 128, warp = (threadIdx.x / 32) % 4;
  const int lane = threadIdx.x % 32;
  const int c_lo = k0 + 64 * wg;                  // the warpgroup's keys
  const int key0 = c_lo + 16 * warp + lane / 4;   // this thread's: +0, +8
  const int col0 = 2 * (lane % 4);

  // query tiles that can see keys [k0, k0 + BK): from the diagonal when
  // causal, to the last row inside the band when windowed
  const int q_lo = causal ? k0 / BQ * BQ : 0;
  const int q_hi = causal && window > 0 ? min(S, k0 + BK - 1 + window) : S;
  const int n_qt = (q_hi - q_lo + BQ - 1) / BQ;

  auto load_q = [&](int stage, int r0) {
    hopper::load_tile<BQ, D, WG_NT>(q_s + stage * Q_BYTES, q + base, rs, r0, S);
    hopper::load_tile<BQ, D, WG_NT>(do_s + stage * Q_BYTES, dout + base, rs,
                                    r0, S);
    const int t = threadIdx.x;
    if (t < 2 * BQ) {                   // lse rows, then delta rows
      const int r = min(r0 + t % BQ, S - 1);
      hopper::cp_async4(row_s + (stage * 2 * BQ + t) * 4,
                        (t < BQ ? lse_bh : delta_bh) + r, r0 + t % BQ < S);
    }
  };
  hopper::load_tile<BK, D, WG_NT>(k_s, k + base, rs, k0, S);
  hopper::load_tile<BK, D, WG_NT>(v_s, v + base, rs, k0, S);
  load_q(0, q_lo);
  hopper::cp_async_commit();

  float dk_acc[ND], dv_acc[ND];
#pragma unroll
  for (int i = 0; i < ND; ++i) dk_acc[i] = dv_acc[i] = 0.f;
  const float sl2 = scale * LOG2E;
  const bool live = c_lo < S;

  for (int it = 0; it < n_qt; ++it) {
    const int st = it & 1;
    if (it + 1 < n_qt) load_q(st ^ 1, q_lo + (it + 1) * BQ);
    hopper::cp_async_commit();
    hopper::cp_async_wait<1>();
    hopper::fence_proxy_async();
    __syncthreads();

    const int q0 = q_lo + it * BQ;
    const bool skip = !live || (causal && q0 + BQ - 1 < c_lo) ||
                      (causal && window > 0 && q0 > c_lo + 63 + window - 1);
    if (!skip) {
      const uint32_t qs = q_s + st * Q_BYTES, dos = do_s + st * Q_BYTES;
      const float* lse_r = lse_sh + st * 2 * BQ;
      const float* dl_r = lse_r + BQ;

      float s[32];                       // S^T: keys x queries
#pragma unroll
      for (int i = 0; i < 32; ++i) s[i] = 0.f;
      hopper::fence_regs(s);
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t col = (kk >> 2), sub = (kk & 3) * 32;
        hopper::wgmma_ss_n64<BF16>(
            s, hopper::make_desc(k_s + col * BK * 128 + wg * 8192 + sub, 16, 1024),
            hopper::make_desc(qs + col * BQ * 128 + sub, 16, 1024), kk > 0);
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(s);

      const bool masked = q0 + BQ > S || c_lo + 64 > S ||
                          (causal && q0 < c_lo + 63) ||
                          (causal && window > 0 && q0 + BQ - 1 - c_lo >= window);
      uint32_t pa[16];
#pragma unroll
      for (int i = 0; i < 32; i += 2) {
        float p[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int qi = 8 * (i >> 2) + col0 + e;        // query in the tile
          const int key = key0 + 8 * ((i >> 1) & 1);
          p[e] = exp2f(fminf(s[i + e] * sl2 - lse_r[qi] * LOG2E, 0.f));
          if (masked && !(q0 + qi < S && visible(q0 + qi, key, S, causal,
                                                 window)))
            p[e] = 0.f;
          s[i + e] = p[e];
        }
        pa[i >> 1] = hopper::pack2<BF16>(p[0], p[1]);
      }

      float dp[32];                      // dP^T: keys x queries
#pragma unroll
      for (int i = 0; i < 32; ++i) dp[i] = 0.f;
      hopper::fence_regs(dp);
      hopper::fence_regs(dv_acc);
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t col = (kk >> 2), sub = (kk & 3) * 32;
        hopper::wgmma_ss_n64<BF16>(
            dp, hopper::make_desc(v_s + col * BK * 128 + wg * 8192 + sub, 16, 1024),
            hopper::make_desc(dos + col * BQ * 128 + sub, 16, 1024), kk > 0);
      }
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk) {
        const uint32_t a[4] = {pa[4 * kk], pa[4 * kk + 1], pa[4 * kk + 2],
                               pa[4 * kk + 3]};
        const uint64_t db = hopper::make_desc(dos + kk * 2048, BQ * 128, 1024);
        if constexpr (D == 128) hopper::wgmma_rs_n128<BF16>(dv_acc, a, db);
        else hopper::wgmma_rs_n64<BF16>(dv_acc, a, db);
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(dp);
      hopper::fence_regs(dv_acc);

      uint32_t da[16];
#pragma unroll
      for (int i = 0; i < 32; i += 2) {
        const int qi = 8 * (i >> 2) + col0;
        da[i >> 1] = hopper::pack2<BF16>(s[i] * (dp[i] - dl_r[qi]),
                                         s[i + 1] * (dp[i + 1] - dl_r[qi + 1]));
      }
      hopper::fence_regs(dk_acc);
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk) {
        const uint32_t a[4] = {da[4 * kk], da[4 * kk + 1], da[4 * kk + 2],
                               da[4 * kk + 3]};
        const uint64_t db = hopper::make_desc(qs + kk * 2048, BQ * 128, 1024);
        if constexpr (D == 128) hopper::wgmma_rs_n128<BF16>(dk_acc, a, db);
        else hopper::wgmma_rs_n64<BF16>(dk_acc, a, db);
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(dk_acc);
    }
    __syncthreads();                     // the stage is free to refill
  }

  if (!live) return;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = key0 + 8 * r;
    if (key >= S) continue;
    const size_t off = base + static_cast<size_t>(key) * rs + col0;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      store2(dk + off + 8 * j, dk_acc[4 * j + 2 * r] * scale,
             dk_acc[4 * j + 2 * r + 1] * scale);
      store2(dv + off + 8 * j, dv_acc[4 * j + 2 * r], dv_acc[4 * j + 2 * r + 1]);
    }
  }
}

// --------------------------------------------------------------- launches

// The i-th pointer argument as X* (the C interface passes every tensor as
// a void pointer; outputs among them are written).
template <typename X>
X* arg(const void* const* p, int i) {
  return static_cast<X*>(const_cast<void*>(p[i]));
}

// Shared memory in floats for one block of kernel *kind* at head dim D.
size_t smem_floats(Kind kind, int tile, int D) {
  const size_t DP = D + 1, PP = tile + 1, t = tile;
  switch (kind) {
    case FWD: return 2 * t * DP + t * D + t * PP;
    case DQ: return 4 * t * DP + t * PP;
    default: return 4 * t * DP + t * PP + 2 * t;
  }
}

// The kernel's instance for dtype T at head dims up to 16 * DPT. Tiles of
// 64 rows keep the accumulators of D <= 128 in registers; D > 128 halves
// the tile so that dK and dV (2 x TILE/16 x D/16 floats a thread) still fit.
template <typename T, int DPT, int TILE>
cudaError_t launch(Kind kind, const void* const* p, int B, int S, int H,
                   int D, int causal, int window, float scale,
                   cudaStream_t stream) {
  const size_t smem = smem_floats(kind, TILE, D) * sizeof(float);
  const dim3 grid((S + TILE - 1) / TILE, B * H);
  const T* q = arg<const T>(p, 0);
  const T* k = arg<const T>(p, 1);
  const T* v = arg<const T>(p, 2);
  cudaError_t err;
  if (kind == FWD) {
    auto kern = flash_fwd_kernel<T, DPT, TILE>;
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    kern<<<grid, NT, smem, stream>>>(q, k, v, arg<T>(p, 3),
                                     arg<float>(p, 4), S, H, D,
                                     causal, window, scale);
  } else if (kind == DQ) {
    auto kern = flash_bwd_dq_kernel<T, DPT, TILE>;
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    kern<<<grid, NT, smem, stream>>>(
        q, k, v, arg<const T>(p, 3), arg<const float>(p, 4),
        arg<const float>(p, 5), arg<T>(p, 6), S, H, D,
        causal, window, scale);
  } else {
    auto kern = flash_bwd_dkv_kernel<T, DPT, TILE>;
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    kern<<<grid, NT, smem, stream>>>(
        q, k, v, arg<const T>(p, 3), arg<const float>(p, 4),
        arg<const float>(p, 5), arg<T>(p, 6),
        arg<T>(p, 7), S, H, D, causal, window, scale);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_typed(Kind kind, const void* const* p, int B, int S, int H,
                         int D, int causal, int window, float scale,
                         cudaStream_t stream) {
  if (D <= 64) return launch<T, 4, 64>(kind, p, B, S, H, D, causal, window, scale, stream);
  if (D <= 128) return launch<T, 8, 64>(kind, p, B, S, H, D, causal, window, scale, stream);
  return launch<T, 16, 32>(kind, p, B, S, H, D, causal, window, scale, stream);
}

// The tensor-core instance of the forward, dQ or dK/dV kernel for dtype T
// (f16 or bf16) at head dim D (64 or 128).
template <typename T, int D>
cudaError_t launch_wgmma(Kind kind, const void* const* p, int B, int S,
                         int H, int causal, int window, float scale,
                         cudaStream_t stream) {
  const T* q = arg<const T>(p, 0);
  const T* k = arg<const T>(p, 1);
  const T* v = arg<const T>(p, 2);
  const size_t smem = wgmma_smem_bytes(kind, D);
  cudaError_t err;
  if (kind == FWD) {
    auto kern = flash_fwd_wgmma_kernel<T, D>;
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    const dim3 grid(B * H, (S + FWD_BQ - 1) / FWD_BQ);
    kern<<<grid, WG_NT, smem, stream>>>(q, k, v, arg<T>(p, 3),
                                        arg<float>(p, 4), S, H, causal,
                                        window, scale);
  } else if (kind == DQ) {
    auto kern = flash_bwd_dq_wgmma_kernel<T, D>;
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    const dim3 grid(B * H, (S + FWD_BQ - 1) / FWD_BQ);
    kern<<<grid, WG_NT, smem, stream>>>(
        q, k, v, arg<const T>(p, 3), arg<const float>(p, 4),
        arg<const float>(p, 5), arg<T>(p, 6), S, H, causal, window, scale);
  } else {
    auto kern = flash_bwd_dkv_wgmma_kernel<T, D>;
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    const dim3 grid(B * H, (S + DKV_BK - 1) / DKV_BK);
    kern<<<grid, WG_NT, smem, stream>>>(
        q, k, v, arg<const T>(p, 3), arg<const float>(p, 4),
        arg<const float>(p, 5), arg<T>(p, 6), arg<T>(p, 7), S, H, causal,
        window, scale);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_wgmma_typed(Kind kind, const void* const* p, int n_ptr,
                               int B, int S, int H, int D, int causal,
                               int window, float scale, cudaStream_t stream) {
  // cp.async moves 16-byte chunks: every (B, S, H, D) tensor must be
  // 16-byte aligned (lse and delta, read 4 bytes at a time, need only 4)
  for (int i = 0; i < n_ptr; ++i) {
    const bool rows = kind == FWD ? i != 4 : i != 4 && i != 5;
    if (rows && reinterpret_cast<uintptr_t>(p[i]) % 16 != 0)
      return cudaErrorMisalignedAddress;
  }
  if (D == 64)
    return launch_wgmma<T, 64>(kind, p, B, S, H, causal, window, scale, stream);
  return launch_wgmma<T, 128>(kind, p, B, S, H, causal, window, scale, stream);
}

// route: 0 = the SIMT instances (every dtype, D <= 256), 1 = the wgmma
// instances (f16/bf16 at D = 64 or 128). The wrapper picks the route; an
// instance that cannot take the call refuses it rather than running
// another.
int dispatch(Kind kind, const void* const* p, int n_ptr, int B, int S, int H,
             int D, int causal, int window, float scale, int dtype, int route,
             void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || D <= 0 || D > MAX_D ||
      static_cast<long long>(B) * H > 65535 || window < 0 ||
      (window > 0 && !causal) || route < 0 || route > 1 ||
      (route == 1 && ((dtype != 1 && dtype != 2) || (D != 64 && D != 128))))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (route == 1) {
    const cudaError_t err =
        dtype == 1
            ? launch_wgmma_typed<__half>(kind, p, n_ptr, B, S, H, D, causal,
                                         window, scale, s)
            : launch_wgmma_typed<__nv_bfloat16>(kind, p, n_ptr, B, S, H, D,
                                                causal, window, scale, s);
    return static_cast<int>(err);
  }
  cudaError_t err;
  switch (dtype) {
    case 0: err = launch_typed<float>(kind, p, B, S, H, D, causal, window, scale, s); break;
    case 1: err = launch_typed<__half>(kind, p, B, S, H, D, causal, window, scale, s); break;
    case 2: err = launch_typed<__nv_bfloat16>(kind, p, B, S, H, D, causal, window, scale, s); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

}  // namespace

// dtype: 0 = float32, 1 = float16, 2 = bfloat16; route: 0 = SIMT, 1 = wgmma.
// Every tensor is contiguous; lse and delta are (B*H, S) f32. Each returns a
// cudaError_t (0 = ok).
extern "C" int kubetpu_flash_forward(const void* q, const void* k,
                                     const void* v, void* out, void* lse,
                                     int B, int S, int H, int D, int causal,
                                     int window, float scale, int dtype,
                                     void* stream, int route) {
  const void* p[] = {q, k, v, out, lse};
  return dispatch(FWD, p, 5, B, S, H, D, causal, window, scale, dtype, route,
                  stream);
}

// Dynamic shared memory in bytes of one block of kernel kind (0 = forward,
// 1 = dQ, 2 = dK/dV) on route (0 = SIMT, 1 = wgmma) at head dim D; ptxas
// reports only static shared memory.
extern "C" int kubetpu_flash_smem_bytes(int kind, int D, int route) {
  if (route == 1)
    return static_cast<int>(wgmma_smem_bytes(static_cast<Kind>(kind), D));
  const int tile = D <= 128 ? 64 : 32;
  return static_cast<int>(smem_floats(static_cast<Kind>(kind), tile, D) *
                          sizeof(float));
}

extern "C" int kubetpu_flash_backward_dq(const void* q, const void* k,
                                         const void* v, const void* dout,
                                         const void* lse, const void* delta,
                                         void* dq, int B, int S, int H, int D,
                                         int causal, int window, float scale,
                                         int dtype, void* stream, int route) {
  const void* p[] = {q, k, v, dout, lse, delta, dq};
  return dispatch(DQ, p, 7, B, S, H, D, causal, window, scale, dtype, route,
                  stream);
}

extern "C" int kubetpu_flash_backward_dkv(const void* q, const void* k,
                                          const void* v, const void* dout,
                                          const void* lse, const void* delta,
                                          void* dk, void* dv, int B, int S,
                                          int H, int D, int causal, int window,
                                          float scale, int dtype,
                                          void* stream, int route) {
  const void* p[] = {q, k, v, dout, lse, delta, dk, dv};
  return dispatch(DKV, p, 8, B, S, H, D, causal, window, scale, dtype, route,
                  stream);
}
