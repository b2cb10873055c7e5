// Flash attention for Hopper (sm_90a): forward, dQ and dK/dV kernels, with a
// plain C interface for ctypes.
//
// Replaces the TPU kernels of kubetpu/ops/flash_attention.py:
//   flash_fwd_kernel     <- _flash_kernel          (pallas_call in _flash_forward)
//   flash_bwd_dq_kernel  <- _flash_bwd_dq_kernel   (pallas_call in _flash_backward)
//   flash_bwd_dkv_kernel <- _flash_bwd_dkv_kernel  (pallas_call in _flash_backward)
// and computes the same functions. q, k, v, out, dO, dq, dk and dv are
// (B, S, H, D) in one dtype (f32, f16 or bf16; K/V already expanded to H
// heads); lse and delta = rowsum(dO * O) are (B*H, S) f32. Key k is visible
// to row r iff k < S and, when causal, k <= r and (window == 0 or
// r - k < window). The forward scales q before the product, masks scores to
// -1e30, keeps the online max / normalizer / accumulator and writes
// out = acc / l and lse = m + log(l). The backward recomputes
// P = exp(min(s * scale - lse, 0)) on visible keys (the clamp bounds ring
// attention's invisible steps), dS = P * (dO V^T - delta),
// dQ = dS K * scale, dK = dS^T Q * scale and dV = P^T dO. All math is f32;
// outputs are stored in the input dtype.
//
// What bounds it on an H100: operations. At B=4, S=2048, H=16, D=128 causal
// the forward does 2 products over the causal half (~69 GFLOP, ~0.07 ms at
// the 989 TFLOP/s bf16 tensor-core rate) against ~134 MB of q/k/v/o
// (~0.04 ms at 3.35 TB/s); dQ recomputes 3 products and dK/dV 4.
//
// Design. The Pallas grids walked key blocks (forward, dQ) or query blocks
// (dK/dV) as a sequential axis; GPU blocks share no state, so each CUDA
// block owns one (batch*head, row tile) and loops over the tiles its rows
// can see: causal tiles up to the diagonal, from the first tile inside the
// band when windowed, every tile when non-causal. The backward keeps the
// JAX package's two kernels — dQ per query tile, dK/dV per key tile — so no
// atomics are needed and the gradients are deterministic. Tiles are staged
// in shared memory as f32 (rows padded to D + 1 floats, so the 16 lanes of
// a half-warp that read 16 different rows hit 16 banks); 256 threads form a
// 16 x 16 grid, each thread owning a (TILE/16) x (TILE/16) patch of the
// score tile and (TILE/16) x ceil(D/16) accumulators in registers. The
// ragged last tile is masked (rows past S load zeros and are not stored;
// keys past S are invisible). Products run on CUDA cores in f32: no wgmma,
// no TMA, no pipelining of the tile loads yet.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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

// --------------------------------------------------------------- launches

enum Kind { FWD = 0, DQ = 1, DKV = 2 };

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

int dispatch(Kind kind, const void* const* p, int B, int S, int H, int D,
             int causal, int window, float scale, int dtype, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || D <= 0 || D > MAX_D ||
      static_cast<long long>(B) * H > 65535 || window < 0 ||
      (window > 0 && !causal))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
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

// dtype: 0 = float32, 1 = float16, 2 = bfloat16. Every tensor is contiguous;
// lse and delta are (B*H, S) f32. Each returns a cudaError_t (0 = ok).
extern "C" int kubetpu_flash_forward(const void* q, const void* k,
                                     const void* v, void* out, void* lse,
                                     int B, int S, int H, int D, int causal,
                                     int window, float scale, int dtype,
                                     void* stream) {
  const void* p[] = {q, k, v, out, lse};
  return dispatch(FWD, p, B, S, H, D, causal, window, scale, dtype, stream);
}

extern "C" int kubetpu_flash_backward_dq(const void* q, const void* k,
                                         const void* v, const void* dout,
                                         const void* lse, const void* delta,
                                         void* dq, int B, int S, int H, int D,
                                         int causal, int window, float scale,
                                         int dtype, void* stream) {
  const void* p[] = {q, k, v, dout, lse, delta, dq};
  return dispatch(DQ, p, B, S, H, D, causal, window, scale, dtype, stream);
}

extern "C" int kubetpu_flash_backward_dkv(const void* q, const void* k,
                                          const void* v, const void* dout,
                                          const void* lse, const void* delta,
                                          void* dk, void* dv, int B, int S,
                                          int H, int D, int causal, int window,
                                          float scale, int dtype,
                                          void* stream) {
  const void* p[] = {q, k, v, dout, lse, delta, dk, dv};
  return dispatch(DKV, p, B, S, H, D, causal, window, scale, dtype, stream);
}
