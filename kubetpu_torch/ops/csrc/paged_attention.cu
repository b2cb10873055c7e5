// Paged attention for Hopper (sm_90a), with a plain C interface for ctypes.
//
// Replaces the TPU kernel kubetpu/ops/paged_attention.py::_paged_attn_kernel
// (reached through _paged_attention_call's pallas_call and exposed there as
// paged_attention, T = 1, and paged_attention_chunk). It computes the same
// function: for each slot b, T queries at positions pos[b]..pos[b]+T-1 attend
// the keys of that slot's pages through table[b] (-1 = unmapped). Key k is
// visible to query position p iff its page is mapped, k <= p, and, with
// window > 0, p - k < window. Query head h = kv_head * g + j (GQA groups in
// (Hkv, g)-major order). Pages hold bf16, f16 or f32 values, or int8 values
// with f32 scales (P, ps, Hkv, 1) that are dequantized while loading as
// float(value) * scale — convert, then scale, in f32, the order the JAX
// gather core uses, which keeps int8 greedy decode token-exact. Scores,
// softmax and the accumulator are f32; the output is acc / max(l, 1e-30) in
// q's dtype, and a row that sees no key writes 0.
//
// What bounds it on an H100: bytes. Decode (T = 1) reads every visible K/V
// page once: sum_b visible_pages_b * ps * Hkv * D * 2 * bytes/elem (plus the
// f32 scales for int8) at 3.35 TB/s, against ~2 flops per byte of work.
//
// Design. The Pallas grid walked pages as a sequential reduction axis with
// the softmax state in VMEM scratch across grid steps; GPU blocks share no
// state, so here one block owns (slot, kv head, tile of ROWS query rows) and
// loops over the keys its rows can see, from the first key inside the band
// to pos + last_row_t. Each iteration stages KT keys' K and V (gathered
// through the page table, dequantized on the way) in shared memory; the
// running max, normalizer and accumulator stay in registers. Each page is
// read from device memory once per (slot, kv head, row tile) and nothing is
// gathered into device memory. Scores and the P.V product run on CUDA cores
// in f32: no wgmma, no TMA and no split-KV pass yet.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -1e30f;   // the Pallas kernel's mask value
constexpr int NT = 128;             // threads per block
constexpr int NWARP = NT / 32;
constexpr int KT = 32;              // keys staged per iteration (one per lane)
constexpr int ROWS = 16;            // query rows (t, j) per block
constexpr int MAX_D = 2 * NT;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__half x) { return __half2float(x); }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f(int8_t x) { return static_cast<float>(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __half from_f<__half>(float x) {
  return __float2half_rn(x);
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(
    float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Copy VEC consecutive elements from global memory: one 16-byte load when
// VEC elements fill 16 bytes (the launcher only picks such a VEC when D is a
// multiple of it, so the address is aligned), else element by element.
template <typename T, int VEC>
__device__ __forceinline__ void load_vec(T (&dst)[VEC], const T* src) {
  if constexpr (VEC * sizeof(T) == 16) {
    *reinterpret_cast<uint4*>(dst) = __ldg(reinterpret_cast<const uint4*>(src));
  } else {
#pragma unroll
    for (int j = 0; j < VEC; ++j) dst[j] = src[j];
  }
}

template <typename QT, typename KVT, bool INT8, int DPT, int VEC>
__global__ void __launch_bounds__(NT) paged_attn_kernel(
    const QT* __restrict__ q,          // (B, T, H, D)
    const KVT* __restrict__ kp,        // (P, ps, Hkv, D)
    const KVT* __restrict__ vp,        // (P, ps, Hkv, D)
    const float* __restrict__ ksc,     // (P, ps, Hkv, 1) when INT8
    const float* __restrict__ vsc,
    const int* __restrict__ table,     // (B, max_pages), -1 = unmapped
    const int* __restrict__ pos_arr,   // (B,) position of q[b, 0]
    QT* __restrict__ out,              // (B, T, H, D)
    int T, int H, int Hkv, int D, int ps, int max_pages, int window,
    float scale) {
  extern __shared__ float smem[];
  const int DP = D + 1;                 // padded K rows: conflict-free reads
  float* q_s = smem;                    // ROWS x D, pre-scaled queries
  float* k_s = q_s + ROWS * D;          // KT x DP
  float* v_s = k_s + KT * DP;           // KT x D
  float* p_s = v_s + KT * D;            // ROWS x KT: scores, then weights
  float* alpha_s = p_s + ROWS * KT;     // ROWS: this tile's rescale factors
  float* l_s = alpha_s + ROWS;          // ROWS: final normalizers
  int* page_s = reinterpret_cast<int*>(l_s + ROWS);   // KT physical pages

  const int b = blockIdx.z, kh = blockIdx.y;
  const int g = H / Hkv;
  const int r0 = blockIdx.x * ROWS;
  const int nr = min(ROWS, T * g - r0);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int pos = pos_arr[b];
  const int* trow = table + static_cast<size_t>(b) * max_pages;

  // row r of the tile is query (t, j) with r0 + r = t * g + j: head kh*g + j
  for (int e = tid; e < nr * D; e += NT) {
    const int r = e / D, d = e - r * D;
    const int rr = r0 + r, t = rr / g, j = rr - t * g;
    q_s[e] = to_f(q[((static_cast<size_t>(b) * T + t) * H + kh * g + j) * D + d])
             * scale;
  }

  // keys the tile's rows can see: up to the last row's position, and from
  // the first row's band floor when windowed
  const int t_first = r0 / g, t_last = (r0 + nr - 1) / g;
  const int k_hi = min(pos + t_last, max_pages * ps - 1);
  const int k_lo = window > 0 ? max(0, pos + t_first - window + 1) : 0;

  float acc[ROWS][DPT];
#pragma unroll
  for (int r = 0; r < ROWS; ++r)
#pragma unroll
    for (int c = 0; c < DPT; ++c) acc[r][c] = 0.f;
  // softmax state of the rows this warp owns: warp, warp + NWARP, ...
  float m_w[ROWS / NWARP], l_w[ROWS / NWARP];
#pragma unroll
  for (int x = 0; x < ROWS / NWARP; ++x) {
    m_w[x] = NEG_INF;
    l_w[x] = 0.f;
  }

  for (int k0 = k_lo; k0 <= k_hi; k0 += KT) {
    if (tid < KT) {
      const int k = k0 + tid;
      page_s[tid] = k <= k_hi ? trow[k / ps] : -1;
    }
    __syncthreads();

    // stage K and V of the KT keys (zeros for masked keys), dequantized
    const int nvec = D / VEC;
    for (int e = tid; e < KT * nvec; e += NT) {
      const int i = e / nvec, d0 = (e - i * nvec) * VEC;
      const int ph = page_s[i];
      float kx[VEC], vx[VEC];
      if (ph >= 0) {
        const size_t row =
            (static_cast<size_t>(ph) * ps + (k0 + i) % ps) * Hkv + kh;
        alignas(16) KVT kb[VEC];
        alignas(16) KVT vb[VEC];
        load_vec<KVT, VEC>(kb, kp + row * D + d0);
        load_vec<KVT, VEC>(vb, vp + row * D + d0);
        const float ks = INT8 ? ksc[row] : 1.f;
        const float vs = INT8 ? vsc[row] : 1.f;
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          kx[j] = INT8 ? to_f(kb[j]) * ks : to_f(kb[j]);
          vx[j] = INT8 ? to_f(vb[j]) * vs : to_f(vb[j]);
        }
      } else {
#pragma unroll
        for (int j = 0; j < VEC; ++j) kx[j] = vx[j] = 0.f;
      }
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        k_s[i * DP + d0 + j] = kx[j];
        v_s[i * D + d0 + j] = vx[j];
      }
    }
    __syncthreads();

    // scores s[r][i] = q_r . k_i (key index fastest across the warp)
    for (int e = tid; e < nr * KT; e += NT) {
      const int r = e / KT, i = e - r * KT;
      const float* qr = q_s + r * D;
      const float* kr = k_s + i * DP;
      float s = 0.f;
      for (int d = 0; d < D; ++d) s = fmaf(qr[d], kr[d], s);
      p_s[r * KT + i] = s;
    }
    __syncthreads();

    // online softmax: one warp per row, lane = key
#pragma unroll
    for (int x = 0; x < ROWS / NWARP; ++x) {
      const int r = warp + x * NWARP;
      if (r < nr) {
        const int qpos = pos + (r0 + r) / g;
        const int k = k0 + lane;
        const bool vis = page_s[lane] >= 0 && k <= qpos &&
                         (window <= 0 || qpos - k < window);
        const float s = vis ? p_s[r * KT + lane] : NEG_INF;
        const float m_new = fmaxf(m_w[x], warp_max(s));
        const float alpha = expf(m_w[x] - m_new);
        // exp(min(s - m, 0)): s <= m by construction; the guard keeps an
        // overflow out of the accumulator, as in the Pallas kernel
        const float p = vis ? expf(fminf(s - m_new, 0.f)) : 0.f;
        l_w[x] = l_w[x] * alpha + warp_sum(p);
        m_w[x] = m_new;
        p_s[r * KT + lane] = p;
        if (lane == 0) alpha_s[r] = alpha;
      }
    }
    __syncthreads();

    // acc[r][d] = acc * alpha + sum_i p[r][i] v[i][d]; thread owns columns
    // d = tid + c * NT
#pragma unroll
    for (int c = 0; c < DPT; ++c) {
      const int d = tid + c * NT;
      if (d < D) {
#pragma unroll
        for (int r = 0; r < ROWS; ++r) {
          if (r < nr) {
            float a = acc[r][c] * alpha_s[r];
            const float* pr = p_s + r * KT;
#pragma unroll 8
            for (int i = 0; i < KT; ++i) a = fmaf(pr[i], v_s[i * D + d], a);
            acc[r][c] = a;
          }
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int x = 0; x < ROWS / NWARP; ++x) {
    const int r = warp + x * NWARP;
    if (r < nr && lane == 0) l_s[r] = l_w[x];
  }
  __syncthreads();

#pragma unroll
  for (int c = 0; c < DPT; ++c) {
    const int d = tid + c * NT;
    if (d < D) {
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        if (r < nr) {
          const int rr = r0 + r, t = rr / g, j = rr - t * g;
          out[((static_cast<size_t>(b) * T + t) * H + kh * g + j) * D + d] =
              from_f<QT>(acc[r][c] / fmaxf(l_s[r], 1e-30f));
        }
      }
    }
  }
}

template <typename QT, typename KVT, bool INT8, int DPT, int VEC>
cudaError_t launch_one(const void* q, const void* k, const void* v,
                       const void* ksc, const void* vsc, const void* table,
                       const void* pos, void* out, int B, int T, int H,
                       int Hkv, int D, int ps, int max_pages, int window,
                       float scale, cudaStream_t stream) {
  auto kern = paged_attn_kernel<QT, KVT, INT8, DPT, VEC>;
  const size_t smem =
      sizeof(float) * (ROWS * D + KT * (D + 1) + KT * D + ROWS * KT + 2 * ROWS)
      + sizeof(int) * KT;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const int g = H / Hkv;
  dim3 grid((T * g + ROWS - 1) / ROWS, Hkv, B);
  kern<<<grid, NT, smem, stream>>>(
      static_cast<const QT*>(q), static_cast<const KVT*>(k),
      static_cast<const KVT*>(v), static_cast<const float*>(ksc),
      static_cast<const float*>(vsc), static_cast<const int*>(table),
      static_cast<const int*>(pos), static_cast<QT*>(out), T, H, Hkv, D, ps,
      max_pages, window, scale);
  return cudaGetLastError();
}

template <typename QT, typename KVT, bool INT8>
cudaError_t launch_typed(const void* q, const void* k, const void* v,
                         const void* ksc, const void* vsc, const void* table,
                         const void* pos, void* out, int B, int T, int H,
                         int Hkv, int D, int ps, int max_pages, int window,
                         float scale, cudaStream_t stream) {
  constexpr int VEC = 16 / sizeof(KVT);
  const bool vec = D % VEC == 0;
  const bool wide = D > NT;
#define KUBETPU_LAUNCH(DPT_, VEC_)                                          \
  return launch_one<QT, KVT, INT8, DPT_, VEC_>(q, k, v, ksc, vsc, table,   \
                                               pos, out, B, T, H, Hkv, D,  \
                                               ps, max_pages, window, scale, \
                                               stream)
  if (wide) {
    if (vec) KUBETPU_LAUNCH(2, VEC);
    KUBETPU_LAUNCH(2, 1);
  }
  if (vec) KUBETPU_LAUNCH(1, VEC);
  KUBETPU_LAUNCH(1, 1);
#undef KUBETPU_LAUNCH
}

}  // namespace

// dtype: 0 = float32, 1 = float16, 2 = bfloat16 (q, out, and dense pages).
// kv_int8: pages are int8 with f32 scales. Returns a cudaError_t (0 = ok).
extern "C" int kubetpu_paged_attention(
    const void* q, const void* k, const void* v, const void* k_scale,
    const void* v_scale, const void* table, const void* pos, void* out,
    int B, int T, int H, int Hkv, int D, int ps, int max_pages, int window,
    float scale, int dtype, int kv_int8, void* stream) {
  if (B <= 0 || T <= 0 || Hkv <= 0 || H % Hkv != 0 || D <= 0 || D > MAX_D ||
      ps <= 0 || max_pages <= 0 || B > 65535 || Hkv > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define KUBETPU_ARGS q, k, v, k_scale, v_scale, table, pos, out, B, T, H, Hkv, \
                     D, ps, max_pages, window, scale, s
  cudaError_t err;
  switch (dtype) {
    case 0:
      err = kv_int8 ? launch_typed<float, int8_t, true>(KUBETPU_ARGS)
                    : launch_typed<float, float, false>(KUBETPU_ARGS);
      break;
    case 1:
      err = kv_int8 ? launch_typed<__half, int8_t, true>(KUBETPU_ARGS)
                    : launch_typed<__half, __half, false>(KUBETPU_ARGS);
      break;
    case 2:
      err = kv_int8
                ? launch_typed<__nv_bfloat16, int8_t, true>(KUBETPU_ARGS)
                : launch_typed<__nv_bfloat16, __nv_bfloat16, false>(
                      KUBETPU_ARGS);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
#undef KUBETPU_ARGS
  return static_cast<int>(err);
}
