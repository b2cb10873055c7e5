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
// with f32 scales (P, ps, Hkv, 1) that are dequantized as
// float(value) * scale — convert, then scale, in f32, the order the JAX
// gather core uses, which keeps int8 greedy decode token-exact. The output
// is acc / max(l, 1e-30) in q's dtype, and a row that sees no key writes 0.
//
// What bounds it on an H100: bytes. Decode (T = 1) reads every visible K/V
// page once: sum_b visible_pages_b * ps * Hkv * D * 2 * bytes/elem (plus the
// f32 scales for int8) at 3.35 TB/s, against ~2 flops per byte of work. A
// prefill chunk (T = 256) does ~T flops per byte read and is bound by the
// tensor cores' rate once the products run there.
//
// The Pallas grid walked pages as a sequential reduction axis with the
// softmax state in VMEM scratch across grid steps; GPU blocks share no
// state. Three designs, chosen by the wrapper (paged_attention.py::_route);
// an instance that cannot take a call refuses it rather than running
// another:
//
// split (decode, T = 1; every dtype, int8 pages, windows; D % 16 == 0).
// The keys are cut into fixed spans of split_keys keys and one block owns
// (slot, kv head, 16 query rows, span): with ~300-key contexts and a few
// slots the grid still fills the card instead of walking 2048 keys in
// series per (slot, head). The grid is sized from the table's width, never
// from pos, so the host never reads pos; a span past pos, below the
// window's band or over unmapped pages writes an empty partial (m = -1e30,
// l = 0) and stops. Inside a span, KT-key tiles of raw K and V rows (and
// int8 scales) are gathered through the page table with 16-byte cp.async,
// two stages deep, into rows padded by 16 bytes (conflict-free row-per-lane
// reads); scores, the online softmax (natural exp, f32) and P.V run on CUDA
// cores. Each block writes its unnormalised partial (m, l, f32 acc), and
// paged_combine_kernel merges a row's spans: m = max m_i,
// l = sum l_i e^(m_i - m), acc = sum acc_i e^(m_i - m) (acc read only where
// l_i > 0), out = acc / max(l, 1e-30) — an all-empty row gives 0, not NaN.
//
// wgmma (prefill chunk, T > 1, window 0; dense bf16/f16 pages at D 64 or
// 128). The flash forward's design (flash_attention.cu) on gathered tiles:
// one warpgroup owns 64 query rows (row r = t * g + j, gathered row by row
// with cp.async into the 128-byte-swizzled layout; 64-row blocks, not 128,
// so a 256-token chunk of 16 heads gives 64 blocks); each 64-key K and V
// tile is gathered key by key through the page table (key k ->
// table[b, k / ps], row (page * ps + k % ps) * Hkv + kh), zero-filled by
// cp.async for unmapped pages and keys past the last row's position, four
// stages deep (a chunk's grid fills at most one block per SM, so the shared
// memory is there to hide the gather's latency). S = Q K^T (SS wgmma), the online softmax in base 2 on the
// fragment (scale * log2 e on the f32 scores), P packed to 16 bits,
// O += P V (RS wgmma, V MN-major). Key k is visible to row r iff its page
// is mapped and k <= pos + r / g; only tiles across the first row's
// diagonal or holding an unmapped page are masked. cp.async rather than
// TMA: every row of a tile has its own address.
//
// SIMT (every other call: T > 1 with f32 or int8 pages, other head dims,
// or a window). One block owns (slot, kv head, tile of ROWS query rows) and
// loops over the keys its rows can see, KT keys a step staged through the
// page table (dequantized on the way) in shared memory as f32; the running
// max, normalizer and accumulator stay in registers; all math f32 on CUDA
// cores.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <initializer_list>
#include <type_traits>

#include "hopper.cuh"

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

// ------------------------------------------------ decode: split-KV partials

constexpr int SPLIT_MAX_KT = 64;    // keys a tile at most (row bytes <= 128)

// Key-tile size of the split kernel: ~8 KB of K rows a stage, 16..64 keys.
__host__ __device__ constexpr int split_kt(int row_bytes) {
  return row_bytes <= 128 ? 64 : row_bytes <= 256 ? 32 : 16;
}

// Query rows a block of the split kernel holds: 1, 4 or 16.
__host__ __device__ constexpr int split_rows(int g) {
  return g <= 1 ? 1 : g <= 4 ? 4 : ROWS;
}

// Dynamic shared memory of the split kernel for GQA groups of g: two
// stages of K and V tiles (rows padded by 16 bytes), the block's queries,
// the tile's scores, the rows' rescale factors, int8 scales and the span's
// page ids.
__host__ __device__ constexpr size_t split_smem_bytes(int D, int elem,
                                                      int ps, int split_keys,
                                                      int g) {
  return static_cast<size_t>(4) * split_kt(D * elem) * (D * elem + 16) +
         sizeof(float) * (split_rows(g) * (D + SPLIT_MAX_KT + 1) +
                          4 * SPLIT_MAX_KT) +
         sizeof(int) * (split_keys / ps + 2);
}

// 16 bytes of shared memory as floats.
template <typename KVT>
__device__ __forceinline__ void chunk_to_f(const uint8_t* src,
                                           float (&x)[16 / sizeof(KVT)]) {
  const uint4 u = *reinterpret_cast<const uint4*>(src);
  const KVT* e = reinterpret_cast<const KVT*>(&u);
#pragma unroll
  for (int j = 0; j < 16 / static_cast<int>(sizeof(KVT)); ++j) x[j] = to_f(e[j]);
}

// One block per (span of split_keys keys, kv head x RT-row tile of the GQA
// group, slot), for one query per slot. Writes the span's unnormalised
// partial of each row: part (B, H, n_splits, D) f32 and ml (B, H, n_splits,
// 2) = (running max, normalizer); an empty span writes only ml = (-1e30, 0).
// RT (1, 4 or 16 rows a block) is the smallest that holds the group, so no
// thread loops over rows that are not there.
template <typename QT, typename KVT, bool INT8, int DPT, int RT>
__global__ void __launch_bounds__(NT) paged_split_kernel(
    const QT* __restrict__ q,          // (B, H, D)
    const KVT* __restrict__ kp,        // (P, ps, Hkv, D)
    const KVT* __restrict__ vp,
    const float* __restrict__ ksc,     // (P, ps, Hkv, 1) when INT8
    const float* __restrict__ vsc,
    const int* __restrict__ table,     // (B, max_pages), -1 = unmapped
    const int* __restrict__ pos_arr,   // (B,)
    float* __restrict__ part, float* __restrict__ ml, int H, int Hkv, int D,
    int ps, int max_pages, int window, int split_keys, float scale) {
  constexpr int VEC = 16 / sizeof(KVT);
  extern __shared__ __align__(16) uint8_t split_smem[];
  const int RB = D * static_cast<int>(sizeof(KVT)) + 16;   // padded row
  const int CH = D / VEC;                                  // chunks a row
  const int kt = split_kt(D * static_cast<int>(sizeof(KVT)));
  uint8_t* kv_s = split_smem;               // [stage][K, V][kt][RB]
  float* q_s = reinterpret_cast<float*>(split_smem + 4 * kt * RB);
  float* p_s = q_s + RT * D;                // RT x kt: scores, weights
  float* alpha_s = p_s + RT * SPLIT_MAX_KT;
  float* sc_s = alpha_s + RT;               // [stage][K, V][kt] int8 scales
  int* page_s = reinterpret_cast<int*>(sc_s + 4 * SPLIT_MAX_KT);

  const int n_splits = gridDim.x, split = blockIdx.x, b = blockIdx.z;
  const int g = H / Hkv, row_tiles = (g + RT - 1) / RT;
  const int kh = blockIdx.y / row_tiles;
  const int r0 = (blockIdx.y - kh * row_tiles) * RT;
  const int nr = min(RT, g - r0);
  const int h0 = kh * g + r0;               // the tile's first head
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int pos = pos_arr[b];

  // the span's keys that the query can see
  const int s0 = split * split_keys;
  const int lo = max(s0, window > 0 ? max(0, pos - window + 1) : 0);
  const int hi = min(min(s0 + split_keys, max_pages * ps) - 1, pos);
  const int p_lo = lo / ps;
  bool mapped = false;
  if (lo <= hi) {
    const int* trow = table + static_cast<size_t>(b) * max_pages;
    for (int i = tid; i <= hi / ps - p_lo; i += NT) {
      const int pg = trow[p_lo + i];
      page_s[i] = pg;
      mapped |= pg >= 0;
    }
  }
  auto row_of = [&](int r) {   // (b, head h0 + r, split) in part / ml
    return (static_cast<size_t>(b) * H + h0 + r) * n_splits + split;
  };
  if (!__syncthreads_or(mapped)) {
    if (tid < nr) {
      ml[2 * row_of(tid)] = NEG_INF;
      ml[2 * row_of(tid) + 1] = 0.f;
    }
    return;
  }

  for (int e = tid; e < nr * D; e += NT) {
    const int r = e / D;
    q_s[e] = to_f(q[static_cast<size_t>(b * H + h0 + r) * D + (e - r * D)]) *
             scale;
  }

  // K and V rows of keys [k0, k0 + kt) into stage st, zero-filled for keys
  // past hi or on unmapped pages; int8 scales beside them
  auto load = [&](int st, int k0) {
    uint8_t* ks = kv_s + (2 * st) * kt * RB;
    uint8_t* vs = ks + kt * RB;
    for (int e = tid; e < kt * CH; e += NT) {
      const int i = e / CH, c = e - i * CH, k = k0 + i;
      const int pg = k <= hi ? page_s[k / ps - p_lo] : -1;
      const size_t row =
          (static_cast<size_t>(max(pg, 0)) * ps + k % ps) * Hkv + kh;
      const size_t off = row * D + c * VEC;
      hopper::cp_async16(hopper::smem_u32(ks + i * RB + c * 16), kp + off,
                         pg >= 0);
      hopper::cp_async16(hopper::smem_u32(vs + i * RB + c * 16), vp + off,
                         pg >= 0);
      if (INT8 && c == 0) {
        float* sc = sc_s + 2 * st * SPLIT_MAX_KT;
        hopper::cp_async4(hopper::smem_u32(sc + i), ksc + row, pg >= 0);
        hopper::cp_async4(hopper::smem_u32(sc + SPLIT_MAX_KT + i), vsc + row,
                          pg >= 0);
      }
    }
  };

  // scores: np lanes share one (row, key) dot product, each taking every
  // np-th 16-byte chunk of the row; np is the largest power of two that
  // divides the chunks and keeps the block's threads busy
  int np = 1;
  while (np * 2 * kt * RT <= NT && CH % (np * 2) == 0 && np < 32) np *= 2;

  float acc[RT][DPT];
#pragma unroll
  for (int r = 0; r < RT; ++r)
#pragma unroll
    for (int c = 0; c < DPT; ++c) acc[r][c] = 0.f;
  // softmax state of the rows this warp owns: warp, warp + NWARP, ...
  constexpr int RW = (RT + NWARP - 1) / NWARP;
  float m_w[RW], l_w[RW];
#pragma unroll
  for (int x = 0; x < RW; ++x) {
    m_w[x] = NEG_INF;
    l_w[x] = 0.f;
  }

  const int n_t = (hi - lo + kt) / kt;
  load(0, lo);
  hopper::cp_async_commit();
  for (int it = 0; it < n_t; ++it) {
    const int st = it & 1, k0 = lo + it * kt;
    if (it + 1 < n_t) load(st ^ 1, k0 + kt);
    hopper::cp_async_commit();
    hopper::cp_async_wait<1>();            // this tile's group has landed
    __syncthreads();
    const uint8_t* ks = kv_s + (2 * st) * kt * RB;
    const uint8_t* vs = ks + kt * RB;
    const float* ksc_t = sc_s + 2 * st * SPLIT_MAX_KT;
    const float* vsc_t = ksc_t + SPLIT_MAX_KT;

    // scores of the (row, key) pairs; -1e30 for invisible keys
    for (int base = 0; base < nr * kt; base += NT / np) {
      const int item = base + tid / np, sub = tid % np;
      const int r = item / kt, i = item - r * kt, k = k0 + i;
      float s = 0.f;
      if (item < nr * kt) {
        const float* qr = q_s + r * D;
        const float kscale = INT8 ? ksc_t[i] : 1.f;
        for (int c = sub; c < CH; c += np) {
          float x[VEC];
          chunk_to_f<KVT>(ks + i * RB + c * 16, x);
#pragma unroll
          for (int j = 0; j < VEC; j += 4) {
            const float4 qv = *reinterpret_cast<const float4*>(qr + c * VEC + j);
            s = fmaf(qv.x, INT8 ? x[j] * kscale : x[j], s);
            s = fmaf(qv.y, INT8 ? x[j + 1] * kscale : x[j + 1], s);
            s = fmaf(qv.z, INT8 ? x[j + 2] * kscale : x[j + 2], s);
            s = fmaf(qv.w, INT8 ? x[j + 3] * kscale : x[j + 3], s);
          }
        }
      }
      for (int o = np / 2; o > 0; o >>= 1)
        s += __shfl_xor_sync(0xffffffffu, s, o);
      if (item < nr * kt && sub == 0)
        p_s[r * SPLIT_MAX_KT + i] =
            k <= hi && page_s[k / ps - p_lo] >= 0 ? s : NEG_INF;
    }
    __syncthreads();

    // online softmax: one warp per row, lanes over the tile's keys
#pragma unroll
    for (int x = 0; x < RW; ++x) {
      const int r = warp + x * NWARP;
      if (r < nr) {
        float* pr = p_s + r * SPLIT_MAX_KT;
        float mx = NEG_INF;
        for (int i = lane; i < kt; i += 32) mx = fmaxf(mx, pr[i]);
        const float m_new = fmaxf(m_w[x], warp_max(mx));
        float sum = 0.f;
        for (int i = lane; i < kt; i += 32) {
          const float s = pr[i];
          const float p = s == NEG_INF ? 0.f : expf(fminf(s - m_new, 0.f));
          pr[i] = p;
          sum += p;
        }
        const float alpha = expf(m_w[x] - m_new);
        l_w[x] = l_w[x] * alpha + warp_sum(sum);
        m_w[x] = m_new;
        if (lane == 0) alpha_s[r] = alpha;
      }
    }
    __syncthreads();

    // acc[r][d] = acc * alpha + sum_i p[r][i] v[i][d]; columns d = tid + c NT
#pragma unroll
    for (int c = 0; c < DPT; ++c) {
      const int d = tid + c * NT;
      if (d < D) {
#pragma unroll
        for (int r = 0; r < RT; ++r)
          if (r < nr) acc[r][c] *= alpha_s[r];
#pragma unroll 4
        for (int i = 0; i < kt; ++i) {
          const KVT* vr = reinterpret_cast<const KVT*>(vs + i * RB);
          const float vv = INT8 ? to_f(vr[d]) * vsc_t[i] : to_f(vr[d]);
#pragma unroll
          for (int r = 0; r < RT; ++r)
            if (r < nr) acc[r][c] = fmaf(p_s[r * SPLIT_MAX_KT + i], vv, acc[r][c]);
        }
      }
    }
    __syncthreads();                       // the stage and p_s are free
  }

#pragma unroll
  for (int x = 0; x < RW; ++x) {
    const int r = warp + x * NWARP;
    if (r < nr && lane == 0) {
      ml[2 * row_of(r)] = m_w[x];
      ml[2 * row_of(r) + 1] = l_w[x];
    }
  }
#pragma unroll
  for (int c = 0; c < DPT; ++c) {
    const int d = tid + c * NT;
    if (d < D) {
#pragma unroll
      for (int r = 0; r < RT; ++r)
        if (r < nr) part[row_of(r) * D + d] = acc[r][c];
    }
  }
}

// One block per (slot, head): merges the row's n_splits partials.
template <typename QT>
__global__ void __launch_bounds__(NT) paged_combine_kernel(
    const float* __restrict__ part, const float* __restrict__ ml,
    QT* __restrict__ out, int n_splits, int D) {
  const size_t row = blockIdx.x;
  const float* mlr = ml + row * n_splits * 2;
  float m = NEG_INF;
  for (int i = 0; i < n_splits; ++i) m = fmaxf(m, mlr[2 * i]);
  float l = 0.f;
  for (int i = 0; i < n_splits; ++i) l += mlr[2 * i + 1] * expf(mlr[2 * i] - m);
  const float inv = 1.f / fmaxf(l, 1e-30f);
  for (int d = threadIdx.x; d < D; d += NT) {
    float a = 0.f;
    for (int i = 0; i < n_splits; ++i)
      if (mlr[2 * i + 1] > 0.f)
        a = fmaf(part[(row * n_splits + i) * D + d], expf(mlr[2 * i] - m), a);
    out[row * D + d] = from_f<QT>(a * inv);
  }
}

// ------------------------------------ prefill chunk on the tensor cores

constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;
constexpr int WG = 128;             // one warpgroup a block
constexpr int CQ = 64, CK = 64;     // query rows a block, keys a tile
constexpr int CNS = 2;              // K/V tile stages in flight

__host__ __device__ constexpr size_t chunk_smem_bytes(int D, int max_pages) {
  return static_cast<size_t>(CQ + 2 * CNS * CK) * D * 2 + 1024 + CNS * CK +
         sizeof(int) * max_pages;
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// One block per (64-row tile of the T * g rows, kv head, slot x key
// split), last tiles (most keys) first. Row r of the tile is query (t, j)
// with r0 + r = t * g + j, head kh * g + j, at position pos + t. With
// n_split = 1 the block writes out; with n_split > 1 it takes its share of
// the rows' key tiles and writes the unnormalised partial (part, ml as the
// split kernel's, per row (b, t, head)) for paged_combine_kernel.
template <typename T, int D>
__global__ void __launch_bounds__(WG, 1) paged_chunk_wgmma_kernel(
    const T* __restrict__ q,           // (B, Tq, H, D)
    const T* __restrict__ kp,          // (P, ps, Hkv, D)
    const T* __restrict__ vp,
    const int* __restrict__ table, const int* __restrict__ pos_arr,
    T* __restrict__ out, float* __restrict__ part, float* __restrict__ ml,
    int Tq, int H, int Hkv, int ps, int max_pages, int n_split,
    float scale) {
  constexpr bool BF16 = std::is_same<T, __nv_bfloat16>::value;
  constexpr int ND = D / 2, CHK = D / 8;           // 16-byte chunks a row
  constexpr uint32_t Q_BYTES = CQ * D * 2, KV_BYTES = CK * D * 2;
  extern __shared__ __align__(16) uint8_t chunk_smem[];
  const uint32_t base_u32 = hopper::smem_u32(chunk_smem);
  const uint32_t q_s = (base_u32 + 1023u) & ~1023u;
  const uint32_t k_s = q_s + Q_BYTES;              // CNS stages
  const uint32_t v_s = k_s + CNS * KV_BYTES;       // CNS stages
  uint8_t* kvis_s = chunk_smem + (v_s + CNS * KV_BYTES - base_u32);  // [CNS][CK]
  int* page_s = reinterpret_cast<int*>(kvis_s + CNS * CK);

  const int b = blockIdx.z / n_split, split = blockIdx.z % n_split;
  const int kh = blockIdx.y, g = H / Hkv, rows = Tq * g;
  const int r0 = (gridDim.x - 1 - blockIdx.x) * CQ;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row0 = 16 * warp + lane / 4;          // tile rows +0, +8
  const int col0 = 2 * (lane % 4);
  const int pos = pos_arr[b];
  const int t_first = r0 / g, t_last = (min(r0 + CQ, rows) - 1) / g;
  const int k_end = pos + t_last;                 // the last key any row sees
  const int k_cap = max_pages * ps;
  // this block's share of the key tiles [0, k_end / CK]
  const int per = (k_end / CK + n_split) / n_split;
  const int kt_lo = split * per;
  const int n_kt = max(0, min(k_end / CK + 1, kt_lo + per) - kt_lo);
  // the (b, t, head) row of part / ml / out of tile row rr
  auto grow = [&](int rr) {
    const int t = rr / g;
    return (static_cast<size_t>(b) * Tq + t) * H + kh * g + (rr - t * g);
  };
  if (n_kt == 0) {                      // an empty share: an empty partial
    for (int r = threadIdx.x; r < CQ && r0 + r < rows; r += WG) {
      ml[2 * (grow(r0 + r) * n_split + split)] = NEG_INF;
      ml[2 * (grow(r0 + r) * n_split + split) + 1] = 0.f;
    }
    return;
  }

  for (int e = threadIdx.x; e < CQ * CHK; e += WG) {
    const int r = e / CHK, c = e % CHK, rr = r0 + r;
    const int t = rr / g, j = rr - t * g;
    const bool valid = rr < rows;
    const T* src = valid ? q + ((static_cast<size_t>(b) * Tq + t) * H + kh * g +
                                j) * D + c * 8
                         : q;
    hopper::cp_async16(q_s + hopper::swz_offset(r, c, CQ), src, valid);
  }
  const int n_pg = min(max_pages, k_end / ps + 1);
  for (int i = threadIdx.x; i < n_pg; i += WG)
    page_s[i] = table[static_cast<size_t>(b) * max_pages + i];
  __syncthreads();

  // K and V rows of keys [k0, k0 + CK) into stage st, gathered through the
  // page table; returns whether one of this thread's keys up to k_end is
  // unmapped
  auto load = [&](int st, int k0) {
    bool hole = false;
    for (int e = threadIdx.x; e < CK * CHK; e += WG) {
      const int i = e / CHK, c = e % CHK, k = k0 + i;
      const bool in = k <= k_end && k < k_cap;
      const int pg = in ? page_s[k / ps] : -1;
      const bool valid = pg >= 0;
      const size_t off =
          ((static_cast<size_t>(max(pg, 0)) * ps + k % ps) * Hkv + kh) * D +
          c * 8;
      const uint32_t dst = hopper::swz_offset(i, c, CK);
      hopper::cp_async16(k_s + st * KV_BYTES + dst, kp + off, valid);
      hopper::cp_async16(v_s + st * KV_BYTES + dst, vp + off, valid);
      if (c == 0) {
        kvis_s[st * CK + i] = valid;
        hole |= k <= k_end && !valid;
      }
    }
    return hole;
  };

  // tiles 0 .. CNS - 2 in flight; bit st of holes: stage st's tile has one
  int holes = 0;
#pragma unroll
  for (int st = 0; st < CNS - 1; ++st) {
    if (st < n_kt) holes |= load(st, (kt_lo + st) * CK) << st;
    hopper::cp_async_commit();
  }

  float o[ND];
#pragma unroll
  for (int i = 0; i < ND; ++i) o[i] = 0.f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  int qpos[2];                                    // the thread's rows' positions
#pragma unroll
  for (int r = 0; r < 2; ++r) qpos[r] = pos + (r0 + row0 + 8 * r) / g;
  const float sl2 = scale * LOG2E;

  for (int it = 0; it < n_kt; ++it) {
    const int st = it % CNS, k0 = (kt_lo + it) * CK;
    if (it + CNS - 1 < n_kt) {           // the stage freed last iteration
      const int sn = (it + CNS - 1) % CNS;
      holes = (holes & ~(1 << sn)) | (load(sn, k0 + (CNS - 1) * CK) << sn);
    }
    hopper::cp_async_commit();
    hopper::cp_async_wait<CNS - 1>();    // this tile's group has landed
    hopper::fence_proxy_async();
    const bool hole = __syncthreads_or((holes >> st) & 1);

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
          s, hopper::make_desc(q_s + col * CQ * 128 + sub, 16, 1024),
          hopper::make_desc(ks + col * CK * 128 + sub, 16, 1024), kk > 0);
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(s);

    // only tiles across the first row's diagonal or with a hole are masked
    const bool masked = hole || k0 + CK - 1 > pos + t_first;
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int r = (i >> 1) & 1, kl = 8 * (i >> 2) + col0 + (i & 1);
      float x = s[i] * sl2;
      if (masked && !(k0 + kl <= qpos[r] && kvis_s[st * CK + kl])) x = NEG_INF;
      s[i] = x;
      mx[r] = fmaxf(mx[r], x);
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
    for (int kk = 0; kk < CK / 16; ++kk) {
      const uint32_t a[4] = {pa[4 * kk], pa[4 * kk + 1], pa[4 * kk + 2],
                             pa[4 * kk + 3]};
      const uint64_t db = hopper::make_desc(vs + kk * 2048, CK * 128, 1024);
      if constexpr (D == 128) hopper::wgmma_rs_n128<BF16>(o, a, db);
      else hopper::wgmma_rs_n64<BF16>(o, a, db);
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(o);
    __syncthreads();                     // the stage is free to refill
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float lr = quad_sum(l[r]);
    const int rr = r0 + row0 + 8 * r;
    if (rr >= rows) continue;
    const size_t gr = grow(rr);
    if (n_split > 1) {                  // the partial, max in natural units
      const size_t pr = gr * n_split + split;
      if (col0 == 0) {
        ml[2 * pr] = lr > 0.f ? m[r] * LN2 : NEG_INF;
        ml[2 * pr + 1] = lr;
      }
      float* prow = part + pr * D + col0;
#pragma unroll
      for (int c = 0; c < D / 8; ++c)
        *reinterpret_cast<float2*>(prow + 8 * c) =
            make_float2(o[4 * c + 2 * r], o[4 * c + 2 * r + 1]);
      continue;
    }
    const float inv = 1.f / fmaxf(lr, 1e-30f);
    T* orow = out + gr * D + col0;
#pragma unroll
    for (int c = 0; c < D / 8; ++c)
      *reinterpret_cast<uint32_t*>(orow + 8 * c) = hopper::pack2<BF16>(
          o[4 * c + 2 * r] * inv, o[4 * c + 2 * r + 1] * inv);
  }
}

// ------------------------------------------------------------- launches

template <typename QT, typename KVT, bool INT8>
cudaError_t launch_split(const void* q, const void* k, const void* v,
                         const void* ksc, const void* vsc, const void* table,
                         const void* pos, float* part, float* ml, int B, int H,
                         int Hkv, int D, int ps, int max_pages, int window,
                         float scale, int split_keys, int n_splits,
                         cudaStream_t stream) {
  // cp.async moves 16-byte chunks of page rows (int8 scales: 4 bytes)
  if (D % 16 != 0 || reinterpret_cast<uintptr_t>(k) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(v) % 16 != 0)
    return cudaErrorMisalignedAddress;
  const int g = H / Hkv, rt = split_rows(g);
  const size_t smem = split_smem_bytes(D, sizeof(KVT), ps, split_keys, g);
  auto kern = paged_split_kernel<QT, KVT, INT8, 1, 1>;
  if (D > NT)
    kern = rt == 1   ? paged_split_kernel<QT, KVT, INT8, 2, 1>
           : rt == 4 ? paged_split_kernel<QT, KVT, INT8, 2, 4>
                     : paged_split_kernel<QT, KVT, INT8, 2, ROWS>;
  else if (rt > 1)
    kern = rt == 4 ? paged_split_kernel<QT, KVT, INT8, 1, 4>
                   : paged_split_kernel<QT, KVT, INT8, 1, ROWS>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(n_splits, Hkv * ((g + rt - 1) / rt), B);
  kern<<<grid, NT, smem, stream>>>(
      static_cast<const QT*>(q), static_cast<const KVT*>(k),
      static_cast<const KVT*>(v), static_cast<const float*>(ksc),
      static_cast<const float*>(vsc), static_cast<const int*>(table),
      static_cast<const int*>(pos), part, ml, H, Hkv, D, ps, max_pages,
      window, split_keys, scale);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_chunk(const void* q, const void* k, const void* v,
                         const void* table, const void* pos, void* out,
                         float* part, float* ml, int B, int Tq, int H,
                         int Hkv, int ps, int max_pages, int n_split,
                         float scale, cudaStream_t stream) {
  auto kern = paged_chunk_wgmma_kernel<T, D>;
  const size_t smem = chunk_smem_bytes(D, max_pages);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((Tq * (H / Hkv) + CQ - 1) / CQ, Hkv, B * n_split);
  kern<<<grid, WG, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(table),
      static_cast<const int*>(pos), static_cast<T*>(out), part, ml, Tq, H,
      Hkv, ps, max_pages, n_split, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_chunk_typed(const void* q, const void* k, const void* v,
                               const void* table, const void* pos, void* out,
                               float* part, float* ml, int B, int Tq, int H,
                               int Hkv, int D, int ps, int max_pages,
                               int n_split, float scale,
                               cudaStream_t stream) {
  // cp.async moves 16-byte chunks: q, pages and out must be 16-byte aligned
  for (const void* p : {q, k, v, static_cast<const void*>(out)})
    if (reinterpret_cast<uintptr_t>(p) % 16 != 0)
      return cudaErrorMisalignedAddress;
  if (D == 64)
    return launch_chunk<T, 64>(q, k, v, table, pos, out, part, ml, B, Tq, H,
                               Hkv, ps, max_pages, n_split, scale, stream);
  return launch_chunk<T, 128>(q, k, v, table, pos, out, part, ml, B, Tq, H,
                              Hkv, ps, max_pages, n_split, scale, stream);
}

bool bad_shape(int B, int T, int H, int Hkv, int D, int ps, int max_pages) {
  return B <= 0 || T <= 0 || Hkv <= 0 || H % Hkv != 0 || D <= 0 ||
         D > MAX_D || ps <= 0 || max_pages <= 0 || B > 65535 || Hkv > 65535;
}

}  // namespace

// dtype: 0 = float32, 1 = float16, 2 = bfloat16 (q, out, and dense pages).
// kv_int8: pages are int8 with f32 scales. Returns a cudaError_t (0 = ok).
extern "C" int kubetpu_paged_attention(
    const void* q, const void* k, const void* v, const void* k_scale,
    const void* v_scale, const void* table, const void* pos, void* out,
    int B, int T, int H, int Hkv, int D, int ps, int max_pages, int window,
    float scale, int dtype, int kv_int8, void* stream) {
  if (bad_shape(B, T, H, Hkv, D, ps, max_pages))
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

// The chunk form on the tensor cores (T > 1, window 0, dense f16/bf16
// pages, D 64 or 128). n_split = 1 writes out; n_split > 1 cuts each row's
// key tiles into n_split shares and writes f32 partials part (B, T, H,
// n_split, D) and ml (B, T, H, n_split, 2) for kubetpu_paged_combine.
extern "C" int kubetpu_paged_chunk_wgmma(
    const void* q, const void* k, const void* v, const void* table,
    const void* pos, void* out, void* part, void* ml, int B, int T, int H,
    int Hkv, int D, int ps, int max_pages, int n_split, float scale,
    int dtype, void* stream) {
  if (bad_shape(B, T, H, Hkv, D, ps, max_pages) || T < 2 || n_split < 1 ||
      static_cast<long long>(B) * n_split > 65535 ||
      (dtype != 1 && dtype != 2) || (D != 64 && D != 128) ||
      (n_split > 1 && (part == nullptr || ml == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* pt = static_cast<float*>(part);
  float* m = static_cast<float*>(ml);
  return static_cast<int>(
      dtype == 1 ? launch_chunk_typed<__half>(q, k, v, table, pos, out, pt, m,
                                              B, T, H, Hkv, D, ps, max_pages,
                                              n_split, scale, s)
                 : launch_chunk_typed<__nv_bfloat16>(
                       q, k, v, table, pos, out, pt, m, B, T, H, Hkv, D, ps,
                       max_pages, n_split, scale, s));
}

// The decode form's first pass: q is (B, H, D), one query per slot at
// pos[b]; part (B, H, n_splits, D) and ml (B, H, n_splits, 2) are f32
// scratch with n_splits = ceil(max_pages * ps / split_keys).
extern "C" int kubetpu_paged_split(
    const void* q, const void* k, const void* v, const void* k_scale,
    const void* v_scale, const void* table, const void* pos, void* part,
    void* ml, int B, int H, int Hkv, int D, int ps, int max_pages, int window,
    float scale, int split_keys, int dtype, int kv_int8, void* stream) {
  const int n_splits = (max_pages * ps + split_keys - 1) / max(split_keys, 1);
  if (bad_shape(B, 1, H, Hkv, D, ps, max_pages) || split_keys <= 0 ||
      n_splits > 65535 ||
      static_cast<long long>(Hkv) *
              ((H / Hkv + split_rows(H / Hkv) - 1) / split_rows(H / Hkv)) >
          65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* pt = static_cast<float*>(part);
  float* m = static_cast<float*>(ml);
#define KUBETPU_ARGS q, k, v, k_scale, v_scale, table, pos, pt, m, B, H, Hkv, \
                     D, ps, max_pages, window, scale, split_keys, n_splits, s
  cudaError_t err;
  switch (dtype) {
    case 0:
      err = kv_int8 ? launch_split<float, int8_t, true>(KUBETPU_ARGS)
                    : launch_split<float, float, false>(KUBETPU_ARGS);
      break;
    case 1:
      err = kv_int8 ? launch_split<__half, int8_t, true>(KUBETPU_ARGS)
                    : launch_split<__half, __half, false>(KUBETPU_ARGS);
      break;
    case 2:
      err = kv_int8
                ? launch_split<__nv_bfloat16, int8_t, true>(KUBETPU_ARGS)
                : launch_split<__nv_bfloat16, __nv_bfloat16, false>(
                      KUBETPU_ARGS);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
#undef KUBETPU_ARGS
  return static_cast<int>(err);
}

// The second pass of the split route and of a split chunk: merges the
// n_splits partials of each of the rows (B * H, or B * T * H) into out
// (rows, D) in dtype.
extern "C" int kubetpu_paged_combine(const void* part, const void* ml,
                                     void* out, int rows, int n_splits, int D,
                                     int dtype, void* stream) {
  if (rows <= 0 || n_splits <= 0 || D <= 0 || D > MAX_D)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* pt = static_cast<const float*>(part);
  const float* m = static_cast<const float*>(ml);
  switch (dtype) {
    case 0:
      paged_combine_kernel<float><<<rows, NT, 0, s>>>(
          pt, m, static_cast<float*>(out), n_splits, D);
      break;
    case 1:
      paged_combine_kernel<__half><<<rows, NT, 0, s>>>(
          pt, m, static_cast<__half*>(out), n_splits, D);
      break;
    case 2:
      paged_combine_kernel<__nv_bfloat16><<<rows, NT, 0, s>>>(
          pt, m, static_cast<__nv_bfloat16*>(out), n_splits, D);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// Dynamic shared memory in bytes of one block: route 1 = the wgmma chunk
// instance at head dim D, 2 = the split instance for elem-byte page values
// at page size ps, split_keys and GQA groups of g; ptxas reports only
// static shared memory.
extern "C" int kubetpu_paged_smem_bytes(int route, int D, int elem, int ps,
                                        int max_pages, int split_keys,
                                        int g) {
  if (route == 1) return static_cast<int>(chunk_smem_bytes(D, max_pages));
  if (route == 2)
    return static_cast<int>(split_smem_bytes(D, elem, ps, split_keys, g));
  return -1;
}
