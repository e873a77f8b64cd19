// Chebyshev-proxy backward of online training (kernel K2): the parameter
// gradient of the proxy pair forces as lane-moment sums, hand-written for
// Hopper (sm_90a).
//
// Replaces: hoomd_tf_tpu/ops/pair_train_pallas.py::_kernel (the Pallas TPU
// kernel behind proxy_bwd_moments). The proxy's lane function is linear in
// its coefficients, so the gradient of <ct, F4> is, with u = 1/max(d2,
// min_r2), w = clip((u - mid) * inv_half, -1, 1), over = max(u - u_hi, 0):
//   d/dc_k  = sum_lanes  A * T_k(w),         A = wE
//   d/dcd_k = sum_lanes  B * T_k(w),         B = wE * over - wF * u^2
// over the half-stencil lanes of kernel K1 (csrc/cellwise_half.cu), with
// the Newton-combined cotangent weights
//   wF = 2 * ((ct_i . d) - [j directed] (ct_j . d)),
//   wE = 0.5 * (cte_i + [j directed] cte_j),
// ct the cotangent times `valid`, and T_k(w) from the two-term recurrence.
// A typed proxy keeps one (c, cd) pair of moment sets per unordered type
// pair; types outside the table add nothing. Without the energy moments,
// A is absent and the c-moments are zero.
//
// Design: one block per home cell. The block stages the occupied slots of
// its 14 half-stencil cells straight from the slot-ordered state
// (half_stencil_stage.cuh), each with its cotangent ct * valid, those of
// the 13 directed blocks only within the cut of the home rows' bounding
// box: no candidate or cotangent plane exists in device memory, and empty
// or out-of-reach slots are never walked. The lanes (home row i, staged candidate j) are split
// over (row, candidate segment) pairs; the self pair is excluded by staged
// index. Untyped with K = 8 or 16 (the train path: K = 16), each thread
// keeps its 2K moments in registers; at the end a warp shuffle tree per
// moment and the warps' partials in a fixed order give the block's sums.
// Typed proxies and other K keep per-thread accumulators in shared memory,
// one [2K] set per candidate type (a thread's row type is fixed within a
// pass), folded into the block's [P][2K] sums at the end of each pass of
// rows. Each block writes its [P * 2K] partial sums; a second kernel sums
// them over cells in a fixed order. No float atomics, so the result is
// deterministic, and any P * 2K works (the Pallas kernel's one 128-lane
// output row capped 2K * P at 128).
//
// What bounds it on an H100: operations. The function needs the slot state
// (positions, valid, the [n_slots, 4] cotangent; types when typed) read
// once and P * 2K floats written, ~4 MB at the 64k train shapes, against
// ~2.2e7 occupied x occupied half-stencil pairs at ~9 float32 operations
// each, plus ~27 + 4K (6K with energy) for the ~5% inside the cut: about
// 0.25 G operations, ~0.004 ms at 67 TFLOP/s.
//
// Built with -fmad=false, and the staging uses _rn intrinsics, so the
// cutoff mask agrees bit for bit with the plain version.

#include <cuda_runtime.h>

#include "half_stencil_stage.cuh"

namespace {

using htf::HalfGeom;
using htf::kHalf;
using htf::kStageInts;
using htf::kThreads;
using htf::kWarps;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// KR > 0: untyped with K = KR, moments in registers; KR == 0: per-thread
// moment sets in shared memory (typed, or another K).
template <bool ENERGY, int KR>
__global__ void __launch_bounds__(kThreads)
proxy_bwd_kernel(const float* __restrict__ pos, const int* __restrict__ types,
                 const float* __restrict__ valid,
                 const float* __restrict__ centers,
                 const float4* __restrict__ ct, HalfGeom g,
                 const float* __restrict__ rcm, int rcm_t, int K, int T,
                 float rc2, float min_r2, float mid, float inv_half,
                 float u_hi, float* __restrict__ partial) {
  extern __shared__ float4 smem4[];
  const int C = kHalf * g.cap;
  const int c = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int K2 = 2 * K;
  const int P = T * (T + 1) / 2;
  const int M = P * K2;
  const bool typed = T > 1;

  float4* spos = smem4;                                  // [C]
  float4* sct = spos + C;                                // [C] ct * valid
  int* stag = reinterpret_cast<int*>(sct + C);           // [C]
  int* sints = stag + C;                                 // [kStageInts]
  float* wpart = reinterpret_cast<float*>(sints + kStageInts);  // [kWarps][M]
  float* acc = wpart + kWarps * M;                       // [M]
  float* slots = acc + M;  // KR == 0: [T][2K][kThreads]

  for (int i = tid; i < M; i += kThreads) acc[i] = 0.f;
  int n0;
  const int total = htf::stage_half_stencil(
      g, c, rc2, pos, types, valid, centers, spos, stag, sints, n0,
      [&](int k, size_t slot) {
        const float4 v = ct[slot];
        const float w = valid[slot];
        sct[k] = make_float4(v.x * w, v.y * w, v.z * w, v.w * w);
      },
      htf::NoSkip());

  float mom[KR > 0 ? 2 * KR : 1];
#pragma unroll
  for (int m = 0; m < (KR > 0 ? 2 * KR : 1); ++m) mom[m] = 0.f;

  for (int r0 = 0; r0 < n0; r0 += kThreads) {
    const htf::RowSplit sp(r0, n0);
    int ti = 0;
    bool row_ok = sp.active;
    if (KR == 0)
      for (int m = 0; m < T * K2; ++m) slots[m * kThreads + tid] = 0.f;
    if (sp.active) {
      const float4 q = spos[sp.row];
      const float4 cq = sct[sp.row];
      ti = __float_as_int(q.w);
      // rows of a type outside the table add nothing
      if (typed && (ti < 0 || ti >= T)) row_ok = false;
      for (int j = sp.seg; row_ok && j < total; j += sp.nseg) {
        if (j == sp.row) continue;  // the self pair (block 0)
        const float4 gj = spos[j];
        const float dx = gj.x - q.x;
        const float dy = gj.y - q.y;
        const float dz = gj.z - q.z;
        const float d2 = dx * dx + dy * dy + dz * dz;
        if (!(d2 <= rc2)) continue;
        const int tj = __float_as_int(gj.w);
        if (rcm != nullptr) {
          const bool known = ti >= 0 && ti < rcm_t && tj >= 0 && tj < rcm_t;
          const float prc2 = known ? rcm[ti * rcm_t + tj] : 0.f;
          if (!(d2 <= prc2)) continue;
        }
        if (typed && (tj < 0 || tj >= T)) continue;
        const bool directed = j >= n0;
        const float r2 = fmaxf(d2, min_r2);
        float wF = cq.x * dx + cq.y * dy + cq.z * dz;
        float4 cj = make_float4(0.f, 0.f, 0.f, 0.f);
        if (directed) {
          cj = sct[j];
          wF = wF - (cj.x * dx + cj.y * dy + cj.z * dz);
        }
        wF = 2.0f * wF;
        const float u = 1.0f / r2;
        const float over = fmaxf(u - u_hi, 0.f);
        float A = 0.f, B;
        if (ENERGY) {
          float wE = cq.w;
          if (directed) wE = wE + cj.w;
          wE = 0.5f * wE;
          A = wE;
          B = wE * over - wF * (u * u);
        } else {
          B = -wF * (u * u);
        }
        const float w = fminf(fmaxf((u - mid) * inv_half, -1.0f), 1.0f);
        const float two_w = 2.0f * w;
        float t_prev = 1.0f, t_cur = w;
        if (KR > 0) {
#pragma unroll
          for (int k = 0; k < (KR > 0 ? KR : 1); ++k) {
            const float t_k = k == 0 ? t_prev : t_cur;
            if (ENERGY) mom[k] += A * t_k;
            mom[KR + k] += B * t_k;
            if (k >= 1) {
              const float t_next = two_w * t_cur - t_prev;
              t_prev = t_cur;
              t_cur = t_next;
            }
          }
        } else {
          float* s = slots + (typed ? tj : 0) * K2 * kThreads + tid;
          for (int k = 0; k < K; ++k) {
            const float t_k = k == 0 ? t_prev : t_cur;
            if (ENERGY) s[k * kThreads] += A * t_k;
            s[(K + k) * kThreads] += B * t_k;
            if (k >= 1) {
              const float t_next = two_w * t_cur - t_prev;
              t_prev = t_cur;
              t_cur = t_next;
            }
          }
        }
      }
    }
    if (KR == 0) {
      // fold this pass's sets into the block sums: the thread's share of
      // pair (a, b), term m -> warp tree -> warp partial -> fixed-order sum
      int pidx = 0;
      for (int a = 0; a < T; ++a) {
        for (int b = a; b < T; ++b, ++pidx) {
          for (int m = 0; m < K2; ++m) {
            float v = 0.f;
            if (row_ok) {
              if (!typed) {
                v = slots[m * kThreads + tid];
              } else {
                if (ti == a) v = slots[(b * K2 + m) * kThreads + tid];
                if (a != b && ti == b)
                  v = v + slots[(a * K2 + m) * kThreads + tid];
              }
            }
            v = warp_sum(v);
            if (lane == 0) wpart[warp * M + pidx * K2 + m] = v;
          }
        }
      }
      __syncthreads();
      for (int i = tid; i < M; i += kThreads) {
        float v = 0.f;
        for (int w = 0; w < kWarps; ++w) v += wpart[w * M + i];
        acc[i] += v;
      }
      __syncthreads();
    }
  }

  if (KR > 0) {
#pragma unroll
    for (int m = 0; m < (KR > 0 ? 2 * KR : 1); ++m) {
      const float v = warp_sum(mom[m]);
      if (lane == 0) wpart[warp * M + m] = v;
    }
    __syncthreads();
    for (int i = tid; i < M; i += kThreads) {
      float v = 0.f;
      for (int w = 0; w < kWarps; ++w) v += wpart[w * M + i];
      acc[i] = v;
    }
  }
  for (int i = tid; i < M; i += kThreads)
    partial[static_cast<size_t>(c) * M + i] = acc[i];
}

// out[m] = sum over cells of partial[cell][m], in a fixed order: one block
// per m, a strided per-thread sum, then a shuffle tree and the warps in
// order.
__global__ void __launch_bounds__(kThreads)
reduce_partials(const float* __restrict__ partial, int n_cells, int M,
                float* __restrict__ out) {
  __shared__ float wsum[kWarps];
  const int m = blockIdx.x;
  const int tid = threadIdx.x;
  float v = 0.f;
  for (int c = tid; c < n_cells; c += kThreads)
    v += partial[static_cast<size_t>(c) * M + m];
  v = warp_sum(v);
  if ((tid & 31) == 0) wsum[tid >> 5] = v;
  __syncthreads();
  if (tid == 0) {
    float s = 0.f;
    for (int w = 0; w < kWarps; ++w) s += wsum[w];
    out[m] = s;
  }
}

// The register-moment degree for (K, T), or 0 for the shared-memory path.
int register_degree(int K, int T) {
  if (T != 1) return 0;
  return (K == 8 || K == 16) ? K : 0;
}

long smem_bytes(int cap, int K, int T) {
  const long K2 = 2L * K;
  const long M = T * (T + 1) / 2 * K2;
  const long slots = register_degree(K, T) ? 0 : T * K2 * kThreads;
  return static_cast<long>(kHalf) * cap * (2 * sizeof(float4) + sizeof(int)) +
         static_cast<long>(sizeof(int)) * kStageInts +
         static_cast<long>(sizeof(float)) * (kWarps * M + M + slots);
}

template <bool ENERGY, int KR>
int launch_moments(const float* pos, const int* types, const float* valid,
                   const float* centers, const float* ct, const HalfGeom& g,
                   int n_cells, const float* rcm, int rcm_t, int K, int T,
                   float rc2, float min_r2, float mid, float inv_half,
                   float u_hi, float* partial, cudaStream_t s) {
  const long smem = smem_bytes(g.cap, K, T);
  auto kernel = proxy_bwd_kernel<ENERGY, KR>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kernel<<<n_cells, kThreads, smem, s>>>(
      pos, types, valid, centers, reinterpret_cast<const float4*>(ct), g, rcm,
      rcm_t, K, T, rc2, min_r2, mid, inv_half, u_hi, partial);
  return static_cast<int>(cudaGetLastError());
}

template <bool ENERGY>
int dispatch_degree(const float* pos, const int* types, const float* valid,
                    const float* centers, const float* ct, const HalfGeom& g,
                    int n_cells, const float* rcm, int rcm_t, int K, int T,
                    float rc2, float min_r2, float mid, float inv_half,
                    float u_hi, float* partial, cudaStream_t s) {
  switch (register_degree(K, T)) {
    case 16:
      return launch_moments<ENERGY, 16>(pos, types, valid, centers, ct, g,
                                        n_cells, rcm, rcm_t, K, T, rc2,
                                        min_r2, mid, inv_half, u_hi, partial,
                                        s);
    case 8:
      return launch_moments<ENERGY, 8>(pos, types, valid, centers, ct, g,
                                       n_cells, rcm, rcm_t, K, T, rc2, min_r2,
                                       mid, inv_half, u_hi, partial, s);
    default:
      return launch_moments<ENERGY, 0>(pos, types, valid, centers, ct, g,
                                       n_cells, rcm, rcm_t, K, T, rc2, min_r2,
                                       mid, inv_half, u_hi, partial, s);
  }
}

}  // namespace

extern "C" {

// Shared-memory bytes one block of the moment kernel needs.
long htf_proxy_bwd_smem(int cap, int K, int ntypes) {
  return smem_bytes(cap, K, ntypes);
}

// Launch both passes on `stream`: per-cell partial sums into `partial`
// ([n_cells][P * 2K] scratch), then their sum into `out` ([P * 2K], per
// pair p: c-moments at p * 2K + k, cd-moments at p * 2K + K + k). `pos`
// [n_slots][3], `types` [n_slots] int32 (or null when untyped), `valid`
// [n_slots], `centers` [n_slots][3], `ct` the [n_slots][4] cotangent,
// `geom` a host HalfGeom. Returns cudaGetLastError() after the launches
// (0 = ok).
int htf_proxy_bwd(const float* pos, const int* types, const float* valid,
                  const float* centers, const float* ct, const HalfGeom* geom,
                  int n_cells, const float* rcm, int rcm_t, int K, int ntypes,
                  float rc2, float min_r2, float mid, float inv_half,
                  float u_hi, int needs_energy, float* partial, float* out,
                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const HalfGeom g = *geom;
  const int M = ntypes * (ntypes + 1) / 2 * 2 * K;
  const int e =
      needs_energy
          ? dispatch_degree<true>(pos, types, valid, centers, ct, g, n_cells,
                                  rcm, rcm_t, K, ntypes, rc2, min_r2, mid,
                                  inv_half, u_hi, partial, s)
          : dispatch_degree<false>(pos, types, valid, centers, ct, g, n_cells,
                                   rcm, rcm_t, K, ntypes, rc2, min_r2, mid,
                                   inv_half, u_hi, partial, s);
  if (e != 0) return e;
  reduce_partials<<<M, kThreads, 0, s>>>(partial, n_cells, M, out);
  return static_cast<int>(cudaGetLastError());
}

const char* htf_proxy_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
