// Chebyshev-proxy backward of online training: the parameter gradient of
// the proxy pair forces as lane-moment sums, hand-written for Hopper
// (sm_90a).
//
// Replaces: hoomd_tf_tpu/ops/pair_train_pallas.py::_kernel (the Pallas TPU
// kernel behind proxy_bwd_moments). The proxy's lane function is linear in
// its coefficients, so the gradient of <ct, F4> is, with u = 1/max(d2,
// min_r2), w = clip((u - mid) * inv_half, -1, 1), over = max(u - u_hi, 0):
//   d/dc_k  = sum_lanes  A * T_k(w),         A = wE
//   d/dcd_k = sum_lanes  B * T_k(w),         B = wE * over - wF * u^2
// over the half-stencil lanes of kernel K1 (csrc/cellwise_half.cu), with
// the Newton-combined cotangent weights
//   wF = 2 * ((ct_r . d) - [j directed] (ct_j . d)),
//   wE = 0.5 * (cte_r + [j directed] cte_j),
// and T_k(w) from the two-term recurrence (T_k = 1 on clipped overlap
// lanes, w = 1). A typed proxy keeps one (c, cd) pair of moment sets per
// unordered type pair; types outside the table add nothing. Without the
// energy moments, A is absent and the c-moments are zero.
//
// Design: one block per cell and a thread per candidate lane (striding in
// chunks of the block size over the 14*cap lanes), the row loop over the
// cell's occupied rows only -- ghost-only row groups cost nothing, where
// the Pallas kernel still ran their lane math. The self pair is excluded
// structurally, by column index in block 0. Within a chunk a thread's
// candidate type is fixed and a row's type is uniform across the block,
// so each thread accumulates into per-thread slots [row type][2K] in
// shared memory (laid out [slot][thread], so a warp's accesses never
// conflict); registers would not hold 2K * T accumulators. At the end of
// each chunk the slots are folded into the block's [P][2K] sums: each
// thread forms its contribution to every (pair, term), a warp shuffle
// tree sums it, and the warps' partials are added in a fixed order. Each
// block writes its [P * 2K] partial sums; a second kernel sums the
// partials over cells in a fixed order. No float atomics anywhere, so the
// result is deterministic, and any P * 2K works (the Pallas kernel's one
// 128-lane output row capped 2K * P at 128).
//
// What bounds it on an H100: the pair lanes, as in K1 -- about
// n_cells * occ * 14*cap lanes, each ~20 f32 FLOPs of displacement, mask
// and weights plus ~6K inside the cut for the recurrence and the moment
// updates (a shared-memory read-modify-write per term). The planes it
// reads (7 or 8 [n_cells, 14*cap] f32) are a few tens of MB at 64k.
//
// Built with -fmad=false like K1, so the cutoff mask agrees bit for bit
// with the plain version.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

template <bool ENERGY>
__global__ void __launch_bounds__(kThreads)
proxy_bwd_kernel(const int* __restrict__ occ, const float* __restrict__ gx,
                 const float* __restrict__ gy, const float* __restrict__ gz,
                 const int* __restrict__ gt, const float* __restrict__ cgx,
                 const float* __restrict__ cgy, const float* __restrict__ cgz,
                 const float* __restrict__ cge, const float* __restrict__ rcm,
                 int rcm_t, int n_cells, int cap, int K, int T, float rc2,
                 float min_r2, float mid, float inv_half, float u_hi,
                 float* __restrict__ partial) {
  extern __shared__ float smem[];
  const int C = 14 * cap;
  const int c = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int K2 = 2 * K;
  const int P = T * (T + 1) / 2;
  const int M = P * K2;
  const bool typed = T > 1;

  float* qx = smem;
  float* qy = qx + cap;
  float* qz = qy + cap;
  float* rx = qz + cap;  // row cotangents
  float* ry = rx + cap;
  float* rz = ry + cap;
  float* re = rz + cap;
  int* qt = reinterpret_cast<int*>(re + cap);
  float* slots = reinterpret_cast<float*>(qt + cap);  // [T][2K][kThreads]
  float* wpart = slots + T * K2 * kThreads;           // [kWarps][M]
  float* acc = wpart + kWarps * M;                    // [M]

  const size_t base = static_cast<size_t>(c) * C;
  const int o = min(max(occ[c], 0), cap);
  for (int r = tid; r < cap; r += kThreads) {
    qx[r] = gx[base + r];
    qy[r] = gy[base + r];
    qz[r] = gz[base + r];
    rx[r] = cgx[base + r];
    ry[r] = cgy[base + r];
    rz[r] = cgz[base + r];
    re[r] = ENERGY ? cge[base + r] : 0.f;
    qt[r] = gt ? gt[base + r] : 0;
  }
  for (int i = tid; i < M; i += kThreads) acc[i] = 0.f;
  __syncthreads();

  for (int j0 = 0; j0 < C; j0 += kThreads) {
    const int j = j0 + tid;
    const bool active = j < C;
    const bool directed = j >= cap;
    float xj = 0.f, yj = 0.f, zj = 0.f, cxj = 0.f, cyj = 0.f, czj = 0.f;
    float cej = 0.f;
    int tj = 0;
    if (active) {
      xj = gx[base + j];
      yj = gy[base + j];
      zj = gz[base + j];
      cxj = cgx[base + j];
      cyj = cgy[base + j];
      czj = cgz[base + j];
      if (ENERGY) cej = cge[base + j];
      tj = gt ? gt[base + j] : 0;
    }
    for (int i = 0; i < T * K2; ++i) slots[i * kThreads + tid] = 0.f;

    for (int r = 0; r < o && active; ++r) {
      const int ti = qt[r];
      // rows of a type outside the table add nothing (uniform branch)
      if (typed && (ti < 0 || ti >= T)) continue;
      const float dx = xj - qx[r];
      const float dy = yj - qy[r];
      const float dz = zj - qz[r];
      const float d2 = dx * dx + dy * dy + dz * dz;
      bool ok = d2 <= rc2 && !(j < cap && j == r);
      if (rcm != nullptr) {
        const bool known = ti >= 0 && ti < rcm_t && tj >= 0 && tj < rcm_t;
        const float prc2 = known ? rcm[ti * rcm_t + tj] : 0.f;
        ok = ok && d2 <= prc2;
      }
      if (!ok) continue;
      const float r2 = fmaxf(d2, min_r2);
      float wF = rx[r] * dx + ry[r] * dy + rz[r] * dz;
      if (directed) wF = wF - (cxj * dx + cyj * dy + czj * dz);
      wF = 2.0f * wF;
      const float u = 1.0f / r2;
      const float over = fmaxf(u - u_hi, 0.f);
      float A = 0.f, B;
      if (ENERGY) {
        float wE = re[r];
        if (directed) wE = wE + cej;
        wE = 0.5f * wE;
        A = wE;
        B = wE * over - wF * (u * u);
      } else {
        B = -wF * (u * u);
      }
      const float w = fminf(fmaxf((u - mid) * inv_half, -1.0f), 1.0f);
      float* s = slots + (typed ? ti : 0) * K2 * kThreads + tid;
      const float two_w = 2.0f * w;
      float t_prev = 1.0f, t_cur = w;
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

    // fold this chunk's slots into the block sums: thread contribution to
    // pair (a, b), term m -> warp tree -> warp partial -> fixed-order sum
    int pidx = 0;
    for (int a = 0; a < T; ++a) {
      for (int b = a; b < T; ++b, ++pidx) {
        for (int m = 0; m < K2; ++m) {
          float v = 0.f;
          if (active) {
            if (!typed) {
              v = slots[m * kThreads + tid];
            } else {
              if (tj == b) v = slots[(a * K2 + m) * kThreads + tid];
              if (a != b && tj == a)
                v = v + slots[(b * K2 + m) * kThreads + tid];
            }
          }
#pragma unroll
          for (int off = 16; off > 0; off >>= 1)
            v += __shfl_xor_sync(0xffffffffu, v, off);
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
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  if ((tid & 31) == 0) wsum[tid >> 5] = v;
  __syncthreads();
  if (tid == 0) {
    float s = 0.f;
    for (int w = 0; w < kWarps; ++w) s += wsum[w];
    out[m] = s;
  }
}

long smem_bytes(int cap, int K, int T) {
  const long K2 = 2L * K;
  const long M = T * (T + 1) / 2 * K2;
  return static_cast<long>(sizeof(float)) *
         (8L * cap + T * K2 * kThreads + kWarps * M + M);
}

}  // namespace

extern "C" {

// Shared-memory bytes one block of the moment kernel needs.
long htf_proxy_bwd_smem(int cap, int K, int ntypes) {
  return smem_bytes(cap, K, ntypes);
}

// Launch both passes on `stream`: per-cell partial sums into `partial`
// ([n_cells][P * 2K] scratch), then their sum into `out` ([P * 2K], per
// pair p: c-moments at p * 2K + k, cd-moments at p * 2K + K + k). Returns
// cudaGetLastError() after the launches (0 = ok).
int htf_proxy_bwd(const int* occ, const float* gx, const float* gy,
                  const float* gz, const int* gt, const float* cgx,
                  const float* cgy, const float* cgz, const float* cge,
                  const float* rcm, int rcm_t, int n_cells, int cap, int K,
                  int ntypes, float rc2, float min_r2, float mid,
                  float inv_half, float u_hi, float* partial, float* out,
                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long smem = smem_bytes(cap, K, ntypes);
  const int M = ntypes * (ntypes + 1) / 2 * 2 * K;
  if (cge != nullptr) {
    auto kernel = proxy_bwd_kernel<true>;
    if (smem > 48 * 1024) {
      cudaError_t e = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(smem));
      if (e != cudaSuccess) return static_cast<int>(e);
    }
    kernel<<<n_cells, kThreads, smem, s>>>(
        occ, gx, gy, gz, gt, cgx, cgy, cgz, cge, rcm, rcm_t, n_cells, cap, K,
        ntypes, rc2, min_r2, mid, inv_half, u_hi, partial);
  } else {
    auto kernel = proxy_bwd_kernel<false>;
    if (smem > 48 * 1024) {
      cudaError_t e = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(smem));
      if (e != cudaSuccess) return static_cast<int>(e);
    }
    kernel<<<n_cells, kThreads, smem, s>>>(
        occ, gx, gy, gz, gt, cgx, cgy, cgz, nullptr, rcm, rcm_t, n_cells,
        cap, K, ntypes, rc2, min_r2, mid, inv_half, u_hi, partial);
  }
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  reduce_partials<<<M, kThreads, 0, s>>>(partial, n_cells, M, out);
  return static_cast<int>(cudaGetLastError());
}

const char* htf_proxy_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
