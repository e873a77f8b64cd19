// Half-stencil (Newton's third law) pair-force kernel of the cellwise
// neighbor mode, hand-written for Hopper (sm_90a).
//
// Replaces: hoomd_tf_tpu/ops/cellwise_pallas.py::_kernel (the Pallas TPU
// kernel behind half_stencil_pair_forces). Same contract: for every cell
// c, its `cap` slot rows (block 0 of the candidate planes -- the self
// cell, zero offset) are tested against the 14*cap candidate lanes (the
// self cell plus 13 directed neighbour offsets), and each pair product
// feeds two reductions:
//   row side       out[k, c, r]        = fwd_k  * sum_j prod_k(r, j)
//   candidate side out[k, c, j >= cap] = back_k * sum_r prod_k(r, j)
// with channels k = [U] (energy, coefficients 0.5/0.5), s*dx, s*dy, s*dz
// (2/-2), [s*dx*dx, s*dy*dy, s*dz*dz, s*dx*dy, s*dx*dz, s*dy*dz] (-1/-1).
// The 13 inverse rolls that push the candidate blocks home stay in
// PyTorch (ops/cellwise.py::assemble_half), shared with the tensor forms.
//
// Masks: d2 <= rc2; the in-cell self pair is excluded by column index in
// block 0 (never by a small-d2 threshold); an optional per-type-pair
// rc2 table; r2 = max(d2, min_r2). The pair function is a functor the
// kernel is templated on:
//   LJForm   -- U = 4 eps (sr6^2 - sr6) + shift, sr6 = (sigma^2 / r2)^3,
//               cut at the form's own rc2 with <= (or < when `strict`, for
//               WCA), from a per-type-pair table of float4
//               (eps, sigma^2, shift, rc2_form);
//   ChebForm -- the Chebyshev proxy of a trained pair potential
//               (ops/chebyshev.py): u = 1/r2, w = clip((u - mid) * inv_half,
//               -1, 1), two Clenshaw recurrences over a [P][2][K] table of
//               coefficients (c, cd) staged in shared memory, and past u_hi
//               the C^1 linear continuation U_hi + s_hi (u - u_hi) with
//               U_hi = sum c, s_hi = sum cd. It returns (U, -su u^2). A typed
//               lane reads the row of its unordered type pair; types outside
//               the table contribute nothing (the JAX mask blend gives zero
//               coefficients there).
// Rows at or above the cell's occupancy are skipped (the analog of the
// Pallas kernel's 8-row-group predicate): real particles occupy a prefix
// of each cell's slots.
//
// What bounds it on an H100: the pair lanes. Each step evaluates about
// n_cells * occ * 14*cap pairs (~5.5e7 at the 64k fluid), each a handful
// of f32 FLOPs (about 6K more inside the cut for the proxy form's two
// Clenshaw series), a reciprocal and one warp-shuffle reduction per channel;
// the [n_cells, 14*cap] f32 planes are read once per cell (a few MB, far
// below the memory roof). The design keeps all of it on chip: one block
// per cell, a thread per candidate lane (striding over lanes in chunks
// of the block size, so any capacity works), the lane's candidate-side
// sums in registers across the whole row loop, and the row-side sums as
// warp shuffles into per-warp partials in shared memory, summed over
// warps in a fixed order. No atomics, so results are deterministic.
//
// Built with -fmad=false so that d2 and the pair products round exactly
// as the PyTorch reference's separate multiplies and adds do: the
// cutoff masks then agree bit for bit and only summation order differs.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// LJ family: read straight from the float4 table in global memory.
struct LJForm {
  const float4* tab;
  int t;
  int strict;

  __device__ __forceinline__ void stage(float*, int) const {}

  __device__ __forceinline__ bool operator()(float r2, int ti, int tj,
                                             float& U, float& s) const {
    const float4 f = tab[t == 1 ? 0 : ti * t + tj];
    const bool inside = strict ? (r2 < f.w) : (r2 <= f.w);
    if (!inside) return false;
    const float inv = 1.0f / r2;
    const float x = f.y * inv;
    const float sr6 = x * x * x;
    s = -12.0f * f.x * (2.0f * sr6 - 1.0f) * sr6 * inv;
    U = 4.0f * f.x * (sr6 * sr6 - sr6) + f.z;
    return true;
  }
};

// Sequential sum c[0] + c[1] + ... (the order of the plain version).
__device__ __forceinline__ float seq_sum(const float* c, int K) {
  float v = c[0];
  for (int k = 1; k < K; ++k) v = v + c[k];
  return v;
}

__device__ __forceinline__ float clenshaw(const float* c, int K, float w) {
  float b1 = 0.f, b2 = 0.f;
  const float two_w = 2.0f * w;
  for (int k = K - 1; k > 0; --k) {
    const float b = c[k] + two_w * b1 - b2;
    b2 = b1;
    b1 = b;
  }
  return c[0] + w * b1 - b2;
}

// Chebyshev proxy: the [P][2][K] coefficient table and the per-pair edge
// values (U_hi, s_hi) live in shared memory, staged once per block.
struct ChebForm {
  const float* coef;  // global [P][2][K]
  int T;              // types of the table (1 = untyped)
  int K;
  float mid, inv_half, u_hi;
  float* sm;          // shared [P][2][K] then [P][2] edge values

  __device__ __forceinline__ int pairs() const { return T * (T + 1) / 2; }

  __device__ __forceinline__ void stage(float* smem, int tid) {
    sm = smem;
    const int P = pairs();
    for (int i = tid; i < P * 2 * K; i += kThreads) sm[i] = coef[i];
    for (int i = tid; i < P * 2; i += kThreads)
      sm[P * 2 * K + i] = seq_sum(coef + i * K, K);
  }

  __device__ __forceinline__ bool operator()(float r2, int ti, int tj,
                                             float& U, float& s) const {
    int p = 0;
    if (T > 1) {
      if (ti < 0 || ti >= T || tj < 0 || tj >= T) return false;
      const int a = min(ti, tj), b = max(ti, tj);
      p = a * T - a * (a - 1) / 2 + (b - a);
    }
    const float* c = sm + p * 2 * K;
    const float* hi = sm + pairs() * 2 * K + p * 2;
    const float u = 1.0f / r2;
    const float over = fmaxf(u - u_hi, 0.f);
    float su;
    if (over <= 0.f) {
      const float w = fminf(fmaxf((u - mid) * inv_half, -1.0f), 1.0f);
      U = clenshaw(c, K, w);
      su = clenshaw(c + K, K, w);
    } else {
      U = hi[0] + hi[1] * over;
      su = hi[1];
    }
    s = -su * u * u;
    return true;
  }
};

template <bool ENERGY, bool VIRIAL>
struct Channels {
  static constexpr int kForce = ENERGY ? 1 : 0;
  static constexpr int kCount = 3 + (ENERGY ? 1 : 0) + (VIRIAL ? 6 : 0);
};

template <bool ENERGY, bool VIRIAL, class Form>
__global__ void __launch_bounds__(kThreads)
half_stencil_kernel(const int* __restrict__ occ,
                    const float* __restrict__ gx,
                    const float* __restrict__ gy,
                    const float* __restrict__ gz,
                    const int* __restrict__ gt, Form form,
                    const float* __restrict__ rcm, int rcm_t,
                    int n_cells, int cap, float rc2, float min_r2,
                    float* __restrict__ out) {
  using Ch = Channels<ENERGY, VIRIAL>;
  constexpr int NCH = Ch::kCount;
  constexpr int OF = Ch::kForce;
  extern __shared__ float smem[];
  const int C = 14 * cap;
  const int c = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  float* qx = smem;
  float* qy = qx + cap;
  float* qz = qy + cap;
  int* qt = reinterpret_cast<int*>(qz + cap);
  float* red = reinterpret_cast<float*>(qt + cap);  // [kWarps][cap][NCH]
  form.stage(red + kWarps * cap * NCH, tid);  // the form's own table

  const size_t base = static_cast<size_t>(c) * C;
  const size_t plane = static_cast<size_t>(n_cells) * C;
  const int o = min(max(occ[c], 0), cap);

  float cf[NCH], cb[NCH];
#pragma unroll
  for (int k = 0; k < NCH; ++k) {
    const bool energy = ENERGY && k == 0;
    const bool force = !energy && k < OF + 3;
    cf[k] = energy ? 0.5f : (force ? 2.0f : -1.0f);
    cb[k] = energy ? 0.5f : (force ? -2.0f : -1.0f);
  }

  for (int r = tid; r < cap; r += kThreads) {
    qx[r] = gx[base + r];
    qy[r] = gy[base + r];
    qz[r] = gz[base + r];
    qt[r] = gt ? gt[base + r] : 0;
  }
  for (int i = tid; i < kWarps * cap * NCH; i += kThreads) red[i] = 0.f;
  __syncthreads();

  for (int j0 = 0; j0 < C; j0 += kThreads) {
    const int j = j0 + tid;
    const bool active = j < C;
    float xj = 0.f, yj = 0.f, zj = 0.f;
    int tj = 0;
    if (active) {
      xj = gx[base + j];
      yj = gy[base + j];
      zj = gz[base + j];
      tj = gt ? gt[base + j] : 0;
    }
    float back[NCH];
#pragma unroll
    for (int k = 0; k < NCH; ++k) back[k] = 0.f;

    for (int r = 0; r < o; ++r) {
      float p[NCH];
#pragma unroll
      for (int k = 0; k < NCH; ++k) p[k] = 0.f;
      if (active) {
        const float dx = xj - qx[r];
        const float dy = yj - qy[r];
        const float dz = zj - qz[r];
        const float d2 = dx * dx + dy * dy + dz * dz;
        const int ti = qt[r];
        bool ok = d2 <= rc2 && !(j < cap && j == r);
        if (rcm != nullptr) {
          const bool known = ti >= 0 && ti < rcm_t && tj >= 0 && tj < rcm_t;
          const float prc2 = known ? rcm[ti * rcm_t + tj] : 0.f;
          ok = ok && d2 <= prc2;
        }
        float U, s;
        if (ok && form(fmaxf(d2, min_r2), ti, tj, U, s)) {
          if (ENERGY) p[0] = U;
          const float sdx = s * dx, sdy = s * dy, sdz = s * dz;
          p[OF] = sdx;
          p[OF + 1] = sdy;
          p[OF + 2] = sdz;
          if (VIRIAL) {
            p[OF + 3] = sdx * dx;
            p[OF + 4] = sdy * dy;
            p[OF + 5] = sdz * dz;
            p[OF + 6] = sdx * dy;
            p[OF + 7] = sdx * dz;
            p[OF + 8] = sdy * dz;
          }
        }
      }
#pragma unroll
      for (int k = 0; k < NCH; ++k) {
        back[k] += p[k];
        float v = p[k];
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          v += __shfl_xor_sync(0xffffffffu, v, off);
        if (lane == 0) red[(warp * cap + r) * NCH + k] += v;
      }
    }
    if (active && j >= cap) {
#pragma unroll
      for (int k = 0; k < NCH; ++k) out[k * plane + base + j] = cb[k] * back[k];
    }
  }
  __syncthreads();

  for (int r = tid; r < cap; r += kThreads) {
#pragma unroll
    for (int k = 0; k < NCH; ++k) {
      float v = 0.f;
      for (int w = 0; w < kWarps; ++w) v += red[(w * cap + r) * NCH + k];
      out[k * plane + base + r] = r < o ? cf[k] * v : 0.f;
    }
  }
}

template <bool ENERGY, bool VIRIAL, class Form>
int launch(const int* occ, const float* gx, const float* gy, const float* gz,
           const int* gt, Form form, int form_floats, const float* rcm,
           int rcm_t, int n_cells, int cap, float rc2, float min_r2,
           float* out, cudaStream_t stream) {
  constexpr int NCH = Channels<ENERGY, VIRIAL>::kCount;
  const size_t smem = sizeof(float) * 4 * cap +
                      sizeof(float) * kWarps * cap * NCH +
                      sizeof(float) * form_floats;
  auto kernel = half_stencil_kernel<ENERGY, VIRIAL, Form>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kernel<<<n_cells, kThreads, smem, stream>>>(
      occ, gx, gy, gz, gt, form, rcm, rcm_t, n_cells, cap, rc2, min_r2, out);
  return static_cast<int>(cudaGetLastError());
}

template <class Form>
int dispatch(const int* occ, const float* gx, const float* gy,
             const float* gz, const int* gt, Form form, int form_floats,
             const float* rcm, int rcm_t, int n_cells, int cap, float rc2,
             float min_r2, int needs_energy, int needs_virial, float* out,
             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (needs_energy && needs_virial)
    return launch<true, true>(occ, gx, gy, gz, gt, form, form_floats, rcm,
                              rcm_t, n_cells, cap, rc2, min_r2, out, s);
  if (needs_energy)
    return launch<true, false>(occ, gx, gy, gz, gt, form, form_floats, rcm,
                               rcm_t, n_cells, cap, rc2, min_r2, out, s);
  if (needs_virial)
    return launch<false, true>(occ, gx, gy, gz, gt, form, form_floats, rcm,
                               rcm_t, n_cells, cap, rc2, min_r2, out, s);
  return launch<false, false>(occ, gx, gy, gz, gt, form, form_floats, rcm,
                              rcm_t, n_cells, cap, rc2, min_r2, out, s);
}

}  // namespace

extern "C" {

// Shared-memory bytes one block needs (the wrapper checks the limit);
// `form_floats` is the pair form's own table (0 for the LJ form).
long htf_half_stencil_smem(int cap, int n_channels, int form_floats) {
  return static_cast<long>(sizeof(float)) *
         (4L * cap + 1L * kWarps * cap * n_channels + form_floats);
}

// LJ-family form. Launch on `stream`; returns cudaGetLastError() of the
// launch (0 = ok).
int htf_half_stencil(const int* occ, const float* gx, const float* gy,
                     const float* gz, const int* gt, const float* form,
                     int form_t, int strict, const float* rcm, int rcm_t,
                     int n_cells, int cap, float rc2, float min_r2,
                     int needs_energy, int needs_virial, float* out,
                     void* stream) {
  LJForm f{reinterpret_cast<const float4*>(form), form_t, strict};
  return dispatch(occ, gx, gy, gz, gt, f, 0, rcm, rcm_t, n_cells, cap, rc2,
                  min_r2, needs_energy, needs_virial, out, stream);
}

// Chebyshev-proxy form: `coef` is the [P][2][K] float32 table of a
// `ntypes`-type proxy (P = ntypes (ntypes + 1) / 2).
int htf_half_stencil_cheb(const int* occ, const float* gx, const float* gy,
                          const float* gz, const int* gt, const float* coef,
                          int ntypes, int K, float mid, float inv_half,
                          float u_hi, const float* rcm, int rcm_t,
                          int n_cells, int cap, float rc2, float min_r2,
                          int needs_energy, int needs_virial, float* out,
                          void* stream) {
  ChebForm f{coef, ntypes, K, mid, inv_half, u_hi, nullptr};
  const int P = ntypes * (ntypes + 1) / 2;
  return dispatch(occ, gx, gy, gz, gt, f, P * 2 * K + P * 2, rcm, rcm_t,
                  n_cells, cap, rc2, min_r2, needs_energy, needs_virial, out,
                  stream);
}

const char* htf_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
