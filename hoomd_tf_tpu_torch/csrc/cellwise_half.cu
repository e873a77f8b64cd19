// Half-stencil (Newton's third law) pair-force kernel K1 of the cellwise
// neighbor mode, hand-written for Hopper (sm_90a).
//
// Replaces: hoomd_tf_tpu/ops/cellwise_pallas.py::_kernel (the Pallas TPU
// kernel behind half_stencil_pair_forces; its variants _kernel_row and
// _kernel_mm compute the same function). Same function: every occupied
// slot row i of cell c against the occupied slots j of the 14 cells of the
// half stencil (the self cell and 13 directed offsets), with
//   d = g_j - q_i, d2 = dx*dx + dy*dy + dz*dz, kept when d2 <= rc2 (and
//   d2 <= rc2_tab[ti][tj] when a per-type cutoff table is given), the self
//   pair excluded by staged index in block 0, r2 = max(d2, min_r2),
// and each pair product feeding two sums per channel:
//   row side        F_i += fwd_k  * prod_k(i, j)   over all 14 blocks
//   candidate side  F_j += back_k * prod_k(i, j)   over blocks 1..13
// with channels k = [U] (energy, coefficients 0.5/0.5), s*dx, s*dy, s*dz
// (2/-2), [s*dx*dx, s*dy*dy, s*dz*dz, s*dx*dy, s*dx*dz, s*dy*dz] (-1/-1),
// s = dU/dr2. The result is forces4 [n_slots, 4] (energy in column 4) and
// the [n_slots, 3, 3] virial, ghost rows zero.
//
// The pair function is a functor the kernel is templated on:
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
//               the table contribute nothing.
//
// Two launches, no float atomics, deterministic:
//   half_stencil_forces, one block per home cell. The block stages the
//     occupied slots of its 14 cells from the slot-ordered state, those
//     of the 13 directed blocks only within the cut of the home rows'
//     bounding box (half_stencil_stage.cuh; a slot left out gets zero
//     back sums), then
//     - a row sweep: threads own (row, candidate segment) pairs, keep the
//       row's sums in registers over their segment, and the segments are
//       added in a fixed order through shared memory;
//     - a candidate sweep: threads own the candidates of blocks 1..13 and
//       keep their back sums in registers over the cell's rows.
//     A lane inside the cut evaluates the pair function once in each
//     sweep. It writes sums[k][0][slot] (row side, the home slots) and
//     sums[k][t][c * cap + r] (candidate side of block t, rank r), raw.
//   half_stencil_home, one thread per slot: the row sum plus the 13 back
//     sums of the cells c - off_t, in the order t = 1..13 of
//     ops/cellwise.py::assemble_half, times the channel coefficients and
//     `valid`, written as forces4 and the virial (finish_forces' work).
//
// What bounds it on an H100: operations. The function needs the slot state
// read once (positions, valid; types when typed) and forces4 written once,
// ~4 MB at the 64k eval shapes, against ~3.3e7 occupied x occupied
// half-stencil pairs, each ~9 float32 operations of displacement, d2 and cut
// test, plus the pair form and the products for the ~5% inside the cut:
// ~0.35 G operations, ~0.005 ms at 67 TFLOP/s. The staging walks
// occupied slots only (about half of a cell's 14 * cap slots), and of the
// directed blocks only the ~40% within reach of the rows' box, so the
// sweeps test about a quarter of the 14 * cap lanes per row. The 14 cells
// are read straight from the state (each slot by 14 blocks, mostly from
// L2): no candidate plane and no roll, and the 14 [n_ch, n_slots] partial
// planes between the two launches are the only intermediate. A directed lane is tested in both sweeps, and inside the
// cut its pair function runs in both: part of the work left above the
// bound.
//
// Built with -fmad=false, and the staging uses _rn intrinsics, so that d2
// and the pair products round exactly as the PyTorch plain version's
// separate multiplies and adds do: the cutoff masks then agree bit for bit
// and only summation order differs.

#include <cuda_runtime.h>

#include "half_stencil_stage.cuh"

namespace {

using htf::HalfGeom;
using htf::kHalf;
using htf::kStageInts;
using htf::kThreads;

// LJ family: read straight from the float4 table in global memory.
struct LJForm {
  const float4* tab;
  int t;
  int strict;

  __device__ __forceinline__ void stage(float*, int) {}

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

// The channel products of the lane (row q, candidate g); false (and `p`
// untouched) outside the cut.
template <bool ENERGY, bool VIRIAL, class Form>
__device__ __forceinline__ bool lane_products(
    float4 q, float4 g, const Form& form, const float* __restrict__ rcm,
    int rcm_t, float rc2, float min_r2,
    float (&p)[Channels<ENERGY, VIRIAL>::kCount]) {
  constexpr int OF = Channels<ENERGY, VIRIAL>::kForce;
  const float dx = g.x - q.x;
  const float dy = g.y - q.y;
  const float dz = g.z - q.z;
  const float d2 = dx * dx + dy * dy + dz * dz;
  if (!(d2 <= rc2)) return false;
  const int ti = __float_as_int(q.w), tj = __float_as_int(g.w);
  if (rcm != nullptr) {
    const bool known = ti >= 0 && ti < rcm_t && tj >= 0 && tj < rcm_t;
    const float prc2 = known ? rcm[ti * rcm_t + tj] : 0.f;
    if (!(d2 <= prc2)) return false;
  }
  float U, s;
  if (!form(fmaxf(d2, min_r2), ti, tj, U, s)) return false;
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
  return true;
}

template <bool ENERGY, bool VIRIAL, class Form>
__global__ void __launch_bounds__(kThreads)
half_stencil_forces(const float* __restrict__ pos,
                    const int* __restrict__ types,
                    const float* __restrict__ valid,
                    const float* __restrict__ centers, HalfGeom g, Form form,
                    const float* __restrict__ rcm, int rcm_t, float rc2,
                    float min_r2, float* __restrict__ sums) {
  constexpr int NCH = Channels<ENERGY, VIRIAL>::kCount;
  extern __shared__ float4 smem4[];
  const int cap = g.cap;
  const int C = kHalf * cap;
  const int c = blockIdx.x;
  const int tid = threadIdx.x;
  const size_t n_slots = static_cast<size_t>(gridDim.x) * cap;
  float4* spos = smem4;                                   // [C]
  int* stag = reinterpret_cast<int*>(spos + C);           // [C]
  int* sints = stag + C;                                  // [kStageInts]
  float* part = reinterpret_cast<float*>(sints + kStageInts);  // [kThreads][NCH]
  form.stage(part + kThreads * NCH, tid);  // the form's own table

  const size_t home = static_cast<size_t>(c) * cap;
  int n0;
  const int total = htf::stage_half_stencil(
      g, c, rc2, pos, types, valid, centers, spos, stag, sints, n0,
      htf::NoExtra(), [&](int t, int r) {
        // a slot out of every row's reach: its back sums are zero
#pragma unroll
        for (int k = 0; k < NCH; ++k)
          sums[(k * kHalf + t) * n_slots + home + r] = 0.f;
      });

  // row sweep: the row sums of the home slots over all 14 blocks
  for (int r0 = 0; r0 < n0; r0 += kThreads) {
    const htf::RowSplit sp(r0, n0);
    if (sp.active) {
      float acc[NCH];
#pragma unroll
      for (int k = 0; k < NCH; ++k) acc[k] = 0.f;
      const float4 q = spos[sp.row];
      for (int j = sp.seg; j < total; j += sp.nseg) {
        if (j == sp.row) continue;  // the self pair (block 0)
        float p[NCH];
        if (lane_products<ENERGY, VIRIAL>(q, spos[j], form, rcm, rcm_t, rc2,
                                          min_r2, p)) {
#pragma unroll
          for (int k = 0; k < NCH; ++k) acc[k] += p[k];
        }
      }
#pragma unroll
      for (int k = 0; k < NCH; ++k) part[tid * NCH + k] = acc[k];
    }
    __syncthreads();
    if (tid < sp.rows) {
      const size_t out = home + stag[r0 + tid];  // block 0: tag = rank
#pragma unroll
      for (int k = 0; k < NCH; ++k) {
        float v = 0.f;
        for (int s = 0; s < sp.nseg; ++s) v += part[(tid * sp.nseg + s) * NCH + k];
        sums[k * kHalf * n_slots + out] = v;
      }
    }
    __syncthreads();
  }

  // candidate sweep: the back sums of the directed blocks' slots
  for (int j = n0 + tid; j < total; j += kThreads) {
    float acc[NCH];
#pragma unroll
    for (int k = 0; k < NCH; ++k) acc[k] = 0.f;
    const float4 gj = spos[j];
    for (int i = 0; i < n0; ++i) {
      float p[NCH];
      if (lane_products<ENERGY, VIRIAL>(spos[i], gj, form, rcm, rcm_t, rc2,
                                        min_r2, p)) {
#pragma unroll
        for (int k = 0; k < NCH; ++k) acc[k] += p[k];
      }
    }
    const int tag = stag[j];
    const int t = tag / cap;
    const size_t out = static_cast<size_t>(t) * n_slots + home + (tag - t * cap);
#pragma unroll
    for (int k = 0; k < NCH; ++k) sums[k * kHalf * n_slots + out] = acc[k];
  }
}

// One thread per slot: the Newton push-back and the finish.
template <bool ENERGY, bool VIRIAL>
__global__ void __launch_bounds__(kThreads)
half_stencil_home(const float* __restrict__ sums,
                  const float* __restrict__ valid, HalfGeom g, int n_slots,
                  float4* __restrict__ forces4, float* __restrict__ virial) {
  using Ch = Channels<ENERGY, VIRIAL>;
  constexpr int NCH = Ch::kCount;
  constexpr int OF = Ch::kForce;
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n_slots) return;
  const float v = valid[i];
  float acc[NCH];
#pragma unroll
  for (int k = 0; k < NCH; ++k) acc[k] = 0.f;
  if (v != 0.f) {
    const size_t plane = static_cast<size_t>(n_slots);
    const int c = i / g.cap, r = i - c * g.cap;
#pragma unroll
    for (int k = 0; k < NCH; ++k) {
      const bool energy = ENERGY && k == 0;
      const float cf = energy ? 0.5f : (k < OF + 3 ? 2.0f : -1.0f);
      acc[k] = cf * sums[k * kHalf * plane + i];
    }
    for (int t = 1; t < kHalf; ++t) {
      const size_t src = static_cast<size_t>(htf::shifted_cell(g, c, t, -1)) *
                             g.cap + r;
#pragma unroll
      for (int k = 0; k < NCH; ++k) {
        const bool energy = ENERGY && k == 0;
        const float cb = energy ? 0.5f : (k < OF + 3 ? -2.0f : -1.0f);
        acc[k] = acc[k] + cb * sums[(k * kHalf + t) * plane + src];
      }
    }
#pragma unroll
    for (int k = 0; k < NCH; ++k) acc[k] = acc[k] * v;
  }
  forces4[i] = make_float4(acc[OF], acc[OF + 1], acc[OF + 2],
                           ENERGY ? acc[0] : 0.f);
  if (VIRIAL) {
    // channels xx, yy, zz, xy, xz, yz -> the symmetric 3x3, row major
    float* w = virial + static_cast<size_t>(i) * 9;
    w[0] = acc[OF + 3];
    w[1] = acc[OF + 6];
    w[2] = acc[OF + 7];
    w[3] = acc[OF + 6];
    w[4] = acc[OF + 4];
    w[5] = acc[OF + 8];
    w[6] = acc[OF + 7];
    w[7] = acc[OF + 8];
    w[8] = acc[OF + 5];
  }
}

long smem_bytes(int cap, int n_ch, int form_floats) {
  return static_cast<long>(kHalf) * cap * (sizeof(float4) + sizeof(int)) +
         static_cast<long>(sizeof(int)) * kStageInts +
         static_cast<long>(sizeof(float)) * (kThreads * n_ch + form_floats);
}

template <bool ENERGY, bool VIRIAL, class Form>
int launch(const float* pos, const int* types, const float* valid,
           const float* centers, const HalfGeom& g, int n_cells, Form form,
           int form_floats, const float* rcm, int rcm_t, float rc2,
           float min_r2, float* sums, float* forces4, float* virial,
           cudaStream_t stream) {
  constexpr int NCH = Channels<ENERGY, VIRIAL>::kCount;
  const long smem = smem_bytes(g.cap, NCH, form_floats);
  auto kernel = half_stencil_forces<ENERGY, VIRIAL, Form>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kernel<<<n_cells, kThreads, smem, stream>>>(pos, types, valid, centers, g,
                                              form, rcm, rcm_t, rc2, min_r2,
                                              sums);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const int n_slots = n_cells * g.cap;
  half_stencil_home<ENERGY, VIRIAL>
      <<<(n_slots + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
          sums, valid, g, n_slots, reinterpret_cast<float4*>(forces4),
          virial);
  return static_cast<int>(cudaGetLastError());
}

template <class Form>
int dispatch(const float* pos, const int* types, const float* valid,
             const float* centers, const HalfGeom* geom, int n_cells,
             Form form, int form_floats, const float* rcm, int rcm_t,
             float rc2, float min_r2, int needs_energy, int needs_virial,
             float* sums, float* forces4, float* virial, void* stream) {
  const HalfGeom g = *geom;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (needs_energy && needs_virial)
    return launch<true, true>(pos, types, valid, centers, g, n_cells, form,
                              form_floats, rcm, rcm_t, rc2, min_r2, sums,
                              forces4, virial, s);
  if (needs_energy)
    return launch<true, false>(pos, types, valid, centers, g, n_cells, form,
                               form_floats, rcm, rcm_t, rc2, min_r2, sums,
                               forces4, virial, s);
  if (needs_virial)
    return launch<false, true>(pos, types, valid, centers, g, n_cells, form,
                               form_floats, rcm, rcm_t, rc2, min_r2, sums,
                               forces4, virial, s);
  return launch<false, false>(pos, types, valid, centers, g, n_cells, form,
                              form_floats, rcm, rcm_t, rc2, min_r2, sums,
                              forces4, virial, s);
}

}  // namespace

extern "C" {

// Shared-memory bytes one block of half_stencil_forces needs (the wrapper
// checks the limit); `form_floats` is the pair form's own table (0 for the
// LJ form).
long htf_half_stencil_smem(int cap, int n_channels, int form_floats) {
  return smem_bytes(cap, n_channels, form_floats);
}

// LJ-family form. `pos` [n_slots][3], `types` [n_slots] int32 (or null when
// untyped), `valid` [n_slots], `centers` [n_slots][3], `geom` a host
// HalfGeom, `sums` the [n_ch][14][n_slots] scratch, `forces4`
// [n_slots][4], `virial` [n_slots][9] (or null). Launches both kernels on
// `stream`; returns cudaGetLastError() after them (0 = ok).
int htf_half_stencil(const float* pos, const int* types, const float* valid,
                     const float* centers, const HalfGeom* geom, int n_cells,
                     const float* form, int form_t, int strict,
                     const float* rcm, int rcm_t, float rc2, float min_r2,
                     int needs_energy, int needs_virial, float* sums,
                     float* forces4, float* virial, void* stream) {
  LJForm f{reinterpret_cast<const float4*>(form), form_t, strict};
  return dispatch(pos, types, valid, centers, geom, n_cells, f, 0, rcm, rcm_t,
                  rc2, min_r2, needs_energy, needs_virial, sums, forces4,
                  virial, stream);
}

// Chebyshev-proxy form: `coef` is the [P][2][K] float32 table of a
// `ntypes`-type proxy (P = ntypes (ntypes + 1) / 2).
int htf_half_stencil_cheb(const float* pos, const int* types,
                          const float* valid, const float* centers,
                          const HalfGeom* geom, int n_cells, const float* coef,
                          int ntypes, int K, float mid, float inv_half,
                          float u_hi, const float* rcm, int rcm_t, float rc2,
                          float min_r2, int needs_energy, int needs_virial,
                          float* sums, float* forces4, float* virial,
                          void* stream) {
  ChebForm f{coef, ntypes, K, mid, inv_half, u_hi, nullptr};
  const int P = ntypes * (ntypes + 1) / 2;
  return dispatch(pos, types, valid, centers, geom, n_cells, f,
                  P * 2 * K + P * 2, rcm, rcm_t, rc2, min_r2, needs_energy,
                  needs_virial, sums, forces4, virial, stream);
}

const char* htf_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
