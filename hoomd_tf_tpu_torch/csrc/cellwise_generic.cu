// Kernel K1's generic form: half-stencil pair forces of a pair function the
// kernel cannot compile, hand-written for Hopper (sm_90a).
//
// Replaces: hoomd_tf_tpu/ops/cellwise_pallas.py::_kernel with an arbitrary
// traced pair function (cellwise_pallas.py:540-605 replays the pair_fn's
// jaxpr inside the kernel). A CUDA kernel cannot run user PyTorch code, so
// the call is split at the pair function:
//
//   generic_list, one block per home cell: it stages the cell's half
//     stencil (half_stencil_stage.cuh, as K1 does), marks the lanes inside
//     the cut, and writes them into a compact list (r2, ti, tj):
//       lane (i, j), i a staged home row, j a staged candidate of the 14
//       blocks, kept when d2 <= rc2 (and d2 <= rc2_tab[ti][tj] when a
//       per-type table is given), j != i (the self pair, by staged index),
//       r2 = max(d2, min_r2), the types as floats.
//     A cell's lanes are row-major (rows and candidates in staged order),
//     so their order is fixed by the home cell and its sweep. The cell's
//     segment is placed by one atomicAdd on a device counter; a cell whose
//     segment would pass the list's budget writes nothing and its base is
//     -1. The counter ends at the lanes the call needed, budget or not.
//   the pair function, evaluated by PyTorch on the whole list:
//     U, s = pair_fn(r2, ti, tj), s = dU/dr2 (user code: the counterpart
//     of the jaxpr Pallas inlines).
//   generic_reduce, one block per home cell: it stages the same cells and
//     marks the same lanes (the same float32 operations, so the same bits),
//     reads each lane's (U, s) by its list index, with no atomics, and
//     makes K1's row sweep (a warp per row, lanes summed by a fixed
//     shuffle tree) and candidate sweep (a thread per candidate of blocks
//     1..13, rows in order), writing the raw sums of K1's channels. Block 0
//     copies the counter out and zeroes it for the next call.
//   half_stencil_home (half_stencil_home.cuh): the Newton push-back and the
//     finish, as in K1.
// The list's placement varies from call to call; the values do not: each
// lane's (U, s) is a function of the lane, and every sum runs in a fixed
// order. A cell that did not fit (base -1) contributes zero sums; the
// caller sees the overflow in the needed count and re-runs with a larger
// budget.
//
// What bounds it on an H100: the same operations as K1 (9 per tested pair,
// the products per in-cut lane), now done twice (each kernel marks every
// lane), plus the list: 12 bytes written and 8 read per in-cut lane (about
// 2.7e6 lanes, ~54 MB at the 64k fluid's shapes) against ~4 MB of slot
// state. Each lane's mask is kept as a bit in shared memory (a 32-bit word
// per row and warp-wide chunk of candidates, with the row's running count
// before it), so the candidate sweep finds a lane's list index with one
// population count.
//
// Built with -fmad=false, and the staging uses _rn intrinsics, so the
// masks and r2 are bit-equal to the PyTorch plain version's.

#include <cuda_runtime.h>
#include <stdint.h>

#include "half_stencil_home.cuh"
#include "half_stencil_stage.cuh"

namespace {

using htf::Channels;
using htf::HalfGeom;
using htf::half_stencil_home;
using htf::kHalf;
using htf::kStageInts;
using htf::kThreads;
using htf::kWarps;

// d2 of the lane (row q, candidate g) and whether it is inside the cut.
__device__ __forceinline__ bool in_cut(float4 q, float4 g,
                                       const float* __restrict__ rcm,
                                       int rcm_t, float rc2, float& dx,
                                       float& dy, float& dz, float& d2) {
  dx = g.x - q.x;
  dy = g.y - q.y;
  dz = g.z - q.z;
  d2 = dx * dx + dy * dy + dz * dz;
  if (!(d2 <= rc2)) return false;
  if (rcm != nullptr) {
    const int ti = __float_as_int(q.w), tj = __float_as_int(g.w);
    const bool known = ti >= 0 && ti < rcm_t && tj >= 0 && tj < rcm_t;
    const float prc2 = known ? rcm[ti * rcm_t + tj] : 0.f;
    if (!(d2 <= prc2)) return false;
  }
  return true;
}

// The block's shared memory after the staged arrays.
struct LaneSmem {
  int* rowoff;     // [cap + 1] each row's first lane in the cell's segment
  int* scratch;    // [2]
  uint32_t* mask;  // [cap][W] in-cut bits, candidate j = 32 w + bit
  uint16_t* pre;   // [cap][W] the row's in-cut lanes before word w
  int W;
};

__device__ __forceinline__ LaneSmem lane_smem(int* after_stage, int cap) {
  LaneSmem s;
  s.W = (kHalf * cap + 31) / 32;
  s.rowoff = after_stage;
  s.scratch = s.rowoff + cap + 1;
  s.mask = reinterpret_cast<uint32_t*>(s.scratch + 2);
  s.pre = reinterpret_cast<uint16_t*>(s.mask + cap * s.W);
  return s;
}

long smem_bytes(int cap) {
  const long C = static_cast<long>(kHalf) * cap;
  const long W = (C + 31) / 32;
  return C * (sizeof(float4) + sizeof(int)) + sizeof(int) * kStageInts +
         sizeof(int) * (cap + 1 + 2) + (sizeof(uint32_t) + sizeof(uint16_t)) *
         cap * W;
}

// Mark the in-cut lanes of the n0 staged rows against the `total` staged
// candidates, a warp per row; fills mask, pre and rowoff (an exclusive
// scan over rows). Returns the cell's lane count. Every thread calls it.
__device__ int mark_lanes(const float4* spos, int n0, int total,
                          const float* __restrict__ rcm, int rcm_t,
                          float rc2, const LaneSmem& s) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nw = (total + 31) / 32;
  for (int i = warp; i < n0; i += kWarps) {
    const float4 q = spos[i];
    int run = 0;
    for (int w = 0; w < nw; ++w) {
      const int j = w * 32 + lane;
      bool ok = false;
      if (j < total && j != i) {
        float dx, dy, dz, d2;
        ok = in_cut(q, spos[j], rcm, rcm_t, rc2, dx, dy, dz, d2);
      }
      const unsigned b = __ballot_sync(0xffffffffu, ok);
      if (lane == 0) {
        s.mask[i * s.W + w] = b;
        s.pre[i * s.W + w] = static_cast<uint16_t>(run);
      }
      run += __popc(b);
    }
    if (lane == 0) s.rowoff[i + 1] = run;
  }
  __syncthreads();
  if (tid == 0) {
    s.rowoff[0] = 0;
    for (int i = 1; i <= n0; ++i) s.rowoff[i] += s.rowoff[i - 1];
  }
  __syncthreads();
  return s.rowoff[n0];
}

__global__ void __launch_bounds__(kThreads)
generic_list(const float* __restrict__ pos, const int* __restrict__ types,
             const float* __restrict__ valid,
             const float* __restrict__ centers, HalfGeom g,
             const float* __restrict__ rcm, int rcm_t, float rc2,
             float min_r2, int budget, int* __restrict__ counter,
             int* __restrict__ cell_base, float* __restrict__ r2_out,
             float* __restrict__ ti_out, float* __restrict__ tj_out) {
  extern __shared__ float4 smem4[];
  const int cap = g.cap;
  const int C = kHalf * cap;
  const int c = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  float4* spos = smem4;
  int* stag = reinterpret_cast<int*>(spos + C);
  int* sints = stag + C;
  const LaneSmem s = lane_smem(sints + kStageInts, cap);

  int n0;
  const int total = htf::stage_half_stencil(
      g, c, rc2, pos, types, valid, centers, spos, stag, sints, n0,
      htf::NoExtra(), htf::NoSkip());
  const int n_lanes = mark_lanes(spos, n0, total, rcm, rcm_t, rc2, s);
  if (tid == 0) {
    int b = atomicAdd(counter, n_lanes);
    if (b > budget - n_lanes) b = -1;  // the segment does not fit
    cell_base[c] = b;
    s.scratch[0] = b;
  }
  __syncthreads();
  const int base = s.scratch[0];
  if (base < 0) return;
  const unsigned below = (1u << lane) - 1u;
  for (int i = warp; i < n0; i += kWarps) {
    const float4 q = spos[i];
    const int row = base + s.rowoff[i];
    const int nw = (total + 31) / 32;
    for (int w = 0; w < nw; ++w) {
      const unsigned b = s.mask[i * s.W + w];
      if ((b >> lane) & 1u) {
        const float4 gj = spos[w * 32 + lane];
        float dx, dy, dz, d2;
        in_cut(q, gj, rcm, rcm_t, rc2, dx, dy, dz, d2);
        const int k = row + s.pre[i * s.W + w] + __popc(b & below);
        r2_out[k] = fmaxf(d2, min_r2);
        ti_out[k] = static_cast<float>(__float_as_int(q.w));
        tj_out[k] = static_cast<float>(__float_as_int(gj.w));
      }
    }
  }
}

// The channel products of the lane (row q, candidate g) with its (U, s).
template <bool ENERGY, bool VIRIAL>
__device__ __forceinline__ void add_products(
    float dx, float dy, float dz, float U, float sl,
    float (&acc)[Channels<ENERGY, VIRIAL>::kCount]) {
  constexpr int OF = Channels<ENERGY, VIRIAL>::kForce;
  if (ENERGY) acc[0] += U;
  const float sdx = sl * dx, sdy = sl * dy, sdz = sl * dz;
  acc[OF] += sdx;
  acc[OF + 1] += sdy;
  acc[OF + 2] += sdz;
  if (VIRIAL) {
    acc[OF + 3] += sdx * dx;
    acc[OF + 4] += sdy * dy;
    acc[OF + 5] += sdz * dz;
    acc[OF + 6] += sdx * dy;
    acc[OF + 7] += sdx * dz;
    acc[OF + 8] += sdy * dz;
  }
}

template <bool ENERGY, bool VIRIAL>
__global__ void __launch_bounds__(kThreads)
generic_reduce(const float* __restrict__ pos, const int* __restrict__ types,
               const float* __restrict__ valid,
               const float* __restrict__ centers, HalfGeom g,
               const float* __restrict__ rcm, int rcm_t, float rc2,
               const int* __restrict__ cell_base,
               const float* __restrict__ U, const float* __restrict__ S,
               float* __restrict__ sums, int* __restrict__ counter,
               int* __restrict__ needed) {
  constexpr int NCH = Channels<ENERGY, VIRIAL>::kCount;
  extern __shared__ float4 smem4[];
  const int cap = g.cap;
  const int C = kHalf * cap;
  const int c = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t n_slots = static_cast<size_t>(gridDim.x) * cap;
  float4* spos = smem4;
  int* stag = reinterpret_cast<int*>(spos + C);
  int* sints = stag + C;
  const LaneSmem s = lane_smem(sints + kStageInts, cap);
  if (c == 0 && tid == 0) {
    // every block of generic_list has finished: hand the count out and
    // zero the counter for the next call
    *needed = *counter;
    *counter = 0;
  }

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
  mark_lanes(spos, n0, total, rcm, rcm_t, rc2, s);
  const int base = cell_base[c];  // -1: the cell's lanes are not listed
  const unsigned below = (1u << lane) - 1u;

  // row sweep: a warp per home row, over all 14 blocks
  for (int i = warp; i < n0; i += kWarps) {
    float acc[NCH];
#pragma unroll
    for (int k = 0; k < NCH; ++k) acc[k] = 0.f;
    const float4 q = spos[i];
    const int row = base + s.rowoff[i];
    const int nw = (total + 31) / 32;
    for (int w = 0; base >= 0 && w < nw; ++w) {
      const unsigned b = s.mask[i * s.W + w];
      if ((b >> lane) & 1u) {
        float dx, dy, dz, d2;
        in_cut(q, spos[w * 32 + lane], rcm, rcm_t, rc2, dx, dy, dz, d2);
        const int k = row + s.pre[i * s.W + w] + __popc(b & below);
        add_products<ENERGY, VIRIAL>(dx, dy, dz, U[k], S[k], acc);
      }
    }
#pragma unroll
    for (int k = 0; k < NCH; ++k) {
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        acc[k] += __shfl_xor_sync(0xffffffffu, acc[k], o);
    }
    if (lane == 0) {
      const size_t out = home + stag[i];  // block 0: tag = rank
#pragma unroll
      for (int k = 0; k < NCH; ++k) sums[k * kHalf * n_slots + out] = acc[k];
    }
  }

  // candidate sweep: the back sums of the directed blocks' slots
  for (int j = n0 + tid; j < total; j += kThreads) {
    float acc[NCH];
#pragma unroll
    for (int k = 0; k < NCH; ++k) acc[k] = 0.f;
    const float4 gj = spos[j];
    const int w = j >> 5;
    const unsigned bit = 1u << (j & 31);
    for (int i = 0; base >= 0 && i < n0; ++i) {
      const unsigned m = s.mask[i * s.W + w];
      if (m & bit) {
        float dx, dy, dz, d2;
        in_cut(spos[i], gj, rcm, rcm_t, rc2, dx, dy, dz, d2);
        const int k = base + s.rowoff[i] + s.pre[i * s.W + w] +
                      __popc(m & (bit - 1u));
        add_products<ENERGY, VIRIAL>(dx, dy, dz, U[k], S[k], acc);
      }
    }
    const int tag = stag[j];
    const int t = tag / cap;
    const size_t out = static_cast<size_t>(t) * n_slots + home + (tag - t * cap);
#pragma unroll
    for (int k = 0; k < NCH; ++k) sums[k * kHalf * n_slots + out] = acc[k];
  }
}

int allow_smem(const void* kernel, long smem) {
  if (smem <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem)));
}

template <bool ENERGY, bool VIRIAL>
int launch_reduce(const float* pos, const int* types, const float* valid,
                  const float* centers, const HalfGeom& g, int n_cells,
                  const float* rcm, int rcm_t, float rc2, const int* cell_base,
                  const float* U, const float* S, float* sums, float* forces4,
                  float* virial, int* counter, int* needed,
                  cudaStream_t stream) {
  const long smem = smem_bytes(g.cap);
  auto kernel = generic_reduce<ENERGY, VIRIAL>;
  int e = allow_smem(reinterpret_cast<const void*>(kernel), smem);
  if (e != 0) return e;
  kernel<<<n_cells, kThreads, smem, stream>>>(pos, types, valid, centers, g,
                                              rcm, rcm_t, rc2, cell_base, U, S,
                                              sums, counter, needed);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_slots = n_cells * g.cap;
  half_stencil_home<ENERGY, VIRIAL>
      <<<(n_slots + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
          sums, valid, g, n_slots, reinterpret_cast<float4*>(forces4),
          virial);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Shared-memory bytes one block of either kernel needs (the wrapper checks
// the limit).
long htf_generic_smem(int cap) { return smem_bytes(cap); }

// The lane list: `pos` [n_slots][3], `types` [n_slots] int32 (or null when
// untyped), `valid` [n_slots], `centers` [n_slots][3], `geom` a host
// HalfGeom, `rcm` the [rcm_t][rcm_t] squared cutoffs (or null), `counter`
// a zeroed device int, `cell_base` [n_cells] int32, `r2`, `ti`, `tj`
// [budget] float32. Returns cudaGetLastError() after the launch (0 = ok).
int htf_generic_list(const float* pos, const int* types, const float* valid,
                     const float* centers, const HalfGeom* geom, int n_cells,
                     const float* rcm, int rcm_t, float rc2, float min_r2,
                     int budget, int* counter, int* cell_base, float* r2,
                     float* ti, float* tj, void* stream) {
  const HalfGeom g = *geom;
  const long smem = smem_bytes(g.cap);
  int e = allow_smem(reinterpret_cast<const void*>(generic_list), smem);
  if (e != 0) return e;
  generic_list<<<n_cells, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      pos, types, valid, centers, g, rcm, rcm_t, rc2, min_r2, budget, counter,
      cell_base, r2, ti, tj);
  return static_cast<int>(cudaGetLastError());
}

// The reduction and the finish: `U`, `S` [budget] float32 the pair
// function's values on the list, `sums` the [n_ch][14][n_slots] scratch,
// `forces4` [n_slots][4], `virial` [n_slots][9] (or null), `needed` a
// device int that receives the lanes the list needed. Launches
// generic_reduce and half_stencil_home on `stream`.
int htf_generic_reduce(const float* pos, const int* types, const float* valid,
                       const float* centers, const HalfGeom* geom,
                       int n_cells, const float* rcm, int rcm_t, float rc2,
                       const int* cell_base, const float* U, const float* S,
                       int needs_energy, int needs_virial, float* sums,
                       float* forces4, float* virial, int* counter,
                       int* needed, void* stream) {
  const HalfGeom g = *geom;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (needs_energy && needs_virial)
    return launch_reduce<true, true>(pos, types, valid, centers, g, n_cells,
                                     rcm, rcm_t, rc2, cell_base, U, S, sums,
                                     forces4, virial, counter, needed, s);
  if (needs_energy)
    return launch_reduce<true, false>(pos, types, valid, centers, g, n_cells,
                                      rcm, rcm_t, rc2, cell_base, U, S, sums,
                                      forces4, virial, counter, needed, s);
  if (needs_virial)
    return launch_reduce<false, true>(pos, types, valid, centers, g, n_cells,
                                      rcm, rcm_t, rc2, cell_base, U, S, sums,
                                      forces4, virial, counter, needed, s);
  return launch_reduce<false, false>(pos, types, valid, centers, g, n_cells,
                                     rcm, rcm_t, rc2, cell_base, U, S, sums,
                                     forces4, virial, counter, needed, s);
}

const char* htf_generic_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
