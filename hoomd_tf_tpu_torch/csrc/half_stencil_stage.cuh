// Staging of the half stencil, shared by kernel K1 (cellwise_half.cu) and
// kernel K2 (proxy_bwd.cu), for Hopper (sm_90a).
//
// One block per home cell c. The block reads the slot rows of the 14 cells
// of the half stencil straight from the slot-ordered state: block t of cell
// c is the cell c + off_t (periodic), with off_0 = (0, 0, 0) and off_1..13
// the directed offsets of ops/cellwise.py::_HALF_OFFS, in that order. It
// keeps only the slots whose `valid` is set (any pattern, not only an
// occupied prefix) and compacts them in shared memory in (block, rank)
// order: a ballot and a population count per warp, the warps' counts summed
// in order, chunk by chunk. The home cell's own slots come first, so
// entries [0, n_home) are the block's rows and also block 0 of its
// candidates. A slot of blocks 1..13 is then staged only if it lies within
// the cut of the rows' bounding box: with d_a = max(lo_a - g_a, g_a - hi_a,
// 0) per axis, d_x*d_x + d_y*d_y + d_z*d_z <= rc2. Rounding is monotonic,
// so for every row q, |g_a - q_a| >= d_a in float32 as in exact
// arithmetic, and a slot left out has d2 > rc2 against every row: it would
// add exactly nothing. At the 64k fluid's cells this leaves out about 60%
// of the directed blocks' occupied slots. The caller's `skipped(t, r)`
// hears of each one (K1 writes its zero back sums there).
//
// Each staged entry holds the cell-relative coordinates with the block's
// stencil offset added, rounded as ops/cellwise.py::_relative_coords rounds
// them (the same float32 operations in the same order, no contraction):
//   q = p - center[slot];  q = q - rint(q / L) * L;  q = q + off_t,
// the type bits in .w (0 when the call is untyped), and the tag t * cap + r
// (block t, rank r in its cell) that addresses the per-slot outputs. Empty
// slots are never staged, so they contribute exactly nothing: the ghost push
// of the tensor forms has no counterpart here.

#pragma once

#include <cuda_runtime.h>

namespace htf {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kHalf = 14;  // the self cell and the 13 directed offsets
// 4-byte words of shared memory the staging uses besides the staged arrays:
// the 14 neighbour cells, a per-warp count and a per-warp bounding box
constexpr int kStageInts = kHalf + 7 * kWarps;

// The plan's static geometry, passed by value: the grid, the capacity, the
// float32 box lengths, and per half-stencil block t its integer cell offset
// (ox, oy, oz) and the float32 Cartesian offset SlotGeometry.offsets holds
// for it. The wrapper fills it from the same Python constants.
struct HalfGeom {
  int nx, ny, nz, cap;
  float lx, ly, lz;
  int off[kHalf][3];
  float offf[kHalf][3];
};

// The cell c + sign * off_t on the periodic grid (x-minor, z-major ids).
__device__ __forceinline__ int shifted_cell(const HalfGeom& g, int c, int t,
                                            int sign) {
  const int x0 = c % g.nx, y0 = (c / g.nx) % g.ny, z0 = c / (g.nx * g.ny);
  const int x = (x0 + sign * g.off[t][0] + g.nx) % g.nx;
  const int y = (y0 + sign * g.off[t][1] + g.ny) % g.ny;
  const int z = (z0 + sign * g.off[t][2] + g.nz) % g.nz;
  return x + g.nx * (y + g.ny * z);
}

// One coordinate, rounded as _relative_coords rounds it.
__device__ __forceinline__ float relative(float p, float center, float L,
                                          float off) {
  const float q = __fsub_rn(p, center);
  return __fadd_rn(__fsub_rn(q, __fmul_rn(rintf(__fdiv_rn(q, L)), L)), off);
}

struct NoExtra {
  __device__ __forceinline__ void operator()(int, size_t) const {}
};

struct NoSkip {
  __device__ __forceinline__ void operator()(int, int) const {}
};

// Distance term of one axis from the bounding box [lo, hi] (0 inside).
__device__ __forceinline__ float box_gap(float v, float lo, float hi) {
  return fmaxf(fmaxf(__fsub_rn(lo, v), __fsub_rn(v, hi)), 0.f);
}

// Stage the valid slots of cell c's 14 half-stencil cells into `spos` and
// `stag` (each sized for 14 * cap entries), the directed blocks' only
// within rc2 of the home rows' bounding box; `sints` is kStageInts words of
// scratch. `extra(k, slot)` stages what else a kernel needs of entry k;
// `skipped(t, r)` is called for each valid slot of the directed blocks left
// out. Returns the number staged and sets `n_home`. Every thread of the
// block must call it; it ends with a barrier.
template <class Extra, class Skipped>
__device__ int stage_half_stencil(const HalfGeom& g, int c, float rc2,
                                  const float* __restrict__ pos,
                                  const int* __restrict__ types,
                                  const float* __restrict__ valid,
                                  const float* __restrict__ centers,
                                  float4* spos, int* stag, int* sints,
                                  int& n_home, Extra extra,
                                  Skipped skipped) {
  int* nb = sints;                                 // [14] the blocks' cells
  int* wall = nb + kHalf;                          // [kWarps] staged per warp
  float* wbox = reinterpret_cast<float*>(wall + kWarps);  // [kWarps][6]
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  if (tid < kHalf) nb[tid] = shifted_cell(g, c, tid, 1);
  __syncthreads();

  const int C = kHalf * g.cap;
  const float inf = __int_as_float(0x7f800000);
  float lo[3] = {0.f, 0.f, 0.f}, hi[3] = {0.f, 0.f, 0.f};  // the rows' box
  int base = 0;
  // stage the valid slots s in [s0, s0 + kThreads) of [.., s_end)
  auto chunk = [&](int s0, int s_end) {
    const int s = s0 + tid;
    const int t = s / g.cap;
    const int r = s - t * g.cap;
    size_t slot = 0;
    bool ok = false;
    float4 q = make_float4(0.f, 0.f, 0.f, 0.f);
    if (s < s_end) {
      slot = static_cast<size_t>(nb[t]) * g.cap + r;
      ok = valid[slot] != 0.f;
    }
    if (ok) {
      const float* p = pos + 3 * slot;
      const float* ce = centers + 3 * slot;
      q = make_float4(relative(p[0], ce[0], g.lx, g.offf[t][0]),
                      relative(p[1], ce[1], g.ly, g.offf[t][1]),
                      relative(p[2], ce[2], g.lz, g.offf[t][2]),
                      __int_as_float(types ? types[slot] : 0));
      if (t > 0) {
        const float dx = box_gap(q.x, lo[0], hi[0]);
        const float dy = box_gap(q.y, lo[1], hi[1]);
        const float dz = box_gap(q.z, lo[2], hi[2]);
        if (!(dx * dx + dy * dy + dz * dz <= rc2)) {
          ok = false;
          skipped(t, r);
        }
      }
    }
    const unsigned b = __ballot_sync(0xffffffffu, ok);
    if (lane == 0) wall[warp] = __popc(b);
    __syncthreads();
    int before = 0, total = 0;
    for (int w = 0; w < kWarps; ++w) {
      before += w < warp ? wall[w] : 0;
      total += wall[w];
    }
    if (ok) {
      const int k = base + before + __popc(b & ((1u << lane) - 1u));
      spos[k] = q;
      stag[k] = s;
      extra(k, slot);
    }
    base += total;
    __syncthreads();  // the per-warp counts are reused
  };

  for (int s0 = 0; s0 < g.cap; s0 += kThreads) chunk(s0, g.cap);
  n_home = base;
  // the rows' bounding box, in every thread (empty: lo = inf, hi = -inf)
  float v[6] = {inf, inf, inf, -inf, -inf, -inf};
  for (int k = tid; k < base; k += kThreads) {
    const float4 r = spos[k];
    v[0] = fminf(v[0], r.x);
    v[1] = fminf(v[1], r.y);
    v[2] = fminf(v[2], r.z);
    v[3] = fmaxf(v[3], r.x);
    v[4] = fmaxf(v[4], r.y);
    v[5] = fmaxf(v[5], r.z);
  }
#pragma unroll
  for (int m = 0; m < 6; ++m) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float o = __shfl_xor_sync(0xffffffffu, v[m], off);
      v[m] = m < 3 ? fminf(v[m], o) : fmaxf(v[m], o);
    }
    if (lane == 0) wbox[warp * 6 + m] = v[m];
  }
  __syncthreads();
#pragma unroll
  for (int m = 0; m < 3; ++m) {
    lo[m] = inf;
    hi[m] = -inf;
    for (int w = 0; w < kWarps; ++w) {
      lo[m] = fminf(lo[m], wbox[w * 6 + m]);
      hi[m] = fmaxf(hi[m], wbox[w * 6 + 3 + m]);
    }
  }
  for (int s0 = g.cap; s0 < C; s0 += kThreads) chunk(s0, C);
  return base;
}

// The row sweep's split of the block over (row, candidate segment) pairs:
// rows r0 .. r0 + rows - 1 of this pass, nseg segments each, thread tid on
// row r0 + tid / nseg and segment tid % nseg (idle when tid >= rows * nseg).
struct RowSplit {
  int rows, nseg, row, seg;
  bool active;
  __device__ __forceinline__ RowSplit(int r0, int n_rows) {
    rows = min(n_rows - r0, kThreads);
    nseg = kThreads / rows;
    row = r0 + static_cast<int>(threadIdx.x) / nseg;
    seg = static_cast<int>(threadIdx.x) % nseg;
    active = static_cast<int>(threadIdx.x) < rows * nseg;
  }
};

}  // namespace htf
