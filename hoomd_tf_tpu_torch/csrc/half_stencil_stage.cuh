// Staging of the half stencil, shared by kernel K1 (cellwise_half.cu,
// cellwise_generic.cu) and kernel K2 (proxy_bwd.cu), for Hopper (sm_90a).
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
// 0) per axis, d_x*d_x + d_y*d_y + d_z*d_z <= rc2. The bounding box is
// taken over the same staged Cartesian coordinates the pair sweeps subtract
// (in a tilted box too: the offsets and the wrap below are Cartesian), and
// rounding is monotonic, so for every row q, |g_a - q_a| >= d_a in float32
// as in exact arithmetic (built with -fmad=false, no product is fused), and
// a slot left out has d2 > rc2 against every row: it would add exactly
// nothing. At the 64k fluid's cells this leaves out about 60% of the
// directed blocks' occupied slots. The caller's `skipped(t, r)` hears of
// each one (K1 writes its zero back sums there).
//
// The geometry comes from the box on the card, [3][3] as ops/box.py::
// make_box lays it out (rows low, high, tilt factors xy, xz, yz), read at
// every launch: a barostat that rescales the box between two launches needs
// no new plan and no host copy. HalfGeom carries integers only. From the
// box each block derives, in float32 and in the order of
// ops/cellwise.py::_box_terms, _cell_centers and _stencil_offsets:
//   L = high - low;  e = L / grid;  f_a = (cell_a + 0.5) * e_a;
//   center = low + f                      (orthorhombic), or
//   center = (low_x + f_x + xy f_y + xz f_z, low_y + f_y + yz f_z,
//             low_z + f_z)                (tilted, left to right);
//   o_a = off_a * e_a;  offset = o, or (o_x + xy o_y + xz o_z,
//             o_y + yz o_z, o_z)          (tilted).
// Each staged entry holds the cell-relative coordinates with the block's
// stencil offset added, rounded as ops/cellwise.py::_relative_coords rounds
// them (the same float32 operations in the same order, no contraction):
//   q = p - center[slot];  q = wrap(q);  q = q + offset_t,
// wrap being q - rint(q / L) * L per axis, or in a tilted box the
// sequential z, y, x wrap of ops/cellwise.py::_wrap_tri (z removes its
// lattice vector from all three components, then y from x and y, then x);
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
// the 14 neighbour cells, a per-warp count and a per-warp bounding box, the
// box lengths and tilt, and per block its cell's center and its offset
constexpr int kStageInts = kHalf + 7 * kWarps + 6 + 6 * kHalf;

// The plan's integers, passed by value: the grid, the capacity, whether the
// box is tilted (its tilt row is then read), and per half-stencil block t
// its integer cell offset (ox, oy, oz). The box itself is a device pointer.
struct HalfGeom {
  int nx, ny, nz, cap, tilted;
  int off[kHalf][3];
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

// Block t's cell center and Cartesian stencil offset from the box on the
// card, written to geo[0..5]; L and the tilt to len[0..5] when t == 0.
__device__ __forceinline__ void block_geometry(const HalfGeom& g,
                                               const float* __restrict__ box,
                                               int cell, int t, float* geo,
                                               float* len) {
  const int dims[3] = {g.nx, g.ny, g.nz};
  const int ci[3] = {cell % g.nx, (cell / g.nx) % g.ny, cell / (g.nx * g.ny)};
  float lo[3], e[3], f[3], o[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    lo[a] = box[a];
    const float L = __fsub_rn(box[3 + a], box[a]);
    e[a] = __fdiv_rn(L, static_cast<float>(dims[a]));
    f[a] = __fmul_rn(__fadd_rn(static_cast<float>(ci[a]), 0.5f), e[a]);
    o[a] = __fmul_rn(static_cast<float>(g.off[t][a]), e[a]);
    if (t == 0) len[a] = L;
  }
  const float xy = box[6], xz = box[7], yz = box[8];
  if (t == 0) {
    len[3] = xy;
    len[4] = xz;
    len[5] = yz;
  }
  if (g.tilted) {
    geo[0] = __fadd_rn(__fadd_rn(__fadd_rn(lo[0], f[0]), __fmul_rn(xy, f[1])),
                       __fmul_rn(xz, f[2]));
    geo[1] = __fadd_rn(__fadd_rn(lo[1], f[1]), __fmul_rn(yz, f[2]));
    geo[3] = __fadd_rn(__fadd_rn(o[0], __fmul_rn(xy, o[1])),
                       __fmul_rn(xz, o[2]));
    geo[4] = __fadd_rn(o[1], __fmul_rn(yz, o[2]));
  } else {
    geo[0] = __fadd_rn(lo[0], f[0]);
    geo[1] = __fadd_rn(lo[1], f[1]);
    geo[3] = o[0];
    geo[4] = o[1];
  }
  geo[2] = __fadd_rn(lo[2], f[2]);
  geo[5] = o[2];
}

// A slot's coordinates relative to its cell's center `ce`, wrapped, plus
// the block's offset `of`, rounded as _relative_coords rounds them. `len`
// holds L and the tilt (xy, xz, yz).
__device__ __forceinline__ float3 relative(const float* p, const float* ce,
                                           const float* of, const float* len,
                                           bool tilted) {
  float q[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) q[a] = __fsub_rn(p[a], ce[a]);
  if (tilted) {
    const float iz = rintf(__fdiv_rn(q[2], len[2]));
    q[0] = __fsub_rn(q[0], __fmul_rn(__fmul_rn(iz, len[4]), len[2]));
    q[1] = __fsub_rn(q[1], __fmul_rn(__fmul_rn(iz, len[5]), len[2]));
    q[2] = __fsub_rn(q[2], __fmul_rn(iz, len[2]));
    const float iy = rintf(__fdiv_rn(q[1], len[1]));
    q[0] = __fsub_rn(q[0], __fmul_rn(__fmul_rn(iy, len[3]), len[1]));
    q[1] = __fsub_rn(q[1], __fmul_rn(iy, len[1]));
    q[0] = __fsub_rn(q[0], __fmul_rn(rintf(__fdiv_rn(q[0], len[0])), len[0]));
  } else {
#pragma unroll
    for (int a = 0; a < 3; ++a)
      q[a] = __fsub_rn(q[a], __fmul_rn(rintf(__fdiv_rn(q[a], len[a])), len[a]));
  }
  return make_float3(__fadd_rn(q[0], of[0]), __fadd_rn(q[1], of[1]),
                     __fadd_rn(q[2], of[2]));
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
                                  const float* __restrict__ box,
                                  float4* spos, int* stag, int* sints,
                                  int& n_home, Extra extra,
                                  Skipped skipped) {
  int* nb = sints;                                 // [14] the blocks' cells
  int* wall = nb + kHalf;                          // [kWarps] staged per warp
  float* wbox = reinterpret_cast<float*>(wall + kWarps);  // [kWarps][6]
  float* len = wbox + 6 * kWarps;                  // [6] L, tilt
  float* geo = len + 6;                            // [14][6] center, offset
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  if (tid < kHalf) {
    nb[tid] = shifted_cell(g, c, tid, 1);
    block_geometry(g, box, nb[tid], tid, geo + 6 * tid, len);
  }
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
      const float3 r3 = relative(pos + 3 * slot, geo + 6 * t,
                                 geo + 6 * t + 3, len, g.tilted != 0);
      q = make_float4(r3.x, r3.y, r3.z,
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
