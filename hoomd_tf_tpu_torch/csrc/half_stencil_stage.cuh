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
// rounding is monotonic, so for every row q, |g_a - q_a| >= d_a in T as in
// exact arithmetic, in float and in double (built with -fmad=false,
// no product is fused), and
// a slot left out has d2 > rc2 against every row: it would add exactly
// nothing. At the 64k fluid's cells this leaves out about 60% of the
// directed blocks' occupied slots. The caller's `skipped(t, r)` hears of
// each one (K1 writes its zero back sums there).
//
// The geometry comes from the box on the card, [3][3] as ops/box.py::
// make_box lays it out (rows low, high, tilt factors xy, xz, yz), read at
// every launch: a barostat that rescales the box between two launches needs
// no new plan and no host copy. HalfGeom carries integers only. From the
// box each block derives, in the scalar type T (float or double: the
// state's dtype; scalar.cuh) and in the order of
// ops/cellwise.py::_box_terms, _cell_centers and _stencil_offsets:
//   L = high - low;  e = L / grid;  f_a = (cell_a + 0.5) * e_a;
//   center = low + f                      (orthorhombic), or
//   center = (low_x + f_x + xy f_y + xz f_z, low_y + f_y + yz f_z,
//             low_z + f_z)                (tilted, left to right);
//   o_a = off_a * e_a;  offset = o, or (o_x + xy o_y + xz o_z,
//             o_y + yz o_z, o_z)          (tilted).
// Each staged entry holds the cell-relative coordinates with the block's
// stencil offset added, rounded as ops/cellwise.py::_relative_coords rounds
// them (the same IEEE operations of type T in the same order, no
// contraction; in double the _rn intrinsics are __dadd_rn, __dmul_rn,
// __ddiv_rn in the places of __fadd_rn, __fmul_rn, __fdiv_rn):
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

#include "scalar.cuh"

namespace htf {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kHalf = 14;  // the self cell and the 13 directed offsets
// Bytes of shared memory the staging uses besides the staged arrays: the
// 14 neighbour cells and a per-warp count (ints), then in T a per-warp
// bounding box, the box lengths and tilt, and per block its cell's center
// and its offset. A multiple of 8, so T arrays may follow it.
template <class T>
__host__ __device__ constexpr int stage_bytes() {
  return 4 * (kHalf + kWarps) +
         static_cast<int>(sizeof(T)) * (6 * kWarps + 6 + 6 * kHalf);
}

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
template <class T>
__device__ __forceinline__ void block_geometry(const HalfGeom& g,
                                               const T* __restrict__ box,
                                               int cell, int t, T* geo,
                                               T* len) {
  const int dims[3] = {g.nx, g.ny, g.nz};
  const int ci[3] = {cell % g.nx, (cell / g.nx) % g.ny, cell / (g.nx * g.ny)};
  T lo[3], e[3], f[3], o[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    lo[a] = box[a];
    const T L = sub_rn(box[3 + a], box[a]);
    e[a] = div_rn(L, static_cast<T>(dims[a]));
    f[a] = mul_rn(add_rn(static_cast<T>(ci[a]), T(0.5)), e[a]);
    o[a] = mul_rn(static_cast<T>(g.off[t][a]), e[a]);
    if (t == 0) len[a] = L;
  }
  const T xy = box[6], xz = box[7], yz = box[8];
  if (t == 0) {
    len[3] = xy;
    len[4] = xz;
    len[5] = yz;
  }
  if (g.tilted) {
    geo[0] = add_rn(add_rn(add_rn(lo[0], f[0]), mul_rn(xy, f[1])),
                    mul_rn(xz, f[2]));
    geo[1] = add_rn(add_rn(lo[1], f[1]), mul_rn(yz, f[2]));
    geo[3] = add_rn(add_rn(o[0], mul_rn(xy, o[1])), mul_rn(xz, o[2]));
    geo[4] = add_rn(o[1], mul_rn(yz, o[2]));
  } else {
    geo[0] = add_rn(lo[0], f[0]);
    geo[1] = add_rn(lo[1], f[1]);
    geo[3] = o[0];
    geo[4] = o[1];
  }
  geo[2] = add_rn(lo[2], f[2]);
  geo[5] = o[2];
}

// A slot's coordinates relative to its cell's center `ce`, wrapped, plus
// the block's offset `of`, rounded as _relative_coords rounds them. `len`
// holds L and the tilt (xy, xz, yz).
template <class T>
__device__ __forceinline__ Vec3<T> relative(const T* p, const T* ce,
                                            const T* of, const T* len,
                                            bool tilted) {
  T q[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) q[a] = sub_rn(p[a], ce[a]);
  if (tilted) {
    const T iz = rint_(div_rn(q[2], len[2]));
    q[0] = sub_rn(q[0], mul_rn(mul_rn(iz, len[4]), len[2]));
    q[1] = sub_rn(q[1], mul_rn(mul_rn(iz, len[5]), len[2]));
    q[2] = sub_rn(q[2], mul_rn(iz, len[2]));
    const T iy = rint_(div_rn(q[1], len[1]));
    q[0] = sub_rn(q[0], mul_rn(mul_rn(iy, len[3]), len[1]));
    q[1] = sub_rn(q[1], mul_rn(iy, len[1]));
    q[0] = sub_rn(q[0], mul_rn(rint_(div_rn(q[0], len[0])), len[0]));
  } else {
#pragma unroll
    for (int a = 0; a < 3; ++a)
      q[a] = sub_rn(q[a], mul_rn(rint_(div_rn(q[a], len[a])), len[a]));
  }
  Vec3<T> r;
  r.x = add_rn(q[0], of[0]);
  r.y = add_rn(q[1], of[1]);
  r.z = add_rn(q[2], of[2]);
  return r;
}

struct NoExtra {
  __device__ __forceinline__ void operator()(int, size_t) const {}
};

struct NoSkip {
  __device__ __forceinline__ void operator()(int, int) const {}
};

// Distance term of one axis from the bounding box [lo, hi] (0 inside).
template <class T>
__device__ __forceinline__ T box_gap(T v, T lo, T hi) {
  return fmax_(fmax_(sub_rn(lo, v), sub_rn(v, hi)), T(0));
}

// Stage the valid slots of cell c's 14 half-stencil cells into `spos` and
// `stag` (each sized for 14 * cap entries), the directed blocks' only
// within rc2 of the home rows' bounding box; `scratch` is stage_bytes<T>()
// bytes. `extra(k, slot)` stages what else a kernel needs of entry k;
// `skipped(t, r)` is called for each valid slot of the directed blocks left
// out. Returns the number staged and sets `n_home`. Every thread of the
// block must call it; it ends with a barrier.
template <class T, class Extra, class Skipped>
__device__ int stage_half_stencil(const HalfGeom& g, int c, T rc2,
                                  const T* __restrict__ pos,
                                  const int* __restrict__ types,
                                  const T* __restrict__ valid,
                                  const T* __restrict__ box, Vec4<T>* spos,
                                  int* stag, unsigned char* scratch,
                                  int& n_home, Extra extra,
                                  Skipped skipped) {
  int* nb = reinterpret_cast<int*>(scratch);       // [14] the blocks' cells
  int* wall = nb + kHalf;                          // [kWarps] staged per warp
  T* wbox = reinterpret_cast<T*>(wall + kWarps);   // [kWarps][6]
  T* len = wbox + 6 * kWarps;                      // [6] L, tilt
  T* geo = len + 6;                                // [14][6] center, offset
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  if (tid < kHalf) {
    nb[tid] = shifted_cell(g, c, tid, 1);
    block_geometry(g, box, nb[tid], tid, geo + 6 * tid, len);
  }
  __syncthreads();

  const int C = kHalf * g.cap;
  const T inf = inf_<T>();
  T lo[3] = {T(0), T(0), T(0)}, hi[3] = {T(0), T(0), T(0)};  // the rows' box
  int base = 0;
  // stage the valid slots s in [s0, s0 + kThreads) of [.., s_end)
  auto chunk = [&](int s0, int s_end) {
    const int s = s0 + tid;
    const int t = s / g.cap;
    const int r = s - t * g.cap;
    size_t slot = 0;
    bool ok = false;
    Vec4<T> q = vec4(T(0), T(0), T(0), T(0));
    if (s < s_end) {
      slot = static_cast<size_t>(nb[t]) * g.cap + r;
      ok = valid[slot] != T(0);
    }
    if (ok) {
      const Vec3<T> r3 = relative(pos + 3 * slot, geo + 6 * t,
                                  geo + 6 * t + 3, len, g.tilted != 0);
      q = vec4(r3.x, r3.y, r3.z, pack_type<T>(types ? types[slot] : 0));
      if (t > 0) {
        const T dx = box_gap(q.x, lo[0], hi[0]);
        const T dy = box_gap(q.y, lo[1], hi[1]);
        const T dz = box_gap(q.z, lo[2], hi[2]);
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
  T v[6] = {inf, inf, inf, -inf, -inf, -inf};
  for (int k = tid; k < base; k += kThreads) {
    const Vec4<T> r = spos[k];
    v[0] = fmin_(v[0], r.x);
    v[1] = fmin_(v[1], r.y);
    v[2] = fmin_(v[2], r.z);
    v[3] = fmax_(v[3], r.x);
    v[4] = fmax_(v[4], r.y);
    v[5] = fmax_(v[5], r.z);
  }
#pragma unroll
  for (int m = 0; m < 6; ++m) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const T o = __shfl_xor_sync(0xffffffffu, v[m], off);
      v[m] = m < 3 ? fmin_(v[m], o) : fmax_(v[m], o);
    }
    if (lane == 0) wbox[warp * 6 + m] = v[m];
  }
  __syncthreads();
#pragma unroll
  for (int m = 0; m < 3; ++m) {
    lo[m] = inf;
    hi[m] = -inf;
    for (int w = 0; w < kWarps; ++w) {
      lo[m] = fmin_(lo[m], wbox[w * 6 + m]);
      hi[m] = fmax_(hi[m], wbox[w * 6 + 3 + m]);
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
