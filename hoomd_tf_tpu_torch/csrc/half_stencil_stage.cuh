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
// box is tilted (its tilt row is then read), per half-stencil block t its
// integer cell offset (ox, oy, oz), and nzl, the home layers of each shard
// a launch covers (nz for a whole state). The box itself is a device
// pointer.
//
// Group mode (GroupTab below): one launch over the z-slab shards of one
// card, each of nzl home layers; the staging reads a shard's rows through
// ShardRows, its forward halo layer (the layer z0 + nzl, mod nz: the half
// stencil reaches z + 1 only) in place from the next shard of the group
// where there is one, else from the shard's own halo rows. A block's
// staging computes centers and offsets from global cells, so its masks are
// those of the whole state.
struct HalfGeom {
  int nx, ny, nz, cap, tilted;
  int off[kHalf][3];
  int nzl;
};

// Slot rows of one shard's output: its home layers, and below a whole
// state its halo layer (the reverse partial).
__host__ __device__ __forceinline__ int out_slots(const HalfGeom& g) {
  return (g.nzl + (g.nzl < g.nz ? 1 : 0)) * g.nx * g.ny * g.cap;
}

// Where the staging reads a cell's slot rows. OneBuffer: a whole state.
// `cell` gives a cell's code (here the cell itself), `slot` a slot row of
// the code's buffer, and pos / types / valid that buffer's arrays; `aux`
// an array a kernel reads beside them at the same slot rows (K2's
// cotangent; null where unused).
template <class T>
struct OneBuffer {
  const T* pos;
  const int* types;
  const T* valid;
  const void* aux;
  __device__ __forceinline__ int cell(const HalfGeom&, int c) const {
    return c;
  }
  __device__ __forceinline__ size_t slot(int code, int cap, int r) const {
    return static_cast<size_t>(code) * cap + r;
  }
  __device__ __forceinline__ const T* p(int) const { return pos; }
  __device__ __forceinline__ const int* ty(int) const { return types; }
  __device__ __forceinline__ const T* v(int) const { return valid; }
  __device__ __forceinline__ const void* a(int) const { return aux; }
};

// A group: the z-slab shards one card holds, in ring order (at most
// kMaxGroup), passed by value as a __grid_constant__ kernel parameter.
// Per shard its buffer's arrays (home layers, then the forward halo
// layer, which a shard whose next shard is in the group may leave out:
// nothing reads it), an auxiliary array read at the same slot rows
// (OneBuffer's aux; null where unused), its first home layer z0 and, as
// indices into the group, the shard before it and after it on the ring
// when that shard is in the group, else -1. Every shard has HalfGeom's nzl
// home layers; its raw sums and outputs lie at its index times its slots
// in the group's arrays. A whole state is the group of one with z0 = 0,
// nzl = nz and no neighbours.
constexpr int kMaxGroup = 16;

template <class T>
struct GroupTab {
  const T* pos[kMaxGroup];
  const int* types[kMaxGroup];
  const T* valid[kMaxGroup];
  const void* aux[kMaxGroup];
  int z0[kMaxGroup], prev[kMaxGroup], next[kMaxGroup];
  int n;
};

// The GroupTab of a group's host arrays (the C entry points' arguments):
// n shards' buffers (pos, types and aux may be null), first home layers
// and ring neighbours in the group.
template <class T>
inline GroupTab<T> group_tab(int n, const void* const* pos,
                             const void* const* types,
                             const void* const* valid, const int* z0,
                             const int* prev, const int* next,
                             const void* const* aux = nullptr) {
  GroupTab<T> tab{};
  tab.n = n;
  for (int k = 0; k < n; ++k) {
    tab.pos[k] = pos ? static_cast<const T*>(pos[k]) : nullptr;
    tab.types[k] = types ? static_cast<const int*>(types[k]) : nullptr;
    tab.valid[k] = static_cast<const T*>(valid[k]);
    tab.aux[k] = aux ? aux[k] : nullptr;
    tab.z0[k] = z0[k];
    tab.prev[k] = prev[k];
    tab.next[k] = next[k];
  }
  return tab;
}

// The rows of one shard k of a group (GroupTab): its own buffer, and when
// the next shard on the ring is in the group, that shard's buffer, whose
// first home layer a cell of k's forward halo layer is read from in place
// (the code's kNextRows bit); else k's halo rows, which the caller filled.
constexpr int kNextRows = 1 << 30;

template <class T>
struct ShardRows {
  const T *pos, *pos_n;
  const int *types, *types_n;
  const T *valid, *valid_n;
  const void *aux, *aux_n;
  int z0;
  bool has_next;

  __device__ __forceinline__ ShardRows(const GroupTab<T>& tab, int k) {
    const int n = tab.next[k];
    has_next = n >= 0;
    const int m = has_next ? n : k;
    pos = tab.pos[k];
    types = tab.types[k];
    valid = tab.valid[k];
    aux = tab.aux[k];
    pos_n = tab.pos[m];
    types_n = tab.types[m];
    valid_n = tab.valid[m];
    aux_n = tab.aux[m];
    z0 = tab.z0[k];
  }
  __device__ __forceinline__ int cell(const HalfGeom& g, int c) const {
    const int layer = g.nx * g.ny;
    const int z = c / layer;
    int lz = z - z0;
    if (lz < 0) lz += g.nz;
    if (has_next && lz == g.nzl) return kNextRows | (c - z * layer);
    return c + (lz - z) * layer;
  }
  __device__ __forceinline__ size_t slot(int code, int cap, int r) const {
    return static_cast<size_t>(code & ~kNextRows) * cap + r;
  }
  __device__ __forceinline__ const T* p(int code) const {
    return (code & kNextRows) ? pos_n : pos;
  }
  __device__ __forceinline__ const int* ty(int code) const {
    return (code & kNextRows) ? types_n : types;
  }
  __device__ __forceinline__ const T* v(int code) const {
    return (code & kNextRows) ? valid_n : valid;
  }
  __device__ __forceinline__ const void* a(int code) const {
    return (code & kNextRows) ? aux_n : aux;
  }
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
  __device__ __forceinline__ void operator()(int, int, size_t) const {}
};

struct NoSkip {
  __device__ __forceinline__ void operator()(int, int) const {}
};

// Distance term of one axis from the bounding box [lo, hi] (0 inside).
template <class T>
__device__ __forceinline__ T box_gap(T v, T lo, T hi) {
  return fmax_(fmax_(sub_rn(lo, v), sub_rn(v, hi)), T(0));
}

// Stage the valid slots of (global) cell c's half-stencil cells, read
// where `src` (OneBuffer, ShardRows) keeps them, into `spos` and `stag`
// (each sized for 14 * cap entries), the directed blocks' only within rc2
// of the home rows' bounding box; `scratch` is stage_bytes<T>() bytes.
// `extra(k, code, slot)` stages what else a kernel needs of entry k (slot
// row `slot` of the buffer of cell code `code`: src.a(code), src.v(code));
// `skipped(t, r)` is called for each valid slot of the
// directed blocks left out. Returns the number staged and sets `n_home`.
// Every thread of the block must call it; it ends with a barrier.
template <class T, class Src, class Extra, class Skipped>
__device__ int stage_rows(const HalfGeom& g, int c, T rc2, const Src& src,
                          const T* __restrict__ box, Vec4<T>* spos,
                          int* stag, unsigned char* scratch, int& n_home,
                          Extra extra, Skipped skipped) {
  int* nb = reinterpret_cast<int*>(scratch);       // [14] the blocks' cells
  int* wall = nb + kHalf;                          // [kWarps] staged per warp
  T* wbox = reinterpret_cast<T*>(wall + kWarps);   // [kWarps][6]
  T* len = wbox + 6 * kWarps;                      // [6] L, tilt
  T* geo = len + 6;                                // [14][6] center, offset
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  if (tid < kHalf) {
    // geometry from the global cell; the rows from its buffer cell
    const int cell = shifted_cell(g, c, tid, 1);
    block_geometry(g, box, cell, tid, geo + 6 * tid, len);
    nb[tid] = src.cell(g, cell);
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
    int code = 0;
    bool ok = false;
    Vec4<T> q = vec4(T(0), T(0), T(0), T(0));
    if (s < s_end) {
      code = nb[t];
      slot = src.slot(code, g.cap, r);
      ok = src.v(code)[slot] != T(0);
    }
    if (ok) {
      const int* types = src.ty(code);
      const Vec3<T> r3 = relative(src.p(code) + 3 * slot, geo + 6 * t,
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
      extra(k, code, slot);
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

// stage_rows of a whole state.
template <class T, class Extra, class Skipped>
__device__ int stage_half_stencil(const HalfGeom& g, int c, T rc2,
                                  const T* __restrict__ pos,
                                  const int* __restrict__ types,
                                  const T* __restrict__ valid,
                                  const T* __restrict__ box, Vec4<T>* spos,
                                  int* stag, unsigned char* scratch,
                                  int& n_home, Extra extra,
                                  Skipped skipped) {
  return stage_rows<T>(g, c, rc2, OneBuffer<T>{pos, types, valid, nullptr},
                       box, spos, stag, scratch, n_home, extra, skipped);
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
