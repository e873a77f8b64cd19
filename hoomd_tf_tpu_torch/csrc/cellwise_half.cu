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
//               the table contribute nothing. A table too large for the
//               block's shared memory (many types: past ~36 types in double
//               at K = 16) is read from device memory instead, laid out
//               there by a small kernel beside the coefficients with the
//               same edge sums.
//
// Group mode (half_stencil_group_forces, half_stencil_group_home; the port
// of hoomd_tf_tpu/ops/cellwise_pallas.py:640-652, which runs the
// pallas_call under shard_map on each device's block of z-slab cells, the
// halo in the XLA rolls around it): the shards one card holds, in ring
// order, in one launch (GroupTab, a
// __grid_constant__ parameter: per shard its buffer, z0 and its ring
// neighbours in the group). Block b is home cell b - k H of shard k =
// b / H, so a group of every shard has the unsharded grid and raw-sum
// layout; a cell of the forward halo layer is read in place from the next
// shard's first home layer when that shard is in the group (ShardRows),
// and the home pass takes a first-layer slot's back sums from the previous
// shard's raw sums in the order t = 1..13: no halo copy, no reverse halo,
// and a group of every shard gives the unsharded forces bit for bit.
// Between groups (cards) the halo is still copied and added by the caller.
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
//
// Every kernel is a template on the scalar type T (scalar.cuh), built for
// float and for double: a float64 state runs the double instantiation,
// positions, staged entries, tables, products and sums all in double (the
// reference's own precision). In double the staging's shared memory and
// the partial sums double, and the operations run at the card's float64
// rate (34 TFLOP/s on an H100 SXM, against 67 in float32): still bound by
// operations, ~0.01 ms at the 64k eval shapes.

#include <cuda_runtime.h>

#include "half_stencil_home.cuh"
#include "half_stencil_stage.cuh"
#include "scalar.cuh"

namespace {

using htf::HalfGeom;
using htf::kHalf;
using htf::kThreads;
using htf::Channels;
using htf::half_stencil_home;
using htf::Vec4;
using htf::fmax_;
using htf::fmin_;

// LJ family: read straight from the [T][T] table of (eps, sigma^2, shift,
// rc2_form) in global memory.
template <class T>
struct LJForm {
  const Vec4<T>* tab;
  int t;
  int strict;

  __device__ __forceinline__ void stage(T*, int) {}

  __device__ __forceinline__ bool operator()(T r2, int ti, int tj, T& U,
                                             T& s) const {
    const Vec4<T> f = tab[t == 1 ? 0 : ti * t + tj];
    const bool inside = strict ? (r2 < f.w) : (r2 <= f.w);
    if (!inside) return false;
    const T inv = T(1) / r2;
    const T x = f.y * inv;
    const T sr6 = x * x * x;
    s = T(-12) * f.x * (T(2) * sr6 - T(1)) * sr6 * inv;
    U = T(4) * f.x * (sr6 * sr6 - sr6) + f.z;
    return true;
  }
};

// Sequential sum c[0] + c[1] + ... (the order of the plain version).
template <class T>
__device__ __forceinline__ T seq_sum(const T* c, int K) {
  T v = c[0];
  for (int k = 1; k < K; ++k) v = v + c[k];
  return v;
}

template <class T>
__device__ __forceinline__ T clenshaw(const T* c, int K, T w) {
  T b1 = T(0), b2 = T(0);
  const T two_w = T(2) * w;
  for (int k = K - 1; k > 0; --k) {
    const T b = c[k] + two_w * b1 - b2;
    b2 = b1;
    b1 = b;
  }
  return c[0] + w * b1 - b2;
}

// Chebyshev proxy: the [P][2][K] coefficient table and the per-pair edge
// values (U_hi, s_hi) live in shared memory, staged once per block, or,
// when `dtab` is set, in that device array of the same layout
// (cheb_device_table).
template <class T>
struct ChebForm {
  const T* coef;  // global [P][2][K]
  int NT;         // types of the table (1 = untyped)
  int K;
  T mid, inv_half, u_hi;
  const T* dtab;  // null, or device [P][2][K] then [P][2] edge values
  const T* sm;    // the table read: shared, or dtab

  __device__ __forceinline__ int pairs() const { return NT * (NT + 1) / 2; }

  __device__ __forceinline__ void stage(T* smem, int tid) {
    if (dtab != nullptr) {
      sm = dtab;
      return;
    }
    const int P = pairs();
    for (int i = tid; i < P * 2 * K; i += kThreads) smem[i] = coef[i];
    for (int i = tid; i < P * 2; i += kThreads)
      smem[P * 2 * K + i] = seq_sum(coef + i * K, K);
    sm = smem;
  }

  __device__ __forceinline__ bool operator()(T r2, int ti, int tj, T& U,
                                             T& s) const {
    int p = 0;
    if (NT > 1) {
      if (ti < 0 || ti >= NT || tj < 0 || tj >= NT) return false;
      const int a = min(ti, tj), b = max(ti, tj);
      p = a * NT - a * (a - 1) / 2 + (b - a);
    }
    const T* c = sm + p * 2 * K;
    const T* hi = sm + pairs() * 2 * K + p * 2;
    const T u = T(1) / r2;
    const T over = fmax_(u - u_hi, T(0));
    T su;
    if (over <= T(0)) {
      const T w = fmin_(fmax_((u - mid) * inv_half, T(-1)), T(1));
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

// The channel products of the lane (row q, candidate g); false (and `p`
// untouched) outside the cut.
template <bool ENERGY, bool VIRIAL, class T, class Form>
__device__ __forceinline__ bool lane_products(
    Vec4<T> q, Vec4<T> g, const Form& form, const T* __restrict__ rcm,
    int rcm_t, T rc2, T min_r2, T (&p)[Channels<ENERGY, VIRIAL>::kCount]) {
  constexpr int OF = Channels<ENERGY, VIRIAL>::kForce;
  const T dx = g.x - q.x;
  const T dy = g.y - q.y;
  const T dz = g.z - q.z;
  const T d2 = dx * dx + dy * dy + dz * dz;
  if (!(d2 <= rc2)) return false;
  const int ti = htf::unpack_type(q.w), tj = htf::unpack_type(g.w);
  if (rcm != nullptr) {
    const bool known = ti >= 0 && ti < rcm_t && tj >= 0 && tj < rcm_t;
    const T prc2 = known ? rcm[ti * rcm_t + tj] : T(0);
    if (!(d2 <= prc2)) return false;
  }
  T U, s;
  if (!form(fmax_(d2, min_r2), ti, tj, U, s)) return false;
  if (ENERGY) p[0] = U;
  const T sdx = s * dx, sdy = s * dy, sdz = s * dz;
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

// One block's work in the group launch: the half stencil of global home
// cell `gc`, its rows read where `src` keeps them, its raw sums written at
// `home` (its first slot in the launch's [n_ch][14][n_slots] planes).
template <class T, bool ENERGY, bool VIRIAL, class Form, class Src>
__device__ __forceinline__ void forces_block(
    const Src& src, int gc, size_t home, size_t n_slots,
    const T* __restrict__ box, const HalfGeom& g, Form& form,
    const T* __restrict__ rcm, int rcm_t, T rc2, T min_r2,
    T* __restrict__ sums) {
  constexpr int NCH = Channels<ENERGY, VIRIAL>::kCount;
  const int cap = g.cap;
  const int C = kHalf * cap;
  const int tid = threadIdx.x;
  Vec4<T>* spos = htf::dynamic_smem<Vec4<T>>();            // [C]
  int* stag = reinterpret_cast<int*>(spos + C);            // [C]
  unsigned char* scratch = reinterpret_cast<unsigned char*>(stag + C);
  T* part = reinterpret_cast<T*>(scratch + htf::stage_bytes<T>());
  //                                                   [kThreads][NCH]
  form.stage(part + kThreads * NCH, tid);  // the form's own table

  int n0;
  const int total = htf::stage_rows<T>(
      g, gc, rc2, src, box, spos, stag, scratch, n0, htf::NoExtra(),
      [&](int t, int r) {
        // a slot out of every row's reach: its back sums are zero
#pragma unroll
        for (int k = 0; k < NCH; ++k)
          sums[(k * kHalf + t) * n_slots + home + r] = T(0);
      });

  // row sweep: the row sums of the home slots over all 14 blocks
  for (int r0 = 0; r0 < n0; r0 += kThreads) {
    const htf::RowSplit sp(r0, n0);
    if (sp.active) {
      T acc[NCH];
#pragma unroll
      for (int k = 0; k < NCH; ++k) acc[k] = T(0);
      const Vec4<T> q = spos[sp.row];
      for (int j = sp.seg; j < total; j += sp.nseg) {
        if (j == sp.row) continue;  // the self pair (block 0)
        T p[NCH];
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
        T v = T(0);
        for (int s = 0; s < sp.nseg; ++s) v += part[(tid * sp.nseg + s) * NCH + k];
        sums[k * kHalf * n_slots + out] = v;
      }
    }
    __syncthreads();
  }

  // candidate sweep: the back sums of the directed blocks' slots
  for (int j = n0 + tid; j < total; j += kThreads) {
    T acc[NCH];
#pragma unroll
    for (int k = 0; k < NCH; ++k) acc[k] = T(0);
    const Vec4<T> gj = spos[j];
    for (int i = 0; i < n0; ++i) {
      T p[NCH];
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

// One block per home cell of a whole state. Its body
// is forces_block's for one buffer, written out: through forces_block,
// ptxas -v (sm_90a) gives the double proxy form without energy
// or virial 64 registers and a 12-byte spill; written out, 64 registers
// and none, the other 15 instantiations the same registers either way.
template <class T, bool ENERGY, bool VIRIAL, class Form>
__global__ void __launch_bounds__(kThreads)
half_stencil_forces(const T* __restrict__ pos, const int* __restrict__ types,
                    const T* __restrict__ valid, const T* __restrict__ box,
                    HalfGeom g, Form form, const T* __restrict__ rcm,
                    int rcm_t, T rc2, T min_r2, T* __restrict__ sums) {
  constexpr int NCH = Channels<ENERGY, VIRIAL>::kCount;
  const int cap = g.cap;
  const int C = kHalf * cap;
  const int c = blockIdx.x;
  const int tid = threadIdx.x;
  const size_t n_slots = static_cast<size_t>(gridDim.x) * cap;
  Vec4<T>* spos = htf::dynamic_smem<Vec4<T>>();            // [C]
  int* stag = reinterpret_cast<int*>(spos + C);            // [C]
  unsigned char* scratch = reinterpret_cast<unsigned char*>(stag + C);
  T* part = reinterpret_cast<T*>(scratch + htf::stage_bytes<T>());
  //                                                   [kThreads][NCH]
  form.stage(part + kThreads * NCH, tid);  // the form's own table

  const size_t home = static_cast<size_t>(c) * cap;
  int n0;
  const int total = htf::stage_half_stencil<T>(
      g, c, rc2, pos, types, valid, box, spos, stag,
      scratch, n0,
      htf::NoExtra(), [&](int t, int r) {
        // a slot out of every row's reach: its back sums are zero
#pragma unroll
        for (int k = 0; k < NCH; ++k)
          sums[(k * kHalf + t) * n_slots + home + r] = T(0);
      });

  // row sweep: the row sums of the home slots over all 14 blocks
  for (int r0 = 0; r0 < n0; r0 += kThreads) {
    const htf::RowSplit sp(r0, n0);
    if (sp.active) {
      T acc[NCH];
#pragma unroll
      for (int k = 0; k < NCH; ++k) acc[k] = T(0);
      const Vec4<T> q = spos[sp.row];
      for (int j = sp.seg; j < total; j += sp.nseg) {
        if (j == sp.row) continue;  // the self pair (block 0)
        T p[NCH];
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
        T v = T(0);
        for (int s = 0; s < sp.nseg; ++s) v += part[(tid * sp.nseg + s) * NCH + k];
        sums[k * kHalf * n_slots + out] = v;
      }
    }
    __syncthreads();
  }

  // candidate sweep: the back sums of the directed blocks' slots
  for (int j = n0 + tid; j < total; j += kThreads) {
    T acc[NCH];
#pragma unroll
    for (int k = 0; k < NCH; ++k) acc[k] = T(0);
    const Vec4<T> gj = spos[j];
    for (int i = 0; i < n0; ++i) {
      T p[NCH];
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

// One launch over every home cell of a group's shards (GroupTab): block b
// is home cell b - k H of shard k = b / H (H home cells a shard), its raw
// sums at slot b cap of the group's planes.
template <class T, bool ENERGY, bool VIRIAL, class Form>
__global__ void __launch_bounds__(kThreads)
half_stencil_group_forces(const __grid_constant__ htf::GroupTab<T> tab,
                          const T* __restrict__ box, HalfGeom g, Form form,
                          const T* __restrict__ rcm, int rcm_t, T rc2,
                          T min_r2, T* __restrict__ sums) {
  const int H = g.nzl * g.nx * g.ny;
  const int b = blockIdx.x;
  const int k = b / H;
  forces_block<T, ENERGY, VIRIAL>(
      htf::ShardRows<T>(tab, k), tab.z0[k] * g.nx * g.ny + (b - k * H),
      static_cast<size_t>(b) * g.cap,
      static_cast<size_t>(gridDim.x) * g.cap, box, g, form, rcm, rcm_t, rc2,
      min_r2, sums);
}

template <class T>
long smem_bytes(int cap, int n_ch, int form_words) {
  return static_cast<long>(kHalf) * cap * (sizeof(Vec4<T>) + sizeof(int)) +
         htf::stage_bytes<T>() +
         static_cast<long>(sizeof(T)) * (kThreads * n_ch + form_words);
}

int allow_smem(const void* kernel, long smem) {
  if (smem <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem)));
}

template <class T, bool ENERGY, bool VIRIAL, class Form>
int launch(const T* pos, const int* types, const T* valid, const T* box,
           const HalfGeom& g, int n_cells, Form form, int form_words,
           const T* rcm, int rcm_t, T rc2, T min_r2, T* sums, T* forces4,
           T* virial, cudaStream_t stream) {
  constexpr int NCH = Channels<ENERGY, VIRIAL>::kCount;
  const long smem = smem_bytes<T>(g.cap, NCH, form_words);
  auto kernel = half_stencil_forces<T, ENERGY, VIRIAL, Form>;
  const int a = allow_smem(reinterpret_cast<const void*>(kernel), smem);
  if (a != 0) return a;
  kernel<<<n_cells, kThreads, smem, stream>>>(pos, types, valid, box, g,
                                              form, rcm, rcm_t, rc2, min_r2,
                                              sums);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const int n_slots = n_cells * g.cap;
  half_stencil_home<T, ENERGY, VIRIAL>
      <<<(n_slots + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
          sums, valid, g, n_slots, reinterpret_cast<Vec4<T>*>(forces4),
          virial);
  return static_cast<int>(cudaGetLastError());
}

// A group's launch: half_stencil_group_forces over every home cell of its
// shards, then half_stencil_group_home
// over every row of their buffers (the outputs joined, shard after shard).
template <class T, bool ENERGY, bool VIRIAL, class Form>
int launch_group(const htf::GroupTab<T>& tab, const T* box,
                 const HalfGeom& g, Form form, int form_words,
                 const T* rcm, int rcm_t, T rc2, T min_r2, T* sums,
                 T* forces4, T* virial, cudaStream_t stream) {
  constexpr int NCH = Channels<ENERGY, VIRIAL>::kCount;
  const long smem = smem_bytes<T>(g.cap, NCH, form_words);
  auto kernel = half_stencil_group_forces<T, ENERGY, VIRIAL, Form>;
  int e = allow_smem(reinterpret_cast<const void*>(kernel), smem);
  if (e != 0) return e;
  const int blocks = tab.n * g.nzl * g.nx * g.ny;
  kernel<<<blocks, kThreads, smem, stream>>>(tab, box, g, form, rcm, rcm_t,
                                             rc2, min_r2, sums);
  e = static_cast<int>(cudaGetLastError());
  if (e != 0) return e;
  const long rows = static_cast<long>(tab.n) * htf::out_slots(g);
  htf::half_stencil_group_home<T, ENERGY, VIRIAL>
      <<<(rows + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
          sums, tab, g, reinterpret_cast<Vec4<T>*>(forces4), virial);
  return static_cast<int>(cudaGetLastError());
}

// The call's pointers, typed: the wrapper hands them over as void *.
template <class T>
struct Args {
  const T *pos, *valid, *box, *rcm;
  const int* types;
  int rcm_t;
  T rc2, min_r2;
  T *sums, *forces4, *virial;
  const htf::GroupTab<T>* tab;  // a group's launch, else null

  Args(const void* p, const int* ty, const void* v, const void* b,
       const void* rm, int rt, double r2, double mr2, void* s, void* f,
       void* w)
      : pos(static_cast<const T*>(p)), valid(static_cast<const T*>(v)),
        box(static_cast<const T*>(b)), rcm(static_cast<const T*>(rm)),
        types(ty), rcm_t(rt), rc2(static_cast<T>(r2)),
        min_r2(static_cast<T>(mr2)), sums(static_cast<T*>(s)),
        forces4(static_cast<T*>(f)), virial(static_cast<T*>(w)),
        tab(nullptr) {}
};

template <class T, class Form>
int dispatch(const Args<T>& a, const HalfGeom* geom, int n_cells, Form form,
             int form_words, int needs_energy, int needs_virial,
             void* stream) {
  const HalfGeom g = *geom;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define HTF_LAUNCH(E, V)                                                    \
  (a.tab ? launch_group<T, E, V>(*a.tab, a.box, g, form, form_words,      \
                                 a.rcm, a.rcm_t, a.rc2, a.min_r2, a.sums,  \
                                 a.forces4, a.virial, s)                   \
         : launch<T, E, V>(a.pos, a.types, a.valid, a.box, g, n_cells,     \
                           form, form_words, a.rcm, a.rcm_t, a.rc2,        \
                           a.min_r2, a.sums, a.forces4, a.virial, s))
  if (needs_energy && needs_virial) return HTF_LAUNCH(true, true);
  if (needs_energy) return HTF_LAUNCH(true, false);
  if (needs_virial) return HTF_LAUNCH(false, true);
  return HTF_LAUNCH(false, false);
#undef HTF_LAUNCH
}

template <class T>
int lj(const Args<T>& a, const HalfGeom* geom, int n_cells, const void* form,
       int form_t, int strict, int needs_energy, int needs_virial,
       void* stream) {
  LJForm<T> f{static_cast<const Vec4<T>*>(form), form_t, strict};
  return dispatch(a, geom, n_cells, f, 0, needs_energy, needs_virial,
                  stream);
}

// ChebForm's table in device memory: the coefficients, then the edge sums
// in ChebForm::stage's order.
template <class T>
__global__ void __launch_bounds__(kThreads)
cheb_device_table(const T* __restrict__ coef, int P, int K,
                  T* __restrict__ out) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i < P * 2 * K) out[i] = coef[i];
  if (i < P * 2) out[P * 2 * K + i] = seq_sum(coef + i * K, K);
}

template <class T>
int cheb(const Args<T>& a, const HalfGeom* geom, int n_cells,
         const void* coef, int ntypes, int K, double mid, double inv_half,
         double u_hi, void* dtab, int needs_energy, int needs_virial,
         void* stream) {
  const T* c = static_cast<const T*>(coef);
  const int P = ntypes * (ntypes + 1) / 2;
  if (dtab != nullptr) {
    cheb_device_table<T>
        <<<(P * 2 * K + kThreads - 1) / kThreads, kThreads, 0,
           static_cast<cudaStream_t>(stream)>>>(c, P, K,
                                                static_cast<T*>(dtab));
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  ChebForm<T> f{c, ntypes, K, static_cast<T>(mid), static_cast<T>(inv_half),
                static_cast<T>(u_hi), static_cast<const T*>(dtab), nullptr};
  return dispatch(a, geom, n_cells, f,
                  dtab != nullptr ? 0 : P * 2 * K + P * 2, needs_energy,
                  needs_virial, stream);
}

}  // namespace

extern "C" {

// Shared-memory bytes one block of half_stencil_forces needs (the wrapper
// checks the limit); `form_words` is the pair form's own table in scalars
// (0 for the LJ form); `f64` picks the double instantiation.
long htf_half_stencil_smem(int f64, int cap, int n_channels,
                           int form_words) {
  return f64 ? smem_bytes<double>(cap, n_channels, form_words)
             : smem_bytes<float>(cap, n_channels, form_words);
}

// LJ-family form. `f64` picks the scalar type of every floating array:
// float32 (0) or float64 (1). `pos` [n_slots][3], `types` [n_slots] int32
// (or null when untyped), `valid` [n_slots], `box` the [3][3] box (rows
// low, high, tilt) on the card, `geom` a host HalfGeom, `form` the
// [form_t][form_t][4] table, `rcm` the [rcm_t][rcm_t] squared cutoffs (or
// null), `sums` the [n_ch][14][n_slots] scratch, `forces4` [n_slots][4],
// `virial` [n_slots][9] (or null); rc2 and min_r2 are rounded to the
// scalar type. Launches both kernels on `stream`; returns
// cudaGetLastError() after them (0 = ok).
int htf_half_stencil(int f64, const void* pos, const int* types,
                     const void* valid, const void* box,
                     const HalfGeom* geom, int n_cells, const void* form,
                     int form_t, int strict, const void* rcm, int rcm_t,
                     double rc2, double min_r2, int needs_energy,
                     int needs_virial, void* sums, void* forces4,
                     void* virial, void* stream) {
  if (f64)
    return lj(Args<double>(pos, types, valid, box, rcm, rcm_t, rc2, min_r2,
                           sums, forces4, virial),
              geom, n_cells, form, form_t, strict, needs_energy,
              needs_virial, stream);
  return lj(Args<float>(pos, types, valid, box, rcm, rcm_t, rc2, min_r2,
                        sums, forces4, virial),
            geom, n_cells, form, form_t, strict, needs_energy, needs_virial,
            stream);
}

// Chebyshev-proxy form: `coef` is the [P][2][K] table of a `ntypes`-type
// proxy (P = ntypes (ntypes + 1) / 2), of the scalar type `f64` picks.
// `dtab` is null (the table is staged in shared memory, form_words
// P * 2K + 2P) or [P * 2K + 2P] device scratch of that type the launch
// fills and the kernel reads (form_words 0).
int htf_half_stencil_cheb(int f64, const void* pos, const int* types,
                          const void* valid, const void* box,
                          const HalfGeom* geom, int n_cells, const void* coef,
                          int ntypes, int K, double mid, double inv_half,
                          double u_hi, void* dtab, const void* rcm,
                          int rcm_t, double rc2,
                          double min_r2, int needs_energy, int needs_virial,
                          void* sums, void* forces4, void* virial,
                          void* stream) {
  if (f64)
    return cheb(Args<double>(pos, types, valid, box, rcm, rcm_t, rc2, min_r2,
                             sums, forces4, virial),
                geom, n_cells, coef, ntypes, K, mid, inv_half, u_hi, dtab,
                needs_energy, needs_virial, stream);
  return cheb(Args<float>(pos, types, valid, box, rcm, rcm_t, rc2, min_r2,
                          sums, forces4, virial),
              geom, n_cells, coef, ntypes, K, mid, inv_half, u_hi, dtab,
              needs_energy, needs_virial, stream);
}

// The group launches (GroupTab; half_stencil_group_forces and
// half_stencil_group_home): `n` shards of one card in ring order, their
// buffers' arrays in the host arrays `pos`, `types` (or null when
// untyped) and `valid`, their first home layers `z0` and ring neighbours
// in the group `prev`, `next` (-1: outside it); `geom` a HalfGeom of
// their nzl; `sums` the [n_ch][14][n H cap] scratch (H home cells a
// shard), `forces4`
// [n][(nzl + 1) nx ny cap][4] and `virial` [n][...][9] (or null), the
// shards' outputs joined. The rest as htf_half_stencil.
int htf_half_stencil_group(int f64, int n, const void* const* pos,
                           const void* const* types,
                           const void* const* valid, const int* z0,
                           const int* prev, const int* next, const void* box,
                           const HalfGeom* geom, const void* form,
                           int form_t, int strict, const void* rcm,
                           int rcm_t, double rc2, double min_r2,
                           int needs_energy, int needs_virial, void* sums,
                           void* forces4, void* virial, void* stream) {
  if (n < 1 || n > htf::kMaxGroup) return cudaErrorInvalidValue;
  if (f64) {
    const htf::GroupTab<double> tab =
        htf::group_tab<double>(n, pos, types, valid, z0, prev, next);
    Args<double> a(nullptr, nullptr, nullptr, box, rcm, rcm_t, rc2, min_r2,
                   sums, forces4, virial);
    a.tab = &tab;
    return lj(a, geom, 0, form, form_t, strict, needs_energy, needs_virial,
              stream);
  }
  const htf::GroupTab<float> tab =
      htf::group_tab<float>(n, pos, types, valid, z0, prev, next);
  Args<float> a(nullptr, nullptr, nullptr, box, rcm, rcm_t, rc2, min_r2,
                sums, forces4, virial);
  a.tab = &tab;
  return lj(a, geom, 0, form, form_t, strict, needs_energy, needs_virial,
            stream);
}

// The Chebyshev-proxy form's group launch: the group's arguments as
// htf_half_stencil_group, the form's as htf_half_stencil_cheb.
int htf_half_stencil_group_cheb(
    int f64, int n, const void* const* pos, const void* const* types,
    const void* const* valid, const int* z0, const int* prev,
    const int* next, const void* box, const HalfGeom* geom,
    const void* coef, int ntypes, int K, double mid, double inv_half,
    double u_hi, void* dtab, const void* rcm, int rcm_t, double rc2,
    double min_r2, int needs_energy, int needs_virial, void* sums,
    void* forces4, void* virial, void* stream) {
  if (n < 1 || n > htf::kMaxGroup) return cudaErrorInvalidValue;
  if (f64) {
    const htf::GroupTab<double> tab =
        htf::group_tab<double>(n, pos, types, valid, z0, prev, next);
    Args<double> a(nullptr, nullptr, nullptr, box, rcm, rcm_t, rc2, min_r2,
                   sums, forces4, virial);
    a.tab = &tab;
    return cheb(a, geom, 0, coef, ntypes, K, mid, inv_half, u_hi, dtab,
                needs_energy, needs_virial, stream);
  }
  const htf::GroupTab<float> tab =
      htf::group_tab<float>(n, pos, types, valid, z0, prev, next);
  Args<float> a(nullptr, nullptr, nullptr, box, rcm, rcm_t, rc2, min_r2,
                sums, forces4, virial);
  a.tab = &tab;
  return cheb(a, geom, 0, coef, ntypes, K, mid, inv_half, u_hi, dtab,
              needs_energy, needs_virial, stream);
}

const char* htf_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
