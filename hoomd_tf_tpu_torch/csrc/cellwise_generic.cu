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
//     the cut, and writes them into a compact list
//     (r2, ti, tj):
//       lane (i, j), i a staged home row, j a staged candidate of the 14
//       blocks, kept when d2 <= rc2 (and d2 <= rc2_tab[ti][tj] when a
//       per-type table is given), j != i (the self pair, by staged index),
//       r2 = max(d2, min_r2), the types as floats.
//     A cell's lanes are row-major (rows and candidates in staged order),
//     so their order is fixed by the home cell and its sweep. The cell's
//     segment is placed by one atomicAdd on a device counter; a cell whose
//     segment would pass the list's budget writes nothing and its base is
//     negative (-1 - the base it drew). The counter ends at the lanes the
//     call needed, budget or not.
//     It also writes the cell's record (its staged entries, tags, row
//     offsets and lane masks) for the reduction, and the zero back sums
//     of the slots the box test left out.
//   the pair function, evaluated by PyTorch on the list:
//     U, s = pair_fn(r2, ti, tj), s = dU/dr2 (user code: the counterpart
//     of the jaxpr Pallas inlines).
//   generic_reduce, one block per home cell: it reads the cell's record,
//     reads each lane's (U, s) by its list index, with no atomics, and
//     makes K1's row sweep (a warp per row, its lanes read densely and
//     summed by a fixed shuffle tree) and candidate sweep (a thread per
//     candidate of blocks 1..13, rows in order), writing the raw sums of
//     K1's channels. Its first block copies the counter out and zeroes it
//     for the next call.
//   half_stencil_home (half_stencil_home.cuh): the Newton push-back and the
//     finish, as in K1.
//   generic_reduce_bwd, the backward of generic_reduce for training (no
//     Pallas counterpart: the JAX package differentiates its pair function
//     through the lane contraction of hoomd_tf_tpu/ops/pair_train.py:
//     161-233 in XLA). The reduction is linear in each listed lane's
//     (U, s), so its vector-Jacobian product with respect to them is a
//     pair of per-lane weights of the forces' cotangent ct (folded with
//     `valid`, which the finish multiplies by), the JAX package's wE, wF:
//       gU = 0.5 ct_e[i] + [block >= 1] 0.5 ct_e[j]
//       gS = sum_k d_k (2 ct_k[i] - [block >= 1] 2 ct_k[j])
//     with i the lane's home slot and j the candidate's own slot, where
//     half_stencil_home pushes its back sums (block 0 lists both orders,
//     so it takes the row term only). One block per home cell reads the
//     cell's record as the reduction does and writes each lane's pair at
//     its list index; further blocks write zeros past the lanes needed,
//     and a cell that did not fit zeroes its share of the list, so every
//     lane of the budget is written and lanes that hold no listed pair
//     (whose r2 is left from an earlier call) carry no gradient.
// The list's placement varies from call to call; the values do not: each
// lane's (U, s) is a function of the lane, and every sum runs in a fixed
// order. A cell that did not fit (negative base) contributes zero sums;
// the caller sees the overflow in the needed count and re-runs with a
// larger budget.
//
// What bounds it on an H100: not bytes (the slot state and 20 bytes per
// listed lane, ~43 MB at the 64k fluid's shapes, 0.013 ms) nor operations
// (9 per tested pair, a few per listed lane), but each cell's chain of
// dependent phases (staging, marking, scans, the writes or sweeps)
// separated by barriers (profile_step.py --mode genparts). So:
//   - the marking gives each warp 32 candidates, held in registers while
//     the rows stream past (a broadcast read per ballot); the row scans
//     are warp scans;
//   - the list's writes and the row sweep are dense (lane e of a row at
//     list index row + e, its candidate the e-th set bit of the row's
//     masks), and the candidate sweep issues the (U, s) loads of 8 rows
//     together;
//   - the reduction does not stage or mark again: the list kernel hands
//     it each cell's record through device memory (~6 KB a cell at the
//     64k fluid's shapes, written and read once).
// Each lane's mask is a bit in shared memory (a 32-bit word per row and
// warp-wide chunk of candidates, with the row's running count before it),
// so the candidate sweep finds a lane's list index with one population
// count.
//
// The backward is bound by bytes: each cell's record read once (~6 KB a
// cell at the 64k fluid's shapes), ct read for the rows and candidates,
// and 8 bytes written per lane of the budget; a warp per row writes its
// lanes densely, as the row sweep reads them.
//
// Built with -fmad=false, and the staging uses _rn intrinsics, so the
// masks and r2 are bit-equal to the PyTorch plain version's.
//
// Every kernel is a template on the scalar type T (scalar.cuh), built for
// float and for double. In double the list holds r2, ti, tj as doubles
// and the pair function's (U, s) come back as doubles (40 bytes a lane,
// against 20), and the staged entries of the records and of shared memory
// take 32 bytes instead of 16: the pair function sees the lane's r2 in
// double, not rounded to float.

#include <cuda_runtime.h>
#include <stdint.h>

#include "half_stencil_home.cuh"
#include "half_stencil_stage.cuh"
#include "scalar.cuh"

namespace {

using htf::Channels;
using htf::HalfGeom;
using htf::half_stencil_home;
using htf::kHalf;
using htf::kThreads;
using htf::kWarps;
using htf::Vec4;

constexpr unsigned kFull = 0xffffffffu;
// blocks of 256 threads an SM the kernels are built for: 6 in float (40
// registers), 4 in double (64: at 40 a double reduction spills)
template <class T>
constexpr int kMinBlocks = sizeof(T) == 8 ? 4 : 6;

// d2 of the lane (row q, candidate g) and whether it is inside the cut.
template <class T>
__device__ __forceinline__ bool in_cut(Vec4<T> q, Vec4<T> g,
                                       const T* __restrict__ rcm, int rcm_t,
                                       T rc2, T& dx, T& dy, T& dz, T& d2) {
  dx = g.x - q.x;
  dy = g.y - q.y;
  dz = g.z - q.z;
  d2 = dx * dx + dy * dy + dz * dz;
  if (!(d2 <= rc2)) return false;
  if (rcm != nullptr) {
    const int ti = htf::unpack_type(q.w), tj = htf::unpack_type(g.w);
    const bool known = ti >= 0 && ti < rcm_t && tj >= 0 && tj < rcm_t;
    const T prc2 = known ? rcm[ti * rcm_t + tj] : T(0);
    if (!(d2 <= prc2)) return false;
  }
  return true;
}

// The list kernel's shared memory: the staged arrays, the staging's
// scratch, then the lane masks.
template <class T>
struct Smem {
  Vec4<T>* spos;   // [C] staged entries
  int* stag;       // [C] their tags
  unsigned char* stage;  // [stage_bytes<T>] the staging's scratch
  int* rowoff;     // [cap + 1] each row's first lane in the cell's segment
  int* scratch;    // [2]
  uint32_t* mask;  // [cap][W] in-cut bits, candidate j = 32 w + bit
  uint16_t* pre;   // [cap][W] the row's in-cut lanes before word w
  int W;
};

template <class T>
__host__ __device__ inline long list_layout(int cap, char* base, Smem<T>* s) {
  const long C = static_cast<long>(kHalf) * cap;
  s->W = static_cast<int>((C + 31) / 32);
  long off = 0;
  auto take = [&](long bytes) {
    const long at = off;
    off += (bytes + 15) & ~15L;
    return base ? base + at : nullptr;
  };
  s->spos = reinterpret_cast<Vec4<T>*>(take(sizeof(Vec4<T>) * C));
  s->stag = reinterpret_cast<int*>(take(4 * C));
  s->stage = reinterpret_cast<unsigned char*>(take(htf::stage_bytes<T>()));
  s->rowoff = reinterpret_cast<int*>(take(4L * (cap + 1)));
  s->scratch = reinterpret_cast<int*>(take(4L * 2));
  s->mask = reinterpret_cast<uint32_t*>(take(4L * cap * s->W));
  s->pre = reinterpret_cast<uint16_t*>(take(2L * cap * s->W));
  return off;
}

template <class T>
long smem_bytes(int cap) {
  Smem<T> s;
  return list_layout(cap, nullptr, &s);
}

// Rows of the candidate sweep whose list loads are in flight together.
constexpr int kBatch = 8;

// The position of the n-th (from 0) set bit of m (m has more than n).
__device__ __forceinline__ int nth_bit(unsigned m, int n) {
  int pos = 0;
#pragma unroll
  for (int sh = 16; sh > 0; sh >>= 1) {
    const int c = __popc(m & ((1u << sh) - 1u));
    if (n >= c) {
      n -= c;
      m >>= sh;
      pos += sh;
    }
  }
  return pos;
}

// The staged candidate of a row's lane e (e < the row's lanes): the e-th
// set bit of the row's `nw` mask words, found from their running counts.
__device__ __forceinline__ int lane_candidate(const uint32_t* mask,
                                              const uint16_t* pre, int nw,
                                              int e) {
  int w = 0;
  for (int v = 1; v < nw; ++v) w = pre[v] <= e ? v : w;
  return w * 32 + nth_bit(mask[w], e - pre[w]);
}

// Mark the in-cut lanes of the n0 staged rows against the `total` staged
// candidates into s.mask: a warp per 32-candidate word, each lane holding
// its candidate while the rows stream past (one broadcast read of a row
// per ballot). Then a warp per row scans its words' counts into s.pre and
// its count into s.rowoff[i + 1], and warp 0 scans the rows' counts
// (s.rowoff exclusive, rowoff[n0] the cell's lanes). Every thread calls
// it; it ends with a barrier.
template <class T>
__device__ void mark_lanes(int n0, int total, const T* __restrict__ rcm,
                           int rcm_t, T rc2, const Smem<T>& s) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nw = (total + 31) / 32;
  for (int w = warp; w < nw; w += kWarps) {
    const int j = w * 32 + lane;
    const Vec4<T> g = s.spos[j < total ? j : total - 1];
    for (int i = 0; i < n0; ++i) {
      const Vec4<T> q = s.spos[i];
      bool ok = false;
      if (j < total && j != i) {
        T dx, dy, dz, d2;
        ok = in_cut(q, g, rcm, rcm_t, rc2, dx, dy, dz, d2);
      }
      const unsigned b = __ballot_sync(kFull, ok);
      if (lane == 0) s.mask[i * s.W + w] = b;
    }
  }
  __syncthreads();
  for (int i = warp; i < n0; i += kWarps) {
    int carry = 0;
    for (int w0 = 0; w0 < nw; w0 += 32) {
      const int w = w0 + lane;
      const int v = w < nw ? __popc(s.mask[i * s.W + w]) : 0;
      int x = v;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(kFull, x, o);
        if (lane >= o) x += y;
      }
      if (w < nw) s.pre[i * s.W + w] = static_cast<uint16_t>(carry + x - v);
      carry += __shfl_sync(kFull, x, 31);
    }
    if (lane == 0) s.rowoff[i + 1] = carry;
  }
  __syncthreads();
  if (warp == 0) {
    int carry = 0;
    for (int i0 = 0; i0 < n0; i0 += 32) {
      const int i = i0 + lane;
      const int v = i < n0 ? s.rowoff[i + 1] : 0;
      int x = v;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(kFull, x, o);
        if (lane >= o) x += y;
      }
      if (i < n0) s.rowoff[i + 1] = carry + x;
      carry += __shfl_sync(kFull, x, 31);
    }
    if (lane == 0) s.rowoff[0] = 0;
  }
  __syncthreads();
}

// The displacement of the lane (row q, candidate g), in_cut's arithmetic.
template <class T>
__device__ __forceinline__ void lane_d(Vec4<T> q, Vec4<T> g, T& dx, T& dy,
                                       T& dz) {
  dx = g.x - q.x;
  dy = g.y - q.y;
  dz = g.z - q.z;
}

__host__ __device__ __forceinline__ long pad4(long n) {
  return (n + 3) & ~3L;
}

// The list kernel's record of a cell, handed to the reduction through
// device memory: 4-byte words from the cell's start, rec_words<T>(cap)
// apart (a multiple of 4 words). Words 0-2 hold n0, total and nw (the
// candidates' mask words); then the staged entries (a Vec4<T> each, 4
// words in float and 8 in double, from word 4), their tags (a word each),
// rowoff [n0 + 1], the masks [n0][nw] and the rows' running counts
// [n0][nw] (16-bit halves).
struct Rec {
  long tag, rowoff, mask, pre;
};

template <class T>
__host__ __device__ __forceinline__ Rec rec_offsets(int n0, int total,
                                                    int nw) {
  Rec r;
  r.tag = 4 + static_cast<long>(sizeof(Vec4<T>) / 4) * total;
  r.rowoff = r.tag + total;
  r.mask = r.rowoff + n0 + 1;
  r.pre = r.mask + static_cast<long>(n0) * nw;
  return r;
}

template <class T>
long rec_words(int cap) {
  const int C = kHalf * cap, W = (C + 31) / 32;
  const Rec r = rec_offsets<T>(cap, C, W);
  return pad4(r.pre + (static_cast<long>(cap) * W + 1) / 2);
}

// Write the staged cell (s) into its record (every thread; no barrier).
template <class T>
__device__ void write_record(const Smem<T>& s, int n0, int total,
                             int* __restrict__ rec) {
  const int tid = threadIdx.x;
  const int nw = (total + 31) / 32;
  const Rec o = rec_offsets<T>(n0, total, nw);
  if (tid == 0) {
    rec[0] = n0;
    rec[1] = total;
    rec[2] = nw;
  }
  Vec4<T>* spos = reinterpret_cast<Vec4<T>*>(rec + 4);
  for (int e = tid; e < total; e += kThreads) {
    spos[e] = s.spos[e];
    rec[o.tag + e] = s.stag[e];
  }
  for (int i = tid; i <= n0; i += kThreads) rec[o.rowoff + i] = s.rowoff[i];
  uint16_t* pre = reinterpret_cast<uint16_t*>(rec + o.pre);
  for (int u = tid; u < n0 * nw; u += kThreads) {
    const int i = u / nw, w = u - i * nw;
    rec[o.mask + u] = static_cast<int>(s.mask[i * s.W + w]);
    pre[u] = s.pre[i * s.W + w];
  }
}

template <class T>
__global__ void __launch_bounds__(kThreads, kMinBlocks<T>)
generic_list(const T* __restrict__ pos, const int* __restrict__ types,
             const T* __restrict__ valid, const T* __restrict__ box,
             HalfGeom g, const T* __restrict__ rcm, int rcm_t, T rc2,
             T min_r2, int budget, int* __restrict__ counter,
             int* __restrict__ cell_base, T* __restrict__ r2_out,
             T* __restrict__ ti_out, T* __restrict__ tj_out,
             int* __restrict__ rec, long rec_stride, T* __restrict__ sums,
             int nch) {
  Smem<T> s;
  list_layout(g.cap, htf::dynamic_smem<char>(), &s);
  const int c = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t n_slots = static_cast<size_t>(gridDim.x) * g.cap;
  const size_t home = static_cast<size_t>(c) * g.cap;
  int n0;
  const int total = htf::stage_half_stencil<T>(
      g, c, rc2, pos, types, valid, box, s.spos, s.stag, s.stage, n0,
      htf::NoExtra(), [&](int t, int r) {
        // a slot out of every row's reach: its back sums are zero
        for (int k = 0; k < nch; ++k)
          sums[(k * kHalf + t) * n_slots + home + r] = T(0);
      });
  mark_lanes(n0, total, rcm, rcm_t, rc2, s);
  if (tid == 0) {
    const int n_lanes = s.rowoff[n0];
    int base = atomicAdd(counter, n_lanes);
    // a segment that does not fit: its base, b, is kept as -1 - b (the
    // backward zeroes the part of [b, b + n_lanes) inside the list)
    if (base > budget - n_lanes) base = -1 - base;
    cell_base[c] = base;
    s.scratch[0] = base;
  }
  write_record(s, n0, total, rec + c * rec_stride);
  __syncthreads();
  const int base = s.scratch[0];
  if (base < 0) return;
  // a warp per row writes the row's lanes densely: lane e of the row at
  // list index row + e
  const int nw = (total + 31) / 32;
  for (int i = warp; i < n0; i += kWarps) {
    const Vec4<T> q = s.spos[i];
    const int row = base + s.rowoff[i];
    const int cnt = s.rowoff[i + 1] - s.rowoff[i];
    for (int e = lane; e < cnt; e += 32) {
      const Vec4<T> gj =
          s.spos[lane_candidate(s.mask + i * s.W, s.pre + i * s.W, nw, e)];
      T dx, dy, dz;
      lane_d(q, gj, dx, dy, dz);
      const T d2 = dx * dx + dy * dy + dz * dz;
      r2_out[row + e] = htf::fmax_(d2, min_r2);
      ti_out[row + e] = static_cast<T>(htf::unpack_type(q.w));
      tj_out[row + e] = static_cast<T>(htf::unpack_type(gj.w));
    }
  }
}

// The channel products of the lane (row q, candidate g) with its (U, s).
template <bool ENERGY, bool VIRIAL, class T>
__device__ __forceinline__ void add_products(
    T dx, T dy, T dz, T U, T sl, T (&acc)[Channels<ENERGY, VIRIAL>::kCount]) {
  constexpr int OF = Channels<ENERGY, VIRIAL>::kForce;
  if (ENERGY) acc[0] += U;
  const T sdx = sl * dx, sdy = sl * dy, sdz = sl * dz;
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

// The reduction's shared memory: a cell's record, unpacked.
template <class T>
struct RSmem {
  Vec4<T>* spos;    // [C]
  uint16_t* stag;   // [C]
  int* rowoff;      // [cap + 1]
  uint32_t* mask;   // [cap * W], row stride nw of the cell
  uint16_t* pre;    // [cap * W]
};

template <class T>
__host__ __device__ inline long reduce_layout(int cap, char* base,
                                              RSmem<T>* s) {
  const long C = static_cast<long>(kHalf) * cap, W = (C + 31) / 32;
  long off = 0;
  auto take = [&](long bytes) {
    const long at = off;
    off += (bytes + 15) & ~15L;
    return base ? base + at : nullptr;
  };
  s->spos = reinterpret_cast<Vec4<T>*>(take(sizeof(Vec4<T>) * C));
  s->stag = reinterpret_cast<uint16_t*>(take(2 * C));
  s->rowoff = reinterpret_cast<int*>(take(4L * (cap + 1)));
  s->mask = reinterpret_cast<uint32_t*>(take(4 * cap * W));
  s->pre = reinterpret_cast<uint16_t*>(take(2 * cap * W));
  return off;
}

template <class T, bool ENERGY, bool VIRIAL>
__global__ void __launch_bounds__(kThreads, kMinBlocks<T>)
generic_reduce(HalfGeom g, const int* __restrict__ rec,
               long rec_stride, const int* __restrict__ cell_base,
               const T* __restrict__ U, const T* __restrict__ S,
               T* __restrict__ sums, int* __restrict__ counter,
               int* __restrict__ needed) {
  constexpr int NCH = Channels<ENERGY, VIRIAL>::kCount;
  RSmem<T> s;
  reduce_layout(g.cap, htf::dynamic_smem<char>(), &s);
  const int cap = g.cap;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t n_slots = static_cast<size_t>(gridDim.x) * cap;
  if (blockIdx.x == 0 && tid == 0) {
    // every block of generic_list has finished: hand the count out and
    // zero the counter for the next call
    *needed = *counter;
    *counter = 0;
  }
  const int c = blockIdx.x;
  const int* r = rec + c * rec_stride;
  const int n0 = r[0], total = r[1], nw = r[2];
  const int base = cell_base[c];  // -1: the cell's lanes are not listed
  const Rec o = rec_offsets<T>(n0, total, nw);
  const Vec4<T>* rspos = reinterpret_cast<const Vec4<T>*>(r + 4);
  for (int e = tid; e < total; e += kThreads) {
    s.spos[e] = rspos[e];
    s.stag[e] = static_cast<uint16_t>(r[o.tag + e]);
  }
  for (int i = tid; i <= n0; i += kThreads) s.rowoff[i] = r[o.rowoff + i];
  const uint16_t* rpre = reinterpret_cast<const uint16_t*>(r + o.pre);
  for (int u = tid; u < n0 * nw; u += kThreads) {
    s.mask[u] = static_cast<uint32_t>(r[o.mask + u]);
    s.pre[u] = rpre[u];
  }
  __syncthreads();
  const size_t home = static_cast<size_t>(c) * cap;

  // row sweep: a warp per home row, its lanes read densely (lane e of
  // the row at list index row + e), each warp lane summing the row's
  // lanes e = lane, lane + 32, ... in order, then a fixed shuffle tree
  for (int i = warp; i < n0; i += kWarps) {
    T acc[NCH];
#pragma unroll
    for (int k = 0; k < NCH; ++k) acc[k] = T(0);
    const Vec4<T> q = s.spos[i];
    const int row = base + s.rowoff[i];
    const int cnt = base >= 0 ? s.rowoff[i + 1] - s.rowoff[i] : 0;
    for (int e = lane; e < cnt; e += 32) {
      T dx, dy, dz;
      lane_d(q, s.spos[lane_candidate(s.mask + i * nw, s.pre + i * nw, nw,
                                      e)],
             dx, dy, dz);
      add_products<ENERGY, VIRIAL>(dx, dy, dz, U[row + e], S[row + e],
                                   acc);
    }
#pragma unroll
    for (int k = 0; k < NCH; ++k) {
#pragma unroll
      for (int o2 = 16; o2 > 0; o2 >>= 1)
        acc[k] += __shfl_xor_sync(kFull, acc[k], o2);
    }
    if (lane == 0) {
      const size_t out = home + s.stag[i];  // block 0: tag = rank
#pragma unroll
      for (int k = 0; k < NCH; ++k)
        sums[k * kHalf * n_slots + out] = acc[k];
    }
  }

  // candidate sweep: the back sums of the directed blocks' slots, rows
  // in order, kBatch at a time: the batch's (U, s) loads are issued
  // together, then its lanes are summed in row order
  for (int j = n0 + tid; j < total; j += kThreads) {
    T acc[NCH];
#pragma unroll
    for (int k = 0; k < NCH; ++k) acc[k] = T(0);
    const Vec4<T> gj = s.spos[j];
    const int w = j >> 5;
    const unsigned bit = 1u << (j & 31);
    for (int i0 = 0; base >= 0 && i0 < n0; i0 += kBatch) {
      T u[kBatch], sl[kBatch];
      unsigned in = 0u;
#pragma unroll
      for (int t = 0; t < kBatch; ++t) {
        const int i = i0 + t;
        const unsigned m = i < n0 ? s.mask[i * nw + w] : 0u;
        u[t] = sl[t] = T(0);
        if (m & bit) {
          const int k = base + s.rowoff[i] + s.pre[i * nw + w] +
                        __popc(m & (bit - 1u));
          u[t] = U[k];
          sl[t] = S[k];
          in |= 1u << t;
        }
      }
#pragma unroll
      for (int t = 0; t < kBatch; ++t) {
        if ((in >> t) & 1u) {
          T dx, dy, dz;
          lane_d(s.spos[i0 + t], gj, dx, dy, dz);
          add_products<ENERGY, VIRIAL>(dx, dy, dz, u[t], sl[t], acc);
        }
      }
    }
    const int tag = s.stag[j];
    const int t = tag / cap;
    const size_t out =
        static_cast<size_t>(t) * n_slots + home + (tag - t * cap);
#pragma unroll
    for (int k = 0; k < NCH; ++k) sums[k * kHalf * n_slots + out] = acc[k];
  }
}

// Blocks of generic_reduce_bwd past the cells: they zero the list's tail.
constexpr int kTailBlocks = 132;

// The record of cell c read into shared memory (every thread; the caller
// places the barrier): the staged entries, their tags, row offsets, masks
// and running counts.
template <class T>
__device__ __forceinline__ void read_record(const int* __restrict__ r,
                                            int n0, int total, int nw,
                                            const RSmem<T>& s) {
  const int tid = threadIdx.x;
  const Rec o = rec_offsets<T>(n0, total, nw);
  const Vec4<T>* rspos = reinterpret_cast<const Vec4<T>*>(r + 4);
  for (int e = tid; e < total; e += kThreads) {
    s.spos[e] = rspos[e];
    s.stag[e] = static_cast<uint16_t>(r[o.tag + e]);
  }
  for (int i = tid; i <= n0; i += kThreads) s.rowoff[i] = r[o.rowoff + i];
  const uint16_t* rpre = reinterpret_cast<const uint16_t*>(r + o.pre);
  for (int u = tid; u < n0 * nw; u += kThreads) {
    s.mask[u] = static_cast<uint32_t>(r[o.mask + u]);
    s.pre[u] = rpre[u];
  }
}

template <class T, bool ENERGY>
__global__ void __launch_bounds__(kThreads, kMinBlocks<T>)
generic_reduce_bwd(HalfGeom g, int n_cells, const int* __restrict__ rec,
                   long rec_stride, const int* __restrict__ cell_base,
                   const Vec4<T>* __restrict__ ct,
                   const T* __restrict__ valid,
                   const int* __restrict__ needed, int budget,
                   T* __restrict__ gU, T* __restrict__ gS) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (static_cast<int>(blockIdx.x) >= n_cells) {
    // the tail past the lanes the list needed holds no pair
    const int lo = *needed < budget ? *needed : budget;
    const int blk = static_cast<int>(blockIdx.x) - n_cells;
    const int stride = (static_cast<int>(gridDim.x) - n_cells) * kThreads;
    for (int k = lo + blk * kThreads + tid; k < budget; k += stride) {
      gS[k] = T(0);
      if (ENERGY) gU[k] = T(0);
    }
    return;
  }
  const int c = blockIdx.x;
  const int cap = g.cap;
  const int* r = rec + c * rec_stride;
  const int n0 = r[0], total = r[1], nw = r[2];
  const int drawn = cell_base[c];
  if (drawn < 0) {
    // a cell that did not fit: zero the part of its segment in the list
    const long b = -1L - drawn;
    const long end = b + r[rec_offsets<T>(n0, total, nw).rowoff + n0];
    const long hi = end < budget ? end : static_cast<long>(budget);
    for (long k = b + tid; k < hi; k += kThreads) {
      gS[k] = T(0);
      if (ENERGY) gU[k] = T(0);
    }
    return;
  }
  RSmem<T> s;
  reduce_layout(cap, htf::dynamic_smem<char>(), &s);
  read_record(r, n0, total, nw, s);
  __syncthreads();
  const size_t cell0 = static_cast<size_t>(c) * cap;
  // a warp per home row, its lanes written densely (lane e of the row at
  // list index row + e)
  for (int i = warp; i < n0; i += kWarps) {
    const Vec4<T> q = s.spos[i];
    const size_t si = cell0 + s.stag[i];  // block 0: tag = rank
    const T vi = valid[si];
    const Vec4<T> ci = ct[si];
    const T rx = T(2) * (ci.x * vi), ry = T(2) * (ci.y * vi),
            rz = T(2) * (ci.z * vi), re = T(0.5) * (ci.w * vi);
    const int row = drawn + s.rowoff[i];
    const int cnt = s.rowoff[i + 1] - s.rowoff[i];
    for (int e = lane; e < cnt; e += 32) {
      const int j = lane_candidate(s.mask + i * nw, s.pre + i * nw, nw, e);
      T dx, dy, dz;
      lane_d(q, s.spos[j], dx, dy, dz);
      T wx = rx, wy = ry, wz = rz, we = re;
      if (j >= n0) {
        // a directed block's candidate: its back sum goes to its own slot
        const int tag = s.stag[j];
        const int t = tag / cap;
        const size_t sj =
            static_cast<size_t>(htf::shifted_cell(g, c, t, 1)) * cap +
            (tag - t * cap);
        const T vj = valid[sj];
        const Vec4<T> cj = ct[sj];
        wx = wx - T(2) * (cj.x * vj);
        wy = wy - T(2) * (cj.y * vj);
        wz = wz - T(2) * (cj.z * vj);
        we = we + T(0.5) * (cj.w * vj);
      }
      gS[row + e] = dx * wx + dy * wy + dz * wz;
      if (ENERGY) gU[row + e] = we;
    }
  }
}

int allow_smem(const void* kernel, long smem) {
  if (smem <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem)));
}

template <class T>
long reduce_smem_bytes(int cap) {
  RSmem<T> s;
  return reduce_layout(cap, nullptr, &s);
}

template <class T>
int list(const HalfGeom* geom, int n_cells, const void* pos,
         const int* types, const void* valid, const void* box,
         const void* rcm, int rcm_t, double rc2, double min_r2, int budget,
         int* counter, int* cell_base, void* r2, void* ti, void* tj,
         int* rec, void* sums, int nch, cudaStream_t st) {
  const HalfGeom g = *geom;
  const long smem = smem_bytes<T>(g.cap);
  auto kernel = generic_list<T>;
  int e = allow_smem(reinterpret_cast<const void*>(kernel), smem);
  if (e != 0) return e;
  kernel<<<n_cells, kThreads, smem, st>>>(
      static_cast<const T*>(pos), types, static_cast<const T*>(valid),
      static_cast<const T*>(box), g, static_cast<const T*>(rcm), rcm_t,
      static_cast<T>(rc2), static_cast<T>(min_r2), budget, counter,
      cell_base, static_cast<T*>(r2), static_cast<T*>(ti),
      static_cast<T*>(tj), rec, rec_words<T>(g.cap), static_cast<T*>(sums),
      nch);
  return static_cast<int>(cudaGetLastError());
}

template <class T, bool ENERGY, bool VIRIAL>
int launch_reduce(const HalfGeom& g, int n_cells, const int* rec,
                  const int* cell_base, const T* U, const T* S, T* sums,
                  const T* valid, T* forces4, T* virial, int* counter,
                  int* needed, cudaStream_t stream) {
  const long smem = reduce_smem_bytes<T>(g.cap);
  auto kernel = generic_reduce<T, ENERGY, VIRIAL>;
  int e = allow_smem(reinterpret_cast<const void*>(kernel), smem);
  if (e != 0) return e;
  kernel<<<n_cells, kThreads, smem, stream>>>(g, rec, rec_words<T>(g.cap),
                                              cell_base, U, S, sums, counter,
                                              needed);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_slots = n_cells * g.cap;
  half_stencil_home<T, ENERGY, VIRIAL>
      <<<(n_slots + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
          sums, valid, g, n_slots, reinterpret_cast<Vec4<T>*>(forces4),
          virial);
  return static_cast<int>(cudaGetLastError());
}

template <class T>
int reduce(const HalfGeom* geom, int n_cells, const int* rec,
           const int* cell_base, const void* U_, const void* S_,
           int needs_energy, int needs_virial, const void* valid_,
           void* sums_, void* forces4_, void* virial_, int* counter,
           int* needed, cudaStream_t st) {
  const HalfGeom g = *geom;
  const T* U = static_cast<const T*>(U_);
  const T* S = static_cast<const T*>(S_);
  const T* valid = static_cast<const T*>(valid_);
  T* sums = static_cast<T*>(sums_);
  T* forces4 = static_cast<T*>(forces4_);
  T* virial = static_cast<T*>(virial_);
#define HTF_REDUCE(E, V)                                                   \
  launch_reduce<T, E, V>(g, n_cells, rec, cell_base, U, S, sums, valid,    \
                         forces4, virial, counter, needed, st)
  if (needs_energy && needs_virial) return HTF_REDUCE(true, true);
  if (needs_energy) return HTF_REDUCE(true, false);
  if (needs_virial) return HTF_REDUCE(false, true);
  return HTF_REDUCE(false, false);
#undef HTF_REDUCE
}

template <class T>
int reduce_bwd(const HalfGeom* geom, int n_cells, const int* rec,
               const int* cell_base, const void* ct, const void* valid,
               int needs_energy, const int* needed, int budget, void* gU,
               void* gS, cudaStream_t st) {
  const HalfGeom g = *geom;
  const long smem = reduce_smem_bytes<T>(g.cap);
  auto kernel = needs_energy ? generic_reduce_bwd<T, true>
                             : generic_reduce_bwd<T, false>;
  int e = allow_smem(reinterpret_cast<const void*>(kernel), smem);
  if (e != 0) return e;
  kernel<<<n_cells + kTailBlocks, kThreads, smem, st>>>(
      g, n_cells, rec, rec_words<T>(g.cap), cell_base,
      static_cast<const Vec4<T>*>(ct), static_cast<const T*>(valid), needed,
      budget, static_cast<T*>(gU), static_cast<T*>(gS));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Shared-memory bytes one block of the list kernel and of the reduction
// needs at capacity `cap` (the wrapper checks the limit); the 4-byte words
// of a cell's record (the wrapper allocates n_cells of them). `f64` picks
// the double instantiation (0: float).
long htf_generic_smem(int f64, int cap) {
  return f64 ? smem_bytes<double>(cap) : smem_bytes<float>(cap);
}
long htf_generic_reduce_smem(int f64, int cap) {
  return f64 ? reduce_smem_bytes<double>(cap) : reduce_smem_bytes<float>(cap);
}
long htf_generic_record_words(int f64, int cap) {
  return f64 ? rec_words<double>(cap) : rec_words<float>(cap);
}

// The lane list. `f64` picks the scalar type of every floating array:
// float32 (0) or float64 (1). `pos` [n_slots][3], `types` [n_slots] int32
// (or null when untyped), `valid` [n_slots], `box` the [3][3] box (rows
// low, high, tilt) on the card, `geom` a host HalfGeom, `rcm` the
// [rcm_t][rcm_t] squared cutoffs (or null), `counter` a zeroed device int,
// `cell_base` [n_cells] int32, `r2`, `ti`, `tj` [budget], `rec` the cells'
// records (n_cells * htf_generic_record_words int32), `sums` the
// reduction's [nch][14][n_slots] scratch (the list kernel writes the zero
// back sums of the slots the box test left out); rc2 and min_r2 are
// rounded to the scalar type. Returns cudaGetLastError() after the launch
// (0 = ok).
int htf_generic_list(int f64, const void* pos, const int* types,
                     const void* valid, const void* box,
                     const HalfGeom* geom, int n_cells, const void* rcm,
                     int rcm_t, double rc2, double min_r2, int budget,
                     int* counter, int* cell_base, void* r2, void* ti,
                     void* tj, int* rec, void* sums, int nch, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return f64 ? list<double>(geom, n_cells, pos, types, valid, box, rcm,
                            rcm_t, rc2, min_r2, budget, counter, cell_base,
                            r2, ti, tj, rec, sums, nch, st)
             : list<float>(geom, n_cells, pos, types, valid, box, rcm,
                           rcm_t, rc2, min_r2, budget, counter, cell_base,
                           r2, ti, tj, rec, sums, nch, st);
}

// The reduction and the finish: `rec` the list kernel's records, `U`, `S`
// [budget] the pair function's values on the list, `valid` [n_slots],
// `sums` the [n_ch][14][n_slots] scratch, `forces4` [n_slots][4],
// `virial` [n_slots][9] (or null), all of the scalar type `f64` picks;
// `needed` a device int that receives the lanes the list needed. Launches
// generic_reduce and half_stencil_home on `stream`.
int htf_generic_reduce(int f64, const HalfGeom* geom, int n_cells,
                       const int* rec, const int* cell_base, const void* U,
                       const void* S, int needs_energy, int needs_virial,
                       const void* valid, void* sums, void* forces4,
                       void* virial, int* counter, int* needed,
                       void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return f64 ? reduce<double>(geom, n_cells, rec, cell_base, U, S,
                              needs_energy, needs_virial, valid, sums,
                              forces4, virial, counter, needed, st)
             : reduce<float>(geom, n_cells, rec, cell_base, U, S,
                             needs_energy, needs_virial, valid, sums,
                             forces4, virial, counter, needed, st);
}

// The reduction's backward: `rec`, `cell_base` and `needed` those of the
// forward call (the list kernel's records and cell bases, the lanes it
// needed), `ct` [n_slots][4] the cotangent of forces4, `valid` [n_slots],
// `gU` (or null when !needs_energy) and `gS` [budget] the cotangents of
// the pair function's U and s on the list, every lane written; floating
// arrays of the scalar type `f64` picks. Returns cudaGetLastError() after
// the launch (0 = ok).
int htf_generic_reduce_bwd(int f64, const HalfGeom* geom, int n_cells,
                           const int* rec, const int* cell_base,
                           const void* ct, const void* valid,
                           int needs_energy, const int* needed, int budget,
                           void* gU, void* gS, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return f64 ? reduce_bwd<double>(geom, n_cells, rec, cell_base, ct, valid,
                                  needs_energy, needed, budget, gU, gS, st)
             : reduce_bwd<float>(geom, n_cells, rec, cell_base, ct, valid,
                                 needs_energy, needed, budget, gU, gS, st);
}

const char* htf_generic_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
