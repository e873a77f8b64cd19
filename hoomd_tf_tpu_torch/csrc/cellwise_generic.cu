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

constexpr unsigned kFull = 0xffffffffu;
// blocks of 256 threads an SM both kernels are built for (40 registers)
constexpr int kMinBlocks = 6;

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

// The list kernel's shared memory: the staged arrays, the staging's
// scratch, then the lane masks.
struct Smem {
  float4* spos;    // [C] staged entries
  int* stag;       // [C] their tags
  int* sints;      // [kStageInts] the staging's scratch
  int* rowoff;     // [cap + 1] each row's first lane in the cell's segment
  int* scratch;    // [2]
  uint32_t* mask;  // [cap][W] in-cut bits, candidate j = 32 w + bit
  uint16_t* pre;   // [cap][W] the row's in-cut lanes before word w
  int W;
};

__host__ __device__ inline long list_layout(int cap, char* base, Smem* s) {
  const long C = static_cast<long>(kHalf) * cap;
  s->W = static_cast<int>((C + 31) / 32);
  long off = 0;
  auto take = [&](long bytes) {
    const long at = off;
    off += (bytes + 15) & ~15L;
    return base ? base + at : nullptr;
  };
  s->spos = reinterpret_cast<float4*>(take(16 * C));
  s->stag = reinterpret_cast<int*>(take(4 * C));
  s->sints = reinterpret_cast<int*>(take(4L * kStageInts));
  s->rowoff = reinterpret_cast<int*>(take(4L * (cap + 1)));
  s->scratch = reinterpret_cast<int*>(take(4L * 2));
  s->mask = reinterpret_cast<uint32_t*>(take(4L * cap * s->W));
  s->pre = reinterpret_cast<uint16_t*>(take(2L * cap * s->W));
  return off;
}

long smem_bytes(int cap) {
  Smem s;
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
__device__ void mark_lanes(int n0, int total, const float* __restrict__ rcm,
                           int rcm_t, float rc2, const Smem& s) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nw = (total + 31) / 32;
  for (int w = warp; w < nw; w += kWarps) {
    const int j = w * 32 + lane;
    const float4 g = s.spos[j < total ? j : total - 1];
    for (int i = 0; i < n0; ++i) {
      const float4 q = s.spos[i];
      bool ok = false;
      if (j < total && j != i) {
        float dx, dy, dz, d2;
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
__device__ __forceinline__ void lane_d(float4 q, float4 g, float& dx,
                                       float& dy, float& dz) {
  dx = g.x - q.x;
  dy = g.y - q.y;
  dz = g.z - q.z;
}

__host__ __device__ __forceinline__ long pad4(long n) {
  return (n + 3) & ~3L;
}

// The list kernel's record of a cell, handed to the reduction through
// device memory: 4-byte words from the cell's start, rec_words(cap)
// apart. Words 0-2 hold n0, total and nw (the candidates' mask words);
// then the staged entries (4 words each, from word 4), their tags (a word
// each), rowoff [n0 + 1], the masks [n0][nw] and the rows' running counts
// [n0][nw] (16-bit halves).
struct Rec {
  long tag, rowoff, mask, pre;
};

__host__ __device__ __forceinline__ Rec rec_offsets(int n0, int total,
                                                    int nw) {
  Rec r;
  r.tag = 4 + 4L * total;
  r.rowoff = r.tag + total;
  r.mask = r.rowoff + n0 + 1;
  r.pre = r.mask + static_cast<long>(n0) * nw;
  return r;
}

long rec_words(int cap) {
  const int C = kHalf * cap, W = (C + 31) / 32;
  const Rec r = rec_offsets(cap, C, W);
  return pad4(r.pre + (static_cast<long>(cap) * W + 1) / 2);
}

// Write the staged cell (s) into its record (every thread; no barrier).
__device__ void write_record(const Smem& s, int n0, int total,
                             int* __restrict__ rec) {
  const int tid = threadIdx.x;
  const int nw = (total + 31) / 32;
  const Rec o = rec_offsets(n0, total, nw);
  if (tid == 0) {
    rec[0] = n0;
    rec[1] = total;
    rec[2] = nw;
  }
  float4* spos = reinterpret_cast<float4*>(rec + 4);
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

__global__ void __launch_bounds__(kThreads, kMinBlocks)
generic_list(const float* __restrict__ pos, const int* __restrict__ types,
             const float* __restrict__ valid,
             const float* __restrict__ box, HalfGeom g,
             const float* __restrict__ rcm, int rcm_t, float rc2,
             float min_r2, int budget, int* __restrict__ counter,
             int* __restrict__ cell_base, float* __restrict__ r2_out,
             float* __restrict__ ti_out, float* __restrict__ tj_out,
             int* __restrict__ rec, long rec_stride, float* __restrict__ sums,
             int nch) {
  extern __shared__ float4 smem4[];
  Smem s;
  list_layout(g.cap, reinterpret_cast<char*>(smem4), &s);
  const int c = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t n_slots = static_cast<size_t>(gridDim.x) * g.cap;
  const size_t home = static_cast<size_t>(c) * g.cap;
  int n0;
  const int total = htf::stage_half_stencil(
      g, c, rc2, pos, types, valid, box, s.spos, s.stag, s.sints, n0,
      htf::NoExtra(), [&](int t, int r) {
        // a slot out of every row's reach: its back sums are zero
        for (int k = 0; k < nch; ++k)
          sums[(k * kHalf + t) * n_slots + home + r] = 0.f;
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
    const float4 q = s.spos[i];
    const int row = base + s.rowoff[i];
    const int cnt = s.rowoff[i + 1] - s.rowoff[i];
    for (int e = lane; e < cnt; e += 32) {
      const float4 gj =
          s.spos[lane_candidate(s.mask + i * s.W, s.pre + i * s.W, nw, e)];
      float dx, dy, dz;
      lane_d(q, gj, dx, dy, dz);
      const float d2 = dx * dx + dy * dy + dz * dz;
      r2_out[row + e] = fmaxf(d2, min_r2);
      ti_out[row + e] = static_cast<float>(__float_as_int(q.w));
      tj_out[row + e] = static_cast<float>(__float_as_int(gj.w));
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

// The reduction's shared memory: a cell's record, unpacked.
struct RSmem {
  float4* spos;     // [C]
  uint16_t* stag;   // [C]
  int* rowoff;      // [cap + 1]
  uint32_t* mask;   // [cap * W], row stride nw of the cell
  uint16_t* pre;    // [cap * W]
};

__host__ __device__ inline long reduce_layout(int cap, char* base,
                                              RSmem* s) {
  const long C = static_cast<long>(kHalf) * cap, W = (C + 31) / 32;
  long off = 0;
  auto take = [&](long bytes) {
    const long at = off;
    off += (bytes + 15) & ~15L;
    return base ? base + at : nullptr;
  };
  s->spos = reinterpret_cast<float4*>(take(16 * C));
  s->stag = reinterpret_cast<uint16_t*>(take(2 * C));
  s->rowoff = reinterpret_cast<int*>(take(4L * (cap + 1)));
  s->mask = reinterpret_cast<uint32_t*>(take(4 * cap * W));
  s->pre = reinterpret_cast<uint16_t*>(take(2 * cap * W));
  return off;
}

template <bool ENERGY, bool VIRIAL>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
generic_reduce(HalfGeom g, const int* __restrict__ rec,
               long rec_stride, const int* __restrict__ cell_base,
               const float* __restrict__ U, const float* __restrict__ S,
               float* __restrict__ sums, int* __restrict__ counter,
               int* __restrict__ needed) {
  constexpr int NCH = Channels<ENERGY, VIRIAL>::kCount;
  extern __shared__ float4 smem4[];
  RSmem s;
  reduce_layout(g.cap, reinterpret_cast<char*>(smem4), &s);
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
  const Rec o = rec_offsets(n0, total, nw);
  const float4* rspos = reinterpret_cast<const float4*>(r + 4);
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
    float acc[NCH];
#pragma unroll
    for (int k = 0; k < NCH; ++k) acc[k] = 0.f;
    const float4 q = s.spos[i];
    const int row = base + s.rowoff[i];
    const int cnt = base >= 0 ? s.rowoff[i + 1] - s.rowoff[i] : 0;
    for (int e = lane; e < cnt; e += 32) {
      float dx, dy, dz;
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
    float acc[NCH];
#pragma unroll
    for (int k = 0; k < NCH; ++k) acc[k] = 0.f;
    const float4 gj = s.spos[j];
    const int w = j >> 5;
    const unsigned bit = 1u << (j & 31);
    for (int i0 = 0; base >= 0 && i0 < n0; i0 += kBatch) {
      float u[kBatch], sl[kBatch];
      unsigned in = 0u;
#pragma unroll
      for (int t = 0; t < kBatch; ++t) {
        const int i = i0 + t;
        const unsigned m = i < n0 ? s.mask[i * nw + w] : 0u;
        u[t] = sl[t] = 0.f;
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
          float dx, dy, dz;
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
__device__ __forceinline__ void read_record(const int* __restrict__ r,
                                            int n0, int total, int nw,
                                            const RSmem& s) {
  const int tid = threadIdx.x;
  const Rec o = rec_offsets(n0, total, nw);
  const float4* rspos = reinterpret_cast<const float4*>(r + 4);
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

template <bool ENERGY>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
generic_reduce_bwd(HalfGeom g, int n_cells, const int* __restrict__ rec,
                   long rec_stride, const int* __restrict__ cell_base,
                   const float4* __restrict__ ct,
                   const float* __restrict__ valid,
                   const int* __restrict__ needed, int budget,
                   float* __restrict__ gU, float* __restrict__ gS) {
  extern __shared__ float4 smem4[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (static_cast<int>(blockIdx.x) >= n_cells) {
    // the tail past the lanes the list needed holds no pair
    const int lo = *needed < budget ? *needed : budget;
    const int blk = static_cast<int>(blockIdx.x) - n_cells;
    const int stride = (static_cast<int>(gridDim.x) - n_cells) * kThreads;
    for (int k = lo + blk * kThreads + tid; k < budget; k += stride) {
      gS[k] = 0.f;
      if (ENERGY) gU[k] = 0.f;
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
    const long end = b + r[rec_offsets(n0, total, nw).rowoff + n0];
    const long hi = end < budget ? end : static_cast<long>(budget);
    for (long k = b + tid; k < hi; k += kThreads) {
      gS[k] = 0.f;
      if (ENERGY) gU[k] = 0.f;
    }
    return;
  }
  RSmem s;
  reduce_layout(cap, reinterpret_cast<char*>(smem4), &s);
  read_record(r, n0, total, nw, s);
  __syncthreads();
  const size_t cell0 = static_cast<size_t>(c) * cap;
  // a warp per home row, its lanes written densely (lane e of the row at
  // list index row + e)
  for (int i = warp; i < n0; i += kWarps) {
    const float4 q = s.spos[i];
    const size_t si = cell0 + s.stag[i];  // block 0: tag = rank
    const float vi = valid[si];
    const float4 ci = ct[si];
    const float rx = 2.f * (ci.x * vi), ry = 2.f * (ci.y * vi),
                rz = 2.f * (ci.z * vi), re = 0.5f * (ci.w * vi);
    const int row = drawn + s.rowoff[i];
    const int cnt = s.rowoff[i + 1] - s.rowoff[i];
    for (int e = lane; e < cnt; e += 32) {
      const int j = lane_candidate(s.mask + i * nw, s.pre + i * nw, nw, e);
      float dx, dy, dz;
      lane_d(q, s.spos[j], dx, dy, dz);
      float wx = rx, wy = ry, wz = rz, we = re;
      if (j >= n0) {
        // a directed block's candidate: its back sum goes to its own slot
        const int tag = s.stag[j];
        const int t = tag / cap;
        const size_t sj =
            static_cast<size_t>(htf::shifted_cell(g, c, t, 1)) * cap +
            (tag - t * cap);
        const float vj = valid[sj];
        const float4 cj = ct[sj];
        wx = wx - 2.f * (cj.x * vj);
        wy = wy - 2.f * (cj.y * vj);
        wz = wz - 2.f * (cj.z * vj);
        we = we + 0.5f * (cj.w * vj);
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

long reduce_smem_bytes(int cap) {
  RSmem s;
  return reduce_layout(cap, nullptr, &s);
}

template <bool ENERGY, bool VIRIAL>
int launch_reduce(const HalfGeom& g, int n_cells, const int* rec,
                  const int* cell_base, const float* U, const float* S,
                  float* sums, const float* valid, float* forces4,
                  float* virial, int* counter, int* needed,
                  cudaStream_t stream) {
  const long smem = reduce_smem_bytes(g.cap);
  auto kernel = generic_reduce<ENERGY, VIRIAL>;
  int e = allow_smem(reinterpret_cast<const void*>(kernel), smem);
  if (e != 0) return e;
  kernel<<<n_cells, kThreads, smem, stream>>>(g, rec, rec_words(g.cap),
                                              cell_base, U, S, sums, counter,
                                              needed);
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

// Shared-memory bytes one block of the list kernel and of the reduction
// needs at capacity `cap` (the wrapper checks the limit); the 4-byte words
// of a cell's record (the wrapper allocates n_cells of them).
long htf_generic_smem(int cap) { return smem_bytes(cap); }
long htf_generic_reduce_smem(int cap) { return reduce_smem_bytes(cap); }
long htf_generic_record_words(int cap) { return rec_words(cap); }

// The lane list: `pos` [n_slots][3], `types` [n_slots] int32 (or null when
// untyped), `valid` [n_slots], `box` the [3][3] box (rows low, high,
// tilt) on the card, `geom` a host
// HalfGeom, `rcm` the [rcm_t][rcm_t] squared cutoffs (or null), `counter`
// a zeroed device int, `cell_base` [n_cells] int32, `r2`, `ti`, `tj`
// [budget] float32, `rec` the cells' records (n_cells *
// htf_generic_record_words int32), `sums` the reduction's
// [nch][14][n_slots] scratch (the list kernel writes the zero back sums of
// the slots the box test left out). Returns cudaGetLastError() after the
// launch (0 = ok).
int htf_generic_list(const float* pos, const int* types, const float* valid,
                     const float* box, const HalfGeom* geom, int n_cells,
                     const float* rcm, int rcm_t, float rc2, float min_r2,
                     int budget, int* counter, int* cell_base, float* r2,
                     float* ti, float* tj, int* rec, float* sums, int nch,
                     void* stream) {
  const HalfGeom g = *geom;
  const long smem = smem_bytes(g.cap);
  int e = allow_smem(reinterpret_cast<const void*>(generic_list), smem);
  if (e != 0) return e;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  generic_list<<<n_cells, kThreads, smem, st>>>(
      pos, types, valid, box, g, rcm, rcm_t, rc2, min_r2, budget, counter,
      cell_base, r2, ti, tj, rec, rec_words(g.cap), sums, nch);
  return static_cast<int>(cudaGetLastError());
}

// The reduction and the finish: `rec` the list kernel's records, `U`, `S`
// [budget] float32 the pair function's values on the list, `valid`
// [n_slots], `sums` the [n_ch][14][n_slots] scratch, `forces4`
// [n_slots][4], `virial` [n_slots][9] (or null), `needed` a device int
// that receives the lanes the list needed. Launches generic_reduce and
// half_stencil_home on `stream`.
int htf_generic_reduce(const HalfGeom* geom, int n_cells, const int* rec,
                       const int* cell_base, const float* U, const float* S,
                       int needs_energy, int needs_virial, const float* valid,
                       float* sums, float* forces4, float* virial,
                       int* counter, int* needed, void* stream) {
  const HalfGeom g = *geom;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (needs_energy && needs_virial)
    return launch_reduce<true, true>(g, n_cells, rec, cell_base, U, S, sums,
                                     valid, forces4, virial, counter, needed,
                                     st);
  if (needs_energy)
    return launch_reduce<true, false>(g, n_cells, rec, cell_base, U, S, sums,
                                      valid, forces4, virial, counter, needed,
                                      st);
  if (needs_virial)
    return launch_reduce<false, true>(g, n_cells, rec, cell_base, U, S, sums,
                                      valid, forces4, virial, counter, needed,
                                      st);
  return launch_reduce<false, false>(g, n_cells, rec, cell_base, U, S, sums,
                                     valid, forces4, virial, counter, needed,
                                     st);
}

// The reduction's backward: `rec`, `cell_base` and `needed` those of the
// forward call (the list kernel's records and cell bases, the lanes it
// needed), `ct` [n_slots][4] float32 the cotangent of forces4, `valid`
// [n_slots], `gU` (or null when !needs_energy) and `gS` [budget] float32
// the cotangents of the pair function's U and s on the list, every lane
// written. Returns cudaGetLastError() after the launch (0 = ok).
int htf_generic_reduce_bwd(const HalfGeom* geom, int n_cells, const int* rec,
                           const int* cell_base, const float* ct,
                           const float* valid, int needs_energy,
                           const int* needed, int budget, float* gU,
                           float* gS, void* stream) {
  const HalfGeom g = *geom;
  const long smem = reduce_smem_bytes(g.cap);
  auto kernel = needs_energy ? generic_reduce_bwd<true>
                             : generic_reduce_bwd<false>;
  int e = allow_smem(reinterpret_cast<const void*>(kernel), smem);
  if (e != 0) return e;
  kernel<<<n_cells + kTailBlocks, kThreads, smem,
           static_cast<cudaStream_t>(stream)>>>(
      g, n_cells, rec, rec_words(g.cap), cell_base,
      reinterpret_cast<const float4*>(ct), valid, needed, budget, gU, gS);
  return static_cast<int>(cudaGetLastError());
}

const char* htf_generic_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
