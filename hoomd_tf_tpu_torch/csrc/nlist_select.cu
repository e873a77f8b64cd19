// Cell-list neighbor selection (kernel K3), hand-written for Hopper
// (sm_90a).
//
// Replaces: hoomd_tf_tpu/ops/nlist_pallas.py::_kernel (the Pallas TPU
// kernel behind pallas_cell_select, called from cell_list.py's
// method='pallas'). Same function: for every occupied query slot of the
// cell list and every candidate in the 27 neighbouring cells (periodic),
//   d   = candidate - query, then d - rintf(d / L) * L per axis,
//   d2  = dx*dx + dy*dy + dz*dz (left to right),
//   valid when lo2 <= d2 <= rc2,
//   key = (bits(d2) & ~slot_mask) | j, with j = k*cap + r the candidate
//         slot (k the stencil offset, r the rank in its cell),
// and the NN smallest keys of the row, nearest first, as (dx, dy, dz,
// type), zero past the row's valid count; a particle that holds no slot
// (its cell overflowed) gets a zero row. Keys are unique within a row,
// so the order is total and the result deterministic. The arithmetic is
// IEEE single precision with no contraction (explicit _rn intrinsics; the
// build also passes -fmad=false): the key is built from d2's bits, so one
// ulp could reorder near-ties, and the PyTorch reference must round
// identically.
//
// What bounds it on an H100: by its bound, bytes: the [N, NN, 4] float32
// list (67 MB at N = 65536, NN = 64) is the only large transfer, and the
// slot rows (1 MB occupied at that size) come from L2. In practice,
// instruction issue in the candidate loop: ~300 occupied candidates per
// query, each chunk of 32 a few dozen warp instructions (the
// subtractions, the |d| <= t0 vote, d2, the cuts, the ballot
// compaction), then a counting rank of the ~45 valid keys; the writes
// hide under that work (profile_step.py --mode k3parts times each part).
//
// The design:
//   - one block per strip of S cells along x at one (y, z); the block
//     stages the occupied slots of its (S+2) x 3 x 3 window once, in
//     shared memory, with cp.async (a warp to a cell, every copy in
//     flight at once), ordered column by column (x), then by the 9 (y, z)
//     rows in the stencil's order. A query of strip cell i then finds its
//     27 cells' candidates as ONE contiguous range (columns i..i+2), and
//     the candidate's index f in that range orders candidates exactly as
//     j does (cells in k order, slots in r order within a cell), so the
//     key's low bits hold f: the same order, and no division to map a
//     winner back to its slot. Short strips (the wrapper's launch_shape)
//     keep more blocks, and more warps, on each SM;
//   - the strip's queries are dealt round-robin to the warps, one query
//     per warp at a time; lanes compute keys over 32 candidates at a time
//     and compact the valid ones with ballot/popc into the warp's key
//     buffer; each key's rank is the number of smaller keys (128-bit
//     broadcast reads); the winners' indices land in rank order in shared
//     memory, and the lanes write the whole NN x 16 B row, consecutive
//     lanes on consecutive float4s, zeros past the valid count: the list
//     is written once, coalesced, with no zero fill before the kernel;
//   - the minimum image without a division per pair: s = rint(fl(d/L)) is
//     decided by comparing |d| with float32 thresholds the wrapper rounds
//     inward (|d| <= t0 <= 0.49 L: s = 0; 0.51 L <= t1 <= |d| <= t2 <=
//     1.49 L: s = sign(d)); fl(d - s L) is then the reference's value bit
//     for bit (s L is exact, and s = copysign(0, d) reproduces the sign of
//     a zero). Only a lane in the band between (|d| near L/2, or past
//     1.49 L: the slots hold unwrapped positions) divides, as the
//     reference does. A chunk of 32 candidates with every |d| <= t0 (a
//     warp vote) takes d itself: s = +-0 changes no d2;
//   - block 0 zeroes the rows of particles that hold no slot, and only
//     when the counts show some (sum of counts < n): it marks the held
//     particles in shared memory from pid, no atomics.
//
// The group mode (the z-slab shards of a device mesh that one card holds,
// ops/cell_list.py::CellNlist.sharded): the launch covers only the
// strips of the group's home layers, given as runs of consecutive layers
// (params->run_z0, run_nzl; a card may hold shards that are not
// adjacent). Blocks take the strips layer by layer, run after run, so a
// block's layer is found by walking the few runs. Two tables:
//   - in place (params->joined = 0), on the card that binned the
//     particles: slots and counts are the whole cell table, the window
//     wraps in z, each held query writes its row by pid into the
//     particle-order list, and block 0 zeroes the rows of particles that
//     hold no slot, whichever layers the group holds. The unsharded call
//     is this mode with one run of every layer;
//   - joined (params->joined = 1), on any other card: slots and counts
//     are the group's joined buffer, each run's home layers with one halo
//     layer on each side (the 27-cell window reaches z - 1 and z + 1
//     only), the runs' layers given in that buffer, the window taken with
//     no wrap; a query writes its row at its home slot, in the order of
//     the runs' home layers, [sum nzl nx ny cap, nn, 4], and a row of an
//     empty slot is not written (the binning card scatters the rows in by
//     pid). pid is not read and there is no block 0.
// Either way the window's cells, their order and counts are the unsharded
// window's, so every row equals the unsharded kernel's row of its
// particle bit for bit.
//
// The kernel is a template on the scalar type T (scalar.cuh), built for
// float and for double. In double the slots, the list and the arithmetic
// are double (d - rint(d / L) L with __ddiv_rn, __dmul_rn, __dsub_rn), the
// thresholds are doubles rounded inward the same way, and the key is the
// 64-bit pattern of d2 with the same low slot bits cleared and OR-ed with
// f (d2 >= 0, so unsigned order is value order), ranked by counting on
// 64-bit keys. Its shared memory holds 32-byte slots and 8-byte keys
// (smem_bytes with the element sizes; ops/nlist_cuda.py repeats it).

#include <cuda_runtime.h>
#include <stdint.h>

#include "scalar.cuh"

// Launch parameters, made once per plan by the wrapper
// (ops/nlist_cuda.py::K3Params mirrors this layout). The lengths, cuts and
// thresholds are doubles here, exact for a float32 plan; the launch
// rounds them to the kernel's scalar type (KParams). Outside the anonymous
// namespace: the C entry point takes it and must stay external.
// The runs of home layers a launch covers: at most kMaxRuns, each a layer
// of the table (z0) and a count (nzl).
constexpr int kMaxRuns = 16;

struct K3Params {
  int nx, ny, nz, cap, nn;
  int strip, warps, n_strips, smem, f64, joined, n_runs;
  int run_z0[kMaxRuns], run_nzl[kMaxRuns];
  unsigned slot_mask;
  double rc2, lo2;
  double L[3], t0[3], t1[3], t2[3];
};

namespace {

using htf::Vec4;

constexpr int kMaxWarps = 8;
constexpr int kSmemLimit = 232448;  // dynamic shared memory per block

// The kernel's copy of the parameters, in its scalar type (a
// __grid_constant__ parameter: the run tables are indexed at run time and
// read in place).
template <class T>
struct KParams {
  int nx, ny, nz, cap, nn, strip, warps, n_strips, smem, joined, n_runs;
  int run_z0[kMaxRuns], run_nzl[kMaxRuns];
  unsigned slot_mask;
  T rc2, lo2;
  T L[3], t0[3], t1[3], t2[3];
};

// The key of a candidate: the bits of d2 (32 in float, 64 in double).
template <class T>
struct KeyOf;
template <>
struct KeyOf<float> {
  using type = unsigned;
  static __device__ __forceinline__ unsigned bits(float d2) {
    return __float_as_uint(d2);
  }
};
template <>
struct KeyOf<double> {
  using type = unsigned long long;
  static __device__ __forceinline__ unsigned long long bits(double d2) {
    return static_cast<unsigned long long>(__double_as_longlong(d2));
  }
};

// Keys a warp's buffer holds: every candidate of a query may be valid.
__host__ __device__ inline int key_buffer(int cap) {
  return (27 * cap + 3) & ~3;  // whole 16-byte groups of 32-bit keys
}

// Shared memory of a block (ops/nlist_cuda.py::smem_bytes repeats it);
// `slot_bytes` 16 (float) or 32 (double), `key_bytes` 4 or 8.
int smem_bytes(int cap, int nn, int strip, int warps, int slot_bytes,
               int key_bytes) {
  const int nw = (strip + 2) * 9;
  return slot_bytes * nw * cap                    // staged window slots
         + key_bytes * warps * key_buffer(cap)    // per-warp key buffers
         + 4 * warps * nn                         // per-warp winners
         + 4 * (nw + 1) + 4 * nw                  // window prefix, cell ids
         + 4 * (strip + 1);                       // strip query prefix
}

constexpr unsigned kFull = 0xffffffffu;

// The minimum image d - s L with s = rint(fl(d / L)): s is +-0 or +-1
// from the thresholds, the IEEE division only where they cannot decide.
template <class T>
__device__ __forceinline__ T min_image(T d, T L, T t0, T t1, T t2) {
  const T a = htf::fabs_(d);
  const bool near = a <= t0;
  T s = htf::copysign_(near ? T(0) : T(1), d);
  if (!near && !(a >= t1 && a <= t2)) s = htf::rint_(htf::div_rn(d, L));
  return htf::sub_rn(d, htf::mul_rn(s, L));
}

template <class T>
__device__ __forceinline__ Vec4<T> displacement(const KParams<T>& p,
                                                Vec4<T> g, Vec4<T> q) {
  return htf::vec4(
      min_image(htf::sub_rn(g.x, q.x), p.L[0], p.t0[0], p.t1[0], p.t2[0]),
      min_image(htf::sub_rn(g.y, q.y), p.L[1], p.t0[1], p.t1[1], p.t2[1]),
      min_image(htf::sub_rn(g.z, q.z), p.L[2], p.t0[2], p.t1[2], p.t2[2]),
      g.w);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}

// A list entry, written once and not read again (streaming stores).
__device__ __forceinline__ void store_row(Vec4<float>* p, Vec4<float> v) {
  __stcs(reinterpret_cast<float4*>(p), make_float4(v.x, v.y, v.z, v.w));
}
__device__ __forceinline__ void store_row(Vec4<double>* p, Vec4<double> v) {
  double2* q = reinterpret_cast<double2*>(p);
  __stcs(q, make_double2(v.x, v.y));
  __stcs(q + 1, make_double2(v.z, v.w));
}

// The number of keys in wk[0 .. n4) (n4 a multiple of 4) below k0 and
// below k1, read 16 bytes at a time.
__device__ __forceinline__ void count_below(const unsigned* wk, int n4,
                                            unsigned k0, unsigned k1,
                                            int& r0, int& r1) {
  const uint4* w4 = reinterpret_cast<const uint4*>(wk);
  for (int m = 0; m < n4 / 4; ++m) {
    const uint4 v = w4[m];
    r0 += (v.x < k0) + (v.y < k0) + (v.z < k0) + (v.w < k0);
    r1 += (v.x < k1) + (v.y < k1) + (v.z < k1) + (v.w < k1);
  }
}
__device__ __forceinline__ void count_below(const unsigned long long* wk,
                                            int n4, unsigned long long k0,
                                            unsigned long long k1, int& r0,
                                            int& r1) {
  const ulonglong2* w2 = reinterpret_cast<const ulonglong2*>(wk);
  for (int m = 0; m < n4 / 2; ++m) {
    const ulonglong2 v = w2[m];
    r0 += (v.x < k0) + (v.y < k0);
    r1 += (v.x < k1) + (v.y < k1);
  }
}

// Block 0: zero the rows of the particles that hold no slot.
template <class T>
__device__ __forceinline__ void zero_unheld_rows(const KParams<T>& p,
                                                 const int* counts,
                                                 const int* pid, int n,
                                                 Vec4<T>* out,
                                                 unsigned char* flags) {
  __shared__ int part[kMaxWarps];
  const int n_cells = p.nx * p.ny * p.nz;
  int held = 0;
  for (int c = threadIdx.x; c < n_cells; c += blockDim.x) held += counts[c];
  for (int o = 16; o > 0; o >>= 1) held += __shfl_xor_sync(kFull, held, o);
  if (threadIdx.x % 32 == 0) part[threadIdx.x / 32] = held;
  __syncthreads();
  held = 0;
  for (int w = 0; w < static_cast<int>(blockDim.x) / 32; ++w)
    held += part[w];
  if (held >= n) return;  // uniform: every particle holds a slot
  const int F = p.smem & ~3;
  const int n_slots = n_cells * p.cap;
  const Vec4<T> zero = htf::vec4(T(0), T(0), T(0), T(0));
  for (int p0 = 0; p0 < n; p0 += F) {
    for (int k = threadIdx.x; k < F / 4; k += blockDim.x)
      reinterpret_cast<unsigned*>(flags)[k] = 0u;
    __syncthreads();
    for (int s = threadIdx.x; s < n_slots; s += blockDim.x) {
      const int q = pid[s];
      if (q >= p0 && q - p0 < F) flags[q - p0] = 1;
    }
    __syncthreads();
    const int p1 = min(n, p0 + F);
    for (int q = p0 + static_cast<int>(threadIdx.x); q < p1;
         q += blockDim.x)
      if (!flags[q - p0])
        for (int c = 0; c < p.nn; ++c)
          out[static_cast<size_t>(q) * p.nn + c] = zero;
    __syncthreads();
  }
}

template <class T>
__global__ void __launch_bounds__(kMaxWarps * 32, 2)
nlist_select_kernel(const __grid_constant__ KParams<T> p,
                    const Vec4<T>* __restrict__ slots,
                    const int* __restrict__ counts,
                    const int* __restrict__ pid, int n,
                    Vec4<T>* __restrict__ out) {
  using K = typename KeyOf<T>::type;
  constexpr K kFar = ~K(0);
  unsigned char* smem = htf::dynamic_smem<unsigned char>();
  if (!p.joined && blockIdx.x == 0) {
    zero_unheld_rows(p, counts, pid, n, out, smem);
    return;
  }
  const int nwmax = (p.strip + 2) * 9;
  const int kbuf = key_buffer(p.cap);
  Vec4<T>* cand = reinterpret_cast<Vec4<T>*>(smem);
  K* keys = reinterpret_cast<K*>(cand + nwmax * p.cap);
  int* winners = reinterpret_cast<int*>(keys + p.warps * kbuf);
  int* start = winners + p.warps * p.nn;  // [nw + 1]
  int* cell = start + nwmax + 1;          // [nw]
  int* qstart = cell + nwmax;             // [S + 1]

  // the joined mode has no block 0; block b's home layer is the h-th of
  // the runs' layers, h counted run after run
  const int b = blockIdx.x - (p.joined ? 0 : 1);
  const int sx = b % p.n_strips;
  const int y0 = (b / p.n_strips) % p.ny;
  const int h = b / (p.n_strips * p.ny);
  int z0 = h, r = 0;
  while (z0 >= p.run_nzl[r]) z0 -= p.run_nzl[r++];
  z0 += p.run_z0[r];
  const int x0 = sx * p.strip;
  const int S = min(p.strip, p.nx - x0);  // the last strip may be ragged
  const int nw = (S + 2) * 9;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  // window cell w = 9 xw + 3 ry + rz: column xw (x0 - 1 + xw), row offset
  // (ry - 1, rz - 1) in y and z, so that strip cell i's stencil offset k
  // is w - 9 i
  for (int w = threadIdx.x; w < nw; w += blockDim.x) {
    const int xw = w / 9, row = w - 9 * xw;
    const int ry = row / 3, rz = row - 3 * ry;
    const int x = (x0 - 1 + xw + p.nx) % p.nx;
    const int y = (y0 - 1 + ry + p.ny) % p.ny;
    // a joined buffer's window lies inside its run's layers: no wrap in z
    const int z = p.joined ? z0 - 1 + rz : (z0 - 1 + rz + p.nz) % p.nz;
    const int c = x + p.nx * (y + p.ny * z);
    cell[w] = c;
    start[w + 1] = counts[c];
  }
  __syncthreads();
  if (warp == 0) {
    // exclusive prefix of the window's counts, then of the strip's queries
    int carry = 0;
    for (int base = 0; base < nw; base += 32) {
      const int w = base + lane;
      const int v = w < nw ? start[w + 1] : 0;
      int incl = v;
      for (int o = 1; o < 32; o <<= 1) {
        const int u = __shfl_up_sync(kFull, incl, o);
        if (lane >= o) incl += u;
      }
      __syncwarp();
      if (w < nw) start[w] = carry + incl - v;
      carry += __shfl_sync(kFull, incl, 31);
    }
    if (lane == 0) start[nw] = carry;
    __syncwarp();
    carry = 0;
    for (int base = 0; base < S; base += 32) {
      const int i = base + lane;
      const int wq = 9 * (i + 1) + 4;
      const int v = i < S ? start[wq + 1] - start[wq] : 0;
      int incl = v;
      for (int o = 1; o < 32; o <<= 1) {
        const int u = __shfl_up_sync(kFull, incl, o);
        if (lane >= o) incl += u;
      }
      if (i < S) qstart[i] = carry + incl - v;
      carry += __shfl_sync(kFull, incl, 31);
    }
    if (lane == 0) qstart[S] = carry;
  }
  __syncthreads();

  // stage the occupied slots (a prefix of each cell's) of the window, a
  // warp to a cell, every 16-byte copy in flight at once (a slot is one
  // copy in float, two in double)
  constexpr int kParts = sizeof(Vec4<T>) / 16;
  for (int w = warp; w < nw; w += p.warps) {
    const int first = start[w], cnt = start[w + 1] - first;
    const char* src =
        reinterpret_cast<const char*>(slots + static_cast<size_t>(cell[w]) *
                                                  p.cap);
    char* dst = reinterpret_cast<char*>(cand + first);
    for (int u = lane; u < cnt * kParts; u += 32)
      cp_async16(dst + 16 * u, src + 16 * u);
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();

  const int Q = qstart[S];
  K* wk = keys + warp * kbuf;
  int* win = winners + warp * p.nn;
  const K mask = static_cast<K>(p.slot_mask);
  int i = 0;
  for (int t = warp; t < Q; t += p.warps) {
    while (qstart[i + 1] <= t) ++i;
    const int qr = t - qstart[i];
    const int wq = 9 * (i + 1) + 4;
    const Vec4<T> q = cand[start[wq] + qr];
    // the row: the query's particle, or in the joined mode its home slot
    // (its cell moved from layer z0 of the buffer to home layer h)
    const size_t row_id =
        p.joined
            ? static_cast<size_t>(cell[wq] + (h - z0) * p.nx * p.ny) * p.cap +
                  qr
            : static_cast<size_t>(
                  pid[static_cast<size_t>(cell[wq]) * p.cap + qr]);
    const int lo = start[9 * i];
    const int total = start[9 * i + 27] - lo;

    int nv = 0;
    for (int base = 0; base < total; base += 32) {
      const int f = base + lane;
      T dx = T(0), dy = T(0), dz = T(0);
      if (f < total) {  // else d = 0, so d2 = 0 < lo2: never valid
        const Vec4<T> g = cand[lo + f];
        dx = htf::sub_rn(g.x, q.x);
        dy = htf::sub_rn(g.y, q.y);
        dz = htf::sub_rn(g.z, q.z);
      }
      // when every |d| <= t0, every shift is +-0 and d2 is d's own
      const bool far = htf::fabs_(dx) > p.t0[0] ||
                       htf::fabs_(dy) > p.t0[1] || htf::fabs_(dz) > p.t0[2];
      if (__any_sync(kFull, far)) {
        dx = min_image(dx, p.L[0], p.t0[0], p.t1[0], p.t2[0]);
        dy = min_image(dy, p.L[1], p.t0[1], p.t1[1], p.t2[1]);
        dz = min_image(dz, p.L[2], p.t0[2], p.t1[2], p.t2[2]);
      }
      const T d2 = htf::add_rn(
          htf::add_rn(htf::mul_rn(dx, dx), htf::mul_rn(dy, dy)),
          htf::mul_rn(dz, dz));
      const bool ok = d2 <= p.rc2 && d2 >= p.lo2;
      const unsigned hits = __ballot_sync(kFull, ok);
      if (ok)
        wk[nv + __popc(hits & ((1u << lane) - 1u))] =
            (KeyOf<T>::bits(d2) & ~mask) | static_cast<K>(f);
      nv += __popc(hits);
    }
    // pad to whole 16-byte groups with keys larger than any valid one
    const int nv4 = (nv + 3) & ~3;
    if (lane < nv4 - nv) wk[nv + lane] = kFar;
    __syncwarp();

    // rank = number of smaller keys (keys are unique); winners in rank
    // order
    for (int h = lane; h < nv; h += 64) {
      const K k0 = wk[h];
      const bool two = h + 32 < nv;
      const K k1 = two ? wk[h + 32] : kFar;
      int r0 = 0, r1 = 0;
      count_below(wk, nv4, k0, k1, r0, r1);
      if (r0 < p.nn) win[r0] = static_cast<int>(k0 & mask);
      if (two && r1 < p.nn) win[r1] = static_cast<int>(k1 & mask);
    }
    __syncwarp();

    // the whole row, coalesced, zeros past the valid count
    const int nout = min(nv, p.nn);
    Vec4<T>* row = out + row_id * p.nn;
    for (int c = lane; c < p.nn; c += 32) {
      Vec4<T> o = htf::vec4(T(0), T(0), T(0), T(0));
      if (c < nout) o = displacement(p, cand[lo + win[c]], q);
      store_row(row + c, o);
    }
    __syncwarp();  // the next query reuses the warp's buffers
  }
}

// each instantiation's dynamic shared memory cap: 48 KB less its static
// array, since a launch whose static and dynamic bytes together pass 48 KB
// needs the opt-in attribute
int g_smem_attr[2] = {48 * 1024 - static_cast<int>(sizeof(int)) * kMaxWarps,
                      48 * 1024 - static_cast<int>(sizeof(int)) * kMaxWarps};

template <class T>
int launch(const K3Params& p, const void* slots, const int* counts,
           const int* pid, int n, void* out, cudaStream_t stream) {
  KParams<T> k{};
  k.nx = p.nx;
  k.ny = p.ny;
  k.nz = p.nz;
  k.cap = p.cap;
  k.nn = p.nn;
  k.strip = p.strip;
  k.warps = p.warps;
  k.n_strips = p.n_strips;
  k.smem = p.smem;
  k.joined = p.joined;
  k.n_runs = p.n_runs;
  int layers = 0;
  for (int r = 0; r < p.n_runs; ++r) {
    k.run_z0[r] = p.run_z0[r];
    k.run_nzl[r] = p.run_nzl[r];
    layers += p.run_nzl[r];
  }
  k.slot_mask = p.slot_mask;
  k.rc2 = static_cast<T>(p.rc2);
  k.lo2 = static_cast<T>(p.lo2);
  for (int a = 0; a < 3; ++a) {
    k.L[a] = static_cast<T>(p.L[a]);
    k.t0[a] = static_cast<T>(p.t0[a]);
    k.t1[a] = static_cast<T>(p.t1[a]);
    k.t2[a] = static_cast<T>(p.t2[a]);
  }
  int& attr = g_smem_attr[sizeof(T) == 8 ? 1 : 0];
  if (p.smem > attr) {
    const cudaError_t e = cudaFuncSetAttribute(
        nlist_select_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        p.smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    attr = p.smem;
  }
  const int blocks = (p.joined ? 0 : 1) + p.n_strips * p.ny * layers;
  nlist_select_kernel<T><<<blocks, p.warps * 32, p.smem, stream>>>(
      k, static_cast<const Vec4<T>*>(slots), counts, pid, n,
      static_cast<Vec4<T>*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Launch on `stream`; `slots` the [n_cells * cap][4] slot rows of the
// table's nz layers and `out` the [n, nn, 4] list, both float32 or, when
// params->f64 is set, float64. In place (params->joined = 0) the rows of
// the particles held in the runs' layers and of the particles that hold no
// slot are written (with one run of every layer: every row, so `out` may
// hold anything). Joined (params->joined = 1) `pid` is not read and `out`
// is [n, nn, 4] with n = (sum of run_nzl) nx ny cap, the home slots' rows
// (those of empty slots are not written). Returns cudaGetLastError() of
// the launch (0 = ok).
int htf_nlist_select(const K3Params* params, const void* slots,
                     const int* counts, const int* pid, int n, void* out,
                     void* stream) {
  const K3Params& p = *params;
  const int slot_bytes = p.f64 ? 32 : 16, key_bytes = p.f64 ? 8 : 4;
  // each run inside the table, its window too when joined (no wrap)
  bool runs_ok = p.n_runs >= 1 && p.n_runs <= kMaxRuns &&
                 (p.joined == 0 || p.joined == 1);
  int layers = 0;
  for (int r = 0; runs_ok && r < p.n_runs; ++r) {
    runs_ok = p.run_nzl[r] >= 1 && p.run_z0[r] >= p.joined &&
              p.run_z0[r] + p.run_nzl[r] + p.joined <= p.nz;
    layers += p.run_nzl[r];
  }
  if (!runs_ok || p.warps < 1 || p.warps > kMaxWarps || p.cap < 1 ||
      p.nn < 1 || p.strip < 1 || p.strip > p.nx ||
      (p.joined && n != layers * p.nx * p.ny * p.cap) ||
      p.n_strips != (p.nx + p.strip - 1) / p.strip || n < 0 ||
      p.smem != smem_bytes(p.cap, p.nn, p.strip, p.warps, slot_bytes,
                           key_bytes) ||
      p.smem > kSmemLimit || 27 * p.cap > static_cast<int>(p.slot_mask) + 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return p.f64 ? launch<double>(p, slots, counts, pid, n, out, s)
               : launch<float>(p, slots, counts, pid, n, out, s);
}

const char* htf_nlist_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
