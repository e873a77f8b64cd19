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

#include <cuda_runtime.h>

// Launch parameters, made once per plan by the wrapper
// (ops/nlist_cuda.py::K3Params mirrors this layout). Outside the
// anonymous namespace: the C entry point takes it and must stay external.
struct K3Params {
  int nx, ny, nz, cap, nn;
  int strip, warps, n_strips, smem;
  unsigned slot_mask;
  float rc2, lo2;
  float L[3], t0[3], t1[3], t2[3];
};

namespace {

constexpr int kMaxWarps = 8;
constexpr int kSmemLimit = 232448;  // dynamic shared memory per block

// Keys a warp's buffer holds: every candidate of a query may be valid.
__host__ __device__ inline int key_buffer(int cap) {
  return (27 * cap + 3) & ~3;  // whole uint4s
}

// Shared memory of a block (ops/nlist_cuda.py::smem_bytes repeats it).
int smem_bytes(int cap, int nn, int strip, int warps) {
  const int nw = (strip + 2) * 9;
  return 16 * nw * cap                    // staged window slots
         + 4 * warps * key_buffer(cap)    // per-warp key buffers
         + 4 * warps * nn                 // per-warp winners
         + 4 * (nw + 1) + 4 * nw          // window prefix, cell ids
         + 4 * (strip + 1);               // strip query prefix
}

constexpr unsigned kFull = 0xffffffffu;

// The minimum image d - s L with s = rint(fl(d / L)): s is +-0 or +-1
// from the thresholds, the IEEE division only where they cannot decide.
__device__ __forceinline__ float min_image(float d, float L, float t0,
                                           float t1, float t2) {
  const float a = fabsf(d);
  const bool near = a <= t0;
  float s = copysignf(near ? 0.0f : 1.0f, d);
  if (!near && !(a >= t1 && a <= t2)) s = rintf(__fdiv_rn(d, L));
  return __fsub_rn(d, __fmul_rn(s, L));
}

__device__ __forceinline__ float4 displacement(const K3Params& p, float4 g,
                                               float4 q) {
  return make_float4(
      min_image(__fsub_rn(g.x, q.x), p.L[0], p.t0[0], p.t1[0], p.t2[0]),
      min_image(__fsub_rn(g.y, q.y), p.L[1], p.t0[1], p.t1[1], p.t2[1]),
      min_image(__fsub_rn(g.z, q.z), p.L[2], p.t0[2], p.t1[2], p.t2[2]),
      g.w);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}

// Block 0: zero the rows of the particles that hold no slot.
__device__ __forceinline__ void zero_unheld_rows(const K3Params& p,
                                                 const int* counts,
                                                 const int* pid, int n,
                                                 float4* out,
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
          out[static_cast<size_t>(q) * p.nn + c] =
              make_float4(0.f, 0.f, 0.f, 0.f);
    __syncthreads();
  }
}

__global__ void __launch_bounds__(kMaxWarps * 32, 2)
nlist_select_kernel(const K3Params p, const float4* __restrict__ slots,
                    const int* __restrict__ counts,
                    const int* __restrict__ pid, int n,
                    float4* __restrict__ out) {
  extern __shared__ float4 smem4[];
  if (blockIdx.x == 0) {
    zero_unheld_rows(p, counts, pid, n, out,
                     reinterpret_cast<unsigned char*>(smem4));
    return;
  }
  const int nwmax = (p.strip + 2) * 9;
  const int kbuf = key_buffer(p.cap);
  float4* cand = smem4;
  unsigned* keys = reinterpret_cast<unsigned*>(cand + nwmax * p.cap);
  int* winners = reinterpret_cast<int*>(keys + p.warps * kbuf);
  int* start = winners + p.warps * p.nn;  // [nw + 1]
  int* cell = start + nwmax + 1;          // [nw]
  int* qstart = cell + nwmax;             // [S + 1]

  const int b = blockIdx.x - 1;
  const int sx = b % p.n_strips;
  const int y0 = (b / p.n_strips) % p.ny;
  const int z0 = b / (p.n_strips * p.ny);
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
    const int z = (z0 - 1 + rz + p.nz) % p.nz;
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
  // warp to a cell, every copy in flight at once
  for (int w = warp; w < nw; w += p.warps) {
    const int first = start[w], cnt = start[w + 1] - first;
    const float4* src = slots + static_cast<size_t>(cell[w]) * p.cap;
    for (int r = lane; r < cnt; r += 32)
      cp_async16(cand + first + r, src + r);
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();

  const int Q = qstart[S];
  unsigned* wk = keys + warp * kbuf;
  int* win = winners + warp * p.nn;
  int i = 0;
  for (int t = warp; t < Q; t += p.warps) {
    while (qstart[i + 1] <= t) ++i;
    const int qr = t - qstart[i];
    const int wq = 9 * (i + 1) + 4;
    const float4 q = cand[start[wq] + qr];
    const int particle = pid[static_cast<size_t>(cell[wq]) * p.cap + qr];
    const int lo = start[9 * i];
    const int total = start[9 * i + 27] - lo;

    int nv = 0;
    for (int base = 0; base < total; base += 32) {
      const int f = base + lane;
      float dx = 0.f, dy = 0.f, dz = 0.f;
      if (f < total) {  // else d = 0, so d2 = 0 < lo2: never valid
        const float4 g = cand[lo + f];
        dx = __fsub_rn(g.x, q.x);
        dy = __fsub_rn(g.y, q.y);
        dz = __fsub_rn(g.z, q.z);
      }
      // when every |d| <= t0, every shift is +-0 and d2 is d's own
      const bool far = fabsf(dx) > p.t0[0] || fabsf(dy) > p.t0[1] ||
                       fabsf(dz) > p.t0[2];
      if (__any_sync(kFull, far)) {
        dx = min_image(dx, p.L[0], p.t0[0], p.t1[0], p.t2[0]);
        dy = min_image(dy, p.L[1], p.t0[1], p.t1[1], p.t2[1]);
        dz = min_image(dz, p.L[2], p.t0[2], p.t1[2], p.t2[2]);
      }
      const float d2 = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx),
                                           __fmul_rn(dy, dy)),
                                 __fmul_rn(dz, dz));
      const bool ok = d2 <= p.rc2 && d2 >= p.lo2;
      const unsigned hits = __ballot_sync(kFull, ok);
      if (ok)
        wk[nv + __popc(hits & ((1u << lane) - 1u))] =
            (__float_as_uint(d2) & ~p.slot_mask) | static_cast<unsigned>(f);
      nv += __popc(hits);
    }
    // pad to whole uint4s with keys larger than any valid one
    const int nv4 = (nv + 3) & ~3;
    if (lane < nv4 - nv) wk[nv + lane] = kFull;
    __syncwarp();

    // rank = number of smaller keys (keys are unique); winners in rank
    // order
    const uint4* wk4 = reinterpret_cast<const uint4*>(wk);
    for (int h = lane; h < nv; h += 64) {
      const unsigned k0 = wk[h];
      const bool two = h + 32 < nv;
      const unsigned k1 = two ? wk[h + 32] : kFull;
      int r0 = 0, r1 = 0;
      for (int m = 0; m < nv4 / 4; ++m) {
        const uint4 v = wk4[m];
        r0 += (v.x < k0) + (v.y < k0) + (v.z < k0) + (v.w < k0);
        r1 += (v.x < k1) + (v.y < k1) + (v.z < k1) + (v.w < k1);
      }
      if (r0 < p.nn) win[r0] = static_cast<int>(k0 & p.slot_mask);
      if (two && r1 < p.nn) win[r1] = static_cast<int>(k1 & p.slot_mask);
    }
    __syncwarp();

    // the whole row, coalesced, zeros past the valid count
    const int nout = min(nv, p.nn);
    float4* row = out + static_cast<size_t>(particle) * p.nn;
    for (int c = lane; c < p.nn; c += 32) {
      float4 o = make_float4(0.f, 0.f, 0.f, 0.f);
      if (c < nout) o = displacement(p, cand[lo + win[c]], q);
      __stcs(row + c, o);
    }
    __syncwarp();  // the next query reuses the warp's buffers
  }
}

// the kernel's dynamic shared memory cap: 48 KB less its static array,
// since a launch whose static and dynamic bytes together pass 48 KB needs
// the opt-in attribute
int g_smem_attr = 48 * 1024 - static_cast<int>(sizeof(int)) * kMaxWarps;

}  // namespace

extern "C" {

// Launch on `stream`; `out` is the [n, nn, 4] float32 list (any contents:
// every row is written). Returns cudaGetLastError() of the launch
// (0 = ok).
int htf_nlist_select(const K3Params* params, const float* slots,
                     const int* counts, const int* pid, int n, float* out,
                     void* stream) {
  const K3Params& p = *params;
  if (p.warps < 1 || p.warps > kMaxWarps || p.cap < 1 || p.nn < 1 ||
      p.strip < 1 || p.strip > p.nx ||
      p.n_strips != (p.nx + p.strip - 1) / p.strip || n < 0 ||
      p.smem != smem_bytes(p.cap, p.nn, p.strip, p.warps) ||
      p.smem > kSmemLimit || 27 * p.cap > static_cast<int>(p.slot_mask) + 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (p.smem > g_smem_attr) {
    const cudaError_t e = cudaFuncSetAttribute(
        nlist_select_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        p.smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    g_smem_attr = p.smem;
  }
  const int blocks = 1 + p.n_strips * p.ny * p.nz;
  nlist_select_kernel<<<blocks, p.warps * 32, p.smem,
                        static_cast<cudaStream_t>(stream)>>>(
      p, reinterpret_cast<const float4*>(slots), counts, pid, n,
      reinterpret_cast<float4*>(out));
  return static_cast<int>(cudaGetLastError());
}

const char* htf_nlist_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
