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
// type). Keys are unique within a row, so the order is a total order and
// the result deterministic. The arithmetic is IEEE single precision with
// no contraction (explicit _rn intrinsics; the build also passes
// -fmad=false): the key is built from d2's bits, so one ulp could reorder
// near-ties, and the PyTorch reference must round identically.
//
// The TPU kernel takes [n_cells, 27*cap] candidate matrices that XLA
// gathers beforehand and lifts rows with one-hot matmuls (Mosaic has no
// dynamic lane indexing). Here each block gathers its own 27 cells:
//   - one block per cell; the first warp reads the 27 neighbour counts
//     and prefix-sums them, then the block stages the occupied candidate
//     slots (real particles fill a prefix of each cell's slots; an empty
//     slot's far sentinel can never be valid) in shared memory with
//     their slot index j;
//   - one warp per occupied query slot: lanes compute keys over a
//     strided share of the candidates and compact the valid ones with
//     ballot/popc into the warp's shared key buffer; each valid key's
//     rank is the number of smaller valid keys; keys with rank < NN are
//     written straight into the particle-order [N, NN, 4] list through
//     the slot's particle id (the TPU path's four row gathers and its
//     stack fused away). Columns past the valid count stay as the
//     wrapper's zero fill. No atomics.
//
// What bounds it on an H100: bytes. The [N, NN, 4] float32 output
// (67 MB at N = 65536, NN = 64) is the only large transfer (~0.02 ms at
// 3.35 TB/s); the slot rows are read once per neighbouring block and
// mostly hit L2. The work is ~300 real candidates per query at the 64k
// fluid (~20 float operations each) plus the ranking (~valid^2 integer
// compares, ~45^2), far below the float32 roof. The design keeps the
// candidate matrix and the keys on chip and writes each output element
// once.

#include <cuda_runtime.h>

namespace {

constexpr int kStencil = 27;
constexpr int kMaxWarps = 8;
constexpr size_t kSmemLimit = 232448;  // dynamic shared memory per block

size_t smem_bytes(int cap, int warps) {
  const size_t c = static_cast<size_t>(kStencil) * cap;
  return c * sizeof(float4)                        // staged candidates
         + static_cast<size_t>(warps) * c * 4      // per-warp key buffers
         + c * 4                                   // slot j of each candidate
         + 2 * 28 * 4;                             // cell prefix, ids
}

__device__ __forceinline__ float min_image(float d, float L) {
  return __fsub_rn(d, __fmul_rn(rintf(__fdiv_rn(d, L)), L));
}

__device__ __forceinline__ float displacement(float4 g, float4 q, float lx,
                                              float ly, float lz, float& dx,
                                              float& dy, float& dz) {
  dx = min_image(__fsub_rn(g.x, q.x), lx);
  dy = min_image(__fsub_rn(g.y, q.y), ly);
  dz = min_image(__fsub_rn(g.z, q.z), lz);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                   __fmul_rn(dz, dz));
}

__global__ void __launch_bounds__(kMaxWarps * 32)
nlist_select_kernel(const float4* __restrict__ slots,
                    const int* __restrict__ counts,
                    const int* __restrict__ pid, int nx, int ny, int nz,
                    int cap, int nn, float rc2, float lo2, float lx,
                    float ly, float lz, unsigned slot_mask,
                    float4* __restrict__ out) {
  extern __shared__ float4 smem4[];
  const int C = kStencil * cap;
  const int warps = blockDim.x / 32;
  float4* cand = smem4;
  unsigned* keys = reinterpret_cast<unsigned*>(cand + C);
  int* cslot = reinterpret_cast<int*>(keys + static_cast<size_t>(warps) * C);
  int* start = cslot + C;  // [28]: prefix of the 27 cells' counts
  int* nbr = start + 28;   // [27]: the neighbour cell ids

  const int c = blockIdx.x;
  const int nq = counts[c];
  if (nq == 0) return;  // uniform over the block
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  if (warp == 0) {
    const int x0 = c % nx, y0 = (c / nx) % ny, z0 = c / (nx * ny);
    int cnt = 0, nb = 0;
    if (lane < kStencil) {
      // offset (a, b, e) in the JAX package's order: k = 9a + 3b + e + 13
      const int a = lane / 9 - 1, b = (lane / 3) % 3 - 1, e = lane % 3 - 1;
      const int x = (x0 + a + nx) % nx;
      const int y = (y0 + b + ny) % ny;
      const int z = (z0 + e + nz) % nz;
      nb = x + nx * (y + ny * z);
      cnt = counts[nb];
    }
    int incl = cnt;
    for (int o = 1; o < 32; o <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += v;
    }
    if (lane < kStencil) {
      start[lane] = incl - cnt;
      nbr[lane] = nb;
    }
    if (lane == kStencil - 1) start[kStencil] = incl;
  }
  __syncthreads();

  for (int s = threadIdx.x; s < C; s += blockDim.x) {
    const int k = s / cap, r = s - k * cap;
    const int first = start[k];
    if (r < start[k + 1] - first) {
      cand[first + r] = slots[static_cast<size_t>(nbr[k]) * cap + r];
      cslot[first + r] = s;
    }
  }
  __syncthreads();

  const int total = start[kStencil];
  unsigned* wk = keys + static_cast<size_t>(warp) * C;
  for (int qr = warp; qr < nq; qr += warps) {
    const size_t qs = static_cast<size_t>(c) * cap + qr;
    const float4 q = slots[qs];
    const size_t row = static_cast<size_t>(pid[qs]) * nn;
    int nv = 0;
    for (int base = 0; base < total; base += 32) {
      const int i = base + lane;
      bool ok = false;
      unsigned key = 0;
      if (i < total) {
        float dx, dy, dz;
        const float d2 = displacement(cand[i], q, lx, ly, lz, dx, dy, dz);
        ok = d2 <= rc2 && d2 >= lo2;
        key = (__float_as_uint(d2) & ~slot_mask) |
              static_cast<unsigned>(cslot[i]);
      }
      const unsigned b = __ballot_sync(0xffffffffu, ok);
      if (ok) wk[nv + __popc(b & ((1u << lane) - 1u))] = key;
      nv += __popc(b);
    }
    __syncwarp();
    for (int i = lane; i < nv; i += 32) {
      const unsigned ki = wk[i];
      int rank = 0;
      for (int m = 0; m < nv; ++m) rank += wk[m] < ki;
      if (rank < nn) {
        const int j = static_cast<int>(ki & slot_mask);
        const int k = j / cap, r = j - k * cap;
        const float4 g = cand[start[k] + r];
        float dx, dy, dz;
        displacement(g, q, lx, ly, lz, dx, dy, dz);
        out[row + rank] = make_float4(dx, dy, dz, g.w);
      }
    }
    __syncwarp();  // the next query reuses the key buffer
  }
}

}  // namespace

extern "C" {

// Warps per block for capacity `cap` (the most, up to 8, whose key
// buffers fit in shared memory); 0 when not even one fits.
int htf_nlist_select_warps(int cap) {
  for (int w = kMaxWarps; w >= 1; --w)
    if (smem_bytes(cap, w) <= kSmemLimit) return w;
  return 0;
}

// Launch on `stream` over the nx*ny*nz cells; `out` is the zero-filled
// [n, nn, 4] float32 list. Returns cudaGetLastError() of the launch
// (0 = ok).
int htf_nlist_select(const float* slots, const int* counts, const int* pid,
                     int nx, int ny, int nz, int cap, int nn, float rc2,
                     float lo2, float lx, float ly, float lz, int slot_bits,
                     int warps, float* out, void* stream) {
  if (warps < 1 || warps > kMaxWarps || cap < 1 || nn < 1 ||
      slot_bits < 1 || slot_bits > 30 ||
      (static_cast<long>(kStencil) * cap > (1L << slot_bits)))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = smem_bytes(cap, warps);
  if (smem > kSmemLimit) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        nlist_select_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const unsigned mask = (1u << slot_bits) - 1u;
  nlist_select_kernel<<<nx * ny * nz, warps * 32, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float4*>(slots), counts, pid, nx, ny, nz, cap,
      nn, rc2, lo2, lx, ly, lz, mask, reinterpret_cast<float4*>(out));
  return static_cast<int>(cudaGetLastError());
}

const char* htf_nlist_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
