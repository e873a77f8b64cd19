// The channels of K1's dual reduction and its second launch, shared by the
// pair-form kernels (cellwise_half.cu) and the generic form's reduction
// (cellwise_generic.cu), for Hopper (sm_90a).
//
// Channels, in order: energy U (coefficients 0.5 / 0.5, when ENERGY),
// s*dx, s*dy, s*dz (2 / -2), then when VIRIAL s*dx*dx, s*dy*dy, s*dz*dz,
// s*dx*dy, s*dx*dz, s*dy*dz (-1 / -1): ops/cellwise.py::_channel_coefs.
// The first launch writes the raw sums [n_ch][14][n_slots] (block 0 the
// row side of the home slots, block t the candidate side of the slots of
// cell c + off_t, at the home cell's index); half_stencil_home adds them.
// In group mode (GroupTab) the planes hold the home slots of every shard
// of the group, shard after shard, and half_stencil_group_home takes a
// first-layer slot's back sums from the previous shard's planes when it is
// in the group, in the same order t = 1..13, so no reverse halo is written
// within a group.

#pragma once

#include <cuda_runtime.h>

#include "half_stencil_stage.cuh"

namespace htf {

template <bool ENERGY, bool VIRIAL>
struct Channels {
  static constexpr int kForce = ENERGY ? 1 : 0;
  static constexpr int kCount = 3 + (ENERGY ? 1 : 0) + (VIRIAL ? 6 : 0);
};

// One thread per slot row of a whole state: the Newton push-back and the
// finish, in T. The raw sums are [n_ch][14][n_slots].
template <class T, bool ENERGY, bool VIRIAL>
__global__ void __launch_bounds__(kThreads)
half_stencil_home(const T* __restrict__ sums, const T* __restrict__ valid,
                  HalfGeom g, int n_slots, Vec4<T>* __restrict__ forces4,
                  T* __restrict__ virial) {
  using Ch = Channels<ENERGY, VIRIAL>;
  constexpr int NCH = Ch::kCount;
  constexpr int OF = Ch::kForce;
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n_slots) return;
  const T v = valid[i];
  T acc[NCH];
#pragma unroll
  for (int k = 0; k < NCH; ++k) acc[k] = T(0);
  if (v != T(0)) {
    const size_t plane = static_cast<size_t>(n_slots);
    const int c = i / g.cap, r = i - c * g.cap;
#pragma unroll
    for (int k = 0; k < NCH; ++k) {
      const bool energy = ENERGY && k == 0;
      const T cf = energy ? T(0.5) : (k < OF + 3 ? T(2) : T(-1));
      acc[k] = cf * sums[k * kHalf * plane + i];
    }
    for (int t = 1; t < kHalf; ++t) {
      const int sc = htf::shifted_cell(g, c, t, -1);
      const size_t src = static_cast<size_t>(sc) * g.cap + r;
#pragma unroll
      for (int k = 0; k < NCH; ++k) {
        const bool energy = ENERGY && k == 0;
        const T cb = energy ? T(0.5) : (k < OF + 3 ? T(-2) : T(-1));
        acc[k] = acc[k] + cb * sums[(k * kHalf + t) * plane + src];
      }
    }
#pragma unroll
    for (int k = 0; k < NCH; ++k) acc[k] = acc[k] * v;
  }
  forces4[i] = vec4(acc[OF], acc[OF + 1], acc[OF + 2],
                    ENERGY ? acc[0] : T(0));
  if (VIRIAL) {
    // channels xx, yy, zz, xy, xz, yz -> the symmetric 3x3, row major
    T* w = virial + static_cast<size_t>(i) * 9;
    w[0] = acc[OF + 3];
    w[1] = acc[OF + 6];
    w[2] = acc[OF + 7];
    w[3] = acc[OF + 6];
    w[4] = acc[OF + 4];
    w[5] = acc[OF + 8];
    w[6] = acc[OF + 7];
    w[7] = acc[OF + 8];
    w[8] = acc[OF + 5];
  }
}

// The finish of one slot: the channel sums times `v`, written as its
// forces4 row and (VIRIAL) its symmetric 3x3 virial, row major.
template <class T, bool ENERGY, bool VIRIAL>
__device__ __forceinline__ void write_slot(
    T (&acc)[Channels<ENERGY, VIRIAL>::kCount], size_t i,
    Vec4<T>* __restrict__ forces4, T* __restrict__ virial) {
  constexpr int OF = Channels<ENERGY, VIRIAL>::kForce;
  forces4[i] = vec4(acc[OF], acc[OF + 1], acc[OF + 2],
                    ENERGY ? acc[0] : T(0));
  if (VIRIAL) {
    // channels xx, yy, zz, xy, xz, yz
    T* w = virial + i * 9;
    w[0] = acc[OF + 3];
    w[1] = acc[OF + 6];
    w[2] = acc[OF + 7];
    w[3] = acc[OF + 6];
    w[4] = acc[OF + 4];
    w[5] = acc[OF + 8];
    w[6] = acc[OF + 7];
    w[7] = acc[OF + 8];
    w[8] = acc[OF + 5];
  }
}

// The home pass of a group (GroupTab): one thread per row of every shard's
// buffer, home layers then halo layer, shard after shard (the outputs
// [n][rows] joined). The raw sums are [n_ch][14][n H cap] (H home cells a
// shard). A home slot takes its row sum and the back sums of the cells
// c - off_t in the order t = 1..13, as the whole state's pass does: from
// its own home layers, or, for a first-layer slot whose source lies one
// layer below,
// from the last home layer of the shard before it in the group. A source
// in a shard outside the group is skipped: its sums arrive as that
// shard's reverse halo. A halo row is zero when the next shard is in the
// group (that shard's pass reads the sums pushed into it; its valid row
// is not read), else it takes the reverse-halo partial.
template <class T, bool ENERGY, bool VIRIAL>
__global__ void __launch_bounds__(kThreads)
half_stencil_group_home(const T* __restrict__ sums,
                        const __grid_constant__ GroupTab<T> tab, HalfGeom g,
                        Vec4<T>* __restrict__ forces4,
                        T* __restrict__ virial) {
  using Ch = Channels<ENERGY, VIRIAL>;
  constexpr int NCH = Ch::kCount;
  constexpr int OF = Ch::kForce;
  const int layer = g.nx * g.ny;
  const int home = g.nzl * layer * g.cap;
  const int rows = home + layer * g.cap;
  const size_t i = static_cast<size_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= static_cast<size_t>(tab.n) * rows) return;
  const int k = static_cast<int>(i / rows);
  const int li = static_cast<int>(i - static_cast<size_t>(k) * rows);
  const bool halo = li >= home;
  // a halo row whose next shard is in the group is zero (its buffer may
  // leave that layer out)
  const bool linked = halo && tab.next[k] >= 0;
  const T v = linked ? T(0) : tab.valid[k][li];
  T acc[NCH];
#pragma unroll
  for (int m = 0; m < NCH; ++m) acc[m] = T(0);
  if (v != T(0)) {
    const size_t plane = static_cast<size_t>(tab.n) * home;
    const int c = li / g.cap, r = li - c * g.cap;
    if (!halo) {
      const size_t at = static_cast<size_t>(k) * home + li;
#pragma unroll
      for (int m = 0; m < NCH; ++m) {
        const bool energy = ENERGY && m == 0;
        const T cf = energy ? T(0.5) : (m < OF + 3 ? T(2) : T(-1));
        acc[m] = cf * sums[m * kHalf * plane + at];
      }
    }
    const int x0 = c % g.nx, y0 = (c / g.nx) % g.ny, z0 = c / layer;
    const int prev = tab.prev[k];
    for (int t = 1; t < kHalf; ++t) {
      const int z = z0 - g.off[t][2];
      int sk = k, sz = z;
      if (z < 0) {
        if (prev < 0) continue;
        sk = prev;
        sz = g.nzl - 1;
      } else if (z >= g.nzl) {
        continue;
      }
      const int x = (x0 - g.off[t][0] + g.nx) % g.nx;
      const int y = (y0 - g.off[t][1] + g.ny) % g.ny;
      const size_t src = static_cast<size_t>(sk) * home +
                         static_cast<size_t>(x + g.nx * (y + g.ny * sz)) *
                             g.cap + r;
#pragma unroll
      for (int m = 0; m < NCH; ++m) {
        const bool energy = ENERGY && m == 0;
        const T cb = energy ? T(0.5) : (m < OF + 3 ? T(-2) : T(-1));
        acc[m] = acc[m] + cb * sums[(m * kHalf + t) * plane + src];
      }
    }
#pragma unroll
    for (int m = 0; m < NCH; ++m) acc[m] = acc[m] * v;
  }
  write_slot<T, ENERGY, VIRIAL>(acc, i, forces4, virial);
}

}  // namespace htf
