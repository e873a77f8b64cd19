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

#pragma once

#include <cuda_runtime.h>

#include "half_stencil_stage.cuh"

namespace htf {

template <bool ENERGY, bool VIRIAL>
struct Channels {
  static constexpr int kForce = ENERGY ? 1 : 0;
  static constexpr int kCount = 3 + (ENERGY ? 1 : 0) + (VIRIAL ? 6 : 0);
};

// One thread per slot: the Newton push-back and the finish, in T.
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
      const size_t src = static_cast<size_t>(htf::shifted_cell(g, c, t, -1)) *
                             g.cap + r;
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

}  // namespace htf
