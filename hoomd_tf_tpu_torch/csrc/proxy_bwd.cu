// Chebyshev-proxy backward of online training (kernel K2): the parameter
// gradient of the proxy pair forces as lane-moment sums, hand-written for
// Hopper (sm_90a).
//
// Replaces: hoomd_tf_tpu/ops/pair_train_pallas.py::_kernel (the Pallas TPU
// kernel behind proxy_bwd_moments). The proxy's lane function is linear in
// its coefficients, so the gradient of <ct, F4> is, with u = 1/max(d2,
// min_r2), w = clip((u - mid) * inv_half, -1, 1), over = max(u - u_hi, 0):
//   d/dc_k  = sum_lanes  A * T_k(w),         A = wE
//   d/dcd_k = sum_lanes  B * T_k(w),         B = wE * over - wF * u^2
// over the half-stencil lanes of kernel K1 (csrc/cellwise_half.cu), with
// the Newton-combined cotangent weights
//   wF = 2 * ((ct_i . d) - [j directed] (ct_j . d)),
//   wE = 0.5 * (cte_i + [j directed] cte_j),
// ct the cotangent times `valid`, and T_k(w) from the two-term recurrence.
// A typed proxy keeps one (c, cd) pair of moment sets per unordered type
// pair; types outside the table add nothing. Without the energy moments,
// A is absent and the c-moments are zero.
//
// Design: one block per home cell. The block stages the occupied slots of
// its 14 half-stencil cells straight from the slot-ordered state
// (half_stencil_stage.cuh), each with its cotangent ct * valid, those of
// the 13 directed blocks only within the cut of the home rows' bounding
// box: no candidate or cotangent plane exists in device memory, and empty
// or out-of-reach slots are never walked. The lanes (home row i, staged candidate j) are split
// over (row, candidate segment) pairs; the self pair is excluded by staged
// index. Untyped with K = 8 or 16 (the train path: K = 16), each thread
// keeps its 2K moments in registers; at the end a warp shuffle tree per
// moment and the warps' partials in a fixed order give the block's sums.
// Typed proxies and other K keep per-thread accumulators in shared memory,
// one [2K] set per candidate type (a thread's row type is fixed within a
// pass), folded into the block's [P][2K] sums at the end of each pass of
// rows. Each block writes its [P * 2K] partial sums; a second kernel sums
// them over cells in a fixed order. No float atomics, so the result is
// deterministic, and any P * 2K works (the Pallas kernel's one 128-lane
// output row capped 2K * P at 128).
//
// Group mode (the training backward under a mesh; GroupTab and ShardRows
// of half_stencil_stage.cuh, as K1's group launch): one launch pair over
// every home cell of the z-slab shards one card holds. Block c is home
// cell c - k H of shard k = c / H, staged from the shard's buffer, its
// candidates' cotangents read at their own slots: a halo cell's in place
// from the next shard's first home layer when that shard is in the group,
// else from the shard's halo rows (the next shard's cotangent there,
// where the reverse halo was added). The blocks run in the group's global
// cell order, so the summing pass adds the cells in that order: a group
// of every shard gives the whole state's moments bit for bit, and groups
// on several cards give parts whose sum is the whole state's (each
// unordered pair belongs to one home cell's half stencil). A z-slab
// shard alone is the group of one with its halo layer.
//
// Many types: the per-thread sets take T * 2K * kThreads scalars, past
// the block's shared memory from three types up in double (K = 16, cap
// 48). The types are then split into groups of G (the largest G whose
// block fits, planned by the wrapper: pair_train_cuda.type_groups, which
// mirrors smem_bytes) and the grid gets one row per pair of groups
// (A, B), A <= B: a block of that row walks only the lanes whose row type
// is in one group and candidate type in the other, keeps G sets per
// thread (indexed by the candidate type within the other group) and
// writes the columns of the type pairs {a in A, b in B} of `partial`.
// Every column is written by exactly one row, so the summing pass is the
// same. With one group (G = T) the grid has one row and the block is
// today's.
//
// What bounds it on an H100: operations. The function needs the slot state
// (positions, valid, the [n_slots, 4] cotangent; types when typed) read
// once and P * 2K floats written, ~4 MB at the 64k train shapes, against
// ~2.2e7 occupied x occupied half-stencil pairs at ~9 float32 operations
// each, plus ~27 + 4K (6K with energy) for the ~5% inside the cut: about
// 0.25 G operations, ~0.004 ms at 67 TFLOP/s.
//
// Built with -fmad=false, and the staging uses _rn intrinsics, so the
// cutoff mask agrees bit for bit with the plain version.
//
// Every kernel is a template on the scalar type S (scalar.cuh), built for
// float and for double: a float64 state and proxy run the double
// instantiation (staged entries, cotangents, moments and sums in double;
// the 2K register moments take twice the registers, and the staging's
// shared memory doubles), at the card's float64 rate.

#include <cuda_runtime.h>

#include "half_stencil_stage.cuh"
#include "scalar.cuh"

namespace {

using htf::HalfGeom;
using htf::kHalf;
using htf::kThreads;
using htf::kWarps;
using htf::Vec4;
using htf::fmax_;
using htf::fmin_;

template <class S>
__device__ __forceinline__ S warp_sum(S v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Grid row `row` of a launch over T types in groups of G: the row-major
// index of the pair of groups (A, B), A <= B, with A = [a0, a1) and
// B = [b0, b1). One group (G >= T): the row pairs all types with all.
struct GroupPair {
  int T, G, a0, a1, b0, b1;
  bool same;
  __device__ GroupPair(int row, int T_, int G_) : T(T_), G(G_ < T_ ? G_ : T_) {
    const int nb = (T + G - 1) / G;
    int i = 0;
    while (row >= nb - i) {  // group row i pairs with groups i .. nb - 1
      row -= nb - i;
      ++i;
    }
    const int j = i + row;
    a0 = i * G;
    a1 = min(T, a0 + G);
    b0 = j * G;
    b1 = min(T, b0 + G);
    same = i == j;
  }
  __device__ int n_pairs() const {
    const int na = a1 - a0;
    return same ? na * (na + 1) / 2 : na * (b1 - b0);
  }
  // The candidate types [o0, o1) a row of type t pairs with in this grid
  // row; false when t is in neither group.
  __device__ bool other(int t, int& o0, int& o1) const {
    if (t >= a0 && t < a1) {
      o0 = b0;
      o1 = b1;
      return true;
    }
    if (t >= b0 && t < b1) {
      o0 = a0;
      o1 = a1;
      return true;
    }
    return false;
  }
  // The `partial` column of this row's i-th moment (pair-major, 2K terms
  // a pair, the pairs in the fold's order): the pair's place in
  // chebyshev.type_pairs order times 2K, plus the term.
  __device__ int column(int i, int K2) const {
    int lp = i / K2;
    const int m = i - lp * K2;
    int a = a0, b;
    if (same) {
      while (lp >= a1 - a) {  // type a pairs with a .. a1 - 1
        lp -= a1 - a;
        ++a;
      }
      b = a + lp;
    } else {
      a = a0 + lp / (b1 - b0);
      b = b0 + lp % (b1 - b0);
    }
    return (a * T - a * (a - 1) / 2 + (b - a)) * K2 + m;
  }
};

// The moments of global home cell `gc`, its rows, valid and cotangent
// (aux) read where `src` keeps them (OneBuffer, ShardRows), written as row
// `c` of `partial`. KR > 0: untyped with K = KR, moments in registers;
// KR == 0: per-thread moment sets in shared memory (typed, or another K).
template <class S, bool ENERGY, int KR, class Src>
__device__ __forceinline__ void moments_block(
    const Src& src, int gc, int c, const S* __restrict__ box, HalfGeom g,
    const S* __restrict__ rcm, int rcm_t, int K, int T, int G, S rc2,
    S min_r2, S mid, S inv_half, S u_hi, S* __restrict__ partial) {
  const int C = kHalf * g.cap;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int K2 = 2 * K;
  const int M_all = T * (T + 1) / 2 * K2;  // a row of `partial`
  const bool typed = T > 1;
  // this grid row's pair of type groups [a0, a1) <= [b0, b1)
  const GroupPair gp(blockIdx.y, T, G);
  const int M = gp.n_pairs() * K2;

  Vec4<S>* spos = htf::dynamic_smem<Vec4<S>>();          // [C]
  Vec4<S>* sct = spos + C;                               // [C] ct * valid
  int* stag = reinterpret_cast<int*>(sct + C);           // [C]
  unsigned char* scratch = reinterpret_cast<unsigned char*>(stag + C);
  S* wpart = reinterpret_cast<S*>(scratch + htf::stage_bytes<S>());
  //                                                       [kWarps][M]
  S* acc = wpart + kWarps * M;                           // [M]
  S* slots = acc + M;  // KR == 0: [G][2K][kThreads]

  for (int i = tid; i < M; i += kThreads) acc[i] = S(0);
  int n0;
  const int total = htf::stage_rows<S>(
      g, gc, rc2, src, box, spos, stag, scratch, n0,
      [&](int k, int code, size_t slot) {
        const Vec4<S> v = static_cast<const Vec4<S>*>(src.a(code))[slot];
        const S w = src.v(code)[slot];
        sct[k] = htf::vec4(v.x * w, v.y * w, v.z * w, v.w * w);
      },
      htf::NoSkip());

  S mom[KR > 0 ? 2 * KR : 1];
#pragma unroll
  for (int m = 0; m < (KR > 0 ? 2 * KR : 1); ++m) mom[m] = S(0);

  for (int r0 = 0; r0 < n0; r0 += kThreads) {
    const htf::RowSplit sp(r0, n0);
    int ti = 0;
    int o0 = 0, o1 = 1;  // the candidate types this row pairs with
    bool row_ok = sp.active;
    if (KR == 0)
      for (int m = 0; m < gp.G * K2; ++m) slots[m * kThreads + tid] = S(0);
    if (sp.active) {
      const Vec4<S> q = spos[sp.row];
      const Vec4<S> cq = sct[sp.row];
      ti = htf::unpack_type(q.w);
      // rows of a type outside the table, or outside both groups, add
      // nothing
      if (typed) row_ok = gp.other(ti, o0, o1);
      for (int j = sp.seg; row_ok && j < total; j += sp.nseg) {
        if (j == sp.row) continue;  // the self pair (block 0)
        const Vec4<S> gj = spos[j];
        const S dx = gj.x - q.x;
        const S dy = gj.y - q.y;
        const S dz = gj.z - q.z;
        const S d2 = dx * dx + dy * dy + dz * dz;
        if (!(d2 <= rc2)) continue;
        const int tj = htf::unpack_type(gj.w);
        if (rcm != nullptr) {
          const bool known = ti >= 0 && ti < rcm_t && tj >= 0 && tj < rcm_t;
          const S prc2 = known ? rcm[ti * rcm_t + tj] : S(0);
          if (!(d2 <= prc2)) continue;
        }
        if (typed && (tj < o0 || tj >= o1)) continue;
        const bool directed = j >= n0;
        const S r2 = fmax_(d2, min_r2);
        S wF = cq.x * dx + cq.y * dy + cq.z * dz;
        Vec4<S> cj = htf::vec4(S(0), S(0), S(0), S(0));
        if (directed) {
          cj = sct[j];
          wF = wF - (cj.x * dx + cj.y * dy + cj.z * dz);
        }
        wF = S(2) * wF;
        const S u = S(1) / r2;
        const S over = fmax_(u - u_hi, S(0));
        S A = S(0), B;
        if (ENERGY) {
          S wE = cq.w;
          if (directed) wE = wE + cj.w;
          wE = S(0.5) * wE;
          A = wE;
          B = wE * over - wF * (u * u);
        } else {
          B = -wF * (u * u);
        }
        const S w = fmin_(fmax_((u - mid) * inv_half, S(-1)), S(1));
        const S two_w = S(2) * w;
        S t_prev = S(1), t_cur = w;
        if (KR > 0) {
#pragma unroll
          for (int k = 0; k < (KR > 0 ? KR : 1); ++k) {
            const S t_k = k == 0 ? t_prev : t_cur;
            if (ENERGY) mom[k] += A * t_k;
            mom[KR + k] += B * t_k;
            if (k >= 1) {
              const S t_next = two_w * t_cur - t_prev;
              t_prev = t_cur;
              t_cur = t_next;
            }
          }
        } else {
          S* s = slots + (typed ? tj - o0 : 0) * K2 * kThreads + tid;
          for (int k = 0; k < K; ++k) {
            const S t_k = k == 0 ? t_prev : t_cur;
            if (ENERGY) s[k * kThreads] += A * t_k;
            s[(K + k) * kThreads] += B * t_k;
            if (k >= 1) {
              const S t_next = two_w * t_cur - t_prev;
              t_prev = t_cur;
              t_cur = t_next;
            }
          }
        }
      }
    }
    if (KR == 0) {
      // fold this pass's sets into the block sums: the thread's share of
      // pair (a, b), term m -> warp tree -> warp partial -> fixed-order sum
      int pidx = 0;
      for (int a = gp.a0; a < gp.a1; ++a) {
        for (int b = gp.same ? a : gp.b0; b < gp.b1; ++b, ++pidx) {
          for (int m = 0; m < K2; ++m) {
            S v = S(0);
            if (row_ok) {
              if (!typed) {
                v = slots[m * kThreads + tid];
              } else {
                if (ti == a) v = slots[((b - o0) * K2 + m) * kThreads + tid];
                if (a != b && ti == b)
                  v = v + slots[((a - o0) * K2 + m) * kThreads + tid];
              }
            }
            v = warp_sum(v);
            if (lane == 0) wpart[warp * M + pidx * K2 + m] = v;
          }
        }
      }
      __syncthreads();
      for (int i = tid; i < M; i += kThreads) {
        S v = S(0);
        for (int w = 0; w < kWarps; ++w) v += wpart[w * M + i];
        acc[i] += v;
      }
      __syncthreads();
    }
  }

  if (KR > 0) {
#pragma unroll
    for (int m = 0; m < (KR > 0 ? 2 * KR : 1); ++m) {
      const S v = warp_sum(mom[m]);
      if (lane == 0) wpart[warp * M + m] = v;
    }
    __syncthreads();
    for (int i = tid; i < M; i += kThreads) {
      S v = S(0);
      for (int w = 0; w < kWarps; ++w) v += wpart[w * M + i];
      acc[i] = v;
    }
  }
  for (int i = tid; i < M; i += kThreads)
    partial[static_cast<size_t>(c) * M_all + gp.column(i, K2)] = acc[i];
}

// One block per home cell of a whole state.
template <class S, bool ENERGY, int KR>
__global__ void __launch_bounds__(kThreads)
proxy_bwd_kernel(const S* __restrict__ pos, const int* __restrict__ types,
                 const S* __restrict__ valid, const S* __restrict__ box,
                 const Vec4<S>* __restrict__ ct, HalfGeom g,
                 const S* __restrict__ rcm, int rcm_t, int K, int T,
                 int G, S rc2, S min_r2, S mid, S inv_half, S u_hi,
                 S* __restrict__ partial) {
  const int c = blockIdx.x;
  moments_block<S, ENERGY, KR>(htf::OneBuffer<S>{pos, types, valid, ct}, c,
                               c, box, g, rcm, rcm_t, K, T, G, rc2, min_r2,
                               mid, inv_half, u_hi, partial);
}

// One block per home cell of a group's shards (GroupTab, the cotangent in
// its aux arrays): block c is home cell c - k H of shard k = c / H, which
// is the group's global cell order (the shards in ring order, z0
// ascending), so the summing pass adds the cells in that order.
template <class S, bool ENERGY, int KR>
__global__ void __launch_bounds__(kThreads)
proxy_bwd_group_kernel(const __grid_constant__ htf::GroupTab<S> tab,
                       const S* __restrict__ box, HalfGeom g,
                       const S* __restrict__ rcm, int rcm_t, int K, int T,
                       int G, S rc2, S min_r2, S mid, S inv_half, S u_hi,
                       S* __restrict__ partial) {
  const int c = blockIdx.x;
  const int H = g.nzl * g.nx * g.ny;
  const int k = c / H;
  moments_block<S, ENERGY, KR>(htf::ShardRows<S>(tab, k),
                               tab.z0[k] * g.nx * g.ny + (c - k * H), c, box,
                               g, rcm, rcm_t, K, T, G, rc2, min_r2, mid,
                               inv_half, u_hi, partial);
}

// out[m] = sum over cells of partial[cell][m], in a fixed order: one block
// per m, a strided per-thread sum, then a shuffle tree and the warps in
// order.
template <class S>
__global__ void __launch_bounds__(kThreads)
reduce_partials(const S* __restrict__ partial, int n_cells, int M,
                S* __restrict__ out) {
  __shared__ S wsum[kWarps];
  const int m = blockIdx.x;
  const int tid = threadIdx.x;
  S v = S(0);
  for (int c = tid; c < n_cells; c += kThreads)
    v += partial[static_cast<size_t>(c) * M + m];
  v = warp_sum(v);
  if ((tid & 31) == 0) wsum[tid >> 5] = v;
  __syncthreads();
  if (tid == 0) {
    S s = S(0);
    for (int w = 0; w < kWarps; ++w) s += wsum[w];
    out[m] = s;
  }
}

// The register-moment degree for (K, T), or 0 for the shared-memory path.
int register_degree(int K, int T) {
  if (T != 1) return 0;
  return (K == 8 || K == 16) ? K : 0;
}

// A block's bytes for T types in groups of G (G >= T: one group, the sums
// of all T(T+1)/2 pairs; else at most G * G pairs a grid row and G moment
// sets a thread). pair_train_cuda.py mirrors this formula.
template <class S>
long smem_bytes(int cap, int K, int T, int G) {
  const long K2 = 2L * K;
  const long Gs = G < T ? G : T;
  const long M = (Gs == T ? T * (T + 1) / 2 : Gs * Gs) * K2;
  const long slots = register_degree(K, T) ? 0 : Gs * K2 * kThreads;
  return static_cast<long>(kHalf) * cap *
             (2 * sizeof(Vec4<S>) + sizeof(int)) +
         htf::stage_bytes<S>() +
         static_cast<long>(sizeof(S)) * (kWarps * M + M + slots);
}

// Grid rows of T types in groups of G: one per pair of groups.
int group_rows(int T, int G) {
  const int nb = G >= T ? 1 : (T + G - 1) / G;
  return nb * (nb + 1) / 2;
}

// The call's arguments, typed: the wrapper hands the arrays over as
// void * and the scalars as double.
template <class S>
struct Args {
  const S *pos, *valid, *box, *rcm;
  const int* types;
  const Vec4<S>* ct;
  int rcm_t, K, T, G;
  S rc2, min_r2, mid, inv_half, u_hi;
  S* partial;
};

// A launch's shards: null for a whole state (Args' arrays), else the
// group's table (its cotangent in the aux arrays).
template <class S, bool ENERGY, int KR>
int launch_moments(const Args<S>& a, const htf::GroupTab<S>* tab,
                   const HalfGeom& g, int n_cells, cudaStream_t s) {
  const long smem = smem_bytes<S>(g.cap, a.K, a.T, a.G);
  auto kernel = proxy_bwd_kernel<S, ENERGY, KR>;
  auto group = proxy_bwd_group_kernel<S, ENERGY, KR>;
  const void* fn = tab ? reinterpret_cast<const void*>(group)
                       : reinterpret_cast<const void*>(kernel);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid(n_cells, group_rows(a.T, a.G));
  if (tab)
    group<<<grid, kThreads, smem, s>>>(
        *tab, a.box, g, a.rcm, a.rcm_t, a.K, a.T, a.G, a.rc2, a.min_r2,
        a.mid, a.inv_half, a.u_hi, a.partial);
  else
    kernel<<<grid, kThreads, smem, s>>>(
        a.pos, a.types, a.valid, a.box, a.ct, g, a.rcm, a.rcm_t, a.K, a.T,
        a.G, a.rc2, a.min_r2, a.mid, a.inv_half, a.u_hi, a.partial);
  return static_cast<int>(cudaGetLastError());
}

template <class S, bool ENERGY>
int dispatch_degree(const Args<S>& a, const htf::GroupTab<S>* tab,
                    const HalfGeom& g, int n_cells, cudaStream_t s) {
  switch (register_degree(a.K, a.T)) {
    case 16:
      return launch_moments<S, ENERGY, 16>(a, tab, g, n_cells, s);
    case 8:
      return launch_moments<S, ENERGY, 8>(a, tab, g, n_cells, s);
    default:
      return launch_moments<S, ENERGY, 0>(a, tab, g, n_cells, s);
  }
}

// Both passes over n_cells home cells: of a whole state (tab null) or of
// a group's shards.
template <class S>
int moments(const void* pos, const int* types, const void* valid,
            const void* box, const void* ct, const htf::GroupTab<S>* tab,
            const HalfGeom* geom, int n_cells, const void* rcm, int rcm_t,
            int K, int ntypes, int group, double rc2, double min_r2,
            double mid, double inv_half, double u_hi, int needs_energy,
            void* partial, void* out, cudaStream_t s) {
  const HalfGeom g = *geom;
  const Args<S> a{static_cast<const S*>(pos), static_cast<const S*>(valid),
                  static_cast<const S*>(box), static_cast<const S*>(rcm),
                  types, static_cast<const Vec4<S>*>(ct), rcm_t, K, ntypes,
                  group < 1 ? ntypes : group, static_cast<S>(rc2),
                  static_cast<S>(min_r2), static_cast<S>(mid),
                  static_cast<S>(inv_half), static_cast<S>(u_hi),
                  static_cast<S*>(partial)};
  const int M = ntypes * (ntypes + 1) / 2 * 2 * K;
  const int e = needs_energy
                    ? dispatch_degree<S, true>(a, tab, g, n_cells, s)
                    : dispatch_degree<S, false>(a, tab, g, n_cells, s);
  if (e != 0) return e;
  reduce_partials<S><<<M, kThreads, 0, s>>>(static_cast<const S*>(partial),
                                            n_cells, M, static_cast<S*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Shared-memory bytes one block of the moment kernel needs (`f64`: the
// double instantiation) for `ntypes` types in groups of `group`.
long htf_proxy_bwd_smem(int f64, int cap, int K, int ntypes, int group) {
  return f64 ? smem_bytes<double>(cap, K, ntypes, group)
             : smem_bytes<float>(cap, K, ntypes, group);
}

// Launch both passes on `stream`: per-cell partial sums into `partial`
// ([n_cells][P * 2K] scratch), then their sum into `out` ([P * 2K], per
// pair p: c-moments at p * 2K + k, cd-moments at p * 2K + K + k). `f64`
// picks the scalar type of every floating array: float32 (0) or float64
// (1). `pos` [n_slots][3], `types` [n_slots] int32 (or null when untyped),
// `valid` [n_slots], `box` the [3][3] box (rows low, high, tilt) on the
// card, `ct` the [n_slots][4] cotangent, `geom` a host HalfGeom, `group`
// the types a group holds (>= ntypes: one group); the scalars are rounded
// to the scalar type. Returns cudaGetLastError() after the launches
// (0 = ok).
int htf_proxy_bwd(int f64, const void* pos, const int* types,
                  const void* valid, const void* box, const void* ct,
                  const HalfGeom* geom, int n_cells, const void* rcm,
                  int rcm_t, int K, int ntypes, int group, double rc2,
                  double min_r2,
                  double mid, double inv_half, double u_hi, int needs_energy,
                  void* partial, void* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return f64 ? moments<double>(pos, types, valid, box, ct, nullptr, geom,
                               n_cells, rcm, rcm_t, K, ntypes, group, rc2,
                               min_r2, mid, inv_half, u_hi, needs_energy,
                               partial, out, s)
             : moments<float>(pos, types, valid, box, ct, nullptr, geom,
                              n_cells, rcm, rcm_t, K, ntypes, group, rc2,
                              min_r2, mid, inv_half, u_hi, needs_energy,
                              partial, out, s);
}

// Both passes over a group of `n` z-slab shards on one card (not to be
// confused with `group`, the types a type group holds): their buffers'
// arrays `pos`, `types` (or null when untyped), `valid` and `ct` (the
// cotangent's buffers) as host arrays of pointers, their first home
// layers `z0` and ring neighbours in the group `prev`, `next`, as
// htf_half_stencil_group takes them; `geom` a HalfGeom of their nzl;
// `partial` [n H][P * 2K] (H home cells a shard), its rows in the group's
// cell order; the rest as htf_proxy_bwd.
int htf_proxy_bwd_group(int f64, int n, const void* const* pos,
                        const void* const* types, const void* const* valid,
                        const void* const* ct, const int* z0,
                        const int* prev, const int* next, const void* box,
                        const HalfGeom* geom, const void* rcm, int rcm_t,
                        int K, int ntypes, int group, double rc2,
                        double min_r2, double mid, double inv_half,
                        double u_hi, int needs_energy, void* partial,
                        void* out, void* stream) {
  if (n < 1 || n > htf::kMaxGroup) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n_cells = n * geom->nzl * geom->nx * geom->ny;
  if (f64) {
    const auto tab =
        htf::group_tab<double>(n, pos, types, valid, z0, prev, next, ct);
    return moments<double>(nullptr, nullptr, nullptr, box, nullptr, &tab,
                           geom, n_cells, rcm, rcm_t, K, ntypes, group, rc2,
                           min_r2, mid, inv_half, u_hi, needs_energy,
                           partial, out, s);
  }
  const auto tab =
      htf::group_tab<float>(n, pos, types, valid, z0, prev, next, ct);
  return moments<float>(nullptr, nullptr, nullptr, box, nullptr, &tab, geom,
                        n_cells, rcm, rcm_t, K, ntypes, group, rc2, min_r2,
                        mid, inv_half, u_hi, needs_energy, partial, out, s);
}

const char* htf_proxy_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
