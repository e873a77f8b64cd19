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
// or out-of-reach slots are never walked. A lane is a pair (home row i,
// staged candidate j); the self pair is excluded by staged index. Each
// block writes its [P * 2K] partial sums; a second kernel sums them over
// cells in a fixed order. No float atomics, so the result is
// deterministic, and any P * 2K works (the Pallas kernel's one 128-lane
// output row capped 2K * P at 128).
//
// Untyped with K = 8 or 16 (the untyped train path: K = 16): the lanes
// are split over (row, candidate segment) pairs, each thread keeps its 2K
// moments in registers; at the end a warp shuffle tree per moment and the
// warps' partials in a fixed order give the block's sums.
//
// Typed proxies, and other K (the tile path): after the staging, one
// stable counting sort in shared memory orders the staged entries by type
// (cord: the entries of type 0, then of type 1, ...; within a type the
// rows come first, as they are the first n0 entries), so the rows of type
// a and the candidates of type b are two ranges of cord. A type pair
// (a, b), a <= b, is the tile of rows of a x candidates of b and, when
// a != b, the tile of rows of b x candidates of a: its lanes, numbered
// row-major, padded to whole warp steps of 32. The pairs' steps, in
// chebyshev.type_pairs order, are split into kWarps contiguous ranges,
// one a warp, so each step of a warp is one pair and its 32 lanes keep
// 2 x 16 moments (16 Chebyshev terms; a larger K takes several passes of
// 16) in registers. Where its pair changes, and at its end, a warp
// flushes: a reduce-scatter over the warp (31 shuffles) leaves moment m
// of the pair in lane m, written to the warp's own slot when it is the
// warp's first pair (which the warp before may share) and otherwise to
// the pair's row of the block's sums, which no other warp writes (the
// ranges are contiguous). The block's sum of a pair is its row plus the
// first-pair slots of the warps whose first pair it is, in warp order.
// Rows of a type outside the table, or lanes outside rc2_tab's cut, add
// nothing. The block stages once whatever T is: a T whose per-pair rows
// do not fit the block's shared memory beside the staging is summed in
// several passes over consecutive ranges of pairs (pair_train_cuda.
// pair_groups plans them, mirroring smem_bytes), each re-walking the
// sorted entries, not re-staging them.
//
// Group mode (the training backward under a mesh; GroupTab and ShardRows
// of half_stencil_stage.cuh, as K1's group launch): one launch pair over
// every home cell of the z-slab shards one card holds. Block c is home
// cell c - k H of shard k = c / H, staged from the shard's buffer, its
// candidates' cotangents read at their own slots: a halo cell's in place
// from the next shard's first home layer when that shard is in the group,
// else from the shard's halo rows (the next shard's cotangent there,
// where the reverse halo was added). The blocks run in the group's global
// cell order and share the block functions of the whole state's kernel,
// so the summing pass adds the same cells' sums in that order: a group of
// every shard gives the whole state's moments bit for bit, and groups on
// several cards give parts whose sum is the whole state's (each
// unordered pair belongs to one home cell's half stencil). A z-slab
// shard alone is the group of one with its halo layer.
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
// the register moments take twice the registers, and the staging's
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

// The tile path's Chebyshev terms a pass keeps in registers, and its
// moments a lane holds: a c and a cd moment a term, one a lane at a flush.
constexpr int kChunk = 16;
constexpr int kMom = 2 * kChunk;
static_assert(kMom == 32, "a flush leaves one moment in each lane");

template <class S>
__device__ __forceinline__ S warp_sum(S v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// One halving step of warp_transpose_sum: a lane keeps the half of
// v[0, 2H) that its bit H selects, adds the partner lane's copy of it and
// leaves the sums in v[0, H).
template <int H, class S>
__device__ __forceinline__ void halve(S (&v)[kMom], int lane) {
  const bool up = (lane & H) != 0;
#pragma unroll
  for (int i = 0; i < H; ++i) {
    const S keep = up ? v[i + H] : v[i];
    const S send = up ? v[i] : v[i + H];
    v[i] = keep + __shfl_xor_sync(0xffffffffu, send, H);
  }
}

// Reduce-scatter over the warp: returns the sum over the 32 lanes of
// v[lane], in five halving steps (31 shuffles in all).
template <class S>
__device__ __forceinline__ S warp_transpose_sum(S (&v)[kMom], int lane) {
  halve<16>(v, lane);
  halve<8>(v, lane);
  halve<4>(v, lane);
  halve<2>(v, lane);
  halve<1>(v, lane);
  return v[0];
}

// A warp's flush of its moments: dst[m] = the warp's sum of moment m,
// then the moments zeroed.
template <class S>
__device__ __forceinline__ void flush(S (&mom)[kMom], int lane, S* dst) {
  dst[lane] = warp_transpose_sum(mom, lane);
#pragma unroll
  for (int m = 0; m < kMom; ++m) mom[m] = S(0);
}

// The lane weights of (row q, candidate g) when d2 = |g - q|^2 is inside
// every cut: A (the c moments' weight, with energy), B and w of
// the file's header; false when the lane adds nothing.
template <class S, bool ENERGY>
__device__ __forceinline__ bool lane_weights(
    const Vec4<S>& q, const Vec4<S>& cq, const Vec4<S>& gj,
    const Vec4<S>* __restrict__ sct, int j, int n0, const S* __restrict__ rcm,
    int rcm_t, S rc2, S min_r2, S mid, S inv_half, S u_hi, S& A, S& B,
    S& w) {
  const S dx = gj.x - q.x;
  const S dy = gj.y - q.y;
  const S dz = gj.z - q.z;
  const S d2 = dx * dx + dy * dy + dz * dz;
  if (!(d2 <= rc2)) return false;
  if (rcm != nullptr) {
    const int ti = htf::unpack_type(q.w);
    const int tj = htf::unpack_type(gj.w);
    const bool known = ti >= 0 && ti < rcm_t && tj >= 0 && tj < rcm_t;
    const S prc2 = known ? rcm[ti * rcm_t + tj] : S(0);
    if (!(d2 <= prc2)) return false;
  }
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
  A = S(0);
  if (ENERGY) {
    S wE = cq.w;
    if (directed) wE = wE + cj.w;
    wE = S(0.5) * wE;
    A = wE;
    B = wE * over - wF * (u * u);
  } else {
    B = -wF * (u * u);
  }
  w = fmin_(fmax_((u - mid) * inv_half, S(-1)), S(1));
  return true;
}

// The shared arrays of a block: the staging's, then the tile path's.
template <class S>
struct Smem {
  Vec4<S>* spos;  // [C] staged entries
  Vec4<S>* sct;   // [C] their cotangents times valid
  int* stag;      // [C]
  unsigned char* scratch;
  S* wpart;       // register path: [kWarps][2K], tile path: [kWarps][kMom]
  S* acc;         // register path: [2K], tile path: [Q][kMom]
};

template <class S>
__device__ __forceinline__ Smem<S> smem_layout(int C, int M) {
  Smem<S> s;
  s.spos = htf::dynamic_smem<Vec4<S>>();
  s.sct = s.spos + C;
  s.stag = reinterpret_cast<int*>(s.sct + C);
  s.scratch = reinterpret_cast<unsigned char*>(s.stag + C);
  s.wpart = reinterpret_cast<S*>(s.scratch + htf::stage_bytes<S>());
  s.acc = s.wpart + kWarps * M;
  return s;
}

// Stage cell gc's half stencil and its cotangents; returns the entries.
template <class S, class Src>
__device__ __forceinline__ int stage(const Src& src, int gc,
                                     const S* __restrict__ box,
                                     const HalfGeom& g,
                                     S rc2, const Smem<S>& sm, int& n0) {
  Vec4<S>* sct = sm.sct;
  return htf::stage_rows<S>(
      g, gc, rc2, src, box, sm.spos, sm.stag, sm.scratch, n0,
      [&](int k, int code, size_t slot) {
        const Vec4<S> v = static_cast<const Vec4<S>*>(src.a(code))[slot];
        const S w = src.v(code)[slot];
        sct[k] = htf::vec4(v.x * w, v.y * w, v.z * w, v.w * w);
      },
      htf::NoSkip());
}

// The register path (untyped, K = KR = 8 or 16): the moments of global
// home cell `gc`, its rows, valid and cotangent (aux) read where `src`
// keeps them (OneBuffer, ShardRows), written as row `c` of `partial`.
template <class S, bool ENERGY, int KR, class Src>
__device__ __forceinline__ void register_block(
    const Src& src, int gc, int c, const S* __restrict__ box,
    const HalfGeom& g,
    const S* __restrict__ rcm, int rcm_t, S rc2, S min_r2, S mid,
    S inv_half, S u_hi, S* __restrict__ partial) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  constexpr int M = 2 * KR;
  const Smem<S> sm = smem_layout<S>(kHalf * g.cap, M);
  int n0;
  const int total = stage(src, gc, box, g, rc2, sm, n0);

  S mom[M];
#pragma unroll
  for (int m = 0; m < M; ++m) mom[m] = S(0);

  for (int r0 = 0; r0 < n0; r0 += kThreads) {
    const htf::RowSplit sp(r0, n0);
    if (!sp.active) continue;
    const Vec4<S> q = sm.spos[sp.row];
    const Vec4<S> cq = sm.sct[sp.row];
    for (int j = sp.seg; j < total; j += sp.nseg) {
      if (j == sp.row) continue;  // the self pair (block 0)
      S A, B, w;
      if (!lane_weights<S, ENERGY>(q, cq, sm.spos[j], sm.sct, j, n0, rcm,
                                   rcm_t, rc2, min_r2, mid, inv_half, u_hi,
                                   A, B, w))
        continue;
      const S two_w = S(2) * w;
      S t_prev = S(1), t_cur = w;
#pragma unroll
      for (int k = 0; k < KR; ++k) {
        const S t_k = k == 0 ? t_prev : t_cur;
        if (ENERGY) mom[k] += A * t_k;
        mom[KR + k] += B * t_k;
        if (k >= 1) {
          const S t_next = two_w * t_cur - t_prev;
          t_prev = t_cur;
          t_cur = t_next;
        }
      }
    }
  }

#pragma unroll
  for (int m = 0; m < M; ++m) {
    const S v = warp_sum(mom[m]);
    if (lane == 0) sm.wpart[warp * M + m] = v;
  }
  __syncthreads();
  for (int i = tid; i < M; i += kThreads) {
    S v = S(0);
    for (int w = 0; w < kWarps; ++w) v += sm.wpart[w * M + i];
    partial[static_cast<size_t>(c) * M + i] = v;
  }
}

// The tile path's integer arrays, after its [Q][kMom] sums: the sorted
// entries, per sort key (a type, or T for a type outside the table) the
// entries, the rows, a running offset, the offsets (NB + 1) and per warp
// a chunk's counts; per pair of a pass its first step (Q + 1) and its
// types; per warp its first pair.
struct TileInts {
  int *cord, *cnt, *nrow, *run, *coff, *wcnt, *pstart, *pab, *fq;
};

__device__ __forceinline__ TileInts tile_ints(int* base, int C, int NB,
                                              int Q) {
  TileInts t;
  t.cord = base;
  t.cnt = t.cord + C;
  t.nrow = t.cnt + NB;
  t.run = t.nrow + NB;
  t.coff = t.run + NB;
  t.wcnt = t.coff + NB + 1;
  t.pstart = t.wcnt + kWarps * NB;
  t.pab = t.pstart + Q + 1;
  t.fq = t.pab + Q;
  return t;
}

// A staged entry's sort key: its type, T when outside the table (it adds
// nothing); 0 for every entry when untyped.
template <class S>
__device__ __forceinline__ int sort_key(const Vec4<S>& e, int T) {
  if (T == 1) return 0;
  const int t = htf::unpack_type(e.w);
  return (t >= 0 && t < T) ? t : T;
}

// The lanes of type pair (a, b): rows of a x candidates of b, and rows of
// b x candidates of a when a != b.
__device__ __forceinline__ int pair_lanes(const TileInts& ti, int a, int b) {
  const int n1 = ti.nrow[a] * ti.cnt[b];
  return a == b ? n1 : n1 + ti.nrow[b] * ti.cnt[a];
}

// The tile path: as register_block, for T types (T = 1: untyped with
// another K), the type pairs in passes of Q.
template <class S, bool ENERGY, class Src>
__device__ __forceinline__ void tile_block(
    const Src& src, int gc, int c, const S* __restrict__ box,
    const HalfGeom& g,
    const S* __restrict__ rcm, int rcm_t, int K, int T, int Q, S rc2,
    S min_r2, S mid, S inv_half, S u_hi, S* __restrict__ partial) {
  const int C = kHalf * g.cap;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int K2 = 2 * K;
  const int P = T * (T + 1) / 2;
  const int M_all = P * K2;
  const int NB = T + 1;
  const Smem<S> sm = smem_layout<S>(C, kMom);
  const TileInts ti =
      tile_ints(reinterpret_cast<int*>(sm.acc + Q * kMom), C, NB, Q);

  for (int i = tid; i < NB; i += kThreads) ti.cnt[i] = ti.nrow[i] = 0;
  for (int i = tid; i < kWarps * NB; i += kThreads) ti.wcnt[i] = 0;
  int n0;
  const int total = stage(src, gc, box, g, rc2, sm, n0);  // ends in a barrier

  // the counting sort: the keys' counts (warp-aggregated integer adds),
  // their offsets, then the entries placed chunk by chunk in staged order
  for (int s0 = 0; s0 < total; s0 += kThreads) {
    const int k = s0 + tid;
    const int key = k < total ? sort_key(sm.spos[k], T) : NB;
    const unsigned peers = __match_any_sync(0xffffffffu, key);
    const unsigned rows = peers & __ballot_sync(0xffffffffu, k < n0);
    if (key < NB && (peers & ((1u << lane) - 1u)) == 0) {
      atomicAdd(&ti.cnt[key], __popc(peers));
      if (rows) atomicAdd(&ti.nrow[key], __popc(rows));
    }
  }
  __syncthreads();
  if (tid == 0) {
    int o = 0;
    for (int t = 0; t < NB; ++t) {
      ti.coff[t] = ti.run[t] = o;
      o += ti.cnt[t];
    }
    ti.coff[NB] = o;
  }
  __syncthreads();
  for (int s0 = 0; s0 < total; s0 += kThreads) {
    const int k = s0 + tid;
    const int key = k < total ? sort_key(sm.spos[k], T) : NB;
    const unsigned peers = __match_any_sync(0xffffffffu, key);
    const int rank = __popc(peers & ((1u << lane) - 1u));
    if (key < T && rank == 0) ti.wcnt[warp * NB + key] = __popc(peers);
    __syncthreads();
    if (key < T) {
      int before = 0;
      for (int w = 0; w < warp; ++w) before += ti.wcnt[w * NB + key];
      ti.cord[ti.run[key] + before + rank] = k;
    }
    __syncthreads();
    for (int t = tid; t < T; t += kThreads) {
      int s = 0;
      for (int w = 0; w < kWarps; ++w) {
        s += ti.wcnt[w * NB + t];
        ti.wcnt[w * NB + t] = 0;
      }
      ti.run[t] += s;
    }
    __syncthreads();
  }

  for (int p0 = 0; p0 < P; p0 += Q) {
    const int Qr = min(Q, P - p0);
    // this pass's pairs: their types and first steps (a warp-wide scan)
    if (warp == 0) {
      int carry = 0;
      for (int q0 = 0; q0 < Qr; q0 += 32) {
        const int q = q0 + lane;
        int steps = 0;
        if (q < Qr) {
          int a = 0, l = p0 + q;
          while (l >= T - a) {  // type a pairs with a .. T - 1
            l -= T - a;
            ++a;
          }
          const int b = a + l;
          ti.pab[q] = a | (b << 16);
          steps = (pair_lanes(ti, a, b) + 31) >> 5;
        }
        int incl = steps;
#pragma unroll
        for (int off = 1; off < 32; off <<= 1) {
          const int o = __shfl_up_sync(0xffffffffu, incl, off);
          if (lane >= off) incl += o;
        }
        if (q < Qr) ti.pstart[q] = carry + incl - steps;
        carry += __shfl_sync(0xffffffffu, incl, 31);
      }
      if (lane == 0) ti.pstart[Qr] = carry;
    }
    __syncthreads();
    const int n_steps = ti.pstart[Qr];
    const int s_begin = static_cast<int>(
        static_cast<long>(n_steps) * warp / kWarps);
    const int s_end = static_cast<int>(
        static_cast<long>(n_steps) * (warp + 1) / kWarps);

    for (int k0 = 0; k0 < K; k0 += kChunk) {
      for (int i = tid; i < Qr * kMom; i += kThreads) sm.acc[i] = S(0);
      if (tid < kWarps) ti.fq[tid] = -1;
      __syncthreads();

      S mom[kMom];
#pragma unroll
      for (int m = 0; m < kMom; ++m) mom[m] = S(0);
      int q = -1;
      int first = -1;
      // the current pair: its types' row and candidate ranges in cord
      int ra = 0, rb = 0, ca = 0, cb = 0, nca = 1, ncb = 1, n1 = 0, nl = 0;
      for (int s = s_begin; s < s_end; ++s) {
        if (q < 0 || s >= ti.pstart[q + 1]) {
          if (q >= 0)
            flush(mom, lane, q == first ? sm.wpart + warp * kMom
                                        : sm.acc + q * kMom);
          if (q < 0) q = 0;
          while (s >= ti.pstart[q + 1]) ++q;
          if (first < 0) {
            first = q;
            if (lane == 0) ti.fq[warp] = q;
          }
          const int a = ti.pab[q] & 0xffff, b = ti.pab[q] >> 16;
          ra = ti.coff[a];
          rb = ti.coff[b];
          ca = ti.coff[a];
          cb = ti.coff[b];
          nca = max(ti.cnt[a], 1);
          ncb = max(ti.cnt[b], 1);
          n1 = ti.nrow[a] * ti.cnt[b];
          nl = pair_lanes(ti, a, b);
        }
        int l = (s - ti.pstart[q]) * 32 + lane;
        if (l >= nl) continue;
        int i, j;
        if (l < n1) {
          i = ti.cord[ra + l / ncb];
          j = ti.cord[cb + l % ncb];
        } else {
          l -= n1;
          i = ti.cord[rb + l / nca];
          j = ti.cord[ca + l % nca];
        }
        if (j == i) continue;  // the self pair
        S A, B, w;
        if (!lane_weights<S, ENERGY>(sm.spos[i], sm.sct[i], sm.spos[j],
                                     sm.sct, j, n0, rcm, rcm_t, rc2, min_r2,
                                     mid, inv_half, u_hi, A, B, w))
          continue;
        const S two_w = S(2) * w;
        S t_k = S(1), t_next = w;  // T_k and T_{k+1}
        for (int k = 0; k < k0; ++k) {
          const S t = two_w * t_next - t_k;
          t_k = t_next;
          t_next = t;
        }
#pragma unroll
        for (int m = 0; m < kChunk; ++m) {
          if (k0 + m < K) {
            if (ENERGY) mom[m] += A * t_k;
            mom[kChunk + m] += B * t_k;
          }
          if (m + 1 < kChunk) {
            const S t = two_w * t_next - t_k;
            t_k = t_next;
            t_next = t;
          }
        }
      }
      if (q >= 0)
        flush(mom, lane,
              q == first ? sm.wpart + warp * kMom : sm.acc + q * kMom);
      __syncthreads();

      // the block's sums of this pass's pairs: a pair's row, then the
      // first-pair slots of the warps that start on it, in warp order
      for (int i = tid; i < Qr * kMom; i += kThreads) {
        const int qq = i / kMom;
        const int m = i - qq * kMom;
        const int k = k0 + (m < kChunk ? m : m - kChunk);
        if (k >= K) continue;
        S v = sm.acc[i];
        for (int w = 0; w < kWarps; ++w)
          if (ti.fq[w] == qq) v += sm.wpart[w * kMom + m];
        const int col = (p0 + qq) * K2 + (m < kChunk ? k : K + k);
        partial[static_cast<size_t>(c) * M_all + col] = v;
      }
      __syncthreads();
    }
  }
}

// The block of global home cell `gc`, written as row `c` of `partial`:
// the register path (KR = 8, 16) or the tile path (KR = 0).
template <class S, bool ENERGY, int KR, class Src>
__device__ __forceinline__ void moments_block(
    const Src& src, int gc, int c, const S* __restrict__ box,
    const HalfGeom& g,
    const S* __restrict__ rcm, int rcm_t, int K, int T, int Q, S rc2,
    S min_r2, S mid, S inv_half, S u_hi, S* __restrict__ partial) {
  if constexpr (KR > 0)
    register_block<S, ENERGY, KR>(src, gc, c, box, g, rcm, rcm_t, rc2,
                                  min_r2, mid, inv_half, u_hi, partial);
  else
    tile_block<S, ENERGY>(src, gc, c, box, g, rcm, rcm_t, K, T, Q, rc2,
                          min_r2, mid, inv_half, u_hi, partial);
}

// One block per home cell of a whole state.
template <class S, bool ENERGY, int KR>
__global__ void __launch_bounds__(kThreads)
proxy_bwd_kernel(const S* __restrict__ pos, const int* __restrict__ types,
                 const S* __restrict__ valid, const S* __restrict__ box,
                 const Vec4<S>* __restrict__ ct, HalfGeom g,
                 const S* __restrict__ rcm, int rcm_t, int K, int T,
                 int Q, S rc2, S min_r2, S mid, S inv_half, S u_hi,
                 S* __restrict__ partial) {
  const int c = blockIdx.x;
  moments_block<S, ENERGY, KR>(htf::OneBuffer<S>{pos, types, valid, ct}, c,
                               c, box, g, rcm, rcm_t, K, T, Q, rc2, min_r2,
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
                       int Q, S rc2, S min_r2, S mid, S inv_half, S u_hi,
                       S* __restrict__ partial) {
  const int c = blockIdx.x;
  const int H = g.nzl * g.nx * g.ny;
  const int k = c / H;
  moments_block<S, ENERGY, KR>(htf::ShardRows<S>(tab, k),
                               tab.z0[k] * g.nx * g.ny + (c - k * H), c, box,
                               g, rcm, rcm_t, K, T, Q, rc2, min_r2, mid,
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

// The register-moment degree for (K, T), or 0 for the tile path.
int register_degree(int K, int T) {
  if (T != 1) return 0;
  return (K == 8 || K == 16) ? K : 0;
}

// A block's bytes for T types, Q type pairs a pass on the tile path.
// pair_train_cuda.py mirrors this formula.
template <class S>
long smem_bytes(int cap, int K, int T, int Q) {
  const long C = static_cast<long>(kHalf) * cap;
  const long staging = C * (2 * sizeof(Vec4<S>) + sizeof(int)) +
                       htf::stage_bytes<S>();
  if (register_degree(K, T)) {
    const long M = 2L * K;
    return staging + static_cast<long>(sizeof(S)) * (kWarps * M + M);
  }
  const long NB = T + 1;
  const long ints = C + 4 * NB + 1 + kWarps * NB + 2L * Q + 1 + kWarps;
  return staging + static_cast<long>(sizeof(S)) * (kWarps + Q) * kMom +
         4 * ints;
}

// The call's arguments, typed: the wrapper hands the arrays over as
// void * and the scalars as double.
template <class S>
struct Args {
  const S *pos, *valid, *box, *rcm;
  const int* types;
  const Vec4<S>* ct;
  int rcm_t, K, T, Q;
  S rc2, min_r2, mid, inv_half, u_hi;
  S* partial;
};

// A launch's shards: null for a whole state (Args' arrays), else the
// group's table (its cotangent in the aux arrays).
template <class S, bool ENERGY, int KR>
int launch_moments(const Args<S>& a, const htf::GroupTab<S>* tab,
                   const HalfGeom& g, int n_cells, cudaStream_t s) {
  const long smem = smem_bytes<S>(g.cap, a.K, a.T, a.Q);
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
  if (tab)
    group<<<n_cells, kThreads, smem, s>>>(
        *tab, a.box, g, a.rcm, a.rcm_t, a.K, a.T, a.Q, a.rc2, a.min_r2,
        a.mid, a.inv_half, a.u_hi, a.partial);
  else
    kernel<<<n_cells, kThreads, smem, s>>>(
        a.pos, a.types, a.valid, a.box, a.ct, g, a.rcm, a.rcm_t, a.K, a.T,
        a.Q, a.rc2, a.min_r2, a.mid, a.inv_half, a.u_hi, a.partial);
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
            int K, int ntypes, int pairs, double rc2, double min_r2,
            double mid, double inv_half, double u_hi, int needs_energy,
            void* partial, void* out, cudaStream_t s) {
  const HalfGeom g = *geom;
  const int P = ntypes * (ntypes + 1) / 2;
  const Args<S> a{static_cast<const S*>(pos), static_cast<const S*>(valid),
                  static_cast<const S*>(box), static_cast<const S*>(rcm),
                  types, static_cast<const Vec4<S>*>(ct), rcm_t, K, ntypes,
                  pairs < 1 || pairs > P ? P : pairs, static_cast<S>(rc2),
                  static_cast<S>(min_r2), static_cast<S>(mid),
                  static_cast<S>(inv_half), static_cast<S>(u_hi),
                  static_cast<S*>(partial)};
  if (a.T > 0xffff) return cudaErrorInvalidValue;  // the pairs' packed types
  const int M = P * 2 * K;
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
// double instantiation) for `ntypes` types, `pairs` type pairs a pass.
long htf_proxy_bwd_smem(int f64, int cap, int K, int ntypes, int pairs) {
  return f64 ? smem_bytes<double>(cap, K, ntypes, pairs)
             : smem_bytes<float>(cap, K, ntypes, pairs);
}

// Launch both passes on `stream`: per-cell partial sums into `partial`
// ([n_cells][P * 2K] scratch), then their sum into `out` ([P * 2K], per
// pair p: c-moments at p * 2K + k, cd-moments at p * 2K + K + k). `f64`
// picks the scalar type of every floating array: float32 (0) or float64
// (1). `pos` [n_slots][3], `types` [n_slots] int32 (or null when untyped),
// `valid` [n_slots], `box` the [3][3] box (rows low, high, tilt) on the
// card, `ct` the [n_slots][4] cotangent, `geom` a host HalfGeom, `pairs`
// the type pairs a block sums in one pass (>= P: all at once); the scalars
// are rounded to the scalar type. Returns cudaGetLastError() after the
// launches (0 = ok).
int htf_proxy_bwd(int f64, const void* pos, const int* types,
                  const void* valid, const void* box, const void* ct,
                  const HalfGeom* geom, int n_cells, const void* rcm,
                  int rcm_t, int K, int ntypes, int pairs, double rc2,
                  double min_r2,
                  double mid, double inv_half, double u_hi, int needs_energy,
                  void* partial, void* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return f64 ? moments<double>(pos, types, valid, box, ct, nullptr, geom,
                               n_cells, rcm, rcm_t, K, ntypes, pairs, rc2,
                               min_r2, mid, inv_half, u_hi, needs_energy,
                               partial, out, s)
             : moments<float>(pos, types, valid, box, ct, nullptr, geom,
                              n_cells, rcm, rcm_t, K, ntypes, pairs, rc2,
                              min_r2, mid, inv_half, u_hi, needs_energy,
                              partial, out, s);
}

// Both passes over a group of `n` z-slab shards on one card: their
// buffers' arrays `pos`, `types` (or null when untyped), `valid` and `ct`
// (the cotangent's buffers) as host arrays of pointers, their first home
// layers `z0` and ring neighbours in the group `prev`, `next`, as
// htf_half_stencil_group takes them; `geom` a HalfGeom of their nzl;
// `partial` [n H][P * 2K] (H home cells a shard), its rows in the group's
// cell order; the rest as htf_proxy_bwd.
int htf_proxy_bwd_group(int f64, int n, const void* const* pos,
                        const void* const* types, const void* const* valid,
                        const void* const* ct, const int* z0,
                        const int* prev, const int* next, const void* box,
                        const HalfGeom* geom, const void* rcm, int rcm_t,
                        int K, int ntypes, int pairs, double rc2,
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
                           geom, n_cells, rcm, rcm_t, K, ntypes, pairs, rc2,
                           min_r2, mid, inv_half, u_hi, needs_energy,
                           partial, out, s);
  }
  const auto tab =
      htf::group_tab<float>(n, pos, types, valid, z0, prev, next, ct);
  return moments<float>(nullptr, nullptr, nullptr, box, nullptr, &tab, geom,
                        n_cells, rcm, rcm_t, K, ntypes, pairs, rc2, min_r2,
                        mid, inv_half, u_hi, needs_energy, partial, out, s);
}

const char* htf_proxy_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
