// The tile both BFS admit-plane kernels share (csrc/bfs_prune.cu,
// csrc/bfs_prune_streamed.cu): one copy of the arithmetic that the two
// must agree on bit for bit.
//
//   admit[x, q] = BL_in(x) ⊆ BL_in(v_q) ∧ BL_out(v_q) ⊆ BL_out(x)
//                 ∧ ¬(fresh_q ∧ DL_out(u_q) ∩ DL_in(x) ≠ ∅)
//
// folds into one accumulator per (x, q), one 3-input logic op (LOP3) per
// word and test:
//
//   acc |= BL_in(x) & ~BL_in(v_q);  acc |= BL_out(v_q) & ~BL_out(x);
//   acc |= DL_out(u_q) & DL_in(x);  admit = (acc == 0)
//
// The freshness gate leaves the inner loop: when a lane's query-side words
// are staged, a stale lane's DL_out(u_q) words are written as zeros, which
// makes its DL term vanish without a branch.
//
// The lane side is staged once per block: the block's threads gather its
// lanes' query-side words, one lane a thread, into shared memory,
// word-major (word w of lane l at w * stride + l), with the freshness
// folded in (`Tile::stage`).  A thread owns a group of L consecutive
// lanes (L = 4 or 8); FixedTile copies their 2*WB + WD words from shared
// memory into registers with 16-byte loads and keeps them there for the
// thread's whole life.  The thread walks vertex rows; for each it reads
// the row's words once (vector loads where aligned), computes L bytes,
// packs them into L / 4 32-bit words and stores them with one 32- or
// 64-bit store where Q allows (Q % L == 0), else byte by byte.
//
// Launch geometry (the wrappers compute it, `AdmitGeometry` in
// kernels/bfs_prune/bfs_prune.py, and test its coverage on the CPU):
// thread t of a block takes lane group  span * slab + t % span  and row
// offset  t / span  (idle when >= rows or the group is past the last); a
// block stages the span * L lanes of its slab.
//
// FixedTile<WB, WD, L> holds compile-time widths (W in 1..4, k <= 128):
// its word loops unroll fully.  RuntimeTile<L> takes any other width and
// loops at run time, reading the lane words from shared memory per row.
// `dispatch` compiles only the (widths, L) pairs the wrapper picks: 4
// lanes for every width, 8 for the grid kernel's narrow lane sides.
#pragma once

#include <cstddef>
#include <cstdint>
#include <cuda_runtime.h>

namespace admit {

struct Planes {
  const int* bl_in;
  const int* bl_out;
  const int* dl_in;
  const int* dl_out;
  int wb, wd, n_cap;
};

// Launch geometry, in the order of the wrapper's AdmitGeometry fields.
struct Geometry {
  int groups;    // lane groups per row: ceil(Q / L)
  int span;      // lane groups one block covers
  int rows;      // rows one block covers per step: threads / span
  int slabs;     // ceil(groups / span); the grid kernel's blockIdx.y
  int n_block;   // the streamed kernel's rows per chunk (0 for the grid)
  int pack;      // Q % L == 0 and the output aligned: packed stores
  int vec;       // the planes' bases 16-byte aligned: vector loads
};

__device__ __forceinline__ int clamp_id(int x, int n) {
  return x < 0 ? 0 : (x >= n ? n - 1 : x);
}

// The grid kernel's freshness: m_cut / d_cut against their totals.
struct CutFresh {
  const int* m_cut;
  int m_total;
  const int* d_cut;
  int d_total;
  __device__ __forceinline__ bool operator()(int l) const {
    if (m_cut == nullptr) return true;
    bool on = __ldg(m_cut + l) >= m_total;
    if (d_cut != nullptr) on = on && __ldg(d_cut + l) >= d_total;
    return on;
  }
};

// The streamed kernel's pre-combined 0/1 freshness row (NULL: all fresh).
struct RowFresh {
  const int* fresh;
  __device__ __forceinline__ bool operator()(int l) const {
    return fresh == nullptr || __ldg(fresh + l) != 0;
  }
};

// W words of one row into registers: from global memory through the
// read-only path (GLOBAL) or from shared memory; 8- or 16-byte loads when
// the row is aligned for them (vec).
template <int W, bool GLOBAL>
__device__ __forceinline__ void load_words(int (&dst)[W], const int* p,
                                           bool vec) {
  if constexpr (W % 4 == 0) {
    if (vec) {
#pragma unroll
      for (int w = 0; w < W; w += 4) {
        const int4 t = GLOBAL ? __ldg(reinterpret_cast<const int4*>(p + w))
                              : *reinterpret_cast<const int4*>(p + w);
        dst[w] = t.x; dst[w + 1] = t.y; dst[w + 2] = t.z; dst[w + 3] = t.w;
      }
      return;
    }
  } else if constexpr (W % 2 == 0) {
    if (vec) {
#pragma unroll
      for (int w = 0; w < W; w += 2) {
        const int2 t = GLOBAL ? __ldg(reinterpret_cast<const int2*>(p + w))
                              : *reinterpret_cast<const int2*>(p + w);
        dst[w] = t.x; dst[w + 1] = t.y;
      }
      return;
    }
  }
#pragma unroll
  for (int w = 0; w < W; ++w) dst[w] = GLOBAL ? __ldg(p + w) : p[w];
}

// Byte i % 4 of word i / 4 is (acc[i] == 0): 0x01010101 less each
// accumulator clamped to 0/1 at its byte (no byte borrows).  ptxas folds
// the zero test into the last logic op's predicate output, so a lane's
// byte costs about one select and one add beyond its LOP3s.
template <int L>
__device__ __forceinline__ void pack_admit(const uint32_t (&acc)[L],
                                           uint32_t (&out)[L / 4]) {
#pragma unroll
  for (int k = 0; k < L / 4; ++k) {
    uint32_t w = 0x01010101u;
#pragma unroll
    for (int i = 0; i < 4; ++i) w -= min(acc[4 * k + i], 1u) << (8 * i);
    out[k] = w;
  }
}

template <int WB, int WD, int L>
struct FixedTile {
  static constexpr int kLanes = L;
  int bi[L][WB], bo[L][WB], dq[L][WD];

  // One vertex row's words.
  struct Row {
    int bi[WB], bo[WB], di[WD];
  };

  // The query-side words of lanes [l0, l0 + nl) into s, word-major with
  // row stride `stride`: BL_in(v_l) words, then BL_out(v_l), then
  // DL_out(u_l) (zeros for a stale lane).  One lane per thread of the
  // block, so the ids and then the lane's rows are two dependent loads.
  // Ids are clamped, so a dead lane u = n_cap reads the last row.
  template <class Fresh>
  static __device__ __forceinline__ void stage(int* s, int stride,
                                               const Planes& P,
                                               const int* u, const int* v,
                                               int l0, int nl,
                                               const Fresh& fresh, bool vec) {
    for (int li = threadIdx.x; li < nl; li += blockDim.x) {
      const int l = l0 + li;
      const size_t vv = clamp_id(__ldg(v + l), P.n_cap);
      const size_t uu = clamp_id(__ldg(u + l), P.n_cap);
      const int keep = fresh(l) ? -1 : 0;
      int b[WB], o[WB], d[WD];
      load_words<WB, true>(b, P.bl_in + vv * WB, vec);
      load_words<WB, true>(o, P.bl_out + vv * WB, vec);
      load_words<WD, true>(d, P.dl_out + uu * WD, vec);
#pragma unroll
      for (int w = 0; w < WB; ++w) {
        s[w * stride + li] = b[w];
        s[(WB + w) * stride + li] = o[w];
      }
#pragma unroll
      for (int w = 0; w < WD; ++w)
        s[(2 * WB + w) * stride + li] = d[w] & keep;
    }
  }

  // Lanes li0 .. li0 + L - 1 of a staged lane side (stride and li0
  // multiples of 4, s 16-byte aligned): 16-byte loads, conflict-free.
  __device__ __forceinline__ void load_lanes(const Planes&, const int* s,
                                             int stride, int li0) {
#pragma unroll
    for (int w = 0; w < 2 * WB + WD; ++w) {
#pragma unroll
      for (int i = 0; i < L; i += 4) {
        const int4 t =
            *reinterpret_cast<const int4*>(s + w * stride + li0 + i);
        const int x[4] = {t.x, t.y, t.z, t.w};
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          if (w < WB) bi[i + k][w] = x[k];
          else if (w < 2 * WB) bo[i + k][w - WB] = x[k];
          else dq[i + k][w - 2 * WB] = x[k];
        }
      }
    }
  }

  template <bool VEC>
  __device__ __forceinline__ Row load_global(const Planes& P, int x) const {
    Row r;
    load_words<WB, true>(r.bi, P.bl_in + (size_t)x * WB, VEC);
    load_words<WB, true>(r.bo, P.bl_out + (size_t)x * WB, VEC);
    load_words<WD, true>(r.di, P.dl_in + (size_t)x * WD, VEC);
    return r;
  }

  // Row xl of a shared-memory chunk laid out [BL_in | BL_out | DL_in],
  // each nb rows (16-byte aligned spans, so rows align for vector loads).
  __device__ __forceinline__ Row load_shared(const int* s, int nb,
                                             int xl) const {
    Row r;
    load_words<WB, false>(r.bi, s + xl * WB, true);
    load_words<WB, false>(r.bo, s + nb * WB + xl * WB, true);
    load_words<WD, false>(r.di, s + 2 * nb * WB + xl * WD, true);
    return r;
  }

  __device__ __forceinline__ void admit(const Row& x,
                                        uint32_t (&out)[L / 4]) const {
    uint32_t acc[L];
#pragma unroll
    for (int i = 0; i < L; ++i) {
      acc[i] = 0;
#pragma unroll
      for (int w = 0; w < WB; ++w) {
        acc[i] |= x.bi[w] & ~bi[i][w];
        acc[i] |= bo[i][w] & ~x.bo[w];
      }
#pragma unroll
      for (int w = 0; w < WD; ++w) acc[i] |= dq[i][w] & x.di[w];
    }
    pack_admit<L>(acc, out);
  }
};

// Any other width: each thread keeps a pointer to its lanes' words in the
// staged lane side and reads them per row (shared-memory broadcasts within
// a lane group).
template <int L>
struct RuntimeTile {
  static constexpr int kLanes = L;
  const int* s;
  int stride, wb, wd;

  struct Row {
    const int* bi;
    const int* bo;
    const int* di;
  };

  template <class Fresh>
  static __device__ __forceinline__ void stage(int* s, int stride,
                                               const Planes& P,
                                               const int* u, const int* v,
                                               int l0, int nl,
                                               const Fresh& fresh, bool) {
    for (int li = threadIdx.x; li < nl; li += blockDim.x) {
      const int l = l0 + li;
      const size_t vv = clamp_id(__ldg(v + l), P.n_cap);
      const size_t uu = clamp_id(__ldg(u + l), P.n_cap);
      const int keep = fresh(l) ? -1 : 0;
      for (int w = 0; w < P.wb; ++w) {
        s[w * stride + li] = __ldg(P.bl_in + vv * P.wb + w);
        s[(P.wb + w) * stride + li] = __ldg(P.bl_out + vv * P.wb + w);
      }
      for (int w = 0; w < P.wd; ++w)
        s[(2 * P.wb + w) * stride + li] =
            __ldg(P.dl_out + uu * P.wd + w) & keep;
    }
  }

  __device__ __forceinline__ void load_lanes(const Planes& P,
                                             const int* lanes, int str,
                                             int li0) {
    s = lanes + li0;
    stride = str;
    wb = P.wb;
    wd = P.wd;
  }

  template <bool VEC>
  __device__ __forceinline__ Row load_global(const Planes& P, int x) const {
    return {P.bl_in + (size_t)x * P.wb, P.bl_out + (size_t)x * P.wb,
            P.dl_in + (size_t)x * P.wd};
  }

  __device__ __forceinline__ Row load_shared(const int* r, int nb,
                                             int xl) const {
    return {r + xl * wb, r + nb * wb + xl * wb, r + 2 * nb * wb + xl * wd};
  }

  __device__ __forceinline__ void admit(const Row& x,
                                        uint32_t (&out)[L / 4]) const {
    uint32_t acc[L];
#pragma unroll
    for (int i = 0; i < L; ++i) acc[i] = 0;
    for (int w = 0; w < wb; ++w) {
      const int xbi = x.bi[w], xbo = x.bo[w];
      const int* bi = s + w * stride;
      const int* bo = s + (wb + w) * stride;
#pragma unroll
      for (int i = 0; i < L; ++i) {
        acc[i] |= xbi & ~bi[i];
        acc[i] |= bo[i] & ~xbo;
      }
    }
    for (int w = 0; w < wd; ++w) {
      const int xdi = x.di[w];
      const int* dq = s + (2 * wb + w) * stride;
#pragma unroll
      for (int i = 0; i < L; ++i) acc[i] |= dq[i] & xdi;
    }
    pack_admit<L>(acc, out);
  }
};

// The L bytes of one (row, lane group) at dst = out + x * Q + lane0:
// one 32- or 64-bit store when packed, else the `valid` (< L at the ragged
// end of a row) bytes one by one.
template <int L>
__device__ __forceinline__ void store_bytes(int8_t* dst,
                                            const uint32_t (&w)[L / 4],
                                            int valid, bool pack) {
  if (pack) {
    if constexpr (L == 8)
      *reinterpret_cast<uint2*>(dst) = make_uint2(w[0], w[1]);
    else
      *reinterpret_cast<uint32_t*>(dst) = w[0];
  } else {
#pragma unroll
    for (int i = 0; i < L; ++i)
      if (i < valid)
        dst[i] = static_cast<int8_t>((w[i / 4] >> (8 * (i & 3))) & 0xff);
  }
}

// launch(FixedTile<B, D, lanes>{}) for the lane counts the wrapper's
// `lanes_per_thread` can return: 8 only where EIGHT (the grid kernel) and
// the lane side is 2*B + D <= 6 words, else 4.  Any other lane count is
// not compiled and returns cudaErrorInvalidValue.
template <int B, int D, bool EIGHT, class Launch>
int launch_fixed(int lanes, Launch& launch) {
  if (lanes == 4) return launch(FixedTile<B, D, 4>{});
  if constexpr (EIGHT && 2 * B + D <= 6)
    if (lanes == 8) return launch(FixedTile<B, D, 8>{});
  return static_cast<int>(cudaErrorInvalidValue);
}

// Calls launch(Tile{}) with the tile instance for (wb, wd, lanes): the
// compile-time widths for W in 1..4, else the run-time-width tile (four
// lanes a thread).
template <bool EIGHT, class Launch>
int dispatch(int wb, int wd, int lanes, Launch&& launch) {
#define ADMIT_CASE(B, D) \
  case (B) * 8 + (D): return launch_fixed<B, D, EIGHT>(lanes, launch);
  if (wb >= 1 && wb <= 4 && wd >= 1 && wd <= 4) {
    switch (wb * 8 + wd) {
      ADMIT_CASE(1, 1) ADMIT_CASE(1, 2) ADMIT_CASE(1, 3) ADMIT_CASE(1, 4)
      ADMIT_CASE(2, 1) ADMIT_CASE(2, 2) ADMIT_CASE(2, 3) ADMIT_CASE(2, 4)
      ADMIT_CASE(3, 1) ADMIT_CASE(3, 2) ADMIT_CASE(3, 3) ADMIT_CASE(3, 4)
      ADMIT_CASE(4, 1) ADMIT_CASE(4, 2) ADMIT_CASE(4, 3) ADMIT_CASE(4, 4)
      default: break;
    }
  }
#undef ADMIT_CASE
  if (lanes == 4) return launch(RuntimeTile<4>{});
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace admit
