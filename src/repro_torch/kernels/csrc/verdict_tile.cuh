// The tile both label-verdict kernels share (csrc/dbl_query.cu,
// csrc/dbl_query_streamed.cu): one copy of the arithmetic the two must
// agree on bit for bit (paper Alg 2 lines 6-13).
//
// One lane (u, v) reads eight label rows, DL_out(u), DL_in(v), DL_out(v),
// DL_in(u) of W_dl words and BL_in(u), BL_in(v), BL_out(u), BL_out(v) of
// W_bl words, and folds them into three accumulators, one 3-input logic
// op (LOP3) per word and test:
//
//   lem1 |= DL_out(u) & DL_in(v)                       Lemma 1: reachable
//   thm  |= DL_out(v) & DL_in(u) | DL_out(u) & DL_in(u)
//           | DL_out(v) & DL_in(v)                     Theorems 1-2
//   bl   |= BL_in(u) & ~BL_in(v) | BL_out(v) & ~BL_out(u)   Lemma 2
//
// `decide` turns them into +1 / 0 / -1 with the self test (raw ids) and
// the two freshness gates (edge-count and tombstone cutoffs, true when a
// kernel has none).
//
// A lane costs two dependent round trips to memory: the ids (with the
// cutoffs, which do not depend on them), then all eight rows at once.
// FixedRows<WD, WB, VEC> holds compile-time widths (W in 1..4): its loads
// unroll fully and are all issued before the first use; with VEC (the
// planes' bases 16-byte aligned) a W = 2 row is one 8-byte load and a
// W = 4 row one 16-byte load, through the read-only path.  W = 1 and 3
// rows load word by word (a 12-byte row is 8-byte aligned only at even
// rows), so a pair of those widths has no VEC instance.  RuntimeRows takes
// any other width (k > 128) and loops at run time.  `dispatch` compiles
// only the instances the wrapper's `verdict_geometry`
// (kernels/dbl_query/dbl_query.py) can return: 12 vector and 16 scalar
// fixed pairs, and the run-time one.
#pragma once

#include <cstddef>
#include <cstdint>
#include <cuda_runtime.h>

namespace verdict {

struct Planes {
  const int* dl_in;
  const int* dl_out;
  const int* bl_in;
  const int* bl_out;
  int wd, wb, n_cap;
};

__device__ __forceinline__ size_t clamp_id(int x, int n) {
  return static_cast<size_t>(x < 0 ? 0 : (x >= n ? n - 1 : x));
}

// One lane's ids and freshness gates (the first round trip).
struct Lane {
  int u, v;
  bool fresh, d_fresh;
};

struct Acc {
  int lem1, thm, bl;
};

// The W words of one row at p into registers, through the read-only path:
// one 8- or 16-byte load when VEC and W is 2 or 4, else word by word.
template <int W, bool VEC>
__device__ __forceinline__ void load_row(int (&dst)[W], const int* p) {
  if constexpr (VEC && W == 4) {
    const int4 t = __ldg(reinterpret_cast<const int4*>(p));
    dst[0] = t.x; dst[1] = t.y; dst[2] = t.z; dst[3] = t.w;
  } else if constexpr (VEC && W == 2) {
    const int2 t = __ldg(reinterpret_cast<const int2*>(p));
    dst[0] = t.x; dst[1] = t.y;
  } else {
#pragma unroll
    for (int w = 0; w < W; ++w) dst[w] = __ldg(p + w);
  }
}

template <int WD, int WB, bool VEC>
struct FixedRows {
  int dlo_u[WD], dli_v[WD], dlo_v[WD], dli_u[WD];
  int bi_u[WB], bi_v[WB], bo_u[WB], bo_v[WB];

  __device__ __forceinline__ void load(const Planes& P, const Lane& l) {
    const size_t uu = clamp_id(l.u, P.n_cap), vv = clamp_id(l.v, P.n_cap);
    load_row<WD, VEC>(dlo_u, P.dl_out + uu * WD);
    load_row<WD, VEC>(dli_v, P.dl_in + vv * WD);
    load_row<WD, VEC>(dlo_v, P.dl_out + vv * WD);
    load_row<WD, VEC>(dli_u, P.dl_in + uu * WD);
    load_row<WB, VEC>(bi_u, P.bl_in + uu * WB);
    load_row<WB, VEC>(bi_v, P.bl_in + vv * WB);
    load_row<WB, VEC>(bo_u, P.bl_out + uu * WB);
    load_row<WB, VEC>(bo_v, P.bl_out + vv * WB);
  }

  __device__ __forceinline__ Acc acc() const {
    Acc a{0, 0, 0};
#pragma unroll
    for (int w = 0; w < WD; ++w) {
      a.lem1 |= dlo_u[w] & dli_v[w];
      a.thm |= (dlo_v[w] & (dli_u[w] | dli_v[w])) | (dlo_u[w] & dli_u[w]);
    }
#pragma unroll
    for (int w = 0; w < WB; ++w)
      a.bl |= (bi_u[w] & ~bi_v[w]) | (bo_v[w] & ~bo_u[w]);
    return a;
  }
};

// Any other width: the rows stay in memory and the word loops run at run
// time.
struct RuntimeRows {
  const int *dlo_u, *dli_v, *dlo_v, *dli_u, *bi_u, *bi_v, *bo_u, *bo_v;
  int wd, wb;

  __device__ __forceinline__ void load(const Planes& P, const Lane& l) {
    const size_t uu = clamp_id(l.u, P.n_cap), vv = clamp_id(l.v, P.n_cap);
    wd = P.wd;
    wb = P.wb;
    dlo_u = P.dl_out + uu * wd;
    dli_v = P.dl_in + vv * wd;
    dlo_v = P.dl_out + vv * wd;
    dli_u = P.dl_in + uu * wd;
    bi_u = P.bl_in + uu * wb;
    bi_v = P.bl_in + vv * wb;
    bo_u = P.bl_out + uu * wb;
    bo_v = P.bl_out + vv * wb;
  }

  __device__ __forceinline__ Acc acc() const {
    Acc a{0, 0, 0};
    for (int w = 0; w < wd; ++w) {
      const int ou = __ldg(dlo_u + w), iv = __ldg(dli_v + w);
      const int ov = __ldg(dlo_v + w), iu = __ldg(dli_u + w);
      a.lem1 |= ou & iv;
      a.thm |= (ov & (iu | iv)) | (ou & iu);
    }
    for (int w = 0; w < wb; ++w)
      a.bl |= (__ldg(bi_u + w) & ~__ldg(bi_v + w)) |
              (__ldg(bo_v + w) & ~__ldg(bo_u + w));
    return a;
  }
};

// +1 reachable, 0 unreachable, -1 unknown.  Label positives need both
// gates; on a tombstone-stale lane (!d_fresh) only BL negatives stand
// (the interval negatives `il_neg` and the theorems need fresh labels).
__device__ __forceinline__ int decide(const Acc& a, bool same, bool il_neg,
                                      bool fresh, bool d_fresh) {
  const bool pos_lbl = a.lem1 != 0, bl_neg = a.bl != 0;
  const bool pos = (pos_lbl && fresh && d_fresh) || same;
  const bool neg = d_fresh ? !(pos_lbl || same) && (bl_neg || il_neg ||
                                                    a.thm != 0)
                           : !same && bl_neg;
  return pos ? 1 : (neg ? 0 : -1);
}

__device__ __forceinline__ void store(void* out, int i, int verdict,
                                      bool out_int8) {
  if (out_int8)
    static_cast<int8_t*>(out)[i] = static_cast<int8_t>(verdict);
  else
    static_cast<int*>(out)[i] = verdict;
}

template <int D, int B, class Launch>
int launch_fixed(bool vec, Launch& launch) {
  if constexpr (D == 2 || D == 4 || B == 2 || B == 4)
    if (vec) return launch(FixedRows<D, B, true>{});
  return launch(FixedRows<D, B, false>{});
}

// Calls launch(Rows{}) with the rows instance for (wd, wb, vec): the
// compile-time widths for W in 1..4 (vector loads where vec and a width
// is 2 or 4), else the run-time widths.
template <class Launch>
int dispatch(int wd, int wb, bool vec, Launch&& launch) {
#define VERDICT_CASE(D, B) \
  case (D) * 8 + (B): return launch_fixed<D, B>(vec, launch);
  if (wd >= 1 && wd <= 4 && wb >= 1 && wb <= 4) {
    switch (wd * 8 + wb) {
      VERDICT_CASE(1, 1) VERDICT_CASE(1, 2) VERDICT_CASE(1, 3)
      VERDICT_CASE(1, 4) VERDICT_CASE(2, 1) VERDICT_CASE(2, 2)
      VERDICT_CASE(2, 3) VERDICT_CASE(2, 4) VERDICT_CASE(3, 1)
      VERDICT_CASE(3, 2) VERDICT_CASE(3, 3) VERDICT_CASE(3, 4)
      VERDICT_CASE(4, 1) VERDICT_CASE(4, 2) VERDICT_CASE(4, 3)
      VERDICT_CASE(4, 4)
      default: break;
    }
  }
#undef VERDICT_CASE
  return launch(RuntimeRows{});
}

}  // namespace verdict
