// Fused DBL label verdict (paper Alg 2 lines 6-13) for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/dbl_query/dbl_query.py
// `dbl_query_verdicts` (body `_make_kernel`, line 35), and fuses the eight
// row gathers and word-major transposes its wrapper runs before the
// pallas_call (src/repro/kernels/dbl_query/ops.py:67-70).
//
// One thread per query lane, through the shared tile
// (csrc/verdict_tile.cuh): the thread loads its ids and cutoffs (m_cut/m_total, d_cut/d_total), then
// all eight label rows of the four packed planes (n_cap, W) int32 at once,
// whole rows with compile-time widths, and applies Lemma 1, Lemma 2,
// Theorems 1-2 and the cutoff gates.  The optional interval planes
// (n_cap, 2*dim) int32 join the negatives through a run-time loop behind a
// uniform branch (no instance is compiled for them).
//
// Bound: bytes.  Per lane it reads two ids, eight label rows of W words,
// the optional cutoffs, and writes one int8/int32 verdict: at a serving
// batch (Q = 20 032, W = 2) 0.36 us of device-memory traffic, and the rows
// sit in L2.  What the kernel pays instead, timed on an H100 (PERF.md):
// the launch (a `zero_` of the output takes 1.4 us), two dependent round
// trips (0.45 us more when every row hits L1) and eight scattered 32 B
// sector requests a lane to L2 (another 1.1 us for random ids, 0.2 us when
// the ids are sorted so that neighbouring lanes share sectors).  The design
// keeps it to those: 64-thread blocks (the fastest of 64 to 1 024 threads
// a block, and of two threads a lane), whole-row vector loads, every load
// of a lane in flight before its first use, and no staging through shared
// memory.  Fewer sector requests would need the four planes interleaved
// per vertex (a vertex's four W = 2 rows in one sector), a layout the
// planes do not have.  The ragged tail is masked here, so the caller pads
// nothing.
#include <cstdint>
#include <cuda_runtime.h>

#include "verdict_tile.cuh"

namespace {

constexpr int MAX_THREADS = 256;

struct Cut {
  const int* m_cut;
  int m_total;
  const int* d_cut;
  int d_total;
};

struct Il {
  const int* in;
  const int* out;
  int wi;
};

template <class Rows>
__global__ void __launch_bounds__(MAX_THREADS) verdicts_kernel(
    verdict::Planes P, const int* __restrict__ u, const int* __restrict__ v,
    int q, Cut cut, Il il, void* out, int out_int8) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= q) return;
  // first round trip: ids and cutoffs
  const verdict::Lane l{
      __ldg(u + i), __ldg(v + i),
      cut.m_cut == nullptr || __ldg(cut.m_cut + i) >= cut.m_total,
      cut.d_cut == nullptr || __ldg(cut.d_cut + i) >= cut.d_total};
  // second: the eight rows
  Rows r;
  r.load(P, l);
  bool il_neg = false;
  if (il.in != nullptr) {
    // containment violation: any(out[u] > out[v]) | any(in[v] > in[u])
    const size_t uu = verdict::clamp_id(l.u, P.n_cap) * il.wi;
    const size_t vv = verdict::clamp_id(l.v, P.n_cap) * il.wi;
    for (int j = 0; j < il.wi; ++j)
      il_neg |= (__ldg(il.out + uu + j) > __ldg(il.out + vv + j)) |
                (__ldg(il.in + vv + j) > __ldg(il.in + uu + j));
  }
  verdict::store(out, i,
                 verdict::decide(r.acc(), l.u == l.v, il_neg, l.fresh,
                                 l.d_fresh),
                 out_int8);
}

}  // namespace

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// All pointers are device pointers; m_cut, d_cut, il_in and il_out may be
// NULL (d_cut needs m_cut, il_in needs il_out).  vec (the planes' bases
// 16-byte aligned), threads and blocks come from the wrapper's
// `verdict_geometry`.  Returns cudaGetLastError() after the launch.
extern "C" int dbl_query_verdicts(
    const int* dl_in, const int* dl_out, int wd,
    const int* bl_in, const int* bl_out, int wb, int n_cap,
    const int* u, const int* v, int q,
    const int* m_cut, int m_total, const int* d_cut, int d_total,
    const int* il_in, const int* il_out, int wi,
    void* out, int out_int8, int vec, int threads, int blocks,
    void* stream) {
  const verdict::Planes P{dl_in, dl_out, bl_in, bl_out, wd, wb, n_cap};
  const Cut cut{m_cut, m_total, d_cut, d_total};
  const Il il{il_in, il_out, wi};
  return verdict::dispatch(wd, wb, vec != 0, [&](auto rows) {
    auto kernel = verdicts_kernel<decltype(rows)>;
    kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
        P, u, v, q, cut, il, out, out_int8);
    return static_cast<int>(cudaGetLastError());
  });
}
