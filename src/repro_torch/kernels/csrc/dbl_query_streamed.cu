// Streamed DBL label verdict (paper Alg 2 lines 6-13) for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/dbl_query/dbl_query.py
// `dbl_query_verdicts_streamed` (body `_make_streamed_kernel`, line 174):
// the same verdicts as `verdicts_kernel` (csrc/dbl_query.cu), bitwise,
// through the same tile (csrc/verdict_tile.cuh), with the query axis cut
// into chunks that persistent blocks walk.  On the TPU the wrapper stacked
// the gathered rows into (nchunks, 4, W, QB) blocks in HBM and one program
// double-buffered them into VMEM; here each thread gathers its lane's rows
// itself, straight into registers.
//
// The cutoffs arrive pre-combined, as in the TPU wrapper: `ncut` (0, 1 or
// 2) rows of 0/1 freshness, row 0 = (m_cut >= m_total), row 1 =
// (d_cut >= d_total).  No interval planes.
//
// Design: at most one block per SM, one thread per lane of a chunk of
// blockDim.x lanes; block b walks chunks b, b + gridDim.x, ...  The
// wrapper's `verdict_geometry` sizes the chunk from Q and the SM count, so
// that a serving batch (Q = 20 032 on 132 SMs: 160-lane chunks, 126
// blocks) is one chunk a block and no block computes two in series.
// Beyond one wave (more than 132 * 256 lanes) the walk is software
// pipelined in registers: while a thread computes chunk j, its rows of
// chunk j + 1 and its ids of chunk j + 2 are in flight, so each step waits
// for at most one round trip.  A two-stage shared-memory ring filled by
// whole-row cp.async in place of the register prefetch timed slower on an
// H100 at every chunk size tried (PERF.md): 3.2 against 3.0 us at
// Q = 20 032 and 14.7-16.3 against 14.3-14.5 us at Q = 200 003.  The rows
// of a lane go to one thread, so the ring only adds a trip through shared
// memory.
//
// Bound: bytes.  Per lane the kernel reads two ids, eight label rows and
// ncut freshness words and writes one verdict; the arithmetic is one logic
// op per word and test.  At a serving batch the rows sit in L2, and the
// kernel pays what `verdicts_kernel` pays (csrc/dbl_query.cu): the launch,
// two dependent round trips and eight scattered sector requests a lane.
#include <cstdint>
#include <cuda_runtime.h>

#include "verdict_tile.cuh"

namespace {

constexpr int MAX_THREADS = 256;

// Lane i's ids and pre-combined freshness words (all fresh when ncut < 2).
__device__ __forceinline__ verdict::Lane load_lane(
    const int* __restrict__ u, const int* __restrict__ v,
    const int* __restrict__ cut, int ncut, int q, int i) {
  return {__ldg(u + i), __ldg(v + i), ncut < 1 || __ldg(cut + i) != 0,
          ncut < 2 || __ldg(cut + q + i) != 0};
}

template <class Rows>
__global__ void __launch_bounds__(MAX_THREADS) streamed_verdicts_kernel(
    verdict::Planes P, const int* __restrict__ u, const int* __restrict__ v,
    int q, const int* __restrict__ cut, int ncut, void* out, int out_int8) {
  const int step = gridDim.x * blockDim.x;
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= q) return;
  verdict::Lane cur = load_lane(u, v, cut, ncut, q, i), next{};
  Rows a, b;
  a.load(P, cur);
  if (i + step < q) next = load_lane(u, v, cut, ncut, q, i + step);
  // One step: the verdicts of chunk j from `rows` while the rows of chunk
  // j + 1 load into `ahead` and the ids of chunk j + 2 into registers.
  // The two row buffers swap roles each step (no copies between them).
  auto walk = [&](const Rows& rows, Rows& ahead) {
    const bool more = i + step < q;
    verdict::Lane after{};
    if (more) {
      ahead.load(P, next);
      if (i + 2 * step < q)
        after = load_lane(u, v, cut, ncut, q, i + 2 * step);
    }
    verdict::store(out, i,
                   verdict::decide(rows.acc(), cur.u == cur.v, false,
                                   cur.fresh, cur.d_fresh),
                   out_int8);
    i += step;
    cur = next;
    next = after;
    return more;
  };
  while (walk(a, b) && walk(b, a)) {
  }
}

}  // namespace

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// All pointers are device pointers; cut is (ncut, q) int32 0/1 rows and may
// be NULL when ncut == 0.  vec (the planes' bases 16-byte aligned), threads
// (lanes a chunk) and blocks (persistent, at most one per SM) come from
// the wrapper's `verdict_geometry`.  Returns cudaGetLastError() after the
// launch.
extern "C" int dbl_query_verdicts_streamed(
    const int* dl_in, const int* dl_out, int wd,
    const int* bl_in, const int* bl_out, int wb, int n_cap,
    const int* u, const int* v, int q, const int* cut, int ncut,
    void* out, int out_int8, int vec, int threads, int blocks,
    void* stream) {
  const verdict::Planes P{dl_in, dl_out, bl_in, bl_out, wd, wb, n_cap};
  return verdict::dispatch(wd, wb, vec != 0, [&](auto rows) {
    auto kernel = streamed_verdicts_kernel<decltype(rows)>;
    kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
        P, u, v, q, cut, ncut, out, out_int8);
    return static_cast<int>(cudaGetLastError());
  });
}
