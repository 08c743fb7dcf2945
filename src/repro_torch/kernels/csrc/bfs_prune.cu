// BFS admit plane (paper Alg 2 lines 20/22 hoisted out of the BFS) for
// Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/bfs_prune/bfs_prune.py
// `bfs_admit_plane` (body `_make_kernel`, line 41):
//
//   admit[x, q] = BL_in(x) ⊆ BL_in(v_q) ∧ BL_out(v_q) ⊆ BL_out(x)
//                 ∧ ¬(DL_out(u_q) ∩ DL_in(x) ≠ ∅)
//
// with the DL term gated off per lane when m_cut[q] < m_total or
// d_cut[q] < d_total.  Output (n_cap, Q) int8, row-major like the
// reference's plane.  The interval-family AND stays outside the kernel.
//
// Bound: integer operations at the serving shapes.  Each output byte
// takes 2*Wb + Wd + 2 integer operations (one 3-input logic op per word
// and test, then the compare and the pack), which on the H100's INT32
// lanes take longer than writing the byte; bytes (the n*Q output plus one
// read of the three vertex planes) bound only small Q.
//
// Design (the tile is csrc/admit_tile.cuh, shared with the streamed
// kernel): a grid-stride walk over vertex rows, two blocks per SM.  Each
// block stages its lanes' query-side words in shared memory, one lane a
// thread (two dependent loads: the ids, then the rows), with the
// freshness gate folded into the DL words; each thread then copies its
// L lanes' words into registers.  Every thread keeps D = 3 of its rows'
// words in flight (the first ones across the staging), so a row's loads
// are issued three rows before it computes; it writes each row's L bytes
// with one packed store.  A Q wider than a block's lane groups takes a
// second grid axis (blockIdx.y) over lane slabs.  What still holds it
// back is the lane staging: every block reads the same Q lanes' rows, so
// those few L2 sectors are hot while all blocks start.
#include <cstdint>
#include <cuda_runtime.h>

#include "admit_tile.cuh"

namespace {

constexpr int MAX_THREADS = 256;

// Rows in flight per thread: a row's words load D rows before it computes.
constexpr int D = 3;

template <bool VEC, class Tile>
__device__ __forceinline__ void admit_rows(
    const admit::Planes& P, const int* u, const int* v, int q,
    const admit::CutFresh& fresh, const admit::Geometry& g, int* lanes_s,
    int8_t* out) {
  constexpr int L = Tile::kLanes;
  const int stride = g.span * L;            // lanes this block stages
  const int l0 = blockIdx.y * stride;
  const int gl = threadIdx.x % g.span;
  const int lane0 = l0 + gl * L;
  const int step = gridDim.x * g.rows;
  int x = blockIdx.x * g.rows + threadIdx.x / g.span;
  const bool on = threadIdx.x / g.span < g.rows && lane0 < q &&
                  x < P.n_cap;
  Tile t;
  typename Tile::Row ring[D];   // rows x, x + step, ... (clamped to n_cap)
  if (on) {                     // in flight across the staging
#pragma unroll
    for (int i = 0; i < D; ++i)
      ring[i] = t.template load_global<VEC>(
          P, min(x + i * step, P.n_cap - 1));
  }
  Tile::stage(lanes_s, stride, P, u, v, l0, min(stride, q - l0), fresh,
              g.vec);
  __syncthreads();
  if (!on) return;
  t.load_lanes(P, lanes_s, stride, gl * L);
  for (;;) {
#pragma unroll
    for (int i = 0; i < D; ++i) {
      uint32_t w[L / 4];
      t.admit(ring[i], w);
      admit::store_bytes<L>(out + (size_t)x * q + lane0, w, q - lane0,
                            g.pack);
      // unconditional (clamped), so the loads issue ahead of the compute
      ring[i] = t.template load_global<VEC>(
          P, min(x + D * step, P.n_cap - 1));
      x += step;
      if (x >= P.n_cap) return;
    }
  }
}

template <class Tile>
__global__ void __launch_bounds__(MAX_THREADS) admit_kernel(
    admit::Planes P, const int* __restrict__ u, const int* __restrict__ v,
    int q, admit::CutFresh fresh, admit::Geometry g,
    int8_t* __restrict__ out) {
  extern __shared__ __align__(16) int lanes_s[];
  if (g.vec)
    admit_rows<true, Tile>(P, u, v, q, fresh, g, lanes_s, out);
  else
    admit_rows<false, Tile>(P, u, v, q, fresh, g, lanes_s, out);
}

}  // namespace

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// All pointers are device pointers; m_cut and d_cut may be NULL (d_cut
// needs m_cut).  out is (n_cap, q) int8.  The launch geometry (lanes per
// thread, the Geometry fields, threads and blocks per grid row) comes from
// the wrapper (`admit_geometry` in kernels/bfs_prune/bfs_prune.py).
// Returns cudaGetLastError() after the launch.
extern "C" int bfs_admit_plane(
    const int* bl_in, const int* bl_out, int wb,
    const int* dl_in, const int* dl_out, int wd, int n_cap,
    const int* u, const int* v, int q,
    const int* m_cut, int m_total, const int* d_cut, int d_total,
    int8_t* out, int lanes, int groups, int span, int rows, int slabs,
    int pack, int vec, int threads, int blocks, int smem, void* stream) {
  const admit::Planes P{bl_in, bl_out, dl_in, dl_out, wb, wd, n_cap};
  const admit::CutFresh fresh{m_cut, m_total, d_cut, d_total};
  const admit::Geometry g{groups, span, rows, slabs, 0, pack, vec};
  return admit::dispatch<true>(wb, wd, lanes, [&](auto tile) {
    auto kernel = admit_kernel<decltype(tile)>;
    if (smem > 48 * 1024) {
      cudaError_t err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    kernel<<<dim3(blocks, slabs), threads, static_cast<size_t>(smem),
             static_cast<cudaStream_t>(stream)>>>(P, u, v, q, fresh, g, out);
    return static_cast<int>(cudaGetLastError());
  });
}
