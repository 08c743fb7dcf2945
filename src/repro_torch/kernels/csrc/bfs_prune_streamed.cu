// Streamed BFS admit plane (paper Alg 2 lines 20/22 hoisted out of the
// BFS) for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/bfs_prune/bfs_prune.py
// `bfs_admit_plane_streamed` (body `_make_streamed_kernel`, line 135):
//
//   admit[x, q] = BL_in(x) ⊆ BL_in(v_q) ∧ BL_out(v_q) ⊆ BL_out(x)
//                 ∧ ¬(fresh_q ∧ DL_out(u_q) ∩ DL_in(x) ≠ ∅)
//
// the same (n_cap, Q) int8 plane as `admit_kernel` (csrc/bfs_prune.cu),
// bitwise, through the same tile (csrc/admit_tile.cuh), with the vertex
// axis streamed.  `fresh` is the one pre-combined 0/1 freshness row of the
// TPU wrapper ((m_cut >= m_total) ∧ (d_cut >= d_total)), or NULL for no
// cutoff.  The interval-family AND stays outside.
//
// Bound: integer operations at the serving shapes, as for `admit_kernel`:
// 2*Wb + Wd + 2 operations per output byte against one byte written.
//
// Design: persistent blocks, about one per SM, walk work items
// it = blockIdx.x, blockIdx.x + gridDim.x, ...; item it is vertex chunk
// it % nchunks of lane slab it / nchunks (one slab unless Q has more lane
// groups than fit a block).  A block stages its slab's lane side in shared
// memory (one lane a thread, freshness folded into the DL words, as the
// grid kernel does) and each thread copies its L lanes' words into
// registers.  In the row-major (n_cap, W) int32 planes a chunk of NB rows
// is one contiguous span per plane; its three spans go into a two-stage
// shared-memory ring, the next item's copy in flight while the current one
// computes.  The block's threads fill a stage with `cp.async`, 16 bytes a
// copy where a span is 16-byte aligned, 4 bytes for the rest (unaligned
// planes, a ragged tail).  Each thread walks the rows r, r + rows, ... of
// a chunk, reading a row's words from the ring (vector loads, broadcasts
// within the row's threads) and writing its L bytes with one packed
// store.  NB spreads n_cap over the blocks (one chunk each up to
// 132 * 1024 rows): a chunk's barriers cost more than the overlap of a
// second chunk buys at the serving sizes, so the ring overlaps chunks
// only beyond that.  A one-thread bulk copy (TMA, with an mbarrier) in
// place of the per-thread copies timed within 3 % of them at the LJ size
// and was taken out.
//
// Dynamic shared memory: the lane side ((2*Wb + Wd) words for each of the
// slab's lanes), then the ring of 2 * NB * (2*Wb + Wd) words (the wrapper
// sizes it and checks it against the card's 227 KB; the entry point opts
// in above 48 KB).
#include <cstdint>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include "admit_tile.cuh"

namespace {

constexpr int MAX_THREADS = 512;

// nwords words global -> shared by the block's threads with cp.async:
// 16-byte copies where src is 16-byte aligned (dst always is), else 4.
__device__ __forceinline__ void copy_words(int* dst, const int* src,
                                           int nwords) {
  int from = 0;
  if ((reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    const int n16 = nwords >> 2;
    for (int i = threadIdx.x; i < n16; i += blockDim.x)
      __pipeline_memcpy_async(dst + 4 * i, src + 4 * i, 16);
    from = n16 << 2;
  }
  for (int i = from + threadIdx.x; i < nwords; i += blockDim.x)
    __pipeline_memcpy_async(dst + i, src + i, sizeof(int));
}

template <class Tile>
__global__ void __launch_bounds__(MAX_THREADS) streamed_admit_kernel(
    admit::Planes P, const int* __restrict__ u, const int* __restrict__ v,
    int q, admit::RowFresh fresh, admit::Geometry g,
    int8_t* __restrict__ out) {
  constexpr int L = Tile::kLanes;
  extern __shared__ __align__(16) int smem[];
  const int wb = P.wb, wd = P.wd, nb = g.n_block;
  const int stride = g.span * L;            // lanes of a slab
  int* lanes_s = smem;
  int* ring = lanes_s + (2 * wb + wd) * stride;
  const int sw = nb * (2 * wb + wd);        // words per ring stage
  const int nchunks = (P.n_cap + nb - 1) / nb;
  const int items = nchunks * g.slabs;

  // Item it's three row spans into ring stage s.
  auto fetch = [&](int it, int s) {
    const int x0 = (it % nchunks) * nb;
    const int nx = min(nb, P.n_cap - x0);
    int* dst = ring + s * sw;
    copy_words(dst, P.bl_in + (size_t)x0 * wb, nx * wb);
    copy_words(dst + nb * wb, P.bl_out + (size_t)x0 * wb, nx * wb);
    copy_words(dst + 2 * nb * wb, P.dl_in + (size_t)x0 * wd, nx * wd);
  };

  const int r = threadIdx.x / g.span;
  const int gl = threadIdx.x % g.span;
  Tile t;
  int slab = -1;

  int it = blockIdx.x;
  if (it < items) fetch(it, 0);
  __pipeline_commit();
  for (int j = 0; it < items; ++j, it += gridDim.x) {
    const int next = it + gridDim.x;
    if (next < items) fetch(next, (j + 1) & 1);
    __pipeline_commit();
    const int sl = it / nchunks;
    const int lane0 = sl * stride + gl * L;
    const bool on = r < g.rows && lane0 < q;
    const bool fresh_slab = sl != slab;
    if (fresh_slab) {           // the lane side of a new slab (uniform)
      Tile::stage(lanes_s, stride, P, u, v, sl * stride,
                  min(stride, q - sl * stride), fresh, g.vec);
      slab = sl;
    }
    __pipeline_wait_prior(1);   // this thread's cp.async of item it
    __syncthreads();            // ... and every other thread's
    if (on && fresh_slab) t.load_lanes(P, lanes_s, stride, gl * L);
    const int x0 = (it % nchunks) * nb;
    const int nx = min(nb, P.n_cap - x0);
    const int* s = ring + (j & 1) * sw;
    if (on) {
      for (int xl = r; xl < nx; xl += g.rows) {
        uint32_t w[L / 4];
        t.admit(t.load_shared(s, nb, xl), w);
        admit::store_bytes<L>(out + (size_t)(x0 + xl) * q + lane0, w,
                              q - lane0, g.pack);
      }
    }
    __syncthreads();            // stage j & 1 is refilled at j + 1, and
  }                             // the lane side restaged
}

}  // namespace

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// All pointers are device pointers; fresh is (q,) int32 0/1 or NULL.  out
// is (n_cap, q) int8.  The launch geometry (lanes per thread, the Geometry
// fields, threads, persistent blocks and the shared memory they take)
// comes from the wrapper (`admit_geometry` in
// kernels/bfs_prune/bfs_prune.py); n_block is a multiple of 4.  Returns
// the error of the shared-memory opt-in or cudaGetLastError() after the
// launch.
extern "C" int bfs_admit_plane_streamed(
    const int* bl_in, const int* bl_out, int wb,
    const int* dl_in, const int* dl_out, int wd, int n_cap,
    const int* u, const int* v, int q, const int* fresh, int8_t* out,
    int lanes, int groups, int span, int rows, int slabs, int n_block,
    int pack, int vec, int threads, int blocks, int smem, void* stream) {
  const admit::Planes P{bl_in, bl_out, dl_in, dl_out, wb, wd, n_cap};
  const admit::RowFresh fr{fresh};
  const admit::Geometry g{groups, span, rows, slabs, n_block, pack, vec};
  return admit::dispatch<false>(wb, wd, lanes, [&](auto tile) {
    auto kernel = streamed_admit_kernel<decltype(tile)>;
    if (smem > 48 * 1024) {
      cudaError_t err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    kernel<<<blocks, threads, static_cast<size_t>(smem),
             static_cast<cudaStream_t>(stream)>>>(P, u, v, q, fr, g, out);
    return static_cast<int>(cudaGetLastError());
  });
}
