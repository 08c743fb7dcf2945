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
// bitwise, with the vertex axis streamed.  `fresh` is the one pre-combined
// 0/1 freshness row of the TPU wrapper ((m_cut >= m_total) ∧ (d_cut >=
// d_total)), or NULL for no cutoff.  The interval-family AND stays outside.
//
// Persistent blocks, about one per SM.  Each block gathers the lane side
// once into shared memory (BL_in(v_q), BL_out(v_q), DL_out(u_q) words and
// the freshness bit for all Q lanes; there is no q_block, one tile spans
// every lane) and then walks vertex chunks c = blockIdx.x, blockIdx.x +
// gridDim.x, ... of NB rows.  In the row-major (n_cap, W) int32 planes a
// chunk of rows is one contiguous span per plane, so its three spans are
// copied into a two-stage shared-memory ring with cp.async (16-byte copies
// where the span is aligned, <cuda_pipeline.h>), the next chunk's copy in
// flight while the current one computes.  Each chunk's (NB, Q) output is
// one contiguous span of the plane: a group of G threads (G = Q rounded up
// to a power of two, at most 32) takes one vertex row, so consecutive
// threads store consecutive bytes and a group reads its vertex words as
// shared-memory broadcasts.  The last chunk's ragged rows are masked.
//
// Shared memory: (2*Wb + Wd) * Q + Q words of lane side plus a ring of
// 2 * NB * (2*Wb + Wd) words; the wrapper checks it against the card's
// 227 KB before the launch and the entry point opts in above 48 KB.
//
// Bound: integer operations at the serving shapes, as for `admit_kernel`:
// about 2*Wb + Wd + 2 operations per output byte against one byte written.
#include <cstdint>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 512;

__device__ __forceinline__ int clamp_id(int x, int n) {
  return x < 0 ? 0 : (x >= n ? n - 1 : x);
}

__host__ __device__ __forceinline__ int lane_words(int nw, int q) {
  return (nw * q + q + 3) & ~3;   // 16-byte aligned start of the ring
}

// Copy nwords contiguous words global -> shared asynchronously, spread
// over the block's threads; dst is 16-byte aligned.
__device__ __forceinline__ void copy_span(int* dst, const int* src,
                                          int nwords) {
  int done = 0;
  if ((reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    const int n16 = nwords >> 2;
    for (int i = threadIdx.x; i < n16; i += blockDim.x)
      __pipeline_memcpy_async(dst + 4 * i, src + 4 * i, 16);
    done = n16 << 2;
  }
  for (int i = done + threadIdx.x; i < nwords; i += blockDim.x)
    __pipeline_memcpy_async(dst + i, src + i, sizeof(int));
}

__global__ void __launch_bounds__(THREADS) streamed_admit_kernel(
    const int* __restrict__ bl_in, const int* __restrict__ bl_out, int wb,
    const int* __restrict__ dl_in, const int* __restrict__ dl_out, int wd,
    int n_cap, const int* __restrict__ u, const int* __restrict__ v, int q,
    const int* __restrict__ fresh, int nb, int8_t* __restrict__ out) {
  extern __shared__ __align__(16) int smem[];
  const int nw = 2 * wb + wd;
  // lane side: [nw][q] words BL_in(v), BL_out(v), DL_out(u), then [q]
  // freshness; then the ring, 2 x [BL_in | BL_out | DL_in rows]
  int* qw = smem;
  int* fr = qw + nw * q;
  int* ring = smem + lane_words(nw, q);
  const int sw = nb * nw;
  const int nchunks = (n_cap + nb - 1) / nb;

  auto fetch = [&](int c, int s) {
    const int x0 = c * nb;
    const int nx = min(nb, n_cap - x0);
    int* dst = ring + s * sw;
    copy_span(dst, bl_in + (size_t)x0 * wb, nx * wb);
    copy_span(dst + nb * wb, bl_out + (size_t)x0 * wb, nx * wb);
    copy_span(dst + 2 * nb * wb, dl_in + (size_t)x0 * wd, nx * wd);
  };

  int c = blockIdx.x;
  if (c < nchunks) fetch(c, 0);
  __pipeline_commit();
  for (int l = threadIdx.x; l < q; l += blockDim.x) {
    const size_t uu = clamp_id(u[l], n_cap), vv = clamp_id(v[l], n_cap);
    for (int w = 0; w < wb; ++w) {
      qw[w * q + l] = bl_in[vv * wb + w];
      qw[(wb + w) * q + l] = bl_out[vv * wb + w];
    }
    for (int w = 0; w < wd; ++w)
      qw[(2 * wb + w) * q + l] = dl_out[uu * wd + w];
    fr[l] = fresh == nullptr ? 1 : fresh[l];
  }

  // G threads per vertex row: Q rounded up to a power of two, at most 32
  int gshift = 0;
  while ((1 << gshift) < q && gshift < 5) ++gshift;
  const int gsize = 1 << gshift;
  const int gid = threadIdx.x >> gshift;
  const int ngroups = blockDim.x >> gshift;
  const int lig = threadIdx.x & (gsize - 1);

  for (int j = 0; c < nchunks; ++j, c += gridDim.x) {
    const int next = c + gridDim.x;
    if (next < nchunks) fetch(next, (j + 1) & 1);
    __pipeline_commit();
    __pipeline_wait_prior(1);   // this thread's copies of chunk c landed
    __syncthreads();            // ... and every other thread's
    const int x0 = c * nb;
    const int nx = min(nb, n_cap - x0);
    const int* s = ring + (j & 1) * sw;
    int8_t* tile = out + (size_t)x0 * q;
    for (int xl = gid; xl < nx; xl += ngroups) {
      const int* xbi = s + xl * wb;
      const int* xbo = s + nb * wb + xl * wb;
      const int* xdi = s + 2 * nb * wb + xl * wd;
      for (int l = lig; l < q; l += gsize) {
        bool ok = true;
        for (int w = 0; w < wb; ++w)
          ok &= ((xbi[w] & ~qw[w * q + l]) == 0) &
                ((qw[(wb + w) * q + l] & ~xbo[w]) == 0);
        if (fr[l]) {
          bool d = false;
          for (int w = 0; w < wd; ++w)
            d |= (qw[(2 * wb + w) * q + l] & xdi[w]) != 0;
          ok &= !d;
        }
        tile[(size_t)xl * q + l] = ok ? 1 : 0;
      }
    }
    __syncthreads();            // slot j & 1 is refilled at j + 1
  }
}

}  // namespace

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Shared memory one block of the streamed admit kernel takes.
extern "C" long long bfs_prune_streamed_smem_bytes(int wb, int wd, int q,
                                                   int nb) {
  const int nw = 2 * wb + wd;
  return (static_cast<long long>(lane_words(nw, q)) +
          2LL * nb * nw) * static_cast<long long>(sizeof(int));
}

// All pointers are device pointers; fresh is (q,) int32 0/1 or NULL.  out
// is (n_cap, q) int8.  nb is the chunk's row count (a multiple of 4) and
// blocks the number of persistent blocks.  Returns the error of the
// shared-memory opt-in or cudaGetLastError() after the launch.
extern "C" int bfs_admit_plane_streamed(
    const int* bl_in, const int* bl_out, int wb,
    const int* dl_in, const int* dl_out, int wd, int n_cap,
    const int* u, const int* v, int q, const int* fresh, int nb,
    int8_t* out, int blocks, void* stream) {
  const long long smem = bfs_prune_streamed_smem_bytes(wb, wd, q, nb);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        streamed_admit_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int nchunks = (n_cap + nb - 1) / nb;
  if (blocks > nchunks) blocks = nchunks;
  streamed_admit_kernel<<<blocks, THREADS, static_cast<size_t>(smem),
                          static_cast<cudaStream_t>(stream)>>>(
      bl_in, bl_out, wb, dl_in, dl_out, wd, n_cap, u, v, q, fresh, nb, out);
  return static_cast<int>(cudaGetLastError());
}
