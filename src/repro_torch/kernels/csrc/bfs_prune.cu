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
// Each block owns a tile of NB vertices × all Q lanes, which is one
// contiguous NB*Q-byte span of the output.  It gathers the lanes'
// query-side words (BL_in(v_q), BL_out(v_q), DL_out(u_q), by u/v inside the
// kernel) and the per-lane freshness bit into shared memory once, and
// stages the tile's vertex words beside them with coalesced loads.  Threads
// then walk the tile's NB*Q outputs in order, so consecutive threads take
// consecutive lanes: the int8 stores are coalesced and the vertex words a
// warp reads come from one or two shared-memory words (broadcasts).
//
// Bound: integer operations at the serving shapes.  Each output byte
// takes about 2*Wb + Wd + 2 integer operations (one 3-input logic op per
// word and test, then the combine), which on the H100's INT32 lanes take
// longer than writing the byte; bytes (the n*Q output plus one read of the
// three vertex planes) bound only small Q.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ int clamp_id(int x, int n) {
  return x < 0 ? 0 : (x >= n ? n - 1 : x);
}

__global__ void admit_kernel(
    const int* __restrict__ bl_in, const int* __restrict__ bl_out, int wb,
    const int* __restrict__ dl_in, const int* __restrict__ dl_out, int wd,
    int n_cap, const int* __restrict__ u, const int* __restrict__ v, int q,
    const int* __restrict__ m_cut, int m_total,
    const int* __restrict__ d_cut, int d_total, int nb,
    int8_t* __restrict__ out) {
  extern __shared__ int smem[];
  const int nw = 2 * wb + wd;   // words per row: BL_in | BL_out | DL
  int* qw = smem;               // [nw][q]  lane words
  int* fresh = qw + nw * q;     // [q]      DL term on for this lane
  int* xw = fresh + q;          // [nw][nb] vertex words of the tile

  for (int l = threadIdx.x; l < q; l += blockDim.x) {
    const size_t uu = clamp_id(u[l], n_cap), vv = clamp_id(v[l], n_cap);
    for (int w = 0; w < wb; ++w) {
      qw[w * q + l] = bl_in[vv * wb + w];
      qw[(wb + w) * q + l] = bl_out[vv * wb + w];
    }
    for (int w = 0; w < wd; ++w) qw[(2 * wb + w) * q + l] = dl_out[uu * wd + w];
    bool on = true;
    if (m_cut != nullptr) {
      on = m_cut[l] >= m_total;
      if (d_cut != nullptr) on = on && d_cut[l] >= d_total;
    }
    fresh[l] = on;
  }
  const int x0 = blockIdx.x * nb;
  const int nx = min(nb, n_cap - x0);
  for (int e = threadIdx.x; e < nx * wb; e += blockDim.x) {
    const int xl = e / wb, w = e % wb;
    xw[w * nb + xl] = bl_in[(size_t)(x0 + xl) * wb + w];
    xw[(wb + w) * nb + xl] = bl_out[(size_t)(x0 + xl) * wb + w];
  }
  for (int e = threadIdx.x; e < nx * wd; e += blockDim.x) {
    const int xl = e / wd, w = e % wd;
    xw[(2 * wb + w) * nb + xl] = dl_in[(size_t)(x0 + xl) * wd + w];
  }
  __syncthreads();

  int8_t* tile = out + (size_t)x0 * q;
  for (int e = threadIdx.x; e < nx * q; e += blockDim.x) {
    const int xl = e / q, l = e % q;
    bool ok = true;
    for (int w = 0; w < wb; ++w) {
      const int bix = xw[w * nb + xl], box = xw[(wb + w) * nb + xl];
      const int biv = qw[w * q + l], bov = qw[(wb + w) * q + l];
      ok &= ((bix & ~biv) == 0) & ((bov & ~box) == 0);
    }
    if (fresh[l]) {
      bool d = false;
      for (int w = 0; w < wd; ++w)
        d |= (qw[(2 * wb + w) * q + l] & xw[(2 * wb + w) * nb + xl]) != 0;
      ok &= !d;
    }
    tile[e] = ok ? 1 : 0;
  }
}

}  // namespace

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// All pointers are device pointers; m_cut and d_cut may be NULL (d_cut
// needs m_cut).  out is (n_cap, q) int8.  Returns cudaGetLastError() after
// the launch (or the error of the shared-memory opt-in).
extern "C" int bfs_admit_plane(
    const int* bl_in, const int* bl_out, int wb,
    const int* dl_in, const int* dl_out, int wd, int n_cap,
    const int* u, const int* v, int q,
    const int* m_cut, int m_total, const int* d_cut, int d_total,
    int8_t* out, void* stream) {
  const int threads = 256;
  int nb = 4096 / q;
  nb = nb < 1 ? 1 : (nb > 256 ? 256 : nb);
  const int nw = 2 * wb + wd;
  const size_t smem = sizeof(int) * ((size_t)nw * (q + nb) + q);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        admit_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int blocks = (n_cap + nb - 1) / nb;
  admit_kernel<<<blocks, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      bl_in, bl_out, wb, dl_in, dl_out, wd, n_cap, u, v, q, m_cut, m_total,
      d_cut, d_total, nb, out);
  return static_cast<int>(cudaGetLastError());
}
