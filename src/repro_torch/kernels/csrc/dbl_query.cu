// Fused DBL label verdict (paper Alg 2 lines 6-13) for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/dbl_query/dbl_query.py
// `dbl_query_verdicts` (body `_make_kernel`, line 35), and fuses the eight
// row gathers and word-major transposes its wrapper runs before the
// pallas_call (src/repro/kernels/dbl_query/ops.py:67-70).
//
// One thread per query lane.  The thread gathers its lane's rows from the
// four packed planes (n_cap, W) int32, row-major, loops over the W = k/32
// words in registers and applies Lemma 1, Lemma 2 and Theorems 1-2, the
// per-lane edge-count cutoff (m_cut/m_total), the tombstone cutoff
// (d_cut/d_total) and the optional interval planes (n_cap, 2*dim) int32.
//
// Bound: bytes.  Per lane it reads two ids, eight label rows of W words
// (each at least one 32 B sector), the optional cutoffs, and writes one
// int8/int32 verdict; nothing else reaches device memory.  At a serving
// batch that is microseconds of traffic, so launch latency dominates; the
// design keeps it to one launch with no staging buffers and masks the
// ragged tail itself, so the caller pads nothing.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ int clamp_id(int x, int n) {
  return x < 0 ? 0 : (x >= n ? n - 1 : x);
}

__global__ void verdicts_kernel(
    const int* __restrict__ dl_in, const int* __restrict__ dl_out, int wd,
    const int* __restrict__ bl_in, const int* __restrict__ bl_out, int wb,
    int n_cap, const int* __restrict__ u, const int* __restrict__ v, int q,
    const int* __restrict__ m_cut, int m_total,
    const int* __restrict__ d_cut, int d_total,
    const int* __restrict__ il_in, const int* __restrict__ il_out, int wi,
    void* out, int out_int8) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= q) return;
  const int ur = u[i], vr = v[i];
  const bool same = ur == vr;
  const size_t uu = clamp_id(ur, n_cap), vv = clamp_id(vr, n_cap);

  const int* dlo_u = dl_out + uu * wd;
  const int* dli_v = dl_in + vv * wd;
  const int* dlo_v = dl_out + vv * wd;
  const int* dli_u = dl_in + uu * wd;
  bool pos_lbl = false, thm = false;
  for (int w = 0; w < wd; ++w) {
    const int a = dlo_u[w], b = dli_v[w], c = dlo_v[w], d = dli_u[w];
    pos_lbl |= (a & b) != 0;                                  // Lemma 1
    thm |= ((c & d) != 0) | ((a & d) != 0) | ((c & b) != 0);  // Thm 1, 2
  }
  const int* bi_u = bl_in + uu * wb;
  const int* bi_v = bl_in + vv * wb;
  const int* bo_u = bl_out + uu * wb;
  const int* bo_v = bl_out + vv * wb;
  bool bl_neg = false;
  for (int w = 0; w < wb; ++w)                                // Lemma 2
    bl_neg |= ((bi_u[w] & ~bi_v[w]) != 0) | ((bo_v[w] & ~bo_u[w]) != 0);

  bool neg_lbl = bl_neg;
  if (il_in != nullptr) {
    // interval containment violation: any(out[u] > out[v]) | any(in[v] > in[u])
    const int* io_u = il_out + uu * wi;
    const int* io_v = il_out + vv * wi;
    const int* ii_u = il_in + uu * wi;
    const int* ii_v = il_in + vv * wi;
    for (int j = 0; j < wi; ++j)
      neg_lbl |= (io_u[j] > io_v[j]) | (ii_v[j] > ii_u[j]);
  }
  bool pos = pos_lbl | same;
  bool neg = !pos & (neg_lbl | thm);
  if (m_cut != nullptr) {
    const bool fresh = m_cut[i] >= m_total;
    if (d_cut != nullptr) {
      const bool d_fresh = d_cut[i] >= d_total;
      pos = (pos_lbl & fresh & d_fresh) | same;
      neg = d_fresh ? neg : (!same & bl_neg);
    } else {
      pos = (pos_lbl & fresh) | same;
    }
  }
  const int verdict = pos ? 1 : (neg ? 0 : -1);
  if (out_int8)
    static_cast<int8_t*>(out)[i] = static_cast<int8_t>(verdict);
  else
    static_cast<int*>(out)[i] = verdict;
}

}  // namespace

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// All pointers are device pointers; m_cut, d_cut, il_in and il_out may be
// NULL (d_cut needs m_cut, il_in needs il_out).  Returns cudaGetLastError()
// after the launch.
extern "C" int dbl_query_verdicts(
    const int* dl_in, const int* dl_out, int wd,
    const int* bl_in, const int* bl_out, int wb, int n_cap,
    const int* u, const int* v, int q,
    const int* m_cut, int m_total, const int* d_cut, int d_total,
    const int* il_in, const int* il_out, int wi,
    void* out, int out_int8, void* stream) {
  const int threads = 256;
  const int blocks = (q + threads - 1) / threads;
  verdicts_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      dl_in, dl_out, wd, bl_in, bl_out, wb, n_cap, u, v, q, m_cut, m_total,
      d_cut, d_total, il_in, il_out, wi, out, out_int8);
  return static_cast<int>(cudaGetLastError());
}
