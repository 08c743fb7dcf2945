// Streamed DBL label verdict (paper Alg 2 lines 6-13) for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/dbl_query/dbl_query.py
// `dbl_query_verdicts_streamed` (body `_make_streamed_kernel`, line 174):
// the same verdicts as `verdicts_kernel` (csrc/dbl_query.cu), bitwise, with
// the query axis cut into QB-lane chunks that stream through a two-stage
// ring in shared memory.  On the TPU the wrapper stacked the gathered rows
// into (nchunks, 4, W, QB) blocks in HBM and one program double-buffered
// them into VMEM; here the gather is the copy itself.
//
// Persistent blocks, about one per SM, each walk chunks c = blockIdx.x,
// blockIdx.x + gridDim.x, ...  One thread owns one lane of a chunk.  While
// the block computes chunk c from one ring slot, the cp.async copies of its
// next chunk's rows (DL_out[u], DL_in[v], DL_out[v], DL_in[u], BL_in[u],
// BL_in[v], BL_out[u], BL_out[v], W words each, gathered by the lane's ids)
// and freshness words land in the other slot (<cuda_pipeline.h>: commit one
// group per chunk, wait for all but the newest).  Words sit word-major in a
// slot ([row][word][lane]), so the threads of a warp touch consecutive
// banks.  The ragged tail of the last chunk is masked; nothing is padded.
//
// The cutoffs arrive pre-combined, as in the TPU wrapper: `ncut` (0, 1 or
// 2) rows of 0/1 freshness, row 0 = (m_cut >= m_total), row 1 =
// (d_cut >= d_total).
//
// Bound: bytes.  Per lane the kernel reads two ids, eight label rows and
// ncut freshness words and writes one verdict; the arithmetic is a few
// logic ops per word.  At a serving batch that is microseconds of traffic,
// so what counts is keeping enough gathers in flight per SM: the ring holds
// two chunks' gathers per block while the previous chunk computes.
#include <cstdint>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

namespace {

constexpr int QB = 128;   // lanes per chunk = threads per block

__device__ __forceinline__ int clamp_id(int x, int n) {
  return x < 0 ? 0 : (x >= n ? n - 1 : x);
}

// Words of one ring slot: 4 DL rows, 4 BL rows, ncut freshness rows and the
// two raw ids, each (words, QB) word-major.
__host__ __device__ __forceinline__ int slot_words(int wd, int wb) {
  return (4 * wd + 4 * wb + 2 + 2) * QB;
}

__global__ void __launch_bounds__(QB) streamed_verdicts_kernel(
    const int* __restrict__ dl_in, const int* __restrict__ dl_out, int wd,
    const int* __restrict__ bl_in, const int* __restrict__ bl_out, int wb,
    int n_cap, const int* __restrict__ u, const int* __restrict__ v, int q,
    const int* __restrict__ cut, int ncut, void* out, int out_int8) {
  extern __shared__ __align__(16) int ring[];
  const int nchunks = (q + QB - 1) / QB;
  const int lane = threadIdx.x;
  const int sw = slot_words(wd, wb);

  // Start the copies of chunk c into ring slot s (this thread's lane only).
  auto fetch = [&](int c, int s) {
    const int i = c * QB + lane;
    if (i >= q) return;
    int* dst = ring + s * sw;
    const int ur = u[i], vr = v[i];
    dst[(4 * wd + 4 * wb + 2) * QB + lane] = ur;
    dst[(4 * wd + 4 * wb + 3) * QB + lane] = vr;
    const size_t uu = clamp_id(ur, n_cap), vv = clamp_id(vr, n_cap);
    const int* dl_rows[4] = {dl_out + uu * wd, dl_in + vv * wd,
                             dl_out + vv * wd, dl_in + uu * wd};
    const int* bl_rows[4] = {bl_in + uu * wb, bl_in + vv * wb,
                             bl_out + uu * wb, bl_out + vv * wb};
    for (int r = 0; r < 4; ++r)
      for (int w = 0; w < wd; ++w)
        __pipeline_memcpy_async(dst + (r * wd + w) * QB + lane,
                                dl_rows[r] + w, sizeof(int));
    int* bdst = dst + 4 * wd * QB;
    for (int r = 0; r < 4; ++r)
      for (int w = 0; w < wb; ++w)
        __pipeline_memcpy_async(bdst + (r * wb + w) * QB + lane,
                                bl_rows[r] + w, sizeof(int));
    int* cdst = dst + (4 * wd + 4 * wb) * QB;
    for (int r = 0; r < ncut; ++r)
      __pipeline_memcpy_async(cdst + r * QB + lane, cut + (size_t)r * q + i,
                              sizeof(int));
  };

  int c = blockIdx.x;
  if (c < nchunks) fetch(c, 0);
  __pipeline_commit();
  for (int j = 0; c < nchunks; ++j, c += gridDim.x) {
    const int next = c + gridDim.x;
    if (next < nchunks) fetch(next, (j + 1) & 1);
    __pipeline_commit();
    __pipeline_wait_prior(1);   // chunk c's group has landed
    const int i = c * QB + lane;
    if (i < q) {
      const int* s = ring + (j & 1) * sw;
      const int* dl = s;                       // dlo_u dli_v dlo_v dli_u
      const int* bl = s + 4 * wd * QB;         // bi_u bi_v bo_u bo_v
      const int* ct = s + (4 * wd + 4 * wb) * QB;
      const bool same = ct[2 * QB + lane] == ct[3 * QB + lane];
      bool pos_lbl = false, thm = false;
      for (int w = 0; w < wd; ++w) {
        const int a = dl[(0 * wd + w) * QB + lane];
        const int b = dl[(1 * wd + w) * QB + lane];
        const int cc = dl[(2 * wd + w) * QB + lane];
        const int d = dl[(3 * wd + w) * QB + lane];
        pos_lbl |= (a & b) != 0;                                  // Lemma 1
        thm |= ((cc & d) != 0) | ((a & d) != 0) | ((cc & b) != 0);  // Thm 1-2
      }
      bool bl_neg = false;
      for (int w = 0; w < wb; ++w) {                              // Lemma 2
        const int biu = bl[(0 * wb + w) * QB + lane];
        const int biv = bl[(1 * wb + w) * QB + lane];
        const int bou = bl[(2 * wb + w) * QB + lane];
        const int bov = bl[(3 * wb + w) * QB + lane];
        bl_neg |= ((biu & ~biv) != 0) | ((bov & ~bou) != 0);
      }
      bool pos = pos_lbl | same;
      bool neg = !pos & (bl_neg | thm);
      if (ncut >= 1) {
        const bool fresh = ct[lane] != 0;
        if (ncut == 2) {
          const bool d_fresh = ct[QB + lane] != 0;
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
    // the slot just read is the target of the next fetch
    __syncthreads();
  }
}

}  // namespace

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Shared memory one block of the streamed verdict kernel takes.
extern "C" int dbl_query_streamed_smem_bytes(int wd, int wb) {
  return 2 * slot_words(wd, wb) * static_cast<int>(sizeof(int));
}

// All pointers are device pointers; cut is (ncut, q) int32 0/1 rows and may
// be NULL when ncut == 0.  blocks is the number of persistent blocks (the
// caller passes about one per SM).  Returns the error of the shared-memory
// opt-in or cudaGetLastError() after the launch.
extern "C" int dbl_query_verdicts_streamed(
    const int* dl_in, const int* dl_out, int wd,
    const int* bl_in, const int* bl_out, int wb, int n_cap,
    const int* u, const int* v, int q, const int* cut, int ncut,
    void* out, int out_int8, int blocks, void* stream) {
  const int smem = dbl_query_streamed_smem_bytes(wd, wb);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        streamed_verdicts_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int nchunks = (q + QB - 1) / QB;
  if (blocks > nchunks) blocks = nchunks;
  streamed_verdicts_kernel<<<blocks, QB, smem,
                             static_cast<cudaStream_t>(stream)>>>(
      dl_in, dl_out, wd, bl_in, bl_out, wb, n_cap, u, v, q, cut, ncut, out,
      out_int8);
  return static_cast<int>(cudaGetLastError());
}
