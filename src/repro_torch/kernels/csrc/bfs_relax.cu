// One relax step of the batched BFS (the residue rounds of Alg 2 and the
// B-BFS baseline), for Hopper (sm_90a).
//
// Replaces no TPU kernel: on the TPU the step (`relax` in
// src/repro/core/query.py) was left to XLA.  The port's plain step
// (src/repro_torch/kernels/bfs_relax/bfs_relax.py `relax_plain`) reduces
// the frontier's rows, reads the host for the edges whose tail is on the
// frontier (`nonzero`), gathers their (E_f, Q) rows, and scatters them
// into a zero-filled plane by a byte max with atomics (`index_reduce_`).
//
// Semantics as `relax_plain`: out (n, Q) bool, out[h][q] = 1 iff some edge
// slot e < m has live[e], heads[e] = h, frontier[tails[e]][q] set and,
// with m_cut, e < m_cut[q].  Tails lie in [0, n) (`relax_edges` clamps
// them); a slot whose tail or head lies outside is skipped.  Any nonzero
// frontier byte is a set lane; the output bytes are 0 or 1.
//
// Bound: the function's compulsory bytes.  The frontier plane is read
// once and the output plane written once (2 n Q), each edge slot's live
// byte and tail read once (9 m), and for each live slot whose tail is on
// the frontier its head (8 E_f).  n = 2 394 385, Q = 64, m = 5.3 M: 0.35
// GB with an empty frontier, 0.10 ms at 3.35 TB/s.  The kernel reads a
// tail's row and writes a head's row again for each such slot (up to
// 2 Q E_f more): its gather cost, which the caches absorb in part.
//
// Design: a memset and two launches on the stream.
// 1. The output plane is zeroed (`cudaMemsetAsync`).
// 2. `relax_rows_kernel`, a thread a row, reads the row's frontier bytes;
//    a warp's ballot packs its 32 rows' "some lane set" into one word of
//    a bit set (n / 8 bytes, 0.3 MB at wiki-Talk's n, 0.6 MB at
//    LiveJournal's), small enough that the edge pass's random tests of
//    it mostly hit the L1 and L2 caches.
// 3. `relax_kernel`, a warp a tile of 128 edge slots, 4 a lane: a lane
//    reads its slots' live bytes in one 4-byte load and their tails in
//    two 16-byte loads (scalar loads in the ragged last tile; the wrapper
//    refuses edge arrays not so aligned), tests each tail's bit, and reads
//    the heads only where some slot is active.  For each of the 4 slots
//    the warp's ballot lists the active ones in shared memory, and the
//    warp walks their rows, a row's 16-byte words (or bytes, `BYTES`) to
//    a thread, cut per lane by m_cut, and ORs the set lanes into the
//    head's row.  Every writer of an output byte writes 1, so words go
//    in by a 64-bit `atomicOr` of eight lanes (a reduction, nothing read
//    back), skipped where an L2 read of the word finds its bits set
//    already (a hub's row is hit by many edges), and bytes by plain
//    stores, a benign race.  The cut is skipped for a block's slots below
//    the least m_cut.  No host read and no (E_f, Q) block in memory.
// Both grids are as many blocks as the card holds at once, fewer for a
// small step, walking their work by stride.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARP = 32;
constexpr int WARPS = THREADS / WARP;
constexpr int SLOTS = 4;               // edge slots a lane takes in a tile
constexpr int TILE = WARP * SLOTS;     // edge slots a warp takes
constexpr unsigned FULL = 0xffffffffu;

// How the rows are read and written (the wrapper's `row_mode`): bytes,
// or 16-byte words (Q % 16 == 0 and the frontier's base 16-byte aligned;
// the output is the wrapper's own allocation).
enum Mode : int { BYTES = 0, VEC16 = 1 };

struct Step {
  const uint8_t* frontier;  // (n, q)
  const int64_t* tails;     // (m,)
  const int64_t* heads;     // (m,)
  const uint8_t* live;      // (m,)
  const int32_t* m_cut;     // (q,) or null
  uint8_t* out;             // (n, q)
  uint32_t* on;             // (ceil(n / 32),) bit r % 32: row r has a lane
  int n, q, m, mode;
};

// Each nonzero byte of x to 0x01, each zero byte stays 0.
__device__ __forceinline__ uint32_t ones(uint32_t x) {
  return ((((x & 0x7f7f7f7fu) + 0x7f7f7f7fu) | x) >> 7) & 0x01010101u;
}

// The 0x01 bytes of the four lanes from `lane` on whose cut admits slot e.
__device__ __forceinline__ uint32_t cut4(const int32_t* m_cut, int lane,
                                         long long e) {
  uint32_t keep = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j)
    keep |= uint32_t(e < __ldg(m_cut + lane + j)) << 8 * j;
  return keep;
}

__global__ void __launch_bounds__(THREADS) relax_rows_kernel(const Step s) {
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  // the loop runs alike in every lane of a warp, for the ballot
  for (long long base = static_cast<long long>(blockIdx.x) * blockDim.x;
       base < s.n; base += step) {
    const long long r = base + threadIdx.x;
    uint32_t any = 0;
    if (r < s.n) {
      const uint8_t* f = s.frontier + r * s.q;
      if (s.mode == VEC16) {
        const auto* f16 = reinterpret_cast<const uint4*>(f);
        for (int c = 0; c < s.q / 16; ++c) {
          const uint4 v = __ldg(f16 + c);
          any |= v.x | v.y | v.z | v.w;
        }
      } else {
        for (int c = 0; c < s.q; ++c) any |= __ldg(f + c);
      }
    }
    // a warp's rows are 32 aligned ones: base is a multiple of 256
    const unsigned bits = __ballot_sync(FULL, any != 0);
    if (threadIdx.x % WARP == 0 && r < s.n) s.on[r / WARP] = bits;
  }
}

__global__ void __launch_bounds__(THREADS) relax_kernel(const Step s) {
  __shared__ int64_t tail_of[WARPS][WARP];
  __shared__ int64_t head_of[WARPS][WARP];
  __shared__ int slot_of[WARPS][WARP];
  __shared__ int least_cut;
  const int lane = threadIdx.x % WARP;
  const int w = threadIdx.x / WARP;
  if (threadIdx.x == 0) least_cut = 0x7fffffff;
  __syncthreads();
  if (s.m_cut != nullptr) {
    int least = 0x7fffffff;
    for (int q = threadIdx.x; q < s.q; q += THREADS)
      least = min(least, __ldg(s.m_cut + q));
    atomicMin(&least_cut, least);
  }
  __syncthreads();
  const long long least = s.m_cut != nullptr ? least_cut : 0x7fffffffLL;
  // a row's work items: 16-byte words or bytes
  const int per_row = s.mode == VEC16 ? s.q / 16 : s.q;
  const long long tiles = (static_cast<long long>(s.m) + TILE - 1) / TILE;
  const long long warps = static_cast<long long>(gridDim.x) * WARPS;
  for (long long tile = static_cast<long long>(blockIdx.x) * WARPS + w;
       tile < tiles; tile += warps) {
    const long long e0 = tile * TILE + SLOTS * lane;
    // live's base is 4-byte aligned, the tails' and heads' 16-byte
    const bool whole = e0 + SLOTS <= s.m;
    uint32_t lv = 0;  // byte j: slot e0 + j is live
    int64_t t[SLOTS], h[SLOTS];
    if (whole) {
      lv = __ldg(reinterpret_cast<const uint32_t*>(s.live + e0));
      const auto* t2 = reinterpret_cast<const longlong2*>(s.tails + e0);
      const longlong2 a = __ldg(t2), b = __ldg(t2 + 1);
      t[0] = a.x; t[1] = a.y; t[2] = b.x; t[3] = b.y;
    } else {
#pragma unroll
      for (int j = 0; j < SLOTS; ++j) {
        const bool in = e0 + j < s.m;
        lv |= uint32_t(in ? __ldg(s.live + e0 + j) : 0) << 8 * j;
        t[j] = in ? __ldg(s.tails + e0 + j) : -1;
      }
    }
    uint32_t act = 0;  // bit j: slot e0 + j is live, its tail on the frontier
#pragma unroll
    for (int j = 0; j < SLOTS; ++j)
      act |= uint32_t(((lv >> 8 * j) & 0xff) != 0 && t[j] >= 0 &&
                      t[j] < s.n &&
                      (__ldg(s.on + t[j] / WARP) >> (t[j] % WARP) & 1))
             << j;
    if (act != 0 && whole) {
      const auto* h2 = reinterpret_cast<const longlong2*>(s.heads + e0);
      const longlong2 a = __ldg(h2), b = __ldg(h2 + 1);
      h[0] = a.x; h[1] = a.y; h[2] = b.x; h[3] = b.y;
    } else {
#pragma unroll
      for (int j = 0; j < SLOTS; ++j)
        h[j] = (act >> j & 1) ? __ldg(s.heads + e0 + j) : -1;
    }
#pragma unroll
    for (int j = 0; j < SLOTS; ++j) {
      const bool active = (act >> j & 1) && h[j] >= 0 && h[j] < s.n;
      const unsigned mask = __ballot_sync(FULL, active);
      if (mask == 0) continue;
      if (active) {
        const int k = __popc(mask & ((1u << lane) - 1));
        tail_of[w][k] = t[j];
        head_of[w][k] = h[j];
        slot_of[w][k] = SLOTS * lane + j;
      }
      __syncwarp();
      const int items = __popc(mask) * per_row;
      for (int it = lane; it < items; it += WARP) {
        const int k = it / per_row;
        const int c = it - k * per_row;
        const long long slot = tile * TILE + slot_of[w][k];
        const bool cut = slot >= least;
        if (s.mode == VEC16) {
          const uint4 v = __ldg(reinterpret_cast<const uint4*>(
              s.frontier + tail_of[w][k] * s.q) + c);
          if ((v.x | v.y | v.z | v.w) == 0) continue;
          auto* o = reinterpret_cast<unsigned long long*>(
              s.out + head_of[w][k] * s.q + 16 * c);
          const uint32_t words[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            uint32_t lo = ones(words[2 * i]), hi = ones(words[2 * i + 1]);
            if (cut) {
              if (lo) lo &= cut4(s.m_cut, 16 * c + 8 * i, slot);
              if (hi) hi &= cut4(s.m_cut, 16 * c + 8 * i + 4, slot);
            }
            const unsigned long long bits =
                static_cast<unsigned long long>(hi) << 32 | lo;
            // bits are only ever set: one already there needs no atomic
            if (bits != 0 && (__ldcg(o + i) & bits) != bits)
              atomicOr(o + i, bits);
          }
        } else {
          if (__ldg(s.frontier + tail_of[w][k] * s.q + c) == 0) continue;
          if (cut && slot >= __ldg(s.m_cut + c)) continue;
          s.out[head_of[w][k] * s.q + c] = 1;
        }
      }
      __syncwarp();
    }
  }
}

// As many blocks of `kernel` as the card holds at once, at most `need`.
template <typename K>
cudaError_t fill_grid(K kernel, long long need, int* blocks) {
  int device = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        THREADS, 0);
  const long long fill = static_cast<long long>(per_sm > 0 ? per_sm : 1) * sms;
  *blocks = static_cast<int>(need < fill ? need : fill);
  return err;
}

}  // namespace

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// All pointers are device pointers: frontier and out (n, q) bytes, on
// (ceil(n / 32),) 32-bit words of scratch, tails and heads (m,) int64,
// live (m,) bytes with a 4-byte aligned base, tails' and heads' bases
// 16-byte aligned, m_cut (q,) int32 or NULL.  `mode` (`Mode`) comes from
// the wrapper's `row_mode`.  Zeroes the output and launches the row pass,
// then the edge pass when m > 0, on `stream`; returns cudaGetLastError()
// after them (or the error of the memset or of an occupancy query).
// Does nothing when n * q == 0.
extern "C" int bfs_relax(const void* frontier, const void* tails,
                         const void* heads, const void* live,
                         const void* m_cut, void* out, void* on, int n,
                         int q, int m, int mode, void* stream) {
  if (static_cast<long long>(n) * q == 0) return 0;
  const Step s{static_cast<const uint8_t*>(frontier),
               static_cast<const int64_t*>(tails),
               static_cast<const int64_t*>(heads),
               static_cast<const uint8_t*>(live),
               static_cast<const int32_t*>(m_cut),
               static_cast<uint8_t*>(out),
               static_cast<uint32_t*>(on), n, q, m, mode};
  const auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      cudaMemsetAsync(out, 0, static_cast<size_t>(n) * q, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  int blocks = 0;
  err = fill_grid(relax_rows_kernel,
                  (static_cast<long long>(n) + THREADS - 1) / THREADS,
                  &blocks);
  if (err != cudaSuccess) return static_cast<int>(err);
  relax_rows_kernel<<<blocks, THREADS, 0, st>>>(s);
  if (m > 0) {
    const long long tiles = (static_cast<long long>(m) + TILE - 1) / TILE;
    err = fill_grid(relax_kernel, (tiles + WARPS - 1) / WARPS, &blocks);
    if (err != cudaSuccess) return static_cast<int>(err);
    relax_kernel<<<blocks, THREADS, 0, st>>>(s);
  }
  return static_cast<int>(cudaGetLastError());
}
