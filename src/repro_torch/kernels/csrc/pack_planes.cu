// Packs the four 0/1 label planes of a DBL index (DL_in, DL_out, BL_in,
// BL_out) into int32 words, in one launch, for Hopper (sm_90a).
//
// Replaces no TPU kernel: on the TPU the pack (`bitset.pack` in
// src/repro/core/bitset.py) was left to XLA.  It was added because the
// port's plain pack (src/repro_torch/core/bitset.py `pack`) widens every
// byte to int64, multiplies by the bit weights and sums: some 7.5 GB of
// traffic a plane at LiveJournal's 4.85 M rows, after every insert.
//
// Layout as `bitset.pack`: plane (n, k) bool/uint8 row-major, words
// (n, ceil(k/32)) int32, lane j in word j / 32 at bit j % 32, LSB first,
// pad bits zero.  The bytes are 0 or 1.
//
// Bound: bytes.  Each input byte is read once and each output word
// written once: n (2k + 2k') + 4 n (2 ceil(k/32) + 2 ceil(k'/32)) bytes,
// 1.40 GB at n = 4 847 571, k = k' = 64, 0.42 ms at 3.35 TB/s.  The
// operations, one multiply, shift and OR per 8 bytes, lie far below.
//
// Design: one flat grid-stride walk over the words of all four planes
// (plane, row, word), one word a thread, on as many 256-thread blocks as
// the card holds at once, so every block walks the same share.
// Neighbouring threads read neighbouring 32-byte runs, so a warp's loads
// cover 1 KB of contiguous bytes, and write neighbouring words.  Where
// k % 8 == 0 and the plane's base is 8-byte aligned (the served k = 64),
// a word's bytes come in 8-byte loads, and 8 bytes become 8 bits with
// one multiply (`bits8`) instead of 8 compares and shifts (the last word
// of a row may hold fewer than 32 bytes, still a multiple of 8).  Any
// other k, or a base off 8 bytes, reads bytes.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int PLANES = 4;

// How a plane's words are read (the wrapper's `plane_mode`).
enum Mode : int { BYTES = 0, VEC8 = 1 };

struct Plane {
  const uint8_t* in;  // (n, k) bytes, row-major
  int32_t* out;       // (n, w) words
  long long first;    // flat index of the plane's first word
  int k, w, mode;
};

struct Planes {
  Plane p[PLANES];
  long long total;    // words of all four planes
};

// Eight 0/1 bytes, the first at the lowest address, to 8 bits LSB first.
// Byte i sits at bit 8 i of x; the magic's byte 7 - i (2^(7-i)) moves it
// to bit 56 + i, and no other product term reaches bits 56..63 or carries
// into them.
__device__ __forceinline__ uint32_t bits8(uint64_t x) {
  return static_cast<uint32_t>((x * 0x0102040810204080ull) >> 56);
}

__device__ __forceinline__ int32_t pack_word(const Plane& p, long long t) {
  const long long row = t / p.w;
  const int word = static_cast<int>(t - row * p.w);
  const uint8_t* src = p.in + row * p.k + word * 32;
  const int len = min(32, p.k - word * 32);  // the last word may be short
  uint32_t bits = 0;
  if (p.mode == VEC8) {
    const auto* src8 = reinterpret_cast<const unsigned long long*>(src);
    for (int c = 0; c < len / 8; ++c) bits |= bits8(__ldg(src8 + c)) << 8 * c;
  } else {
    for (int c = 0; c < len; ++c) bits |= uint32_t(__ldg(src + c) != 0) << c;
  }
  return static_cast<int32_t>(bits);
}

__global__ void __launch_bounds__(THREADS) pack_planes_kernel(const Planes P) {
  __shared__ Plane s[PLANES];
  if (threadIdx.x == 0) {
#pragma unroll
    for (int j = 0; j < PLANES; ++j) s[j] = P.p[j];
  }
  __syncthreads();
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < P.total; i += step) {
    // planes of no words share their successor's `first`
    const int j = (i >= s[1].first) + (i >= s[2].first) + (i >= s[3].first);
    const Plane& p = s[j];
    const long long t = i - p.first;
    p.out[t] = pack_word(p, t);
  }
}

}  // namespace

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// All pointers are device pointers: the four (n, k) / (n, k_bl) byte
// planes and their four word outputs.  mode_* (`Mode`) come from the
// wrapper's `plane_mode`.  The grid is as many blocks as the card holds at
// once, fewer for a small pack.  Returns cudaGetLastError() after the
// launch (or the error of the occupancy query); launches nothing when
// there are no words.
extern "C" int pack_label_planes(
    const void* dl_in, const void* dl_out, const void* bl_in,
    const void* bl_out, void* dl_in_w, void* dl_out_w, void* bl_in_w,
    void* bl_out_w, int n, int k_dl, int k_bl, int mode_dl_in,
    int mode_dl_out, int mode_bl_in, int mode_bl_out, void* stream) {
  const void* in[PLANES] = {dl_in, dl_out, bl_in, bl_out};
  void* out[PLANES] = {dl_in_w, dl_out_w, bl_in_w, bl_out_w};
  const int k[PLANES] = {k_dl, k_dl, k_bl, k_bl};
  const int mode[PLANES] = {mode_dl_in, mode_dl_out, mode_bl_in, mode_bl_out};
  Planes P;
  long long first = 0;
  for (int j = 0; j < PLANES; ++j) {
    const int w = (k[j] + 31) / 32;
    P.p[j] = Plane{static_cast<const uint8_t*>(in[j]),
                   static_cast<int32_t*>(out[j]), first, k[j], w, mode[j]};
    first += static_cast<long long>(n) * w;
  }
  P.total = first;
  if (P.total == 0) return 0;
  int device = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, pack_planes_kernel, THREADS, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long need = (P.total + THREADS - 1) / THREADS;
  const long long fill = static_cast<long long>(per_sm > 0 ? per_sm : 1) * sms;
  const int blocks = static_cast<int>(need < fill ? need : fill);
  pack_planes_kernel<<<blocks, THREADS, 0,
                       static_cast<cudaStream_t>(stream)>>>(P);
  return static_cast<int>(cudaGetLastError());
}
