// Lane-interleaved rANS decode, one warp per stream, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/rans_decode.py
// (_rans_group_kernel, wrapper rans_decode_pallas). The TPU kernel decodes
// a group of streams as a (group, k_max) state tile and turns the renorm
// mask into per-lane word offsets with a lane-axis cumsum. Here the rANS
// lane IS the CUDA lane: warp w of a CTA owns stream blockIdx.x*group + w,
// its 32 lanes hold the 32 lane states, and the exclusive prefix of the
// renorm mask is __popc(__ballot_sync(...) & lanemask_lt).
//
// What bounds it: each step is a short dependent chain (table lookups ->
// multiply -> ballot -> a word load when a lane renormalizes), so a warp is
// latency-bound and the card is filled by many streams in flight, not by
// bandwidth. The freq/cum/sym tables of the 4 stream classes (19 KB) sit
// in shared memory so the lookups never touch device memory; each stream
// reads only its own words at word_off (the TPU kernel took the whole
// word buffer as one block). Output is zero outside valid symbols.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kLanes = 32;          // MAX_LANES == warp size
constexpr int kClasses = 4;         // N_STREAMS
constexpr int kProbBits = 12;
constexpr int kProbScale = 1 << kProbBits;
constexpr uint32_t kRansL = 1u << 16;

__global__ void rans_decode_kernel(const uint16_t* __restrict__ words,
                                   int64_t n_words,
                                   const int64_t* __restrict__ word_off,
                                   const int32_t* __restrict__ n_syms,
                                   const int32_t* __restrict__ lanes,
                                   const int32_t* __restrict__ class_ids,
                                   const uint16_t* __restrict__ freq,
                                   const uint16_t* __restrict__ cum,
                                   const uint8_t* __restrict__ sym,
                                   int n_streams, int t_max, int group,
                                   uint8_t* __restrict__ out) {
  __shared__ uint16_t s_freq[kClasses * 256];
  __shared__ uint16_t s_cum[kClasses * 256];
  __shared__ __align__(16) uint8_t s_sym[kClasses * kProbScale];
  for (int i = threadIdx.x; i < kClasses * 256; i += blockDim.x) {
    s_freq[i] = freq[i];
    s_cum[i] = cum[i];
  }
  const uint4* sym4 = reinterpret_cast<const uint4*>(sym);
  uint4* s_sym4 = reinterpret_cast<uint4*>(s_sym);
  for (int i = threadIdx.x; i < kClasses * kProbScale / 16; i += blockDim.x)
    s_sym4[i] = sym4[i];
  __syncthreads();

  const int warp = threadIdx.x / kLanes;
  const int lane = threadIdx.x % kLanes;
  const int s = blockIdx.x * group + warp;
  if (s >= n_streams) return;       // no barrier follows

  const int steps = t_max > 0 ? t_max : 1;
  uint8_t* row = out + static_cast<int64_t>(s) * steps * kLanes;
  const int n = n_syms[s];
  const int K = lanes[s] > 1 ? lanes[s] : 1;
  const int cls = class_ids[s];
  int T = n > 0 ? (n + K - 1) / K : 0;
  if (T > t_max) T = t_max;
  const bool lane_ok = lane < K;
  const int64_t woff = word_off[s];
  const uint32_t lt_mask = (1u << lane) - 1u;

  if (T > 0) {
    // initial lane states: two little-endian u16 words per lane
    const int st_lane = lane < K ? lane : K - 1;
    int64_t si = woff + 2 * st_lane;
    si = si < 0 ? 0 : (si > n_words - 2 ? n_words - 2 : si);
    uint32_t x = static_cast<uint32_t>(words[si])
                 | (static_cast<uint32_t>(words[si + 1]) << 16);
    const int64_t data = woff + 2 * K;
    int64_t cursor = 0;
    const uint16_t* f_tab = s_freq + cls * 256;
    const uint16_t* c_tab = s_cum + cls * 256;
    const uint8_t* s_tab = s_sym + cls * kProbScale;
    for (int t = 0; t < T; ++t) {   // T is warp-uniform
      const uint32_t slot = x & (kProbScale - 1);
      const uint8_t sy = s_tab[slot];
      uint32_t nx = static_cast<uint32_t>(f_tab[sy]) * (x >> kProbBits)
                    + slot - static_cast<uint32_t>(c_tab[sy]);
      const bool renorm = lane_ok && nx < kRansL;
      const uint32_t m = __ballot_sync(0xffffffffu, renorm);
      if (renorm) {
        int64_t wi = data + cursor + __popc(m & lt_mask);
        wi = wi < 0 ? 0 : (wi > n_words - 1 ? n_words - 1 : wi);
        nx = (nx << 16) | static_cast<uint32_t>(words[wi]);
      }
      cursor += __popc(m);
      if (lane_ok) x = nx;
      row[t * kLanes + lane] = lane_ok ? sy : 0;
    }
  }
  for (int t = T; t < steps; ++t) row[t * kLanes + lane] = 0;
}

}  // namespace

extern "C" int rans_decode_launch(const void* words, long long n_words,
                                  const void* word_off, const void* n_syms,
                                  const void* lanes, const void* class_ids,
                                  const void* freq, const void* cum,
                                  const void* sym, int n_streams, int t_max,
                                  int group, void* out, int device,
                                  void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int grid = (n_streams + group - 1) / group;
  rans_decode_kernel<<<grid, group * kLanes, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint16_t*>(words), n_words,
      static_cast<const int64_t*>(word_off),
      static_cast<const int32_t*>(n_syms), static_cast<const int32_t*>(lanes),
      static_cast<const int32_t*>(class_ids),
      static_cast<const uint16_t*>(freq), static_cast<const uint16_t*>(cum),
      static_cast<const uint8_t*>(sym), n_streams, t_max, group,
      static_cast<uint8_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* rans_decode_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
