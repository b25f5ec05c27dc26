// Lane-interleaved rANS decode straight into linear stream rows, for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/rans_decode.py
// (_rans_group_kernel, wrapper rans_decode_pallas) together with the
// linearization that follows it in the decoder. The TPU kernel decodes a
// group of streams as a (group, k_max) state tile, gets each lane's word
// offset from a lane-axis cumsum of the renorm mask, and writes step-major
// rows padded to the longest stream. Here the rANS lane is the CUDA lane
// (one warp per stream), the exclusive renorm prefix is
// __popc(__ballot_sync(...) & lanemask_lt), and symbol i of a stream (step
// i / K, lane i % K) is stored at byte i of its segment in one (B, row)
// u8 tensor:
//   [literals: block_size | lengths: 2*max_cmds | offsets: ob*max_cmds |
//    commands: 2*max_cmds | pad to a multiple of 16],
// the layout the LZ77 match kernel reads. Each segment is zero past its
// stream's symbols, up to the next segment; nothing is written outside
// the row.
//
// What bounds it: the bytes it must move (stream words in, linear rows
// out) are the bound, but a warp's step is a dependent chain of a few
// dozen instructions (that issuing them is what holds the kernel back is
// a hypothesis no issue metric has tested); the design cuts the step and
// keeps the SMs full:
//   * one 32-bit slot entry per class, (symbol, freq - 1, slot - cum),
//     turns a step's lookups into one shared-memory load;
//   * CTA (x, c) decodes stream class c of `group` blocks, so it stages
//     one class's 16 KB slot table, not four; class 0 (the long literal
//     streams) comes first in launch order, the short plane streams fill
//     in behind it;
//   * the stream's words sit in a two-register window of 32 words each,
//     loaded coalesced; a renormalizing lane takes its word with a
//     shuffle, and the next 32 words load when the first 32 are spent, so
//     a step loads nothing; the rare window move is one branch;
//   * at most 32 registers a thread, so 64 warps fit on an SM;
//   * the output is written once, linear, instead of padded step-major
//     rows that a gather then reorders.
// Every word index is clamped, so a malformed archive never faults.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

// Makes `device` current for a launcher's body and restores the caller's
// current device when the launcher returns, so a launch on one card
// leaves the caller's next allocation where it was.
struct DeviceGuard {
  int prev = -1;
  cudaError_t set(int device) {
    cudaError_t err = cudaGetDevice(&prev);
    if (err != cudaSuccess) {
      prev = -1;
      return err;
    }
    return cudaSetDevice(device);
  }
  ~DeviceGuard() {
    if (prev >= 0) cudaSetDevice(prev);
  }
};

constexpr int kLanes = 32;          // MAX_LANES == warp size
constexpr int kClasses = 4;         // N_STREAMS, one segment each
constexpr int kProbBits = 12;
constexpr int kProbScale = 1 << kProbBits;
constexpr uint32_t kRansL = 1u << 16;
constexpr int kMaxGroup = 16;       // warps (blocks) per CTA

struct Layout {
  int start[kClasses + 1];          // segment starts; start[4] = row width
  int width[kClasses];              // bytes of stream symbols per segment
};

__device__ __forceinline__ uint32_t word_at(const uint16_t* __restrict__ w,
                                            int64_t n_words, int64_t i) {
  i = i < 0 ? 0 : (i > n_words - 1 ? n_words - 1 : i);
  return __ldg(w + i);
}

// bytes [lo, hi) of p set to 0 by one warp, 16 bytes per lane where aligned
__device__ void zero_fill(uint8_t* p, int lo, int hi, int lane) {
  if (lo >= hi) return;
  uint8_t* a = p + lo;
  uint8_t* e = p + hi;
  uint8_t* a16 = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(a) + 15) & ~uintptr_t{15});
  uint8_t* e16 = reinterpret_cast<uint8_t*>(
      reinterpret_cast<uintptr_t>(e) & ~uintptr_t{15});
  if (a16 >= e16) {
    for (uint8_t* q = a + lane; q < e; q += kLanes) *q = 0;
    return;
  }
  for (uint8_t* q = a + lane; q < a16; q += kLanes) *q = 0;
  for (uint4* q = reinterpret_cast<uint4*>(a16) + lane;
       q < reinterpret_cast<uint4*>(e16); q += kLanes)
    *q = make_uint4(0, 0, 0, 0);
  for (uint8_t* q = e16 + lane; q < e; q += kLanes) *q = 0;
}

// at most 16 warps a CTA; 32 registers a thread keep 64 warps on an SM
__global__ void __launch_bounds__(kMaxGroup * kLanes,
                                  2048 / (kMaxGroup * kLanes))
rans_decode_kernel(const uint16_t* __restrict__ words, int64_t n_words,
                   const int64_t* __restrict__ word_off,
                   const int32_t* __restrict__ n_syms,
                   const int32_t* __restrict__ lanes,
                   const uint32_t* __restrict__ slots, int n_blocks,
                   int group, Layout lay, uint8_t* __restrict__ out) {
  __shared__ uint4 s_tab4[kProbScale / 4];
  const int cls = blockIdx.y;
  const uint4* tab4 = reinterpret_cast<const uint4*>(slots) +
                      cls * (kProbScale / 4);
  for (int i = threadIdx.x; i < kProbScale / 4; i += blockDim.x)
    s_tab4[i] = __ldg(tab4 + i);
  __syncthreads();
  const uint32_t* tab = reinterpret_cast<const uint32_t*>(s_tab4);

  const int warp = threadIdx.x / kLanes;
  const int lane = threadIdx.x % kLanes;
  const int b = blockIdx.x * group + warp;
  if (b >= n_blocks) return;        // no barrier follows

  // this class's segment (constant indices keep `lay` in parameter space)
  int w = 0, seg = 0, seg_end = 0;
#pragma unroll
  for (int c = 0; c < kClasses; ++c) {
    if (c == cls) {
      w = lay.width[c];
      seg = lay.start[c];
      seg_end = lay.start[c + 1];
    }
  }
  const int s = b * kClasses + cls;
  const int n = n_syms[s];
  int K = lanes[s];
  K = K < 1 ? 1 : (K > kLanes ? kLanes : K);
  const int n_out = n < 0 ? 0 : (n > w ? w : n);   // symbols written
  const int T = (n_out + K - 1) / K;               // steps decoded
  uint8_t* dst = out + static_cast<int64_t>(b) * lay.start[kClasses] + seg;
  const bool lane_ok = lane < K;

  if (T > 0) {
    // initial lane states: two little-endian u16 words per lane
    const int64_t woff = word_off[s];
    int64_t si = woff + 2 * (lane < K ? lane : K - 1);
    si = si < 0 ? 0 : (si > n_words - 2 ? n_words - 2 : si);
    uint32_t x = static_cast<uint32_t>(__ldg(words + si)) |
                 (static_cast<uint32_t>(__ldg(words + si + 1)) << 16);
    const int64_t data = woff + 2 * K;
    // word window: w0 holds words [base, base + 32), w1 the next 32; c =
    // words of w0 already taken, < 32 at the top of every step, and a
    // step takes at most 32 words, so every word a step needs is in it
    int c = 0;
    int64_t base = data;
    uint32_t w0 = word_at(words, n_words, base + lane);
    uint32_t w1 = word_at(words, n_words, base + kLanes + lane);
    const uint32_t lt_mask = (1u << lane) - 1u;
    uint8_t* o = dst + lane;        // this lane's next symbol byte
    int left = n_out - lane;        // > 0 while that byte is in the stream
    for (int t = 0; t < T; ++t) {   // T is warp-uniform
      const uint32_t e = tab[x & (kProbScale - 1)];
      uint32_t nx = ((e >> 8 & 0xFFFu) + 1u) * (x >> kProbBits) + (e >> 20);
      const bool renorm = lane_ok && nx < kRansL;
      const uint32_t m = __ballot_sync(0xffffffffu, renorm);
      const int idx = c + __popc(m & lt_mask);
      const int cn = c + __popc(m);
      uint32_t word = __shfl_sync(0xffffffffu, w0, idx & 31);
      if (cn >= kLanes) {           // the step used up w0: about 1 in 6
        // w1 is read only here, so its load, issued when the window last
        // moved, stays off the chain until then
        const uint32_t hi = __shfl_sync(0xffffffffu, w1, idx & 31);
        word = idx < kLanes ? word : hi;
        base += kLanes;
        w0 = w1;
        w1 = word_at(words, n_words, base + kLanes + lane);
        c = cn - kLanes;
      } else {
        c = cn;
      }
      if (renorm) nx = (nx << 16) | word;
      if (lane_ok) {
        x = nx;
        if (left > 0) *o = static_cast<uint8_t>(e);
      }
      o += K;
      left -= K;
    }
  }
  zero_fill(dst, n_out, seg_end - seg, lane);
}

}  // namespace

extern "C" int rans_decode_launch(const void* words, long long n_words,
                                  const void* word_off, const void* n_syms,
                                  const void* lanes, const void* slots,
                                  int n_blocks, int group,
                                  const int* seg_start, const int* seg_width,
                                  void* out, int device, void* stream) {
  if (group < 1 || group > kMaxGroup)
    return static_cast<int>(cudaErrorInvalidValue);
  DeviceGuard guard;
  cudaError_t err = guard.set(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  Layout lay;
  for (int c = 0; c <= kClasses; ++c) lay.start[c] = seg_start[c];
  for (int c = 0; c < kClasses; ++c) lay.width[c] = seg_width[c];
  const dim3 grid((n_blocks + group - 1) / group, kClasses);
  rans_decode_kernel<<<grid, group * kLanes, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint16_t*>(words), n_words,
      static_cast<const int64_t*>(word_off),
      static_cast<const int32_t*>(n_syms), static_cast<const int32_t*>(lanes),
      static_cast<const uint32_t*>(slots), n_blocks, group, lay,
      static_cast<uint8_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* rans_decode_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
