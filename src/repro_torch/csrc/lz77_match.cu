// LZ77 match resolution for self-contained ("ra") blocks, one CTA per
// block, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/lz77_match.py
// (_decode_block_kernel, wrapper lz77_decode_blocks_pallas), which decodes
// one block per grid step entirely in VMEM. The same five steps run here
// inside one CTA:
//   1. exclusive scans of command totals and literal lengths (CUB block
//      scans over tiles of the command axis, carried across tiles);
//   2. command-of-byte: +1 at every command end, then an inclusive scan
//      over the output bytes;
//   3. one source pointer per output byte: a literal index, or a match
//      source with the self-overlap fold off + (k mod d);
//   4. pointer-doubling rounds, ping-pong between two i32 arrays with one
//      __syncthreads per round; the loop stops after the first round in
//      which no pointer moved (a fixpoint, so the bytes equal those of the
//      full round count) and never runs past `rounds`;
//   5. literal payout.
//
// What bounds it: every round is a dependent gather over the whole block,
// so the work is operations on the pointer arrays, not device-memory
// bytes. The design keeps those arrays out of device memory where they
// fit: at the 16 KiB default block the two ping-pong arrays (128 KB) live
// in dynamic shared memory. At the 1 MiB paper-1 block (8 MiB of pointers)
// they live in a global scratch buffer the wrapper allocates; one CTA
// still owns one block, so __syncthreads per round is still the only
// barrier needed. Per-command start positions and literal bases go to a
// global scratch row (the command count is data-dependent and can exceed
// shared memory at 1 MiB blocks); they are read back through L1/L2.
//
// Malformed command planes decode to garbage that digest verification
// reports; every memory index is clamped, so they never fault.
#include <cstdint>
#include <cuda_runtime.h>
#include <cub/block/block_scan.cuh>

namespace {

constexpr int kItems = 4;            // scan items per thread per tile

struct RunningPrefix {
  int total;
  __device__ int operator()(int block_aggregate) {
    const int old = total;
    total += block_aggregate;
    return old;
  }
};

template <int NT>
__global__ void __launch_bounds__(NT)
lz77_decode_kernel(const int32_t* __restrict__ lit_lens,
                   const int32_t* __restrict__ match_lens,
                   const int32_t* __restrict__ offsets,
                   const int32_t* __restrict__ n_cmds,
                   const uint8_t* __restrict__ literals,
                   const int32_t* __restrict__ block_len,
                   int n_cmd_cols, int lit_cols, int out_size, int rounds,
                   int use_smem, int32_t* __restrict__ cmd_scratch,
                   int32_t* __restrict__ ptr_scratch,
                   uint8_t* __restrict__ out) {
  using BlockScan = cub::BlockScan<int, NT>;
  __shared__ typename BlockScan::TempStorage scan_tmp;
  extern __shared__ int32_t dyn_smem[];

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int C = n_cmd_cols;
  const int64_t crow = static_cast<int64_t>(b) * C;
  const int32_t* ll_row = lit_lens + crow;
  const int32_t* ml_row = match_lens + crow;
  const int32_t* off_row = offsets + crow;
  int32_t* P_row = cmd_scratch + 2 * crow;          // command start
  int32_t* lit_base_row = P_row + C;                // literal base
  int32_t* A;
  int32_t* Bf;
  if (use_smem) {
    A = dyn_smem;
    Bf = dyn_smem + out_size;
  } else {
    A = ptr_scratch + static_cast<int64_t>(b) * 2 * out_size;
    Bf = A + out_size;
  }
  const int nc = n_cmds[b];
  const int blen = block_len[b];

  // marks: A[i] counts the valid commands that end exactly at byte i
  for (int i = tid; i < out_size; i += NT) A[i] = 0;
  __syncthreads();

  // 1. command scans, tile by tile, carrying the running totals
  RunningPrefix tot_prefix{0}, lit_prefix{0};
  for (int base = 0; base < C; base += NT * kItems) {
    int tot[kItems], ll[kItems];
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      const int j = base + tid * kItems + k;
      const bool v = j < C && j < nc;
      ll[k] = v ? ll_row[j] : 0;
      tot[k] = v ? ll[k] + ml_row[j] : 0;
    }
    int tot_ex[kItems], ll_ex[kItems];
    BlockScan(scan_tmp).ExclusiveSum(tot, tot_ex, tot_prefix);
    __syncthreads();
    BlockScan(scan_tmp).ExclusiveSum(ll, ll_ex, lit_prefix);
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      const int j = base + tid * kItems + k;
      if (j < C) {
        P_row[j] = tot_ex[k];
        lit_base_row[j] = ll_ex[k];
        const int end = tot_ex[k] + tot[k];
        if (j < nc && end >= 0 && end < out_size) atomicAdd(&A[end], 1);
      }
    }
  }
  __syncthreads();

  // 2. command-of-byte: inclusive scan of the marks, in place
  RunningPrefix mark_prefix{0};
  for (int base = 0; base < out_size; base += NT * kItems) {
    int v[kItems];
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      const int i = base + tid * kItems + k;
      v[k] = i < out_size ? A[i] : 0;
    }
    __syncthreads();
    BlockScan(scan_tmp).InclusiveSum(v, v, mark_prefix);
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      const int i = base + tid * kItems + k;
      if (i < out_size) A[i] = v[k];
    }
  }
  __syncthreads();

  // 3. one source pointer per output byte, into Bf
  for (int i = tid; i < out_size; i += NT) {
    int c = A[i];
    c = c < C - 1 ? c : C - 1;
    const int P = P_row[c];
    const int ll = c < nc ? ll_row[c] : 0;
    const int off = off_row[c];
    const int rel = i - P;
    int p;
    if (rel < ll) {
      p = -(lit_base_row[c] + rel + 1);
    } else {
      int d = P + ll - off;
      d = d > 1 ? d : 1;
      int k = (rel - ll) % d;
      k = k < 0 ? k + d : k;
      p = off + k;
    }
    Bf[i] = i < blen ? p : -1;
  }
  __syncthreads();

  // 4. pointer doubling, ping-pong Bf -> A -> Bf ...
  int32_t* src = Bf;
  int32_t* dst = A;
  for (int r = 0; r < rounds; ++r) {
    int moved = 0;
    for (int i = tid; i < out_size; i += NT) {
      const int p = src[i];
      int q = p;
      if (p >= 0) q = src[p < out_size ? p : out_size - 1];
      dst[i] = q;
      moved |= q != p;
    }
    const int any = __syncthreads_or(moved);
    int32_t* t = src;
    src = dst;
    dst = t;
    if (!any) break;
  }

  // 5. literal payout
  const uint8_t* lit_row = literals + static_cast<int64_t>(b) * lit_cols;
  uint8_t* out_row = out + static_cast<int64_t>(b) * out_size;
  for (int i = tid; i < out_size; i += NT) {
    int li = -src[i] - 1;
    li = li < 0 ? 0 : (li > lit_cols - 1 ? lit_cols - 1 : li);
    out_row[i] = lit_row[li];
  }
}

template <int NT>
cudaError_t launch(const int32_t* ll, const int32_t* ml, const int32_t* off,
                   const int32_t* nc, const uint8_t* lits,
                   const int32_t* blen, int n_blocks, int C, int L,
                   int out_size, int rounds, int use_smem,
                   int32_t* cmd_scratch, int32_t* ptr_scratch, uint8_t* out,
                   cudaStream_t stream) {
  const size_t smem = use_smem ? 2ull * out_size * sizeof(int32_t) : 0;
  cudaError_t err = cudaFuncSetAttribute(
      lz77_decode_kernel<NT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  lz77_decode_kernel<NT><<<n_blocks, NT, smem, stream>>>(
      ll, ml, off, nc, lits, blen, C, L, out_size, rounds, use_smem,
      cmd_scratch, ptr_scratch, out);
  return cudaGetLastError();
}

}  // namespace

extern "C" int lz77_decode_launch(const void* lit_lens, const void* match_lens,
                                  const void* offsets, const void* n_cmds,
                                  const void* literals, const void* block_len,
                                  int n_blocks, int n_cmd_cols, int lit_cols,
                                  int out_size, int rounds, int use_smem,
                                  void* cmd_scratch, void* ptr_scratch,
                                  void* out, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  auto args = [&](auto fn) {
    return fn(static_cast<const int32_t*>(lit_lens),
              static_cast<const int32_t*>(match_lens),
              static_cast<const int32_t*>(offsets),
              static_cast<const int32_t*>(n_cmds),
              static_cast<const uint8_t*>(literals),
              static_cast<const int32_t*>(block_len), n_blocks, n_cmd_cols,
              lit_cols, out_size, rounds, use_smem,
              static_cast<int32_t*>(cmd_scratch),
              static_cast<int32_t*>(ptr_scratch), static_cast<uint8_t*>(out),
              static_cast<cudaStream_t>(stream));
  };
  // small blocks take fewer threads so several CTAs share an SM
  err = out_size >= 8192 ? args(launch<1024>) : args(launch<256>);
  return static_cast<int>(err);
}

extern "C" const char* lz77_decode_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
