// LZ77 match resolution of self-contained ("ra") blocks straight from the
// decoded byte planes, one CTA per block, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/lz77_match.py
// (_decode_block_kernel, wrapper lz77_decode_blocks_pallas) together with
// the plane decoding that precedes it in the decoder. The TPU kernel takes
// i32 command columns, finds each byte's command with a cumsum over the
// whole block in VMEM and runs blocks one after another. Here a CTA owns a
// block and takes the linear stream bytes the rANS kernel writes:
//   1. command prologue: the literal-length, match-length and offset byte
//      planes become (ll, ml, offset) per command in shared memory (the
//      first min(4, offset_bytes) offset planes, bit 31 masked at four);
//      one block scan gives each command's start and literal base (the
//      scans saturate at 2^30, so a malformed plane cannot wrap a start
//      back into the block);
//   2. per-command fill: warp w takes commands w, w + warps, ... and
//      writes the source pointer of each of their bytes: -(lit_base + rel
//      + 1) for a literal, off + k for a match byte, off + (k mod d) only
//      once k >= d; bytes past the last command follow the plain version's
//      rule for them, bytes past block_len get -1. No mark array, no scan
//      over the output bytes, no per-byte command lookup;
//   3. pointer doubling between two pointer arrays, one __syncthreads_or
//      per round, 16 bytes of pointers per thread at a time so its gathers
//      are independent; the loop stops after the first round in which no
//      pointer moved (a fixpoint, so the bytes equal those of the full
//      round count) and never runs past `rounds`;
//   4. payout: 16 output bytes per thread from the literal row, one
//      16-byte store.
// Rows whose size is not a multiple of 16 bytes take per-element rounds
// and per-byte stores instead of the vector forms.
//
// What bounds it: LZ77 decode itself needs only to read the planes and
// literals and write the block, so its floor is those bytes over HBM.
// This kernel spends far more than that on integer work in shared memory:
// the fill is a few operations per byte and every doubling round a
// dependent gather per byte, so what the design fights is how many blocks
// are in flight and how many instructions a byte costs. At out_size <=
// 32768 every pointer lies in [-32768, 32767] (literal pointers are >=
// -out_size, match pointers are clamped to out_size - 1 when written,
// which changes no output byte), so pointers are 16-bit, and the command
// table lives in the second pointer array until the first round needs it:
// at 16 KiB blocks a CTA takes 64 KB of shared memory and three share an
// SM. The literal row is read in place through the read-only cache;
// staging it in shared memory (16 KB more) measured slower, because it
// costs the third CTA. Blocks over 32 KiB keep i32 pointers and their
// command table in a global scratch row the wrapper allocates; one CTA
// still owns one block, so a __syncthreads per round is still the only
// barrier.
//
// Every memory index is clamped, so a malformed archive decodes to garbage
// that digest verification reports and never faults.
#include <cstdint>
#include <type_traits>
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

// Phase clocks, compiled in only with -DLZ77_PHASE_CLOCKS (as
// scripts/lz77_phase_clocks.py builds it): thread 0 of each CTA adds the SM
// clock cycles of the prologue, fill, rounds and payout to slots 0-3, each
// phase closed by a barrier, and counts the CTA in slot 4.
#ifdef LZ77_PHASE_CLOCKS
__device__ unsigned long long g_phase_clocks[5];
#define PHASE_START() long long phase_t = clock64()
#define PHASE_MARK(k)                                                   \
  if (threadIdx.x == 0) {                                               \
    const long long now = clock64();                                    \
    atomicAdd(&g_phase_clocks[k],                                       \
              static_cast<unsigned long long>(now - phase_t));          \
    phase_t = now;                                                      \
    if ((k) == 3) atomicAdd(&g_phase_clocks[4], 1ull);                  \
  }
#else
#define PHASE_START()
#define PHASE_MARK(k)
#endif

constexpr uint32_t kCap = 1u << 30;     // saturation of the command scans
constexpr int kCmdBytes = 16;           // command table bytes per command
constexpr int kSmemBudget = 200 * 1024; // dynamic shared memory per CTA

enum { kLit = 0, kLen = 1, kOff = 2, kCmd = 3 };

struct Planes {
  const uint8_t* row[4];      // block 0's literals, lengths, offsets, commands
  long long stride[4];        // row strides in bytes
  int width[4];               // segment widths in bytes
};

// where the working arrays live, decided once per geometry on the host
struct Plan {
  int ptr_bytes;              // 2 (out_size <= 32768, in shared memory) or 4
  int in_smem;                // 1: pointers and command table in shared
                              // memory; 0: both in global scratch
  int threads;
  int smem;                   // dynamic shared memory bytes
  int cmd_at;                 // command table offset (the pointers start at 0)
  long long scratch;          // global scratch bytes per block
};

constexpr int align16(long long n) {
  return static_cast<int>((n + 15) & ~15ll);
}

Plan make_plan(int out_size, int n_cmd_cols) {
  Plan p{};
  const long long cmd_sz = align16(kCmdBytes * n_cmd_cols);
  if (out_size <= 32768) {
    const long long one = 2ll * out_size;
    // the command table is dead before the first round writes the second
    // pointer array, so it lives there when it fits
    const bool overlay = cmd_sz + 16 <= one;
    p.cmd_at = overlay ? align16(one) : align16(2 * one);
    const long long need = align16(2 * one) + (overlay ? 0 : cmd_sz);
    if (need <= kSmemBudget) {
      p.ptr_bytes = 2;
      p.in_smem = 1;
      p.smem = static_cast<int>(need);
      p.threads = out_size <= 2048 ? 128 : 512;
      return p;
    }
  }
  p.ptr_bytes = 4;
  p.cmd_at = align16(8ll * out_size);
  p.scratch = p.cmd_at + cmd_sz;
  p.threads = 1024;
  return p;
}

__device__ __forceinline__ uint32_t sat(uint32_t x) {
  return x < kCap ? x : kCap;
}

// byte `idx` of a plane row of width w, clamped into the row
__device__ __forceinline__ uint32_t plane_byte(const uint8_t* row, int w,
                                               long long idx) {
  idx = idx < 0 ? 0 : (idx > w - 1 ? w - 1 : idx);
  return row[idx];
}

// exclusive block scan of two saturating sums; tot_* get the block totals
template <int NT>
__device__ void block_exscan2(uint32_t& a, uint32_t& b, uint32_t& tot_a,
                              uint32_t& tot_b, uint32_t (*s_warp)[2]) {
  constexpr int kWarps = NT / 32;
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  uint32_t ia = a, ib = b;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const uint32_t ua = __shfl_up_sync(0xffffffffu, ia, o);
    const uint32_t ub = __shfl_up_sync(0xffffffffu, ib, o);
    if (lane >= o) {
      ia = sat(ia + ua);
      ib = sat(ib + ub);
    }
  }
  uint32_t ea = __shfl_up_sync(0xffffffffu, ia, 1);
  uint32_t eb = __shfl_up_sync(0xffffffffu, ib, 1);
  if (lane == 0) ea = eb = 0;
  if (lane == 31) {
    s_warp[warp][0] = ia;
    s_warp[warp][1] = ib;
  }
  __syncthreads();
  if (warp == 0) {
    uint32_t wa = lane < kWarps ? s_warp[lane][0] : 0;
    uint32_t wb = lane < kWarps ? s_warp[lane][1] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const uint32_t ua = __shfl_up_sync(0xffffffffu, wa, o);
      const uint32_t ub = __shfl_up_sync(0xffffffffu, wb, o);
      if (lane >= o) {
        wa = sat(wa + ua);
        wb = sat(wb + ub);
      }
    }
    if (lane < kWarps) {
      s_warp[lane][0] = wa;
      s_warp[lane][1] = wb;
    }
  }
  __syncthreads();
  a = warp ? sat(s_warp[warp - 1][0] + ea) : ea;
  b = warp ? sat(s_warp[warp - 1][1] + eb) : eb;
  tot_a = s_warp[kWarps - 1][0];
  tot_b = s_warp[kWarps - 1][1];
}

// source pointers of bytes i0, i0 + step, ... < end of the command that
// starts at P with ll literal bytes (literal base lb) and then a match
// from off: -(lb + (i - P) + 1) for a literal byte, off + k for the k-th
// match byte, off + (k mod d) once k >= d (only a self-overlapping match
// gets there), clamped to n - 1, which changes no output byte; -1 past
// block_len
template <typename PtrT>
__device__ __forceinline__ void fill_command(PtrT* ptr, int i0, int end,
                                             int step, int P, int ll, int lb,
                                             int off, int blen, int n) {
  const int lit_end = P + ll;
  const int lit_bias = P - lb - 1;
  const int d0 = lit_end - off;
  const int d = d0 > 1 ? d0 : 1;
  end = end < n ? end : n;
  for (int i = i0; i < end; i += step) {
    int k = i - lit_end;
    if (k >= d) k %= d;
    const int m = off + k < n - 1 ? off + k : n - 1;
    const int p = k < 0 ? lit_bias - i : m;
    ptr[i] = static_cast<PtrT>(i < blen ? p : -1);
  }
}

template <typename PtrT, int NT, bool kSmem>
__global__ void __launch_bounds__(NT, kSmem && NT == 512 ? 3 : 1)
lz77_match_kernel(Planes pl, const int32_t* __restrict__ n_cmds,
                  const int32_t* __restrict__ block_len, int C, int N,
                  int off_planes, int mask_top, int rounds, Plan plan,
                  uint8_t* __restrict__ scratch, uint8_t* __restrict__ out) {
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ uint32_t s_warp[NT / 32][2];
  PHASE_START();

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int L = pl.width[kLit];

  // the literal row is read in place (L1/L2): staging it in shared memory
  // would cost the third resident CTA per SM at 16 KiB blocks
  const uint8_t* lits = pl.row[kLit] + b * pl.stride[kLit];

  uint8_t* base = kSmem ? smem : scratch + b * plan.scratch;
  PtrT* ptr = reinterpret_cast<PtrT*>(base);
  int32_t* cmd = reinterpret_cast<int32_t*>(base + plan.cmd_at);
  int32_t* cP = cmd;                                  // command start
  int32_t* cLB = cmd + C;                             // literal base
  int32_t* cOff = cmd + 2 * C;                        // match source
  uint32_t* cLM = reinterpret_cast<uint32_t*>(cmd + 3 * C);  // ll | ml << 16

  const int nc = n_cmds[b];
  const int blen = block_len[b];
  const int nv = nc < 0 ? 0 : (nc > C ? C : nc);      // valid commands

  // 1. command prologue: planes -> (ll, ml, off), then the two scans
  const uint8_t* len_row = pl.row[kLen] + b * pl.stride[kLen];
  const uint8_t* off_row = pl.row[kOff] + b * pl.stride[kOff];
  const uint8_t* cmd_row = pl.row[kCmd] + b * pl.stride[kCmd];
  for (int j = tid; j < C; j += NT) {
    uint32_t ll = 0, ml = 0, off = 0;
    if (j < nv) {
      const int wc = pl.width[kCmd], wl = pl.width[kLen], wo = pl.width[kOff];
      ll = plane_byte(cmd_row, wc, j) |
           plane_byte(cmd_row, wc, static_cast<long long>(nc) + j) << 8;
      ml = plane_byte(len_row, wl, j) |
           plane_byte(len_row, wl, static_cast<long long>(nc) + j) << 8;
      for (int p = 0; p < off_planes; ++p) {
        uint32_t byte = plane_byte(off_row, wo,
                                   static_cast<long long>(p) * nc + j);
        if (p == 3 && mask_top) byte &= 0x7Fu;
        off |= byte << (8 * p);
      }
    }
    cLM[j] = ll | ml << 16;
    cOff[j] = static_cast<int32_t>(off);
  }
  __syncthreads();
  const int ipt = (C + NT - 1) / NT;                  // commands per thread
  const int j0 = tid * ipt < C ? tid * ipt : C;
  const int j1 = j0 + ipt < C ? j0 + ipt : C;
  uint32_t st = 0, sl = 0;
  for (int j = j0; j < j1; ++j) {
    const uint32_t lm = cLM[j];
    st = sat(st + (lm & 0xFFFFu) + (lm >> 16));
    sl = sat(sl + (lm & 0xFFFFu));
  }
  uint32_t total, total_lit;
  block_exscan2<NT>(st, sl, total, total_lit, s_warp);
  for (int j = j0; j < j1; ++j) {
    const uint32_t lm = cLM[j];
    cP[j] = static_cast<int32_t>(st);
    cLB[j] = static_cast<int32_t>(sl);
    st = sat(st + (lm & 0xFFFFu) + (lm >> 16));
    sl = sat(sl + (lm & 0xFFFFu));
  }
  __syncthreads();
  PHASE_MARK(0);

  // 2. per-command fill; starts are nondecreasing, so a warp stops at the
  //    first of its commands that starts past the block
  for (int c = warp; c < nv; c += NT / 32) {
    const int P = cP[c];
    if (P >= N) break;
    const uint32_t lm = cLM[c];
    const int ll = static_cast<int>(lm & 0xFFFFu);
    fill_command(ptr, P + lane, P + ll + static_cast<int>(lm >> 16), 32, P,
                 ll, cLB[c], cOff[c], blen, N);
  }
  // bytes past the last command: the plain version gives them command
  // min(n_cmds, C - 1), an empty one at the end when n_cmds < C
  const int tail =
      total < static_cast<uint32_t>(N) ? static_cast<int>(total) : N;
  if (tail < N) {
    const int ct = nc < 0 ? 0 : (nc > C - 1 ? C - 1 : nc);
    if (ct < nv)
      fill_command(ptr, tail + tid, N, NT, cP[ct],
                   static_cast<int>(cLM[ct] & 0xFFFFu), cLB[ct], cOff[ct],
                   blen, N);
    else
      fill_command(ptr, tail + tid, N, NT, tail, 0,
                   static_cast<int>(total_lit), 0, blen, N);
  }
  __syncthreads();
  PHASE_MARK(1);

  // 3. pointer doubling, ping-pong between the two arrays; a thread takes
  //    16 bytes of pointers at a time, so its gathers are independent
  constexpr int kVec = 16 / static_cast<int>(sizeof(PtrT));
  union Vec {
    uint4 u;
    PtrT e[kVec];
  };
  const bool vec = N % kVec == 0;     // both arrays are then 16-byte aligned
  PtrT* src = ptr;
  PtrT* dst = ptr + N;
  for (int r = 0; r < rounds; ++r) {
    int moved = 0;
    if (vec) {
      for (int v = tid; v < N / kVec; v += NT) {
        Vec a, q;
        a.u = reinterpret_cast<const uint4*>(src)[v];
#pragma unroll
        for (int e = 0; e < kVec; ++e) {
          const int p = a.e[e];
          const int t = p >= 0 ? static_cast<int>(src[p]) : p;
          q.e[e] = static_cast<PtrT>(t);
          moved |= t != p;
        }
        reinterpret_cast<uint4*>(dst)[v] = q.u;
      }
    } else {
      for (int i = tid; i < N; i += NT) {
        const int p = src[i];
        const int q = p >= 0 ? static_cast<int>(src[p]) : p;
        dst[i] = static_cast<PtrT>(q);
        moved |= q != p;
      }
    }
    const int any = __syncthreads_or(moved);
    PtrT* t = src;
    src = dst;
    dst = t;
    if (!any) break;
  }
  PHASE_MARK(2);

  // 4. payout from the literal row, 16 bytes per thread where aligned
  uint8_t* out_row = out + static_cast<long long>(b) * N;
  auto lit_of = [&](int p) {
    int li = -p - 1;
    li = li < 0 ? 0 : (li > L - 1 ? L - 1 : li);
    return static_cast<uint32_t>(__ldg(lits + li));
  };
  if (N % 16 == 0 && reinterpret_cast<uintptr_t>(out_row) % 16 == 0) {
    for (int q = tid; q < N / 16; q += NT) {
      Vec a[16 / kVec];
#pragma unroll
      for (int h = 0; h < 16 / kVec; ++h)
        a[h].u = reinterpret_cast<const uint4*>(src)[q * (16 / kVec) + h];
      uint32_t v[4];
#pragma unroll
      for (int w = 0; w < 4; ++w) {
        v[w] = 0;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int e = 4 * w + k;
          v[w] |= lit_of(a[e / kVec].e[e % kVec]) << (8 * k);
        }
      }
      reinterpret_cast<uint4*>(out_row)[q] = make_uint4(v[0], v[1], v[2], v[3]);
    }
  } else {
    for (int i = tid; i < N; i += NT)
      out_row[i] = static_cast<uint8_t>(lit_of(src[i]));
  }
#ifdef LZ77_PHASE_CLOCKS
  __syncthreads();
#endif
  PHASE_MARK(3);
}

template <typename PtrT, int NT, bool kSmem>
cudaError_t launch(const Planes& pl, const int32_t* nc, const int32_t* blen,
                   int n_blocks, int C, int N, int off_planes, int mask_top,
                   int rounds, const Plan& plan, uint8_t* scratch,
                   uint8_t* out, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      lz77_match_kernel<PtrT, NT, kSmem>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, plan.smem);
  if (err != cudaSuccess) return err;
  lz77_match_kernel<PtrT, NT, kSmem><<<n_blocks, NT, plan.smem, stream>>>(
      pl, nc, blen, C, N, off_planes, mask_top, rounds, plan, scratch, out);
  return cudaGetLastError();
}

template <typename PtrT, int NT, bool kSmem>
cudaError_t occupancy(const Plan& plan, int* ctas) {
  cudaError_t err = cudaFuncSetAttribute(
      lz77_match_kernel<PtrT, NT, kSmem>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, plan.smem);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      ctas, lz77_match_kernel<PtrT, NT, kSmem>, NT, plan.smem);
}

// the one template instance a plan runs: (pointer type, threads, storage)
template <typename Fn>
cudaError_t dispatch(const Plan& plan, Fn&& fn) {
  using I128 = std::integral_constant<int, 128>;
  using I512 = std::integral_constant<int, 512>;
  using I1024 = std::integral_constant<int, 1024>;
  if (!plan.in_smem)
    return fn(static_cast<int32_t*>(nullptr), I1024{}, std::false_type{});
  return plan.threads == 128
             ? fn(static_cast<int16_t*>(nullptr), I128{}, std::true_type{})
             : fn(static_cast<int16_t*>(nullptr), I512{}, std::true_type{});
}

}  // namespace

// global scratch bytes per block (pointers, then the command table)
extern "C" int lz77_match_scratch(int out_size, int n_cmd_cols,
                                  long long* bytes) {
  *bytes = make_plan(out_size, n_cmd_cols).scratch;
  return 0;
}

// [resident CTAs per SM, threads, dynamic smem bytes, pointer bytes,
//  working arrays in shared memory]
extern "C" int lz77_match_occupancy(int out_size, int n_cmd_cols, int device,
                                    int* info) {
  DeviceGuard guard;
  cudaError_t err = guard.set(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Plan p = make_plan(out_size, n_cmd_cols);
  int ctas = 0;
  err = dispatch(p, [&](auto tag, auto nt, auto in_smem) {
    return occupancy<std::remove_pointer_t<decltype(tag)>,
                     decltype(nt)::value, decltype(in_smem)::value>(p, &ctas);
  });
  info[0] = ctas;
  info[1] = p.threads;
  info[2] = p.smem;
  info[3] = p.ptr_bytes;
  info[4] = p.in_smem;
  return static_cast<int>(err);
}

extern "C" int lz77_match_launch(const void* const* rows,
                                 const long long* strides, const int* widths,
                                 const void* n_cmds, const void* block_len,
                                 int n_blocks, int n_cmd_cols, int out_size,
                                 int offset_bytes, int rounds,
                                 void* scratch, void* out, int device,
                                 void* stream) {
  DeviceGuard guard;
  cudaError_t err = guard.set(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  Planes pl;
  for (int s = 0; s < 4; ++s) {
    pl.row[s] = static_cast<const uint8_t*>(rows[s]);
    pl.stride[s] = strides[s];
    pl.width[s] = widths[s];
  }
  const Plan p = make_plan(out_size, n_cmd_cols);
  const int off_planes = offset_bytes < 4 ? offset_bytes : 4;
  err = dispatch(p, [&](auto tag, auto nt, auto in_smem) {
    return launch<std::remove_pointer_t<decltype(tag)>, decltype(nt)::value,
                  decltype(in_smem)::value>(
        pl, static_cast<const int32_t*>(n_cmds),
        static_cast<const int32_t*>(block_len), n_blocks, n_cmd_cols,
        out_size, off_planes, offset_bytes >= 4, rounds, p,
        static_cast<uint8_t*>(scratch), static_cast<uint8_t*>(out),
        static_cast<cudaStream_t>(stream));
  });
  return static_cast<int>(err);
}

extern "C" const char* lz77_match_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

#ifdef LZ77_PHASE_CLOCKS
// copies the five phase-clock slots to `host` and zeroes them
extern "C" int lz77_phase_clocks(unsigned long long* host) {
  cudaError_t err = cudaMemcpyFromSymbol(host, g_phase_clocks,
                                         sizeof(g_phase_clocks));
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned long long zero[5] = {};
  return static_cast<int>(
      cudaMemcpyToSymbol(g_phase_clocks, zero, sizeof(zero)));
}
#endif
