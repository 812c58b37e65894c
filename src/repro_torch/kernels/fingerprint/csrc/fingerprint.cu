// Tensor fingerprint for NVIDIA Hopper, sm_90a.
//
// Replaces the TPU kernel repro/kernels/fingerprint/kernel.py:45
// (fingerprint_blocks, body _fp_kernel) and the fold it calls (_fold,
// repro/kernels/fingerprint/ref.py:45).  The input's bytes, zero-padded to
// whole 4096-byte blocks, are read as little-endian uint32 words; each of
// the 1024 lanes l of a block carries its own accumulator through all the
// blocks in order, all arithmetic mod 2^32:
//
//   acc_0[l]     = SEED ^ (l * PHI)
//   acc_{i+1}[l] = (acc_i[l] * M1) ^ (block_i[l] + (i+1) * PHI)
//
// and the 1024 accumulators are folded to two words.  The token must equal
// the JAX package's bit for bit.
//
// What bounds it on the H100: each input byte is read once and takes about
// 0.75 integer operations, so the bytes bound it (3.35 TB/s; 0.97 ms for a
// 3.25 GB tensor).  No kernel of this definition reaches that bound: the
// step (acc * M1) ^ y does not compose into anything a parallel scan could
// use, so each lane is one chain of n_blocks dependent IMAD -> LOP3 steps
// (792,576 of them for 3.25 GB, some 2.4 ms at 6 cycles a step and
// 1.98 GHz), and only 1024 threads exist to consume the bytes.  To let the
// chains, not the loads, set the pace, about 3 MB must be in flight across
// the card: far more than 1024 threads can hold in registers.
//
// The route is chosen by the input's address, never by failure:
//
// * 16-byte-aligned inputs (every leaf of a parameter tree: PyTorch aligns
//   its allocations) take fingerprint_tma.  The whole blocks are a 2-d
//   tensor (n_full rows of 1024 uint32 words, row stride 4096 B) read by TMA
//   in stages of (lanes of this CTA) x (rows blocks), each one or more
//   boxes of at most 256 rows completing on one mbarrier (expect-tx), into a
//   ring of `stages` stages in shared memory.  A CTA is two warps.  Each of
//   warp 0's first `lanes` threads owns one lane and reads its word of each
//   block from shared memory (a warp reads one row of a box: no bank
//   conflicts).  The reads and the `w + salt` adds run a group of kGroup
//   blocks ahead of the chain, into a second set of registers, so the chain
//   itself is one IMAD and one LOP3 a block.  Warp 0 releases a stage (an
//   mbarrier arrive) as soon as it has read its last block; one thread of
//   warp 1, the producer, then refills it with the stage `stages` ahead, so
//   the chain warp never waits on a copy's issue.  Each stage still costs
//   the chain warp a few hundred cycles, so stages are tall.  A wait longer
//   than kHangCycles traps, so a wrong byte count fails the run instead of
//   hanging the card.  Rows past n_full in the last stage are zero-filled
//   by TMA and never chained.
// * any other input (a byte view at an offset that is not a multiple of
//   16) takes fingerprint_ring, read in place: one thread per lane, 32 CTAs
//   of one warp, each thread keeping kDepth blocks in flight in a register
//   ring.  A view that does not start on a 4-byte boundary (an odd byte
//   offset, a 16-bit view at an odd element) is read as the aligned words
//   around each word, joined with a funnel shift.  Only aligned words holding
//   at least one input byte are loaded, so nothing is read outside the pages
//   the input lies on.
//
// In both, the partial last block is masked in the kernel, never padded in
// memory: words past the end read as 0, and a word only partly inside the
// input is built from its bytes, little-endian, with zeros above them.  The
// fold is a second launch of one CTA of 1024 threads: an xor reduction by
// warp shuffles, then across the 32 warps in shared memory.
//
// cuTensorMapEncodeTiled is a driver function, reached through the
// runtime's entry-point query: the library links nothing beyond cudart.

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr uint32_t kSeed = 0x9E3779B9u;
constexpr uint32_t kPhi = 0x85EBCA6Bu;
constexpr uint32_t kM1 = 0xC2B2AE35u;
constexpr int kLanes = 1024;             // uint32 words of a block
constexpr long long kBlockBytes = 4LL * kLanes;
constexpr int kWarp = 32;                // threads of a CTA, both routes
constexpr int kDepth = 64;               // ring route: blocks in flight a thread
constexpr int kGroup = 32;               // TMA route: blocks a group of reads
constexpr int kMaxBoxRows = 256;         // TMA's limit on a box dim
constexpr int kMaxSmem = 227 * 1024;     // dynamic shared memory a CTA may use
// A wait longer than this (about 2 s at the H100's clock) is a fault (a
// byte count that never completes); the kernel traps instead of hanging.
constexpr long long kHangCycles = 1LL << 32;

// One step of a lane's chain: block i's word w enters as w + (i + 1) * PHI.
__device__ __forceinline__ uint32_t step(uint32_t acc, uint32_t w_salted) {
  return (acc * kM1) ^ w_salted;
}

// A word of the input, all four bytes inside it, from the aligned word `lo`
// that holds its first byte and the aligned word `hi` after it; `shift` is
// 8 * (the input's address mod 4).  The ring holds the loads and the join
// waits for the use, so that loads, not finished words, are in flight.
template <bool kAligned>
__device__ __forceinline__ uint32_t join(uint32_t lo, uint32_t hi, int shift) {
  return kAligned ? lo : __funnelshift_r(lo, hi, shift);
}

// Word `k` of an input of `n` bytes, with the bytes at n and beyond read as
// 0.  `base` points at the aligned word holding the input's first byte,
// which lies `r` bytes into it.
__device__ __forceinline__ uint32_t tail_word(const uint32_t* base, long long k,
                                              int r, long long n) {
  const long long first = 4 * k;  // the input byte the word starts at
  if (first >= n) return 0u;
  // base[k] holds input bytes first - r .. first + 3 - r, so byte `first`;
  // base[k + 1] holds first + 4 - r .. first + 7 - r
  uint32_t w = __ldg(base + k);
  if (r != 0) {
    const uint32_t hi = (first + 4 - r < n) ? __ldg(base + k + 1) : 0u;
    w = __funnelshift_r(w, hi, 8 * r);
  }
  const long long valid = n - first;
  if (valid < 4) w &= (1u << (8 * valid)) - 1u;
  return w;
}

// The partial last block, if any, into the lane's accumulator.
__device__ __forceinline__ uint32_t tail_step(uint32_t acc, const uint32_t* base, int lane, int r,
                                              long long n, long long n_full) {
  if (n_full * kBlockBytes >= n) return acc;
  const uint32_t salt = static_cast<uint32_t>(n_full + 1) * kPhi;
  return step(acc, tail_word(base, n_full * kLanes + lane, r, n) + salt);
}

// ---------------------------------------------------------------------------
// Ring route: any address
// ---------------------------------------------------------------------------

// One thread per lane: the accumulator through every block, into acc[lane].
template <bool kAligned>
__global__ void __launch_bounds__(kWarp)
    fingerprint_ring(const uint32_t* __restrict__ base, int r, long long n,
                     long long n_full, uint32_t* __restrict__ acc_out) {
  const int lane = blockIdx.x * kWarp + threadIdx.x;
  const uint32_t* p = base + lane;  // this lane's word of block 0
  const int shift = 8 * r;
  uint32_t acc = kSeed ^ (static_cast<uint32_t>(lane) * kPhi);
  uint32_t salt = 0u;  // (i + 1) * PHI once advanced for block i

  // Block i + j sits in slot j of the ring (lo, and hi when misaligned);
  // the slot is refilled with block i + kDepth + j as soon as it is read.
  uint32_t lo[kDepth] = {}, hi[kDepth] = {};
#pragma unroll
  for (int j = 0; j < kDepth; ++j) {
    if (j < n_full) {
      lo[j] = __ldg(p + j * kLanes);
      if (!kAligned) hi[j] = __ldg(p + j * kLanes + 1);
    }
  }

  long long i = 0;
  for (; i + kDepth <= n_full; i += kDepth) {
#pragma unroll
    for (int j = 0; j < kDepth; ++j) {
      const uint32_t w = join<kAligned>(lo[j], hi[j], shift);
      const long long next = i + kDepth + j;
      if (next < n_full) {
        lo[j] = __ldg(p + next * kLanes);
        if (!kAligned) hi[j] = __ldg(p + next * kLanes + 1);
      }
      salt += kPhi;
      acc = step(acc, w + salt);
    }
  }
  // The last n_full % kDepth full blocks, already loaded.
#pragma unroll
  for (int j = 0; j < kDepth; ++j) {
    if (i + j < n_full) {
      salt += kPhi;
      acc = step(acc, join<kAligned>(lo[j], hi[j], shift) + salt);
    }
  }
  acc_out[lane] = tail_step(acc, base, lane, r, n, n_full);
}

// ---------------------------------------------------------------------------
// TMA route: 16-byte-aligned inputs
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}

__device__ __forceinline__ bool mbar_try(uint32_t bar, uint32_t parity) {
  uint32_t ok;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(ok)
      : "r"(bar), "r"(parity)
      : "memory");
  return ok != 0;
}

// Wait until the barrier's phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try(bar, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try(bar, parity))
    if (clock64() - t0 > kHangCycles) __trap();
}

// The box at (lane0, row0) of the 2-d map (1024 words, n_full rows) into
// shared memory at `dst`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int lane0, int row0) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(lane0), "r"(row0), "r"(bar)
      : "memory");
}

// Bytes of dynamic shared memory: the ring, 1024-aligned, then its full and
// empty barriers.
__host__ __device__ constexpr int tma_ring_bytes(int lanes, int rows, int stages) {
  return stages * lanes * rows * 4;
}
__host__ __device__ constexpr int tma_smem_bytes(int lanes, int rows, int stages) {
  return tma_ring_bytes(lanes, rows, stages) + 16 * stages + 1024;
}

// Reads the words of kGroup blocks: rows r .. r + kGroup - 1 of a stage.
__device__ __forceinline__ void read_group(uint32_t (&w)[kGroup], const uint32_t* col, int kL,
                                           int r) {
#pragma unroll
  for (int u = 0; u < kGroup; ++u) w[u] = col[(r + u) * kL];
}

// Chains the kGroup blocks of `w`, the first of them block b, salt = b * PHI,
// and reads the next group's words into `next` (rows r..), one a step: the
// read and the salt add do not depend on acc, so they fill the chain's stall
// slots (IMAD then LOP3, some 10 cycles a block).
template <bool kRead>
__device__ __forceinline__ uint32_t chain_group(uint32_t acc, const uint32_t (&w)[kGroup],
                                                uint32_t salt, uint32_t (&next)[kGroup],
                                                const uint32_t* col, int kL, int r) {
#pragma unroll
  for (int u = 0; u < kGroup; ++u) {
    if (kRead) next[u] = col[(r + u) * kL];
    acc = step(acc, w[u] + salt + static_cast<uint32_t>(u + 1) * kPhi);
  }
  return acc;
}

// Two warps per CTA.  Warp 0's threads 0 .. kL - 1 own lanes
// blockIdx.x * kL + thread and chain them; one thread of warp 1 is the
// producer, refilling each stage as soon as warp 0 releases it.  `rows`, the
// blocks of a stage, is a multiple of 2 * kGroup, and of kMaxBoxRows when
// larger.
template <int kL>
__global__ void __launch_bounds__(2 * kWarp)
    fingerprint_tma(const __grid_constant__ CUtensorMap map, const uint32_t* __restrict__ base,
                    long long n, long long n_full, int rows, int stages,
                    uint32_t* __restrict__ acc_out) {
  extern __shared__ unsigned char smem_raw[];
  // offset, not cast, to 1024 bytes, so that the reads stay shared-memory loads
  const int pad = static_cast<int>((1024u - (smem_addr(smem_raw) & 1023u)) & 1023u);
  uint32_t* ring = reinterpret_cast<uint32_t*>(smem_raw + pad);
  const uint32_t ring_s = smem_addr(ring);
  const uint32_t full0 = ring_s + tma_ring_bytes(kL, rows, stages);  // stage s filled
  const uint32_t empty0 = full0 + 8 * stages;                        // stage s read
  const int tid = threadIdx.x;
  const int lane0 = blockIdx.x * kL;
  const int stage_words = kL * rows;
  const uint32_t stage_bytes = 4u * stage_words;
  const int box_rows = rows < kMaxBoxRows ? rows : kMaxBoxRows;
  const uint32_t box_bytes = 4u * kL * box_rows;
  const long long loads = (n_full + rows - 1) / rows;  // stages filled, in order

  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (tid >= kWarp) {  // the producer
    if (tid == kWarp) {
      int s = 0;            // the stage of load t and the parity of its phases
      uint32_t phase = 0u;  // (counted, not divided: a 64-bit division is slow)
      for (long long t = 0; t < loads; ++t) {
        if (t >= stages) mbar_wait(empty0 + 8 * s, phase ^ 1u);  // load t - stages read
        mbar_expect_tx(full0 + 8 * s, stage_bytes);
        for (int q = 0; q < rows / box_rows; ++q)  // a stage is one or more boxes
          tma_load(ring_s + s * stage_bytes + q * box_bytes, &map, full0 + 8 * s, lane0,
                   static_cast<int>(t * rows + q * box_rows));
        if (++s == stages) {
          s = 0;
          phase ^= 1u;
        }
      }
    }
    return;
  }

  const int lane = lane0 + tid;
  uint32_t acc = kSeed ^ (static_cast<uint32_t>(lane) * kPhi);
  const bool chains = tid < kL;
  constexpr uint32_t kGroupSalt = static_cast<uint32_t>(kGroup) * kPhi;
  int s = 0;
  uint32_t phase = 0u;
  for (long long t = 0; t < loads; ++t) {
    mbar_wait(full0 + 8 * s, phase);
    const uint32_t* col = ring + s * stage_words + tid;  // this lane's word of each block
    const long long b0 = t * rows;                       // the stage's first block
    // block b0 + r enters with (b0 + r + 1) * PHI = salt + (r + 1) * PHI
    uint32_t salt = static_cast<uint32_t>(b0) * kPhi;
    if (chains && n_full - b0 >= rows) {
      // A whole stage: two groups of words in registers, one read while the
      // chain runs the other, so the chain is one IMAD and one LOP3 a block.
      uint32_t wa[kGroup], wb[kGroup];
      read_group(wa, col, kL, 0);
      int r = 0;
      for (; r + 2 * kGroup < rows; r += 2 * kGroup) {
        acc = chain_group<true>(acc, wa, salt, wb, col, kL, r + kGroup);
        acc = chain_group<true>(acc, wb, salt + kGroupSalt, wa, col, kL, r + 2 * kGroup);
        salt += 2 * kGroupSalt;
      }
      acc = chain_group<true>(acc, wa, salt, wb, col, kL, r + kGroup);
      acc = chain_group<false>(acc, wb, salt + kGroupSalt, wa, col, kL, 0);
    } else if (chains) {  // the last stage, partly past n_full
      const int live = static_cast<int>(n_full - b0);
      for (int r = 0; r < live; ++r) {
        salt += kPhi;
        acc = step(acc, col[r * kL] + salt);
      }
    }
    __syncwarp();  // the whole warp has read stage s: release it to the producer
    if (tid == 0) mbar_arrive(empty0 + 8 * s);
    if (++s == stages) {
      s = 0;
      phase ^= 1u;
    }
  }
  if (chains) acc_out[lane] = tail_step(acc, base, lane, 0, n, n_full);
}

using EncodeTiled = decltype(&cuTensorMapEncodeTiled);

// The driver's cuTensorMapEncodeTiled, looked up once; null if the driver
// lacks it.
EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

template <int kL>
cudaError_t launch_tma(const uint32_t* base, long long n, long long n_full, int rows, int stages,
                       uint32_t* acc, cudaStream_t st) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorSymbolNotFound;
  CUtensorMap map;
  // an input of less than one block loads no box; the map still needs a row
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(kLanes),
                              static_cast<cuuint64_t>(n_full > 0 ? n_full : 1)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(kBlockBytes)};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(kL),
                             static_cast<cuuint32_t>(rows < kMaxBoxRows ? rows : kMaxBoxRows)};
  const cuuint32_t unit[2] = {1, 1};
  if (encode(&map, CU_TENSOR_MAP_DATA_TYPE_UINT32, 2, const_cast<uint32_t*>(base), dims, strides,
             box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return cudaErrorInvalidValue;
  const int smem = tma_smem_bytes(kL, rows, stages);
  cudaError_t err =
      cudaFuncSetAttribute(fingerprint_tma<kL>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  fingerprint_tma<kL><<<kLanes / kL, 2 * kWarp, smem, st>>>(map, base, n, n_full, rows, stages,
                                                            acc);
  return cudaGetLastError();
}

__device__ __forceinline__ uint32_t warp_xor(uint32_t v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v ^= __shfl_xor_sync(0xFFFFFFFFu, v, o);
  return v;
}

// One CTA of 1024 threads: the 1024 accumulators to the (2,) token.
__global__ void __launch_bounds__(kLanes)
    fingerprint_fold(const uint32_t* __restrict__ acc, uint32_t* __restrict__ out) {
  __shared__ uint32_t part[2][kLanes / 32];
  const int l = threadIdx.x;
  const uint32_t mixed = acc[l] * (static_cast<uint32_t>(l) | 1u);
  uint32_t h = warp_xor(mixed);
  uint32_t h2 = warp_xor((mixed ^ (mixed >> 16)) * kM1);
  if ((l & 31) == 0) {
    part[0][l >> 5] = h;
    part[1][l >> 5] = h2;
  }
  __syncthreads();
  if (l < 32) {
    h = warp_xor(part[0][l]);
    h2 = warp_xor(part[1][l]);
    if (l == 0) {
      h = (h ^ (h >> 15)) * kPhi;
      h2 = (h2 ^ (h2 >> 13)) * kM1;
      out[0] = h ^ (h >> 16);
      out[1] = h2 ^ (h2 >> 15);
    }
  }
}

}  // namespace

// data: n > 0 bytes; acc: 1024 uint32 of scratch; out: the (2,) uint32
// token.  route 0 (TMA) needs a 16-byte-aligned `data` and takes stages of
// `lanes` (8, 16 or 32) x `rows` words (`rows` a multiple of 64 up to 256,
// or of 256: boxes of at most 256 rows) in a ring of `stages`;
// route 1 (register ring) takes any address and ignores the three.  Both
// launches go on `stream`.  Returns a cudaError_t (0 = launched); an input the route
// cannot take is refused, not rerouted.
extern "C" int repro_fingerprint(const void* data, long long n, int route, int lanes, int rows,
                                 int stages, uint32_t* acc, uint32_t* out, void* stream) {
  if (data == nullptr || n <= 0 || acc == nullptr || out == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const uintptr_t addr = reinterpret_cast<uintptr_t>(data);
  const long long n_full = n / kBlockBytes;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (route == 0) {
    if (addr % 16 != 0) return static_cast<int>(cudaErrorMisalignedAddress);
    if (rows <= 0 || rows % (2 * kGroup) != 0 || (rows > kMaxBoxRows && rows % kMaxBoxRows) ||
        stages <= 0 || tma_smem_bytes(lanes, rows, stages) > kMaxSmem)
      return static_cast<int>(cudaErrorInvalidValue);
    const uint32_t* base = static_cast<const uint32_t*>(data);
    switch (lanes) {
      case 8: err = launch_tma<8>(base, n, n_full, rows, stages, acc, st); break;
      case 16: err = launch_tma<16>(base, n, n_full, rows, stages, acc, st); break;
      case 32: err = launch_tma<32>(base, n, n_full, rows, stages, acc, st); break;
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  } else if (route == 1) {
    const int r = static_cast<int>(addr & 3u);
    const uint32_t* base = reinterpret_cast<const uint32_t*>(addr - r);
    const int grid = kLanes / kWarp;
    if (r == 0)
      fingerprint_ring<true><<<grid, kWarp, 0, st>>>(base, r, n, n_full, acc);
    else
      fingerprint_ring<false><<<grid, kWarp, 0, st>>>(base, r, n, n_full, acc);
    err = cudaGetLastError();
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  fingerprint_fold<<<1, kLanes, 0, st>>>(acc, out);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* repro_fingerprint_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
