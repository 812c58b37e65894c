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
// 1.98 GHz), and only 1024 threads exist to keep loads in flight.
//
// What the design does about it:
//  * one thread per lane, the block loop inside the thread (replacing the
//    TPU's sequential grid axis): 32 CTAs of one warp each, so the chains
//    run on 32 SMs and each warp's load of a block is one 128-byte line;
//  * the loads do not depend on acc, so each thread keeps kDepth blocks in
//    flight in a register ring (unrolled), loaded kDepth blocks ahead of use;
//  * the tail is masked in the kernel, never padded in memory: words past
//    the end read as 0, and a word only partly inside the input is built
//    from its bytes, little-endian, with zeros above them;
//  * an input that does not start on a 4-byte boundary (a byte view at an
//    odd offset, a 16-bit view at an odd element) is read as the aligned
//    words around each word, joined with a funnel shift.  Only aligned words
//    holding at least one input byte are loaded, so nothing is read outside
//    the pages the input lies on;
//  * the fold is a second launch of one CTA of 1024 threads: an xor
//    reduction by warp shuffles, then across the 32 warps in shared memory.
//
// Later work: a cp.async/TMA ring in shared memory to keep far more loads in
// flight than registers can, so that the chains, not the loads, set the time.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr uint32_t kSeed = 0x9E3779B9u;
constexpr uint32_t kPhi = 0x85EBCA6Bu;
constexpr uint32_t kM1 = 0xC2B2AE35u;
constexpr int kLanes = 1024;             // uint32 words of a block
constexpr long long kBlockBytes = 4LL * kLanes;
constexpr int kCtaLanes = 32;            // one warp per CTA
constexpr int kDepth = 64;               // blocks each thread keeps in flight

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

// One thread per lane: the accumulator through every block, into acc[lane].
template <bool kAligned>
__global__ void __launch_bounds__(kCtaLanes)
    fingerprint_lanes(const uint32_t* __restrict__ base, int r, long long n,
                      long long n_full, uint32_t* __restrict__ acc_out) {
  const int lane = blockIdx.x * kCtaLanes + threadIdx.x;
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
      acc = (acc * kM1) ^ (w + salt);
    }
  }
  // The last n_full % kDepth full blocks, already loaded.
#pragma unroll
  for (int j = 0; j < kDepth; ++j) {
    if (i + j < n_full) {
      salt += kPhi;
      acc = (acc * kM1) ^ (join<kAligned>(lo[j], hi[j], shift) + salt);
    }
  }
  // The partial last block, if any.
  if (n_full * kBlockBytes < n) {
    salt += kPhi;
    acc = (acc * kM1) ^ (tail_word(base, n_full * kLanes + lane, r, n) + salt);
  }
  acc_out[lane] = acc;
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

// data: n > 0 bytes at any address; acc: 1024 uint32 of scratch; out: the
// (2,) uint32 token.  Both launches go on `stream`.  Returns a cudaError_t
// (0 = launched).
extern "C" int repro_fingerprint(const void* data, long long n, uint32_t* acc,
                                 uint32_t* out, void* stream) {
  if (data == nullptr || n <= 0 || acc == nullptr || out == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const uintptr_t addr = reinterpret_cast<uintptr_t>(data);
  const int r = static_cast<int>(addr & 3u);
  const uint32_t* base = reinterpret_cast<const uint32_t*>(addr - r);
  const long long n_full = n / kBlockBytes;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int grid = kLanes / kCtaLanes;
  if (r == 0)
    fingerprint_lanes<true><<<grid, kCtaLanes, 0, st>>>(base, r, n, n_full, acc);
  else
    fingerprint_lanes<false><<<grid, kCtaLanes, 0, st>>>(base, r, n, n_full, acc);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  fingerprint_fold<<<1, kLanes, 0, st>>>(acc, out);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* repro_fingerprint_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
