// Flash-attention forward (grouped-query heads) for NVIDIA Hopper, sm_90a.
//
// Replaces the TPU kernel repro/kernels/flash_attention/kernel.py
// (_fa_kernel, launched by flash_attention_bh): softmax(scale * Q K^T + mask) V
// with an online softmax.  The mask is k_pos < Skv and, when causal,
// k_pos <= q_pos (both counted from 0), and with a sliding window of W keys
// (causal only) q_pos - k_pos < W; a row whose denominator is 0 divides by 1;
// the output has q's dtype.
//
// What bounds it on the H100: at qwen2.5-3b's serving prefill (B = 4,
// H = 16, KV = 2, S = 1024, hd = 128, causal) the work is 1.72e10 FLOP of
// products over 37.7 MB of q, k, v and o: 0.0174 ms at the bf16 tensor-core
// peak against 0.0113 ms at the memory rate, so the products bound it, and
// only the tensor cores can approach that bound.
//
// bfloat16 and float16 inputs take fa_fwd_tc, built for that, with the
// element type as a template parameter (the wgmma operand type and the
// tensor maps' data type follow it):
//  * both products run on the tensor cores with wgmma (f32 accumulate):
//    S = Q K^T with Q and K from shared memory (K stored keys x hd is the
//    K-major B operand), then O += P V with P from registers (the S
//    accumulator fragment, rounded to the input type, is the A fragment of
//    the next product, so no shuffle through shared memory) and V from
//    shared memory as an MN-major B operand (the transpose bit);
//  * the scale is applied to S in f32 after the product, folded with log2 e
//    into exp2 (the SFU's ex2.approx): a pre-scaled Q rounded to 16 bits
//    would add error;
//  * K and V stream through a 2-stage ring filled by TMA: one producer
//    warp issues the copies (mbarrier expect-tx completion) while two
//    consumer warpgroups of 64 q rows each run the products on the stage
//    before.  Q's 128-row tile is loaded once per CTA.  Below hd 256 the
//    producer warp keeps the consumers' register allotment: setmaxnreg acts
//    on a whole warpgroup, and one warp is a quarter of one;
//  * head dims 16, 32, 64, 80, 96, 128 and 256.  A row of hd elements is
//    cut into boxes of the widest of 64, 32 or 16 columns that divides hd,
//    each box one swizzle span (128, 64 or 32 bytes): hd 64, 128 and 256
//    in 64-column boxes, 96 in three of 32, 80 in five of 16.  The wgmma
//    descriptors name the same swizzle; along hd the boxes lie a box apart
//    (the K steps of Q K^T and the N atoms of the MN-major V);
//  * a K/V tile is 128 keys, or 64 at hd 256: Q's 64 KB and two stages of
//    64-key K and V tiles take 192 KB, where 128 keys would need 320 KB,
//    and the consumer keeps 128 O and 32 S accumulators instead of 128 and
//    64 in registers.  Even so a consumer thread spills at the 168
//    registers a thread of a 288-thread wgmma kernel gets (registers are
//    allotted by warpgroup).  So at hd 256 the producer is a whole
//    warpgroup, which keeps 24 registers and hands the rest to the two
//    consumer warpgroups (setmaxnreg: 240 each).  ptxas still compiles the
//    consumers to 168 and spills 224 bytes a thread (its -v report), but
//    the call ran 1.7 % faster than with a producer warp (NVIDIA H100 80GB
//    HBM3 at 700 W, Gemma-2-2B's prefill shape; bench.py);
//  * the branch between producer and consumers tests a warpgroup index
//    made uniform over the warp by a shuffle, as setmaxnreg needs; at the
//    models' prefills that alone ran no slower than testing threadIdx on
//    the same card (9 % faster at hd 64), with the same output bit for bit;
//  * the tensor maps are encoded on the host per call over the caller's
//    strided views (the model's permuted q, transposed k and v), so neither
//    the GQA broadcast nor a transpose is copied;
//  * the running max and denominator stay in registers, reduced across the
//    four threads that share an accumulator row; K/V tiles wholly above
//    the causal diagonal are never loaded and only diagonal and ragged
//    tiles are masked (rows that TMA zero-fills past Skv become -inf before
//    the max); the q tiles of largest q0 launch first, so the long causal
//    rows do not form the last wave;
//  * a sliding window (hymba-1.5b's local layers: W = 1024 keys at
//    S = 4096) is the kernel fa_fwd_band, the same CTA body instantiated
//    with the window as a template flag, so fa_fwd_tc compiles as it did
//    without one.  A CTA starts at the tile of its first row's first live
//    key, max(0, q0 - W + 1), and counts its stage ring from there; tiles
//    wholly below the band are never loaded, and besides the diagonal and
//    ragged tiles only the tiles that cross the band's lower edge are
//    masked.  At hymba's prefill that is 9 tiles a CTA where the causal
//    kernel walks up to 32, and every CTA has about the same number.
//
// float32 inputs take fa_fwd_f32, scalar f32 FMAs on the CUDA cores (64-row
// q and 32-key tiles staged as f32 in shared memory, state in registers);
// with a window it starts at the tile of its first live key, as fa_fwd_band
// does, and so does fa_fwd_wide.
// It is kept for its contract, full f32 within 2e-4: TF32 tensor cores keep
// about three decimal digits and cannot meet it.  The serve path never sends
// it f32.  The choice is by dtype; nothing falls back from one to the other.
// A head dim with no instance here, up to 256, is zero-padded by the Python
// wrapper to the next one.
//
// A head dim over 256 (wgmma's widest N, so no tensor-core instance) takes
// fa_fwd_wide in every dtype: scalar f32 FMAs, the head dim given at run
// time.  Each CTA owns 64 q rows and 128 of O's columns (blockIdx.z); it
// sums S = Q K^T over 64-column slabs of Q and K staged as f32 in shared
// memory and adds P V for its own columns, so its block of O stays in
// registers at any hd, and each of a q tile's ceil(hd / 128) CTAs computes
// S again.  At Gemma-2-2B's heads with hd 512 (B = 4, H = 8, KV = 4,
// S = 1024, causal) it runs about 9.1e10 FLOP on the CUDA cores for the
// 3.4e10 the attention needs: this route is right first, not fast (loads
// element by element, no tensor cores).
//
// cuTensorMapEncodeTiled is a driver function, reached through the
// runtime's entry-point query: the library links nothing beyond cudart.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// Element strides of the batch, head and sequence dims (head dim is dense).
struct Strides {
  long long b, h, s;
};

// The widest instance of the two kernels below; a head dim over it takes the
// wide kernel, in every dtype.
constexpr int kWidestInstance = 256;

// ---------------------------------------------------------------------------
// float32: scalar kernel
// ---------------------------------------------------------------------------

constexpr int kBQ = 64;                        // q rows per CTA
constexpr int kBK = 32;                        // keys per kv tile
constexpr int kThreads = 128;
constexpr int kTX = 8;                         // threads sharing a row group
constexpr int kRQ = kBQ / (kThreads / kTX);    // q rows per thread (4)
constexpr int kCK = kBK / kTX;                 // key columns per thread (4)
constexpr float kNegInf = -1e30f;              // the TPU kernel's NEG_INF

template <int HD>
constexpr int smem_floats() {
  return kBQ * (HD + 1) + kBK * (HD + 1) + kBK * HD + kBQ * (kBK + 1);
}

__device__ __forceinline__ float row_group_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 4));
}

__device__ __forceinline__ float row_group_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  x += __shfl_xor_sync(0xffffffffu, x, 2);
  return x + __shfl_xor_sync(0xffffffffu, x, 4);
}

// kWindow: keys with q_pos - k_pos >= window are masked too (a causal call).
template <int HD, bool kWindow>
__global__ void __launch_bounds__(kThreads)
fa_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
           const float* __restrict__ v, float* __restrict__ o, int H, int group,
           int Sq, int Skv, Strides qs, Strides ks, Strides vs, Strides os,
           float scale, int causal, int window) {
  static_assert(HD % kTX == 0, "head dim must split over a row group");
  constexpr int kLd = HD + 1;    // padded rows: conflict-free column walks
  constexpr int kPd = kBK + 1;
  constexpr int kDC = HD / kTX;  // accumulator columns per thread

  extern __shared__ float smem[];
  float* sq = smem;              // [kBQ][kLd]
  float* sk = sq + kBQ * kLd;    // [kBK][kLd]
  float* sv = sk + kBK * kLd;    // [kBK][HD]
  float* sp = sv + kBK * HD;     // [kBQ][kPd] probabilities of this tile

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  const int kvh = h / group;
  const int q0 = blockIdx.y * kBQ;
  const int tid = threadIdx.x;
  const int ty = tid / kTX;
  const int tx = tid - ty * kTX;

  const float* qb = q + b * qs.b + h * qs.h;
  const float* kb = k + b * ks.b + kvh * ks.h;
  const float* vb = v + b * vs.b + kvh * vs.h;
  float* ob = o + b * os.b + h * os.h;

  for (int i = tid; i < kBQ * HD; i += kThreads) {
    const int r = i / HD;
    const int c = i - r * HD;
    const int qp = q0 + r;
    sq[r * kLd + c] = qp < Sq ? qb[qp * qs.s + c] * scale : 0.f;
  }

  float m[kRQ], l[kRQ], acc[kRQ][kDC];
#pragma unroll
  for (int r = 0; r < kRQ; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int j = 0; j < kDC; ++j) acc[r][j] = 0.f;
  }

  // Causal: a key past the tile's last row is masked for every row; with a
  // window, so is a key before the first row's first live key.
  const int kv_end = causal ? min(Skv, q0 + kBQ) : Skv;
  const int kv_begin = kWindow ? max(0, q0 - window + 1) / kBK * kBK : 0;
  for (int k0 = kv_begin; k0 < kv_end; k0 += kBK) {
    __syncthreads();  // q staged (first pass); previous k/v tile consumed
    for (int i = tid; i < kBK * HD; i += kThreads) {
      const int r = i / HD;
      const int c = i - r * HD;
      const int kp = k0 + r;
      const bool in = kp < Skv;
      sk[r * kLd + c] = in ? kb[kp * ks.s + c] : 0.f;
      sv[r * HD + c] = in ? vb[kp * vs.s + c] : 0.f;
    }
    __syncthreads();

    float s[kRQ][kCK];
#pragma unroll
    for (int r = 0; r < kRQ; ++r)
#pragma unroll
      for (int c = 0; c < kCK; ++c) s[r][c] = 0.f;
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      float qv[kRQ], kv[kCK];
#pragma unroll
      for (int r = 0; r < kRQ; ++r) qv[r] = sq[(ty * kRQ + r) * kLd + d];
#pragma unroll
      for (int c = 0; c < kCK; ++c) kv[c] = sk[(tx + c * kTX) * kLd + d];
#pragma unroll
      for (int r = 0; r < kRQ; ++r)
#pragma unroll
        for (int c = 0; c < kCK; ++c) s[r][c] = fmaf(qv[r], kv[c], s[r][c]);
    }

#pragma unroll
    for (int r = 0; r < kRQ; ++r) {
      const int qp = q0 + ty * kRQ + r;
      bool live[kCK];
      float mx = kNegInf;
#pragma unroll
      for (int c = 0; c < kCK; ++c) {
        const int kp = k0 + tx + c * kTX;
        live[c] = kp < Skv && (!causal || kp <= qp) && (!kWindow || qp - kp < window);
        s[r][c] = live[c] ? s[r][c] : kNegInf;
        mx = fmaxf(mx, s[r][c]);
      }
      const float m_new = fmaxf(m[r], row_group_max(mx));
      const float alpha = expf(m[r] - m_new);  // rescale of the old state
      float psum = 0.f;
#pragma unroll
      for (int c = 0; c < kCK; ++c) {
        const float p = live[c] ? expf(s[r][c] - m_new) : 0.f;
        sp[(ty * kRQ + r) * kPd + tx + c * kTX] = p;
        psum += p;
      }
      l[r] = l[r] * alpha + row_group_sum(psum);
      m[r] = m_new;
#pragma unroll
      for (int j = 0; j < kDC; ++j) acc[r][j] *= alpha;
    }
    __syncwarp();  // a row group's probabilities are written and read by one warp

#pragma unroll 4
    for (int c = 0; c < kBK; ++c) {
      float pv[kRQ];
#pragma unroll
      for (int r = 0; r < kRQ; ++r) pv[r] = sp[(ty * kRQ + r) * kPd + c];
#pragma unroll
      for (int j = 0; j < kDC; ++j) {
        const float vv = sv[c * HD + tx + j * kTX];
#pragma unroll
        for (int r = 0; r < kRQ; ++r) acc[r][j] = fmaf(pv[r], vv, acc[r][j]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRQ; ++r) {
    const int qp = q0 + ty * kRQ + r;
    if (qp < Sq) {
      const float den = l[r] == 0.f ? 1.f : l[r];  // fully masked rows
#pragma unroll
      for (int j = 0; j < kDC; ++j)
        ob[qp * os.s + tx + j * kTX] = acc[r][j] / den;
    }
  }
}

template <int HD>
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* o, int B,
                       int H, int KV, int Sq, int Skv, Strides qs, Strides ks,
                       Strides vs, Strides os, float scale, int causal, int window,
                       cudaStream_t stream) {
  const auto kernel = window > 0 ? fa_fwd_f32<HD, true> : fa_fwd_f32<HD, false>;
  const int smem = smem_floats<HD>() * static_cast<int>(sizeof(float));
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(B * H, (Sq + kBQ - 1) / kBQ);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), H, H / KV, Sq, Skv,
      qs, ks, vs, os, scale, causal, window);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bfloat16 and float16: wgmma + TMA kernel
// ---------------------------------------------------------------------------

namespace hopper {

constexpr int kRows = 128;                // q rows per CTA
constexpr int kStages = 2;                // K/V ring depth
constexpr int kConsumers = 256;           // two warpgroups of 64 q rows each
constexpr int kSmemLimit = 232448;        // dynamic shared memory a CTA may have
// registers a thread of the producer and of a consumer warpgroup keeps
// where the producer is a warpgroup: 128 x 24 + 256 x 240 = 64,512 of the
// SM's 65,536, all 384 threads' 168 at launch
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;
constexpr float kLog2e = 1.4426950408889634f;
// A wait longer than this (about 2 s at the H100's clock) is a fault (a
// byte count that never completes); the kernel traps instead of hanging.
constexpr long long kHangCycles = 1LL << 32;

// The element types of the tensor-core kernel.  A tag's name is its wgmma
// operand type (the instructions below are spelled from it); pack rounds
// two f32 values to one 32-bit pair, the first in the low half.
struct bf16 {
  using T = __nv_bfloat16;
  static constexpr CUtensorMapDataType kMapType = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&h);
  }
};
struct f16 {
  using T = __half;
  static constexpr CUtensorMapDataType kMapType = CU_TENSOR_MAP_DATA_TYPE_FLOAT16;
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    __half2 h = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&h);
  }
};

// Shared-memory geometry at head dim HD.  Q's tile is 128 rows, a stage's K
// or V tile kKeys rows; a row of hd 16-bit values is split into boxes of
// kBoxCols columns, one swizzle span (32, 64 or 128 bytes) each; each box
// holds its tile's rows one after another, as TMA writes them.
template <int HD>
struct Geometry {
  static constexpr int kBoxCols = HD % 64 == 0 ? 64 : HD % 32 == 0 ? 32 : 16;
  static constexpr int kBoxes = HD / kBoxCols;
  static constexpr int kRowBytes = kBoxCols * 2;
  static constexpr int kKeys = HD > 128 ? 64 : 128;  // keys per K/V tile
  // the producer: one warp, or at hd 256 a warpgroup that gives its
  // registers to the consumers
  static constexpr bool kRegShift = HD > 128;
  static constexpr int kThreads = kConsumers + (kRegShift ? 128 : 32);
  static constexpr int kQBoxBytes = kRows * kRowBytes;
  static constexpr int kKVBoxBytes = kKeys * kRowBytes;
  static constexpr int kQBytes = kBoxes * kQBoxBytes;
  static constexpr int kKVBytes = kBoxes * kKVBoxBytes;
  // wgmma descriptor layout type: 1 = 128 B swizzle, 2 = 64 B, 3 = 32 B
  static constexpr uint64_t kLayout = kRowBytes == 128 ? 1 : kRowBytes == 64 ? 2 : 3;
  static constexpr int kKOff = kQBytes;                      // after Q
  static constexpr int kVOff = kKOff + kStages * kKVBytes;
  static constexpr int kBarOff = kVOff + kStages * kKVBytes;
  // barriers (Q, K full x2, V full x2, empty x2) and slack to align the base
  static constexpr int kSmemBytes = kBarOff + 64 + 1024;
  static_assert(HD % 16 == 0 && HD <= 256, "head dim a multiple of 16, at most 256");
  static_assert(kSmemBytes <= kSmemLimit, "shared memory of one CTA");
};

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

// One box of a 4-d tensor map (hd, rows, heads, batch) into shared memory.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int col, int row, int head, int batch) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4, %5}], [%6];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(col), "r"(row), "r"(head), "r"(batch), "r"(bar)
      : "memory");
}

// wgmma shared-memory matrix descriptor: start address, leading and stride
// byte offsets (16-byte units) and the swizzle layout type.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo,
                                              uint64_t layout) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | static_cast<uint64_t>(lbo >> 4) << 16 |
         static_cast<uint64_t>(sbo >> 4) << 32 | layout << 62;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

// Registers of this thread's warpgroup from here on (every thread of the
// warpgroup runs it): fewer for the producer, more for a consumer.
template <int N>
__device__ __forceinline__ void reg_dealloc() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void reg_alloc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(N));
}

// Keeps the compiler from moving reads of an accumulator across the wait.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// 2^x by the SFU's approximation (relative error about 2^-22), flushing
// results below 2^-126 to 0: p is rounded to 16 bits next, so this is exact
// enough, and cheaper than exp2f's full-range path.
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// The accumulator operands of a wgmma: WG_D<n>(0) binds d[0] .. d[n - 1]
// as in-out registers and WG_R<n> names them (%0 .. %(n - 1)) in the
// instruction.
#define WG_D8(i)                                                                               \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]), "+f"(d[i + 5]), \
      "+f"(d[i + 6]), "+f"(d[i + 7])
#define WG_D16(i) WG_D8(i), WG_D8(i + 8)
#define WG_D32(i) WG_D16(i), WG_D16(i + 16)
#define WG_D40(i) WG_D32(i), WG_D8(i + 32)
#define WG_D48(i) WG_D32(i), WG_D16(i + 32)
#define WG_D64(i) WG_D32(i), WG_D32(i + 32)
#define WG_D128(i) WG_D64(i), WG_D64(i + 64)
#define WG_R8 "%0, %1, %2, %3, %4, %5, %6, %7"
#define WG_R16 WG_R8 ", %8, %9, %10, %11, %12, %13, %14, %15"
#define WG_R32 WG_R16 ", %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
#define WG_R40 WG_R32 ", %32, %33, %34, %35, %36, %37, %38, %39"
#define WG_R48 WG_R40 ", %40, %41, %42, %43, %44, %45, %46, %47"
#define WG_R64                                                                                \
  WG_R48 ", %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
#define WG_R128                                                                                \
  WG_R64 ", %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "  \
         "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "    \
         "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, "    \
         "%110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, " \
         "%124, %125, %126, %127"

// S = Q K^T for one 16-wide k step: m64nNk16 over the N keys of a tile into
// NACC = N / 2 accumulators, A and B from shared memory, both K-major.  DA,
// DB and P name Q's and K's descriptors and the accumulate flag, numbered
// after the accumulators.
#define WGMMA_SS(TY, N, NACC, DA, DB, P)                                                      \
  __device__ __forceinline__ void wgmma_ss(TY, float (&d)[NACC], uint64_t da, uint64_t db,    \
                                           int accumulate) {                                  \
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, " P ", 0;\n"                              \
                 "wgmma.mma_async.sync.aligned.m64n" #N "k16.f32." #TY "." #TY " {" WG_R##NACC \
                 "}, " DA ", " DB ", p, 1, 1, 0, 0;\n}\n"                                   \
                 : WG_D##NACC(0)                                                              \
                 : "l"(da), "l"(db), "r"(accumulate));                                        \
  }
WGMMA_SS(bf16, 128, 64, "%64", "%65", "%66")
WGMMA_SS(bf16, 64, 32, "%32", "%33", "%34")
WGMMA_SS(f16, 128, 64, "%64", "%65", "%66")
WGMMA_SS(f16, 64, 32, "%32", "%33", "%34")
#undef WGMMA_SS

// O += P V for one 16-key k step at head dim N: m64nNk16 into NACC = N / 2
// accumulators, A (P) from registers, B (V) from shared memory, MN-major
// (transpose bit set).  A, B and P name P's four registers, V's descriptor
// and the accumulate flag, numbered after the accumulators.
#define WGMMA_RS(TY, N, NACC, A, B, P)                                                          \
  __device__ __forceinline__ void wgmma_rs(TY, float (&d)[NACC], const uint32_t (&a)[4],        \
                                           uint64_t db) {                                       \
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, " P ", 0;\n"                                \
                 "wgmma.mma_async.sync.aligned.m64n" #N "k16.f32." #TY "." #TY " {" WG_R##NACC   \
                 "}, {" A "}, " B ", p, 1, 1, 1;\n}\n"                                         \
                 : WG_D##NACC(0)                                                                \
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));                \
  }
#define WGMMA_RS_ALL(TY)                                         \
  WGMMA_RS(TY, 16, 8, "%8, %9, %10, %11", "%12", "%13")          \
  WGMMA_RS(TY, 32, 16, "%16, %17, %18, %19", "%20", "%21")       \
  WGMMA_RS(TY, 64, 32, "%32, %33, %34, %35", "%36", "%37")       \
  WGMMA_RS(TY, 80, 40, "%40, %41, %42, %43", "%44", "%45")       \
  WGMMA_RS(TY, 96, 48, "%48, %49, %50, %51", "%52", "%53")       \
  WGMMA_RS(TY, 128, 64, "%64, %65, %66, %67", "%68", "%69")      \
  WGMMA_RS(TY, 256, 128, "%128, %129, %130, %131", "%132", "%133")
WGMMA_RS_ALL(bf16)
WGMMA_RS_ALL(f16)
#undef WGMMA_RS_ALL
#undef WGMMA_RS

// One CTA: 128 q rows of one (batch, head).  Warps 0-7 are two consumer
// warpgroups (rows q0 .. q0+63 and q0+64 .. q0+127); warp 8 (warps 8-11 at
// hd 256) is the producer, one thread of which issues every copy.  kWindow:
// a causal call whose keys with q_pos - k_pos >= window are masked too; the
// CTA's K/V tiles start at its first row's first live key.  The maps are the
// kernel's __grid_constant__ parameters, which TMA reads in place.
template <int HD, class E, bool kWindow>
__device__ __forceinline__ void fa_fwd_cta(const CUtensorMap& qmap, const CUtensorMap& kmap,
                                           const CUtensorMap& vmap,
                                           typename E::T* __restrict__ o, int H, int group,
                                           int Sq, int Skv, Strides os, float scale, int causal,
                                           int window) {
  using G = Geometry<HD>;
  constexpr int kKeys = G::kKeys;
  extern __shared__ unsigned char smem_raw[];
  // 1024-byte alignment: the 128 B swizzle pattern repeats every 8 rows
  const uint32_t base = (smem_addr(smem_raw) + 1023) & ~1023u;
  const uint32_t sq = base;
  const uint32_t q_bar = base + G::kBarOff;
  auto k_tile = [&](int st) { return base + G::kKOff + st * G::kKVBytes; };
  auto v_tile = [&](int st) { return base + G::kVOff + st * G::kKVBytes; };
  auto k_full = [&](int st) { return q_bar + 8 * (1 + st); };
  auto v_full = [&](int st) { return q_bar + 8 * (1 + kStages + st); };
  auto empty = [&](int st) { return q_bar + 8 * (1 + 2 * kStages + st); };

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  const int kvh = h / group;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kRows;  // largest q0 first
  const int kv_end = causal ? min(Skv, q0 + kRows) : Skv;
  const int n_tiles = (kv_end + kKeys - 1) / kKeys;
  // the first tile a row of this CTA has a live key in; the stage ring and
  // its parities count from it
  const int first = kWindow ? max(0, q0 - window + 1) / kKeys : 0;
  const int tid = threadIdx.x;
  // the thread's warpgroup (2: the producer), uniform over a warp as the
  // compiler sees it, which setmaxnreg's register regions need
  const int wg = __shfl_sync(0xffffffffu, tid / 128, 0);

  if (tid == 0) {
    mbar_init(q_bar, 1);
    for (int st = 0; st < kStages; ++st) {
      mbar_init(k_full(st), 1);
      mbar_init(v_full(st), 1);
      mbar_init(empty(st), kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (wg == kConsumers / 128) {
    if constexpr (G::kRegShift) reg_dealloc<kProducerRegs>();
    if (tid == kConsumers) {
      mbar_expect_tx(q_bar, G::kQBytes);
      for (int x = 0; x < G::kBoxes; ++x)
        tma_load(sq + x * G::kQBoxBytes, &qmap, q_bar, x * G::kBoxCols, q0, h, b);
      for (int it = first; it < n_tiles; ++it) {
        const int st = (it - first) % kStages;
        // the stage's previous tile (it - kStages) consumed; passes at once
        // on the first round
        mbar_wait(empty(st), (((it - first) / kStages) & 1) ^ 1);
        mbar_expect_tx(k_full(st), G::kKVBytes);
        for (int x = 0; x < G::kBoxes; ++x)
          tma_load(k_tile(st) + x * G::kKVBoxBytes, &kmap, k_full(st), x * G::kBoxCols,
                   it * kKeys, kvh, b);
        mbar_expect_tx(v_full(st), G::kKVBytes);
        for (int x = 0; x < G::kBoxes; ++x)
          tma_load(v_tile(st) + x * G::kKVBoxBytes, &vmap, v_full(st), x * G::kBoxCols,
                   it * kKeys, kvh, b);
      }
    }
  } else {
    if constexpr (G::kRegShift) reg_alloc<kConsumerRegs>();
    // Consumer warpgroup wg: q rows qw .. qw+63.  Thread t holds rows
    // r0 = 16 * (t / 32) + (t % 32) / 4 and r0 + 8 of them, and columns
    // 8 j + 2 (t % 4) + {0, 1} of the S and O accumulators.
    const int t = tid % 128;
    const int lane = t % 32;
    const int r0 = 16 * (t / 32) + lane / 4;
    const int qw = q0 + 64 * wg;
    const int qp0 = qw + r0, qp1 = qp0 + 8;
    const float c = scale * kLog2e;
    const float ninf = __int_as_float(0xff800000);

    float acc[HD / 2];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) acc[i] = 0.f;
    float m0 = ninf, m1 = ninf;  // running max of scale * log2 e * s
    float l0 = 0.f, l1 = 0.f;    // this thread's share of the denominator

    mbar_wait(q_bar, 0);
    const uint32_t q_rows = sq + wg * 64 * G::kRowBytes;
    for (int it = first; it < n_tiles; ++it) {
      const int st = (it - first) % kStages;
      const uint32_t parity = ((it - first) / kStages) & 1;
      const int k0 = it * kKeys;

      // S = Q K^T: 64 rows x kKeys keys, K-major A and B, hd / 16 k steps;
      // a k step lies in box (16 kk / kBoxCols), 32 kk bytes into its span
      float s[kKeys / 2];
#pragma unroll
      for (int i = 0; i < kKeys / 2; ++i) s[i] = 0.f;
      mbar_wait(k_full(st), parity);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        const uint32_t box = kk * 16 / G::kBoxCols, span = (kk * 32) % G::kRowBytes;
        wgmma_ss(E{}, s,
                 smem_desc(q_rows + box * G::kQBoxBytes + span, 16, 8 * G::kRowBytes, G::kLayout),
                 smem_desc(k_tile(st) + box * G::kKVBoxBytes + span, 16, 8 * G::kRowBytes,
                           G::kLayout),
                 kk > 0);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(s);

      // Online softmax in the exp2 domain.  Masked: keys past Skv (TMA
      // zero-filled them), on the diagonal tile keys after the row, and on a
      // tile that crosses the band's lower edge (below the first live key of
      // the warpgroup's last row, min(qw + 63, Sq - 1) - window + 1) keys the
      // window leaves out; a window of at least Sq masks no tile.
      const bool masked = k0 + kKeys > Skv || (causal && k0 + kKeys - 1 > qw) ||
                          (kWindow && k0 < min(qw + 64, Sq) - window);
      float mx0 = m0, mx1 = m1;
#pragma unroll
      for (int i = 0; i < kKeys / 2; ++i) {
        float x = s[i] * c;
        if (masked) {
          const int kp = k0 + 8 * (i / 4) + 2 * (lane % 4) + (i % 2);
          const int qp = (i / 2) % 2 ? qp1 : qp0;
          if (kp >= Skv || (causal && kp > qp) || (kWindow && qp - kp >= window)) x = ninf;
        }
        s[i] = x;
        if ((i / 2) % 2) mx1 = fmaxf(mx1, x);
        else mx0 = fmaxf(mx0, x);
      }
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
      // a row with no live key yet keeps p = 0 and alpha = 0 (no inf - inf):
      // under a window, a whole tile below the row's first live key
      const float b0 = mx0 == ninf ? 0.f : mx0;
      const float b1 = mx1 == ninf ? 0.f : mx1;
      const float alpha0 = fast_exp2(m0 - b0), alpha1 = fast_exp2(m1 - b1);
      m0 = mx0;
      m1 = mx1;
      float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
      for (int i = 0; i < kKeys / 2; ++i) {
        if ((i / 2) % 2) {
          s[i] = fast_exp2(s[i] - b1);
          sum1 += s[i];
        } else {
          s[i] = fast_exp2(s[i] - b0);
          sum0 += s[i];
        }
      }
      l0 = l0 * alpha0 + sum0;
      l1 = l1 * alpha1 + sum1;
#pragma unroll
      for (int i = 0; i < HD / 2; ++i) acc[i] *= (i / 2) % 2 ? alpha1 : alpha0;

      // P in the input type, laid out as the A fragments of the kKeys / 16
      // k steps of P V
      uint32_t p[kKeys / 16][4];
#pragma unroll
      for (int kk = 0; kk < kKeys / 16; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r) p[kk][r] = E::pack(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1]);

      // O += P V: V (keys x hd, hd contiguous) is the MN-major B operand;
      // 8 key rows per swizzle atom (SBO), the next kBoxCols columns one box
      // further (LBO)
      mbar_wait(v_full(st), parity);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kKeys / 16; ++kk)
        wgmma_rs(E{}, acc, p[kk],
                 smem_desc(v_tile(st) + kk * 16 * G::kRowBytes, G::kKVBoxBytes,
                           8 * G::kRowBytes, G::kLayout));
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(acc);
      mbar_arrive(empty(st));
    }

    l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
    l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
    const float inv0 = 1.f / (l0 == 0.f ? 1.f : l0);  // fully masked rows
    const float inv1 = 1.f / (l1 == 0.f ? 1.f : l1);
    typename E::T* ob = o + b * os.b + h * os.h + 2 * (lane % 4);
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
      if (qp0 < Sq)
        *reinterpret_cast<uint32_t*>(ob + qp0 * os.s + 8 * j) =
            E::pack(acc[4 * j] * inv0, acc[4 * j + 1] * inv0);
      if (qp1 < Sq)
        *reinterpret_cast<uint32_t*>(ob + qp1 * os.s + 8 * j) =
            E::pack(acc[4 * j + 2] * inv1, acc[4 * j + 3] * inv1);
    }
  }
}

template <int HD, class E>
__global__ void __launch_bounds__(Geometry<HD>::kThreads, 1)
fa_fwd_tc(const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,
          const __grid_constant__ CUtensorMap vmap, typename E::T* __restrict__ o, int H,
          int group, int Sq, int Skv, Strides os, float scale, int causal) {
  fa_fwd_cta<HD, E, false>(qmap, kmap, vmap, o, H, group, Sq, Skv, os, scale, causal, 0);
}

// The causal kernel with a sliding window of `window` keys (window > 0).
template <int HD, class E>
__global__ void __launch_bounds__(Geometry<HD>::kThreads, 1)
fa_fwd_band(const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,
            const __grid_constant__ CUtensorMap vmap, typename E::T* __restrict__ o, int H,
            int group, int Sq, int Skv, Strides os, float scale, int window) {
  fa_fwd_cta<HD, E, true>(qmap, kmap, vmap, o, H, group, Sq, Skv, os, scale, 1, window);
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

// A 4-d map (hd, rows, heads, batch) over a strided 16-bit tensor, boxes of
// kBoxCols x box_rows with the swizzle the descriptors expect.  Strides are
// elements; rows past `rows` read as zeros.
template <int HD, class E>
CUresult encode(EncodeTiled encode_fn, CUtensorMap* map, const void* ptr, int rows, int box_rows,
                int heads, int batch, Strides st) {
  using G = Geometry<HD>;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(HD), static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(heads), static_cast<cuuint64_t>(batch)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(st.s) * 2,
                                 static_cast<cuuint64_t>(st.h) * 2,
                                 static_cast<cuuint64_t>(st.b) * 2};
  const cuuint32_t box[4] = {G::kBoxCols, static_cast<cuuint32_t>(box_rows), 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUtensorMapSwizzle swizzle = G::kRowBytes == 128  ? CU_TENSOR_MAP_SWIZZLE_128B
                                     : G::kRowBytes == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                                          : CU_TENSOR_MAP_SWIZZLE_32B;
  return encode_fn(map, E::kMapType, 4, const_cast<void*>(ptr), dims, strides, box, unit,
                   CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                   CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

template <int HD, class E>
cudaError_t launch_tc(const void* q, const void* k, const void* v, void* o, int B, int H, int KV,
                      int Sq, int Skv, Strides qs, Strides ks, Strides vs, Strides os,
                      float scale, int causal, int window, cudaStream_t stream) {
  using G = Geometry<HD>;
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return cudaErrorSymbolNotFound;
  CUtensorMap qmap, kmap, vmap;
  // Skv = 0 loads no tile; the maps still need a non-empty row dim
  const int kv_rows = Skv > 0 ? Skv : 1;
  if (encode<HD, E>(fn, &qmap, q, Sq, kRows, H, B, qs) != CUDA_SUCCESS ||
      encode<HD, E>(fn, &kmap, k, kv_rows, G::kKeys, KV, B, ks) != CUDA_SUCCESS ||
      encode<HD, E>(fn, &vmap, v, kv_rows, G::kKeys, KV, B, vs) != CUDA_SUCCESS)
    return cudaErrorInvalidValue;
  // the two kernels differ in their last argument: the window, or the flag
  const auto kernel = window > 0 ? fa_fwd_band<HD, E> : fa_fwd_tc<HD, E>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, G::kSmemBytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(B * H, (Sq + kRows - 1) / kRows);
  kernel<<<grid, G::kThreads, G::kSmemBytes, stream>>>(
      qmap, kmap, vmap, static_cast<typename E::T*>(o), H, H / KV, Sq, Skv, os, scale,
      window > 0 ? window : causal);
  return cudaGetLastError();
}

}  // namespace hopper

// ---------------------------------------------------------------------------
// head dims over 256, every dtype: the wide kernel
// ---------------------------------------------------------------------------

namespace wide {

constexpr int kBQ = 64;                        // q rows per CTA
constexpr int kBK = 64;                        // keys per kv tile
constexpr int kSlab = 64;                      // head-dim columns of Q and K staged at once
constexpr int kCols = 128;                     // O columns per CTA (blockIdx.z)
constexpr int kThreads = 128;
constexpr int kRQ = kBQ / (kThreads / kTX);    // q rows per thread (4)
constexpr int kCK = kBK / kTX;                 // key columns per thread (8)
constexpr int kDC = kCols / kTX;               // O columns per thread (16)
constexpr int kLd = kSlab + 1;                 // padded rows: conflict-free column walks
constexpr int kPd = kBK + 1;
constexpr int kSmemBytes =
    (kBQ * kLd + kBK * kLd + kBK * kCols + kBQ * kPd) * static_cast<int>(sizeof(float));
constexpr int kMaxGridYZ = 65535;              // gridDim.y (q tiles) and gridDim.z (O slabs)
static_assert(kBK == kBQ, "one loop stages a slab of Q and of K");

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float widen(__half x) { return __half2float(x); }
template <class E>
__device__ __forceinline__ E narrow(float x);
template <>
__device__ __forceinline__ float narrow<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 narrow<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}
template <>
__device__ __forceinline__ __half narrow<__half>(float x) { return __float2half_rn(x); }

// One CTA per (b*h, 64 q rows, 128 of O's columns), for any head dim hd.
// Per kv tile of 64 keys, S = (scale * Q) K^T is summed over the head dim in
// slabs of 64 columns, each staged as f32 in shared memory; then the online
// softmax (the f32 kernel's, per row group of 8 threads) and O[:, cols] +=
// P V[:, cols].  Each of the ceil(hd / 128) CTAs of a q tile computes S
// again: the price of keeping a thread's O block (4 rows x 16 columns) in
// registers at any hd.  kWindow: keys with q_pos - k_pos >= window are
// masked too (a causal call).
template <class E, bool kWindow>
__global__ void __launch_bounds__(kThreads)
fa_fwd_wide(const E* __restrict__ q, const E* __restrict__ k, const E* __restrict__ v,
            E* __restrict__ o, int H, int group, int Sq, int Skv, int hd, Strides qs,
            Strides ks, Strides vs, Strides os, float scale, int causal, int window) {
  extern __shared__ float smem[];
  float* sq = smem;              // [kBQ][kLd] a slab of scale * Q
  float* sk = sq + kBQ * kLd;    // [kBK][kLd] the same slab of K
  float* sv = sk + kBK * kLd;    // [kBK][kCols] V at this CTA's columns
  float* sp = sv + kBK * kCols;  // [kBQ][kPd] probabilities of this tile

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  const int kvh = h / group;
  const int q0 = blockIdx.y * kBQ;
  const int c0 = blockIdx.z * kCols;
  const int tid = threadIdx.x;
  const int ty = tid / kTX;
  const int tx = tid - ty * kTX;

  const E* qb = q + b * qs.b + h * qs.h;
  const E* kb = k + b * ks.b + kvh * ks.h;
  const E* vb = v + b * vs.b + kvh * vs.h;
  E* ob = o + b * os.b + h * os.h;

  float m[kRQ], l[kRQ], acc[kRQ][kDC];
#pragma unroll
  for (int r = 0; r < kRQ; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int j = 0; j < kDC; ++j) acc[r][j] = 0.f;
  }

  // Causal: a key past the tile's last row is masked for every row; with a
  // window, so is a key before the first row's first live key.
  const int kv_end = causal ? min(Skv, q0 + kBQ) : Skv;
  const int kv_begin = kWindow ? max(0, q0 - window + 1) / kBK * kBK : 0;
  for (int k0 = kv_begin; k0 < kv_end; k0 += kBK) {
    float s[kRQ][kCK];
#pragma unroll
    for (int r = 0; r < kRQ; ++r)
#pragma unroll
      for (int c = 0; c < kCK; ++c) s[r][c] = 0.f;

    for (int d0 = 0; d0 < hd; d0 += kSlab) {
      __syncthreads();  // the previous slab, or the previous tile's P V, is consumed
      for (int i = tid; i < kBQ * kSlab; i += kThreads) {
        const int r = i / kSlab;
        const int c = i - r * kSlab;
        const int qp = q0 + r;
        sq[r * kLd + c] =
            qp < Sq && d0 + c < hd ? widen(qb[qp * qs.s + d0 + c]) * scale : 0.f;
        const int kp = k0 + r;  // kBK == kBQ: the same loop stages K
        sk[r * kLd + c] = kp < Skv && d0 + c < hd ? widen(kb[kp * ks.s + d0 + c]) : 0.f;
      }
      if (d0 == 0) {
        for (int i = tid; i < kBK * kCols; i += kThreads) {
          const int r = i / kCols;
          const int c = i - r * kCols;
          const int kp = k0 + r;
          sv[r * kCols + c] = kp < Skv && c0 + c < hd ? widen(vb[kp * vs.s + c0 + c]) : 0.f;
        }
      }
      __syncthreads();
#pragma unroll 8
      for (int d = 0; d < kSlab; ++d) {
        float qv[kRQ], kv[kCK];
#pragma unroll
        for (int r = 0; r < kRQ; ++r) qv[r] = sq[(ty * kRQ + r) * kLd + d];
#pragma unroll
        for (int c = 0; c < kCK; ++c) kv[c] = sk[(tx + c * kTX) * kLd + d];
#pragma unroll
        for (int r = 0; r < kRQ; ++r)
#pragma unroll
          for (int c = 0; c < kCK; ++c) s[r][c] = fmaf(qv[r], kv[c], s[r][c]);
      }
    }

#pragma unroll
    for (int r = 0; r < kRQ; ++r) {
      const int qp = q0 + ty * kRQ + r;
      bool live[kCK];
      float mx = kNegInf;
#pragma unroll
      for (int c = 0; c < kCK; ++c) {
        const int kp = k0 + tx + c * kTX;
        live[c] = kp < Skv && (!causal || kp <= qp) && (!kWindow || qp - kp < window);
        s[r][c] = live[c] ? s[r][c] : kNegInf;
        mx = fmaxf(mx, s[r][c]);
      }
      const float m_new = fmaxf(m[r], row_group_max(mx));
      const float alpha = expf(m[r] - m_new);  // rescale of the old state
      float psum = 0.f;
#pragma unroll
      for (int c = 0; c < kCK; ++c) {
        const float p = live[c] ? expf(s[r][c] - m_new) : 0.f;
        sp[(ty * kRQ + r) * kPd + tx + c * kTX] = p;
        psum += p;
      }
      l[r] = l[r] * alpha + row_group_sum(psum);
      m[r] = m_new;
#pragma unroll
      for (int j = 0; j < kDC; ++j) acc[r][j] *= alpha;
    }
    __syncwarp();  // a row group's probabilities are written and read by one warp

#pragma unroll 4
    for (int c = 0; c < kBK; ++c) {
      float pv[kRQ];
#pragma unroll
      for (int r = 0; r < kRQ; ++r) pv[r] = sp[(ty * kRQ + r) * kPd + c];
#pragma unroll
      for (int j = 0; j < kDC; ++j) {
        const float vv = sv[c * kCols + tx + j * kTX];
#pragma unroll
        for (int r = 0; r < kRQ; ++r) acc[r][j] = fmaf(pv[r], vv, acc[r][j]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRQ; ++r) {
    const int qp = q0 + ty * kRQ + r;
    if (qp < Sq) {
      const float den = l[r] == 0.f ? 1.f : l[r];  // fully masked rows
#pragma unroll
      for (int j = 0; j < kDC; ++j) {
        const int col = c0 + tx + j * kTX;
        if (col < hd) ob[qp * os.s + col] = narrow<E>(acc[r][j] / den);
      }
    }
  }
}

template <class E>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int B, int H, int KV,
                   int Sq, int Skv, int hd, Strides qs, Strides ks, Strides vs, Strides os,
                   float scale, int causal, int window, cudaStream_t stream) {
  const int q_tiles = (Sq + kBQ - 1) / kBQ;
  const int col_tiles = (hd + kCols - 1) / kCols;
  if (q_tiles > kMaxGridYZ || col_tiles > kMaxGridYZ) return cudaErrorInvalidConfiguration;
  const auto kernel = window > 0 ? fa_fwd_wide<E, true> : fa_fwd_wide<E, false>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(B * H, q_tiles, col_tiles);
  kernel<<<grid, kThreads, kSmemBytes, stream>>>(
      static_cast<const E*>(q), static_cast<const E*>(k), static_cast<const E*>(v),
      static_cast<E*>(o), H, H / KV, Sq, Skv, hd, qs, ks, vs, os, scale, causal, window);
  return cudaGetLastError();
}

}  // namespace wide

#define REPRO_FA_ARGS q, k, v, o, B, H, KV, Sq, Skv, qs, ks, vs, os, scale, causal, window, stream
#define REPRO_FA_WIDE_ARGS \
  q, k, v, o, B, H, KV, Sq, Skv, hd, qs, ks, vs, os, scale, causal, window, stream

// The instances of one kernel over the head dims the wrapper launches.
template <template <int> class Launch>
cudaError_t by_head_dim(int hd, const void* q, const void* k, const void* v, void* o, int B,
                        int H, int KV, int Sq, int Skv, Strides qs, Strides ks, Strides vs,
                        Strides os, float scale, int causal, int window, cudaStream_t stream) {
  switch (hd) {
    case 16: return Launch<16>::run(REPRO_FA_ARGS);
    case 32: return Launch<32>::run(REPRO_FA_ARGS);
    case 64: return Launch<64>::run(REPRO_FA_ARGS);
    case 80: return Launch<80>::run(REPRO_FA_ARGS);
    case 96: return Launch<96>::run(REPRO_FA_ARGS);
    case 128: return Launch<128>::run(REPRO_FA_ARGS);
    case 256: return Launch<256>::run(REPRO_FA_ARGS);
  }
  return cudaErrorInvalidValue;
}

template <int HD>
struct F32 {
  template <class... A>
  static cudaError_t run(A... a) { return launch_f32<HD>(a...); }
};
template <int HD>
struct Bf16 {
  template <class... A>
  static cudaError_t run(A... a) { return hopper::launch_tc<HD, hopper::bf16>(a...); }
};
template <int HD>
struct F16 {
  template <class... A>
  static cudaError_t run(A... a) { return hopper::launch_tc<HD, hopper::f16>(a...); }
};

cudaError_t dispatch(int dtype, int hd, const void* q, const void* k, const void* v, void* o,
                     int B, int H, int KV, int Sq, int Skv, Strides qs, Strides ks, Strides vs,
                     Strides os, float scale, int causal, int window, cudaStream_t stream) {
  if (hd > kWidestInstance) {
    switch (dtype) {
      case 0: return wide::launch<float>(REPRO_FA_WIDE_ARGS);
      case 1: return wide::launch<__nv_bfloat16>(REPRO_FA_WIDE_ARGS);
      case 2: return wide::launch<__half>(REPRO_FA_WIDE_ARGS);
    }
    return cudaErrorInvalidValue;
  }
  switch (dtype) {
    case 0: return by_head_dim<F32>(hd, REPRO_FA_ARGS);
    case 1: return by_head_dim<Bf16>(hd, REPRO_FA_ARGS);
    case 2: return by_head_dim<F16>(hd, REPRO_FA_ARGS);
  }
  return cudaErrorInvalidValue;
}

#undef REPRO_FA_ARGS
#undef REPRO_FA_WIDE_ARGS

}  // namespace

// q (B, H, Sq, hd), k and v (B, KV, Skv, hd), o (B, H, Sq, hd), each with
// the element strides given for its first three dims and a dense head dim;
// hd is 16, 32, 64, 80, 96, 128 or 256 (an instance), or any hd over 256
// (fa_fwd_wide).  dtype: 0 = float32, 1 = bfloat16, 2 = float16; below
// hd 256 a 16-bit pointer is 16-byte aligned and its strides are multiples
// of 8 elements (TMA's terms).  window: 0, or the keys a query sees in a
// causal call (q_pos - k_pos < window).  Returns a cudaError_t (0 = launched).
extern "C" int repro_fa_fwd_window(const void* q, const void* k, const void* v,
                                   void* o, int dtype, int B, int H, int KV, int Sq,
                                   int Skv, int hd, long long q_sb, long long q_sh,
                                   long long q_ss, long long k_sb, long long k_sh,
                                   long long k_ss, long long v_sb, long long v_sh,
                                   long long v_ss, long long o_sb, long long o_sh,
                                   long long o_ss, float scale, int causal, int window,
                                   void* stream) {
  if (B <= 0 || H <= 0 || KV <= 0 || H % KV != 0 || Sq <= 0 || Skv < 0 || window < 0 ||
      (window > 0 && !causal))
    return static_cast<int>(cudaErrorInvalidValue);
  const Strides qs{q_sb, q_sh, q_ss}, ks{k_sb, k_sh, k_ss};
  const Strides vs{v_sb, v_sh, v_ss}, os{o_sb, o_sh, o_ss};
  return static_cast<int>(dispatch(dtype, hd, q, k, v, o, B, H, KV, Sq, Skv, qs, ks, vs, os,
                                   scale, causal, window, static_cast<cudaStream_t>(stream)));
}

extern "C" const char* repro_fa_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
