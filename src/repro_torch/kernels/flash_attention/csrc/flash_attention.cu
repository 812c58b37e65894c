// Flash-attention forward (grouped-query heads) for NVIDIA Hopper, sm_90a.
//
// Replaces the TPU kernel repro/kernels/flash_attention/kernel.py
// (_fa_kernel, launched by flash_attention_bh): softmax(scale * Q K^T + mask) V
// with an online softmax.  The mask is k_pos < Skv and, when causal,
// k_pos <= q_pos (both counted from 0); a row whose denominator is 0 divides
// by 1; the output has q's dtype.
//
// What bounds it on the H100: at the serving prefill shape (S = 1024,
// hd = 128, 8 query heads per kv head) the causal work is a few hundred
// FLOPs per byte of q, k, v and o, above the card's bf16 ridge, so the
// products bound it.  This first version does them with scalar f32 FMAs on
// the CUDA cores: no tensor cores (wgmma) and no TMA yet.  What the design
// does about the bound is what flash attention is for: the score tile and
// the running state never leave the chip, Q K^T over a tile reuses each
// shared-memory operand across a 4 x 4 register block, and kv tiles wholly
// above the causal diagonal are never visited, halving the causal work.
//
// Layout of the work:
//  * one CTA of 128 threads per (b*h, 64-row q tile); a loop over 32-key kv
//    tiles inside the CTA replaces the TPU's sequential kv grid axis;
//  * the q tile (pre-scaled, as the TPU kernel does), the k tile and the v
//    tile are staged in shared memory as f32 (dynamic shared memory, about
//    74 KB at hd = 128, opted in with cudaFuncSetAttribute);
//  * thread (ty, tx) owns q rows 4*ty .. 4*ty+3; for those rows it holds a
//    4 x 4 block of scores (keys tx + 8*c) and the f32 accumulator columns
//    tx + 8*j, so the running max m and denominator l are reduced across the
//    8 threads of a row group with warp shuffles and kept in registers;
//  * K and V are addressed through kv head h / group with the caller's batch,
//    head and sequence strides, so neither the GQA broadcast nor a
//    transposed layout is copied;
//  * the ragged Sq and Skv edges are masked here, so nothing is padded.
//
// f32 inputs stay f32 end to end (no TF32); bf16 inputs are widened to f32
// on load and the output is rounded once.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBQ = 64;                        // q rows per CTA
constexpr int kBK = 32;                        // keys per kv tile
constexpr int kThreads = 128;
constexpr int kTX = 8;                         // threads sharing a row group
constexpr int kRQ = kBQ / (kThreads / kTX);    // q rows per thread (4)
constexpr int kCK = kBK / kTX;                 // key columns per thread (4)
constexpr float kNegInf = -1e30f;              // the TPU kernel's NEG_INF

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_f32(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_f32(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// Element strides of the batch, head and sequence dims (head dim is dense).
struct Strides {
  long long b, h, s;
};

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

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
fa_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, T* __restrict__ o, int H, int group,
              int Sq, int Skv, Strides qs, Strides ks, Strides vs, Strides os,
              float scale, int causal) {
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

  const T* qb = q + b * qs.b + h * qs.h;
  const T* kb = k + b * ks.b + kvh * ks.h;
  const T* vb = v + b * vs.b + kvh * vs.h;
  T* ob = o + b * os.b + h * os.h;

  for (int i = tid; i < kBQ * HD; i += kThreads) {
    const int r = i / HD;
    const int c = i - r * HD;
    const int qp = q0 + r;
    sq[r * kLd + c] = qp < Sq ? load_f32(qb + qp * qs.s + c) * scale : 0.f;
  }

  float m[kRQ], l[kRQ], acc[kRQ][kDC];
#pragma unroll
  for (int r = 0; r < kRQ; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int j = 0; j < kDC; ++j) acc[r][j] = 0.f;
  }

  // Causal: a key past the tile's last row is masked for every row.
  const int kv_end = causal ? min(Skv, q0 + kBQ) : Skv;
  for (int k0 = 0; k0 < kv_end; k0 += kBK) {
    __syncthreads();  // q staged (first pass); previous k/v tile consumed
    for (int i = tid; i < kBK * HD; i += kThreads) {
      const int r = i / HD;
      const int c = i - r * HD;
      const int kp = k0 + r;
      const bool in = kp < Skv;
      sk[r * kLd + c] = in ? load_f32(kb + kp * ks.s + c) : 0.f;
      sv[r * HD + c] = in ? load_f32(vb + kp * vs.s + c) : 0.f;
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
        live[c] = kp < Skv && (!causal || kp <= qp);
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
        store_f32(ob + qp * os.s + tx + j * kTX, acc[r][j] / den);
    }
  }
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int B,
                   int H, int KV, int Sq, int Skv, Strides qs, Strides ks,
                   Strides vs, Strides os, float scale, int causal,
                   cudaStream_t stream) {
  const int smem = smem_floats<HD>() * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      fa_fwd_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(B * H, (Sq + kBQ - 1) / kBQ);
  fa_fwd_kernel<T, HD><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), H, H / KV, Sq, Skv, qs, ks,
      vs, os, scale, causal);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_hd(int hd, const void* q, const void* k, const void* v,
                        void* o, int B, int H, int KV, int Sq, int Skv,
                        Strides qs, Strides ks, Strides vs, Strides os,
                        float scale, int causal, cudaStream_t stream) {
  switch (hd) {
    case 16:
      return launch<T, 16>(q, k, v, o, B, H, KV, Sq, Skv, qs, ks, vs, os, scale, causal, stream);
    case 32:
      return launch<T, 32>(q, k, v, o, B, H, KV, Sq, Skv, qs, ks, vs, os, scale, causal, stream);
    case 64:
      return launch<T, 64>(q, k, v, o, B, H, KV, Sq, Skv, qs, ks, vs, os, scale, causal, stream);
    case 128:
      return launch<T, 128>(q, k, v, o, B, H, KV, Sq, Skv, qs, ks, vs, os, scale, causal, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// q (B, H, Sq, hd), k and v (B, KV, Skv, hd), o (B, H, Sq, hd), each with
// the element strides given for its first three dims and a dense head dim.
// dtype: 0 = float32, 1 = bfloat16.  Returns a cudaError_t (0 = launched).
extern "C" int repro_fa_fwd(const void* q, const void* k, const void* v,
                            void* o, int dtype, int B, int H, int KV, int Sq,
                            int Skv, int hd, long long q_sb, long long q_sh,
                            long long q_ss, long long k_sb, long long k_sh,
                            long long k_ss, long long v_sb, long long v_sh,
                            long long v_ss, long long o_sb, long long o_sh,
                            long long o_ss, float scale, int causal,
                            void* stream) {
  if (B <= 0 || H <= 0 || KV <= 0 || H % KV != 0 || Sq <= 0 || Skv < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Strides qs{q_sb, q_sh, q_ss}, ks{k_sb, k_sh, k_ss};
  const Strides vs{v_sb, v_sh, v_ss}, os{o_sb, o_sh, o_ss};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0)
    err = dispatch_hd<float>(hd, q, k, v, o, B, H, KV, Sq, Skv, qs, ks, vs, os, scale, causal, s);
  else if (dtype == 1)
    err = dispatch_hd<__nv_bfloat16>(hd, q, k, v, o, B, H, KV, Sq, Skv, qs, ks, vs, os, scale, causal, s);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}

extern "C" const char* repro_fa_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
