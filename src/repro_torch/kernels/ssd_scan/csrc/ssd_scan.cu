// Mamba-2 SSD chunked scan for NVIDIA Hopper, sm_90a.
//
// Replaces the TPU kernel repro/kernels/ssd_scan/kernel.py:96 (ssd_scan_bh,
// body _ssd_kernel).  Per stream (batch b, head h) the sequence is cut into
// chunks of Q steps; within a chunk, with A = cumsum(a),
//
//   y[i]   = sum_{j<=i} (C[i] . B[j]) exp(A[i] - A[j]) X[j]  +  exp(A[i]) C[i] S^T
//   S_next = S exp(A[Q-1]) + sum_j exp(A[Q-1] - A[j]) X[j]^T B[j]
//
// with the (P, N) state S carried in f32 from one chunk to the next, starting
// from s0; y has x's dtype and the final state is f32.  Steps past S (the
// ragged tail) and chunk rows past Q are loaded as zeros, which is inert
// (a = 0 keeps the state, x = b = 0 adds nothing), so nothing is padded in
// device memory.
//
// What bounds it on the H100: at the mamba2-130m serving prefill (96 streams
// of 1024 steps, P = 64, N = 128, Q = 128, bf16) the work is about 8e9 FLOP
// of matrix products for about 34 MB of input and output, some 240 FLOP per
// byte: on the bf16 tensor cores the bytes would bound it (about 0.010 ms at
// 3.35 TB/s).  Within a stream the chunks run in order (chunk k needs the
// state chunk k - 1 leaves), so a stream is one CTA's work and 96 streams
// take 96 of the 132 SMs.
//
// bfloat16 inputs (the serve path's) take ssd_scan_bf16, built for that:
//  * all four products of a chunk run on the tensor cores with mma.sync
//    m16n8k16 (bf16 operands, f32 accumulate), fed by ldmatrix from shared
//    memory: G = C B^T, then (G o L) X, C S^T and (X o decay)^T B.  Each of
//    8 warps owns 16 rows of the chunk: it computes G in 16 x 16 tiles left
//    of the diagonal only (two tiles at a time, so their products
//    interleave), masks each to -inf above the diagonal before the exp, and
//    uses the tile's accumulators as the A fragment of (G o L) X as they
//    stand.  Warps w and w + 4 share a scheduler and own row strips w and
//    7 - w, so each scheduler has 9 of the 36 tiles;
//  * precision: the sequential recurrence in f32 is the reference, within
//    3e-2 elementwise.  Rounding G o L or the state to bf16 each leaves
//    rare elements past that limit at the serving shape (measured by
//    rounding.py), so both are split into a bf16 hi and lo part and
//    multiplied twice (about 16 bits kept); X o decay, the update's A
//    operand, is rounded to bf16 once, which stays far inside the limit at
//    N <= 128.  A wider state sums more columns' rounding into each y, and
//    at N = 384 one rounding of X o decay took y to 0.72-0.87 of the limit
//    (rounding.py --state 384) and past it at one element on the card; so
//    past 128 columns X o decay is split into hi + lo too;
//  * the state S is f32, carried in the accumulators of the state update
//    (each warp a 16 x 64 block of the 64 x 128 state) across the chunks,
//    and as its hi and lo bf16 halves in shared memory, the B operand of
//    C S^T;
//  * the chunk's operands are staged in shared memory (C, B: Q x N; X: Q x
//    P tile; a; rows padded by 16 bytes so ldmatrix is free of bank
//    conflicts) in two buffers: chunk k + 1's loads, issued when chunk k - 1
//    is done, overlap chunk k's math.  213,504 B in all: one CTA an SM;
//  * loads are cp.async of 16 bytes when every row of x, B and C starts on
//    a 16-byte boundary (the model's views do), else element by element at
//    the same points.  Rows past the chunk's end and columns past N and P
//    are zeros, which is inert (a = 0 keeps the state, x = b = 0 adds
//    nothing), so nothing is padded in device memory.
//
// float32 and float16 inputs take ssd_scan_f32, scalar f32 FMAs on the CUDA
// cores, kept for its contract (5e-4), which TF32 tensor cores cannot meet
// (float16 values are widened to f32 as they are staged and y is rounded to
// float16 as it is stored: mma.sync cannot take f16 operands beside the
// bf16 hi and lo halves of G o L and S):
//  * one CTA of 256 threads per (stream b*h, 64-column P tile); the chunk
//    loop runs inside the CTA, replacing the TPU's sequential chunk axis;
//  * the chunk's C, B (Q x N) and X (Q x P tile) are staged in shared memory
//    as f32 with the state S (P tile x N); rows are padded to 32 and the
//    N-major rows by one float, so column walks are free of bank conflicts
//    (about 210 KB at Q = N = 128, P = 64: one CTA per SM);
//  * warp 0 takes the inclusive cumsum of a (4 steps per lane, then a warp
//    scan), so A sits in shared memory for everyone;
//  * y is produced in 32-row tiles: the tile of (C B^T) o L, masked to -inf
//    above the diagonal before the exp, then y = tile X + exp(A) C S^T;
//  * after the last tile, X rows are scaled by exp(A[Q-1] - A[j]) in place
//    and the state is updated.
// The choice is by dtype; nothing falls back from one to the other.  Both
// read B and C through the caller's strides (the model's head broadcast has
// head stride 0, so nothing is copied per head).
//
// Chunks and state widths past the staging (128 rows, 128 state columns):
//  * a chunk of Q > 128 rows (Mamba-2's upstream default is 256) runs as
//    ceil(Q / 128) sub-chunks of ceil(Q / n) rows, in order.  In exact
//    arithmetic the chunked scan gives the same y and final state for any
//    chunk length, so the sub-chunks' result is the chunk's; the staging and
//    the warp-0 cumsum stay at 128 rows;
//  * both terms of y, (L o C B^T) X and exp(A) C S^T, are sums over the
//    state columns n, and the state's columns update independently.  So a
//    state wider than 128 is split over the grid (blockIdx.z) into tiles of
//    128 columns: each CTA carries its tile of the state exactly and writes
//    its partial y, in f32, to a workspace the wrapper allocates; a second
//    kernel (sum_tiles) adds the tiles' partial y in order and stores y in
//    its dtype.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kLanes = 32;
constexpr int kRow = 32;      // rows of a y tile; Q, N and P are padded to it
constexpr int kPT = 64;       // P columns per CTA
constexpr int kSubQ = 128;    // rows of a sub-chunk (the warp-0 cumsum holds 4 per lane)
constexpr int kTileN = 128;   // state columns of a CTA (register block of the update)
constexpr int kMaxGridYZ = 65535;  // gridDim.y (P tiles) and gridDim.z (state tiles) limit


// Element strides of the batch, sequence and head dims (the last dim is dense).
struct Strides {
  long long b, s, h;
};

// Values of the scalar kernel's input and output types as f32, and back.
__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__half v) { return __half2float(v); }
template <class T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __half from_f32<__half>(float v) { return __float2half_rn(v); }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// The offset of element (b, t, h, 0) in the dense (B, S, H, P) workspace of
// a partial y, one per state tile.
__device__ __forceinline__ long long work_row(int bi, int t, int h, int S, int H, int P) {
  return ((static_cast<long long>(bi) * S + t) * H + h) * P;
}

__host__ __device__ constexpr int pad32(int n) { return (n + kRow - 1) / kRow * kRow; }

// Shared floats for padded chunk rows Qp, state width Np and P tile Pp.
__host__ __device__ constexpr int smem_floats(int Qp, int Np, int Pp) {
  return 2 * Qp * (Np + 1) + Pp * (Np + 1) + Qp * Pp + kRow * Qp + Qp;
}

// One 32-row tile of G = (C B^T) o L for rows i0.., columns j < 32 * JT.
// Thread (ty, tx) owns rows i0 + 4 ty + r and columns tx + 32 cb.
template <int JT>
__device__ __forceinline__ void g_tile(const float* sC, const float* sB,
                                       const float* sA, float* sG, int i0,
                                       int Np, int ldn, int Qp, int ty,
                                       int tx) {
  float g[4][JT];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int cb = 0; cb < JT; ++cb) g[r][cb] = 0.f;
  const float* crow = sC + (i0 + 4 * ty) * ldn;
#pragma unroll 4
  for (int n = 0; n < Np; ++n) {
    float cv[4], bv[JT];
#pragma unroll
    for (int r = 0; r < 4; ++r) cv[r] = crow[r * ldn + n];
#pragma unroll
    for (int cb = 0; cb < JT; ++cb) bv[cb] = sB[(tx + kLanes * cb) * ldn + n];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int cb = 0; cb < JT; ++cb) g[r][cb] = fmaf(cv[r], bv[cb], g[r][cb]);
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = i0 + 4 * ty + r;
    const float ai = sA[i];
#pragma unroll
    for (int cb = 0; cb < JT; ++cb) {
      const int j = tx + kLanes * cb;
      // segsum: -inf above the diagonal, so the exp gives 0 there and no
      // inf * 0 can arise
      const float seg = j <= i ? ai - sA[j] : -INFINITY;
      sG[(4 * ty + r) * Qp + j] = g[r][cb] * expf(seg);
    }
  }
}

// One CTA of 256 threads per (stream b*h, 64-column P tile, 128-column state
// tile).  T is the type of x, b, c and y (float or __half); y_work, when
// not null, takes this state tile's partial y in f32 instead of y.
template <int PC, int NC, class T>
__global__ void __launch_bounds__(kThreads)
ssd_scan_f32(const T* __restrict__ x, const float* __restrict__ a,
             const T* __restrict__ b, const T* __restrict__ c,
             const float* __restrict__ s0, T* __restrict__ y, float* __restrict__ y_work,
             float* __restrict__ s_out, int H, int S, int Q, int P, int N,
             Strides xs, Strides as, Strides bs, Strides cs, Strides ys) {
  constexpr int Pp = kLanes * PC;   // P tile as staged (zero columns past P)
  constexpr int Np = kLanes * NC;
  constexpr int ldn = Np + 1;
  constexpr int RP = Pp / 8;        // state rows per thread in the update
  const int Qp = pad32(Q);

  extern __shared__ float smem[];
  float* sC = smem;                 // [Qp][ldn]
  float* sB = sC + Qp * ldn;        // [Qp][ldn]
  float* sS = sB + Qp * ldn;        // [Pp][ldn]  state, f32
  float* sX = sS + Pp * ldn;        // [Qp][Pp]
  float* sG = sX + Qp * Pp;         // [kRow][Qp] one tile of (C B^T) o L
  float* sA = sG + kRow * Qp;       // [Qp]       A = cumsum(a) within the chunk

  const int bh = blockIdx.x;
  const int bi = bh / H;
  const int h = bh - bi * H;
  const int p0 = blockIdx.y * kPT;
  const int PT = min(kPT, P - p0);  // live columns of this CTA
  const int n0 = blockIdx.z * kTileN;
  const int NT = min(kTileN, N - n0);  // live state columns of this CTA
  const int tid = threadIdx.x;
  const int ty = tid / kLanes;
  const int tx = tid - ty * kLanes;

  const T* xb = x + bi * xs.b + h * xs.h + p0;
  const float* ab = a + bi * as.b + h * as.h;
  const T* bb = b + bi * bs.b + h * bs.h + n0;
  const T* cb = c + bi * cs.b + h * cs.h + n0;
  T* yb = y + bi * ys.b + h * ys.h + p0;
  float* yw = y_work == nullptr
                  ? nullptr
                  : y_work + static_cast<long long>(blockIdx.z) * gridDim.x * S * P + p0;
  const float* s0b = s0 + (static_cast<long long>(bh) * P + p0) * N + n0;
  float* sob = s_out + (static_cast<long long>(bh) * P + p0) * N + n0;

  for (int k = tid; k < Pp * Np; k += kThreads) {
    const int p = k / Np;
    const int n = k - p * Np;
    sS[p * ldn + n] = p < PT && n < NT ? s0b[p * N + n] : 0.f;
  }

  const int n_chunks = (S + Q - 1) / Q;
  for (int ch = 0; ch < n_chunks; ++ch) {
    const int t0 = ch * Q;
    const int rows = min(Q, S - t0);  // live rows of this chunk
    __syncthreads();  // the previous chunk is done with sB, sX; s0 staged

    for (int k = tid; k < Qp * Np; k += kThreads) {
      const int r = k / Np;
      const int n = k - r * Np;
      const bool live = r < rows && n < NT;
      const long long t = t0 + r;
      sC[r * ldn + n] = live ? to_f32(cb[t * cs.s + n]) : 0.f;
      sB[r * ldn + n] = live ? to_f32(bb[t * bs.s + n]) : 0.f;
    }
    for (int k = tid; k < Qp * Pp; k += kThreads) {
      const int r = k / Pp;
      const int p = k - r * Pp;
      sX[k] = r < rows && p < PT ? to_f32(xb[(t0 + r) * xs.s + p]) : 0.f;
    }
    if (ty == 0) {  // inclusive cumsum of a: 4 steps per lane, then a warp scan
      float v[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int r = 4 * tx + k;
        v[k] = r < rows ? ab[(t0 + r) * as.s] : 0.f;
      }
      v[1] += v[0];
      v[2] += v[1];
      v[3] += v[2];
      float tot = v[3];
#pragma unroll
      for (int off = 1; off < kLanes; off *= 2) {
        const float up = __shfl_up_sync(0xffffffffu, tot, off);
        if (tx >= off) tot += up;
      }
      const float before = tot - v[3];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int r = 4 * tx + k;
        if (r < Qp) sA[r] = v[k] + before;
      }
    }
    __syncthreads();

    for (int i0 = 0; i0 < Qp; i0 += kRow) {
      const int jt = i0 / kRow + 1;  // column blocks at or left of the diagonal
      switch (jt) {
        case 1: g_tile<1>(sC, sB, sA, sG, i0, Np, ldn, Qp, ty, tx); break;
        case 2: g_tile<2>(sC, sB, sA, sG, i0, Np, ldn, Qp, ty, tx); break;
        case 3: g_tile<3>(sC, sB, sA, sG, i0, Np, ldn, Qp, ty, tx); break;
        default: g_tile<4>(sC, sB, sA, sG, i0, Np, ldn, Qp, ty, tx); break;
      }
      __syncthreads();

      // y rows i0 + 4 ty + r, columns tx + 32 pc
      float acc[4][PC], off[4][PC];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int pc = 0; pc < PC; ++pc) acc[r][pc] = off[r][pc] = 0.f;
      const float* grow = sG + 4 * ty * Qp;
      const int j_end = jt * kRow;
#pragma unroll 4
      for (int j = 0; j < j_end; ++j) {
        float gv[4], xv[PC];
#pragma unroll
        for (int r = 0; r < 4; ++r) gv[r] = grow[r * Qp + j];
#pragma unroll
        for (int pc = 0; pc < PC; ++pc) xv[pc] = sX[j * Pp + tx + kLanes * pc];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int pc = 0; pc < PC; ++pc) acc[r][pc] = fmaf(gv[r], xv[pc], acc[r][pc]);
      }
      const float* crow = sC + (i0 + 4 * ty) * ldn;
#pragma unroll 4
      for (int n = 0; n < Np; ++n) {  // carried-in state: C S^T
        float cv[4], sv[PC];
#pragma unroll
        for (int r = 0; r < 4; ++r) cv[r] = crow[r * ldn + n];
#pragma unroll
        for (int pc = 0; pc < PC; ++pc) sv[pc] = sS[(tx + kLanes * pc) * ldn + n];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int pc = 0; pc < PC; ++pc) off[r][pc] = fmaf(cv[r], sv[pc], off[r][pc]);
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = i0 + 4 * ty + r;
        if (i < rows) {
          const float decay = expf(sA[i]);
#pragma unroll
          for (int pc = 0; pc < PC; ++pc) {
            const int p = tx + kLanes * pc;
            if (p < PT) {
              const float yv = fmaf(decay, off[r][pc], acc[r][pc]);
              if (yw != nullptr)
                yw[work_row(bi, t0 + i, h, S, H, P) + p] = yv;
              else
                yb[(t0 + i) * ys.s + p] = from_f32<T>(yv);
            }
          }
        }
      }
      __syncthreads();  // sG is rewritten by the next tile; sX and sS are read
    }

    // state update: S = S exp(A_last) + (X o exp(A_last - A))^T B
    const float a_last = sA[Qp - 1];
    for (int k = tid; k < Qp * Pp; k += kThreads) sX[k] *= expf(a_last - sA[k / Pp]);
    __syncthreads();
    float acc[RP][NC];
#pragma unroll
    for (int r = 0; r < RP; ++r)
#pragma unroll
      for (int nc = 0; nc < NC; ++nc) acc[r][nc] = 0.f;
#pragma unroll 2
    for (int j = 0; j < Qp; ++j) {
      float xv[RP], bv[NC];
#pragma unroll
      for (int r = 0; r < RP; ++r) xv[r] = sX[j * Pp + ty + 8 * r];
#pragma unroll
      for (int nc = 0; nc < NC; ++nc) bv[nc] = sB[j * ldn + tx + kLanes * nc];
#pragma unroll
      for (int r = 0; r < RP; ++r)
#pragma unroll
        for (int nc = 0; nc < NC; ++nc) acc[r][nc] = fmaf(xv[r], bv[nc], acc[r][nc]);
    }
    const float decay = expf(a_last);
#pragma unroll
    for (int r = 0; r < RP; ++r)
#pragma unroll
      for (int nc = 0; nc < NC; ++nc) {
        float* s = sS + (ty + 8 * r) * ldn + tx + kLanes * nc;
        *s = fmaf(*s, decay, acc[r][nc]);
      }
  }
  __syncthreads();

  for (int k = tid; k < PT * NT; k += kThreads) {
    const int p = k / NT;
    const int n = k - p * NT;
    sob[p * N + n] = sS[p * ldn + n];
  }
}

// y = the sum of the state tiles' partial y (tile 0 first), in y's type and
// strides; the workspace is dense (tiles, B, S, H, P).
template <class T>
__global__ void __launch_bounds__(kThreads)
sum_tiles(const float* __restrict__ y_work, T* __restrict__ y, int tiles, int S, int H, int P,
          long long total, Strides ys) {
  for (long long e = blockIdx.x * static_cast<long long>(kThreads) + threadIdx.x; e < total;
       e += static_cast<long long>(gridDim.x) * kThreads) {
    float v = y_work[e];
    for (int z = 1; z < tiles; ++z) v += y_work[z * total + e];
    const int p = static_cast<int>(e % P);
    const long long row = e / P;
    const int h = static_cast<int>(row % H);
    const int t = static_cast<int>(row / H % S);
    const long long bi = row / H / S;
    y[bi * ys.b + t * ys.s + h * ys.h + p] = from_f32<T>(v);
  }
}

template <class T>
cudaError_t launch_sum_tiles(const float* y_work, void* y, int tiles, int B, int S, int H, int P,
                             Strides ys, cudaStream_t stream) {
  const long long total = static_cast<long long>(B) * S * H * P;
  const long long blocks = (total + kThreads - 1) / kThreads;
  sum_tiles<T><<<static_cast<int>(blocks < 132 * 8 ? blocks : 132 * 8), kThreads, 0, stream>>>(
      y_work, static_cast<T*>(y), tiles, S, H, P, total, ys);
  return cudaGetLastError();
}

template <int PC, int NC, class T>
cudaError_t launch_f32(const void* x, const float* a, const void* b, const void* c,
                       const float* s0, void* y, float* y_work, float* s_out, int B, int S,
                       int H, int P, int N, int Q, Strides xs, Strides as, Strides bs,
                       Strides cs, Strides ys, cudaStream_t stream) {
  const int smem =
      smem_floats(pad32(Q), kLanes * NC, kLanes * PC) * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      ssd_scan_f32<PC, NC, T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(B * H, (P + kPT - 1) / kPT, (N + kTileN - 1) / kTileN);
  ssd_scan_f32<PC, NC, T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), a, static_cast<const T*>(b), static_cast<const T*>(c), s0,
      static_cast<T*>(y), y_work, s_out, H, S, Q, P, N, xs, as, bs, cs, ys);
  return cudaGetLastError();
}

#define REPRO_SSD_ARGS \
  x, a, b, c, s0, y, y_work, s_out, B, S, H, P, N, Q, xs, as, bs, cs, ys, stream

template <int PC, class T>
cudaError_t dispatch_f32_n(int nc, const void* x, const float* a, const void* b, const void* c,
                           const float* s0, void* y, float* y_work, float* s_out, int B, int S,
                           int H, int P, int N, int Q, Strides xs, Strides as, Strides bs,
                           Strides cs, Strides ys, cudaStream_t stream) {
  switch (nc) {
    case 1: return launch_f32<PC, 1, T>(REPRO_SSD_ARGS);
    case 2: return launch_f32<PC, 2, T>(REPRO_SSD_ARGS);
    case 3: return launch_f32<PC, 3, T>(REPRO_SSD_ARGS);
    case 4: return launch_f32<PC, 4, T>(REPRO_SSD_ARGS);
    default: return cudaErrorInvalidValue;
  }
}

// The scalar kernel for x, b, c and y of type T: its column blocks cover
// the P tile and the widest state tile.
template <class T>
cudaError_t dispatch_f32(const void* x, const float* a, const void* b, const void* c,
                         const float* s0, void* y, float* y_work, float* s_out, int B, int S,
                         int H, int P, int N, int Q, Strides xs, Strides as, Strides bs,
                         Strides cs, Strides ys, cudaStream_t stream) {
  const int nc = pad32(N < kTileN ? N : kTileN) / kLanes;
  if (P > kLanes) return dispatch_f32_n<2, T>(nc, REPRO_SSD_ARGS);
  return dispatch_f32_n<1, T>(nc, REPRO_SSD_ARGS);
}

// ---------------------------------------------------------------------------
// bfloat16: tensor-core kernel
// ---------------------------------------------------------------------------

namespace tc {

using bf16 = __nv_bfloat16;

constexpr int kQ = kSubQ;            // chunk rows as staged
constexpr int kN = kTileN;           // state columns as staged
constexpr int kLdN = kN + 8;         // C, B and S rows: +16 bytes against bank conflicts
constexpr int kLdX = kPT + 8;        // X rows
constexpr int kWarps = kThreads / 32;
constexpr int kKS = kN / 16;         // k steps over the state width, at most
// shared memory, in bytes: two buffers of a chunk's C, B, X and a, then the
// state (hi and lo bf16 halves) and the chunk's A, exp(A), exp(A[last] - A)
constexpr int kOffC = 0;
constexpr int kOffB = kOffC + kQ * kLdN * 2;
constexpr int kOffX = kOffB + kQ * kLdN * 2;
constexpr int kOffRawA = kOffX + kQ * kLdX * 2;
constexpr int kBufBytes = kOffRawA + kQ * 4;
constexpr int kOffSHi = 2 * kBufBytes;
constexpr int kOffSLo = kOffSHi + kPT * kLdN * 2;
constexpr int kOffA = kOffSLo + kPT * kLdN * 2;
constexpr int kOffEA = kOffA + kQ * 4;
constexpr int kOffDE = kOffEA + kQ * 4;
constexpr int kSmemBytes = kOffDE + kQ * 4;
static_assert(kWarps * 16 == kQ, "one warp per 16 chunk rows");
static_assert(kSmemBytes <= 227 * 1024, "shared memory of one CTA");

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, zeros when !live (nothing is read then)
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool live) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(dst), "l"(src),
               "r"(live ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, bool live) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(dst), "l"(src),
               "r"(live ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

// d += a b: m16n8k16, bf16 operands, f32 accumulators
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}
__device__ __forceinline__ float2 unpack(uint32_t v) {
  return __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&v));
}

// ldmatrix addresses; `lane` picks a row of one of the four 8 x 8 matrices.
// A operand, rows r0.. and k columns k0.. of a row-major tile.
__device__ __forceinline__ uint32_t a_addr(uint32_t base, int ld, int r0, int k0, int lane) {
  const int m = lane >> 3;
  return base + 2 * ((r0 + (lane & 7) + 8 * (m & 1)) * ld + k0 + 8 * (m >> 1));
}
// B operands of two n8 tiles (n0.., n0 + 8..) at k0.., stored one row per n
// (read as is) or one row per k (read transposed).
__device__ __forceinline__ uint32_t b_addr_n(uint32_t base, int ld, int n0, int k0, int lane) {
  const int m = lane >> 3;
  return base + 2 * ((n0 + (lane & 7) + 8 * (m >> 1)) * ld + k0 + 8 * (m & 1));
}
__device__ __forceinline__ uint32_t b_addr_k(uint32_t base, int ld, int n0, int k0, int lane) {
  const int m = lane >> 3;
  return base + 2 * ((k0 + (lane & 7) + 8 * (m & 1)) * ld + n0 + 8 * (m >> 1));
}
// A operand of the transpose of a tile stored one row per k (X as X^T).
__device__ __forceinline__ uint32_t at_addr(uint32_t base, int ld, int m0, int k0, int lane) {
  const int m = lane >> 3;
  return base + 2 * ((k0 + (lane & 7) + 8 * (m >> 1)) * ld + m0 + 8 * (m & 1));
}

// Rows of a chunk into shared memory: `rows` x `cols` bf16 of `src` (row
// stride `ss` elements) into a kQ x (8 * pieces) tile with row stride `ld`,
// zeros past rows and cols.  kVec: 16-byte cp.async (rows 16-byte aligned,
// cols a multiple of 8); else element by element.
template <bool kVec, int kPieces>
__device__ __forceinline__ void load_rows(unsigned char* smem, int off, int ld, const bf16* src,
                                          long long ss, int rows, int cols, int tid) {
  bf16* dst = reinterpret_cast<bf16*>(smem + off);
  for (int k = tid; k < kQ * kPieces; k += kThreads) {
    const int r = k / kPieces;
    const int c0 = 8 * (k - r * kPieces);
    const bf16* row = src + r * ss;
    if (kVec) {
      const bool live = r < rows && c0 < cols;
      cp_async16(smem_addr(dst + r * ld + c0), live ? row + c0 : src, live);
    } else {
      const unsigned short* rs = reinterpret_cast<const unsigned short*>(row);
      unsigned short* ds = reinterpret_cast<unsigned short*>(dst + r * ld + c0);
#pragma unroll
      for (int e = 0; e < 8; ++e) ds[e] = r < rows && c0 + e < cols ? rs[c0 + e] : 0;
    }
  }
}

template <bool kVec>
__device__ __forceinline__ void load_a(float* dst, const float* ab, long long ss, int rows,
                                       int tid) {
  if (tid < kQ) {
    const bool live = tid < rows;
    if (kVec)
      cp_async4(smem_addr(dst + tid), live ? ab + tid * ss : ab, live);
    else
      dst[tid] = live ? ab[tid * ss] : 0.f;
  }
}

// v as hi + lo, two bf16 pairs whose sum keeps about 16 bits of v
__device__ __forceinline__ void split(float v0, float v1, uint32_t& hi, uint32_t& lo) {
  hi = pack(v0, v1);
  const float2 h = unpack(hi);
  lo = pack(v0 - h.x, v1 - h.y);
}

// One CTA of 8 warps per (stream b*h, 64-column P tile, 128-column state
// tile).  Each warp owns 16 chunk rows (G o L, y) and the state block of
// rows 16 (w % 4) .. and columns 64 (w / 4) .. (the update).  y_work, when
// not null, takes this state tile's partial y in f32 instead of y.
// kSplitXd (a state of several tiles): X o decay as hi + lo.
template <bool kVec, bool kSplitXd>
__global__ void __launch_bounds__(kThreads, 1)
ssd_scan_bf16(const bf16* __restrict__ x, const float* __restrict__ a,
              const bf16* __restrict__ b, const bf16* __restrict__ c,
              const float* __restrict__ s0, bf16* __restrict__ y, float* __restrict__ y_work,
              float* __restrict__ s_out, int H, int S, int Q, int P, int N, Strides xs,
              Strides as, Strides bs, Strides cs, Strides ys) {
  extern __shared__ __align__(16) unsigned char tc_smem[];
  unsigned char* smem = tc_smem;
  const uint32_t sbase = smem_addr(smem);
  const uint32_t sSHi = sbase + kOffSHi, sSLo = sbase + kOffSLo;
  float* sA = reinterpret_cast<float*>(smem + kOffA);
  float* sEA = reinterpret_cast<float*>(smem + kOffEA);
  float* sDE = reinterpret_cast<float*>(smem + kOffDE);

  const int bh = blockIdx.x;
  const int bi = bh / H;
  const int h = bh - bi * H;
  const int p0 = blockIdx.y * kPT;
  const int PT = min(kPT, P - p0);  // live columns of this CTA
  const int n0 = blockIdx.z * kN;
  const int NT = min(kN, N - n0);   // live state columns of this CTA
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;

  const bf16* xb = x + bi * xs.b + h * xs.h + p0;
  const float* ab = a + bi * as.b + h * as.h;
  const bf16* bb = b + bi * bs.b + h * bs.h + n0;
  const bf16* cb = c + bi * cs.b + h * cs.h + n0;
  bf16* yb = y + bi * ys.b + h * ys.h + p0;
  float* yw = y_work == nullptr
                  ? nullptr
                  : y_work + static_cast<long long>(blockIdx.z) * gridDim.x * S * P + p0;
  const float* s0b = s0 + (static_cast<long long>(bh) * P + p0) * N + n0;
  float* sob = s_out + (static_cast<long long>(bh) * P + p0) * N + n0;

  const int nk = (NT + 15) / 16;     // k steps over the state tile
  const int sm0 = 16 * (warp & 3);   // this warp's state rows (p) ...
  const int sn0 = 64 * (warp >> 2);  // ... and columns (n)
  // this warp's 16 chunk rows: warps w and w + 4 share a scheduler and get
  // strips w and 7 - w, whose G tiles left of the diagonal number 9 together
  const int strip = warp < 4 ? warp : 11 - warp;
  const int r0 = 16 * strip;

  // The state: f32 in the update's accumulators; in shared memory as the
  // hi and lo bf16 halves of the B operand of C S^T.
  float st[8][4];
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int p = sm0 + g + 8 * (e >> 1), n = sn0 + 8 * nt + 2 * t + (e & 1);
      st[nt][e] = p < PT && n < NT ? s0b[p * N + n] : 0.f;
    }
  auto store_state = [&]() {
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int off = 2 * ((sm0 + g + 8 * hf) * kLdN + sn0 + 8 * nt + 2 * t);
        uint32_t hi, lo;
        split(st[nt][2 * hf], st[nt][2 * hf + 1], hi, lo);
        *reinterpret_cast<uint32_t*>(smem + kOffSHi + off) = hi;
        *reinterpret_cast<uint32_t*>(smem + kOffSLo + off) = lo;
      }
  };
  store_state();

  const int n_chunks = (S + Q - 1) / Q;
  auto issue = [&](int ch) {  // chunk ch's C, B, X and a into buffer ch % 2
    const int t0 = ch * Q, rows = min(Q, S - t0), buf = (ch & 1) * kBufBytes;
    load_rows<kVec, kN / 8>(smem, buf + kOffC, kLdN, cb + t0 * cs.s, cs.s, rows, NT, tid);
    load_rows<kVec, kN / 8>(smem, buf + kOffB, kLdN, bb + t0 * bs.s, bs.s, rows, NT, tid);
    load_rows<kVec, kPT / 8>(smem, buf + kOffX, kLdX, xb + t0 * xs.s, xs.s, rows, PT, tid);
    load_a<kVec>(reinterpret_cast<float*>(smem + buf + kOffRawA), ab + t0 * as.s, as.s, rows,
                 tid);
    if (kVec) cp_commit();
  };
  if (n_chunks > 0) issue(0);
  if (n_chunks > 1) issue(1);

  for (int ch = 0; ch < n_chunks; ++ch) {
    const int t0 = ch * Q;
    const int rows = min(Q, S - t0);  // live rows of this chunk
    const bool live_strip = r0 < rows;
    const int buf = (ch & 1) * kBufBytes;
    const uint32_t sC = sbase + buf + kOffC, sB = sbase + buf + kOffB, sX = sbase + buf + kOffX;
    if (kVec) {  // this chunk's loads (the next chunk's may still be in flight)
      if (ch + 1 < n_chunks)
        cp_wait<1>();
      else
        cp_wait<0>();
    }
    __syncthreads();  // ... for everyone, with the state's bf16 halves

    if (warp == 0) {  // inclusive cumsum of a: 4 steps per lane, then a warp scan
      const float* raw = reinterpret_cast<const float*>(smem + buf + kOffRawA);
      float v[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) v[k] = raw[4 * lane + k];
      v[1] += v[0];
      v[2] += v[1];
      v[3] += v[2];
      float tot = v[3];
#pragma unroll
      for (int off = 1; off < 32; off *= 2) {
        const float up = __shfl_up_sync(0xffffffffu, tot, off);
        if (lane >= off) tot += up;
      }
      const float before = tot - v[3];
      const float last = __shfl_sync(0xffffffffu, tot, 31);  // rows past the chunk add 0
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float A = v[k] + before;
        sA[4 * lane + k] = A;
        sEA[4 * lane + k] = expf(A);
        sDE[4 * lane + k] = expf(last - A);
      }
    }

    // y = exp(A) C S^T, the carried-in state's part (S as hi + lo)
    float acc[8][4];
#pragma unroll
    for (int pt = 0; pt < 8; ++pt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[pt][e] = 0.f;
    if (live_strip) {
#pragma unroll
      for (int ks = 0; ks < kKS; ++ks) {
        if (ks < nk) {
          uint32_t af[4];
          ldsm_x4(af, a_addr(sC, kLdN, r0, 16 * ks, lane));
#pragma unroll
          for (int pp = 0; pp < 4; ++pp) {
            uint32_t bh4[4], bl4[4];
            ldsm_x4(bh4, b_addr_n(sSHi, kLdN, 16 * pp, 16 * ks, lane));
            ldsm_x4(bl4, b_addr_n(sSLo, kLdN, 16 * pp, 16 * ks, lane));
            mma(acc[2 * pp], af, bh4[0], bh4[1]);
            mma(acc[2 * pp + 1], af, bh4[2], bh4[3]);
            mma(acc[2 * pp], af, bl4[0], bl4[1]);
            mma(acc[2 * pp + 1], af, bl4[2], bl4[3]);
          }
        }
      }
    }
    __syncthreads();  // A, exp(A) and exp(A[last] - A)

    if (live_strip) {
      const float ea0 = sEA[r0 + g], ea1 = sEA[r0 + g + 8];
#pragma unroll
      for (int pt = 0; pt < 8; ++pt) {
        acc[pt][0] *= ea0;
        acc[pt][1] *= ea0;
        acc[pt][2] *= ea1;
        acc[pt][3] *= ea1;
      }
      // y += (G o L) X over the 16-column tiles of G at or left of the
      // diagonal, two tiles at a time so that their products interleave
      const float ai0 = sA[r0 + g], ai1 = sA[r0 + g + 8];
      const int i0 = r0 + g, i1 = i0 + 8;
      for (int kt = 0; kt <= strip; kt += 2) {
        const bool two = kt + 1 <= strip;
        float gt[2][2][4] = {};
#pragma unroll
        for (int ks = 0; ks < kKS; ++ks) {
          if (ks < nk) {
            uint32_t af[4], bf[4];
            ldsm_x4(af, a_addr(sC, kLdN, r0, 16 * ks, lane));
            ldsm_x4(bf, b_addr_n(sB, kLdN, 16 * kt, 16 * ks, lane));
            mma(gt[0][0], af, bf[0], bf[1]);
            mma(gt[0][1], af, bf[2], bf[3]);
            if (two) {
              ldsm_x4(bf, b_addr_n(sB, kLdN, 16 * kt + 16, 16 * ks, lane));
              mma(gt[1][0], af, bf[0], bf[1]);
              mma(gt[1][1], af, bf[2], bf[3]);
            }
          }
        }
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          if (u == 1 && !two) break;
          const int kc = kt + u;  // the tile's 16 columns: 16 kc ..
          // G o L: segsum -inf above the diagonal before the exp, so the
          // exp gives 0 there and no inf * 0 can arise; split hi + lo
          uint32_t ph[4], pl[4];
#pragma unroll
          for (int nt = 0; nt < 2; ++nt) {
            const int j = 16 * kc + 8 * nt + 2 * t;
            const float aj0 = sA[j], aj1 = sA[j + 1];
            const float l00 = __expf(j <= i0 ? ai0 - aj0 : -INFINITY);
            const float l01 = __expf(j + 1 <= i0 ? ai0 - aj1 : -INFINITY);
            const float l10 = __expf(j <= i1 ? ai1 - aj0 : -INFINITY);
            const float l11 = __expf(j + 1 <= i1 ? ai1 - aj1 : -INFINITY);
            split(gt[u][nt][0] * l00, gt[u][nt][1] * l01, ph[2 * nt], pl[2 * nt]);
            split(gt[u][nt][2] * l10, gt[u][nt][3] * l11, ph[2 * nt + 1], pl[2 * nt + 1]);
          }
#pragma unroll
          for (int pp = 0; pp < 4; ++pp) {
            uint32_t bf[4];
            ldsm_x4_t(bf, b_addr_k(sX, kLdX, 16 * pp, 16 * kc, lane));
            mma(acc[2 * pp], ph, bf[0], bf[1]);
            mma(acc[2 * pp + 1], ph, bf[2], bf[3]);
            mma(acc[2 * pp], pl, bf[0], bf[1]);
            mma(acc[2 * pp + 1], pl, bf[2], bf[3]);
          }
        }
      }
      // y rows r0 + g and r0 + g + 8, columns 8 pt + 2 t and + 1
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int i = r0 + g + 8 * hf;
        if (i < rows && yw != nullptr) {
          float* wr = yw + work_row(bi, t0 + i, h, S, H, P);
#pragma unroll
          for (int pt = 0; pt < 8; ++pt) {
            const int p = 8 * pt + 2 * t;
            if (p < PT) wr[p] = acc[pt][2 * hf];
            if (p + 1 < PT) wr[p + 1] = acc[pt][2 * hf + 1];
          }
        } else if (i < rows) {
          bf16* yr = yb + (t0 + i) * ys.s;
#pragma unroll
          for (int pt = 0; pt < 8; ++pt) {
            const int p = 8 * pt + 2 * t;
            if (p + 1 < PT && (P & 1) == 0) {
              *reinterpret_cast<uint32_t*>(yr + p) = pack(acc[pt][2 * hf], acc[pt][2 * hf + 1]);
            } else {
              if (p < PT) yr[p] = __float2bfloat16(acc[pt][2 * hf]);
              if (p + 1 < PT) yr[p + 1] = __float2bfloat16(acc[pt][2 * hf + 1]);
            }
          }
        }
      }
    }

    // S = S exp(A[last]) + (X o exp(A[last] - A))^T B
    const float decay = sEA[kQ - 1];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[nt][e] *= decay;
    if (sn0 < NT) {
      const int nq = (rows + 15) / 16;
#pragma unroll
      for (int ks = 0; ks < kQ / 16; ++ks) {
        if (ks < nq) {
          uint32_t af[4];
          ldsm_x4_t(af, at_addr(sX, kLdX, sm0, 16 * ks, lane));
          const int j0 = 16 * ks + 2 * t, j1 = j0 + 8;  // k (step) of af[0..1] and af[2..3]
          const float d00 = sDE[j0], d01 = sDE[j0 + 1], d10 = sDE[j1], d11 = sDE[j1 + 1];
          uint32_t al[4];  // the lo half, with kSplitXd
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float2 v = unpack(af[e]);
            const float v0 = v.x * (e < 2 ? d00 : d10), v1 = v.y * (e < 2 ? d01 : d11);
            if constexpr (kSplitXd) {
              split(v0, v1, af[e], al[e]);
            } else {
              af[e] = pack(v0, v1);
            }
          }
#pragma unroll
          for (int np = 0; np < 4; ++np) {
            uint32_t bf[4];
            ldsm_x4_t(bf, b_addr_k(sB, kLdN, sn0 + 16 * np, 16 * ks, lane));
            mma(st[2 * np], af, bf[0], bf[1]);
            mma(st[2 * np + 1], af, bf[2], bf[3]);
            if constexpr (kSplitXd) {
              mma(st[2 * np], al, bf[0], bf[1]);
              mma(st[2 * np + 1], al, bf[2], bf[3]);
            }
          }
        }
      }
    }
    __syncthreads();  // this chunk's buffer and the state's halves are free
    store_state();
    if (ch + 2 < n_chunks) issue(ch + 2);
  }

#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int p = sm0 + g + 8 * (e >> 1), n = sn0 + 8 * nt + 2 * t + (e & 1);
      if (p < PT && n < NT) sob[p * N + n] = st[nt][e];
    }
}

cudaError_t launch_bf16(int load_mode, const void* x, const float* a, const void* b, const void* c,
                        const float* s0, void* y, float* y_work, float* s_out, int B, int S, int H,
                        int P, int N, int Q, Strides xs, Strides as, Strides bs, Strides cs,
                        Strides ys, cudaStream_t stream) {
  const bool split_xd = N > kN;
  const auto kernel = load_mode == 1
                          ? (split_xd ? ssd_scan_bf16<true, true> : ssd_scan_bf16<true, false>)
                          : (split_xd ? ssd_scan_bf16<false, true> : ssd_scan_bf16<false, false>);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(B * H, (P + kPT - 1) / kPT, (N + kN - 1) / kN);
  kernel<<<grid, kThreads, kSmemBytes, stream>>>(
      static_cast<const bf16*>(x), a, static_cast<const bf16*>(b), static_cast<const bf16*>(c),
      s0, static_cast<bf16*>(y), y_work, s_out, H, S, Q, P, N, xs, as, bs, cs, ys);
  return cudaGetLastError();
}

// Whether 16-byte cp.async can read every row of a bf16 (B, S, H, n) tensor
// whose rows have `n` elements: a 16-byte-aligned base and strides of
// multiples of 8 elements, n a multiple of 8.
bool rows_aligned(const void* p, Strides st, int n) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && st.b % 8 == 0 && st.s % 8 == 0 &&
         st.h % 8 == 0 && n % 8 == 0;
}

}  // namespace tc

#undef REPRO_SSD_ARGS

}  // namespace

// x (B, S, H, P), a (B, S, H) f32, b and c (B, S, H, N), y (B, S, H, P), each
// with the element strides given for its batch, sequence and head dims and a
// dense last dim (a head stride of 0 broadcasts b or c over heads); s0 and
// s_out (B*H, P, N) f32, dense.  Q is the chunk length (over kSubQ it runs
// as sub-chunks), N the state width (over kTileN it runs as tiles on
// blockIdx.z); the P and state tiles are each at most kMaxGridYZ.  y_work:
// a dense f32 (ceil(N / kTileN), B, S, H, P) workspace when N > kTileN, else
// null.
// dtype of x, b, c, y: 0 = float32 (the scalar kernel), 1 = bfloat16 (the
// tensor-core kernel), 2 = float16 (the scalar kernel, f32 inside).
// load_mode (bfloat16 only): 1 = 16-byte cp.async, which needs every row of
// x, b and c 16-byte aligned (refused otherwise, never rerouted), 0 = element
// by element.  Returns a cudaError_t (0 = launched).
extern "C" int repro_ssd_scan(const void* x, const float* a, const void* b,
                              const void* c, const float* s0, void* y, float* y_work,
                              float* s_out, int dtype, int load_mode, int B, int S,
                              int H, int P, int N, int Q, long long x_sb,
                              long long x_ss, long long x_sh, long long a_sb,
                              long long a_ss, long long a_sh, long long b_sb,
                              long long b_ss, long long b_sh, long long c_sb,
                              long long c_ss, long long c_sh, long long y_sb,
                              long long y_ss, long long y_sh, void* stream) {
  if (B <= 0 || H <= 0 || S < 0 || P <= 0 || N <= 0 || Q <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int tiles = (N + kTileN - 1) / kTileN;
  if (tiles > kMaxGridYZ || (P + kPT - 1) / kPT > kMaxGridYZ)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  if (tiles > 1 && S > 0 && y_work == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const int n_sub = (Q + kSubQ - 1) / kSubQ;
  const int Qs = (Q + n_sub - 1) / n_sub;  // rows of a sub-chunk: what the kernels run
  const Strides xs{x_sb, x_ss, x_sh}, as{a_sb, a_ss, a_sh};
  const Strides bs{b_sb, b_ss, b_sh}, cs{c_sb, c_ss, c_sh}, ys{y_sb, y_ss, y_sh};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0) {
    err = dispatch_f32<float>(x, a, b, c, s0, y, y_work, s_out, B, S, H, P, N, Qs, xs, as, bs,
                              cs, ys, st);
  } else if (dtype == 2) {
    err = dispatch_f32<__half>(x, a, b, c, s0, y, y_work, s_out, B, S, H, P, N, Qs, xs, as, bs,
                               cs, ys, st);
  } else {
    if (dtype != 1 || (load_mode != 0 && load_mode != 1))
      return static_cast<int>(cudaErrorInvalidValue);
    if (load_mode == 1 && !(tc::rows_aligned(x, xs, P) && tc::rows_aligned(b, bs, N) &&
                            tc::rows_aligned(c, cs, N)))
      return static_cast<int>(cudaErrorMisalignedAddress);
    err = tc::launch_bf16(load_mode, x, a, b, c, s0, y, y_work, s_out, B, S, H, P, N, Qs, xs, as,
                          bs, cs, ys, st);
  }
  if (err != cudaSuccess || tiles == 1 || S == 0) return static_cast<int>(err);
  switch (dtype) {
    case 0: return static_cast<int>(launch_sum_tiles<float>(y_work, y, tiles, B, S, H, P, ys, st));
    case 1:
      return static_cast<int>(launch_sum_tiles<__nv_bfloat16>(y_work, y, tiles, B, S, H, P, ys, st));
    default: return static_cast<int>(launch_sum_tiles<__half>(y_work, y, tiles, B, S, H, P, ys, st));
  }
}

extern "C" const char* repro_ssd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
