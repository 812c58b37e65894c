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
// for about 34 MB of input and output, some 240 FLOP per byte: on the bf16
// tensor cores the bytes would bound it (about 0.010 ms at 3.35 TB/s).  This
// first version does the products with scalar f32 FMAs on the CUDA cores (no
// mma.sync, wgmma or TMA yet), so the FMAs bound it instead.  What the design
// does about the bytes: each input element is read from device memory once,
// the state never leaves the chip between chunks, B and C are read through
// the caller's strides (the model's head broadcast has head stride 0, so
// nothing is copied per head), and the Q x Q decay matrix exists only as one
// 32-row tile in shared memory.  What it does about the FMAs: every product
// runs from shared memory into a register block (4 x 4 for C B^T, up to
// 8 x 4 for the state update) with one operand broadcast across the warp,
// and C B^T tiles wholly above the diagonal are skipped.
//
// Layout of the work:
//  * one CTA of 256 threads per (stream b*h, 64-column P tile); the chunk
//    loop runs inside the CTA, replacing the TPU's sequential chunk axis;
//  * the chunk's C, B (Q x N) and X (Q x P tile) are staged in shared memory
//    as f32 with the state S (P tile x N); rows are padded to 32 and the
//    N-major rows by one float, so column walks are free of bank conflicts
//    (about 210 KB at Q = N = 128, P = 64: dynamic shared memory opted in
//    with cudaFuncSetAttribute, one CTA per SM);
//  * warp 0 takes the inclusive cumsum of a (4 steps per lane, then a warp
//    scan), so A sits in shared memory for everyone;
//  * y is produced in 32-row tiles: the tile of (C B^T) o L, masked to -inf
//    above the diagonal before the exp, then y = tile X + exp(A) C S^T;
//  * after the last tile, X rows are scaled by exp(A[Q-1] - A[j]) in place
//    and the state is updated.  Splitting P over two CTAs would recompute
//    C B^T in each; at P = 64 there is one P tile, so nothing is repeated.
//
// f32 inputs stay f32 end to end; bf16 inputs are widened to f32 on load and
// y is rounded once.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kLanes = 32;
constexpr int kRow = 32;      // rows of a y tile; Q, N and P are padded to it
constexpr int kPT = 64;       // P columns per CTA
constexpr int kMaxQ = 128;    // chunk length limit (the warp-0 cumsum holds 4 per lane)
constexpr int kMaxN = 128;    // state width limit (register block of the update)

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_f32(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_f32(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// Element strides of the batch, sequence and head dims (the last dim is dense).
struct Strides {
  long long b, s, h;
};

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

template <typename T, int PC, int NC>
__global__ void __launch_bounds__(kThreads)
ssd_scan_kernel(const T* __restrict__ x, const float* __restrict__ a,
                const T* __restrict__ b, const T* __restrict__ c,
                const float* __restrict__ s0, T* __restrict__ y,
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
  const int tid = threadIdx.x;
  const int ty = tid / kLanes;
  const int tx = tid - ty * kLanes;

  const T* xb = x + bi * xs.b + h * xs.h + p0;
  const float* ab = a + bi * as.b + h * as.h;
  const T* bb = b + bi * bs.b + h * bs.h;
  const T* cb = c + bi * cs.b + h * cs.h;
  T* yb = y + bi * ys.b + h * ys.h + p0;
  const float* s0b = s0 + (static_cast<long long>(bh) * P + p0) * N;
  float* sob = s_out + (static_cast<long long>(bh) * P + p0) * N;

  for (int k = tid; k < Pp * Np; k += kThreads) {
    const int p = k / Np;
    const int n = k - p * Np;
    sS[p * ldn + n] = p < PT && n < N ? s0b[p * N + n] : 0.f;
  }

  const int n_chunks = (S + Q - 1) / Q;
  for (int ch = 0; ch < n_chunks; ++ch) {
    const int t0 = ch * Q;
    const int rows = min(Q, S - t0);  // live rows of this chunk
    __syncthreads();  // the previous chunk is done with sB, sX; s0 staged

    for (int k = tid; k < Qp * Np; k += kThreads) {
      const int r = k / Np;
      const int n = k - r * Np;
      const bool live = r < rows && n < N;
      const long long t = t0 + r;
      sC[r * ldn + n] = live ? load_f32(cb + t * cs.s + n) : 0.f;
      sB[r * ldn + n] = live ? load_f32(bb + t * bs.s + n) : 0.f;
    }
    for (int k = tid; k < Qp * Pp; k += kThreads) {
      const int r = k / Pp;
      const int p = k - r * Pp;
      sX[k] = r < rows && p < PT ? load_f32(xb + (t0 + r) * xs.s + p) : 0.f;
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
            if (p < PT)
              store_f32(yb + (t0 + i) * ys.s + p, fmaf(decay, off[r][pc], acc[r][pc]));
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

  for (int k = tid; k < PT * N; k += kThreads) {
    const int p = k / N;
    const int n = k - p * N;
    sob[k] = sS[p * ldn + n];
  }
}

template <typename T, int PC, int NC>
cudaError_t launch(const void* x, const float* a, const void* b, const void* c,
                   const float* s0, void* y, float* s_out, int B, int S, int H,
                   int P, int N, int Q, Strides xs, Strides as, Strides bs,
                   Strides cs, Strides ys, cudaStream_t stream) {
  const int smem =
      smem_floats(pad32(Q), kLanes * NC, kLanes * PC) * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      ssd_scan_kernel<T, PC, NC>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(B * H, (P + kPT - 1) / kPT);
  ssd_scan_kernel<T, PC, NC><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), a, static_cast<const T*>(b),
      static_cast<const T*>(c), s0, static_cast<T*>(y), s_out, H, S, Q, P, N,
      xs, as, bs, cs, ys);
  return cudaGetLastError();
}

template <typename T, int PC>
cudaError_t dispatch_n(int nc, const void* x, const float* a, const void* b,
                       const void* c, const float* s0, void* y, float* s_out,
                       int B, int S, int H, int P, int N, int Q, Strides xs,
                       Strides as, Strides bs, Strides cs, Strides ys,
                       cudaStream_t stream) {
  switch (nc) {
    case 1: return launch<T, PC, 1>(x, a, b, c, s0, y, s_out, B, S, H, P, N, Q, xs, as, bs, cs, ys, stream);
    case 2: return launch<T, PC, 2>(x, a, b, c, s0, y, s_out, B, S, H, P, N, Q, xs, as, bs, cs, ys, stream);
    case 3: return launch<T, PC, 3>(x, a, b, c, s0, y, s_out, B, S, H, P, N, Q, xs, as, bs, cs, ys, stream);
    case 4: return launch<T, PC, 4>(x, a, b, c, s0, y, s_out, B, S, H, P, N, Q, xs, as, bs, cs, ys, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t dispatch(const void* x, const float* a, const void* b,
                     const void* c, const float* s0, void* y, float* s_out,
                     int B, int S, int H, int P, int N, int Q, Strides xs,
                     Strides as, Strides bs, Strides cs, Strides ys,
                     cudaStream_t stream) {
  const int nc = pad32(N) / kLanes;
  if (P > kLanes)
    return dispatch_n<T, 2>(nc, x, a, b, c, s0, y, s_out, B, S, H, P, N, Q, xs, as, bs, cs, ys, stream);
  return dispatch_n<T, 1>(nc, x, a, b, c, s0, y, s_out, B, S, H, P, N, Q, xs, as, bs, cs, ys, stream);
}

}  // namespace

// x (B, S, H, P), a (B, S, H) f32, b and c (B, S, H, N), y (B, S, H, P), each
// with the element strides given for its batch, sequence and head dims and a
// dense last dim (a head stride of 0 broadcasts b or c over heads); s0 and
// s_out (B*H, P, N) f32, dense.  Q is the chunk length.  dtype of x, b, c, y:
// 0 = float32, 1 = bfloat16.  Returns a cudaError_t (0 = launched).
extern "C" int repro_ssd_scan(const void* x, const float* a, const void* b,
                              const void* c, const float* s0, void* y,
                              float* s_out, int dtype, int B, int S, int H,
                              int P, int N, int Q, long long x_sb,
                              long long x_ss, long long x_sh, long long a_sb,
                              long long a_ss, long long a_sh, long long b_sb,
                              long long b_ss, long long b_sh, long long c_sb,
                              long long c_ss, long long c_sh, long long y_sb,
                              long long y_ss, long long y_sh, void* stream) {
  if (B <= 0 || H <= 0 || S < 0 || P <= 0 || N <= 0 || N > kMaxN || Q <= 0 ||
      Q > kMaxQ)
    return static_cast<int>(cudaErrorInvalidValue);
  const Strides xs{x_sb, x_ss, x_sh}, as{a_sb, a_ss, a_sh};
  const Strides bs{b_sb, b_ss, b_sh}, cs{c_sb, c_ss, c_sh}, ys{y_sb, y_ss, y_sh};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0)
    err = dispatch<float>(x, a, b, c, s0, y, s_out, B, S, H, P, N, Q, xs, as, bs, cs, ys, st);
  else if (dtype == 1)
    err = dispatch<__nv_bfloat16>(x, a, b, c, s0, y, s_out, B, S, H, P, N, Q, xs, as, bs, cs, ys, st);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}

extern "C" const char* repro_ssd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
