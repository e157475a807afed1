// Hopper kernel of the RWKV6 (Finch) WKV recurrence: per (batch, head), an
// fp32 (dk x dv) state S carried over T steps with a data-dependent decay w
// and a bonus u,
//
//     y_t = r_t . (S + diag(u) k_t v_t^T)        (dv outputs)
//     S   = diag(w_t) S + k_t v_t^T
//
// It replaces the JAX package's Pallas kernel kernels/rwkv6_scan.py (wkv6 /
// _wkv_kernel).  The TPU kernel cuts T into chunks of 32 and runs each chunk
// as two MXU products of decay-rescaled r and k, rescaling by
// exp(-cumsum(log w)); below a decay of about 0.06 those factors overflow
// fp32 within a chunk.  This kernel runs the exact sequential recurrence of
// the reference's oracle (kernels/ref.py wkv6_ref) instead, which has no
// such limit.
//
// Layout of the work: a block owns one (batch, head) and a tile of C state
// columns: C = 32, or 16 (for dk <= 64) where 32 would leave SMs without a
// block, as in one request's prefill (B * H * dv / 32 = 128 blocks on 132
// SMs): more blocks hide more of each step's latency, while a grid that
// fills the card, as a decode step of 4 slots does, runs faster on 32.
// Four neighbouring lanes share a column j; lane g of the four
// holds rows g, g + 4, g + 8, ... of that column in registers (dk / 4
// values), so a step is, per lane and row i, kv = k_i v_j,
// y += r_i (s_ij + u_i kv) and s_ij = w_i s_ij + kv, with no exchange
// between lanes except two warp shuffles that add up the four partial y_j.
// Each step's rows {r_i, k_i, w_i, u_i} are staged in shared memory as one
// float4 per row, 16 steps at a time, from coalesced loads; the next 16
// steps are fetched into registers (widened only when staged) while the
// current ones run, so the chain over T does not wait on memory.  S is read
// from s0 once at the start and written to sT once at the end; sT may be s0
// itself (a serving slot's state updated in place), since a block reads and
// writes only its own columns.
//
// What bounds it on the H100: in decode (T = 1) the state's bytes (4 * dk *
// dv read and written per head: 8.4 MB a layer for 4 RWKV6-7B slots); in
// prefill the serial chain over T, with only B * H * dv * 4 lanes (16,384
// for one RWKV6-7B request: one warp per scheduler) to hide each step's
// shared-memory reads and shuffles.  A step takes ~550 cycles at dk = dv =
// 64, against ~150 to dispatch its instructions; more lanes per column,
// more columns per lane and unrolled steps all measured no better, and the
// 16-column tile only where the 32-column grid leaves SMs idle (PERF.md).  The chunked form on wgmma tiles, with a rescaling that is
// safe for small decays, is later work.
//
// r, k and v are fp32 or bf16 (read directly, one template each), w, u, s0
// are fp32, y and sT fp32.  dk and dv up to 128.
//
// Plain C interface for ctypes: launches on the given stream, allocates
// nothing, does not synchronise, returns the CUDA error of the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kGroups = 4;                  // lanes sharing one state column
constexpr int kSteps = 16;                  // time steps staged at a time
constexpr int kMaxDim = 128;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// NR: state rows per lane (dk <= kGroups * NR); rows past dk are zero
// padding, so they add nothing to y and stay zero in the state.  kCols:
// state columns per block.
template <typename T, int NR, int kCols>
__global__ void __launch_bounds__(kGroups * kCols)
wkv6_kernel(const T* __restrict__ r, const T* __restrict__ k,
            const T* __restrict__ v, const float* __restrict__ w,
            const float* __restrict__ u, const float* s0,
            float* __restrict__ y, float* sT, int Tn, int H, int dk, int dv) {
  constexpr int kThreads = kGroups * kCols;
  constexpr int DKP = kGroups * NR;                  // padded rows
  constexpr int kRowLoads = kSteps * DKP / kThreads;  // per lane per chunk
  constexpr int kColLoads = kSteps * kCols / kThreads;
  static_assert(kSteps * DKP % kThreads == 0 && NR % 2 == 0, "tiling");
  __shared__ float4 rows[kSteps][DKP];               // {r, k, w, u}
  __shared__ float vs[kSteps][kCols];
  __shared__ float us[DKP];

  const int tile = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x;
  const int g = tid % kGroups;
  const int jl = tid / kGroups;
  const int j = tile * kCols + jl;
  const bool col_ok = j < dv;
  const long long bh = static_cast<long long>(b) * H + h;
  const long long rk_step = static_cast<long long>(H) * dk;  // r/k/w stride
  const long long v_step = static_cast<long long>(H) * dv;
  const long long rk_base = static_cast<long long>(b) * Tn * rk_step
                            + static_cast<long long>(h) * dk;
  const long long v_base = static_cast<long long>(b) * Tn * v_step
                           + static_cast<long long>(h) * dv;

  for (int i = tid; i < DKP; i += kThreads) {
    us[i] = i < dk ? u[h * dk + i] : 0.f;
  }
  float s[NR];                       // column j, rows g, g + kGroups, ...
  const float* s0p = s0 + bh * dk * dv;
#pragma unroll
  for (int m = 0; m < NR; ++m) {
    const int i = g + kGroups * m;
    s[m] = (col_ok && i < dk) ? s0p[static_cast<long long>(i) * dv + j] : 0.f;
  }

  // the next chunk's r, k, w, v, fetched into registers as they are stored
  // (widened only when staged, so the loads stay in flight meanwhile)
  T rb[kRowLoads], kb[kRowLoads], vb[kColLoads];
  float wb[kRowLoads];
  auto fetch = [&](int t0) {
    const int tc = min(kSteps, Tn - t0);
#pragma unroll
    for (int q = 0; q < kRowLoads; ++q) {
      const int idx = tid + q * kThreads;
      const int tt = idx / DKP, i = idx - tt * DKP;
      const bool ok = tt < tc && i < dk;
      const long long off = rk_base + (t0 + tt) * rk_step + i;
      rb[q] = ok ? r[off] : T();
      kb[q] = ok ? k[off] : T();
      wb[q] = ok ? w[off] : 0.f;
    }
#pragma unroll
    for (int q = 0; q < kColLoads; ++q) {
      const int idx = tid + q * kThreads;
      const int tt = idx / kCols, c = idx - tt * kCols;
      const int jj = tile * kCols + c;
      vb[q] = (tt < tc && jj < dv) ? v[v_base + (t0 + tt) * v_step + jj]
                                   : T();
    }
  };

  if (Tn > 0) fetch(0);
  for (int t0 = 0; t0 < Tn; t0 += kSteps) {
    const int tc = min(kSteps, Tn - t0);
    __syncthreads();                       // the previous chunk is consumed
#pragma unroll
    for (int q = 0; q < kRowLoads; ++q) {
      const int idx = tid + q * kThreads;
      const int i = idx % DKP;
      rows[idx / DKP][i] = make_float4(to_f(rb[q]), to_f(kb[q]), wb[q],
                                       us[i]);
    }
#pragma unroll
    for (int q = 0; q < kColLoads; ++q) {
      const int idx = tid + q * kThreads;
      vs[idx / kCols][idx % kCols] = to_f(vb[q]);
    }
    __syncthreads();
    if (t0 + kSteps < Tn) fetch(t0 + kSteps);   // in flight during the steps

    for (int tt = 0; tt < tc; ++tt) {
      const float vj = vs[tt][jl];
      float y0 = 0.f, y1 = 0.f;       // two chains: even and odd m
#pragma unroll
      for (int m = 0; m < NR; m += 2) {
        const float4 p0 = rows[tt][g + kGroups * m];
        const float kv0 = p0.y * vj;
        y0 = fmaf(p0.x, fmaf(p0.w, kv0, s[m]), y0);
        s[m] = fmaf(p0.z, s[m], kv0);
        const float4 p1 = rows[tt][g + kGroups * (m + 1)];
        const float kv1 = p1.y * vj;
        y1 = fmaf(p1.x, fmaf(p1.w, kv1, s[m + 1]), y1);
        s[m + 1] = fmaf(p1.z, s[m + 1], kv1);
      }
      float yv = y0 + y1;
#pragma unroll
      for (int o = 1; o < kGroups; o <<= 1) {
        yv += __shfl_xor_sync(0xffffffffu, yv, o);
      }
      if (g == 0 && col_ok) y[v_base + (t0 + tt) * v_step + j] = yv;
    }
  }

  float* sTp = sT + bh * dk * dv;
#pragma unroll
  for (int m = 0; m < NR; ++m) {
    const int i = g + kGroups * m;
    if (col_ok && i < dk) sTp[static_cast<long long>(i) * dv + j] = s[m];
  }
}

// The 16-column tile stops at dk = 64: past it, its lanes' staged rows
// (twice a 32-column lane's) spill.
constexpr int kNarrowMaxDk = 64;

// Launches the instance with the fewest rows per lane that covers dk.
template <typename T, int NR, int kCols>
int launch(const void* r, const void* k, const void* v, const float* w,
           const float* u, const float* s0, float* y, float* sT, int B,
           int Tn, int H, int dk, int dv, cudaStream_t st) {
  constexpr int kTop = kCols == 16 ? kNarrowMaxDk : kMaxDim;
  if constexpr (kGroups * NR < kTop) {
    if (dk > kGroups * NR) {
      return launch<T, 2 * NR, kCols>(r, k, v, w, u, s0, y, sT, B, Tn, H,
                                      dk, dv, st);
    }
  }
  const dim3 grid((dv + kCols - 1) / kCols, H, B);
  wkv6_kernel<T, NR, kCols><<<grid, kGroups * kCols, 0, st>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), w, u, s0, y, sT, Tn, H, dk, dv);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// r, k (B, T, H, dk) and v (B, T, H, dv), all fp32 or all bf16 (rkv_bf16);
// w (B, T, H, dk), u (H, dk), s0 (B, H, dk, dv) fp32; y (B, T, H, dv) and
// sT (B, H, dk, dv) fp32 out (sT may be s0); all contiguous.
extern "C" int repro_wkv6(const void* r, const void* k, const void* v,
                          const float* w, const float* u, const float* s0,
                          float* y, float* sT, int rkv_bf16, int B, int Tn,
                          int H, int dk, int dv, void* stream) {
  if (dk < 1 || dk > kMaxDim || dv < 1 || dv > kMaxDim || Tn < 0 ||
      B > 65535 || H > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (B == 0 || H == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const bool narrow = dk <= kNarrowMaxDk &&
                      static_cast<long long>((dv + 31) / 32) * H * B < sms;
  if (rkv_bf16) {
    return narrow ? launch<__nv_bfloat16, 2, 16>(r, k, v, w, u, s0, y, sT, B,
                                                 Tn, H, dk, dv, st)
                  : launch<__nv_bfloat16, 2, 32>(r, k, v, w, u, s0, y, sT, B,
                                                 Tn, H, dk, dv, st);
  }
  return narrow ? launch<float, 2, 16>(r, k, v, w, u, s0, y, sT, B, Tn, H, dk,
                                       dv, st)
                : launch<float, 2, 32>(r, k, v, w, u, s0, y, sT, B, Tn, H, dk,
                                       dv, st);
}
