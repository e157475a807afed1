// Hopper kernels of the RG-LRU linear recurrence (Griffin / RecurrentGemma):
// h_t = a_t * h_{t-1} + b_t, elementwise over the LRU width, from a carry h0.
//
// They replace the JAX package's Pallas kernel kernels/rglru_scan.py
// (rglru_scan / _rglru_kernel), which tiles the width into lane blocks and
// runs each time chunk as a log-depth prefix combine in VMEM.  Two routes
// here, picked by the wrapper from the shape (kernels/rglru_scan.py
// rglru_route):
//
// "sequential" (repro_rglru_scan_f32: decode, short T): every (batch,
// channel) pair is one thread with a loop over T.  Neighbouring threads own
// neighbouring channels, so each step's loads and stores are coalesced
// along the width, and the state stays in a register; each thread fetches
// kUnroll steps of a and b before it folds them in.  Every multiply and add
// is rounded on its own (__fmul_rn, __fadd_rn), so it equals its plain
// PyTorch version (a multiply then an add per step) bit for bit.  Its grid
// is B * W threads: 2,560 in a RecurrentGemma-2B prefill, 20 blocks on 132
// SMs, each walking all T dependent steps, so the loop's latency bounds a
// prefill; a decode step (T = 1) is bound by launch latency.
//
// "chunked" (repro_rglru_scan_chunked_f32: prefill) cuts T into chunks of L
// steps and gives each (batch, chunk, channel) a thread, so a prefill of
// 1,374 steps over 2,560 channels is 110,080 threads at L = 32, coalesced
// along the width as above, in two launches:
//   1. rglru_chunk_summary_kernel: each chunk's product of a and its h from
//      0 (the recurrence is associative; every factor lies in (0, 1));
//   2. rglru_chunk_out_kernel: each chunk folds the summaries of the chunks
//      before it, in order, into its incoming carry (at most T / L short
//      steps), then recomputes its h from that carry and writes it; the
//      last chunk writes hT.
// Every operation is rounded on its own, so it equals the plain version of
// the same algorithm (linear_recurrence_chunked_plain) bit for bit; against
// the sequential order it is held to the reference's tolerance for its own
// log-depth scan (atol 1e-5, rtol 1e-4), not bit for bit.  What bounds it
// on the H100: bytes, 12 a step for each channel (a and b read, h written);
// a and b are read twice, the second time mostly from the 50 MB L2.
//
// "gated" (repro_rglru_gated: a decode step, T < CHUNKED_MIN_T) fuses the
// RG-LRU layer's gate chain (models/blocks.py rglru_apply, from the two
// block-diagonal products before their biases to b_t) into the sequential
// recurrence: rg = sigmoid(rg_pre + rg_b), ig = sigmoid(ig_pre + ig_b),
// log_a = (-C * softplus(lam)) * rg, a = exp(log_a), b = sqrt(max(1 -
// exp(2 log_a), 1e-12)) * (ig * xc), then h = a * h + b.  It replaces no
// TPU kernel of its own: the JAX package computes the chain with XLA's
// elementwise operations before its rglru_scan.  A thread per (batch,
// channel), as the sequential route, with the channel's softplus and
// biases in registers.  Each value is rounded to the type the chain gives
// it (bf16 after the bias adds, the sigmoids, -C * softplus and ig * xc
// when the weights are bf16; fp32 elsewhere), and every operation uses the
// single-precision function PyTorch's CUDA operator uses (expf, log1pf,
// IEEE division and square root, separately rounded multiplies and adds),
// so it equals the chain run operator by operator on the card wherever
// those agree.  What bounds it on the H100: at decode (4 x 2,560 channels,
// 80 blocks) the launch's latency; it exists to take the chain's 18 host
// operators a layer out of a step that the host bounds.  hT may be written
// over h0 (a serving slot's state): a thread reads its h0 before it writes.
//
// Plain C interface for ctypes: launches on the given stream, allocates
// nothing (the chunked route's scratch comes from the caller), does not
// synchronise, returns the CUDA error of the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kUnroll = 8;

__global__ void __launch_bounds__(kThreads)
rglru_scan_kernel(const float* __restrict__ a, const float* __restrict__ b,
                  const float* __restrict__ h0, float* __restrict__ h,
                  float* __restrict__ hT, int B, int T, int W) {
  const long long idx = static_cast<long long>(blockIdx.x) * blockDim.x
                        + threadIdx.x;
  if (idx >= static_cast<long long>(B) * W) return;
  const long long bi = idx / W;
  const long long w = idx - bi * W;
  const long long base = bi * T * W + w;
  const float* ap = a + base;
  const float* bp = b + base;
  float* hp = h + base;
  float hv = h0[idx];
  int t = 0;
  for (; t + kUnroll <= T; t += kUnroll) {
    float av[kUnroll], bv[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long off = static_cast<long long>(t + u) * W;
      av[u] = ap[off];
      bv[u] = bp[off];
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      hv = __fadd_rn(__fmul_rn(av[u], hv), bv[u]);
      hp[static_cast<long long>(t + u) * W] = hv;
    }
  }
  for (; t < T; ++t) {
    const long long off = static_cast<long long>(t) * W;
    hv = __fadd_rn(__fmul_rn(ap[off], hv), bp[off]);
    hp[off] = hv;
  }
  hT[idx] = hv;
}


// the chunked route: a thread per (channel, chunk, batch)
constexpr int kChunkThreads = 128;

// 1. The summary of one chunk of a channel: prod a and h from 0, each into
// a (B, nc, W) array.
__global__ void __launch_bounds__(kChunkThreads)
rglru_chunk_summary_kernel(const float* __restrict__ a,
                           const float* __restrict__ b,
                           float* __restrict__ prod, float* __restrict__ hend,
                           int T, int W, int L) {
  const int w = blockIdx.x * kChunkThreads + threadIdx.x;
  if (w >= W) return;
  const int c = blockIdx.y, bi = blockIdx.z, nc = gridDim.y;
  const int t0 = c * L, n = min(L, T - t0);
  const long long base = (static_cast<long long>(bi) * T + t0) * W + w;
  const float* ap = a + base;
  const float* bp = b + base;
  float p = 1.f, hv = 0.f;
  int t = 0;
  for (; t + kUnroll <= n; t += kUnroll) {
    float av[kUnroll], bv[kUnroll];
#pragma unroll
    for (int q = 0; q < kUnroll; ++q) {
      const long long off = static_cast<long long>(t + q) * W;
      av[q] = ap[off];
      bv[q] = bp[off];
    }
#pragma unroll
    for (int q = 0; q < kUnroll; ++q) {
      hv = __fadd_rn(__fmul_rn(av[q], hv), bv[q]);
      p = __fmul_rn(p, av[q]);
    }
  }
  for (; t < n; ++t) {
    const long long off = static_cast<long long>(t) * W;
    const float av = ap[off];
    hv = __fadd_rn(__fmul_rn(av, hv), bp[off]);
    p = __fmul_rn(p, av);
  }
  const long long o = (static_cast<long long>(bi) * nc + c) * W + w;
  prod[o] = p;
  hend[o] = hv;
}

// 2. One chunk of a channel: the carry folded from h0 over the summaries of
// the chunks before it, then h from it; the last chunk writes hT.
__global__ void __launch_bounds__(kChunkThreads)
rglru_chunk_out_kernel(const float* __restrict__ a,
                       const float* __restrict__ b,
                       const float* __restrict__ h0,
                       const float* __restrict__ prod,
                       const float* __restrict__ hend, float* __restrict__ h,
                       float* __restrict__ hT, int T, int W, int L) {
  const int w = blockIdx.x * kChunkThreads + threadIdx.x;
  if (w >= W) return;
  const int c = blockIdx.y, bi = blockIdx.z, nc = gridDim.y;
  float hv = h0[static_cast<long long>(bi) * W + w];
  const long long so = static_cast<long long>(bi) * nc * W + w;
  int m = 0;
  for (; m + kUnroll <= c; m += kUnroll) {
    float pv[kUnroll], ev[kUnroll];
#pragma unroll
    for (int q = 0; q < kUnroll; ++q) {
      pv[q] = prod[so + static_cast<long long>(m + q) * W];
      ev[q] = hend[so + static_cast<long long>(m + q) * W];
    }
#pragma unroll
    for (int q = 0; q < kUnroll; ++q) {
      hv = __fadd_rn(__fmul_rn(pv[q], hv), ev[q]);
    }
  }
  for (; m < c; ++m) {
    const long long off = so + static_cast<long long>(m) * W;
    hv = __fadd_rn(__fmul_rn(prod[off], hv), hend[off]);
  }
  const int t0 = c * L, n = min(L, T - t0);
  const long long base = (static_cast<long long>(bi) * T + t0) * W + w;
  const float* ap = a + base;
  const float* bp = b + base;
  float* hp = h + base;
  int t = 0;
  for (; t + kUnroll <= n; t += kUnroll) {
    float av[kUnroll], bv[kUnroll];
#pragma unroll
    for (int q = 0; q < kUnroll; ++q) {
      const long long off = static_cast<long long>(t + q) * W;
      av[q] = ap[off];
      bv[q] = bp[off];
    }
#pragma unroll
    for (int q = 0; q < kUnroll; ++q) {
      hv = __fadd_rn(__fmul_rn(av[q], hv), bv[q]);
      hp[static_cast<long long>(t + q) * W] = hv;
    }
  }
  for (; t < n; ++t) {
    const long long off = static_cast<long long>(t) * W;
    hv = __fadd_rn(__fmul_rn(ap[off], hv), bp[off]);
    hp[off] = hv;
  }
  if (c == nc - 1) hT[static_cast<long long>(bi) * W + w] = hv;
}

// the gated route: one type for xc, the gate products, the biases and lam
constexpr float kLruC = 8.0f;                           // the decay scale C
constexpr float kBetaFloor = static_cast<float>(1e-12);  // clamp(min=1e-12)

template <typename T>
__device__ __forceinline__ float load_f(const T* p);
template <>
__device__ __forceinline__ float load_f<float>(const float* p) { return *p; }
template <>
__device__ __forceinline__ float load_f<__nv_bfloat16>(
    const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

// x rounded to T, as a PyTorch operator with T outputs rounds its fp32
// result
template <typename T>
__device__ __forceinline__ float round_to(float x);
template <>
__device__ __forceinline__ float round_to<float>(float x) { return x; }
template <>
__device__ __forceinline__ float round_to<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// torch.sigmoid: 1 / (1 + exp(-x)) in fp32
__device__ __forceinline__ float sigmoid_f(float x) {
  return __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-x)));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
rglru_gated_kernel(const T* __restrict__ xc, const T* __restrict__ rg_pre,
                   const T* __restrict__ ig_pre, const T* __restrict__ rg_b,
                   const T* __restrict__ ig_b, const T* __restrict__ lam,
                   const float* h0, float* __restrict__ h, float* hT, int B,
                   int T_, int W) {
  const long long idx = static_cast<long long>(blockIdx.x) * blockDim.x
                        + threadIdx.x;
  if (idx >= static_cast<long long>(B) * W) return;
  const long long bi = idx / W;
  const long long w = idx - bi * W;
  // -C * softplus(lam): torch.logaddexp(lam, 0) is max(lam, 0) +
  // log1p(exp(-|lam - 0|)) in fp32, then a multiply by -C, each rounded to T
  const float l = load_f(lam + w);
  const float sp = round_to<T>(
      __fadd_rn(fmaxf(l, 0.0f), log1pf(expf(-fabsf(l)))));
  const float c = round_to<T>(__fmul_rn(-kLruC, sp));
  const float rb = load_f(rg_b + w);
  const float ib = load_f(ig_b + w);
  float hv = h0[idx];
  for (int t = 0; t < T_; ++t) {
    const long long off = (bi * T_ + t) * W + w;
    const float rg = round_to<T>(sigmoid_f(round_to<T>(
        __fadd_rn(load_f(rg_pre + off), rb))));
    const float ig = round_to<T>(sigmoid_f(round_to<T>(
        __fadd_rn(load_f(ig_pre + off), ib))));
    const float log_a = __fmul_rn(c, rg);
    const float a = expf(log_a);
    const float gx = round_to<T>(__fmul_rn(ig, load_f(xc + off)));
    float u = __fsub_rn(1.0f, expf(__fmul_rn(2.0f, log_a)));
    u = u < kBetaFloor ? kBetaFloor : u;            // a NaN stays NaN
    const float bt = __fmul_rn(__fsqrt_rn(u), gx);
    hv = __fadd_rn(__fmul_rn(a, hv), bt);
    h[off] = hv;
  }
  hT[idx] = hv;
}

}  // namespace

// a, b (B, T, W) fp32; h0 (B, W) fp32; h (B, T, W) and hT (B, W) fp32 out,
// all contiguous.
extern "C" int repro_rglru_scan_f32(const float* a, const float* b,
                                    const float* h0, float* h, float* hT,
                                    int B, int T, int W, void* stream) {
  const long long n = static_cast<long long>(B) * W;
  if (n == 0) return 0;
  const unsigned blocks = static_cast<unsigned>((n + kThreads - 1) / kThreads);
  rglru_scan_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      a, b, h0, h, hT, B, T, W);
  return static_cast<int>(cudaGetLastError());
}

// The chunked route: as repro_rglru_scan_f32, in chunks of L steps, with
// scratch from the caller: summary (2, B, max(1, ceil(T / L)), W) fp32.
extern "C" int repro_rglru_scan_chunked_f32(const float* a, const float* b,
                                            const float* h0, float* h,
                                            float* hT, float* summary, int B,
                                            int T, int W, int L,
                                            void* stream) {
  if (B < 0 || T < 0 || W < 0 || L < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (B == 0 || W == 0) return 0;
  const int nc = T > 0 ? (T + L - 1) / L : 1;
  if (nc > 65535 || B > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((W + kChunkThreads - 1) / kChunkThreads, nc, B);
  float* prod = summary;
  float* hend = summary + static_cast<long long>(B) * nc * W;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  rglru_chunk_summary_kernel<<<grid, kChunkThreads, 0, st>>>(a, b, prod, hend,
                                                             T, W, L);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  rglru_chunk_out_kernel<<<grid, kChunkThreads, 0, st>>>(a, b, h0, prod, hend,
                                                         h, hT, T, W, L);
  return static_cast<int>(cudaGetLastError());
}

// The gated route: xc, rg_pre, ig_pre (B, T, W) and rg_b, ig_b, lam (W,) of
// one type (bf16 when bf16 != 0, else fp32); h0 (B, W) fp32; h (B, T, W) and
// hT (B, W) fp32 out (hT may be h0), all contiguous.
extern "C" int repro_rglru_gated(const void* xc, const void* rg_pre,
                                 const void* ig_pre, const void* rg_b,
                                 const void* ig_b, const void* lam,
                                 const float* h0, float* h, float* hT, int B,
                                 int T, int W, int bf16, void* stream) {
  if (B < 0 || T < 0 || W < 0) return static_cast<int>(cudaErrorInvalidValue);
  const long long n = static_cast<long long>(B) * W;
  if (n == 0) return 0;
  const unsigned blocks = static_cast<unsigned>((n + kThreads - 1) / kThreads);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16) {
    using T16 = __nv_bfloat16;
    rglru_gated_kernel<T16><<<blocks, kThreads, 0, st>>>(
        static_cast<const T16*>(xc), static_cast<const T16*>(rg_pre),
        static_cast<const T16*>(ig_pre), static_cast<const T16*>(rg_b),
        static_cast<const T16*>(ig_b), static_cast<const T16*>(lam), h0, h,
        hT, B, T, W);
  } else {
    rglru_gated_kernel<float><<<blocks, kThreads, 0, st>>>(
        static_cast<const float*>(xc), static_cast<const float*>(rg_pre),
        static_cast<const float*>(ig_pre), static_cast<const float*>(rg_b),
        static_cast<const float*>(ig_b), static_cast<const float*>(lam), h0,
        h, hT, B, T, W);
  }
  return static_cast<int>(cudaGetLastError());
}
