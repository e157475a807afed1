// Hopper kernel of the RG-LRU linear recurrence (Griffin / RecurrentGemma):
// h_t = a_t * h_{t-1} + b_t, elementwise over the LRU width, from a carry h0.
//
// It replaces the JAX package's Pallas kernel kernels/rglru_scan.py
// (rglru_scan / _rglru_kernel).  The TPU kernel tiles the width into lane
// blocks and runs each time chunk as a log-depth prefix combine in VMEM.
// Here every (batch, channel) pair is one thread with a sequential loop over
// T: neighbouring threads own neighbouring channels, so each step's loads
// and stores are coalesced along the width, and the state stays in a
// register.  To keep loads in flight despite the serial dependency, each
// thread fetches kUnroll steps of a and b before it folds them in.
//
// Every multiply and add is rounded on its own (__fmul_rn, __fadd_rn), so
// the kernel equals its plain PyTorch version (a multiply then an add per
// step) bit for bit.  The TPU kernel's log-depth scan and the reference's
// associative scan round differently; the tests state that tolerance.
//
// What bounds it on the H100: 12 bytes a step for each channel (a and b
// read, h written) against 2 flops, so bytes; with B * W threads (2,560 in a
// RecurrentGemma-2B prefill) the card is far from full, and the latency of
// the serial loop, not the bandwidth, is what limits a single call.
//
// Plain C interface for ctypes: launches on the given stream, allocates
// nothing, does not synchronise, returns the CUDA error of the launch.

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
