// Hopper kernels of the §4.6 OPT=MIN water-filling (batched, float64).
//
// Both kernels are held bit for bit to the host numpy kernels
// (repro_torch.core.alloc_kernels.maxmin_yields_csr) and to their plain
// PyTorch versions (repro_torch/kernels/alloc_matvec.py and
// maxmin_round.py).  Build with --fmad=false: nvcc contracts a multiply
// feeding an add into one FMA by default, which rounds once where numpy
// rounds twice and is 1 ulp off on a large share of operand triples.  The
// explicit __dmul_rn / __dadd_rn / __dsub_rn / __ddiv_rn intrinsics pin
// every operation to IEEE round-to-nearest on top of that.
//
// Plain C interface for ctypes: every entry point launches on the stream
// it is given, allocates nothing, does not synchronise, and returns
// cudaGetLastError().

#include <cuda_runtime.h>

namespace {

constexpr double kNeedEps = 1e-12;  // a node counts if its unfrozen need > this
constexpr double kTieTol = 1e-15;   // bottleneck-scan tolerance
constexpr double kCapTol = 1e-12;   // a level this close to 1 caps everyone

constexpr int kMatvecThreads = 128;
constexpr int kRoundThreads = 128;

// A. alloc_matvec — replaces the Pallas kernel kernels/alloc_matvec.py
// (alloc_matvec / _mv_kernel) of the JAX package.
//
// out[b, n] = sum_j w[b, n, j] * x[b, j], every product rounded, the adds
// strictly left to right over ascending j.  One thread per (lane, node)
// row.  Bound by bytes: the weights are read once and each element feeds
// one multiply and one add, far below the FP64 rate; neighbouring threads
// read rows W doubles apart, and each 128-byte line they touch serves 16
// consecutive j from L1.
__global__ void alloc_matvec_kernel(const double* __restrict__ w,
                                    const double* __restrict__ x,
                                    double* __restrict__ out,
                                    long long rows, int N, int W) {
  const long long row = static_cast<long long>(blockIdx.x) * blockDim.x
                        + threadIdx.x;
  if (row >= rows) return;
  const double* wr = w + row * W;
  const double* xb = x + (row / N) * W;
  double acc = 0.0;
  for (int j = 0; j < W; ++j) {
    acc = __dadd_rn(acc, __dmul_rn(wr[j], xb[j]));
  }
  out[row] = acc;
}

// The water level of one node: max(0, 1 - f) / u, as the numpy kernel
// computes it.
__device__ __forceinline__ double node_level(double f, double u) {
  double room = __dsub_rn(1.0, f);
  room = room > 0.0 ? room : 0.0;
  return __ddiv_rn(room, u);
}

// B. maxmin_round — one freeze round of the lockstep water-filling; it
// replaces the vmapped bottleneck scan and the masked freeze update of the
// JAX package's core/alloc_jax.py (_build_maxmin, body and scan_single).
//
// One block per lane.  Thread 0 scans the nodes in ascending order for the
// tolerance-updated running minimum (the order matters when two levels sit
// within 1e-15, so it cannot be a parallel argmin).  The scan keeps only
// the minimum and the node where it last dropped: the binding set is that
// node plus every later valid node within 1e-15 of the final minimum,
// which the block then marks in parallel.  The block finishes the round
// over its W columns: a column freezes when any binding node holds it (or
// when the level caps at 1), a round that froze nothing freezes every open
// column, and open columns take the level.  Lanes with live == 0 copy
// their inputs.  Bound by bytes (the presence mask dominates); the scan is
// a serial chain of N dependent FP64 operations on one thread.
__global__ void maxmin_round_kernel(const double* __restrict__ f_use,
                                    const double* __restrict__ u_need,
                                    const unsigned char* __restrict__ present,
                                    const unsigned char* __restrict__ frozen,
                                    const double* __restrict__ y,
                                    const unsigned char* __restrict__ live,
                                    double* __restrict__ y_out,
                                    unsigned char* __restrict__ frozen_out,
                                    int N, int W) {
  extern __shared__ int binding[];   // node ids, N slots
  __shared__ double s_best;
  __shared__ int s_last_drop;
  __shared__ int s_n_binding;

  const long long b = blockIdx.x;
  const double* f = f_use + b * N;
  const double* u = u_need + b * N;
  const unsigned char* pr = present + b * N * W;
  const unsigned char* fz = frozen + b * W;
  const double* yb = y + b * W;
  double* yo = y_out + b * W;
  unsigned char* fo = frozen_out + b * W;

  if (!live[b]) {                    // uniform over the block
    for (int j = threadIdx.x; j < W; j += blockDim.x) {
      yo[j] = yb[j];
      fo[j] = fz[j];
    }
    return;
  }

  if (threadIdx.x == 0) {
    double best = 1.0;
    int last_drop = N;
    for (int n = 0; n < N; ++n) {
      const double un = u[n];
      if (!(un > kNeedEps)) continue;
      const double lvl = node_level(f[n], un);
      if (lvl < __dsub_rn(best, kTieTol)) {
        best = lvl;
        last_drop = n;
      }
    }
    s_best = best;
    s_last_drop = last_drop;
    s_n_binding = 0;
  }
  __syncthreads();

  const double best_raw = s_best;
  const bool cap = best_raw >= __dsub_rn(1.0, kCapTol);
  const double level = cap ? 1.0 : best_raw;

  if (!cap) {
    // !cap implies the scan dropped at least once, so last_drop < N
    for (int n = s_last_drop + threadIdx.x; n < N; n += blockDim.x) {
      const double un = u[n];
      if (!(un > kNeedEps)) continue;
      const double lvl = node_level(f[n], un);
      if (fabs(__dsub_rn(lvl, best_raw)) <= kTieTol) {
        binding[atomicAdd(&s_n_binding, 1)] = n;
      }
    }
  }
  __syncthreads();
  const int n_binding = s_n_binding;

  // pass 1: newly frozen columns (stashed in frozen_out by the thread that
  // owns the column; pass 2 uses the same column-to-thread assignment)
  int any_newly = 0;
  for (int j = threadIdx.x; j < W; j += blockDim.x) {
    const bool open = !fz[j];
    bool newly;
    if (cap) {
      newly = open;
    } else {
      bool on_binding = false;
      for (int k = 0; k < n_binding && !on_binding; ++k) {
        on_binding = pr[static_cast<long long>(binding[k]) * W + j] != 0;
      }
      newly = on_binding && open;
    }
    fo[j] = newly;
    any_newly |= newly;
  }
  any_newly = __syncthreads_or(any_newly);

  // pass 2: the freeze update (a round that froze nothing freezes all)
  for (int j = threadIdx.x; j < W; j += blockDim.x) {
    const bool was_frozen = fz[j] != 0;
    const bool newly = any_newly ? (fo[j] != 0) : !was_frozen;
    yo[j] = was_frozen ? yb[j] : level;
    fo[j] = was_frozen || newly;
  }
}

}  // namespace

extern "C" {

int repro_alloc_matvec_f64(const double* w, const double* x, double* out,
                           int B, int N, int W, void* stream) {
  const long long rows = static_cast<long long>(B) * N;
  if (rows > 0) {
    const long long blocks = (rows + kMatvecThreads - 1) / kMatvecThreads;
    alloc_matvec_kernel<<<static_cast<unsigned int>(blocks), kMatvecThreads,
                          0, static_cast<cudaStream_t>(stream)>>>(
        w, x, out, rows, N, W);
  }
  return static_cast<int>(cudaGetLastError());
}

int repro_maxmin_round_f64(const double* f_use, const double* u_need,
                           const unsigned char* present,
                           const unsigned char* frozen, const double* y,
                           const unsigned char* live, double* y_out,
                           unsigned char* frozen_out, int B, int N, int W,
                           void* stream) {
  if (B > 0) {
    const size_t smem = static_cast<size_t>(N > 0 ? N : 1) * sizeof(int);
    maxmin_round_kernel<<<B, kRoundThreads, smem,
                          static_cast<cudaStream_t>(stream)>>>(
        f_use, u_need, present, frozen, y, live, y_out, frozen_out, N, W);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
