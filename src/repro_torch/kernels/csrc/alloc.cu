// Hopper kernels of the §4.6 OPT=MIN water-filling (batched, float64), and
// of the §4.7 stretch passes' per-node usage scatter.
//
// Both kernels are held bit for bit to the host numpy kernels
// (repro_torch.core.alloc_kernels.maxmin_yields_csr) and to their plain
// PyTorch versions (repro_torch/kernels/alloc_matvec.py and
// maxmin_solve.py).  Build with --fmad=false: nvcc contracts a multiply
// feeding an add into one FMA by default, which rounds once where numpy
// rounds twice and is 1 ulp off on a large share of operand triples.  The
// explicit __dmul_rn / __dadd_rn / __dsub_rn / __ddiv_rn intrinsics pin
// every operation to IEEE round-to-nearest on top of that.
//
// Plain C interface for ctypes: every entry point launches on the stream
// it is given, allocates nothing, does not synchronise, and returns
// cudaGetLastError() (or the error of a refused shared-memory request).

#include <cuda_runtime.h>
#include <math_constants.h>

#include <cstdint>

namespace {

constexpr double kNeedEps = 1e-12;  // a node counts if its unfrozen need > this
constexpr double kTieTol = 1e-15;   // bottleneck-scan tolerance
constexpr double kCapTol = 1e-12;   // a level this close to 1 caps everyone

constexpr int kMatvecRows = 16;     // rows of one lane a matvec block takes
constexpr int kMatvecThreads = 64;  // threads that stage them
constexpr int kMatvecCols = 64;     // columns staged at a time
constexpr int kSolveMaxThreads = 256;

// The chains of one row: acc[k] = sum over j < W of row[j] * x[k * x_stride
// + j], each product rounded, the adds strictly left to right over
// ascending j, continuing from acc (which the caller starts at 0.0).  Both
// kernels run every row through here; row and x lie in shared memory, or
// row in global memory.  The products of eight columns are formed (their
// loads issued together) before their eight adds, so a step waits on an
// add's latency rather than on a load's.
template <int K>
__device__ __forceinline__ void row_chains(const double* row,
                                           const double* x, int x_stride,
                                           int W, double (&acc)[K]) {
  constexpr int kBlock = 8;
  int j = 0;
  for (; j + kBlock <= W; j += kBlock) {
    double t[kBlock][K];
#pragma unroll
    for (int u = 0; u < kBlock; ++u) {
      const double w = row[j + u];
#pragma unroll
      for (int k = 0; k < K; ++k) {
        t[u][k] = __dmul_rn(w, x[k * x_stride + j + u]);
      }
    }
#pragma unroll
    for (int u = 0; u < kBlock; ++u) {
#pragma unroll
      for (int k = 0; k < K; ++k) acc[k] = __dadd_rn(acc[k], t[u][k]);
    }
  }
  for (; j < W; ++j) {
    const double w = row[j];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      acc[k] = __dadd_rn(acc[k], __dmul_rn(w, x[k * x_stride + j]));
    }
  }
}

// A row stride in doubles that is odd, so the 16 rows a half-warp reads
// at one column fall in 16 different 8-byte bank pairs.
__host__ __device__ __forceinline__ int padded_stride(int W) {
  return W | 1;
}

constexpr int kStageBatch = 8;      // loads a thread keeps in flight

// Copies rows x cols doubles, row r at src + r * src_stride, into shared
// memory at dst + r * dst_stride (rows * cols < 2^31: a shared tile).
// Neighbouring threads take neighbouring addresses, 16 bytes each where
// `pairs` (cols and src_stride even, src 16-byte aligned), and a thread
// issues kStageBatch loads before it stores any, so the copy waits on
// about one memory latency a batch.
__device__ __forceinline__ void stage_rows(const double* __restrict__ src,
                                           long long src_stride, int rows,
                                           int cols, double* dst,
                                           int dst_stride, bool pairs) {
  const int per_row = pairs ? cols / 2 : cols;
  const int n = rows * per_row;
  const int step = blockDim.x;
  for (int base = threadIdx.x; base < n; base += kStageBatch * step) {
    double2 v[kStageBatch];
    int to[kStageBatch];
#pragma unroll
    for (int u = 0; u < kStageBatch; ++u) {
      const int k = base + u * step;
      if (k < n) {
        const int r = k / per_row, c = k - r * per_row;
        const double* at = src + r * src_stride;
        if (pairs) {
          v[u] = __ldg(reinterpret_cast<const double2*>(at) + c);
          to[u] = r * dst_stride + 2 * c;
        } else {
          v[u].x = __ldg(at + c);
          to[u] = r * dst_stride + c;
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kStageBatch; ++u) {
      if (base + u * step < n) {
        dst[to[u]] = v[u].x;
        if (pairs) dst[to[u] + 1] = v[u].y;
      }
    }
  }
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// A. alloc_matvec — replaces the Pallas kernel kernels/alloc_matvec.py
// (alloc_matvec / _mv_kernel) of the JAX package.
//
// out[b, n] = sum_j w[b, n, j] * x[b, j].  Bound by bytes (the weights,
// read once; one multiply and one add an element, far below the FP64
// rate), and at the main path's shapes (16, 128, 32) by latency: the
// whole call is 260 KB.  One block takes one lane and a group of 16 rows,
// so (16, 128, 32) runs as 128 blocks on the 132 SMs.  The group's rows,
// 64 columns at a time, are one contiguous run (all of it when W <= 64):
// 64 threads stage it into shared memory with 16-byte loads, neighbouring
// threads on neighbouring addresses, all in flight together, and stage x
// beside it; then each of 16 threads runs its row's chain out of shared
// memory (odd row stride: no bank conflicts).  Target: at or below one
// torch.bmm of the same product in the same call.  On the H100 it stays
// about 1.1x above it (PERF.md): a row's 32 adds are one dependent chain,
// which bit-identity fixes, where bmm reduces a row as a tree.
__global__ void __launch_bounds__(kMatvecThreads)
alloc_matvec_kernel(const double* __restrict__ w,
                    const double* __restrict__ x,
                    double* __restrict__ out, int N, int W, int groups) {
  __shared__ double tile[kMatvecRows * (kMatvecCols | 1)];
  __shared__ double xs[kMatvecCols];
  constexpr int stride = kMatvecCols | 1;

  const long long b = blockIdx.x / groups;
  const int n0 = (blockIdx.x % groups) * kMatvecRows;
  const int rows = min(kMatvecRows, N - n0);
  const double* wb = w + (b * N + n0) * W;
  const double* xb = x + b * W;
  // chunks start at even columns, so a chunk keeps 16-byte alignment
  const bool pairs = W % 2 == 0 && aligned16(wb);

  double acc[1] = {0.0};
  for (int c0 = 0; c0 < W; c0 += kMatvecCols) {
    const int cw = min(kMatvecCols, W - c0);
    for (int k = threadIdx.x; k < cw; k += kMatvecThreads) {
      xs[k] = __ldg(xb + c0 + k);
    }
    // rows * cw / 2 <= 512 pairs: at most 8 a thread, 4 at W = 32, all
    // in one unrolled pass
    if (pairs) {
      const int half = cw / 2;
#pragma unroll 4
      for (int k = threadIdx.x; k < rows * half; k += kMatvecThreads) {
        const int r = k / half, c = 2 * (k - r * half);
        const double2 v = __ldg(reinterpret_cast<const double2*>(
            wb + static_cast<long long>(r) * W + c0 + c));
        tile[r * stride + c] = v.x;
        tile[r * stride + c + 1] = v.y;
      }
    } else {
#pragma unroll 4
      for (int k = threadIdx.x; k < rows * cw; k += kMatvecThreads) {
        const int r = k / cw, c = k - r * cw;
        tile[r * stride + c] = __ldg(wb + static_cast<long long>(r) * W
                                     + c0 + c);
      }
    }
    __syncthreads();
    if (threadIdx.x < rows) {
      row_chains<1>(tile + threadIdx.x * stride, xs, 0, cw, acc);
    }
    __syncthreads();
  }
  if (threadIdx.x < rows) out[b * N + n0 + threadIdx.x] = acc[0];
}

// The water level of one node: max(0, 1 - f) / u, as the numpy kernel
// computes it, or +inf where the node has no unfrozen need (u <= 1e-12).
// +inf never drops below a running minimum and never ties with one, and a
// valid level is finite (at most 1 / 1e-12), so it needs no mask.
__device__ __forceinline__ double node_level(double f, double u) {
  if (!(u > kNeedEps)) return CUDART_INF;
  double room = __dsub_rn(1.0, f);
  room = room > 0.0 ? room : 0.0;
  return __ddiv_rn(room, u);
}

// B. maxmin_solve — one lane's whole water-filling; it replaces the JAX
// package's lockstep program core/alloc_jax.py (_build_maxmin, the
// while_loop at :206-276: both matvecs, scan_single and the freeze update
// of body).
//
// One block per lane loops over freeze rounds until its lane is done: all
// columns frozen, or n_active + 1 rounds run.  This equals the lockstep
// loop, which steps every lane while any is live: a lane's done test is
// monotone (frozen only grows, the round count only rises), so a lane is
// live for a prefix of the global rounds and its own round count equals
// the global one while it is live; a round of the lockstep loop leaves a
// lane that is not live unchanged; and nothing a lane computes reads
// another lane.  Padded lanes (nothing active) exit at round 0.
//
// What bounds it: per round two chains of W dependent adds a row (the
// add order is the bit-identity contract), then an ordered scan of the
// nodes.  The retired design paid three launches and one host read a
// round and left 127 of 128 threads idle in the scan.  Here the lane stays
// in shared memory across rounds: the weight tile (route "shared", odd
// row stride) or, where it does not fit, the weights read from global
// memory each round (route "global"; L2 holds them after the first); the
// presence mask as bits; both x vectors, updated in place as columns
// freeze.  One thread owns a node row and runs its two chains together;
// every thread writes its node's level to shared memory.  Warp 0 then scans 32 levels at a
// time: a ballot of `level < best - 1e-15` finds the first node that
// drops, the minimum takes its level, and the ballot repeats over the
// lanes after it, so every decision is the serial scan's, in node order
// against the minimum of that moment.  The binding set (the last drop and
// every later node within 1e-15 of the final minimum) ORs its presence
// bits into a column mask, and the owners of the columns apply the
// freeze update.  A round is then bound by latency: the chains, one FP64
// divide a node, the scan's ballots and five barriers (~2 us at 128 x 32
// on the H100, PERF.md).
template <bool kTile>
__global__ void __launch_bounds__(kSolveMaxThreads)
maxmin_solve_kernel(const unsigned char* __restrict__ present,
                    const double* __restrict__ weight,
                    const unsigned char* __restrict__ active,
                    double* __restrict__ y_out, int* __restrict__ rounds_out,
                    int N, int W) {
  extern __shared__ double smem[];
  const int stride = padded_stride(W);
  const int words = (W + 31) / 32;
  double* tile = smem;                                   // N x stride
  double* xf = smem + (kTile ? static_cast<long long>(N) * stride : 0);
  double* xu = xf + W;             // xu[j] == 0.0 exactly when j is frozen
  double* levels = xu + W;                               // N
  unsigned* pbits = reinterpret_cast<unsigned*>(levels + N);  // N x words
  unsigned* bind = pbits + static_cast<long long>(N) * words;  // words
  __shared__ double s_best;
  __shared__ int s_last_drop;

  const long long b = blockIdx.x;
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5;
  const double* wb = weight + b * N * W;
  const unsigned char* pb = present + b * N * W;
  const unsigned char* ab = active + b * W;

  // ---- stage the lane once a dispatch -----------------------------------
  if (kTile) {
    stage_rows(wb, W, N, W, tile, stride, W % 2 == 0 && aligned16(wb));
  }
  // presence as bits, a 32-column word a thread, its 32 loads in flight
  for (int t = tid; t < N * words; t += nthreads) {
    const int j0 = (t % words) * 32;
    const unsigned char* src = pb + static_cast<long long>(t / words) * W
                               + j0;
    const int cnt = min(32, W - j0);
    unsigned bits = 0u;
#pragma unroll
    for (int jj = 0; jj < 32; ++jj) {
      if (jj < cnt && src[jj] != 0) bits |= 1u << jj;
    }
    pbits[t] = bits;
  }
  int n_active = 0;
  for (int j0 = 0; j0 < W; j0 += nthreads) {
    const int j = j0 + tid;
    const bool a = j < W && ab[j] != 0;
    if (j < W) {
      xf[j] = 0.0;
      xu[j] = a ? 1.0 : 0.0;
    }
    n_active += __syncthreads_count(a);
  }

  // ---- freeze rounds ------------------------------------------------------
  int i = 0;
  double level = 0.0;              // the level open columns hold (y starts 0)
  while (true) {
    int all_frozen = 1;
    for (int j = tid; j < W; j += nthreads) all_frozen &= xu[j] == 0.0;
    all_frozen = __syncthreads_and(all_frozen);
    if (all_frozen || i >= n_active + 1) break;          // uniform

    for (int k = tid; k < words; k += nthreads) bind[k] = 0u;
    // both matvecs in one pass: f_use with x = frozen ? y : 0, u_need
    // with x = frozen ? 0 : 1 (xf and xu side by side)
    for (int n = tid; n < N; n += nthreads) {
      double acc[2] = {0.0, 0.0};
      const double* row = kTile ? tile + static_cast<long long>(n) * stride
                                : wb + static_cast<long long>(n) * W;
      row_chains<2>(row, xf, W, W, acc);
      levels[n] = node_level(acc[0], acc[1]);
    }
    __syncthreads();

    if (warp == 0) {
      double best = 1.0;
      int last_drop = N;
      for (int n0 = 0; n0 < N; n0 += 32) {
        const double lvl = n0 + lane < N ? levels[n0 + lane] : CUDART_INF;
        unsigned drop = __ballot_sync(0xffffffffu,
                                      lvl < __dsub_rn(best, kTieTol));
        while (drop) {
          const int first = __ffs(drop) - 1;
          best = __shfl_sync(0xffffffffu, lvl, first);
          last_drop = n0 + first;
          const unsigned after = first == 31 ? 0u : (~0u << (first + 1));
          drop = __ballot_sync(0xffffffffu,
                               lvl < __dsub_rn(best, kTieTol)) & after;
        }
      }
      if (lane == 0) {
        s_best = best;
        s_last_drop = last_drop;
      }
    }
    __syncthreads();

    const double best = s_best;
    const bool cap = best >= __dsub_rn(1.0, kCapTol);
    level = cap ? 1.0 : best;
    if (!cap) {
      // !cap implies a drop, so last_drop < N
      for (int n = s_last_drop + tid; n < N; n += nthreads) {
        if (fabs(__dsub_rn(levels[n], best)) <= kTieTol) {
          for (int k = 0; k < words; ++k) {
            const unsigned bits = pbits[static_cast<long long>(n) * words + k];
            if (bits) atomicOr(&bind[k], bits);
          }
        }
      }
    }
    __syncthreads();

    // columns on a binding node freeze (every open one when capped); a
    // round that froze nothing freezes every open column; open columns
    // take the level
    int any_newly = 0;
    for (int j = tid; j < W; j += nthreads) {
      const bool on_binding = cap || ((bind[j >> 5] >> (j & 31)) & 1u);
      any_newly |= xu[j] != 0.0 && on_binding;
    }
    any_newly = __syncthreads_or(any_newly);
    for (int j = tid; j < W; j += nthreads) {
      if (xu[j] == 0.0) continue;                        // frozen before
      const bool on_binding = cap || ((bind[j >> 5] >> (j & 31)) & 1u);
      if (!any_newly || on_binding) {
        xf[j] = level;
        xu[j] = 0.0;
      }
    }
    ++i;
  }

  // y: frozen columns hold their level in xf, open ones the last level;
  // clipped to [0, 1] as torch.clip does (NaN passes through)
  for (int j = tid; j < W; j += nthreads) {
    double v = xu[j] == 0.0 ? xf[j] : level;
    v = v < 0.0 ? 0.0 : (v > 1.0 ? 1.0 : v);
    y_out[b * W + j] = v;
  }
  if (tid == 0) rounds_out[b] = i;
}

size_t solve_smem(int N, int W, bool tile) {
  const size_t words = (static_cast<size_t>(W) + 31) / 32;
  size_t doubles = 2 * static_cast<size_t>(W) + N;       // xf, xu, levels
  if (tile) doubles += static_cast<size_t>(N) * padded_stride(W);
  return doubles * sizeof(double)
         + (static_cast<size_t>(N) * words + words) * sizeof(unsigned);
}

template <bool kTile>
int launch_solve(const unsigned char* present, const double* weight,
                 const unsigned char* active, double* y_out, int* rounds_out,
                 int B, int N, int W, cudaStream_t stream) {
  const size_t smem = solve_smem(N, W, kTile);
  cudaError_t err = cudaFuncSetAttribute(
      maxmin_solve_kernel<kTile>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  int threads = ((N + 31) / 32) * 32;
  threads = threads < 32 ? 32 : (threads > kSolveMaxThreads
                                 ? kSolveMaxThreads : threads);
  maxmin_solve_kernel<kTile><<<B, threads, smem, stream>>>(
      present, weight, active, y_out, rounds_out, N, W);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// The per-node usage scatter of the §4.7 stretch passes (node_usage_kernel).
//
// Replaces the JAX package's XLA segment_sum in core/alloc_jax.py
// (node_usage / node_usage_batch, :317-348).  Contract: out[b, n] is the sum
// of vals[b, k] over the k with nodes[b, k] == n, added in ascending k
// starting from 0.0 — bit for bit an in-order np.add.at.  An entry naming
// no node in [0, N) (the sentinel N marks padding) is dropped.  Atomics
// (index_add_ / scatter_add_ on the card) would add in a run-dependent
// order, so none are used: one block takes one lane and 128 nodes, one
// thread one node, and every thread walks the lane's list in order and
// adds the entries that name its node.  The list is staged through shared
// memory a tile at a time, where all threads read the same entry (a
// broadcast).  Bound: bytes (the lists read once, the usage written once);
// at the stretch passes' sizes the walk of K entries a thread is the
// latency that counts.
constexpr int kUsageThreads = 128;
constexpr int kUsageTile = 2048;

__global__ void __launch_bounds__(kUsageThreads)
node_usage_kernel(const long long* __restrict__ nodes,
                  const double* __restrict__ vals, double* __restrict__ out,
                  int K, int N) {
  __shared__ int s_node[kUsageTile];
  __shared__ double s_val[kUsageTile];
  const long long lane = blockIdx.x;
  const int node = blockIdx.y * kUsageThreads + threadIdx.x;
  const long long* lane_nodes = nodes + lane * K;
  const double* lane_vals = vals + lane * K;
  double acc = 0.0;
  for (int base = 0; base < K; base += kUsageTile) {
    const int n = K - base < kUsageTile ? K - base : kUsageTile;
    __syncthreads();                    // the previous tile is consumed
    for (int i = threadIdx.x; i < n; i += kUsageThreads) {
      const long long v = __ldg(lane_nodes + base + i);
      s_node[i] = (v >= 0 && v < N) ? static_cast<int>(v) : -1;
      s_val[i] = __ldg(lane_vals + base + i);
    }
    __syncthreads();
    for (int i = 0; i < n; ++i) {
      if (s_node[i] == node) acc = __dadd_rn(acc, s_val[i]);
    }
  }
  if (node < N) out[lane * N + node] = acc;
}

}  // namespace

extern "C" {

int repro_alloc_matvec_f64(const double* w, const double* x, double* out,
                           int B, int N, int W, void* stream) {
  const int groups = (N + kMatvecRows - 1) / kMatvecRows;
  const long long blocks = static_cast<long long>(B) * groups;
  if (blocks > 0) {
    alloc_matvec_kernel<<<static_cast<unsigned int>(blocks), kMatvecThreads,
                          0, static_cast<cudaStream_t>(stream)>>>(
        w, x, out, N, W, groups);
  }
  return static_cast<int>(cudaGetLastError());
}

int repro_maxmin_solve_f64(const unsigned char* present, const double* weight,
                           const unsigned char* active, double* y_out,
                           int* rounds_out, int tile, int B, int N, int W,
                           void* stream) {
  if (B <= 0) return static_cast<int>(cudaGetLastError());
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return tile ? launch_solve<true>(present, weight, active, y_out,
                                   rounds_out, B, N, W, s)
              : launch_solve<false>(present, weight, active, y_out,
                                    rounds_out, B, N, W, s);
}

int repro_node_usage_f64(const long long* nodes, const double* vals,
                         double* out, int B, int K, int N, void* stream) {
  if (B > 0 && N > 0) {
    const dim3 grid(static_cast<unsigned int>(B),
                    static_cast<unsigned int>((N + kUsageThreads - 1)
                                              / kUsageThreads));
    node_usage_kernel<<<grid, kUsageThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(nodes, vals, out,
                                                             K, N);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
