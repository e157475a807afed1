// Hopper kernels of the RWKV6 (Finch) WKV recurrence: per (batch, head), an
// fp32 (dk x dv) state S carried over T steps with a data-dependent decay w
// and a bonus u,
//
//     y_t = r_t . (S + diag(u) k_t v_t^T)        (dv outputs)
//     S   = diag(w_t) S + k_t v_t^T
//
// They replace the JAX package's Pallas kernel kernels/rwkv6_scan.py (wkv6 /
// _wkv_kernel).  The TPU kernel cuts T into chunks of 32 and runs each chunk
// as two MXU products of r exp(la_prev) and k exp(-la), la the cumulative
// log decay from the chunk's start; below a decay of about 0.06 exp(-la)
// overflows fp32 within a chunk.  Two routes here, picked by the wrapper
// from the shape (kernels/rwkv6_scan.py wkv6_route):
//
// "sequential" (repro_wkv6: decode, short T, dk or dv above 64) runs the
// exact sequential recurrence of the reference's oracle (kernels/ref.py
// wkv6_ref).  A block owns one (batch, head) and a tile of C state
// columns: C = 32, or 16 (for dk <= 64) where 32 would leave SMs without a
// block.  Four neighbouring lanes share a column j; lane g of the four
// holds rows g, g + 4, ... of that column in registers, so a step is, per
// lane and row i, kv = k_i v_j, y += r_i (s_ij + u_i kv) and s_ij = w_i
// s_ij + kv, with two warp shuffles adding up the four partial y_j.  Each
// step's rows {r_i, k_i, w_i, u_i} are staged in shared memory as one
// float4 per row, 16 steps at a time, the next 16 fetched while the current
// ones run.  What bounds it on the H100: in decode (T = 1) the state's
// bytes (4 * dk * dv read and written per head); in a long prefill the
// serial chain over T (a step takes ~550 cycles at dk = dv = 64 with one
// warp per scheduler; tiles, lanes and unrolling moved it 15 % at most).
//
// "chunked" (repro_wkv6_chunked: prefill, dk and dv multiples of 8 up to
// 64) cuts T into chunks of kC = 64 steps and works on them in parallel,
// in three launches:
//   1. wkv6_chunk_state_kernel, a block per (batch, head, chunk): the
//      chunk's own state contribution (k_j prod_{m>j} w_m)^T v_j and its
//      total decay prod w;
//   2. wkv6_chunk_prefix_kernel, a thread per state element: the prefix
//      over chunks from s0, which overwrites each contribution with the
//      chunk's incoming state and writes sT (each thread reads its s0
//      element before it writes the same sT element, so sT may be s0);
//   3. wkv6_chunk_out_kernel, a block per (batch, head, chunk): y from the
//      chunk's incoming state, the intra-chunk attention and the bonus.
// Every decay factor is a product of w's (no exp, no log), normalised at
// the boundary of kL = 16-step sub-chunks: with P_i the product of w from
// the start of i's sub-chunk I up to i - 1, Q_j the product after j to the
// end of its sub-chunk J, and Tot a whole sub-chunk's product, the pair
// (i, j in an earlier J) is (r_i P_i) . (k_j Q_j G_IJ), G_IJ the Tot's
// strictly between J and I; the state term is (r_i P_i prod_{I'<I} Tot) .
// S_in; the contribution's key is k_j Q_j prod_{J'>J} Tot.  No factor
// exceeds 1, so a small decay underflows to 0, its limit, where the TPU
// form overflows.  Pairs inside one sub-chunk (j < i) are summed
// elementwise, sum_c r_ic k_jc prod_{j<m<i} w_mc, with the product kept
// as a running product by a thread per (key, 8 channels); the bonus is the
// diagonal.  The products (r^ k^T per sub-chunk pair, att . v, r^ . S_in,
// k^T . v) run on the tensor cores, mma.sync m16n8k8 in TF32 with each
// operand split into its TF32 high part and the fp32 remainder (read by
// the tensor core as TF32) and three products accumulated in fp32 (3xTF32:
// lo.hi + hi.lo + hi.hi): one TF32 product (10-bit mantissas) misses the
// 1e-4 tolerance by an order of magnitude, the split keeps ~fp32 accuracy.
// Tiles live in shared memory with row strides of 68 or 72 floats, so
// every fragment load is free of bank conflicts; rows are loaded from
// global memory 16 bytes at a time, every load of a block issued before
// any is used, and y and the states leave through shared memory as whole
// rows.  What bounds it on the H100: bytes first (r, k, v and w read
// twice, y written, and the per-chunk states, dk * dv fp32 a chunk,
// written, read and written by the prefix, read again: ~225 MB for one
// 1,428-token RWKV6-7B prefill, ~67 us at 3.35 TB/s), then the elementwise
// sub-chunk diagonal and the mma.sync products, three TF32 products for
// each fp32 one; the function's own bound is its fp32 operations
// (chip_smoke.py wkv6_bound).  Measured times: PERF.md.
//
// r, k and v are fp32 or bf16 (read directly, one template each), w, u, s0
// are fp32, y and sT fp32.  dk and dv up to 128 (multiples of 8 up to 64
// on the chunked route).
//
// Plain C interface for ctypes: launches on the given stream, allocates
// nothing (the chunked route's scratch comes from the caller), does not
// synchronise, returns the CUDA error of the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

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


// ---------------------------------------------------------------------------
// the chunked route
// ---------------------------------------------------------------------------
constexpr int kC = 64;                 // steps of a chunk
constexpr int kL = 16;                 // steps of a sub-chunk: one mma row tile
constexpr int kNS = kC / kL;           // sub-chunks of a chunk
constexpr int kD = 64;                 // dk and dv, zero-padded
constexpr int kCT = 256;               // threads of a chunk block: 8 warps
constexpr int kLdA = kD + 4;           // row stride of tiles read as A or B^T
constexpr int kLdB = kD + 8;           // row stride of tiles read as B or A^T
static_assert(kC == kD && kNS == 4, "the warp layout assumes these sizes");

// an mma operand split in a TF32 high part (x with its low 13 mantissa bits
// cleared) and the remainder, which is exact in fp32; the tensor core reads
// the remainder's top 19 bits, so the pair holds x to ~2^-22
template <int N>
struct Frag {
  uint32_t hi[N], lo[N];
};

template <int N>
__device__ __forceinline__ Frag<N> split(const float (&x)[N]) {
  Frag<N> f;
#pragma unroll
  for (int e = 0; e < N; ++e) {
    f.hi[e] = __float_as_uint(x[e]) & 0xffffe000u;
    f.lo[e] = __float_as_uint(x[e] - __uint_as_float(f.hi[e]));
  }
  return f;
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += a b in 3xTF32: the small products first, fp32 accumulation
__device__ __forceinline__ void mma3(float (&d)[4], const Frag<4>& a,
                                     const Frag<2>& b) {
  mma_tf32(d, a.lo, b.hi);
  mma_tf32(d, a.hi, b.lo);
  mma_tf32(d, a.hi, b.hi);
}

// Fragments of mma.m16n8k8 (g = lane / 4, t = lane % 4).  A (16 x 8) with
// A[m][k] = X[(m0 + m) * ld + k0 + k] * sc[k0 + k]
__device__ __forceinline__ Frag<4> load_a(const float* X, int ld, int m0,
                                          int k0, const float* sc, int g,
                                          int t) {
  const float s0 = sc[k0 + t], s1 = sc[k0 + t + 4];
  const float x[4] = {X[(m0 + g) * ld + k0 + t] * s0,
                      X[(m0 + g + 8) * ld + k0 + t] * s0,
                      X[(m0 + g) * ld + k0 + t + 4] * s1,
                      X[(m0 + g + 8) * ld + k0 + t + 4] * s1};
  return split(x);
}

// A with A[m][k] = X[(m0 + m) * ld + k0 + k]
__device__ __forceinline__ Frag<4> load_a(const float* X, int ld, int m0,
                                          int k0, int g, int t) {
  const float x[4] = {X[(m0 + g) * ld + k0 + t], X[(m0 + g + 8) * ld + k0 + t],
                      X[(m0 + g) * ld + k0 + t + 4],
                      X[(m0 + g + 8) * ld + k0 + t + 4]};
  return split(x);
}

// A stored transposed: A[m][k] = Z[(k0 + k) * ld + m0 + m]
__device__ __forceinline__ Frag<4> load_at(const float* Z, int ld, int m0,
                                           int k0, int g, int t) {
  const float x[4] = {Z[(k0 + t) * ld + m0 + g], Z[(k0 + t) * ld + m0 + g + 8],
                      Z[(k0 + t + 4) * ld + m0 + g],
                      Z[(k0 + t + 4) * ld + m0 + g + 8]};
  return split(x);
}

// B (8 x 8) with B[k][n] = Y[(k0 + k) * ld + n0 + n]
__device__ __forceinline__ Frag<2> load_b(const float* Y, int ld, int k0,
                                          int n0, int g, int t) {
  const float x[2] = {Y[(k0 + t) * ld + n0 + g], Y[(k0 + t + 4) * ld + n0 + g]};
  return split(x);
}

// B stored transposed and scaled: B[k][n] = Z[(n0 + n) * ld + k0 + k] *
// sc[k0 + k] (no scale where sc is null)
__device__ __forceinline__ Frag<2> load_bt(const float* Z, int ld, int k0,
                                           int n0, const float* sc, int g,
                                           int t) {
  float x[2] = {Z[(n0 + g) * ld + k0 + t], Z[(n0 + g) * ld + k0 + t + 4]};
  if (sc != nullptr) {
    x[0] *= sc[k0 + t];
    x[1] *= sc[k0 + t + 4];
  }
  return split(x);
}

// eight consecutive floats of shared memory (32-byte aligned), as two
// 16-byte loads
__device__ __forceinline__ void unpack(const float4* p, float (&x)[8]) {
  const float4 a = p[0], b = p[1];
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
  x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
}

// The kC steps of one head from row `row0` (the index of (b, t0, h) in
// (B, T, H)) of x (B, T, H, d), d a multiple of 16 bytes' worth of
// elements: this thread's share as 16-byte loads, every load issued before
// any is used (rows past `rows` and columns past d are not read).
template <typename T>
struct TileRegs {
  static constexpr int kElems = 16 / sizeof(T);            // per load
  static constexpr int kLoads = kC * kD / kCT / kElems;    // per thread
  uint4 raw[kLoads];
};

template <typename T>
__device__ __forceinline__ TileRegs<T> fetch_tile(const T* x, long long row0,
                                                  int H, int d, int rows) {
  using R = TileRegs<T>;
  R f;
#pragma unroll
  for (int q = 0; q < R::kLoads; ++q) {
    const int e = (threadIdx.x + q * kCT) * R::kElems;
    const int i = e / kD, c = e % kD;
    f.raw[q] = (i < rows && c < d)
                   ? *reinterpret_cast<const uint4*>(
                         x + (row0 + static_cast<long long>(i) * H) * d + c)
                   : make_uint4(0, 0, 0, 0);
  }
  return f;
}

__device__ __forceinline__ void widen(const uint4& v, const float*,
                                      float (&out)[4]) {
  out[0] = __uint_as_float(v.x); out[1] = __uint_as_float(v.y);
  out[2] = __uint_as_float(v.z); out[3] = __uint_as_float(v.w);
}

__device__ __forceinline__ void widen(const uint4& v, const __nv_bfloat16*,
                                      float (&out)[8]) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    out[2 * e] = __uint_as_float(w[e] << 16);
    out[2 * e + 1] = __uint_as_float(w[e] & 0xffff0000u);
  }
}

// ... widened to fp32 into a (kC x ld) tile, `fill` where nothing was read
template <typename T>
__device__ __forceinline__ void stage_tile(float* tile, int ld,
                                           const TileRegs<T>& f, int d,
                                           int rows, float fill) {
  using R = TileRegs<T>;
#pragma unroll
  for (int q = 0; q < R::kLoads; ++q) {
    const int e = (threadIdx.x + q * kCT) * R::kElems;
    const int i = e / kD, c = e % kD;
    const bool ok = i < rows && c < d;
    float v[R::kElems];
    widen(f.raw[q], static_cast<const T*>(nullptr), v);
#pragma unroll
    for (int m = 0; m < R::kElems; m += 4) {
      *reinterpret_cast<float4*>(tile + i * ld + c + m) =
          ok ? make_float4(v[m], v[m + 1], v[m + 2], v[m + 3])
             : make_float4(fill, fill, fill, fill);
    }
  }
}

// A (kC x kD) fp32 tile of shared memory (row stride ld) to rows of global
// memory, 16 bytes at a time: row i at out + i * stride, its first d
// columns (a multiple of 4), the rows before `rows`.
__device__ __forceinline__ void write_tile(const float* tile, int ld,
                                           float* out, long long stride,
                                           int d, int rows) {
#pragma unroll
  for (int q = 0; q < kC * kD / 4 / kCT; ++q) {
    const int e = (threadIdx.x + q * kCT) * 4;
    const int i = e / kD, c = e % kD;
    if (i < rows && c < d) {
      *reinterpret_cast<float4*>(out + i * stride + c) =
          *reinterpret_cast<const float4*>(tile + i * ld + c);
    }
  }
}

// an accumulator fragment (rows m0 + g, m0 + g + 8; columns n0 + 2 t,
// n0 + 2 t + 1) into a shared tile
__device__ __forceinline__ void put_acc(float* tile, int ld, int m0, int n0,
                                        const float (&acc)[4], int g, int t) {
  *reinterpret_cast<float2*>(tile + (m0 + g) * ld + n0 + 2 * t) =
      make_float2(acc[0], acc[1]);
  *reinterpret_cast<float2*>(tile + (m0 + g + 8) * ld + n0 + 2 * t) =
      make_float2(acc[2], acc[3]);
}

// 1. A block per (chunk, head, batch): the chunk's state contribution
// (k_j prod_{m>j} w_m)^T v_j (kD x kD, into `states`) and its total decay
// prod w (kD, into `decays`); padded rows and columns give 0 and 1.
template <typename T>
__global__ void __launch_bounds__(kCT)
wkv6_chunk_state_kernel(const T* __restrict__ k, const T* __restrict__ v,
                        const float* __restrict__ w,
                        float* __restrict__ states,
                        float* __restrict__ decays, int Tn, int H, int dk,
                        int dv) {
  extern __shared__ float smem[];
  float* ks = smem;                      // (kC x kLdB): k, then its key
  float* vs = ks + kC * kLdB;            // (kC x kLdB)
  float* ws = vs + kC * kLdB;            // (kC x kLdA)
  float* tot = ws + kC * kLdA;           // (kNS x kD): a sub-chunk's product
  const int chunk = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int nc = gridDim.x, tid = threadIdx.x;
  const int t0 = chunk * kC, rows = min(kC, Tn - t0);
  const long long row0 = (static_cast<long long>(b) * Tn + t0) * H + h;
  const long long chunk_id = (static_cast<long long>(b) * H + h) * nc + chunk;
  {
    const auto kf = fetch_tile(k, row0, H, dk, rows);
    const auto vf = fetch_tile(v, row0, H, dv, rows);
    const auto wf = fetch_tile(w, row0, H, dk, rows);
    stage_tile(ks, kLdB, kf, dk, rows, 0.f);
    stage_tile(vs, kLdB, vf, dv, rows, 0.f);
    stage_tile(ws, kLdA, wf, dk, rows, 1.f);
  }
  __syncthreads();

  const int c = tid % kD, sub = tid / kD;   // a thread per (channel, sub)
  {
    float p = 1.f, q = 1.f;
    for (int i = 0; i < kL; ++i) p *= ws[(sub * kL + i) * kLdA + c];
    for (int i = kL - 1; i >= 0; --i) {     // k_j Q_j
      const int row = sub * kL + i;
      ks[row * kLdB + c] *= q;
      q *= ws[row * kLdA + c];
    }
    tot[sub * kD + c] = p;
  }
  __syncthreads();
  {
    float after = 1.f;                      // the sub-chunks after this one
    for (int m = kNS - 1; m > sub; --m) after *= tot[m * kD + c];
    for (int i = 0; i < kL; ++i) ks[(sub * kL + i) * kLdB + c] *= after;
    if (sub == 0) {
      float d = tot[c];
      for (int m = 1; m < kNS; ++m) d *= tot[m * kD + c];
      decays[chunk_id * kD + c] = d;
    }
  }
  __syncthreads();

  // key^T v: warp (16-row tile of channels, half of the columns)
  const int warp = tid / 32, lane = tid % 32, g = lane >> 2, t = lane & 3;
  const int m0 = (warp >> 1) * 16, nb = (warp & 1) * 32;
  float acc[4][4] = {};
#pragma unroll
  for (int k0 = 0; k0 < kC; k0 += 8) {
    const Frag<4> a = load_at(ks, kLdB, m0, k0, g, t);
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      mma3(acc[nt], a, load_b(vs, kLdB, k0, nb + nt * 8, g, t));
    }
  }
  __syncthreads();                        // key^T v read ks: reuse it
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
    put_acc(ks, kLdB, m0, nb + nt * 8, acc[nt], g, t);
  }
  __syncthreads();
  write_tile(ks, kLdB, states + chunk_id * (kD * kD), kD, kD, kD);
}

// 2. A thread per state element of a (batch, head): the prefix over chunks
// from s0.  Each chunk's contribution in `states` is overwritten by the
// state the chunk starts from; sT gets the last.  A thread reads its s0
// element before it writes the same sT element, so sT may be s0.
__global__ void __launch_bounds__(256)
wkv6_chunk_prefix_kernel(const float* s0, float* sT,
                         float* __restrict__ states,
                         const float* __restrict__ decays, int BH, int nc,
                         int dk, int dv) {
  constexpr int kAhead = 8;                 // chunks loaded at a time
  const long long idx = static_cast<long long>(blockIdx.x) * blockDim.x
                        + threadIdx.x;
  if (idx >= static_cast<long long>(BH) * kD * kD) return;
  const long long bh = idx / (kD * kD);
  const int i = static_cast<int>(idx / kD % kD), j = static_cast<int>(idx % kD);
  const bool ok = i < dk && j < dv;
  const long long e = (bh * dk + i) * dv + j;
  float s = ok ? s0[e] : 0.f;
  float* st = states + bh * nc * (kD * kD) + i * kD + j;
  const float* dp = decays + bh * nc * kD + i;
  for (int c0 = 0; c0 < nc; c0 += kAhead) {
    float ub[kAhead] = {}, db[kAhead] = {};
#pragma unroll
    for (int q = 0; q < kAhead; ++q) {
      if (c0 + q < nc) {
        ub[q] = st[static_cast<long long>(c0 + q) * (kD * kD)];
        db[q] = dp[static_cast<long long>(c0 + q) * kD];
      }
    }
#pragma unroll
    for (int q = 0; q < kAhead; ++q) {
      if (c0 + q < nc) {
        st[static_cast<long long>(c0 + q) * (kD * kD)] = s;
        s = fmaf(db[q], s, ub[q]);
      }
    }
  }
  if (ok) sT[e] = s;
}

// 3. A block per (chunk, head, batch): y of the chunk's steps.
template <typename T>
__global__ void __launch_bounds__(kCT, 2)
wkv6_chunk_out_kernel(const T* __restrict__ r, const T* __restrict__ k,
                      const T* __restrict__ v, const float* __restrict__ w,
                      const float* __restrict__ u,
                      const float* __restrict__ states, float* __restrict__ y,
                      int Tn, int H, int dk, int dv) {
  extern __shared__ float smem[];
  float* rs = smem;                      // (kC x kLdA): r, then r P
  float* ks = rs + kC * kLdA;            // (kC x kLdA): k, then k Q
  float* ws = ks + kC * kLdA;            // (kC x kLdA): w, then attention
  float* vs = ws + kC * kLdA;            // (kC x kLdB)
  float* ss = vs + kC * kLdB;            // (kD x kLdB): the incoming state
  float* us = ss + kD * kLdB;            // (kD)
  float* tot = us + kD;                  // (kNS x kD): a sub-chunk's product
  float* before = tot + kNS * kD;        // (kNS x kD): of those before I
  float* between = before + kNS * kD;    // (3 x kD): G_20, G_30, G_31
  float* att = ws;
  const int chunk = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int nc = gridDim.x, tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32, g = lane >> 2, t = lane & 3;
  const int t0 = chunk * kC, rows = min(kC, Tn - t0);
  const long long row0 = (static_cast<long long>(b) * Tn + t0) * H + h;
  // every load issued at once; v and S_in staged only after the diagonal
  // blocks, so their loads stay in flight meanwhile
  const auto vf = fetch_tile(v, row0, H, dv, rows);
  float4 sf[kD * kD / 4 / kCT];
  {
    const auto rf = fetch_tile(r, row0, H, dk, rows);
    const auto kf = fetch_tile(k, row0, H, dk, rows);
    const auto wf = fetch_tile(w, row0, H, dk, rows);
    const float4* sp = reinterpret_cast<const float4*>(
        states
        + ((static_cast<long long>(b) * H + h) * nc + chunk) * (kD * kD));
#pragma unroll
    for (int q = 0; q < kD * kD / 4 / kCT; ++q) sf[q] = sp[tid + q * kCT];
    stage_tile(rs, kLdA, rf, dk, rows, 0.f);
    stage_tile(ks, kLdA, kf, dk, rows, 0.f);
    stage_tile(ws, kLdA, wf, dk, rows, 1.f);
  }
  if (tid < kD) us[tid] = tid < dk ? u[h * dk + tid] : 0.f;
  __syncthreads();

  // Pairs inside a sub-chunk, elementwise: a task per (sub-chunk, key j,
  // 8 channels), two a thread; rows i > j take sum_c r_ic k_jc
  // prod_{j<m<i} w_mc, row j the bonus r_j . (u k_j), rows i < j 0.  The
  // eight lanes of a task then sum their rows, each keeping two.
  const int cg = lane & 7;
  float keep[2][2];
#pragma unroll
  for (int p = 0; p < 2; ++p) {
    const int combo = (tid >> 3) + 32 * p;
    const int base = (combo >> 4) * kL, j = combo & 15;
    const float4* kr = reinterpret_cast<const float4*>(
        ks + (base + j) * kLdA + 8 * cg);
    const float4* rj = reinterpret_cast<const float4*>(
        rs + (base + j) * kLdA + 8 * cg);
    const float4* uc = reinterpret_cast<const float4*>(us + 8 * cg);
    float kf[8], acc[kL];               // kf: k_j prod_{j<m<i} w_m
    unpack(kr, kf);
    float bonus = 0.f;
    {
      float rv[8], uv[8];
      unpack(rj, rv);
      unpack(uc, uv);
#pragma unroll
      for (int e = 0; e < 8; ++e) bonus = fmaf(rv[e] * uv[e], kf[e], bonus);
    }
#pragma unroll
    for (int i = 0; i < kL; ++i) {
      acc[i] = i == j ? bonus : 0.f;
      if (i > j) {
        float rv[8], wv[8];
        unpack(reinterpret_cast<const float4*>(rs + (base + i) * kLdA + 8 * cg),
               rv);
        unpack(reinterpret_cast<const float4*>(ws + (base + i) * kLdA + 8 * cg),
               wv);
        float d0 = 0.f, d1 = 0.f;          // two chains: even and odd e
#pragma unroll
        for (int e = 0; e < 8; e += 2) {
          d0 = fmaf(rv[e], kf[e], d0);
          d1 = fmaf(rv[e + 1], kf[e + 1], d1);
        }
#pragma unroll
        for (int e = 0; e < 8; ++e) kf[e] *= wv[e];
        acc[i] = d0 + d1;
      }
    }
    // reduce-scatter over the 8 lanes: lane cg ends with rows 2 cg, 2 cg + 1
    float x8[8], x4[4];
    const bool h4 = cg & 4, h2 = cg & 2, h1 = cg & 1;
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const float send = h4 ? acc[q] : acc[q + 8];
      x8[q] = (h4 ? acc[q + 8] : acc[q])
              + __shfl_xor_sync(0xffffffffu, send, 4);
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float send = h2 ? x8[q] : x8[q + 4];
      x4[q] = (h2 ? x8[q + 4] : x8[q]) + __shfl_xor_sync(0xffffffffu, send, 2);
    }
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const float send = h1 ? x4[q] : x4[q + 2];
      keep[p][q] = (h1 ? x4[q + 2] : x4[q])
                   + __shfl_xor_sync(0xffffffffu, send, 1);
    }
  }
  stage_tile(vs, kLdB, vf, dv, rows, 0.f);
#pragma unroll
  for (int q = 0; q < kD * kD / 4 / kCT; ++q) {
    const int idx = tid + q * kCT;
    *reinterpret_cast<float4*>(ss + (idx / (kD / 4)) * kLdB
                               + (idx % (kD / 4)) * 4) = sf[q];
  }
  __syncthreads();

  // Running products in each sub-chunk: a thread per (channel, sub-chunk)
  // turns r into r P and k into k Q.
  {
    const int c = tid % kD, sub = tid / kD;
    float p = 1.f, q = 1.f;
    for (int i = 0; i < kL; ++i) {
      const int row = sub * kL + i;
      rs[row * kLdA + c] *= p;
      p *= ws[row * kLdA + c];
    }
    for (int i = kL - 1; i >= 0; --i) {
      const int row = sub * kL + i;
      ks[row * kLdA + c] *= q;
      q *= ws[row * kLdA + c];
    }
    tot[sub * kD + c] = p;
  }
  __syncthreads();
  if (tid < kD) {                          // products of whole sub-chunks
    const float t0v = tot[tid], t1 = tot[kD + tid], t2 = tot[2 * kD + tid];
    before[tid] = 1.f;
    before[kD + tid] = t0v;
    before[2 * kD + tid] = t0v * t1;
    before[3 * kD + tid] = t0v * t1 * t2;
    between[tid] = t1;                     // (I, J) = (2, 0)
    between[kD + tid] = t1 * t2;           // (3, 0)
    between[2 * kD + tid] = t2;            // (3, 1)
  }
#pragma unroll
  for (int p = 0; p < 2; ++p) {            // the diagonal blocks (w is done)
    const int combo = (tid >> 3) + 32 * p;
    const int base = (combo >> 4) * kL, j = combo & 15;
    att[(base + 2 * cg) * kLdA + base + j] = keep[p][0];
    att[(base + 2 * cg + 1) * kLdA + base + j] = keep[p][1];
  }
  __syncthreads();

  // Pairs across sub-chunks on the tensor cores: warp (I, half) forms key
  // tile 2 J + half of each earlier sub-chunk J.
  const int I = warp >> 1, half = warp & 1, m0 = I * kL;
  for (int J = 0; J < I; ++J) {
    const float* sc = J == I - 1 ? nullptr
                      : between + (J == 0 ? (I == 2 ? 0 : 1) : 2) * kD;
    const int n0 = J * kL + half * 8;
    float acc[4] = {};
#pragma unroll
    for (int k0 = 0; k0 < kD; k0 += 8) {
      mma3(acc, load_a(rs, kLdA, m0, k0, g, t),
           load_bt(ks, kLdA, k0, n0, sc, g, t));
    }
    att[(m0 + g) * kLdA + n0 + 2 * t] = acc[0];
    att[(m0 + g) * kLdA + n0 + 2 * t + 1] = acc[1];
    att[(m0 + g + 8) * kLdA + n0 + 2 * t] = acc[2];
    att[(m0 + g + 8) * kLdA + n0 + 2 * t + 1] = acc[3];
  }
  __syncthreads();

  // y = (r P before_I) . S_in + att . v: warp (I, half) owns rows m0..m0+15
  // and columns nb..nb+31.
  const int nb = half * 32;
  float acc[4][4] = {};
#pragma unroll
  for (int k0 = 0; k0 < kD; k0 += 8) {
    const Frag<4> a = load_a(rs, kLdA, m0, k0, before + I * kD, g, t);
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      mma3(acc[nt], a, load_b(ss, kLdB, k0, nb + nt * 8, g, t));
    }
  }
  for (int k0 = 0; k0 < m0 + kL; k0 += 8) {
    const Frag<4> a = load_a(att, kLdA, m0, k0, g, t);
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      mma3(acc[nt], a, load_b(vs, kLdB, k0, nb + nt * 8, g, t));
    }
  }
  __syncthreads();                        // done with r P: reuse it for y
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
    put_acc(rs, kLdA, m0, nb + nt * 8, acc[nt], g, t);
  }
  __syncthreads();
  write_tile(rs, kLdA, y + row0 * dv, static_cast<long long>(H) * dv,
                   dv, rows);
}

constexpr size_t kStateSmem =
    sizeof(float) * (2 * kC * kLdB + kC * kLdA + kNS * kD);
constexpr size_t kOutSmem =
    sizeof(float) * (3 * kC * kLdA + kC * kLdB + kD * kLdB + kD + 2 * kNS * kD
                     + 3 * kD);

template <typename T>
int launch_chunked(const void* r, const void* k, const void* v,
                   const float* w, const float* u, const float* s0, float* y,
                   float* sT, float* states, float* decays, int B, int Tn,
                   int H, int dk, int dv, cudaStream_t st) {
  const int nc = (Tn + kC - 1) / kC;
  const dim3 grid(nc, H, B);
  cudaError_t err = cudaSuccess;
  if (nc > 0) {
    err = cudaFuncSetAttribute(wkv6_chunk_state_kernel<T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(kStateSmem));
    if (err == cudaSuccess) {
      err = cudaFuncSetAttribute(wkv6_chunk_out_kernel<T>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(kOutSmem));
    }
    if (err != cudaSuccess) return static_cast<int>(err);
    wkv6_chunk_state_kernel<T><<<grid, kCT, kStateSmem, st>>>(
        static_cast<const T*>(k), static_cast<const T*>(v), w, states, decays,
        Tn, H, dk, dv);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const long long n = static_cast<long long>(B) * H * kD * kD;
  wkv6_chunk_prefix_kernel<<<static_cast<unsigned>((n + 255) / 256), 256, 0,
                             st>>>(s0, sT, states, decays, B * H, nc, dk, dv);
  err = cudaGetLastError();
  if (err != cudaSuccess || nc == 0) return static_cast<int>(err);
  wkv6_chunk_out_kernel<T><<<grid, kCT, kOutSmem, st>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), w, u, states, y, Tn, H, dk, dv);
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

// The chunked route: arguments as repro_wkv6, dk and dv multiples of 8 up
// to 64 (rows of whole 16-byte loads), plus scratch from the caller: states
// (B, H, ceil(T / 64), 64, 64) and decays (B, H, ceil(T / 64), 64), fp32.
extern "C" int repro_wkv6_chunked(const void* r, const void* k, const void* v,
                                  const float* w, const float* u,
                                  const float* s0, float* y, float* sT,
                                  float* states, float* decays, int rkv_bf16,
                                  int B, int Tn, int H, int dk, int dv,
                                  void* stream) {
  if (dk < 1 || dk > kD || dv < 1 || dv > kD || dk % 8 || dv % 8 ||
      Tn < 0 || B > 65535 || H > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (B == 0 || H == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return rkv_bf16
             ? launch_chunked<__nv_bfloat16>(r, k, v, w, u, s0, y, sT, states,
                                             decays, B, Tn, H, dk, dv, st)
             : launch_chunked<float>(r, k, v, w, u, s0, y, sT, states, decays,
                                     B, Tn, H, dk, dv, st);
}
