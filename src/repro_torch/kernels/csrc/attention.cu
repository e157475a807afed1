// Hopper kernels of the serving path's attention: flash attention (prefill)
// and flash decode (one new token against a KV cache).
//
// They replace the JAX package's Pallas kernels in
// src/repro/kernels/flash_attention.py: flash_attention (def :78,
// pallas_call :110) and flash_decode (def :162, pallas_call :186).  The
// plain PyTorch versions are repro_torch.models.layers.chunked_attention
// and decode_attention.  Every query row attends a contiguous key interval
// [lo, hi): the causal mask, the sliding window, q_offset and a cache's
// valid length are all such intervals.  A row with no key gives 0.
//
// Prefill (flash_attention) has two instances, decode (flash_decode) two,
// and the decode splits a second pass; the wrappers choose the instance by
// types and head dims alone (attention_route, decode_route).
//
// 1. attn_wgmma_kernel — prefill with bf16 q, k and v whose head dims are
//    multiples of 16 up to 256 (every served shape).  Bound on the H100 by
//    operations: ~4 hd flops a (row, key) pair against one read of each
//    element, e.g. 9.7 GFLOP against 6 MB at RecurrentGemma-2B's
//    1,374-token prompt, so the bf16 tensor cores (989 TFLOP/s) set the
//    bound and fp32 FMAs on the CUDA cores (67 TFLOP/s) cannot approach it.
//    Design:
//    - Both products run on wgmma, bf16 in, fp32 accumulate.  S = Q K^T
//      (m64n64k16) takes Q and K from shared memory, K-major, 128-byte
//      swizzle: hd is cut into 64-column panels of 64 rows x 128 bytes
//      (four at hd 256), a k-step of 16 columns is a 32-byte step inside a
//      panel.  O += P V (m64n64k16 per 64 output columns) takes P from
//      registers: the fp32 S fragment, after the online softmax, is packed
//      into bf16 pairs, which is the A-fragment layout; V is read as it
//      lies in device memory ([key][d]) through wgmma's transpose flag, so
//      there is no transposing pass.  m, l and O stay fp32 in registers.
//      Rounding P to bf16 is the one rounding the plain version does not
//      share exactly (it rounds the normalised P to v's type).
//    - Tiles arrive by TMA (cp.async.bulk.tensor, 4-d maps over
//      (d, head, row, batch) encoded on the host per call, 128-byte
//      swizzle, rows past the end zero-filled) into a ring of two K/V
//      stages; one producer warp keeps the next tile's copies in flight
//      while the consumer warpgroup runs the current one, on mbarriers
//      (full per stage for K and for V, empty per stage).
//    - Counts behind the tile sizes, at hd = hdv = 256: a consumer
//      warpgroup owns 64 query rows of one head (wgmma's M); Q takes 32 KB,
//      a 64-key stage 32 KB of K and 32 KB of V, so Q + 2 stages = 160 KB
//      of the 227 KB; registers: O 128 fp32 a thread + S 32 + P 16, under
//      the 255 a thread of one 160-thread block an SM (no setmaxnreg is
//      needed).  A second consumer warpgroup (128 rows) would halve the
//      grid: RecurrentGemma-2B's prompt of 1,374 tokens x 10 heads gives
//      220 blocks of 64 rows on 132 SMs, 110 of 128.  Blocks are ordered
//      heaviest first (the last query tiles of every head), so the causal
//      tail does not end the launch alone.  The ten query heads of
//      RecurrentGemma's one KV head read the same K/V again from L2.
//    - Masks: the block walks the union of its rows' intervals in 64-key
//      tiles; a tile inside every valid row's interval takes the unmasked
//      path, the others mask the S fragment by [lo, hi) per row.
// 2. attn_kernel — the general prefill instance (fp32, mixed types, head
//    dims that wgmma does not take): 64 rows a block, 32-key tiles widened
//    to fp32 in shared memory, fp32 FMAs on the CUDA cores, 4 threads a
//    row.  The phase-6 model check runs it in fp32.
// 3. decode_mma_kernel — decode with a bf16 cache, hd a multiple of 16 and
//    hdv of 8 (every served shape; q fp32 or bf16).  Bound by bytes: the
//    valid cache rows are read once per KV head (6 MB at four
//    RecurrentGemma slots of ~1,400 tokens, 1.6 us at 3.35 TB/s).  Design:
//    - A block of 256 threads owns (request, KV head, a split of the
//      keys); the splits put two blocks on every SM whatever the batch
//      (flash-decoding), and a split with no valid key exits at once.
//      An empty cache (S = 0: an encoder-decoder's cross cache that holds
//      no frame) is one split with no chunk, whose block writes 0: the
//      accumulator stays 0 and is scaled by 1 / max(l, 1e-30).
//    - The cache stays bf16 in shared memory, in chunks of 32 keys through
//      a two-stage cp.async ring, K and V as separate groups, so V lands
//      while the scores are computed and the next chunk is in flight.
//    - Both products on mma.sync m16n8k16 (bf16 in, fp32 accumulate) with
//      the group's query heads as the 16 rows of a tile (ten of them for
//      RecurrentGemma; the padding rows are zero); K and V are read in
//      place, q as bf16 — an fp32 q as the sum of two bf16 parts, two
//      products, so it keeps its accuracy; P is rounded to bf16 as in
//      prefill.  Softmax: a warp a head over the chunk.  On the CUDA
//      cores (decode_kernel) the two products are most of a block's time,
//      a chain of shared-memory loads that 8 warps cannot hide; on the
//      tensor cores they are a small part of it.
//    - The combine stays a second kernel, launched only when there is
//      more than one split: folding it in with a last-block counter would
//      need a counter that survives between calls, and so state in the
//      library, for a launch of a few microseconds.  It reads each split's
//      (m, l) once, weighs the splits that hold keys in shared memory and
//      spreads the sum over (request, head, 64 columns) blocks.
// 4. decode_kernel — the general decode instance (an fp32 cache, head dims
//    the mma instance does not take): the same blocks, splits and ring,
//    the cache in its own type; scores by 8 lanes a key (hd/8 dims each, a
//    3-step shuffle) for two heads at a time, q fp32 in shared memory; P V
//    by a thread two output columns.
//
// Row statistics and accumulators are fp32 everywhere; the output has q's
// type.  Plain C interface for ctypes: every entry point launches on the
// stream it is given, allocates nothing, does not synchronise, and returns
// the CUDA error of the launch (0 on success; a tensor map the driver
// refuses gives minus its CUresult).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kMaxHead = 256;   // largest hd / hdv taken
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(
    float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ========================================================================
// General prefill instance: fp32 FMAs on the CUDA cores
// ========================================================================
constexpr int kRows = 64;   // query rows per block
constexpr int kKeys = 32;   // keys per tile

// Copies a rows x width tile (row stride `stride` elements; rows at or past
// `valid` are zero-filled) from device memory into shared memory as fp32,
// row pitch `pitch`, 16 bytes a thread where the tile allows it.
template <int THREADS, typename T>
__device__ __forceinline__ void load_tile(float* dst, int pitch,
                                          const T* __restrict__ src,
                                          long long stride, int rows,
                                          int valid, int width) {
  constexpr int V = 16 / sizeof(T);
  const bool vec = width % V == 0 && stride % V == 0 && pitch % 4 == 0 &&
                   (reinterpret_cast<unsigned long long>(src) & 15) == 0 &&
                   (reinterpret_cast<unsigned long long>(dst) & 15) == 0;
  if (vec) {
    const int per_row = width / V;
#pragma unroll 4
    for (int idx = threadIdx.x; idx < rows * per_row; idx += THREADS) {
      const int r = idx / per_row;
      const int c = (idx - r * per_row) * V;
      float f[V];
      if (r < valid) {
        const uint4 raw = *reinterpret_cast<const uint4*>(src + r * stride + c);
        const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
        for (int j = 0; j < V; ++j) f[j] = to_f(e[j]);
      } else {
#pragma unroll
        for (int j = 0; j < V; ++j) f[j] = 0.0f;
      }
      float4* d4 = reinterpret_cast<float4*>(dst + r * pitch + c);
#pragma unroll
      for (int j = 0; j < V; j += 4) {
        d4[j / 4] = make_float4(f[j], f[j + 1], f[j + 2], f[j + 3]);
      }
    }
  } else {
    for (int idx = threadIdx.x; idx < rows * width; idx += THREADS) {
      const int r = idx / width, c = idx - r * width;
      dst[r * pitch + c] = r < valid ? to_f(src[r * stride + c]) : 0.0f;
    }
  }
}

struct AttnArgs {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int Tq, Tk, H, Hkv, hd, hdv;
  int causal, window, q_offset;
  float scale;
};

// The key interval [lo, hi) of query row qi (empty when hi <= lo).
__device__ __forceinline__ void row_keys(const AttnArgs& a, int qi, int* lo,
                                         int* hi) {
  const int pos = a.q_offset + qi;
  int l = a.window > 0 ? pos - a.window + 1 : 0;
  l = l > 0 ? l : 0;
  int h = a.causal ? (pos + 1 < a.Tk ? pos + 1 : a.Tk) : a.Tk;
  *lo = l;
  *hi = h > l ? h : l;
}

// The union [kmin, kmax) of the intervals of the valid rows q0 .. q0 +
// rows - 1, and [lo_max, hi_min): the keys inside every valid row's
// interval (empty when a row has none).  Row intervals only move right as
// the row grows, so the ends of the row range decide them.
__device__ __forceinline__ void block_keys(const AttnArgs& a, int q0,
                                           int rows, int* kmin, int* kmax,
                                           int* lo_max, int* hi_min) {
  const int last = (q0 + rows < a.Tq ? q0 + rows : a.Tq) - 1;
  int lo0, hi0, lo1, hi1;
  row_keys(a, q0, &lo0, &hi0);
  row_keys(a, last, &lo1, &hi1);
  int lo = a.Tk, hi = 0;
  for (int qi = q0; qi <= last; ++qi) {   // rows with no key are skipped
    int l, h;
    row_keys(a, qi, &l, &h);
    if (h > l) {
      lo = l < lo ? l : lo;
      hi = h > hi ? h : hi;
    }
  }
  *kmin = lo;
  *kmax = hi;
  *lo_max = lo1;
  *hi_min = (hi0 > lo0 && hi1 > lo1) ? hi0 : lo1;
}

// kRows query rows a block, 4 threads a row.
template <typename TQ, typename TKV, int NACC>
__global__ void __launch_bounds__(4 * kRows)
attn_kernel(AttnArgs a) {
  constexpr int THREADS = 4 * kRows;
  extern __shared__ __align__(16) float smem[];
  __shared__ int blk_lo, blk_hi;

  const TQ* __restrict__ q = static_cast<const TQ*>(a.q);
  const TKV* __restrict__ k = static_cast<const TKV*>(a.k);
  const TKV* __restrict__ v = static_cast<const TKV*>(a.v);
  TQ* __restrict__ o = static_cast<TQ*>(a.o);

  const int hd = a.hd, hdv = a.hdv;
  // row pitches padded by 4 floats: rows 4 banks apart, so the score
  // loop's reads of 8 query rows and 4 key rows hit distinct banks
  const int qw = hd + 4;
  const int kvw = (hd > hdv ? hd : hdv) + 4;
  float* Qs = smem;                                // kRows x qw
  float* KVs = Qs + kRows * qw;                    // kKeys x kvw
  float* Ps = KVs + kKeys * kvw;                   // kRows x (kKeys + 1)

  const int tid = threadIdx.x;
  const int b = blockIdx.z, h = blockIdx.y;
  const int hkv = h / (a.H / a.Hkv);
  const int q0 = blockIdx.x * kRows;
  if (tid == 0) {
    int lo_max, hi_min;
    block_keys(a, q0, kRows, &blk_lo, &blk_hi, &lo_max, &hi_min);
  }
  const int n_valid = a.Tq - q0 < kRows ? a.Tq - q0 : kRows;
  const long long q_row = static_cast<long long>(a.H) * hd;
  load_tile<THREADS>(Qs, qw, q + (static_cast<long long>(b) * a.Tq + q0) *
                                     q_row + static_cast<long long>(h) * hd,
                     q_row, kRows, n_valid, hd);
  __syncthreads();

  const int r = tid >> 2;          // this thread's row
  const int sub = tid & 3;         // its quarter of the row's keys/columns
  int lo = 0, hi = 0;
  if (r < n_valid) row_keys(a, q0 + r, &lo, &hi);
  const long long k_base = static_cast<long long>(b) * a.Tk * a.Hkv * hd
                           + static_cast<long long>(hkv) * hd;
  const long long v_base = static_cast<long long>(b) * a.Tk * a.Hkv * hdv
                           + static_cast<long long>(hkv) * hdv;
  const long long k_row = static_cast<long long>(a.Hkv) * hd;
  const long long v_row = static_cast<long long>(a.Hkv) * hdv;
  const int kmin = blk_lo, kmax = blk_hi;

  float m = kNegInf, l = 0.0f;
  float acc[NACC];
#pragma unroll
  for (int i = 0; i < NACC; ++i) acc[i] = 0.0f;

  for (int k0 = kmin; k0 < kmax; k0 += kKeys) {
    __syncthreads();               // the last tile's V and P are consumed
    load_tile<THREADS>(KVs, kvw, k + k_base + k0 * k_row, k_row, kKeys,
                       kmax - k0, hd);
    __syncthreads();

    float s[kKeys / 4];
#pragma unroll
    for (int j = 0; j < kKeys / 4; ++j) s[j] = 0.0f;
    const float* qr = Qs + r * qw;
    for (int d = 0; d < hd; ++d) {
      const float qv = qr[d];
#pragma unroll
      for (int j = 0; j < kKeys / 4; ++j) {
        s[j] += qv * KVs[(sub + 4 * j) * kvw + d];
      }
    }
    float mt = kNegInf;
#pragma unroll
    for (int j = 0; j < kKeys / 4; ++j) {
      const int key = k0 + sub + 4 * j;
      const bool ok = key >= lo && key < hi;
      s[j] = ok ? s[j] * a.scale : kNegInf;
      mt = ok ? fmaxf(mt, s[j]) : mt;
    }
    mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 1));
    mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 2));
    const float m_new = fmaxf(m, mt);
    const float alpha = expf(m - m_new);
    float ls = 0.0f;
#pragma unroll
    for (int j = 0; j < kKeys / 4; ++j) {
      const int key = k0 + sub + 4 * j;
      const float p = (key >= lo && key < hi) ? expf(s[j] - m_new) : 0.0f;
      Ps[r * (kKeys + 1) + sub + 4 * j] = p;
      ls += p;
    }
    ls += __shfl_xor_sync(0xffffffffu, ls, 1);
    ls += __shfl_xor_sync(0xffffffffu, ls, 2);
    l = l * alpha + ls;
    m = m_new;
#pragma unroll
    for (int i = 0; i < NACC; ++i) acc[i] *= alpha;
    __syncthreads();               // K is consumed, P is written

    load_tile<THREADS>(KVs, kvw, v + v_base + k0 * v_row, v_row, kKeys,
                       kmax - k0, hdv);
    __syncthreads();

    const float* pr = Ps + r * (kKeys + 1);
    for (int c = 0; c < kKeys; ++c) {
      const float p = pr[c];
      const float* vr = KVs + c * kvw + sub;
#pragma unroll
      for (int i = 0; i < NACC; ++i) {
        if (sub + 4 * i < hdv) acc[i] += p * vr[4 * i];
      }
    }
  }

  if (r < n_valid) {
    const float denom = fmaxf(l, 1e-30f);
    TQ* orow = o + ((static_cast<long long>(b) * a.Tq + q0 + r) * a.H + h) *
                       hdv;
#pragma unroll
    for (int i = 0; i < NACC; ++i) {
      const int d = sub + 4 * i;
      if (d < hdv) orow[d] = from_f<TQ>(acc[i] / denom);
    }
  }
}

size_t cuda_cores_smem(int hd, int hdv) {
  const int kvw = (hd > hdv ? hd : hdv) + 4;
  return sizeof(float) * (static_cast<size_t>(kRows) * (hd + 4)
                          + static_cast<size_t>(kKeys) * kvw
                          + static_cast<size_t>(kRows) * (kKeys + 1));
}

template <typename TQ, typename TKV, int NACC>
int launch_cuda_cores(const AttnArgs& a, dim3 grid, cudaStream_t stream) {
  const size_t smem = cuda_cores_smem(a.hd, a.hdv);
  cudaError_t err = cudaFuncSetAttribute(
      attn_kernel<TQ, TKV, NACC>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  attn_kernel<TQ, TKV, NACC><<<grid, 4 * kRows, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename TQ, typename TKV>
int launch_cuda_cores_types(const AttnArgs& a, dim3 grid,
                            cudaStream_t stream) {
  if (a.hdv <= 64) return launch_cuda_cores<TQ, TKV, 16>(a, grid, stream);
  if (a.hdv <= 128) return launch_cuda_cores<TQ, TKV, 32>(a, grid, stream);
  return launch_cuda_cores<TQ, TKV, 64>(a, grid, stream);
}

// ========================================================================
// bf16 prefill instance: wgmma on the tensor cores, TMA into a K/V ring
// ========================================================================
constexpr int kWgRows = 64;         // query rows a block: wgmma's M
constexpr int kWgKeys = 64;         // keys a tile: N of S = Q K^T
constexpr int kWgStages = 2;        // K/V tiles in flight
constexpr int kPanel = 64;          // bf16 columns of a 128-byte panel
constexpr int kPanelBytes = 64 * 128;   // one panel of 64 rows
constexpr int kWgThreads = 160;     // consumer warpgroup + producer warp

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(smem_u32(bar)) : "memory");
}

// Waits for the completion of the barrier's phase of parity `parity`.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(addr), "r"(parity) : "memory");
  } while (!done);
}

// One box of a 4-d tensor map (d, head, row, batch) into shared memory;
// completion is counted on `bar` in bytes.
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            int c0, int c1, int c2, int c3,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(smem_u32(bar))
      : "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle; offsets in bytes.
__device__ __forceinline__ uint64_t wg_desc(const void* p, uint32_t lbo,
                                            uint32_t sbo) {
  const uint32_t addr = smem_u32(p);
  uint64_t d = static_cast<uint64_t>((addr & 0x3FFFF) >> 4);
  d |= static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16;
  d |= static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32;
  d |= static_cast<uint64_t>(1) << 62;
  return d;
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keeps the compiler from moving accumulator reads or writes across the
// asynchronous wgmma window.
__device__ __forceinline__ void fence_regs(float (&r)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}

#define WG_D32(d)                                                         \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), \
  "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),            \
  "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),        \
  "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),        \
  "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),        \
  "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),        \
  "+f"(d[31])

#define WG_REGS32                                                         \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "    \
  "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "     \
  "%28, %29, %30, %31}"

// d (64 x 64, fp32) = A B^T (+ d when accumulate), A and B bf16 K-major in
// shared memory.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t desc_a,
                                         uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WG_REGS32
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : WG_D32(d)
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// d (64 x 64, fp32) += A B, A bf16 from registers (the m64k16 fragment),
// B bf16 in shared memory with N contiguous (transposed).
__device__ __forceinline__ void wgmma_rs(float (&d)[32], uint32_t a0,
                                         uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint64_t desc_b) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %37, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WG_REGS32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : WG_D32(d)
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(desc_b), "r"(1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

struct WgArgs {
  AttnArgs a;
  float scale_log2;     // scale * log2(e): the softmax runs on exp2
};

// NVP: 64-column panels of V (hdv <= 64 NVP).  Threads 0-127 are the
// consumer warpgroup, 128-159 the producer warp.
template <int NVP>
__global__ void __launch_bounds__(kWgThreads, 1)
attn_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                  const __grid_constant__ CUtensorMap tm_k,
                  const __grid_constant__ CUtensorMap tm_v, WgArgs w) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bar_q;
  __shared__ __align__(8) uint64_t full_k[kWgStages], full_v[kWgStages],
      empty[kWgStages];
  const AttnArgs& a = w.a;

  // swizzled tiles start on 1,024-byte boundaries (8 rows of 128 bytes)
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const int nqp = (a.hd + kPanel - 1) / kPanel;
  uint8_t* Qs = smem;                                   // nqp panels
  uint8_t* Ks = Qs + nqp * kPanelBytes;                 // stages x nqp
  uint8_t* Vs = Ks + kWgStages * nqp * kPanelBytes;     // stages x NVP

  // heaviest first: the last query tiles of every head, then the earlier
  const int ntq = (a.Tq + kWgRows - 1) / kWgRows;
  const int qt = ntq - 1 - static_cast<int>(blockIdx.x) / a.H;
  const int h = static_cast<int>(blockIdx.x) % a.H;
  const int b = blockIdx.y;
  const int hkv = h / (a.H / a.Hkv);
  const int q0 = qt * kWgRows;
  int kmin, kmax, lo_max, hi_min;
  block_keys(a, q0, kWgRows, &kmin, &kmax, &lo_max, &hi_min);
  const int ntiles = kmax > kmin ? (kmax - kmin + kWgKeys - 1) / kWgKeys : 0;

  if (threadIdx.x == 0) {
    mbar_init(&bar_q, 1);
    for (int s = 0; s < kWgStages; ++s) {
      mbar_init(&full_k[s], 1);
      mbar_init(&full_v[s], 1);
      mbar_init(&empty[s], 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= 128) {
    // ---- producer: one thread issues every copy ------------------------
    if (threadIdx.x == 128) {
      mbar_expect_tx(&bar_q, nqp * kPanelBytes);
      for (int p = 0; p < nqp; ++p) {
        tma_load_4d(Qs + p * kPanelBytes, &tm_q, p * kPanel, h, q0, b,
                    &bar_q);
      }
      for (int t = 0; t < ntiles; ++t) {
        const int s = t % kWgStages;
        if (t >= kWgStages) mbar_wait(&empty[s], ((t / kWgStages) - 1) & 1);
        const int k0 = kmin + t * kWgKeys;
        mbar_expect_tx(&full_k[s], nqp * kPanelBytes);
        for (int p = 0; p < nqp; ++p) {
          tma_load_4d(Ks + (s * nqp + p) * kPanelBytes, &tm_k, p * kPanel,
                      hkv, k0, b, &full_k[s]);
        }
        mbar_expect_tx(&full_v[s], NVP * kPanelBytes);
        for (int p = 0; p < NVP; ++p) {
          tma_load_4d(Vs + (s * NVP + p) * kPanelBytes, &tm_v, p * kPanel,
                      hkv, k0, b, &full_v[s]);
        }
      }
    }
    return;
  }

  // ---- consumer warpgroup: 64 rows, 16 a warp ----------------------------
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int r0 = (tid >> 5) * 16 + (lane >> 2);    // rows r0 and r0 + 8
  int lo[2], hi[2];
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int qi = q0 + r0 + 8 * rr;
    lo[rr] = hi[rr] = 0;
    if (qi < a.Tq) row_keys(a, qi, &lo[rr], &hi[rr]);
  }
  float o[NVP][32];
#pragma unroll
  for (int vp = 0; vp < NVP; ++vp) {
#pragma unroll
    for (int i = 0; i < 32; ++i) o[vp][i] = 0.0f;
  }
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.0f, 0.0f};
  const int ksteps = a.hd / 16;

  mbar_wait(&bar_q, 0);
  for (int t = 0; t < ntiles; ++t) {
    const int s = t % kWgStages;
    const uint32_t par = (t / kWgStages) & 1;
    const int k0 = kmin + t * kWgKeys;

    // S = Q K^T on the tensor cores
    float sc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) sc[i] = 0.0f;
    mbar_wait(&full_k[s], par);
    fence_regs(sc);
    wg_fence();
    const uint8_t* kst = Ks + s * nqp * kPanelBytes;
    for (int kk = 0; kk < ksteps; ++kk) {
      const int off = (kk / 4) * kPanelBytes + (kk % 4) * 32;
      wgmma_ss(sc, wg_desc(Qs + off, 16, 1024), wg_desc(kst + off, 16, 1024),
               kk > 0);
    }
    wg_commit();
    wg_wait_all();
    fence_regs(sc);

    // online softmax on the fragment: register i holds row r0 + 8 ((i/2)%2)
    // and key k0 + 8 (i/4) + 2 (lane%4) + i%2
    const bool full = k0 >= lo_max && k0 + kWgKeys <= hi_min;
    float mt[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int rr = (i >> 1) & 1;
      float x = sc[i] * w.scale_log2;
      if (!full) {
        const int key = k0 + (i >> 2) * 8 + (lane & 3) * 2 + (i & 1);
        x = (key >= lo[rr] && key < hi[rr]) ? x : -CUDART_INF_F;
      }
      sc[i] = x;
      mt[rr] = fmaxf(mt[rr], x);
    }
    float alpha[2];
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      mt[rr] = fmaxf(mt[rr], __shfl_xor_sync(0xffffffffu, mt[rr], 1));
      mt[rr] = fmaxf(mt[rr], __shfl_xor_sync(0xffffffffu, mt[rr], 2));
      const float m_new = fmaxf(m[rr], mt[rr]);   // finite: m starts finite
      alpha[rr] = exp2f(m[rr] - m_new);
      m[rr] = m_new;
      l[rr] *= alpha[rr];
    }
    uint32_t pa[16];
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      const int rr = (i >> 1) & 1;
      const float p0 = exp2f(sc[i] - m[rr]);
      const float p1 = exp2f(sc[i + 1] - m[rr]);
      l[rr] += p0 + p1;
      pa[i >> 1] = pack_bf16(p0, p1);
    }
#pragma unroll
    for (int vp = 0; vp < NVP; ++vp) {
#pragma unroll
      for (int i = 0; i < 32; ++i) o[vp][i] *= alpha[(i >> 1) & 1];
    }

    // O += P V on the tensor cores; V's panels are [key][64 d], 128 bytes
    // a key, read transposed: 8-key groups 1,024 bytes apart, a k-step of
    // 16 keys 2,048 bytes
    mbar_wait(&full_v[s], par);
#pragma unroll
    for (int vp = 0; vp < NVP; ++vp) fence_regs(o[vp]);
    wg_fence();
    const uint8_t* vst = Vs + s * NVP * kPanelBytes;
#pragma unroll
    for (int vp = 0; vp < NVP; ++vp) {
#pragma unroll
      for (int kk = 0; kk < kWgKeys / 16; ++kk) {
        wgmma_rs(o[vp], pa[4 * kk], pa[4 * kk + 1], pa[4 * kk + 2],
                 pa[4 * kk + 3],
                 wg_desc(vst + vp * kPanelBytes + kk * 2048, kPanelBytes,
                         1024));
      }
    }
    wg_commit();
    wg_wait_all();
#pragma unroll
    for (int vp = 0; vp < NVP; ++vp) fence_regs(o[vp]);
    mbar_arrive(&empty[s]);
  }

  // ---- epilogue: normalise and store bf16 pairs ---------------------------
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    l[rr] += __shfl_xor_sync(0xffffffffu, l[rr], 1);
    l[rr] += __shfl_xor_sync(0xffffffffu, l[rr], 2);
    l[rr] = 1.0f / fmaxf(l[rr], 1e-30f);
  }
  __nv_bfloat16* out = static_cast<__nv_bfloat16*>(a.o);
#pragma unroll
  for (int vp = 0; vp < NVP; ++vp) {
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      const int rr = (i >> 1) & 1;
      const int qi = q0 + r0 + 8 * rr;
      const int col = vp * kPanel + (i >> 2) * 8 + (lane & 3) * 2;
      if (qi < a.Tq && col < a.hdv) {
        const long long at =
            ((static_cast<long long>(b) * a.Tq + qi) * a.H + h) * a.hdv + col;
        *reinterpret_cast<__nv_bfloat162*>(out + at) = __floats2bfloat162_rn(
            o[vp][i] * l[rr], o[vp][i + 1] * l[rr]);
      }
    }
  }
}

// cuTensorMapEncodeTiled, reached through the runtime so that the library
// needs no link against the driver library.
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess) {
      fn = reinterpret_cast<EncodeTiledFn>(p);
    }
  }
  return fn;
}

// A (B, T, heads, width) bf16 tensor as a 4-d map (width, heads, T, B)
// with boxes of 64 columns x 1 head x 64 rows, 128-byte swizzle; boxes
// past an end are zero-filled.  Returns 0 or minus the CUresult.
int make_map(CUtensorMap* map, const void* ptr, int B, int T, int heads,
             int width) {
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(width),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(T),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t row = static_cast<cuuint64_t>(width) * 2;
  const cuuint64_t strides[3] = {row, row * heads, row * heads * T};
  const cuuint32_t box[4] = {kPanel, 1, kWgRows, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult res = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                          const_cast<void*>(ptr), dims, strides, box, elem,
                          CU_TENSOR_MAP_INTERLEAVE_NONE,
                          CU_TENSOR_MAP_SWIZZLE_128B,
                          CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                          CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : -static_cast<int>(res);
}

size_t wgmma_smem(int hd, int nvp) {
  const int nqp = (hd + kPanel - 1) / kPanel;
  return 1024 + static_cast<size_t>(kPanelBytes) *
                    (nqp + kWgStages * (nqp + nvp));
}

template <int NVP>
int launch_wgmma_nvp(const WgArgs& w, const CUtensorMap& mq,
                     const CUtensorMap& mk, const CUtensorMap& mv, int B,
                     cudaStream_t stream) {
  const size_t smem = wgmma_smem(w.a.hd, NVP);
  cudaError_t err = cudaFuncSetAttribute(
      attn_wgmma_kernel<NVP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(((w.a.Tq + kWgRows - 1) / kWgRows) * w.a.H, B);
  attn_wgmma_kernel<NVP><<<grid, kWgThreads, smem, stream>>>(mq, mk, mv, w);
  return static_cast<int>(cudaGetLastError());
}

int launch_wgmma(const AttnArgs& a, int B, cudaStream_t stream) {
  if (a.hd % 16 != 0 || a.hdv % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  CUtensorMap mq, mk, mv;
  int err = make_map(&mq, a.q, B, a.Tq, a.H, a.hd);
  if (err == 0) err = make_map(&mk, a.k, B, a.Tk, a.Hkv, a.hd);
  if (err == 0) err = make_map(&mv, a.v, B, a.Tk, a.Hkv, a.hdv);
  if (err != 0) return err;
  const WgArgs w{a, a.scale * 1.4426950408889634f};
  switch ((a.hdv + kPanel - 1) / kPanel) {
    case 1: return launch_wgmma_nvp<1>(w, mq, mk, mv, B, stream);
    case 2: return launch_wgmma_nvp<2>(w, mq, mk, mv, B, stream);
    case 3: return launch_wgmma_nvp<3>(w, mq, mk, mv, B, stream);
    default: return launch_wgmma_nvp<4>(w, mq, mk, mv, B, stream);
  }
}

// ========================================================================
// Decode: one token per request against the cache, split over keys
// ========================================================================
constexpr int kDecThreads = 256;
constexpr int kDecChunk = 32;       // keys a chunk: a warp's lanes
constexpr int kDecStages = 2;       // chunks in the cp.async ring
constexpr int kLanesPerKey = 8;     // lanes sharing one key's dot product

struct DecodeArgs {
  const void* q;
  const void* k;
  const void* v;
  const long long* lens;   // (B,) tokens already in context
  void* o;           // (B, H, hdv), written when nsplit == 1
  float* part_acc;   // (B, H, nsplit, hdv) unnormalised accumulators
  float* part_ml;    // (B, H, nsplit, 2) running max and normaliser
  int S, H, Hkv, hd, hdv, nsplit, split_keys;
  float scale_log2;
};

// Shared-memory layout of a decode block, in bytes from the base.  Lane li
// of a key's 8 takes dims li, li + 8, li + 16, ...; q is kept fp32 as
// [head][e4][lane][4] (its e-th dim of lane li at e4 = e / 4), so a lane
// reads 4 of its dims as one float4 and 8 lanes read 128 contiguous bytes.
// K rows are one 16-byte vector longer than needed, so the 4 keys a warp
// reads at once fall in different banks.
struct DecodeLayout {
  int e4, kp, vp;          // float4s of q a lane, K and V row pitches
  size_t ring, qs, sc, stats, total;
};

template <typename TKV>
__host__ __device__ DecodeLayout decode_layout(int G, int hd, int hdv) {
  DecodeLayout L;
  L.e4 = ((hd + kLanesPerKey - 1) / kLanesPerKey + 3) / 4;
  constexpr int V = 16 / sizeof(TKV);    // elements of a 16-byte copy
  L.kp = (hd + V - 1) / V * V + V;
  L.vp = (hdv + V - 1) / V * V;
  L.ring = 0;
  L.qs = L.ring + static_cast<size_t>(kDecStages) * kDecChunk *
                      (L.kp + L.vp) * sizeof(TKV);
  L.qs = (L.qs + 15) / 16 * 16;
  L.sc = L.qs + static_cast<size_t>(G) * L.e4 * kLanesPerKey * 4 * 4;
  L.stats = L.sc + static_cast<size_t>(G) * kDecChunk * 4;
  L.total = L.stats + static_cast<size_t>(3) * G * 4;
  return L;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(smem_u32(dst)), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// Starts the copy of `rows` cache rows of `width` elements (row stride
// `stride`) into shared memory (pitch `pitch`) and commits it as one group:
// 16 bytes a copy where the rows allow it, else a plain copy.
template <typename T>
__device__ __forceinline__ void issue_rows(T* dst, int pitch,
                                           const T* __restrict__ src,
                                           long long stride, int rows,
                                           int width, bool vec) {
  if (vec) {
    constexpr int V = 16 / sizeof(T);
    const int per_row = width / V;
    for (int idx = threadIdx.x; idx < rows * per_row; idx += kDecThreads) {
      const int r = idx / per_row, c = (idx - r * per_row) * V;
      cp_async16(dst + r * pitch + c, src + r * stride + c);
    }
  } else {
    for (int idx = threadIdx.x; idx < rows * width; idx += kDecThreads) {
      const int r = idx / width, c = idx - r * width;
      dst[r * pitch + c] = src[r * stride + c];
    }
  }
  cp_async_commit();
}

template <typename T>
__device__ __forceinline__ void load2(const T* p, float& x, float& y);
template <>
__device__ __forceinline__ void load2<float>(const float* p, float& x,
                                             float& y) {
  const float2 v = *reinterpret_cast<const float2*>(p);
  x = v.x;
  y = v.y;
}
template <>
__device__ __forceinline__ void load2<__nv_bfloat16>(const __nv_bfloat16* p,
                                                     float& x, float& y) {
  const __nv_bfloat162 v = *reinterpret_cast<const __nv_bfloat162*>(p);
  x = __low2float(v);
  y = __high2float(v);
}

// A decode block's share of the work: request b's keys [s0, hi) of one
// KV head (the split, cut at the valid length), in chunks of kDecChunk.
template <typename TKV>
struct DecodeBlock {
  long long bh0;             // (request, the group's first query head)
  int s0, hi, n_chunks;
  const TKV* kg;             // the KV head's K and V rows of request b
  const TKV* vg;
  long long k_row, v_row;
  bool vec;                  // 16-byte copies allowed
};

template <typename TKV>
__device__ __forceinline__ DecodeBlock<TKV> decode_block(const DecodeArgs& a,
                                                         int G,
                                                         long long len) {
  DecodeBlock<TKV> d;
  const int split = blockIdx.x, hkv = blockIdx.y, b = blockIdx.z;
  d.bh0 = static_cast<long long>(b) * a.H + hkv * G;
  int hi = len + 1 < a.S ? static_cast<int>(len + 1) : a.S;
  d.s0 = split * a.split_keys;
  const int s1 = d.s0 + a.split_keys;
  d.hi = hi < s1 ? hi : s1;
  const int n_keys = d.hi > d.s0 ? d.hi - d.s0 : 0;
  d.n_chunks = (n_keys + kDecChunk - 1) / kDecChunk;
  const long long kv0 = static_cast<long long>(b) * a.S * a.Hkv + hkv;
  d.kg = static_cast<const TKV*>(a.k) + kv0 * a.hd;
  d.vg = static_cast<const TKV*>(a.v) + kv0 * a.hdv;
  d.k_row = static_cast<long long>(a.Hkv) * a.hd;
  d.v_row = static_cast<long long>(a.Hkv) * a.hdv;
  constexpr int V = 16 / sizeof(TKV);
  d.vec = a.hd % V == 0 && a.hdv % V == 0 &&
          (reinterpret_cast<unsigned long long>(a.k) & 15) == 0 &&
          (reinterpret_cast<unsigned long long>(a.v) & 15) == 0;
  return d;
}

// Starts chunk c's K and V rows into ring stage c % kDecStages (two
// groups, empty past the last chunk) and zeros the V rows past its last
// key: P is 0 there, and 0 times what the stage held before could be NaN.
template <typename TKV>
__device__ __forceinline__ void issue_chunk(const DecodeBlock<TKV>& d,
                                            TKV* ring, int kp, int vp,
                                            int hd, int hdv, int c) {
  TKV* ks = ring + (c % kDecStages) * kDecChunk * (kp + vp);
  TKV* vs = ks + kDecChunk * kp;
  const int key0 = d.s0 + c * kDecChunk;
  const int n = c < d.n_chunks ? (d.hi - key0 < kDecChunk ? d.hi - key0
                                                          : kDecChunk) : 0;
  issue_rows(ks, kp, d.kg + key0 * d.k_row, d.k_row, n, hd, d.vec);
  issue_rows(vs, vp, d.vg + key0 * d.v_row, d.v_row, n, hdv, d.vec);
  if (n > 0) {
    for (int idx = threadIdx.x; idx < (kDecChunk - n) * hdv;
         idx += kDecThreads) {
      vs[(n + idx / hdv) * vp + idx % hdv] = from_f<TKV>(0.0f);
    }
  }
}

// q's first 8 x kDecThreads elements of the group, loaded as fp32.
template <typename TQ>
__device__ __forceinline__ void load_q8(const TQ* qg, int nq, float (&x)[8]) {
#pragma unroll
  for (int u = 0; u < 8; ++u) {
    const int idx = threadIdx.x + u * kDecThreads;
    x[u] = idx < nq ? to_f(qg[idx]) : 0.0f;
  }
}

// The online softmax of one chunk of n keys, a warp a head: score(g, key)
// is the scaled score (log2 units), put_p(g, key, p) stores a key's
// probability (0 past n); the head's running max, normaliser and the
// factor that rescales its accumulator go to ms, ls and al.
template <typename Score, typename Put>
__device__ __forceinline__ void chunk_softmax(int G, int n, Score score,
                                              Put put_p, float* ms,
                                              float* ls, float* al) {
  const int lane = threadIdx.x & 31;
  for (int g = threadIdx.x >> 5; g < G; g += kDecThreads / 32) {
    const float s = lane < n ? score(g, lane) : -CUDART_INF_F;
    float mt = s;
#pragma unroll
    for (int x = 16; x > 0; x >>= 1) {
      mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, x));
    }
    const float m_old = ms[g];
    const float m_new = fmaxf(m_old, mt);
    const float p = lane < n ? exp2f(s - m_new) : 0.0f;
    float sum = p;
#pragma unroll
    for (int x = 16; x > 0; x >>= 1) {
      sum += __shfl_xor_sync(0xffffffffu, sum, x);
    }
    put_p(g, lane, p);
    if (lane == 0) {
      const float alpha = exp2f(m_old - m_new);
      al[g] = alpha;
      ls[g] = ls[g] * alpha + sum;
      ms[g] = m_new;
    }
  }
}

// Each head's running max and normaliser for the combine (a split with no
// key writes l = 0).
__device__ __forceinline__ void write_stats(const DecodeArgs& a,
                                            long long bh0, int G,
                                            const float* ms,
                                            const float* ls) {
  for (int g = threadIdx.x; g < G; g += kDecThreads) {
    float* ml = a.part_ml + 2 * ((bh0 + g) * a.nsplit + blockIdx.x);
    ml[0] = ms ? ms[g] : kNegInf;
    ml[1] = ls ? ls[g] : 0.0f;
  }
}

// GM bounds the group's query heads (16 or 64); a thread accumulates P V
// for up to GM / 2 of them.
template <typename TQ, typename TKV, int GM>
__global__ void __launch_bounds__(kDecThreads)
decode_kernel(DecodeArgs a) {
  constexpr int GP = (GM + 1) / 2;   // heads a thread in P V (HS >= 2)
  extern __shared__ __align__(16) uint8_t dec_smem[];
  const int G = a.H / a.Hkv;
  const DecodeLayout L = decode_layout<TKV>(G, a.hd, a.hdv);
  TKV* ring = reinterpret_cast<TKV*>(dec_smem + L.ring);
  float* qs = reinterpret_cast<float*>(dec_smem + L.qs);
  float* sc = reinterpret_cast<float*>(dec_smem + L.sc);
  float* ms = reinterpret_cast<float*>(dec_smem + L.stats);
  float* ls = ms + G;
  float* al = ls + G;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int hd = a.hd, hdv = a.hdv;
  // the length and q's first loads in flight together
  const long long len = a.lens[blockIdx.z];
  const TQ* qg = static_cast<const TQ*>(a.q) +
                 (static_cast<long long>(blockIdx.z) * a.H +
                  blockIdx.y * G) * hd;
  const int nq = G * hd;
  float xq[8];
  load_q8(qg, nq, xq);
  const DecodeBlock<TKV> d = decode_block<TKV>(a, G, len);
  if (d.n_chunks == 0 && a.nsplit > 1) {   // no key here
    write_stats(a, d.bh0, G, nullptr, nullptr);
    return;
  }
  for (int c = 0; c < kDecStages; ++c) {
    issue_chunk(d, ring, L.kp, L.vp, hd, hdv, c);
  }

  // q as fp32 in the lanes' order, zero past hd
  auto put_q = [&](int g, int dim, float x) {
    const int e = dim / kLanesPerKey;
    qs[((g * L.e4 + e / 4) * kLanesPerKey + dim % kLanesPerKey) * 4 +
       e % 4] = x;
  };
#pragma unroll
  for (int u = 0; u < 8; ++u) {
    const int idx = tid + u * kDecThreads;
    if (idx < nq) put_q(idx / hd, idx % hd, xq[u]);
  }
  for (int idx = tid + 8 * kDecThreads; idx < nq; idx += kDecThreads) {
    put_q(idx / hd, idx % hd, to_f(qg[idx]));
  }
  const int qpad = L.e4 * 4 * kLanesPerKey - hd;
  for (int idx = tid; idx < G * qpad; idx += kDecThreads) {
    put_q(idx / qpad, hd + idx % qpad, 0.0f);
  }
  for (int g = tid; g < G; g += kDecThreads) {
    ms[g] = kNegInf;
    ls[g] = 0.0f;
  }

  // P V ownership: columns c0 and c0 + 1, heads hs, hs + HS, ...
  const int pairs = (hdv + 1) / 2;
  const int HS = kDecThreads / pairs;
  const int c0 = 2 * (tid % pairs), hs = tid / pairs;
  const bool pv = hs < HS, c1_ok = c0 + 1 < hdv;
  float acc0[GP], acc1[GP];
#pragma unroll
  for (int i = 0; i < GP; ++i) acc0[i] = acc1[i] = 0.0f;

  const int grp = lane / kLanesPerKey, li = lane % kLanesPerKey;
  for (int c = 0; c < d.n_chunks; ++c) {
    const TKV* ks = ring + (c % kDecStages) * kDecChunk * (L.kp + L.vp);
    const TKV* vs = ks + kDecChunk * L.kp;
    const int key0 = d.s0 + c * kDecChunk;
    const int n = d.hi - key0 < kDecChunk ? d.hi - key0 : kDecChunk;
    cp_async_wait<3>();          // this chunk's K has landed
    __syncthreads();

    // scores: 8 lanes a key, a warp 4 keys, the block the chunk; two
    // heads at a time, two partial sums each
    {
      const int key = warp * (32 / kLanesPerKey) + grp;
      const bool ok = key < n;
      float kr[32];
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        const int d = li + kLanesPerKey * e;
        kr[e] = (ok && e < 4 * L.e4 && d < hd) ? to_f(ks[key * L.kp + d])
                                               : 0.0f;
      }
      const float4* q4 = reinterpret_cast<const float4*>(qs) + li;
      for (int g = 0; g < G; g += 2) {
        const bool two = g + 1 < G;
        float s0a = 0.0f, s0b = 0.0f, s1a = 0.0f, s1b = 0.0f;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          if (j < L.e4) {
            const float4 x = q4[(g * L.e4 + j) * kLanesPerKey];
            s0a += x.x * kr[4 * j] + x.y * kr[4 * j + 1];
            s0b += x.z * kr[4 * j + 2] + x.w * kr[4 * j + 3];
            if (two) {
              const float4 y = q4[((g + 1) * L.e4 + j) * kLanesPerKey];
              s1a += y.x * kr[4 * j] + y.y * kr[4 * j + 1];
              s1b += y.z * kr[4 * j + 2] + y.w * kr[4 * j + 3];
            }
          }
        }
        float s0 = s0a + s0b, s1 = s1a + s1b;
#pragma unroll
        for (int x = 4; x > 0; x >>= 1) {
          s0 += __shfl_xor_sync(0xffffffffu, s0, x);
          s1 += __shfl_xor_sync(0xffffffffu, s1, x);
        }
        if (ok && li == 0) {
          sc[g * kDecChunk + key] = s0 * a.scale_log2;
          if (two) sc[(g + 1) * kDecChunk + key] = s1 * a.scale_log2;
        }
      }
    }
    cp_async_wait<2>();          // this chunk's V has landed
    __syncthreads();

    // online softmax: a warp a head
    chunk_softmax(
        G, n, [&](int g, int key) { return sc[g * kDecChunk + key]; },
        [&](int g, int key, float p) { sc[g * kDecChunk + key] = p; }, ms,
        ls, al);
    __syncthreads();

    // P V: a thread two columns, four keys a step (one float4 of
    // probabilities a head)
    if (pv) {
#pragma unroll
      for (int i = 0; i < GP; ++i) {
        const int g = hs + i * HS;
        if (g < G) {
          acc0[i] *= al[g];
          acc1[i] *= al[g];
        }
      }
      const int n4 = n & ~3;
      for (int key = 0; key < n4; key += 4) {
        float x0[4], x1[4];
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          load2(vs + (key + t) * L.vp + c0, x0[t], x1[t]);
        }
#pragma unroll
        for (int i = 0; i < GP; ++i) {
          const int g = hs + i * HS;
          if (g < G) {
            const float4 p =
                *reinterpret_cast<const float4*>(sc + g * kDecChunk + key);
            acc0[i] += p.x * x0[0] + p.y * x0[1] + p.z * x0[2] + p.w * x0[3];
            acc1[i] += p.x * x1[0] + p.y * x1[1] + p.z * x1[2] + p.w * x1[3];
          }
        }
      }
      for (int key = n4; key < n; ++key) {
        float x0, x1;
        load2(vs + key * L.vp + c0, x0, x1);
#pragma unroll
        for (int i = 0; i < GP; ++i) {
          const int g = hs + i * HS;
          if (g < G) {
            const float p = sc[g * kDecChunk + key];
            acc0[i] += p * x0;
            acc1[i] += p * x1;
          }
        }
      }
    }
    __syncthreads();             // the stage and the scores are free

    issue_chunk(d, ring, L.kp, L.vp, hd, hdv, c + kDecStages);
  }
  cp_async_wait<0>();
  __syncthreads();

  if (pv) {
#pragma unroll
    for (int i = 0; i < GP; ++i) {
      const int g = hs + i * HS;
      if (g >= G) continue;
      if (a.nsplit == 1) {       // one split: the output itself
        TQ* o = static_cast<TQ*>(a.o) + (d.bh0 + g) * hdv + c0;
        const float inv = 1.0f / fmaxf(ls[g], 1e-30f);
        o[0] = from_f<TQ>(acc0[i] * inv);
        if (c1_ok) o[1] = from_f<TQ>(acc1[i] * inv);
      } else {
        float* pa =
            a.part_acc + ((d.bh0 + g) * a.nsplit + blockIdx.x) * hdv + c0;
        pa[0] = acc0[i];
        if (c1_ok) pa[1] = acc1[i];
      }
    }
  }
  if (a.nsplit > 1) write_stats(a, d.bh0, G, ms, ls);
}

// ---- decode on the tensor cores: bf16 cache, hd % 16 == 0, hdv % 8 == 0 ---
// The same blocks, splits, chunks and cp.async ring as decode_kernel; the
// two products run as mma.sync m16n8k16 (bf16 in, fp32 accumulate) with the
// group's query heads as the 16 rows of a tile (G <= 16: one tile).
// S = q K^T: q from shared memory as bf16 (an fp32 q as the sum of two
// bf16 parts, two products, so its accuracy is kept), K read in place.
// O += P V: P rounded to bf16 (as the prefill kernel does), V read in
// place; O stays in registers across the chunks.
constexpr int kScPitch = 40;   // floats a row of scores (bank spread)
constexpr int kPbPitch = 40;   // bf16 a row of probabilities

struct MmaLayout {
  int kp, vp, qp;                       // bf16 row pitches of K, V, q
  size_t ring, qh, ql, sc, pb, stats, total;
};

__host__ __device__ inline MmaLayout mma_layout(int rows, int hd, int hdv,
                                                bool q_lo) {
  MmaLayout L;
  L.kp = hd + 8;                // + 16 bytes: rows fall in other banks
  L.vp = hdv + 8;
  L.qp = hd + 8;
  L.ring = 0;
  L.qh = static_cast<size_t>(kDecStages) * kDecChunk * (L.kp + L.vp) * 2;
  L.ql = L.qh + static_cast<size_t>(rows) * L.qp * 2;
  L.sc = L.ql + (q_lo ? static_cast<size_t>(rows) * L.qp * 2 : 0);
  L.pb = L.sc + static_cast<size_t>(2) * rows * kScPitch * 4;
  L.stats = L.pb + static_cast<size_t>(rows) * kPbPitch * 2;
  L.total = L.stats + static_cast<size_t>(3) * rows * 4;
  return L;
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack2(__nv_bfloat16 lo,
                                          __nv_bfloat16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

// d (16 x 8, fp32) += A (16 x 16, bf16, row-major) B (16 x 8, bf16).
__device__ __forceinline__ void mma_bf16(float (&d)[4], uint32_t a0,
                                         uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// MT: tiles of 16 query heads (G <= 16 MT).
template <typename TQ, int MT>
__global__ void __launch_bounds__(kDecThreads)
decode_mma_kernel(DecodeArgs a) {
  using bf16 = __nv_bfloat16;
  constexpr int R = 16 * MT;                 // head rows, padded
  constexpr bool kLo = sizeof(TQ) == 4;      // fp32 q: a second bf16 part
  constexpr int kNtW = kMaxHead / 8 / (kDecThreads / 32);   // n-tiles a warp
  extern __shared__ __align__(16) uint8_t mma_smem[];
  const int G = a.H / a.Hkv;
  const MmaLayout L = mma_layout(R, a.hd, a.hdv, kLo);
  bf16* ring = reinterpret_cast<bf16*>(mma_smem + L.ring);
  bf16* qh = reinterpret_cast<bf16*>(mma_smem + L.qh);
  bf16* ql = reinterpret_cast<bf16*>(mma_smem + L.ql);
  float* sc = reinterpret_cast<float*>(mma_smem + L.sc);
  bf16* pb = reinterpret_cast<bf16*>(mma_smem + L.pb);
  float* ms = reinterpret_cast<float*>(mma_smem + L.stats);
  float* ls = ms + R;
  float* al = ls + R;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int hd = a.hd, hdv = a.hdv;
  // the length and q's first loads in flight together
  const long long len = a.lens[blockIdx.z];
  const TQ* qg = static_cast<const TQ*>(a.q) +
                 (static_cast<long long>(blockIdx.z) * a.H +
                  blockIdx.y * G) * hd;
  const int nq = G * hd;
  float xq[8];
  load_q8(qg, nq, xq);
  const DecodeBlock<bf16> d = decode_block<bf16>(a, G, len);
  if (d.n_chunks == 0 && a.nsplit > 1) {   // no key here
    write_stats(a, d.bh0, G, nullptr, nullptr);
    return;
  }
  for (int c = 0; c < kDecStages; ++c) {
    issue_chunk(d, ring, L.kp, L.vp, hd, hdv, c);
  }

  // q as bf16 (and an fp32 q's remainder), zero rows past G; P zero; the
  // running statistics
  auto put_q = [&](int idx, float x) {
    const int g = idx / hd, dim = idx - g * hd;
    const bf16 h = __float2bfloat16(x);
    qh[g * L.qp + dim] = h;
    if (kLo) ql[g * L.qp + dim] = __float2bfloat16(x - __bfloat162float(h));
  };
#pragma unroll
  for (int u = 0; u < 8; ++u) {
    const int idx = tid + u * kDecThreads;
    if (idx < nq) put_q(idx, xq[u]);
  }
  for (int idx = tid + 8 * kDecThreads; idx < nq; idx += kDecThreads) {
    put_q(idx, to_f(qg[idx]));
  }
  for (int idx = nq + tid; idx < R * hd; idx += kDecThreads) put_q(idx, 0.0f);
  for (int idx = tid; idx < R * kPbPitch; idx += kDecThreads) {
    pb[idx] = __float2bfloat16(0.0f);
  }
  for (int g = tid; g < R; g += kDecThreads) {
    ms[g] = kNegInf;
    ls[g] = 0.0f;
    al[g] = 0.0f;
  }

  float o[MT][kNtW][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int j = 0; j < kNtW; ++j) {
#pragma unroll
      for (int i = 0; i < 4; ++i) o[mt][j][i] = 0.0f;
    }
  }
  const int n_tiles = (hdv + 7) / 8;
  const int ksteps = hd / 16;

  for (int c = 0; c < d.n_chunks; ++c) {
    const bf16* ks = ring + (c % kDecStages) * kDecChunk * (L.kp + L.vp);
    const bf16* vs = ks + kDecChunk * L.kp;
    const int key0 = d.s0 + c * kDecChunk;
    const int n = d.hi - key0 < kDecChunk ? d.hi - key0 : kDecChunk;
    cp_async_wait<3>();          // this chunk's K has landed
    __syncthreads();

    // S = q K^T: a unit is (head tile, 8 keys, half of the k-steps)
    for (int u = warp; u < MT * 8; u += kDecThreads / 32) {
      const int mt = u / 8, nt = (u / 2) % 4, kh = u % 2;
      float d[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      const int qoff = (mt * 16 + gid) * L.qp + tig * 2;
      const bf16* kb = ks + (nt * 8 + gid) * L.kp + tig * 2;
      for (int kk = kh; kk < ksteps; kk += 2) {
        const int d0 = kk * 16;
        const uint32_t b0 = ld32(kb + d0), b1 = ld32(kb + d0 + 8);
        const bf16* qa = qh + qoff + d0;
        mma_bf16(d, ld32(qa), ld32(qa + 8 * L.qp), ld32(qa + 8),
                 ld32(qa + 8 * L.qp + 8), b0, b1);
        if (kLo) {
          const bf16* qb = ql + qoff + d0;
          mma_bf16(d, ld32(qb), ld32(qb + 8 * L.qp), ld32(qb + 8),
                   ld32(qb + 8 * L.qp + 8), b0, b1);
        }
      }
      float* sp = sc + (kh * R + mt * 16 + gid) * kScPitch + nt * 8 + tig * 2;
      *reinterpret_cast<float2*>(sp) = make_float2(d[0], d[1]);
      *reinterpret_cast<float2*>(sp + 8 * kScPitch) = make_float2(d[2], d[3]);
    }
    cp_async_wait<2>();          // this chunk's V has landed
    __syncthreads();

    // online softmax: a warp a head; P to bf16
    chunk_softmax(
        G, n,
        [&](int g, int key) {
          return (sc[g * kScPitch + key] + sc[(R + g) * kScPitch + key]) *
                 a.scale_log2;
        },
        [&](int g, int key, float p) {
          pb[g * kPbPitch + key] = __float2bfloat16(p);
        },
        ms, ls, al);
    __syncthreads();

    // O = O alpha + P V: warp w owns output columns of n-tiles w, w + 8, ..
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const float a_lo = al[mt * 16 + gid], a_hi = al[mt * 16 + gid + 8];
#pragma unroll
      for (int j = 0; j < kNtW; ++j) {
        o[mt][j][0] *= a_lo;
        o[mt][j][1] *= a_lo;
        o[mt][j][2] *= a_hi;
        o[mt][j][3] *= a_hi;
      }
    }
#pragma unroll
    for (int kk = 0; kk < kDecChunk / 16; ++kk) {
      const int k0 = kk * 16;
      uint32_t pa[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const bf16* pr = pb + (mt * 16 + gid) * kPbPitch + k0 + tig * 2;
        pa[mt][0] = ld32(pr);
        pa[mt][1] = ld32(pr + 8 * kPbPitch);
        pa[mt][2] = ld32(pr + 8);
        pa[mt][3] = ld32(pr + 8 * kPbPitch + 8);
      }
#pragma unroll
      for (int j = 0; j < kNtW; ++j) {
        const int nt = warp + j * (kDecThreads / 32);
        if (nt < n_tiles) {
          const bf16* vb = vs + (k0 + tig * 2) * L.vp + nt * 8 + gid;
          const uint32_t b0 = pack2(vb[0], vb[L.vp]);
          const uint32_t b1 = pack2(vb[8 * L.vp], vb[9 * L.vp]);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            mma_bf16(o[mt][j], pa[mt][0], pa[mt][1], pa[mt][2], pa[mt][3],
                     b0, b1);
          }
        }
      }
    }
    __syncthreads();             // the stage, scores and P are free
    issue_chunk(d, ring, L.kp, L.vp, hd, hdv, c + kDecStages);
  }
  cp_async_wait<0>();
  __syncthreads();

#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int j = 0; j < kNtW; ++j) {
      const int col = (warp + j * (kDecThreads / 32)) * 8 + tig * 2;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int g = mt * 16 + gid + 8 * half;
        if (g >= G || col >= hdv) continue;
        const float v0 = o[mt][j][2 * half], v1 = o[mt][j][2 * half + 1];
        if (a.nsplit == 1) {     // one split: the output itself
          TQ* out = static_cast<TQ*>(a.o) + (d.bh0 + g) * hdv + col;
          const float inv = 1.0f / fmaxf(ls[g], 1e-30f);
          out[0] = from_f<TQ>(v0 * inv);
          if (col + 1 < hdv) out[1] = from_f<TQ>(v1 * inv);
        } else {
          float* pa =
              a.part_acc + ((d.bh0 + g) * a.nsplit + blockIdx.x) * hdv + col;
          pa[0] = v0;
          if (col + 1 < hdv) pa[1] = v1;
        }
      }
    }
  }
  if (a.nsplit > 1) write_stats(a, d.bh0, G, ms, ls);
}

// Decode, second pass: a block per (request, query head, 64 output
// columns), 4 groups of 64 threads over the splits.  One warp reads every
// split's running max and normaliser once and weighs the splits that hold
// keys (l > 0, a prefix of them) into shared memory against their largest
// max; each thread sums a quarter of those splits for its column, 8 loads
// in flight, and the quarters are added in shared memory.
constexpr int kMaxSplits = 4096;
constexpr int kCombineCols = 64;
constexpr int kCombineGroups = kDecThreads / kCombineCols;

template <typename TQ>
__global__ void __launch_bounds__(kDecThreads)
decode_combine_kernel(const float* __restrict__ part_acc,
                      const float* __restrict__ part_ml, TQ* __restrict__ o,
                      int nsplit, int hdv) {
  __shared__ float wt[kMaxSplits], lt[kMaxSplits];
  __shared__ float red[kCombineGroups][kCombineCols];
  __shared__ float total;
  __shared__ int used;
  const long long bh = blockIdx.x;
  const float2* ml = reinterpret_cast<const float2*>(part_ml) + bh * nsplit;
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    float M = kNegInf;
    int n = 0;
    for (int s = lane; s < nsplit; s += 32) {
      const float2 x = ml[s];
      wt[s] = x.x;
      lt[s] = x.y;
      if (x.y > 0.0f) {
        M = fmaxf(M, x.x);
        ++n;
      }
    }
#pragma unroll
    for (int x = 16; x > 0; x >>= 1) {
      M = fmaxf(M, __shfl_xor_sync(0xffffffffu, M, x));
      n += __shfl_xor_sync(0xffffffffu, n, x);
    }
    float L = 0.0f;
    for (int s = lane; s < n; s += 32) {
      const float w = exp2f(wt[s] - M);
      wt[s] = w;
      L += lt[s] * w;
    }
#pragma unroll
    for (int x = 16; x > 0; x >>= 1) {
      L += __shfl_xor_sync(0xffffffffu, L, x);
    }
    if (lane == 0) {
      total = fmaxf(L, 1e-30f);
      used = n;
    }
  }
  __syncthreads();
  const int c = threadIdx.x % kCombineCols, grp = threadIdx.x / kCombineCols;
  const int d = blockIdx.y * kCombineCols + c;
  float acc = 0.0f;
  if (d < hdv) {
    const float* pa = part_acc + bh * nsplit * hdv + d;
#pragma unroll 8
    for (int s = grp; s < used; s += kCombineGroups) {
      acc += pa[static_cast<long long>(s) * hdv] * wt[s];
    }
  }
  red[grp][c] = acc;
  __syncthreads();
  if (grp == 0 && d < hdv) {
#pragma unroll
    for (int g = 1; g < kCombineGroups; ++g) acc += red[g][c];
    o[bh * hdv + d] = from_f<TQ>(acc / total);
  }
}

// The second pass, when there is more than one split.
template <typename TQ>
int launch_combine(const DecodeArgs& a, int B, cudaStream_t st) {
  if (a.nsplit == 1) return 0;
  const dim3 grid(B * a.H, (a.hdv + kCombineCols - 1) / kCombineCols);
  decode_combine_kernel<TQ><<<grid, kDecThreads, 0, st>>>(
      a.part_acc, a.part_ml, static_cast<TQ*>(a.o), a.nsplit, a.hdv);
  return static_cast<int>(cudaGetLastError());
}

template <typename Kernel>
int launch_decode_kernel(Kernel kernel, size_t smem, const DecodeArgs& a,
                         int B, cudaStream_t st) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3(a.nsplit, a.Hkv, B), kDecThreads, smem, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// mma != 0: the tensor-core instance (the caller checked that it takes the
// call), else the CUDA-core one.
template <typename TQ, typename TKV>
int launch_decode_types(const DecodeArgs& a, int mma, int B,
                        cudaStream_t st) {
  const int G = a.H / a.Hkv;
  int err;
  if (mma) {
    const int mt = (G + 15) / 16;
    const size_t smem = mma_layout(16 * (mt > 2 ? 4 : mt), a.hd, a.hdv,
                                   sizeof(TQ) == 4).total;
    if (mt == 1) {
      err = launch_decode_kernel(decode_mma_kernel<TQ, 1>, smem, a, B, st);
    } else if (mt == 2) {
      err = launch_decode_kernel(decode_mma_kernel<TQ, 2>, smem, a, B, st);
    } else {
      err = launch_decode_kernel(decode_mma_kernel<TQ, 4>, smem, a, B, st);
    }
  } else {
    const size_t smem = decode_layout<TKV>(G, a.hd, a.hdv).total;
    err = G <= 16
        ? launch_decode_kernel(decode_kernel<TQ, TKV, 16>, smem, a, B, st)
        : launch_decode_kernel(decode_kernel<TQ, TKV, 64>, smem, a, B, st);
  }
  return err != 0 ? err : launch_combine<TQ>(a, B, st);
}

}  // namespace

// q (B, Tq, H, hd), k (B, Tk, Hkv, hd), v (B, Tk, Hkv, hdv), o (B, Tq, H,
// hdv), all contiguous.  Row i of the queries sits at position
// q_offset + i; it attends to key j when j <= position (causal) and
// j > position - window (window > 0).  wgmma != 0 takes the tensor-core
// instance (bf16 q, k, v; hd and hdv multiples of 16; 16-byte aligned
// bases), else the CUDA-core one; the caller decides.
extern "C" int repro_flash_attention(
    const void* q, const void* k, const void* v, void* o, int q_bf16,
    int kv_bf16, int wgmma, int B, int Tq, int Tk, int H, int Hkv, int hd,
    int hdv, int causal, int window, int q_offset, float scale,
    void* stream) {
  if (B == 0 || Tq == 0 || H == 0) return 0;
  if (hd < 1 || hd > kMaxHead || hdv < 1 || hdv > kMaxHead || Hkv < 1 ||
      H % Hkv != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const AttnArgs a{q, k, v, o, Tq, Tk, H, Hkv, hd, hdv, causal, window,
                   q_offset, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (wgmma) {
    if (!q_bf16 || !kv_bf16) return static_cast<int>(cudaErrorInvalidValue);
    return launch_wgmma(a, B, st);
  }
  const dim3 grid((Tq + kRows - 1) / kRows, H, B);
  if (q_bf16 && kv_bf16)
    return launch_cuda_cores_types<__nv_bfloat16, __nv_bfloat16>(a, grid, st);
  if (q_bf16) return launch_cuda_cores_types<__nv_bfloat16, float>(a, grid, st);
  if (kv_bf16)
    return launch_cuda_cores_types<float, __nv_bfloat16>(a, grid, st);
  return launch_cuda_cores_types<float, float>(a, grid, st);
}

// q (B, H, hd), k (B, S, Hkv, hd), v (B, S, Hkv, hdv), lens (B,) int64,
// o (B, H, hdv); scratch part_acc (B, H, nsplit, hdv) and part_ml (B, H,
// nsplit, 2) fp32, with nsplit * split_keys >= S (unused when nsplit is
// 1).  Request b attends to cache slots < min(lens[b] + 1, S).  G = H /
// Hkv must be at most 64.  mma != 0 takes the tensor-core instance (a bf16
// cache, hd a multiple of 16, hdv of 8), else the CUDA-core one; the caller
// decides.
extern "C" int repro_flash_decode(
    const void* q, const void* k, const void* v, const long long* lens,
    void* o, void* part_acc, void* part_ml, int q_bf16, int kv_bf16, int mma,
    int B, int S, int H, int Hkv, int hd, int hdv, int nsplit,
    int split_keys, float scale, void* stream) {
  if (B == 0 || H == 0) return 0;
  if (hd < 1 || hd > kMaxHead || hdv < 1 || hdv > kMaxHead || Hkv < 1 ||
      H % Hkv != 0 || H / Hkv > 64 || nsplit < 1 || nsplit > kMaxSplits ||
      split_keys < 1 || static_cast<long long>(nsplit) * split_keys < S ||
      (mma && (!kv_bf16 || hd % 16 != 0 || hdv % 8 != 0))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const DecodeArgs a{q, k, v, lens, o, static_cast<float*>(part_acc),
                     static_cast<float*>(part_ml), S, H, Hkv, hd, hdv,
                     nsplit, split_keys, scale * 1.4426950408889634f};
  if (q_bf16 && kv_bf16)
    return launch_decode_types<__nv_bfloat16, __nv_bfloat16>(a, mma, B, st);
  if (q_bf16) return launch_decode_types<__nv_bfloat16, float>(a, mma, B, st);
  if (kv_bf16)
    return launch_decode_types<float, __nv_bfloat16>(a, mma, B, st);
  return launch_decode_types<float, float>(a, mma, B, st);
}
