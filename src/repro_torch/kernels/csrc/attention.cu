// Hopper kernels of the serving path's attention: flash attention (prefill)
// and flash decode (one new token against a KV cache).
//
// They replace the JAX package's Pallas kernels in
// kernels/flash_attention.py: flash_attention / _attn_kernel (prefill) and
// flash_decode / _decode_kernel (decode).  The plain PyTorch versions beside
// them are repro_torch.models.layers.chunked_attention and
// decode_attention.
//
// One kernel serves both.  A block owns up to ROWS query rows that share
// one K/V head, and every row attends to a contiguous key interval
// [lo, hi): the causal mask, the sliding window and a cache's valid length
// are all such intervals.  In prefill the rows are 64 consecutive positions
// of one query head; in decode they are the G query heads of one KV head at
// the new token (the TPU kernel's GQA grouping), in blocks of 16 rows when
// G <= 16, so the cache is read once per group.  In decode the keys are also split into chunks, one block
// each, so that a few requests still fill the card (flash-decoding): every
// block writes its rows' unnormalised accumulator with their running max
// and normaliser, and a second kernel combines the chunks.  Blocks run in
// parallel with nothing carried between them: a
// block loops over the key tiles its rows need, from the smallest lo to the
// largest hi, and skips every tile outside them.  Masked keys get a zero
// probability, so no tile that is fully masked for a row changes it (the
// TPU kernel reaches the same result through exp(-1e30 - m) = 0).
//
// Per key tile: the K tile goes to shared memory as fp32 (16-byte loads),
// each row's
// scores are computed by 4 threads (8 keys each), the online softmax
// updates the row's running max m, normaliser l and fp32 accumulator
// (kept in registers: 4 threads x NACC columns per row), then the V tile
// replaces K in the same buffer and the accumulator takes P V.  Row
// statistics and the accumulator are fp32 whatever the input types; q and
// the K/V tensors take fp32 or bf16 independently (decode runs an fp32 q
// against the default bf16 cache without copying the cache); the output
// has q's type.
//
// What bounds it on the H100: prefill at the slice's shapes does ~4*hd
// flops per (row, key) pair and moves each q/k/v element once, so it is
// bound by operations; this kernel runs them as fp32 FMAs on the CUDA
// cores, one shared-memory load per FMA, which caps it well below the
// 67 TFLOP/s fp32 rate (tensor cores via wgmma are later work).  Decode
// reads the valid cache rows once per KV head and is bound by bytes; the
// split over keys puts about one block on every SM whatever the batch.
//
// Plain C interface for ctypes: every entry point launches on the stream
// it is given, allocates nothing, does not synchronise, and returns the
// CUDA error of the launch (0 on success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kPrefillRows = 64;  // query rows per block in prefill
constexpr int kDecodeRows = 16;   // ... in decode, for groups of <= 16 heads
constexpr int kKeys = 32;       // keys per tile
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

// Copies a rows x width tile (row stride `stride` elements; rows at or past
// `valid` are zero-filled) from device memory into shared memory as fp32,
// row pitch `pitch`.  Where the tile allows it (width and stride multiples
// of a 16-byte vector, aligned bases, a pitch that keeps float4 stores
// aligned) every thread moves 16 bytes at a time, so a few independent
// loads per thread fill the tile; otherwise one element at a time.
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
  const int* lens;   // decode: (B,) tokens already in context; else null
  float* part_acc;   // decode: (B, H, nsplit, hdv) unnormalised accumulators
  float* part_ml;    // decode: (B, H, nsplit, 2) running max and normaliser
  int Tq, Tk, H, Hkv, hd, hdv;
  int causal, window, q_offset;
  int split_keys;    // decode: keys per split
  float scale;
};

// ROWS query rows a block, 4 threads a row.
template <typename TQ, typename TKV, int NACC, int ROWS>
__global__ void __launch_bounds__(4 * ROWS)
attn_kernel(AttnArgs a) {
  constexpr int THREADS = 4 * ROWS;
  extern __shared__ __align__(16) float smem[];
  __shared__ int row_lo[ROWS], row_hi[ROWS];
  __shared__ long long row_q[ROWS], row_o[ROWS], row_p[ROWS];
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
  float* Qs = smem;                                // ROWS x qw
  float* KVs = Qs + ROWS * qw;                     // kKeys x kvw
  float* Ps = KVs + kKeys * kvw;                   // ROWS x (kKeys + 1)

  const int tid = threadIdx.x;
  const int b = blockIdx.z;
  const int G = a.H / a.Hkv;
  const bool decode = a.lens != nullptr;
  const int hkv = decode ? blockIdx.y : blockIdx.y / G;

  // ---- the block's rows: q/o offsets and key intervals ------------------
  if (tid < ROWS) {
    int lo = 0, hi = 0;
    long long qo = -1, oo = -1, po = -1;
    if (decode) {
      // blockIdx.x is the key split; the rows are the group's G <= ROWS
      // query heads
      if (tid < G) {
        const int h = hkv * G + tid;
        const int len = a.lens[b];
        const int s0 = blockIdx.x * a.split_keys;
        const int s1 = s0 + a.split_keys;
        hi = len + 1 < a.Tk ? len + 1 : a.Tk;
        hi = hi < s1 ? hi : s1;
        lo = s0;
        hi = hi > lo ? hi : lo;
        qo = (static_cast<long long>(b) * a.H + h) * hd;
        po = (static_cast<long long>(b) * a.H + h) * gridDim.x + blockIdx.x;
        oo = po * hdv;
      }
    } else {
      const int qi = blockIdx.x * ROWS + tid;
      if (qi < a.Tq) {
        const int h = blockIdx.y;
        const int pos = a.q_offset + qi;
        lo = a.window > 0 ? pos - a.window + 1 : 0;
        lo = lo > 0 ? lo : 0;
        hi = a.causal ? (pos + 1 < a.Tk ? pos + 1 : a.Tk) : a.Tk;
        hi = hi > lo ? hi : lo;
        const long long rq = (static_cast<long long>(b) * a.Tq + qi) * a.H + h;
        qo = rq * hd;
        oo = rq * hdv;
      }
    }
    row_lo[tid] = lo;
    row_hi[tid] = hi;
    row_q[tid] = qo;
    row_o[tid] = oo;
    row_p[tid] = po;
  }
  __syncthreads();
  if (tid == 0) {
    int lo = a.Tk, hi = 0;
    for (int r = 0; r < ROWS; ++r) {
      if (row_hi[r] > row_lo[r]) {
        lo = row_lo[r] < lo ? row_lo[r] : lo;
        hi = row_hi[r] > hi ? row_hi[r] : hi;
      }
    }
    blk_lo = lo;
    blk_hi = hi;
  }
  // the block's query rows are evenly spaced and valid from the first on
  {
    const long long q_row = decode ? hd : static_cast<long long>(a.H) * hd;
    int n_valid = 0;
    while (n_valid < ROWS && row_q[n_valid] >= 0) ++n_valid;
    load_tile<THREADS>(Qs, qw, q + (n_valid ? row_q[0] : 0), q_row, ROWS,
                       n_valid, hd);
  }
  __syncthreads();

  const int r = tid >> 2;          // this thread's row
  const int sub = tid & 3;         // its quarter of the row's keys/columns
  const int lo = row_lo[r], hi = row_hi[r];
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

  if (row_o[r] >= 0 && decode) {
    float* prow = a.part_acc + row_o[r];
#pragma unroll
    for (int i = 0; i < NACC; ++i) {
      const int d = sub + 4 * i;
      if (d < hdv) prow[d] = acc[i];
    }
    if (sub == 0) {
      a.part_ml[2 * row_p[r]] = m;
      a.part_ml[2 * row_p[r] + 1] = l;
    }
  } else if (row_o[r] >= 0) {
    const float denom = fmaxf(l, 1e-30f);
    TQ* orow = o + row_o[r];
#pragma unroll
    for (int i = 0; i < NACC; ++i) {
      const int d = sub + 4 * i;
      if (d < hdv) orow[d] = from_f<TQ>(acc[i] / denom);
    }
  }
}

// Decode, second pass: one block per (request, query head), one thread per
// output column; rescales every split's accumulator and normaliser to the
// largest running max and divides.  A split with no valid key (l = 0)
// contributes nothing.
template <typename TQ>
__global__ void decode_combine_kernel(const float* __restrict__ part_acc,
                                      const float* __restrict__ part_ml,
                                      TQ* __restrict__ o, int nsplit,
                                      int hdv) {
  const long long bh = blockIdx.x;
  const int d = threadIdx.x;
  const float* ml = part_ml + bh * nsplit * 2;
  float M = kNegInf;
  for (int s = 0; s < nsplit; ++s) {
    if (ml[2 * s + 1] > 0.0f) M = fmaxf(M, ml[2 * s]);
  }
  float L = 0.0f, acc = 0.0f;
  for (int s = 0; s < nsplit; ++s) {
    const float l = ml[2 * s + 1];
    const float w = l > 0.0f ? expf(ml[2 * s] - M) : 0.0f;
    L += l * w;
    acc += part_acc[(bh * nsplit + s) * hdv + d] * w;
  }
  o[bh * hdv + d] = from_f<TQ>(acc / fmaxf(L, 1e-30f));
}

size_t smem_bytes(int rows, int hd, int hdv) {
  const int kvw = (hd > hdv ? hd : hdv) + 4;
  return sizeof(float) * (static_cast<size_t>(rows) * (hd + 4)
                          + static_cast<size_t>(kKeys) * kvw
                          + static_cast<size_t>(rows) * (kKeys + 1));
}

template <typename TQ, typename TKV, int NACC, int ROWS>
int launch_rows(const AttnArgs& a, dim3 grid, cudaStream_t stream) {
  const size_t smem = smem_bytes(ROWS, a.hd, a.hdv);
  cudaError_t err = cudaFuncSetAttribute(
      attn_kernel<TQ, TKV, NACC, ROWS>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  attn_kernel<TQ, TKV, NACC, ROWS><<<grid, 4 * ROWS, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename TQ, typename TKV, int NACC>
int launch_nacc(const AttnArgs& a, int rows, dim3 grid, cudaStream_t stream) {
  if (rows == kDecodeRows)
    return launch_rows<TQ, TKV, NACC, kDecodeRows>(a, grid, stream);
  return launch_rows<TQ, TKV, NACC, kPrefillRows>(a, grid, stream);
}

template <typename TQ, typename TKV>
int launch_types(const AttnArgs& a, int rows, dim3 grid,
                 cudaStream_t stream) {
  if (a.hdv <= 64) return launch_nacc<TQ, TKV, 16>(a, rows, grid, stream);
  if (a.hdv <= 128) return launch_nacc<TQ, TKV, 32>(a, rows, grid, stream);
  return launch_nacc<TQ, TKV, 64>(a, rows, grid, stream);
}

int launch(const AttnArgs& a, int rows, int q_bf16, int kv_bf16, dim3 grid,
           cudaStream_t stream) {
  if (a.hd < 1 || a.hd > kMaxHead || a.hdv < 1 || a.hdv > kMaxHead ||
      a.Hkv < 1 || a.H % a.Hkv != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (q_bf16 && kv_bf16)
    return launch_types<__nv_bfloat16, __nv_bfloat16>(a, rows, grid, stream);
  if (q_bf16)
    return launch_types<__nv_bfloat16, float>(a, rows, grid, stream);
  if (kv_bf16)
    return launch_types<float, __nv_bfloat16>(a, rows, grid, stream);
  return launch_types<float, float>(a, rows, grid, stream);
}

}  // namespace

// q (B, Tq, H, hd), k (B, Tk, Hkv, hd), v (B, Tk, Hkv, hdv), o (B, Tq, H,
// hdv), all contiguous.  Row i of the queries sits at position
// q_offset + i; it attends to key j when j <= position (causal) and
// j > position - window (window > 0).
extern "C" int repro_flash_attention(
    const void* q, const void* k, const void* v, void* o, int q_bf16,
    int kv_bf16, int B, int Tq, int Tk, int H, int Hkv, int hd, int hdv,
    int causal, int window, int q_offset, float scale, void* stream) {
  if (B == 0 || Tq == 0 || H == 0) return 0;
  AttnArgs a{q, k, v, o, nullptr, nullptr, nullptr, Tq, Tk, H, Hkv, hd, hdv,
             causal, window, q_offset, 0, scale};
  const dim3 grid((Tq + kPrefillRows - 1) / kPrefillRows, H, B);
  return launch(a, kPrefillRows, q_bf16, kv_bf16, grid,
                static_cast<cudaStream_t>(stream));
}

// q (B, H, hd), k (B, S, Hkv, hd), v (B, S, Hkv, hdv), lens (B,) int32,
// o (B, H, hdv); scratch part_acc (B, H, nsplit, hdv) and part_ml (B, H,
// nsplit, 2) fp32, with nsplit * split_keys >= S.  Request b attends to
// cache slots < min(lens[b] + 1, S).  G = H / Hkv must be at most 64; a
// group of at most 16 heads runs in blocks of 16 rows (64 threads), so
// padding rows do not multiply the work, and several blocks share an SM.
extern "C" int repro_flash_decode(
    const void* q, const void* k, const void* v, const int* lens, void* o,
    void* part_acc, void* part_ml, int q_bf16, int kv_bf16, int B, int S,
    int H, int Hkv, int hd, int hdv, int nsplit, int split_keys, float scale,
    void* stream) {
  if (B == 0 || H == 0) return 0;
  if (Hkv < 1 || H / Hkv > kPrefillRows || nsplit < 1 ||
      static_cast<long long>(nsplit) * split_keys < S) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  AttnArgs a{q, k, v, o, lens, static_cast<float*>(part_acc),
             static_cast<float*>(part_ml), 1, S, H, Hkv, hd, hdv, 0, 0, 0,
             split_keys, scale};
  const int rows = H / Hkv <= kDecodeRows ? kDecodeRows : kPrefillRows;
  int err = launch(a, rows, q_bf16, kv_bf16, dim3(nsplit, Hkv, B), st);
  if (err != 0) return err;
  const float* pa = static_cast<const float*>(part_acc);
  const float* pm = static_cast<const float*>(part_ml);
  if (q_bf16) {
    decode_combine_kernel<__nv_bfloat16><<<B * H, hdv, 0, st>>>(
        pa, pm, static_cast<__nv_bfloat16*>(o), nsplit, hdv);
  } else {
    decode_combine_kernel<float><<<B * H, hdv, 0, st>>>(
        pa, pm, static_cast<float*>(o), nsplit, hdv);
  }
  return static_cast<int>(cudaGetLastError());
}
