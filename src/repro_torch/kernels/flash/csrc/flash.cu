// Flash-attention forward for Hopper (sm_90a), hand-written CUDA.
//
// Replaces src/repro/kernels/flash/kernel.py: _flash_kernel (l.35, via
// flash_call l.76 and ops.py:flash_attention l.16) with flash_fwd.
//
// Computes, per batch b and query head h, softmax(q k^T / sqrt(hd)) v over
// the keys and values of KV head h / (H / Hkv) (grouped-query attention),
// with the causal mask top-left aligned (query i sees keys j <= i) and
// masked scores at -1e30, as repro_torch/kernels/flash/ref.py does.  The
// tensors are read where they lie: q and o are (B, S, H, hd), k and v
// (B, Sk, Hkv, hd), each with its own batch, sequence and head strides in
// elements and the head dim contiguous; flash_call's (BH, S, hd) panels are
// the case H = Hkv = 1.  Types: f32 or bf16 in, the same type out
// (round-to-nearest-even for bf16); the arithmetic is f32 throughout.
//
// The algorithm is the TPU kernel's: one query tile stays on chip while
// the K/V tiles of its head stream past it, with an f32 online softmax per
// query row (running max m, running sum l, accumulator rescaled by
// exp(m_old - m_new)); q is multiplied by the scale after its f32 cast,
// and the output is acc / max(l, 1e-30).  For causal attention the loop
// stops at the diagonal: a query tile whose last row is r reads the
// ceil((r + 1) / TK) key tiles that row can see.  (The TPU kernel's bound,
// (iq+1)*tq//tk + (tq//tk > 0), drops key tiles when tq < tk.)  The kernel
// tiles at its own TQ x TK, whatever the caller's tq / tk, and masks
// ragged edges itself, so the answer does not depend on tq / tk.
//
// What bounds it on this card: the two products, 4 * hd flops per visible
// (query, key) pair, at 989 TFLOP/s in bf16 on the tensor cores or 67
// TFLOP/s in f32 off them; the bytes (q, k, v read once, o written once)
// are far below that at these head dims.  This first design is simple:
// CUDA-core FMAs in f32 for both types (no TF32, which would break the
// reference's 2e-5 tolerance in f32; no mma.sync for bf16 either: one
// code path for both types now, and the tensor-core design for Hopper,
// wgmma fed by TMA with warp specialisation, is the redesign that comes
// next).  One CTA of 256 threads per (query tile, b, h), the heaviest
// causal tiles launched first.  The query tile (scaled, in f32) stays in
// shared memory; each K/V tile is converted to f32 in shared memory; each
// thread holds a 4 x (TK / 16) block of scores and a 4 x (hd / 16) block
// of the accumulator, the rows' statistics reduced across the 16 lanes
// that share them by warp shuffles; the probabilities go through shared
// memory to the P V product.  Row strides of HD + 4 floats keep the
// 16-byte reads of K free of bank conflicts.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 256;

template <int HD>
struct Tile {
  static constexpr int TQ = 64;                 // query rows of a CTA
  static constexpr int TK = HD >= 128 ? 32 : 64;  // key rows of a step
  static constexpr int RM = TQ / 16;            // query rows of a thread
  static constexpr int CN = TK / 16;            // score columns of a thread
  static constexpr int DV = HD >= 32 ? 2 : 1;   // adjacent output columns
  static constexpr int DN = HD / (16 * DV);     // output column groups
  static constexpr int QS = HD + 4;             // Q / K row stride (floats)
  static constexpr int VS = HD;                 // V row stride
  static constexpr int PS = TK + 4;             // P row stride
  static constexpr int SMEM_FLOATS = TQ * QS + TK * QS + TK * VS + TQ * PS;
  static_assert(HD % 16 == 0, "head dim must be a multiple of 16");
};

struct Strides {  // in elements
  long long b, s, h;
};

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  Strides sq, sk, sv, so;
  int batch, seq_q, seq_k, heads, group;  // group = H / Hkv
  int causal;
  float scale;
};

__device__ __forceinline__ void store8(float* dst, const float* x) {
  reinterpret_cast<float4*>(dst)[0] = make_float4(x[0], x[1], x[2], x[3]);
  reinterpret_cast<float4*>(dst)[1] = make_float4(x[4], x[5], x[6], x[7]);
}

// One 16-byte vector of T -> floats (times mul) in shared memory at dst.
__device__ __forceinline__ void load16(const float* src, float* dst,
                                       float mul, bool live) {
  float4 x = live ? *reinterpret_cast<const float4*>(src)
                  : make_float4(0.f, 0.f, 0.f, 0.f);
  *reinterpret_cast<float4*>(dst) =
      make_float4(x.x * mul, x.y * mul, x.z * mul, x.w * mul);
}

__device__ __forceinline__ void load16(const __nv_bfloat16* src, float* dst,
                                       float mul, bool live) {
  float x[8];
  if (live) {
    const uint4 raw = *reinterpret_cast<const uint4*>(src);
    const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 f = __bfloat1622float2(p[e]);
      x[2 * e] = f.x * mul;
      x[2 * e + 1] = f.y * mul;
    }
  } else {
#pragma unroll
    for (int e = 0; e < 8; ++e) x[e] = 0.f;
  }
  store8(dst, x);
}

// rows [row0, row0 + rows) of one head's (seq, HD) panel at base -> f32
// shared memory (row stride ld), scaled by mul; rows at or past seq are 0.
template <typename T, int HD>
__device__ __forceinline__ void load_tile(const T* base, long long stride,
                                          int row0, int rows, int seq,
                                          float* dst, int ld, float mul) {
  constexpr int kVec = 16 / sizeof(T);  // elements per 16-byte vector
  constexpr int kPerRow = HD / kVec;
  for (int i = threadIdx.x; i < rows * kPerRow; i += kThreads) {
    const int r = i / kPerRow;
    const int c = (i % kPerRow) * kVec;
    const bool live = row0 + r < seq;
    load16(base + (live ? (long long)(row0 + r) * stride + c : 0),
           dst + r * ld + c, mul, live);
  }
}

__device__ __forceinline__ void put(float* o, float x) { *o = x; }
__device__ __forceinline__ void put(__nv_bfloat16* o, float x) {
  *o = __float2bfloat16_rn(x);
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads, 2) flash_fwd_kernel(Args a) {
  using L = Tile<HD>;
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);
  float* ks = qs + L::TQ * L::QS;
  float* vs = ks + L::TK * L::QS;
  float* ps = vs + L::TK * L::VS;

  // heaviest causal tiles first: blocks [0, B*H) take the last query tile
  const int panels = a.batch * a.heads;
  const int n_q = (a.seq_q + L::TQ - 1) / L::TQ;
  const int iq = n_q - 1 - (int)(blockIdx.x / panels);
  const int panel = (int)(blockIdx.x % panels);
  const int b = panel / a.heads;
  const int h = panel % a.heads;
  const int hk = h / a.group;
  const int q0 = iq * L::TQ;

  const T* qg = static_cast<const T*>(a.q) + b * a.sq.b + h * a.sq.h;
  const T* kg = static_cast<const T*>(a.k) + b * a.sk.b + hk * a.sk.h;
  const T* vg = static_cast<const T*>(a.v) + b * a.sv.b + hk * a.sv.h;
  T* og = static_cast<T*>(a.o) + b * a.so.b + h * a.so.h;

  const int tx = threadIdx.x % 16;  // score / output column lane
  const int ty = threadIdx.x / 16;  // row group: rows ty * RM + i

  load_tile<T, HD>(qg, a.sq.s, q0, L::TQ, a.seq_q, qs, L::QS, a.scale);

  int n_k = (a.seq_k + L::TK - 1) / L::TK;
  if (a.causal) {
    const int last = min(q0 + L::TQ, a.seq_q);  // rows [q0, last) live
    n_k = min(n_k, (last + L::TK - 1) / L::TK);
  }

  float m[L::RM], l[L::RM], acc[L::RM][L::DN][L::DV];
#pragma unroll
  for (int i = 0; i < L::RM; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < L::DN; ++c)
#pragma unroll
      for (int e = 0; e < L::DV; ++e) acc[i][c][e] = 0.f;
  }

  for (int kt = 0; kt < n_k; ++kt) {
    const int k0 = kt * L::TK;
    __syncthreads();  // the previous step's reads of K, V, P are done
    load_tile<T, HD>(kg, a.sk.s, k0, L::TK, a.seq_k, ks, L::QS, 1.f);
    load_tile<T, HD>(vg, a.sv.s, k0, L::TK, a.seq_k, vs, L::VS, 1.f);
    __syncthreads();

    // scores: rows ty * RM + i, columns tx + 16 * j
    float s[L::RM][L::CN];
#pragma unroll
    for (int i = 0; i < L::RM; ++i)
#pragma unroll
      for (int j = 0; j < L::CN; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; d += 4) {
      float4 qa[L::RM], kb[L::CN];
#pragma unroll
      for (int i = 0; i < L::RM; ++i)
        qa[i] = *reinterpret_cast<const float4*>(
            qs + (ty * L::RM + i) * L::QS + d);
#pragma unroll
      for (int j = 0; j < L::CN; ++j)
        kb[j] = *reinterpret_cast<const float4*>(
            ks + (tx + 16 * j) * L::QS + d);
#pragma unroll
      for (int i = 0; i < L::RM; ++i)
#pragma unroll
        for (int j = 0; j < L::CN; ++j) {
          s[i][j] = fmaf(qa[i].x, kb[j].x, s[i][j]);
          s[i][j] = fmaf(qa[i].y, kb[j].y, s[i][j]);
          s[i][j] = fmaf(qa[i].z, kb[j].z, s[i][j]);
          s[i][j] = fmaf(qa[i].w, kb[j].w, s[i][j]);
        }
    }

    // the online softmax of each row, its statistics shared by 16 lanes
#pragma unroll
    for (int i = 0; i < L::RM; ++i) {
      const int row = q0 + ty * L::RM + i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < L::CN; ++j) {
        const int col = k0 + tx + 16 * j;
        if (col >= a.seq_k || (a.causal && row < col)) s[i][j] = kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float corr = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < L::CN; ++j) {
        const float p = expf(s[i][j] - m_new);
        sum += p;
        ps[(ty * L::RM + i) * L::PS + tx + 16 * j] = p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = l[i] * corr + sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < L::DN; ++c)
#pragma unroll
        for (int e = 0; e < L::DV; ++e) acc[i][c][e] *= corr;
    }
    __syncthreads();

    // acc += P V: output columns DV * tx + 16 * DV * c + e
#pragma unroll 2
    for (int j = 0; j < L::TK; j += 4) {
      float4 p4[L::RM];
#pragma unroll
      for (int i = 0; i < L::RM; ++i)
        p4[i] = *reinterpret_cast<const float4*>(
            ps + (ty * L::RM + i) * L::PS + j);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const float* vrow = vs + (j + jj) * L::VS + L::DV * tx;
#pragma unroll
        for (int c = 0; c < L::DN; ++c) {
          float w[L::DV];
          if constexpr (L::DV == 2) {
            const float2 x =
                *reinterpret_cast<const float2*>(vrow + 16 * L::DV * c);
            w[0] = x.x;
            w[1] = x.y;
          } else {
            w[0] = vrow[16 * c];
          }
#pragma unroll
          for (int i = 0; i < L::RM; ++i) {
            const float p = jj == 0 ? p4[i].x
                            : jj == 1 ? p4[i].y
                            : jj == 2 ? p4[i].z
                                      : p4[i].w;
#pragma unroll
            for (int e = 0; e < L::DV; ++e)
              acc[i][c][e] = fmaf(p, w[e], acc[i][c][e]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < L::RM; ++i) {
    const int row = q0 + ty * L::RM + i;
    if (row >= a.seq_q) continue;
    const float den = fmaxf(l[i], 1e-30f);
    T* orow = og + row * a.so.s + L::DV * tx;
#pragma unroll
    for (int c = 0; c < L::DN; ++c)
#pragma unroll
      for (int e = 0; e < L::DV; ++e)
        put(orow + 16 * L::DV * c + e, acc[i][c][e] / den);
  }
}

template <typename T, int HD>
int launch(const Args& a, cudaStream_t stream) {
  using L = Tile<HD>;
  const size_t smem = L::SMEM_FLOATS * sizeof(float);
  auto kernel = flash_fwd_kernel<T, HD>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (long long)a.batch * a.heads *
                           ((a.seq_q + L::TQ - 1) / L::TQ);
  if (blocks == 0) return 0;
  if (blocks > 0x7FFFFFFFLL) return (int)cudaErrorInvalidConfiguration;
  kernel<<<(unsigned)blocks, kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(int hd, const Args& a, cudaStream_t stream) {
  switch (hd) {
    case 16: return launch<T, 16>(a, stream);
    case 32: return launch<T, 32>(a, stream);
    case 64: return launch<T, 64>(a, stream);
    case 128: return launch<T, 128>(a, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q, o: (B, S, H, hd); k, v: (B, Sk, Hkv, hd); strides in elements as
// (batch, sequence, head) for each, the head dim contiguous; every pointer
// and stride 16-byte aligned.  dtype 0 = f32, 1 = bf16.  Returns the CUDA
// error of the launch (0 on success); an unsupported dtype or head dim is
// cudaErrorInvalidValue.
extern "C" int flash_fwd(int dtype, int hd, const void* q, const void* k,
                         const void* v, void* o, int batch, int seq_q,
                         int seq_k, int heads, int kv_heads,
                         const long long* strides, int causal, float scale,
                         void* stream) {
  if (kv_heads <= 0 || heads % kv_heads != 0)
    return (int)cudaErrorInvalidValue;
  Args a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.o = o;
  a.sq = {strides[0], strides[1], strides[2]};
  a.sk = {strides[3], strides[4], strides[5]};
  a.sv = {strides[6], strides[7], strides[8]};
  a.so = {strides[9], strides[10], strides[11]};
  a.batch = batch;
  a.seq_q = seq_q;
  a.seq_k = seq_k;
  a.heads = heads;
  a.group = heads / kv_heads;
  a.causal = causal;
  a.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch<float>(hd, a, s);
  if (dtype == 1) return dispatch<__nv_bfloat16>(hd, a, s);
  return (int)cudaErrorInvalidValue;
}
