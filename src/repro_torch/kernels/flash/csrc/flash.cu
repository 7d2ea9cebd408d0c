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
// (round-to-nearest-even for bf16); sums and the softmax are f32.
//
// The algorithm is the TPU kernel's: one query tile stays on chip while
// the K/V tiles of its head stream past it, with an f32 online softmax per
// query row (running max m, running sum l, accumulator rescaled by
// exp(m_old - m_new)), and the output is acc / max(l, 1e-30).  For causal
// attention the loop stops at the diagonal: a query tile whose last row is
// r reads the ceil((r + 1) / TK) key tiles that row can see.  (The TPU
// kernel's bound, (iq+1)*tq//tk + (tq//tk > 0), drops key tiles when
// tq < tk.)  Each kernel tiles at its own TQ x TK, whatever the caller's
// tq / tk, and masks ragged edges itself, so the answer does not depend on
// tq / tk.  One CTA per (query tile, b, h), the heaviest causal tiles
// launched first.
//
// What bounds it on this card: the two products, 4 * hd flops per visible
// (query, key) pair, at 989 TFLOP/s in bf16 on the tensor cores or 67
// TFLOP/s in f32 off them; the bytes (q, k, v read once, o written once)
// are far below that at these head dims.  So each type has the design that
// reaches its own peak:
//
// bf16, flash_fwd_wgmma: FlashAttention-3's forward in its plain form, the
// products on the tensor cores.  Three warpgroups per 128-row query tile.
// Warp 0, the producer (its registers cut to 24 by setmaxnreg), loads the
// query tile once and streams 128-key K and V tiles through a two-stage
// ring in shared memory by TMA, with a full mbarrier per tile and an empty
// one per stage; its 4-D tensor maps over (hd, H, S, B) are built from the
// strides, so the zero fill past S and Sk stays inside one (b, head)
// panel.  The two consumer warpgroups (240 registers each) own 64 query
// rows each: S = Q K^T by wgmma m64n128k16 from shared memory, both
// operands K-major; the online softmax in registers, with the scale folded
// into exp2, each row's statistics shared by the 4 lanes of a quad, and
// the masks applied on the last key tile only, the one tile where they can
// bite; P rounded to bf16 straight into wgmma's A fragment in registers
// (the accumulator's layout is the fragment's); O += P V by wgmma with A
// from registers and V read N-major through the transpose flag.  Tiles are
// swizzled as wide as a row: 128 B at hd 128 (two 64-column boxes) and 64,
// 64 B at 32, 32 B at 16, with the wgmma descriptors' strides to match.
// Left for later: ping-pong of the two consumers, the next tile's products
// under this one's softmax, persistent CTAs, a GQA group's heads in one
// CTA.  Rounding P to bf16 is what every tensor-core attention does; it
// puts the output's relative error near 2e-3, the class of
// scaled_dot_product_attention.
//
// f32, flash_fwd_kernel<float, HD>: CUDA-core FMAs, since TF32 on the
// tensor cores would break the reference's 2e-5 tolerance.  256 threads,
// 2 CTAs per SM, 64-row query tiles.  The query tile (scaled, in f32)
// stays in shared memory; each K/V tile is loaded into shared memory; each
// thread holds a 4 x (TK / 16) block of scores and a 4 x (hd / 16) block
// of the accumulator, the rows' statistics reduced across the 16 lanes
// that share them by warp shuffles; the probabilities go through shared
// memory to the P V product.  Row strides of HD + 4 floats keep the
// 16-byte reads of K free of bank conflicts.

#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;

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

// ---- f32: CUDA-core FMAs ----

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

// One 16-byte vector of floats, times mul, into shared memory at dst.
__device__ __forceinline__ void load16(const float* src, float* dst,
                                       float mul, bool live) {
  float4 x = live ? *reinterpret_cast<const float4*>(src)
                  : make_float4(0.f, 0.f, 0.f, 0.f);
  *reinterpret_cast<float4*>(dst) =
      make_float4(x.x * mul, x.y * mul, x.z * mul, x.w * mul);
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

// ---- bf16: wgmma on the tensor cores, fed by TMA, warp-specialised ----

constexpr int kHopperThreads = 384;  // the producer's warpgroup + 2 consumers
constexpr uint64_t kWaitLimitNs = 10000000000ull;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(bar) : "memory");
}

__device__ __forceinline__ bool mbar_try(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

__device__ __forceinline__ uint64_t global_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}

// Wait for the phase of parity `parity` to complete.  A wait that outlasts
// kWaitLimitNs traps, so a lost phase fails the launch instead of hanging
// the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try(bar, parity)) return;
  const uint64_t t0 = global_ns();
  while (!mbar_try(bar, parity))
    if (global_ns() - t0 > kWaitLimitNs) __trap();
}

// One box of a 4-D tensor map at (c0, c1, c2, c3) into shared memory at dst;
// its bytes complete a transaction of the barrier at bar.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0),
         "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(N));
}

template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(N));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Pin registers that an asynchronous wgmma reads or writes to this point
// of the program, so the compiler moves no access to them across it.
template <int N>
__device__ __forceinline__ void pin(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

template <int N>
__device__ __forceinline__ void pin(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(r[i][e])::"memory");
}

// A wgmma shared-memory descriptor: start address, leading and stride byte
// offsets (16-byte units), swizzle code (1 = 128 B, 2 = 64 B, 3 = 32 B).
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo, uint64_t swz) {
  return (uint64_t)((addr >> 4) & 0x3FFF) |
         (uint64_t)((lbo >> 4) & 0x3FFF) << 16 |
         (uint64_t)((sbo >> 4) & 0x3FFF) << 32 | swz << 62;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// d (64 x 128, f32) = A (64 x 16) B (16 x 128) + (accumulate ? d : 0); A
// and B bf16 in shared memory, both K-major (descriptors a, b)
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t a,
                                              uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(accumulate));
}

// d (64 x N, f32) += A (64 x 16, bf16 in registers: the fragment of
// wgmma's accumulator layout) B (16 x N, bf16 in shared memory, N-major:
// the transpose flag set)
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t (&a)[4], uint64_t b);

template <>
__device__ __forceinline__ void wgmma_rs<16>(float (&d)[8],
                                             const uint32_t (&a)[4],
                                             uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<32>(float (&d)[16],
                                             const uint32_t (&a)[4],
                                             uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<64>(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<128>(float (&d)[64],
                                             const uint32_t (&a)[4],
                                             uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// The tiles and shared memory of flash_fwd_wgmma at head dim HD.  A
// 128-row tile is BOXES boxes of BOX columns, each box 128 rows of ROW
// bytes, swizzled over ROW bytes: the layout TMA writes and wgmma reads.
template <int HD>
struct Hop {
  static constexpr int TQ = 128;   // query rows of a CTA, 64 per consumer
  static constexpr int TK = 128;   // keys of a ring stage
  static constexpr int STAGES = 2;
  static constexpr int BOX = HD < 64 ? HD : 64;  // columns of a TMA box
  static constexpr int BOXES = HD / BOX;
  static constexpr int ROW = 2 * BOX;            // bytes of a box row
  static constexpr int PANEL = 128 * ROW;        // bytes of a box
  static constexpr int TILE = BOXES * PANEL;     // bytes of a tile
  static constexpr int ATOM = 8 * ROW;           // bytes of 8 rows
  static constexpr uint64_t SWIZZLE = ROW == 128 ? 1 : ROW == 64 ? 2 : 3;
  // Q | K stages | V stages | mbarriers, from a 1024-byte aligned base
  static constexpr int BARS = 1 + 3 * STAGES;
  static constexpr int SMEM = 1024 + (1 + 2 * STAGES) * TILE + 8 * BARS;
  static_assert(HD % 16 == 0 && HD <= 128, "head dim 16, 32, 64 or 128");
};

// Q or K (rows x 16 columns at addr), K-major: 8-row groups ATOM apart.
template <class L>
__device__ __forceinline__ uint64_t k_major(uint32_t addr) {
  return smem_desc(addr, 16, L::ATOM, L::SWIZZLE);
}

// V (16 keys x HD columns at addr), N-major: 8-key groups ATOM apart,
// 64-column boxes PANEL apart.
template <class L>
__device__ __forceinline__ uint64_t n_major(uint32_t addr) {
  return smem_desc(addr, L::PANEL, L::ATOM, L::SWIZZLE);
}

template <int HD>
__global__ void __launch_bounds__(kHopperThreads, 1)
    flash_fwd_wgmma(const __grid_constant__ CUtensorMap q_map,
                    const __grid_constant__ CUtensorMap k_map,
                    const __grid_constant__ CUtensorMap v_map, Args a) {
  using L = Hop<HD>;
  extern __shared__ uint8_t smem[];
  const uint32_t q_s = (smem_u32(smem) + 1023) & ~1023u;
  const uint32_t k_s = q_s + L::TILE;                  // + stage * TILE
  const uint32_t v_s = k_s + L::STAGES * L::TILE;      // + stage * TILE
  const uint32_t bars = v_s + L::STAGES * L::TILE;
  const uint32_t full_q = bars;
  const uint32_t full_k = bars + 8;                    // + 8 * stage
  const uint32_t full_v = full_k + 8 * L::STAGES;      // + 8 * stage
  const uint32_t empty = full_v + 8 * L::STAGES;       // + 8 * stage

  // heaviest causal tiles first: blocks [0, B*H) take the last query tile
  const int panels = a.batch * a.heads;
  const int n_q = (a.seq_q + L::TQ - 1) / L::TQ;
  const int iq = n_q - 1 - (int)(blockIdx.x / panels);
  const int panel = (int)(blockIdx.x % panels);
  const int b = panel / a.heads;
  const int h = panel % a.heads;
  const int q0 = iq * L::TQ;
  int n_k = (a.seq_k + L::TK - 1) / L::TK;
  if (a.causal) {
    const int last = min(q0 + L::TQ, a.seq_q);  // rows [q0, last) live
    n_k = min(n_k, (last + L::TK - 1) / L::TK);
  }

  if (threadIdx.x == 0) {
    mbar_init(full_q, 1);
    for (int st = 0; st < L::STAGES; ++st) {
      mbar_init(full_k + 8 * st, 1);
      mbar_init(full_v + 8 * st, 1);
      mbar_init(empty + 8 * st, 8);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {  // the producer: one thread starts every load
    setmaxnreg_dec<24>();
    if (threadIdx.x == 0) {
      const int hk = h / a.group;
      mbar_expect_tx(full_q, L::TILE);
      for (int x = 0; x < L::BOXES; ++x)
        tma_load(q_s + x * L::PANEL, &q_map, full_q, x * L::BOX, h, q0, b);
      for (int kt = 0; kt < n_k; ++kt) {
        const int st = kt % L::STAGES;
        mbar_wait(empty + 8 * st, ((kt / L::STAGES) & 1) ^ 1);
        mbar_expect_tx(full_k + 8 * st, L::TILE);
        for (int x = 0; x < L::BOXES; ++x)
          tma_load(k_s + st * L::TILE + x * L::PANEL, &k_map, full_k + 8 * st,
                   x * L::BOX, hk, kt * L::TK, b);
        mbar_expect_tx(full_v + 8 * st, L::TILE);
        for (int x = 0; x < L::BOXES; ++x)
          tma_load(v_s + st * L::TILE + x * L::PANEL, &v_map, full_v + 8 * st,
                   x * L::BOX, hk, kt * L::TK, b);
      }
    }
    return;
  }

  // the consumers: warpgroup c owns query rows [64 c, 64 c + 64) of the
  // tile; a thread holds rows row0 and row0 + 8, and of each 8-column
  // block of S and O the columns 2 (lane % 4) and 2 (lane % 4) + 1
  setmaxnreg_inc<240>();
  const int c = wg - 1;
  const int lane = threadIdx.x % 32;
  const int row0 = q0 + 64 * c + 16 * (threadIdx.x % 128 / 32) + lane / 4;
  const float scale_log2 = a.scale * 1.4426950408889634f;
  const uint32_t q_rows = q_s + 64 * c * L::ROW;

  float o[HD / 2], s[64], m[2], l[2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 64; ++i) s[i] = 0.f;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
  }

  mbar_wait(full_q, 0);
  for (int kt = 0; kt < n_k; ++kt) {
    const int st = kt % L::STAGES;
    const uint32_t parity = (kt / L::STAGES) & 1;
    const uint32_t ks = k_s + st * L::TILE;
    const uint32_t vs = v_s + st * L::TILE;
    mbar_wait(full_k + 8 * st, parity);

    // s = q k^T, 16 of the head dim a step
    pin(s);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      const uint32_t off = kk * 16 / L::BOX * L::PANEL + kk * 16 % L::BOX * 2;
      wgmma_ss_n128(s, k_major<L>(q_rows + off), k_major<L>(ks + off), kk);
    }
    wgmma_commit();
    wgmma_wait_all();
    pin(s);

    // the online softmax in log2 units; s[i] is row row0 + 8 ((i / 2) % 2),
    // key k0 + 8 (i / 4) + 2 (lane % 4) + i % 2
    const int k0 = kt * L::TK;
    const bool edge = kt == n_k - 1;  // the one tile a mask can bite
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      float x = s[i] * scale_log2;
      if (edge) {
        const int col = k0 + 8 * (i / 4) + 2 * (lane % 4) + i % 2;
        if (col >= a.seq_k || (a.causal && col > row0 + 8 * ((i / 2) % 2)))
          x = kNegInf;
      }
      s[i] = x;
      mx[(i / 2) % 2] = fmaxf(mx[(i / 2) % 2], x);
    }
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      corr[r] = exp2f(m[r] - mx[r]);
      m[r] = mx[r];
      l[r] *= corr[r];  // the lane's share; the quad's sum at the end
    }
    // P in bf16, as the A fragments of 8 steps of 16 keys
    uint32_t p[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {  // e = 0, 2: row0; e = 1, 3: row0 + 8
        const float x0 = exp2f(s[8 * j + 2 * e] - m[e % 2]);
        const float x1 = exp2f(s[8 * j + 2 * e + 1] - m[e % 2]);
        l[e % 2] += x0 + x1;
        p[j][e] = pack_bf16(x0, x1);
      }
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) o[i] *= corr[(i / 2) % 2];

    // o += p v, 16 keys a step
    mbar_wait(full_v + 8 * st, parity);
    pin(o);
    pin(p);
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < 8; ++j)
      wgmma_rs<HD>(o, p[j], n_major<L>(vs + j * 16 * L::ROW));
    wgmma_commit();
    wgmma_wait_all();
    pin(o);
    pin(p);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + 8 * st);  // this warp is done with st
  }

  __nv_bfloat16* og =
      static_cast<__nv_bfloat16*>(a.o) + b * a.so.b + h * a.so.h;
  float den[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    den[r] = fmaxf(l[r], 1e-30f);
  }
#pragma unroll
  for (int i = 0; i < HD / 2; i += 2) {
    const int r = (i / 2) % 2;
    const int row = row0 + 8 * r;
    if (row < a.seq_q)
      *reinterpret_cast<__nv_bfloat162*>(
          og + row * a.so.s + 8 * (i / 4) + 2 * (lane % 4)) =
          __floats2bfloat162_rn(o[i] / den[r], o[i + 1] / den[r]);
  }
}

using EncodeTiled = PFN_cuTensorMapEncodeTiled_v12000;

// cuTensorMapEncodeTiled of libcuda, found through the runtime so the
// library needs no -lcuda; null if libcuda lacks it.
EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &found) == cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// The 4-D map (hd, heads, seq, batch) of a bf16 tensor with element strides
// st, in boxes of BOX columns x 128 rows of one (b, head); zero fill.
template <class L>
int tensor_map(CUtensorMap* map, const void* base, int heads, int seq,
               int batch, const Strides& st) {
  const EncodeTiled encode = encoder();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[4] = {(cuuint64_t)(L::BOXES * L::BOX),
                              (cuuint64_t)heads, (cuuint64_t)seq,
                              (cuuint64_t)batch};
  const cuuint64_t strides[3] = {(cuuint64_t)(2 * st.h),
                                 (cuuint64_t)(2 * st.s),
                                 (cuuint64_t)(2 * st.b)};
  const cuuint32_t box[4] = {(cuuint32_t)L::BOX, 1, (cuuint32_t)L::TK, 1};
  const cuuint32_t step[4] = {1, 1, 1, 1};
  const CUtensorMapSwizzle swizzle =
      L::ROW == 128  ? CU_TENSOR_MAP_SWIZZLE_128B
      : L::ROW == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                     : CU_TENSOR_MAP_SWIZZLE_32B;
  const CUresult rc = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims,
      strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return rc == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

template <int HD>
int launch_wgmma(const Args& a, cudaStream_t stream) {
  using L = Hop<HD>;
  const long long blocks = (long long)a.batch * a.heads *
                           ((a.seq_q + L::TQ - 1) / L::TQ);
  if (blocks == 0) return 0;
  if (blocks > 0x7FFFFFFFLL) return (int)cudaErrorInvalidConfiguration;
  const int kv_heads = a.heads / a.group;
  CUtensorMap q_map, k_map, v_map;
  int rc = tensor_map<L>(&q_map, a.q, a.heads, a.seq_q, a.batch, a.sq);
  if (rc == 0)
    rc = tensor_map<L>(&k_map, a.k, kv_heads, a.seq_k, a.batch, a.sk);
  if (rc == 0)
    rc = tensor_map<L>(&v_map, a.v, kv_heads, a.seq_k, a.batch, a.sv);
  if (rc != 0) return rc;
  auto kernel = flash_fwd_wgmma<HD>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::SMEM);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(unsigned)blocks, kHopperThreads, L::SMEM, stream>>>(
      q_map, k_map, v_map, a);
  return (int)cudaGetLastError();
}

template <int HD>
int launch_type(int dtype, const Args& a, cudaStream_t stream) {
  if (dtype == 0) return launch<float, HD>(a, stream);
  if (dtype == 1) return launch_wgmma<HD>(a, stream);
  return (int)cudaErrorInvalidValue;
}

int dispatch(int dtype, int hd, const Args& a, cudaStream_t stream) {
  switch (hd) {
    case 16: return launch_type<16>(dtype, a, stream);
    case 32: return launch_type<32>(dtype, a, stream);
    case 64: return launch_type<64>(dtype, a, stream);
    case 128: return launch_type<128>(dtype, a, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q, o: (B, S, H, hd); k, v: (B, Sk, Hkv, hd); strides in elements as
// (batch, sequence, head) for each, the head dim contiguous; every pointer
// and stride 16-byte aligned, and in bf16 every stride positive (TMA).
// dtype 0 = f32, 1 = bf16.  Returns the CUDA error of the launch (0 on
// success); an unsupported dtype or head dim, or a tensor map that
// libcuda refuses, is cudaErrorInvalidValue.
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
  return dispatch(dtype, hd, a, static_cast<cudaStream_t>(stream));
}
