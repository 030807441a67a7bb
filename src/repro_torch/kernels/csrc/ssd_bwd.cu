// Mamba2 SSD scan, backward — the Hopper kernel behind
// kernels/ssd_scan.py:ssd_scan_bwd (every bf16 training step of the ssm and
// hybrid families at a (P, N) of ssd_scan.TC_SHAPES).
//
// Replaces: models/mamba2.ssd_scan_vjp, autograd through the float32 plain
// scan (ssd_chunked) recomputed in the backward.  The reference has no
// Pallas backward: it differentiates ssd_chunked under XLA.
//
// Per (batch b, head h), chunks of 64 rows, cum the running sum of dt * a
// inside a chunk, h_z the state entering chunk z (P x N), dh_z its
// gradient, w_j = exp(cum_last - cum_j) dt_j, G = C B^T, L_ij =
// exp(cum_i - cum_j) (j <= i), M = G o L o dt_j and dM = dy x^T:
//   dx_j  = sum_i M_ij dy_i + w_j dh_{z+1} B_j + D dy_j
//   dB_j  = sum_i dG_ij C_i + w_j dh_{z+1}^T x_j,  dG = dM o L o dt_j
//   dC_i  = sum_j dG_ij B_j + exp(cum_i) h_z^T dy_i
//   dh_z  = exp(cum_last) dh_{z+1} + sum_i exp(cum_i) dy_i C_i^T
//   dcum  = rowsum(dM o M) - colsum(dM o M) + C_i . dC_inter_i - dw_j w_j,
//           and at the chunk's last row sum_j dw_j w_j + exp(cum_last)
//           <dh_{z+1}, h_z>, with dw_j = B_j . (dh_{z+1}^T x_j)
//   ddt_j = a * sum_{k >= j} dcum_k + colsum(dM o G o L)_j
//           + dw_j exp(cum_last - cum_j);  da = sum dt_j sum_{k >= j} dcum_k
//   dD    = sum dy . x
// dB and dC are summed over the heads of their group.
//
// What bounds it on an H100: at Mamba2-370m's training shape (B=16,
// S=2048, H=32, P=64, N=128, one group) the gradients need about 0.46 GB
// (x, dy, B, C, dt and dstate read; dx, dB, dC, ddt written) and about
// 120 GFLOP of products: 0.14 ms of HBM traffic at 3.35 TB/s.  The plain
// VJP it replaces moves 76.8 GB through five float32 (b, chunks, 256, 256,
// h) tensors.  As in the forward, the walk over chunks is sequential per
// (batch, head), so what a design reaches is the products' rate on one SM
// times the blocks in flight.
//
// Design (ssd_bwd_tc<P, N>, bf16 x, B, C, dy on the tensor cores; the
// forward's (P, N) instantiations):
//   * one block of 8 warps per (batch, head), like the forward: 512 blocks
//     at the cell's shape, about 4 waves of one block an SM.  Warp w owns
//     chunk rows 16 (w % 4) .. + 15 and half w / 4 of the P and the N
//     columns; for dh, N rows 16 (w % 4 + 4 k) .. + 15 and the P half (the
//     forward's state layout).  The chunk-parallel alternative (16k
//     (batch, chunk, head) items) needs the chunk states and their
//     gradients in device memory between kernels; here they never leave
//     the block but once;
//   * pass 1 walks the chunks forward and rebuilds the chunk-entry states
//     h_1 .. h_{nc-1} from x, dt, a and B (the forward's state update),
//     each stored once as its bf16 hi + lo pair in a scratch the wrapper
//     allocates (B H (nc - 1) 2 N P bf16: 0.5 GB at the cell's shape,
//     written once and read once, ~0.3 ms of the bound's traffic more);
//   * pass 2 walks the chunks in reverse with dh in float32 mma
//     accumulators, from the given dstate.  A 2-stage cp.async ring holds
//     x, dy, B, C, dt and h_z of one chunk while the next one's load is in
//     flight.  Per chunk: the state paths (B dh^T, x dh, dy h_z, dh's
//     update) and the causal 16 x 16 tiles of C B^T and dy x^T twice, in
//     the row (i) orientation for dC and rowsum(dM o M), and transposed (j
//     rows) for dx, dB and the column sums, so each of M, dG and their
//     transposes is an A operand straight from the accumulators and no
//     64 x 64 matrix goes through shared memory;
//   * the per-row sums (rowsum, colsum, dw, C . dC_inter) meet in shared
//     memory; warp 0 forms dcum, its reverse running sum (a shuffle scan),
//     ddt and da;
//   * dB and dC of one group are summed over its heads by float32 atomics
//     (red.global.add) into a zeroed float32 scratch that the wrapper casts
//     once to bf16: the order of the heads' adds varies from run to run, a
//     relative change of a few float32 ulps in a sum of H terms;
//   * precision equal to the float32 plain VJP's, as the forward keeps it:
//     x, B, C and dy are exact bf16 operands; every float32 operand (M,
//     dG, their transposes, h_z, dh, exp(cum) o C) goes to the tensor
//     cores as a bf16 hi + lo pair (16 significant bits), two MMAs each;
//     accumulators are float32, each output rounded once.  No TF32;
//   * it allocates nothing, runs on the caller's stream, and returns
//     cudaGetLastError() after the launch.
// float32 and other shapes take the plain VJP in the wrapper.  The PTX
// wrappers (cp.async, ldmatrix, mma, the hi + lo split) are copies of
// csrc/ssd.cu's: a translation unit of its own leaves the forward's
// source and build as they are.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kT = 64;                    // rows per chunk
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kBlockSmemLimit = 232448;   // 227 KB, an H100 block's most
constexpr float kLog2e = 1.4426950408889634f;

template <int P, int N>
struct BwdShape {
  static_assert(P % 16 == 0 && N % 16 == 0 && P <= 128 && N <= 128,
                "ssd backward: P and N multiples of 16, at most 128");
  static constexpr int XP = P + 8;        // x, dy, h and dh row pitch
  static constexpr int BP = N + 8;        // B and C row pitch
  static constexpr int PT = P / 16;       // n8 tiles in a warp's P half
  static constexpr int NH = N / 16;       // n8 tiles in a warp's N half
  static constexpr int KP = P / 16;       // k16 steps over P
  static constexpr int KN = N / 16;       // k16 steps over N
  static constexpr int NT = N / 16;       // m16 tiles of dh rows
  static constexpr int NW = (NT + 3) / 4; // dh m16 tiles a warp owns
  // one ring stage (bytes): x, dy [kT][XP], B, C [kT][BP] bf16, dt [kT]
  // float32, h_z hi and lo [N][XP] bf16
  static constexpr int kX = 0;
  static constexpr int kDy = kX + 2 * kT * XP;
  static constexpr int kB = kDy + 2 * kT * XP;
  static constexpr int kC = kB + 2 * kT * BP;
  static constexpr int kDt = kC + 2 * kT * BP;
  static constexpr int kHh = kDt + 4 * kT;
  static constexpr int kHl = kHh + 2 * N * XP;
  static constexpr int kStage = kHl + 2 * N * XP;
  // after the ring: dh hi and lo [N][XP], then the float32 row sums:
  // rowsum [kT], colsum [kT], dw [2][kT], C . dC_inter [2][kT], and one
  // float a warp
  static constexpr int kDhh = 2 * kStage;
  static constexpr int kDhl = kDhh + 2 * N * XP;
  static constexpr int kRed = kDhl + 2 * N * XP;
  static constexpr int kSmem = kRed + 4 * (6 * kT + kWarps);
  static_assert(kSmem <= kBlockSmemLimit, "ssd backward smem");
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 2^x in one MUFU instruction; cum is kept in log2 units
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(ok ? 16 : 0) : "memory");
}
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(dst), "l"(src), "r"(ok ? 4 : 0) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, "
               "[%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr) : "memory");
}
__device__ __forceinline__ void ldsm_x2(uint32_t& r0, uint32_t& r1,
                                        uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r0), "=r"(r1) : "r"(addr) : "memory");
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 "
               "{%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr) : "memory");
}
__device__ __forceinline__ void ldsm_x2_t(uint32_t& r0, uint32_t& r1,
                                          uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, "
               "[%2];\n"
               : "=r"(r0), "=r"(r1) : "r"(addr) : "memory");
}

// d (16 x 8, float32) += a (16 x 16, bf16, row) b (16 x 8, bf16, col)
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// (v0, v1) as the bf16 pair hi + lo: hi = bf16(v), lo = bf16(v - hi)
__device__ __forceinline__ void split2(float v0, float v1, uint32_t& hi,
                                       uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(v0, v1);
  const float2 hf = __bfloat1622float2(h);
  hi = bits(h);
  lo = bits(__floats2bfloat162_rn(v0 - hf.x, v1 - hf.y));
}

__device__ __forceinline__ float2 unpack2(uint32_t v) {
  return __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&v));
}

__device__ __forceinline__ float2 lds2(uint32_t addr) {
  uint32_t v;
  asm volatile("ld.shared.b32 %0, [%1];\n" : "=r"(v) : "r"(addr) : "memory");
  return unpack2(v);
}

__device__ __forceinline__ void sts(uint32_t addr, uint32_t v) {
  asm volatile("st.shared.b32 [%0], %1;\n" :: "r"(addr), "r"(v) : "memory");
}

// The A operand (m16 x k16) of rows m0 .. m0 + 15, columns k0 .. k0 + 15
// of a row-major bf16 tile.
__device__ __forceinline__ void load_a(uint32_t (&af)[4], uint32_t base,
                                       int pitch, int m0, int k0, int lane) {
  ldsm_x4(af, base + 2 * ((m0 + (lane & 15)) * pitch + k0 + (lane >> 4) * 8));
}

// The B operands (k16 x n8) of rows k0 .. k0 + 15 and columns n0 + 8 t of
// a row-major [k][n] bf16 tile (ldmatrix.trans).
template <int T>
__device__ __forceinline__ void load_b_rows(uint32_t (&bf)[T][2],
                                            uint32_t base, int pitch,
                                            int k0, int n0, int lane) {
  const int row = k0 + (lane & 15);
#pragma unroll
  for (int t = 0; t + 1 < T; t += 2) {
    uint32_t r[4];
    ldsm_x4_t(r, base + 2 * (row * pitch + n0 + 8 * t + (lane >> 4) * 8));
    bf[t][0] = r[0];
    bf[t][1] = r[1];
    bf[t + 1][0] = r[2];
    bf[t + 1][1] = r[3];
  }
  if (T & 1)
    ldsm_x2_t(bf[T - 1][0], bf[T - 1][1],
              base + 2 * (row * pitch + n0 + 8 * (T - 1)));
}

// The B operands (k16 x n8) of columns n0 + 8 t and rows k0 .. k0 + 15 of
// an [n][k] bf16 tile, k contiguous (a row-major tile read as its
// transpose: B^T's rows for C B^T, the state's [n][p] for x . dh).
template <int T>
__device__ __forceinline__ void load_b_cols(uint32_t (&bf)[T][2],
                                            uint32_t base, int pitch,
                                            int n0, int k0, int lane) {
  const int kc = k0 + ((lane >> 3) & 1) * 8;
#pragma unroll
  for (int t = 0; t + 1 < T; t += 2) {
    uint32_t r[4];
    ldsm_x4(r, base + 2 * ((n0 + 8 * t + (lane & 7) + ((lane >> 4) << 3))
                           * pitch + kc));
    bf[t][0] = r[0];
    bf[t][1] = r[1];
    bf[t + 1][0] = r[2];
    bf[t + 1][1] = r[3];
  }
  if (T & 1)
    ldsm_x2(bf[T - 1][0], bf[T - 1][1],
            base + 2 * ((n0 + 8 * (T - 1) + (lane & 7)) * pitch + kc));
}

struct Args {
  const bf16* x;
  long long xsb, xss;
  const bf16* dy;
  long long dysb, dyss;
  const float* dt;
  long long dtsb, dtss;
  const float* a;
  const float* d;
  const bf16* bm;
  long long bsb, bss;
  const bf16* cm;
  long long csb, css;
  const float* dstate;
  long long dstsb;
  int bsz, seq, heads;
  bf16* dx;
  long long dxsb, dxss;
  float* ddt;
  long long ddtsb, ddtss;
  float* da;
  float* dd;
  long long psb;
  float* db;
  long long dbsb, dbss;
  float* dc;
  long long dcsb, dcss;
  bf16* scratch;
};

// Chunk rows [t0, t0 + rows) into one ring stage (rows past `rows`
// zero-filled): x, B and dt; with `full` also dy, C and the chunk-entry
// state h (`h` null: the zero state).
template <int P, int N>
__device__ __forceinline__ void load_chunk(uint32_t st, const Args& g,
                                           const bf16* xp, const bf16* dyp,
                                           const bf16* bp, const bf16* cp,
                                           const float* dtp, const bf16* h,
                                           int t0, int rows, bool full,
                                           int tid) {
  using S = BwdShape<P, N>;
  constexpr int kXc = P / 8, kBc = N / 8;     // 16-byte pieces a row
  for (int i = tid; i < kT * kXc; i += kThreads) {
    const int j = i / kXc, c = i - j * kXc;
    const bool ok = j < rows;
    const uint32_t off = 2 * (j * S::XP + 8 * c);
    cp_async16(st + S::kX + off, ok ? xp + (t0 + j) * g.xss + 8 * c : xp,
               ok);
    if (full)
      cp_async16(st + S::kDy + off,
                 ok ? dyp + (t0 + j) * g.dyss + 8 * c : dyp, ok);
  }
  for (int i = tid; i < kT * kBc; i += kThreads) {
    const int j = i / kBc, c = i - j * kBc;
    const bool ok = j < rows;
    const uint32_t off = 2 * (j * S::BP + 8 * c);
    cp_async16(st + S::kB + off, ok ? bp + (t0 + j) * g.bss + 8 * c : bp,
               ok);
    if (full)
      cp_async16(st + S::kC + off, ok ? cp + (t0 + j) * g.css + 8 * c : cp,
                 ok);
  }
  if (tid < kT) {
    const bool ok = tid < rows;
    cp_async4(st + S::kDt + 4 * tid,
              ok ? dtp + static_cast<long long>(t0 + tid) * g.dtss : dtp, ok);
  }
  if (full) {
    // h_z: hi [N][P] then lo [N][P], dense
    for (int i = tid; i < 2 * N * kXc; i += kThreads) {
      const int r = i / kXc, c = i - r * kXc;     // r: hi rows, then lo
      const uint32_t dst = st + (r < N ? S::kHh : S::kHl)
                           + 2 * ((r % N) * S::XP + 8 * c);
      cp_async16(dst, h != nullptr ? h + r * P + 8 * c : xp, h != nullptr);
    }
  }
  cp_async_commit();
}

// The running sum of dt * a (log2 units) over one chunk, in every warp:
// rows 2 lane and 2 lane + 1.
struct Scan {
  float dt0, dt1, cum0, cum1, last;
};

__device__ __forceinline__ Scan scan_chunk(const float* sdt, float a2,
                                           int lane) {
  Scan s;
  const float2 d = reinterpret_cast<const float2*>(sdt)[lane];
  s.dt0 = d.x;
  s.dt1 = d.y;
  const float da0 = d.x * a2, da1 = d.y * a2;
  float incl = da0 + da1;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float o = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += o;
  }
  float excl = __shfl_up_sync(0xffffffffu, incl, 1);
  if (lane == 0) excl = 0.f;
  s.cum0 = excl + da0;
  s.cum1 = s.cum0 + da1;
  s.last = __shfl_sync(0xffffffffu, s.cum1, 31);
  return s;
}

// the value of row r (0 .. 63) of a per-row pair (v0 at 2 lane, v1 at 2
// lane + 1), read by shuffle
__device__ __forceinline__ float row_of(float v0, float v1, int r) {
  const float e = __shfl_sync(0xffffffffu, v0, r >> 1);
  const float o = __shfl_sync(0xffffffffu, v1, r >> 1);
  return (r & 1) ? o : e;
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  v += __shfl_xor_sync(0xffffffffu, v, 2);
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

template <int P, int N>
__global__ void __launch_bounds__(kThreads, 1)
ssd_bwd_tc(const Args g) {
  using S = BwdShape<P, N>;
  constexpr int PT = S::PT, NH = S::NH, KP = S::KP, KN = S::KN;
  constexpr int NT = S::NT, NW = S::NW, XP = S::XP, BP = S::BP;
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int mt = warp & 3;                  // rows 16 mt ..; dh tiles mt + 4k
  const int half = warp >> 2;
  const int p0 = half * (P / 2);            // the warp's P half
  const int n0 = half * (N / 2);            // the warp's N half
  const int gq = lane >> 2, q = lane & 3;
  const int i0 = 16 * mt + gq;              // this lane's rows i0, i0 + 8
  const int bh = blockIdx.x;
  const int b = bh / g.heads;
  const int h = bh - b * g.heads;
  const bf16* xp = g.x + b * g.xsb + static_cast<long long>(h) * P;
  const bf16* dyp = g.dy + b * g.dysb + static_cast<long long>(h) * P;
  const float* dtp = g.dt + b * g.dtsb + h;
  const bf16* bp = g.bm + b * g.bsb;
  const bf16* cp = g.cm + b * g.csb;
  const float a_h = g.a[h];
  const float a2 = a_h * kLog2e;            // cum in log2 units
  const float d_h = g.d != nullptr ? g.d[h] : 0.f;
  const int chunks = (g.seq + kT - 1) / kT;
  // the chunk-entry states h_1 .. h_{chunks-1}, each hi [N][P], lo [N][P]
  bf16* hs = g.scratch + static_cast<long long>(bh) * (chunks - 1) * 2 * N * P;
  const uint32_t s0 = smem_u32(smem);
  const uint32_t s_dhh = s0 + S::kDhh, s_dhl = s0 + S::kDhl;
  float* red = reinterpret_cast<float*>(smem + S::kRed);
  float* red_rowq = red;                    // [kT]
  float* red_colr = red + kT;               // [kT]
  float* red_dw = red + 2 * kT;             // [2][kT]
  float* red_dci = red + 4 * kT;            // [2][kT]
  float* red_w = red + 6 * kT;              // [kWarps]

  // ---- pass 1: h_1 .. h_{chunks-1}, the forward's state update
  {
    float st[NW][PT][4];
#pragma unroll
    for (int k = 0; k < NW; ++k)
#pragma unroll
      for (int t = 0; t < PT; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) st[k][t][e] = 0.f;
    if (chunks > 1)
      load_chunk<P, N>(s0, g, xp, dyp, bp, cp, dtp, nullptr, 0, kT, false,
                       tid);
    for (int ck = 0; ck + 1 < chunks; ++ck) {
      const int t0 = ck * kT;
      const uint32_t sx = s0 + (ck & 1) * S::kStage;
      const uint32_t sb = sx + S::kB;
      const float* sdt = reinterpret_cast<const float*>(
          smem + (ck & 1) * S::kStage + S::kDt);
      cp_async_wait_all();
      __syncthreads();       // chunk ck landed; the other stage is free
      if (ck + 2 < chunks)
        load_chunk<P, N>(s0 + ((ck + 1) & 1) * S::kStage, g, xp, dyp, bp, cp,
                         dtp, nullptr, t0 + kT, kT, false, tid);
      const Scan sc = scan_chunk(sdt, a2, lane);
      const float el = ex2(sc.last);
#pragma unroll
      for (int k = 0; k < NW; ++k)
#pragma unroll
        for (int t = 0; t < PT; ++t)
#pragma unroll
          for (int e = 0; e < 4; ++e) st[k][t][e] *= el;
      const float w0 = ex2(sc.last - sc.cum0) * sc.dt0;
      const float w1 = ex2(sc.last - sc.cum1) * sc.dt1;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const float wa0 = __shfl_sync(0xffffffffu, w0, 8 * kk + q);
        const float wa1 = __shfl_sync(0xffffffffu, w1, 8 * kk + q);
        const float wb0 = __shfl_sync(0xffffffffu, w0, 8 * kk + 4 + q);
        const float wb1 = __shfl_sync(0xffffffffu, w1, 8 * kk + 4 + q);
        uint32_t xf[PT][2];
        load_b_rows<PT>(xf, sx + S::kX, XP, 16 * kk, p0, lane);
#pragma unroll
        for (int k = 0; k < NW; ++k) {
          const int nt = mt + 4 * k;
          if (nt >= NT) continue;
          uint32_t r[4], ahi[4], alo[4];
          ldsm_x4_t(r, sb + 2 * ((16 * kk + (lane & 7) + (lane >> 4) * 8) * BP
                                 + 16 * nt + ((lane >> 3) & 1) * 8));
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float2 v = unpack2(r[e]);
            split2(v.x * (e < 2 ? wa0 : wb0), v.y * (e < 2 ? wa1 : wb1),
                   ahi[e], alo[e]);
          }
#pragma unroll
          for (int t = 0; t < PT; ++t) {
            mma16816(st[k][t], ahi, xf[t][0], xf[t][1]);
            mma16816(st[k][t], alo, xf[t][0], xf[t][1]);
          }
        }
      }
      // h_{ck+1} out, as its bf16 pair
      bf16* ho = hs + static_cast<long long>(ck) * 2 * N * P;
#pragma unroll
      for (int k = 0; k < NW; ++k) {
        const int nt = mt + 4 * k;
        if (nt >= NT) continue;
#pragma unroll
        for (int t = 0; t < PT; ++t) {
          const int p = p0 + 8 * t + 2 * q;
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int n = 16 * nt + gq + 8 * r;
            uint32_t hi, lo;
            split2(st[k][t][2 * r], st[k][t][2 * r + 1], hi, lo);
            *reinterpret_cast<uint32_t*>(ho + n * P + p) = hi;
            *reinterpret_cast<uint32_t*>(ho + N * P + n * P + p) = lo;
          }
        }
      }
    }
    __syncthreads();         // pass 1's reads of the ring and writes of h done
  }

  // ---- pass 2: the chunks in reverse
  float dh[NW][PT][4];
  {
    const float* ds = g.dstate + b * g.dstsb
                      + static_cast<long long>(h) * P * N;
#pragma unroll
    for (int k = 0; k < NW; ++k) {
      const int nt = mt + 4 * k;
#pragma unroll
      for (int t = 0; t < PT; ++t) {
        const int p = p0 + 8 * t + 2 * q;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int n = 16 * nt + gq + 8 * (e >> 1);
          dh[k][t][e] = nt < NT ? ds[(p + (e & 1)) * N + n] : 0.f;
        }
        if (nt < NT) {
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int n = 16 * nt + gq + 8 * r;
            uint32_t hi, lo;
            split2(dh[k][t][2 * r], dh[k][t][2 * r + 1], hi, lo);
            sts(s_dhh + 2 * (n * XP + p), hi);
            sts(s_dhl + 2 * (n * XP + p), lo);
          }
        }
      }
    }
  }
  float da_acc = 0.f, dd_acc = 0.f;
  {
    const int last = chunks - 1;
    load_chunk<P, N>(s0 + (last & 1) * S::kStage, g, xp, dyp, bp, cp, dtp,
                     last > 0 ? hs + static_cast<long long>(last - 1) * 2 * N * P
                              : nullptr,
                     last * kT, g.seq - last * kT, true, tid);
  }
  for (int ck = chunks - 1; ck >= 0; --ck) {
    const int t0 = ck * kT;
    const int rows = min(kT, g.seq - t0);
    const uint32_t st = s0 + (ck & 1) * S::kStage;
    const uint32_t sx = st + S::kX, sdy = st + S::kDy, sb = st + S::kB,
                   sc = st + S::kC, shh = st + S::kHh, shl = st + S::kHl;
    const float* sdt = reinterpret_cast<const float*>(
        smem + (ck & 1) * S::kStage + S::kDt);
    cp_async_wait_all();
    __syncthreads();         // chunk ck landed; dh's pair and the sums free
    if (ck > 0)
      load_chunk<P, N>(s0 + ((ck - 1) & 1) * S::kStage, g, xp, dyp, bp, cp,
                       dtp,
                       ck > 1 ? hs + static_cast<long long>(ck - 2) * 2 * N * P
                              : nullptr,
                       t0 - kT, kT, true, tid);

    const Scan scn = scan_chunk(sdt, a2, lane);
    const float cum_r0 = row_of(scn.cum0, scn.cum1, i0);
    const float cum_r1 = row_of(scn.cum0, scn.cum1, i0 + 8);
    const float dt_r0 = row_of(scn.dt0, scn.dt1, i0);
    const float dt_r1 = row_of(scn.dt0, scn.dt1, i0 + 8);
    const float w_r0 = ex2(scn.last - cum_r0) * dt_r0;
    const float w_r1 = ex2(scn.last - cum_r1) * dt_r1;
    const float e_r0 = ex2(cum_r0), e_r1 = ex2(cum_r1);

    // [state paths]  dx = w o (B dh^T), U = x dh (dB = w o U, dw = B . U),
    // V = exp(cum) o (dy h_z) (dC's inter part, dcum's C . V)
    float dxa[PT][4], dba[NH][4], dca[NH][4];
#pragma unroll
    for (int t = 0; t < PT; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) dxa[t][e] = 0.f;
#pragma unroll
    for (int t = 0; t < NH; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) dba[t][e] = dca[t][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KN; ++kk) {
      uint32_t af[4], bh_[PT][2], bl_[PT][2];
      load_a(af, sb, BP, 16 * mt, 16 * kk, lane);
      load_b_rows<PT>(bh_, s_dhh, XP, 16 * kk, p0, lane);
      load_b_rows<PT>(bl_, s_dhl, XP, 16 * kk, p0, lane);
#pragma unroll
      for (int t = 0; t < PT; ++t) {
        mma16816(dxa[t], af, bh_[t][0], bh_[t][1]);
        mma16816(dxa[t], af, bl_[t][0], bl_[t][1]);
      }
    }
#pragma unroll
    for (int t = 0; t < PT; ++t) {
      dxa[t][0] *= w_r0;
      dxa[t][1] *= w_r0;
      dxa[t][2] *= w_r1;
      dxa[t][3] *= w_r1;
    }
#pragma unroll
    for (int kk = 0; kk < KP; ++kk) {
      uint32_t ax[4], ad[4];
      load_a(ax, sx, XP, 16 * mt, 16 * kk, lane);
      load_a(ad, sdy, XP, 16 * mt, 16 * kk, lane);
      uint32_t f_hi[NH][2], f_lo[NH][2];
      load_b_cols<NH>(f_hi, s_dhh, XP, n0, 16 * kk, lane);
      load_b_cols<NH>(f_lo, s_dhl, XP, n0, 16 * kk, lane);
#pragma unroll
      for (int t = 0; t < NH; ++t) {
        mma16816(dba[t], ax, f_hi[t][0], f_hi[t][1]);
        mma16816(dba[t], ax, f_lo[t][0], f_lo[t][1]);
      }
      load_b_cols<NH>(f_hi, shh, XP, n0, 16 * kk, lane);
      load_b_cols<NH>(f_lo, shl, XP, n0, 16 * kk, lane);
#pragma unroll
      for (int t = 0; t < NH; ++t) {
        mma16816(dca[t], ad, f_hi[t][0], f_hi[t][1]);
        mma16816(dca[t], ad, f_lo[t][0], f_lo[t][1]);
      }
    }
    float dw_p0 = 0.f, dw_p1 = 0.f, dci_p0 = 0.f, dci_p1 = 0.f;
#pragma unroll
    for (int t = 0; t < NH; ++t) {
      const int n = n0 + 8 * t + 2 * q;
      const float2 b0 = lds2(sb + 2 * (i0 * BP + n));
      const float2 b1 = lds2(sb + 2 * ((i0 + 8) * BP + n));
      const float2 c0 = lds2(sc + 2 * (i0 * BP + n));
      const float2 c1 = lds2(sc + 2 * ((i0 + 8) * BP + n));
      dw_p0 += dba[t][0] * b0.x + dba[t][1] * b0.y;
      dw_p1 += dba[t][2] * b1.x + dba[t][3] * b1.y;
      dca[t][0] *= e_r0;
      dca[t][1] *= e_r0;
      dca[t][2] *= e_r1;
      dca[t][3] *= e_r1;
      dci_p0 += dca[t][0] * c0.x + dca[t][1] * c0.y;
      dci_p1 += dca[t][2] * c1.x + dca[t][3] * c1.y;
      dba[t][0] *= w_r0;
      dba[t][1] *= w_r0;
      dba[t][2] *= w_r1;
      dba[t][3] *= w_r1;
    }
    // <dh_{z+1}, h_z> over this thread's dh elements
    float s_p = 0.f;
#pragma unroll
    for (int k = 0; k < NW; ++k) {
      const int nt = mt + 4 * k;
      if (nt >= NT) continue;
#pragma unroll
      for (int t = 0; t < PT; ++t) {
        const int p = p0 + 8 * t + 2 * q;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int n = 16 * nt + gq + 8 * r;
          const float2 hh = lds2(shh + 2 * (n * XP + p));
          const float2 hl = lds2(shl + 2 * (n * XP + p));
          s_p += dh[k][t][2 * r] * (hh.x + hl.x)
                 + dh[k][t][2 * r + 1] * (hh.y + hl.y);
        }
      }
    }

    // [rows i]  G = C B^T and dM = dy x^T over the causal tiles j <= i:
    // dC += dG B, rowsum(dM o M)
    float rq0 = 0.f, rq1 = 0.f;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      if (kk > mt) continue;
      float ga[2][4], ma[2][4];
#pragma unroll
      for (int u = 0; u < 2; ++u)
#pragma unroll
        for (int e = 0; e < 4; ++e) ga[u][e] = ma[u][e] = 0.f;
#pragma unroll
      for (int k2 = 0; k2 < KN; ++k2) {
        uint32_t af[4], r[4];
        load_a(af, sc, BP, 16 * mt, 16 * k2, lane);
        ldsm_x4(r, sb + 2 * ((16 * kk + (lane & 7) + ((lane >> 4) << 3)) * BP
                             + 16 * k2 + ((lane >> 3) & 1) * 8));
        mma16816(ga[0], af, r[0], r[1]);
        mma16816(ga[1], af, r[2], r[3]);
      }
#pragma unroll
      for (int k2 = 0; k2 < KP; ++k2) {
        uint32_t af[4], r[4];
        load_a(af, sdy, XP, 16 * mt, 16 * k2, lane);
        ldsm_x4(r, sx + 2 * ((16 * kk + (lane & 7) + ((lane >> 4) << 3)) * XP
                             + 16 * k2 + ((lane >> 3) & 1) * 8));
        mma16816(ma[0], af, r[0], r[1]);
        mma16816(ma[1], af, r[2], r[3]);
      }
      uint32_t gh[4], gl[4];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int src = 8 * kk + 4 * u + q;     // holds rows j, j + 1
        const float cj0 = __shfl_sync(0xffffffffu, scn.cum0, src);
        const float cj1 = __shfl_sync(0xffffffffu, scn.cum1, src);
        const float dj0 = __shfl_sync(0xffffffffu, scn.dt0, src);
        const float dj1 = __shfl_sync(0xffffffffu, scn.dt1, src);
        const int j = 16 * kk + 8 * u + 2 * q;
        float dg[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = i0 + 8 * (e >> 1), jj = j + (e & 1);
          const float ci = (e >> 1) ? cum_r1 : cum_r0;
          const float cj = (e & 1) ? cj1 : cj0;
          const float dj = (e & 1) ? dj1 : dj0;
          const float l = jj <= i ? ex2(ci - cj) : 0.f;
          const float rr = ma[u][e] * ga[u][e] * l;   // dM G L
          dg[e] = ma[u][e] * l * dj;
          if (e >> 1) rq1 += rr * dj; else rq0 += rr * dj;
        }
        split2(dg[0], dg[1], gh[2 * u], gl[2 * u]);
        split2(dg[2], dg[3], gh[2 * u + 1], gl[2 * u + 1]);
      }
      uint32_t bf[NH][2];
      load_b_rows<NH>(bf, sb, BP, 16 * kk, n0, lane);
#pragma unroll
      for (int t = 0; t < NH; ++t) {
        mma16816(dca[t], gh, bf[t][0], bf[t][1]);
        mma16816(dca[t], gl, bf[t][0], bf[t][1]);
      }
    }

    // [rows j]  G^T = B C^T and dM^T = x dy^T over the tiles i >= j:
    // dx += M^T dy, dB += dG^T C, colsum(dM o G o L)
    float cr0 = 0.f, cr1 = 0.f;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      if (kk < mt) continue;
      float ga[2][4], ma[2][4];
#pragma unroll
      for (int u = 0; u < 2; ++u)
#pragma unroll
        for (int e = 0; e < 4; ++e) ga[u][e] = ma[u][e] = 0.f;
#pragma unroll
      for (int k2 = 0; k2 < KN; ++k2) {
        uint32_t af[4], r[4];
        load_a(af, sb, BP, 16 * mt, 16 * k2, lane);
        ldsm_x4(r, sc + 2 * ((16 * kk + (lane & 7) + ((lane >> 4) << 3)) * BP
                             + 16 * k2 + ((lane >> 3) & 1) * 8));
        mma16816(ga[0], af, r[0], r[1]);
        mma16816(ga[1], af, r[2], r[3]);
      }
#pragma unroll
      for (int k2 = 0; k2 < KP; ++k2) {
        uint32_t af[4], r[4];
        load_a(af, sx, XP, 16 * mt, 16 * k2, lane);
        ldsm_x4(r, sdy + 2 * ((16 * kk + (lane & 7) + ((lane >> 4) << 3)) * XP
                              + 16 * k2 + ((lane >> 3) & 1) * 8));
        mma16816(ma[0], af, r[0], r[1]);
        mma16816(ma[1], af, r[2], r[3]);
      }
      uint32_t mh[4], ml[4], gh[4], gl[4];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int src = 8 * kk + 4 * u + q;     // holds rows i, i + 1
        const float ci0 = __shfl_sync(0xffffffffu, scn.cum0, src);
        const float ci1 = __shfl_sync(0xffffffffu, scn.cum1, src);
        const int i = 16 * kk + 8 * u + 2 * q;
        float mv[4], dg[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int j = i0 + 8 * (e >> 1), ii = i + (e & 1);
          const float cj = (e >> 1) ? cum_r1 : cum_r0;
          const float dj = (e >> 1) ? dt_r1 : dt_r0;
          const float ci = (e & 1) ? ci1 : ci0;
          const float l = ii >= j ? ex2(ci - cj) : 0.f;
          const float gl_ = ga[u][e] * l;
          mv[e] = gl_ * dj;
          dg[e] = ma[u][e] * l * dj;
          if (e >> 1) cr1 += ma[u][e] * gl_; else cr0 += ma[u][e] * gl_;
        }
        split2(mv[0], mv[1], mh[2 * u], ml[2 * u]);
        split2(mv[2], mv[3], mh[2 * u + 1], ml[2 * u + 1]);
        split2(dg[0], dg[1], gh[2 * u], gl[2 * u]);
        split2(dg[2], dg[3], gh[2 * u + 1], gl[2 * u + 1]);
      }
      {
        uint32_t bf[PT][2];
        load_b_rows<PT>(bf, sdy, XP, 16 * kk, p0, lane);
#pragma unroll
        for (int t = 0; t < PT; ++t) {
          mma16816(dxa[t], mh, bf[t][0], bf[t][1]);
          mma16816(dxa[t], ml, bf[t][0], bf[t][1]);
        }
      }
      {
        uint32_t bf[NH][2];
        load_b_rows<NH>(bf, sc, BP, 16 * kk, n0, lane);
#pragma unroll
        for (int t = 0; t < NH; ++t) {
          mma16816(dba[t], gh, bf[t][0], bf[t][1]);
          mma16816(dba[t], gl, bf[t][0], bf[t][1]);
        }
      }
    }

    // [dh]  dh_z = exp(cum_last) dh_{z+1} + (exp(cum) o C)^T dy
    {
      const float el = ex2(scn.last);
#pragma unroll
      for (int k = 0; k < NW; ++k)
#pragma unroll
        for (int t = 0; t < PT; ++t)
#pragma unroll
          for (int e = 0; e < 4; ++e) dh[k][t][e] *= el;
    }
    {
      const float e0 = ex2(scn.cum0), e1 = ex2(scn.cum1);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const float ea0 = __shfl_sync(0xffffffffu, e0, 8 * kk + q);
        const float ea1 = __shfl_sync(0xffffffffu, e1, 8 * kk + q);
        const float eb0 = __shfl_sync(0xffffffffu, e0, 8 * kk + 4 + q);
        const float eb1 = __shfl_sync(0xffffffffu, e1, 8 * kk + 4 + q);
        uint32_t yf[PT][2];
        load_b_rows<PT>(yf, sdy, XP, 16 * kk, p0, lane);
#pragma unroll
        for (int k = 0; k < NW; ++k) {
          const int nt = mt + 4 * k;
          if (nt >= NT) continue;
          uint32_t r[4], ahi[4], alo[4];
          ldsm_x4_t(r, sc + 2 * ((16 * kk + (lane & 7) + (lane >> 4) * 8) * BP
                                 + 16 * nt + ((lane >> 3) & 1) * 8));
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float2 v = unpack2(r[e]);
            split2(v.x * (e < 2 ? ea0 : eb0), v.y * (e < 2 ? ea1 : eb1),
                   ahi[e], alo[e]);
          }
#pragma unroll
          for (int t = 0; t < PT; ++t) {
            mma16816(dh[k][t], ahi, yf[t][0], yf[t][1]);
            mma16816(dh[k][t], alo, yf[t][0], yf[t][1]);
          }
        }
      }
    }

    // [out]  dx (+ D dy, one rounding), dB and dC summed over the heads
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int i = i0 + 8 * r;
      if (i >= rows) continue;
      const long long row = t0 + i;
      bf16* dxr = g.dx + b * g.dxsb + row * g.dxss
                  + static_cast<long long>(h) * P;
#pragma unroll
      for (int t = 0; t < PT; ++t) {
        const int p = p0 + 8 * t + 2 * q;
        const float2 dyv = lds2(sdy + 2 * (i * XP + p));
        const float2 xv = lds2(sx + 2 * (i * XP + p));
        dd_acc += dyv.x * xv.x + dyv.y * xv.y;
        *reinterpret_cast<__nv_bfloat162*>(dxr + p) = __floats2bfloat162_rn(
            dxa[t][2 * r] + d_h * dyv.x, dxa[t][2 * r + 1] + d_h * dyv.y);
      }
      float* dbr = g.db + b * g.dbsb + row * g.dbss;
      float* dcr = g.dc + b * g.dcsb + row * g.dcss;
#pragma unroll
      for (int t = 0; t < NH; ++t) {
        const int n = n0 + 8 * t + 2 * q;
        atomicAdd(dbr + n, dba[t][2 * r]);
        atomicAdd(dbr + n + 1, dba[t][2 * r + 1]);
        atomicAdd(dcr + n, dca[t][2 * r]);
        atomicAdd(dcr + n + 1, dca[t][2 * r + 1]);
      }
    }
    // the per-row sums of this warp's columns
    rq0 = quad_sum(rq0);
    rq1 = quad_sum(rq1);
    cr0 = quad_sum(cr0);
    cr1 = quad_sum(cr1);
    dw_p0 = quad_sum(dw_p0);
    dw_p1 = quad_sum(dw_p1);
    dci_p0 = quad_sum(dci_p0);
    dci_p1 = quad_sum(dci_p1);
    s_p = warp_sum(s_p);
    if (q == 0) {
      if (half == 0) {                  // both halves hold the whole rows
        red_rowq[i0] = rq0;
        red_rowq[i0 + 8] = rq1;
        red_colr[i0] = cr0;
        red_colr[i0 + 8] = cr1;
      }
      red_dw[half * kT + i0] = dw_p0;
      red_dw[half * kT + i0 + 8] = dw_p1;
      red_dci[half * kT + i0] = dci_p0;
      red_dci[half * kT + i0 + 8] = dci_p1;
    }
    if (lane == 0) red_w[warp] = s_p;
    __syncthreads();         // every read of dh's pair done; sums in place

#pragma unroll
    for (int k = 0; k < NW; ++k) {
      const int nt = mt + 4 * k;
      if (nt >= NT) continue;
#pragma unroll
      for (int t = 0; t < PT; ++t) {
        const int p = p0 + 8 * t + 2 * q;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int n = 16 * nt + gq + 8 * r;
          uint32_t hi, lo;
          split2(dh[k][t][2 * r], dh[k][t][2 * r + 1], hi, lo);
          sts(s_dhh + 2 * (n * XP + p), hi);
          sts(s_dhl + 2 * (n * XP + p), lo);
        }
      }
    }
    if (warp == 0) {
      // dcum of rows 2 lane and 2 lane + 1, its reverse running sum, ddt
      const int r0 = 2 * lane, r1 = r0 + 1;
      const float w0 = ex2(scn.last - scn.cum0) * scn.dt0;
      const float w1 = ex2(scn.last - scn.cum1) * scn.dt1;
      const float dw0 = red_dw[r0] + red_dw[kT + r0];
      const float dw1 = red_dw[r1] + red_dw[kT + r1];
      const float cr_0 = red_colr[r0], cr_1 = red_colr[r1];
      float dc0 = red_rowq[r0] - scn.dt0 * cr_0 + red_dci[r0] + red_dci[kT + r0]
                  - dw0 * w0;
      float dc1 = red_rowq[r1] - scn.dt1 * cr_1 + red_dci[r1] + red_dci[kT + r1]
                  - dw1 * w1;
      const float dww = warp_sum(dw0 * w0 + dw1 * w1);
      float sz = 0.f;
#pragma unroll
      for (int k = 0; k < kWarps; ++k) sz += red_w[k];
      if (lane == 31) dc1 += dww + ex2(scn.last) * sz;
      // g_r = sum_{k >= r} dcum_k
      const float pair = dc0 + dc1;
      float incl = pair;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float o = __shfl_down_sync(0xffffffffu, incl, off);
        if (lane + off < 32) incl += o;
      }
      const float g1 = incl - pair + dc1;
      const float g0 = g1 + dc0;
      da_acc += scn.dt0 * g0 + scn.dt1 * g1;
      const float dd0 = a_h * g0 + cr_0 + dw0 * ex2(scn.last - scn.cum0);
      const float dd1 = a_h * g1 + cr_1 + dw1 * ex2(scn.last - scn.cum1);
      float* ddtp = g.ddt + b * g.ddtsb + h;
      if (r0 < rows) ddtp[(t0 + r0) * g.ddtss] = dd0;
      if (r1 < rows) ddtp[(t0 + r1) * g.ddtss] = dd1;
    }
  }

  // da and dD of this (batch, head)
  dd_acc = warp_sum(dd_acc);
  __syncthreads();           // warp 0's last reads of the sums are done
  if (lane == 0) red_w[warp] = dd_acc;
  __syncthreads();
  if (warp == 0) {
    da_acc = warp_sum(da_acc);
    if (lane == 0) {
      float s = 0.f;
#pragma unroll
      for (int k = 0; k < kWarps; ++k) s += red_w[k];
      g.dd[b * g.psb + h] = s;
      g.da[b * g.psb + h] = da_acc;
    }
  }
}

template <int P, int N>
int launch(const Args& g, cudaStream_t stream) {
  using S = BwdShape<P, N>;
  static const cudaError_t configured = cudaFuncSetAttribute(
      ssd_bwd_tc<P, N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      S::kSmem);
  if (configured != cudaSuccess) return configured;
  ssd_bwd_tc<P, N><<<g.bsz * g.heads, kThreads, S::kSmem, stream>>>(g);
  return cudaGetLastError();
}

// a 16-byte aligned base, and batch and sequence strides of a multiple of
// 8 elements wherever that dimension is longer than 1 (cp.async's rule)
bool aligned16(const void* p, long long sb, long long ss, int bsz, int seq) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0
         && (bsz == 1 || sb % 8 == 0) && (seq == 1 || ss % 8 == 0);
}

}  // namespace

// The SSD scan's gradients for one group of heads (bf16 x, B, C, dy at P x
// N = 112 x 64, 64 x 128 or 16 x 16): dx (bf16, written), ddt (float32,
// written), da and dD partials of each (batch, head) (float32, written at
// [b * psb + h]), dB and dC (float32, added to: the caller zeroes them and
// sums over the groups' heads).  scratch holds B H (ceil(S / 64) - 1) 2 N
// P bf16.  The wrapper checks shapes and alignment and raises; here a
// shape or alignment outside the kernel's returns cudaErrorInvalidValue.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int shark_ssd_scan_bwd(
    const void* x, long long xsb, long long xss, const void* dy,
    long long dysb, long long dyss, const void* dt, long long dtsb,
    long long dtss, const void* a, const void* d, const void* bm,
    long long bsb, long long bss, const void* cm, long long csb,
    long long css, const void* dstate, long long dstsb, int bsz, int seq,
    int heads, int p, int n, void* dx, long long dxsb, long long dxss,
    void* ddt, long long ddtsb, long long ddtss, void* da, void* dd,
    long long psb, void* db, long long dbsb, long long dbss, void* dc,
    long long dcsb, long long dcss, void* scratch, void* stream) {
  if (seq < 1 || bsz < 1 || heads < 1
      || !aligned16(x, xsb, xss, bsz, seq) || !aligned16(dy, dysb, dyss, bsz, seq)
      || !aligned16(bm, bsb, bss, bsz, seq) || !aligned16(cm, csb, css, bsz, seq)
      || (reinterpret_cast<uintptr_t>(scratch) & 15) != 0)
    return cudaErrorInvalidValue;
  const Args g{static_cast<const bf16*>(x), xsb, xss,
               static_cast<const bf16*>(dy), dysb, dyss,
               static_cast<const float*>(dt), dtsb, dtss,
               static_cast<const float*>(a), static_cast<const float*>(d),
               static_cast<const bf16*>(bm), bsb, bss,
               static_cast<const bf16*>(cm), csb, css,
               static_cast<const float*>(dstate), dstsb, bsz, seq, heads,
               static_cast<bf16*>(dx), dxsb, dxss,
               static_cast<float*>(ddt), ddtsb, ddtss,
               static_cast<float*>(da), static_cast<float*>(dd), psb,
               static_cast<float*>(db), dbsb, dbss,
               static_cast<float*>(dc), dcsb, dcss,
               static_cast<bf16*>(scratch)};
  const auto st = static_cast<cudaStream_t>(stream);
  if (p == 112 && n == 64) return launch<112, 64>(g, st);
  if (p == 64 && n == 128) return launch<64, 128>(g, st);
  if (p == 16 && n == 16) return launch<16, 16>(g, st);
  return cudaErrorInvalidValue;
}
