// Per-frame SI and TI partial sums of u8/u16 luma, for Hopper (sm_90a).
// Built by ops/_build.py with nvcc into a plain C shared library and bound
// with ctypes (ops/cuda_kernels.py).
//
// siti_partials<T, kTI> is one strip walk with two instances. The fused
// SI+TI pass (kTI) replaces the TPU kernels
// processing_chain_tpu/ops/pallas_kernels.py siti_frames_fused_batch
// (:398-428; _siti_batch_kernel :386-395) and siti_frames_fused (:355-383;
// _siti_partial_kernel :345-352), which share the stripe body
// _siti_stripe_rows (:325-333): a batch axis and a per-frame predecessor
// (frame (b, t-1), or prev_last[b] for t = 0, or none: TI = 0). The SI
// pass (no kTI) replaces si_frames_fused (:293-313; _sobel_stripe_stats
// :263-283; _std_from_partials :336-342). What bounds them on an H100: a
// 64-frame 2160x3840 u8 chunk is 531 MB read once (0.158 ms at 3.35 TB/s;
// 539 MB, 0.161 ms, with the predecessor frames TI reads) and ~14 SI
// operations per pixel, which this design runs in f32 (7.42 G, 0.111 ms at
// 67 T fp32 ops/s), so the SI pass is bound by its bytes; the fused pass
// adds 4 TI operations in int32 (2.12 G, 0.063 ms at 33.5 T int32 ops/s),
// 0.174 ms in all, so operations bind it, just above its bytes. In
// practice instructions bind both (the u8 SI row step is ~24 SASS
// instructions a pixel, issued at about two thirds of the SMs' rate), so
// the design spends as few instructions per pixel as it can:
//  * a thread owns 16 bytes of columns (16 u8 or 8 u16 samples) of a
//    64-row strip and walks down it, one coalesced 16-byte load per row
//    (issued a row ahead), rows r - 1, r, r + 1 held in registers; nothing
//    goes through shared memory but the block's final sums;
//  * the Sobel is separable: per column s = up + 2 md + dn and d = dn - up,
//    then gx = s[c+1] - s[c-1] and gy = d[c-1] + 2 d[c] + d[c+1], the
//    neighbours across a thread's edge from the next lanes (__shfl) and
//    across the warp's edge loaded directly by lanes 0 and 31. u8 samples
//    convert to f32 by a byte permute and one add, and every gradient
//    value, square and 4-term sum is an exact integer in f32, so the
//    arithmetic runs on the fp32 pipe at twice the int32 rate;
//  * Σ|∇| takes RowMag: the root as x * rsqrt(x) plus its exact-residual
//    correction, split so that a row's 16 terms sum exactly in f32 and go
//    to f64 once per row (~9 instructions a term against MagSum's ~15);
//  * with kTI, TI's Σd and Σd² come from the same row vectors against the
//    predecessor's row by byte dot products (dp4a), about 1.25 int32
//    instructions per pixel; without it no predecessor row is loaded and
//    the walk keeps only the SI sums;
//  * the warp stays converged around the shuffles: one masked path for
//    every lane, predicated edge and row loads, __syncwarp before the
//    shuffles (the first version, with a per-lane branch there, ran 1.5x
//    slower).
// The per-thread sums stay exact in 32 bits for a row (u8) and widen to 64
// bits once per row. Ownership is a partition of the source pixels (rows 0
// and H-1 and columns 0 and W-1 included), so every pixel's difference is
// counted exactly once, and no [B, T+1] copy of the chunk is built.
//
// ti_partials, the separate TI pass, replaces ti_frames_fused (:443-465;
// _ti_partial_kernel :431-440): 16-byte vector loads of each frame and its
// predecessor, ~4 integer operations per pixel, one partial per block.
//
// Numerics: the Pallas kernels keep f32 sufficient statistics, and
// sigma = sqrt(E[x^2] - E[x]^2) over 8.3 M samples is where f32
// cancellation bites. Here Σ(gx²+gy²), Σd and Σd² are exact int64 sums
// of exact integer terms, and Σ|∇| is an f64 sum of square roots good to
// ~1e-14 (RowMag for u8, MagSum for u16). The caller reduces the per-block
// partials in f64. The right and bottom edges (gradient columns >= W-1,
// rows >= H-1) are masked here, as the Pallas kernel masked `col < w - 1`.
// TI takes an optional predecessor frame, so a chunk's first TI is
// computed in the kernel against the previous chunk's last frame (kept at
// container depth).

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int THREADS = 256;

__device__ __forceinline__ double warp_sum(double v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ long long warp_sum(long long v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

// Σ|∇| of u16 gradients to about double precision without f64 sums per
// pixel. SI is sqrt(E[m²] - E[m]²) with E[m²] exact, so on a frame with
// few gradients any rounding of the square roots shows as σ > 0 where the
// exact σ is 0 (one f32 sqrt per term leaves ~0.03 on a 3x3 frame). Each
// term is its f64 root split into the f32 m plus a correction, and the f32
// sum carries its rounding errors in `lo` (TwoSum), so hi + lo is good to
// ~1e-14 relative. (u8 terms take RowMag, below.)
struct MagSum {
  float hi = 0.0f, lo = 0.0f;

  __device__ __forceinline__ void add(float m, float c) {
    const float t = hi + m;
    const float bp = t - hi;
    lo += ((hi - (t - bp)) + (m - bp)) + c;
    hi = t;
  }
  __device__ __forceinline__ void add(long long m2) {
    const double md = sqrt((double)m2);
    const float m = (float)md;
    add(m, (float)(md - (double)m));
  }
  __device__ __forceinline__ double value() const {
    return (double)hi + (double)lo;
  }
};

// Block-wide sums of (a, b); the result is valid in thread 0.
template <typename A, typename B>
__device__ __forceinline__ void block_sum(A& a, B& b) {
  __shared__ A sa[THREADS / 32];
  __shared__ B sb[THREADS / 32];
  a = warp_sum(a);
  b = warp_sum(b);
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  if (lane == 0) {
    sa[warp] = a;
    sb[warp] = b;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int k = 1; k < THREADS / 32; ++k) {
      a += sa[k];
      b += sb[k];
    }
  }
}

// Σd and Σd² of one 16-byte vector pair (16 u8 or 8 u16 samples).
__device__ __forceinline__ void diff_vec(const uint4& a, const uint4& b,
                                         long long& s1, long long& s2,
                                         uint8_t) {
  const unsigned wa[4] = {a.x, a.y, a.z, a.w};
  const unsigned wb[4] = {b.x, b.y, b.z, b.w};
  int d1 = 0, d2 = 0;  // <= 16 * 255^2: fits int32
#pragma unroll
  for (int q = 0; q < 4; ++q) {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int d = (int)((wa[q] >> (8 * k)) & 0xffu) -
                    (int)((wb[q] >> (8 * k)) & 0xffu);
      d1 += d;
      d2 += d * d;
    }
  }
  s1 += d1;
  s2 += d2;
}

__device__ __forceinline__ void diff_vec(const uint4& a, const uint4& b,
                                         long long& s1, long long& s2,
                                         uint16_t) {
  const unsigned wa[4] = {a.x, a.y, a.z, a.w};
  const unsigned wb[4] = {b.x, b.y, b.z, b.w};
  int d1 = 0;
  long long d2 = 0;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const int d = (int)((wa[q] >> (16 * k)) & 0xffffu) -
                    (int)((wb[q] >> (16 * k)) & 0xffffu);
      d1 += d;
      d2 += (long long)d * d;
    }
  }
  s1 += d1;
  s2 += d2;
}

// grid (n_blk, T): block b of frame t sums d = y[t] - y[t-1] (y[-1] =
// prev; no predecessor -> zero partials, TI[0] = 0) over a grid-stride
// slice of the H*W samples. vec: both frames 16-byte aligned and H*W*size
// a multiple of 16, so the whole frame goes as uint4 loads.
template <typename T>
__global__ void __launch_bounds__(THREADS) ti_partials(
    const T* __restrict__ y, const T* __restrict__ prev, long long hw,
    int vec, long long* __restrict__ ps1, long long* __restrict__ ps2) {
  const int t = blockIdx.y;
  const T* cur = y + (size_t)t * hw;
  const T* pre = t > 0 ? y + (size_t)(t - 1) * hw : prev;
  long long s1 = 0, s2 = 0;
  if (pre != nullptr) {
    const long long start = (long long)blockIdx.x * THREADS + threadIdx.x;
    const long long stride = (long long)gridDim.x * THREADS;
    if (vec) {
      const long long nvec = hw * (long long)sizeof(T) / 16;
      const uint4* a = reinterpret_cast<const uint4*>(cur);
      const uint4* b = reinterpret_cast<const uint4*>(pre);
      for (long long v = start; v < nvec; v += stride)
        diff_vec(a[v], b[v], s1, s2, T());
    } else {
      for (long long i = start; i < hw; i += stride) {
        const long long d = (long long)cur[i] - (long long)pre[i];
        s1 += d;
        s2 += d * d;
      }
    }
  }
  block_sum(s1, s2);
  if (threadIdx.x == 0) {
    ps1[(size_t)t * gridDim.x + blockIdx.x] = s1;
    ps2[(size_t)t * gridDim.x + blockIdx.x] = s2;
  }
}

// Block-wide sums of four partials; the result is valid in thread 0.
__device__ __forceinline__ void block_sum4(double& a, long long& b,
                                           long long& c, long long& d) {
  __shared__ double sa[THREADS / 32];
  __shared__ long long sb[THREADS / 32], sc[THREADS / 32], sd[THREADS / 32];
  a = warp_sum(a);
  b = warp_sum(b);
  c = warp_sum(c);
  d = warp_sum(d);
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  if (lane == 0) {
    sa[warp] = a;
    sb[warp] = b;
    sc[warp] = c;
    sd[warp] = d;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int k = 1; k < THREADS / 32; ++k) {
      a += sa[k];
      b += sb[k];
      c += sc[k];
      d += sd[k];
    }
  }
}

constexpr int ST_ROWS = 64;   // owned source rows per strip
constexpr int ST_BYTES = 16;  // bytes of owned columns per thread (one vector)

// Σ|∇| of u8 gradients for the strip walk, to ~1e-14 relative like MagSum
// at a fraction of its cost. The root of each exact integer term x < 2^24
// is m = x * rsqrt(x) (a few ulp) plus the first-order correction
// (x - m²) / 2m, summed as Σ r * rsqrt(x) / 2 (r = x - m² by one fma). m
// splits into hi, m rounded to a multiple of 2^-8 (m < 2^11, so a row of
// 16 his sums exactly in f32), and lo = m - hi; each row's Σhi goes to an
// f64 sum once per row, and Σlo and the corrections stay small f32 sums.
struct RowMag {
  double acc = 0.0;  // Σ hi of finished rows
  float row = 0.0f;  // Σ hi of this row: exact (multiples of 2^-8, < 2^16)
  float lo = 0.0f;   // Σ (m - hi)
  float cor = 0.0f;  // Σ r * rsqrt(x): twice the corrections

  // x: the term, 0 or an exact integer below 2^24 or 2^-100 (whose root
  // 2^-50 stands in for 0); xr: x, or any normal positive number where x
  // is 0, so that the hardware approximation needs none of rsqrtf's
  // denormal handling and m = x * y is 0 there
  __device__ __forceinline__ void add(float x, float xr) {
    float y;
    asm("rsqrt.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(xr));
    const float m = x * y;
    const float r = fmaf(-m, m, x);
    cor = fmaf(r, y, cor);
    const float hi = (m + 49152.0f) - 49152.0f;  // ulp 2^-8 in [2^15, 2^16)
    row += hi;
    lo += m - hi;
  }
  __device__ __forceinline__ void end_row() {
    acc += (double)row;
    row = 0.0f;
  }
  __device__ __forceinline__ double value() const {
    return acc + (double)lo + 0.5 * (double)cor;
  }
};

// One strip row of a thread's C = 16 / sizeof(T) owned columns: the samples
// (f32 for u8, whose gradient arithmetic is exact in f32; int for u16) and,
// for lanes 0 and 31, the column just left / right of the warp's span.
template <typename T>
struct StripRow {
  using V = typename std::conditional<sizeof(T) == 1, float, int>::type;
  static constexpr int C = ST_BYTES / sizeof(T);
  V v[C];
  V el, er;
};

// The 16-byte vector of columns cb .. cb + C - 1 of row r of frame f
// (zeros outside the frame), by one load when rows are 16-byte aligned.
template <typename T>
__device__ __forceinline__ uint4 load_vec(const T* __restrict__ f, int r,
                                          int h, int w, int cb, int vec) {
  constexpr int C = ST_BYTES / sizeof(T);
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  const bool ok = r >= 0 && r < h && cb < w;
  if (vec) {  // a predicated load: the warp does not branch
    uint4 q = zero;
    if (ok) q = *reinterpret_cast<const uint4*>(f + (size_t)r * w + cb);
    return q;
  }
  if (!ok) return zero;
  const T* p = f + (size_t)r * w + cb;
  uint32_t u[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int j = 0; j < C; ++j) {
    const uint32_t s = cb + j < w ? (uint32_t)p[j] : 0u;
    u[j * sizeof(T) / 4] |= s << (8 * ((j * sizeof(T)) % 4));
  }
  return make_uint4(u[0], u[1], u[2], u[3]);
}

// Unpack a vector into row.v: u8 samples to exact f32 through the
// 2^23 magic (one byte permute and one add each), u16 samples to int.
template <typename T>
__device__ __forceinline__ void unpack_row(const uint4& q, StripRow<T>& row) {
  const uint32_t u[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
  for (int j = 0; j < StripRow<T>::C; ++j) {
    if constexpr (sizeof(T) == 1)
      row.v[j] = __int_as_float(__byte_perm(u[j / 4], 0x4b000000u,
                                            0x7540u | (j % 4))) - 8388608.0f;
    else
      row.v[j] = (int)((u[j / 2] >> (16 * (j % 2))) & 0xffffu);
  }
}

// Column c of row r of frame f for lanes 0 and 31 (the columns beside the
// warp's span), 0 elsewhere and outside the frame; one predicated load, so
// the warp does not diverge.
template <typename T>
__device__ __forceinline__ typename StripRow<T>::V edge_sample(
    const T* __restrict__ f, int r, int h, int w, int c, bool edge_lane) {
  using V = typename StripRow<T>::V;
  V x = 0;
  if (edge_lane && r >= 0 && r < h && c >= 0 && c < w)
    x = (V)f[(size_t)r * w + c];
  return x;
}

// Per-thread sums of the strip walk; the SI pass never touches the TI
// fields, so they cost it nothing.
template <typename T>
struct StripSums {
  RowMag mag8;            // Σ|∇| (u8)
  MagSum mag16;           // Σ|∇| (u16)
  long long s2 = 0;       // Σ(gx² + gy²)
  long long d1 = 0, d2 = 0;  // Σd, Σd² (u16)
  int sd = 0;                // u8: Σc - Σp
  uint32_t sq = 0, cp = 0;   // u8: Σc² + Σp², Σcp
};

// Σ a_i b_i over the four bytes of a (signed) and b (unsigned), plus c.
__device__ __forceinline__ int dp4a_su(uint32_t a, uint32_t b, int c) {
  int d;
  asm("dp4a.s32.u32 %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(b), "r"(c));
  return d;
}

// TI terms of one owned row vector: u8 by byte dot products (Σd = Σc - Σp
// with +1 and -1 weights, Σd² = (Σc² + Σp²) - 2Σcp, all exact in 32 bits
// over a strip), u16 by diff_vec.
template <typename T>
__device__ __forceinline__ void ti_vec(const uint4& c, const uint4& p,
                                       StripSums<T>& acc) {
  if constexpr (sizeof(T) == 1) {
    const uint32_t cu[4] = {c.x, c.y, c.z, c.w};
    const uint32_t pu[4] = {p.x, p.y, p.z, p.w};
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      acc.sd = dp4a_su(0x01010101u, cu[q], acc.sd);
      acc.sd = dp4a_su(0xffffffffu, pu[q], acc.sd);
      acc.sq = __dp4a(cu[q], cu[q], acc.sq);
      acc.sq = __dp4a(pu[q], pu[q], acc.sq);
      acc.cp = __dp4a(cu[q], pu[q], acc.cp);
    }
  } else {
    diff_vec(c, p, acc.d1, acc.d2, T());
  }
}

// The u8 SI terms of one row from the vertical smooths s and differences
// d (index j + 1 for column cb + j): Σ|∇| and Σ(gx² + gy²), the latter
// through exact f32 sums of 4 terms (<= 4 * 2 * 1020² < 2^23) read back as
// integers. col[j] (1 or 0) multiplies column cb + j's term. The root's
// argument gets a floor of 2^-100 inside the fma: a normal f32 far below
// half an ulp of every nonzero term, so it changes none, and where both
// gradients are 0 the term is 2^-100 and its root 2^-50 (negligible, and
// lost when the 4-term sums are read back as integers).
template <int N>
__device__ __forceinline__ void si_terms8(const float (&s)[N],
                                          const float (&d)[N],
                                          const float (&col)[N - 2],
                                          StripSums<uint8_t>& acc) {
  constexpr int C = N - 2;
  int row2 = 0;
#pragma unroll
  for (int g = 0; g < C / 4; ++g) {
    float quad = 0.0f;
#pragma unroll
    for (int j = 4 * g; j < 4 * g + 4; ++j) {
      const float gx = s[j + 2] - s[j];
      const float gy = d[j] + d[j + 2] + 2.0f * d[j + 1];
      const float xr = fmaf(gx, gx, fmaf(gy, gy, 0x1p-100f));
      const float m2 = xr * col[j];
      acc.mag8.add(m2, xr);
      quad += m2;
    }
    row2 += __float_as_int(quad + 8388608.0f) - 0x4b000000;
  }
  acc.mag8.end_row();
  acc.s2 += row2;
}

// SI terms of centre row r from rows r - 1 (up), r (md), r + 1 (dn), by the
// separable Sobel: per column the vertical smooth s = up + 2 md + dn and
// difference d = dn - up, then gx = s[c+1] - s[c-1] and
// gy = d[c-1] + 2 d[c] + d[c+1]. The neighbours across a thread's edge come
// from the next lanes; across the warp's edge from el/er. col[j]: 1 when
// column cb + j has a Sobel interior, else 0.
template <typename T>
__device__ __forceinline__ void si_row(
    const StripRow<T>& up, const StripRow<T>& md, const StripRow<T>& dn,
    int lane, const typename StripRow<T>::V (&col)[StripRow<T>::C],
    StripSums<T>& acc) {
  using V = typename StripRow<T>::V;
  constexpr int C = StripRow<T>::C;
  V s[C + 2], d[C + 2];  // index j + 1 holds column cb + j
  s[1] = up.v[0] + dn.v[0] + 2 * md.v[0];
  d[1] = dn.v[0] - up.v[0];
  s[C] = up.v[C - 1] + dn.v[C - 1] + 2 * md.v[C - 1];
  d[C] = dn.v[C - 1] - up.v[C - 1];
  __syncwarp();  // the shuffles' fast path needs the warp converged
  s[0] = __shfl_up_sync(0xffffffffu, s[C], 1);
  d[0] = __shfl_up_sync(0xffffffffu, d[C], 1);
  s[C + 1] = __shfl_down_sync(0xffffffffu, s[1], 1);
  d[C + 1] = __shfl_down_sync(0xffffffffu, d[1], 1);
#pragma unroll
  for (int j = 1; j < C - 1; ++j) {
    s[j + 1] = up.v[j] + dn.v[j] + 2 * md.v[j];
    d[j + 1] = dn.v[j] - up.v[j];
  }
  if (lane == 0) {
    s[0] = up.el + dn.el + 2 * md.el;
    d[0] = dn.el - up.el;
  }
  if (lane == 31) {
    s[C + 1] = up.er + dn.er + 2 * md.er;
    d[C + 1] = dn.er - up.er;
  }
  if constexpr (sizeof(T) == 1) {
    si_terms8(s, d, col, acc);
  } else {
#pragma unroll
    for (int j = 0; j < C; ++j) {
      if (col[j] == 0) continue;
      const long long gx = s[j + 2] - s[j];
      const long long gy = d[j] + d[j + 2] + 2 * d[j + 1];
      const long long m2 = gx * gx + gy * gy;
      acc.mag16.add(m2);
      acc.s2 += m2;
    }
  }
}

// The next strip row, loaded one step ahead of its use: the samples and
// edge columns of row r of cur and, with kTI, the predecessor's row r when
// it is an owned row with a predecessor (else zeros).
template <typename T, bool kTI>
struct RowAhead {
  uint4 q, p;  // p: kTI only
  typename StripRow<T>::V el, er;

  __device__ __forceinline__ void load(const T* __restrict__ cur,
                                       const T* __restrict__ pre, int r,
                                       int r1, int h, int w, int cb, int lane,
                                       int vec) {
    constexpr int C = StripRow<T>::C;
    q = load_vec(cur, r, h, w, cb, vec);
    if constexpr (kTI)
      p = pre != nullptr && r < r1 ? load_vec(pre, r, h, w, cb, vec)
                                   : make_uint4(0u, 0u, 0u, 0u);
    el = edge_sample(cur, r, h, w, cb - 1, lane == 0);
    er = edge_sample(cur, r, h, w, cb + C, lane == 31);
  }
  // into a strip row, taking the owned row's TI terms on the way (kTI)
  __device__ __forceinline__ void take(StripRow<T>& row, bool ti,
                                       StripSums<T>& acc) const {
    if constexpr (kTI)
      if (ti) ti_vec(q, p, acc);
    unpack_row(q, row);
    row.el = el;
    row.er = er;
  }
};

// One step of the strip walk: centre row r with rows r - 1, r, r + 1 in
// up, md, dn. dn takes row r + 1 from `ahead` (its slot held row r - 2),
// with the TI terms of row r + 1 when it is owned; `ahead` then starts the
// loads of row r + 2, which stay in flight during row r's SI.
template <typename T, bool kTI>
__device__ __forceinline__ void strip_step(
    StripRow<T>& up, StripRow<T>& md, StripRow<T>& dn,
    RowAhead<T, kTI>& ahead, const T* __restrict__ cur,
    const T* __restrict__ pre, int r, int r1, int h, int w, int cb, int lane,
    int vec, const typename StripRow<T>::V (&col)[StripRow<T>::C],
    StripSums<T>& acc) {
  ahead.take(dn, pre != nullptr && r + 1 < r1, acc);
  ahead.load(cur, pre, r + 2, r1, h, w, cb, lane, vec);
  if (r >= 1 && r <= h - 2) si_row(up, md, dn, lane, col, acc);
}

// SI (and, with kTI, TI) partials of nz = B*T frames y [B, T, H, W]. grid
// (ceil(W / (256 C)), ceil(H / ST_ROWS), <= nz) with C = 16 / sizeof(T);
// blocks stride over the frames in z. Thread k of block (x, y) owns
// columns [C (256 x + k), C (256 x + k + 1)) of source rows
// [ST_ROWS y, ST_ROWS (y + 1)) (clipped to the frame), and walks down them
// with the rows above and below in registers. Block (x, y) of frame z
// writes, at [z][y * gridDim.x + x]: ps1 = Σ|∇| (f64) and ps2 = Σ(gx²+gy²)
// over the owned pixels with 1 <= r <= H-2 and 1 <= c <= W-2 and, with
// kTI, pd1 = Σd, pd2 = Σd² over all owned pixels, d = y[b, t] - pred: pred
// = y[b, t-1] for t > 0, prev[b] for t = 0 when prev is given, else none
// (d sums stay 0, so TI[b, 0] = 0). Without kTI, prev, pd1 and pd2 are not
// read. vec: rows of W samples are a multiple of 16 bytes and y and prev
// are 16-byte aligned, so each owned row segment is one uint4 load.
// Two blocks an SM (128 registers a thread): the u8 walks need them, and
// with three (85 registers) ptxas spills the u8 SI walk, which then runs
// slower (tune_siti.py).
template <typename T, bool kTI>
__global__ void __launch_bounds__(THREADS, 2)
    siti_partials(const T* __restrict__ y, const T* __restrict__ prev, int t,
                  int nz, int h, int w, int vec, double* __restrict__ ps1,
                  long long* __restrict__ ps2, long long* __restrict__ pd1,
                  long long* __restrict__ pd2) {
  constexpr int C = StripRow<T>::C;
  const size_t hw = (size_t)h * w;
  const int lane = threadIdx.x % 32;
  const int cb = (blockIdx.x * THREADS + threadIdx.x) * C;
  const bool warp_live = (cb - lane * C) < w;  // warp-uniform
  const int r0 = blockIdx.y * ST_ROWS, r1 = min(r0 + ST_ROWS, h);
  // column factors, kept in registers over the walk: a bit mask would be
  // turned back into predicates at every row (two compares a column)
  typename StripRow<T>::V col[C];
#pragma unroll
  for (int j = 0; j < C; ++j) col[j] = cb + j >= 1 && cb + j <= w - 2;
  const size_t blk = (size_t)blockIdx.y * gridDim.x + blockIdx.x;
  const size_t nblk = (size_t)gridDim.x * gridDim.y;

  for (int z = blockIdx.z; z < nz; z += gridDim.z) {
    const T* cur = y + (size_t)z * hw;
    const T* pre = nullptr;
    if constexpr (kTI) {
      const int tz = z % t;
      pre = tz > 0 ? cur - hw
                   : (prev != nullptr ? prev + (size_t)(z / t) * hw : nullptr);
    }
    StripSums<T> acc;
    if (warp_live) {
      StripRow<T> a, b, c;
      RowAhead<T, kTI> ahead;
      ahead.load(cur, pre, r0 - 1, r1, h, w, cb, lane, vec);
      ahead.take(a, false, acc);
      ahead.load(cur, pre, r0, r1, h, w, cb, lane, vec);
      ahead.take(b, pre != nullptr, acc);
      ahead.load(cur, pre, r0 + 1, r1, h, w, cb, lane, vec);
      if constexpr (sizeof(T) == 1) {
        // three steps a turn, the rows' roles rotating, so that no row is
        // copied (the copies were 50 of ~500 instructions a step)
        for (int r = r0; r < r1; r += 3) {
          strip_step(a, b, c, ahead, cur, pre, r, r1, h, w, cb, lane, vec,
                     col, acc);
          if (r + 1 >= r1) break;
          strip_step(b, c, a, ahead, cur, pre, r + 1, r1, h, w, cb, lane,
                     vec, col, acc);
          if (r + 2 >= r1) break;
          strip_step(c, a, b, ahead, cur, pre, r + 2, r1, h, w, cb, lane,
                     vec, col, acc);
        }
      } else {
        // u16: one step a row, the rows copied down; rotating, the walk
        // needs 100 registers instead of 70 and loses a block an SM
        for (int r = r0; r < r1; ++r) {
          strip_step(a, b, c, ahead, cur, pre, r, r1, h, w, cb, lane, vec,
                     col, acc);
          a = b;
          b = c;
        }
      }
    }
    double s1;
    if constexpr (sizeof(T) == 1)
      s1 = acc.mag8.value();
    else
      s1 = acc.mag16.value();
    long long s2 = acc.s2;
    const size_t o = (size_t)z * nblk + blk;
    if constexpr (kTI) {
      long long d1, d2;
      if constexpr (sizeof(T) == 1) {
        d1 = acc.sd;
        d2 = (long long)acc.sq - 2 * (long long)acc.cp;
      } else {
        d1 = acc.d1;
        d2 = acc.d2;
      }
      block_sum4(s1, s2, d1, d2);
      if (threadIdx.x == 0) {
        ps1[o] = s1;
        ps2[o] = s2;
        pd1[o] = d1;
        pd2[o] = d2;
      }
    } else {
      block_sum(s1, s2);
      if (threadIdx.x == 0) {
        ps1[o] = s1;
        ps2[o] = s2;
      }
    }
    __syncthreads();  // thread 0 has read the block sum's shared partials
  }
}

// One launch of the strip walk over nz frames (see siti_partials).
template <bool kTI>
int launch_strips(const void* y, const void* prev, int t, int nz, int h,
                  int w, int elem_bytes, int vec, void* ps1, void* ps2,
                  void* pd1, void* pd2, void* stream) {
  if (t <= 0 || nz <= 0 || nz % t != 0 || (elem_bytes != 1 && elem_bytes != 2))
    return (int)cudaErrorInvalidValue;
  const int cols = THREADS * ST_BYTES / elem_bytes;  // owned columns per block
  dim3 grid((w + cols - 1) / cols, (h + ST_ROWS - 1) / ST_ROWS,
            nz < 65535 ? nz : 65535);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  double* p1 = static_cast<double*>(ps1);
  long long* p2 = static_cast<long long*>(ps2);
  long long* q1 = static_cast<long long*>(pd1);
  long long* q2 = static_cast<long long*>(pd2);
  if (elem_bytes == 1)
    siti_partials<uint8_t, kTI><<<grid, THREADS, 0, s>>>(
        static_cast<const uint8_t*>(y), static_cast<const uint8_t*>(prev), t,
        nz, h, w, vec, p1, p2, q1, q2);
  else
    siti_partials<uint16_t, kTI><<<grid, THREADS, 0, s>>>(
        static_cast<const uint16_t*>(y), static_cast<const uint16_t*>(prev),
        t, nz, h, w, vec, p1, p2, q1, q2);
  return (int)cudaGetLastError();
}

}  // namespace

// The grids and partials below: [nz, n_ty, n_tx] with
// n_tx = ceil(w * elem_bytes / 4096) (256 threads x 16 bytes of columns)
// and n_ty = ceil(h / 64); vec as in siti_partials.

// y: [t, h, w] u8 (elem_bytes 1) or u16 (2). ps1 f64 = Σ|∇|, ps2 int64 =
// Σ(gx²+gy²) per frame and block (nz = t).
extern "C" int pc_si_partials(const void* y, int t, int h, int w,
                              int elem_bytes, int vec, void* ps1, void* ps2,
                              void* stream) {
  return launch_strips<false>(y, nullptr, t, t, h, w, elem_bytes, vec, ps1,
                              ps2, nullptr, nullptr, stream);
}

// y: [nz / t, t, h, w] u8/u16; prev: [nz / t, h, w] same type, or null.
// ps1 f64 and ps2/pd1/pd2 int64 per frame and block.
extern "C" int pc_siti_partials(const void* y, const void* prev, int t,
                                int nz, int h, int w, int elem_bytes,
                                int vec, void* ps1, void* ps2, void* pd1,
                                void* pd2, void* stream) {
  return launch_strips<true>(y, prev, t, nz, h, w, elem_bytes, vec, ps1, ps2,
                             pd1, pd2, stream);
}

// y: [t, h*w] u8/u16; prev: [h*w] same type, or null. ps1/ps2 int64:
// [t, n_blk].
extern "C" int pc_ti_partials(const void* y, const void* prev, int t,
                              long long hw, int elem_bytes, int vec,
                              int n_blk, void* ps1, void* ps2,
                              void* stream) {
  dim3 grid(n_blk, t);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  long long* p1 = static_cast<long long*>(ps1);
  long long* p2 = static_cast<long long*>(ps2);
  if (elem_bytes == 1)
    ti_partials<uint8_t><<<grid, THREADS, 0, s>>>(
        static_cast<const uint8_t*>(y), static_cast<const uint8_t*>(prev),
        hw, vec, p1, p2);
  else if (elem_bytes == 2)
    ti_partials<uint16_t><<<grid, THREADS, 0, s>>>(
        static_cast<const uint16_t*>(y), static_cast<const uint16_t*>(prev),
        hw, vec, p1, p2);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
