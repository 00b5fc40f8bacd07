// Per-frame SI and TI partial sums of u8/u16 luma, for Hopper (sm_90a).
// Built by ops/_build.py with nvcc into a plain C shared library and bound
// with ctypes (ops/cuda_kernels.py).
//
// siti_partials, the fused SI+TI pass, replaces the TPU kernels
// processing_chain_tpu/ops/pallas_kernels.py siti_frames_fused_batch
// (:398-428; _siti_batch_kernel :386-395) and siti_frames_fused (:355-383;
// _siti_partial_kernel :345-352), which share the stripe body
// _siti_stripe_rows (:325-333). One template serves both: a batch axis and
// a per-frame predecessor (frame (b, t-1), or prev_last[b] for t = 0, or
// none: TI = 0). What bounds it on an H100: a 64-frame 2160x3840 u8 chunk
// plus its predecessor is 539 MB read once (0.161 ms at 3.35 TB/s) and
// ~18 int32 operations per pixel (14 SI, 4 TI: 9.55 G, 0.285 ms at
// 33.5 T int32 ops/s), so operations bind. The design reads the frame
// once: each block owns a 32x128 rectangle of source pixels and stages it
// with a one-pixel halo in shared memory (16-byte loads where the rows
// are aligned), takes SI at the owned pixels that have a Sobel interior,
// and diffs the owned pixels against the predecessor as they arrive,
// loading the predecessor straight from device memory in the same 16-byte
// vectors. The per-pixel sums stay in 32-bit integers for u8 and widen
// only per thread. Ownership is a partition of the source pixels (rows 0
// and H-1 and columns 0 and W-1 included), so every pixel's difference is
// counted exactly once, and no [B, T+1] copy of the chunk is built.
//
// si_partials and ti_partials, the separate passes, replace
// si_frames_fused (:293-313; _sobel_stripe_stats :263-283;
// _std_from_partials :336-342) and ti_frames_fused (:443-465;
// _ti_partial_kernel :431-440). Each reads one 8.3 MB 2160x3840 luma
// frame (u8) and does ~14 (SI) or ~4 (TI) integer/float operations per
// pixel. SI stages a tile plus a one-pixel halo in shared memory (~8%
// re-read at tile edges); TI uses 16-byte vector loads of both frames;
// each writes one partial per block, nothing else.
//
// Numerics: the Pallas kernels keep f32 sufficient statistics, and
// sigma = sqrt(E[x^2] - E[x]^2) over 8.3 M samples is where f32
// cancellation bites. Here Σ(gx²+gy²), Σd and Σd² are exact int64 sums
// of exact integer terms, and Σ|∇| is an f64 sum of square roots good to
// ~1e-14 (MagSum). The caller reduces the per-block partials in
// f64. The right and bottom edges (gradient columns >= W-1, rows >= H-1)
// are masked here, as the Pallas kernel masked `col < w - 1`. TI takes
// an optional predecessor frame, so a chunk's first TI is computed in the
// kernel against the previous chunk's last frame (kept at container
// depth).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int SI_TW = 128;  // gradient columns per block
constexpr int SI_TH = 32;   // gradient rows per block

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ double warp_sum(double v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ long long warp_sum(long long v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

// Per-thread sum type of Σ(gx²+gy²): a u8 thread sums 16 terms of at most
// 2 * 1020² (fits int32); u16 terms need 64 bits.
template <typename T>
struct GradSum {
  using type = long long;
};
template <>
struct GradSum<uint8_t> {
  using type = int;
};

// Σ|∇| to about double precision without f64 arithmetic per pixel. SI is
// sqrt(E[m²] - E[m]²) with E[m²] exact, so on a frame with few gradients
// any rounding of the square roots shows as σ > 0 where the exact σ is 0
// (one f32 sqrt per term leaves ~0.03 on a 3x3 frame). Each term is the
// f32 root m plus the first-order correction from its exact residual
// m2 - m² (one fma; u8 m2 < 2^24 is exact in f32, u16 terms take an f64
// root split into m + correction), and the f32 sum carries its rounding
// errors in `lo` (TwoSum), so hi + lo is good to ~1e-14 relative.
struct MagSum {
  float hi = 0.0f, lo = 0.0f;

  __device__ __forceinline__ void add(float m, float c) {
    const float t = hi + m;
    const float bp = t - hi;
    lo += ((hi - (t - bp)) + (m - bp)) + c;
    hi = t;
  }
  __device__ __forceinline__ void add(int m2) {
    const float x = (float)m2;
    const float m = sqrtf(x);
    const float r = fmaf(-m, m, x);
    add(m, m > 0.0f ? __fdividef(0.5f * r, m) : 0.0f);
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

// One (frame, SI_TH x SI_TW gradient tile) per block. Gradient position
// (r, c) is the 3x3 Sobel centred on source pixel (r, c), valid for
// 1 <= r <= H-2, 1 <= c <= W-2. Partials: ps1 = Σ|∇| (f64), ps2 = Σ|∇|²
// (int64), one per block, at [frame][blockIdx.y * gridDim.x + blockIdx.x].
template <typename T>
__global__ void __launch_bounds__(THREADS) si_partials(
    const T* __restrict__ y, int h, int w, double* __restrict__ ps1,
    long long* __restrict__ ps2) {
  __shared__ int tile[SI_TH + 2][SI_TW + 2];
  const T* f = y + (size_t)blockIdx.z * h * w;
  const int r_base = blockIdx.y * SI_TH;  // source row of tile[0][*]
  const int c_base = blockIdx.x * SI_TW;  // source col of tile[*][0]
  for (int e = threadIdx.x; e < (SI_TH + 2) * (SI_TW + 2); e += THREADS) {
    const int rr = e / (SI_TW + 2), cc = e % (SI_TW + 2);
    const int r = r_base + rr, c = c_base + cc;
    tile[rr][cc] = (r < h && c < w) ? (int)f[(size_t)r * w + c] : 0;
  }
  __syncthreads();

  using G = typename GradSum<T>::type;
  MagSum mag;
  G s2 = 0;
  const int cc = threadIdx.x % SI_TW;
  if (c_base + 1 + cc < w - 1) {
    for (int rr = threadIdx.x / SI_TW; rr < SI_TH; rr += THREADS / SI_TW) {
      if (r_base + 1 + rr >= h - 1) break;
      const int* up = tile[rr];
      const int* md = tile[rr + 1];
      const int* dn = tile[rr + 2];
      const G gx = (G)(up[cc + 2] + 2 * md[cc + 2] + dn[cc + 2]) -
                   (G)(up[cc] + 2 * md[cc] + dn[cc]);
      const G gy = (G)(dn[cc] + 2 * dn[cc + 1] + dn[cc + 2]) -
                   (G)(up[cc] + 2 * up[cc + 1] + up[cc + 2]);
      const G m2 = gx * gx + gy * gy;
      mag.add(m2);
      s2 += m2;
    }
  }
  double s1 = mag.value();
  long long s2w = s2;
  block_sum(s1, s2w);
  if (threadIdx.x == 0) {
    const size_t o =
        (size_t)blockIdx.z * gridDim.x * gridDim.y + blockIdx.y * gridDim.x +
        blockIdx.x;
    ps1[o] = s1;
    ps2[o] = s2w;
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

constexpr int ST_TW = 128;  // owned source columns per block (fused pass)
constexpr int ST_TH = 32;   // owned source rows per block

__device__ __forceinline__ void unpack_vec(const uint4& a, int* dst, uint8_t) {
  const unsigned wa[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
  for (int q = 0; q < 4; ++q)
#pragma unroll
    for (int k = 0; k < 4; ++k) dst[4 * q + k] = (wa[q] >> (8 * k)) & 0xffu;
}

__device__ __forceinline__ void unpack_vec(const uint4& a, int* dst,
                                           uint16_t) {
  const unsigned wa[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
  for (int q = 0; q < 4; ++q)
#pragma unroll
    for (int k = 0; k < 2; ++k) dst[2 * q + k] = (wa[q] >> (16 * k)) & 0xffffu;
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

// Fused SI+TI partials of nz = B*T frames y [B, T, H, W]. grid
// (ceil(W/ST_TW), ceil(H/ST_TH), <= nz); blocks stride over the frames in
// z. Block (x, y) of frame z owns source rows [32y, 32y+32) and columns
// [128x, 128x+128) (clipped to the frame). It writes, at [z][y * gridDim.x
// + x]: ps1 = Σ|∇| (f64) and ps2 = Σ(gx²+gy²) over the owned pixels with
// 1 <= r <= H-2 and 1 <= c <= W-2, and pd1 = Σd, pd2 = Σd² over all owned
// pixels, d = y[b, t] - pred: pred = y[b, t-1] for t > 0, prev[b] for
// t = 0 when prev is given, else none (d sums stay 0, so TI[b, 0] = 0).
// vec: rows of W samples are a multiple of 16 bytes and y and prev are
// 16-byte aligned, so owned row segments go as uint4 loads.
template <typename T>
__global__ void __launch_bounds__(THREADS) siti_partials(
    const T* __restrict__ y, const T* __restrict__ prev, int t, int nz,
    int h, int w, int vec, double* __restrict__ ps1,
    long long* __restrict__ ps2, long long* __restrict__ pd1,
    long long* __restrict__ pd2) {
  constexpr int NPV = 16 / sizeof(T);     // samples per 16-byte vector
  constexpr int VPR = ST_TW / NPV;        // vectors per owned tile row
  __shared__ int tile[ST_TH + 2][ST_TW + 2];  // tile[rr][cc]: (r0-1+rr, c0-1+cc)
  const size_t hw = (size_t)h * w;
  const int r0 = blockIdx.y * ST_TH, c0 = blockIdx.x * ST_TW;
  const size_t blk = (size_t)blockIdx.y * gridDim.x + blockIdx.x;
  const size_t nblk = (size_t)gridDim.x * gridDim.y;

  for (int z = blockIdx.z; z < nz; z += gridDim.z) {
    const int tz = z % t;
    const T* cur = y + (size_t)z * hw;
    const T* pre = tz > 0 ? cur - hw
                          : (prev != nullptr ? prev + (size_t)(z / t) * hw
                                             : nullptr);
    long long d1 = 0, d2 = 0;
    // owned columns of rows r0-1 .. r0+ST_TH; owned rows also diff
    if (vec) {
      for (int e = threadIdx.x; e < (ST_TH + 2) * VPR; e += THREADS) {
        const int rr = e / VPR, v = e % VPR;
        const int r = r0 - 1 + rr, c = c0 + v * NPV;
        int* dst = &tile[rr][1 + v * NPV];
        if (r < 0 || r >= h || c >= w) {
#pragma unroll
          for (int k = 0; k < NPV; ++k) dst[k] = 0;
          continue;
        }
        const size_t o = (size_t)r * w + c;
        const uint4 a = *reinterpret_cast<const uint4*>(cur + o);
        unpack_vec(a, dst, T());
        if (pre != nullptr && rr >= 1 && rr <= ST_TH)
          diff_vec(a, *reinterpret_cast<const uint4*>(pre + o), d1, d2, T());
      }
    } else {
      for (int e = threadIdx.x; e < (ST_TH + 2) * ST_TW; e += THREADS) {
        const int rr = e / ST_TW, cc = e % ST_TW;
        const int r = r0 - 1 + rr, c = c0 + cc;
        int s = 0;
        if (r >= 0 && r < h && c < w) {
          const size_t o = (size_t)r * w + c;
          s = (int)cur[o];
          if (pre != nullptr && rr >= 1 && rr <= ST_TH) {
            const long long d = (long long)s - (long long)pre[o];
            d1 += d;
            d2 += d * d;
          }
        }
        tile[rr][1 + cc] = s;
      }
    }
    // halo columns c0-1 and c0+ST_TW
    for (int e = threadIdx.x; e < 2 * (ST_TH + 2); e += THREADS) {
      const int rr = e >> 1, right = e & 1;
      const int r = r0 - 1 + rr, c = right ? c0 + ST_TW : c0 - 1;
      tile[rr][right ? ST_TW + 1 : 0] =
          (r >= 0 && r < h && c >= 0 && c < w) ? (int)cur[(size_t)r * w + c]
                                               : 0;
    }
    __syncthreads();

    using G = typename GradSum<T>::type;
    MagSum mag;
    G s2 = 0;
    const int cc = threadIdx.x % ST_TW;  // owned column c0 + cc
    const int c = c0 + cc;
    if (c >= 1 && c <= w - 2) {
      for (int rr = threadIdx.x / ST_TW; rr < ST_TH; rr += THREADS / ST_TW) {
        const int r = r0 + rr;  // centre row, tile row rr + 1
        if (r > h - 2) break;
        if (r < 1) continue;
        const int* up = tile[rr];
        const int* md = tile[rr + 1];
        const int* dn = tile[rr + 2];
        const G gx = (G)(up[cc + 2] + 2 * md[cc + 2] + dn[cc + 2]) -
                     (G)(up[cc] + 2 * md[cc] + dn[cc]);
        const G gy = (G)(dn[cc] + 2 * dn[cc + 1] + dn[cc + 2]) -
                     (G)(up[cc] + 2 * up[cc + 1] + up[cc + 2]);
        const G m2 = gx * gx + gy * gy;
        mag.add(m2);
        s2 += m2;
      }
    }
    double s1 = mag.value();
    long long s2w = s2;
    // block_sum4's barrier also orders this frame's tile reads before the
    // next frame's tile writes
    block_sum4(s1, s2w, d1, d2);
    if (threadIdx.x == 0) {
      const size_t o = (size_t)z * nblk + blk;
      ps1[o] = s1;
      ps2[o] = s2w;
      pd1[o] = d1;
      pd2[o] = d2;
    }
  }
}

}  // namespace

// y: [t, h, w] u8 (elem_bytes 1) or u16 (2). ps1 f64 / ps2 int64:
// [t, n_ty, n_tx] with n_tx = ceil((w-2)/128), n_ty = ceil((h-2)/32).
extern "C" int pc_si_partials(const void* y, int t, int h, int w,
                              int elem_bytes, void* ps1, void* ps2,
                              void* stream) {
  dim3 grid((w - 2 + SI_TW - 1) / SI_TW, (h - 2 + SI_TH - 1) / SI_TH, t);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  double* p1 = static_cast<double*>(ps1);
  long long* p2 = static_cast<long long*>(ps2);
  if (elem_bytes == 1)
    si_partials<uint8_t><<<grid, THREADS, 0, s>>>(
        static_cast<const uint8_t*>(y), h, w, p1, p2);
  else if (elem_bytes == 2)
    si_partials<uint16_t><<<grid, THREADS, 0, s>>>(
        static_cast<const uint16_t*>(y), h, w, p1, p2);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// y: [nz / t, t, h, w] u8/u16; prev: [nz / t, h, w] same type, or null.
// ps1 f64 and ps2/pd1/pd2 int64: [nz, n_ty, n_tx] with n_tx = ceil(w/128),
// n_ty = ceil(h/32).
extern "C" int pc_siti_partials(const void* y, const void* prev, int t,
                                int nz, int h, int w, int elem_bytes,
                                int vec, void* ps1, void* ps2, void* pd1,
                                void* pd2, void* stream) {
  if (t <= 0 || nz <= 0 || nz % t != 0) return (int)cudaErrorInvalidValue;
  dim3 grid((w + ST_TW - 1) / ST_TW, (h + ST_TH - 1) / ST_TH,
            nz < 65535 ? nz : 65535);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  double* p1 = static_cast<double*>(ps1);
  long long* p2 = static_cast<long long*>(ps2);
  long long* q1 = static_cast<long long*>(pd1);
  long long* q2 = static_cast<long long*>(pd2);
  if (elem_bytes == 1)
    siti_partials<uint8_t><<<grid, THREADS, 0, s>>>(
        static_cast<const uint8_t*>(y), static_cast<const uint8_t*>(prev), t,
        nz, h, w, vec, p1, p2, q1, q2);
  else if (elem_bytes == 2)
    siti_partials<uint16_t><<<grid, THREADS, 0, s>>>(
        static_cast<const uint16_t*>(y), static_cast<const uint16_t*>(prev),
        t, nz, h, w, vec, p1, p2, q1, q2);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
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
