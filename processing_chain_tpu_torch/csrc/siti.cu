// Per-frame SI and TI partial sums of [T, H, W] u8/u16 luma, for Hopper
// (sm_90a). Built by ops/_build.py with nvcc into a plain C shared library
// and bound with ctypes (ops/cuda_kernels.py).
//
// Replaces the TPU kernels processing_chain_tpu/ops/pallas_kernels.py
// si_frames_fused (:293-313; _sobel_stripe_stats :263-283;
// _std_from_partials :336-342) and ti_frames_fused (:443-465;
// _ti_partial_kernel :431-440).
//
// What bounds them on an H100: each reads one 8.3 MB 2160x3840 luma frame
// (u8) and does ~17 (SI) or ~4 (TI) integer/float operations per pixel,
// so both are bound by device-memory bytes, ~2.5 us per u8 frame. The
// design reads every sample from device memory once (SI: a tile plus a
// one-pixel halo in shared memory, ~8% re-read at tile edges; TI: 16-byte
// vector loads of both frames) and writes one partial per block, nothing
// else.
//
// Numerics: the Pallas kernels keep f32 sufficient statistics, and
// sigma = sqrt(E[x^2] - E[x]^2) over 8.3 M samples is where f32
// cancellation bites. Here Σ(gx²+gy²), Σd and Σd² are exact int64 sums
// of exact integer terms; only Σ|∇| (a sum of square roots) is f32 within
// a block. The caller reduces the per-block partials in f64. The right
// and bottom edges (gradient columns >= W-1, rows >= H-1) are masked here,
// as the Pallas kernel masked `col < w - 1`. TI takes an optional
// predecessor frame, so a chunk's first TI is computed in the kernel
// against the previous chunk's last frame (kept at container depth).

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

__device__ __forceinline__ long long warp_sum(long long v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

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
// 1 <= r <= H-2, 1 <= c <= W-2. Partials: ps1 = Σ|∇| (f32), ps2 = Σ|∇|²
// (int64), one per block, at [frame][blockIdx.y * gridDim.x + blockIdx.x].
template <typename T>
__global__ void __launch_bounds__(THREADS) si_partials(
    const T* __restrict__ y, int h, int w, float* __restrict__ ps1,
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

  float s1 = 0.0f;
  long long s2 = 0;
  const int cc = threadIdx.x % SI_TW;
  if (c_base + 1 + cc < w - 1) {
    for (int rr = threadIdx.x / SI_TW; rr < SI_TH; rr += THREADS / SI_TW) {
      if (r_base + 1 + rr >= h - 1) break;
      const int* up = tile[rr];
      const int* md = tile[rr + 1];
      const int* dn = tile[rr + 2];
      const long long gx = (up[cc + 2] + 2 * md[cc + 2] + dn[cc + 2]) -
                           (up[cc] + 2 * md[cc] + dn[cc]);
      const long long gy = (dn[cc] + 2 * dn[cc + 1] + dn[cc + 2]) -
                           (up[cc] + 2 * up[cc + 1] + up[cc + 2]);
      const long long m2 = gx * gx + gy * gy;
      s1 += sqrtf((float)m2);
      s2 += m2;
    }
  }
  block_sum(s1, s2);
  if (threadIdx.x == 0) {
    const size_t o =
        (size_t)blockIdx.z * gridDim.x * gridDim.y + blockIdx.y * gridDim.x +
        blockIdx.x;
    ps1[o] = s1;
    ps2[o] = s2;
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

}  // namespace

// y: [t, h, w] u8 (elem_bytes 1) or u16 (2). ps1 f32 / ps2 int64:
// [t, n_ty, n_tx] with n_tx = ceil((w-2)/128), n_ty = ceil((h-2)/32).
extern "C" int pc_si_partials(const void* y, int t, int h, int w,
                              int elem_bytes, void* ps1, void* ps2,
                              void* stream) {
  dim3 grid((w - 2 + SI_TW - 1) / SI_TW, (h - 2 + SI_TH - 1) / SI_TH, t);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* p1 = static_cast<float*>(ps1);
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
