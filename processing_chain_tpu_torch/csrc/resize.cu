// Fused two-pass polyphase resize of [T, src_h, src_w] u8/u16 frames, for
// Hopper (sm_90a). Built by ops/_build.py with nvcc into a plain C shared
// library and bound with ctypes (ops/cuda_kernels.py).
//
// Replaces the TPU kernel processing_chain_tpu/ops/pallas_kernels.py
// resize_frames_fused (:131-215, body _fused_resize_kernel :70-128). Same
// function, not the same blocking: the banded dense matrices and the
// 128/8 alignment shifts of the Pallas kernel served the MXU and Mosaic's
// slicing rules and have no counterpart here. This kernel reads tap lists
// (index + coefficient per output sample) from the host plan functions of
// ops/resize.py instead.
//
// What bounds it on an H100: at the AVPVS shapes (1080p -> 2160p, 64-frame
// chunks) each frame moves 3.11 MB in and 12.44 MB out, and the two passes
// do ~75 M int32 multiply-adds; int32 multiply-add runs at half the fp32
// FMA rate, so bytes and operations come to about the same few
// microseconds per frame. The design keeps the one extra traffic source
// out of device memory: a block computes one TILE_W-wide, tile_h-tall
// output tile, runs the horizontal pass over exactly the source rows that
// tile needs into shared memory, then the vertical pass from shared
// memory. The [dst_w, src_h] intermediate never touches device memory;
// the horizontal pass is recomputed only for the few rows where adjacent
// row tiles' tap windows overlap.
//
// Arithmetic, by route:
//  * EXACT (u8 with bicubic/lanczos inside swscale_exact_applicable):
//    libswscale's integer pipeline, as ops/resize._swscale_exact computes
//    it: horizontal int32 MAC of 14-bit coefficients, arithmetic >>7 and a
//    top-only clamp to 32767 (the intermediate may be negative), then a
//    vertical int32 MAC of 12-bit coefficients, + (64 << 12), >>19, clip to
//    [0, 255]. That is bit-exact with libswscale's C path
//    (SWS_ACCURATE_RND|SWS_BITEXACT) and with the reference package's CPU
//    golden path: stricter than the TPU kernel's own contract, which is
//    <= 1 code value from the golden path.
//  * float (u16, or u8 outside that envelope): the TPU kernel's f32
//    arithmetic with make_plan's 14-bit weights, horizontal first, the u8
//    32767/128 intermediate clamp only for u8, floor(x + 0.5), clip to
//    maxval. Products and sums are rounded one at a time in tap order (no
//    FMA contraction), so the kernel equals its plain torch version
//    (ops/cuda_kernels.resize_frames_plain) bit for bit; against the TPU
//    kernel it differs only on rounding ties (<= 1 code value).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE_W = 128;   // output columns per block
constexpr int THREADS = 256;  // TILE_W columns x 2 rows per sweep
constexpr int ROW_STEP = THREADS / TILE_W;

template <typename T, bool EXACT>
__global__ void __launch_bounds__(THREADS) resize_two_pass(
    const T* __restrict__ src, T* __restrict__ dst,
    int src_h, int src_w, int dst_h, int dst_w, int tile_h,
    const int* __restrict__ idx_h, const void* __restrict__ co_h, int kh,
    const int* __restrict__ idx_v, const void* __restrict__ co_v, int kv,
    const int* __restrict__ tile_r0, const int* __restrict__ tile_rn,
    int maxval, int clamp_mid) {
  // mid[rn][TILE_W]: horizontal-pass result for this tile's source rows
  extern __shared__ int4 smem_raw[];
  int* mid_i = reinterpret_cast<int*>(smem_raw);
  float* mid_f = reinterpret_cast<float*>(smem_raw);

  const int jj = threadIdx.x % TILE_W;
  const int j = blockIdx.x * TILE_W + jj;
  const int ty = blockIdx.y;
  const int r0 = tile_r0[ty];
  const int rn = tile_rn[ty];
  const bool col_ok = j < dst_w;
  const T* frame = src + (size_t)blockIdx.z * src_h * src_w;

  if (col_ok) {
    const int* ih = idx_h + (size_t)j * kh;
    for (int rr = threadIdx.x / TILE_W; rr < rn; rr += ROW_STEP) {
      const T* row = frame + (size_t)(r0 + rr) * src_w;
      if (EXACT) {
        const int* c = static_cast<const int*>(co_h) + (size_t)j * kh;
        int acc = 0;
        for (int k = 0; k < kh; ++k) acc += (int)row[ih[k]] * c[k];
        mid_i[rr * TILE_W + jj] = min(acc >> 7, 32767);
      } else {
        const float* c = static_cast<const float*>(co_h) + (size_t)j * kh;
        float acc = __fmul_rn((float)row[ih[0]], c[0]);
        for (int k = 1; k < kh; ++k)
          acc = __fadd_rn(acc, __fmul_rn((float)row[ih[k]], c[k]));
        if (clamp_mid) acc = fminf(acc, 32767.0f / 128.0f);
        mid_f[rr * TILE_W + jj] = acc;
      }
    }
  }
  __syncthreads();
  if (!col_ok) return;

  T* out = dst + (size_t)blockIdx.z * dst_h * dst_w;
  const int i1 = min((ty + 1) * tile_h, dst_h);
  for (int i = ty * tile_h + threadIdx.x / TILE_W; i < i1; i += ROW_STEP) {
    const int* iv = idx_v + (size_t)i * kv;
    int o;
    if (EXACT) {
      const int* c = static_cast<const int*>(co_v) + (size_t)i * kv;
      int acc = 0;
      for (int k = 0; k < kv; ++k)
        acc += mid_i[(iv[k] - r0) * TILE_W + jj] * c[k];
      o = min(max((acc + (64 << 12)) >> 19, 0), 255);
    } else {
      const float* c = static_cast<const float*>(co_v) + (size_t)i * kv;
      float acc = __fmul_rn(mid_f[(iv[0] - r0) * TILE_W + jj], c[0]);
      for (int k = 1; k < kv; ++k)
        acc = __fadd_rn(acc, __fmul_rn(mid_f[(iv[k] - r0) * TILE_W + jj], c[k]));
      float r = floorf(__fadd_rn(acc, 0.5f));
      o = (int)fminf(fmaxf(r, 0.0f), (float)maxval);
    }
    out[(size_t)i * dst_w + j] = (T)o;
  }
}

template <typename T, bool EXACT>
cudaError_t launch(const void* src, void* dst, int t, int src_h, int src_w,
                   int dst_h, int dst_w, int tile_h, int n_tiles,
                   const int* idx_h, const void* co_h, int kh,
                   const int* idx_v, const void* co_v, int kv,
                   const int* tile_r0, const int* tile_rn, int smem_bytes,
                   int maxval, int clamp_mid, cudaStream_t stream) {
  auto kernel = resize_two_pass<T, EXACT>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return err;
  dim3 grid((dst_w + TILE_W - 1) / TILE_W, n_tiles, t);
  kernel<<<grid, THREADS, smem_bytes, stream>>>(
      static_cast<const T*>(src), static_cast<T*>(dst), src_h, src_w, dst_h,
      dst_w, tile_h, idx_h, co_h, kh, idx_v, co_v, kv, tile_r0, tile_rn,
      maxval, clamp_mid);
  return cudaGetLastError();
}

}  // namespace

// elem_bytes: 1 (u8) or 2 (u16). exact: 1 for the swscale integer route
// (u8 only; coefficient arrays int32), 0 for the f32 route (f32 arrays).
// idx_h/co_h: [dst_w, kh]; idx_v/co_v: [dst_h, kv]; tile_r0/tile_rn:
// [n_tiles] first source row and row count of each tile_h-row output tile.
// Returns the launch's cudaError_t (0 on success).
extern "C" int pc_resize_frames(
    const void* src, void* dst, int t, int elem_bytes, int exact,
    int src_h, int src_w, int dst_h, int dst_w, int tile_h, int n_tiles,
    const int* idx_h, const void* co_h, int kh,
    const int* idx_v, const void* co_v, int kv,
    const int* tile_r0, const int* tile_rn, int smem_bytes,
    int maxval, int clamp_mid, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (elem_bytes == 1 && exact)
    return launch<uint8_t, true>(src, dst, t, src_h, src_w, dst_h, dst_w,
                                 tile_h, n_tiles, idx_h, co_h, kh, idx_v, co_v,
                                 kv, tile_r0, tile_rn, smem_bytes, maxval,
                                 clamp_mid, s);
  if (elem_bytes == 1)
    return launch<uint8_t, false>(src, dst, t, src_h, src_w, dst_h, dst_w,
                                  tile_h, n_tiles, idx_h, co_h, kh, idx_v,
                                  co_v, kv, tile_r0, tile_rn, smem_bytes,
                                  maxval, clamp_mid, s);
  if (elem_bytes == 2 && !exact)
    return launch<uint16_t, false>(src, dst, t, src_h, src_w, dst_h, dst_w,
                                   tile_h, n_tiles, idx_h, co_h, kh, idx_v,
                                   co_v, kv, tile_r0, tile_rn, smem_bytes,
                                   maxval, clamp_mid, s);
  return (int)cudaErrorInvalidValue;
}
