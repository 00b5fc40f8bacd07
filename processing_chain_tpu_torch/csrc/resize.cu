// Fused two-pass polyphase resize of [T, src_h, src_w] u8/u16 frames, for
// Hopper (sm_90a). Built by ops/_build.py with nvcc into a plain C shared
// library and bound with ctypes (ops/cuda_kernels.py).
//
// Replaces the TPU kernel processing_chain_tpu/ops/pallas_kernels.py
// resize_frames_fused (:131-215, body _fused_resize_kernel :70-128). Same
// function, not the same blocking: the banded dense matrices and the
// 128/8 alignment shifts of the Pallas kernel served the MXU and Mosaic's
// slicing rules and have no counterpart here. The host plan
// (ops/cuda_kernels._resize_plan) turns the tap lists of ops/resize.py
// into window starts: every tap list is a contiguous window
// clip(start + k, 0, src - 1).
//
// What bounds it on an H100: a 64-frame yuv420p chunk at the AVPVS shapes
// (Y 1080x1920 -> 2160x3840, U and V 540x960 -> 1080x1920) moves 995 MB
// (0.297 ms at 3.35 TB/s) and does 4.78 G int32 multiply-adds with
// bicubic's 4 taps (0.285 ms at the int32 rate; lanczos's 6 taps: 0.428
// ms). Bytes and operations are close, but on the exact route every
// product and every shift, clip and byte pack runs on the int32 pipe,
// which issues at half the fp32 rate, so that pipe is what the kernel
// fills. The first design (one thread per output sample, every tap loading
// its index and coefficient from device memory, an int32 intermediate in
// shared memory) issued about 19 load instructions per output pixel and
// took 3.62 ms per bicubic chunk on an H100 80GB HBM3 at 700 W, limited by
// those loads. Two designs replace it, both persistent over frames (a block
// walks frames z, z + Z, ..., so its tap tables are read once), both with
// each thread owning 8 adjacent output columns, and both staging the source
// rows their tile needs into shared memory with 16-byte cp.async copies,
// double-buffered so frame t + Z's rows are in flight while frame t
// computes (unaligned rows and the frame's edges take a scalar copy into
// the same layout):
//  * resize_ring, for plans whose horizontal and vertical tap counts are
//    equal and 2, 4 or 6 (every upscale of the chain, so every main path):
//    one warp per 256-column output tile keeps its columns' window starts
//    and horizontal coefficients in registers, walks the staged rows top to
//    bottom with the last K horizontal results in registers, and emits each
//    output row when its window is complete. The intermediate never leaves
//    registers; there is no block barrier.
//  * resize_two_pass, for every other plan (downscales, mixed tap counts):
//    a 256-thread block runs the horizontal pass, coefficients from shared
//    memory, into a shared-memory intermediate (int32 on the exact route,
//    f32 otherwise; two 16-byte loads feed 8 columns of a vertical tap),
//    then the vertical pass, one warp per output row, the row's
//    coefficients read as warp-wide broadcasts.
// Reckoned load instructions per output pixel at 2x bicubic in
// resize_ring: 4 byte loads per staged sample x 0.56 staged rows per output
// row = 2.25, 4 coefficient broadcasts per 8 pixels = 0.5, staging about
// 0.02: under 3, against 19 before. The u8 output packs with saturating
// byte packs (cvt.pack.sat), which also do the final clip.
//
// Arithmetic, by route:
//  * EXACT (u8 with bicubic/lanczos inside swscale_exact_applicable):
//    libswscale's integer pipeline, as ops/resize._swscale_exact computes
//    it: horizontal int32 MAC of 14-bit coefficients, arithmetic >>7 and a
//    top-only clamp to 32767 (the intermediate may be negative and stays
//    int32), then a vertical int32 MAC of
//    12-bit coefficients, + (64 << 12), >>19, clip to [0, 255]. That is
//    bit-exact with libswscale's C path (SWS_ACCURATE_RND|SWS_BITEXACT)
//    and with the reference package's CPU golden path: stricter than the
//    TPU kernel's own contract, which is <= 1 code value from the golden
//    path.
//  * float (u16, or u8 outside that envelope): the TPU kernel's f32
//    arithmetic with make_plan's 14-bit weights, horizontal first, the u8
//    32767/128 intermediate clamp only for u8, floor(x + 0.5), clip to
//    maxval. Products and sums are rounded one at a time in tap order (no
//    FMA contraction), so the kernel equals its plain torch version
//    (ops/cuda_kernels.resize_frames_plain) bit for bit; against the TPU
//    kernel it differs only on rounding ties (<= 1 code value).

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int TILE_W = 256;       // output columns per block
constexpr int V = 8;              // output columns per thread
constexpr int THREADS = 256;      // 8 warps; a warp covers one 256-column row
constexpr int WARPS = THREADS / 32;
static_assert(TILE_W == 32 * V, "one warp spans the tile's width");

struct ResizeArgs {
  const void* src;
  void* dst;
  int t, src_h, src_w, dst_h, dst_w;
  int tile_h, rn, sw, vec;
  const int* hpos;      // [n_ct * TILE_W] first tap, relative to tile_xb
  const void* co_h;     // [n_ct * TILE_W, kh] int32 (exact) or f32
  int kh;
  const int* tile_xb;   // [n_ct] first staged source column (may be < 0)
  const int* vpos;      // [n_rt * tile_h] first tap, relative to tile_rlo
  const void* co_v;     // [n_rt * tile_h, kv]
  int kv;
  const int* tile_rlo;  // [n_rt] first staged source row (may be < 0)
  int maxval, clamp_mid;
};

__host__ __device__ constexpr int round16(int b) { return (b + 15) & ~15; }

// Byte offsets of the dynamic shared memory regions (mirrored by
// ops/cuda_kernels._resize_smem_bytes). The intermediate is 4-byte int32
// (exact) or f32.
struct Layout {
  int mid, vco, hco, vpos, total;
};

__host__ __device__ inline Layout layout(int rn, int sw, int elem, int tile_h,
                                         int kv, int kh) {
  Layout l;
  l.mid = 2 * rn * sw * elem;  // two source buffers; sw * elem % 16 == 0
  l.vco = l.mid + rn * TILE_W * 4;
  l.hco = l.vco + round16(tile_h * kv * 4);
  l.vpos = l.hco + round16(TILE_W * kh * 4);
  l.total = l.vpos + round16(tile_h * 4);
  return l;
}

// Four int32 values clipped to [0, 255] and packed little-endian into one
// word (v0 in the low byte): two saturating pack instructions instead of
// eight min/max and three byte inserts.
__device__ __forceinline__ uint32_t pack_sat_u8(int v0, int v1, int v2,
                                                int v3) {
  uint32_t hi, d;
  asm("cvt.pack.sat.u8.s32.b32 %0, %1, %2, 0;" : "=r"(hi) : "r"(v3), "r"(v2));
  asm("cvt.pack.sat.u8.s32.b32 %0, %1, %2, %3;"
      : "=r"(d)
      : "r"(v1), "r"(v0), "r"(hi));
  return d;
}

// One thread's 8 output samples of a row: one 8- (u8) or 16-byte (u16)
// store where the row allows, else sample by sample. Exact-route values
// arrive unclipped; the u8 packing and the scalar path clip them.
template <typename T>
__device__ __forceinline__ void store_row(T* orow, const int (&o)[V],
                                          bool out_vec, int n_out,
                                          int maxval) {
  if (out_vec) {
    if constexpr (sizeof(T) == 1) {
      *reinterpret_cast<uint2*>(orow) =
          make_uint2(pack_sat_u8(o[0], o[1], o[2], o[3]),
                     pack_sat_u8(o[4], o[5], o[6], o[7]));
    } else {  // the f32 route, already clipped
      uint4 w;
      w.x = (uint32_t)o[0] | ((uint32_t)o[1] << 16);
      w.y = (uint32_t)o[2] | ((uint32_t)o[3] << 16);
      w.z = (uint32_t)o[4] | ((uint32_t)o[5] << 16);
      w.w = (uint32_t)o[6] | ((uint32_t)o[7] << 16);
      *reinterpret_cast<uint4*>(orow) = w;
    }
  } else {
#pragma unroll
    for (int v = 0; v < V; ++v)
      if (v < n_out) orow[v] = (T)min(max(o[v], 0), maxval);
  }
}

// Stage source rows rlo .. rlo + rn - 1 (clipped) x columns xb .. xb + sw - 1
// (clipped) of frame `frame` into buf [rn][sw], then commit one cp.async
// group. A 16-byte vector inside the row goes by cp.async when the rows are
// aligned; anything else is copied a sample at a time.
template <typename T, int NT>
__device__ __forceinline__ void stage(const T* __restrict__ frame, T* buf,
                                      const ResizeArgs& a, int rlo, int xb) {
  constexpr int NV = 16 / sizeof(T);
  const int nvec = a.sw / NV;
  for (int q = threadIdx.x; q < a.rn * nvec; q += NT) {
    const int rr = q / nvec, v = q - rr * nvec;
    const int r = min(max(rlo + rr, 0), a.src_h - 1);
    const T* row = frame + (size_t)r * a.src_w;
    T* d = buf + rr * a.sw + v * NV;
    const int x = xb + v * NV;
    if (a.vec && x >= 0 && x + NV <= a.src_w) {
      __pipeline_memcpy_async(d, row + x, 16);
    } else {
#pragma unroll
      for (int k = 0; k < NV; ++k) d[k] = row[min(max(x + k, 0), a.src_w - 1)];
    }
  }
  __pipeline_commit();
}

// Any plan resize_ring does not take: horizontal coefficients from shared
// memory, any tap counts.
template <typename T, bool EXACT>
__global__ void __launch_bounds__(THREADS) resize_two_pass(ResizeArgs a) {
  using Co = typename std::conditional<EXACT, int, float>::type;
  using Acc = Co;
  using Mid = Co;
  extern __shared__ int4 smem_raw[];
  char* smem = reinterpret_cast<char*>(smem_raw);
  const Layout L = layout(a.rn, a.sw, sizeof(T), a.tile_h, a.kv, a.kh);
  T* const buf0 = reinterpret_cast<T*>(smem);  // buffer b at buf0 + b * stride
  const int buf_stride = a.rn * a.sw;
  Mid* mid = reinterpret_cast<Mid*>(smem + L.mid);
  Co* vco = reinterpret_cast<Co*>(smem + L.vco);
  Co* hco = reinterpret_cast<Co*>(smem + L.hco);
  int* vpos = reinterpret_cast<int*>(smem + L.vpos);

  const T* src = static_cast<const T*>(a.src);
  T* dst = static_cast<T*>(a.dst);
  const Co* co_h = static_cast<const Co*>(a.co_h);
  const Co* co_v = static_cast<const Co*>(a.co_v);
  const int ct = blockIdx.x, rt = blockIdx.y;
  const int xb = a.tile_xb[ct], rlo = a.tile_rlo[rt];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int j0 = lane * V;               // first owned column in the tile
  const int col0 = ct * TILE_W + j0;     // ... in the frame
  const size_t src_frame = (size_t)a.src_h * a.src_w;
  const size_t dst_frame = (size_t)a.dst_h * a.dst_w;

  int t = blockIdx.z;
  if (t >= a.t) return;
  stage<T, THREADS>(src + (size_t)t * src_frame, buf0, a, rlo, xb);

  // tap tables, once per block
  for (int e = threadIdx.x; e < a.tile_h * a.kv; e += THREADS)
    vco[e] = co_v[(size_t)rt * a.tile_h * a.kv + e];
  for (int e = threadIdx.x; e < a.tile_h; e += THREADS)
    vpos[e] = a.vpos[rt * a.tile_h + e];
  for (int e = threadIdx.x; e < TILE_W * a.kh; e += THREADS)
    hco[e] = co_h[(size_t)ct * TILE_W * a.kh + e];
  int off[V];
#pragma unroll
  for (int v = 0; v < V; ++v) off[v] = a.hpos[col0 + v];
  const int i0 = rt * a.tile_h;
  const int rows = min(a.tile_h, a.dst_h - i0);
  const int n_out = min(V, a.dst_w - col0);
  const bool out_vec =
      n_out == V && a.dst_w % V == 0 && ((uintptr_t)dst & 15) == 0;

  for (int b = 0; t < a.t; t += gridDim.z, b ^= 1) {
    const int tn = t + gridDim.z;
    if (tn < a.t)
      stage<T, THREADS>(src + (size_t)tn * src_frame,
                        buf0 + (b ^ 1) * buf_stride, a, rlo, xb);
    else
      __pipeline_commit();
    __pipeline_wait_prior(1);
    __syncthreads();  // frame t staged; the last frame's vertical pass done

    // horizontal pass: staged rows -> mid[rr][TILE_W]
    const T* sb = buf0 + b * buf_stride;
    for (int rr = warp; rr < a.rn; rr += WARPS) {
      const T* row = sb + rr * a.sw;
      Mid m[V];
#pragma unroll
      for (int v = 0; v < V; ++v) {
        const T* p = row + off[v];
        const Co* c = hco + (j0 + v) * a.kh;
        if constexpr (EXACT) {
          int acc = 0;
          for (int k = 0; k < a.kh; ++k) acc += (int)p[k] * c[k];
          m[v] = min(acc >> 7, 32767);
        } else {
          float acc = __fmul_rn((float)p[0], c[0]);
          for (int k = 1; k < a.kh; ++k)
            acc = __fadd_rn(acc, __fmul_rn((float)p[k], c[k]));
          if (a.clamp_mid) acc = fminf(acc, 32767.0f / 128.0f);
          m[v] = acc;
        }
      }
      Mid* md = mid + rr * TILE_W + j0;
      if constexpr (EXACT) {
        int4* mi = reinterpret_cast<int4*>(md);
        mi[0] = make_int4(m[0], m[1], m[2], m[3]);
        mi[1] = make_int4(m[4], m[5], m[6], m[7]);
      } else {
        float4* mf = reinterpret_cast<float4*>(md);
        mf[0] = make_float4(m[0], m[1], m[2], m[3]);
        mf[1] = make_float4(m[4], m[5], m[6], m[7]);
      }
    }
    __syncthreads();  // mid complete

    // vertical pass: mid -> output rows i0 .. i0 + rows - 1, one warp per
    // row; two 16-byte shared loads feed 8 columns of one tap
    T* out = dst + (size_t)t * dst_frame;
    for (int i = warp; i < rows; i += WARPS) {
      const Mid* mc = mid + vpos[i] * TILE_W + j0;
      const Co* c = vco + i * a.kv;
      Acc acc[V];
      int o[V];  // exact: not yet clipped (the u8 packing saturates)
      if constexpr (EXACT) {
#pragma unroll
        for (int v = 0; v < V; ++v) acc[v] = 0;
        for (int k = 0; k < a.kv; ++k) {
          const int ck = c[k];
          const int4* mi = reinterpret_cast<const int4*>(mc + k * TILE_W);
          const int4 lo = mi[0], hi = mi[1];
          const int x[V] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
#pragma unroll
          for (int v = 0; v < V; ++v) acc[v] += x[v] * ck;
        }
#pragma unroll
        for (int v = 0; v < V; ++v)
          o[v] = (acc[v] + (64 << 12)) >> 19;
      } else {
        for (int k = 0; k < a.kv; ++k) {
          const float ck = c[k];
          const float4* mf = reinterpret_cast<const float4*>(mc + k * TILE_W);
          const float4 lo = mf[0], hi = mf[1];
          const float x[V] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
#pragma unroll
          for (int v = 0; v < V; ++v)
            acc[v] = k == 0 ? __fmul_rn(x[v], ck)
                            : __fadd_rn(acc[v], __fmul_rn(x[v], ck));
        }
#pragma unroll
        for (int v = 0; v < V; ++v) {
          const float r = floorf(__fadd_rn(acc[v], 0.5f));
          o[v] = (int)fminf(fmaxf(r, 0.0f), (float)a.maxval);
        }
      }
      store_row(out + (size_t)(i0 + i) * a.dst_w + col0, o, out_vec, n_out,
                a.maxval);
    }
  }
}

// The ring design, for plans whose horizontal and vertical tap counts are
// both K (the chain's upscales: bicubic 4, lanczos 6, bilinear 2). A block
// is one warp and owns a 256-column x tile_h-row output tile: it stages the
// tile's source rows as resize_two_pass does, then walks them top to
// bottom, keeping the last K horizontal results of each thread's 8 columns
// in registers (a ring of K slots, indexed at compile time), and emits each
// output row when the last row of its window arrives. The intermediate
// never leaves registers and the warp needs no block barrier.
template <typename T, bool EXACT, int K>
__global__ void __launch_bounds__(32) resize_ring(ResizeArgs a) {
  using Co = typename std::conditional<EXACT, int, float>::type;
  using Acc = Co;
  extern __shared__ int4 smem_raw[];
  char* smem = reinterpret_cast<char*>(smem_raw);
  const int buf_stride = a.rn * a.sw;  // samples; * sizeof(T) % 16 == 0
  T* const buf0 = reinterpret_cast<T*>(smem);
  Co* vco = reinterpret_cast<Co*>(smem + 2 * buf_stride * sizeof(T));
  int* vend = reinterpret_cast<int*>(reinterpret_cast<char*>(vco) +
                                     round16(a.tile_h * K * 4));

  const T* src = static_cast<const T*>(a.src);
  T* dst = static_cast<T*>(a.dst);
  const Co* co_h = static_cast<const Co*>(a.co_h);
  const Co* co_v = static_cast<const Co*>(a.co_v);
  const int ct = blockIdx.x, rt = blockIdx.y, lane = threadIdx.x;
  const int xb = a.tile_xb[ct], rlo = a.tile_rlo[rt];
  const int col0 = ct * TILE_W + lane * V;
  const size_t src_frame = (size_t)a.src_h * a.src_w;
  const size_t dst_frame = (size_t)a.dst_h * a.dst_w;

  int t = blockIdx.z;
  if (t >= a.t) return;
  stage<T, 32>(src + (size_t)t * src_frame, buf0, a, rlo, xb);
  for (int e = lane; e < a.tile_h * K; e += 32)
    vco[e] = co_v[(size_t)rt * a.tile_h * K + e];
  for (int e = lane; e < a.tile_h; e += 32)
    vend[e] = a.vpos[rt * a.tile_h + e] + K - 1;  // last staged row of the window
  int off[V];
  Co hc[V][K];
#pragma unroll
  for (int v = 0; v < V; ++v) {
    off[v] = a.hpos[col0 + v];
#pragma unroll
    for (int k = 0; k < K; ++k) hc[v][k] = co_h[(size_t)(col0 + v) * K + k];
  }
  const int i0 = rt * a.tile_h;
  const int rows = min(a.tile_h, a.dst_h - i0);
  const int n_out = min(V, a.dst_w - col0);
  const bool out_vec =
      n_out == V && a.dst_w % V == 0 && ((uintptr_t)dst & 15) == 0;

  for (int b = 0; t < a.t; t += gridDim.z, b ^= 1) {
    const int tn = t + gridDim.z;
    if (tn < a.t)
      stage<T, 32>(src + (size_t)tn * src_frame, buf0 + (b ^ 1) * buf_stride,
                   a, rlo, xb);
    else
      __pipeline_commit();
    __pipeline_wait_prior(1);
    __syncwarp();  // frame t staged by every lane

    const T* sb = buf0 + b * buf_stride;
    T* out = dst + (size_t)t * dst_frame + (size_t)i0 * a.dst_w + col0;
    Acc ring[K][V];
    int i = 0, end = vend[0];
    for (int base = 0; base < a.rn; base += K) {
#pragma unroll
      for (int s = 0; s < K; ++s) {  // staged row base + s goes to slot s
        const int rr = base + s;
        if (rr >= a.rn) break;
        const T* row = sb + rr * a.sw;
#pragma unroll
        for (int v = 0; v < V; ++v) {
          const T* p = row + off[v];
          if constexpr (EXACT) {
            int acc = 0;
#pragma unroll
            for (int k = 0; k < K; ++k) acc += (int)p[k] * hc[v][k];
            ring[s][v] = min(acc >> 7, 32767);
          } else {
            float acc = __fmul_rn((float)p[0], hc[v][0]);
#pragma unroll
            for (int k = 1; k < K; ++k)
              acc = __fadd_rn(acc, __fmul_rn((float)p[k], hc[v][k]));
            if (a.clamp_mid) acc = fminf(acc, 32767.0f / 128.0f);
            ring[s][v] = acc;
          }
        }
        // rows whose window ends here: tap k is staged row rr - K + 1 + k,
        // in slot (s + 1 + k) % K
        while (end == rr) {
          const Co* c = vco + i * K;
          int o[V];
          if constexpr (EXACT) {
            int acc[V];
#pragma unroll
            for (int v = 0; v < V; ++v) acc[v] = 64 << 12;
#pragma unroll
            for (int k = 0; k < K; ++k) {
              const int ck = c[k];
#pragma unroll
              for (int v = 0; v < V; ++v) acc[v] += ring[(s + 1 + k) % K][v] * ck;
            }
#pragma unroll
            for (int v = 0; v < V; ++v) o[v] = acc[v] >> 19;
          } else {
            float acc[V];
#pragma unroll
            for (int k = 0; k < K; ++k) {
              const float ck = c[k];
#pragma unroll
              for (int v = 0; v < V; ++v)
                acc[v] = k == 0 ? __fmul_rn(ring[(s + 1) % K][v], ck)
                                : __fadd_rn(acc[v],
                                            __fmul_rn(ring[(s + 1 + k) % K][v], ck));
            }
#pragma unroll
            for (int v = 0; v < V; ++v) {
              const float r = floorf(__fadd_rn(acc[v], 0.5f));
              o[v] = (int)fminf(fmaxf(r, 0.0f), (float)a.maxval);
            }
          }
          store_row(out + (size_t)i * a.dst_w, o, out_vec, n_out, a.maxval);
          ++i;
          end = i < rows ? vend[i] : -1;
        }
      }
    }
    __syncwarp();  // every lane done with buffer b before it is restaged
  }
}

template <typename T, bool EXACT>
cudaError_t launch_two_pass(const ResizeArgs& a, int n_rt, int grid_z,
                            cudaStream_t stream) {
  const Layout L = layout(a.rn, a.sw, sizeof(T), a.tile_h, a.kv, a.kh);
  auto kernel = resize_two_pass<T, EXACT>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L.total);
  if (err != cudaSuccess) return err;
  dim3 grid((a.dst_w + TILE_W - 1) / TILE_W, n_rt, grid_z);
  kernel<<<grid, THREADS, L.total, stream>>>(a);
  return cudaGetLastError();
}

template <typename T, bool EXACT, int K>
cudaError_t launch_ring(const ResizeArgs& a, int n_rt, int grid_z,
                        cudaStream_t stream) {
  const int smem = 2 * round16(a.rn * a.sw * (int)sizeof(T)) +
                   round16(a.tile_h * K * 4) + round16(a.tile_h * 4);
  auto kernel = resize_ring<T, EXACT, K>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((a.dst_w + TILE_W - 1) / TILE_W, n_rt, grid_z);
  kernel<<<grid, 32, smem, stream>>>(a);
  return cudaGetLastError();
}

// ring: the plan has kh == kv in {2, 4, 6} (ops/cuda_kernels decides, and
// sizes the grid for one-warp blocks); otherwise resize_two_pass.
template <typename T, bool EXACT>
cudaError_t launch_taps(const ResizeArgs& a, int n_rt, int grid_z, int ring,
                        cudaStream_t s) {
  if (ring) {
    if (a.kh != a.kv) return cudaErrorInvalidValue;
    switch (a.kh) {
      case 2: return launch_ring<T, EXACT, 2>(a, n_rt, grid_z, s);
      case 4: return launch_ring<T, EXACT, 4>(a, n_rt, grid_z, s);
      case 6: return launch_ring<T, EXACT, 6>(a, n_rt, grid_z, s);
      default: return cudaErrorInvalidValue;
    }
  }
  return launch_two_pass<T, EXACT>(a, n_rt, grid_z, s);
}

}  // namespace

// elem_bytes: 1 (u8) or 2 (u16). exact: 1 for the swscale integer route
// (u8 only; coefficient arrays int32), 0 for the f32 route (f32 arrays).
// Plan arrays as ops/cuda_kernels._resize_plan builds them: hpos/co_h
// [n_ct * 256(, kh)], tile_xb [n_ct], vpos/co_v [n_rt * tile_h(, kv)],
// tile_rlo [n_rt]; rn staged rows and sw staged columns per block; grid_z
// frame groups; ring: launch resize_ring (kh == kv in {2, 4, 6}); vec:
// source rows are 16-byte aligned.
// Returns the launch's cudaError_t (0 on success).
extern "C" int pc_resize_frames(
    const void* src, void* dst, int t, int elem_bytes, int exact,
    int src_h, int src_w, int dst_h, int dst_w, int tile_h, int n_rt, int rn,
    int sw, int grid_z, int ring, int vec, const int* hpos, const void* co_h,
    int kh,
    const int* tile_xb, const int* vpos, const void* co_v, int kv,
    const int* tile_rlo, int maxval, int clamp_mid, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const ResizeArgs a{src, dst, t, src_h, src_w, dst_h, dst_w, tile_h, rn,
                     sw, vec, hpos, co_h, kh, tile_xb, vpos, co_v, kv,
                     tile_rlo, maxval, clamp_mid};
  if (t <= 0 || grid_z <= 0 || n_rt <= 0) return (int)cudaErrorInvalidValue;
  if (elem_bytes == 1 && exact)
    return (int)launch_taps<uint8_t, true>(a, n_rt, grid_z, ring, s);
  if (elem_bytes == 1)
    return (int)launch_taps<uint8_t, false>(a, n_rt, grid_z, ring, s);
  if (elem_bytes == 2 && !exact)
    return (int)launch_taps<uint16_t, false>(a, n_rt, grid_z, ring, s);
  return (int)cudaErrorInvalidValue;
}
