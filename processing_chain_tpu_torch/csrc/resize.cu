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
// ms); the mobile CPVS downscale of a 2160p chunk moves the same bytes
// the other way with 8 taps a pass. Both kernels are persistent over
// frames (a block walks frames z, z + Z, ..., so its tap tables are read
// once) and are one warp a block, with no block barrier:
//  * resize_ring, for plans whose horizontal and vertical tap counts are
//    equal and 2, 4 or 6 (every upscale of the chain, so every main path):
//    the warp owns a 256-column output tile, each lane 8 adjacent columns
//    with their window starts and horizontal coefficients in registers. It
//    stages the tile's source rows into shared memory with 16-byte
//    cp.async copies, double-buffered over frames, walks them top to
//    bottom with the last K horizontal results in registers, and emits
//    each output row when its window is complete.
//  * resize_stream, for every other plan (downscales at any ratio, mixed
//    tap counts): the warp owns a column tile (256, 128, 64 or 32 columns,
//    the widest whose shared memory stays small) and a strip of output
//    rows, and streams the strip's source rows top to bottom through a
//    ring of NBUF groups of BATCH staged rows, the next groups in flight
//    while one computes, so shared memory no longer grows with the
//    vertical ratio. Where the source rows are 16-byte aligned, a row goes
//    by one bulk copy (TMA) into its slot, completed on the group's
//    mbarrier; otherwise by the lanes' cp.async copies. Two staged rows a
//    step go through the horizontal pass into a ring of kv + 1
//    intermediate rows, and every output row whose window closes on a row
//    is emitted from the ring. Horizontal coefficients live in shared
//    memory as [tap][column] and the lanes take interleaved columns
//    (lane + 32 v), so a warp's coefficient and sample loads hit
//    consecutive words; the columns a lane owns (tile_w / 32) are a
//    template parameter, so their sums (two rows' worth) are independent
//    chains whose loads issue together. Taps come in groups of four (the
//    plan pads them with zero weights). In the vertical pass a lane owns
//    4 adjacent columns (two such groups at 256 columns), one 16-byte
//    load a tap each.
//    What its measurements taught (tune_resize.py, NVIDIA H100 80GB HBM3):
//    with a runtime column count each column waited for its own loads;
//    staging a row at a time by the whole warp's cp.async took half the
//    kernel's time whatever the ring's depth; a group's rows side by side
//    and the bulk copies took most of that back. What is left is
//    instruction issue: about 47 instructions an output pixel at 2x,
//    reckoned from this source.
// The exact route's horizontal MAC is two dp2a instructions per four
// taps: the four source bytes of a column's taps, aligned out of two
// 32-bit words by one byte permute, against two int16 pairs of
// coefficients (libswscale's 14-bit coefficients fit int16). At 2x that
// is about 6 instructions per four taps where a byte load, a coefficient
// load and an int32 multiply-add per tap took 12. The u8 output packs with
// saturating byte packs (cvt.pack.sat), which also do the final clip.
//
// Arithmetic, by route:
//  * EXACT (u8 with bicubic/lanczos inside swscale_exact_applicable):
//    libswscale's integer pipeline, as ops/resize._swscale_exact computes
//    it: horizontal int32 MAC of 14-bit coefficients, arithmetic >>7 and a
//    top-only clamp to 32767 (the intermediate may be negative and stays
//    int32), then a vertical int32 MAC of
//    12-bit coefficients, + (64 << 12), >>19, clip to [0, 255]. Every sum
//    is exact in int32, so the order of the adds does not matter. That is
//    bit-exact with libswscale's C path (SWS_ACCURATE_RND|SWS_BITEXACT)
//    and with the reference package's CPU golden path: stricter than the
//    TPU kernel's own contract, which is <= 1 code value from the golden
//    path.
//  * float (u16, or u8 outside that envelope): the TPU kernel's f32
//    arithmetic with make_plan's 14-bit weights, horizontal first, the u8
//    32767/128 intermediate clamp only for u8, floor(x + 0.5), clip to
//    maxval. Products and sums are rounded one at a time in tap order (no
//    FMA contraction; a zero-weight padding tap adds an exact zero), so
//    the kernel equals its plain torch version
//    (ops/cuda_kernels.resize_frames_plain) bit for bit; against the TPU
//    kernel it differs only on rounding ties (<= 1 code value).

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int TILE_W = 256;       // output columns of a resize_ring tile
constexpr int V = 8;              // ... per lane
static_assert(TILE_W == 32 * V, "one warp spans the ring tile's width");
// resize_stream stages its source rows in cp.async groups of BATCH rows,
// a ring of NBUF groups: NBUF - 1 groups in flight while one computes
constexpr int BATCH = 4;
constexpr int NBUF = 3;
constexpr int STAGES = BATCH * NBUF;  // staged source rows
static_assert(BATCH % 2 == 0 && 32 % BATCH == 0, "two rows a step; lanes split evenly");

struct ResizeArgs {
  const void* src;
  void* dst;
  int t, src_h, src_w, dst_h, dst_w;
  int tile_w, tile_h, rn, sw, vec;
  const int* hpos;      // [n_ct * tile_w] first tap, relative to tile_xb
  const void* co_h;     // ring: [n_ct * 256, kh]; stream: see stream_layout
  int kh;               // stream: padded to a multiple of 4 * GU
  const int* tile_xb;   // [n_ct] first staged source column (may be < 0)
  const int* vpos;      // [n_rt * tile_h] first tap, relative to tile_rlo
  const void* co_v;     // [n_rt * tile_h, kv]
  int kv;
  const int* tile_rlo;  // [n_rt] first staged source row (may be < 0)
  int maxval, clamp_mid;
};

__host__ __device__ constexpr int round16(int b) { return (b + 15) & ~15; }

// Byte offsets of resize_stream's dynamic shared memory (mirrored by
// ops/cuda_kernels._stream_smem_bytes): STAGES staged source rows of sw
// samples; the ring of kv + 1 intermediate rows of tile_w int32 (exact) or
// f32; the horizontal coefficients, [kh / 4][tile_w] int2 of int16 pairs
// (exact) or [kh][tile_w] f32; the strip's vertical coefficients
// [tile_h][kv]; the strip's last window rows [tile_h]; one mbarrier for
// each of the NBUF staging groups.
struct StreamLayout {
  int mid, hco, vco, vend, bar, total;
};

__host__ __device__ inline StreamLayout stream_layout(const ResizeArgs& a,
                                                      int elem, bool exact) {
  StreamLayout l;
  l.mid = round16(STAGES * a.sw * elem);
  l.hco = l.mid + (a.kv + 1) * a.tile_w * 4;
  l.vco = l.hco + a.kh * a.tile_w * (exact ? 2 : 4);
  l.vend = l.vco + round16(a.tile_h * a.kv * 4);
  l.bar = l.vend + round16(a.tile_h * 4);
  l.total = l.bar + round16(NBUF * 8);
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

// resize_stream's 4 adjacent output samples: one 4- (u8) or 8-byte (u16)
// store where the row allows, else sample by sample.
template <typename T>
__device__ __forceinline__ void store4(T* orow, const int (&o)[4],
                                       bool out_vec, int n_out, int maxval) {
  if (out_vec) {
    if constexpr (sizeof(T) == 1) {
      *reinterpret_cast<uint32_t*>(orow) = pack_sat_u8(o[0], o[1], o[2], o[3]);
    } else {
      *reinterpret_cast<uint2*>(orow) =
          make_uint2((uint32_t)o[0] | ((uint32_t)o[1] << 16),
                     (uint32_t)o[2] | ((uint32_t)o[3] << 16));
    }
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (e < n_out) orow[e] = (T)min(max(o[e], 0), maxval);
  }
}

// Copy the 16 bytes of `row` from column x (clipped) to d: by cp.async
// when the rows are aligned and the vector lies inside the row, else a
// sample at a time. The caller commits the cp.async group.
template <typename T>
__device__ __forceinline__ void copy16(T* d, const T* row, int x, const ResizeArgs& a) {
  constexpr int NV = 16 / sizeof(T);
  if (a.vec && x >= 0 && x + NV <= a.src_w) {
    __pipeline_memcpy_async(d, row + x, 16);
  } else {
#pragma unroll
    for (int k = 0; k < NV; ++k) d[k] = row[min(max(x + k, 0), a.src_w - 1)];
  }
}

// Copy source row r (clipped) x columns xb .. xb + sw - 1 (clipped) of
// `frame` into buf [sw], 16-byte vectors first, first + step, ... by this
// thread.
template <typename T>
__device__ __forceinline__ void stage_row(const T* __restrict__ frame, T* buf,
                                          const ResizeArgs& a, int r, int xb,
                                          int first, int step) {
  constexpr int NV = 16 / sizeof(T);
  const T* row = frame + (size_t)min(max(r, 0), a.src_h - 1) * a.src_w;
  for (int v = first; v < a.sw / NV; v += step) copy16(buf + v * NV, row, xb + v * NV, a);
}

// Stage source rows rlo .. rlo + rn - 1 (clipped) x columns xb .. xb + sw - 1
// (clipped) of frame `frame` into buf [rn][sw], the warp's lanes taking the
// (row, vector) pairs in turn, then commit one cp.async group
// (resize_ring).
template <typename T>
__device__ __forceinline__ void stage(const T* __restrict__ frame, T* buf,
                                      const ResizeArgs& a, int rlo, int xb) {
  constexpr int NV = 16 / sizeof(T);
  const int nvec = a.sw / NV;
  for (int q = threadIdx.x; q < a.rn * nvec; q += 32) {
    const int rr = q / nvec, v = q - rr * nvec;
    const T* row = frame + (size_t)min(max(rlo + rr, 0), a.src_h - 1) * a.src_w;
    copy16(buf + rr * a.sw + v * NV, row, xb + v * NV, a);
  }
  __pipeline_commit();
}

// Hopper's bulk copies (TMA) into shared memory, completed on an mbarrier.
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

// One arrival on `bar` that also expects `bytes` of bulk copies.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void bulk_copy(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::"r"(
          smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// Wait for the phase of `bar` with parity `parity` to complete. The spin
// is bounded: a phase that never completes traps (a launch error) rather
// than hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  for (uint32_t n = 0;; ++n) {
    uint32_t done;
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
    if (done) return;
    if (n == (1u << 24)) __trap();
  }
}

// resize_stream's 4-tap groups per step of its tap loop with NV columns a
// lane: at least 4 independent column sums a step (mirrored by
// ops/cuda_kernels._stream_group_unroll; the plan pads the taps to a
// multiple of 4 x this with zero weights).
__host__ __device__ constexpr int stream_groups(int nv) { return nv >= 4 ? 1 : 4 / nv; }

// d = acc + lo16(pair) * byte0(bytes) + hi16(pair) * byte1(bytes), the
// pair's halves signed, the bytes unsigned (dp2a.hi: bytes 2 and 3).
__device__ __forceinline__ int dp2a_lo(int pair, uint32_t bytes, int acc) {
  int d;
  asm("dp2a.lo.s32.u32 %0, %1, %2, %3;" : "=r"(d) : "r"(pair), "r"(bytes), "r"(acc));
  return d;
}

__device__ __forceinline__ int dp2a_hi(int pair, uint32_t bytes, int acc) {
  int d;
  asm("dp2a.hi.s32.u32 %0, %1, %2, %3;" : "=r"(d) : "r"(pair), "r"(bytes), "r"(acc));
  return d;
}

// Every plan resize_ring does not take. One warp walks, for each of its
// frames, the strip's rn staged source rows s = 0 .. rn - 1 in order:
// every BATCH rows, stage the group NBUF - 1 groups ahead and wait for the
// current one; run the horizontal pass of row s into ring slot s % kv,
// then emit every output row whose window ends at s (rows end in order:
// window starts are non-decreasing, windows are kv rows long), reading tap
// k from slot (s + 1 + k) % kv. The row counter runs on across frames, so
// staging stays ahead over frame boundaries.
template <typename T, bool EXACT, int NV>
__global__ void __launch_bounds__(32) resize_stream(ResizeArgs a) {
  using Co = typename std::conditional<EXACT, int, float>::type;
  constexpr int GU = stream_groups(NV);
  extern __shared__ int4 smem_raw[];
  char* smem = reinterpret_cast<char*>(smem_raw);
  const StreamLayout L = stream_layout(a, sizeof(T), EXACT);
  T* const buf = reinterpret_cast<T*>(smem);
  Co* const mid = reinterpret_cast<Co*>(smem + L.mid);
  Co* const vco = reinterpret_cast<Co*>(smem + L.vco);
  int* const vend = reinterpret_cast<int*>(smem + L.vend);

  const T* src = static_cast<const T*>(a.src);
  T* dst = static_cast<T*>(a.dst);
  const int lane = threadIdx.x, ct = blockIdx.x, rt = blockIdx.y;
  const int tw = a.tile_w, kv = a.kv, rn = a.rn;
  const int xb = a.tile_xb[ct], rlo = a.tile_rlo[rt];
  const size_t src_frame = (size_t)a.src_h * a.src_w;
  const size_t dst_frame = (size_t)a.dst_h * a.dst_w;
  const int t0 = blockIdx.z;
  if (t0 >= a.t) return;
  const int total = (a.t - t0 + gridDim.z - 1) / gridDim.z * rn;

  // Staged rows go BATCH to a group: group g holds rows g BATCH ..
  // g BATCH + BATCH - 1 of the block's row sequence (row sr of frame sf
  // starts the group), in ring slots (g % NBUF) BATCH ... Aligned sources
  // (vec) go by one bulk copy a row, issued by lane 0 and completed on the
  // slot's mbarrier (phase g / NBUF), with the columns outside the frame
  // filled by the lanes (row k of the group by lanes k LPR ..); other
  // sources go by the lanes' cp.async copies, one cp.async group a group.
  constexpr int LPR = 32 / BATCH;
  uint64_t* const bars = reinterpret_cast<uint64_t*>(smem + L.bar);
  const int in_lo = max(xb, 0), in_hi = min(xb + a.sw, a.src_w);  // in-frame columns
  int sq = 0, sr = 0;
  const T* sf = src + (size_t)t0 * src_frame;
  const size_t frame_step = (size_t)gridDim.z * src_frame;
  auto stage_batch = [&]() {
    const int n = min(BATCH, total - sq);  // rows of the group in the sequence
    const int k = lane / LPR;
    int r = sr + k;
    const T* f = sf;
    while (r >= rn) {
      r -= rn;
      f += frame_step;
    }
    const T* row = f + (size_t)min(max(rlo + r, 0), a.src_h - 1) * a.src_w;
    T* d = buf + (sq + k) % STAGES * a.sw;
    if (a.vec) {
      uint64_t* bar = bars + sq / BATCH % NBUF;
      const uint32_t seg = (uint32_t)(in_hi - in_lo) * sizeof(T);
      if (lane == 0) mbar_expect_tx(bar, n > 0 ? n * seg : 0);
      __syncwarp();  // the expectation stands before any copy completes
      // lanes 0, LPR, ... issue their rows' copies, after the slot's last
      // reads (ordered by the step's barriers) on the generic proxy
      if (lane % LPR == 0 && k < n) {
        asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
        bulk_copy(d + (in_lo - xb), row + in_lo, seg, bar);
      }
      if (k < n) {
        for (int e = lane % LPR; e < in_lo - xb; e += LPR) d[e] = row[0];
        for (int e = in_hi - xb + lane % LPR; e < a.sw; e += LPR) d[e] = row[a.src_w - 1];
      }
    } else {
      if (k < n) stage_row<T>(f, d, a, rlo + r, xb, lane % LPR, LPR);
      __pipeline_commit();
    }
    sq += BATCH;
    for (sr += BATCH; sr >= rn; sr -= rn) sf += frame_step;
  };
  if (lane == 0) {
    for (int b = 0; b < NBUF; ++b) mbar_init(bars + b, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncwarp();
  for (int g = 0; g < NBUF - 1; ++g) stage_batch();

  // tap tables, once per block
  {
    const int words = a.kh * tw * (EXACT ? 2 : 4) / 4;
    const int* g = static_cast<const int*>(a.co_h) + (size_t)ct * words;
    int* h = reinterpret_cast<int*>(smem + L.hco);
    for (int e = lane; e < words; e += 32) h[e] = g[e];
  }
  const Co* co_v = static_cast<const Co*>(a.co_v);
  for (int e = lane; e < a.tile_h * kv; e += 32)
    vco[e] = co_v[(size_t)rt * a.tile_h * kv + e];
  for (int e = lane; e < a.tile_h; e += 32)
    vend[e] = a.vpos[rt * a.tile_h + e] + kv - 1;
  int off[NV];  // the lane's columns lane + 32 v of the tile (tw = 32 NV)
  uint32_t sel[NV];  // byte permute selecting bytes off .. off + 3
#pragma unroll
  for (int v = 0; v < NV; ++v) {
    off[v] = a.hpos[ct * tw + lane + 32 * v];
    sel[v] = 0x3210u + (uint32_t)(off[v] & 3) * 0x1111u;
  }
  // vertical pass: 4 adjacent columns at 4 lane and 4 lane + 128
  const int vc0 = 4 * lane, vc1 = 4 * lane + 128;
  const int gc0 = ct * tw + vc0, gc1 = ct * tw + vc1;
  const bool vl0 = vc0 < tw && gc0 < a.dst_w, vl1 = vc1 < tw && gc1 < a.dst_w;
  const int i0 = rt * a.tile_h;
  const int rows = min(a.tile_h, a.dst_h - i0);
  const bool out_vec = a.dst_w % 4 == 0 && ((uintptr_t)dst & 7) == 0;
  __syncwarp();  // tables stored

  // ring slot of staged row q (the block's running row count): q % R
  const int R = kv + 1;
  int s = 0, i = 0, end = vend[0];
  T* out = dst + (size_t)t0 * dst_frame + (size_t)i0 * a.dst_w;

  // emit the rows whose window ends at strip row s (staged row q, in
  // slot qs); tap k of the window is in slot (qs - kv + 1 + k) % R. Then
  // step to the next strip row, and on to the block's next frame after
  // the strip's last.
  auto emit = [&](int qs) {
    const int first = qs + 2 >= R ? qs + 2 - R : qs + 2;  // (qs - kv + 1) % R
    while (end == s) {
      const Co* c = vco + i * kv;
      int o0[4], o1[4];
      int sl = first;
      if constexpr (EXACT) {
        int a0[4], a1[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) a0[e] = a1[e] = 64 << 12;
#pragma unroll 2
        for (int k = 0; k < kv; ++k) {
          const int* m = mid + sl * tw;
          const int4 x0 = vl0 ? *reinterpret_cast<const int4*>(m + vc0) : make_int4(0, 0, 0, 0);
          const int4 x1 = vl1 ? *reinterpret_cast<const int4*>(m + vc1) : make_int4(0, 0, 0, 0);
          const int ck = c[k];
          a0[0] += x0.x * ck; a0[1] += x0.y * ck; a0[2] += x0.z * ck; a0[3] += x0.w * ck;
          a1[0] += x1.x * ck; a1[1] += x1.y * ck; a1[2] += x1.z * ck; a1[3] += x1.w * ck;
          sl = sl + 1 == R ? 0 : sl + 1;
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          o0[e] = a0[e] >> 19;
          o1[e] = a1[e] >> 19;
        }
      } else {
        float a0[4], a1[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) a0[e] = a1[e] = 0.0f;
#pragma unroll 2
        for (int k = 0; k < kv; ++k) {
          const float* m = mid + sl * tw;
          const float4 x0 = vl0 ? *reinterpret_cast<const float4*>(m + vc0) : make_float4(0, 0, 0, 0);
          const float4 x1 = vl1 ? *reinterpret_cast<const float4*>(m + vc1) : make_float4(0, 0, 0, 0);
          const float ck = c[k];
          a0[0] = __fadd_rn(a0[0], __fmul_rn(x0.x, ck));
          a0[1] = __fadd_rn(a0[1], __fmul_rn(x0.y, ck));
          a0[2] = __fadd_rn(a0[2], __fmul_rn(x0.z, ck));
          a0[3] = __fadd_rn(a0[3], __fmul_rn(x0.w, ck));
          a1[0] = __fadd_rn(a1[0], __fmul_rn(x1.x, ck));
          a1[1] = __fadd_rn(a1[1], __fmul_rn(x1.y, ck));
          a1[2] = __fadd_rn(a1[2], __fmul_rn(x1.z, ck));
          a1[3] = __fadd_rn(a1[3], __fmul_rn(x1.w, ck));
          sl = sl + 1 == R ? 0 : sl + 1;
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          o0[e] = (int)fminf(fmaxf(floorf(__fadd_rn(a0[e], 0.5f)), 0.0f), (float)a.maxval);
          o1[e] = (int)fminf(fmaxf(floorf(__fadd_rn(a1[e], 0.5f)), 0.0f), (float)a.maxval);
        }
      }
      T* orow = out + (size_t)i * a.dst_w;
      if (vl0) store4(orow + gc0, o0, out_vec, min(4, a.dst_w - gc0), a.maxval);
      if (vl1) store4(orow + gc1, o1, out_vec, min(4, a.dst_w - gc1), a.maxval);
      ++i;
      end = i < rows ? vend[i] : -1;
    }
    if (++s == rn) {  // the frame's strip is done: on to the block's next frame
      s = 0;
      out += (size_t)gridDim.z * dst_frame;
      i = 0;
      end = vend[0];
    }
  };

  // two staged rows a step (BATCH is even): their horizontal passes are
  // independent, so the step holds 2 x GU x NV column sums
  for (int q = 0, qs = 0; q < total; q += 2) {
    if (q % BATCH == 0) {
      stage_batch();
      const int g = q / BATCH;
      if (a.vec)
        mbar_wait(bars + g % NBUF, (uint32_t)(g / NBUF) & 1u);
      else
        __pipeline_wait_prior(NBUF - 1);
    }
    __syncwarp();  // rows q, q + 1 staged by every lane; the last emission done
    const int qs1 = qs + 1 == R ? 0 : qs + 1;
    const T* row0 = buf + (q % STAGES) * a.sw;
    const T* row1 = row0 + a.sw;  // q is even and STAGES even: same ring turn
    Co* m0 = mid + qs * tw;
    Co* m1 = mid + qs1 * tw;
    const bool two = q + 1 < total;  // else row1 holds stale samples, not stored
    if constexpr (EXACT) {
      const uint32_t* w0 = reinterpret_cast<const uint32_t*>(row0);
      const uint32_t* w1 = reinterpret_cast<const uint32_t*>(row1);
      const int2* c = reinterpret_cast<const int2*>(smem + L.hco) + lane;
      int acc0[NV], acc1[NV];
      uint32_t lo0[NV], lo1[NV];
#pragma unroll
      for (int v = 0; v < NV; ++v) {
        acc0[v] = acc1[v] = 0;
        lo0[v] = w0[off[v] >> 2];
        lo1[v] = w1[off[v] >> 2];
      }
      for (int g0 = 0; g0 < a.kh / 4; g0 += GU) {
#pragma unroll
        for (int gg = 0; gg < GU; ++gg) {
          const int g = g0 + gg;
#pragma unroll
          for (int v = 0; v < NV; ++v) {
            const int2 cc = c[g * tw + 32 * v];
            const uint32_t hi0 = w0[(off[v] >> 2) + g + 1];
            const uint32_t hi1 = w1[(off[v] >> 2) + g + 1];
            const uint32_t b0 = __byte_perm(lo0[v], hi0, sel[v]);
            const uint32_t b1 = __byte_perm(lo1[v], hi1, sel[v]);
            acc0[v] = dp2a_hi(cc.y, b0, dp2a_lo(cc.x, b0, acc0[v]));
            acc1[v] = dp2a_hi(cc.y, b1, dp2a_lo(cc.x, b1, acc1[v]));
            lo0[v] = hi0;
            lo1[v] = hi1;
          }
        }
      }
#pragma unroll
      for (int v = 0; v < NV; ++v) {
        m0[lane + 32 * v] = min(acc0[v] >> 7, 32767);
        if (two) m1[lane + 32 * v] = min(acc1[v] >> 7, 32767);
      }
    } else {
      const float* c = reinterpret_cast<const float*>(smem + L.hco) + lane;
      float acc0[NV], acc1[NV];
#pragma unroll
      for (int v = 0; v < NV; ++v) acc0[v] = acc1[v] = 0.0f;
      for (int k0 = 0; k0 < a.kh; k0 += 4 * GU) {
#pragma unroll
        for (int kk = 0; kk < 4 * GU; ++kk) {
          const int k = k0 + kk;
#pragma unroll
          for (int v = 0; v < NV; ++v) {
            const float ck = c[k * tw + 32 * v];
            acc0[v] = __fadd_rn(acc0[v], __fmul_rn((float)row0[off[v] + k], ck));
            acc1[v] = __fadd_rn(acc1[v], __fmul_rn((float)row1[off[v] + k], ck));
          }
        }
      }
      const float cap = 32767.0f / 128.0f;
#pragma unroll
      for (int v = 0; v < NV; ++v) {
        m0[lane + 32 * v] = a.clamp_mid ? fminf(acc0[v], cap) : acc0[v];
        if (two) m1[lane + 32 * v] = a.clamp_mid ? fminf(acc1[v], cap) : acc1[v];
      }
    }
    __syncwarp();  // ring slots complete

    emit(qs);
    if (two) emit(qs1);
    qs = qs1 + 1 == R ? 0 : qs1 + 1;
  }
}

// The ring design, for plans whose horizontal and vertical tap counts are
// both K (the chain's upscales: bicubic 4, lanczos 6, bilinear 2). A block
// is one warp and owns a 256-column x tile_h-row output tile: it stages the
// tile's source rows (stage), then walks them top to
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
  stage<T>(src + (size_t)t * src_frame, buf0, a, rlo, xb);
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
      stage<T>(src + (size_t)tn * src_frame, buf0 + (b ^ 1) * buf_stride, a, rlo, xb);
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

template <typename T, bool EXACT, int NV>
cudaError_t launch_stream(const ResizeArgs& a, int n_rt, int grid_z,
                          cudaStream_t stream) {
  if (a.kh % (4 * stream_groups(NV)) != 0) return cudaErrorInvalidValue;
  const int smem = stream_layout(a, sizeof(T), EXACT).total;
  auto kernel = resize_stream<T, EXACT, NV>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((a.dst_w + a.tile_w - 1) / a.tile_w, n_rt, grid_z);
  kernel<<<grid, 32, smem, stream>>>(a);
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

// ring: the plan has kh == kv in {2, 4, 6} and 256-column tiles
// (ops/cuda_kernels decides, and sizes the grid for one-warp blocks);
// otherwise resize_stream with tile_w / 32 columns a lane (tile_w one of
// 256, 128, 64, 32; kh a multiple of 4 * stream_groups).
template <typename T, bool EXACT>
cudaError_t launch_taps(const ResizeArgs& a, int n_rt, int grid_z, int ring,
                        cudaStream_t s) {
  if (ring) {
    if (a.kh != a.kv || a.tile_w != TILE_W) return cudaErrorInvalidValue;
    switch (a.kh) {
      case 2: return launch_ring<T, EXACT, 2>(a, n_rt, grid_z, s);
      case 4: return launch_ring<T, EXACT, 4>(a, n_rt, grid_z, s);
      case 6: return launch_ring<T, EXACT, 6>(a, n_rt, grid_z, s);
      default: return cudaErrorInvalidValue;
    }
  }
  if (a.kv <= 0 || a.kh <= 0) return cudaErrorInvalidValue;
  switch (a.tile_w) {
    case 256: return launch_stream<T, EXACT, 8>(a, n_rt, grid_z, s);
    case 128: return launch_stream<T, EXACT, 4>(a, n_rt, grid_z, s);
    case 64: return launch_stream<T, EXACT, 2>(a, n_rt, grid_z, s);
    case 32: return launch_stream<T, EXACT, 1>(a, n_rt, grid_z, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// elem_bytes: 1 (u8) or 2 (u16). exact: 1 for the swscale integer route
// (u8 only; coefficient arrays int32), 0 for the f32 route (f32 arrays).
// Plan arrays as ops/cuda_kernels._resize_plan builds them: hpos
// [n_ct * tile_w], co_h (ring: [n_ct * 256, kh]; stream: per column tile
// [kh / 4][tile_w] int16 pairs packed two to an int2 (exact) or
// [kh][tile_w] f32), tile_xb [n_ct], vpos/co_v [n_rt * tile_h(, kv)],
// tile_rlo [n_rt]; rn staged rows and sw staged columns per tile; grid_z
// frame groups; ring: launch resize_ring (kh == kv in {2, 4, 6}), else
// resize_stream; vec: source rows are 16-byte aligned.
// Returns the launch's cudaError_t (0 on success).
extern "C" int pc_resize_frames(
    const void* src, void* dst, int t, int elem_bytes, int exact,
    int src_h, int src_w, int dst_h, int dst_w, int tile_w, int tile_h,
    int n_rt, int rn, int sw, int grid_z, int ring, int vec,
    const int* hpos, const void* co_h, int kh, const int* tile_xb,
    const int* vpos, const void* co_v, int kv, const int* tile_rlo,
    int maxval, int clamp_mid, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const ResizeArgs a{src, dst, t, src_h, src_w, dst_h, dst_w, tile_w, tile_h,
                     rn, sw, vec, hpos, co_h, kh, tile_xb, vpos, co_v, kv,
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
