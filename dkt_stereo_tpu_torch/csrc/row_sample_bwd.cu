// Gaussian row sampling (PCVNet's correlation lookup, K5), backward: the
// gradient of every pyramid level (dvol) and of the level-0 sample
// positions (dpos) from the lookup's incoming gradient g, in one launch.
//
// Replaces the Pallas TPU kernels of dkt_stereo_tpu/ops/pallas/row_sample.py
// (_row_sample_bwd_impl :108): _bwd_vol_kernel (:47, launched at :118) and
// _bwd_pos_kernel (:66, launched at :129), two pallas_calls per level. Here
// one launch covers every level and both gradients.
//
// On finite positions it is the exact transpose of the port's forward kernel
// csrc/row_sample.cu, whose output for pixel p, level i and sample k is
//   out[p, i*K + k] = v_i[x0] * (1 - w) + v_i[x0 + 1] * w,
//   x = pos[p, k] / cf^i, x0 = floor(x), w = x - x0,
// with taps outside the row read as 0. So
//   dvol_i[p, j] = sum_k g[p, i*K + k] * ((1 - w) [j == x0] + w [j == x0 + 1]),
//   dpos[p, k]   = sum_i (g*v_i[x0 + 1] - g*v_i[x0]) / cf^i,
// the two-tap form at exact integers too (row_sample.py:10-18: the sign form
// broke 29 of 2.1M positions on the TPU). The position is clamped to
// [-2, w2 + 1] before the integer conversion, as the forward clamps finite
// ones, so huge, infinite or NaN positions give no dvol contribution and
// zero dpos (the forward, the plain twin and the JAX kernel give NaN for a
// NaN position). The
// products g*(1 - w), g*w and g*v are rounded on their own (__fmul_rn,
// __fadd_rn: not contracted into fused multiply-adds), as the plain twin
// rounds them.
//
// g arrives as autograd hands it back: the forward output's dtype (bf16
// under mixed precision, converted to fp32 exactly) and folded layout, (B*G,
// L*S, H, W) channels-last in memory (csrc/row_sample.cu); only the loads of
// g know the layout. Tap t = l*K + g*S + s of pixel (b, hw) reads channel
// l*S + s of image b*G + g.
//
// What bounds it on the H100: bytes. At the training shapes (8 x 80 x 180
// pixels, K = 36, widths 180/45/11, bf16 levels) it writes 54.4 MB of dvol
// and 16.6 MB of dpos and reads 16.6 MB of positions, 49.8 MB of g and the
// rows' taps: ~0.047 ms at 3.35 TB/s (24.9 MB less with a bf16 g). Its arithmetic must stay below that.
// (The first port, one 128-thread block a pixel whose every dvol column
// scanned all K taps of its level, took 0.405 ms there, as long as the
// backward of F.grid_sample.)
//
// Design. One warp per pixel, 4 pixels (warps) a block (fewer where a
// pixel's working set needs more shared memory); a warp meets the block's
// other warps only once, before the block's stores.
//  - Taps: the warp stages its pixel's L*K taps in shared memory, one float4
//    each: (x0 bits, g*(1-w), g*w, and the tap's dpos term (g*v[x0 + 1] -
//    g*v[x0]) / cf^i, two row reads). dpos[p, k] then sums its L terms in
//    level order. The level scale is a multiply by the exact power of two,
//    the same number as the forward's ldexpf.
//  - dvol: the taps are binned by (level, x0), where only x0 in [-1, w2 - 1]
//    reaches a column of its level: level i owns w2_i + 1 bins, one array
//    for every level, each bin two fp32 running sums (its taps' g*(1-w)
//    and g*w). 32 taps at a time, __match_any_sync finds the taps that
//    share a bin, and the lowest lane of each group adds the group's taps
//    to the bin's sums in lane order; the rounds go in tap order, so every
//    bin sums its taps in increasing k. Column j of level i is then one add
//    of two bins: sum g*(1-w) over x0 = j, plus sum g*w over x0 = j - 1.
//    Work in taps + columns, where the one-block-per-pixel version compared
//    every column with every tap (L*K*sum(w2) ~ 8.5k tap visits a pixel);
//    a sorted tap list read by a loop per column (a counting sort, a scan
//    and a scatter) was barely faster than that version on the H100, and
//    these bins take half its time (chip_smoke.py phase 23, PERF.md).
//  - Stores: each warp writes its row of every level, zeros included, into
//    the block's staging area in the level's dtype; the block's rows of a
//    level are one contiguous span of dvol_i, so the block writes it with
//    16-byte vectors (the staging area is offset to the span's alignment),
//    with element stores only at the span's ragged ends. Every dvol element
//    is written exactly once: no memset, no atomics, a fixed summation
//    order, so two launches give the same bits.
// A null dvol pointer (no level needs a gradient) or dpos pointer (the
// positions need none) skips that half.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxLevels = 4;
constexpr int kPixels = 4;  // warps (pixels) per block, fewer if shared memory is short
constexpr int kMaxShared = 227 * 1024;

struct Levels {
  const void* vol[kMaxLevels];
  void* dvol[kMaxLevels];
  int w2[kMaxLevels];
};

inline int align16(int n) { return (n + 15) & ~15; }

// Shared memory of one block, in bytes from the dynamic base: per warp the
// taps (float4 x L*K) and the bins (float2 x (sum(w2) + L), rounded up to
// 16 bytes); then the block's staging area, level by level, each with 16
// bytes to shift it to its span's alignment. The host computes it and passes
// it to the kernel, whose tap loop then finds a warp's area in one multiply.
struct Layout {
  int bins, warp_bytes, level[kMaxLevels], total;
};

inline Layout layout(const int (&w2)[kMaxLevels], int levels, int K, int elem, int pixels) {
  Layout l;
  int ncols = 0;
#pragma unroll
  for (int i = 0; i < kMaxLevels; ++i) ncols += i < levels ? w2[i] : 0;
  l.bins = 16 * levels * K;
  l.warp_bytes = align16(l.bins + 8 * (ncols + levels + 1));  // zeroed 16 bytes at a time
  int off = pixels * l.warp_bytes;
#pragma unroll
  for (int i = 0; i < kMaxLevels; ++i) {
    l.level[i] = off;
    if (i < levels) off += align16(pixels * w2[i] * elem + 16);
  }
  l.total = off;
  return l;
}

// a[i] for a runtime i < kMaxLevels without indexing memory by it
template <typename A>
__device__ __forceinline__ A pick(const A (&a)[kMaxLevels], int i) {
  return i == 0 ? a[0] : i == 1 ? a[1] : i == 2 ? a[2] : a[3];
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

template <typename T, typename TG>
__global__ void __launch_bounds__(32 * kPixels)
row_sample_bwd_kernel(Levels lv, const Layout L, int levels, const float* __restrict__ pos,
                      const TG* __restrict__ g, float* __restrict__ dpos, long long npix,
                      int K, int log2_cf, int pixels, int G, int HW) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int LK = levels * K;
  int w2[kMaxLevels], cb[kMaxLevels];  // widths and first columns of the levels
  float scale[kMaxLevels];             // 2^-(i log2 cf), exact
  const T* vol[kMaxLevels];
  T* dvol[kMaxLevels];
  int ncols = 0;
#pragma unroll
  for (int i = 0; i < kMaxLevels; ++i) {
    w2[i] = i < levels ? lv.w2[i] : 0;
    cb[i] = ncols;
    ncols += w2[i];
    scale[i] = i < levels ? __int_as_float((127 - i * log2_cf) << 23) : 1.0f;
    vol[i] = static_cast<const T*>(lv.vol[i]);
    dvol[i] = static_cast<T*>(lv.dvol[i]);
  }
  unsigned char* ws = smem + warp * L.warp_bytes;
  float4* taps = reinterpret_cast<float4*>(ws);
  float2* bins = reinterpret_cast<float2*>(ws + L.bins);
  const long long p0 = (long long)blockIdx.x * pixels;
  const long long pix = p0 + warp;
  const bool live = pix < npix;
  const int nblk = (int)(npix - p0 < pixels ? npix - p0 : pixels);  // pixels of this block
  // the staging area of each level starts at its span's alignment mod 16
  T* stage[kMaxLevels];
  int mis[kMaxLevels];
#pragma unroll
  for (int i = 0; i < kMaxLevels; ++i) {
    mis[i] = (int)(reinterpret_cast<uintptr_t>(dvol[i] + p0 * w2[i]) & 15);
    stage[i] = reinterpret_cast<T*>(smem + L.level[i] + mis[i]);
  }

  // g's folded layout: the pixel's first value, once a warp; then tap (gi,
  // ch) sits gi * HW*LS + ch values on (32-bit offsets)
  const int S = K / G, LS = levels * S;
  const int pb = live ? (int)pix / HW : 0;
  const long long bG = (long long)pb * G, hw = live ? pix - (long long)pb * HW : 0;
  const TG* gpix = g + (bG * HW + hw) * LS;
  const int gstride = HW * LS;

  const bool want_vol = lv.dvol[0] != nullptr;  // uniform over the grid
  const int nbins = ncols + levels;  // level i: bins cb[i] + i + (x0 + 1), x0 in [-1, w2 - 1]
  if (live) {
    if (want_vol) {
      for (int b = lane; 2 * b < nbins; b += 32)
        reinterpret_cast<float4*>(bins)[b] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      __syncwarp();
    }
    const unsigned lt = (1u << lane) - 1u;
    // tap t = lvl*K + gi*S + s of this lane, stepped by 32 a round without
    // a division
    int tl = lane / K, tg = (lane - tl * K) / S, ts = lane - tl * K - tg * S;
    for (int t0 = 0; t0 < LK; t0 += 32) {
      const int t = t0 + lane;
      int bin = -1;
      if (t < LK) {
        const int lvl = tl;
        const int wl = pick(w2, lvl);
        const float sc = pick(scale, lvl);
        const int k = tg * S + ts, ch = lvl * S + ts;
        const float gv = to_f32(gpix[tg * gstride + ch]);
        // the forward's expressions (row_sample.cu): clamp, floor, fraction
        const float x = fminf(fmaxf(pos[pix * K + k] * sc, -2.0f), (float)(wl + 1));
        const float f = floorf(x);
        const int x0 = (int)f;
        const float w = __fsub_rn(x, f);
        float dp = 0.0f;
        if (dpos != nullptr) {
          const T* row = pick(vol, lvl) + pix * (long long)wl;
          const float v0 = (x0 >= 0 && x0 < wl) ? to_f32(row[x0]) : 0.0f;
          const float v1 = (x0 + 1 >= 0 && x0 + 1 < wl) ? to_f32(row[x0 + 1]) : 0.0f;
          dp = __fmul_rn(__fsub_rn(__fmul_rn(gv, v1), __fmul_rn(gv, v0)), sc);
        }
        taps[t] = make_float4(__int_as_float(x0), __fmul_rn(gv, __fsub_rn(1.0f, w)),
                              __fmul_rn(gv, w), dp);
        if (x0 >= -1 && x0 < wl) bin = pick(cb, lvl) + lvl + x0 + 1;
      }
      if (want_vol) {
        __syncwarp();  // this round's taps, for the group sums
        const unsigned same = __match_any_sync(0xffffffffu, bin);
        if (bin >= 0 && (same & lt) == 0u) {  // the group's lowest lane, for the group
          float2 acc = bins[bin];
          for (unsigned m = same; m != 0u; m &= m - 1u) {
            const float4 e = taps[t0 + __ffs(m) - 1];
            acc.x = __fadd_rn(acc.x, e.y);
            acc.y = __fadd_rn(acc.y, e.z);
          }
          bins[bin] = acc;
        }
      }
      __syncwarp();
      for (ts += 32; ts >= S;) {
        ts -= S;
        if (++tg == G) tg = 0, ++tl;
      }
    }
    if (dpos != nullptr) {
      for (int k = lane; k < K; k += 32) {
        float d = 0.0f;
        for (int lvl = 0; lvl < levels; ++lvl) d = __fadd_rn(d, taps[lvl * K + k].w);
        dpos[pix * K + k] = d;
      }
    }
    if (want_vol) {
      // column j of level i (c = cb[i] + j): bin c + i + 1 holds x0 = j,
      // bin c + i holds x0 = j - 1
      for (int c = lane; c < ncols; c += 32) {
        const int lvl = (c >= cb[1]) + (c >= cb[2]) + (c >= cb[3]);
        put(pick(stage, lvl) + warp * pick(w2, lvl) + (c - pick(cb, lvl)),
            __fadd_rn(bins[c + lvl + 1].x, bins[c + lvl].y));
      }
    }
  }
  if (!want_vol) return;
  __syncthreads();
  // the block's rows of each level: one span of nblk * w2 elements
#pragma unroll
  for (int i = 0; i < kMaxLevels; ++i) {
    if (i >= levels) break;
    const int nbytes = nblk * w2[i] * (int)sizeof(T);
    const unsigned char* src = reinterpret_cast<const unsigned char*>(stage[i]);
    unsigned char* dst = reinterpret_cast<unsigned char*>(dvol[i] + p0 * w2[i]);
    const int head = min((16 - mis[i]) & 15, nbytes);
    const int nvec = (nbytes - head) >> 4;
    const int tail0 = head + (nvec << 4);
    for (int v = threadIdx.x; v < nvec; v += blockDim.x)
      *reinterpret_cast<uint4*>(dst + head + 16 * v) =
          *reinterpret_cast<const uint4*>(src + head + 16 * v);
    const int nhead = head / (int)sizeof(T), ntail = (nbytes - tail0) / (int)sizeof(T);
    const int t = threadIdx.x;
    if (t < nhead)
      reinterpret_cast<T*>(dst)[t] = reinterpret_cast<const T*>(src)[t];
    else if (t < nhead + ntail)
      reinterpret_cast<T*>(dst + tail0)[t - nhead] =
          reinterpret_cast<const T*>(src + tail0)[t - nhead];
  }
}

template <typename T, typename TG>
int launch(const Levels& lv, int levels, const float* pos, const void* g, float* dpos,
           long long npix, int K, int log2_cf, int G, int HW, cudaStream_t s) {
  int pixels = kPixels;
  while (pixels > 1 && layout(lv.w2, levels, K, (int)sizeof(T), pixels).total > kMaxShared)
    pixels >>= 1;
  const Layout L = layout(lv.w2, levels, K, (int)sizeof(T), pixels);
  const int total = L.total;
  if (total > kMaxShared) return (int)cudaErrorInvalidValue;
  if (total > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        row_sample_bwd_kernel<T, TG>, cudaFuncAttributeMaxDynamicSharedMemorySize, total);
    if (e != cudaSuccess) return (int)e;
  }
  const long long blocks = (npix + pixels - 1) / pixels;
  row_sample_bwd_kernel<T, TG><<<(unsigned)blocks, 32 * pixels, total, s>>>(
      lv, L, levels, pos, static_cast<const TG*>(g), dpos, npix, K, log2_cf, pixels, G, HW);
  return (int)cudaGetLastError();
}

}  // namespace

// Launch on `stream`. dvol0..3 all null: no dvol; dpos null: no dpos (not
// both). dvol tensors must be 16-byte aligned (fresh allocations are). `g`
// is the folded (B*G, L*K/G, H, W) gradient, HW = H * W, in fp32 or bf16
// (`g_bf16`), channels-last in memory.
// Returns cudaGetLastError() after the launch (0 = ok), or
// cudaErrorInvalidValue for arguments it refuses, among them a pixel's
// working set beyond one block's shared memory.
extern "C" int row_sample_bwd_launch(const void* vol0, const void* vol1, const void* vol2,
                                     const void* vol3, void* dvol0, void* dvol1, void* dvol2,
                                     void* dvol3, int w2_0, int w2_1, int w2_2, int w2_3,
                                     int levels, const float* pos, const void* g, float* dpos,
                                     long long npix, int K, int log2_cf, int is_bf16, int G,
                                     int HW, int g_bf16, void* stream) {
  if (levels < 1 || levels > kMaxLevels || npix < 1 || npix > 0x7fffffffLL || K < 1 ||
      K > (1 << 20) || log2_cf < 0 || (levels - 1) * log2_cf > 126 ||
      (dvol0 == nullptr && dpos == nullptr) || G < 1 || K % G != 0 || HW < 1 ||
      npix % HW != 0 || (long long)HW * levels * K > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  Levels lv = {{vol0, vol1, vol2, vol3}, {dvol0, dvol1, dvol2, dvol3}, {w2_0, w2_1, w2_2, w2_3}};
  for (int i = 0; i < levels; ++i)
    if (lv.w2[i] < 1 || lv.vol[i] == nullptr || (dvol0 != nullptr && lv.dvol[i] == nullptr) ||
        (reinterpret_cast<uintptr_t>(lv.dvol[i]) & 15) != 0)
      return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16 && g_bf16)
    return launch<__nv_bfloat16, __nv_bfloat16>(lv, levels, pos, g, dpos, npix, K, log2_cf, G,
                                                HW, s);
  if (is_bf16)
    return launch<__nv_bfloat16, float>(lv, levels, pos, g, dpos, npix, K, log2_cf, G, HW, s);
  if (g_bf16)
    return launch<float, __nv_bfloat16>(lv, levels, pos, g, dpos, npix, K, log2_cf, G, HW, s);
  return launch<float, float>(lv, levels, pos, g, dpos, npix, K, log2_cf, G, HW, s);
}
