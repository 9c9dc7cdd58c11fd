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
// ones, so huge or infinite positions give no dvol contribution and zero
// dpos. A NaN position gives NaN in its pixel's whole row of every level
// and zero dpos, as the JAX kernels do (their relu(1 - |j - NaN|) weights
// are NaN in every column; their dpos selectors are 0). The
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
// other warps only after the level table is staged and before the block's
// stores.
//  - Levels: any number up to kMaxLevels. Their pointers, widths and first
//    columns arrive in one __grid_constant__ parameter block, and each block
//    stages a table of them in shared memory (a level's width, first column,
//    scale and staging offset in one 16-byte entry), so a lane reads its
//    tap's level with one shared load, wherever the level boundaries fall
//    in its warp.
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

constexpr int kMaxLevels = 32;
constexpr int kPixels = 4;  // warps (pixels) per block, fewer if shared memory is short
constexpr int kMaxShared = 227 * 1024;

// the launch's levels: host arrays copied into the parameter block
struct Levels {
  const void* vol[kMaxLevels];
  void* dvol[kMaxLevels];
  int w2[kMaxLevels];
  int cb[kMaxLevels];     // first column of the level among all levels' columns
  int stage[kMaxLevels];  // byte offset of the level's staging area in shared memory
};

// one level in a block's shared table: width, first column, 2^-(i log2 cf)
// as bits, and the byte offset of its staging area shifted to its span's
// alignment mod 16
struct Entry {
  int w2, cb, scale, stage;
};

inline int align16(int n) { return (n + 15) & ~15; }

// Shared memory of one block, in bytes from the dynamic base: the level
// table (an Entry and a volume pointer a level); per warp the taps (float4
// x L*K) and the bins (float2 x (sum(w2) + L), rounded up to 16 bytes);
// then the block's staging area, level by level, each with 16 bytes to
// shift it to its span's alignment. The host computes it (and
// ops/cuda/row_sample.py::bwd_smem_bytes mirrors it) and passes it to the
// kernel, whose tap loop then finds a warp's area in one multiply.
struct Layout {
  int table, bins, warp_bytes, ncols, total;
};

inline Layout layout(const int* w2, int levels, int K, int elem, int pixels, int* stage) {
  Layout l;
  l.ncols = 0;
  for (int i = 0; i < levels; ++i) l.ncols += w2[i];
  l.table = align16(levels * (int)(sizeof(Entry) + sizeof(void*)));
  l.bins = 16 * levels * K;
  l.warp_bytes = align16(l.bins + 8 * (l.ncols + levels + 1));  // zeroed 16 bytes at a time
  int off = l.table + pixels * l.warp_bytes;
  for (int i = 0; i < levels; ++i) {
    if (stage != nullptr) stage[i] = off;
    off += align16(pixels * w2[i] * elem + 16);
  }
  l.total = off;
  return l;
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

template <typename T, typename TG>
__global__ void __launch_bounds__(32 * kPixels)
row_sample_bwd_kernel(const __grid_constant__ Levels lv, const Layout L, int levels,
                      const float* __restrict__ pos, const TG* __restrict__ g,
                      float* __restrict__ dpos, long long npix, int K, int log2_cf, int pixels,
                      int G, int HW) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int LK = levels * K;
  const long long p0 = (long long)blockIdx.x * pixels;
  const bool want_vol = lv.dvol[0] != nullptr;  // uniform over the grid
  Entry* table = reinterpret_cast<Entry*>(smem);
  const void** vols = reinterpret_cast<const void**>(smem + levels * sizeof(Entry));
  // the block's level table; each level's staging area starts at its
  // span's alignment mod 16
  for (int i = threadIdx.x; i < levels; i += blockDim.x) {
    const int w2 = lv.w2[i];
    const int mis = want_vol ? (int)(reinterpret_cast<uintptr_t>(
                                         static_cast<T*>(lv.dvol[i]) + p0 * w2) & 15)
                             : 0;
    table[i] = Entry{w2, lv.cb[i], (127 - i * log2_cf) << 23, lv.stage[i] + mis};
    vols[i] = lv.vol[i];
  }
  __syncthreads();

  unsigned char* ws = smem + L.table + warp * L.warp_bytes;
  float4* taps = reinterpret_cast<float4*>(ws);
  float2* bins = reinterpret_cast<float2*>(ws + L.bins);
  const long long pix = p0 + warp;
  const bool live = pix < npix;
  const int nblk = (int)(npix - p0 < pixels ? npix - p0 : pixels);  // pixels of this block

  // g's folded layout: the pixel's first value, once a warp; then tap (gi,
  // ch) sits gi * HW*LS + ch values on (32-bit offsets)
  const int S = K / G, LS = levels * S;
  const int pb = live ? (int)pix / HW : 0;
  const long long bG = (long long)pb * G, hw = live ? pix - (long long)pb * HW : 0;
  const TG* gpix = g + (bG * HW + hw) * LS;
  const int gstride = HW * LS;

  const int ncols = L.ncols;
  const int nbins = ncols + levels;  // level i: bins cb[i] + i + (x0 + 1), x0 in [-1, w2 - 1]
  if (live) {
    if (want_vol) {
      for (int b = lane; 2 * b < nbins; b += 32)
        reinterpret_cast<float4*>(bins)[b] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      __syncwarp();
    }
    const unsigned lt = (1u << lane) - 1u;
    bool nan_pos = false;  // a NaN position of this lane's taps
    // tap t = lvl*K + gi*S + s of this lane, stepped by 32 a round without
    // a division
    int tl = lane / K, tg = (lane - tl * K) / S, ts = lane - tl * K - tg * S;
    for (int t0 = 0; t0 < LK; t0 += 32) {
      const int t = t0 + lane;
      int bin = -1;
      if (t < LK) {
        const int lvl = tl;
        const Entry e = table[lvl];
        const int wl = e.w2;
        const float sc = __int_as_float(e.scale);
        const int k = tg * S + ts, ch = lvl * S + ts;
        const float gv = to_f32(gpix[tg * gstride + ch]);
        // the forward's expressions (row_sample.cu): clamp, floor, fraction
        const float xr = pos[pix * K + k];
        nan_pos |= isnan(xr);
        const float x = fminf(fmaxf(xr * sc, -2.0f), (float)(wl + 1));
        const float f = floorf(x);
        const int x0 = (int)f;
        const float w = __fsub_rn(x, f);
        float dp = 0.0f;
        if (dpos != nullptr) {
          const T* row = static_cast<const T*>(vols[lvl]) + pix * (long long)wl;
          const float v0 = (x0 >= 0 && x0 < wl) ? to_f32(row[x0]) : 0.0f;
          const float v1 = (x0 + 1 >= 0 && x0 + 1 < wl) ? to_f32(row[x0 + 1]) : 0.0f;
          dp = __fmul_rn(__fsub_rn(__fmul_rn(gv, v1), __fmul_rn(gv, v0)), sc);
        }
        taps[t] = make_float4(__int_as_float(x0), __fmul_rn(gv, __fsub_rn(1.0f, w)),
                              __fmul_rn(gv, w), dp);
        if (x0 >= -1 && x0 < wl) bin = e.cb + lvl + x0 + 1;
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
      // a NaN position makes the pixel's row NaN in every level, as the
      // JAX kernel's weights do
      const bool nan_row = __any_sync(0xffffffffu, nan_pos);
      // column j of level i (c = cb[i] + j): bin c + i + 1 holds x0 = j,
      // bin c + i holds x0 = j - 1
      int lvl = 0;
      for (int c = lane; c < ncols; c += 32) {
        while (lvl + 1 < levels && c >= table[lvl + 1].cb) ++lvl;
        const Entry e = table[lvl];
        const float v = nan_row ? __int_as_float(0x7fc00000)
                                : __fadd_rn(bins[c + lvl + 1].x, bins[c + lvl].y);
        put(reinterpret_cast<T*>(smem + e.stage) + warp * e.w2 + (c - e.cb), v);
      }
    }
  }
  if (!want_vol) return;
  __syncthreads();
  // the block's rows of each level: one span of nblk * w2 elements
  for (int i = 0; i < levels; ++i) {
    const Entry e = table[i];
    const int mis = e.stage - lv.stage[i];
    const int nbytes = nblk * e.w2 * (int)sizeof(T);
    const unsigned char* src = smem + e.stage;
    unsigned char* dst = reinterpret_cast<unsigned char*>(static_cast<T*>(lv.dvol[i]) + p0 * e.w2);
    const int head = min((16 - mis) & 15, nbytes);
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

// the widest block (kPixels warps, halved while it does not fit) and its
// layout; a layout whose total exceeds kMaxShared does not fit at 1 pixel
inline Layout plan(const int* w2, int levels, int K, int elem, int& pixels, int* stage) {
  pixels = kPixels;
  while (pixels > 1 && layout(w2, levels, K, elem, pixels, nullptr).total > kMaxShared)
    pixels >>= 1;
  return layout(w2, levels, K, elem, pixels, stage);
}

template <typename T, typename TG>
int launch(Levels& lv, int levels, const float* pos, const void* g, float* dpos, long long npix,
           int K, int log2_cf, int G, int HW, cudaStream_t s) {
  int pixels;
  const Layout L = plan(lv.w2, levels, K, (int)sizeof(T), pixels, lv.stage);
  if (L.total > kMaxShared) return (int)cudaErrorInvalidValue;
  if (L.total > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        row_sample_bwd_kernel<T, TG>, cudaFuncAttributeMaxDynamicSharedMemorySize, L.total);
    if (e != cudaSuccess) return (int)e;
  }
  const long long blocks = (npix + pixels - 1) / pixels;
  row_sample_bwd_kernel<T, TG><<<(unsigned)blocks, 32 * pixels, L.total, s>>>(
      lv, L, levels, pos, static_cast<const TG*>(g), dpos, npix, K, log2_cf, pixels, G, HW);
  return (int)cudaGetLastError();
}

}  // namespace

// Dynamic shared memory of one block at `pixels` warps (the wrapper's plan
// mirrors it): `widths` holds one width per level, `elem` is the levels'
// element size in bytes.
extern "C" int row_sample_bwd_smem_bytes(const int* widths, int levels, int K, int elem,
                                         int pixels) {
  return layout(widths, levels, K, elem, pixels, nullptr).total;
}

// Launch on `stream`: `vols`, `dvols` and `widths` hold one entry per level
// (host arrays); dvols[0] null: no dvol; dpos null: no dpos (not both).
// dvol tensors must be 16-byte aligned (fresh allocations are). `g` is the
// folded (B*G, L*K/G, H, W) gradient, HW = H * W, in fp32 or bf16
// (`g_bf16`), channels-last in memory.
// Returns cudaGetLastError() after the launch (0 = ok), or
// cudaErrorInvalidValue for arguments it refuses, among them a pixel's
// working set beyond one block's shared memory.
extern "C" int row_sample_bwd_launch(const void* const* vols, void* const* dvols,
                                     const int* widths, int levels, const float* pos,
                                     const void* g, float* dpos, long long npix, int K,
                                     int log2_cf, int is_bf16, int G, int HW, int g_bf16,
                                     void* stream) {
  if (levels < 1 || levels > kMaxLevels || npix < 1 || npix > 0x7fffffffLL || K < 1 ||
      K > (1 << 20) || log2_cf < 0 || (levels - 1) * log2_cf > 126 ||
      (dvols[0] == nullptr && dpos == nullptr) || G < 1 || K % G != 0 || HW < 1 ||
      npix % HW != 0 || (long long)HW * levels * K > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  Levels lv = {};
  int ncols = 0;
  for (int i = 0; i < levels; ++i) {
    if (widths[i] < 1 || vols[i] == nullptr || (dvols[0] != nullptr && dvols[i] == nullptr) ||
        (reinterpret_cast<uintptr_t>(dvols[i]) & 15) != 0)
      return (int)cudaErrorInvalidValue;
    lv.vol[i] = vols[i];
    lv.dvol[i] = dvols[0] != nullptr ? dvols[i] : nullptr;
    lv.w2[i] = widths[i];
    lv.cb[i] = ncols;
    ncols += widths[i];
  }
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
