// Combined geometry-encoding volume lookup (IGEV-Stereo, K4), backward:
// d/dgeo and d/dcorr of every level from the lookup's incoming gradient g.
//
// Replaces the Pallas TPU kernels of dkt_stereo_tpu/ops/pallas/geo_lookup.py
// (_geo_bwd_impl :223): _bwd_geo_kernel (:119, launched at :261) and
// _bwd_corr_kernel (:153, launched at :285), one pallas_call per level each.
// Here each kernel covers every level in one launch.
//
// It is the exact transpose of the port's forward kernel csrc/geo_lookup.cu,
// not of the JAX arithmetic: the forward shares one fractional weight w
// across the 2r+1 taps of a (pixel, level, part) and reads the 2r+2 slots
// x0 .. x0+2r+1, with
//   out[k] = v[x0+k] * (1-w) + v[x0+k+1] * w,   k = 0 .. 2r.
// So slot s = x0 + j (0 <= j <= 2r+1) of that pixel's row receives
//   dv[s] = g[j] * (1-w) [j <= 2r] + g[j-1] * w [j >= 1],
// and every other slot receives 0. first_tap() below computes p0, x0 and w
// with the forward's expressions: the position is clamped to [-(2r+3), n+1]
// before the integer conversion, so +-1e9 gives zeros. A NaN position
// (a NaN disparity; for dcorr also a NaN coordinate) gives NaN in its
// pixel's whole row of every level, as the JAX kernels' relu(1 - |j - NaN|)
// weights do and the plain twin does: its weight is NaN, its window reaches
// no slot, and a block that holds one fills those rows with NaN.
//
// Outputs, in the pyramid's dtype (bf16 or fp32, the math in fp32, rounded
// once at the store):
//   dgeo_i  (npix, D_i, C), channel-minor: element (p, s, c) reads g[p, i*
//           (C+1)*(2r+1) + c*(2r+1) + j] and j-1 with j = s - x0(disp/2^i);
//   dcorr_i (npix, W2_i): element (p, s) reads g[p, i*(C+1)*(2r+1) +
//           C*(2r+1) + j] and j-1 with j = s - x0((coords - disp)/2^i).
//
// What bounds it on the H100: bytes. Every output element is written once,
// zeros outside the tap window included: at the IGEV training step (8 x 80
// x 184, D 48/24 x 8, W2 184/92, bf16) 135.7 MB of dgeo and 65.0 MB of
// dcorr, beside 49.3 MB and 7.3 MB of g taps that land in range: 0.0554 and
// 0.0219 ms at 3.35 TB/s. About 79 % of level 0's dgeo is zeros that need no
// read.
//
// Design. The first port gave a thread 8 consecutive outputs: a 64-bit
// division to find them, then disp reloaded and the first tap recomputed
// by every thread of a pixel (48 of them), scattered fp32 gathers of g, and
// only then its one 16-byte store; its grid was sized for the largest level,
// so half of level 1's blocks exited at once (30 % of its bound). Here a
// block owns a tile of P consecutive pixels (a power of two, 8..64, from the
// wrapper's plan) and every level of them:
//   1. one thread per (pixel, level) computes disp (and coords), the first
//      tap and the weight once, with first_tap()'s expressions, into shared
//      memory;
//   2. the g pieces whose windows reach the row (C*(2r+1) fp32 a pixel and
//      level for dgeo, 2r+1 for dcorr) are copied by cp.async as the
//      aligned 16-byte chunks that cover them, all issued before any wait;
//   3. level by level, the tile's output span (P*D_i*C or P*W2_i values,
//      one contiguous range) is built in shared memory: zeroed with 16-byte
//      stores, then each window's 2r+2 slots x C channels written by one
//      thread an element (a window's slots are distinct, so every element is
//      written once), then the span goes out as aligned 16-byte vectors, the
//      same instruction for zeros and values, whole 32-byte sectors a warp.
// No atomics, no memset pass, no integer division per element (float
// reciprocals find an element's pixel and slot). Variants that stored the
// zero vectors and the others from registers with different instructions
// (a warp's lanes split between them, so a 32-byte sector arrives in
// pieces) ran slower on the H100 than this staging. Any number of levels
// up to kMaxLevels (the parameter block) and any radius whose staging fits
// shared memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxLevels = 32;
constexpr long long kMaxSmem = 232448;  // a block's shared memory on the H100

struct Grads {
  void* out[kMaxLevels];  // dgeo_i (npix, D_i, C) or dcorr_i (npix, W2_i)
  int n[kMaxLevels];      // D_i or W2_i
};

__host__ __device__ inline long long round16(long long b) { return (b + 15) / 16 * 16; }

// Shared memory of one block: an int4 a (pixel, level) item (x0, w, the g
// piece's offset in its slot, whether the window reaches the row), a slot
// a item for its g piece, staged from anywhere in its first 16-byte chunk,
// then the staging area of one level's output span (the widest level's).
// Mirrored by ops/cuda/geo_lookup.py::bwd_smem_bytes.
struct Plan {
  int len;  // g floats a item
  long long slot, slot_off, stage_off, bytes;
};

__host__ __device__ inline Plan make_plan(int levels, int radius, int channels, bool geo,
                                          int pixels, int max_size, int eo) {
  Plan pl;
  const int taps = 2 * radius + 1;
  pl.len = geo ? channels * taps : taps;
  const long long items = (long long)pixels * levels;
  pl.slot = round16(pl.len * 4LL) + 16;
  pl.slot_off = items * 16;
  pl.stage_off = pl.slot_off + items * pl.slot;
  pl.bytes = pl.stage_off + round16((long long)pixels * max_size * (geo ? channels : 1) * eo);
  return pl;
}

__device__ __forceinline__ void cp_async16(void* smem, uintptr_t gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// 2^-lvl, exact: the forward's x / 2^lvl
__device__ __forceinline__ float pow2_neg(int lvl) { return __int_as_float((127 - lvl) << 23); }

// The forward kernel's first tap and shared fractional weight
// (csrc/geo_lookup.cu, the same expressions; NaN for a NaN position).
__device__ __forceinline__ void first_tap(float x, int radius, int n, int& x0, float& w) {
  const int taps = 2 * radius + 1;
  const float p = x - (float)radius;
  const float p0 = fminf(fmaxf(p, -(float)(taps + 2)), (float)(n + 1));
  const float f0 = floorf(p0);
  x0 = (int)f0;
  w = isnan(p) ? p : p0 - f0;
}

// floor(a / d) for 0 <= a < 2^24 and d >= 1, by a float reciprocal and
// one correction, without an integer division
__device__ __forceinline__ int udiv(int a, int d, float inv_d) {
  int q = (int)((float)a * inv_d);
  q -= q * d > a;
  q += (q + 1) * d <= a;
  return q;
}

__device__ __forceinline__ void store_one(float* dst, float v) { *dst = v; }
__device__ __forceinline__ void store_one(__nv_bfloat16* dst, float v) {
  *dst = __float2bfloat16_rn(v);
}

// kGeo: the geo volume (row of n*C per pixel, positions disp/2^i); else the
// init correlation (row of n per pixel, positions (coords - disp)/2^i).
template <typename T, bool kGeo>
__global__ void __launch_bounds__(kThreads)
    geo_lookup_bwd_kernel(const __grid_constant__ Grads gr, int levels, int channels,
                          const float* __restrict__ disp, const float* __restrict__ coords,
                          const float* __restrict__ g, long long npix, int radius,
                          int log2_pixels, int max_size) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int VE = 16 / sizeof(T);  // elements a vector
  const int P = 1 << log2_pixels;
  const int taps = 2 * radius + 1;
  const int C = kGeo ? channels : 1;
  const Plan pl = make_plan(levels, radius, channels, kGeo, P, max_size, sizeof(T));
  const long long pix0 = (long long)blockIdx.x * P;
  const int np = (int)min((long long)P, npix - pix0);
  const int items = levels << log2_pixels;
  const long long gstride = (long long)levels * (channels + 1) * taps;
  int4* meta = reinterpret_cast<int4*>(smem);
  unsigned char* slots = smem + pl.slot_off;

  // 1. each (pixel, level): its first tap and weight, once
  int nan_pos = 0;  // a NaN position among this thread's items
  for (int it = threadIdx.x; it < items; it += kThreads) {
    const int lvl = it >> log2_pixels, p = it & (P - 1);
    int x0 = 0, hit = 0, off = 0;
    float w = 0.0f;
    if (p < np) {
      const long long pix = pix0 + p;
      const int n = gr.n[lvl];
      const float d = disp[pix];
      const float sc = pow2_neg(lvl);
      first_tap(kGeo ? d * sc : (coords[pix] - d) * sc, radius, n, x0, w);
      nan_pos |= isnan(w);
      hit = x0 + taps >= 0 && x0 <= n - 1;  // slots x0 .. x0 + 2r + 1 reach the row
      const float* piece = g + pix * gstride + lvl * (channels + 1) * taps + (kGeo ? 0 : channels * taps);
      off = (int)(reinterpret_cast<uintptr_t>(piece) & 15);
    }
    meta[it] = make_int4(x0, __float_as_int(w), off, hit);
  }
  const bool any_nan = __syncthreads_or(nan_pos) != 0;

  // 2. the g pieces of the windows that reach their rows, all copies in flight
  const int maxch = (pl.len * 4 + 15) / 16 + 1;
  for (int q = threadIdx.x; q < items * maxch; q += kThreads) {
    const int it = q / maxch, ch = q - it * maxch;
    const int4 m = meta[it];
    if (!m.w) continue;
    const int lvl = it >> log2_pixels, p = it & (P - 1);
    const float* piece =
        g + (pix0 + p) * gstride + lvl * (channels + 1) * taps + (kGeo ? 0 : channels * taps);
    const uintptr_t a = reinterpret_cast<uintptr_t>(piece);
    const uintptr_t c = (a & ~static_cast<uintptr_t>(15)) + 16 * ch;
    if (c <= ((a + pl.len * 4 - 1) & ~static_cast<uintptr_t>(15)))
      cp_async16(slots + it * pl.slot + 16 * ch, c);
  }

  cp_async_wait_all();
  __syncthreads();  // a thread reads pieces that other threads copied

  // 3. level by level: zero the tile's span in shared memory, scatter each
  // window's slots into it, then write the span out as 16-byte vectors
  T* stage = reinterpret_cast<T*>(smem + pl.stage_off);
  const int wslots = taps + 1;  // slots x0 .. x0 + 2r + 1 of a window
  const float inv_c = 1.0f / (float)C, inv_w = 1.0f / (float)(wslots * C);
  for (int lvl = 0; lvl < levels; ++lvl) {
    const int n = gr.n[lvl];
    const int row = n * C;  // outputs a pixel
    const int nvec = (np * row * (int)sizeof(T) + 15) / 16;
    for (int v = threadIdx.x; v < nvec; v += kThreads)
      reinterpret_cast<uint4*>(stage)[v] = make_uint4(0u, 0u, 0u, 0u);
    __syncthreads();
    // (pixel, window slot, channel) items: every element of a window is
    // written once (its slots are distinct), the rest stay zero
    const int4* lm = meta + (lvl << log2_pixels);
    const unsigned char* ls = slots + (lvl << log2_pixels) * pl.slot;
    for (int e = threadIdx.x; e < np * wslots * C; e += kThreads) {
      const int p = udiv(e, wslots * C, inv_w);
      const int r = e - p * wslots * C, j = udiv(r, C, inv_c), c = r - j * C;
      const int4 m = lm[p];
      const int sl = m.x + j;
      if (!m.w || sl < 0 || sl >= n) continue;
      const float w = __int_as_float(m.y);
      const float* gc = reinterpret_cast<const float*>(ls + p * pl.slot + m.z) + c * taps;
      float acc = 0.0f;
      if (j < taps) acc += gc[j] * (1.0f - w);
      if (j >= 1) acc += gc[j - 1] * w;
      store_one(stage + p * row + sl * C + c, acc);
    }
    if (any_nan) {
      // the rows of NaN positions: no window reaches them, so no element is
      // written twice
      const float inv_row = 1.0f / (float)row;
      for (int e = threadIdx.x; e < np * row; e += kThreads)
        if (isnan(__int_as_float(lm[udiv(e, row, inv_row)].y)))
          store_one(stage + e, __int_as_float(0x7fc00000));
    }
    __syncthreads();
    T* dst = static_cast<T*>(gr.out[lvl]) + pix0 * row;
    const int count = np * row, full = count / (16 / (int)sizeof(T));
    for (int v = threadIdx.x; v < full; v += kThreads)
      reinterpret_cast<uint4*>(dst)[v] = reinterpret_cast<const uint4*>(stage)[v];
    for (int e = full * (16 / (int)sizeof(T)) + threadIdx.x; e < count; e += kThreads)
      dst[e] = stage[e];
    __syncthreads();  // the staging area is the next level's
  }
}

bool valid(int levels, int radius, int channels, int pixels) {
  return levels >= 1 && levels <= kMaxLevels && radius >= 0 && channels >= 1 && pixels >= 8 &&
         pixels <= 64 && (pixels & (pixels - 1)) == 0;
}

template <typename T, bool kGeo>
int launch(const Grads& gr, int levels, int channels, const float* disp, const float* coords,
           const float* g, long long npix, int radius, int pixels, int max_size, cudaStream_t s) {
  const Plan pl = make_plan(levels, radius, channels, kGeo, pixels, max_size, sizeof(T));
  auto kernel = geo_lookup_bwd_kernel<T, kGeo>;
  if (pl.bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)pl.bytes);
    if (e != cudaSuccess) return (int)e;
  }
  const unsigned blocks = (unsigned)((npix + pixels - 1) / pixels);
  kernel<<<blocks, kThreads, pl.bytes, s>>>(gr, levels, channels, disp, coords, g, npix, radius,
                                            __builtin_ctz(pixels), max_size);
  return (int)cudaGetLastError();
}

int launch_part(bool geo, void* const* outs, const int* sizes, int levels, int channels,
                const float* disp, const float* coords, const float* g, long long npix,
                int radius, int is_bf16, int pixels, void* stream) {
  if (!valid(levels, radius, channels, pixels) || npix < 1 ||
      npix * (long long)levels * (channels + 1) * (2 * radius + 1) > (1LL << 40))
    return (int)cudaErrorInvalidValue;
  Grads gr = {};
  int max_size = 0;
  for (int i = 0; i < levels; ++i) {
    // the vector stores need 16-byte aligned level tensors; a tile's span
    // (pixels * size * C values) is then aligned too
    if (sizes[i] < 1 || (long long)pixels * sizes[i] * (geo ? channels : 1) >= (1LL << 24) ||
        reinterpret_cast<uintptr_t>(outs[i]) % 16 != 0)
      return (int)cudaErrorInvalidValue;
    gr.out[i] = outs[i];
    gr.n[i] = sizes[i];
    max_size = sizes[i] > max_size ? sizes[i] : max_size;
  }
  if (make_plan(levels, radius, channels, geo, pixels, max_size, is_bf16 ? 2 : 4).bytes > kMaxSmem)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (geo)
    return is_bf16 ? launch<__nv_bfloat16, true>(gr, levels, channels, disp, coords, g, npix,
                                                 radius, pixels, max_size, s)
                   : launch<float, true>(gr, levels, channels, disp, coords, g, npix, radius,
                                         pixels, max_size, s);
  return is_bf16 ? launch<__nv_bfloat16, false>(gr, levels, channels, disp, coords, g, npix,
                                                radius, pixels, max_size, s)
                 : launch<float, false>(gr, levels, channels, disp, coords, g, npix, radius,
                                        pixels, max_size, s);
}

}  // namespace

// Dynamic shared memory of one block (the wrapper's plan mirrors it); `geo`
// 1 for the dgeo kernel, 0 for dcorr; `max_size` the largest D_i or W2_i.
extern "C" long long geo_lookup_bwd_smem_bytes(int levels, int radius, int channels, int geo,
                                               int pixels, int max_size, int out_bf16) {
  return make_plan(levels, radius, channels, geo != 0, pixels, max_size, out_bf16 ? 2 : 4).bytes;
}

// Both launch functions take the same arguments: the output levels' pointers
// (dgeo or dcorr) and sizes (D_i or W2_i) as host arrays, the level count,
// the geo channels C, disp and coords (B*H*W fp32 each; the geo kernel
// ignores coords), g (B*H*W x L*(C+1)*(2r+1) fp32, dense), pixels, radius,
// bf16 flag, pixels a block, stream. Each returns cudaGetLastError() after
// the launch (0 = ok), or cudaErrorInvalidValue for arguments it refuses.
extern "C" int geo_lookup_bwd_geo_launch(void* const* outs, const int* sizes, int levels,
                                         int channels, const float* disp, const float* coords,
                                         const float* g, long long npix, int radius, int is_bf16,
                                         int pixels, void* stream) {
  return launch_part(true, outs, sizes, levels, channels, disp, coords, g, npix, radius, is_bf16,
                     pixels, stream);
}

extern "C" int geo_lookup_bwd_corr_launch(void* const* outs, const int* sizes, int levels,
                                          int channels, const float* disp, const float* coords,
                                          const float* g, long long npix, int radius,
                                          int is_bf16, int pixels, void* stream) {
  return launch_part(false, outs, sizes, levels, channels, disp, coords, g, npix, radius, is_bf16,
                     pixels, stream);
}
