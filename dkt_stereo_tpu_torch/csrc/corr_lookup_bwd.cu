// Correlation-pyramid lookup, backward (RAFT-Stereo, config "reg_cuda").
//
// Replaces the Pallas TPU kernel of the lookup's VJP,
// dkt_stereo_tpu/ops/pallas/corr_lookup.py (_lookup_bwd_impl :254, kernel
// body _bwd_kernel :63, call :268; large frames _lookup_bwd_chunked :170 with
// _bwd_kernel_level :152, call :206). Given g = dL/d(out), (B, H, W1,
// L*(2r+1)) in the forward's output dtype (bf16 or fp32, read exactly in
// fp32), it writes dL/d(vol_i) for every level i, (B, H, W1, W2_i) in the
// pyramid's dtype, every element once. The coordinates get no gradient:
// RAFT detaches them every iteration. A NaN coordinate gives a NaN row in
// every level, as the TPU kernel's relu(1 - |j - NaN|) weights do.
//
// What bounds it on the H100: bytes, almost all of them writes. Every
// element of every level is written, zeros included, while g and the
// coordinates are read once. At B=8, 80 x 180 pixels, W2 180/90/45/22,
// r = 4, bf16: 77.6 MB written against ~8.7 MB read.
//
// Design: each level's d/dvolume is one flat array, and a block owns the
// contiguous span of 64 pixels (fewer where the staging would not fit) in
// every level:
//   1. the block's g (64 x L x (2r+1) values) is read coalesced into
//      shared memory as fp32;
//   2. each (level, pixel) item scatters its taps into the few columns its
//      window touches, with the forward kernel's position arithmetic (each
//      tap position rounded on its own, corr_lookup.cu), so this is the
//      forward's exact transpose: forward out[k] = v[i0_k]*(1-w_k) +
//      v[i0_k+1]*w_k gives d/dv[j] = sum over the taps that read column j;
//      the window (at most 2r+3 columns) and its first column go to shared
//      memory;
//   3. every thread writes 16-byte vectors of the flat arrays: for element
//      e of the span, pixel e / W2 (a float reciprocal with an exact
//      correction) and column e % W2; a vector inside one row that misses
//      the row's window is a zero store. Every element has one writer: no
//      atomics, no zero fill, the same bits on every launch.
// Every level goes in one launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxLevels = 32;
constexpr long long kMaxSmem = 232448;  // a block's shared memory on the H100

struct Grads {
  void* dvol[kMaxLevels];
  int w2[kMaxLevels];
};

__host__ __device__ inline long long round16(long long b) { return (b + 15) / 16 * 16; }

// Shared memory of one block: the fp32 g span, each item's window (2r+3
// floats) and an int2 (first column, width) per item. Mirrored by
// ops/cuda/corr_lookup.py::bwd_smem_bytes.
struct Plan {
  int taps, win;
  long long win_off, meta_off, bytes;
};

__host__ __device__ inline Plan make_plan(int levels, int radius, int pixels) {
  Plan pl;
  pl.taps = 2 * radius + 1;
  pl.win = pl.taps + 2;
  const long long items = (long long)pixels * levels;
  pl.win_off = round16(items * pl.taps * 4);
  pl.meta_off = pl.win_off + round16(items * pl.win * 4);
  pl.bytes = pl.meta_off + items * 8;
  return pl;
}

__device__ __forceinline__ float to_f32(const float* p) { return *p; }
__device__ __forceinline__ float to_f32(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

__device__ __forceinline__ float pow2_neg(int lvl) { return __int_as_float((127 - lvl) << 23); }

template <typename T>
struct Vec;
template <>
struct Vec<float> {
  static constexpr int n = 4;
  static __device__ __forceinline__ uint4 pack(const float* v) {
    return make_uint4(__float_as_uint(v[0]), __float_as_uint(v[1]), __float_as_uint(v[2]),
                      __float_as_uint(v[3]));
  }
};
template <>
struct Vec<__nv_bfloat16> {
  static constexpr int n = 8;
  static __device__ __forceinline__ uint4 pack(const float* v) {
    uint4 r;
    unsigned* u = reinterpret_cast<unsigned*>(&r);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
      u[i] = *reinterpret_cast<const unsigned*>(&h);
    }
    return r;
  }
};

// d/dvol at column `col` of item `it`: its window value, or zero
__device__ __forceinline__ float window_value(const int2* meta, const float* win_s, int win,
                                              int it, int col) {
  const int2 m = meta[it];
  const int j = col - m.x;
  return (j >= 0 && j < m.y) ? win_s[it * win + min(j, win - 1)] : 0.0f;
}

template <typename TG, typename TD>
__global__ void __launch_bounds__(kThreads)
    corr_lookup_bwd_kernel(Grads gr, int levels, const float* __restrict__ coords,
                           const TG* __restrict__ g, long long npix, int radius, int pixels) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Plan pl = make_plan(levels, radius, pixels);
  const int taps = pl.taps, win = pl.win, C = levels * taps, items = pixels * levels;
  const long long pix0 = (long long)blockIdx.x * pixels;
  const int np = (int)min((long long)pixels, npix - pix0);
  float* g_s = reinterpret_cast<float*>(smem);
  float* win_s = reinterpret_cast<float*>(smem + pl.win_off);
  int2* meta = reinterpret_cast<int2*>(smem + pl.meta_off);
  const float rf = (float)radius;

  // 1. the block's g, coalesced
  const TG* gb = g + pix0 * C;
  for (int e = threadIdx.x; e < np * C; e += kThreads) g_s[e] = to_f32(gb + e);
  __syncthreads();

  // 2. each item's window of d/dvol
  for (int it = threadIdx.x; it < items; it += kThreads) {
    const int lvl = it / pixels, p = it - lvl * pixels;
    if (p >= np) continue;
    float* wv = win_s + it * win;
    float xs = coords[pix0 + p];
    if (isnan(xs)) {  // a NaN row
      for (int j = 0; j < win; ++j) wv[j] = __int_as_float(0x7fc00000);
      meta[it] = make_int2(0, gr.w2[lvl]);
      continue;
    }
    const int w2 = gr.w2[lvl];
    xs = fminf(fmaxf(xs * pow2_neg(lvl), -(rf + 2.0f)), (float)w2 + rf + 1.0f);
    const int xa = (int)floorf(__fadd_rn(xs, -rf));
    for (int j = 0; j < win; ++j) wv[j] = 0.0f;
    const float* gp = g_s + p * C + lvl * taps;
    int i0 = xa;
    for (int k = 0; k < taps; ++k) {
      const float xk = __fadd_rn(xs, (float)(k - radius));
      const float f = floorf(xk);
      const float w = __fsub_rn(xk, f);
      i0 = (int)f;
      wv[i0 - xa] = __fadd_rn(wv[i0 - xa], __fmul_rn(gp[k], __fsub_rn(1.0f, w)));
      wv[i0 + 1 - xa] = __fadd_rn(wv[i0 + 1 - xa], __fmul_rn(gp[k], w));
    }
    meta[it] = make_int2(xa, i0 + 2 - xa);
  }
  __syncthreads();

  // 3. every level's span, 16-byte vectors
  constexpr int V = Vec<TD>::n;
  for (int lvl = 0; lvl < levels; ++lvl) {
    const int w2 = gr.w2[lvl];
    const float inv = 1.0f / (float)w2;
    TD* dst = static_cast<TD*>(gr.dvol[lvl]) + pix0 * w2;
    const int span = np * w2, nvec = span / V, base = lvl * pixels;
    for (int v = threadIdx.x; v < nvec; v += kThreads) {
      const int e0 = v * V;
      int p = __float2int_rz(__int2float_rn(e0) * inv);
      int col = e0 - p * w2;
      while (col < 0) { --p; col += w2; }
      while (col >= w2) { ++p; col -= w2; }
      float vals[V];
      const int2 m = meta[base + p];
      if (col + V <= w2 && (col + V <= m.x || col >= m.x + m.y)) {
#pragma unroll
        for (int t = 0; t < V; ++t) vals[t] = 0.0f;
      } else {
#pragma unroll
        for (int t = 0; t < V; ++t) {
          vals[t] = window_value(meta, win_s, win, base + p, col);
          if (++col == w2) { col = 0; ++p; }
        }
      }
      reinterpret_cast<uint4*>(dst)[v] = Vec<TD>::pack(vals);
    }
    for (int e = nvec * V + threadIdx.x; e < span; e += kThreads) {
      const int p = e / w2;
      store(dst + e, window_value(meta, win_s, win, base + p, e - p * w2));
    }
  }
}

template <typename TG, typename TD>
int launch(const Grads& gr, int levels, const float* coords, const void* g, long long npix,
           int radius, int pixels, cudaStream_t s) {
  const Plan pl = make_plan(levels, radius, pixels);
  auto kernel = corr_lookup_bwd_kernel<TG, TD>;
  if (pl.bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)pl.bytes);
    if (e != cudaSuccess) return (int)e;
  }
  const unsigned blocks = (unsigned)((npix + pixels - 1) / pixels);
  kernel<<<blocks, kThreads, pl.bytes, s>>>(gr, levels, coords, static_cast<const TG*>(g), npix,
                                            radius, pixels);
  return (int)cudaGetLastError();
}

}  // namespace

// Dynamic shared memory of one block (the wrapper's plan mirrors it).
extern "C" long long corr_lookup_bwd_smem_bytes(int levels, int radius, int pixels) {
  return make_plan(levels, radius, pixels).bytes;
}

// Launch on `stream`: `dvols` and `widths` hold one pointer and one width per
// level, each d/dvolume dense and 16-byte aligned; `g` is a dense (npix,
// levels * (2r+1)) tensor. Returns cudaGetLastError() after the launch
// (0 = ok).
extern "C" int corr_lookup_bwd_launch(void* const* dvols, const int* widths, int levels,
                                      const float* coords, const void* g, long long npix,
                                      int radius, int g_bf16, int vol_bf16, int pixels,
                                      void* stream) {
  if (levels < 1 || levels > kMaxLevels || radius < 0 || pixels < 8 || pixels > 64 ||
      pixels % 8 != 0 || npix < 1 || corr_lookup_bwd_smem_bytes(levels, radius, pixels) > kMaxSmem)
    return (int)cudaErrorInvalidValue;
  Grads gr = {};
  for (int i = 0; i < levels; ++i) {
    gr.dvol[i] = dvols[i];
    gr.w2[i] = widths[i];
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (g_bf16 && vol_bf16)
    return launch<__nv_bfloat16, __nv_bfloat16>(gr, levels, coords, g, npix, radius, pixels, s);
  if (g_bf16) return launch<__nv_bfloat16, float>(gr, levels, coords, g, npix, radius, pixels, s);
  if (vol_bf16) return launch<float, __nv_bfloat16>(gr, levels, coords, g, npix, radius, pixels, s);
  return launch<float, float>(gr, levels, coords, g, npix, radius, pixels, s);
}
