// Gaussian row sampling (PCVNet's correlation lookup, K5), backward: the
// gradient of every pyramid level (dvol) and of the level-0 sample
// positions (dpos) from the lookup's incoming gradient g, in one launch.
//
// Replaces the Pallas TPU kernels of dkt_stereo_tpu/ops/pallas/row_sample.py
// (_row_sample_bwd_impl :108): _bwd_vol_kernel (:47, launched at :118) and
// _bwd_pos_kernel (:66, launched at :129), two pallas_calls per level. Here
// one launch covers every level and both gradients.
//
// It is the exact transpose of the port's forward kernel csrc/row_sample.cu,
// whose output for pixel p, level i and sample k is
//   out[p, i*K + k] = v_i[x0] * (1 - w) + v_i[x0 + 1] * w,
//   x = pos[p, k] / cf^i, x0 = floor(x), w = x - x0,
// with taps outside the row read as 0. So
//   dvol_i[p, j] = sum_k g[p, i*K + k] * ((1 - w) [j == x0] + w [j == x0 + 1]),
//   dpos[p, k]   = sum_i (g*v_i[x0 + 1] - g*v_i[x0]) / cf^i,
// the two-tap form at exact integers too (row_sample.py:10-18: the sign form
// broke 29 of 2.1M positions on the TPU). The position is clamped to
// [-2, w2 + 1] before the integer conversion, exactly as in the forward, so
// huge, infinite or NaN positions give no dvol contribution and zero dpos
// (the plain twin and the JAX kernel give NaN for a NaN position). The
// products g*(1 - w), g*w and g*v are rounded on their own (__fmul_rn,
// __fadd_rn: not contracted into fused multiply-adds), as the plain twin
// rounds them.
//
// Work unit: one block per pixel. Its threads first stage the pixel's L*K
// taps in shared memory, one float4 each: (x0, g*(1-w), g*w, g). Then
//   - dpos: thread k sums its position's L levels (two tap reads a level);
//   - dvol: the threads stride over the sum of the level widths (236 columns
//     at the training grid, widths 180/45/11), and column j of level i sums,
//     over k = 0..K-1 in order, what each staged tap gives j. Every dvol
//     element is written exactly once, zeros included, in the level's dtype
//     (the sum in fp32, rounded once at the store): no memset, no atomics,
//     and two launches give the same bits.
// A null dvol pointer (no level needs a gradient) or dpos pointer (the
// positions need none) skips that half.
//
// What bounds it on the H100: bytes. At the training shapes (8 x 80 x 180
// pixels, K = 36, bf16 levels) it writes 54.4 MB of dvol and 16.6 MB of
// dpos and reads 16.6 MB of positions, 49.8 MB of g and at most the rows'
// taps. The column loop does K compares per column (8.5k per pixel), which
// is arithmetic that a later version can cut by binning the taps by column.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxLevels = 4;
constexpr int kThreads = 128;
constexpr int kMaxShared = 48 * 1024;

struct Levels {
  const void* vol[kMaxLevels];
  void* dvol[kMaxLevels];
  int w2[kMaxLevels];
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

template <typename T>
__global__ void __launch_bounds__(kThreads)
row_sample_bwd_kernel(Levels lv, int levels, const float* __restrict__ pos,
                      const float* __restrict__ g, float* __restrict__ dpos, int K, int log2_cf) {
  extern __shared__ float4 taps[];  // levels * K: (x0 bits, g*(1-w), g*w, g)
  const long long pix = blockIdx.x;
  const int LK = levels * K;
  for (int t = threadIdx.x; t < LK; t += blockDim.x) {
    const int lvl = t / K;
    const int w2 = lv.w2[lvl];
    const float gv = g[pix * LK + t];
    // the forward's expressions (row_sample.cu): clamp, floor, fraction
    const float x = fminf(fmaxf(ldexpf(pos[pix * K + (t - lvl * K)], -lvl * log2_cf), -2.0f),
                          (float)(w2 + 1));
    const float f = floorf(x);
    const float w = __fsub_rn(x, f);
    taps[t] = make_float4(__int_as_float((int)f), __fmul_rn(gv, __fsub_rn(1.0f, w)),
                          __fmul_rn(gv, w), gv);
  }
  __syncthreads();

  if (dpos != nullptr) {
    for (int k = threadIdx.x; k < K; k += blockDim.x) {
      float d = 0.0f;
      for (int lvl = 0; lvl < levels; ++lvl) {
        const float4 e = taps[lvl * K + k];
        const int x0 = __float_as_int(e.x);
        const int w2 = lv.w2[lvl];
        const T* row = static_cast<const T*>(lv.vol[lvl]) + pix * (long long)w2;
        const float v0 = (x0 >= 0 && x0 < w2) ? to_f32(row[x0]) : 0.0f;
        const float v1 = (x0 + 1 >= 0 && x0 + 1 < w2) ? to_f32(row[x0 + 1]) : 0.0f;
        d = __fadd_rn(d, ldexpf(__fsub_rn(__fmul_rn(e.w, v1), __fmul_rn(e.w, v0)),
                                -lvl * log2_cf));
      }
      dpos[pix * K + k] = d;
    }
  }

  if (lv.dvol[0] != nullptr) {
    int total = 0;
    for (int lvl = 0; lvl < levels; ++lvl) total += lv.w2[lvl];
    for (int c = threadIdx.x; c < total; c += blockDim.x) {
      int lvl = 0, j = c;
      while (j >= lv.w2[lvl]) j -= lv.w2[lvl++];
      const float4* e = taps + lvl * K;
      float acc = 0.0f;
      for (int k = 0; k < K; ++k) {
        const float4 t = e[k];
        const int x0 = __float_as_int(t.x);
        if (x0 == j) acc = __fadd_rn(acc, t.y);
        if (x0 + 1 == j) acc = __fadd_rn(acc, t.z);
      }
      store(static_cast<T*>(lv.dvol[lvl]) + pix * (long long)lv.w2[lvl] + j, acc);
    }
  }
}

}  // namespace

// Launch on `stream`. dvol0..3 all null: no dvol; dpos null: no dpos (not
// both). Returns cudaGetLastError() after the launch (0 = ok).
extern "C" int row_sample_bwd_launch(const void* vol0, const void* vol1, const void* vol2,
                                     const void* vol3, void* dvol0, void* dvol1, void* dvol2,
                                     void* dvol3, int w2_0, int w2_1, int w2_2, int w2_3,
                                     int levels, const float* pos, const float* g, float* dpos,
                                     long long npix, int K, int log2_cf, int is_bf16,
                                     void* stream) {
  const size_t shared = (size_t)levels * K * sizeof(float4);
  if (levels < 1 || levels > kMaxLevels || npix < 1 || npix > 0x7fffffffLL || K < 1 ||
      log2_cf < 0 || shared > (size_t)kMaxShared || (dvol0 == nullptr && dpos == nullptr))
    return (int)cudaErrorInvalidValue;
  Levels lv = {{vol0, vol1, vol2, vol3}, {dvol0, dvol1, dvol2, dvol3}, {w2_0, w2_1, w2_2, w2_3}};
  for (int i = 0; i < levels; ++i)
    if (lv.w2[i] < 1 || lv.vol[i] == nullptr || (dvol0 != nullptr && lv.dvol[i] == nullptr))
      return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned blocks = (unsigned)npix;
  if (is_bf16)
    row_sample_bwd_kernel<__nv_bfloat16><<<blocks, kThreads, shared, s>>>(lv, levels, pos, g,
                                                                          dpos, K, log2_cf);
  else
    row_sample_bwd_kernel<float><<<blocks, kThreads, shared, s>>>(lv, levels, pos, g, dpos, K,
                                                                  log2_cf);
  return (int)cudaGetLastError();
}
