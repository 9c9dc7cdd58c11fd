// Correlation-pyramid lookup (RAFT-Stereo, config "reg" / "reg_cuda").
//
// Replaces the Pallas TPU kernel dkt_stereo_tpu/ops/pallas/corr_lookup.py
// (corr_lookup_pallas :290; _lookup_fwd_impl :223 with _fwd_kernel :42, and
// the chunked _lookup_fwd_chunked :112 with _fwd_kernel_level :94). For every
// pixel (b, h, w1) and level i it samples the 2r+1 positions
// x/2^i + k - r, k = 0..2r, along the volume row vol_i[b, h, w1, :] with
// linear interpolation and zero padding, and writes them to
// out[b, h, w1, i*(2r+1) + k]: the motion encoder's input, channels last, in
// the compute dtype (bf16 under mixed precision, else fp32). Interpolation is
// fp32, with one round-to-nearest-even to bf16. Any number of levels (up to
// kMaxLevels, the parameter block) and any radius whose staging fits shared
// memory. A NaN coordinate gives NaN in its 2r+1 outputs of every level, as
// the TPU kernel's relu(1 - |j - NaN|) weights do; finite coordinates far
// out of range give zeros.
//
// What bounds it on the H100: bytes. Each (pixel, level) reads a window of
// 2r+2 neighbouring values of its own row (20 B in bf16 at r = 4) and writes
// 2r+1 values; a few FLOPs per byte. At B=8, 80 x 180 pixels, 4 levels,
// r = 4, bf16 out: 8.3 MB written, <= 9.2 MB of taps read.
//
// Design: the TPU kernel sweeps whole rows with relu(1 - |j - pos|) weights
// because it has no cheap gather; here the windows are gathered. Nothing is
// shared between pixels, and device memory moves whole 32-byte sectors, so a
// 20-byte window costs one or two of them: at 8 x 80 x 180 the windows touch
// ~28 MB of sectors for ~9 MB of taps, which sets this kernel's floor. A
// block owns 64 consecutive pixels (fewer where the staging would not fit)
// of every level, one (level, pixel) item a thread, the items of one warp on
// one level:
//   1. each item copies the aligned 16-byte chunks that cover its window
//      (rows need no alignment: W2 = 45 or 22 start anywhere) into a slot
//      of shared memory with cp.async, all of them issued before any
//      arithmetic;
//   2. each item interpolates its 2r+1 taps from its slot, the plain
//      twin's fp32 operations in the plain twin's order (each tap position
//      rounded on its own, no contraction), into the block's output span in
//      shared memory;
//   3. the block's contiguous span of 64 x L x (2r+1) outputs goes to
//      device memory in 16-byte stores.
// The position is clamped before the integer conversion; the clamp only
// moves positions whose taps are all outside the row.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxLevels = 32;
constexpr long long kMaxSmem = 232448;  // a block's shared memory on the H100

struct Levels {
  const void* vol[kMaxLevels];
  int w2[kMaxLevels];
};

__host__ __device__ inline long long round16(long long b) { return (b + 15) / 16 * 16; }

// Shared memory of one block: an int4 of metadata and a window slot per
// (level, pixel) item, then the block's output span. Mirrored by
// ops/cuda/corr_lookup.py::fwd_smem_bytes.
struct Plan {
  int taps;
  long long slot_bytes, slot_off, out_off, bytes;
};

__host__ __device__ inline Plan make_plan(int levels, int radius, int ev, int eo, int pixels) {
  Plan pl;
  pl.taps = 2 * radius + 1;
  const long long items = (long long)pixels * levels;
  // a window of at most 2r+3 values starting anywhere in its first chunk
  pl.slot_bytes = round16((16 - ev) + (long long)(pl.taps + 2) * ev);
  pl.slot_off = items * 16;
  pl.out_off = pl.slot_off + items * pl.slot_bytes;
  pl.bytes = pl.out_off + round16(items * pl.taps * eo);
  return pl;
}

__device__ __forceinline__ float to_f32(const float* p) { return *p; }
__device__ __forceinline__ float to_f32(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

__device__ __forceinline__ void cp_async16(void* smem, uintptr_t gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// 2^-lvl, exact: x * 2^-lvl equals the plain twin's x / 2**lvl
__device__ __forceinline__ float pow2_neg(int lvl) { return __int_as_float((127 - lvl) << 23); }

template <typename TV, typename TO>
__global__ void __launch_bounds__(kThreads)
    corr_lookup_kernel(Levels lv, int levels, const float* __restrict__ coords,
                       TO* __restrict__ out, long long npix, int radius, int pixels) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Plan pl = make_plan(levels, radius, sizeof(TV), sizeof(TO), pixels);
  const int taps = pl.taps, C = levels * taps, items = pixels * levels;
  const long long pix0 = (long long)blockIdx.x * pixels;
  const int np = (int)min((long long)pixels, npix - pix0);
  int4* meta = reinterpret_cast<int4*>(smem);
  unsigned char* slots = smem + pl.slot_off;
  TO* out_s = reinterpret_cast<TO*>(smem + pl.out_off);
  const float rf = (float)radius;

  // 1. every item's window, copied chunk by chunk; no arithmetic waits
  for (int it = threadIdx.x; it < items; it += kThreads) {
    const int lvl = it / pixels, p = it - lvl * pixels;
    if (p >= np) continue;
    const long long pix = pix0 + p;
    const int w2 = lv.w2[lvl];
    float xs = coords[pix];
    int lo = 0, hi = -1, off = 0;
    if (!isnan(xs)) {
      xs = fminf(fmaxf(xs * pow2_neg(lvl), -(rf + 2.0f)), (float)w2 + rf + 1.0f);
      // taps k = 0 and 2r bound the window: positions are monotone in k
      lo = max((int)floorf(__fadd_rn(xs, -rf)), 0);
      hi = min((int)floorf(__fadd_rn(xs, rf)) + 1, w2 - 1);
      if (lo <= hi) {
        const TV* row = static_cast<const TV*>(lv.vol[lvl]) + pix * w2;
        const uintptr_t a = reinterpret_cast<uintptr_t>(row + lo);
        const uintptr_t c0 = a & ~static_cast<uintptr_t>(15);
        const uintptr_t c1 = reinterpret_cast<uintptr_t>(row + hi) & ~static_cast<uintptr_t>(15);
        off = (int)(a - c0);
        unsigned char* slot = slots + it * pl.slot_bytes;
        for (uintptr_t c = c0; c <= c1; c += 16) cp_async16(slot + (c - c0), c);
      }
    }
    meta[it] = make_int4(__float_as_int(xs), lo, hi, off);
  }
  cp_async_wait_all();  // each item reads only the slot its own thread filled

  // 2. the taps, as the plain twin computes them
  for (int it = threadIdx.x; it < items; it += kThreads) {
    const int lvl = it / pixels, p = it - lvl * pixels;
    if (p >= np) continue;
    const int4 m = meta[it];
    const float xs = __int_as_float(m.x);
    TO* o = out_s + p * C + lvl * taps;
    if (isnan(xs)) {
      for (int k = 0; k < taps; ++k) store(o + k, __int_as_float(0x7fc00000));
      continue;
    }
    const int lo = m.y, hi = m.z;
    const TV* win = reinterpret_cast<const TV*>(slots + it * pl.slot_bytes + m.w);
    for (int k = 0; k < taps; ++k) {
      const float xk = __fadd_rn(xs, (float)(k - radius));
      const float f = floorf(xk);
      const int i0 = (int)f;
      const float w = __fsub_rn(xk, f);
      const float a = (i0 >= lo && i0 <= hi) ? to_f32(win + (i0 - lo)) : 0.0f;
      const float b = (i0 + 1 >= lo && i0 + 1 <= hi) ? to_f32(win + (i0 + 1 - lo)) : 0.0f;
      store(o + k, __fadd_rn(__fmul_rn(a, __fsub_rn(1.0f, w)), __fmul_rn(b, w)));
    }
  }
  __syncthreads();

  // 3. the block's output span: 16-byte stores, the ragged end by value
  const long long nbytes = (long long)np * C * sizeof(TO);
  TO* dst = out + pix0 * C;
  const int nvec = (int)(nbytes / 16);
  for (int v = threadIdx.x; v < nvec; v += kThreads)
    reinterpret_cast<uint4*>(dst)[v] = reinterpret_cast<const uint4*>(out_s)[v];
  for (int e = nvec * (16 / (int)sizeof(TO)) + threadIdx.x; e < np * C; e += kThreads)
    dst[e] = out_s[e];
}

template <typename TV, typename TO>
int launch(const Levels& lv, int levels, const float* coords, void* out, long long npix,
           int radius, int pixels, cudaStream_t s) {
  const Plan pl = make_plan(levels, radius, sizeof(TV), sizeof(TO), pixels);
  auto kernel = corr_lookup_kernel<TV, TO>;
  if (pl.bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)pl.bytes);
    if (e != cudaSuccess) return (int)e;
  }
  const unsigned blocks = (unsigned)((npix + pixels - 1) / pixels);
  kernel<<<blocks, kThreads, pl.bytes, s>>>(lv, levels, coords, static_cast<TO*>(out), npix,
                                            radius, pixels);
  return (int)cudaGetLastError();
}

bool valid(int levels, int radius, int pixels) {
  return levels >= 1 && levels <= kMaxLevels && radius >= 0 && pixels >= 8 && pixels <= 64 &&
         pixels % 8 == 0;
}

}  // namespace

// Dynamic shared memory of one block (the wrapper's plan mirrors it).
extern "C" long long corr_lookup_smem_bytes(int levels, int radius, int vol_bf16, int out_bf16,
                                            int pixels) {
  return make_plan(levels, radius, vol_bf16 ? 2 : 4, out_bf16 ? 2 : 4, pixels).bytes;
}

// Launch on `stream`: `vols` and `widths` hold one pointer and one width per
// level; `out` is a dense (npix, levels * (2r+1)) tensor, 16-byte aligned.
// Returns cudaGetLastError() after the launch (0 = ok).
extern "C" int corr_lookup_launch(const void* const* vols, const int* widths, int levels,
                                  const float* coords, void* out, long long npix, int radius,
                                  int vol_bf16, int out_bf16, int pixels, void* stream) {
  if (!valid(levels, radius, pixels) || npix < 1 ||
      corr_lookup_smem_bytes(levels, radius, vol_bf16, out_bf16, pixels) > kMaxSmem)
    return (int)cudaErrorInvalidValue;
  Levels lv = {};
  for (int i = 0; i < levels; ++i) {
    lv.vol[i] = vols[i];
    lv.w2[i] = widths[i];
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vol_bf16 && out_bf16)
    return launch<__nv_bfloat16, __nv_bfloat16>(lv, levels, coords, out, npix, radius, pixels, s);
  if (vol_bf16)
    return launch<__nv_bfloat16, float>(lv, levels, coords, out, npix, radius, pixels, s);
  if (out_bf16)
    return launch<float, __nv_bfloat16>(lv, levels, coords, out, npix, radius, pixels, s);
  return launch<float, float>(lv, levels, coords, out, npix, radius, pixels, s);
}
