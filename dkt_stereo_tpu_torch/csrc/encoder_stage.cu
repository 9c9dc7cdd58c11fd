// One fused full-resolution encoder stage (fnet stem-norm + layer1 chain).
//
// Replaces the Pallas TPU kernel dkt_stereo_tpu/ops/pallas/encoder_conv.py
// (encoder_stage, :274; kernel body _stage_kernel, :178). On logical NHWC
// tensors with C = 64 it computes
//
//   h = relu(a1 * u + b1)                         (relu optional)
//   h = relu(h + relu(a2 * v + b2))               (only with the v stream)
//   y = conv3x3(h, w), zero SAME padding, no bias
//
// with per-(sample, channel) affines a*, b* in fp32, h rounded to the
// activation dtype before the conv (the TPU kernel's VMEM buffer), fp32
// accumulation, y stored in the activation dtype, and per-(sample, channel)
// fp32 sums of y and y^2 taken from the fp32 accumulator, not from the
// rounded y. Optionally h itself is written out (the block's residual tap).
//
// The file also serves the VJP (encoder_conv.py::encoder_stage_ad, :476;
// its backward _stage_ad_bwd, :394-470, calls encoder_stage again on the
// flipped, IO-transposed taps with the identity affine): the adjoint SAME
// conv of the output cotangent g_y. In bf16 that is a kernel of its own,
// encoder_stage_adjoint_kernel; in fp32 (parity runs) the fp32 stage kernel
// with the identity affine and null statistics pointers.
//
// What bounds it on the H100: at (2, 736, 1280, 64) bf16 one stage moves
// 0.48 GB (u in, y out; 0.96 GB with v and h) and does 139 GFLOP of
// multiply-adds: ~0.14 ms of memory traffic, ~0.14 ms of tensor-core time.
// Bytes and products tie, so loads, products and stores must overlap and
// the products run near the wgmma rate.
//
// Design. The TPU kernel packs column pairs into 128 lanes (w2d) and carries
// a row halo across its sequential grid; neither is needed here: each tile
// of 8 output rows x 30 columns of one sample loads its halo'd input box by
// TMA and needs nothing from any other tile. Both bf16 kernels share one
// mainloop:
//  - Products through wgmma.mma_async m64n256k16, both operands read from
//    shared memory by descriptor, fp32 accumulators in registers: the 64
//    output channels on M (A = the taps, one 64 x 64 block a tap, rows of
//    64 input channels), 256 pixels on N (B = the box, pixel rows of 64
//    channels). Per instruction that is 2 KB of A and 8 KB of B for 524
//    kFLOP, 80 bytes a clock at the tensor cores' rate, within shared
//    memory's 128. Pixels on M (m64n64k16, A through ldmatrix) would need
//    the full 128 bytes a clock: rejected.
//  - The tap shift is a byte offset of B's start: the box is 10 rows of 32
//    pixels, so output pixel n = 32 r + c and tap (dy, dx) read box pixel
//    n + 32 dy + dx; columns 30 and 31 of each row are computed and dropped
//    (6 % of the products). Swizzling is a function of the shared-memory
//    address (TMA's write and wgmma's read alike), so a start 128 bytes
//    into a 1024-byte atom needs no base offset.
//  - Input through TMA: one cp.async.bulk.tensor.4d a box over the map
//    (C = 64, W, H, B), a (64, 32, 10, 1) box with the 128-byte swizzle (64
//    bf16 channels are one 128-byte row), into a ring completed by
//    mbarriers; a box never reads the next sample.
//  - Persistent blocks, one an SM: a producer warp keeps the next tiles'
//    loads in flight while one consumer warpgroup runs the 36 products of a
//    tile. The 72 KB of taps are copied once a block, already in the
//    swizzled order the descriptors read (laid out by the host).
//  - Epilogue: the fp32 accumulators are rounded to bf16 and written
//    pixel-major by stmatrix.trans into a 32 KB staging area, in the
//    swizzle a TMA store reads; one thread stores each of the tile's 8 rows
//    (a (64, 30, 1, 1) box; TMA clips the ragged right and bottom edges)
//    and the stores drain while the next tile is multiplied.
// The forward (encoder_stage_fwd_kernel) adds what the stage needs:
//  - The prologue in shared memory: a second warpgroup waits for each u box
//    (and the v box, by a TMA ring of its own), computes h over the box in
//    place, rounded to bf16, and hands it to the consumer by an mbarrier
//    while the consumer multiplies the previous tile. The channels of a
//    16-byte chunk follow from its address: chunk s of box pixel p holds
//    channels 8 (s ^ (p % 8)), and a prologue thread's chunks all hold the
//    same 8 channels: their per-sample affines live in its registers,
//    reloaded when the walk crosses into another sample.
//  - SAME padding belongs to h, not to u: TMA's zero fill gives u = 0
//    outside the sample, which the prologue would turn into relu(b1) != 0,
//    so it writes zeros at every box pixel outside the image.
//  - h (emit_h) is written by the prologue for the tile's interior 8 x 30
//    pixels only, so every pixel of h is written once.
//  - Statistics from the fp32 accumulators before y is rounded: with
//    channels on M each thread's accumulator rows are two fixed channels,
//    summed over the tile's pixels in the image (the dropped columns and
//    anything past W or H masked) into running sums, folded over the quad
//    by shuffles and added by one fp32 atomicAdd a (block, sample,
//    channel) when the walk leaves a sample or ends.
//  - The v ring takes a stage of the u ring: 3 u stages without v, 2 u
//    stages and 1 v stage with it.
// On the H100 the stage takes about half the time of the first kernel
// (mma.sync, no overlap of loads and products; chip_smoke.py phases 3 and
// 19, PERF.md). A ping-pong variant, two consumer warpgroups that each ran
// the prologue on its own tile and staged y in the tile's consumed u
// stage, was faster without v and slower with it: with one u stage a
// warpgroup and one shared v stage, every tile waited for its loads. One
// design serves both: this one.
// The bf16 adjoint (encoder_stage_adjoint_kernel) is the mainloop alone:
// no affine, ReLU, statistics or v, and TMA's zero fill is its padding. On
// the H100 it takes 0.456 ms a launch at the training shape, cuDNN's
// dgrad 0.594 (chip_smoke.py phase 7, PERF.md). Splitting each tile into
// two halves of 128 columns with accumulators of their own, so that one
// half's epilogue overlaps the other half's products, was slower there and
// needed more registers: rejected.
// fp32 (parity runs, and the fp32 VJP's adjoint): the same function on the
// fp32 CUDA cores. An 8 x 32 tile streams the input through shared memory
// in chunks of 8 channels, applying the prologue and the border zeros on
// the way in; each thread accumulates 8 pixels x 8 channels in registers,
// reusing every input value for the 3 horizontal taps; statistics reduced
// over the block and added with global atomics.

#include <cuda.h>  // CUtensorMap and its enums only: no driver library is linked
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;
constexpr int C = 64;  // channels in and out

// ---------------------------------------------------------------- fp32 path
constexpr int TH = 8;       // output rows per block, one warp each
constexpr int TW = 32;      // output columns per block
constexpr int CK = 8;       // input channels per shared-memory chunk
constexpr int NT = 256;     // threads per block
constexpr int IH = TH + 2;  // input tile rows with halo
constexpr int IW = TW + 2;  // input tile columns with halo

template <bool STATS>
__global__ void __launch_bounds__(NT)
encoder_stage_f32_kernel(const float* __restrict__ u, const float* __restrict__ a1,
                         const float* __restrict__ b1, const float* __restrict__ v,
                         const float* __restrict__ a2, const float* __restrict__ b2,
                         const float* __restrict__ w, float* __restrict__ y,
                         float* __restrict__ ssum, float* __restrict__ sssq,
                         float* __restrict__ hout, int H, int W, int relu_u) {
  __shared__ float in_s[CK][IH][IW];
  __shared__ __align__(16) float w_s[9][CK][C];
  __shared__ float red_sum[C];
  __shared__ float red_ssq[C];

  const int b = blockIdx.z;
  const int ty0 = blockIdx.y * TH;
  const int tx0 = blockIdx.x * TW;
  const int tid = threadIdx.x;
  // thread -> (output row r, 8 columns from c0, channels 4cg..4cg+3 and
  // 32+4cg..32+4cg+3); the split channel groups keep the float4 weight reads
  // of 8 neighbouring lanes on 32 distinct banks
  const int cg = tid & 7;
  const int r = tid >> 5;
  const int c0 = ((tid >> 3) & 3) * 8;

  if (tid < C) {
    red_sum[tid] = 0.0f;
    red_ssq[tid] = 0.0f;
  }

  const size_t base = (size_t)b * H * W * C;
  const int bc = b * C;

  float acc[8][8];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int k = 0; k < 8; ++k) acc[j][k] = 0.0f;

  for (int cc = 0; cc < C; cc += CK) {
    __syncthreads();  // the previous chunk is consumed
    for (int i = tid; i < CK * IH * IW; i += NT) {
      const int ci = i % CK;
      const int p = i / CK;
      const int col = p % IW;
      const int row = p / IW;
      const int gy = ty0 + row - 1;
      const int gx = tx0 + col - 1;
      float h = 0.0f;  // outside the image: SAME padding zeros
      if (gy >= 0 && gy < H && gx >= 0 && gx < W) {
        const int c = cc + ci;
        const size_t off = base + ((size_t)gy * W + gx) * C + c;
        h = u[off] * a1[bc + c] + b1[bc + c];
        if (relu_u) h = fmaxf(h, 0.0f);
        if (v != nullptr) h = fmaxf(h + fmaxf(v[off] * a2[bc + c] + b2[bc + c], 0.0f), 0.0f);
        // each image pixel is the interior of exactly one block
        if (hout != nullptr && row >= 1 && row <= TH && col >= 1 && col <= TW) hout[off] = h;
      }
      in_s[ci][row][col] = h;
    }
    for (int i = tid; i < 9 * CK * C; i += NT) {
      const int co = i % C;
      const int rest = i / C;
      const int ci = rest % CK;
      const int tap = rest / CK;
      w_s[tap][ci][co] = w[((size_t)tap * C + cc + ci) * C + co];
    }
    __syncthreads();

#pragma unroll 2
    for (int ci = 0; ci < CK; ++ci) {
#pragma unroll
      for (int dy = 0; dy < 3; ++dy) {
        float xin[10];
#pragma unroll
        for (int j = 0; j < 10; ++j) xin[j] = in_s[ci][r + dy][c0 + j];
#pragma unroll
        for (int dx = 0; dx < 3; ++dx) {
          const float4 wa = *reinterpret_cast<const float4*>(&w_s[dy * 3 + dx][ci][4 * cg]);
          const float4 wb = *reinterpret_cast<const float4*>(&w_s[dy * 3 + dx][ci][32 + 4 * cg]);
          const float wk[8] = {wa.x, wa.y, wa.z, wa.w, wb.x, wb.y, wb.z, wb.w};
#pragma unroll
          for (int j = 0; j < 8; ++j)
#pragma unroll
            for (int k = 0; k < 8; ++k) acc[j][k] = fmaf(xin[j + dx], wk[k], acc[j][k]);
        }
      }
    }
  }

  float ps[8], pq[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    ps[k] = 0.0f;
    pq[k] = 0.0f;
  }
  const int gy = ty0 + r;
  if (gy < H) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int gx = tx0 + c0 + j;
      if (gx < W) {
        float* yp = y + base + ((size_t)gy * W + gx) * C;
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          const int co = (k < 4) ? 4 * cg + k : 32 + 4 * cg + (k - 4);
          const float a = acc[j][k];
          yp[co] = a;
          ps[k] += a;
          pq[k] += a * a;
        }
      }
    }
  }
  if constexpr (STATS) {
    // lanes 8q + cg share their channels: fold the four of them
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      ps[k] += __shfl_xor_sync(0xffffffffu, ps[k], 8);
      ps[k] += __shfl_xor_sync(0xffffffffu, ps[k], 16);
      pq[k] += __shfl_xor_sync(0xffffffffu, pq[k], 8);
      pq[k] += __shfl_xor_sync(0xffffffffu, pq[k], 16);
    }
    if ((tid & 31) < 8) {
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const int co = (k < 4) ? 4 * cg + k : 32 + 4 * cg + (k - 4);
        atomicAdd(&red_sum[co], ps[k]);
        atomicAdd(&red_ssq[co], pq[k]);
      }
    }
    __syncthreads();
    if (tid < C) {
      atomicAdd(&ssum[bc + tid], red_sum[tid]);
      atomicAdd(&sssq[bc + tid], red_ssq[tid]);
    }
  }
}

// ---------------------------------------------------------------- bf16 path
// Both bf16 kernels multiply tiles of 8 output rows x 30 columns of one
// sample. A tile's input box, 10 rows x 32 columns x 64 channels from
// (x0 - 1, y0 - 1), lands by TMA as 320 pixel rows of 128 bytes, so the
// wgmma column n = 32 r + c (c = 0..31, the last two columns of each row
// wasted) of tap (dy, dx) reads box pixel n + 32 dy + dx: each tap is one
// constant byte offset of B's start, and N = 256 columns are the tile's 8
// rows.
constexpr int TILE_H = 8;                      // output rows per tile
constexpr int TILE_W = 30;                     // output columns per tile
constexpr int BOX_W = TILE_W + 2;              // box columns: the row pitch in pixels
constexpr int BOX_H = TILE_H + 2;              // box rows
constexpr int TILE_N = TILE_H * BOX_W;         // 256: wgmma N
constexpr int PIX_BYTES = C * 2;               // 128 bytes a pixel: one 128-byte swizzle row
constexpr int BOX_BYTES = BOX_H * BOX_W * PIX_BYTES;  // 40 KB
constexpr int TAP_BYTES = 9 * C * PIX_BYTES;   // 72 KB of taps
constexpr int OUT_BYTES = TILE_N * PIX_BYTES;  // 32 KB of output staging
constexpr int WG = 128;                        // a warpgroup
constexpr int kMaxSmem = 232448;               // an H100 block's shared memory
constexpr int kEncodeError = 100000;
static_assert(TILE_N == 256, "one m64n256k16 per tap and 16 input channels");

union Pack8 {  // eight bf16 channels, one 16-byte load or store
  uint4 q;
  __nv_bfloat162 h2[4];
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// shared-memory matrix descriptor: 128-byte swizzle, 8-row groups 1024 bytes
// apart (K-major rows of 128 bytes; the leading offset is unused)
__device__ __forceinline__ uint64_t wgmma_desc(uint32_t saddr) {
  return (uint64_t)((saddr & 0x3FFFF) >> 4) | (1ull << 16) | ((uint64_t)(1024 >> 4) << 32) |
         (1ull << 62);
}

// d (64 x 256, fp32) += a (64 x 16) * b (16 x 256); both operands bf16 in
// shared memory, read by descriptor, K-major; scale_d 0 overwrites d
__device__ __forceinline__ void wgmma_256(float (&d)[128], uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(a), "l"(b), "r"(scale_d));
}

__device__ __forceinline__ void acc_fence(float (&d)[128]) {
#pragma unroll
  for (int i = 0; i < 128; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

// returns once the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred p;\nWAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// barrier `id` among `count` threads (a warpgroup's own; 0 is __syncthreads)
__device__ __forceinline__ void named_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void stsm_x4_trans(uint32_t addr, uint32_t r0, uint32_t r1, uint32_t r2,
                                              uint32_t r3) {
  asm volatile("stmatrix.sync.aligned.m8n8.x4.trans.shared.b16 [%0], {%1, %2, %3, %4};\n" ::"r"(
                   addr),
               "r"(r0), "r"(r1), "r"(r2), "r"(r3)
               : "memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// the box of the tile at (x0, y0) of sample b, from (x0 - 1, y0 - 1); TMA
// fills what lies outside the sample with zeros
__device__ __forceinline__ void load_box(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int x0, int y0, int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(0), "r"(x0 - 1), "r"(y0 - 1), "r"(b)
      : "memory");
}

// the tile's 36 products into d: the taps (A: output channels x 64 input
// channels a tap) times the box in stage `box` (B: pixels x 64 channels)
__device__ __forceinline__ void tile_products(float (&d)[128], uint64_t desc_w, uint32_t box) {
  const uint64_t desc_in = wgmma_desc(box);
  acc_fence(d);
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
  for (int tap = 0; tap < 9; ++tap)
#pragma unroll
    for (int kc = 0; kc < C / 16; ++kc)
      wgmma_256(d, desc_w + ((tap * C * PIX_BYTES + kc * 32) >> 4),
                desc_in + ((((tap / 3) * BOX_W + tap % 3) * PIX_BYTES + kc * 32) >> 4), tap | kc);
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  acc_fence(d);
}

// y of a tile, by the consumer warpgroup (threads 0..127): d[4j + 2i + e]
// is (channel 16 warp + 8 i + lane / 4, pixel 8 j + 2 (lane % 4) + e);
// stmatrix.trans writes it pixel-major, bf16, into the staging area in the
// 128-byte swizzle a TMA store reads, and one thread stores each of the
// tile's rows (a (64, 30, 1, 1) box; TMA clips the ragged right and bottom).
// The stores drain while the next tile is multiplied.
__device__ __forceinline__ void store_tile(const float (&d)[128], uint32_t out_s,
                                           const CUtensorMap* ymap, int tid, int b, int y0,
                                           int x0, int H) {
  const int warp = tid >> 5;
  const int lane = tid & 31;
  // stmatrix: lane l gives row l % 8 of matrix l / 8 = (channel half
  // m & 1, pixel block m >> 1); rows are pixels, 8 channels of 16 bytes each
  const int sm_m = lane >> 3;
  const int sm_row = lane & 7;
  const uint32_t sm_chunk = (uint32_t)(((2 * warp + (sm_m & 1)) ^ sm_row) << 4);
  if (tid == 0) asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
  named_sync(1, WG);  // the last tile's stores have read the staging
#pragma unroll
  for (int j = 0; j < TILE_N / 8; j += 2) {
    const uint32_t px = (uint32_t)(8 * (j + (sm_m >> 1)) + sm_row);
    stsm_x4_trans(out_s + px * PIX_BYTES + sm_chunk, pack_bf16(d[4 * j], d[4 * j + 1]),
                  pack_bf16(d[4 * j + 2], d[4 * j + 3]), pack_bf16(d[4 * j + 4], d[4 * j + 5]),
                  pack_bf16(d[4 * j + 6], d[4 * j + 7]));
  }
  fence_async_shared();
  named_sync(1, WG);
  if (tid == 0) {
    const uint64_t map = reinterpret_cast<uint64_t>(ymap);
#pragma unroll 1
    for (int row = 0; row < TILE_H && y0 + row < H; ++row)
      asm volatile(
          "cp.async.bulk.tensor.4d.global.shared::cta.tile.bulk_group [%0, {%2, %3, %4, %5}], "
          "[%1];\n" ::"l"(map),
          "r"(out_s + row * BOX_W * PIX_BYTES), "r"(0), "r"(x0), "r"(y0 + row), "r"(b)
          : "memory");
    asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
  }
}

// ------------------------------------------------------- bf16 forward stage
// Persistent, one block an SM: a producer warp keeps TMA loads of the u
// (and v) boxes in flight; a prologue warpgroup turns each landed u box
// into h in place; the consumer warpgroup multiplies the previous tile's h
// meanwhile, then takes the statistics and stores y.
template <bool HAS_V>
struct Fwd {
  static constexpr int kStages = HAS_V ? 2 : 3;  // u ring
  static constexpr int kVStages = HAS_V ? 1 : 0;  // v ring
  static constexpr int kThreads = 2 * WG + 32;
  static constexpr int kBars = 3 * kStages + 2 * kVStages;
  // 1 KB of alignment slack, the taps, the rings, the staging, the
  // mbarriers. wgmma reads up to 2 pixels past a u stage: into the next
  // stage, the v ring or the staging area, for the discarded columns only
  static constexpr int kSmem =
      1024 + TAP_BYTES + (kStages + kVStages) * BOX_BYTES + OUT_BYTES + 8 * kBars;
  static_assert(kSmem <= kMaxSmem, "one block per SM");
};

template <bool HAS_V>
__global__ void __launch_bounds__(Fwd<HAS_V>::kThreads, 1)
encoder_stage_fwd_kernel(const __grid_constant__ CUtensorMap umap,
                         const __grid_constant__ CUtensorMap vmap,
                         const __grid_constant__ CUtensorMap ymap, const bf16* __restrict__ taps,
                         const float* __restrict__ a1, const float* __restrict__ b1,
                         const float* __restrict__ a2, const float* __restrict__ b2,
                         float* __restrict__ ssum, float* __restrict__ sssq,
                         bf16* __restrict__ hout, int B, int H, int W, int relu_u) {
  constexpr int NS = Fwd<HAS_V>::kStages;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;  // the swizzle atom is 1024 bytes
  unsigned char* sm = smem_raw + (base - raw);
  const uint32_t w_s = base;
  const uint32_t in_s = w_s + TAP_BYTES;
  const uint32_t v_s = in_s + NS * BOX_BYTES;
  const uint32_t out_s = v_s + Fwd<HAS_V>::kVStages * BOX_BYTES;
  const uint32_t full = out_s + OUT_BYTES;  // full[s] at full + 8 s: u landed
  const uint32_t ready = full + 8 * NS;      // ready[s]: h is in place
  const uint32_t empty = ready + 8 * NS;     // empty[s]: products done
  const uint32_t vfull = empty + 8 * NS;     // the v box landed
  const uint32_t vempty = vfull + 8;         // and was read
  const int tid = threadIdx.x;
  const int tiles_x = (W + TILE_W - 1) / TILE_W;
  const int per_sample = tiles_x * ((H + TILE_H - 1) / TILE_H);
  const int tiles = B * per_sample;  // < 2^31: checked by the launcher

  // the taps, already in their swizzled order, stay for every tile
  for (int i = tid; i < TAP_BYTES / 16; i += Fwd<HAS_V>::kThreads)
    reinterpret_cast<uint4*>(sm)[i] = reinterpret_cast<const uint4*>(taps)[i];
  if (tid == 0) {
    for (int s = 0; s < NS; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(ready + 8 * s, WG);
      mbar_init(empty + 8 * s, WG);
    }
    if constexpr (HAS_V) {
      mbar_init(vfull, 1);
      mbar_init(vempty, WG);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  fence_async_shared();  // the taps' generic stores, before wgmma reads them
  __syncthreads();

  if (tid >= 2 * WG) {  // producer: one lane keeps the rings' loads in flight
    if (tid == 2 * WG) {
      int it = 0;
      for (int t = blockIdx.x; t < tiles; t += gridDim.x, ++it) {
        const int s = it % NS;
        const int b = t / per_sample;
        const int r = t - b * per_sample;
        const int y0 = (r / tiles_x) * TILE_H;
        const int x0 = (r % tiles_x) * TILE_W;
        mbar_wait(empty + 8 * s, ((it / NS) & 1) ^ 1);
        mbar_expect_tx(full + 8 * s, BOX_BYTES);
        load_box(in_s + s * BOX_BYTES, &umap, full + 8 * s, x0, y0, b);
        if constexpr (HAS_V) {
          mbar_wait(vempty, (it & 1) ^ 1);
          mbar_expect_tx(vfull, BOX_BYTES);
          load_box(v_s, &vmap, vfull, x0, y0, b);
        }
      }
    }
    return;
  }

  if (tid >= WG) {
    // prologue warpgroup: h = [relu](a1 u + b1) [, relu(h + relu(a2 v + b2))]
    // over the landed box, in place, rounded to bf16, and zero at every box
    // pixel outside the image (the SAME padding belongs to h: TMA's zero u
    // would become relu(b1)); the tile's interior pixels are h's output.
    // Thread tt transforms chunks i = tt + 128 k: i % 8 and the pixel's
    // p % 8 = (i / 8) % 8 do not depend on k, so neither do its channels
    static_assert(WG % 64 == 0, "a prologue thread's channels are the same for every chunk");
    const int tt = tid - WG;
    const int c0 = 8 * ((tt & 7) ^ ((tt >> 3) & 7));
    float ra1[8], rb1[8], ra2[8], rb2[8];  // their affines for the current sample
    int cur_b = -1, it = 0;
    for (int t = blockIdx.x; t < tiles; t += gridDim.x, ++it) {
      const int s = it % NS;
      const int b = t / per_sample;
      const int r = t - b * per_sample;
      const int y0 = (r / tiles_x) * TILE_H;
      const int x0 = (r % tiles_x) * TILE_W;
      if (b != cur_b) {  // tiles go in sample order
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          ra1[e] = a1[b * C + c0 + e];
          rb1[e] = b1[b * C + c0 + e];
          if constexpr (HAS_V) {
            ra2[e] = a2[b * C + c0 + e];
            rb2[e] = b2[b * C + c0 + e];
          }
        }
        cur_b = b;
      }
      mbar_wait(full + 8 * s, (it / NS) & 1);
      if constexpr (HAS_V) mbar_wait(vfull, it & 1);
      uint4* box = reinterpret_cast<uint4*>(sm + (in_s - base) + s * BOX_BYTES);
      const uint4* vbox = reinterpret_cast<const uint4*>(sm + (v_s - base));
#pragma unroll 4
      for (int k = 0; k < BOX_BYTES / 16 / WG; ++k) {
        const int i = tt + WG * k;  // 16-byte chunk i % 8 of box pixel p, channels
        const int p = i >> 3;       // c0..c0+7 by the 128-byte swizzle
        const int row = p / BOX_W;
        const int col = p % BOX_W;
        const int y = y0 - 1 + row;
        const int x = x0 - 1 + col;
        Pack8 hq;
        hq.q = make_uint4(0u, 0u, 0u, 0u);
        if (y >= 0 && y < H && x >= 0 && x < W) {
          Pack8 uq, vq;
          uq.q = box[i];
          if constexpr (HAS_V) vq.q = vbox[i];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const float2 uf = __bfloat1622float2(uq.h2[j]);
            float h0 = uf.x * ra1[2 * j] + rb1[2 * j];
            float h1 = uf.y * ra1[2 * j + 1] + rb1[2 * j + 1];
            if (relu_u) {
              h0 = fmaxf(h0, 0.0f);
              h1 = fmaxf(h1, 0.0f);
            }
            if constexpr (HAS_V) {
              const float2 vf = __bfloat1622float2(vq.h2[j]);
              h0 = fmaxf(h0 + fmaxf(vf.x * ra2[2 * j] + rb2[2 * j], 0.0f), 0.0f);
              h1 = fmaxf(h1 + fmaxf(vf.y * ra2[2 * j + 1] + rb2[2 * j + 1], 0.0f), 0.0f);
            }
            hq.h2[j] = __floats2bfloat162_rn(h0, h1);
          }
          // each image pixel is the interior of exactly one tile
          if (hout != nullptr && row >= 1 && row <= TILE_H && col >= 1 && col <= TILE_W)
            *reinterpret_cast<uint4*>(hout + (((size_t)b * H + y) * W + x) * C + c0) = hq.q;
        }
        box[i] = hq.q;
      }
      if constexpr (HAS_V) mbar_arrive(vempty);
      fence_async_shared();  // h's generic stores, before wgmma reads them
      mbar_arrive(ready + 8 * s);
    }
    return;
  }

  // consumer warpgroup: 36 wgmma a tile, the statistics, y
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const uint64_t desc_w = wgmma_desc(w_s);
  float d[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) d[i] = 0.0f;
  // running sums of this thread's channels 16 warp + lane / 4 (+ 8) over the
  // current sample, folded over the quad and added once the walk leaves it
  float s0 = 0.0f, q0 = 0.0f, s1 = 0.0f, q1 = 0.0f;
  auto flush = [&](int b) {
#pragma unroll
    for (int o = 1; o < 4; o <<= 1) {
      s0 += __shfl_xor_sync(0xffffffffu, s0, o);
      q0 += __shfl_xor_sync(0xffffffffu, q0, o);
      s1 += __shfl_xor_sync(0xffffffffu, s1, o);
      q1 += __shfl_xor_sync(0xffffffffu, q1, o);
    }
    if ((lane & 3) == 0) {
      const int ch = b * C + 16 * warp + (lane >> 2);
      atomicAdd(&ssum[ch], s0);
      atomicAdd(&sssq[ch], q0);
      atomicAdd(&ssum[ch + 8], s1);
      atomicAdd(&sssq[ch + 8], q1);
    }
    s0 = q0 = s1 = q1 = 0.0f;
  };
  int cur_b = -1, it = 0;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x, ++it) {
    const int s = it % NS;
    const int b = t / per_sample;
    const int r = t - b * per_sample;
    const int y0 = (r / tiles_x) * TILE_H;
    const int x0 = (r % tiles_x) * TILE_W;
    if (b != cur_b) {
      if (cur_b >= 0) flush(cur_b);
      cur_b = b;
    }
    mbar_wait(ready + 8 * s, (it / NS) & 1);
    tile_products(d, desc_w, in_s + s * BOX_BYTES);
    mbar_arrive(empty + 8 * s);  // this thread is done with the stage

    // statistics from the fp32 accumulators, over the tile's pixels in the
    // image (not the dropped columns 30 and 31, nor past W or H)
    const int wv = min(TILE_W, W - x0);
    const int hv = H - y0;
#pragma unroll
    for (int j = 0; j < TILE_N / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        if ((j >> 2) < hv && 8 * (j & 3) + 2 * (lane & 3) + e < wv) {
          const float v0 = d[4 * j + e];
          const float v1 = d[4 * j + 2 + e];
          s0 += v0;
          q0 += v0 * v0;
          s1 += v1;
          q1 += v1 * v1;
        }
      }
    }
    store_tile(d, out_s, &ymap, tid, b, y0, x0, H);
  }
  if (cur_b >= 0) flush(cur_b);
  if (tid == 0) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// ------------------------------------------------------- bf16 adjoint conv
// A zero-SAME 3x3 64 -> 64 conv without prologue or statistics (the VJP's
// adjoint; header note): the forward kernel's mainloop with no prologue
// warpgroup, the TMA's zero fill being the padding.
constexpr int AD_STAGES = 3;                   // input ring
constexpr int AD_THREADS = WG + 32;            // one consumer warpgroup and a producer warp
// 1 KB of alignment slack, the taps, the ring, the staging, 2 x stages
// mbarriers. wgmma reads up to 2 pixels past a stage: into the next stage
// or the staging area, for the discarded columns only
constexpr int AD_SMEM = 1024 + TAP_BYTES + AD_STAGES * BOX_BYTES + OUT_BYTES + 16 * AD_STAGES;
static_assert(AD_SMEM <= kMaxSmem, "one block per SM");

__global__ void __launch_bounds__(AD_THREADS, 1)
encoder_stage_adjoint_kernel(const __grid_constant__ CUtensorMap gmap,
                             const __grid_constant__ CUtensorMap ymap,
                             const bf16* __restrict__ taps, int B, int H, int W) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;  // the swizzle atom is 1024 bytes
  unsigned char* sm = smem_raw + (base - raw);
  const uint32_t w_s = base;
  const uint32_t in_s = w_s + TAP_BYTES;
  const uint32_t out_s = in_s + AD_STAGES * BOX_BYTES;
  const uint32_t full = out_s + OUT_BYTES;  // full[s] at full + 8 s
  const uint32_t empty = full + 8 * AD_STAGES;
  const int tid = threadIdx.x;
  const int tiles_x = (W + TILE_W - 1) / TILE_W;
  const int per_sample = tiles_x * ((H + TILE_H - 1) / TILE_H);
  const int tiles = B * per_sample;  // < 2^31: checked by the launcher

  // the taps, already in their swizzled order, stay for every tile
  for (int i = tid; i < TAP_BYTES / 16; i += AD_THREADS)
    reinterpret_cast<uint4*>(sm)[i] = reinterpret_cast<const uint4*>(taps)[i];
  if (tid == 0) {
    for (int s = 0; s < AD_STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, WG);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  fence_async_shared();  // the taps' generic stores, before wgmma reads them
  __syncthreads();

  if (tid >= WG) {  // producer: one lane keeps the ring's loads in flight
    if (tid == WG) {
      int it = 0;
      for (int t = blockIdx.x; t < tiles; t += gridDim.x, ++it) {
        const int s = it % AD_STAGES;
        mbar_wait(empty + 8 * s, ((it / AD_STAGES) & 1) ^ 1);
        const int b = t / per_sample;
        const int r = t - b * per_sample;
        mbar_expect_tx(full + 8 * s, BOX_BYTES);
        load_box(in_s + s * BOX_BYTES, &gmap, full + 8 * s, (r % tiles_x) * TILE_W,
                 (r / tiles_x) * TILE_H, b);
      }
    }
    return;
  }

  // consumer warpgroup: 36 wgmma a tile, then the epilogue
  const uint64_t desc_w = wgmma_desc(w_s);
  float d[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) d[i] = 0.0f;
  int it = 0;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x, ++it) {
    const int s = it % AD_STAGES;
    const int b = t / per_sample;
    const int r = t - b * per_sample;
    mbar_wait(full + 8 * s, (it / AD_STAGES) & 1);
    tile_products(d, desc_w, in_s + s * BOX_BYTES);
    mbar_arrive(empty + 8 * s);  // this thread is done with the stage
    store_tile(d, out_s, &ymap, tid, b, (r / tiles_x) * TILE_H, (r % tiles_x) * TILE_W, H);
  }
  if (tid == 0) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// cuTensorMapEncodeTiled, a driver-API function, through the runtime's
// driver entry point (the libraries link no -lcuda)
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t e =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    return (e == cudaSuccess && q == cudaDriverEntryPointSuccess) ? (EncodeTiled)p : nullptr;
  }();
  return fn;
}

// a bf16 (B, H, W, 64) tensor as a 4-d map (C, W, H, B), 128-byte swizzle
int encode_nhwc(CUtensorMap* map, const bf16* p, int B, int H, int W, int box_w, int box_h) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[4] = {(cuuint64_t)C, (cuuint64_t)W, (cuuint64_t)H, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)PIX_BYTES, (cuuint64_t)PIX_BYTES * W,
                                 (cuuint64_t)PIX_BYTES * W * H};
  const cuuint32_t box[4] = {(cuuint32_t)C, (cuuint32_t)box_w, (cuuint32_t)box_h, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<bf16*>(p), dims,
                        strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kEncodeError + (int)r;
}

int sm_count(int* sms) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  return (int)e;
}

bool misaligned(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) != 0; }

template <bool HAS_V>
int launch_fwd(const bf16* u, const float* a1, const float* b1, const bf16* v, const float* a2,
               const float* b2, const bf16* taps, bf16* y, float* ssum, float* sssq, bf16* h,
               int B, int H, int W, int relu_u, cudaStream_t s) {
  if (misaligned(u) || misaligned(y) || misaligned(taps) || (HAS_V && misaligned(v)) ||
      (h != nullptr && misaligned(h)))
    return (int)cudaErrorInvalidValue;
  const long long tiles =
      (long long)B * ((H + TILE_H - 1) / TILE_H) * ((W + TILE_W - 1) / TILE_W);
  if (tiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  CUtensorMap umap, vmap, ymap;
  int e = encode_nhwc(&umap, u, B, H, W, BOX_W, BOX_H);
  if (e == 0) e = HAS_V ? encode_nhwc(&vmap, v, B, H, W, BOX_W, BOX_H) : 0;
  if (e == 0) e = encode_nhwc(&ymap, y, B, H, W, TILE_W, 1);
  if (e != 0) return e;
  if (!HAS_V) vmap = umap;
  static const cudaError_t attr = cudaFuncSetAttribute(
      encoder_stage_fwd_kernel<HAS_V>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      Fwd<HAS_V>::kSmem);
  if (attr != cudaSuccess) return (int)attr;
  int sms = 0;
  if ((e = sm_count(&sms)) != 0) return e;
  const int grid = (int)(tiles < sms ? tiles : sms);
  encoder_stage_fwd_kernel<HAS_V><<<grid, Fwd<HAS_V>::kThreads, Fwd<HAS_V>::kSmem, s>>>(
      umap, vmap, ymap, taps, a1, b1, a2, b2, ssum, sssq, h, B, H, W, relu_u);
  return (int)cudaGetLastError();
}

int launch_adjoint(const bf16* g, const bf16* taps, bf16* y, int B, int H, int W,
                   cudaStream_t s) {
  if (B < 1 || H < 1 || W < 1 || misaligned(g) || misaligned(y) || misaligned(taps))
    return (int)cudaErrorInvalidValue;
  const long long tiles =
      (long long)B * ((H + TILE_H - 1) / TILE_H) * ((W + TILE_W - 1) / TILE_W);
  if (tiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  CUtensorMap gmap, ymap;
  int e = encode_nhwc(&gmap, g, B, H, W, BOX_W, BOX_H);
  if (e == 0) e = encode_nhwc(&ymap, y, B, H, W, TILE_W, 1);
  if (e != 0) return e;
  static const cudaError_t attr = cudaFuncSetAttribute(
      encoder_stage_adjoint_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, AD_SMEM);
  if (attr != cudaSuccess) return (int)attr;
  int sms = 0;
  if ((e = sm_count(&sms)) != 0) return e;
  const int grid = (int)(tiles < sms ? tiles : sms);
  encoder_stage_adjoint_kernel<<<grid, AD_THREADS, AD_SMEM, s>>>(gmap, ymap, taps, B, H, W);
  return (int)cudaGetLastError();
}

}  // namespace

// u, v, y, h: (B, H, W, 64) contiguous, fp32 or bf16 (is_bf16); v and h may
// be null. a*, b*: (B, 64) fp32. w: in fp32 the (3, 3, 64, 64) HWIO taps;
// in bf16 the taps as ops/cuda/encoder_conv.py::_pack_taps lays them out
// (per tap, output-channel rows of 64 input channels, 16-byte chunks
// swizzled as the shared memory they are copied to), and u, v, y, h 16-byte
// aligned. ssum, sssq: (B, 64) fp32, zeroed by the caller; null for both
// skips the statistics, which only the fp32 kernel does (the fp32 VJP's
// adjoint conv; the bf16 one is encoder_stage_adjoint_launch). Launches on
// `stream` and returns 0, a CUDA error code, or kEncodeError + the CUresult
// of a failed tensor-map encode.
extern "C" int encoder_stage_launch(const void* u, const float* a1, const float* b1,
                                    const void* v, const float* a2, const float* b2,
                                    const void* w, void* y, float* ssum, float* sssq, void* h,
                                    int B, int H, int W, int channels, int relu_u, int is_bf16,
                                    void* stream) {
  const bool stats = ssum != nullptr;
  if (channels != C || B < 1 || B > 65535 || H < 1 || W < 1 || stats != (sssq != nullptr) ||
      (!stats && (v != nullptr || is_bf16)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    const bf16* ub = static_cast<const bf16*>(u);
    const bf16* vb = static_cast<const bf16*>(v);
    const bf16* wb = static_cast<const bf16*>(w);
    bf16* yb = static_cast<bf16*>(y);
    bf16* hb = static_cast<bf16*>(h);
    return v != nullptr ? launch_fwd<true>(ub, a1, b1, vb, a2, b2, wb, yb, ssum, sssq, hb, B, H,
                                           W, relu_u, s)
                        : launch_fwd<false>(ub, a1, b1, vb, a2, b2, wb, yb, ssum, sssq, hb, B, H,
                                            W, relu_u, s);
  }
  const dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH, B);
  const float* uf = static_cast<const float*>(u);
  const float* vf = static_cast<const float*>(v);
  const float* wf = static_cast<const float*>(w);
  if (stats)
    encoder_stage_f32_kernel<true><<<grid, NT, 0, s>>>(uf, a1, b1, vf, a2, b2, wf,
                                                       static_cast<float*>(y), ssum, sssq,
                                                       static_cast<float*>(h), H, W, relu_u);
  else
    encoder_stage_f32_kernel<false><<<grid, NT, 0, s>>>(uf, a1, b1, vf, a2, b2, wf,
                                                        static_cast<float*>(y), ssum, sssq,
                                                        static_cast<float*>(h), H, W, relu_u);
  return (int)cudaGetLastError();
}

// Dynamic shared memory of a bf16 forward block without and with v.
extern "C" int encoder_stage_fwd_smem_bytes(int has_v) {
  return has_v ? Fwd<true>::kSmem : Fwd<false>::kSmem;
}

// The bf16 adjoint conv: y = conv3x3(g, taps), zero SAME padding, no bias.
// g, y: (B, H, W, 64) bf16, contiguous, 16-byte aligned. taps: the 9 x 64 x
// 64 adjoint taps as ops/cuda/encoder_conv.py::_pack_taps(adjoint=True) lays
// them out. Launches on `stream`; returns 0, a CUDA error code, or
// kEncodeError + the CUresult of a failed tensor-map encode.
extern "C" int encoder_stage_adjoint_launch(const void* g, const void* taps, void* y, int B,
                                            int H, int W, void* stream) {
  return launch_adjoint(static_cast<const bf16*>(g), static_cast<const bf16*>(taps),
                        static_cast<bf16*>(y), B, H, W, static_cast<cudaStream_t>(stream));
}
