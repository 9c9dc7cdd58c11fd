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
// encoder_stage_adjoint_kernel below; in fp32 (parity runs) it is the fp32
// kernel with the identity affine and null statistics pointers.
//
// What bounds it on the H100: at (2, 736, 1280, 64) bf16 one stage moves
// 0.48 GB (u in, y out; 0.96 GB with v and h) and does 139 GFLOP of
// multiply-adds: ~0.14 ms of memory traffic, ~0.14 ms of tensor-core time.
//
// Design. The TPU kernel packs column pairs into 128 lanes (w2d) and carries
// a row halo across its sequential grid; neither is needed here: each block
// owns an output tile of one sample and all 64 output channels, loads its
// halo'd input tile into shared memory once, applying the affine/ReLU
// prologue and the image-border zeros on the way in, and needs nothing from
// any other block. Statistics are reduced over the block (warp shuffles or
// per-lane sums, then shared-memory atomics) and added, one value per
// channel, to zero-initialised (B, 64) buffers with global fp32 atomics:
// blocks run in no order, so no sum is carried from one block to the next.
//
//  - bf16 (the inference path): the conv is an implicit GEMM on the tensor
//    cores (ldmatrix + mma.sync m16n8k16, bf16 -> fp32). Blocks are
//    persistent: two per SM, each loads the 3x3x64x64 weights into shared
//    memory once and then walks over 8 x 16 output tiles. Per tile its
//    4 warps each own two output rows (16 pixels each) x 64 channels in 16
//    accumulator fragments; for each of the 9 taps and 4 chunks of 16 input
//    channels a warp loads 4 weight fragments and reuses each for both rows.
//    The prologue issues all of a thread's 16-byte loads of the halo'd tile
//    before it transforms any. Pixels and weight rows are 144 bytes apart in
//    shared memory, so the 8 rows of every ldmatrix phase fall on distinct
//    banks; 109 KB of shared memory per block. The epilogue takes the
//    statistics from the fp32 fragments (warp shuffles over the pixels),
//    stages y as bf16 in the freed input tile and writes it as coalesced
//    16-byte vectors.
//  - fp32 (parity runs): the same function on the fp32 CUDA cores. An
//    8 x 32 tile streams the input through shared memory in chunks of 8
//    channels; each thread accumulates 8 pixels x 8 channels in registers,
//    reusing every input value for the 3 horizontal taps.
//
// The bf16 adjoint conv (encoder_stage_adjoint_kernel) is exactly a
// zero-SAME 3x3 64 -> 64 conv with no bias, ReLU or statistics: cuDNN's
// dgrad. At the training shape (16, 320, 720, 64) it moves 943.8 MB (g in,
// g_h out) and does 271.8 GFLOP: 0.2817 ms of memory traffic and 0.275 ms
// of tensor-core time, so it must overlap loads with products and run the
// products near the wgmma rate at once. Run through the forward kernel
// above (ldmatrix + mma.sync; global load, barrier, products, barrier,
// epilogue per tile; an identity prologue; 2 blocks of 4 warps an SM) it
// took 0.94 ms against cuDNN's 0.59. Its design:
//  - Products through wgmma.mma_async m64n256k16, both operands read from
//    shared memory by descriptor, fp32 accumulators in registers: the 64
//    output channels on M (A = the taps, one 64 x 64 block a tap, rows of
//    64 input channels), 256 pixels on N (B = the input tile, pixel rows of
//    64 channels). Per instruction that is 2 KB of A and 8 KB of B for
//    524 kFLOP, 80 bytes a clock at the tensor cores' rate, within shared
//    memory's 128. Pixels on M (m64n64k16, A through ldmatrix) would need
//    the full 128 bytes a clock: rejected.
//  - The tap shift is a byte offset of B's start: the tile's input box is
//    10 rows of 32 pixels, so a row pitch of 32 pixels makes output pixel
//    n = 32 r + c and tap (dy, dx) read box pixel n + 32 dy + dx. Each tile
//    is 8 rows x 30 columns; its columns 30 and 31 are computed and dropped
//    (6 % of the products). Swizzling is a function of the shared-memory
//    address (TMA's write and wgmma's read alike), so a start 128 bytes
//    into a 1024-byte atom needs no base offset.
//  - Input through TMA: one cp.async.bulk.tensor.4d a tile over the map
//    (C = 64, W, H, B) with a (64, 32, 10, 1) box and the 128-byte swizzle
//    (64 bf16 channels are one 128-byte row), into a ring of 3 stages
//    completed by mbarriers. The box starts at (x0 - 1, y0 - 1) and TMA
//    fills what lies outside the sample with zeros: that is the SAME
//    padding, with no border code, and a box never reads the next sample.
//  - Persistent blocks, one an SM (225 KB of shared memory): a producer
//    warp keeps the next tiles' loads in flight while one consumer
//    warpgroup runs the 36 products of a tile. The 72 KB of taps are copied
//    once a block, already in the swizzled order the descriptors read
//    (laid out by the host).
//  - Epilogue: the fp32 accumulators are rounded to bf16 and written
//    pixel-major by stmatrix.trans into a 32 KB staging area, in the
//    swizzle a TMA store reads; one thread stores each of the tile's 8 rows
//    (a (64, 30, 1, 1) box; TMA clips the ragged right and bottom edges)
//    and the stores drain while the next tile is multiplied.
//  - No affine, no ReLU, no statistics and no v: the launch passes none.
// On the H100 it takes 0.456 ms a launch at the training shape, cuDNN's
// dgrad 0.594 (chip_smoke.py phase 7, PERF.md). Splitting each tile into
// two halves of 128 columns with accumulators of their own, so that one
// half's epilogue overlaps the other half's products, was slower there and
// needed more registers: rejected.

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
constexpr int TC_TH = 8;             // output rows per tile
constexpr int TC_TW = 16;            // output columns per tile: one fragment's rows
constexpr int TC_WARPS = TC_TH / 2;  // two output rows per warp
constexpr int TC_NT = 32 * TC_WARPS;
constexpr int TC_IH = TC_TH + 2;
constexpr int TC_IW = TC_TW + 2;
constexpr int PS = 72;  // bf16 per pixel and per weight row in shared memory (144 B)
constexpr int TC_IN_ELEMS = TC_IH * TC_IW * PS;
constexpr int TC_W_ELEMS = 9 * C * PS;
constexpr int TC_SMEM = (TC_IN_ELEMS + TC_W_ELEMS) * 2;
constexpr int TC_VECS = TC_IH * TC_IW * (C / 8);            // 16-byte vectors per input tile
constexpr int TC_LOADS = (TC_VECS + TC_NT - 1) / TC_NT;     // of them per thread
static_assert(TC_WARPS * 2 * TC_TW * PS <= TC_IN_ELEMS, "epilogue staging must fit the input tile");

union Pack8 {  // eight bf16 channels, one 16-byte load or store
  uint4 q;
  __nv_bfloat162 h2[4];
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// four 8x8 bf16 matrices; lane l gives the address of row l % 8 of matrix l / 8
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// d += a (16x16, row major) * b (16x8, column major), fp32 accumulators
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <bool HAS_V>
__global__ void __launch_bounds__(TC_NT, 2)
encoder_stage_bf16_kernel(const bf16* __restrict__ u, const float* __restrict__ a1,
                          const float* __restrict__ b1, const bf16* __restrict__ v,
                          const float* __restrict__ a2, const float* __restrict__ b2,
                          const bf16* __restrict__ w, bf16* __restrict__ y,
                          float* __restrict__ ssum, float* __restrict__ sssq,
                          bf16* __restrict__ hout, int B, int H, int W, int relu_u) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* in_s = reinterpret_cast<bf16*>(smem);
  bf16* w_s = in_s + TC_IN_ELEMS;
  __shared__ float aff[4][C];  // a1, b1, a2, b2 of the current sample
  __shared__ float red_sum[C];
  __shared__ float red_ssq[C];

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int tiles_x = (W + TC_TW - 1) / TC_TW;
  const int tiles = tiles_x * ((H + TC_TH - 1) / TC_TH);  // per sample
  // ldmatrix rows: pixels of an A fragment, input channels of a B fragment
  const int lm_row = (lane & 7) + ((lane >> 3) & 1) * 8;
  const int lm_col = (lane >> 4) * 8;
  const int g = lane >> 2;  // accumulator fragment: pixels g, g + 8
  const int cq = lane & 3;  // and channels 2cq, 2cq + 1 of each 8
  const uint32_t in_base = smem_addr(in_s);
  const uint32_t w_base = smem_addr(w_s);

  // weights (tap, ci) -> 9*64 rows of 64 co, once for all of this block's tiles
  for (int i = tid; i < 9 * C * (C / 8); i += TC_NT) {
    const int row = i >> 3;
    const int c8 = (i & 7) * 8;
    *reinterpret_cast<uint4*>(w_s + row * PS + c8) =
        *reinterpret_cast<const uint4*>(w + (size_t)row * C + c8);
  }

  int cur_b = -1;
  for (int t = blockIdx.x; t < B * tiles; t += gridDim.x) {
    const int b = t / tiles;
    const int ty0 = ((t - b * tiles) / tiles_x) * TC_TH;
    const int tx0 = ((t - b * tiles) % tiles_x) * TC_TW;
    const size_t base = (size_t)b * H * W * C;
    if (b != cur_b) {  // tiles go in sample order: flush the last sample's statistics
      if (tid < C) {
        if (cur_b >= 0) {
          atomicAdd(&ssum[cur_b * C + tid], red_sum[tid]);
          atomicAdd(&sssq[cur_b * C + tid], red_ssq[tid]);
        }
        red_sum[tid] = 0.0f;
        red_ssq[tid] = 0.0f;
        aff[0][tid] = a1[b * C + tid];
        aff[1][tid] = b1[b * C + tid];
        if constexpr (HAS_V) {
          aff[2][tid] = a2[b * C + tid];
          aff[3][tid] = b2[b * C + tid];
        }
      }
      __syncthreads();
      cur_b = b;
    }

    // halo'd input tile through the prologue: all loads first, then transform
    Pack8 uq[TC_LOADS], vq[HAS_V ? TC_LOADS : 1];
#pragma unroll
    for (int k = 0; k < TC_LOADS; ++k) {
      const int i = tid + k * TC_NT;
      const int p = i >> 3;
      const int gy = ty0 + p / TC_IW - 1;
      const int gx = tx0 + p % TC_IW - 1;
      uq[k].q = make_uint4(0u, 0u, 0u, 0u);
      if constexpr (HAS_V) vq[k].q = make_uint4(0u, 0u, 0u, 0u);
      if (i < TC_VECS && gy >= 0 && gy < H && gx >= 0 && gx < W) {
        const size_t off = base + ((size_t)gy * W + gx) * C + (i & 7) * 8;
        uq[k].q = *reinterpret_cast<const uint4*>(u + off);
        if constexpr (HAS_V) vq[k].q = *reinterpret_cast<const uint4*>(v + off);
      }
    }
#pragma unroll
    for (int k = 0; k < TC_LOADS; ++k) {
      const int i = tid + k * TC_NT;
      if (i < TC_VECS) {
        const int p = i >> 3;
        const int c8 = (i & 7) * 8;
        const int row = p / TC_IW;
        const int col = p % TC_IW;
        const int gy = ty0 + row - 1;
        const int gx = tx0 + col - 1;
        Pack8 hq;
        hq.q = make_uint4(0u, 0u, 0u, 0u);  // outside the image: SAME padding zeros
        if (gy >= 0 && gy < H && gx >= 0 && gx < W) {
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int c = c8 + 2 * j;
            const float2 uf = __bfloat1622float2(uq[k].h2[j]);
            float h0 = uf.x * aff[0][c] + aff[1][c];
            float h1 = uf.y * aff[0][c + 1] + aff[1][c + 1];
            if (relu_u) {
              h0 = fmaxf(h0, 0.0f);
              h1 = fmaxf(h1, 0.0f);
            }
            if constexpr (HAS_V) {
              const float2 vf = __bfloat1622float2(vq[k].h2[j]);
              h0 = fmaxf(h0 + fmaxf(vf.x * aff[2][c] + aff[3][c], 0.0f), 0.0f);
              h1 = fmaxf(h1 + fmaxf(vf.y * aff[2][c + 1] + aff[3][c + 1], 0.0f), 0.0f);
            }
            hq.h2[j] = __floats2bfloat162_rn(h0, h1);
          }
          // each image pixel is the interior of exactly one tile
          if (hout != nullptr && row >= 1 && row <= TC_TH && col >= 1 && col <= TC_TW)
            *reinterpret_cast<uint4*>(hout + base + ((size_t)gy * W + gx) * C + c8) = hq.q;
        }
        *reinterpret_cast<uint4*>(in_s + p * PS + c8) = hq.q;
      }
    }
    __syncthreads();

    // implicit GEMM: out[row][px][co] += in[row+dy][px+dx][ci] * w[dy][dx][ci][co]
    float acc[2][8][4];
#pragma unroll
    for (int rr = 0; rr < 2; ++rr)
#pragma unroll
      for (int nb = 0; nb < 8; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[rr][nb][e] = 0.0f;
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int dy = tap / 3;
      const int dx = tap % 3;
#pragma unroll
      for (int kc = 0; kc < C / 16; ++kc) {
        uint32_t bf[4][4];  // bf[j]: channels 16j..16j+7 (regs 0, 1) and 16j+8.. (regs 2, 3)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          ldsm_x4_trans(bf[j], w_base + 2 * ((tap * C + kc * 16 + lm_row) * PS + j * 16 + lm_col));
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          uint32_t af[4];
          const int row = 2 * warp + rr + dy;
          ldsm_x4(af, in_base + 2 * ((row * TC_IW + lm_row + dx) * PS + kc * 16 + lm_col));
#pragma unroll
          for (int nb = 0; nb < 8; ++nb)
            mma_bf16(acc[rr][nb], af, bf[nb >> 1][(nb & 1) * 2], bf[nb >> 1][(nb & 1) * 2 + 1]);
        }
      }
    }
    __syncthreads();  // every warp is done with the input tile: stage y there

    // epilogue: statistics from the fp32 fragments, y through shared memory
    bf16* st = in_s + warp * (2 * TC_TW) * PS;
    float s[8][2], q[8][2];
#pragma unroll
    for (int nb = 0; nb < 8; ++nb) s[nb][0] = s[nb][1] = q[nb][0] = q[nb][1] = 0.0f;
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const bool row_ok = ty0 + 2 * warp + rr < H;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int px = g + 8 * half;
        const bool ok = row_ok && tx0 + px < W;
#pragma unroll
        for (int nb = 0; nb < 8; ++nb) {
          const float y0 = acc[rr][nb][2 * half];
          const float y1 = acc[rr][nb][2 * half + 1];
          *reinterpret_cast<__nv_bfloat162*>(st + (rr * TC_TW + px) * PS + nb * 8 + 2 * cq) =
              __floats2bfloat162_rn(y0, y1);
          if (ok) {
            s[nb][0] += y0;
            s[nb][1] += y1;
            q[nb][0] += y0 * y0;
            q[nb][1] += y1 * y1;
          }
        }
      }
    }
    {
      // lanes with the same cq hold the same channels: fold the eight pixels g
#pragma unroll
      for (int nb = 0; nb < 8; ++nb)
#pragma unroll
        for (int e = 0; e < 2; ++e)
#pragma unroll
          for (int m = 4; m < 32; m <<= 1) {
            s[nb][e] += __shfl_xor_sync(0xffffffffu, s[nb][e], m);
            q[nb][e] += __shfl_xor_sync(0xffffffffu, q[nb][e], m);
          }
      if (lane < 4) {
#pragma unroll
        for (int nb = 0; nb < 8; ++nb)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            atomicAdd(&red_sum[nb * 8 + 2 * lane + e], s[nb][e]);
            atomicAdd(&red_ssq[nb * 8 + 2 * lane + e], q[nb][e]);
          }
      }
    }
    __syncwarp();
    // 32 pixels x 8 vectors of 16 bytes, eight lanes per pixel
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int idx = lane + 32 * k;
      const int p = idx >> 3;
      const int c8 = (idx & 7) * 8;
      const int gy = ty0 + 2 * warp + p / TC_TW;
      const int gx = tx0 + p % TC_TW;
      if (gy < H && gx < W)
        *reinterpret_cast<uint4*>(y + base + ((size_t)gy * W + gx) * C + c8) =
            *reinterpret_cast<const uint4*>(st + p * PS + c8);
    }
    __syncthreads();  // the staging area is the next tile's input tile
  }
  if (cur_b >= 0 && tid < C) {
    atomicAdd(&ssum[cur_b * C + tid], red_sum[tid]);
    atomicAdd(&sssq[cur_b * C + tid], red_ssq[tid]);
  }
}

template <bool HAS_V>
int launch_bf16(const bf16* u, const float* a1, const float* b1, const bf16* v, const float* a2,
                const float* b2, const bf16* w, bf16* y, float* ssum, float* sssq, bf16* h, int B,
                int H, int W, int relu_u, cudaStream_t s) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      encoder_stage_bf16_kernel<HAS_V>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      TC_SMEM);
  if (attr != cudaSuccess) return (int)attr;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, encoder_stage_bf16_kernel<HAS_V>, TC_NT, TC_SMEM);
  if (e != cudaSuccess) return (int)e;
  const long long tiles =
      (long long)B * ((H + TC_TH - 1) / TC_TH) * ((W + TC_TW - 1) / TC_TW);
  if (tiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const int grid = (int)(tiles < (long long)sms * per_sm ? tiles : (long long)sms * per_sm);
  if (grid < 1) return (int)cudaErrorInvalidConfiguration;
  encoder_stage_bf16_kernel<HAS_V><<<grid, TC_NT, TC_SMEM, s>>>(
      u, a1, b1, v, a2, b2, w, y, ssum, sssq, h, B, H, W, relu_u);
  return (int)cudaGetLastError();
}

// ------------------------------------------------------- bf16 adjoint conv
// A zero-SAME 3x3 64 -> 64 conv without prologue or statistics (the VJP's
// adjoint; header note). Tile: 8 output rows x 30 columns of one sample. Its
// input box, 10 rows x 32 columns x 64 channels from (x0 - 1, y0 - 1), lands
// by TMA as 320 pixel rows of 128 bytes, so the wgmma column n = 32 r + c
// (c = 0..31, the last two columns of each row wasted) of tap (dy, dx) reads
// box pixel n + 32 dy + dx: each tap is one constant byte offset of B's
// start, and N = 256 columns are the tile's 8 rows.
constexpr int AD_TH = 8;                       // output rows per tile
constexpr int AD_TW = 30;                      // output columns per tile
constexpr int AD_BW = AD_TW + 2;               // box columns: the row pitch in pixels
constexpr int AD_BH = AD_TH + 2;               // box rows
constexpr int AD_N = AD_TH * AD_BW;            // 256: wgmma N
constexpr int AD_PIX = C * 2;                  // 128 bytes a pixel: one 128-byte swizzle row
constexpr int AD_STAGES = 3;                   // input ring
constexpr int AD_STAGE_BYTES = AD_BH * AD_BW * AD_PIX;  // 40 KB
constexpr int AD_W_BYTES = 9 * C * AD_PIX;     // 72 KB of taps
constexpr int AD_OUT_BYTES = AD_N * AD_PIX;    // 32 KB of output staging
constexpr int AD_CONSUMERS = 128;              // one warpgroup
constexpr int AD_THREADS = AD_CONSUMERS + 32;  // and one producer warp
// 1 KB of alignment slack, the taps, the ring, the staging, 2 x stages
// mbarriers. wgmma reads up to 2 pixels past a stage: into the next stage
// or the staging area, for the discarded columns only
constexpr int AD_SMEM =
    1024 + AD_W_BYTES + AD_STAGES * AD_STAGE_BYTES + AD_OUT_BYTES + 16 * AD_STAGES;
constexpr int kEncodeError = 100000;
static_assert(AD_N == 256, "one m64n256k16 per tap and 16 input channels");
static_assert(AD_SMEM <= 232448, "one block per SM");

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

__device__ __forceinline__ void named_sync_consumers() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(AD_CONSUMERS) : "memory");
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

__global__ void __launch_bounds__(AD_THREADS, 1)
encoder_stage_adjoint_kernel(const __grid_constant__ CUtensorMap gmap,
                             const __grid_constant__ CUtensorMap ymap,
                             const bf16* __restrict__ taps, int B, int H, int W) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;  // the swizzle atom is 1024 bytes
  unsigned char* sm = smem_raw + (base - raw);
  const uint32_t w_s = base;
  const uint32_t in_s = w_s + AD_W_BYTES;
  const uint32_t out_s = in_s + AD_STAGES * AD_STAGE_BYTES;
  const uint32_t full = out_s + AD_OUT_BYTES;  // full[s] at full + 8 s
  const uint32_t empty = full + 8 * AD_STAGES;
  const int tid = threadIdx.x;
  const int tiles_x = (W + AD_TW - 1) / AD_TW;
  const int per_sample = tiles_x * ((H + AD_TH - 1) / AD_TH);
  const int tiles = B * per_sample;  // < 2^31: checked by the launcher

  // the taps, already in their swizzled order, stay for every tile
  for (int i = tid; i < AD_W_BYTES / 16; i += AD_THREADS)
    reinterpret_cast<uint4*>(sm)[i] = reinterpret_cast<const uint4*>(taps)[i];
  if (tid == 0) {
    for (int s = 0; s < AD_STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, AD_CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  fence_async_shared();  // the taps' generic stores, before wgmma reads them
  __syncthreads();

  if (tid >= AD_CONSUMERS) {  // producer: one lane keeps the ring's loads in flight
    if (tid == AD_CONSUMERS) {
      const uint64_t map = reinterpret_cast<uint64_t>(&gmap);
      int it = 0;
      for (int t = blockIdx.x; t < tiles; t += gridDim.x, ++it) {
        const int s = it % AD_STAGES;
        mbar_wait(empty + 8 * s, ((it / AD_STAGES) & 1) ^ 1);
        const int b = t / per_sample;
        const int r = t - b * per_sample;
        const int y0 = (r / tiles_x) * AD_TH;
        const int x0 = (r % tiles_x) * AD_TW;
        mbar_expect_tx(full + 8 * s, AD_STAGE_BYTES);
        // the box starts at (x0 - 1, y0 - 1); TMA fills what lies outside
        // the sample with zeros: the SAME padding
        asm volatile(
            "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::complete_tx::bytes "
            "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(in_s + s * AD_STAGE_BYTES),
            "l"(map), "r"(full + 8 * s), "r"(0), "r"(x0 - 1), "r"(y0 - 1), "r"(b)
            : "memory");
      }
    }
    return;
  }

  // consumer warpgroup: 36 wgmma a tile, then the epilogue
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const uint64_t ymap_addr = reinterpret_cast<uint64_t>(&ymap);
  const uint64_t desc_w = wgmma_desc(w_s);
  float d[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) d[i] = 0.0f;
  // stmatrix: lane l gives row l % 8 of matrix l / 8 = (channel half
  // m & 1, pixel block m >> 1); rows are pixels, 8 channels of 16 bytes each
  const int sm_m = lane >> 3;
  const int sm_row = lane & 7;
  const uint32_t sm_chunk = (uint32_t)(((2 * warp + (sm_m & 1)) ^ sm_row) << 4);
  int it = 0;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x, ++it) {
    const int s = it % AD_STAGES;
    const int b = t / per_sample;
    const int r = t - b * per_sample;
    const int y0 = (r / tiles_x) * AD_TH;
    const int x0 = (r % tiles_x) * AD_TW;
    mbar_wait(full + 8 * s, (it / AD_STAGES) & 1);
    const uint64_t desc_in = wgmma_desc(in_s + s * AD_STAGE_BYTES);
    acc_fence(d);
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int tap = 0; tap < 9; ++tap)
#pragma unroll
      for (int kc = 0; kc < C / 16; ++kc)
        wgmma_256(d, desc_w + ((tap * C * AD_PIX + kc * 32) >> 4),
                  desc_in + ((((tap / 3) * AD_BW + tap % 3) * AD_PIX + kc * 32) >> 4), tap | kc);
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    acc_fence(d);
    mbar_arrive(empty + 8 * s);  // this thread is done with the stage

    // epilogue: d[4j + 2i + e] is (channel 16 warp + 8 i + lane / 4, pixel
    // 8 j + 2 (lane % 4) + e); stmatrix.trans writes it pixel-major, bf16,
    // in the 128-byte swizzle the TMA store reads
    if (tid == 0) asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
    named_sync_consumers();  // the last tile's stores have read the staging
#pragma unroll
    for (int j = 0; j < AD_N / 8; j += 2) {
      const uint32_t px = (uint32_t)(8 * (j + (sm_m >> 1)) + sm_row);
      stsm_x4_trans(out_s + px * AD_PIX + sm_chunk, pack_bf16(d[4 * j], d[4 * j + 1]),
                    pack_bf16(d[4 * j + 2], d[4 * j + 3]), pack_bf16(d[4 * j + 4], d[4 * j + 5]),
                    pack_bf16(d[4 * j + 6], d[4 * j + 7]));
    }
    fence_async_shared();
    named_sync_consumers();
    if (tid == 0) {
      // one store a row of 30 pixels; TMA clips the ragged right and bottom
#pragma unroll 1
      for (int row = 0; row < AD_TH && y0 + row < H; ++row)
        asm volatile(
            "cp.async.bulk.tensor.4d.global.shared::cta.tile.bulk_group [%0, {%2, %3, %4, %5}], "
            "[%1];\n" ::"l"(ymap_addr),
            "r"(out_s + row * AD_BW * AD_PIX), "r"(0), "r"(x0), "r"(y0 + row), "r"(b)
            : "memory");
      asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    }
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
  const cuuint64_t strides[3] = {(cuuint64_t)AD_PIX, (cuuint64_t)AD_PIX * W,
                                 (cuuint64_t)AD_PIX * W * H};
  const cuuint32_t box[4] = {(cuuint32_t)C, (cuuint32_t)box_w, (cuuint32_t)box_h, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<bf16*>(p), dims,
                        strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kEncodeError + (int)r;
}

int launch_adjoint(const bf16* g, const bf16* taps, bf16* y, int B, int H, int W,
                   cudaStream_t s) {
  if (B < 1 || H < 1 || W < 1 || ((reinterpret_cast<uintptr_t>(g) |
                                   reinterpret_cast<uintptr_t>(y) |
                                   reinterpret_cast<uintptr_t>(taps)) & 15) != 0)
    return (int)cudaErrorInvalidValue;
  const long long tiles =
      (long long)B * ((H + AD_TH - 1) / AD_TH) * ((W + AD_TW - 1) / AD_TW);
  if (tiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  CUtensorMap gmap, ymap;
  int e = encode_nhwc(&gmap, g, B, H, W, AD_BW, AD_BH);
  if (e == 0) e = encode_nhwc(&ymap, y, B, H, W, AD_TW, 1);
  if (e != 0) return e;
  static const cudaError_t attr = cudaFuncSetAttribute(
      encoder_stage_adjoint_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, AD_SMEM);
  if (attr != cudaSuccess) return (int)attr;
  int dev = 0, sms = 0;
  cudaError_t ce = cudaGetDevice(&dev);
  if (ce == cudaSuccess) ce = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (ce != cudaSuccess) return (int)ce;
  const int grid = (int)(tiles < sms ? tiles : sms);
  encoder_stage_adjoint_kernel<<<grid, AD_THREADS, AD_SMEM, s>>>(gmap, ymap, taps, B, H, W);
  return (int)cudaGetLastError();
}

}  // namespace

// u, v, y, h: (B, H, W, 64) contiguous, fp32 or bf16 (is_bf16); v and h may
// be null. a*, b*: (B, 64) fp32. w: (3, 3, 64, 64) HWIO in the activation
// dtype. ssum, sssq: (B, 64) fp32, zeroed by the caller; null for both
// skips the statistics, which only the fp32 kernel does (the fp32 VJP's
// adjoint conv; the bf16 one is encoder_stage_adjoint_launch). Launches on
// `stream` and returns cudaGetLastError() (0 = ok).
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
    return v != nullptr ? launch_bf16<true>(ub, a1, b1, vb, a2, b2, wb, yb, ssum, sssq, hb, B, H,
                                            W, relu_u, s)
                        : launch_bf16<false>(ub, a1, b1, vb, a2, b2, wb, yb, ssum, sssq, hb, B,
                                             H, W, relu_u, s);
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

// The bf16 adjoint conv: y = conv3x3(g, taps), zero SAME padding, no bias.
// g, y: (B, H, W, 64) bf16, contiguous, 16-byte aligned. taps: the 9 x 64 x
// 64 adjoint taps as ops/cuda/encoder_conv.py::_pack_adjoint_taps lays them
// out (per tap, output-channel rows of 64 input channels, 16-byte chunks
// swizzled as the shared memory they are copied to). Launches on `stream`;
// returns 0, a CUDA error code, or kEncodeError + the CUresult of a failed
// tensor-map encode.
extern "C" int encoder_stage_adjoint_launch(const void* g, const void* taps, void* y, int B,
                                            int H, int W, void* stream) {
  return launch_adjoint(static_cast<const bf16*>(g), static_cast<const bf16*>(taps),
                        static_cast<bf16*>(y), B, H, W, static_cast<cudaStream_t>(stream));
}
