// Backward of the bilinear border-padded warp (csrc/warp.cu), channels-major.
// Given the output cotangent g (N, C, Ho, Wo) and the sample coordinates
// (N, Ho, Wo), it scatters g * (corner weight) into the source cotangent
// grad_src (N, C, H, W), and optionally writes the coordinate cotangents
// grad_x / grad_y (N, Ho, Wo).
//
// Replaces the TPU kernels warp_bilinear_grad_chw
// (mine_tpu/ops/pallas/warp.py:741, body _warp_grad_kernel / _scatter_tile)
// and warp_bilinear_grad_chw_banded (:585), and with them the rest of the
// custom_vjp backward in mine_tpu/ops/grid_sample.py::_pallas_bwd: the
// save_corners forward pass that re-gathers the four corners (:140-143) and
// the jnp elementwise coordinate cotangent (:152-162). Mosaic has no scatter,
// so the TPU kernel turns it into one-hot MXU matmuls into a VMEM-resident
// tile of the source, written once; here the same locality comes from a tile
// of the source in shared memory, and device memory has no VMEM ceiling, so
// one kernel serves both source sizes.
//
// Bound: memory. Per output pixel the kernel reads two coordinates and C
// cotangent values, and grad_src is written (zero-filled by the caller, then
// added into); in the coordinate mode it also reads the four corners of src
// per channel and writes two floats. Scattered straight into device memory,
// that is 4C fp32 atomics per output pixel (400 M at the training path's
// (128, 4, 384, 512)), and L2's atomic units, not the bytes, set the time.
//
// Design: one block owns one 64x4 tile of output pixels of one plane, all C
// channels. Each thread computes its tap once with mine::prep_coords (so the
// border convention is the forward's, bit for bit), and the block reduces the
// bounding box of its threads' valid corners (warp shuffles, then shared
// memory; the -1 corner of a size-1 axis is masked and not counted). Then,
// decided per block from its data:
//   * shared path, when the box's C planes fit kTileBytes: the block zeroes a
//     [C][bh][bw] tile in shared memory, adds its 4C contributions a pixel
//     with shared-memory atomics, and flushes the tile to grad_src with one
//     global atomic per nonzero element, a warp per row on consecutive
//     addresses (neighbouring tiles' footprints overlap, so the flush stays
//     atomic). For the smooth homographies of an MPI a tile's box is about
//     65x5, so the global atomics drop from 16 to about 5 per output pixel,
//     all coalesced. sm_90 has no shared-memory float add: each shared atomic
//     is a CAS loop (ATOMS.CAST.SPIN), and those loops, not the global flush,
//     are the path's largest cost on an H100 (mine_tpu_torch/kernel_variants.py
//     times the path without each);
//   * direct path, otherwise (strong minification, a tile straddling a clamp
//     edge or scattered coordinates): the 4C global atomics a pixel.
// Both paths are this kernel; each block adds one to its path's count in
// `path_blocks` (when given), so a caller sees how its data split. The
// coordinate cotangent reads the corners with __ldg and sums over C in
// registers on either path, so nothing of the (N, 4, C, Ho, Wo) corner
// residuals is ever stored. Atomics add in a different order on every run:
// grad_src is reproducible to rounding only.
#include <climits>

#include "warp_common.cuh"

namespace {

constexpr int kTileW = 64, kTileH = 4;  // a warp is half a tile row
constexpr int kThreads = kTileW * kTileH;
constexpr int kWarps = kThreads / 32;
// One block's shared-memory source tile: at 24 KB eight 256-thread blocks
// (the SM's 2048 threads) fit in the SM's 228 KB, and a 64x4 output tile
// minified up to about 2x still fits at C = 4. Under 48 KB, so no opt-in.
constexpr int kTileBytes = 24 * 1024;
constexpr int kTileFloats = kTileBytes / 4;

template <bool kCoords>
__global__ void __launch_bounds__(kThreads)
    warp_bilinear_grad_kernel(const float* __restrict__ g, const float* __restrict__ coords_x,
                              const float* __restrict__ coords_y,
                              const float* __restrict__ src, float* __restrict__ grad_src,
                              float* __restrict__ grad_x, float* __restrict__ grad_y, int c,
                              int h, int w, int ho, int wo,
                              unsigned long long* __restrict__ path_blocks) {
  extern __shared__ float tile[];
  __shared__ int warp_box[4][kWarps];
  __shared__ int box[4];  // xlo, xhi, ylo, yhi of the block's valid corners

  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int ox = blockIdx.x * kTileW + threadIdx.x % kTileW;
  const int oy = blockIdx.y * kTileH + threadIdx.x / kTileW;
  const int64_t n = blockIdx.z;
  const bool active = ox < wo && oy < ho;
  const int64_t n_pix = (int64_t)ho * wo;
  const int64_t hw = (int64_t)h * w;
  const int64_t i = n * n_pix + (int64_t)oy * wo + ox;

  const float x = active ? __ldg(coords_x + i) : 0.0f;
  const float y = active ? __ldg(coords_y + i) : 0.0f;
  const mine::BilinearTap t = mine::prep_coords(x, y, h, w);
  // the Pallas kernel's corner weights, in its order of operations
  const float w00 = (1.0f - t.wx) * (1.0f - t.wy);
  const float w01 = t.wx * (1.0f - t.wy);
  const float w10 = (1.0f - t.wx) * t.wy;
  const float w11 = t.wx * t.wy;

  // the block's bounding box over valid corners only; every pixel has one
  // (on a size-1 axis the +1 corner is the valid one)
  int xlo = INT_MAX, xhi = INT_MIN, ylo = INT_MAX, yhi = INT_MIN;
  if (active) {
    const bool vx0 = t.v00 || t.v10, vx1 = t.v01 || t.v11;
    const bool vy0 = t.v00 || t.v01, vy1 = t.v10 || t.v11;
    xlo = vx0 ? t.x0 : t.x0 + 1;
    xhi = vx1 ? t.x0 + 1 : t.x0;
    ylo = vy0 ? t.y0 : t.y0 + 1;
    yhi = vy1 ? t.y0 + 1 : t.y0;
  }
  xlo = __reduce_min_sync(0xffffffffu, xlo);
  xhi = __reduce_max_sync(0xffffffffu, xhi);
  ylo = __reduce_min_sync(0xffffffffu, ylo);
  yhi = __reduce_max_sync(0xffffffffu, yhi);
  if (lane == 0) {
    warp_box[0][warp] = xlo;
    warp_box[1][warp] = xhi;
    warp_box[2][warp] = ylo;
    warp_box[3][warp] = yhi;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int k = 1; k < kWarps; ++k) {
      xlo = min(xlo, warp_box[0][k]);
      xhi = max(xhi, warp_box[1][k]);
      ylo = min(ylo, warp_box[2][k]);
      yhi = max(yhi, warp_box[3][k]);
    }
    box[0] = xlo;
    box[1] = xhi;
    box[2] = ylo;
    box[3] = yhi;
  }
  __syncthreads();
  xlo = box[0];
  ylo = box[2];
  const int bw = box[1] - xlo + 1, bh = box[3] - ylo + 1;
  // the same decision in every thread of the block: the syncs below are uniform
  const bool use_tile = (int64_t)bw * bh * c <= kTileFloats;
  if (threadIdx.x == 0 && path_blocks != nullptr) atomicAdd(path_blocks + (use_tile ? 0 : 1), 1ull);

  const float* gp = g + n * c * n_pix + ((int64_t)oy * wo + ox);
  float* gsrc = grad_src + n * c * hw;
  const float* img = kCoords ? src + n * c * hw : nullptr;
  float acc_x = 0.0f, acc_y = 0.0f;
  // the coordinate cotangent's share of channel ch, from the same g value
  auto add_coord_terms = [&](int ch, float gv) {
    if (!kCoords) return;
    const float* sp = img + ch * hw;
    const float a00 = t.v00 ? __ldg(sp + t.off00) : 0.0f;
    const float a01 = t.v01 ? __ldg(sp + t.off01) : 0.0f;
    const float a10 = t.v10 ? __ldg(sp + t.off10) : 0.0f;
    const float a11 = t.v11 ? __ldg(sp + t.off11) : 0.0f;
    const float dx = (a01 - a00) * (1.0f - t.wy) + (a11 - a10) * t.wy;
    const float dy = (a10 - a00) * (1.0f - t.wx) + (a11 - a01) * t.wx;
    acc_x += gv * dx;
    acc_y += gv * dy;
  };

  if (use_tile) {
    const int plane = bw * bh;
    for (int k = threadIdx.x; k < plane * c; k += kThreads) tile[k] = 0.0f;
    __syncthreads();
    if (active) {
      // masked corners (index -1) are never touched, so t00 may lie outside
      const int t00 = (t.y0 - ylo) * bw + (t.x0 - xlo);
      for (int ch = 0; ch < c; ++ch) {
        const float gv = __ldg(gp + ch * n_pix);
        float* tp = tile + ch * plane;
        if (t.v00) atomicAdd(tp + t00, gv * w00);
        if (t.v01) atomicAdd(tp + t00 + 1, gv * w01);
        if (t.v10) atomicAdd(tp + t00 + bw, gv * w10);
        if (t.v11) atomicAdd(tp + t00 + bw + 1, gv * w11);
        add_coord_terms(ch, gv);
      }
    }
    __syncthreads();
    // flush: a warp per tile row, its lanes on consecutive columns
    for (int r = warp; r < bh * c; r += kWarps) {
      const int ch = r / bh, row = r - ch * bh;
      const float* tp = tile + r * bw;
      float* dst = gsrc + ch * hw + (int64_t)(ylo + row) * w + xlo;
      for (int col = lane; col < bw; col += 32) {
        const float v = tp[col];
        if (v != 0.0f) atomicAdd(dst + col, v);
      }
    }
  } else if (active) {
    for (int ch = 0; ch < c; ++ch) {
      const float gv = __ldg(gp + ch * n_pix);
      float* plane = gsrc + ch * hw;
      if (t.v00) atomicAdd(plane + t.off00, gv * w00);
      if (t.v01) atomicAdd(plane + t.off01, gv * w01);
      if (t.v10) atomicAdd(plane + t.off10, gv * w10);
      if (t.v11) atomicAdd(plane + t.off11, gv * w11);
      add_coord_terms(ch, gv);
    }
  }

  if (kCoords && active) {
    // zero where the border clamp saturates (jnp.clip's gradient outside
    // [0, size-1]); the closed interval keeps the border itself
    grad_x[i] = (x >= 0.0f && x <= (float)(w - 1)) ? acc_x : 0.0f;
    grad_y[i] = (y >= 0.0f && y <= (float)(h - 1)) ? acc_y : 0.0f;
  }
}

}  // namespace

// grad_src must be zeroed by the caller. With src null only grad_src is
// computed (grad_x / grad_y are not touched and may be null). path_blocks,
// when not null, is a device array of two unsigned 64-bit counts to which
// each block adds one: [0] blocks on the shared path, [1] on the direct path.
extern "C" int mine_warp_bilinear_grad_f32(const void* g, const void* coords_x,
                                           const void* coords_y, const void* src,
                                           void* grad_src, void* grad_x, void* grad_y,
                                           int n, int c, int h, int w, int ho, int wo,
                                           void* path_blocks, void* stream) {
  const dim3 grid((wo + kTileW - 1) / kTileW, (ho + kTileH - 1) / kTileH, n);
  unsigned long long* paths = (unsigned long long*)path_blocks;
  if (src != nullptr) {
    warp_bilinear_grad_kernel<true><<<grid, kThreads, kTileBytes, (cudaStream_t)stream>>>(
        (const float*)g, (const float*)coords_x, (const float*)coords_y, (const float*)src,
        (float*)grad_src, (float*)grad_x, (float*)grad_y, c, h, w, ho, wo, paths);
  } else {
    warp_bilinear_grad_kernel<false><<<grid, kThreads, kTileBytes, (cudaStream_t)stream>>>(
        (const float*)g, (const float*)coords_x, (const float*)coords_y, nullptr,
        (float*)grad_src, nullptr, nullptr, c, h, w, ho, wo, paths);
  }
  return (int)cudaGetLastError();
}
