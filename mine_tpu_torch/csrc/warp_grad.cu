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
// so the TPU kernel turns it into one-hot MXU matmuls over a sequential grid;
// a CUDA thread scatters with atomicAdd directly, and device memory has no
// VMEM ceiling, so one kernel serves both source sizes.
//
// Bound: memory. Per output pixel the kernel reads two coordinates and C
// cotangent values and does 4C atomic adds into grad_src, whose zero fill
// (by the caller) and read-modify-write are the largest traffic; in the
// coordinate mode it also reads the four corners of src per channel and
// writes two floats. Neighbouring output pixels sample neighbouring source
// pixels for the smooth homographies of an MPI, so a warp's atomics land on
// a few cache lines and are merged in L2.
//
// Design: one thread per output pixel, its tap computed once by
// mine::prep_coords (so the border convention is the forward's, bit for
// bit) and reused across the C channels. The coordinate cotangent is
// accumulated over C in registers from the same corner reads, so nothing of
// the (N, 4, C, Ho, Wo) corner residuals is ever stored. Atomics add in a
// different order on every run: grad_src is reproducible to rounding only.
// Coordinates outside the image clamp to the border, so every off-image
// sample lands its weight on the edge pixels: those addresses take many
// atomics from many threads (contention, not a fault).
#include "warp_common.cuh"

namespace {

template <bool kCoords>
__global__ void warp_bilinear_grad_kernel(const float* __restrict__ g,
                                          const float* __restrict__ coords_x,
                                          const float* __restrict__ coords_y,
                                          const float* __restrict__ src,
                                          float* __restrict__ grad_src,
                                          float* __restrict__ grad_x,
                                          float* __restrict__ grad_y, int c, int h,
                                          int w, int64_t n_pix, int64_t total) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const int64_t n = i / n_pix;
  const int64_t p = i - n * n_pix;
  const int64_t hw = (int64_t)h * w;
  const float x = __ldg(coords_x + i);
  const float y = __ldg(coords_y + i);
  const mine::BilinearTap t = mine::prep_coords(x, y, h, w);
  // the Pallas kernel's corner weights, in its order of operations
  const float w00 = (1.0f - t.wx) * (1.0f - t.wy);
  const float w01 = t.wx * (1.0f - t.wy);
  const float w10 = (1.0f - t.wx) * t.wy;
  const float w11 = t.wx * t.wy;
  const float* gp = g + n * c * n_pix + p;
  float* gsrc = grad_src + n * c * hw;
  const float* img = kCoords ? src + n * c * hw : nullptr;
  float acc_x = 0.0f, acc_y = 0.0f;
  for (int ch = 0; ch < c; ++ch) {
    const float gv = __ldg(gp + ch * n_pix);
    float* plane = gsrc + ch * hw;
    if (t.v00) atomicAdd(plane + t.off00, gv * w00);
    if (t.v01) atomicAdd(plane + t.off01, gv * w01);
    if (t.v10) atomicAdd(plane + t.off10, gv * w10);
    if (t.v11) atomicAdd(plane + t.off11, gv * w11);
    if (kCoords) {
      const float* sp = img + ch * hw;
      const float a00 = t.v00 ? __ldg(sp + t.off00) : 0.0f;
      const float a01 = t.v01 ? __ldg(sp + t.off01) : 0.0f;
      const float a10 = t.v10 ? __ldg(sp + t.off10) : 0.0f;
      const float a11 = t.v11 ? __ldg(sp + t.off11) : 0.0f;
      const float dx = (a01 - a00) * (1.0f - t.wy) + (a11 - a10) * t.wy;
      const float dy = (a10 - a00) * (1.0f - t.wx) + (a11 - a01) * t.wx;
      acc_x += gv * dx;
      acc_y += gv * dy;
    }
  }
  if (kCoords) {
    // zero where the border clamp saturates (jnp.clip's gradient outside
    // [0, size-1]); the closed interval keeps the border itself
    grad_x[i] = (x >= 0.0f && x <= (float)(w - 1)) ? acc_x : 0.0f;
    grad_y[i] = (y >= 0.0f && y <= (float)(h - 1)) ? acc_y : 0.0f;
  }
}

}  // namespace

// grad_src must be zeroed by the caller. With src null only grad_src is
// computed (grad_x / grad_y are not touched and may be null).
extern "C" int mine_warp_bilinear_grad_f32(const void* g, const void* coords_x,
                                           const void* coords_y, const void* src,
                                           void* grad_src, void* grad_x, void* grad_y,
                                           int n, int c, int h, int w, int ho, int wo,
                                           void* stream) {
  const int64_t n_pix = (int64_t)ho * wo;
  const int64_t total = (int64_t)n * n_pix;
  const int threads = 256;
  const int64_t blocks = (total + threads - 1) / threads;
  if (src != nullptr) {
    warp_bilinear_grad_kernel<true><<<(unsigned int)blocks, threads, 0, (cudaStream_t)stream>>>(
        (const float*)g, (const float*)coords_x, (const float*)coords_y, (const float*)src,
        (float*)grad_src, (float*)grad_x, (float*)grad_y, c, h, w, n_pix, total);
  } else {
    warp_bilinear_grad_kernel<false><<<(unsigned int)blocks, threads, 0, (cudaStream_t)stream>>>(
        (const float*)g, (const float*)coords_x, (const float*)coords_y, nullptr,
        (float*)grad_src, nullptr, nullptr, c, h, w, n_pix, total);
  }
  return (int)cudaGetLastError();
}
