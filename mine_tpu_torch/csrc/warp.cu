// Bilinear border-padded warp, channels-major: out[n, c, p] = src[n, c] sampled
// at (coords_x[n, p], coords_y[n, p]), source-pixel units.
//
// Replaces the TPU kernels warp_bilinear_chw (mine_tpu/ops/pallas/warp.py:365,
// body _warp_kernel) and warp_bilinear_chw_banded (:552). On the TPU the
// banded variant exists because the resident kernel keeps the whole source in
// VMEM, which caps it at 8 MiB; here the source stays in device memory and is
// read through the cache, so one kernel serves both size regimes.
//
// Bound: memory. Per output pixel the kernel reads two fp32 coordinates and
// four corners per channel, and writes one value per channel. Neighbouring
// output pixels sample neighbouring source pixels for the smooth homographies
// of an MPI, so the corner reads of a warp mostly hit lines that neighbouring
// threads already brought into L1/L2, and device-memory traffic stays near
// coords + source + output (about 252 MB, 75 us at 3.35 TB/s, for the dense
// compositor's 32 planes x 4 channels at 384x512).
//
// Design: one thread per output pixel (n, p); the tap (weights and corner
// offsets) is computed once and reused across the C channels, which are
// looped over in registers. Consecutive threads own consecutive output
// pixels, so coordinate reads and output writes are coalesced.
#include "warp_common.cuh"

namespace {

__global__ void warp_bilinear_kernel(const float* __restrict__ src,
                                     const float* __restrict__ coords_x,
                                     const float* __restrict__ coords_y,
                                     float* __restrict__ out, int c, int h, int w,
                                     int64_t n_pix, int64_t total) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const int64_t n = i / n_pix;
  const int64_t p = i - n * n_pix;
  const int64_t hw = (int64_t)h * w;
  const mine::BilinearTap t = mine::prep_coords(__ldg(coords_x + i), __ldg(coords_y + i), h, w);
  const float* img = src + n * c * hw;
  float* o = out + n * c * n_pix + p;
  for (int ch = 0; ch < c; ++ch) {
    o[ch * n_pix] = mine::sample(img + ch * hw, t);
  }
}

}  // namespace

extern "C" int mine_warp_bilinear_f32(const void* src, const void* coords_x,
                                      const void* coords_y, void* out, int n, int c,
                                      int h, int w, int ho, int wo, void* stream) {
  const int64_t n_pix = (int64_t)ho * wo;
  const int64_t total = (int64_t)n * n_pix;
  const int threads = 256;
  const int64_t blocks = (total + threads - 1) / threads;
  warp_bilinear_kernel<<<(unsigned int)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const float*)src, (const float*)coords_x, (const float*)coords_y, (float*)out, c, h,
      w, n_pix, total);
  return (int)cudaGetLastError();
}
