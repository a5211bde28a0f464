// Fused homography warp + front-to-back over-composite of an MPI.
//
// Replaces the TPU kernel warp_composite_chw (mine_tpu/ops/pallas/warp.py:689,
// body _warp_composite_kernel :624). Per output pixel and per plane s, in
// order: sample the plane's C channels with the warp's border-clamped bilinear
// tap (sigma last), zero sigma where the target-frame z < 0, then
//   tau = exp(-sigma * dist), w = T * (1 - tau),
//   acc_rgb += w * rgb, acc_z += w * z, acc_w += w,
//   acc_valid += (x, y) inside (-1, W) x (-1, H),  T <- T * (tau + 1e-6).
// Output (N, C+3, Ho, Wo): C-1 rgb sums, z sum, weight sum, valid count, T.
//
// Bound: memory. Per plane pixel the kernel reads x, y, dist and z (16 bytes)
// and about C source values; it writes C+3 values per output pixel once, after
// the whole sweep. At S=32, C=4, 384x512 that is about 207 MB, 62 us at
// 3.35 TB/s.
//
// Design: one thread per output pixel. The TPU kernel's sequential plane grid
// axis, whose accumulators stay resident in VMEM across the sweep, becomes a
// loop inside the thread with the accumulators in registers, so no warped
// plane and no partial sum ever reaches device memory. Consecutive threads
// own consecutive output pixels: the per-plane coordinate reads coalesce, and
// the corner reads of smooth homographies share cache lines. The channel
// count is the compile-time constant C = 4 (rgb + sigma), so the accumulators
// are registers, not local memory.
#include "warp_common.cuh"

namespace {

constexpr int C = 4;  // rgb + sigma, the only payload the compositor has

__global__ void warp_composite_kernel(const float* __restrict__ src,
                                      const float* __restrict__ coords_x,
                                      const float* __restrict__ coords_y,
                                      const float* __restrict__ dist,
                                      const float* __restrict__ z,
                                      float* __restrict__ out, int s, int h, int w,
                                      int64_t n_pix, int64_t total) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const int64_t n = i / n_pix;
  const int64_t p = i - n * n_pix;
  const int64_t hw = (int64_t)h * w;

  float rgb[C - 1];
#pragma unroll
  for (int ch = 0; ch < C - 1; ++ch) rgb[ch] = 0.0f;
  float z_sum = 0.0f, w_sum = 0.0f, valid_sum = 0.0f, trans = 1.0f;

  for (int sp = 0; sp < s; ++sp) {
    const int64_t q = (n * s + sp) * n_pix + p;
    const float x = __ldg(coords_x + q);
    const float y = __ldg(coords_y + q);
    const mine::BilinearTap t = mine::prep_coords(x, y, h, w);
    const float* img = src + (n * s + sp) * C * hw;
    float vals[C];
#pragma unroll
    for (int ch = 0; ch < C; ++ch) vals[ch] = mine::sample(img + ch * hw, t);

    const float zz = __ldg(z + q);
    // planes behind the target camera contribute nothing
    const float sigma = zz >= 0.0f ? vals[C - 1] : 0.0f;
    const bool valid = (x > -1.0f) && (x < (float)w) && (y > -1.0f) && (y < (float)h);
    const float tau = expf(-sigma * __ldg(dist + q));
    const float wgt = trans * (1.0f - tau);
#pragma unroll
    for (int ch = 0; ch < C - 1; ++ch) rgb[ch] += wgt * vals[ch];
    z_sum += wgt * zz;
    w_sum += wgt;
    valid_sum += valid ? 1.0f : 0.0f;
    // the 1e-6 keeps the transmittance off exactly zero, as the dense cumprod
    trans = trans * (tau + 1.0e-6f);
  }

  float* o = out + n * (C + 3) * n_pix + p;
#pragma unroll
  for (int ch = 0; ch < C - 1; ++ch) o[ch * n_pix] = rgb[ch];
  o[(C - 1) * n_pix] = z_sum;
  o[C * n_pix] = w_sum;
  o[(C + 1) * n_pix] = valid_sum;
  o[(C + 2) * n_pix] = trans;
}

}  // namespace

// The wrapper rejects any c but 4 before it calls; c is checked again here.
extern "C" int mine_warp_composite_f32(const void* src, const void* coords_x,
                                       const void* coords_y, const void* dist,
                                       const void* z, void* out, int n, int s, int c,
                                       int h, int w, int ho, int wo, void* stream) {
  if (c != C) return (int)cudaErrorInvalidValue;
  const int64_t n_pix = (int64_t)ho * wo;
  const int64_t total = (int64_t)n * n_pix;
  const int threads = 256;
  const int64_t blocks = (total + threads - 1) / threads;
  warp_composite_kernel<<<(unsigned int)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const float*)src, (const float*)coords_x, (const float*)coords_y,
      (const float*)dist, (const float*)z, (float*)out, s, h, w, n_pix, total);
  return (int)cudaGetLastError();
}
