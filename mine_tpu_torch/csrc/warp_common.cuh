// Shared device code of the warp kernels: one border-clamped bilinear tap
// with the exact coordinate convention of the JAX package's Pallas kernels
// (mine_tpu/ops/pallas/warp.py _prep_coords / _corner_gather4).
//
// Coordinates clamp to [0, size-1]; the corner pair is
// (floor(min(x, size-2)), +1) with weights (1-wx, wx). A corner index outside
// [0, size-1] contributes 0: that happens on a size-1 axis, where
// min(x, size-2) is -1 and the Pallas kernel masks the corner out.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace mine {

struct BilinearTap {
  float wx, wy;
  int x0, y0;                          // top-left corner; the others are +1
  int64_t off00, off01, off10, off11;  // offsets into one (H, W) plane
  bool v00, v01, v10, v11;             // corner lies inside the plane
};

__device__ __forceinline__ BilinearTap prep_coords(float x, float y, int h, int w) {
  x = fminf(fmaxf(x, 0.0f), (float)(w - 1));
  y = fminf(fmaxf(y, 0.0f), (float)(h - 1));
  const float x0f = floorf(fminf(x, (float)(w - 2)));
  const float y0f = floorf(fminf(y, (float)(h - 2)));
  const int x0 = (int)x0f, y0 = (int)y0f;
  const int x1 = x0 + 1, y1 = y0 + 1;
  const bool vx0 = x0 >= 0 && x0 < w, vx1 = x1 >= 0 && x1 < w;
  const bool vy0 = y0 >= 0 && y0 < h, vy1 = y1 >= 0 && y1 < h;
  BilinearTap t;
  t.wx = x - x0f;
  t.wy = y - y0f;
  t.x0 = x0;
  t.y0 = y0;
  t.v00 = vy0 && vx0;
  t.v01 = vy0 && vx1;
  t.v10 = vy1 && vx0;
  t.v11 = vy1 && vx1;
  t.off00 = (int64_t)y0 * w + x0;
  t.off01 = t.off00 + 1;
  t.off10 = t.off00 + w;
  t.off11 = t.off10 + 1;
  return t;
}

// One channel plane sampled at the tap; the blend order is the Pallas
// kernel's (top row, bottom row, then the vertical mix).
__device__ __forceinline__ float sample(const float* __restrict__ plane,
                                        const BilinearTap& t) {
  const float a00 = t.v00 ? __ldg(plane + t.off00) : 0.0f;
  const float a01 = t.v01 ? __ldg(plane + t.off01) : 0.0f;
  const float a10 = t.v10 ? __ldg(plane + t.off10) : 0.0f;
  const float a11 = t.v11 ? __ldg(plane + t.off11) : 0.0f;
  const float top = a00 * (1.0f - t.wx) + a01 * t.wx;
  const float bot = a10 * (1.0f - t.wx) + a11 * t.wx;
  return top * (1.0f - t.wy) + bot * t.wy;
}

}  // namespace mine

// Each library exports its own copy: the libraries are loaded separately.
extern "C" const char* mine_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
