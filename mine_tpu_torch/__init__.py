"""PyTorch/CUDA port of mine_tpu: predict an MPI from one image, render novel
views with hand-written CUDA warp kernels (csrc/). The JAX package mine_tpu is
the reference it is tested against; this package imports nothing of it."""
