"""Rasterizer (plain oracle + CUDA blend kernels), SSIM and 3-NN."""
