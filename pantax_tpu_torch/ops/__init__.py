"""Device kernels and the fused pipeline."""
