"""Field, curve, segmented-scan, MSM, NTT and fixed-base layers with their
kernels, and the Fq per-op microbenchmark (field_bench)."""
