"""Field, curve, segmented-scan, MSM and NTT layers with their kernels."""
