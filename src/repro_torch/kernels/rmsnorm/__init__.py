"""The legacy two-output residual+RMSNorm: hand CUDA kernel, plain version."""
