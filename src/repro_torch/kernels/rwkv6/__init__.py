"""WKV6 (RWKV-6 time-mix recurrence): hand CUDA kernel and plain versions."""
