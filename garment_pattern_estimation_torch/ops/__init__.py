"""Ops of the port: the fused EdgeConv (CUDA kernel + plain version),
sparsemax, masked pools, the kNN packing helpers."""
