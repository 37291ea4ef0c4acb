"""garment_pattern_estimation_torch — the PyTorch + CUDA port for NVIDIA Hopper.

A second package beside `garment_pattern_estimation_tpu` (the JAX reference,
which this package never imports). It runs the NeuralTailor attention
model's serving path: point cloud -> panel outlines, placements, stitch tags.

Layering (bottom-up):
    device.py    device resolution: CUDA unless the caller asks for the CPU
    ops/         the fused EdgeConv CUDA kernel (csrc/) with its plain PyTorch
                 version, sparsemax, pools, the packing helpers of the kNN
    models/      nn.Modules of the attention model, the registry, the loader
                 from the JAX package's flax variables
    experiment/  the serving pipeline (standardize -> forward -> un-standardize)
"""
import torch

from .device import resolve_device

# The JAX reference computes every f32 matmul outside its kernels at full f32.
# TF32 would keep ~10 mantissa bits in matmuls (cuBLAS) and convolutions
# (cuDNN) on the card, so both are turned off for the whole package.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
# The bf16 compute mode's products accumulate in f32, as on the TPU's MXU:
# no split-K partial sums rounded to bf16 in cuBLAS.
torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False

__version__ = '0.1.0'

__all__ = ['resolve_device']
