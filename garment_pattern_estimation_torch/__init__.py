"""garment_pattern_estimation_torch — the PyTorch + CUDA port for NVIDIA Hopper.

A second package beside `garment_pattern_estimation_tpu` (the JAX reference,
which this package never imports). It serves the NeuralTailor pattern-shape
models, the attention model and the baseline (point cloud -> panel outlines,
placements, stitch tags), and trains them, step by step or over a dataset;
and it trains the stitch model on a shape run's predictions, the two-stage
pipeline of the train CLI; it evaluates and predicts with both stages and
exports a serving artifact.

Layering (bottom-up):
    device.py    device resolution: CUDA unless the caller asks for the CPU
    core/        the sewing-pattern spec and its tensor codec (numpy)
    preprocess/  mesh IO, surface sampling and snapping (a C++ library)
    data/        datasets, splits, balanced batches, the prefetching loader
    utils/       the synthetic dataset generator
    ops/         the CUDA kernels (csrc/) with their plain PyTorch versions,
                 sparsemax, pools, chunked EdgeConv training
    models/      nn.Modules of the shape models and the stitch model, the
                 registry, the loader from the JAX package's flax variables
    losses/      the composed pattern loss, the stitch model's loss, their
                 quality metrics
    train/       Trainer: train_step, eval_step and fit; predict and eval
                 shortcuts (eval_utils)
    experiment/  serving (standardize -> forward -> un-standardize), its
                 `torch.export` artifact, the local experiment tracker,
                 checkpoints and reference `.pth` files, a stored run's
                 dataset and model
    cli/         the entry points: train, on_test_set, predict_per_example,
                 noise_levels, export_serving
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
