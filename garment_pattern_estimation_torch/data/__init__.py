"""Dataset layer: datasets, loaders, splits, balanced batching, transforms.

The port's copy of garment_pattern_estimation_tpu/data/, without the stitch
model's `GarmentStitchPairsDataset`."""

from .datasets import (
    BaseDataset, GarmentBaseDataset, Garment3DPatternFullDataset, DATASET_REGISTRY,
)
from .wrapper import DatasetWrapper
from .loader import DataLoader, Subset, default_collate
from .sampler import BalancedBatchSampler
from .utils import sample_points_from_meshes, save_garments_prediction
from ..core import InvalidPatternDefError
from . import transforms

__all__ = [
    'BaseDataset', 'GarmentBaseDataset', 'Garment3DPatternFullDataset',
    'DATASET_REGISTRY', 'DatasetWrapper',
    'DataLoader', 'Subset', 'default_collate', 'BalancedBatchSampler',
    'sample_points_from_meshes', 'save_garments_prediction',
    'InvalidPatternDefError', 'transforms',
]
