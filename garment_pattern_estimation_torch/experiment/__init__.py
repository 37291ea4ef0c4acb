"""Serving, experiment tracking and checkpoints of the port."""

from .checkpoint import load_checkpoint_file, save_checkpoint_file
from .serving import build_serving_fn
from .tracker import ExperimentWrapper, ExperimentWrappper

__all__ = ['build_serving_fn', 'ExperimentWrappper', 'ExperimentWrapper',
           'save_checkpoint_file', 'load_checkpoint_file']
