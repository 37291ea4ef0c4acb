"""Serving and its exported artifact, experiment tracking, checkpoints and
the import of reference `.pth` files."""

from .checkpoint import load_checkpoint_file, save_checkpoint_file
from .serving import (ServingModel, build_serving_fn, export_serving_artifact,
                      load_serving_artifact)
from .torch_import import load_checkpoint_any
from .tracker import ExperimentWrapper, ExperimentWrappper

__all__ = ['build_serving_fn', 'export_serving_artifact', 'load_serving_artifact',
           'ServingModel', 'ExperimentWrappper', 'ExperimentWrapper',
           'save_checkpoint_file', 'load_checkpoint_file', 'load_checkpoint_any']
