"""The pattern-shape models (the baseline and the attention model), their
building blocks, registry and weight loader."""

from . import blocks
from .flax_import import state_dict_from_flax
from .nets import GarmentFullPattern3DModule, GarmentSegmentPattern3DModule
from .registry import GarmentModel, build_model

__all__ = ['blocks', 'build_model', 'GarmentModel', 'GarmentFullPattern3DModule',
           'GarmentSegmentPattern3DModule', 'state_dict_from_flax']
