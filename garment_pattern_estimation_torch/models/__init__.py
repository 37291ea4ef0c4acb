"""The pattern-shape models (the baseline and the attention model), the
stitch model, their building blocks, registry and weight loader."""

from . import blocks
from .flax_import import state_dict_from_flax
from .nets import (GarmentFullPattern3DModule, GarmentSegmentPattern3DModule,
                   StitchOnEdge3DPairsModule)
from .registry import GarmentModel, build_model

__all__ = ['blocks', 'build_model', 'GarmentModel', 'GarmentFullPattern3DModule',
           'GarmentSegmentPattern3DModule', 'StitchOnEdge3DPairsModule',
           'state_dict_from_flax']
