"""Core sewing-pattern library: spec format, tensor codec, panel classes.

The port's copy of garment_pattern_estimation_tpu/core/ (numpy and scipy
inside; `render.py` imports matplotlib only when it draws)."""

from .pattern_spec import PatternSpec, panel_spec_template, pattern_spec_template
from .pattern_codec import NNSewingPattern, EmptyPanelError, InvalidPatternDefError
from .panel_classes import PanelClasses
from .properties import Properties
from . import rotations

__all__ = [
    'PatternSpec', 'NNSewingPattern', 'PanelClasses', 'Properties',
    'EmptyPanelError', 'InvalidPatternDefError',
    'panel_spec_template', 'pattern_spec_template', 'rotations',
]
