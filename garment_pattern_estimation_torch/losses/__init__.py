"""Losses and quality metrics of the pattern-shape models and the stitch
model."""

from .composed import ComposedLoss, ComposedPatternLoss

__all__ = ['ComposedLoss', 'ComposedPatternLoss']
