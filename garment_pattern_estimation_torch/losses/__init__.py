"""Losses and quality metrics of the pattern-shape models."""

from .composed import ComposedPatternLoss

__all__ = ['ComposedPatternLoss']
