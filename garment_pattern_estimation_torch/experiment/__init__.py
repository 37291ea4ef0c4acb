"""Serving of the port."""

from .serving import build_serving_fn

__all__ = ['build_serving_fn']
