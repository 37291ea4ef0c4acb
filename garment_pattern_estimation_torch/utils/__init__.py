"""Utilities: the synthetic garment dataset generator."""
