"""Utilities: the synthetic garment dataset generator; the port's spans
(`tracing`)."""
