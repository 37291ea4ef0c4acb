"""JSON-backed key-value property files.

Replaces the external ``customconfig.Properties`` used throughout the
reference (e.g. nn/train.py:82 for ``system.json``, nn/data/datasets.py:445
for per-dataset ``dataset_properties.json``): a thin dict wrapper around a
JSON file with load/merge/serialize.

The port's copy of garment_pattern_estimation_tpu/core/properties.py:1-64.
"""
from __future__ import annotations

import json
from pathlib import Path


class Properties:
    """Dictionary-like access to a JSON properties file."""

    def __init__(self, filename=None, clean_stats=False):
        self.properties = {}
        self.filename = str(filename) if filename is not None else None
        if filename is not None:
            with open(filename, 'r') as f:
                self.properties = json.load(f)
            if clean_stats:
                self._clean_stats(self.properties)

    # --- dict interface ---
    def __getitem__(self, key):
        return self.properties[key]

    def __setitem__(self, key, value):
        self.properties[key] = value

    def __contains__(self, key):
        return key in self.properties

    def get(self, key, default=None):
        return self.properties.get(key, default)

    def update(self, *args, **kwargs):
        self.properties.update(*args, **kwargs)

    def merge(self, filename):
        """Merge (override) values from another properties file."""
        with open(filename, 'r') as f:
            self.properties.update(json.load(f))

    def has(self, key):
        return key in self.properties

    def serialize(self, filename=None):
        filename = filename or self.filename
        if filename is None:
            raise ValueError('Properties::no filename to serialize to')
        Path(filename).parent.mkdir(parents=True, exist_ok=True)
        with open(filename, 'w') as f:
            json.dump(self.properties, f, indent=2, sort_keys=True)
        return filename

    @staticmethod
    def _clean_stats(node):
        if isinstance(node, dict):
            node.pop('stats', None)
            for value in node.values():
                Properties._clean_stats(value)
