"""Panel classification: (template, panel-name) -> class index.

Behavioral counterpart of the reference's ``nn/data/panel_classes.py``:
the class file is a JSON object mapping class names to lists of
``[template, panel]`` pairs; class order in the file defines indices, and the
number of classes drives ``max_pattern_len`` when classification is enabled.

The port's copy of garment_pattern_estimation_tpu/core/panel_classes.py:1-50.
"""
from __future__ import annotations

import json

import numpy as np


class PanelClasses:
    """Access panel classification by garment-template role."""

    def __init__(self, classes_file):
        self.filename = str(classes_file)
        with open(classes_file, 'r') as stream:
            # plain dict: json.load preserves file order on py3.7+
            self.classes = json.load(stream)

        self.names = list(self.classes)
        # flat lookup: (template, panel) -> class id, file order = index
        self.panel_to_idx = {
            tuple(member): class_id
            for class_id, members in enumerate(self.classes.values())
            for member in members}

    def __len__(self):
        return len(self.names)

    def class_idx(self, template, panel):
        """Index of the class the (template, panel) pair belongs to."""
        return self.panel_to_idx[template, panel]

    def class_name(self, idx):
        return self.names[idx]

    def map(self, template_name, panel_list):
        """Map panel names (for one template) to class ids; 'stitch' labels
        map to -1 with a warning (reference: panel_classes.py:819-830)."""
        def one(panel):
            if panel == 'stitch':
                print(f'{type(self).__name__}::Warning::stitch label maps to -1')
                return -1
            return self.panel_to_idx[template_name, panel]

        return np.array([one(panel) for panel in panel_list], dtype=float)
