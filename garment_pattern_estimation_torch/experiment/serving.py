"""The serving pipeline: raw points in physical units -> pattern tensors in
physical units, eager or as an exported artifact.

Counterpart of garment_pattern_estimation_tpu/experiment/serving.py:
standardize the cloud with the data config's `f_shift`/`f_scale`, run the
eval forward, un-standardize the prediction keys that have ground-truth
statistics. `build_serving_fn` runs it eagerly; `export_serving_artifact`
traces it once with `torch.export` and saves a self-contained artifact
directory:

    model.pt2       the exported program (weights baked in), `torch.export.save`
    manifest.json   input/output shapes + dtypes, the data config needed to
                    decode tensors into sewing patterns, export metadata

The fused EdgeConv is a registered operator (`ops/edgeconv.py`,
`gpe_torch::fused_edgeconv`), so the program holds a call to it and an
artifact exported on the card launches the hand-written kernel at run time.
`load_serving_artifact` needs no model code and no checkpoint: only the
port's `ops` (the operator's registration). An artifact runs on the device
type it was exported on (`platforms`) and refuses inputs on any other.
"""
from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import torch
from torch import nn

from ..utils import tracing
from .tracker import _to_jsonable

SERVING_FORMAT_VERSION = 1
_BLOB_NAME = 'model.pt2'
_MANIFEST_NAME = 'manifest.json'

# prediction keys that un-standardize back to physical units; the rest
# (free-edge logits, attention weights) pass through raw
_GT_KEYS = ('outlines', 'rotations', 'translations', 'stitch_tags')


class ServingPipeline(nn.Module):
    """standardize -> the model's eval forward -> un-standardize, with the
    data config's statistics as buffers on the model's device. A missing
    `f_shift`/`f_scale` means identity."""

    def __init__(self, model, data_config):
        super().__init__()
        self.module = model.module
        std = data_config.get('standardize', {})

        def vec(values):
            return torch.as_tensor(values, dtype=torch.float32, device=model.device)

        self.register_buffer('f_shift', vec(std.get('f_shift', [0.0, 0.0, 0.0])))
        self.register_buffer('f_scale', vec(std.get('f_scale', [1.0, 1.0, 1.0])))
        self.gt_keys = [k for k in _GT_KEYS if k in std.get('gt_shift', {})]
        for key in self.gt_keys:
            self.register_buffer(f'gt_shift_{key}', vec(std['gt_shift'][key]))
            self.register_buffer(f'gt_scale_{key}', vec(std['gt_scale'][key]))

    def forward(self, points):
        x = (points.float() - self.f_shift) / self.f_scale
        preds = self.module(x.contiguous())
        return {key: value * getattr(self, f'gt_scale_{key}') + getattr(self, f'gt_shift_{key}')
                if key in self.gt_keys else value
                for key, value in preds.items()}


def build_serving_fn(model, data_config):
    """`serve(points (B, N, 3)) -> {key: tensor}` on the model's device; a
    call is one `gpe.serve` span (`utils/tracing.py`)."""
    pipeline = ServingPipeline(model, data_config)
    device = model.device

    @torch.inference_mode()
    def serve(points):
        with tracing.span('gpe.serve'):
            return pipeline(torch.as_tensor(points, device=device))

    return serve


def export_serving_artifact(model, data_config, out_dir, *, batch_size=64, num_points=2000,
                            extra_manifest=None):
    """Export the serving pipeline of `model` (eval mode) for (batch_size,
    num_points, 3) f32 inputs on the model's device with `torch.export`,
    and write the program and its manifest into `out_dir`. Returns the
    manifest dict."""
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    model.module.eval()
    pipeline = ServingPipeline(model, data_config).eval()
    example = torch.zeros(batch_size, num_points, 3, dtype=torch.float32, device=model.device)
    with torch.no_grad():
        program = torch.export.export(pipeline, (example,))
    blob_path = out_dir / _BLOB_NAME
    torch.export.save(program, blob_path)

    manifest = {
        'format_version': SERVING_FORMAT_VERSION,
        'model': model.name,
        'platforms': [model.device.type],
        'input': {'shape': [batch_size, num_points, 3], 'dtype': 'float32',
                  'units': 'physical (unstandardized) point coordinates'},
        'outputs': _output_info(program),
        'data_config': _to_jsonable(data_config),
        'blob_bytes': blob_path.stat().st_size,
    }
    manifest.update(extra_manifest or {})
    (out_dir / _MANIFEST_NAME).write_text(json.dumps(manifest, indent=2))
    return manifest


def _output_info(program):
    """{output key: {'shape', 'dtype'}} from the exported graph's output
    values, each key matched to its value through the output tree."""
    values = list(program.graph.output_node().args[0])
    user = values[len(values) - len(program.graph_signature.user_outputs):]
    tree = torch.utils._pytree.tree_unflatten(list(range(len(user))),
                                              program.call_spec.out_spec)
    return {key: {'shape': list(user[i].meta['val'].shape),
                  'dtype': str(user[i].meta['val'].dtype).removeprefix('torch.')}
            for key, i in tree.items()}


class ServingModel:
    """A loaded serving artifact: validates inputs, calls the exported
    program under `torch.inference_mode`, returns the prediction dict in
    physical units on the artifact's device."""

    def __init__(self, program, manifest):
        self._module = program.module()
        self.manifest = manifest
        self.input_shape = tuple(manifest['input']['shape'])
        self.platforms = tuple(manifest['platforms'])

    @property
    def data_config(self):
        return self.manifest['data_config']

    def __call__(self, points):
        if not isinstance(points, torch.Tensor):
            points = torch.as_tensor(np.asarray(points, dtype=np.float32))
        if tuple(points.shape) != self.input_shape:
            raise ValueError(
                f'ServingModel::input shape {tuple(points.shape)} does not '
                f'match the exported program {self.input_shape}; re-export '
                'with the serving batch/point count or pad the batch')
        if points.device.type not in self.platforms:
            raise ValueError(
                f'ServingModel::input on {points.device.type}, but the program was '
                f'exported for {list(self.platforms)}; move the input there or '
                're-export on that device')
        with torch.inference_mode():
            return self._module(points)


def load_serving_artifact(path):
    """Load a `ServingModel` from an artifact directory (or its blob path)."""
    from ..ops import edgeconv  # noqa: F401  registers gpe_torch::fused_edgeconv

    path = Path(path)
    if path.is_file():
        path = path.parent
    blob_path = path / _BLOB_NAME
    if not blob_path.exists():
        raise FileNotFoundError(f'load_serving_artifact::{blob_path} missing')
    manifest = json.loads((path / _MANIFEST_NAME).read_text())
    return ServingModel(torch.export.load(blob_path), manifest)
