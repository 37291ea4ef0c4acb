"""Fault C9's witness: `--torch_cross_check` of both parity CLIs on one
checkpoint, all on the CPU, each forward against the torch reference
replica's:
  * `jax_fused`: the JAX CLI with its fused EdgeConv layer, the forward it
    serves and holds on a TPU, through `fused_edgeconv_reference`
    (garment_pattern_estimation_tpu/ops/edgeconv.py), the kernel's
    numerics in plain jnp;
  * `jax_xla`: the JAX CLI as it runs on the CPU (the f32 XLA layer);
  * `port`: the port CLI with `--device cpu`: `torch:` rows the serving
    forward (the fused layer's plain version), `torch_f32:` rows the f32
    forward.
A port checkpoint (`--shape_pth`, no global-pool head) is first written as
a reference `.pth` through the replica, which the JAX CLI imports.

    JAX_PLATFORM_NAME=cpu PYTHONPATH=.:tests python tests/torch_serving_gap_witness.py \\
        --dataset_root parity_run/data_big --shape_config shape.yaml \\
        --shape_pth checkpoint.pt --output witness.json

Prints and writes {forward: {row: {ours, reference, delta}}}.
"""
from __future__ import annotations

import argparse
import contextlib
import functools
import json
import tempfile
from pathlib import Path


@contextlib.contextmanager
def jax_fused_forward():
    """The JAX CLI's models built with `use_pallas=True`, their fused layer
    through `fused_edgeconv_reference`: the eval forward a TPU runs."""
    from garment_pattern_estimation_tpu.cli import parity_check as jx_parity
    from garment_pattern_estimation_tpu.models import blocks as jx_blocks
    from garment_pattern_estimation_tpu.ops.edgeconv import fused_edgeconv_reference

    def reference(x, folded, k, mlp_dtype, interpret):
        return fused_edgeconv_reference(x, folded, k, mlp_dtype=mlp_dtype)

    saved = jx_parity.build_model, jx_blocks.fused_edgeconv
    jx_parity.build_model = functools.partial(saved[0], use_pallas=True)
    jx_blocks.fused_edgeconv = reference
    try:
        yield
    finally:
        jx_parity.build_model, jx_blocks.fused_edgeconv = saved


def reference_pth(shape_config, dataset_root, shape_pth, out):
    """`shape_pth` (a port or reference checkpoint) as a reference `.pth`:
    loaded into the replica (its unread global-pool head as drawn when the
    checkpoint lacks it), the replica's state dict saved."""
    import torch

    from garment_pattern_estimation_torch.cli import parity_check as pt_parity
    from garment_pattern_estimation_torch.experiment import load_checkpoint_any

    args = argparse.Namespace(shape_config=shape_config, dataset_root=dataset_root,
                              max_datapoints=None, shape_pth='')
    config, dataset = pt_parity._build_shape_stack(args, torch.device('cpu'),
                                                   load_checkpoint=False)[:2]
    replica = pt_parity._replica_from_config(config, dataset)
    pt_parity._load_replica(replica, load_checkpoint_any(shape_pth)['model'])
    torch.save({'model_state_dict': replica.state_dict()}, out)
    return out


def replica_rows(report):
    """{row: {ours, reference, delta}} of a report's replica rows."""
    return {c['metric']: {k: c[k] for k in ('ours', 'reference', 'delta')}
            for c in report.get('comparisons', [])
            if c['metric'].split(':')[0] in ('torch', 'torch_f32')}


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument('--dataset_root', required=True)
    parser.add_argument('--shape_config', required=True)
    parser.add_argument('--shape_pth', required=True)
    parser.add_argument('--output', default='serving_gap_witness.json')
    args = parser.parse_args(argv)

    from garment_pattern_estimation_torch.cli import parity_check as pt_parity
    from garment_pattern_estimation_tpu.cli import parity_check as jx_parity

    out = {}
    with tempfile.TemporaryDirectory() as work:
        work = Path(work)
        pth = reference_pth(args.shape_config, args.dataset_root, args.shape_pth,
                            work / 'shape.pth')
        common = ['--dataset_root', args.dataset_root, '--shape_config', args.shape_config,
                  '--torch_cross_check']
        runs = (('port', pt_parity.main, ['--shape_pth', args.shape_pth, '--device', 'cpu'],
                 contextlib.nullcontext),
                ('jax_xla', jx_parity.main, ['--shape_pth', str(pth)], contextlib.nullcontext),
                ('jax_fused', jx_parity.main, ['--shape_pth', str(pth)], jax_fused_forward))
        for name, cli, extra, context in runs:
            report = work / f'{name}.json'
            with context():
                cli(common + extra + ['--output', str(report)])
            out[name] = replica_rows(json.loads(report.read_text()))
    Path(args.output).write_text(json.dumps(out, indent=1))
    print(json.dumps(out, indent=1))


if __name__ == '__main__':
    main()
