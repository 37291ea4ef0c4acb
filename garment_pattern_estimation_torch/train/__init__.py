"""The training step, `Trainer.fit` and the evaluation shortcuts of the
port."""

from .eval_utils import eval_metrics, make_predict_fn
from .trainer import Trainer, canonical_epoch, cosine_onecycle_schedule, phase_of

__all__ = ['Trainer', 'canonical_epoch', 'cosine_onecycle_schedule', 'eval_metrics',
           'make_predict_fn', 'phase_of']
