"""The training step of the port."""

from .trainer import Trainer, canonical_epoch, cosine_onecycle_schedule, phase_of

__all__ = ['Trainer', 'canonical_epoch', 'cosine_onecycle_schedule', 'phase_of']
