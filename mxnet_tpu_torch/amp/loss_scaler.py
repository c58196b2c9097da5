"""Dynamic loss scaler: the port's counterpart of
``mxnet_tpu/amp/loss_scaler.py`` (after MXNet's
``python/mxnet/contrib/amp/loss_scaler.py``).

bfloat16 has float32's exponent range, so ``amp.init_trainer`` gives it
a static scale of 1.  For float16 the classic dynamic scheme applies:
halve on overflow (not below 1) and skip the update, double after
``scale_window`` clean steps (not above 2**24).
"""
from __future__ import annotations

import torch

__all__ = ["LossScaler"]


class LossScaler:
    def __init__(self, init_scale=2.0 ** 16, scale_factor=2.0,
                 scale_window=2000, dynamic=True):
        self.loss_scale = float(init_scale)
        self._scale_factor = scale_factor
        self._scale_window = scale_window
        self._dynamic = dynamic
        self._unskipped = 0

    def has_overflow(self, params):
        """True if any present gradient of ``params`` is not finite.  One
        multi-tensor max-norm over the gradients (NaN and inf carry
        through a max), then one read on the host."""
        grads = [p.grad for p in params if p.grad is not None]
        if not grads:
            return False
        norms = torch._foreach_norm(grads, float("inf"))
        return not bool(torch.isfinite(
            torch.stack([n.float() for n in norms])).all())

    def update_scale(self, overflow):
        if not self._dynamic:
            return
        if overflow:
            self.loss_scale = max(self.loss_scale / self._scale_factor, 1.0)
            self._unskipped = 0
        else:
            self._unskipped += 1
            if self._unskipped >= self._scale_window:
                self.loss_scale = min(self.loss_scale * self._scale_factor,
                                      2.0 ** 24)
                self._unskipped = 0
