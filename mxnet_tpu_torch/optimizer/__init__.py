"""``mxnet_tpu_torch.optimizer`` (counterpart of ``mxnet_tpu.optimizer``):
SGD, NAG, Adam and AdamW over the pure ``fused_rule`` update functions,
and the learning-rate schedules of ``lr_scheduler``."""
from . import lr_scheduler
from .optimizer import (NAG, SGD, Adam, AdamW, Optimizer, create, fused_rule,
                        register)

__all__ = ["Optimizer", "SGD", "NAG", "Adam", "AdamW", "register", "create",
           "fused_rule", "lr_scheduler"]
