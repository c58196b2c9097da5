"""``mxnet_tpu_torch.optimizer`` (counterpart of ``mxnet_tpu.optimizer``):
the optimizers over the pure ``fused_rule`` update functions or the
reference's own chains, ``Updater``, and the learning-rate schedules of
``lr_scheduler``."""
from . import lr_scheduler
from .optimizer import (NAG, SGD, SGLD, AdaDelta, AdaGrad, Adam, AdamW, Ftrl,
                        LAMB, LARS, Optimizer, RMSProp, Segments, Signum,
                        Test, Updater, ccSGD, create, fused_rule, get_updater,
                        register)

__all__ = ["Optimizer", "SGD", "NAG", "Adam", "AdamW", "AdaGrad", "AdaDelta",
           "RMSProp", "Ftrl", "Signum", "LAMB", "LARS", "SGLD", "Test",
           "ccSGD", "register", "create", "Updater", "get_updater",
           "fused_rule", "Segments", "lr_scheduler"]
