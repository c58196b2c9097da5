"""``gluon.model_zoo.vision`` (counterpart of
``mxnet_tpu.gluon.model_zoo.vision``): the classifiers (ResNet v1/v2,
AlexNet, VGG, SqueezeNet, DenseNet, Inception V3, MobileNet v1/v2,
ResNeXt, SE-ResNet, ResNeSt) and SSD.

``get_model(name)`` serves them (dots and dashes in names read as
underscores, as in the reference); YOLO, R-CNN, segmentation, the
``*_v1b`` backbones and pose raise ``NotSupportedError`` naming ROADMAP
§1 item 11c, where they arrive, and ``pretrained=True`` raises: no
weights are downloaded, and the model store is not ported (load a local
``.params`` file with ``load_parameters``).
"""
import importlib

from .resnet import *  # noqa: F401,F403
from .alexnet import *  # noqa: F401,F403
from .vgg import *  # noqa: F401,F403
from .squeezenet import *  # noqa: F401,F403
from .mobilenet import *  # noqa: F401,F403
from .densenet import *  # noqa: F401,F403
from .inception import *  # noqa: F401,F403
from .resnext import *  # noqa: F401,F403
from .resnest import *  # noqa: F401,F403
from .ssd import *  # noqa: F401,F403
from .yolo import *  # noqa: F401,F403
from .segmentation import *  # noqa: F401,F403
from .rcnn import *  # noqa: F401,F403
from .pose import *  # noqa: F401,F403
from ....base import MXNetError, NotSupportedError

_MODULES = ("resnet", "alexnet", "vgg", "squeezenet", "mobilenet",
            "densenet", "inception", "resnext", "resnest", "ssd", "yolo",
            "segmentation", "rcnn", "pose")
_NON_MODELS = {"heatmap_to_coord"}    # exported utilities, not factories
_MODELS = {}
__all__ = ["get_model"]
for _m in _MODULES:
    _mod = importlib.import_module(f"{__name__}.{_m}")
    __all__ += list(_mod.__all__)
    _MODELS.update({name: getattr(_mod, name) for name in _mod.__all__
                    if name[0].islower() and not name.startswith("get_")
                    and name not in _NON_MODELS})
del _m, _mod


def get_model(name, pretrained=False, root=None, ctx=None, **kwargs):
    """The zoo's model ``name`` (reference ``get_model``; dots and dashes
    in names read as underscores, as there)."""
    name = name.lower().replace("-", "_").replace(".", "_")
    if name not in _MODELS:
        raise MXNetError(f"Model {name} is not supported. Available: "
                         f"{sorted(_MODELS)}")
    if pretrained:
        raise NotSupportedError(
            "pretrained weights: the model store is not ported and nothing "
            "is downloaded; load a local .params file with load_parameters")
    return _MODELS[name](**kwargs)
