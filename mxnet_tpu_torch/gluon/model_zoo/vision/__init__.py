"""``gluon.model_zoo.vision`` (counterpart of
``mxnet_tpu.gluon.model_zoo.vision``): the ResNets so far.

``get_model(name)`` serves ``resnet{18,34,50,101,152}_v{1,2}``; every
other name of the reference's zoo raises ``NotSupportedError`` naming
ROADMAP §1 item 11, where the rest of the zoo arrives, and
``pretrained=True`` raises: no weights are downloaded, and the model
store is not ported (load a local ``.params`` file with
``load_parameters``).
"""
from .resnet import *  # noqa: F401,F403
from . import resnet as _resnet
from ....base import MXNetError, NotSupportedError

_MODELS = {name: getattr(_resnet, name) for name in _resnet.__all__
           if name[0].islower() and not name.startswith("get_")}

# the rest of the reference's zoo (mxnet_tpu/gluon/model_zoo/vision)
_LATER = frozenset("""
alexnet darknet53 densenet121 densenet161 densenet169 densenet201
faster_rcnn_resnet50_v1b inception_v3 mobilenet0_25 mobilenet0_5
mobilenet0_75 mobilenet1_0 mobilenet_v2_0_25 mobilenet_v2_0_5
mobilenet_v2_0_75 mobilenet_v2_1_0 resnest101 resnest200 resnest269
resnest50 resnet101_v1b resnet18_v1b resnet34_v1b resnet50_v1b
resnext101_32x4d resnext101_64x4d resnext50_32x4d se_resnet101
se_resnet50 simple_pose_resnet18_v1b simple_pose_resnet50_v1b
squeezenet1_0 squeezenet1_1 ssd_300_resnet34_v1 ssd_512_resnet50_v1
vgg11 vgg11_bn vgg13 vgg13_bn vgg16 vgg16_bn vgg19 vgg19_bn
yolo3_darknet53
""".split())


def get_model(name, pretrained=False, root=None, ctx=None, **kwargs):
    """The zoo's model ``name`` (reference ``get_model``; dots and dashes
    in names read as underscores, as there)."""
    name = name.lower().replace("-", "_").replace(".", "_")
    if name in _LATER:
        raise NotSupportedError(
            f"model {name!r} is not ported yet: the rest of the model zoo "
            "arrives with ROADMAP §1 item 11")
    if name not in _MODELS:
        raise MXNetError(f"Model {name} is not supported. Available: "
                         f"{sorted(_MODELS)}")
    if pretrained:
        raise NotSupportedError(
            "pretrained weights: the model store is not ported and nothing "
            "is downloaded; load a local .params file with load_parameters")
    return _MODELS[name](**kwargs)


__all__ = list(_resnet.__all__) + ["get_model"]
