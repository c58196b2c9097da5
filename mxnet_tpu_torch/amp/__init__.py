"""``mxnet_tpu_torch.amp`` -- automatic mixed precision.

Counterpart of ``mxnet_tpu/amp`` (after MXNet's
``python/mxnet/contrib/amp/amp.py``): ``init``, ``init_trainer``,
``scale_loss``, ``unscale``, ``list_lp16_ops``, ``list_fp32_ops``,
``convert_hybrid_block``, ``convert_model`` and ``LossScaler``, with the
reference's signatures.  The default target dtype is bfloat16, which
needs no loss scaling (the scaler pins to 1); float16 gets the dynamic
scaler.

The policy.  ``init()`` sets a process-wide policy, as the reference's
does (it patches the JAX package's op registry; ``_deinit_for_tests``
undoes either).  It switches on no global autocast: a model opens one
``torch.autocast`` region around its forward body while the policy is
on (:func:`region`; ``LlamaForCausalLM.forward`` does, and so does the
outermost call of a gluon ``Block``).  A region per forward is what
keeps autocast's cache of low-precision weight copies fresh: the cache
lives until the outermost region exits, so under one global region the
forward after an in-place optimizer update would read the last step's
bf16 weights.  Parameters, their gradients and the optimizer state stay
float32; the matmuls' casts are differentiable, so the gradients arrive
in float32.

The gluon path (NDArray ops, ``gluon.nn``, BERT) casts as the
reference does: the op registry of ``ndarray/ops.py`` casts each listed
op's inputs by ``lists.py`` and runs the op with autocast off, so an op
computes in the same dtype on the CPU and on the card.

Where the Llama path's casts differ from ``amp/lists.py``.  Its torch
modules call no registered op, so their casts are autocast's lists, not
the reference's:

- ``TARGET_DTYPE_OPS``: ``FullyConnected``, ``dot``/``batch_dot`` and
  ``Convolution`` are ``linear``, ``matmul``/``bmm`` and ``conv*`` in
  autocast's low-precision lists on the CPU and on CUDA alike, so the
  Llama projections and the LM head run in the target dtype, as the
  reference's ``nn.Dense`` do.
- ``FP32_OPS``: CUDA autocast widens ``softmax``, ``log_softmax``,
  ``exp``, ``log``, ``pow``, ``sum``, ``prod``, ``cumsum`` and the norms
  to float32; CPU autocast (torch 2.13) leaves ``log_softmax`` and most
  of these in bfloat16.  The Llama body does not depend on either list:
  RMSNorm reduces in float32 by its own casts and RoPE's angles are
  float32.  The loss stays outside the region, so on both devices
  ``SoftmaxCrossEntropyLoss`` takes the bf16 logits and computes in
  bf16, as the reference's does (its loss runs through an unlisted
  ``apply_nary``, ``mxnet_tpu/gluon/loss.py:127``).
- ``WIDEST_TYPE_CASTS``: PyTorch's type promotion widens a bf16 + f32
  elementwise op to f32 by itself, as the residual adds do in both
  packages.
- RoPE: the reference's float32 cos/sin widen q and k to float32 (JAX's
  promotion), so its attention takes f32 q, k and bf16 v; the port
  rounds the rotation back to bf16, so flash attention (K3) takes bf16
  q, k and v and runs its bf16 tensor-core kernels on the card.  K3 has
  no float16 kernels: under ``init("float16")`` the card raises
  ``NotSupportedError`` at the kernel (the CPU runs the plain versions).

``convert_model`` works on symbols, which the port does not have yet:
it raises ``NotSupportedError``.
"""
from __future__ import annotations

import contextlib

import torch

from ..base import MXNetError, NotSupportedError
from . import lists
from .loss_scaler import LossScaler

__all__ = ["init", "init_trainer", "scale_loss", "unscale",
           "list_lp16_ops", "list_fp32_ops", "convert_model",
           "convert_hybrid_block", "LossScaler", "region"]

_DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16}
_target_dtype = None          # the policy's dtype name, None when off


def init(target_dtype="bfloat16", target_precision_ops=None,
         conditional_fp32_ops=None, fp32_ops=None):
    """Switch the process-wide mixed-precision policy on (a second call
    changes nothing, as in the reference).  ``target_dtype``:
    ``"bfloat16"`` or ``"float16"``.  The op-list arguments extend the
    reference's registry patch; the port's registry applies the
    reference's own lists and takes no extensions yet, so only None or
    empty lists are taken."""
    global _target_dtype
    if _target_dtype is not None:
        return
    if target_dtype not in _DTYPES:
        raise MXNetError("target_dtype must be bfloat16 or float16")
    for name, ops in (("target_precision_ops", target_precision_ops),
                      ("conditional_fp32_ops", conditional_fp32_ops),
                      ("fp32_ops", fp32_ops)):
        if ops:
            raise NotSupportedError(
                f"amp.init({name}=...): extending the op registry's "
                "lists arrives with ROADMAP §1 item 12")
    _target_dtype = target_dtype


def _deinit_for_tests():
    """Undo :func:`init` (a test helper, not part of the reference API)."""
    global _target_dtype
    _target_dtype = None


_uncached = [0]               # > 0 inside no_cast_cache()


def region(device_type):
    """The forward region of a model body on ``device_type`` (``"cuda"``
    or ``"cpu"``): ``torch.autocast`` to the target dtype while the
    policy is on, else a context that changes nothing.  Inside
    :func:`no_cast_cache` the region keeps no cache of low-precision
    weight copies."""
    if _target_dtype is None:
        return contextlib.nullcontext()
    return torch.autocast(device_type, dtype=_DTYPES[_target_dtype],
                          cache_enabled=not _uncached[0])


@contextlib.contextmanager
def no_cast_cache():
    """Regions opened inside keep no cache of cast weights.  A CUDA
    graph's body needs it (PyTorch requires ``cache_enabled=False`` under
    capture): a bf16 copy cast outside the graph would be read by every
    replay after the float32 weights have moved.
    ``parallel.DataParallelTrainer`` runs its step body inside it, on
    the card and the CPU alike."""
    _uncached[0] += 1
    try:
        yield
    finally:
        _uncached[0] -= 1


def init_trainer(trainer):
    """Attach a loss scaler to a ``gluon.Trainer`` and replace its
    ``step`` (the reference's ``amp.init_trainer``): the gradients are
    rescaled by ``rescale_grad / batch_size / loss_scale``; under the
    dynamic (float16) scaler a step whose gradients are not all finite
    is skipped and its gradients dropped; then the scale is updated.
    bfloat16 gets a static scale of 1 and no overflow check."""
    if _target_dtype is None:
        raise MXNetError("call amp.init() before amp.init_trainer()")
    if _target_dtype == "bfloat16":
        trainer._amp_loss_scaler = LossScaler(init_scale=1.0, dynamic=False)
    else:
        trainer._amp_loss_scaler = LossScaler()

    def step(batch_size, ignore_stale_grad=False):
        scaler = trainer._amp_loss_scaler
        trainer._refresh()
        trainer._optimizer.rescale_grad = \
            trainer._scale / batch_size / scaler.loss_scale
        overflow = scaler._dynamic and scaler.has_overflow(trainer._params)
        if not overflow:
            trainer._update(ignore_stale_grad)
        else:                       # skip the step, drop the gradients
            for p in trainer._params:
                p.grad = None
        scaler.update_scale(overflow)

    trainer.step = step


@contextlib.contextmanager
def scale_loss(loss, trainer):
    """Scale the loss before backward (the reference's
    ``amp.scale_loss``): ``with scale_loss(loss, trainer) as scaled:
    scaled.backward()``."""
    scaler = getattr(trainer, "_amp_loss_scaler", None)
    if scaler is None or scaler.loss_scale == 1.0:
        yield loss
        return
    if isinstance(loss, (list, tuple)):
        yield [l * scaler.loss_scale for l in loss]
    else:
        yield loss * scaler.loss_scale


def unscale(trainer):
    """Divide the present gradients by the loss scale, in place (the
    reference's ``amp.unscale``)."""
    scaler = getattr(trainer, "_amp_loss_scaler", None)
    if scaler is None or scaler.loss_scale == 1.0:
        return
    trainer._refresh()
    grads = [p.grad for p in trainer._params if p.grad is not None]
    if grads:
        torch._foreach_mul_(grads, 1.0 / scaler.loss_scale)


def convert_hybrid_block(block, target_dtype="bfloat16"):
    """Cast a block's parameters to the target dtype in place and return
    it: a gluon ``HybridBlock`` through ``block.cast(target_dtype)``, as
    the reference does, so each Parameter's dtype follows; a torch
    module (the Llama path) through ``.to``, floating-point parameters
    and buffers.  A Trainer built on the block before loses its flat
    parameter buffer's aliasing and says so at its next step."""
    if target_dtype not in _DTYPES:
        raise MXNetError("target_dtype must be bfloat16 or float16")
    if isinstance(block, torch.nn.Module):
        return block.to(_DTYPES[target_dtype])
    block.cast(target_dtype)
    return block


def list_lp16_ops(target_dtype="bfloat16"):
    """The reference's low-precision op names (one table serves bf16 and
    fp16)."""
    return list(lists.TARGET_DTYPE_OPS)


def list_fp32_ops(target_dtype="bfloat16"):
    """The reference's float32-pinned op names (dtype-independent)."""
    return list(lists.FP32_OPS)


def convert_model(sym, arg_params, aux_params, target_dtype="bfloat16",
                  target_dtype_ops=None, fp32_ops=None,
                  conditional_fp32_ops=None, excluded_sym_names=None,
                  cast_optional_params=False):
    """The reference's Module-API conversion of a symbol: refused until
    ``symbol/`` is ported (ROADMAP §1 item 11)."""
    raise NotSupportedError(
        "amp.convert_model converts symbols, which arrive with symbol/ "
        "(ROADMAP §1 item 11); use amp.init() and convert_hybrid_block")
