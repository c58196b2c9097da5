"""Carry weights across from the JAX package into the port.

Gluon blocks (BERT and any port ``Block``): ``load_block_weights(block,
arrays)`` copies a dict of numpy arrays keyed by the structural names of
``block._collect_params_with_prefix()`` (``encoder.transformer_cells.0.
attention.proj_query.weight``, ...; the same names in both packages)
into the block's parameters, checking each shape and finishing deferred
parameters with the array's shape on their initialize context;
``block_weights_to_numpy(block)`` is the reverse.  The file route is
``nd.save``/``load_parameters``: the JAX package's ``save_parameters``
writes a file the port's ``load_parameters`` reads, and the reverse.

The Llama path:

``load_llama_decode_weights(model, arrays)`` takes the structure the
reference's ``LlamaForCausalLM.decode_weights()`` returns, as numpy
arrays::

    (embed, final_norm, lm_head | None,
     [(in_norm, q, k, v, o, post_norm, gate, up, down), ...])

and copies it into the port's modules.  Dense weights are ``(out, in)``
in both packages (``x @ w.T``), so every array copies as it is; dtype
conversion happens in the copy.  ``llama_decode_weights_to_numpy(model)``
is the inverse: the port's parameters in that structure, as float32
numpy arrays, for comparing against the reference after training.
"""
from __future__ import annotations

import numpy as np
import torch

from .base import MXNetError

__all__ = ["load_block_weights", "block_weights_to_numpy",
           "load_llama_decode_weights", "llama_decode_weights_to_numpy"]

_LAYER_NAMES = ("in_norm", "q", "k", "v", "o", "post_norm", "gate", "up",
                "down")


def _copy(dst, src, name):
    arr = np.asarray(src)
    if tuple(arr.shape) != tuple(dst.shape):
        raise MXNetError(f"{name}: shape {tuple(arr.shape)} does not match "
                         f"the port's {tuple(dst.shape)}")
    dst.copy_(torch.from_numpy(np.array(arr, dtype=np.float32)))


@torch.no_grad()
def load_llama_decode_weights(model, arrays):
    """Copy the reference's decode-weight structure ``arrays`` into
    ``model`` (a port ``LlamaForCausalLM``) in place; returns ``model``."""
    embed, norm, head, layers = arrays
    dst_embed, dst_norm, dst_head, dst_layers = model.decode_weights()
    if (head is None) != (dst_head is None):
        raise MXNetError("lm_head: tie_embeddings differs between the "
                         "source weights and the port's config")
    if len(layers) != len(dst_layers):
        raise MXNetError(f"{len(layers)} source layers vs the port's "
                         f"{len(dst_layers)}")
    _copy(dst_embed, embed, "embed")
    _copy(dst_norm, norm, "final_norm")
    if head is not None:
        _copy(dst_head, head, "lm_head")
    for i, (src, dst) in enumerate(zip(layers, dst_layers)):
        for name, s, d in zip(_LAYER_NAMES, src, dst):
            _copy(d, s, f"layer {i} {name}")
    return model


@torch.no_grad()
def llama_decode_weights_to_numpy(model):
    """The port ``LlamaForCausalLM``'s parameters in the reference's
    decode-weight structure, as float32 numpy arrays (host copies)."""
    def arr(t):
        return t.detach().to("cpu", torch.float32, copy=True).numpy()
    embed, norm, head, layers = model.decode_weights()
    return (arr(embed), arr(norm), None if head is None else arr(head),
            [tuple(arr(w) for w in layer) for layer in layers])


@torch.no_grad()
def load_block_weights(block, arrays):
    """Copy ``arrays`` (structural name -> numpy array) into the gluon
    ``block``'s parameters in place; every parameter must be named and
    every name must be a parameter.  A deferred parameter takes the
    array's shape (which must agree with what is known of it) and is
    allocated on its initialize context.  Returns ``block``."""
    params = block._collect_params_with_prefix()
    missing = sorted(set(params) - set(arrays))
    extra = sorted(set(arrays) - set(params))
    if missing or extra:
        raise MXNetError(f"load_block_weights: missing {missing}, "
                         f"unknown {extra}")
    for name, param in params.items():
        arr = np.asarray(arrays[name])
        have = param.shape if param._nd is None else \
            tuple(param._var.shape)
        if have is None or len(have) != arr.ndim or any(
                h > 0 and h != a for h, a in zip(have, arr.shape)):
            raise MXNetError(f"{name}: shape {tuple(arr.shape)} does not "
                             f"match the port's {have}")
        if param._nd is None and param._deferred_init is None:
            raise MXNetError(f"{name}: initialize the block before loading "
                             "weights into it")
        param.set_data(arr)
    return block


@torch.no_grad()
def block_weights_to_numpy(block):
    """The gluon ``block``'s initialized parameters by structural name,
    as float32 numpy arrays (host copies)."""
    return {name: p.data().data.detach().to("cpu", torch.float32,
                                              copy=True).numpy()
            for name, p in block._collect_params_with_prefix().items()
            if p._nd is not None}
