"""Carry weights across from the JAX package into the port.

Gluon blocks (BERT and any port ``Block``): ``load_block_weights(block,
arrays)`` copies a dict of numpy arrays keyed by the structural names of
``block._collect_params_with_prefix()`` (``encoder.transformer_cells.0.
attention.proj_query.weight``, ...; the same names in both packages)
into the block's parameters, checking each shape and finishing deferred
parameters with the array's shape on their initialize context;
``block_weights_to_numpy(block)`` is the reverse.  The fused recurrent
layers (``gluon.rnn.RNN``/``LSTM``/``GRU``) carry their per-layer names
(``l0_i2h_weight`` ... ``r1_h2h_bias``) the same way, and
``rnn_packed_vector(layer)`` lays them out as ``nd.RNN``'s packed vector
(all weights by layer, then direction, then all biases).  The file route is
``nd.save``/``load_parameters``: the JAX package's ``save_parameters``
writes a file the port's ``load_parameters`` reads, and the reverse.

Llama's decode-weight structure (``decode_weights()``, which the
engine and ``generate`` read):

``load_llama_decode_weights(model, arrays)`` takes the structure the
reference's ``LlamaForCausalLM.decode_weights()`` returns, as numpy
arrays::

    (embed, final_norm, lm_head | None,
     [(in_norm, q, k, v, o, post_norm, gate, up, down), ...])

and copies it into the port's parameters.  Dense weights are ``(out, in)``
in both packages (``x @ w.T``), so every array copies as it is; dtype
conversion happens in the copy.  ``llama_decode_weights_to_numpy(model)``
is the inverse: the port's parameters in that structure, as float32
numpy arrays, for comparing against the reference after training.

Quantized nets: ``quantized_state(block)`` reads every int8 twin of a
block tree (``QuantizedDense``/``QuantizedConv2D`` of either package,
whose codes, scales and activation scale both keep in ``_qw``,
``_w_scale`` and ``_act_scale``)
as ``{structural path: (int8 codes, f32 scales, act_scale)}`` in numpy,
the path being the child's attribute chain (``model.layers.0.attention.
q_proj``, ``lm_head``).  ``load_quantized_state(net, state)`` puts those
codes and scales into the port's net: a float ``Dense`` or ``Conv2D`` at
a path becomes its int8 twin, an existing twin is overwritten in place.
Parity tests then compare one set of codes and scales, never two
calibrations.
"""
from __future__ import annotations

import numpy as np
import torch

from .base import MXNetError

__all__ = ["load_block_weights", "block_weights_to_numpy",
           "rnn_packed_vector",
           "load_llama_decode_weights", "llama_decode_weights_to_numpy",
           "quantized_state", "load_quantized_state"]

_LAYER_NAMES = ("in_norm", "q", "k", "v", "o", "post_norm", "gate", "up",
                "down")


def _copy(dst, src, name):
    """``src`` into the Parameter ``dst`` (in place, or allocated where
    ``dst`` is placed)."""
    arr = np.asarray(src)
    if tuple(arr.shape) != tuple(dst.shape):
        raise MXNetError(f"{name}: shape {tuple(arr.shape)} does not match "
                         f"the port's {tuple(dst.shape)}")
    dst.set_data(torch.from_numpy(np.array(arr, dtype=np.float32)))


@torch.no_grad()
def load_llama_decode_weights(model, arrays):
    """Copy the reference's decode-weight structure ``arrays`` into
    ``model`` (a port ``LlamaForCausalLM``) in place; returns ``model``."""
    embed, norm, head, layers = arrays
    dst_embed, dst_norm, dst_head, dst_layers = model._decode_params()
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
        if param._nd is None and param._deferred_init is None and \
                param._ctx is None:
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


@torch.no_grad()
def rnn_packed_vector(layer):
    """A fused recurrent layer's parameters as ``nd.RNN``'s packed 1-D
    vector (float32 numpy): for each layer and then direction
    ``W_i2h, W_h2h``, then the biases ``b_i2h, b_h2h`` in the same
    order."""
    names = layer._param_list()
    order = [n for n in names if n.endswith("weight")] + \
        [n for n in names if n.endswith("bias")]
    return np.concatenate([
        layer._reg_params[n].data().data.detach().to(
            "cpu", torch.float32).reshape(-1).numpy() for n in order])


def _quantized_children(block, prefix=""):
    for name, child in block._children.items():
        path = prefix + name
        if hasattr(child, "_qw"):
            yield path, child
        else:
            yield from _quantized_children(child, path + ".")


def quantized_state(block):
    """Every int8 twin under ``block`` (either package's) by structural
    path: ``(codes int8, scales f32, act_scale float)`` as numpy."""
    return {path: (np.array(q._qw, dtype=np.int8),
                   np.array(q._w_scale, dtype=np.float32),
                   float(q._act_scale))
            for path, q in _quantized_children(block)}


@torch.no_grad()
def load_quantized_state(net, state):
    """Put ``state`` (:func:`quantized_state`'s layout) into the port's
    ``net``: each path's float ``Dense``/``Conv2D`` becomes its int8 twin
    with these codes and scales (an existing twin is overwritten in
    place); the bias stays the layer's own.  Returns ``net``."""
    from .contrib.quantization import QuantizedConv2D, QuantizedDense
    from .gluon import nn
    for path, (codes, scales, act_scale) in state.items():
        *parents, name = path.split(".")
        block = net
        for part in parents:
            block = block._children[part]
        child = block._children.get(name)
        if child is None:
            raise MXNetError(f"load_quantized_state: no block at {path}")
        if not hasattr(child, "_qw"):
            twin = QuantizedDense if isinstance(child, nn.Dense) else \
                QuantizedConv2D if isinstance(child, nn.Conv2D) else None
            if twin is None:
                raise MXNetError(f"load_quantized_state: {path} is a "
                                 f"{type(child).__name__}, not a Dense or "
                                 "Conv2D")
            q = twin(child, 1.0)
            block._children[name] = q
            object.__setattr__(block, name, q)
            child = q
        for dst, src, what in ((child._qw, codes, "codes"),
                               (child._w_scale, scales, "scales")):
            src = np.asarray(src)
            if tuple(src.shape) != tuple(dst.shape):
                raise MXNetError(f"{path} {what}: shape {tuple(src.shape)} "
                                 f"does not match the port's "
                                 f"{tuple(dst.shape)}")
            dst.copy_(torch.from_numpy(np.ascontiguousarray(src)))
        child._set_act_scale(act_scale)
    return net
