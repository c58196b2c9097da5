"""INT8 post-training quantization.

Counterpart of ``mxnet_tpu/contrib/quantization.py`` (after MXNet's
``python/mxnet/contrib/quantization.py``): calibrate the activation
ranges of a Gluon net's ``Dense`` and ``Conv2D`` layers (naive min/max
or KL entropy), then swap those layers for int8 twins in place.
Weights are quantized per output channel, symmetric (``amax / 127``,
floored at 1e-8); activations per tensor from the calibrated threshold
(``threshold / 127``).  The int8 x int8 -> int32 product is
``ops.quant_matmul.int8_matmul``: cuBLASLt's int8 GEMM on the card, an
exact int32 product on the CPU (the reference computes it in XLA, so it
is a plain matrix product here too, not a ported kernel).

``QuantizedDense`` quantizes its input at the activation scale, takes
the int32 product with the weight codes, then rescales in f32
(``acc * (act_scale * w_scale)``), adds the bias, applies relu and
honours ``flatten``, op for op as the reference.  Its output is f32
whatever the input's dtype, as the reference's.  ``QuantizedConv2D``
runs the same product over im2col patches (``F.unfold``), with the
patch length zero-padded to a multiple of 8 on the card (exact: the
padded codes are 0).

``quantize_model`` (the Module API's symbol surgery) raises with the
reference's recipe: quantize a Gluon block with ``quantize_net``.
"""
from __future__ import annotations

import numpy as _np
import torch
import torch.nn.functional as F_

from .. import _tape
from ..base import MXNetError
from ..gluon import nn
from ..gluon.block import HybridBlock
from ..ndarray.ndarray import NDArray, apply
from ..ops.quant_matmul import int8_matmul, quantize_rtn_int8

__all__ = ["quantize_net", "quantize_model", "calib_thresholds",
           "QuantizedDense", "QuantizedConv2D", "optimal_threshold_kl"]


def _quant_params_symmetric(w, axis=None):
    """Symmetric int8 codes and scale of ``w`` (f32): ``s = max(amax,
    1e-8) / 127`` per slice over ``axis`` (kept as size-1 dims), or one
    scale for the whole tensor."""
    a = w.abs()
    amax = a.amax(dim=axis, keepdim=True) if axis is not None else a.max()
    scale = torch.clamp_min(amax, 1e-8) / 127.0
    return quantize_rtn_int8(w, scale), scale


def optimal_threshold_kl(hist, hist_edges, num_quantized_bins=255):
    """KL-divergence calibration threshold (reference
    ``_get_optimal_threshold``): the clip threshold whose quantized
    distribution best matches the histogram.  numpy, on the host."""
    hist = _np.asarray(hist, dtype=_np.float64)
    num_bins = len(hist)
    if num_bins < num_quantized_bins + 2:
        return float(hist_edges[-1])
    zero_bin = num_bins // 2
    best_kl, best_t = _np.inf, float(hist_edges[-1])
    # threshold sweep: symmetric windows growing from the center
    for i in range(num_quantized_bins // 2 + 1, num_bins // 2 + 1):
        lo, hi = zero_bin - i, zero_bin + i
        p = hist[lo:hi].copy()
        if p.sum() == 0:
            continue
        p[0] += hist[:lo].sum()
        p[-1] += hist[hi:].sum()
        # quantize p into num_quantized_bins, then expand back
        factor = len(p) / num_quantized_bins
        q = _np.zeros_like(p)
        for j in range(num_quantized_bins):
            start = int(j * factor)
            stop = max(int((j + 1) * factor), start + 1)
            chunk = p[start:stop]
            nz = (chunk > 0).sum()
            if nz:
                q[start:stop] = _np.where(chunk > 0, chunk.sum() / nz, 0)
        pm = p / p.sum()
        qm = q / q.sum() if q.sum() else q
        mask = (pm > 0) & (qm > 0)
        if not mask.any():
            continue
        kl = float((pm[mask] * _np.log(pm[mask] / qm[mask])).sum())
        if kl < best_kl:
            best_kl = kl
            best_t = float(hist_edges[hi])
    return best_t


class _Collector:
    """Forward-pre-hook activation range collector.  Naive mode reduces
    each input's min and max on its device, with one host read a call;
    entropy mode takes the reference's histogram of the input over
    ``[-amax, amax]`` on the host, in float64."""

    def __init__(self, mode="naive", num_bins=2001):
        self.mode = mode
        self.num_bins = num_bins
        self.ranges = {}      # block -> (min, max)
        self.hists = {}       # block -> (histogram, edges)

    def hook(self, block):
        def pre_hook(blk, args):
            x = args[0]
            x = x.data if isinstance(x, NDArray) else torch.as_tensor(x)
            if self.mode == "naive":
                lo, hi = torch.stack([x.min(), x.max()]).double().tolist()
                old = self.ranges.get(blk)
                if old:
                    lo, hi = min(lo, old[0]), max(hi, old[1])
                self.ranges[blk] = (lo, hi)
                return
            v = x.detach().to("cpu", torch.float64).numpy()
            amax = float(_np.abs(v).max()) or 1e-8
            hist, edges = _np.histogram(v, bins=self.num_bins,
                                        range=(-amax, amax))
            old = self.hists.get(blk)
            if old is not None and len(old[0]) == len(hist) and \
                    old[1][-1] >= edges[-1]:
                self.hists[blk] = (old[0] + hist, old[1])
            else:
                self.hists[blk] = (hist, edges)
        return pre_hook

    def threshold(self, blk):
        if self.mode == "naive":
            lo, hi = self.ranges[blk]
            return max(abs(lo), abs(hi))
        hist, edges = self.hists[blk]
        return optimal_threshold_kl(hist, edges)


class _QuantizedLayer(HybridBlock):
    """Codes, scales and bias of an int8 twin (not Parameters, as in the
    reference: ``collect_params`` and ``save_parameters`` skip them)."""

    def _init_quant(self, weight, bias, act_threshold, axis):
        w = weight.data().data.detach().float()
        self._qw, self._w_scale = _quant_params_symmetric(w, axis=axis)
        self._bias = None if bias is None else bias.data().data.detach()
        self._set_act_scale(float(act_threshold) / 127.0)

    def _set_act_scale(self, act_scale):
        self._act_scale = float(act_scale)
        # the f32 scale every product reads (the reference's python float
        # enters its f32 ops as f32), written in place once it exists: an
        # engine's steps and graphs read this tensor
        if hasattr(self, "_as"):
            self._as.fill_(self._act_scale)
        else:
            self._as = torch.tensor(self._act_scale, dtype=torch.float32,
                                    device=self._qw.device)

    @property
    def quantized_weight(self):
        """int8 weight codes."""
        return self._qw

    @property
    def weight_scale(self):
        """Per-output-channel f32 dequantization scale (size-1 dims
        kept)."""
        return self._w_scale

    @property
    def act_scale(self):
        """Scalar activation quantization scale (threshold / 127)."""
        return self._act_scale


class QuantizedDense(_QuantizedLayer):
    """int8 x int8 -> int32 Dense (reference: quantized_fully_connected):
    ``(units, in)`` int8 codes, ``(units, 1)`` f32 scales, one activation
    scale."""

    def __init__(self, dense, act_threshold, **kwargs):
        super().__init__(**kwargs)
        self._init_quant(dense.weight, dense.bias, act_threshold, 1)
        self._units = getattr(dense, "_units", self._qw.shape[0])
        self._act_type = getattr(dense, "_act_type", None)
        self._flatten = getattr(dense, "_flatten", True)

    def hybrid_forward(self, F, x):
        qw, ws, a = self._qw, self._w_scale, self._as
        bias, act, flatten = self._bias, self._act_type, self._flatten

        def quantized_dense(d):
            # flatten=False (sequence models) quantizes over the last
            # axis only, keeping the leading dims, as the float layer
            lead = d.shape[:1] if flatten else d.shape[:-1]
            flat = d.reshape(d.shape[0], -1) if flatten \
                else d.reshape(-1, d.shape[-1])
            acc = int8_matmul(quantize_rtn_int8(flat, a), qw)
            out = acc.float() * (a * ws.reshape(1, -1))
            if bias is not None:
                out = out + bias
            if act == "relu":
                out = torch.clamp_min(out, 0)
            return out.reshape(lead + (out.shape[-1],))
        return apply(quantized_dense, [x])

    def __repr__(self):
        return (f"QuantizedDense({self._qw.shape[1]} -> {self._units}, "
                f"int8)")


class QuantizedConv2D(_QuantizedLayer):
    """int8 convolution with int32 accumulation (reference:
    quantized_conv): im2col patches of the input, quantized, against the
    ``(O, I, kh, kw)`` int8 codes, one product per group."""

    def __init__(self, conv, act_threshold, **kwargs):
        super().__init__(**kwargs)
        self._init_quant(conv.weight, getattr(conv, "bias", None),
                         act_threshold, (1, 2, 3))
        kw = dict(getattr(conv, "_kwargs", {}))
        self._stride = tuple(kw.get("stride", (1, 1)))
        self._pad = tuple(kw.get("pad", (0, 0)))
        self._dilate = tuple(kw.get("dilate", (1, 1)))
        self._groups = kw.get("num_group", 1)

    def hybrid_forward(self, F, x):
        qw, ws, a, bias = self._qw, self._w_scale, self._as, self._bias
        stride, pad, dilate, groups = (self._stride, self._pad,
                                       self._dilate, self._groups)
        O, I, kh, kw = qw.shape
        og = O // groups

        def quantized_conv(d):
            n, _, h, w = d.shape
            ho = (h + 2 * pad[0] - dilate[0] * (kh - 1) - 1) // stride[0] + 1
            wo = (w + 2 * pad[1] - dilate[1] * (kw - 1) - 1) // stride[1] + 1
            outs = []
            for g in range(groups):
                # (N, I*kh*kw, L) patches; the zero padding quantizes to 0
                cols = F_.unfold(d[:, g * I:(g + 1) * I].float(), (kh, kw),
                                 dilation=dilate, padding=pad, stride=stride)
                qx = quantize_rtn_int8(cols.transpose(1, 2)
                                       .reshape(n * ho * wo, -1), a)
                qg = qw[g * og:(g + 1) * og].reshape(og, -1)
                k = qx.shape[1]
                if qx.is_cuda and k % 8:
                    qx = F_.pad(qx, (0, -k % 8))
                    qg = F_.pad(qg, (0, -k % 8))
                outs.append(int8_matmul(qx, qg.contiguous()))
            acc = torch.cat(outs, dim=1) if groups > 1 else outs[0]
            acc = acc.reshape(n, ho, wo, O).permute(0, 3, 1, 2)
            out = acc.float() * (a * ws.reshape(1, -1, 1, 1))
            if bias is not None:
                out = out + bias.reshape(1, -1, 1, 1)
            return out.contiguous()
        return apply(quantized_conv, [x])

    def __repr__(self):
        return f"QuantizedConv2D({self._qw.shape[1]} -> {self._qw.shape[0]}" \
            ", int8)"


def _walk(block):
    yield block
    for child in block._children.values():
        yield from _walk(child)


def calib_thresholds(net, calib_data, calib_mode="naive", num_batches=10):
    """Run calibration forwards (predict mode, nothing recorded) and
    return ``{block: threshold}`` for every ``Dense`` and ``Conv2D`` the
    batches reached."""
    collector = _Collector(mode="naive" if calib_mode == "naive"
                           else "entropy")
    targets = [b for b in _walk(net) if isinstance(b, (nn.Dense, nn.Conv2D))]
    handles = []
    for b in targets:
        h = collector.hook(b)
        b._forward_pre_hooks.append(h)
        handles.append((b, h))
    prev = _tape.set_training(False)
    try:
        for i, batch in enumerate(calib_data):
            if i >= num_batches:
                break
            net(batch[0] if isinstance(batch, (tuple, list)) else batch)
    finally:
        _tape.set_training(prev)
        for b, h in handles:
            b._forward_pre_hooks.remove(h)
    return {b: collector.threshold(b) for b in targets
            if b in collector.ranges or b in collector.hists}


def quantize_net(network, calib_data=None, calib_mode="naive",
                 quantized_dtype="int8", exclude_layers=None,
                 num_calib_batches=10):
    """Quantize a Gluon net in place (reference
    ``quantization.quantize_net``): every ``Dense``/``Conv2D`` child the
    calibration reached becomes its int8 twin; children named in
    ``exclude_layers`` (by attribute name) and blocks the batches never
    reached keep their float weights.  Returns ``network``."""
    if quantized_dtype not in ("int8", "auto"):
        raise MXNetError("only int8 quantization is supported (uint8 buys "
                         "nothing over int8 here)")
    if calib_data is None:
        raise MXNetError("calib_data is required (post-training "
                         "calibration)")
    exclude = set(exclude_layers or [])
    thresholds = calib_thresholds(network, calib_data, calib_mode,
                                  num_calib_batches)

    def convert(block):
        for name, child in list(block._children.items()):
            if child in thresholds and name not in exclude and \
                    child.weight._nd is not None:
                if isinstance(child, nn.Dense):
                    q = QuantizedDense(child, thresholds[child])
                elif isinstance(child, nn.Conv2D):
                    q = QuantizedConv2D(child, thresholds[child])
                else:
                    continue
                block._children[name] = q
                if hasattr(block, name):
                    object.__setattr__(block, name, q)
            else:
                convert(child)
    convert(network)
    return network


def quantize_model(sym, arg_params, aux_params, data_names=("data",),
                   calib_data=None, calib_mode="naive",
                   quantized_dtype="int8", **kwargs):
    """The reference's Module-API PTQ, which raises with its recipe:
    quantize a Gluon block instead."""
    raise MXNetError(
        "quantize_model: use quantize_net on a Gluon block instead - "
        "load the checkpoint into gluon (e.g. the model zoo), then "
        "contrib.quantization.quantize_net(net, calib_data=...). This "
        "build quantizes at the block level (an int8 x int8 -> int32 "
        "product), not by symbol-graph surgery.")

