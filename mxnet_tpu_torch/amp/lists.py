"""AMP op lists: the port's own copy of ``mxnet_tpu/amp/lists.py``.

Three classes, MXNet's scheme (the reference's
``python/mxnet/contrib/amp/lists/symbol.py``):

- ``TARGET_DTYPE_OPS``: run in the low-precision target dtype;
- ``FP32_OPS``: numerically sensitive, inputs cast up to float32;
- ``WIDEST_TYPE_CASTS``: multi-input ops whose inputs are cast to the
  widest dtype among them.

Everything unlisted runs in whatever dtype arrives.  The op registry of
``ndarray/ops.py`` (``_register``) casts each listed op's inputs by
these lists; they are also what ``amp.list_lp16_ops`` /
``list_fp32_ops`` return.  Torch modules outside the registry (Llama)
cast by ``torch.autocast``'s lists (see ``amp/__init__.py`` for where
the two differ).
"""

# matmuls, convolutions, rnn: the fp16 whitelist of the reference
TARGET_DTYPE_OPS = [
    "FullyConnected", "Convolution", "Deconvolution", "dot", "batch_dot",
    "linalg_gemm2", "RNN",
]

# the reference's fp32 blacklist: softmax family, norms, losses, exp/log/pow
FP32_OPS = [
    "softmax", "log_softmax", "softmin", "SoftmaxActivation", "SoftmaxOutput",
    "softmax_cross_entropy", "BatchNorm", "LayerNorm", "InstanceNorm",
    "L2Normalization", "norm", "exp", "log", "log2", "log10", "expm1",
    "log1p", "erf", "gamma", "gammaln", "smooth_l1", "mean", "sum", "nansum",
    "prod", "nanprod", "cumsum",
]

WIDEST_TYPE_CASTS = [
    "add_n", "concat", "stack", "where", "broadcast_add", "broadcast_sub",
    "broadcast_mul", "broadcast_div",
]
