"""NLP models of the port (counterpart of
``mxnet_tpu.gluon.model_zoo.nlp``): the attention cells, BERT, the
Transformer, the language models (``StandardRNN``, ``AWDRNN``), the
sequence samplers and Llama.

``get_model(name)`` serves the BERT, Transformer and language-model
constructors; ``pretrained=True`` raises: no weights are downloaded, and
the model store is not ported (load a local ``.params`` file with
``load_parameters``).
"""
from .attention import DotProductAttention, MultiHeadAttention
from .bert import (BERTEncoder, BERTModel, bert_12_768_12, bert_24_1024_16,
                   get_bert_model)
from .llama import (LlamaConfig, LlamaForCausalLM, LlamaModel, RMSNorm,
                    llama3_8b, llama_tiny)
from .sampler import BeamSearchSampler, BeamSearchScorer, SequenceSampler
from .transformer import (TransformerDecoder, TransformerEncoder,
                          TransformerModel, positional_encoding,
                          transformer_en_de_512)
from .language_model import (AWDRNN, StandardRNN, awd_lstm_lm_600,
                             awd_lstm_lm_1150, standard_lstm_lm_200,
                             standard_lstm_lm_650, standard_lstm_lm_1500)
from . import (bert as _bert, transformer as _transformer,
               language_model as _language_model)
from ....base import MXNetError, NotSupportedError

_MODELS = {name: getattr(m, name)
           for m in (_bert, _transformer, _language_model)
           for name in m.__all__
           if name[0].islower() and not name.startswith(("get_",
                                                         "positional_"))}


def get_model(name, pretrained=False, root=None, ctx=None, **kwargs):
    """The zoo's model ``name`` (reference ``gluonnlp.model.get_model``),
    built with ``kwargs``."""
    if name not in _MODELS:
        raise MXNetError(f"Model {name!r} is not present in the NLP model "
                         f"zoo; available: {sorted(_MODELS)}")
    if pretrained:
        raise NotSupportedError(
            "pretrained weights: the model store is not ported and nothing "
            "is downloaded; load a local .params file with load_parameters")
    return _MODELS[name](**kwargs)


__all__ = ["DotProductAttention", "MultiHeadAttention", "BERTEncoder",
           "BERTModel", "get_bert_model", "bert_12_768_12",
           "bert_24_1024_16", "LlamaConfig", "LlamaModel",
           "LlamaForCausalLM", "RMSNorm", "llama3_8b", "llama_tiny",
           "BeamSearchScorer", "BeamSearchSampler", "SequenceSampler",
           "TransformerEncoder", "TransformerDecoder", "TransformerModel",
           "transformer_en_de_512", "positional_encoding", "StandardRNN",
           "AWDRNN", "standard_lstm_lm_200", "standard_lstm_lm_650",
           "standard_lstm_lm_1500", "awd_lstm_lm_1150", "awd_lstm_lm_600",
           "get_model"]
