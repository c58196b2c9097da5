"""NLP models of the port (counterpart of
``mxnet_tpu.gluon.model_zoo.nlp``): the attention cells, BERT and
Llama."""
from .attention import DotProductAttention, MultiHeadAttention
from .bert import (BERTEncoder, BERTModel, bert_12_768_12, bert_24_1024_16,
                   get_bert_model)
from .llama import (LlamaConfig, LlamaForCausalLM, LlamaModel, RMSNorm,
                    llama3_8b, llama_tiny)

__all__ = ["DotProductAttention", "MultiHeadAttention", "BERTEncoder",
           "BERTModel", "get_bert_model", "bert_12_768_12",
           "bert_24_1024_16", "LlamaConfig", "LlamaModel",
           "LlamaForCausalLM", "RMSNorm", "llama3_8b", "llama_tiny"]
