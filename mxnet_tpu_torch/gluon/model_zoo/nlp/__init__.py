"""NLP models of the port (counterpart of
``mxnet_tpu.gluon.model_zoo.nlp``)."""
from .llama import (LlamaConfig, LlamaForCausalLM, LlamaModel, RMSNorm,
                    llama3_8b, llama_tiny)

__all__ = ["LlamaConfig", "LlamaModel", "LlamaForCausalLM", "RMSNorm",
           "llama3_8b", "llama_tiny"]
