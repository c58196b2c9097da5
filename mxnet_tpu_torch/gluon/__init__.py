"""Gluon-style model code of the port (counterpart of ``mxnet_tpu.gluon``):
so far the Llama model zoo entry the serving slice runs."""
