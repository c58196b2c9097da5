"""Model zoo of the port (counterpart of ``mxnet_tpu.gluon.model_zoo``)."""
