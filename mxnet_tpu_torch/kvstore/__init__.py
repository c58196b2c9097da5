"""``mx.kv`` (counterpart of ``mxnet_tpu/kvstore``; reference
python/mxnet/kvstore.py)."""
from .kvstore import (KVStore, KVStoreLocal, KVStoreTPUSync,
                      KVStoreDistTPUSync, GradientCompression,
                      Int8GradientCompression, create)
from .horovod import KVStoreHorovod, KVStoreBytePS
