"""Models of the port: the dense and MoE Llama family (``llama``), the
BERT encoder (``bert``), ResNet v1.5 (``resnet``), the MNIST MLP
(``mlp``), the JAX parameter converter (``convert``) and KV-cached
decoding (``generate``)."""

from horovod_tpu_torch.models.mlp import mlp_forward, mlp_init  # noqa: F401
from horovod_tpu_torch.models.resnet import (  # noqa: F401
    ResNetConfig,
    resnet_forward,
    resnet_init,
    resnet_loss,
)
