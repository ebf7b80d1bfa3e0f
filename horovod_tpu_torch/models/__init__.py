"""Models of the port: the dense and MoE Llama family (``llama``), the
BERT encoder (``bert``), ResNet v1.5 (``resnet``), the MNIST MLP
(``mlp``), the JAX parameter converter (``convert``) and KV-cached
decoding (``generate``), with the JAX package's package-level names."""

from horovod_tpu_torch.models.llama import (  # noqa: F401
    LlamaConfig,
    llama_forward,
    llama_init,
    llama_loss,
    llama_partition_rules,
)
from horovod_tpu_torch.models.generate import (  # noqa: F401
    llama_decode_step,
    llama_generate,
    llama_prefill,
)
from horovod_tpu_torch.models.mlp import mlp_forward, mlp_init  # noqa: F401
from horovod_tpu_torch.models.resnet import (  # noqa: F401
    ResNetConfig,
    resnet_forward,
    resnet_init,
    resnet_loss,
    resnet_partition_rules,
)
from horovod_tpu_torch.models.bert import (  # noqa: F401
    BertConfig,
    bert_forward,
    bert_init,
    bert_mlm_loss,
    bert_partition_rules,
)
