"""Models of the port: the dense and MoE Llama family (``llama``), the
BERT encoder (``bert``), the JAX parameter converter (``convert``) and
KV-cached decoding (``generate``)."""
