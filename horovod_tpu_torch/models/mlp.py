"""Small MLP classifier: the MNIST end-to-end slice's model.

The port of ``horovod_tpu/models/mlp.py``: a list of ``{"w", "b"}``
layers ([fan_in, fan_out] weights), relu between them, plain PyTorch.
"""

import torch

from horovod_tpu_torch._device import resolve_device


def mlp_init(generator, sizes=(784, 128, 64, 10), device=None):
    """Random f32 layers with JAX's ``mlp_init`` shapes (weights
    N(0, 1/fan_in), zero biases; the values differ from JAX's), drawn on
    ``generator``'s device and moved to ``device`` (default cuda)."""
    dev = resolve_device(device)
    params = []
    for fan_in, fan_out in zip(sizes[:-1], sizes[1:]):
        w = torch.randn((fan_in, fan_out), generator=generator,
                        dtype=torch.float32, device=generator.device)
        params.append({"w": w.mul_(fan_in ** -0.5).to(dev),
                       "b": torch.zeros(fan_out, device=dev)})
    return params


def mlp_forward(params, x):
    """x [..., sizes[0]] -> logits [..., sizes[-1]] on the params'
    device."""
    x = torch.as_tensor(x, device=params[0]["w"].device)
    for layer in params[:-1]:
        x = torch.relu(x @ layer["w"] + layer["b"])
    last = params[-1]
    return x @ last["w"] + last["b"]
