"""The port's default-device rule.

Entry points run on the card unless the caller asks for the CPU. With
no device given and no CUDA they raise: a run that silently fell back
to the CPU would report CPU numbers under a GPU's name.
"""

import torch


def resolve_device(device=None):
    """``device`` as a ``torch.device``; ``None`` means ``cuda``."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device available: pass device='cpu' to run the "
            "plain PyTorch path on the CPU")
    return torch.device("cuda")


def check_on(device, **tensors):
    """Raise unless every tensor lies on ``device``."""
    for name, t in tensors.items():
        if t.device.type != device.type or (
                device.index is not None and t.device != device):
            raise ValueError(f"{name} lies on {t.device}, expected "
                             f"{device}")


def on_device(params, device, **tensors):
    """An entry point's device rule: resolve ``device``, check the
    params lie there and move the other inputs to it (None stays None).
    Returns (device, {name: tensor})."""
    dev = resolve_device(device)
    check_on(dev, embed=params["embed"])
    return dev, {k: None if t is None else torch.as_tensor(t, device=dev)
                 for k, t in tensors.items()}
