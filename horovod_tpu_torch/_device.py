"""The port's device rules.

Entry points run on the card unless the caller asks for the CPU. With
no device given and no CUDA they raise: a run that silently fell back
to the CPU would report CPU numbers under a GPU's name. Below them, an
op runs its kernel for CUDA tensors and its plain PyTorch version only
for CPU tensors (:func:`kernel_or_plain`), and a kernel with two
routes picks one from the dtype alone (:func:`dtype_route`,
:func:`pick_route`).
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


def kernel_or_plain(label, x, kernel, plain, *args):
    """``kernel(x, *args)`` for a CUDA tensor ``x``, ``plain(x, *args)``
    for a CPU tensor, an error for anything else: never a fallback from
    one to the other. ``label`` names the op in the error."""
    if x.is_cuda:
        return kernel(x, *args)
    if x.device.type == "cpu":
        return plain(x, *args)
    raise ValueError(f"{label} has no path for {x.device}")


def dtype_route(kernel, dtype):
    """The route of a two-kernel op for ``dtype``: ``"wgmma"`` (the
    tensor-core kernel) for bfloat16, ``"fma"`` for float32; a ValueError
    for anything else. ``kernel`` names the op in the error."""
    if dtype == torch.bfloat16:
        return "wgmma"
    if dtype == torch.float32:
        return "fma"
    raise ValueError(f"{kernel} has no kernel for {dtype}: it takes float32 "
                     f"(fma) or bfloat16 (wgmma)")


def pick_route(kernel, dtype, want, route=None):
    """``route`` if given ("fma" also takes bfloat16: the earlier kernel,
    kept as the wgmma kernel's yardstick), else ``want``, the dtype's
    route; a ValueError for a route that does not take ``dtype``."""
    route = route or want
    if route not in ("wgmma", "fma") or (route == "wgmma" and
                                         want != "wgmma"):
        raise ValueError(f"{kernel} route {route!r} does not take {dtype}")
    return route
