"""Model and optimizer state broadcast, object broadcast and gather.

Counterpart of ``horovod_tpu/torch/functions.py``:
``broadcast_parameters:15`` (which here also takes the port's nested
Llama param dict), ``broadcast_optimizer_state:35``,
``broadcast_object:87`` and ``allgather_object:106``. Objects travel
pickled, as CPU byte tensors; they are unpickled only from this
program's own ranks.
"""

import io
import pickle

import numpy as np
import torch

from horovod_tpu_torch.torch import mpi_ops


def _named_tensors(params, prefix=""):
    """(name, tensor) pairs of a ``state_dict``, of a nested tree of
    dicts and lists of tensors (the port's Llama params: ``layers/wq``
    ...; the ResNet's: ``stage0/1/conv2`` ...), or of an iterable of pairs
    (``named_parameters()``)."""
    items = params.items() if hasattr(params, "items") else params
    out = []
    for name, p in items:
        if isinstance(p, list):
            p = {str(i): v for i, v in enumerate(p)}
        if isinstance(p, dict):
            out += _named_tensors(p, f"{prefix}{name}/")
        elif torch.is_tensor(p):
            out.append((f"{prefix}{name}", p))
    return out


def broadcast_parameters(params, root_rank=0):
    """Broadcast parameters in place from ``root_rank``."""
    handles = [mpi_ops.broadcast_async_(p.data, root_rank,
                                        name=f"broadcast.param.{name}")
               for name, p in _named_tensors(params)]
    for h in handles:
        h.synchronize()


def broadcast_optimizer_state(optimizer, root_rank=0):
    """Broadcast an optimizer's state dict from ``root_rank``, in place:
    tensors natively, everything else by :func:`broadcast_object`."""
    state = optimizer.state_dict()
    scalar_blob = broadcast_object(
        _strip_tensors(state), root_rank, name="opt_state.scalars")
    if mpi_ops.rank() != root_rank:
        _merge_scalars(state, scalar_blob)
    handles = []
    for sid, pstate in sorted(state.get("state", {}).items(),
                              key=lambda kv: str(kv[0])):
        for key, val in sorted(pstate.items()):
            if torch.is_tensor(val):
                handles.append(mpi_ops.broadcast_async_(
                    val, root_rank, name=f"opt.{sid}.{key}"))
    for h in handles:
        h.synchronize()
    optimizer.load_state_dict(state)


def _strip_tensors(obj):
    if torch.is_tensor(obj):
        return None
    if isinstance(obj, dict):
        return {k: _strip_tensors(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        t = [_strip_tensors(v) for v in obj]
        return t if isinstance(obj, list) else tuple(t)
    return obj


def _merge_scalars(dst, src):
    if isinstance(dst, dict):
        for k, v in dst.items():
            if torch.is_tensor(v):
                continue
            if isinstance(v, (dict, list)):
                _merge_scalars(v, src[k] if isinstance(src, dict) else None)
            elif isinstance(src, dict) and k in src and src[k] is not None:
                dst[k] = src[k]
    elif isinstance(dst, list) and isinstance(src, (list, tuple)):
        for i, v in enumerate(dst):
            if isinstance(v, (dict, list)):
                _merge_scalars(v, src[i])
            elif not torch.is_tensor(v) and src[i] is not None:
                dst[i] = src[i]


def _pickled(obj):
    buf = io.BytesIO()
    pickle.dump(obj, buf, protocol=pickle.HIGHEST_PROTOCOL)
    return torch.from_numpy(np.frombuffer(buf.getvalue(),
                                          dtype=np.uint8).copy())


def broadcast_object(obj, root_rank=0, name=None):
    """Broadcast a picklable object from ``root_rank``."""
    name = name or "broadcast_object"
    if mpi_ops.rank() == root_rank:
        payload = _pickled(obj)
    else:
        payload = torch.zeros(0, dtype=torch.uint8)
    sz = torch.tensor([payload.numel()], dtype=torch.int64)
    sz = mpi_ops.broadcast(sz, root_rank, name=f"{name}.len")
    if mpi_ops.rank() != root_rank:
        payload = torch.zeros(int(sz[0]), dtype=torch.uint8)
    payload = mpi_ops.broadcast(payload, root_rank, name=f"{name}.data")
    return pickle.loads(payload.numpy().tobytes())


def allgather_object(obj, name=None):
    """Gather a picklable object from every rank: a list by rank."""
    name = name or "allgather_object"
    payload = _pickled(obj)
    sizes = mpi_ops.allgather(torch.tensor([payload.numel()],
                                           dtype=torch.int64),
                              name=f"{name}.len")
    data = mpi_ops.allgather(payload, name=f"{name}.data").numpy()
    out, off = [], 0
    for s in sizes.tolist():
        out.append(pickle.loads(data[off:off + s].tobytes()))
        off += s
    return out
