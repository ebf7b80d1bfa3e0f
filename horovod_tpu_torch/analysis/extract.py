"""Recording a program's collectives by running it, one rank at a time.

The port's counterpart of ``horovod_tpu/analysis/extract.py``. JAX traces
a program to a jaxpr and walks its equations; an eager PyTorch program
has no such trace, so hvdlint runs it once for each rank to check, under
a :class:`~torch.utils._python_dispatch.TorchDispatchMode`, in a
``torch.distributed`` world of the ``fake`` backend (one process stands
for every rank: each run joins the world as one of them). The mode sees
every dispatcher op in issue order, and records:

- **a** :class:`Collective` **per** ``c10d`` **op**, named in JAX's
  vocabulary: an all-reduce is ``psum`` (``pmax``/``pmin`` for MAX/MIN),
  a reduce-scatter ``psum_scatter``, an all-gather ``all_gather``, an
  all-to-all ``all_to_all``, a broadcast ``psum`` (JAX's ``pbroadcast``
  is a masked psum), and the sends and receives of one
  ``batch_isend_irecv`` (consecutive point-to-point ops) ``ppermute``,
  one a send (a receive where there are more receives than sends). Its
  axes are the mesh axes whose ranks its group spans; its ``source``
  the ``file:line`` of the first frame outside torch, the port's
  ``parallel/`` and this package's machinery.
- **a** :class:`Collective` **per request of the eager lane**
  (``hvd.allreduce`` and the like), where the caller enqueues it
  (``torch/mpi_ops.py OBSERVERS``): the lane runs the collective on its
  own thread, where the mode does not reach. Its group is the process
  set's ranks.
- **the compute/collective profile**: ``("flops", n)`` runs weighed by
  the formulas ``torch.utils.flop_counter`` registers (matmuls,
  attention, the port's custom ops; as ``telemetry.step_timer.
  count_flops``), ``("coll", prim, axes, path, source)`` issue points,
  and ``("cut", label)`` where a program boundary begins. JAX lints each
  jitted program on its own; the split step's gradient calls and its
  apply are separate programs there, so the recorder cuts the run where
  they begin (:data:`PROGRAM_BOUNDARIES`), and C7 weighs each segment
  alone.
- **width provenance** (C3): which f32 tensors were cast up from bf16 or
  f16 (through copies, views and reshapes), whether a reduction took
  one, and whether every later use of its result casts it straight back
  down.

Where JAX's extraction keeps control flow (``Loop``, ``Branches``) to
reason per path, the port keeps one sequence per rank: C1 compares the
ranks' sequences on every group they share, C8 tells a count that
differs by rank from a different collective. A run sees only the path
its inputs take, so a divergence shows when the inputs (``args`` may be
made per rank) or the rank make the ranks take different paths.

The ``fake`` backend's collectives write nothing, so the recorder fills
each output as if every rank held this rank's data: a sum is ``size``
times the input, a gather the input repeated, a receive zeros. A
program whose routing depends on data (MoE top-K, the grouped dispatch's
splits) then takes the same path on every run.
"""

import contextlib
import dataclasses
import functools
import importlib
import math
import os
import sys
import threading

import numpy as np
import torch
import torch.distributed as dist

#: collective primitive name -> reduce op it applies (None = pure data
#: movement): the JAX package's vocabulary, which the recorder emits.
COLLECTIVE_PRIMS = {
    "psum": "sum",
    "pmax": "max",
    "pmin": "min",
    "psum_scatter": "sum",
    "reduce_scatter": "sum",
    "ppermute": None,
    "pbroadcast": None,
    "all_gather": None,
    "all_to_all": None,
    "pgather": None,
}

#: c10d op -> (JAX primitive, how its operands are laid out).
_C10D = {
    "allreduce_": ("psum", "reduce"),
    "allreduce_coalesced_": ("psum", "reduce"),
    "_allgather_base_": ("all_gather", "gather_base"),
    "allgather_": ("all_gather", "gather_list"),
    "_reduce_scatter_base_": ("psum_scatter", "scatter_base"),
    "reduce_scatter_": ("psum_scatter", "scatter_list"),
    "alltoall_base_": ("all_to_all", "a2a_base"),
    "alltoall_": ("all_to_all", "a2a_list"),
    "broadcast_": ("psum", "broadcast"),
    "send": ("ppermute", "send"),
    "recv_": ("ppermute", "recv"),
}

#: c10d ReduceOp codes (``ReduceOp.RedOpType``) -> (primitive, op).
_REDUCE = {0: ("psum", "sum"), 1: ("psum", "sum"), 2: ("psum", "product"),
           3: ("pmin", "min"), 4: ("pmax", "max")}

#: dtypes whose f32 promotion before a reduction doubles wire bytes
_NARROW = (torch.bfloat16, torch.float16)

#: ops whose output holds its input's values (a copy, a view, a new
#: shape): provenance flows through them.
_MOVEMENT = frozenset({
    "clone", "view", "_unsafe_view", "reshape", "detach", "alias",
    "contiguous", "expand", "permute", "transpose", "t", "slice", "select",
    "squeeze", "unsqueeze", "flatten", "lift_fresh", "as_strided", "split",
    "split_with_sizes", "chunk", "unbind", "movedim", "narrow", "_to_copy",
    "to", "copy_", "view_as",
})

#: Where the port's programs are cut into the programs JAX jits apart:
#: each gradient call of the split step, its (unfused) ZeRO apply, and
#: the fused ZeRO step's last gradient call with the apply it drives.
PROGRAM_BOUNDARIES = (
    "horovod_tpu_torch.parallel.train_step:_value_and_grad",
    "horovod_tpu_torch.parallel.zero:ZeroApply.apply",
    "horovod_tpu_torch.parallel.fusion:value_and_grad_bucketed",
)

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_TORCH = os.path.dirname(os.path.abspath(torch.__file__))
# Frames that are the machinery, not the program: torch, the port's
# collectives and mesh code, the eager lane's frontend, and this
# package's recorder and checks.
_MACHINERY = (_TORCH, os.path.join(_PKG, "parallel") + os.sep,
              *(os.path.join(_PKG, "analysis", f) for f in (
                  "extract.py", "api.py", "checks.py")),
              *(os.path.join(_PKG, "torch", f) for f in (
                  "mpi_ops.py", "functions.py", "optimizer.py",
                  "fused_optimizer.py")))


@dataclasses.dataclass(frozen=True)
class Collective:
    """One collective one rank issued.

    ``shape`` is its (first) operand's; ``ranks`` its group's global
    ranks; ``send``/``recv`` a ``ppermute``'s two sides, each ``(peer,
    nelems, dtype)`` or None."""

    prim: str              # JAX primitive name, e.g. "psum"
    axes: tuple            # mesh axes its group spans, in mesh order
    dtype: str             # operand dtype
    nelems: int            # operand elements
    reduce_op: str         # "sum"/"max"/... or "" for data movement
    path: str              # program segment
    source: str            # user file:line (best effort)
    upcast_from: str = ""  # operand was cast up from this dtype
    roundtrip: bool = False  # every use casts straight back down
    shape: tuple = ()
    ranks: tuple = ()
    send: tuple = None
    recv: tuple = None

    @property
    def key(self):
        """Identity for sequence comparison: what must match across
        ranks for the collective to rendezvous."""
        return (self.prim, self.axes, self.dtype, self.nelems,
                self.reduce_op)


@dataclasses.dataclass
class Extraction:
    """Everything the checks consume, from the ranks' runs of one
    program."""

    signature: tuple       # the first checked rank's collectives
    per_rank: dict         # rank -> its collectives, in issue order
    axis_names_seen: set   # every axis any collective spanned
    #: the first checked rank's event list for C7: ``("flops", weight)``
    #: runs, ``("coll", prim, axes, path, source)`` issue points and
    #: ``("cut", label)`` program boundaries.
    profile: tuple = ()
    same_inputs: bool = True   # every rank ran on the same inputs


# ---- the fake world and its mesh --------------------------------------------

class LintMesh:
    """A mesh of arbitrary axis names over the fake world (the port's
    ``Mesh`` takes only ``AXIS_ORDER``'s): ``shape`` in declared order,
    ranks laid out row-major, one group for every set of axes larger
    than 1, ``group`` the whole mesh's."""

    def __init__(self, shape, rank, device, axis_groups, group):
        self.shape = dict(shape)
        self.rank = rank
        self.device = device
        grid = np.arange(max(1, math.prod(self.shape.values()))).reshape(
            tuple(self.shape.values()) or (1,))
        idx = np.unravel_index(rank, grid.shape)
        self.coords = dict(zip(self.shape, (int(i) for i in idx)))
        self._axis_groups = axis_groups
        self.group = group

    @property
    def size(self):
        return math.prod(self.shape.values())

    def axis_size(self, axis):
        return self.shape[axis]

    def axis_index(self, axis):
        return self.coords[axis]

    def axis_group(self, axis):
        return self._axis_groups.get(axis)

    def axes_group(self, axes):
        live = tuple(a for a in self.shape if a in axes and self.shape[a] > 1)
        if not live:
            return None
        if len(live) == 1:
            return self._axis_groups.get(live[0])
        if len(live) == sum(n > 1 for n in self.shape.values()):
            return self.group
        return self._axis_groups[live]

    def axes_size(self, axes):
        return math.prod(self.shape[a] for a in set(axes))


@contextlib.contextmanager
def fake_world(axis_env, rank, device="cpu"):
    """Join a ``fake`` world of ``prod(sizes)`` ranks as ``rank`` and
    yield its mesh: the port's ``parallel.mesh.Mesh`` when every axis is
    one of its ``AXIS_ORDER``, else a :class:`LintMesh`. The world is
    left when the block ends. A process already in another world cannot
    hold one: run the lint in a process of its own."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from horovod_tpu_torch.parallel.mesh import AXIS_ORDER, Mesh, open_groups

    if dist.is_initialized():
        if dist.get_backend() != "fake":
            raise RuntimeError(
                "hvdlint records in a fake torch.distributed world of its "
                f"own, and this process already joined a "
                f"{dist.get_backend()!r} one: lint in a process that has "
                "not")
        dist.destroy_process_group()
    env = [(str(n), int(s)) for n, s in axis_env]
    sizes = dict(env)
    world = math.prod(sizes.values()) if sizes else 1
    if not 0 <= rank < world:
        raise ValueError(f"rank {rank} is not in a world of {world}")
    dev = torch.device(device)
    dist.init_process_group("fake", rank=rank, world_size=world,
                            store=FakeStore())
    new_group = dist.new_group

    def fake_group(*a, backend=None, pg_options=None, **kw):
        # The port opens its groups on a named backend (NCCL, gloo); in
        # the fake world every group is a fake one.
        del backend, pg_options
        return new_group(*a, **kw)

    dist.new_group = fake_group
    try:
        if env and all(n in AXIS_ORDER for n in sizes):
            full = {a: sizes.get(a, 1) for a in AXIS_ORDER}
            groups, whole = open_groups(AXIS_ORDER, full, rank)
            mesh = Mesh(full, rank, dev, groups, whole)
        else:
            order = [n for n, _ in env]
            groups, whole = open_groups(order, sizes, rank)
            mesh = LintMesh(sizes, rank, dev, groups, whole)
        yield mesh
    finally:
        dist.new_group = new_group
        dist.destroy_process_group()


def _group_axes(mesh):
    """Global ranks of each of ``mesh``'s groups (this rank's) -> the
    axes it spans, in mesh order."""
    out = {}
    if mesh is None:
        return out
    order = [a for a in mesh.shape if mesh.shape[a] > 1]
    for key, g in mesh._axis_groups.items():
        axes = (key,) if isinstance(key, str) else tuple(key)
        out[tuple(dist.get_process_group_ranks(g))] = axes
    if mesh.group is not None and order:
        out[tuple(dist.get_process_group_ranks(mesh.group))] = tuple(order)
    return out


# ---- the recorder -----------------------------------------------------------

def _dtype_name(dtype):
    return str(dtype).removeprefix("torch.")


def _source():
    """``file:line`` of the first frame outside the machinery (torch,
    the port's ``parallel/``, the recorder), else of the first outside
    torch."""
    f = sys._getframe(2)
    fallback = ""
    while f is not None:
        name = os.path.abspath(f.f_code.co_filename)
        if not name.startswith(_MACHINERY):
            return f"{name}:{f.f_lineno}"
        if not fallback and not name.startswith(_TORCH):
            fallback = f"{name}:{f.f_lineno}"
        f = f.f_back
    return fallback


_OPS_FILE = os.path.join(_PKG, "parallel", "ops.py")


def _called_from(path):
    """Whether the nearest frame outside torch and the recorder is in
    ``path``."""
    f = sys._getframe(1)
    own = os.path.abspath(__file__)
    while f is not None:
        name = os.path.abspath(f.f_code.co_filename)
        if not name.startswith(_TORCH) and name != own:
            return name == path
        f = f.f_back
    return False


def _resolve(target):
    """``"module:Qual.name"`` -> (owner object, attribute name)."""
    mod, _, qual = target.partition(":")
    owner = importlib.import_module(mod)
    *outer, attr = qual.split(".")
    for part in outer:
        owner = getattr(owner, part)
    return owner, attr


class _Recorder:
    """One rank's run: its collectives, profile and provenance."""

    def __init__(self, axes_of):
        from torch.utils.flop_counter import flop_registry
        from torch.utils.weak import WeakIdKeyDictionary

        self.flop_registry = flop_registry
        self.axes_of = axes_of
        self.records = []        # dicts, frozen into Collectives at the end
        self.profile = []
        self.path = "<top>"
        # the open batch: (kind, peer, tensor, source, group ranks)
        self.p2p = []
        self.upcast = WeakIdKeyDictionary()    # f32 tensor -> narrow dtype
        self.reduced = WeakIdKeyDictionary()   # result tensor -> record
        self.lock = threading.RLock()

    # -- events --------------------------------------------------------

    def flops(self, n):
        if n <= 0:
            return
        if self.profile and self.profile[-1][0] == "flops":
            self.profile[-1] = ("flops", self.profile[-1][1] + n)
        else:
            self.profile.append(("flops", n))

    def cut(self, label):
        with self.lock:
            self.flush()
            self.path = label
            self.profile.append(("cut", label))

    def add(self, prim, ranks, tensors, reduce_op, source, **extra):
        axes = self.axes_of(ranks)
        nelems = sum(max(1, t.numel()) for t in tensors)
        dtypes = sorted({_dtype_name(t.dtype) for t in tensors})
        rec = dict(prim=prim, axes=axes, dtype=",".join(dtypes),
                   nelems=nelems, reduce_op=reduce_op, path=self.path,
                   source=source, ranks=tuple(ranks),
                   shape=tuple(tensors[0].shape) if tensors else (), **extra)
        self.records.append(rec)
        self.profile.append(("coll", prim, axes, self.path, source))
        return rec

    def flush(self):
        """Close the open point-to-point batch into ``ppermute``s."""
        if not self.p2p:
            return
        batch, self.p2p = self.p2p, []
        sends = [b for b in batch if b[0] == "send"]
        recvs = [b for b in batch if b[0] == "recv"]

        def side(b):
            return None if b is None else (b[1], b[2].numel(),
                                           _dtype_name(b[2].dtype))

        for i in range(max(len(sends), len(recvs))):
            s = sends[i] if i < len(sends) else None
            r = recvs[i] if i < len(recvs) else None
            _, _, t, source, ranks = s or r
            self.add("ppermute", ranks, [t], "", source, send=side(s),
                     recv=side(r))

    # -- c10d ops ------------------------------------------------------

    def collective(self, func, args, kwargs):
        name = func._schema.name.split("::")[-1]
        pg = op_code = None
        for a in list(args) + list(kwargs.values()):
            if isinstance(a, torch.ScriptObject):
                kind = a._type().qualified_name()
                if kind.endswith("ProcessGroup"):
                    pg = dist.ProcessGroup.unbox(a)
                elif kind.endswith("ReduceOp"):
                    op_code = int(a.op())
        ranks = tuple(dist.get_process_group_ranks(pg)) if pg is not None \
            else tuple(range(dist.get_world_size()))
        me = ranks.index(dist.get_rank()) if dist.get_rank() in ranks else 0
        prim, layout = _C10D.get(name, (name, "other"))
        source = _source()
        out = func(*args, **kwargs)
        fake = pg is not None and dist.get_backend(pg) == "fake"
        if layout in ("send", "recv"):
            t = args[0][0]
            peer = ranks[args[2]]
            self.p2p.append((layout, peer, t, source, ranks))
            if fake and layout == "recv":
                with torch.no_grad():
                    t.zero_()
            return out
        self.flush()
        n = len(ranks)
        if layout == "reduce":
            prim, red = _REDUCE.get(op_code, ("psum", "sum"))
            tensors = list(args[0])
            rec = self.add(prim, ranks, tensors, red, source)
            self.track_reduction(rec, tensors, tensors)
            if fake and op_code in (0, None):
                with torch.no_grad():
                    for t in tensors:
                        t.mul_(n)
        elif layout == "scatter_base":
            o, i = args[0], args[1]
            red = _REDUCE.get(op_code, ("psum", "sum"))[1]
            rec = self.add(prim, ranks, [i], red, source)
            self.track_reduction(rec, [i], [o])
            if fake:
                with torch.no_grad():
                    blk = i.reshape(n, -1)[me].reshape(o.shape)
                    o.copy_(blk * n if op_code in (0, None) else blk)
        elif layout == "scatter_list":
            outs, ins = list(args[0]), [t for ts in args[1] for t in ts]
            rec = self.add(prim, ranks, ins, "sum", source)
            self.track_reduction(rec, ins, outs)
            if fake:
                with torch.no_grad():
                    for o, ts in zip(outs, args[1]):
                        o.copy_(ts[me] * n)
        elif layout == "gather_base":
            o, i = args[0], args[1]
            self.add(prim, ranks, [i], "", source)
            if fake:
                with torch.no_grad():
                    o.reshape(n, -1).copy_(i.reshape(1, -1).expand(n, -1))
        elif layout == "gather_list":
            ins = list(args[1])
            self.add(prim, ranks, ins, "", source)
            if fake:
                with torch.no_grad():
                    for outs, i in zip(args[0], ins):
                        for o in outs:
                            o.copy_(i)
        elif layout == "a2a_base":
            o, i = args[0], args[1]
            self.add(prim, ranks, [i], "", source)
            if fake:
                self._fill_a2a(o, i, args[3], args[4], n, me)
        elif layout == "a2a_list":
            outs, ins = list(args[0]), list(args[1])
            self.add(prim, ranks, ins, "", source)
            if fake:
                with torch.no_grad():
                    for o in outs:
                        if o.shape == ins[me].shape:
                            o.copy_(ins[me])
                        else:
                            o.zero_()
        else:
            tensors = [a for a in args if isinstance(a, torch.Tensor)] + [
                t for a in args if isinstance(a, (list, tuple))
                for t in a if isinstance(t, torch.Tensor)]
            self.add(prim, ranks, tensors,
                     "sum" if layout == "broadcast" else "", source)
        return out

    @staticmethod
    def _fill_a2a(o, i, out_splits, in_splits, n, me):
        """Every rank holding this one's input: from each peer the block
        this rank's input sends to itself."""
        with torch.no_grad():
            if not out_splits and not in_splits:
                blk = i.reshape(n, -1)[me]
                o.reshape(n, -1).copy_(blk.reshape(1, -1).expand(n, -1))
                return
            ins = list(in_splits) or [i.shape[0] // n] * n
            outs = list(out_splits) or [o.shape[0] // n] * n
            start = sum(ins[:me])
            mine = i.narrow(0, start, ins[me])
            at = 0
            for rows in outs:
                dst = o.narrow(0, at, rows)
                if rows == ins[me]:
                    dst.copy_(mine)
                else:
                    dst.zero_()
                at += rows

    # -- the eager lane's requests -----------------------------------------

    def lane(self, req, tensor, members):
        """One request of the eager lane (``torch/mpi_ops.py``), recorded
        as the caller enqueues it."""
        from horovod_tpu_torch.common.message import ReduceOp, RequestType

        kinds = {RequestType.ALLREDUCE: "psum",
                 RequestType.ALLGATHER: "all_gather",
                 RequestType.BROADCAST: "psum",
                 RequestType.ALLTOALL: "all_to_all",
                 RequestType.REDUCESCATTER: "psum_scatter"}
        prim = kinds.get(req.request_type)
        if prim is None:
            return
        red = ""
        if req.request_type in (RequestType.ALLREDUCE,
                                RequestType.REDUCESCATTER):
            prim, red = {ReduceOp.MIN: ("pmin", "min"),
                         ReduceOp.MAX: ("pmax", "max")}.get(
                req.reduce_op, (prim, "sum"))
        elif req.request_type == RequestType.BROADCAST:
            red = "sum"
        with self.lock:
            self.flush()
            ranks = members or range(dist.get_world_size())
            self.add(prim, tuple(ranks), [tensor], red, _source())

    # -- width provenance (C3) -------------------------------------------

    def track_reduction(self, rec, operands, results):
        if not operands:
            return
        src = self.upcast.get(operands[0])
        if src is not None and operands[0].dtype == torch.float32:
            rec["upcast_from"] = _dtype_name(src)
            rec["roundtrip"] = True
            for t in results:
                self.reduced[t] = rec

    def provenance(self, func, args, kwargs, out):
        name = func._overloadpacket.__name__
        if not self.upcast and not self.reduced and name not in (
                "_to_copy", "to", "copy_"):
            return
        ins = [a for a in torch.utils._pytree.tree_leaves((args, kwargs))
               if isinstance(a, torch.Tensor)]
        outs = [o for o in torch.utils._pytree.tree_leaves(out)
                if isinstance(o, torch.Tensor)]
        if name == "copy_" and len(ins) >= 2:
            ins, outs = [ins[1]], [ins[0]]
        first = ins[0] if ins else None
        cast = name in ("_to_copy", "to", "copy_")
        # As JAX's walker reads a reduction's direct producer and direct
        # users, provenance passes only through the copies and views the
        # port's collective wrappers make around the c10d op (and
        # autograd's detaches); a reshape in the program is a use.
        passes = None

        def wrapper_op():
            nonlocal passes
            if passes is None:
                passes = name in ("detach", "alias", "lift_fresh") or (
                    name in _MOVEMENT and _called_from(_OPS_FILE))
            return passes

        for t in ins:
            rec = self.reduced.get(t)
            if rec is None:
                continue
            if cast and outs and all(
                    _dtype_name(o.dtype) == rec["upcast_from"] for o in outs):
                continue
            if t is first and wrapper_op():
                for o in outs:
                    if o.dtype == torch.float32:
                        self.reduced[o] = rec
            else:
                rec["roundtrip"] = False
        if first is None or name not in _MOVEMENT:
            return
        if first.dtype in _NARROW and cast:
            src = first.dtype
        else:
            src = self.upcast.get(first)
            if src is None or not wrapper_op():
                return
        for o in outs:
            if o.dtype == torch.float32:
                self.upcast[o] = src

    def finish(self, outputs):
        self.flush()
        for o in torch.utils._pytree.tree_leaves(outputs):
            if isinstance(o, torch.Tensor):
                rec = self.reduced.get(o)
                if rec is not None:
                    rec["roundtrip"] = False
        return tuple(Collective(**r) for r in self.records)


def _mode(rec):
    from torch.utils._python_dispatch import TorchDispatchMode

    class _Record(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            with rec.lock:
                if func.namespace == "c10d":
                    return rec.collective(func, args, kwargs)
                rec.flush()
            out = func(*args, **kwargs)
            with rec.lock:
                formula = rec.flop_registry.get(func._overloadpacket)
                if formula is not None:
                    rec.flops(int(formula(*args, **kwargs, out_val=out)))
                rec.provenance(func, args, kwargs, out)
            return out

    return _Record()


@contextlib.contextmanager
def _cuts(rec, targets):
    """Each call of a ``targets`` function begins a program segment."""
    saved, counts = [], {}
    try:
        for target in targets:
            owner, attr = _resolve(target)
            fn = getattr(owner, attr)
            label = target.rpartition(":")[2]

            def wrapped(*a, __fn=fn, __label=label, **kw):
                counts[__label] = counts.get(__label, 0) + 1
                rec.cut(f"{__label}#{counts[__label]}")
                return __fn(*a, **kw)

            functools.update_wrapper(wrapped, fn)
            saved.append((owner, attr, vars(owner).get(attr)))
            setattr(owner, attr, wrapped)
        yield
    finally:
        for owner, attr, fn in reversed(saved):
            if fn is None:
                delattr(owner, attr)
            else:
                setattr(owner, attr, fn)


def record(fn, args=(), kwargs=None, *, mesh=None, cuts=PROGRAM_BOUNDARIES):
    """Run ``fn(*args, **kwargs)`` once under the recorder, in the
    current ``torch.distributed`` world (a ``fake`` one's outputs
    filled). Returns ``(collectives, profile, output)``. ``mesh`` names
    the groups' axes; ``cuts`` are the program boundaries."""
    axes = _group_axes(mesh)

    def axes_of(ranks):
        got = axes.get(tuple(ranks))
        return got if got is not None else (f"ranks{list(ranks)}",)

    from horovod_tpu_torch.torch import mpi_ops

    rec = _Recorder(axes_of)
    mpi_ops.OBSERVERS.append(rec.lane)
    try:
        with _cuts(rec, cuts or ()), _mode(rec):
            out = fn(*args, **(kwargs or {}))
    finally:
        mpi_ops.OBSERVERS.remove(rec.lane)
    colls = rec.finish(out)
    return colls, tuple(rec.profile), out


def _clone(tree):
    if isinstance(tree, torch.Tensor):
        return tree.clone()
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not hasattr(tree, "_fields"):
        return type(tree)(_clone(v) for v in tree)
    return tree


def _fingerprint(tree):
    """What of a rank's inputs can differ by rank: each tensor's shape,
    dtype and sum, each number and string (meshes, groups and other
    objects aside)."""
    if isinstance(tree, torch.Tensor):
        return (tuple(tree.shape), str(tree.dtype),
                None if tree.is_complex() else
                float(torch.sum(tree.detach(), dtype=torch.float64)))
    if isinstance(tree, dict):
        return tuple((k, _fingerprint(v)) for k, v in sorted(
            tree.items(), key=lambda kv: str(kv[0])))
    if isinstance(tree, (list, tuple)):
        return tuple(_fingerprint(v) for v in tree)
    if isinstance(tree, (int, float, str, bool)) or tree is None:
        return tree
    return type(tree).__name__


def extract(fn, args=(), kwargs=None, *, axis_env=(), ranks=None,
            device="cpu", cuts=PROGRAM_BOUNDARIES):
    """Run ``fn`` once for each rank of ``ranks`` (default: every rank
    of the world ``axis_env`` spans) in a fake world, and return the
    :class:`Extraction`. ``args`` is a tuple (the same inputs on every
    rank, each run on its own copy) or a callable ``args(mesh) ->
    tuple`` of the rank's inputs (``mesh.rank`` tells which)."""
    env = list(axis_env or ())
    world = math.prod(s for _, s in env) if env else 1
    ranks = tuple(range(world)) if ranks is None else tuple(ranks)
    if not ranks:
        raise ValueError("extract needs at least one rank")
    per_rank, profile, seen = {}, (), set()
    prints = set()
    for r in ranks:
        with fake_world(env, r, device) as mesh:
            a = args(mesh) if callable(args) else (
                _clone(tuple(args)) if len(ranks) > 1 else tuple(args))
            if callable(args) and len(ranks) > 1:
                prints.add(_fingerprint(a))
            colls, prof, _ = record(fn, a, kwargs, mesh=mesh, cuts=cuts)
        per_rank[r] = colls
        if r == ranks[0]:
            profile = prof
        for c in colls:
            seen.update(c.axes)
    return Extraction(signature=per_rank[ranks[0]], per_rank=per_rank,
                      axis_names_seen=seen, profile=profile,
                      same_inputs=len(prints) <= 1)


def linearize(nodes):
    """The ordered list of collectives of a signature (the port's
    signatures are already one rank's flat sequence)."""
    return [n for n in nodes if isinstance(n, Collective)]


def iter_nodes(nodes):
    """Every node of a signature, in order."""
    yield from nodes
