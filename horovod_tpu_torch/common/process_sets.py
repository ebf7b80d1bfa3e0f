"""Process sets: collectives over subgroups of ranks.

The port's own copy of ``horovod_tpu/common/process_sets.py``
(``ProcessSet``, ``global_process_set``, ``add_process_set``,
``remove_process_set``). A set maps onto ``torch.distributed.new_group``
groups, one gloo group and, on the card, one NCCL group, which every
rank creates: registration is collective and must happen in the same
order on every rank. ``add_process_set`` ends with a negotiated barrier,
so no rank uses a set before every rank has registered it.
"""

from horovod_tpu_torch.common import basics


class ProcessSet:
    """A subgroup of ranks collectives can run over; pass it (or its
    ``process_set_id``) as an op's ``process_set_id``."""

    process_set_id = None

    def __init__(self, ranks):
        self.ranks = None if ranks is None else sorted(int(r) for r in ranks)

    def _registered(self):
        if self.process_set_id is None:
            return None
        return basics.lane().set_groups(self.process_set_id)

    def size(self):
        """Number of ranks in the set (None if unknown)."""
        s = self._registered()
        if s is None:
            return None if self.ranks is None else len(self.ranks)
        return s.size()

    def rank(self):
        """This process's rank within the set, or None if not included."""
        s = self._registered()
        return None if s is None else s.position

    def included(self):
        return self.rank() is not None

    def __index__(self):
        if self.process_set_id is None:
            raise ValueError(
                "ProcessSet is not registered; call hvd.add_process_set first")
        return self.process_set_id

    def __repr__(self):
        return f"ProcessSet(id={self.process_set_id}, ranks={self.ranks})"


global_process_set = ProcessSet(None)
global_process_set.process_set_id = 0


def add_process_set(process_set):
    """Register a set (collective: every rank calls it with the same
    ranks, in the same order as any other registration). Takes a
    ``ProcessSet`` or a list of ranks; returns the registered set."""
    ps = process_set if isinstance(process_set, ProcessSet) \
        else ProcessSet(process_set)
    if ps.process_set_id is not None:
        raise ValueError(f"{ps!r} is already registered")
    if not ps.ranks:
        raise ValueError("a process set needs at least one rank")
    size = basics.size()
    if any(r < 0 or r >= size for r in ps.ranks) or \
            len(set(ps.ranks)) != len(ps.ranks):
        raise ValueError(f"invalid process set ranks {ps.ranks}")
    ps.process_set_id = basics.lane().register_set(ps.ranks)
    basics.lane().barrier(0)
    return ps


def remove_process_set(process_set):
    """Deregister a set (same same-order rule as add); True if it was
    registered."""
    ps_id = int(process_set)
    if ps_id == 0:
        raise ValueError("cannot remove the global process set")
    basics.lane().barrier(0)  # every collective on the set has run
    removed = basics.lane().unregister_set(ps_id)
    if isinstance(process_set, ProcessSet):
        process_set.process_set_id = None
    return removed is not None
