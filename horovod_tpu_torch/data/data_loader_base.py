"""Data-loader base and its async prefetch mixin.

The port's own copy of ``horovod_tpu/data/data_loader_base.py``
(``BaseDataLoader``, ``AsyncDataLoaderMixin``), itself the counterpart
of upstream Horovod's ``horovod/data/data_loader_base.py``. It is pure
Python: a subclass yields batches from ``_iterate``, and the mixin runs
that generator on a producer thread that keeps a bounded queue of
batches ready ahead of the step loop, so the host thread that feeds the
card does not stall it between steps.
"""

import queue
import threading


class BaseDataLoader:
    """Iterable over training batches.

    Subclasses implement :meth:`_iterate`; users iterate the loader itself.
    """

    def __len__(self):
        raise NotImplementedError()

    def _iterate(self):
        """Yield batches for one epoch."""
        raise NotImplementedError()

    def __iter__(self):
        return iter(self._iterate())


class AsyncDataLoaderMixin:
    """Mix in BEFORE a BaseDataLoader subclass to prefetch on a thread.

    ``class AsyncDataLoader(AsyncDataLoaderMixin, MyLoader): ...``

    The producer thread runs ``super()._iterate()`` and feeds a bounded
    queue; the consumer (training loop) pops from it. ``async_loading=False``
    degrades to synchronous iteration. Call :meth:`close_async_loader` when
    finished (elastic reset does this between generations).
    """

    def __init__(self, async_loading=True, async_depth=2, *args, **kwargs):
        self.async_loading = async_loading
        self.async_depth = async_depth
        self._queue = None
        self._thread = None
        self._shutdown = None
        super().__init__(*args, **kwargs)

    def close_async_loader(self):
        """Stop the producer thread and drain the queue."""
        if self._thread is None:
            return
        self._shutdown.set()
        # Unblock a producer waiting on a full queue.
        try:
            while True:
                self._queue.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=10)
        # A producer stuck >10s inside user I/O is left to die as a daemon;
        # it holds only this epoch's queue/event (captured below), so it can
        # never leak stale batches into a later epoch.
        self._thread = None
        self._queue = None
        self._shutdown = None

    def _produce(self, q, shutdown):
        # q/shutdown are THIS epoch's objects: a zombie from a timed-out
        # close cannot observe the next epoch's state.
        try:
            interrupted = False
            for batch in super()._iterate():
                if shutdown.is_set():
                    interrupted = True
                    break
                q.put((batch, None))
            if not interrupted:
                q.put((None, StopIteration()))
            else:
                # Best-effort sentinel after an early shutdown: a consumer
                # resumed post-close still terminates via its timed get
                # even if the queue was full here.
                try:
                    q.put_nowait((None, StopIteration()))
                except queue.Full:
                    pass
        except Exception as e:  # noqa: BLE001 — surface in the consumer
            q.put((None, e))

    def _iterate(self):
        if not self.async_loading:
            yield from super()._iterate()
            return
        self.close_async_loader()  # end any previous epoch first
        shutdown = threading.Event()
        q = queue.Queue(maxsize=self.async_depth)
        thread = threading.Thread(target=self._produce, args=(q, shutdown),
                                  daemon=True)
        self._shutdown, self._queue, self._thread = shutdown, q, thread
        thread.start()
        try:
            while True:
                try:
                    batch, err = q.get(timeout=0.1)
                except queue.Empty:
                    # Timed get (not a bare blocking get) so a consumer
                    # resumed after close_async_loader() terminates even if
                    # the producer's sentinel was drained by the close.
                    if shutdown.is_set():
                        return
                    continue
                if err is not None:
                    if isinstance(err, StopIteration):
                        return
                    raise err
                yield batch
        finally:
            # Close THIS epoch via locals: a late-GC'd abandoned generator
            # must not tear down a newer epoch's producer.
            shutdown.set()
            try:
                while True:
                    q.get_nowait()
            except queue.Empty:
                pass
            thread.join(timeout=10)
            if self._thread is thread:
                self._thread = self._queue = self._shutdown = None
