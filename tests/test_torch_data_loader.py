"""The port's ``BaseDataLoader`` / ``AsyncDataLoaderMixin``
(``horovod_tpu_torch/data``), case for case against the JAX package's
``tests/single/test_data_loader.py``: the same loaders, the same
iterations, the same expected batches. The module is pure Python, the
port's own copy of ``horovod_tpu/data/data_loader_base.py``; the first
case also iterates the JAX package's loader over the same range."""

import time

import pytest

from horovod_tpu_torch.data import AsyncDataLoaderMixin, BaseDataLoader


class RangeLoader(BaseDataLoader):
    def __init__(self, n, delay=0.0):
        self.n = n
        self.delay = delay

    def __len__(self):
        return self.n

    def _iterate(self):
        for i in range(self.n):
            if self.delay:
                time.sleep(self.delay)
            yield i


class AsyncRangeLoader(AsyncDataLoaderMixin, RangeLoader):
    pass


def test_sync_iteration():
    from horovod_tpu.data import BaseDataLoader as JaxBase

    class JaxRange(JaxBase):
        def __len__(self):
            return 5

        def _iterate(self):
            yield from range(5)

    assert list(RangeLoader(5)) == list(JaxRange()) == [0, 1, 2, 3, 4]


def test_async_iteration_order_preserved():
    loader = AsyncRangeLoader(n=20)
    assert list(loader) == list(range(20))
    # Re-iterable: a second epoch restarts the producer.
    assert list(loader) == list(range(20))


def test_async_disabled_degrades_to_sync():
    loader = AsyncRangeLoader(async_loading=False, n=7)
    assert list(loader) == list(range(7))
    assert loader._thread is None


def test_async_prefetch_overlaps():
    # With a slow producer, the consumer still sees every batch once.
    loader = AsyncRangeLoader(async_depth=4, n=10, delay=0.005)
    assert list(loader) == list(range(10))


def test_async_error_propagates():
    # The failing _iterate goes on the base class: on the mixed class it
    # would shadow AsyncDataLoaderMixin._iterate in the MRO.
    class BoomBase(BaseDataLoader):
        def _iterate(self):
            yield 1
            raise ValueError("bad batch")

    class Boom(AsyncDataLoaderMixin, BoomBase):
        pass

    loader = Boom()
    it = iter(loader)
    assert next(it) == 1
    with pytest.raises(ValueError, match="bad batch"):
        list(it)
    assert loader._thread is not None or loader._queue is None  # async ran


def test_close_mid_epoch():
    loader = AsyncRangeLoader(async_depth=2, n=1000, delay=0.001)
    it = iter(loader)
    assert next(it) == 0
    loader.close_async_loader()  # must not hang on the full queue
    assert loader._thread is None
