"""Data loading of the port: ``BaseDataLoader`` and the async prefetch
``AsyncDataLoaderMixin`` (``data_loader_base``)."""

from horovod_tpu_torch.data.data_loader_base import (  # noqa: F401
    AsyncDataLoaderMixin,
    BaseDataLoader,
)
