"""The elastic launch: the driver (``driver.py``), host discovery
(``discovery.py``), the rendezvous server and client
(``rendezvous.py``) and the workers' notifications (``worker.py``)."""

from horovod_tpu_torch.runner.elastic.discovery import (  # noqa: F401
    HostDiscoveryScript,
    HostManager,
)
from horovod_tpu_torch.runner.elastic.driver import ElasticDriver  # noqa: F401
from horovod_tpu_torch.runner.elastic.rendezvous import (  # noqa: F401
    RendezvousClient,
    RendezvousServer,
)
