"""The elastic launch: the driver (``driver.py``), host discovery
(``discovery.py``), the rendezvous server and client
(``rendezvous.py``) and the workers' notifications (``worker.py``)."""
