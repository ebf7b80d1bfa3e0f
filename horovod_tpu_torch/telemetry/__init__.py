"""The lane's live endpoints: the Prometheus text of a metrics snapshot
(``exporters.py``) and the per-rank debug server (``debug_server.py``)."""
