"""Serving lane of the port: paged KV cache (``kvcache``), request
scheduler (``scheduler``), the continuous-batching ``DecodeEngine``
(``engine``) and the disaggregated elastic ``ServingLoop`` (``service``;
``serve_smoke`` is its two-rank chaos drill)."""
