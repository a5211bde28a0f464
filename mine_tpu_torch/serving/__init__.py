"""Serving (counterpart of mine_tpu/serving): the RenderEngine (engine.py),
the byte-budgeted MPI cache (cache.py), compressed tiers and the wire format
(compress.py), the micro-batcher (batcher.py), the metric set (metrics.py)
and the HTTP server (server.py; `python -m mine_tpu_torch.serving`)."""
