"""api: the admission gate (`admission.py`).

The reference package's HTTP and gRPC services come with the port's
metrics collector and tracing spine (ROADMAP.md queue 1 item 7).
"""
