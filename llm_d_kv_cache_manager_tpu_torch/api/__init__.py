"""api: the scoring services (`http_service.py`, `grpc_server.py`) and the
admission gate (`admission.py`).

The gRPC names are resolved on first use, so that importing the package
(the HTTP service, the admission gate) never imports `grpc`.
"""

__all__ = ["IndexerGrpcClient", "serve_grpc"]


def __getattr__(name):
    if name in __all__:
        from llm_d_kv_cache_manager_tpu_torch.api import grpc_server

        return getattr(grpc_server, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
