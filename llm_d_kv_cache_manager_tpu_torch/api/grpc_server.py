"""gRPC scoring service.

Copy of the reference package's `api/grpc_server.py`, after the Go
reference's gRPC service wrapper
(examples/kv_cache_index_service/server/server.go) over
api/indexer.proto. Message classes are protoc-generated (indexer_pb2); the
service is wired with grpcio generic handlers (no grpc_tools codegen needed
in this environment), exposing `kvtpu.api.v1.IndexerService/GetPodScores`
plus the score-explain counterpart `ExplainScores`.

`ExplainScores` reuses `GetPodScoresRequest` on the wire and returns the
explain report as UTF-8 JSON bytes: this environment has no protoc to
regenerate indexer_pb2 with new message types, and generic handlers make
the serializer explicit anyway — the JSON body is the same document
`GET /debug/score_explain` serves, so the two surfaces cannot drift.
"""

from __future__ import annotations

import contextlib
import json
import os
import queue
import threading
import time
from concurrent import futures
from typing import Dict, Iterator, List

import grpc

from llm_d_kv_cache_manager_tpu_torch import obs
from llm_d_kv_cache_manager_tpu_torch.api import indexer_pb2 as pb
from llm_d_kv_cache_manager_tpu_torch.api.admission import (
    SHED_DEADLINE,
    AdmissionController,
    AdmissionRejected,
)
from llm_d_kv_cache_manager_tpu_torch.metrics import collector as metrics
from llm_d_kv_cache_manager_tpu_torch.utils import logging as kvlog

logger = kvlog.get_logger("api.grpc")

SERVICE_NAME = "kvtpu.api.v1.IndexerService"
METHOD_GET_POD_SCORES = "GetPodScores"
METHOD_GET_POD_SCORES_EX = "GetPodScoresEx"
METHOD_EXPLAIN_SCORES = "ExplainScores"
METHOD_CLUSTER_STATUS = "ClusterStatus"
METHOD_SCORE_PODS_BULK = "ScorePodsBulk"

# Bulk-endpoint micro-batching defaults. `serve_grpc` callers can override
# per instance; left unset, the SCORE_BATCH_MAX / SCORE_BATCH_WINDOW_MS
# environment knobs (the same ones the HTTP batch endpoint reads) apply.
DEFAULT_BULK_MAX_BATCH = 128
DEFAULT_BULK_WINDOW_S = 0.0


@contextlib.contextmanager
def _noop_admit(budget_s=None):
    """Admission disabled: the gate is identity (deadline checks remain)."""
    yield


def _request_to_score_request(request: pb.GetPodScoresRequest):
    from llm_d_kv_cache_manager_tpu_torch.kvcache.indexer import ScoreRequest

    return ScoreRequest(
        prompt=request.prompt,
        model_name=request.model_name,
        pod_identifiers=list(request.pod_identifiers),
        lora_id=request.lora_id if request.HasField("lora_id") else None,
    )


def _shed_abort(context: grpc.ServicerContext, e: AdmissionRejected) -> None:
    """Map an admission shed to RESOURCE_EXHAUSTED + retry-after trailer
    (the gRPC sibling of HTTP 429 + Retry-After)."""
    context.set_trailing_metadata(
        (("retry-after-ms", str(int(e.retry_after_s * 1000))),)
    )
    context.abort(grpc.StatusCode.RESOURCE_EXHAUSTED, str(e))


def _carrier_from_context(context: grpc.ServicerContext):
    """Raw trace carrier from the request metadata (obs.GRPC_CARRIER_KEY),
    or None. Never raises: a carrier problem must never fail scoring —
    malformed values are counted downstream by `obs.adopt`."""
    try:
        for key, value in context.invocation_metadata() or ():
            if key == obs.GRPC_CARRIER_KEY:
                return value
    except Exception:  # noqa: BLE001 - metadata access is best-effort
        return None
    return None


def _deadline_expired(context: grpc.ServicerContext) -> bool:
    """True when the CLIENT's propagated deadline has already passed —
    any score computed now is work nobody is waiting for. Counted as a
    `deadline` shed (the caller abandoned us; we abort the work, not the
    connection)."""
    remaining = context.time_remaining()
    if remaining is not None and remaining <= 0:
        metrics.count_admission_shed(SHED_DEADLINE)
        return True
    return False


def _make_handler(
    indexer,
    cluster_status_fn=None,
    bulk_max_batch: int = DEFAULT_BULK_MAX_BATCH,
    bulk_window_s: float = DEFAULT_BULK_WINDOW_S,
    admission: AdmissionController = None,
):
    admit = admission.admit if admission is not None else _noop_admit

    def get_pod_scores(
        request: pb.GetPodScoresRequest, context: grpc.ServicerContext
    ) -> pb.GetPodScoresResponse:
        try:
            with admit(context.time_remaining()):
                with obs.adopt(_carrier_from_context(context)):
                    scores: Dict[str, float] = indexer.get_pod_scores(
                        request.prompt,
                        request.model_name,
                        list(request.pod_identifiers),
                        lora_id=(
                            request.lora_id if request.HasField("lora_id")
                            else None
                        ),
                    )
        except AdmissionRejected as e:
            _shed_abort(context, e)
            return pb.GetPodScoresResponse()
        except Exception as e:  # noqa: BLE001 - surface as gRPC status
            logger.warning("GetPodScores failed: %s", e)
            context.abort(grpc.StatusCode.INTERNAL, str(e))
            return pb.GetPodScoresResponse()
        response = pb.GetPodScoresResponse()
        for pod, score in sorted(scores.items(), key=lambda kv: -kv[1]):
            response.scores.append(pb.PodScore(pod_identifier=pod, score=score))
        return response

    def get_pod_scores_ex(
        request: pb.GetPodScoresRequest, context: grpc.ServicerContext
    ) -> dict:
        """Scatter-gather transport method (cluster/scorer.py): the scores
        PLUS per-pod matched-prefix lengths and the prompt's block-hash
        chain — everything the partition-ownership merge needs. JSON
        payload, same no-protoc rationale as ExplainScores."""
        if _deadline_expired(context):
            # Explicit no-signal, the same degraded shape a missing
            # partition produces in the scatter-gather merge — never a
            # stall, never wasted scoring.
            return {
                "scores": {}, "match_blocks": {}, "block_hashes": [],
                "degraded": "deadline",
            }
        try:
            with admit(context.time_remaining()):
                # Cross-process tracing seam: a carrier in the metadata
                # makes the read path's root trace adopt the CALLER's
                # trace id, and the completed trace's span tuples ride
                # back in the reply so the caller's recorder can
                # assemble one distributed tree (obs/carrier.py).
                with obs.adopt(_carrier_from_context(context)) as adoption:
                    result = indexer.get_pod_scores_ex(
                        request.prompt,
                        request.model_name,
                        list(request.pod_identifiers),
                        lora_id=(
                            request.lora_id if request.HasField("lora_id")
                            else None
                        ),
                    )
        except AdmissionRejected as e:
            _shed_abort(context, e)
            return {}
        except Exception as e:  # noqa: BLE001 - surface as gRPC status
            logger.warning("GetPodScoresEx failed: %s", e)
            context.abort(grpc.StatusCode.INTERNAL, str(e))
            return {}
        payload = {
            "scores": result.scores,
            "match_blocks": result.match_blocks,
            "block_hashes": result.block_hashes,
        }
        shipped = obs.export_trace(adoption.trace)
        if shipped is not None:
            payload["trace"] = shipped
        return payload

    def cluster_status(
        request: pb.GetPodScoresRequest, context: grpc.ServicerContext
    ) -> dict:
        """Replication introspection (same document as GET /cluster/status;
        the request message is ignored — reused so no new proto type is
        needed)."""
        if cluster_status_fn is None:
            return {"cluster": None}
        try:
            return cluster_status_fn()
        except Exception as e:  # noqa: BLE001 - surface as gRPC status
            logger.warning("ClusterStatus failed: %s", e)
            context.abort(grpc.StatusCode.INTERNAL, str(e))
            return {}

    def explain_scores(
        request: pb.GetPodScoresRequest, context: grpc.ServicerContext
    ) -> dict:
        try:
            return indexer.explain_scores(
                request.prompt,
                request.model_name,
                list(request.pod_identifiers),
                lora_id=request.lora_id if request.HasField("lora_id") else None,
            )
        except Exception as e:  # noqa: BLE001 - surface as gRPC status
            logger.warning("ExplainScores failed: %s", e)
            context.abort(grpc.StatusCode.INTERNAL, str(e))
            return {}

    def score_pods_bulk(
        request_iterator, context: grpc.ServicerContext
    ) -> Iterator[dict]:
        """Streaming bulk read path: a stream of `GetPodScoresRequest`s
        in, a stream of per-item results out, emitted as they complete.

        A feeder thread drains the request stream into a queue; the
        serving loop micro-batches whatever has arrived (up to
        `bulk_max_batch` items, waiting at most `bulk_window_s` after the
        first item of a window) and scores each window through
        `Indexer.score_many` — so a router pushing 32 concurrent requests
        pays ONE amortized read-path pass, while a trickle of singles
        still gets per-request latency. Responses carry `index` (the
        request's position in the stream) and stream back in order; when
        the stream metadata carried a trace carrier, each scored window's
        span payload additionally streams back as an index-less
        `{"trace": ...}` message (the client filters them out of the
        result list)."""
        carrier = _carrier_from_context(context)
        feed: "queue.Queue" = queue.Queue()
        _done = object()

        def feeder():
            try:
                for req in request_iterator:
                    feed.put(req)
            except Exception as e:  # noqa: BLE001 - stream torn down
                logger.debug("bulk request stream ended: %s", e)
            finally:
                feed.put(_done)

        threading.Thread(
            target=feeder, name="grpc-bulk-feeder", daemon=True
        ).start()

        index = 0
        finished = False
        while not finished:
            first = feed.get()
            if first is _done:
                break
            window = [first]
            if bulk_window_s > 0:
                deadline = time.perf_counter() + bulk_window_s
            while len(window) < bulk_max_batch:
                try:
                    if bulk_window_s > 0:
                        budget = deadline - time.perf_counter()
                        if budget <= 0:
                            break
                        item = feed.get(timeout=budget)
                    else:
                        item = feed.get_nowait()
                except queue.Empty:
                    break
                if item is _done:
                    finished = True
                    break
                window.append(item)
            if context.time_remaining() is not None and (
                context.time_remaining() <= 0
            ):
                # Client deadline expired mid-stream: every remaining
                # window item is abandoned work. Count each as a deadline
                # shed and stop — no score is computed for a caller that
                # is no longer listening.
                for _ in window:
                    metrics.count_admission_shed(SHED_DEADLINE)
                return
            try:
                with admit(context.time_remaining()):
                    with obs.adopt(carrier) as adoption:
                        scored = indexer.score_many(
                            [_request_to_score_request(r) for r in window]
                        )
            except AdmissionRejected as e:
                # Count the whole window (one stream-level shed would hide
                # the per-item volume) and surface the explicit status.
                for _ in window[1:]:
                    metrics.count_admission_shed(e.kind)
                _shed_abort(context, e)
                return
            except Exception as e:  # noqa: BLE001 - surface as gRPC status
                logger.warning("ScorePodsBulk window failed: %s", e)
                context.abort(grpc.StatusCode.INTERNAL, str(e))
                return
            for result in scored:
                yield {
                    "index": index,
                    "scores": result.scores,
                    "match_blocks": result.match_blocks,
                    "block_hashes": result.block_hashes,
                }
                index += 1
            shipped = obs.export_trace(adoption.trace)
            if shipped is not None:
                yield {"trace": shipped}

    rpc_handlers = {
        METHOD_SCORE_PODS_BULK: grpc.stream_stream_rpc_method_handler(
            score_pods_bulk,
            request_deserializer=pb.GetPodScoresRequest.FromString,
            response_serializer=lambda d: json.dumps(d).encode("utf-8"),
        ),
        METHOD_GET_POD_SCORES: grpc.unary_unary_rpc_method_handler(
            get_pod_scores,
            request_deserializer=pb.GetPodScoresRequest.FromString,
            response_serializer=pb.GetPodScoresResponse.SerializeToString,
        ),
        METHOD_GET_POD_SCORES_EX: grpc.unary_unary_rpc_method_handler(
            get_pod_scores_ex,
            request_deserializer=pb.GetPodScoresRequest.FromString,
            response_serializer=lambda d: json.dumps(d).encode("utf-8"),
        ),
        METHOD_CLUSTER_STATUS: grpc.unary_unary_rpc_method_handler(
            cluster_status,
            request_deserializer=pb.GetPodScoresRequest.FromString,
            response_serializer=lambda d: json.dumps(d).encode("utf-8"),
        ),
        METHOD_EXPLAIN_SCORES: grpc.unary_unary_rpc_method_handler(
            explain_scores,
            request_deserializer=pb.GetPodScoresRequest.FromString,
            response_serializer=lambda d: json.dumps(d).encode("utf-8"),
        ),
    }
    return grpc.method_handlers_generic_handler(SERVICE_NAME, rpc_handlers)


def serve_grpc(
    indexer,
    address: str = "[::]:50051",
    max_workers: int = 8,
    cluster_status_fn=None,
    bulk_max_batch: int = None,
    bulk_window_s: float = None,
    admission: AdmissionController = None,
) -> grpc.Server:
    """Start (non-blocking) a gRPC server wrapping the indexer.

    `cluster_status_fn` (optional zero-arg callable) backs the
    `ClusterStatus` method — pass `ClusterScorer.status` or a replica's
    readiness composition when this server fronts a replicated index.
    `bulk_max_batch` / `bulk_window_s` shape the `ScorePodsBulk`
    micro-batcher: at most that many stream items are folded into one
    `score_many` window, waiting at most that long after a window's first
    item (0 = score whatever has already arrived, never wait). Left None,
    they resolve from SCORE_BATCH_MAX / SCORE_BATCH_WINDOW_MS — the same
    environment knobs the HTTP `/score_completions/batch` cap reads.
    `admission` (optional AdmissionController, typically the SAME instance
    the HTTP surface uses so the two fronts share one bounded budget)
    gates every scoring method: sheds surface as RESOURCE_EXHAUSTED with a
    `retry-after-ms` trailer; client deadlines propagate into the gate and
    an expired deadline aborts the scoring work (counted) instead of
    computing an abandoned score.
    """
    if bulk_max_batch is None:
        bulk_max_batch = int(
            os.environ.get("SCORE_BATCH_MAX", DEFAULT_BULK_MAX_BATCH)
        )
    if bulk_window_s is None:
        bulk_window_s = (
            float(os.environ.get("SCORE_BATCH_WINDOW_MS", 0))
            / 1000.0
        ) or DEFAULT_BULK_WINDOW_S
    server = grpc.server(futures.ThreadPoolExecutor(max_workers=max_workers))
    server.add_generic_rpc_handlers(
        (_make_handler(
            indexer,
            cluster_status_fn=cluster_status_fn,
            bulk_max_batch=bulk_max_batch,
            bulk_window_s=bulk_window_s,
            admission=admission,
        ),)
    )
    server.add_insecure_port(address)
    server.start()
    logger.info("gRPC IndexerService listening on %s", address)
    return server


class IndexerGrpcClient:
    """Minimal client for IndexerService (mirrors the reference's example
    client, the Go reference's examples/kv_cache_index_service/client/main.go)."""

    def __init__(self, target: str, timeout_s: float = 5.0):
        self._channel = grpc.insecure_channel(target)
        self._timeout = timeout_s
        self._call = self._channel.unary_unary(
            f"/{SERVICE_NAME}/{METHOD_GET_POD_SCORES}",
            request_serializer=pb.GetPodScoresRequest.SerializeToString,
            response_deserializer=pb.GetPodScoresResponse.FromString,
        )
        self._explain_call = self._channel.unary_unary(
            f"/{SERVICE_NAME}/{METHOD_EXPLAIN_SCORES}",
            request_serializer=pb.GetPodScoresRequest.SerializeToString,
            response_deserializer=lambda b: json.loads(b.decode("utf-8")),
        )
        self._ex_call = self._channel.unary_unary(
            f"/{SERVICE_NAME}/{METHOD_GET_POD_SCORES_EX}",
            request_serializer=pb.GetPodScoresRequest.SerializeToString,
            response_deserializer=lambda b: json.loads(b.decode("utf-8")),
        )
        self._status_call = self._channel.unary_unary(
            f"/{SERVICE_NAME}/{METHOD_CLUSTER_STATUS}",
            request_serializer=pb.GetPodScoresRequest.SerializeToString,
            response_deserializer=lambda b: json.loads(b.decode("utf-8")),
        )
        self._bulk_call = self._channel.stream_stream(
            f"/{SERVICE_NAME}/{METHOD_SCORE_PODS_BULK}",
            request_serializer=pb.GetPodScoresRequest.SerializeToString,
            response_deserializer=lambda b: json.loads(b.decode("utf-8")),
        )

    def get_pod_scores(
        self, prompt: str, model_name: str, pod_identifiers=(), lora_id=None
    ) -> Dict[str, float]:
        request = pb.GetPodScoresRequest(
            prompt=prompt,
            model_name=model_name,
            pod_identifiers=list(pod_identifiers),
        )
        if lora_id is not None:
            request.lora_id = lora_id
        response = self._call(request, timeout=self._timeout)
        return {s.pod_identifier: s.score for s in response.scores}

    def explain_scores(
        self, prompt: str, model_name: str, pod_identifiers=(), lora_id=None
    ) -> dict:
        """Score-explain counterpart: the same JSON report
        `GET /debug/score_explain` serves (scores bit-identical to
        `get_pod_scores`)."""
        request = pb.GetPodScoresRequest(
            prompt=prompt,
            model_name=model_name,
            pod_identifiers=list(pod_identifiers),
        )
        if lora_id is not None:
            request.lora_id = lora_id
        return self._explain_call(request, timeout=self._timeout)

    @staticmethod
    def _carrier_metadata(carrier):
        return ((obs.GRPC_CARRIER_KEY, carrier),) if carrier else None

    def get_pod_scores_ex(
        self, prompt: str, model_name: str, pod_identifiers=(), lora_id=None,
        carrier=None,
    ) -> dict:
        """Scatter-gather transport call: {"scores", "match_blocks",
        "block_hashes"} as plain JSON types (cluster/scorer.py rebuilds a
        PodScores from it). `carrier` (an obs/carrier.py string) rides the
        request metadata; the reply then carries the server-side span
        payload under "trace"."""
        request = pb.GetPodScoresRequest(
            prompt=prompt,
            model_name=model_name,
            pod_identifiers=list(pod_identifiers),
        )
        if lora_id is not None:
            request.lora_id = lora_id
        return self._ex_call(
            request, timeout=self._timeout,
            metadata=self._carrier_metadata(carrier),
        )

    def score_pods_bulk(self, requests, carrier=None, trace_sink=None) -> List[dict]:
        """Streaming bulk scoring: `requests` is a sequence of dicts with
        `prompt`, `model_name` and optional `pod_identifiers` / `lora_id`.
        Streams every request up, collects the per-item JSON results
        (emitted by the server as its micro-batches complete) and returns
        them ordered by stream position — one
        `{"index", "scores", "match_blocks", "block_hashes"}` payload per
        request. With a `carrier`, the server's per-window span payloads
        are appended to `trace_sink` (when given) instead of the result
        list."""

        def gen():
            for r in requests:
                request = pb.GetPodScoresRequest(
                    prompt=r["prompt"],
                    model_name=r["model_name"],
                    pod_identifiers=list(r.get("pod_identifiers", ())),
                )
                if r.get("lora_id") is not None:
                    request.lora_id = r["lora_id"]
                yield request

        results = []
        for payload in self._bulk_call(
            gen(), timeout=self._timeout,
            metadata=self._carrier_metadata(carrier),
        ):
            if "index" in payload:
                results.append(payload)
            elif trace_sink is not None and payload.get("trace") is not None:
                trace_sink.append(payload["trace"])
        results.sort(key=lambda d: d["index"])
        return results

    def cluster_status(self) -> dict:
        return self._status_call(
            pb.GetPodScoresRequest(prompt="", model_name=""),
            timeout=self._timeout,
        )

    def close(self) -> None:
        self._channel.close()
