"""HTTP-over-Unix-domain-socket client to the tokenizer sidecar.

Copy of the reference package's `tokenization/uds_client.py`:
POST /tokenize (raw prompt → {input_ids, offset_mapping}) and
POST /chat-template against the Python sidecar's Unix socket, with a 5s
timeout, 2 retries, and exponential backoff with jitter. The sidecar itself is the repository's `services/uds_tokenizer/`.
"""

from __future__ import annotations

import http.client
import json
import random
import socket
import time
from typing import List, Optional

from llm_d_kv_cache_manager_tpu_torch.tokenization.tokenizer import (
    TokenizationResult,
    Tokenizer,
    _char_to_byte_offsets,
)
from llm_d_kv_cache_manager_tpu_torch.utils import logging as kvlog

logger = kvlog.get_logger("tokenization.uds")

DEFAULT_SOCKET_PATH = "/tmp/tokenizer/tokenizer-uds.socket"
DEFAULT_TIMEOUT_S = 5.0
DEFAULT_RETRIES = 2
BACKOFF_BASE_S = 0.1


class _UDSConnection(http.client.HTTPConnection):
    def __init__(self, socket_path: str, timeout: float):
        super().__init__("localhost", timeout=timeout)
        self._socket_path = socket_path

    def connect(self) -> None:
        sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        sock.settimeout(self.timeout)
        sock.connect(self._socket_path)
        self.sock = sock


class UDSTokenizer(Tokenizer):
    def __init__(
        self,
        socket_path: Optional[str] = None,
        timeout_s: float = DEFAULT_TIMEOUT_S,
        retries: int = DEFAULT_RETRIES,
    ):
        self.socket_path = socket_path or DEFAULT_SOCKET_PATH
        self.timeout_s = timeout_s
        self.retries = retries

    def _request(self, path: str, body: dict) -> dict:
        payload = json.dumps(body)
        last_error: Optional[Exception] = None
        for attempt in range(self.retries + 1):
            conn = _UDSConnection(self.socket_path, self.timeout_s)
            try:
                conn.request(
                    "POST",
                    path,
                    body=payload,
                    headers={"Content-Type": "application/json"},
                )
                resp = conn.getresponse()
                data = resp.read()
                if resp.status != 200:
                    raise RuntimeError(
                        f"sidecar {path} returned {resp.status}: {data[:200]!r}"
                    )
                return json.loads(data)
            except Exception as e:  # noqa: BLE001 - retry any transport error
                last_error = e
                if attempt < self.retries:
                    backoff = BACKOFF_BASE_S * (2**attempt) * (1 + random.random())
                    logger.debug(
                        "UDS request %s failed (attempt %d): %s; retrying in %.2fs",
                        path, attempt + 1, e, backoff,
                    )
                    time.sleep(backoff)
            finally:
                conn.close()
        raise RuntimeError(
            f"UDS tokenizer request {path} failed after {self.retries + 1} attempts: "
            f"{last_error}"
        )

    def encode(self, prompt: str, model_name: str) -> TokenizationResult:
        data = self._request(
            # No add_special_tokens: the sidecar's configured default + BOS
            # dedup decide (templated prompts may already carry BOS).
            "/tokenize", {"prompt": prompt, "model": model_name}
        )
        tokens: List[int] = list(data["input_ids"])
        char_offsets = [tuple(o) for o in data.get("offset_mapping", [])]
        if len(char_offsets) != len(tokens):
            char_offsets = [(0, 0)] * len(tokens)
        return TokenizationResult(
            tokens=tokens, offsets=_char_to_byte_offsets(prompt, char_offsets)
        )

    def render_chat_template(self, request) -> str:
        body = {
            "conversations": request.conversations,
            "chat_template": request.chat_template,
            "tools": request.tools,
            "documents": request.documents,
            "add_generation_prompt": request.add_generation_prompt,
            "continue_final_message": request.continue_final_message,
            "model": request.model_name,
        }
        data = self._request("/chat-template", body)
        return data["rendered"]
