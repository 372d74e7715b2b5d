"""KVEvents schema — msgpack wire format, vLLM-compatible.

Port of the reference package's `kvevents/events.py`. All structures are
msgpack *arrays* (tagged unions):

  EventBatch        = [ts: float64, events: [tagged...], data_parallel_rank?]
  BlockStored       = ["BlockStored", block_hashes, parent_block_hash,
                       token_ids, block_size, lora_id, medium]
  BlockRemoved      = ["BlockRemoved", block_hashes, medium]
  AllBlocksCleared  = ["AllBlocksCleared"]

The wire bytes are made and read by the port's own codec
(utils/msgpack_codec.py), which gives the bytes of `msgpack.packb(...,
use_bin_type=True)`: the port needs no msgpack package.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, List, Optional, Sequence, Union

from llm_d_kv_cache_manager_tpu_torch.utils import msgpack_codec

BLOCK_STORED_TAG = "BlockStored"
BLOCK_REMOVED_TAG = "BlockRemoved"
ALL_BLOCKS_CLEARED_TAG = "AllBlocksCleared"

Hash = Union[int, bytes]


def hash_as_uint64(raw: Any) -> int:
    """Coerce an event block hash to uint64: int (legacy) as-is, bytes (new
    vLLM format) as the last 8 bytes big-endian."""
    if isinstance(raw, bool):  # guard: bool is an int subclass
        raise TypeError(f"unsupported hash type: {type(raw).__name__}")
    if isinstance(raw, int):
        return raw & 0xFFFFFFFFFFFFFFFF
    if isinstance(raw, (bytes, bytearray)):
        if len(raw) == 0:
            raise ValueError("hash byte string is empty")
        return int.from_bytes(bytes(raw[-8:]), "big")
    raise TypeError(f"unsupported hash type: {type(raw).__name__}")


@dataclass
class BlockStored:
    block_hashes: List[Hash]
    parent_block_hash: Optional[Hash]
    token_ids: List[int]
    block_size: int
    lora_id: Optional[int] = None
    medium: Optional[str] = None

    def to_tagged_union(self) -> List[Any]:
        return [
            BLOCK_STORED_TAG,
            self.block_hashes,
            self.parent_block_hash,
            self.token_ids,
            self.block_size,
            self.lora_id,
            self.medium,
        ]

    @classmethod
    def from_payload(cls, payload: Sequence[Any]) -> "BlockStored":
        p = list(payload) + [None] * (6 - len(payload))
        return cls(
            block_hashes=list(p[0] or []),
            parent_block_hash=p[1],
            token_ids=list(p[2] or []),
            block_size=int(p[3] or 0),
            lora_id=p[4],
            medium=p[5],
        )


@dataclass
class BlockRemoved:
    block_hashes: List[Hash]
    medium: Optional[str] = None

    def to_tagged_union(self) -> List[Any]:
        return [BLOCK_REMOVED_TAG, self.block_hashes, self.medium]

    @classmethod
    def from_payload(cls, payload: Sequence[Any]) -> "BlockRemoved":
        p = list(payload) + [None] * (2 - len(payload))
        return cls(block_hashes=list(p[0] or []), medium=p[1])


@dataclass
class AllBlocksCleared:
    def to_tagged_union(self) -> List[Any]:
        return [ALL_BLOCKS_CLEARED_TAG]

    @classmethod
    def from_payload(cls, payload: Sequence[Any]) -> "AllBlocksCleared":
        return cls()


Event = Union[BlockStored, BlockRemoved, AllBlocksCleared]

_TAG_TO_CLS = {
    BLOCK_STORED_TAG: BlockStored,
    BLOCK_REMOVED_TAG: BlockRemoved,
    ALL_BLOCKS_CLEARED_TAG: AllBlocksCleared,
}


@dataclass
class EventBatch:
    ts: float
    events: List[Event]
    data_parallel_rank: Optional[int] = None

    def to_msgpack(self) -> bytes:
        arr: List[Any] = [self.ts, [e.to_tagged_union() for e in self.events]]
        if self.data_parallel_rank is not None:
            arr.append(self.data_parallel_rank)
        return msgpack_codec.packb(arr)

    @classmethod
    def from_msgpack(cls, payload: bytes) -> "EventBatch":
        arr = msgpack_codec.unpackb(payload)
        if not isinstance(arr, (list, tuple)) or len(arr) < 2:
            raise ValueError("malformed event batch: expected [ts, events, ...]")
        ts = float(arr[0])
        events: List[Event] = []
        for tagged in arr[1]:
            if not isinstance(tagged, (list, tuple)) or not tagged:
                raise ValueError("malformed tagged union in event batch")
            tag, payload_parts = tagged[0], tagged[1:]
            cls_for_tag = _TAG_TO_CLS.get(tag)
            if cls_for_tag is None:
                continue  # unknown event type: skip, don't poison the batch
            events.append(cls_for_tag.from_payload(payload_parts))
        dp_rank = arr[2] if len(arr) > 2 else None
        return cls(ts=ts, events=events, data_parallel_rank=dp_rank)
