"""Transfer-vs-recompute cost model for the host tier.

Port of the reference package's `engine/costs.py`. Whether moving a KV
block beats recomputing it is arithmetic intensity: restoring a block costs
its `kv_bytes_per_token` over the transfer path's rate, recomputing it costs
the model's `flops_per_token` over the card's prefill rate. `TransferCostModel`
turns that into a decision for a chain of blocks.

The rates are the port's own: `MEASURED_RATES` holds the four rates that
chip_smoke.py's phase 8 measures on the card (the loopback host store, the
transfer wire between two pods, the codec's host-to-device insert, and the
flagship's prefill FLOP/s), with the card and run they came from. An
explicit `rates=` argument overrides them.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional, Sequence

# Block sources a restorable chain prefix can mix, in the order load_chain
# resolves them: a payload the prefetcher already fetched into host RAM
# ("ready", pays only the device insert), the local host store ("staged",
# loopback fetch + insert), a peer pod over the transfer wire ("peer",
# network fetch + insert).
READY, STAGED, PEER = "ready", "staged", "peer"

# Rates measured by chip_smoke.py phase 8 on bf16 pages (medians of 5
# calls; the first recorded run of PERF.md's host-tier readings): bytes/s
# of the flagship's 64-block prefix through each path (staged: loopback
# store fetch + insert; peer: the wire's fetch + insert; insert: the codec's
# host-to-device insert alone) and the flagship's recompute rate
# (flops_per_token x 1,536 tokens over the median time to first token of a
# fresh pod).
MEASURED_RATES = {
    "staged_bytes_per_s": 257590411.29314822,
    "peer_bytes_per_s": 264279461.66998288,
    "insert_bytes_per_s": 3942978547.391944,
    "compute_flops_per_s": 105289264850309.97,
    "source": "chip_smoke.py phase 8 (bf16 pages) on NVIDIA H100 80GB HBM3, 700.00 W",
}


def flops_per_token(model_config) -> float:
    """~2 FLOPs per parameter touched per token: attention projections +
    gated MLP (a MoE model's top_k experts and its router). The LM head is
    left out: this prices recomputing cached prefix blocks, whose tokens
    never produce logits."""
    c = model_config
    attn = (
        c.d_model * c.n_q_heads * c.head_dim  # wq
        + 2 * c.d_model * c.n_kv_heads * c.head_dim  # wk, wv
        + c.n_q_heads * c.head_dim * c.d_model  # wo
    )
    mlp = 3 * c.d_model * c.d_ff  # gate, up, down
    # The MoE family (models/mixtral.py) activates top_k experts per token.
    n_experts_active = getattr(c, "top_k", None)
    if getattr(c, "n_experts", 0) and n_experts_active:
        mlp = n_experts_active * mlp + c.d_model * c.n_experts  # + router
    return 2.0 * c.n_layers * (attn + mlp)


def kv_bytes_per_token(model_config, quantized: bool = False) -> float:
    """Bytes of KV cache one token occupies across all layers: its share of
    a block payload (engine._DevicePageCodec layout: (k, v) in the model
    dtype, or the int8 (k_q, k_scale, v_q, v_scale) with one f32 scale per
    row)."""
    c = model_config
    rows = 2 * c.n_layers * c.n_kv_heads  # k and v, every layer, every head
    if quantized:
        return rows * (c.head_dim * 1 + 4)  # int8 row + f32 scale
    return rows * c.head_dim * c.dtype.itemsize


@dataclass(frozen=True)
class TransferCostModel:
    """Per-token seconds for this pod's model on this card. `margin` < 1
    demands transfer beat recompute by that factor; > 1 tolerates slower
    transfers."""

    recompute_s: float
    staged_restore_s: float
    onboard_s: float
    insert_s: float
    margin: float = 1.0
    source: str = ""

    def per_token(self, source: str) -> float:
        return {
            READY: self.insert_s,
            STAGED: self.staged_restore_s,
            PEER: self.onboard_s,
        }[source]

    def admit_prefix(self, sources: Sequence[str], page_size: int) -> int:
        """Longest chain prefix worth restoring. Restoring k blocks saves
        k * page_size tokens of recompute and costs the sum of their
        transfer times; admit the longest prefix whose cumulative cost stays
        within margin x savings (an expensive block can ride on the cheap
        ones behind it: chains restore as prefixes, never with holes)."""
        budget_per_block = self.margin * self.recompute_s * page_size
        cost = 0.0
        admitted = 0
        for i, source in enumerate(sources):
            cost += self.per_token(source) * page_size
            if cost <= budget_per_block * (i + 1):
                admitted = i + 1
        return admitted

    def with_margin(self, margin: float) -> "TransferCostModel":
        return replace(self, margin=margin)

    @classmethod
    def from_rates(
        cls,
        *,
        model_flops_per_token: float,
        model_kv_bytes_per_token: float,
        rates: Optional[dict] = None,
        margin: float = 1.0,
    ) -> "TransferCostModel":
        rates = rates or MEASURED_RATES
        if rates is None:
            raise ValueError("no transfer rates: pass rates= (MEASURED_RATES is unset)")
        return cls(
            recompute_s=model_flops_per_token / rates["compute_flops_per_s"],
            staged_restore_s=model_kv_bytes_per_token / rates["staged_bytes_per_s"],
            onboard_s=model_kv_bytes_per_token / rates["peer_bytes_per_s"],
            insert_s=model_kv_bytes_per_token / rates["insert_bytes_per_s"],
            margin=margin,
            source=rates["source"],
        )

    @classmethod
    def for_model(
        cls,
        model_config,
        quantized: bool = False,
        rates: Optional[dict] = None,
        margin: float = 1.0,
    ) -> "TransferCostModel":
        """The gate an EnginePod builds for its own model: the card's rates
        x this model's arithmetic intensity."""
        return cls.from_rates(
            model_flops_per_token=flops_per_token(model_config),
            model_kv_bytes_per_token=kv_bytes_per_token(model_config, quantized=quantized),
            rates=rates,
            margin=margin,
        )


#: Gate that admits every restorable block: tests that pin restore
#: mechanics rather than economics.
ALWAYS_TRANSFER = TransferCostModel(
    recompute_s=1.0,
    staged_restore_s=0.0,
    onboard_s=0.0,
    insert_s=0.0,
    source="always-transfer",
)

#: Gate that refuses every transfer: the degenerate "recompute everything"
#: policy, a bench arm.
NEVER_TRANSFER = TransferCostModel(
    recompute_s=0.0,
    staged_restore_s=1.0,
    onboard_s=1.0,
    insert_s=1.0,
    source="never-transfer",
)
