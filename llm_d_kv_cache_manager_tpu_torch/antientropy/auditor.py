"""Sampled residency audits: actively reconciling index vs reality.

Copy of the reference package's `antientropy/auditor.py`; the tiers it
re-admits at are configurable (`AuditorConfig.device_tier`/`host_tier`, the
reference's "hbm"/"host" by default) so pods that advertise "gpu" and "cpu" get
their re-admissions under the names they publish. Fetch-miss feedback
(feedback.py) only heals placements the data plane happens to touch, and
truth-weighted scoring (tracker.py) only demotes — neither REPAIRS divergence
the traffic never exercises. This auditor closes the loop: on a clock-driven
cadence it samples each pod's advertised entries from the index's exported
view, challenges the pod through a cheap resident-set digest
(`EnginePod.resident_block_digest` — per-tier membership bits plus a bounded
sample of actually-resident hashes), and repairs BOTH directions of divergence:

- **phantom entries** (advertised, not resident): purged via the
  targeted `Index.remove_entries`, per tier — a wiped device cache does
  not disprove a still-staged host copy, and vice versa;
- **unknown residents** (resident, not advertised): re-admitted exactly
  as a BlockStored digest would have landed them — `index.add` under the
  pod's identity at the digest's tier. (This build's engines hash blocks
  with the same chunked chain the request keys use, so engine key ==
  request key; a deployment bridging foreign engine hashes would route
  re-admissions through its event pool instead.)

Sampling keeps each round O(sample × pods), seeded so a round's choice
of challenged entries is a pure function of (seed, round) — replayable
under a fault run. Per-round verdicts feed the trust tracker's accuracy
EWMA, which is what lets a sampled audit protect even the entries it
never challenged: a pod caught lying on a sample is demoted everywhere
until later samples come back clean.
"""

from __future__ import annotations

import random
import time
from collections import defaultdict
from dataclasses import dataclass
from typing import Callable, Dict, Optional

from llm_d_kv_cache_manager_tpu_torch.kvcache.kvblock.key import (
    Key,
    PodEntry,
    base_pod_identifier,
)
from llm_d_kv_cache_manager_tpu_torch.utils import logging as kvlog

logger = kvlog.get_logger("antientropy.auditor")

# Tier families the digest surface distinguishes (kvcache/backend.py
# names + GPU-era aliases).
DEVICE_TIERS = frozenset({"hbm", "gpu", "device"})
HOST_TIERS = frozenset({"host", "cpu"})


@dataclass
class AuditorConfig:
    # Audit cadence; tick() before this much clock has passed is a no-op.
    interval_s: float = 10.0
    # Advertised entries challenged per (pod, tier-family) per round.
    sample_per_pod: int = 16
    # Cap on resident-sample hashes requested from each pod per round
    # (the re-admit direction); 0 disables re-admission entirely.
    readmit_sample: int = 32
    # Suspicion-triggered escalation: a pod whose trust EWMA sits below
    # the tracker's distrust threshold gets its ENTIRE advertised set
    # challenged (capped at escalate_cap per tier) instead of a sample —
    # a pod caught lying on a sample earns a full reconciliation, which
    # is what clears the phantoms the sample never touched. Requires a
    # tracker; False keeps every round at sample size.
    escalate_full: bool = True
    escalate_cap: int = 4096
    # Seed for the per-round sample choice (deterministic replays).
    seed: int = 0
    # Tier names a re-admission lands under, one per digest family. The
    # reference writes "hbm" and "host"; pods that advertise "gpu" and
    # "cpu" set those, so a re-admitted entry is the one their BlockStored
    # would have written.
    device_tier: str = "hbm"
    host_tier: str = "host"


class ResidencyAuditor:
    """Clock-injected, pull-based auditor (tick() from the caller's
    cadence — no background thread, same discipline as fleethealth).

    `digest_fn(pod_identifier, device_hashes, host_hashes, max_extra)`
    answers a pod's residency challenge: a dict with `device`/`host`
    membership sets over the challenged hashes and bounded
    `extra_device`/`extra_host` samples of resident hashes, or None when
    the pod is unreachable (that round skips it — unreachability is
    fleethealth's signal, not divergence evidence).
    """

    def __init__(
        self,
        index,
        model_name: str,
        digest_fn: Callable,
        tracker=None,
        config: Optional[AuditorConfig] = None,
        clock: Callable[[], float] = time.monotonic,
    ):
        self.index = index
        self.model_name = model_name
        self.digest_fn = digest_fn
        self.tracker = tracker
        self.config = config or AuditorConfig()
        self.clock = clock
        self._last_audit_t: Optional[float] = None
        self._round = 0
        self.stats = {
            "rounds": 0, "pods_audited": 0, "pods_unreachable": 0,
            "entries_challenged": 0, "phantoms_purged": 0,
            "blocks_readmitted": 0, "escalated_audits": 0,
        }

    # -- cadence -----------------------------------------------------------

    def tick(self, now: Optional[float] = None) -> bool:
        """Run one audit round if the interval elapsed. Returns whether a
        round ran (the sim drains the event pool only when it did)."""
        if now is None:
            now = self.clock()
        if (
            self._last_audit_t is not None
            and now - self._last_audit_t < self.config.interval_s
        ):
            return False
        self._last_audit_t = now
        self.audit_once(now)
        return True

    # -- one round ---------------------------------------------------------

    def audit_once(self, now: Optional[float] = None) -> dict:
        """Audit every advertised pod once. Returns this round's verdict
        {pod: {"verified": n, "phantom": n, "purged": n, "readmitted": n}}.
        """
        if now is None:
            now = self.clock()
        self._round += 1
        rng = random.Random((self.config.seed << 20) ^ self._round)
        advertised = self._advertised_by_pod()
        # Pods the tracker distrusts stay on the audit schedule even when
        # the repair loop has purged their LAST advertised entry — an
        # empty advertised set that matches an empty resident set is a
        # CLEAN audit, and clean audits are the only road back to trust.
        pods = set(advertised)
        if self.tracker is not None:
            pods.update(
                pod for pod in self.tracker.status()["pods"]
                if self.tracker.factor_for(pod) < 1.0
            )
        verdicts: Dict[str, dict] = {}
        for pod in sorted(pods):
            per_tier = advertised.get(pod, {"device": [], "host": []})
            device_adv = per_tier.get("device", [])
            host_adv = per_tier.get("host", [])
            k = self.config.sample_per_pod
            if (
                self.config.escalate_full
                and self.tracker is not None
                and self.tracker.accuracy(pod)
                < self.tracker.config.distrust_threshold
            ):
                # Escalated round: the sample caught this pod lying;
                # reconcile everything it still advertises.
                k = max(k, self.config.escalate_cap)
                self.stats["escalated_audits"] += 1
            device_sample = (
                rng.sample(device_adv, k) if len(device_adv) > k
                else list(device_adv)
            )
            host_sample = (
                rng.sample(host_adv, k) if len(host_adv) > k
                else list(host_adv)
            )
            try:
                digest = self.digest_fn(
                    pod, device_sample, host_sample,
                    self.config.readmit_sample,
                )
            except Exception as e:  # noqa: BLE001 - a dead pod must not
                # unwind the round; its turn comes again next interval.
                logger.debug("residency digest for %s failed: %s", pod, e)
                digest = None
            if digest is None:
                self.stats["pods_unreachable"] += 1
                continue
            verdict = self._reconcile(
                pod, device_sample, host_sample, per_tier, digest
            )
            verdicts[pod] = verdict
            self.stats["pods_audited"] += 1
            self.stats["entries_challenged"] += (
                len(device_sample) + len(host_sample)
            )
            self.stats["phantoms_purged"] += verdict["purged"]
            self.stats["blocks_readmitted"] += verdict["readmitted"]
            if self.tracker is not None:
                self.tracker.observe_audit(
                    pod,
                    verified=verdict["verified"],
                    phantom=verdict["phantom"],
                    purged=verdict["purged"],
                    readmitted=verdict["readmitted"],
                    now=now,
                )
        self.stats["rounds"] += 1
        return verdicts

    def _advertised_by_pod(self) -> Dict[str, Dict[str, list]]:
        """Project the index view into {base_pod: {"device": [hashes],
        "host": [hashes]}} for this model. One export per round — the
        price of sampling without a per-pod reverse index; rounds are
        periodic and the view walk is allocation-light."""
        view = self.index.export_view()
        out: Dict[str, Dict[str, list]] = defaultdict(
            lambda: {"device": [], "host": []}
        )
        for model_name, chunk_hash, pods in view.entries:
            if model_name != self.model_name:
                continue
            for pod, tier in pods:
                if tier in DEVICE_TIERS:
                    out[base_pod_identifier(pod)]["device"].append(chunk_hash)
                elif tier in HOST_TIERS:
                    out[base_pod_identifier(pod)]["host"].append(chunk_hash)
        return out

    def _reconcile(
        self, pod: str, device_sample, host_sample, per_tier, digest: dict
    ) -> dict:
        verified = 0
        purged = 0
        phantom_device = [
            h for h in device_sample if h not in digest.get("device", ())
        ]
        phantom_host = [
            h for h in host_sample if h not in digest.get("host", ())
        ]
        verified = (
            len(device_sample) - len(phantom_device)
            + len(host_sample) - len(phantom_host)
        )
        if phantom_device:
            purged += self.index.remove_entries(
                pod,
                [Key(self.model_name, h) for h in phantom_device],
                device_tiers=DEVICE_TIERS,
            )
        if phantom_host:
            purged += self.index.remove_entries(
                pod,
                [Key(self.model_name, h) for h in phantom_host],
                device_tiers=HOST_TIERS,
            )
        readmitted = 0
        if self.config.readmit_sample > 0:
            advertised_device = set(per_tier.get("device", ()))
            advertised_host = set(per_tier.get("host", ()))
            readmitted += self._readmit(
                pod, digest.get("extra_device", ()), advertised_device,
                self.config.device_tier,
            )
            readmitted += self._readmit(
                pod, digest.get("extra_host", ()), advertised_host,
                self.config.host_tier,
            )
        phantom = len(phantom_device) + len(phantom_host)
        if phantom or readmitted:
            logger.info(
                "residency audit: pod %s — %d/%d challenged entries "
                "verified, %d phantom (purged %d), %d resident block(s) "
                "re-admitted",
                pod, verified, verified + phantom, phantom, purged,
                readmitted,
            )
        return {
            "verified": verified, "phantom": phantom,
            "purged": purged, "readmitted": readmitted,
        }

    def _readmit(self, pod: str, resident, advertised: set, tier: str) -> int:
        """Re-admit resident-but-unadvertised blocks at the digest's
        tier, exactly as a BlockStored digest would land them (engine key
        == request key in this build — module docstring)."""
        unknown = [h for h in resident if h not in advertised]
        if not unknown:
            return 0
        keys = [Key(self.model_name, h) for h in unknown]
        try:
            self.index.add(keys, keys, [PodEntry(pod, tier)])
        except ValueError as e:
            logger.debug("re-admit for %s failed: %s", pod, e)
            return 0
        return len(unknown)

    def register_knobs(self, registry) -> None:
        """Publish the audit cadence to the autopilot
        (autopilot/knobs.py). tick() compares against the config on
        every call, so tightening the interval takes effect on the next
        tick. Bounds are relative to the configured baseline: the
        controller can audit up to 8x faster under a hit-rate burn
        (divergence repair is the lever) and never slower than 4x the
        operator's cadence."""
        from llm_d_kv_cache_manager_tpu_torch.autopilot.knobs import (
            KNOB_AUDIT_INTERVAL,
            KnobSpec,
        )

        cfg = self.config
        base = cfg.interval_s
        registry.register(
            KnobSpec(
                name=KNOB_AUDIT_INTERVAL,
                floor=base / 8.0,
                ceiling=base * 4.0,
                max_step=base / 2.0,
                description="residency-audit cadence in seconds",
            ),
            get=lambda: cfg.interval_s,
            set_=lambda v: setattr(cfg, "interval_s", float(v)),
        )

    # -- introspection -----------------------------------------------------

    def status(self) -> dict:
        return {
            "last_audit_t": self._last_audit_t,
            "interval_s": self.config.interval_s,
            "sample_per_pod": self.config.sample_per_pod,
            **self.stats,
        }
