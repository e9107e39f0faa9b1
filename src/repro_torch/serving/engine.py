"""Continuous-batching serving engine fused with distributed feature joins.

PyTorch port of ``repro/serving/engine.py``: the paper's thesis — deep
learning and data engineering in one program — as one serving loop,

admission -> feature fetch -> slot prefill -> continuous-batching decode

* **Admission** (:class:`~repro_torch.serving.queue.AdmissionQueue`):
  bounded, rejections counted.
* **Feature fetch** (:class:`FeatureStore`): each request's drug and cell
  keys resolve against feature tables resident on the device through the
  port's own distributed operators — the table is hash-shuffled once at
  ingest (streamed from host in morsels), and every micro-batch of keys
  runs shuffle + local join (``dist_join`` with the build-side shuffle
  hoisted out of the request path).
* **Slot prefill** (``models.model.make_slot_prefill``): prompts are
  right-padded to one fixed shape; on the card every attention layer
  runs the flash-attention kernel and every Mamba layer the
  selective-scan kernel; the prompt's cache (KV, or Mamba conv and ssm
  state) is written into the running batch cache at the freed slot
  (``models.model.write_cache_slot``).  A model with Mamba layers is
  prefilled at the prompt's true length, never on the padding: its state
  has no positions to mask, so a state that ran on through the padding
  would not be the prompt's.  (The JAX engine prefills the padded shape
  there; the port is held to the reference's ``make_prefill`` at the
  true length instead.)
* **Decode** (``models.model.make_serve_step`` with per-slot cache
  lengths): one step drives the whole fixed-shape batch; finished slots
  are refilled from the queue at once.

Under a ``policy`` over several ranks (the reference's
``ServingEngine(..., policy=)``) every rank runs its own engine on the
same requests: it holds its slice of the weights (under ``fsdp_tp`` at
a data axis of several ranks a 2D slice, gathered over the data group a
layer at a time in every forward; whole over ``pod``) and its heads'
caches.  The slots split over the batch ranks (pod x data, pod major)
in contiguous blocks where they divide (``sharding.batch_block``; else
every batch rank holds them all, as the reference keeps an indivisible
batch whole): a rank's cache holds its block.  Admission, refill and
the choice of slot stay global, so every rank makes the same choices; a
slot prefill (one row) runs whole on every batch rank and its cache is
written only by the slot's owner; a decode step runs each rank's block
and its greedy tokens come from the logits gathered over the batch and
model groups, the same bits on every
rank, so the ranks take the same steps.  The feature stores are given a
context over all ranks and run their shuffles at that world size.

The reference donates the cache buffers to its jitted steps; here the
cache is one set of tensors updated in place by every prefill write and
decode step.  Every stage reports into
:class:`~repro_torch.serving.metrics.ServingMetrics`.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Mapping

import numpy as np
import torch

from ..core import dist_ops as D
from ..core import local_ops as L
from ..core import morsel as Mo
from ..core.context import HptmtContext
from ..core import kernel_backend as KB
from ..core.table import narrow_column
from ..models import model as M
from ..models import sharding as Sh
from .batcher import SlotBatch
from .metrics import ServingMetrics
from .queue import AdmissionQueue

__all__ = ["Request", "FeatureStore", "ServingEngine"]


# --------------------------------------------------------------------------
# Requests
# --------------------------------------------------------------------------


@dataclasses.dataclass
class Request:
    """One serving request: a prompt to decode plus feature-table keys.

    ``status`` walks ``queued -> active -> done`` (or ``rejected`` at the
    admission queue / ``feature_miss`` when a key has no feature row —
    both *counted* terminals, never silent)."""

    req_id: int
    prompt: np.ndarray                      # (L,) int32 token ids
    gen_len: int                            # tokens to generate (>= 1)
    drug_id: int | None = None
    cell_id: int | None = None
    status: str = "new"
    features: dict[str, float] | None = None
    out_tokens: list[int] = dataclasses.field(default_factory=list)
    t_submit: float = 0.0
    t_admit: float = 0.0
    t_first: float = 0.0
    t_done: float = 0.0


# --------------------------------------------------------------------------
# Feature store: resident distributed feature table + lookup
# --------------------------------------------------------------------------


class FeatureStore:
    """Device-resident distributed feature table with a lookup path.

    ``source`` (a column mapping or a :class:`~repro_torch.core.morsel
    .ChunkedTable`) is ingested once: each host morsel is hash-shuffled
    on ``key_col`` and appended into this rank's resident accumulator
    (``local_ops.append_rows``).  Keys must be unique.

    ``lookup(keys)`` resolves a micro-batch of keys as ``dist_join`` does
    — shuffle the probe on the key, local inner join, collect — with the
    build-side shuffle done once at ingest.  ``contains(keys)`` is the
    membership path (shuffle + local ``isin``).  Slabs are sized
    skew-proof (every key of a micro-batch may hash to one rank), so
    lookups never drop; any overflow (ingest imbalance past
    ``overcommit``) is counted in ``self.dropped``, summed over ranks.
    """

    def __init__(self, ctx: HptmtContext, key_col: str, source, *,
                 probe_capacity: int, chunk_rows: int | None = None,
                 overcommit: float = 2.0,
                 resident_capacity_per_shard: int | None = None):
        if probe_capacity <= 0:
            raise ValueError("probe_capacity must be positive")
        self.ctx = ctx
        self.key_col = key_col
        self.probe_capacity = int(probe_capacity)
        self.dropped = 0
        world = ctx.world_size

        if isinstance(source, Mo.ChunkedTable):
            src = source
        else:
            cols = {k: np.asarray(v) for k, v in source.items()}
            n = len(next(iter(cols.values())))
            src = Mo.ChunkedTable(cols, chunk_rows or max(n, 1))
        if key_col not in src.names:
            raise ValueError(f"key column {key_col!r} not in source "
                             f"columns {src.names}")
        self.n_rows = src.nrows
        self.feature_cols = tuple(k for k in src.names if k != key_col)

        rcap = resident_capacity_per_shard or max(
            1, math.ceil(src.nrows / world * overcommit))
        acc = D.distribute_table(
            ctx, {k: narrow_column(k, v[:0]) for k, v in
                  src.columns.items()},
            capacity_per_shard=rcap)

        def ingest_step(c, a, chunk):
            # skew-proof slab: a whole morsel may hash to one rank, so
            # ingest itself never drops (only the resident append can
            # overflow, counted, past `overcommit`)
            per = chunk.capacity
            sh, d = D.shuffle(c, chunk, [key_col], slots_per_dest=per,
                              out_capacity=c.world_size * per)
            a2, ad = L.append_rows(a, sh)
            return a2, d + c.psum(ad)

        ingest = D.DistributedPipeline(ctx, ingest_step)
        for g in src.distribute(ctx):
            acc, d = ingest(acc, g)
            self.dropped += int(d)
        self.resident = acc

        # probe sizing: a micro-batch of `probe_capacity` keys, every one
        # of which may route to a single rank (skewed/hot keys)
        pcap = max(1, math.ceil(self.probe_capacity / world))
        self._probe_cap_per_shard = pcap
        out_cap = world * pcap

        def lookup_step(c, build, probe):
            sh, d = D.shuffle(c, probe, [key_col], slots_per_dest=pcap,
                              out_capacity=out_cap)
            out, jd = L.join(sh, build, left_on=[key_col], how="inner",
                             out_capacity=out_cap, return_overflow=True,
                             may_plan=False)
            return out, d + c.psum(jd)

        def contains_step(c, build, probe):
            sh, d = D.shuffle(c, probe, [key_col], slots_per_dest=pcap,
                              out_capacity=out_cap)
            mask, over = L.isin(sh, key_col, build, key_col,
                                return_overflow=True, may_plan=False)
            return L.select(sh, mask), d + c.psum(over)

        self._lookup = D.DistributedPipeline(ctx, lookup_step)
        self._contains = D.DistributedPipeline(ctx, contains_step)

    # ---------------------------------------------------------------- probes
    def _distribute_probe(self, keys: np.ndarray):
        keys = np.asarray(keys)
        if keys.ndim != 1:
            raise ValueError("keys must be 1-D")
        if len(keys) > self.probe_capacity:
            raise ValueError(f"{len(keys)} keys exceed probe_capacity "
                             f"{self.probe_capacity}")
        probe = {self.key_col: keys.astype(np.int32),
                 "_req": np.arange(len(keys), dtype=np.int32)}
        return D.distribute_table(
            self.ctx, probe,
            capacity_per_shard=self._probe_cap_per_shard)

    def lookup(self, keys: np.ndarray):
        """Resolve ``keys`` -> ``(features, found)``: ``features`` maps each
        feature column to a ``(len(keys),)`` array aligned with ``keys``
        (zeros where missing) and ``found`` flags which keys had a row."""
        k = len(np.asarray(keys))
        out, d = self._lookup(self.resident, self._distribute_probe(keys))
        self.dropped += int(d)
        cols = D.collect_table(self.ctx, out)
        req = cols.pop("_req")
        found = np.zeros(k, bool)
        found[req] = True
        feats = {}
        for name in self.feature_cols:
            buf = np.zeros(k, cols[name].dtype)
            buf[req] = cols[name]
            feats[name] = buf
        return feats, found

    def contains(self, keys: np.ndarray) -> np.ndarray:
        """Membership mask over ``keys`` (the semi-join path — no feature
        materialization)."""
        k = len(np.asarray(keys))
        out, d = self._contains(self.resident,
                                self._distribute_probe(keys))
        self.dropped += int(d)
        cols = D.collect_table(self.ctx, out)
        found = np.zeros(k, bool)
        found[cols["_req"]] = True
        return found


# --------------------------------------------------------------------------
# The engine
# --------------------------------------------------------------------------


class ServingEngine:
    """Admission queue -> feature fetch -> slot prefill -> continuous
    decode (see module docstring).

    ``feature_stores`` maps a request attribute name (``"drug_id"`` /
    ``"cell_id"``) to the :class:`FeatureStore` resolving it; every store's
    ``probe_capacity`` must admit a full refill micro-batch (``slots``).
    ``params`` live on ``device`` (``None`` = the CUDA card), this
    rank's slice of them under a ``policy`` over several ranks; ``attn_impl=None``
    and ``mamba_impl=None`` take the attention and scan paths that device
    implies (``kernel_backend.attention_impl``,
    ``kernel_backend.mamba_impl``)."""

    def __init__(self, cfg, params, *, policy=None, slots: int = 4,
                 prompt_capacity: int = 32, gen_capacity: int = 32,
                 queue_capacity: int = 64,
                 feature_stores: Mapping[str, FeatureStore] | None = None,
                 attn_impl: str | None = None,
                 mamba_impl: str | None = None, device=None,
                 clock=time.perf_counter):
        if cfg.frontend != "none" or cfg.is_encdec:
            raise ValueError("ServingEngine serves decoder-only LM "
                             "configs (no frontend/encoder)")
        self.device = KB.resolve_device(device)
        self.cfg = cfg
        self.params = params
        self.clock = clock
        self.n_slots = int(slots)
        self.prompt_capacity = int(prompt_capacity)
        self.gen_capacity = int(gen_capacity)
        self.decode_len = self.prompt_capacity + self.gen_capacity
        self.attn_impl = attn_impl or KB.attention_impl(self.device)
        self.mamba_impl = mamba_impl or KB.mamba_impl(self.device)
        self.feature_stores = dict(feature_stores or {})
        for name, store in self.feature_stores.items():
            if store.probe_capacity < self.n_slots:
                raise ValueError(
                    f"feature store {name!r} probe_capacity "
                    f"{store.probe_capacity} < slots {self.n_slots}")

        self.metrics = ServingMetrics()
        self.queue = AdmissionQueue(queue_capacity, self.metrics)
        self.batch = SlotBatch(self.n_slots)
        self._finished: list[Request] = []

        # one static-shape cache for the whole engine lifetime: this
        # rank's block of the slots
        self._rows = Sh.batch_block(policy, self.n_slots)
        self.caches = M.init_caches(cfg, self.n_slots, self.decode_len,
                                    self.device, policy=policy)
        self._slot_prefill = M.make_slot_prefill(
            cfg, policy, decode_len=self.decode_len,
            attn_impl=self.attn_impl, mamba_impl=self.mamba_impl)
        self._serve_step = M.make_serve_step(cfg, policy)

    # ------------------------------------------------------------ admission
    def submit(self, req: Request) -> bool:
        """Offer a request to the admission queue.  Returns False (and the
        rejection is counted) under backpressure — the caller may retry."""
        if not (1 <= len(req.prompt) <= self.prompt_capacity):
            raise ValueError(f"prompt length {len(req.prompt)} outside "
                             f"[1, {self.prompt_capacity}]")
        if not (1 <= req.gen_len <= self.gen_capacity):
            raise ValueError(f"gen_len {req.gen_len} outside "
                             f"[1, {self.gen_capacity}]")
        req.t_submit = self.clock()
        ok = self.queue.offer(req)
        req.status = "queued" if ok else "rejected"
        return ok

    # -------------------------------------------------------- feature fetch
    def _fetch_features(self, reqs: list[Request]) -> list[Request]:
        """One batched lookup per store for a refill micro-batch; requests
        whose key has no feature row terminate as counted
        ``feature_miss``es.  Returns the requests that resolved fully."""
        if not self.feature_stores:
            return reqs
        ok = np.ones(len(reqs), bool)
        fetched: dict[int, dict] = {i: {} for i in range(len(reqs))}
        for attr, store in self.feature_stores.items():
            keys = np.asarray([getattr(r, attr) for r in reqs])
            feats, found = store.lookup(keys)
            ok &= found
            self.metrics.inc("feature_rows", int(found.sum()))
            if store.dropped:
                self.metrics.counters["feature_dropped"] = sum(
                    s.dropped for s in self.feature_stores.values())
            for i in range(len(reqs)):
                if found[i]:
                    for name, col in feats.items():
                        fetched[i][name] = float(col[i])
        good = []
        for i, r in enumerate(reqs):
            if ok[i]:
                r.features = fetched[i]
                good.append(r)
            else:
                r.status = "feature_miss"
                r.t_done = self.clock()
                self.metrics.inc("feature_misses")
                self._finished.append(r)
        return good

    # --------------------------------------------------------------- refill
    def _refill(self) -> None:
        free = self.batch.free()
        n = min(len(free), len(self.queue))
        if n == 0:
            return
        reqs = [self.queue.pop() for _ in range(n)]
        reqs = self._fetch_features(reqs)
        for r in reqs:
            slot = self.batch.free()[0]
            prompt_len = len(r.prompt)
            padded = np.zeros((1, self.prompt_capacity), np.int32)
            padded[0, :prompt_len] = r.prompt
            logits, one = self._slot_prefill(
                self.params, {"tokens": torch.from_numpy(padded)
                              .to(self.device)}, prompt_len)
            M.write_cache_slot(self.caches, one, slot, self._rows)
            first_tok = int(torch.argmax(logits, -1)[0])
            now = self.clock()
            r.t_admit = now
            r.t_first = now
            r.status = "active"
            r.out_tokens.append(first_tok)
            self.metrics.inc("admitted")
            self.metrics.inc("prefills")
            self.metrics.inc("tokens_generated")
            self.metrics.observe("queue_wait", now - r.t_submit)
            self.metrics.observe("ttft", now - r.t_submit)
            if r.gen_len == 1:          # prefill's token was the answer
                self._complete(r)
                continue
            self.batch.occupy(slot, r, first_token=first_tok,
                              prompt_len=prompt_len, gen_target=r.gen_len)
        self.metrics.gauge("slot_occupancy", self.batch.occupancy)

    def _complete(self, r: Request) -> None:
        r.status = "done"
        r.t_done = self.clock()
        self.metrics.inc("completed")
        self.metrics.observe("latency", r.t_done - r.t_submit)
        self._finished.append(r)

    # ----------------------------------------------------------------- step
    def step(self) -> list[Request]:
        """Refill freed slots from the queue, run one decode step over the
        fixed-shape batch, and return the requests that finished."""
        self._refill()
        active = self.batch.active()
        if active:
            logits, self.caches = self._serve_step(
                self.params, self.caches,
                torch.from_numpy(self.batch.tokens).to(self.device),
                self.batch.cache_lens.copy())
            nxt = torch.argmax(logits, -1).to(torch.int32)[:, None] \
                .cpu().numpy()
            self.metrics.inc("decode_steps")
            self.metrics.inc("tokens_generated", len(active))
            finished = self.batch.advance(
                nxt, on_token=lambda s, r, t: r.out_tokens.append(t))
            for slot in finished:
                self._complete(self.batch.release(slot))
            self.metrics.gauge("slot_occupancy", self.batch.occupancy)
        done, self._finished = self._finished, []
        return done

    @property
    def busy(self) -> bool:
        return bool(len(self.queue) or self.batch.active())

    def run_until_drained(self, max_steps: int = 1_000_000):
        """Step until the queue and every slot are empty; returns all
        requests that finished along the way."""
        out = []
        steps = 0
        while self.busy:
            out.extend(self.step())
            steps += 1
            if steps > max_steps:
                raise RuntimeError(f"engine not drained after "
                                   f"{max_steps} steps")
        return out
