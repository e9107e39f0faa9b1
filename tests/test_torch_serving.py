"""The port's serving path against the JAX package's.

* The reference's host-side unit tests of the admission queue, the slot
  batcher and the metrics registry (``tests/test_serving.py``), run
  against the port's copies.
* One engine run on reduced ``lm100m`` with a feature store, mirroring
  the reference's ``served`` fixture, checked for the same invariants:
  the accounting identity, the counted ``feature_miss``, features equal
  to the joined row, nothing dropped, static cache shapes, the request
  bounds, the engine against the one-shot decode loop.
* The same requests through the JAX engine on the same weights (the
  reference's ``init_params(PRNGKey(0))`` carried across by
  ``params_from_jax``): the same statuses and features, and the same
  greedy tokens by the rule of ``tests/test_torch_model.py`` — equal up to
  the first position where the top-2 logit margin is below
  ``2 * LOGIT_TOL`` (the margins are the port's: with both packages'
  logits within ``LOGIT_TOL`` of each other, a larger margin fixes the
  argmax in both).
* Reduced ``falcon-mamba-7b`` (a Mamba stack) served by the port's
  engine: with prompts shorter than the capacity against the reference's
  ``make_prefill`` at the prompt's true length plus ``make_serve_step``
  fed the engine's tokens (the reference's own definition of SSM decode:
  its engine prefills the padded prompt, whose state is not the
  prompt's), and with prompts that fill the capacity against the JAX
  engine itself.  Logits within ``LOGIT_TOL``; tokens compared up to the
  first position whose top-2 margin is at most twice the largest logit
  difference measured (the rule of ``tests/test_torch_model.py``).
* Reduced ``granite-moe-3b-a800m`` (MoE layers) through both engines on
  the same requests, held as the dense run is.
* Reduced ``jamba-1.5-large-398b`` (period stacks: 4 layers in periods
  of 2, and 8 in periods of 4) served by the port's engine, held to the
  reference's true-length prefill and decode as the Mamba stack is (its
  Mamba sub-layers see no padding); its nested caches in the engine.
* ``append_rows`` and ``ChunkedTable`` against the reference, and the
  ``repro_torch.launch.serve`` CLI on the CPU (``lm100m``,
  ``granite-moe-3b-a800m``, ``falcon-mamba-7b`` and
  ``jamba-1.5-large-398b``).
"""
import collections
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_reduced as jax_reduced
from repro.core import local_ops as JL
from repro.core import morsel as JMo
from repro.core.context import make_context as jax_context
from repro.core.table import Table as JT
from repro.models import model as JM
from repro import serving as JS
from repro_torch.configs import get_reduced
from repro_torch.core import local_ops as L
from repro_torch.core import morsel as Mo
from repro_torch.core.context import make_context
from repro_torch.core.table import Table
from repro_torch.models import model as M
from repro_torch.serving import (AdmissionQueue, FeatureStore, Request,
                                 ServingEngine, ServingMetrics, SlotBatch)

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
LOGIT_TOL = 2e-2       # as tests/test_torch_model.py, for the same reason
MOE = "granite-moe-3b-a800m"
@pytest.fixture(scope="module", autouse=True)
def _clear_jax_caches():
    """The JAX engines built here fill ``jax.jit`` caches that outlive the
    module, and ``tests/test_serving.py``, when it runs later in the same
    process, counts its engine's compiled executables: drop them when
    the module ends."""
    yield
    jax.clear_caches()


# (prompt length, gen_len) of the served run, as the reference's fixture:
# the gen_len = 1 edge and one key with no feature row (request 3)
SHAPES = [(12, 6), (1, 1), (5, 3), (9, 2), (3, 4), (7, 1), (2, 5), (11, 3)]


# --------------------------------------------------------------------------
# the reference's host-side unit tests, on the port's copies
# --------------------------------------------------------------------------


def test_queue_rejects_counted_at_capacity():
    m = ServingMetrics()
    q = AdmissionQueue(2, m)
    assert q.offer("a") and q.offer("b")
    assert not q.offer("c")          # full: refused, counted
    assert not q.offer("d")
    assert m.count("submitted") == 4
    assert m.count("rejected") == 2
    assert len(q) == 2
    assert q.pop() == "a"            # FIFO
    assert q.offer("e")              # freed capacity admits again
    assert m.count("rejected") == 2
    assert m.count("submitted") == len(q) + 1 + m.count("rejected")


def test_queue_validates_capacity():
    with pytest.raises(ValueError, match="capacity"):
        AdmissionQueue(0)
    assert AdmissionQueue(1).pop() is None


def test_slot_batch_lifecycle():
    b = SlotBatch(3)
    assert b.free() == [0, 1, 2] and b.occupancy == 0
    b.occupy(1, "r1", first_token=7, prompt_len=4, gen_target=2)
    assert b.active() == [1] and b.cache_lens[1] == 4 and b.tokens[1, 0] == 7
    with pytest.raises(ValueError, match="occupied"):
        b.occupy(1, "r2", first_token=0, prompt_len=1, gen_target=1)
    nxt = np.zeros((3, 1), np.int32)
    nxt[1, 0] = 9
    seen = []
    done = b.advance(nxt, on_token=lambda s, r, t: seen.append((s, r, t)))
    assert done == [1] and seen == [(1, "r1", 9)]
    assert b.cache_lens[1] == 5 and b.tokens[1, 0] == 9
    assert b.release(1) == "r1" and b.free() == [0, 1, 2]
    with pytest.raises(ValueError, match="free"):
        b.release(1)
    assert b.cache_lens.shape == (3,) and b.tokens.shape == (3, 1)


def test_slot_batch_advance_skips_idle_slots():
    b = SlotBatch(2)
    b.occupy(0, "r", first_token=1, prompt_len=2, gen_target=5)
    before = b.cache_lens.copy()
    b.advance(np.zeros((2, 1), np.int32))
    assert b.cache_lens[1] == before[1]
    assert b.cache_lens[0] == before[0] + 1


def test_metrics_registry():
    m = ServingMetrics()
    m.inc("x"), m.inc("x", 2)
    m.gauge("g", 3), m.gauge("g", 1)
    for v in (0.1, 0.2, 0.3):
        m.observe("lat", v)
    assert m.count("x") == 3 and m.count("missing") == 0
    assert m.gauges["g"] == {"last": 1.0, "max": 3.0}
    s = m.summary("lat")
    assert s["count"] == 3 and abs(s["p50"] - 0.2) < 1e-9
    snap = m.snapshot()
    assert snap["counters"]["x"] == 3 and "lat" in snap["latency"]
    assert m.summary("none") == {"count": 0}
    assert np.isnan(m.percentile("none", 50))


# --------------------------------------------------------------------------
# one engine run in each package on the same weights and requests
# --------------------------------------------------------------------------


def margin(logits: torch.Tensor) -> np.ndarray:
    top = torch.topk(logits.float(), 2, dim=-1).values
    return (top[..., 0] - top[..., 1]).cpu().numpy()


def record_margins(engine):
    """Make ``engine`` record each request's top-2 logit margin at every
    token it emits (prefill first, then each decode step), in the order of
    ``out_tokens``."""
    margins = collections.defaultdict(list)
    upcoming = collections.deque()
    fetch, prefill, serve = (engine._fetch_features, engine._slot_prefill,
                             engine._serve_step)

    def fetch_hook(reqs):
        good = fetch(reqs)
        upcoming.extend(good)
        return good

    def prefill_hook(params, batch, length):
        logits, caches = prefill(params, batch, length)
        margins[upcoming.popleft().req_id].append(float(margin(logits)[0]))
        return logits, caches

    def serve_hook(params, caches, tokens, cache_lens):
        logits, caches = serve(params, caches, tokens, cache_lens)
        m = margin(logits)
        for slot in engine.batch.active():
            margins[engine.batch.request_at(slot).req_id].append(
                float(m[slot]))
        return logits, caches

    engine._fetch_features = fetch_hook
    engine._slot_prefill = prefill_hook
    engine._serve_step = serve_hook
    return margins


def greedy_agree(got, want, margins, tol) -> int:
    n = 0
    for g, w, m in zip(got, want, margins):
        if m < tol:
            break
        assert g == w, f"token {n}: {g} != {w} at margin {m}"
        n += 1
    return n


def serve_all(engine, reqs):
    """Submit, drain, resubmit what the small queue rejected, drain."""
    rejected = [r for r in reqs if not engine.submit(r)]
    done = engine.run_until_drained()
    for r in rejected:
        assert engine.submit(r)
    return rejected, done + engine.run_until_drained()


def reference_weights(arch):
    """(reference cfg, its ``init_params(PRNGKey(0))``, port cfg, the
    port's copy) of a reduced config."""
    cfg = jax_reduced(arch)
    jp = JM.init_params(jax.random.PRNGKey(0), cfg)
    tcfg = get_reduced(arch)
    return cfg, jp, tcfg, M.params_from_jax(
        jax.tree_util.tree_map(np.asarray, jp), tcfg, "cpu")


@pytest.fixture(scope="module")
def weights():
    return reference_weights("lm100m")


@pytest.fixture(scope="module")
def moe_weights():
    return reference_weights(MOE)


def make_request_data(vocab):
    rng = np.random.default_rng(1)
    n_keys = 32
    feats = {"drug_id": np.arange(n_keys, dtype=np.int32),
             "d0": rng.normal(size=n_keys).astype(np.float32)}
    reqs = [(i, rng.integers(0, vocab, p_len).astype(np.int32), g,
             999 if i == 3 else i) for i, (p_len, g) in enumerate(SHAPES)]
    return feats, reqs


@pytest.fixture(scope="module")
def request_data():
    return make_request_data(1024)


ENGINE_KW = dict(slots=2, prompt_capacity=12, gen_capacity=6,
                 queue_capacity=4)


def serve_port(weights, request_data):
    """The port's engine over the requests, with a feature store."""
    _, _, cfg, params = weights
    feats, spec = request_data
    store = FeatureStore(make_context("cpu"), "drug_id", feats,
                         probe_capacity=8, chunk_rows=8)
    eng = ServingEngine(cfg, params, feature_stores={"drug_id": store},
                        device="cpu", **ENGINE_KW)
    margins = record_margins(eng)
    reqs = [Request(req_id=i, prompt=p, gen_len=g, drug_id=d)
            for i, p, g, d in spec]
    rejected, done = serve_all(eng, reqs)
    return eng, store, feats, reqs, rejected, done, margins


def serve_jax(weights, request_data):
    """The JAX package's engine over the same requests and weights."""
    cfg, params, _, _ = weights
    feats, spec = request_data
    ctx = jax_context(jax.make_mesh((1,), ("rows",)))
    store = JS.FeatureStore(ctx, "drug_id", feats, probe_capacity=8,
                            chunk_rows=8)
    eng = JS.ServingEngine(cfg, params, feature_stores={"drug_id": store},
                           **ENGINE_KW)
    reqs = [JS.Request(req_id=i, prompt=p, gen_len=g, drug_id=d)
            for i, p, g, d in spec]
    rejected, done = serve_all(eng, reqs)
    return eng, rejected, done


@pytest.fixture(scope="module")
def served(weights, request_data):
    return serve_port(weights, request_data)


@pytest.fixture(scope="module")
def jax_served(weights, request_data):
    return serve_jax(weights, request_data)


def test_engine_every_admitted_request_completes(served):
    eng, store, feats, reqs, rejected, done, _ = served
    m = eng.metrics
    assert m.count("submitted") == m.count("completed") + \
        m.count("rejected") + m.count("feature_misses")
    assert m.count("rejected") == len(rejected)
    by_id = {r.req_id: r for r in done}
    assert sorted(by_id) == list(range(len(reqs)))
    for r in done:
        if r.req_id == 3:
            assert r.status == "feature_miss"
        else:
            assert r.status == "done"
            assert len(r.out_tokens) == r.gen_len
            np.testing.assert_allclose(
                r.features["d0"], feats["d0"][r.drug_id])
    assert m.count("feature_misses") == 1
    assert store.dropped == 0


def test_engine_static_batch_shape_across_refills(served):
    eng = served[0]
    struct = M.cache_struct(eng.cfg, eng.n_slots, eng.decode_len)
    assert {k: (tuple(v.shape), v.dtype) for k, v in eng.caches.items()} \
        == struct


def test_engine_validates_request_bounds(served):
    eng = served[0]
    with pytest.raises(ValueError, match="prompt length"):
        eng.submit(Request(req_id=99, prompt=np.zeros(13, np.int32),
                           gen_len=1, drug_id=0))
    with pytest.raises(ValueError, match="gen_len"):
        eng.submit(Request(req_id=99, prompt=np.zeros(1, np.int32),
                           gen_len=7, drug_id=0))


def tokens_match(served, jax_served):
    """The same statuses, features and counts as the JAX engine, and the
    same greedy tokens up to the first margin below 2 * LOGIT_TOL."""
    _, _, _, _, rejected, done, margins = served
    jeng, jrejected, jdone = jax_served
    assert [r.req_id for r in rejected] == [r.req_id for r in jrejected]
    assert eng_counts(served[0]) == eng_counts(jeng)
    want = {r.req_id: r for r in jdone}
    compared = 0
    for r in done:
        w = want[r.req_id]
        assert r.status == w.status and r.features == w.features
        assert len(r.out_tokens) == len(w.out_tokens)
        assert len(margins[r.req_id]) == len(r.out_tokens)
        compared += greedy_agree(r.out_tokens, w.out_tokens,
                                 margins[r.req_id], 2 * LOGIT_TOL)
    assert compared >= 1


def test_engine_tokens_match_the_jax_engine(served, jax_served):
    tokens_match(served, jax_served)


def test_moe_engine_tokens_match_the_jax_engine(moe_weights):
    """Reduced granite-moe (MoE layers, 8 experts top-2) through both
    engines on the same requests, as the dense engine above."""
    data = make_request_data(moe_weights[2].vocab)
    served = serve_port(moe_weights, data)
    tokens_match(served, serve_jax(moe_weights, data))
    eng, store, feats, reqs, rejected, done, _ = served
    assert sorted(r.req_id for r in done) == list(range(len(reqs)))
    assert store.dropped == 0


def eng_counts(eng):
    return {k: eng.metrics.count(k) for k in
            ("submitted", "completed", "rejected", "feature_misses",
             "prefills", "decode_steps", "tokens_generated")}


def test_engine_matches_oneshot_greedy_decode(weights):
    """A request decoded through slot refill + per-slot cache lengths
    emits the same greedy tokens as the one-shot prefill/serve path."""
    _, _, cfg, params = weights
    P, G = 10, 5
    rng = np.random.default_rng(2)
    prefill = M.make_prefill(cfg, decode_len=P + G)
    serve = M.make_serve_step(cfg)
    for p_len in (P, 4):             # full-capacity and right-padded
        prompt = rng.integers(0, cfg.vocab, p_len).astype(np.int32)
        logits, caches = prefill(params,
                                 {"tokens": torch.from_numpy(prompt[None])})
        want = [int(logits[0].argmax())]
        for i in range(G - 1):
            logits, caches = serve(params, caches,
                                   torch.tensor([[want[-1]]]), p_len + i)
            want.append(int(logits[0].argmax()))
        eng = ServingEngine(cfg, params, slots=3, prompt_capacity=P,
                            gen_capacity=G, queue_capacity=4, device="cpu")
        req = Request(req_id=0, prompt=prompt, gen_len=G)
        assert eng.submit(req)
        done = eng.run_until_drained()
        assert done[0].out_tokens == want, f"p_len={p_len}"


def test_engine_rejects_nonlm_config():
    cfg = dataclasses.replace(get_reduced("lm100m"), frontend="vision")
    with pytest.raises(ValueError, match="decoder-only"):
        ServingEngine(cfg, params={}, slots=1)


def test_feature_store_validation_and_contains():
    ctx = make_context("cpu")
    with pytest.raises(ValueError, match="probe_capacity"):
        FeatureStore(ctx, "k", {"k": np.arange(4)}, probe_capacity=0)
    with pytest.raises(ValueError, match="key column"):
        FeatureStore(ctx, "nope", {"k": np.arange(4)}, probe_capacity=4)
    store = FeatureStore(ctx, "k", {"k": np.arange(4), "f": np.ones(4)},
                         probe_capacity=4, chunk_rows=3)
    with pytest.raises(ValueError, match="exceed"):
        store.lookup(np.zeros(5, np.int32))
    with pytest.raises(ValueError, match="1-D"):
        store.lookup(np.zeros((2, 2), np.int32))
    np.testing.assert_array_equal(store.contains(np.array([3, 9, 0, 4])),
                                  [True, False, True, False])
    assert store.dropped == 0


# --------------------------------------------------------------------------
# a Mamba stack: reduced falcon-mamba-7b
# --------------------------------------------------------------------------

MAMBA = "falcon-mamba-7b"
MAMBA_KW = dict(slots=2, prompt_capacity=12, gen_capacity=6,
                queue_capacity=8)


@pytest.fixture(scope="module")
def mamba_weights():
    cfg = jax_reduced(MAMBA)
    jp = JM.init_params(jax.random.PRNGKey(0), cfg)
    tcfg = get_reduced(MAMBA)
    return cfg, jp, tcfg, M.params_from_jax(
        jax.tree_util.tree_map(np.asarray, jp), tcfg, "cpu")


def record_logits(engine):
    """Make ``engine`` keep each request's logits (float32 numpy) at every
    token it emits, in the order of ``out_tokens``."""
    logits = collections.defaultdict(list)
    upcoming = collections.deque()
    fetch, prefill, serve = (engine._fetch_features, engine._slot_prefill,
                             engine._serve_step)

    def fetch_hook(reqs):
        good = fetch(reqs)
        upcoming.extend(good)
        return good

    def prefill_hook(params, batch, length):
        lg, caches = prefill(params, batch, length)
        logits[upcoming.popleft().req_id].append(lg[0].float().numpy())
        return lg, caches

    def serve_hook(params, caches, tokens, cache_lens):
        lg, caches = serve(params, caches, tokens, cache_lens)
        for slot in engine.batch.active():
            logits[engine.batch.request_at(slot).req_id].append(
                lg[slot].float().numpy())
        return lg, caches

    engine._fetch_features = fetch_hook
    engine._slot_prefill = prefill_hook
    engine._serve_step = serve_hook
    return logits


def jax_true_length_logits(cfg, jp, req, tokens):
    """The reference's ``make_prefill`` at the prompt's true length, then
    batch-1 ``make_serve_step`` fed ``tokens``: its logits at each of the
    request's positions."""
    n = len(req.prompt)
    logits, caches = jax.jit(JM.make_prefill(cfg, None, decode_len=n + 8))(
        jp, {"tokens": jnp.asarray(req.prompt[None])})
    step = jax.jit(JM.make_serve_step(cfg, None))
    out = [np.asarray(logits[0])]
    for i in range(req.gen_len - 1):
        logits, caches = step(jp, caches, jnp.asarray([[tokens[i]]],
                                                      jnp.int32),
                              jnp.int32(n + i))
        out.append(np.asarray(logits[0]))
    return out


def mamba_requests(shapes, seed):
    rng = np.random.default_rng(seed)
    return [(i, rng.integers(0, 512, p).astype(np.int32), g)
            for i, (p, g) in enumerate(shapes)]


def agree_under_margins(got_tokens, want_tokens, got_logits, want_logits):
    """Logits within LOGIT_TOL at every position; tokens equal up to the
    first position whose reference margin is at most twice the logits'
    difference there.  Returns the tokens compared."""
    n = 0
    for g, w, gl, wl in zip(got_tokens, want_tokens, got_logits,
                            want_logits, strict=True):
        diff = float(np.abs(gl - wl).max())
        assert diff <= LOGIT_TOL
        top = np.sort(wl)
        if top[-1] - top[-2] <= 2 * diff:
            break
        assert g == w, f"token {n}: {g} != {w}"
        n += 1
    return n


def test_mamba_engine_matches_the_true_length_reference(mamba_weights):
    """Prompts shorter than the capacity, right-padded by the engine: the
    port prefills the true length, so every position matches the
    reference's true-length prefill and decode."""
    cfg, jp, tcfg, tp = mamba_weights
    eng = ServingEngine(tcfg, tp, device="cpu", **MAMBA_KW)
    logits = record_logits(eng)
    reqs = [Request(req_id=i, prompt=p, gen_len=g) for i, p, g in
            mamba_requests([(5, 6), (9, 4), (1, 5), (3, 3)], seed=3)]
    for r in reqs:
        assert eng.submit(r)
    done = eng.run_until_drained()
    assert sorted(r.req_id for r in done) == [0, 1, 2, 3]
    compared = 0
    for r in done:
        assert r.status == "done" and len(r.out_tokens) == r.gen_len
        want = jax_true_length_logits(cfg, jp, r, r.out_tokens)
        # fed the engine's tokens: the same context at every position
        assert max(float(np.abs(g - w).max()) for g, w in
                   zip(logits[r.req_id], want, strict=True)) <= LOGIT_TOL
        compared += agree_under_margins(
            r.out_tokens, [int(w.argmax()) for w in want],
            logits[r.req_id], want)
    assert compared >= 1


def test_mamba_engine_full_prompts_match_the_jax_engine(mamba_weights):
    """Prompts that fill the capacity (no padding, so the JAX engine's
    state is the prompt's): the same tokens as the JAX engine, by the
    margins of the reference's one-shot loop fed the JAX engine's tokens
    (the reference holds its engine to that loop token for token)."""
    cfg, jp, tcfg, tp = mamba_weights
    spec = mamba_requests([(12, 6), (12, 4), (12, 5)], seed=4)
    eng = ServingEngine(tcfg, tp, device="cpu", **MAMBA_KW)
    logits = record_logits(eng)
    jeng = JS.ServingEngine(cfg, jp, **MAMBA_KW)
    runs = []
    for e, R in ((eng, Request), (jeng, JS.Request)):
        reqs = [R(req_id=i, prompt=p, gen_len=g) for i, p, g in spec]
        for r in reqs:
            assert e.submit(r)
        runs.append({r.req_id: r for r in e.run_until_drained()})
    assert eng_counts(eng) == eng_counts(jeng)
    compared = 0
    for rid, r in runs[0].items():
        w = runs[1][rid]
        assert r.status == w.status == "done"
        assert len(r.out_tokens) == len(w.out_tokens) == r.gen_len
        want = jax_true_length_logits(cfg, jp, w, w.out_tokens)
        compared += agree_under_margins(r.out_tokens, w.out_tokens,
                                        logits[rid], want)
    assert compared >= 1


def test_mamba_engine_caches_are_float32_states(mamba_weights):
    _, _, tcfg, tp = mamba_weights
    eng = ServingEngine(tcfg, tp, device="cpu", **MAMBA_KW)
    E, N, K = tcfg.d_inner, tcfg.ssm_state, tcfg.ssm_conv
    assert {k: (tuple(v.shape), v.dtype) for k, v in eng.caches.items()} \
        == {"conv": ((tcfg.n_layers, 2, K - 1, E), torch.float32),
            "ssm": ((tcfg.n_layers, 2, E, N), torch.float32)}
    assert eng.mamba_impl == "xla"


# --------------------------------------------------------------------------
# period stacks: reduced jamba-1.5-large-398b
# --------------------------------------------------------------------------

JAMBA = "jamba-1.5-large-398b"
# reduced Jamba as it is (periods of 2), and at 8 layers in periods of 4
JAMBA_LAYOUTS = {"period2": {}, "period4": dict(n_layers=8, attn_period=4)}


@pytest.fixture(scope="module", params=sorted(JAMBA_LAYOUTS))
def jamba_weights(request):
    fields = JAMBA_LAYOUTS[request.param]
    cfg = dataclasses.replace(jax_reduced(JAMBA), **fields)
    jp = JM.init_params(jax.random.PRNGKey(0), cfg)
    tcfg = dataclasses.replace(get_reduced(JAMBA), **fields)
    return cfg, jp, tcfg, M.params_from_jax(
        jax.tree_util.tree_map(np.asarray, jp), tcfg, "cpu")


def test_jamba_engine_matches_the_true_length_reference(jamba_weights):
    """Right-padded prompts through the engine's slot refills: every
    position within LOGIT_TOL of the reference's true-length prefill and
    decode fed the engine's tokens, and the tokens by its margins."""
    cfg, jp, tcfg, tp = jamba_weights
    eng = ServingEngine(tcfg, tp, device="cpu", **MAMBA_KW)
    logits = record_logits(eng)
    reqs = [Request(req_id=i, prompt=p, gen_len=g) for i, p, g in
            mamba_requests([(5, 6), (12, 4), (1, 5), (8, 3)], seed=5)]
    for r in reqs:
        assert eng.submit(r)
    done = eng.run_until_drained()
    assert sorted(r.req_id for r in done) == [0, 1, 2, 3]
    compared = 0
    for r in done:
        assert r.status == "done" and len(r.out_tokens) == r.gen_len
        want = jax_true_length_logits(cfg, jp, r, r.out_tokens)
        compared += agree_under_margins(
            r.out_tokens, [int(w.argmax()) for w in want],
            logits[r.req_id], want)
    assert compared >= 1


def test_jamba_engine_caches_nest_by_sub_layer(jamba_weights):
    """The engine's caches: a ``sub{j}`` a layer of the period, each leaf
    stacked over the periods with one row a slot (the reference's
    ``cache_struct``)."""
    cfg, _, tcfg, tp = jamba_weights
    eng = ServingEngine(tcfg, tp, device="cpu", **MAMBA_KW)
    want = JM.cache_struct(cfg, MAMBA_KW["slots"],
                           MAMBA_KW["prompt_capacity"]
                           + MAMBA_KW["gen_capacity"])
    got = {j: {k: (tuple(v.shape), v.dtype) for k, v in sub.items()}
           for j, sub in eng.caches.items()}
    assert got == {j: {k: (v.shape, torch.bfloat16 if k in ("k", "v")
                           else torch.float32) for k, v in sub.items()}
                   for j, sub in want.items()}


# --------------------------------------------------------------------------
# append_rows and ChunkedTable against the reference
# --------------------------------------------------------------------------


@pytest.mark.parametrize("n_acc,n_new,cap", [(3, 4, 10), (6, 7, 10),
                                             (0, 0, 4), (4, 0, 4)])
def test_append_rows_matches_reference(n_acc, n_new, cap):
    rng = np.random.default_rng(n_acc * 10 + n_new)
    acc = {"k": rng.integers(0, 99, n_acc).astype(np.int32),
           "v": rng.normal(size=n_acc).astype(np.float32)}
    new = {"k": rng.integers(0, 99, n_new).astype(np.int32),
           "v": rng.normal(size=n_new).astype(np.float32)}
    j, jd = JL.append_rows(JT.from_dict(acc, cap), JT.from_dict(new, 8))
    t, td = L.append_rows(Table.from_dict(acc, cap, device="cpu"),
                          Table.from_dict(new, 8, device="cpu"))
    assert int(td) == int(jd) == max(n_acc + n_new - cap, 0)
    assert int(t.nvalid) == int(j.nvalid)
    for k in acc:
        np.testing.assert_array_equal(t.columns[k].numpy(),
                                      np.asarray(j.columns[k]))
    with pytest.raises(ValueError, match="schema"):
        L.append_rows(Table.from_dict(acc, cap, device="cpu"),
                      Table.from_dict({"k": new["k"]}, 8, device="cpu"))


@pytest.mark.parametrize("rows,chunk", [(10, 4), (8, 8), (0, 3)])
def test_chunked_table_matches_reference(rows, chunk):
    data = {"k": np.arange(rows, dtype=np.int32),
            "f": np.linspace(0, 1, rows).astype(np.float32)}
    j, t = JMo.ChunkedTable(data, chunk), Mo.ChunkedTable(data, chunk)
    assert (t.nrows, t.num_chunks, t.names, t.capacity_per_shard(1)) == \
        (j.nrows, j.num_chunks, j.names, j.capacity_per_shard(1))
    jctx = jax_context(jax.make_mesh((1,), ("rows",)))
    for jt, tt in zip(j.distribute(jctx), t.distribute(make_context("cpu")),
                      strict=True):
        assert int(tt.nvalid) == int(np.asarray(jt.nvalid).sum())
        for k in data:
            np.testing.assert_array_equal(tt.columns[k].numpy(),
                                          np.asarray(jt.columns[k]))
    with pytest.raises(ValueError, match="chunk_rows"):
        Mo.ChunkedTable(data, 0)
    with pytest.raises(ValueError, match="equal length"):
        Mo.ChunkedTable({"a": np.zeros(2), "b": np.zeros(3)}, 2)


# --------------------------------------------------------------------------
# the CLI
# --------------------------------------------------------------------------


def test_serve_cli_on_the_cpu():
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         "lm100m", "--reduced", "--device", "cpu", "--requests", "8"],
        env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    assert "serve OK" in proc.stdout
    assert "counter          completed = 8" in proc.stdout


def test_serve_cli_serves_granite_moe_on_the_cpu():
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         MOE, "--reduced", "--device", "cpu", "--requests", "6",
         "--prompt-len", "16", "--gen", "4"],
        env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    assert "serve OK" in proc.stdout
    assert "counter          completed = 6" in proc.stdout


def test_serve_cli_serves_falcon_mamba_on_the_cpu():
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         MAMBA, "--reduced", "--device", "cpu", "--requests", "6",
         "--prompt-len", "16", "--gen", "4"],
        env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    assert "serve OK" in proc.stdout
    assert "counter          completed = 6" in proc.stdout


def test_serve_cli_serves_jamba_on_the_cpu():
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         JAMBA, "--reduced", "--device", "cpu", "--requests", "6",
         "--prompt-len", "16", "--gen", "4"],
        env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    assert "serve OK" in proc.stdout
    assert "counter          completed = 6" in proc.stdout
