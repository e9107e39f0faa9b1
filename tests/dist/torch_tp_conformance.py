"""Subprocess worker for tests/test_torch_tp.py: the sharded serving path
at world W, run by the JAX package over a ``(data=1, model=W)`` mesh
with ``make_policy(mesh, "fsdp_tp")`` or by W PyTorch ranks under the
port's policy, on the same weights and inputs, written to one ``.npz``.

Usage:
  XLA_FLAGS=--xla_force_host_platform_device_count=W \\
      python torch_tp_conformance.py jax W OUT.npz WEIGHTS.npz
  python torch_tp_conformance.py torch W OUT.npz WEIGHTS.npz RANK STORE

``WEIGHTS.npz`` holds the reference's initial weights (``MODELS`` and
``MOE_LAYERS``, flattened with ``/``), written by the test.  Cases:

* ``moe/<arch>/<path>/<cf>``: ``moe_shuffle`` and ``moe_decode`` of one
  MoE layer at a capacity factor where no row drops, at the default and
  at one where rows drop: the output, ``aux`` and each rank's dropped rows (the
  reference's, from its own ``_route`` and ``radix_histogram_ranks`` on
  each rank's shard, as its ``~ok`` counts them);
* ``lm/<model>``: ``make_prefill`` then greedy ``make_serve_step``s:
  every step's logits and the prefill's caches (the port's: each rank's
  heads, or a Mamba stack's conv and ssm states of its channels); an
  enc-dec config's prompts come with their frames and its caches hold
  the cross-attention's ``ck``/``cv``, a vision config's with their
  patch embeddings in front, and its decode starts after them; a period
  stack's (Jamba's) caches are written under each ``sub{j}``;
* ``engine``: both engines (with their policy and a feature store over
  all ranks) on the same requests: each request's status, tokens and
  features, the port's top-2 margins, each rank's tokens;
* ``mamba_engine``, ``jamba_engine``: (torch only) the port's engine on
  reduced ``falcon-mamba-7b`` and ``jamba-1.5-large-398b`` with its
  policy and a feature store over all ranks on the same requests,
  recorded as ``engine``; the test holds it to the port's world-1 engine
  (the reference's engine runs a Mamba state through a prompt's
  padding);
* ``fs``: (torch only) the feature-store cases of
  ``tests/dist/serving_conformance.py`` at world W;
* ``mem``: (torch only) each rank's parameter bytes, whole and by leaf.

In ``torch`` mode the ranks meet through a gloo process group on a
``file://`` store with a timeout on the group, and rank 0 writes.
"""
import collections
import math
import sys

import numpy as np

MODELS = {"granite-3-2b": {}, "granite-moe-3b-a800m": {},
          # the KV heads do not split over the model axis: each rank
          # holds the one KV head its q heads read
          "granite-3-2b/kv1": {"n_kv_heads": 1},
          # a Mamba stack: each rank runs its block of the channels
          "falcon-mamba-7b": {},
          # an encoder and cross-attention, and a patch prefix: each rank
          # runs its block of every attention's heads
          "seamless-m4t-large-v2": {}, "internvl2-2b": {},
          # a period stack: Mamba sub-layers on their channels, the
          # attention sub-layer on its heads, MoE sub-layers dispatched
          "jamba-1.5-large-398b": {}}
MAMBA_ENGINE = "falcon-mamba-7b"
JAMBA_ENGINE = "jamba-1.5-large-398b"
MOE_LAYERS = ("granite-moe-3b-a800m", "qwen3-moe-235b-a22b")
# path -> capacity factors: none dropped (E / top_k for the shuffle:
# C_send = the rows of a rank), the default, rows dropped; "fallback" is
# moe_shuffle on a sequence that does not split over the model axis,
# which both packages run as moe_dense (the port on each rank's experts)
MOE_PATHS = {"shuffle": (4.0, 1.25, 0.5), "decode": (4.0, 0.5),
             "fallback": (1.25,)}
P, G = 16, 6                  # prompt length and tokens generated
ENGINE = "granite-moe-3b-a800m"
ENGINE_KW = dict(slots=2, prompt_capacity=12, gen_capacity=6,
                 queue_capacity=4)
# (prompt length, gen_len) of the engine's requests; request 3's key has
# no feature row
SHAPES = [(12, 6), (1, 1), (5, 3), (9, 2), (3, 4), (7, 1), (2, 5), (11, 3)]


def config(getter, name):
    import dataclasses
    arch, _, _ = name.partition("/")
    return dataclasses.replace(getter(arch), **MODELS.get(name, {}))


def unflatten(flat, prefix):
    tree = {}
    for key, v in flat.items():
        if not key.startswith(prefix + "/"):
            continue
        node = tree
        *path, leaf = key[len(prefix) + 1:].split("/")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = np.asarray(v)
    return tree


def bf16_exact(shape, seed):
    """float32 values that bf16 holds exactly."""
    x = np.random.default_rng(seed).normal(size=shape).astype(np.float32)
    return (x.view(np.uint32) & np.uint32(0xFFFF0000)).view(np.float32)


def moe_inputs(cfg, path):
    """(B, S, d): a prefill of 2 x 16 tokens, 8 x 8 replicated rows for
    decode (64 tokens, so that a capacity of 8 rows drops some), or 2 x
    15 tokens for the fallback."""
    shape, seed = {"shuffle": ((2, 16), 11), "decode": ((8, 8), 12),
                   "fallback": ((2, 15), 13)}[path]
    return bf16_exact(shape + (cfg.d_model,), seed)


def prompt_tokens(cfg, seed):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab, (3, P)).astype(np.int32)


def frontend_inputs(cfg, rows, seq, seed):
    """The float inputs of a config's stub frontend, drawn by numpy: an
    enc-dec config's frames (``seq // enc_len_ratio`` a row), a vision
    config's ``frontend_tokens`` patch embeddings a row; none else."""
    rng = np.random.default_rng(100 + seed)
    out = {}
    if cfg.is_encdec:
        out["frames"] = rng.normal(size=(rows, seq // cfg.enc_len_ratio,
                                         cfg.d_model)).astype(np.float32)
    if cfg.frontend == "vision":
        out["patch_embeds"] = rng.normal(size=(
            rows, cfg.frontend_tokens, cfg.d_model)).astype(np.float32)
    return out


def prefix_len(cfg):
    """The positions a vision config puts in front of the tokens."""
    return cfg.frontend_tokens if cfg.frontend == "vision" else 0


def lm_batch(cfg, seed=4):
    """(the prompts of :func:`prompt_tokens` with the config's frontend
    inputs, the position of the first decode step)."""
    toks = prompt_tokens(cfg, seed)
    return dict(tokens=toks, **frontend_inputs(cfg, len(toks), P, seed)), \
        prefix_len(cfg) + P


def request_data(vocab):
    rng = np.random.default_rng(1)
    n_keys = 32
    feats = {"drug_id": np.arange(n_keys, dtype=np.int32),
             "d0": rng.normal(size=n_keys).astype(np.float32)}
    reqs = [(i, rng.integers(0, vocab, p_len).astype(np.int32), g,
             999 if i == 3 else i) for i, (p_len, g) in enumerate(SHAPES)]
    return feats, reqs


def feature_table():
    """The feature table of ``serving_conformance.py`` and its probes."""
    rng = np.random.default_rng(7)
    n = 200
    keys = rng.permutation(n).astype(np.int32)
    table = {"k": keys,
             "f0": rng.normal(size=n).astype(np.float32),
             "f1": rng.normal(size=n).astype(np.float32),
             "f2": rng.integers(0, 100, n).astype(np.int32)}
    probe = rng.integers(-20, n + 20, 50).astype(np.int32)
    return table, probe


def serve_all(engine, reqs):
    """Submit, drain, resubmit what the small queue rejected, drain."""
    rejected = [r for r in reqs if not engine.submit(r)]
    done = engine.run_until_drained()
    for r in rejected:
        assert engine.submit(r)
    return rejected, done + engine.run_until_drained()


def engine_record(out, done, rejected, eng, prefix):
    out[f"{prefix}/rejected"] = np.array([r.req_id for r in rejected],
                                         np.int32)
    out[f"{prefix}/counts"] = np.array([eng.metrics.count(k) for k in (
        "submitted", "completed", "rejected", "feature_misses", "prefills",
        "decode_steps", "tokens_generated")], np.int64)
    for r in done:
        out[f"{prefix}/{r.req_id}/status"] = np.array(r.status)
        out[f"{prefix}/{r.req_id}/tokens"] = np.array(r.out_tokens,
                                                      np.int32)
        out[f"{prefix}/{r.req_id}/d0"] = np.array(
            (r.features or {}).get("d0", np.nan), np.float32)


# --------------------------------------------------------------------------
# the JAX reference
# --------------------------------------------------------------------------


def run_jax(world, out_path, weights_path):
    import jax
    import jax.numpy as jnp
    from jax.sharding import AxisType, Mesh
    from repro import serving as JS
    from repro.configs import get_reduced
    from repro.core.context import make_context
    from repro.kernels.hash_partition import radix_histogram_ranks
    from repro.models import model as JM
    from repro.models import moe as JMoe
    from repro.models.sharding import make_policy

    assert len(jax.devices()) == world
    # Auto axes: the reference's GSPMD constraints need them
    mesh = jax.make_mesh((1, world), ("data", "model"),
                         axis_types=(AxisType.Auto, AxisType.Auto))
    policy = make_policy(mesh, "fsdp_tp")
    flat = dict(np.load(weights_path))
    out = {}

    for arch in MOE_LAYERS:
        cfg = get_reduced(arch)
        p = jax.tree_util.tree_map(jnp.asarray,
                                   unflatten(flat, f"moe/{arch}"))
        E, k = cfg.n_experts, cfg.top_k
        E_loc = JMoe.n_experts_padded(cfg) // world
        for path, cfs in MOE_PATHS.items():
            x = moe_inputs(cfg, path)
            jx = jnp.asarray(x, jnp.bfloat16)
            for cf in cfs:
                fn = JMoe.moe_decode if path == "decode" \
                    else JMoe.moe_shuffle
                y, aux = jax.jit(lambda p, x, fn=fn, cf=cf: fn(
                    p, cfg, x, policy, cf))(p, jx)
                key = f"moe/{arch}/{path}/{cf}"
                out[f"{key}/y"] = np.asarray(y.astype(jnp.float32))
                out[f"{key}/aux"] = np.asarray(aux, np.float32)
                # each rank's dropped rows as the reference's ~ok counts,
                # and the routed ids in token layout (B, S, k)
                drops, ids_all = [], []
                if path == "fallback":
                    _, ids, _ = JMoe._route(
                        p["router"], jx.reshape(-1, x.shape[2]), k)
                    drops = [0] * world
                    ids_all = [np.asarray(ids).reshape(x.shape[:2] + (k,))]
                for r in range(world if path != "fallback" else 0):
                    if path == "shuffle":
                        s = x.shape[1] // world
                        xs = jx[:, r * s:(r + 1) * s].reshape(-1, x.shape[2])
                        T = xs.shape[0]
                        C = max(1, math.ceil(T * k / E * cf))
                        _, ids, _ = JMoe._route(p["router"], xs, k)
                        _, ranks = radix_histogram_ranks(ids.reshape(-1), E)
                        drops.append(int(jnp.sum(ranks >= C)))
                        ids_all.append(np.asarray(ids).reshape(
                            x.shape[0], s, k))
                    else:
                        xs = jx.reshape(-1, x.shape[2])
                        T = xs.shape[0]
                        C = max(8, math.ceil(T * k / E * cf))
                        _, ids, _ = JMoe._route(p["router"], xs, k)
                        le = ids.reshape(-1) - r * E_loc
                        mine = (le >= 0) & (le < E_loc)
                        _, ranks = radix_histogram_ranks(
                            jnp.where(mine, le, E_loc), E_loc + 1)
                        drops.append(int(jnp.sum(mine & (ranks >= C))))
                        ids_all = [np.asarray(ids).reshape(
                            x.shape[0], x.shape[1], k)]
                out[f"{key}/dropped"] = np.array(drops, np.int64)
                out[f"{key}/ids"] = np.concatenate(ids_all, axis=1)

    for name in MODELS:
        cfg = config(get_reduced, name)
        params = jax.tree_util.tree_map(jnp.asarray,
                                        unflatten(flat, f"lm/{name}"))
        batch, pos0 = lm_batch(cfg)
        prefill = jax.jit(JM.make_prefill(cfg, policy,
                                          decode_len=pos0 + G))
        step = jax.jit(JM.make_serve_step(cfg, policy))
        logits, caches = prefill(params, {k: jnp.asarray(v)
                                          for k, v in batch.items()})
        for c, v in _leaves(caches):
            out[f"lm/{name}/{c}"] = np.asarray(v.astype(jnp.float32))
        for i in range(G):
            lg = np.asarray(logits)
            out[f"lm/{name}/logits/{i}"] = lg
            if i < G - 1:
                logits, caches = step(params, caches, jnp.asarray(
                    lg.argmax(-1)[:, None].astype(np.int32)),
                    jnp.int32(pos0 + i))

    cfg = get_reduced(ENGINE)
    params = jax.tree_util.tree_map(jnp.asarray,
                                    unflatten(flat, f"lm/{ENGINE}"))
    feats, spec = request_data(cfg.vocab)
    ctx = make_context(Mesh(np.array(jax.devices()), ("rows",)))
    store = JS.FeatureStore(ctx, "drug_id", feats, probe_capacity=8,
                            chunk_rows=8)
    eng = JS.ServingEngine(cfg, params, policy=policy,
                           feature_stores={"drug_id": store}, **ENGINE_KW)
    reqs = [JS.Request(req_id=i, prompt=p, gen_len=g, drug_id=d)
            for i, p, g, d in spec]
    rejected, done = serve_all(eng, reqs)
    engine_record(out, done, rejected, eng, "engine/jax")
    np.savez(out_path, **out)


# --------------------------------------------------------------------------
# the port, one rank per process
# --------------------------------------------------------------------------


def record_margins(engine):
    """Each request's top-2 logit margin at every token it emits, in the
    order of ``out_tokens`` (as tests/test_torch_serving.py)."""
    import torch
    margins = collections.defaultdict(list)
    upcoming = collections.deque()
    fetch, prefill, serve = (engine._fetch_features, engine._slot_prefill,
                             engine._serve_step)

    def margin(logits):
        top = torch.topk(logits.float(), 2, dim=-1).values
        return (top[..., 0] - top[..., 1]).numpy()

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


def world1_engine(flat, arch, kw):
    """The port's engine at world 1 (in the calling process, no process
    group) on reduced ``arch`` with the weights of ``flat`` and a feature
    store, on the requests of :func:`request_data`: its record as
    :func:`engine_record` writes it under ``w1``, with the margins."""
    from repro_torch.configs import get_reduced
    from repro_torch.core.context import make_context
    from repro_torch.models import model as M
    from repro_torch.serving import FeatureStore, Request, ServingEngine

    cfg = get_reduced(arch)
    params = M.params_from_jax(unflatten(flat, f"lm/{arch}"), cfg, "cpu")
    feats, spec = request_data(cfg.vocab)
    store = FeatureStore(make_context("cpu"), "drug_id", feats,
                         probe_capacity=8, chunk_rows=8)
    eng = ServingEngine(cfg, params, feature_stores={"drug_id": store},
                        device="cpu", **kw)
    margins = record_margins(eng)
    reqs = [Request(req_id=i, prompt=p, gen_len=g, drug_id=d)
            for i, p, g, d in spec]
    rejected, done = serve_all(eng, reqs)
    out = {}
    engine_record(out, done, rejected, eng, "w1")
    for rid, m in margins.items():
        out[f"w1/{rid}/margins"] = np.array(m, np.float32)
    return out


def compare_engine_to_world1(res, t, want, cfg, model, slots, tol):
    """One rank's engine record ``res`` (under ``t``) of a Mamba stack
    against the port's world-1 engine's ``want`` (:func:`world1_engine`):
    the same rejections, counts, statuses and features, greedy tokens
    equal up to the first that differs where world 1's margin is below
    ``tol`` (the rule of ``tests/test_torch_model.py``), at least one
    token compared; the rank's Mamba caches hold ``slots`` rows and E /
    ``model`` channels (a period stack's in each Mamba sub-layer, over
    its periods)."""
    np.testing.assert_array_equal(res[f"{t}/rejected"], want["w1/rejected"])
    np.testing.assert_array_equal(res[f"{t}/counts"], want["w1/counts"])
    assert int(res[f"{t}/store_dropped"]) == 0
    E = cfg.d_inner // model
    L = cfg.n_layers // (cfg.attn_period if cfg.attn_period > 1 else 1)
    shapes = {k[len(f"{t}/cache_shapes/"):]: v for k, v in res.items()
              if k.startswith(f"{t}/cache_shapes/")}
    assert any(k.endswith("ssm") for k in shapes), shapes
    for k, per_rank in shapes.items():
        want_shape = {"conv": (L, slots, cfg.ssm_conv - 1, E),
                      "ssm": (L, slots, E, cfg.ssm_state)}.get(
            k.rsplit("/", 1)[-1])
        for got_shape in per_rank:
            assert want_shape is None or tuple(got_shape) == want_shape, k
    compared = 0
    for rid in range(len(SHAPES)):
        assert str(res[f"{t}/{rid}/status"]) == str(want[f"w1/{rid}/status"])
        np.testing.assert_array_equal(res[f"{t}/{rid}/d0"],
                                      want[f"w1/{rid}/d0"])
        toks, wtoks = res[f"{t}/{rid}/tokens"], want[f"w1/{rid}/tokens"]
        assert len(toks) == len(wtoks)
        if rid == 3:
            assert str(res[f"{t}/{rid}/status"]) == "feature_miss"
            continue
        for g, w, m in zip(toks, wtoks, want[f"w1/{rid}/margins"]):
            if m > tol:
                assert g == w, (rid, toks, wtoks)
                compared += 1
            elif g != w:
                break
    assert compared >= 1


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


def run_torch(world, out_path, weights_path, rank, store_path):
    import torch
    import torch.distributed as dist
    from repro_torch.configs import get_reduced
    from repro_torch.core.context import all_gather, make_context
    from repro_torch.core.morsel import ChunkedTable
    from repro_torch.launch import mesh as Me
    from repro_torch.models import model as M
    from repro_torch.models import moe as Moe
    from repro_torch.models import sharding as Sh
    from repro_torch.serving import FeatureStore, Request, ServingEngine

    torch.set_num_threads(2)
    Me.init_rank(rank, world, store_path, "cpu", timeout_s=120)
    mesh = Me.make_debug_mesh(data=1, model=world)
    policy = Sh.make_policy(mesh, "fsdp_tp")
    group = policy.model_group
    flat = dict(np.load(weights_path))
    out = {}

    def gathered(t):
        return torch.stack(all_gather(torch.as_tensor(t), group)).numpy()

    for arch in MOE_LAYERS:
        cfg = get_reduced(arch)
        p = M.params_from_jax(unflatten(flat, f"moe/{arch}"), cfg, "cpu",
                              policy=policy)
        for path, cfs in MOE_PATHS.items():
            x = torch.from_numpy(moe_inputs(cfg, path)).bfloat16()
            for cf in cfs:
                fn = Moe.moe_decode if path == "decode" \
                    else Moe.moe_shuffle
                Moe.drop_log = []
                try:
                    y, aux = fn(p, cfg, x, policy, cf)
                finally:
                    log, Moe.drop_log = Moe.drop_log, None
                # a dispatch logs its drops once; the fallback drops none
                assert len(log) == (path != "fallback"), log
                if not log:
                    log = [torch.zeros((), dtype=torch.int64)]
                key = f"moe/{arch}/{path}/{cf}"
                out[f"{key}/y"] = y.float().numpy()
                out[f"{key}/aux"] = aux.numpy()
                out[f"{key}/dropped"] = gathered(log[0]).astype(np.int64)
                out[f"{key}/y_ranks"] = gathered(y.float())
                # the routed ids as moe_shuffle / moe_decode compute them
                # (the same function on the same rows), in token layout
                B, S, d = x.shape
                s = S // world if path == "shuffle" else S
                ids = [Moe._route(p["router"],
                                  x[:, r * s:(r + 1) * s].reshape(-1, d),
                                  cfg.top_k)[1].reshape(B, s, cfg.top_k)
                       for r in range(S // s)]
                out[f"{key}/ids"] = torch.cat(ids, dim=1).numpy()

    for name in MODELS:
        cfg = config(get_reduced, name)
        params = M.params_from_jax(unflatten(flat, f"lm/{name}"), cfg,
                                   "cpu", policy=policy)
        if name == ENGINE:
            out["mem/rank_bytes"] = gathered(torch.tensor(sum(
                t.numel() * t.element_size()
                for _, t in _leaves(params)))).astype(np.int64)
            for leaf, t in _leaves(params):
                out[f"mem/leaf/{leaf}"] = gathered(torch.tensor(
                    t.numel() * t.element_size())).astype(np.int64)
        batch, pos0 = lm_batch(cfg)
        prefill = M.make_prefill(cfg, policy, decode_len=pos0 + G)
        step = M.make_serve_step(cfg, policy)
        logits, caches = prefill(params, {k: torch.from_numpy(v)
                                          for k, v in batch.items()})
        for c, v in _leaves(caches):  # each rank's heads or channels
            out[f"lm/{name}/{c}_ranks"] = gathered(v.float())
        for i in range(G):
            out[f"lm/{name}/logits/{i}"] = logits.numpy()
            out[f"lm/{name}/logits_ranks/{i}"] = gathered(logits)
            if i < G - 1:
                logits, caches = step(params, caches, logits.argmax(-1)[
                    :, None].to(torch.int32), pos0 + i)

    ctx = make_context("cpu")
    for arch, prefix in ((ENGINE, "engine/torch"),
                         (MAMBA_ENGINE, "mamba_engine/torch"),
                         (JAMBA_ENGINE, "jamba_engine/torch")):
        cfg = get_reduced(arch)
        params = M.params_from_jax(unflatten(flat, f"lm/{arch}"), cfg,
                                   "cpu", policy=policy)
        feats, spec = request_data(cfg.vocab)
        store = FeatureStore(ctx, "drug_id", feats, probe_capacity=8,
                             chunk_rows=8)
        eng = ServingEngine(cfg, params, policy=policy,
                            feature_stores={"drug_id": store}, device="cpu",
                            **ENGINE_KW)
        margins = record_margins(eng)
        reqs = [Request(req_id=i, prompt=p, gen_len=g, drug_id=d)
                for i, p, g, d in spec]
        rejected, done = serve_all(eng, reqs)
        engine_record(out, done, rejected, eng, prefix)
        for rid, m in margins.items():
            out[f"{prefix}/{rid}/margins"] = np.array(m, np.float32)
        tokens = np.concatenate([np.array(r.out_tokens, np.int32) for r in
                                 sorted(done, key=lambda r: r.req_id)])
        out[f"{prefix}/tokens_ranks"] = gathered(torch.from_numpy(tokens))
        out[f"{prefix}/store_dropped"] = np.array(store.dropped)
        for c, v in _leaves(eng.caches):
            out[f"{prefix}/cache_shapes/{c}"] = gathered(
                torch.tensor(list(v.shape)))

    # the feature-store cases of serving_conformance.py at this world
    table, probe = feature_table()
    fs = FeatureStore(ctx, "k", ChunkedTable(table, chunk_rows=32),
                      probe_capacity=64)
    out["fs/ingest_dropped"] = np.array(fs.dropped)
    feats, found = fs.lookup(probe)
    out["fs/mixed/found"] = found
    for c in ("f0", "f1", "f2"):
        out[f"fs/mixed/{c}"] = feats[c]
    hot = np.full(fs.probe_capacity, int(table["k"][0]), np.int32)
    feats, found = fs.lookup(hot)
    out["fs/hot/found"], out["fs/hot/f0"] = found, feats["f0"]
    feats, found = fs.lookup(np.array([5, 5, 7, 5], np.int32))
    out["fs/dup/found"], out["fs/dup/f2"] = found, feats["f2"]
    out["fs/contains"] = fs.contains(probe)
    out["fs/dropped"] = np.array(fs.dropped)

    dist.barrier()
    if rank == 0:
        np.savez(out_path, **out)
    dist.destroy_process_group()


if __name__ == "__main__":
    mode, world, out_path, weights_path = sys.argv[1:5]
    if mode == "jax":
        run_jax(int(world), out_path, weights_path)
    else:
        run_torch(int(world), out_path, weights_path, int(sys.argv[5]),
                  sys.argv[6])
