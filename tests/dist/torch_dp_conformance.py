"""Subprocess worker for tests/test_torch_serve_dp.py: serving at a data
axis of two ranks, run by the JAX package over forced host devices or by
the port's gloo ranks, on the same weights and inputs.

Usage:
  XLA_FLAGS=--xla_force_host_platform_device_count=4 \\
      python torch_dp_conformance.py jax OUT.npz WEIGHTS.npz COMBO[,COMBO]
  python torch_dp_conformance.py torch MESH OUT WEIGHTS.npz RANK STORE

The reference runs the named ``COMBOS`` (two processes can share them
out); ``MESH`` is ``2x1`` (two ranks) or ``2x2`` (four), and each torch
rank writes ``OUT.rank<r>.npz``.  ``WEIGHTS.npz`` holds the reference's initial
weights (``MODELS`` and the MoE layer, flattened with ``/``), written by
the test.  Cases, for each of ``COMBOS`` (data, model, flavor) that the
mesh runs:

* ``lm/<combo>/<model>``: ``SLOTS`` prompts slot-prefilled one at a time
  (``make_slot_prefill``, ``write_cache_slot`` into slot i), then
  ``G - 1`` greedy ``make_serve_step``s over all slots: each prefill's
  logits, each step's, and the caches after the prefills (the port's:
  each rank's block of the slots and its KV heads);
* ``oneshot/<combo>/<model>``: reduced ``seamless-m4t-large-v2`` (its
  frames) and ``internvl2-2b`` (its patch embeddings in front) through
  ``make_prefill`` on ``SLOTS`` prompts of ``PCAP`` tokens (two a data
  rank), then ``G - 1`` greedy ``make_serve_step``s (the engine does not
  serve these families): each step's logits and the prefill's caches
  (the port's: each rank's rows and KV heads, ``ck``/``cv`` too);
* ``mamba/<combo>``: reduced ``falcon-mamba-7b`` through ``make_prefill``
  on ``SLOTS`` prompts of ``PCAP`` tokens (two a data rank), then
  ``G - 1`` greedy ``make_serve_step``s: each step's logits and the
  prefill's conv and ssm states (the port's: each rank's rows and
  channels);
* ``jamba/<combo>``: at ``JAMBA_COMBOS``, reduced
  ``jamba-1.5-large-398b`` (period stacks; its MoE sub-layers at
  ``JAMBA_CF``, where no row drops) as ``mamba/<combo>``: each
  sub-layer's caches (the port's: each rank's rows, channels and KV
  heads) under ``sub{j}``;
* ``engine/<combo>``: the MoE engine (``ENGINE_KW``, 4 slots: 2 a data
  rank) with a feature store over all ranks on the requests of
  ``tests/dist/torch_tp_conformance.py``: each request's status, tokens
  and features, the port's top-2 margins;

and the ``lm`` cases under ``fsdp_tp`` at each of ``POD_COMBOS`` (the
``2x2`` ranks; each rank also writes its batch and model coordinates,
``lm/<combo>/coord``); and at ``2x2`` under ``fsdp_tp`` only:

* ``engine3``: the same engine with 3 slots, which do not split over the
  data ranks (every rank holds them all);
* ``mamba_engine``, ``jamba_engine``: (torch only) the port's engine on
  reduced ``falcon-mamba-7b`` and ``jamba-1.5-large-398b``
  (``ENGINE_KW``), which the test holds to the port's world-1 engine;
* ``moe``: ``moe_decode`` of one MoE layer on 8 x 8 rows (4 x 8 a data
  rank) at capacity factor 0.5, where rows drop: the output, each rank's
  routed ids and dropped rows (the reference's per shard, from its own
  ``_route`` and ``radix_histogram_ranks`` as its ``~ok`` counts them);
* ``mem``: (torch only) each rank's parameter bytes, whole and by leaf;
* ``adamw/<flavor>``: (torch only, ``2x2`` under ``tp`` and
  ``fsdp_tp``) three AdamW steps with ``sharding.Zero1`` on seeded
  leaves, in place (``donate=True``) against :func:`update_before`:
  whether every leaf's bits agree and every tensor kept its storage.
"""
import math
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_tp_conformance as TPW  # noqa: E402

MODELS = ("granite-3-2b", "granite-moe-3b-a800m")
MAMBA = "falcon-mamba-7b"
JAMBA = "jamba-1.5-large-398b"
JAMBA_COMBOS = ("2x2",)
# the Jamba cases' MoE capacity factor: E / top_k, where no row drops
JAMBA_CF = 4.0
# served through make_prefill + make_serve_step only
ONESHOT = ("seamless-m4t-large-v2", "internvl2-2b")
ENGINE = "granite-moe-3b-a800m"
MOE_ARCH = "granite-moe-3b-a800m"
COMBOS = {"2x1": (2, 1, "fsdp_tp"), "2x2": (2, 2, "fsdp_tp"),
          "2x2tp": (2, 2, "tp")}
MESHES = {"2x1": ("2x1",), "2x2": ("2x2", "2x2tp")}
# two batch axes, run by the 2x2 ranks on a mesh of their own: the slots
# over pod x data (pod major), the weights cut over data and whole over
# pod; lm cases only
POD_COMBOS = {"pod2x2x1": {"pod": 2, "data": 2, "model": 1},
              "pod2x1x2": {"pod": 2, "data": 1, "model": 2}}
SLOTS, PCAP, G = 4, 12, 5          # slots, prompt capacity, tokens each
LENS = (5, 12, 1, 9)               # the slots' prompt lengths
ENGINE_KW = dict(slots=4, prompt_capacity=12, gen_capacity=6,
                 queue_capacity=4)
MOE_CF = 0.5
SHAPES = TPW.SHAPES


def served_config(getter, arch):
    """The reduced config of ``arch`` as the cases serve it: Jamba's at
    ``JAMBA_CF``."""
    import dataclasses
    cfg = getter(arch)
    if arch != JAMBA:
        return cfg
    return dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, moe_capacity_factor=JAMBA_CF))


def prompts(cfg, seed):
    rng = np.random.default_rng(seed)
    out = np.zeros((SLOTS, PCAP), np.int32)
    for i, n in enumerate(LENS):
        out[i, :n] = rng.integers(0, cfg.vocab, n)
    return out


def mamba_prompts(cfg, seed=6):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab, (SLOTS, PCAP)).astype(np.int32)


def oneshot_batch(cfg, seed=7):
    """(``SLOTS`` prompts of ``PCAP`` tokens with the config's frontend
    inputs, the position of the first decode step)."""
    toks = np.random.default_rng(seed).integers(
        0, cfg.vocab, (SLOTS, PCAP)).astype(np.int32)
    return dict(tokens=toks, **TPW.frontend_inputs(cfg, SLOTS, PCAP, seed)), \
        TPW.prefix_len(cfg) + PCAP


def update_before(params, grads, state, cfg, zero=None):
    """``optim.adamw.update`` as it was written before it could write in
    place: new tensors for the parameters and the moments.  The in-place
    update must give its bits."""
    import torch
    from repro_torch.models import sharding as Sh
    from repro_torch.optim import adamw as A
    F32 = torch.float32
    with torch.no_grad():
        step = state["step"] + 1
        lr = A.schedule(cfg, step)
        gnorm = A.global_norm(grads, zero)
        scale_clip = torch.clamp(cfg.clip_norm / (gnorm + 1e-9), max=1.0)
        b1, b2 = cfg.b1, cfg.b2
        stepf = step.to(F32)
        bc1 = 1 - torch.pow(b1, stepf)
        bc2 = 1 - torch.pow(b2, stepf)
        new_p, new_m, new_v = {}, {}, {}
        for k, held in params.items():
            p = held if zero is None else zero.local(k, held)
            g = grads[k].to(F32) * scale_clip
            m = b1 * state["m"][k].to(F32) + (1 - b1) * g
            v = b2 * state["v"][k].to(F32) + (1 - b2) * g * g
            delta = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps)
            if A._decay_mask(k):
                delta = delta + cfg.weight_decay * p.to(F32)
            new_p[k] = (p.to(F32) - lr * delta).to(p.dtype)
            dim = None if zero is None else zero.ddim[k]
            if not (zero is None or zero.policy.fsdp or dim is None
                    or zero.D == 1):
                new_p[k] = Sh._gather_blocks(new_p[k], zero.group, dim,
                                             held.shape[dim])
            new_m[k] = m.to(state["m"][k].dtype)
            new_v[k] = v.to(state["v"][k].dtype)
    return new_p, {"m": new_m, "v": new_v, "step": step}, \
        {"grad_norm": gnorm, "lr": lr}


def adamw_case(tree, policy=None, steps=3, seed=5):
    """(every leaf's bits equal to :func:`update_before`'s, every tensor
    kept its storage) over ``steps`` in-place AdamW steps of ``tree``
    (float32 leaves) as this rank holds it under ``policy`` (with
    ``sharding.Zero1``; ``None``: world 1), from seeded gradients in the
    2D layout; each step's inputs are the same for both updates."""
    import torch
    from repro_torch.models import sharding as Sh
    from repro_torch.optim import adamw as A
    cfg = A.AdamWConfig(lr=1e-2, warmup_steps=1, total_steps=steps)
    held = {k: torch.as_tensor(np.asarray(v), dtype=torch.float32)
            for k, v in A.flatten_params(Sh.shard_params(
                tree, policy) if policy else tree).items()}
    zero = Sh.Zero1(policy, held) if policy else None
    local = zero.local if zero else (lambda k, p: p)
    state = A.init({k: local(k, p) for k, p in held.items()}, cfg)
    gen = torch.Generator().manual_seed(
        seed + (policy.batch_rank if policy else 0))

    def storage():
        return [t.data_ptr() for t in [*held.values(), *state["m"].values(),
                                       *state["v"].values(), state["step"]]]

    ptrs, same = storage(), True
    for _ in range(steps):
        grads = {k: torch.randn(local(k, p).shape, generator=gen)
                 for k, p in held.items()}
        want_p, want_s, want_m = update_before(held, grads, state, cfg,
                                               zero)
        held, state, met = A.update(held, grads, state, cfg, zero,
                                    donate=True)
        same &= all(torch.equal(held[k], want_p[k]) for k in held)
        same &= all(torch.equal(state[w][k], want_s[w][k])
                    for w in ("m", "v") for k in held)
        same &= torch.equal(state["step"], want_s["step"])
        same &= torch.equal(met["grad_norm"], want_m["grad_norm"])
    return bool(same), storage() == ptrs


def moe_x(cfg):
    return TPW.bf16_exact((8, 8, cfg.d_model), 12)


def row_block(B, parts, index):
    per = B // parts
    return slice(index * per, (index + 1) * per)


# --------------------------------------------------------------------------
# the JAX reference
# --------------------------------------------------------------------------


def run_jax(out_path, weights_path, combos):
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

    flat = dict(np.load(weights_path))
    out = {}

    def lm_cases(combo, policy):
        for name in MODELS:
            cfg = get_reduced(name)
            params = jax.tree_util.tree_map(
                jnp.asarray, TPW.unflatten(flat, f"lm/{name}"))
            prefill = jax.jit(JM.make_slot_prefill(cfg, policy,
                                                   decode_len=PCAP + G))
            insert = jax.jit(JM.write_cache_slot, donate_argnums=(0,))
            step = jax.jit(JM.make_serve_step(cfg, policy))
            caches = jax.tree_util.tree_map(
                lambda s: jnp.zeros(s.shape, s.dtype),
                JM.cache_struct(cfg, SLOTS, PCAP + G))
            toks = prompts(cfg, 4)
            first = []
            key = f"lm/{combo}/{name}"
            for i, n in enumerate(LENS):
                logits, one = prefill(params, {"tokens": jnp.asarray(
                    toks[i:i + 1])}, jnp.int32(n))
                caches = insert(caches, one, jnp.int32(i))
                lg = np.asarray(logits)[0]
                out[f"{key}/prefill/{i}"] = lg
                first.append(int(lg.argmax()))
            for c in ("k", "v"):
                out[f"{key}/{c}"] = np.asarray(caches[c].astype(jnp.float32))
            tok = np.array(first, np.int32)
            for j in range(G - 1):
                logits, caches = step(params, caches,
                                      jnp.asarray(tok[:, None]),
                                      jnp.asarray(np.array(LENS) + j,
                                                  jnp.int32))
                lg = np.asarray(logits)
                out[f"{key}/logits/{j}"] = lg
                tok = lg.argmax(-1).astype(np.int32)

    for combo in combos:
        if combo in POD_COMBOS:
            sizes = POD_COMBOS[combo]
            mesh = jax.make_mesh(tuple(sizes.values()), tuple(sizes),
                                 axis_types=(AxisType.Auto,) * 3)
            lm_cases(combo, make_policy(mesh, "fsdp_tp"))
            continue
        D, Mw, flavor = COMBOS[combo]
        devs = jax.devices()[:D * Mw]
        # Auto axes: the reference's GSPMD constraints need them
        mesh = jax.make_mesh((D, Mw), ("data", "model"), devices=devs,
                             axis_types=(AxisType.Auto, AxisType.Auto))
        policy = make_policy(mesh, flavor)
        lm_cases(combo, policy)

        for name in ONESHOT:
            cfg = get_reduced(name)
            params = jax.tree_util.tree_map(
                jnp.asarray, TPW.unflatten(flat, f"lm/{name}"))
            batch, pos0 = oneshot_batch(cfg)
            prefill = jax.jit(JM.make_prefill(cfg, policy,
                                              decode_len=pos0 + G))
            step = jax.jit(JM.make_serve_step(cfg, policy))
            logits, caches = prefill(params, {k: jnp.asarray(v)
                                              for k, v in batch.items()})
            key = f"oneshot/{combo}/{name}"
            for c, v in caches.items():
                out[f"{key}/{c}"] = np.asarray(v.astype(jnp.float32))
            for j in range(G):
                lg = np.asarray(logits)
                out[f"{key}/logits/{j}"] = lg
                if j < G - 1:
                    logits, caches = step(params, caches, jnp.asarray(
                        lg.argmax(-1)[:, None].astype(np.int32)),
                        jnp.int32(pos0 + j))

        for arch, key in ((MAMBA, f"mamba/{combo}"),
                          (JAMBA, f"jamba/{combo}")):
            if arch == JAMBA and combo not in JAMBA_COMBOS:
                continue
            cfg = served_config(get_reduced, arch)
            params = jax.tree_util.tree_map(
                jnp.asarray, TPW.unflatten(flat, f"lm/{arch}"))
            prefill = jax.jit(JM.make_prefill(cfg, policy,
                                              decode_len=PCAP + G))
            step = jax.jit(JM.make_serve_step(cfg, policy))
            logits, caches = prefill(params, {"tokens": jnp.asarray(
                mamba_prompts(cfg))})
            for c, v in TPW._leaves(caches):
                out[f"{key}/{c}"] = np.asarray(v.astype(jnp.float32))
            for j in range(G):
                lg = np.asarray(logits)
                out[f"{key}/logits/{j}"] = lg
                if j < G - 1:
                    logits, caches = step(params, caches, jnp.asarray(
                        lg.argmax(-1)[:, None].astype(np.int32)),
                        jnp.int32(PCAP + j))

        cfg = get_reduced(ENGINE)
        params = jax.tree_util.tree_map(
            jnp.asarray, TPW.unflatten(flat, f"lm/{ENGINE}"))
        ctx = make_context(Mesh(np.array(devs), ("rows",)))
        runs = [("engine/" + combo, ENGINE_KW)]
        if combo == "2x2":
            runs.append(("engine3", dict(ENGINE_KW, slots=3)))
        for prefix, kw in runs:
            feats, spec = TPW.request_data(cfg.vocab)
            store = JS.FeatureStore(ctx, "drug_id", feats, probe_capacity=8,
                                    chunk_rows=8)
            eng = JS.ServingEngine(cfg, params, policy=policy,
                                   feature_stores={"drug_id": store}, **kw)
            reqs = [JS.Request(req_id=i, prompt=p, gen_len=g, drug_id=d)
                    for i, p, g, d in spec]
            rejected, done = TPW.serve_all(eng, reqs)
            TPW.engine_record(out, done, rejected, eng, prefix)

        if combo != "2x2":
            continue
        cfg = get_reduced(MOE_ARCH)
        p = jax.tree_util.tree_map(jnp.asarray,
                                   TPW.unflatten(flat, f"moe/{MOE_ARCH}"))
        x = moe_x(cfg)
        jx = jnp.asarray(x, jnp.bfloat16)
        y, _ = jax.jit(lambda p, x: JMoe.moe_decode(p, cfg, x, policy,
                                                    MOE_CF))(p, jx)
        out["moe/y"] = np.asarray(y.astype(jnp.float32))
        E, k = cfg.n_experts, cfg.top_k
        E_loc = JMoe.n_experts_padded(cfg) // Mw
        drops, ids_all = np.zeros((D, Mw), np.int64), []
        for d in range(D):
            xs = jx[row_block(x.shape[0], D, d)].reshape(-1, x.shape[2])
            T = xs.shape[0]
            C = max(8, math.ceil(T * k / E * MOE_CF))
            _, ids, _ = JMoe._route(p["router"], xs, k)
            ids_all.append(np.asarray(ids))
            for r in range(Mw):
                le = ids.reshape(-1) - r * E_loc
                mine = (le >= 0) & (le < E_loc)
                _, ranks = radix_histogram_ranks(
                    jnp.where(mine, le, E_loc), E_loc + 1)
                drops[d, r] = int(jnp.sum(mine & (ranks >= C)))
        out["moe/dropped"] = drops
        out["moe/ids"] = np.stack(ids_all)
    np.savez(out_path, **out)


# --------------------------------------------------------------------------
# the port, one rank per process
# --------------------------------------------------------------------------


def run_torch(mesh_name, out_path, weights_path, rank, store_path):
    import torch
    import torch.distributed as dist
    from repro_torch.configs import get_reduced
    from repro_torch.core.context import make_context
    from repro_torch.launch import mesh as Me
    from repro_torch.models import model as M
    from repro_torch.models import moe as Moe
    from repro_torch.models import sharding as Sh
    from repro_torch.serving import FeatureStore, Request, ServingEngine

    torch.set_num_threads(1)
    D, Mw, _ = COMBOS[mesh_name]
    Me.init_rank(rank, D * Mw, store_path, "cpu", timeout_s=120)
    mesh = Me.make_mesh({"data": D, "model": Mw})
    flat = dict(np.load(weights_path))
    out = {"coord": np.array([mesh.coord["data"], mesh.coord["model"]])}

    def lm_cases(combo, policy):
        rows = Sh.batch_block(policy, SLOTS)
        for name in MODELS:
            cfg = get_reduced(name)
            params = M.params_from_jax(TPW.unflatten(flat, f"lm/{name}"),
                                       cfg, "cpu", policy=policy)
            prefill = M.make_slot_prefill(cfg, policy, decode_len=PCAP + G)
            step = M.make_serve_step(cfg, policy)
            caches = M.init_caches(cfg, SLOTS, PCAP + G, "cpu",
                                   policy=policy)
            toks = prompts(cfg, 4)
            first = []
            key = f"lm/{combo}/{name}"
            for i, n in enumerate(LENS):
                logits, one = prefill(params, {"tokens": torch.from_numpy(
                    toks[i:i + 1])}, n)
                M.write_cache_slot(caches, one, i, rows)
                out[f"{key}/prefill/{i}"] = logits[0].numpy()
                first.append(int(logits[0].argmax()))
            for c in ("k", "v"):
                out[f"{key}/{c}"] = caches[c].float().numpy()
            tok = torch.tensor(first, dtype=torch.int32)
            for j in range(G - 1):
                logits, caches = step(params, caches, tok[:, None],
                                      np.array(LENS, np.int32) + j)
                out[f"{key}/logits/{j}"] = logits.numpy()
                tok = logits.argmax(-1).to(torch.int32)

    for combo in MESHES[mesh_name]:
        policy = Sh.make_policy(mesh, COMBOS[combo][2])
        lm_cases(combo, policy)

        for name in ONESHOT:
            cfg = get_reduced(name)
            params = M.params_from_jax(TPW.unflatten(flat, f"lm/{name}"),
                                       cfg, "cpu", policy=policy)
            batch, pos0 = oneshot_batch(cfg)
            prefill = M.make_prefill(cfg, policy, decode_len=pos0 + G)
            step = M.make_serve_step(cfg, policy)
            logits, caches = prefill(params, {k: torch.from_numpy(v)
                                              for k, v in batch.items()})
            key = f"oneshot/{combo}/{name}"
            for c, v in caches.items():   # bf16: float() copies
                out[f"{key}/{c}"] = v.float().numpy()
            for j in range(G):
                out[f"{key}/logits/{j}"] = logits.numpy()
                if j < G - 1:
                    logits, caches = step(params, caches, logits.argmax(-1)[
                        :, None].to(torch.int32), pos0 + j)

        for arch, key in ((MAMBA, f"mamba/{combo}"),
                          (JAMBA, f"jamba/{combo}")):
            if arch == JAMBA and combo not in JAMBA_COMBOS:
                continue
            cfg = served_config(get_reduced, arch)
            params = M.params_from_jax(TPW.unflatten(flat, f"lm/{arch}"),
                                       cfg, "cpu", policy=policy)
            prefill = M.make_prefill(cfg, policy, decode_len=PCAP + G)
            step = M.make_serve_step(cfg, policy)
            logits, caches = prefill(params, {"tokens": torch.from_numpy(
                mamba_prompts(cfg))})
            for c, v in TPW._leaves(caches):  # a copy: decode writes
                out[f"{key}/{c}"] = v.float().numpy().copy()   # in place
            for j in range(G):
                out[f"{key}/logits/{j}"] = logits.numpy()
                if j < G - 1:
                    logits, caches = step(params, caches, logits.argmax(-1)[
                        :, None].to(torch.int32), PCAP + j)

        held = {arch: (served_config(get_reduced, arch), M.params_from_jax(
            TPW.unflatten(flat, f"lm/{arch}"), get_reduced(arch), "cpu",
            policy=policy)) for arch in (ENGINE, MAMBA, JAMBA)}
        cfg, params = held[ENGINE]
        runs = [("engine/" + combo, ENGINE, ENGINE_KW)]
        if combo == "2x2":
            runs += [("engine3", ENGINE, dict(ENGINE_KW, slots=3)),
                     ("mamba_engine", MAMBA, ENGINE_KW),
                     ("jamba_engine", JAMBA, ENGINE_KW)]
        for prefix, arch, kw in runs:
            feats, spec = TPW.request_data(held[arch][0].vocab)
            store = FeatureStore(make_context("cpu"), "drug_id", feats,
                                 probe_capacity=8, chunk_rows=8)
            eng = ServingEngine(*held[arch], policy=policy,
                                feature_stores={"drug_id": store},
                                device="cpu", **kw)
            out[f"{prefix}/cache_rows"] = np.array(
                next(iter(M.cache_leaves(eng.caches)))[1].shape[1])
            for c, v in TPW._leaves(eng.caches):
                out[f"{prefix}/cache_shapes/{c}"] = np.array([v.shape])
            margins = TPW.record_margins(eng)
            reqs = [Request(req_id=i, prompt=p, gen_len=g, drug_id=d)
                    for i, p, g, d in spec]
            rejected, done = TPW.serve_all(eng, reqs)
            TPW.engine_record(out, done, rejected, eng, prefix)
            for rid, m in margins.items():
                out[f"{prefix}/{rid}/margins"] = np.array(m, np.float32)
            out[f"{prefix}/store_dropped"] = np.array(store.dropped)

        if combo != "2x2":
            continue
        out["mem/rank_bytes"] = np.array(sum(
            t.numel() * t.element_size() for _, t in TPW._leaves(params)))
        for leaf, t in TPW._leaves(params):
            out[f"mem/leaf/{leaf}"] = np.array(t.numel() * t.element_size())
        cfg = get_reduced(MOE_ARCH)
        p = Sh.gather_data(M.params_from_jax(
            TPW.unflatten(flat, f"moe/{MOE_ARCH}"), cfg, "cpu",
            policy=policy), policy)
        x = torch.from_numpy(moe_x(cfg)).bfloat16()
        x = x[Sh.batch_block(policy, x.shape[0])]
        Moe.drop_log = []
        try:
            y, _ = Moe.moe_decode(p, cfg, x, policy, MOE_CF)
        finally:
            log, Moe.drop_log = Moe.drop_log, None
        assert len(log) == 1, log
        out["moe/y"] = y.float().numpy()
        out["moe/dropped"] = np.array(int(log[0]))
        out["moe/ids"] = Moe._route(p["router"], x.reshape(-1, x.shape[2]),
                                    cfg.top_k)[1].numpy()

    if mesh_name == "2x2":
        tree = TPW.unflatten(flat, f"lm/{ENGINE}")
        for flavor in ("tp", "fsdp_tp"):
            out[f"adamw/{flavor}"] = np.array(adamw_case(
                tree, Sh.make_policy(mesh, flavor)))
        for combo, sizes in POD_COMBOS.items():
            policy = Sh.make_policy(Me.make_mesh(sizes), "fsdp_tp")
            out[f"lm/{combo}/coord"] = np.array([policy.batch_rank,
                                                 policy.model_rank])
            lm_cases(combo, policy)

    dist.barrier()
    np.savez(f"{out_path}.rank{rank}.npz", **out)
    dist.destroy_process_group()


if __name__ == "__main__":
    if sys.argv[1] == "jax":
        run_jax(sys.argv[2], sys.argv[3], sys.argv[4].split(","))
    else:
        run_torch(sys.argv[2], sys.argv[3], sys.argv[4], int(sys.argv[5]),
                  sys.argv[6])
