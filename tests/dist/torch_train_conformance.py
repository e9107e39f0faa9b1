"""Subprocess worker for tests/test_torch_train_mesh.py: one train step at
``data=2, model=2``, ``pod=2, data=2, model=1`` or ``data=1, model=4``,
run by the JAX package over four forced host devices or by four PyTorch
ranks, on the same weights and batch, written to one ``.npz``.

Usage:
  XLA_FLAGS=--xla_force_host_platform_device_count=4 \\
      python torch_train_conformance.py jax OUT.npz WEIGHTS.npz ROUTES.npz
  python torch_train_conformance.py torch OUT.npz WEIGHTS.npz ROUTES.npz \\
      RANK STORE [CKPT_DIR]

``WEIGHTS.npz`` holds the reference's ``init_params(PRNGKey(0))`` of each
reduced arch of ``CASES``, flattened with ``/``, written by the test.
Each case (``[mesh/]arch/flavor[/capacity]``) is one ``make_train_step``
under ``make_policy(mesh, flavor)`` at its mesh (``MESHES``) on
``lm_batch_at(0)`` of ``ROWS[mesh]`` x ``S`` tokens (:func:`batch_of`:
with an enc-dec config's frames or a vision config's patch embeddings)
with ``OPT`` (the reference: the ``REFERENCE_CASES``): its
metrics, every new parameter and AdamW moment
whole (the reference's ``np.asarray`` of the global array, the port's
gathered by ``sharding.StateLayout``), and for each MoE layer and rank
the routed expert ids and the dropped rows of the forward (the
reference's from a ``jax.debug.callback`` in its dispatch plan, as its
``~ok`` counts them).  The reference also takes the same step at world 1
and writes its moments (the cases without MoE layers).

A MoE layer is counted among the stack's MoE layers (:func:`n_moe`: a
period stack's MoE sub-layers over its periods), in the forward's
order.  The reference runs its MoE cases first and then writes their
routed ids
to ``ROUTES.npz``; the port's ranks run their other cases, wait for that
file, and take the reference's routes in the MoE cases it ran
(:func:`pin_routes`), so that a near tie of the router's top-k, which
the two packages' float32 products in other orders may break
differently, moves no row and every leaf is compared.  They write how
their own top-k differed: the rows of each layer and rank that picked
other experts, and the largest gap between the router's probabilities
of the two picks.  The port's ranks also write their own moments
(``OUT.rank<r>.npz``: the ZeRO-1 slices) and, with ``CKPT_DIR``, restore
the world-1 checkpoint the test wrote there at this world, bit for bit
against their slices, and save and restore their state after the step.

In ``torch`` mode the ranks meet through a gloo process group on a
``file://`` store with a timeout on the group, and rank 0 writes.
"""
import dataclasses
import os
import sys
import threading
import time

import numpy as np

WORLD = 4
MESHES = {"2x2": {"data": 2, "model": 2},
          # two batch axes: the rows over pod x data, the weights and
          # moments cut over data and whole over pod
          "pod": {"pod": 2, "data": 2, "model": 1},
          # reduced granite-3-2b's 2 KV heads over 4 model ranks: two
          # ranks share each
          "1x4": {"data": 1, "model": 4}}
MESH = MESHES["2x2"]
# rows of a case's batch: one or two a batch rank
ROWS = {"2x2": 2, "pod": 4, "1x4": 2}
B, S = ROWS["2x2"], 32
OPT = dict(lr=1e-3, warmup_steps=0, total_steps=10)
# an arch with its config changed: (arch, replaced fields); the weights
# are the reference's init_params of the changed config
VARIANTS = {"granite-3-2b-kv1": ("granite-3-2b", {"n_kv_heads": 1})}
# name -> (arch, flavor, capacity factor or None, mesh); at 5 >= E /
# top_k no row can drop, at 1.25 rows drop
CASES = {
    "granite-moe-3b-a800m/tp/5": ("granite-moe-3b-a800m", "tp", 5.0, "2x2"),
    "granite-moe-3b-a800m/tp/1.25": ("granite-moe-3b-a800m", "tp", 1.25,
                                     "2x2"),
    "granite-moe-3b-a800m/fsdp_tp/5": ("granite-moe-3b-a800m", "fsdp_tp",
                                       5.0, "2x2"),
    "lm100m/tp": ("lm100m", "tp", None, "2x2"),
    "qwen1.5-110b/fsdp_tp": ("qwen1.5-110b", "fsdp_tp", None, "2x2"),
    # a Mamba stack: E over the model axis, in_proj's [x | z] cut per part
    "falcon-mamba-7b/tp": ("falcon-mamba-7b", "tp", None, "2x2"),
    "falcon-mamba-7b/fsdp_tp": ("falcon-mamba-7b", "fsdp_tp", None, "2x2"),
    # an encoder and cross-attention (frames), and a patch prefix: every
    # attention's heads over the model axis, the rows over data
    "seamless-m4t-large-v2/tp": ("seamless-m4t-large-v2", "tp", None,
                                 "2x2"),
    "seamless-m4t-large-v2/fsdp_tp": ("seamless-m4t-large-v2", "fsdp_tp",
                                      None, "2x2"),
    "internvl2-2b/tp": ("internvl2-2b", "tp", None, "2x2"),
    # pod x data: one row a batch rank.  At model 1 a MoE layer runs
    # moe_dense in both packages (the reference's moe_apply), no dispatch
    # plan to pin, and its aux is the whole batch's
    "pod/granite-3-2b/tp": ("granite-3-2b", "tp", None, "pod"),
    "pod/granite-3-2b/fsdp_tp": ("granite-3-2b", "fsdp_tp", None, "pod"),
    "pod/granite-moe-3b-a800m/fsdp_tp": ("granite-moe-3b-a800m", "fsdp_tp",
                                         None, "pod"),
    # KV heads shared by model ranks: each rank's k / v gradient summed
    # over the ranks that hold its head
    "1x4/granite-3-2b/tp": ("granite-3-2b", "tp", None, "1x4"),
    "1x4/granite-3-2b/fsdp_tp": ("granite-3-2b", "fsdp_tp", None, "1x4"),
    "granite-3-2b-kv1/tp": ("granite-3-2b-kv1", "tp", None, "2x2"),
    # a period stack (Jamba: Mamba, attention and MoE sub-layers) under
    # both flavors, and at 1x4, where two model ranks share each KV head
    "jamba-1.5-large-398b/tp/5": ("jamba-1.5-large-398b", "tp", 5.0,
                                  "2x2"),
    "jamba-1.5-large-398b/fsdp_tp/5": ("jamba-1.5-large-398b", "fsdp_tp",
                                       5.0, "2x2"),
    "1x4/jamba-1.5-large-398b/tp/5": ("jamba-1.5-large-398b", "tp", 5.0,
                                      "1x4"),
}
MAMBA = "falcon-mamba-7b"
SEAMLESS = "seamless-m4t-large-v2"
GRANITE = "granite-3-2b"
JAMBA = "jamba-1.5-large-398b"
# the layout round trips of these archs' training states (a Mamba stack's
# in_proj cut per part, an encoder subtree; granite-3-2b at pod x data
# and with its KV heads shared at 1x4): arch -> (label, mesh, flavor)
LAYOUTS_OF = {a: (("2x2/tp", "2x2", "tp"), ("2x2/fsdp_tp", "2x2", "fsdp_tp"),
                  ("1x4", "1x4", "fsdp_tp")) for a in (MAMBA, SEAMLESS,
                                                       JAMBA)}
LAYOUTS_OF[GRANITE] = (("pod/tp", "pod", "tp"),
                       ("pod/fsdp_tp", "pod", "fsdp_tp"),
                       ("1x4/tp", "1x4", "tp"),
                       ("1x4/fsdp_tp", "1x4", "fsdp_tp"))
LAYOUTS = LAYOUTS_OF[MAMBA]
# the cases whose state after the step each rank saves, whole leaves the
# test restores at world 1: case -> the checkpoint's tag
MESH_CKPTS = {"falcon-mamba-7b/tp": MAMBA,
              "seamless-m4t-large-v2/tp": SEAMLESS,
              "pod/granite-3-2b/tp": "pod",
              "jamba-1.5-large-398b/tp/5": JAMBA}
ARCHS = sorted({c[0] for c in CASES.values()})
# MoE cases at model 1, whose layers run moe_dense: the reference's routes
# come from its router (whole batch), not from a dispatch plan
DENSE_MOE_CASES = ["pod/granite-moe-3b-a800m/fsdp_tp"]
# MoE cases under fsdp_tp at 2x2, held to the port's own tp step at the
# same mesh (the reference's fsdp_tp arithmetic is qwen's)
FSDP_MOE_CASES = {"granite-moe-3b-a800m/fsdp_tp/5":
                  "granite-moe-3b-a800m/tp/5",
                  "jamba-1.5-large-398b/fsdp_tp/5":
                  "jamba-1.5-large-398b/tp/5"}
# the port takes the reference's routes in these (its MoE cases run first)
PINNED_CASES = [n for n in CASES if CASES[n][2] is not None
                and n not in FSDP_MOE_CASES] + DENSE_MOE_CASES
# the cases the reference runs too, the pinned ones first
REFERENCE_CASES = PINNED_CASES + [
    n for n in CASES if n not in PINNED_CASES and n not in FSDP_MOE_CASES]
ROUTES_WAIT_S = 500


def reduced(getter, arch):
    """The reduced config of ``arch`` (a name of ``VARIANTS`` too)."""
    base, fields = VARIANTS.get(arch, (arch, {}))
    return dataclasses.replace(getter(base), **fields)


def config(getter, name):
    arch, _, cf, _ = CASES[name]
    cfg = reduced(getter, arch)
    if cf is not None:
        cfg = dataclasses.replace(cfg, train=dataclasses.replace(
            cfg.train, moe_capacity_factor=cf))
    return cfg


def rows_of(name):
    """The rows of case ``name``'s batch."""
    return ROWS[CASES[name][3]]


def n_moe(cfg) -> int:
    """The MoE layers of ``cfg``'s stack (a period stack's MoE
    sub-layers, counted over its periods)."""
    return sum(cfg._layer_has_moe(i) for i in range(cfg.n_layers))


def model_ranks(name) -> int:
    """The model ranks of case ``name``'s mesh."""
    return MESHES[CASES[name][3]]["model"]


def batch_of(cfg, lm_batch_at, rows=B):
    """``lm_batch_at(0)`` (the calling package's) of ``rows`` x ``S``
    tokens with the config's frontend inputs (numpy, seeded): an enc-dec
    config's frames, ``S // enc_len_ratio`` a row; a vision config's
    ``frontend_tokens`` patch embeddings a row, in front of the tokens
    (the loss skips them)."""
    batch = dict(lm_batch_at(0, vocab=cfg.vocab, batch=rows, seq=S))
    rng = np.random.default_rng(9)
    if cfg.is_encdec:
        batch["frames"] = rng.normal(size=(rows, S // cfg.enc_len_ratio,
                                           cfg.d_model)).astype(np.float32)
    if cfg.frontend == "vision":
        batch["patch_embeds"] = rng.normal(size=(
            rows, cfg.frontend_tokens, cfg.d_model)).astype(np.float32)
    return batch


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


def flatten(tree, prefix=""):
    out = {}
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            out.update(flatten(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = v
    return out


def record_routes(out, key, calls, n_layers, capacity):
    """Each rank's routed ids and dropped rows of the forward's MoE
    layers: ``calls`` maps (data, model) to that shard's dispatch plans,
    (flat ids, ranks) in call order, the first ``n_layers`` (the MoE
    layers, :func:`n_moe`) the forward's."""
    for (d, m), plans in sorted(calls.items()):
        for layer, (eid, ranks) in enumerate(plans[:n_layers]):
            eid, ranks = np.asarray(eid), np.asarray(ranks)
            T = eid.size // capacity[1]
            C = max(1, int(np.ceil(T * capacity[1] / capacity[2]
                                   * capacity[0])))
            out[f"{key}/ids/{layer}/{d}/{m}"] = eid.astype(np.int32)
            out[f"{key}/dropped/{layer}/{d}/{m}"] = np.array(
                int((ranks >= C).sum()), np.int64)


# --------------------------------------------------------------------------
# the JAX reference
# --------------------------------------------------------------------------


def run_jax(out_path, weights_path, routes_path):
    import jax
    import jax.numpy as jnp
    from jax.sharding import AxisType
    from repro.configs import get_reduced
    from repro.data.synthetic import lm_batch_at
    from repro.models import model as JM
    from repro.models import moe as JMoe
    from repro.models.sharding import make_policy
    from repro.optim import adamw as JA

    assert len(jax.devices()) == WORLD
    # Auto axes: the reference's GSPMD constraints need them
    meshes = {k: jax.make_mesh(tuple(v.values()), tuple(v),
                               axis_types=(AxisType.Auto,) * len(v))
              for k, v in MESHES.items()}
    flat = dict(np.load(weights_path))
    opt_cfg = JA.AdamWConfig(**OPT)
    calls, lock = {}, threading.Lock()
    plain = JMoe.radix_histogram_ranks

    def plan(eid, P):
        counts, ranks = plain(eid, P)

        def keep(e, r, d, m):
            with lock:
                calls.setdefault((int(d), int(m)), []).append((e, r))

        jax.debug.callback(keep, eid, ranks, jax.lax.axis_index("data"),
                           jax.lax.axis_index("model"))
        return counts, ranks

    JMoe.radix_histogram_ranks = plan
    plain_route, dense = JMoe._route, []

    def route(router, x2d, top_k):
        w, ids, aux = plain_route(router, x2d, top_k)

        def keep(i):
            with lock:
                dense.append(np.asarray(i))

        jax.debug.callback(keep, ids)      # the whole batch's
        return w, ids, aux

    out, world1 = {}, {}
    assert REFERENCE_CASES[:len(PINNED_CASES)] == PINNED_CASES
    for name in REFERENCE_CASES:
        if name == REFERENCE_CASES[len(PINNED_CASES)]:
            write_routes(routes_path, out)
        arch, flavor, cf, mesh = CASES[name]
        cfg = config(get_reduced, name)
        params = jax.tree_util.tree_map(jnp.asarray,
                                        unflatten(flat, arch))
        batch = {k: jnp.asarray(v) for k, v in batch_of(
            cfg, lm_batch_at, rows_of(name)).items()}
        step = jax.jit(JM.make_train_step(
            cfg, make_policy(meshes[mesh], flavor), opt_cfg))
        calls.clear()
        dense.clear()
        JMoe._route = route if name in DENSE_MOE_CASES else plain_route
        new, opt, met = step(params, JA.init(params, opt_cfg), batch)
        jax.block_until_ready(new)
        jax.effects_barrier()
        JMoe._route = plain_route
        for L, ids in enumerate(dense[:n_moe(cfg)]):
            # the forward's routes, layer by layer (a recompute follows)
            out[f"{name}/ids/{L}"] = ids.astype(np.int32)
        for k, v in met.items():
            out[f"{name}/met/{k}"] = np.asarray(v, np.float32)
        for what, tree in (("new", new), ("m", opt["m"]), ("v", opt["v"])):
            for k, v in flatten(tree).items():
                out[f"{name}/{what}/{k}"] = np.asarray(v, np.float32)
        if cf is not None:
            record_routes(out, name, calls, n_moe(cfg),
                          (cf, cfg.top_k, cfg.n_experts))
            continue
        # the same step at world 1: how far the layout alone moves the
        # reference's moments (a MoE layer's auxiliary loss is a mean over
        # the shards, another function at world 1; at model 1 it is the
        # whole batch's); one for each arch and batch
        key = (arch, rows_of(name))
        if key not in world1:
            _, opt, _ = jax.jit(JM.make_train_step(cfg, None, opt_cfg))(
                params, JA.init(params, opt_cfg), batch)
            world1[key] = {f"{what}/{k}": np.asarray(v, np.float32)
                           for what in ("m", "v")
                           for k, v in flatten(opt[what]).items()}
        for k, v in world1[key].items():
            out[f"{name}/world1/{k}"] = v
    np.savez(out_path, **out)


def write_routes(routes_path, out):
    """The routed ids of the MoE cases, written whole before the file
    appears under its name."""
    part = f"{routes_path}.part"
    with open(part, "wb") as f:
        np.savez(f, **{k: v for k, v in out.items() if "/ids/" in k})
    os.replace(part, routes_path)


def read_routes(routes_path):
    deadline = time.monotonic() + ROUTES_WAIT_S
    while not os.path.exists(routes_path):
        if time.monotonic() > deadline:
            raise TimeoutError(f"no {routes_path} in {ROUTES_WAIT_S} s")
        time.sleep(0.1)
    return dict(np.load(routes_path))


def pin_routes(picks, differ):
    """A ``moe._route`` that picks, for the ``n``-th MoE layer of the
    forward (counted by its router; a recompute picks as its forward
    did), the experts ``picks[n]`` (T, k), largest first, with the gates
    and the auxiliary loss that ``moe._route`` gives for those picks;
    for each forward call it sets ``differ[n]`` to (the rows whose own
    top-k picks other experts or another order, the largest gap between
    the router's probabilities of the two picks on those rows)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.models import moe as Moe

    plain, layers = Moe._route, {}

    def route(router, x2, top_k):
        n = layers.setdefault(router.data_ptr(), len(layers))
        pick = torch.from_numpy(picks[n]).long()
        _, own, _ = plain(router, x2, top_k)
        probs = torch.softmax(x2.float() @ router.float(), dim=-1)
        vals = torch.gather(probs, 1, pick)
        if not Moe._recomputing:
            with torch.no_grad():     # the recompute saves what this did
                rows = (own.long() != pick).any(dim=1)
                gap = (torch.gather(probs, 1, own.long()) - vals).abs()
                differ[n] = (int(rows.sum()),
                             float(gap[rows].max()) if rows.any() else 0.0)
        w = vals / torch.clamp(vals.sum(dim=-1, keepdim=True), min=1e-9)
        E = router.shape[1]
        frac = F.one_hot(pick[:, 0], E).float().mean(dim=0)
        aux = E * torch.sum(frac * probs.mean(dim=0))
        return w, pick.to(torch.int32), aux
    return route


# --------------------------------------------------------------------------
# the port, one rank per process
# --------------------------------------------------------------------------


def run_torch(out_path, weights_path, routes_path, rank, store_path,
              ckpt_dir=None):
    import torch
    import torch.distributed as dist
    from repro_torch import checkpoint as Ck
    from repro_torch.configs import get_reduced
    from repro_torch.data.synthetic import lm_batch_at
    from repro_torch.launch import mesh as Me
    from repro_torch.models import model as M
    from repro_torch.models import moe as Moe
    from repro_torch.models import sharding as Sh
    from repro_torch.optim import adamw as A

    torch.set_num_threads(1)
    Me.init_rank(rank, WORLD, store_path, "cpu", timeout_s=120)
    meshes = {k: Me.make_mesh(v) for k, v in MESHES.items()}
    flat = dict(np.load(weights_path))
    opt_cfg = A.AdamWConfig(**OPT)
    plain = Moe.radix_histogram_ranks
    plans = []

    def plan(eid, P):
        counts, ranks = plain(eid, P)
        if not Moe._recomputing:
            plans.append((eid.clone(), ranks.clone()))
        return counts, ranks

    Moe.radix_histogram_ranks = plan
    out, mine = {}, {}
    route, routes = Moe._route, None
    for name in sorted(CASES, key=lambda n: n in PINNED_CASES):
        arch, flavor, cf, mesh = CASES[name]
        cfg = config(get_reduced, name)
        Mm = model_ranks(name)
        d, m = divmod(rank, Mm)
        differ = {}
        policy = Sh.make_policy(meshes[mesh], flavor)
        if name in PINNED_CASES:
            routes = routes or read_routes(routes_path)
            if name in DENSE_MOE_CASES:     # this rank's rows of the batch
                rows = Sh.batch_block(policy, rows_of(name))
                picks = [routes[f"{name}/ids/{L}"].reshape(
                    rows_of(name), S, -1)[rows].reshape(-1, cfg.top_k)
                    for L in range(n_moe(cfg))]
            else:
                picks = [routes[f"{name}/ids/{L}/{d}/{m}"].reshape(
                    -1, cfg.top_k) for L in range(n_moe(cfg))]
            Moe._route = pin_routes(picks, differ)
        params = M.params_from_jax(unflatten(flat, arch), cfg, "cpu",
                                   master=True, policy=policy)
        zero = Sh.Zero1(policy, A.flatten_params(params))
        opt = A.init({k: zero.local(k, p) for k, p in
                      A.flatten_params(params).items()}, opt_cfg)
        batch = {k: torch.from_numpy(v) for k, v in Sh.shard_batch(
            batch_of(cfg, lm_batch_at, rows_of(name)), policy).items()}
        plans.clear()
        Moe.drop_log = []
        try:
            new, opt, met = M.make_train_step(cfg, policy, opt_cfg)(
                params, opt, batch)
        finally:
            log, Moe.drop_log = Moe.drop_log, None
            Moe._route = route
        for k, v in met.items():
            out[f"{name}/met/{k}"] = v.numpy()
        layout = Sh.train_state_layout(policy, new, opt, cfg)
        whole = layout.whole(Ck.tree_leaves((new, opt)))
        if whole is not None:
            keys = [f"new/{k}" for k in A.flatten_params(new)]
            keys += [f"m/{k}" for k in sorted(opt["m"])] + ["step"]
            keys += [f"v/{k}" for k in sorted(opt["v"])]
            for k, a in zip(keys, whole):
                out[f"{name}/{k}"] = a
        for what in ("m", "v"):
            for k, v in opt[what].items():
                mine[f"{name}/{what}/{k}"] = v.numpy()
        if cf is not None:
            fwd = [e for e in log if not isinstance(e, Moe.Recomputed)]
            assert len(fwd) == n_moe(cfg), log
            # every rank's plans and drops, gathered in rank order
            calls = {divmod(r, Mm): got
                     for r, got in enumerate(gather_objects(
                         [(e.numpy(), rk.numpy()) for e, rk in plans]))}
            record_routes(out, name, calls, n_moe(cfg),
                          (cf, cfg.top_k, cfg.n_experts))
            drops = gather_objects([int(x) for x in fwd])
            for r, ds in enumerate(drops):
                rd, rm = divmod(r, Mm)
                for layer, n in enumerate(ds):
                    out[f"{name}/log_dropped/{layer}/{rd}/{rm}"] = \
                        np.array(n, np.int64)
        if name in PINNED_CASES:
            assert sorted(differ) == list(range(n_moe(cfg))), differ
            for r, got in enumerate(gather_objects(differ)):
                rd, rm = divmod(r, Mm)
                for layer, (rows, gap) in got.items():
                    out[f"{name}/own_differ/{layer}/{rd}/{rm}"] = \
                        np.array(rows, np.int64)
                    out[f"{name}/own_gap/{layer}/{rd}/{rm}"] = \
                        np.array(gap, np.float64)
        if ckpt_dir is not None and name == "lm100m/tp":
            checkpoint_cases(ckpt_dir, cfg, policy, params, new, opt,
                             layout, out)
        if ckpt_dir is not None and name in MESH_CKPTS:
            # whole leaves, which the test restores at world 1
            Ck.save(f"{ckpt_dir}_{MESH_CKPTS[name]}", 1, (new, opt),
                    layout=layout)
    for arch in LAYOUTS_OF:
        layout_cases(arch, unflatten(flat, arch), meshes, out)
    np.savez(f"{out_path}.rank{rank}.npz", **mine)
    dist.barrier()
    if rank == 0:
        np.savez(out_path, **out)
    dist.destroy_process_group()


def layout_key(arch, label):
    """The results' prefix of ``arch``'s layout round trip at ``label``
    (the Mamba stack's under ``layout/<label>``)."""
    return f"layout/{label}" if arch == MAMBA else f"layout/{arch}/{label}"


def layout_cases(arch, tree, meshes, out):
    """The layout round trips of reduced ``arch``'s training state at
    each of ``LAYOUTS_OF[arch]`` (``meshes``: the port's mesh of each
    name of ``MESHES``), each rank's booleans gathered into
    ``out[layout_key(arch, label) + "/<check>"]``:

    * ``whole``: ``StateLayout.whole`` of the rank's slices
      (``shard_params``) and of moments set to their 2D slices (``m``)
      and twice those (``v``) gives back every whole leaf bit for bit,
      ``in_proj`` in the reference's ``[x | z]`` order included;
    * ``local``: ``StateLayout.local`` of each whole leaf is the rank's
      slice bit for bit;
    * ``gather_data``: under ``fsdp_tp`` the layer's 2D slices gathered
      over data are the ``tp`` slices bit for bit (at ``1x4``: the slices
      themselves);
    * ``zero1``: under ``tp`` ``Zero1.local`` of each ``tp`` slice is the
      ``fsdp_tp`` slice, and ``Zero1.whole`` of that gives the ``tp``
      slice back, bit for bit."""
    import torch
    from repro_torch import checkpoint as Ck
    from repro_torch.configs import get_reduced
    from repro_torch.launch import mesh as Me
    from repro_torch.models import model as M
    from repro_torch.models import sharding as Sh
    from repro_torch.optim import adamw as A

    cfg = reduced(get_reduced, arch)
    whole = {k: torch.from_numpy(np.asarray(v, np.float32))
             for k, v in flatten(tree).items()}
    for label, mesh, flavor in LAYOUTS_OF[arch]:
        m = meshes[mesh]

        def held(fl):
            return A.flatten_params(M.params_from_jax(
                tree, cfg, "cpu", master=True,
                policy=Sh.make_policy(m, fl)))

        policy = Sh.make_policy(m, flavor)
        params = held(flavor)
        zero = Sh.Zero1(policy, params)
        local2d = {k: zero.local(k, p).clone() for k, p in params.items()}
        opt = {"m": local2d, "v": {k: 2 * v for k, v in local2d.items()},
               "step": torch.zeros((), dtype=torch.int32)}
        tree_p = A.unflatten_params(params)
        layout = Sh.train_state_layout(policy, tree_p, opt, cfg)
        leaves = Ck.tree_leaves((tree_p, opt))
        got = layout.whole(leaves)
        # the same leaves whole, in the same order
        want = Ck.tree_leaves((A.unflatten_params(whole), {
            "m": whole, "v": {k: 2 * v for k, v in whole.items()},
            "step": torch.zeros((), dtype=torch.int32)}))
        ok_whole = got is None or (len(got) == len(want) and all(
            np.array_equal(g, w.numpy()) and g.dtype == w.numpy().dtype
            for g, w in zip(got, want)))
        ok_local = all(
            np.array_equal(layout.local(w.numpy(), i), leaf.numpy())
            for i, (w, leaf) in enumerate(zip(want, leaves)))
        tp = held("tp")
        fsdp = held("fsdp_tp") if flavor == "tp" else params
        gathered = A.flatten_params(Sh.gather_data(
            A.unflatten_params(fsdp), Sh.make_policy(m, "fsdp_tp")))
        ok_gather = all(torch.equal(gathered[k], tp[k]) for k in tp)
        ok_zero = True
        if flavor == "tp":
            ok_zero = all(torch.equal(zero.local(k, tp[k]), fsdp[k])
                          and torch.equal(zero.whole(
                              k, fsdp[k].clone(), torch.zeros_like(tp[k])),
                              tp[k]) for k in tp)
        for check, ok in (("whole", ok_whole), ("local", ok_local),
                          ("gather_data", ok_gather), ("zero1", ok_zero)):
            out[f"{layout_key(arch, label)}/{check}"] = np.array(
                gather_objects(ok))


def gather_objects(obj):
    import torch.distributed as dist
    got = [None] * dist.get_world_size()
    dist.all_gather_object(got, obj)
    return got


def checkpoint_cases(ckpt_dir, cfg, policy, params, new, opt, layout, out):
    """The world-1 checkpoint of the initial state (written by the test
    at step 0) restored at this world equals this rank's slices of the
    initial state bit for bit; the state after the step, saved at this
    world and restored, equals this rank's state bit for bit."""
    import torch
    from repro_torch import checkpoint as Ck
    from repro_torch.optim import adamw as A

    zero_opt = A.init({k: torch.zeros_like(v) for k, v in
                       opt["m"].items()}, A.AdamWConfig(**OPT))
    step, (p0, o0) = Ck.restore(ckpt_dir, (params, zero_opt), step=0,
                                layout=layout)
    same = step == 0 and all(
        torch.equal(a, b) for a, b in zip(Ck.tree_leaves((p0, o0)),
                                          Ck.tree_leaves((params,
                                                          zero_opt))))
    Ck.save(ckpt_dir, 1, (new, opt), layout=layout)
    step, back = Ck.restore(ckpt_dir, (new, opt), step=1, layout=layout)
    same_after = step == 1 and all(
        torch.equal(a, b) for a, b in zip(Ck.tree_leaves(back),
                                          Ck.tree_leaves((new, opt))))
    ok = gather_objects((same, same_after))
    out["ckpt/world1_restored"] = np.array([a for a, _ in ok])
    out["ckpt/roundtrip"] = np.array([b for _, b in ok])


if __name__ == "__main__":
    mode, out_path, weights_path, routes_path = sys.argv[1:5]
    if mode == "jax":
        run_jax(out_path, weights_path, routes_path)
    else:
        run_torch(out_path, weights_path, routes_path, int(sys.argv[5]),
                  sys.argv[6], sys.argv[7] if len(sys.argv) > 7 else None)
