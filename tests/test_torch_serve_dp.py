"""The port's serving path at a data axis of two ranks against the JAX
package at the same meshes (``tests/dist/torch_dp_conformance.py``).

The port's ranks are gloo processes that meet through a ``file://``
store under ``tmp_path`` with a 120 s timeout on the process group: two
for ``(data=2, model=1)``, four for ``(data=2, model=2)``.  The JAX
reference runs in one subprocess with four forced host devices and an
Auto-axis mesh of each shape.  Every process is killed past
``LIMIT_S``.  Both sides start from the reference's
``init_params(PRNGKey(0))`` / ``moe_init`` weights, which this module
writes.  Meshes and flavors: ``2x1`` (``fsdp_tp``), ``2x2``
(``fsdp_tp``) and ``2x2tp`` (``tp``); the reference's cases run in two
processes at once, ``2x2`` in one and the other two in the other.

* ``make_slot_prefill`` into four slots, then greedy ``make_serve_step``
  over them (two slots a data rank), on reduced ``granite-3-2b`` and
  ``granite-moe-3b-a800m``: prefill and decode logits within
  ``LOGIT_TOL`` (greedy tokens by the rule of
  ``tests/test_torch_tp.py``), every rank's logits the same bits, each
  rank's caches within ``LOGIT_TOL`` of its block of the reference's
  slots and its KV heads.
* Both engines with their policy and a feature store over all ranks on
  the same requests (reduced ``granite-moe-3b-a800m``, 4 slots): the
  same rejections, counts, statuses and features, greedy tokens equal up
  to the first margin below ``2 * LOGIT_TOL``, every rank's tokens
  equal; at ``2x2`` also with 3 slots, which stay whole on every rank.
* ``make_prefill`` and greedy ``make_serve_step`` on four rows (two a
  data rank) of reduced ``seamless-m4t-large-v2`` (frames through the
  encoder, cross-attention) and ``internvl2-2b`` (patch embeddings in
  front, decode from P + S) at each mesh against the reference: logits
  within ``LOGIT_TOL``, greedy tokens by the module's rule, every rank's
  logits the same bits, each rank's ``k``/``v`` (and ``ck``/``cv``)
  within ``LOGIT_TOL`` of its rows and KV heads of the reference's.
* ``make_prefill`` and greedy ``make_serve_step`` on reduced
  ``falcon-mamba-7b`` (the reference's slot prefill runs a Mamba state
  through the prompt's padding) at each mesh against the reference, and
  the port's Mamba engine at ``2x2`` against its world-1 engine; reduced
  ``jamba-1.5-large-398b`` (period stacks) the same way at ``2x2``
  under ``fsdp_tp``, each rank's sub-layer caches its rows and channels
  or KV heads of the reference's.
* ``moe_decode`` at ``2x2`` on 4 x 8 rows a data rank at capacity factor
  0.5: rows drop in the reference, and every rank whose shard routes
  like the reference drops as many rows as the reference's shard.
* At ``2x2`` under ``fsdp_tp`` each rank holds its 2D slices: its
  parameter bytes are the sum of its slices', and a leaf cut over both
  axes sums over the four ranks to the whole leaf.
* The slot prefill and greedy decode of reduced ``granite-3-2b`` and
  ``granite-moe-3b-a800m`` at two batch axes, ``pod=2, data=2, model=1``
  and ``pod=2, data=1, model=2`` under ``fsdp_tp`` (the ``2x2`` ranks on
  meshes of their own, the reference in its second process), as above.
* ``launch.serve --mesh data=2,model=2`` and ``--mesh pod=2,data=2,model=1``
  on the CPU print ``serve OK``.
"""
import importlib.util
import os
import subprocess
import sys

import numpy as np
import pytest

import jax

from repro import configs as JC
from repro.models import model as JM
from repro.models import moe as JMoe
from repro_torch import configs as TC
from repro_torch.launch import mesh as Me
from repro_torch.models import model as TM
from repro_torch.models import sharding as Sh

HERE = os.path.dirname(os.path.abspath(__file__))
WORKER_PATH = os.path.join(HERE, "dist", "torch_dp_conformance.py")
SRC = os.path.join(os.path.dirname(HERE), "src")
LIMIT_S = 600
LOGIT_TOL = 2e-2
BF16_TOL = 2e-2
MAMBA_STATE_TOL = 2e-2

_spec = importlib.util.spec_from_file_location("torch_dp_conformance",
                                               WORKER_PATH)
W = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(W)


def _flatten(tree, prefix, out):
    for k, v in tree.items():
        if isinstance(v, dict):
            _flatten(v, f"{prefix}/{k}", out)
        else:
            out[f"{prefix}/{k}"] = np.asarray(v)


def write_weights(path):
    flat = {}
    for name in W.MODELS + (W.MAMBA, W.JAMBA) + W.ONESHOT:
        _flatten(JM.init_params(jax.random.PRNGKey(0),
                                JC.get_reduced(name)), f"lm/{name}", flat)
    _flatten(JMoe.moe_init(jax.random.PRNGKey(10),
                           JC.get_reduced(W.MOE_ARCH)), f"moe/{W.MOE_ARCH}",
             flat)
    np.savez(path, **flat)
    return flat


def _start(args, env_extra=None):
    env = {k: v for k, v in os.environ.items() if not k.startswith("REPRO_")}
    env.update(PYTHONPATH=SRC, **(env_extra or {}))
    return subprocess.Popen([sys.executable, WORKER_PATH, *args], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)


def _finish(proc, what):
    try:
        out, _ = proc.communicate(timeout=LIMIT_S)
    except subprocess.TimeoutExpired:
        proc.kill()
        out, _ = proc.communicate()
        raise AssertionError(f"{what} hung past {LIMIT_S} s:\n{out[-3000:]}")
    assert proc.returncode == 0, f"{what} failed:\n{out[-3000:]}"


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(weights, JAX results, {mesh: [each rank's results]}) of one run
    of the worker on each side."""
    tmp = tmp_path_factory.mktemp("dp")
    weights = write_weights(tmp / "weights.npz")
    shares = ("2x2", ",".join(["2x1", "2x2tp", *W.POD_COMBOS]))
    procs = [(_start(["jax", str(tmp / f"jax{i}.npz"),
                      str(tmp / "weights.npz"), combos],
                     {"XLA_FLAGS": "--xla_force_host_platform_device_count=4",
                      "JAX_PLATFORMS": "cpu"}), f"jax reference {combos}")
             for i, combos in enumerate(shares)]
    worlds = {"2x1": 2, "2x2": 4}
    for mesh, world in worlds.items():
        procs += [(_start(["torch", mesh, str(tmp / mesh),
                           str(tmp / "weights.npz"), str(rank),
                           str(tmp / f"store_{mesh}")]),
                   f"torch {mesh} rank {rank}") for rank in range(world)]
    try:
        for proc, what in procs:
            _finish(proc, what)
    finally:
        for proc, _ in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    got = {mesh: [dict(np.load(tmp / f"{mesh}.rank{r}.npz"))
                  for r in range(world)] for mesh, world in worlds.items()}
    want = {}
    for i in range(len(shares)):
        want.update(np.load(tmp / f"jax{i}.npz"))
    return weights, want, got


def ranks_of(got, combo):
    """Each rank's results of ``combo`` (the pod meshes' are the 2x2
    ranks')."""
    return got["2x2" if combo in W.POD_COMBOS else combo[:3]]


def combo_mesh(combo):
    """(batch ranks, model ranks) of ``combo``."""
    if combo in W.POD_COMBOS:
        sizes = W.POD_COMBOS[combo]
        return sizes["pod"] * sizes["data"], sizes["model"]
    return W.COMBOS[combo][:2]


def close(got, want, tol):
    np.testing.assert_allclose(got, want, rtol=tol,
                               atol=tol * float(np.abs(want).max()))


def greedy_agree(got, want, margins, tol):
    """(tokens compared, first position of a difference or the length):
    the rule of tests/test_torch_model.py."""
    n = 0
    for i, (g, w, m, t) in enumerate(zip(got, want, margins,
                                         np.broadcast_to(tol, len(got)))):
        if m > t:
            assert g == w, f"token {i}: {g} != {w} at margin {m}"
            n += 1
        elif g != w:
            return n, i
    return n, len(got)


@pytest.mark.parametrize("name", W.MODELS)
@pytest.mark.parametrize("combo", list(W.COMBOS) + list(W.POD_COMBOS))
def test_prefill_and_decode_match_reference(runs, combo, name):
    """At each mesh, pod x data (pod major) among them: every rank's
    logits the same bits, each rank's caches its block of the slots
    (by its index over the batch axes) and its KV heads, the logits
    against the reference's by the module's rule."""
    _, want, got = runs
    D, Mw = combo_mesh(combo)
    cfg = TC.get_reduced(name)
    key = f"lm/{combo}/{name}"
    ranks = ranks_of(got, combo)
    steps = [f"{key}/prefill/{i}" for i in range(W.SLOTS)] + \
        [f"{key}/logits/{j}" for j in range(W.G - 1)]
    for res in ranks[1:]:               # every rank the same bits
        for s in steps:
            np.testing.assert_array_equal(res[s], ranks[0][s])
    for res in ranks:                   # each rank's block of the caches
        d, m = res[f"lm/{combo}/coord"] if combo in W.POD_COMBOS \
            else res["coord"]
        rows = slice(d * W.SLOTS // D, (d + 1) * W.SLOTS // D)
        h0, nh = Sh.kv_head_block(cfg.n_heads, cfg.n_kv_heads, Mw, m)
        for c in ("k", "v"):
            np.testing.assert_allclose(
                res[f"{key}/{c}"], want[f"{key}/{c}"][:, rows, h0:h0 + nh],
                rtol=LOGIT_TOL, atol=LOGIT_TOL)
    # a slot's logits: its prefill's, then one a decode step
    lg = np.stack([ranks[0][f"{key}/prefill/{i}"] for i in range(W.SLOTS)]
                  )[:, None]
    jl = np.stack([want[f"{key}/prefill/{i}"] for i in range(W.SLOTS)]
                  )[:, None]
    lg = np.concatenate([lg] + [ranks[0][f"{key}/logits/{j}"][:, None]
                                for j in range(W.G - 1)], 1)
    jl = np.concatenate([jl] + [want[f"{key}/logits/{j}"][:, None]
                                for j in range(W.G - 1)], 1)
    assert np.abs(lg[:, 0] - jl[:, 0]).max() <= LOGIT_TOL
    top = np.sort(jl, -1)
    margins = top[..., -1] - top[..., -2]
    diffs = np.abs(lg - jl).max(-1)
    for b in range(W.SLOTS):
        n, same = greedy_agree(lg[b].argmax(-1), jl[b].argmax(-1),
                               margins[b], 2 * diffs[b])
        assert n >= 1 and diffs[b, :same + 1].max() <= LOGIT_TOL


def check_logits(ranks, want, steps, rows, tied=()):
    """Every rank's logits at ``steps`` the same bits; rank 0's against
    the reference's within ``LOGIT_TOL``, greedy tokens by the module's
    rule, row by row over ``rows``.  The rows of ``tied`` (a MoE router's
    near tie on one of their tokens, :func:`near_tie_rows`) are held to
    the token rule alone, and at least one row is not among them."""
    for res in ranks[1:]:
        for s in steps:
            np.testing.assert_array_equal(res[s], ranks[0][s])
    lg = np.stack([ranks[0][s] for s in steps], 1)
    jl = np.stack([want[s] for s in steps], 1)
    top = np.sort(jl, -1)
    margins = top[..., -1] - top[..., -2]
    diffs = np.abs(lg - jl).max(-1)
    assert len(set(tied)) < rows, tied
    for b in range(rows):
        n, same = greedy_agree(lg[b].argmax(-1), jl[b].argmax(-1),
                               margins[b], 2 * diffs[b])
        assert n >= 1
        if b not in tied:
            assert diffs[b, :same + 1].max() <= LOGIT_TOL, (b, diffs[b])


# a near tie of a MoE router: its k-th and (k+1)-th probabilities this
# close, where the two packages' float32 router products, summed in other
# orders, may pick other experts
TIE_GAP = 1e-4


def near_tie_rows(weights, cfg, tokens):
    """The rows of ``tokens`` on one of whose tokens some MoE layer of the
    port's world-1 prefill (the same router inputs but for bf16 roundings)
    has a near tie (``TIE_GAP``)."""
    import torch
    from repro_torch.models import moe as TMoe
    gaps, plain = [], TMoe._route

    def route(router, x2d, k):
        probs = torch.softmax(x2d.float() @ router.float(), dim=-1)
        top = torch.topk(probs, k + 1, dim=-1).values
        gaps.append((top[:, k - 1] - top[:, k]).reshape(tokens.shape))
        return plain(router, x2d, k)

    TMoe._route = route
    try:
        TM.make_prefill(cfg, decode_len=tokens.shape[1])(
            TM.params_from_jax(W.TPW.unflatten(weights, f"lm/{cfg.name}"),
                               cfg, "cpu"),
            {"tokens": torch.from_numpy(tokens)})
    finally:
        TMoe._route = plain
    low = torch.stack(gaps).amin(dim=(0, 2)) < TIE_GAP
    return [int(b) for b in np.flatnonzero(low.numpy())]


@pytest.mark.parametrize("name", W.ONESHOT)
@pytest.mark.parametrize("combo", list(W.COMBOS))
def test_oneshot_prefill_and_decode_match_reference(runs, combo, name):
    """An enc-dec and a vision config through ``make_prefill`` and greedy
    ``make_serve_step`` at each mesh: the batch's rows split over the
    data ranks (frames and patch embeddings with their tokens), every
    attention's heads over the model ranks."""
    _, want, got = runs
    D, Mw, _ = W.COMBOS[combo]
    cfg = TC.get_reduced(name)
    key = f"oneshot/{combo}/{name}"
    ranks = ranks_of(got, combo)
    for res in ranks:                   # each rank's rows and KV heads
        d, m = res["coord"]
        rows = slice(d * W.SLOTS // D, (d + 1) * W.SLOTS // D)
        h0, nh = Sh.kv_head_block(cfg.n_heads, cfg.n_kv_heads, Mw, m)
        for c in ("k", "v") + (("ck", "cv") if cfg.is_encdec else ()):
            np.testing.assert_allclose(
                res[f"{key}/{c}"], want[f"{key}/{c}"][:, rows, h0:h0 + nh],
                rtol=LOGIT_TOL, atol=LOGIT_TOL)
    check_logits(ranks, want, [f"{key}/logits/{j}" for j in range(W.G)],
                 W.SLOTS)


@pytest.mark.parametrize("combo", list(W.COMBOS))
def test_mamba_prefill_and_decode_match_reference(runs, combo):
    """Reduced ``falcon-mamba-7b`` through ``make_prefill`` and greedy
    ``make_serve_step`` (two rows a data rank, E / M channels a model
    rank) against the reference at the same mesh: logits within
    ``LOGIT_TOL``, greedy tokens by the module's rule, every rank's
    logits the same bits, each rank's conv and ssm states its rows and
    channels of the reference's, within ``MAMBA_STATE_TOL`` of their
    largest."""
    _, want, got = runs
    D, Mw, _ = W.COMBOS[combo]
    cfg = TC.get_reduced(W.MAMBA)
    key = f"mamba/{combo}"
    ranks = ranks_of(got, combo)
    E = cfg.d_inner // Mw
    for res in ranks:
        d, m = res["coord"]
        rows = slice(d * W.SLOTS // D, (d + 1) * W.SLOTS // D)
        chans = slice(m * E, (m + 1) * E)
        for c, idx in (("conv", (slice(None), rows, slice(None), chans)),
                       ("ssm", (slice(None), rows, chans))):
            whole = want[f"{key}/{c}"]
            assert res[f"{key}/{c}"].shape == whole[idx].shape, c
            err = float(np.abs(res[f"{key}/{c}"] - whole[idx]).max())
            assert err <= MAMBA_STATE_TOL * float(np.abs(whole).max()), \
                (c, d, m, err)
    check_logits(ranks, want, [f"{key}/logits/{j}" for j in range(W.G)],
                 W.SLOTS)


@pytest.mark.parametrize("combo", W.JAMBA_COMBOS)
def test_jamba_prefill_and_decode_match_reference(runs, combo):
    """Reduced ``jamba-1.5-large-398b`` (period stacks) through
    ``make_prefill`` and greedy ``make_serve_step`` against the reference
    at the same mesh, as the Mamba stack: each rank's Mamba sub-layers'
    conv and ssm states its rows and channels of the reference's, its
    attention sub-layer's k / v its rows and KV heads, each within the
    module's tolerances; logits and tokens by its rule, but a row with a
    near tie of a MoE router (here the last token of row 3, at a gap of
    2.4e-5, routes to other experts in the two packages and moves its
    logits by 0.021) by the token rule alone."""
    weights, want, got = runs
    D, Mw, _ = W.COMBOS[combo]
    cfg = TC.get_reduced(W.JAMBA)
    key = f"jamba/{combo}"
    ranks = ranks_of(got, combo)
    E = cfg.d_inner // Mw
    struct = TM.cache_struct(cfg, 1, 1)
    for res in ranks:
        d, m = res["coord"]
        rows = slice(d * W.SLOTS // D, (d + 1) * W.SLOTS // D)
        chans = slice(m * E, (m + 1) * E)
        h0, nh = Sh.kv_head_block(cfg.n_heads, cfg.n_kv_heads, Mw, m)
        for j, sub in struct.items():
            for c in sub:
                idx = {"conv": (slice(None), rows, slice(None), chans),
                       "ssm": (slice(None), rows, chans)}.get(
                    c, (slice(None), rows, slice(h0, h0 + nh)))
                whole = want[f"{key}/{j}/{c}"]
                mine = res[f"{key}/{j}/{c}"]
                assert mine.shape == whole[idx].shape, (j, c)
                if c in ("k", "v"):
                    np.testing.assert_allclose(mine, whole[idx],
                                               rtol=LOGIT_TOL,
                                               atol=LOGIT_TOL)
                    continue
                err = float(np.abs(mine - whole[idx]).max())
                assert err <= MAMBA_STATE_TOL * float(np.abs(whole).max()), \
                    (j, c, d, m, err)
    check_logits(ranks, want, [f"{key}/logits/{j}" for j in range(W.G)],
                 W.SLOTS, near_tie_rows(weights, cfg, W.mamba_prompts(cfg)))


def test_jamba_engine_matches_world1_engine(runs):
    """The port's engine on reduced Jamba at ``2x2`` against its world-1
    engine on the same requests, as the Mamba engine; every rank's
    tokens equal."""
    weights, _, got = runs
    want = W.TPW.world1_engine(weights, W.JAMBA, W.ENGINE_KW)
    ranks = ranks_of(got, "2x2")
    for res in ranks:
        W.TPW.compare_engine_to_world1(
            res, "jamba_engine", want, TC.get_reduced(W.JAMBA), 2,
            W.SLOTS // 2, 2 * LOGIT_TOL)
        for rid in range(len(W.SHAPES)):
            np.testing.assert_array_equal(
                res[f"jamba_engine/{rid}/tokens"],
                ranks[0][f"jamba_engine/{rid}/tokens"])


def test_mamba_engine_matches_world1_engine(runs):
    """The port's Mamba engine at ``2x2`` (two slots a data rank, E / 2
    channels a model rank) against its world-1 engine on the same
    requests, by ``tests/test_torch_tp.py``'s rule; every rank's tokens
    equal."""
    weights, _, got = runs
    want = W.TPW.world1_engine(weights, W.MAMBA, W.ENGINE_KW)
    ranks = ranks_of(got, "2x2")
    for res in ranks:
        W.TPW.compare_engine_to_world1(
            res, "mamba_engine", want, TC.get_reduced(W.MAMBA), 2,
            W.SLOTS // 2, 2 * LOGIT_TOL)
        for rid in range(len(W.SHAPES)):
            np.testing.assert_array_equal(
                res[f"mamba_engine/{rid}/tokens"],
                ranks[0][f"mamba_engine/{rid}/tokens"])


@pytest.mark.parametrize("prefix", [f"engine/{c}" for c in W.COMBOS]
                         + ["engine3"])
def test_engine_matches_reference_engine(runs, prefix):
    _, want, got = runs
    ranks = ranks_of(got, "2x2" if prefix == "engine3" else prefix[7:])
    res = ranks[0]
    np.testing.assert_array_equal(res[f"{prefix}/rejected"],
                                  want[f"{prefix}/rejected"])
    np.testing.assert_array_equal(res[f"{prefix}/counts"],
                                  want[f"{prefix}/counts"])
    submitted, completed, rejected, misses = res[f"{prefix}/counts"][:4]
    assert submitted == completed + rejected + misses
    assert int(res[f"{prefix}/store_dropped"]) == 0
    # 4 slots split over the two data ranks; 3 stay whole on each
    assert int(res[f"{prefix}/cache_rows"]) == \
        (3 if prefix == "engine3" else W.SLOTS // 2)
    compared = 0
    for rid in range(len(W.SHAPES)):
        assert str(res[f"{prefix}/{rid}/status"]) == \
            str(want[f"{prefix}/{rid}/status"])
        np.testing.assert_array_equal(res[f"{prefix}/{rid}/d0"],
                                      want[f"{prefix}/{rid}/d0"])
        toks, jtoks = res[f"{prefix}/{rid}/tokens"], \
            want[f"{prefix}/{rid}/tokens"]
        assert len(toks) == len(jtoks)
        for other in ranks[1:]:
            np.testing.assert_array_equal(other[f"{prefix}/{rid}/tokens"],
                                          toks)
        if rid == 3:
            assert str(res[f"{prefix}/{rid}/status"]) == "feature_miss"
            continue
        margins = res[f"{prefix}/{rid}/margins"]
        assert len(margins) == len(toks)
        compared += greedy_agree(toks, jtoks, margins, 2 * LOGIT_TOL)[0]
    assert compared >= 1


def test_moe_decode_drops_match_reference(runs):
    _, want, got = runs
    assert want["moe/dropped"].sum() > 0, want["moe/dropped"]
    ranks = ranks_of(got, "2x2")
    clean = 0
    for res in ranks:
        d, m = res["coord"]
        ids = res["moe/ids"]
        # the ranks of a data row sum their experts' rows: the same bits
        for other in ranks:
            if other["coord"][0] == d:
                np.testing.assert_array_equal(other["moe/y"], res["moe/y"])
        if not np.array_equal(ids, want["moe/ids"][d]):
            continue
        clean += 1
        assert int(res["moe/dropped"]) == want["moe/dropped"][d, m], \
            (d, m, int(res["moe/dropped"]), want["moe/dropped"])
        close(res["moe/y"], want["moe/y"][d * 4:(d + 1) * 4], BF16_TOL)
    assert clean >= 1, "no rank routed like the reference"


def test_each_rank_holds_its_2d_slices(runs):
    weights, _, got = runs
    from repro_torch.launch import mesh as Me
    tree = W.TPW.unflatten(weights, f"lm/{W.ENGINE}")
    sizes = {"data": 2, "model": 2}
    policy = Sh.make_policy(Me.abstract_mesh(sizes), "fsdp_tp")
    specs = policy.param_specs(tree)
    ranks = ranks_of(got, "2x2")
    total = np.zeros(len(ranks), np.int64)
    both = 0
    for leaf in (k for k in ranks[0] if k.startswith("mem/leaf/")):
        names = leaf[len("mem/leaf/"):].split("/")
        full, spec = tree, specs
        for n in names:
            full, spec = full[n], spec[n]
        size = 2 if TM._is_matmul_weight(
            names[-2] if len(names) > 1 else "", names[-1], full.ndim) else 4
        per_rank = np.array([int(r[leaf]) for r in ranks])
        for i, res in enumerate(ranks):
            coord = dict(zip(("data", "model"), res["coord"]))
            idx = Sh.shard_slices(full.shape, spec, sizes, coord)
            assert per_rank[i] == full[idx].size * size, (leaf, coord)
        if "data" in spec and "model" in spec:
            both += 1
            assert per_rank.sum() == full.size * size, leaf
        total += per_rank
    assert both >= 4
    np.testing.assert_array_equal([int(r["mem/rank_bytes"]) for r in ranks],
                                  total)


def run_serve_cli(mesh):
    env = {k: v for k, v in os.environ.items() if not k.startswith("REPRO_")}
    env["PYTHONPATH"] = SRC
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         "granite-moe-3b-a800m", "--reduced", "--device", "cpu",
         "--requests", "6", "--slots", "4", "--prompt-len", "8", "--gen",
         "4", "--mesh", mesh], env=env, capture_output=True,
        text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    assert proc.stdout.count("serve OK") == 1      # rank 0 prints
    assert str(Me.parse_mesh(mesh)) in proc.stdout


def test_serve_cli_at_data2_model2_on_the_cpu():
    run_serve_cli("data=2,model=2")


def test_serve_cli_at_pod2_data2_on_the_cpu():
    """Four rank processes: the slots over pod x data, the weights cut
    over data and whole over pod."""
    run_serve_cli("pod=2,data=2,model=1")


@pytest.mark.parametrize("flavor", ["tp", "fsdp_tp"])
def test_adamw_in_place_with_zero1_matches_before(runs, flavor):
    """Three in-place AdamW steps with ``Zero1`` at ``2x2`` give every
    rank the bits of the update that made new tensors, and keep each
    tensor's storage (``tests/test_torch_adamw.py`` at world 1)."""
    _, _, got = runs
    for res in ranks_of(got, "2x2"):
        same, kept = res[f"adamw/{flavor}"]
        assert same and kept, (res["coord"], same, kept)
