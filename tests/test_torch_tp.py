"""The port's sharded serving path at world 2 against the JAX package at
world 2 (``tests/dist/torch_tp_conformance.py``).

Two gloo processes meet through a ``file://`` store under ``tmp_path``
with a 120 s timeout on the process group; the JAX reference runs in its
own subprocess with two forced host devices and a ``(data=1, model=2)``
mesh under ``make_policy(mesh, "fsdp_tp")``.  Every process is killed
past ``LIMIT_S``.  Both sides start from the reference's
``init_params(PRNGKey(0))`` / ``moe_init`` weights, which this module
writes.

* ``moe_shuffle`` and ``moe_decode`` on reduced ``granite-moe-3b-a800m``
  and ``qwen3-moe-235b-a22b``, at a capacity factor where no row drops
  (``E / top_k`` for the shuffle), at the default (1.25 for the shuffle,
  4 for decode) and at 0.5, where rows drop, and ``moe_shuffle`` on 15
  tokens, which do not split over the ranks (both fall back to
  ``moe_dense``; the port on each rank's experts): where a rank's shard routes every row to
  the same experts in both packages (both compute float32 router
  products in other orders, so a near tie may flip; a flipped row
  reorders its experts' ranks), its dropped rows equal the reference's
  ``~ok`` count and its tokens' outputs are within ``BF16_TOL`` (rtol,
  and atol of ``BF16_TOL`` times the largest magnitude: bf16 expert
  products summed in other orders, as ``tests/test_torch_moe.py``); at
  least one shard of each case must route identically; in decode,
  every token whose rows keep their places in their experts' order
  (:func:`same_places`) is compared, and one must; ``aux`` within
  ``ROUTE_TOL`` relative where every id agrees; the ranks' outputs equal
  bit for bit.
* ``make_prefill`` + greedy ``make_serve_step`` on reduced
  ``granite-3-2b``, ``granite-moe-3b-a800m``, ``granite-3-2b`` with
  one KV head (each rank holds the KV head its q heads read),
  ``falcon-mamba-7b`` (each rank its half of the channels E),
  ``seamless-m4t-large-v2`` (frames through the encoder; the
  cross-attention's ``ck``/``cv`` cached too) and ``internvl2-2b``
  (patch embeddings in front, decode from P + S) and
  ``jamba-1.5-large-398b`` (a period stack: each Mamba sub-layer on its
  channels, the attention sub-layer on its heads, each MoE sub-layer
  dispatched; its caches under each ``sub{j}``): logits and
  the gathered prefill caches within ``LOGIT_TOL`` (the tolerance of
  ``tests/test_torch_model.py`` at world 1; measured at most 3.2e-3 here)
  or, for the Mamba conv and ssm states, within ``MAMBA_STATE_TOL`` of
  their largest, greedy tokens by that module's rule, the ranks' logits
  equal bit for bit.  Each rank's caches hold its KV heads
  (``kv_head_block``) or its E / 2 channels.
* The port's Mamba engine and its Jamba engine at world 2 against its
  world-1 engine on the same requests (the reference's engine runs a
  Mamba state through a prompt's padding, ROADMAP Queue 3 item 3).
* Both engines with their policy and a feature store over both ranks on
  the same requests (reduced ``granite-moe-3b-a800m``): the same
  rejections, counts, statuses and features, greedy tokens equal up to
  the first margin below ``2 * LOGIT_TOL`` (the margins are the port's,
  as ``tests/test_torch_serving.py``), both ranks' tokens equal.
* The feature-store cases of ``tests/dist/serving_conformance.py`` at
  world 2, against numpy.
* Each rank holds only its shards: its parameter bytes are the sum of
  its leaves', each leaf the size of its slice under the spec table, and
  a sharded leaf's slices sum over the ranks to the whole leaf.
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
WORKER_PATH = os.path.join(HERE, "dist", "torch_tp_conformance.py")
SRC = os.path.join(os.path.dirname(HERE), "src")
WORLD = 2
LIMIT_S = 600
LOGIT_TOL = 2e-2
BF16_TOL = 2e-2
MAMBA_STATE_TOL = 2e-2
ROUTE_TOL = 1e-5

_spec = importlib.util.spec_from_file_location("torch_tp_conformance",
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
    for name in W.MODELS:
        cfg = W.config(JC.get_reduced, name)
        _flatten(JM.init_params(jax.random.PRNGKey(0), cfg), f"lm/{name}",
                 flat)
    for i, arch in enumerate(W.MOE_LAYERS):
        _flatten(JMoe.moe_init(jax.random.PRNGKey(10 + i),
                               JC.get_reduced(arch)), f"moe/{arch}", flat)
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
    """(weights, JAX results, port results) of one run of the worker on
    each side."""
    tmp = tmp_path_factory.mktemp("tp")
    weights = write_weights(tmp / "weights.npz")
    want_path, got_path = tmp / "jax.npz", tmp / "torch.npz"
    procs = [(_start(["jax", str(WORLD), str(want_path),
                      str(tmp / "weights.npz")],
                     {"XLA_FLAGS": "--xla_force_host_platform_device_count="
                      f"{WORLD}", "JAX_PLATFORMS": "cpu"}), "jax reference")]
    procs += [(_start(["torch", str(WORLD), str(got_path),
                       str(tmp / "weights.npz"), str(rank),
                       str(tmp / "store")]), f"torch rank {rank}")
              for rank in range(WORLD)]
    try:
        for proc, what in procs:
            _finish(proc, what)
    finally:
        for proc, _ in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return weights, dict(np.load(want_path)), dict(np.load(got_path))


def close(got, want, tol):
    np.testing.assert_allclose(got, want, rtol=tol,
                               atol=tol * float(np.abs(want).max()))


def same_places(ids, jids):
    """(B, S) mask of the tokens whose k rows go to the same experts in
    both packages at the same place in each expert's stable order (the
    count of earlier rows, in (b, s, k) order, routed to that expert):
    a decode capacity keeps or drops these rows alike, whatever other
    tokens' near ties did."""
    def places(a):
        flat, seen = a.reshape(-1), {}
        out = np.empty_like(flat)
        for i, e in enumerate(flat):
            out[i] = seen.get(e, 0)
            seen[e] = out[i] + 1
        return out.reshape(a.shape)
    return ((ids == jids) & (places(ids) == places(jids))).all(-1)


@pytest.mark.parametrize("path,cf", [(p, cf) for p, cfs in
                                     W.MOE_PATHS.items() for cf in cfs])
@pytest.mark.parametrize("arch", W.MOE_LAYERS)
def test_moe_dispatch_matches_reference(runs, arch, path, cf):
    _, want, got = runs
    key = f"moe/{arch}/{path}/{cf}"
    for r in range(1, WORLD):           # replicated output: equal bits
        np.testing.assert_array_equal(got[f"{key}/y_ranks"][r],
                                      got[f"{key}/y_ranks"][0])
    ids, jids = got[f"{key}/ids"], want[f"{key}/ids"]
    y, jy = got[f"{key}/y"], want[f"{key}/y"]
    dropped, jdropped = got[f"{key}/dropped"], want[f"{key}/dropped"]
    if cf == W.MOE_PATHS[path][0]:
        assert jdropped.sum() == 0, jdropped
    if cf == 0.5:
        assert jdropped.sum() > 0, jdropped
    S = ids.shape[1]
    s = S // WORLD if path == "shuffle" else S
    clean = 0
    for r in range(WORLD):
        # a shuffle rank routes its own slice; decode ranks share all rows
        cols = slice(r * s, (r + 1) * s) if path == "shuffle" \
            else slice(None)
        if not np.array_equal(ids[:, cols], jids[:, cols]):
            continue
        clean += 1
        assert dropped[r] == jdropped[r], (r, dropped, jdropped)
        if path == "shuffle":
            close(y[:, cols], jy[:, cols], BF16_TOL)
    assert clean >= 1, "no rank routed like the reference"
    if path == "decode":
        # a decode step's rows are on every rank: compare each token whose
        # rows keep their places, whether or not another token flipped
        kept = same_places(ids, jids)
        assert kept.any(), "no token routed like the reference"
        close(y[kept], jy[kept], BF16_TOL)
    if np.array_equal(ids, jids):
        close(y, jy, BF16_TOL)
        aux, jaux = float(got[f"{key}/aux"]), float(want[f"{key}/aux"])
        assert abs(aux - jaux) <= ROUTE_TOL * abs(jaux), (aux, jaux)


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


# the channel dim of a Mamba stack's caches: conv (L, B, K-1, E), ssm
# (L, B, E, N)
CHANNEL_DIM = {"conv": 3, "ssm": 2}


def check_mamba_caches(got, want, key, cfg):
    """Each rank's conv and ssm caches hold its E / WORLD channels, and
    put together in rank order they are within ``MAMBA_STATE_TOL`` of
    the reference's largest magnitude (``tests/test_torch_mamba.py``'s
    rule)."""
    for c, dim in CHANNEL_DIM.items():
        per, whole = got[f"{key}/{c}_ranks"], want[f"{key}/{c}"]
        for r in range(WORLD):
            assert per[r].shape[dim] == cfg.d_inner // WORLD, (c, r)
        mine = np.concatenate(list(per), axis=dim)
        assert mine.shape == whole.shape, (c, mine.shape, whole.shape)
        err = float(np.abs(mine - whole).max())
        assert err <= MAMBA_STATE_TOL * float(np.abs(whole).max()), (c, err)


def check_kv_caches(got, want, key, cfg, names):
    """Each rank's caches ``names`` hold its KV heads (``kv_head_block``)
    within LOGIT_TOL of the reference's."""
    for c in names:
        for r, kv in enumerate(got[f"{key}/{c}_ranks"]):
            h0, nh = Sh.kv_head_block(cfg.n_heads, cfg.n_kv_heads, WORLD, r)
            np.testing.assert_allclose(
                kv, want[f"{key}/{c}"][:, :, h0:h0 + nh],
                rtol=LOGIT_TOL, atol=LOGIT_TOL)


@pytest.mark.parametrize("name", list(W.MODELS))
def test_prefill_and_decode_match_reference(runs, name):
    _, want, got = runs
    key = f"lm/{name}"
    cfg = W.config(TC.get_reduced, name)
    if cfg.attn_period > 1:            # each sub-layer's own caches
        struct = TM.cache_struct(cfg, 1, 1)
        assert len(struct) == cfg.attn_period
        for j, sub in struct.items():
            if "ssm" in sub:
                check_mamba_caches(got, want, f"{key}/{j}", cfg)
            else:
                check_kv_caches(got, want, f"{key}/{j}", cfg, ("k", "v"))
    elif TM.has_mamba(cfg):
        check_mamba_caches(got, want, key, cfg)
    else:
        check_kv_caches(got, want, key, cfg, ("k", "v") + (
            ("ck", "cv") if cfg.is_encdec else ()))
    steps = range(W.G)
    lg = np.stack([got[f"{key}/logits/{i}"] for i in steps], 1)
    jl = np.stack([want[f"{key}/logits/{i}"] for i in steps], 1)
    for i in steps:
        ranks = got[f"{key}/logits_ranks/{i}"]
        for r in range(1, WORLD):
            np.testing.assert_array_equal(ranks[r], ranks[0])
    top = np.sort(jl, -1)
    margins = top[..., -1] - top[..., -2]
    diffs = np.abs(lg - jl).max(-1)
    for b in range(lg.shape[0]):
        n, same = greedy_agree(lg[b].argmax(-1), jl[b].argmax(-1),
                               margins[b], 2 * diffs[b])
        assert n >= 1 and diffs[b, :same + 1].max() <= LOGIT_TOL


def test_engine_matches_reference_engine(runs):
    _, want, got = runs
    t, j = "engine/torch", "engine/jax"
    np.testing.assert_array_equal(got[f"{t}/rejected"], want[f"{j}/rejected"])
    np.testing.assert_array_equal(got[f"{t}/counts"], want[f"{j}/counts"])
    submitted, completed, rejected, misses = got[f"{t}/counts"][:4]
    assert submitted == completed + rejected + misses
    assert int(got[f"{t}/store_dropped"]) == 0
    compared = 0
    for rid in range(len(W.SHAPES)):
        assert str(got[f"{t}/{rid}/status"]) == str(want[f"{j}/{rid}/status"])
        np.testing.assert_array_equal(got[f"{t}/{rid}/d0"],
                                      want[f"{j}/{rid}/d0"])
        toks, jtoks = got[f"{t}/{rid}/tokens"], want[f"{j}/{rid}/tokens"]
        assert len(toks) == len(jtoks)
        if rid == 3:
            assert str(got[f"{t}/{rid}/status"]) == "feature_miss"
            continue
        margins = got[f"{t}/{rid}/margins"]
        assert len(margins) == len(toks)
        compared += greedy_agree(toks, jtoks, margins, 2 * LOGIT_TOL)[0]
    assert compared >= 1
    ranks = got[f"{t}/tokens_ranks"]
    for r in range(1, WORLD):
        np.testing.assert_array_equal(ranks[r], ranks[0])


def test_mamba_engine_matches_world1_engine(runs):
    """The port's Mamba engine at world 2 against its world-1 engine on
    the same requests (which ``tests/test_torch_model.py`` holds to the
    reference's prefill at the true length): the same rejections, counts,
    statuses and features, greedy tokens equal up to the first margin
    below ``2 * LOGIT_TOL`` (world 1's margins), both ranks' tokens equal,
    each rank's caches of its slots and E / 2 channels."""
    weights, _, got = runs
    want = W.world1_engine(weights, W.MAMBA_ENGINE, W.ENGINE_KW)
    W.compare_engine_to_world1(got, "mamba_engine/torch", want,
                               TC.get_reduced(W.MAMBA_ENGINE), WORLD,
                               W.ENGINE_KW["slots"], 2 * LOGIT_TOL)
    ranks = got["mamba_engine/torch/tokens_ranks"]
    for r in range(1, WORLD):
        np.testing.assert_array_equal(ranks[r], ranks[0])


def test_jamba_engine_matches_world1_engine(runs):
    """The port's engine on reduced Jamba (period stacks) at world 2
    against its world-1 engine on the same requests, as the Mamba
    engine: its Mamba sub-layers' caches hold the rank's E / 2 channels
    over the periods."""
    weights, _, got = runs
    want = W.world1_engine(weights, W.JAMBA_ENGINE, W.ENGINE_KW)
    W.compare_engine_to_world1(got, "jamba_engine/torch", want,
                               TC.get_reduced(W.JAMBA_ENGINE), WORLD,
                               W.ENGINE_KW["slots"], 2 * LOGIT_TOL)
    ranks = got["jamba_engine/torch/tokens_ranks"]
    for r in range(1, WORLD):
        np.testing.assert_array_equal(ranks[r], ranks[0])


def test_feature_store_conformance_world2(runs):
    """``tests/dist/serving_conformance.py``'s cases on the port's stores
    over two ranks, against numpy gathers."""
    _, _, got = runs
    table, probe = W.feature_table()
    n = len(table["k"])
    by_key = {c: table[c][np.argsort(table["k"])] for c in ("f0", "f1",
                                                            "f2")}
    present = (probe >= 0) & (probe < n)
    assert int(got["fs/ingest_dropped"]) == 0
    np.testing.assert_array_equal(got["fs/mixed/found"], present)
    for c in ("f0", "f1", "f2"):
        expect = np.where(present, by_key[c][np.clip(probe, 0, n - 1)], 0)
        np.testing.assert_array_equal(got[f"fs/mixed/{c}"], expect)
    hot = int(table["k"][0])
    assert got["fs/hot/found"].all()
    np.testing.assert_array_equal(
        got["fs/hot/f0"], np.full(len(got["fs/hot/f0"]), by_key["f0"][hot]))
    assert got["fs/dup/found"].all()
    np.testing.assert_array_equal(got["fs/dup/f2"],
                                  by_key["f2"][[5, 5, 7, 5]])
    np.testing.assert_array_equal(got["fs/contains"], present)
    assert int(got["fs/dropped"]) == 0


def test_each_rank_holds_only_its_shards(runs):
    weights, _, got = runs
    tree = W.unflatten(weights, f"lm/{W.ENGINE}")
    policy = Sh.make_policy(Me.abstract_mesh({"data": 1, "model": WORLD}),
                            "fsdp_tp")
    specs = policy.param_specs(tree)
    rank_bytes = got["mem/rank_bytes"]
    total = np.zeros(WORLD, np.int64)
    for leaf in (k for k in got if k.startswith("mem/leaf/")):
        names = leaf[len("mem/leaf/"):].split("/")
        full, spec = tree, specs
        for n in names:
            full, spec = full[n], spec[n]
        size = 2 if TM._is_matmul_weight(
            names[-2] if len(names) > 1 else "", names[-1], full.ndim) else 4
        per_rank = got[leaf]
        for r in range(WORLD):
            idx = Sh.shard_slices(full.shape, spec, {"data": 1,
                                                     "model": WORLD},
                                  {"data": 0, "model": r})
            assert per_rank[r] == full[idx].size * size, (leaf, r)
        if "model" in spec:
            assert per_rank.sum() == full.size * size, leaf
        else:
            assert (per_rank == full.size * size).all(), leaf
        total += per_rank
    np.testing.assert_array_equal(rank_bytes, total)
    unsharded = sum(v.size * (2 if TM._is_matmul_weight(
        k.split("/")[-2], k.split("/")[-1], v.ndim) else 4)
        for k, v in weights.items() if k.startswith(f"lm/{W.ENGINE}/"))
    assert rank_bytes.max() < unsharded
