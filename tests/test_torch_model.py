"""The port's LM stack against the JAX package: the reference's
``init_params(PRNGKey(0))`` weights carried across by ``params_from_jax``
on reduced ``granite-3-2b``, ``lm100m`` and ``falcon-mamba-7b``, then
``make_prefill``, ``make_slot_prefill`` and ``make_serve_step`` (scalar
and per-slot ``cache_len``) on the same numpy tokens, on reduced
``granite-moe-3b-a800m`` (MoE layers: 8 experts, top-2),
``seamless-m4t-large-v2`` (an encoder over numpy-seeded float frames,
P / 4 of them, and a decoder with cross-attention, whose ``ck``/``cv``
caches are compared like the KV caches), ``internvl2-2b`` (16
numpy-seeded float patch embeddings in front of the tokens: its caches
hold P + S + G positions and its first decode step is at P + S) and
``jamba-1.5-large-398b``'s period stacks (reduced: 4 layers in periods
of 2, (Mamba, MLP) then (attention, MoE); ``JAMBA8``: 8 layers in
periods of 4, which adds the (Mamba, MoE) kind; parameters and caches
under ``sub{j}``, compared leaf by leaf) too, and the configs' analytic
sizes.

Tolerance: logits within ``LOGIT_TOL = 2e-2`` absolute and KV caches
within 2e-2 (rtol and atol); a Mamba stack's conv and ssm states within
2e-2 of the state's largest magnitude (the ssm state of these random
weights is of order 1e-7).  A Mamba stack's slot prefill is held to the
reference's ``make_prefill`` at the prompt's true length, not to the
reference's slot prefill, whose state runs on through the padding.  Both packages compute in bf16 with float32 sums,
but XLA and PyTorch's CPU kernels sum bf16 dots in different orders and
round them back to bf16 at different places, so an activation may differ
by one bf16 ulp (2^-8 relative) and the logits (magnitude about 2) by a
few thousandths after two layers (measured: at most 5e-3).  Greedy
tokens are compared up to the first position where the two packages'
tokens differ (their contexts are the same until there): wherever the
reference's top-2 logit margin is above twice the largest difference of
the two packages' logits there (itself within ``LOGIT_TOL``) the tokens
must be equal, as the argmax is the same in both; at a smaller margin a
difference within the tolerance could swap the two, so a difference
there ends the comparison.  At least one token of each sequence must be
compared.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro import configs as JC
from repro.models import model as JM
from repro_torch import configs as TC
from repro_torch.models import model as TM
from repro_torch.models import transformer as TT

LOGIT_TOL = 2e-2
DENSE = ("granite-3-2b", "lm100m")
JAMBA = "jamba-1.5-large-398b"
JAMBA8 = JAMBA + "/8"         # 8 layers in two periods of 4
ARCHS = DENSE + ("falcon-mamba-7b", "granite-moe-3b-a800m",
                 "seamless-m4t-large-v2", "internvl2-2b", JAMBA, JAMBA8)
P, G = 16, 6                      # prompt length and tokens generated


def reduced(get, arch):
    """``get(arch)`` (a package's ``get_reduced``), and for ``JAMBA8``
    reduced Jamba at 8 layers in periods of 4."""
    name, _, layers = arch.partition("/")
    cfg = get(name)
    return dataclasses.replace(cfg, n_layers=8, attn_period=4) if layers \
        else cfg


def margin(logits: np.ndarray) -> np.ndarray:
    top = np.sort(logits, axis=-1)
    return top[..., -1] - top[..., -2]


def greedy_agree(got, want, want_margins, tol) -> tuple[int, int]:
    """(tokens compared, the first position whose tokens differ or the
    length): up to that position every token whose margin is above
    ``tol`` (a number, or one per position) is compared and must be
    equal; a difference at a margin not above it ends the comparison."""
    n = 0
    for i, (g, w, m, t) in enumerate(zip(got, want, want_margins,
                                         np.broadcast_to(tol, len(got)))):
        if m > t:
            assert g == w, f"token {i}: {g} != {w} at margin {m}"
            n += 1
        elif g != w:
            return n, i
    return n, len(got)


def close(got, want, tol=LOGIT_TOL):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(jnp.asarray(want, jnp.float32)),
                               rtol=tol, atol=tol)


def close_caches(got, want):
    """Every cache leaf of ``want`` in ``got``, same shape and dtype, a
    period stack's ``sub{j}`` levels walked through: KV caches within
    LOGIT_TOL, Mamba states within LOGIT_TOL of the leaf's largest
    magnitude."""
    assert set(got) == set(want)
    for k, w in want.items():
        if isinstance(w, dict):
            close_caches(got[k], w)
            continue
        w = np.asarray(jnp.asarray(w, jnp.float32))
        assert tuple(got[k].shape) == w.shape, k
        if k in ("k", "v", "ck", "cv"):
            assert got[k].dtype == torch.bfloat16
            close(got[k], w)
        else:
            assert got[k].dtype == torch.float32
            np.testing.assert_allclose(
                got[k].numpy(), w, rtol=0,
                atol=LOGIT_TOL * float(np.abs(w).max()))


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    """(reference cfg, reference params, port cfg, port params, the
    reference's jitted prefill and serve step, shared by the tests so each
    compiles once per shape)."""
    arch = request.param
    cfg = reduced(JC.get_reduced, arch)
    jp = JM.init_params(jax.random.PRNGKey(0), cfg)
    tcfg = reduced(TC.get_reduced, arch)
    tp = TM.params_from_jax(jax.tree_util.tree_map(np.asarray, jp), tcfg,
                            "cpu")
    return (cfg, jp, tcfg, tp,
            jax.jit(JM.make_prefill(cfg, None, decode_len=cap(cfg))),
            jax.jit(JM.make_serve_step(cfg, None)))


def tokens(cfg, shape, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab, shape).astype(np.int32)


def prefix(cfg) -> int:
    """The positions a vision config puts in front of the tokens."""
    return cfg.frontend_tokens if cfg.frontend == "vision" else 0


def cap(cfg) -> int:
    """The caches' positions: the prefix, the prompt and the tokens
    generated."""
    return prefix(cfg) + P + G


def batch(cfg, toks, seed=0):
    """``toks`` with the config's float inputs, drawn by numpy: an
    enc-dec config's frames (one per ``enc_len_ratio`` tokens of P), a
    vision config's patch embeddings.  Returns (the JAX batch, the
    port's)."""
    b = {"tokens": toks}
    rng = np.random.default_rng(100 + seed)
    B = toks.shape[0]
    if cfg.is_encdec:
        b["frames"] = rng.normal(size=(B, P // cfg.enc_len_ratio,
                                       cfg.d_model)).astype(np.float32)
    if cfg.frontend == "vision":
        b["patch_embeds"] = rng.normal(size=(B, cfg.frontend_tokens,
                                             cfg.d_model)).astype(np.float32)
    return ({k: jnp.asarray(v) for k, v in b.items()},
            {k: torch.from_numpy(v) for k, v in b.items()})


def test_params_from_jax(pair):
    cfg, jp, tcfg, tp, jprefill, jserve = pair
    flat_j = jax.tree_util.tree_flatten_with_path(jp)[0]
    for path, leaf in flat_j:
        names = [k.key for k in path]
        node = tp
        for n in names:
            node = node[n]
        assert tuple(node.shape) == leaf.shape, names
        # bf16 as the reference casts them at use; dt_proj.w and the MoE
        # router stay float32
        if names[-1] in ("embed", "e_gate", "e_up", "e_down") \
                or (names[-1] == "w" and names[-2] != "dt_proj"):
            assert node.dtype == torch.bfloat16, names
            want = np.asarray(leaf.astype(jnp.bfloat16).astype(jnp.float32))
        else:
            assert node.dtype == torch.float32, names
            want = np.asarray(leaf)
        np.testing.assert_array_equal(node.float().numpy(), want)


def test_prefill_matches_jax(pair):
    cfg, jp, tcfg, tp, jprefill, jserve = pair
    jb, tb = batch(cfg, tokens(cfg, (3, P)))
    jl, jc = jprefill(jp, jb)
    tl, tc = TM.make_prefill(tcfg, decode_len=cap(cfg))(tp, tb)
    close(tl, jl)
    close_caches(tc, jc)
    struct = TM.cache_struct(tcfg, 3, cap(cfg),
                             P // cfg.enc_len_ratio if cfg.is_encdec else 0)
    assert shapes(tc) == shapes(struct)
    assert shapes(tc) == jax.tree_util.tree_map(
        lambda s: s.shape, JM.cache_struct(
            cfg, 3, cap(cfg), P // cfg.enc_len_ratio if cfg.is_encdec
            else 0))


def shapes(tree):
    """The shapes of a cache tree, or of ``cache_struct``'s (shape,
    dtype) pairs."""
    return {k: shapes(v) if isinstance(v, dict)
            else tuple(v[0] if isinstance(v, tuple) else v.shape)
            for k, v in tree.items()}


def ssm_leaves(tree):
    """The Mamba ssm states of a cache tree (a period stack's under each
    ``sub{j}``), as float32 numpy."""
    if "ssm" in tree:
        return [np.asarray(jnp.asarray(tree["ssm"], jnp.float32))
                if not isinstance(tree["ssm"], torch.Tensor)
                else tree["ssm"].numpy()]
    return [a for v in tree.values() if isinstance(v, dict)
            for a in ssm_leaves(v)]


def test_slot_prefill_matches_jax(pair):
    cfg, jp, tcfg, tp, jprefill, jserve = pair
    length = 9
    toks = np.zeros((1, P), np.int32)
    toks[0, :length] = tokens(cfg, length, seed=1)
    jb, tb = batch(cfg, toks, seed=1)
    jl, jc = jax.jit(JM.make_slot_prefill(cfg, None, decode_len=cap(cfg)))(
        jp, jb, jnp.int32(length))
    tl, tc = TM.make_slot_prefill(tcfg, decode_len=cap(cfg))(tp, tb, length)
    close(tl, jl)
    if TM.has_mamba(tcfg):
        # the reference's state at the true length; its slot prefill's
        # state ran on through the padding and is not the prompt's
        _, jtrue = jprefill(jp, {"tokens": jnp.asarray(toks[:, :length])})
        close_caches(tc, jtrue)
        # (the first Mamba layer's state differs from the padded one)
        got, padded = ssm_leaves(tc)[0], ssm_leaves(jc)[0]
        assert np.abs(got - padded).max() > LOGIT_TOL * np.abs(padded).max()
    else:
        close_caches(tc, jc)
    # the slot's logits are the unpadded prompt's last-position logits
    ul, _ = TM.make_prefill(tcfg, decode_len=cap(cfg))(
        tp, dict(tb, tokens=tb["tokens"][:, :length]))
    close(tl, ul.numpy(), 1e-6)


@pytest.mark.parametrize("per_slot", [False, True])
def test_serve_step_matches_jax(pair, per_slot):
    cfg, jp, tcfg, tp, jprefill, jserve = pair
    jb, tb = batch(cfg, tokens(cfg, (3, P), seed=2), seed=2)
    jl, jc = jprefill(jp, jb)
    tl, tc = TM.make_prefill(tcfg, decode_len=cap(cfg))(tp, tb)
    nxt = tokens(cfg, (3, 1), seed=3)
    # a vision config's first decode position is past its prefix
    cl = prefix(cfg) + (np.array([P, P - 5, P + 2], np.int32) if per_slot
                        else P)
    jd, jc = jserve(jp, jc, jnp.asarray(nxt), jnp.asarray(cl))
    td, tc = TM.make_serve_step(tcfg)(tp, tc, torch.from_numpy(nxt), cl)
    close(td, jd)
    close_caches(tc, jc)


@pytest.mark.parametrize("arch", DENSE)
def test_serve_step_rejects_positions_past_the_cache(arch):
    tcfg = TC.get_reduced(arch)
    tp = TM.init_params(torch.Generator().manual_seed(0), tcfg)
    caches = TM.init_caches(tcfg, 2, 8, "cpu")
    step = TM.make_serve_step(tcfg)
    with pytest.raises(ValueError, match="outside"):
        step(tp, caches, torch.zeros((2, 1), dtype=torch.int32),
             np.array([3, 8], np.int32))


def test_greedy_tokens_match_jax(pair):
    """Three sequences decoded greedily by the one-shot loop in both."""
    cfg, jp, tcfg, tp, jprefill, jserve = pair
    jb, tb = batch(cfg, tokens(cfg, (3, P), seed=4), seed=4)
    pos = prefix(cfg) + P                # the first decode position
    logits, caches = jprefill(jp, jb)
    want, margins, jlogits = [], [], []
    for i in range(G):
        lg = np.asarray(logits)
        jlogits.append(lg)
        want.append(lg.argmax(-1))
        margins.append(margin(lg))
        if i < G - 1:
            logits, caches = jserve(jp, caches,
                                    jnp.asarray(want[-1][:, None]),
                                    jnp.int32(pos + i))
    tserve = TM.make_serve_step(tcfg)
    logits, caches = TM.make_prefill(tcfg, decode_len=cap(cfg))(tp, tb)
    got, diffs = [], []
    for i in range(G):
        got.append(logits.argmax(-1).numpy())
        diffs.append(np.abs(logits.numpy() - jlogits[i]).max(-1))
        if i < G - 1:
            logits, caches = tserve(tp, caches, torch.from_numpy(
                got[-1][:, None].astype(np.int32)), pos + i)
    got, want, margins, diffs = (np.stack(a, 1)
                                 for a in (got, want, margins, diffs))
    for b in range(3):
        # the logits are the same function of the same context up to the
        # first difference of tokens, included
        n, same = greedy_agree(got[b], want[b], margins[b], 2 * diffs[b])
        assert n >= 1 and diffs[b, :same + 1].max() <= LOGIT_TOL


def test_write_cache_slot_in_place():
    cfg = TC.get_reduced("lm100m")
    caches = TM.init_caches(cfg, 3, 10, "cpu")
    one = {k: torch.full(v.shape[:1] + (1,) + v.shape[2:], 2.0,
                         dtype=v.dtype) for k, v in caches.items()}
    ids = {k: id(v) for k, v in caches.items()}
    out = TM.write_cache_slot(caches, one, 1)
    for k, v in out.items():
        assert id(v) == ids[k]
        assert bool((v[:, 1] == 2).all()) and bool((v[:, [0, 2]] == 0).all())


def test_write_cache_slot_walks_period_caches():
    """A period stack's caches (a ``sub{j}`` a layer of the period): every
    leaf written in place at the slot, on the slot's owner only."""
    cfg = TC.get_reduced(JAMBA)
    caches = TM.init_caches(cfg, 3, 10, "cpu")
    one = jax.tree_util.tree_map(
        lambda v: torch.full(v.shape[:1] + (1,) + v.shape[2:], 2.0,
                             dtype=v.dtype), caches)
    ids = [id(v) for v in jax.tree_util.tree_leaves(caches)]
    TM.write_cache_slot(caches, one, 2, rows=slice(0, 2))   # not held here
    out = TM.write_cache_slot(caches, one, 1)
    leaves = jax.tree_util.tree_leaves(out)
    assert [id(v) for v in leaves] == ids and len(leaves) == 4
    for v in leaves:
        assert bool((v[:, 1] == 2).all()) and bool((v[:, [0, 2]] == 0).all())


@pytest.mark.parametrize("arch", JC.ARCH_IDS + ("lm100m",))
def test_config_sizes_match_reference(arch):
    for get_j, get_t in ((JC.get_config, TC.get_config),
                         (JC.get_reduced, TC.get_reduced)):
        j, t = get_j(arch), get_t(arch)
        assert dataclasses.asdict(j) == dataclasses.asdict(t)
        assert t.param_count() == j.param_count()
        assert t.active_param_count() == j.active_param_count()
        assert t.padded_vocab() == j.padded_vocab()


@pytest.mark.parametrize("arch", ["granite-moe-3b-a800m",
                                  "qwen3-moe-235b-a22b"])
def test_moe_configs_supported(arch):
    for get in (TC.get_config, TC.get_reduced):
        TT.check_supported(get(arch))
    cfg = TC.get_reduced(arch)
    struct = TM.cache_struct(cfg, 2, 8)
    assert set(struct) == {"k", "v"}


@pytest.mark.parametrize("arch,cross", [("seamless-m4t-large-v2", True),
                                        ("internvl2-2b", False)])
def test_encdec_and_vision_configs_supported(arch, cross):
    for get in (TC.get_config, TC.get_reduced):
        TT.check_supported(get(arch))
    cfg = TC.get_reduced(arch)
    struct = TM.cache_struct(cfg, 2, 8, enc_len=3)
    assert set(struct) == ({"k", "v", "ck", "cv"} if cross else {"k", "v"})
    if cross:
        # the cross caches at the encoder's length, not padded
        assert struct["ck"][0] == (cfg.n_layers, 2, cfg.n_kv_heads, 3,
                                   cfg.d_head)
    params = TM.init_params(torch.Generator().manual_seed(0), cfg)
    assert ("encoder" in params) == cross
    assert ("cross" in params["layers"]) == cross
    if cross:
        enc = params["encoder"]["layers"]
        assert enc["attn"]["wq"]["w"].shape[0] == cfg.encoder_layers
        assert "cross" not in enc and "ffn_gelu" in enc


@pytest.mark.parametrize("arch", [JAMBA, JAMBA8])
def test_jamba_period_stacks_supported(arch):
    """Jamba's period stacks: every sub-layer ``j`` of the kind of layer
    ``j``, each leaf stacked over the periods, the caches nested the same
    way (the reference's ``cache_struct``)."""
    for get in (TC.get_config, TC.get_reduced):
        TT.check_supported(get(JAMBA))
    cfg = reduced(TC.get_reduced, arch)
    per = cfg.attn_period
    params = TM.init_params(torch.Generator().manual_seed(0), cfg)
    layers = params["layers"]
    assert list(layers) == [f"sub{j}" for j in range(per)]
    for j in range(per):
        mixer, ffn, _ = TT.layer_kind(cfg, j)
        sub = layers[f"sub{j}"]
        assert ("attn" if mixer == "attn" else "mamba") in sub
        assert ("ffn_moe" if ffn == "moe" else "ffn_mlp") in sub
        assert all(v.shape[0] == cfg.n_layers // per
                   for v in jax.tree_util.tree_leaves(sub))
    kinds = {TT.layer_kind(cfg, j)[:2] for j in range(per)}
    assert ("mamba", "moe") in kinds if per == 4 else \
        kinds == {("mamba", "mlp"), ("attn", "moe")}
    struct = TM.cache_struct(cfg, 2, 8)
    assert set(struct[f"sub{per - 1}"]) == {"k", "v"}
    assert all(set(struct[f"sub{j}"]) == {"conv", "ssm"}
               for j in range(per - 1))


def _layer_tree(tree, seed):
    """The reference's layer params as numpy, biases and norm scales
    drawn away from their 0 / 1 init so that they matter."""
    rng = np.random.default_rng(seed)

    def conv(node):
        out = {}
        for k, v in node.items():
            if isinstance(v, dict):
                out[k] = conv(v)
            else:
                a = np.array(v, np.float32)
                if k in ("b", "scale"):
                    a = a + rng.normal(scale=0.1, size=a.shape).astype(
                        np.float32)
                out[k] = a
        return out

    return conv(tree)


def test_attention_layer_with_bias_and_qk_norm():
    """attn_apply and attn_decode with ``qkv_bias`` and ``qk_norm`` (no
    dense config of the reduced set has both) against the reference."""
    from repro.models import layers as JLy
    from repro_torch.models import layers as TLy
    cfg = dataclasses.replace(JC.get_reduced("lm100m"), qkv_bias=True,
                              qk_norm=True)
    tcfg = dataclasses.replace(TC.get_reduced("lm100m"), qkv_bias=True,
                               qk_norm=True)
    tree = _layer_tree(JLy.attn_init(jax.random.PRNGKey(1), cfg), 5)
    jp = jax.tree_util.tree_map(jnp.asarray, tree)
    tp = TM.params_from_jax(tree, tcfg, "cpu")
    rng = np.random.default_rng(6)
    B, S = 2, 8
    x = rng.normal(size=(B, S, cfg.d_model)).astype(np.float32)
    pos = np.tile(np.arange(S, dtype=np.int32), (B, 1))
    jy, (jk, jv) = jax.jit(JLy.attn_apply, static_argnums=1)(
        jp, cfg, jnp.asarray(x, jnp.bfloat16), jnp.asarray(pos))
    ty, (tk, tv) = TLy.attn_apply(tp, tcfg, torch.from_numpy(x).bfloat16(),
                                  torch.from_numpy(pos))
    for t, j in ((ty, jy), (tk, jk), (tv, jv)):
        close(t, j)
    x1 = rng.normal(size=(B, 1, cfg.d_model)).astype(np.float32)
    cl = np.array([S, S - 3], np.int32)
    pad = ((0, 0), (0, 0), (0, 2), (0, 0))
    jy, jc = jax.jit(JLy.attn_decode, static_argnums=1)(
        jp, cfg, jnp.asarray(x1, jnp.bfloat16),
        {"k": jnp.pad(jk, pad), "v": jnp.pad(jv, pad)}, jnp.asarray(cl))
    tc = {"k": torch.nn.functional.pad(tk, (0, 0, 0, 2)),
          "v": torch.nn.functional.pad(tv, (0, 0, 0, 2))}
    ty, tc = TLy.attn_decode(tp, tcfg, torch.from_numpy(x1).bfloat16(), tc,
                             torch.from_numpy(cl))
    close(ty, jy)
    for k in ("k", "v"):
        close(tc[k], jc[k])


def test_gelu_mlp_matches_jax():
    """The audio family's MLP (tanh-approximated GELU, as jax.nn.gelu)."""
    from repro.models import layers as JLy
    from repro_torch.models import layers as TLy
    tree = _layer_tree(JLy.gelu_mlp_init(jax.random.PRNGKey(2), 64, 256, 2),
                       7)
    x = np.random.default_rng(8).normal(size=(2, 5, 64)).astype(np.float32)
    cfg = TC.get_reduced("lm100m")
    close(TLy.gelu_mlp(TM.params_from_jax(tree, cfg, "cpu"),
                       torch.from_numpy(x).bfloat16()),
          jax.jit(JLy.gelu_mlp)(jax.tree_util.tree_map(jnp.asarray, tree),
                                jnp.asarray(x, jnp.bfloat16)))
