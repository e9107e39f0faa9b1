"""LM training in the port against the JAX package, on reduced
``lm100m``, ``granite-3-2b`` (GQA), ``falcon-mamba-7b``,
``granite-moe-3b-a800m`` (MoE, 8 experts top-2),
``seamless-m4t-large-v2`` (encoder and cross-attention, 8 frames a row)
``internvl2-2b`` (16 patch embeddings a row in front of the tokens,
which the loss skips) and ``jamba-1.5-large-398b``'s period stacks
(reduced, 4 layers in periods of 2; ``/8``: 8 layers in periods of 4,
with a (Mamba, MoE) sub-layer; the remat body one period) at B 2, S 32,
the frames and patch embeddings
float32 from a numpy seed, and lm100m and granite-moe at 2 microbatches:
the reference's
``init_params(PRNGKey(0))`` weights carried across as float32 masters
(``params_from_jax(..., master=True)``).  At 2 microbatches the
reference's ``loss`` metric is the mean total, loss plus 0.01 moe_aux
(``as_reference_reports``); the port's is the cross entropy, as
without microbatches.

Tolerances: ``lm_batch_at`` equal; ``ce_loss`` (chunks 1 and 4) and one
``make_train_step``'s loss and MoE auxiliary loss within ``LOSS_RTOL``
relative, its ``grad_norm`` within ``GNORM_RTOL``, and every updated
parameter within ``2·lr + 1e-6`` absolute of the reference's (a first
AdamW step moves a leaf by about ``lr·sign(g)``: a sign flip on a
near-zero gradient costs ``2·lr``, and nothing larger is excused).  Beside that bound, which an
unchanged or reversed update would also meet: each leaf's AdamW moments
within ``M_RTOL`` (``m``, 0.1·g: the leaf's gradient) and ``V_RTOL``
(``v``, 0.05·g²) of the leaf's largest reference moment (the enc-dec
stack's within ``ENCDEC_MOMENTS`` times those: its gradients pass
through three blocks a decoder layer and the encoder, and each package's
bf16 gradient lies up to 0.74 % (the port) and 0.98 % (the reference) of
the leaf's largest from the port's float32 gradient, which measured the
two 1.26 % apart in ``m`` and 2.5 % in ``v`` on ``embed``; Jamba's
hybrid stack's too: each package's ``m`` lies up to 2.0-3.0 % (the
port) and 1.7-2.2 % (the reference) of a leaf's largest from the port's
float32 step, ``v`` up to 5.9 / 4.4 %, and the two 1.49 % apart in ``m``
and 2.37 % in ``v``); the elements
whose reference gradient is at least ``SURE_FRAC`` of their leaf's
largest, whose sign bf16 sums cannot flip, within ``STEP_TOL·lr`` (in
the enc-dec stack only those of at least ``ENCDEC_SIGN_G``); and
no more than ``LOOSE_SHARE`` of all elements beyond ``STEP_TOL·lr`` (of
those of at least ``ENCDEC_SIGN_G`` in the enc-dec stack).
Both packages run bf16 products with float32 sums in different orders.
In the Jamba cases the port's step takes the reference's routes (the
ids its router picked in the step's forward, recorded by a callback on
its ``_route``; the train worker's ``pin_routes``): a near tie of the
router's top-k, which the two packages' float32 products in other
orders may break differently, would move a row to another expert (the
8-layer case has one, at a gap of 1.7e-4); the port's own top-k must
pick the same experts but at near ties (``TIE_GAP``).
``IN_ORDER_STEPS`` steps on the batches in order hold every step's loss
and grad norm to the same tolerances.  The chunked selective
scan against the reference's ``_scan_chunked_xla``, forward and VJP,
float32, within ``SCAN_RTOL`` of each array's largest magnitude; at a
sequence that is no multiple of the chunk, against its own unchunked
run.  Remat ``none``, ``full`` and ``dots`` give the same gradients
(``REMAT_TOL``), and ``launch.train.main`` with ``--fail-at`` ends bit
for bit where the run without it does."""
import dataclasses
import importlib.util
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_reduced as j_reduced
from repro.data.synthetic import lm_batch_at as j_lm_batch_at
from repro.models import mamba as JMb
from repro.models import model as JM
from repro.models import moe as JMoe
from repro.optim import adamw as JA
from repro_torch import checkpoint as Ck
from repro_torch.configs import TrainSettings, get_reduced
from repro_torch.data.synthetic import lm_batch_at
from repro_torch.launch import train as train_cli
from repro_torch.models import mamba as TMb
from repro_torch.models import model as TM
from repro_torch.models import moe as TMoe
from repro_torch.models.transformer import StackOpts
from repro_torch.optim import adamw as TA

_spec = importlib.util.spec_from_file_location(
    "torch_train_conformance", os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "dist",
        "torch_train_conformance.py"))
W = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(W)

LOSS_RTOL, GNORM_RTOL, SCAN_RTOL, REMAT_TOL = 2e-3, 2e-2, 1e-5, 1e-6
M_RTOL, V_RTOL = 1e-2, 2e-2
ENCDEC_MOMENTS = 2
SURE_FRAC, STEP_TOL, LOOSE_SHARE = 0.05, 1e-3, 0.02
# the enc-dec stack's sure elements also have |g| >= ENCDEC_SIGN_G (200
# AdamW eps): a first AdamW step is lr g / (|g| + eps), lr sign(g) only
# where |g| >> eps, and its encoder's q and k gradients are about 1e-7
ENCDEC_SIGN_G = 2e-6
IN_ORDER_STEPS = 8
B, S = 2, 32
JAMBA = "jamba-1.5-large-398b"
ARCHS = ("lm100m", "granite-3-2b", "falcon-mamba-7b", "granite-moe-3b-a800m",
         "seamless-m4t-large-v2", "internvl2-2b", JAMBA, JAMBA + "/8")
OPT = dict(lr=1e-3, warmup_steps=0, total_steps=10)
AUX_COEFF = 0.01                 # make_loss_fn's default, in both packages
# a near tie: the router's probabilities of two picks this close
TIE_GAP = 1e-3


@pytest.fixture(autouse=True)
def few_threads():
    """Two intra-op threads: the suite runs six workers on the machine's
    cores, and small ops on more threads each spend most of their time
    waiting for one another."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def np_tree(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), tree)


def float_inputs(cfg, step=0) -> dict:
    """An enc-dec config's frames (S / enc_len_ratio a row) and a vision
    config's patch embeddings, float32 from a numpy seed: the same numbers
    for both packages."""
    rng = np.random.default_rng(1000 + step)
    out = {}
    if cfg.is_encdec:
        out["frames"] = rng.normal(
            size=(B, S // cfg.enc_len_ratio, cfg.d_model)).astype(np.float32)
    if cfg.frontend == "vision":
        out["patch_embeds"] = rng.normal(
            size=(B, cfg.frontend_tokens, cfg.d_model)).astype(np.float32)
    return out


def jbatch(cfg, step=0):
    return {k: jnp.asarray(v) for k, v in
            dict(j_lm_batch_at(step, vocab=cfg.vocab, batch=B, seq=S),
                 **float_inputs(cfg, step)).items()}


def tbatch(cfg, step=0):
    return {k: torch.from_numpy(v) for k, v in
            dict(lm_batch_at(step, vocab=cfg.vocab, batch=B, seq=S),
                 **float_inputs(cfg, step)).items()}


def with_micro(cfg, n):
    return dataclasses.replace(cfg, train=TrainSettings(microbatches=n))


@pytest.fixture(scope="module",
                params=ARCHS + ("lm100m/micro2", "granite-moe-3b-a800m/micro2"))
def case(request):
    """One config: the reference's weights and one reference train step
    on lm_batch_at(0) (compiled once), and the port's masters."""
    arch, _, micro = request.param.partition("/")
    jcfg, cfg = j_reduced(arch), get_reduced(arch)
    if micro == "8":                 # Jamba at 8 layers in periods of 4
        jcfg, cfg = (dataclasses.replace(c, n_layers=8, attn_period=4)
                     for c in (jcfg, cfg))
    elif micro:
        jcfg = dataclasses.replace(
            jcfg, train=dataclasses.replace(jcfg.train, microbatches=2))
        cfg = with_micro(cfg, 2)
    jparams = JM.init_params(jax.random.PRNGKey(0), jcfg)
    jopt_cfg = JA.AdamWConfig(**OPT)
    plain, routes = JMoe._route, []
    if arch == JAMBA:
        def route(router, x2d, top_k):
            w, ids, aux = plain(router, x2d, top_k)
            jax.debug.callback(lambda i: routes.append(np.asarray(i)), ids)
            return w, ids, aux
        JMoe._route = route
    try:
        step = jax.jit(JM.make_train_step(jcfg, None, jopt_cfg))
        jnew, jopt, jmet = step(jparams, JA.init(jparams, jopt_cfg),
                                jbatch(jcfg))
        jax.effects_barrier()
    finally:
        JMoe._route = plain
    n_moe = sum(cfg._layer_has_moe(i) for i in range(cfg.n_layers))
    return dict(jcfg=jcfg, cfg=cfg, jparams=jparams, jstep_fn=step,
                # the first step's forward, one (T, k) a MoE layer (its
                # recompute follows); ``route_log`` keeps what later
                # calls of ``jstep_fn`` route
                routes=routes[:n_moe], route_log=routes, n_moe=n_moe,
                jopt_cfg=jopt_cfg,
                params=TM.params_from_jax(np_tree(jparams), cfg, "cpu",
                                          master=True),
                jnew=np_tree(jnew), jm=np_tree(jopt["m"]),
                jv=np_tree(jopt["v"]),
                jmet={k: float(v) for k, v in jmet.items()},
                jstep=int(jopt["step"]))


def rel(got, want):
    return abs(got - want) / abs(want)


def as_reference_reports(cfg, met):
    """The port's metrics as the reference reports them: with
    microbatches its ``loss`` is the mean of each microbatch's total,
    ``loss + AUX_COEFF * moe_aux`` (it accumulates the value of
    ``value_and_grad``), without them the cross entropy alone; the port
    reports the cross entropy in both."""
    met = {k: float(v) for k, v in met.items()}
    if cfg.train.microbatches > 1:
        met["loss"] += AUX_COEFF * met["moe_aux"]
    return met


@pytest.mark.parametrize("step", [0, 1, 99])
def test_lm_batch_at_matches_reference(step):
    for vocab, batch, seq in ((1024, 2, 32), (32768, 8, 512)):
        got = lm_batch_at(step, vocab=vocab, batch=batch, seq=seq)
        want = j_lm_batch_at(step, vocab=vocab, batch=batch, seq=seq)
        for k in ("tokens", "labels"):
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])


def test_masters_are_float32_and_serving_bf16():
    cfg = get_reduced("falcon-mamba-7b")
    master = TM.init_params(torch.Generator().manual_seed(0), cfg,
                            master=True)
    serve = TM.init_params(torch.Generator().manual_seed(0), cfg)
    flat, sflat = TA.flatten_params(master), TA.flatten_params(serve)
    assert {v.dtype for v in flat.values()} == {torch.float32}
    assert sflat["layers.mamba.in_proj.w"].dtype == torch.bfloat16
    assert sflat["layers.mamba.dt_proj.w"].dtype == torch.float32
    for k, v in flat.items():            # the same draws
        assert torch.equal(v.to(sflat[k].dtype), sflat[k]), k


@pytest.mark.parametrize("chunks", [1, 4])
def test_ce_loss_matches_reference(case, chunks):
    cfg, jcfg = case["cfg"], case["jcfg"]
    rng = np.random.default_rng(chunks)
    x = rng.normal(size=(B, S, cfg.d_model)).astype(np.float32)
    labels = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    labels[0, :5] = -1                          # masked
    xb = jnp.asarray(x, jnp.bfloat16)
    want = float(JM.ce_loss(case["jparams"], jcfg, xb, jnp.asarray(labels),
                            chunks))
    got = float(TM.ce_loss(case["params"], cfg,
                           torch.from_numpy(np.asarray(xb, np.float32))
                           .to(torch.bfloat16), torch.from_numpy(labels),
                           chunks))
    assert rel(got, want) <= LOSS_RTOL, (got, want)


def test_train_step_matches_reference(case):
    cfg = case["cfg"]
    opt_cfg = TA.AdamWConfig(**OPT)
    params = case["params"]
    opt = TA.init(TA.flatten_params(params), opt_cfg)
    route, differ = TMoe._route, {}
    if case["routes"]:
        TMoe._route = W.pin_routes(case["routes"], differ)
    try:
        new, opt, met = TM.make_train_step(cfg, None, opt_cfg)(
            params, opt, tbatch(cfg))
    finally:
        TMoe._route = route
    if case["routes"]:
        # the port's own top-k picked the reference's experts but at near
        # ties
        assert sorted(differ) == list(range(len(case["routes"])))
        assert all(gap <= TIE_GAP for _, gap in differ.values()), differ
    jmet = case["jmet"]
    reported = as_reference_reports(cfg, met)
    assert rel(reported["loss"], jmet["loss"]) <= LOSS_RTOL, \
        (reported["loss"], jmet["loss"])
    assert rel(float(met["grad_norm"]), jmet["grad_norm"]) <= GNORM_RTOL, \
        (float(met["grad_norm"]), jmet["grad_norm"])
    # the MoE auxiliary loss (0 in both without MoE layers)
    assert abs(float(met["moe_aux"]) - jmet["moe_aux"]) \
        <= LOSS_RTOL * abs(jmet["moe_aux"]), \
        (float(met["moe_aux"]), jmet["moe_aux"])
    lr = float(met["lr"])
    assert lr == pytest.approx(jmet["lr"], rel=1e-6)
    assert opt["step"].dtype == torch.int32 and int(opt["step"]) == \
        case["jstep"] == 1
    want = TA.flatten_params(case["jnew"])
    got = TA.flatten_params(new)
    assert list(got) == list(want)
    jm, jv = (TA.flatten_params(case[j]) for j in ("jm", "jv"))
    # the enc-dec branch, for Jamba's hybrid stack too
    deep = cfg.is_encdec or cfg.family == "hybrid"
    loose = total = 0
    for k, w in want.items():
        assert got[k].dtype == torch.float32, k
        f = ENCDEC_MOMENTS if deep else 1
        for moment, ref, tol in (("m", jm, f * M_RTOL), ("v", jv, f * V_RTOL)):
            merr = float(np.abs(opt[moment][k].numpy() - ref[k]).max())
            assert merr <= tol * float(np.abs(ref[k]).max()), \
                (k, moment, merr)
        err = np.abs(got[k].numpy() - w)
        assert float(err.max()) <= 2 * lr + 1e-6, (k, float(err.max()))
        gm = np.abs(jm[k])
        # the elements whose step is lr sign(g) (m = 0.1 g)
        sign_like = gm >= 0.1 * ENCDEC_SIGN_G if deep \
            else np.ones(gm.shape, bool)
        sure = sign_like & (gm >= SURE_FRAC * gm.max())
        assert float(err[sure].max(initial=0)) <= STEP_TOL * lr, \
            (k, float(err[sure].max(initial=0)) / lr)
        loose += int((err[sign_like] > STEP_TOL * lr).sum())
        total += int(sign_like.sum())
    assert loose <= LOOSE_SHARE * total, (loose, total)


def test_train_steps_in_order_follow_reference(case):
    """IN_ORDER_STEPS steps on ``lm_batch_at(0..)`` in order from the
    same masters: every step's loss and grad norm within the first
    step's tolerances of the reference's, so the port's training follows
    the reference's past its first update (in the Jamba cases each step
    on the reference's routes of that step)."""
    cfg = case["cfg"]
    opt_cfg = TA.AdamWConfig(**OPT)
    params, jparams = case["params"], case["jparams"]
    opt = TA.init(TA.flatten_params(params), opt_cfg)
    jopt = JA.init(jparams, case["jopt_cfg"])
    step = TM.make_train_step(cfg, None, opt_cfg)
    route, log = TMoe._route, case["route_log"]
    for s in range(IN_ORDER_STEPS):
        log.clear()
        jparams, jopt, jmet = case["jstep_fn"](jparams, jopt, jbatch(cfg, s))
        jax.effects_barrier()
        if case["routes"]:           # the reference's routes of this step
            TMoe._route = W.pin_routes(log[:case["n_moe"]], {})
        try:
            params, opt, met = step(params, opt, tbatch(cfg, s))
        finally:
            TMoe._route = route
        met = as_reference_reports(cfg, met)
        for k, tol in (("loss", LOSS_RTOL), ("grad_norm", GNORM_RTOL),
                       ("moe_aux", LOSS_RTOL)):
            assert abs(met[k] - float(jmet[k])) \
                <= tol * abs(float(jmet[k])), (s, k, met[k], float(jmet[k]))


# --------------------------------------------------------------------------
# the chunked scan
# --------------------------------------------------------------------------


def scan_inputs(S, E=16, N=4, Bsz=2, seed=0):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    return dict(x=f(Bsz, S, E), delta=np.log1p(np.exp(f(Bsz, S, E))),
                A=-np.exp(0.5 * f(E, N)), Bm=f(Bsz, S, N), Cm=f(Bsz, S, N),
                D=f(E))


def close_to(got, want, what):
    got, want = np.asarray(got), np.asarray(want)
    err = float(np.abs(got - want).max())
    assert err <= SCAN_RTOL * float(np.abs(want).max()), (what, err)


def port_scan_vjp(inp, h0, gy, gh, chunk):
    t = {k: torch.from_numpy(v).requires_grad_(True) for k, v in inp.items()}
    h0 = torch.from_numpy(h0).requires_grad_(True)
    y, hT = TMb.scan_chunked(**t, h0=h0, chunk=chunk)
    grads = torch.autograd.grad((y, hT), list(t.values()) + [h0],
                                (torch.from_numpy(gy), torch.from_numpy(gh)))
    return y.detach(), hT.detach(), [g.numpy() for g in grads]


def test_scan_chunked_matches_reference_forward_and_vjp():
    S, chunk = 32, 8
    inp = scan_inputs(S)
    rng = np.random.default_rng(1)
    h0 = rng.normal(size=(2, 16, 4)).astype(np.float32)
    gy = rng.normal(size=(2, S, 16)).astype(np.float32)
    gh = rng.normal(size=(2, 16, 4)).astype(np.float32)
    names = list(inp) + ["h0"]

    def ref(x, delta, A, Bm, Cm, D, h0):
        return JMb._scan_chunked_xla(x, delta, A, Bm, Cm, D, h0, chunk)

    (jy, jh), vjp = jax.vjp(ref, *[jnp.asarray(v) for v in inp.values()],
                            jnp.asarray(h0))
    jgrads = vjp((jnp.asarray(gy), jnp.asarray(gh)))
    y, hT, grads = port_scan_vjp(inp, h0, gy, gh, chunk)
    close_to(y, jy, "y")
    close_to(hT, jh, "hT")
    for name, g, w in zip(names, grads, jgrads):
        close_to(g, w, name)


def test_scan_chunked_takes_any_length():
    """S 40 in chunks of 16 (the last one 8 long) against one chunk."""
    S = 40
    inp = scan_inputs(S, seed=2)
    rng = np.random.default_rng(3)
    h0 = rng.normal(size=(2, 16, 4)).astype(np.float32)
    gy = rng.normal(size=(2, S, 16)).astype(np.float32)
    gh = rng.normal(size=(2, 16, 4)).astype(np.float32)
    y, hT, grads = port_scan_vjp(inp, h0, gy, gh, 16)
    y1, hT1, grads1 = port_scan_vjp(inp, h0, gy, gh, S)
    close_to(y, y1, "y")
    close_to(hT, hT1, "hT")
    for name, g, w in zip(list(inp) + ["h0"], grads, grads1):
        close_to(g, w, name)


# --------------------------------------------------------------------------
# remat modes and the launcher's drill
# --------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["lm100m", "falcon-mamba-7b",
                                  "granite-moe-3b-a800m",
                                  "seamless-m4t-large-v2", JAMBA])
def test_remat_modes_give_equal_gradients(arch):
    cfg = get_reduced(arch)
    params = TM.init_params(torch.Generator().manual_seed(0), cfg,
                            master=True)
    batch = tbatch(cfg)
    grads = {}
    for remat in ("none", "full", "dots"):
        flat = {k: p.detach().requires_grad_(True)
                for k, p in TA.flatten_params(params).items()}
        loss_fn = TM.make_loss_fn(cfg, None, StackOpts(remat=remat,
                                                 mamba_chunk=8))
        total, _ = loss_fn(TA.unflatten_params(flat), batch)
        grads[remat] = torch.autograd.grad(total, list(flat.values()))
    for remat in ("full", "dots"):
        for g, w in zip(grads[remat], grads["none"]):
            torch.testing.assert_close(g, w, rtol=REMAT_TOL, atol=REMAT_TOL)


def test_train_cli_restart_drill_is_bit_identical(tmp_path, capsys):
    """``python -m repro_torch.launch.train --arch lm100m --reduced
    --device cpu --steps 12 --fail-at 7``: the restart from the step-5
    checkpoint ends with the final params and AdamW moments, bit for
    bit, and the history of the run without the failure."""
    argv = ["--arch", "lm100m", "--reduced", "--device", "cpu",
            "--steps", "12", "--batch", "2", "--seq", "32",
            "--ckpt-every", "5", "--log-every", "0"]
    ref = train_cli.main(argv + ["--ckpt-dir", str(tmp_path / "ref")])
    # a stale checkpoint of another run is removed, a file of the user's
    # in the directory stays
    Ck.save(str(tmp_path / "fail"), 10, {"stale": torch.zeros(1)})
    (tmp_path / "fail" / "notes.txt").write_text("kept")
    got = train_cli.main(argv + ["--ckpt-dir", str(tmp_path / "fail"),
                                 "--fail-at", "7"])
    assert (tmp_path / "fail" / "notes.txt").read_text() == "kept"
    assert "[fault] injected failure at step 7" in capsys.readouterr().out
    keys = ("loss", "grad_norm", "lr")
    assert [h["step"] for h in got] == list(range(6, 13))
    assert [[h[k] for k in keys] for h in got] == \
        [[h[k] for k in keys] for h in ref[5:]]
    final = []
    for d in ("ref", "fail"):
        with np.load(tmp_path / d / "step_12" / "arrays.npz") as f:
            final.append([f[f"a{i}"] for i in range(len(f.files))])
    assert len(final[0]) == len(final[1]) > 2 * 11
    for a, b in zip(*final):
        assert a.dtype == b.dtype and np.array_equal(a, b)
