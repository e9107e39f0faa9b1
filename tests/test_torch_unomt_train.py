"""UNOMT stage 4 in the port (``models.unomt_net``, ``optim.adamw``,
``optim.compression``, ``core.tensor_ops``, ``runtime.ddp``) against the
JAX package on the CPU, parameters carried across by
``unomt_params_from_jax``.

Tolerances, float32 throughout (XLA and PyTorch add the products' and
reductions' terms in other orders, and their ``cos`` and ``pow`` may
differ in the last place):

* forward and loss: ``|port - jax| <= 1e-5 * (1 + |jax|)``;
* gradients: each leaf within ``1e-5 * max|g_jax| + 1e-6``;
* schedule, global norm and AdamW updates: ``rtol 1e-6``, ``atol 1e-7``
  (updates on identical gradients);
* int8 collectives: equal, or one quantisation step (``scale``) apart
  where a value lands on a rounding tie differently;
* DDP steps: losses and parameters within ``2e-5 * (1 + |jax|)`` after
  three steps.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.core import tensor_ops as JTO
from repro.core.context import make_context as jax_context
from repro.core.context import shard_map
from repro.core.table import Table as JT
from repro.data import unomt as JU
from repro.models import unomt_net as JN
from repro.optim import adamw as JA
from repro.optim import compression as JC
from repro.runtime.ddp import make_ddp_train_step as jax_ddp_step
from repro_torch.core import tensor_ops as TTO
from repro_torch.core.context import make_context as torch_context
from repro_torch.core.table import Table as TT
from repro_torch.data import unomt as TU
from repro_torch.launch import unomt_e2e
from repro_torch.models import unomt_net as TN
from repro_torch.optim import adamw as TA
from repro_torch.optim import compression as TC
from repro_torch.runtime.ddp import make_ddp_train_step as torch_ddp_step

CFG = dict(n_features=17, d_hidden=32, n_res_blocks=2, n_dense_tail=1)
N = 64


def close(got, want, rel, msg=""):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, msg
    err = np.abs(got - want)
    assert np.all(err <= rel * (1 + np.abs(want))), (msg, err.max())


def t(a):
    return torch.from_numpy(np.array(a, np.float32))


@pytest.fixture(scope="module")
def net():
    jcfg = JN.UnomtNetConfig(**CFG)
    tcfg = TN.UnomtNetConfig(**CFG)
    jp = JN.init(jax.random.PRNGKey(0), jcfg)
    rng = np.random.default_rng(0)
    batch = {"x": rng.normal(size=(N, 17)).astype(np.float32),
             "y": rng.normal(size=N).astype(np.float32),
             "mask": (rng.random(N) < 0.8)}
    return jcfg, tcfg, jp, TN.unomt_params_from_jax(jp, "cpu"), batch


def test_defaults_and_param_names_match_jax(net):
    assert dataclass_fields(TN.UnomtNetConfig()) == \
        dataclass_fields(JN.UnomtNetConfig())
    _, tcfg, jp, tp, _ = net
    names = [jax.tree_util.keystr(path, simple=True, separator=".")
             for path, _ in jax.tree_util.tree_flatten_with_path(jp)[0]]
    assert list(tp) == names
    mine = TN.init(torch.Generator().manual_seed(0), tcfg)
    assert list(mine) == names
    assert all(mine[k].shape == tp[k].shape for k in names)


def dataclass_fields(c):
    return {f: getattr(c, f) for f in ("n_features", "d_hidden",
                                       "n_res_blocks", "n_dense_tail",
                                       "dropout")}


def test_apply_and_loss_match_jax(net):
    jcfg, tcfg, jp, tp, b = net
    want = JN.apply(jp, jcfg, jnp.asarray(b["x"]))
    got = TN.apply(tp, tcfg, t(b["x"]))
    close(got, want, 1e-5, "apply")
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    tb = {"x": t(b["x"]), "y": t(b["y"]), "mask": torch.from_numpy(b["mask"])}
    wl, _ = JN.mse_loss(jp, jcfg, jb)
    gl, gm = TN.mse_loss(tp, tcfg, tb)
    close(gl, wl, 1e-5, "masked loss")
    assert gm["mse"] is gl
    wl, _ = JN.mse_loss(jp, jcfg, {"x": jb["x"], "y": jb["y"]})
    gl, _ = TN.mse_loss(tp, tcfg, {"x": tb["x"], "y": tb["y"]})
    close(gl, wl, 1e-5, "unmasked loss")


def jax_keep_masks(key, jcfg, n):
    """The keep masks ``unomt_net.apply`` draws with ``key``: one split
    per block, then ``bernoulli`` of the block's (n, d_hidden) shape."""
    masks = []
    for _ in range(jcfg.n_res_blocks):
        key, sub = jax.random.split(key)
        masks.append(np.asarray(jax.random.bernoulli(
            sub, 1 - jcfg.dropout, (n, jcfg.d_hidden))))
    return masks


def test_train_apply_with_the_reference_dropout_masks(net):
    jcfg, tcfg, jp, tp, b = net
    key = jax.random.PRNGKey(3)
    want = JN.apply(jp, jcfg, jnp.asarray(b["x"]), train=True, key=key)
    masks = [torch.from_numpy(np.array(m))
             for m in jax_keep_masks(key, jcfg, N)]
    got = TN.apply(tp, tcfg, t(b["x"]), train=True, keep_masks=masks)
    close(got, want, 1e-5, "dropout")
    assert not np.allclose(np.asarray(want), np.asarray(
        JN.apply(jp, jcfg, jnp.asarray(b["x"]))))
    # a generator's masks drop about the configured share
    gen = torch.Generator().manual_seed(1)
    a = TN.apply(tp, tcfg, t(b["x"]), train=True, generator=gen)
    assert a.shape == (N,) and torch.isfinite(a).all()


def test_gradients_match_jax(net):
    jcfg, tcfg, jp, tp, b = net
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    (wl, _), wg = jax.value_and_grad(JN.mse_loss, has_aux=True)(
        jp, jcfg, jb)
    leaves = {k: v.clone().requires_grad_(True) for k, v in tp.items()}
    tb = {"x": t(b["x"]), "y": t(b["y"]), "mask": torch.from_numpy(b["mask"])}
    gl, _ = TN.mse_loss(leaves, tcfg, tb)
    grads = dict(zip(leaves, torch.autograd.grad(gl, list(leaves.values()))))
    close(gl.detach(), wl, 1e-5, "loss")
    want = TN.unomt_params_from_jax(wg, "cpu")
    for k, w in want.items():
        tol = 1e-5 * float(w.abs().max()) + 1e-6
        assert float((grads[k] - w).abs().max()) <= tol, k


# --------------------------------------------------------------------------
# AdamW
# --------------------------------------------------------------------------


OPT = dict(lr=1e-2, warmup_steps=3, total_steps=20, weight_decay=0.1)


def test_schedule_matches_jax():
    for kw in (OPT, dict(lr=1.0, warmup_steps=10, total_steps=100,
                         min_lr_ratio=0.1), dict(warmup_steps=0)):
        jcfg, tcfg = JA.AdamWConfig(**kw), TA.AdamWConfig(**kw)
        for s in (0, 1, 2, 5, 10, 17, 55, 100, 150):
            want = float(JA.schedule(jcfg, jnp.int32(s)))
            got = TA.schedule(tcfg, torch.tensor(s, dtype=torch.int32))
            assert got.dtype == torch.float32
            np.testing.assert_allclose(float(got), want, rtol=1e-6,
                                       atol=1e-7, err_msg=f"{kw} step {s}")


def test_global_norm_and_decay_mask_match_jax(net):
    _, _, jp, tp, _ = net
    np.testing.assert_allclose(float(TA.global_norm(tp)),
                               float(JA.global_norm(jp)), rtol=1e-6)
    paths = jax.tree_util.tree_flatten_with_path(jp)[0]
    for path, _ in paths:
        name = jax.tree_util.keystr(path, simple=True, separator=".")
        assert TA._decay_mask(name) == JA._decay_mask(path), name
    for name in ("layers.0.norm.scale", "mamba.A_log", "mamba.D",
                 "mamba.conv_b", "x.w", "embed.embed"):
        jpath = tuple(jax.tree_util.DictKey(n) for n in name.split("."))
        assert TA._decay_mask(name) == JA._decay_mask(jpath), name


def test_five_updates_match_jax(net):
    _, _, jp, tp, _ = net
    jcfg, tcfg = JA.AdamWConfig(**OPT), TA.AdamWConfig(**OPT)
    js, ts = JA.init(jp, jcfg), TA.init(tp, tcfg)
    rng = np.random.default_rng(11)
    for i in range(5):
        # large gradients at step 0 so clipping acts, small afterwards
        scale = 10.0 if i == 0 else 0.05
        g = {k: (rng.normal(size=v.shape) * scale).astype(np.float32)
             for k, v in tp.items()}
        jg = jax.tree_util.tree_unflatten(
            jax.tree_util.tree_structure(jp), [jnp.asarray(g[k]) for k in tp])
        jp, js, jm = JA.update(jp, jg, js, jcfg)
        tp, ts, tm = TA.update(tp, {k: t(v) for k, v in g.items()}, ts, tcfg)
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-6)
        np.testing.assert_allclose(float(tm["lr"]), float(jm["lr"]),
                                   rtol=1e-6)
    assert int(ts["step"]) == int(js["step"]) == 5
    want = TN.unomt_params_from_jax(jp, "cpu")
    wm = TN.unomt_params_from_jax(js["m"], "cpu")
    wv = TN.unomt_params_from_jax(js["v"], "cpu")
    for k in want:
        for got, w in ((tp[k], want[k]), (ts["m"][k], wm[k]),
                       (ts["v"][k], wv[k])):
            np.testing.assert_allclose(got.numpy(), w.numpy(), rtol=1e-6,
                                       atol=1e-7, err_msg=k)


# --------------------------------------------------------------------------
# int8 collectives at world 1
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jctx():
    return jax_context(jax.make_mesh((1,), ("rows",)))


def within_one_step(got, want, step, what):
    """Equal, or one quantisation step apart; prints how many values are
    a step apart (a rounding that went the other way) and how many differ
    by float rounding alone (under half a step)."""
    got, want = np.asarray(got), np.asarray(want)
    diff = np.abs(got.astype(np.float64) - want)
    flips = int((diff > step / 2).sum())
    ulps = int(((diff > 0) & (diff <= step / 2)).sum())
    print(f"{what}: of {want.size} values {flips} one step apart, "
          f"{ulps} apart by float rounding")
    assert np.all(diff <= np.asarray(step, np.float64) * 1.0001), what


def test_quantized_psum_matches_jax(jctx):
    rng = np.random.default_rng(4)
    x = (rng.normal(size=(37, 5)) * 3).astype(np.float32)
    fn = shard_map(lambda v: JTO.quantized_psum(v, jctx.row_axes, 1),
                   mesh=jctx.mesh, in_specs=P(), out_specs=P())
    want = np.asarray(jax.jit(fn)(jnp.asarray(x)))
    got = TTO.quantized_psum(t(x), torch_context("cpu")).numpy()
    # two rounds of int8 rounding: within two steps of the input
    within_one_step(got, want, np.abs(x).max() / 127, "quantized_psum")
    assert np.abs(got - x).max() <= 2 * np.abs(x).max() / 127
    assert np.array_equal(
        TTO.psum_pytree({"a": t(x)}, torch_context("cpu"))["a"].numpy(), x)


def test_compressed_grad_allreduce_matches_jax(net, jctx):
    _, _, jp, tp, _ = net
    rng = np.random.default_rng(6)
    g = {k: rng.normal(size=v.shape).astype(np.float32)
         for k, v in tp.items()}
    e = {k: (rng.normal(size=v.shape) * 0.01).astype(np.float32)
         for k, v in tp.items()}
    tree = jax.tree_util.tree_structure(jp)
    jg = jax.tree_util.tree_unflatten(tree, [jnp.asarray(g[k]) for k in tp])
    je = jax.tree_util.tree_unflatten(tree, [jnp.asarray(e[k]) for k in tp])
    fn = shard_map(lambda a, b: JC.compressed_grad_allreduce(
        a, b, jctx.row_axes, 1), mesh=jctx.mesh, in_specs=(P(), P()),
        out_specs=(P(), P()))
    wg, we = jax.jit(fn)(jg, je)
    tg, te = TC.compressed_grad_allreduce(
        {k: t(v) for k, v in g.items()}, {k: t(v) for k, v in e.items()},
        torch_context("cpu"))
    wg = TN.unomt_params_from_jax(wg, "cpu")
    we = TN.unomt_params_from_jax(we, "cpu")
    for k in tp:
        step = np.abs(g[k] + e[k]).max() / 127
        within_one_step(tg[k], wg[k], step, f"mean {k}")
        within_one_step(te[k], we[k], step, f"residual {k}")
    zero = TC.init_residuals(tp)
    assert all(v.dtype == torch.float32 and not v.any()
               for v in zero.values())


# --------------------------------------------------------------------------
# the DDP step at world 1, and the overfitting check of tests/test_system.py
# --------------------------------------------------------------------------


@pytest.mark.parametrize("compress", [False, True])
def test_ddp_step_matches_jax(net, jctx, compress):
    jcfg, tcfg, jp, tp, b = net
    kw = dict(lr=1e-3, warmup_steps=2, total_steps=10)
    jstep = jax_ddp_step(lambda p, bb: JN.mse_loss(p, jcfg, bb),
                         JA.AdamWConfig(**kw), jctx, compress=compress)
    tstep = torch_ddp_step(lambda p, bb: TN.mse_loss(p, tcfg, bb),
                           TA.AdamWConfig(**kw), torch_context("cpu"),
                           compress=compress)
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    tb = {"x": t(b["x"]), "y": t(b["y"]), "mask": torch.from_numpy(b["mask"])}
    jp = jax.tree_util.tree_map(jnp.array, jp)       # the step donates it
    js = (jp, JA.init(jp, JA.AdamWConfig(**kw)), JC.init_residuals(jp))
    ts = (tp, TA.init(tp, TA.AdamWConfig(**kw)), TC.init_residuals(tp))
    for _ in range(3):
        *js, jm = jstep(*js, jb)
        *ts, tm = tstep(*ts, tb)
        close(tm["loss"], jm["loss"], 2e-5, "loss")
        close(tm["grad_norm"], jm["grad_norm"], 2e-5, "grad_norm")
    want = TN.unomt_params_from_jax(js[0], "cpu")
    for k, w in want.items():
        close(ts[0][k], w, 2e-5, k)


def test_unomt_net_overfits_port_pipeline_output():
    """Mirror of ``test_system.py::test_unomt_net_overfits_pipeline_output``
    on the port's own pipeline and training: the loss falls below a fifth
    of its start in 80 full-batch steps."""
    raw = JU.gen_unomt_tables(n_response=1024, n_drugs=64, n_cells=32,
                              seed=7)
    feat = TU.unomt_local_pipeline(
        *[TT.from_dict(raw[k], device="cpu")
          for k in ("response", "descriptors", "fingerprints", "rna")],
        out_capacity=2048)
    X, y, mask = TU.feature_label_arrays(feat)
    cfg = TN.UnomtNetConfig(n_features=X.shape[1], d_hidden=64,
                            n_res_blocks=2, n_dense_tail=1, dropout=0.0)
    params = TN.init(torch.Generator().manual_seed(0), cfg)
    opt_cfg = TA.AdamWConfig(lr=3e-3, warmup_steps=0, min_lr_ratio=1.0,
                             weight_decay=0.0)
    step = torch_ddp_step(lambda p, bb: TN.mse_loss(p, cfg, bb), opt_cfg,
                          torch_context("cpu"))
    state = (params, TA.init(params, opt_cfg), TC.init_residuals(params))
    batch = {"x": X, "y": y, "mask": mask}
    losses = []
    for _ in range(80):
        *state, m = step(*state, batch)
        losses.append(float(m["loss"]))
    assert losses[-1] < 0.2 * losses[0], (losses[0], losses[-1])
    # the reference's table engine gives the same features
    jfeat = JU.unomt_local_pipeline(
        *[JT.from_dict(raw[k])
          for k in ("response", "descriptors", "fingerprints", "rna")],
        out_capacity=2048)
    assert int(jfeat.nvalid) == int(feat.nvalid)


@pytest.mark.parametrize("compress", [False, True])
def test_unomt_e2e_entry_point_on_cpu(compress, capsys):
    """``python -m repro_torch.launch.unomt_e2e --device cpu``, small:
    stages 2–4 run and the loss falls."""
    argv = ["--device", "cpu", "--rows", "400", "--steps", "4"]
    history = unomt_e2e.main(argv + ["--compress"] * compress)
    assert len(history) == 4
    assert history[-1]["loss"] < history[0]["loss"]
    out = capsys.readouterr().out
    assert "unomt_e2e OK" in out and "on cpu" in out
