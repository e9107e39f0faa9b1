"""The port's sharded training at ``data=2, model=2`` against the JAX
package at the same mesh and against the port's own world-1 step
(``tests/dist/torch_train_conformance.py``).

Four gloo processes meet through a ``file://`` store under ``tmp_path``
with a 120 s timeout on the process group; the JAX reference runs in its
own subprocess with four forced host devices and an Auto-axis ``(data=2,
model=2)`` mesh (this jax makes Explicit axes by default, under which
the reference's ``with_sharding_constraint`` raises).  Every process is
killed past ``LIMIT_S``.  Both start from the reference's
``init_params(PRNGKey(0))`` weights, which this module writes, and take
one ``make_train_step`` on ``lm_batch_at(0)`` of 2 x 32 tokens.

* One step of reduced ``granite-moe-3b-a800m`` under ``tp`` at capacity
  factors 5 (no row drops) and 1.25, reduced ``lm100m`` under ``tp``,
  reduced ``qwen1.5-110b`` under ``fsdp_tp``, reduced
  ``falcon-mamba-7b`` and ``seamless-m4t-large-v2`` (its frames through
  the encoder and every cross-attention) under both, reduced
  ``internvl2-2b`` (its patch embeddings in front) under ``tp`` and
  reduced ``jamba-1.5-large-398b`` (period stacks: Mamba, attention and
  MoE sub-layers, capacity 5) under ``tp`` at ``2x2`` and at ``1x4``,
  where two model ranks share each KV head (granite-moe and Jamba under
  ``fsdp_tp`` at 5 run in the port only, held to their ``tp`` steps and
  to world 1): ``loss``, ``grad_norm`` and ``moe_aux`` against the
  reference's within the tolerances of ``tests/test_torch_lm_train.py``,
  and every new parameter and AdamW moment by that module's leaf rule
  (:func:`leaf_rule`; in the MoE and enc-dec cases its enc-dec branch,
  which counts only elements whose gradient is at least ``SIGN_G``: the
  encoder's q and k gradients are about 1e-7, where a first AdamW step
  is no sign; in the enc-dec and Jamba cases also its moment tolerance,
  ``ENCDEC_MOMENTS`` times the plain one, plus the reference's own
  layout move: the hybrid stack's bf16 moments lie up to 2-3 % of a
  leaf's largest from its float32 step's in each package and layout,
  ``tests/test_torch_lm_train.py``).  In the MoE
  cases the port's ranks take the
  reference's routes (the worker's ``pin_routes``): a near tie of the
  router's top-k, which the two packages' float32 products in other
  orders may break differently, would move a row to another expert.  The
  port's own top-k must agree with the reference's on every row but near
  ties, whose probabilities lie within ``TIE_GAP``, and on every row of
  at least one layer (:func:`test_own_routes_match_reference`).
* The same step against the port's world-1 step on the whole batch
  (capacity 5: nothing drops), whose MoE layers route every row as the
  sharded step routed it and take the reference's auxiliary loss at the
  mesh, the mean over the (data, model) shards of each shard's
  ``E * sum(frac * pmean)`` (:func:`pinned_routes`): the same function,
  summed in other orders; and in one microbatch per data rank, so that
  each data rank's bf16 gradients are rounded and summed in float32 as
  the microbatches' are.  ``fsdp_tp`` against ``tp``: the same
  arithmetic in another layout.  Where the reference's own step at the
  mesh moves a moment further from its world-1 step than the leaf rule's
  tolerance (the bf16 rounding of each rank's partial sums: up to 1.6 %
  of a leaf's largest on these reduced models), the port's may lie
  within twice that (:func:`reference_layout_noise`).
* At capacity 1.25 each rank's dropped rows of each layer (the port's
  ``moe.drop_log``) equal the reference's.
* ZeRO-1: each rank's ``m`` and ``v`` have the shape of its 2D slice
  (``param_specs(for_opt=True)``) and equal that slice of the gathered
  moments bit for bit, and within the leaf rule's moment tolerances of
  the same slice of the world-1 step's.
* The Mamba layout (a model rank holds ``in_proj``'s x and z columns of
  its channels), reduced Seamless's (the encoder subtree, the
  decoder's ``cross`` and ``ln_cross``) and reduced Jamba's (the
  ``sub{j}`` level of its period stacks): at ``2x2`` under both flavors
  and at ``1x4`` the training state's whole leaves and each rank's
  slices go through ``StateLayout`` both ways bit for bit, and the data
  axis's gathers need nothing new; the ``2x2`` Mamba, Seamless and
  Jamba steps' checkpoints restore at world 1 in both packages.
* Checkpoints: a world-1 checkpoint restores at ``data=2, model=2`` into
  each rank's slices bit for bit, and a state saved there restores bit
  for bit; ``launch.train.main --mesh data=2,model=2`` for 4 steps with
  ``--fail-at 2`` ends bit-identical to the run without it (every leaf
  of the last checkpoint and the records), and that checkpoint restores
  at world 1 in both packages.
* ``--coordinator``: four ranks started by hand with ``RANK`` /
  ``WORLD_SIZE`` / ``LOCAL_RANK`` on a port found by binding port 0 end
  bit-identical to the drill's ``--mesh data=2,model=2`` run.

Every run of the module starts in one fixture (:func:`runs`): the
worker's processes and the coordinator's ranks are started first, and
the drill runs in this process while they do.
* What stays refused at world > 1: a second batch axis of several
  ranks and KV heads that do not split in training (item 3).
  ``launch.train`` refuses an encoder or vision config at every world:
  its batches carry tokens and labels only, as the reference's.
"""
import dataclasses
import importlib.util
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax

from repro import checkpoint as JCk
from repro import configs as JC
from repro.models import model as JM
from repro.optim import adamw as JA
from repro_torch import checkpoint as Ck
from repro_torch import configs as TC
from repro_torch.data.synthetic import lm_batch_at
from repro_torch.launch import mesh as Me
from repro_torch.launch import train as Tr
from repro_torch.models import model as TM
from repro_torch.models import moe as TMoe
from repro_torch.models import sharding as Sh
from repro_torch.models import transformer as Tf
from repro_torch.optim import adamw as TA

HERE = os.path.dirname(os.path.abspath(__file__))
WORKER_PATH = os.path.join(HERE, "dist", "torch_train_conformance.py")
SRC = os.path.join(os.path.dirname(HERE), "src")
LIMIT_S = 600
# tests/test_torch_lm_train.py's tolerances and leaf rule
LOSS_RTOL, GNORM_RTOL = 2e-3, 2e-2
M_RTOL, V_RTOL = 1e-2, 2e-2
SURE_FRAC, STEP_TOL, LOOSE_SHARE = 0.05, 1e-3, 0.02
# that module's enc-dec branch: the moments of an enc-dec stack against
# the other package within twice M_RTOL / V_RTOL (at world 1 the two
# packages' bf16 gradients through the encoder and the cross-attention
# lie up to 1.26 % of a leaf's largest apart in m); at the mesh each
# package's layout moves them too (reduced Seamless's encoder w_in: the
# port 0.71-1.05 % from its world 1, the reference 0.73 % from its own)
ENCDEC_MOMENTS = 2
# the enc-dec branch of that module's rule, taken by the enc-dec cases
# and by the MoE cases against the reference: an expert's leaves see a
# few rows of the batch, and at capacity 1.25 2.04 % of all elements step
# beyond STEP_TOL lr, nearly all with |g| < SIGN_G, where a first AdamW
# step is no sign
SIGN_G = 2e-6
# a near tie: the router's probabilities of two picks this close; past
# the first layer the packages' inputs differ by bf16 roundings
TIE_GAP = 1e-4

_spec = importlib.util.spec_from_file_location("torch_train_conformance",
                                               WORKER_PATH)
W = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(W)
MOE_CASES = [n for n, c in W.CASES.items() if c[2] is not None]
NODROP_CASES = [n for n, c in W.CASES.items() if c[2] != 1.25]


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Two intra-op threads, as tests/test_torch_lm_train.py, for the
    module's fixtures too (the world-1 steps run in this process)."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _flatten(tree, prefix, out):
    for k, v in tree.items():
        if isinstance(v, dict):
            _flatten(v, f"{prefix}/{k}", out)
        else:
            out[f"{prefix}/{k}"] = np.asarray(v)


def _start(args, env_extra=None):
    env = {k: v for k, v in os.environ.items() if not k.startswith("REPRO_")}
    env.update(PYTHONPATH=SRC, **(env_extra or {}))
    return subprocess.Popen([sys.executable, *args], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)


def _finish(procs):
    try:
        for proc, what in procs:
            try:
                out, _ = proc.communicate(timeout=LIMIT_S)
            except subprocess.TimeoutExpired:
                proc.kill()
                out, _ = proc.communicate()
                raise AssertionError(f"{what} hung past {LIMIT_S} s:\n"
                                     f"{out[-3000:]}")
            assert proc.returncode == 0, f"{what} failed:\n{out[-3000:]}"
    finally:
        for proc, _ in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()


def world1_state(cfg, tree):
    """The port's world-1 masters of the reference's weights and AdamW's
    initial state."""
    params = TM.params_from_jax(tree, cfg, "cpu", master=True)
    return params, TA.init(TA.flatten_params(params),
                           TA.AdamWConfig(**W.OPT))


CLI = ["--arch", "lm100m", "--reduced", "--device", "cpu", "--batch", "2",
       "--seq", "32", "--log-every", "0"]
DRILL = ["--mesh", "data=2,model=2", "--steps", "4", "--ckpt-every", "2"]
# launch.train at two batch axes, 2 steps of 4 rows (one or two a batch
# rank): pod x data, and pod without data, where no leaf is cut
POD_MESHES = ("pod=2,data=2,model=1", "pod=2,data=1,model=1")
POD_RUN = ["--steps", "2", "--ckpt-every", "2", "--batch", "4"]


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def started(tmp_path_factory):
    """Every run of the module, started together: the worker on each
    side, whose results are ``step``: (weights, JAX results, port
    results, each rank's moments); four ``--coordinator`` ranks started
    by hand, whose last checkpoint is in ``coord``; and, in this process
    while those run, ``launch.train.main --mesh data=2,model=2`` for 4
    steps with a checkpoint every 2, plainly and with ``--fail-at 2``:
    ``drill`` maps each to (its history, its checkpoint directory)."""
    tmp = tmp_path_factory.mktemp("train_mesh")
    flat = {}
    for arch in W.ARCHS:
        _flatten(JM.init_params(jax.random.PRNGKey(0),
                                W.reduced(JC.get_reduced, arch)), arch, flat)
    np.savez(tmp / "weights.npz", **flat)
    ckpt = tmp / "ckpt"
    cfg = W.config(TC.get_reduced, "lm100m/tp")
    Ck.save(str(ckpt), 0, world1_state(cfg, W.unflatten(flat, "lm100m")))
    want_path, got_path = tmp / "jax.npz", tmp / "torch.npz"
    routes = str(tmp / "routes.npz")
    procs = [(_start([WORKER_PATH, "jax", str(want_path),
                      str(tmp / "weights.npz"), routes],
                     {"XLA_FLAGS": "--xla_force_host_platform_device_count="
                      f"{W.WORLD}", "JAX_PLATFORMS": "cpu"}), "jax reference")]
    procs += [(_start([WORKER_PATH, "torch", str(got_path),
                       str(tmp / "weights.npz"), routes, str(rank),
                       str(tmp / "store"), str(ckpt)]), f"torch rank {rank}")
              for rank in range(W.WORLD)]
    port = _free_port()
    for rank in range(4):
        env = {"RANK": str(rank), "WORLD_SIZE": "4", "LOCAL_RANK": "0",
               "OMP_NUM_THREADS": "1"}
        procs.append((_start(["-m", "repro_torch.launch.train", *CLI,
                              *DRILL, "--coordinator", f"localhost:{port}",
                              "--ckpt-dir", str(tmp / "coord")], env),
                      f"coordinator rank {rank}"))
    # the launcher at pod x data: each run's last checkpoint in pod/<mesh>
    for mesh in POD_MESHES:
        procs.append((_start(["-m", "repro_torch.launch.train", *CLI,
                              "--mesh", mesh, *POD_RUN, "--ckpt-dir",
                              str(tmp / "pod" / mesh)]), f"--mesh {mesh}"))
    drill = {}
    try:
        for what, extra in (("plain", []), ("failed", ["--fail-at", "2"])):
            d = str(tmp / what)
            drill[what] = (Tr.main(CLI + DRILL + ["--ckpt-dir", d] + extra),
                           d)
    except BaseException:
        for proc, _ in procs:
            proc.kill()
            proc.wait()
        raise
    _finish(procs)
    ranks = [dict(np.load(f"{got_path}.rank{r}.npz"))
             for r in range(W.WORLD)]
    return {"step": (flat, dict(np.load(want_path)),
                     dict(np.load(got_path)), ranks),
            "drill": drill, "coord": tmp / "coord", "pod": tmp / "pod",
            "mesh_ckpt": {t: tmp / f"ckpt_{t}"
                          for t in W.MESH_CKPTS.values()}}


@pytest.fixture(scope="module")
def runs(started):
    return started["step"]


@pytest.fixture(scope="module")
def drill(started):
    return started["drill"]


def pinned_routes(ids, rows: int, model: int):
    """A world-1 ``moe._route`` for microbatches of ``rows`` rows that
    picks, for MoE layer ``L`` (counted by its router in the forward's
    order) of microbatch ``i`` (counted by its forward calls; a recompute
    picks as its forward did), the experts ``ids[L]`` (B, S, k) of those
    rows, and returns the reference's auxiliary loss at the mesh: the
    mean over the ``model`` blocks of the sequence of each block's ``E *
    sum(frac * pmean)``."""
    layers, calls, current = {}, {}, {}

    def route(router, x2, top_k):
        L = layers.setdefault(router.data_ptr(), len(layers))
        if not TMoe._recomputing:
            current[L] = calls.get(L, 0)
            calls[L] = current[L] + 1
        i = current[L]
        pick = torch.from_numpy(ids[L][i * rows:(i + 1) * rows])
        Bn, Sn, _ = pick.shape
        probs = torch.softmax(x2.float() @ router.float(), dim=-1)
        flat = pick.reshape(-1, top_k).long()
        vals = torch.gather(probs, 1, flat)
        w = vals / torch.clamp(vals.sum(dim=-1, keepdim=True), min=1e-9)
        E = router.shape[1]
        p3 = probs.reshape(Bn, Sn, E)
        s = Sn // model
        auxes = []
        for m in range(model):
            first = pick[:, m * s:(m + 1) * s, 0].reshape(-1).long()
            frac = torch.nn.functional.one_hot(first, E).float().mean(dim=0)
            auxes.append(E * torch.sum(
                frac * p3[:, m * s:(m + 1) * s].reshape(-1, E).mean(dim=0)))
        return w, flat.to(torch.int32), torch.stack(auxes).mean()
    return route


def mesh_axes(name):
    """(data ranks, model ranks) of case ``name``'s mesh."""
    sizes = W.MESHES[W.CASES[name][3]]
    return sizes["data"], sizes["model"]


def mesh_ids(got, name, cfg):
    """The sharded step's routed ids of each MoE layer in world-1 token
    layout (B, S, k)."""
    D, Mm = mesh_axes(name)
    B = W.rows_of(name)
    b, s = B // D, W.S // Mm
    out = []
    for layer in range(W.n_moe(cfg)):
        ids = np.zeros((B, W.S, cfg.top_k), np.int32)
        for d in range(D):
            for m in range(Mm):
                ids[d * b:(d + 1) * b, m * s:(m + 1) * s] = \
                    got[f"{name}/ids/{layer}/{d}/{m}"].reshape(b, s, -1)
        out.append(ids)
    return out


def world1_micro(name):
    """The microbatches of case ``name``'s world-1 step: one a batch rank
    (each rank's bf16 gradients rounded and then summed in float32, as
    the microbatches' are); one where a dense MoE layer's aux is the whole
    batch's (model 1 under a mesh, as the reference's compiler takes it),
    which one microbatch a rank would not give."""
    cfg = W.config(TC.get_reduced, name)
    sizes = W.MESHES[W.CASES[name][3]]
    if cfg.n_experts and sizes["model"] == 1:
        return 1
    return sizes.get("pod", 1) * sizes["data"]


@pytest.fixture(scope="module")
def world1(runs):
    """The port's world-1 step of every case that drops nothing, in
    :func:`world1_micro` microbatches; MoE layers at a sharded model axis
    pinned to the sharded step's routes (:func:`pinned_routes`), and at
    model 1 to the reference's, which the sharded step took."""
    flat, want, got, _ = runs
    out = {}
    for name in NODROP_CASES:
        arch, _, cf, _ = W.CASES[name]
        D = world1_micro(name)
        cfg = W.config(TC.get_reduced, name)
        cfg = dataclasses.replace(cfg, train=dataclasses.replace(
            cfg.train, microbatches=D))
        params, opt = world1_state(cfg, W.unflatten(flat, arch))
        batch = {k: torch.from_numpy(v) for k, v in W.batch_of(
            cfg, lm_batch_at, W.rows_of(name)).items()}
        route = TMoe._route
        if cf is not None:
            TMoe._route = pinned_routes(mesh_ids(got, name, cfg),
                                        W.rows_of(name) // D,
                                        mesh_axes(name)[1])
        elif name in W.DENSE_MOE_CASES:     # the reference's, as the mesh's
            TMoe._route = W.pin_routes([want[f"{name}/ids/{L}"] for L in
                                        range(W.n_moe(cfg))], {})
        try:
            new, opt, met = TM.make_train_step(
                cfg, None, TA.AdamWConfig(**W.OPT))(params, opt, batch)
        finally:
            TMoe._route = route
        res = {f"met/{k}": v.numpy() for k, v in met.items()}
        res.update({f"new/{k}": v.numpy()
                    for k, v in TA.flatten_params(new).items()})
        for what in ("m", "v"):
            res.update({f"{what}/{k}": v.numpy()
                        for k, v in opt[what].items()})
        out[name] = res
    return out


def leaves(res, prefix, what):
    """``what`` (new, m or v) -> {leaf path: array} of one result."""
    head = f"{prefix}{what}/"
    return {k[len(head):]: v for k, v in res.items() if k.startswith(head)}


def leaf_rule(got, want, lr, layout_noise=None, sign_g=None,
              encdec_moments=False):
    """tests/test_torch_lm_train.py's rule for one step: AdamW moments
    within M_RTOL / V_RTOL of the leaf's largest, every parameter within
    2 lr + 1e-6, the elements whose gradient is at least SURE_FRAC of the
    leaf's largest within STEP_TOL lr, at most LOOSE_SHARE of all beyond
    it.  ``got`` and ``want`` map new / m / v to {leaf: array}.  With
    ``layout_noise`` ({(moment, leaf): share}) a moment may also lie
    within twice that share of the leaf's largest (see
    :func:`reference_layout_noise`).  With ``sign_g``, as that module's
    enc-dec branch, only the elements whose gradient is at least
    ``sign_g`` count for the last two (a first AdamW step is lr g / (|g|
    + eps): lr sign(g) only where |g| >> eps).  With ``encdec_moments``
    (an enc-dec stack against the reference) a moment lies within that
    branch's ``ENCDEC_MOMENTS`` times M_RTOL / V_RTOL, what the two
    packages may differ by at world 1, plus the reference's own layout
    move instead."""
    assert sorted(got["new"]) == sorted(want["new"])
    loose = total = 0
    for k, w in want["new"].items():
        for moment, tol in (("m", M_RTOL), ("v", V_RTOL)):
            noise = 0.0 if layout_noise is None \
                else layout_noise[(moment, k)]
            tol = ENCDEC_MOMENTS * tol + noise if encdec_moments \
                else max(tol, 2 * noise)
            ref = want[moment][k]
            merr = float(np.abs(got[moment][k] - ref).max())
            assert merr <= tol * float(np.abs(ref).max()), (k, moment, merr)
        err = np.abs(got["new"][k] - w)
        assert float(err.max()) <= 2 * lr + 1e-6, (k, float(err.max()))
        gm = np.abs(want["m"][k])
        # the elements whose step is lr sign(g) (m = 0.1 g)
        sign_like = np.ones(gm.shape, bool) if sign_g is None \
            else gm >= 0.1 * sign_g
        sure = sign_like & (gm >= SURE_FRAC * gm.max())
        assert float(err[sure].max(initial=0)) <= STEP_TOL * lr, \
            (k, float(err[sure].max(initial=0)) / lr)
        loose += int((err[sign_like] > STEP_TOL * lr).sum())
        total += int(sign_like.sum())
    assert loose <= LOOSE_SHARE * total, (loose, total)


def result(res, prefix=""):
    return {w: leaves(res, prefix, w) for w in ("new", "m", "v")}


def reference_layout_noise(want, name):
    """{(moment, leaf): how far the reference's own moments at the mesh
    lie from its world-1 step's, as a share of the leaf's largest}: the
    bf16 gradients of each rank's rows are rounded before the ranks sum
    them, so the layout alone moves a moment; on the reduced models this
    is up to 1.6 % (qwen1.5-110b's ``wk.b``), beyond ``M_RTOL``.  The
    port at the mesh is held to the reference at the mesh, and to its own
    world-1 step, within the leaf rule's tolerances or within twice the
    reference's own move.  None for the cases with MoE layers, whose
    auxiliary loss at the mesh is another function than at world 1 (they
    meet the leaf rule's tolerances)."""
    if name in MOE_CASES:
        return None
    out = {}
    for moment in ("m", "v"):
        for k, mesh in leaves(want, f"{name}/", moment).items():
            w1 = want[f"{name}/world1/{moment}/{k}"]
            out[(moment, k)] = float(np.abs(mesh - w1).max()) \
                / float(np.abs(w1).max())
    return out


def sign_g(name, cfg):
    """The leaf rule's ``sign_g`` for a case: its enc-dec branch for an
    enc-dec config (as ``tests/test_torch_lm_train.py`` holds it at world
    1) and, against the reference, for the MoE cases."""
    return SIGN_G if cfg.is_encdec or name in MOE_CASES else None


def rel(got, want):
    return abs(float(got) - float(want)) / abs(float(want))


def same_routes(got, want, name, cfg):
    """{(MoE layer, data, model): whether that rank routed every row as
    the reference did}."""
    D, Mm = mesh_axes(name)
    return {(L, d, m): np.array_equal(got[f"{name}/ids/{L}/{d}/{m}"],
                                      want[f"{name}/ids/{L}/{d}/{m}"])
            for L in range(W.n_moe(cfg)) for d in range(D)
            for m in range(Mm)}


@pytest.mark.parametrize("name", W.REFERENCE_CASES)
def test_step_matches_reference(runs, name):
    _, want, got, _ = runs
    cfg = W.config(TC.get_reduced, name)
    for k, tol in (("loss", LOSS_RTOL), ("grad_norm", GNORM_RTOL)):
        assert rel(got[f"{name}/met/{k}"], want[f"{name}/met/{k}"]) <= tol, \
            (k, float(got[f"{name}/met/{k}"]), float(want[f"{name}/met/{k}"]))
    assert float(got[f"{name}/met/lr"]) == pytest.approx(
        float(want[f"{name}/met/lr"]), rel=1e-6)
    if name in MOE_CASES:
        # the port's ranks routed as the reference did (pinned)
        assert all(same_routes(got, want, name, cfg).values())
    if cfg.n_experts:
        assert rel(got[f"{name}/met/moe_aux"],
                   want[f"{name}/met/moe_aux"]) <= LOSS_RTOL
    else:
        assert float(got[f"{name}/met/moe_aux"]) == 0 \
            == float(want[f"{name}/met/moe_aux"])
    leaf_rule(result(got, f"{name}/"), result(want, f"{name}/"),
              float(want[f"{name}/met/lr"]),
              reference_layout_noise(want, name), sign_g(name, cfg),
              encdec_moments=cfg.is_encdec or cfg.family == "hybrid")


@pytest.mark.parametrize("name", W.PINNED_CASES)
def test_own_routes_match_reference(runs, name):
    """The port's own top-k, under the reference's routes, picks the
    reference's experts on every row of at least one layer, and other
    experts (or another order) only at near ties."""
    _, _, got, _ = runs
    cfg = W.config(TC.get_reduced, name)
    D, Mm = mesh_axes(name)
    keys = [(L, d, m) for L in range(W.n_moe(cfg))
            for d in range(D) for m in range(Mm)]
    for key in keys:
        rows = int(got[f"{name}/own_differ/%d/%d/%d" % key])
        gap = float(got[f"{name}/own_gap/%d/%d/%d" % key])
        assert gap <= TIE_GAP, (key, rows, gap)
    assert any(all(int(got[f"{name}/own_differ/{L}/{d}/{m}"]) == 0
                   for d in range(D) for m in range(Mm))
               for L in range(W.n_moe(cfg)))


@pytest.mark.parametrize("name", NODROP_CASES)
def test_step_matches_world1(runs, world1, name):
    _, want, got, _ = runs
    w1 = world1[name]
    cfg = W.config(TC.get_reduced, name)
    for k, tol in (("loss", LOSS_RTOL), ("grad_norm", GNORM_RTOL),
                   ("moe_aux", LOSS_RTOL)):
        g, w = float(got[f"{name}/met/{k}"]), float(w1[f"met/{k}"])
        assert abs(g - w) <= tol * abs(w), (k, g, w)
    # Jamba's hybrid stack: the enc-dec branch with its moment tolerance
    # (tests/test_torch_lm_train.py: each layout's bf16 moments lie up to
    # 2-3 % of a leaf's largest from the float32 step's)
    hybrid = cfg.family == "hybrid"
    leaf_rule(result(got, f"{name}/"), result(w1),
              float(w1["met/lr"]), reference_layout_noise(want, name),
              SIGN_G if cfg.is_encdec or hybrid else None,
              encdec_moments=hybrid)


def test_fsdp_matches_tp(runs):
    """``fsdp_tp`` and ``tp`` at the same mesh route alike (the same
    forward numbers) and give the same step by the leaf rule."""
    check_fsdp_matches_tp(runs, "granite-moe-3b-a800m/fsdp_tp/5")


def test_jamba_fsdp_matches_tp(runs):
    """The same for reduced Jamba's period stack: each sub-layer gathers
    its own 2D leaves over data in the forward and the recompute of its
    period."""
    check_fsdp_matches_tp(runs, "jamba-1.5-large-398b/fsdp_tp/5")


def check_fsdp_matches_tp(runs, fsdp):
    _, _, got, _ = runs
    tp = W.FSDP_MOE_CASES[fsdp]
    cfg = W.config(TC.get_reduced, tp)
    assert all(same_routes({k.replace(fsdp, tp): v for k, v in got.items()
                            if k.startswith(fsdp)}, got, tp, cfg).values())
    for k in ("loss", "moe_aux"):
        assert float(got[f"{fsdp}/met/{k}"]) == float(got[f"{tp}/met/{k}"])
    assert rel(got[f"{fsdp}/met/grad_norm"], got[f"{tp}/met/grad_norm"]) \
        <= GNORM_RTOL
    leaf_rule(result(got, f"{fsdp}/"), result(got, f"{tp}/"),
              float(got[f"{tp}/met/lr"]))


@pytest.mark.parametrize("name", [n for n in MOE_CASES
                                  if n in W.REFERENCE_CASES])
def test_dropped_rows_match_reference(runs, name):
    _, want, got, _ = runs
    cfg = W.config(TC.get_reduced, name)
    total = 0
    for L, d, m in same_routes(got, want, name, cfg):
        key = f"{name}/dropped/{L}/{d}/{m}"
        # the port's log is what its ranks counted past the capacity
        assert int(got[f"{name}/log_dropped/{L}/{d}/{m}"]) == int(got[key])
        assert int(got[key]) == int(want[key]), (L, d, m)
        total += int(want[key])
    assert (total > 0) == (W.CASES[name][2] == 1.25), total


@pytest.mark.parametrize("name", NODROP_CASES)
def test_zero1_moments_are_2d_slices(runs, world1, name):
    flat, want, got, ranks = runs
    noise = reference_layout_noise(want, name)
    cfg = W.config(TC.get_reduced, name)
    arch, flavor, _, mesh_name = W.CASES[name]
    shapes = TA.flatten_params(W.unflatten(flat, arch))
    mesh = W.MESHES[mesh_name]
    for r in range(W.WORLD):
        coord, rest = {}, r
        for a in reversed(list(mesh)):
            coord[a], rest = rest % mesh[a], rest // mesh[a]
        policy = Sh.make_policy(Me.abstract_mesh(mesh, coord), flavor)
        for what, rtol in (("m", M_RTOL), ("v", V_RTOL)):
            for k, whole in shapes.items():
                tol = rtol if noise is None \
                    else max(rtol, 2 * noise[(what, k)])
                if cfg.family == "hybrid":      # as test_step_matches_world1
                    tol = ENCDEC_MOMENTS * rtol
                spec = Sh.with_kv_heads(policy.leaf_spec(k, whole.ndim, True),
                                        k, cfg, policy.world_m)
                idx = Sh.shard_slices(whole.shape, spec, mesh, coord)
                mine = ranks[r][f"{name}/{what}/{k}"]
                np.testing.assert_array_equal(
                    mine, got[f"{name}/{what}/{k}"][idx])
                ref = world1[name][f"{what}/{k}"]
                assert float(np.abs(mine - ref[idx]).max(initial=0)) \
                    <= tol * float(np.abs(ref).max()), (r, what, k)
    # the data and model axes cut each rank's moments of a 2D-cut leaf;
    # a pod holds them whole
    leaf = {W.MAMBA: "layers.mamba.in_proj.w",
            W.JAMBA: "layers.sub1.attn.wq.w"}.get(arch, "layers.attn.wq.w")
    m0 = ranks[0][f"{name}/m/{leaf}"]
    assert m0.size * mesh["data"] * mesh["model"] == shapes[leaf].size


@pytest.mark.parametrize("label", [label for label, _, _ in W.LAYOUTS])
def test_mamba_layout_round_trip(runs, label):
    """Reduced falcon-mamba-7b's training state at ``2x2`` under both
    flavors and at ``1x4``: ``StateLayout.whole`` of every rank's slices
    gives back each whole leaf bit for bit (``in_proj`` in the
    reference's ``[x | z]`` order), ``StateLayout.local`` of the whole
    leaves gives each rank's slices bit for bit, and the data axis's
    gathers (``gather_data``, ``Zero1.local``, ``Zero1.whole``) take
    ``in_proj``'s per-part model cut as it is (the worker's
    ``layout_cases``)."""
    _, _, got, _ = runs
    check_layout(got, W.MAMBA, label)


def check_layout(got, arch, label):
    for check in ("whole", "local", "gather_data", "zero1"):
        ok = got[f"{W.layout_key(arch, label)}/{check}"]
        assert len(ok) == W.WORLD and ok.all(), (check, ok)


@pytest.mark.parametrize("label", [label for label, _, _ in W.LAYOUTS])
def test_seamless_layout_round_trip(runs, label):
    """Reduced seamless-m4t-large-v2's training state (the ``encoder``
    subtree, the decoder's ``cross`` and ``ln_cross``) through the same
    round trips: the spec table reads those leaves by name, and nothing
    else is needed."""
    _, _, got, _ = runs
    check_layout(got, W.SEAMLESS, label)


def test_mamba_mesh_checkpoint_restores_at_world1_in_both_packages(
        started):
    """The checkpoint reduced falcon-mamba-7b's ranks wrote after their
    ``tp`` step at ``2x2`` holds whole leaves: the port and the reference
    restore it at world 1, each to the arrays on disk bit for bit, and
    its parameters and moments are the step's, gathered by
    ``StateLayout`` (which ``test_step_matches_reference`` holds to the
    reference's step)."""
    check_mesh_checkpoint(started, W.MAMBA)


def test_seamless_mesh_checkpoint_restores_at_world1_in_both_packages(
        started):
    """The same for reduced seamless-m4t-large-v2's ``tp`` step: the
    encoder's leaves among the whole leaves, restored at world 1 in both
    packages."""
    check_mesh_checkpoint(started, W.SEAMLESS)


def test_pod_mesh_checkpoint_restores_at_world1_in_both_packages(started):
    """The same for reduced granite-3-2b's ``tp`` step at ``pod=2, data=2,
    model=1``: the moments cut over data are gathered over it alone, and
    a pod's copies are not gathered."""
    check_mesh_checkpoint(started, W.GRANITE, "pod", "pod/granite-3-2b/tp")


@pytest.mark.parametrize("label",
                         [label for label, _, _ in W.LAYOUTS_OF[W.JAMBA]])
def test_jamba_layout_round_trip(runs, label):
    """Reduced Jamba's training state (its ``sub{j}`` level: Mamba, MoE
    and attention sub-layers, stacked over the periods) through the same
    round trips: the spec table reads its leaves by name, and the level
    between is transparent."""
    _, _, got, _ = runs
    check_layout(got, W.JAMBA, label)


def test_jamba_mesh_checkpoint_restores_at_world1_in_both_packages(
        started):
    """The checkpoint reduced Jamba's ranks wrote after their ``tp`` step
    at ``2x2``: whole leaves under ``sub{j}``, restored at world 1 in both
    packages."""
    check_mesh_checkpoint(started, W.JAMBA, name=f"{W.JAMBA}/tp/5")


@pytest.mark.parametrize("label",
                         [label for label, _, _ in W.LAYOUTS_OF[W.GRANITE]])
def test_granite_layout_round_trip(runs, label):
    """Reduced granite-3-2b's training state at ``pod=2, data=2, model=1``
    under both flavors (the 2D cut over data, whole over pod) and at
    ``1x4``, where two model ranks share each KV head (``KVHeads``: a
    whole leaf takes one copy of each head's columns, and each rank's
    slice is its head's), through the round trips of the worker's
    ``layout_cases``."""
    _, _, got, _ = runs
    check_layout(got, W.GRANITE, label)


def check_mesh_checkpoint(started, arch, tag=None, name=None):
    _, _, got, _ = started["step"]
    d = str(started["mesh_ckpt"][tag or arch])
    name = name or f"{arch}/tp"
    arrays = _arrays(os.path.join(d, "step_1"))
    cfg = TC.get_reduced(arch)
    params = TM.init_params(torch.Generator().manual_seed(0), cfg,
                            master=True)
    template = (params, TA.init(TA.flatten_params(params), TA.AdamWConfig()))
    step, (new, opt) = Ck.restore(d, template)
    assert step == 1
    assert _bits_equal([t.numpy() for t in Ck.tree_leaves((new, opt))],
                       arrays)
    for k, v in TA.flatten_params(new).items():
        np.testing.assert_array_equal(v.numpy(), got[f"{name}/new/{k}"])
    for what in ("m", "v"):
        for k, v in opt[what].items():
            np.testing.assert_array_equal(v.numpy(),
                                          got[f"{name}/{what}/{k}"])
    jparams = JM.init_params(jax.random.PRNGKey(0), JC.get_reduced(arch))
    step, jstate = JCk.restore(d, (jparams, JA.init(jparams,
                                                    JA.AdamWConfig())))
    assert step == 1
    assert _bits_equal([np.asarray(a) for a in
                        jax.tree_util.tree_leaves(jstate)], arrays)


def test_world1_checkpoint_restores_at_mesh(runs):
    _, _, got, _ = runs
    assert got["ckpt/world1_restored"].all()
    assert got["ckpt/roundtrip"].all()


# --------------------------------------------------------------------------
# the launcher: --mesh drill, restores across worlds, --coordinator
# --------------------------------------------------------------------------

def _arrays(path):
    with np.load(os.path.join(path, "arrays.npz")) as f:
        return [f[f"a{i}"] for i in range(len(f.files))]


def _bits_equal(a, b):
    return len(a) == len(b) and all(
        x.dtype == y.dtype and x.shape == y.shape
        and np.array_equal(x.reshape(-1).view(np.uint8),
                           y.reshape(-1).view(np.uint8))
        for x, y in zip(a, b))


def test_train_mesh_drill_is_bit_identical(drill):
    (plain, pd), (failed, fd) = drill["plain"], drill["failed"]
    assert [h["step"] for h in plain] == [1, 2, 3, 4]
    # the restart resumes from step 2's checkpoint
    assert [h["step"] for h in failed] == [3, 4]
    keys = ("loss", "grad_norm", "lr")
    assert [[h[k] for k in keys] for h in failed] == \
        [[h[k] for k in keys] for h in plain[2:]]
    assert _bits_equal(_arrays(os.path.join(pd, "step_4")),
                       _arrays(os.path.join(fd, "step_4")))


def test_mesh_checkpoint_restores_at_world1_in_both_packages(drill):
    """The data=2,model=2 run's last checkpoint holds whole leaves: the
    port restores it at world 1 in one process, and so does the
    reference, each to the arrays on disk bit for bit."""
    _, d = drill["plain"]
    arrays = _arrays(os.path.join(d, "step_4"))
    cfg = TC.get_reduced("lm100m")
    params = TM.init_params(torch.Generator().manual_seed(0), cfg,
                            master=True)
    template = (params, TA.init(TA.flatten_params(params), TA.AdamWConfig()))
    step, state = Ck.restore(d, template)
    assert step == 4
    assert _bits_equal([t.numpy() for t in Ck.tree_leaves(state)], arrays)
    jcfg = JC.get_reduced("lm100m")
    jparams = JM.init_params(jax.random.PRNGKey(0), jcfg)
    jtemplate = (jparams, JA.init(jparams, JA.AdamWConfig()))
    step, jstate = JCk.restore(d, jtemplate)
    assert step == 4
    assert _bits_equal([np.asarray(a) for a in
                        jax.tree_util.tree_leaves(jstate)], arrays)


@pytest.mark.parametrize("mesh", POD_MESHES)
def test_pod_mesh_launcher_checkpoint_restores_at_world1(started, mesh):
    """``launch.train --mesh`` over two batch axes (rank processes on the
    CPU): its last checkpoint holds whole leaves, which the port restores
    at world 1 in one process and the reference too, each to the arrays
    on disk bit for bit.  At ``pod=2, data=1`` no leaf is cut (the
    reference's ``_dd`` names ``data``, of one rank), so every moment is
    whole on each rank; a layout that cut them over the pods would save
    half of each as if whole."""
    d = str(started["pod"] / mesh)
    arrays = _arrays(os.path.join(d, "step_2"))
    cfg = TC.get_reduced("lm100m")
    params = TM.init_params(torch.Generator().manual_seed(0), cfg,
                            master=True)
    template = (params, TA.init(TA.flatten_params(params), TA.AdamWConfig()))
    # every leaf whole: the parameters' and the moments' shapes at world 1
    assert [a.shape for a in arrays] == \
        [tuple(t.shape) for t in Ck.tree_leaves(template)]
    step, state = Ck.restore(d, template)
    assert step == 2
    assert _bits_equal([t.numpy() for t in Ck.tree_leaves(state)], arrays)
    jparams = JM.init_params(jax.random.PRNGKey(0), JC.get_reduced("lm100m"))
    step, jstate = JCk.restore(d, (jparams, JA.init(jparams,
                                                    JA.AdamWConfig())))
    assert step == 2
    assert _bits_equal([np.asarray(a) for a in
                        jax.tree_util.tree_leaves(jstate)], arrays)


def test_train_coordinator_matches_mesh(started):
    """Four ranks started by hand and joined through ``--coordinator``
    end as the drill's ``--mesh data=2,model=2`` run does, bit for
    bit."""
    _, d = started["drill"]["plain"]
    assert _bits_equal(_arrays(started["coord"] / "step_4"),
                       _arrays(os.path.join(d, "step_4")))


@pytest.mark.parametrize("arch,what", [("falcon-mamba-7b", "Mamba"),
                                       ("seamless-m4t-large-v2", "encoder"),
                                       ("internvl2-2b", "vision")])
def test_world_gt1_training_refuses_the_next_slice(arch, what):
    """A Mamba stack, an enc-dec config and a vision config are accepted
    at (data 2, model 1), (1, 2) and (2, 2), in serving and in training
    (their steps are held to the reference by
    :func:`test_step_matches_reference`).  ``launch.train`` refuses the
    encoder and vision configs at every world, before any rank starts:
    its batches carry no frames or patch embeddings."""
    cfg = TC.get_reduced(arch)
    shapes = ({"data": 2, "model": 1}, {"data": 1, "model": 2},
              {"data": 2, "model": 2})
    for shape in shapes:
        policy = Sh.make_policy(Me.abstract_mesh(shape))
        for train in (False, True):
            Tf.check_supported(cfg, policy, train=train)
        TM.make_train_step(cfg, policy, TA.AdamWConfig())
        TM.make_prefill(cfg, policy, decode_len=8)
    if what == "Mamba":
        return
    inputs = "frames" if what == "encoder" else "patch embeddings"
    for mesh in ([], ["--mesh", "data=2,model=1"]):
        with pytest.raises(ValueError, match=inputs):
            Tr.main(["--arch", arch, "--reduced", "--device", "cpu",
                     *mesh])


def test_serving_at_data_gt1_is_refused_training_is_not():
    """Serving and training accept a data axis of several ranks, a second
    batch axis (``pod`` x ``data``: ``test_step_matches_reference`` holds
    the pod cases to the reference) and, in training, KV heads that do
    not split over the model axis (the ``1x4`` and ``kv1`` cases), and a
    period stack (Jamba) at all of them."""
    cfg = TC.get_reduced("granite-moe-3b-a800m")
    policy = Sh.make_policy(Me.abstract_mesh({"data": 2, "model": 2}))
    Tf.check_supported(cfg, policy, train=True)
    Tf.check_supported(cfg, policy)
    TM.make_prefill(cfg, policy, decode_len=8)
    pods = Sh.make_policy(Me.abstract_mesh({"pod": 2, "data": 2,
                                            "model": 1}))
    for train in (False, True):
        Tf.check_supported(cfg, pods, train=train)
    TM.make_train_step(cfg, pods, TA.AdamWConfig())
    lm = dataclasses.replace(TC.get_reduced("granite-3-2b"), n_kv_heads=1)
    Tf.check_supported(lm, policy, train=True)
    TM.make_train_step(lm, policy, TA.AdamWConfig())
    jamba = TC.get_reduced("jamba-1.5-large-398b")
    for p in (policy, pods, Sh.make_policy(Me.abstract_mesh(
            {"data": 1, "model": 4}))):
        for train in (False, True):
            Tf.check_supported(jamba, p, train=train)
        TM.make_train_step(jamba, p, TA.AdamWConfig())
