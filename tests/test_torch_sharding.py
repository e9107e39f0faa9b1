"""The port's sharding policy against the JAX package's, on the CPU
without process groups (the sharded path at world 2 is
``tests/test_torch_tp.py``).

* ``param_specs``: the port's spec of every leaf of every reduced arch
  (shapes from ``jax.eval_shape`` of the reference's ``init_params``)
  equals the reference's, under both flavors and ``for_opt``, with each
  policy from ``make_policy``'s axis discovery on the same axis names.
* ``make_policy``'s axis discovery on four meshes.
* ``shard_params`` at model = 2 (and at data = 2 x model = 2 under
  ``fsdp_tp``): the ranks' slices, put back along the dims their specs
  name, give back every leaf bit for bit; reduced granite-3-2b with one
  KV head: each rank's ``wk``/``wv`` are the columns of the KV head its
  q heads read.
* Rank memory: at model = 2 each rank's bytes are the sum of its shards
  and a sharded leaf's shards sum to the whole.
* What the slice refuses at world > 1, with the ROADMAP item it waits
  for, and what it accepts (Mamba, encoder and vision configs); what
  ``launch.train --mesh`` and ``--coordinator`` refuse.
* ``launch.serve --mesh data=1,model=2 --device cpu``: two rank
  processes serve reduced granite-moe and reduced falcon-mamba-7b, and
  ``--mesh data=1,model=1`` serves in-process.
* ``make_debug_mesh`` / ``make_production_mesh``: the reference's axis
  names, and the sizes they refuse outside a process group.
"""
import dataclasses
import functools
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
from jax.sharding import AxisType

from repro import configs as JC
from repro.models import model as JM
from repro.models.sharding import make_policy as jax_make_policy
from repro_torch import configs as TC
from repro_torch.launch import mesh as Me
from repro_torch.launch import train as Tr
from repro_torch.models import model as TM
from repro_torch.models import sharding as Sh
from repro_torch.models import transformer as Tf
from repro_torch.optim import adamw as TA

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MESHES = {"data,model": {"data": 1, "model": 1},
          "pod,data,model": {"pod": 1, "data": 1, "model": 1},
          "rows": {"rows": 1},
          "rows,cols": {"rows": 1, "cols": 1}}


@functools.cache
def shapes(arch):
    """The reference's parameter shapes of a reduced arch."""
    cfg = JC.get_reduced(arch)
    return jax.eval_shape(lambda k: JM.init_params(k, cfg),
                          jax.random.PRNGKey(0))


def jax_mesh(axes):
    shape = MESHES[axes]
    return jax.make_mesh(tuple(shape.values()), tuple(shape),
                         axis_types=(AxisType.Auto,) * len(shape))


def to_tuples(tree):
    """The reference's PartitionSpecs as tuples."""
    return {k: to_tuples(v) if isinstance(v, dict) else tuple(v)
            for k, v in tree.items()}


@pytest.mark.parametrize("for_opt", [False, True])
@pytest.mark.parametrize("flavor", ["tp", "fsdp_tp"])
@pytest.mark.parametrize("arch", JC.ARCH_IDS)
def test_param_specs_match_reference(arch, flavor, for_opt):
    for axes in ("data,model", "pod,data,model"):
        want = jax_make_policy(jax_mesh(axes), flavor).param_specs(
            shapes(arch), for_opt=for_opt)
        got = Sh.make_policy(Me.abstract_mesh(MESHES[axes]),
                             flavor).param_specs(shapes(arch),
                                                 for_opt=for_opt)
        assert got == to_tuples(want)


@pytest.mark.parametrize("axes", list(MESHES))
def test_make_policy_axis_discovery(axes):
    want = jax_make_policy(jax_mesh(axes), "fsdp_tp")
    got = Sh.make_policy(Me.abstract_mesh(MESHES[axes]), "fsdp_tp")
    assert got.model_axis == want.model_axis
    assert got.batch_axes == want.batch_axes
    assert Sh.make_policy(None).mesh is None


def numpy_tree(tree, seed=0):
    rng = np.random.default_rng(seed)
    return {k: numpy_tree(v, seed) if isinstance(v, dict)
            else rng.normal(size=v.shape).astype(np.float32)
            for k, v in tree.items()}


def reassemble(parts, shape, spec, sizes, coords):
    """Put the ranks' slices of one leaf back together (NaN where no
    rank's slice lands)."""
    out = np.full(shape, np.nan, np.float32)
    for part, coord in zip(parts, coords):
        idx = Sh.shard_slices(shape, spec, sizes, coord)
        out[idx] = part
    return out


def coords_of(sizes):
    out = [{}]
    for a, n in sizes.items():
        out = [dict(c, **{a: i}) for c in out for i in range(n)]
    return out


@pytest.mark.parametrize("sizes,flavor", [({"data": 1, "model": 2}, "tp"),
                                          ({"data": 2, "model": 2},
                                           "fsdp_tp")])
@pytest.mark.parametrize("arch", JC.ARCH_IDS)
def test_shard_params_concat_gives_back_the_tree(arch, sizes, flavor):
    tree = numpy_tree(shapes(arch))
    policy = Sh.make_policy(Me.abstract_mesh(sizes), flavor)
    specs = policy.param_specs(tree)
    coords = coords_of(sizes)
    parts = [Sh.shard_params(tree, policy, c) for c in coords]

    def walk(node, spec, ps):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, spec[k], [p[k] for p in ps])
                continue
            back = reassemble([p[k] for p in ps], v.shape, spec[k], sizes,
                              coords)
            np.testing.assert_array_equal(back, v, err_msg=k)
            if any(a is not None for a in spec[k]):
                assert ps[0][k].size < v.size, k

    walk(tree, specs, parts)


def test_grouped_kv_heads_hold_what_their_q_heads_read():
    cfg = dataclasses.replace(TC.get_reduced("granite-3-2b"), n_kv_heads=1)
    params = TM.init_params(torch.Generator().manual_seed(0), cfg)
    policy = Sh.make_policy(Me.abstract_mesh({"data": 1, "model": 2}),
                            "fsdp_tp")
    wk = params["layers"]["attn"]["wk"]["w"]
    wq = params["layers"]["attn"]["wq"]["w"]
    for r in range(2):
        part = Sh.shard_params(params, policy, {"data": 0, "model": r},
                               cfg=cfg)
        assert Sh.kv_head_block(cfg.n_heads, cfg.n_kv_heads, 2, r) == (0, 1)
        assert torch.equal(part["layers"]["attn"]["wk"]["w"], wk)
        half = wq.shape[-1] // 2
        assert torch.equal(part["layers"]["attn"]["wq"]["w"],
                           wq[..., r * half:(r + 1) * half])
    with pytest.raises(ValueError, match="unevenly"):
        Sh.kv_head_block(6, 3, 2, 0)     # 3 q heads across groups of 2
    with pytest.raises(ValueError, match="split"):
        Sh.kv_head_block(5, 1, 2, 0)


@pytest.mark.parametrize("arch", ["granite-moe-3b-a800m", "granite-3-2b"])
def test_rank_memory_is_its_shards(arch):
    cfg = TC.get_reduced(arch)
    params = TM.init_params(torch.Generator().manual_seed(0), cfg)
    sizes = {"data": 1, "model": 2}
    policy = Sh.make_policy(Me.abstract_mesh(sizes), "fsdp_tp")
    specs = policy.param_specs(params)

    def leaves(tree, spec):
        for k, v in tree.items():
            if isinstance(v, dict):
                yield from leaves(v, spec[k])
            else:
                yield v, spec[k]

    ranks = [Sh.shard_params(params, policy, c) for c in coords_of(sizes)]
    whole = list(leaves(params, specs))
    per = [[t for t, _ in leaves(r, specs)] for r in ranks]
    rank_bytes = [sum(t.numel() * t.element_size() for t in p) for p in per]
    for i, (t, spec) in enumerate(whole):
        nbytes = [p[i].numel() * p[i].element_size() for p in per]
        for r, c in enumerate(coords_of(sizes)):
            idx = Sh.shard_slices(t.shape, spec, sizes, c)
            assert nbytes[r] == t[idx].numel() * t.element_size()
        if "model" in spec:
            assert sum(nbytes) == t.numel() * t.element_size()
        else:
            assert nbytes == [t.numel() * t.element_size()] * 2
    total = sum(t.numel() * t.element_size() for t, _ in whole)
    assert max(rank_bytes) < total <= sum(rank_bytes)


@pytest.mark.parametrize("arch,sizes,what", [
    ("falcon-mamba-7b", {"data": 1, "model": 2}, "Mamba"),
    ("seamless-m4t-large-v2", {"data": 1, "model": 2}, "encoder"),
    ("internvl2-2b", {"data": 1, "model": 2}, "vision"),
    ("granite-3-2b", {"pod": 2, "data": 2, "model": 1}, "data axis")])
def test_sharded_path_refuses_the_next_slice(arch, sizes, what):
    """A Mamba stack, an encoder config and a vision config are accepted
    at (data 2, model 1), (1, 2) and (2, 2), and a second batch axis
    (pod 2 x data 2) at model 1 and 2, in serving and in training, under
    both flavors; the train step and the prefill build there.  A period
    stack (Jamba) is accepted at the same meshes, and its train step and
    prefill build there too."""
    cfg = TC.get_reduced(arch)
    shapes = ({"data": 2, "model": 1}, {"data": 1, "model": 2},
              {"data": 2, "model": 2})
    if what == "data axis":
        shapes = (sizes, dict(sizes, model=2))
    for shape in shapes:
        for flavor in ("tp", "fsdp_tp"):
            policy = Sh.make_policy(Me.abstract_mesh(shape), flavor)
            for train in (False, True):
                Tf.check_supported(cfg, policy, train=train)
            if what == "data axis":
                TM.make_train_step(cfg, policy, None)
                TM.make_prefill(cfg, policy, decode_len=8)
    jamba = TC.get_reduced("jamba-1.5-large-398b")
    for shape in shapes:
        for flavor in ("tp", "fsdp_tp"):
            policy = Sh.make_policy(Me.abstract_mesh(shape), flavor)
            for train in (False, True):
                Tf.check_supported(jamba, policy, train=train)
            TM.make_train_step(jamba, policy, None)
            TM.make_prefill(jamba, policy, decode_len=8)


def _abstract_policies(sizes, flavor):
    """The policy of every rank of an abstract mesh of ``sizes``."""
    names = list(sizes)
    out = []
    for r in range(int(np.prod(list(sizes.values())))):
        coord, rest = {}, r
        for a in reversed(names):
            coord[a] = rest % sizes[a]
            rest //= sizes[a]
        out.append(Sh.make_policy(Me.abstract_mesh(sizes, coord), flavor))
    return out


def test_pod_without_data_cuts_nothing():
    """At pod 2 x data 1 x model 1 the reference's ``_dd`` names
    ``data``, of one rank: no leaf is cut and nothing is gathered, under
    ``fsdp_tp`` (``gather_data`` returns its tree, every leaf whole) and
    for ZeRO-1 (``Zero1`` holds whole moments, the layout names no axis
    of several ranks), while the rows split over the two pods."""
    cfg = TC.get_reduced("granite-moe-3b-a800m")
    tree = TM.init_params(torch.Generator().manual_seed(0), cfg,
                          master=True)
    flat = TA.flatten_params(tree)
    sizes = {"pod": 2, "data": 1, "model": 1}
    for policy in _abstract_policies(sizes, "fsdp_tp"):
        assert not policy.fsdp and policy.world_fsdp == 1
        assert policy.world_d == 2
        held = Sh.shard_params(tree, policy, cfg=cfg)
        got = TA.flatten_params(Sh.gather_data(held, policy))
        assert all(torch.equal(got[k], v) for k, v in flat.items())
        assert Sh.batch_block(policy, 4) == slice(2 * policy.batch_rank,
                                                  2 * policy.batch_rank + 2)
    for policy in _abstract_policies(sizes, "tp"):
        zero = Sh.Zero1(policy, flat, cfg)
        assert zero.D == 1
        assert all(zero.local(k, p) is p for k, p in flat.items())
        assert all(zero.counted(k) == (policy.batch_rank == 0)
                   for k in flat)
        opt = TA.init(flat, TA.AdamWConfig())
        layout = Sh.train_state_layout(policy, tree, opt, cfg)
        assert all(sizes[a] == 1 for spec in layout.specs for e in spec
                   for a in Sh._axes(e))


@pytest.mark.parametrize("sizes", [{"pod": 2, "data": 2, "model": 1},
                                   {"pod": 2, "data": 1, "model": 2},
                                   {"pod": 2, "data": 2, "model": 2}])
def test_batch_rank_is_pod_major(sizes):
    """A rank's block of a batch's rows follows its index over pod x
    data, pod major (the reference's ``P(("pod", "data"))``); the 2D
    weight dim and the ZeRO-1 moments follow ``data`` alone, and a leaf
    is counted in the global norm on pod 0 only."""
    D = sizes["pod"] * sizes["data"]
    cfg = TC.get_reduced("granite-3-2b")
    flat = TA.flatten_params(TM.init_params(
        torch.Generator().manual_seed(0), cfg, master=True))
    for policy in _abstract_policies(sizes, "fsdp_tp"):
        c = policy.mesh.coord
        assert policy.batch_rank == c["pod"] * sizes["data"] + c["data"]
        assert policy.world_d == D
        assert Sh.batch_block(policy, 2 * D) == slice(
            2 * policy.batch_rank, 2 * policy.batch_rank + 2)
        assert Sh.batch_block(policy, D + 1) == slice(0, D + 1)
        assert policy.fsdp == (sizes["data"] > 1)
        assert policy.fsdp_rank == (c["data"] if sizes["data"] > 1 else 0)
        zero = Sh.Zero1(policy, flat, cfg)
        assert zero.D == sizes["data"]
        if c["pod"]:
            assert not any(zero.counted(k) for k in flat)


def test_mesh_refuses_data_before_pod():
    with pytest.raises(ValueError, match="pod major"):
        Me.make_mesh({"data": 1, "pod": 1, "model": 1})


@pytest.mark.parametrize("sizes,holders", [
    ({"data": 1, "model": 4}, [0, 2]),
    ({"data": 2, "model": 2}, [0])])
def test_shared_kv_heads_are_counted_once(sizes, holders):
    """Reduced granite-3-2b's 2 KV heads over 4 model ranks (and one KV
    head over 2): the ranks whose q heads read a KV head hold its
    columns (``KVHeads``, from ``with_kv_heads``), and only the first of
    them counts it in the global norm; ``wq`` as before."""
    cfg = TC.get_reduced("granite-3-2b")
    if sizes["model"] == 2:
        cfg = dataclasses.replace(cfg, n_kv_heads=1)
    tree = TM.init_params(torch.Generator().manual_seed(0), cfg,
                          master=True)
    for policy in _abstract_policies(sizes, "tp"):
        held = TA.flatten_params(Sh.shard_params(tree, policy, cfg=cfg))
        zero = Sh.Zero1(policy, held, cfg)
        m = policy.model_rank
        for k in ("layers.attn.wk.w", "layers.attn.wv.w"):
            spec = zero.spec[k]
            assert isinstance(spec[-1], Sh.KVHeads) and spec[-1] == "model"
            h0, nh = Sh.kv_head_block(cfg.n_heads, cfg.n_kv_heads,
                                      policy.world_m, m)
            assert held[k].shape[-1] == nh * cfg.d_head
            # the 2D leaf's moments are cut over data: each data rank
            # counts its rows
            assert zero.counted(k) == (m in holders)
        assert zero.counted("layers.attn.wq.w")


@pytest.mark.parametrize("multi_pod", [False, True])
def test_production_meshes_train_what_they_serve(multi_pod):
    """On ``make_production_mesh``'s shapes, (16, 16) and (2, 16, 16),
    ``check_supported(train=True)`` accepts every config that it accepts
    for serving (KV heads shared by model ranks included), Jamba's
    period stack among them."""
    shape = {"pod": 2, "data": 16, "model": 16} if multi_pod \
        else {"data": 16, "model": 16}
    served = []
    for arch in TC.ARCH_IDS:
        cfg = TC.get_config(arch)
        for flavor in ("tp", "fsdp_tp"):
            policy = Sh.make_policy(Me.abstract_mesh(shape), flavor)
            try:
                Tf.check_supported(cfg, policy)
            except NotImplementedError:
                assert cfg.attn_period > 1 or cfg.moe_period > 1, arch
                with pytest.raises(NotImplementedError):
                    Tf.check_supported(cfg, policy, train=True)
                continue
            except ValueError:
                with pytest.raises(ValueError):
                    Tf.check_supported(cfg, policy, train=True)
                continue
            Tf.check_supported(cfg, policy, train=True)
            served.append(arch)
    for arch in ("granite-3-2b", "qwen1.5-110b", "mistral-large-123b",
                 "qwen3-moe-235b-a22b", "internvl2-2b",
                 "jamba-1.5-large-398b"):
        assert arch in served, arch


@pytest.mark.parametrize("flag", ["--mesh", "--coordinator"])
def test_train_refuses_mesh_and_coordinator(flag, monkeypatch):
    """Both flags train (tests/test_torch_train_mesh.py); they refuse
    before any rank starts: an enc-dec stack, whose frames the
    launcher's batches do not carry (at every world, as the reference's
    launcher has none), and ``--coordinator`` without the rank's
    environment (``RANK``, ``WORLD_SIZE``, as torchrun sets them)."""
    if flag == "--mesh":
        with pytest.raises(ValueError, match="frames"):
            Tr.main(["--arch", "seamless-m4t-large-v2", "--reduced",
                     "--device", "cpu", flag, "data=1,model=2"])
        return
    for var in ("RANK", "WORLD_SIZE"):
        monkeypatch.delenv(var, raising=False)
    with pytest.raises(SystemExit, match="RANK"):
        Tr.main(["--arch", "lm100m", "--reduced", "--device", "cpu", flag,
                 "localhost:1"])


@pytest.mark.parametrize("arch,mesh", [
    pytest.param("granite-moe-3b-a800m", "data=1,model=2",
                 id="data=1,model=2"),
    pytest.param("granite-moe-3b-a800m", "data=1,model=1",
                 id="data=1,model=1"),
    pytest.param("falcon-mamba-7b", "data=1,model=2",
                 id="falcon-mamba-7b-data=1,model=2")])
def test_serve_cli_mesh_on_the_cpu(arch, mesh):
    env = {k: v for k, v in os.environ.items() if not k.startswith("REPRO_")}
    env["PYTHONPATH"] = os.path.join(REPO, "src")
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         arch, "--reduced", "--device", "cpu",
         "--requests", "6", "--slots", "2", "--prompt-len", "8", "--gen",
         "4", "--mesh", mesh], env=env, capture_output=True, text=True,
        timeout=300)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    assert "serve OK" in proc.stdout
    assert proc.stdout.count("serve OK") == 1      # rank 0 prints
    if mesh.endswith("2"):
        assert "x 2 ranks" in proc.stdout


def test_mesh_factories_match_reference_axes():
    """The port's mesh factories carry the reference's axis names in its
    order; outside a process group they form a mesh of one rank and
    refuse any other size."""
    from repro.launch import mesh as JMe
    for kw in ({}, {"pod": 1}):
        got = Me.make_debug_mesh(data=1, model=1, **kw)
        want = JMe.make_debug_mesh(data=1, model=1, **kw)
        assert got.axis_names == tuple(want.axis_names)
        assert got.shape == dict(want.shape) and got.size == 1
        assert got.coord == {a: 0 for a in got.axis_names}
        assert all(g is None for g in got.groups.values())
    with pytest.raises(ValueError, match="needs 8 ranks"):
        Me.make_debug_mesh()
    for multi_pod, n in ((False, 256), (True, 512)):
        with pytest.raises(ValueError, match=f"needs {n} ranks"):
            Me.make_production_mesh(multi_pod=multi_pod)


def test_parse_mesh():
    assert Me.parse_mesh("data=1,model=2") == {"data": 1, "model": 2}
    with pytest.raises(ValueError, match="name=size"):
        Me.parse_mesh("data=1,model")
