"""The port's meta-device dry-run (``repro_torch/launch/{specs,dryrun}.py``)
against the JAX package's specs, on the CPU:

* specs: for every arch x cell on both production meshes (16 x 16 and
  2 x 16 x 16), each parameter, AdamW moment, batch and cache leaf that
  rank 0 of the port holds has the per-device shape and dtype of the
  reference's ``NamedSharding.shard_shape`` on an ``AbstractMesh``, but
  the leaves of :data:`BY_DESIGN`, whose per-rank bytes are held to the
  ratio each names; the cells the port refuses (:data:`REFUSED`) raise
  with their refusal's words;
* the reduced config of every arch builds its train, prefill and decode
  steps on ``meta`` tensors at world 1 and at data = 2 x model = 2 (the
  ``fake`` backend), with ``ok`` records carrying the reference's
  roofline fields, and leaves no process group;
* a reduced dense train step counts 6 N tokens + attention FLOPs
  exactly (without remat; with it the forward's twice), and rank 0's at
  data = 2 x model = 2, times 4, equals world 1's;
* a reduced Falcon-Mamba train step at 5 scan chunks counts on ``meta``
  (the 3 middle chunks of each scan run once, counted 3 times) exactly
  the FLOPs, bytes and ops that the same step counts on CPU tensors,
  where every chunk runs;
* Granite-3.0-2B's decode_32k at full width on 16 x 16 is ``ok`` and
  raises the process's peak RSS by less than 1 GB (nothing allocated);
* the CLI records a refused cell with its words, writes its own file and
  not the reference's ``results/dryrun.json``.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import AbstractMesh

from repro import configs as JC
from repro.launch import specs as JS
from repro.models.sharding import make_policy as jax_make_policy
from repro.optim import adamw as JAw
from repro_torch import configs as TC
from repro_torch.configs import ShapeCell
from repro_torch.launch import dryrun as Dr
from repro_torch.launch import mesh as Me
from repro_torch.launch import specs as SP
from repro_torch.models import model as TM
from repro_torch.models import transformer as Tf
from repro_torch.optim import adamw as TAw
from repro_torch.roofline import cost as Cost

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PRODUCTION = {"16x16": {"data": 16, "model": 16},
              "2x16x16": {"pod": 2, "data": 16, "model": 16}}
# the cells the port refuses on both production meshes, with the words:
# the reference pads uneven shards, the port splits heads evenly
REFUSED = {"minitron-4b": "24 attention heads do not split over a model "
                          "axis of 16",
           "granite-moe-3b-a800m": "24 attention heads do not split over "
                                   "a model axis of 16"}
# leaves whose per-rank layout differs from the reference's by design,
# with the reason; their per-rank bytes are held to the ratio
# :func:`expected` gives
BY_DESIGN = {
    "bf16": "serving holds the matmul weights, the MoE experts and the "
            "embedding as bf16 (the reference casts its float32 masters at "
            "every use): half the bytes",
    "kv_heads": "where the KV heads do not split over model, each model "
                "rank holds the whole KV head its q heads read "
                "(sharding.KVHeads), not 1/16 of the columns",
    "cache": "the caches cut the KV heads over model (each rank its "
             "heads, or its one shared head) where the reference cuts the "
             "sequence",
    "serving_batch": "the prefill and decode functions take the whole "
                     "batch on every rank and run their block of rows",
}


def flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        path = f"{prefix}.{k}" if prefix else k
        if isinstance(v, dict):
            out.update(flat(v, path))
        else:
            out[path] = v
    return out


def ref_leaf(s):
    """(per-device shape, dtype name) of a reference stand-in."""
    shape = tuple(s.shape) if s.sharding is None \
        else tuple(s.sharding.shard_shape(s.shape))
    return shape, str(s.dtype)


def port_leaf(t):
    return tuple(t.shape), str(t.dtype).replace("torch.", "")


def nbytes(shape, dtype):
    n = 1
    for d in shape:
        n *= d
    return n * {"float32": 4, "bfloat16": 2, "int32": 4}[dtype]


def expected(path, ref, cfg, cell, sizes):
    """(the shape and dtype rank 0 of the port holds for the reference's
    per-device ``ref`` at ``path``, the :data:`BY_DESIGN` reasons, the
    ratio of the per-rank bytes they give)."""
    shape, dtype = ref
    names = path.split(".")
    kind = JC.SHAPES[cell].kind
    world_m = sizes["model"]
    world_d = sizes["data"] * sizes.get("pod", 1)
    reasons, r = [], 1.0
    if names[0] == "params" and kind != "train" \
            and TM._is_matmul_weight(names[-2], names[-1], len(shape)):
        dtype, r = "bfloat16", r * 0.5
        reasons.append("bf16")
    if names[0] in ("params", "opt_state") and len(names) > 2 \
            and names[-2] in ("wk", "wv") \
            and cfg.n_kv_heads % world_m:
        # one KV head, where the reference holds n_kv / world_m heads
        r *= cfg.d_head / shape[-1]
        shape = shape[:-1] + (cfg.d_head,)
        reasons.append("kv_heads")
    if names[0] == "caches" and names[-1] in ("k", "v", "ck", "cv"):
        L, b, H, S, D = shape
        heads = H // world_m if H % world_m == 0 else 1
        r *= heads * world_m / H
        shape = (L, b, heads, S * world_m, D)
        reasons.append("cache")
    if ((names[0] == "batch" and kind == "prefill") or names[0] == "tokens") \
            and shape[0] < JC.SHAPES[cell].global_batch:
        shape = (shape[0] * world_d,) + shape[1:]
        r *= world_d
        reasons.append("serving_batch")
    return (shape, dtype), reasons, r


@pytest.mark.parametrize("mesh", list(PRODUCTION))
@pytest.mark.parametrize("arch", JC.ARCH_IDS)
def test_specs_match_reference_shard_shapes(arch, mesh):
    sizes = PRODUCTION[mesh]
    jmesh = AbstractMesh(tuple(sizes.values()), tuple(sizes))
    jcfg, cfg = JC.get_config(arch), TC.get_config(arch)
    for cell in JC.cells_for(arch):
        kind = JC.SHAPES[cell].kind
        flavor = cfg.train.sharding if kind == "train" else "fsdp_tp"
        jsp = JS.input_specs(jcfg, cell, jax_make_policy(jmesh, flavor),
                             JAw.AdamWConfig(
                                 moment_dtype=jcfg.train.opt_dtype))
        policy = Dr.cell_policy(cfg, cell, Me.abstract_mesh(sizes))
        if arch in REFUSED:
            with pytest.raises(ValueError, match=REFUSED[arch]):
                Tf.check_supported(cfg, policy, train=kind == "train")
            continue
        sp = SP.input_specs(cfg, cell, policy)
        want = {k: ref_leaf(v) for k, v in flat(
            {k: v for k, v in jsp.items() if k != "kind"}).items()}
        got = {k: port_leaf(v) for k, v in flat(
            {k: v for k, v in sp.items() if k != "kind"}).items()}
        assert set(got) == set(want), (cell, set(got) ^ set(want))
        if kind == "decode":
            assert sp["cache_len"].device.type == "cpu"
        reasons = set()
        for path, ref in want.items():
            exp, why, r = expected(path, ref, cfg, cell, sizes)
            assert got[path] == exp, (cell, path, got[path], ref)
            assert nbytes(*got[path]) == r * nbytes(*ref), (cell, path)
            reasons.update(why)
        assert reasons <= set(BY_DESIGN)
    assert arch in REFUSED or SP.resident(sp)["total_bytes"] > 0


def small(kind):
    """A cell of ``kind`` at test size."""
    return {"train": ShapeCell("train_4k", 64, 8, "train"),
            "prefill": ShapeCell("prefill_32k", 96, 4, "prefill"),
            "decode": ShapeCell("decode_32k", 96, 8, "decode")}[kind]


FIELDS = ("compute_s", "memory_s", "collective_s", "bound", "model_flops",
          "mfu", "flops_per_dev")


@pytest.mark.parametrize("arch", JC.ARCH_IDS)
def test_reduced_steps_build_at_world_1_and_2x2(arch):
    cfg = TC.get_reduced(arch)
    for shape in (None, {"data": 2, "model": 2}):
        for kind in ("train", "prefill", "decode"):
            rec = Dr.measure(cfg, small(kind), shape)
            assert rec["ok"] and not dist.is_initialized()
            for field in FIELDS:
                assert field in rec, (kind, field)
            assert rec["compute_s"] > 0
            assert rec["bound"] in ("compute", "memory", "collective")
            assert 0 < rec["mfu"] <= 1 and rec["memory_per_dev"][
                "total_bytes"] > 0
            assert (rec["collective_s"] > 0) == (shape is not None)
            if kind == "prefill" and cfg.n_heads:
                assert rec["kernels"]["flash_attention"]["calls"] > 0


def analytic_train_flops(cfg, B, S, remat):
    """6 N T + the attention's 12 B Hq S^2 D a layer (the plain full
    attention computes every score), N the matmul weights (the tied head
    counted as the embedding), and the head's product once more
    (``model.ce_loss`` recomputes each chunk's logits in the backward);
    with remat every layer's forward once more too, but its last product
    (``w_down``), whose output no backward reads: the non-reentrant
    checkpoint stops its recompute before it."""
    params = TM.init_params(SP._SHAPES_ONLY, cfg, master=True)
    n = sum(v.numel() for k, v in flat(params).items()
            if k.endswith(".w") or (k == "embed.embed"
                                    and cfg.tie_embeddings))
    head = cfg.padded_vocab() * cfg.d_model
    T = B * S
    layers = 2 * (n - head) * T \
        + 4 * B * cfg.n_heads * S * S * cfg.d_head * cfg.n_layers
    total = 3 * (layers + 2 * head * T) + 2 * head * T
    last = 2 * cfg.d_model * cfg.d_ff * T * cfg.n_layers
    return total + layers - last if remat else total


@pytest.mark.parametrize("remat", ["none", "full"])
def test_dense_train_flops_are_analytic(remat):
    import dataclasses
    cfg = TC.get_reduced("granite-3-2b")
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, remat=remat))
    cell = small("train")
    rec = Dr.measure(cfg, cell, None)
    want = analytic_train_flops(cfg, cell.global_batch, cell.seq_len,
                                remat == "full")
    # tolerance: exact (the counter sees every product once)
    assert rec["flops_per_dev"] == pytest.approx(want, rel=1e-9)
    mesh = Dr.measure(cfg, cell, {"data": 2, "model": 2})
    assert 4 * mesh["flops_per_dev"] == pytest.approx(
        rec["flops_per_dev"], rel=1e-9)


def test_mamba_train_counts_equal_every_chunk_run(monkeypatch):
    """The dry-run's repeated scan chunks (``CostCounter.repeated``)
    against the loop run whole: 640 tokens are 5 chunks of the training
    scan's 128.  Tolerance: exact."""
    cfg = TC.get_reduced("falcon-mamba-7b")
    S = 5 * Tf.StackOpts().mamba_chunk
    loops = []
    repeated = Cost.CostCounter.repeated

    def counted(self, n, *args, **kw):
        loops.append(n)
        return repeated(self, n, *args, **kw)

    monkeypatch.setattr(Cost.CostCounter, "repeated", counted)
    rec = Dr.measure(cfg, ShapeCell("train_4k", S, 1, "train"), None)
    # every layer's scan, and again in its recompute (remat "full")
    assert cfg.train.remat == "full" and loops == [3] * 2 * cfg.n_layers
    params = TM.init_params(torch.Generator().manual_seed(0), cfg,
                            master=True)
    opt = TAw.init(TAw.flatten_params(params), SP.opt_config(cfg))
    tok = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (1, S + 1)).astype(np.int32))
    batch = {"tokens": tok[:, :S].contiguous(),
             "labels": tok[:, 1:].contiguous()}
    step = TM.make_train_step(cfg, None, SP.opt_config(cfg), donate=True)
    with Cost.CostCounter() as cc:
        step(params, opt, batch)
    assert len(loops) == 2 * cfg.n_layers     # none on CPU tensors
    assert (rec["flops_per_dev"], rec["bytes_per_dev"], rec["ops"],
            rec["flops_f32_per_dev"]) \
        == (cc.flops, cc.bytes, cc.ops, cc.flops_f32)


RSS = """
import resource, sys
sys.path.insert(0, {src!r})
from repro_torch.launch import dryrun as Dr
import torch.distributed as dist
before = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
rec = Dr.run_cell("granite-3-2b", "decode_32k", False)
after = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
print(rec["ok"], rec["bound"], (after - before) * 1024,
      dist.is_initialized(), rec["memory_per_dev"]["total_bytes"])
"""


def test_full_width_decode_allocates_nothing():
    proc = subprocess.run(
        [sys.executable, "-c", RSS.format(src=os.path.join(REPO, "src"))],
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    ok, bound, grew, initialised, resident = proc.stdout.split()
    assert ok == "True" and initialised == "False"
    assert bound in ("compute", "memory", "collective")
    assert int(grew) < 1 << 30
    assert int(resident) > 2 << 30       # the 32 k caches it did not hold


def test_cli_records_refusals_in_its_own_file(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    out = tmp_path / "d.json"
    Dr.main(["--arch", "granite-moe-3b-a800m", "--cell", "decode_32k",
             "--mesh", "multi", "--out", str(out)])
    Dr.main(["--arch", "granite-moe-3b-a800m", "--cell", "decode_32k",
             "--mesh", "single", "--out", str(out), "--tag", "t"])
    res = json.loads(out.read_text())
    assert set(res) == {"baseline/granite-moe-3b-a800m/decode_32k/2x16x16",
                        "t/granite-moe-3b-a800m/decode_32k/16x16"}
    for rec in res.values():
        assert rec["ok"] is False
        assert REFUSED["granite-moe-3b-a800m"] in rec["error"]
    assert not dist.is_initialized()
    assert not (tmp_path / "results").exists()
    Dr.main(["--arch", "granite-moe-3b-a800m", "--cell", "decode_32k",
             "--mesh", "single"])
    assert json.loads((tmp_path / "results" / "dryrun_torch.json")
                      .read_text())[
        "baseline/granite-moe-3b-a800m/decode_32k/16x16"]["ok"] is False
    assert not (tmp_path / "results" / "dryrun.json").exists()
