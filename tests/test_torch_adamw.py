"""AdamW in place: ``optim.adamw.update(..., donate=True)`` writes the
new parameters, moments and step into the tensors it is given, with the
bits of the update that made new tensors
(``tests/dist/torch_dp_conformance.py:update_before``, the formula as it
was); ``donate=False`` leaves its inputs as they were.  The train step
passes ``donate`` through (``launch/train.py`` donates, as the
reference's launcher).  With ``sharding.Zero1`` over four ranks:
``tests/test_torch_serve_dp.py``."""
import importlib.util
import os

import numpy as np
import pytest
import torch

from repro_torch import configs as TC
from repro_torch.data.synthetic import lm_batch_at
from repro_torch.models import model as TM
from repro_torch.optim import adamw as A

HERE = os.path.dirname(os.path.abspath(__file__))
_spec = importlib.util.spec_from_file_location(
    "torch_dp_conformance", os.path.join(HERE, "dist",
                                         "torch_dp_conformance.py"))
W = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(W)


def seeded_tree(seed=0):
    """Leaves whose names take and skip weight decay (``scale``, ``b``)."""
    rng = np.random.default_rng(seed)

    def a(*shape):
        return rng.normal(size=shape).astype(np.float32)
    return {"embed": {"embed": a(32, 8)},
            "layers": {"attn": {"wq": {"w": a(2, 8, 16), "b": a(2, 16)}},
                       "ln1": {"scale": a(2, 8)}},
            "final_norm": {"scale": a(8)}}


def test_update_in_place_matches_before():
    same, kept = W.adamw_case(seeded_tree())
    assert same and kept


def test_update_without_donate_leaves_its_inputs():
    cfg = A.AdamWConfig(lr=1e-2, warmup_steps=1, total_steps=3)
    params = {k: torch.from_numpy(v) for k, v in
              A.flatten_params(seeded_tree()).items()}
    state = A.init(params, cfg)
    gen = torch.Generator().manual_seed(1)
    grads = {k: torch.randn(p.shape, generator=gen)
             for k, p in params.items()}
    before = A.copy_state(params, state)
    new_p, new_s, _ = A.update(params, grads, state, cfg)
    for k in params:
        assert torch.equal(params[k], before[0][k])
        assert new_p[k].data_ptr() != params[k].data_ptr()
    assert torch.equal(state["step"], before[1]["step"])
    got = A.update(before[0], grads, before[1], cfg, donate=True)
    for k in params:
        assert torch.equal(got[0][k], new_p[k])
        assert torch.equal(got[1]["m"][k], new_s["m"][k])
        assert torch.equal(got[1]["v"][k], new_s["v"][k])


@pytest.mark.parametrize("arch", ["lm100m", "granite-moe-3b-a800m"])
def test_train_step_donates_in_place(arch):
    cfg = TC.get_reduced(arch)
    opt_cfg = A.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=2)
    params = TM.init_params(torch.Generator().manual_seed(0), cfg,
                            master=True)
    opt = A.init(A.flatten_params(params), opt_cfg)
    batch = {k: torch.from_numpy(v) for k, v in
             lm_batch_at(0, vocab=cfg.vocab, batch=2, seq=16).items()}
    kept = A.copy_state(A.flatten_params(params), opt)
    new, nopt, met = TM.make_train_step(cfg, None, opt_cfg)(params, opt,
                                                           batch)
    for k, p in A.flatten_params(params).items():     # left as they were
        assert torch.equal(p, kept[0][k]), k
    ptrs = [p.data_ptr() for p in A.flatten_params(params).values()]
    dnew, dopt, dmet = TM.make_train_step(cfg, None, opt_cfg, donate=True)(
        params, opt, batch)
    assert [p.data_ptr() for p in A.flatten_params(dnew).values()] == ptrs
    assert dopt["m"] is opt["m"] and dopt["step"] is opt["step"]
    assert float(dmet["loss"]) == float(met["loss"])
    for k, p in A.flatten_params(new).items():
        assert torch.equal(A.flatten_params(dnew)[k], p), k
        assert torch.equal(dopt["m"][k], nopt["m"][k]), k
        assert torch.equal(dopt["v"][k], nopt["v"][k]), k
