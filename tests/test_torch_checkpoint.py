"""The port's checkpoint store (``repro_torch.checkpoint``): one case for
each of ``tests/test_checkpoint.py``'s, on tensors, and two across the
packages: a checkpoint ``repro.checkpoint.save`` writes from the
reference's reduced ``lm100m`` ``init_params`` tree (and its AdamW
state) restores into the port's master template with equal arrays, and
the port's restores into the reference's template."""
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro import checkpoint as JCk
from repro.configs import get_reduced as j_reduced
from repro.models import model as JM
from repro.optim import adamw as JA
from repro_torch import checkpoint as Ck
from repro_torch.checkpoint import (AsyncCheckpointer, all_steps,
                                    latest_step, restore, save)
from repro_torch.configs import get_reduced
from repro_torch.models import model as TM
from repro_torch.optim import adamw as TA


def _state(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"params": {"w": torch.randn((8, 4), generator=g),
                       "b": torch.zeros(4)},
            "opt": {"m": torch.ones((8, 4)) * 0.5,
                    "step": torch.tensor(7, dtype=torch.int32)}}


def _trees_equal(a, b):
    fa, fb = Ck.tree_leaves(a), Ck.tree_leaves(b)
    return len(fa) == len(fb) and all(
        x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(fa, fb))


def test_save_restore_roundtrip(tmp_path):
    state = _state()
    save(str(tmp_path), 10, state)
    step, restored = restore(str(tmp_path), state)
    assert step == 10
    assert _trees_equal(state, restored)
    # the template's key order survives (sums over a dict's leaves follow
    # it, so a restart depends on it)
    assert list(restored["params"]) == ["w", "b"]


def test_latest_step_and_gc(tmp_path):
    state = _state()
    for s in (1, 2, 3, 4, 5):
        save(str(tmp_path), s, state, keep_last=3)
    assert latest_step(str(tmp_path)) == 5
    assert all_steps(str(tmp_path)) == [3, 4, 5]


def test_restore_specific_step(tmp_path):
    s1, s2 = _state(1), _state(2)
    save(str(tmp_path), 1, s1)
    save(str(tmp_path), 2, s2)
    step, got = restore(str(tmp_path), s1, step=1)
    assert step == 1
    assert _trees_equal(got, s1)


def test_restore_empty_dir_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        restore(str(tmp_path), _state())


def test_crashed_tmp_dir_is_ignored(tmp_path):
    """A leftover .tmp_step dir (crashed writer) is not listed, nor a
    step dir without its meta."""
    save(str(tmp_path), 1, _state())
    os.makedirs(tmp_path / ".tmp_step_2")
    assert latest_step(str(tmp_path)) == 1
    os.makedirs(tmp_path / "step_99")
    assert latest_step(str(tmp_path)) == 1


def test_clear_removes_only_the_stores_entries(tmp_path):
    """``clear`` (a fresh run's start) removes ``step_<N>`` and
    ``.tmp_step_<N>`` and leaves every other entry of the directory."""
    save(str(tmp_path), 1, _state())
    save(str(tmp_path), 2, _state())
    os.makedirs(tmp_path / ".tmp_step_3")
    os.makedirs(tmp_path / "data" / "step_4")
    (tmp_path / "notes.txt").write_text("kept")
    (tmp_path / "step_5").write_text("a file, not the store's")
    Ck.clear(str(tmp_path))
    assert sorted(os.listdir(tmp_path)) == ["data", "notes.txt", "step_5"]
    assert os.path.isdir(tmp_path / "data" / "step_4")
    assert latest_step(str(tmp_path)) is None
    Ck.clear(str(tmp_path / "missing"))          # no directory: nothing


def test_leaf_count_mismatch_raises(tmp_path):
    save(str(tmp_path), 1, _state())
    with pytest.raises(ValueError, match="leaf count"):
        restore(str(tmp_path), {"only": torch.zeros(2)})


def test_async_checkpointer(tmp_path):
    ckpt = AsyncCheckpointer(str(tmp_path), keep_last=2)
    state = _state()
    for s in (10, 20, 30):
        ckpt.save(s, state)
    ckpt.wait()
    assert ckpt.last_saved == 30
    assert all_steps(str(tmp_path)) == [20, 30]
    _, got = restore(str(tmp_path), state)
    assert _trees_equal(got, state)


def test_async_checkpointer_snapshot_semantics(tmp_path):
    """A CPU tensor changed in place right after save() does not leak
    into the checkpoint (``.cpu()`` of it would be the same storage)."""
    ckpt = AsyncCheckpointer(str(tmp_path))
    w = torch.ones(4)
    ckpt.save(1, {"w": w})
    w.add_(41.0)
    ckpt.wait()
    _, got = restore(str(tmp_path), {"w": torch.zeros(4)})
    assert torch.equal(got["w"], torch.ones(4))


def test_restore_casts_to_template_device_and_dtype(tmp_path):
    save(str(tmp_path), 1, {"w": torch.arange(8, dtype=torch.float32),
                            "n": np.arange(3, dtype=np.int64)})
    template = {"w": torch.zeros(8, dtype=torch.float64, device="cpu"),
                "n": np.zeros(3, np.int32)}
    _, got = restore(str(tmp_path), template)
    assert got["w"].dtype == torch.float64 and got["w"].device.type == "cpu"
    assert torch.equal(got["w"], torch.arange(8, dtype=torch.float64))
    assert got["n"].dtype == np.int32
    np.testing.assert_array_equal(got["n"], np.arange(3))


# --------------------------------------------------------------------------
# across the packages
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def lm_states():
    """The reference's reduced lm100m (params, AdamW state) and the port's
    master template of the same config."""
    jcfg = j_reduced("lm100m")
    jparams = JM.init_params(jax.random.PRNGKey(0), jcfg)
    jstate = (jparams, JA.init(jparams, JA.AdamWConfig()))
    cfg = get_reduced("lm100m")
    params = TM.init_params(torch.Generator().manual_seed(1), cfg,
                            master=True)
    tstate = (params, TA.init(TA.flatten_params(params), TA.AdamWConfig()))
    return jstate, tstate


def test_reference_checkpoint_restores_into_port(tmp_path, lm_states):
    (jparams, jopt), tstate = lm_states
    JCk.save(str(tmp_path), 3, (jparams, jopt))
    step, (params, opt) = restore(str(tmp_path), tstate)
    assert step == 3
    flat = TA.flatten_params(params)
    jflat = {".".join(k.key for k in path): v for path, v in
             jax.tree_util.tree_flatten_with_path(jparams)[0]}
    assert list(flat) == list(jflat)      # the reference's path names
    for (path, got), want in zip(flat.items(), jflat.values()):
        assert got.dtype == torch.float32, path
        np.testing.assert_array_equal(got.numpy(), np.asarray(want), path)
    assert opt["step"].dtype == torch.int32 and int(opt["step"]) == 0


def test_port_checkpoint_restores_into_reference(tmp_path, lm_states):
    jstate, (params, opt) = lm_states
    save(str(tmp_path), 5, (params, opt))
    step, (jparams, jopt) = JCk.restore(str(tmp_path), jstate)
    assert step == 5
    for (path, want), got in zip(TA.flatten_params(params).items(),
                                 jax.tree_util.tree_leaves(jparams)):
        np.testing.assert_array_equal(np.asarray(got), want.numpy(), path)
    assert jopt["step"].dtype == jnp.int32
