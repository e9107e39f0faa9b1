"""The port's fault-tolerant runtime (``repro_torch.runtime.trainer``):
one case for each of ``tests/test_trainer.py``'s and
``tests/test_trainer_donation.py``'s, on a small step function, and the
UNOMT restart drill: ``launch.unomt_e2e.main`` with ``--fail-at`` ends
bit-identical to the same call without it.  Restarts are held to the
uninterrupted run bit for bit."""
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.data.synthetic import lm_batch_at as j_lm_batch_at
from repro_torch.checkpoint import save, tree_leaves
from repro_torch.data.synthetic import lm_batch_at
from repro_torch.launch import unomt_e2e
from repro_torch.optim import adamw
from repro_torch.runtime.trainer import (FailureInjector, StepTimeMonitor,
                                         Trainer, run_with_restarts)

VOCAB, BATCH, SEQ = 64, 4, 16
OPT = adamw.AdamWConfig(lr=1e-2, warmup_steps=0, min_lr_ratio=1.0)


@pytest.fixture(autouse=True)
def few_threads():
    """Two intra-op threads: the suite runs six workers on the machine's
    cores, and small ops on more threads each spend most of their time
    waiting for one another."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _loss(params, batch):
    x = F.one_hot(batch["tokens"].long(), VOCAB).float() @ params["w"]
    logits = x @ params["w"].T
    lab = F.one_hot(batch["labels"].long(), VOCAB).float()
    return -torch.mean(torch.sum(F.log_softmax(logits, -1) * lab, -1))


def _make_step():
    def step(state, batch):
        params, opt = state
        leaves = {k: p.detach().requires_grad_(True)
                  for k, p in params.items()}
        loss = _loss(leaves, batch)
        g = dict(zip(leaves, torch.autograd.grad(loss,
                                                 list(leaves.values()))))
        params, opt, m = adamw.update(params, g, opt, OPT)
        return (params, opt), dict(m, loss=loss.detach())

    params = {"w": torch.randn((VOCAB, 32),
                               generator=torch.Generator().manual_seed(0))
              * 0.1}
    return step, (params, adamw.init(params, OPT))


def _batch(s):
    return {k: torch.from_numpy(v) for k, v in
            lm_batch_at(s, vocab=VOCAB, batch=BATCH, seq=SEQ).items()}


def _batches(start):
    def gen():
        s = start
        while True:
            yield _batch(s)
            s += 1
    return gen()


def _assert_bits_equal(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and torch.equal(x, y)


def test_batches_match_reference():
    """The step-addressable data a restart relies on is the reference's."""
    for s in (0, 7, 123):
        got = lm_batch_at(s, vocab=VOCAB, batch=BATCH, seq=SEQ)
        want = j_lm_batch_at(s, vocab=VOCAB, batch=BATCH, seq=SEQ)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])


def test_uninterrupted_run(tmp_path):
    step, state = _make_step()
    tr = Trainer(step_fn=step, ckpt_dir=str(tmp_path), ckpt_every=5)

    def const_batches():
        b = _batch(0)
        while True:
            yield b

    final, hist = tr.run(state, const_batches(), n_steps=20, log_every=0)
    assert len(hist) == 20
    assert hist[-1]["loss"] < hist[0]["loss"]   # overfits a fixed batch


def test_restart_after_failure_is_bit_identical(tmp_path):
    step, state0 = _make_step()
    tr_ref = Trainer(step_fn=step, ckpt_dir=str(tmp_path / "ref"),
                     ckpt_every=5)
    ref_state, ref_hist = tr_ref.run(state0, _batches(0), n_steps=12,
                                     log_every=0)
    # failure at step 7 -> restore the step-5 checkpoint -> resume
    tr = Trainer(step_fn=step, ckpt_dir=str(tmp_path / "fail"), ckpt_every=5,
                 failure=FailureInjector(fail_at=7))
    final_state, hist = run_with_restarts(_batches, tr, state0, n_steps=12,
                                          log_fn=lambda *_: None)
    _assert_bits_equal(ref_state, final_state)
    assert [h["step"] for h in hist] == list(range(6, 13))
    assert [h["loss"] for h in hist] == [h["loss"] for h in ref_hist[5:]]


def test_run_with_restarts_gives_up(tmp_path):
    step, state = _make_step()

    class AlwaysFail(FailureInjector):
        def check(self, s):
            raise RuntimeError("boom")

    tr = Trainer(step_fn=step, ckpt_dir=str(tmp_path), ckpt_every=5,
                 failure=AlwaysFail())
    with pytest.raises(RuntimeError):
        run_with_restarts(_batches, tr, state, n_steps=5, max_restarts=2,
                          log_fn=lambda *_: None)


def test_straggler_monitor():
    mon = StepTimeMonitor(alpha=0.5, threshold=2.0)
    assert mon.record(0, 1.0) is False       # first sample seeds the mean
    assert mon.record(1, 1.1) is False
    assert mon.record(2, 10.0) is True       # 10x the mean -> flagged
    assert mon.stragglers[0][0] == 2
    assert mon.record(3, 1.0) is False


def test_restore_or_init_prefers_checkpoint(tmp_path):
    step, state = _make_step()
    tr = Trainer(step_fn=step, ckpt_dir=str(tmp_path), ckpt_every=2)
    s, _ = tr.run(state, _batches(0), n_steps=4, log_every=0)
    start, restored = tr.restore_or_init(state)
    assert start == 4
    _assert_bits_equal(s, restored)


def test_restart_before_first_checkpoint_with_in_place_steps(tmp_path):
    """A step that updates its state in place (the port's counterpart of
    the reference's donated buffers) changes ``init_state``; a failure
    before the first periodic checkpoint restarts from the step-0
    snapshot, not from that changed state."""
    rng = np.random.default_rng(0)
    X = torch.from_numpy(rng.normal(size=(16, 4)).astype(np.float32))
    y = torch.from_numpy(rng.normal(size=(16,)).astype(np.float32))

    def step_fn(state, batch):
        params, opt = state
        w = params["w"].detach().requires_grad_(True)
        loss = torch.mean((batch["x"] @ w - batch["y"]) ** 2)
        g = torch.autograd.grad(loss, w)[0]
        new, opt, m = adamw.update(params, {"w": g}, opt, OPT)
        params["w"].copy_(new["w"])               # in place
        return (params, opt), dict(m, loss=loss.detach())

    def batches(start):
        while True:
            yield {"x": X, "y": y}

    def state0():
        params = {"w": torch.zeros(4)}
        return (params, adamw.init(params, OPT))

    ref, _ = Trainer(step_fn=step_fn, ckpt_dir=str(tmp_path / "ref"),
                     ckpt_every=100).run(state0(), batches(0), n_steps=6,
                                         log_every=0)
    tr = Trainer(step_fn=step_fn, ckpt_dir=str(tmp_path / "fail"),
                 ckpt_every=100, failure=FailureInjector(fail_at=3))
    state, hist = run_with_restarts(batches, tr, state0(), n_steps=6,
                                    log_fn=lambda *_: None)
    assert len(hist) == 6
    _assert_bits_equal(ref, state)


def test_unomt_drill_is_bit_identical(tmp_path, capsys):
    """``launch.unomt_e2e.main --fail-at 5``: the restart from the step-3
    checkpoint ends with the history and the final (params, opt,
    residuals) of the run without the failure."""
    argv = ["--device", "cpu", "--rows", "100", "--steps", "8",
            "--ckpt-every", "3"]
    ref = unomt_e2e.main(argv + ["--ckpt-dir", str(tmp_path / "ref")])
    # a stale checkpoint of another run is removed, a file of the user's
    # in the directory stays
    save(str(tmp_path / "fail"), 7, {"stale": torch.zeros(1)})
    (tmp_path / "fail" / "notes.txt").write_text("kept")
    got = unomt_e2e.main(argv + ["--ckpt-dir", str(tmp_path / "fail"),
                                 "--fail-at", "5"])
    assert (tmp_path / "fail" / "notes.txt").read_text() == "kept"
    assert "[fault] injected failure at step 5" in capsys.readouterr().out
    keys = ("loss", "grad_norm", "lr")
    assert [h["step"] for h in got] == list(range(4, 9))
    assert [[h[k] for k in keys] for h in got] == \
        [[h[k] for k in keys] for h in ref[3:]]
    final = []
    for d in ("ref", "fail"):
        with np.load(tmp_path / d / "step_8" / "arrays.npz") as f:
            final.append([f[f"a{i}"] for i in range(len(f.files))])
    assert len(final[0]) == len(final[1]) > 3 * 10
    for a, b in zip(*final):
        assert a.dtype == b.dtype and np.array_equal(a, b)
