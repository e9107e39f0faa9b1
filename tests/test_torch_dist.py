"""The port's distributed join, Table 5 operators, set operators, UNOMT
pipeline and morsel operators at world 2 against the JAX package at
world 2: bit for bit, but for the UNOMT columns the pipeline scales, whose
float32 sums add in another order in each package and are held to
``|port - jax| <= 2e-5 * (1 + |jax|)``, and the DDP step of the UNOMT
net, whose loss, gradient norm and updated parameters are held to the
same bound.

Two gloo processes meet through a ``file://`` store under ``tmp_path``
with a 120 s timeout on the process group, so a hung collective raises;
the JAX reference runs in its own subprocess with two forced host
devices.  Every process is also killed past ``LIMIT_S`` (the JAX side
compiles one program per case, slowly on a loaded machine), so nothing
can stall the suite.
"""
import os
import subprocess
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
WORKER = os.path.join(HERE, "dist", "torch_join_conformance.py")
SETOP_WORKER = os.path.join(HERE, "dist", "torch_setop_conformance.py")
MORSEL_WORKER = os.path.join(HERE, "dist",
                             "torch_morsel_train_conformance.py")
SRC = os.path.join(os.path.dirname(HERE), "src")
WORLD = 2
LIMIT_S = 600


def _start(args, env_extra=None, worker=WORKER):
    # default backends on both sides: the cases pick their backends
    # themselves
    env = {k: v for k, v in os.environ.items() if not k.startswith("REPRO_")}
    env.update(PYTHONPATH=SRC, **(env_extra or {}))
    return subprocess.Popen([sys.executable, worker, *args], env=env,
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


def _run_both(tmp_path, worker):
    """Run ``worker`` for the JAX package (two forced host devices) and
    as two port ranks; returns (jax results, port results)."""
    want_path, got_path = tmp_path / "jax.npz", tmp_path / "torch.npz"
    store = tmp_path / "store"
    procs = [(_start(["jax", str(WORLD), str(want_path)],
                     {"XLA_FLAGS": "--xla_force_host_platform_device_count="
                      f"{WORLD}", "JAX_PLATFORMS": "cpu"}, worker),
              "jax reference")]
    procs += [(_start(["torch", str(WORLD), str(got_path), str(rank),
                       str(store)], worker=worker), f"torch rank {rank}")
              for rank in range(WORLD)]
    try:
        for proc, what in procs:
            _finish(proc, what)
    finally:
        for proc, _ in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return np.load(want_path), np.load(got_path)


def test_dist_join_world2_matches_jax(tmp_path):
    want, got = _run_both(tmp_path, WORKER)
    assert sorted(want.files) == sorted(got.files)
    for key in want.files:
        a, b = want[key], got[key]
        assert a.dtype == b.dtype, (key, a.dtype, b.dtype)
        if a.dtype == np.float32:
            a, b = a.view(np.int32), b.view(np.int32)
        np.testing.assert_array_equal(a, b, err_msg=key)
    drops = {k: int(want[k]) for k in want.files if k.endswith("/dropped")}
    assert not any(drops.values()), drops
    for case in ("planned/hash", "groupby/hash", "unique/hash", "sort/radix",
                 "repartition", "broadcast/hash"):
        assert len(want[f"{case}/k"]) > 0, case


def test_dist_setops_and_unomt_world2_match_jax(tmp_path):
    want, got = _run_both(tmp_path, SETOP_WORKER)
    assert sorted(want.files) == sorted(got.files)
    scaled = ("concentration",) + tuple(f"rna{j}" for j in range(8))
    for key in want.files:
        a, b = want[key], got[key]
        assert a.dtype == b.dtype and a.shape == b.shape, key
        if key.startswith("unomt/") and key.endswith(scaled):
            a64 = a.astype(np.float64)
            assert np.all(np.abs(b - a64) <= 2e-5 * (1 + np.abs(a64))), key
            continue
        if a.dtype == np.float32:
            a, b = a.view(np.int32), b.view(np.int32)
        np.testing.assert_array_equal(a, b, err_msg=key)
    drops = {k: int(want[k]) for k in want.files if k.endswith("/dropped")}
    assert not any(drops.values()), drops
    for impl in ("sortmerge", "hash"):
        assert len(want[f"unomt/{impl}/drug_id"]) > 400
        assert len(want[f"isin/skewed/{impl}/k"]) > 0
        # subnormal and zero keys met on one rank: one group, not several
        assert len(want[f"subnormal_groupby/"
                        f"{'hash' if impl == 'hash' else 'sort'}/f"]) == 3


def test_dist_morsels_and_ddp_step_world2_match_jax(tmp_path):
    want, got = _run_both(tmp_path, MORSEL_WORKER)
    assert sorted(want.files) == sorted(got.files)
    for key in want.files:
        a, b = want[key], got[key]
        assert a.dtype == b.dtype and a.shape == b.shape, key
        if key.startswith("ddp/"):
            a64 = a.astype(np.float64)
            assert np.all(np.abs(b - a64) <= 2e-5 * (1 + np.abs(a64))), key
            continue
        if a.dtype == np.float32:
            a, b = a.view(np.int32), b.view(np.int32)
        np.testing.assert_array_equal(a, b, err_msg=key)
    drops = {k: int(want[k]) for k in want.files if k.endswith("/dropped")}
    assert not any(drops.values()), drops
    for build in ("resident", "restream"):
        for impl in ("sortmerge", "hash"):
            assert len(want[f"join/{build}/{impl}/k"]) == 2000
    assert len(want["groupby/hash/k"]) == 150
