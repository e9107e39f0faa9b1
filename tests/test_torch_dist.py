"""The port's distributed join and Table 5 operators at world 2 against
the JAX package at world 2, bit for bit.

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
SRC = os.path.join(os.path.dirname(HERE), "src")
WORLD = 2
LIMIT_S = 600


def _start(args, env_extra=None):
    # default backends on both sides: the cases pick their backends
    # themselves
    env = {k: v for k, v in os.environ.items() if not k.startswith("REPRO_")}
    env.update(PYTHONPATH=SRC, **(env_extra or {}))
    return subprocess.Popen([sys.executable, WORKER, *args], env=env,
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


def test_dist_join_world2_matches_jax(tmp_path):
    want_path, got_path = tmp_path / "jax.npz", tmp_path / "torch.npz"
    store = tmp_path / "store"
    procs = [(_start(["jax", str(WORLD), str(want_path)],
                     {"XLA_FLAGS": "--xla_force_host_platform_device_count="
                      f"{WORLD}", "JAX_PLATFORMS": "cpu"}), "jax reference")]
    procs += [(_start(["torch", str(WORLD), str(got_path), str(rank),
                       str(store)]), f"torch rank {rank}")
              for rank in range(WORLD)]
    try:
        for proc, what in procs:
            _finish(proc, what)
    finally:
        for proc, _ in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    want, got = np.load(want_path), np.load(got_path)
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
