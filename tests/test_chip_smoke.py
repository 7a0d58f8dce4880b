"""chip_smoke.py: its phase functions at tiny sizes on the CPU (x64, so
every comparison with the f64 reference is tight), its f64 reference
against the package's oracles, and its refusal to run without a GPU."""

import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

import chip_smoke as cs
from helpers import oracle_synthetic_lambda

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = dict(n=3000, f=16, centers=8, b=64, k=10, alpha=0.9, n_check=32,
             n_lambda=256, seed=5)


@pytest.fixture(scope="module")
def ctx():
    return cs.Ctx("cpu-test")


@pytest.fixture(scope="module")
def built(ctx):
    return cs.phase_build(ctx, SMALL["n"], SMALL["f"], SMALL["centers"],
                          SMALL["n_lambda"], SMALL["seed"])


def test_ref_lambda_matches_helpers_oracle():
    rng = np.random.default_rng(0)
    x = rng.uniform(0.1, 1.0, (12, 10))
    a = rng.uniform(0, 1, (10, 10))
    a = np.maximum(a, a.T) * (a > 0.5)
    np.fill_diagonal(a, 0)
    lap = np.diag(a.sum(1)) - a
    got = cs.ref_lambda(x, lap, block=5)
    for r in range(12):
        want = oracle_synthetic_lambda(x[r], lap,
                                       max(np.median(x[r]), 1e-10))
        assert got[r] == pytest.approx(want, rel=1e-12, abs=1e-15)


def test_check_topk_flags_a_wrong_id(ctx):
    ref_s = np.array([[0.9, 0.8, 0.7, 0.1]])
    ref_i = np.array([[4, 2, 9, 1]])
    cs.check_topk(ctx, "ok", ref_s[:, :3], ref_i[:, :3], ref_s, ref_i)
    with pytest.raises(cs.SmokeError):
        cs.check_topk(ctx, "bad", ref_s[:, :3], np.array([[4, 9, 2]]),
                      ref_s, ref_i)
    with pytest.raises(cs.SmokeError):
        cs.check_topk(ctx, "bad score", ref_s[:, :3] + 1e-3, ref_i[:, :3],
                      ref_s, ref_i)


def test_phase_build(ctx, built):
    index, rows, dup = built
    assert index.nitems == SMALL["n"]
    assert all(np.array_equal(rows[d], rows[dup[0]]) for d in dup)


def test_phase_serve(ctx, built):
    index, rows, dup = built
    cs.phase_serve(ctx, index, rows, dup, SMALL["b"], SMALL["k"],
                   SMALL["alpha"], SMALL["n_check"], 11)


def test_phase_routing(ctx):
    out = cs.phase_routing(ctx, 512, 16, 3, reps=3)
    assert out["host_ms"] > 0 and out["device_ms"] > 0


def test_phase_memory(ctx, built):
    index, _, _ = built
    out = cs.phase_memory(ctx, index, 20_000, 32, SMALL["k"],
                          SMALL["alpha"], 4)
    assert "peak_bytes" in out


def test_phase_pruned(ctx, built):
    index, _, _ = built
    rate = cs.phase_pruned(ctx, index, 4096, 64, SMALL["k"],
                           SMALL["alpha"], 2, 6)
    assert rate < 1.0


def test_phase_live(ctx, built):
    index, rows, _ = built
    cs.phase_live(ctx, index, rows, 6000, 300, 40, 40, SMALL["b"],
                  SMALL["k"], SMALL["alpha"], SMALL["n_check"], 7)


def test_phase_wide(ctx):
    cs.phase_wide(ctx, 2400, 48, 6, 64, SMALL["k"], SMALL["alpha"], 32, 64,
                  8)


def test_phase_energy(ctx):
    cs.phase_energy(ctx, 2000, 16, 8, (16, 64), SMALL["k"], 32, 9)


def test_phase_mesh_on_virtual_devices(ctx, eight_devices):
    cs.phase_mesh(ctx, 4096, 16, 8, 32, SMALL["k"], SMALL["alpha"], 32, 64,
                  10, 4)


def _run_script(cwd, script):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    return subprocess.run([sys.executable, script], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_chip_smoke_exits_nonzero_without_gpu():
    r = _run_script(REPO, os.path.join(REPO, "chip_smoke.py"))
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout


def test_chip_smoke_alone_fails(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    r = _run_script(str(tmp_path), str(tmp_path / "chip_smoke.py"))
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout


@pytest.mark.gpu
def test_chip_smoke_on_gpu():
    """The whole smoke on the card, in its own process (this one stays on
    the CPU); skips where nvidia-smi finds no GPU."""
    smi = shutil.which("nvidia-smi")
    if smi is None or subprocess.run([smi, "-L"], capture_output=True
                                     ).returncode != 0:
        pytest.skip("needs an NVIDIA GPU (run: python chip_smoke.py)")
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_PLATFORMS", "XLA_FLAGS")}
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=1200)
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.strip().splitlines()[-1].startswith('{"ok": true')
