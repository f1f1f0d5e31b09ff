"""Kernel selection, compile-cache placement, optional installs, and
chip_smoke.py's behaviour without a GPU (all CPU-only checks)."""

import os
import subprocess
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from efa_xray_tpu.config import FilterConfig
from efa_xray_tpu.ops import select

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("kw", [
    {},
    {"method": "serial"},
    {"dtype": "float64"},
    {"hybrid_alpha": 0.5, "static_b_sigma": 1.0, "static_b_length": 500.0},
])
def test_cpu_selects_xla(kw):
    """On the CPU the auto choice is XLA for every configuration, and
    interpret mode is off unless asked for."""
    k = select.choose(FilterConfig(**kw))
    assert k == select.Kernels(body=False, tail=False, interpret=False)


def test_forced_kernels_need_a_gpu_or_explicit_interpret():
    cfg = FilterConfig(use_pallas=True)
    with pytest.raises(ValueError, match="CUDA GPU"):
        select.choose(cfg)
    k = select.choose(cfg, interpret=True)
    assert k.body and k.tail and k.interpret


def test_tail_follows_body_and_skips_hybrid():
    hyb = dict(hybrid_alpha=0.5, static_b_sigma=1.0, static_b_length=500.0)
    assert select.choose(FilterConfig(use_pallas=True, **hyb),
                         interpret=True) == select.Kernels(True, False, True)
    assert select.choose(FilterConfig(use_pallas=True, tail_pallas=False),
                         interpret=True) == select.Kernels(True, False, True)
    # serial has no phase 2 to put a kernel in
    assert select.choose(FilterConfig(use_pallas=True, method="serial"),
                         interpret=True) == select.Kernels(False, False, True)


def test_platform_follows_default_device():
    """The host fast path places the update with jax.default_device; the
    selector reads the platform from there."""
    assert select.platform() == "cpu"
    with jax.default_device(jax.devices("cpu")[0]):
        assert select.platform() == "cpu"


def test_small_host_runs_on_the_cpu_and_matches():
    """FilterConfig.small_host runs the update under a CPU default
    device: the selector sees the CPU there, and the analysis is the
    same."""
    from conftest import make_demo_obs, make_demo_state
    from efa_xray_tpu.assimilation.ensrf import EnSRF

    state = make_demo_state(nmems=8, seed=2)
    obs = list(make_demo_obs(state, nobs=4, seed=3))
    want, _ = EnSRF(state, obs, config=FilterConfig(localization="GC"),
                    verbose=False).update()
    filt = EnSRF(state, obs, config=FilterConfig(localization="GC",
                                                 small_host=True),
                 verbose=False)
    assert filt._host_fastpath()
    with filt._host_fastpath_ctx():
        assert select.platform() == "cpu"
    got, _ = filt.update()
    assert got.data.devices() == {jax.devices("cpu")[0]}
    np.testing.assert_allclose(np.asarray(got.data), np.asarray(want.data),
                               rtol=0, atol=1e-12)


def test_ensrf_interpret_is_explicit():
    from conftest import make_demo_obs, make_demo_state
    from efa_xray_tpu.assimilation.ensrf import EnSRF

    state = make_demo_state(nmems=8, seed=0)
    filt = EnSRF(state, list(make_demo_obs(state, nobs=3, seed=1)),
                 config=FilterConfig(localization="GC"), verbose=False)
    assert filt._kernels() == select.Kernels(False, False, False)


def test_compile_cache_env_wins(monkeypatch, tmp_path):
    from efa_xray_tpu.utils import compile_cache

    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "env"))
    assert compile_cache.enable(str(tmp_path)) == str(tmp_path / "env")
    assert jax.config.jax_compilation_cache_dir == before
    assert not (tmp_path / ".jax_cache").exists()


def test_compile_cache_defaults_to_checkout(monkeypatch, tmp_path):
    from efa_xray_tpu.utils import compile_cache

    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    before = jax.config.jax_compilation_cache_dir
    try:
        path = compile_cache.enable(str(tmp_path))
        assert path == str(tmp_path / ".jax_cache")
        assert (tmp_path / ".jax_cache").is_dir()
        assert jax.config.jax_compilation_cache_dir == path
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
    assert compile_cache.CHECKOUT == ROOT
    with open(os.path.join(ROOT, ".gitignore")) as fh:
        assert ".jax_cache/" in fh.read().split()


def _run(code, **kw):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("EFA_TESTS_ON_GPU", None)
    return subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300, **kw)


def test_import_without_pandas_or_h5py():
    """The main path imports only JAX, NumPy and SciPy: blocking pandas
    and h5py must not break ``import efa_xray_tpu`` or an update."""
    r = _run(
        "import sys\n"
        "sys.modules['pandas'] = None; sys.modules['h5py'] = None\n"
        "sys.path.insert(0, 'tests')\n"
        "import efa_xray_tpu\n"
        "from conftest import make_demo_obs, make_demo_state\n"
        "s = make_demo_state(nmems=6, seed=0)\n"
        "p, _ = efa_xray_tpu.EnSRF(s, list(make_demo_obs(s, nobs=2)),"
        " verbose=False).update()\n"
        "print('ok', p.data.shape)\n")
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.startswith("ok")


def test_chip_smoke_fails_without_gpu():
    """No accelerator: exit non-zero and print no result line."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("EFA_TESTS_ON_GPU", None)
    r = subprocess.run(
        [sys.executable, "-c",
         "import sys, chip_smoke; chip_smoke.phase_gpu_tests = lambda: None;"
         " chip_smoke.card_line = lambda: 'stand-in card';"
         " sys.argv = ['chip_smoke.py']; sys.exit(chip_smoke.main())"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
    assert "no GPU: JAX found platform 'cpu'" in r.stderr
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0 and '"ok"' not in r.stdout
    assert "no GPU" in r.stderr


def test_chip_smoke_fails_alone(tmp_path):
    """A directory holding chip_smoke.py and nothing else of the repo."""
    import shutil

    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("PYTHONPATH", None)
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                       env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def test_chip_smoke_rel_rms():
    """The comparison helper: RMS of the difference over RMS of the
    increment, for the member mean and the perturbations apart."""
    sys.path.insert(0, ROOT)
    import chip_smoke

    prior = jnp.zeros((3, 4))
    want = jnp.asarray([[1.0, 3.0, 1.0, 3.0]] * 3)  # mean 2, perts +-1
    got = want + jnp.asarray([[0.1, 0.1, 0.1, 0.1]] * 3)  # mean off by 0.1
    em, ep = chip_smoke.rel_rms(got, want, prior)
    np.testing.assert_allclose(em, 0.05, rtol=1e-6)
    assert ep < 1e-6
    got2 = want + jnp.asarray([[0.2, -0.2, 0.2, -0.2]] * 3)
    em2, ep2 = chip_smoke.rel_rms(got2, want, prior)
    assert em2 < 1e-6
    np.testing.assert_allclose(ep2, 0.2, rtol=1e-6)
