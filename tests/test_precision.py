"""matmul_precision config: validation, context plumbing, CPU no-op.

What the knob means depends on the hardware (on an H100 the default runs
f32 dots as TF32; "highest" runs true f32 products).  On CPU, f32/f64
dots are exact
regardless, so here we verify the plumbing: the value is validated, the
solver update actually runs under the requested jax.default_matmul_precision
context, and results on CPU are unchanged by it.
"""

import numpy as np
import pytest

import jax

from conftest import make_demo_obs, make_demo_state
from efa_xray_tpu.assimilation.ensrf import EnSRF
from efa_xray_tpu.config import FilterConfig


def test_bad_matmul_precision_rejected():
    with pytest.raises(ValueError, match="matmul_precision"):
        FilterConfig(matmul_precision="bf16x3")


@pytest.mark.parametrize("value", [None, "default", "highest", "bfloat16",
                                   "float32", "tensorfloat32", "high"])
def test_accepted_matmul_precision_values(value):
    assert FilterConfig(matmul_precision=value).matmul_precision == value


def test_precision_ctx_sets_jax_config():
    state = make_demo_state(ntimes=1, ny=4, nx=4, nmems=6, seed=0)
    obs = make_demo_obs(state, nobs=2, seed=1)
    filt = EnSRF(state, list(obs), verbose=False,
                 config=FilterConfig(matmul_precision="highest"))
    with filt._matmul_precision_ctx():
        assert jax.config.jax_default_matmul_precision == "highest"
    # None -> nullcontext, ambient setting untouched
    filt2 = EnSRF(state, list(obs), verbose=False, config=FilterConfig())
    before = jax.config.jax_default_matmul_precision
    with filt2._matmul_precision_ctx():
        assert jax.config.jax_default_matmul_precision == before


@pytest.mark.parametrize("value", ["highest", "bfloat16"])
def test_update_runs_under_precision_and_matches_on_cpu(value):
    """CPU dots ignore the precision ladder: any setting must leave the
    posterior unchanged (the knob only means something on an
    accelerator)."""
    state = make_demo_state(ntimes=2, ny=5, nx=6, nmems=10, seed=3)
    obs = make_demo_obs(state, nobs=5, seed=4, radius=1200.0)
    base = FilterConfig(localization="GC", dtype="float64")
    pinned = FilterConfig(localization="GC", dtype="float64",
                          matmul_precision=value)
    p0, _ = EnSRF(state, list(obs), config=base, verbose=False).update()
    p1, _ = EnSRF(state, list(obs), config=pinned, verbose=False).update()
    np.testing.assert_allclose(np.asarray(p1.data), np.asarray(p0.data),
                               rtol=0, atol=1e-12)
