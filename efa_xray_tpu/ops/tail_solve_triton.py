"""In-kernel serial solve of one observation-space tail panel (Triton).

Phase 1 of the hierarchical tail (``ensrf_core.tail_scan_blocked``) runs
the exact serial square-root recurrence on each panel's own ``[P, M]``
rows.  As a ``lax.scan`` every ob is an XLA loop step of several small
launches.  Here one program holds the whole ``[P, M]`` slab in registers
and runs the per-ob dependence as a ``fori_loop``: each step extracts the
ob's row, forms the slab-wide covariance by a row reduction, and applies
the rank-1 update in place.  The per-ob cost is the arithmetic itself.

The ob-ob localization weight matrix (Gaspari-Cohn on either geometry,
times the optional vertical and cross-variable factors) is built by XLA
and streamed in; row ``i`` of it is one vector load per step.

Exactness: same update algebra as ``ensrf_core.tail_scan`` (no hybrid
static column), with the post-update diagnostics in closed form — row
``i`` of the slab right after ob ``i`` is ``(1 - beta * kmat_i) * ye``,
so ``post_var = (1 - beta * kmat_i)^2 * varye``.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from efa_xray_tpu.ops.ensrf_triton import pow2


def _make_kernel(p: int, pp: int, m: int, mp: int, unbiased: bool):
    vden = (m - 1) if unbiased else m

    def kernel(vals_ref, errs_ref, assim_ref, w_ref, tm_in_ref, tp_in_ref,
               tm_ref, tp_ref, ye_ref, gain_ref, sqrt_ref, pm_ref, pv_ref,
               om_ref, ov_ref):
        i0 = jnp.int32(0)
        ridx = jnp.arange(pp, dtype=jnp.int32)
        cidx = jnp.arange(mp, dtype=jnp.int32)
        rmask = ridx < p
        cmask = cidx < m
        smask = rmask[:, None] & cmask[None, :]
        tp0 = plgpu.load(tp_in_ref.at[pl.ds(i0, pp), pl.ds(i0, mp)],
                         mask=smask, other=0.0)
        tm0 = plgpu.load(tm_in_ref.at[pl.ds(i0, pp)], mask=rmask, other=0.0)
        f32 = tp0.dtype
        nan = jnp.asarray(jnp.nan, f32)

        def step(i, carry):
            tm, tp = carry
            sel = ridx == i
            ye = jnp.sum(jnp.where(sel[:, None], tp, 0.0), axis=0)  # [MP]
            mye = jnp.sum(jnp.where(sel, tm, 0.0))
            y_i = plgpu.load(vals_ref.at[i])
            r_i = plgpu.load(errs_ref.at[i])
            fa = plgpu.load(assim_ref.at[i])  # 1.0 assimilate, 0.0 skip
            a_i = fa != 0
            mu = jnp.sum(ye) / m
            dev = jnp.where(cmask, ye - mu, 0.0)
            varye = jnp.sum(dev * dev) / vden
            innov = y_i - mye
            kdenom = varye + r_i
            scale = 1.0 / (kdenom * (m - 1))
            beta = 1.0 / (1.0 + jnp.sqrt(r_i / kdenom))
            kcov = jnp.sum(tp * ye[None, :], axis=1)  # [PP]
            w = plgpu.load(w_ref.at[i, pl.ds(i0, pp)], mask=rmask, other=0.0)
            kmat = kcov * w * scale
            tm = tm + (fa * innov) * kmat
            tp = tp - ((fa * beta) * kmat)[:, None] * ye[None, :]
            k_i = jnp.sum(jnp.where(sel, kmat, 0.0))
            shrink = 1.0 - beta * k_i
            plgpu.store(ye_ref.at[i, pl.ds(i0, mp)], ye, mask=cmask)
            plgpu.store(gain_ref.at[i], fa * innov * scale)
            plgpu.store(sqrt_ref.at[i], fa * beta * scale)
            plgpu.store(pm_ref.at[i], mye)
            plgpu.store(pv_ref.at[i], varye)
            plgpu.store(om_ref.at[i], jnp.where(a_i, mye + k_i * innov, nan))
            plgpu.store(ov_ref.at[i],
                        jnp.where(a_i, shrink * shrink * varye, nan))
            return tm, tp

        tm, tp = jax.lax.fori_loop(i0, jnp.int32(p), step, (tm0, tp0))
        plgpu.store(tm_ref.at[pl.ds(i0, pp)], tm, mask=rmask)
        plgpu.store(tp_ref.at[pl.ds(i0, pp), pl.ds(i0, mp)], tp, mask=smask)

    return kernel


def _num_warps(pp: int, mp: int) -> int:
    # Keep the register slab near 64 f32 per thread.
    return max(4, min(16, pp * mp // (64 * 32)))


@functools.partial(jax.jit, static_argnames=("unbiased", "interpret"))
def tail_panel_solve(
    tail_mean,  # [P]
    tail_perts,  # [P, M]
    values,  # [P]
    errors,  # [P]
    assim,  # [P] bool
    weights,  # [P, P]: weights[i, j] = gain factor of ob i at obs row j
    unbiased: bool = False,
    interpret: bool = False,
):
    """Serial EnSRF solve of one tail panel in one kernel launch.

    Returns ``(tm, tp, ye, gain_coef, sqrt_coef, pm, pv, om, ov)`` with
    the meanings of :func:`ensrf_core.tail_scan`'s outputs restricted to
    the panel.  ``weights`` of all ones is the unlocalized solve."""
    p, m = tail_perts.shape
    dtype = tail_perts.dtype
    pp, mp = pow2(p), pow2(m)
    vec = lambda: jax.ShapeDtypeStruct((p,), dtype)
    outs = pl.pallas_call(
        _make_kernel(p, pp, m, mp, bool(unbiased)),
        grid=(1,),
        out_shape=[vec(), jax.ShapeDtypeStruct((p, m), dtype),
                   jax.ShapeDtypeStruct((p, m), dtype),
                   vec(), vec(), vec(), vec(), vec(), vec()],
        compiler_params=plgpu.CompilerParams(num_warps=_num_warps(pp, mp),
                                             num_stages=1),
        interpret=interpret,
        name="ensrf_tail_panel",
    )(values.astype(dtype), errors.astype(dtype), assim.astype(dtype),
      weights.astype(dtype), tail_mean.astype(dtype), tail_perts)
    return tuple(outs)
