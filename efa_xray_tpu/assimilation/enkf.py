"""Stochastic (perturbed-observation) EnKF — the classic Monte-Carlo
ensemble Kalman filter (Evensen 1994; Burgers, van Leeuwen & Evensen 1998).

An extension beyond the reference, which implements only the deterministic
square-root update (``efa_xray/assimilation/ensrf.py:33-151``).  Each
member assimilates a perturbed observation ``y + eps_m`` with the FULL
Kalman gain::

    x_m <- x_m + K (y + eps_m - H x_m),   eps_m ~ N(0, R)

so the perturbation update is ``Xap = Xbp - K (ye - eps~)`` with centered
perturbations ``eps~`` — no square-root ``beta`` factor.  In expectation
over the perturbation draws this reproduces the EnSRF posterior
covariance; per realization it adds O(1/sqrt(M)) sampling noise, in
exchange for exactly Gaussian-consistent higher moments (the square-root
filter's deterministic update can produce non-Gaussian outliers in small
ensembles).

Execution: the default blocked two-phase form mirrors the EnSRF
(``method="blocked"``: obs-space tail scan + Gram-corrected block sweep of
the body, :func:`enkf_blocked`) — the same one-HBM-pass-per-block
structure, with the apply rows being the perturbed departures ``z`` and
the correction Gram ``Z Ye^T``.  ``method="serial"`` keeps the literal
per-ob ``lax.scan`` twin of
:func:`efa_xray_tpu.assimilation.ensrf_core.ensrf_serial`.  The only
extra state either way is the pre-drawn ``[nobs, M]`` perturbation table
(one ``jax.random.normal`` call — never a per-ob host RNG round-trip).
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from efa_xray_tpu.assimilation import ensrf_core as core
from efa_xray_tpu.assimilation.assimilation import Assimilation
from efa_xray_tpu.assimilation.ensrf_core import (
    ObsArrays,
    ObsDiagnostics,
    _empty_diags,
    _loc_weights,
    _ye_var,
)
from efa_xray_tpu.config import FilterConfig
from efa_xray_tpu.observation.localization import latlon_to_unit


def draw_ob_perturbations(key, errors, nmems: int, scale: bool = True):
    """Centered observation perturbations, ``[nobs, M]``.

    ``eps ~ N(0, R)`` per ob row, centered so the perturbed-ob mean is the
    ob itself.  ``scale=True`` additionally rescales each row so its
    ddof=1 sample variance is exactly ``R`` (standard variance-exact
    trick; removes one O(1/sqrt(M)) noise term from the posterior spread).
    """
    errors = jnp.asarray(errors)
    nobs = errors.shape[0]
    eps = jax.random.normal(key, (nobs, nmems), dtype=errors.dtype)
    eps = eps - jnp.mean(eps, axis=1, keepdims=True)
    if scale:
        sd = jnp.std(eps, axis=1, ddof=1, keepdims=True)
        eps = eps / jnp.maximum(sd, 1e-30)
    return eps * jnp.sqrt(errors)[:, None]


@functools.partial(
    jax.jit,
    static_argnames=("localize", "unbiased", "fast_geometry", "vertical"),
)
def enkf_serial(
    body_mean,  # [Ns]
    body_perts,  # [Ns, M]
    tail_mean,  # [No]
    tail_perts,  # [No, M]
    body_lat,  # [Ns]
    body_lon,  # [Ns]
    obs: ObsArrays,
    eps,  # [No, M] centered observation perturbations
    localize: bool = True,
    unbiased: bool = False,
    fast_geometry: bool = False,
    body_vert=None,
    vertical: bool = False,
    varloc=None,  # [nv(+1), nvars] cross-variable localization factors
    row_var=None,  # [Ns] int32
    ob_var=None,  # [No] int32
):
    """Serial perturbed-obs EnKF as one ``lax.scan`` over observations.

    Identical structure to ``ensrf_core.ensrf_serial`` (same augmented
    state, localization, QC masking and diagnostics); the update applies
    the full gain to ``ye - eps~`` instead of ``beta * K`` to ``ye``.
    Returns ``(body_mean, body_perts, tail_mean, tail_perts, diags)``.
    """
    nens = body_perts.shape[1]
    dtype = body_perts.dtype
    nobs = obs.values.shape[0]
    if nobs == 0:
        return body_mean, body_perts, tail_mean, tail_perts, _empty_diags(dtype)

    if localize and fast_geometry:
        body_xyz = latlon_to_unit(body_lat, body_lon).astype(dtype)
        tail_xyz = latlon_to_unit(obs.lats, obs.lons).astype(dtype)
    else:
        body_xyz = tail_xyz = None
    obs = obs.with_default_verts()
    tail_vert = obs.verts.astype(dtype) if (localize and vertical) else None
    bvert = body_vert.astype(dtype) if (localize and vertical) else None
    use_vl = varloc is not None
    if use_vl:
        if row_var is None or ob_var is None:
            raise ValueError("varloc needs row_var and ob_var")
        vl = jnp.asarray(varloc, dtype)
        rvar = jnp.asarray(row_var, jnp.int32)
        ovar_all = jnp.asarray(ob_var, jnp.int32)
    else:
        ovar_all = jnp.zeros(nobs, jnp.int32)

    def step(carry, xs):
        bm, bp, tm, tp = carry
        (i, y, r_err, ob_lat, ob_lon, radius, do_assim, ob_vert, ob_vrad,
         eps_row, ov) = xs

        ye = jax.lax.dynamic_index_in_dim(tp, i, axis=0, keepdims=False)
        mye = tm[i]
        varye = _ye_var(ye, unbiased)

        innov = y - mye
        kdenom = varye + r_err
        scale = 1.0 / (kdenom * (nens - 1))

        kcov_b = bp @ ye
        kcov_t = tp @ ye
        vkw_b = dict(row_vert=bvert, ob_vert=ob_vert, vert_radius=ob_vrad) \
            if (localize and vertical) else {}
        vkw_t = dict(row_vert=tail_vert, ob_vert=ob_vert, vert_radius=ob_vrad) \
            if (localize and vertical) else {}
        if localize and fast_geometry:
            ob_xyz = latlon_to_unit(ob_lat, ob_lon).astype(dtype)
            w_b = _loc_weights(None, None, None, None, radius, True, dtype,
                               row_xyz=body_xyz, ob_xyz=ob_xyz, **vkw_b)
            w_t = _loc_weights(None, None, None, None, radius, True, dtype,
                               row_xyz=tail_xyz, ob_xyz=ob_xyz, **vkw_t)
        else:
            w_b = _loc_weights(body_lat, body_lon, ob_lat, ob_lon, radius,
                               localize, dtype, **vkw_b)
            w_t = _loc_weights(obs.lats, obs.lons, ob_lat, ob_lon, radius,
                               localize, dtype, **vkw_t)
        if localize:
            kcov_b = kcov_b * w_b
            kcov_t = kcov_t * w_t
        if use_vl:
            fr = vl[ov]
            kcov_b = kcov_b * fr[rvar]
            kcov_t = kcov_t * fr[ovar_all]

        kmat_b = kcov_b * scale
        kmat_t = kcov_t * scale

        # Mean: same Kalman update as the EnSRF.  Perturbations: full gain
        # applied to the perturbed-ob departures (Burgers et al. 1998 eq. 10).
        z = ye - eps_row  # [M]
        bm2 = bm + kmat_b * innov
        tm2 = tm + kmat_t * innov
        bp2 = bp - kmat_b[:, None] * z[None, :]
        tp2 = tp - kmat_t[:, None] * z[None, :]

        bm2 = jnp.where(do_assim, bm2, bm)
        tm2 = jnp.where(do_assim, tm2, tm)
        bp2 = jnp.where(do_assim, bp2, bp)
        tp2 = jnp.where(do_assim, tp2, tp)

        post_row = jax.lax.dynamic_index_in_dim(tp2, i, axis=0, keepdims=False)
        diag = (
            mye,
            varye,
            jnp.where(do_assim, tm2[i], jnp.nan),
            jnp.where(do_assim, _ye_var(post_row, unbiased), jnp.nan),
            do_assim,
        )
        return (bm2, bp2, tm2, tp2), diag

    xs = (
        jnp.arange(nobs),
        obs.values.astype(dtype),
        obs.errors.astype(dtype),
        obs.lats.astype(dtype),
        obs.lons.astype(dtype),
        obs.radii.astype(dtype),
        obs.assim,
        obs.verts.astype(dtype),
        obs.vert_radii.astype(dtype),
        eps.astype(dtype),
        ovar_all,
    )
    with jax.named_scope("enkf/serial_scan"):
        (bm, bp, tm, tp), diags = jax.lax.scan(
            step, (body_mean, body_perts, tail_mean, tail_perts), xs
        )
    return bm, bp, tm, tp, ObsDiagnostics(*diags)


@functools.partial(
    jax.jit,
    static_argnames=("localize", "unbiased", "fast_geometry", "vertical"),
)
def enkf_tail_scan(tail_mean, tail_perts, obs: ObsArrays, eps,
                   localize: bool = True, unbiased: bool = False,
                   fast_geometry: bool = False, vertical: bool = False,
                   varloc=None, ob_var=None):
    """Run the stochastic EnKF on the observation-space tail only.

    The EnKF twin of :func:`ensrf_core.tail_scan`: produces the exact
    as-encountered ``ye`` sequence, the per-ob scalar coefficients, and
    the perturbed-ob departure rows ``z = ye - eps`` that the blocked
    body sweep applies against.  Returns ``(TailSolution, z)`` with
    ``gain_coef = innov * scale`` and ``sqrt_coef = scale`` (the EnKF
    applies the FULL gain to ``z``; there is no beta factor — Burgers
    et al. 1998 eq. 10, vs the reference's square root,
    ``efa_xray/assimilation/ensrf.py:135``).
    """
    nens = tail_perts.shape[1]
    dtype = tail_perts.dtype
    nobs = obs.values.shape[0]
    if nobs == 0:
        zc = jnp.zeros((0,), dtype=dtype)
        return core.TailSolution(
            ye=jnp.zeros((0, nens), dtype=dtype), gain_coef=zc,
            sqrt_coef=zc, tail_mean=tail_mean, tail_perts=tail_perts,
            diags=_empty_diags(dtype),
        ), jnp.zeros((0, nens), dtype=dtype)

    if localize and fast_geometry:
        tail_xyz = latlon_to_unit(obs.lats, obs.lons).astype(dtype)
    else:
        tail_xyz = None
    obs = obs.with_default_verts()
    tail_vert = obs.verts.astype(dtype) if (localize and vertical) else None
    use_vl = varloc is not None
    if use_vl:
        if ob_var is None:
            raise ValueError("varloc needs ob_var")
        vl = jnp.asarray(varloc, dtype)
        ovar_all = jnp.asarray(ob_var, jnp.int32)
    else:
        ovar_all = jnp.zeros(nobs, jnp.int32)

    def step(carry, xs):
        tm, tp = carry
        (i, y, r_err, ob_lat, ob_lon, radius, do_assim, ob_vert, ob_vrad,
         eps_row, ov) = xs

        ye = jax.lax.dynamic_index_in_dim(tp, i, axis=0, keepdims=False)
        mye = tm[i]
        varye = _ye_var(ye, unbiased)
        innov = y - mye
        kdenom = varye + r_err
        scale = 1.0 / (kdenom * (nens - 1))

        kcov_t = tp @ ye
        vkw = dict(row_vert=tail_vert, ob_vert=ob_vert,
                   vert_radius=ob_vrad) if (localize and vertical) else {}
        if localize and fast_geometry:
            w_t = _loc_weights(None, None, None, None, radius, True, dtype,
                               row_xyz=tail_xyz,
                               ob_xyz=latlon_to_unit(ob_lat, ob_lon)
                               .astype(dtype), **vkw)
        else:
            w_t = _loc_weights(obs.lats, obs.lons, ob_lat, ob_lon, radius,
                               localize, dtype, **vkw)
        if localize:
            kcov_t = kcov_t * w_t
        if use_vl:
            kcov_t = kcov_t * vl[ov][ovar_all]
        kmat_t = kcov_t * scale

        z = ye - eps_row
        tm2 = jnp.where(do_assim, tm + kmat_t * innov, tm)
        tp2 = jnp.where(do_assim, tp - kmat_t[:, None] * z[None, :], tp)

        post_row = jax.lax.dynamic_index_in_dim(tp2, i, axis=0,
                                                keepdims=False)
        out = (
            ye,
            z,
            jnp.where(do_assim, innov * scale, 0.0),
            jnp.where(do_assim, scale, 0.0),
            mye,
            varye,
            jnp.where(do_assim, tm2[i], jnp.nan),
            jnp.where(do_assim, _ye_var(post_row, unbiased), jnp.nan),
            do_assim,
        )
        return (tm2, tp2), out

    xs = (
        jnp.arange(nobs),
        obs.values.astype(dtype),
        obs.errors.astype(dtype),
        obs.lats.astype(dtype),
        obs.lons.astype(dtype),
        obs.radii.astype(dtype),
        obs.assim,
        obs.verts.astype(dtype),
        obs.vert_radii.astype(dtype),
        eps.astype(dtype),
        ovar_all,
    )
    with jax.named_scope("enkf/tail_scan"):
        (tm, tp), (ye, z, gain, coef, pm, pv, om, ov, asm) = jax.lax.scan(
            step, (tail_mean, tail_perts), xs
        )
    return core.TailSolution(
        ye=ye, gain_coef=gain, sqrt_coef=coef, tail_mean=tm,
        tail_perts=tp, diags=ObsDiagnostics(pm, pv, om, ov, asm),
    ), z


@functools.partial(
    jax.jit,
    static_argnames=("localize", "unbiased", "fast_geometry", "vertical",
                     "block_size"),
)
def enkf_blocked(
    body_mean, body_perts, tail_mean, tail_perts, body_lat, body_lon,
    obs: ObsArrays, eps,
    localize: bool = True, unbiased: bool = False,
    fast_geometry: bool = False, body_vert=None, vertical: bool = False,
    block_size: int = 128,
    varloc=None, row_var=None, ob_var=None,
):
    """Blocked two-phase stochastic EnKF: obs-space tail scan + one
    block-swept body application.

    The EnKF twin of :func:`ensrf_core.ensrf_blocked`: phase 1 solves the
    cheap ``[No, M]`` tail serially (exact ye sequence + coefficients +
    departure rows ``z``); phase 2 applies all obs to the state body in
    ``block_size`` batches through the same Gram-corrected recurrence as
    the EnSRF, with the apply rows being ``z`` instead of ``ye``
    (``apply_obs_block(apply_rows=...)``).  Algebraically identical to
    :func:`enkf_serial` for the same ``eps`` (fp reassociation only); the
    state body crosses HBM ``No/block_size`` times instead of ``No``.
    """
    tail, z = enkf_tail_scan(
        tail_mean, tail_perts, obs, eps, localize=localize,
        unbiased=unbiased, fast_geometry=fast_geometry, vertical=vertical,
        varloc=varloc, ob_var=ob_var,
    )
    bm, bp = core.ensrf_blocked_body(
        body_mean, body_perts, body_lat, body_lon, tail, obs,
        localize=localize, block_size=block_size,
        fast_geometry=fast_geometry, body_vert=body_vert,
        vertical=vertical, apply_rows=z,
        varloc=varloc, row_var=row_var, ob_var=ob_var,
    )
    return bm, bp, tail.tail_mean, tail.tail_perts, tail.diags


class EnKF(Assimilation):
    """User-facing stochastic EnKF with the same API as
    :class:`~efa_xray_tpu.assimilation.ensrf.EnSRF` /
    :class:`~efa_xray_tpu.assimilation.letkf.LETKF`.

    Extra knobs: ``seed`` (perturbation draw; fixed seed = reproducible
    analysis) and ``scale_perturbations`` (variance-exact rescaling of the
    drawn perturbations, on by default).
    """

    def __init__(
        self,
        state,
        obs,
        inflation=None,
        verbose: bool = True,
        loc=False,
        config: Optional[FilterConfig] = None,
        seed: int = 0,
        scale_perturbations: bool = True,
        mesh=None,
    ):
        if config is None:
            config = FilterConfig(
                localization="GC" if loc not in (None, False) else None,
                verbose=verbose,
            )
        super().__init__(state, obs, inflation=inflation, verbose=verbose,
                         config=config, mesh=mesh)
        self.seed = int(seed)
        self.scale_perturbations = bool(scale_perturbations)

    @Assimilation.with_matmul_precision
    def update(self) -> Tuple["object", "object"]:
        """Assimilate all observations; return (posterior, observations).

        Tiny workloads route to the host CPU backend
        (:meth:`Assimilation._host_fastpath`), same as the EnSRF."""
        if self._host_fastpath():
            with self._host_fastpath_ctx():
                return self._update_impl()
        return self._update_impl()

    def _update_impl(self) -> Tuple["object", "object"]:
        cfg = self.config
        if cfg.hybrid_alpha < 1.0:
            raise ValueError(
                "hybrid covariance (hybrid_alpha < 1) is implemented for "
                "the EnSRF solver only; the stochastic EnKF would silently "
                "ignore the static-B blend"
            )
        if self.verbose:
            self.log.info("Beginning stochastic EnKF update sequence")
        body_mean, body_perts, tail_mean, tail_perts = self.format_prior_state()
        obs = self.obs_arrays()
        obs = self.apply_outlier_check(obs, tail_mean, tail_perts)

        dtype = jnp.dtype(cfg.dtype)
        # Structure-cached device coordinates (see row_latlon_device).
        body_lat, body_lon = self.prior.structure.row_latlon_device(dtype)
        vertical = cfg.localize and self._vertical_active()
        body_vert = (
            jnp.asarray(self.prior.structure.row_vert(), dtype=dtype)
            if vertical
            else jnp.zeros_like(body_lat)
        )

        prior_spread = None
        if cfg.rtps_alpha > 0.0:
            from efa_xray_tpu.assimilation.adaptive_inflation import row_spread

            prior_spread = row_spread(body_perts)
        # RTPP needs the prior perturbations after the update; the EnKF
        # path does not donate them, so a reference suffices.
        prior_perts_saved = body_perts if cfg.rtpp_alpha > 0.0 else None

        eps = draw_ob_perturbations(
            jax.random.PRNGKey(self.seed),
            obs.errors.astype(dtype),
            self.prior.structure.nmems,
            scale=self.scale_perturbations,
        )
        vl_kwargs = self.varloc_kwargs(dtype)
        if self.mesh is not None:
            from efa_xray_tpu.parallel.sharded import enkf_update_sharded

            bm, bp, tm, tp, diags = enkf_update_sharded(
                body_mean,
                body_perts,
                tail_mean,
                tail_perts,
                body_lat,
                body_lon,
                obs,
                eps,
                mesh=self.mesh,
                localize=cfg.localize,
                unbiased=cfg.unbiased_variance,
                fast_geometry=cfg.fast_geometry,
                body_vert=body_vert,
                vertical=vertical,
                method=cfg.method,
                block_size=cfg.block_size,
                **vl_kwargs,
            )
        elif cfg.method == "blocked":
            bm, bp, tm, tp, diags = enkf_blocked(
                body_mean,
                body_perts,
                tail_mean,
                tail_perts,
                body_lat,
                body_lon,
                obs,
                eps,
                localize=cfg.localize,
                unbiased=cfg.unbiased_variance,
                fast_geometry=cfg.fast_geometry,
                body_vert=body_vert,
                vertical=vertical,
                block_size=cfg.block_size,
                **vl_kwargs,
            )
        else:
            bm, bp, tm, tp, diags = enkf_serial(
                body_mean,
                body_perts,
                tail_mean,
                tail_perts,
                body_lat,
                body_lon,
                obs,
                eps,
                localize=cfg.localize,
                unbiased=cfg.unbiased_variance,
                fast_geometry=cfg.fast_geometry,
                body_vert=body_vert,
                vertical=vertical,
                **vl_kwargs,
            )

        if prior_spread is not None:
            from efa_xray_tpu.assimilation.adaptive_inflation import rtps

            bp = rtps(prior_spread, bp, cfg.rtps_alpha)
        if prior_perts_saved is not None:
            from efa_xray_tpu.assimilation.adaptive_inflation import rtpp

            bp = rtpp(prior_perts_saved, bp, cfg.rtpp_alpha)

        self.record_diagnostics(diags)
        self.maybe_update_adaptive_inflation()
        self.post, _ = self.format_posterior_state(bm, bp)
        return self.post, self.obs
