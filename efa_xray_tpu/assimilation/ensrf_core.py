"""Pure-functional EnSRF update kernels (the algorithmic core).

Implements the Whitaker & Hamill (2002) serial ensemble square-root filter
in the augmented-state formulation of the reference
(``efa_xray/assimilation/assimilation.py:146-150``: observation-space priors
appended to the state so H is an index pick), with the reference's exact
per-observation update sequence (``efa_xray/assimilation/ensrf.py:50-149``):

    ye      = row (nstate + i) of the perturbation matrix
    varye   = Var(ye)                      (population variance, np.var)
    innov   = y_i - mean_row(nstate + i)
    kdenom  = varye + R_i
    kcov    = Xbp @ ye / (M - 1), localized by Gaspari-Cohn weights
    K       = kcov / kdenom
    mean   += K * innov
    beta    = 1 / (1 + sqrt(R_i / kdenom))
    Xbp    -= (beta * K) outer ye

Two equivalent execution strategies are provided:

1. :func:`ensrf_serial` — a direct ``lax.scan`` over observations.  One
   fused XLA step per ob; HBM-bound (state read+written once per ob).

2. :func:`ensrf_blocked` — a mathematically *exact* two-phase reformulation
   (same update sequence, re-associated):

   * **Phase 1** (:func:`tail_scan`): run the serial filter on the tiny
     observation-space tail only (``[nobs, nmems]``).  Because ``varye``,
     ``innov``, ``kdenom`` and ``beta`` depend only on the tail, this yields
     the exact per-step ``ye`` vectors and scalar coefficients of the full
     serial algorithm, at O(nobs^2 * nmems) cost.
   * **Phase 2** (:func:`apply_obs_block`): apply observations to the big
     state body in blocks of B.  Within a block the sequential rank-1
     updates compose through a small triangular recurrence on the
     ``[rows, B]`` inner-product matrix, so the state is touched by TWO
     matrix products per block instead of 2B rank-1 passes — memory
     traffic drops by the block factor and the FLOPs move onto the matrix
     units.

   (The re-association is in the same family as iterative Sherman-Morrison
   formulations of the EnKF — cf. Nino-Ruiz, Sandu & Anderson's iterative
   Sherman-Morrison EnKF, arXiv:1302.3876 — specialized here to the
   Whitaker-Hamill square-root update with per-row localization, which is
   what forces the w_j ∘ (...) elementwise structure below.)

   Derivation: with per-row localization weights w_j, coefficients
   g_j = beta_j / (kdenom_j (M-1)) and a_j = innov_j / (kdenom_j (M-1)),
   the serial updates give X_j = X_0 - sum_{i<j} (w_i ∘ d_i) g_i y_i^T
   where d_j = X_j-th-step dot: d_j = X_0 y_j - sum_{i<j} (w_i ∘ d_i) g_i
   (y_i · y_j).  So D_0 = X_0 Y^T (one matmul), the d_j follow from a
   B-step recurrence using the Gram matrix G = Y Y^T, and the final state
   and mean are X_B = X_0 - (U ∘ g) Y and xm + U a with U = [w_j ∘ d_j].

Both strategies are row-parallel in the state dimension: under
``shard_map`` each device runs them on its shard with the tail replicated
and **zero per-observation collectives** — the working realization of the
reference's (broken) chunked-multiprocessing design
(``efa_xray/assimilation/assimilation.py:176-230``).
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

from efa_xray_tpu.observation.localization import (
    chordal_gc_weights,
    gaspari_cohn,
    haversine,
    latlon_to_unit,
)


class ObsArrays(NamedTuple):
    """Per-observation device arrays consumed by the kernels.

    Vertical localization (an extension; the reference carries ``vert``
    but never uses it, ``observation/observation.py:19,27``): when a row
    vertical coordinate is supplied to the kernels, total weights are the
    product of horizontal Gaspari-Cohn (great-circle km) and vertical
    Gaspari-Cohn (|row_vert - vert| in the user's vertical units, e.g.
    hPa or meters).  ``vert_radii = inf`` disables it per ob.
    """

    values: jnp.ndarray  # [No]
    errors: jnp.ndarray  # [No] observation error variance R
    lats: jnp.ndarray  # [No]
    lons: jnp.ndarray  # [No]
    radii: jnp.ndarray  # [No] GC halfwidth km; inf = no localization
    assim: jnp.ndarray  # bool [No] assimilate_this AND qc_ok
    verts: jnp.ndarray = None  # [No] vertical coordinate (0 when unused)
    vert_radii: jnp.ndarray = None  # [No] vertical GC halfwidth; inf = off

    def with_default_verts(self):
        n = self.values.shape[0]
        dtype = self.values.dtype
        verts = self.verts
        vrad = self.vert_radii
        if verts is None:
            verts = jnp.zeros(n, dtype=dtype)
        if vrad is None:
            vrad = jnp.full(n, jnp.inf, dtype=dtype)
        return self._replace(verts=verts, vert_radii=vrad)


class ObsDiagnostics(NamedTuple):
    """Per-observation filter diagnostics (reference writes these onto the
    Observation objects: ``ensrf.py:66-70,144-149``)."""

    prior_mean: jnp.ndarray
    prior_var: jnp.ndarray
    post_mean: jnp.ndarray
    post_var: jnp.ndarray
    assimilated: jnp.ndarray  # bool


class TailSolution(NamedTuple):
    """Phase-1 output: everything the state body needs, per observation.

    In hybrid mode (``hybrid_alpha < 1``) the ensemble coefficients carry
    the ``alpha`` blend factor and two extra per-ob scalars describe the
    FIXED static-covariance column ``s_j = (1-a) sigma_row sigma_ob gc_j /
    kdenom_j``: the state body applies ``mean += sigma_row * (Gc @
    static_gain)`` and ``X -= [g_j (w_j o d_j) + sigma_row static_sqrt_j
    gc_j] Y`` (see :func:`apply_obs_block`)."""

    ye: jnp.ndarray  # [No, M] the pre-update obs-space perturbation rows
    gain_coef: jnp.ndarray  # [No] a_j = [a] innov / (kdenom (M-1)); 0 when skipped
    sqrt_coef: jnp.ndarray  # [No] g_j = [a] beta  / (kdenom (M-1)); 0 when skipped
    tail_mean: jnp.ndarray  # [No] posterior tail mean
    tail_perts: jnp.ndarray  # [No, M] posterior tail perts
    diags: ObsDiagnostics
    # hybrid static-column scalars (None in pure-ensemble mode):
    # static_gain_j = (1-a) sigma_ob_j innov_j / kdenom_j
    # static_sqrt_j = (1-a) sigma_ob_j beta_j  / kdenom_j
    static_gain: Optional[jnp.ndarray] = None  # [No]; 0 when skipped
    static_sqrt: Optional[jnp.ndarray] = None  # [No]; 0 when skipped


def _ye_var(ye, unbiased: bool):
    """Ensemble variance of the obs-space perturbation row.

    ``unbiased=False`` reproduces the reference exactly: ``np.var(ye)``
    (ddof=0, ``ensrf.py:69``) feeding a ddof=1 covariance (``ensrf.py:95``)
    — an inconsistency that makes the analysis weakly observation-order
    dependent.  ``unbiased=True`` uses ddof=1 throughout (textbook
    Whitaker-Hamill), restoring exact order invariance of the analysis
    mean for unlocalized serial assimilation.
    """
    m = jnp.mean(ye)
    sq = (ye - m) ** 2
    if unbiased:
        return jnp.sum(sq) / (ye.shape[0] - 1)
    return jnp.mean(sq)


def _empty_diags(dtype) -> "ObsDiagnostics":
    z = jnp.zeros((0,), dtype=dtype)
    return ObsDiagnostics(z, z, z, z, jnp.zeros((0,), dtype=bool))


def _loc_weights(row_lat, row_lon, ob_lat, ob_lon, radius, localize: bool, dtype,
                 row_xyz=None, ob_xyz=None,
                 row_vert=None, ob_vert=None, vert_radius=None):
    """Gaspari-Cohn weights from one ob to a set of rows; ones when
    localization is globally off (reference ``ensrf.py:99``) or the ob's
    radius is inf (reference crashes on that case; SURVEY.md §2.1/O3).
    When unit vectors are supplied, uses the fast chordal path.  When a row
    vertical coordinate is supplied, multiplies by vertical GC weights."""
    if not localize:
        return None
    if row_xyz is not None:
        w = chordal_gc_weights(row_xyz, ob_xyz, radius).astype(dtype)
    else:
        d = haversine((row_lat, row_lon), (ob_lat, ob_lon))
        w = gaspari_cohn(d, radius).astype(dtype)
    if row_vert is not None:
        w = w * gaspari_cohn(jnp.abs(row_vert - ob_vert), vert_radius).astype(dtype)
    return w


# ---------------------------------------------------------------------------
# Strategy 1: direct serial scan
# ---------------------------------------------------------------------------


@functools.partial(
    jax.jit,
    static_argnames=("localize", "unbiased", "fast_geometry", "vertical",
                     "hybrid_alpha"),
)
def ensrf_serial(
    body_mean,  # [Ns]
    body_perts,  # [Ns, M]
    tail_mean,  # [No]
    tail_perts,  # [No, M]
    body_lat,  # [Ns] per-row latitudes (grid tiled over vars/times)
    body_lon,  # [Ns]
    obs: ObsArrays,
    localize: bool = True,
    unbiased: bool = False,
    fast_geometry: bool = False,
    body_vert=None,  # [Ns] vertical coordinate per row (used when vertical)
    vertical: bool = False,
    hybrid_alpha: float = 1.0,
    body_sigma=None,  # [Ns] static-B std per row (hybrid_alpha < 1)
    tail_sigma=None,  # [No] static-B std at ob locations
    static_length=None,  # scalar km: GC halfwidth of the static correlation
    varloc=None,  # [nv(+1), nvars] cross-variable localization factors:
    # varloc[ob_var, row_var] multiplies the gain like a GC weight
    # (DART-style variable localization; an extension — the reference
    # localizes spatially only, efa_xray/assimilation/ensrf.py:99-115)
    row_var=None,  # [Ns] int32 state-variable index per row
    ob_var=None,  # [No] int32 observed-variable index per ob (row of varloc)
):
    """Serial EnSRF as one ``lax.scan`` over observations.

    Returns ``(body_mean, body_perts, tail_mean, tail_perts, diags)``.

    ``hybrid_alpha < 1`` blends a STATIC climatological background
    covariance into the gain (hybrid ensemble-variational in its simplest
    sequential form; Hamill & Snyder 2000):

        cov(row, ob) = alpha * loc_w * ens_cov
                       + (1 - alpha) * sigma_s(row) sigma_s(ob) GC(d, L_B)
        var(ye)      = alpha * var_ens(ye) + (1 - alpha) * sigma_s(ob)^2

    with the static part held FIXED over the batch (the standard
    hybrid-gain simplification — only the ensemble part tracks the
    sequential update).  ``hybrid_alpha = 0`` is classic Optimal
    Interpolation with a compactly-supported Gaspari-Cohn covariance
    model; ``hybrid_alpha = 1`` (default) is the pure ensemble filter and
    reproduces the reference exactly.  An extension — the reference has no
    static or hybrid covariance at all.
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

    hybrid = hybrid_alpha < 1.0
    if hybrid:
        if body_sigma is None or tail_sigma is None or static_length is None:
            raise ValueError(
                "hybrid_alpha < 1 needs body_sigma, tail_sigma and "
                "static_length"
            )
        alpha = jnp.asarray(hybrid_alpha, dtype)
        bsig = jnp.broadcast_to(
            jnp.asarray(body_sigma, dtype), body_mean.shape
        )
        tsig = jnp.broadcast_to(
            jnp.asarray(tail_sigma, dtype), tail_mean.shape
        )
        slen = jnp.asarray(static_length, dtype)
    use_vl = varloc is not None
    if use_vl:
        if row_var is None or ob_var is None:
            raise ValueError("varloc needs row_var and ob_var")
        if hybrid:
            raise ValueError("varloc does not combine with hybrid "
                             "covariance (the static column would be "
                             "untapered)")
        vl = jnp.asarray(varloc, dtype)
        rvar = jnp.asarray(row_var, jnp.int32)
        ovar_all = jnp.asarray(ob_var, jnp.int32)
    else:
        ovar_all = jnp.zeros(nobs, jnp.int32)

    def step(carry, xs):
        bm, bp, tm, tp = carry
        (i, y, r_err, ob_lat, ob_lon, radius, do_assim, ob_vert,
         ob_vrad, ov) = xs

        ye = jax.lax.dynamic_index_in_dim(tp, i, axis=0, keepdims=False)  # [M]
        mye = tm[i]
        varye = _ye_var(ye, unbiased)

        innov = y - mye
        if hybrid:
            sig_ob = tsig[i]
            varye = alpha * varye + (1.0 - alpha) * sig_ob * sig_ob
        kdenom = varye + r_err
        scale = 1.0 / (kdenom * (nens - 1))
        beta = 1.0 / (1.0 + jnp.sqrt(r_err / kdenom))

        kcov_b = bp @ ye  # [Ns]
        kcov_t = tp @ ye  # [No]
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
            fr = vl[ov]  # [nvars] this ob's factor row
            kcov_b = kcov_b * fr[rvar]
            kcov_t = kcov_t * fr[ovar_all]

        kmat_b = kcov_b * scale
        kmat_t = kcov_t * scale
        if hybrid:
            # Static covariance column: GC-correlated climatological
            # variances, added to the (already loc-tapered, scaled)
            # ensemble gain numerator; kdenom above already blends.
            gcb = _loc_weights(body_lat, body_lon, ob_lat, ob_lon, slen,
                              True, dtype)
            gct = _loc_weights(obs.lats, obs.lons, ob_lat, ob_lon, slen,
                              True, dtype)
            stat_b = bsig * sig_ob * gcb
            stat_t = tsig * sig_ob * gct
            kmat_b = alpha * kmat_b + (1.0 - alpha) * stat_b / kdenom
            kmat_t = alpha * kmat_t + (1.0 - alpha) * stat_t / kdenom

        bm2 = bm + kmat_b * innov
        tm2 = tm + kmat_t * innov
        bp2 = bp - (beta * kmat_b)[:, None] * ye[None, :]
        tp2 = tp - (beta * kmat_t)[:, None] * ye[None, :]

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
        ovar_all,
    )
    with jax.named_scope("ensrf/serial_scan"):
        (bm, bp, tm, tp), diags = jax.lax.scan(
            step, (body_mean, body_perts, tail_mean, tail_perts), xs
        )
    return bm, bp, tm, tp, ObsDiagnostics(*diags)


# ---------------------------------------------------------------------------
# Strategy 2, phase 1: tail-only scan
# ---------------------------------------------------------------------------


@functools.partial(
    jax.jit,
    static_argnames=("localize", "unbiased", "fast_geometry", "vertical",
                     "hybrid_alpha"),
)
def tail_scan(tail_mean, tail_perts, obs: ObsArrays, localize: bool = True,
              unbiased: bool = False, fast_geometry: bool = False,
              vertical: bool = False,
              hybrid_alpha: float = 1.0,
              tail_sigma=None,  # [No] static-B std at ob locations
              static_length=None,
              varloc=None,  # [nv(+1), nvars] cross-variable factors
              ob_var=None  # [No] int32 (tail rows ARE obs rows)
              ) -> TailSolution:
    """Run the serial filter on the observation-space tail only.

    Produces the exact ``ye`` sequence and scalar coefficients the full
    serial algorithm would use, plus all per-ob diagnostics.

    ``hybrid_alpha < 1`` runs the hybrid ensemble-static blend of
    :func:`ensrf_serial` on the tail rows and additionally emits the
    per-ob static-column scalars the body sweep needs (see
    :class:`TailSolution`).
    """
    nens = tail_perts.shape[1]
    dtype = tail_perts.dtype
    nobs = obs.values.shape[0]
    if localize and fast_geometry:
        tail_xyz = latlon_to_unit(obs.lats, obs.lons).astype(dtype)
    else:
        tail_xyz = None
    obs = obs.with_default_verts()
    tail_vert = obs.verts.astype(dtype) if (localize and vertical) else None
    hybrid = hybrid_alpha < 1.0
    if hybrid:
        if tail_sigma is None or static_length is None:
            raise ValueError(
                "hybrid_alpha < 1 needs tail_sigma and static_length"
            )
        alpha = jnp.asarray(hybrid_alpha, dtype)
        tsig = jnp.broadcast_to(
            jnp.asarray(tail_sigma, dtype), tail_mean.shape
        )
        slen = jnp.asarray(static_length, dtype)
    use_vl = varloc is not None
    if use_vl:
        if ob_var is None:
            raise ValueError("varloc needs ob_var")
        if hybrid:
            raise ValueError("varloc does not combine with hybrid "
                             "covariance")
        vl = jnp.asarray(varloc, dtype)
        ovar_all = jnp.asarray(ob_var, jnp.int32)
    else:
        ovar_all = jnp.zeros(nobs, jnp.int32)
    if nobs == 0:
        z = jnp.zeros((0,), dtype=dtype)
        return TailSolution(
            ye=jnp.zeros((0, nens), dtype=dtype),
            gain_coef=z,
            sqrt_coef=z,
            tail_mean=tail_mean,
            tail_perts=tail_perts,
            diags=_empty_diags(dtype),
            static_gain=z if hybrid else None,
            static_sqrt=z if hybrid else None,
        )

    def step(carry, xs):
        tm, tp = carry
        (i, y, r_err, ob_lat, ob_lon, radius, do_assim, ob_vert, ob_vrad,
         ov) = xs

        ye = jax.lax.dynamic_index_in_dim(tp, i, axis=0, keepdims=False)
        mye = tm[i]
        varye = _ye_var(ye, unbiased)

        innov = y - mye
        if hybrid:
            sig_ob = tsig[i]
            varye = alpha * varye + (1.0 - alpha) * sig_ob * sig_ob
        kdenom = varye + r_err
        scale = 1.0 / (kdenom * (nens - 1))
        beta = 1.0 / (1.0 + jnp.sqrt(r_err / kdenom))

        kcov_t = tp @ ye
        vkw = dict(row_vert=tail_vert, ob_vert=ob_vert, vert_radius=ob_vrad) \
            if (localize and vertical) else {}
        if localize and fast_geometry:
            w_t = _loc_weights(None, None, None, None, radius, True, dtype,
                               row_xyz=tail_xyz,
                               ob_xyz=latlon_to_unit(ob_lat, ob_lon).astype(dtype),
                               **vkw)
        else:
            w_t = _loc_weights(obs.lats, obs.lons, ob_lat, ob_lon, radius,
                               localize, dtype, **vkw)
        if localize:
            kcov_t = kcov_t * w_t
        if use_vl:
            kcov_t = kcov_t * vl[ov][ovar_all]

        kmat_t = kcov_t * scale
        if hybrid:
            # Same gain construction as ensrf_serial's hybrid branch:
            # blend the (localized, scaled) ensemble numerator with the
            # fixed static column at the obs rows.
            gct = _loc_weights(obs.lats, obs.lons, ob_lat, ob_lon, slen,
                               True, dtype)
            stat_t = tsig * sig_ob * gct
            kmat_t = alpha * kmat_t + (1.0 - alpha) * stat_t / kdenom
        tm2 = jnp.where(do_assim, tm + kmat_t * innov, tm)
        tp2 = jnp.where(do_assim, tp - (beta * kmat_t)[:, None] * ye[None, :], tp)

        if hybrid:
            gain_coef = jnp.where(do_assim, alpha * innov * scale, 0.0)
            sqrt_coef = jnp.where(do_assim, alpha * beta * scale, 0.0)
            s_base = (1.0 - alpha) * sig_ob / kdenom
            static_gain = jnp.where(do_assim, s_base * innov, 0.0)
            static_sqrt = jnp.where(do_assim, s_base * beta, 0.0)
        else:
            gain_coef = jnp.where(do_assim, innov * scale, 0.0)
            sqrt_coef = jnp.where(do_assim, beta * scale, 0.0)
            static_gain = static_sqrt = jnp.zeros((), dtype)

        post_row = jax.lax.dynamic_index_in_dim(tp2, i, axis=0, keepdims=False)
        out = (
            ye,
            gain_coef,
            sqrt_coef,
            static_gain,
            static_sqrt,
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
        ovar_all,
    )
    with jax.named_scope("ensrf/tail_scan"):
        (tm, tp), (ye, gain, sqrt_c, sg, ss, pm, pv, om, ov, asm) = jax.lax.scan(
            step, (tail_mean, tail_perts), xs
        )
    return TailSolution(
        ye=ye,
        gain_coef=gain,
        sqrt_coef=sqrt_c,
        tail_mean=tm,
        tail_perts=tp,
        diags=ObsDiagnostics(pm, pv, om, ov, asm),
        static_gain=sg if hybrid else None,
        static_sqrt=ss if hybrid else None,
    )


def _panel_weights(pob: ObsArrays, localize: bool, fast_geometry: bool,
                   vertical: bool, dtype, varloc=None, ob_var=None):
    """``[P, P]`` gain factors of each panel ob (row) toward each panel
    ob's tail row (column): GC on the configured geometry, times the
    vertical and cross-variable factors when active (ones when
    unlocalized)."""
    p = pob.values.shape[0]
    if not localize:
        w = jnp.ones((p, p), dtype=dtype)
    elif fast_geometry:
        xyz = latlon_to_unit(pob.lats, pob.lons)
        w = chordal_gc_weights(xyz[None, :, :], xyz[:, None, :],
                               pob.radii[:, None]).astype(dtype)
    else:
        w = gaspari_cohn(
            haversine((pob.lats[None, :], pob.lons[None, :]),
                      (pob.lats[:, None], pob.lons[:, None])),
            pob.radii[:, None],
        ).astype(dtype)
    if localize and vertical:
        w = w * gaspari_cohn(
            jnp.abs(pob.verts[None, :] - pob.verts[:, None]),
            pob.vert_radii[:, None],
        ).astype(dtype)
    if varloc is not None:
        w = w * varloc[ob_var][:, ob_var]
    return w


def _panel_solve_kernel(tm, tp, pob: ObsArrays, localize: bool,
                        unbiased: bool, fast_geometry: bool, vertical: bool,
                        interpret: bool, dtype, varloc=None,
                        ob_var=None) -> TailSolution:
    """Serial solve of one obs panel through the Triton kernel
    (:mod:`efa_xray_tpu.ops.tail_solve_triton`), wrapped as a
    :class:`TailSolution`.  The ob-ob weight matrix is built here in XLA
    and streamed into the kernel."""
    from efa_xray_tpu.ops.tail_solve_triton import tail_panel_solve

    wmat = _panel_weights(pob, localize, fast_geometry, vertical, dtype,
                          varloc=varloc, ob_var=ob_var)
    ptm, ptp, pye, pg, psq, ppm, ppv, pom, pov = tail_panel_solve(
        tm, tp, pob.values, pob.errors, pob.assim, wmat,
        unbiased=unbiased, interpret=interpret,
    )
    return TailSolution(
        ye=pye, gain_coef=pg, sqrt_coef=psq,
        tail_mean=ptm, tail_perts=ptp,
        diags=ObsDiagnostics(ppm, ppv, pom, pov, pob.assim),
    )


@functools.partial(
    jax.jit,
    static_argnames=("localize", "unbiased", "fast_geometry", "vertical",
                     "panel", "hybrid_alpha", "kernels", "interpret"),
)
def tail_scan_blocked(tail_mean, tail_perts, obs: ObsArrays,
                      localize: bool = True, unbiased: bool = False,
                      fast_geometry: bool = False, vertical: bool = False,
                      panel: int = 512,
                      hybrid_alpha: float = 1.0,
                      tail_sigma=None,
                      static_length=None,
                      kernels: bool = False,
                      interpret: bool = False,
                      varloc=None,  # [nv(+1), nvars] cross-variable factors
                      ob_var=None,  # [No] int32
                      ) -> TailSolution:
    """Hierarchical (panel-blocked) phase 1 — same outputs as
    :func:`tail_scan`, exact up to fp reassociation.

    The plain tail scan touches the whole ``[No, M]`` tail once per ob
    (``No`` sequential steps), which dominates the update beyond ~10k obs.
    Here obs are processed in panels of ``B``:

    1. run the ordinary serial scan on just the panel's own ``[B, M]``
       rows (a panel's obs and rows are index-aligned, so this IS
       :func:`tail_scan` on the slice) -> the panel's exact ``ye``/
       coefficient sequence and diagnostics;
    2. apply those B pre-solved obs to every row OUTSIDE the panel with
       the same blocked operator the state body uses
       (:func:`apply_obs_block`; the in-panel rows are masked to zero
       weight since step 1 already updated them).

    Sequential work drops from ``No`` full-tail passes to ``No`` tiny
    ``[B, M]`` steps + ``No/B`` blocked tail passes.

    ``kernels=True`` runs both steps as Triton kernels: step 1 as one
    launch per panel with the slab in registers
    (:mod:`efa_xray_tpu.ops.tail_solve_triton`), step 2 through the body
    kernel (:mod:`efa_xray_tpu.ops.ensrf_triton`).  The in-panel rows
    that the XLA path masks out (``outside``) are overwritten by the
    exact panel solution right after the apply, so masking is
    unnecessary and any row-local applier works.  Not available with the
    hybrid static column.
    """
    nens = tail_perts.shape[1]
    dtype = tail_perts.dtype
    nobs = obs.values.shape[0]
    hybrid = hybrid_alpha < 1.0
    hkw = dict(hybrid_alpha=hybrid_alpha, static_length=static_length) \
        if hybrid else {}
    use_vl = varloc is not None
    vkw = dict(varloc=varloc, ob_var=ob_var) if use_vl else {}
    if kernels and hybrid:
        raise ValueError("the tail kernels have no hybrid static column")
    if nobs == 0 or nobs <= panel:
        if kernels and nobs > 0:
            # One panel covers the whole batch: the kernel solve IS the
            # tail (no out-of-panel rows to apply to).
            return _panel_solve_kernel(
                tail_mean, tail_perts, obs.with_default_verts(),
                localize=localize, unbiased=unbiased,
                fast_geometry=fast_geometry, vertical=vertical,
                interpret=interpret, dtype=dtype,
                varloc=jnp.asarray(varloc, dtype) if use_vl else None,
                ob_var=jnp.asarray(ob_var, jnp.int32) if use_vl else None,
            )
        return tail_scan(tail_mean, tail_perts, obs, localize=localize,
                         unbiased=unbiased, fast_geometry=fast_geometry,
                         vertical=vertical, tail_sigma=tail_sigma, **hkw,
                         **vkw)

    obs = obs.with_default_verts()
    npanels = -(-nobs // panel)
    pad = npanels * panel - nobs

    def padded(x, fill=0.0):
        cfg = [(0, pad)] + [(0, 0)] * (x.ndim - 1)
        return jnp.pad(x.astype(dtype) if x.dtype != jnp.bool_ else x, cfg,
                       constant_values=fill)

    tm = jnp.pad(tail_mean, (0, pad))
    tp = jnp.pad(tail_perts, ((0, pad), (0, 0)))
    values = padded(obs.values)
    errors = padded(obs.errors, 1.0)
    lats = padded(obs.lats)
    lons = padded(obs.lons)
    radii = padded(obs.radii, jnp.inf)
    assim = jnp.pad(obs.assim, (0, pad))  # padded obs are no-ops
    verts = padded(obs.verts)
    vrads = padded(obs.vert_radii, jnp.inf)
    ntot = nobs + pad
    if use_vl:
        vl = jnp.asarray(varloc, dtype)
        ovarr = jnp.pad(jnp.asarray(ob_var, jnp.int32), (0, pad))
    if hybrid:
        tsig_all = jnp.pad(
            jnp.broadcast_to(jnp.asarray(tail_sigma, dtype),
                             tail_mean.shape), (0, pad)
        )
        slen = jnp.asarray(static_length, dtype)

    if localize and fast_geometry:
        all_xyz = latlon_to_unit(lats, lons).astype(dtype)
    else:
        all_xyz = None
    row_idx = jnp.arange(ntot)

    def sl(x, start):
        return jax.lax.dynamic_slice_in_dim(x, start, panel, axis=0)

    def step(carry, p):
        tm, tp = carry
        base = p * panel
        pob = ObsArrays(
            values=sl(values, base),
            errors=sl(errors, base),
            lats=sl(lats, base),
            lons=sl(lons, base),
            radii=sl(radii, base),
            assim=sl(assim, base),
            verts=sl(verts, base),
            vert_radii=sl(vrads, base),
        )
        # 1. exact serial solve on the panel's own rows.
        if kernels:
            sol = _panel_solve_kernel(
                jax.lax.dynamic_slice_in_dim(tm, base, panel),
                jax.lax.dynamic_slice_in_dim(tp, base, panel, axis=0),
                pob, localize=localize, unbiased=unbiased,
                fast_geometry=fast_geometry, vertical=vertical,
                interpret=interpret, dtype=dtype,
                varloc=vl if use_vl else None,
                ob_var=sl(ovarr, base) if use_vl else None,
            )
        else:
            sol = tail_scan(
                jax.lax.dynamic_slice_in_dim(tm, base, panel),
                jax.lax.dynamic_slice_in_dim(tp, base, panel, axis=0),
                pob, localize=localize, unbiased=unbiased,
                fast_geometry=fast_geometry, vertical=vertical,
                tail_sigma=sl(tsig_all, base) if hybrid else None, **hkw,
                **(dict(varloc=vl, ob_var=sl(ovarr, base)) if use_vl
                   else {}),
            )
        # 2. blocked application to all rows outside the panel.  The
        # in-panel rows' apply results are irrelevant — they are
        # overwritten with the exact step-1 solution below — so the
        # applier may touch them freely (the XLA path still masks them to
        # keep fp-identical parity with historical results; the kernel
        # path does not need to).
        if kernels:
            from efa_xray_tpu.ops.ensrf_triton import body_update

            tm2, tp2 = body_update(
                tm, tp, lats, lons, sol, pob,
                localize=localize,
                geometry="chordal" if fast_geometry else "haversine",
                body_vert=verts if (localize and vertical) else None,
                vertical=(localize and vertical),
                varloc=vl if use_vl else None,
                row_var=ovarr if use_vl else None,
                ob_var=sl(ovarr, base) if use_vl else None,
                interpret=interpret,
            )
            tm2 = jax.lax.dynamic_update_slice_in_dim(
                tm2, sol.tail_mean, base, axis=0)
            tp2 = jax.lax.dynamic_update_slice_in_dim(
                tp2, sol.tail_perts, base, axis=0)
            return (tm2, tp2), (sol.ye, sol.gain_coef, sol.sqrt_coef,
                                sol.diags)
        outside = ((row_idx < base) | (row_idx >= base + panel)).astype(dtype)
        if localize and fast_geometry:
            pxyz = sl(all_xyz, base)
            w = chordal_gc_weights(
                all_xyz[:, None, :], pxyz[None, :, :], pob.radii[None, :]
            ).astype(dtype)
        elif localize:
            w = gaspari_cohn(
                haversine((lats[:, None], lons[:, None]),
                          (pob.lats[None, :], pob.lons[None, :])),
                pob.radii[None, :],
            ).astype(dtype)
        else:
            w = jnp.ones((ntot, panel), dtype=dtype)
        if localize and vertical:
            w = w * gaspari_cohn(
                jnp.abs(verts[:, None] - pob.verts[None, :]),
                pob.vert_radii[None, :],
            ).astype(dtype)
        if use_vl:
            # factor[r, j] = vl[panel_ob_var_j, row_ob_var_r]
            w = w * vl[sl(ovarr, base)][:, ovarr].T
        w = w * outside[:, None]
        static_mean = static_tilde = None
        if hybrid:
            # Static columns toward all OUT-of-panel obs rows (in-panel
            # rows were already updated exactly in step 1, hence the same
            # `outside` mask).  Static geometry is exact haversine — part
            # of the covariance model's definition.
            gc = gaspari_cohn(
                haversine((lats[:, None], lons[:, None]),
                          (pob.lats[None, :], pob.lons[None, :])),
                slen,
            ).astype(dtype) * outside[:, None]
            static_mean = tsig_all * (gc @ sol.static_gain)
            static_tilde = tsig_all[:, None] * gc * sol.static_sqrt[None, :]
        tm2, tp2 = apply_obs_block(
            tm, tp, sol.ye, sol.gain_coef, sol.sqrt_coef, w,
            static_mean=static_mean, static_tilde=static_tilde,
        )
        # panel rows were updated exactly in step 1; write them back.
        tm2 = jax.lax.dynamic_update_slice_in_dim(tm2, sol.tail_mean, base,
                                                  axis=0)
        tp2 = jax.lax.dynamic_update_slice_in_dim(tp2, sol.tail_perts, base,
                                                  axis=0)
        outs = (sol.ye, sol.gain_coef, sol.sqrt_coef, sol.diags)
        if hybrid:
            outs = outs + (sol.static_gain, sol.static_sqrt)
        return (tm2, tp2), outs

    with jax.named_scope("ensrf/tail_scan_blocked"):
        (tm, tp), outs = jax.lax.scan(step, (tm, tp), jnp.arange(npanels))
    if hybrid:
        ye, gain, sqrtc, diags, sgain, ssqrt = outs
    else:
        ye, gain, sqrtc, diags = outs
        sgain = ssqrt = None

    flat = lambda x: x.reshape((npanels * panel,) + x.shape[2:])[:nobs]
    return TailSolution(
        ye=flat(ye),
        gain_coef=flat(gain),
        sqrt_coef=flat(sqrtc),
        tail_mean=tm[:nobs],
        tail_perts=tp[:nobs],
        diags=ObsDiagnostics(*(flat(d) for d in diags)),
        static_gain=flat(sgain) if hybrid else None,
        static_sqrt=flat(ssqrt) if hybrid else None,
    )


# ---------------------------------------------------------------------------
# Strategy 2, phase 2: blocked state-body update
# ---------------------------------------------------------------------------


def _block_recurrence(d0, gram, w, gain_coef, sqrt_coef, panel: int = 8,
                      static_tilde=None):
    """Solve the within-block triangular recurrence (panel-blocked).

    d0:   [rows, B]  = X_0 @ Y^T
    gram: [B, B]     = Y @ Y^T
    w:    [rows, B]  per-row localization weights (or None)
    static_tilde: [rows, B] hybrid static-column term beta_j s_j (or None)
    Returns ``(U, V)``: U = [w_j ∘ d_j] columns and the full perturbation
    gain columns V = [g_j U_j + static_tilde_j], both [rows, B].  (In pure
    ensemble mode V = U * g; it is returned so hybrid and pure share one
    code path and the perts update is always ``X - V @ Y``.)

    Forward substitution is panel-blocked: corrections against already-
    solved columns are dense [rows, done] x [done, P] matmuls (one per
    panel) instead of one [rows, B] matvec per step — this cuts re-reads
    of V from B to B/P passes and keeps the FLOPs in matrix products.  The
    correction for step j subtracts V's columns against the Gram matrix:
    d_j = (X_0 Y^T)_j - sum_{i<j} V_i G_ij, which reduces to the pure
    recurrence of the module docstring when static_tilde is None.
    """
    bsz = d0.shape[1]

    # Accumulate solved columns incrementally (one concatenate per panel +
    # one per in-panel step on a <= panel-wide slab).  A naive
    # re-stack-all-columns-per-step formulation traces O(B^2) stack ops,
    # which blows up compile time at the default block_size=128.
    u_done = None  # [rows, base] U columns solved in previous panels
    v_done = None  # [rows, base] V columns (drive the corrections)
    for base in range(0, bsz, panel):
        width = min(panel, bsz - base)
        d_panel = jax.lax.slice_in_dim(d0, base, base + width, axis=1)
        if base > 0:
            d_panel = d_panel - v_done @ gram[:base, base : base + width]
        u_cols, v_cols = [], []
        for t in range(width):
            d_j = d_panel[:, t]
            if t > 0:
                v_p = jnp.stack(v_cols, axis=1)  # [rows, t], t < panel
                d_j = d_j - v_p @ gram[base : base + t, base + t]
            u_j = d_j if w is None else w[:, base + t] * d_j
            v_j = u_j * sqrt_coef[base + t]
            if static_tilde is not None:
                v_j = v_j + static_tilde[:, base + t]
            u_cols.append(u_j)
            v_cols.append(v_j)
        u_slab = jnp.stack(u_cols, axis=1)  # [rows, width]
        v_slab = jnp.stack(v_cols, axis=1)
        u_done = u_slab if u_done is None else jnp.concatenate(
            [u_done, u_slab], axis=1)
        v_done = v_slab if v_done is None else jnp.concatenate(
            [v_done, v_slab], axis=1)
    return u_done, v_done


@jax.jit
def apply_obs_block(body_mean, body_perts, ye_block, gain_coef, sqrt_coef,
                    w_block, static_mean=None, static_tilde=None,
                    apply_rows=None):
    """Apply one block of B pre-solved observations to the state body.

    ``ye_block [B, M]``, coefficients ``[B]``, ``w_block [rows, B]`` (or
    None for no localization).  Two matrix products + a B-step recurrence.

    Hybrid static-covariance extension (generalizes the reference's pure
    ensemble gain, ``efa_xray/assimilation/ensrf.py:95,119``): the static
    column of ob j is fixed over the block, so its whole contribution
    enters as two precomputed terms — ``static_mean [rows]`` (the summed
    mean pull ``sigma_row * (Gc @ static_gain)``) added once, and
    ``static_tilde [rows, B]`` (``sigma_row static_sqrt_j gc_j`` columns)
    riding the same recurrence/matmul as the ensemble part.

    ``apply_rows [B, M]`` (default: ``ye_block``): the rows the solved
    gain columns are applied AGAINST — for the square-root filter these
    are the ``ye`` rows themselves (perts update ``X - V @ Y``,
    ``efa_xray/assimilation/ensrf.py:141``); for the stochastic EnKF they
    are the perturbed-ob departures ``z = ye - eps`` (Burgers et al. 1998
    eq. 10), and the correction Gram becomes ``A @ Y^T`` since later obs'
    priors see the state updated by ``V @ A``.
    """
    y = ye_block.astype(body_perts.dtype)
    a = y if apply_rows is None else apply_rows.astype(body_perts.dtype)
    d0 = jnp.dot(body_perts, y.T, preferred_element_type=body_perts.dtype)
    # gram[i, j] = a_i . ye_j: the prior of (later) ob j picks up column i
    # through the ``- V @ A`` perts update.  Pure square-root mode has
    # a == y and this is the usual symmetric Ye Gram.
    gram = jnp.dot(a, y.T, preferred_element_type=body_perts.dtype)
    u, v = _block_recurrence(d0, gram, w_block, gain_coef, sqrt_coef,
                             static_tilde=static_tilde)
    body_mean = body_mean + u @ gain_coef
    if static_mean is not None:
        body_mean = body_mean + static_mean
    body_perts = body_perts - jnp.dot(
        v, a, preferred_element_type=body_perts.dtype
    )
    return body_mean, body_perts


@functools.partial(
    jax.jit,
    static_argnames=("localize", "block_size", "fast_geometry", "vertical",
                     "hybrid"),
)
def ensrf_blocked_body(
    body_mean,
    body_perts,
    body_lat,
    body_lon,
    tail: TailSolution,
    obs: ObsArrays,
    localize: bool = True,
    block_size: int = 32,
    fast_geometry: bool = False,
    body_vert=None,
    vertical: bool = False,
    hybrid: bool = False,
    body_sigma=None,  # [Ns] static-B std per row (hybrid mode)
    static_length=None,  # scalar km: GC halfwidth of the static correlation
    apply_rows=None,  # [No, M] alternative apply rows (stochastic EnKF:
    # z = ye - eps; see apply_obs_block)
    varloc=None,  # [nv(+1), nvars] cross-variable localization factors
    row_var=None,  # [Ns] int32 state-variable index per row
    ob_var=None,  # [No] int32 observed-variable index per ob
):
    """Phase 2: sweep the pre-solved observation sequence over the state
    body in blocks.  Exact (up to fp reassociation) match of the serial
    algorithm.

    ``hybrid=True`` additionally applies each ob's FIXED static-covariance
    column (``tail.static_gain``/``static_sqrt`` scalars times the per-row
    ``sigma_row gc_j`` profile at ``static_length``) through the same
    block recurrence — the hybrid generalization of the serial path."""
    nobs = tail.ye.shape[0]
    dtype = body_perts.dtype
    if nobs == 0:
        return body_mean, body_perts
    if hybrid and (body_sigma is None or static_length is None
                   or tail.static_gain is None):
        raise ValueError(
            "hybrid blocked body needs body_sigma, static_length and a "
            "hybrid-mode TailSolution (static_gain/static_sqrt)"
        )
    if hybrid and apply_rows is not None:
        raise ValueError("apply_rows (stochastic EnKF) does not combine "
                         "with hybrid covariance")
    nblocks = -(-nobs // block_size)
    pad = nblocks * block_size - nobs

    obs = obs.with_default_verts()
    ye = jnp.pad(tail.ye, ((0, pad), (0, 0)))
    gain = jnp.pad(tail.gain_coef, (0, pad))
    sqrtc = jnp.pad(tail.sqrt_coef, (0, pad))
    ob_lat = jnp.pad(obs.lats.astype(dtype), (0, pad))
    ob_lon = jnp.pad(obs.lons.astype(dtype), (0, pad))
    radii = jnp.pad(obs.radii.astype(dtype), (0, pad), constant_values=jnp.inf)
    ob_vert = jnp.pad(obs.verts.astype(dtype), (0, pad))
    ob_vrad = jnp.pad(obs.vert_radii.astype(dtype), (0, pad), constant_values=jnp.inf)
    use_vl = varloc is not None
    if use_vl:
        if row_var is None or ob_var is None:
            raise ValueError("varloc needs row_var and ob_var")
        if hybrid:
            raise ValueError("varloc does not combine with hybrid "
                             "covariance")
        vl = jnp.asarray(varloc, dtype)
        rvar = jnp.asarray(row_var, jnp.int32)
        ovar_b = jnp.pad(jnp.asarray(ob_var, jnp.int32), (0, pad)).reshape(
            nblocks, block_size)
    else:
        ovar_b = jnp.zeros((nblocks, block_size), jnp.int32)

    ye_b = ye.reshape(nblocks, block_size, -1)
    # Apply rows ride the scan alongside ye; the dispatch below is
    # Python-static, so the square-root path (apply_rows=None) still
    # traces apply_obs_block's symmetric a == y form and the dummy xs
    # entry is dead-code-eliminated.
    use_ar = apply_rows is not None
    ar_b = (ye_b if not use_ar
            else jnp.pad(apply_rows.astype(dtype), ((0, pad), (0, 0)))
            .reshape(nblocks, block_size, -1))
    gain_b = gain.reshape(nblocks, block_size).astype(dtype)
    sqrt_b = sqrtc.reshape(nblocks, block_size).astype(dtype)
    lat_b = ob_lat.reshape(nblocks, block_size)
    lon_b = ob_lon.reshape(nblocks, block_size)
    rad_b = radii.reshape(nblocks, block_size)
    vert_b = ob_vert.reshape(nblocks, block_size)
    vrad_b = ob_vrad.reshape(nblocks, block_size)
    if hybrid:
        # Padded obs carry zero static coefficients, so their (arbitrary)
        # gc columns contribute nothing.
        sgain_b = jnp.pad(tail.static_gain, (0, pad)).reshape(
            nblocks, block_size).astype(dtype)
        ssqrt_b = jnp.pad(tail.static_sqrt, (0, pad)).reshape(
            nblocks, block_size).astype(dtype)
        bsig = jnp.broadcast_to(
            jnp.asarray(body_sigma, dtype), body_mean.shape
        )
        slen = jnp.asarray(static_length, dtype)
    else:
        z = jnp.zeros((nblocks, block_size), dtype)
        sgain_b = ssqrt_b = z

    if localize and fast_geometry:
        body_xyz = latlon_to_unit(body_lat, body_lon).astype(dtype)
    else:
        body_xyz = None

    def step(carry, xs):
        bm, bp = carry
        yb, ab, gb, sb, latb, lonb, radb, vertb, vradb, sgb, ssb, ovb = xs
        if localize and fast_geometry:
            ob_xyz = latlon_to_unit(latb, lonb).astype(dtype)
            w = chordal_gc_weights(
                body_xyz[:, None, :], ob_xyz[None, :, :], radb[None, :]
            ).astype(dtype)
        elif localize:
            d = haversine(
                (body_lat[:, None], body_lon[:, None]), (latb[None, :], lonb[None, :])
            )
            w = gaspari_cohn(d, radb[None, :]).astype(dtype)
        else:
            w = None
        if localize and vertical:
            w = w * gaspari_cohn(
                jnp.abs(body_vert.astype(dtype)[:, None] - vertb[None, :]),
                vradb[None, :],
            ).astype(dtype)
        if use_vl:
            # factor[i, j] = vl[block_ob_var_j, row_var_i] — enters the
            # recurrence exactly like a GC weight (per-(row, ob)), so
            # blocked == serial stays exact.
            fmat = vl[ovb][:, rvar].T  # [Ns, B]
            w = fmat if w is None else w * fmat
        static_mean = static_tilde = None
        if hybrid:
            # Static correlation profile of the block's obs (GC at the
            # static length, exact haversine — the static model's geometry
            # is part of its definition, independent of fast_geometry).
            gc = gaspari_cohn(
                haversine((body_lat[:, None], body_lon[:, None]),
                          (latb[None, :], lonb[None, :])),
                slen,
            ).astype(dtype)
            static_mean = bsig * (gc @ sgb)
            static_tilde = bsig[:, None] * gc * ssb[None, :]
        bm, bp = apply_obs_block(bm, bp, yb, gb, sb, w,
                                 static_mean=static_mean,
                                 static_tilde=static_tilde,
                                 apply_rows=ab if use_ar else None)
        return (bm, bp), None

    with jax.named_scope("ensrf/block_update"):
        (bm, bp), _ = jax.lax.scan(
            step,
            (body_mean, body_perts),
            (ye_b, ar_b, gain_b, sqrt_b, lat_b, lon_b, rad_b, vert_b,
             vrad_b, sgain_b, ssqrt_b, ovar_b),
        )
    return bm, bp


def ensrf_blocked(
    body_mean,
    body_perts,
    tail_mean,
    tail_perts,
    body_lat,
    body_lon,
    obs: ObsArrays,
    localize: bool = True,
    block_size: int = 32,
    unbiased: bool = False,
    fast_geometry: bool = False,
    body_vert=None,
    vertical: bool = False,
    tail_panel: Optional[int] = None,
    hybrid_alpha: float = 1.0,
    body_sigma=None,
    tail_sigma=None,
    static_length=None,
    varloc=None,  # [nv(+1), nvars] cross-variable localization factors
    row_var=None,  # [Ns] int32
    ob_var=None,  # [No] int32
):
    """Full blocked update: phase-1 tail scan + phase-2 blocked body sweep.

    Drop-in equivalent of :func:`ensrf_serial` (same returns, including
    the hybrid ensemble-static blend for ``hybrid_alpha < 1`` and the
    ``varloc`` cross-variable localization factors).
    ``tail_panel``: panel size for the hierarchical phase-1 solve (None =
    plain per-ob scan; a panel only pays off beyond a few thousand obs).
    """
    hybrid = hybrid_alpha < 1.0
    hkw = dict(hybrid_alpha=hybrid_alpha, tail_sigma=tail_sigma,
               static_length=static_length) if hybrid else {}
    vkw = dict(varloc=varloc, ob_var=ob_var) if varloc is not None else {}
    if tail_panel:
        tail = tail_scan_blocked(tail_mean, tail_perts, obs,
                                 localize=localize, unbiased=unbiased,
                                 fast_geometry=fast_geometry,
                                 vertical=vertical, panel=tail_panel,
                                 **hkw, **vkw)
    else:
        tail = tail_scan(tail_mean, tail_perts, obs, localize=localize,
                         unbiased=unbiased, fast_geometry=fast_geometry,
                         vertical=vertical, **hkw, **vkw)
    bm, bp = ensrf_blocked_body(
        body_mean,
        body_perts,
        body_lat,
        body_lon,
        tail,
        obs,
        localize=localize,
        block_size=block_size,
        fast_geometry=fast_geometry,
        body_vert=body_vert,
        vertical=vertical,
        hybrid=hybrid,
        body_sigma=body_sigma if hybrid else None,
        static_length=static_length if hybrid else None,
        varloc=varloc,
        row_var=row_var,
        ob_var=ob_var,
    )
    return bm, bp, tail.tail_mean, tail.tail_perts, tail.diags
