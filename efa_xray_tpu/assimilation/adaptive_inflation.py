"""Spatially/temporally varying adaptive covariance inflation.

Capability parity with ``efa_xray/assimilation/adaptive_inflation.py:8-80``
(Anderson 2009, Tellus 61A, 72-83): an inflation field with two moments
(mean, std) per state variable on the state grid, load-or-initialize
semantics, perturbation inflation by the mean field, and netCDF checkpoint.

The reference never implemented the actual *adaptive* step — the Bayesian
update of the inflation distribution from observation innovations (SURVEY.md
§2/A8 notes its absence).  :meth:`AdaptiveInflation.update_inflation`
implements it here following Anderson (2009) eqs. 3-10 (the same linearized
Gaussian-likelihood scheme used by DART's ``adaptive_inflate_mod``):

    for each observation with innovation d, prior obs-space ensemble
    variance s², error variance r², and localization weight γ to a state
    point with inflation mean λ̄:

        λ̃      = (1 + γ(√λ̄ − 1))²          (localized inflation)
        θ²     = λ̃ s² + r²                  (expected innovation variance)
        l(λ̄)   = N(d; 0, θ²)                (likelihood at the prior mean)
        l'(λ̄)  = dl/dλ via dθ/dλ = γ s² (1 + γ(√λ̄ − 1)) / (2 θ √λ̄)
        posterior mode = root of λ² + bλ + c closest to λ̄, with
        b = l/l' − 2λ̄,  c = λ̄² − σ_λ² − l λ̄ / l'

    σ_λ, the inflation standard deviation, may be held fixed (the default,
    matching the moment fields the reference stores but never updates) or
    evolved per Anderson (2009) §4 with ``evolve_sd=True``: fit a Gaussian
    to the posterior by evaluating the posterior density ratio

        R = p(λ_u + σ_λ | d) / p(λ_u | d)          (log space)
        σ_λ,u² = −σ_λ² / (2 ln R)

    clipped to never grow and floored at ``sd_min`` so inflation never
    freezes entirely (the El Gharamti 2018 lower-bound refinement).  The
    shrinking σ_λ is the principled damping that removes the need for a
    hand-tuned fixed sd or a hard λ_max cap.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from efa_xray_tpu.observation.localization import gaspari_cohn, haversine
from efa_xray_tpu.state.ensemble import EnsembleState
from efa_xray_tpu.utils import ncio, timeutil


@jax.jit
def _anderson_update(
    lam_mean,  # [rows] current inflation mean per state row
    lam_sd,  # scalar inflation std (held fixed)
    gamma,  # [rows] localization weight of this ob at each row
    innov2,  # scalar d^2
    sigma_p2,  # scalar prior obs-space ensemble variance s^2
    sigma_o2,  # scalar ob error variance r^2
    lambda_min=1.0,
    lambda_max=1e6,
):
    """One observation's Bayesian update of the inflation mean field.

    ``lambda_min``/``lambda_max`` are traced operands (plain ``jnp.clip``
    bounds), NOT static jit arguments — callers like
    :func:`update_inflation_rows` pass them through from their own traced
    context, and a tracer in a static slot poisons the jit cache."""
    sqrt_lam = jnp.sqrt(jnp.maximum(lam_mean, 1e-12))
    lam_loc = (1.0 + gamma * (sqrt_lam - 1.0)) ** 2
    theta2 = lam_loc * sigma_p2 + sigma_o2
    theta = jnp.sqrt(theta2)

    # Gaussian likelihood of the innovation and its lambda-derivative.
    l_bar = jnp.exp(-0.5 * innov2 / theta2) / (jnp.sqrt(2.0 * jnp.pi) * theta)
    dtheta_dlam = (
        0.5 * gamma * sigma_p2 * (1.0 + gamma * (sqrt_lam - 1.0)) / (theta * sqrt_lam)
    )
    l_prime = l_bar * (innov2 / theta2 - 1.0) / theta * dtheta_dlam

    # Posterior mode: root of lambda^2 + b lambda + c closest to lam_mean.
    safe = jnp.abs(l_prime) > 1e-30
    lp = jnp.where(safe, l_prime, 1.0)
    b = l_bar / lp - 2.0 * lam_mean
    c = lam_mean**2 - lam_sd**2 - l_bar * lam_mean / lp
    disc = jnp.maximum(b**2 - 4.0 * c, 0.0)
    sq = jnp.sqrt(disc)
    r1 = (-b + sq) / 2.0
    r2 = (-b - sq) / 2.0
    new_lam = jnp.where(jnp.abs(r1 - lam_mean) < jnp.abs(r2 - lam_mean), r1, r2)
    new_lam = jnp.where(safe & (gamma > 0.0), new_lam, lam_mean)
    return jnp.clip(new_lam, lambda_min, lambda_max)


def _log_posterior(lam, lam_prior, lam_sd, gamma, innov2, sigma_p2, sigma_o2):
    """Unnormalized log posterior density of the inflation λ given one
    innovation: log N(d; 0, θ²(λ)) + log N(λ; λ̄_p, σ_λ²).  Log space keeps
    the Anderson §4 density RATIO well-defined where the float32 likelihood
    would underflow (large d²/θ²)."""
    sqrt_lam = jnp.sqrt(jnp.maximum(lam, 1e-12))
    theta2 = (1.0 + gamma * (sqrt_lam - 1.0)) ** 2 * sigma_p2 + sigma_o2
    log_l = -0.5 * (jnp.log(theta2) + innov2 / theta2)
    sd2 = jnp.maximum(lam_sd, 1e-12) ** 2
    return log_l - 0.5 * (lam - lam_prior) ** 2 / sd2


@jax.jit
def _anderson_sd_update(
    lam_post,  # [rows] posterior inflation mean (this ob already applied)
    lam_prior,  # [rows] prior inflation mean
    lam_sd,  # [rows] prior inflation std
    gamma,  # [rows] localization weight
    innov2,  # scalar d^2
    sigma_p2,  # scalar prior obs-space ensemble variance
    sigma_o2,  # scalar ob error variance
    sd_min=0.0,
):
    """Anderson (2009) §4 Gaussian refit of the inflation std.

    Evaluate the posterior density at the mode λ_u and one prior-sd above
    it; matching the log-ratio to a Gaussian gives σ_u² = −σ²/(2 ln R).
    The refit never grows σ (the posterior is at least as sharp as the
    prior) and is floored at ``sd_min`` so the inflation stays adaptive
    (El Gharamti 2018's lower bound)."""
    log_r = _log_posterior(
        lam_post + lam_sd, lam_prior, lam_sd, gamma, innov2, sigma_p2, sigma_o2
    ) - _log_posterior(
        lam_post, lam_prior, lam_sd, gamma, innov2, sigma_p2, sigma_o2
    )
    shrinking = log_r < -1e-12
    denom = jnp.where(shrinking, -2.0 * log_r, 1.0)
    sd_new = lam_sd * jnp.sqrt(1.0 / denom)
    sd_new = jnp.where(shrinking & (gamma > 0.0), sd_new, lam_sd)
    return jnp.clip(sd_new, sd_min, lam_sd)


@functools.partial(jax.jit, static_argnames=("evolve_sd",))
def update_inflation_rows(
    lam,  # [..., rows] inflation mean field(s); last axis matches row coords
    lam_sd,  # scalar or broadcastable [..., 1] inflation std
    row_lats,  # [rows]
    row_lons,  # [rows]
    obs_lats,  # [No]
    obs_lons,  # [No]
    radii,  # [No] GC halfwidth km (inf -> uniform weight 1)
    innovations,  # [No]
    prior_vars,  # [No] prior obs-space ensemble variance
    ob_err_vars,  # [No]
    assim,  # bool [No]
    lambda_min=1.0,
    lambda_max=1e6,
    evolve_sd: bool = False,
    sd_min=0.0,
):
    """Anderson (2009) update of an inflation field from an obs batch.

    One ``lax.scan`` over observations; the per-ob localization weight
    ``gamma [rows]`` broadcasts against any leading lam axes, so the same
    kernel serves flat per-row fields (``lam [rows]``, cycling harness) and
    stacked grid fields (``lam [V, T, G]`` with per-variable
    ``lam_sd [V, 1, 1]``, :class:`AdaptiveInflation`).

    With ``evolve_sd=True`` the inflation std is carried per element and
    refit after every observation (Anderson §4, :func:`_anderson_sd_update`)
    — the principled damping — and the return value is ``(lam, lam_sd)``
    with ``lam_sd`` broadcast to ``lam``'s shape.  Default returns ``lam``
    only (historical fixed-sd behavior)."""

    if not evolve_sd:

        def step(lam, xs):
            ob_lat, ob_lon, radius, d2, sp2, so2, use = xs
            gamma = gaspari_cohn(
                haversine((row_lats, row_lons), (ob_lat, ob_lon)), radius
            )
            new = _anderson_update(
                lam, lam_sd, gamma, d2, sp2, so2,
                lambda_min=lambda_min, lambda_max=lambda_max,
            )
            return jnp.where(use, new, lam), None

        xs = (obs_lats, obs_lons, radii, innovations**2, prior_vars,
              ob_err_vars, assim)
        lam, _ = jax.lax.scan(step, lam, xs)
        return lam

    sd0 = jnp.broadcast_to(
        jnp.asarray(lam_sd, dtype=lam.dtype), lam.shape
    ).astype(lam.dtype)

    def step(carry, xs):
        lam, sd = carry
        ob_lat, ob_lon, radius, d2, sp2, so2, use = xs
        gamma = gaspari_cohn(
            haversine((row_lats, row_lons), (ob_lat, ob_lon)), radius
        )
        new = _anderson_update(
            lam, sd, gamma, d2, sp2, so2,
            lambda_min=lambda_min, lambda_max=lambda_max,
        )
        new_sd = _anderson_sd_update(
            new, lam, sd, gamma, d2, sp2, so2, sd_min=sd_min
        )
        return (
            jnp.where(use, new, lam),
            jnp.where(use, new_sd, sd),
        ), None

    (lam, sd), _ = jax.lax.scan(step, (lam, sd0), xs=(
        obs_lats, obs_lons, radii, innovations**2, prior_vars, ob_err_vars,
        assim,
    ))
    return lam, sd




# ---------------------------------------------------------------------------
# Colored (batched) Anderson update — SURVEY.md §5.7's "non-overlapping
# localization regions" trick, exact here because the inflation update is
# purely ROW-LOCAL (no obs-space tail couples observations): two obs whose
# Gaspari-Cohn supports are disjoint update disjoint rows, so they commute
# bit-for-bit.  Color the obs so no two same-colored supports overlap;
# each color is then ONE vectorized full-field update with per-row ob
# attributes — ~1e2 steps instead of ~1e4 at the production scale.  (A
# gather/scatter WINDOWED scan is the other candidate; on the previous
# accelerator its gathers cost more than the elementwise work they saved.
# It has not been measured on a GPU.)
#
# The result equals the sequential scan in the COLOR order (colors
# ascending, caller order within a color) — a valid serial order like any
# other; the Anderson update, like the filter itself, is weakly
# order-dependent.
# ---------------------------------------------------------------------------

import collections as _collections
import hashlib as _hashlib

_COLOR_CACHE: "_collections.OrderedDict" = _collections.OrderedDict()
_COLOR_CACHE_MAX = 8


def build_obs_coloring(row_lats, row_lons, obs_lats, obs_lons, radii,
                       max_colors_fraction: float = 0.25,
                       slack_km: float = 2.0):
    """Host-side obs coloring + per-(color, row) ob assignment.

    Returns ``(order [No], color_sizes [C], row_ob [C, rows] int32)`` or
    ``None`` when coloring cannot help (non-finite radii, or more than
    ``max_colors_fraction * No`` colors — overlap too dense to batch).

    ``order`` lists obs colors-ascending (caller order within a color);
    ``row_ob[c, g]`` is the LOCAL index (into color c's slice of
    ``order``) of the unique same-colored ob whose support covers row g,
    or -1.  Cached per (coords, radii) digest — stationary networks build
    once, like the forward-operator taps."""
    row_lats = np.asarray(row_lats, np.float64)
    row_lons = np.asarray(row_lons, np.float64)
    obs_lats = np.asarray(obs_lats, np.float64)
    obs_lons = np.asarray(obs_lons, np.float64)
    radii = np.asarray(radii, np.float64)
    if not np.isfinite(radii).all():
        return None
    nobs = obs_lats.shape[0]
    nrows = row_lats.shape[0]

    h = _hashlib.sha1()
    for a in (row_lats, row_lons, obs_lats, obs_lons, radii):
        h.update(np.ascontiguousarray(a).tobytes())
    # The cached row map is DEVICE-resident: key on the default backend
    # too, so a host-fastpath (cpu) build never collides with an
    # accelerator run of the same network (cross-device operands raise in
    # jax).
    key = (h.hexdigest(), float(max_colors_fraction), float(slack_km),
           jax.default_backend())
    if key in _COLOR_CACHE:
        _COLOR_CACHE.move_to_end(key)
        return _COLOR_CACHE[key]

    from scipy.spatial import cKDTree

    def unit(lat, lon):
        la, lo = np.radians(lat), np.radians(lon)
        cl = np.cos(la)
        return np.stack([cl * np.cos(lo), cl * np.sin(lo), np.sin(la)], -1)

    oxyz = unit(obs_lats, obs_lons)
    tree = cKDTree(oxyz)
    # conflict iff great-circle dist < 2 (r_i + r_j) (+slack): supports
    # are open disks of radius 2 r each.
    rmax = float(radii.max())
    ang_i = np.minimum(2.0 * (radii + rmax + slack_km) / 6371.0, np.pi)
    chord_i = 2.0 * np.sin(ang_i / 2.0)
    colors = np.full(nobs, -1, np.int64)
    neigh = tree.query_ball_point(oxyz, chord_i, workers=-1)
    for i in range(nobs):
        used = set()
        for j in neigh[i]:
            if j == i or colors[j] < 0:
                continue
            # exact pairwise test (the query radius over-approximates)
            dot = float(np.clip(np.dot(oxyz[i], oxyz[j]), -1.0, 1.0))
            if 6371.0 * np.arccos(dot) < 2.0 * (radii[i] + radii[j]) + slack_km:
                used.add(int(colors[j]))
        c = 0
        while c in used:
            c += 1
        colors[i] = c
    ncolors = int(colors.max()) + 1
    if ncolors > max_colors_fraction * max(nobs, 4):
        out = None
        _COLOR_CACHE[key] = out
        return out

    order = np.argsort(colors, kind="stable").astype(np.int64)
    color_sizes = np.bincount(colors, minlength=ncolors)

    # per-(color, row) unique covering ob (uniqueness: same-colored
    # supports are disjoint).  Assign by per-OB support ball queries on a
    # rows tree — a nearest-ob query would mis-assign with mixed radii (a
    # row can sit outside its nearest ob's support yet inside a farther,
    # wider ob's).
    rtree = cKDTree(unit(row_lats, row_lons))
    row_ob = np.full((ncolors, nrows), -1, np.int32)
    ang_o = np.minimum((2.0 * radii + slack_km) / 6371.0, np.pi)
    chord_o = 2.0 * np.sin(ang_o / 2.0)
    off = 0
    for c in range(ncolors):
        idx = order[off : off + color_sizes[c]]
        for local, j in enumerate(idx):
            rows_in = rtree.query_ball_point(oxyz[j], chord_o[j])
            row_ob[c, rows_in] = local
        off += color_sizes[c]
    # Device-resident row map: [C, rows] int32 is 56 MB at the production
    # scale — upload once per network, not once per cycle.
    out = (order, color_sizes.astype(np.int64), jnp.asarray(row_ob))
    _COLOR_CACHE[key] = out
    while len(_COLOR_CACHE) > _COLOR_CACHE_MAX:
        _COLOR_CACHE.popitem(last=False)
    return out


@functools.partial(jax.jit, static_argnames=("evolve_sd",))
def update_inflation_rows_colored(
    lam,  # [..., rows]
    lam_sd,
    row_lats,  # [rows]
    row_lons,  # [rows]
    row_ob,  # [C, rows] int32 local covering-ob index per color (-1 = none)
    ob_attrs,  # [C, n_max, 6] padded per-color ob tables:
    # (lat, lon, radius, d2, sp2, so2); padding rows are all-zero
    ob_use,  # [C, n_max] bool (assim AND not padding)
    lambda_min=1.0,
    lambda_max=1e6,
    evolve_sd: bool = False,
    sd_min=0.0,
):
    """Colored form of :func:`update_inflation_rows`: one vectorized
    full-field update per color (same-colored supports are disjoint, so
    their sequential updates commute exactly).  Equals the sequential
    scan over the color-reordered batch up to fp contraction."""

    def row_attrs(attrs, use, rob):
        # one-hot gather as a matmul: [rows, n_max] @ [n_max, 7] (a plain
        # gather may be faster on a GPU; not measured yet).
        n_max = attrs.shape[0]
        onehot = (rob[:, None] == jnp.arange(n_max, dtype=jnp.int32)[None, :])
        cols = jnp.concatenate(
            [attrs, use[:, None].astype(attrs.dtype)], axis=1
        )  # [n_max, 7]
        g = jnp.dot(onehot.astype(attrs.dtype), cols,
                    preferred_element_type=attrs.dtype)  # [rows, 7]
        covered = (rob >= 0) & (g[:, 6] > 0.5)
        return g, covered

    def step(carry, xs):
        rob, attrs, use = xs
        g, covered = row_attrs(attrs, use, rob)
        gamma = jnp.where(
            covered,
            gaspari_cohn(
                haversine((row_lats, row_lons), (g[:, 0], g[:, 1])),
                jnp.where(g[:, 2] > 0, g[:, 2], jnp.inf),
            ),
            0.0,
        )
        if evolve_sd:
            lam, sd = carry
            new = _anderson_update(lam, sd, gamma, g[:, 3], g[:, 4], g[:, 5],
                                   lambda_min=lambda_min,
                                   lambda_max=lambda_max)
            new_sd = _anderson_sd_update(new, lam, sd, gamma, g[:, 3],
                                         g[:, 4], g[:, 5], sd_min=sd_min)
            return (jnp.where(covered, new, lam),
                    jnp.where(covered, new_sd, sd)), None
        lam = carry
        new = _anderson_update(lam, lam_sd, gamma, g[:, 3], g[:, 4], g[:, 5],
                               lambda_min=lambda_min, lambda_max=lambda_max)
        return jnp.where(covered, new, lam), None

    if evolve_sd:
        sd0 = jnp.broadcast_to(
            jnp.asarray(lam_sd, dtype=lam.dtype), lam.shape
        ).astype(lam.dtype)
        (lam, sd), _ = jax.lax.scan(step, (lam, sd0),
                                    xs=(row_ob, ob_attrs, ob_use))
        return lam, sd
    lam, _ = jax.lax.scan(step, lam, xs=(row_ob, ob_attrs, ob_use))
    return lam


def pack_color_tables(order, color_sizes, obs_lats, obs_lons, radii,
                      innovations, prior_vars, ob_err_vars, assim,
                      dtype=np.float64):
    """Pad per-color ob attribute tables for
    :func:`update_inflation_rows_colored`: ``(ob_attrs [C, n_max, 6],
    ob_use [C, n_max])``."""
    order = np.asarray(order)
    sizes = np.asarray(color_sizes)
    n_max = int(sizes.max())
    C = sizes.shape[0]
    attrs = np.zeros((C, n_max, 6), dtype)
    use = np.zeros((C, n_max), bool)
    cols = np.stack([
        np.asarray(obs_lats, dtype), np.asarray(obs_lons, dtype),
        np.asarray(radii, dtype),
        np.asarray(innovations, dtype) ** 2,
        np.asarray(prior_vars, dtype), np.asarray(ob_err_vars, dtype),
    ], axis=1)[order]
    am = np.asarray(assim, bool)[order]
    off = 0
    for c in range(C):
        n = int(sizes[c])
        attrs[c, :n] = cols[off : off + n]
        use[c, :n] = am[off : off + n]
        off += n
    return attrs, use


class AdaptiveInflation:
    """Adaptive inflation state: per-variable (mean, std) fields of shape
    ``[ntimes, ny, nx]`` on the prior's grid."""

    def __init__(self, priorstate: EnsembleState, priorinf):
        """``priorinf`` is ``(inftype, infile, initvals)`` exactly as in the
        reference (``adaptive_inflation.py:16-28``): try to load ``infile``,
        else build fresh fields from the ``(mean, std)`` tuple ``initvals``."""
        assert isinstance(priorstate, EnsembleState)
        inftype, infile, initvals = priorinf
        self.structure = priorstate.structure
        try:
            self._load(infile)
        except Exception:
            self.build_initial_inflation(priorstate, initvals)

    # -- construction / I/O ---------------------------------------------------
    def build_initial_inflation(self, priorstate: EnsembleState, initvals) -> None:
        """Uniform initial fields (reference ``adaptive_inflation.py:32-56``)."""
        s = priorstate.structure
        mean0, std0 = initvals
        self.mean = {
            v: np.full((s.ntimes, s.ny, s.nx), float(mean0), dtype=np.float64)
            for v in s.var_names
        }
        self.std = {
            v: np.full((s.ntimes, s.ny, s.nx), float(std0), dtype=np.float64)
            for v in s.var_names
        }

    def _load(self, infile: str) -> None:
        ds = ncio.read_dataset(infile)
        s = self.structure
        self.mean, self.std = {}, {}
        for v in s.var_names:
            arr = np.asarray(ds[v], dtype=np.float64)
            self.mean[v] = arr[..., 0]
            self.std[v] = arr[..., 1]

    def save_to_disk(self, filename: str = "prior_inflation.nc") -> None:
        """Checkpoint (reference ``adaptive_inflation.py:76-80``)."""
        s = self.structure
        valids = s.times64()
        lead = timeutil.lead_hours(s.times_s, s.times_s[0])
        variables = {
            "validtime": (("validtime",), lead),
            "lat": (("y", "x"), np.asarray(s.lat)),
            "lon": (("y", "x"), np.asarray(s.lon)),
        }
        for v in s.var_names:
            variables[v] = (
                ("validtime", "y", "x", "moment"),
                np.stack([self.mean[v], self.std[v]], axis=-1),
            )
        ds = ncio.NcDataset(
            dims={"validtime": s.ntimes, "y": s.ny, "x": s.nx, "moment": 2},
            variables=variables,
        )
        ncio.write_dataset(filename, ds)

    # -- application ------------------------------------------------------------
    def mean_field(self) -> np.ndarray:
        """Stacked inflation means, shape ``[nvars, ntimes, ny, nx]``."""
        return np.stack([self.mean[v] for v in self.structure.var_names], axis=0)

    def inflate_state(self, priorstate: EnsembleState) -> EnsembleState:
        """Multiply perturbations by ``sqrt`` of the inflation mean field.

        The Anderson (2009) machinery this class implements defines λ as a
        covariance (VARIANCE) multiplier — ``update_inflation`` learns it
        through ``θ² = λ̃ s² + r²`` — so the consistent application to
        perturbations is ``sqrt(λ)`` (the convention the cycling harness
        uses, ``models/cycling.py``).  The reference's stub multiplies
        perturbations by the field directly
        (``adaptive_inflation.py:59-74``), but it never LEARNS the field,
        so its multiplier semantic is unobservable there; applying a
        learned variance-λ to the std doubles the inflation in log space
        every cycle — a positive feedback that measurably diverges a
        cycled run (benchmarks/cycled_production.py went NaN by cycle 2
        before this fix)."""
        factor = jnp.sqrt(
            jnp.asarray(self.mean_field(), dtype=priorstate.data.dtype)
        )
        mean = priorstate.ensemble_mean()[..., None]
        perts = priorstate.data - mean
        return priorstate.replace_data(factor[..., None] * perts + mean)

    # -- the adaptive (posterior) update the reference lacks ------------------
    def update_inflation(
        self,
        obs_lats,
        obs_lons,
        obs_radii,
        innovations,
        prior_vars,
        ob_err_vars,
        assimilated=None,
        lambda_min: float = 1.0,
        lambda_max: float = 1e6,
        lambda_sd_floor: float = 1e-4,
        evolve_sd: bool = False,
        sd_min: float = 0.05,
        damp: float = 1.0,
    ) -> None:
        """Anderson (2009) Bayesian update of the inflation mean fields from
        a batch of observation innovations.

        All arguments are 1-D arrays over the observation batch: the
        innovation ``y - H x̄`` (``innovations``), the prior obs-space
        ensemble variance (``prior_vars``, e.g. the filter's ``prior_var``
        diagnostics), and the error variances.  ``obs_radii`` give the GC
        localization halfwidth used to spread each update spatially
        (``inf`` -> uniform weight 1).

        ``evolve_sd=True`` also evolves the per-element std fields
        (Anderson 2009 §4 refit, floored at ``sd_min``) and writes them
        back to ``self.std`` — the reference stores the (mean, std) moment
        pair but never updates either
        (``efa_xray/assimilation/adaptive_inflation.py:42-56``).

        ``damp < 1`` relaxes the updated mean toward 1 (DART inflation
        damping, ``lambda <- 1 + damp * (lambda - 1)``) so residual
        observation bias / model error cannot ratchet the field upward
        without bound across cycles (see FilterConfig.adaptive_damp).
        """
        s = self.structure
        glat = jnp.asarray(s.lat.ravel())
        glon = jnp.asarray(s.lon.ravel())
        mask = (
            np.ones(len(np.asarray(obs_lats)), dtype=bool)
            if assimilated is None
            else np.asarray(assimilated, dtype=bool)
        )

        # All variables at once: lam [V, T, G], per-variable std [V, 1, 1];
        # the per-ob gamma [G] broadcasts across the leading axes inside
        # update_inflation_rows (one scan total instead of one per variable).
        nvars = len(s.var_names)
        lam = jnp.asarray(
            self.mean_field().reshape(nvars, s.ntimes, s.ny * s.nx)
        )
        if evolve_sd:
            # Full per-element std fields ride along and get refit per ob.
            lam_sd = jnp.asarray(
                np.maximum(
                    np.stack(
                        [self.std[v] for v in s.var_names], axis=0
                    ).reshape(nvars, s.ntimes, s.ny * s.nx),
                    lambda_sd_floor,
                )
            ).astype(lam.dtype)
        else:
            lam_sd = jnp.asarray(
                [max(float(np.mean(self.std[v])), lambda_sd_floor)
                 for v in s.var_names]
            ).reshape(nvars, 1, 1).astype(lam.dtype)

        common = (
            jnp.asarray(obs_lats, dtype=lam.dtype),
            jnp.asarray(obs_lons, dtype=lam.dtype),
            jnp.asarray(obs_radii, dtype=lam.dtype),
            jnp.asarray(innovations, dtype=lam.dtype),
            jnp.asarray(prior_vars, dtype=lam.dtype),
            jnp.asarray(ob_err_vars, dtype=lam.dtype),
            jnp.asarray(mask),
        )
        kw = dict(lambda_min=lambda_min, lambda_max=lambda_max,
                  evolve_sd=evolve_sd, sd_min=sd_min)
        # Colored batched form when every radius is finite and the
        # support-overlap graph colors sparsely (measured: the full-field
        # per-ob scan was 86% of the config-13 analysis cost).
        coloring = build_obs_coloring(
            s.lat.ravel(), s.lon.ravel(), obs_lats, obs_lons, obs_radii
        )
        if coloring is not None:
            order, sizes, row_ob = coloring
            attrs, use = pack_color_tables(
                order, sizes, obs_lats, obs_lons, obs_radii,
                innovations, prior_vars, ob_err_vars, mask,
            )
            out = update_inflation_rows_colored(
                lam, lam_sd,
                glat.astype(lam.dtype), glon.astype(lam.dtype),
                row_ob,  # device-cached with the coloring
                jnp.asarray(attrs, dtype=lam.dtype),
                jnp.asarray(use),
                **kw,
            )
        else:
            out = update_inflation_rows(
                lam, lam_sd,
                glat.astype(lam.dtype), glon.astype(lam.dtype),
                *common, **kw,
            )
        lam, sd = out if evolve_sd else (out, None)
        if damp < 1.0:
            lam = jnp.maximum(1.0 + damp * (lam - 1.0), lambda_min)
        mean_out = np.asarray(lam).reshape(nvars, s.ntimes, s.ny, s.nx)
        for i, v in enumerate(s.var_names):
            self.mean[v] = mean_out[i]
        if sd is not None:
            sd_out = np.asarray(sd).reshape(nvars, s.ntimes, s.ny, s.nx)
            for i, v in enumerate(s.var_names):
                self.std[v] = sd_out[i]


@jax.jit
def row_spread(perts):
    """Per-row ensemble spread (ddof=1): ``[rows]`` from ``[rows, M]``."""
    return jnp.sqrt(jnp.sum(perts**2, axis=1) / (perts.shape[1] - 1))


@jax.jit
def rtps(prior_spread, post_perts, alpha):
    """Relaxation-to-prior-spread posterior inflation (Whitaker & Hamill
    2012, MWR 140:3078) — an extension beyond the reference, which has no
    posterior inflation at all (its AdaptiveInflation stops at the prior
    multiply, ``efa_xray/assimilation/adaptive_inflation.py:59-74``).

    ``prior_spread`` is the per-row background spread (``row_spread`` of
    the prior perturbations — computed BEFORE the update so it survives
    buffer donation).  Per state row the posterior perturbations scale so
    the analysis spread relaxes toward the background spread,

        sigma_a' = (1 - alpha) * sigma_a + alpha * sigma_b
        X_a'     = X_a * sigma_a' / sigma_a

    ``alpha = 0`` is a no-op, ``alpha = 1`` restores the prior spread
    exactly.  Rows whose posterior spread is zero (e.g. collapsed or
    padded rows) are left untouched.  Works on sharded arrays unchanged
    (purely row-local).
    """
    sb = prior_spread
    sa = row_spread(post_perts)
    safe = sa > 0
    factor = jnp.where(
        safe, 1.0 + alpha * (sb - sa) / jnp.where(safe, sa, 1.0), 1.0
    )
    return post_perts * factor[:, None].astype(post_perts.dtype)


@jax.jit
def rtpp(prior_perts, post_perts, alpha):
    """Relaxation-to-prior-perturbations posterior inflation (Zhang,
    Snyder & Sun 2004, MWR 132:1238) — the member-wise sibling of
    :func:`rtps`, and like it an extension beyond the reference (whose
    AdaptiveInflation stops at the prior multiply,
    ``efa_xray/assimilation/adaptive_inflation.py:59-74``).

    Each posterior perturbation is blended member-wise with its prior
    counterpart,

        X_a' = (1 - alpha) * X_a + alpha * X_b

    ``alpha = 0`` is a no-op, ``alpha = 1`` restores the prior
    perturbations (and hence spread *and* correlation structure) exactly.
    Unlike RTPS this needs the full prior perturbation matrix to survive
    the update — callers on buffer-donating paths must pass a copy.
    Purely row- and member-local, so it works on sharded arrays unchanged.
    """
    return (
        (1.0 - alpha) * post_perts
        + alpha * prior_perts.astype(post_perts.dtype)
    )
