"""Forward operators H as precomputed gather taps.

The reference evaluates H one observation at a time in Python:
``Observation.estimate`` -> ``EnsembleState.interpolate``
(``efa_xray/observation/observation.py:40-50``,
``efa_xray/state/ensemble.py:170-239``): 4 nearest grid points with
inverse-distance weights (exact-match short-circuit within 1 km), linear
time interpolation, then a weighted gather-sum over members.

H is linear, so on the device it is a sparse matrix: per observation a fixed
set of K = 4 (space) x 2 (time) *taps* — flattened state-row indices plus
scalar weights.  ``build_taps`` constructs them for a whole observation
batch at once (distance search runs on device, chunked over observations);
``apply_taps`` evaluates ``ye = W @ gather(X)`` for all obs in one shot.

Deliberate fixes vs. the reference (see SURVEY.md §2.1):

* nearest-point ranking uses true great-circle distance, not the
  sin(lat)/cos(lon) hypot proxy (``ensemble.py:160-163``) — the proxy is
  not a metric and can select the wrong points; a ``metric="reference_proxy"``
  mode reproduces the old ranking for comparison studies;
* the exact-match branch one-hots the nearest point instead of crashing on
  the reference's 2-D index into a 1-D array (``ensemble.py:196``);
* linear time weights are proportional to proximity.  The reference assigns
  the *reversed* weights (``ensemble.py:218-224`` gives the lower bracket
  time the weight of the upper).  ``time_weighting="reference"`` reproduces
  that behavior for bit-parity studies; the default is correct linear
  interpolation;
* an out-of-time-range observation becomes a QC flag (``qc_ok=False``,
  zero weights) instead of a printed ``None`` (``ensemble.py:205-208``),
  so batches stay dense and jittable.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from efa_xray_tpu.observation import localization as _loc
from efa_xray_tpu.state.structure import StateStructure

EXACT_MATCH_KM = 1.0  # reference: efa_xray/state/ensemble.py:195


@dataclasses.dataclass
class ObsTaps:
    """Sparse linear forward operator for a batch of observations.

    ``ye[i] = sum_k weights[i, k] * state_vect[rows[i, k]]`` (per member).
    """

    rows: jnp.ndarray  # int32 [nobs, K] flattened state-row indices
    weights: jnp.ndarray  # float [nobs, K]
    qc_ok: np.ndarray  # bool [nobs] host array; False -> zero weights

    @property
    def nobs(self) -> int:
        return self.rows.shape[0]


def _topk_scores(grid_lat, grid_lon, lats, lons, metric: str):
    if metric == "haversine":
        score = -_loc.haversine(
            (grid_lat[None, :], grid_lon[None, :]), (lats[:, None], lons[:, None])
        )
    elif metric == "reference_proxy":
        # The reference's periodic-safe proxy (efa_xray/state/ensemble.py:160-163)
        score = -jnp.hypot(
            jnp.sin(jnp.radians(grid_lat[None, :])) - jnp.sin(jnp.radians(lats[:, None])),
            jnp.cos(jnp.radians(grid_lon[None, :])) - jnp.cos(jnp.radians(lons[:, None])),
        )
    else:
        raise ValueError(f"unknown metric {metric!r}")
    return score


@functools.partial(jax.jit, static_argnames=("npt", "metric"))
def _topk_points(grid_lat, grid_lon, lats, lons, npt: int, metric: str):
    """For each (lat, lon) in the batch return the ``npt`` nearest flat grid
    indices."""
    score = _topk_scores(grid_lat, grid_lon, lats, lons, metric)
    _, idx = jax.lax.top_k(score, npt)
    # Selected-point distances are recomputed in float64 on host by the
    # callers that need them; returning them here would be a dead transfer.
    return idx


@functools.partial(
    jax.jit, static_argnames=("npt", "metric", "chunk", "topk_method")
)
def _topk_points_mapped(grid_lat, grid_lon, lats, lons, npt: int,
                        metric: str, chunk: int,
                        topk_method: str = "exact"):
    """Chunked nearest-point search as ONE device dispatch.

    ``lats``/``lons`` must be padded to a multiple of ``chunk``; a
    ``lax.map`` over chunk rows bounds the live ``[chunk, ngrid]`` score
    matrix exactly like the host-side chunk loop, but the whole batch
    costs one argument upload + one dispatch instead of one per chunk.

    For the default ``haversine`` metric the scoring is two-stage:
    chordal dot products (one ``[chunk, 3] x [3, ngrid]`` matmul —
    chord length is exactly monotone in great-circle distance, so the
    ranking is identical) over-select ``~4*npt`` candidates, and the
    exact haversine rescored on just those picks the final ``npt``.
    This replaces the ~10-transcendental-op-per-pair haversine over the
    full ``[chunk, ngrid]`` slab with a matmul; the over-selection
    absorbs f32 dot resolution (cos flattens near zero distance —
    ~2 km of tie range on Earth radius, far inside the candidate set at
    any realistic grid spacing).  The candidate rescore — and the final
    IDW weights, recomputed in f64 on host by ``build_taps`` — use true
    great-circle distances, so results match the single-stage search.

    ``topk_method="approx"`` swaps the full-width candidate ``top_k``
    (which dominates the search cost — the scoring matmul is cheap) for
    ``lax.approx_max_k`` at recall 0.99.  The ``~4*npt``-fold candidate
    over-selection plus exact rescore means a true ``npt``-nearest point
    is lost only if the approximate reduction drops it from the top-28
    entirely — misses concentrate at the candidate-set BOUNDARY, not at
    the maxima the final answer needs — but the result is no longer
    formally guaranteed identical, hence opt-in
    (``FilterConfig.taps_topk``).
    """
    ngrid = grid_lat.shape[0]

    if metric == "haversine" and ngrid > 4 * npt + 12:
        gxyz = _loc.latlon_to_unit(grid_lat, grid_lon)  # [ngrid, 3]
        m = 4 * npt + 12

        def one(ll):
            la, lo = ll
            oxyz = _loc.latlon_to_unit(la, lo)  # [chunk, 3]
            # HIGHEST is load-bearing: a default-precision f32 matmul may
            # round its inputs (TF32 on a GPU: ~sqrt(2*2^-11) rad ~ 200 km
            # of distance resolution for chord dots near 1.0; bf16 is
            # worse) — the top-m candidate set
            # then MISSES true nearest points outright (measured as O(sigma)
            # ye errors by benchmarks/taps_search_ab.py).  Multi-pass f32 on
            # this K=3 contraction is noise next to the top_k that follows;
            # with it the tie range is the documented ~2-4 km, far inside
            # the m-fold over-selection.
            dots = jnp.einsum(
                "oc,gc->og", oxyz, gxyz,
                preferred_element_type=oxyz.dtype,
                precision=jax.lax.Precision.HIGHEST,
            )
            if topk_method == "approx":
                _, cand = jax.lax.approx_max_k(dots, m, recall_target=0.99)
            else:
                _, cand = jax.lax.top_k(dots, m)  # [chunk, m]
            d = _loc.haversine(
                (grid_lat[cand], grid_lon[cand]),
                (la[:, None], lo[:, None]),
            )
            _, sub = jax.lax.top_k(-d, npt)
            return jnp.take_along_axis(cand, sub, axis=1)

    else:

        def one(ll):
            la, lo = ll
            score = _topk_scores(grid_lat, grid_lon, la, lo, metric)
            _, idx = jax.lax.top_k(score, npt)
            return idx

    idx = jax.lax.map(one, (lats.reshape(-1, chunk), lons.reshape(-1, chunk)))
    return idx.reshape(lats.shape[0], npt)


def _haversine_np(lat1, lon1, lat2, lon2) -> np.ndarray:
    """Host (NumPy, float64) great-circle distance in km; broadcasts."""
    la1 = np.radians(np.asarray(lat1, dtype=np.float64))
    la2 = np.radians(np.asarray(lat2, dtype=np.float64))
    dlat = la2 - la1
    dlon = np.radians(
        np.asarray(lon2, dtype=np.float64) - np.asarray(lon1, dtype=np.float64)
    )
    a = np.sin(dlat / 2.0) ** 2 + np.cos(la1) * np.cos(la2) * np.sin(dlon / 2.0) ** 2
    return _loc.EARTH_RADIUS_KM * 2.0 * np.arctan2(np.sqrt(a), np.sqrt(1.0 - a))


def separable_grid_axes(lat2d, lon2d):
    """``(lat1d, lon1d)`` if the raster is a separable lat x lon product
    grid with monotone axes, else ``None``.

    Separable means ``lat[y, x] == lat1d[y]`` and ``lon[y, x] == lon1d[x]``
    for all (y, x) — the ordinary regular/rectilinear case (uniform spacing
    NOT required; a Gaussian-latitude grid qualifies).  1-D location-list
    states (``nx == 1`` with arbitrary points) fail the lon-constancy test
    unless they genuinely lie on one meridian.
    """
    lat2d = np.asarray(lat2d, dtype=np.float64)
    lon2d = np.asarray(lon2d, dtype=np.float64)
    if lat2d.ndim != 2:
        return None
    lat1 = lat2d[:, 0]
    lon1 = lon2d[0, :]
    if not (
        np.array_equal(lat2d, np.broadcast_to(lat1[:, None], lat2d.shape))
        and np.array_equal(lon2d, np.broadcast_to(lon1[None, :], lon2d.shape))
    ):
        return None
    dla, dlo = np.diff(lat1), np.diff(lon1)
    if not ((dla > 0).all() or (dla < 0).all()):
        return None
    if not ((dlo > 0).all() or (dlo < 0).all()):
        return None
    return lat1, lon1


def _nearest_separable(
    lat1, lon1, lats, lons, npt: int, ncand_rows: int = 4, ncand_cols: int = 8
):
    """Exact nearest-``npt`` search on a separable grid, entirely on host.

    Replaces the device full-grid ``top_k`` (the dominant cost of a cold
    ``build_taps``) with
    O(log ny + log nx + ncand) index arithmetic per ob: both axes are
    monotone, so the nearest rows/columns live in a small contiguous
    (circularly contiguous, for wrapped longitude) index window around the
    ``searchsorted`` insertion point — nearest-k sets in a sorted array
    are contiguous and contain the insertion point, so a window of twice
    the needed size always covers them.  The candidate set is the
    ``ncand_rows`` nearest latitude rows x the ``ncand_cols`` nearest
    longitude columns, and a per-ob CERTIFICATE proves no excluded grid
    point can beat the selected ``npt``:

    * any point in an excluded row is at least ``R * |dphi|`` away (a
      great circle between latitudes phi1, phi2 spans at least their
      latitude separation);
    * within a kept row, great-circle distance is monotone in the wrapped
      longitude gap ``|dlambda| <= 180`` (d/dDl cos(gc) = -cos(phi_ob) *
      cos(phi_row) * sin(Dl) <= 0), so every excluded column in that row
      is at least as far as the row's farthest CANDIDATE.

    Returns ``(flat_idx [nobs, npt] int64, certified [nobs] bool)``;
    uncertified rows (possible only for obs very near a pole on coarse
    grids) must be re-searched exactly by the caller.
    """
    lat1 = np.asarray(lat1, dtype=np.float64)
    lon1 = np.asarray(lon1, dtype=np.float64)
    lats = np.asarray(lats, dtype=np.float64)
    lons = np.asarray(lons, dtype=np.float64)
    ny, nx = lat1.shape[0], lon1.shape[0]
    nobs = lats.shape[0]
    nr = min(ncand_rows, ny)
    nc = min(max(ncand_cols, npt), nx)
    if nr * nc < npt:
        nr = min(ny, int(np.ceil(npt / nc)))
        if nr * nc < npt:
            raise ValueError("candidate window smaller than npt")

    asc_lat = ny == 1 or lat1[-1] >= lat1[0]
    la = lat1 if asc_lat else lat1[::-1]
    if nr < ny:
        # window of 2(nr+1) contiguous rows around the insertion point is
        # guaranteed to contain the nr+1 nearest rows (see docstring)
        wr = min(ny, 2 * (nr + 1))
        jr = np.searchsorted(la, lats)
        start = np.clip(jr - (nr + 1), 0, ny - wr)
        rwin = start[:, None] + np.arange(wr)[None, :]  # [nobs, wr] distinct
        dphi_w = np.abs(lats[:, None] - la[rwin])
        part = np.argpartition(dphi_w, nr - 1, axis=1)[:, :nr]
        rows_sel = np.take_along_axis(rwin, part, axis=1)  # [nobs, nr]
        # the (nr+1)-th smallest in-window gap IS the global smallest
        # excluded-row gap -> lower bound on any excluded-row point's
        # distance
        excl_gap = np.partition(dphi_w, nr, axis=1)[:, nr]
        row_lb = _loc.EARTH_RADIUS_KM * np.radians(excl_gap)
        if not asc_lat:
            rows_sel = ny - 1 - rows_sel
    else:
        rows_sel = np.broadcast_to(np.arange(ny), (nobs, ny)).copy()
        row_lb = np.full(nobs, np.inf)

    asc_lon = nx == 1 or lon1[-1] >= lon1[0]
    lo = lon1 if asc_lon else lon1[::-1]
    if nc < nx:
        # nearest-by-wrapped-gap columns are CIRCULARLY contiguous around
        # the circular insertion point; a 2*nc circular window covers them
        wc = min(nx, 2 * nc)
        lonw = lo[0] + ((lons - lo[0]) % 360.0)
        jc = np.searchsorted(lo, lonw)
        cwin = (jc[:, None] + np.arange(wc)[None, :] - nc) % nx  # distinct
        dlam_w = np.abs(((lons[:, None] - lo[cwin] + 180.0) % 360.0) - 180.0)
        part = np.argpartition(dlam_w, nc - 1, axis=1)[:, :nc]
        cols_sel = np.take_along_axis(cwin, part, axis=1)  # [nobs, nc]
        if not asc_lon:
            cols_sel = nx - 1 - cols_sel
        col_window_full = False
    else:
        cols_sel = np.broadcast_to(np.arange(nx), (nobs, nx)).copy()
        col_window_full = True

    cand_lat = lat1[rows_sel][:, :, None]  # [nobs, nr, 1]
    cand_lon = lon1[cols_sel][:, None, :]  # [nobs, 1, nc]
    d = _haversine_np(lats[:, None, None], lons[:, None, None], cand_lat, cand_lon)
    flat = (rows_sel[:, :, None] * nx + cols_sel[:, None, :]).reshape(nobs, -1)
    d2 = d.reshape(nobs, -1)

    # Ascending distance with ties broken by LOWEST flat grid index — a
    # deterministic rule shared with _host_full_search and matching the
    # single-stage device top_k (lax.top_k prefers the lowest index among
    # equal scores), so obs exactly equidistant between grid points select
    # the same points on every host path.  (The two-stage chordal device
    # search breaks exact ties by fp rounding instead — see the
    # FilterConfig.taps_search note.)  The candidate set is tiny
    # (nr*nc <= ~32), so a full lexsort is cheap.
    order = np.lexsort((flat, d2), axis=1)[:, :npt]
    pick = order
    d_star = np.take_along_axis(d2, order[:, -1:], axis=1)[:, 0]

    # Certificate (conservative margin absorbs f64 rounding differences
    # between the analytic bound and the haversine evaluation).
    margin = 1.0 + 1e-9
    certified = row_lb >= d_star * margin
    if not col_window_full:
        # farthest candidate per kept row bounds that row's excluded columns
        certified &= (d.max(axis=2) >= d_star[:, None] * margin).all(axis=1)
    return np.take_along_axis(flat, pick, axis=1).astype(np.int64), certified


def _host_full_search(row_lat, row_lon, lats, lons, npt: int,
                      chunk_bytes: int = 1 << 28) -> np.ndarray:
    """Exact host-side full-grid nearest-``npt`` for a (small) set of obs.

    Used for separable-fast-path certificate failures: a fresh device
    search for a handful of obs would pay a new-shape compile; the NumPy
    slab here is cheap at the few obs this ever sees."""
    row_lat = np.asarray(row_lat, dtype=np.float64).ravel()
    row_lon = np.asarray(row_lon, dtype=np.float64).ravel()
    lats = np.asarray(lats, dtype=np.float64)
    lons = np.asarray(lons, dtype=np.float64)
    ngrid = row_lat.shape[0]
    per = max(1, chunk_bytes // (ngrid * 8))
    out = np.empty((lats.shape[0], npt), dtype=np.int64)
    for s in range(0, lats.shape[0], per):
        d = _haversine_np(
            lats[s:s + per, None], lons[s:s + per, None],
            row_lat[None, :], row_lon[None, :],
        )
        # Stable argsort over the flat axis = ascending distance with ties
        # at the lowest flat index, matching the device top_k tie rule.
        out[s:s + per] = np.argsort(d, axis=1, kind="stable")[:, :npt]
    return out


def nearest_points(grid_lat, grid_lon, lat, lon, npt: int = 1,
                   metric: str = "haversine") -> Tuple[np.ndarray, np.ndarray]:
    """Indices of the ``npt`` nearest grid points to one (lat, lon), as
    ``(y_idx, x_idx)`` arrays (reference: ``efa_xray/state/ensemble.py:152-168``)."""
    grid_lat = np.asarray(grid_lat, dtype=np.float64)
    shape = grid_lat.shape
    npt = min(npt, grid_lat.size)
    flat_idx = _topk_points(
        jnp.asarray(grid_lat.ravel()),
        jnp.asarray(np.asarray(grid_lon, dtype=np.float64).ravel()),
        jnp.asarray([lat], dtype=jnp.float32 if not jax.config.jax_enable_x64 else jnp.float64),
        jnp.asarray([lon], dtype=jnp.float32 if not jax.config.jax_enable_x64 else jnp.float64),
        npt,
        metric,
    )
    flat = np.asarray(flat_idx[0])
    if len(shape) == 1:
        # 1-D location list: (loc_idx, zeros) so callers can treat it as (y, x)
        return flat, np.zeros(npt, dtype=np.int64)
    return np.unravel_index(flat, shape)


def _space_weights(dist: np.ndarray, exact_match_km: float) -> np.ndarray:
    """Per-ob spatial weights over the selected points: one-hot within the
    exact-match tolerance, inverse-distance otherwise
    (reference: ``efa_xray/state/ensemble.py:193-200``)."""
    nobs, npt = dist.shape
    w = np.empty_like(dist)
    exact = (dist < exact_match_km).any(axis=1)
    with np.errstate(divide="ignore"):
        inv = 1.0 / dist
    inv[~np.isfinite(inv)] = 0.0
    denom = inv.sum(axis=1, keepdims=True)
    # Degenerate all-zero denominators can't happen unless all 4 distances are
    # inf; guard anyway.
    w = inv / np.where(denom > 0, denom, 1.0)
    onehot = np.zeros_like(dist)
    onehot[np.arange(nobs), dist.argmin(axis=1)] = 1.0
    w[exact] = onehot[exact]
    return w


def _time_weights(
    times_s: np.ndarray, ob_times_s: np.ndarray, mode: str
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Bracketing time indices [nobs, 2], weights [nobs, 2], in-range mask.

    Reference semantics: ``efa_xray/state/ensemble.py:201-224``.
    """
    times_s = np.asarray(times_s, dtype=np.int64)
    t = np.asarray(ob_times_s, dtype=np.int64)
    nobs = t.shape[0]
    ok = (t >= times_s[0]) & (t <= times_s[-1])
    tc = np.clip(t, times_s[0], times_s[-1])
    # first index with times >= t  (reference's (valids >= time64).argmax())
    hi = np.searchsorted(times_s, tc, side="left")
    exact = times_s[np.minimum(hi, len(times_s) - 1)] == tc
    lo = np.where(exact, hi, np.maximum(hi - 1, 0))
    idx = np.stack([lo, hi], axis=1).astype(np.int64)
    w = np.zeros((nobs, 2), dtype=np.float64)
    tot = (times_s[hi] - times_s[lo]).astype(np.float64)
    tot = np.where(tot > 0, tot, 1.0)
    frac_hi = (tc - times_s[lo]).astype(np.float64) / tot  # proximity-correct
    if mode == "linear":
        w[:, 1] = frac_hi
        w[:, 0] = 1.0 - frac_hi
    elif mode == "reference":
        # reference swaps the bracket weights (ensemble.py:223-224)
        w[:, 1] = 1.0 - frac_hi
        w[:, 0] = frac_hi
    else:
        raise ValueError(f"unknown time_weighting {mode!r}")
    w[exact, 0] = 0.0
    w[exact, 1] = 1.0
    w[~ok] = 0.0
    return idx, w, ok


def build_taps(
    structure: StateStructure,
    lats,
    lons,
    times_s,
    var_idx,
    npt: int = 4,
    exact_match_km: float = EXACT_MATCH_KM,
    metric: str = "haversine",
    time_weighting: str = "linear",
    obs_chunk_bytes: int = 1 << 28,
    topk_method: str = "exact",
    search: str = "auto",
) -> ObsTaps:
    """Construct gather taps for a batch of point observations.

    ``lats``/``lons``: float [nobs]; ``times_s``: int64 epoch seconds
    [nobs]; ``var_idx``: int [nobs] index into ``structure.var_names``.

    ``search="auto"`` (default) detects separable lat x lon product grids
    and runs the nearest-point search as exact host-side index arithmetic
    (:func:`_nearest_separable` — no device dispatch, no full-grid
    ``top_k``); non-separable grids, the ``reference_proxy`` metric, and
    per-ob certificate failures fall back to the exact search
    (``search="device"`` forces the device path everywhere).
    """
    lats = np.asarray(lats, dtype=np.float64)
    lons = np.asarray(lons, dtype=np.float64)
    var_idx = np.asarray(var_idx, dtype=np.int64)
    nobs = lats.shape[0]
    ngrid = structure.ngrid
    # Tiny grids (e.g. a single-point EFA trajectory state) have fewer
    # points than the default 4-point stencil; use what exists.
    npt = min(npt, ngrid)

    fdtype = jnp.float64 if jax.config.jax_enable_x64 else jnp.float32

    # Device-side nearest-point search, chunked so the [chunk, ngrid]
    # distance matrix stays within a bounded footprint.  The whole batch
    # is padded to a chunk multiple and searched in ONE dispatch
    # (lax.map over chunk rows) with one upload and one tiny index pull,
    # instead of one dispatch and one pull per chunk.
    itemsize = jnp.dtype(fdtype).itemsize
    chunk = max(1, min(nobs, obs_chunk_bytes // max(ngrid * itemsize, 1)))
    if search not in ("auto", "device"):
        raise ValueError(f"unknown search {search!r}")
    axes = (
        separable_grid_axes(structure.lat, structure.lon)
        if (search == "auto" and metric == "haversine" and nobs > 0
            and npt <= ngrid)
        else None
    )
    if nobs == 0:  # empty observation batch
        sp_idx = np.empty((0, npt), dtype=np.int64)
    elif axes is not None:
        sp_idx, certified = _nearest_separable(axes[0], axes[1], lats, lons, npt)
        if not certified.all():
            bad = ~certified
            sp_idx[bad] = _host_full_search(
                structure.lat, structure.lon, lats[bad], lons[bad], npt,
                chunk_bytes=obs_chunk_bytes,
            )
    else:
        # The grid upload happens only on this branch: the host-side
        # separable path above must stay free of ANY device transfer (a
        # multi-MB grid upload is exactly the cold-build cost it was built
        # to eliminate).
        glat, glon = structure.grid_latlon_device(fdtype)
        npad = (-nobs) % chunk
        lat_p = np.concatenate([lats, np.full(npad, lats[0])])
        lon_p = np.concatenate([lons, np.full(npad, lons[0])])
        sp_idx = np.asarray(
            _topk_points_mapped(
                glat, glon,
                jnp.asarray(lat_p, dtype=fdtype),
                jnp.asarray(lon_p, dtype=fdtype),
                npt, metric, chunk, topk_method,
            )[:nobs],
            dtype=np.int64,
        )

    # Recompute the selected distances in f64 on host (pure NumPy — true
    # float64 regardless of jax_enable_x64, and no device dispatch) so the
    # IDW weights and the exact-match test are precision-independent of the
    # device dtype.
    sel_lat = structure.lat.ravel()[sp_idx]
    sel_lon = structure.lon.ravel()[sp_idx]
    sp_dist = _haversine_np(lats[:, None], lons[:, None], sel_lat, sel_lon)
    sw = _space_weights(sp_dist, exact_match_km)  # [nobs, npt]

    t_idx, tw, ok = _time_weights(structure.times_s, times_s, time_weighting)

    # Combine: rows[(i, p, q)] = flat(var, t_idx[i,q], grid=sp_idx[i,p])
    # weights = sw[i,p] * tw[i,q]
    ntimes = structure.ntimes
    rows = (
        (var_idx[:, None, None] * ntimes + t_idx[:, None, :]) * ngrid
        + sp_idx[:, :, None]
    ).reshape(nobs, npt * 2)
    weights = (sw[:, :, None] * tw[:, None, :]).reshape(nobs, npt * 2)
    weights[~ok] = 0.0

    return ObsTaps(
        rows=jnp.asarray(rows, dtype=jnp.int32),
        weights=jnp.asarray(weights, dtype=fdtype),
        qc_ok=np.asarray(ok),
    )


# ---------------------------------------------------------------------------
# Module-level taps cache: a cycling workload with a stationary observation
# network pays the forward-operator build (several times the analysis cost
# at config-5 scale) only once.
# Keyed on the state STRUCTURE (content-hashed, identity-independent) plus a
# digest of the obs coordinates/times and the build parameters; obs VALUES
# and errors never enter the taps, so re-observing the same network with new
# data each cycle is a hit.  Entries hold device buffers (rows + weights,
# ~64 B/ob), bounded by an LRU per structure; the per-structure tables drop
# automatically when the structure itself is garbage-collected.
# ---------------------------------------------------------------------------

import collections as _collections
import hashlib as _hashlib
import weakref as _weakref

_TAPS_CACHE: "_weakref.WeakKeyDictionary" = _weakref.WeakKeyDictionary()
TAPS_CACHE_MAX_PER_STRUCTURE = 8
# Diagnostic counter of ACTUAL tap constructions (cache misses); tests and
# benchmarks read it to prove cycle 2+ skips the rebuild.
taps_build_count = 0


def _obs_digest(lats, lons, times_s, var_idx, params: tuple) -> str:
    h = _hashlib.sha1()
    for a in (lats, lons, times_s, var_idx):
        arr = np.ascontiguousarray(np.asarray(a))
        h.update(arr.tobytes())
        h.update(str(arr.dtype).encode())
        h.update(str(arr.shape).encode())
    h.update(repr(params).encode())
    return h.hexdigest()


def build_taps_cached(
    structure: StateStructure,
    lats,
    lons,
    times_s,
    var_idx,
    npt: int = 4,
    exact_match_km: float = EXACT_MATCH_KM,
    metric: str = "haversine",
    time_weighting: str = "linear",
    topk_method: str = "exact",
    search: str = "auto",
) -> ObsTaps:
    """LRU-cached :func:`build_taps` for stationary observation networks.

    Same contract as :func:`build_taps`; reuses the device tap buffers when
    the same (structure, obs coordinates, parameters) recur — e.g. every
    cycle of a cycling DA run against a fixed surface network (amortizes
    the per-ob interpolate path the taps replace,
    ``efa_xray/state/ensemble.py:170-239``)."""
    global taps_build_count
    # x64 mode changes the weight dtype build_taps emits; key on it.
    params = (npt, float(exact_match_km), metric, time_weighting,
              topk_method, search, bool(jax.config.jax_enable_x64))
    key = _obs_digest(lats, lons, times_s, var_idx, params)
    per = _TAPS_CACHE.get(structure)
    if per is not None and key in per:
        per.move_to_end(key)
        return per[key]
    taps = build_taps(
        structure, lats, lons, times_s, var_idx,
        npt=npt, exact_match_km=exact_match_km, metric=metric,
        time_weighting=time_weighting, topk_method=topk_method,
        search=search,
    )
    taps_build_count += 1
    if per is None:
        per = _collections.OrderedDict()
        _TAPS_CACHE[structure] = per
    per[key] = taps
    while len(per) > TAPS_CACHE_MAX_PER_STRUCTURE:
        per.popitem(last=False)
    return taps


@jax.jit
def apply_taps(state_vect, rows, weights):
    """Evaluate all observation priors at once: ``[nobs, nmems]``.

    ``state_vect``: ``[nstate, nmems]``; one vectorized gather replaces the
    reference's per-ob Python loop (``efa_xray/assimilation/assimilation.py:45-48``).
    """
    gathered = jnp.take(state_vect, rows, axis=0)  # [nobs, K, nmems]
    return jnp.einsum("okm,ok->om", gathered, weights.astype(state_vect.dtype))


def apply_taps_obj(state_vect, taps: ObsTaps):
    return apply_taps(state_vect, taps.rows, taps.weights)
