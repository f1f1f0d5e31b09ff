"""Ensemble sensitivity analysis and observation-impact prediction.

Extensions beyond the reference (whose only verification artifact is the
per-ob stats table, ``efa_xray/postprocess/postprocess.py:8-39``): these
are the standard companion tools of the EFA workflow the reference was
built for (Madaus & Hakim 2015, QJRMS):

* :func:`ensemble_sensitivity` — Torn & Hakim (2008, MWR) regression
  sensitivity of a scalar forecast metric ``J`` to every state element,
  ``dJ/dx_i = cov(x_i, J) / var(x_i)``, with the correlation field and
  an optional statistical-significance mask.  On the device: the whole
  field is one ``[Ns, M] x [M]`` device matvec — no per-point loop.
* :func:`observation_impact` — Ancell & Hakim (2007, MWR)-style
  prediction of the change in ``J``'s mean and variance from
  assimilating each candidate observation (the observation-targeting
  question: which obs would most reduce forecast-metric uncertainty).
  For a single observation and a metric linear in the state this is
  EXACT for the serial EnSRF update (the square-root identity
  ``2*beta*kdenom - beta^2*varye = kdenom``); for a batch it is the
  standard independent-obs approximation.

Both run entirely from public-API objects (``EnsembleState``,
``ObservationBatch`` or ``Observation`` lists) and return NumPy/pandas
results for analysis and plotting.
"""

from __future__ import annotations

import math
from typing import TYPE_CHECKING, Callable, Dict, Optional, Union

import numpy as np

if TYPE_CHECKING:  # pandas is an optional install (DataFrame results)
    import pandas as pd

import jax.numpy as jnp

from efa_xray_tpu.observation import forward as _fwd
from efa_xray_tpu.observation.observation import ObservationBatch
from efa_xray_tpu.state.ensemble import EnsembleState

Metric = Union[np.ndarray, Callable[[EnsembleState], np.ndarray]]


def region_mean_metric(
    var: str,
    time_index: Optional[int] = None,
    lat_range: Optional[tuple] = None,
    lon_range: Optional[tuple] = None,
) -> Callable[[EnsembleState], np.ndarray]:
    """Convenience metric builder: per-member mean of ``var`` over an
    optional validtime index and lat/lon box — the usual "forecast
    metric J" of the EFA/ESA literature (e.g. area-averaged SLP at the
    verification time)."""

    def metric(state: EnsembleState) -> np.ndarray:
        s = state.structure
        vi = s.var_names.index(var)
        data = np.asarray(state.data[vi])  # [T, Y, X, M]
        if time_index is not None:
            ti = time_index % data.shape[0]  # support negative indices
            data = data[ti : ti + 1]
        mask = np.ones((s.ny, s.nx), dtype=bool)
        if lat_range is not None:
            mask &= (s.lat >= lat_range[0]) & (s.lat <= lat_range[1])
        if lon_range is not None:
            mask &= (s.lon >= lon_range[0]) & (s.lon <= lon_range[1])
        if not mask.any():
            raise ValueError("region selects no grid points")
        return data[:, mask, :].mean(axis=(0, 1))

    return metric


def metric_values(state: EnsembleState, metric: Metric) -> np.ndarray:
    """Resolve a metric spec to a per-member vector ``[M]``."""
    j = metric(state) if callable(metric) else np.asarray(metric)
    j = np.asarray(j, dtype=np.float64)
    if j.shape != (state.structure.nmems,):
        raise ValueError(
            f"metric must give one value per member "
            f"({state.structure.nmems}), got shape {j.shape}"
        )
    return j


def _sig_mask(corr: np.ndarray, nmems: int, confidence: float) -> np.ndarray:
    """Two-sided test of nonzero correlation at the given confidence via
    the exact t transform ``t = r sqrt((M-2)/(1-r^2))`` (scipy when
    available, normal approximation otherwise)."""
    r = np.clip(corr, -0.999999, 0.999999)
    t = np.abs(r) * np.sqrt((nmems - 2) / (1.0 - r * r))
    alpha = 1.0 - confidence
    try:
        from scipy.stats import t as tdist

        pcrit = tdist.ppf(1.0 - alpha / 2.0, df=nmems - 2)
    except Exception:  # pragma: no cover - scipy is in the image
        # normal-approx critical value
        from statistics import NormalDist

        pcrit = NormalDist().inv_cdf(1.0 - alpha / 2.0)
    return t > pcrit


def ensemble_sensitivity(
    state: EnsembleState,
    metric: Metric,
    unbiased: bool = True,
    confidence: Optional[float] = None,
) -> Dict[str, Dict[str, np.ndarray]]:
    """Torn & Hakim (2008) ensemble sensitivity of ``J`` to every state
    element.

    ``metric`` is a per-member ``[M]`` array or a callable
    ``state -> [M]`` (see :func:`region_mean_metric`).  Returns, keyed by
    variable name, dicts with ``[ntimes, ny, nx]`` fields:

    * ``sensitivity`` — the regression slope ``cov(x, J)/var(x)``
      (units of J per unit of x);
    * ``covariance`` — the raw ``cov(x, J)``;
    * ``correlation`` — ``corr(x, J)``;
    * ``significant`` — boolean mask (only when ``confidence`` given),
      two-sided t-test that the correlation differs from zero.

    The covariance sweep is one device matvec over the ``[Ns, M]`` state;
    ``unbiased`` selects the ddof=1 sample convention (the ESA-literature
    default).
    """
    s = state.structure
    nm = s.nmems
    j = metric_values(state, metric)
    jp = jnp.asarray(j - j.mean(), dtype=state.data.dtype)

    x = state.to_vect()  # [Ns, M]
    xm = jnp.mean(x, axis=1, keepdims=True)
    xp = x - xm
    ddof = 1 if unbiased else 0
    cov = xp @ jp / (nm - ddof)  # [Ns]
    varx = jnp.sum(xp * xp, axis=1) / (nm - ddof)
    varj = float(np.sum((j - j.mean()) ** 2) / (nm - ddof))

    cov = np.asarray(cov, dtype=np.float64)
    varx = np.asarray(varx, dtype=np.float64)
    sens = np.divide(cov, varx, out=np.zeros_like(cov), where=varx > 0)
    denom = np.sqrt(varx * varj)
    corr = np.divide(cov, denom, out=np.zeros_like(cov), where=denom > 0)

    sig = _sig_mask(corr, nm, confidence) if confidence is not None else None
    shape = (s.nvars, s.ntimes, s.ny, s.nx)
    out: Dict[str, Dict[str, np.ndarray]] = {}
    for vi, name in enumerate(s.var_names):
        fields = {
            "sensitivity": sens.reshape(shape)[vi],
            "covariance": cov.reshape(shape)[vi],
            "correlation": corr.reshape(shape)[vi],
        }
        if sig is not None:
            fields["significant"] = sig.reshape(shape)[vi]
        out[name] = fields
    return out


def observation_impact(
    state: EnsembleState,
    obs,
    metric: Metric,
    unbiased: bool = False,
    time_weighting: str = "linear",
) -> pd.DataFrame:
    """Predicted impact of each candidate observation on the scalar
    forecast metric ``J`` (Ancell & Hakim 2007): with obs-space prior
    ``ye`` and ``kdenom = var(ye) + R``,

    * ``dJ_mean_pred  =  cov(J, ye)/kdenom * (y - mean(ye))``
    * ``dJ_var_pred   = -cov(J, ye)^2 / kdenom``

    Ranking candidate obs by ``-dJ_var_pred`` is the classic
    observation-targeting recipe.  ``unbiased`` must match the filter's
    ``FilterConfig.unbiased_variance`` for the single-ob prediction to
    reproduce the serial EnSRF exactly (the covariance is always ddof=1,
    the reference's gain convention — ``efa_xray/assimilation/ensrf.py:
    88-95``).  QC-failing obs (outside the space/time domain) get NaN
    predictions and ``qc_ok = False``.
    """
    s = state.structure
    nm = s.nmems
    batch = ObservationBatch.coerce(obs)
    j = metric_values(state, metric)
    jp = jnp.asarray(j - j.mean(), dtype=state.data.dtype)

    taps = _fwd.build_taps_cached(
        s, batch.lats, batch.lons, batch.times_s, batch.var_indices(s),
        time_weighting=time_weighting,
    )
    ye = _fwd.apply_taps_obj(state.to_vect(), taps)  # [No, M]
    mye = jnp.mean(ye, axis=1, keepdims=True)
    yep = ye - mye
    ddof_den = 1 if unbiased else 0
    varye = jnp.sum(yep * yep, axis=1) / (nm - ddof_den)
    covj = yep @ jp / (nm - 1)

    mye = np.asarray(mye[:, 0], dtype=np.float64)
    varye = np.asarray(varye, dtype=np.float64)
    covj = np.asarray(covj, dtype=np.float64)
    qc = np.asarray(taps.qc_ok)

    kdenom = varye + np.asarray(batch.errors, dtype=np.float64)
    innov = np.asarray(batch.values, dtype=np.float64) - mye
    dj_mean = covj / kdenom * innov
    dj_var = -(covj * covj) / kdenom
    dj_mean[~qc] = np.nan
    dj_var[~qc] = np.nan

    import pandas as pd

    return pd.DataFrame(
        {
            "obtype": list(batch.obtypes),
            "lat": np.asarray(batch.lats, dtype=np.float64),
            "lon": np.asarray(batch.lons, dtype=np.float64),
            "value": np.asarray(batch.values, dtype=np.float64),
            "ob error": np.asarray(batch.errors, dtype=np.float64),
            "prior mean": np.where(qc, mye, np.nan),
            "prior variance": np.where(qc, varye, np.nan),
            "metric cov": np.where(qc, covj, np.nan),
            "dJ_mean_pred": dj_mean,
            "dJ_var_pred": dj_var,
            "qc_ok": qc,
        }
    )


def greedy_obs_selection(
    state: EnsembleState,
    obs,
    metric: Metric,
    nselect: int,
    unbiased: bool = False,
    time_weighting: str = "linear",
) -> pd.DataFrame:
    """Greedy sequential observation-network design: repeatedly pick the
    candidate whose assimilation most reduces the forecast-metric
    variance, ACCOUNTING for the obs already selected.

    This is the augmented-state insight of the reference
    (``efa_xray/assimilation/assimilation.py:146-150``) run entirely in
    observation space: after each pick the candidate ``ye`` matrix and
    the metric members get the exact serial square-root update
    (``Xap = Xbp - beta K (x) ye``, ``efa_xray/assimilation/ensrf.py:
    135-141``, restricted to the ``[No, M]`` tail), so later scores see
    the information already harvested — naive top-n re-counts shared
    information; greedy does not.  For unlocalized obs and a linear
    metric the cumulative predictions are EXACT: assimilating the
    selected set serially with the EnSRF realizes them (tested).

    Obs-space only (``[No, M]`` host float64 — a planning tool, not a
    hot path).  Returns one row per pick, in pick order: the candidate
    index, per-step and cumulative predicted metric mean change and
    variance reduction.  ``unbiased`` mirrors
    ``FilterConfig.unbiased_variance``.
    """
    s = state.structure
    nm = s.nmems
    batch = ObservationBatch.coerce(obs)
    if not 0 < nselect <= batch.nobs:
        raise ValueError(f"nselect must be in 1..{batch.nobs}")
    j = metric_values(state, metric)
    jp = j - j.mean()

    taps = _fwd.build_taps_cached(
        s, batch.lats, batch.lons, batch.times_s, batch.var_indices(s),
        time_weighting=time_weighting,
    )
    ye = np.asarray(_fwd.apply_taps_obj(state.to_vect(), taps),
                    dtype=np.float64)
    qc = np.asarray(taps.qc_ok)
    mye = ye.mean(axis=1)
    yep = ye - mye[:, None]
    errors = np.asarray(batch.errors, dtype=np.float64)
    values = np.asarray(batch.values, dtype=np.float64)
    ddof_den = 1 if unbiased else 0

    avail = qc.copy()
    rows = []
    cum_dj, cum_dvar = 0.0, 0.0
    for _ in range(nselect):
        varye = np.sum(yep * yep, axis=1) / (nm - ddof_den)
        kdenom = varye + errors
        covj = yep @ jp / (nm - 1)
        score = np.where(avail, covj * covj / kdenom, -np.inf)
        pick = int(np.argmax(score))
        if not np.isfinite(score[pick]):
            break  # no eligible candidates left
        avail[pick] = False

        kd, r = kdenom[pick], errors[pick]
        innov = values[pick] - mye[pick]
        dj_mean = covj[pick] / kd * innov
        dj_var = -covj[pick] * covj[pick] / kd
        cum_dj += dj_mean
        cum_dvar += dj_var
        rows.append(
            {
                "candidate": pick,
                "obtype": batch.obtypes[pick],
                "lat": float(batch.lats[pick]),
                "lon": float(batch.lons[pick]),
                "dJ_mean_step": dj_mean,
                "dJ_var_step": dj_var,
                "dJ_mean_cum": cum_dj,
                "dJ_var_cum": cum_dvar,
            }
        )

        # exact serial square-root update of the obs-space tail + metric
        ye_p = yep[pick].copy()
        kvec = (yep @ ye_p) / (nm - 1) / kd  # [No] gains onto candidates
        kj = covj[pick] / kd
        beta = 1.0 / (1.0 + math.sqrt(r / kd))
        mye = mye + kvec * innov
        yep = yep - beta * np.outer(kvec, ye_p)
        jp = jp - beta * kj * ye_p

    import pandas as pd

    return pd.DataFrame(rows)
