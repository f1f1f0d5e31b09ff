"""Ensemble verification statistics beyond the reference's per-ob table.

The reference's only verification artifact is the per-ob DataFrame
(``efa_xray/postprocess/postprocess.py:8-39``).  Cycling/production DA
needs ensemble-quality diagnostics as well; this module adds the standard
ones:

* field RMSE / bias / spread against a truth field (spread-skill: a
  calibrated ensemble has RMSE ~ spread * sqrt((M+1)/M));
* observation-space rank histograms (flat for a reliable ensemble);
* observation-space CRPS (exact kernel form, plain or fair);
* innovation consistency: E[d^2] vs (prior_var + R), the statistic that
  drives adaptive inflation (Anderson 2009).
"""

from __future__ import annotations

from typing import TYPE_CHECKING, Dict, Optional

import numpy as np

if TYPE_CHECKING:  # pandas is an optional install (DataFrame results)
    import pandas as pd

from efa_xray_tpu.observation import forward as _fwd
from efa_xray_tpu.observation.observation import ObservationBatch
from efa_xray_tpu.state.ensemble import EnsembleState


def field_verification(state: EnsembleState, truth) -> pd.DataFrame:
    """Per-variable, per-validtime RMSE/bias/spread vs a truth field.

    ``truth``: array ``[nvars, ntimes, ny, nx]`` (or ``[ntimes, ny, nx,
    nvars]``, auto-transposed).
    """
    s = state.structure
    tr = np.asarray(truth)
    if tr.shape == (s.ntimes, s.ny, s.nx, s.nvars):
        tr = np.transpose(tr, (3, 0, 1, 2))
    if tr.shape != (s.nvars, s.ntimes, s.ny, s.nx):
        raise ValueError(f"truth shape {tr.shape} does not match state {s.shape[:-1]}")
    mean = np.asarray(state.ensemble_mean())
    spread = np.asarray(state.ensemble_spread())
    full = np.asarray(state.data, dtype=np.float64)  # [V, T, Y, X, M]
    m = full.shape[-1]
    w = 2.0 * np.arange(m) + 1.0 - m
    rows = []
    for vi, name in enumerate(s.var_names):
        for ti, t in enumerate(s.times64()):
            err = mean[vi, ti] - tr[vi, ti]
            ens = full[vi, ti].reshape(-1, m)
            mae = np.mean(np.abs(ens - tr[vi, ti].reshape(-1, 1)))
            pair = 2.0 * np.mean(np.sort(ens, axis=1) @ w) / (m * m)
            rows.append(
                {
                    "variable": name,
                    "validtime": t,
                    "rmse": float(np.sqrt(np.mean(err**2))),
                    "bias": float(np.mean(err)),
                    "spread": float(np.mean(spread[vi, ti])),
                    # grid-mean exact ensemble CRPS vs truth (scores the
                    # full predictive distribution, not just the mean)
                    "crps": float(mae - 0.5 * pair),
                }
            )
    import pandas as pd

    return pd.DataFrame(rows)


def rank_histogram(state: EnsembleState, obs, time_weighting: str = "linear"):
    """Observation-space rank histogram: for each ob, the rank of the
    observed value within the sorted ensemble estimates.  Returns
    ``counts`` of length ``nmems + 1`` (flat == statistically reliable)."""
    batch = ObservationBatch.coerce(obs)
    s = state.structure
    taps = _fwd.build_taps_cached(
        s, batch.lats, batch.lons, batch.times_s, batch.var_indices(s),
        time_weighting=time_weighting,
    )
    ye = np.asarray(_fwd.apply_taps_obj(state.to_vect(), taps), dtype=np.float64)
    ok = np.asarray(taps.qc_ok)
    ranks = (ye[ok] < batch.values[ok, None]).sum(axis=1)
    return np.bincount(ranks, minlength=s.nmems + 1)


def crps(state: EnsembleState, obs, time_weighting: str = "linear",
         fair: bool = False):
    """Observation-space continuous ranked probability score.

    For each ob, the exact ensemble (kernel) CRPS of the member estimates
    ``ye`` against the observed value (Gneiting & Raftery 2007, eq. 21):

        CRPS_i = mean_j |ye_ij - y_i|  -  0.5 c * mean_jk |ye_ij - ye_ik|

    with ``c = 1`` for the plain score of the empirical ensemble CDF and
    ``c = M/(M-1)`` for the FAIR score (Ferro et al. 2008) — the unbiased
    estimate of the CRPS the underlying distribution would achieve with
    infinite members, the right choice when comparing ensembles of
    different sizes.  Lower is better; reduces to ``|mean - y|`` (MAE)
    for a spread-less ensemble.  QC-failing obs (outside the state's
    space/time domain) are skipped.

    Returns ``(per_ob, mean)``: a length-``nobs`` float array (NaN where
    QC failed) and the mean over QC-passing obs.
    """
    batch = ObservationBatch.coerce(obs)
    s = state.structure
    taps = _fwd.build_taps_cached(
        s, batch.lats, batch.lons, batch.times_s, batch.var_indices(s),
        time_weighting=time_weighting,
    )
    ye = np.asarray(_fwd.apply_taps_obj(state.to_vect(), taps),
                    dtype=np.float64)
    m = ye.shape[1]
    if fair and m < 2:
        raise ValueError("fair CRPS needs at least 2 members")
    mae = np.mean(np.abs(ye - batch.values[:, None]), axis=1)
    # E|X - X'| via the sorted-ensemble identity (O(M log M) per ob):
    # mean_jk |x_j - x_k| = (2/M^2) * sum_j ((2j + 1 - M) * x_(j))
    srt = np.sort(ye, axis=1)
    w = 2.0 * np.arange(m) + 1.0 - m
    spread_term = 2.0 * (srt @ w) / (m * m)
    c = m / (m - 1.0) if fair else 1.0
    per_ob = mae - 0.5 * c * spread_term
    ok = np.asarray(taps.qc_ok)
    per_ob = np.where(ok, per_ob, np.nan)
    return per_ob, float(np.mean(per_ob[ok]))


def innovation_consistency(batch: ObservationBatch) -> Dict[str, float]:
    """Innovation variance consistency after a filter run: for a
    well-tuned system ``mean(d^2) ~= mean(prior_var + R)``; a ratio > 1
    signals an under-dispersive prior (raise inflation)."""
    if batch.prior_mean is None:
        raise ValueError("Run the filter first (no prior_mean diagnostics)")
    batch.materialize_diagnostics()
    ok = (
        np.ones(batch.nobs, dtype=bool)
        if batch.assimilated is None
        else np.asarray(batch.assimilated)
    )
    d2 = (batch.values[ok] - batch.prior_mean[ok]) ** 2
    expected = batch.prior_var[ok] + batch.errors[ok]
    return {
        "mean_innov_sq": float(np.mean(d2)),
        "mean_expected": float(np.mean(expected)),
        "consistency_ratio": float(np.mean(d2) / np.mean(expected)),
        "nobs": int(ok.sum()),
    }


def desroziers_diagnostics(
    stats: pd.DataFrame, group_by: Optional[str] = "obtype"
) -> pd.DataFrame:
    """Desroziers et al. (2005, QJRMS) a-posteriori consistency diagnostics.

    Input is the per-ob table from
    :func:`efa_xray_tpu.postprocess.postprocess.obs_assimilation_statistics`
    (the device twin of ``efa_xray/postprocess/postprocess.py:8-39`` —
    the reference computes the raw per-ob stats but offers no consistency
    analysis of them).  With background departures ``d_b = y - H(x_b)`` and
    analysis departures ``d_a = y - H(x_a)``, a filter using correct R and
    HBH^T satisfies, in expectation over obs:

    * ``E[d_a d_b] = R``            (estimated obs-error variance)
    * ``E[(d_b - d_a) d_b] = HBH^T`` (estimated background variance in
      obs space)
    * ``E[d_b^2] = HBH^T + R``       (total innovation variance)

    Returns one row per ``group_by`` group (or a single "all" row): counts,
    assigned vs estimated R, the estimated-to-assigned ratio (> 1 means
    the assigned obs error is too small), estimated HBH^T vs the ensemble
    prior variance, and the total-innovation consistency ratio that drives
    adaptive inflation.
    """
    df = stats[stats["assimilated"].astype(bool)]
    if len(df) == 0:
        raise ValueError("No assimilated observations in the table")

    def one(g: pd.DataFrame) -> Dict[str, float]:
        d_b = np.asarray(g["value"] - g["prior mean"], dtype=np.float64)
        d_a = np.asarray(g["value"] - g["post mean"], dtype=np.float64)
        r_assigned = float(np.mean(g["ob error"]))
        r_est = float(np.mean(d_a * d_b))
        hbht_est = float(np.mean((d_b - d_a) * d_b))
        total = float(np.mean(d_b * d_b))
        prior_var = float(np.mean(g["prior variance"]))
        return {
            "nobs": int(len(g)),
            "R_assigned": r_assigned,
            "R_estimated": r_est,
            "R_ratio": r_est / r_assigned if r_assigned > 0 else np.nan,
            "HBHT_estimated": hbht_est,
            "prior_var_ensemble": prior_var,
            "innov_var": total,
            "innov_var_expected": prior_var + r_assigned,
            "innov_consistency": (
                total / (prior_var + r_assigned)
                if prior_var + r_assigned > 0
                else np.nan
            ),
        }

    if group_by is None:
        rows = {"all": one(df)}
    else:
        rows = {k: one(g) for k, g in df.groupby(group_by)}
    import pandas as pd

    out = pd.DataFrame.from_dict(rows, orient="index")
    out.index.name = group_by or "group"
    return out
