"""Observation-space verification statistics.

Parity with ``efa_xray/postprocess/postprocess.py:8-39``: a per-observation
pandas DataFrame of prior/posterior obs-space means and variances plus
metadata.  The forward operator is re-applied to prior and posterior in one
vectorized gather each, instead of the reference's per-ob Python loop.
"""

from __future__ import annotations

from typing import TYPE_CHECKING

import numpy as np

if TYPE_CHECKING:  # pandas is an optional install (DataFrame results)
    import pandas as pd

from efa_xray_tpu.observation import forward as _fwd
from efa_xray_tpu.observation.observation import ObservationBatch
from efa_xray_tpu.state.ensemble import EnsembleState
from efa_xray_tpu.utils import timeutil


def obs_assimilation_statistics(
    prior: EnsembleState,
    post: EnsembleState,
    obs,
    time_weighting: str = "linear",
) -> pd.DataFrame:
    """Per-ob statistics table (columns match the reference's)."""
    assert isinstance(prior, EnsembleState)
    assert isinstance(post, EnsembleState)
    batch = ObservationBatch.coerce(obs)

    taps = _fwd.build_taps_cached(
        prior.structure,
        batch.lats,
        batch.lons,
        batch.times_s,
        batch.var_indices(prior.structure),
        time_weighting=time_weighting,
    )
    prior_ye = np.asarray(_fwd.apply_taps_obj(prior.to_vect(), taps), dtype=np.float64)
    post_ye = np.asarray(_fwd.apply_taps_obj(post.to_vect(), taps), dtype=np.float64)

    batch.materialize_diagnostics()
    assimilated = batch.assimilated
    if assimilated is None:
        assimilated = np.zeros(batch.nobs, dtype=bool)

    lead = timeutil.lead_hours(batch.times_s, prior.structure.times_s[0])
    import pandas as pd

    df = pd.DataFrame(
        {
            "validtime": timeutil.to_datetime64(batch.times_s),
            "flead": lead,
            "lat": batch.lats,
            "lon": batch.lons,
            "obtype": batch.obtypes,
            "description": batch.descriptions,
            "ob error": batch.errors,
            "value": batch.values,
            "assimilated": np.asarray(assimilated, dtype=bool),
            "prior mean": prior_ye.mean(axis=1),
            "post mean": post_ye.mean(axis=1),
            "prior variance": prior_ye.var(axis=1),
            "post variance": post_ye.var(axis=1),
        }
    )
    # Extension column (absent in the reference): innovation-outlier QC
    # outcome, when the filter ran with FilterConfig.outlier_threshold.
    if batch.qc_outlier is not None:
        df["outlier"] = np.asarray(batch.qc_outlier, dtype=bool)
    return df
