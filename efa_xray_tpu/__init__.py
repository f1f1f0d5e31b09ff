"""efa_xray_tpu — a JAX ensemble square-root filter (EnSRF) framework.

A brand-new JAX/XLA implementation of Ensemble Forecast Adjustment (EFA;
Madaus & Hakim 2015) with the full capability surface of the reference
``lmadaus/efa_xray`` package, re-designed for accelerators:

* the ensemble state is a dense device array ``[vars, times, y, x, members]``
  with static host-side metadata (``StateStructure``) instead of an
  ``xarray.Dataset`` subclass (reference: ``efa_xray/state/ensemble.py:15``);
* the serial per-observation Python loop (reference:
  ``efa_xray/assimilation/ensrf.py:50-149``) becomes a ``lax.scan`` and a
  mathematically-equivalent *blocked* two-phase algorithm whose hot ops are
  matrix products (on a GPU, one fused Triton kernel);
* forward operators (reference: ``efa_xray/state/ensemble.py:170-239``)
  become precomputed gather indices + weights applied in one vectorized shot;
* multi-chip runs shard the state axis over a ``jax.sharding.Mesh`` with the
  observation-space tail replicated (zero per-observation collectives),
  replacing the reference's broken ``multiprocessing`` driver
  (``efa_xray/assimilation/assimilation.py:176-230``).
"""

from efa_xray_tpu.state.structure import StateStructure
from efa_xray_tpu.state.ensemble import EnsembleState
from efa_xray_tpu.observation.observation import Observation, ObservationBatch
from efa_xray_tpu.observation.localization import (
    gaspari_cohn,
    haversine,
    distance_to_point,
)
from efa_xray_tpu.assimilation.assimilation import Assimilation, update
from efa_xray_tpu.assimilation.enkf import EnKF
from efa_xray_tpu.assimilation.ensrf import EnSRF
from efa_xray_tpu.assimilation.letkf import LETKF
from efa_xray_tpu.assimilation.adaptive_inflation import AdaptiveInflation
from efa_xray_tpu.postprocess.postprocess import obs_assimilation_statistics
from efa_xray_tpu.config import FilterConfig

__version__ = "0.1.0"

__all__ = [
    "StateStructure",
    "EnsembleState",
    "Observation",
    "ObservationBatch",
    "gaspari_cohn",
    "haversine",
    "distance_to_point",
    "Assimilation",
    "EnKF",
    "EnSRF",
    "LETKF",
    "AdaptiveInflation",
    "update",
    "obs_assimilation_statistics",
    "FilterConfig",
]
