"""Observation records and the device-friendly struct-of-arrays batch.

The reference models observations as a Python attribute bag, one object per
ob (``efa_xray/observation/observation.py:17-36``), looped over in Python.
On the device a batch of observations is a *struct of arrays*
(:class:`ObservationBatch`): values, error variances, coordinates, times,
per-ob localization radii, and QC masks — everything a jitted kernel needs
as dense arrays, with human metadata (descriptions, type names) kept on the
host.  :class:`Observation` is retained as the per-ob user-facing record for
drop-in familiarity, including the diagnostic result slots
(``prior_mean/prior_var/post_mean/post_var/assimilated``) the filter writes
back (reference: ``ensrf.py:66-70,144-149``).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np

from efa_xray_tpu.observation import localization as _loc
from efa_xray_tpu.utils import timeutil


class Observation:
    """One point observation (reference parity:
    ``efa_xray/observation/observation.py:17-36``)."""

    def __init__(
        self,
        value=None,
        obtype=None,
        time=None,
        error=None,
        lat=None,
        lon=None,
        vert=None,
        prior_mean=None,
        post_mean=None,
        prior_var=None,
        post_var=None,
        assimilate_this=False,
        description=None,
        localize_radius=None,
        vert_localize_radius=None,
        forward_operator=None,
    ):
        self.value = value
        self.obtype = obtype
        self.time = time
        self.error = error  # observation error VARIANCE (R)
        self.lat = lat
        self.lon = lon
        self.vert = vert
        self.prior_mean = prior_mean
        self.post_mean = post_mean
        self.prior_var = prior_var
        self.post_var = post_var
        self.assimilate_this = assimilate_this
        self.assimilated = False
        # Set True by the filter when FilterConfig.outlier_threshold
        # rejects this ob (innovation-based gross-error QC).
        self.outlier = False
        self.description = description
        self.localize_radius = localize_radius
        # Vertical GC halfwidth in the same units as ``vert`` (extension;
        # the reference stores ``vert`` but never localizes on it).
        self.vert_localize_radius = vert_localize_radius
        # Optional custom H: a callable ``state -> ye[nmems]`` — the
        # pluggable-operator hook the reference's docstring promises but
        # never implements (``observation/observation.py:44-46``).
        self.forward_operator = forward_operator

    def estimate(self, state):
        """Ensemble estimate of this ob: H(x) for every member
        (reference: ``efa_xray/observation/observation.py:40-50``).  Uses
        the custom ``forward_operator`` when set, otherwise space/time
        interpolation of the matching state variable."""
        if self.forward_operator is not None:
            return self.forward_operator(state)
        return state.interpolate(self.obtype, self.time, self.lat, self.lon)

    def distance_to_state(self, state):
        """Distance (km) from this ob to every state grid point
        (reference: ``efa_xray/observation/observation.py:53-56``)."""
        return state.distance_to_point(self.lat, self.lon)

    def localize(self, state, type="GC", full_state=False):
        """Localization weights from this ob to a state grid or to a list
        of observations (reference: ``efa_xray/observation/observation.py:59-87``).

        ``localize_radius=None`` returns ones (the reference crashes on
        this case; see SURVEY.md §2.1/O3)."""
        halfwidth = self.localize_radius
        if isinstance(state, (list, tuple)):
            other_lats = np.asarray([ob.lat for ob in state], dtype=np.float64)
            other_lons = np.asarray([ob.lon for ob in state], dtype=np.float64)
            distances = np.asarray(
                _loc.haversine((self.lat, self.lon), (other_lats, other_lons))
            )
        else:
            distances = np.asarray(state.distance_to_point(self.lat, self.lon))
        if halfwidth is None:
            return np.ones(distances.shape)
        if type == "GC":
            return _loc.gaspari_cohn_np(distances, halfwidth)
        raise ValueError(f"Unknown localization type {type!r}")

    def map_localization(self, state, projection=None, type="GC", ax=None,
                         coastlines="auto"):
        """Plot the localization footprint (reference:
        ``efa_xray/observation/observation.py:94-115``, which needed
        Basemap; here plain matplotlib / any callable projection).

        ``coastlines``: draw coastline outlines (the reference's
        ``drawcoastlines``/``drawcountries``, ``observation.py:109-111``).
        A geo toolkit is used when importable — cartopy preferred,
        Basemap as fallback; when neither is installed (this image ships
        neither), ``"auto"``/``True`` fall back to the built-in
        orientation-grade world outline
        (:mod:`efa_xray_tpu.utils.coastlines`).  A path or ``(N, 2)``
        lon/lat array draws those user-supplied NaN-separated polylines
        instead (see :func:`utils.coastlines.load_segments` for the
        formats).  ``False`` disables."""
        import matplotlib.pyplot as plt

        localization = np.asarray(self.localize(state, type=type))
        if projection is not None:
            gx, gy = state.project_coordinates(projection)
        else:
            gx, gy = np.asarray(state.structure.lon), np.asarray(state.structure.lat)
        coast_auto = coastlines is True or (
            isinstance(coastlines, str) and coastlines == "auto"
        )
        if ax is None:
            if coast_auto and projection is None:
                try:  # lat/lon axes: a cartopy GeoAxes gives real outlines
                    import cartopy.crs as ccrs

                    _, ax = plt.subplots(
                        figsize=(10, 8),
                        subplot_kw={"projection": ccrs.PlateCarree()},
                    )
                except ImportError:
                    _, ax = plt.subplots(figsize=(10, 8))
            else:
                _, ax = plt.subplots(figsize=(10, 8))
        pm = ax.pcolormesh(gx, gy, localization.reshape(gx.shape), vmin=0.0, vmax=1.0)
        if coastlines is not False and coastlines is not None:
            from ..utils import coastlines as _coast

            segments = None  # builtin coarse world outline
            drew = False
            if coast_auto:
                if hasattr(ax, "coastlines"):  # cartopy GeoAxes
                    try:
                        import cartopy.feature as cfeature

                        ax.coastlines()
                        ax.add_feature(cfeature.BORDERS, linewidth=0.5)
                        drew = True
                    except Exception:
                        pass
                if not drew and projection is not None and hasattr(
                    projection, "drawcoastlines"
                ):  # a Basemap instance doubles as the projection callable
                    try:
                        projection.drawcoastlines(ax=ax)
                        projection.drawcountries(ax=ax)
                        drew = True
                    except Exception:
                        pass
            else:  # a path or an (N, 2) lon/lat array of polylines
                segments = coastlines
            if not drew:
                lon360 = projection is None and np.nanmax(gx) > 180.0
                _coast.draw_coastlines(
                    ax, segments=segments, projection=projection,
                    lon360=lon360,
                )
                if projection is None:
                    # keep the view on the data, not the world outline
                    ax.set_xlim(float(np.nanmin(gx)), float(np.nanmax(gx)))
                    ax.set_ylim(float(np.nanmin(gy)), float(np.nanmax(gy)))
        plt.colorbar(pm, ax=ax)
        ax.set_title(
            "Localization Weights for {:s} ({:5.3f},{:5.3f})".format(
                str(self.description), self.lat, self.lon
            )
        )
        return ax

    def __repr__(self):
        return (
            f"Observation({self.obtype!r}, value={self.value}, "
            f"lat={self.lat}, lon={self.lon}, time={self.time})"
        )


@dataclasses.dataclass
class ObservationBatch:
    """Struct-of-arrays view of N observations (all host NumPy; converted
    to device arrays at the assimilation boundary)."""

    values: np.ndarray  # float64 [N]
    errors: np.ndarray  # float64 [N], observation error variance R
    lats: np.ndarray  # float64 [N]
    lons: np.ndarray  # float64 [N]
    times_s: np.ndarray  # int64 [N] epoch seconds
    obtypes: List[str]  # length N variable names
    localize_radius: np.ndarray  # float64 [N]; np.inf == no localization
    assimilate_flags: np.ndarray  # bool [N]
    verts: np.ndarray  # float64 [N] vertical coordinate (NaN when absent)
    descriptions: List[Optional[str]]
    vert_radius: np.ndarray = None  # float64 [N] vertical halfwidth; inf = off
    # True where the ob carries a custom forward_operator (its obtype need
    # not name a state variable and it bypasses interpolation QC).
    custom_operator: np.ndarray = None

    # Result slots (filled by the filter)
    prior_mean: Optional[np.ndarray] = None
    prior_var: Optional[np.ndarray] = None
    post_mean: Optional[np.ndarray] = None
    post_var: Optional[np.ndarray] = None
    assimilated: Optional[np.ndarray] = None
    # True where FilterConfig.outlier_threshold rejected an otherwise-
    # assimilable ob (innovation-based gross-error QC / background check).
    qc_outlier: Optional[np.ndarray] = None

    def __post_init__(self):
        if self.vert_radius is None:
            self.vert_radius = np.full(len(self.values), np.inf, dtype=np.float64)
        if self.custom_operator is None:
            self.custom_operator = np.zeros(len(self.values), dtype=bool)

    def __len__(self) -> int:
        return len(self.values)

    @property
    def nobs(self) -> int:
        return len(self.values)

    @classmethod
    def from_observations(cls, obs: Sequence[Observation]) -> "ObservationBatch":
        n = len(obs)
        radius = np.full(n, np.inf, dtype=np.float64)
        vert_radius = np.full(n, np.inf, dtype=np.float64)
        for i, ob in enumerate(obs):
            if ob.localize_radius is not None:
                radius[i] = float(ob.localize_radius)
            if getattr(ob, "vert_localize_radius", None) is not None:
                vert_radius[i] = float(ob.vert_localize_radius)
        return cls(
            values=np.asarray([ob.value for ob in obs], dtype=np.float64),
            errors=np.asarray([ob.error for ob in obs], dtype=np.float64),
            lats=np.asarray([ob.lat for ob in obs], dtype=np.float64),
            lons=np.asarray([ob.lon for ob in obs], dtype=np.float64),
            times_s=timeutil.to_epoch_seconds([ob.time for ob in obs]),
            obtypes=[ob.obtype for ob in obs],
            localize_radius=radius,
            assimilate_flags=np.asarray(
                [bool(ob.assimilate_this) for ob in obs], dtype=bool
            ),
            verts=np.asarray(
                [np.nan if ob.vert is None else float(ob.vert) for ob in obs],
                dtype=np.float64,
            ),
            descriptions=[ob.description for ob in obs],
            vert_radius=vert_radius,
            custom_operator=np.asarray(
                [getattr(ob, "forward_operator", None) is not None for ob in obs],
                dtype=bool,
            ),
            # carry result slots already present on the objects (the
            # reference postprocess reads ob.assimilated, postprocess.py:29)
            assimilated=np.asarray(
                [bool(getattr(ob, "assimilated", False)) for ob in obs], dtype=bool
            ),
        )

    @classmethod
    def coerce(cls, obs) -> "ObservationBatch":
        if isinstance(obs, ObservationBatch):
            return obs
        return cls.from_observations(list(obs))

    def take(self, order) -> "ObservationBatch":
        """Reordered copy: every per-ob array/list (including any filled
        result slots) permuted by ``order``.  Device-resident result
        slots stay device arrays (the gather happens on device — no host
        sync)."""
        order = np.asarray(order)

        def perm(v):
            if v is None:
                return None
            if isinstance(v, list):
                return [v[i] for i in order]
            return v[order]  # np stays np, jax stays jax

        return dataclasses.replace(
            self, **{f.name: perm(getattr(self, f.name))
                     for f in dataclasses.fields(self)}
        )

    def spatial_sort(self) -> Tuple["ObservationBatch", np.ndarray]:
        """``(sorted_batch, order)`` with obs in spherical-Hilbert
        spatial-locality order.

        Observation order is the CALLER's choice in a serial filter (the
        analysis is weakly order-dependent; the reference demo shuffles
        it, ``efa_demo.ipynb`` cell 11) — and spatially sorted obs are
        the THROUGHPUT choice: the body kernel culls (row-tile, obs
        block) pairs whose localization weights are provably zero, which
        only engages when consecutive obs are spatially compact.
        Diagnostics
        come back in the sorted order; invert with
        ``batch.take(np.argsort(order))``."""
        from efa_xray_tpu.observation.thinning import _hilbert3d_np

        order = np.argsort(_hilbert3d_np(self.lats, self.lons),
                           kind="stable")
        return self.take(order), order

    def var_indices(self, structure) -> np.ndarray:
        """State-variable index per ob.  Custom-operator obs map to 0: their
        interpolation taps are placeholders that compute_ob_priors
        overrides, so their obtype need not name a state variable."""
        return np.asarray(
            [
                0 if self.custom_operator[i] else structure.var_index(t)
                for i, t in enumerate(self.obtypes)
            ],
            dtype=np.int32,
        )

    def materialize_diagnostics(self) -> None:
        """Convert device-resident result slots to host float64/bool NumPy
        in ONE transfer.  ``record_diagnostics`` leaves the filter's device
        arrays in the slots so no host pull sits on the update's critical
        path; every per-element consumer (``writeback``, ``to_dataframe``,
        verification) calls this first — otherwise each ``float(x[i])``
        would pay its own device round trip."""
        import jax

        host_names = ("prior_mean", "prior_var", "post_mean", "post_var")
        bool_names = ("assimilated", "qc_outlier")
        pending = {
            n: getattr(self, n)
            for n in host_names + bool_names
            if getattr(self, n) is not None
            and not isinstance(getattr(self, n), np.ndarray)
        }
        if not pending:
            return
        host = jax.device_get(pending)
        for n, v in host.items():
            dtype = bool if n in bool_names else np.float64
            setattr(self, n, np.asarray(v, dtype=dtype))

    def writeback(self, obs: Sequence[Observation]) -> None:
        """Copy filter diagnostics back onto user Observation objects,
        mirroring the in-place attribute writes of the reference loop
        (``efa_xray/assimilation/ensrf.py:66-70,144-149``)."""
        self.materialize_diagnostics()
        for i, ob in enumerate(obs):
            ob.prior_mean = None if self.prior_mean is None else float(self.prior_mean[i])
            ob.prior_var = None if self.prior_var is None else float(self.prior_var[i])
            ob.outlier = (
                False if self.qc_outlier is None else bool(self.qc_outlier[i])
            )
            if self.assimilated is not None and self.assimilated[i]:
                ob.post_mean = float(self.post_mean[i])
                ob.post_var = float(self.post_var[i])
                ob.assimilated = True
            else:
                ob.assimilated = False

    def to_observations(self) -> List[Observation]:
        out = []
        for i in range(self.nobs):
            ob = Observation(
                value=float(self.values[i]),
                obtype=self.obtypes[i],
                time=timeutil.to_datetime64(self.times_s[i]),
                error=float(self.errors[i]),
                lat=float(self.lats[i]),
                lon=float(self.lons[i]),
                vert=None if np.isnan(self.verts[i]) else float(self.verts[i]),
                assimilate_this=bool(self.assimilate_flags[i]),
                description=self.descriptions[i],
                localize_radius=(
                    None
                    if np.isinf(self.localize_radius[i])
                    else float(self.localize_radius[i])
                ),
                vert_localize_radius=(
                    None
                    if np.isinf(self.vert_radius[i])
                    else float(self.vert_radius[i])
                ),
            )
            out.append(ob)
        if self.prior_mean is not None:
            self.writeback(out)
        return out

    def to_dataframe(self):
        """Pandas view of the batch (one row per ob), including result
        slots when the filter has run.  Inverse of :meth:`from_dataframe`.
        """
        import pandas as pd

        self.materialize_diagnostics()

        cols = {
            "value": np.asarray(self.values, dtype=np.float64),
            "error": np.asarray(self.errors, dtype=np.float64),
            "lat": np.asarray(self.lats, dtype=np.float64),
            "lon": np.asarray(self.lons, dtype=np.float64),
            "time": timeutil.to_datetime64(self.times_s),
            "obtype": list(self.obtypes),
            "localize_radius": np.asarray(self.localize_radius,
                                          dtype=np.float64),
            "assimilate_this": np.asarray(self.assimilate_flags, dtype=bool),
            "vert": np.asarray(self.verts, dtype=np.float64),
            "vert_radius": np.asarray(self.vert_radius, dtype=np.float64),
            "description": list(self.descriptions),
        }
        for name in ("prior_mean", "prior_var", "post_mean", "post_var",
                     "assimilated", "qc_outlier"):
            val = getattr(self, name)
            if val is not None:
                cols[name] = np.asarray(val)
        return pd.DataFrame(cols)

    @classmethod
    def from_dataframe(cls, df) -> "ObservationBatch":
        """Build a batch from a DataFrame with (at least) columns
        ``value, error, lat, lon, time, obtype``.  Optional columns:
        ``localize_radius`` (default inf = no localization),
        ``assimilate_this`` (default True), ``vert`` (default NaN),
        ``vert_radius`` (default inf), ``description`` (default None).
        The tabular twin of the reference's per-Observation constructor
        (``efa_xray/observation/observation.py:17-36``)."""
        n = len(df)

        def col(name, default, dtype=np.float64):
            if name in df.columns:
                return np.asarray(df[name], dtype=dtype)
            return np.full(n, default, dtype=dtype)

        descriptions = (
            [None if (d is None or (isinstance(d, float) and np.isnan(d)))
             else str(d) for d in df["description"]]
            if "description" in df.columns
            else [None] * n
        )
        return cls(
            values=np.asarray(df["value"], dtype=np.float64),
            errors=np.asarray(df["error"], dtype=np.float64),
            lats=np.asarray(df["lat"], dtype=np.float64),
            lons=np.asarray(df["lon"], dtype=np.float64),
            times_s=timeutil.to_epoch_seconds(
                np.asarray(df["time"], dtype="datetime64[s]")
            ),
            obtypes=[str(t) for t in df["obtype"]],
            localize_radius=col("localize_radius", np.inf),
            assimilate_flags=col("assimilate_this", True, dtype=bool),
            verts=col("vert", np.nan),
            descriptions=descriptions,
            vert_radius=col("vert_radius", np.inf),
        )
