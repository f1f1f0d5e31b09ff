"""Assimilation driver layer: priors, inflation, state formatting.

Functional parity with ``efa_xray/assimilation/assimilation.py``:

* observation priors (``compute_ob_priors`` :36-49) — one vectorized gather
  for the whole batch instead of a per-ob Python loop;
* multiplicative inflation (``inflate_state`` :52-118) — float / dict /
  file forms as a single broadcast multiply;
* prior formatting with state augmentation (``format_prior_state``
  :120-154) — the flattened state splits into mean + perturbations and the
  obs-space priors are appended as a *separately carried* tail (replicated
  under sharding while the body is sharded; SURVEY.md §5.8);
* posterior formatting (``format_posterior_state`` :157-171).

The module-level :func:`update` driver replaces the reference's dead
multiprocessing fan-out (:176-230) with a working call that optionally
shards over a device mesh.
"""

from __future__ import annotations

import copy
import functools
from typing import Optional, Sequence, Tuple, Union

import jax
import jax.numpy as jnp
import numpy as np

from efa_xray_tpu.config import FilterConfig
from efa_xray_tpu.observation import forward as _fwd
from efa_xray_tpu.observation.observation import Observation, ObservationBatch
from efa_xray_tpu.state.ensemble import EnsembleState
from efa_xray_tpu.utils.validation import ValidationError

InflationSpec = Union[None, float, str, dict]


@functools.partial(jax.jit, static_argnames=("dtype",))
def _unpack_obs(packed, dtype):
    """Split the packed ``[8, No]`` per-ob matrix into the ObsArrays
    fields in one dispatch (row 7 is the assimilate mask as 0/1)."""
    p = packed.astype(dtype)
    return p[0], p[1], p[2], p[3], p[4], p[5], p[6], packed[7] != 0


@functools.partial(jax.jit, static_argnames=("dtype",))
def _format_prior_jit(data, rows, weights, dtype):
    """Fused prior formatting: flatten + mean/perts split for the state
    body AND the obs-space tail (the taps gather) in ONE dispatch.

    Functionally identical to the unfused path (reshape -> apply_taps ->
    means -> perts -> astype); one dispatch instead of several per update
    (``benchmarks/api_anatomy.py``)."""
    from efa_xray_tpu.observation import forward as _fwd

    vect = jnp.reshape(data, (-1, data.shape[-1]))
    ye = _fwd.apply_taps(vect, rows, weights)
    tail_mean = jnp.mean(ye, axis=1)
    tail_perts = (ye - tail_mean[:, None]).astype(dtype)
    body_mean = jnp.mean(vect, axis=1)
    body_perts = (vect - body_mean[:, None]).astype(dtype)
    return (body_mean.astype(dtype), body_perts,
            tail_mean.astype(dtype), tail_perts)


@functools.partial(jax.jit, static_argnames=("shape", "dtype"))
def _posterior_jit(body_mean, body_perts, shape, dtype):
    """Fused posterior rebuild: recombine + cast + reshape in one dispatch."""
    return jnp.reshape(
        (body_mean[:, None] + body_perts).astype(dtype), shape
    )


def inflate_state(
    state: EnsembleState, inflation: InflationSpec, verbose: bool = False
) -> EnsembleState:
    """Multiplicative prior-perturbation inflation.

    Accepted specs (reference semantics,
    ``efa_xray/assimilation/assimilation.py:52-118``):

    * float — all variables' perturbations scaled by the factor;
    * str — filename of a saved inflation dataset (netCDF/HDF5 written by
      this package); per-variable fields broadcast-multiply that variable's
      perturbations (fields may be any shape broadcastable to
      ``(ntimes, ny, nx)``);
    * dict — keys that are dimension names (``validtime``/``lat``/``lon``/
      ``x``/``y``) map to 1-D arrays of per-element factors along that
      dimension applied to all variables; keys that are variable names map
      to scalar factors for that variable (unknown variables are skipped
      with a warning, matching :107-109).

    Returns a new inflated state (the reference mutates in place and needs
    an ``is_inflated`` idempotence flag, :56-59; a pure function needs none).
    """
    if inflation is None:
        return state
    # AdaptiveInflation instance: delegate to its mean-field multiply
    # (the reference defines the class but nothing ever calls it; SURVEY §2/A8).
    from efa_xray_tpu.assimilation.adaptive_inflation import AdaptiveInflation

    if isinstance(inflation, AdaptiveInflation):
        if verbose:
            print("Applying adaptive inflation mean field")
        return inflation.inflate_state(state)
    s = state.structure
    mean = state.ensemble_mean()[..., None]  # [V,T,Y,X,1]
    perts = state.data - mean

    if isinstance(inflation, (int, float)) and not isinstance(inflation, bool):
        if verbose:
            print(f"Inflating all variables by factor: {float(inflation):3.2f}")
        return state.replace_data(perts * float(inflation) + mean)

    if isinstance(inflation, str):
        from efa_xray_tpu.utils import ncio

        if verbose:
            print(f"Loading inflation from file: {inflation}")
        ds = ncio.read_dataset(inflation)
        factor = np.ones((s.nvars, s.ntimes, s.ny, s.nx), dtype=np.float64)
        for vi, name in enumerate(s.var_names):
            if name in ds.variables:
                factor[vi] = np.broadcast_to(
                    np.asarray(ds[name]), (s.ntimes, s.ny, s.nx)
                )
        return state.replace_data(
            perts * jnp.asarray(factor, dtype=state.data.dtype)[..., None] + mean
        )

    if isinstance(inflation, dict):
        data = state.data
        dim_axis = {"validtime": 1, "y": 2, "lat": 2, "x": 3, "lon": 3}
        for k, v in inflation.items():
            mean = jnp.mean(data, axis=-1, keepdims=True)
            perts = data - mean
            if k in dim_axis:
                if verbose:
                    print(f"Inflating all variables along {k} dimension")
                arr = np.asarray(v, dtype=np.float64)
                axis = dim_axis[k]
                if arr.shape[0] != data.shape[axis]:
                    raise ValidationError(
                        f"inflation along {k} has length {arr.shape[0]}, "
                        f"dimension has {data.shape[axis]}"
                    )
                shape = [1] * 5
                shape[axis] = arr.shape[0]
                factor = jnp.asarray(arr, dtype=data.dtype).reshape(shape)
                data = perts * factor + mean
            else:
                if not isinstance(v, (int, float)) or isinstance(v, bool):
                    raise TypeError(
                        f"Per-variable inflation for {k!r} must be a number, "
                        f"got {type(v).__name__}"
                    )
                v = float(v)
                if k not in s.var_names:
                    print(f"Unable to find variable {k} to inflate.  Skipping...")
                    continue
                if verbose:
                    print(f"Inflating variable {k} by factor: {v:3.2f}")
                vi = s.var_index(k)
                data = data.at[vi].set(perts[vi] * v + mean[vi])
        return state.replace_data(data)

    raise TypeError(f"Unsupported inflation spec: {type(inflation)!r}")


class Assimilation:
    """Base driver: holds prior/obs, computes priors, formats state.

    Reference parity: ``efa_xray/assimilation/assimilation.py:10-171``.
    """

    def __init__(
        self,
        state: EnsembleState,
        obs,
        nproc: int = 1,  # accepted for API parity; parallelism comes from `mesh`
        inflation: InflationSpec = None,
        verbose: bool = False,
        config: Optional[FilterConfig] = None,
        mesh=None,
    ):
        from efa_xray_tpu.utils.logging import verbose_logger
        from efa_xray_tpu.utils.validation import validate_obs, validate_state

        self.log = verbose_logger(verbose)
        self.prior = state
        self._user_obs = obs if isinstance(obs, (list, tuple)) else None
        self.obs = ObservationBatch.coerce(obs)
        validate_state(state)
        validate_obs(self.obs, state.structure)
        self.verbose = verbose
        self.nproc = nproc
        self.inflation = inflation
        self.config = config or FilterConfig(verbose=verbose)
        self.mesh = mesh
        # obs_order="hilbert": assimilate in spatial-locality order (the
        # kernels' culling choice) but keep every caller-visible artifact
        # — diagnostics, writeback, returned batch — in the CALLER's
        # order (record_diagnostics inverts the permutation).
        self._obs_unsort = None
        if self.config.obs_order == "hilbert" and self.obs.nobs > 1:
            self.obs, _order = self.obs.spatial_sort()
            self._obs_unsort = np.argsort(_order)
        self.is_inflated = False
        self._taps = None

    # -- observation priors ------------------------------------------------
    def build_taps(self) -> _fwd.ObsTaps:
        if self._taps is None:
            # Module-level LRU behind this: a cycling workload re-observing
            # the same network each cycle (fresh filter object, same
            # structure + obs coordinates) skips the rebuild entirely.
            cfg = self.config
            self._taps = _fwd.build_taps_cached(
                self.prior.structure,
                self.obs.lats,
                self.obs.lons,
                self.obs.times_s,
                self.obs.var_indices(self.prior.structure),
                npt=cfg.npt,
                exact_match_km=cfg.exact_match_km,
                metric=cfg.nearest_metric,
                time_weighting=cfg.time_weighting,
                topk_method=cfg.taps_topk,
                search=cfg.taps_search,
            )
        return self._taps

    def obs_arrays(self):
        """Device-ready per-ob arrays.  QC-failed obs (e.g. out of the
        state's time range) are masked out of the update, generalizing the
        reference's ``assimilate_this`` gate (``ensrf.py:74-76``).

        All eight per-ob arrays ride ONE host->device transfer (a packed
        ``[8, No]`` float64 matrix split by a single jitted unpack) instead
        of eight separate uploads, on a path that runs on every update
        (``benchmarks/api_anatomy.py``)."""
        from efa_xray_tpu.assimilation import ensrf_core as core

        taps = self.build_taps()
        dtype = jnp.dtype(self.config.dtype)
        radii = np.asarray(self.obs.localize_radius, dtype=np.float64).copy()
        if self.config.default_radius is not None:
            radii[np.isinf(radii)] = float(self.config.default_radius)
        # Interpolation QC (e.g. out-of-time-range) applies only to obs
        # whose ye comes from interpolation; custom-operator obs define
        # their own validity.
        qc = np.asarray(taps.qc_ok) | np.asarray(self.obs.custom_operator)
        assim = np.asarray(self.obs.assimilate_flags) & qc
        # Vertical localization applies only to obs with a finite vertical
        # coordinate; others get an infinite vertical radius (weight 1).
        verts = np.asarray(self.obs.verts, dtype=np.float64).copy()
        vrad = np.asarray(self.obs.vert_radius, dtype=np.float64).copy()
        vrad[~np.isfinite(verts)] = np.inf
        verts[~np.isfinite(verts)] = 0.0
        packed = np.stack([
            np.asarray(self.obs.values, dtype=np.float64),
            np.asarray(self.obs.errors, dtype=np.float64),
            np.asarray(self.obs.lats, dtype=np.float64),
            np.asarray(self.obs.lons, dtype=np.float64),
            radii,
            verts,
            vrad,
            assim.astype(np.float64),
        ])
        vals, errs, lats, lons, rad, vrt, vrd, asm = _unpack_obs(
            jnp.asarray(packed), dtype
        )
        return core.ObsArrays(
            values=vals,
            errors=errs,
            lats=lats,
            lons=lons,
            radii=rad,
            assim=asm,
            verts=vrt,
            vert_radii=vrd,
        )

    def apply_outlier_check(self, oa, tail_mean, tail_perts):
        """Innovation-based gross-error QC (``FilterConfig.outlier_threshold``).

        Rejects observations whose squared innovation exceeds
        ``t^2 * (var(ye) + R)`` under the FORECAST prior (the obs-space
        tail stats computed before any ob of the batch is assimilated —
        DART's ``outlier_threshold`` semantics), AND-ing the rejection
        into the ``assim`` mask so every solver and execution path skips
        them identically.  Rejected obs keep their prior diagnostics
        (the reference's ``assimilate_this`` skip semantics,
        ``efa_xray/assimilation/ensrf.py:74-76``) and are flagged in
        ``ObservationBatch.qc_outlier`` for postprocess/writeback.

        Variance convention follows ``cfg.unbiased_variance`` — the same
        ddof the gain denominator uses — so "t sigmas" means the same
        sigma the filter itself sees.

        ``cfg.outlier_action="inflate"`` assimilates flagged obs anyway
        with R raised to ``innov^2/t^2 - var(ye)`` (adaptive observation
        error inflation, Minamide & Zhang 2017 MWR), putting the
        innovation at exactly t sigma instead of discarding the ob.
        """
        t = self.config.outlier_threshold
        if t is None:
            return oa
        ddof = 1 if self.config.unbiased_variance else 0
        m = tail_perts.shape[1]
        varye = jnp.sum(tail_perts * tail_perts, axis=1) / (m - ddof)
        innov = oa.values - tail_mean
        bad = innov * innov > (t * t) * (varye + oa.errors)
        # Flag only obs that would otherwise have been assimilated.
        flagged = np.asarray(jax.device_get(oa.assim & bad), dtype=bool)
        self.obs.qc_outlier = flagged
        n = int(flagged.sum())
        action = self.config.outlier_action
        if n and self.verbose:
            self.log.info(
                "Outlier check (t=%.2f) %s %d/%d obs",
                t,
                "rejected" if action == "reject" else "R-inflated",
                n,
                len(flagged),
            )
        if action == "inflate":
            # innov^2/t^2 - varye > R exactly where `bad` is True, so the
            # maximum never lowers an error; where ~bad the original R
            # passes through untouched.
            r_infl = jnp.maximum(oa.errors, innov * innov / (t * t) - varye)
            return oa._replace(errors=jnp.where(bad, r_infl, oa.errors))
        return oa._replace(assim=oa.assim & ~bad)

    def _vertical_active(self) -> bool:
        """Vertical localization is on when the state declares per-variable
        vertical coordinates and at least one ob requests a finite vertical
        radius."""
        if self.prior.structure.var_verts is None:
            return False
        vr = np.asarray(self.obs.vert_radius, dtype=np.float64)
        verts = np.asarray(self.obs.verts, dtype=np.float64)
        return bool(np.any(np.isfinite(vr) & np.isfinite(verts)))

    def _host_fastpath(self) -> bool:
        """True when this update should run on the host CPU backend
        (``FilterConfig.small_host``; single device only)."""
        return bool(self.config.small_host) and self.mesh is None

    def _host_fastpath_ctx(self):
        """Context manager placing the update on the host CPU: moves the
        prior to the CPU device and makes it the default for every array
        the update creates (jits follow their inputs there)."""
        import contextlib

        @contextlib.contextmanager
        def ctx():
            cpu = jax.devices("cpu")[0]
            data = self.prior.data
            devs = getattr(data, "devices", None)
            if devs is not None and any(
                d.platform != "cpu" for d in data.devices()
            ):
                self.prior = EnsembleState(
                    jax.device_put(jax.device_get(data), cpu),
                    self.prior.structure,
                )
            with jax.default_device(cpu):
                yield

        return ctx()

    def _matmul_precision_ctx(self):
        """Context manager pinning what an f32 matmul means for everything
        traced inside ``update()`` — XLA einsums and Triton kernel dots
        alike.  On an H100 the JAX default runs f32 products as TF32
        (~1e-3 relative input rounding); ``matmul_precision="highest"``
        runs true f32 products.  ``None`` inherits the ambient setting
        (a no-op context)."""
        import contextlib

        mp = getattr(self.config, "matmul_precision", None)
        if mp is None:
            return contextlib.nullcontext()
        return jax.default_matmul_precision(mp)

    @staticmethod
    def with_matmul_precision(fn):
        """Decorator for solver ``update()`` methods: run the whole update
        (tracing included) under :meth:`_matmul_precision_ctx`.  The
        precision config is part of JAX's trace-cache key, so switching
        it re-traces rather than reusing stale executables."""
        import functools

        @functools.wraps(fn)
        def wrapper(self, *args, **kwargs):
            with self._matmul_precision_ctx():
                return fn(self, *args, **kwargs)

        return wrapper

    def compute_ob_priors(self, state: Optional[EnsembleState] = None):
        """Ensemble obs-space priors: means [No] and perts [No, M]
        (reference: ``assimilation.py:36-49``, vectorized).

        Observations carrying a custom ``forward_operator`` (the pluggable
        H the reference promises at ``observation/observation.py:44-46``)
        get their rows evaluated through that callable; all interpolating
        obs share one vectorized gather.
        """
        state = self.prior if state is None else state
        taps = self.build_taps()
        ye = _fwd.apply_taps_obj(state.to_vect(), taps)  # [No, M]
        custom = self._custom_operators()
        if custom:
            rows = jnp.stack(
                [jnp.asarray(fn(state), dtype=ye.dtype) for _, fn in custom]
            )
            idx = jnp.asarray([i for i, _ in custom])
            ye = ye.at[idx].set(rows)
        means = jnp.mean(ye, axis=1)
        perts = ye - means[:, None]
        return means, perts

    def _custom_operators(self):
        if self._user_obs is None:
            return []
        return [
            (i, ob.forward_operator)
            for i, ob in enumerate(self._user_obs)
            if getattr(ob, "forward_operator", None) is not None
        ]

    def inflate_state(self) -> None:
        if self.is_inflated:
            self.log.warning("State already inflated.  Skipping additional inflation.")
            return
        self.prior = inflate_state(self.prior, self.inflation, verbose=self.verbose)
        self.is_inflated = True

    # -- formatting ----------------------------------------------------------
    def format_prior_state(self):
        """Vectorize, split mean/perts, append obs-space tail.

        Returns ``(body_mean [Ns], body_perts [Ns, M], tail_mean [No],
        tail_perts [No, M])``.  Unlike the reference's single concatenated
        augmented array (``assimilation.py:146-150``), body and tail stay
        separate so the body can be sharded while the tail replicates.
        """
        if self.inflation is not None:
            if self.verbose:
                self.log.info("Inflating Prior State")
            self.inflate_state()
        if self.verbose:
            self.log.info("Computing observation priors")
        dtype = jnp.dtype(self.config.dtype)
        if not self._custom_operators():
            # Fast path: body split + obs priors in one fused dispatch.
            taps = self.build_taps()
            return _format_prior_jit(
                self.prior.data, taps.rows, taps.weights, dtype
            )
        tail_mean, tail_perts = self.compute_ob_priors()
        if self.verbose:
            self.log.info("Converting state to vector")
        prior = self.prior.to_vect()
        body_mean = jnp.mean(prior, axis=1)
        body_perts = prior - body_mean[:, None]
        return (
            body_mean.astype(dtype),
            body_perts.astype(dtype),
            tail_mean.astype(dtype),
            tail_perts.astype(dtype),
        )

    def format_posterior_state(self, body_mean, body_perts):
        """Rebuild an EnsembleState from posterior mean + perts
        (reference: ``assimilation.py:157-171``)."""
        if self.verbose:
            self.log.info("Formatting posterior")
        data = _posterior_jit(
            body_mean,
            body_perts,
            self.prior.structure.shape,
            jnp.dtype(self.prior.data.dtype),
        )
        return EnsembleState(data, self.prior.structure), self.obs

    def varloc_kwargs(self, dtype) -> dict:
        """Cross-variable localization inputs from
        ``FilterConfig.variable_localization`` (empty dict when off):
        the ``[nvars+1, nvars]`` factor matrix (extra row = ones for
        custom-operator obs, whose "observed variable" is undefined),
        the per-row state-variable index (rows are var-major,
        ``ensemble.py:110-114`` order), and the per-ob observed-variable
        index."""
        cfg = self.config
        spec = cfg.variable_localization
        if not spec:
            return {}
        st = self.prior.structure
        names = list(st.var_names)
        nv = len(names)
        fac = np.ones((nv + 1, nv), dtype=np.float64)
        for key, val in spec.items():
            a, b = key.split(":") if isinstance(key, str) else key
            for n in (a, b):
                if n not in names:
                    raise KeyError(
                        f"variable_localization names unknown variable "
                        f"{n!r} (state has {names})")
            fac[names.index(a), names.index(b)] = float(val)
        ob_var = self.obs.var_indices(st).copy()
        custom = np.asarray(self.obs.custom_operator, dtype=bool)
        ob_var[custom] = nv  # the all-ones row: no variable taper
        row_var = np.repeat(np.arange(nv, dtype=np.int32),
                            st.ntimes * st.ngrid)
        import jax.numpy as jnp

        return dict(
            varloc=jnp.asarray(fac, dtype),
            row_var=jnp.asarray(row_var),
            ob_var=jnp.asarray(ob_var),
        )

    def maybe_update_adaptive_inflation(self) -> None:
        """Learn the adaptive-inflation mean field from this batch's
        innovations (Anderson 2009) so the next cycle's prior inflation
        has adapted to the data — the step the reference's
        AdaptiveInflation never implemented (SURVEY.md §2/A8).

        Shared by ALL solvers (EnSRF, LETKF, EnKF) so a cycling workflow
        gets the ``FilterConfig.adaptive_inflation_update`` contract
        regardless of filter choice.  Call after ``record_diagnostics``
        (it consumes the per-ob prior mean/variance recorded there).
        """
        if not self.config.adaptive_inflation_update:
            return
        from efa_xray_tpu.assimilation.adaptive_inflation import (
            AdaptiveInflation,
        )

        if isinstance(self.inflation, AdaptiveInflation):
            b = self.obs
            self.inflation.update_inflation(
                b.lats,
                b.lons,
                b.localize_radius,
                b.values - b.prior_mean,
                b.prior_var,
                b.errors,
                assimilated=b.assimilated,
                lambda_min=self.config.adaptive_min,
                lambda_max=self.config.adaptive_max,
                evolve_sd=self.config.adaptive_sd_evolve,
                sd_min=self.config.adaptive_sd_min,
                damp=self.config.adaptive_damp,
            )

    # -- diagnostics write-back -------------------------------------------
    def record_diagnostics(self, diags) -> None:
        """Record the per-ob diagnostics on the ObservationBatch.

        When the caller passed an ObservationBatch (the production path),
        the result slots receive the DEVICE arrays directly — no host pull
        sits on the update's critical path; any later consumer's
        ``np.asarray``/``float()`` converts (and syncs) on first use, by
        which point the device work has long finished.  When the caller
        passed ``Observation`` objects, the per-ob writeback needs host
        scalars, so one batched ``device_get`` runs eagerly (still a single
        round trip, not five)."""
        writeback = self._user_obs is not None and all(
            isinstance(o, Observation) for o in self._user_obs
        )
        if writeback:
            pm, pv, om, ov, asm = jax.device_get(
                (diags.prior_mean, diags.prior_var, diags.post_mean,
                 diags.post_var, diags.assimilated)
            )
            self.obs.prior_mean = np.asarray(pm, dtype=np.float64)
            self.obs.prior_var = np.asarray(pv, dtype=np.float64)
            self.obs.post_mean = np.asarray(om, dtype=np.float64)
            self.obs.post_var = np.asarray(ov, dtype=np.float64)
            self.obs.assimilated = np.asarray(asm, dtype=bool)
        else:
            self.obs.prior_mean = diags.prior_mean
            self.obs.prior_var = diags.prior_var
            self.obs.post_mean = diags.post_mean
            self.obs.post_var = diags.post_var
            self.obs.assimilated = diags.assimilated
        if self._obs_unsort is not None:
            # obs_order="hilbert": back to the caller's order.  take()
            # keeps device diag slots as device gathers — no host sync
            # lands on the update's critical path.
            self.obs = self.obs.take(self._obs_unsort)
        if writeback:
            self.obs.writeback(self._user_obs)


def update(
    prior_state: EnsembleState,
    obs,
    inflate: InflationSpec = None,
    loc=False,
    nproc: int = 1,
    verbose: bool = False,
    mesh=None,
    config: Optional[FilterConfig] = None,
    solver: str = "ensrf",
) -> Tuple[EnsembleState, ObservationBatch]:
    """One-call update (working replacement for the reference's dead
    multiprocessing driver, ``assimilation.py:176-230``).

    ``mesh``: optional ``jax.sharding.Mesh``; when given, the state body is
    sharded across devices (the modern form of the reference's intended
    state-chunk fan-out).  ``nproc`` is accepted for signature parity and
    ignored.  ``solver``: ``"ensrf"`` (reference algorithm, default),
    ``"letkf"`` or ``"enkf"`` — same contract, see the solver classes.
    """
    from efa_xray_tpu.assimilation.enkf import EnKF
    from efa_xray_tpu.assimilation.ensrf import EnSRF
    from efa_xray_tpu.assimilation.letkf import LETKF

    try:
        cls = {"ensrf": EnSRF, "letkf": LETKF, "enkf": EnKF}[solver]
    except KeyError:
        raise ValueError(f"unknown solver {solver!r}") from None
    if config is None:
        config = FilterConfig(
            localization="GC" if loc not in (None, False) else None,
            verbose=verbose,
        )
    kwargs = dict(
        inflation=inflate, verbose=verbose, loc=loc, config=config, mesh=mesh
    )
    if cls is EnSRF:
        kwargs["nproc"] = nproc  # signature parity with the reference
    filt = cls(prior_state, obs, **kwargs)
    return filt.update()
