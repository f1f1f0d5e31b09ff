"""EnSRF: the user-facing serial ensemble square-root filter.

Drop-in capability match for the reference class
(``efa_xray/assimilation/ensrf.py:8-151``): construct with a prior
EnsembleState, observations, inflation and localization options; call
``.update()`` to get ``(posterior_state, observations)`` with per-ob
diagnostics recorded.

The per-observation Python loop becomes either a ``lax.scan``
(``method="serial"``) or the exact blocked two-phase algorithm
(``method="blocked"``, default — see
:mod:`efa_xray_tpu.assimilation.ensrf_core`), optionally sharded over a
``jax.sharding.Mesh`` along the state dimension
(:mod:`efa_xray_tpu.parallel.sharded`).  Which implementation runs each
phase (XLA or the Triton kernels) is decided in one place,
:func:`efa_xray_tpu.ops.select.choose`.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from efa_xray_tpu.assimilation import ensrf_core as core
from efa_xray_tpu.assimilation.assimilation import Assimilation
from efa_xray_tpu.config import FilterConfig
from efa_xray_tpu.observation.observation import ObservationBatch
from efa_xray_tpu.state.ensemble import EnsembleState


@functools.partial(jax.jit, static_argnames=("chunk",))
def _slice_chunk(tail, obs_p, start, chunk: int):
    """One compiled slicer serves every chunk of every update: the start
    index is traced, only the chunk width is static (module-level so the
    jit cache persists across filter instances/cycles)."""
    sl = lambda a: jax.lax.dynamic_slice_in_dim(a, start, chunk, 0)
    return jax.tree.map(sl, tail), jax.tree.map(sl, obs_p)


class EnSRF(Assimilation):
    def __init__(
        self,
        state: EnsembleState,
        obs,
        nproc: int = 1,
        inflation=None,
        verbose: bool = True,
        loc=False,
        config: Optional[FilterConfig] = None,
        mesh=None,
    ):
        if config is None:
            config = FilterConfig(
                localization="GC" if loc not in (None, False) else None,
                verbose=verbose,
            )
        super().__init__(
            state,
            obs,
            nproc=nproc,
            inflation=inflation,
            verbose=verbose,
            config=config,
            mesh=mesh,
        )
        self.loc = loc if loc not in (None, False) else (config.localization or False)

    # Run the Triton kernels in the Pallas interpreter.  Only tests set
    # this (there is no GPU to compile them for on a CPU host).
    interpret: bool = False

    def _kernels(self):
        from efa_xray_tpu.ops import select

        return select.choose(self.config, interpret=self.interpret)

    def _hybrid_kwargs(self, body_mean, dtype):
        """Static-B inputs for ``hybrid_alpha < 1``: per-row sigma and its
        interpolation to ob locations with the same forward-operator taps
        as the state (generalizes the reference's pure-ensemble gain,
        ``efa_xray/assimilation/ensrf.py:95,119``)."""
        cfg = self.config
        if cfg.hybrid_alpha >= 1.0:
            return {}
        from efa_xray_tpu.observation import forward as _fwd

        bsig = jnp.broadcast_to(
            jnp.asarray(cfg.static_b_sigma, dtype), body_mean.shape
        )
        taps = self.build_taps()
        tsig = _fwd.apply_taps_obj(bsig[:, None], taps)[:, 0]
        return dict(
            hybrid_alpha=float(cfg.hybrid_alpha),
            body_sigma=bsig,
            tail_sigma=tsig,
            static_length=float(cfg.static_b_length),
        )

    @Assimilation.with_matmul_precision
    def update(self) -> Tuple[EnsembleState, ObservationBatch]:
        """Assimilate all observations; return (posterior, observations).

        Reference flow parity: ``efa_xray/assimilation/ensrf.py:33-151``.
        ``FilterConfig.small_host`` routes the update to the host CPU
        backend (:meth:`Assimilation._host_fastpath`): same algorithm,
        same results up to backend fp differences.
        """
        if self._host_fastpath():
            with self._host_fastpath_ctx():
                return self._update_impl()
        return self._update_impl()

    def _update_impl(self) -> Tuple[EnsembleState, ObservationBatch]:
        cfg = self.config
        if self.verbose:
            self.log.info("Beginning update sequence")
        body_mean, body_perts, tail_mean, tail_perts = self.format_prior_state()
        obs = self.obs_arrays()
        obs = self.apply_outlier_check(obs, tail_mean, tail_perts)

        dtype = jnp.dtype(cfg.dtype)
        # Structure-cached device coordinates: no per-update host tile +
        # re-upload of 2 x nstate floats (see row_latlon_device).
        body_lat, body_lon = self.prior.structure.row_latlon_device(dtype)
        vertical = cfg.localize and self._vertical_active()
        if vertical:
            body_vert = jnp.asarray(self.prior.structure.row_vert(), dtype=dtype)
        else:
            body_vert = jnp.zeros_like(body_lat)

        if self.verbose:
            self.log.info("Beginning observation loop (%s)", cfg.method)

        # Background spread per row, captured BEFORE the update so RTPS
        # survives buffer donation of the prior perturbations.
        prior_spread = None
        if cfg.rtps_alpha > 0.0:
            from efa_xray_tpu.assimilation.adaptive_inflation import row_spread

            prior_spread = row_spread(body_perts)
        prior_perts_saved = None
        if cfg.rtpp_alpha > 0.0:
            # RTPP blends member-wise with the prior perturbations, so they
            # must survive the update; the mesh and body-kernel paths
            # donate the prior buffers, so keep an explicit copy there.
            donating = self.mesh is not None or self._kernels().body
            prior_perts_saved = (
                jnp.array(body_perts, copy=True) if donating else body_perts
            )

        hybrid_kwargs = self._hybrid_kwargs(body_mean, dtype)
        vl_kwargs = self.varloc_kwargs(dtype)
        obs_chunk = cfg.obs_chunk
        if obs_chunk is None:
            # Auto: chunk huge batches (see FilterConfig.obs_chunk) unless
            # an incompatible option forces one-shot.
            obs_chunk = (
                65536
                if (
                    int(obs.values.shape[0]) > 131072
                    and not hybrid_kwargs
                    and not vl_kwargs
                )
                else 0
            )
        if (
            self.mesh is None
            and obs_chunk
            and int(obs.values.shape[0]) > int(obs_chunk)
        ):
            if hybrid_kwargs or vl_kwargs:
                raise ValueError(
                    "obs_chunk does not combine with hybrid covariance or "
                    "variable localization (the chunked body sweep carries "
                    "no per-row static/var inputs)"
                )
            bm, bp, tm, tp, diags = self._solve_obs_chunked(
                body_mean, body_perts, tail_mean, tail_perts,
                body_lat, body_lon, obs, body_vert, vertical, dtype,
                int(obs_chunk),
            )
        elif self.mesh is not None:
            # The sharded driver has no chunked mode: a huge batch runs
            # one-shot shapes beyond the envelope the single-device
            # driver chunks at.  Refuse loudly rather than run them
            # silently; obs_chunk=0 is the explicit opt-in.
            nobs_mesh = int(obs.values.shape[0])
            if cfg.obs_chunk is not None and cfg.obs_chunk > 0:
                raise ValueError(
                    "obs_chunk is a single-device driver; it does not "
                    "combine with mesh=. Pre-split the batch into "
                    "sequential EnSRF.update() calls, or pass obs_chunk=0 "
                    "to force the one-shot sharded update."
                )
            if cfg.obs_chunk is None and nobs_mesh > 131072:
                raise ValueError(
                    f"{nobs_mesh} obs in one sharded update exceeds the "
                    "131072-ob one-shot envelope (the single-device "
                    "driver chunks beyond it). Split the batch into sequential "
                    "EnSRF.update() calls of <= 131072 obs (exact: the "
                    "serial filter composes), or pass obs_chunk=0 to "
                    "force the one-shot shapes anyway."
                )
            from efa_xray_tpu.parallel import sharded

            bm, bp, tm, tp, diags = sharded.ensrf_update_sharded(
                body_mean,
                body_perts,
                tail_mean,
                tail_perts,
                body_lat,
                body_lon,
                obs,
                mesh=self.mesh,
                localize=cfg.localize,
                method=cfg.method,
                block_size=cfg.block_size,
                unbiased=cfg.unbiased_variance,
                fast_geometry=cfg.fast_geometry,
                body_vert=body_vert,
                vertical=vertical,
                kernels=self._kernels(),
                tail_panel=cfg.tail_panel,
                cull=cfg.cull,
                spatial_sort=cfg.spatial_sort,
                # EnSRF owns the formatted prior: let the posterior shards
                # reuse its HBM.
                donate=True,
                **hybrid_kwargs,
                **vl_kwargs,
            )
        else:
            bm, bp, tm, tp, diags = self._solve_once(
                body_mean, body_perts, tail_mean, tail_perts,
                body_lat, body_lon, obs, body_vert, vertical, dtype,
                hybrid_kwargs, vl_kwargs,
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

    def _solve_once(
        self,
        body_mean,
        body_perts,
        tail_mean,
        tail_perts,
        body_lat,
        body_lon,
        obs,
        body_vert,
        vertical: bool,
        dtype,
        hybrid_kwargs: dict,
        vl_kwargs: dict,
    ):
        """One full single-device update (tail + body) through the
        configured solver path; returns ``(bm, bp, tm, tp, diags)``."""
        cfg = self.config
        if cfg.method == "serial":
            return core.ensrf_serial(
                body_mean,
                body_perts,
                tail_mean,
                tail_perts,
                body_lat,
                body_lon,
                obs,
                localize=cfg.localize,
                unbiased=cfg.unbiased_variance,
                fast_geometry=cfg.fast_geometry,
                body_vert=body_vert,
                vertical=vertical,
                **hybrid_kwargs,
                **vl_kwargs,
            )
        k = self._kernels()
        tail = core.tail_scan_blocked(
            tail_mean,
            tail_perts,
            obs,
            localize=cfg.localize,
            unbiased=cfg.unbiased_variance,
            fast_geometry=cfg.fast_geometry,
            vertical=vertical,
            panel=cfg.tail_panel,
            kernels=k.tail,
            interpret=k.interpret,
            **{n: v for n, v in hybrid_kwargs.items() if n != "body_sigma"},
            **{n: v for n, v in vl_kwargs.items() if n != "row_var"},
        )
        bm, bp = self._body_apply(
            body_mean, body_perts, body_lat, body_lon, tail, obs,
            body_vert, vertical, hybrid_kwargs, vl_kwargs,
        )
        return bm, bp, tail.tail_mean, tail.tail_perts, tail.diags

    def _solve_obs_chunked(
        self,
        body_mean,
        body_perts,
        tail_mean,
        tail_perts,
        body_lat,
        body_lon,
        obs,
        body_vert,
        vertical: bool,
        dtype,
        chunk: int,
    ):
        """Process the observation batch exactly with bounded per-call
        shapes: phase 1 (the obs-space serial solve) runs ONCE over the
        full batch — its shapes are already panel-bounded internally —
        and phase 2 (the body sweep) applies the pre-solved sequence in
        fixed ``chunk``-ob slices, each reusing ONE compiled shape with
        the state carry donated along the chain.

        Algebraically identical to the one-shot update: the body sweep is
        a per-ob sequence of row-local ops on precomputed tail
        quantities, so partitioning it at chunk boundaries only
        reassociates fp — the serial filter's augmented-state invariant
        (``efa_xray/assimilation/assimilation.py:146-150``)."""
        cfg = self.config
        nobs = int(obs.values.shape[0])
        nchunks = -(-nobs // chunk)
        pad = nchunks * chunk - nobs
        obs = obs.with_default_verts()

        def pad1(x, fill=0.0):
            if x.dtype == jnp.bool_:
                return jnp.pad(x, (0, pad))
            return jnp.pad(x.astype(dtype), (0, pad), constant_values=fill)

        obs_p = core.ObsArrays(
            values=pad1(obs.values),
            errors=pad1(obs.errors, 1.0),
            lats=pad1(obs.lats),
            lons=pad1(obs.lons),
            radii=pad1(obs.radii, jnp.inf),
            assim=jnp.pad(obs.assim, (0, pad)),  # padded obs are no-ops
            verts=pad1(obs.verts),
            vert_radii=pad1(obs.vert_radii, jnp.inf),
        )
        tm_p = jnp.pad(tail_mean.astype(dtype), (0, pad))
        tp_p = jnp.pad(tail_perts.astype(dtype), ((0, pad), (0, 0)))

        k = self._kernels()
        tail = core.tail_scan_blocked(
            tm_p, tp_p, obs_p,
            localize=cfg.localize,
            unbiased=cfg.unbiased_variance,
            fast_geometry=cfg.fast_geometry,
            vertical=vertical,
            panel=cfg.tail_panel,
            kernels=k.tail,
            interpret=k.interpret,
        )

        bm, bp = body_mean, body_perts
        for i in range(nchunks):
            tail_i, obs_i = _slice_chunk(tail, obs_p, i * chunk, chunk)
            bm, bp = self._body_apply(
                bm, bp, body_lat, body_lon, tail_i, obs_i,
                body_vert, vertical, {}, {},
            )

        cut = lambda a: a[:nobs]
        return (bm, bp, cut(tail.tail_mean), cut(tail.tail_perts),
                jax.tree.map(cut, tail.diags))

    def _body_apply(self, bm, bp, body_lat, body_lon, tail, obs,
                    body_vert, vertical: bool, hybrid_kwargs: dict,
                    vl_kwargs: dict):
        """Phase 2: apply a pre-solved observation sequence
        (TailSolution) to the state body through the selected kernel
        family."""
        cfg = self.config
        k = self._kernels()
        hybrid = bool(hybrid_kwargs)
        if k.body:
            from efa_xray_tpu.ops.ensrf_triton import body_update_donating

            row_order = inv_order = None
            if cfg.spatial_sort:
                row_order, inv_order = (
                    self.prior.structure.spatial_order_device())
            # Donating: EnSRF owns the formatted prior and never touches
            # it again, so the kernel updates the state in place.
            return body_update_donating(
                bm, bp, body_lat, body_lon, tail, obs,
                localize=cfg.localize,
                geometry="chordal" if cfg.fast_geometry else "haversine",
                body_vert=body_vert if vertical else None,
                vertical=vertical,
                cull=cfg.cull,
                spatial_sort=cfg.spatial_sort,
                row_order=row_order,
                inv_order=inv_order,
                hybrid=hybrid,
                body_sigma=hybrid_kwargs.get("body_sigma"),
                static_length=hybrid_kwargs.get("static_length"),
                interpret=k.interpret,
                **vl_kwargs,
            )
        return core.ensrf_blocked_body(
            bm, bp, body_lat, body_lon, tail, obs,
            localize=cfg.localize,
            block_size=cfg.block_size,
            fast_geometry=cfg.fast_geometry,
            body_vert=body_vert,
            vertical=vertical,
            hybrid=hybrid,
            body_sigma=hybrid_kwargs.get("body_sigma"),
            static_length=hybrid_kwargs.get("static_length"),
            **vl_kwargs,
        )
