"""Typed configuration for the filter.

The reference configures everything through loose kwargs and a polymorphic
``inflation`` argument (``efa_xray/assimilation/ensrf.py:28``,
``efa_xray/assimilation/assimilation.py:15-25``); per-ob knobs ride on the
Observation objects.  Here the run-level knobs live in one dataclass, while
per-ob overrides (``localize_radius``, ``assimilate_this``) remain arrays on
the :class:`~efa_xray_tpu.observation.observation.ObservationBatch`.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Union

# Fields of older versions that configs on disk may still carry: knobs of
# kernels this version no longer has, and the host fast path's auto rule.
_REMOVED_FIELDS = frozenset({"pallas_tile", "mxu_bf16", "small_host_threshold"})


@dataclasses.dataclass
class FilterConfig:
    # Covariance localization: "GC" (Gaspari-Cohn) or None/False for off
    # (reference ``loc`` kwarg, ensrf.py:28,99).
    localization: Optional[str] = "GC"
    # Default GC halfwidth (km) for obs without a per-ob radius; None means
    # such obs are not localized (weights = 1).
    default_radius: Optional[float] = None
    # Execution strategy: "blocked" (two-phase, matrix products, default) or
    # "serial" (direct lax.scan, the literal reference algorithm).
    method: str = "blocked"
    # Observations applied to the state body per phase-2 block by the XLA
    # body (the Triton body kernel has its own, ops/ensrf_triton.BLOCK_OBS).
    block_size: int = 128
    # Panel size for the hierarchical phase-1 tail solve
    # (ensrf_core.tail_scan_blocked): each panel's serial recurrence runs
    # on its own [panel, M] rows, then one blocked apply updates the rest
    # of the tail.  Identical results up to fp reassociation.  64 was the
    # fastest panel for the tail kernels on an H100 at the headline shape
    # (10k obs x 80 members; 128 within 7%).
    tail_panel: int = 64
    # Run the blocked tail through the Triton kernels: each panel's serial
    # recurrence as one launch with the [panel, M] slab in registers
    # (ops/tail_solve_triton) and the panel apply through the body kernel
    # (ops/ensrf_triton).  True / False / None (auto: with the body
    # kernel, i.e. blocked float32 updates on a CUDA GPU; see
    # ops/select.py).  Not available with hybrid covariance.
    tail_pallas: Optional[bool] = None
    # Forward-operator knobs (reference: efa_xray/state/ensemble.py:170-239).
    npt: int = 4
    exact_match_km: float = 1.0
    nearest_metric: str = "haversine"  # or "reference_proxy"
    # Nearest-point candidate selection in build_taps: "exact"
    # (lax.top_k) or "approx" (lax.approx_max_k at recall 0.99 over a
    # ~4*npt candidate set that is then exactly rescored — see
    # observation/forward.py:_topk_points_mapped).  The full-width top-k
    # dominates the forward-operator device build cost; approx is the
    # opt-out from the formal exactness guarantee.  Only applies to the
    # default "haversine" nearest_metric (the "reference_proxy" metric
    # reproduces the reference's scoring verbatim and stays exact).
    taps_topk: str = "exact"
    # Nearest-point search strategy: "auto" (default) detects separable
    # lat x lon product grids and resolves the search as exact host-side
    # index arithmetic with a per-ob exactness certificate — no device
    # launch at all (observation/forward.py:_nearest_separable);
    # "device" forces the full device search (the taps_topk path) even on
    # separable grids.  Selected points (and hence ye) are identical
    # either way, with one measure-zero caveat: among grid points at
    # EXACTLY equal distance from an ob, the host paths break ties by
    # lowest flat grid index (so "auto", its full-search fallback, and
    # the single-stage device top_k all agree), while the two-stage
    # chordal device search resolves such ties by its own fp rounding —
    # an ob exactly midway between grid points may select a different
    # (equally correct, equidistant) point there.
    taps_search: str = "auto"
    time_weighting: str = "linear"  # or "reference" (reproduces swapped weights)
    # Device dtype for the update ("float32" on the GPU; "float64" for
    # parity studies with jax_enable_x64).
    dtype: str = "float32"
    # Triton body kernel for the blocked state update (ops/ensrf_triton:
    # one program per row tile keeps its [tile, M] state in registers
    # across all obs blocks, so the state crosses device memory once).
    # True / False / None (auto: on for blocked float32 updates on a
    # CUDA GPU, where it beat the XLA body end to end; XLA elsewhere —
    # see ops/select.py).  Covers flat and gridded states, both
    # geometries, vertical and cross-variable localization, and hybrid
    # covariance.
    use_pallas: Optional[bool] = None
    # Run the whole update on the host CPU backend (EnSRF, EnKF, LETKF;
    # single device only).  The posterior lands on the CPU device, so a
    # cycling loop at demo scale stays host-local.
    small_host: bool = False
    # Process the observation batch in sequential chunks of this many obs
    # (EnSRF, single-device only).  Exact up to fp reassociation: the
    # tail solve runs once over the whole batch, and the body sweep
    # applies it chunk by chunk, every chunk compiled to the SAME shapes
    # (one compile for any batch size).  None = AUTO: batches over
    # 131072 obs run in 65536-ob chunks, which bounds the one-shot
    # shapes.  0 disables chunking entirely.  One-shot (with a raise on
    # explicit chunking) with hybrid covariance, variable localization,
    # or a mesh; mesh batches over 131072 obs refuse unless obs_chunk=0
    # explicitly opts into the one-shot shapes.
    obs_chunk: Optional[int] = None
    # Assimilation-order policy for the observation batch.  None =
    # caller's order (reference parity: the localized serial analysis is
    # weakly order-dependent, so the framework never silently reorders).
    # "hilbert" = assimilate in spherical-Hilbert spatial-locality order
    # and return diagnostics/writeback in the CALLER's order: spatially
    # compact obs blocks are what lets the body kernel's localization
    # culling engage (docs/recipes.md).  Equivalent to the caller
    # pre-sorting with
    # ``ObservationBatch.spatial_sort()`` (the reference demo shuffles
    # its obs order, ``efa_demo.ipynb`` cell 11 — order is a free
    # choice).
    obs_order: Optional[str] = None
    # What an f32 matmul means for this filter's traces.  Applied as a
    # ``jax.default_matmul_precision`` context around every solver trace,
    # so it governs the XLA einsums AND the Triton kernels' dots alike.
    # On an H100, "default" runs f32 products on the tensor cores as
    # TF32 (10-bit mantissa inputs, ~1e-3 relative input rounding, f32
    # accumulation); "highest" runs true f32 products for
    # accuracy-pinned reruns.  None = inherit the ambient JAX setting.
    # Other accepted values: "high", "bfloat16", "tensorfloat32",
    # "float32" (= "highest").
    matmul_precision: Optional[str] = None
    # Fast chordal geometry for localization weights (unit-vector dot +
    # polynomial arccos; ~2e-8 rad error) instead of the exact haversine.
    # Off by default to keep bit-level reference parity.
    fast_geometry: bool = False
    # Localization culling in the body kernel: skip (row-tile,
    # obs-block) pairs whose Gaspari-Cohn weights are provably all zero.
    # EXACT (the skipped work is multiplication by zero); on by default.
    cull: bool = True
    # Permute state rows into spherical Morton order around the body
    # kernel (exact — the update is row-local; the inverse permutation is
    # applied on the way out) so row tiles cover compact caps and culling
    # bites.  Pays off when the observation ORDER is also spatially
    # coherent; obs order is part of the serial algorithm's definition, so
    # sorting obs is left to the caller (see
    # observation.localization.spatial_sort_order and
    # observation.thinning.sort_spatially).
    spatial_sort: bool = False
    # False reproduces the reference's np.var (ddof=0) in the gain
    # denominator against a ddof=1 covariance (ensrf.py:69,95) — weakly
    # observation-order dependent.  True uses ddof=1 throughout (textbook
    # Whitaker-Hamill; analysis mean exactly order-invariant when
    # unlocalized).
    unbiased_variance: bool = False
    # --- LETKF solver knobs (efa_xray_tpu.assimilation.letkf; an extension
    # beyond the reference, which has only the serial EnSRF) ---
    # Grid points per local patch sharing one ensemble-space solve (weights
    # at the patch centroid).  1 = textbook per-point LETKF (exact).
    letkf_patch_size: int = 1
    # Max observations entering each local solve (nearest-k truncation;
    # only binds when a localization footprint holds more than k obs).
    letkf_k_obs: int = 64
    # Batched SPD inverse-sqrt backend: "newton_schulz" (pure matmuls)
    # or "eigh" (exact reference backend).
    letkf_sqrt: str = "newton_schulz"
    # Newton-Schulz iteration count (quadratically convergent once the
    # linear phase ~log2(cond) is past; 30 covers cond ~ 1e4 in f32).
    letkf_ns_iters: int = 30
    # Patches solved per lax.map step (bounds the [chunk, k, M] gather).
    letkf_chunk: int = 512
    # Nearest-k obs selection primitive: "exact" (lax.top_k over all
    # obs), "approx" (lax.approx_max_k, recall >= 0.95 per patch — a
    # missed far-edge ob carries a near-zero GC weight by construction),
    # or "host" (EXACT: a host kd-tree emits certified per-patch-group
    # candidate sets — ball(centroid, r_k + 2*group_radius) provably
    # covers every member patch's true top-k — and the device rescopes
    # its HIGHEST-precision dots + top_k to the S << No candidates;
    # cached per (structure, obs network) like forward-operator taps, so
    # cycling re-pays nothing.  Horizontal-only localization).
    letkf_topk: str = "exact"
    # Matmul precision of the LETKF's ensemble-SPACE solve chain (the
    # C = Y^T diag(rho/R) Y build, the Newton-Schulz inverse-sqrt
    # iterations, and the wbar solve) — NOT the big state-apply einsums,
    # which stay at the ambient/default precision.  Reduced-precision
    # dot inputs stall the Newton-Schulz iteration at a floor set by the
    # input rounding; "highest" converges it to f32.  "high" = 3-pass
    # middle ground.  Applies only to the tiny [C, M, M] solve operands.
    letkf_solve_precision: str = "default"
    # --- Hybrid ensemble-static background covariance (Hamill & Snyder
    # 2000).  hybrid_alpha = 1 is the pure ensemble filter (reference
    # parity); 0 is classic Optimal Interpolation with a Gaspari-Cohn
    # covariance model.  The static part is
    # sigma_s(x) sigma_s(y) GC(d, static_b_length), held fixed over the
    # batch (standard hybrid-gain simplification).  Supported on the
    # serial scan AND the blocked two-phase path (the static column rides
    # the same block recurrence, in the XLA body and the body kernel),
    # with or without a mesh; the tail kernels skip it (a hybrid tail
    # runs the XLA panel scan).
    hybrid_alpha: float = 1.0
    # Static background std: scalar, or per-state-row array of nstate.
    static_b_sigma: Union[float, object, None] = None
    # GC halfwidth (km) of the static covariance model.
    static_b_length: Optional[float] = None
    # Relaxation-to-prior-spread posterior inflation (Whitaker & Hamill
    # 2012): after the analysis, each row's posterior spread relaxes toward
    # the background spread by this fraction.  0 = off (reference parity);
    # 1 = restore prior spread exactly.  Applies to both solvers.
    rtps_alpha: float = 0.0
    # Relaxation-to-prior-perturbations posterior inflation (Zhang, Snyder
    # & Sun 2004): posterior perturbations blend member-wise with the prior
    # ones, X_a' = (1-a) X_a + a X_b.  0 = off (reference parity); 1 =
    # restore prior perturbations exactly.  Mutually exclusive with
    # rtps_alpha (operationally one relaxation scheme is chosen, and
    # composing them has no established semantics).  Note: RTPP keeps a
    # copy of the prior perturbation matrix alive through the update, so
    # on the buffer-donating paths peak HBM gains one [Nstate, Nmems]
    # buffer.  Applies to all solvers.
    rtpp_alpha: float = 0.0
    # When ``inflation`` is an AdaptiveInflation instance, Bayesian-update
    # its mean field from this batch's innovations after the analysis
    # (Anderson 2009) so the next cycle's prior inflation has learned from
    # the data.  The reference's AdaptiveInflation never implemented this
    # step (SURVEY.md §2/A8).
    adaptive_inflation_update: bool = True
    # Evolve the inflation std alongside the mean (Anderson 2009 §4
    # posterior-density refit, floored at ``adaptive_sd_min``): the
    # principled self-damping that removes the need for a hand-tuned fixed
    # sd.  Off = historical fixed-sd behavior (the reference stores the
    # std moment field but never updates it, adaptive_inflation.py:42-56).
    adaptive_sd_evolve: bool = False
    adaptive_sd_min: float = 0.05
    # Per-update relaxation of the learned inflation mean toward 1
    # (DART's inflation damping): lambda <- 1 + damp * (lambda - 1) after
    # each Anderson update.  1.0 = off.  Residual observation bias or
    # model error makes innovations SYSTEMATICALLY exceed the expected
    # variance, so an undamped field ratchets upward wherever the data
    # disagree for non-dispersion reasons — measured: the production
    # cycled benchmark's inflation ran away and blew the L96-2d forecast
    # off the attractor (NaN by cycle 2) until damped.  The
    # evolved std (adaptive_sd_evolve) shrinks the UPDATE SIZE, not the
    # accumulated level, so it does not substitute for damping.
    adaptive_damp: float = 1.0
    # Bounds on the learned inflation mean field (DART's
    # inf_lower_bound / inf_upper_bound).  Damping alone cannot contain
    # the sparse-obs runaway: a point whose own dispersion is never
    # tested by a nearby ob (gamma << 1 for every ob) integrates the
    # whole network's excess innovations MULTIPLICATIVELY — measured on
    # the gridded production benchmark, the field max doubled per cycle
    # (x2 growth vs x0.9 damping) until the inflated spread threw the
    # analysis off the model attractor.  Production cycling should set
    # adaptive_max to a few (spread multiplier sqrt(adaptive_max)).
    adaptive_min: float = 1.0
    adaptive_max: float = 1e6
    # Innovation-based gross-error QC ("background check" / first-guess
    # check; DART's ``outlier_threshold``, GSI's gross check — standard
    # operational-DA QC the reference never had: its only gate is the
    # user-set ``assimilate_this``, efa_xray/assimilation/ensrf.py:74-76).
    # When set to ``t``, an observation is rejected — not assimilated,
    # prior stats still recorded, flagged in
    # ``ObservationBatch.qc_outlier`` — when its squared innovation
    # exceeds ``t**2`` times the expected innovation variance under the
    # prior: ``(y - mean(ye))^2 > t^2 * (var(ye) + R)``.  The test uses
    # the FORECAST prior ye statistics (before any ob of the batch is
    # assimilated), matching DART's definition, so the mask is identical
    # across serial/blocked/Pallas/mesh paths and all three solvers.
    # Typical operational values: 3-4.  None = off (reference parity).
    outlier_threshold: Optional[float] = None
    # What to do with a flagged outlier: "reject" (DART semantics — the ob
    # is skipped entirely) or "inflate" (adaptive observation error
    # inflation, Minamide & Zhang 2017 MWR: R is raised to exactly
    # ``innov^2 / t^2 - var(ye)`` so the innovation sits at t sigma and
    # the ob is still assimilated with proportionally weakened impact —
    # the all-sky-radiance treatment where rejecting every cloud-affected
    # ob would discard the most informative data).  Flagged obs are
    # recorded in ``qc_outlier`` either way; the batch keeps the ORIGINAL
    # measurement R (the inflation is an assimilation-time treatment, not
    # a revised error estimate).
    outlier_action: str = "reject"
    # --- Cross-variable localization (DART-style "variable localization";
    # an extension — the reference localizes spatially only,
    # efa_xray/assimilation/ensrf.py:99-115).  Dict mapping
    # (observed_var, state_var) pairs — tuple keys or "OBSVAR:STATEVAR"
    # strings — to multiplicative gain factors >= 0 (unlisted pairs
    # default to 1.0).  0 blocks the update entirely: e.g.
    # {"T2m:PS": 0.0} stops temperature obs from ever touching surface
    # pressure through spurious sample covariances.  The factor enters
    # the gain exactly like a Gaspari-Cohn weight (per (row, ob)), works
    # with or without spatial localization, and composes with vertical
    # localization.  EnSRF + EnKF, serial and blocked methods, single
    # device or mesh (row factors shard with the rows — zero
    # collectives).  The body and tail kernels gather the factor per
    # (row, ob) from the small table.  The LETKF applies the factor
    # to rho (the R-localization analog), at the cost of per-(group,
    # patch) solves — the same VT-fold layout vertical localization uses
    # — and requires letkf_topk "exact"/"approx" and spatial
    # localization on.  Not combinable with hybrid covariance (the
    # static column would be untapered).
    variable_localization: Optional[dict] = None
    verbose: bool = False

    @property
    def localize(self) -> bool:
        return self.localization not in (None, False)

    # -- persistence (reproducible-run config files; the reference has no
    # config system at all — loose kwargs, SURVEY.md §5.6) ----------------
    def to_dict(self, full: bool = False) -> dict:
        """JSON-ready dict.  ``full=False`` (default) keeps only fields
        that differ from the dataclass defaults, so saved configs stay
        readable and forward-compatible (new knobs keep their defaults on
        load).  Non-JSON values are converted: array ``static_b_sigma``
        becomes a list, tuple ``variable_localization`` keys become
        ``"OBSVAR:STATEVAR"`` strings."""
        out = {}
        for f in dataclasses.fields(self):
            val = getattr(self, f.name)
            if not full:
                try:
                    is_default = val is f.default or (
                        type(val) is type(f.default) and val == f.default
                    )
                except Exception:
                    is_default = False
                if is_default:
                    continue
            if f.name == "static_b_sigma" and val is not None and not isinstance(
                val, (int, float)
            ):
                import numpy as _np

                val = _np.asarray(val, dtype=float).tolist()
            if f.name == "variable_localization" and isinstance(val, dict):
                val = {
                    (k if isinstance(k, str) else f"{k[0]}:{k[1]}"): float(v)
                    for k, v in val.items()
                }
            out[f.name] = val
        return out

    def save(self, path: str) -> None:
        """Write the config as JSON (only non-default fields)."""
        import json

        with open(path, "w") as fh:
            json.dump(self.to_dict(), fh, indent=2, sort_keys=True)
            fh.write("\n")

    @classmethod
    def load(cls, path: str, **overrides) -> "FilterConfig":
        """Read a JSON config written by :meth:`save` (or by hand).
        Fields that older versions had and this one dropped are ignored
        with a warning; other unknown keys raise (typo safety).
        ``overrides`` are applied on top.  Validation runs through the
        normal constructor."""
        import json
        import warnings

        with open(path) as fh:
            data = json.load(fh)
        if not isinstance(data, dict):
            raise ValueError(f"{path}: expected a JSON object")
        dropped = sorted(set(data) & _REMOVED_FIELDS)
        if dropped:
            warnings.warn(
                f"{path}: ignoring removed FilterConfig field(s): "
                f"{', '.join(dropped)}", stacklevel=2)
            for k in dropped:
                del data[k]
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = sorted(set(data) - known)
        if unknown:
            raise ValueError(
                f"{path}: unknown FilterConfig field(s): {', '.join(unknown)}"
            )
        data.update(overrides)
        return cls(**data)

    def __post_init__(self):
        if self.localization not in (None, False, "GC"):
            raise ValueError(f"Unknown localization {self.localization!r}")
        if self.method not in ("blocked", "serial"):
            raise ValueError(f"Unknown method {self.method!r}")
        if self.block_size < 1:
            raise ValueError("block_size must be >= 1")
        if self.letkf_sqrt not in ("newton_schulz", "eigh"):
            raise ValueError(f"Unknown letkf_sqrt {self.letkf_sqrt!r}")
        if self.letkf_topk not in ("exact", "approx", "host"):
            raise ValueError(f"Unknown letkf_topk {self.letkf_topk!r}")
        if self.obs_order not in (None, "hilbert"):
            raise ValueError(f"Unknown obs_order {self.obs_order!r}")
        if self.letkf_solve_precision not in ("default", "high", "highest"):
            raise ValueError(
                f"Unknown letkf_solve_precision "
                f"{self.letkf_solve_precision!r}"
            )
        if self.variable_localization is not None:
            if not isinstance(self.variable_localization, dict):
                raise ValueError("variable_localization must be a dict of "
                                 "(obs_var, state_var) -> factor")
            for key, val in self.variable_localization.items():
                if isinstance(key, str):
                    if key.count(":") != 1:
                        raise ValueError(
                            f"variable_localization string keys must be "
                            f"'OBSVAR:STATEVAR', got {key!r}")
                elif not (isinstance(key, tuple) and len(key) == 2):
                    raise ValueError(
                        f"variable_localization keys must be 2-tuples or "
                        f"'A:B' strings, got {key!r}")
                if not (isinstance(val, (int, float)) and val >= 0):
                    raise ValueError(
                        f"variable_localization factors must be numbers "
                        f">= 0, got {key!r}: {val!r}")
            if self.hybrid_alpha < 1.0:
                raise ValueError(
                    "variable_localization does not combine with hybrid "
                    "covariance (the static column would be untapered)")
        if self.taps_topk not in ("exact", "approx"):
            raise ValueError(f"Unknown taps_topk {self.taps_topk!r}")
        if self.taps_search not in ("auto", "device"):
            raise ValueError(f"Unknown taps_search {self.taps_search!r}")
        if self.matmul_precision not in (
            None, "default", "high", "highest", "bfloat16",
            "tensorfloat32", "float32",
        ):
            raise ValueError(
                f"Unknown matmul_precision {self.matmul_precision!r}"
            )
        if self.letkf_patch_size < 1 or self.letkf_k_obs < 1:
            raise ValueError("letkf_patch_size and letkf_k_obs must be >= 1")
        if self.outlier_threshold is not None and not (
            isinstance(self.outlier_threshold, (int, float))
            and self.outlier_threshold > 0
        ):
            raise ValueError("outlier_threshold must be a number > 0 or None")
        if self.outlier_action not in ("reject", "inflate"):
            raise ValueError(
                f"Unknown outlier_action {self.outlier_action!r} "
                "(expected 'reject' or 'inflate')"
            )
        if not 0.0 <= self.rtps_alpha <= 1.0:
            raise ValueError("rtps_alpha must be in [0, 1]")
        if not 0.0 <= self.rtpp_alpha <= 1.0:
            raise ValueError("rtpp_alpha must be in [0, 1]")
        if self.rtps_alpha > 0.0 and self.rtpp_alpha > 0.0:
            raise ValueError(
                "rtps_alpha and rtpp_alpha are mutually exclusive — pick "
                "one relaxation scheme"
            )
        if not 0.0 <= self.hybrid_alpha <= 1.0:
            raise ValueError("hybrid_alpha must be in [0, 1]")
        if self.hybrid_alpha < 1.0:
            if self.static_b_sigma is None or self.static_b_length is None:
                raise ValueError(
                    "hybrid_alpha < 1 needs static_b_sigma and "
                    "static_b_length"
                )
            if self.tail_pallas:
                raise ValueError(
                    "tail_pallas requires the pure-ensemble gain (the "
                    "tail kernels have no static column)"
                )
