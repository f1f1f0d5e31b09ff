"""Multi-device EnSRF: state body sharded, observation tail replicated.

The communication design follows SURVEY.md §5.8.  Both kernels in
:mod:`efa_xray_tpu.assimilation.ensrf_core` are row-parallel in the state
dimension — every per-observation quantity that couples rows (``ye``,
``varye``, ``innov``, ``kdenom``, ``beta``) lives entirely in the
replicated obs-space tail.  So under ``shard_map``:

* the body mean/perts and per-row lat/lon shard along the ``state`` axis;
* the tail and all per-ob arrays replicate;
* the tail update runs redundantly (and bit-identically) on every device;
* **zero collectives** are issued inside the observation loop — the
  interconnect is touched only by the initial gather of observation priors
  (outside this module) and the final result layout.

This is the working realization of the reference's intended
(broken) design: "obs-space priors computed once globally, then each worker
runs the full serial EnSRF on its state chunk independently"
(``efa_xray/assimilation/assimilation.py:176-230``).
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from efa_xray_tpu.assimilation import ensrf_core as core
from efa_xray_tpu.ops.select import Kernels
from efa_xray_tpu.parallel.mesh import STATE_AXIS, pad_rows, pad_to_multiple


def _shard_specs(axis: str, extra_in=()):
    sharded = P(axis)
    sharded2 = P(axis, None)
    rep = P()
    obs_spec = core.ObsArrays(*([rep] * 8))
    in_specs = (sharded, sharded2, rep, rep, sharded, sharded, sharded,
                obs_spec) + tuple(extra_in)
    out_specs = (
        sharded,
        sharded2,
        rep,
        rep,
        core.ObsDiagnostics(*([rep] * 5)),
    )
    return in_specs, out_specs


def _ensrf_sharded_impl(
    body_mean,
    body_perts,
    tail_mean,
    tail_perts,
    body_lat,
    body_lon,
    body_vert,
    obs: core.ObsArrays,
    body_sigma,  # [Ns] static-B std, sharded with the rows (hybrid mode)
    tail_sigma,  # [No] static-B std at ob locations, replicated
    varloc=None,  # [nv(+1), nvars] cross-variable factors, replicated
    row_var=None,  # [Ns] int32, sharded with the rows
    ob_var=None,  # [No] int32, replicated
    *,
    mesh: Mesh,
    localize: bool,
    method: str,
    block_size: int,
    axis_name: str,
    unbiased: bool,
    kernels: Kernels,
    fast_geometry: bool,
    vertical: bool,
    tail_panel: int,
    cull: bool,
    spatial_sort: bool,
    hybrid_alpha: float,
    static_length: float,
    use_varloc: bool = False,
):
    # The hybrid static column is per-row x per-ob separable, so it shards
    # exactly like the ensemble part: sigma_row rides the state axis, the
    # ob-side scalars replicate with the tail — still zero collectives.
    # Variable-localization factors are per-(row, ob) too: the tiny factor
    # matrix and ob_var replicate, row_var rides the state axis.
    hybrid = hybrid_alpha < 1.0
    if varloc is None:
        # direct (non-wrapper) callers with varloc off: tiny traced
        # placeholders so the shard_map pytree stays fixed
        varloc = jnp.ones((1, 1), body_mean.dtype)
        row_var = jnp.zeros(body_mean.shape, jnp.int32)
        ob_var = jnp.zeros(tail_mean.shape, jnp.int32)
    in_specs, out_specs = _shard_specs(
        axis_name, extra_in=(P(axis_name), P(), P(), P(axis_name), P()))

    def local_update(bm, bp, tm, tp, blat, blon, bvert, ob, bsig, tsig,
                     vl, rvar, ovar):
        hkw = dict(hybrid_alpha=hybrid_alpha, tail_sigma=tsig,
                   static_length=static_length) if hybrid else {}
        vkw = (dict(varloc=vl, row_var=rvar, ob_var=ovar)
               if use_varloc else {})
        if method == "serial":
            return core.ensrf_serial(
                bm, bp, tm, tp, blat, blon, ob, localize=localize,
                unbiased=unbiased, fast_geometry=fast_geometry,
                body_vert=bvert, vertical=vertical,
                body_sigma=bsig if hybrid else None, **hkw, **vkw,
            )
        # The tail replicates, so running it through the kernels stays
        # collective-free.
        tail = core.tail_scan_blocked(
            tm, tp, ob, localize=localize, unbiased=unbiased,
            fast_geometry=fast_geometry, vertical=vertical,
            panel=tail_panel,
            kernels=kernels.tail,
            interpret=kernels.interpret,
            **hkw,
            **(dict(varloc=vl, ob_var=ovar) if use_varloc else {}),
        )
        if kernels.body:
            # A state shard is an arbitrary row slice, and the kernel's
            # weights are per row: it applies to every shard as is.
            from efa_xray_tpu.ops.ensrf_triton import body_update

            bm, bp = body_update(
                bm, bp, blat, blon, tail, ob,
                localize=localize,
                geometry="chordal" if fast_geometry else "haversine",
                body_vert=bvert if vertical else None,
                vertical=vertical,
                cull=cull, spatial_sort=spatial_sort,
                hybrid=hybrid,
                body_sigma=bsig if hybrid else None,
                static_length=static_length if hybrid else None,
                interpret=kernels.interpret,
                **vkw,
            )
        else:
            bm, bp = core.ensrf_blocked_body(
                bm, bp, blat, blon, tail, ob,
                localize=localize, block_size=block_size,
                fast_geometry=fast_geometry,
                body_vert=bvert, vertical=vertical,
                hybrid=hybrid,
                body_sigma=bsig if hybrid else None,
                static_length=static_length if hybrid else None,
                **vkw,
            )
        return bm, bp, tail.tail_mean, tail.tail_perts, tail.diags

    fn = jax.shard_map(
        local_update,
        mesh=mesh,
        in_specs=in_specs,
        out_specs=out_specs,
        check_vma=False,
    )
    return fn(
        body_mean, body_perts, tail_mean, tail_perts, body_lat, body_lon,
        body_vert, obs, body_sigma, tail_sigma, varloc, row_var, ob_var,
    )


_SHARDED_STATIC = (
    "mesh", "localize", "method", "block_size", "axis_name",
    "unbiased", "kernels", "fast_geometry", "vertical",
    "tail_panel", "cull", "spatial_sort", "hybrid_alpha", "static_length",
    "use_varloc",
)

_ensrf_sharded_jit = jax.jit(_ensrf_sharded_impl, static_argnames=_SHARDED_STATIC)

# Donates the (padded, device-placed) state shards: under the mesh the
# posterior shards reuse the prior shards' device memory, so a sharded run
# does not carry 2x peak state memory.  Safe only when the caller owns the
# buffers (EnSRF does — it formats the prior itself).
_ensrf_sharded_jit_donating = jax.jit(
    _ensrf_sharded_impl, static_argnames=_SHARDED_STATIC, donate_argnums=(0, 1)
)


def ensrf_update_sharded(
    body_mean,
    body_perts,
    tail_mean,
    tail_perts,
    body_lat,
    body_lon,
    obs: core.ObsArrays,
    mesh: Mesh,
    localize: bool = True,
    method: str = "blocked",
    block_size: int = 32,
    axis_name: str = STATE_AXIS,
    unbiased: bool = False,
    kernels: Kernels = Kernels(body=False, tail=False, interpret=False),
    fast_geometry: bool = False,
    body_vert=None,
    vertical: bool = False,
    donate: bool = False,
    tail_panel: int = 64,
    cull: bool = True,
    spatial_sort: bool = False,
    hybrid_alpha: float = 1.0,
    body_sigma=None,  # [Ns] static-B std per row (hybrid_alpha < 1)
    tail_sigma=None,  # [No] static-B std at ob locations
    static_length=None,  # km: GC halfwidth of the static covariance model
    varloc=None,  # [nv(+1), nvars] cross-variable localization factors
    row_var=None,  # [Ns] int32 state-variable index per row
    ob_var=None,  # [No] int32 observed-variable index per ob
):
    """Sharded EnSRF update.  Pads the state rows to a multiple of the mesh
    size (pad rows carry zero perturbations and benign coordinates, so their
    updates are no-ops that never touch real rows), shards the body, runs
    the row-local kernel, and unpads.

    ``kernels`` (:func:`efa_xray_tpu.ops.select.choose`) picks the XLA
    programs or the Triton kernels for the tail and the body, as on one
    device.  ``hybrid_alpha < 1`` blends the static-B covariance on every
    device shard (``body_sigma`` shards with the rows; the ob-side scalars
    replicate) — the full hybrid gain stays row-local, zero collectives.

    ``donate=True`` donates the state shards to the update (posterior
    reuses the prior's memory).  The caller's ``body_mean``/``body_perts``
    may be invalidated when no padding/re-placement copy was needed —
    only pass it when the caller owns and will not reuse them."""
    ns = body_mean.shape[0]
    ndev = mesh.shape[axis_name]
    ns_pad = pad_to_multiple(ns, ndev)
    hybrid = hybrid_alpha < 1.0
    use_varloc = varloc is not None
    if hybrid:
        if body_sigma is None or tail_sigma is None or static_length is None:
            raise ValueError(
                "hybrid_alpha < 1 needs body_sigma, tail_sigma and "
                "static_length"
            )

    bm = pad_rows(body_mean, ns_pad)
    bp = pad_rows(body_perts, ns_pad)
    blat = pad_rows(body_lat, ns_pad)
    blon = pad_rows(body_lon, ns_pad)
    if body_vert is None:
        body_vert = jnp.zeros_like(body_lat[:ns])
    bvert = pad_rows(body_vert, ns_pad)
    if hybrid:
        bsig = pad_rows(
            jnp.broadcast_to(jnp.asarray(body_sigma, bm.dtype), (ns,)), ns_pad
        )
        tsig = jnp.broadcast_to(
            jnp.asarray(tail_sigma, bm.dtype), tail_mean.shape
        )
    else:
        # Fixed signature for the jit cache: zero-filled placeholders.
        bsig = jnp.zeros_like(blat)
        tsig = jnp.zeros_like(tail_mean)
    if use_varloc:
        vl = jnp.asarray(varloc, bm.dtype)
        rvar = pad_rows(jnp.asarray(row_var, jnp.int32), ns_pad)
        ovar = jnp.asarray(ob_var, jnp.int32)
    else:
        vl = jnp.ones((1, 1), bm.dtype)
        rvar = jnp.zeros((ns_pad,), jnp.int32)
        ovar = jnp.zeros((tail_mean.shape[0],), jnp.int32)

    shard1 = NamedSharding(mesh, P(axis_name))
    shard2 = NamedSharding(mesh, P(axis_name, None))
    rep = NamedSharding(mesh, P())
    bm = jax.device_put(bm, shard1)
    bp = jax.device_put(bp, shard2)
    blat = jax.device_put(blat, shard1)
    blon = jax.device_put(blon, shard1)
    bvert = jax.device_put(bvert, shard1)
    bsig = jax.device_put(bsig, shard1)
    tail_mean = jax.device_put(tail_mean, rep)
    tail_perts = jax.device_put(tail_perts, rep)
    tsig = jax.device_put(tsig, rep)
    vl = jax.device_put(vl, rep)
    rvar = jax.device_put(rvar, shard1)
    ovar = jax.device_put(ovar, rep)
    obs = jax.tree.map(lambda x: jax.device_put(x, rep), obs.with_default_verts())

    run = _ensrf_sharded_jit_donating if donate else _ensrf_sharded_jit
    bm, bp, tm, tp, diags = run(
        bm,
        bp,
        tail_mean,
        tail_perts,
        blat,
        blon,
        bvert,
        obs,
        bsig,
        tsig,
        vl,
        rvar,
        ovar,
        mesh=mesh,
        localize=localize,
        method=method,
        block_size=block_size,
        axis_name=axis_name,
        unbiased=unbiased,
        kernels=kernels,
        fast_geometry=fast_geometry,
        vertical=vertical,
        tail_panel=tail_panel,
        cull=cull,
        spatial_sort=spatial_sort,
        hybrid_alpha=float(hybrid_alpha),
        static_length=(
            float(static_length) if static_length is not None else 0.0
        ),
        use_varloc=use_varloc,
    )
    if ns != ns_pad:
        bm, bp = bm[:ns], bp[:ns]
    return bm, bp, tm, tp, diags


# ---------------------------------------------------------------------------
# Sharded stochastic EnKF
# ---------------------------------------------------------------------------


def _enkf_sharded_impl(
    body_mean,
    body_perts,
    tail_mean,
    tail_perts,
    body_lat,
    body_lon,
    body_vert,
    obs: core.ObsArrays,
    eps,  # [No, M] centered ob perturbations (replicated)
    varloc=None,  # [nv(+1), nvars] cross-variable factors, replicated
    row_var=None,  # [Ns] int32, sharded with the rows
    ob_var=None,  # [No] int32, replicated
    *,
    mesh: Mesh,
    localize: bool,
    axis_name: str,
    unbiased: bool,
    fast_geometry: bool,
    vertical: bool,
    method: str,
    block_size: int,
    use_varloc: bool = False,
):
    from efa_xray_tpu.assimilation.enkf import enkf_blocked, enkf_serial

    if varloc is None:
        varloc = jnp.ones((1, 1), body_mean.dtype)
        row_var = jnp.zeros(body_mean.shape, jnp.int32)
        ob_var = jnp.zeros(tail_mean.shape, jnp.int32)
    in_specs, out_specs = _shard_specs(axis_name)
    # eps + factor matrix + ob_var replicate with the tail; row_var
    # shards with the rows.
    in_specs = in_specs + (P(), P(), P(axis_name), P())

    def local_update(bm, bp, tm, tp, blat, blon, bvert, ob, eps_rep,
                     vl, rvar, ovar):
        vkw = (dict(varloc=vl, row_var=rvar, ob_var=ovar)
               if use_varloc else {})
        # The tail (and its scan) replicates per shard either way; the
        # blocked form additionally block-sweeps the LOCAL body rows
        # through the Gram-corrected recurrence (apply rows z) — still
        # zero collectives, same layout as the EnSRF sharded path.
        if method == "blocked":
            return enkf_blocked(
                bm, bp, tm, tp, blat, blon, ob, eps_rep,
                localize=localize, unbiased=unbiased,
                fast_geometry=fast_geometry, body_vert=bvert,
                vertical=vertical, block_size=block_size, **vkw,
            )
        return enkf_serial(
            bm, bp, tm, tp, blat, blon, ob, eps_rep, localize=localize,
            unbiased=unbiased, fast_geometry=fast_geometry,
            body_vert=bvert, vertical=vertical, **vkw,
        )

    fn = jax.shard_map(
        local_update,
        mesh=mesh,
        in_specs=in_specs,
        out_specs=out_specs,
        check_vma=False,
    )
    return fn(
        body_mean, body_perts, tail_mean, tail_perts, body_lat, body_lon,
        body_vert, obs, eps, varloc, row_var, ob_var,
    )


_ENKF_SHARDED_STATIC = (
    "mesh", "localize", "axis_name", "unbiased", "fast_geometry", "vertical",
    "method", "block_size", "use_varloc",
)

_enkf_sharded_jit = jax.jit(
    _enkf_sharded_impl, static_argnames=_ENKF_SHARDED_STATIC
)


def enkf_update_sharded(
    body_mean,
    body_perts,
    tail_mean,
    tail_perts,
    body_lat,
    body_lon,
    obs: core.ObsArrays,
    eps,
    mesh: Mesh,
    localize: bool = True,
    axis_name: str = STATE_AXIS,
    unbiased: bool = False,
    fast_geometry: bool = False,
    body_vert=None,
    vertical: bool = False,
    method: str = "blocked",
    block_size: int = 128,
    varloc=None,
    row_var=None,
    ob_var=None,
):
    """Sharded stochastic EnKF (same layout/communication design as
    :func:`ensrf_update_sharded`): state body sharded along the state axis,
    obs tail AND the perturbation table replicated, the update runs
    row-locally with zero per-ob collectives — ``method="blocked"``
    (default) block-sweeps each shard's rows through the Gram-corrected
    recurrence (:func:`efa_xray_tpu.assimilation.enkf.enkf_blocked`);
    ``"serial"`` keeps the per-ob scan.  The perturbed-ob update is
    exactly as row-parallel as the square-root one — ``eps`` enters only
    through the obs-space vector ``ye - eps~``."""
    ns = body_mean.shape[0]
    ndev = mesh.shape[axis_name]
    ns_pad = pad_to_multiple(ns, ndev)

    bm = pad_rows(body_mean, ns_pad)
    bp = pad_rows(body_perts, ns_pad)
    blat = pad_rows(body_lat, ns_pad)
    blon = pad_rows(body_lon, ns_pad)
    if body_vert is None:
        body_vert = jnp.zeros_like(body_lat[:ns])
    bvert = pad_rows(body_vert, ns_pad)
    use_varloc = varloc is not None
    if use_varloc:
        vl = jnp.asarray(varloc, bm.dtype)
        rvar = pad_rows(jnp.asarray(row_var, jnp.int32), ns_pad)
        ovar = jnp.asarray(ob_var, jnp.int32)
    else:
        vl = jnp.ones((1, 1), bm.dtype)
        rvar = jnp.zeros((ns_pad,), jnp.int32)
        ovar = jnp.zeros((tail_mean.shape[0],), jnp.int32)

    shard1 = NamedSharding(mesh, P(axis_name))
    shard2 = NamedSharding(mesh, P(axis_name, None))
    rep = NamedSharding(mesh, P())
    bm = jax.device_put(bm, shard1)
    bp = jax.device_put(bp, shard2)
    blat = jax.device_put(blat, shard1)
    blon = jax.device_put(blon, shard1)
    bvert = jax.device_put(bvert, shard1)
    tail_mean = jax.device_put(tail_mean, rep)
    tail_perts = jax.device_put(tail_perts, rep)
    eps = jax.device_put(eps, rep)
    vl = jax.device_put(vl, rep)
    rvar = jax.device_put(rvar, shard1)
    ovar = jax.device_put(ovar, rep)
    obs = jax.tree.map(lambda x: jax.device_put(x, rep), obs.with_default_verts())

    bm, bp, tm, tp, diags = _enkf_sharded_jit(
        bm,
        bp,
        tail_mean,
        tail_perts,
        blat,
        blon,
        bvert,
        obs,
        eps,
        vl,
        rvar,
        ovar,
        mesh=mesh,
        localize=localize,
        axis_name=axis_name,
        unbiased=unbiased,
        fast_geometry=fast_geometry,
        vertical=vertical,
        method=method,
        block_size=block_size,
        use_varloc=use_varloc,
    )
    if ns != ns_pad:
        bm, bp = bm[:ns], bp[:ns]
    return bm, bp, tm, tp, diags


# ---------------------------------------------------------------------------
# Sharded LETKF
# ---------------------------------------------------------------------------


def _letkf_sharded_impl(
    bm,  # [VT, Gpad]
    bp,  # [VT, Gpad, M]
    tail_mean,
    tail_perts,
    grid_lat,  # [Gpad]
    grid_lon,  # [Gpad]
    obs: core.ObsArrays,
    *,
    mesh: Mesh,
    g_local: int,
    axis_name: str,
    patch_size: int,
    k_obs: int,
    localize: bool,
    sqrt_method: str,
    ns_iters: int,
    chunk: int,
    vertical: bool = False,
    body_vert=None,  # [VT, Gpad] (sharded like bm) or None
    unbiased: bool = False,
    topk_method: str = "exact",
    solve_precision: str = "default",
    sel_cand=None,  # [ndev * Gn_local, S] host-certified candidates
    sel_mask=None,
    sel_group: int = 0,
    varloc=None,  # [nv(+1), nvars] cross-variable factors, replicated
    ob_var=None,  # [No] int32, replicated
    group_var=None,  # [VT] int32, replicated
):
    from efa_xray_tpu.assimilation import letkf_core

    vt, _ = bm.shape
    nens = bp.shape[-1]
    sharded_g = P(None, axis_name)
    rep = P()
    if body_vert is None:
        body_vert = jnp.zeros_like(bm)
    host_sel = topk_method == "host"
    if not host_sel:
        # pytree-stable dummies (never read)
        sel_cand = jnp.zeros((mesh.shape[axis_name], 1), jnp.int32)
        sel_mask = jnp.zeros((mesh.shape[axis_name], 1), jnp.bool_)
    use_varloc = varloc is not None
    if not use_varloc:
        varloc = jnp.ones((1, 1), bm.dtype)
        ob_var = jnp.zeros((tail_mean.shape[0],), jnp.int32)
        group_var = jnp.zeros((vt,), jnp.int32)
    in_specs = (
        sharded_g,
        P(None, axis_name, None),
        rep,
        rep,
        P(axis_name),
        P(axis_name),
        sharded_g,
        P(axis_name, None),
        P(axis_name, None),
        rep,
        rep,
        rep,
        core.ObsArrays(*([rep] * 8)),
    )
    out_specs = (
        sharded_g,
        P(None, axis_name, None),
        rep,
        rep,
        core.ObsDiagnostics(*([rep] * 5)),
    )

    def local_update(bm_l, bp_l, tm, tp, glat_l, glon_l, bvert_l,
                     cand_l, mask_l, vl, ovar, gvar, ob):
        # Every patch's solve is grid-local; the obs-space diagnostics
        # solve runs redundantly (bit-identically) on each device.  No
        # collectives anywhere.
        bm2, bp2, tm2, tp2, diags = letkf_core.letkf_update(
            bm_l.reshape(vt * g_local),
            bp_l.reshape(vt * g_local, nens),
            tm,
            tp,
            glat_l,
            glon_l,
            ob,
            ngrid=g_local,
            patch_size=patch_size,
            k_obs=k_obs,
            localize=localize,
            sqrt_method=sqrt_method,
            ns_iters=ns_iters,
            chunk=min(chunk, max(1, -(-g_local // patch_size))),
            vertical=vertical,
            body_vert=bvert_l.reshape(vt * g_local) if vertical else None,
            unbiased=unbiased,
            topk_method=topk_method,
            solve_precision=solve_precision,
            sel_cand=cand_l if host_sel else None,
            sel_mask=mask_l if host_sel else None,
            sel_group=sel_group,
            varloc=vl if use_varloc else None,
            ob_var=ovar if use_varloc else None,
            group_var=gvar if use_varloc else None,
        )
        return (
            bm2.reshape(vt, g_local),
            bp2.reshape(vt, g_local, nens),
            tm2,
            tp2,
            diags,
        )

    fn = jax.shard_map(
        local_update,
        mesh=mesh,
        in_specs=in_specs,
        out_specs=out_specs,
        check_vma=False,
    )
    return fn(bm, bp, tail_mean, tail_perts, grid_lat, grid_lon, body_vert,
              sel_cand, sel_mask, varloc, ob_var, group_var, obs)


_LETKF_STATIC = (
    "mesh", "g_local", "axis_name", "patch_size", "k_obs", "localize",
    "sqrt_method", "ns_iters", "chunk", "vertical", "unbiased",
    "topk_method", "solve_precision", "sel_group",
)
_letkf_sharded_jit = jax.jit(_letkf_sharded_impl, static_argnames=_LETKF_STATIC)


def letkf_update_sharded(
    body_mean,
    body_perts,
    tail_mean,
    tail_perts,
    grid_lat,  # [G] one copy of the spatial grid
    grid_lon,
    obs: core.ObsArrays,
    mesh: Mesh,
    ngrid: int,
    patch_size: int = 1,
    k_obs: int = 64,
    localize: bool = True,
    sqrt_method: str = "newton_schulz",
    ns_iters: int = 30,
    chunk: int = 512,
    axis_name: str = STATE_AXIS,
    vertical: bool = False,
    body_vert=None,  # [Ns] per-row vertical coordinate (vertical mode)
    unbiased: bool = False,
    topk_method: str = "exact",
    solve_precision: str = "default",
    sel_cand=None,  # [ndev * Gn_local, S] host candidates (topk "host"),
    # built per shard by letkf._host_selection_cached(ndev=...)
    sel_mask=None,
    sel_group: int = 0,
    varloc=None,  # [nv(+1), nvars] cross-variable factors
    ob_var=None,  # [No] int32
    group_var=None,  # [VT] int32
):
    """Sharded LETKF: the GRID axis (not the flat row axis) shards across
    the mesh, since rows of a column share their patch's weights.  Patches
    are independent, the tail/obs replicate, and — like the EnSRF path —
    **zero collectives** run inside the analysis.

    The grid is padded to a multiple of ``ndev * patch_size`` so local
    patch boundaries coincide with the unsharded ones: sharded and
    single-device analyses are identical (pad points repeat the last grid
    point and are dropped afterwards)."""
    ns = body_mean.shape[0]
    nens = body_perts.shape[1]
    vt = ns // ngrid
    ndev = mesh.shape[axis_name]
    g_pad = pad_to_multiple(ngrid, ndev * patch_size)
    pad = g_pad - ngrid

    bm = body_mean.reshape(vt, ngrid)
    bp = body_perts.reshape(vt, ngrid, nens)
    bvert = None if body_vert is None else body_vert.reshape(vt, ngrid)
    glat, glon = grid_lat, grid_lon
    if pad:
        bm = jnp.pad(bm, ((0, 0), (0, pad)))
        bp = jnp.pad(bp, ((0, 0), (0, pad), (0, 0)))
        glat = jnp.concatenate([glat, jnp.repeat(glat[-1:], pad)])
        glon = jnp.concatenate([glon, jnp.repeat(glon[-1:], pad)])
        if bvert is not None:
            bvert = jnp.pad(bvert, ((0, 0), (0, pad)), mode="edge")

    shard_g1 = NamedSharding(mesh, P(axis_name))
    shard_g2 = NamedSharding(mesh, P(None, axis_name))
    shard_g3 = NamedSharding(mesh, P(None, axis_name, None))
    rep = NamedSharding(mesh, P())
    bm = jax.device_put(bm, shard_g2)
    bp = jax.device_put(bp, shard_g3)
    glat = jax.device_put(glat, shard_g1)
    glon = jax.device_put(glon, shard_g1)
    if bvert is not None:
        bvert = jax.device_put(bvert, shard_g2)
    tail_mean = jax.device_put(tail_mean, rep)
    tail_perts = jax.device_put(tail_perts, rep)
    obs = jax.tree.map(lambda x: jax.device_put(x, rep), obs.with_default_verts())
    if topk_method == "host" and sel_cand is not None:
        shard_sel = NamedSharding(mesh, P(axis_name, None))
        sel_cand = jax.device_put(jnp.asarray(sel_cand), shard_sel)
        sel_mask = jax.device_put(jnp.asarray(sel_mask), shard_sel)

    bm, bp, tm, tp, diags = _letkf_sharded_jit(
        bm,
        bp,
        tail_mean,
        tail_perts,
        glat,
        glon,
        obs,
        mesh=mesh,
        g_local=g_pad // ndev,
        axis_name=axis_name,
        patch_size=patch_size,
        k_obs=k_obs,
        localize=localize,
        sqrt_method=sqrt_method,
        ns_iters=ns_iters,
        chunk=chunk,
        vertical=vertical,
        body_vert=bvert,
        unbiased=unbiased,
        topk_method=topk_method,
        solve_precision=solve_precision,
        sel_cand=sel_cand,
        sel_mask=sel_mask,
        sel_group=sel_group,
        varloc=varloc,
        ob_var=ob_var,
        group_var=group_var,
    )
    bm = bm[:, :ngrid].reshape(ns)
    bp = bp[:, :ngrid].reshape(ns, nens)
    return bm, bp, tm, tp, diags
