"""Phase-2 body sweep as one Pallas kernel through Triton: the state
crosses device memory once.

The XLA body (:func:`efa_xray_tpu.assimilation.ensrf_core.ensrf_blocked_body`)
writes four ``[rows, B]`` slabs (weights, ``d0``, ``U``, ``V``) to device
memory for every block of B obs and runs the within-block recurrence as B
separate row-wide operations.  Here one program owns a ``[TR, M]`` tile
of the state and keeps it in registers while it walks over every obs
block, so the state is read once and written once per update:

* the grid runs over row tiles only; the obs-block loop is a
  ``fori_loop`` inside the program;
* each program reads its own cull bits (:func:`cull_masks`, plain JAX)
  and skips (tile, block) pairs whose Gaspari-Cohn weights are provably
  all zero — exact, the skipped work multiplies by zero;
* per block, ``D = X Y^T`` and ``X -= V Y`` are two ``[TR, M] x [M, B]``
  products on the tensor cores; between them the block's B obs are
  solved column by column in registers (right-looking: each solved
  column ``v_j`` is subtracted from the later columns of ``D`` through
  the block's Gram row);
* localization weights are computed in-kernel per (row, ob): chordal
  (``fast_geometry``: polynomial arccos of the unit-vector dot, as
  :func:`~efa_xray_tpu.observation.localization.chordal_gc_weights`) or
  exact great-circle (``2 asin(chord / 2)``, the haversine formula
  written through the unit-vector chord), times an optional vertical
  Gaspari-Cohn factor and an optional cross-variable factor gathered
  from the small ``varloc`` table;
* the hybrid static column (``hybrid=True``) rides the same recurrence:
  ``v_j = g_j u_j + ss_j s_j`` with ``s_j = sigma_row GC(d, L_B)`` on the
  exact great-circle distance, as the XLA body defines it.

Members are padded to a power of two (``>= 16``, the tensor cores'
smallest dot), row tiles and obs blocks are powers of two; partial tiles
and padded members are masked on load and store, so the in/out buffers
keep their shapes and alias (the donating entry point updates the state
in place).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from efa_xray_tpu.assimilation.ensrf_core import ObsArrays, TailSolution
from efa_xray_tpu.observation.localization import (
    EARTH_RADIUS_KM,
    _arccos_as,
    latlon_to_unit,
    morton3d_keys,
)

TILE_ROWS = 64
"""State rows per program (one ``[TILE_ROWS, M]`` register tile).  64
with 4 warps beat 32 and 128 rows (4 or 8 warps) on an H100 at the
headline shape."""

BLOCK_OBS = 16
"""Obs per block: the unit of culling and of the two tensor-core
products.  16 (the smallest tensor-core dot) beat 32 on an H100: the
in-register column solve costs B operations per (row, ob) pair."""

NUM_WARPS = 4

# Culling-bound slack: covers f32 arccos conditioning of the cap bound
# (2e-3 rad ~ 13 km, far below any localization radius).
_CULL_MARGIN_RAD = 2e-3

_WORD = 32  # cull bits per int32 word

# Rows of the per-ob parameter matrix.
_OX, _OY, _OZ, _IRAD, _OVERT, _IVRAD, _GAIN, _SQRT, _SGAIN, _SSQRT = range(10)
# Rows of the per-row geometry matrix.
_RX, _RY, _RZ, _RVERT, _RSIG = range(5)


def pow2(n: int, floor: int = 16) -> int:
    """Smallest power of two >= max(n, floor)."""
    p = floor
    while p < n:
        p *= 2
    return p


def dot_precision():
    """The ``lax.Precision`` of the kernels' dots under the ambient
    ``jax.default_matmul_precision`` (which
    :meth:`Assimilation.with_matmul_precision` sets from
    ``FilterConfig.matmul_precision``).  "highest"/"float32" run true f32
    products; everything else takes the tensor cores' TF32 path, as XLA's
    own f32 dots do at the default."""
    mp = jax.config.jax_default_matmul_precision
    if mp in ("highest", "float32"):
        return jax.lax.Precision.HIGHEST
    return jax.lax.Precision.DEFAULT


def gc_scaled(r):
    """Gaspari-Cohn of the scaled distance ``r = d / halfwidth`` (same
    branches as :func:`~efa_xray_tpu.observation.localization.gaspari_cohn`)."""
    inner = ((((-0.25 * r + 0.5) * r + 0.625) * r - 5.0 / 3.0) * (r * r)) + 1.0
    r_safe = jnp.where(r > 0, r, 1.0)
    outer = (
        ((((r / 12.0 - 0.5) * r + 0.625) * r + 5.0 / 3.0) * r - 5.0) * r
        + 4.0
        - 2.0 / (3.0 * r_safe)
    )
    return jnp.where(r <= 1.0, inner, jnp.where(r < 2.0, outer, 0.0))


def _angles(rx, ry, rz, ox, oy, oz, geometry: str):
    """Great-circle angle between row unit vectors and one ob's."""
    if geometry == "chordal":
        return _arccos_as(jnp.clip(rx * ox + ry * oy + rz * oz, -1.0, 1.0))
    return _chord_angle(rx, ry, rz, ox, oy, oz)


def _chord_angle(rx, ry, rz, ox, oy, oz):
    dx, dy, dz = rx - ox, ry - oy, rz - oz
    half = 0.5 * jnp.sqrt(dx * dx + dy * dy + dz * dz)
    return 2.0 * jnp.arcsin(jnp.minimum(half, 1.0))


def _make_kernel(*, nrows, nmems, mp, tr, bsz, nwords, localize, geometry,
                 vertical, hybrid, varloc, nvars, inv_static_len, precision):
    need_geo = localize or hybrid
    dims = (((1,), (1,)), ((), ()))  # X [TR, MP] . Y [B, MP]^T
    dims_v = (((1,), (0,)), ((), ()))  # V [TR, B] . Y [B, MP]

    def kernel(bits_ref, rowf_ref, rvar_ref, obp_ref, ovar_ref, ye_ref,
               gram_ref, vl_ref, bm_ref, bp_ref, om_ref, op_ref):
        i0 = jnp.int32(0)
        t = pl.program_id(0)
        r0 = t * tr
        rmask = r0 + jnp.arange(tr, dtype=jnp.int32) < nrows
        cmask = jnp.arange(mp, dtype=jnp.int32) < nmems
        xmask = rmask[:, None] & cmask[None, :]
        rows = pl.ds(r0, tr)
        x0 = plgpu.load(bp_ref.at[rows, pl.ds(i0, mp)], mask=xmask, other=0.0)
        f = x0.dtype
        xm0 = plgpu.load(bm_ref.at[rows], mask=rmask, other=0.0)

        def row(k):
            return plgpu.load(rowf_ref.at[k, rows], mask=rmask,
                              other=0.0)[:, None]

        if need_geo:
            rx, ry, rz = row(_RX), row(_RY), row(_RZ)
        if vertical:
            rv = row(_RVERT)
        if hybrid:
            rsig = row(_RSIG)
        if varloc:
            rvar = plgpu.load(rvar_ref.at[rows], mask=rmask, other=0)[:, None]
        col = jnp.arange(bsz, dtype=jnp.int32)[None, :]

        def block(b, carry):
            x, xm = carry
            obs = pl.ds(b * bsz, bsz)

            def ob(k):
                return plgpu.load(obp_ref.at[k, obs])[None, :]

            y = plgpu.load(ye_ref.at[obs, pl.ds(i0, mp)],
                           mask=jnp.broadcast_to(cmask[None, :], (bsz, mp)),
                           other=0.0)
            d = jax.lax.dot_general(x, y, dims, precision=precision,
                                    preferred_element_type=f)
            # Per-(row, ob) factors of the whole block at once: no
            # dependence between columns, so they leave the serial chain.
            w = None
            if need_geo:
                ox, oy, oz = ob(_OX), ob(_OY), ob(_OZ)
            if localize:
                ang = _angles(rx, ry, rz, ox, oy, oz, geometry)
                irad = ob(_IRAD)
                w = jnp.where(irad > 0, gc_scaled(EARTH_RADIUS_KM * ang * irad),
                              1.0)
                if vertical:
                    ivr = ob(_IVRAD)
                    w = w * jnp.where(
                        ivr > 0, gc_scaled(jnp.abs(rv - ob(_OVERT)) * ivr), 1.0)
            if varloc:
                ov = plgpu.load(ovar_ref.at[obs])[None, :]
                fac = plgpu.load(vl_ref.at[ov * nvars + rvar])
                w = fac if w is None else w * fac
            g = ob(_SQRT)
            if hybrid:
                hang = (ang if (localize and geometry != "chordal")
                        else _chord_angle(rx, ry, rz, ox, oy, oz))
                s = rsig * gc_scaled(EARTH_RADIUS_KM * hang * inv_static_len)
                ss = ob(_SSQRT)
            # e[:, k] = w_k * (d_k - sum_{i<k} v_i G_ik), kept current as
            # columns solve (right-looking), so u_j is one extraction.
            e = d if w is None else w * d
            u_all = jnp.zeros((tr, bsz), f)
            for j in range(bsz):
                onehot = col == j
                u = jnp.sum(jnp.where(onehot, e, 0.0), axis=1)[:, None]
                u_all = jnp.where(onehot, u, u_all)
                v = u
                if hybrid:
                    v = (u * jnp.sum(jnp.where(onehot, g, 0.0))
                         + jnp.sum(jnp.where(onehot, s, 0.0), axis=1)[:, None]
                         * jnp.sum(jnp.where(onehot, ss, 0.0)))
                upd = v * plgpu.load(gram_ref.at[b, j, pl.ds(i0, bsz)])[None, :]
                e = e - (upd if w is None else w * upd)
            vmat = u_all * g
            mean = jnp.sum(u_all * ob(_GAIN), axis=1)
            if hybrid:
                vmat = vmat + s * ss
                mean = mean + jnp.sum(s * ob(_SGAIN), axis=1)
            x = x - jax.lax.dot_general(vmat, y, dims_v, precision=precision,
                                        preferred_element_type=f)
            return x, xm + mean

        def word(wi, carry):
            bits = plgpu.load(bits_ref.at[t, wi])

            def each(i, c):
                alive = ((bits >> i) & 1) != 0
                return jax.lax.cond(alive, lambda cc: block(wi * _WORD + i, cc),
                                    lambda cc: cc, c)

            return jax.lax.cond(
                bits != 0,
                lambda c: jax.lax.fori_loop(i0, jnp.int32(_WORD), each, c),
                lambda c: c, carry)

        x, xm = jax.lax.fori_loop(i0, jnp.int32(nwords), word, (x0, xm0))
        plgpu.store(op_ref.at[rows, pl.ds(i0, mp)], x, mask=xmask)
        plgpu.store(om_ref.at[rows], xm, mask=rmask)

    return kernel


def cull_masks(body_xyz, ob_xyz, radii, assim, tile: int, block_size: int):
    """``[gtiles, nblocks]`` bool: False where every Gaspari-Cohn weight
    between the row tile and the obs block is provably zero.

    Bound: a tile is a spherical cap (center ``c_t``, angular radius
    ``cap_t``), and so is the block's set of assimilated obs (``c_b``,
    ``cap_b``).  Every (row, ob) pair is then at least
    ``angle(c_t, c_b) - cap_t - cap_b`` apart, and GC support ends at
    ``2 * halfwidth``: the pair is dead beyond ``cap_t + cap_b +
    max_j 2 r_j / R``.  Obs with ``radii = inf`` keep every pair alive;
    obs with ``assim = False`` have zero gain and sqrt coefficients
    (``ensrf_core.tail_scan``) and never keep a pair alive.  Dots run at
    HIGHEST precision: a TF32 dot would blur the bound by ~1e-3 in
    cosine."""
    hi = jax.lax.Precision.HIGHEST
    nrows = body_xyz.shape[0]
    nobs = ob_xyz.shape[0]
    gtiles = max(1, -(-nrows // tile))
    nblocks = max(1, -(-nobs // block_size))
    dtype = body_xyz.dtype
    fallback = jnp.asarray([1.0, 0.0, 0.0], dtype=dtype)

    def caps(xyz, active):  # xyz [G, K, 3], active [G, K]
        s = jnp.sum(jnp.where(active[..., None], xyz, 0.0), axis=1)
        n = jnp.sqrt(jnp.sum(s * s, axis=1, keepdims=True))
        center = jnp.where(n > 1e-6, s / jnp.maximum(n, 1e-6), fallback)
        cosang = jnp.einsum("gkc,gc->gk", xyz, center, precision=hi)
        cosmin = jnp.min(jnp.where(active, cosang, 1.0), axis=1)
        return center, jnp.arccos(jnp.clip(cosmin, -1.0, 1.0))

    rpad = gtiles * tile - nrows
    txyz = jnp.concatenate(
        [body_xyz, jnp.broadcast_to(body_xyz[-1:], (rpad, 3))]
    ).reshape(gtiles, tile, 3)
    tcenter, tcap = caps(txyz, jnp.ones((gtiles, tile), bool))

    opad = nblocks * block_size - nobs
    oxyz = jnp.pad(ob_xyz, ((0, opad), (0, 0))).reshape(nblocks, block_size, 3)
    act = jnp.pad(assim, (0, opad)).reshape(nblocks, block_size)
    bcenter, bcap = caps(oxyz, act)
    support = 2.0 * jnp.abs(radii.astype(dtype)) / EARTH_RADIUS_KM
    support = jnp.pad(support, (0, opad)).reshape(nblocks, block_size)
    bsup = jnp.max(jnp.where(act, support, 0.0), axis=1)

    ang = jnp.arccos(jnp.clip(
        jnp.einsum("tc,bc->tb", tcenter, bcenter, precision=hi), -1.0, 1.0))
    alive = ang <= (tcap[:, None] + bcap[None, :] + bsup[None, :]
                    + _CULL_MARGIN_RAD)
    return alive & jnp.any(act, axis=1)[None, :]


def pack_bits(alive):
    """``[gtiles, nblocks]`` bool -> ``[gtiles, nwords]`` int32, bit ``i``
    of word ``w`` = block ``32 w + i``."""
    gtiles, nblocks = alive.shape
    nwords = -(-nblocks // _WORD)
    a = jnp.pad(alive, ((0, 0), (0, nwords * _WORD - nblocks)))
    a = a.reshape(gtiles, nwords, _WORD).astype(jnp.uint32)
    packed = jnp.sum(a << jnp.arange(_WORD, dtype=jnp.uint32), axis=-1,
                     dtype=jnp.uint32)
    return jax.lax.bitcast_convert_type(packed, jnp.int32)


def _body_impl(
    body_mean,
    body_perts,
    body_lat,
    body_lon,
    tail: TailSolution,
    obs: ObsArrays,
    localize: bool = True,
    geometry: str = "chordal",
    body_vert=None,
    vertical: bool = False,
    cull: bool = True,
    spatial_sort: bool = False,
    row_order=None,
    inv_order=None,
    hybrid: bool = False,
    body_sigma=None,  # [N] static-B std per row (hybrid mode)
    static_length=None,  # km: GC halfwidth of the static covariance model
    varloc=None,  # [nv(+1), nvars] cross-variable localization factors
    row_var=None,  # [N] int32 state-variable index per row
    ob_var=None,  # [No] int32 observed-variable index per ob
    block_size: int = BLOCK_OBS,
    tile: int = TILE_ROWS,
    interpret: bool = False,
):
    """Apply the pre-solved obs sequence ``tail`` to the state body.

    Same result as :func:`ensrf_core.ensrf_blocked_body` with
    ``fast_geometry = (geometry == "chordal")`` up to fp reassociation,
    for any row layout (flat or gridded; per-row weights are exact for
    both).  ``block_size`` and ``tile`` are rounded up to powers of two
    (>= 16).  ``spatial_sort`` permutes rows into spherical Morton order
    around the kernel so that row tiles are compact caps and culling
    bites (exact: the update is row-local); ``row_order``/``inv_order``
    pass a precomputed permutation."""
    nobs = tail.ye.shape[0]
    if nobs == 0:
        return body_mean, body_perts
    if geometry not in ("chordal", "haversine"):
        raise ValueError(f"Unknown geometry {geometry!r}")
    if hybrid and (body_sigma is None or static_length is None
                   or tail.static_gain is None):
        raise ValueError(
            "hybrid body kernel needs body_sigma, static_length and a "
            "hybrid-mode TailSolution (static_gain/static_sqrt)"
        )
    use_vl = varloc is not None
    if use_vl and (row_var is None or ob_var is None):
        raise ValueError("varloc needs row_var and ob_var")
    dtype = body_perts.dtype
    nrows, nmems = body_perts.shape
    bsz = pow2(block_size)
    tr = pow2(tile)
    mp = pow2(nmems)
    nblocks = -(-nobs // bsz)
    pad = nblocks * bsz - nobs
    nwords = -(-nblocks // _WORD)
    gtiles = -(-nrows // tr)

    obs = obs.with_default_verts()
    f = lambda x: x.astype(dtype)
    padv = lambda x, fill=0.0: jnp.pad(f(x), (0, pad), constant_values=fill)
    ob_xyz = f(latlon_to_unit(obs.lats, obs.lons))
    radii = f(obs.radii)
    inv = lambda r: jnp.where(jnp.isinf(r), 0.0, 1.0 / jnp.abs(r))
    zeros = jnp.zeros((nobs,), dtype)
    sqrtc = padv(tail.sqrt_coef)
    obp = jnp.stack([
        padv(ob_xyz[:, 0]), padv(ob_xyz[:, 1]), padv(ob_xyz[:, 2]),
        padv(inv(radii)), padv(obs.verts), padv(inv(f(obs.vert_radii))),
        padv(tail.gain_coef), sqrtc,
        padv(tail.static_gain if hybrid else zeros),
        padv(tail.static_sqrt if hybrid else zeros),
    ])
    ye = jnp.pad(f(tail.ye), ((0, pad), (0, 0)))
    yb = ye.reshape(nblocks, bsz, nmems)
    hi = jax.lax.Precision.HIGHEST
    gram = jnp.einsum("bjm,bkm->bjk", yb, yb, precision=hi)
    # gram[b, j, k] = g_j y_j . y_k for k > j: ob j's pull on the later
    # columns k of its block (hybrid: without g_j, which then scales v_j
    # in-kernel next to the static term).
    if not hybrid:
        gram = gram * sqrtc.reshape(nblocks, bsz)[:, :, None]
    gram = jnp.where(jnp.arange(bsz)[None, :] > jnp.arange(bsz)[:, None],
                     gram, 0.0)
    if use_vl:
        vl = f(jnp.asarray(varloc))
        nvars = int(vl.shape[1])
        vl = vl.reshape(-1)
        ovar = jnp.pad(jnp.asarray(ob_var, jnp.int32), (0, pad))
        # Clamped like an XLA gather: tail rows of custom-operator obs
        # carry the extra index nvars (the table's all-ones row).
        rvar = jnp.clip(jnp.asarray(row_var, jnp.int32), 0, nvars - 1)
    else:
        nvars = 1
        vl = jnp.ones((1,), dtype)
        ovar = jnp.zeros((nobs + pad,), jnp.int32)
        rvar = jnp.zeros((nrows,), jnp.int32)

    body_xyz = f(latlon_to_unit(body_lat, body_lon))
    bvert = f(body_vert) if body_vert is not None else jnp.zeros((nrows,), dtype)
    bsig = (jnp.broadcast_to(f(jnp.asarray(body_sigma)), (nrows,))
            if hybrid else jnp.zeros((nrows,), dtype))
    if spatial_sort:
        if row_order is None:
            row_order = jnp.argsort(morton3d_keys(body_xyz))
        if inv_order is None:
            inv_order = jnp.zeros_like(row_order).at[row_order].set(
                jnp.arange(nrows, dtype=row_order.dtype))
        take = lambda a: jnp.take(a, row_order, axis=0)
        body_mean, body_perts = take(body_mean), take(body_perts)
        body_xyz, bvert, bsig, rvar = (take(body_xyz), take(bvert),
                                       take(bsig), take(rvar))
    rowf = jnp.stack([body_xyz[:, 0], body_xyz[:, 1], body_xyz[:, 2],
                      bvert, bsig])

    if localize and cull:
        cull_radii = radii
        if hybrid:
            # The static column's support ends at 2 * static_length.
            cull_radii = jnp.maximum(radii, float(static_length))
        alive = cull_masks(body_xyz, ob_xyz, cull_radii, obs.assim, tr, bsz)
    else:
        alive = jnp.ones((gtiles, nblocks), bool)
    bits = pack_bits(alive)

    kernel = _make_kernel(
        nrows=nrows, nmems=nmems, mp=mp, tr=tr, bsz=bsz, nwords=nwords,
        localize=localize, geometry=geometry, vertical=vertical,
        hybrid=hybrid, varloc=use_vl, nvars=nvars,
        inv_static_len=(1.0 / float(static_length)) if hybrid else 0.0,
        precision=dot_precision(),
    )
    out_mean, out_perts = pl.pallas_call(
        kernel,
        grid=(gtiles,),
        out_shape=[
            jax.ShapeDtypeStruct((nrows,), dtype),
            jax.ShapeDtypeStruct((nrows, nmems), dtype),
        ],
        input_output_aliases={8: 0, 9: 1},
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS,
                                             num_stages=1),
        interpret=interpret,
        name="ensrf_body",
    )(bits, rowf, rvar, obp, ovar, ye, gram, vl, f(body_mean), body_perts)

    if spatial_sort:
        return (jnp.take(out_mean, inv_order, axis=0),
                jnp.take(out_perts, inv_order, axis=0))
    return out_mean, out_perts


_STATIC = ("localize", "geometry", "vertical", "cull", "spatial_sort",
           "hybrid", "static_length", "block_size", "tile", "interpret")

body_update = jax.jit(_body_impl, static_argnames=_STATIC)

# Donates the state buffers (args 0 and 1): the kernel updates them in
# place.  EnSRF uses this (it owns the formatted prior).
body_update_donating = jax.jit(
    _body_impl, static_argnames=_STATIC, donate_argnums=(0, 1)
)
