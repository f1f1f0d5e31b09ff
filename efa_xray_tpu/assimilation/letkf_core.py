"""LETKF: batched local ensemble transform Kalman filter.

An extension beyond the reference, which implements only the *serial*
square-root filter (``efa_xray/assimilation/ensrf.py:50-149``) whose
per-observation loop is inherently sequential (SURVEY.md §7 "hard parts").
The LETKF (Hunt, Kostelich & Szunyogh 2007, Physica D 230:112) removes that
bottleneck: every observation is assimilated simultaneously, and the
analysis decomposes into an independent ensemble-space solve per local
region — embarrassingly parallel over the grid, which is exactly the shape
accelerators want:

* **obs selection** = one batched top-k over chordal dot products;
* **ensemble-space matrices** ``C = Y^T diag(rho/R) Y`` = batched
  ``[K, M] x [K, M]`` matmuls;
* **inverse square root** of ``A = (M-1) I + C`` via coupled Newton–Schulz
  iterations — *pure matmuls*, no eigendecomposition on the hot path
  (``jnp.linalg.eigh`` is available as a reference backend);
* **weight application** = batched ``[S, M] x [M, M]`` matmuls.

Localization semantics differ from the serial EnSRF by construction: the
EnSRF tapers the *gain* rows (B-localization); the LETKF tapers the
*observation-error precision* per analysis point (R-localization).  With
localization off the two filters produce the same analysis mean and
covariance (tested), though individual perturbations differ by a rotation.

Approximation knobs (both exact at their defaults):

* ``patch_size`` — grid points per local patch sharing one set of weights
  (weights evaluated at the patch centroid).  ``1`` = per-point weights
  (textbook LETKF).  Rows at the same horizontal location across
  variables/times always share weights, which for horizontal-only
  localization is exact.
* ``k_obs`` — max observations entering a local solve (the nearest k by
  great-circle distance).  Observations beyond ``2 x radius`` carry zero
  weight anyway, so ``k_obs`` only truncates when a footprint holds more
  than k observations.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from efa_xray_tpu.assimilation.ensrf_core import ObsArrays, ObsDiagnostics, _empty_diags
from efa_xray_tpu.observation.localization import (
    chordal_gc_weights,
    gaspari_cohn,
    latlon_to_unit,
)


def _solve_precision_obj(solve_precision: str):
    """Resolve the ``solve_precision`` knob to a ``lax.Precision`` (or
    None = ambient).  Governs the ensemble-SPACE solve chain only — the
    ``C = Y^T diag(rho/R) Y`` build, the Newton–Schulz iterations, and the
    ``wbar`` solve, all tiny ``[C, K, M]`` / ``[C, M, M]`` operands — NOT
    the big state-apply einsums.  Rationale: at a reduced-precision
    default (TF32 inputs on a GPU) the NS iteration stalls at a floor set
    by the input rounding (see ``_invsqrt_newton_schulz``); pinning just
    the solve chain buys that accuracy back while the FLOP-heavy applies
    keep full speed."""
    if solve_precision in (None, "default"):
        return None
    if solve_precision == "high":
        return jax.lax.Precision.HIGH
    if solve_precision == "highest":
        return jax.lax.Precision.HIGHEST
    raise ValueError(f"unknown solve_precision {solve_precision!r}")


class PatchWeights(NamedTuple):
    """Per-patch ensemble-space analysis weights."""

    wbar: jnp.ndarray  # [P, M]  mean-update weights
    transform: jnp.ndarray  # [P, M, M] symmetric sqrt transform W


# ---------------------------------------------------------------------------
# Local observation selection
# ---------------------------------------------------------------------------


def _top_k(dots, k: int, method: str = "exact"):
    """Nearest-k selection by descending dot product.

    ``method="approx"`` uses ``jax.lax.approx_max_k`` (a partial-reduction
    primitive, recall >= 0.95 per row) — obs SELECTION
    tolerates approximation: a missed far-edge ob carries a near-zero
    Gaspari-Cohn weight by construction, so analysis impact is far below
    the localization truncation already accepted by nearest-k itself.
    """
    if method == "approx":
        return jax.lax.approx_max_k(dots, k, recall_target=0.95)
    # approx_max_k(recall_target=1.0) — the partial-reduce op with loss
    # disabled — ran at the SAME cost as the sort-based primitive on the
    # previous accelerator (benchmarks/letkf_breakdown.py measures it),
    # so exact selection stays on lax.top_k and "approx" (recall >= 0.95)
    # is the fast option.
    return jax.lax.top_k(dots, k)


def select_local_obs(patch_xyz, obs_xyz, k: int, chunk: int = 4096,
                     topk_method: str = "exact"):
    """Indices of the k nearest observations per patch: ``[P, k]``.

    Nearest by great-circle distance == largest chordal dot product, so the
    selection is one ``[P, 3] x [3, No]`` matmul + ``top_k`` per chunk of
    patches (chunked to bound the ``[chunk, No]`` score buffer).
    """
    npatch = patch_xyz.shape[0]
    k = int(min(k, obs_xyz.shape[0]))
    nchunks = -(-npatch // chunk)
    pad = nchunks * chunk - npatch
    pxyz = jnp.pad(patch_xyz, ((0, pad), (0, 0))).reshape(nchunks, chunk, 3)

    def one(pts):
        # HIGHEST is load-bearing exactly as in the taps search
        # (observation/forward.py:_topk_points_mapped): a default-precision
        # f32 matmul may round its inputs (TF32 on a GPU: ~sqrt(2*2^-11)
        # rad ~ 200 km of ranking resolution for chord dots near 1.0;
        # bf16 is worse) — the nearest-k set then includes/excludes obs
        # mis-ranked by hundreds of km, which (unlike the far-edge misses
        # "approx" tolerates) carry mid-range GC weights.  The K=3
        # contraction is noise next to the top_k that follows.
        dots = jnp.einsum(
            "pc,oc->po", pts, obs_xyz,
            preferred_element_type=jnp.float32,
            precision=jax.lax.Precision.HIGHEST,
        )
        _, idx = _top_k(dots, k, topk_method)
        return idx

    idx = jax.lax.map(one, pxyz).reshape(nchunks * chunk, k)
    return idx[:npatch]


def _sel_cost(s: int, group: int) -> float:
    """Device-cost model for one (candidate width S, bundle size) choice:
    per-patch rescoring work is ~ S (dots + masked top_k), and per-GROUP
    work (obs_xyz gather + broadcast of the candidate row) is ~ S/group
    per patch — so shrinking the bundle shrinks S (tighter certificate)
    but multiplies the shared-row overhead.  The relative weight was
    fitted to device A/Bs of forced bundle sizes at the pod slice (pick
    64) and at 50k obs (pick 16) (benchmarks/letkf_breakdown.py
    --group); cost = S*(1 + 16/g) reproduces both orderings.  Not
    re-fitted on the H100."""
    return s * (1.0 + 16.0 / group)


def host_select_candidates(grid_lat, grid_lon, ngrid: int, patch_size: int,
                           obs_lat, obs_lon, k: int, chunk: int = 512,
                           group: int = 64, slack: float = 1e-5,
                           auto_group: bool = True):
    """Certified per-GROUP candidate obs sets for EXACT nearest-k
    selection at a fraction of the device top_k cost
    (``letkf_topk="host"``).

    The device-exact selection runs ``top_k`` over ALL ``No`` obs per
    patch — a large share of the pod-slice LETKF update
    (``benchmarks/letkf_breakdown.py``), with no faster exact on-device
    form.  But the top-k problem has spatial structure a host kd-tree
    exploits (the same move ``taps_search="auto"`` made for the forward
    operator, ``observation/forward.py``): bundle ``group`` adjacent
    patches, and compute ONE candidate set per bundle that provably
    contains every member patch's true nearest-k.  The device then
    rescopes its exact HIGHEST-precision dots + ``top_k`` to the
    ``S << No`` candidates.

    Certificate (chord metric; exact, not heuristic): let ``c`` be the
    bundle centroid, ``d = max_p |p - c|`` over member patch centers, and
    ``r_k(c)`` the k-th-nearest-ob distance from ``c``.  The k-th-NN
    distance is 1-Lipschitz in the query point, so for any member patch
    ``p`` and any ob ``o`` in ``p``'s true top-k:
    ``|c - o| <= |p - o| + d <= r_k(p) + d <= r_k(c) + 2d``.
    Hence ``ball(c, r_k(c) + 2d)`` covers every member's top-k; ``slack``
    absorbs the f32 device patch centers vs these f64 host centers.
    Candidate lists are sorted by obs index so tie-breaking matches the
    device-exact path's stable ``top_k``.

    Mirrors `_analyze_body_chunked`'s horizontal-mode padding exactly
    (patch → chunk → group alignment).  Returns
    ``(cand [Gn, S] int32, mask [Gn, S] bool, group_eff)`` with
    ``Gn = padded_units / group_eff`` and ``group_eff = gcd(group,
    effective chunk)`` so groups tile device chunks.
    """
    from scipy.spatial import cKDTree

    glat = np.asarray(grid_lat, np.float64)[:ngrid]
    glon = np.asarray(grid_lon, np.float64)[:ngrid]
    olat = np.asarray(obs_lat, np.float64)
    olon = np.asarray(obs_lon, np.float64)
    nobs = olat.shape[0]
    kk = int(min(k, nobs))

    def unit(lat, lon):
        la, lo = np.radians(lat), np.radians(lon)
        cl = np.cos(la)
        return np.stack([cl * np.cos(lo), cl * np.sin(lo), np.sin(la)], -1)

    npatch = -(-ngrid // patch_size)
    gpad = npatch * patch_size - ngrid
    gx = unit(glat, glon)
    if gpad:
        gx = np.concatenate([gx, np.repeat(gx[-1:], gpad, axis=0)], axis=0)
    px = gx.reshape(npatch, patch_size, 3).mean(axis=1)
    px /= np.maximum(np.linalg.norm(px, axis=-1, keepdims=True), 1e-12)

    chunkc = int(min(chunk, npatch))
    nchunks = -(-npatch // chunkc)
    padded = nchunks * chunkc
    oxyz = unit(olat, olon)
    tree = cKDTree(oxyz)

    def certify(group_try: int):
        """Bundle certificates for one bundle size: member patch centers
        ``pxg``, bundle ``centers``, certified ball ``radius`` and the
        ``wide`` mask (space-curve-jump bundles whose centroid ball would
        blow up — certified per member patch instead; see below)."""
        ngroups_real = -(-npatch // group_try)
        ppad = ngroups_real * group_try - npatch
        pxg = px
        if ppad:
            pxg = np.concatenate(
                [pxg, np.repeat(pxg[-1:], ppad, axis=0)], axis=0)
        pxg = pxg.reshape(ngroups_real, group_try, 3)
        centers = pxg.mean(axis=1)
        centers /= np.maximum(
            np.linalg.norm(centers, axis=-1, keepdims=True), 1e-12)
        d = np.linalg.norm(pxg - centers[:, None, :], axis=-1).max(axis=1)
        rk = tree.query(centers, k=kk, workers=-1)[0]
        rk = rk[:, -1] if kk > 1 else np.reshape(rk, (-1,))
        radius = rk + 2.0 * d + slack
        # Wide groups (space-curve jumps: members far from the centroid)
        # make the centroid certificate's ball huge — ONE such group would
        # blow the global candidate width S toward No (at the pod slice
        # about 1% of groups straddle Hilbert jumps with d up to ~1 rad).
        # For those, certify per member patch instead (d = 0 by
        # construction: ball(p, r_k(p) + slack) contains p's top-k by
        # definition) and take the union — a few clusters' worth of
        # candidates, not the sphere.
        wide = radius > np.minimum(2.0, rk + 2.0 * np.median(d) + 0.1)
        return pxg, centers, radius, wide

    def member_radii(members):
        rkp = tree.query(members, k=kk, workers=-1)[0]
        return (rkp[:, -1] if kk > 1 else np.reshape(rkp, (-1,))) + slack

    def est_width(group_try: int):
        """Exact candidate width S for one bundle size WITHOUT materializing
        the big tight-bundle lists: COUNT-only kd queries
        (``return_length=True``) give the tight widths, and the few wide
        (space-curve-jump) bundles — whose union a count sum would badly
        overestimate and distort the cost ranking — materialize their
        member lists (dozens of bundles, not thousands).  Returns
        ``(s, cert, wide_lists)`` so the winner's :func:`build` reuses the
        certificate and the wide-bundle unions instead of recomputing the
        kd work (certify + per-member queries ran twice before)."""
        cert = certify(group_try)
        pxg, centers, radius, wide = cert
        tight = np.nonzero(~wide)[0]
        s = kk
        wide_lists = {}
        if tight.size:
            counts = tree.query_ball_point(
                centers[tight], radius[tight], workers=-1,
                return_length=True)
            s = max(s, int(np.max(counts)))
        for g in np.nonzero(wide)[0]:
            acc: set = set()
            for lst in tree.query_ball_point(pxg[g], member_radii(pxg[g])):
                acc.update(lst)
            wide_lists[int(g)] = sorted(acc)
            s = max(s, len(acc))
        return s, cert, wide_lists

    def build(cert, wide_lists):
        """Candidate lists from a certificate; returns (lists, s_max).
        Tight bundles materialize here (only the WINNING bundle size pays
        this); wide-bundle unions come precomputed from est_width."""
        pxg, centers, radius, wide = cert
        lists = [None] * len(centers)
        tight = np.nonzero(~wide)[0]
        for g, lst in zip(tight, tree.query_ball_point(
                centers[tight], radius[tight], workers=-1)):
            lists[g] = lst
        for g in np.nonzero(wide)[0]:
            lists[g] = wide_lists[int(g)]
        return lists, max(kk, max(len(lst) for lst in lists))

    # Auto group size: the device rescoring cost is ~ proportional to the
    # candidate width S, and S grows with the bundle radius's 2d term —
    # which shrinks with smaller bundles (at the cost of more, cheaper,
    # host queries).  Dense networks (2d >> r_k) want small bundles;
    # sparse ones don't care.  Rank group, group/4, group/16 by the
    # COUNT-only width estimate and materialize lists ONLY for the winner
    # (the full 3x list materialization was the dominant build cost;
    # counts cut it ~2.5x with the same choice of bundle).
    g0 = math.gcd(int(group), chunkc)
    cands_g = ((g0, *(g for g in (g0 // 4, g0 // 16)
                      if g >= 1 and g0 % g == 0))
               if auto_group else (g0,))
    tried = []
    certs = {}
    for g_try in cands_g:
        s_t, cert, wide_lists = est_width(g_try)
        certs[g_try] = (cert, wide_lists)
        tried.append((_sel_cost(s_t, g_try), g_try))
        if s_t <= 2 * kk:  # already near the k floor; stop refining
            break
    _, group_eff = min(tried, key=lambda t: (t[0], -t[1]))
    lists, s_max = build(*certs[group_eff])
    ngroups_real = -(-npatch // group_eff)
    s_cap = int(min(-(-s_max // 8) * 8, nobs))
    ngroups_total = padded // group_eff
    cand = np.zeros((ngroups_total, s_cap), np.int32)
    mask = np.zeros((ngroups_total, s_cap), np.bool_)
    for g, lst in enumerate(lists):
        idx = np.sort(np.asarray(lst, np.int64))[:s_cap]
        cand[g, : idx.size] = idx
        mask[g, : idx.size] = True
    for g in range(ngroups_real, ngroups_total):  # device upad region
        cand[g] = cand[ngroups_real - 1]
        mask[g] = mask[ngroups_real - 1]
    return cand, mask, group_eff


# ---------------------------------------------------------------------------
# Batched SPD inverse / inverse-sqrt
# ---------------------------------------------------------------------------


def _invsqrt_newton_schulz(a, iters: int, precision=None):
    """Batched ``(A^{-1/2}, A^{-1})`` for SPD ``A [..., M, M]`` with pure
    matmuls (no eigendecomposition).

    Coupled Newton–Schulz (Denman–Beavers variant): scale ``A`` by an upper
    spectral bound c (max abs row sum), then iterate
    ``T = (3 I - Z Y) / 2;  Y <- Y T;  Z <- T Z`` which drives
    ``Y -> (A/c)^{1/2}`` and ``Z -> (A/c)^{-1/2}``.  Converges for any SPD
    matrix since ``0 < lambda/c <= 1``; the iteration count covers the
    linear phase ~log2(condition number) plus the quadratic tail.

    ``precision``: matmul precision of the iteration einsums (None =
    ambient).  At a reduced-precision default the iteration stalls at the
    input-rounding floor; ``Precision.HIGHEST`` converges to f32 at the
    cost of true-f32 matmuls (benchmarks/letkf_solve_precision_ab.py) —
    thread via ``letkf_update(solve_precision=...)``.
    """
    m = a.shape[-1]
    dtype = a.dtype
    eye = jnp.eye(m, dtype=dtype)
    c = jnp.max(jnp.sum(jnp.abs(a), axis=-1), axis=-1)  # [...]: inf-norm >= lmax
    c = jnp.maximum(c, jnp.asarray(1e-30, dtype))
    y = a / c[..., None, None]
    z = jnp.broadcast_to(eye, a.shape)

    # ``iters`` is the CAP; the loop exits as soon as the whole batch has
    # converged.  Converged means EITHER max |ZY - I| fell below ~100 eps
    # (the iteration's fixed point at nominal working precision) OR the
    # error entered the quadratic regime (err < 0.1 — in it, one exact
    # iteration SQUARES the error) yet failed to halve — i.e. it stalled
    # at the matmul-precision floor.  The stall test is what fires under
    # reduced-precision f32 einsums (TF32, bf16 passes): the floor sits
    # well above eps and the eps-based tolerance alone never triggers, so
    # the loop would run its full cap — iterating at the floor buys
    # nothing.  For well-conditioned LETKF systems
    # (lambda_min >= M-1 by construction) convergence lands around 8-12
    # iterations.  The stall test stays disabled above err = 0.1 because
    # small eigenvalues mu grow only ~2.25x per early iteration, so err
    # legitimately creeps near 1 through the linear phase.
    tol = jnp.asarray(100.0, dtype) * jnp.finfo(dtype).eps
    quad = jnp.asarray(0.1, dtype)

    def cond(state):
        i, _, _, err, prev = state
        stalled = jnp.logical_and(err < quad, err > 0.5 * prev)
        return jnp.logical_and(
            i < iters, jnp.logical_and(err > tol, jnp.logical_not(stalled))
        )

    def body(state):
        i, y, z, err, _ = state
        zy = jnp.einsum(
            "...ij,...jk->...ik", z, y, preferred_element_type=dtype,
            precision=precision,
        )
        new_err = jnp.max(jnp.abs(zy - eye))
        t = 1.5 * eye - 0.5 * zy
        y = jnp.einsum("...ij,...jk->...ik", y, t,
                       preferred_element_type=dtype, precision=precision)
        z = jnp.einsum("...ij,...jk->...ik", t, z,
                       preferred_element_type=dtype, precision=precision)
        return i + 1, y, z, new_err, err

    _, y, z, _, _ = jax.lax.while_loop(
        cond,
        body,
        (
            jnp.asarray(0),
            y,
            z,
            jnp.asarray(jnp.inf, dtype),
            jnp.asarray(jnp.inf, dtype),
        ),
    )
    inv_sqrt = z / jnp.sqrt(c)[..., None, None]
    inv = jnp.einsum(
        "...ij,...jk->...ik", inv_sqrt, inv_sqrt,
        preferred_element_type=dtype, precision=precision,
    )
    return inv_sqrt, inv


def _invsqrt_eigh(a):
    """Reference backend: batched eigendecomposition (exact, slower)."""
    e, v = jnp.linalg.eigh(a)
    e = jnp.maximum(e, jnp.asarray(1e-30, a.dtype))
    inv_sqrt = jnp.einsum(
        "...ij,...j,...kj->...ik", v, 1.0 / jnp.sqrt(e), v,
        preferred_element_type=a.dtype,
    )
    inv = jnp.einsum(
        "...ij,...j,...kj->...ik", v, 1.0 / e, v, preferred_element_type=a.dtype
    )
    return inv_sqrt, inv


# ---------------------------------------------------------------------------
# Per-patch ensemble-space solve
# ---------------------------------------------------------------------------


def solve_patch_weights(
    ye,  # [No, M] obs-space prior perturbations
    innov,  # [No] y - H(xbar), prior innovations
    rinv,  # [No] 1/R (already zeroed for non-assimilated obs)
    obs_xyz,  # [No, 3] unit vectors
    obs_radii,  # [No] GC halfwidth km (inf = no localization)
    patch_xyz,  # [P, 3] patch-centroid unit vectors
    idx,  # [P, K] local obs indices
    *,
    localize: bool = True,
    sqrt_method: str = "newton_schulz",
    ns_iters: int = 30,
    chunk: int = 512,
    patch_verts=None,  # [P] vertical coordinates (vertical mode)
    obs_verts=None,  # [No]
    obs_vert_radii=None,  # [No] vertical GC halfwidths (inf = off)
    solve_precision: str = "default",  # see _solve_precision_obj
    varloc=None,  # [nv(+1), nvars] cross-variable factors on rho
    obs_var=None,  # [No] int32 observed-variable index
    patch_var=None,  # [P] int32 analyzed-variable index per patch
) -> PatchWeights:
    """Solve the LETKF ensemble-space analysis for every patch.

    Math (Hunt et al. 2007, eqs. 20-23), per patch with local subsets:
        A    = (M-1) I + Y^T diag(rho / R) Y
        Pt   = A^{-1}
        wbar = Pt Y^T diag(rho / R) d
        W    = sqrt(M-1) A^{-1/2}            (symmetric square root)
    ``W 1 = 1`` exactly (perturbations stay centered) because ``Y 1 = 0``
    makes ``1`` an eigenvector of ``A`` with eigenvalue ``M-1``.
    """
    npatch, k = idx.shape
    nens = ye.shape[1]
    dtype = ye.dtype
    chunk = int(min(chunk, npatch))
    nchunks = -(-npatch // chunk)
    pad = nchunks * chunk - npatch
    idx_c = jnp.pad(idx, ((0, pad), (0, 0))).reshape(nchunks, chunk, k)
    pxyz_c = jnp.pad(patch_xyz, ((0, pad), (0, 0))).reshape(nchunks, chunk, 3)
    if patch_verts is None:
        pvert_c = jnp.zeros((nchunks, chunk), dtype=dtype)
    else:
        pvert_c = jnp.pad(
            patch_verts.astype(dtype), (0, pad)
        ).reshape(nchunks, chunk)
    use_vl = varloc is not None
    if use_vl:
        vl = jnp.asarray(varloc, dtype)
        ovar = jnp.asarray(obs_var, jnp.int32)
        pvar_c = jnp.pad(
            jnp.asarray(patch_var, jnp.int32), (0, pad)
        ).reshape(nchunks, chunk)
    else:
        pvar_c = jnp.zeros((nchunks, chunk), jnp.int32)

    eye = jnp.eye(nens, dtype=dtype)
    sprec = _solve_precision_obj(solve_precision)

    def one(args):
        ii, pxyz, pvert, pvar = args  # [C, K], [C, 3], [C], [C]
        yl = ye[ii]  # [C, K, M]
        dl = innov[ii]  # [C, K]
        a = rinv[ii]  # [C, K]
        if localize:
            rho = chordal_gc_weights(
                pxyz[:, None, :], obs_xyz[ii], obs_radii[ii]
            ).astype(dtype)
            if patch_verts is not None:
                rho = rho * gaspari_cohn(
                    jnp.abs(pvert[:, None] - obs_verts[ii]),
                    obs_vert_radii[ii],
                ).astype(dtype)
            a = a * rho
        if use_vl:
            # factor[c, k] = varloc[obs_var[ii[c,k]], patch_var[c]] — the
            # R-localization analog of the EnSRF's per-(row, ob) factor.
            a = a * jnp.take_along_axis(vl.T[pvar], ovar[ii], axis=1)
        ya = yl * a[..., None]  # [C, K, M]
        cmat = jnp.einsum(
            "ckm,ckn->cmn", ya, yl, preferred_element_type=dtype,
            precision=sprec,
        )
        amat = (nens - 1) * eye + cmat
        if sqrt_method == "eigh":
            inv_sqrt, inv = _invsqrt_eigh(amat)
        else:
            inv_sqrt, inv = _invsqrt_newton_schulz(amat, ns_iters,
                                                   precision=sprec)
        b = jnp.einsum("ckm,ck->cm", ya, dl, preferred_element_type=dtype,
                       precision=sprec)
        wbar = jnp.einsum("cmn,cn->cm", inv, b, preferred_element_type=dtype,
                          precision=sprec)
        transform = jnp.sqrt(jnp.asarray(nens - 1, dtype)) * inv_sqrt
        return wbar, transform

    with jax.named_scope("letkf/solve"):
        wbar, transform = jax.lax.map(one, (idx_c, pxyz_c, pvert_c, pvar_c))
    wbar = wbar.reshape(nchunks * chunk, nens)[:npatch]
    transform = transform.reshape(nchunks * chunk, nens, nens)[:npatch]
    return PatchWeights(wbar=wbar, transform=transform)


# ---------------------------------------------------------------------------
# Patch geometry + weight application
# ---------------------------------------------------------------------------


def apply_patch_weights(body_mean, body_perts, weights: PatchWeights,
                        ngrid: int, patch_size: int):
    """Transform the state body by per-patch weights: one batched matmul.

    Rows are ``(var, time, grid)`` C-order (``StateStructure.row_latlon``);
    all VT = nvars*ntimes copies of a grid point share its patch weights
    (exact for horizontal localization).
    """
    nrows, nens = body_perts.shape
    vt = nrows // ngrid
    npatch = weights.wbar.shape[0]
    pad = npatch * patch_size - ngrid
    dtype = body_perts.dtype

    xm = body_mean.reshape(vt, ngrid)
    xp = body_perts.reshape(vt, ngrid, nens)
    if pad:
        xm = jnp.pad(xm, ((0, 0), (0, pad)))
        xp = jnp.pad(xp, ((0, 0), (0, pad), (0, 0)))
    xm = xm.reshape(vt, npatch, patch_size)
    xp = xp.reshape(vt, npatch, patch_size, nens)

    with jax.named_scope("letkf/apply"):
        post_mean = xm + jnp.einsum(
            "vpsm,pm->vps", xp, weights.wbar.astype(dtype),
            preferred_element_type=dtype,
        )
        post_perts = jnp.einsum(
            "vpsm,pmk->vpsk", xp, weights.transform.astype(dtype),
            preferred_element_type=dtype,
        )
    post_mean = post_mean.reshape(vt, npatch * patch_size)[:, :ngrid]
    post_perts = post_perts.reshape(vt, npatch * patch_size, nens)[:, :ngrid]
    return post_mean.reshape(nrows), post_perts.reshape(nrows, nens)


# ---------------------------------------------------------------------------
# Fused select -> solve -> apply sweep (the production body path)
# ---------------------------------------------------------------------------


def _analyze_body_chunked(
    body_mean,  # [Ns]
    body_perts,  # [Ns, M]
    ye,  # [No, M]
    innov,  # [No]
    rinv,  # [No]
    obs_xyz,  # [No, 3]
    obs_radii,  # [No]
    grid_xyz,  # [G, 3]
    *,
    ngrid: int,
    patch_size: int,
    k_obs: int,
    sqrt_method: str,
    ns_iters: int,
    chunk: int,
    group_vert=None,  # [VT] per-group vertical coordinate (vertical mode)
    obs_verts=None,  # [No]
    obs_vert_radii=None,  # [No]
    topk_method: str = "exact",
    solve_precision: str = "default",  # see _solve_precision_obj
    sel_cand=None,  # [Gn, S] host-certified candidate obs (topk "host")
    sel_mask=None,  # [Gn, S] candidate validity
    sel_group: int = 0,  # patches per candidate group (static)
    varloc=None,  # [nv(+1), nvars] cross-variable factors on rho
    obs_var=None,  # [No] int32
    group_var=None,  # [VT] int32 state-variable index per group (vertical
    # mode only — variable-dependent rho needs per-group solves)
):
    """Localized LETKF body analysis, one ``lax.map`` over patch chunks.

    Each chunk runs the full pipeline — nearest-k obs selection, rho
    weighting, ensemble-space solve, weight application — so the per-patch
    ``[M, M]`` transforms live only in the chunk's working set and the
    whole-state footprint stays at O(state), never O(npatch * M^2)
    (at pod scale the materialized transforms would be tens of GB).

    Horizontal-only mode (``group_vert=None``): one solve per spatial
    patch, shared by all VT = nvars*ntimes copies of its rows (exact).
    Vertical mode: rho gains a vertical Gaspari-Cohn factor, which differs
    per level, so the solve runs per (group, patch) — VT times the solves,
    rows laid out ``[(VT * P), S, M]`` with no transpose (the flat state is
    already (group, grid) C-order).
    """
    nens = body_perts.shape[1]
    dtype = body_perts.dtype
    nrows = body_mean.shape[0]
    vt = nrows // ngrid
    k = int(min(k_obs, ye.shape[0]))
    vertical = group_vert is not None

    npatch = -(-ngrid // patch_size)
    gpad = npatch * patch_size - ngrid

    xm = body_mean.reshape(vt, ngrid)
    xp = body_perts.reshape(vt, ngrid, nens)
    gx = grid_xyz
    if gpad:
        xm = jnp.pad(xm, ((0, 0), (0, gpad)))
        xp = jnp.pad(xp, ((0, 0), (0, gpad), (0, 0)))
        gx = jnp.concatenate([gx, jnp.repeat(gx[-1:], gpad, axis=0)], axis=0)
    pxyz = gx.reshape(npatch, patch_size, 3).mean(axis=1)
    pxyz = pxyz / jnp.maximum(
        jnp.linalg.norm(pxyz, axis=-1, keepdims=True), 1e-12
    )

    use_vl = varloc is not None
    if use_vl and not vertical:
        raise ValueError(
            "varloc needs the per-(group, patch) unit layout; callers set "
            "vertical=True with zero group verticals when only variable "
            "localization is active (letkf_update does this)"
        )
    if vertical:
        # One analysis unit per (group, patch): [U = VT*P, S(, M)] slabs.
        nunits = vt * npatch
        xm = xm.reshape(nunits, patch_size)
        xp = xp.reshape(nunits, patch_size, nens)
        pxyz = jnp.tile(pxyz, (vt, 1))
        pvert = jnp.repeat(group_vert.astype(dtype), npatch)
        uvar = (jnp.repeat(jnp.asarray(group_var, jnp.int32), npatch)
                if use_vl else jnp.zeros(nunits, jnp.int32))
    else:
        # One unit per spatial patch, applied across all VT groups.
        nunits = npatch
        xm = xm.reshape(vt, npatch, patch_size).transpose(1, 0, 2)
        xp = xp.reshape(vt, npatch, patch_size, nens).transpose(1, 0, 2, 3)
        pvert = jnp.zeros(nunits, dtype=dtype)
        uvar = jnp.zeros(nunits, jnp.int32)

    chunk = int(min(chunk, nunits))
    nchunks = -(-nunits // chunk)
    upad = nchunks * chunk - nunits
    if upad:
        pad1 = ((0, upad),) + ((0, 0),) * (xm.ndim - 1)
        pad2 = ((0, upad),) + ((0, 0),) * (xp.ndim - 1)
        xm = jnp.pad(xm, pad1)
        xp = jnp.pad(xp, pad2)
        pxyz = jnp.pad(pxyz, ((0, upad), (0, 0)))
        pvert = jnp.pad(pvert, (0, upad))
        uvar = jnp.pad(uvar, (0, upad))

    xm = xm.reshape((nchunks, chunk) + xm.shape[1:])
    xp = xp.reshape((nchunks, chunk) + xp.shape[1:])
    pxyz = pxyz.reshape(nchunks, chunk, 3)
    pvert = pvert.reshape(nchunks, chunk)
    uvar = uvar.reshape(nchunks, chunk)
    eye = jnp.eye(nens, dtype=dtype)
    sprec = _solve_precision_obj(solve_precision)
    if use_vl:
        vlm = jnp.asarray(varloc, dtype)
        ovar_arr = jnp.asarray(obs_var, jnp.int32)

    host_sel = topk_method == "host"
    if host_sel:
        if vertical:
            raise ValueError(
                "letkf_topk='host' supports horizontal-only localization; "
                "use 'exact' or 'approx' with vertical localization"
            )
        if sel_cand is None or sel_mask is None or sel_group <= 0:
            raise ValueError(
                "letkf_topk='host' needs sel_cand/sel_mask/sel_group from "
                "host_select_candidates"
            )
        if chunk % sel_group:
            raise ValueError(
                f"sel_group {sel_group} must divide the effective chunk "
                f"{chunk} (host_select_candidates guarantees this when "
                f"given the same chunk/patch geometry)"
            )
        gpc = chunk // sel_group
        nsc = sel_cand.shape[-1]
        if sel_cand.shape[0] != nchunks * gpc:
            raise ValueError(
                f"sel_cand has {sel_cand.shape[0]} groups, geometry needs "
                f"{nchunks * gpc} (stale candidates for this grid/chunk?)"
            )
        if nsc < k:
            raise ValueError(f"candidate width {nsc} < k {k}")
        sel_cand = sel_cand.reshape(nchunks, gpc, nsc)
        sel_mask = sel_mask.reshape(nchunks, gpc, nsc)
    else:
        # dummies so lax.map's xs pytree is static across modes
        sel_cand = jnp.zeros((nchunks, 1, 1), jnp.int32)
        sel_mask = jnp.zeros((nchunks, 1, 1), jnp.bool_)

    def one(args):
        xm_c, xp_c, px, pv, uv, cand_c, mask_c = args
        if host_sel:
            # Exact selection rescoped to the certified candidates: the
            # same HIGHEST-precision chordal dots, top_k over S << No.
            oc = obs_xyz[cand_c]  # [G, S, 3]
            pxg = px.reshape(gpc, sel_group, 3)
            dg = jnp.einsum(
                "gpc,gsc->gps", pxg, oc,
                preferred_element_type=jnp.float32,
                precision=jax.lax.Precision.HIGHEST,
            )
            dg = jnp.where(mask_c[:, None, :], dg, -jnp.inf)
            _, pos = jax.lax.top_k(dg, k)  # [G, P, K]
            ii = jnp.take_along_axis(
                jnp.broadcast_to(cand_c[:, None, :], (gpc, sel_group, nsc)),
                pos, axis=-1,
            ).reshape(chunk, k)
        else:
            # precision=HIGHEST: rounded dot inputs would mis-rank the
            # nearest-k selection by hundreds of km — see select_local_obs.
            dots = jnp.einsum(
                "pc,oc->po", px, obs_xyz,
                preferred_element_type=jnp.float32,
                precision=jax.lax.Precision.HIGHEST,
            )
            _, ii = _top_k(dots, k, topk_method)  # [C, K]
        yl = ye[ii]  # [C, K, M]
        rho = chordal_gc_weights(
            px[:, None, :], obs_xyz[ii], obs_radii[ii]
        ).astype(dtype)
        if vertical:
            rho = rho * gaspari_cohn(
                jnp.abs(pv[:, None] - obs_verts[ii]), obs_vert_radii[ii]
            ).astype(dtype)
        a = rinv[ii] * rho  # [C, K]
        if use_vl:
            # factor[c, k] = varloc[obs_var[ii[c,k]], unit_var[c]]
            a = a * jnp.take_along_axis(vlm.T[uv], ovar_arr[ii], axis=1)
        ya = yl * a[..., None]
        cmat = jnp.einsum("ckm,ckn->cmn", ya, yl,
                          preferred_element_type=dtype, precision=sprec)
        amat = (nens - 1) * eye + cmat
        if sqrt_method == "eigh":
            inv_sqrt, inv = _invsqrt_eigh(amat)
        else:
            inv_sqrt, inv = _invsqrt_newton_schulz(amat, ns_iters,
                                                   precision=sprec)
        b = jnp.einsum("ckm,ck->cm", ya, innov[ii],
                       preferred_element_type=dtype, precision=sprec)
        wbar = jnp.einsum("cmn,cn->cm", inv, b, preferred_element_type=dtype,
                          precision=sprec)
        w = jnp.sqrt(jnp.asarray(nens - 1, dtype)) * inv_sqrt
        if vertical:
            pm = xm_c + jnp.einsum(
                "csm,cm->cs", xp_c, wbar, preferred_element_type=dtype
            )
            pp = jnp.einsum(
                "csm,cmk->csk", xp_c, w, preferred_element_type=dtype
            )
        else:
            pm = xm_c + jnp.einsum(
                "cvsm,cm->cvs", xp_c, wbar, preferred_element_type=dtype
            )
            pp = jnp.einsum(
                "cvsm,cmk->cvsk", xp_c, w, preferred_element_type=dtype
            )
        return pm, pp

    with jax.named_scope("letkf/body_sweep"):
        pm, pp = jax.lax.map(
            one, (xm, xp, pxyz, pvert, uvar, sel_cand, sel_mask))

    pm = pm.reshape((nchunks * chunk,) + pm.shape[2:])[:nunits]
    pp = pp.reshape((nchunks * chunk,) + pp.shape[2:])[:nunits]
    if vertical:
        pm = pm.reshape(vt, npatch * patch_size)[:, :ngrid]
        pp = pp.reshape(vt, npatch * patch_size, nens)[:, :ngrid]
    else:
        pm = pm.transpose(1, 0, 2).reshape(vt, npatch * patch_size)[:, :ngrid]
        pp = pp.transpose(1, 0, 2, 3).reshape(
            vt, npatch * patch_size, nens
        )[:, :ngrid]
    return pm.reshape(nrows), pp.reshape(nrows, nens)


# ---------------------------------------------------------------------------
# Full update
# ---------------------------------------------------------------------------


@functools.partial(
    jax.jit,
    static_argnames=(
        "ngrid", "patch_size", "k_obs", "localize", "sqrt_method",
        "ns_iters", "chunk", "vertical", "topk_method", "unbiased",
        "solve_precision", "sel_group",
    ),
)
def letkf_update(
    body_mean,  # [Ns]
    body_perts,  # [Ns, M]
    tail_mean,  # [No] obs-space prior means
    tail_perts,  # [No, M]
    grid_lat,  # [G] ONE copy of the spatial grid (not tiled over vars/times)
    grid_lon,  # [G]
    obs: ObsArrays,
    *,
    ngrid: int,
    patch_size: int = 1,
    k_obs: int = 64,
    localize: bool = True,
    sqrt_method: str = "newton_schulz",
    ns_iters: int = 30,
    chunk: int = 512,
    vertical: bool = False,
    body_vert=None,  # [Ns]; each (var,time) group must sit at ONE level
    topk_method: str = "exact",
    unbiased: bool = False,
    solve_precision: str = "default",  # ensemble-space solve matmul
    # precision: "default" (ambient — TF32 on a GPU, NS floor set by the
    # input rounding), "high" or "highest" (true f32 fixed point ~1e-5);
    # see _solve_precision_obj
    sel_cand=None,  # [Gn, S] topk_method="host": certified candidates
    sel_mask=None,  # [Gn, S]
    sel_group: int = 0,  # patches per candidate group (static)
    varloc=None,  # [nv(+1), nvars] cross-variable localization factors —
    # multiplies rho per (analyzed variable, observed variable); the
    # R-localization analog of the EnSRF's gain factor.  Forces
    # per-(group, patch) solves (the vertical-mode unit layout), since a
    # variable-dependent rho breaks the shared-solve-per-column trick.
    ob_var=None,  # [No] int32
    group_var=None,  # [VT] int32 variable index per (var, time) group
):
    """One simultaneous LETKF analysis of all observations.

    Returns ``(body_mean, body_perts, tail_mean, tail_perts, diags)`` —
    the same contract as :func:`efa_xray_tpu.assimilation.ensrf_core.ensrf_serial`.

    With ``localize=False`` every patch sees every observation with weight
    one, which reduces to the global ETKF; the analysis mean and covariance
    then match the serial EnSRF (with ``unbiased=True``) exactly.
    """
    nens = body_perts.shape[1]
    dtype = body_perts.dtype
    nobs = obs.values.shape[0]
    if nobs == 0:
        return body_mean, body_perts, tail_mean, tail_perts, _empty_diags(dtype)

    innov = (obs.values.astype(dtype) - tail_mean).astype(dtype)
    # Clamp R away from zero: the solver-class path already rejects
    # non-positive error variances (utils/validation.py:51-55), but direct
    # core callers could otherwise feed rinv = inf into C and the
    # inverse-sqrt solve.  The serial EnSRF tolerates R = 0 (kdenom stays
    # finite); the floor keeps the solvers on one finite-output contract
    # for degenerate obs errors while leaving any validated input intact.
    r_floor = jnp.asarray(jnp.finfo(dtype).tiny, dtype)
    rinv = jnp.where(
        obs.assim,
        1.0 / jnp.maximum(obs.errors.astype(dtype), r_floor),
        jnp.zeros((), dtype),
    )
    obs_xyz = latlon_to_unit(obs.lats, obs.lons).astype(dtype)
    radii = obs.radii.astype(dtype)
    vertical = bool(vertical and localize and body_vert is not None)
    if vertical:
        obs = obs.with_default_verts()
        overts = obs.verts.astype(dtype)
        ovrad = obs.vert_radii.astype(dtype)
        vt = body_mean.shape[0] // ngrid
        group_vert = body_vert.reshape(vt, ngrid)[:, 0].astype(dtype)
    else:
        overts = ovrad = group_vert = None

    use_vl = varloc is not None
    if use_vl:
        if not localize:
            raise ValueError(
                "varloc needs localization (the unlocalized global ETKF "
                "is one shared solve — a variable-dependent rho cannot "
                "apply)"
            )
        if topk_method == "host":
            raise ValueError(
                "letkf_topk='host' does not combine with varloc (the "
                "per-(group, patch) unit layout); use 'exact' or 'approx'"
            )
        if ob_var is None or group_var is None:
            raise ValueError("varloc needs ob_var and group_var")
        if not vertical:
            # Variable-dependent rho needs per-group solves: activate the
            # vertical unit layout with zero verticals (vert radii default
            # to inf, so the vertical GC factor is exactly 1).
            vertical = True
            obs = obs.with_default_verts()
            overts = obs.verts.astype(dtype)
            ovrad = obs.vert_radii.astype(dtype)
            vt = body_mean.shape[0] // ngrid
            group_vert = jnp.zeros(vt, dtype)

    solve = functools.partial(
        solve_patch_weights,
        tail_perts,
        innov,
        rinv,
        obs_xyz,
        radii,
        localize=localize,
        sqrt_method=sqrt_method,
        ns_iters=ns_iters,
        chunk=chunk,
        obs_verts=overts,
        obs_vert_radii=ovrad,
        solve_precision=solve_precision,
        varloc=varloc,
        obs_var=ob_var,
    )

    if localize:
        grid_xyz = latlon_to_unit(
            grid_lat.astype(dtype), grid_lon.astype(dtype)
        ).astype(dtype)
        bm, bp = _analyze_body_chunked(
            body_mean,
            body_perts,
            tail_perts,
            innov,
            rinv,
            obs_xyz,
            radii,
            grid_xyz,
            ngrid=ngrid,
            patch_size=patch_size,
            k_obs=k_obs,
            sqrt_method=sqrt_method,
            ns_iters=ns_iters,
            chunk=chunk,
            group_vert=group_vert,
            obs_verts=overts,
            obs_vert_radii=ovrad,
            topk_method=topk_method,
            solve_precision=solve_precision,
            sel_cand=sel_cand,
            sel_mask=sel_mask,
            sel_group=sel_group,
            varloc=varloc,
            obs_var=ob_var,
            group_var=group_var,
        )
    else:
        # Global ETKF: one patch covering the whole grid, all obs, rho = 1.
        pxyz = jnp.zeros((1, 3), dtype=dtype).at[0, 2].set(1.0)
        idx = jnp.arange(nobs, dtype=jnp.int32)[None, :]
        weights = solve(pxyz, idx)
        bm, bp = apply_patch_weights(body_mean, body_perts, weights,
                                     ngrid=ngrid, patch_size=ngrid)

    # Observation-space posterior (diagnostics + tail return): each ob's
    # location is its own patch, so H(x^a) transforms with local weights
    # evaluated exactly at the ob (reference records these per ob:
    # ``efa_xray/assimilation/ensrf.py:144-149``).
    if localize:
        ob_idx = select_local_obs(obs_xyz, obs_xyz, k_obs)
        ob_weights = solve(
            obs_xyz, ob_idx,
            patch_verts=overts if vertical else None,
            # each ob's own patch analyzes its OWN observed variable
            patch_var=ob_var if use_vl else None,
        )
    else:
        ob_weights = PatchWeights(
            wbar=jnp.broadcast_to(weights.wbar, (nobs, nens)),
            transform=jnp.broadcast_to(weights.transform, (nobs, nens, nens)),
        )
    tm = tail_mean + jnp.einsum(
        "om,om->o", tail_perts, ob_weights.wbar, preferred_element_type=dtype
    )
    tp = jnp.einsum(
        "om,omk->ok", tail_perts, ob_weights.transform,
        preferred_element_type=dtype,
    )

    # Diagnostic variances follow the SAME ddof convention as the EnSRF
    # (``ensrf_core._ye_var`` honoring cfg.unbiased_variance, default
    # ddof=0) so AdaptiveInflation / Desroziers statistics are comparable
    # across solvers.  The ensemble-space solve itself is inherently
    # ddof=1 (ETKF math) and is unaffected.
    var_denom = (nens - 1) if unbiased else nens
    prior_var = jnp.sum(tail_perts**2, axis=1) / var_denom
    post_var = jnp.sum(tp**2, axis=1) / var_denom
    diags = ObsDiagnostics(
        prior_mean=tail_mean,
        prior_var=prior_var,
        post_mean=jnp.where(obs.assim, tm, jnp.nan),
        post_var=jnp.where(obs.assim, post_var, jnp.nan),
        assimilated=obs.assim,
    )
    return bm, bp, tm, tp, diags
