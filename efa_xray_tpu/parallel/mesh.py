"""Device-mesh helpers.

Replacement for the reference's multiprocessing layout
(``efa_xray/assimilation/assimilation.py:176-230``,
``efa_xray/state/ensemble.py:59-107``): instead of pickling state chunks
through an ``mp.Queue``, the flattened state dimension is sharded over a
``jax.sharding.Mesh`` (ICI within a slice, DCN across slices) and the
observation-space tail is replicated — the two collectives the reference
needed (broadcast obs priors, gather chunks) become sharding annotations.
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

STATE_AXIS = "state"


def make_mesh(devices: Optional[Sequence] = None, axis_name: str = STATE_AXIS) -> Mesh:
    """A 1-D mesh over all (or the given) devices, named for the state axis."""
    if devices is None:
        devices = jax.devices()
    return Mesh(np.asarray(devices), (axis_name,))


def pad_to_multiple(n: int, multiple: int) -> int:
    return -(-n // multiple) * multiple


def pad_rows(arr, target_rows: int, fill=0.0):
    """Pad leading (state-row) dimension up to ``target_rows``."""
    pad = target_rows - arr.shape[0]
    if pad == 0:
        return arr
    widths = [(0, pad)] + [(0, 0)] * (arr.ndim - 1)
    return jnp.pad(arr, widths, constant_values=fill)


def shard_state_array(data, mesh: Mesh, axis_name: str = STATE_AXIS):
    """Place a dense ``[vars, times, y, x, mems]`` state array on the mesh,
    sharded along the first evenly-divisible state dimension (preferring the
    largest: y, then x, then time, then var).  Falls back to replication —
    the sharded update path does its own padded flat-row sharding either
    way; this is a memory-placement convenience."""
    ndev = mesh.shape[axis_name]
    if data.ndim == 2:  # flattened [nstate, nmems]
        candidates = [0]
    else:
        candidates = [2, 3, 1, 0]
    for axis in candidates:
        if axis < data.ndim and data.shape[axis] % ndev == 0:
            spec_axes = [None] * data.ndim
            spec_axes[axis] = axis_name
            return jax.device_put(data, NamedSharding(mesh, P(*spec_axes)))
    return jax.device_put(data, NamedSharding(mesh, P(*([None] * data.ndim))))
