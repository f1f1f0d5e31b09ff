"""The one place that decides which implementation runs each EnSRF phase.

Two kernel families exist: the plain XLA programs of
:mod:`efa_xray_tpu.assimilation.ensrf_core`, which compile for every
backend, and the Triton kernels of this package (the phase-2 body sweep,
:mod:`~efa_xray_tpu.ops.ensrf_triton`, and the phase-1 panel solve,
:mod:`~efa_xray_tpu.ops.tail_solve_triton`), which compile only for a
CUDA GPU.  The rules:

* the platform is the one the update's arrays land on: the default
  device when one is set (the host fast path sets the CPU), else JAX's
  default backend;
* on a GPU, a blocked float32 update takes the kernels (each won end to
  end on an H100 against the XLA body and tail it replaces); elsewhere,
  and for ``method="serial"`` or float64, the XLA programs run;
* ``FilterConfig.use_pallas`` / ``tail_pallas`` force a choice either
  way;
* a kernel on a platform that cannot compile it is an error, unless the
  caller passes ``interpret=True`` (tests: the Pallas interpreter runs
  the same kernels on the CPU).  Interpret mode is never inferred.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp


class Kernels(NamedTuple):
    body: bool  # Triton phase-2 body kernel (else ensrf_blocked_body)
    tail: bool  # Triton panel solve + body-kernel panel apply
    interpret: bool  # run the kernels in the Pallas interpreter


def platform() -> str:
    """Platform new uncommitted arrays land on: an active
    ``jax.default_device`` (a Device or a platform string; the host fast
    path runs whole updates under one), else the default backend."""
    dev = jax.config.jax_default_device
    if dev is not None:
        return dev if isinstance(dev, str) else dev.platform
    return jax.default_backend()


def choose(cfg, *, interpret: bool = False) -> Kernels:
    """Kernel choice for one update under ``cfg`` (a FilterConfig)."""
    on_gpu = platform() == "gpu"
    blocked = cfg.method == "blocked"
    auto = on_gpu and blocked and jnp.dtype(cfg.dtype) == jnp.float32
    body = blocked and (auto if cfg.use_pallas is None
                        else bool(cfg.use_pallas))
    if cfg.tail_pallas is None:
        tail = body and cfg.hybrid_alpha >= 1.0
    else:
        tail = blocked and bool(cfg.tail_pallas)
    if (body or tail) and not (on_gpu or interpret):
        raise ValueError(
            "the Triton kernels compile only for a CUDA GPU; on "
            f"{platform()!r} leave use_pallas/tail_pallas unset"
        )
    return Kernels(body=body, tail=tail, interpret=bool(interpret))
