"""Shared plumbing for the demo scripts in ``examples/``.

Every example is a demo-scale problem (tiny grids, thousands of small RK4
steps, matplotlib output).  By default (``--platform keep``) the examples
run on whatever device JAX picks; ``--platform cpu`` pins the host CPU.
"""

from __future__ import annotations


def add_platform_arg(ap) -> None:
    """Add the common ``--platform`` option to an argparse parser."""
    ap.add_argument(
        "--platform",
        default="keep",
        choices=["cpu", "keep"],
        help="jax platform: 'keep' the default device (default) or pin "
        "the host cpu",
    )


def apply_platform(args) -> None:
    """Pin jax to ``args.platform`` (no-op for ``keep``).  Must run
    before the first jax computation of the process; if a backend is
    already live (e.g. the example's ``main()`` is driven from a test
    process), an already-matching platform passes silently and a
    mismatch raises with a clear message."""
    platform = getattr(args, "platform", "keep")
    if platform == "keep":
        return
    import jax

    try:
        jax.config.update("jax_platforms", platform)
    except RuntimeError:
        if jax.default_backend() != platform:
            raise RuntimeError(
                f"jax already initialized on {jax.default_backend()!r}; "
                f"cannot switch to {platform!r} — pass --platform keep"
            )
