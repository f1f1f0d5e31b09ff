"""Every performance number the docs cite must have a committed raw point.

A manifest of (cited number, where it is cited) -> (results file,
selector, key) triples.  Editing a doc number without committing the raw
measurement point breaks the build.  The raw points are H100 runs of
``chip_smoke.py`` and of the kernel-vs-XLA probe, in
``benchmarks/results_h100.json``; each entry names its card and power
limit.

The manifest lists the CURRENT citations; when a number is re-measured
and the doc updated, update the manifest entry in the same commit as the
doc.
"""

from __future__ import annotations

import json
import os
import re

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load(fname):
    with open(os.path.join(ROOT, "benchmarks", fname)) as f:
        return json.load(f)


def _find(entries, **match):
    out = []
    for e in entries:
        if all(e.get(k) == v for k, v in match.items()):
            out.append(e)
    return out


# (cited value, rel tolerance, doc location, results file, selector dict,
#  value extractor)
_KVX = {"config": "kernel-vs-xla-headline"}
_SMOKE = {"config": "chip-smoke"}
MANIFEST = [
    (0.281, 0.02, "README body kernel 0.281 s", "results_h100.json", _KVX,
     lambda e: e["body_kernel_seconds"]),
    (25.3, 0.02, "README XLA body 25.3 s", "results_h100.json", _KVX,
     lambda e: e["body_xla_block128_seconds"]),
    (0.039, 0.03, "README tail kernels 0.039 s", "results_h100.json", _KVX,
     lambda e: e["tail_kernels_panel64_seconds"]),
    (0.269, 0.02, "README XLA tail 0.269 s", "results_h100.json", _KVX,
     lambda e: e["tail_xla_panel64_seconds"]),
    (0.18, 0.05, "README cull alive fraction 18%", "results_h100.json", _KVX,
     lambda e: e["cull_alive_fraction"]),
    (0.385, 0.02, "README headline update 0.385 s", "results_h100.json",
     _SMOKE, lambda e: e["headline_exact_kernel_update_steady_seconds"]),
    (0.397, 0.02, "README fast-geometry update 0.397 s", "results_h100.json",
     _SMOKE,
     lambda e: e["headline_fast_geometry_kernel_update_steady_seconds"]),
    (0.284, 0.02, "README LETKF config-2 0.284 s", "results_h100.json",
     _SMOKE, lambda e: e["letkf_config2_steady_seconds"]),
    (1.5e-3, 0.05, "README kernel vs XLA 1.5e-3 of the increment",
     "results_h100.json", _SMOKE,
     lambda e: e["checks"]["kernel_vs_xla_mean_default"]),
    (2.4e-4, 0.05, "README kernel vs XLA 2.4e-4 at highest",
     "results_h100.json", _SMOKE,
     lambda e: e["checks"]["kernel_vs_xla_mean_highest"]),
]


@pytest.mark.parametrize(
    "cited,tol,where,fname,selector,extract", MANIFEST,
    ids=[m[2] for m in MANIFEST])
def test_cited_number_has_committed_raw_point(cited, tol, where, fname,
                                              selector, extract):
    entries = _load(fname)
    matches = _find(entries, **selector)
    assert matches, f"{where}: no entry matching {selector} in {fname}"
    vals = []
    for e in matches:
        try:
            vals.append(float(extract(e)))
        except (KeyError, StopIteration):
            continue
    assert vals, f"{where}: matching entries lack the cited value"
    best = min(vals, key=lambda v: abs(v - cited))
    assert abs(best - cited) <= tol * cited, (
        f"{where}: cited {cited} but committed raw point(s) say {vals} "
        f"({fname} {selector}) — update the doc and this manifest together"
    )


def test_results_files_cited_in_docs_exist():
    """Any results_*.json / MULTICHIP_r*.json / BENCH_r*.json filename
    mentioned in README or docs/ must exist in the repo."""
    docs = [os.path.join(ROOT, "README.md")]
    for d in os.listdir(os.path.join(ROOT, "docs")):
        docs.append(os.path.join(ROOT, "docs", d))
    pat = re.compile(
        r"(results_[a-z0-9_]+\.json|MULTICHIP_r\d+\.json|BENCH_r\d+\.json)")
    missing = []
    for doc in docs:
        with open(doc) as f:
            text = f.read()
        for m in set(pat.findall(text)):
            for base in ("benchmarks", "."):
                if os.path.exists(os.path.join(ROOT, base, m)):
                    break
            else:
                missing.append(f"{os.path.basename(doc)} -> {m}")
    assert not missing, f"docs cite uncommitted artifacts: {missing}"
