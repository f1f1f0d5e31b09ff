"""FilterConfig JSON persistence (save/load + CLI --config).

The reference has no config system at all (loose kwargs; SURVEY.md §5.6);
this covers the reproducible-run config-file layer: minimal non-default
serialization, non-JSON field conversion, typo safety, override
precedence, and the CLI path.
"""

import json

import numpy as np
import pytest

from efa_xray_tpu.config import FilterConfig


def test_roundtrip_non_default_fields(tmp_path):
    cfg = FilterConfig(
        method="serial",
        dtype="float64",
        outlier_threshold=3.5,
        rtps_alpha=0.4,
        letkf_k_obs=32,
        variable_localization={("T2m", "PS"): 0.0},
    )
    path = str(tmp_path / "cfg.json")
    cfg.save(path)

    with open(path) as fh:
        data = json.load(fh)
    # minimal: defaults are not written
    assert "block_size" not in data and "tail_panel" not in data
    # tuple keys stringified
    assert data["variable_localization"] == {"T2m:PS": 0.0}

    back = FilterConfig.load(path)
    assert back.method == "serial"
    assert back.dtype == "float64"
    assert back.outlier_threshold == 3.5
    assert back.rtps_alpha == 0.4
    assert back.letkf_k_obs == 32
    assert back.variable_localization == {"T2m:PS": 0.0}
    # untouched fields keep their defaults
    assert back.block_size == FilterConfig().block_size


def test_array_static_b_sigma_serializes(tmp_path):
    sigma = np.linspace(0.5, 1.5, 7)
    cfg = FilterConfig(
        hybrid_alpha=0.6, static_b_sigma=sigma, static_b_length=1000.0
    )
    path = str(tmp_path / "cfg.json")
    cfg.save(path)
    back = FilterConfig.load(path)
    np.testing.assert_allclose(np.asarray(back.static_b_sigma), sigma)
    assert back.hybrid_alpha == 0.6


def test_unknown_key_raises(tmp_path):
    path = str(tmp_path / "cfg.json")
    with open(path, "w") as f:
        json.dump({"outlier_treshold": 3.0}, f)  # typo
    with pytest.raises(ValueError, match="outlier_treshold"):
        FilterConfig.load(path)


@pytest.mark.parametrize("field,value", [
    ("pallas_tile", 8192), ("mxu_bf16", True),
    ("small_host_threshold", 4_000_000),
])
def test_old_config_with_removed_field_loads(tmp_path, field, value):
    """Config files written by older versions keep loading: fields this
    version dropped are ignored with a warning, the rest applies."""
    path = str(tmp_path / "cfg.json")
    with open(path, "w") as f:
        json.dump({field: value, "rtps_alpha": 0.3}, f)
    with pytest.warns(UserWarning, match=field):
        cfg = FilterConfig.load(path)
    assert cfg.rtps_alpha == 0.3
    assert not hasattr(cfg, field)


def test_load_applies_validation_and_overrides(tmp_path):
    path = str(tmp_path / "cfg.json")
    with open(path, "w") as f:
        json.dump({"rtps_alpha": 0.3}, f)
    # overrides win over the file
    cfg = FilterConfig.load(path, rtps_alpha=0.0, rtpp_alpha=0.5)
    assert cfg.rtps_alpha == 0.0 and cfg.rtpp_alpha == 0.5
    # validation still runs (rtps+rtpp exclusive)
    with open(path, "w") as f:
        json.dump({"rtps_alpha": 0.3, "rtpp_alpha": 0.2}, f)
    with pytest.raises(ValueError):
        FilterConfig.load(path)


def test_full_dump_includes_defaults():
    d = FilterConfig().to_dict(full=True)
    assert d["block_size"] == 128 and d["method"] == "blocked"


def test_cli_config_file(tmp_path, capsys):
    import csv

    from conftest import make_demo_state
    from efa_xray_tpu import cli
    from efa_xray_tpu.utils import timeutil

    state = make_demo_state(ny=6, nx=8, nmems=16, seed=8)
    prior_nc = tmp_path / "prior.nc"
    state.save_to_disk(str(prior_nc))
    s = state.structure
    rng = np.random.default_rng(5)
    obs_csv = tmp_path / "obs.csv"
    with open(obs_csv, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["value", "lat", "lon", "time", "obtype", "error"])
        for i in range(5):
            value = 380.0 if i == 2 else 280.0 + rng.normal(0, 2)
            t = timeutil.to_datetime64(int(s.times_s[i % s.ntimes]))
            w.writerow([
                f"{value:.3f}",
                f"{rng.uniform(s.lat.min() + 0.5, s.lat.max() - 0.5):.4f}",
                f"{rng.uniform(s.lon.min() + 0.5, s.lon.max() - 0.5):.4f}",
                str(t), s.var_names[0], "1.0",
            ])
    cfg_json = tmp_path / "cfg.json"
    FilterConfig(outlier_threshold=10.0, dtype="float64").save(str(cfg_json))

    out_nc = tmp_path / "post.nc"
    rc = cli.main([
        "assimilate", "--state", str(prior_nc), "--obs", str(obs_csv),
        "--out", str(out_nc), "--radius", "2000",
        "--config", str(cfg_json), "--dtype", "float64",
    ])
    assert rc == 0
    printed = capsys.readouterr().out
    # the file's outlier_threshold was honored
    assert "rejected 1 obs" in printed
    assert "assimilated 4/5 obs" in printed
