"""The port's native panel ops (`factorvae_tpu_torch/native`) against the JAX
package's (`factorvae_tpu.native`) and against the numpy path, bitwise: the
fill maps, the COO->dense scatter, `compute_fill_maps` and `build_panel`
with the native pass on and off (repeated rows included), the build rules
(build directory, hashed file name, one report of a failed build, a missing
source or an unwritable build directory served by numpy, the source among
the package data) and the call counters. This host has g++; a host without
it takes the numpy path."""

from __future__ import annotations

import fnmatch
import os
import tomllib
import warnings
from pathlib import Path

import numpy as np
import pandas as pd
import pytest

from factorvae_tpu import native as jnative
from factorvae_tpu.data import build_panel as jbuild_panel
from factorvae_tpu.data import synthetic_frame as jsynthetic_frame
from factorvae_tpu_torch import _build, native
from factorvae_tpu_torch.data.loader import PanelDataset
from factorvae_tpu_torch.data.panel import Panel, build_panel
from factorvae_tpu_torch.data.synthetic import synthetic_frame
from factorvae_tpu_torch.data.windows import compute_fill_maps

pytestmark = pytest.mark.skipif(native.load() is None or jnative.load() is None,
                                reason="g++ is not available: no native library")


def _eq(a, b):
    """Equal shape, dtype and values; numbers bit for bit (NaNs included)."""
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype
    if a.dtype.kind in "biuf":
        assert a.tobytes() == b.tobytes()
    else:
        assert np.array_equal(a, b)


def _numpy_maps(valid):
    os.environ[native.ENV] = "0"
    try:
        return compute_fill_maps(valid)
    finally:
        del os.environ[native.ENV]


def _masks():
    rng = np.random.default_rng(0)
    out = {}
    for seed, (d, i) in enumerate([(40, 17), (64, 33), (9, 300)]):
        v = np.random.default_rng(seed).random((d, i)) > 0.4
        v[:, 2] = False                              # an all-invalid column
        out[f"random_{d}x{i}"] = v
    out["single_day"] = rng.random((1, 12)) > 0.5
    out["d1_all_invalid"] = np.zeros((1, 5), bool)
    out["one_instrument"] = rng.random((25, 1)) > 0.5
    out["all_valid"] = np.ones((6, 4), bool)
    out["strided_view"] = (rng.random((30, 20)) > 0.3)[::2, ::3]
    return out


@pytest.mark.parametrize("name", list(_masks()))
def test_fill_maps_bitwise_jax_native_and_numpy(name):
    valid = _masks()[name]
    got = native.fill_maps(valid)
    want = jnative.fill_maps(valid)
    numpy = _numpy_maps(valid)
    for g, w, n in zip(got, want, numpy):
        _eq(g, w)
        _eq(g, n)


@pytest.mark.parametrize("seed", [0, 1])
def test_scatter_bitwise_jax_native_and_numpy(seed):
    rng = np.random.default_rng(seed)
    d, i, c, n = 15, 7, 5, 60
    key = rng.choice(d * i, n, replace=False)        # distinct (day, instrument)
    rows, cols = key % d, key // d
    vals = rng.normal(size=(n, c)).astype(np.float32)
    got = native.scatter_panel(vals, rows, cols, d, i)
    want = np.full((i, d, c), np.nan, np.float32)
    want[cols, rows] = vals
    _eq(got, jnative.scatter_panel(vals, rows, cols, d, i))
    _eq(got, want)
    # intp indices, a strided values view
    wide = np.repeat(vals, 2, axis=1)[:, ::2]
    _eq(native.scatter_panel(wide, rows.astype(np.intp), cols.astype(np.intp), d, i), want)


def test_scatter_keeps_the_later_of_repeated_rows():
    vals = np.arange(12, dtype=np.float32).reshape(4, 3)
    rows, cols = np.array([0, 1, 0, 0]), np.array([2, 0, 2, 1])
    got = native.scatter_panel(vals, rows, cols, 2, 3)
    _eq(got, jnative.scatter_panel(vals, rows, cols, 2, 3))
    _eq(got[2, 0], vals[2])
    _eq(got[0, 1], vals[1])


def test_scatter_refuses_indices_outside_the_panel():
    vals = np.zeros((2, 3), np.float32)
    with pytest.raises(IndexError):
        native.scatter_panel(vals, np.array([0, 5]), np.array([0, 0]), 4, 2)
    with pytest.raises(IndexError):
        native.scatter_panel(vals, np.array([0, 1]), np.array([-1, 0]), 4, 2)
    with pytest.raises(ValueError):
        native.scatter_panel(vals, np.array([0]), np.array([0, 0]), 4, 2)


def _repeated(df):
    """`df` with two of its rows repeated under new values: the later one
    must win on every path."""
    extra = df.iloc[[3, 8]].copy()
    extra.iloc[:, :] = np.arange(extra.size, dtype=np.float32).reshape(extra.shape) + 100
    return pd.concat([df, extra])


@pytest.mark.parametrize("repeated", [False, True], ids=["distinct", "repeated_rows"])
def test_build_panel_native_numpy_and_jax(repeated, monkeypatch):
    df = synthetic_frame(num_days=15, num_instruments=7, num_features=5,
                         missing_prob=0.25, seed=9)
    jdf = jsynthetic_frame(num_days=15, num_instruments=7, num_features=5,
                           missing_prob=0.25, seed=9)
    if repeated:
        df, jdf = _repeated(df), _repeated(jdf)
    nat = build_panel(df)
    jnat = jbuild_panel(jdf)
    monkeypatch.setenv(native.ENV, "0")
    numpy = build_panel(df)
    jnumpy = jbuild_panel(jdf)
    for p in (numpy, jnat, jnumpy):
        _eq(nat.values, p.values)
        _eq(nat.valid, p.valid)
    _eq(nat.dates, jnat.dates.values.astype("datetime64[D]"))
    _eq(nat.instruments, np.asarray(jnat.instruments))
    if repeated:
        _eq(nat.values[nat.instruments.tolist().index(df.index[-1][1]),
                       list(nat.dates).index(np.datetime64(df.index[-1][0], "D"))],
            df.iloc[-1].to_numpy(np.float32))
    lv, nv = compute_fill_maps(nat.valid)
    monkeypatch.delenv(native.ENV)
    _eq(compute_fill_maps(nat.valid)[0], lv)
    _eq(compute_fill_maps(nat.valid)[1], nv)


def test_call_counts_follow_the_path_that_ran(monkeypatch):
    df = synthetic_frame(num_days=10, num_instruments=5, num_features=3, seed=2)
    native.reset_call_counts()
    assert native.call_counts() == {op: {"native": 0, "numpy": 0} for op in native.OPS}
    panel = build_panel(df)
    PanelDataset(panel, seq_len=3, device="cpu")
    assert native.call_counts() == {"fill_maps": {"native": 1, "numpy": 0},
                                    "scatter_panel": {"native": 1, "numpy": 0}}
    monkeypatch.setenv(native.ENV, "0")
    assert native.load() is None and native.fill_maps(panel.valid) is None
    ds = PanelDataset(build_panel(df), seq_len=3, device="cpu")
    assert native.call_counts() == {"fill_maps": {"native": 1, "numpy": 1},
                                    "scatter_panel": {"native": 1, "numpy": 1}}
    # the append recomputes the maps over the grown history
    monkeypatch.delenv(native.ENV)
    grown = synthetic_frame(num_days=12, num_instruments=5, num_features=3, seed=2)
    new_day = build_panel(grown).date_slice(str(panel.dates[-1] + 1), None)
    assert ds.extend_days(Panel(values=new_day.values, valid=new_day.valid,
                                dates=new_day.dates, instruments=new_day.instruments))
    assert native.call_counts()["fill_maps"] == {"native": 2, "numpy": 1}
    native.reset_call_counts()
    assert native.call_counts()["scatter_panel"] == {"native": 0, "numpy": 0}


def test_library_lands_in_the_build_dir_under_a_hashed_name(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "BUILD_DIR", _build.BUILD_DIR)
    default = native.library_path()
    built = _build.set_build_dir(tmp_path / "cache")
    path = native.library_path()
    assert path.parent == built and path.name == default.name
    assert path.name.startswith("libpanelops-") and path.suffix == ".so"
    assert native.load() is not None and path.exists()
    assert (built / ".build.lock").exists()
    # an edited source gets a new file name; the old library is never loaded for it
    src = tmp_path / "panelops.cpp"
    src.write_text(native.SRC.read_text() + "\n// edited\n")
    monkeypatch.setattr(native, "SRC", src)
    assert native.library_path() != path and not native.library_path().exists()
    lib = native.load()
    assert lib is not None and native.library_path().exists()
    last, nxt = native.fill_maps(np.array([[1, 0], [0, 0], [0, 1]], bool))
    _eq(last, np.array([[0, -1], [0, -1], [0, 2]], np.int32))
    _eq(nxt, np.array([[0, 2], [3, 2], [3, 2]], np.int32))
    # no KERNELS entry, no compile event
    assert "panelops" not in _build.KERNELS


def test_a_failed_build_is_reported_once_and_numpy_serves(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    src = tmp_path / "panelops.cpp"
    src.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SRC", src)
    before = _build.compile_event_counts()
    with pytest.warns(UserWarning, match="g\\+\\+ exited") as caught:
        assert native.load() is None
    assert any("error" in str(w.message) for w in caught)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert native.load() is None                 # refused, not retried or reported
    valid = np.random.default_rng(1).random((8, 4)) > 0.5
    native.reset_call_counts()
    maps = compute_fill_maps(valid)
    assert native.call_counts()["fill_maps"] == {"native": 0, "numpy": 1}
    monkeypatch.undo()
    for a, b in zip(maps, jnative.fill_maps(valid)):
        _eq(a, b)
    assert _build.compile_event_counts() == before
    assert not list(tmp_path.glob("*.so")) and not list(tmp_path.glob("*.tmp"))


def _numpy_served(monkeypatch, why):
    """With the library refused for `why`, `build_panel` and the fill maps
    are served by numpy, warned once, bitwise the native results."""
    df = synthetic_frame(num_days=12, num_instruments=6, num_features=4,
                         missing_prob=0.2, seed=5)
    want = build_panel(df)
    want_maps = compute_fill_maps(want.valid)
    why()
    native.reset_call_counts()
    with pytest.warns(UserWarning, match="numpy serves") as caught:
        assert native.load() is None
    assert len(caught) == 1
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        got = build_panel(df)
        got_maps = compute_fill_maps(got.valid)
    assert native.call_counts() == {"fill_maps": {"native": 0, "numpy": 1},
                                    "scatter_panel": {"native": 0, "numpy": 1}}
    _eq(got.values, want.values)
    _eq(got.valid, want.valid)
    for g, w in zip(got_maps, want_maps):
        _eq(g, w)
    return caught[0]


def test_a_missing_source_is_served_by_numpy(tmp_path, monkeypatch):
    monkeypatch.setattr(native, "_refused", set())
    w = _numpy_served(monkeypatch, lambda: monkeypatch.setattr(
        native, "SRC", tmp_path / "not_installed" / "panelops.cpp"))
    assert "not_installed" in str(w.message)


def test_an_unwritable_build_dir_is_served_by_numpy(tmp_path, monkeypatch):
    # a build directory under a plain file: mkdir fails (as it does for
    # any user in a read-only site-packages)
    blocker = tmp_path / "site-packages"
    blocker.write_text("")
    monkeypatch.setattr(native, "_refused", set())
    w = _numpy_served(monkeypatch, lambda: monkeypatch.setattr(
        _build, "BUILD_DIR", blocker / "_build"))
    assert "building or loading" in str(w.message)
    assert blocker.is_file()


def test_fallback_runs_and_counts_only_when_the_library_is_off(monkeypatch):
    valid = np.random.default_rng(3).random((7, 5)) > 0.5
    calls = []

    def fallback(v):
        calls.append(v)
        return "numpy"

    native.reset_call_counts()
    assert native.fill_maps(valid, fallback=fallback) != "numpy" and not calls
    monkeypatch.setenv(native.ENV, "0")
    assert native.fill_maps(valid, fallback=fallback) == "numpy" and calls == [valid]
    assert native.fill_maps(valid) is None
    assert native.scatter_panel(np.zeros((1, 2), np.float32), np.array([0]),
                                np.array([0]), 1, 1) is None
    assert native.call_counts() == {"fill_maps": {"native": 1, "numpy": 1},
                                    "scatter_panel": {"native": 0, "numpy": 0}}


def test_the_source_ships_with_the_package():
    """A non-editable install carries `panelops.cpp`: pyproject's
    package-data names it."""
    root = Path(__file__).resolve().parents[1]
    data = tomllib.loads((root / "pyproject.toml").read_text())
    globs = data["tool"]["setuptools"]["package-data"]["factorvae_tpu_torch.native"]
    assert any(fnmatch.fnmatch(native.SRC.name, g) for g in globs)
