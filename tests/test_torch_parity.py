"""The port's parity harness (needle_tpu_torch.parity) on the CPU.

With `--device cpu --trials 2 --eps-seconds 10` it passes: the walk-all,
band (episode tiles and per pair) and direct routes are each taken and
RunEntry-exact against the numpy engine under the plain count walk, and
the value errors and hashes hold. The pair route walks one pair at n_pad
16,384, which the plain version takes most of a minute for here; it runs
on the card (tests/test_torch_cuda.py and chip_smoke.py). Its libraries
are tools/hw_parity.py's for the same seeds (where the port's engine
gives needle_tpu's JAX engine's results), and the harness can fail: a
walk that loses one diagonal's counts, or a route that is not taken, makes
it exit 1.
"""

import json
import os

import numpy as np
import pytest

from needle_tpu_torch import parity
from needle_tpu_torch.search import diag_runs
from tools import hw_parity

CPU_ROUTES = "walk-all,band-dense,band-pairs,direct"


def _main(capsys, argv):
    rc = parity.main(argv)
    lines = capsys.readouterr().out.strip().splitlines()
    return rc, json.loads(lines[-1])


def test_harness_passes_on_cpu(capsys, monkeypatch):
    monkeypatch.setenv("NEEDLE_TPU_SEARCH_PREFILTER", "auto")
    monkeypatch.delenv("NEEDLE_TPU_SEARCH_DIRECT", raising=False)
    rc, out = _main(capsys, ["--device", "cpu", "--trials", "2",
                             "--eps-seconds", "10", "--routes", CPU_ROUTES])
    assert rc == 0 and out["ok"], out
    assert out["backend"] == "cpu" and out["kernels"] == ["plain"]
    assert sorted(out["routes"]) == sorted(CPU_ROUTES.split(","))
    for route, r in out["routes"].items():
        assert r["exact"] and r["taken"], (route, r)
        assert r["pair_infos_checked"] > 0
    assert out["routes"]["walk-all"]["launches"]["plain"] > 0
    assert out["routes"]["direct"]["launches"]["plain"] == 0
    assert out["prefilter"]["pairs_skipped"] > 0
    assert out["prefilter"]["libraries"] == 3 and "mismatches" not in out
    assert out["direct"]["direct_items"] > 0
    assert out["eps_ok"] and out["eps_max_value_err"] < 5e-6
    assert out["ingest_eps_ok"] and out["ingest_eps_dec_factor"] == 4
    assert out["hashes_bit_exact"] and out["ingest_hashes_bit_exact"]
    # the knobs are restored
    assert os.environ["NEEDLE_TPU_SEARCH_PREFILTER"] == "auto"
    assert "NEEDLE_TPU_SEARCH_DIRECT" not in os.environ


def _same_library(ours, theirs):
    assert [lib[0] for lib in ours] == [lib[0] for lib in theirs]
    for (_, o_fhs, *o_cfg), (_, t_fhs, *t_cfg) in zip(ours, theirs):
        assert o_cfg == t_cfg
        assert len(o_fhs) == len(t_fhs)
        for o, t in zip(o_fhs, t_fhs):
            for field in ("opening_hashes", "opening_ts_nanos",
                          "ending_hashes", "ending_ts_nanos"):
                assert np.array_equal(getattr(o, field), getattr(t, field))
            assert o.to_bytes() == t.to_bytes()


def test_libraries_and_engines_equal_hw_parity():
    """Same seeds, same libraries as tools/hw_parity.py; on them the port's
    torch engine on the CPU gives needle_tpu's JAX engine's infos (the
    walk-all libraries) and the port's numpy oracle needle_tpu's (the
    prefilter libraries)."""
    seed = 20260817
    ours = parity.make_libraries(np.random.default_rng(seed), 2)
    theirs = hw_parity.make_libraries(np.random.default_rng(seed), 2)
    _same_library(ours, theirs)
    for (_, fhs, thr, mo, endings), (_, t_fhs, *_) in zip(ours, theirs):
        assert parity.run_engine(fhs, thr, mo, endings, "cpu") == \
            hw_parity.run_engine(t_fhs, thr, mo, endings, "jax")
    _same_library(parity.make_libraries(np.random.default_rng(seed), 6),
                  hw_parity.make_libraries(np.random.default_rng(seed), 6))
    ours = parity.make_prefilter_libraries(np.random.default_rng(seed + 1))
    theirs = hw_parity.make_prefilter_libraries(np.random.default_rng(seed + 1))
    _same_library(ours, theirs)
    for (_, fhs, thr, mo, endings), (_, t_fhs, *_) in zip(ours, theirs):
        assert parity.run_engine(fhs, thr, mo, endings) == \
            hw_parity.run_engine(t_fhs, thr, mo, endings, "numpy")
    (_, fhs, *_), = parity.make_pair_library(np.random.default_rng(seed + 2))
    assert len(fhs[0].opening_hashes) > 15360 and len(fhs) == 3


def test_lost_diagonal_is_caught(capsys, monkeypatch):
    """A count walk that zeroes the first flagged diagonal of every call:
    the harness reports the mismatch, exact false, and exits 1."""
    real = diag_runs.batch_counts_reference

    def lossy(*args, **kwargs):
        counts = real(*args, **kwargs)
        flagged = (counts > 0).any(dim=0).nonzero()
        if len(flagged):
            counts[:, int(flagged[0])] = 0
        return counts

    monkeypatch.setattr(diag_runs, "batch_counts_reference", lossy)
    rc, out = _main(capsys, ["--device", "cpu", "--trials", "2", "--skip-eps",
                             "--routes", "walk-all"])
    assert rc == 1 and not out["ok"]
    assert out["exact"] is False
    assert out["routes"]["walk-all"]["mismatches"]
    assert {m["route"] for m in out["mismatches"]} == {"walk-all"}
    assert out["routes"]["walk-all"]["taken"]


def test_route_not_taken_fails(capsys, monkeypatch):
    """band-dense forced with walk-all's knobs: exact, but the walk was
    unmasked and nothing was skipped, so the route was not taken."""
    monkeypatch.setitem(parity.ROUTES, "band-dense",
                        (parity.ROUTES["walk-all"][0], "prefilter"))
    rc, out = _main(capsys, ["--device", "cpu", "--skip-eps",
                             "--routes", "band-dense"])
    assert rc == 1 and not out["routes_taken"]
    assert out["routes"]["band-dense"]["exact"]
    assert not out["routes"]["band-dense"]["taken"]


def test_unknown_route_is_refused(capsys):
    with pytest.raises(SystemExit) as exit_info:
        parity.main(["--device", "cpu", "--routes", "walk-all,sideways"])
    assert exit_info.value.code == 2
    assert "sideways" in capsys.readouterr().err
