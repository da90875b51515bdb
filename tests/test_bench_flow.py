"""Control-flow tests for the benchmark harness (bench.py).

The timed legs are stubbed out (each returns a recognizable constant) so
these tests validate the MEASUREMENT WIRING — which legs run, which keys
they publish, and that a failing leg fails the run — without a GPU.
"""
import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import bench  # noqa: E402


@pytest.fixture
def flow_env(monkeypatch):
    """Small shapes, stubbed timing, deterministic leg constants."""
    monkeypatch.setenv("AFP_BENCH_CHECK", "0")
    monkeypatch.setenv("AFP_BENCH_SUSTAIN", "4")
    monkeypatch.setenv("AFP_BENCH_SUSTAIN_ASYMPTOTE", "8")
    monkeypatch.setenv("AFP_BENCH_CHAIN", "1")
    monkeypatch.setattr(bench, "_peaks", lambda kind=None: bench._PEAKS[
        "NVIDIA H100 80GB HBM3"])
    monkeypatch.setattr(bench, "_time_runs",
                        lambda *a, **k: (0.001, None))
    monkeypatch.setattr(bench, "_sustained_xrt",
                        lambda *a, **k: 100000.0)
    monkeypatch.setattr(
        bench, "_sustained_ring_xrt",
        lambda pipe, params, ring, reps, n_sust=None:
        200000.0 + (n_sust or 0) + (1000.0 if pipe._i16_ingest else 0.0))
    yield


def test_run_config_publishes_every_ring_leg(flow_env):
    """All three serving forms (f32, pcm16, int16 I/O) publish the ring
    and asymptote keys from the shared leg suite."""
    r = bench.run_config(batch=8, nblocks=2, reps=1, strategy="td_mxu")
    for form in ("f32", "pcm16", "i16io"):
        for tmpl in ("sustained_{}_ring_xrt",
                     "sustained_{}_ring_asym2048_xrt"):
            assert r.get(tmpl.format(form)) is not None, tmpl.format(form)
    # default legs see n_sust=None (the env default applies inside the
    # real function); asymptote legs see the explicit 8
    assert r["sustained_f32_ring_xrt"] == 200000.0
    assert r["sustained_f32_ring_asym2048_xrt"] == 200008.0
    assert r["sustained_i16io_ring_asym2048_xrt"] == 201008.0
    assert r["mfu"] is not None
    # methodology contract: the headline name carries the methodology
    assert r["methodology"] == "sustained_f32ring"
    assert r["metric"].startswith("sustained_f32ring_xrt")


def test_ring_leg_suite_keeps_earlier_measurements(flow_env, monkeypatch):
    """A failing leg fails the run: the asymptote's exception propagates
    (the harness no longer swallows failures), after the base leg ran."""
    calls = []

    def ring(pipe, params, r, reps, n_sust=None):
        calls.append(n_sust)
        if n_sust is not None:
            raise RuntimeError("asymptote leg blew up")
        return 123.0

    monkeypatch.setattr(bench, "_sustained_ring_xrt", ring)
    with pytest.raises(RuntimeError, match="asymptote"):
        bench._ring_leg_suite(object(), object(), object(), 1, "test")
    assert calls == [None, 8]


def test_ring_leg_suite_skips_asymptote_at_or_below_sustain(
        flow_env, monkeypatch):
    monkeypatch.setenv("AFP_BENCH_SUSTAIN_ASYMPTOTE", "4")  # == SUSTAIN

    class P:
        _i16_ingest = False

    out = bench._ring_leg_suite(P(), object(), object(), 1, "test")
    assert out["ring"] == 200000.0
    assert out["asym"] is None


def test_run_agc_config_i16io_nested_in_pcm16_asym(flow_env):
    """The C8 leg publishes the f32 and pcm16 serving rings (default and
    asymptote) beside the chained and sustained loops."""
    r = bench.run_agc_config(batch=8, nblocks=2, reps=1,
                             strategy="td_mxu", agc_mode="exact")
    assert r["ring"] == 200000.0 and r["ring_asym"] == 200008.0
    assert r["ring_pcm16"] == 201000.0 and r["ring_pcm16_asym"] == 201008.0
    assert r["sustained"] == 100000.0


def test_per_stream_ring_leg_wiring(flow_env, monkeypatch):
    """The per-stream filter-bank ring leg builds the 4-design bank on the
    headline-shaped (shrunk) config and publishes its key."""
    monkeypatch.setenv("AFP_BENCH_RING_BLOCKS", "2")
    monkeypatch.setattr(
        bench, "_time_sustained",
        lambda label, dispatch, pipe, n_sust, K, batch, blocksize, reps:
        float(777000))
    out = bench.run_per_stream_ring_xrt(32, 2)
    assert out == {"per_stream_ring_xrt": 777000}


def test_reconfig_latency_leg(flow_env, rng):
    """The live-reconfig leg: a mid-serve gain swap is detected at the
    chunk boundary (effect_blocks == 0 for a boundary-aligned swap) with
    a finite wall latency."""
    out = bench.run_reconfig_latency(1)
    assert out["reconfig_effect_blocks"] == 0
    assert 0.0 < out["reconfig_to_effect_ms"] < 60000.0


def test_peak_table_is_keyed_by_device_kind():
    """The H100 row carries the data-sheet peaks; an unknown device is an
    error, never a default."""
    row = bench._PEAKS["NVIDIA H100 80GB HBM3"]
    assert row["bf16"] == 989e12 and row["tf32"] == 495e12
    assert row["fp32"] == 67e12 and row["hbm"] == 3.35e12
    assert bench._peaks("NVIDIA H100 80GB HBM3") is row
    with pytest.raises(KeyError, match="no published peaks"):
        bench._peaks("cpu")


def test_bench_main_needs_a_gpu(capsys):
    """On the CPU the harness exits non-zero and prints no result line."""
    assert bench.main([]) == 1
    out = capsys.readouterr()
    assert "needs a GPU" in out.err and "metric" not in out.out


def test_chain_imaging_report_keys_and_gate():
    """The cross-kernel imaging oracle publishes the default-tier key and
    enforces the −90 dB gate on it (the default-config contract)."""
    out = bench.chain_imaging_report()
    q = out["resample_default_quality"]
    assert q == "hq"
    assert out[f"chain_err_db_default_{q}"] < -90
    assert out["chain_err_db_headline_vhq"] < -90
    # 'fast' is reported (to show why it is not the default) and is worse
    assert out["chain_err_db_default_fast"] > out[f"chain_err_db_default_{q}"]
