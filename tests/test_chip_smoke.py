"""`chip_smoke.py` phases at toy size on the CPU, called as functions.

The phases compare against their references exactly as on the card; only
the shapes shrink.  `main()` itself must refuse the CPU: non-zero exit and
no ok line.
"""
import os
import shutil
import subprocess
import sys

import jax
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import chip_smoke as cs  # noqa: E402

TOY = cs.Size(batch=8, chunks=2, chunk=2, c5_block=1024, c8_block=512,
              quick_batch=4, oracle_rows=4)


def test_phase_device_reports_platform():
    info = cs.phase_device("cpu")
    assert info == {"platform": "cpu", "kind": "cpu",
                    "count": len(jax.devices())}
    with pytest.raises(cs.SmokeError, match="expected 'gpu'"):
        cs.phase_device("gpu")


def test_phase_compile_toy(capsys):
    cs.phase_compile(TOY)
    out = capsys.readouterr().out
    assert "[1] compile C5" in out and "[1] compile C8" in out


def test_phase_kernels_toy(capsys):
    cs.phase_kernels(TOY, 0, "cpu")
    out = capsys.readouterr().out
    for tag in ("conv C5 td_mxu", "conv C5 fft", "agc kernel exact",
                "agc kernel fast", "dither tpdf", "dither rpdf",
                "pcm16 round trip"):
        assert tag in out


def test_phase_c5_ring_toy(capsys):
    cs.phase_c5_ring(TOY, 0)
    out = capsys.readouterr().out
    assert out.count("ring == staged bitwise: True") == 2


def test_phase_c8_toy(capsys):
    cs.phase_c8(TOY, 0)
    out = capsys.readouterr().out
    assert "C8 ring" in out and "fallback_replays=0" in out


def test_phase_quickstart_toy():
    cs.phase_quickstart(TOY, 0)


def test_phase_cli_toy(tmp_path):
    cs.phase_cli(0, str(tmp_path))
    assert (tmp_path / "out.wav").exists()


def test_phase_four_toy(capsys):
    """The four-device phase on four of the virtual CPU devices."""
    cs.phase_four(cs.Size(batch=8, chunks=2, chunk=2, c5_block=1024), 0)
    out = capsys.readouterr().out
    assert "collectives in the compiled serving HLO: none" in out
    assert out.count("bitwise (dither off): True") == 4


def test_check_raises_smoke_error():
    with pytest.raises(cs.SmokeError, match="boom"):
        cs.check(False, "boom")


@pytest.mark.parametrize("argv", [[], ["--four"]])
def test_main_refuses_cpu(capsys, argv):
    assert cs.main(argv) == 1
    out = capsys.readouterr().out
    assert '"ok"' not in out


def test_script_alone_fails(tmp_path):
    """In a directory holding chip_smoke.py and nothing else of the repo
    the script exits non-zero and prints no ok line."""
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                       env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
