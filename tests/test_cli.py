"""CLI smoke tests (offline WAV processing, design, devices)."""
import numpy as np
import pytest

from afp.cli import main
from afp.utils import read_wav, write_wav

#: heavy suite — excluded from the fast pass (docs/TESTING.md tiering);
#: run the FULL suite before committing kernel/engine changes
pytestmark = pytest.mark.slow



def test_cli_process_wav(tmp_path, rng, capsys):
    src = str(tmp_path / "in.wav")
    dst = str(tmp_path / "out.wav")
    x = (0.3 * rng.standard_normal((2, 44100))).astype(np.float32).clip(-1, 1)
    write_wav(src, x, 44100)
    rc = main(["process", src, dst, "--blocksize", "1024", "--upsample", "2",
               "--numtaps", "65", "--cutoff", "10000", "--dither", "off"])
    assert rc == 0
    y, rate = read_wav(dst)
    assert rate == 44100
    assert y.shape[0] == 2
    assert np.all(np.isfinite(y))
    # lowpass at 10k must attenuate HF energy: compare spectra
    X = np.abs(np.fft.rfft(x[0]))
    Y = np.abs(np.fft.rfft(y[0, : x.shape[1]]))
    hf = slice(int(15000 / 44100 * x.shape[1]), None)
    assert np.mean(Y[hf]) < 0.1 * np.mean(X[hf])


def test_cli_process_with_eq_and_agc(tmp_path, rng):
    src = str(tmp_path / "in.wav")
    dst = str(tmp_path / "out.wav")
    x = (0.01 * rng.standard_normal((1, 22050))).astype(np.float32)
    write_wav(src, x, 44100)
    rc = main(["process", src, dst, "--blocksize", "1024", "--upsample", "1",
               "--numtaps", "65", "--eq-gains", "1,1,1,1,1,1,1,1,1",
               "--agc", "--dither", "off"])
    assert rc == 0
    y, _ = read_wav(dst)
    assert np.std(y[:, 4096:]) > np.std(x) * 1.5  # AGC boost


def test_cli_design(tmp_path, capsys):
    plot = str(tmp_path / "resp.png")
    taps = str(tmp_path / "taps.txt")
    rc = main(["design", "--cutoff", "11000", "--numtaps", "101",
               "--plot", plot, "--taps-out", taps])
    assert rc == 0
    import os

    assert os.path.getsize(plot) > 1000
    h = np.loadtxt(taps)
    assert h.shape == (101,)


def test_cli_devices(capsys):
    assert main(["devices"]) == 0
    assert capsys.readouterr().out.strip()


def test_cli_process_pcm16_matches_f32_td_mxu(tmp_path, rng):
    """--ingest pcm16 on a 16-bit WAV converts on-device to exactly the
    n/32768 floats read_wav would produce, so its output sits in the
    pair-kernel numerics class: bit-identical to pair ingest (pinned at
    engine level in test_pcm16.py) and within the documented ≤ −110 dB
    regrouped-accumulation class of the staged-f32 td_mxu gold used here
    (`ops/pallas/fir_td.py:_fir_kernel_b3t_f32` note).  Partial final
    block included (int16 zero padding)."""
    import dataclasses

    from afp.engine import StreamConfig, StreamEngine
    from afp.utils import read_wav_pcm16

    src, dst = str(tmp_path / "in.wav"), str(tmp_path / "out.wav")
    x = (0.3 * rng.standard_normal((2, 3000))).astype(np.float32).clip(-1, 1)
    write_wav(src, x, 44100, width=2)
    rc = main(["process", src, dst, "--blocksize", "1024", "--upsample", "2",
               "--numtaps", "65", "--cutoff", "10000", "--dither", "off",
               "--ingest", "pcm16"])
    assert rc == 0
    y, rate = read_wav(dst)
    assert rate == 44100 and y.shape == (2, 3000)

    # gold: the engine on the f32 td_mxu path fed read_wav's floats
    xf, _ = read_wav(src)
    xi, _ = read_wav_pcm16(src)
    np.testing.assert_array_equal(xi.astype(np.float32) / 32768.0, xf)
    cfg = StreamConfig(
        samplerate=44100, blocksize=1024, upsample_factor=2, numtaps=65,
        cutoff=10000.0, batch=2, dither_kind="off", output_clip=None,
        eq_enabled=False,  # the CLI without --eq-gains runs EQ-off
        conv_strategy="td_mxu", downsample_mode="resample")
    eng = StreamEngine(cfg)
    pad = np.zeros((2, 1024 - 3000 % 1024), np.float32)
    # fold='prefer' matches the CLI's offline execution strategy — the
    # comparison isolates the pcm16-vs-f32 INGEST numerics (on CPU the
    # interpret-mode fold and scan differ by ~1e-7 GEMM reassociation,
    # which alone would eat this 8-LSB₂₄ budget)
    gold = eng.process_signal(np.concatenate([xf, pad], axis=1),
                              fold="prefer")[:, :3000]
    # compare at the 24-bit output quantization the CLI writes: the
    # pair-class vs staged-f32 difference is ≤ −110 dB ≈ a few LSB₂₄
    q = np.round(np.clip(gold, -1, 1) * float((1 << 23) - 1))
    yq = np.round(np.clip(y, -1, 1) * float((1 << 23) - 1))
    assert np.max(np.abs(yq - q)) <= 8.0
    # most samples land on the identical 24-bit code (empirical sanity —
    # the max-LSB bound above is the contract; 0.897 measured under the
    # folded offline path)
    assert np.mean(yq == q) > 0.85


def test_cli_process_pcm16_rejects_float_wavs_accepts_agc(tmp_path, rng):
    src, dst = str(tmp_path / "inf.wav"), str(tmp_path / "out.wav")
    x = (0.3 * rng.standard_normal((1, 2048))).astype(np.float32)
    write_wav(src, x, 44100, float_format=True)  # IEEE float, not PCM16
    with pytest.raises(ValueError, match="16-bit PCM"):
        main(["process", src, dst, "--ingest", "pcm16", "--dither", "off"])
    # pcm16 ingest works through the AGC (C8) chain — the step converts
    # the raw int16 x at device entry
    src2 = str(tmp_path / "in.wav")
    write_wav(src2, x, 44100, width=2)
    rc = main(["process", src2, dst, "--ingest", "pcm16", "--agc",
               "--blocksize", "512", "--upsample", "1", "--numtaps", "65",
               "--dither", "off"])
    assert rc == 0
    y, rate = read_wav(dst)
    assert rate == 44100 and y.shape == (1, 2048) and np.any(y != 0)


def test_cli_process_keeps_partial_final_block(tmp_path, rng):
    """An input that isn't a whole number of blocks must come back at full
    length (the final partial block used to be silently dropped)."""
    src, dst = str(tmp_path / "in.wav"), str(tmp_path / "out.wav")
    x = (0.3 * rng.standard_normal((1, 22050))).astype(np.float32).clip(-1, 1)
    write_wav(src, x, 44100)
    rc = main(["process", src, dst, "--blocksize", "1024", "--upsample", "1",
               "--numtaps", "65", "--dither", "off"])
    assert rc == 0
    y, _ = read_wav(dst)
    assert y.shape == (1, 22050)
    assert np.any(y[:, -512:])  # the tail carries real audio, not silence


def test_cli_process_asrc_output_length(tmp_path, rng):
    """--samplerate differing from the file rate engages the ASRC; the
    output length is CEIL(n_in·sr/rate) — the resample_poly convention
    (review fix: the float-floor trim used to drop the final sample)."""
    src = str(tmp_path / "in.wav")
    dst = str(tmp_path / "out.wav")
    n_in = 1001  # 1001·160/147 → 1089.52… → 1090 samples at 48 kHz
    x = (0.3 * rng.standard_normal((1, n_in))).astype(np.float32).clip(-1, 1)
    write_wav(src, x, 44100)
    rc = main(["process", src, dst, "--samplerate", "48000",
               "--blocksize", "512", "--upsample", "1", "--numtaps", "65",
               "--cutoff", "10000", "--dither", "off"])
    assert rc == 0
    y, rate = read_wav(dst)
    assert rate == 48000
    assert y.shape[1] == -(-n_in * 48000 // 44100)
    assert np.all(np.isfinite(y))


def test_cli_preset_roundtrip(tmp_path, rng, capsys):
    """`preset save` → `process --preset` applies the stored sound (here a
    much lower cutoff) while deployment flags stay the command line's —
    the reference's preset workflow (`stream_process_GUI_Presets.py:143-195`)
    as a scriptable CLI surface."""
    store = str(tmp_path / "p.json")
    rc = main(["preset", "save", "dark", "--store", store,
               "--cutoff", "2000", "--numtaps", "65", "--window", "blackman"])
    assert rc == 0
    rc = main(["preset", "list", "--store", store])
    assert rc == 0
    assert "dark" in capsys.readouterr().out.splitlines()
    rc = main(["preset", "show", "dark", "--store", store])
    assert rc == 0
    shown = capsys.readouterr().out
    assert '"cutoff": 2000' in shown and '"samplerate"' not in shown

    src, dst = str(tmp_path / "in.wav"), str(tmp_path / "out.wav")
    x = (0.3 * rng.standard_normal((1, 22050))).astype(np.float32).clip(-1, 1)
    write_wav(src, x, 44100)
    args = ["process", src, dst, "--blocksize", "1024", "--upsample", "1",
            "--numtaps", "65", "--cutoff", "18000", "--dither", "off"]
    assert main(args) == 0
    y_flags, _ = read_wav(dst)
    assert main(args + ["--preset", "dark", "--preset-store", store]) == 0
    y_preset, _ = read_wav(dst)
    # the preset's 2 kHz lowpass must attenuate 5-15 kHz energy the 18 kHz
    # flags run passes almost untouched
    n = x.shape[1]
    band = slice(int(5000 / 44100 * n), int(15000 / 44100 * n))
    e_flags = np.mean(np.abs(np.fft.rfft(y_flags[0])[band]) ** 2)
    e_preset = np.mean(np.abs(np.fft.rfft(y_preset[0])[band]) ** 2)
    assert e_preset < 1e-3 * e_flags

    assert main(["preset", "delete", "dark", "--store", store]) == 0
    import json

    with open(store) as f:
        assert json.load(f)["presets"] == {}


def test_cli_preset_eq_gains_and_errors(tmp_path, rng, capsys):
    """Preset saves carry EQ band gains; `process --eq-gains` still
    overrides them; unknown names and missing args exit non-zero."""
    import json

    import pytest

    store = str(tmp_path / "p.json")
    assert main(["preset", "save", "warm", "--store", store,
                 "--numtaps", "65", "--upsample", "1", "--dither", "off",
                 "--eq-gains", "2,1,1,1,1,1,1,1,1"]) == 0
    rec = json.load(open(store))["presets"]["warm"]
    assert rec["gains"][0] == 2.0 and rec["settings"]["eq_enabled"] is True
    capsys.readouterr()

    with pytest.raises(SystemExit):
        main(["preset", "save", "bad", "--store", store,
              "--eq-gains", "1,2,3"])  # wrong band count
    with pytest.raises(SystemExit):
        main(["preset", "show", "nope", "--store", store])
    with pytest.raises(SystemExit):
        main(["preset", "delete", "nope", "--store", store])
    with pytest.raises(SystemExit):
        main(["preset", "save", "--store", store])  # missing name

    src, dst = str(tmp_path / "in.wav"), str(tmp_path / "out.wav")
    x = (0.1 * rng.standard_normal((1, 4096))).astype(np.float32)
    write_wav(src, x, 44100)
    with pytest.raises(SystemExit):
        main(["process", src, dst, "--preset", "nope",
              "--preset-store", store, "--dither", "off"])
    # --eq-gains beats the preset's stored gains: flat gains over the
    # 'warm' preset must reproduce the no-preset flat-EQ output exactly
    flat = ["--blocksize", "1024", "--upsample", "1", "--numtaps", "65",
            "--eq-gains", "1,1,1,1,1,1,1,1,1", "--dither", "off"]
    assert main(["process", src, dst] + flat) == 0
    y_ref, _ = read_wav(dst)
    assert main(["process", src, dst, "--preset", "warm",
                 "--preset-store", store] + flat) == 0
    y_ovr, _ = read_wav(dst)
    np.testing.assert_array_equal(y_ovr, y_ref)


def test_cli_agc_link_stereo(tmp_path, rng):
    """--agc-link on a stereo file: one gain per frame, driven by the
    loudest channel, so the exact 2:1 channel balance survives the AGC;
    without it the quiet channel is boosted harder and the balance moves."""
    import pytest

    src, dst = str(tmp_path / "in.wav"), str(tmp_path / "out.wav")
    x = (0.02 * rng.standard_normal((1, 22050))).astype(np.float32)
    st = np.concatenate([x, np.float32(0.5) * x], axis=0)
    write_wav(src, st, 44100, float_format=True)  # lossless ingest
    args = ["process", src, dst, "--blocksize", "1024", "--upsample", "1",
            "--numtaps", "65", "--agc", "--dither", "off"]
    assert main(args + ["--agc-link"]) == 0
    y, _ = read_wav(dst)
    # output is 24-bit PCM: each channel quantized independently (LSB 2^-23)
    assert np.max(np.abs(y[1] - 0.5 * y[0])) < 3 * 2.0 ** -23

    assert main(args) == 0
    y_un, _ = read_wav(dst)
    assert np.max(np.abs(y_un[1] - 0.5 * y_un[0])) > 1e-3

    with pytest.raises(SystemExit):  # --agc-link without --agc
        main(["process", src, dst, "--agc-link", "--dither", "off"])


def test_cli_batch_matches_process(tmp_path, rng):
    """`batch` over 3 mono files of different lengths ≡ per-file `process`
    (same flags), each trimmed to its own length — packing files into the
    batch axis must be inaudible (the batched FFT plan may shift ulps)."""
    import os

    srcs, lens = [], (1500, 2048, 700)
    for i, n in enumerate(lens):
        s = str(tmp_path / f"f{i}.wav")
        write_wav(s, (0.2 * rng.standard_normal((1, n))).astype(np.float32),
                  44100, float_format=True)
        srcs.append(s)
    flags = ["--blocksize", "512", "--upsample", "2", "--numtaps", "65",
             "--dither", "off"]
    out_dir = str(tmp_path / "batched")
    assert main(["batch", *srcs, "-o", out_dir] + flags) == 0
    for i, (s, n) in enumerate(zip(srcs, lens)):
        ref = str(tmp_path / f"ref{i}.wav")
        assert main(["process", s, ref] + flags) == 0
        y_ref, _ = read_wav(ref)
        y, rate = read_wav(os.path.join(out_dir, f"f{i}.wav"))
        assert rate == 44100 and y.shape == (1, n)
        np.testing.assert_allclose(y, y_ref, atol=1e-6)


def test_cli_batch_agc_link_is_per_file(tmp_path, rng):
    """--agc-link in batch mode links CHANNELS of one file, never files:
    each stereo file keeps its own 2:1 image bitwise, while the quiet file
    gets a stronger gain than the loud one (independent per-file AGC)."""
    import os

    base = (0.04 * rng.standard_normal((1, 2048))).astype(np.float32)
    for name, scale in (("loud.wav", 1.0), ("quiet.wav", 0.125)):
        st = np.concatenate([base, np.float32(0.5) * base], 0) * np.float32(scale)
        write_wav(str(tmp_path / name), st, 44100, float_format=True)
    out_dir = str(tmp_path / "out")
    assert main(["batch", str(tmp_path / "loud.wav"),
                 str(tmp_path / "quiet.wav"), "-o", out_dir,
                 "--blocksize", "512", "--upsample", "1", "--numtaps", "65",
                 "--agc", "--agc-link", "--dither", "off"]) == 0
    yl, _ = read_wav(os.path.join(out_dir, "loud.wav"))
    yq, _ = read_wav(os.path.join(out_dir, "quiet.wav"))
    lsb = 2.0 ** -23  # 24-bit PCM output: per-channel quantization
    assert np.max(np.abs(yl[1] - 0.5 * yl[0])) < 3 * lsb
    assert np.max(np.abs(yq[1] - 0.5 * yq[0])) < 3 * lsb
    # not linked across files: the quiet file is boosted harder
    assert np.max(np.abs(yq[0])) > 2.0 * 0.125 * np.max(np.abs(yl[0]))


def test_cli_batch_groups_and_errors(tmp_path, rng):
    """Mixed sample rates and (under --agc-link) mixed channel counts run
    as separate groups; duplicate basenames and empty globs fail loudly."""
    import os

    a = str(tmp_path / "a.wav")   # 44.1k mono
    b = str(tmp_path / "b.wav")   # 22.05k mono
    c = str(tmp_path / "c.wav")   # 44.1k stereo
    write_wav(a, (0.1 * rng.standard_normal((1, 1024))).astype(np.float32),
              44100, float_format=True)
    write_wav(b, (0.1 * rng.standard_normal((1, 800))).astype(np.float32),
              22050, float_format=True)
    write_wav(c, (0.02 * rng.standard_normal((2, 1024))).astype(np.float32),
              44100, float_format=True)
    out_dir = str(tmp_path / "out")
    flags = ["-o", out_dir, "--blocksize", "512", "--upsample", "1",
             "--numtaps", "33", "--dither", "off"]
    # glob input + mixed rates (a, c @44.1k; b @22.05k) + linked mixed
    # channel counts (mono group + stereo group)
    assert main(["batch", str(tmp_path / "[abc].wav")] + flags
                + ["--agc", "--agc-link"]) == 0
    for name, n in (("a.wav", 1024), ("b.wav", 800), ("c.wav", 1024)):
        y, _ = read_wav(os.path.join(out_dir, name))
        assert y.shape[1] == n and np.all(np.isfinite(y))

    with pytest.raises(SystemExit, match="no files match"):
        main(["batch", str(tmp_path / "nope*.wav")] + flags)
    os.makedirs(str(tmp_path / "sub"))
    dup = str(tmp_path / "sub" / "a.wav")
    write_wav(dup, (0.1 * rng.standard_normal((1, 512))).astype(np.float32),
              44100, float_format=True)
    with pytest.raises(SystemExit, match="basenames"):
        main(["batch", a, dup] + flags)


def test_cli_agc_link_respects_preset_agc(tmp_path, rng):
    """--agc-link consults the EFFECTIVE config: a preset that enables AGC
    makes --agc-link work without --agc; a preset that disables AGC makes
    --agc --agc-link fail loudly instead of silently dropping the link."""
    import pytest

    src, dst = str(tmp_path / "in.wav"), str(tmp_path / "out.wav")
    x = (0.02 * rng.standard_normal((1, 22050))).astype(np.float32)
    write_wav(src, np.concatenate([x, np.float32(0.5) * x], axis=0),
              44100, float_format=True)
    store = str(tmp_path / "p.json")
    assert main(["preset", "save", "agcon", "--store", store,
                 "--agc", "--dither", "off"]) == 0
    assert main(["preset", "save", "agcoff", "--store", store,
                 "--dither", "off"]) == 0
    args = ["process", src, dst, "--blocksize", "1024", "--upsample", "1",
            "--numtaps", "65", "--dither", "off", "--preset-store", store]
    assert main(args + ["--preset", "agcon", "--agc-link"]) == 0
    y, _ = read_wav(dst)
    assert np.max(np.abs(y[1] - 0.5 * y[0])) < 3 * 2.0 ** -23  # linked
    assert np.std(y[:, 4096:]) > np.std(x) * 1.5  # and AGC really ran
    with pytest.raises(SystemExit, match="requires AGC"):
        main(args + ["--preset", "agcoff", "--agc", "--agc-link"])


def test_cli_process_viz_plots(tmp_path, rng):
    """--spectrum-plot / --waterfall-plot render the GUI observation
    surfaces offline: both PNGs exist and the spectrum reflects the
    lowpass (HF bins attenuated in the plotted overlay data)."""
    import os

    src, dst = str(tmp_path / "in.wav"), str(tmp_path / "out.wav")
    x = (0.2 * rng.standard_normal((1, 8192))).astype(np.float32)
    write_wav(src, x, 44100, float_format=True)
    sp, wf = str(tmp_path / "spec.png"), str(tmp_path / "wfall.png")
    assert main(["process", src, dst, "--blocksize", "1024", "--upsample",
                 "1", "--numtaps", "129", "--cutoff", "5000",
                 "--dither", "off", "--spectrum-plot", sp,
                 "--waterfall-plot", wf]) == 0
    assert os.path.getsize(sp) > 1000 and os.path.getsize(wf) > 1000


def test_cli_mesh_sharded_matches_single_device(tmp_path, rng):
    """process/batch --mesh N: stream-DP over the virtual mesh — output
    matches the single-device run (batched-FFT ulps), per-file lengths
    survive the silent row padding, and --agc-link groups stay shard-local
    (5 stereo files = 10 rows pad to 16 over 8 shards in whole pairs)."""
    import os

    srcs = []
    for i in range(5):
        s = str(tmp_path / f"m{i}.wav")
        x = (0.02 * rng.standard_normal((1, 900 + 200 * i))).astype(np.float32)
        st = np.concatenate([x, np.float32(0.5) * x], axis=0)
        write_wav(s, st, 44100, float_format=True)
        srcs.append(s)
    flags = ["--blocksize", "512", "--upsample", "2", "--numtaps", "65",
             "--agc", "--agc-link", "--dither", "off"]
    d1, d8 = str(tmp_path / "one"), str(tmp_path / "eight")
    assert main(["batch", *srcs, "-o", d1] + flags) == 0
    assert main(["batch", *srcs, "-o", d8] + flags + ["--mesh", "8"]) == 0
    for i in range(5):
        y1, _ = read_wav(os.path.join(d1, f"m{i}.wav"))
        y8, _ = read_wav(os.path.join(d8, f"m{i}.wav"))
        assert y8.shape == y1.shape == (2, 900 + 200 * i)
        np.testing.assert_allclose(y8, y1, atol=1e-6)
        # the link held inside the sharded run (groups shard-local)
        assert np.max(np.abs(y8[1] - 0.5 * y8[0])) < 3 * 2.0 ** -23

    # single-file process --mesh, eq gains through the sharded path
    dst1, dst8 = str(tmp_path / "p1.wav"), str(tmp_path / "p8.wav")
    pf = ["--blocksize", "512", "--upsample", "2", "--numtaps", "65",
          "--eq-gains", "1,1,1,2,2,1,1,1,1", "--dither", "off"]
    assert main(["process", srcs[0], dst1] + pf) == 0
    assert main(["process", srcs[0], dst8] + pf + ["--mesh", "8"]) == 0
    y1, _ = read_wav(dst1)
    y8, _ = read_wav(dst8)
    np.testing.assert_allclose(y8, y1, atol=1e-6)

    # --mesh + rate conversion fails in the up-front plan (nothing written)
    d_err = str(tmp_path / "err")
    with pytest.raises(SystemExit, match="rate conversion"):
        main(["batch", *srcs, "-o", d_err, "--samplerate", "48000",
              "--mesh", "8", "--blocksize", "512", "--dither", "off"])
    assert not os.path.exists(os.path.join(d_err, "m0.wav"))


# ---------------------------------------------------------------- stream

def test_cli_stream_lockstep_matches_process(tmp_path, rng, capsys):
    """`stream --lockstep -o` captures the paced surface's output; with
    dither off it equals the offline `process` path (the dispatcher is
    1-in-1-out in lockstep: no priming, no drops) to float32 rounding —
    `process` folds the blocks into one batched product, which may round
    differently from the per-block scan."""
    import json

    src = str(tmp_path / "in.wav")
    cap = str(tmp_path / "cap.wav")
    ref = str(tmp_path / "ref.wav")
    x = (0.3 * rng.standard_normal((2, 5000))).astype(np.float32).clip(-1, 1)
    write_wav(src, x, 44100)
    flags = ["--blocksize", "1024", "--upsample", "2", "--numtaps", "65",
             "--dither", "off"]
    assert main(["stream", src, "-o", cap, "--lockstep"] + flags) == 0
    snap = json.loads(capsys.readouterr().out)
    assert snap["blocks"] == 5 and snap["realtime"] is False
    assert snap["drops"] == 0 and snap["fallback_silence"] == 0
    assert main(["process", src, ref] + flags) == 0
    y, rate = read_wav(cap)
    z, _ = read_wav(ref)
    assert rate == 44100 and y.shape == (2, 5000)
    np.testing.assert_allclose(y, z[:, : y.shape[1]], atol=1e-6)


def test_cli_stream_tone_and_viz(tmp_path, capsys):
    """--tone generates the source; the spectrum plot renders from the
    captured output and the metrics line is valid JSON."""
    import json
    import os

    plot = str(tmp_path / "spec.png")
    rc = main(["stream", "--tone", "1000", "--blocks", "4", "--lockstep",
               "--blocksize", "512", "--upsample", "1", "--numtaps", "33",
               "--dither", "off", "--spectrum-plot", plot])
    assert rc == 0
    snap = json.loads(capsys.readouterr().out)
    assert snap["blocks"] == 4
    assert os.path.getsize(plot) > 1000


def test_cli_stream_fault_ladder(tmp_path, rng, capsys):
    """--fault-corrupt exercises the degradation ladder from the CLI: the
    corrupted blocks are replaced (replay rung), the stream completes, and
    the captured output stays finite."""
    import json

    src = str(tmp_path / "in.wav")
    cap = str(tmp_path / "cap.wav")
    write_wav(src, (0.2 * rng.standard_normal((1, 8192))).astype(np.float32),
              44100)
    rc = main(["stream", src, "-o", cap, "--lockstep", "--blocksize", "1024",
               "--upsample", "1", "--numtaps", "33", "--dither", "off",
               "--fault-corrupt", "3"])
    assert rc == 0
    snap = json.loads(capsys.readouterr().out)
    assert snap["fallback_replays"] >= 2  # blocks 3 and 6 of 8
    y, _ = read_wav(cap)
    assert y.shape == (1, 8192) and np.all(np.isfinite(y))


def test_cli_stream_pcm16_io(tmp_path, rng, capsys):
    """int16 in both directions through the paced surface: --ingest pcm16
    + --emit pcm16 captures raw int16 PCM matching the offline process
    path under the same flags.  ±1 LSB: `process` runs the time-folded
    path (fold='prefer'), whose batched product may reassociate at ~1e-7
    (tests/test_fold.py's documented numerics), and the emit16 quantizer
    rounds that onto the odd LSB."""
    from afp.utils import read_wav_pcm16, write_wav_pcm16

    src = str(tmp_path / "in16.wav")
    cap = str(tmp_path / "cap16.wav")
    ref = str(tmp_path / "ref16.wav")
    q = (rng.standard_normal((1, 4096)) * 8000).astype(np.int16)
    write_wav_pcm16(src, q, 44100)
    flags = ["--blocksize", "1024", "--upsample", "2", "--numtaps", "65",
             "--ingest", "pcm16", "--emit", "pcm16", "--dither", "off"]
    assert main(["stream", src, "-o", cap, "--lockstep"] + flags) == 0
    capsys.readouterr()
    assert main(["process", src, ref] + flags) == 0
    y, _ = read_wav_pcm16(cap)
    z, _ = read_wav_pcm16(ref)
    assert y.dtype == np.int16
    diff = np.abs(y.astype(np.int32) - z[:, : y.shape[1]].astype(np.int32))
    assert diff.max() <= 1 and (diff != 0).mean() < 0.01


def test_cli_stream_errors(tmp_path, rng):
    src = str(tmp_path / "in.wav")
    write_wav(src, np.zeros((1, 2048), np.float32), 44100)
    with pytest.raises(SystemExit, match="needs a source"):
        main(["stream"])
    with pytest.raises(SystemExit, match="--seconds or --blocks"):
        main(["stream", "--tone", "440"])
    with pytest.raises(SystemExit, match="--seconds or --blocks"):
        main(["stream", src, "--loop"])
    with pytest.raises(SystemExit, match="single-device dispatcher"):
        main(["stream", src, "--mesh", "2"])
    with pytest.raises(SystemExit, match="must be in"):
        main(["stream", "--tone", "99999", "--blocks", "1"])
    with pytest.raises(SystemExit, match="float samples"):
        main(["stream", "--tone", "440", "--blocks", "1",
              "--ingest", "pcm16"])
    with pytest.raises(SystemExit, match="sound card's own input"):
        main(["stream", src, "--audio"])


def test_cli_stream_realtime_paced(tmp_path, rng, capsys):
    """The default (paced) mode runs the native monotonic pacer: the run
    takes at least (n_blocks-1) block periods of wall time and reports
    realtime=true.  Small shapes keep the engine comfortably under the
    block budget even on a loaded CI box."""
    import json
    import time

    src = str(tmp_path / "in.wav")
    write_wav(src, (0.1 * rng.standard_normal((1, 4 * 2048))
                    ).astype(np.float32), 8000)
    t0 = time.monotonic()
    rc = main(["stream", src, "--blocksize", "2048", "--upsample", "1",
               "--numtaps", "17", "--dither", "off"])
    wall = time.monotonic() - t0
    assert rc == 0
    snap = json.loads(capsys.readouterr().out)
    assert snap["realtime"] is True
    # 4 blocks at 2048/8000 s each: ≥ 3 inter-block waits of wall time
    assert wall >= 3 * (2048 / 8000) * 0.9


def test_cli_stream_checkpoint_resume(tmp_path, rng):
    """Mid-stream checkpoint/resume from the CLI (§5.4): run 1 streams the
    first 5 blocks and checkpoints; run 2 resumes with --skip-blocks; the
    joined captures are bit-identical (at the 24-bit WAV grid) to a single
    full run — WITH dither on (the keyed dither walk rides the state)."""
    src = str(tmp_path / "in.wav")
    x = (0.3 * rng.standard_normal((2, 10000))).astype(np.float32).clip(-1, 1)
    write_wav(src, x, 44100)
    full, h1, h2 = (str(tmp_path / n) for n in ("f.wav", "1.wav", "2.wav"))
    ck = str(tmp_path / "ck.npz")
    flags = ["--lockstep", "--blocksize", "1024", "--upsample", "2",
             "--numtaps", "65"]
    assert main(["stream", src, "-o", full] + flags) == 0
    assert main(["stream", src, "-o", h1, "--blocks", "5",
                 "--checkpoint-out", ck] + flags) == 0
    assert main(["stream", src, "-o", h2, "--skip-blocks", "5",
                 "--resume", ck, "--lockstep"]) == 0
    f, _ = read_wav(full)
    j = np.concatenate([read_wav(h1)[0], read_wav(h2)[0]], axis=1)
    np.testing.assert_array_equal(f, j[:, : f.shape[1]])


def test_cli_stream_resume_errors(tmp_path, rng):
    src = str(tmp_path / "in.wav")
    write_wav(src, np.zeros((2, 4096), np.float32), 44100)
    ck = str(tmp_path / "ck.npz")
    assert main(["stream", src, "--lockstep", "--blocksize", "1024",
                 "--upsample", "1", "--numtaps", "33", "--dither", "off",
                 "--checkpoint-out", ck]) == 0
    mono = str(tmp_path / "mono.wav")
    write_wav(mono, np.zeros((1, 2048), np.float32), 44100)
    with pytest.raises(SystemExit, match="expects 2 channels"):
        main(["stream", mono, "--resume", ck, "--lockstep"])
    with pytest.raises(SystemExit, match="expects 2 channels"):
        main(["stream", "--tone", "440", "--blocks", "2", "--resume", ck])
    wrong_rate = str(tmp_path / "r48.wav")
    write_wav(wrong_rate, np.zeros((2, 2048), np.float32), 48000)
    with pytest.raises(SystemExit, match="48000 Hz"):
        main(["stream", wrong_rate, "--resume", ck, "--lockstep"])
    with pytest.raises(SystemExit, match="only has 4 blocks"):
        main(["stream", src, "--lockstep", "--blocksize", "1024",
              "--upsample", "1", "--numtaps", "33", "--dither", "off",
              "--skip-blocks", "9"])
    with pytest.raises(SystemExit, match="needs an input WAV"):
        main(["stream", "--tone", "440", "--blocks", "2",
              "--skip-blocks", "1"])


def test_cli_process_output_rate_upsampled(tmp_path, rng):
    """--output-rate upsampled writes the high-rate grid: upf× the input
    length at upf× the header rate."""
    src, dst = str(tmp_path / "in.wav"), str(tmp_path / "out.wav")
    n_in = 4096
    x = (0.3 * rng.standard_normal((1, n_in))).astype(np.float32).clip(-1, 1)
    write_wav(src, x, 44100)
    rc = main(["process", src, dst, "--blocksize", "1024", "--upsample", "2",
               "--numtaps", "65", "--cutoff", "10000", "--dither", "off",
               "--output-rate", "upsampled"])
    assert rc == 0
    y, rate = read_wav(dst)
    assert rate == 88200
    assert y.shape == (1, 2 * n_in)
    assert np.all(np.isfinite(y))
    # real audio must fill the WHOLE length (the old trim dropped the
    # second half entirely)
    assert np.std(y[:, n_in:]) > 0.01


def test_cli_process_output_rate_upsampled_asrc(tmp_path, rng):
    """ASRC (--samplerate ≠ file rate) composed with upsampled output:
    length is CEIL(n·sr/rate)·upf at samplerate·upf Hz."""
    src, dst = str(tmp_path / "in.wav"), str(tmp_path / "out.wav")
    n_in = 1001
    x = (0.3 * rng.standard_normal((1, n_in))).astype(np.float32).clip(-1, 1)
    write_wav(src, x, 44100)
    rc = main(["process", src, dst, "--samplerate", "48000",
               "--blocksize", "512", "--upsample", "2", "--numtaps", "65",
               "--cutoff", "10000", "--dither", "off",
               "--output-rate", "upsampled"])
    assert rc == 0
    y, rate = read_wav(dst)
    assert rate == 96000
    assert y.shape[1] == 2 * -(-n_in * 48000 // 44100)
    assert np.all(np.isfinite(y))


def test_cli_stream_output_rate_upsampled_capture(tmp_path, rng, capsys):
    """stream --lockstep -o with upsampled output captures the full
    high-rate stream and matches the offline process path."""
    import json

    src = str(tmp_path / "in.wav")
    cap, ref = str(tmp_path / "cap.wav"), str(tmp_path / "ref.wav")
    x = (0.3 * rng.standard_normal((2, 5000))).astype(np.float32).clip(-1, 1)
    write_wav(src, x, 44100)
    flags = ["--blocksize", "1024", "--upsample", "2", "--numtaps", "65",
             "--dither", "off", "--output-rate", "upsampled"]
    assert main(["stream", src, "-o", cap, "--lockstep"] + flags) == 0
    snap = json.loads(capsys.readouterr().out)
    assert snap["blocks"] == 5 and snap["fallback_silence"] == 0
    assert main(["process", src, ref] + flags) == 0
    y, rate = read_wav(cap)
    z, zrate = read_wav(ref)
    assert rate == 88200 and zrate == 88200
    assert y.shape == (2, 10000) and z.shape == (2, 10000)
    np.testing.assert_array_equal(y, z)


def test_cli_stream_lockstep_asrc_capture(tmp_path, rng, capsys):
    """stream --lockstep with --samplerate ≠ file rate (ASRC) captures
    honestly: the synchronous drain emits a block exactly when a full converted block
    exists — zero underruns, zero fabricated silence, and the capture is
    the offline process output's whole-block prefix."""
    import json

    src = str(tmp_path / "in.wav")
    cap, ref = str(tmp_path / "cap.wav"), str(tmp_path / "ref.wav")
    n_in = 16 * 1024  # 16 source blocks at 48 kHz → ~15052 samples at 44.1 k
    x = (0.3 * rng.standard_normal((1, n_in))).astype(np.float32).clip(-1, 1)
    write_wav(src, x, 48000)
    flags = ["--samplerate", "44100", "--blocksize", "1024",
             "--upsample", "1", "--numtaps", "65", "--dither", "off"]
    assert main(["stream", src, "-o", cap, "--lockstep"] + flags) == 0
    snap = json.loads(capsys.readouterr().out)
    assert snap["underruns"] == 0 and snap["fallback_silence"] == 0
    assert snap["drops"] == 0
    y, rate = read_wav(cap)
    assert rate == 44100
    # whole converted blocks only — nothing fabricated, nothing stretched.
    # The frontend converts in 4160-source-sample super-blocks (l_dev for
    # the 147/160 ratio): 16384 in → 3 chunks × 3822 engine samples =
    # 11466 buffered → 11 whole 1024-blocks; the rest is streaming latency
    # (residual super-block + group delay), flushed only offline
    assert y.shape[1] == 11 * 1024
    assert main(["process", src, ref] + flags) == 0
    z, _ = read_wav(ref)
    np.testing.assert_allclose(y, z[:, : y.shape[1]], atol=2e-6)


def test_cli_output_rate_and_audio_gates(tmp_path, rng):
    """Conflicting-flag combinations exit in CLI style (SystemExit with a
    message), never as raw tracebacks."""
    src, dst = str(tmp_path / "in16.wav"), str(tmp_path / "out.wav")
    q = (rng.standard_normal((1, 2048)) * 8000).astype(np.int16)
    from afp.utils import write_wav_pcm16

    write_wav_pcm16(src, q, 44100)
    # pcm16 ingest with upsampled output is supported (the step converts
    # at device entry, before any stage)
    assert main(["process", src, dst, "--ingest", "pcm16",
                 "--output-rate", "upsampled"]) == 0
    with pytest.raises(SystemExit, match="not supported with --audio"):
        main(["stream", "--audio", "--output-rate", "upsampled"])
    with pytest.raises(SystemExit, match="not supported with --audio"):
        main(["stream", "--audio", "-o", dst])
    with pytest.raises(SystemExit, match="not supported with --audio"):
        main(["stream", "--audio", "--fault-drop", "3"])
    with pytest.raises(SystemExit, match="not supported with --audio"):
        main(["stream", "--audio", "--lockstep"])


def test_cli_stream_audio_resume_upsampled_gate(tmp_path, rng):
    """A --resume'd checkpoint carrying output_rate='upsampled'
    used to bypass the flag-level --audio gate and hit AudioStream's raw
    ValueError — the config-level gate must catch it in CLI style."""
    src = str(tmp_path / "in.wav")
    ck = str(tmp_path / "ck.npz")
    write_wav(src, (0.1 * rng.standard_normal((1, 2048))).astype(np.float32),
              44100)
    assert main(["stream", src, "--lockstep", "--blocksize", "1024",
                 "--upsample", "2", "--numtaps", "33", "--dither", "off",
                 "--output-rate", "upsampled", "--checkpoint-out", ck]) == 0
    with pytest.raises(SystemExit, match="resumed checkpoint"):
        main(["stream", "--audio", "--resume", ck])
