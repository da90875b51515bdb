"""Command-line interface: offline WAV processing through the engine.

The batch counterpart of the reference's real-time scripts — process audio
files through the full pipeline (resample → EQ → FIR → AGC → dither) on
the device::

    python -m afp process in.wav out.wav --cutoff 11000 --numtaps 301
    python -m afp batch 'stems/*.wav' -o filtered/ --agc --agc-link
    python -m afp stream in.wav --seconds 5          # paced live stream
    python -m afp stream --audio --seconds 10        # real sound card
    python -m afp devices
    python -m afp design --cutoff 11000 --numtaps 301 --plot resp.png
    python -m afp preset save warm --store p.json --eq-gains 2,2,1,1,1,1,1,1,1
    python -m afp process in.wav out.wav --preset warm --preset-store p.json

``batch`` packs every file's channels into one [Σ channels, max_len]
array and runs the whole set through a single offline-fold dispatch per
sample-rate group — the stream-DP deployment shape (SURVEY §2.4).

Presets carry the *sound* (gains + filter settings), never deployment shape
(samplerate/blocksize/ingest/emit) — the reference's preset semantics
(`reference/stream_process_GUI_Presets.py:143-195`), persisted to JSON.
"""
from __future__ import annotations

import argparse
import os
import sys

import numpy as np

__all__ = ["main"]


def _add_config_args(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--samplerate", type=int, default=None,
                    help="engine rate (default: the input file's rate)")
    ap.add_argument("--blocksize", type=int, default=2048)
    ap.add_argument("--upsample", type=int, default=2)
    ap.add_argument("--numtaps", type=int, default=129)
    ap.add_argument("--cutoff", type=float, default=14000.0)
    ap.add_argument("--cutoff-high", type=float, default=None,
                    help="second edge for bandpass/bandstop")
    ap.add_argument("--filter-type", default="lowpass",
                    choices=["lowpass", "highpass", "bandpass", "bandstop"])
    ap.add_argument("--window", default="hamming")
    ap.add_argument("--method", default="window", choices=["window", "remez"])
    ap.add_argument("--min-phase", action="store_true")
    ap.add_argument("--eq-gains", default=None,
                    help="comma-separated 9 gains, e.g. 1,1,1,1,1,1,2,2,2")
    ap.add_argument("--agc", action="store_true")
    ap.add_argument("--agc-target", type=float, default=0.1)
    ap.add_argument("--agc-link", action="store_true",
                    help="link the AGC across the file's channels: one gain "
                         "per frame, driven by the loudest channel's RMS — "
                         "keeps the stereo image fixed (independent "
                         "per-channel gains pull it toward the quiet side)")
    ap.add_argument("--dither", default="tpdf", choices=["tpdf", "rpdf", "off"])
    ap.add_argument("--ingest", default="f32", choices=["f32", "pcm16"],
                    help="pcm16: feed 16-bit PCM WAVs raw (exact on-device "
                         "n/32768 conversion, half the transfer bytes; no "
                         "resample)")
    ap.add_argument("--output-rate", default="base",
                    choices=["base", "upsampled"],
                    help="'upsampled': keep the high-rate signal after the "
                         "FIR instead of decimating back — the output WAV "
                         "is at samplerate×upsample (the reference's DAC "
                         "path made explicit; disables the offline fold, "
                         "which only covers the fused single-rate chain)")
    ap.add_argument("--emit", default="f32", choices=["f32", "pcm16"],
                    help="pcm16: the device quantizes the dithered output "
                         "to int16 PCM in the conv store and the WAV is "
                         "written from the raw samples (half the "
                         "device→host bytes; 16-bit output file)")
    ap.add_argument("--mesh", type=int, default=1, metavar="N",
                    help="shard the batch over the first N devices "
                         "(stream DP via ShardedPipeline — rows are padded "
                         "to divide, in whole --agc-link groups; silent "
                         "pad rows are independent streams and never touch "
                         "real output).  1 = single-device engine path")


def _eq_gains_into(args, cfg):
    """Fold --eq-gains into ``cfg.eq_bands`` — the single parse/validate
    point for every path (engine, sharded, preset save)."""
    if not getattr(args, "eq_gains", None):
        return cfg
    import dataclasses

    gains = [float(g) for g in args.eq_gains.split(",")]
    if len(gains) != len(cfg.eq_bands):
        raise SystemExit(f"--eq-gains needs {len(cfg.eq_bands)} values, "
                         f"got {len(gains)}")
    return dataclasses.replace(cfg, eq_bands=tuple(
        dataclasses.replace(b, gain=g)
        for b, g in zip(cfg.eq_bands, gains)))


def _build_config(args, samplerate: int):
    from .engine import StreamConfig

    cutoff = (
        (args.cutoff, args.cutoff_high)
        if args.filter_type in ("bandpass", "bandstop")
        else args.cutoff
    )
    if args.filter_type in ("bandpass", "bandstop") and args.cutoff_high is None:
        raise SystemExit("--cutoff-high required for bandpass/bandstop")
    return StreamConfig(
        samplerate=samplerate,
        blocksize=args.blocksize,
        upsample_factor=args.upsample,
        numtaps=args.numtaps,
        cutoff=cutoff,
        filter_type=args.filter_type,
        window_type=args.window,
        design_method=args.method,
        min_phase=args.min_phase,
        eq_enabled=args.eq_gains is not None,
        agc_enabled=args.agc,
        agc_target_level=args.agc_target,
        dither_kind=args.dither,
        downsample_mode="resample",
        output_clip=0.99 if args.agc else None,
        output_rate=getattr(args, "output_rate", "base"),
    )


def _configure(args, rate: int, batch_rows: int, link_group: int):
    """StreamConfig for ``batch_rows`` rows of ``rate``-Hz audio under the
    process/batch flags: preset overlay, --eq-gains (overrides the
    preset's), --agc-link, ingest/emit gating, ASRC wiring.
    ``link_group`` is only applied when --agc-link is set."""
    import dataclasses

    sr = args.samplerate or rate
    cfg = _build_config(args, sr)
    if getattr(args, "preset", None):
        from .engine.presets import PresetStore

        store = PresetStore(args.preset_store)
        if args.preset not in store:
            raise SystemExit(
                f"unknown preset {args.preset!r} in {args.preset_store}")
        # preset wins for sound fields; deployment fields (samplerate,
        # blocksize, ingest, emit, ...) stay the flags' — PresetStore's
        # EXCLUDED_FIELDS contract
        cfg = store.load_preset(args.preset, cfg)
    cfg = _eq_gains_into(args, cfg)  # after the preset: flags override it
    cfg = dataclasses.replace(cfg, batch=batch_rows)
    if getattr(args, "agc_link", False):
        # consult the EFFECTIVE config: agc_enabled is a sound field a
        # preset may have turned on (then --agc-link alone must work) or
        # off (then linking would be silently inert — fail loudly instead)
        if not cfg.agc_enabled:
            raise SystemExit("--agc-link requires AGC (pass --agc, or a "
                             "preset that enables it)")
        cfg = dataclasses.replace(cfg, agc_link_group=link_group)
    if getattr(args, "ingest", "f32") == "pcm16":
        if sr != rate:
            raise SystemExit("--ingest pcm16 is incompatible with rate "
                             "conversion (drop --samplerate, or use f32)")
        cfg = dataclasses.replace(cfg, ingest="pcm16")
    if getattr(args, "emit", "f32") == "pcm16":
        cfg = dataclasses.replace(cfg, emit="pcm16")
    if sr != rate:
        if getattr(args, "mesh", 1) > 1:
            # validated here so `batch --mesh` fails in the up-front plan
            # pass, before any group is processed and written
            raise SystemExit("--mesh is incompatible with rate conversion "
                             "(the ASRC frontend is an engine surface — "
                             "drop --samplerate or run --mesh 1)")
        cfg = dataclasses.replace(cfg, source_samplerate=rate)
    return cfg


def _out_rate(cfg) -> int:
    """The produced stream's sample rate (upsampled output keeps the
    high-rate grid)."""
    return (cfg.upsampled_rate if cfg.output_rate == "upsampled"
            else cfg.samplerate)


def _out_samples(cfg, n_in: int, rate: int) -> int:
    """Exact output length for `n_in` input samples read at `rate` Hz:
    CEIL under the ASRC (the resample_poly convention — integer
    arithmetic; float division could round an exact product down and
    drop the final sample), ×upsample_factor when the output keeps the
    upsampled grid."""
    n = -(-n_in * cfg.samplerate // rate) if cfg.samplerate != rate else n_in
    if cfg.output_rate == "upsampled":
        n *= cfg.upsample_factor
    return n


def _process_rows(args, cfg, x: np.ndarray, rate: int):
    """[rows, n] through the engine's offline path; returns ``(out, engine)``
    with ``out`` trimmed to the (converted) input length."""
    from .engine import StreamEngine

    engine = StreamEngine(cfg)  # --eq-gains already live in cfg.eq_bands
    n_in = x.shape[1]
    sr = cfg.samplerate
    if engine._asrc_frontend is not None:
        # offline: zero-pad so the resampler tail flushes through the block
        # framing, then trim to the exact converted length
        pad = 2 * cfg.blocksize * rate // sr + engine._asrc_frontend.l_dev
        x = np.concatenate([x, np.zeros((x.shape[0], pad), np.float32)], axis=1)
    elif n_in % cfg.blocksize:
        # zero-pad the final partial block (process_signal scans whole
        # blocks; the causal chain lets us trim back to the input length,
        # so no audio is dropped) — in the ingest dtype (int16 for pcm16)
        rem = cfg.blocksize - n_in % cfg.blocksize
        x = np.concatenate([x, np.zeros((x.shape[0], rem), x.dtype)],
                           axis=1)
    # offline by definition: prefer the time-folded batched fast path (one
    # batched call over all blocks instead of one small step per block);
    # with dither on the fold's noise realization differs from blockwise
    # streaming (same keyed TPDF distribution), which a file-processing
    # run never observes
    out = engine.process_signal(x, fold="prefer")
    # exact output length for the input (CEIL under ASRC — the
    # resample_poly convention; ×upf when the output keeps the upsampled
    # grid) — _out_samples is the single definition
    n_out = _out_samples(cfg, n_in, rate)
    if engine._asrc_frontend is not None or out.shape[1] > n_out:
        out = out[:, :n_out]
    return out, engine


def _process_rows_sharded(args, cfg, x: np.ndarray, n_dev: int):
    """[rows, n] sharded over the first `n_dev` devices (stream DP,
    `ShardedPipeline.process_signal` — the per-shard offline fold).  Rows
    pad with silent streams to divide over the mesh in whole link groups;
    pure DP makes pad rows invisible to real output.  Returns the out
    array trimmed back to the caller's rows and (padded-time) length."""
    import dataclasses

    import jax

    from .engine.config import PipelineParams
    from .parallel import ShardedPipeline, make_mesh

    assert cfg.source_samplerate is None  # _configure rejected --mesh + ASRC
    if len(jax.devices()) < n_dev:
        raise SystemExit(f"--mesh {n_dev}: only {len(jax.devices())} "
                         "devices available")
    rows, n_in = x.shape
    group = cfg.agc_link_group if cfg.agc_enabled else 1
    unit = n_dev * group  # every shard holds whole groups
    if -rows % unit:
        x = np.concatenate(
            [x, np.zeros((-rows % unit, n_in), x.dtype)], axis=0)
    cfg = dataclasses.replace(cfg, batch=x.shape[0])
    if n_in % cfg.blocksize:
        rem = cfg.blocksize - n_in % cfg.blocksize
        x = np.concatenate([x, np.zeros((x.shape[0], rem), x.dtype)], axis=1)
    sp = ShardedPipeline(cfg, make_mesh(n_dev))
    design = PipelineParams.design(sp.cfg)
    params = sp.device_params(design)
    _, out = sp.process_signal(params, sp.init_state(seed=0), x,
                               fold="prefer")
    out = np.asarray(out)[:rows]
    # no ASRC here (rejected above), so rate == cfg.samplerate; the trim
    # still honors output_rate='upsampled' (n_in × upf output samples)
    n_out = _out_samples(cfg, n_in, cfg.samplerate)
    return (out[:, :n_out] if out.shape[1] > n_out else out), design


def _write_out(path: str, out: np.ndarray, cfg) -> None:
    from .utils import write_wav, write_wav_pcm16

    rate = _out_rate(cfg)  # the upsampled grid when output_rate='upsampled'
    if cfg.emit == "pcm16":
        # the device already quantized (dither → int16 in the conv store):
        # write the raw samples verbatim — no host float round trip
        write_wav_pcm16(path, out, rate)
    else:
        write_wav(path, out, rate, width=3)


def _viz_outputs(args, out: np.ndarray, cfg, taps=None) -> None:
    """--spectrum-plot / --waterfall-plot: the reference GUIs' observation
    surfaces (`stream_process_EQ_GUI.py:395-411` spectrum overlay,
    `stream_process_GUI_Waterfall.py:312-339` 3-D history) rendered offline
    from the processed output's first channel, per engine block.  The
    spectrum overlay power-means EVERY block; the waterfall shows the last
    50 (its fixed history depth).  `taps`: the already-designed main
    kernel (avoids re-running the cold design path); designed here only
    if absent."""
    sp = getattr(args, "spectrum_plot", None)
    wf = getattr(args, "waterfall_plot", None)
    if not (sp or wf):
        return
    from .ops.spectrum import WATERFALL_DEPTH, spectrum_db, spectrum_freqs

    y = np.asarray(out[0], dtype=np.float32)
    if out.dtype == np.int16:
        y = y / np.float32(32768.0)
    # the output lives on the emitted grid: blocksize·upf samples per engine
    # block at the upsampled rate when output_rate='upsampled'
    L = (cfg.upsampled_block if cfg.output_rate == "upsampled"
         else cfg.blocksize)
    out_rate = _out_rate(cfg)
    if y.shape[-1] < L:
        y = np.pad(y, (0, L - y.shape[-1]))
    nb = y.shape[-1] // L
    db = np.asarray(spectrum_db(y[: nb * L].reshape(nb, L)))
    freqs = spectrum_freqs(L, float(out_rate))
    if sp:
        from .viz import plot_filter_response

        if taps is None:
            from .engine.config import PipelineParams

            taps = PipelineParams.design(cfg).main_taps
        # power-mean across ALL blocks (a dB mean would bias toward quiet
        # blocks; a tail-only slice would misrepresent long files)
        mean_db = 10.0 * np.log10(np.mean(10.0 ** (db / 10.0), axis=0) + 1e-30)
        plot_filter_response(
            taps, fs=cfg.upsampled_rate,
            filter_type=cfg.filter_type, save_path=sp,
            spectrum=(freqs, mean_db))
        print(f"spectrum plot: {sp}", file=sys.stderr)
    if wf:
        from .viz import plot_waterfall

        # newest-last depth-50 ring, floor-primed — the waterfall_init/push
        # layout with the file's last ≤50 block spectra
        tail = db[-WATERFALL_DEPTH:]
        ring = np.full((WATERFALL_DEPTH, db.shape[-1]), -200.0, np.float32)
        ring[WATERFALL_DEPTH - tail.shape[0]:] = tail
        plot_waterfall(ring, freqs, block_seconds=L / float(out_rate),
                       save_path=wf)
        print(f"waterfall plot: {wf}", file=sys.stderr)


def cmd_process(args) -> int:
    from .utils import read_wav, read_wav_pcm16

    pcm16 = getattr(args, "ingest", "f32") == "pcm16"
    if pcm16:
        # raw int16 path: the WAV's PCM samples ride untouched to the
        # device, which converts exactly (n/32768) — bit-identical output
        # to the f32 path, half the host→device bytes
        x, rate = read_wav_pcm16(args.input)
    else:
        x, rate = read_wav(args.input)
    n_in = x.shape[1]
    cfg = _configure(args, rate, batch_rows=x.shape[0],
                     link_group=x.shape[0])
    if args.mesh > 1:
        out, design = _process_rows_sharded(args, cfg, x, args.mesh)
        tail = f"sharded over {args.mesh} devices"
    else:
        out, engine = _process_rows(args, cfg, x, rate)
        design = engine.design
        tail = f"xRT(busy) {engine.metrics.xrt_busy(cfg.samplerate):,.0f}"
    _write_out(args.output, out, cfg)
    _viz_outputs(args, out, cfg, taps=design.main_taps)
    print(f"{args.input} → {args.output}: {x.shape[0]} ch × {n_in} samples, "
          f"{tail}", file=sys.stderr)
    return 0


def cmd_batch(args) -> int:
    """Process MANY WAVs in one batched device dispatch per group.

    The batch axis is the device's scaling axis (stream DP — SURVEY §2.4):
    a single file's channels leave the device mostly idle, so the batch
    command packs every file's channels into one [Σ channels, max_len]
    array (zero-padded on the right; the chain is causal and each file is
    trimmed back to its own length, so padding never reaches the output)
    and runs the whole directory through ONE offline-fold dispatch.  Files
    are grouped by sample rate (one engine per rate); with --agc-link the
    group key adds the channel count and the link group is per-FILE — a
    quiet file still gets its own gain, only channels within a file share.
    The reference has no offline/batch surface at all (it is a real-time
    mono script, `stream_process.py:22`); this is the deployment shape an
    accelerator actually earns its keep on."""
    import glob as globmod

    from .utils import read_wav, read_wav_pcm16

    pcm16 = args.ingest == "pcm16"
    paths = []
    for pat in args.inputs:
        if any(c in pat for c in "*?["):
            hits = sorted(globmod.glob(pat))
            if not hits:
                raise SystemExit(f"no files match {pat!r}")
            paths.extend(hits)
        else:
            paths.append(pat)
    seen = set()
    paths = [p for p in paths if not (p in seen or seen.add(p))]
    names = [os.path.basename(p) for p in paths]
    dup = {n for n in names if names.count(n) > 1}
    if dup:
        raise SystemExit(
            f"inputs from different directories share output basenames "
            f"{sorted(dup)} — rename or batch them separately")
    reader = read_wav_pcm16 if pcm16 else read_wav
    files = [(p, *reader(p)) for p in paths]

    # one engine per sample rate; --agc-link additionally needs a uniform
    # channel count per group (the link group is the per-file channels)
    groups: dict = {}
    for p, x, rate in files:
        key = (rate, x.shape[0] if args.agc_link else 0)
        groups.setdefault(key, []).append((p, x))
    os.makedirs(args.out_dir, exist_ok=True)
    # validate EVERY group's config up front — a flag incompatible with one
    # group (e.g. --ingest pcm16 under rate conversion) must fail before
    # any other group's files are processed and written
    plan = []
    for (rate, ch), members in sorted(groups.items()):
        rows = sum(x.shape[0] for _, x in members)
        cfg = _configure(args, rate, batch_rows=rows,
                         link_group=ch if args.agc_link else 1)
        cfg.validate()
        plan.append((rate, members, rows, cfg))
    wrote = 0
    for rate, members, rows, cfg in plan:
        n_max = max(x.shape[1] for _, x in members)
        packed = np.zeros((rows, n_max), np.int16 if pcm16 else np.float32)
        row0 = 0
        for _, x in members:
            packed[row0:row0 + x.shape[0], : x.shape[1]] = x
            row0 += x.shape[0]
        if args.mesh > 1:
            out, _ = _process_rows_sharded(args, cfg, packed, args.mesh)
            tail = f"sharded over {args.mesh} devices"
        else:
            out, engine = _process_rows(args, cfg, packed, rate)
            tail = ("xRT(busy) "
                    f"{engine.metrics.xrt_busy(cfg.samplerate):,.0f}")
        row0 = 0
        for p, x in members:
            n = x.shape[1]
            y = out[row0:row0 + x.shape[0]]
            # per-file trim: the group was trimmed to ITS max length above;
            # _out_samples covers ASRC ceil AND the upsampled output grid
            y = y[:, : _out_samples(cfg, n, rate)]
            _write_out(os.path.join(args.out_dir, os.path.basename(p)),
                       y, cfg)
            row0 += x.shape[0]
            wrote += 1
        print(f"{rate} Hz group: {len(members)} files as {rows} rows × "
              f"{n_max} samples in one dispatch, {tail}", file=sys.stderr)
    print(f"{wrote} files → {args.out_dir}", file=sys.stderr)
    return 0


def cmd_stream(args) -> int:
    """Live streaming from the CLI — the reference's deployment shape (its
    scripts run a paced duplex stream until interrupted,
    `reference/stream_process.py:100-130`), previously reachable only
    through the example scripts.

    Default backend is the hardware-free
    :class:`~afp.runtime.dispatcher.SimulatedStream`: the native
    monotonic pacer enforces the true block rate, so underruns/overruns
    and engine load are real measurements.  ``--lockstep`` drops the
    pacing (1-in-1-out, no priming silence, nothing dropped) — the mode
    to use with ``-o`` captures; with an ASRC (--samplerate ≠ file rate)
    lockstep drives the engine synchronously and emits a block exactly
    when a full converted block exists (variable cadence, still nothing
    fabricated or dropped).  ``--audio`` opens the PortAudio duplex
    bridge on hosts with a sound card (mic → engine → speakers; no input
    file).  ``--fault-*`` inject driver faults to exercise the
    degradation ladder (§5.3).  Exit prints ONE JSON metrics line
    (blocks, underruns, overruns, drops, ladder counters, xrt_busy, ring
    stats) to stdout."""
    import json
    import math
    import time as timemod

    from .engine import StreamEngine

    if args.mesh > 1:
        raise SystemExit("stream runs the single-device dispatcher; "
                         "--mesh applies to process/batch")
    pcm16 = args.ingest == "pcm16"

    # ---- source material ----
    if args.audio:
        if args.input or args.tone is not None:
            raise SystemExit("--audio streams the sound card's own input; "
                             "drop the input file/--tone")
        # the PortAudio path has no capture sink, no block source to fault,
        # and no offline viz buffer — reject the flags loudly instead of
        # silently ignoring them (matching the command's other strict checks)
        for flag, val in (("-o/--output", args.output),
                          ("--loop", args.loop),
                          ("--spectrum-plot", args.spectrum_plot),
                          ("--waterfall-plot", args.waterfall_plot),
                          ("--fault-drop", args.fault_drop),
                          ("--fault-late", args.fault_late),
                          ("--fault-corrupt", args.fault_corrupt),
                          ("--lockstep", args.lockstep)):
            if val:
                raise SystemExit(f"{flag} is not supported with --audio "
                                 "(the PortAudio duplex path has no "
                                 "simulated source/sink)")
        if args.output_rate == "upsampled":
            # AudioStream's duplex contract is base-rate (runtime/audio.py
            # rejects it with a raw ValueError) — fail in CLI style
            raise SystemExit("--output-rate upsampled is not supported with "
                             "--audio (the duplex callback is base-rate "
                             "1-in-1-out)")
        rate = args.samplerate or 44100
        batch = 1
        x = None
    elif args.input:
        from .utils import read_wav, read_wav_pcm16

        x, rate = (read_wav_pcm16 if pcm16 else read_wav)(args.input)
        batch = x.shape[0]
    elif args.tone is not None:
        if pcm16:
            raise SystemExit("--tone generates float samples; use f32 "
                             "ingest (or stream a 16-bit WAV)")
        rate = args.samplerate or 44100
        if args.tone <= 0 or args.tone >= rate / 2:
            raise SystemExit(f"--tone must be in (0, {rate // 2}) Hz")
        batch = 1
        x = None  # generated per block below (needs cfg.blocksize first)
    else:
        raise SystemExit("stream needs a source: an input WAV, --tone HZ, "
                         "or --audio")

    if args.resume:
        # restore the checkpointed engine VERBATIM (§5.4: bit-exact
        # mid-stream resume) — the checkpoint's config governs; design/
        # deployment flags on the command line are ignored, except the
        # transport flags, which must agree with how the source is read
        from .engine.checkpoint import load_checkpoint

        engine = load_checkpoint(args.resume)
        cfg = engine.cfg
        if (cfg.ingest == "pcm16") != pcm16:
            raise SystemExit(f"--resume: checkpoint has ingest="
                             f"{cfg.ingest!r}; pass matching --ingest")
        if x is not None and x.shape[0] != cfg.batch:
            raise SystemExit(f"--resume: checkpoint expects {cfg.batch} "
                             f"channels, input has {x.shape[0]}")
        if args.tone is not None and cfg.batch != 1:
            raise SystemExit("--resume: checkpoint expects "
                             f"{cfg.batch} channels; --tone generates 1")
        src_rate = cfg.source_samplerate or cfg.samplerate
        if rate != src_rate and not args.audio:
            raise SystemExit(f"--resume: checkpoint expects {src_rate} Hz "
                             f"input, source is {rate} Hz")
    else:
        cfg = _configure(args, rate, batch_rows=batch, link_group=batch)
        engine = None  # built after duration validation
    L = cfg.blocksize

    # ---- duration ----
    nb_file = None
    if x is not None:
        n_in = x.shape[1]
        if n_in % L:  # zero-pad the final partial block, in the ingest dtype
            x = np.concatenate(
                [x, np.zeros((batch, L - n_in % L), x.dtype)], axis=1)
        nb_file = x.shape[1] // L
        if args.skip_blocks:
            # resume workflows: run 1 streams blocks [0, K) and
            # checkpoints; run 2 streams [K, …) with --resume
            if args.skip_blocks >= nb_file:
                raise SystemExit(f"--skip-blocks {args.skip_blocks}: the "
                                 f"input only has {nb_file} blocks")
            x = x[:, args.skip_blocks * L:]
            n_in = max(0, n_in - args.skip_blocks * L)
            nb_file -= args.skip_blocks
    elif args.skip_blocks:
        raise SystemExit("--skip-blocks needs an input WAV")
    if args.blocks is not None:
        n_blocks = args.blocks
    elif args.seconds is not None:
        n_blocks = max(1, math.ceil(args.seconds * rate / L))
    elif nb_file is not None and not args.loop:
        n_blocks = nb_file
    elif args.audio:
        n_blocks = None  # until Ctrl-C
    else:
        raise SystemExit("--tone/--loop streams need --seconds or --blocks")
    if args.loop and nb_file is None:
        raise SystemExit("--loop needs an input WAV")

    if engine is None:
        engine = StreamEngine(cfg)

    # ---- real sound card (PortAudio duplex) ----
    if args.audio:
        if cfg.output_rate == "upsampled":
            # the flag-level gate above catches --output-rate; this catches
            # a --resume'd checkpoint whose CONFIG carries upsampled output
            raise SystemExit("--audio requires base-rate output; the "
                             "resumed checkpoint was saved with "
                             "output_rate='upsampled'")
        from .runtime.audio import AudioStream

        device = None
        if args.device is not None:
            parts = args.device.split(",")
            device = (int(parts[0]), int(parts[-1]))
        stream = AudioStream(engine, device=device)
        stream.start()
        try:
            if args.blocks is not None:
                # no simulated tick to count — poll the engine's own block
                # counter until the requested number has been processed
                while engine.metrics.blocks_processed < args.blocks:
                    timemod.sleep(min(0.05, L / rate))
            elif args.seconds is not None:
                timemod.sleep(args.seconds)
            else:
                print("streaming (Ctrl-C to stop)…", file=sys.stderr)
                while True:
                    timemod.sleep(1.0)
        except KeyboardInterrupt:
            pass
        finally:
            stream.stop()
            snap = engine.metrics.snapshot()
            snap["cpu_load"] = round(stream.cpu_load, 4)
            stream.close()
        snap["xrt_busy"] = round(engine.metrics.xrt_busy(cfg.samplerate), 1)
        if args.checkpoint_out:
            from .engine.checkpoint import save_checkpoint

            save_checkpoint(args.checkpoint_out, engine)
            print(f"checkpoint → {args.checkpoint_out}", file=sys.stderr)
        print(json.dumps(snap))
        return 0

    # ---- simulated paced stream ----
    from .runtime.dispatcher import FaultInjector, SimulatedStream

    if x is not None:
        def source(i: int):
            j = i % nb_file if args.loop else i
            if j >= nb_file:
                return np.zeros((batch, L), x.dtype)  # past EOF (--seconds)
            return x[:, j * L:(j + 1) * L]
    else:  # --tone
        t = np.arange(L, dtype=np.float64) / rate
        omega = 2.0 * np.pi * args.tone

        def source(i: int):
            ph = omega * (i * L / rate + t)
            return (0.3 * np.sin(ph)).astype(np.float32)[None, :]

    faults = None
    if args.fault_drop or args.fault_late or args.fault_corrupt:
        faults = FaultInjector(
            drop_every=args.fault_drop or None,
            late_every=args.fault_late or None,
            late_seconds=args.fault_late_ms / 1000.0,
            corrupt_every=args.fault_corrupt or None)

    captured = [] if (args.output or args.spectrum_plot
                      or args.waterfall_plot) else None
    sink = captured.append if captured is not None else None
    stream = SimulatedStream(engine, source, sink=sink, faults=faults,
                             realtime=not args.lockstep)
    snap = stream.run(n_blocks=n_blocks)

    if captured is not None and captured:
        out = np.concatenate(captured, axis=1)
        # trim the final block's zero pad back off a non-looped file run
        # (no ASRC: the chain is causal, so the pad never alters real
        # samples; under ASRC the stream keeps whole converted blocks).
        # _out_samples maps n_in to the output grid (×upf for upsampled)
        if (nb_file is not None and not args.loop
                and cfg.source_samplerate is None
                and n_blocks == nb_file):
            n_out = _out_samples(cfg, n_in, rate)
            if out.shape[1] > n_out:
                out = out[:, :n_out]
        if args.output:
            _write_out(args.output, out, cfg)
            print(f"captured {out.shape[1]} samples × {out.shape[0]} ch "
                  f"→ {args.output}", file=sys.stderr)
        _viz_outputs(args, out, cfg, taps=engine.design.main_taps)
    if args.checkpoint_out:
        from .engine.checkpoint import save_checkpoint

        save_checkpoint(args.checkpoint_out, engine)
        print(f"checkpoint → {args.checkpoint_out}", file=sys.stderr)
    snap["xrt_busy"] = round(engine.metrics.xrt_busy(cfg.samplerate), 1)
    snap["realtime"] = not args.lockstep
    print(json.dumps(snap))
    return 0


def cmd_preset(args) -> int:
    """Preset store CRUD — the reference GUI's save/load/delete combobox
    (`stream_process_GUI_Presets.py:143-195`) as a scriptable surface."""
    import json

    from .engine.presets import PresetStore

    store = PresetStore(args.store)
    if args.action == "list":
        for n in store.names:
            print(n)
        return 0
    if not args.name:
        raise SystemExit(f"preset {args.action} requires a preset name")
    if args.action == "delete":
        if args.name not in store:
            raise SystemExit(f"unknown preset {args.name!r} in {args.store}")
        store.delete_preset(args.name)
        return 0
    if args.action == "show":
        try:
            print(json.dumps(store.get(args.name), indent=2))
        except KeyError:
            raise SystemExit(f"unknown preset {args.name!r} in {args.store}")
        return 0
    # save: snapshot the sound the design/EQ/AGC flags describe
    cfg = _eq_gains_into(args, _build_config(args, args.samplerate or 44100))
    store.save_preset(args.name, cfg.validate())
    print(f"saved preset {args.name!r} → {args.store}", file=sys.stderr)
    return 0


def cmd_devices(_args) -> int:
    from .runtime.devices import format_devices

    print(format_devices())
    return 0


def cmd_design(args) -> int:
    from .design import create_fir_filter

    cutoff = (
        [args.cutoff, args.cutoff_high]
        if args.filter_type in ("bandpass", "bandstop")
        else args.cutoff
    )
    h = create_fir_filter(
        method=args.method, cutoff=cutoff, numtaps=args.numtaps,
        window_type=args.window, filter_type=args.filter_type,
        samplerate=(args.samplerate or 44100) * args.upsample,
    )
    if args.plot:
        from .viz import plot_filter_response

        plot_filter_response(h, fs=(args.samplerate or 44100) * args.upsample,
                             filter_type=args.filter_type, save_path=args.plot)
        print(f"plot: {args.plot}", file=sys.stderr)
    np.savetxt(args.taps_out, h) if args.taps_out else print(h)
    return 0


def build_parser() -> argparse.ArgumentParser:
    """The ``afp`` argument parser (every subcommand)."""
    ap = argparse.ArgumentParser(prog="afp")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("process", help="process WAV through the pipeline")
    p.add_argument("input")
    p.add_argument("output")
    _add_config_args(p)
    p.add_argument("--preset", default=None,
                   help="apply a named preset from --preset-store on top of "
                        "the flags (sound fields only — deployment flags "
                        "like --blocksize/--ingest stay yours; --eq-gains "
                        "still overrides the preset's gains)")
    p.add_argument("--preset-store", default="presets.json",
                   help="preset JSON file (default: ./presets.json)")
    p.add_argument("--spectrum-plot", default=None, metavar="PNG",
                   help="save the filter response with the processed "
                        "output's spectrum overlaid (the GUI's observation "
                        "surface, offline)")
    p.add_argument("--waterfall-plot", default=None, metavar="PNG",
                   help="save the 3-D waterfall of the output's last 50 "
                        "block spectra (the waterfall GUI, offline)")
    p.set_defaults(fn=cmd_process)

    b = sub.add_parser(
        "batch", help="process many WAVs in one batched device dispatch")
    b.add_argument("inputs", nargs="+",
                   help="WAV paths and/or glob patterns (quote globs)")
    b.add_argument("-o", "--out-dir", required=True,
                   help="output directory (same basenames)")
    _add_config_args(b)
    b.add_argument("--preset", default=None,
                   help="apply a named preset from --preset-store on top "
                        "of the flags (sound fields only)")
    b.add_argument("--preset-store", default="presets.json",
                   help="preset JSON file (default: ./presets.json)")
    b.set_defaults(fn=cmd_batch)

    st = sub.add_parser(
        "stream",
        help="live paced streaming (simulated pacer or real sound card)")
    st.add_argument("input", nargs="?", default=None,
                    help="WAV source (omit with --tone or --audio)")
    st.add_argument("-o", "--output", default=None,
                    help="capture the processed stream to a WAV (use "
                         "--lockstep: realtime captures include the "
                         "output ring's priming silence)")
    _add_config_args(st)
    st.add_argument("--preset", default=None,
                    help="apply a named preset from --preset-store (sound "
                         "fields only)")
    st.add_argument("--preset-store", default="presets.json")
    st.add_argument("--seconds", type=float, default=None,
                    help="stream duration (default: the input file's length)")
    st.add_argument("--blocks", type=int, default=None,
                    help="stream duration in engine blocks (wins over "
                         "--seconds)")
    st.add_argument("--loop", action="store_true",
                    help="loop the input WAV (needs --seconds/--blocks)")
    st.add_argument("--tone", type=float, default=None, metavar="HZ",
                    help="stream a generated sine instead of a file")
    st.add_argument("--lockstep", action="store_true",
                    help="no pacing: 1-in-1-out as fast as possible (the "
                         "offline capture mode; default paces at the true "
                         "block rate off the native monotonic pacer)")
    st.add_argument("--audio", action="store_true",
                    help="real PortAudio duplex stream (mic → engine → "
                         "speakers); requires the sounddevice backend")
    st.add_argument("--device", default=None,
                    help="--audio device index or 'in,out' pair")
    st.add_argument("--fault-drop", type=int, default=0, metavar="N",
                    help="drop every Nth input block (ladder demo)")
    st.add_argument("--fault-late", type=int, default=0, metavar="N",
                    help="delay every Nth input block by --fault-late-ms")
    st.add_argument("--fault-late-ms", type=float, default=5.0)
    st.add_argument("--fault-corrupt", type=int, default=0, metavar="N",
                    help="NaN-poison every Nth input block (full-scale "
                         "click under pcm16 ingest)")
    st.add_argument("--checkpoint-out", default=None, metavar="NPZ",
                    help="save a bit-exact engine checkpoint at stream end "
                         "(§5.4 — resume later with --resume)")
    st.add_argument("--resume", default=None, metavar="NPZ",
                    help="restore the engine from a checkpoint and continue "
                         "the stream bit-exactly; the checkpoint's config "
                         "governs (design flags on this command line are "
                         "ignored).  Pair with --skip-blocks to continue "
                         "an input file where the first run stopped")
    st.add_argument("--skip-blocks", type=int, default=0, metavar="K",
                    help="start the input WAV K engine blocks in")
    st.add_argument("--spectrum-plot", default=None, metavar="PNG",
                    help="save the response + captured-output spectrum")
    st.add_argument("--waterfall-plot", default=None, metavar="PNG",
                    help="save the captured output's 3-D waterfall")
    st.set_defaults(fn=cmd_stream)

    pr = sub.add_parser(
        "preset", help="save/list/show/delete sound presets (JSON store)")
    pr.add_argument("action", choices=["save", "list", "show", "delete"])
    pr.add_argument("name", nargs="?", default=None)
    pr.add_argument("--store", default="presets.json",
                    help="preset JSON file (default: ./presets.json)")
    _add_config_args(pr)
    pr.set_defaults(fn=cmd_preset)

    d = sub.add_parser("devices", help="list accelerator devices")
    d.set_defaults(fn=cmd_devices)

    g = sub.add_parser("design", help="design a filter, print/save taps")
    _add_config_args(g)
    g.add_argument("--plot", default=None, help="save response plot PNG")
    g.add_argument("--taps-out", default=None, help="save taps to a text file")
    g.set_defaults(fn=cmd_design)
    return ap


def main(argv=None) -> int:
    from .utils.jax_cache import enable_compile_cache

    enable_compile_cache()
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
