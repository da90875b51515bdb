"""The fused streaming pipeline (device hot path).

Re-creates the reference block chain — ASRC → AGC → upsample → multiband EQ →
main FIR → downsample → clip → dither (`reference/stream_process_AGC.py
:91-201`, `stream_process.py:79-120`) — as one jitted step over
device-resident ``[batch, block]`` arrays, with all streaming state carried
functionally so the whole run can be a single ``lax.scan``.

Fusion beyond the reference's combined-EQ-kernel trick
(`stream_process_EQ_GUI.py:87-90`): the EQ bank *and* the main filter are
folded into ONE frequency response,

    H_comb = (Σ_i gain_i · H_band_i) · H_main

so the entire filtering stage is a single rfft → complex multiply → irfft
overlap-save pass (or, with ``conv_strategy='td_mxu'``, one band-matrix
product with the same cascade kernel).  Gain changes are a
[1, n_bands] × [n_bands, F] product — runtime data, never a recompile (the
glitch-free reconfig property, SURVEY.md §2.4).

Backends: on a GPU the AGC recurrence runs the Triton-route Pallas kernel
(`ops/pallas/agc_scan.py`); on the CPU every stage is its plain JAX
reference (tests and small runs).  Any other backend is an error
(`ops/backend.py`).

Latency semantics: one block in → one block out, zero-primed state — the
same contract as the reference's sounddevice callback.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..ops.agc import (AGCParams, desired_gain, moving_rms, smooth_gain_blockwise,
                       smooth_gain_parallel, smooth_gain_scan)
from ..ops.backend import device_platform
from ..ops.convolve import band_conv, next_pow2
from ..ops.dither import dither
from ..ops.pcm16 import pcm16_to_f32, quantize_pcm16
from ..ops.resample import PolyResampler, decimate
from .config import PipelineParams, StreamConfig

__all__ = ["DeviceParams", "StreamState", "Pipeline"]

#: chunk of the blockwise AGC recurrence (``agc_mode='fast'``)
AGC_FAST_CHUNK = 32


class DeviceParams(NamedTuple):
    """Runtime (dynamic) parameter bank living in device memory.

    Swapping these arrays is the device expression of the reference's
    double-buffered `filter_lock` parameter swap
    (`stream_process_EQ_GUI.py:50-55, 380-385`): same shapes → no recompile.
    """

    H_bands: jnp.ndarray  # [n_bands, F] band kernel spectra
    H_main: jnp.ndarray  # [F] main kernel spectrum, or a [B, F] bank
    eq_gains: jnp.ndarray  # [n_bands], or a [B, n_bands] bank
    agc_target: jnp.ndarray  # [] scalar or [B]
    agc_max_gain: jnp.ndarray  # []
    agc_a_att: jnp.ndarray  # []
    agc_a_rel: jnp.ndarray  # []
    # time-domain cascade taps (fused path; for the 'td_mxu' strategy)
    casc_bands: Optional[jnp.ndarray] = None  # [n_bands, n_casc]
    casc_main: Optional[jnp.ndarray] = None  # [n_casc]

    def combined_response(self, eq_enabled: bool,
                          premultiplied: bool = False) -> jnp.ndarray:
        """The live frequency response.

        `premultiplied=False`: H_bands are raw band spectra → multiply the
        gain-combined EQ by H_main (the literal multirate chain).
        `premultiplied=True` (fused single-rate path): H_bands are already
        full per-band *cascade* spectra (upsampler ⊛ band ⊛ main ⊛
        downsampler, phase-0 polyphase) → just gain-combine; H_main is the
        no-EQ cascade.
        """
        if eq_enabled and self.H_bands.shape[0] > 0:
            # HIGHEST: a DEFAULT f32 contraction may round its inputs
            # (TF32 on the GPU) and miss the −90 dB contract
            H_eq = jnp.tensordot(self.eq_gains, self.H_bands, axes=1,
                                 precision=jax.lax.Precision.HIGHEST)
            return H_eq if premultiplied else H_eq * self.H_main
        return self.H_main

    def combined_cascade(self, eq_enabled: bool) -> jnp.ndarray:
        """Time-domain fused kernel [n_casc] (td_mxu strategy): the gain
        combination is linear in the taps, same as in frequency."""
        if eq_enabled and self.casc_bands is not None and self.casc_bands.shape[0] > 0:
            return jnp.tensordot(self.eq_gains, self.casc_bands, axes=1,
                                 precision=jax.lax.Precision.HIGHEST)
        return self.casc_main

    def per_stream(self) -> bool:
        """True for row-level banks (per-stream EQ gains or main filters),
        which always run through the [B, F] frequency response."""
        return (getattr(self.eq_gains, "ndim", 1) == 2
                or getattr(self.H_main, "ndim", 1) == 2)


class StreamState(NamedTuple):
    """Carried streaming state (pytree; all shapes static)."""

    asrc: Optional[PolyResampler]
    up: Optional[PolyResampler]
    conv_tail: jnp.ndarray  # [B, N_f − 1] f32 overlap-save input history
    down: Optional[PolyResampler]
    agc_gain: Optional[jnp.ndarray]  # [B] carried smoothed gain
    key: jax.Array
    #: [B, 50, n_bins] scan-carried spectrum ring (waterfall_enabled)
    wf: Optional[jnp.ndarray] = None


class Pipeline:
    """Compiled streaming pipeline for a fixed (static) StreamConfig.

    Usage::

        pipe = Pipeline(cfg)
        params = pipe.device_params(PipelineParams.design(cfg))
        state = pipe.init_state(seed=0)
        state, out = pipe.step(params, state, block)      # jitted
        state, outs = pipe.run(params, state, blocks)     # lax.scan over time
    """

    def __init__(self, cfg: StreamConfig):
        cfg = cfg.validate()
        self.cfg = cfg
        self.batch = cfg.batch
        self.block = cfg.blocksize
        self.upf = cfg.upsample_factor
        self.up_block = cfg.blocksize * cfg.upsample_factor
        #: 'gpu' (compiled kernels) or 'cpu' (plain references)
        self.platform = device_platform()

        # fused kernel length: EQ band (numtaps') ⊛ main (numtaps')
        n_design = cfg.numtaps // 2 + cfg.numtaps % 2 if cfg.min_phase else cfg.numtaps
        self.n_kernel = n_design
        self.n_fused = (
            2 * n_design - 1 if (cfg.eq_enabled and len(cfg.eq_bands) > 0) else n_design
        )

        # --- single-rate fusion ---
        # upsample(U) → filter → downsample(U) with base-rate output is
        # algebraically y[n] = Σ_p cascade[U·(n−p)]·x[p]: ONE base-rate FIR
        # with the phase-0 polyphase component of the full cascade.
        # upsampled-rate output keeps the literal multirate chain (the fusion
        # exists precisely because the output returns to base rate)
        self.upsampled_out = cfg.output_rate == "upsampled" and self.upf > 1
        self.fused = bool(cfg.fuse_rate_conversion) and not self.upsampled_out
        if self.fused:
            from ..ops.resample import streaming_kernel

            if self.upf > 1:
                self._h_up_np = streaming_kernel(
                    self.upf, 1, quality=cfg.resample_quality)
                self._h_down_np = (
                    streaming_kernel(1, self.upf, quality=cfg.resample_quality)
                    if cfg.downsample_mode == "resample"
                    else None
                )
            else:
                self._h_up_np = np.ones(1)
                self._h_down_np = None
            n_total = len(self._h_up_np) + self.n_fused - 1
            if self._h_down_np is not None:
                n_total += len(self._h_down_np) - 1
            self.n_casc = -(-n_total // self.upf)  # ceil: decimated length
            self.nfft = next_pow2(self.block + self.n_casc - 1)
        else:
            self.n_casc = None
            self.nfft = next_pow2(self.up_block + self.n_fused - 1)

        #: td_mxu strategy: the cascade runs as one band-matrix product
        #: (`ops.convolve.band_conv`) instead of the FFT pass
        self._use_td = self.fused and cfg.conv_strategy == "td_mxu"
        self.agc = AGCParams(
            target_level=cfg.agc_target_level,
            window_size=cfg.agc_window_size,
            max_gain=cfg.agc_max_gain,
            attack=cfg.agc_attack,
            release=cfg.agc_release,
        )
        #: the AGC recurrence runs the Triton kernel on the GPU; 'parallel'
        #: mode and the CPU run the plain JAX forms
        self._agc_kernel = (cfg.agc_enabled and self.platform == "gpu"
                            and cfg.agc_mode != "parallel")
        #: int16 PCM at the boundaries: ingest converts n/32768 at device
        #: entry (exact), emit quantizes in the output epilogue
        self._i16_ingest = cfg.ingest == "pcm16"
        self._emit16 = cfg.emit == "pcm16"
        # Device-side ASRC runs only in 'compat' mode (reference semantics);
        # in 'exact' mode the StreamEngine's host AsrcFrontend owns rate
        # conversion and the device pipeline sees engine-rate blocks.
        self._asrc_device = bool(
            cfg.source_samplerate
            and cfg.source_samplerate != cfg.samplerate
            and cfg.asrc_mode == "compat"
        )
        # compat submode: streaming when the block divides the reduced
        # decimation factor, else the reference's stateless per-block
        # conversion (`stream_process_AGC.py:126-129`)
        self._asrc_stateless = False
        if self._asrc_device:
            import math as _math

            g = _math.gcd(cfg.samplerate, cfg.source_samplerate)
            self._asrc_stateless = bool(self.block % (cfg.source_samplerate // g))

        # NOTE: no donate_argnums — the engine's degradation ladder keeps the
        # previous state alive to recover from a failed step (a donated state
        # buffer would be dead after any exception).  State is tiny (tails),
        # so donation buys nothing here.
        self._step = jax.jit(self._step_impl)
        self._run = jax.jit(self._run_impl)

    # ---------------- dynamic reconfiguration ----------------

    def refresh_dynamic(self, cfg: StreamConfig) -> None:
        """Absorb a dynamic-only config change (same `static_key()`):
        update `cfg` and re-derive the AGC α values so subsequent
        :meth:`device_params` banks reflect the new target/attack/release.
        Shapes are untouched — no recompile."""
        if cfg.static_key() != self.cfg.static_key():
            raise ValueError("refresh_dynamic requires an identical static_key")
        self.cfg = cfg
        self.agc = AGCParams(
            target_level=cfg.agc_target_level,
            window_size=cfg.agc_window_size,
            max_gain=cfg.agc_max_gain,
            attack=cfg.agc_attack,
            release=cfg.agc_release,
        )

    # ---------------- parameter bank ----------------

    def device_params(self, p: PipelineParams,
                      cfg: "StreamConfig | None" = None,
                      agc: "AGCParams | None" = None) -> DeviceParams:
        """Upload a designed parameter bank (kernel spectra at the pipeline's
        static FFT length, so swaps never change shapes).

        `cfg`/`agc` override the pipeline's current dynamic fields — this
        lets a reconfig build the NEW bank entirely outside the swap lock
        (host convolutions + device uploads take tens of ms; holding the
        lock for them would stall the real-time thread).

        On the fused path, per-band kernels become full *cascade* kernels —
        float64 host convolution of upsampler ⊛ band ⊛ main [⊛ downsampler],
        decimated to the phase-0 polyphase component — keeping the response
        linear in the EQ gains (glitch-free live gain updates preserved).
        """
        cfg = cfg if cfg is not None else self.cfg
        agc = agc if agc is not None else self.agc
        # when the EQ bank is unused, H_bands is a [1, F] zeros placeholder
        # gated off statically (no zero-size device arrays)
        n_b = p.eq_taps.shape[0] if (cfg.eq_enabled and len(cfg.eq_bands)) else 0
        placeholder = lambda: jnp.fft.rfft(
            jnp.zeros((1, 8), dtype=jnp.float32), n=self.nfft
        )
        if self.fused:
            main64 = np.asarray(p.main_taps, dtype=np.float64)

            def cascade(band: np.ndarray | None) -> np.ndarray:
                k = np.convolve(self._h_up_np, main64)
                if band is not None:
                    k = np.convolve(k, band)
                if self._h_down_np is not None:
                    k = np.convolve(k, self._h_down_np)
                k = k[:: self.upf]  # phase-0 polyphase component
                out = np.zeros(self.n_casc)
                out[: len(k)] = k
                return out

            if n_b:
                bands = np.stack(
                    [cascade(np.asarray(b, dtype=np.float64)) for b in p.eq_taps]
                )
                H_bands = jnp.fft.rfft(
                    jnp.asarray(bands, dtype=jnp.float32), n=self.nfft, axis=-1
                )
            else:
                H_bands = placeholder()
            H_main = jnp.fft.rfft(
                jnp.asarray(cascade(None), dtype=jnp.float32), n=self.nfft
            )
        else:
            H_bands = jnp.fft.rfft(
                jnp.asarray(p.eq_taps, dtype=jnp.float32), n=self.nfft, axis=-1
            ) if n_b else placeholder()
            H_main = jnp.fft.rfft(
                jnp.asarray(p.main_taps, dtype=jnp.float32), n=self.nfft
            )
        gains = np.asarray(p.eq_gains, dtype=np.float32)
        if gains.size == 0 or not n_b:
            gains = np.zeros(H_bands.shape[0], dtype=np.float32)
        casc_bands = casc_main = None
        if self._use_td:
            casc_main = jnp.asarray(cascade(None), dtype=jnp.float32)
            casc_bands = (jnp.asarray(bands, dtype=jnp.float32) if n_b
                          else jnp.zeros((1, self.n_casc), dtype=jnp.float32))
        return DeviceParams(
            H_bands=H_bands,
            H_main=H_main,
            eq_gains=jnp.asarray(gains),
            casc_bands=casc_bands,
            casc_main=casc_main,
            agc_target=jnp.float32(cfg.agc_target_level),
            agc_max_gain=jnp.float32(cfg.agc_max_gain),
            agc_a_att=jnp.float32(agc.a_att),
            agc_a_rel=jnp.float32(agc.a_rel),
        )

    # ---------------- state ----------------

    def init_state(self, seed: int = 0) -> StreamState:
        cfg = self.cfg
        B = (self.batch,)
        asrc = None
        if self._asrc_device and not self._asrc_stateless:
            asrc = PolyResampler.init(
                cfg.samplerate, cfg.source_samplerate, block=self.block,
                batch_shape=B, quality=cfg.resample_quality,
            )
        up = None
        if self.upf > 1 and not self.fused:
            up = PolyResampler.init(self.upf, 1, block=self.block,
                                    batch_shape=B,
                                    quality=cfg.resample_quality)
        down = None
        if (self.upf > 1 and cfg.downsample_mode == "resample"
                and not self.fused and not self.upsampled_out):
            down = PolyResampler.init(1, self.upf, block=self.up_block,
                                      batch_shape=B,
                                      quality=cfg.resample_quality)
        n_tail = (self.n_casc if self.fused else self.n_fused) - 1
        conv_tail = jnp.zeros((self.batch, n_tail), dtype=jnp.float32)
        agc_gain = jnp.ones((self.batch,), dtype=jnp.float32) if cfg.agc_enabled else None
        wf = None
        if cfg.waterfall_enabled:
            from ..ops.spectrum import waterfall_init

            out_len = self.up_block if self.upsampled_out else self.block
            wf = waterfall_init(out_len // 2 + 1, batch_shape=(self.batch,))
        return StreamState(
            asrc=asrc,
            up=up,
            conv_tail=conv_tail,
            down=down,
            agc_gain=agc_gain,
            key=jax.random.PRNGKey(seed),
            wf=wf,
        )

    # ---------------- stages ----------------

    def _ingest(self, block) -> jnp.ndarray:
        """Device-entry conversion to the f32 working signal."""
        if self._i16_ingest:
            x = jnp.asarray(block)
            if x.dtype != jnp.int16:  # never silently quantize floats
                raise ValueError(
                    f"ingest='pcm16' blocks must be int16, got {x.dtype}")
            return pcm16_to_f32(x)
        return jnp.asarray(block, dtype=jnp.float32)

    def _linked(self, d: jnp.ndarray) -> jnp.ndarray:
        """Apply the ``agc_link_group`` group-min to the desired-gain signal
        (`ops.agc.link_desired`) — identity at group 1."""
        G = self.cfg.agc_link_group
        if G == 1:
            return d
        from ..ops.agc import link_desired

        return link_desired(d, G, batch_axis=0)

    def _smooth_gain(self, params: DeviceParams, d: jnp.ndarray, carry):
        """Attack/release gains [B, T] from the desired gain [B, T]:
        the Triton kernel on the GPU, the plain JAX forms elsewhere."""
        mode = self.cfg.agc_mode
        a_att, a_rel = params.agc_a_att, params.agc_a_rel
        if mode == "parallel":
            return smooth_gain_parallel(d, a_att, a_rel, init=carry)
        chunk = AGC_FAST_CHUNK if mode == "fast" else 1
        if self._agc_kernel:
            from ..ops.pallas.agc_scan import smooth_gain_pallas

            return smooth_gain_pallas(d.T, a_att, a_rel, init=carry,
                                      chunk=chunk, interpret=False).T
        if chunk > 1:
            return smooth_gain_blockwise(d, a_att, a_rel, chunk=chunk,
                                         init=carry)
        return smooth_gain_scan(d, a_att, a_rel, init=carry)

    def _agc(self, params: DeviceParams, x: jnp.ndarray, agc_gain):
        """AGC + clip ±0.99 (`stream_process_AGC.py:132-144`): moving RMS →
        desired gain → attack/release → clip → apply.  Any AGC knob may be
        a per-stream [B] vector (`batch.with_per_stream_agc`)."""
        rms = moving_rms(x, self.agc.window_size)
        d = self._linked(desired_gain(rms, params.agc_target,
                                      params.agc_max_gain))
        carry = agc_gain if self.cfg.agc_carry else None
        g = self._smooth_gain(params, d, carry)
        mg = params.agc_max_gain
        g = jnp.clip(g, 0.1, mg[:, None] if mg.ndim == 1 else mg)
        return jnp.clip(x * g, -0.99, 0.99), g[..., -1]

    def _conv(self, params: DeviceParams, ext: jnp.ndarray,
              repeat: int = 1) -> jnp.ndarray:
        """Fused cascade over overlap-extended rows [R, n_casc−1+L] →
        [R, L]: the band-matrix product (td_mxu) or the overlap-save FFT
        pass.  Row-level banks always take the [B, F] response; `repeat`
        repeats each bank row for the offline fold's B-major rows."""
        cfg = self.cfg
        has_eq = cfg.eq_enabled and len(cfg.eq_bands) > 0
        n_conv = self.n_casc
        if self._use_td and not params.per_stream():
            return band_conv(ext, params.combined_cascade(has_eq))
        H = params.combined_response(has_eq, premultiplied=True)
        if H.ndim == 2 and repeat > 1:
            H = jnp.repeat(H, repeat, axis=0)
        y = jnp.fft.irfft(jnp.fft.rfft(ext, n=self.nfft) * H, n=self.nfft)
        return jax.lax.slice_in_dim(y, n_conv - 1, n_conv - 1 + self.block,
                                    axis=-1)

    def _output_stage(self, y: jnp.ndarray, key: jax.Array):
        """Clip → keyed dither → int16 quantize (``emit='pcm16'``); the
        reference order (`stream_process_AGC.py:180`,
        `stream_process.py:83-90`).  Returns (y, advanced key)."""
        cfg = self.cfg
        if cfg.output_clip is not None:
            y = jnp.clip(y, -cfg.output_clip, cfg.output_clip)
        if cfg.dither_kind != "off":
            key, sub = jax.random.split(key)
            y = dither(sub, y, cfg.dither_bits, cfg.dither_kind)
        if self._emit16:
            y = quantize_pcm16(y)
        return y, key

    # ---------------- the hot step ----------------

    def _step_impl(self, params: DeviceParams, state: StreamState,
                   block: jnp.ndarray):
        cfg = self.cfg
        x = self._ingest(block)  # [B, L_in] f32

        # 1. ASRC: source rate → engine rate, padded/trimmed to blocksize
        #    (reference compat, `stream_process_AGC.py:126-129`)
        asrc = state.asrc
        if asrc is not None:
            asrc, x = asrc.process(x)
        elif self._asrc_stateless:
            from ..ops.resample import resample_poly

            x = resample_poly(x, cfg.samplerate, cfg.source_samplerate,
                              quality=cfg.resample_quality)
        if asrc is not None or self._asrc_stateless:
            n = x.shape[-1]
            if n < self.block:
                x = jnp.pad(x, ((0, 0), (0, self.block - n)))
            else:
                x = x[..., : self.block]

        # 2. AGC (pre-upsample; `stream_process_AGC.py:132-144`) + clip ±0.99
        agc_gain = state.agc_gain
        if agc_gain is not None:
            x, agc_gain = self._agc(params, x, agc_gain)

        # 3–5. the linear chain: upsample → EQ+main FIR → downsample.
        # Fused path: one base-rate pass with the phase-0 polyphase cascade
        # kernel (identical output, ~upf× less work).
        up = state.up
        down = state.down
        if self.fused:
            n_conv = self.n_casc
            ext = jnp.concatenate([state.conv_tail, x], axis=-1)
            y = self._conv(params, ext)
            conv_tail = jax.lax.slice_in_dim(
                ext, ext.shape[-1] - (n_conv - 1), ext.shape[-1], axis=-1)
        else:
            has_eq = cfg.eq_enabled and len(cfg.eq_bands) > 0
            if up is not None:
                up, x = up.process(x)  # [B, L*upf]
            H = params.combined_response(has_eq)
            ext = jnp.concatenate([state.conv_tail, x], axis=-1)  # [B, N_f-1+L']
            Y = jnp.fft.rfft(ext, n=self.nfft) * H
            y = jnp.fft.irfft(Y, n=self.nfft)
            y = jax.lax.slice_in_dim(
                y, self.n_fused - 1, self.n_fused - 1 + self.up_block, axis=-1
            )
            conv_tail = jax.lax.slice_in_dim(
                ext, ext.shape[-1] - (self.n_fused - 1), ext.shape[-1], axis=-1
            )
            if self.upf > 1 and not self.upsampled_out:
                if cfg.downsample_mode == "decimate":
                    y = decimate(y, self.upf)  # anti-alias provided by main filter
                else:
                    down, y = down.process(y)

        # 6–7. output clip, keyed dither, int16 quantize
        y, key = self._output_stage(y, state.key)

        # 8. scan-carried waterfall capture (§5.5 observability on-device)
        wf = state.wf
        if wf is not None:
            from ..ops.spectrum import spectrum_db, waterfall_push

            # the listener's signal IS the quantized one — dequantize
            # (exact) only to feed the f32 FFT
            y_wf = pcm16_to_f32(y) if self._emit16 else y
            wf = waterfall_push(wf, spectrum_db(y_wf))

        new_state = StreamState(
            asrc=asrc, up=up, conv_tail=conv_tail, down=down,
            agc_gain=agc_gain, key=key, wf=wf,
        )
        return new_state, y

    def step(self, params: DeviceParams, state: StreamState, block: jnp.ndarray):
        """One block: [B, L] → ([B, L] out, state).  Jitted; state is NOT
        donated — the engine's degradation ladder keeps the previous state
        alive to recover from a failed step (see the __init__ note)."""
        return self._step(params, state, block)

    # ---------------- serving-ring step ----------------

    @property
    def supports_ring_step(self) -> bool:
        """True when :meth:`ring_step` is available: the fused single-rate
        chain with the scan-carried waterfall off and no device-side
        ASRC."""
        return bool(self.fused and not self.cfg.waterfall_enabled
                    and not self._asrc_device)

    def _ring_step_impl(self, params: DeviceParams, state: StreamState,
                        ring: jnp.ndarray, idx, out_ring: jnp.ndarray):
        """One serving step over device-resident rings: slot `idx` of the
        input ring runs the same body as :meth:`step`, and its output
        lands in slot `idx` of the (donated) output ring — so ring and
        staged output are the same by construction."""
        if not self.supports_ring_step:
            raise ValueError(
                "ring_step requires the fused chain with the waterfall and "
                "device ASRC disabled (see supports_ring_step)")
        want_in = jnp.int16 if self._i16_ingest else jnp.float32
        if ring.dtype != want_in:
            raise ValueError(
                f"ingest={self.cfg.ingest!r} serving rings must be "
                f"{jnp.dtype(want_in)}, got {ring.dtype}")
        want_out = jnp.int16 if self._emit16 else jnp.float32
        if out_ring.dtype != want_out:
            raise ValueError(
                f"emit={self.cfg.emit!r} serving output rings must be "
                f"{jnp.dtype(want_out)}, got {out_ring.dtype}")
        x = jax.lax.dynamic_index_in_dim(ring, idx, keepdims=False)
        state, y = self._step_impl(params, state, x)
        out_ring = jax.lax.dynamic_update_index_in_dim(out_ring, y, idx, 0)
        return state, out_ring

    def ring_step(self, params: DeviceParams, state: StreamState,
                  ring: jnp.ndarray, idx, out_ring: jnp.ndarray):
        """Jitted :meth:`_ring_step_impl`; `out_ring` is donated (slot
        `idx` is written in place and the rest rides through untouched)."""
        if not hasattr(self, "_ring_step"):
            self._ring_step = jax.jit(self._ring_step_impl,
                                      donate_argnums=(4,))
        return self._ring_step(params, state, ring,
                               jnp.asarray(idx, jnp.int32), out_ring)

    def _run_ring_impl(self, params: DeviceParams, state: StreamState,
                       ring: jnp.ndarray, out_ring: jnp.ndarray,
                       n_steps: int, start):
        K = ring.shape[0]
        start = jnp.asarray(start, dtype=jnp.int32)

        def body(carry, i):
            st, rg = carry
            st, rg = self._ring_step_impl(
                params, st, ring, jnp.mod(start + i, K), rg)
            return (st, rg), ()

        (state, out_ring), _ = jax.lax.scan(
            body, (state, out_ring), jnp.arange(n_steps, dtype=jnp.int32))
        return state, out_ring

    def run_ring(self, params: DeviceParams, state: StreamState,
                 ring: jnp.ndarray, out_ring: jnp.ndarray, n_steps: int,
                 start=0):
        """Sustained serving: ONE dispatch advances `n_steps` blocks around
        the device-resident rings, slot `(start+i) mod K` each step, writing
        the DONATED `out_ring` in place.  The host refills input slots /
        drains output slots while the device scans.  `n_steps` is static
        (compile-cached per value)."""
        if not hasattr(self, "_run_ring"):
            self._run_ring = jax.jit(self._run_ring_impl,
                                     static_argnums=(4,),
                                     donate_argnums=(3,))
        return self._run_ring(params, state, ring, out_ring, n_steps, start)

    # ---------------- scan over many blocks ----------------

    def _run_impl(self, params: DeviceParams, state: StreamState,
                  blocks: jnp.ndarray):
        def body(carry, blk):
            return self._step_impl(params, carry, blk)

        return jax.lax.scan(body, state, blocks)

    def run(self, params: DeviceParams, state: StreamState, blocks: jnp.ndarray):
        """Scan the pipeline over [T_blocks, B, L] → ([T_blocks, B, L_out])."""
        return self._run(params, state, blocks)

    # convenience: process a whole [B, T] signal
    def process_signal(self, params: DeviceParams, state: StreamState,
                       signal: jnp.ndarray, fold="auto"):
        """Whole-signal convenience: [B, T] → [B, T'].

        ``fold`` selects the offline execution strategy:

        * ``False`` — the literal streaming scan (one ``_step_impl`` per
          block, state threaded through ``lax.scan``).
        * ``"auto"`` (default) — the scan.  The fold's batched product may
          be blocked differently from the scan's and shift the last bits,
          so 'auto' never changes results.
        * ``"prefer"`` — fold whenever :attr:`supports_fold` (offline
          callers that don't need the scan's dither stream: the CLI); with
          dither on the fold's noise REALIZATION differs from blockwise
          streaming (same keyed distribution — one fold seed instead of a
          per-block key walk), everything else agrees to float32 rounding.
        * ``True`` — require the fold; raises if unsupported.
        """
        B, T = signal.shape
        L = self.block
        nblocks = T // L
        if self._fold_decision(fold):
            return self.process_signal_folded(params, state, signal)
        # transfer the CONTIGUOUS signal first and lay out the block axis on
        # device: reshape+swapaxes on a large host array forces a strided
        # host copy, which is slow for GB-class signals
        signal = self._coerce_signal(signal)
        blocks = signal[:, : nblocks * L].reshape(B, nblocks, L).swapaxes(0, 1)
        state, outs = self.run(params, state, blocks)
        return state, outs.swapaxes(0, 1).reshape(B, -1)

    def _coerce_signal(self, signal):
        if self._i16_ingest:
            signal = jnp.asarray(signal)
            if signal.dtype != jnp.int16:  # never silently quantize floats
                raise ValueError(
                    f"ingest='pcm16' signals must be int16, got "
                    f"{signal.dtype}")
            return signal
        return jnp.asarray(signal, dtype=jnp.float32)

    # ---------------- offline time-folded fast path ----------------

    def _fold_decision(self, fold) -> bool:
        """Resolve a `fold` argument ('auto'|'prefer'|True|False)."""
        if fold is True:
            if not self.supports_fold:
                raise ValueError(
                    "fold=True but this pipeline cannot fold (needs the "
                    "fused single-rate chain without AGC/device-ASRC/"
                    "waterfall)")
            return True
        if fold == "prefer":
            return self.supports_fold
        if fold == "auto" or fold is False:
            return False
        raise ValueError(
            f"fold must be 'auto', 'prefer', True, or False; got {fold!r}")

    @property
    def supports_fold(self) -> bool:
        """True when the offline fold applies: the fused single-rate chain
        with no cross-block recurrence (AGC) and no streaming resampler
        state (device ASRC / unfused up-down chain) — each block's output
        then depends only on the signal window behind it, so blocks fold
        into the BATCH axis and the whole signal runs as ONE batched
        call (`process_signal_folded`)."""
        cfg = self.cfg
        return (self.fused
                and not cfg.agc_enabled
                and not self._asrc_device
                and not cfg.waterfall_enabled)

    def _frame_rows(self, ext, nb: int, W: int):
        """Frame [B, H + nb·L] into hop-L windows [B·nb, W] (W = H + L)
        using k = ceil(W/L) shifted block VIEWS + one concat — no gather."""
        B = ext.shape[0]
        L = self.block
        k = -(-W // L)
        need = (nb - 1 + k) * L
        if need > ext.shape[-1]:
            ext = jnp.pad(ext, ((0, 0), (0, need - ext.shape[-1])))
        view = ext[:, :need].reshape(B, nb - 1 + k, L)
        frames = jnp.concatenate(
            [view[:, j:j + nb] for j in range(k)], axis=-1)[..., :W]
        return frames.reshape(B * nb, W)

    def process_signal_folded(self, params: DeviceParams, state: StreamState,
                              signal: jnp.ndarray):
        """Offline fast path: fold a [B, T] signal's blocks into the BATCH
        axis and run the conv chain as ONE batched call.

        With no AGC the fused cascade has no cross-block recurrence: block
        i's output depends only on signal[i·L − (n_casc−1) … (i+1)·L), so
        the windows fold into rows of one [B·nb, n−1+L] call — the same
        per-row math as the scan, in one large product instead of nb small
        ones.  Results agree with the scan to float32 rounding (the batched
        product may be blocked differently); with dither on the noise
        realization differs (one fold seed, not the scan's per-block key
        walk).  Final state matches the scan's (conv tail = the signal's
        last history columns, sliced — exact).

        Memory: ≈ (2 + (n−1)/L)× the signal bytes transiently (the framed
        rows duplicate each block's history).

        No reference analog — the reference processes offline files through
        the same per-block callback loop (`stream_process.py:79-120`).
        """
        if not hasattr(self, "_fold"):
            self._fold = jax.jit(self._fold_impl)
        signal = self._coerce_signal(signal)
        nb = signal.shape[-1] // self.block
        if nb == 0:  # nothing to fold
            out_dt = jnp.int16 if self._emit16 else jnp.float32
            return state, jnp.zeros((signal.shape[0], 0), out_dt)
        return self._fold(params, state, signal[:, : nb * self.block])

    def _fold_impl(self, params: DeviceParams, state: StreamState,
                   signal: jnp.ndarray):
        B, T = signal.shape
        L = self.block
        nb = T // L
        n_conv = self.n_casc
        ext = jnp.concatenate([state.conv_tail, self._ingest(signal)],
                              axis=-1)
        rows = self._frame_rows(ext, nb, n_conv - 1 + L)
        y = self._conv(params, rows, repeat=nb)
        y, key = self._output_stage(y, state.key)
        y = y.reshape(B, nb * L)
        new_state = state._replace(conv_tail=ext[:, -(n_conv - 1):], key=key)
        return new_state, y
