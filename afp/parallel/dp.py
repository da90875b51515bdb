"""Stream-axis data parallelism (SURVEY.md §2.4 "batch/channel DP").

The reference processes ONE mono stream on one pinned CPU core
(`reference/stream_process.py:17, 22`).  Here the batch of concurrent
streams is sharded over the device mesh with `shard_map`; the pipeline step
runs unchanged per shard (it is batch-size-agnostic), and — streams being
independent — no collectives appear in the hot path.  The only cross-device
touch is the per-shard dither key: the mesh position is folded in ONCE at
`init_state` (a [n_shards] key vector sharded on 'streams'), so shards draw
decorrelated noise while every entry point — step, run, chunked run_ring
dispatches — advances the key by pure splits and composes bit-identically.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..engine.config import PipelineParams, StreamConfig
from ..engine.pipeline import DeviceParams, Pipeline, StreamState
from ..ops.resample import PolyResampler

__all__ = ["ShardedPipeline"]


def _resampler_spec(r, ax="streams"):
    """Spec pytree for a PolyResampler: per-stream input history shards,
    the (shared) kernel replicates."""
    if r is None:
        return None
    return r._replace(hist=P(ax, None), h=P())


def _state_spec(state: StreamState, ax="streams") -> StreamState:
    """PartitionSpec pytree for a StreamState, tagged STRUCTURALLY by field
    (not by shape coincidence — a PRNG key at batch=2 or a kernel whose
    length equals the batch must not land on the batch axis).  `ax` is the
    mesh axis the batch dimension shards over."""
    return StreamState(
        asrc=_resampler_spec(state.asrc, ax),
        up=_resampler_spec(state.up, ax),
        conv_tail=P(ax, None),
        down=_resampler_spec(state.down, ax),
        agc_gain=None if state.agc_gain is None else P(ax),
        key=P(ax),  # [n_shards] pre-folded per-shard keys
        wf=None if state.wf is None else P(ax, None, None),
    )


def _param_spec_tree(params: DeviceParams, ax="streams") -> DeviceParams:
    """PartitionSpec pytree for a DeviceParams bank: everything replicates
    except per-stream gain banks ([B, n_bands], structurally 2-D — shared
    banks are 1-D) which shard on 'streams'."""
    per_stream = getattr(params.eq_gains, "ndim", 1) == 2
    # H_main is [F] shared or [B, F] per-stream-kernel banks (structurally
    # 2-D); H_bands/casc_bands are [n_bands, ·] and always replicate
    ps_main = getattr(params.H_main, "ndim", 1) == 2
    # per-stream AGC policies ([B] vectors) shard with the streams
    vec = lambda v: P(ax) if getattr(v, "ndim", 0) == 1 else P()
    return DeviceParams(
        H_bands=P(),
        H_main=P(ax, None) if ps_main else P(),
        eq_gains=P(ax, None) if per_stream else P(),
        agc_target=vec(params.agc_target),
        agc_max_gain=vec(params.agc_max_gain),
        agc_a_att=vec(params.agc_a_att),
        agc_a_rel=vec(params.agc_a_rel),
        casc_bands=None if params.casc_bands is None else P(),
        casc_main=None if params.casc_main is None else P(),
    )


class ShardedPipeline:
    """A Pipeline whose batch axis is sharded over a 1-D 'streams' mesh.

    ``cfg.batch`` is the GLOBAL stream count and must divide evenly over the
    mesh.  Params are replicated; state and blocks are sharded.  Usage::

        mesh = make_mesh(8)
        sp = ShardedPipeline(cfg, mesh)
        params = sp.device_params(PipelineParams.design(sp.cfg))
        state = sp.init_state()
        state, out = sp.step(params, state, blocks)   # blocks: [B_global, L]
    """

    def __init__(self, cfg: StreamConfig, mesh: Mesh):
        cfg = cfg.validate()
        if "streams" not in mesh.axis_names:
            raise ValueError("mesh must have a 'streams' axis")
        self._bax = "streams"
        n_shards = mesh.shape["streams"]
        if cfg.batch % n_shards:
            raise ValueError(
                f"global batch {cfg.batch} must divide over {n_shards} devices"
            )
        self.mesh = mesh
        self.n_shards = n_shards
        # the inner pipeline is built at per-shard batch (shapes inside
        # shard_map are the local shard shapes)
        import dataclasses

        self.local_cfg = dataclasses.replace(cfg, batch=cfg.batch // n_shards)
        self.cfg = cfg
        self.pipeline = Pipeline(self.local_cfg)

        state_example = self.pipeline.init_state()
        sspec = _state_spec(state_example, self._bax)
        bspec = P(self._bax, None)

        self._sspec = sspec
        self._bspec = bspec
        self._exec_cache = {}

    def _local_scan(self, params, state, blocks):
        """Shard-local scan over `_step_impl` — the single definition of the
        per-shard streaming loop (key unwrap → lax.scan → key re-wrap),
        shared by the `run` executable and `process_signal`'s scan
        fallback so the key-wrap discipline can't drift between them.
        `blocks` is [T, B_local, L]."""
        state = state._replace(key=state.key[0])

        def body(carry, blk):
            return self.pipeline._step_impl(params, carry, blk)

        st, ys = jax.lax.scan(body, state, blocks)
        return st._replace(key=st.key[None]), ys

    def _get_exec(self, params: DeviceParams):
        """Build (lazily, cached) the shard_map'd step/run for this params
        structure — per-stream banks (structurally 2-D gains/responses, or
        [B] AGC vectors) shard on 'streams', shared banks replicate."""
        pspec = _param_spec_tree(params, self._bax)
        key = tuple(
            getattr(l, "shape", None) for l in jax.tree_util.tree_leaves(params)
        )
        if key in self._exec_cache:
            return self._exec_cache[key]
        mesh, sspec, bspec = self.mesh, self._sspec, self._bspec

        def local_step(params, state, block):
            # per-shard key: pre-folded at init_state (shape [1] locally)
            state = state._replace(key=state.key[0])
            st, y = self.pipeline._step_impl(params, state, block)
            return st._replace(key=st.key[None]), y

        step = jax.jit(
            jax.shard_map(
                local_step,
                mesh=mesh,
                in_specs=(pspec, sspec, bspec),
                out_specs=(sspec, bspec),
                check_vma=False,
            ),
            # state is NOT donated, matching Pipeline's contract
            # (pipeline.py: the caller may retry/compare with the old
            # state — e.g. a degradation ladder or checkpoint of the
            # pre-step state); it is tiny (tails + key), so donation
            # buys nothing
        )

        tspec = P(None, self._bax, None)
        run = jax.jit(
            jax.shard_map(
                self._local_scan,
                mesh=mesh,
                in_specs=(pspec, sspec, tspec),
                out_specs=(sspec, tspec),
                check_vma=False,
            ),
        )
        self._exec_cache[key] = (step, run)
        return step, run

    # ---- public surface (global shapes) ----

    # Pipeline-duck-typed attributes so serving hosts (`RingServer`) drive
    # a ShardedPipeline unchanged: global batch, per-shard-agnostic block,
    # and the inner pipeline's capability flags.
    @property
    def batch(self) -> int:
        return self.cfg.batch

    @property
    def block(self) -> int:
        return self.pipeline.block

    @property
    def supports_ring_step(self) -> bool:
        return self.pipeline.supports_ring_step

    @property
    def ring_sharding(self):
        """NamedSharding for [S, B_global, T] serving rings — hosts place
        the rings once so per-dispatch resharding transfers never happen."""
        return NamedSharding(self.mesh, P(None, self._bax, None))

    def device_params(self, p: PipelineParams) -> DeviceParams:
        return self.pipeline.device_params(p)

    def init_state(self, seed: int = 0) -> StreamState:
        """Global state: per-shard states concatenated on the batch axis.
        Which leaves widen is decided by the structural spec, not by shape."""
        local = self.pipeline.init_state(seed=seed)
        # the dither key is folded with the shard index ONCE here (stored
        # as a [n_shards] per-shard key vector sharded on 'streams'); the
        # walk afterwards is pure splits, so every entry point — step, run,
        # chunked run_ring dispatches — composes bit-identically
        spec = _state_spec(local, self._bax)._replace(key=None)

        def widen(leaf, s):
            if isinstance(s, P) and len(s) and s[0] == self._bax:
                reps = (self.n_shards,) + (1,) * (leaf.ndim - 1)
                return jnp.tile(leaf, reps)
            return leaf

        wide = jax.tree_util.tree_map(
            widen, local, spec, is_leaf=lambda x: x is None
        )
        wide = wide._replace(key=jax.vmap(
            lambda i: jax.random.fold_in(local.key, i)
        )(jnp.arange(self.n_shards)))
        return self._place_state(wide)

    def _place_state(self, state: StreamState) -> StreamState:
        sspec = _state_spec(state, self._bax)

        def place(leaf, spec):
            return jax.device_put(leaf, NamedSharding(self.mesh, spec))

        return jax.tree_util.tree_map(place, state, sspec)

    def step(self, params: DeviceParams, state: StreamState, blocks):
        """[B_global, L] in → ([B_global, L] out, state)."""
        step, _ = self._get_exec(params)
        return step(params, state, blocks)

    def run(self, params: DeviceParams, state: StreamState, blocks):
        """[T, B_global, L] in → ([T, B_global, L] out, state)."""
        _, run = self._get_exec(params)
        return run(params, state, blocks)

    def process_signal(self, params: DeviceParams, state: StreamState,
                       signal, fold="auto"):
        """Sharded offline convenience: [B_global, T] → [B_global, T'].
        Stream-DP over the mesh with `Pipeline.process_signal` semantics —
        the offline time-folded fast path applies PER SHARD (each shard
        folds its local streams' blocks into its batch axis; same fold
        rules).  Zero hot-path collectives, per-shard dither keys."""
        pipe = self.pipeline
        signal = pipe._coerce_signal(signal)
        nb = signal.shape[-1] // pipe.block
        use_fold = pipe._fold_decision(fold)
        if nb == 0:
            out_dt = jnp.int16 if pipe._emit16 else jnp.float32
            return state, jnp.zeros((signal.shape[0], 0), out_dt)
        signal = signal[:, : nb * pipe.block]
        pspec = _param_spec_tree(params, self._bax)
        key = ("signal", use_fold, nb, signal.dtype.name) + tuple(
            getattr(l, "shape", None) for l in jax.tree_util.tree_leaves(params)
        )
        if key not in self._exec_cache:
            mesh, sspec = self.mesh, self._sspec
            L, n_blocks = pipe.block, nb

            def local_signal(params, state, sig):
                if use_fold:
                    state = state._replace(key=state.key[0])
                    st, y = pipe._fold_impl(params, state, sig)
                    return st._replace(key=st.key[None]), y
                B = sig.shape[0]
                blocks = sig.reshape(B, n_blocks, L).swapaxes(0, 1)
                st, ys = self._local_scan(params, state, blocks)
                return st, ys.swapaxes(0, 1).reshape(B, -1)

            sigspec = P(self._bax, None)
            self._exec_cache[key] = jax.jit(
                jax.shard_map(
                    local_signal,
                    mesh=mesh,
                    in_specs=(pspec, sspec, sigspec),
                    out_specs=(sspec, sigspec),
                    check_vma=False,
                ),
            )
        return self._exec_cache[key](params, state, signal)

    def run_ring(self, params: DeviceParams, state: StreamState,
                 ring, out_ring, n_steps: int, start=0):
        """Sharded serving loop (`Pipeline.run_ring`): the [S, B_global, T]
        rings shard on 'streams', the slot index is replicated, and each
        shard reads/writes its own ring slices in place — zero hot-loop
        collectives.  `out_ring` is donated; `n_steps` is static."""
        if not self.pipeline.supports_ring_step:
            raise ValueError(
                "run_ring requires a ring-capable pipeline — the fused "
                "chain with the waterfall and device ASRC disabled (see "
                "Pipeline.supports_ring_step)")
        pspec = _param_spec_tree(params, self._bax)
        key = ("ring", n_steps) + tuple(
            getattr(l, "shape", None) for l in jax.tree_util.tree_leaves(params)
        )
        if key not in self._exec_cache:
            mesh, sspec = self.mesh, self._sspec
            rspec = P(None, self._bax, None)

            def local_ring(params, state, ring, rg, start):
                state = state._replace(key=state.key[0])
                st, rg = self.pipeline._run_ring_impl(
                    params, state, ring, rg, n_steps, start)
                return st._replace(key=st.key[None]), rg

            self._exec_cache[key] = jax.jit(
                jax.shard_map(
                    local_ring,
                    mesh=mesh,
                    in_specs=(pspec, sspec, rspec, rspec, P()),
                    out_specs=(sspec, rspec),
                    check_vma=False,
                ),
                donate_argnums=(3,),
            )
        return self._exec_cache[key](
            params, state, ring, out_ring, jnp.asarray(start, jnp.int32))
