"""Engine-state checkpoint / resume (SURVEY.md §5.4).

The reference persists nothing beyond in-memory presets; this module adds the
promised upgrade: a full snapshot of a streaming job — config, device
parameter bank, and carried stream state (resampler histories, overlap tails,
AGC gain, RNG key) — so a batched streaming job can stop and resume
mid-stream bit-exactly.

Format: a single ``.npz`` (flattened pytree leaves) + embedded JSON config.
No orbax dependency — state here is a handful of small arrays, not sharded
model weights; np.savez keeps restore trivially portable.
"""
from __future__ import annotations

import json
import jax
import numpy as np

from .config import StreamConfig
from .engine import StreamEngine

__all__ = ["save_checkpoint", "load_checkpoint"]

#: v2: config may carry the `ingest`/`emit` keys.  v1 checkpoints load
#: unchanged.  The state carries one float32 overlap tail.
_FORMAT_VERSION = 2


def save_checkpoint(path: str, engine: StreamEngine) -> None:
    """Snapshot a StreamEngine to `path` (.npz).

    The whole snapshot is taken under the engine's swap lock so a
    concurrent ``apply_config`` (or block in another thread) can never
    produce a torn state/params pair; like the engine's own entry points,
    this makes the read atomic — it does not pause a worker thread that
    is mid-``process_block``, so checkpoint from the control thread
    between blocks (the dispatcher's natural cadence)."""
    with engine._swap_lock:
        state_leaves, state_tree = jax.tree_util.tree_flatten(engine.state)
        param_leaves, param_tree = jax.tree_util.tree_flatten(engine.params)
        arrays = {}
        for i, l in enumerate(state_leaves):
            arrays[f"state_{i}"] = np.asarray(l)
        for i, l in enumerate(param_leaves):
            arrays[f"param_{i}"] = np.asarray(l)
        meta = {
            "version": _FORMAT_VERSION,
            "config": engine.cfg.to_dict(),
            "seed": engine._seed,
            "n_state_leaves": len(state_leaves),
            "n_param_leaves": len(param_leaves),
        }
        if engine._asrc_frontend is not None:  # host ASRC accumulators
            meta["has_asrc"] = True
            arrays.update(engine._asrc_frontend.get_state())
            if engine._asrc_outq:  # drained-but-undelivered engine blocks
                arrays["asrc_outq"] = np.stack(list(engine._asrc_outq))
        if engine._in_framer is not None:  # process_frames residuals (v2+)
            meta["has_framer"] = True
            arrays["framer_in"] = engine._in_framer.get_state()
            arrays["framer_out"] = engine._out_framer.get_state()
    arrays["meta_json"] = np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8)
    np.savez(path, **arrays)


def load_checkpoint(path: str) -> StreamEngine:
    """Restore a StreamEngine (config re-validated, pipeline re-jitted,
    streaming state restored bit-exactly)."""
    with np.load(path) as z:
        meta = json.loads(bytes(z["meta_json"]).decode())
        if meta["version"] not in (1, _FORMAT_VERSION):
            raise ValueError(f"unsupported checkpoint version {meta['version']}")
        cfg = StreamConfig.from_dict(meta["config"])
        if meta.get("conv_pair") or meta.get("bf16_leaves"):
            raise ValueError("checkpoint carries a bf16 pair overlap tail, "
                             "which this version no longer restores")
        engine = StreamEngine(cfg, seed=meta["seed"])
        state_leaves = [z[f"state_{i}"] for i in range(meta["n_state_leaves"])]
        param_leaves = [z[f"param_{i}"] for i in range(meta["n_param_leaves"])]
        if meta.get("has_asrc") and engine._asrc_frontend is not None:
            engine._asrc_frontend.set_state(
                {k: z[k] for k in ("asrc_in", "asrc_out", "asrc_hist")}
            )
            if "asrc_outq" in z:
                engine._asrc_outq.extend(np.asarray(z["asrc_outq"]))
        if meta.get("has_framer"):
            from ..runtime.framer import BlockFramer

            # residuals ride the transport dtypes (raw int16 for pcm16
            # ingest / emit='pcm16' output — a float framer would silently
            # convert them)
            engine._in_framer = BlockFramer(engine.cfg.batch,
                                            dtype=engine._in_dtype)
            engine._out_framer = BlockFramer(engine.cfg.batch,
                                             dtype=engine._out_dtype)
            engine._in_framer.set_state(z["framer_in"])
            engine._out_framer.set_state(z["framer_out"])
    _, state_tree = jax.tree_util.tree_flatten(engine.state)
    _, param_tree = jax.tree_util.tree_flatten(engine.params)
    state = jax.tree_util.tree_unflatten(state_tree, state_leaves)
    params = jax.tree_util.tree_unflatten(param_tree, param_leaves)
    # transfer once at load: raw numpy leaves would otherwise ride into
    # every jitted step as a fresh host→device upload per block (state
    # heals after the first step returns device arrays; params never do)
    engine.state = jax.device_put(state)
    engine.params = jax.device_put(params)
    return engine
