"""Device enumeration (C11 analog).

The reference lists PortAudio endpoints (`reference/
list_audio_devices.py:4-6`: index, name, channel counts).  This framework's
"devices" are accelerators: report index, kind, platform, process, and
memory stats per device, plus mesh-topology hints.
"""
from __future__ import annotations

from typing import List

__all__ = ["list_devices", "format_devices", "main"]


def list_devices() -> List[dict]:
    import jax

    out = []
    for d in jax.devices():
        info = {
            "index": d.id,
            "kind": getattr(d, "device_kind", "unknown"),
            "platform": d.platform,
            "process": getattr(d, "process_index", 0),
        }
        try:
            stats = d.memory_stats()
            if stats:
                info["hbm_bytes_limit"] = stats.get("bytes_limit")
                info["hbm_bytes_in_use"] = stats.get("bytes_in_use")
        except Exception:
            pass
        try:
            info["coords"] = tuple(getattr(d, "coords", ()))
        except Exception:
            pass
        out.append(info)
    return out


def format_devices() -> str:
    lines = []
    for d in list_devices():
        mem = ""
        if d.get("hbm_bytes_limit"):
            mem = f", memory {d['hbm_bytes_limit'] / 2**30:.1f} GiB"
        lines.append(
            f"{d['index']}: {d['kind']} ({d['platform']}, process {d['process']}{mem})"
        )
    return "\n".join(lines)


def main() -> None:  # python -m afp.runtime.devices
    print(format_devices())


if __name__ == "__main__":
    main()
