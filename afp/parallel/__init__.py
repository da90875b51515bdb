"""Parallelism layer: stream-axis DP, time-axis halo exchange, kernel
(tensor) parallelism for long FIRs, mesh helpers."""
from .dp import ShardedPipeline
from .halo import halo_convolve, halo_convolve_sharded
from .kp import KernelParallelConv
from .long import filter_long_signal
from .mesh import Mesh, NamedSharding, P, make_mesh

__all__ = [
    "ShardedPipeline",
    "halo_convolve",
    "halo_convolve_sharded",
    "KernelParallelConv",
    "filter_long_signal",
    "make_mesh",
    "Mesh",
    "NamedSharding",
    "P",
]
