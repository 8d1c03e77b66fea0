"""Uncore model: collective and point-to-point transfer time estimates.

Counterpart of ``repro/core/noc.py``. EPAC's uncore (section 4 of the
paper): a 2-D-mesh CHI NoC (64 GB/s per port per direction at 1 GHz),
distributed 256 kB L2 slices with programmable address interleaving, a
directory Home Node, and a 25 GB/s-per-direction C2C SerDes link that
extends the NoC off-chip.

The functions are analytical: bytes over a link rate plus per-hop
latency, on a ``FabricSpec`` the caller supplies. The spec has no
default: a fabric's figures belong to the machine it describes, and the
port names none for the card (the disaggregated engine leaves its
migrations unpriced without one, ``launch/engine/disagg.py``).
``EPAC_NOC`` is the paper's own table of EPAC's silicon, not a figure
of any machine the port runs on.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class FabricSpec:
    """Link rates in bytes/second per device for each mesh axis tier.

    Attributes
    ----------
    ici_bw : float
        Rate of an on-package link (every axis but ``"pod"``).
    pod_bw : float
        Rate of the slow tier between packages (the ``"pod"`` axis; the
        C2C SerDes in EPAC's terms).
    latency_us : float
        Per-hop latency, software and link, in microseconds.
    """

    ici_bw: float
    pod_bw: float
    latency_us: float


# EPAC's own figures, from the paper (section 4 and the bring-up in 5).
EPAC_NOC = {
    "noc_port_bw_GBps_per_dir": 64.0,   # 512 b/cycle @ 1 GHz
    "c2c_bw_GBps_per_dir": 25.0,        # 8 SerDes lanes x 25 Gb/s
    "c2c_bw_GBps_aggregate": 50.0,
    "c2c_demonstrated_GBps": 20.0,      # bring-up measured (section 5)
    "l2_slice_kB": 256,
    "l2_line_bytes": 64,
    "l2_outstanding": 128,
}


def _axis_bw(axis: str, fabric: FabricSpec) -> float:
    return fabric.pod_bw if axis == "pod" else fabric.ici_bw


def p2p_time(nbytes: float, hops: int, axis: str,
             fabric: FabricSpec) -> float:
    """Point-to-point transfer estimate: one source, one destination,
    ``hops`` links of the given axis tier apart. The payload serializes
    once onto the first link and cuts through (wormhole routing, not
    store-and-forward), so the rate is paid once and only the per-hop
    latency grows with distance:

        time = nbytes / bw(axis) + hops * latency_us * 1e-6

    ``hops <= 0`` (the same device) is free. The disaggregated engine
    prices a KV migration with it when it is given a fabric."""
    if hops <= 0:
        return 0.0
    return nbytes / _axis_bw(axis, fabric) + hops * fabric.latency_us * 1e-6


def all_reduce_time(bytes_per_device: float, axis_size: int, axis: str,
                    fabric: FabricSpec) -> float:
    """Ring all-reduce: 2(n-1)/n * bytes over the axis link."""
    if axis_size <= 1:
        return 0.0
    return 2.0 * (axis_size - 1) / axis_size * bytes_per_device \
        / _axis_bw(axis, fabric)


def all_gather_time(bytes_per_device_shard: float, axis_size: int,
                    axis: str, fabric: FabricSpec) -> float:
    """Ring all-gather of per-device shards: (n-1) * shard bytes."""
    if axis_size <= 1:
        return 0.0
    return (axis_size - 1) * bytes_per_device_shard / _axis_bw(axis, fabric)


def reduce_scatter_time(bytes_per_device: float, axis_size: int, axis: str,
                        fabric: FabricSpec) -> float:
    """Ring reduce-scatter: (n-1)/n * bytes over the axis link."""
    if axis_size <= 1:
        return 0.0
    return (axis_size - 1) / axis_size * bytes_per_device \
        / _axis_bw(axis, fabric)


def all_to_all_time(bytes_per_device: float, axis_size: int, axis: str,
                    fabric: FabricSpec) -> float:
    """All-to-all: each device keeps 1/n of its bytes and sends the
    rest, (n-1)/n * bytes over the axis link."""
    if axis_size <= 1:
        return 0.0
    return (axis_size - 1) / axis_size * bytes_per_device \
        / _axis_bw(axis, fabric)


def interleave(addr: int, n_slices: int, line_bytes: int = 64,
               mode: str = "line") -> int:
    """EPAC's L2 programmable address interleaving: the slice id of
    ``addr``. ``"line"`` interleaves consecutive cache lines across
    slices (the NoC default); ``"block"`` keeps 4 KiB blocks per slice."""
    if mode == "line":
        return (addr // line_bytes) % n_slices
    if mode == "block":
        return (addr // 4096) % n_slices
    raise ValueError(mode)
