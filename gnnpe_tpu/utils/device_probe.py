"""Published peak rates of the devices this system runs on.

``ops/ell._select_hubs`` prices a hub column of the binned ELL layout
against the gather time it saves, and ``bench.py`` states its rates as
a share of the device's memory bandwidth.  Both read the table below,
keyed by ``jax.Device.device_kind``.  A device that is not in the table
is an error, not a default: a wrong peak silently skews every ratio
computed from it.

Sources: NVIDIA H100 and H200 data sheets (SXM parts; dense bf16 rate
without sparsity, at the full power limit).  The ``cpu`` row is a
nominal figure for CPU test runs only; it describes no real host.
"""

from __future__ import annotations

from typing import Tuple

# device_kind -> (memory bytes/s, dense bf16 flop/s)
PEAKS = {
    "NVIDIA H100 80GB HBM3": (3.35e12, 989e12),
    "NVIDIA H200": (4.8e12, 989e12),
    "cpu": (50e9, 1e12),
}


def peak_rates(kind: str) -> Tuple[float, float]:
    """(memory bytes/s, bf16 flop/s) of ``kind``; KeyError if unknown."""
    try:
        return PEAKS[kind]
    except KeyError:
        raise KeyError(f"no published peaks for device kind {kind!r}; "
                       f"add it to utils/device_probe.PEAKS") from None


def device_constants(feature_dim: int = 128
                     ) -> Tuple[float, float, float]:
    """(memory bytes/s, bf16 flop/s, seconds per gathered row) of the
    first visible device.  The row cost is what one f32 row of
    ``feature_dim`` takes at peak bandwidth: a lower bound for a
    gather, derived from the table, not measured."""
    import jax
    bw, flops = peak_rates(jax.devices()[0].device_kind)
    return bw, flops, 4.0 * feature_dim / bw
