"""Host-engine throughput: the headline workload on the real host engine.

Until round 3 this script measured a *stubbed* ceiling (the device chunk
program replaced by a zeros factory), because the host plane was only a
staging layer for the device.  Round 4 made the host plane a first-class
engine (``engine="host"``: C++ unpack + DCT-IV IMDCT + fused window/OLA,
engine/host.py) — so the metric is now measured end-to-end through the
production path: real synthesis, real PCM bytes, the exact code a user
gets from ``BatchDecoder(raws, engine="host")``.  No monkeypatching, no
jax import anywhere (the host engine's hard promise,
tests/test_host_engine.py).

The measurement drifts with "host weather" (VM page state, steal time),
so the reported
number is the MEDIAN of the timed rounds with the min/max spread, not a
best-of: bench.py forwards all three so the artifact carries its own
error bar.

Usage: python tools/host_ceiling.py [n_streams] [repeats] [timed_rounds]
Prints ``host_ceiling_x: <median>`` plus ``host_ceiling_spread: <min> <max>``;
emitted by bench.py as the ``host_ceiling`` stderr metric.
"""

import os as _os
import sys as _sys

_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))

# Force the host engine: this metric is the host plane's number.  The
# host engine never imports jax, so no platform pinning is needed — but
# assert the promise held at the end.
_os.environ["NVT_ENGINE"] = "host"

import statistics
import sys
import time

# the promise checked at the end is that the host engine itself did not
# ADD the import (tests/test_host_engine.py proves the stronger no-import
# property in a clean subprocess)
_HAD_JAX = "jax" in sys.modules

from nvorbis_tpu.utils.hostmem import enable_page_recycling

enable_page_recycling()  # NVT_NO_MALLOPT=1 measures the un-fixed baseline

N = int(sys.argv[1]) if len(sys.argv) > 1 else 8
REPEATS = int(sys.argv[2]) if len(sys.argv) > 2 else 64
ROUNDS = int(sys.argv[3]) if len(sys.argv) > 3 else 4

import os

from nvorbis_tpu.testgen.corpus import long_stream

path = long_stream(REPEATS)

raw = open(path, "rb").read()
raws = [raw] * N


def once():
    from nvorbis_tpu.parallel.batch import BatchDecoder

    bd = BatchDecoder(raws)
    assert bd._host_mode, "host_ceiling must run the host engine"
    outs = bd.decode_all()
    total = 0.0
    for st, o in zip(bd._streams, outs):
        total += len(o) / st.decoder.channels / st.decoder.sample_rate
    return total


def main():
    from nvorbis_tpu.utils import profiling

    t0 = time.perf_counter()
    audio = once()  # warm (packet tables, window/basis caches, page pool)
    t_warm = time.perf_counter() - t0
    print(
        f"warm: {audio:.0f}s audio in {t_warm:.1f}s = {audio / t_warm:.1f}x",
        file=sys.stderr,
    )

    xs = []
    for i in range(ROUNDS):
        profiling.enable(True)
        profiling.reset()
        t0 = time.perf_counter()
        audio = once()
        dt = time.perf_counter() - t0
        xs.append(audio / dt)
        print(
            f"timed: {audio:.0f}s audio in {dt:.1f}s = {xs[-1]:.1f}x",
            file=sys.stderr,
        )
        if i == ROUNDS - 1:
            profiling.report(sys.stderr)
    assert _HAD_JAX or "jax" not in sys.modules, "host engine imported jax"
    med = statistics.median(xs)
    print(f"host_ceiling_x: {med:.1f}")
    print(f"host_ceiling_spread: {min(xs):.1f} {max(xs):.1f}")
    return med


if __name__ == "__main__":
    main()
