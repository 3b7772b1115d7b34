"""In-process alternating A/B of two host_decode .so builds.

For rebuild-requiring C++ changes (no env twin knob): build the two
variants to separate paths, then alternate them within ONE process by
re-pointing ``native._SO`` and calling ``native.reset()`` between arms
(dlopen of distinct paths yields distinct library instances; the
unpacker cache is cleared by reset).  Same adjacent-pair methodology as
tools/ab_host.py — single timings on this host class measure VM
weather, not code.

Usage:
  python tools/ab_so.py OLD_SO NEW_SO [pairs] [streams] [repeats]
"""

import os
import statistics
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

os.environ["NVT_ENGINE"] = "host"

from nvorbis_tpu.utils.hostmem import enable_page_recycling  # noqa: E402

enable_page_recycling()

so_a = sys.argv[1]
so_b = sys.argv[2]
PAIRS = int(sys.argv[3]) if len(sys.argv) > 3 else 5
N = int(sys.argv[4]) if len(sys.argv) > 4 else 8
REPEATS = int(sys.argv[5]) if len(sys.argv) > 5 else 32
WORKLOAD = os.environ.get("NVT_AB_WORKLOAD", "stereo")  # stereo | surround

if WORKLOAD == "surround":
    import numpy as np

    from nvorbis_tpu.testgen.vorbis_writer import make_simple_spec

    spec = make_simple_spec(
        channels=6, sample_rate=48000, residue_type=2,
        couplings=[(0, 1), (2, 3), (4, 5)],
    )
    raw = spec.build_stream(np.random.default_rng(1), 60 * REPEATS)
    CHANNELS, RATE = 6, 48000
else:
    from nvorbis_tpu.testgen.corpus import long_stream

    path = long_stream(REPEATS)
    raw = open(path, "rb").read()
    CHANNELS, RATE = 2, 44100
raws = [raw] * N

from nvorbis_tpu import native  # noqa: E402
from nvorbis_tpu.parallel.batch import BatchDecoder  # noqa: E402


def use(so):
    # keep the .so newer than the source so load() does not rebuild it
    os.utime(so)
    native._SO = so
    native.reset()
    assert native.load() is not None, so


def once():
    outs = BatchDecoder(raws).decode_all()
    return sum(len(o) for o in outs) / CHANNELS / RATE


for so in (so_a, so_b):
    use(so)
    once()  # warm both instances: page pool, tables, caches

res = {so_a: [], so_b: []}
wins_b = 0
for p in range(PAIRS):
    pair = {}
    for so in (so_a, so_b):
        use(so)
        t0 = time.perf_counter()
        audio = once()
        dt = time.perf_counter() - t0
        pair[so] = dt
        res[so].append(dt)
    if pair[so_b] < pair[so_a]:
        wins_b += 1
    print(f"pair {p}: A {pair[so_a]:.3f}s  B {pair[so_b]:.3f}s  "
          f"({'B' if pair[so_b] < pair[so_a] else 'A'} wins)", flush=True)

ma = statistics.median(res[so_a])
mb = statistics.median(res[so_b])
print(f"A median {ma:.3f}s  B median {mb:.3f}s  B wins {wins_b}/{PAIRS}  "
      f"B/A speedup {ma / mb:.3f}x  audio {audio:.0f}s")
