"""In-process alternating A/B for host-engine env knobs.

The only valid comparison methodology on this host class: the same
binary drifts with VM weather across minutes, so
variants must alternate within ONE process and be judged on adjacent
pairs + medians.  Knobs sampled at decoder construction (NVT_NO_T2CH2,
NVT_FLOOR_DIV, NVT_FLOOR_INC, NVT_NO_SORTED_UNPACK, NVT_NO_OLA2,
NVT_NO_OLAG, NVT_HOST_FUSED_OLA=0, ...) flip cleanly between
constructions; rebuild-requiring changes need stash-pair children
instead (tools/ab_so.py).

Usage:
  python tools/ab_host.py ENV_VAR [pairs] [streams] [repeats]
    A arm: ENV_VAR unset   B arm: ENV_VAR=1
  python tools/ab_host.py ENV_VAR=0 ...   (B arm sets =0 instead)

Prints per-pair times, medians, and adjacent-win count.  Exit code 0.
"""

import os
import statistics
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

os.environ["NVT_ENGINE"] = "host"

from nvorbis_tpu.utils.hostmem import enable_page_recycling  # noqa: E402

enable_page_recycling()

spec = sys.argv[1] if len(sys.argv) > 1 else "NVT_HOST_FUSED_OLA=0"
PAIRS = int(sys.argv[2]) if len(sys.argv) > 2 else 5
N = int(sys.argv[3]) if len(sys.argv) > 3 else 8
REPEATS = int(sys.argv[4]) if len(sys.argv) > 4 else 32

var, _, bval = spec.partition("=")
bval = bval or "1"

WORKLOAD = os.environ.get("NVT_AB_WORKLOAD", "stereo")  # stereo | surround
if WORKLOAD == "surround":
    import numpy as np

    from nvorbis_tpu.testgen.vorbis_writer import make_simple_spec

    _spec = make_simple_spec(
        channels=6, sample_rate=48000, residue_type=2,
        couplings=[(0, 1), (2, 3), (4, 5)],
    )
    raw = _spec.build_stream(np.random.default_rng(1), 60 * REPEATS)
    CHANNELS, RATE = 6, 48000
else:
    from nvorbis_tpu.testgen.corpus import long_stream

    path = long_stream(REPEATS)
    raw = open(path, "rb").read()
    CHANNELS, RATE = 2, 44100
raws = [raw] * N

from nvorbis_tpu.parallel.batch import BatchDecoder  # noqa: E402


def once():
    outs = BatchDecoder(raws).decode_all()
    return sum(len(o) for o in outs) / CHANNELS / RATE


once()
once()  # warm: page pool, tables, caches
res = []
for i in range(PAIRS):
    for tag, env in (("A(unset)", None), (f"B({var}={bval})", bval)):
        if env is None:
            os.environ.pop(var, None)
        else:
            os.environ[var] = env
        t0 = time.perf_counter()
        audio = once()
        dt = time.perf_counter() - t0
        res.append((tag, dt))
        print(f"{tag:22s} {dt:6.2f}s  {audio / dt:7.1f}x", flush=True)
os.environ.pop(var, None)

a = [x for t, x in res if t.startswith("A")]
b = [x for t, x in res if t.startswith("B")]
wins = sum(1 for i in range(0, len(res), 2) if res[i][1] < res[i + 1][1])
print(f"\nA median {statistics.median(a):.3f}s   "
      f"B median {statistics.median(b):.3f}s   "
      f"adjacent wins for A: {wins}/{PAIRS}")
