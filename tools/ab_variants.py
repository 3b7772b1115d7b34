"""In-process alternating A/B of decode-loop variants.

Cross-process A/Bs also measure machine weather (clocks, neighbours,
page state).  This harness warms the jit caches once, then alternates the
variants several cycles within one process and reports per-variant
medians — adjacent samples share the weather, so the RATIO is meaningful
even when the absolute numbers drift.

Usage: python tools/ab_variants.py [n_streams] [repeats] [cycles]
Variants are toggled via NVT_READY_MAIN (read per decode call... set
before each run) — extend `VARIANTS` for other knobs.
"""

import os as _os
import sys as _sys

_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))


import os
import statistics
import sys
import time

N = int(sys.argv[1]) if len(sys.argv) > 1 else 8
REPEATS = int(sys.argv[2]) if len(sys.argv) > 2 else 16
CYCLES = int(sys.argv[3]) if len(sys.argv) > 3 else 3

from nvorbis_tpu.testgen.corpus import long_stream

path = long_stream(REPEATS)
raw = open(path, "rb").read()
raws = [raw] * N

from nvorbis_tpu.parallel.batch import BatchDecoder

# each variant: env overrides + optional stream count override.
# NVT_AB_VARIANTS overrides with a JSON dict of the same shape, e.g.
# '{"base": {"env": {}}, "serial": {"env": {"NVT_FETCH_OVERLAP": "0"}}}'
VARIANTS = {
    "streams8": {"env": {}, "n": 8},
    "streams16": {"env": {}, "n": 16},
}
if os.environ.get("NVT_AB_VARIANTS"):
    import json

    VARIANTS = json.loads(os.environ["NVT_AB_VARIANTS"])


def once(n):
    bd = BatchDecoder([raw] * n)
    outs = bd.decode_all()
    total = 0.0
    for st, o in zip(bd._streams, outs):
        total += len(o) / st.decoder.channels / st.decoder.sample_rate
    return total


def apply_env(env):
    for k, v in env.items():
        if v:
            os.environ[k] = v
        else:
            os.environ.pop(k, None)
    # chunk-size knobs are bound at import (deliberately: startup knobs, so
    # the compiled-shape cache stays stable for library users); the A/B
    # needs them live, so refresh both modules' copies from the env
    import nvorbis_tpu.engine.bulk as bulk
    import nvorbis_tpu.parallel.batch as batch

    cf = bulk._env_pow2("NVT_CHUNK_FRAMES", 4096)
    cap = bulk._env_pow2("NVT_CAP_PER_SIZE", max(1, cf // 2))
    for m in (bulk, batch):
        m.CHUNK_FRAMES = cf
        m.CAP_PER_SIZE = cap


for name, spec in VARIANTS.items():  # warm every variant's shapes
    apply_env(spec.get("env", {}))
    t0 = time.perf_counter()
    audio = once(spec.get("n", N))
    print(f"warm {name}: {audio / (time.perf_counter() - t0):.1f}x",
          file=sys.stderr, flush=True)

results = {k: [] for k in VARIANTS}
for c in range(CYCLES):
    for name, spec in VARIANTS.items():
        apply_env(spec.get("env", {}))
        t0 = time.perf_counter()
        audio = once(spec.get("n", N))
        x = audio / (time.perf_counter() - t0)
        results[name].append(x)
        print(f"cycle {c} {name}: {x:.1f}x", file=sys.stderr, flush=True)

for name, xs in results.items():
    print(f"{name}: median {statistics.median(xs):.1f}x  all "
          f"{[round(x, 1) for x in xs]}")
