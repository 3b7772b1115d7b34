"""Span-traced run of the headline workload (longform batch decode).

Prints the phase breakdown (collect / unpack / dispatch / fetch) for one
warm decode_batch call plus wall totals, so the binding resource is
measurable rather than guessed.

Usage: python tools/profile_headline.py [n_streams] [repeats]
"""

import os as _os
import sys as _sys

_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))


import sys
import time

from nvorbis_tpu.utils import profiling

N = int(sys.argv[1]) if len(sys.argv) > 1 else 8
REPEATS = int(sys.argv[2]) if len(sys.argv) > 2 else 64

import os

from nvorbis_tpu.testgen.corpus import long_stream

path = long_stream(REPEATS)

raw = open(path, "rb").read()
raws = [raw] * N

from nvorbis_tpu.parallel.batch import BatchDecoder


def once():
    bd = BatchDecoder(raws)
    outs = bd.decode_all()
    total = 0.0
    for st, o in zip(bd._streams, outs):
        total += len(o) / st.decoder.channels / st.decoder.sample_rate
    return total


t0 = time.perf_counter()
audio = once()  # warm: compiles
t_warm = time.perf_counter() - t0
print(f"warm: {audio:.0f}s audio in {t_warm:.1f}s = "
      f"{audio / t_warm:.1f}x", file=sys.stderr)

profiling.enable(True)
profiling.reset()
t0 = time.perf_counter()
audio = once()
dt = time.perf_counter() - t0
print(f"timed: {audio:.0f}s audio in {dt:.1f}s = {audio / dt:.1f}x",
      file=sys.stderr)
profiling.report(sys.stderr)
