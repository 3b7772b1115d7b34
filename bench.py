"""Benchmark harness: the bench configs + the headline metric.

stdout carries exactly ONE JSON line — the headline metric
(``decode_throughput_stereo_44k1_longform_batch``, x-realtime per chip vs
the 500x north-star target).  Each config additionally emits one JSON line
on stderr:

  1. decode_1test_wav           — 1test.ogg decode-to-WAV latency config
  2. longform_batch (headline)  — N long-form stereo 44.1 kHz streams
  3. chained_seek               — granule-exact seeks/sec on a chained file
  4. surround51_48k             — 5.1 @ 48 kHz coupled Residue2 synthetic
  5. batch64 / batch64_mixed    — 64-stream aggregate throughput
                                  (homogeneous / 4 distinct setups)
  6. host_ceiling               — the headline workload pinned to the host
                                  engine, median + spread (tools/)
  7. *_device / *_int16         — device-plane validation configs: the
                                  same workloads forced through the device
                                  path (``engine="jax"``), f32 and 16-bit
                                  transport; they fail unless JAX runs on
                                  the GPU
  8. device_synth               — fetch-free device compute (tools/)

Every line carries what it ran on: ``platform``, ``device_kind`` and
``device_count`` as JAX reports them and ``card`` (``nvidia-smi``'s
``name, power.limit``), plus a ``backend`` tag ("host" or "device") naming
the plane that produced the value.

Each config runs in a child process of its own, one at a time, so one
process holds the card at a time; the parent never initializes JAX.
Fixtures come from the bundled corpus (``nvorbis_tpu.testgen.corpus``).

Env knobs: NVT_BENCH_STREAMS (headline batch width, default 8),
NVT_BENCH_REPS (timed reps, default 3), NVT_BENCH_CONFIGS
(comma-separated subset), NVT_BENCH_BUDGET (wall seconds for the optional
configs, default 1500), NVT_BENCH_NO_FORK=1 (run every config in this
process), NVT_FETCH_INT16=1 (lossy 16-bit PCM transport).
"""

import json
import os
import subprocess
import sys
import time

_REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, _REPO)

from nvorbis_tpu.testgen.corpus import (  # noqa: E402  (jax-free)
    CACHE_DIR, MONO_SHORT, STEREO, STEREO_SHIFTED, fixture_path,
    long_stream,
)
from nvorbis_tpu.utils import devinfo  # noqa: E402  (jax-free)

REPEATS = int(os.environ.get("NVT_BENCH_REPEATS", "64"))
# 64 repeats ~= 7 minutes of stereo 44.1 kHz audio per stream
TARGET_X_REALTIME = 500.0

N_STREAMS = int(os.environ.get("NVT_BENCH_STREAMS", "8"))
REPS = int(os.environ.get("NVT_BENCH_REPS", "3"))
BUDGET = float(os.environ.get("NVT_BENCH_BUDGET", "1500"))
B64_REPEATS = int(os.environ.get("NVT_BENCH_B64_REPEATS", "8"))
B64_WIDTH = int(os.environ.get("NVT_BENCH_B64_WIDTH", "16"))  # streams per setup
FWD_REPEATS = int(os.environ.get("NVT_BENCH_FWD_REPEATS", "8"))
S51_PACKETS = int(os.environ.get("NVT_BENCH_51_PACKETS", "4096"))
# headline first (it is the recorded metric), then the cheap configs, then
# the expensive variants — so an exhausted budget drops the big ones, not
# the coverage
CONFIGS = [c for c in os.environ.get(
    "NVT_BENCH_CONFIGS",
    "longform_batch,host_ceiling,decode_1test_wav,chained_seek,"
    "forward_only,surround51_48k,batch64,batch64_mixed,device_synth,"
    "longform_batch_device,longform_batch_int16,surround51_48k_int16",
).split(",") if c]

_T0 = time.perf_counter()
_DEVICE_FIELDS = None


def _device_fields():
    """What this process ran on; read lazily, after the config ran, so a
    config whose work runs in a child process never shares the card."""
    global _DEVICE_FIELDS
    if _DEVICE_FIELDS is None:
        d = devinfo.device()
        _DEVICE_FIELDS = {"platform": d["platform"],
                          "device_kind": d["kind"],
                          "device_count": d["count"],
                          "card": devinfo.card()}
    return _DEVICE_FIELDS


def _emit(line, final=False):
    out = sys.stdout if final else sys.stderr
    print(json.dumps(line), file=out, flush=True)


def _budget_left():
    return BUDGET - (time.perf_counter() - _T0)


def _require_gpu():
    """Device cells fail loudly off the GPU (no fallback plane)."""
    import jax

    if jax.default_backend() != "gpu":
        raise RuntimeError(
            f"device config needs the GPU; jax backend is "
            f"{jax.default_backend()!r}")


_LAST_BACKEND = "host"


def decode_batch(raws, engine="auto"):
    """Aggregate decoded audio seconds via the batch plane; sets
    ``_LAST_BACKEND`` to the plane that ran."""
    global _LAST_BACKEND
    from nvorbis_tpu.parallel.batch import BatchDecoder

    bd = BatchDecoder(raws, engine=engine)
    outs = bd.decode_all()
    _LAST_BACKEND = "host" if bd._host_mode else "device"
    total = 0.0
    for st, o in zip(bd._streams, outs):
        total += len(o) / st.decoder.channels / st.decoder.sample_rate
    return total


def _reader_backend(reader):
    """Which plane a VorbisReader's auto pipeline resolved to."""
    name = type(reader._stream_decoder._pipeline).__name__
    return {"HostPipeline": "host", "JaxPipeline": "device",
            "_OraclePipeline": "oracle"}.get(name, name)


def _timed_best(fn, reps=REPS):
    best = 0.0
    for _ in range(max(1, reps)):
        t0 = time.perf_counter()
        audio_sec = fn()
        dt = time.perf_counter() - t0
        best = max(best, audio_sec / dt)
    return best


def _timed_median(fn, reps=REPS):
    """(median, [lo, hi]) x-realtime over ``reps`` timed runs — the
    headline's estimator: the metric of record carries its spread."""
    rates = []
    for _ in range(max(1, reps)):
        t0 = time.perf_counter()
        audio_sec = fn()
        rates.append(audio_sec / (time.perf_counter() - t0))
    rates.sort()
    n = len(rates)
    med = rates[n // 2] if n % 2 else (rates[n // 2 - 1] + rates[n // 2]) / 2
    return med, [round(rates[0], 1), round(rates[-1], 1)]


def cfg_longform_batch():
    """The headline: production ``engine="auto"`` on the long-form batch."""
    raw = open(long_stream(REPEATS), "rb").read()
    raws = [raw] * N_STREAMS
    decode_batch(raws)  # warm (packet tables, page pool, any jit caches)
    med, spread = _timed_median(lambda: decode_batch(raws))
    return {
        "metric": "decode_throughput_stereo_44k1_longform_batch",
        "value": round(med, 3),
        "unit": "x_realtime_per_chip",
        "spread": spread,
        "streams": N_STREAMS,
        "backend": _LAST_BACKEND,
    }


def cfg_longform_batch_device():
    """Device-plane validation: the headline workload forced through the
    device path (co-batched chunk programs)."""
    _require_gpu()
    raw = open(long_stream(REPEATS), "rb").read()
    raws = [raw] * N_STREAMS
    decode_batch(raws, engine="jax")  # warm jit caches
    return {
        "metric": "decode_throughput_stereo_44k1_longform_batch_device",
        "value": round(_timed_best(
            lambda: decode_batch(raws, engine="jax")), 3),
        "unit": "x_realtime_per_chip",
        "streams": N_STREAMS,
        "backend": _LAST_BACKEND,
    }


def cfg_longform_batch_int16():
    """The device headline with 16-bit PCM transport (NVT_FETCH_INT16):
    halves device->host bytes, quantifying how much of the device f32
    number is transfer-bound.  Lossy (~3e-5) — reported separately, never
    the headline.  Transport dtype only exists on the device path."""
    _require_gpu()
    raw = open(long_stream(REPEATS), "rb").read()
    raws = [raw] * N_STREAMS
    os.environ["NVT_FETCH_INT16"] = "1"
    try:
        decode_batch(raws, engine="jax")  # warm
        value = round(_timed_best(
            lambda: decode_batch(raws, engine="jax")), 3)
    finally:
        os.environ.pop("NVT_FETCH_INT16", None)
    return {
        "metric": "decode_throughput_stereo_44k1_longform_batch_int16",
        "value": value,
        "unit": "x_realtime_per_chip",
        "streams": N_STREAMS,
        "backend": _LAST_BACKEND,
    }


def cfg_decode_1test_wav():
    import nvorbis_tpu as nv
    from nvorbis_tpu.wave_io import write_wav

    # fixed output path, like the reference's TestApp (one WAV target,
    # TestApp/Program.cs:12-29): the full header+data write is timed, but
    # not a per-rep tempfile create+unlink round trip
    os.makedirs(CACHE_DIR, exist_ok=True)
    wav_path = os.path.join(CACHE_DIR, "_1test_out.wav")

    def once():
        r = nv.VorbisReader(fixture_path(MONO_SHORT))
        pcm = r.read_all()
        audio_sec = len(pcm) / r.channels / r.sample_rate
        write_wav(wav_path, pcm, r.sample_rate, r.channels)
        r.dispose()
        return audio_sec

    once()  # warm
    r = nv.VorbisReader(fixture_path(MONO_SHORT))
    backend = _reader_backend(r)
    r.dispose()
    return {
        "metric": "decode_1test_to_wav",
        "value": round(_timed_best(once, reps=5), 3),
        "unit": "x_realtime_per_chip",
        "backend": backend,
    }


def cfg_chained_seek():
    import numpy as np

    import nvorbis_tpu as nv
    from nvorbis_tpu.testgen.ogg_writer import make_chained_stream

    os.makedirs(CACHE_DIR, exist_ok=True)
    path = os.path.join(CACHE_DIR, "chained3_x4.ogg")
    if not os.path.exists(path):
        make_chained_stream(fixture_path(STEREO), 4, path, repeats=4)

    r = nv.VorbisReader(path)
    total = r.total_samples
    rng = np.random.default_rng(0)
    targets = rng.integers(0, max(1, total - 44100), size=24)
    buf = np.zeros(4096 * r.channels, dtype=np.float32)

    # parity first: every seek must land granule-exact
    r.sample_position = int(targets[0])
    assert r.sample_position == int(targets[0])

    for tgt in targets[:8]:  # warm (page provisioning, ramp caches)
        r.sample_position = int(tgt)
        r.read_samples(buffer=buf)
    n_seeks = 0
    t0 = time.perf_counter()
    for tgt in targets:
        r.sample_position = int(tgt)
        r.read_samples(buffer=buf)
        n_seeks += 1
    dt = time.perf_counter() - t0
    backend = _reader_backend(r)
    r.dispose()
    return {
        "metric": "chained_seek_read",
        "value": round(n_seeks / dt, 2),
        "unit": "seeks_per_sec",
        "backend": backend,
    }


def cfg_forward_only():
    """Streaming (non-seekable) decode throughput vs the seekable bulk
    path on the same bytes.  Forward-only sources can't use the packet
    table (one C++ packetization pass needs a seekable byte source) but
    the bulk plane's per-packet provider pull still feeds the same fused
    chunk programs — the reference treats its forward-only path as a
    first-class citizen (Ogg/ForwardOnlyPacketProvider.cs), so its
    throughput is tracked here."""
    import io

    import nvorbis_tpu as nv

    raw = open(long_stream(FWD_REPEATS), "rb").read()

    class _Fwd(io.BytesIO):
        def seekable(self):
            return False

    backend = [None]

    def _once(wrap):
        r = nv.VorbisReader(wrap(raw))
        backend[0] = _reader_backend(r)
        pcm = r.read_all()
        sec = len(pcm) / r.channels / r.sample_rate
        r.dispose()
        return sec

    _once(_Fwd)  # warm
    fwd = _timed_best(lambda: _once(_Fwd), reps=1)
    seek = _timed_best(lambda: _once(io.BytesIO), reps=1)
    return {
        "metric": "decode_throughput_forward_only",
        "value": round(fwd, 3),
        "unit": "x_realtime_per_chip",
        "seekable_ratio": round(fwd / max(seek, 1e-9), 3),
        "backend": backend[0],
    }


def _surround51_raws():
    import numpy as np

    from nvorbis_tpu.testgen.vorbis_writer import make_simple_spec

    spec = make_simple_spec(
        channels=6, sample_rate=48000, residue_type=2,
        couplings=[(0, 1), (2, 3), (4, 5)],
    )
    blob = spec.build_stream(np.random.default_rng(1), S51_PACKETS)
    return [blob] * 4


def cfg_surround51_48k():
    raws = _surround51_raws()
    decode_batch(raws)  # warm
    return {
        "metric": "decode_throughput_51_48k_residue2",
        # best-of-2 (same rationale as batch64: the first timed rep on a
        # snapshot-VM host still pays first-touch transients)
        "value": round(_timed_best(lambda: decode_batch(raws), reps=2), 3),
        "unit": "x_realtime_per_chip",
        "streams": 4,
        "backend": _LAST_BACKEND,
    }


def cfg_surround51_48k_int16():
    """5.1 through the device with 16-bit transport: 6-channel f32 is 3.3x
    stereo's bytes/audio-sec, the config most in need of halved transfer
    bytes.  Device-validation config (see cfg_longform_batch_int16)."""
    _require_gpu()
    raws = _surround51_raws()
    os.environ["NVT_FETCH_INT16"] = "1"
    try:
        decode_batch(raws, engine="jax")  # warm
        value = round(_timed_best(
            lambda: decode_batch(raws, engine="jax"), reps=1), 3)
    finally:
        os.environ.pop("NVT_FETCH_INT16", None)
    return {
        "metric": "decode_throughput_51_48k_residue2_int16",
        "value": value,
        "unit": "x_realtime_per_chip",
        "streams": 4,
        "backend": _LAST_BACKEND,
    }


def cfg_batch64():
    raw = open(long_stream(B64_REPEATS), "rb").read()
    raws = [raw] * (4 * B64_WIDTH)
    # warm + best-of-2: each fresh BatchDecoder allocates ~1.2 GB of new
    # output buffers, and on snapshot-VM hosts the first-touch faults cost
    # seconds per GB until glibc's recycled heap stabilizes (2-3
    # constructions); steady state is the representative service number
    decode_batch(raws)  # warm
    return {
        "metric": "decode_throughput_64stream_batch",
        "value": round(_timed_best(lambda: decode_batch(raws), reps=2), 3),
        "unit": "x_realtime_per_chip",
        "streams": len(raws),
        "backend": _LAST_BACKEND,
    }


def cfg_batch64_mixed():
    """64 streams over 4 DISTINCT setups (the homogeneous batch64 decodes
    64 copies of one file, which co-batches into a single symbol-mode
    group; distinct codebooks fragment into separate groups with less
    amortization — this measures that regime).  Fleet: 16 streams each of
    the 3test long-form, the issue6test long-form, and two synthetic
    stereo 44.1 kHz specs with different residue topologies/codebooks."""
    import numpy as np

    from nvorbis_tpu.parallel.batch import BatchDecoder
    from nvorbis_tpu.testgen.vorbis_writer import make_simple_spec

    n_pk = B64_REPEATS * 225  # ~match the long fixture's packet count
    W = B64_WIDTH
    raws = []
    raws += [open(long_stream(B64_REPEATS), "rb").read()] * W
    raws += [open(long_stream(B64_REPEATS, STEREO_SHIFTED),
                  "rb").read()] * W
    spec_a = make_simple_spec(channels=2, sample_rate=44100, residue_type=2)
    raws += [spec_a.build_stream(np.random.default_rng(2), n_pk)] * W
    spec_b = make_simple_spec(channels=2, sample_rate=44100, residue_type=1,
                              n_stages=1, couplings=[])
    raws += [spec_b.build_stream(np.random.default_rng(3), n_pk)] * W

    bd = BatchDecoder(raws)
    groups = {bd._group_key(st.decoder._setup, st.native)
              for st in bd._streams if st.native is not None}
    n_groups = len(groups)

    def once():
        return decode_batch(raws)

    once()  # warm (see cfg_batch64: best-of-2 rides out the fresh-buffer
    # first-touch transient on snapshot-VM hosts)
    return {
        "metric": "decode_throughput_64stream_batch_mixed",
        "value": round(_timed_best(once, reps=2), 3),
        "unit": "x_realtime_per_chip",
        "streams": len(raws),
        "distinct_setups": 4,
        "groups": n_groups,
        "backend": _LAST_BACKEND,
    }


def cfg_device_synth():
    """Fetch-free device-compute throughput: tools/device_synth.py captures
    the fused chunk programs (floor render + coupling + IMDCT matmul +
    window + on-device gather OLA — the device replacement for
    NVorbis/Mapping.cs:95-198 + Mdct.cs:65-313 + StreamDecoder.cs:532-541)
    with device-resident inputs, then replays them with the PCM left on
    device.  Runs in a child process of its own, so this process must not
    hold the card meanwhile (its device fields are read after the child
    exits)."""
    streams = os.environ.get("NVT_SYNTH_STREAMS", "8")
    repeats = os.environ.get("NVT_SYNTH_REPEATS", "16")
    proc = subprocess.run(
        [sys.executable, os.path.join(_REPO, "tools", "device_synth.py"),
         streams, repeats, "5"],
        capture_output=True, text=True, timeout=1150,
    )
    value = spread = backend = audio = None
    for ln in proc.stdout.splitlines():
        if ln.startswith("device_synth_x:"):
            value = float(ln.split(":", 1)[1])
        elif ln.startswith("device_synth_spread:"):
            lo, hi = ln.split(":", 1)[1].split()
            spread = [float(lo), float(hi)]
        elif ln.startswith("backend:"):
            backend = ln.split(":", 1)[1].strip()
        elif ln.startswith("audio_sec:"):
            audio = float(ln.split(":", 1)[1])
    if value is None:
        tail = (proc.stderr or "").strip().splitlines()
        raise RuntimeError(
            f"device_synth child rc={proc.returncode}: "
            + (tail[-1] if tail else "no output")
        )
    return {
        "metric": "device_synth_throughput",
        "value": value,
        "unit": "x_realtime_per_chip",
        "spread": spread,
        "audio_sec": audio,
        "streams": int(streams),
        "backend": backend,
    }


def cfg_host_ceiling():
    """Host-engine throughput through the REAL production path
    (tools/host_ceiling.py: BatchDecoder(engine="host"), real synthesis,
    real PCM emit).  Runs in a child for a clean allocator/page state;
    jax-free.
    Reports the median of the timed rounds with the min/max spread so
    host-weather drift travels with the number."""
    proc = subprocess.run(
        [sys.executable, os.path.join(_REPO, "tools", "host_ceiling.py"),
         "8", "32", "6"],
        capture_output=True, text=True, timeout=420,
    )
    value = spread = None
    for ln in proc.stdout.splitlines():
        if ln.startswith("host_ceiling_x:"):
            value = float(ln.split(":", 1)[1])
        elif ln.startswith("host_ceiling_spread:"):
            lo, hi = ln.split(":", 1)[1].split()
            spread = [float(lo), float(hi)]
    if value is None:
        tail = (proc.stderr or "").strip().splitlines()
        raise RuntimeError(
            f"host_ceiling child rc={proc.returncode}: "
            + (tail[-1] if tail else "no output")
        )
    return {
        "metric": "host_ceiling",
        "value": round(value, 1),
        "unit": "x_realtime_host_engine_median",
        "spread": spread,
        "streams": 8,
        "backend": "host",
    }


_CFG_FNS = {
    "longform_batch": cfg_longform_batch,
    "longform_batch_device": cfg_longform_batch_device,
    "longform_batch_int16": cfg_longform_batch_int16,
    "decode_1test_wav": cfg_decode_1test_wav,
    "chained_seek": cfg_chained_seek,
    "surround51_48k": cfg_surround51_48k,
    "forward_only": cfg_forward_only,
    "surround51_48k_int16": cfg_surround51_48k_int16,
    "batch64": cfg_batch64,
    "batch64_mixed": cfg_batch64_mixed,
    "device_synth": cfg_device_synth,
    "host_ceiling": cfg_host_ceiling,
}


# wall limit of each config's child, and the budget a config needs left
# before it starts (the headline always runs)
LIMITS = {"longform_batch": 900.0, "longform_batch_device": 1500.0,
          "longform_batch_int16": 1500.0, "batch64": 900.0,
          "batch64_mixed": 900.0, "surround51_48k": 600.0,
          "surround51_48k_int16": 700.0, "forward_only": 700.0,
          "device_synth": 1200.0}
MIN_LEFT = {"batch64": 150.0, "batch64_mixed": 150.0,
            "forward_only": 100.0,
            "longform_batch_device": 400.0,
            "longform_batch_int16": 300.0,
            "surround51_48k": 100.0, "surround51_48k_int16": 150.0,
            "device_synth": 200.0}

HEADLINE = "longform_batch"
_HEADLINE_METRIC = "decode_throughput_stereo_44k1_longform_batch"


def main():
    """Run ``CONFIGS`` in this process."""
    headline_emitted = False
    for name in CONFIGS:
        fn = _CFG_FNS.get(name)
        if fn is None:
            print(f"unknown bench config {name!r}", file=sys.stderr)
            continue
        if (name != HEADLINE and not os.environ.get("NVT_BENCH_CHILD")
                and _budget_left() < MIN_LEFT.get(name, 0.0)):
            _emit({"metric": name, "skipped": "budget exhausted",
                   **_device_fields()})
            continue
        try:
            line = fn()
        except Exception as e:  # one config must not kill the rest
            _emit({"metric": name, "error": f"{type(e).__name__}: {e}",
                   **_device_fields()})
            continue
        if "x_realtime" in line.get("unit", ""):
            line["vs_baseline"] = round(line["value"] / TARGET_X_REALTIME, 4)
        else:
            line["vs_baseline"] = None
        line.update(_device_fields())
        _emit(line)
        if line["metric"] == _HEADLINE_METRIC:
            _emit(line, final=True)
            headline_emitted = True

    if not headline_emitted and (HEADLINE in CONFIGS or not CONFIGS):
        _emit({"metric": _HEADLINE_METRIC, "value": 0.0,
               "unit": "x_realtime_per_chip", "vs_baseline": 0.0,
               **_device_fields()}, final=True)


def parent_main():
    """Process-per-config orchestration (default): each config runs in a
    child of its own, one at a time, so one process holds the card at a
    time.  The parent relays the children's lines, prints the headline on
    stdout once, and never initializes JAX."""
    headline_line = None
    last_fields = {"card": devinfo.card()}
    for name in CONFIGS:
        if name not in _CFG_FNS:
            print(f"unknown bench config {name!r}", file=sys.stderr)
            continue
        if name != HEADLINE and _budget_left() < MIN_LEFT.get(name, 0.0):
            _emit({"metric": name, "skipped": "budget exhausted",
                   **last_fields})
            continue
        limit = LIMITS.get(name, 600.0)
        env = dict(os.environ, NVT_BENCH_CHILD="1", NVT_BENCH_CONFIGS=name)
        try:
            proc = subprocess.run(
                [sys.executable, os.path.abspath(__file__)],
                env=env, capture_output=True, text=True, timeout=limit,
            )
            err, out = proc.stderr, proc.stdout
        except subprocess.TimeoutExpired as e:
            err = e.stderr or ""
            out = ""
            if isinstance(err, bytes):
                err = err.decode(errors="replace")
            _emit({"metric": name,
                   "error": f"config exceeded {limit:.0f}s (killed)",
                   **last_fields})
        for ln in err.splitlines():
            if not ln.startswith("{"):
                continue
            try:
                rec = json.loads(ln)
            except ValueError:
                continue
            if "platform" in rec:
                last_fields = {k: rec[k] for k in (
                    "platform", "device_kind", "device_count", "card")}
            if rec.get("metric") == _HEADLINE_METRIC and "value" in rec:
                continue  # the headline goes to stdout, once
            print(ln, file=sys.stderr, flush=True)
        for ln in out.splitlines():
            if ln.startswith("{"):
                rec = json.loads(ln)
                if rec.get("metric") == _HEADLINE_METRIC and rec.get(
                        "value"):
                    headline_line = rec
        if name == HEADLINE and headline_line is not None:
            # stdout carries the headline the moment it exists, so an
            # external timeout killing a later config can't zero the run
            _emit(headline_line, final=True)

    if headline_line is None:
        _emit({"metric": _HEADLINE_METRIC, "value": 0.0,
               "unit": "x_realtime_per_chip", "vs_baseline": 0.0,
               **last_fields}, final=True)


if __name__ == "__main__":
    if os.environ.get("NVT_BENCH_CHILD") or \
            os.environ.get("NVT_BENCH_NO_FORK"):
        main()
    else:
        parent_main()
