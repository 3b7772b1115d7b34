"""Smoke test of the decode path on one GPU, at real widths.

    python chip_smoke.py            # phases 1-5 on one card
    python chip_smoke.py --multi    # phase 6 only, on four cards

Drives the system through the entry points a user calls
(``VorbisReader(..., engine="jax")``, ``BatchDecoder``) on the bundled
corpus (``tests/fixtures``) and on long-form streams built from it, and
holds every device result to the repo's plain references: the float64
numpy oracle (``synth/oracle.py``), the host overlap-add and dense residue
staging, and the jax-free host engine.

1. synthesis program (``synth/device._synth_program``) vs the oracle at
   n = 256, 2048 and 8192, B = 512 coupled stereo floor1 frames; also the
   same dot at ``Precision.DEFAULT`` (what TF32 would cost);
2. symbol-mode residue rebuild vs dense staging, and the gather
   overlap-add vs the host overlap-add, on the stereo fixture's chunks;
3. reader path, seek and forward-only source vs the oracle, every file;
4. batch path at deployment size (8 x ~7 min stereo, 4 x 5.1 @ 48 kHz)
   vs the host engine, with wall time and audio-seconds per second;
5. short-file latency on the device and host planes, and the duration at
   which the device plane starts to win (``NVT_DEVICE_MIN_SECS``);
6. (``--multi``) phase 4's batch on a 4-card ``stream`` mesh vs one card
   (within the f32 summation-order bound: per-card GEMM shapes differ), and
   the (stream, freq)-sharded synthesis vs the oracle.

Refuses to run unless JAX's backend is the GPU.  Any failed check raises,
so the exit code is non-zero; on success the last stdout line is
``{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}``.
"""

import argparse
import json
import os
import sys
import time

import numpy as np

import nvorbis_tpu as nv
from nvorbis_tpu.testgen import corpus
from nvorbis_tpu.utils import devinfo

# engine vs oracle: f32 at Precision.HIGHEST, only the summation order
# differs (the jax engine's bound in tests/test_golden_libvorbis.py)
SYNTH_BOUND = 2e-6
# device batch decode vs the host engine (DCT-IV vs dense matmul); for
# synthetic streams, whose unnormalized VQ values reach ~20 before the
# floor, plus 5e-7 per unit of unclipped peak, as
# tests/test_golden_libvorbis.py bounds them against libvorbis
BATCH_BOUND = 1e-6
SYNTHETIC_PER_PEAK = 5e-7

CARD = "card not read"


def say(msg):
    print(msg, flush=True)


def timed(msg, secs):
    say(f"{msg}: {secs:.4f} s  [{CARD}]")


def _platforms(arr):
    return {d.platform for d in arr.devices()}


# -- shared helpers ------------------------------------------------------------


def stream_frames(src, n, batch):
    """``batch`` real frames of block size ``n`` from ``src`` (path or
    bytes), unpacked by the C++ host plane into dense tensors (frames are
    repeated cyclically when the stream has fewer).  Returns
    ``(setup, mode, max_posts, residue, ys, used, has_floor, widx)``."""
    from nvorbis_tpu.native import NativeUnpacker

    r = nv.VorbisReader(src, engine="oracle")
    dec = r._stream_decoder
    setup = dec._setup
    raws = []
    while True:
        p = dec._packet_provider.get_next_packet()
        if p is None:
            break
        raws.append(bytes(p.data))
        p.done()
    native = NativeUnpacker(setup, dec._max_posts)
    residue, ys, used, has_floor, meta = native.unpack(raws)
    rows = [i for i in range(len(raws)) if meta[i, 0] == 1
            and setup.modes[meta[i, 1]].block_size == n]
    assert rows, f"no {n}-sample frames in the stream"
    idx = np.resize(np.asarray(rows), batch)
    mode = setup.modes[int(meta[rows[0], 1])]
    out = (setup, mode, dec._max_posts, residue[idx][:, :, : n // 2].copy(),
           ys[idx], used[idx].astype(bool), has_floor[idx].astype(bool),
           meta[idx, 2].astype(np.int32))
    r.dispose()
    return out


def oracle_pcm(setup, mode, residue, ys, used, has_floor, widx):
    """The numpy oracle over a batch (synth/oracle.synthesize_frame's
    stages: coupling, floor1 render, floor multiply, float64 IMDCT, window).
    Returns ``(pcm [B, C, n] f32, err_est)`` where ``err_est`` is the
    probabilistic f32 error scale of the IMDCT sums,
    ``2^-24 * sqrt(n/2) * max ||x * b_i||_2``, computed in float64."""
    from nvorbis_tpu.codec.floor import INVERSE_DB_TABLE, render_polyline_batch
    from nvorbis_tpu.codec.frames import apply_inverse_coupling
    from nvorbis_tpu.synth.oracle import imdct_basis

    B, C, n2 = residue.shape
    n = mode.block_size
    res = residue.copy()
    apply_inverse_coupling(res.transpose(1, 0, 2), mode.mapping, [True] * C)
    curves = np.zeros((B, C, n2), np.float32)
    for c in range(C):
        fl = setup.floors[mode.mapping.channel_floor[c]]
        sub = np.flatnonzero(has_floor[:, c])
        if len(sub):
            p = fl.post_count
            ylines = render_polyline_batch(
                fl.xs_sorted, ys[sub, c, :p], used[sub, c, :p], n2)
            curves[sub, c] = INVERSE_DB_TABLE[np.clip(ylines, 0, 255)]
    spec = (res * curves).reshape(-1, n2).astype(np.float64)
    basis = imdct_basis(n)
    pcm = (spec @ basis).astype(np.float32).reshape(B, C, n)
    pcm *= np.stack(mode.windows).astype(np.float32)[widx][:, None, :]
    est = 2.0 ** -24 * np.sqrt(n2) * float(
        np.sqrt((spec * spec) @ (basis * basis)).max())
    return pcm, est


def _big_block_frames(batch):
    """Coupled stereo floor1 frames at the spec's largest block (8192),
    from a seeded synthetic stream (no encoder emits 8192 blocks at
    44.1 kHz); residues are scaled so the PCM peaks near 0.9, the range
    real audio decodes to."""
    from nvorbis_tpu.testgen.vorbis_writer import make_simple_spec

    blob = make_simple_spec(channels=2, residue_type=2, block0=512,
                            block1=8192).build_stream(
        np.random.default_rng(11), 2 * batch + 16)
    frames = list(stream_frames(blob, 8192, batch))
    ref, _ = oracle_pcm(*frames[:2], *frames[3:])
    frames[3] = frames[3] * np.float32(0.9 / float(np.abs(ref).max()))
    return frames


# -- phase 1 -------------------------------------------------------------------


def phase_synth(ns=(256, 2048, 8192), batch=512):
    """``_synth_program`` (through DeviceSynth.dispatch) vs the oracle."""
    import jax
    import jax.numpy as jnp

    from nvorbis_tpu.synth.device import DeviceSynth, _floored_spectrum

    stereo = corpus.long_stream(2)
    results = {}
    for n in ns:
        if n == 8192:
            frames = _big_block_frames(batch)
        else:
            frames = stream_frames(stereo, n, batch)
        setup, mode, max_posts, residue, ys, used, has_floor, widx = frames
        assert residue.shape[1] == 2 and mode.mapping.coupling_mag
        ref, est = oracle_pcm(setup, mode, residue, ys, used, has_floor, widx)

        synth = DeviceSynth(setup, mode, max_posts=max_posts)
        out, b = synth.dispatch(residue, ys, used, has_floor, widx)
        jax.block_until_ready(out)
        t0 = time.perf_counter()
        out, b = synth.dispatch(residue, ys, used, has_floor, widx)
        jax.block_until_ready(out)
        dt = time.perf_counter() - t0
        plat = _platforms(out)
        pcm = np.asarray(out)[:b]
        err = float(np.abs(pcm - ref).max())

        # the same dot at Precision.DEFAULT (TF32 on the GPU)
        spec = jax.jit(_floored_spectrum, static_argnames=("coupling",))(
            jnp.asarray(residue), jnp.asarray(ys), jnp.asarray(used),
            jnp.asarray(has_floor), synth._xs_dev, synth.coupling_steps,
            sl=synth._sl_dev)
        dflt = jnp.dot(spec.reshape(-1, n // 2), synth._basis_dev,
                       precision=jax.lax.Precision.DEFAULT)
        dflt = np.asarray(dflt).reshape(ref.shape) * np.stack(
            mode.windows).astype(np.float32)[widx][:, None, :]
        err_d = float(np.abs(dflt - ref).max())

        timed(f"[1] synth n={n} B={batch} C=2 device={sorted(plat)} "
              f"max_abs_err={err:.3e} (bound {SYNTH_BOUND:.0e}, f32 error "
              f"scale {est:.3e}) DEFAULT-precision err={err_d:.3e} "
              f"peak={float(np.abs(ref).max()):.3f}; warm call", dt)
        assert np.isfinite(pcm).all() and pcm.shape == ref.shape
        assert err <= SYNTH_BOUND, (n, err)
        results[n] = {"err": err, "err_default": err_d, "est": est,
                      "platforms": plat}
    return results


# -- phase 2 -------------------------------------------------------------------


def _max_ulp(a, b):
    ia = a.astype(np.float32).view(np.int32).astype(np.int64)
    ib = b.astype(np.float32).view(np.int32).astype(np.int64)
    return int(np.abs(ia - ib).max()) if ia.size else 0


def check_residue_sym(src):
    """Symbol-mode rebuild on the device vs the C++ dense staging, every
    mode of ``src``; returns the max ULP difference (0 = bit-identical)."""
    import jax

    from nvorbis_tpu.native import NativeUnpacker
    from nvorbis_tpu.synth.residue_sym import (
        plan_static, plan_tables_dev, reconstruct_spectrum,
    )

    r = nv.VorbisReader(src, engine="oracle")
    dec = r._stream_decoder
    setup = dec._setup
    native = NativeUnpacker(setup, dec._max_posts)
    assert native.sym_plans is not None, "symbol mode unavailable"
    raws = []
    while True:
        p = dec._packet_provider.get_next_packet()
        if p is None:
            break
        raws.append(bytes(p.data))
        p.done()
    dense, _, _, _, meta_d = native.unpack(raws)
    classes, ids, _, _, _, meta = native.unpack_sym(raws)
    assert np.array_equal(meta_d[:, :5], meta[:, :5])
    fn = jax.jit(reconstruct_spectrum, static_argnames=("st", "channels"))
    worst = 0
    for mi, mode in enumerate(setup.modes):
        rows = [i for i in range(len(raws))
                if meta[i, 0] == 1 and meta[i, 1] == mi]
        if not rows:
            continue
        plan = native.sym_plans[id(setup.residues[
            mode.mapping.submap_residue[0]])]
        st = plan_static(plan, mode.block_size)
        counts = meta[rows, 5]
        bases = np.concatenate([[0], np.cumsum(counts)[:-1]]).astype(
            np.int32)
        flat = np.concatenate([ids[i, : meta[i, 5]] for i in rows]).astype(
            np.int32)
        got = fn(classes[rows][:, : st.chr_count, : st.n_part].astype(
            np.int32), flat, bases, plan_tables_dev(plan), st=st,
            channels=setup.channels)
        assert _platforms(got) == {jax.default_backend()}
        want = dense[rows][:, :, : mode.block_size // 2]
        worst = max(worst, _max_ulp(np.asarray(got), want))
    r.dispose()
    return worst


def check_gather_ola(src):
    """The device gather overlap-add (both index forms) vs the host
    overlap-add, on every chunk of a host-engine decode of ``src``;
    returns the max ULP difference."""
    import jax
    import jax.numpy as jnp

    import nvorbis_tpu.engine.host as host_mod
    from nvorbis_tpu.engine.bulk import gather_ola
    from nvorbis_tpu.engine.plan import L_QUANTUM, pad_quantum, round_up
    from nvorbis_tpu.parallel.batch import BatchDecoder

    chunks = []
    orig = host_mod._overlap_add

    def spy(out, rows_all, n_max, s, prim, sec, sl, L_real):
        orig(out, rows_all, n_max, s, prim, sec, sl, L_real)
        chunks.append((out.copy(), rows_all.copy(), s.copy(), prim.copy(),
                       sec.copy(), sl.copy(), L_real))

    raw = open(src, "rb").read() if isinstance(src, str) else src
    old_env = os.environ.get("NVT_HOST_NO_SPEC")
    os.environ["NVT_HOST_NO_SPEC"] = "1"  # the numpy OLA lane
    host_mod._overlap_add = spy
    try:
        BatchDecoder([raw], engine="host", clip_samples=False).decode_all()
    finally:
        host_mod._overlap_add = orig
        if old_env is None:
            os.environ.pop("NVT_HOST_NO_SPEC", None)
        else:
            os.environ["NVT_HOST_NO_SPEC"] = old_env
    assert chunks, "host decode produced no overlap-add chunk"

    fn = jax.jit(gather_ola, static_argnames=("L_pad", "scan"))
    worst = 0
    for want, rows_all, s, prim, sec, sl, L_real in chunks:
        C = rows_all.shape[1]
        rows = rows_all.transpose(0, 2, 1).reshape(-1, C)
        L_pad = pad_quantum(L_real, L_QUANTUM)
        nseg = len(s)
        S_pad = round_up(max(1, nseg), 256)
        segE = (L_pad + 1 + np.arange(S_pad + 1)).astype(np.int32)
        segE[:nseg] = s
        tab = [np.zeros(S_pad, np.int32) for _ in range(3)]
        for t, v in zip(tab, (prim, sec, sl)):
            t[:nseg] = v
        for scan in (False, True):
            got = fn(jnp.asarray(rows), segE, *tab, L_pad=L_pad, scan=scan)
            assert _platforms(got) == {jax.default_backend()}
            worst = max(worst, _max_ulp(np.asarray(got)[:L_real], want))
    return worst


def phase_sym_ola(name=corpus.STEREO):
    path = corpus.fixture_path(name)
    t0 = time.perf_counter()
    ulp_sym = check_residue_sym(path)
    ulp_ola = check_gather_ola(path)
    timed(f"[2] {name}: symbol rebuild vs dense max_ulp={ulp_sym}, gather "
          f"OLA vs host OLA max_ulp={ulp_ola} (bound 0: bit-identical)",
          time.perf_counter() - t0)
    assert ulp_sym == 0 and ulp_ola == 0, (ulp_sym, ulp_ola)
    return {"ulp_sym": ulp_sym, "ulp_ola": ulp_ola}


# -- phase 3 -------------------------------------------------------------------


class _ForwardOnly:
    """A source that hides seekability (tests/test_ogg.ForwardOnlyStream)."""

    def __init__(self, path):
        self._f = open(path, "rb")

    def read(self, n=-1):
        return self._f.read(n)

    def seekable(self):
        return False

    def close(self):
        self._f.close()


def _read_window(reader, secs, count_secs):
    reader.time_position = secs
    buf = np.zeros(int(reader.sample_rate * count_secs) * reader.channels,
                   np.float32)
    n = reader.read_samples(buffer=buf)
    return buf[:n]


def phase_reader(names=corpus.ALL):
    out = {}
    for name in names:
        path = corpus.fixture_path(name)
        ref_r = nv.VorbisReader(path, engine="oracle")
        ref = ref_r.read_all()
        t0 = time.perf_counter()
        r = nv.VorbisReader(path, engine="jax")
        assert type(r._stream_decoder._pipeline).__name__ == "JaxPipeline"
        got = r.read_all()
        dt = time.perf_counter() - t0
        assert got.shape == ref.shape, (name, got.shape, ref.shape)
        err = float(np.abs(got - ref).max())
        errs = {"read_all": err}
        if r.total_time > 4.0:  # granule seek to 3 s, read 1 s
            a = _read_window(r, 3.0, 1.0)
            b = _read_window(ref_r, 3.0, 1.0)
            assert len(a) == len(b) > 0
            errs["seek"] = float(np.abs(a - b).max())
        r.dispose()
        ref_r.dispose()
        f = nv.VorbisReader(_ForwardOnly(path), engine="jax")
        fwd = f.read_all()
        f.dispose()
        assert fwd.shape == ref.shape
        errs["forward_only"] = float(np.abs(fwd - ref).max())
        timed(f"[3] {name}: jax vs oracle max_abs_err "
              + " ".join(f"{k}={v:.3e}" for k, v in errs.items())
              + f" (bound {SYNTH_BOUND:.0e}); cold read_all", dt)
        assert max(errs.values()) <= SYNTH_BOUND, (name, errs)
        out[name] = errs
    return out


# -- phase 4 -------------------------------------------------------------------


def _surround51(streams, packets):
    from nvorbis_tpu.testgen.vorbis_writer import make_simple_spec

    spec = make_simple_spec(channels=6, sample_rate=48000, residue_type=2,
                            couplings=[(0, 1), (2, 3), (4, 5)])
    return [spec.build_stream(np.random.default_rng(1), packets)] * streams


class _OutputSpy:
    """Records the devices of every chunk output the batch plane fetches."""

    def __init__(self):
        import nvorbis_tpu.parallel.batch as batch_mod

        self._mod = batch_mod
        self.device_sets = []

    def __enter__(self):
        self._orig = self._mod.fetch_pcm

        def spy(arr, quantized=False):
            self.device_sets.append(frozenset(arr.sharding.device_set))
            return self._orig(arr, quantized=quantized)

        self._mod.fetch_pcm = spy
        return self

    def __exit__(self, *exc):
        self._mod.fetch_pcm = self._orig


def _audio_secs(outs, bd):
    return sum(len(o) / st.decoder.channels / st.decoder.sample_rate
               for o, st in zip(outs, bd._streams))


def batch_vs_host(label, raws, mesh=None, synthetic=False):
    """Device batch decode of ``raws`` (cold, then timed warm) vs the host
    engine.  Returns the device outputs."""
    import jax

    from nvorbis_tpu.parallel.batch import BatchDecoder

    t0 = time.perf_counter()
    with _OutputSpy() as spy:
        bd = BatchDecoder(raws, mesh=mesh)
        assert not bd._host_mode
        got = bd.decode_all()
    cold = time.perf_counter() - t0
    plats = {d.platform for s in spy.device_sets for d in s}
    assert spy.device_sets and plats == {jax.default_backend()}, plats
    t0 = time.perf_counter()
    bd = BatchDecoder(raws, mesh=mesh)
    got = bd.decode_all()
    warm = time.perf_counter() - t0
    secs = _audio_secs(got, bd)

    t0 = time.perf_counter()
    hb = BatchDecoder(raws, engine="host")
    want = hb.decode_all()
    host = time.perf_counter() - t0
    err = 0.0
    for g, w in zip(got, want):
        assert g.shape == w.shape and np.isfinite(g).all()
        err = max(err, float(np.abs(g - w).max()))
    bound = BATCH_BOUND
    if synthetic:
        peak = max(float(np.abs(o).max()) for o in BatchDecoder(
            raws, engine="host", clip_samples=False).decode_all())
        bound += SYNTHETIC_PER_PEAK * peak
    timed(f"[4] {label}: {len(raws)} streams, {secs:.1f} audio s; device "
          f"{sorted(plats)} (first decode, compiles included: {cold:.2f} s) "
          f"{secs / warm:.1f} audio-s/s; host engine {secs / host:.1f} "
          f"audio-s/s ({host:.2f} s); max_abs_err={err:.3e} "
          f"(bound {bound:.3e}); device warm wall", warm)
    assert err <= bound, (label, err, bound)
    return got, {"warm_s": warm, "cold_s": cold, "host_s": host,
                 "audio_s": secs, "err": err, "device_sets": spy.device_sets}


def longform_raws(repeats=64, streams=8):
    return [open(corpus.long_stream(repeats), "rb").read()] * streams


def phase_batch(repeats=64, streams=8, s51_streams=4, s51_packets=4096):
    res = {}
    _, res["longform"] = batch_vs_host(
        f"stereo 44.1 kHz long-form (fixture x{repeats})",
        longform_raws(repeats, streams))
    _, res["surround51"] = batch_vs_host(
        f"5.1 @ 48 kHz residue 2 ({s51_packets} packets)",
        _surround51(s51_streams, s51_packets), synthetic=True)
    return res


# -- phase 5 -------------------------------------------------------------------


def _decode_secs(src, engine, reps):
    """(median wall s, audio s) of ``VorbisReader(src, engine).read_all()``
    after one warm decode."""
    times = []
    for i in range(reps + 1):
        t0 = time.perf_counter()
        r = nv.VorbisReader(src, engine=engine)
        pcm = r.read_all()
        dt = time.perf_counter() - t0
        audio = len(pcm) / r.channels / r.sample_rate
        r.dispose()
        if i:
            times.append(dt)
    return float(np.median(times)), audio


def phase_short(reps=5, long_repeats=(4, 16)):
    """Short-file latency on both planes, then the crossover: a line
    ``t = a + b * audio_s`` fitted per plane over the mono fixture, the
    stereo fixture and long-form streams gives the duration where the
    device plane's time drops below the host engine's."""
    srcs = [corpus.fixture_path(corpus.MONO_SHORT),
            corpus.fixture_path(corpus.STEREO)]
    srcs += [corpus.long_stream(k) for k in long_repeats]
    fits = {}
    rows = {}
    for engine in ("jax", "host"):
        pts = [_decode_secs(s, engine, reps) for s in srcs]
        rows[engine] = pts
        t = np.array([p[0] for p in pts])
        a = np.array([p[1] for p in pts])
        fits[engine] = np.polyfit(a, t, 1)  # slope, intercept
    (dj, hj), (dh, hh) = fits["jax"], fits["host"]
    dev_short, audio = rows["jax"][0]
    host_short = rows["host"][0][0]
    timed(f"[5] {corpus.MONO_SHORT} ({audio:.2f} audio s) host engine "
          f"median of {reps}", host_short)
    timed(f"[5] {corpus.MONO_SHORT} ({audio:.2f} audio s) device "
          f"(engine=jax) median of {reps}", dev_short)
    for engine in ("jax", "host"):
        say(f"[5] {engine}: " + ", ".join(
            f"{a:.1f} audio s in {t:.4f} s" for t, a in rows[engine])
            + f"  [{CARD}]")
    if dj < dh and hj > hh:
        cross = (hj - hh) / (dh - dj)
        say(f"[5] device plane wins above {cross:.2f} audio s (fit: device "
            f"{hj * 1e3:.1f} ms + {dj * 1e3:.3f} ms/audio-s, host "
            f"{hh * 1e3:.1f} ms + {dh * 1e3:.3f} ms/audio-s)  [{CARD}]")
    else:
        cross = None
        say(f"[5] no crossover in range (fit: device {hj * 1e3:.1f} ms + "
            f"{dj * 1e3:.3f} ms/audio-s, host {hh * 1e3:.1f} ms + "
            f"{dh * 1e3:.3f} ms/audio-s)  [{CARD}]")
    return {"device_short_s": dev_short, "host_short_s": host_short,
            "crossover_s": cross, "rows": rows}


# -- phase 6 -------------------------------------------------------------------


def sharded_synth_vs_oracle(mesh, batch=512):
    """``make_sharded_synth`` over a (stream, freq) mesh vs the oracle on
    real n = 2048 stereo frames; returns the max abs error."""
    import jax.numpy as jnp

    from nvorbis_tpu.parallel.sharded import make_sharded_synth
    from nvorbis_tpu.synth.device import _XS_PAD
    from nvorbis_tpu.synth.oracle import imdct_basis

    setup, mode, max_posts, residue, ys, used, has_floor, widx = (
        stream_frames(corpus.long_stream(2), 2048, batch))
    ref, _ = oracle_pcm(setup, mode, residue, ys, used, has_floor, widx)
    B, C, _ = residue.shape
    xs = np.full((B, C, max_posts), _XS_PAD, np.int32)
    for c in range(C):
        fl = setup.floors[mode.mapping.channel_floor[c]]
        xs[:, c, : fl.post_count] = fl.xs_sorted
    windows = np.broadcast_to(np.stack(mode.windows).astype(np.float32),
                              (B, len(mode.windows), 2048)).copy()
    fn = make_sharded_synth(mesh, tuple(zip(mode.mapping.coupling_mag,
                                            mode.mapping.coupling_ang)))
    out = fn(*(jnp.asarray(a) for a in (
        residue, ys, used, has_floor, widx, xs, windows,
        imdct_basis(2048, np.float32))))
    assert len(out.sharding.device_set) == mesh.devices.size
    return float(np.abs(np.asarray(out) - ref).max())


def phase_multi(n_dev=4, repeats=64, streams=8):
    import jax
    from jax.sharding import Mesh

    from nvorbis_tpu.parallel.sharded import build_mesh

    devs = jax.devices()
    assert len(devs) >= n_dev, f"--multi needs {n_dev} devices, have {len(devs)}"
    raws = longform_raws(repeats, streams)
    one, _ = batch_vs_host("one card", raws)
    mesh = Mesh(np.array(devs[:n_dev]), ("stream",))
    got, info = batch_vs_host(f"{n_dev}-card stream mesh", raws, mesh=mesh)
    spans = {len(s) for s in info["device_sets"]}
    assert spans == {n_dev}, spans
    assert all(a.shape == b.shape for a, b in zip(got, one))
    ulp = max(_max_ulp(a, b) for a, b in zip(got, one))
    diff = max(float(np.abs(a - b).max()) for a, b in zip(got, one))
    # not bit-for-bit on GPUs: each card's IMDCT GEMM sees a quarter of the
    # frames, and cuBLAS picks its algorithm (and summation order) by shape
    say(f"[6] {n_dev}-card mesh vs one card: max_abs_diff={diff:.3e} "
        f"max_ulp={ulp} (bound {SYNTH_BOUND:.0e}: f32, summation order "
        f"only), outputs span {sorted(spans)} devices  [{CARD}]")
    assert diff <= SYNTH_BOUND, diff
    err = sharded_synth_vs_oracle(build_mesh(n_dev))
    say(f"[6] sharded synthesis on a {n_dev // 2}x2 (stream, freq) mesh vs "
        f"oracle: max_abs_err={err:.3e} (bound {SYNTH_BOUND:.0e})  [{CARD}]")
    assert err <= SYNTH_BOUND, err
    return {"ulp": ulp, "diff": diff, "sharded_err": err}


# -- main ----------------------------------------------------------------------


def main(argv=None) -> int:
    global CARD
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--multi", action="store_true",
                    help="run only the four-card phase")
    args = ap.parse_args(argv)

    import jax

    backend = jax.default_backend()
    if backend != "gpu":
        print(f"chip_smoke: needs the GPU; JAX's backend is {backend!r}",
              file=sys.stderr)
        return 2
    from nvorbis_tpu import native
    from nvorbis_tpu.utils.jaxinit import cache_dir, ensure_compile_cache

    if native.load() is None:  # the C++ host plane must build (g++)
        raise RuntimeError("the C++ host plane did not build or load")
    ensure_compile_cache()
    CARD = devinfo.card()
    say(CARD)
    say(f"jax {jax.__version__}; devices {jax.devices()}; compile cache "
        f"{jax.config.jax_compilation_cache_dir or cache_dir()}")
    t0 = time.perf_counter()
    if args.multi:
        phase_multi()
        count = 4
    else:
        phase_synth()
        phase_sym_ola()
        phase_reader()
        phase_batch()
        phase_short()
        count = 1
    timed("all phases", time.perf_counter() - t0)
    d = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
