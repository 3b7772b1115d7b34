"""On-chip isolation of the reconstruction gathers.

Builds one symbol-mode chunk's reconstruction with each data-dependent
gather individually replaced by a same-shape arithmetic fake (wrong
values, identical compute graph otherwise), and times the variants with
the device_synth marginal-rate method (one jitted fori_loop program per
variant, value-fetch barrier, rung differences cancel fixed costs).

Variants:
  full   — the production reconstruct_spectrum
  noids  — ids gather (jnp.take(ids_flat, slot)) -> slot & 0x3FFF
  nomega — mega gather (jnp.take(mega_t, addr)) -> addr * 1e-6
  none   — both replaced
The (full - noids) and (full - nomega) deltas are each gather's true
marginal cost inside the fused program.

Usage: python tools/ab_recon_gathers.py [streams] [repeats]
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

STREAMS = int(sys.argv[1]) if len(sys.argv) > 1 else 4
REPEATS = int(sys.argv[2]) if len(sys.argv) > 2 else 8

import numpy as np  # noqa: E402

from nvorbis_tpu.testgen.corpus import long_stream

path = long_stream(REPEATS)
raw = open(path, "rb").read()

# capture one dispatched symbol chunk via the BatchDecoder hook
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from nvorbis_tpu.parallel.batch import BatchDecoder  # noqa: E402

dec = BatchDecoder([raw] * STREAMS, engine="jax")
cap = []
dec._capture = cap  # same hook device_synth uses
dec._capture_only = True
dec.decode_all()
syms = [(cfg, args) for cfg, args, _L in cap
        if any(b[0] == "s" for b in cfg[3])]
assert syms, "no symbol-mode chunks captured"
cfg, args = syms[0]
print(f"captured {len(cap)} chunks, {len(syms)} symbol-mode; using chunk 0",
      flush=True)

from nvorbis_tpu.synth.residue_sym import SymStatic  # noqa: E402


def make_fn(mode):
    def recon_only(*flat):
        import nvorbis_tpu.synth.residue_sym as rs

        i = 0
        acc_sum = jnp.float32(0.0)
        for b in cfg[3]:
            if b[0] != "s":
                (residue, ys2, used2, hf2, widx2, tid2, xs_t, win_t,
                 basis, sl_t) = flat[i:i + 10]
                i += 10
                acc_sum = acc_sum + jnp.sum(residue)
                continue
            (classes, ids_flat, frame_base, ys2, used2, hf2, widx2,
             tid2, xs_t, win_t, basis, sl_t, g_t, pr_t, mg_t) = \
                flat[i:i + 15]
            i += 15
            st = b[7]
            if mode in ("wide", "narrow"):
                # production reconstruct_spectrum, group widths on/off
                stv = st._replace(
                    widths=st.widths if mode == "wide"
                    else (1,) * st.stages)
                res = rs.reconstruct_spectrum(
                    classes.astype(jnp.int32), ids_flat, frame_base,
                    (g_t, pr_t, mg_t), stv, cfg[0])
            else:
                res = _recon(mode, classes.astype(jnp.int32), ids_flat,
                             frame_base, (g_t, pr_t, mg_t), st, cfg[0])
            acc_sum = acc_sum + jnp.sum(res)
        return acc_sum.reshape(1, 1)

    return recon_only


def _recon(mode, classes, ids_flat, frame_base, tabs, st, channels):
    begin, psize, n_part, CHR, S, n_cls, half, rtype = st[:8]
    groups_t, pair_t, mega_t = tabs
    B = classes.shape[0]
    n_ids = ids_flat.shape[0]
    mega_n = mega_t.shape[0]
    if n_part == 0:
        return jnp.zeros((B, CHR, 0), dtype=jnp.float32)
    coded = n_part * psize
    counts = jnp.take(groups_t, classes, axis=0)
    counts_c = counts.transpose(0, 3, 1, 2).reshape(B, -1)
    prefix = (jnp.cumsum(counts_c, axis=1) - counts_c).reshape(
        B, S, CHR, n_part)
    is_cls_p = classes < n_cls
    cls_safe_p = jnp.where(is_cls_p, classes, 0)
    live_p = jnp.broadcast_to(
        is_cls_p[:, :, :, None], (B, CHR, n_part, psize)
    ).reshape(B, CHR, coded)
    acc = jnp.zeros((B, CHR, coded), dtype=jnp.float32)
    for s in range(S):
        rows = jnp.take(pair_t, cls_safe_p * S + s, axis=0)
        pe = rows[..., 0].reshape(B, CHR, coded)
        base = rows[..., 1].reshape(B, CHR, coded)
        live = live_p & (pe >= 0)
        g = pe >> 16
        dm = pe & 0xFFFF
        sb = jnp.broadcast_to(
            prefix[:, s][:, :, :, None], (B, CHR, n_part, psize)
        ).reshape(B, CHR, coded)
        slot = frame_base[:, None, None] + sb + g
        if mode in ("noids", "none"):
            idv = (slot & 0x3FFF).astype(jnp.int32)
        else:
            idv = jnp.take(ids_flat, jnp.clip(slot, 0, n_ids - 1)).astype(
                jnp.int32)
        live = live & (idv >= 0)
        addr = base + idv * dm
        if mode in ("nomega", "none"):
            val = addr.astype(jnp.float32) * jnp.float32(1e-6)
        else:
            val = jnp.take(mega_t, jnp.clip(addr, 0, mega_n - 1))
        acc = acc + jnp.where(live, val, jnp.float32(0.0))
    return acc


def time_variant(mode):
    fn = make_fn(mode)
    dev_args = jax.device_put(args)

    def body(k, carry):
        # perturb one scalar input-dependency so iterations can't collapse
        out = fn(*dev_args)
        return carry + out[0, 0] + k.astype(jnp.float32) * 0.0

    @jax.jit
    def loop(K):
        return jax.lax.fori_loop(0, K, body, jnp.float32(0.0))

    # settle + rungs
    float(loop(1))
    rates = []
    t_prev, k_prev = None, None
    for K in (2, 12, 42):
        t0 = time.perf_counter()
        float(loop(K))
        dt = time.perf_counter() - t0
        if t_prev is not None:
            rates.append((dt - t_prev) / (K - k_prev))
        t_prev, k_prev = dt, K
    per = min(rates)
    print(f"{mode:7s} per-iter {per * 1e3:8.2f} ms", flush=True)
    return per


variants = sys.argv[3].split(",") if len(sys.argv) > 3 else [
    "full", "noids", "nomega", "none", "narrow", "wide", "narrow", "wide"]
base = None
for m in variants:
    p = time_variant(m)
    if base is None:
        base = p
    else:
        print(f"  -> {m} saves {(base - p) * 1e3:7.2f} ms/iter vs first",
              flush=True)
