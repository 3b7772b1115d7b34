"""Multi-stream co-batched decoding — the throughput-saturation plane.

Decode N Ogg Vorbis streams concurrently by batching their frames into
shared device programs.  Streams are grouped by synthesis topology
(channels, block sizes, per-mode coupling); within a group every chunk
dispatches ONE fused XLA program that

  * synthesizes all frames of all streams (per-frame floor X tables and
    window tables are gathered from stacked per-(stream, mode) tables, so
    one compiled program serves the whole group),
  * overlap-adds each stream's frames into its own contiguous range of the
    chunk output via the gather-formulated segment table (see
    ``engine/bulk.py``),

then fetches the chunk once.  Dispatch latency and device->host transfers
amortize over every stream in the group — this is the 64-stream saturation
path, and (with ``mesh=``) the multi-chip scale-out path: frame-axis inputs
shard over the mesh's ``stream`` axis and XLA inserts the collectives.

The reference has no equivalent (it is single-stream per call); this is the
device-plane replacement for "run N decoder instances".
"""

import functools
import os
from collections import defaultdict

import numpy as np

from nvorbis_tpu.codec.floor import Floor1
from nvorbis_tpu.engine.plan import (
    StreamPlanner, round_up as _round_up, peek_mode_index, CAP_PER_SIZE,
    CHUNK_FRAMES, L_QUANTUM, pad_quantum as _pad_quantum,
)
from nvorbis_tpu.ogg.fast_packets import plan_job_arr
from nvorbis_tpu.synth.oracle import imdct_basis

# jax (and the jax-backed synthesis module) import lazily inside the
# device-only paths: BatchDecoder(engine="host") must work — and stay
# fast to import — in environments where jax is absent entirely (the
# host engine's jax-free promise, tests/test_host_engine.py)
from nvorbis_tpu.utils.bitmath import CLIP_LIMIT
from nvorbis_tpu.utils.fetch import (
    block_ready, fetch_pcm, int16_transport_enabled, ready_on_main,
)


def _bucket_size(b: int, shard_mult: int = 1) -> int:
    """Padded frame-batch extent for one bucket (min 16; see
    engine/plan.pad_quantum for the grid + the on-chip measurement).

    ``shard_mult``: the mesh ``stream`` extent — frame-sharded tensors
    must be divisible by it (an odd mesh over the 16-quantum grid fails
    pjit's divisibility check otherwise; caught by the 3-device dryrun)."""
    q = _pad_quantum(b, 16)
    if shard_mult > 1 and q % shard_mult:
        q = ((q + shard_mult - 1) // shard_mult) * shard_mult
    return q


@functools.lru_cache(maxsize=64)
def _batch_program(cfg, mesh_key=None):
    """cfg: (C, L_pad, S_pad, buckets) with buckets a tuple of
    ("d", B_pad, n, P, W, T, coupling) — dense residue — or
    ("s", B_pad, n, P, W, T, coupling, st, N_pad) — residue symbols
    (see synth/residue_sym.py).

    Per dense bucket args: residue [B,C,n2], ys [B,C,P], used,
    has_floor [B,C], widx [B], tid [B], xs_t [T,C,P], win_t [T,W,n],
    basis [n2,n], sl_t [T,C,n2]; symbol buckets replace residue with
    classes [B,CHR,n_part], ids_flat [N_pad], frame_base [B] and append the
    three plan tables (groups, pair, mega — synth/residue_sym.py);
    then segE [S_pad+1], prim, sec, sec_len.
    """
    import jax
    import jax.numpy as jnp

    from nvorbis_tpu.engine.bulk import gather_ola
    from nvorbis_tpu.synth.device import synth_spectra

    C, L_pad, S_pad, buckets, clip, i16, ola_scan = cfg
    n_max = max(b[2] for b in buckets)

    def fn(*flat):
        from nvorbis_tpu.synth.residue_sym import reconstruct_spectrum

        i = 0
        all_rows = []
        for b in buckets:
            if b[0] == "s":
                _, B, n, P, W, T, coupling, st, _npad = b
                (classes, ids_flat, frame_base, ys, used, has_floor, widx,
                 tid, xs_t, win_t, basis, sl_t,
                 g_t, pr_t, mg_t) = flat[i : i + 15]
                i += 15
                # classes travel as uint8 (4x fewer upload bytes); widen
                # on device
                residue = reconstruct_spectrum(
                    classes.astype(jnp.int32), ids_flat, frame_base,
                    (g_t, pr_t, mg_t), st, C,
                )
            else:
                _, B, n, P, W, T, coupling = b
                (residue, ys, used, has_floor, widx, tid, xs_t, win_t,
                 basis, sl_t) = flat[i : i + 10]
                i += 10
            xs = jnp.take(xs_t, tid, axis=0)  # [B, C, P]
            sl = jnp.take(sl_t, tid, axis=0)  # [B, C, n2]
            pcm = synth_spectra(
                residue, ys, used, has_floor, xs, basis, coupling, sl=sl
            )  # [B, C, n]
            win = win_t[tid, widx]  # [B, n]
            pcm = pcm * win[:, None, :]
            pcm = pcm.transpose(0, 2, 1)  # [B, n, C]
            if n < n_max:
                pcm = jnp.pad(pcm, [(0, 0), (0, n_max - n), (0, 0)])
            all_rows.append(pcm)
        segE, prim, sec, sec_len = flat[i : i + 4]

        rows = jnp.concatenate(all_rows, axis=0).reshape(-1, C)
        # scan form: the scatter+cumsum index chain replaces the binary
        # search's log2(S_pad) gather rounds (engine/bulk.gather_ola)
        out = gather_ola(rows, segE, prim, sec, sec_len, L_pad,
                         scan=ola_scan)
        if clip:
            # fused into the epilogue: saves a whole-output host clip pass
            out = jnp.clip(out, -CLIP_LIMIT, CLIP_LIMIT)
        if i16:
            # int16 transport quantization fused too (NVT_FETCH_INT16):
            # same math as utils.fetch.fetch_pcm's post-hoc op, minus the
            # extra dispatches and the f32 intermediate in HBM
            out = jnp.round(
                jnp.clip(out, -1.0, 1.0) * 32767.0
            ).astype(jnp.int16)
        return out

    if mesh_key is None:
        return jax.jit(fn)

    # mesh variant: shard frame-axis inputs over the 'stream' axis
    from jax.sharding import NamedSharding, PartitionSpec as P_

    mesh = _MESHES[mesh_key]
    frame = NamedSharding(mesh, P_("stream"))
    repl = NamedSharding(mesh, P_())
    in_sh = []
    for b in buckets:
        if b[0] == "s":
            # classes/base/per-frame tensors shard by frame; the flat id
            # stream and the static tables replicate
            in_sh += [frame, repl, frame, frame, frame, frame, frame, frame,
                      repl, repl, repl, repl, repl, repl, repl]
        else:
            in_sh += [frame, frame, frame, frame, frame, frame,
                      repl, repl, repl, repl]
    in_sh += [repl, repl, repl, repl]
    return jax.jit(fn, in_shardings=tuple(in_sh), out_shardings=repl)


_MESHES = {}


class _StreamState:
    """Per-stream decode state inside a batch."""

    __slots__ = (
        "reader", "decoder", "native", "planner", "plans_tail", "carry",
        "chunk_base", "out", "done", "pcm", "table_ids", "last_plan",
        "table", "cursor", "ov_tab", "blk_tab", "out_pos",
    )


class BatchDecoder:
    """Co-batched decoder over many sources.

    ``decode_all()`` returns one interleaved float32 array per source, each
    identical (to float rounding) to that source's single-stream decode.
    """

    def __init__(self, sources, mesh=None, clip_samples=True,
                 engine: str = "auto"):
        import nvorbis_tpu as nv
        from nvorbis_tpu.native import unpacker_for

        # engine="host" (or auto with NVT_ENGINE=host) decodes every
        # stream on the host engine — no jax import, no backend touch, no
        # co-batching (there is no dispatch overhead to amortize host-side)
        if engine not in ("auto", "host", "jax"):
            raise ValueError(f"Unknown engine {engine!r}")
        self._host_mode = engine == "host" or (
            engine == "auto" and mesh is None
            and os.environ.get("NVT_ENGINE") == "host"
        )
        if not self._host_mode:
            from nvorbis_tpu.utils.jaxinit import ensure_compile_cache

            ensure_compile_cache()
        else:
            # the host engine needs the page-recycling allocator policy as
            # much as the device staging planes do (snapshot-VM first-touch
            # faults cap fresh-buffer pipelines at 10-30 MB/s — measured
            # 88x vs 594x on the SAME workload without this); jax-free
            from nvorbis_tpu.utils.hostmem import enable_page_recycling

            enable_page_recycling()
        self.clip_samples = clip_samples
        self._capture = None  # list -> _dispatch records (cfg, args, L_real)
        self._capture_only = False  # skip PCM fetches during capture (the
        # replay tool needs only the device-resident args)
        self._mesh_key = None
        self._shard_mult = 1  # mesh 'stream' extent: frame-axis divisor
        if mesh is not None:
            self._mesh_key = ("mesh", id(mesh))
            _MESHES[self._mesh_key] = mesh
            self._shard_mult = int(dict(mesh.shape).get("stream", 1))

        self._streams = []
        unpackers = {}  # id(setup) -> NativeUnpacker|None (setups are
        # shared across same-header streams via the setup cache, and the
        # unpacker is stateless per call, so one instance serves them all)
        tables_by_src = {}  # (id(src), serial) -> packet table: duplicate
        # source objects (a fleet decoding N copies of one blob) share one
        # container packetization pass; tables are read-only per cursor
        for src in sources:
            st = _StreamState()
            st.reader = nv.VorbisReader(src, engine="oracle")
            st.decoder = st.reader._stream_decoder
            skey = id(st.decoder._setup)
            if skey in unpackers:
                st.native = unpackers[skey]
            else:
                try:
                    st.native = unpacker_for(
                        st.decoder._setup, st.decoder._max_posts
                    )
                except RuntimeError:
                    # no native plane (NVT_NO_NATIVE, missing toolchain) or
                    # a setup it cannot represent (Floor0): degrade this
                    # stream to the pure-Python host plane instead of
                    # failing the batch — the reference decodes such streams
                    # through the same pipeline as every other (Floor0.cs)
                    st.native = None
                unpackers[skey] = st.native
            # clean-path packet table: one C++ pass packetizes the whole
            # logical stream (ogg/fast_packets.py); any anomaly —
            # corruption, resync, unbuffered source — keeps the Python
            # provider, which owns the reference's recovery semantics
            st.table = None
            st.cursor = None  # PacketTableCursor when the table exists
            if st.native is not None:
                from nvorbis_tpu.ogg.fast_packets import (
                    PacketTableCursor, table_for_decoder,
                )

                tkey = (id(src),
                        st.decoder._packet_provider.stream_serial)
                if tkey in tables_by_src:
                    table = tables_by_src[tkey]
                else:
                    table = table_for_decoder(st.decoder)
                    tables_by_src[tkey] = table
                if table is not None:
                    st.table = table
                    st.cursor = PacketTableCursor(table)
            # vectorized (mode, window) -> (start, valid, total) and block
            # size lookups for the windowed planner fast path
            setup = st.decoder._setup
            w_max = max(len(m.overlaps) for m in setup.modes)
            st.ov_tab = np.zeros((len(setup.modes), w_max, 3), dtype=np.int64)
            st.blk_tab = np.zeros(len(setup.modes), dtype=np.int64)
            for mi, m in enumerate(setup.modes):
                st.blk_tab[mi] = m.block_size
                for wi, svt in enumerate(m.overlaps):
                    st.ov_tab[mi, wi] = svt
            st.planner = StreamPlanner()
            st.carry = None
            st.last_plan = None
            st.chunk_base = 0
            st.out = []
            st.out_pos = 0
            st.pcm = None
            if st.table is not None:
                # final granule bounds the output (end-trim only shrinks):
                # preallocate the stream's PCM so chunk fetches write in
                # place — no end-of-decode concatenate pass
                gran, fl = st.table[2], st.table[3]
                with_g = gran[(fl & 2) != 0]
                if len(with_g):
                    bound = int(with_g[-1]) + setup.block1_size
                    st.pcm = np.empty(
                        bound * setup.channels, dtype=np.float32
                    )
            st.done = False
            self._streams.append(st)

    # -- grouping ------------------------------------------------------------

    @staticmethod
    def _group_key(setup, native):
        # block_flag matters even when block0 == block1 (spec-legal): same-
        # size modes can differ in window count, and win_tables are sized
        # from members[0] only
        modes_key = tuple(
            (m.block_size, m.block_flag,
             tuple(zip(m.mapping.coupling_mag, m.mapping.coupling_ang)))
            for m in setup.modes
        )
        # symbol mode shares residue tables group-wide, so the tables'
        # content is part of the key (identical files co-batch; different
        # codebooks split into separate groups)
        import hashlib

        plans = getattr(native, "sym_plans", None)
        if plans is None:
            sym_key = "dense"
        else:
            h = hashlib.md5()
            for m in setup.modes:
                plan = plans[id(setup.residues[m.mapping.submap_residue[0]])]
                for arr in (plan.groups_np, plan.pair_np, plan.vq_mega_np):
                    h.update(arr.tobytes())
                h.update(bytes([plan.residue_type]))
                h.update(plan.begin.to_bytes(4, "little"))
                h.update(plan.psize.to_bytes(4, "little"))
            sym_key = h.hexdigest()
        return (setup.channels, setup.block0_size, setup.block1_size,
                modes_key, sym_key)

    def decode_all(self):
        if self._host_mode:
            return self._decode_all_host()
        groups = defaultdict(list)
        for st in self._streams:
            if st.native is None or getattr(st.native, "spec_only", False):
                # fallback: no native plane -> per-stream oracle decode;
                # spec-only native (Floor0) -> the host engine's spectrum
                # lane (the device planes have no Floor0 form)
                st.reader.clip_samples = self.clip_samples
                st.pcm = None  # fallback decoders return their own buffer
                if st.native is not None:
                    from nvorbis_tpu.engine.host import HostBulkDecoder

                    st.decoder._started = True
                    hb = HostBulkDecoder(st.decoder, st.native,
                                         table=st.table,
                                         clip=self.clip_samples)
                    st.out = [hb.run()]
                    if self.clip_samples and hb.maxabs > CLIP_LIMIT:
                        st.decoder._has_clipped = True
                else:
                    st.out = [st.reader.read_all()]
                st.done = True
                continue
            groups[self._group_key(st.decoder._setup, st.native)].append(st)

        try:
            for key, members in groups.items():
                self._decode_group(members)
        finally:
            if self._unpack_pool is not None:
                self._unpack_pool.shutdown(wait=False)
                self._unpack_pool = None

        # clipping happened on-device (program epilogue) or inside the
        # fallback reader — no whole-output host pass here
        results = []
        for st in self._streams:
            if st.pcm is not None:
                pcm = st.pcm[: st.out_pos]
            elif st.out:
                pcm = st.out[0] if len(st.out) == 1 else np.concatenate(st.out)
            else:
                pcm = np.zeros(0, dtype=np.float32)
            results.append(pcm)
            st.reader.dispose()
        return results

    def _decode_all_host(self):
        """Host-engine decode of every stream (no jax, no co-batching).

        Per-stream host bulk decode: host-side there is no
        dispatch/transfer overhead for co-batching to amortize, so N
        streams decode at the single-stream host rate — and streams are
        INDEPENDENT, so on multi-core hosts they fan out over a thread
        pool (the heavy stages — C++ unpack, pocketfft DCT, C++
        window/OLA — all release the GIL; the shared unpacker is
        stateless per call with thread-local C++ scratch).
        ``NVT_HOST_THREADS`` overrides the default ``min(streams,
        cpu_count)``; single-core hosts keep the sequential loop.
        Streams without a native plane (Floor0 / NVT_NO_NATIVE) use their
        reader's oracle read loop, as in the device path's fallback."""
        from nvorbis_tpu.engine.host import HostBulkDecoder

        threads = int(os.environ.get("NVT_HOST_THREADS", "0") or 0)
        if threads <= 0:
            threads = min(len(self._streams), os.cpu_count() or 1)
        threads = max(1, min(threads, len(self._streams)))

        def _one(st):
            st.pcm = None  # the host decoder returns its own buffer
            if st.native is None:
                st.reader.clip_samples = self.clip_samples
                pcm = st.reader.read_all()
            else:
                st.decoder._started = True
                hb = HostBulkDecoder(st.decoder, st.native, table=st.table,
                                     clip=self.clip_samples)
                # outer per-stream threading owns the cores: keep the
                # unpack's internal packet pool at one thread
                hb.unpack_threads = 1 if threads > 1 else 0
                pcm = hb.run()
                # the clamp rides the OLA store; maxabs is pre-clamp
                if self.clip_samples and hb.maxabs > CLIP_LIMIT:
                    st.decoder._has_clipped = True
            st.out = [pcm]
            st.done = True
            st.reader.dispose()
            return pcm

        if threads == 1:
            return [_one(st) for st in self._streams]
        from concurrent.futures import ThreadPoolExecutor

        with ThreadPoolExecutor(max_workers=threads) as pool:
            return list(pool.map(_one, self._streams))

    # -- group decode ----------------------------------------------------------

    def _decode_group(self, members):
        setup0 = members[0].decoder._setup
        C = setup0.channels
        # stacked per-(stream, mode) tables, padded to group maxima
        P = max(st.decoder._max_posts for st in members)
        n_modes = len(setup0.modes)

        from nvorbis_tpu.synth.device import floor1_bin_map, _XS_PAD

        # table id = stream_index * n_modes + mode_index
        xs_tables = {}   # block size -> np [T, C, P]
        win_tables = {}  # block size -> np [T, W, n]
        sizes = sorted({m.block_size for m in setup0.modes})
        T = len(members) * n_modes
        for n in sizes:
            # W differs per mode (long: 4, short: 1); use max over modes of
            # this size
            W = max(
                len(m.windows) for m in setup0.modes if m.block_size == n
            )
            xs_tables[n] = np.full((T, C, P), _XS_PAD, dtype=np.int32)
            win_tables[n] = np.zeros((T, W, n), dtype=np.float32)
        for si, st in enumerate(members):
            setup = st.decoder._setup
            for mi, mode in enumerate(setup.modes):
                t = si * n_modes + mi
                n = mode.block_size
                for c in range(C):
                    fl = setup.floors[mode.mapping.channel_floor[c]]
                    if isinstance(fl, Floor1):
                        xs_tables[n][t, c, : fl.post_count] = fl.xs_sorted
                win = np.stack(mode.windows).astype(np.float32)
                win_tables[n][t, : win.shape[0]] = win

        sl_np = {n: floor1_bin_map(v, n // 2) for n, v in xs_tables.items()}
        basis_np = {n: imdct_basis(n, np.float32) for n in sizes}
        self._win_shapes = {n: v.shape for n, v in win_tables.items()}

        # residue symbol mode (group-uniform via the group key); buckets are
        # keyed by block size, so it requires one residue plan per size
        from nvorbis_tpu.synth.residue_sym import (
            plan_static, plan_tables_dev,
        )

        # NVT_NO_SYMBOLS forces dense residue staging (host-built spectra,
        # 16x the upload bytes, zero reconstruction gathers on device) —
        # the A/B twin of symbol mode
        sym_plans = (None if os.environ.get("NVT_NO_SYMBOLS")
                     else getattr(members[0].native, "sym_plans", None))
        self._sym = sym_plans is not None
        sym_plan_of = {}
        if self._sym:
            for n in sizes:
                plans_for_n = {
                    id(setup0.residues[m.mapping.submap_residue[0]])
                    for m in setup0.modes if m.block_size == n
                }
                if len(plans_for_n) != 1:
                    self._sym = False
                    break
            if self._sym:
                for m in setup0.modes:
                    n = m.block_size
                    if n not in sym_plan_of:
                        sym_plan_of[n] = sym_plans[
                            id(setup0.residues[m.mapping.submap_residue[0]])
                        ]

        import jax.numpy as jnp

        self._sym_info = {}
        xs_dev = {n: jnp.asarray(v) for n, v in xs_tables.items()}
        sl_dev = {n: jnp.asarray(v) for n, v in sl_np.items()}
        win_dev = {n: jnp.asarray(v) for n, v in win_tables.items()}
        basis_dev = {n: jnp.asarray(v) for n, v in basis_np.items()}
        for n, p in sym_plan_of.items():
            self._sym_info[n] = (plan_static(p, n), plan_tables_dev(p))

        self._stream_slot = {id(st): i for i, st in enumerate(members)}
        active = list(members)
        from collections import deque

        from concurrent.futures import ThreadPoolExecutor

        from nvorbis_tpu.utils.fetch import overlap_fetches
        from nvorbis_tpu.utils.profiling import span

        def _run(finish):
            with span("batch.fetch"):
                finish()

        if overlap_fetches():
            # ready/xfer pipeline: the main thread blocks on chunk k's
            # device compute (utils.fetch.ready_on_main), then hands the
            # transfer to the single worker and moves on to collect +
            # dispatch k+1 — compute of k+1 overlaps the transfer of k.  A
            # single worker keeps per-stream chunk order.
            pending = deque()
            with ThreadPoolExecutor(max_workers=1) as pool:
                while active:
                    with span("batch.collect"):
                        chunk = self._collect_chunk(active, P, n_modes)
                    if chunk is None:
                        break
                    with span("batch.dispatch"):
                        finish = self._dispatch(chunk, C, P, setup0,
                                                xs_dev, win_dev, basis_dev,
                                                sl_dev)
                    if ready_on_main():
                        dev_out = getattr(finish, "device_out", None)
                        if dev_out is not None:
                            with span("batch.ready"):
                                block_ready(dev_out)
                    pending.append(pool.submit(_run, finish))
                    while len(pending) > 2:
                        pending.popleft().result()
                    active = [st for st in active if not st.done]
                while pending:
                    pending.popleft().result()
        else:
            # serialized fetches (NVT_FETCH_OVERLAP=0), but keep the
            # host-only collect of chunk k+1 (C++ unpack, planning)
            # overlapped with chunk k's device compute.
            with span("batch.collect"):
                chunk = self._collect_chunk(active, P, n_modes)
            while chunk is not None:
                with span("batch.dispatch"):
                    finish = self._dispatch(chunk, C, P, setup0,
                                            xs_dev, win_dev, basis_dev,
                                            sl_dev)
                active = [st for st in active if not st.done]
                with span("batch.collect"):
                    next_chunk = (self._collect_chunk(active, P, n_modes)
                                  if active else None)
                _run(finish)
                chunk = next_chunk

        for st in members:
            dec = st.decoder
            dec._eos_found = True
            dec._prev_buf = None
            dec._started = True
            dec._current_position = st.planner.stream_pos0 + st.planner.emitted

    def _collect_chunk(self, active, P, n_modes):
        """Pull up to CHUNK_FRAMES packets across active streams.

        Returns per-frame arrays + per-stream segment info, or None when all
        streams are exhausted.
        """
        from concurrent.futures import ThreadPoolExecutor

        from nvorbis_tpu.utils.profiling import span

        residues = []
        classes_l = []
        ids_l = []
        yss = []
        useds = []
        hfs = []
        metas = []
        plans = []

        # phase 1: pull packet windows per stream.  Streams with a packet
        # table (one prior C++ packetization pass) slice it with vectorized
        # mode peeks; others walk the Python provider per packet.
        jobs = []  # dicts: st, n, view|raws, granules, eos, resync, ovh_bits
        budget = CHUNK_FRAMES
        size_counts = {}
        for st in active:
            if st.done or budget <= 0:
                continue
            if size_counts and max(size_counts.values()) >= CAP_PER_SIZE:
                break
            job = (self._pull_table if st.table is not None
                   else self._pull_provider)(st, budget, size_counts)
            if job is not None:
                budget -= job["n"]
                jobs.append(job)
        if not jobs:
            return None

        # phase 2: bit-serial unpack, all streams concurrently (the C++
        # core releases the GIL and threads internally; multiple windows
        # in flight keep its pool fed when per-stream windows are small)
        def _unpack(job):
            st = job["st"]
            view = job.get("view")
            if view is not None:
                if self._sym:
                    return st.native.unpack_sym_view(*view)
                return st.native.unpack_view(*view)
            if self._sym:
                return st.native.unpack_sym(job["raws"])
            return st.native.unpack(job["raws"])

        with span("batch.unpack"):
            if len(jobs) == 1:
                unpacked = [_unpack(jobs[0])]
            else:
                # persistent pool: per-chunk executor create/join costs
                # ~5-8 ms/chunk in pure thread churn
                ex = self._unpack_pool
                if ex is None:
                    ex = self._unpack_pool = ThreadPoolExecutor(
                        max_workers=4, thread_name_prefix="nvt-unpack"
                    )
                unpacked = list(ex.map(_unpack, jobs))

        # phase 3: per-packet lapping plans + stats (order-sensitive)
        stream_rows = []  # (st, r0, r1, plans|None, last_plan)
        plan_cols = []    # per job: [nj, 5] int64 (ok, pos_base, start,
                          # valid, total) — the dispatch-plane view; the
                          # boxed FramePlan list exists only on the
                          # sequential fallback path (bad packets)
        r0 = 0
        for job, arrs in zip(jobs, unpacked):
            st = job["st"]
            dec = st.decoder
            setup = dec._setup
            if self._sym:
                classes, ids, ys, used, has_floor, meta = arrs
                classes_l.append(classes)
                ids_l.append(ids)
            else:
                residue, ys, used, has_floor, meta = arrs
            pa, new_plans, st.last_plan = plan_job_arr(
                st.planner, st.ov_tab, st.blk_tab, setup, meta, job,
                dec._stats, st.last_plan,
            )
            plan_cols.append(pa)
            stream_rows.append((st, r0, r0 + len(pa), new_plans,
                                st.last_plan))
            r0 += len(pa)
            if not self._sym:
                residues.append(residue)
            yss.append(ys)
            useds.append(used)
            hfs.append(has_floor)
            metas.append(meta)
        chunk = {
            "ys": self._pad_cat(yss, P),
            "used": self._pad_cat(useds, P),
            "has_floor": np.concatenate(hfs),
            "plan_arr": np.concatenate(plan_cols),
            "stream_rows": stream_rows,
            "meta": np.concatenate(metas),
        }
        if self._sym:
            chunk["classes"] = np.concatenate(classes_l)
            chunk["ids"] = np.concatenate(ids_l)
        else:
            chunk["residue"] = np.concatenate(residues)
        return chunk

    def _pull_provider(self, st, budget, size_counts):
        """Per-packet pull through the Python provider (robust path)."""
        dec = st.decoder
        setup = dec._setup
        mfb = setup.mode_field_bits
        nm = len(setup.modes)
        raws, granules, eos, resync, ovh_bits = [], [], [], [], []
        while len(raws) < budget:
            if size_counts and max(size_counts.values()) >= CAP_PER_SIZE:
                break
            p = dec._packet_provider.get_next_packet()
            if p is None:
                st.done = True
                break
            data = bytes(p.data)
            raws.append(data)
            granules.append(p.granule_position)
            eos.append(p.is_end_of_stream)
            resync.append(p.is_resync)
            ovh_bits.append(p.container_overhead_bits)
            p.done()
            mi = peek_mode_index(data, mfb)
            if mi is not None and mi < nm:
                n = setup.modes[mi].block_size
                size_counts[n] = size_counts.get(n, 0) + 1
        if not raws:
            return None
        return {
            "st": st, "n": len(raws), "raws": raws, "granules": granules,
            "eos": eos, "resync": resync, "ovh_bits": ovh_bits,
        }

    def _pull_table(self, st, budget, size_counts):
        """Vectorized window slice out of the stream's packet table."""
        job = st.cursor.pull(
            st.decoder._setup, st.blk_tab, budget, size_counts, CAP_PER_SIZE
        )
        if st.cursor.done:
            st.done = True
        if job is not None:
            job["st"] = st
        return job

    @staticmethod
    def _pad_cat(arrs, P):
        out = []
        for a in arrs:
            if a.shape[2] < P:
                a = np.pad(a, [(0, 0), (0, 0), (0, P - a.shape[2])])
            out.append(a)
        return np.concatenate(out)

    def _dispatch(self, chunk, C, P, setup0, xs_dev, win_dev, basis_dev,
                  sl_dev):
        """Stage one chunk's bucket tensors + segment tables.

        Everything per-frame arrives as numpy columns (``plan_arr`` /
        ``meta``) and is consumed with whole-array ops: bucketing, flat-row
        assignment, and the per-stream lapping segment tables are all
        vectorized (a 4096-frame chunk previously spent ~48 ms in
        per-frame Python loops here — the dominant host-plane cost after
        the C++ unpack).  Streams whose window contains a bad packet take
        a scalar fallback walk that owns the drain-the-previous-tail
        semantics (``NVorbis/StreamDecoder.cs:352-356``)."""
        import jax.numpy as jnp

        arr = chunk["plan_arr"]    # [R,5] ok, pos_base, start, valid, total
        meta_all = chunk["meta"]
        stream_rows = chunk["stream_rows"]
        n_modes = len(setup0.modes)
        R = arr.shape[0]

        ok = arr[:, 0] == 1
        mode_r = meta_all[:, 1].astype(np.int64)
        widx_r = meta_all[:, 2].astype(np.int64)
        blk_vec = np.array([m.block_size for m in setup0.modes],
                           dtype=np.int64)
        # bad rows may carry garbage mode fields: clamp the index, zero
        # the size so they never match a bucket
        bsz = np.where(ok, blk_vec[np.minimum(mode_r, n_modes - 1)], 0)

        slot_r = np.empty(R, dtype=np.int64)  # stream slot per chunk row
        for st, r0, r1, _, _ in stream_rows:
            slot_r[r0:r1] = self._stream_slot[id(st)]

        # bucket sizes present, plus carry-only block sizes
        ns = {int(n) for n in np.unique(bsz[ok])} if ok.any() else set()
        carries = []
        for st, _, _, _, _ in stream_rows:
            if st.carry is not None:
                carries.append(st)
                ns.add(setup0.modes[st.carry[0]["meta"][1]].block_size)

        cfg_buckets = []
        args = []
        row_base = 0
        gr = np.full(R, -1, dtype=np.int64)  # chunk row -> flat bucket row
        n_max = max(ns) if ns else setup0.block1_size
        carry_rows = {}

        for n in sorted(ns):
            ridx = np.flatnonzero(ok & (bsz == n))
            n2 = n // 2
            # carries whose frame uses this block size
            cs = [st for st in carries
                  if setup0.modes[st.carry[0]["meta"][1]].block_size == n]
            B = len(ridx) + len(cs)
            B_pad = _bucket_size(B, self._shard_mult)
            if self._sym:
                from nvorbis_tpu.synth.residue_sym import (
                    CLASS_SENTINEL, flatten_ids, round_ids,
                )

                st_geom, tabs = self._sym_info[n]
                n_part, chr_c = st_geom.n_part, st_geom.chr_count
                cls_b = np.full((B_pad, chr_c, max(1, n_part)),
                                CLASS_SENTINEL, np.uint8)
                base_b = np.zeros((B_pad,), np.int32)
                id_parts = []
                pos = 0
            else:
                res_b = np.zeros((B_pad, C, n2), np.float32)
            ys_b = np.zeros((B_pad, C, P), np.int16)
            used_b = np.zeros((B_pad, C, P), bool)
            hf_b = np.zeros((B_pad, C), bool)
            widx_b = np.zeros((B_pad,), np.int32)
            tid_b = np.zeros((B_pad,), np.int32)

            j = 0
            for st in cs:
                crow, cplan = st.carry
                if self._sym:
                    cls_b[j, :, :n_part] = crow["classes"][:chr_c, :n_part]
                    base_b[j] = pos
                    id_parts.append(crow["ids"])
                    pos += len(crow["ids"])
                else:
                    res_b[j] = crow["residue"][:, :n2]
                ys_b[j, :, : crow["ys"].shape[1]] = crow["ys"]
                used_b[j, :, : crow["used"].shape[1]] = crow["used"]
                hf_b[j] = crow["has_floor"]
                widx_b[j] = crow["meta"][2]
                tid_b[j] = crow["tid"]
                carry_rows[id(st)] = row_base + j
                j += 1
            # bulk-gather the frame rows (one fancy-index op per tensor —
            # a per-frame python loop costs ~1s/chunk at 8k frames)
            if len(ridx):
                Rn = len(ridx)
                dst = slice(j, j + Rn)
                ys_b[dst] = chunk["ys"][ridx]
                used_b[dst] = chunk["used"][ridx]
                hf_b[dst] = chunk["has_floor"][ridx]
                widx_b[dst] = widx_r[ridx]
                tid_b[dst] = slot_r[ridx] * n_modes + mode_r[ridx]
                if self._sym:
                    cls_b[dst, :, :n_part] = (
                        chunk["classes"][ridx][:, :chr_c, :n_part]
                    )
                    flat_rows, base_rows = flatten_ids(
                        chunk["ids"][ridx], meta_all[ridx, 5]
                    )
                    base_b[dst] = pos + base_rows
                    id_parts.append(flat_rows)
                    pos += len(flat_rows)
                else:
                    res_b[dst] = chunk["residue"][ridx][:, :, :n2]
                gr[ridx] = row_base + j + np.arange(Rn)
                j += Rn

            T, W = self._win_shapes[n][:2]
            cpl = tuple(zip(
                setup0.modes[0].mapping.coupling_mag,
                setup0.modes[0].mapping.coupling_ang,
            ))
            # group key guarantees every mode of this block size shares the
            # coupling topology
            for m in setup0.modes:
                if m.block_size == n:
                    cpl = tuple(zip(m.mapping.coupling_mag,
                                    m.mapping.coupling_ang))
                    break
            if self._sym:
                N_pad = round_ids(pos)
                flat = np.full((N_pad,), -1, np.int16)
                if pos:
                    flat[:pos] = np.concatenate(id_parts).astype(np.int16)
                cfg_buckets.append(("s", B_pad, n, P, W, T, cpl, st_geom,
                                    N_pad))
                args.extend([
                    *map(jnp.asarray, (cls_b, flat, base_b, ys_b, used_b,
                                       hf_b, widx_b, tid_b)),
                    xs_dev[n], win_dev[n], basis_dev[n], sl_dev[n], *tabs,
                ])
            else:
                cfg_buckets.append(("d", B_pad, n, P, W, T, cpl))
                args.extend([
                    *map(jnp.asarray, (res_b, ys_b, used_b, hf_b, widx_b,
                                       tid_b)),
                    xs_dev[n], win_dev[n], basis_dev[n], sl_dev[n],
                ])
            row_base += B_pad

        # --- per-stream segment tables laid out consecutively -------------
        # (st, out_offset, length) per stream; segment columns collected as
        # arrays — chunk rows per stream are contiguous, so each stream is
        # one vectorized slice
        seg_s, seg_prim, seg_sec, seg_sl = [], [], [], []
        ranges = []
        out_off = 0
        for st, r0, r1, plan_objs, last_plan_obj in stream_rows:
            sid = id(st)
            chunk_base = st.chunk_base
            prev_plan = st.carry[1] if st.carry is not None else None
            prev_row = carry_rows.get(sid)
            okm = ok[r0:r1]
            if r1 > r0:
                # the shared lapping-segment formulation (engine/plan.py;
                # the host/bulk planes call the same function) with this
                # stream's flat-row map and output offset — a third
                # hand-maintained copy of the walk lived here until the
                # round-4 review
                from nvorbis_tpu.engine.plan import build_segments

                s_, prim_, sec_, sl_ = build_segments(
                    arr[r0:r1], gr[r0:r1], n_max, prev_plan,
                    prev_row if prev_row is not None else 0, chunk_base,
                )
                seg_s.append(out_off + s_)
                seg_prim.append(prim_)
                seg_sec.append(sec_)
                seg_sl.append(sl_)

            length_total = st.planner.emitted - chunk_base
            if length_total > 0:
                ranges.append((st, out_off, length_total))
                out_off += length_total

            # update carry for the next chunk
            good_idx = np.flatnonzero(okm)
            if len(good_idx):
                k = r0 + int(good_idx[-1])
                meta_k = meta_all[k]
                crow = {
                    "ys": chunk["ys"][k].copy(),
                    "used": chunk["used"][k].copy(),
                    "has_floor": chunk["has_floor"][k].copy(),
                    "meta": meta_k,
                    "tid": self._stream_slot[sid] * n_modes + int(meta_k[1]),
                }
                if self._sym:
                    crow["classes"] = chunk["classes"][k].copy()
                    crow["ids"] = chunk["ids"][k, : int(meta_k[5])].copy()
                else:
                    crow["residue"] = chunk["residue"][k].copy()
                # fast path boxes only the window's final plan — with
                # every frame good, the last good row IS that frame
                st.carry = (crow, plan_objs[k - r0] if plan_objs is not None
                            else last_plan_obj)
            st.chunk_base = st.planner.emitted

        L_real = out_off
        if L_real == 0:
            return lambda: None
        # quantized program shape (see _pad_quantum), quantized device-side
        # slice for the fetch (see engine/bulk.py)
        L_pad = _pad_quantum(L_real, L_QUANTUM)
        segs_s = (np.concatenate(seg_s) if seg_s
                  else np.zeros(0, dtype=np.int64))
        n_segs = len(segs_s)
        S_pad = _round_up(max(1, n_segs), 256)
        segE = np.empty(S_pad + 1, dtype=np.int32)
        prim = np.zeros(S_pad, dtype=np.int32)
        sec = np.zeros(S_pad, dtype=np.int32)
        sec_len = np.zeros(S_pad, dtype=np.int32)
        segE[:n_segs] = segs_s
        segE[n_segs:] = L_pad + 1 + np.arange(n_segs, S_pad + 1,
                                              dtype=np.int32)
        if n_segs:
            prim[:n_segs] = np.concatenate(seg_prim)
            sec[:n_segs] = np.concatenate(seg_sec)
            sec_len[:n_segs] = np.concatenate(seg_sl)
        args.extend(map(jnp.asarray, (segE, prim, sec, sec_len)))

        i16 = int16_transport_enabled()
        # ola_scan: scatter+cumsum OLA index chain (NVT_NO_OLA_SCAN keeps
        # the searchsorted form as the A/B twin; part of the cfg so a
        # flip recompiles)
        cfg = (C, L_pad, S_pad, tuple(cfg_buckets), self.clip_samples, i16,
               not os.environ.get("NVT_NO_OLA_SCAN"))
        L_fetch = min(L_pad, _round_up(L_real, L_QUANTUM))

        fn = _batch_program(cfg, self._mesh_key)
        out = fn(*args)
        out_f = out[:L_fetch] if L_fetch != L_pad else out
        if self._capture is not None:
            # fetch-free replay hook (tools/device_synth.py): in-process
            # args are device-resident arrays, so (cfg, args) replays
            # the compiled program with zero host<->device transfer
            self._capture.append((cfg, args, L_real))
            if self._capture_only:
                def finish():
                    pass

                finish.device_out = out_f
                return finish

        def finish():
            host = fetch_pcm(out_f, quantized=i16)
            from nvorbis_tpu.utils.profiling import span

            with span("batch.emit"):
                _emit(host)

        finish.device_out = out_f  # lets decode_all block on compute
        # separately from the transfer (ready/xfer pipelining)

        def _emit(host):
            import ctypes

            for st, off, length in ranges:
                flat = host[off : off + length].reshape(-1)
                if st.pcm is not None:
                    # preallocated from the packet table's final granule:
                    # no end-of-decode concatenate pass
                    pos = st.out_pos
                    end = pos + flat.size
                    if end <= st.pcm.size:
                        if flat.flags.c_contiguous and \
                                flat.dtype == st.pcm.dtype:
                            # ctypes.memmove releases the GIL during the
                            # copy (a numpy slice assignment holds it):
                            # emit runs on the fetch worker and must not
                            # contend with the main thread's collect of
                            # the next chunk
                            ctypes.memmove(
                                st.pcm.ctypes.data + pos * st.pcm.itemsize,
                                flat.ctypes.data,
                                flat.size * flat.itemsize,
                            )
                        else:
                            st.pcm[pos:end] = flat
                        st.out_pos = end
                        continue
                    # estimate overrun (trim-free stream oddity): spill
                    st.out.append(st.pcm[:pos].copy())
                    st.pcm = None
                st.out.append(flat.copy())

        return finish

    _stream_slot = None  # set in decode_all per group
    _unpack_pool = None  # persistent C++-unpack thread pool (decode_all)
