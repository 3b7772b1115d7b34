"""Frame-batching engine: host read-ahead -> bucketed async device dispatch.

``JaxPipeline`` plugs into :class:`~nvorbis_tpu.stream_decoder.StreamDecoder`
(the ``engine="jax"`` path).  It reads ahead a window of packets, unpacks
them on the host plane into dense :class:`FrameSpec` tensors, buckets the
frames by *mode* (each mode has a static block size / window set / mapping
topology, so each bucket maps onto the shared jitted synthesis program — see
``synth/device.py``), dispatches one asynchronous device call per bucket,
and replays the results to the decoder in original packet order so all
overlap-add, end-trim, position and stats semantics
(``NVorbis/StreamDecoder.cs:417-541``) are untouched.

Double buffering: device results stay as live jax arrays until the consumer
touches them, and the *next* window's host unpack + dispatch happens as soon
as the previous window is handed to the consumer — so the sequential host
bit-plane runs concurrently with device synthesis (JAX dispatch is async).

This replaces the reference's packet-at-a-time synthesis with frame-batch
data parallelism: the overlap-add dependency between consecutive frames is
only pairwise, so a whole window of frames can be synthesized in parallel
and lapped afterwards.
"""

import os
from collections import deque

import numpy as np


class _LazyBatch:
    """Deferred device->host conversion for one dispatched bucket."""

    __slots__ = ("dev", "count", "_np")

    def __init__(self, dev, count):
        # slice the batch padding off on-device: never fetch padded rows
        self.dev = dev[:count] if count != dev.shape[0] else dev
        self.count = count
        self._np = None

    def get(self, i):
        if self._np is None:
            from nvorbis_tpu.utils.fetch import fetch_np

            self._np = fetch_np(self.dev)
        return np.array(self._np[i])  # writable copy for overlap-add


class JaxPipeline:
    """Read-ahead batched synthesis via the JAX device plane."""

    def __init__(self, decoder, readahead: int = 2048):
        import jax  # noqa: F401  -- raise early when JAX is unavailable

        from nvorbis_tpu.synth.device import DeviceSynth

        self._DeviceSynth = DeviceSynth
        self._decoder = decoder
        self._max_readahead = readahead
        self._queue = deque()
        self._pending = None  # next window, already dispatched to the device
        self._provider_done = False
        self._window = 8  # adaptive: grows toward _max_readahead
        self._synths = {}  # id(mode) -> DeviceSynth
        self._win_stacks = {}  # id(mode) -> stacked [W, n] window table

        # native host plane (C++), when buildable and the setup is supported
        self._native = None
        try:
            from nvorbis_tpu.native import unpacker_for

            self._native = unpacker_for(decoder._setup, decoder._max_posts)
        except Exception:
            self._native = None
        # HostPipeline sets this: every window on the host plane
        self._host_only = False

    def reset(self):
        self._queue.clear()
        self._pending = None
        self._provider_done = False
        self._window = 4

    def next_result(self, need_frames=None):
        """Pop the next decoded packet result.

        ``need_frames``: the caller's remaining demand (frames), when known.
        Post-reset windows are capped to it so a seek-then-short-read never
        decodes (or device-dispatches) frames it will not consume; sustained
        sequential reads ramp the window up to the full read-ahead.
        """
        if not self._queue:
            # promote the in-flight window, then immediately dispatch the
            # next one: the device synthesizes it while the consumer drains
            # the queue (JAX dispatch is asynchronous).  During the post-
            # reset ramp-up the windows are host-synthesized and a seeking
            # caller reads only a few frames — prefetching there would
            # decode 4x the frames it consumes, so don't.
            if self._pending is None and not self._provider_done:
                self._pending = self._fill(need_frames)
            if self._pending is not None:
                self._queue.extend(self._pending)
                self._pending = None
            if not self._provider_done and self._window > self._ORACLE_WINDOW:
                self._pending = self._fill(need_frames)
                if not self._pending:
                    self._pending = None
        if not self._queue:
            return None
        res = self._queue.popleft()
        if res._lazy is not None:
            batch, i = res._lazy
            res.pcm = batch.get(i)
            res._lazy = None
        return res

    # -- internals ----------------------------------------------------------

    def _synth_for(self, mode):
        synth = self._synths.get(id(mode))
        if synth is None:
            dec = self._decoder
            synth = self._DeviceSynth(dec._setup, mode, max_posts=dec._max_posts)
            self._synths[id(mode)] = synth
        return synth

    # windows at or below this synthesize on the host: a device dispatch
    # costs a round trip that only pays for itself at batch scale.
    # Post-seek and stream-open reads hit the 8/32 ramp-up windows, so
    # granule-exact seeks stay cheap.
    _ORACLE_WINDOW = 32
    # host-only mode (engine="host"): cap windows so the host IMDCT bounds
    # per-read latency (~256 frames = well under a second of work)
    _HOST_WINDOW_CAP = 256

    def _fill(self, need_frames=None):
        """Unpack + dispatch one window; returns the result list.

        The window follows the 4x ramp, but demand (``need_frames``) caps it
        during ramp-up — and a demand-capped fill does not advance the ramp,
        so scattered small reads stay on the cheap host path."""
        if self._host_only:
            cap = self._HOST_WINDOW_CAP
            if need_frames is not None and need_frames < self._window:
                return self._fill_native_host(max(2, min(need_frames, cap)))
            window = min(self._window, cap)
            if self._window <= cap:
                self._window = min(self._max_readahead, self._window * 4)
            return self._fill_native_host(window)
        if need_frames is not None and need_frames < self._window:
            window = max(2, need_frames)
            if window <= self._ORACLE_WINDOW:
                return self._fill_ramp(window)
        if self._window <= self._ORACLE_WINDOW:
            return self._fill_ramp()
        if self._native is not None:
            if getattr(self._native, "spec_only", False):
                # Floor0: no dense/device form — host spectrum lane, even
                # in device mode (correct, just not device-synthesized)
                return self._fill_native_host()
            return self._fill_native()
        dec = self._decoder
        results = []
        buckets = {}  # id(mode) -> (mode, [(result_index, frame)])
        window = self._window
        self._window = min(self._max_readahead, window * 4)
        while len(results) < window:
            packet = dec._packet_provider.get_next_packet()
            if packet is None:
                self._provider_done = True
                break
            res = dec._unpack_packet_result(packet)
            packet.done()
            frame = getattr(res, "_frame", None)
            results.append(res)
            if frame is not None:
                buckets.setdefault(id(frame.mode), (frame.mode, []))[1].append(
                    (len(results) - 1, frame)
                )
            if res.is_end_of_stream:
                break

        for mode, items in buckets.values():
            synth = self._synth_for(mode)
            frames = [f for _, f in items]
            residue = np.stack([f.residue for f in frames])
            ys = np.stack([f.floor1_ys for f in frames])
            used = np.stack([f.floor1_used for f in frames])
            has_floor = np.stack([f.has_floor for f in frames])
            window_index = np.array([f.window_index for f in frames], dtype=np.int32)
            f0 = None
            if synth.has_floor0:
                f0 = np.zeros(
                    (len(frames), synth.channels, synth.n2), dtype=np.float32
                )
                for i, f in enumerate(frames):
                    for c, curve in f.floor0_curves.items():
                        f0[i, c] = curve
            dev, count = synth.dispatch(residue, ys, used, has_floor, window_index, f0)
            batch = _LazyBatch(dev, count)
            for slot, (ri, frame) in enumerate(items):
                r = results[ri]
                r._lazy = (batch, slot)
                r._frame = None

        return results

    def _fill_ramp(self, window=None):
        """Ramp-window fill (seeks, stream starts): host-only synthesis.

        Routes through the C++ unpacker + dense numpy synthesis when the
        native plane exists — one unpack call for the whole window instead
        of the ≤32 per-packet Python Huffman walks that dominated seek
        profiles (~60% of each seek, NOTES round 2) — and falls back to
        the per-packet oracle fill otherwise.  Numerics match the oracle
        fill to the 5e-6 parity tolerance (see _fill_native_host)."""
        if self._native is None:
            return self._fill_oracle(window)
        return self._fill_native_host(window)

    def _fill_native_host(self, window=None):
        """C++ unpack -> batched numpy synthesis, no device touch.

        Uses the host engine's spectrum lane when available: the C++
        unpack fuses residue decode, inverse coupling and the floor curve
        multiply (bit-identical to the Python stages), and the IMDCT is
        the O(n log n) DCT-IV — the same pipeline engine/host.py runs, so
        ramp/streaming reads match bulk reads bit-for-bit.  Numerics
        match the oracle fill to the 5e-6 parity tolerance.  The legacy
        dense lane (f64 basis matmul) remains for setups without the
        spectrum unpack."""
        from nvorbis_tpu.codec.floor import INVERSE_DB_TABLE

        dec = self._decoder
        setup = dec._setup
        if window is None:
            window = self._window
            self._window = min(self._max_readahead, window * 4)

        packets, raw = self._pull_packets(window)
        if not packets:
            return []

        if window >= 64:
            # sustained sequential reading: worth the process-global
            # allocator policy (tiny one-shot clip decodes never get here)
            from nvorbis_tpu.utils.hostmem import enable_page_recycling

            enable_page_recycling()

        spec_lane = (
            getattr(self._native, "has_spec", False)
            and (getattr(self._native, "spec_only", False)  # Floor0: the
                 # spectrum lane is the only native form
                 or (not os.environ.get("NVT_HOST_NO_SPEC")
                     and not os.environ.get("NVT_HOST_F64")))
        )
        if spec_lane:
            from nvorbis_tpu.engine.host import HostSynth

            spec, meta = self._native.unpack_spec(raw, n_threads=1)
            results, buckets = self._results_from_meta(packets, meta,
                                                       setup)
            synth = getattr(self, "_host_synth", None)
            if synth is None:
                synth = self._host_synth = HostSynth(setup)
            for mode_idx, rows in buckets.items():
                n = setup.modes[mode_idx].block_size
                idx = np.asarray(rows)
                pcm = synth.synthesize_spec(
                    mode_idx, spec[idx][:, :, : n // 2],
                    meta[idx, 2].astype(np.int64),
                )
                for k, ri in enumerate(rows):
                    results[ri].pcm = pcm[k]
            return results

        from nvorbis_tpu.synth.oracle import imdct_basis

        residue, ys, used, has_floor, meta = self._native.unpack(
            raw, n_threads=1
        )
        results, buckets = self._results_from_meta(packets, meta, setup)

        for mode_idx, rows in buckets.items():
            mode = setup.modes[mode_idx]
            mapping = mode.mapping
            n = mode.block_size
            n2 = n // 2
            idx = np.asarray(rows)
            res_b = residue[idx][:, :, :n2]  # [b, C, n2] f32
            b, C = res_b.shape[:2]

            # inverse coupling: the oracle's in-place [C, ...] transform
            # broadcasts over the batch via a channel-first view.  Execute
            # every step: do-not-decode channels carry all-zero residue,
            # for which the transform is the identity (frames.py skips
            # them only to save work on its single-frame path)
            from nvorbis_tpu.codec.frames import apply_inverse_coupling

            apply_inverse_coupling(
                res_b.transpose(1, 0, 2), mapping, [True] * C
            )

            # floor curves (zero when the channel has no floor energy —
            # silence, Mapping.cs:192-196 / Floor1.cs:218-221); one batched
            # render per channel — the per-(frame, channel) scalar loop
            # dominated seek-ramp cost
            from nvorbis_tpu.codec.floor import render_polyline_batch
            curves = np.zeros((b, C, n2), dtype=np.float32)
            for c in range(C):
                sub = np.flatnonzero(has_floor[idx, c])
                if not len(sub):
                    continue
                fl = setup.floors[mapping.channel_floor[c]]
                p = fl.post_count
                ylines = render_polyline_batch(
                    fl.xs_sorted, ys[idx[sub], c, :p],
                    used[idx[sub], c, :p], n2,
                )
                curves[sub, c] = INVERSE_DB_TABLE[np.clip(ylines, 0, 255)]

            spectrum = (res_b * curves).astype(np.float64)
            pcm = spectrum.reshape(-1, n2) @ imdct_basis(n)
            pcm = pcm.astype(np.float32).reshape(b, C, n)
            win_tab = self._win_stacks.get(id(mode))
            if win_tab is None:
                win_tab = self._win_stacks[id(mode)] = np.stack(mode.windows)
            wins = win_tab[meta[idx, 2]]  # [b, n] f32
            pcm *= wins[:, None, :]
            for k, ri in enumerate(rows):
                results[ri].pcm = pcm[k]
        return results

    def _pull_packets(self, window):
        """Pull up to ``window`` packets (stopping at EOS/provider end)."""
        dec = self._decoder
        packets, raw = [], []
        while len(packets) < window:
            packet = dec._packet_provider.get_next_packet()
            if packet is None:
                self._provider_done = True
                break
            packets.append(packet)
            raw.append(bytes(packet.data))
            if packet.is_end_of_stream:
                break
        return packets, raw

    def _results_from_meta(self, packets, meta, setup):
        """Build per-packet result objects from native unpack metadata.

        Same accounting as ``StreamDecoder._unpack_packet_result``: status,
        mode/window indices, bit counts, granule/EOS/resync flags.  Returns
        ``(results, buckets)`` with buckets mapping mode_idx -> packet rows.
        """
        from nvorbis_tpu.stream_decoder import _PacketResult

        results = []
        buckets = {}
        for i, packet in enumerate(packets):
            res = _PacketResult()
            res.is_end_of_stream = packet.is_end_of_stream
            res.is_resync = packet.is_resync
            res.container_overhead_bits = packet.container_overhead_bits
            status = int(meta[i, 0])
            total_bits = int(meta[i, 4])
            if status != 1:
                res.bits_remaining = total_bits
                results.append(res)
                packet.done()
                continue
            mode_idx = int(meta[i, 1])
            window_index = int(meta[i, 2])
            mode = setup.modes[mode_idx]
            res.start, res.valid, res.total = mode.overlaps[window_index]
            res.granule_pos = packet.granule_position
            res.bits_read = int(meta[i, 3])
            res.bits_remaining = total_bits - res.bits_read
            results.append(res)
            buckets.setdefault(mode_idx, []).append(i)
            packet.done()
        return results, buckets

    def _fill_oracle(self, window=None):
        """Small-window fill: per-packet numpy synthesis, no device touch
        (identical semantics to the oracle engine's pipeline)."""
        from nvorbis_tpu.synth.oracle import synthesize_frame

        dec = self._decoder
        if window is None:
            window = self._window
            self._window = min(self._max_readahead, window * 4)
        results = []
        while len(results) < window:
            packet = dec._packet_provider.get_next_packet()
            if packet is None:
                self._provider_done = True
                break
            res = dec._unpack_packet_result(packet)
            if res is not None and getattr(res, "_frame", None) is not None:
                res.pcm = synthesize_frame(dec._setup, res._frame)
                res._frame = None
            packet.done()
            results.append(res)
            if res.is_end_of_stream:
                break
        return results

    def _fill_native(self):
        """Window fill via the C++ host plane: one unpack call, one device
        dispatch per mode present.  Output semantics identical to the
        Python path (bit-exact dense tensors; see tests/test_native.py)."""
        dec = self._decoder
        setup = dec._setup
        window = self._window
        self._window = min(self._max_readahead, window * 4)

        packets, raw = self._pull_packets(window)
        if not packets:
            return []

        sym = getattr(self._native, "sym_plans", None) is not None
        if sym:
            classes_w, ids_w, ys, used, has_floor, meta = (
                self._native.unpack_sym(raw)
            )
        else:
            residue, ys, used, has_floor, meta = self._native.unpack(raw)
        used = used.astype(bool)
        has_floor = has_floor.astype(bool)

        results, buckets = self._results_from_meta(packets, meta, setup)

        for mode_idx, rows in buckets.items():
            mode = setup.modes[mode_idx]
            synth = self._synth_for(mode)
            n2 = synth.n2
            idx = np.asarray(rows)
            window_index = meta[idx, 2].astype(np.int32)
            if sym:
                from nvorbis_tpu.synth.residue_sym import flatten_ids

                if not hasattr(synth, "_sym_static"):
                    res_cfg = setup.residues[mode.mapping.submap_residue[0]]
                    synth.attach_symbol_plan(
                        self._native.sym_plans[id(res_cfg)]
                    )
                st = synth._sym_static
                flat, base = flatten_ids(ids_w[idx], meta[idx, 5])
                dev, count = synth.dispatch_sym(
                    classes_w[idx][:, : st.chr_count, : max(1, st.n_part)],
                    flat, base, ys[idx], used[idx], has_floor[idx],
                    window_index,
                )
            else:
                dev, count = synth.dispatch(
                    residue[idx][:, :, :n2],
                    ys[idx],
                    used[idx],
                    has_floor[idx],
                    window_index,
                    None,
                )
            batch = _LazyBatch(dev, count)
            for slot, ri in enumerate(rows):
                results[ri]._lazy = (batch, slot)

        return results


class HostPipeline(JaxPipeline):
    """Streaming pipeline that never touches jax (``engine="host"``).

    Same read-ahead window machinery as :class:`JaxPipeline` in host-only
    mode — C++ unpack + batched numpy synthesis per window
    (``_fill_native_host``) — but constructed without importing jax or any
    device plane, so it works in environments without jax at all
    (tests/test_host_engine.py decodes with ``import jax`` blocked).
    Bulk decode (``decode_all``) routes to engine/host.HostBulkDecoder.

    Raises when the native plane is unavailable for this setup (Floor0 /
    NVT_NO_NATIVE); the caller degrades to the oracle pipeline, which is
    equally jax-free.
    """

    def __init__(self, decoder, readahead: int = 2048):
        from nvorbis_tpu.native import unpacker_for

        # NB: the page-recycling allocator policy is NOT applied here —
        # it is a process-global, irreversible mallopt, and this
        # constructor runs for every short-clip open under engine="auto".
        # Bulk decodes (HostBulkDecoder) and sustained streaming fills
        # (>= 64 frames, below) apply it where the win is measured.
        self._decoder = decoder
        self._max_readahead = readahead
        self._queue = deque()
        self._pending = None
        self._provider_done = False
        self._window = 8
        self._synths = {}
        self._win_stacks = {}
        self._native = unpacker_for(decoder._setup, decoder._max_posts)
        self._host_only = True
