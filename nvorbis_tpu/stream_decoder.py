"""StreamDecoder: the per-logical-stream Vorbis decode engine.

Mirrors NVorbis/StreamDecoder.cs: header processing, the packet->PCM read
loop with lapped overlap-add, end-of-stream trimming to the final granule,
position pickup after resync, clipping, stats, and granule-exact seek with
one-packet pre-roll.

Synthesis is pluggable: ``engine="oracle"`` synthesizes each frame with the
numpy reference path; ``engine="host"`` runs the jax-free C++ + numpy host
engine; ``engine="jax"`` batches frames ahead and dispatches fused device
programs (see nvorbis_tpu/engine/batcher.py); ``engine="auto"`` uses the
device planes (host engine for short streams) unless ``NVT_ENGINE`` names
another engine.
"""


import numpy as np

from nvorbis_tpu.errors import (
    InvalidStreamError,
    PreRollPacketError,
    SeekNotSupportedError,
)
from nvorbis_tpu.codec import setup as setup_mod
from nvorbis_tpu.codec.floor import Floor1
from nvorbis_tpu.codec.frames import unpack_audio_packet
from nvorbis_tpu.ogg.packets import Packet as OggPacket
from nvorbis_tpu.stats import StreamStats
from nvorbis_tpu.tags import TagData
from nvorbis_tpu.utils.bitmath import CLIP_LIMIT


class _PacketResult:
    """Outcome of decoding one packet (successful or not)."""

    __slots__ = (
        "pcm", "start", "valid", "total",
        "is_end_of_stream", "granule_pos", "is_resync",
        "bits_read", "bits_remaining", "container_overhead_bits",
        "_frame", "_lazy",
    )

    def __init__(self):
        self.pcm = None
        self.start = 0
        self.valid = 0
        self.total = 0
        self.is_end_of_stream = False
        self.granule_pos = None
        self.is_resync = False
        self.bits_read = 0
        self.bits_remaining = 0
        self.container_overhead_bits = 0
        self._frame = None
        self._lazy = None


class _OraclePipeline:
    """Per-packet synchronous synthesis with the numpy oracle."""

    def __init__(self, decoder):
        self._decoder = decoder

    def next_result(self, need_frames=None):
        dec = self._decoder
        packet = dec._packet_provider.get_next_packet()
        if packet is None:
            return None
        res = dec._unpack_packet_result(packet)
        if res is not None and getattr(res, "_frame", None) is not None:
            from nvorbis_tpu.synth.oracle import synthesize_frame

            res.pcm = synthesize_frame(dec._setup, res._frame)
            res._frame = None
        packet.done()
        return res

    def reset(self):
        pass


class StreamDecoder:
    def __init__(self, packet_provider, engine: str = "auto"):
        if packet_provider is None:
            raise ValueError("packet_provider is required")
        self._packet_provider = packet_provider
        self._stats = StreamStats()
        self.clip_samples = True
        self._engine_name = engine

        packet = packet_provider.peek_next_packet()
        if packet is None or not self._process_header_packets(packet):
            if packet is not None:
                packet.reset()
                msg = setup_mod.identify_bitstream(packet)
            else:
                msg = "Could not find Vorbis data to decode."
            self._packet_provider = None
            raise InvalidStreamError(msg)

        self._current_position = 0
        self._started = False
        self._reset_decoder()
        self._pipeline = self._make_pipeline(engine)

    # -- initialization -------------------------------------------------------

    def _process_header_packets(self, first_packet) -> bool:
        # Reference: StreamDecoder.ProcessHeaderPackets (107-127)
        provider = self._packet_provider
        id_header = setup_mod.parse_id_header(first_packet)
        if id_header is None:
            return False
        self._id_header = id_header
        self._stats.set_sample_rate(id_header.sample_rate)
        self._add_header_packet_stats(first_packet)

        if not self._try_table_headers(first_packet, id_header):
            provider.get_next_packet().done()  # consume the peeked packet

            packet = provider.get_next_packet()
            if packet is None:
                return False
            comments = setup_mod.parse_comment_header(packet)
            if comments is None:
                return False
            self._vendor, self._comments = comments
            self._add_header_packet_stats(packet)
            packet.done()

            packet = provider.get_next_packet()
            if packet is None:
                return False
            stp, hdr_bits, hdr_rem = setup_mod.parse_setup_header_cached(
                packet, id_header
            )
            if stp is None:
                return False
            self._setup = stp
            self._stats.add_packet(
                -1, hdr_bits, hdr_rem, packet.container_overhead_bits
            )
            packet.done()

        # dense floor1 indexing for the device tables
        self._floor_id_map = {}
        self._max_posts = 1
        for f in self._setup.floors:
            if isinstance(f, Floor1):
                self._floor_id_map[id(f)] = len(self._floor_id_map)
                self._max_posts = max(self._max_posts, f.post_count)

        self._tags = None
        return True

    def _try_table_headers(self, first_packet, id_header) -> bool:
        """Parse the comment+setup headers from the C++ packet table.

        For small seekable streams the one-pass native packetization
        (built here, cached on the decoder, and reused by decode_all)
        replaces the Python page walk for header packets 1-2 — the walk
        (page reads + CRC + packet assembly) measured ~40% of a small
        file's open.  The provider is fast-forwarded lazily so a later
        streaming read still starts at the first audio packet.  Returns
        False (having touched nothing observable) when the table is
        unavailable or disagrees with the provider's first packet —
        the caller then runs the provider path.
        """
        import os

        provider = self._packet_provider
        if not getattr(provider, "can_seek", False) or not hasattr(
            provider, "fast_forward_packets"
        ):
            return False
        try:
            max_bytes = int(
                os.environ.get("NVT_OPEN_TABLE_BYTES", str(4 << 20))
            )
        except ValueError:
            max_bytes = 4 << 20
        if max_bytes <= 0:
            return False
        from nvorbis_tpu.ogg.fast_packets import table_for_decoder

        table = table_for_decoder(self, max_bytes=max_bytes)
        if table is None:
            return False
        data, off, gran, flags, ovh = table
        # alignment guard: table packet 0 must be the provider's packet 0
        # (a chained container or resync could misalign them)
        if bytes(data[off[0]:off[1]]) != bytes(first_packet.data):
            return False
        p1 = OggPacket(data[off[1]:off[2]].tobytes())
        p1.container_overhead_bits = int(ovh[1]) * 8
        comments = setup_mod.parse_comment_header(p1)
        if comments is None:
            return False
        p2 = OggPacket(data[off[2]:off[3]].tobytes())
        p2.container_overhead_bits = int(ovh[2]) * 8
        stp, hdr_bits, hdr_rem = setup_mod.parse_setup_header_cached(
            p2, id_header
        )
        if stp is None:
            return False
        self._vendor, self._comments = comments
        self._add_header_packet_stats(p1)
        self._setup = stp
        self._stats.add_packet(
            -1, hdr_bits, hdr_rem, p2.container_overhead_bits
        )
        provider.fast_forward_packets(3)
        return True

    def _add_header_packet_stats(self, packet):
        self._stats.add_packet(
            -1, packet.bits_read, packet.bits_remaining, packet.container_overhead_bits
        )

    def _short_stream(self) -> bool:
        """Short streams decode on the host engine under ``engine="auto"``:
        below ``NVT_DEVICE_MIN_SECS`` of audio (0 disables) a device decode's
        fixed dispatch and transfer cost (~12 ms on an H100 host, 700 W)
        outweighs its throughput.  The 3.0 s default is not derived from a
        crossover: on that host the single-stream host engine was faster
        at every length measured, 0.4 s to 104 s (PERF.md)."""
        import os

        try:
            secs = float(os.environ.get("NVT_DEVICE_MIN_SECS", "3.0"))
        except ValueError:
            return False
        if secs <= 0:
            return False
        try:
            provider = self._packet_provider
            if provider is None or not getattr(provider, "can_seek", False):
                return False
            total = provider.get_granule_count()
            return total is not None and total < secs * self.sample_rate
        except Exception:
            return False

    def _make_pipeline(self, engine: str):
        import os

        if engine == "auto" and os.environ.get("NVT_ENGINE"):
            v = os.environ["NVT_ENGINE"]
            if v in ("host", "jax", "oracle", "auto"):
                engine = v
            else:
                # a typo'd global env knob must not turn every open()
                # into a hard failure — warn once and keep auto
                import warnings

                warnings.warn(
                    f"ignoring unknown NVT_ENGINE={v!r} "
                    "(expected host/jax/oracle/auto)",
                    RuntimeWarning, stacklevel=3,
                )
        if engine == "oracle":
            return _OraclePipeline(self)
        if engine == "host":
            # the host engine never touches jax (engine/host.py contract);
            # setups without a native plane (NVT_NO_NATIVE, no toolchain)
            # degrade to the oracle pipeline — equally jax-free, slower.
            # Floor0 setups ride the native spectrum lane since round 5
            # (native/host_decode.cpp floor0_unpack/floor0_apply)
            try:
                from nvorbis_tpu.engine.batcher import HostPipeline

                return HostPipeline(self)
            except Exception:
                return _OraclePipeline(self)
        if engine == "auto" and self._short_stream():
            # short streams skip the device but still prefer the host
            # engine over the numpy oracle (setups without a native plane
            # fall to the oracle as everywhere else)
            try:
                from nvorbis_tpu.engine.batcher import HostPipeline

                return HostPipeline(self)
            except Exception:
                return _OraclePipeline(self)
        if engine in ("jax", "auto"):
            # no silent fallback: a device plane that cannot be built is an
            # error under auto as much as under jax
            from nvorbis_tpu.engine.batcher import JaxPipeline

            return JaxPipeline(self)
        raise ValueError(f"Unknown engine {engine!r}")

    # -- state ---------------------------------------------------------------

    def _reset_decoder(self):
        # Reference: StreamDecoder.ResetDecoder (295-305)
        self._prev_buf = None
        self._prev_start = 0
        self._prev_end = 0
        self._prev_stop = 0
        self._eos_found = False
        self._has_clipped = False
        self._has_position = False

    # -- packet decode ---------------------------------------------------------

    def _unpack_packet_result(self, packet):
        """Decode one packet's host plane; attaches the FrameSpec for the
        synthesis backend.  Mirrors StreamDecoder.DecodeNextPacket (465-530).
        """
        res = _PacketResult()
        res.is_end_of_stream = packet.is_end_of_stream
        res.is_resync = packet.is_resync
        res.container_overhead_bits = packet.container_overhead_bits
        frame = unpack_audio_packet(
            self._setup, packet, self._floor_id_map, self._max_posts
        )
        if frame is None:
            if packet.bits_read <= 1:
                # packet started with a 1 bit: not an audio packet
                res.bits_remaining = packet.bits_remaining + 1
            else:
                res.bits_remaining = packet.bits_read + packet.bits_remaining
            res._frame = None
            return res
        res.start = frame.start
        res.valid = frame.valid
        res.total = frame.total
        res.granule_pos = frame.granule_pos
        res.bits_read = frame.bits_read
        res.bits_remaining = frame.bits_remaining
        res._frame = frame
        return res

    # -- the read loop -----------------------------------------------------------

    def read(self, buffer: np.ndarray, offset: int = 0, count: int = None) -> int:
        """Read interleaved float32 samples into ``buffer[offset:offset+count]``.

        ``count`` must be a multiple of ``channels``.  Returns the number of
        floats written.  Reference: StreamDecoder.Read (320-389).
        """
        if buffer is None:
            raise ValueError("buffer is required")
        if count is None:
            count = len(buffer) - offset
        if offset < 0 or offset + count > len(buffer):
            raise ValueError("offset/count out of range")
        if count % self.channels != 0:
            raise ValueError("count must be a multiple of channels")
        if self._packet_provider is None:
            raise ValueError("decoder is disposed")
        if count == 0:
            return 0

        self._started = True
        channels = self.channels
        idx = offset
        tgt = offset + count

        while idx < tgt:
            if self._prev_start == self._prev_end:
                if self._eos_found:
                    self._prev_buf = None
                    break
                remaining = (tgt - idx) // channels
                need = remaining // max(1, self._setup.block0_size // 2) + 2
                _, sample_position = self._read_next_packet(
                    (idx - offset) // channels, need_frames=need
                )
                if sample_position is not None and not self._has_position:
                    self._has_position = True
                    self._current_position = (
                        sample_position
                        - (self._prev_end - self._prev_start)
                        - (idx - offset) // channels
                    )

            copy_len = min((tgt - idx) // channels, self._prev_end - self._prev_start)
            if copy_len > 0:
                idx += self._copy_buffer(buffer, idx, copy_len)

        count_written = idx - offset
        self._current_position += count_written // channels
        return count_written

    def decode_all(self):
        """Bulk fast path: decode the whole stream with device-side
        overlap-add (engine/bulk.py).  Only valid on a freshly opened
        decoder; returns clipped interleaved float32, or None when the bulk
        path does not apply (then use the read() loop)."""
        if self._started or self._eos_found or self._packet_provider is None:
            return None
        native = getattr(self._pipeline, "_native", None)
        if native is None:
            return None
        from nvorbis_tpu.engine.batcher import HostPipeline

        if isinstance(self._pipeline, HostPipeline) or getattr(
            native, "spec_only", False
        ):
            # spec-only natives (Floor0) ride the host spectrum lane in
            # EVERY engine: the dense/symbol device forms cannot express
            # an LSP floor, and the C++ entry points guard (zero frames)
            # host engine: C++ unpack + numpy synthesis + host overlap-add,
            # no jax anywhere (engine/host.py)
            from nvorbis_tpu.engine.host import HostBulkDecoder

            self._started = True
            hb = HostBulkDecoder(self, native, clip=self.clip_samples)
            pcm = hb.run()
            # the clamp rides the OLA store; maxabs is pre-clamp
            if self.clip_samples and hb.maxabs > CLIP_LIMIT:
                self._has_clipped = True
            return pcm
        from nvorbis_tpu.engine.bulk import BulkDecoder

        self._started = True
        pcm = BulkDecoder(self, native).run()
        if pcm is None:
            return None
        if self.clip_samples and pcm.size:
            if np.any(np.abs(pcm) > CLIP_LIMIT):
                self._has_clipped = True
                pcm = np.clip(pcm, -CLIP_LIMIT, CLIP_LIMIT)
        return pcm

    def read_samples(self, count: int = None, buffer=None, offset: int = 0) -> np.ndarray:
        """Convenience wrapper returning a fresh interleaved array."""
        if buffer is not None:
            n = self.read(buffer, offset, count)
            return buffer[offset : offset + n]
        if count is None:
            raise ValueError("count or buffer required")
        out = np.zeros(count, dtype=np.float32)
        n = self.read(out, 0, count)
        return out[:n]

    def _copy_buffer(self, target, target_index, count) -> int:
        # Reference: ClippingCopyBuffer / CopyBuffer (391-415)
        channels = self.channels
        start = self._prev_start
        chunk = self._prev_buf[:, start : start + count]  # [C, count]
        flat = chunk.T.reshape(-1)  # interleaved
        if self.clip_samples:
            if np.any(np.abs(flat) > CLIP_LIMIT):
                self._has_clipped = True
                flat = np.clip(flat, -CLIP_LIMIT, CLIP_LIMIT)
        target[target_index : target_index + count * channels] = flat
        self._prev_start += count
        return count * channels

    def _read_next_packet(self, buffered_samples: int, need_frames=None):
        """Decode + lap the next packet; returns (ok, sample_position).

        Reference: StreamDecoder.ReadNextPacket (417-463) — a failed read
        drains the previous packet so the windowing fades it out.
        """
        res = self._pipeline.next_result(need_frames)
        if res is None:
            self._eos_found = True
            self._stats.add_packet(0, 0, 0, 0)
            self._prev_end = self._prev_stop
            return False, None

        self._eos_found |= res.is_end_of_stream
        if res.is_resync:
            self._has_position = False

        if res.pcm is None:
            self._stats.add_packet(
                0, res.bits_read, res.bits_remaining, res.container_overhead_bits
            )
            self._prev_end = self._prev_stop
            return False, None

        start, valid, total = res.start, res.valid, res.total
        sample_position = res.granule_pos

        # end-trim to the final granule position (StreamDecoder.cs:428-437)
        if sample_position is not None and res.is_end_of_stream:
            actual_end = (
                self._current_position + buffered_samples + valid - start
            )
            diff = sample_position - actual_end
            if diff < 0:
                valid += diff

        pcm = res.pcm
        if self._prev_end > 0:
            # overlap-add the previous packet's tail (StreamDecoder.cs:532-541).
            # On malformed window-flag transitions the tail can exceed the new
            # block; the reference adds into fixed block1-size scratch where
            # the spill lands beyond the consumed range and is discarded —
            # clamping reproduces that
            tail = min(self._prev_stop - self._prev_end, pcm.shape[1] - start)
            if tail > 0:
                pcm[:, start : start + tail] += self._prev_buf[
                    :, self._prev_end : self._prev_end + tail
                ]
            self._prev_start = start
        elif self._prev_buf is None:
            # very first packet: all of it is lapping lead-in
            self._prev_start = valid

        self._stats.add_packet(
            valid - self._prev_start,
            res.bits_read,
            res.bits_remaining,
            res.container_overhead_bits,
        )

        self._prev_end = valid
        self._prev_stop = total
        self._prev_buf = pcm
        return True, sample_position

    # -- seeking ---------------------------------------------------------------

    def seek_to(self, sample_position: int) -> None:
        """Seek so the next read starts at ``sample_position``.

        Reference: StreamDecoder.SeekTo (552-628).
        """
        if self._packet_provider is None:
            raise ValueError("decoder is disposed")
        if not self._packet_provider.can_seek:
            raise SeekNotSupportedError("Seek is not supported by the packet provider.")
        if sample_position < 0:
            raise ValueError("sample_position must be >= 0")

        self._started = True
        if sample_position == 0:
            self._packet_provider.seek_to(0, 0, self._get_packet_granules)
            roll_forward = 0
        else:
            pos = self._packet_provider.seek_to(
                sample_position, 1, self._get_packet_granules
            )
            roll_forward = sample_position - pos

        self._reset_decoder()
        self._pipeline.reset()
        self._has_position = True

        # pre-roll packet
        ok, _ = self._read_next_packet(0, need_frames=1)
        if not ok:
            self._eos_found = True
            if self._packet_provider.get_granule_count() != sample_position:
                raise PreRollPacketError(
                    "Could not read pre-roll packet! Try seeking again prior to reading more samples."
                )
            self._prev_start = self._prev_stop
            self._current_position = sample_position
            return
        # the actual packet
        ok, _ = self._read_next_packet(0, need_frames=1)
        if not ok:
            self._reset_decoder()
            self._pipeline.reset()
            self._eos_found = True
            raise PreRollPacketError(
                "Could not read pre-roll packet! Try seeking again prior to reading more samples."
            )

        self._prev_start += roll_forward
        self._current_position = sample_position

    def seek_to_time(self, seconds: float) -> None:
        self.seek_to(int(self.sample_rate * seconds))

    def _get_packet_granules(self, packet) -> int:
        # Reference: StreamDecoder.GetPacketGranules (630-647)
        if packet.is_resync:
            return 0
        if packet.read_bit():
            return 0
        mode_idx = packet.read_bits(self._setup.mode_field_bits)
        if mode_idx < 0 or mode_idx >= len(self._setup.modes):
            return 0
        return self._setup.modes[mode_idx].get_packet_sample_count(packet)

    # -- lifecycle ---------------------------------------------------------------

    def dispose(self):
        self._packet_provider = None

    close = dispose

    # -- properties ---------------------------------------------------------------

    @property
    def channels(self) -> int:
        return self._id_header.channels

    @property
    def sample_rate(self) -> int:
        return self._id_header.sample_rate

    @property
    def upper_bitrate(self) -> int:
        return self._id_header.upper_bitrate

    @property
    def nominal_bitrate(self) -> int:
        return self._id_header.nominal_bitrate

    @property
    def lower_bitrate(self) -> int:
        return self._id_header.lower_bitrate

    @property
    def tags(self) -> TagData:
        if self._tags is None:
            self._tags = TagData(self._vendor, self._comments)
        return self._tags

    @property
    def total_samples(self) -> int:
        if self._packet_provider is None:
            raise ValueError("decoder is disposed")
        return self._packet_provider.get_granule_count()

    @property
    def total_time(self) -> float:
        return self.total_samples / self.sample_rate

    @property
    def sample_position(self) -> int:
        return self._current_position

    @sample_position.setter
    def sample_position(self, value: int):
        self.seek_to(value)

    @property
    def time_position(self) -> float:
        return self._current_position / self.sample_rate

    @time_position.setter
    def time_position(self, value: float):
        self.seek_to(int(self.sample_rate * value))

    @property
    def has_clipped(self) -> bool:
        return self._has_clipped

    @property
    def is_end_of_stream(self) -> bool:
        return self._eos_found and self._prev_buf is None

    @property
    def stats(self) -> StreamStats:
        return self._stats
