"""Packet providers: seekable packet iteration + granule-exact seek, and the
forward-only streaming path.

Mirrors NVorbis/Ogg/PacketProvider.cs (seekable: continuation stitching,
granule back-calculation per packet, libvorbis long/short-block granule bug
correction, pre-roll handling) and NVorbis/Ogg/ForwardOnlyPacketProvider.cs
(page FIFO, sequence-gap resync detection, continuation concatenation).
"""

from nvorbis_tpu.errors import InvalidDataError, SeekNotSupportedError
from nvorbis_tpu.ogg.bitreader import BitReader
from nvorbis_tpu.ogg.pages import (
    FLAG_BEGINNING_OF_STREAM,
    FLAG_END_OF_STREAM,
)


class Packet(BitReader):
    """A Vorbis packet: a bit reader plus stream-position metadata."""

    __slots__ = ()

    def done(self) -> None:  # kept for API parity; no cache to invalidate
        pass


class PacketProvider:
    """Seekable packet iterator for one logical stream.

    Reference: NVorbis/Ogg/PacketProvider.cs.
    """

    can_seek = True

    def __init__(self, page_index, serial: int):
        self._index = page_index  # StreamPageIndex
        self.stream_serial = serial
        self._page_index = 0
        self._packet_index = 0
        self._skip_packets = 0

    # -- sequential iteration ------------------------------------------------

    def fast_forward_packets(self, n: int) -> None:
        """Defer advancing past ``n`` packets until the next sequential
        pull.  The table-backed header parse consumes the header packets
        from the C++ packetization without walking their pages here; a
        later streaming read drains the skip through the normal walk, and
        an absolute reposition (seek_to) cancels it."""
        self._skip_packets = n

    def _drain_skip(self) -> None:
        while self._skip_packets > 0:
            pkt, pg, pki = self._next_packet(
                self._page_index, self._packet_index
            )
            if pkt is None:
                self._skip_packets = 0
                return
            self._page_index = pg
            self._packet_index = pki
            self._skip_packets -= 1

    def get_next_packet(self):
        if self._skip_packets:
            self._drain_skip()
        pkt, pg, pki = self._next_packet(self._page_index, self._packet_index)
        if pkt is not None:
            self._page_index = pg
            self._packet_index = pki
        return pkt

    def peek_next_packet(self):
        if self._skip_packets:
            self._drain_skip()
        pkt, _, _ = self._next_packet(self._page_index, self._packet_index)
        return pkt

    def _next_packet(self, page_index, packet_index):
        rec = self._index.get_page(page_index)
        while rec is not None and rec.packet_count == 0:
            # empty page (zero-length lacing only) — carries flags/granule
            # but no payload; skip to the next page
            page_index += 1
            packet_index = 0
            rec = self._index.get_page(page_index)
        if rec is None:
            return None, page_index, packet_index
        return self._create_packet(
            page_index,
            packet_index,
            True,
            rec.granule_pos,
            rec.is_resync,
            rec.is_continued,
            rec.packet_count,
            rec.overhead,
        )

    def get_granule_count(self) -> int:
        if not self._index.has_all_pages:
            # force a scan of all remaining pages (PacketProvider.cs:32-42)
            self._index.get_page(2**31 - 1)
        return self._index.max_granule_position or 0

    # -- packet construction --------------------------------------------------

    def _create_packet(
        self,
        page_index,
        packet_index,
        advance,
        granule_pos,
        is_resync,
        is_continued,
        packet_count,
        page_overhead,
    ):
        """Build one packet, stitching continuations across pages.

        Reference: PacketProvider.CreatePacket (PacketProvider.cs:324-438).
        Returns (packet|None, next_page_index, next_packet_index).
        """
        packets = self._index.get_page_packets(page_index)
        if packet_index >= len(packets):
            return None, page_index, packet_index
        parts = [packets[packet_index]]

        final_page = page_index
        if is_continued and packet_index == packet_count - 1:
            # the packet continues into following pages
            is_first_packet = True
            if packet_index > 0:
                page_overhead = 0
            cont_page = page_index
            while is_continued:
                cont_page += 1
                rec = self._index.get_page(cont_page)
                if rec is None:
                    return None, page_index, packet_index
                granule_pos = rec.granule_pos
                is_resync = rec.is_resync
                is_continued = rec.is_continued
                packet_count = rec.packet_count
                page_overhead += rec.overhead
                if not rec.is_continuation or rec.is_resync:
                    # broken stream; use what we already have
                    break
                if is_continued and packet_count > 1:
                    # the continuation ends within this page
                    is_continued = False
                parts.append(self._index.get_page_packets(cont_page)[0])
            # the stitched packet owns the final page's granule when it is
            # the last packet *completing* there (spec-correct; the reference
            # only handles the single-packet case, PacketProvider.cs:375)
            is_last_packet = packet_count - (1 if is_continued else 0) == 1
            final_page = cont_page
        else:
            is_first_packet = packet_index == 0
            # granule belongs to the last packet completing in the page
            # (an ending partial packet completes on a later page)
            is_last_packet = packet_index == packet_count - (
                2 if is_continued else 1
            )

        pkt = Packet(b"".join(parts))
        pkt.is_resync = is_resync
        if is_first_packet:
            pkt.container_overhead_bits = page_overhead * 8
        if is_last_packet:
            pkt.granule_position = None if granule_pos == -1 else granule_pos
            if self._is_stream_end(final_page):
                pkt.is_end_of_stream = True

        return self._finish_advance(
            pkt, page_index, packet_index, final_page, packet_count, advance
        )

    def _is_stream_end(self, page_index: int) -> bool:
        """True when no packet-bearing page exists after ``page_index``.

        Unlike a bare has-all-pages check this looks one page ahead (skipping
        empty marker pages), making the end-of-stream flag — and therefore
        the final-granule end trim — independent of whether the page index
        was pre-scanned (e.g. by a TotalSamples query)."""
        j = page_index + 1
        while True:
            rec = self._index.get_page(j)
            if rec is None:
                return self._index.has_all_pages and (
                    page_index < self._index.page_count
                )
            if rec.packet_count > 0:
                return False
            j += 1

    def _finish_advance(self, pkt, page_index, packet_index, final_page,
                        packet_count, advance):
        next_page = page_index
        next_packet = packet_index
        if advance:
            if final_page != page_index:
                next_page = final_page
                next_packet = 0
            if next_packet == packet_count - 1:
                next_page += 1
                next_packet = 0
            else:
                next_packet += 1
        return pkt, next_page, next_packet

    # -- seeking --------------------------------------------------------------

    def seek_to(self, granule_pos: int, pre_roll: int, get_packet_granule_count) -> int:
        """Position the cursor so the next packet decodes up to
        ``granule_pos``; returns the granule at the packet's start.

        Reference: PacketProvider.SeekTo (PacketProvider.cs:56-72).
        """
        page_index = self._index.find_page(granule_pos)
        granule_pos, packet_index = self._find_packet(
            page_index, pre_roll, granule_pos, get_packet_granule_count
        )
        norm = self._normalize_packet_index(page_index, packet_index)
        if norm is None:
            raise ValueError("granulePos out of range")
        self._page_index, self._packet_index = norm
        self._skip_packets = 0  # absolute reposition cancels any deferred skip
        return granule_pos

    def _previous_page_info(self, page_index, get_packet_granule_count):
        # Reference: GetPreviousPageInfo (PacketProvider.cs:74-106)
        if page_index <= 0:
            return 0, 0, 0
        rec = self._index.get_page(page_index - 1)
        if rec is None:
            raise InvalidDataError("Could not get preceding page?!")
        if page_index > self._index.first_data_page_index:
            prev_page = page_index - 1
            last_packet_index = rec.packet_count - 1
            pkt, _, _ = self._create_packet(
                prev_page, last_packet_index, False, 0, False,
                rec.is_continued, rec.packet_count, 0,
            )
            if pkt is None:
                raise InvalidDataError("Could not find end of continuation!")
            last_page_packet_len = get_packet_granule_count(pkt)
        else:
            last_page_packet_len = 0
        return rec.granule_pos, last_page_packet_len, (1 if rec.is_continued else 0)

    def _target_page_info(self, page_index, first_real_packet, last_page_packet_len,
                          get_packet_granule_count):
        # Reference: GetTargetPageInfo (PacketProvider.cs:108-146)
        rec = self._index.get_page(page_index)
        if rec is None:
            raise InvalidDataError("Could not get found page?!")
        packet_count = rec.packet_count
        if rec.is_continued:
            packet_count -= 1

        gps = [0] * packet_count
        counts = [0] * packet_count
        end_gp = rec.granule_pos
        for i in range(packet_count - 1, first_real_packet - 1, -1):
            gps[i] = end_gp
            pkt, _, _ = self._create_packet(
                page_index, i, False, rec.granule_pos,
                (i == 0 and rec.is_resync), rec.is_continued, packet_count, 0,
            )
            if pkt is None:
                raise InvalidDataError("Could not find end of continuation!")
            counts[i] = get_packet_granule_count(pkt)
            end_gp -= counts[i]

        if first_real_packet == 1:
            gps[0] = end_gp
            end_gp -= last_page_packet_len
            counts[0] = last_page_packet_len
        return gps, end_gp, counts

    def _find_packet(self, page_index, pre_roll, granule_pos, get_packet_granule_count):
        # Reference: FindPacket (PacketProvider.cs:206-226)
        last_page_gp, last_page_packet_len, first_real_packet = self._previous_page_info(
            page_index, get_packet_granule_count
        )
        gps, end_gp, counts = self._target_page_info(
            page_index, first_real_packet, last_page_packet_len, get_packet_granule_count
        )
        if (
            end_gp != last_page_gp
            and not self._is_vorbis_bug_diff(end_gp - last_page_gp)
            and self._index.has_all_pages
            and page_index == self._index.page_count - 1
            and page_index != self._index.first_data_page_index
        ):
            # Final page of the stream with end-trim: the page granule is
            # deliberately smaller than the packets' sample counts, so anchor
            # the walk on the previous page's granule instead.  (The
            # reference throws "GranulePos mismatch" on such seeks.)
            end_gp = last_page_gp
            run = end_gp
            for i in range(first_real_packet, len(gps)):
                run += counts[i]
                gps[i] = run
        if page_index == self._index.first_data_page_index:
            # The stream's first audio packet produces no samples (it only
            # primes the lapping state), so the backward walk lands at
            # -count(packet 0) instead of 0.  Clamp rather than letting the
            # libvorbis-bug heuristic misfire (which would shift every packet
            # granule and make seeks land count(packet 0) early — the
            # reference has this defect for short first blocks).
            end_gp = 0
        granule_pos, packet_index = self._locate_packet(
            page_index, gps, end_gp, last_page_gp, last_page_packet_len, granule_pos
        )
        # apply the pre-roll unless we're already at the stream's first packet
        # (which is its own pre-roll).  The reference guards with
        # `packetIndex > 1` (PacketProvider.cs:221), which skips the pre-roll
        # when targeting the second audio packet and lands one packet late;
        # `> 0` is the sample-exact condition.
        if end_gp > 0 or packet_index > 0:
            packet_index -= pre_roll
        return granule_pos, packet_index

    def _locate_packet(self, page_index, gps, end_gp, last_page_gp,
                       last_page_packet_len, granule_pos):
        # Reference: FindPacket(int, long[], ...) (PacketProvider.cs:148-204)
        # A granule of -1 on the previous page (a packet spans it entirely,
        # no packet completes there) provides no anchor — the backward walk
        # from the target page's own granule is the only source of truth, so
        # there is nothing to cross-check.
        if end_gp != last_page_gp and last_page_gp != -1:
            diff = end_gp - last_page_gp
            if self._is_vorbis_bug_diff(diff):
                if diff > 0:
                    # libvorbis mis-counted a long block at the end of the
                    # previous page (PacketProvider.cs:154-167)
                    if granule_pos <= end_gp:
                        return end_gp - last_page_packet_len, -1
                else:
                    # shift the page's first-packet start with its ends:
                    # a target in packet 0 must roll forward from the
                    # corrected start (the previous page's granule), not
                    # from the uncorrected walk, or the roll overruns the
                    # packet
                    gps = [g - diff for g in gps]
                    end_gp -= diff
            elif page_index > self._index.first_data_page_index:
                raise InvalidDataError(
                    f"GranulePos mismatch: Page {page_index}, expected "
                    f"{last_page_gp}, calculated {end_gp}"
                )
        for i, g in enumerate(gps):
            if g >= granule_pos:
                return (end_gp if i == 0 else gps[i - 1]), i
        raise InvalidDataError("Could not find seek packet?!")

    @staticmethod
    def _is_vorbis_bug_diff(diff: int) -> bool:
        """Detect the libvorbis long/short block granule bug: |diff| must be
        exactly ``longBlock/4 - shortBlock/4`` (a run of set bits followed by
        cleared bits).  Reference: PacketProvider.cs:228-260."""
        diff = abs(diff)
        temp = diff
        short_bits = 0
        while temp > 0 and (temp & 1) == 0:
            short_bits += 1
            temp >>= 1
        long_bits = short_bits
        while (temp & 1) == 1:
            long_bits += 1
            temp >>= 1
        return temp == 0 and diff == (1 << long_bits) - (1 << short_bits)

    def _normalize_packet_index(self, page_index, packet_index):
        # Resolve negative packet indexes into prior pages, honoring
        # continuations.  Reference: NormalizePacketIndex (264-296).
        rec = self._index.get_page(page_index)
        if rec is None:
            return None
        is_resync = rec.is_resync
        is_continuation = rec.is_continuation
        pg, pk = page_index, packet_index
        while pk < (1 if is_continuation else 0):
            if is_continuation and is_resync:
                return None
            was_continuation = is_continuation
            pg -= 1
            rec = self._index.get_page(pg)
            if rec is None:
                return None
            is_resync = rec.is_resync
            is_continuation = rec.is_continuation
            if was_continuation and not rec.is_continued:
                return None
            pk += rec.packet_count - (1 if was_continuation else 0)
        return pg, pk


class ForwardOnlyPacketProvider:
    """Streaming (non-seekable) packet provider.

    Reference: NVorbis/Ogg/ForwardOnlyPacketProvider.cs.  Deviation: a packet
    stitched across pages still picks up the final page's granule position
    when it is the last packet completing there (the reference drops it).
    """

    can_seek = False

    def __init__(self, physical_reader, serial: int):
        self._reader = physical_reader
        self.stream_serial = serial
        self._last_seq = 0
        self._page_queue = []  # (RawPage, is_resync)
        self._is_end_of_stream = False
        self._cur_page = None
        self._cur_packets = None
        self._cur_packet_idx = 0
        self._cur_is_resync = False
        self._fresh_page = False
        self._peeked = None

    def add_page(self, page, is_resync: bool) -> bool:
        # Reference: ForwardOnlyPacketProvider.AddPage (37-69)
        if page.flags & FLAG_BEGINNING_OF_STREAM:
            if self._is_end_of_stream:
                return False
            is_resync = True
            self._last_seq = page.seq_no
        else:
            is_resync = is_resync or (page.seq_no != self._last_seq + 1)
            self._last_seq = page.seq_no
        if sum(page.buf[27 : 27 + page.seg_count]) == 0:
            return False
        self._page_queue.append((page, is_resync))
        return True

    def set_end_of_stream(self) -> None:
        self._is_end_of_stream = True

    def get_next_packet(self):
        if self._peeked is not None:
            pkt = self._peeked
            self._peeked = None
            return pkt
        return self._get_packet()

    def peek_next_packet(self):
        if self._peeked is None:
            self._peeked = self._get_packet()
        return self._peeked

    def _probe_end(self) -> bool:
        """Pull pages until one with data is queued or the stream ends;
        True when the stream is over.  Makes the end-of-stream flag (and the
        final-granule end trim) independent of page arrival timing — e.g. a
        trailing empty end-of-stream marker page."""
        for _ in range(8):  # bounded: marker pages are adjacent in practice
            if self._page_queue or self._is_end_of_stream:
                break
            if not self._reader.read_next_page():
                break
        return self._is_end_of_stream and not self._page_queue

    def _read_next_page(self):
        while not self._page_queue:
            if self._is_end_of_stream or not self._reader.read_next_page():
                return False
        page, is_resync = self._page_queue.pop(0)
        self._cur_page = page
        self._cur_packets = page.packets()
        self._cur_packet_idx = 0
        self._cur_is_resync = is_resync
        self._fresh_page = True
        return True

    def _get_packet(self):
        # grab a page if needed
        if self._cur_page is None or self._cur_packet_idx >= len(self._cur_packets):
            if not self._read_next_page():
                return None
        is_resync = self._cur_is_resync if self._fresh_page else False
        cont_overhead = self._cur_page.overhead if self._fresh_page else 0

        if self._fresh_page and self._cur_page.is_continuation:
            # resync'd into the middle of a packet: drop the partial tail
            # (its bytes count as container overhead, as in the reference;
            # ForwardOnlyPacketProvider.cs:148-165)
            is_resync = True
            cont_overhead += len(self._cur_packets[self._cur_packet_idx])
            self._cur_packet_idx += 1
            if self._cur_packet_idx >= len(self._cur_packets):
                self._fresh_page = False
                return self._get_packet()
        self._fresh_page = False

        data = self._cur_packets[self._cur_packet_idx]
        self._cur_packet_idx += 1

        is_last = self._cur_packet_idx >= len(self._cur_packets)
        granule_pos = None
        is_eos = False
        if is_last and self._cur_page.is_continued:
            # this is the partial packet: stitch across following pages
            parts = [data]
            while True:
                if not self._read_next_page():
                    break
                page = self._cur_page
                if not page.is_continuation or self._cur_is_resync:
                    # stream is broken; use what we could get (the fresh page
                    # is left unconsumed for the next call)
                    break
                cont_overhead += page.overhead
                self._fresh_page = False
                parts.append(self._cur_packets[0])
                self._cur_packet_idx = 1
                if not (page.is_continued and len(self._cur_packets) == 1):
                    # the packet ends within this page; it owns the page's
                    # granule when it is the last packet completing there
                    completing = len(self._cur_packets) - (1 if page.is_continued else 0)
                    if completing == 1:
                        granule_pos = page.granule_pos
                        is_eos = bool(page.flags & FLAG_END_OF_STREAM) or self._probe_end()
                    break
            data = b"".join(parts)
        else:
            # is this the last packet *completing* in the page?
            completes_last = is_last
            if self._cur_page.is_continued:
                completes_last = self._cur_packet_idx == len(self._cur_packets) - 1
            if completes_last:
                granule_pos = self._cur_page.granule_pos
                if (self._cur_page.flags & FLAG_END_OF_STREAM) or self._probe_end():
                    is_eos = True

        pkt = Packet(data)
        pkt.is_resync = is_resync
        pkt.granule_position = granule_pos
        pkt.is_end_of_stream = is_eos
        pkt.container_overhead_bits = cont_overhead * 8
        return pkt

    def get_granule_count(self):
        raise SeekNotSupportedError("Forward-only streams cannot report total granules.")

    def seek_to(self, granule_pos, pre_roll, get_packet_granule_count):
        raise SeekNotSupportedError("Forward-only streams cannot seek.")
